// Flash attention with in-kernel broadcast dropout: kernels 9 (forward), 10
// (dK, dV) and 11 (dQ, and the bias gradient ds) of the port, f32 or bf16,
// dh 64 or 128, any Lq and Lk. Deterministic: no atomics, every output
// element is summed by one thread in a fixed order, so two identical
// launches give identical bits.
//
// Replaces the TPU kernels of pointcloudmatters_tpu/ops/flash_attention.py:
//    9  `_flash_attention_impl` (:697; pallas_call :869), body
//       `_flash_attention_kernel` (:419, :430, :585);
//   10  `_flash_attention_bwd_dkv` (:1068; :1253), body
//       `_flash_attention_dkv_kernel` (:907);
//   11  `_flash_attention_bwd_dq` (:1427; :1601), body
//       `_flash_attention_dq_kernel` (:1278).
// Their function, as ops/flash_attention.py's plain versions spell it out:
// scores s = (q k^T + ab) * sm_scale in f32 (q is not pre-scaled), the mask
// value -0.7 * f32 max ADDED where segment ids differ or a key is after the
// query under `causal` (so a row whose keys are all masked weighs every
// visited key alike), and under `causal` the pairs of a (block_q, block_k)
// tile of the TPU grid wholly above the diagonal (`below_or_on_diag`,
// :413-416) not visited at all. Forward: o = sum_j p_j D_j v_j / l with p =
// exp(s - m), l the undropped row sum, and the row statistics l and m (f32)
// written for the backward. Backward, with di = rowsum(o * do) taken by the
// caller in f32: p = exp(s - m) * (1 / l), p_dropped = p D,
// dS = (dP D - di) * p * sm_scale with dP = do v^T; dV = p_dropped^T do,
// dK = dS^T q, dQ = dS k, and ds = dS where a bias was given.
//
// Dropout: D = keep ? f32(1 / keep) : 0 with keep iff bits >= threshold
// (min(int(rate 2^32), 2^32 - 1)) and keep = 1 - threshold / 2^32, the TPU
// kernel's threshold and scale (:379-394). The bits are Philox4x32-10
// (philox.cuh) and a pure function of (seed, query row, key column), the
// same for every batch item and head: key (seed, 0), counter (j / 4, i, 1,
// 0), output word j % 4. Counter word 2, 0 in the oneshot mask, keeps the
// two streams apart. Every kernel regenerates the mask of the pairs it
// visits, so the backward drops exactly what the forward dropped.
//
// bf16 rounds where the TPU kernels round (:571-573, :1023-1024, :1045,
// :1397-1399): p D before p v, p_dropped before dV, dS before dK and dQ,
// and each output once (flash_mma.cuh). The f32 kernels of this file hold
// their tiles, row statistics and accumulators in f32. The forward follows the
// TPU's update rule block_k block by block_k block (:528-575), as the plain
// version does: m_next = max(m_prev, rowmax(s)) over the whole block first,
// then p = exp(s - m_next), l_next = rowsum(p) + exp(m_prev - m_next)
// l_prev, and the accumulator kept normalised, acc <- acc (l_corr / l_next)
// + (p v) / l_next with 1 / l_next = 1 where l_next is 0. With
// block_k >= Lk it takes the single-step variant (:585, :647-665): l
// first, then p / l before dropout and p v, and no division at the end.
//
// What bounds it on an H100: arithmetic. 4 B H Lq Lk dh flops forward (6
// with S taken twice), 8 for dK/dV (S, dP, dV, dK) and 6 for dQ (S, dP,
// dQ). At f32 all three kernels run on the TF32 tensor cores in 3xTF32
// (f32_mma.cuh: exact-f32 products from three TF32 mmas, each k step's sum
// added to the f32 accumulator rounding to nearest). At bf16 the C entries
// dispatch to the tensor-core kernels of flash_mma.cuh (kernels 9, 10 and
// 11), which also holds what every kernel here shares: the launch
// arguments, the mask value, the causal skips, the Philox bits, the score
// function and the forward's walk over the block_k blocks.
//
// What the design does about the TPU kernels' shape: those carry m, l and
// the accumulators in VMEM scratch across a sequential kv grid axis (dK/dV
// across a sequential q axis). Hopper has no sequential grid axis, so a
// loop inside the block takes its place, as in kernels 3 and 4. Every f32
// kernel here is 4 warps x 16 rows, f32 tiles streamed by cp.async into
// two-stage rings (plain loads for views whose rows are not 16-byte
// aligned), scores a sub-tile of 16 or 32 columns at a time, the C
// fragments of one product taken as the A fragments of the next
// (f32_mma.cuh's k permutation), and flash_mma.cuh's score function
// (`logits`, each launch-wide condition tested once) and lane-shared Philox
// draws (`keep_rows`, `keep_keys`):
//   9  one block a (64-query tile, batch * head), walking the block_k
//      blocks as bf16 kernel 9 walks them: per block S and its row max over
//      the 64-key tiles the block overlaps, then S again, p and P V (the
//      single step: a pass for l between), K and V tiles streamed. S is
//      computed again, not staged: a 64 x 512 block of f32 scores would
//      take 128 KiB of shared memory and one block an SM. The update keeps
//      the TPU's arithmetic and two accumulators;
//   10 one block a (64-key tile, batch * head), K and V resident, Q and dO
//      tiles and their rows' m, 1 / l, di and segment ids streamed over the
//      query tiles it visits; S^T = K Q^T and dP^T = V dO^T, so that
//      p_dropped^T and dS^T are the A fragments of dV += p_dropped^T dO and
//      dK += dS^T Q; dK and dV of its 64 keys in registers;
//   11 one block a (64-query tile, batch * head), Q and dO resident, K, V
//      and the keys' segment ids streamed over the key tiles it visits;
//      S = Q K^T and dP = dO V^T, dS into dQ += dS K and, with a bias, from
//      its registers into ds.
// Tail tiles are bounds-checked: pairs out of range, and pairs of causal
// tiles the TPU grid skips, get the logit -inf and weigh exactly 0 (in the
// forward a row that has seen none of its pairs yet keeps m = -inf, and
// its exp is taken against 0 instead, never NaN). Under `causal` the
// visited tiles of a key tile are a suffix of the query tiles and those of
// a query tile a prefix of the key tiles; the rings stream just those.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"
#include "f32_mma.cuh"
#include "flash_mma.cuh"

namespace {

using pcm::flash::Args;
using pcm::flash::FwdStep;
using pcm::flash::last_row;
using pcm::flash::logits;
using pcm::flash::next_step;
using pcm::flash::quad_max;
using pcm::flash::quad_sum;
using pcm::flash::score_ds;
using pcm::flash::Strides;
using pcm::flash::tile_skipped;

namespace mm = pcm::attn_mma;
namespace tx = pcm::tf32x3;

static_assert(tx::kTile == pcm::flash::kTileRows, "tile_skipped tests 64-row query tiles");

// ---- kernel 9 at f32: 3xTF32 on the tensor cores (f32_mma.cuh) -------------------

// Shared memory of the forward: the 64-row Q tile held for the whole block,
// two-stage rings of K and V tiles, and two stages of key segment ids.
template <int DH>
constexpr size_t f32_fwd_smem() {
  return 5 * tx::tile_bytes<DH>() + 2 * tx::kTile * sizeof(int);
}

// One block a (batch, head, 64-query tile), walking the block_k blocks it
// visits as flash_mma.cuh's fwd_kernel walks them (its FwdStep): per block
// S = q k^T and the row max m_next, then S again with p = exp(s - m_use),
// its undropped row sum and o_curr = (p D) V, the C fragments of p D taken
// as the A fragments of the product (the single step: a pass for l between,
// and p / l). At the block's end the TPU's update in its own arithmetic:
// l_next = rowsum + exp(m_prev - m_next) l_prev and acc <- acc (l_corr /
// l_next) + o_curr / l_next, rounded step by step as the plain version
// rounds it (two accumulators). `vec`: q, k and v rows 16-byte aligned.
template <int DH>
__global__ void __launch_bounds__(tx::kThreads, DH == 64 ? 2 : 1)
    f32_fwd_kernel(Args a, int vec) {
  constexpr int LD = tx::ld<DH>(), T = tx::kTile, NT = tx::sub<DH>() / 8;
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;
  float* Ks = Qs + T * LD;      // two stages
  float* Vs = Ks + 2 * T * LD;  // two stages
  int* kids = reinterpret_cast<int*>(Vs + 2 * T * LD);  // [stage][64] key segment ids

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * T;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const float* kb = (const float*)a.k + b * a.ks.b + h * a.ks.h;
  const float* vb = (const float*)a.v + b * a.vs.b + h * a.vs.h;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int cq = 2 * (lane & 3);
  // the keep threshold and the scale of a kept score; without dropout every
  // score is kept (its bits stay 0) and scaled by 1
  const uint32_t thr = a.dropout ? a.threshold : 0u;
  const float kept = a.dropout ? a.inv_keep : 1.f;
  int sq[2];  // the segment ids of rows row and row + 8 (0 past Lq or without ids)
#pragma unroll
  for (int i = 0; i < 2; ++i)
    sq[i] = a.seg_q != nullptr && row + 8 * i < a.Lq
                ? a.seg_q[(long long)b * a.Lq + row + 8 * i] : 0;
  // the key tile at step s into stage st: K, V in pass 2, the segment ids
  auto load = [&](const FwdStep& s, int st) {
    tx::load_tile<DH>(Ks + st * T * LD, kb, a.ks.l, s.t * T, a.Lk, vec);
    if (s.pass == 2) tx::load_tile<DH>(Vs + st * T * LD, vb, a.vs.l, s.t * T, a.Lk, vec);
    for (int r = threadIdx.x; r < T; r += tx::kThreads)
      kids[st * T + r] = a.seg_kv != nullptr && s.t * T + r < a.Lk
                             ? a.seg_kv[(long long)b * a.Lk + s.t * T + r] : 0;
  };

  const bool single = a.bk >= a.Lk;
  const int bk = single ? a.Lk : a.bk;
  FwdStep cur{0, min(bk, a.Lk), 0, 0};  // block 0 is visited by every row (block_q >= 2)
  tx::load_tile<DH>(Qs, (const float*)a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, vec);
  load(cur, 0);
  mm::cp_async_commit();

  // rows row and row + 8: the running state, and the current block's terms
  float acc[DH / 8][4], o_cur[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = o_cur[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float mx[2] = {-INFINITY, -INFINITY}, psum[2] = {0.f, 0.f};
  float m_next[2], m_use[2], l_single[2];
  bool run[2];

  for (int st = 0;; st ^= 1) {
    FwdStep nxt = cur;
    const bool more = next_step(a, q0, bk, single, nxt);
    if (more) load(nxt, st ^ 1);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + st * T * LD;
    const float* Vt = Vs + st * T * LD;
    const int* ids = kids + st * T;
    const int k0 = cur.t * T;
    const bool edge = k0 < cur.kb0 || k0 + T > cur.kend;  // the tile straddles the block
#pragma unroll 1
    for (int sc = 0; sc < T; sc += 8 * NT) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      tx::mma_abt<DH, NT>(s, Qs, warp * 16, Kt, sc);
      logits<NT, float>(a, bh, s, [&](int j, int e) {
        const int kc = sc + 8 * j + cq + (e & 1);  // key column in the tile
        return make_int4(row + (e >> 1) * 8, k0 + kc, sq[e >> 1], ids[kc]);
      });
      if (edge) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = k0 + sc + 8 * j + cq + (e & 1);
            if (c < cur.kb0 || c >= cur.kend) s[j][e] = -INFINITY;
          }
      }
      if (cur.pass == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      } else if (cur.pass == 1) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) psum[e >> 1] += expf(s[j][e] - m_use[e >> 1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t keep[4] = {0u, 0u, 0u, 0u};
          if (a.dropout) pcm::flash::keep_rows(keep, a.seed, row, k0 + sc + 8 * j + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float p = expf(s[j][e] - m_use[i]);
            if (single)
              p = __fdiv_rn(p, l_single[i]);
            else
              psum[i] += p;
            s[j][e] = __fmul_rn(p, keep[e] >= thr ? kept : 0.f);  // p D
          }
        }
        tx::mma_pv<DH, NT>(o_cur, s, Vt, sc);
      }
    }

    if (cur.t == (cur.kend - 1) / T) {  // the pass's last tile: the same in every thread
      if (cur.pass == 0) {
        // m_next = max(m_prev, rowmax(s)); a row whose block_q tile does not
        // reach this block (under `causal`) keeps its state
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m_next[i] = fmaxf(m_run[i], quad_max(mx[i]));
          m_use[i] = m_next[i] == -INFINITY ? 0.f : m_next[i];  // no visited pair yet
          run[i] = !a.causal || last_row(row + 8 * i, a.bq) > cur.kb0;
        }
      } else if (cur.pass == 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) l_single[i] = quad_sum(psum[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float rowsum = quad_sum(psum[i]);
          float corr = 0.f, inv = 1.f;  // single step: acc <- o_curr
          if (run[i]) {
            if (single) {
              l_run[i] = l_single[i];
            } else {
              // l_next = rowsum(p) + alpha l_prev; 1 / l_next taken as 1 where 0
              const float l_corr = __fmul_rn(expf(m_run[i] - m_use[i]), l_run[i]);
              const float l_next = __fadd_rn(rowsum, l_corr);
              inv = l_next == 0.f ? 1.f : __fdiv_rn(1.0f, l_next);
              corr = __fmul_rn(l_corr, inv);
              l_run[i] = l_next;
            }
            m_run[i] = m_next[i];
#pragma unroll
            for (int j = 0; j < DH / 8; ++j)
#pragma unroll
              for (int e = 2 * i; e < 2 * i + 2; ++e)
                acc[j][e] = single ? o_cur[j][e]
                                   : __fadd_rn(__fmul_rn(acc[j][e], corr),
                                               __fmul_rn(o_cur[j][e], inv));
          }
          mx[i] = -INFINITY;
          psum[i] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o_cur[j][e] = 0.f;
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
    if (!more) break;
    cur = nxt;
  }

  const long long sb = (long long)bh * a.Lq;
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row + 8 * i < a.Lq) {
        a.l[sb + row + 8 * i] = l_run[i];
        a.m[sb + row + 8 * i] = m_run[i];
      }
  }
  float* ob = (float*)a.o + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e >> 1) * 8;
      if (r < a.Lq) ob[(long long)r * a.os.l + c + (e & 1)] = acc[j][e];
    }
  }
}

// ---- kernels 10 and 11 at f32: 3xTF32 on the tensor cores (f32_mma.cuh) -------------

// Shared memory of the backward kernels: two 64-row tiles held for the
// whole block, two two-stage rings of streamed tiles, and two stages of
// per-row terms (dK/dV: m, 1 / l, di and the segment id of 64 queries; dQ:
// the segment ids of 64 keys, in the same room).
template <int DH>
constexpr size_t f32_bwd_smem() {
  return 6 * tx::tile_bytes<DH>() + 2 * 4 * tx::kTile * sizeof(float);
}

// Query columns a sub-tile of kernel 10 at both dh: at dh = 64, 32
// (tx::sub) left it at 255 registers with 36 B stored and 92 B loaded
// spilled; 16 fits it in 224 without a spill and ran 5-7% faster (H100
// 80GB HBM3 at 700 W, scripts/ab_kernel_builds.py).
constexpr int kDkvSub = 16;

// One block a (batch, head, 64-key tile), looping over the query tiles it
// visits: S^T = K Q^T and dP^T = V dO^T a sub-tile at a time, their logits
// by flash's score function in the key-row layout, then dV += p_dropped^T dO
// and dK += dS^T Q, the C fragments of p_dropped^T and dS^T taken as the A
// fragments of the two sums. `vec`: q, k, v and dout rows 16-byte aligned.
template <int DH>
__global__ void __launch_bounds__(tx::kThreads, DH == 64 ? 2 : 1)
    f32_dkv_kernel(Args a, int vec) {
  constexpr int LD = tx::ld<DH>(), T = tx::kTile, NT = kDkvSub / 8;
  extern __shared__ __align__(16) float smf[];
  float* Ks = smf;
  float* Vs = Ks + T * LD;
  float* Qs = Vs + T * LD;          // two stages
  float* dOs = Qs + 2 * T * LD;     // two stages
  float* rows = dOs + 2 * T * LD;   // [stage][m, 1/l, di, id][64]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * T;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const float* qb = (const float*)a.q + b * a.qs.b + h * a.qs.h;
  const float* dob = (const float*)a.dout + b * a.dos.b + h * a.dos.h;
  const int key = k0 + warp * 16 + (lane >> 2);  // and key + 8
  const int cq = 2 * (lane & 3);
  const long long sb = (long long)bh * a.Lq;
  // the keep threshold and the scale of a kept score; without dropout every
  // score is kept (its bits stay 0) and scaled by 1
  const uint32_t thr = a.dropout ? a.threshold : 0u;
  const float kept = a.dropout ? a.inv_keep : 1.f;
  int skv[2];  // the segment ids of keys key and key + 8 (0 past Lk or without ids)
#pragma unroll
  for (int i = 0; i < 2; ++i)
    skv[i] = a.seg_kv != nullptr && key + 8 * i < a.Lk
                 ? a.seg_kv[(long long)b * a.Lk + key + 8 * i] : 0;

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // query tile q0 into stage st: its Q and dO rows, and its rows' terms by
  // plain loads (0 past Lq)
  auto load = [&](int st, int q0) {
    tx::load_tile<DH>(Qs + st * T * LD, qb, a.qs.l, q0, a.Lq, vec);
    tx::load_tile<DH>(dOs + st * T * LD, dob, a.dos.l, q0, a.Lq, vec);
    float* sp = rows + st * 4 * T;
    int* ids = reinterpret_cast<int*>(sp + 3 * T);
    for (int r = threadIdx.x; r < T; r += tx::kThreads) {
      const bool in = q0 + r < a.Lq;
      sp[r] = in ? a.m[sb + q0 + r] : 0.f;
      sp[T + r] = in ? 1.0f / a.l[sb + q0 + r] : 0.f;
      sp[2 * T + r] = in ? a.di[sb + q0 + r] : 0.f;
      ids[r] = a.seg_q != nullptr && in ? a.seg_q[(long long)b * a.Lq + q0 + r] : 0;
    }
  };

  // under `causal` the query tiles this key tile visits are a suffix
  const int n_qt = (a.Lq + T - 1) / T;
  int qt0 = 0;
  while (qt0 < n_qt && tile_skipped(a, qt0 * T, k0)) ++qt0;
  if (qt0 < n_qt) {
    tx::load_tile<DH>(Ks, (const float*)a.k + b * a.ks.b + h * a.ks.h, a.ks.l, k0, a.Lk, vec);
    tx::load_tile<DH>(Vs, (const float*)a.v + b * a.vs.b + h * a.vs.h, a.vs.l, k0, a.Lk, vec);
    load(0, qt0 * T);
    mm::cp_async_commit();
  }
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    const float* Qt = Qs + st * T * LD;
    const float* dOt = dOs + st * T * LD;
    if (qt + 1 < n_qt) load(st ^ 1, (qt + 1) * T);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const float* sm_m = rows + st * 4 * T;
    const float* sm_r = sm_m + T;
    const float* sm_d = sm_r + T;
    const int* sm_id = reinterpret_cast<const int*>(sm_d + T);
    const int q0 = qt * T;
#pragma unroll 1
    for (int sc = 0; sc < T; sc += 8 * NT) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      tx::mma_abt<DH, NT>(s, Ks, warp * 16, Qt, sc);    // S^T
      tx::mma_abt<DH, NT>(dp, Vs, warp * 16, dOt, sc);  // dP^T
      logits<NT, float>(a, bh, s, [&](int j, int e) {
        const int qc = sc + 8 * j + cq + (e & 1);  // query column in the tile
        return make_int4(q0 + qc, key + (e >> 1) * 8, sm_id[qc], skv[e >> 1]);
      });
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = sc + 8 * j + cq;  // query column in the tile
        uint32_t keep[4] = {0u, 0u, 0u, 0u};
        if (a.dropout) pcm::flash::keep_keys(keep, a.seed, key, q0 + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c + (e & 1);
          const float d = keep[e] >= thr ? kept : 0.f;
          // dS, and p_dropped into s
          dp[j][e] = score_ds(s[j][e], dp[j][e], sm_m[qc], sm_r[qc], sm_d[qc], d, a.scale,
                              s[j][e]);
        }
      }
      tx::mma_pv<DH, NT>(dv, s, dOt, sc);
      tx::mma_pv<DH, NT>(dk, dp, Qt, sc);
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

  float* dkb = (float*)a.dk + b * a.dks.b + h * a.dks.h;
  float* dvb = (float*)a.dv + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = key + (e >> 1) * 8;
      if (r < a.Lk) {
        dkb[(long long)r * a.dks.l + c + (e & 1)] = dk[j][e];
        dvb[(long long)r * a.dvs.l + c + (e & 1)] = dv[j][e];
      }
    }
  }
}

// One block a (batch, head, 64-query tile), looping over the key tiles it
// visits: S = Q K^T and dP = dO V^T a sub-tile at a time, their logits in
// the query-row layout, then dQ += dS K, the C fragments of dS taken as A
// fragments, and dS from its registers into `ds` when a bias was given. dS
// carries sm_scale, so dQ is written as summed. `vec` as for
// f32_dkv_kernel.
template <int DH>
__global__ void __launch_bounds__(tx::kThreads, DH == 64 ? 2 : 1)
    f32_dq_kernel(Args a, int vec) {
  constexpr int LD = tx::ld<DH>(), T = tx::kTile, NT = tx::sub<DH>() / 8;
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;
  float* dOs = Qs + T * LD;
  float* Ks = dOs + T * LD;     // two stages
  float* Vs = Ks + 2 * T * LD;  // two stages
  int* kids = reinterpret_cast<int*>(Vs + 2 * T * LD);  // [stage][64] key segment ids

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * T;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const float* kb = (const float*)a.k + b * a.ks.b + h * a.ks.h;
  const float* vb = (const float*)a.v + b * a.vs.b + h * a.vs.h;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int cq = 2 * (lane & 3);
  const uint32_t thr = a.dropout ? a.threshold : 0u;
  const float kept = a.dropout ? a.inv_keep : 1.f;
  // m, 1 / l, di and the segment id of rows row and row + 8 (0 past Lq)
  float m[2], inv_l[2], di[2];
  int sq[2];
  const long long sb = (long long)bh * a.Lq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    const bool in = r < a.Lq;
    m[i] = in ? a.m[sb + r] : 0.f;
    inv_l[i] = in ? 1.0f / a.l[sb + r] : 0.f;
    di[i] = in ? a.di[sb + r] : 0.f;
    sq[i] = a.seg_q != nullptr && in ? a.seg_q[(long long)b * a.Lq + r] : 0;
  }
  // key tile kt into stage st: its K and V rows, and their segment ids by
  // plain loads (0 past Lk)
  auto load = [&](int st, int kt) {
    tx::load_tile<DH>(Ks + st * T * LD, kb, a.ks.l, kt * T, a.Lk, vec);
    tx::load_tile<DH>(Vs + st * T * LD, vb, a.vs.l, kt * T, a.Lk, vec);
    for (int r = threadIdx.x; r < T; r += tx::kThreads)
      kids[st * T + r] = a.seg_kv != nullptr && kt * T + r < a.Lk
                             ? a.seg_kv[(long long)b * a.Lk + kt * T + r] : 0;
  };

  // under `causal` the key tiles this query tile visits are a prefix (the
  // first is always visited: block_q >= 2)
  int n_kt = (a.Lk + T - 1) / T;
  while (n_kt > 1 && tile_skipped(a, q0, (n_kt - 1) * T)) --n_kt;
  tx::load_tile<DH>(Qs, (const float*)a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, vec);
  tx::load_tile<DH>(dOs, (const float*)a.dout + b * a.dos.b + h * a.dos.h, a.dos.l, q0, a.Lq,
                    vec);
  load(0, 0);
  mm::cp_async_commit();

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  float* ds = (float*)a.ds;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) load(st ^ 1, kt + 1);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + st * T * LD;
    const float* Vt = Vs + st * T * LD;
    const int* ids = kids + st * T;
    const int k0 = kt * T;
#pragma unroll 1
    for (int sc = 0; sc < T; sc += 8 * NT) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      tx::mma_abt<DH, NT>(s, Qs, warp * 16, Kt, sc);
      tx::mma_abt<DH, NT>(dp, dOs, warp * 16, Vt, sc);
      logits<NT, float>(a, bh, s, [&](int j, int e) {
        const int kc = sc + 8 * j + cq + (e & 1);  // key column in the tile
        return make_int4(row + (e >> 1) * 8, k0 + kc, sq[e >> 1], ids[kc]);
      });
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t keep[4] = {0u, 0u, 0u, 0u};
        if (a.dropout) pcm::flash::keep_rows(keep, a.seed, row, k0 + sc + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float d = keep[e] >= thr ? kept : 0.f;
          float pd;
          s[j][e] = score_ds(s[j][e], dp[j][e], m[i], inv_l[i], di[i], d, a.scale, pd);  // dS
        }
      }
      if (ds != nullptr) {  // the bias gradient: dS of the pairs in range
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = row + (e >> 1) * 8, c = k0 + sc + 8 * j + cq + (e & 1);
            if (r < a.Lq && c < a.Lk) ds[(sb + r) * a.Lk + c] = s[j][e];
          }
      }
      tx::mma_pv<DH, NT>(acc, s, Kt, sc);
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

  float* dqb = (float*)a.dq + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e >> 1) * 8;
      if (r < a.Lq) dqb[(long long)r * a.dqs.l + c + (e & 1)] = acc[j][e];
    }
  }
}

enum Which { kFwd, kDkv, kDq };

template <typename T, int DH>
cudaError_t launch(Which w, const Args& args, int B, cudaStream_t stream) {
  if constexpr (pcm::is_bf16<T>::value) {  // kernels 9, 10 and 11 on the tensor cores
    if (w == kFwd) return pcm::flash::launch_fwd<DH>(args, B, stream);
    return pcm::flash::launch_bwd<DH>(w == kDkv, args, B, stream);
  } else {
    if (w == kFwd) {  // kernel 9 in 3xTF32
      const int vec = tx::rows_aligned(args.q, args.qs) && tx::rows_aligned(args.k, args.ks) &&
                      tx::rows_aligned(args.v, args.vs);
      const size_t smem = f32_fwd_smem<DH>();
      const cudaError_t err = cudaFuncSetAttribute(
          f32_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      f32_fwd_kernel<DH><<<dim3((args.Lq + tx::kTile - 1) / tx::kTile, B * args.H),
                           tx::kThreads, smem, stream>>>(args, vec);
      return cudaGetLastError();
    }
    // kernel 10 or 11 in 3xTF32
    const int vec = tx::rows_aligned(args.q, args.qs) && tx::rows_aligned(args.k, args.ks) &&
                    tx::rows_aligned(args.v, args.vs) && tx::rows_aligned(args.dout, args.dos);
    const size_t smem = f32_bwd_smem<DH>();
    void (*kernel)(Args, int) = w == kDkv ? f32_dkv_kernel<DH> : f32_dq_kernel<DH>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int rows = w == kDkv ? args.Lk : args.Lq;
    kernel<<<dim3((rows + tx::kTile - 1) / tx::kTile, B * args.H), tx::kThreads, smem, stream>>>(
        args, vec);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_dh(Which w, int dh, const Args& a, int B, cudaStream_t s) {
  if (dh == 64) return launch<T, 64>(w, a, B, s);
  if (dh == 128) return launch<T, 128>(w, a, B, s);
  return cudaErrorInvalidValue;
}

// Fills the fields every entry shares and launches kernel `w`.
int run(Which w, Args& a, const void* q, const void* k, const void* v, const void* ab,
        const int* seg_q, const int* seg_kv, int B, int H, int Lq, int Lk, int dh, int causal,
        int block_q, int block_k, float sm_scale, unsigned threshold, float inv_keep,
        unsigned seed, int dropout, int bf16, int device, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || B * H > 65535 || block_q < 2 || block_k < 1 ||
      (seg_q == nullptr) != (seg_kv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ab = ab;
  a.seg_q = seg_q;
  a.seg_kv = seg_kv;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.causal = causal;
  a.bq = block_q;
  a.bk = block_k;
  a.scale = sm_scale;
  a.threshold = threshold;
  a.inv_keep = inv_keep;
  a.seed = seed;
  a.dropout = dropout;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return (int)launch_dh<pcm::bf16>(w, dh, a, B, s);
  return (int)launch_dh<float>(w, dh, a, B, s);
}

Strides at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

}  // namespace

extern "C" {

// Common arguments of the three entries. q (B, H, Lq, dh), k and v (B, H,
// Lk, dh), all f32 (bf16 == 0) or all bf16 (bf16 != 0) on device `device`,
// each given by base pointer and (batch, head, row) strides in elements,
// last axis contiguous; dh is 64 or 128. `ab` is a contiguous (B, H, Lq,
// Lk) bias of the same type, or null. seg_q and seg_kv are contiguous
// (B, Lq) and (B, Lk) int32 segment ids, or both null. `causal`,
// block_q >= 2 and block_k >= 1 (the TPU grid's tile, which decides the
// causal skips), sm_scale (f32), and the dropout threshold, inv_keep =
// 1 / keep, seed and flag as the module docstring gives them. Each entry
// launches one kernel on `stream` and returns the cudaError_t of its launch.

// Kernel 9. `strides` holds 12 values: (b, h, l) of q, k, v, o. Writes o
// (B, H, Lq, dh) of the inputs' type and l, m, contiguous (B, H, Lq) f32.
int pcm_flash_fwd(const void* q, const void* k, const void* v, const void* ab,
                  const int* seg_q, const int* seg_kv, void* o, float* l, float* m,
                  const long long* strides, int B, int H, int Lq, int Lk, int dh, int causal,
                  int block_q, int block_k, float sm_scale, unsigned threshold,
                  float inv_keep, unsigned seed, int dropout, int bf16, int device,
                  void* stream) {
  Args a = {};
  a.o = o;
  a.l = l;
  a.m = m;
  a.qs = at(strides, 0);
  a.ks = at(strides, 1);
  a.vs = at(strides, 2);
  a.os = at(strides, 3);
  return run(kFwd, a, q, k, v, ab, seg_q, seg_kv, B, H, Lq, Lk, dh, causal, block_q, block_k,
             sm_scale, threshold, inv_keep, seed, dropout, bf16, device, stream);
}

// Kernel 10. l, m: the forward's statistics; dout (B, H, Lq, dh) of the
// inputs' type; di = rowsum(o * dout), contiguous (B, H, Lq) f32.
// `strides` holds 18 values: (b, h, l) of q, k, v, dout, dk, dv. Writes dk
// and dv (B, H, Lk, dh) of the inputs' type.
int pcm_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* ab,
                      const int* seg_q, const int* seg_kv, const float* l, const float* m,
                      const void* dout, const float* di, void* dk, void* dv,
                      const long long* strides, int B, int H, int Lq, int Lk, int dh,
                      int causal, int block_q, int block_k, float sm_scale,
                      unsigned threshold, float inv_keep, unsigned seed, int dropout,
                      int bf16, int device, void* stream) {
  Args a = {};
  a.l = (float*)l;
  a.m = (float*)m;
  a.dout = dout;
  a.di = di;
  a.dk = dk;
  a.dv = dv;
  a.qs = at(strides, 0);
  a.ks = at(strides, 1);
  a.vs = at(strides, 2);
  a.dos = at(strides, 3);
  a.dks = at(strides, 4);
  a.dvs = at(strides, 5);
  return run(kDkv, a, q, k, v, ab, seg_q, seg_kv, B, H, Lq, Lk, dh, causal, block_q,
             block_k, sm_scale, threshold, inv_keep, seed, dropout, bf16, device, stream);
}

// Kernel 11. As kernel 10; `strides` holds 15 values: (b, h, l) of q, k,
// v, dout, dq. Writes dq (B, H, Lq, dh) of the inputs' type and, when `ds`
// is not null (a bias was given), the visited tiles of ds, contiguous
// (B, H, Lq, Lk) of the inputs' type; the caller zeroes ds first.
int pcm_flash_bwd_dq(const void* q, const void* k, const void* v, const void* ab,
                     const int* seg_q, const int* seg_kv, const float* l, const float* m,
                     const void* dout, const float* di, void* dq, void* ds,
                     const long long* strides, int B, int H, int Lq, int Lk, int dh,
                     int causal, int block_q, int block_k, float sm_scale,
                     unsigned threshold, float inv_keep, unsigned seed, int dropout, int bf16,
                     int device, void* stream) {
  Args a = {};
  a.l = (float*)l;
  a.m = (float*)m;
  a.dout = dout;
  a.di = di;
  a.dq = dq;
  a.ds = ds;
  a.qs = at(strides, 0);
  a.ks = at(strides, 1);
  a.vs = at(strides, 2);
  a.dos = at(strides, 3);
  a.dqs = at(strides, 4);
  return run(kDq, a, q, k, v, ab, seg_q, seg_kv, B, H, Lq, Lk, dh, causal, block_q, block_k,
             sm_scale, threshold, inv_keep, seed, dropout, bf16, device, stream);
}

}  // extern "C"
