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
// dQ). At f32, kernel 9 runs on the TF32 tensor cores in 3xTF32
// (f32_mma.cuh: exact-f32 products from three TF32 mmas) and kernels 10 and
// 11 on the FP32 pipes as f32 FMAs. At bf16 the C entries dispatch to the
// tensor-core kernels of flash_mma.cuh (kernels 9, 10 and 11), which also
// holds what every kernel here shares: the launch arguments, the mask value,
// the causal skips, the Philox bits, the score function and the forward's
// walk over the block_k blocks.
//
// What the design does about the TPU kernels' shape: those carry m, l and
// the accumulators in VMEM scratch across a sequential kv grid axis (dK/dV
// across a sequential q axis). Hopper has no sequential grid axis, so a
// loop inside the block takes its place, as in kernels 3 and 4:
//   9  (f32) one block a (64-query tile, batch * head), 4 warps x 16 rows,
//      walking the block_k blocks as bf16 kernel 9 walks them: per block S
//      and its row max over the 64-key tiles the block overlaps, then S
//      again, p and P V (the single step: a pass for l between), K and V
//      tiles streamed by cp.async into two-stage rings. S is computed again,
//      not staged: a 64 x 512 block of f32 scores would take 128 KiB of
//      shared memory and one block an SM. The C fragments of p D are the A
//      fragments of P V (f32_mma.cuh's k permutation), and the update keeps
//      the TPU's arithmetic and two accumulators;
//   10 (f32) one block a (64-key tile, batch * head); it loops over the query
//      tiles, dK and dV of its 64 keys in registers;
//   11 (f32) one block a (64-query tile, batch * head); it loops over the key
//      tiles, dQ of its 64 queries in registers, and writes its ds tiles.
// Kernels 10 and 11 take 256 threads a block, each a 4x4 register tile of
// the 64x64 score work, shared tiles padded by one float a row. Tail tiles
// are bounds-checked: pairs out of range, and pairs of causal tiles the TPU
// grid skips, get the logit -inf and weigh exactly 0 (a row that has seen
// none of its pairs yet keeps m = -inf, and its exp is taken against 0
// instead, never NaN). A 64x64 tile none of whose pairs is visited is
// skipped.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"
#include "f32_mma.cuh"
#include "flash_mma.cuh"
#include "philox.cuh"

namespace {

using pcm::round_to;
using pcm::to_f;
using pcm::flash::Args;
using pcm::flash::flash_keep_bits4;
using pcm::flash::FwdStep;
using pcm::flash::kMaskValue;
using pcm::flash::last_row;
using pcm::flash::logits;
using pcm::flash::next_step;
using pcm::flash::quad_max;
using pcm::flash::quad_sum;
using pcm::flash::Strides;
using pcm::flash::tile_skipped;

namespace mm = pcm::attn_mma;
namespace tx = pcm::tf32x3;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
static_assert(kBQ == pcm::flash::kTileRows, "tile_skipped tests 64-row query tiles");

// The logit of (row, col) from the product s = q . k, or -inf for a pair
// out of range or not visited. sq and skv are the pair's segment ids.
template <typename T>
__device__ __forceinline__ float logit(const Args& a, long long bh, int row, int col, float s,
                                       int sq, int skv) {
  if (row >= a.Lq || col >= a.Lk) return -INFINITY;
  if (a.causal && last_row(row, a.bq) <= (col / a.bk) * a.bk) return -INFINITY;
  if (a.ab != nullptr)
    s = __fadd_rn(s, to_f(((const T*)a.ab)[(bh * a.Lq + row) * a.Lk + col]));
  s = __fmul_rn(s, a.scale);
  const bool masked = (a.seg_q != nullptr && sq != skv) || (a.causal && col > row);
  return masked ? __fadd_rn(s, kMaskValue) : s;
}

// The 4x4 register tile of products of rows ty + 16 i of A and rows
// tx + 16 j of B (both DH wide in shared memory, row pitch DH + 1).
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, float (&s)[4][4]) {
  constexpr int LD = DH + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// Rows r0.. of a (batch, head) slice into shared memory (pitch ld), zero
// past `rows`.
template <typename T, int DH>
__device__ __forceinline__ void load_rows(const T* base, long long stride, int r0, int rows,
                                          float* dst, int ld) {
  for (int e = threadIdx.x; e < 64 * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    dst[r * ld + c] = r0 + r < rows ? to_f(base[(r0 + r) * stride + c]) : 0.f;
  }
}

// Segment ids of rows r0 .. r0 + 63 of batch item b (0 past `rows` or
// without segment ids).
__device__ __forceinline__ void load_ids(const int* ids, int b, int r0, int rows, int* dst) {
  for (int r = threadIdx.x; r < 64; r += kThreads)
    dst[r] = ids != nullptr && r0 + r < rows ? ids[(long long)b * rows + r0 + r] : 0;
}

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

template <int DH>
constexpr size_t bwd_smem_bytes() {
  return (4 * (size_t)kBQ * (DH + 1) + 2 * (size_t)kBQ * (kBK + 1) + 3 * kBQ) *
             sizeof(float) + (kBQ + kBK) * sizeof(int);
}

// Shared memory of the backward kernels.
template <int DH>
struct BwdTiles {
  float *Ks, *Vs, *Qs, *dOs, *Ps, *dSs, *rm, *rl, *rd;
  int *sq, *skv;
  __device__ explicit BwdTiles(float* sm) {
    constexpr int LD = DH + 1;
    Ks = sm;
    Vs = Ks + kBK * LD;
    Qs = Vs + kBK * LD;
    dOs = Qs + kBQ * LD;
    Ps = dOs + kBQ * LD;
    dSs = Ps + kBQ * (kBK + 1);
    rm = dSs + kBQ * (kBK + 1);
    rl = rm + kBQ;
    rd = rl + kBQ;
    sq = (int*)(rd + kBQ);
    skv = sq + kBQ;
  }
};

// Query rows q0.. of q and do, their m, 1 / l and di, and their segment ids.
template <typename T, int DH>
__device__ __forceinline__ void load_query_tile(const Args& a, int bh, int b, int h, int q0,
                                                const BwdTiles<DH>& t) {
  load_rows<T, DH>((const T*)a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, t.Qs, DH + 1);
  load_rows<T, DH>((const T*)a.dout + b * a.dos.b + h * a.dos.h, a.dos.l, q0, a.Lq, t.dOs,
                   DH + 1);
  load_ids(a.seg_q, b, q0, a.Lq, t.sq);
  const long long base = (long long)bh * a.Lq + q0;
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < a.Lq;
    t.rm[r] = in ? a.m[base + r] : 0.f;
    t.rl[r] = in ? 1.0f / a.l[base + r] : 0.f;
    t.rd[r] = in ? a.di[base + r] : 0.f;
  }
}

// Key rows k0.. of k and v, and their segment ids.
template <typename T, int DH>
__device__ __forceinline__ void load_key_tile(const Args& a, int b, int h, int k0,
                                              const BwdTiles<DH>& t) {
  load_rows<T, DH>((const T*)a.k + b * a.ks.b + h * a.ks.h, a.ks.l, k0, a.Lk, t.Ks, DH + 1);
  load_rows<T, DH>((const T*)a.v + b * a.vs.b + h * a.vs.h, a.vs.l, k0, a.Lk, t.Vs, DH + 1);
  load_ids(a.seg_kv, b, k0, a.Lk, t.skv);
}

// Recomputes the (64 query x 64 key) tile at (q0, k0) and leaves p_dropped
// in Ps and dS in dSs (row = query, column = key), both rounded to T; 0 for
// pairs not visited. Every thread of the block calls it; it ends with the
// tiles complete.
template <typename T, int DH>
__device__ __forceinline__ void probs_and_ds(const Args& a, long long bh, int q0, int k0,
                                             const BwdTiles<DH>& t) {
  constexpr int LDP = kBK + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
  tile_dot<DH>(t.Qs, t.Ks, s);
  tile_dot<DH>(t.dOs, t.Vs, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float x = logit<T>(a, bh, q0 + r, k0 + c, s[i][j], t.sq[r], t.skv[c]);
      const float p = x == -INFINITY ? 0.f : __fmul_rn(expf(x - t.rm[r]), t.rl[r]);
      if (a.dropout) {  // finished in the pass below
        t.Ps[r * LDP + c] = p;
        t.dSs[r * LDP + c] = dp[i][j];
      } else {
        t.Ps[r * LDP + c] = round_to<T>(p);
        t.dSs[r * LDP + c] =
            p == 0.f ? 0.f
                     : round_to<T>(__fmul_rn(__fmul_rn(__fsub_rn(dp[i][j], t.rd[r]), p), a.scale));
      }
    }
  }
  __syncthreads();
  if (a.dropout) {
    for (int gi = threadIdx.x; gi < kBQ * (kBK / 4); gi += kThreads) {
      const int r = gi / (kBK / 4), c4 = (gi % (kBK / 4)) * 4;
      const uint4 bits = flash_keep_bits4(a.seed, q0 + r, (k0 + c4) >> 2);
      const uint32_t w[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = r * LDP + c4 + e;
        const float d = w[e] >= a.threshold ? a.inv_keep : 0.f;
        const float p = t.Ps[at];
        t.dSs[at] = p == 0.f ? 0.f
                             : round_to<T>(__fmul_rn(
                                   __fmul_rn(__fsub_rn(__fmul_rn(t.dSs[at], d), t.rd[r]), p),
                                   a.scale));
        t.Ps[at] = round_to<T>(__fmul_rn(p, d));
      }
    }
    __syncthreads();
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int LD = DH + 1;
  constexpr int LDP = kBK + 1;
  constexpr int CJ = DH / 16;  // output columns a thread
  extern __shared__ float sm[];
  const BwdTiles<DH> t(sm);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;

  float dk[4][CJ], dv[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  load_key_tile<T, DH>(a, b, h, k0, t);
  const int n_qt = (a.Lq + kBQ - 1) / kBQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    if (tile_skipped(a, q0, k0)) continue;  // the same for every thread
    __syncthreads();  // the previous query tile is consumed (and the key tile loaded)
    load_query_tile<T, DH>(a, bh, b, h, q0, t);
    __syncthreads();
    probs_and_ds<T, DH>(a, bh, q0, k0, t);
    // dV += p_dropped^T dO and dK += dS^T Q: key rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float pk[4], sk[4], dov[CJ], qv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = t.Ps[qq * LDP + ty + 16 * i];
        sk[i] = t.dSs[qq * LDP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        dov[j] = t.dOs[qq * LD + tx + 16 * j];
        qv[j] = t.Qs[qq * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          dv[i][j] = fmaf(pk[i], dov[j], dv[i][j]);
          dk[i][j] = fmaf(sk[i], qv[j], dk[i][j]);
        }
    }
  }

  T* dkb = (T*)a.dk + b * a.dks.b + h * a.dks.h;
  T* dvb = (T*)a.dv + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= a.Lk) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      dkb[kr * a.dks.l + tx + 16 * j] = pcm::from_f<T>(dk[i][j]);
      dvb[kr * a.dvs.l + tx + 16 * j] = pcm::from_f<T>(dv[i][j]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int LD = DH + 1;
  constexpr int LDP = kBK + 1;
  constexpr int CJ = DH / 16;
  extern __shared__ float sm[];
  const BwdTiles<DH> t(sm);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;

  load_query_tile<T, DH>(a, bh, b, h, q0, t);
  float dq[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dq[i][j] = 0.f;

  T* ds = (T*)a.ds;
  const int n_kt = (a.Lk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (tile_skipped(a, q0, k0)) continue;  // its ds stays the caller's zeros
    __syncthreads();  // the previous key tile is consumed (and the query tile loaded)
    load_key_tile<T, DH>(a, b, h, k0, t);
    __syncthreads();
    probs_and_ds<T, DH>(a, bh, q0, k0, t);
    if (ds != nullptr) {  // the bias gradient: this tile of dS, rows and columns in range
      for (int e = threadIdx.x; e < kBQ * kBK; e += kThreads) {
        const int r = e / kBK, c = e % kBK;
        if (q0 + r < a.Lq && k0 + c < a.Lk)
          ds[((long long)bh * a.Lq + q0 + r) * a.Lk + k0 + c] =
              pcm::from_f<T>(t.dSs[r * LDP + c]);
      }
    }
    // dQ += dS K: query rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float sv[4], kv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = t.dSs[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = t.Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) dq[i][j] = fmaf(sv[i], kv[j], dq[i][j]);
    }
  }

  T* dqb = (T*)a.dq + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) dqb[qr * a.dqs.l + tx + 16 * j] = pcm::from_f<T>(dq[i][j]);
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
    const size_t smem = bwd_smem_bytes<DH>();
    void (*kernel)(Args) = w == kDkv ? flash_dkv_kernel<T, DH> : flash_dq_kernel<T, DH>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int tiles = w == kDkv ? (args.Lk + kBK - 1) / kBK : (args.Lq + kBQ - 1) / kBQ;
    kernel<<<dim3(tiles, B * args.H), kThreads, smem, stream>>>(args);
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
