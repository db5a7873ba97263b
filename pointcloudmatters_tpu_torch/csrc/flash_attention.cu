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
// and each output once (flash_mma.cuh). The kernels of this file hold their
// tiles, row statistics and accumulators in f32. The forward follows the
// TPU's update rule block_k block by block_k block (:528-575), as the plain
// version does: m_next = max(m_prev, rowmax(s)) over the whole block first,
// then p = exp(s - m_next), l_next = rowsum(p) + exp(m_prev - m_next)
// l_prev, and the accumulator kept normalised, acc <- acc (l_corr / l_next)
// + (p v) / l_next with 1 / l_next = 1 where l_next is 0. With
// block_k >= Lk it takes the single-step variant (:585, :647-665): l
// first, then p / l before dropout and p v, and no division at the end.
//
// What bounds it on an H100: arithmetic. 4 B H Lq Lk dh flops forward, 8
// for dK/dV (S, dP, dV, dK) and 6 for dQ (S, dP, dQ). The kernels below are
// the f32 instances, f32 FMAs on the FP32 pipes (TF32 would round their
// operands). At bf16 the C entries dispatch to the tensor-core kernels of
// flash_mma.cuh (kernels 9, 10 and 11), which also holds what every kernel
// here shares: the launch arguments, the mask value, the causal skips and
// the Philox bits.
//
// What the design does about the TPU kernels' shape: those carry m, l and
// the accumulators in VMEM scratch across a sequential kv grid axis (dK/dV
// across a sequential q axis). Hopper has no sequential grid axis, so a
// loop inside the block takes its place, as in kernels 3 and 4
// (attention_fwd.cuh, attention_bwd.cu, whose tiling this file follows and
// leaves untouched):
//   9  (f32) one block a (64-query tile, batch * head); for each block_k block
//      of keys it takes the row max over the block's 64-key tiles, then p
//      and p v tile by tile, and updates m, l and the accumulators once. A
//      block's 64 x block_k scores are staged in shared memory when they fit
//      (128 KiB at the flagship's 512, beside the Q, K and V tiles);
//      otherwise each pass computes them again;
//   10 (f32) one block a (64-key tile, batch * head); it loops over the query
//      tiles, dK and dV of its 64 keys in registers;
//   11 (f32) one block a (64-query tile, batch * head); it loops over the key
//      tiles, dQ of its 64 queries in registers, and writes its ds tiles.
// 256 threads a block, each a 4x4 register tile of the 64x64 score work;
// shared tiles padded by one float a row. Tail tiles are bounds-checked:
// pairs out of range, and pairs of causal tiles the TPU grid skips, get the
// logit -inf and weigh exactly 0 (a row that has seen none of its pairs yet
// keeps m = -inf, and its exp is taken against 0 instead, never NaN). A
// 64x64 tile none of whose pairs is visited is skipped.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"
#include "flash_mma.cuh"
#include "philox.cuh"

namespace {

using pcm::round_to;
using pcm::to_f;
using pcm::flash::Args;
using pcm::flash::flash_keep_bits4;
using pcm::flash::kMaskValue;
using pcm::flash::last_row;
using pcm::flash::Strides;
using pcm::flash::tile_skipped;

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

// Dynamic shared memory of the forward at a score pitch of `sp` floats:
// the Q, K and V tiles, 64 rows of scores (a whole block_k block when it is
// staged, else one 64-key tile) and the segment ids.
template <int DH>
constexpr size_t fwd_smem_bytes(int sp) {
  return ((size_t)kBQ * (DH + 1) + (size_t)kBK * (DH + 1) + (size_t)kBK * DH +
          (size_t)kBQ * sp) * sizeof(float) + (kBQ + kBK) * sizeof(int);
}

// The 64x64 logit tile at key column k0 of a block that ends at `kend`:
// loads the K tile (rows up to kend) and its segment ids, then s[i][j] for
// row ty + 16 i, column tx + 16 j, -inf past kend. Every thread calls it.
template <typename T, int DH>
__device__ __forceinline__ void fwd_logits(const Args& a, long long bh, int b, const T* kb,
                                           int q0, int k0, int kend, const float* Qs,
                                           float* Ks, const int* sq, int* skv,
                                           float (&s)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  __syncthreads();  // the previous K tile is consumed
  load_rows<T, DH>(kb, a.ks.l, k0, kend, Ks, DH + 1);
  load_ids(a.seg_kv, b, k0, a.Lk, skv);
  __syncthreads();
  tile_dot<DH>(Qs, Ks, s);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      s[i][j] = k0 + c < kend ? logit<T>(a, bh, q0 + r, k0 + c, s[i][j], sq[r], skv[c])
                              : -INFINITY;
    }
}

// The sum, or the maximum, of v over the 16 threads that share a row group
// (lanes 16 (ty & 1) + tx of warp ty / 2); a butterfly, so every one of them
// gets the same bits.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int LD = DH + 1;   // padded row of Q and K tiles
  constexpr int CJ = DH / 16;  // output columns a thread
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ss = Vs + kBK * DH;  // 64 rows of pitch a.sp: scores, then p
  int* sq = (int*)(Ss + kBQ * a.sp);
  int* skv = sq + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const T* kb = (const T*)a.k + b * a.ks.b + h * a.ks.h;
  const T* vb = (const T*)a.v + b * a.vs.b + h * a.vs.h;
  T* ob = (T*)a.o + b * a.os.b + h * a.os.h;

  load_rows<T, DH>((const T*)a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, Qs, LD);
  load_ids(a.seg_q, b, q0, a.Lq, sq);

  // rows ty + 16 i: the running state, the same in the row group's 16 threads
  float acc[4][CJ], m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  // the TPU's single-step variant: one block, p normalised before p v
  const bool single = a.bk >= a.Lk;
  const int bk = single ? a.Lk : a.bk;
  for (int kb0 = 0; kb0 < a.Lk; kb0 += bk) {
    if (tile_skipped(a, q0, kb0)) continue;  // the same for every thread
    const int kend = min(kb0 + bk, a.Lk);
    const int nt = (kend - kb0 + kBK - 1) / kBK;

    // pass 1: the block's row max m_next = max(m_prev, rowmax(s)), the
    // scores staged in Ss when the block fits
    float m_use[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m_use[i] = -INFINITY;
    for (int t = 0; t < nt; ++t) {
      float s[4][4];
      fwd_logits<T, DH>(a, bh, b, kb, q0, kb0 + t * kBK, kend, Qs, Ks, sq, skv, s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m_use[i] = fmaxf(m_use[i], s[i][j]);
          if (a.staged) Ss[(ty + 16 * i) * a.sp + t * kBK + tx + 16 * j] = s[i][j];
        }
    }
    float m_next[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m_next[i] = fmaxf(m_run[i], row_max16(m_use[i]));
      m_use[i] = m_next[i] == -INFINITY ? 0.f : m_next[i];  // no visited pair yet
    }

    // the logits of tile t: staged, or computed again
    auto logits = [&](int t, float (&s)[4][4]) {
      if (!a.staged) {
        fwd_logits<T, DH>(a, bh, b, kb, q0, kb0 + t * kBK, kend, Qs, Ks, sq, skv, s);
        return;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = Ss[(ty + 16 * i) * a.sp + t * kBK + tx + 16 * j];
    };

    // pass 2, single step only: l = rowsum(exp(s - m)) before p is formed
    float psum[4] = {0.f, 0.f, 0.f, 0.f}, l_single[4];
    if (single) {
      for (int t = 0; t < nt; ++t) {
        float s[4][4];
        logits(t, s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) psum[i] += expf(s[i][j] - m_use[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) l_single[i] = row_sum16(psum[i]);
    }

    // pass 3: p = exp(s - m_next) (single step: / l), l's row sum of the
    // undropped p, p D rounded to T, and o_curr = p v over the block
    float o_cur[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) o_cur[i][j] = 0.f;
    for (int t = 0; t < nt; ++t) {
      const int k0 = kb0 + t * kBK;
      float s[4][4];
      logits(t, s);  // recomputed: syncs, then loads K
      __syncthreads();  // the previous tile's V and p are consumed
      load_rows<T, DH>(vb, a.vs.l, k0, kend, Vs, DH);
      float* Ps = a.staged ? Ss + t * kBK : Ss;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = expf(s[i][j] - m_use[i]);
          if (single)
            p = __fdiv_rn(p, l_single[i]);
          else
            psum[i] += p;
          // undropped p is rounded here; dropped p after its scaling below
          Ps[(ty + 16 * i) * a.sp + tx + 16 * j] = a.dropout ? p : round_to<T>(p);
        }
      __syncthreads();

      if (a.dropout) {  // p <- round(p D), four columns a thread
        for (int gi = tid; gi < kBQ * (kBK / 4); gi += kThreads) {
          const int r = gi / (kBK / 4), c4 = (gi % (kBK / 4)) * 4;
          float* pr = Ps + r * a.sp + c4;
          uint32_t w[4];
          if ((k0 & 3) == 0) {  // one draw holds the four columns
            const uint4 bits = flash_keep_bits4(a.seed, q0 + r, (k0 + c4) >> 2);
            w[0] = bits.x;
            w[1] = bits.y;
            w[2] = bits.z;
            w[3] = bits.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + c4 + e;
              const uint4 bits = flash_keep_bits4(a.seed, q0 + r, col >> 2);
              const int word = col & 3;
              w[e] = word == 0 ? bits.x : word == 1 ? bits.y : word == 2 ? bits.z : bits.w;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pr[e] = round_to<T>(w[e] >= a.threshold ? pr[e] * a.inv_keep : 0.f);
        }
        __syncthreads();
      }

      // o_curr += P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float pv[4], vv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * a.sp + kk];
#pragma unroll
        for (int j = 0; j < CJ; ++j) vv[j] = Vs[kk * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) o_cur[i][j] = fmaf(pv[i], vv[j], o_cur[i][j]);
      }
    }

    // the block's update of the rows that visit it; under `causal` a row
    // whose block_q tile does not reach this block keeps its state
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      const bool run = !a.causal || last_row(row, a.bq) > kb0;
      const float rowsum = row_sum16(psum[i]);  // every thread of the group calls it
      if (!run) continue;
      if (single) {
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = o_cur[i][j];
        l_run[i] = l_single[i];
      } else {
        // l_next = rowsum(p) + alpha l_prev; acc <- acc (l_corr / l_next) +
        // o_curr / l_next, with 1 / l_next taken as 1 where l_next is 0
        const float l_corr = __fmul_rn(expf(m_run[i] - m_use[i]), l_run[i]);
        const float l_next = __fadd_rn(rowsum, l_corr);
        const float inv = l_next == 0.f ? 1.f : __fdiv_rn(1.0f, l_next);
        const float corr = __fmul_rn(l_corr, inv);
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], corr), __fmul_rn(o_cur[i][j], inv));
        l_run[i] = l_next;
      }
      m_run[i] = m_next[i];
    }
  }

  const long long base = (long long)bh * a.Lq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Lq) continue;
    if (tx == 0) {
      a.l[base + row] = l_run[i];
      a.m[base + row] = m_run[i];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) ob[row * a.os.l + tx + 16 * j] = pcm::from_f<T>(acc[i][j]);
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
    Args a = args;
    size_t smem = bwd_smem_bytes<DH>();
    if (w == kFwd) {
      // stage a whole block_k block of scores when it fits the opt-in shared
      // memory, else keep one 64-key tile and compute the scores again
      int device = 0, optin = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return err;
      const int width = ((a.bk >= a.Lk ? a.Lk : a.bk) + kBK - 1) / kBK * kBK;
      a.staged = fwd_smem_bytes<DH>(width + 1) <= (size_t)optin;
      a.sp = a.staged ? width + 1 : kBK + 1;
      smem = fwd_smem_bytes<DH>(a.sp);
    }
    void (*kernel)(Args) = flash_fwd_kernel<T, DH>;
    if (w == kDkv) kernel = flash_dkv_kernel<T, DH>;
    if (w == kDq) kernel = flash_dq_kernel<T, DH>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int tiles = w == kDkv ? (a.Lk + kBK - 1) / kBK : (a.Lq + kBQ - 1) / kBQ;
    kernel<<<dim3(tiles, B * a.H), kThreads, smem, stream>>>(a);
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
