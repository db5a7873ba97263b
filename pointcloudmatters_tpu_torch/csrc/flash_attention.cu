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
// bf16 (T = bf16) rounds where the TPU kernels round (:571-573, :1023-1024,
// :1045, :1397-1399): p D before p v, p_dropped before dV, dS before dK and
// dQ, and each output once; inputs convert to f32 on load, and tiles, row
// statistics and accumulators are f32. One choice differs from the TPU
// kernel and from the plain version: the forward rounds p = exp(s - m)
// against its own running max over 64-key tiles (the plain version, like
// the TPU, against the running max after each block_k block, or the final
// normalised p in the single-step variant). Both are one rounding of the
// same value against another scale; the kernel is held to the plain
// version at the bf16 tolerance (chip_smoke.py).
//
// What bounds it on an H100: arithmetic. 4 B H Lq Lk dh flops forward, 8
// for dK/dV (S, dP, dV, dK) and 6 for dQ (S, dP, dQ), all f32 FMAs on the
// FP32 pipes in both element types; tensor-core tiles (mma/wgmma) are
// later work.
//
// What the design does about the TPU kernels' shape: those carry m, l and
// the accumulators in VMEM scratch across a sequential kv grid axis (dK/dV
// across a sequential q axis). Hopper has no sequential grid axis, so a
// loop inside the block takes its place, as in kernels 3 and 4
// (attention_fwd.cuh, attention_bwd.cu, whose tiling this file follows and
// leaves untouched):
//   9  one block a (64-query tile, batch * head); it streams 64-key tiles
//      with an f32 online softmax and divides by l once at the end;
//   10 one block a (64-key tile, batch * head); it loops over the query
//      tiles, dK and dV of its 64 keys in registers;
//   11 one block a (64-query tile, batch * head); it loops over the key
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
#include "philox.cuh"

namespace {

using pcm::round_to;
using pcm::to_f;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
// DEFAULT_MASK_VALUE: -0.7 times the f32 maximum, in double, then rounded
// to f32, as the TPU kernel adds it to its f32 scores
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);

struct Strides {
  long long b, h, l;
};

// One launch's arguments; the element pointers are of type T (float or
// bf16), `ab` and `ds` contiguous (B, H, Lq, Lk), l, m and di contiguous
// (B, H, Lq) f32, the segment ids contiguous (B, Lq) and (B, Lk) int32.
struct Args {
  const void *q, *k, *v, *ab, *dout;
  const int *seg_q, *seg_kv;
  void *o, *dq, *dk, *dv, *ds;
  float *l, *m;
  const float* di;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int H, Lq, Lk, causal, bq, bk;
  float scale;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int dropout;
};

// Keep bits of key columns 4g .. 4g+3 of query row `row`, every batch item
// and head alike.
__device__ __forceinline__ uint4 flash_keep_bits4(uint32_t seed, int row, int g) {
  return pcm::philox4x32_10(make_uint4((uint32_t)g, (uint32_t)row, 1u, 0u),
                            make_uint2(seed, 0u));
}

// The last row of `row`'s block_q tile: the tile at key column c is visited
// iff that row exceeds the first column of c's block_k tile.
__device__ __forceinline__ int last_row(int row, int bq) { return (row / bq + 1) * bq - 1; }

// True when the causal kernels visit no pair of the 64x64 tile at (q0, k0).
__device__ __forceinline__ bool tile_skipped(const Args& a, int q0, int k0) {
  if (!a.causal) return false;
  return last_row(min(q0 + kBQ, a.Lq) - 1, a.bq) <= (k0 / a.bk) * a.bk;
}

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

template <int DH>
constexpr size_t fwd_smem_bytes() {
  return ((size_t)kBQ * (DH + 1) + (size_t)kBK * (DH + 1) + (size_t)kBK * DH +
          (size_t)kBQ * (kBK + 1) + 2 * kBQ) * sizeof(float) + (kBQ + kBK) * sizeof(int);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int LD = DH + 1;    // padded row of Q and K tiles
  constexpr int LDP = kBK + 1;  // padded row of the score tile
  constexpr int CJ = DH / 16;   // output columns a thread
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * DH;
  float* row_alpha = Ps + kBQ * LDP;
  float* row_l = row_alpha + kBQ;
  int* sq = (int*)(row_l + kBQ);
  int* skv = sq + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const T* kb = (const T*)a.k + b * a.ks.b + h * a.ks.h;
  const T* vb = (const T*)a.v + b * a.vs.b + h * a.vs.h;
  T* ob = (T*)a.o + b * a.os.b + h * a.os.h;

  load_rows<T, DH>((const T*)a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, Qs, LD);
  load_ids(a.seg_q, b, q0, a.Lq, sq);

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  float m_run[8], l_run[8];  // rows warp*8 .. warp*8+7, same in every lane
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  const int n_kt = (a.Lk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (tile_skipped(a, q0, k0)) continue;  // the same for every thread
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_rows<T, DH>(kb, a.ks.l, k0, a.Lk, Ks, LD);
    load_rows<T, DH>(vb, a.vs.l, k0, a.Lk, Vs, DH);
    load_ids(a.seg_kv, b, k0, a.Lk, skv);
    __syncthreads();

    float s[4][4];
    tile_dot<DH>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        Ps[r * LDP + c] = logit<T>(a, bh, q0 + r, k0 + c, s[i][j], sq[r], skv[c]);
      }
    __syncthreads();

    // online softmax: warp w folds rows 8w .. 8w+7, two columns a lane
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const float s0 = Ps[r * LDP + lane], s1 = Ps[r * LDP + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[rr], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no visited pair yet
      const float alpha = expf(m_run[rr] - m_use);
      const float p0 = expf(s0 - m_use), p1 = expf(s1 - m_use);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[rr] = l_run[rr] * alpha + sum;
      m_run[rr] = m_new;
      // undropped p is rounded here; dropped p after its scaling below
      Ps[r * LDP + lane] = a.dropout ? p0 : round_to<T>(p0);
      Ps[r * LDP + lane + 32] = a.dropout ? p1 : round_to<T>(p1);
      if (lane == 0) row_alpha[r] = alpha;
    }
    __syncthreads();

    if (a.dropout) {  // p <- round(p D), four columns a draw
      for (int gi = tid; gi < kBQ * (kBK / 4); gi += kThreads) {
        const int r = gi / (kBK / 4), c4 = (gi % (kBK / 4)) * 4;
        const uint4 bits = flash_keep_bits4(a.seed, q0 + r, (k0 + c4) >> 2);
        float* pr = Ps + r * LDP + c4;
        pr[0] = round_to<T>(bits.x >= a.threshold ? pr[0] * a.inv_keep : 0.f);
        pr[1] = round_to<T>(bits.y >= a.threshold ? pr[1] * a.inv_keep : 0.f);
        pr[2] = round_to<T>(bits.z >= a.threshold ? pr[2] * a.inv_keep : 0.f);
        pr[3] = round_to<T>(bits.w >= a.threshold ? pr[3] * a.inv_keep : 0.f);
      }
      __syncthreads();
    }

    // acc = alpha * acc + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = Vs[kk * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  __syncthreads();  // row_alpha is read; it now takes the final row max
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      row_l[warp * 8 + rr] = l_run[rr];
      row_alpha[warp * 8 + rr] = m_run[rr];
    }
  }
  __syncthreads();
  const long long base = (long long)bh * a.Lq + q0;
  for (int r = tid; r < kBQ && q0 + r < a.Lq; r += kThreads) {
    a.l[base + r] = row_l[r];
    a.m[base + r] = row_alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= a.Lq) continue;
    const float lr = row_l[r];
    const float inv = lr == 0.f ? 1.f : 1.0f / lr;  // the TPU's l_next_inv_safe
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      ob[(q0 + r) * a.os.l + tx + 16 * j] = pcm::from_f<T>(acc[i][j] * inv);
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
cudaError_t launch(Which w, const Args& a, int B, cudaStream_t stream) {
  const size_t smem = w == kFwd ? fwd_smem_bytes<DH>() : bwd_smem_bytes<DH>();
  constexpr cudaFuncAttribute kAttr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const cudaError_t err =
      w == kFwd   ? cudaFuncSetAttribute(flash_fwd_kernel<T, DH>, kAttr, (int)smem)
      : w == kDkv ? cudaFuncSetAttribute(flash_dkv_kernel<T, DH>, kAttr, (int)smem)
                  : cudaFuncSetAttribute(flash_dq_kernel<T, DH>, kAttr, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = w == kDkv ? (a.Lk + kBK - 1) / kBK : (a.Lq + kBQ - 1) / kBQ;
  const dim3 grid(tiles, B * a.H);
  if (w == kFwd)
    flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(a);
  else if (w == kDkv)
    flash_dkv_kernel<T, DH><<<grid, kThreads, smem, stream>>>(a);
  else
    flash_dq_kernel<T, DH><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
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
