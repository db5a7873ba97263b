// The data-source token builder's two kernels: the forward statistics
// (kernel 5) and the tie-routed dW term of its backward (kernel 6).
//
// Kernel 5 replaces the TPU kernel `_fwd_kernel` / `_core_pallas`
// (pointcloudmatters_tpu/ops/fused_builder.py:115-206, 226-296). For bf16 g
// (B, N, D), bf16 h (B, M, D) and nn (B, M, K) int32 with -1 for holes, K
// <= 16, and x[m, k] = bf16(g[nn[m, k]] - h[m]) (the difference taken in f32
// and rounded once, as the TPU and the plain version take it), it writes
//   vmax[m] / vmin[m]  the max / min over the live k of x, bf16 (-inf / +inf
//                      for a query with holes only);
//   sg[m]              bf16 of the f32 sum over k of g[nn[m, k]], holes 0;
//   bm[m]              int32 tie bitmap: bit k when live x_k == vmax, bit
//                      16 + k when live x_k == vmin, compared on the rounded
//                      values (fused_builder.py:186-196);
//   total / total_sq   f32 sums over the live (m, k) of x and of x * x, the
//                      square in f32 (exact for bf16 x), as the TPU kernel
//                      squares (fused_builder.py:183-185).
// The (B, M, K, D) neighbourhood tensor never exists. What bounds it on an
// H100: bytes. It must read g, h and nn and write four (B, M, D) outputs
// (741 MB at B=32, N=10240, M=2048, D=512: 0.22 ms at 3.35 TB/s); the
// gathers read 16 source rows a query (1.07 GB), which the 50 MB L2 serves
// as long as the blocks in flight work on one or two clouds (10 MB of g
// each). Design: one block per (cloud, 32 consecutive queries), one thread
// per pair of channels, so that a warp reads 128 contiguous bytes of a
// source row and each source row (1 KB at D=512) is read whole by the block;
// a thread keeps its K differences in registers to set the tie bits after
// the max and min are known. The TPU kernel's query sort, chunk transpose
// and VMEM-resident g are devices of its memory system and have no place
// here: a block reads each query's K rows straight from global memory.
// Totals are per-block partial sums, reduced by a second kernel in a fixed
// order: no atomics, so two launches give identical bits.
//
// Kernel 6 replaces the TPU kernel `_routed_kernel` / `_routed_dw_pallas`
// (fused_builder.py:339-383). It computes
//   dW[c, d] = sum over (b, m, k) of src[b, nn[b, m, k], c] * w[b, m, k, d],
//   w = bit_max_k(bm[b, m, d]) * dvx[b, m, d] + bit_min_k(bm) * dvn[b, m, d]
// with bf16 src, dvx and dvn (the tie-count-normalised cotangents rounded
// as at fused_builder.py:489-490), w and the sums in f32, hole rows zero,
// as the reference `_routed_dw_xla` does (the TPU kernel rounds w to
// bf16, which differs where one neighbour holds both tie bits). It gathers
// the src rows itself from nn, where the TPU path builds a (B, K, Ci, M)
// gathered copy first (1.1 GB at the flagship shapes), and builds the
// (B, M, K, D) weights only in shared memory. What bounds it: operations,
// 2 * B*M*K * Cin * D flops (0.57 TFLOP at B=32, Cin=515) at the bf16
// tensor-core peak.
// Design: dW = A^T W, a split-K GEMM over the B*M*K gathered rows on
// `mma.sync.m16n8k16` bf16 -> f32 (attention_mma.cuh's helpers, A read
// transposed by `ldmatrix.trans` as gemm_mma.cuh's kAT mode reads it).
//   - A block is 8 warps computing a 128-channel x 128-column tile of dW
//     over one split of the (b, m) pairs, each warp a 64 x 32 part; a
//     stage is 4 pairs (4 K rows, padded to a multiple of 16).
//   - Source rows: `cp.async` of 16-byte chunks at a row pitch that is a
//     multiple of 8 channels (the wrapper pads Cin = 515 to 528, as the
//     TPU path pads to a multiple of 16, fused_builder.py:473-476), a hole
//     or a row past the split zero-filled; a ring of 5 stages keeps 3
//     stages in flight while one multiplies, their indices read a stage
//     ahead. Channels at or above Cin only reach dW rows that are not
//     stored. A stage's bm, dvx and dvn rows come by `cp.async` too (D a
//     multiple of 8, the rows 16-byte aligned: the entry rejects others).
//   - Weights: each thread takes one pair and two columns, forms the four
//     values w can take there (mx dvx + mn dvn, in f32 as the plain version
//     forms them) and writes w_hi = bf16(w) for each of the K neighbours:
//     that of no tie bit (0) in all K rows, then over it that of each
//     neighbour with a bit (two a column, more on ties); the next stage's
//     between this stage's k steps (two weight buffers). Only
//     w = dvx + dvn (one neighbour both max and min: a query with one live
//     neighbour, or equal values) is not a bf16 value; for it w_lo =
//     bf16(w - w_hi), and a block-wide vote runs the w_lo product only in a
//     stage where some w_lo of the tile is not 0. Adding zero products
//     changes no bit, so the skip is exact.
//   - The tensor cores add truncating: a stage's products go into a zeroed
//     f32 fragment, added to the f32 accumulator rounding to nearest every
//     kFlush = 2 stages (f32_mma.cuh's remedy).
//   - The splits' partial tiles are summed by a second kernel in split
//     order; the splits are a function of the shapes only: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "attention_mma.cuh"
#include "elem.cuh"

namespace {

using pcm::bf16;

constexpr int kMaxK = 16;
constexpr int kQB = 32;  // queries a block, kernel 5

// ---------------------------------------------------------------------------
// kernel 5: forward statistics
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
builder_fwd_kernel(const bf16* __restrict__ g, const bf16* __restrict__ h,
                   const int* __restrict__ nn, bf16* __restrict__ vmax_out,
                   bf16* __restrict__ vmin_out, bf16* __restrict__ sg_out,
                   int* __restrict__ bm_out, float* __restrict__ part, int N, int M, int K,
                   int D) {
  __shared__ int nn_s[kQB * kMaxK];
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kQB;
  const int nq = min(kQB, M - m0);
  for (int e = threadIdx.x; e < nq * K; e += blockDim.x)
    nn_s[e] = nn[((long long)b * M + m0) * K + e];
  __syncthreads();

  const long long blk = (long long)b * gridDim.x + blockIdx.x;
  const bf16* gb = g + (long long)b * N * D;
  for (int dp = threadIdx.x; dp < D / 2; dp += blockDim.x) {
    const int d0 = 2 * dp;
    float tot0 = 0.f, tot1 = 0.f, sq0 = 0.f, sq1 = 0.f;
    for (int qi = 0; qi < nq; ++qi) {
      const long long row = (long long)b * M + m0 + qi;
      const float2 hv = __bfloat1622float2(*(const __nv_bfloat162*)(h + row * D + d0));
      float x0[kMaxK], x1[kMaxK];
      unsigned live = 0;
      float mx0 = -INFINITY, mx1 = -INFINITY, mn0 = INFINITY, mn1 = INFINITY;
      float sg0 = 0.f, sg1 = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k >= K) break;
        const int n = nn_s[qi * K + k];
        float2 gv = make_float2(0.f, 0.f);
        if (n >= 0) {
          gv = __bfloat1622float2(*(const __nv_bfloat162*)(gb + (long long)n * D + d0));
          live |= 1u << k;
        }
        x0[k] = pcm::round_to<bf16>(gv.x - hv.x);
        x1[k] = pcm::round_to<bf16>(gv.y - hv.y);
        sg0 += gv.x;
        sg1 += gv.y;
        if (n >= 0) {
          mx0 = fmaxf(mx0, x0[k]);
          mx1 = fmaxf(mx1, x1[k]);
          mn0 = fminf(mn0, x0[k]);
          mn1 = fminf(mn1, x1[k]);
          tot0 += x0[k];
          tot1 += x1[k];
          sq0 += x0[k] * x0[k];
          sq1 += x1[k] * x1[k];
        }
      }
      unsigned bits0 = 0, bits1 = 0;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k >= K) break;
        if (!((live >> k) & 1u)) continue;
        bits0 |= (x0[k] == mx0 ? 1u : 0u) << k;
        bits0 |= (x0[k] == mn0 ? 1u : 0u) << (16 + k);
        bits1 |= (x1[k] == mx1 ? 1u : 0u) << k;
        bits1 |= (x1[k] == mn1 ? 1u : 0u) << (16 + k);
      }
      const long long o = row * D + d0;
      *(__nv_bfloat162*)(vmax_out + o) = __floats2bfloat162_rn(mx0, mx1);
      *(__nv_bfloat162*)(vmin_out + o) = __floats2bfloat162_rn(mn0, mn1);
      *(__nv_bfloat162*)(sg_out + o) = __floats2bfloat162_rn(sg0, sg1);
      *(int2*)(bm_out + o) = make_int2((int)bits0, (int)bits1);
    }
    float* pb = part + blk * 2 * D;
    pb[d0] = tot0;
    pb[d0 + 1] = tot1;
    pb[D + d0] = sq0;
    pb[D + d0 + 1] = sq1;
  }
}

// out[j] = sum over blocks of part[blk, j], j < 2 D, in a fixed order: lane
// group l of 8 sums blocks l, l + 8, ..., then lane group 0 adds the 8.
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, long long nblk,
                    int width) {
  __shared__ float acc[8][32];
  const int col = blockIdx.x * 32 + (threadIdx.x & 31);
  const int grp = threadIdx.x >> 5;
  float s = 0.f;
  if (col < width)
    for (long long i = grp; i < nblk; i += 8) s += part[i * width + col];
  acc[grp][threadIdx.x & 31] = s;
  __syncthreads();
  if (grp == 0 && col < width) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += acc[i][threadIdx.x];
    out[col] = t;
  }
}

// ---------------------------------------------------------------------------
// kernel 6: routed dW on the bf16 tensor cores
// ---------------------------------------------------------------------------
namespace mm = pcm::attn_mma;

constexpr int kTC = 128;     // dW rows (source channels) a block
constexpr int kTD = 128;     // dW columns a block
constexpr int kPairs = 4;    // (b, m) pairs a stage
constexpr int kStageRows = kPairs * kMaxK;  // gathered rows a stage, at most
constexpr int kLd = 128 + 8;  // a shared row: 128 values and 16 bytes of padding
constexpr int kRing = 5;      // stages of source rows and pair data in shared memory
// stages between two flushes of the stage sums into the f32 accumulators
// (ROUTED_FLUSH in ops/fused_builder.py)
constexpr int kFlush = 2;
// 2 (channels) x kTD / 32 (columns) warps, 64 x 32 each
constexpr int kRoutedThreads = 2 * kTD;
constexpr int kWarpsD = kTD / 32;
constexpr int kRowsAPass = kRoutedThreads / 16;   // source rows a load pass
constexpr int kPasses = kStageRows / kRowsAPass;  // load passes a stage

struct RoutedSmem {
  bf16 a[kRing][kStageRows][kLd];  // gathered source rows [row][channel]
  bf16 w_hi[2][kStageRows][kLd];   // a stage's weights [row][column]: bf16(w)
  bf16 w_lo[kStageRows][kLd];      // and bf16(w - w_hi)
  int bm[kRing][kPairs][kTD];      // the stages' tie bits and cotangents
  bf16 dvx[kRing][kPairs][kTD];
  bf16 dvn[kRing][kPairs][kTD];
};

struct RoutedArgs {
  const bf16* src;
  const int* nn;
  const int* bm;
  const bf16 *dvx, *dvn;
  float* part;
  int* counts;
  int N, M, K, Cin, pitch, D;
  int n_pairs, pairs_per_split;  // B * M <= 2^30
};

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const bf16 h = __float2bfloat16_rn(x);
  return (uint32_t)*reinterpret_cast<const unsigned short*>(&h);
}

__device__ __forceinline__ float bf16_value(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// The bf16 bits of w for each (max bit, min bit) of a column, and w_lo of
// w = dvx + dvn: w formed as the plain version forms it (a product by 0 or
// 1, then one f32 sum, so 0 * inf stays NaN), w_lo = bf16(w - bf16(w)),
// 0 where w is not finite.
struct Routes {
  uint32_t h00, h10, h01, h11, l11;
  __device__ __forceinline__ Routes(float vx, float vn) {
    const float zx = __fmul_rn(0.f, vx), zn = __fmul_rn(0.f, vn);
    const float w11 = __fadd_rn(vx, vn);
    h00 = bf16_bits(__fadd_rn(zx, zn));
    h10 = bf16_bits(__fadd_rn(vx, zn));
    h01 = bf16_bits(__fadd_rn(zx, vn));
    h11 = bf16_bits(w11);
    l11 = isfinite(w11) ? bf16_bits(__fsub_rn(w11, bf16_value(h11))) : 0u;
  }
  // m: the column's bits shifted by k and masked with 0x10001
  __device__ __forceinline__ uint32_t hi(uint32_t m) const {
    return m == 0x10001u ? h11 : m == 1u ? h10 : m != 0u ? h01 : h00;
  }
  __device__ __forceinline__ uint32_t lo(uint32_t m) const { return m == 0x10001u ? l11 : 0u; }
};

// A thread's part of a stage's weights: pair q, columns d and d + 1.
struct PairWeights {
  uint32_t b0, b1;
  Routes r0, r1;
  __device__ __forceinline__ PairWeights(const RoutedSmem& s, int slot, int q, int d)
      : b0((uint32_t)s.bm[slot][q][d]),
        b1((uint32_t)s.bm[slot][q][d + 1]),
        r0(pcm::to_f(s.dvx[slot][q][d]), pcm::to_f(s.dvn[slot][q][d])),
        r1(pcm::to_f(s.dvx[slot][q][d + 1]), pcm::to_f(s.dvn[slot][q][d + 1])) {}
  // w_hi of neighbours k0 .. k1 - 1 with neither tie bit into w (rows q K
  // + k, columns d, d + 1): 0, or NaN where dvx or dvn is not finite
  __device__ __forceinline__ void hi_clear(bf16 (*w)[kLd], int q, int d, int K, int k0,
                                           int k1) const {
    const uint32_t v = r0.h00 | (r1.h00 << 16);
    for (int k = k0; k < k1; ++k) *reinterpret_cast<uint32_t*>(&w[q * K + k][d]) = v;
  }
  // then w_hi of the neighbours with a tie bit (one or two a column, more
  // on ties), one bf16 store each
  __device__ __forceinline__ void hi_set(bf16 (*w)[kLd], int q, int d, int K,
                                         uint32_t kmask) const {
    for (uint32_t u = (b0 | (b0 >> 16)) & kmask; u != 0u; u &= u - 1u) {
      const int k = __ffs(u) - 1;
      *reinterpret_cast<unsigned short*>(&w[q * K + k][d]) =
          (unsigned short)r0.hi((b0 >> k) & 0x10001u);
    }
    for (uint32_t u = (b1 | (b1 >> 16)) & kmask; u != 0u; u &= u - 1u) {
      const int k = __ffs(u) - 1;
      *reinterpret_cast<unsigned short*>(&w[q * K + k][d + 1]) =
          (unsigned short)r1.hi((b1 >> k) & 0x10001u);
    }
  }
  __device__ __forceinline__ void lo(bf16 (*w)[kLd], int q, int d, int K) const {
    for (int k = 0; k < K; ++k)
      *reinterpret_cast<uint32_t*>(&w[q * K + k][d]) =
          r0.lo((b0 >> k) & 0x10001u) | (r1.lo((b1 >> k) & 0x10001u) << 16);
  }
  // whether a w_lo is not 0: a neighbour holds both bits and w_lo != +-0
  __device__ __forceinline__ bool has_lo(uint32_t kmask) const {
    return ((b0 & (b0 >> 16) & kmask) != 0u && (r0.l11 & 0x7fffu) != 0u) ||
           ((b1 & (b1 >> 16) & kmask) != 0u && (r1.l11 & 0x7fffu) != 0u);
  }
};

__global__ void __launch_bounds__(kRoutedThreads, 1)
routed_dw_kernel(const RoutedArgs a) {
  extern __shared__ __align__(16) unsigned char routed_smem[];
  RoutedSmem& s = *reinterpret_cast<RoutedSmem*>(routed_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_ctiles = (a.Cin + kTC - 1) / kTC;
  const int c0 = (int)(blockIdx.x % n_ctiles) * kTC, d0 = (int)(blockIdx.x / n_ctiles) * kTD;
  const int p_begin = (int)blockIdx.y * a.pairs_per_split;
  const int p_end = min(p_begin + a.pairs_per_split, a.n_pairs);
  const int n_stages = p_end > p_begin ? (p_end - p_begin + kPairs - 1) / kPairs : 0;
  const int K = a.K, rows = kPairs * K, steps = (rows + 15) / 16;
  const int k_per_step = (K + steps - 1) / steps;  // neighbours built a k step
  const int wm = (warp / kWarpsD) * 64, wn = (warp % kWarpsD) * 32;  // the warp's part
  // 16-channel fragments of the warp below Cin (the others are not stored)
  const int live = max(0, min(4, (a.Cin - c0 - wm + 15) / 16));

  // source rows: thread t loads 16 bytes at channel c0 + cc of the stage's
  // rows (t >> 4) + kRowsAPass j, j < kPasses
  const int cc = (tid & 15) * 8;
  // the pair in the stage of each of those rows, a byte each
  uint64_t pair_of = 0;
#pragma unroll
  for (int j = 0; j < kPasses; ++j)
    pair_of |= (uint64_t)(((tid >> 4) + kRowsAPass * j) / K) << (8 * j);
  // a row's nn entry is flat entry p K + k = (stage's first pair) K + row
  auto load_nn = [&](int st, int (&out)[kPasses]) {
    const int pb = p_begin + st * kPairs;
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int r = (tid >> 4) + kRowsAPass * j;
      const int p = pb + (int)((pair_of >> (8 * j)) & 0xffu);
      out[j] = st < n_stages && r < rows && p < p_end ? __ldg(a.nn + (long long)pb * K + r) : -1;
    }
  };
  auto issue = [&](int st, const int (&nnv)[kPasses]) {
    if (st >= n_stages) return;
    const int slot = st % kRing;
    const int pb = p_begin + st * kPairs;
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int r = (tid >> 4) + kRowsAPass * j;
      if (r >= steps * 16) continue;
      const bool in = nnv[j] >= 0 && c0 + cc < a.Cin;
      const int b = (pb + (int)((pair_of >> (8 * j)) & 0xffu)) / a.M;
      const bf16* g =
          in ? a.src + ((long long)b * a.N + nnv[j]) * a.pitch + c0 + cc : a.src;
      mm::cp_async16(&s.a[slot][r][cc], g, in ? 16 : 0);
    }
    // one 16-byte chunk a thread: bm, then dvx, then dvn
    const bool is_bm = tid < kTD;
    const int i = is_bm ? tid : (tid - kTD) % (kTD / 2);
    const int q = is_bm ? i / (kTD / 4) : i / (kTD / 8);
    const int e = is_bm ? (i % (kTD / 4)) * 4 : (i % (kTD / 8)) * 8;
    const int p = pb + q;
    const bool in = p < p_end && d0 + e < a.D;
    const long long o = (long long)p * a.D + d0 + e;
    if (is_bm)
      mm::cp_async16(&s.bm[slot][q][e], in ? a.bm + o : a.bm, in ? 16 : 0);
    else if (tid < kTD + kTD / 2)
      mm::cp_async16(&s.dvx[slot][q][e], in ? a.dvx + o : a.dvx, in ? 16 : 0);
    else
      mm::cp_async16(&s.dvn[slot][q][e], in ? a.dvn + o : a.dvn, in ? 16 : 0);
  };

  // rows rows .. 16 steps - 1 of the weights are padding: zero, never written
  for (int e = tid; e < (steps * 16 - rows) * (kTD / 2); e += kRoutedThreads) {
    const int r = rows + e / (kTD / 2), d = 2 * (e % (kTD / 2));
    *reinterpret_cast<uint32_t*>(&s.w_hi[0][r][d]) = 0u;
    *reinterpret_cast<uint32_t*>(&s.w_hi[1][r][d]) = 0u;
    *reinterpret_cast<uint32_t*>(&s.w_lo[r][d]) = 0u;
  }

  float acc[4][4][4], t[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = t[i][j][e] = 0.f;

  // the ring: stages 0 .. kRing - 2 in flight, then one more each stage
  int nn_next[kPasses];
  for (int st = 0; st + 1 < kRing; ++st) {
    load_nn(st, nn_next);
    issue(st, nn_next);
    mm::cp_async_commit();
  }
  load_nn(kRing - 1, nn_next);
  // weights: thread t forms those of pair t / (kTD / 2), columns 2 (t %
  // (kTD / 2)) and + 1
  const int wq = tid / (kTD / 2), wd = 2 * (tid % (kTD / 2));
  const uint32_t kmask = K >= 16 ? 0xffffu : (1u << K) - 1u;
  bool has_lo = false;
  if (n_stages > 0) {  // stage 0's weights
    mm::cp_async_wait<kRing - 2>();
    __syncthreads();
    const PairWeights pw(s, 0, wq, wd);
    pw.hi_clear(s.w_hi[0], wq, wd, K, 0, K);
    pw.hi_set(s.w_hi[0], wq, wd, K, kmask);
    has_lo = pw.has_lo(kmask);
  }
  int lo_stages = 0;

  for (int st = 0; st < n_stages; ++st) {
    const int slot = st % kRing, wb = st & 1;
    // stages st and st + 1 have landed; stage st's weights are built;
    // stage st - 1's tiles are consumed
    mm::cp_async_wait<kRing - 3>();
    const bool lo = __syncthreads_or(has_lo);
    if (lo) {
      const PairWeights pw(s, slot, wq, wd);
      pw.lo(s.w_lo, wq, wd, K);
      __syncthreads();
      ++lo_stages;
    }
    issue(st + kRing - 1, nn_next);
    mm::cp_async_commit();
    load_nn(st + kRing, nn_next);

    // stage st's products, and between its k steps stage st + 1's weights
    const bool next = st + 1 < n_stages;
    const PairWeights pw(s, (st + 1) % kRing, wq, wd);
    has_lo = next && pw.has_lo(kmask);
    for (int kk = 0; kk < steps; ++kk) {
      if (next)
        pw.hi_clear(s.w_hi[wb ^ 1], wq, wd, K, kk * k_per_step, min(K, (kk + 1) * k_per_step));
      // the k step's fragments, then its products (the small terms first)
      uint32_t af[4][4], bh[2][4], bl[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < live)
          mm::ldsm_x4_t(af[i], &s.a[slot][kk * 16 + ((lane >> 4) << 3) + (lane & 7)]
                                       [wm + i * 16 + (((lane >> 3) & 1) << 3)]);
      const int row = kk * 16 + (lane & 15);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {  // 8-column fragments 2 jp and 2 jp + 1
        const int col = wn + jp * 16 + ((lane >> 4) << 3);
        mm::ldsm_x4_t(bh[jp], &s.w_hi[wb][row][col]);
        if (lo) mm::ldsm_x4_t(bl[jp], &s.w_lo[row][col]);
      }
      if (lo) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < live) {
              mm::mma(t[i][2 * jp], af[i], bl[jp][0], bl[jp][1]);
              mm::mma(t[i][2 * jp + 1], af[i], bl[jp][2], bl[jp][3]);
            }
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < live) {
            mm::mma(t[i][2 * jp], af[i], bh[jp][0], bh[jp][1]);
            mm::mma(t[i][2 * jp + 1], af[i], bh[jp][2], bh[jp][3]);
          }
    }
    if (next) pw.hi_set(s.w_hi[wb ^ 1], wq, wd, K, kmask);
    if ((st + 1) % kFlush == 0) {  // the stage sums into the accumulator, rounding to nearest
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] = __fadd_rn(acc[i][j][e], t[i][j][e]);
            t[i][j][e] = 0.f;
          }
    }
  }
  mm::cp_async_wait<0>();

  if (tid == 0 && a.counts != nullptr) {
    atomicAdd(a.counts, lo_stages);
    atomicAdd(a.counts + 1, n_stages);
  }
  float* pb = a.part + (long long)blockIdx.y * a.Cin * a.D;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wm + 16 * i + (lane >> 2) + 8 * h;
      if (c >= a.Cin) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + wn + 8 * j + 2 * (lane & 3);
        const float x0 = __fadd_rn(acc[i][j][2 * h], t[i][j][2 * h]);
        const float x1 = __fadd_rn(acc[i][j][2 * h + 1], t[i][j][2 * h + 1]);
        float* o = pb + (long long)c * a.D + d;
        if (d + 1 < a.D && (uintptr_t)o % 8 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
        } else {
          if (d < a.D) o[0] = x0;
          if (d + 1 < a.D) o[1] = x1;
        }
      }
    }
}

// out[e] = sum over splits s = 0, 1, ... of part[s, e], in that order.
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, long long n,
                  int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[i * n + e];
  out[e] = s;
}

}  // namespace

extern "C" {

// Number of per-block partial rows kernel 5 writes for B clouds of M
// queries: the caller's `part` holds that many (2, D) f32 rows.
long long pcm_builder_fwd_partials(int B, int M) {
  return (long long)B * ((M + kQB - 1) / kQB);
}

// Kernel 5. g (B, N, D) and h (B, M, D) bf16, nn (B, M, K) int32 (-1 =
// hole), all contiguous on device `device`; 1 <= K <= 16, D even. Writes
// vmax, vmin, sg (B, M, D) bf16, bm (B, M, D) int32 and totals (2, D) f32
// (total, then total_sq); part is f32 scratch of
// pcm_builder_fwd_partials(B, M) * 2 * D. Returns the first cudaError_t of
// its two launches that is not success.
int pcm_builder_fwd(const void* g, const void* h, const int* nn, void* vmax, void* vmin,
                    void* sg, int* bm, float* part, float* totals, int B, int N, int M, int K,
                    int D, int device, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1 || K < 1 || K > kMaxK || D < 2 || D % 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = std::min(256, ((D / 2 + 31) / 32) * 32);
  builder_fwd_kernel<<<dim3((M + kQB - 1) / kQB, B), threads, 0, s>>>(
      (const bf16*)g, (const bf16*)h, nn, (bf16*)vmax, (bf16*)vmin, (bf16*)sg, bm, part, N, M,
      K, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(2 * D + 31) / 32, 256, 0, s>>>(part, totals,
                                                         pcm_builder_fwd_partials(B, M), 2 * D);
  return (int)cudaGetLastError();
}

// Kernel 6. src (B, N, Cin) bf16 at row pitch `pitch` (a multiple of 8 at
// least Cin, the data 16-byte aligned; channels Cin .. pitch - 1 are never
// read into a stored entry), nn (B, M, K) int32 (-1 = hole), bm (B, M, D)
// int32, dvx and dvn (B, M, D) bf16, all on device `device`, the last four
// contiguous, bm, dvx and dvn 16-byte aligned; 1 <= K <= 16, D a multiple
// of 8, B * M <= 2^30. The B*M (b, m) pairs are cut into `splits`
// consecutive runs (a multiple of 4 pairs each, the last shorter); part is
// f32 scratch of splits * Cin * D; out (Cin, D) f32 is written. The stage
// sums are flushed into the f32 accumulators every kFlush stages of 4
// pairs. `counts`: null, or two int32 on the device
// to which the launch adds the (block, stage) tiles that ran the w_lo
// product and all tiles. Returns the first cudaError_t that is not success.
int pcm_routed_dw(const void* src, const int* nn, const int* bm, const void* dvx,
                  const void* dvn, float* part, float* out, int* counts, int B, int N, int M,
                  int K, int Cin, int pitch, int D, int splits, int device, void* stream) {
  if (B < 1 || N < 1 || M < 1 || K < 1 || K > kMaxK || Cin < 1 || D < 8 || D % 8 != 0 ||
      splits < 1 || splits > 65535 || pitch < Cin || pitch % 8 != 0 ||
      (uintptr_t)src % 16 != 0 || (uintptr_t)bm % 16 != 0 || (uintptr_t)dvx % 16 != 0 ||
      (uintptr_t)dvn % 16 != 0 || (long long)B * M > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(routed_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(RoutedSmem));
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  RoutedArgs a{(const bf16*)src, nn, bm, (const bf16*)dvx, (const bf16*)dvn, part, counts, N, M,
               K, Cin, pitch, D, 0, 0};
  a.n_pairs = B * M;
  a.pairs_per_split = ((a.n_pairs + splits - 1) / splits + kPairs - 1) / kPairs * kPairs;
  const dim3 grid(((Cin + kTC - 1) / kTC) * ((D + kTD - 1) / kTD), splits);
  routed_dw_kernel<<<grid, kRoutedThreads, sizeof(RoutedSmem), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)Cin * D;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, out, n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
