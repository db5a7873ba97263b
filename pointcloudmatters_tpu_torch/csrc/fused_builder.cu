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
// as at fused_builder.py:489-490), w and the sums in f32, hole rows zero. It
// gathers the src rows itself from nn, where the TPU path builds a
// (B, K, Ci, M) gathered copy first (1.1 GB at the flagship shapes). What
// bounds it: operations, 2 * B*M*K * Cin * D flops (0.57 TFLOP at B=32,
// Cin=515), here f32 FMAs on the FP32 pipes (tensor-core tiles are later
// work). Design: a GEMM over the B*M*K rows, one block per (64-channel,
// 128-column) tile of dW and per split of the (b, m) pairs; a stage stages
// the gathered src rows of 4 pairs (4 K rows) and their w rows in shared
// memory, and each of 256 threads accumulates a 4 x 8 register tile with
// 16-byte shared loads. The splits' partial tiles are summed by a second
// kernel in split order: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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
// kernel 6: routed dW
// ---------------------------------------------------------------------------
constexpr int kTC = 64;    // dW rows (src channels) a block
constexpr int kTD = 128;   // dW columns a block
constexpr int kPairs = 4;  // (b, m) pairs a stage: up to 64 rows
constexpr int kRows = kPairs * kMaxK;
constexpr size_t kRoutedSmem =
    (size_t)kRows * kTC * sizeof(float) + (size_t)kRows * kTD * sizeof(float) +
    (size_t)kRows * sizeof(long long);

__global__ void __launch_bounds__(256)
routed_dw_kernel(const bf16* __restrict__ src, const int* __restrict__ nn,
                 const int* __restrict__ bm, const bf16* __restrict__ dvx,
                 const bf16* __restrict__ dvn, float* __restrict__ part, int N, int M, int K,
                 int Cin, int D, long long n_pairs, long long pairs_per_split) {
  extern __shared__ float4 sm4[];
  float* As = (float*)sm4;                       // [rows][kTC] gathered src
  float* Ws = As + kRows * kTC;                  // [rows][kTD] routed weights
  long long* base_s = (long long*)(Ws + kRows * kTD);  // src offset of a row, -1 = hole

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * kTC, d0 = blockIdx.y * kTD;
  const long long p_begin = (long long)blockIdx.z * pairs_per_split;
  const long long p_end = min(p_begin + pairs_per_split, n_pairs);
  const int rows = kPairs * K;

  // thread tile: dW rows c0 + 4 ty + i, columns d0 + 4 tx + j and
  // d0 + 64 + 4 tx + j (i, j < 4)
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (long long p0 = p_begin; p0 < p_end; p0 += kPairs) {
    __syncthreads();  // the previous stage's tiles are consumed
    for (int e = tid; e < rows; e += blockDim.x) {
      const long long p = p0 + e / K;
      const int n = p < p_end ? nn[p * K + e % K] : -1;
      base_s[e] = n >= 0 ? ((p / M) * N + n) * (long long)Cin : -1;
    }
    for (int e = tid; e < kPairs * kTD; e += blockDim.x) {
      const int q = e / kTD, d = e % kTD;
      const long long p = p0 + q;
      unsigned bits = 0;
      float wx = 0.f, wn = 0.f;
      if (p < p_end && d0 + d < D) {
        const long long o = p * D + d0 + d;
        bits = (unsigned)bm[o];
        wx = pcm::to_f(dvx[o]);
        wn = pcm::to_f(dvn[o]);
      }
      for (int k = 0; k < K; ++k)
        Ws[(q * K + k) * kTD + d] =
            (float)((bits >> k) & 1u) * wx + (float)((bits >> (16 + k)) & 1u) * wn;
    }
    __syncthreads();  // base_s is complete
    for (int e = tid; e < rows * kTC; e += blockDim.x) {
      const int r = e / kTC, c = e % kTC;
      const long long base = base_s[r];
      As[r * kTC + c] = base >= 0 && c0 + c < Cin ? pcm::to_f(src[base + c0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const float4 a = *(const float4*)(As + r * kTC + 4 * ty);
      const float4 w0 = *(const float4*)(Ws + r * kTD + 4 * tx);
      const float4 w1 = *(const float4*)(Ws + r * kTD + 64 + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }

  float* pb = part + (long long)blockIdx.z * Cin * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + 4 * ty + i;
    if (c >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (d < D) pb[(long long)c * D + d] = acc[i][j];
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

// Kernel 6. src (B, N, Cin) bf16, nn (B, M, K) int32 (-1 = hole), bm
// (B, M, D) int32, dvx and dvn (B, M, D) bf16, all contiguous on device
// `device`; 1 <= K <= 16. The B*M (b, m) pairs are cut into `splits`
// consecutive runs; part is f32 scratch of splits * Cin * D; out (Cin, D)
// f32 is written. Returns the first cudaError_t that is not success.
int pcm_routed_dw(const void* src, const int* nn, const int* bm, const void* dvx,
                  const void* dvn, float* part, float* out, int B, int N, int M, int K,
                  int Cin, int D, int splits, int device, void* stream) {
  if (B < 1 || N < 1 || M < 1 || K < 1 || K > kMaxK || Cin < 1 || D < 1 || splits < 1 ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(routed_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kRoutedSmem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_pairs = (long long)B * M;
  const long long per_split = (n_pairs + splits - 1) / splits;
  const dim3 grid((Cin + kTC - 1) / kTC, (D + kTD - 1) / kTD, splits);
  routed_dw_kernel<<<grid, 256, kRoutedSmem, s>>>(
      (const bf16*)src, nn, bm, (const bf16*)dvx, (const bf16*)dvn, part, N, M, K, Cin, D,
      n_pairs, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)Cin * D;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, out, n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
