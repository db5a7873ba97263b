// A bf16 GEMM on the tensor cores with the fused attention layer's
// epilogue: the projections of kernel 7 at bf16 (x Wq, x Wk, x Wv and
// heads Wo), which kernel 8 at bf16 shares for its recomputed q, k and v
// (fused_mha.cu `project_qkv`).
//
// Replaces, at bf16, the projections inside the TPU kernel `_fwd_kernel`
// (pointcloudmatters_tpu/ops/fused_mha.py:59; pallas_call :164 of
// `_fwd_rule` :154): C = T((A B + bias) * scale), bf16 operands, every
// product and sum f32 (`preferred_element_type=jnp.float32`), the output
// rounded once to its type. The f32 instance of the layer keeps its FMA
// GEMM (fused_mha.cu `gemm_kernel`): its operands are f32, which TF32 or
// bf16 products would round.
//
// What bounds it on an H100: the tensor cores, 2 M N K flops at 989 TFLOP/s
// bf16 dense (17.2 GFLOP for the four projections of a layer at B = 4,
// L = 2051, D = 512: 0.017 ms), against 3 MB of operands a problem.
//
// What the design does about it:
// - `mma.sync.m16n8k16` bf16 -> f32 on attention_mma.cuh's helpers. A block
//   is 4 warps computing a 64 x 64 tile of C, each warp a 32 x 32 quarter
//   (two 16-row A fragments, four 8-column B fragments, eight mma a 16-deep
//   step), over 32-deep K steps streamed through a two-stage `cp.async`
//   ring. Shared rows are padded by 16 bytes, so `ldmatrix` reads are free
//   of bank conflicts.
// - A is row-major (the activations). B = W is read at any strides: with
//   W's output axis contiguous (a (D_in, D_out) weight) a K step is 32 rows
//   of 64 outputs, read by `ldmatrix.trans`; with its input axis contiguous
//   (`nn.Linear.weight.t()`) it is 64 rows of 32 inputs, read by
//   `ldmatrix`; otherwise, or where rows are not 16-byte aligned, by plain
//   loads into the second layout.
// - Up to three problems of one shape share a launch (blockIdx.z), as the
//   FMA GEMM's `GemmBatch` does; every C element is summed by one thread in
//   a fixed order, so two launches give identical bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "elem.cuh"

namespace pcm {
namespace gemm_mma {

namespace mm = attn_mma;

constexpr int kBM = 64, kBN = 64, kBK = 32;  // block tile of C, K step
constexpr int kThreads = 128;                 // 4 warps, 2 x 2, 32 x 32 each
constexpr int kMaxProblems = 3;
constexpr int kLdK = kBK + 8;  // a row of 32 K values, padded by 16 bytes
constexpr int kLdN = kBN + 8;  // a row of 64 N values, padded by 16 bytes

// How a problem's B tiles are loaded: rows of N values (ldmatrix.trans),
// rows of K values (ldmatrix), or plain loads into rows of K values.
enum BMode { kRowsOfN = 0, kRowsOfK = 1, kPlain = 2 };

// C = (A B + bias) * scale over an M x N x K problem, bf16 in and out:
// A[m][k] = a[m * a_m + k], B[k][n] = b[k * b_k + n * b_n], C[m][n] =
// c[m * c_m + n]; bias has N values, or is null.
struct Problem {
  const bf16* a;
  long long a_m;
  const bf16* b;
  long long b_k, b_n;
  const bf16* bias;
  bf16* c;
  long long c_m;
  float scale;
  int a_vec;   // A rows 16-byte aligned: cp.async
  int b_mode;  // a BMode
};

struct Batch {
  Problem p[kMaxProblems];
};

// ROWS rows of COLS contiguous values, rows r0.. of g (row stride ls), into
// a shared tile of row pitch LDS; zero at rows >= n. By cp.async with `vec`
// (the caller commits and waits), else by plain loads.
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g, long long ls, int r0, int n,
                                          int vec) {
  constexpr int CH = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    bf16* dst = sm + r * LDS + c;
    const bool in = r0 + r < n;
    const bf16* src = in ? g + (long long)(r0 + r) * ls + c : g;
    if (vec) {
      mm::cp_async16(dst, src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = in ? src[e] : mm::bf16_zero();
    }
  }
}

// The A and B tiles of K step k0 into one stage of the ring (N a multiple
// of 64, so B has no ragged tile).
__device__ __forceinline__ void load_step(const Problem& p, bf16* As, bf16* Bs, int m0, int n0,
                                          int k0, int M, int N) {
  load_rows<kBM, kBK, kLdK>(As, p.a + k0, p.a_m, m0, M, p.a_vec);
  if (p.b_mode == kRowsOfN) {
    load_rows<kBK, kBN, kLdN>(Bs, p.b + n0 * p.b_n, p.b_k, k0, k0 + kBK, 1);
  } else if (p.b_mode == kRowsOfK) {
    load_rows<kBN, kBK, kLdK>(Bs, p.b + k0 * p.b_k, p.b_n, n0, N, 1);
  } else {
    for (int i = threadIdx.x; i < kBN * kBK; i += kThreads) {
      const int nn = i / kBK, kk = i % kBK;
      Bs[nn * kLdK + kk] = p.b[(long long)(k0 + kk) * p.b_k + (long long)(n0 + nn) * p.b_n];
    }
  }
}

// One block a 64 x 64 tile of C of problem blockIdx.z.
__global__ void __launch_bounds__(kThreads) gemm_kernel(Batch batch, int M, int N, int K) {
  constexpr int kA = kBM * kLdK;                                     // A stage
  constexpr int kB = kBN * kLdK > kBK * kLdN ? kBN * kLdK : kBK * kLdN;  // B stage
  __shared__ __align__(16) bf16 As[2 * kA];
  __shared__ __align__(16) bf16 Bs[2 * kB];
  const Problem p = batch.p[blockIdx.z];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;  // the warp's quarter
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bool rows_of_n = p.b_mode == kRowsOfN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int steps = K / kBK;
  load_step(p, As, Bs, m0, n0, 0, M, N);
  mm::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    if (s + 1 < steps)
      load_step(p, As + (st ^ 1) * kA, Bs + (st ^ 1) * kB, m0, n0, (s + 1) * kBK, M, N);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const bf16* At = As + st * kA;
    const bf16* Bt = Bs + st * kB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mm::ldsm_x4(af[i], At + (wm + i * 16 + (lane & 15)) * kLdK + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {  // 8-column B fragments 2 jp and 2 jp + 1
        uint32_t bf[4];
        const int nb = wn + jp * 16;
        if (rows_of_n)
          mm::ldsm_x4_t(bf, Bt + (kk * 16 + (lane & 15)) * kLdN + nb + ((lane >> 4) << 3));
        else
          mm::ldsm_x4(bf, Bt + (nb + (lane & 7) + ((lane >> 4) << 3)) * kLdK + kk * 16 +
                              (((lane >> 3) & 1) << 3));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mm::mma(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mm::mma(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

  // the epilogue: (acc + bias) * scale, rounded once, two columns a store
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + 8 * j + 2 * (lane & 3);  // and n + 1 (N is a multiple of 64)
      const float b0 = p.bias != nullptr ? to_f(p.bias[n]) : 0.f;
      const float b1 = p.bias != nullptr ? to_f(p.bias[n + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + (lane >> 2) + 8 * h;
        if (m >= M) continue;
        const float x0 = __fmul_rn(__fadd_rn(acc[i][j][2 * h], b0), p.scale);
        const float x1 = __fmul_rn(__fadd_rn(acc[i][j][2 * h + 1], b1), p.scale);
        bf16* c = p.c + (long long)m * p.c_m + n;
        if ((uintptr_t)c % 4 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(x0, x1);
        } else {
          c[0] = __float2bfloat16_rn(x0);
          c[1] = __float2bfloat16_rn(x1);
        }
      }
    }
}

// Whether a row-major view (pointer, row stride) has 16-byte aligned rows.
inline int rows_aligned(const void* p, long long ls) {
  return (uintptr_t)p % 16 == 0 && ls % 8 == 0;
}

// A problem over A (M, K) row-major (row stride a_m) and B = W (K, N) at
// strides (b_k, b_n), into C (M, N) (row stride c_m); the B mode follows
// W's strides and alignment.
inline Problem problem(const bf16* a, long long a_m, const bf16* w, long long b_k,
                       long long b_n, const bf16* bias, bf16* c, long long c_m, float scale) {
  Problem p{a, a_m, w, b_k, b_n, bias, c, c_m, scale, rows_aligned(a, a_m), kPlain};
  if (b_n == 1 && rows_aligned(w, b_k))
    p.b_mode = kRowsOfN;
  else if (b_k == 1 && rows_aligned(w, b_n))
    p.b_mode = kRowsOfK;
  return p;
}

// `n` problems of one M x N x K shape in one launch on `stream`; N a
// multiple of 64 and K of 32 (the layer's D is a multiple of 64).
inline cudaError_t gemm(const Problem* probs, int n, int M, int N, int K, cudaStream_t stream) {
  if (n < 1 || n > kMaxProblems || M < 1 || N < 1 || N % kBN != 0 || K < kBK || K % kBK != 0 ||
      (M + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  Batch batch{};
  for (int i = 0; i < n; ++i) batch.p[i] = probs[i];
  gemm_kernel<<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, n), kThreads, 0, stream>>>(
      batch, M, N, K);
  return cudaGetLastError();
}

}  // namespace gemm_mma
}  // namespace pcm
