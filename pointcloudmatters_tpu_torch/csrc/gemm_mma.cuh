// A bf16 GEMM on the tensor cores with the fused attention layer's
// epilogues: the projections of kernel 7 at bf16 (x Wq, x Wk, x Wv and
// heads Wo) and every product of kernel 8 at bf16 but its attention
// (fused_mha.cu `bwd`): the recomputed q, k and v, dheads, the input
// gradients and the weight gradients.
//
// Replaces, at bf16, the projections inside the TPU kernels `_fwd_kernel`
// (pointcloudmatters_tpu/ops/fused_mha.py:59; pallas_call :164 of
// `_fwd_rule` :154) and `_bwd_kernel` (:206; pallas_call :419 of `_bwd_rule`
// :406): bf16 operands, every product and sum f32
// (`preferred_element_type=jnp.float32`), the output rounded once to its
// type. The f32 instance of the layer takes fused_mha.cu's FP32 GEMM: its
// operands are f32, which TF32 or bf16 products would round.
//
// Modes (template arguments of `gemm_kernel`; <false, kBias> is kernel 7's):
// - kBias: C = bf16((A B + bias) * scale): the projections, dheads = dO
//   Wo^T and dx_v = bf16(dv) Wv^T;
// - kF32: C = A B in f32, as split-K partials: split s of `splits` sums its
//   K range into c + s * c_split, which fused_mha.cu's `reduce_kernel` sums
//   in split order (dx_qk's dk part, one split; the weight gradients);
// - kAddend: C = bf16(A B + addend), the addend f32 (M, N): dx_qk =
//   bf16(bf16(dq) Wq^T + bf16(dk) Wk^T), rounded once;
// - A read transposed (kAT): A = X^T for X (K, M) row-major, the weight
//   gradients x^T g and heads^T dO over B L rows, K ragged: its tiles are
//   32 rows of 64 M values, read by `ldmatrix.trans`.
//
// What bounds it on an H100: the tensor cores, 2 M N K flops at 989 TFLOP/s
// bf16 dense (17.2 GFLOP for the four projections of a layer at B = 4,
// L = 2051, D = 512: 0.017 ms; 47.3 GFLOP for kernel 8's eleven products:
// 0.048 ms), against 3 MB of operands a problem.
//
// What the design does about it:
// - `mma.sync.m16n8k16` bf16 -> f32 on attention_mma.cuh's helpers. A block
//   is 4 warps computing a 64 x 64 tile of C, each warp a 32 x 32 quarter
//   (two 16-row A fragments, four 8-column B fragments, eight mma a 16-deep
//   step), over 32-deep K steps streamed through a two-stage `cp.async`
//   ring. Shared rows are padded by 16 bytes, so `ldmatrix` reads are free
//   of bank conflicts.
// - A is row-major (the activations) or, with kAT, read transposed. B = W is
//   read at any strides: with W's output axis contiguous (a (D_in, D_out)
//   weight, or a row-major gradient) a K step is 32 rows of 64 outputs,
//   read by `ldmatrix.trans`; with its input axis contiguous
//   (`nn.Linear.weight.t()`) it is 64 rows of 32 inputs, read by
//   `ldmatrix`; otherwise, or where rows are not 16-byte aligned, by plain
//   loads into the second layout. Rows past K load as zeros.
// - Up to four problems of one shape share a launch (blockIdx.z, times the
//   splits); every C element is summed by one thread in a fixed order, and
//   the split ranges are a function of the shape, so two launches give
//   identical bits.

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
constexpr int kMaxProblems = 4;
constexpr int kLdK = kBK + 8;  // a row of 32 K values, padded by 16 bytes
constexpr int kLdN = kBN + 8;  // a row of 64 N values, padded by 16 bytes

// How a problem's B tiles are loaded: rows of N values (ldmatrix.trans),
// rows of K values (ldmatrix), or plain loads into rows of K values.
enum BMode { kRowsOfN = 0, kRowsOfK = 1, kPlain = 2 };

// What the epilogue writes (see the header).
enum Out { kBias = 0, kF32 = 1, kAddend = 2 };

// One M x N x K problem, bf16 operands: A[m][k] = a[m * a_m + k] (with kAT
// a[k * a_m + m]), B[k][n] = b[k * b_k + n * b_n], C[m][n] = c[m * c_m + n]
// of bf16 (kBias, kAddend) or f32 (kF32, split s at c + s * c_split); bias
// has N values, or is null; addend is f32 (M, N) at row stride c_m, or null.
struct Problem {
  const bf16* a;
  long long a_m;
  const bf16* b;
  long long b_k, b_n;
  const bf16* bias;
  const float* addend;
  void* c;
  long long c_m, c_split;
  float scale;
  int a_vec;   // A rows 16-byte aligned: cp.async
  int b_mode;  // a BMode
};

// The problems of a launch and the split of K: split s sums K rows
// [s k_per_split, (s + 1) k_per_split) (kF32 only; otherwise one split).
struct Batch {
  Problem p[kMaxProblems];
  int splits, k_per_split;
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
// of 64, so B has no ragged tile; with kAT, M too, and rows past k_end are
// zero: K is ragged only there, and B then is never in kRowsOfK).
template <bool kAT>
__device__ __forceinline__ void load_step(const Problem& p, bf16* As, bf16* Bs, int m0, int n0,
                                          int k0, int k_end, int M, int N) {
  if constexpr (kAT)
    load_rows<kBK, kBM, kLdN>(As, p.a + m0, p.a_m, k0, k_end, p.a_vec);
  else
    load_rows<kBM, kBK, kLdK>(As, p.a + k0, p.a_m, m0, M, p.a_vec);
  if (p.b_mode == kRowsOfN) {
    load_rows<kBK, kBN, kLdN>(Bs, p.b + n0 * p.b_n, p.b_k, k0, kAT ? k_end : k0 + kBK, 1);
  } else if (p.b_mode == kRowsOfK) {
    load_rows<kBN, kBK, kLdK>(Bs, p.b + k0 * p.b_k, p.b_n, n0, N, 1);
  } else {
    for (int i = threadIdx.x; i < kBN * kBK; i += kThreads) {
      const int nn = i / kBK, kk = i % kBK;
      Bs[nn * kLdK + kk] =
          !kAT || k0 + kk < k_end
              ? p.b[(long long)(k0 + kk) * p.b_k + (long long)(n0 + nn) * p.b_n]
              : mm::bf16_zero();
    }
  }
}

// One block a 64 x 64 tile of C of problem blockIdx.z (with kF32, of
// problem blockIdx.z / splits over the K range of split blockIdx.z % splits).
template <bool kAT = false, int kOut = kBias>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Batch batch, int M, int N, int K) {
  constexpr int kA = kAT ? kBK * kLdN : kBM * kLdK;                  // A stage
  constexpr int kB = kBN * kLdK > kBK * kLdN ? kBN * kLdK : kBK * kLdN;  // B stage
  __shared__ __align__(16) bf16 As[2 * kA];
  __shared__ __align__(16) bf16 Bs[2 * kB];
  const int split = kOut == kF32 ? (int)blockIdx.z % batch.splits : 0;
  const Problem p = batch.p[kOut == kF32 ? (int)blockIdx.z / batch.splits : (int)blockIdx.z];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;  // the warp's quarter
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bool rows_of_n = p.b_mode == kRowsOfN;
  const int k_begin = kOut == kF32 ? split * batch.k_per_split : 0;
  const int k_end = kOut == kF32 ? min(K, k_begin + batch.k_per_split) : K;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int steps = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  if (steps > 0) load_step<kAT>(p, As, Bs, m0, n0, k_begin, k_end, M, N);
  mm::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    if (s + 1 < steps)
      load_step<kAT>(p, As + (st ^ 1) * kA, Bs + (st ^ 1) * kB, m0, n0,
                     k_begin + (s + 1) * kBK, k_end, M, N);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const bf16* At = As + st * kA;
    const bf16* Bt = Bs + st * kB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (kAT)  // At[k][m]: the 8 x 8 blocks (m, k) of a fragment, transposed
          mm::ldsm_x4_t(af[i], At + (kk * 16 + ((lane >> 4) << 3) + (lane & 7)) * kLdN + wm +
                                   i * 16 + (((lane >> 3) & 1) << 3));
        else
          mm::ldsm_x4(af[i], At + (wm + i * 16 + (lane & 15)) * kLdK + kk * 16 + (lane >> 4) * 8);
      }
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

  // the epilogue, two columns a store: (acc + bias) * scale or acc + addend
  // rounded once to bf16, or acc in f32
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + 8 * j + 2 * (lane & 3);  // and n + 1 (N is a multiple of 64)
      float b0 = 0.f, b1 = 0.f;
      if constexpr (kOut == kBias) {
        b0 = p.bias != nullptr ? to_f(p.bias[n]) : 0.f;
        b1 = p.bias != nullptr ? to_f(p.bias[n + 1]) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + (lane >> 2) + 8 * h;
        if (m >= M) continue;
        float x0 = acc[i][j][2 * h], x1 = acc[i][j][2 * h + 1];
        const long long at = (long long)m * p.c_m + n;
        if constexpr (kOut == kF32) {
          float* c = static_cast<float*>(p.c) + split * p.c_split + at;
          if ((uintptr_t)c % 8 == 0) {
            *reinterpret_cast<float2*>(c) = make_float2(x0, x1);
          } else {
            c[0] = x0;
            c[1] = x1;
          }
          continue;
        } else if constexpr (kOut == kBias) {
          x0 = __fmul_rn(__fadd_rn(x0, b0), p.scale);
          x1 = __fmul_rn(__fadd_rn(x1, b1), p.scale);
        } else if (p.addend != nullptr) {
          x0 = __fadd_rn(x0, p.addend[at]);
          x1 = __fadd_rn(x1, p.addend[at + 1]);
        }
        bf16* c = static_cast<bf16*>(p.c) + at;
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

// A problem over A (M, K) row-major (row stride a_m; with kAT, A^T (K, M)
// row-major) and B = W (K, N) at strides (b_k, b_n), into C (M, N) (row
// stride c_m); the B mode follows W's strides and alignment.
inline Problem problem(const bf16* a, long long a_m, const bf16* w, long long b_k,
                       long long b_n, const bf16* bias, void* c, long long c_m, float scale) {
  Problem p{a, a_m, w, b_k, b_n, bias, nullptr, c, c_m, 0, scale, rows_aligned(a, a_m), kPlain};
  if (b_n == 1 && rows_aligned(w, b_k))
    p.b_mode = kRowsOfN;
  else if (b_k == 1 && rows_aligned(w, b_n))
    p.b_mode = kRowsOfK;
  return p;
}

// The K rows of one split of K over `splits`: a multiple of the K step, so
// the ranges are a function of K and splits alone.
inline int k_per_split(int K, int splits) {
  return ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
}

// `n` problems of one M x N x K shape in one launch on `stream`; N a
// multiple of 64. Without kAT K is a multiple of 32; with kAT M is a
// multiple of 64, K any size, and no B in kRowsOfK. `splits` (kF32 only)
// splits K.
template <bool kAT = false, int kOut = kBias>
inline cudaError_t gemm(const Problem* probs, int n, int M, int N, int K, cudaStream_t stream,
                        int splits = 1) {
  if (n < 1 || n > kMaxProblems || M < 1 || N < 1 || N % kBN != 0 || K < 1 || splits < 1 ||
      (kOut != kF32 && splits != 1) || (M + kBM - 1) / kBM > 65535 || n * splits > 65535)
    return cudaErrorInvalidValue;
  if (kAT ? M % kBM != 0 : (K < kBK || K % kBK != 0)) return cudaErrorInvalidValue;
  Batch batch{};
  for (int i = 0; i < n; ++i) {
    if (kAT && probs[i].b_mode == kRowsOfK) return cudaErrorInvalidValue;
    batch.p[i] = probs[i];
  }
  batch.splits = splits;
  batch.k_per_split = k_per_split(K, splits);
  gemm_kernel<kAT, kOut><<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, n * splits), kThreads,
                           0, stream>>>(batch, M, N, K);
  return cudaGetLastError();
}

}  // namespace gemm_mma
}  // namespace pcm
