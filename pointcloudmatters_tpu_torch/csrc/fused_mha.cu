// One self-attention layer with its projections, forward and backward, f32
// or bf16 inputs (the element type T of x, the weights and the biases).
//
// Replaces the TPU kernels `_fwd_kernel` / `_fwd_rule` and `_bwd_kernel` /
// `_bwd_rule` (pointcloudmatters_tpu/ops/fused_mha.py:59-203, 206-476).
// Semantics, with bf16() a rounding to bf16 and every sum and product f32
// from the operands' values (the TPU kernel rounds to bf16 whatever T is):
//
//   q = bf16((x_qk Wq + bq) * scale)   k = bf16(x_qk Wk + bk)   v = bf16(x_v Wv + bv)
//   per head: e = exp(s - rowmax s), denom = sum e (before dropout),
//             e_drop = keep ? e / (1 - rate) : 0, head = bf16((bf16(e_drop) v) / denom)
//   out = T(heads Wo + bo)
//
// and the backward, which recomputes q, k, v and the row statistics from the
// inputs (the forward saves nothing else):
//
//   dheads = bf16(dO Wo^T); r = 1 / denom; p_drop = keep ? e (inv r) : 0
//   dv = bf16(p_drop)^T dheads; dp = dheads v^T; z = keep ? dp (inv r) : 0
//   u = r sum(z e) (unrounded); ds = bf16(e (z - u)); dq = ds k; dk = ds q
//   dq_lin = dq * scale (unrounded); dx_qk = T(bf16(dq_lin) Wq^T + bf16(dk) Wk^T)
//   dx_v = T(bf16(dv) Wv^T); dWq = x_qk^T bf16(dq_lin), dWk = x_qk^T bf16(dk),
//   dWv = x_v^T bf16(dv), dWo = heads^T dO; db. = the f32 column sums of
//   dq_lin, dk, dv and dO; every weight and bias gradient cast to T.
//
// The keep mask is the oneshot kernels' (philox.cuh): one per head, shared
// across the batch, a function of (seed, head, query row, key column).
//
// What bounds it on an H100: arithmetic. At B=4, L=2051, D=512, 8 heads:
// the forward is 17.2 GFLOP of projections and 34.5 of attention; the
// backward 47.3 of projection-type products (q, k, v recomputed, dheads,
// three input and four weight gradients) and 189 of attention as this
// design computes it (11 L^2 dh products a head: S three times and dP
// twice, e V, dQ, dV and dK; the TPU kernel counts 6). Every attention
// product, in both instances, is `mma.sync` bf16 -> f32 on the tensor cores
// (the TPU kernel rounds q, k, v, e, dheads and the heads to bf16 whatever
// T is, so no rounding moves): 0.19 ms at 989 TFLOP/s. At bf16 every other
// product is on the tensor cores too (gemm_mma.cuh, 0.05 ms); at f32 those
// take an f32 operand and run on the FP32 pipes (the FP32 GEMM below, 0.71
// ms at 67 TFLOP/s; TF32 or bf16 products would round the f32 operands).
// What holds it back now: `mma.sync` fed from shared memory and exp on the
// FP32 pipes in the attention kernels (bf16 #3/#4 reach 130-150 TFLOP/s at
// rate 0), the FP32 GEMM's share of the FP32 peak at f32, and some twenty
// launches of which the reductions are small.
//
// What the design does about the TPU kernel's shape. That kernel keeps K, V
// and all eight weight-gradient accumulators in VMEM across a sequential
// (batch, q-tile) grid; Hopper has no sequential grid and 227 KB a block. So
// each product is its own pass, every launch is free of atomics, and every
// sum has a fixed order (two launches are bit-identical):
//
//   - `project_qkv`, the q, k and v projections of both directions, one
//     launch of three problems: at bf16 gemm_mma.cuh's tensor-core GEMM, at
//     f32 the FP32 GEMM; the forward's out projection likewise;
//   - the forward's attention core is bf16 kernel 3's tensor-core forward
//     (attention_mma.cuh, scale 1: q is already scaled and rounded), whose
//     two passes round e against the row's final max;
//   - the backward's attention is attention_mma.cuh's kernels in their
//     `Fused` statistics form, in both instances: the forward kernel as the
//     rows' statistics pass, a block a (batch, head, 64-query tile): a pass
//     over the key tiles for the row max m, then one for e, its sum,
//     sum(keep dP e) and the recomputed head (e_drop V); it writes m,
//     r = 1 / sum e, u and the head. Then bf16 kernel 4's dK/dV kernel (a
//     block a 64-key tile, S^T and dP^T, over the query tiles) and dQ
//     kernel (a block a 64-query tile, S and dP again) with ds =
//     bf16(e (z - u)), writing dq_lin = dQ scale, dK and dV in f32 (for
//     the bias sums) and in bf16 (the GEMMs' operands);
//   - the input and weight gradients: at bf16 gemm_mma.cuh's modes (dx_qk's
//     dk part into f32, then its dq part with that addend, rounded once; the
//     four weight gradients x^T g with A read transposed, one launch, as
//     f32 split-K partials), at f32 the FP32 GEMM;
//   - `colsum_kernel` + `reduce_kernel`: the bias gradients in f32, and the
//     sums of the split partials, in split order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "attention_mma.cuh"
#include "elem.cuh"
#include "gemm_mma.cuh"
#include "philox.cuh"

namespace {

using pcm::bf16;
using pcm::from_f;
using pcm::to_f;

constexpr int kThreads = 256;  // the reductions' blocks
constexpr int kMaxProblems = 4;

// ---------------------------------------------------------------------------
// The FP32 GEMM: every product of the f32 instance but the attention.
//
// C = (A B + bias) * scale + addend over an M x N x K problem whose operands
// are f32 or bf16 (a bf16 value converts to f32 exactly as it loads), every
// product an f32 FMA and every sum f32 in K order: no TF32 and no split-bf16,
// so f32 operands stay exact. The output is rounded once to its type. Up to
// four problems of one shape share a launch (blockIdx.z, times the splits);
// a long K (the weight gradients, B*L rows) is split into `splits` ranges
// whose f32 partials `reduce_kernel` sums in split order.
//
// What bounds it on an H100: the FP32 pipes, 2 M N K flops at 67 TFLOP/s
// (kernel 8's eleven products at B = 4, L = 2051, D = 512, 47.3 GFLOP:
// 0.71 ms; kernel 7's four, 17.2 GFLOP: 0.26 ms).
//
// What the design does about it: a block of 256 threads computes a
// 128 x 128 tile of C, each thread an 8 x 8 register tile (rows 4 ty .. and
// 64 + 4 ty .., columns 4 tx .. and 64 + 4 tx ..): 64 FMAs for every four
// `float4` shared loads. A and B are staged K-major (As[k][m], Bs[k][n],
// rows padded by 4 floats) in 8-deep K steps, double-buffered: the next
// step's global loads go to registers while this step multiplies. A thread
// loads four neighbours along an operand's contiguous axis, by one vector
// load where the rows are aligned, and transposes them into the K-major
// tile where that axis is K. Two blocks an SM (128 registers a thread).

constexpr int kSM = 128, kSN = 128, kSK = 8;  // block tile of C, K step
constexpr int kSThreads = 256;                // 16 x 16 threads, 8 x 8 outputs each
constexpr int kSLd = kSM + 4;                 // a K-major tile row, padded

// C = (A B + bias) * scale + addend: element (m, k) of A at a[m * a_m + k *
// a_k], and so on; bias has N values of B's type, addend is f32 (M, N) at
// row stride N; either may be null. Split s of a split K writes its partial
// at c + s * c_split. The layout flags are set by `gemm`.
struct Gemm {
  const void* a;
  long long a_m, a_k;
  const void* b;
  long long b_k, b_n;
  const void* bias;
  const float* addend;
  void* c;
  long long c_m, c_split;
  float scale;
  int a_kc, a_vec;  // A's chunks run along K; by vector loads
  int b_kc, b_vec;  // likewise for B
};

struct GemmBatch {
  Gemm p[kMaxProblems];
  int splits, k_per_split;
};

// base[0], base[step], base[2 step], base[3 step] as f32, zero past the first
// n; one vector load when `vec` and all four are in (step 1, aligned).
template <typename T>
__device__ __forceinline__ float4 fetch4(const T* base, long long step, int n, int vec) {
  if (vec && n == 4) {
    if constexpr (pcm::is_bf16<T>::value) {
      const uint2 u = *reinterpret_cast<const uint2*>(base);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      return make_float4(lo.x, lo.y, hi.x, hi.y);
    } else {
      return *reinterpret_cast<const float4*>(base);
    }
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < n ? to_f(base[i * step]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// A thread's chunk of the tile of K step k0 of an operand with rows (M or N
// axis) r0 .. r0 + 127 of `rows`: four K values of one row (kc) or four rows
// of one K value; zero past `rows` and past k_end.
template <typename T>
__device__ __forceinline__ float4 fetch_tile(const T* x, long long s_r, long long s_k, int kc,
                                             int vec, int r0, int rows, int k0, int k_end) {
  const int t = threadIdx.x;
  if (kc) {
    const int r = r0 + (t >> 1), k = k0 + (t & 1) * 4;
    const int n = r < rows ? max(0, min(4, k_end - k)) : 0;
    return fetch4(x + (long long)r * s_r + (long long)k * s_k, s_k, n, vec);
  }
  const int k = k0 + (t >> 5), r = r0 + (t & 31) * 4;
  const int n = k < k_end ? max(0, min(4, rows - r)) : 0;
  return fetch4(x + (long long)r * s_r + (long long)k * s_k, s_r, n, vec);
}

// That chunk into a K-major shared tile.
__device__ __forceinline__ void store_tile(float* S, float4 v, int kc) {
  const int t = threadIdx.x;
  if (kc) {
    const int r = t >> 1, k = (t & 1) * 4;
    S[(k + 0) * kSLd + r] = v.x;
    S[(k + 1) * kSLd + r] = v.y;
    S[(k + 2) * kSLd + r] = v.z;
    S[(k + 3) * kSLd + r] = v.w;
  } else {
    *reinterpret_cast<float4*>(S + (t >> 5) * kSLd + (t & 31) * 4) = v;
  }
}

// Four neighbouring outputs, rounded to TC; one vector store where aligned.
template <typename TC>
__device__ __forceinline__ void store4(TC* c, const float (&x)[4]) {
  if constexpr (pcm::is_bf16<TC>::value) {
    if ((uintptr_t)c % 8 == 0) {
      __nv_bfloat162 v[2] = {__floats2bfloat162_rn(x[0], x[1]), __floats2bfloat162_rn(x[2], x[3])};
      *reinterpret_cast<uint2*>(c) = *reinterpret_cast<const uint2*>(v);
      return;
    }
  } else {
    if ((uintptr_t)c % 16 == 0) {
      *reinterpret_cast<float4*>(c) = make_float4(x[0], x[1], x[2], x[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] = from_f<TC>(x[j]);
}

// One block a 128 x 128 tile of C of problem blockIdx.z / splits, over the K
// range of split blockIdx.z % splits.
template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kSThreads, 2)
fp32_gemm_kernel(GemmBatch batch, int M, int N, int K) {
  __shared__ __align__(16) float As[2][kSK * kSLd];
  __shared__ __align__(16) float Bs[2][kSK * kSLd];
  const int split = (int)blockIdx.z % batch.splits;
  const Gemm p = batch.p[blockIdx.z / batch.splits];
  const TA* A = static_cast<const TA*>(p.a);
  const TB* Bm = static_cast<const TB*>(p.b);
  const int m0 = blockIdx.y * kSM, n0 = blockIdx.x * kSN;
  const int k_begin = split * batch.k_per_split;
  const int k_end = min(K, k_begin + batch.k_per_split);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (k_begin < k_end) {
    float4 ra = fetch_tile(A, p.a_m, p.a_k, p.a_kc, p.a_vec, m0, M, k_begin, k_end);
    float4 rb = fetch_tile(Bm, p.b_n, p.b_k, p.b_kc, p.b_vec, n0, N, k_begin, k_end);
    store_tile(As[0], ra, p.a_kc);
    store_tile(Bs[0], rb, p.b_kc);
    __syncthreads();
    int st = 0;
    for (int k0 = k_begin; k0 < k_end; k0 += kSK) {
      const bool more = k0 + kSK < k_end;
      if (more) {  // the next step's loads in flight while this one multiplies
        ra = fetch_tile(A, p.a_m, p.a_k, p.a_kc, p.a_vec, m0, M, k0 + kSK, k_end);
        rb = fetch_tile(Bm, p.b_n, p.b_k, p.b_kc, p.b_vec, n0, N, k0 + kSK, k_end);
      }
      const float* At = As[st];
      const float* Bt = Bs[st];
#pragma unroll
      for (int kk = 0; kk < kSK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(At + kk * kSLd + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(At + kk * kSLd + 64 + 4 * ty);
        const float4 b0 = *reinterpret_cast<const float4*>(Bt + kk * kSLd + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(Bt + kk * kSLd + 64 + 4 * tx);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) {
        store_tile(As[st ^ 1], ra, p.a_kc);
        store_tile(Bs[st ^ 1], rb, p.b_kc);
      }
      __syncthreads();  // stage st is consumed, stage st ^ 1 filled
      st ^= 1;
    }
  }

  TC* C = static_cast<TC*>(p.c) + split * p.c_split;
  const TB* bias = static_cast<const TB*>(p.bias);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i >> 2) * 64 + 4 * ty + (i & 3);
    if (m >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + jh * 64 + 4 * tx;  // and the next three (N is a multiple of 64)
      if (n >= N) continue;
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = acc[i][4 * jh + j];
        if (bias != nullptr) x[j] += to_f(bias[n + j]);
        x[j] *= p.scale;
        if (p.addend != nullptr) x[j] += p.addend[(long long)m * N + n + j];
      }
      store4(C + (long long)m * p.c_m + n, x);
    }
  }
}

// out[i] = sum over s < S of part[s * stride + i], in order of s.
template <typename TO>
__global__ void reduce_kernel(const float* __restrict__ part, long long stride, int S,
                              long long n, TO* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[k * stride + i];
  out[i] = from_f<TO>(s);
}

// part[s * stride + c] = sum of x[r][c] over the rows r of split s: a block
// of 32 columns x 8 row lanes, lane g summing rows g, g + 8, ... in order, the
// lanes then summed in order.
template <typename TI>
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const TI* __restrict__ x, int rows, int cols, int rows_per_split,
              float* __restrict__ part, long long stride) {
  __shared__ float lanes[8][32];
  const int cx = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + cx;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);
  float s = 0.f;
  if (c < cols)
    for (int r = r0 + g; r < r1; r += 8) s += to_f(x[(long long)r * cols + c]);
  lanes[g][cx] = s;
  __syncthreads();
  if (g == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += lanes[k][cx];
    part[blockIdx.y * stride + c] = t;
  }
}

// ---------------------------------------------------------------------------
// Launch helpers

// Returns the cudaError_t of `call` from the enclosing function unless it is
// cudaSuccess.
#define PCM_TRY(call)                          \
  do {                                         \
    const cudaError_t e_ = (call);             \
    if (e_ != cudaSuccess) return e_;          \
  } while (0)

struct Launch {
  int B, L, D, H, splits;
  float scale;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int dropout;
  cudaStream_t stream;
};

// A weight (D_in, D_out) with strides (in, out), as the B operand: W itself
// or its transpose.
struct Weight {
  const void* w;
  long long s_in, s_out;
};

Gemm problem(const void* a, long long a_m, long long a_k, const void* b, long long b_k,
             long long b_n, void* c, long long c_m) {
  Gemm g{};
  g.a = a;
  g.a_m = a_m;
  g.a_k = a_k;
  g.b = b;
  g.b_k = b_k;
  g.b_n = b_n;
  g.c = c;
  g.c_m = c_m;
  g.scale = 1.f;
  return g;
}

// rows (M, D) x W (D, D), the rows row-major
Gemm times_w(const void* x, const Weight& w, void* c, long long D) {
  return problem(x, D, 1, w.w, w.s_in, w.s_out, c, D);
}

// rows (M, D) x W^T (D, D)
Gemm times_wt(const void* x, const Weight& w, void* c, long long D) {
  return problem(x, D, 1, w.w, w.s_out, w.s_in, c, D);
}

// x^T g over `rows` rows of (rows, D) row-major x and g -> f32 split partials
Gemm xt_times(const void* x, const void* g, float* part, long long D, long long part_stride) {
  Gemm p = problem(x, 1, D, g, D, 1, part, D);
  p.c_split = part_stride;
  return p;
}

// An operand's layout flags: chunks along K unless its other axis (M or N)
// is the contiguous one; vector loads where that axis has stride 1 and
// every chunk starts 4-element aligned.
template <typename T>
void layout(const void* x, long long s_r, long long s_k, int& kc, int& vec) {
  kc = !(s_r == 1 && s_k != 1);
  const long long contiguous = kc ? s_k : s_r, other = kc ? s_r : s_k;
  vec = contiguous == 1 && other % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0;
}

// `probs` (up to four of one M x N x K shape) in one launch of the FP32 GEMM
template <typename TA, typename TB, typename TC>
cudaError_t gemm(const Launch& l, std::initializer_list<Gemm> probs, int M, int N, int K,
                 int splits = 1) {
  GemmBatch batch{};
  int n = 0;
  for (Gemm g : probs) {
    layout<TA>(g.a, g.a_m, g.a_k, g.a_kc, g.a_vec);
    layout<TB>(g.b, g.b_n, g.b_k, g.b_kc, g.b_vec);
    batch.p[n++] = g;
  }
  batch.splits = splits;
  batch.k_per_split = pcm::gemm_mma::k_per_split(K, splits);  // a multiple of kSK
  const dim3 grid((N + kSN - 1) / kSN, (M + kSM - 1) / kSM, n * splits);
  fp32_gemm_kernel<TA, TB, TC><<<grid, kSThreads, 0, l.stream>>>(batch, M, N, K);
  return cudaGetLastError();
}

namespace mma = pcm::gemm_mma;

// (rows, D) x W (D, D) -> C on the tensor cores (bf16 only)
mma::Problem mma_times_w(const bf16* x, const Weight& w, const bf16* bias, void* c, long long D,
                         float scale) {
  return mma::problem(x, D, (const bf16*)w.w, w.s_in, w.s_out, bias, c, D, scale);
}

// (rows, D) x W^T (D, D) -> C on the tensor cores, `addend` f32 (rows, D) or null
mma::Problem mma_times_wt(const bf16* x, const Weight& w, const float* addend, void* c,
                          long long D) {
  mma::Problem p = mma::problem(x, D, (const bf16*)w.w, w.s_out, w.s_in, nullptr, c, D, 1.f);
  p.addend = addend;
  return p;
}

// x^T g over the rows of (rows, D) row-major x and g -> f32 split partials
// on the tensor cores (A read transposed)
mma::Problem mma_xt_times(const bf16* x, const bf16* g, float* part, long long D,
                          long long part_stride) {
  mma::Problem p = mma::problem(x, D, g, D, 1, nullptr, part, D, 1.f);
  p.c_split = part_stride;
  return p;
}

// q, k, v into the bf16 (3, B, L, D) buffer qkv: the forward's and the
// backward's projections, one launch; at bf16 on the tensor cores
// (gemm_mma.cuh), at f32 by the FP32 GEMM.
template <typename T>
cudaError_t project_qkv(const Launch& l, const T* x_qk, const T* x_v, const Weight* w,
                        const T* const* bias, bf16* qkv) {
  const long long rows = (long long)l.B * l.L, D = l.D;
  if constexpr (pcm::is_bf16<T>::value) {
    const mma::Problem p[3] = {mma_times_w(x_qk, w[0], bias[0], qkv, D, l.scale),
                               mma_times_w(x_qk, w[1], bias[1], qkv + rows * D, D, 1.f),
                               mma_times_w(x_v, w[2], bias[2], qkv + 2 * rows * D, D, 1.f)};
    return mma::gemm(p, 3, (int)rows, l.D, l.D, l.stream);
  } else {
    Gemm q = times_w(x_qk, w[0], qkv, D), k = times_w(x_qk, w[1], qkv + rows * D, D),
         v = times_w(x_v, w[2], qkv + 2 * rows * D, D);
    q.bias = bias[0];
    q.scale = l.scale;
    k.bias = bias[1];
    v.bias = bias[2];
    return gemm<T, T, bf16>(l, {q, k, v}, (int)rows, l.D, l.D);
  }
}

// The heads of every head from q, k, v: bf16 kernel 3's tensor-core forward
// (attention_mma.cuh) with scale 1 (q is already scaled and rounded), all
// L keys, one keep mask per head shared across the batch, no row statistics.
template <int DH>
cudaError_t attention_core(const Launch& l, const bf16* qkv, bf16* heads) {
  namespace mm = pcm::attn_mma;
  const long long rows = (long long)l.B * l.L, D = l.D;
  const mm::Strides st{l.L * D, DH, D};
  const bf16 *q = qkv, *k = qkv + rows * D, *v = qkv + 2 * rows * D;
  const mm::FwdArgs a{q, k, v, heads, nullptr, nullptr, st, st, st, st, l.H, l.L, l.L, l.L,
                      1.0f, l.threshold, l.inv_keep, l.seed, l.dropout,
                      mm::rows_aligned(k, st) && mm::rows_aligned(v, st)};
  return mm::launch_fwd<DH>(a, l.B, l.stream);
}

template <typename T>
cudaError_t fwd(void* const* ptrs, const Weight* w, const Launch& l) {
  const T* x_qk = (const T*)ptrs[0];
  const T* x_v = (const T*)ptrs[1];
  const T* bias[4] = {(const T*)ptrs[3], (const T*)ptrs[5], (const T*)ptrs[7],
                      (const T*)ptrs[9]};
  bf16* qkv = (bf16*)ptrs[10];  // q, k, v, heads: (B, L, D) each
  T* out = (T*)ptrs[11];
  const long long rows = (long long)l.B * l.L, D = l.D;
  bf16* heads = qkv + 3 * rows * D;
  PCM_TRY(project_qkv<T>(l, x_qk, x_v, w, bias, qkv));
  PCM_TRY(l.D / l.H == 64 ? attention_core<64>(l, qkv, heads)
                          : attention_core<128>(l, qkv, heads));
  if constexpr (pcm::is_bf16<T>::value) {
    const mma::Problem o = mma_times_w(heads, w[3], bias[3], out, D, 1.f);
    return mma::gemm(&o, 1, (int)rows, l.D, l.D, l.stream);
  } else {
    Gemm o = times_w(heads, w[3], out, D);
    o.bias = bias[3];
    return gemm<bf16, T, T>(l, {o}, (int)rows, l.D, l.D);
  }
}

// The backward's attention on the tensor cores (attention_mma.cuh, the
// `Fused` form): the statistics pass (m, r, u and the heads), then dK/dV
// and dQ. q, k, v, dheads, the heads and the bf16 dq, dk, dv are (B, L, D)
// with head h in columns h*dh .., as are the f32 dq, dk, dv; stats holds
// m, r, u, (B, H, L) each.
template <int DH>
cudaError_t attention_bwd(const Launch& l, const bf16* q, const bf16* k, const bf16* v,
                          const bf16* dheads, bf16* heads, bf16* dq, bf16* dk, bf16* dv,
                          float* stats, float* dq32, float* dk32, float* dv32) {
  namespace mm = pcm::attn_mma;
  const long long D = l.D, n_stats = (long long)l.B * l.H * l.L;
  float *m = stats, *r = stats + n_stats, *u = stats + 2 * n_stats;
  const mm::Strides st{l.L * D, DH, D};
  const int vec = mm::rows_aligned(q, st) && mm::rows_aligned(k, st) &&
                  mm::rows_aligned(v, st) && mm::rows_aligned(dheads, st);
  const mm::FwdArgs fa{q, k, v, heads, m, r, st, st, st, st, l.H, l.L, l.L, l.L,
                       1.0f, l.threshold, l.inv_keep, l.seed, l.dropout, vec};
  const mm::BwdArgs ba{q, k, v, dheads, m, r, u, dq, dk, dv, st, st, st, st, st, st, st,
                       l.H, l.L, l.L, l.L, l.scale, l.threshold, l.inv_keep, l.seed, l.dropout,
                       vec};
  return mm::launch_fused_bwd<DH>(fa, ba, mm::Fused{dheads, u, dq32, dk32, dv32}, l.B, l.stream);
}

template <typename TI>
cudaError_t colsum(const Launch& l, const TI* x, float* part, long long stride) {
  const int rows = l.B * l.L;
  const int per = (rows + l.splits - 1) / l.splits;
  colsum_kernel<TI><<<dim3((l.D + 31) / 32, l.splits), kThreads, 0, l.stream>>>(x, rows, l.D,
                                                                               per, part, stride);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t reduce(const Launch& l, const float* part, long long stride, long long n, TO* out) {
  reduce_kernel<TO><<<(unsigned)((n + 255) / 256), 256, 0, l.stream>>>(part, stride, l.splits,
                                                                        n, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(void* const* ptrs, const Weight* w, const Launch& l) {
  const T* x_qk = (const T*)ptrs[0];
  const T* x_v = (const T*)ptrs[1];
  const T* dout = (const T*)ptrs[2];
  const T* bias[3] = {(const T*)ptrs[4], (const T*)ptrs[6], (const T*)ptrs[8]};
  const long long rows = (long long)l.B * l.L, D = l.D, DD = D * D;
  bf16* qkv = (bf16*)ptrs[10];  // q, k, v, dheads, heads, dq_lin, dk, dv
  bf16* dheads = qkv + 3 * rows * D;
  bf16* heads = qkv + 4 * rows * D;
  bf16 *dq = qkv + 5 * rows * D, *dk = qkv + 6 * rows * D, *dv = qkv + 7 * rows * D;
  float* f32s = (float*)ptrs[11];  // dq_lin, dk, dv, dxk
  float *dq32 = f32s, *dk32 = f32s + rows * D, *dv32 = f32s + 2 * rows * D,
        *dxk = f32s + 3 * rows * D;
  float* stats = (float*)ptrs[12];  // m, r, u: (B, H, L) each
  float* parts = (float*)ptrs[13];  // (4, splits, D*D + D)
  T* dx_qk = (T*)ptrs[14];
  T* dx_v = (T*)ptrs[15];
  T* dW[4] = {(T*)ptrs[16], (T*)ptrs[18], (T*)ptrs[20], (T*)ptrs[22]};
  T* db[4] = {(T*)ptrs[17], (T*)ptrs[19], (T*)ptrs[21], (T*)ptrs[23]};
  const long long pstride = DD + D;  // one split's dW and db partials
  const long long pblock = l.splits * pstride;
  const int M = (int)rows;
  constexpr bool kBf16 = pcm::is_bf16<T>::value;

  // q, k, v and dheads = bf16(dO Wo^T)
  PCM_TRY(project_qkv<T>(l, x_qk, x_v, w, bias, qkv));
  if constexpr (kBf16) {
    const mma::Problem p = mma_times_wt(dout, w[3], nullptr, dheads, D);
    PCM_TRY(mma::gemm(&p, 1, M, l.D, l.D, l.stream));
  } else {
    PCM_TRY((gemm<T, T, bf16>(l, {times_wt(dout, w[3], dheads, D)}, M, l.D, l.D)));
  }

  const bf16 *q = qkv, *k = qkv + rows * D, *v = qkv + 2 * rows * D;
  PCM_TRY(l.D / l.H == 64
              ? attention_bwd<64>(l, q, k, v, dheads, heads, dq, dk, dv, stats, dq32, dk32, dv32)
              : attention_bwd<128>(l, q, k, v, dheads, heads, dq, dk, dv, stats, dq32, dk32,
                                   dv32));

  // input gradients: dx_qk = T(bf16(dq) Wq^T + bf16(dk) Wk^T), dx_v = T(bf16(dv) Wv^T);
  // weight gradients as split partials
  if constexpr (kBf16) {
    const mma::Problem gk = mma_times_wt(dk, w[1], nullptr, dxk, D);
    PCM_TRY((mma::gemm<false, mma::kF32>(&gk, 1, M, l.D, l.D, l.stream)));
    const mma::Problem gx[2] = {mma_times_wt(dq, w[0], dxk, dx_qk, D),
                                mma_times_wt(dv, w[2], nullptr, dx_v, D)};
    PCM_TRY((mma::gemm<false, mma::kAddend>(gx, 2, M, l.D, l.D, l.stream)));
    const mma::Problem gw[4] = {mma_xt_times(x_qk, dq, parts, D, pstride),
                                mma_xt_times(x_qk, dk, parts + pblock, D, pstride),
                                mma_xt_times(x_v, dv, parts + 2 * pblock, D, pstride),
                                mma_xt_times(heads, dout, parts + 3 * pblock, D, pstride)};
    PCM_TRY((mma::gemm<true, mma::kF32>(gw, 4, l.D, l.D, M, l.stream, l.splits)));
  } else {
    PCM_TRY((gemm<bf16, T, float>(l, {times_wt(dk, w[1], dxk, D)}, M, l.D, l.D)));
    Gemm gq = times_wt(dq, w[0], dx_qk, D);
    gq.addend = dxk;
    PCM_TRY((gemm<bf16, T, T>(l, {gq, times_wt(dv, w[2], dx_v, D)}, M, l.D, l.D)));
    PCM_TRY((gemm<T, bf16, float>(l,
                                  {xt_times(x_qk, dq, parts, D, pstride),
                                   xt_times(x_qk, dk, parts + pblock, D, pstride),
                                   xt_times(x_v, dv, parts + 2 * pblock, D, pstride)},
                                  l.D, l.D, M, l.splits)));
    PCM_TRY((gemm<bf16, T, float>(l, {xt_times(heads, dout, parts + 3 * pblock, D, pstride)},
                                  l.D, l.D, M, l.splits)));
  }

  // the bias gradients' column sums, then every sum of partials in split order
  PCM_TRY(colsum<float>(l, dq32, parts + DD, pstride));
  PCM_TRY(colsum<float>(l, dk32, parts + pblock + DD, pstride));
  PCM_TRY(colsum<float>(l, dv32, parts + 2 * pblock + DD, pstride));
  PCM_TRY(colsum<T>(l, dout, parts + 3 * pblock + DD, pstride));
  for (int p = 0; p < 4; ++p) {
    PCM_TRY(reduce<T>(l, parts + p * pblock, pstride, DD, dW[p]));
    PCM_TRY(reduce<T>(l, parts + p * pblock + DD, pstride, D, db[p]));
  }
  return cudaSuccess;
}

bool valid(int B, int L, int D, int H, int splits) {
  return B >= 1 && L >= 1 && H >= 1 && D % H == 0 && (D / H == 64 || D / H == 128) &&
         B * H <= 65535 && splits >= 1 && (long long)B * L < (1LL << 31) &&
         ((long long)B * L + 63) / 64 <= 65535;
}

}  // namespace

extern "C" {

// The forward. ptrs: x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, scratch, out.
// x_qk, x_v and out are (B, L, D) row-major, the biases (D,), all of one
// type (f32 if bf16 == 0, else bf16) on device `device`; the weights are
// (D, D) = (D_in, D_out) with the strides in `wstrides` (in, out for wq, wk,
// wv, wo, in elements). scratch is bf16 (4, B, L, D). D / H is 64 or 128;
// scale = (D / H)^-0.5; dropout, threshold, inv_keep and seed as the oneshot
// kernels take them. `splits` is unused. Returns the first cudaError_t.
int pcm_fused_mha_fwd(void* const* ptrs, const long long* wstrides, int B, int L, int D, int H,
                      int splits, float scale, unsigned threshold, float inv_keep,
                      unsigned seed, int dropout, int bf16, int device, void* stream) {
  if (!valid(B, L, D, H, splits)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Launch l{B, L, D, H, splits, scale, threshold, inv_keep, seed, dropout,
                 (cudaStream_t)stream};
  const Weight w[4] = {{ptrs[2], wstrides[0], wstrides[1]},
                       {ptrs[4], wstrides[2], wstrides[3]},
                       {ptrs[6], wstrides[4], wstrides[5]},
                       {ptrs[8], wstrides[6], wstrides[7]}};
  return (int)(bf16 ? fwd<pcm::bf16>(ptrs, w, l) : fwd<float>(ptrs, w, l));
}

// The backward. ptrs: x_qk, x_v, dout, wq, bq, wk, bk, wv, bv, wo, then the
// scratch: bf16 (8, B, L, D), f32 (4, B, L, D), f32 (3, B, H, L), f32
// (4, splits, D*D + D); then the outputs dx_qk, dx_v, dwq, dbq, dwk, dbk,
// dwv, dbv, dwo, dbo (contiguous, of the inputs' type; the weight gradients
// (D_in, D_out)). Other arguments as the forward's; the weight and bias
// gradients sum B*L rows in `splits` ranges, reduced in order.
int pcm_fused_mha_bwd(void* const* ptrs, const long long* wstrides, int B, int L, int D, int H,
                      int splits, float scale, unsigned threshold, float inv_keep,
                      unsigned seed, int dropout, int bf16, int device, void* stream) {
  if (!valid(B, L, D, H, splits)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Launch l{B, L, D, H, splits, scale, threshold, inv_keep, seed, dropout,
                 (cudaStream_t)stream};
  const Weight w[4] = {{ptrs[3], wstrides[0], wstrides[1]},
                       {ptrs[5], wstrides[2], wstrides[3]},
                       {ptrs[7], wstrides[4], wstrides[5]},
                       {ptrs[9], wstrides[6], wstrides[7]}};
  return (int)(bf16 ? bwd<pcm::bf16>(ptrs, w, l) : bwd<float>(ptrs, w, l));
}

}  // extern "C"
