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
// the forward is 17.2 GFLOP of projections and 34.5 of attention, the
// backward ~47 of projection-type products and ~103 of attention as the TPU
// kernel counts them (this design recomputes S three and dP twice more: 11
// L^2 dh products a head against the forward's 3). The forward's attention
// core and, at bf16, its projections and the backward's recomputed q, k, v
// run on the tensor cores (`mma.sync` bf16 -> f32); the rest of the
// backward, and every f32 projection, on the FP32 pipes (f32 FMAs; TF32 or
// bf16 products would round the f32 operands).
//
// What the design does about the TPU kernel's shape. That kernel keeps K, V
// and all eight weight-gradient accumulators in VMEM across a sequential
// (batch, q-tile) grid; Hopper has no sequential grid and 227 KB a block. So
// each product is its own pass, every launch is free of atomics, and every
// sum has a fixed order (two launches are bit-identical):
//
//   - `project_qkv`, the q, k and v projections of both directions, one
//     launch of three problems: at bf16 gemm_mma.cuh's tensor-core GEMM, at
//     f32 `gemm_kernel`; the forward's out projection likewise;
//   - `gemm_kernel`: a tiled f32 FMA GEMM (64x64 tile, 16-deep k steps, 4x4
//     register tile a thread) over strided operands of either type, with a
//     bias, scale and f32-addend epilogue and the output rounded to its type.
//     Up to three problems of one shape share a launch; a long reduction
//     (the weight gradients, B*L rows) is split into `splits` row ranges
//     whose f32 partials `reduce_kernel` sums in split order;
//   - the forward's attention core is bf16 kernel 3's tensor-core forward
//     (attention_mma.cuh, scale 1: q is already scaled and rounded), whose
//     two passes round e against the row's final max;
//   - `bwd_rows_kernel`, a block a (batch, head, 64-query tile): three passes
//     over the key tiles give the row max m; then e, denom, sum(keep dp e)
//     and the recomputed head; then ds and dQ. It writes m, r, u, the head
//     and dq_lin;
//   - `bwd_keys_kernel`, a block a (batch, head, 64-key tile): one pass over
//     the query tiles with their m, r, u gives dK and dV in registers;
//   - `colsum_kernel` + `reduce_kernel`: the bias gradients in f32.
// In the backward kernels a thread holds a 4x4 tile of the 64x64 scores
// whose four columns are neighbours, so one Philox call gives its keep bits;
// row sums are register partials folded over the 16 lanes of a row at the
// end of a pass.

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
using pcm::round_to;
using pcm::to_f;

constexpr int kThreads = 256;
constexpr int kGM = 64, kGN = 64, kGK = 16;  // GEMM tile
constexpr int kBQ = 64, kBK = 64;            // attention tiles
constexpr int kMaxProblems = 3;

// C = (A B + bias) * scale + addend over an M x N x K problem; element (m,
// k) of A at a[m * a_m + k * a_k], and so on. bias has N values of B's type;
// addend is f32 (M, N) row-major; either may be null. round_a/round_b round
// an f32 operand to bf16 as it is loaded. Split s of a split reduction
// writes its partial at c + s * c_split.
struct Gemm {
  const void* a;
  long long a_m, a_k;
  const void* b;
  long long b_k, b_n;
  const void* bias;
  const float* addend;
  void* c;
  long long c_m, c_n, c_split;
  float scale;
  int round_a, round_b;
};

struct GemmBatch {
  Gemm p[kMaxProblems];
};

template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(GemmBatch batch, int M, int N, int K, int splits, int k_per_split) {
  __shared__ float As[kGK][kGM + 4];
  __shared__ float Bs[kGK][kGN + 4];
  const Gemm p = batch.p[blockIdx.z / splits];
  const int split = blockIdx.z % splits;
  const TA* A = (const TA*)p.a;
  const TB* Bm = (const TB*)p.b;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kGK) {
    // neighbouring threads load along the operand's contiguous axis
    for (int e = tid; e < kGM * kGK; e += kThreads) {
      const int mm = p.a_k == 1 ? e / kGK : e % kGM;
      const int kk = p.a_k == 1 ? e % kGK : e / kGM;
      const int m = m0 + mm, k = k0 + kk;
      float x = 0.f;
      if (m < M && k < k_end) {
        x = to_f(A[m * p.a_m + k * p.a_k]);
        if (p.round_a) x = round_to<bf16>(x);
      }
      As[kk][mm] = x;
    }
    for (int e = tid; e < kGK * kGN; e += kThreads) {
      const int nn = p.b_n == 1 ? e % kGN : e / kGK;
      const int kk = p.b_n == 1 ? e / kGN : e % kGK;
      const int n = n0 + nn, k = k0 + kk;
      float x = 0.f;
      if (n < N && k < k_end) {
        x = to_f(Bm[k * p.b_k + n * p.b_n]);
        if (p.round_b) x = round_to<bf16>(x);
      }
      Bs[kk][nn] = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  TC* C = (TC*)p.c + split * p.c_split;
  const TB* bias = (const TB*)p.bias;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float x = acc[i][j];
      if (bias != nullptr) x += to_f(bias[n]);
      x *= p.scale;
      if (p.addend != nullptr) x += p.addend[(long long)m * N + n];
      C[m * p.c_m + n * p.c_n] = from_f<TC>(x);
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

// The backward's attention operands, (B, L, D) row-major with head h in
// columns h*dh .. h*dh+dh-1.
struct BwdArgs {
  const bf16 *q, *k, *v, *dheads;
  float *row_m, *row_r, *row_u;  // (B, H, L) each
  bf16* heads;
  float *dq, *dk, *dv;
  int H, L, D;
  float scale;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int dropout;
};

// Rows r0.. of head h of a (B, L, D) bf16 tensor into an f32 tile, zero past L.
template <int DH>
__device__ __forceinline__ void load_tile(const bf16* base, int L, int D, int r0, float* t) {
  constexpr int LD = DH + 1;
  for (int e = threadIdx.x; e < 64 * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    t[r * LD + c] = r0 + r < L ? to_f(base[(long long)(r0 + r) * D + c]) : 0.f;
  }
}

// s[i][j] = X[ty+16i] . Y[4tx+j] (and, with Z/W, p[i][j] = Z[ty+16i] . W[4tx+j])
// over DH columns of padded f32 tiles.
template <int DH, bool kTwo>
__device__ __forceinline__ void tile_dots(const float* X, const float* Y, const float* Z,
                                          const float* W, float (&s)[4][4], float (&p)[4][4]) {
  constexpr int LD = DH + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = p[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float x[4], y[4], z[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = X[(ty + 16 * i) * LD + d];
      if (kTwo) z[i] = Z[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = Y[(4 * tx + j) * LD + d];
      if (kTwo) w[j] = W[(4 * tx + j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i], y[j], s[i][j]);
        if (kTwo) p[i][j] = fmaf(z[i], w[j], p[i][j]);
      }
  }
}

// The keep bits of a thread's four neighbouring columns 4tx.. of key tile k0
// in query row `row` (all kept without dropout).
__device__ __forceinline__ void keep4(const BwdArgs& a, int h, int row, int k0, bool (&keep)[4]) {
  if (!a.dropout) {
    keep[0] = keep[1] = keep[2] = keep[3] = true;
    return;
  }
  const uint4 bits = pcm::keep_bits4(a.seed, h, row, (k0 + 4 * (threadIdx.x & 15)) >> 2);
  keep[0] = bits.x >= a.threshold;
  keep[1] = bits.y >= a.threshold;
  keep[2] = bits.z >= a.threshold;
  keep[3] = bits.w >= a.threshold;
}

// Sum (or max) over the 16 lanes that hold one row's columns.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int DH>
constexpr size_t rows_smem_floats() {
  return 4 * (size_t)64 * (DH + 1) + (size_t)64 * (kBK + 1);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) bwd_rows_kernel(BwdArgs a) {
  constexpr int LD = DH + 1, LDP = kBK + 1, CJ = DH / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + 64 * LD;
  float* Ks = dOs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* Ps = Vs + 64 * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const long long off = (long long)b * a.L * a.D + h * DH;
  const int n_kt = (a.L + kBK - 1) / kBK;
  load_tile<DH>(a.q + off, a.L, a.D, q0, Qs);
  load_tile<DH>(a.dheads + off, a.L, a.D, q0, dOs);

  float s[4][4], dp[4][4];
  // pass 1: the row max
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<DH>(a.k + off, a.L, a.D, k0, Ks);
    __syncthreads();
    tile_dots<DH, false>(Qs, Ks, nullptr, nullptr, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + 4 * tx + j < a.L) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = row_max(m[i]);

  // pass 2: denom, sum(keep dp e) and the head
  float l[4] = {0.f, 0.f, 0.f, 0.f}, w[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<DH>(a.k + off, a.L, a.D, k0, Ks);
    load_tile<DH>(a.v + off, a.L, a.D, k0, Vs);
    __syncthreads();
    tile_dots<DH, true>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool keep[4];
      keep4(a, h, q0 + ty + 16 * i, k0, keep);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ed = 0.f;
        if (k0 + 4 * tx + j < a.L) {
          const float e = expf(s[i][j] - m[i]);
          l[i] += e;
          if (keep[j]) {
            w[i] = fmaf(dp[i][j], e, w[i]);
            ed = a.dropout ? e * a.inv_keep : e;
          }
        }
        Ps[(ty + 16 * i) * LDP + 4 * tx + j] = round_to<bf16>(ed);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vv[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
  float r[4], u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = 1.0f / row_sum(l[i]);
    u[i] = r[i] * (row_sum(w[i]) * (a.inv_keep * r[i]));
    const int row = q0 + ty + 16 * i;
    if (row >= a.L) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c)
      a.heads[off + (long long)row * a.D + tx + 16 * c] = from_f<bf16>(acc[i][c] * r[i]);
    if (tx == 0) {
      const long long at = (long long)blockIdx.y * a.L + row;
      a.row_m[at] = m[i];
      a.row_r[at] = r[i];
      a.row_u[at] = u[i];
    }
  }

  // pass 3: ds = bf16(e (z - u)) and dQ = ds K
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<DH>(a.k + off, a.L, a.D, k0, Ks);
    load_tile<DH>(a.v + off, a.L, a.D, k0, Vs);
    __syncthreads();
    tile_dots<DH, true>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool keep[4];
      keep4(a, h, q0 + ty + 16 * i, k0, keep);
      const float zr = a.inv_keep * r[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds = 0.f;
        if (k0 + 4 * tx + j < a.L) {
          const float e = expf(s[i][j] - m[i]);
          const float z = keep[j] ? dp[i][j] * zr : 0.f;
          ds = round_to<bf16>(e * (z - u[i]));
        }
        Ps[(ty + 16 * i) * LDP + 4 * tx + j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float dv[4], kv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kv[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(dv[i], kv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.L) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c)
      a.dq[off + (long long)row * a.D + tx + 16 * c] = acc[i][c] * a.scale;
  }
}

template <int DH>
constexpr size_t keys_smem_floats() {
  return 4 * (size_t)64 * (DH + 1) + 2 * (size_t)64 * (kBK + 1) + 3 * kBQ;
}

template <int DH>
__global__ void __launch_bounds__(kThreads) bwd_keys_kernel(BwdArgs a) {
  constexpr int LD = DH + 1, LDP = kBK + 1, CJ = DH / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + 64 * LD;
  float* Qs = Vs + 64 * LD;
  float* dOs = Qs + 64 * LD;
  float* Ps = dOs + 64 * LD;
  float* dSs = Ps + 64 * LDP;
  float* rm = dSs + 64 * LDP;
  float* rr = rm + kBQ;
  float* ru = rr + kBQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const long long off = (long long)b * a.L * a.D + h * DH;
  load_tile<DH>(a.k + off, a.L, a.D, k0, Ks);
  load_tile<DH>(a.v + off, a.L, a.D, k0, Vs);

  float dk[4][CJ], dv[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (a.L + kBQ - 1) / kBQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous query tile is consumed
    load_tile<DH>(a.q + off, a.L, a.D, q0, Qs);
    load_tile<DH>(a.dheads + off, a.L, a.D, q0, dOs);
    for (int rw = threadIdx.x; rw < kBQ; rw += kThreads) {
      const bool in = q0 + rw < a.L;
      const long long at = (long long)blockIdx.y * a.L + q0 + rw;
      rm[rw] = in ? a.row_m[at] : 0.f;
      rr[rw] = in ? a.row_r[at] : 0.f;
      ru[rw] = in ? a.row_u[at] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<DH, true>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rw = ty + 16 * i;
      bool keep[4];
      keep4(a, h, q0 + rw, k0, keep);
      const float zr = a.inv_keep * rr[rw];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pd = 0.f, ds = 0.f;
        if (q0 + rw < a.L && k0 + 4 * tx + j < a.L) {
          const float e = expf(s[i][j] - rm[rw]);
          const float z = keep[j] ? dp[i][j] * zr : 0.f;
          pd = keep[j] ? e * zr : 0.f;
          ds = e * (z - ru[rw]);
        }
        Ps[rw * LDP + 4 * tx + j] = round_to<bf16>(pd);
        dSs[rw * LDP + 4 * tx + j] = round_to<bf16>(ds);
      }
    }
    __syncthreads();
    // dV += p_drop^T dheads, dK += dS^T Q: key rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float pk[4], sk[4], dov[CJ], qv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = Ps[qq * LDP + ty + 16 * i];
        sk[i] = dSs[qq * LDP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        dov[c] = dOs[qq * LD + tx + 16 * c];
        qv[c] = Qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          dv[i][c] = fmaf(pk[i], dov[c], dv[i][c]);
          dk[i][c] = fmaf(sk[i], qv[c], dk[i][c]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= a.L) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      a.dk[off + (long long)kr * a.D + tx + 16 * c] = dk[i][c];
      a.dv[off + (long long)kr * a.D + tx + 16 * c] = dv[i][c];
    }
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
             long long b_n, void* c, long long c_m, long long c_n) {
  Gemm g{};
  g.a = a;
  g.a_m = a_m;
  g.a_k = a_k;
  g.b = b;
  g.b_k = b_k;
  g.b_n = b_n;
  g.c = c;
  g.c_m = c_m;
  g.c_n = c_n;
  g.scale = 1.f;
  return g;
}

// rows (M, D) x W (D, D), the rows row-major
Gemm times_w(const void* x, const Weight& w, void* c, long long D) {
  return problem(x, D, 1, w.w, w.s_in, w.s_out, c, D, 1);
}

// rows (M, D) x W^T (D, D)
Gemm times_wt(const void* x, const Weight& w, void* c, long long D) {
  return problem(x, D, 1, w.w, w.s_out, w.s_in, c, D, 1);
}

// x^T g over `rows` rows of (rows, D) row-major x and g -> f32 split partials
Gemm xt_times(const void* x, const void* g, float* part, long long D, long long part_stride) {
  Gemm p = problem(x, 1, D, g, D, 1, part, D, 1);
  p.c_split = part_stride;
  return p;
}

template <typename TA, typename TB, typename TC>
cudaError_t gemm(const Launch& l, std::initializer_list<Gemm> probs, int M, int N, int K,
                 int splits = 1) {
  GemmBatch batch{};
  int n = 0;
  for (const Gemm& g : probs) batch.p[n++] = g;
  const int k_per_split = (K + splits - 1) / splits;
  const dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM, n * splits);
  gemm_kernel<TA, TB, TC><<<grid, kThreads, 0, l.stream>>>(batch, M, N, K, splits, k_per_split);
  return cudaGetLastError();
}

// (rows, D) x W (D, D) -> C on the tensor cores (bf16 only)
pcm::gemm_mma::Problem mma_times_w(const bf16* x, const Weight& w, const bf16* bias, bf16* c,
                                   long long D, float scale) {
  return pcm::gemm_mma::problem(x, D, (const bf16*)w.w, w.s_in, w.s_out, bias, c, D, scale);
}

// q, k, v into the bf16 (3, B, L, D) buffer qkv: the forward's and the
// backward's projections, one launch; at bf16 on the tensor cores
// (gemm_mma.cuh), at f32 by the FMA GEMM.
template <typename T>
cudaError_t project_qkv(const Launch& l, const T* x_qk, const T* x_v, const Weight* w,
                        const T* const* bias, bf16* qkv) {
  const long long rows = (long long)l.B * l.L, D = l.D;
  if constexpr (pcm::is_bf16<T>::value) {
    const pcm::gemm_mma::Problem p[3] = {
        mma_times_w(x_qk, w[0], bias[0], qkv, D, l.scale),
        mma_times_w(x_qk, w[1], bias[1], qkv + rows * D, D, 1.f),
        mma_times_w(x_v, w[2], bias[2], qkv + 2 * rows * D, D, 1.f)};
    return pcm::gemm_mma::gemm(p, 3, (int)rows, l.D, l.D, l.stream);
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
    const pcm::gemm_mma::Problem o = mma_times_w(heads, w[3], bias[3], out, D, 1.f);
    return pcm::gemm_mma::gemm(&o, 1, (int)rows, l.D, l.D, l.stream);
  } else {
    Gemm o = times_w(heads, w[3], out, D);
    o.bias = bias[3];
    return gemm<bf16, T, T>(l, {o}, (int)rows, l.D, l.D);
  }
}

template <int DH>
cudaError_t attention_bwd(const Launch& l, const BwdArgs& a) {
  const size_t rows_smem = rows_smem_floats<DH>() * sizeof(float);
  const size_t keys_smem = keys_smem_floats<DH>() * sizeof(float);
  PCM_TRY(cudaFuncSetAttribute(bwd_rows_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)rows_smem));
  PCM_TRY(cudaFuncSetAttribute(bwd_keys_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)keys_smem));
  const dim3 grid((l.L + 63) / 64, l.B * l.H);
  bwd_rows_kernel<DH><<<grid, kThreads, rows_smem, l.stream>>>(a);
  PCM_TRY(cudaGetLastError());
  bwd_keys_kernel<DH><<<grid, kThreads, keys_smem, l.stream>>>(a);
  return cudaGetLastError();
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
  bf16* qkv = (bf16*)ptrs[10];  // q, k, v, dheads, heads
  bf16* dheads = qkv + 3 * rows * D;
  bf16* heads = qkv + 4 * rows * D;
  float* f32s = (float*)ptrs[11];  // dq_lin, dk, dv, dxk
  float *dq = f32s, *dk = f32s + rows * D, *dv = f32s + 2 * rows * D, *dxk = f32s + 3 * rows * D;
  float* stats = (float*)ptrs[12];  // m, r, u: (B, H, L) each
  float* parts = (float*)ptrs[13];  // (4, splits, D*D + D)
  T* dx_qk = (T*)ptrs[14];
  T* dx_v = (T*)ptrs[15];
  T* dW[4] = {(T*)ptrs[16], (T*)ptrs[18], (T*)ptrs[20], (T*)ptrs[22]};
  T* db[4] = {(T*)ptrs[17], (T*)ptrs[19], (T*)ptrs[21], (T*)ptrs[23]};
  const long long pstride = DD + D;  // one split's dW and db partials
  const long long pblock = l.splits * pstride;
  const int M = (int)rows;

  PCM_TRY(project_qkv<T>(l, x_qk, x_v, w, bias, qkv));
  PCM_TRY((gemm<T, T, bf16>(l, {times_wt(dout, w[3], dheads, D)}, M, l.D, l.D)));

  BwdArgs a;
  a.q = qkv;
  a.k = qkv + rows * D;
  a.v = qkv + 2 * rows * D;
  a.dheads = dheads;
  const long long n_stats = (long long)l.B * l.H * l.L;
  a.row_m = stats;
  a.row_r = stats + n_stats;
  a.row_u = stats + 2 * n_stats;
  a.heads = heads;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.H = l.H;
  a.L = l.L;
  a.D = l.D;
  a.scale = l.scale;
  a.threshold = l.threshold;
  a.inv_keep = l.inv_keep;
  a.seed = l.seed;
  a.dropout = l.dropout;
  PCM_TRY(l.D / l.H == 64 ? attention_bwd<64>(l, a) : attention_bwd<128>(l, a));

  // input gradients: dx_qk = T(bf16(dq) Wq^T + bf16(dk) Wk^T), dx_v = T(bf16(dv) Wv^T)
  Gemm gk = times_wt(dk, w[1], dxk, D);
  gk.round_a = 1;
  PCM_TRY((gemm<float, T, float>(l, {gk}, M, l.D, l.D)));
  Gemm gq = times_wt(dq, w[0], dx_qk, D), gv = times_wt(dv, w[2], dx_v, D);
  gq.round_a = gv.round_a = 1;
  gq.addend = dxk;
  PCM_TRY((gemm<float, T, T>(l, {gq, gv}, M, l.D, l.D)));

  // weight gradients as split partials, then the bias gradients' column sums
  Gemm wq = xt_times(x_qk, dq, parts, D, pstride);
  Gemm wk = xt_times(x_qk, dk, parts + pblock, D, pstride);
  Gemm wv = xt_times(x_v, dv, parts + 2 * pblock, D, pstride);
  wq.round_b = wk.round_b = wv.round_b = 1;
  PCM_TRY((gemm<T, float, float>(l, {wq, wk, wv}, l.D, l.D, M, l.splits)));
  PCM_TRY((gemm<bf16, T, float>(l, {xt_times(heads, dout, parts + 3 * pblock, D, pstride)}, l.D,
                                l.D, M, l.splits)));
  PCM_TRY(colsum<float>(l, dq, parts + DD, pstride));
  PCM_TRY(colsum<float>(l, dk, parts + pblock + DD, pstride));
  PCM_TRY(colsum<float>(l, dv, parts + 2 * pblock + DD, pstride));
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
         ((long long)B * L + kGM - 1) / kGM <= 65535;
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
// scratch: bf16 (5, B, L, D), f32 (4, B, L, D), f32 (3, B, H, L), f32
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
