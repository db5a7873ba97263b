// Exact softmax attention forward in f32, one block per (batch, head,
// 64-query tile), streaming 64-key tiles: the f32 instance of kernel 3. Its
// C entry is attention_fwd.cu, which sends bf16 to the tensor-core kernel of
// attention_mma.cuh.
//
// Replaces the forward of the TPU kernel `_fwd_kernel` / `oneshot_attention`
// (pointcloudmatters_tpu/ops/oneshot_attention.py:68-94, 176-230). Semantics:
// q is scaled by `scale` (as the TPU path pre-scales q), keys at column
// l_actual and beyond are masked out (`col < l_actual`,
// oneshot_attention.py:82-83), o = (e_drop v) / sum(e) with e = exp(s - max
// s) and f32 accumulation. At dropout rate > 0, e_drop = keep ? e / (1 -
// rate) : 0 with the keep mask of philox.cuh (one per head, shared across
// the batch); the denominator stays the undropped sum, as in the TPU kernel
// (oneshot_attention.py:85-94). For the backward the kernel can also write
// each row's max and 1 / denominator, (B, H, Lq) f32 each.
//
// What bounds it on an H100: arithmetic. 4*B*H*Lq*Lk*dh flops (275 GFLOP a
// layer at B=32, H=8, L=2051, dh=64), which TF32 alone would round: every
// product runs on the TF32 tensor cores in 3xTF32 (f32_mma.cuh: exact-f32
// products from three TF32 mmas, each k step's sum added to the f32
// accumulator rounding to nearest). The TPU kernel holds a whole f32 score
// row (64 queries x 2176 keys x 4 B = 557 KB), which does not fit the 227 KB
// of shared memory a Hopper block may use.
//
// What the design does about it: the score row never exists, and each key
// is visited once (a single pass with an online softmax; the backward, f32
// kernel 4, recomputes p from the row max and 1 / l written here). A block
// is 4 warps x 16 query rows; it holds its 64 rows of q * scale in an f32
// tile and streams K and V tiles of 64 keys by cp.async into two-stage
// rings (plain loads for views whose rows are not 16-byte aligned), up to
// l_actual. For each key tile a warp takes S = (q scale) K^T into C
// fragments (its 16 rows x 64 keys), sets keys at l_actual and beyond to
// -1e30, and folds the tile into its rows' running max m and sum l, kept in
// registers and reduced over the four lanes of a row by shuffles: m_new =
// max(m, rowmax(S)), e = expf(s - m_new), l <- l exp(m - m_new) + rowsum(e),
// acc <- acc exp(m - m_new). Dropout draws the keep bits in the C-fragment
// layout (attention_mma.cuh `keep_rows`: one Philox call for four
// neighbouring key columns, shared by a lane pair), e_drop = keep ? e
// inv_keep : 0, and the C fragments of e_drop are the A fragments of
// acc += e_drop V (f32_mma.cuh's k permutation): P never goes through shared
// memory. Output = acc * (1 / l), as the TPU kernel does. A key tile costs
// two barriers: one after its cp.async wait, so that every thread's copies
// have landed, and one after P V, so that its stage is consumed before it
// is refilled. Every warp splits the fragments it multiplies into their
// TF32 halves itself: splitting q once a block, or q, K and V once a block
// of 8 warps, measured slower on the card (PERF.md).
//
// Strides are passed for q, k, v and o (batch, head, row; the last axis must
// be contiguous), so (B, L, H, dh) projections are read in place.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "f32_mma.cuh"
#include "philox.cuh"

namespace pcm {
namespace attn {

namespace mm = attn_mma;
namespace tx = tf32x3;

constexpr float kNegInf = -1.0e30f;  // NEG_INF of the TPU kernel

using Strides = mm::Strides;

struct Args {
  const float *q, *k, *v;
  float* o;
  float *row_max, *row_inv;  // both null when the statistics are not needed
  Strides qs, ks, vs, os;
  int H, Lq, Lk, l_actual;
  float scale;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int dropout;
};

// The query rows of a block (16 a warp), and the f32 tiles of shared
// memory: q, two stages of K and V.
constexpr int kBlockRows = tx::kTile;
constexpr int kBlockThreads = 2 * kBlockRows;

template <int DH>
constexpr size_t smem_bytes() {
  return 5 * tx::tile_bytes<DH>();
}

// Rows r0 .. r0 + ROWS - 1 of g (row stride ls) into f32 tile rows, zero at
// rows >= n, NTH threads: by cp.async with `vec`, else by plain loads (as
// f32_mma.cuh's load_tile).
template <int DH, int ROWS, int NTH>
__device__ __forceinline__ void load_rows(float* sm, const float* g, long long ls, int r0,
                                          int n, int vec) {
  constexpr int CH = DH / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTH) {
    const int r = i / CH, c = (i % CH) * 4;
    float* dst = sm + tx::at<DH>(r, c);
    const bool in = r0 + r < n;
    const float* src = in ? g + (long long)(r0 + r) * ls + c : g;
    if (vec) {
      mm::cp_async16(dst, src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = in ? src[e] : 0.f;
    }
  }
}

// The ROWS-row tile `t` times `scale` (scale != 1), rounded, over the chunks
// of thread threadIdx.x of NTH (each its own after its cp.async wait).
template <int DH, int ROWS, int NTH>
__device__ __forceinline__ void scale_tile(float* t, float scale) {
  constexpr int CH = DH / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTH) {
    const int o = tx::at<DH>(i / CH, (i % CH) * 4);
    float4 x = *reinterpret_cast<float4*>(t + o);
    if (scale != 1.f) x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                                      __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
    *reinterpret_cast<float4*>(t + o) = x;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// `vec`: q, k and v rows 16-byte aligned (tiles stream by cp.async).
template <int DH>
__global__ void __launch_bounds__(kBlockThreads, DH == 64 ? 2 : 1)
attn_fwd_kernel(Args a, int vec) {
  constexpr int LD = tx::ld<DH>(), T = tx::kTile, NT = T / 8;  // 8-key score tiles
  constexpr int R = kBlockRows, NTH = kBlockThreads;
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;
  float* KVs = Qs + R * LD;  // stage st: K, V
  auto ktile = [&](int st) { return KVs + (2 * st + 0) * T * LD; };
  auto vtile = [&](int st) { return KVs + (2 * st + 1) * T * LD; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * R;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const float* kb = a.k + b * a.ks.b + h * a.ks.h;
  const float* vb = a.v + b * a.vs.b + h * a.vs.h;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int cq = 2 * (lane & 3);
  auto load_kv = [&](int st, int k0) {
    load_rows<DH, T, NTH>(ktile(st), kb, a.ks.l, k0, a.Lk, vec);
    load_rows<DH, T, NTH>(vtile(st), vb, a.vs.l, k0, a.Lk, vec);
  };

  load_rows<DH, R, NTH>(Qs, a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, vec);
  mm::cp_async_commit();
  load_kv(0, 0);
  mm::cp_async_commit();
  mm::cp_async_wait<1>();
  scale_tile<DH, R, NTH>(Qs, a.scale);  // q -> q * scale, rounded

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows row, row + 8

  const int n_kt = (a.l_actual + T - 1) / T;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) load_kv(st ^ 1, (kt + 1) * T);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();  // tile kt has landed, every thread's copies
    const int k0 = kt * T;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    tx::mma_abt<DH, NT>(s, Qs, warp * 16, ktile(st), 0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = k0 + 8 * j + cq;
      if (col >= a.l_actual) s[j][0] = s[j][2] = kNegInf;
      if (col + 1 >= a.l_actual) s[j][1] = s[j][3] = kNegInf;
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_run[i], quad_max(mx[i]));
      alpha[i] = expf(m_run[i] - m_new[i]);  // 0 on the first tile
      m_run[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t keep[4];
      if (a.dropout) mm::keep_rows(keep, a.seed, h, row, k0 + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev = expf(s[j][e] - m_new[e >> 1]);
        sum[e >> 1] += ev;
        s[j][e] = !a.dropout ? ev : keep[e] >= a.threshold ? ev * a.inv_keep : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    tx::mma_pv<DH, NT>(acc, s, vtile(st), 0);
    __syncthreads();  // stage st is consumed before it is refilled
  }

  const float inv[2] = {1.0f / l_run[0], 1.0f / l_run[1]};
  if (a.row_max != nullptr && (lane & 3) == 0) {
    const long long base = (long long)blockIdx.y * a.Lq;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row + 8 * i < a.Lq) {
        a.row_max[base + row + 8 * i] = m_run[i];
        a.row_inv[base + row + 8 * i] = inv[i];
      }
  }
  float* ob = a.o + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e >> 1) * 8;
      if (r < a.Lq) ob[(long long)r * a.os.l + c + (e & 1)] = acc[j][e] * inv[e >> 1];
    }
  }
}

template <int DH>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = tx::rows_aligned(a.q, a.qs) && tx::rows_aligned(a.k, a.ks) &&
                  tx::rows_aligned(a.v, a.vs);
  const dim3 grid((a.Lq + kBlockRows - 1) / kBlockRows, B * a.H);
  attn_fwd_kernel<DH><<<grid, kBlockThreads, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace pcm
