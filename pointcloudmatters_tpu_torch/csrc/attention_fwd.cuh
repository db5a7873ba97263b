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
// layer at B=32, H=8, L=2051, dh=64) on the FP32 pipes: the products are f32
// FMAs, which TF32 would round. The TPU kernel holds a whole f32 score row
// (64 queries x 2176 keys x 4 B = 557 KB), which does not fit the 227 KB of
// shared memory a Hopper block may use.
//
// What the design does about it: the score row never exists. A block keeps
// its 64 scaled query rows in shared memory and streams K and V in tiles of
// 64 keys; each of its 256 threads computes a 4x4 register tile of the 64x64
// scores, each warp folds 8 score rows into the row max m and sum l with an
// online max (expf, not __expf, for parity), and each thread accumulates a
// 4 x dh/16 register tile of the output, rescaled by exp(m_old - m_new).
// Shared arrays that threads read along a key or query row are padded by one
// float, so the reads are free of bank conflicts. Key tiles past l_actual
// are not visited; rows beyond the array are zero-filled. Output = acc *
// (1 / l), as the TPU kernel does. Dropout is one more pass over the 64x64
// probability tile in shared memory, after the row sums and before P V:
// each thread draws one Philox call for four neighbouring key columns (about
// 30 integer operations an element against 2 dh FMAs).
//
// Strides are passed for q, k, v and o (batch, head, row; the last axis must
// be contiguous), so (B, L, H, dh) projections are read in place.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace pcm {
namespace attn {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1.0e30f;  // NEG_INF of the TPU kernel

struct Strides {
  long long b, h, l;
};

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (DH + 1) + (size_t)kBK * (DH + 1) + (size_t)kBK * DH +
         (size_t)kBQ * (kBK + 1) + 2 * kBQ;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ row_max, float* __restrict__ row_inv, Strides qs,
                Strides ks, Strides vs, Strides os, int H, int Lq, int Lk, int l_actual,
                float scale, uint32_t threshold, float inv_keep, uint32_t seed,
                int dropout) {
  constexpr int LD = DH + 1;   // padded row of Q and K tiles
  constexpr int LDP = kBK + 1; // padded row of the score tile
  constexpr int CJ = DH / 16;  // output columns a thread
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * DH;
  float* row_alpha = Ps + kBQ * LDP;
  float* row_l = row_alpha + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 16 x 16 thread grid
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    Qs[r * LD + c] = q0 + r < Lq ? __fmul_rn(qb[(q0 + r) * qs.l + c], scale) : 0.f;
  }

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

  const int n_kt = (l_actual + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int r = e / DH, c = e % DH;
      const bool in = k0 + r < Lk;
      Ks[r * LD + c] = in ? kb[(k0 + r) * ks.l + c] : 0.f;
      Vs[r * DH + c] = in ? vb[(k0 + r) * vs.l + c] : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, key columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = col < l_actual ? s[i][j] : kNegInf;
      }
    __syncthreads();

    // softmax rows: warp w folds rows 8w .. 8w+7, two columns a lane
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const float s0 = Ps[r * LDP + lane], s1 = Ps[r * LDP + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[rr], mx);
      const float alpha = expf(m_run[rr] - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[rr] = l_run[rr] * alpha + sum;
      m_run[rr] = m_new;
      Ps[r * LDP + lane] = p0;
      Ps[r * LDP + lane + 32] = p1;
      if (lane == 0) row_alpha[r] = alpha;
    }
    __syncthreads();

    if (dropout) {  // P <- keep ? P / (1 - rate) : 0, four columns a draw
      for (int gi = tid; gi < kBQ * (kBK / 4); gi += kThreads) {
        const int r = gi / (kBK / 4), c4 = (gi % (kBK / 4)) * 4;
        const uint4 bits = pcm::keep_bits4(seed, h, q0 + r, (k0 + c4) >> 2);
        float* pr = Ps + r * LDP + c4;
        pr[0] = bits.x >= threshold ? pr[0] * inv_keep : 0.f;
        pr[1] = bits.y >= threshold ? pr[1] * inv_keep : 0.f;
        pr[2] = bits.z >= threshold ? pr[2] * inv_keep : 0.f;
        pr[3] = bits.w >= threshold ? pr[3] * inv_keep : 0.f;
      }
      __syncthreads();
    }

    // acc = alpha * acc + P V
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

  __syncthreads();  // the last tile's row_alpha is read; it now holds the row max
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      row_l[warp * 8 + rr] = l_run[rr];
      row_alpha[warp * 8 + rr] = m_run[rr];  // the final row max
    }
  }
  __syncthreads();
  if (row_max != nullptr) {
    const long long base = (long long)blockIdx.y * Lq + q0;
    for (int r = tid; r < kBQ && q0 + r < Lq; r += kThreads) {
      row_max[base + r] = row_alpha[r];
      row_inv[base + r] = 1.0f / row_l[r];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Lq) continue;
    const float inv = 1.0f / row_l[r];
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      ob[(q0 + r) * os.l + tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* row_max,
                   float* row_inv, Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int H, int Lq, int Lk, int l_actual, float scale, uint32_t threshold,
                   float inv_keep, uint32_t seed, int dropout, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBQ - 1) / kBQ, B * H);
  attn_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, row_max, row_inv, qs, ks,
      vs, os, H, Lq, Lk, l_actual, scale, threshold, inv_keep, seed, dropout);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace pcm
