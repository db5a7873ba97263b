// The S = Q K^T product of the f32 attention kernels, three ways, for
// scripts/probe_f32_product.py: each kernel takes the row max of S over every
// key (pass 0 of the flash forward) for q, k of (B H, L, dh) f32, and writes
// the scores of (batch, head) 0 where asked.
//   scheme 0: 3xTF32 on the tensor cores (csrc/f32_mma.cuh, the scheme the f32
//             oneshot backward and flash forward use);
//   scheme 1: TF32 alone (the hi halves only), for its error;
//   scheme 2: the FP32 pipes, each thread an 8 x 8 register tile of a
//             128 x 128 score tile from K-major shared tiles read as float4
//             (the tiling of fused_mha.cu's fp32_gemm_kernel).

#include <cuda_runtime.h>
#include <math.h>

#include "../pointcloudmatters_tpu_torch/csrc/f32_mma.cuh"

namespace {

namespace tx = pcm::tf32x3;
namespace mm = pcm::attn_mma;

template <int DH, bool kThree>
__global__ void __launch_bounds__(tx::kThreads) tc_rowmax(const float* q, const float* k, int L,
                                                          float* mx, float* s_out) {
  constexpr int LD = tx::ld<DH>(), T = tx::kTile, NT = mm::kSub / 8;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Ks = Qs + T * LD;  // two stages
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * T, bh = blockIdx.y;
  const int row = q0 + warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const float* kb = k + (long long)bh * L * DH;
  tx::load_tile<DH>(Qs, q + (long long)bh * L * DH, DH, q0, L, 1);
  tx::load_tile<DH>(Ks, kb, DH, 0, L, 1);
  mm::cp_async_commit();
  const int n_kt = (L + T - 1) / T;
  float m[2] = {-INFINITY, -INFINITY};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) tx::load_tile<DH>(Ks + (st ^ 1) * T * LD, kb, DH, (kt + 1) * T, L, 1);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + st * T * LD;
#pragma unroll 1
    for (int sc = 0; sc < T; sc += mm::kSub) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (kThree) {
        tx::mma_abt<DH, NT>(s, Qs, warp * 16, Kt, sc);
      } else {
#pragma unroll
        for (int kk = 0; kk < DH / 8; ++kk) {
          const tx::Split<4> a = tx::a_frag<DH>(Qs, warp * 16, kk);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const tx::Split<2> b = tx::b_frag<DH>(Kt, sc + 8 * j, kk);
            tx::mma(s[j], a.hi, b.hi[0], b.hi[1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + (e >> 1) * 8, c = kt * T + sc + 8 * j + cq + (e & 1);
          if (c < L) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
          if (s_out != nullptr && bh == 0 && r < L && c < L) s_out[(long long)r * L + c] = s[j][e];
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    if ((lane & 3) == 0 && row + 8 * i < L) mx[(long long)bh * L + row + 8 * i] = m[i];
  }
}

constexpr int kPT = 128, kPThreads = 256, kPLd = kPT + 4;

// rows r0 .. r0 + 127 of x (DH wide) into a K-major tile S[d][r], zero past L
template <int DH>
__device__ __forceinline__ void load_kmajor(float* S, const float* x, int r0, int L) {
  for (int i = threadIdx.x; i < kPT * DH / 4; i += kPThreads) {
    const int r = i / (DH / 4), d = (i % (DH / 4)) * 4;
    const float4 v = r0 + r < L ? *reinterpret_cast<const float4*>(x + (long long)(r0 + r) * DH + d)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    S[(d + 0) * kPLd + r] = v.x;
    S[(d + 1) * kPLd + r] = v.y;
    S[(d + 2) * kPLd + r] = v.z;
    S[(d + 3) * kPLd + r] = v.w;
  }
}

template <int DH>
__global__ void __launch_bounds__(kPThreads) fp32_rowmax(const float* q, const float* k, int L,
                                                         float* mx, float* s_out) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;
  float* Kt = Qt + DH * kPLd;
  const int tx_ = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kPT, bh = blockIdx.y;
  const float* kb = k + (long long)bh * L * DH;
  load_kmajor<DH>(Qt, q + (long long)bh * L * DH, q0, L);
  float m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = -INFINITY;
  for (int k0 = 0; k0 < L; k0 += kPT) {
    __syncthreads();  // the previous K tile is consumed
    load_kmajor<DH>(Kt, kb, k0, L);
    __syncthreads();
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 a0 = *reinterpret_cast<const float4*>(Qt + d * kPLd + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(Qt + d * kPLd + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Kt + d * kPLd + 4 * tx_);
      const float4 b1 = *reinterpret_cast<const float4*>(Kt + d * kPLd + 64 + 4 * tx_);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = q0 + (i >> 2) * 64 + 4 * ty + (i & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = k0 + (j >> 2) * 64 + 4 * tx_ + (j & 3);
        if (c < L) m[i] = fmaxf(m[i], acc[i][j]);
        if (s_out != nullptr && bh == 0 && r < L && c < L) s_out[(long long)r * L + c] = acc[i][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
    const int r = q0 + (i >> 2) * 64 + 4 * ty + (i & 3);
    if (tx_ == 0 && r < L) mx[(long long)bh * L + r] = m[i];
  }
}

template <int DH>
cudaError_t launch(int scheme, const float* q, const float* k, int BH, int L, float* mx,
                   float* s_out, cudaStream_t s) {
  void (*kernel)(const float*, const float*, int, float*, float*) =
      scheme == 0 ? tc_rowmax<DH, true> : scheme == 1 ? tc_rowmax<DH, false> : fp32_rowmax<DH>;
  const bool tc = scheme != 2;
  const size_t smem = tc ? 3 * tx::tile_bytes<DH>() : 2 * (size_t)DH * kPLd * sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = tc ? tx::kTile : kPT;
  kernel<<<dim3((L + rows - 1) / rows, BH), tc ? tx::kThreads : kPThreads, smem, s>>>(
      q, k, L, mx, s_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int probe_rowmax(int scheme, const float* q, const float* k, int BH, int L, int dh,
                            float* mx, float* s_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 64) return (int)launch<64>(scheme, q, k, BH, L, mx, s_out, s);
  if (dh == 128) return (int)launch<128>(scheme, q, k, BH, L, mx, s_out, s);
  return (int)cudaErrorInvalidValue;
}
