// Exact k-nearest-neighbour query over padded clouds, one thread per query.
//
// Replaces the TPU kernel `_knn3_kernel` / `knn_query_padded_pallas3`
// (pointcloudmatters_tpu/ops/pallas_knn3.py:46-152). Semantics are those of
// `knn_query_padded` (pointcloudmatters_tpu/ops/pointops.py): squared
// distances ascending, exact in f32, clamped at 0; exact ties go to the
// smaller point index; invalid points are skipped; slots a row cannot fill
// hold index -1 and distance 1e10.
//
// What bounds it on an H100: B*M*N distance evaluations (671 M at the
// flagship's B=32, M=2048, N=10240), each a dozen FP32 instructions plus a
// compare against the running k-th distance; the top-k insertions are rare
// after the first few hundred points. The TPU kernel keeps a whole (TM, N)
// distance row in 16 MB of VMEM and extracts k minima by vector reductions;
// that row does not fit a Hopper SM, and Hopper has scalar threads, so the
// design is the classic one instead.
//
// What the design does about it: each thread owns one query and keeps its
// sorted top-K list (distances and indices) in registers, fully unrolled so
// the list never leaves them. The block streams the cloud through shared
// memory in tiles of kTile points in ascending index order (coordinates, the
// squared norm and the validity byte); every thread of the block reads the
// same point at the same time, a broadcast. Because points arrive in index
// order, inserting only on a strictly smaller distance keeps ties at the
// smaller index. Nothing is written to device memory but the k results.
//
// Rounding: the distance is |q|^2 + |p|^2 - 2 (q0 p0 + q1 p1 + q2 p2) with
// __fmul_rn/__fadd_rn/__fsub_rn in the plain version's order, so no FMA
// contraction changes a bit and the kernel is index-exact against its plain
// PyTorch version on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 64;  // threads (queries) a block
constexpr int kTile = 1024;   // points a shared-memory tile
constexpr float kBig = 1.0e10f;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

template <int K>
__global__ void __launch_bounds__(kQueries)
knn_kernel(const float* __restrict__ q, const float* __restrict__ p,
           const uint8_t* __restrict__ mask, int32_t* __restrict__ out_idx,
           float* __restrict__ out_d2, int M, int N, int k) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile], tn[kTile];
  __shared__ uint8_t tv[kTile];

  const int b = blockIdx.y;
  const int m = blockIdx.x * kQueries + threadIdx.x;
  const bool active = m < M;
  const float* pb = p + (size_t)b * N * 3;
  const uint8_t* mb = mask + (size_t)b * N;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + ((size_t)b * M + m) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float q2 = sqnorm(qx, qy, qz);

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = -1;
  }

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int tn_count = min(kTile, N - t0);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < tn_count; j += kQueries) {
      const float x = pb[3 * (t0 + j)], y = pb[3 * (t0 + j) + 1], z = pb[3 * (t0 + j) + 2];
      tx[j] = x;
      ty[j] = y;
      tz[j] = z;
      tn[j] = sqnorm(x, y, z);
      tv[j] = mb[t0 + j];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < tn_count; ++j) {
      if (!tv[j]) continue;
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, tx[j]), __fmul_rn(qy, ty[j])),
                                  __fmul_rn(qz, tz[j]));
      const float d =
          fmaxf(__fsub_rn(__fadd_rn(q2, tn[j]), __fmul_rn(2.0f, dot)), 0.0f);
      if (d < bd[K - 1]) {
        // insert before the first strictly larger entry, then shift the tail
        float cd = d;
        int ci = t0 + j;
        bool shifting = false;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const bool take = shifting || cd < bd[s];
          if (take) {
            const float td = bd[s];
            const int ti = bi[s];
            bd[s] = cd;
            bi[s] = ci;
            cd = td;
            ci = ti;
          }
          shifting = take;
        }
      }
    }
  }

  if (!active) return;
  const size_t o = ((size_t)b * M + m) * k;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      out_d2[o + s] = bd[s];
      out_idx[o + s] = bd[s] >= kBig ? -1 : bi[s];
    }
  }
}

template <int K>
cudaError_t launch(const float* q, const float* p, const uint8_t* mask, int32_t* idx,
                   float* d2, int B, int M, int N, int k, cudaStream_t stream) {
  const dim3 grid((M + kQueries - 1) / kQueries, B);
  knn_kernel<K><<<grid, kQueries, 0, stream>>>(q, p, mask, idx, d2, M, N, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pcm_knn_max_k() { return 64; }

// q (B, M, 3) f32, p (B, N, 3) f32, mask (B, N) bool as bytes; idx (B, M, k)
// int32 and d2 (B, M, k) f32 outputs; all contiguous on device `device`.
// Returns the cudaError_t of the launch.
int pcm_knn(const float* q, const float* p, const uint8_t* mask, int32_t* idx, float* d2,
            int B, int M, int N, int k, int device, void* stream) {
  if (B < 1 || M < 1 || N < 1 || k < 1 || k > 64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // the register list is a compile-time size: the smallest of 4/8/16/32/64
  // that holds k (the top-K prefix of length k is the top-k)
  if (k <= 4) return (int)launch<4>(q, p, mask, idx, d2, B, M, N, k, s);
  if (k <= 8) return (int)launch<8>(q, p, mask, idx, d2, B, M, N, k, s);
  if (k <= 16) return (int)launch<16>(q, p, mask, idx, d2, B, M, N, k, s);
  if (k <= 32) return (int)launch<32>(q, p, mask, idx, d2, B, M, N, k, s);
  return (int)launch<64>(q, p, mask, idx, d2, B, M, N, k, s);
}

}  // extern "C"
