// Exact k-nearest-neighbour query over padded clouds, one thread per query,
// 1 <= k <= 128.
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
// sorted top-K list (knn_topk.cuh: in registers up to K = 64, fully
// unrolled so the list never leaves them; in a shared-memory column above).
// The block streams the cloud through shared memory in tiles of kTile
// points in ascending index order (coordinates, the squared norm and the
// validity byte); every thread of the block reads the same point at the
// same time, a broadcast. Nothing is written to device memory but the k
// results.
//
// Rounding: the distance is pcm_topk::dist2, the plain version's expression
// with round-to-nearest intrinsics, so the kernel is index-exact against
// its plain PyTorch version on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_topk.cuh"

namespace {

using pcm_topk::kBig;

constexpr int kQueries = 64;  // threads (queries) a block
constexpr int kTile = 1024;   // points a shared-memory tile

template <class List>
__global__ void __launch_bounds__(kQueries)
knn_kernel(const float* __restrict__ q, const float* __restrict__ p,
           const uint8_t* __restrict__ mask, int32_t* __restrict__ out_idx,
           float* __restrict__ out_d2, int M, int N, int k) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile], tn[kTile];
  __shared__ uint8_t tv[kTile];
  extern __shared__ __align__(16) unsigned char list_smem[];

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
  const float q2 = pcm_topk::sqnorm(qx, qy, qz);
  List list;
  list.init(list_smem, threadIdx.x, kQueries);

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int tn_count = min(kTile, N - t0);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < tn_count; j += kQueries) {
      const float x = pb[3 * (t0 + j)], y = pb[3 * (t0 + j) + 1], z = pb[3 * (t0 + j) + 2];
      tx[j] = x;
      ty[j] = y;
      tz[j] = z;
      tn[j] = pcm_topk::sqnorm(x, y, z);
      tv[j] = mb[t0 + j];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < tn_count; ++j) {
      if (!tv[j]) continue;
      const float d = pcm_topk::dist2(qx, qy, qz, q2, tx[j], ty[j], tz[j], tn[j]);
      list.push_after(d, t0 + j);  // points arrive in index order
    }
  }

  if (!active) return;
  const size_t o = ((size_t)b * M + m) * k;
  list.store(out_idx + o, out_d2 + o, k);
}

template <class List>
cudaError_t launch(const float* q, const float* p, const uint8_t* mask, int32_t* idx,
                   float* d2, int B, int M, int N, int k, cudaStream_t stream) {
  const size_t smem = List::smem_bytes(kQueries);
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_kernel<List>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((M + kQueries - 1) / kQueries, B);
  knn_kernel<List><<<grid, kQueries, smem, stream>>>(q, p, mask, idx, d2, M, N, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pcm_knn_max_k() { return pcm_topk::kMaxK; }

// q (B, M, 3) f32, p (B, N, 3) f32, mask (B, N) bool as bytes; idx (B, M, k)
// int32 and d2 (B, M, k) f32 outputs; all contiguous on device `device`;
// 1 <= k <= pcm_knn_max_k(). Returns the cudaError_t of the launch.
int pcm_knn(const float* q, const float* p, const uint8_t* mask, int32_t* idx, float* d2,
            int B, int M, int N, int k, int device, void* stream) {
  if (B < 1 || M < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)pcm_topk::with_list(k, [&](auto tag) {
    return launch<typename decltype(tag)::type>(q, p, mask, idx, d2, B, M, N, k, s);
  });
}

}  // extern "C"
