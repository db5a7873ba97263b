// Exact k-nearest-neighbour query by a dense scan: kernel 13 of the port,
// 1 <= k <= 128.
//
// Replaces the TPU kernel `knn_query_padded_pallas` (pallas_call :108;
// bodies `_knn_kernel` :49 and `_extract_k` :35) of
// pointcloudmatters_tpu/ops/pallas_knn.py, and follows its traversal: one
// block a (cloud, 128-query tile); the whole reference cloud in
// tn = min(2048, max(N, 128))-point chunks in index order, each merged into
// the running k-best. Semantics: squared distances ascending, clamped at 0,
// invalid points skipped, index -1 and distance 1e10 where a row runs
// short, exact ties to the smaller index (the TPU's first argmin over
// [k-best, chunk] gives the same).
//
// What bounds it on an H100: B*M*N distance evaluations, each a dozen FP32
// instructions plus a compare against the running k-th distance; no chunk
// is skipped. The TPU kernel extracts the k minima of every (tile, chunk)
// pair by k vector reductions over a (128, k + 2048) tile, which is most of
// its time; a Hopper thread instead inserts into a sorted list, rarely once
// the list is full.
//
// What the design does about it: the chunk is staged in shared memory
// (2048 x (x, y, z, |p|^2, valid), 34 KiB) and every thread, one a query,
// reads the same point at the same time, a broadcast. Points arrive in
// index order, so a point enters only on a strictly smaller distance and
// ties stay with the smaller index. The per-query list is knn_topk.cuh's;
// the distance is pcm_topk::dist2, bit for bit that of knn.cu and of the
// plain version. Nothing is written to device memory but the k results.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "knn_topk.cuh"

namespace {

constexpr int kQueries = 128;  // threads (queries) a block: the TPU's tile
constexpr int kChunk = 2048;   // the TPU's reference chunk, at most

template <class List>
__global__ void __launch_bounds__(kQueries)
knn_baseline_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    const uint8_t* __restrict__ mask, int32_t* __restrict__ out_idx,
                    float* __restrict__ out_d2, int M, int N, int k, int tn) {
  __shared__ float cx[kChunk], cy[kChunk], cz[kChunk], cn[kChunk];
  __shared__ uint8_t cv[kChunk];
  extern __shared__ __align__(16) unsigned char list_smem[];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int m = blockIdx.x * kQueries + tid;
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
  list.init(list_smem, tid, kQueries);

  for (int base = 0; base < N; base += tn) {
    const int cnt = min(tn, N - base);
    __syncthreads();  // the previous chunk is consumed
    for (int jj = tid; jj < cnt; jj += kQueries) {
      const float x = pb[3 * (base + jj)], y = pb[3 * (base + jj) + 1],
                  z = pb[3 * (base + jj) + 2];
      cx[jj] = x;
      cy[jj] = y;
      cz[jj] = z;
      cn[jj] = pcm_topk::sqnorm(x, y, z);
      cv[jj] = mb[base + jj];
    }
    __syncthreads();
    if (!active) continue;
    for (int jj = 0; jj < cnt; ++jj) {
      if (!cv[jj]) continue;
      const float d = pcm_topk::dist2(qx, qy, qz, q2, cx[jj], cy[jj], cz[jj], cn[jj]);
      list.push_after(d, base + jj);
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
        knn_baseline_kernel<List>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int tn = std::min(kChunk, std::max(N, 128));
  const dim3 grid((M + kQueries - 1) / kQueries, B);
  knn_baseline_kernel<List><<<grid, kQueries, smem, stream>>>(q, p, mask, idx, d2, M, N, k, tn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, M, 3) f32, p (B, N, 3) f32, mask (B, N) bool as bytes; idx (B, M, k)
// int32 and d2 (B, M, k) f32 outputs; all contiguous on device `device`;
// 1 <= k <= 128. Returns the cudaError_t of the launch.
int pcm_knn_baseline(const float* q, const float* p, const uint8_t* mask, int32_t* idx,
                     float* d2, int B, int M, int N, int k, int device, void* stream) {
  if (B < 1 || M < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)pcm_topk::with_list(k, [&](auto tag) {
    return launch<typename decltype(tag)::type>(q, p, mask, idx, d2, B, M, N, k, s);
  });
}

}  // extern "C"
