// Exact k-nearest-neighbour query with chunk skipping: kernel 12 of the
// port, 1 <= k <= 128.
//
// Replaces the TPU kernel `knn_query_padded_pallas2` (pallas_call :138;
// bodies `_knn2_kernel` :65 and `_merge_chunk` :48) of
// pointcloudmatters_tpu/ops/pallas_knn2.py, and follows its traversal: one
// block a (cloud, 128-query tile); the reference cloud in
// tn = min(512, max(N, 128))-point chunks, visited in the ring order c0,
// c0+1, c0-1, c0+2, ... (mod n_chunks) from the tile's home chunk
// c0 = qt * n_chunks / n_tiles; a chunk merged into the running k-best only
// when its smallest distance can beat the tile's worst k-th best. Callers
// sort the queries (and the cloud) along a Morton curve, so a tile's first
// chunks fill its k-best and the distant chunks skip; the result is exact
// on any order. Semantics: squared distances ascending, clamped at 0,
// invalid points skipped, index -1 and distance 1e10 where a row runs
// short. Exact ties go to the smaller index (the TPU leaves their order
// unspecified): the list orders by (distance, index), and a chunk is
// skipped only when its minimum is strictly greater than the tile's worst
// k-th best (the TPU skips at >=), since a point at that distance with a
// smaller index still enters.
//
// What bounds it on an H100: the distance evaluations, B*M*N at most (each
// a dozen FP32 instructions), fewer when chunks skip: a skipped chunk costs
// one pass of distances and two block reductions, a merged one two passes
// (the minimum, then the insertions).
//
// What the design does about it: the chunk is staged in shared memory
// (512 x (x, y, z, |p|^2, valid), 8.5 KiB) and every thread, one a query,
// reads the same point at the same time, a broadcast. The early-out is a
// block-wide decision: the chunk's minimum distance over the tile's rows
// and the largest k-th best of those rows are reduced across the block
// (warp shuffles, then one value a warp), and the insertion pass runs only
// when the minimum does not exceed it. Recomputing the distances there is
// cheaper than staging a 128 x 512 tile. The per-query list is
// knn_topk.cuh's. Thread 0 adds the block's skipped chunks to an optional
// device counter. The distance is pcm_topk::dist2, bit for bit that of
// knn.cu and of the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "knn_topk.cuh"

namespace {

constexpr int kQueries = 128;  // threads (queries) a block: the TPU's tile
constexpr int kChunk = 512;    // the TPU's reference chunk, at most
constexpr int kWarps = kQueries / 32;

template <class List>
__global__ void __launch_bounds__(kQueries)
knn_chunkskip_kernel(const float* __restrict__ q, const float* __restrict__ p,
                     const uint8_t* __restrict__ mask, int32_t* __restrict__ out_idx,
                     float* __restrict__ out_d2, int M, int N, int k, int tn, int n_chunks,
                     int* __restrict__ skipped) {
  __shared__ float cx[kChunk], cy[kChunk], cz[kChunk], cn[kChunk];
  __shared__ uint8_t cv[kChunk];
  __shared__ float warp_min[kWarps], warp_max[kWarps];
  extern __shared__ __align__(16) unsigned char list_smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, qt = blockIdx.x, n_tiles = gridDim.x;
  const int m = qt * kQueries + tid;
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

  const int c0 = (int)(((long long)qt * n_chunks) / n_tiles);  // the home chunk
  int n_skipped = 0;
  for (int j = 0; j < n_chunks; ++j) {
    const int off = (j + 1) / 2;
    const int c = (c0 + ((j & 1) ? off : -off) + n_chunks) % n_chunks;
    const int base = c * tn;
    const int cnt = min(tn, N - base);  // the rest of the last chunk is padding
    __syncthreads();  // the previous chunk and reduction are consumed
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

    // the row's smallest distance over the chunk (1e10 if it holds no valid
    // point), and its k-th best (not the list's K-th, so that a k below K
    // skips the chunks the plain version skips); rows past M take part in
    // neither
    float rmin = active ? pcm_topk::kBig : INFINITY;
    if (active)
      for (int jj = 0; jj < cnt; ++jj)
        if (cv[jj])
          rmin = fminf(rmin, pcm_topk::dist2(qx, qy, qz, q2, cx[jj], cy[jj], cz[jj], cn[jj]));
    float tau = active ? list.kth(k) : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      rmin = fminf(rmin, __shfl_xor_sync(0xffffffffu, rmin, o));
      tau = fmaxf(tau, __shfl_xor_sync(0xffffffffu, tau, o));
    }
    if (lane == 0) {
      warp_min[warp] = rmin;
      warp_max[warp] = tau;
    }
    __syncthreads();
    float chunk_min = warp_min[0], tile_tau = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      chunk_min = fminf(chunk_min, warp_min[w]);
      tile_tau = fmaxf(tile_tau, warp_max[w]);
    }
    if (chunk_min > tile_tau) {  // no row of the tile can take a point
      ++n_skipped;
      continue;
    }
    if (active)
      for (int jj = 0; jj < cnt; ++jj)
        if (cv[jj])
          list.push(pcm_topk::dist2(qx, qy, qz, q2, cx[jj], cy[jj], cz[jj], cn[jj]), base + jj);
  }

  if (tid == 0 && skipped != nullptr) atomicAdd(skipped, n_skipped);
  if (!active) return;
  const size_t o = ((size_t)b * M + m) * k;
  list.store(out_idx + o, out_d2 + o, k);
}

template <class List>
cudaError_t launch(const float* q, const float* p, const uint8_t* mask, int32_t* idx,
                   float* d2, int* skipped, int B, int M, int N, int k, cudaStream_t stream) {
  const size_t smem = List::smem_bytes(kQueries);
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_chunkskip_kernel<List>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int tn = std::min(kChunk, std::max(N, 128));
  const int n_chunks = (N + tn - 1) / tn;
  const dim3 grid((M + kQueries - 1) / kQueries, B);
  knn_chunkskip_kernel<List><<<grid, kQueries, smem, stream>>>(q, p, mask, idx, d2, M, N, k,
                                                               tn, n_chunks, skipped);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, M, 3) f32, p (B, N, 3) f32, mask (B, N) bool as bytes; idx (B, M, k)
// int32 and d2 (B, M, k) f32 outputs; all contiguous on device `device`;
// 1 <= k <= 128. `skipped`: null, or one int32 on the device to which the
// launch adds the number of (tile, chunk) pairs it skipped. Returns the
// cudaError_t of the launch.
int pcm_knn_chunkskip(const float* q, const float* p, const uint8_t* mask, int32_t* idx,
                      float* d2, int* skipped, int B, int M, int N, int k, int device,
                      void* stream) {
  if (B < 1 || M < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)pcm_topk::with_list(k, [&](auto tag) {
    return launch<typename decltype(tag)::type>(q, p, mask, idx, d2, skipped, B, M, N, k, s);
  });
}

}  // extern "C"
