// Exact k-nearest-neighbour query by a dense scan on lane groups: kernel 13
// of the port, 1 <= k <= 128.
//
// Replaces the TPU kernel `knn_query_padded_pallas` (pallas_call :108;
// bodies `_knn_kernel` :49 and `_extract_k` :35) of
// pointcloudmatters_tpu/ops/pallas_knn.py, and follows its traversal: one
// block a (cloud, query tile); the whole reference cloud in
// tn = min(2048, max(N, 128))-point chunks in index order, none skipped.
// Semantics: squared distances ascending, clamped at 0, invalid points
// skipped, index -1 and distance 1e10 where a row runs short, exact ties to
// the smaller index (the TPU's first argmin over [k-best, chunk] gives the
// same).
//
// What bounds it on an H100: B*M*N distance evaluations, each a dozen
// issued instructions plus a compare against the row's k-th best; at small
// batches, how many warps there are (one thread a query and 128 queries a
// block gave 16 blocks at B=1, M=2048).
//
// What the design does about it: kernel 12's tile loop (knn_chunkskip.cu)
// without its skip test and box pruning, on the selection of
// csrc/knn_select.cuh. Each query is a group of S lanes with per-lane
// queues and bitonic merges over shuffles; a tile of TQ queries is one
// block of TQ * S threads; the wrapper (ops/knn_baseline.py) chooses S and
// TQ by kernel 12's rule, so that the warps fill the card. A pre-pass
// writes each point once as a 16-byte record (invalid points (0, 0, 0,
// +inf), which enter no list); each chunk's records are staged in shared
// memory. The selection is exact on any visiting order (knn_select.cuh);
// the distance is pcm_topk::dist2, bit for bit that of knn.cu, of
// knn_chunkskip.cu and of the plain version. Nothing is written to device
// memory but the records and the k results.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "knn_select.cuh"

namespace {

using pcm_select::invalid_record;
using pcm_select::kFull;
using pcm_select::kUnroll;

constexpr int kChunk = 2048;      // the TPU's reference chunk, at most
constexpr int kMaxTile = 128;     // queries a tile, at most: the TPU's tile
constexpr int kMaxThreads = 256;  // TQ * S, at most

template <int S, int R>
__global__ void __launch_bounds__(kMaxThreads)
knn_baseline_kernel(const float4* __restrict__ rec, const float* __restrict__ q,
                    int32_t* __restrict__ out_idx, float* __restrict__ out_d2, int M, int N,
                    int k, int tq, int tn) {
  __shared__ __align__(16) float4 chunk[kChunk];
  constexpr int kStep = S * kUnroll;

  const int tid = threadIdx.x, lane_g = tid % S;
  const int b = blockIdx.y;
  const int m = blockIdx.x * tq + tid / S;
  const bool active = m < M;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + ((size_t)b * M + m) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float q2 = pcm_topk::sqnorm(qx, qy, qz);
  pcm_select::GroupSelect<S, R> sel;
  sel.init(lane_g, k, active);

  const float4* rb = rec + (size_t)b * N;
  for (int base = 0; base < N; base += tn) {
    const int cnt = min(tn, N - base);
    const int span = (cnt + kStep - 1) / kStep * kStep;  // <= kChunk: kChunk % kStep == 0
    __syncthreads();  // the previous chunk is consumed
    for (int jj = tid; jj < span; jj += blockDim.x)
      chunk[jj] = jj < cnt ? rb[base + jj] : invalid_record();
    __syncthreads();
    for (int jj = lane_g; jj < span; jj += kStep) {
      if (sel.must_merge()) sel.merge();
      float d[kUnroll];
      bool near = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 r = chunk[jj + u * S];
        d[u] = pcm_topk::dist2(qx, qy, qz, q2, r.x, r.y, r.z, r.w);
        near |= d[u] <= sel.td;
      }
      if (__any_sync(kFull, near)) {  // a uniform branch, as in knn.cu
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) sel.push(d[u], base + jj + u * S);
      }
    }
  }
  if (__any_sync(kFull, sel.cnt > 0)) sel.merge();

  if (!active) return;
  const size_t o = ((size_t)b * M + m) * k;
  sel.store(out_idx + o, out_d2 + o, k);
}

template <int S, int R>
cudaError_t launch(const float* q, const float* p, const uint8_t* mask, float4* rec,
                   int32_t* idx, float* d2, int B, int M, int N, int k, int tq,
                   cudaStream_t stream) {
  const int tn = std::min(kChunk, std::max(N, 128));
  pcm_select::records_kernel<<<dim3((N + tn - 1) / tn, B), pcm_select::kRecordThreads, 0,
                               stream>>>(p, mask, rec, nullptr, nullptr, N, tn, 0);
  const dim3 grid((M + tq - 1) / tq, B);
  knn_baseline_kernel<S, R><<<grid, tq * S, 0, stream>>>(rec, q, idx, d2, M, N, k, tq, tn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pcm_knn_baseline_max_tile() { return kMaxTile; }
int pcm_knn_baseline_max_threads() { return kMaxThreads; }

// q (B, M, 3) f32, p (B, N, 3) f32, mask (B, N) bool as bytes; rec a (B, N)
// float4 scratch; idx (B, M, k) int32 and d2 (B, M, k) f32 outputs; all
// contiguous on device `device`; 1 <= k <= 128. S, the lanes a query, as
// pcm_knn takes it; TQ, the queries a tile, a power of two <= 128 with
// 32 <= TQ * S <= 256. Returns the cudaError_t of the launches.
int pcm_knn_baseline(const float* q, const float* p, const uint8_t* mask, void* rec,
                     int32_t* idx, float* d2, int B, int M, int N, int k, int S, int TQ,
                     int device, void* stream) {
  if (B < 1 || M < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (TQ < 1 || TQ > kMaxTile || (TQ & (TQ - 1)) != 0 || TQ * S < 32 || TQ * S > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float4* records = static_cast<float4*>(rec);
  return (int)pcm_select::with_shape(S, k, [&](auto shape) {
    using Sh = decltype(shape);
    return launch<Sh::kS, Sh::kR>(q, p, mask, records, idx, d2, B, M, N, k, TQ, s);
  });
}

}  // extern "C"
