// Exact k-nearest-neighbour query over padded clouds on lane groups,
// 1 <= k <= 128: kernel 2 of the port.
//
// Replaces the TPU kernel `_knn3_kernel` / `knn_query_padded_pallas3`
// (pointcloudmatters_tpu/ops/pallas_knn3.py:46-152). Semantics are those of
// `knn_query_padded` (pointcloudmatters_tpu/ops/pointops.py): squared
// distances ascending, exact in f32, clamped at 0; exact ties go to the
// smaller point index; invalid points are skipped; slots a row cannot fill
// hold index -1 and distance 1e10.
//
// What bounds it on an H100: B*M*N distance evaluations (84 M at B=4,
// M=2048, N=10240), each about a dozen issued instructions (a 16-byte
// shared load, nine round-to-nearest FP32 operations, the compare with the
// row's k-th pair). The TPU kernel keeps a whole (TM, N) distance row in
// 16 MB of VMEM and extracts k minima by vector reductions; that row does
// not fit a Hopper SM. One thread a query left the card nearly empty at
// small batches (32 blocks of 64 threads at B=1).
//
// What the design does about it: a query is served by a group of S lanes
// (csrc/knn_select.cuh), S chosen by the wrapper (ops/knn.py) so that the
// B*M*S/32 warps fill the card; the block's kThreads / S queries stream the
// cloud's records (written once by the pre-pass) through shared memory in
// kTile-point tiles, two stages by cp.async, and every group scans every
// tile, each lane a strided share, queueing the candidates before its row's
// k-th pair and merging when a queue fills. Nothing is written to device
// memory but the records, their indices and the k results.
//
// The visiting order: clouds come sorted along a Morton curve, so in index
// order a query meets points ever nearer to it as the scan approaches its
// place, and nearly every one of them is queued (an emulation of the
// flagship's cloud: 427-867 candidates a query against 126-379). The
// pre-pass therefore writes position j of a cloud as point (j * A) mod N, A
// the odd number nearest N (sqrt(5) - 1) / 2 that is coprime to N, with
// the point's index beside it: each tile is then a sample of the whole
// cloud, and the k-th pair is tight after the first. A lane reads a
// point's index only when its distance does not exceed the k-th's. The
// pair order keeps the result exact on this order as on any.
//
// Rounding: the distance is pcm_topk::dist2, bit for bit the plain
// version's expression and kernels 12's and 13's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_select.cuh"

namespace {

using pcm_select::invalid_record;
using pcm_select::kUnroll;

constexpr int kThreads = 256;  // threads a block: kThreads / S queries
constexpr int kTile = 1024;    // points a shared-memory stage (16 KiB)
constexpr int kRecordChunk = 1024;

// stage a tile of cnt records and their indices (padded with invalid
// records to `span`; the padding's indices are never read)
__device__ __forceinline__ void stage(float4* dst, int* dst_idx, const float4* src,
                                      const int* src_idx, int cnt, int span) {
  for (int j = threadIdx.x; j < span; j += kThreads) {
    if (j < cnt) pcm_select::cp_async16(dst + j, src + j);
    else dst[j] = invalid_record();
  }
  for (int j = threadIdx.x; j < cnt; j += kThreads) pcm_select::cp_async4(dst_idx + j, src_idx + j);
}

template <int S, int R>
__global__ void __launch_bounds__(kThreads)
knn_group_kernel(const float4* __restrict__ rec, const int* __restrict__ rec_idx,
                 const float* __restrict__ q,
                 int32_t* __restrict__ out_idx, float* __restrict__ out_d2, int M, int N, int k) {
  __shared__ __align__(16) float4 tile[2][kTile];
  __shared__ int tile_idx[2][kTile];
  constexpr int kGroups = kThreads / S;
  constexpr int kStep = S * kUnroll;  // tile points a group takes between two votes

  const int tid = threadIdx.x, lane_g = tid % S;
  const int b = blockIdx.y, m = blockIdx.x * kGroups + tid / S;
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
  const int* ib = rec_idx + (size_t)b * N;
  const int n_tiles = (N + kTile - 1) / kTile;
  auto span_of = [](int cnt) { return (cnt + kStep - 1) / kStep * kStep; };
  {
    const int cnt = min(kTile, N);
    stage(tile[0], tile_idx[0], rb, ib, cnt, span_of(cnt));
  }
  pcm_select::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int t1 = (t + 1) * kTile, cnt = min(kTile, N - t1);
      stage(tile[(t + 1) & 1], tile_idx[(t + 1) & 1], rb + t1, ib + t1, cnt, span_of(cnt));
    }
    pcm_select::cp_async_commit();
    pcm_select::cp_async_wait<1>();  // this thread's copies of tile t landed
    __syncthreads();                 // and everyone's
    const float4* tl = tile[t & 1];
    const int* tli = tile_idx[t & 1];
    const int span = span_of(min(kTile, N - t * kTile));
    for (int j = lane_g; j < span; j += kStep) {
      if (sel.must_merge()) sel.merge();
      float d[kUnroll];
      bool near = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 r = tl[j + u * S];
        d[u] = pcm_topk::dist2(qx, qy, qz, q2, r.x, r.y, r.z, r.w);
        near |= d[u] <= sel.td;
      }
      // a uniform branch: most steps of the warp queue nothing, and skip the
      // queue's selects
      if (__any_sync(pcm_select::kFull, near)) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (d[u] <= sel.td) sel.push(d[u], tli[j + u * S]);  // the index only if near
      }
    }
    __syncthreads();  // tile t is consumed before its stage is refilled
  }
  if (__any_sync(pcm_select::kFull, sel.cnt > 0)) sel.merge();

  if (!active) return;
  const size_t o = ((size_t)b * M + m) * k;
  sel.store(out_idx + o, out_d2 + o, k);
}

// the visiting order's multiplier: the odd number nearest N (sqrt(5) - 1) / 2
// that is coprime to N (1 for N <= 2)
int order_multiplier(int N) {
  int a = (int)(N * 0.6180339887498949) | 1;
  auto gcd = [](long long x, long long y) {
    while (y) {
      const long long t = x % y;
      x = y;
      y = t;
    }
    return x;
  };
  while (a > 1 && gcd(a, N) != 1) a += 2;
  return a < N ? a : 1;
}

template <int S, int R>
cudaError_t launch(const float* q, const float* p, const uint8_t* mask, float4* rec,
                   int* rec_idx, int32_t* idx, float* d2, int B, int M, int N, int k,
                   cudaStream_t stream) {
  pcm_select::records_kernel<<<dim3((N + kRecordChunk - 1) / kRecordChunk, B),
                               pcm_select::kRecordThreads, 0, stream>>>(
      p, mask, rec, rec_idx, nullptr, N, kRecordChunk, order_multiplier(N));
  const dim3 grid((M + kThreads / S - 1) / (kThreads / S), B);
  knn_group_kernel<S, R><<<grid, kThreads, 0, stream>>>(rec, rec_idx, q, idx, d2, M, N, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pcm_knn_max_k() { return pcm_topk::kMaxK; }
int pcm_knn_max_rows() { return pcm_select::kMaxRows; }
int pcm_knn_threads() { return kThreads; }
int pcm_knn_order_multiplier(int N) { return order_multiplier(N); }

// q (B, M, 3) f32, p (B, N, 3) f32, mask (B, N) bool as bytes; rec a (B, N)
// float4 scratch and rec_idx a (B, N) int32 scratch; idx (B, M, k) int32
// and d2 (B, M, k) f32 outputs; all contiguous on device `device`; 1 <= k
// <= pcm_knn_max_k(); S, the lanes a query, in {1, 2, 4, 8, 16, 32} with
// the least power of two at or above k at most pcm_knn_max_rows() * S.
// Returns the cudaError_t of the launches.
int pcm_knn(const float* q, const float* p, const uint8_t* mask, void* rec, int* rec_idx,
            int32_t* idx, float* d2, int B, int M, int N, int k, int S, int device,
            void* stream) {
  if (B < 1 || M < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float4* records = static_cast<float4*>(rec);
  return (int)pcm_select::with_shape(S, k, [&](auto shape) {
    using Sh = decltype(shape);
    return launch<Sh::kS, Sh::kR>(q, p, mask, records, rec_idx, idx, d2, B, M, N, k, s);
  });
}

}  // extern "C"
