// Exact k-nearest-neighbour query with chunk skipping on lane groups: kernel
// 12 of the port, 1 <= k <= 128.
//
// Replaces the TPU kernel `knn_query_padded_pallas2` (pallas_call :138;
// bodies `_knn2_kernel` :65 and `_merge_chunk` :48) of
// pointcloudmatters_tpu/ops/pallas_knn2.py, and follows its traversal: one
// block a (cloud, query tile) of TQ queries; the reference cloud in
// tn = min(512, max(N, 128))-point chunks, visited in the ring order c0,
// c0+1, c0-1, c0+2, ... (mod n_chunks) from the tile's home chunk
// c0 = qt * n_chunks / n_tiles; a chunk skipped when its smallest distance
// over the tile's rows is strictly greater than the largest k-th best of
// those rows (the TPU skips at >=; a point at that distance with a smaller
// index must still enter). Callers sort the queries along a Morton curve,
// so a tile's first chunks fill its k-best and distant chunks skip; the
// result is exact on any order. Semantics: squared distances ascending,
// clamped at 0, invalid points skipped, index -1 and distance 1e10 where a
// row runs short, exact ties to the smaller index.
//
// What bounds it on an H100: the distance evaluations of the chunks that
// are not skipped (each a dozen issued instructions); at small batches, how
// many blocks there are (one a tile: 16 at B=1, M=2048 with the TPU's
// 128-query tile).
//
// What the design does about it:
//   - Each query is a lane group (csrc/knn_select.cuh); the wrapper
//     (ops/knn_chunkskip.py) chooses S so that the warps fill the card, and
//     the tile TQ, a power of two <= 128, so that the B * ceil(M / TQ)
//     blocks do; the plain version takes the same TQ (`tm`).
//   - One pass a chunk. The TPU computes the chunk's minimum, then merges
//     (k extractions). Here every lane queues, in the same pass that takes
//     the minimum, the candidates before its row's current k-th pair, which
//     is never after the k-th that the skip test reads (the snapshot of the
//     chunk's start: merges only tighten it). A chunk that the rule skips
//     has every distance above that snapshot of every row, so it queues
//     nothing; a merged chunk queues every point that can enter a row's k
//     best. So the lists, and the skip count, are the plain version's.
//     Every queue is merged at the end of each computed chunk, so the
//     tile's k-th best is exact when the next chunk's test reads it.
//   - Far chunks are pruned before any distance: the pre-pass boxes each
//     chunk's valid points, the prologue the tile's queries, and a chunk
//     whose box bound (knn_select.cuh `box_bound`, lowered by a proven
//     rounding margin, so it never exceeds a distance dist2 returns for the
//     chunk) is above the tile's k-th snapshot is skipped unread. Its
//     minimum is then above the snapshot too: the rule skips it as well.
//     A skipped count is kept of both kinds, and of the pruned apart.
//   - The chunk's records (written once by the pre-pass) are staged in
//     shared memory; the chunk's minimum and the tile's new k-th best are
//     reduced by warp shuffles and one barrier.
// The distance is pcm_topk::dist2, bit for bit that of knn.cu, of knn_baseline.cu
// and of the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "knn_select.cuh"

namespace {

using pcm_select::invalid_record;
using pcm_select::kBoxFloats;
using pcm_select::kFull;
using pcm_select::kUnroll;

constexpr int kChunk = 512;       // the TPU's reference chunk, at most
constexpr int kMaxTile = 128;     // queries a tile, at most: the TPU's tile
constexpr int kMaxThreads = 256;  // TQ * S, at most
constexpr int kMaxWarps = kMaxThreads / 32;

template <int S, int R>
__global__ void __launch_bounds__(kMaxThreads)
knn_chunkskip_kernel(const float4* __restrict__ rec, const float* __restrict__ boxes,
                     const float* __restrict__ q, int32_t* __restrict__ out_idx,
                     float* __restrict__ out_d2, int M, int N, int k, int tq, int tn,
                     int n_chunks, int* __restrict__ counts) {
  __shared__ __align__(16) float4 chunk[kChunk];
  __shared__ float wbox[kMaxWarps][7];
  __shared__ float wmin[kMaxWarps], wtau[kMaxWarps];
  constexpr int kStep = S * kUnroll;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5, lane_g = tid % S;
  const int b = blockIdx.y, qt = blockIdx.x, n_tiles = gridDim.x;
  const int m = qt * tq + tid / S;
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

  // the tile's box of its active queries, and their largest |q|^2: lows,
  // negated highs and the negated norm, all reduced by min
  float tbox[7] = {active ? qx : INFINITY, active ? qy : INFINITY, active ? qz : INFINITY,
                   active ? -qx : INFINITY, active ? -qy : INFINITY, active ? -qz : INFINITY,
                   active ? -q2 : INFINITY};
#pragma unroll
  for (int f = 0; f < 7; ++f) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tbox[f] = fminf(tbox[f], __shfl_xor_sync(kFull, tbox[f], o));
    if (lane == 0) wbox[warp][f] = tbox[f];
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 7; ++f) {
    float v = wbox[0][f];
    for (int w = 1; w < n_warps; ++w) v = fminf(v, wbox[w][f]);
    tbox[f] = f < 3 ? v : -v;
  }

  const float4* rb = rec + (size_t)b * N;
  const float* bb = boxes + (size_t)b * n_chunks * kBoxFloats;
  const int c0 = (int)(((long long)qt * n_chunks) / n_tiles);  // the home chunk
  float tau = pcm_topk::kBig;  // the tile's largest k-th best: every list is empty
  int n_skipped = 0, n_pruned = 0;
  for (int j = 0; j < n_chunks; ++j) {
    const int off = (j + 1) / 2;
    const int c = (c0 + ((j & 1) ? off : -off) + n_chunks) % n_chunks;
    const float* bx = bb + (size_t)c * kBoxFloats;
    // the same value in every thread: the whole block skips or computes
    if (pcm_select::box_bound(tbox, bx) > tau) {
      ++n_skipped;
      ++n_pruned;
      continue;
    }
    const int base = c * tn, cnt = min(tn, N - base);
    const int span = (cnt + kStep - 1) / kStep * kStep;  // <= kChunk: kChunk % kStep == 0
    for (int jj = tid; jj < span; jj += blockDim.x)
      chunk[jj] = jj < cnt ? rb[base + jj] : invalid_record();
    __syncthreads();

    // the row's smallest distance over the chunk, an invalid or padded slot
    // at 1e10, as the plain version pads the chunk (bx[7]: valid points);
    // a row past M takes no part
    float rmin = active && bx[7] < (float)tn ? pcm_topk::kBig : INFINITY;
    for (int jj = lane_g; jj < span; jj += kStep) {
      if (sel.must_merge()) sel.merge();
      float d[kUnroll];
      bool near = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 r = chunk[jj + u * S];
        d[u] = pcm_topk::dist2(qx, qy, qz, q2, r.x, r.y, r.z, r.w);
        rmin = fminf(rmin, d[u]);
        near |= d[u] <= sel.td;
      }
      if (__any_sync(kFull, near)) {  // a uniform branch, as in knn.cu
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) sel.push(d[u], base + jj + u * S);
      }
    }
    if (__any_sync(kFull, sel.cnt > 0)) sel.merge();
    if (!active) rmin = INFINITY;
    float kth = sel.td;  // -inf past M
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      rmin = fminf(rmin, __shfl_xor_sync(kFull, rmin, o));
      kth = fmaxf(kth, __shfl_xor_sync(kFull, kth, o));
    }
    if (lane == 0) {
      wmin[warp] = rmin;
      wtau[warp] = kth;
    }
    // also: the chunk is consumed before the next is staged, and wmin/wtau
    // are read before the next computed chunk writes them (after its
    // staging barrier)
    __syncthreads();
    float chunk_min = wmin[0], next_tau = wtau[0];
    for (int w = 1; w < n_warps; ++w) {
      chunk_min = fminf(chunk_min, wmin[w]);
      next_tau = fmaxf(next_tau, wtau[w]);
    }
    if (chunk_min > tau) ++n_skipped;  // no row could take a point of it
    tau = next_tau;
  }

  if (tid == 0 && counts != nullptr) {
    atomicAdd(counts, n_skipped);
    atomicAdd(counts + 1, n_pruned);
  }
  if (!active) return;
  const size_t o = ((size_t)b * M + m) * k;
  sel.store(out_idx + o, out_d2 + o, k);
}

template <int S, int R>
cudaError_t launch(const float* q, const float* p, const uint8_t* mask, float4* rec,
                   float* boxes, int32_t* idx, float* d2, int* counts, int B, int M, int N,
                   int k, int tq, cudaStream_t stream) {
  const int tn = std::min(kChunk, std::max(N, 128));
  const int n_chunks = (N + tn - 1) / tn;
  pcm_select::records_kernel<<<dim3(n_chunks, B), pcm_select::kRecordThreads, 0, stream>>>(
      p, mask, rec, nullptr, boxes, N, tn, 0);
  const dim3 grid((M + tq - 1) / tq, B);
  knn_chunkskip_kernel<S, R><<<grid, tq * S, 0, stream>>>(rec, boxes, q, idx, d2, M, N, k, tq,
                                                          tn, n_chunks, counts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pcm_knn_chunkskip_max_tile() { return kMaxTile; }
int pcm_knn_chunkskip_max_threads() { return kMaxThreads; }
int pcm_knn_chunkskip_box_floats() { return kBoxFloats; }

// q (B, M, 3) f32, p (B, N, 3) f32, mask (B, N) bool as bytes; rec a (B, N)
// float4 scratch and boxes a (B, ceil(N / min(512, max(N, 128))), 8) f32
// scratch; idx (B, M, k) int32 and d2 (B, M, k) f32 outputs; all contiguous
// on device `device`; 1 <= k <= 128. S, the lanes a query, as pcm_knn takes
// it; TQ, the queries a tile, a power of two <= 128 with 32 <= TQ * S <=
// 256. `counts`: null, or two int32 on the device to which the launch adds
// the (tile, chunk) pairs it skipped and, of those, the pairs it pruned by
// their boxes. Returns the cudaError_t of the launches.
int pcm_knn_chunkskip(const float* q, const float* p, const uint8_t* mask, void* rec,
                      float* boxes, int32_t* idx, float* d2, int* counts, int B, int M, int N,
                      int k, int S, int TQ, int device, void* stream) {
  if (B < 1 || M < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (TQ < 1 || TQ > kMaxTile || (TQ & (TQ - 1)) != 0 || TQ * S < 32 || TQ * S > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float4* records = static_cast<float4*>(rec);
  return (int)pcm_select::with_shape(S, k, [&](auto shape) {
    using Sh = decltype(shape);
    return launch<Sh::kS, Sh::kR>(q, p, mask, records, boxes, idx, d2, counts, B, M, N, k, TQ,
                                  s);
  });
}

}  // extern "C"
