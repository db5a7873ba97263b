// The running k-best list of one query of the dense-scan kNN kernel 13
// (knn_baseline.cu), and the squared distance and pair order that all three
// kNN kernels share (kernels 2 and 12, knn.cu and knn_chunkskip.cu, keep
// their lists on lane groups: knn_select.cuh).
//
// A list holds K (distance, index) pairs in ascending order of the pair:
// a smaller distance first, and on equal distances the smaller index. Empty
// slots hold (1e10, kNoIndex), which no candidate of distance 1e10 beats;
// `store` writes index -1 for every slot at or above 1e10.
//
// Kernel 13 visits the points in index order and calls `push_after`, which
// compares distances only: a later point with an equal distance must stay
// behind, so exact ties go to the smaller index (the order the plain
// versions give), and the cheaper compare matters because a warp pays for
// the insertion of any of its threads.
//
// Two layouts, one interface (`init`, `worst` (the K-th distance),
// `push_after`, `store`):
//   RegTopK<K>, K <= 64: the list in registers, fully unrolled, so it never
//     leaves them (2K registers);
//   SmemTopK<K>, for K up to 128: at K = 128 the list alone would take 256
//     registers, more than a thread has, so it lives in dynamic shared
//     memory, one column a thread (slot s of thread t at s * nthreads + t),
//     which keeps a warp's accesses on 32 distinct banks. The last
//     distance is cached in a register for the hot comparison. A block needs
//     `smem_bytes(nthreads)` of dynamic shared memory for it.
// The top-K prefix of length k is the top-k, so a kernel instantiates the
// smallest K that holds k and stores only the first k slots.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pcm_topk {

constexpr float kBig = 1.0e10f;
constexpr int kNoIndex = 0x7fffffff;
constexpr int kMaxK = 128;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// |q|^2 + |p|^2 - 2 (q0 p0 + q1 p1 + q2 p2), clamped at 0, with
// round-to-nearest intrinsics in the plain version's order, so no FMA
// contraction changes a bit.
__device__ __forceinline__ float dist2(float qx, float qy, float qz, float q2, float px,
                                       float py, float pz, float p2) {
  const float dot =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, px), __fmul_rn(qy, py)), __fmul_rn(qz, pz));
  return fmaxf(__fsub_rn(__fadd_rn(q2, p2), __fmul_rn(2.0f, dot)), 0.0f);
}

// (d, i) comes before (d2, i2)
__device__ __forceinline__ bool before(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

template <int K>
struct RegTopK {
  static constexpr size_t smem_bytes(int) { return 0; }
  float d[K];
  int i[K];

  __device__ __forceinline__ void init(unsigned char*, int, int) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      d[s] = kBig;
      i[s] = kNoIndex;
    }
  }
  __device__ __forceinline__ float worst() const { return d[K - 1]; }
  // insert before the first larger distance, then shift the tail: ci is
  // larger than every index in the list, so only the distance decides
  __device__ __forceinline__ void push_after(float cd, int ci) {
    if (!(cd < d[K - 1])) return;
    bool shifting = false;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool take = shifting || cd < d[s];
      if (take) {
        const float td = d[s];
        const int ti = i[s];
        d[s] = cd;
        i[s] = ci;
        cd = td;
        ci = ti;
      }
      shifting = take;
    }
  }
  __device__ __forceinline__ void store(int32_t* out_idx, float* out_d2, int k) const {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k) {
        out_d2[s] = d[s];
        out_idx[s] = d[s] >= kBig ? -1 : i[s];
      }
    }
  }
};

template <int K>
struct SmemTopK {
  static constexpr size_t smem_bytes(int nthreads) {
    return (size_t)K * nthreads * (sizeof(float) + sizeof(int));
  }
  float* d;  // this thread's column
  int* i;
  int stride;
  float wd;  // the last distance, cached

  // `smem`: the block's smem_bytes(nthreads) of dynamic shared memory
  __device__ __forceinline__ void init(unsigned char* smem, int tid, int nthreads) {
    d = reinterpret_cast<float*>(smem) + tid;
    i = reinterpret_cast<int*>(smem + (size_t)K * nthreads * sizeof(float)) + tid;
    stride = nthreads;
    for (int s = 0; s < K; ++s) {
      d[s * stride] = kBig;
      i[s * stride] = kNoIndex;
    }
    wd = kBig;
  }
  __device__ __forceinline__ float worst() const { return wd; }
  // insertion from the tail: shift each larger distance one slot down (ci
  // is larger than every index in the list)
  __device__ __forceinline__ void push_after(float cd, int ci) {
    if (!(cd < wd)) return;
    int s = K - 1;
    while (s > 0) {
      const float pd = d[(s - 1) * stride];
      const int pi = i[(s - 1) * stride];
      if (!(cd < pd)) break;
      d[s * stride] = pd;
      i[s * stride] = pi;
      --s;
    }
    d[s * stride] = cd;
    i[s * stride] = ci;
    wd = d[(K - 1) * stride];
  }
  __device__ __forceinline__ void store(int32_t* out_idx, float* out_d2, int k) const {
    for (int s = 0; s < k; ++s) {
      const float v = d[s * stride];
      out_d2[s] = v;
      out_idx[s] = v >= kBig ? -1 : i[s * stride];
    }
  }
};

template <typename L>
struct ListTag {
  using type = L;
};

// Calls `f(ListTag<List>{})` with the list type that holds k (1 <= k <=
// 128): the register list of 4, 8, 16, 32 or 64 slots, or the shared-memory
// list of 128. Returns f's cudaError_t, or cudaErrorInvalidValue for k out
// of range.
template <typename F>
cudaError_t with_list(int k, F f) {
  if (k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  if (k <= 4) return f(ListTag<RegTopK<4>>{});
  if (k <= 8) return f(ListTag<RegTopK<8>>{});
  if (k <= 16) return f(ListTag<RegTopK<16>>{});
  if (k <= 32) return f(ListTag<RegTopK<32>>{});
  if (k <= 64) return f(ListTag<RegTopK<64>>{});
  return f(ListTag<SmemTopK<128>>{});
}

}  // namespace pcm_topk
