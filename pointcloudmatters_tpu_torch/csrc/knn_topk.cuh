// The squared distance, the pair order and the limits that the exact kNN
// kernels 2, 12 and 13 (knn.cu, knn_chunkskip.cu, knn_baseline.cu) share;
// their lists live on lane groups (knn_select.cuh).
//
// A k-best list holds (distance, index) pairs in ascending order of the
// pair: a smaller distance first, and on equal distances the smaller index
// (`before`). Empty slots hold (1e10, kNoIndex), which no candidate of
// distance 1e10 beats; a kernel writes index -1 for every slot at or above
// 1e10.

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

}  // namespace pcm_topk
