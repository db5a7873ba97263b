// Element types of the kernels: f32, or bf16 with f32 arithmetic. A bf16
// value is converted to f32 on load; `round_to<T>` rounds an f32 value to T
// and back, which is where a bf16 kernel reproduces a rounding point of its
// TPU counterpart (the identity for f32).

#pragma once

#include <cuda_bf16.h>

namespace pcm {

typedef __nv_bfloat16 bf16;

template <typename T>
struct is_bf16 {
  static constexpr bool value = false;
};
template <>
struct is_bf16<bf16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

}  // namespace pcm
