// C entry of the exact softmax attention forward (kernel 3 of the port,
// the TPU's `oneshot_attention` `_fwd_kernel`). The f32 kernel and its
// design notes are in attention_fwd.cuh (FP32 FMAs); the bf16 kernel, on the
// tensor cores, is in attention_mma.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "attention_mma.cuh"

namespace {

using pcm::attn::launch;
using pcm::attn::Strides;

cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                      float* row_max, float* row_inv, Strides qs, Strides ks, Strides vs,
                      Strides os, int B, int H, int Lq, int Lk, int l_actual, float scale,
                      uint32_t threshold, float inv_keep, uint32_t seed, int dropout,
                      cudaStream_t s) {
  if (dh == 64)
    return launch<64>(q, k, v, o, row_max, row_inv, qs, ks, vs, os, B, H, Lq, Lk, l_actual,
                      scale, threshold, inv_keep, seed, dropout, s);
  if (dh == 128)
    return launch<128>(q, k, v, o, row_max, row_inv, qs, ks, vs, os, B, H, Lq, Lk, l_actual,
                       scale, threshold, inv_keep, seed, dropout, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, H, Lq, dh), k and v (B, H, Lk, dh), o (B, H, Lq, dh), all f32
// (bf16 == 0) or all bf16 (bf16 != 0), given by base pointer and (batch,
// head, row) strides in elements, last axis contiguous, on device `device`.
// dh is 64 or 128; 1 <= l_actual <= Lk; `scale` is already rounded to the
// element type. row_max and row_inv are (B, H, Lq) f32 contiguous, or both
// null when the statistics are not needed. With `dropout` non-zero,
// probabilities whose keep bits are below `threshold` are dropped and the
// others scaled by inv_keep = 1 / (1 - rate); `seed` keys the mask. Returns
// the cudaError_t of the launch.
int pcm_attention_fwd(const void* q, const void* k, const void* v, void* o, float* row_max,
                      float* row_inv, long long qsb, long long qsh, long long qsl,
                      long long ksb, long long ksh, long long ksl, long long vsb,
                      long long vsh, long long vsl, long long osb, long long osh,
                      long long osl, int B, int H, int Lq, int Lk, int dh, int l_actual,
                      float scale, unsigned threshold, float inv_keep, unsigned seed,
                      int dropout, int bf16, int device, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || l_actual < 1 || l_actual > Lk ||
      B * H > 65535 || (row_max == nullptr) != (row_inv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl}, os{osb, osh, osl};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    namespace mm = pcm::attn_mma;
    const mm::Strides ks2{ksb, ksh, ksl}, vs2{vsb, vsh, vsl};
    const mm::FwdArgs a{(const pcm::bf16*)q, (const pcm::bf16*)k, (const pcm::bf16*)v,
                        (pcm::bf16*)o, row_max, row_inv, mm::Strides{qsb, qsh, qsl}, ks2,
                        vs2, mm::Strides{osb, osh, osl}, H, Lq, Lk, l_actual, scale,
                        threshold, inv_keep, seed, dropout,
                        mm::rows_aligned(k, ks2) && mm::rows_aligned(v, vs2)};
    if (dh == 64) return (int)mm::launch_fwd<64>(a, B, s);
    if (dh == 128) return (int)mm::launch_fwd<128>(a, B, s);
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_dh(dh, q, k, v, o, row_max, row_inv, qs, ks, vs, os, B, H, Lq, Lk,
                        l_actual, scale, threshold, inv_keep, seed, dropout, s);
}

}  // extern "C"
