// C entry of the exact softmax attention forward (kernel 3 of the port,
// the TPU's `oneshot_attention` `_fwd_kernel`). The f32 kernel and its
// design notes are in attention_fwd.cuh (3xTF32 on the TF32 tensor cores,
// f32_mma.cuh); the bf16 kernel, on the bf16 tensor cores, is in
// attention_mma.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "attention_mma.cuh"

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
  namespace fw = pcm::attn;
  const fw::Args a{(const float*)q, (const float*)k, (const float*)v, (float*)o, row_max,
                   row_inv, fw::Strides{qsb, qsh, qsl}, fw::Strides{ksb, ksh, ksl},
                   fw::Strides{vsb, vsh, vsl}, fw::Strides{osb, osh, osl}, H, Lq, Lk, l_actual,
                   scale, threshold, inv_keep, seed, dropout};
  if (dh == 64) return (int)fw::launch<64>(a, B, s);
  if (dh == 128) return (int)fw::launch<128>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
