// Batched farthest-point sampling over padded clouds, one block per cloud.
//
// Replaces the TPU kernel `_fps_kernel` / `farthest_point_sampling_padded_pallas`
// (pointcloudmatters_tpu/ops/pallas_fps.py:30-103). Semantics are those of
// `_farthest_point_sampling_padded_xla` (pointcloudmatters_tpu/ops/pointops.py):
// seed at index 0; running min-distance cache; invalid points carry -1 so they
// are picked only once every valid point's distance is below -1 (never, unless
// a row has no valid point); rows with fewer valid points than `npoints` repeat
// indices; exact ties go to the smaller index.
//
// What bounds it on an H100: the loop is sequential. Each of the npoints-1
// iterations needs the previous argmax, so the time is npoints times the
// latency of one pass over the cloud plus one block-wide argmax (warp
// shuffles, one __syncthreads). Only B blocks exist, so only B of the 132 SMs
// work (B = 1 in a rollout).
//
// What the design does about it: everything the loop touches stays on chip.
// Coordinates live in dynamic shared memory (12 bytes a point: 123 KB at
// N = 10240), the min-distance cache in registers (PPT values a thread), the
// validity of a thread's points in one bitmask register. An iteration reads
// the chosen point from shared memory (a broadcast), updates PPT distances,
// reduces (value, index) within the warp by shuffles, and reduces the 32 warp
// results redundantly in every warp from a double-buffered shared array, so
// one barrier an iteration suffices.
//
// Above 16,384 points (two cameras of the shipped 16,384 each, say) the
// coordinates no longer fit shared memory (12 bytes a point) nor the cache
// registers, so `fps_kernel_large` keeps the min-distance cache and the
// validity in shared memory (5 bytes a point, up to kMaxNLarge points) and
// reads the coordinates from global memory, where the cloud stays in L2
// (240 KB at N = 20480). Its loop, reduction and tie order are the same.
//
// Rounding: distances are computed with __fmul_rn/__fadd_rn/__fsub_rn in the
// plain version's order, |x|^2 + |p|^2 - 2 (x0 p0 + x1 p1 + x2 p2), with
// |x|^2 = x0 x0 + x1 x1 + x2 x2, so no FMA contraction changes a bit and the
// kernel is index-exact against its plain PyTorch version on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPPT = 16;  // points a thread: N <= 16384
constexpr int kMaxN = kMaxThreads * kMaxPPT;
constexpr int kMaxNLarge = 40960;  // 5 bytes a point of dynamic shared memory

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// (v, i) beats (bv, bi) when larger, or equal with a smaller index.
__device__ __forceinline__ void take_better(float v, int i, float& bv, int& bi) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    take_better(ov, oi, bv, bi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads, 1)  // 64 registers a thread
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
           int32_t* __restrict__ out, int N, int npoints) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  const uint8_t* m = mask + (size_t)b * N;

  for (int j = tid; j < N; j += nthreads) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
  }

  float dist[PPT];
  uint32_t valid = 0;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = tid + i * nthreads;
    if (j < N) {
      const bool v = m[j] != 0;
      valid |= (uint32_t)v << i;
      dist[i] = v ? 1.0e10f : -1.0f;
    } else {
      dist[i] = -INFINITY;  // beyond the row: never selected
    }
  }
  if (tid == 0) out[(size_t)b * npoints] = 0;
  __syncthreads();

  int last = 0;
  for (int it = 1; it < npoints; ++it) {
    const float px = sx[last], py = sy[last], pz = sz[last];
    const float p2 = sqnorm(px, py, pz);
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int j = tid + i * nthreads;
      if ((valid >> i) & 1u) {
        const float x = sx[j], y = sy[j], z = sz[j];
        const float dot =
            __fadd_rn(__fadd_rn(__fmul_rn(x, px), __fmul_rn(y, py)), __fmul_rn(z, pz));
        const float d = __fsub_rn(__fadd_rn(sqnorm(x, y, z), p2), __fmul_rn(2.0f, dot));
        dist[i] = fminf(dist[i], d);
      }
      // j rises with i, so a strict > keeps the smaller index on a tie
      if (dist[i] > bv) {
        bv = dist[i];
        bi = j;
      }
    }
    warp_argmax(bv, bi);
    const int buf = it & 1;
    if (lane == 0) {
      red_v[buf][warp] = bv;
      red_i[buf][warp] = bi;
    }
    __syncthreads();
    // every warp reduces the warp results itself: no second barrier. The
    // buffer alternates, so a warp that runs ahead writes the other one.
    bv = lane < nwarps ? red_v[buf][lane] : -INFINITY;
    bi = lane < nwarps ? red_i[buf][lane] : 0x7fffffff;
    warp_argmax(bv, bi);
    last = bi;
    if (tid == 0) out[(size_t)b * npoints + it] = last;
  }
}

// The same loop for kMaxN < N <= kMaxNLarge: the min-distance cache and the
// validity in shared memory, the coordinates read from global memory. Each
// thread touches only its own points (j = tid + i * nthreads), so the cache
// needs no barrier of its own.
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_kernel_large(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                 int32_t* __restrict__ out, int N, int npoints) {
  extern __shared__ float smem[];
  float* dist = smem;
  uint8_t* valid = reinterpret_cast<uint8_t*>(dist + N);
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  const uint8_t* m = mask + (size_t)b * N;

  for (int j = tid; j < N; j += nthreads) {
    const bool v = m[j] != 0;
    valid[j] = v;
    dist[j] = v ? 1.0e10f : -1.0f;
  }
  if (tid == 0) out[(size_t)b * npoints] = 0;
  __syncthreads();

  int last = 0;
  for (int it = 1; it < npoints; ++it) {
    const float px = __ldg(p + 3 * last), py = __ldg(p + 3 * last + 1),
                pz = __ldg(p + 3 * last + 2);
    const float p2 = sqnorm(px, py, pz);
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = tid; j < N; j += nthreads) {
      float dj = dist[j];
      if (valid[j]) {
        const float x = __ldg(p + 3 * j), y = __ldg(p + 3 * j + 1), z = __ldg(p + 3 * j + 2);
        const float dot =
            __fadd_rn(__fadd_rn(__fmul_rn(x, px), __fmul_rn(y, py)), __fmul_rn(z, pz));
        const float d = __fsub_rn(__fadd_rn(sqnorm(x, y, z), p2), __fmul_rn(2.0f, dot));
        dj = fminf(dj, d);
        dist[j] = dj;
      }
      // j rises, so a strict > keeps the smaller index on a tie
      if (dj > bv) {
        bv = dj;
        bi = j;
      }
    }
    warp_argmax(bv, bi);
    const int buf = it & 1;
    if (lane == 0) {
      red_v[buf][warp] = bv;
      red_i[buf][warp] = bi;
    }
    __syncthreads();
    bv = lane < nwarps ? red_v[buf][lane] : -INFINITY;
    bi = lane < nwarps ? red_i[buf][lane] : 0x7fffffff;
    warp_argmax(bv, bi);
    last = bi;
    if (tid == 0) out[(size_t)b * npoints + it] = last;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, const uint8_t* mask, int32_t* out, int B, int N,
                   int npoints, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)3 * N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<PPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)((size_t)3 * kMaxN * sizeof(float)));
  if (err != cudaSuccess) return err;
  fps_kernel<PPT><<<B, threads, smem, stream>>>(xyz, mask, out, N, npoints);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pcm_fps_max_points() { return kMaxNLarge; }

// xyz (B, N, 3) f32, mask (B, N) bool as bytes, out (B, npoints) int32; all
// contiguous on device `device`. Returns the cudaError_t of the launch.
int pcm_fps(const float* xyz, const uint8_t* mask, int32_t* out, int B, int N,
            int npoints, int device, void* stream) {
  if (N < 1 || N > kMaxNLarge || npoints < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N > kMaxN) {
    const size_t smem = (size_t)N * (sizeof(float) + 1);
    err = cudaFuncSetAttribute(fps_kernel_large, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)((size_t)kMaxNLarge * (sizeof(float) + 1)));
    if (err != cudaSuccess) return (int)err;
    fps_kernel_large<<<B, kMaxThreads, smem, (cudaStream_t)stream>>>(xyz, mask, out, N,
                                                                      npoints);
    return (int)cudaGetLastError();
  }
  const int threads = N >= kMaxThreads ? kMaxThreads : ((N + 31) / 32) * 32;
  const int ppt = (N + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ppt) {
#define PCM_FPS_CASE(P) \
  case P:               \
    return (int)launch<P>(xyz, mask, out, B, N, npoints, threads, s);
    PCM_FPS_CASE(1)
    PCM_FPS_CASE(2)
    PCM_FPS_CASE(3)
    PCM_FPS_CASE(4)
    PCM_FPS_CASE(5)
    PCM_FPS_CASE(6)
    PCM_FPS_CASE(7)
    PCM_FPS_CASE(8)
    PCM_FPS_CASE(9)
    PCM_FPS_CASE(10)
    PCM_FPS_CASE(11)
    PCM_FPS_CASE(12)
    PCM_FPS_CASE(13)
    PCM_FPS_CASE(14)
    PCM_FPS_CASE(15)
    PCM_FPS_CASE(16)
#undef PCM_FPS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
