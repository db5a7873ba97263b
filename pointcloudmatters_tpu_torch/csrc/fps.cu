// Batched farthest-point sampling over padded clouds, one thread-block
// cluster per cloud.
//
// Replaces the TPU kernel `_fps_kernel` / `farthest_point_sampling_padded_pallas`
// (pointcloudmatters_tpu/ops/pallas_fps.py:30-103). Semantics are those of
// `_farthest_point_sampling_padded_xla` (pointcloudmatters_tpu/ops/pointops.py):
// seed at index 0; running min-distance cache; invalid points carry -1 so they
// are picked only once every valid point's distance is below -1 (never, unless
// a row has no valid point); rows with fewer valid points than `npoints` repeat
// indices; exact ties go to the smaller index.
//
// What bounds it on an H100: the loop is sequential. Each of the npoints - 1
// rounds needs the previous round's argmax, so the time is npoints times the
// latency of one round: a pass over the cloud (about 20 instructions a point)
// and an argmax over it. With one block a cloud that pass is one SM's issue
// rate (10,240 points: about 1,600 issue cycles a round), and only B of the
// 132 SMs work (B = 1 in a rollout).
//
// What the design does about it: a cloud is spread over a cluster of C CTAs
// (C in {1, 2, 4, 8, 16} and the threads a CTA chosen by the wrapper,
// ops/fps.py), launched with cudaLaunchKernelEx and a cluster dimension.
// CTA r owns the contiguous slice [r S, (r + 1) S) of the cloud, S =
// ceil(N / C), and keeps it in shared memory as float4 (x, y, z, |x|^2),
// |x|^2 computed once with the rounding below; its min-distance cache and
// the validity of its points stay in registers (point j of the slice in
// thread j % T, slot j / T). A round:
//   1. every thread updates its points and takes their argmax (j rises
//      with the slot, so a strict > keeps the smaller index); each warp
//      reduces (value, index) by two `redux.sync`: the max of the value's
//      order-preserving bits, then the min index among the lanes that hold
//      it; the warps' results meet in shared memory (one __syncthreads) and
//      warp 0 reduces them the same way;
//   2. lanes 0 .. C - 1 of warp 0 send the CTA's record (value, index, x,
//      y, z, |x|^2, the point read from the CTA's own slice) into slot
//      [round & 1][r] of CTA 0 .. C - 1 of the cluster by `st.async`, each
//      onto the receiving CTA's mbarrier [round & 1], which counts the
//      bytes (thread 0 of each CTA arms it for C records a round);
//   3. every warp waits on its CTA's mbarrier (`mbarrier.try_wait.parity`,
//      acquire at cluster scope), reads the C records and reduces them by
//      the same two `redux.sync`. All CTAs then hold the same winner and,
//      from its record, its coordinates: no CTA reads the chosen point from
//      another CTA's memory, and no cluster-wide barrier runs in the loop.
// Why two slots and two mbarriers suffice (the argument of the double-
// buffered warp results of the one-block kernel this replaces, lifted to
// the cluster): a CTA sends its record of round i + 1 only after it has
// read the records of round i (its warps meet at round i + 1's
// __syncthreads after their reads), and a CTA reaches round i + 2 only
// with every CTA's record of round i + 1. So a record of round i + 2 never
// lands in a slot that is still to be read, nor counts on a phase of the
// mbarrier that is still open; and no warp can miss its phase (parity i &
// 1), since the next phase of that mbarrier needs this CTA's own record of
// round i + 2. A cluster barrier before the first round makes sure that
// every CTA runs, with its mbarriers initialised, before any record is
// sent; one after the last keeps every CTA until the records in flight
// have landed.
// Two other exchanges measured slower on the card (PERF.md): a record a
// warp, and plain remote stores with one cluster barrier a round.
//
// A CTA holds at most kMaxSlice points (192 KiB of float4; 16,384 would
// take 256 KiB, above the 227 KiB a block may use) and a thread at most
// kMaxPPT of them, so the wrapper takes C >= ceil(N / kMaxSlice) up to
// kMaxCluster * kMaxSlice = 196,608 points a cloud (a cluster of 16 CTAs
// of 1024 threads, one an SM). Above that the cluster has 16 CTAs of 1024
// threads, and each CTA holds the first kMaxSlice points of its slice as
// above and streams the rest each round: their coordinates from xyz, their
// validity from mask, and their min-distance cache from the caller's f32
// scratch `work` (B, N), read and written back by the thread that owns the
// point (slice point j >= kMaxSlice in thread j % T, after its held
// points: j still rises within a thread, so the strict > still keeps the
// smaller index). |x|^2 of a streamed point is recomputed each round with
// the same rounding, so nothing else changes. The streaming is a template
// argument: the kernel that holds its whole slice carries none of it (with
// it, an empty loop and a branch slowed every round by 16%, PERF.md). A
// cloud holds at most kMaxN points: an index stays below kNoIndex.
//
// Rounding: distances are computed with __fmul_rn/__fadd_rn/__fsub_rn in the
// plain version's order, |x|^2 + |p|^2 - 2 (x0 p0 + x1 p1 + x2 p2), with
// |x|^2 = x0 x0 + x1 x1 + x2 x2, so no FMA contraction changes a bit and the
// kernel is index-exact against its plain PyTorch version on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPPT = 12;  // points a thread
constexpr int kMaxSlice = kMaxThreads * kMaxPPT;  // points a CTA: 12,288
constexpr int kMaxCluster = 16;  // non-portable above 8
constexpr int kMaxResident = kMaxCluster * kMaxSlice;  // held by a cluster: 196,608
constexpr uint32_t kNoIndex = 0x7fffffffu;
constexpr int kMaxN = (int)kNoIndex - 1;  // points a cloud
constexpr int kMaxDevices = 64;
constexpr uint32_t kRecordBytes = 24;  // (key, index) and (x, y, z, |x|^2)

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The bits of v as an unsigned integer in the order of the floats (v not
// NaN; -0 is taken as +0 first, as the float comparison takes them).
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's best (key, index): the largest key, then the smallest index
// among the lanes that hold it. Every lane gets both.
__device__ __forceinline__ void warp_best(uint32_t key, uint32_t idx, uint32_t& best_key,
                                          uint32_t& best_idx) {
  best_key = __reduce_max_sync(0xffffffffu, key);
  best_idx = __reduce_min_sync(0xffffffffu, key == best_key ? idx : 0xffffffffu);
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of shared-memory address `a` of this CTA in CTA `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A slot of the round's exchange: the winner's coordinates and |x|^2, and
// (ordered value, index).
struct Slots {
  float4* xyzw;  // [2][C]
  uint2* key;    // [2][C]
};

// Where lane l < C of warp 0 writes the CTA's record of each parity: the
// CTA's slot of that parity and the mbarrier of that parity in CTA l of the
// cluster (addresses mapped once, before the rounds).
struct Route {
  uint32_t key[2], xyzw[2], bar[2];
};

__device__ __forceinline__ Route route(const Slots& slots, uint64_t* bar, int slot, int C,
                                       int lane) {
  Route r;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    r.key[b] = mapa(smem_u32(slots.key + b * C + slot), lane);
    r.xyzw[b] = mapa(smem_u32(slots.xyzw + b * C + slot), lane);
    r.bar[b] = mapa(smem_u32(bar + b), lane);
  }
  return r;
}

// Lanes 0 .. C - 1 write the record of parity `buf` into CTA `lane` each
// (by st.async: onto that CTA's mbarrier of the parity).
__device__ __forceinline__ void send(const Route& r, int buf, float4 w, uint32_t key,
                                     uint32_t idx, int lane, int C) {
  if (lane >= C) return;
  const uint32_t k = buf ? r.key[1] : r.key[0];
  const uint32_t x = buf ? r.xyzw[1] : r.xyzw[0];
  const uint32_t rb = buf ? r.bar[1] : r.bar[0];
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];\n"
      ::"r"(k), "r"(key), "r"(idx), "r"(rb) : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(x), "f"(w.x), "f"(w.y), "f"(w.z), "f"(w.w), "r"(rb) : "memory");
}

// The slice as float4, and two parities of C record slots.
constexpr size_t smem_bytes(int slice, int cluster) {
  return (size_t)slice * sizeof(float4) + (size_t)2 * cluster * kRecordBytes;
}

// One cluster a cloud: grid (B C), cluster (C), T threads a CTA; kStream
// when a slice is above kMaxSlice points, and only then is `work` (B, N)
// f32 read.
template <bool kStream>
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                   int32_t* __restrict__ out, float* __restrict__ work, int N, int npoints,
                   int slice) {
  extern __shared__ __align__(16) float4 sm4[];
  __shared__ uint2 red[2][32];    // the warps' results
  __shared__ uint64_t bar[2];     // a round's records have landed
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = blockDim.x, W = T >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int held = min(slice, kMaxSlice);  // the slice points in shared memory
  float4* pts = sm4;
  const Slots slots{pts + held, reinterpret_cast<uint2*>(pts + held + 2 * C)};

  const int b = blockIdx.x / C;
  const int lo = rank * slice;
  const int n_own = max(0, min(N - lo, slice));
  const int n_held = min(n_own, kMaxSlice);
  const int ppt = (n_held + T - 1) / T;  // the same in every thread of the CTA
  const float* p = xyz + (size_t)b * N * 3;
  const uint8_t* m = mask + (size_t)b * N + lo;
  float* wk = work + (size_t)b * N + lo;  // the streamed points' caches

  for (int j = tid; j < n_held; j += T) {
    const float* q = p + (size_t)3 * (lo + j);
    pts[j] = make_float4(q[0], q[1], q[2], sqnorm(q[0], q[1], q[2]));
  }
  if (kStream) {
    for (int j = kMaxSlice + tid; j < n_own; j += T) wk[j] = m[j] ? 1.0e10f : -1.0f;
  }
  float dist[kMaxPPT];
  uint32_t valid = 0;
#pragma unroll
  for (int i = 0; i < kMaxPPT; ++i) {
    const int j = tid + i * T;
    if (j < n_held) {
      const bool v = m[j] != 0;
      valid |= (uint32_t)v << i;
      dist[i] = v ? 1.0e10f : -1.0f;
    } else {
      dist[i] = -INFINITY;  // beyond the row or the slice: never selected
    }
  }
  if (rank == 0 && tid == 0) out[(size_t)b * npoints] = 0;
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float px = p[0], py = p[1], pz = p[2];
  float p2 = sqnorm(px, py, pz);
  uint32_t phases = 0;  // the parity of each mbarrier's current phase
  // lanes >= C send nothing
  const Route to = route(slots, bar, rank, C, lane < C ? lane : rank);
  cluster_barrier();  // every CTA runs, with its slice and mbarriers in place

  for (int it = 1; it < npoints; ++it) {
    const int buf = it & 1;
    if (tid == 0) mbar_expect(&bar[buf], C * kRecordBytes);
    float bv = -INFINITY;
    uint32_t bi = kNoIndex;
#pragma unroll
    for (int i = 0; i < kMaxPPT; ++i) {
      if (i == ppt) break;
      const int j = tid + i * T;
      if ((valid >> i) & 1u) {
        const float4 x = pts[j];
        const float dot =
            __fadd_rn(__fadd_rn(__fmul_rn(x.x, px), __fmul_rn(x.y, py)), __fmul_rn(x.z, pz));
        const float d = __fsub_rn(__fadd_rn(x.w, p2), __fmul_rn(2.0f, dot));
        dist[i] = fminf(dist[i], d);
      }
      // j rises with i, so a strict > keeps the smaller index on a tie
      if (dist[i] > bv) {
        bv = dist[i];
        bi = (uint32_t)(lo + j);
      }
    }
    if (kStream) {  // the streamed points, after the held ones
#pragma unroll 4
      for (int j = kMaxSlice + tid; j < n_own; j += T) {
        float dj = wk[j];
        if (m[j]) {
          const float* q = p + (size_t)3 * (lo + j);
          const float x0 = q[0], x1 = q[1], x2 = q[2];
          const float dot =
              __fadd_rn(__fadd_rn(__fmul_rn(x0, px), __fmul_rn(x1, py)), __fmul_rn(x2, pz));
          const float d = __fsub_rn(__fadd_rn(sqnorm(x0, x1, x2), p2), __fmul_rn(2.0f, dot));
          dj = fminf(dj, d);
          wk[j] = dj;
        }
        if (dj > bv) {
          bv = dj;
          bi = (uint32_t)(lo + j);
        }
      }
    }
    uint32_t wkey, widx;
    warp_best(ordered(bv), bi, wkey, widx);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    // the CTA's record: the warps' results through shared memory (parity
    // buffered as the slots are), reduced by warp 0, which sends it
    if (lane == 0) red[buf][warp] = make_uint2(wkey, widx);
    __syncthreads();
    if (warp == 0) {
      const uint2 r = lane < W ? red[buf][lane] : make_uint2(0u, 0xffffffffu);
      uint32_t ckey, cidx;
      warp_best(r.x, r.y, ckey, cidx);
      float4 w = zero;
      if (cidx != kNoIndex) {
        const int j = (int)cidx - lo;
        if (!kStream || j < kMaxSlice) {
          w = pts[j];
        } else {
          const float* q = p + (size_t)3 * cidx;
          w = make_float4(q[0], q[1], q[2], sqnorm(q[0], q[1], q[2]));
        }
      }
      send(to, buf, w, ckey, cidx, lane, C);
    }
    mbar_wait(&bar[buf], (phases >> buf) & 1u);
    phases ^= 1u << buf;

    // every warp reduces the records of the round; the lane of the winner
    // hands out its point
    uint32_t ck = 0u, ci = 0xffffffffu;
    float4 cp = zero;
    for (int s = lane; s < C; s += 32) {
      const uint2 r = slots.key[buf * C + s];
      const float4 x = slots.xyzw[buf * C + s];
      if (r.x > ck || (r.x == ck && r.y < ci)) {
        ck = r.x;
        ci = r.y;
        cp = x;
      }
    }
    uint32_t gkey, gidx;
    warp_best(ck, ci, gkey, gidx);
    const int win = __ffs(__ballot_sync(0xffffffffu, ck == gkey && ci == gidx)) - 1;
    px = __shfl_sync(0xffffffffu, cp.x, win);
    py = __shfl_sync(0xffffffffu, cp.y, win);
    pz = __shfl_sync(0xffffffffu, cp.z, win);
    p2 = __shfl_sync(0xffffffffu, cp.w, win);
    if (rank == 0 && tid == 0) out[(size_t)b * npoints + it] = (int32_t)gidx;
  }
  cluster_barrier();  // no CTA leaves while records fly
}

using Kernel = void (*)(const float*, const uint8_t*, int32_t*, float*, int, int, int);

// The kernel for clouds of N points over C CTAs.
Kernel kernel_for(int N, int C) {
  return (N + C - 1) / C > kMaxSlice ? fps_cluster_kernel<true> : fps_cluster_kernel<false>;
}

// The kernels' attributes on the current device `device`, set at their
// first use there: clusters above 8 CTAs, and the shared memory of the
// largest slice (what a launch takes is its own dynamic size).
cudaError_t set_attributes(int device) {
  static bool done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const Kernel kernels[2] = {fps_cluster_kernel<false>, fps_cluster_kernel<true>};
  for (Kernel k : kernels) {
    cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxSlice, kMaxCluster));
    if (err != cudaSuccess) return err;
  }
  done[device] = true;
  return cudaSuccess;
}

// The launch configuration of B clouds of N points, C CTAs of T threads
// each; false when the kernel does not take it.
bool config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int B, int N, int C, int T,
            cudaStream_t stream) {
  if (N < 1 || N > kMaxN || B < 1 || C < 1 || C > kMaxCluster || (C & (C - 1)) != 0 ||
      T < 32 || T > kMaxThreads || T % 32 != 0)
    return false;
  const int slice = (N + C - 1) / C;
  const int held = slice < kMaxSlice ? slice : kMaxSlice;
  if ((held + T - 1) / T > kMaxPPT) return false;
  // a slice is streamed only in the largest cluster, each thread holding kMaxPPT points
  if (slice > kMaxSlice && (C != kMaxCluster || T != kMaxThreads)) return false;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3((unsigned)T);
  cfg.dynamicSmemBytes = smem_bytes(held, C);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return true;
}

}  // namespace

extern "C" {

int pcm_fps_max_points() { return kMaxN; }

int pcm_fps_max_slice() { return kMaxSlice; }

int pcm_fps_max_points_per_thread() { return kMaxPPT; }

// How many clusters of C CTAs of T threads, for clouds of N points, the
// device can hold at once (cudaOccupancyMaxActiveClusters): 0 when none
// fits, minus the cudaError_t on an error.
int pcm_fps_max_active_clusters(int N, int C, int T, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (!config(cfg, attr, 1, N, C, T, 0)) return -(int)cudaErrorInvalidValue;
  err = set_attributes(device);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel_for(N, C), &cfg);
  if (err != cudaSuccess) return -(int)err;
  return n;
}

// xyz (B, N, 3) f32, mask (B, N) bool as bytes, out (B, npoints) int32, and
// for N > kMaxResident work (B, N) f32 scratch (else unread, may be null);
// all contiguous on device `device`. One cluster of C CTAs (a power of two
// up to 16) of T threads (a multiple of 32) a cloud; ceil(min(ceil(N / C),
// kMaxSlice) / T) <= kMaxPPT, and C = 16, T = 1024 where ceil(N / C) >
// kMaxSlice. Returns the cudaError_t of the launch.
int pcm_fps(const float* xyz, const uint8_t* mask, int32_t* out, float* work, int B, int N,
            int npoints, int C, int T, int device, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (npoints < 1 || !config(cfg, attr, B, N, C, T, (cudaStream_t)stream) ||
      ((N + C - 1) / C > kMaxSlice && work == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = set_attributes(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel_for(N, C), xyz, mask, out, work, N, npoints,
                           (N + C - 1) / C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
