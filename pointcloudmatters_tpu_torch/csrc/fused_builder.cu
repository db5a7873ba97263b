// The data-source token builder's two kernels: the forward statistics
// (kernel 5) and the tie-routed dW term of its backward (kernel 6).
//
// Kernel 5 replaces the TPU kernel `_fwd_kernel` / `_core_pallas`
// (pointcloudmatters_tpu/ops/fused_builder.py:115-206, 226-296). For bf16 g
// (B, N, D), bf16 h (B, M, D) and nn (B, M, K) int32 with -1 for holes, K
// <= 16, and x[m, k] = bf16(g[nn[m, k]] - h[m]) (the difference taken in f32
// and rounded once, as the TPU and the plain version take it), it writes
//   vmax[m] / vmin[m]  the max / min over the live k of x, bf16 (-inf / +inf
//                      for a query with holes only);
//   sg[m]              bf16 of the f32 sum over k of g[nn[m, k]], holes 0;
//   bm[m]              int32 tie bitmap: bit k when live x_k == vmax, bit
//                      16 + k when live x_k == vmin, compared on the rounded
//                      values (fused_builder.py:186-196);
//   total / total_sq   f32 sums over the live (m, k) of x and of x * x, the
//                      square in f32 (exact for bf16 x), as the TPU kernel
//                      squares (fused_builder.py:183-185).
// The (B, M, K, D) neighbourhood tensor never exists. What bounds it on an
// H100: bytes. It must read g, h and nn and write four (B, M, D) outputs
// (742 MB at B=32, N=10240, M=2048, D=512: 0.22 ms at 3.35 TB/s); the
// gathers read 16 source rows a query (1.07 GB), which the 50 MB L2 serves
// as long as the blocks in flight work on one or two clouds (10 MB of g
// each). Design:
//   - A thread owns 8 consecutive channels (a 16-byte chunk of a row), so
//     D / 8 threads serve a query: each gathered g row and h arrive as
//     16-byte `ld.global.nc` loads (a warp reads 512 contiguous bytes of a
//     source row), vmax, vmin and sg leave as 16-byte stores and bm as two.
//   - A block of 256 threads serves QF = min(16, 256 / (D / 8)) queries at
//     once (4 at D = 512): a thread issues the gathers of its query's live
//     neighbours together, K loads in flight (hole rows are not loaded).
//   - The B*M queries go out in groups of QF to at most kFwdBlocks = 264
//     blocks, round robin: block i takes groups i, i + blocks, ... So the
//     blocks work on neighbouring groups (one or two clouds) at any time,
//     and the block count and each block's rounds follow from (B, M, D)
//     alone. 264 blocks are one wave at two blocks an SM (128 registers a
//     thread); 132, 396, 528, 792 and 1056 measured slower
//     (scripts/probe_builder_fwd.py, PERF.md). Each round's nn rows are
//     staged in shared memory by `cp.async` during the round before. (Each
//     warp staging its own, with no block barrier between rounds, took a
//     register more and spilled: slower.)
//   - x = bf16(g - h) is one `sub.rn.bf16x2` a channel pair: one rounding of
//     the exact difference, which is what the f32 difference rounded once
//     gives (for bf16 operands the f32 difference is exact unless their
//     exponents differ by more than 15, and then both round to the larger
//     operand). The K differences stay packed (K * 4 registers at K = 16);
//     vmax and vmin are `max.bf16x2` / `min.bf16x2` over the live ones, and
//     the tie bits come after them by packed compares, a hole compared as
//     NaN (never equal). sg adds the gathered rows in f32 in k order, as the
//     plain version adds them.
//   - Totals: each thread sums x and x * x of its channels in f32 over a
//     query's neighbours, then adds the query's sums to its running totals
//     in shared memory (K + rounds terms deep, not K * rounds: at 264
//     blocks a thread walks 63 rounds at B=32); a block adds its QF query
//     slots in slot order and writes one row of partials; a second kernel
//     sums the rows in a fixed order (128 interleaved runs a column, then 4
//     runs a lane, then a shuffle tree). No atomics, so two launches give
//     identical bits.
// The TPU kernel's query sort, chunk transpose and VMEM-resident g are
// devices of its memory system and have no place here.
//
// Kernel 6 replaces the TPU kernel `_routed_kernel` / `_routed_dw_pallas`
// (fused_builder.py:339-383). It computes
//   dW[c, d] = sum over (b, m, k) of src[b, nn[b, m, k], c] * w[b, m, k, d],
//   w = bit_max_k(bm[b, m, d]) * dvx[b, m, d] + bit_min_k(bm) * dvn[b, m, d]
// with bf16 src, dvx and dvn (the tie-count-normalised cotangents rounded
// as at fused_builder.py:489-490), w and the sums in f32, hole rows zero,
// as the reference `_routed_dw_xla` does (the TPU kernel rounds w to
// bf16, which differs where one neighbour holds both tie bits). It gathers
// the src rows itself from nn, where the TPU path builds a (B, K, Ci, M)
// gathered copy first (1.1 GB at the flagship shapes), and builds the
// (B, M, K, D) weights only in shared memory. What bounds it: operations,
// 2 * B*M*K * Cin * D flops (0.57 TFLOP at B=32, Cin=515) at the bf16
// tensor-core peak.
// Design: dW = A^T W, a split-K GEMM over the B*M*K gathered rows on
// `mma.sync.m16n8k16` bf16 -> f32 (attention_mma.cuh's helpers, A read
// transposed by `ldmatrix.trans` as gemm_mma.cuh's kAT mode reads it).
//   - A block is 8 warps computing a 128-channel x 128-column tile of dW
//     over one split of the (b, m) pairs, each warp a 64 x 32 part; a
//     stage is 4 pairs (4 K rows, padded to a multiple of 16).
//   - Source rows: `cp.async` of 16-byte chunks at a row pitch that is a
//     multiple of 8 channels (the wrapper pads Cin = 515 to 528, as the
//     TPU path pads to a multiple of 16, fused_builder.py:473-476), a hole
//     or a row past the split zero-filled; a ring of 5 stages keeps 3
//     stages in flight while one multiplies, their indices read a stage
//     ahead. Channels at or above Cin only reach dW rows that are not
//     stored. A stage's bm, dvx and dvn rows come by `cp.async` too (D a
//     multiple of 8, the rows 16-byte aligned: the entry rejects others).
//   - Weights: each thread takes one pair and two columns, forms the four
//     values w can take there (mx dvx + mn dvn, in f32 as the plain version
//     forms them) and writes w_hi = bf16(w) for each of the K neighbours:
//     that of no tie bit (0) in all K rows, then over it that of each
//     neighbour with a bit (two a column, more on ties); the next stage's
//     between this stage's k steps (two weight buffers). Only
//     w = dvx + dvn (one neighbour both max and min: a query with one live
//     neighbour, or equal values) is not a bf16 value; for it w_lo =
//     bf16(w - w_hi), and a block-wide vote runs the w_lo product only in a
//     stage where some w_lo of the tile is not 0. Adding zero products
//     changes no bit, so the skip is exact.
//   - The tensor cores add truncating: a stage's products go into a zeroed
//     f32 fragment, added to the f32 accumulator rounding to nearest every
//     kFlush = 2 stages (f32_mma.cuh's remedy).
//   - The splits' partial tiles are summed by a second kernel in split
//     order; the splits are a function of the shapes only: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "elem.cuh"

namespace {

using pcm::bf16;
namespace mm = pcm::attn_mma;

constexpr int kMaxK = 16;
// kernel 5: threads a block, queries in flight a block at most, blocks at
// most (the two an SM of an H100's 132 that its registers let run at once:
// one wave; more rounds a block above that)
constexpr int kFwdThreads = 256;
constexpr int kMaxQF = 16;
constexpr int kFwdBlocks = 264;
constexpr int kSumRuns = 128;  // interleaved runs a column of the partial sum
static_assert(kSumRuns == 4 * 32, "the partial sum's lanes take 4 runs each");

// Kernel 5's decomposition of B*M queries of D channels, from the shapes
// alone: chunks of 8 channels a row, chunks a pass (one pass unless D >
// 2048), queries a group, groups, blocks and rounds a block.
struct FwdShape {
  int chunks, per_pass, qf, passes, blocks, rounds;
  __host__ __device__ FwdShape(long long queries, int D) {
    chunks = D / 8;
    per_pass = chunks < kFwdThreads ? chunks : kFwdThreads;
    qf = kFwdThreads / per_pass < kMaxQF ? kFwdThreads / per_pass : kMaxQF;
    passes = (chunks + per_pass - 1) / per_pass;
    const long long groups = (queries + qf - 1) / qf;
    blocks = (int)(groups < kFwdBlocks ? groups : kFwdBlocks);
    rounds = (int)((groups + blocks - 1) / blocks);
  }
};

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(mm::smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 of a pair as f32
__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

constexpr uint32_t kNaN2 = 0x7fc07fc0u;      // a bf16 NaN pair: a hole's x
constexpr uint32_t kNegInf2 = 0xff80ff80u;   // -inf, +inf pairs
constexpr uint32_t kPosInf2 = 0x7f807f80u;

__global__ void __launch_bounds__(kFwdThreads, 2)
builder_fwd_kernel(const bf16* __restrict__ g, const bf16* __restrict__ h,
                   const int* __restrict__ nn, bf16* __restrict__ vmax_out,
                   bf16* __restrict__ vmin_out, bf16* __restrict__ sg_out,
                   int* __restrict__ bm_out, float* __restrict__ part, int N, int M, int K,
                   int D, long long queries) {
  __shared__ int nn_s[2][kMaxQF * kMaxK];
  // a pass's totals of each thread over its rounds: x, then x * x
  __shared__ __align__(16) float red[kFwdThreads * 16];
  const FwdShape sh(queries, D);
  const int tid = threadIdx.x;
  const int slot = tid / sh.per_pass, cl = tid % sh.per_pass;
  const int qk = sh.qf * K;  // nn entries a round, at most kFwdThreads
  // round r's nn rows into buffer r & 1 (an empty group past the last round)
  auto stage = [&](int r) {
    const long long i = ((long long)r * gridDim.x + blockIdx.x) * sh.qf * K + tid;
    if (tid < qk && r < sh.rounds && i < queries * K) cp_async4(&nn_s[r & 1][tid], nn + i);
    mm::cp_async_commit();
  };

  for (int pass = 0; pass < sh.passes; ++pass) {
    const int c = pass * sh.per_pass + cl;  // the thread's chunk
    const bool mine = slot < sh.qf && c < sh.chunks;
    // the thread's totals over its rounds, in shared memory (its own
    // entries; the slots' rows are read after the pass's last round)
    float* acc = red + slot * 16 * sh.per_pass + cl * 8;
    if (slot < sh.qf) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = acc[8 * sh.per_pass + j] = 0.f;
    }
    stage(0);
    for (int r = 0; r < sh.rounds; ++r) {
      mm::cp_async_wait<0>();
      __syncthreads();  // round r's rows have landed; round r - 1's are read
      stage(r + 1);
      const long long q = ((long long)r * gridDim.x + blockIdx.x) * sh.qf + slot;
      if (!mine || q >= queries) continue;
      const int* nq = nn_s[r & 1] + slot * K;
      const bf16* gb = g + (q / M) * N * D + c * 8;
      const long long o = q * D + c * 8;
      const uint4 hv = __ldcs(reinterpret_cast<const uint4*>(h + o));
      const uint32_t hp[4] = {hv.x, hv.y, hv.z, hv.w};
      // the gathers of the live neighbours, all in flight; a hole's x is NaN
      uint32_t x[kMaxK][4];
      unsigned live = 0;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k >= K) break;
        const int n = nq[k];
        uint4 v = make_uint4(kNaN2, kNaN2, kNaN2, kNaN2);
        if (n >= 0) {
          v = __ldg(reinterpret_cast<const uint4*>(gb + (long long)n * D));
          live |= 1u << k;
        }
        x[k][0] = v.x;
        x[k][1] = v.y;
        x[k][2] = v.z;
        x[k][3] = v.w;
      }
      // sg in k order, x = bf16(g - h), vmax, vmin and the totals
      float sg[8], tot[8], sq[8];  // the query's sums over k
      uint32_t mx[4], mn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sg[2 * j] = sg[2 * j + 1] = tot[2 * j] = tot[2 * j + 1] = sq[2 * j] = sq[2 * j + 1] = 0.f;
        mx[j] = kNegInf2;
        mn[j] = kPosInf2;
      }
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k >= K) break;
        if (!((live >> k) & 1u)) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sg[2 * j] += lo_f(x[k][j]);
          sg[2 * j + 1] += hi_f(x[k][j]);
          const __nv_bfloat162 d = __hsub2(as_bf2(x[k][j]), as_bf2(hp[j]));
          x[k][j] = as_u32(d);
          mx[j] = as_u32(__hmax2(as_bf2(mx[j]), d));
          mn[j] = as_u32(__hmin2(as_bf2(mn[j]), d));
          const float d0 = lo_f(x[k][j]), d1 = hi_f(x[k][j]);
          tot[2 * j] += d0;
          tot[2 * j + 1] += d1;
          sq[2 * j] = fmaf(d0, d0, sq[2 * j]);  // x * x is exact: one rounding either way
          sq[2 * j + 1] = fmaf(d1, d1, sq[2 * j + 1]);
        }
      }
      // the query's totals onto the thread's: K + rounds terms deep, not K * rounds
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j] += tot[j];
        acc[8 * sh.per_pass + j] += sq[j];
      }
      // the tie bits: bit k of a pair's low / high half for its two channels
      uint32_t tmax[4] = {0u, 0u, 0u, 0u}, tmin[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k >= K) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tmax[j] |= __heq2_mask(as_bf2(x[k][j]), as_bf2(mx[j])) & (0x10001u << k);
          tmin[j] |= __heq2_mask(as_bf2(x[k][j]), as_bf2(mn[j])) & (0x10001u << k);
        }
      }
      // the outputs
      __stcs(reinterpret_cast<uint4*>(vmax_out + o), make_uint4(mx[0], mx[1], mx[2], mx[3]));
      __stcs(reinterpret_cast<uint4*>(vmin_out + o), make_uint4(mn[0], mn[1], mn[2], mn[3]));
      __stcs(reinterpret_cast<uint4*>(sg_out + o),
             make_uint4(pack_rn(sg[0], sg[1]), pack_rn(sg[2], sg[3]), pack_rn(sg[4], sg[5]),
                        pack_rn(sg[6], sg[7])));
      uint32_t bits[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bits[2 * j] = __byte_perm(tmax[j], tmin[j], 0x5410);      // channel 2j: low halves
        bits[2 * j + 1] = __byte_perm(tmax[j], tmin[j], 0x7632);  // 2j + 1: high halves
      }
      __stcs(reinterpret_cast<uint4*>(bm_out + o), make_uint4(bits[0], bits[1], bits[2], bits[3]));
      __stcs(reinterpret_cast<uint4*>(bm_out + o) + 1,
             make_uint4(bits[4], bits[5], bits[6], bits[7]));
    }
    // the block's row of partials: the slots' totals added in slot order
    __syncthreads();
    float* pb = part + (long long)blockIdx.x * 2 * D;
    for (int e = tid; e < 16 * sh.per_pass; e += kFwdThreads) {
      const int which = e / (8 * sh.per_pass), ch = pass * sh.per_pass * 8 + e % (8 * sh.per_pass);
      if (ch >= D) continue;
      float s = 0.f;
      for (int i = 0; i < sh.qf; ++i) s += red[i * 16 * sh.per_pass + e];
      pb[which * D + ch] = s;
    }
    __syncthreads();  // red and nn_s are the next pass's
  }
}

// out[j] = sum over rows i < rows of part[i, j], j < width, in a fixed
// order: run u of kSumRuns adds rows u, u + kSumRuns, ... in order; then
// lane l of a warp adds runs 4l .. 4l + 3 in order, and the warp's lanes are
// added by a shuffle tree. A block takes 8 columns (a 32-byte sector a row),
// a warp a column in the last step.
__global__ void __launch_bounds__(8 * kSumRuns)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int rows,
                    int width) {
  __shared__ float acc[kSumRuns][8];
  const int c8 = threadIdx.x & 7, run = threadIdx.x >> 3;
  const int col = blockIdx.x * 8 + c8;
  float s = 0.f;
  if (col < width) {
#pragma unroll 4
    for (int i = run; i < rows; i += kSumRuns) s += part[(long long)i * width + col];
  }
  acc[run][c8] = s;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 8) {
    float t = acc[4 * lane][warp];
#pragma unroll
    for (int i = 1; i < 4; ++i) t += acc[4 * lane + i][warp];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0 && blockIdx.x * 8 + warp < width) out[blockIdx.x * 8 + warp] = t;
  }
}

// ---------------------------------------------------------------------------
// kernel 6: routed dW on the bf16 tensor cores
// ---------------------------------------------------------------------------
constexpr int kTC = 128;     // dW rows (source channels) a block
constexpr int kTD = 128;     // dW columns a block
constexpr int kPairs = 4;    // (b, m) pairs a stage
constexpr int kStageRows = kPairs * kMaxK;  // gathered rows a stage, at most
constexpr int kLd = 128 + 8;  // a shared row: 128 values and 16 bytes of padding
constexpr int kRing = 5;      // stages of source rows and pair data in shared memory
// stages between two flushes of the stage sums into the f32 accumulators
// (ROUTED_FLUSH in ops/fused_builder.py)
constexpr int kFlush = 2;
// 2 (channels) x kTD / 32 (columns) warps, 64 x 32 each
constexpr int kRoutedThreads = 2 * kTD;
constexpr int kWarpsD = kTD / 32;
constexpr int kRowsAPass = kRoutedThreads / 16;   // source rows a load pass
constexpr int kPasses = kStageRows / kRowsAPass;  // load passes a stage

struct RoutedSmem {
  bf16 a[kRing][kStageRows][kLd];  // gathered source rows [row][channel]
  bf16 w_hi[2][kStageRows][kLd];   // a stage's weights [row][column]: bf16(w)
  bf16 w_lo[kStageRows][kLd];      // and bf16(w - w_hi)
  int bm[kRing][kPairs][kTD];      // the stages' tie bits and cotangents
  bf16 dvx[kRing][kPairs][kTD];
  bf16 dvn[kRing][kPairs][kTD];
};

struct RoutedArgs {
  const bf16* src;
  const int* nn;
  const int* bm;
  const bf16 *dvx, *dvn;
  float* part;
  int* counts;
  int N, M, K, Cin, pitch, D;
  int n_pairs, pairs_per_split;  // B * M <= 2^30
};

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const bf16 h = __float2bfloat16_rn(x);
  return (uint32_t)*reinterpret_cast<const unsigned short*>(&h);
}

__device__ __forceinline__ float bf16_value(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// The bf16 bits of w for each (max bit, min bit) of a column, and w_lo of
// w = dvx + dvn: w formed as the plain version forms it (a product by 0 or
// 1, then one f32 sum, so 0 * inf stays NaN), w_lo = bf16(w - bf16(w)),
// 0 where w is not finite.
struct Routes {
  uint32_t h00, h10, h01, h11, l11;
  __device__ __forceinline__ Routes(float vx, float vn) {
    const float zx = __fmul_rn(0.f, vx), zn = __fmul_rn(0.f, vn);
    const float w11 = __fadd_rn(vx, vn);
    h00 = bf16_bits(__fadd_rn(zx, zn));
    h10 = bf16_bits(__fadd_rn(vx, zn));
    h01 = bf16_bits(__fadd_rn(zx, vn));
    h11 = bf16_bits(w11);
    l11 = isfinite(w11) ? bf16_bits(__fsub_rn(w11, bf16_value(h11))) : 0u;
  }
  // m: the column's bits shifted by k and masked with 0x10001
  __device__ __forceinline__ uint32_t hi(uint32_t m) const {
    return m == 0x10001u ? h11 : m == 1u ? h10 : m != 0u ? h01 : h00;
  }
  __device__ __forceinline__ uint32_t lo(uint32_t m) const { return m == 0x10001u ? l11 : 0u; }
};

// A thread's part of a stage's weights: pair q, columns d and d + 1.
struct PairWeights {
  uint32_t b0, b1;
  Routes r0, r1;
  __device__ __forceinline__ PairWeights(const RoutedSmem& s, int slot, int q, int d)
      : b0((uint32_t)s.bm[slot][q][d]),
        b1((uint32_t)s.bm[slot][q][d + 1]),
        r0(pcm::to_f(s.dvx[slot][q][d]), pcm::to_f(s.dvn[slot][q][d])),
        r1(pcm::to_f(s.dvx[slot][q][d + 1]), pcm::to_f(s.dvn[slot][q][d + 1])) {}
  // w_hi of neighbours k0 .. k1 - 1 with neither tie bit into w (rows q K
  // + k, columns d, d + 1): 0, or NaN where dvx or dvn is not finite
  __device__ __forceinline__ void hi_clear(bf16 (*w)[kLd], int q, int d, int K, int k0,
                                           int k1) const {
    const uint32_t v = r0.h00 | (r1.h00 << 16);
    for (int k = k0; k < k1; ++k) *reinterpret_cast<uint32_t*>(&w[q * K + k][d]) = v;
  }
  // then w_hi of the neighbours with a tie bit (one or two a column, more
  // on ties), one bf16 store each
  __device__ __forceinline__ void hi_set(bf16 (*w)[kLd], int q, int d, int K,
                                         uint32_t kmask) const {
    for (uint32_t u = (b0 | (b0 >> 16)) & kmask; u != 0u; u &= u - 1u) {
      const int k = __ffs(u) - 1;
      *reinterpret_cast<unsigned short*>(&w[q * K + k][d]) =
          (unsigned short)r0.hi((b0 >> k) & 0x10001u);
    }
    for (uint32_t u = (b1 | (b1 >> 16)) & kmask; u != 0u; u &= u - 1u) {
      const int k = __ffs(u) - 1;
      *reinterpret_cast<unsigned short*>(&w[q * K + k][d + 1]) =
          (unsigned short)r1.hi((b1 >> k) & 0x10001u);
    }
  }
  __device__ __forceinline__ void lo(bf16 (*w)[kLd], int q, int d, int K) const {
    for (int k = 0; k < K; ++k)
      *reinterpret_cast<uint32_t*>(&w[q * K + k][d]) =
          r0.lo((b0 >> k) & 0x10001u) | (r1.lo((b1 >> k) & 0x10001u) << 16);
  }
  // whether a w_lo is not 0: a neighbour holds both bits and w_lo != +-0
  __device__ __forceinline__ bool has_lo(uint32_t kmask) const {
    return ((b0 & (b0 >> 16) & kmask) != 0u && (r0.l11 & 0x7fffu) != 0u) ||
           ((b1 & (b1 >> 16) & kmask) != 0u && (r1.l11 & 0x7fffu) != 0u);
  }
};

__global__ void __launch_bounds__(kRoutedThreads, 1)
routed_dw_kernel(const RoutedArgs a) {
  extern __shared__ __align__(16) unsigned char routed_smem[];
  RoutedSmem& s = *reinterpret_cast<RoutedSmem*>(routed_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_ctiles = (a.Cin + kTC - 1) / kTC;
  const int c0 = (int)(blockIdx.x % n_ctiles) * kTC, d0 = (int)(blockIdx.x / n_ctiles) * kTD;
  const int p_begin = (int)blockIdx.y * a.pairs_per_split;
  const int p_end = min(p_begin + a.pairs_per_split, a.n_pairs);
  const int n_stages = p_end > p_begin ? (p_end - p_begin + kPairs - 1) / kPairs : 0;
  const int K = a.K, rows = kPairs * K, steps = (rows + 15) / 16;
  const int k_per_step = (K + steps - 1) / steps;  // neighbours built a k step
  const int wm = (warp / kWarpsD) * 64, wn = (warp % kWarpsD) * 32;  // the warp's part
  // 16-channel fragments of the warp below Cin (the others are not stored)
  const int live = max(0, min(4, (a.Cin - c0 - wm + 15) / 16));

  // source rows: thread t loads 16 bytes at channel c0 + cc of the stage's
  // rows (t >> 4) + kRowsAPass j, j < kPasses
  const int cc = (tid & 15) * 8;
  // the pair in the stage of each of those rows, a byte each
  uint64_t pair_of = 0;
#pragma unroll
  for (int j = 0; j < kPasses; ++j)
    pair_of |= (uint64_t)(((tid >> 4) + kRowsAPass * j) / K) << (8 * j);
  // a row's nn entry is flat entry p K + k = (stage's first pair) K + row
  auto load_nn = [&](int st, int (&out)[kPasses]) {
    const int pb = p_begin + st * kPairs;
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int r = (tid >> 4) + kRowsAPass * j;
      const int p = pb + (int)((pair_of >> (8 * j)) & 0xffu);
      out[j] = st < n_stages && r < rows && p < p_end ? __ldg(a.nn + (long long)pb * K + r) : -1;
    }
  };
  auto issue = [&](int st, const int (&nnv)[kPasses]) {
    if (st >= n_stages) return;
    const int slot = st % kRing;
    const int pb = p_begin + st * kPairs;
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int r = (tid >> 4) + kRowsAPass * j;
      if (r >= steps * 16) continue;
      const bool in = nnv[j] >= 0 && c0 + cc < a.Cin;
      const int b = (pb + (int)((pair_of >> (8 * j)) & 0xffu)) / a.M;
      const bf16* g =
          in ? a.src + ((long long)b * a.N + nnv[j]) * a.pitch + c0 + cc : a.src;
      mm::cp_async16(&s.a[slot][r][cc], g, in ? 16 : 0);
    }
    // one 16-byte chunk a thread: bm, then dvx, then dvn
    const bool is_bm = tid < kTD;
    const int i = is_bm ? tid : (tid - kTD) % (kTD / 2);
    const int q = is_bm ? i / (kTD / 4) : i / (kTD / 8);
    const int e = is_bm ? (i % (kTD / 4)) * 4 : (i % (kTD / 8)) * 8;
    const int p = pb + q;
    const bool in = p < p_end && d0 + e < a.D;
    const long long o = (long long)p * a.D + d0 + e;
    if (is_bm)
      mm::cp_async16(&s.bm[slot][q][e], in ? a.bm + o : a.bm, in ? 16 : 0);
    else if (tid < kTD + kTD / 2)
      mm::cp_async16(&s.dvx[slot][q][e], in ? a.dvx + o : a.dvx, in ? 16 : 0);
    else
      mm::cp_async16(&s.dvn[slot][q][e], in ? a.dvn + o : a.dvn, in ? 16 : 0);
  };

  // rows rows .. 16 steps - 1 of the weights are padding: zero, never written
  for (int e = tid; e < (steps * 16 - rows) * (kTD / 2); e += kRoutedThreads) {
    const int r = rows + e / (kTD / 2), d = 2 * (e % (kTD / 2));
    *reinterpret_cast<uint32_t*>(&s.w_hi[0][r][d]) = 0u;
    *reinterpret_cast<uint32_t*>(&s.w_hi[1][r][d]) = 0u;
    *reinterpret_cast<uint32_t*>(&s.w_lo[r][d]) = 0u;
  }

  float acc[4][4][4], t[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = t[i][j][e] = 0.f;

  // the ring: stages 0 .. kRing - 2 in flight, then one more each stage
  int nn_next[kPasses];
  for (int st = 0; st + 1 < kRing; ++st) {
    load_nn(st, nn_next);
    issue(st, nn_next);
    mm::cp_async_commit();
  }
  load_nn(kRing - 1, nn_next);
  // weights: thread t forms those of pair t / (kTD / 2), columns 2 (t %
  // (kTD / 2)) and + 1
  const int wq = tid / (kTD / 2), wd = 2 * (tid % (kTD / 2));
  const uint32_t kmask = K >= 16 ? 0xffffu : (1u << K) - 1u;
  bool has_lo = false;
  if (n_stages > 0) {  // stage 0's weights
    mm::cp_async_wait<kRing - 2>();
    __syncthreads();
    const PairWeights pw(s, 0, wq, wd);
    pw.hi_clear(s.w_hi[0], wq, wd, K, 0, K);
    pw.hi_set(s.w_hi[0], wq, wd, K, kmask);
    has_lo = pw.has_lo(kmask);
  }
  int lo_stages = 0;

  for (int st = 0; st < n_stages; ++st) {
    const int slot = st % kRing, wb = st & 1;
    // stages st and st + 1 have landed; stage st's weights are built;
    // stage st - 1's tiles are consumed
    mm::cp_async_wait<kRing - 3>();
    const bool lo = __syncthreads_or(has_lo);
    if (lo) {
      const PairWeights pw(s, slot, wq, wd);
      pw.lo(s.w_lo, wq, wd, K);
      __syncthreads();
      ++lo_stages;
    }
    issue(st + kRing - 1, nn_next);
    mm::cp_async_commit();
    load_nn(st + kRing, nn_next);

    // stage st's products, and between its k steps stage st + 1's weights
    const bool next = st + 1 < n_stages;
    const PairWeights pw(s, (st + 1) % kRing, wq, wd);
    has_lo = next && pw.has_lo(kmask);
    for (int kk = 0; kk < steps; ++kk) {
      if (next)
        pw.hi_clear(s.w_hi[wb ^ 1], wq, wd, K, kk * k_per_step, min(K, (kk + 1) * k_per_step));
      // the k step's fragments, then its products (the small terms first)
      uint32_t af[4][4], bh[2][4], bl[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < live)
          mm::ldsm_x4_t(af[i], &s.a[slot][kk * 16 + ((lane >> 4) << 3) + (lane & 7)]
                                       [wm + i * 16 + (((lane >> 3) & 1) << 3)]);
      const int row = kk * 16 + (lane & 15);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {  // 8-column fragments 2 jp and 2 jp + 1
        const int col = wn + jp * 16 + ((lane >> 4) << 3);
        mm::ldsm_x4_t(bh[jp], &s.w_hi[wb][row][col]);
        if (lo) mm::ldsm_x4_t(bl[jp], &s.w_lo[row][col]);
      }
      if (lo) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < live) {
              mm::mma(t[i][2 * jp], af[i], bl[jp][0], bl[jp][1]);
              mm::mma(t[i][2 * jp + 1], af[i], bl[jp][2], bl[jp][3]);
            }
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < live) {
            mm::mma(t[i][2 * jp], af[i], bh[jp][0], bh[jp][1]);
            mm::mma(t[i][2 * jp + 1], af[i], bh[jp][2], bh[jp][3]);
          }
    }
    if (next) pw.hi_set(s.w_hi[wb ^ 1], wq, wd, K, kmask);
    if ((st + 1) % kFlush == 0) {  // the stage sums into the accumulator, rounding to nearest
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] = __fadd_rn(acc[i][j][e], t[i][j][e]);
            t[i][j][e] = 0.f;
          }
    }
  }
  mm::cp_async_wait<0>();

  if (tid == 0 && a.counts != nullptr) {
    atomicAdd(a.counts, lo_stages);
    atomicAdd(a.counts + 1, n_stages);
  }
  float* pb = a.part + (long long)blockIdx.y * a.Cin * a.D;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wm + 16 * i + (lane >> 2) + 8 * h;
      if (c >= a.Cin) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + wn + 8 * j + 2 * (lane & 3);
        const float x0 = __fadd_rn(acc[i][j][2 * h], t[i][j][2 * h]);
        const float x1 = __fadd_rn(acc[i][j][2 * h + 1], t[i][j][2 * h + 1]);
        float* o = pb + (long long)c * a.D + d;
        if (d + 1 < a.D && (uintptr_t)o % 8 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
        } else {
          if (d < a.D) o[0] = x0;
          if (d + 1 < a.D) o[1] = x1;
        }
      }
    }
}

// out[e] = sum over splits s = 0, 1, ... of part[s, e], in that order.
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, long long n,
                  int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[i * n + e];
  out[e] = s;
}

}  // namespace

extern "C" {

// Number of per-block partial rows kernel 5 writes for B clouds of M
// queries of D channels: the caller's `part` holds that many (2, D) f32 rows.
long long pcm_builder_fwd_partials(int B, int M, int D) {
  return FwdShape((long long)B * M, D).blocks;
}

// Kernel 5. g (B, N, D) and h (B, M, D) bf16, nn (B, M, K) int32 (-1 =
// hole), all contiguous on device `device`, g, h and the four outputs
// 16-byte aligned; 1 <= K <= 16, D a multiple of 8. Writes vmax, vmin, sg
// (B, M, D) bf16, bm (B, M, D) int32 and totals (2, D) f32 (total, then
// total_sq); part is f32 scratch of pcm_builder_fwd_partials(B, M, D) * 2 *
// D. Returns the first cudaError_t of its two launches that is not success.
int pcm_builder_fwd(const void* g, const void* h, const int* nn, void* vmax, void* vmin,
                    void* sg, int* bm, float* part, float* totals, int B, int N, int M, int K,
                    int D, int device, void* stream) {
  if (B < 1 || N < 1 || M < 1 || K < 1 || K > kMaxK || D < 8 || D % 8 != 0 ||
      (uintptr_t)g % 16 != 0 || (uintptr_t)h % 16 != 0 || (uintptr_t)vmax % 16 != 0 ||
      (uintptr_t)vmin % 16 != 0 || (uintptr_t)sg % 16 != 0 || (uintptr_t)bm % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long queries = (long long)B * M;
  const FwdShape sh(queries, D);
  builder_fwd_kernel<<<sh.blocks, kFwdThreads, 0, s>>>(
      (const bf16*)g, (const bf16*)h, nn, (bf16*)vmax, (bf16*)vmin, (bf16*)sg, bm, part, N, M,
      K, D, queries);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(2 * D + 7) / 8, 8 * kSumRuns, 0, s>>>(part, totals, sh.blocks, 2 * D);
  return (int)cudaGetLastError();
}

// Kernel 6. src (B, N, Cin) bf16 at row pitch `pitch` (a multiple of 8 at
// least Cin, the data 16-byte aligned; channels Cin .. pitch - 1 are never
// read into a stored entry), nn (B, M, K) int32 (-1 = hole), bm (B, M, D)
// int32, dvx and dvn (B, M, D) bf16, all on device `device`, the last four
// contiguous, bm, dvx and dvn 16-byte aligned; 1 <= K <= 16, D a multiple
// of 8, B * M <= 2^30. The B*M (b, m) pairs are cut into `splits`
// consecutive runs (a multiple of 4 pairs each, the last shorter); part is
// f32 scratch of splits * Cin * D; out (Cin, D) f32 is written. The stage
// sums are flushed into the f32 accumulators every kFlush stages of 4
// pairs. `counts`: null, or two int32 on the device
// to which the launch adds the (block, stage) tiles that ran the w_lo
// product and all tiles. Returns the first cudaError_t that is not success.
int pcm_routed_dw(const void* src, const int* nn, const int* bm, const void* dvx,
                  const void* dvn, float* part, float* out, int* counts, int B, int N, int M,
                  int K, int Cin, int pitch, int D, int splits, int device, void* stream) {
  if (B < 1 || N < 1 || M < 1 || K < 1 || K > kMaxK || Cin < 1 || D < 8 || D % 8 != 0 ||
      splits < 1 || splits > 65535 || pitch < Cin || pitch % 8 != 0 ||
      (uintptr_t)src % 16 != 0 || (uintptr_t)bm % 16 != 0 || (uintptr_t)dvx % 16 != 0 ||
      (uintptr_t)dvn % 16 != 0 || (long long)B * M > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(routed_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(RoutedSmem));
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  RoutedArgs a{(const bf16*)src, nn, bm, (const bf16*)dvx, (const bf16*)dvn, part, counts, N, M,
               K, Cin, pitch, D, 0, 0};
  a.n_pairs = B * M;
  a.pairs_per_split = ((a.n_pairs + splits - 1) / splits + kPairs - 1) / kPairs * kPairs;
  const dim3 grid(((Cin + kTC - 1) / kTC) * ((D + kTD - 1) / kTD), splits);
  routed_dw_kernel<<<grid, kRoutedThreads, sizeof(RoutedSmem), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)Cin * D;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, out, n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
