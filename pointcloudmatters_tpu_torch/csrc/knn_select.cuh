// The selection that the exact kNN kernels 2 (knn.cu), 12
// (knn_chunkskip.cu) and 13 (knn_baseline.cu) share: a query served by a
// group of S lanes of one warp, S in {1, 2, 4, 8, 16, 32}, so that a warp
// serves 32 / S queries and a small batch still fills the card.
//
// Points. A pre-pass (`records_kernel`) writes each point once as a 16-byte
// record (x, y, z, |p|^2), |p|^2 by pcm_topk::sqnorm, and each invalid point
// as (0, 0, 0, +inf). The kernels stage the records in shared memory and
// lane r of a group takes the tile's points r, r + S, r + 2S, ... (strided,
// so the S lanes of every group read S neighbouring records at once), four
// at a time (kUnroll) between two checks of the queues.
//   - No valid point's distance changes a bit: it is pcm_topk::dist2 of the
//     same eight floats as before (the record holds sqnorm's value, and
//     dist2 is round-to-nearest intrinsics throughout).
//   - No invalid point can enter, whatever its coordinates (zeros, inf,
//     NaN): its record drops them for zeros, so for a finite query dot = 0
//     and d = fmaxf((|q|^2 + inf) - 0, 0) = +inf, and a candidate enters only
//     before the row's k-th pair, whose distance is at most 1e10 (an empty
//     slot). Had the coordinates been kept, inf * 0 = NaN would have made
//     d = fmaxf(NaN, 0) = 0.
//
// The list. Each group keeps one exact list of S * R slots of (distance,
// index) pairs, ascending by the pair (pcm_topk::before: a smaller distance
// first, on equal distances the smaller index), spread over the group's
// lanes in registers, blocked: lane l holds slots l R .. l R + R - 1. R is
// the least power of two with S R >= k (and R >= 1), at most kMaxRows, so
// k = 32 needs S >= 2, k = 64 S >= 4 and k = 128 S >= 8. Empty slots hold
// (1e10, kNoIndex).
//
// Queues. A lane puts each candidate that comes before its row's k-th pair
// (slot k - 1, broadcast to the group after each merge) into its own queue
// of kQueue pairs. Before every kUnroll points a lane computes, the warp
// votes (__any_sync over the whole warp: the groups of a warp run in
// lockstep, so merging one group's queues costs the others nothing, and
// their queues empty early); if any lane could overflow, every group of the
// warp merges every queue into its list, one level at a time: each lane
// offers one queued pair (or (+inf, kNoIndex)), and
//   - with S = 1 the lane inserts it (each slot takes the candidate or its
//     predecessor's pair);
//   - with S > 1 the group sorts its S offers by a bitonic network over
//     shuffles (lane l ends with the l-th), takes slot s the smaller of its
//     pair and offer S R - 1 - s (the list's S R smallest, a bitonic
//     sequence), and sorts that by a bitonic half-cleaner (shuffles across
//     lanes, compare-exchanges across a lane's rows).
// After the first few hundred points the k-th pair is tight and merges are
// rare; the warp no longer pays an unrolled insertion for every candidate
// of any one lane.
//
// Why the result is exact on any visiting order, with ties to the smaller
// index: the list orders by the pair, and every pair is distinct (each point is visited once a query;
// only empty slots repeat, and no candidate equals them). A point p of the
// true top k has fewer than k pairs before it among all points, so it comes
// before the k-th pair of any subset of the points, and so before the row's
// k-th pair at any time (a stale one from the last merge included): it is
// queued, merged, and never pushed past slot k - 1. So the first k slots
// end as the k smallest pairs.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "knn_topk.cuh"

namespace pcm_select {

using pcm_topk::kBig;
using pcm_topk::kNoIndex;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kQueue = 8;     // pairs a lane's queue holds
constexpr int kUnroll = 4;    // points a lane computes between two votes
constexpr int kMaxRows = 16;  // list slots a lane holds at most
constexpr int kRecordThreads = 256;
constexpr int kBoxFloats = 8;  // lo x, y, z, hi x, y, z, largest |p|^2, valid points

// 2^-18: the relative margin by which a box bound is lowered (box_bound)
constexpr float kMargin = 3.814697265625e-06f;

// the lane-group sizes the kernels take
__host__ __device__ constexpr bool valid_group(int S) {
  return S == 1 || S == 2 || S == 4 || S == 8 || S == 16 || S == 32;
}

// list slots a lane holds for k results in groups of S lanes: the least
// power of two K >= k, spread over S lanes (at least one slot a lane)
inline int list_rows(int k, int S) {
  int K = 1;
  while (K < k) K <<= 1;
  return K > S ? K / S : 1;
}

__device__ __forceinline__ float4 invalid_record() {
  return make_float4(0.f, 0.f, 0.f, INFINITY);
}

// Records of B clouds of N points, in chunks of `chunk` points: grid
// (ceil(N / chunk), B), kRecordThreads threads. Position j of a cloud holds
// point (j * perm) mod N (0 < perm < N coprime to N; perm = 0: point j),
// and with `idx` that point's index. With `boxes` (perm = 0 only), also
// each chunk's box of its valid points (kBoxFloats floats a (cloud, chunk):
// the lows, the highs, the largest |p|^2, the number of valid points; a
// chunk without one has lows +inf, highs -inf).
__global__ void __launch_bounds__(kRecordThreads)
records_kernel(const float* __restrict__ p, const uint8_t* __restrict__ mask,
               float4* __restrict__ rec, int* __restrict__ idx, float* __restrict__ boxes,
               int N, int chunk, int perm) {
  __shared__ float part[kRecordThreads / 32][kBoxFloats];
  const int b = blockIdx.y, c = blockIdx.x;
  const int base = c * chunk, cnt = min(chunk, N - base);
  const float* pb = p + (size_t)b * N * 3;
  const uint8_t* mb = mask + (size_t)b * N;
  float4* rb = rec + (size_t)b * N + base;
  // lows, negated highs, negated largest |p|^2, negated count: all by min
  float v[kBoxFloats] = {INFINITY, INFINITY, INFINITY, INFINITY,
                         INFINITY, INFINITY, INFINITY, 0.f};
  for (int j = threadIdx.x; j < cnt; j += kRecordThreads) {
    const int src = perm ? (int)(((long long)(base + j) * perm) % N) : base + j;
    float4 r = invalid_record();
    if (mb[src]) {
      const float x = pb[3 * src], y = pb[3 * src + 1], z = pb[3 * src + 2];
      r = make_float4(x, y, z, pcm_topk::sqnorm(x, y, z));
      v[0] = fminf(v[0], x);
      v[1] = fminf(v[1], y);
      v[2] = fminf(v[2], z);
      v[3] = fminf(v[3], -x);
      v[4] = fminf(v[4], -y);
      v[5] = fminf(v[5], -z);
      v[6] = fminf(v[6], -r.w);
      v[7] -= 1.f;  // exact: at most 2^24 points
    }
    rb[j] = r;
    if (idx != nullptr) idx[(size_t)b * N + base + j] = src;
  }
  if (boxes == nullptr) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < kBoxFloats; ++f) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(kFull, v[f], o);
      v[f] = f == 7 ? v[f] + w : fminf(v[f], w);
    }
    if (lane == 0) part[warp][f] = v[f];
  }
  __syncthreads();
  if (threadIdx.x < kBoxFloats) {
    const int f = threadIdx.x;
    float s = part[0][f];
    for (int w = 1; w < kRecordThreads / 32; ++w)
      s = f == 7 ? s + part[w][f] : fminf(s, part[w][f]);
    // highs, |p|^2 and the count back to their signs
    boxes[((size_t)b * gridDim.x + c) * kBoxFloats + f] = f < 3 ? s : -s;
  }
}

// A lower bound of every distance that pcm_topk::dist2 returns for a query
// of the tile box `t` (lows, highs, largest |q|^2 of its queries) and a
// valid point of the chunk box `bx` (records_kernel's), capped at 1e10;
// 1e10 for a chunk without a valid point.
//
// Why it never exceeds such a distance. Let u = 2^-24 and D = |q - p|^2
// exactly. dist2 rounds |q|^2 and |p|^2 (each within 3.0001 u of the exact
// value, sums of non-negative terms), q.p (within 3.0001 u |q||p| <= 1.5001
// u (|q|^2 + |p|^2)), their sum and the difference (u each), and the clamp
// at 0 only raises it: dist2 >= D - 9.01 u (|q|^2 + |p|^2). The box gives D
// >= G, G the exact sum over the axes of the squared gap max(0, q_lo -
// p_hi, p_lo - q_hi); `lb`, G in float, is at most G (1 + 6u) (each gap
// rounded once, squared, three non-negative terms summed), so G >= lb - 6u
// lb. With |q|^2 <= q2max (1 + 3.01 u) and the same for p, dist2 >= lb -
// 16 u (lb + q2max + p2max) (rounding the margin costs a few u of it more,
// covered by taking 2^-18 = 64 u). Far from the origin (coordinates near
// 1e3, |q|^2 ~ 3e6) the margin is ~11, and so is dist2's own error: the
// bound stays true and prunes less.
__device__ __forceinline__ float box_bound(const float* t, const float* bx) {
  if (bx[7] == 0.f) return kBig;
  float lb = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float gap = fmaxf(fmaxf(__fsub_rn(t[a], bx[3 + a]), __fsub_rn(bx[a], t[3 + a])), 0.f);
    lb = __fadd_rn(lb, __fmul_rn(gap, gap));
  }
  const float margin = __fmul_rn(kMargin, __fadd_rn(__fadd_rn(lb, t[6]), bx[6]));
  return fminf(__fsub_rn(lb, margin), kBig);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One query's list, queue and admission threshold, in a group of S lanes
// with R list slots a lane. Every member function is called by all 32
// lanes of the warp together (the shuffles and votes take the full mask).
template <int S, int R>
struct GroupSelect {
  static_assert(valid_group(S) && R >= 1 && R <= kMaxRows, "unsupported group shape");
  float ld[R];  // slots lane R .. lane R + R - 1 of the group's list
  int li[R];
  float qd[kQueue];  // this lane's queue, entries 0 .. cnt - 1, the newest first
  int qi[kQueue];
  int cnt;
  float td;  // the row's k-th pair, or (-inf, -1) for a row past M
  int ti;
  int lane;  // in the group
  int kth_lane, kth_row;
  bool active;

  template <typename T>
  __device__ __forceinline__ static T bcast(T v, int src) {
    if constexpr (S == 1) return v;
    else return __shfl_sync(kFull, v, src, S);
  }

  __device__ __forceinline__ void init(int lane_in_group, int k, bool is_active) {
    lane = lane_in_group;
    kth_lane = (k - 1) / R;
    kth_row = (k - 1) % R;
    active = is_active;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      ld[j] = kBig;
      li[j] = kNoIndex;
    }
    cnt = 0;
    refresh();
  }

  // the admission threshold: slot k - 1, by selects over the rows written as
  // PTX `selp` (a select loop in C++ is turned into an indexed load, which
  // moves the whole list to local memory)
  __device__ __forceinline__ void refresh() {
    float v = ld[0];
    int w = li[0];
#pragma unroll
    for (int j = 1; j < R; ++j) {
      asm("{\n .reg .pred p;\n setp.eq.s32 p, %2, %3;\n selp.f32 %0, %1, %0, p;\n}"
          : "+f"(v) : "f"(ld[j]), "r"(j), "r"(kth_row));
      asm("{\n .reg .pred p;\n setp.eq.s32 p, %2, %3;\n selp.b32 %0, %1, %0, p;\n}"
          : "+r"(w) : "r"(li[j]), "r"(j), "r"(kth_row));
    }
    v = bcast(v, kth_lane);
    w = bcast(w, kth_lane);
    td = active ? v : -INFINITY;
    ti = active ? w : -1;
  }

  // the queue is a shift register (entry 0 the newest), indexed only by
  // constants, so that it stays in registers
  __device__ __forceinline__ void push(float d, int i) {
    if (pcm_topk::before(d, i, td, ti)) {
#pragma unroll
      for (int t = kQueue - 1; t > 0; --t) {
        qd[t] = qd[t - 1];
        qi[t] = qi[t - 1];
      }
      qd[0] = d;
      qi[0] = i;
      ++cnt;
    }
  }

  // whether a lane of the warp could overflow within the next kUnroll points
  __device__ __forceinline__ bool must_merge() const {
    return __any_sync(kFull, cnt > kQueue - kUnroll);
  }

  // (S = 1) the lane's candidate (cd, ci) into its list: slot s keeps its
  // pair if that is before the candidate, else takes the candidate if slot
  // s - 1's pair is before it (or s = 0), else slot s - 1's pair. A
  // candidate (+inf, kNoIndex) changes nothing.
  __device__ __forceinline__ void insert(float cd, int ci) {
    float pd = 0.f;
    int pi = 0;
    bool prev_before = true;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float od = ld[j];
      const int oi = li[j];
      const bool b = pcm_topk::before(od, oi, cd, ci);
      if (!b) {
        ld[j] = prev_before ? cd : pd;
        li[j] = prev_before ? ci : pi;
      }
      pd = od;
      pi = oi;
      prev_before = b;
    }
  }

  // compare-exchange of this lane's (d, i) with the pair (od, oi) of its
  // partner: keep the earlier pair if `keep_min`, else the later one
  __device__ __forceinline__ static void exchange(float& d, int& i, float od, int oi,
                                                  bool keep_min) {
    const bool other_first = pcm_topk::before(od, oi, d, i);
    if (keep_min ? other_first : pcm_topk::before(d, i, od, oi)) {
      d = od;
      i = oi;
    }
  }

  // the group's S offers (cd, ci), one a lane, into the list
  __device__ __forceinline__ void merge_offers(float cd, int ci) {
    if constexpr (S == 1) {
      insert(cd, ci);
    } else {
      // sort the offers ascending: lane l ends with the l-th
#pragma unroll
      for (int size = 2; size <= S; size <<= 1) {
#pragma unroll
        for (int stride = size / 2; stride > 0; stride >>= 1) {
          const float od = __shfl_xor_sync(kFull, cd, stride, S);
          const int oi = __shfl_xor_sync(kFull, ci, stride, S);
          exchange(cd, ci, od, oi, ((lane & stride) == 0) == ((lane & size) == 0));
        }
      }
      // slot s takes the smaller of its pair and offer S R - 1 - s: the list's
      // S R smallest pairs, ascending then descending
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int src = S * R - 1 - (lane * R + j);
        const float od = __shfl_sync(kFull, cd, src & (S - 1), S);
        const int oi = __shfl_sync(kFull, ci, src & (S - 1), S);
        if (src < S) exchange(ld[j], li[j], od, oi, true);
      }
      // a bitonic half-cleaner over the S R slots sorts them
#pragma unroll
      for (int stride = S * R / 2; stride >= R; stride >>= 1) {
        const int lanes = stride / R;
        const bool lower = (lane & lanes) == 0;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float od = __shfl_xor_sync(kFull, ld[j], lanes, S);
          const int oi = __shfl_xor_sync(kFull, li[j], lanes, S);
          exchange(ld[j], li[j], od, oi, lower);
        }
      }
#pragma unroll
      for (int stride = R / 2; stride > 0; stride >>= 1) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if ((j & stride) == 0) {
            const float lo_d = ld[j], hi_d = ld[j + stride];
            const int lo_i = li[j], hi_i = li[j + stride];
            if (pcm_topk::before(hi_d, hi_i, lo_d, lo_i)) {
              ld[j] = hi_d;
              li[j] = hi_i;
              ld[j + stride] = lo_d;
              li[j + stride] = lo_i;
            }
          }
        }
      }
    }
  }

  // every queue of the warp into its group's list, a level at a time (each
  // lane offers its newest pair and shifts its queue down), then a new
  // threshold
  __device__ __forceinline__ void merge() {
#pragma unroll 1
    while (__any_sync(kFull, cnt > 0)) {
      const bool has = cnt > 0;
      const float cd = has ? qd[0] : INFINITY;
      const int ci = has ? qi[0] : kNoIndex;
#pragma unroll
      for (int t = 0; t + 1 < kQueue; ++t) {
        qd[t] = qd[t + 1];
        qi[t] = qi[t + 1];
      }
      cnt = has ? cnt - 1 : 0;
      merge_offers(cd, ci);
    }
    refresh();
  }

  // the first k slots: distances, and indices (-1 where a slot holds 1e10
  // or more)
  __device__ __forceinline__ void store(int32_t* out_idx, float* out_d2, int k) const {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int s = lane * R + j;
      if (s < k) {
        out_d2[s] = ld[j];
        out_idx[s] = ld[j] >= kBig ? -1 : li[j];
      }
    }
  }
};

template <int S, int R>
struct Shape {
  static constexpr int kS = S;
  static constexpr int kR = R;
};

template <int S, int R, typename F>
cudaError_t call_shape(F& f) {
  if constexpr (S * R <= pcm_topk::kMaxK && R <= kMaxRows) return f(Shape<S, R>{});
  else return cudaErrorInvalidValue;
}

template <int S, typename F>
cudaError_t with_rows(int R, F& f) {
  switch (R) {
    case 1: return call_shape<S, 1>(f);
    case 2: return call_shape<S, 2>(f);
    case 4: return call_shape<S, 4>(f);
    case 8: return call_shape<S, 8>(f);
    case 16: return call_shape<S, 16>(f);
    default: return cudaErrorInvalidValue;
  }
}

// Calls `f(Shape<S, R>{})` for groups of S lanes and k results (1 <= k <=
// 128), R = list_rows(k, S). Returns f's cudaError_t, or
// cudaErrorInvalidValue for an S the kernels do not take or an R above
// kMaxRows.
template <typename F>
cudaError_t with_shape(int S, int k, F f) {
  if (k < 1 || k > pcm_topk::kMaxK || !valid_group(S)) return cudaErrorInvalidValue;
  const int R = list_rows(k, S);
  if (R > kMaxRows) return cudaErrorInvalidValue;
  switch (S) {
    case 1: return with_rows<1>(R, f);
    case 2: return with_rows<2>(R, f);
    case 4: return with_rows<4>(R, f);
    case 8: return with_rows<8>(R, f);
    case 16: return with_rows<16>(R, f);
    default: return with_rows<32>(R, f);
  }
}

}  // namespace pcm_select
