// Flash attention on the bf16 tensor cores: kernels 9 (the forward, o and
// the row statistics l and m), 10 (dK, dV) and 11 (dQ, and the bias
// gradient ds) at bf16, and what they share with the f32 kernels of
// flash_attention.cu (the launch arguments, the mask value, the causal
// skips, the Philox bits), whose C entries `pcm_flash_fwd`,
// `pcm_flash_bwd_dkv` and `pcm_flash_bwd_dq` dispatch here when the element
// type is bf16. The f32 kernels are in flash_attention.cu (kernels 9, 10
// and 11 in 3xTF32 on the TF32 tensor cores, f32_mma.cuh).
//
// Replaces the TPU kernels of pointcloudmatters_tpu/ops/flash_attention.py
// at bf16: `_flash_attention_impl` (:697; pallas_call :869, bodies
// `_flash_attention_kernel_single_batch` :430 and the single-step variant
// :585), `_flash_attention_bwd_dkv` (:1068; :1253, body
// `_flash_attention_dkv_kernel` :907) and `_flash_attention_bwd_dq` (:1427;
// :1601, body :1278). Their arithmetic is kept exactly as flash_attention.cu
// states it: s = (q k^T + ab) * sm_scale in f32 with q not pre-scaled, the
// mask value added where segment ids differ or a key is after the query
// under `causal`, pairs of causal TPU-grid tiles above the diagonal not
// visited (logit -inf, weight 0). Forward, block_k block by block_k block:
// the block's row max m_next = max(m_prev, rowmax(s)), p = exp(s - m_next),
// l_next = rowsum(p) + exp(m_prev - m_next) l_prev over the undropped p,
// bf16(p D) before P V and the accumulator kept normalised; the single-step
// variant (block_k >= Lk) takes l first and p / l. Backward:
// p = exp(s - m) * (1 / l) from the forward's f32 row statistics,
// p_dropped = bf16(p D) before dV += p_dropped^T dO, dP = dO v^T,
// dS = bf16(((dP D) - di) * p * sm_scale) before dK += dS^T q and
// dQ += dS k, f32 accumulators and each output rounded once. Every product
// takes bf16 operands with f32 sums, as the TPU kernels' dots do
// (`preferred_element_type=jnp.float32`, :571-573, :1023-1024, :1045,
// :1397-1400), and the rounding points are exactly where the mma needs bf16
// operands.
//
// What bounds them on an H100: the tensor cores in principle (4 B H Lq Lk dh
// flops forward, 6 with its second S; 8 for dK/dV, 6 for dQ; at 989
// TFLOP/s bf16 dense). In practice `mma.sync` fed from shared memory, exp
// and the score function on the FP32 pipes and Philox on the integer pipes
// (one call a four scores, each score drawn once a kernel, for every one of
// the B H (batch, head) pairs that share the mask) keep them several times
// above it.
//
// What the design does about it, as attention_mma.cuh does for the oneshot
// backward (its fragment helpers, tiles and cp.async ring are reused):
// - Every product is `mma.sync.m16n8k16` bf16 -> f32 on bf16 shared tiles
//   padded by 16 bytes a row, read by `ldmatrix` (`.trans` for the B
//   operands dO, q and k). Streamed tiles come through `cp.async` into a
//   two-stage ring; views whose rows are not 16-byte aligned load by plain
//   loads.
// - A block is 4 warps x 16 rows = 64 rows. Forward: one block a
//   (64-query tile, batch * head); its q rows stay A fragments across the
//   walk over the block_k blocks it visits: per block a pass of S and the
//   row max over the 64-key tiles the block overlaps, then S again with p,
//   its row sum and P V (the single step: a pass for l between them).
//   S is computed again, not staged: a 64 x 512 block of f32 scores would
//   take 128 KiB of shared memory and leave room for one block an SM. The
//   normalised update is folded into acc: scaled by l_corr once m_next is
//   known, P V added, times 1 / l_next at the block's end (f32 rounding
//   apart, the TPU's rule, with one accumulator instead of two, which at
//   dh = 128 would not fit the registers). dK/dV: one block a (64-key
//   tile, batch * head), looping over the query tiles; it computes
//   S^T = K Q^T and dP^T = V dO^T, so that p_dropped^T and dS^T go from C
//   fragments straight into the A fragments of dV += p_dropped^T dO and
//   dK += dS^T Q. Each query tile's m, 1 / l, di and segment ids stream
//   with its Q and dO tiles. dQ: one block a (64-query tile, batch * head),
//   looping over the key tiles; its q and dO rows stay A fragments across
//   the loop, dS goes from C to A fragment for dQ += dS K, and the bias
//   gradient is stored from the rounded fragment.
// - Scores are worked on sub-tiles of 16 (dK/dV) or 32 (dQ) columns, which
//   keeps dK and dV (dh / 2 floats each a thread) or dQ in registers; at
//   dh = 64 both kernels are held to 128 registers, four blocks an SM.
// - The score function is applied to a whole sub-tile at once, each
//   condition that holds for the whole launch (a bias, segment ids,
//   `causal`, dropout) tested once outside the per-score code, which stays
//   straight-line: per-score branches kept the compiler from overlapping the
//   exps of neighbouring scores.
// - Causal: the TPU-grid tiles a 64 x 64 tile touches are decided pair by
//   pair by the score function; a 64 x 64 tile none of whose pairs is
//   visited is not loaded at all. The visited tiles of a key tile are a
//   suffix of the query tiles, those of a query tile a prefix of the key
//   tiles, so the ring streams a contiguous range.
// - Dropout bits are flash's (key (seed, 0), counter (col / 4, row, 1, 0),
//   one mask for every batch item and head), drawn in the mma layouts as
//   attention_mma.cuh's keep_rows / keep_keys draw the oneshot bits: a lane
//   pair shares two calls in dQ's query-row layout, four lanes transpose
//   four calls by xor shuffles in dK/dV's key-row layout.
// - No atomics: every output element is summed by one thread in a fixed
//   order, so two launches give identical bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "elem.cuh"
#include "philox.cuh"

namespace pcm {
namespace flash {

// DEFAULT_MASK_VALUE: -0.7 times the f32 maximum, in double, then rounded
// to f32, as the TPU kernel adds it to its f32 scores
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);
constexpr int kTileRows = 64;  // query rows of the tile `tile_skipped` tests

using Strides = attn_mma::Strides;

// One launch's arguments; the element pointers are of type T (float or
// bf16), `ab` and `ds` contiguous (B, H, Lq, Lk), l, m and di contiguous
// (B, H, Lq) f32, the segment ids contiguous (B, Lq) and (B, Lk) int32.
struct Args {
  const void *q, *k, *v, *ab, *dout;
  const int *seg_q, *seg_kv;
  void *o, *dq, *dk, *dv, *ds;
  float *l, *m;
  const float* di;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int H, Lq, Lk, causal, bq, bk;
  float scale;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int dropout;
  int unused[2];  // keeps the offset of the parameter after Args in the kernels that take one
};

// Keep bits of key columns 4g .. 4g+3 of query row `row`, every batch item
// and head alike.
__device__ __forceinline__ uint4 flash_keep_bits4(uint32_t seed, int row, int g) {
  return pcm::philox4x32_10(make_uint4((uint32_t)g, (uint32_t)row, 1u, 0u),
                            make_uint2(seed, 0u));
}

// The last row of `row`'s block_q tile: the tile at key column c is visited
// iff that row exceeds the first column of c's block_k tile.
__device__ __forceinline__ int last_row(int row, int bq) { return (row / bq + 1) * bq - 1; }

// True when the causal kernels visit no pair of the 64x64 tile at (q0, k0).
__device__ __forceinline__ bool tile_skipped(const Args& a, int q0, int k0) {
  if (!a.causal) return false;
  return last_row(min(q0 + kTileRows, a.Lq) - 1, a.bq) <= (k0 / a.bk) * a.bk;
}

// ---- the bf16 backward on the tensor cores ------------------------------------

namespace mm = attn_mma;

// Keep bits of a C fragment in dQ's query-row layout: rows `row` and row + 8
// (queries), columns c0 and c0 + 1 (keys, c0 even); mm::keep_rows with
// flash's bits.
__device__ __forceinline__ void keep_rows(uint32_t (&k)[4], uint32_t seed, int row, int c0) {
  const int odd = threadIdx.x & 1;
  const uint4 w = flash_keep_bits4(seed, row + (odd ? 8 : 0), c0 >> 2);
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  k[0] = odd ? r0 : w.x;  // row, c0
  k[1] = odd ? r1 : w.y;  // row, c0 + 1
  k[2] = odd ? w.z : r0;  // row + 8, c0
  k[3] = odd ? w.w : r1;  // row + 8, c0 + 1
}

// Keep bits of a C fragment in dK/dV's key-row layout: rows `key` and
// key + 8 (keys; the warp's first key a multiple of 16), columns q and
// q + 1 (queries); mm::keep_keys with flash's bits. k[e] is the bit of
// query q + (e & 1), key key + 8 (e >> 1).
__device__ __forceinline__ void keep_keys(uint32_t (&k)[4], uint32_t seed, int key, int q) {
  const int j = (threadIdx.x >> 2) & 3;  // key % 4
  const uint4 w = flash_keep_bits4(seed, q + (j & 1), ((key - j) >> 2) + 2 * (j >> 1));
  uint32_t v[4] = {w.x, w.y, w.z, w.w};
  mm::xor_permute(v, j);  // v[t] = word j ^ t of call j: what lane j ^ t needs
  k[0] = v[0];
  k[1] = __shfl_xor_sync(0xffffffffu, v[1], 4);
  k[2] = __shfl_xor_sync(0xffffffffu, v[2], 8);
  k[3] = __shfl_xor_sync(0xffffffffu, v[3], 12);
  mm::xor_permute(k, j);  // k[e] = word j of call e
}

// The logits of the scores s[j][e] (the C fragments of a 16 x 8 NT
// product) in place: (s + ab) * sm_scale, the mask value added where segment
// ids differ or a key is after its query under `causal`, and -inf for a
// pair out of range or in a causal TPU-grid tile not visited, with each
// condition that is the same for the whole block (a bias, segment ids,
// `causal`) tested once for all the fragments, so that the per-element work
// stays straight-line code the compiler can interleave. pair(j, e) gives the
// element's query row, key column, query segment id and key segment id
// (x, y, z, w). T is the bias's element type.
template <int NT, typename T = bf16, class Pair>
__device__ __forceinline__ void logits(const Args& a, long long bh, float (&s)[NT][4],
                                       Pair pair) {
  if (a.ab != nullptr) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int4 p = pair(j, e);
        if (p.x < a.Lq && p.y < a.Lk)
          s[j][e] = __fadd_rn(s[j][e], to_f(((const T*)a.ab)[(bh * a.Lq + p.x) * a.Lk + p.y]));
      }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], a.scale);
  if (a.seg_q != nullptr || a.causal) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int4 p = pair(j, e);
        if ((a.seg_q != nullptr && p.z != p.w) || (a.causal && p.y > p.x))
          s[j][e] = __fadd_rn(s[j][e], kMaskValue);
        if (a.causal && last_row(p.x, a.bq) <= (p.y / a.bk) * a.bk) s[j][e] = -INFINITY;
      }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int4 p = pair(j, e);
      if (p.x >= a.Lq || p.y >= a.Lk) s[j][e] = -INFINITY;
    }
}

// p and dS of one score from its logit x and product dP: p = exp(x - m) / l
// (0 where x is -inf), D the dropout scale (inv_keep or 0; 1 without
// dropout, which multiplies exactly), dS = ((dP D) - di) p sm_scale, 0 where
// p is 0. Returns p D in `pd`.
__device__ __forceinline__ float score_ds(float x, float dp, float m, float inv_l, float di,
                                          float d, float scale, float& pd) {
  const float p = x == -INFINITY ? 0.f : __fmul_rn(expf(x - m), inv_l);
  pd = __fmul_rn(p, d);
  return p == 0.f ? 0.f : __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(dp, d), di), p), scale);
}

// Score columns a sub-tile in dK/dV (dQ takes attention_mma.cuh's 32): its
// two 16 x 16 score and dP fragments leave room in 128 registers for dK and
// dV at dh = 64 without a spill, four blocks an SM.
constexpr int kDkvSub = 16;

// Shared memory of both kernels: two 64-row tiles held for the whole block,
// two two-stage rings of streamed tiles, and two stages of per-row terms
// (dK/dV: m, 1 / l, di and the segment id of 64 queries; dQ: the segment
// ids of 64 keys).
template <int DH>
__host__ __device__ constexpr size_t bwd_smem() {
  return (size_t)(2 * mm::kRows + 4 * mm::kTile) * mm::ld<DH>() * sizeof(bf16) +
         2 * 4 * mm::kTile * sizeof(float);
}

// One block a (batch, head, 64-key tile), looping over the query tiles it
// visits: S^T = K Q^T and dP^T = V dO^T, then dV += p_dropped^T dO and
// dK += dS^T Q. `vec`: q, k, v and dout rows 16-byte aligned.
template <int DH>
__global__ void __launch_bounds__(mm::kThreads, DH == 64 ? 4 : 1) dkv_kernel(Args a, int vec) {
  constexpr int LD = mm::ld<DH>();
  constexpr int T = mm::kTile;
  constexpr int NT = kDkvSub / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + mm::kRows * LD;
  bf16* Qs = Vs + mm::kRows * LD;  // two stages
  bf16* dOs = Qs + 2 * T * LD;     // two stages
  float* rows = reinterpret_cast<float*>(dOs + 2 * T * LD);  // [stage][m, 1/l, di, id][64]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * mm::kRows;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const bf16* qb = (const bf16*)a.q + b * a.qs.b + h * a.qs.h;
  const bf16* dob = (const bf16*)a.dout + b * a.dos.b + h * a.dos.h;
  const int key = k0 + warp * 16 + (lane >> 2);  // and key + 8
  const int cq = 2 * (lane & 3);
  const long long sb = (long long)bh * a.Lq;
  // the keep threshold and the scale of a kept score; without dropout every
  // score is kept (its bits stay 0) and scaled by 1
  const uint32_t thr = a.dropout ? a.threshold : 0u;
  const float kept = a.dropout ? a.inv_keep : 1.f;
  int skv[2];  // the segment ids of keys key and key + 8 (0 past Lk or without ids)
#pragma unroll
  for (int i = 0; i < 2; ++i)
    skv[i] = a.seg_kv != nullptr && key + 8 * i < a.Lk
                 ? a.seg_kv[(long long)b * a.Lk + key + 8 * i] : 0;

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // the row terms of query tile q0 into stage st, by plain loads (0 past Lq)
  auto load_rows = [&](int st, int q0) {
    float* sp = rows + st * 4 * T;
    int* ids = reinterpret_cast<int*>(sp + 3 * T);
    for (int r = threadIdx.x; r < T; r += mm::kThreads) {
      const bool in = q0 + r < a.Lq;
      sp[r] = in ? a.m[sb + q0 + r] : 0.f;
      sp[T + r] = in ? 1.0f / a.l[sb + q0 + r] : 0.f;
      sp[2 * T + r] = in ? a.di[sb + q0 + r] : 0.f;
      ids[r] = a.seg_q != nullptr && in ? a.seg_q[(long long)b * a.Lq + q0 + r] : 0;
    }
  };

  // under `causal` the query tiles this key tile visits are a suffix
  const int n_qt = (a.Lq + T - 1) / T;
  int qt0 = 0;
  while (qt0 < n_qt && tile_skipped(a, qt0 * T, k0)) ++qt0;
  if (qt0 < n_qt) {
    mm::load_tile<DH>(Ks, (const bf16*)a.k + b * a.ks.b + h * a.ks.h, a.ks.l, k0, a.Lk, vec);
    mm::load_tile<DH>(Vs, (const bf16*)a.v + b * a.vs.b + h * a.vs.h, a.vs.l, k0, a.Lk, vec);
    mm::load_tile<DH>(Qs, qb, a.qs.l, qt0 * T, a.Lq, vec);
    mm::load_tile<DH>(dOs, dob, a.dos.l, qt0 * T, a.Lq, vec);
    load_rows(0, qt0 * T);
    mm::cp_async_commit();
  }
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    const bf16* Qt = Qs + st * T * LD;
    const bf16* dOt = dOs + st * T * LD;
    if (qt + 1 < n_qt) {
      mm::load_tile<DH>(Qs + (st ^ 1) * T * LD, qb, a.qs.l, (qt + 1) * T, a.Lq, vec);
      mm::load_tile<DH>(dOs + (st ^ 1) * T * LD, dob, a.dos.l, (qt + 1) * T, a.Lq, vec);
      load_rows(st ^ 1, (qt + 1) * T);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const float* sm_m = rows + st * 4 * T;
    const float* sm_r = sm_m + T;
    const float* sm_d = sm_r + T;
    const int* sm_id = reinterpret_cast<const int*>(sm_d + T);
    const int q0 = qt * T;
#pragma unroll 1
    for (int sc = 0; sc < T; sc += kDkvSub) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mm::mma_abt_s<DH, NT>(s, Ks, warp * 16, Qt, sc);    // S^T
      mm::mma_abt_s<DH, NT>(dp, Vs, warp * 16, dOt, sc);  // dP^T
      logits<NT>(a, bh, s, [&](int j, int e) {
        const int qc = sc + 8 * j + cq + (e & 1);  // query column in the tile
        return make_int4(q0 + qc, key + (e >> 1) * 8, sm_id[qc], skv[e >> 1]);
      });
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = sc + 8 * j + cq;  // query column in the tile
        uint32_t keep[4] = {0u, 0u, 0u, 0u};
        if (a.dropout) keep_keys(keep, a.seed, key, q0 + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c + (e & 1);
          const float d = keep[e] >= thr ? kept : 0.f;
          dp[j][e] = score_ds(s[j][e], dp[j][e], sm_m[qc], sm_r[qc], sm_d[qc], d, a.scale,
                              s[j][e]);
        }
      }
      uint32_t pf[NT / 2][4], dsf[NT / 2][4];
      mm::to_a_frags<NT>(pf, s);   // p_dropped rounded to bf16
      mm::to_a_frags<NT>(dsf, dp);  // dS rounded to bf16
      mm::mma_pv<DH, NT / 2>(dv, pf, dOt, sc);
      mm::mma_pv<DH, NT / 2>(dk, dsf, Qt, sc);
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

  bf16* dkb = (bf16*)a.dk + b * a.dks.b + h * a.dks.h;
  bf16* dvb = (bf16*)a.dv + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = key + (e >> 1) * 8;
      if (r < a.Lk) {
        dkb[(long long)r * a.dks.l + c + (e & 1)] = __float2bfloat16_rn(dk[j][e]);
        dvb[(long long)r * a.dvs.l + c + (e & 1)] = __float2bfloat16_rn(dv[j][e]);
      }
    }
  }
}

// One block a (batch, head, 64-query tile), looping over the key tiles it
// visits: S = Q K^T and dP = dO V^T, then dQ += dS K, and the rounded dS
// into `ds` when a bias was given. `vec` as for dkv_kernel.
template <int DH>
__global__ void __launch_bounds__(mm::kThreads, DH == 64 ? 4 : 1) dq_kernel(Args a, int vec) {
  constexpr int LD = mm::ld<DH>();
  constexpr int T = mm::kTile;
  constexpr int NT = mm::kSub / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + mm::kRows * LD;
  bf16* Ks = dOs + mm::kRows * LD;  // two stages
  bf16* Vs = Ks + 2 * T * LD;       // two stages
  int* kids = reinterpret_cast<int*>(Vs + 2 * T * LD);  // [stage][64] key segment ids

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * mm::kRows;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const bf16* kb = (const bf16*)a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = (const bf16*)a.v + b * a.vs.b + h * a.vs.h;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int cq = 2 * (lane & 3);

  // the keep threshold and the scale of a kept score; without dropout every
  // score is kept (its bits stay 0) and scaled by 1
  const uint32_t thr = a.dropout ? a.threshold : 0u;
  const float kept = a.dropout ? a.inv_keep : 1.f;
  // m, 1 / l, di and the segment id of rows row and row + 8 (0 past Lq)
  float m[2], inv_l[2], di[2];
  int sq[2];
  const long long sb = (long long)bh * a.Lq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    const bool in = r < a.Lq;
    m[i] = in ? a.m[sb + r] : 0.f;
    inv_l[i] = in ? 1.0f / a.l[sb + r] : 0.f;
    di[i] = in ? a.di[sb + r] : 0.f;
    sq[i] = a.seg_q != nullptr && in ? a.seg_q[(long long)b * a.Lq + r] : 0;
  }
  // the key tiles' segment ids into stage st, by plain loads (0 past Lk)
  auto load_ids = [&](int st, int k0) {
    for (int r = threadIdx.x; r < T; r += mm::kThreads)
      kids[st * T + r] = a.seg_kv != nullptr && k0 + r < a.Lk
                             ? a.seg_kv[(long long)b * a.Lk + k0 + r] : 0;
  };

  // under `causal` the key tiles this query tile visits are a prefix (the
  // first is always visited: block_q >= 2)
  int n_kt = (a.Lk + T - 1) / T;
  while (n_kt > 1 && tile_skipped(a, q0, (n_kt - 1) * T)) --n_kt;
  mm::load_tile<DH>(Qs, (const bf16*)a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, vec);
  mm::load_tile<DH>(dOs, (const bf16*)a.dout + b * a.dos.b + h * a.dos.h, a.dos.l, q0, a.Lq,
                    vec);
  mm::load_tile<DH>(Ks, kb, a.ks.l, 0, a.Lk, vec);
  mm::load_tile<DH>(Vs, vb, a.vs.l, 0, a.Lk, vec);
  load_ids(0, 0);
  mm::cp_async_commit();
  mm::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4], df[DH / 16][4];
  mm::load_a_frags<DH>(qf, Qs, warp * 16);
  mm::load_a_frags<DH>(df, dOs, warp * 16);

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  bf16* ds = (bf16*)a.ds;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      mm::load_tile<DH>(Ks + (st ^ 1) * T * LD, kb, a.ks.l, (kt + 1) * T, a.Lk, vec);
      mm::load_tile<DH>(Vs + (st ^ 1) * T * LD, vb, a.vs.l, (kt + 1) * T, a.Lk, vec);
      load_ids(st ^ 1, (kt + 1) * T);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * T * LD;
    const bf16* Vt = Vs + st * T * LD;
    const int* ids = kids + st * T;
    const int k0 = kt * T;
#pragma unroll 1
    for (int sc = 0; sc < T; sc += mm::kSub) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mm::mma_abt<DH, NT>(s, qf, Kt, sc);
      mm::mma_abt<DH, NT>(dp, df, Vt, sc);
      logits<NT>(a, bh, s, [&](int j, int e) {
        const int kc = sc + 8 * j + cq + (e & 1);  // key column in the tile
        return make_int4(row + (e >> 1) * 8, k0 + kc, sq[e >> 1], ids[kc]);
      });
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t keep[4] = {0u, 0u, 0u, 0u};
        if (a.dropout) keep_rows(keep, a.seed, row, k0 + sc + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float d = keep[e] >= thr ? kept : 0.f;
          float pd;
          s[j][e] = score_ds(s[j][e], dp[j][e], m[i], inv_l[i], di[i], d, a.scale, pd);
        }
      }
      if (ds != nullptr) {  // the bias gradient: the rounded dS of the pairs in range
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = row + (e >> 1) * 8, c = k0 + sc + 8 * j + cq + (e & 1);
            if (r < a.Lq && c < a.Lk)
              ds[(sb + r) * a.Lk + c] = __float2bfloat16_rn(s[j][e]);
          }
      }
      uint32_t dsf[NT / 2][4];
      mm::to_a_frags<NT>(dsf, s);  // dS rounded to bf16
      mm::mma_pv<DH, NT / 2>(acc, dsf, Kt, sc);
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

  bf16* dqb = (bf16*)a.dq + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e >> 1) * 8;
      if (r < a.Lq) dqb[(long long)r * a.dqs.l + c + (e & 1)] = __float2bfloat16_rn(acc[j][e]);
    }
  }
}

// ---- the bf16 forward on the tensor cores ---------------------------------------

// Shared memory of the forward: the 64-row Q tile held for the whole block,
// the two-stage rings of K and V tiles, and two stages of key segment ids.
template <int DH>
__host__ __device__ constexpr size_t fwd_smem() {
  return (size_t)(mm::kRows + 4 * mm::kTile) * mm::ld<DH>() * sizeof(bf16) +
         2 * mm::kTile * sizeof(int);
}

// A step of the forward's walk: 64-key tile t (absolute: keys 64 t ..
// 64 t + 63) of pass `pass` over the block_k block [kb0, kend). Pass 0 takes
// the row max, pass 1 (single step only) the row sum, pass 2 p, its sum and
// P V. The tiles of a block are those it overlaps, so every tile starts at a
// multiple of 64 (the lane-shared Philox draws need a multiple of 4); keys
// of a tile outside the block are masked.
struct FwdStep {
  int kb0, kend, pass, t;
};

// The step after `s`, or false at the end of the walk: the passes of a
// block, then the next block, up to Lk or, under `causal`, up to the first
// block this query tile does not visit (the visited blocks are a prefix).
__device__ __forceinline__ bool next_step(const Args& a, int q0, int bk, bool single,
                                          FwdStep& s) {
  if (++s.t <= (s.kend - 1) / mm::kTile) return true;
  s.pass += single ? 1 : 2;  // 0 -> 1 -> 2 in the single step, 0 -> 2 otherwise
  if (s.pass > 2) {
    s.kb0 += bk;
    s.pass = 0;
    if (s.kb0 >= a.Lk || tile_skipped(a, q0, s.kb0)) return false;
    s.kend = min(s.kb0 + bk, a.Lk);
  }
  s.t = s.kb0 / mm::kTile;
  return true;
}

// The sum, or the maximum, over the four lanes that hold a row's columns.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// One block a (batch, head, 64-query tile), walking the block_k blocks it
// visits: per block S and the row max m_next, S again and p = exp(s - m_use)
// with its undropped row sum, bf16(p D) into A fragments and acc += P V.
// The TPU's normalised update acc <- acc (l_corr / l_next) + (p v) / l_next
// is folded: acc is scaled by l_corr once m_next is known, P V added, and
// the sum multiplied by 1 / l_next (1 where l_next is 0) at the block's end,
// which differs from the TPU's order in f32 rounding only and spares a
// second accumulator. The single-step variant (block_k >= Lk) takes the row
// sum l in a pass of its own, then p / l, and no division at the end. `vec`:
// q, k and v rows 16-byte aligned.
template <int DH>
__global__ void __launch_bounds__(mm::kThreads, DH == 64 ? 4 : 1) fwd_kernel(Args a, int vec) {
  constexpr int LD = mm::ld<DH>();
  constexpr int T = mm::kTile;
  constexpr int NT = mm::kSub / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + mm::kRows * LD;  // two stages
  bf16* Vs = Ks + 2 * T * LD;      // two stages
  int* kids = reinterpret_cast<int*>(Vs + 2 * T * LD);  // [stage][64] key segment ids

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * mm::kRows;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const bf16* kb = (const bf16*)a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = (const bf16*)a.v + b * a.vs.b + h * a.vs.h;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int cq = 2 * (lane & 3);
  // the keep threshold and the scale of a kept score; without dropout every
  // score is kept (its bits stay 0) and scaled by 1
  const uint32_t thr = a.dropout ? a.threshold : 0u;
  const float kept = a.dropout ? a.inv_keep : 1.f;
  int sq[2];  // the segment ids of rows row and row + 8 (0 past Lq or without ids)
#pragma unroll
  for (int i = 0; i < 2; ++i)
    sq[i] = a.seg_q != nullptr && row + 8 * i < a.Lq
                ? a.seg_q[(long long)b * a.Lq + row + 8 * i] : 0;
  // the key tile at step s into stage st: K, V in pass 2, the segment ids
  auto load = [&](const FwdStep& s, int st) {
    mm::load_tile<DH>(Ks + st * T * LD, kb, a.ks.l, s.t * T, a.Lk, vec);
    if (s.pass == 2) mm::load_tile<DH>(Vs + st * T * LD, vb, a.vs.l, s.t * T, a.Lk, vec);
    for (int r = threadIdx.x; r < T; r += mm::kThreads)
      kids[st * T + r] = a.seg_kv != nullptr && s.t * T + r < a.Lk
                             ? a.seg_kv[(long long)b * a.Lk + s.t * T + r] : 0;
  };

  const bool single = a.bk >= a.Lk;
  const int bk = single ? a.Lk : a.bk;
  FwdStep cur{0, min(bk, a.Lk), 0, 0};  // block 0 is visited by every row (block_q >= 2)
  mm::load_tile<DH>(Qs, (const bf16*)a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, vec);
  load(cur, 0);
  mm::cp_async_commit();
  mm::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4];
  mm::load_a_frags<DH>(qf, Qs, warp * 16);

  // rows row and row + 8: the running state, and the current block's terms
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float mx[2] = {-INFINITY, -INFINITY}, psum[2] = {0.f, 0.f};
  float m_next[2], m_use[2], l_corr[2], l_single[2];
  bool run[2];

  for (int st = 0;; st ^= 1) {
    FwdStep nxt = cur;
    const bool more = next_step(a, q0, bk, single, nxt);
    if (more) load(nxt, st ^ 1);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * T * LD;
    const bf16* Vt = Vs + st * T * LD;
    const int* ids = kids + st * T;
    const int k0 = cur.t * T;
    const bool edge = k0 < cur.kb0 || k0 + T > cur.kend;  // the tile straddles the block
#pragma unroll 1
    for (int sc = 0; sc < T; sc += mm::kSub) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mm::mma_abt<DH, NT>(s, qf, Kt, sc);
      logits<NT>(a, bh, s, [&](int j, int e) {
        const int kc = sc + 8 * j + cq + (e & 1);  // key column in the tile
        return make_int4(row + (e >> 1) * 8, k0 + kc, sq[e >> 1], ids[kc]);
      });
      if (edge) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = k0 + sc + 8 * j + cq + (e & 1);
            if (c < cur.kb0 || c >= cur.kend) s[j][e] = -INFINITY;
          }
      }
      if (cur.pass == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      } else if (cur.pass == 1) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) psum[e >> 1] += expf(s[j][e] - m_use[e >> 1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t keep[4] = {0u, 0u, 0u, 0u};
          if (a.dropout) keep_rows(keep, a.seed, row, k0 + sc + 8 * j + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float p = expf(s[j][e] - m_use[i]);
            if (single)
              p = __fdiv_rn(p, l_single[i]);
            else
              psum[i] += p;
            s[j][e] = __fmul_rn(p, keep[e] >= thr ? kept : 0.f);  // p D
          }
        }
        uint32_t pf[NT / 2][4];
        mm::to_a_frags<NT>(pf, s);  // p D rounded to bf16
        mm::mma_pv<DH, NT / 2>(acc, pf, Vt, sc);
      }
    }

    if (cur.t == (cur.kend - 1) / T) {  // the pass's last tile: the same in every thread
      if (cur.pass == 0) {
        // m_next = max(m_prev, rowmax(s)); a row whose block_q tile does not
        // reach this block (under `causal`) keeps its state
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m_next[i] = fmaxf(m_run[i], quad_max(mx[i]));
          m_use[i] = m_next[i] == -INFINITY ? 0.f : m_next[i];  // no visited pair yet
          run[i] = !a.causal || last_row(row + 8 * i, a.bq) > cur.kb0;
          l_corr[i] = run[i] && !single ? __fmul_rn(expf(m_run[i] - m_use[i]), l_run[i]) : 1.f;
        }
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = __fmul_rn(acc[j][e], l_corr[e >> 1]);
      } else if (cur.pass == 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) l_single[i] = quad_sum(psum[i]);
      } else {
        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float rowsum = quad_sum(psum[i]);
          inv[i] = 1.f;
          if (run[i]) {
            if (single) {
              l_run[i] = l_single[i];
            } else {
              // l_next = rowsum(p) + alpha l_prev; 1 / l_next taken as 1 where 0
              const float l_next = __fadd_rn(rowsum, l_corr[i]);
              inv[i] = l_next == 0.f ? 1.f : __fdiv_rn(1.0f, l_next);
              l_run[i] = l_next;
            }
            m_run[i] = m_next[i];
          }
          mx[i] = -INFINITY;
          psum[i] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = __fmul_rn(acc[j][e], inv[e >> 1]);
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
    if (!more) break;
    cur = nxt;
  }

  const long long sb = (long long)bh * a.Lq;
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row + 8 * i < a.Lq) {
        a.l[sb + row + 8 * i] = l_run[i];
        a.m[sb + row + 8 * i] = m_run[i];
      }
  }
  bf16* ob = (bf16*)a.o + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e >> 1) * 8;
      if (r < a.Lq) ob[(long long)r * a.os.l + c + (e & 1)] = __float2bfloat16_rn(acc[j][e]);
    }
  }
}

// Kernel 9 at bf16 on `stream`, dh 64 or 128.
template <int DH>
cudaError_t launch_fwd(const Args& a, int B, cudaStream_t stream) {
  const int vec = mm::rows_aligned(a.q, a.qs) && mm::rows_aligned(a.k, a.ks) &&
                  mm::rows_aligned(a.v, a.vs);
  const size_t smem = fwd_smem<DH>();
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<DH><<<dim3((a.Lq + mm::kRows - 1) / mm::kRows, B * a.H), mm::kThreads, smem,
                   stream>>>(a, vec);
  return cudaGetLastError();
}

// Kernel 10 (dkv) or 11 at bf16 on `stream`, dh 64 or 128.
template <int DH>
cudaError_t launch_bwd(bool dkv, const Args& a, int B, cudaStream_t stream) {
  const int vec = mm::rows_aligned(a.q, a.qs) && mm::rows_aligned(a.k, a.ks) &&
                  mm::rows_aligned(a.v, a.vs) && mm::rows_aligned(a.dout, a.dos);
  const size_t smem = bwd_smem<DH>();
  constexpr cudaFuncAttribute kAttr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  void (*kernel)(Args, int) = dq_kernel<DH>;
  if (dkv) kernel = dkv_kernel<DH>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, kAttr, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = dkv ? a.Lk : a.Lq;
  kernel<<<dim3((rows + mm::kRows - 1) / mm::kRows, B * a.H), mm::kThreads, smem, stream>>>(
      a, vec);
  return cudaGetLastError();
}

}  // namespace flash
}  // namespace pcm
