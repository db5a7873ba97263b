// Exact softmax attention backward, f32 or bf16: dQ, dK and dV by
// recomputation, deterministic (no atomics: every output element is summed
// by one thread in a fixed order, so two identical launches give identical
// bits).
//
// Replaces the TPU kernel `_bwd_kernel` / `_bwd_rule`
// (pointcloudmatters_tpu/ops/oneshot_attention.py:97-166, 233-275): q is
// pre-scaled by `scale`, keys at column l_actual and beyond are masked, the
// dropout keep mask is regenerated from the forward's seed (philox.cuh), and
// dQ is chained back by `scale`. With p = exp(s - m) / denom from the
// forward's row statistics (row max m and 1 / denom, written by
// attention_fwd.cu) and D_i = rowsum(dO_i * O_i):
//
//   p_drop = keep ? p / (1 - rate) : 0        dV = p_drop^T dO
//   dP     = dO V^T                           dS = p * (keep ? dP / (1 - rate) : 0 - D)
//   dK     = dS^T (q * scale)                 dQ = dS K * scale
//
// (D equals the TPU kernel's u / r = rowsum(z * e) at :142, dropout or not;
// in bf16 it reads the rounded output O, where the TPU kernel sums unrounded
// products, the one place the bf16 variant takes another route.)
//
// This file holds the f32 kernels and the D pre-pass of both element
// types. In bf16 the dK/dV and dQ kernels are the tensor-core kernels of
// attention_mma.cuh, which round where the TPU kernel rounds: the
// pre-scaled q (oneshot_attention.py:238), p_drop before dV (:131), dS
// before dQ and dK (:143), dQ before its scale (:147, :273), and the
// outputs. The f32 kernels below keep tiles, statistics, p, dS and
// accumulators f32.
//
// What bounds the f32 kernels on an H100: arithmetic. 14 dh flops a score
// element (S and dP recomputed in both kernels; 120.6 GFLOP at B = 4,
// H = 8, L = 2051, dh = 64), on the TF32 tensor cores in 3xTF32
// (f32_mma.cuh: each product an exact-f32 sum of three TF32 mmas).
//
// What the design does about the TPU kernel's shape: that kernel holds a
// whole key row and accumulates dK/dV in VMEM scratch across a sequential
// q-tile grid axis. Hopper has no sequential grid axis and a block has
// 227 KB, so the work is split three ways, each without atomics:
//   1. one warp a query row: D = rowsum(dO * O);
//   2. one block a (batch, head, 64-key tile), looping over the 64-query
//      tiles: dK and dV of its 64 keys in registers;
//   3. one block a (batch, head, 64-query tile), looping over the key tiles
//      up to l_actual: dQ of its 64 queries in registers.
// At f32, kernels 2 and 3 follow the bf16 kernels' shape with f32_mma.cuh's
// product: 4 warps x 16 rows, f32 tiles streamed by cp.async into two-stage
// rings (plain loads for views whose rows are not 16-byte aligned), the C
// fragments of S and dP (S^T and dP^T in kernel 2) taken as the A fragments
// of dQ += dS K (dV += p_drop^T dO, dK += dS^T q), scores a 16- or 32-column
// sub-tile at a time, and the lane-shared Philox draws of attention_mma.cuh
// (`keep_rows`, `keep_keys`), one call for four neighbouring key columns.
// Strides are passed for every tensor (batch, head, row; last axis
// contiguous), so the (B, L, H, dh) projections are read in place and
// dQ/dK/dV are written in the same layout.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "elem.cuh"
#include "f32_mma.cuh"
#include "philox.cuh"

namespace {

using pcm::to_f;

namespace mm = pcm::attn_mma;
namespace tx = pcm::tf32x3;

constexpr int kThreads = 256;  // the D pre-pass: 8 rows a block

using Strides = mm::Strides;

template <typename T>
struct Args {
  const T *q, *k, *v, *o, *dout;
  const float *row_max, *row_inv;
  float* delta;
  T *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int H, Lq, Lk, l_actual;
  float scale;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int dropout;
};

// D = rowsum(dO * O), one warp a (batch, head, query row).
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_kernel(Args<T> a, int dh,
                                                                    long long rows) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = (int)(row % a.Lq);
  const int bh = (int)(row / a.Lq);
  const int b = bh / a.H, h = bh % a.H;
  const T* o = a.o + b * a.os.b + h * a.os.h + i * a.os.l;
  const T* d = a.dout + b * a.dos.b + h * a.dos.h + i * a.dos.l;
  float sum = 0.f;
  for (int c = lane; c < dh; c += 32) sum = fmaf(to_f(d[c]), to_f(o[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) a.delta[row] = sum;
}

// ---- f32: dK/dV and dQ in 3xTF32 on the tensor cores (f32_mma.cuh) --------------

// Shared memory of both kernels: two 64-row f32 tiles held for the whole
// block, two two-stage rings of streamed tiles, and (dK/dV) two stages of
// m, 1 / l and D of 64 queries.
template <int DH>
constexpr size_t f32_smem() {
  return 6 * tx::tile_bytes<DH>() + 2 * 3 * tx::kTile * sizeof(float);
}

// One block a (batch, head, 64-key tile), looping over the query tiles:
// S^T = K (q scale)^T and dP^T = V dO^T a sub-tile at a time, then
// dV += p_drop^T dO and dK += dS^T (q scale), the C fragments of S^T and dP^T
// taken as the A fragments of the two sums. `vec`: q, k, v and dout rows
// 16-byte aligned.
template <int DH>
__global__ void __launch_bounds__(tx::kThreads, DH == 64 ? 2 : 1)
    f32_dkdv_kernel(Args<float> a, int vec) {
  constexpr int LD = tx::ld<DH>(), T = tx::kTile, NT = tx::sub<DH>() / 8;
  extern __shared__ __align__(16) float smf[];
  float* Ks = smf;
  float* Vs = Ks + T * LD;
  float* Qs = Vs + T * LD;       // two stages
  float* dOs = Qs + 2 * T * LD;  // two stages
  float* stats = dOs + 2 * T * LD;  // [stage][m, 1/l, D][64]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * T;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const float* qb = a.q + b * a.qs.b + h * a.qs.h;
  const float* dob = a.dout + b * a.dos.b + h * a.dos.h;
  const int key = k0 + warp * 16 + (lane >> 2);  // and key + 8
  const int cq = 2 * (lane & 3);
  const long long sb = (long long)bh * a.Lq;

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // the statistics of query tile q0 into stage st (rows past Lq get m = +inf
  // and 1/l = 0, so their p is 0)
  auto load_stats = [&](int st, int q0) {
    float* sp = stats + st * 3 * T;
    for (int r = threadIdx.x; r < T; r += tx::kThreads) {
      const bool in = q0 + r < a.Lq;
      sp[r] = in ? a.row_max[sb + q0 + r] : INFINITY;
      sp[T + r] = in ? a.row_inv[sb + q0 + r] : 0.f;
      sp[2 * T + r] = in ? a.delta[sb + q0 + r] : 0.f;
    }
  };

  if (k0 < a.l_actual) {  // key tiles past l_actual get zero gradients
    const int n_qt = (a.Lq + T - 1) / T;
    tx::load_tile<DH>(Ks, a.k + b * a.ks.b + h * a.ks.h, a.ks.l, k0, a.Lk, vec);
    tx::load_tile<DH>(Vs, a.v + b * a.vs.b + h * a.vs.h, a.vs.l, k0, a.Lk, vec);
    tx::load_tile<DH>(Qs, qb, a.qs.l, 0, a.Lq, vec);
    tx::load_tile<DH>(dOs, dob, a.dos.l, 0, a.Lq, vec);
    load_stats(0, 0);
    mm::cp_async_commit();
    for (int qt = 0; qt < n_qt; ++qt) {
      const int st = qt & 1;
      float* Qt = Qs + st * T * LD;
      const float* dOt = dOs + st * T * LD;
      if (qt + 1 < n_qt) {
        tx::load_tile<DH>(Qs + (st ^ 1) * T * LD, qb, a.qs.l, (qt + 1) * T, a.Lq, vec);
        tx::load_tile<DH>(dOs + (st ^ 1) * T * LD, dob, a.dos.l, (qt + 1) * T, a.Lq, vec);
        load_stats(st ^ 1, (qt + 1) * T);
      }
      mm::cp_async_commit();
      mm::cp_async_wait<1>();
      tx::scale_own_chunks<DH>(Qt, a.scale);  // q -> q * scale
      __syncthreads();
      const float* sm_m = stats + st * 3 * T;
      const float* sm_r = sm_m + T;
      const float* sm_d = sm_r + T;
      const int q0 = qt * T;
#pragma unroll 1
      for (int sc = 0; sc < T; sc += 8 * NT) {
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        tx::mma_abt<DH, NT>(s, Ks, warp * 16, Qt, sc);    // S^T
        tx::mma_abt<DH, NT>(dp, Vs, warp * 16, dOt, sc);  // dP^T
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = sc + 8 * j + cq;  // query column in the tile
          uint32_t keep[4];
          if (a.dropout) mm::keep_keys(keep, a.seed, h, key, q0 + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c + (e & 1);
            const bool live = key + (e >> 1) * 8 < a.l_actual;
            const float p = live ? expf(s[j][e] - sm_m[qc]) * sm_r[qc] : 0.f;
            float pd = p, dpk = dp[j][e];
            if (a.dropout) {
              const bool kp = keep[e] >= a.threshold;
              pd = kp ? p * a.inv_keep : 0.f;
              dpk = kp ? dpk * a.inv_keep : 0.f;
            }
            s[j][e] = pd;                     // p_drop
            dp[j][e] = p * (dpk - sm_d[qc]);  // dS
          }
        }
        tx::mma_pv<DH, NT>(dv, s, dOt, sc);
        tx::mma_pv<DH, NT>(dk, dp, Qt, sc);
      }
      __syncthreads();  // stage st is consumed before it is refilled
    }
  }

  float* dkb = a.dk + b * a.dks.b + h * a.dks.h;
  float* dvb = a.dv + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = key + (e >> 1) * 8;
      if (r < a.Lk) {
        dkb[(long long)r * a.dks.l + c + (e & 1)] = dk[j][e];
        dvb[(long long)r * a.dvs.l + c + (e & 1)] = dv[j][e];
      }
    }
  }
}

// One block a (batch, head, 64-query tile), looping over the key tiles up
// to l_actual: S = (q scale) K^T and dP = dO V^T a sub-tile at a time,
// then dQ += dS K, the C fragments of dS taken as A fragments; dQ
// times scale at the end. `vec` as for f32_dkdv_kernel.
template <int DH>
__global__ void __launch_bounds__(tx::kThreads, DH == 64 ? 2 : 1)
    f32_dq_kernel(Args<float> a, int vec) {
  constexpr int LD = tx::ld<DH>(), T = tx::kTile, NT = tx::sub<DH>() / 8;
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;
  float* dOs = Qs + T * LD;
  float* Ks = dOs + T * LD;     // two stages
  float* Vs = Ks + 2 * T * LD;  // two stages

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * T;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const float* kb = a.k + b * a.ks.b + h * a.ks.h;
  const float* vb = a.v + b * a.vs.b + h * a.vs.h;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int cq = 2 * (lane & 3);

  tx::load_tile<DH>(Qs, a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, vec);
  tx::load_tile<DH>(dOs, a.dout + b * a.dos.b + h * a.dos.h, a.dos.l, q0, a.Lq, vec);
  mm::cp_async_commit();
  tx::load_tile<DH>(Ks, kb, a.ks.l, 0, a.Lk, vec);
  tx::load_tile<DH>(Vs, vb, a.vs.l, 0, a.Lk, vec);
  mm::cp_async_commit();
  // rows past Lq: m = +inf and 1/l = 0, so their p is 0
  const long long sb = (long long)bh * a.Lq;
  const float m0 = row < a.Lq ? a.row_max[sb + row] : INFINITY;
  const float m1 = row + 8 < a.Lq ? a.row_max[sb + row + 8] : INFINITY;
  const float r0 = row < a.Lq ? a.row_inv[sb + row] : 0.f;
  const float r1 = row + 8 < a.Lq ? a.row_inv[sb + row + 8] : 0.f;
  const float d0 = row < a.Lq ? a.delta[sb + row] : 0.f;
  const float d1 = row + 8 < a.Lq ? a.delta[sb + row + 8] : 0.f;
  mm::cp_async_wait<1>();
  tx::scale_own_chunks<DH>(Qs, a.scale);  // q -> q * scale

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_kt = (a.l_actual + T - 1) / T;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      tx::load_tile<DH>(Ks + (st ^ 1) * T * LD, kb, a.ks.l, (kt + 1) * T, a.Lk, vec);
      tx::load_tile<DH>(Vs + (st ^ 1) * T * LD, vb, a.vs.l, (kt + 1) * T, a.Lk, vec);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + st * T * LD;
    const float* Vt = Vs + st * T * LD;
#pragma unroll 1
    for (int sc = 0; sc < T; sc += 8 * NT) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      tx::mma_abt<DH, NT>(s, Qs, warp * 16, Kt, sc);
      tx::mma_abt<DH, NT>(dp, dOs, warp * 16, Vt, sc);
      const int c0 = kt * T + sc;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = c0 + 8 * j + cq;
        float p[4];
        p[0] = col < a.l_actual ? expf(s[j][0] - m0) * r0 : 0.f;
        p[1] = col + 1 < a.l_actual ? expf(s[j][1] - m0) * r0 : 0.f;
        p[2] = col < a.l_actual ? expf(s[j][2] - m1) * r1 : 0.f;
        p[3] = col + 1 < a.l_actual ? expf(s[j][3] - m1) * r1 : 0.f;
        if (a.dropout) {
          uint32_t keep[4];
          mm::keep_rows(keep, a.seed, h, row, col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = keep[e] >= a.threshold ? dp[j][e] * a.inv_keep : 0.f;
        }
        s[j][0] = p[0] * (dp[j][0] - d0);  // dS
        s[j][1] = p[1] * (dp[j][1] - d0);
        s[j][2] = p[2] * (dp[j][2] - d1);
        s[j][3] = p[3] * (dp[j][3] - d1);
      }
      tx::mma_pv<DH, NT>(acc, s, Kt, sc);
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

  float* dqb = a.dq + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e >> 1) * 8;
      if (r < a.Lq) dqb[(long long)r * a.dqs.l + c + (e & 1)] = acc[j][e] * a.scale;
    }
  }
}

// dK/dV, then dQ, at f32 on `stream` (after the D pre-pass).
template <int DH>
cudaError_t launch_f32(const Args<float>& a, int B, cudaStream_t stream) {
  const int vec = tx::rows_aligned(a.q, a.qs) && tx::rows_aligned(a.k, a.ks) &&
                  tx::rows_aligned(a.v, a.vs) && tx::rows_aligned(a.dout, a.dos);
  const size_t smem = f32_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(f32_dkdv_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(f32_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  f32_dkdv_kernel<DH><<<dim3((a.Lk + tx::kTile - 1) / tx::kTile, B * a.H), tx::kThreads, smem,
                        stream>>>(a, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  f32_dq_kernel<DH><<<dim3((a.Lq + tx::kTile - 1) / tx::kTile, B * a.H), tx::kThreads, smem,
                      stream>>>(a, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* row_max, const float* row_inv,
                         float* delta, void* dq, void* dk, void* dv,
                         const long long* st, int B, int H, int Lq, int Lk, int dh,
                         int l_actual, float scale, uint32_t threshold, float inv_keep,
                         uint32_t seed, int dropout, cudaStream_t s) {
  Args<T> a;
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.o = (const T*)o;
  a.dout = (const T*)dout;
  a.row_max = row_max;
  a.row_inv = row_inv;
  a.delta = delta;
  a.dq = (T*)dq;
  a.dk = (T*)dk;
  a.dv = (T*)dv;
  a.qs = Strides{st[0], st[1], st[2]};
  a.ks = Strides{st[3], st[4], st[5]};
  a.vs = Strides{st[6], st[7], st[8]};
  a.os = Strides{st[9], st[10], st[11]};
  a.dos = Strides{st[12], st[13], st[14]};
  a.dqs = Strides{st[15], st[16], st[17]};
  a.dks = Strides{st[18], st[19], st[20]};
  a.dvs = Strides{st[21], st[22], st[23]};
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.l_actual = l_actual;
  a.scale = scale;
  a.threshold = threshold;
  a.inv_keep = inv_keep;
  a.seed = seed;
  a.dropout = dropout;
  if (dh != 64 && dh != 128) return cudaErrorInvalidValue;
  // D = rowsum(dO * O); then dK/dV and dQ, on the FP32 pipes in f32 and on
  // the tensor cores in bf16
  const long long rows = (long long)B * H * Lq;
  attn_bwd_delta_kernel<T>
      <<<(unsigned)((rows * 32 + kThreads - 1) / kThreads), kThreads, 0, s>>>(a, dh, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (pcm::is_bf16<T>::value) {
    const mm::BwdArgs m{a.q, a.k, a.v, a.dout, a.row_max, a.row_inv, a.delta, a.dq, a.dk,
                        a.dv, a.qs, a.ks, a.vs, a.dos, a.dqs, a.dks, a.dvs, H, Lq, Lk,
                        l_actual, a.scale, threshold, inv_keep, seed, dropout,
                        mm::rows_aligned(q, a.qs) && mm::rows_aligned(k, a.ks) &&
                            mm::rows_aligned(v, a.vs) && mm::rows_aligned(dout, a.dos)};
    return dh == 64 ? mm::launch_bwd<64>(m, B, s) : mm::launch_bwd<128>(m, B, s);
  } else {
    return dh == 64 ? launch_f32<64>(a, B, s) : launch_f32<128>(a, B, s);
  }
}

}  // namespace

extern "C" {

// q (B, H, Lq, dh), k and v (B, H, Lk, dh), the forward's output o and its
// gradient dout (B, H, Lq, dh), all f32 (bf16 == 0) or all bf16 (bf16 != 0)
// on device `device`, each given by base pointer and (batch, head, row)
// strides in elements with the last axis contiguous. `strides` holds 24
// values: (b, h, l) of q, k, v, o, dout, dq, dk, dv in that order. row_max
// and row_inv are the forward's (B, H, Lq) f32 statistics; delta is
// (B, H, Lq) f32 scratch; dq, dk, dv (of the inputs' type) are written. dh
// is 64 or 128; 1 <= l_actual <= Lk; scale, dropout, threshold, inv_keep and
// seed as the forward got them. Launches three kernels on `stream` and
// returns the first cudaError_t that is not success.
int pcm_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* row_max, const float* row_inv,
                      float* delta, void* dq, void* dk, void* dv,
                      const long long* strides, int B, int H, int Lq, int Lk, int dh,
                      int l_actual, float scale, unsigned threshold, float inv_keep,
                      unsigned seed, int dropout, int bf16, int device, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || l_actual < 1 || l_actual > Lk ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_typed<pcm::bf16>(q, k, v, o, dout, row_max, row_inv, delta, dq, dk, dv,
                                        strides, B, H, Lq, Lk, dh, l_actual, scale,
                                        threshold, inv_keep, seed, dropout, s);
  return (int)launch_typed<float>(q, k, v, o, dout, row_max, row_inv, delta, dq, dk, dv,
                                  strides, B, H, Lq, Lk, dh, l_actual, scale, threshold,
                                  inv_keep, seed, dropout, s);
}

}  // extern "C"
