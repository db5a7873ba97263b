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
// outputs. The f32 kernels below keep tiles, statistics and accumulators f32
// (their `T` is float; `round_to<float>` is the identity).
//
// What bounds the f32 kernels on an H100: arithmetic, as in the forward.
// 14 dh flops a score element (S and dP recomputed in both passes below) on
// the FP32 pipes, as f32 FMAs (f32 stays off TF32, which would lose the
// 1e-5 the f32 step is held to).
//
// What the design does about the TPU kernel's shape: that kernel holds a
// whole key row and accumulates dK/dV in VMEM scratch across a sequential
// q-tile grid axis. Hopper has no sequential grid axis and a block has
// 227 KB, so the work is split three ways, each without atomics:
//   1. one warp a query row: D = rowsum(dO * O);
//   2. one block a (batch, head, 64-key tile), looping over the 64-query
//      tiles: dK and dV of its 64 keys in registers (4 rows x dh/16 columns
//      a thread);
//   3. one block a (batch, head, 64-query tile), looping over the key tiles
//      up to l_actual: dQ of its 64 queries in registers.
// Tiles live in shared memory padded by one float a row; the 64x64 score
// work uses the forward's 16x16 thread grid (4x4 elements a thread). The
// dropout mask is applied in one pass over the probability tile, one Philox
// call for four neighbouring key columns. Strides are passed for every
// tensor (batch, head, row; last axis contiguous), so the (B, L, H, dh)
// projections are read in place and dQ/dK/dV are written in the same layout.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "elem.cuh"
#include "philox.cuh"

namespace {

using pcm::round_to;
using pcm::to_f;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

using Strides = pcm::attn_mma::Strides;

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

template <int DH>
constexpr size_t smem_floats() {
  return 4 * (size_t)kBQ * (DH + 1) + 2 * (size_t)kBQ * (kBK + 1) + 3 * kBQ;
}

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

// Query rows q0.. of Q (pre-scaled) and dO, and their row statistics, into
// shared memory; rows past Lq are zero with m = +inf, so their p is 0.
template <typename T, int DH>
__device__ __forceinline__ void load_query_tile(const Args<T>& a, int bh, int b, int h,
                                                int q0, float* Qs, float* dOs, float* rm,
                                                float* rr, float* rd) {
  constexpr int LD = DH + 1;
  const T* qb = a.q + b * a.qs.b + h * a.qs.h;
  const T* dob = a.dout + b * a.dos.b + h * a.dos.h;
  for (int e = threadIdx.x; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    const bool in = q0 + r < a.Lq;
    Qs[r * LD + c] =
        in ? round_to<T>(__fmul_rn(to_f(qb[(q0 + r) * a.qs.l + c]), a.scale)) : 0.f;
    dOs[r * LD + c] = in ? to_f(dob[(q0 + r) * a.dos.l + c]) : 0.f;
  }
  const long long base = (long long)bh * a.Lq + q0;
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < a.Lq;
    rm[r] = in ? a.row_max[base + r] : INFINITY;
    rr[r] = in ? a.row_inv[base + r] : 0.f;
    rd[r] = in ? a.delta[base + r] : 0.f;
  }
}

// Key rows k0.. of K and V into shared memory, zero past Lk.
template <typename T, int DH>
__device__ __forceinline__ void load_key_tile(const Args<T>& a, int b, int h, int k0,
                                              float* Ks, float* Vs) {
  constexpr int LD = DH + 1;
  const T* kb = a.k + b * a.ks.b + h * a.ks.h;
  const T* vb = a.v + b * a.vs.b + h * a.vs.h;
  for (int e = threadIdx.x; e < kBK * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    const bool in = k0 + r < a.Lk;
    Ks[r * LD + c] = in ? to_f(kb[(k0 + r) * a.ks.l + c]) : 0.f;
    Vs[r * LD + c] = in ? to_f(vb[(k0 + r) * a.vs.l + c]) : 0.f;
  }
}

// Recomputes the (64 query x 64 key) tile at (q0, k0) and leaves
// p_drop in Ps and dS in dSs (row = query, column = key), both rounded to T.
// Every thread of the block calls it; it ends with the tiles complete.
template <typename T, int DH>
__device__ __forceinline__ void probs_and_ds(const Args<T>& a, int h, int q0, int k0,
                                             const float* Qs, const float* dOs,
                                             const float* Ks, const float* Vs, float* Ps,
                                             float* dSs, const float* rm, const float* rr,
                                             const float* rd) {
  constexpr int LD = DH + 1;
  constexpr int LDP = kBK + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float aq[4], ad[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      aq[i] = Qs[(ty + 16 * i) * LD + d];
      ad[i] = dOs[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = Ks[(tx + 16 * j) * LD + d];
      bv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(ad[i], bv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = k0 + c < a.l_actual ? expf(s[i][j] - rm[r]) * rr[r] : 0.f;
      Ps[r * LDP + c] = a.dropout ? p : round_to<T>(p);
      dSs[r * LDP + c] = a.dropout ? dp[i][j] : round_to<T>(p * (dp[i][j] - rd[r]));
    }
  }
  __syncthreads();
  if (a.dropout) {
    for (int gi = threadIdx.x; gi < kBQ * (kBK / 4); gi += kThreads) {
      const int r = gi / (kBK / 4), c4 = (gi % (kBK / 4)) * 4;
      const uint4 bits = pcm::keep_bits4(a.seed, h, q0 + r, (k0 + c4) >> 2);
      const uint32_t w[4] = {bits.x, bits.y, bits.z, bits.w};
      const float dr = rd[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = r * LDP + c4 + e;
        const bool keep = w[e] >= a.threshold;
        const float p = Ps[at];
        dSs[at] = round_to<T>(p * ((keep ? dSs[at] * a.inv_keep : 0.f) - dr));
        Ps[at] = round_to<T>(keep ? p * a.inv_keep : 0.f);
      }
    }
    __syncthreads();
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_kernel(Args<T> a) {
  constexpr int LD = DH + 1;
  constexpr int LDP = kBK + 1;
  constexpr int CJ = DH / 16;  // output columns a thread
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* dOs = Qs + kBQ * LD;
  float* Ps = dOs + kBQ * LD;
  float* dSs = Ps + kBQ * LDP;
  float* rm = dSs + kBQ * LDP;
  float* rr = rm + kBQ;
  float* rd = rr + kBQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;

  float dk[4][CJ], dv[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  if (k0 < a.l_actual) {  // key tiles past l_actual get zero gradients
    load_key_tile<T, DH>(a, b, h, k0, Ks, Vs);
    const int n_qt = (a.Lq + kBQ - 1) / kBQ;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous query tile is consumed
      load_query_tile<T, DH>(a, bh, b, h, q0, Qs, dOs, rm, rr, rd);
      __syncthreads();
      probs_and_ds<T, DH>(a, h, q0, k0, Qs, dOs, Ks, Vs, Ps, dSs, rm, rr, rd);
      // dV += p_drop^T dO and dK += dS^T Q: key rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        float pk[4], sk[4], dov[CJ], qv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pk[i] = Ps[qq * LDP + ty + 16 * i];
          sk[i] = dSs[qq * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          dov[j] = dOs[qq * LD + tx + 16 * j];
          qv[j] = Qs[qq * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            dv[i][j] = fmaf(pk[i], dov[j], dv[i][j]);
            dk[i][j] = fmaf(sk[i], qv[j], dk[i][j]);
          }
      }
    }
  }

  T* dkb = a.dk + b * a.dks.b + h * a.dks.h;
  T* dvb = a.dv + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= a.Lk) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      dkb[kr * a.dks.l + tx + 16 * j] = pcm::from_f<T>(dk[i][j]);
      dvb[kr * a.dvs.l + tx + 16 * j] = pcm::from_f<T>(dv[i][j]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(Args<T> a) {
  constexpr int LD = DH + 1;
  constexpr int LDP = kBK + 1;
  constexpr int CJ = DH / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* dOs = Qs + kBQ * LD;
  float* Ps = dOs + kBQ * LD;
  float* dSs = Ps + kBQ * LDP;
  float* rm = dSs + kBQ * LDP;
  float* rr = rm + kBQ;
  float* rd = rr + kBQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;

  load_query_tile<T, DH>(a, bh, b, h, q0, Qs, dOs, rm, rr, rd);
  float dq[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dq[i][j] = 0.f;

  const int n_kt = (a.l_actual + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous key tile is consumed
    load_key_tile<T, DH>(a, b, h, k0, Ks, Vs);
    __syncthreads();
    probs_and_ds<T, DH>(a, h, q0, k0, Qs, dOs, Ks, Vs, Ps, dSs, rm, rr, rd);
    // dQ += dS K: query rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float sv[4], kv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) dq[i][j] = fmaf(sv[i], kv[j], dq[i][j]);
    }
  }

  T* dqb = a.dq + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      dqb[qr * a.dqs.l + tx + 16 * j] = pcm::from_f<T>(round_to<T>(dq[i][j]) * a.scale);
  }
}

template <typename T, int DH>
cudaError_t launch(const Args<T>& a, int B, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T, DH>
      <<<dim3((a.Lk + kBK - 1) / kBK, B * a.H), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, DH>
      <<<dim3((a.Lq + kBQ - 1) / kBQ, B * a.H), kThreads, smem, stream>>>(a);
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
    namespace mm = pcm::attn_mma;
    const mm::BwdArgs m{a.q, a.k, a.v, a.dout, a.row_max, a.row_inv, a.delta, a.dq, a.dk,
                        a.dv, a.qs, a.ks, a.vs, a.dos, a.dqs, a.dks, a.dvs, H, Lq, Lk,
                        l_actual, a.scale, threshold, inv_keep, seed, dropout,
                        mm::rows_aligned(q, a.qs) && mm::rows_aligned(k, a.ks) &&
                            mm::rows_aligned(v, a.vs) && mm::rows_aligned(dout, a.dos)};
    return dh == 64 ? mm::launch_bwd<64>(m, B, s) : mm::launch_bwd<128>(m, B, s);
  } else {
    return dh == 64 ? launch<T, 64>(a, B, s) : launch<T, 128>(a, B, s);
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
