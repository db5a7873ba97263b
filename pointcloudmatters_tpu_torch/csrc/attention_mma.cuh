// Exact softmax attention on the bf16 tensor cores: the bf16 forward
// (kernel 3) and the bf16 backward's dK/dV and dQ kernels (kernel 4). Their
// C entries are attention_fwd.cu and attention_bwd.cu, which dispatch here
// when the element type is bf16. At f32 the forward (attention_fwd.cuh)
// and the backward's dK/dV and dQ kernels (attention_bwd.cu) take these
// kernels' shape on the TF32 tensor cores in 3xTF32 (f32_mma.cuh), with the
// cp.async and Philox helpers below.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel`
// (pointcloudmatters_tpu/ops/oneshot_attention.py:68-166) at bf16. Their
// arithmetic is kept: every product takes bf16 operands with f32
// accumulation, as the MXU did (`preferred_element_type=jnp.float32`), and
// the operands are rounded where the TPU kernel rounds them: q pre-scaled by
// bf16(scale) (:209, :238), e_drop before P V (:91), p_drop before dV
// (:131), dS before dQ and dK (:143), dQ before its scale (:273). Keys at
// column l_actual and beyond are masked with -1e30 before the max. The
// forward takes e = exp(s - m) against the row's final max, so it makes two
// passes over the key tiles (S and the row max; then S again, e, its f32
// sum, dropout and P V); the denominator is the undropped sum and o = acc *
// (1 / l). The backward uses the forward's row max and 1 / l, and
// D = rowsum(dO * O) (attention_bwd.cu's pre-pass). Dropout bits are
// philox.cuh's keep_bits4(seed, h, query row, key column / 4): one mask per
// head, shared across the batch, exactly the f32 kernels' mask.
//
// What bounds it on an H100: the tensor cores in principle (4 B H Lq Lk dh
// flops forward, 1.5x that with the row-max pass; 14 B H Lq Lk dh backward
// with S and dP computed in both kernels), at 989 TFLOP/s bf16 dense. In
// practice `mma.sync` fed from shared memory, exp on the FP32 pipes and
// Philox on the integer pipes (one call a four scores, ~70 operations; a
// quarter to a third of each kernel's time at rate 0.1 on an H100 80GB
// HBM3, chip_smoke.py) keep the kernels several times above that bound.
//
// What the design does about it:
// - Every product is `mma.sync.m16n8k16` bf16 -> f32. Tiles sit in shared
//   memory as bf16 with rows padded by 16 bytes, so the eight row addresses
//   of an `ldmatrix` fall in distinct banks; `ldmatrix.trans` gives the
//   transposed operands (V in P V, dO and Q in dV and dK, K in dQ).
// - Streamed tiles come through `cp.async` into a two-stage ring: tile t+1
//   loads while tile t multiplies (a plain load path serves views whose
//   rows are not 16-byte aligned).
// - A block is 4 warps, 16 rows a warp, 64 rows a block. The C fragment of
//   one product is the A fragment of the next (two f32 accumulators packed
//   into a bf16 pair), so P and dS never go through shared memory.
// - Forward and dQ: rows are queries; a warp holds its 16 pre-scaled q (and
//   dO) rows as A fragments for the whole key loop. dK/dV: rows are keys;
//   the block computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are
//   A fragments of dV += P^T dO and dK += dS^T Q without a transpose.
// - The backward keeps its three kernels and no atomics: every output
//   element is summed by one thread in a fixed order, so two launches give
//   identical bits.
// - Dropout: one Philox call serves four neighbouring key columns. A
//   thread holds two columns of two rows of an 8-column tile, so the calls
//   are shared between lanes: in the query-row layout a lane pair draws
//   the two rows' calls and swaps two words; in the key-row layout of
//   dK/dV four lanes draw four calls and transpose them with three xor
//   shuffles. Each score element is drawn once a kernel.
// - The dK/dV and dQ kernels work on 32-score sub-tiles, which keeps their
//   accumulators (dK and dV: dh / 2 floats each a thread) in registers. At
//   dh = 64 the forward and dK/dV are held to 128 registers, four blocks an
//   SM (dK/dV then spills 12 bytes a thread; measured faster than three
//   blocks at 158 registers without a spill).
//
// The fused layer's backward (kernel 8, fused_mha.cu) takes these kernels
// in another statistics form (`Fused`): the forward kernel as its rows'
// statistics pass (it also computes dP = dheads V^T, a 32-key sub-tile at a
// time beside S, and u = r sum(z e)), then dK/dV and dQ with e = exp(s - m)
// and u where the oneshot kernels take p = e r and D, q already scaled,
// outputs in f32 and bf16. The oneshot instantiations (`Oneshot`) keep the
// code paths that kernels 3 and 4 had.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"
#include "philox.cuh"

namespace pcm {
namespace attn_mma {

constexpr int kRows = 64;    // rows a block: queries (forward, dQ) or keys (dK/dV)
constexpr int kTile = 64;    // rows of a streamed tile
constexpr int kThreads = 128;  // 4 warps, 16 rows each
constexpr int kSub = 32;       // score columns a sub-tile in the backward
constexpr float kNegInf = -1.0e30f;  // NEG_INF of the TPU kernel

struct Strides {
  long long b, h, l;
};

struct FwdArgs {
  const bf16 *q, *k, *v;
  bf16* o;
  float *row_max, *row_inv;  // both null when the statistics are not needed
  Strides qs, ks, vs, os;
  int H, Lq, Lk, l_actual;
  float scale;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int dropout;
  int vec;  // K and V rows 16-byte aligned: tiles stream by cp.async
};

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *row_max, *row_inv, *delta;
  bf16 *dq, *dk, *dv;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int H, Lq, Lk, l_actual;
  float scale;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int dropout;
  int vec;  // q, k, v and dout rows 16-byte aligned
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two f32 values rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bf16 bf16_zero() { return __float2bfloat16_rn(0.f); }

// ---- tiles -------------------------------------------------------------------

template <int DH>
__host__ __device__ constexpr int ld() {
  return DH + 8;  // a row padded by 16 bytes
}

// Rows r0 .. r0 + 63 of a (row stride `ls`) into a shared tile, zero at
// rows >= n. With `vec` by cp.async (the caller commits and waits), else by
// plain loads.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, long long ls, int r0,
                                          int n, int vec) {
  constexpr int LD = ld<DH>(), CH = DH / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    bf16* dst = sm + r * LD + c;
    const bool in = r0 + r < n;
    const bf16* src = in ? g + (long long)(r0 + r) * ls + c : g;
    if (vec) {
      cp_async16(dst, src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = in ? src[e] : bf16_zero();
    }
  }
}

// Rows r0 .. r0 + 63 of q, pre-scaled by `scale` and rounded to bf16, into
// a shared tile (zero at rows >= n), by plain loads.
template <int DH>
__device__ __forceinline__ void load_q_scaled(bf16* sm, const bf16* g, long long ls, int r0,
                                              int n, float scale) {
  constexpr int LD = ld<DH>();
  for (int i = threadIdx.x; i < kTile * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    sm[r * LD + c] =
        r0 + r < n ? __float2bfloat16_rn(__fmul_rn(__bfloat162float(g[(long long)(r0 + r) * ls + c]), scale))
                   : bf16_zero();
  }
}

// The rows a thread loaded by load_tile, multiplied by `scale` and rounded,
// in place (each thread touches only the chunks it copied itself, after its
// own cp.async wait).
template <int DH>
__device__ __forceinline__ void scale_own_chunks(bf16* sm, float scale) {
  constexpr int LD = ld<DH>(), CH = DH / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    bf16* p = sm + r * LD + c;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      p[e] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(p[e]), scale));
  }
}

// The A fragments (16 rows x DH) of rows row0 .. row0 + 15 of a shared tile.
template <int DH>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DH / 16][4], const bf16* sm,
                                             int row0) {
  constexpr int LD = ld<DH>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm_x4(f[kk], sm + (row0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
}

// c[j] += A (16 x DH, fragments `a`) times rows n0 + 8 j of a shared tile
// (the B operand: B[k][n] = tile[n0 + n][k]), for j < NT.
template <int DH, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const uint32_t (&a)[DH / 16][4],
                                        const bf16* sm, int n0) {
  constexpr int LD = ld<DH>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, sm + (n0 + jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                     (((lane >> 3) & 1) << 3));
      mma(c[2 * jp], a[kk], b[0], b[1]);
      mma(c[2 * jp + 1], a[kk], b[2], b[3]);
    }
}

// As mma_abt, with the A fragments read from rows a0 .. a0 + 15 of another
// shared tile as they are needed.
template <int DH, int NT>
__device__ __forceinline__ void mma_abt_s(float (&c)[NT][4], const bf16* sa, int a0,
                                          const bf16* sm, int n0) {
  constexpr int LD = ld<DH>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sa + (a0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, sm + (n0 + jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                     (((lane >> 3) & 1) << 3));
      mma(c[2 * jp], a, b[0], b[1]);
      mma(c[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DH) += P (16 x 16 KT, as bf16 pairs packed from the C fragments
// p) times rows k0 .. k0 + 16 KT - 1 of a shared tile (the B operand
// B[k][n] = tile[k0 + k][n], read by ldmatrix.trans).
template <int DH, int KT>
__device__ __forceinline__ void mma_pv(float (&acc)[DH / 8][4], const uint32_t (&p)[KT][4],
                                       const bf16* sm, int k0) {
  constexpr int LD = ld<DH>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, sm + (k0 + kk * 16 + (lane & 15)) * LD + dp * 16 + ((lane >> 4) << 3));
      mma(acc[2 * dp], p[kk], b[0], b[1]);
      mma(acc[2 * dp + 1], p[kk], b[2], b[3]);
    }
}

// C fragments of 8-column tiles 2 kk and 2 kk + 1 -> the A fragment of
// k-step kk: the accumulator layout of m16n8k16 is its A layout.
template <int NT>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// ---- dropout bits --------------------------------------------------------------

// Keep bits of the four C-fragment elements of an 8-column tile in the
// query-row layout: rows `row` and row + 8 (queries), columns c0 and c0 + 1
// (keys, c0 even). Lanes l and l ^ 1 share a group of four columns: each
// draws one row's call and passes the other lane the two words it needs.
__device__ __forceinline__ void keep_rows(uint32_t (&k)[4], uint32_t seed, int h, int row,
                                          int c0) {
  const int odd = threadIdx.x & 1;
  const uint4 w = pcm::keep_bits4(seed, h, row + (odd ? 8 : 0), c0 >> 2);
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  k[0] = odd ? r0 : w.x;  // row, c0
  k[1] = odd ? r1 : w.y;  // row, c0 + 1
  k[2] = odd ? w.z : r0;  // row + 8, c0
  k[3] = odd ? w.w : r1;  // row + 8, c0 + 1
}

// v[t] <- v[t ^ j]
__device__ __forceinline__ void xor_permute(uint32_t (&v)[4], int j) {
  uint32_t t;
  if (j & 1) {
    t = v[0]; v[0] = v[1]; v[1] = t;
    t = v[2]; v[2] = v[3]; v[3] = t;
  }
  if (j & 2) {
    t = v[0]; v[0] = v[2]; v[2] = t;
    t = v[1]; v[1] = v[3]; v[3] = t;
  }
}

// Keep bits of the four C-fragment elements of an 8-column tile in the
// key-row layout of dK/dV: rows `key` and key + 8 (keys; key0 = the warp's
// first key, a multiple of 16), columns q and q + 1 (queries). The four
// lanes that hold keys key0 + 4 g .. + 3 and the same columns need the
// four calls (q, q + 1) x (group g, g + 2), word key % 4 of each: lane j of
// the four draws call j, and an xor transpose hands out the words.
__device__ __forceinline__ void keep_keys(uint32_t (&k)[4], uint32_t seed, int h, int key,
                                          int q) {
  const int j = (threadIdx.x >> 2) & 3;  // key % 4
  const uint4 w = pcm::keep_bits4(seed, h, q + (j & 1), ((key - j) >> 2) + 2 * (j >> 1));
  uint32_t v[4] = {w.x, w.y, w.z, w.w};
  xor_permute(v, j);  // v[t] = word j ^ t of call j: what lane j ^ t needs
  k[0] = v[0];
  k[1] = __shfl_xor_sync(0xffffffffu, v[1], 4);
  k[2] = __shfl_xor_sync(0xffffffffu, v[2], 8);
  k[3] = __shfl_xor_sync(0xffffffffu, v[3], 12);
  xor_permute(k, j);  // k[e] = word j of call e
}

// ---- statistics forms ------------------------------------------------------------

// The oneshot kernels (3 and 4): the forward's o and row statistics; in the
// backward p = exp(s - m) / l, dS = p (dP_kept - D), q scaled and rounded
// as it loads, bf16 dQ = bf16(bf16(dQ) scale), dK, dV.
struct Oneshot {
  static constexpr bool kFused = false;
};

// The fused layer's backward (kernel 8, q already scaled and rounded). The
// forward kernel in this form is its statistics pass: it also reads
// dheads (at q's strides) and sums w = sum keep dP e beside l, and writes
// m, r = 1 / l (FwdArgs' row statistics), u = r (w (inv_keep r)) (= r sum
// z e) and the heads (FwdArgs' o). dK/dV and dQ then take e = exp(s - m),
// z = keep ? dP (inv_keep r) : 0, dS = e (z - u) and p_drop = keep ? e
// (inv_keep r) : 0, with BwdArgs' delta holding u (the oneshot D = u / r);
// dQ is dQ scale, unrounded, and dQ, dK, dV are written in f32 here and
// rounded to bf16 at BwdArgs' outputs.
struct Fused {
  static constexpr bool kFused = true;
  const bf16* dheads;
  float* u;              // (B, H, Lq)
  float *dq, *dk, *dv;   // at the strides of BwdArgs' dq, dk, dv
};

// ---- forward -------------------------------------------------------------------

template <int DH, class Form>
__host__ __device__ constexpr size_t fwd_smem() {
  return (size_t)((Form::kFused ? 2 : 1) * kRows + 4 * kTile) * ld<DH>() * sizeof(bf16);
}

template <int DH, class Form>
__global__ void __launch_bounds__(kThreads, DH == 64 ? 4 : 1) fwd_kernel(FwdArgs a, Form f) {
  constexpr int LD = ld<DH>();
  constexpr int NT = kTile / 8;  // 8-column score tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kRows * LD;     // two stages
  bf16* Vs = Ks + 2 * kTile * LD;  // two stages

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kRows;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int cq = 2 * (lane & 3);                 // first column of a thread in a tile

  load_q_scaled<DH>(Qs, a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, a.scale);
  bf16* dOs = Vs + 2 * kTile * LD;  // the fused form's dheads rows
  if constexpr (Form::kFused)
    load_tile<DH>(dOs, f.dheads + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, 0);
  __syncthreads();
  uint32_t qf[DH / 16][4], df[Form::kFused ? DH / 16 : 1][4];
  load_a_frags<DH>(qf, Qs, warp * 16);
  if constexpr (Form::kFused) load_a_frags<DH>(df, dOs, warp * 16);

  const int n_kt = (a.l_actual + kTile - 1) / kTile;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float w0 = 0.f, w1 = 0.f;  // the fused form's sum keep dP e
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // pass 0: S and the row max; pass 1: S, e, its sum, dropout and P V
  for (int pass = 0; pass < 2; ++pass) {
    load_tile<DH>(Ks, kb, a.ks.l, 0, a.Lk, a.vec);
    if (pass) load_tile<DH>(Vs, vb, a.vs.l, 0, a.Lk, a.vec);
    cp_async_commit();
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < n_kt) {
        load_tile<DH>(Ks + (st ^ 1) * kTile * LD, kb, a.ks.l, (kt + 1) * kTile, a.Lk, a.vec);
        if (pass)
          load_tile<DH>(Vs + (st ^ 1) * kTile * LD, vb, a.vs.l, (kt + 1) * kTile, a.Lk,
                        a.vec);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int k0 = kt * kTile;
      if constexpr (Form::kFused) {
        if (pass == 1) {  // S and dP = dheads V^T a 32-key sub-tile at a time
          const bf16* Kt = Ks + st * kTile * LD;
          const bf16* Vt = Vs + st * kTile * LD;
#pragma unroll 1
          for (int sc = 0; sc < kTile; sc += kSub) {
            float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
            for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            mma_abt<DH, kSub / 8>(s, qf, Kt, sc);
            mma_abt<DH, kSub / 8>(dp, df, Vt, sc);
#pragma unroll
            for (int j = 0; j < kSub / 8; ++j) {
              const int col = k0 + sc + 8 * j + cq;
              uint32_t keep[4];
              if (a.dropout) keep_rows(keep, a.seed, h, row, col);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const bool hi = e >= 2;
                float ev = 0.f;
                if (col + (e & 1) < a.l_actual) {
                  ev = expf(s[j][e] - (hi ? m1 : m0));
                  if (hi) l1 += ev; else l0 += ev;
                  if (!a.dropout || keep[e] >= a.threshold) {
                    if (hi) w1 = fmaf(dp[j][e], ev, w1); else w0 = fmaf(dp[j][e], ev, w0);
                    if (a.dropout) ev *= a.inv_keep;
                  } else {
                    ev = 0.f;
                  }
                }
                s[j][e] = ev;  // e_drop, rounded by to_a_frags
              }
            }
            uint32_t p[kSub / 16][4];
            to_a_frags<kSub / 8>(p, s);
            mma_pv<DH, kSub / 16>(acc, p, Vt, sc);
          }
          __syncthreads();  // stage st is consumed before it is refilled
          continue;
        }
      }

      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma_abt<DH, NT>(s, qf, Ks + st * kTile * LD, 0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = k0 + 8 * j + cq;
        if (col >= a.l_actual) s[j][0] = s[j][2] = kNegInf;
        if (col + 1 >= a.l_actual) s[j][1] = s[j][3] = kNegInf;
      }
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
          m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
        }
      } else if constexpr (!Form::kFused) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[j][0] = expf(s[j][0] - m0);
          s[j][1] = expf(s[j][1] - m0);
          s[j][2] = expf(s[j][2] - m1);
          s[j][3] = expf(s[j][3] - m1);
          l0 += s[j][0] + s[j][1];
          l1 += s[j][2] + s[j][3];
          if (a.dropout) {
            uint32_t keep[4];
            keep_rows(keep, a.seed, h, row, k0 + 8 * j + cq);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = keep[e] >= a.threshold ? s[j][e] * a.inv_keep : 0.f;
          }
        }
        uint32_t p[NT / 2][4];
        to_a_frags<NT>(p, s);  // e_drop rounded to bf16
        mma_pv<DH, NT / 2>(acc, p, Vs + st * kTile * LD, 0);
      }
      __syncthreads();  // stage st is consumed before it is refilled
    }
    if (pass == 0) {  // the row max over the four lanes of a row
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    if constexpr (Form::kFused) {
      w0 += __shfl_xor_sync(0xffffffffu, w0, off);
      w1 += __shfl_xor_sync(0xffffffffu, w1, off);
    }
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  if (a.row_max != nullptr && (lane & 3) == 0) {
    const long long base = (long long)blockIdx.y * a.Lq;
    if (row < a.Lq) {
      a.row_max[base + row] = m0;
      a.row_inv[base + row] = inv0;
      if constexpr (Form::kFused) f.u[base + row] = inv0 * (w0 * (a.inv_keep * inv0));
    }
    if (row + 8 < a.Lq) {
      a.row_max[base + row + 8] = m1;
      a.row_inv[base + row + 8] = inv1;
      if constexpr (Form::kFused) f.u[base + row + 8] = inv1 * (w1 * (a.inv_keep * inv1));
    }
  }
  bf16* ob = a.o + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
    if (row < a.Lq) {
      ob[(long long)row * a.os.l + c] = __float2bfloat16_rn(acc[j][0] * inv0);
      ob[(long long)row * a.os.l + c + 1] = __float2bfloat16_rn(acc[j][1] * inv0);
    }
    if (row + 8 < a.Lq) {
      ob[(long long)(row + 8) * a.os.l + c] = __float2bfloat16_rn(acc[j][2] * inv1);
      ob[(long long)(row + 8) * a.os.l + c + 1] = __float2bfloat16_rn(acc[j][3] * inv1);
    }
  }
}

// The forward (or, in the fused form, kernel 8's statistics pass) on `stream`.
template <int DH, class Form = Oneshot>
cudaError_t launch_fwd(const FwdArgs& a, int B, cudaStream_t stream, const Form& f = Form{}) {
  const size_t smem = fwd_smem<DH, Form>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DH, Form>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kRows - 1) / kRows, B * a.H);
  fwd_kernel<DH, Form><<<grid, kThreads, smem, stream>>>(a, f);
  return cudaGetLastError();
}

// Two f32 values (columns c, c + 1 of a row; `at` even) into a bf16 tensor
// and an f32 tensor at the same element offset.
__device__ __forceinline__ void store_pair(bf16* o, float* o32, long long at, float x0,
                                           float x1) {
  *reinterpret_cast<__nv_bfloat162*>(o + at) = __floats2bfloat162_rn(x0, x1);
  *reinterpret_cast<float2*>(o32 + at) = make_float2(x0, x1);
}

template <int DH>
__host__ __device__ constexpr size_t bwd_smem() {
  return (size_t)(2 * kRows + 4 * kTile) * ld<DH>() * sizeof(bf16) +
         2 * 3 * kTile * sizeof(float);
}

// ---- backward: dQ --------------------------------------------------------------

// One block a (batch, head, 64-query tile): dQ = (dS K) over the key tiles
// up to l_actual, times scale (rounded as the form says).
template <int DH, class Form>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a, Form f) {
  constexpr int LD = ld<DH>();
  constexpr int SC = kSub;
  constexpr int NT = SC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kRows * LD;
  bf16* Ks = dOs + kRows * LD;     // two stages
  bf16* Vs = Ks + 2 * kTile * LD;  // two stages

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8
  const int cq = 2 * (lane & 3);

  const int n_kt = (a.l_actual + kTile - 1) / kTile;
  load_tile<DH>(Ks, kb, a.ks.l, 0, a.Lk, a.vec);
  load_tile<DH>(Vs, vb, a.vs.l, 0, a.Lk, a.vec);
  cp_async_commit();
  if constexpr (Form::kFused)
    load_tile<DH>(Qs, a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, 0);
  else
    load_q_scaled<DH>(Qs, a.q + b * a.qs.b + h * a.qs.h, a.qs.l, q0, a.Lq, a.scale);
  load_tile<DH>(dOs, a.dout + b * a.dos.b + h * a.dos.h, a.dos.l, q0, a.Lq, 0);
  // rows past Lq: m = +inf and 1/l = 0, so their p is 0
  const long long sb = (long long)bh * a.Lq;
  const float m0 = row < a.Lq ? a.row_max[sb + row] : INFINITY;
  const float m1 = row + 8 < a.Lq ? a.row_max[sb + row + 8] : INFINITY;
  const float r0 = row < a.Lq ? a.row_inv[sb + row] : 0.f;
  const float r1 = row + 8 < a.Lq ? a.row_inv[sb + row + 8] : 0.f;
  const float d0 = row < a.Lq ? a.delta[sb + row] : 0.f;
  const float d1 = row + 8 < a.Lq ? a.delta[sb + row + 8] : 0.f;
  const float zr0 = a.inv_keep * r0, zr1 = a.inv_keep * r1;  // the fused form's z factor
  __syncthreads();
  uint32_t qf[DH / 16][4], df[DH / 16][4];
  load_a_frags<DH>(qf, Qs, warp * 16);
  load_a_frags<DH>(df, dOs, warp * 16);

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<DH>(Ks + (st ^ 1) * kTile * LD, kb, a.ks.l, (kt + 1) * kTile, a.Lk, a.vec);
      load_tile<DH>(Vs + (st ^ 1) * kTile * LD, vb, a.vs.l, (kt + 1) * kTile, a.Lk, a.vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * kTile * LD;
    const bf16* Vt = Vs + st * kTile * LD;
#pragma unroll 1
    for (int sc = 0; sc < kTile; sc += SC) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<DH, NT>(s, qf, Kt, sc);
      mma_abt<DH, NT>(dp, df, Vt, sc);
      const int c0 = kt * kTile + sc;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = c0 + 8 * j + cq;
        if constexpr (Form::kFused) {
          uint32_t keep[4];
          if (a.dropout) keep_rows(keep, a.seed, h, row, col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e >= 2;
            const float ev =
                col + (e & 1) < a.l_actual ? expf(s[j][e] - (hi ? m1 : m0)) : 0.f;
            const bool kp = !a.dropout || keep[e] >= a.threshold;
            const float z = kp ? dp[j][e] * (hi ? zr1 : zr0) : 0.f;
            s[j][e] = ev * (z - (hi ? d1 : d0));  // dS, rounded by to_a_frags
          }
        } else {
          float p[4];
          p[0] = col < a.l_actual ? expf(s[j][0] - m0) * r0 : 0.f;
          p[1] = col + 1 < a.l_actual ? expf(s[j][1] - m0) * r0 : 0.f;
          p[2] = col < a.l_actual ? expf(s[j][2] - m1) * r1 : 0.f;
          p[3] = col + 1 < a.l_actual ? expf(s[j][3] - m1) * r1 : 0.f;
          if (a.dropout) {
            uint32_t keep[4];
            keep_rows(keep, a.seed, h, row, col);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[j][e] = keep[e] >= a.threshold ? dp[j][e] * a.inv_keep : 0.f;
          }
          s[j][0] = p[0] * (dp[j][0] - d0);  // dS, rounded by to_a_frags
          s[j][1] = p[1] * (dp[j][1] - d0);
          s[j][2] = p[2] * (dp[j][2] - d1);
          s[j][3] = p[3] * (dp[j][3] - d1);
        }
      }
      uint32_t ds[NT / 2][4];
      to_a_frags<NT>(ds, s);
      mma_pv<DH, NT / 2>(acc, ds, Kt, sc);
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

  const long long qo = b * a.dqs.b + h * a.dqs.h;
  bf16* qb = a.dq + qo;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
    if constexpr (Form::kFused) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row + hh * 8;
        if (r < a.Lq)
          store_pair(qb, f.dq + qo, (long long)r * a.dqs.l + c, acc[j][2 * hh] * a.scale,
                     acc[j][2 * hh + 1] * a.scale);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e >> 1) * 8;
        if (r < a.Lq)
          qb[(long long)r * a.dqs.l + c + (e & 1)] =
              __float2bfloat16_rn(pcm::round_to<bf16>(acc[j][e]) * a.scale);
      }
    }
  }
}

// ---- backward: dK and dV -----------------------------------------------------

// One block a (batch, head, 64-key tile), looping over the query tiles:
// S^T = K Q^T and dP^T = V dO^T, then dV += P_drop^T dO and dK += dS^T Q.
template <int DH, class Form>
__global__ void __launch_bounds__(kThreads, DH == 64 ? 4 : 1) dkdv_kernel(BwdArgs a, Form f) {
  constexpr int LD = ld<DH>();
  constexpr int SC = kSub;
  constexpr int NT = SC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kRows * LD;
  bf16* Qs = Vs + kRows * LD;       // two stages
  bf16* dOs = Qs + 2 * kTile * LD;  // two stages
  float* stats = reinterpret_cast<float*>(dOs + 2 * kTile * LD);  // [stage][m, 1/l, D][64]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const bf16* qb = a.q + b * a.qs.b + h * a.qs.h;
  const bf16* dob = a.dout + b * a.dos.b + h * a.dos.h;
  const int key = k0 + warp * 16 + (lane >> 2);  // and key + 8
  const int cq = 2 * (lane & 3);
  const long long sb = (long long)bh * a.Lq;

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // the statistics of query tile q0 into stage st (plain loads; rows past
  // Lq get m = +inf and 1/l = 0, so their p is 0)
  auto load_stats = [&](int st, int q0) {
    float* sp = stats + st * 3 * kTile;
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < a.Lq;
      sp[r] = in ? a.row_max[sb + q0 + r] : INFINITY;
      sp[kTile + r] = in ? a.row_inv[sb + q0 + r] : 0.f;
      sp[2 * kTile + r] = in ? a.delta[sb + q0 + r] : 0.f;
    }
  };

  if (k0 < a.l_actual) {  // key tiles past l_actual get zero gradients
    const int n_qt = (a.Lq + kTile - 1) / kTile;
    load_tile<DH>(Ks, a.k + b * a.ks.b + h * a.ks.h, a.ks.l, k0, a.Lk, a.vec);
    load_tile<DH>(Vs, a.v + b * a.vs.b + h * a.vs.h, a.vs.l, k0, a.Lk, a.vec);
    load_tile<DH>(Qs, qb, a.qs.l, 0, a.Lq, a.vec);
    load_tile<DH>(dOs, dob, a.dos.l, 0, a.Lq, a.vec);
    load_stats(0, 0);
    cp_async_commit();
    for (int qt = 0; qt < n_qt; ++qt) {
      const int st = qt & 1;
      bf16* Qt = Qs + st * kTile * LD;
      const bf16* dOt = dOs + st * kTile * LD;
      if (qt + 1 < n_qt) {
        load_tile<DH>(Qs + (st ^ 1) * kTile * LD, qb, a.qs.l, (qt + 1) * kTile, a.Lq, a.vec);
        load_tile<DH>(dOs + (st ^ 1) * kTile * LD, dob, a.dos.l, (qt + 1) * kTile, a.Lq,
                      a.vec);
        load_stats(st ^ 1, (qt + 1) * kTile);
      }
      cp_async_commit();
      cp_async_wait<1>();
      if constexpr (!Form::kFused) scale_own_chunks<DH>(Qt, a.scale);  // q -> bf16(q * scale)
      __syncthreads();
      const float* sm_m = stats + st * 3 * kTile;
      const float* sm_r = sm_m + kTile;
      const float* sm_d = sm_r + kTile;
      const int q0 = qt * kTile;
#pragma unroll 1
      for (int sc = 0; sc < kTile; sc += SC) {
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        mma_abt_s<DH, NT>(s, Ks, warp * 16, Qt, sc);    // S^T
        mma_abt_s<DH, NT>(dp, Vs, warp * 16, dOt, sc);  // dP^T
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = sc + 8 * j + cq;  // query column in the tile
          uint32_t keep[4];
          if (a.dropout) keep_keys(keep, a.seed, h, key, q0 + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c + (e & 1);
            const bool live = key + (e >> 1) * 8 < a.l_actual;
            if constexpr (Form::kFused) {
              const float ev = live ? expf(s[j][e] - sm_m[qc]) : 0.f;
              const float zr = a.inv_keep * sm_r[qc];
              const bool kp = !a.dropout || keep[e] >= a.threshold;
              s[j][e] = kp ? ev * zr : 0.f;                               // p_drop
              dp[j][e] = ev * ((kp ? dp[j][e] * zr : 0.f) - sm_d[qc]);  // dS
            } else {
              const float p = live ? expf(s[j][e] - sm_m[qc]) * sm_r[qc] : 0.f;
              float pd = p, dpk = dp[j][e];
              if (a.dropout) {
                const bool kp = keep[e] >= a.threshold;
                pd = kp ? p * a.inv_keep : 0.f;
                dpk = kp ? dpk * a.inv_keep : 0.f;
              }
              s[j][e] = pd;                     // p_drop, rounded by to_a_frags
              dp[j][e] = p * (dpk - sm_d[qc]);  // dS, likewise
            }
          }
        }
        uint32_t pf[NT / 2][4], dsf[NT / 2][4];
        to_a_frags<NT>(pf, s);
        to_a_frags<NT>(dsf, dp);
        mma_pv<DH, NT / 2>(dv, pf, dOt, sc);
        mma_pv<DH, NT / 2>(dk, dsf, Qt, sc);
      }
      __syncthreads();  // stage st is consumed before it is refilled
    }
  }

  const long long ko = b * a.dks.b + h * a.dks.h, vo = b * a.dvs.b + h * a.dvs.h;
  bf16* dkb = a.dk + ko;
  bf16* dvb = a.dv + vo;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + cq;
    if constexpr (Form::kFused) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = key + hh * 8;
        if (r < a.Lk) {
          store_pair(dkb, f.dk + ko, (long long)r * a.dks.l + c, dk[j][2 * hh],
                     dk[j][2 * hh + 1]);
          store_pair(dvb, f.dv + vo, (long long)r * a.dvs.l + c, dv[j][2 * hh],
                     dv[j][2 * hh + 1]);
        }
      }
    } else {
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
}

// dK/dV, then dQ, on `stream` (after the caller's D = rowsum(dO * O) pass).
template <int DH>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = bwd_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<DH, Oneshot>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<DH, Oneshot>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dkdv_kernel<DH, Oneshot>
      <<<dim3((a.Lk + kRows - 1) / kRows, B * a.H), kThreads, smem, stream>>>(a, Oneshot{});
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<DH, Oneshot>
      <<<dim3((a.Lq + kRows - 1) / kRows, B * a.H), kThreads, smem, stream>>>(a, Oneshot{});
  return cudaGetLastError();
}

// The fused layer's attention backward on `stream`: the statistics pass
// (fa: m, r, u and the heads), then dK/dV and dQ in the fused form (ba
// reads m, r and u as row_max, row_inv and delta; Lq = Lk = l_actual).
template <int DH>
cudaError_t launch_fused_bwd(const FwdArgs& fa, const BwdArgs& ba, const Fused& f, int B,
                             cudaStream_t stream) {
  cudaError_t err = launch_fwd<DH, Fused>(fa, B, stream, f);
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_smem<DH>();
  err = cudaFuncSetAttribute(dkdv_kernel<DH, Fused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<DH, Fused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ba.Lq + kRows - 1) / kRows, B * ba.H);
  dkdv_kernel<DH, Fused><<<grid, kThreads, smem, stream>>>(ba, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<DH, Fused><<<grid, kThreads, smem, stream>>>(ba, f);
  return cudaGetLastError();
}

// Whether every row start of a (pointer, strides) view is 16-byte aligned.
inline bool rows_aligned(const void* p, const Strides& s) {
  return ((uintptr_t)p % 16 == 0) && s.b % 8 == 0 && s.h % 8 == 0 && s.l % 8 == 0;
}

}  // namespace attn_mma
}  // namespace pcm
