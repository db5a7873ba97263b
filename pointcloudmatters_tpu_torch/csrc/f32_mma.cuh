// Exact-f32 products on the TF32 tensor cores ("3xTF32"), the one product
// scheme of the f32 oneshot forward and backward (kernels 3 and 4,
// attention_fwd.cuh and attention_bwd.cu) and of the f32 flash forward and
// backward (kernels 9, 10 and 11, flash_attention.cu).
//
// Each f32 operand x is split into hi = rna(x) and lo = rna(x - hi), both
// TF32 (`cvt.rna.tf32.f32`: 10 mantissa bits, ties away from zero), so that
// x = hi + lo to 2^-22 |x|. Each 8-deep k step of a product a b is summed
// as a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first, by three
// `mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32` into a zeroed f32 sum, which
// is added to the f32 accumulator rounding to nearest (`mma3`); the dropped
// a_lo b_lo is below 2^-22 |a b|. The result is an f32 dot product to a few
// f32 ulps, where TF32 alone (one mma, hi only) moves a score by ~3e-4 of
// its size (scripts/probe_f32_product.py).
//
// What bounds it on an H100: the TF32 tensor cores at 495 TFLOP/s dense,
// three passes a product (165 TFLOP/s of f32 work), against 67 TFLOP/s of
// the FP32 pipes; in practice `mma.sync` fed from shared memory and the
// splits (two conversions and a subtraction an operand element, on the
// FP32 and integer pipes) keep the kernels well below that.
//
// What the design does about it:
// - Tiles are f32 in shared memory, rows of DH + 8 floats with bit 3 of the
//   column flipped in rows 4-7 of every 8 (`at`). A row-major fragment
//   (A, and B read as the rows of a tile: S = Q K^T) is then one 8-byte
//   load a row, and a transposed one (B read down the columns of a tile:
//   P V, dS K) two 4-byte loads; both hit 32 distinct banks a warp.
// - The k index of every mma is permuted: logical k = t (lane % 4) and
//   t + 4 are the physical columns 2t and 2t + 1 of the 8-wide step. That
//   makes a row's two A values neighbours (the 8-byte load above) and, the
//   point of it, makes the C fragment of one product (rows g and g + 8,
//   columns 2t and 2t + 1) the A fragment of the next: P and dS go from
//   the accumulators of S and dP into P V, dS K, P^T dO and dS^T Q without
//   a shuffle or a trip through shared memory, as the bf16 kernels'
//   `to_a_frags` does for m16n8k16. Both operands of a product take the
//   same permutation, so the sum over k is the same sum.
// - The C fragment layout of m16n8k8 is that of m16n8k16, so the bf16
//   kernels' lane-shared Philox draws (`keep_rows`, `keep_keys`) and
//   flash's score function serve the f32 kernels unchanged.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace pcm {
namespace tf32x3 {

namespace mm = attn_mma;
using mm::kThreads;
using mm::kTile;

// a tile row: DH floats and 8 of padding (DH + 8 = 8 mod 32 at DH 64, 128)
template <int DH>
__host__ __device__ constexpr int ld() {
  return DH + 8;
}

// Score columns a sub-tile of the kernels: at dh = 128 their accumulators
// take twice the registers, so the sub-tile's S and dP are halved.
template <int DH>
__host__ __device__ constexpr int sub() {
  return DH == 64 ? 32 : 16;
}

template <int DH>
__host__ __device__ constexpr size_t tile_bytes() {
  return (size_t)kTile * ld<DH>() * sizeof(float);
}

// The offset of element (r, c) of a tile.
template <int DH>
__device__ __forceinline__ int at(int r, int c) {
  return r * ld<DH>() + (c ^ ((r & 4) << 1));
}

// Whether every row start of an f32 (pointer, strides) view is 16-byte
// aligned, so that its tiles load by cp.async.
inline bool rows_aligned(const void* p, const mm::Strides& s) {
  return ((uintptr_t)p % 16 == 0) && s.b % 4 == 0 && s.h % 4 == 0 && s.l % 4 == 0;
}

// Rows r0 .. r0 + 63 of g (row stride ls) into a tile, zero at rows >= n:
// by cp.async with `vec` (the caller commits and waits), else by plain loads.
template <int DH>
__device__ __forceinline__ void load_tile(float* sm, const float* g, long long ls, int r0,
                                          int n, int vec) {
  constexpr int CH = DH / 4;
  for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 4;
    float* dst = sm + at<DH>(r, c);
    const bool in = r0 + r < n;
    const float* src = in ? g + (long long)(r0 + r) * ls + c : g;
    if (vec) {
      mm::cp_async16(dst, src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = in ? src[e] : 0.f;
    }
  }
}

// The chunks this thread loaded by load_tile, times `scale`, in place
// (after the thread's own cp.async wait).
template <int DH>
__device__ __forceinline__ void scale_own_chunks(float* sm, float scale) {
  constexpr int CH = DH / 4;
  for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
    float* p = sm + at<DH>(i / CH, (i % CH) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __fmul_rn(p[e], scale);
  }
}

// ---- the split product ---------------------------------------------------------

// cvt.rna.tf32.f32 of a finite x (10 mantissa bits, ties away from zero):
// the magnitude's bits rounded up at half a TF32 ulp, two integer operations
// where the conversion instruction takes four (it also tests for inf and
// NaN, which the kernels' operands are not).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// N operand values as TF32 pairs: x = hi + lo to 2^-22 |x|
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.hi[i] = to_tf32(x[i]);
    s.lo[i] = to_tf32(x[i] - __uint_as_float(s.hi[i]));
  }
  return s;
}

// d += a b, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in f32: a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first,
// into a zeroed sum that is then added to d rounding to nearest. The
// tensor cores add into their accumulator truncating, toward zero: added
// straight into d, over the 2051 keys of a P V or dS K sum, that bias
// grows with every step (to 3e-5 of dQ at the flagship's shape, against
// the 1e-5 the f32 steps are held to); this way each k step is truncated
// against its own sum only, and d is rounded to nearest.
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a, const Split<2>& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a.lo, b.hi[0], b.hi[1]);
  mma(t, a.hi, b.lo[0], b.lo[1]);
  mma(t, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// ---- fragments (k permuted: logical t, t + 4 = physical 2t, 2t + 1) ----------------
//
// A fragment's rows start at a multiple of 8 (r0, n0 and k0 below), so the
// column bit that `at` flips depends on the lane alone: it adds +8 or -8 to
// the columns of an even or an odd 8-column step. The lane's offsets of
// both parities are taken once; the unrolled steps load at fixed offsets
// from them. g = lane / 4, t = lane % 4.

// The lane's offset of (row g, column 2t) from (r0, 8 kk), for kk odd or not.
template <int DH>
__device__ __forceinline__ int row_off(int odd) {
  const int lane = threadIdx.x & 31, g = lane >> 2, flip = (g & 4) << 1;
  return g * ld<DH>() + 2 * (lane & 3) + (odd ? -flip : flip);
}

// The lane's offset of (row 2t, column g) from (k0, 8 j), for j odd or not.
template <int DH>
__device__ __forceinline__ int col_off(int odd) {
  const int lane = threadIdx.x & 31, t = lane & 3, flip = (t & 2) << 2;
  return 2 * t * ld<DH>() + (lane >> 2) + (odd ? -flip : flip);
}

// The A fragment of rows r0 .. r0 + 15, columns 8 kk .. 8 kk + 7 of a tile.
template <int DH>
__device__ __forceinline__ Split<4> a_frag(const float* sm, int r0, int kk) {
  const float* p = sm + r0 * ld<DH>() + 8 * kk + row_off<DH>(kk & 1);
  const float2 x = *reinterpret_cast<const float2*>(p);
  const float2 y = *reinterpret_cast<const float2*>(p + 8 * ld<DH>());
  const float v[4] = {x.x, y.x, x.y, y.y};
  return split<4>(v);
}

// The B fragment B[k][n] = tile[n0 + n][8 kk + k]: n along the tile's rows.
template <int DH>
__device__ __forceinline__ Split<2> b_frag(const float* sm, int n0, int kk) {
  const float2 x =
      *reinterpret_cast<const float2*>(sm + n0 * ld<DH>() + 8 * kk + row_off<DH>(kk & 1));
  const float v[2] = {x.x, x.y};
  return split<2>(v);
}

// The B fragment B[k][n] = tile[k0 + k][8 j + n]: k along the tile's rows.
template <int DH>
__device__ __forceinline__ Split<2> b_frag_t(const float* sm, int k0, int j) {
  const float* p = sm + k0 * ld<DH>() + 8 * j + col_off<DH>(j & 1);
  const float v[2] = {p[0], p[ld<DH>()]};
  return split<2>(v);
}

// The C fragment of a 16 x 8 product as the A fragment of an 8-deep k step.
__device__ __forceinline__ Split<4> a_from_c(const float (&c)[4]) {
  const float v[4] = {c[0], c[2], c[1], c[3]};
  return split<4>(v);
}

// c[j] += A B^T for j < NT: A is rows a0 .. a0 + 15 of tile sa, B^T's
// column 8 j + n is row n0 + 8 j + n of tile sb (S = Q K^T and the like).
template <int DH, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const float* sa, int a0,
                                        const float* sb, int n0) {
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const Split<4> a = a_frag<DH>(sa, a0, kk);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma3(c[j], a, b_frag<DH>(sb, n0 + 8 * j, kk));
  }
}

// acc (16 x DH) += P (16 x 8 KT, the C fragments p) times rows k0 ..
// k0 + 8 KT - 1 of tile sb (P V, dS K, P^T dO, dS^T Q).
template <int DH, int KT>
__device__ __forceinline__ void mma_pv(float (&acc)[DH / 8][4], const float (&p)[KT][4],
                                       const float* sb, int k0) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const Split<4> a = a_from_c(p[kk]);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) mma3(acc[j], a, b_frag_t<DH>(sb, k0 + 8 * kk, j));
  }
}

}  // namespace tf32x3
}  // namespace pcm
