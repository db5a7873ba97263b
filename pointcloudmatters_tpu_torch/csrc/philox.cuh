// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011; the Random123 constants) and the attention dropout mask built
// from it. Shared by attention_fwd.cu and attention_bwd.cu, so that the
// backward regenerates exactly the forward's mask.
//
// The mask replaces the TPU kernel's `_keep_mask`
// (pointcloudmatters_tpu/ops/oneshot_attention.py:52-65), whose bits come
// from the TPU core's own generator and cannot be reproduced elsewhere. Its
// structure and threshold are kept: one mask per head, shared across the
// batch; keep iff bits >= min(int(rate * 2^32), 2^32 - 1) in uint32 space.
//
// keep(seed, h, i, j) is a pure function of the absolute query row i and key
// column j, never of a tile: key = (seed, h), counter = (j / 4, i, 0, 0), and
// the bits of column j are output word j % 4. One Philox call thus serves
// four neighbouring columns. The plain PyTorch version
// (ops/oneshot_attention.py, `keep_mask`) computes the same function.

#pragma once

#include <stdint.h>

namespace pcm {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Keep bits of key columns 4*g .. 4*g+3 of query row `row`, head `h`.
__device__ __forceinline__ uint4 keep_bits4(uint32_t seed, int h, int row, int g) {
  return philox4x32_10(make_uint4((uint32_t)g, (uint32_t)row, 0u, 0u),
                       make_uint2(seed, (uint32_t)h));
}

}  // namespace pcm
