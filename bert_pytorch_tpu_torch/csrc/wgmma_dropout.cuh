// The attention-dropout keep mask in registers, for the tensor-core routes
// of the training kernels: each thread draws the keep bits of its own 32
// elements of a 64 x 64 accumulator tile (the fragment layout of
// wgmma_common.cuh) from the Philox of flash_attention_common.cuh, while
// the score wgmmas run. Two orientations:
//
//   * keep_bits: rows are q, columns keys (S = Q K^T): the training
//     forward #1 (flash_infer_wgmma.cuh) and the dq kernel #2
//     (flash_attention_bwd.cu);
//   * keep_bits_t: rows are keys, columns q (S^T = K q^T): the dkv kernel
//     #3 (flash_attention_bwd.cu).
//
// Both give bit e of the returned word for element e, and both draw every
// Philox word once: the bits equal `philox_keep_mask` at the same
// coordinates.

#pragma once

#include "flash_attention_common.cuh"
#include "wgmma_common.cuh"

namespace flash {
namespace wg {

// The keep bits of this thread's 32 score elements in the tile whose rows
// start at `row` (this thread's first row) and whose keys start at k0
// (bit e: element e, at row row + 8 * ((e >> 1) & 1) and key k0 + 8 *
// (e >> 2) + 2 * (lane % 4) + (e & 1)). One Philox call gives the four
// keys 8j + 4(c/2) .. + 3 of one row (c = lane % 4); lanes c and c ^ 1
// hold two of those keys each, of the same two rows r and r + 8, so lane c
// draws row r + 8 (c & 1) and the pair swaps draws with one shuffle: no
// word is drawn twice and none is wasted.
__device__ __forceinline__ uint32_t keep_bits(uint2 seed, uint32_t threshold,
                                              int bh, int row, int k0,
                                              int lane) {
  const int c = lane & 3;
  const int odd = c & 1;
  const uint32_t q = static_cast<uint32_t>(row + 8 * odd);
  uint32_t own = 0;  // bit 4j + i: key i of the group of block j
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>((k0 >> 2) + 2 * j + (c >> 1)), q,
                   static_cast<uint32_t>(bh), 0u),
        seed);
    own |= (static_cast<uint32_t>(w.x >= threshold) |
            static_cast<uint32_t>(w.y >= threshold) << 1 |
            static_cast<uint32_t>(w.z >= threshold) << 2 |
            static_cast<uint32_t>(w.w >= threshold) << 3)
           << (4 * j);
  }
  const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 1);
  const uint32_t row_r = odd ? other : own;
  const uint32_t row_r8 = odd ? own : other;
  // Element e = 4j + 2 * half + t is key 2(c & 1) + t of group j.
  return ((row_r >> (2 * odd)) & 0x33333333u) |
         (((row_r8 >> (2 * odd)) & 0x33333333u) << 2);
}

// The keep bits of this thread's 32 elements of the transposed [64 keys x
// 64 q] tile whose keys start at k0 and q rows at q0 (bit e: element e, at
// key row 16 * warp + lane / 4 + 8 * ((e >> 1) & 1) and q column
// 8 * (e >> 2) + 2 * (lane % 4) + (e & 1)). The four keys of one Philox
// call are key i = lane / 4 % 4 of the four lanes with the same lane / 16
// and lane % 4, and those lanes share all 32 of their calls: lane i draws
// the calls of elements 8i .. 8i + 7, keeps byte b for key b, and the four
// swap bytes with three shuffles.
__device__ __forceinline__ uint32_t keep_bits_t(uint2 seed, uint32_t threshold,
                                                int bh, int q0, int k0,
                                                int warp, int lane) {
  const int i = (lane >> 2) & 3;
  const int c = lane & 3;
  const uint32_t group0 =
      static_cast<uint32_t>((k0 >> 2) + 4 * warp + (lane >> 4));
  uint32_t own = 0;  // bit 8b + k: key b of call k (element 8i + k)
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int half = (k >> 1) & 1;
    const int col = 8 * (2 * i + (k >> 2)) + 2 * c + (k & 1);
    const uint4 w = philox4x32_10(
        make_uint4(group0 + 2 * half, static_cast<uint32_t>(q0 + col),
                   static_cast<uint32_t>(bh), 0u),
        seed);
    own |= (static_cast<uint32_t>(w.x >= threshold) |
            static_cast<uint32_t>(w.y >= threshold) << 8 |
            static_cast<uint32_t>(w.z >= threshold) << 16 |
            static_cast<uint32_t>(w.w >= threshold) << 24)
           << k;
  }
  uint32_t keep = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {  // from the lane whose i is i ^ t
    const uint32_t from =
        t == 0 ? own : __shfl_xor_sync(0xffffffffu, own, 4 * t);
    keep |= ((from >> (8 * i)) & 0xFFu) << (8 * (i ^ t));
  }
  return keep;
}

}  // namespace wg
}  // namespace flash
