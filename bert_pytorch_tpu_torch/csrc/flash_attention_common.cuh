// Pieces shared by the training flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): dtype conversions
// (fp32, bf16 and fp16), the
// half-warp reductions, and the counter-based dropout generator.
//
// Dropout: Philox4x32-10 keyed by the 64-bit seed and counted by
// (key column / 4, query row, batch*head, 0). One call yields the keep bits
// of four neighbouring keys of one query row, so the mask of an element
// depends only on its coordinates and never on the tiling: forward and
// backward kernels may walk their tiles in any order and still draw the
// same mask. The TPU kernels seeded their hardware PRNG per tile instead
// (bert_pytorch_tpu/ops/pallas/attention.py `_keep_mask`), which tied the
// backward to the forward's tiles. An element is kept iff its 32 random
// bits are >= threshold = uint32(rate * 2^32), the JAX package's
// convention. The plain PyTorch version of the same generator is
// `philox_keep_mask` in ops/kernels/attention.py.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;             // rows and keys per tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kPer = kTile / 16;      // tile rows (and keys) per thread
constexpr int kPStride = kTile + 1;   // odd stride of the P / dS tiles
constexpr float kNegInf = -1e30f;     // _NEG_INF of the Pallas kernels
constexpr float kMasked = -10000.0f;  // additive mask convention

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// Round to nearest, not saturating: past 65504 an fp16 value is inf, as
// the JAX kernels' astype(float16) makes it (an overflow must reach the
// gradients, so the loss scaler skips the step).
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// The value an fp32 operand takes when it is rounded to T for a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, offset));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 key) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return c;
}

// Fills the keep bytes of the [kTile rows x kTile keys] tile whose first
// query row is q0 and first key is k0 (k0 % 4 == 0): byte (r, c) lands at
// keep[r * kTile + c], or at keep[c * kTile + r] when kKeyMajor. All
// threads of the block take part; the caller synchronises before reading.
template <bool kKeyMajor>
__device__ __forceinline__ void fill_keep_tile(uint8_t* keep, uint2 key,
                                               uint32_t threshold, int bh,
                                               int q0, int k0) {
  for (int e = threadIdx.x; e < kTile * (kTile / 4); e += kThreads) {
    const int r = e / (kTile / 4);
    const int g = e - r * (kTile / 4);
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>((k0 >> 2) + g),
                   static_cast<uint32_t>(q0 + r), static_cast<uint32_t>(bh),
                   0u),
        key);
    const uint32_t words[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * g + j;
      keep[kKeyMajor ? c * kTile + r : r * kTile + c] =
          words[j] >= threshold ? 1 : 0;
    }
  }
}

// Additive block-diagonal mask of packed rows (`_seg_mask` of the Pallas
// kernels): q may attend to k iff both carry the same nonzero id.
__device__ __forceinline__ float seg_mask(int q_id, int k_id) {
  return (q_id == k_id && q_id > 0) ? 0.f : kMasked;
}

}  // namespace flash
