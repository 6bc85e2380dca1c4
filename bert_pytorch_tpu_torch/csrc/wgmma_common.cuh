// Hopper (sm_90a) building blocks shared by the tensor-core routes of the
// attention kernels: the serving kernels #4 and #5 (flash_attention_infer.cu,
// flash_attention_infer_int8.cu) and the training forward #1, dq #2 and
// dkv #3 (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
//   * TMA: 4-D tensor maps (D, H, S, B) over the model's [B, S, H, D]
//     layout, encoded on the host through the driver entry point the
//     runtime already loaded (no -lcuda), with a box of (chunk, 1, 64, 1)
//     swizzled by the chunk's width, so the ragged S edge zero-fills inside
//     the batch. A row of up to 128 bytes is one box; a 256-byte row
//     (bf16 D = 128) is two 128-byte boxes.
//   * mbarriers that TMA completes (the expected bytes are the full boxes:
//     TMA counts zero-filled rows too).
//   * `wgmma` shared-memory descriptors for K-major operands (rows of K
//     contiguous) and MN-major B operands (read with the transpose bit),
//     and the products the kernels use: d (+)= A B^T from shared memory
//     (bf16 or fp16 m64nNk16, int8 m64nNk32, N = 64, or 128 for a serving
//     geometry's 128-key stage) and d += A B with A (64 x
//     16 bf16 or fp16) from registers, in the S accumulator's fragment
//     layout. The 16-bit element type E (__nv_bfloat16 or __half) is a
//     template parameter: the instruction's `.bf16.bf16` or `.f16.f16`,
//     the TMA map's data type and the pair packing follow it.
//   * The fragment helpers: pinning accumulator registers across an
//     asynchronous wgmma, 16-bit pair packing (round to nearest, not
//     saturating), quad reductions and e^x by `ex2.approx`.
//
// Accumulator fragment of an m64nN fp32 tile: thread t of warp w holds
// element e (0 <= e < N/2) at row 16w + (t%32)/4 + 8 * ((e >> 1) & 1),
// column 8 * (e >> 2) + 2 * (t % 4) + (e & 1). Pairs (e, e + 1) are,
// four at a time, the A fragment of one k16 step of a register-A wgmma.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {
namespace wg {

// The TMA data type of a 16-bit element type.
template <typename E>
constexpr CUtensorMapDataType tma_type() {
  static_assert(std::is_same_v<E, __nv_bfloat16> || std::is_same_v<E, __half>,
                "bf16 or fp16");
  return std::is_same_v<E, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // rows of a tile (wgmma M)
constexpr int kStages = 2;

// A tile of kTileRows rows (64 unless a serving geometry takes 128 keys a
// stage) of kRowBytes bytes, as TMA lays it out: chunks of up to 128 bytes
// per row (the swizzle span), each chunk kTileRows rows deep, filled by one
// 64-row box per chunk and 64 rows.
template <int kRowBytes, int kTileRows = kRows>
struct Tile {
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes % 128 == 0,
                "rows of 32, 64 or a multiple of 128 bytes");
  static_assert(kTileRows % kRows == 0, "whole 64-row boxes");
  static constexpr int kChunk = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kChunks = kRowBytes / kChunk;
  static constexpr int kBytes = kTileRows * kRowBytes;  // a multiple of 1024
};

// -- host: tensor maps ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links against nothing but the runtime.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (D, H, S, B) over a contiguous [B, S, H, D] tensor of
// `elem`-byte values, with a box of (chunk bytes, 1, 64 rows, 1) swizzled by
// the chunk's width; rows past S read as zeros.
inline cudaError_t bshd_map(CUtensorMap* map, const void* base,
                            CUtensorMapDataType type, int elem, int chunk,
                            int batch, int seq, int heads, int head_dim) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t row = static_cast<cuuint64_t>(head_dim) * elem;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(chunk / elem), 1,
                             static_cast<cuuint32_t>(kRows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      chunk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : chunk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult rc = encode(
      map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// -- device: shared memory, mbarriers, TMA ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(h), "r"(s), "r"(b),
      "r"(bar)
      : "memory");
}

// The kTileRows rows from s of one (b, h) head into a
// Tile<kRowBytes, kTileRows> at dst.
template <int kRowBytes, int kElem, int kTileRows = kRows>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int h, int s, int b) {
  using T = Tile<kRowBytes, kTileRows>;
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
    for (int r = 0; r < kTileRows; r += kRows)
      tma_load(dst + (c * kTileRows + r) * T::kChunk, map, bar,
               c * T::kChunk / kElem, h, s + r, b);
}

// -- device: wgmma ------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units, 14 bits each), swizzle mode (1: 128 B, 2: 64 B,
// 3: 32 B). Every tile base is 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, int swizzle) {
  const uint64_t mode = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | mode << 62;
}

// K-major operand (rows of K contiguous: q, k, v and dO tiles), at the k-step
// `step` of 32 bytes (k16 bf16 or k32 int8): 8-row groups 8 * chunk bytes
// apart; the leading offset is unused by swizzled K-major layouts.
template <int kRowBytes, int kTileRows = kRows>
__device__ __forceinline__ uint64_t k_major(uint32_t base, int step) {
  using T = Tile<kRowBytes, kTileRows>;
  const int byte = step * 32;
  return descriptor(base + (byte / T::kChunk) * kTileRows * T::kChunk +
                        byte % T::kChunk,
                    16, 8 * T::kChunk, T::kChunk);
}

// MN-major B operand (a tile of rows by D, D contiguous, read as 16 rows x
// N: V in the forward, K in dq, dO and q in dkv), at the row step `step` of
// 16 rows: the leading offset steps to the next chunk of D, the stride
// offset to the next 8 rows.
template <int kRowBytes, int kTileRows = kRows>
__device__ __forceinline__ uint64_t mn_major(uint32_t base, int step) {
  using T = Tile<kRowBytes, kTileRows>;
  return descriptor(base + step * 16 * T::kChunk, kTileRows * T::kChunk,
                    8 * T::kChunk, T::kChunk);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <typename R, int N>
__device__ __forceinline__ void pin(R (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same_v<R, float>)
      asm volatile("" : "+f"(r[i])::"memory");
    else
      asm volatile("" : "+r"(r[i])::"memory");
  }
}

#define FLASH_WG8(C, d, i)                                                  \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define FLASH_WG_REGS32                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                \
  "%8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, "         \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define FLASH_WG_REGS64                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                \
  "%8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, "         \
  "%24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, "         \
  "%40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, "         \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define FLASH_WG64(C, d)                                                    \
  FLASH_WG8(C, d, 0), FLASH_WG8(C, d, 8), FLASH_WG8(C, d, 16),              \
      FLASH_WG8(C, d, 24), FLASH_WG8(C, d, 32), FLASH_WG8(C, d, 40),        \
      FLASH_WG8(C, d, 48), FLASH_WG8(C, d, 56)

// d (+)= A B^T for a 64 x N fp32 tile (N = 64, or 128 for a serving
// geometry's 128-key stage), A and B K-major in shared memory in the 16-bit
// type E (bf16 or fp16); `accumulate` 0 overwrites d.
#define FLASH_MMA_SS(TY)                                                    \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY               \
      " " FLASH_WG_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                  \
      : FLASH_WG8("+f", d, 0), FLASH_WG8("+f", d, 8), FLASH_WG8("+f", d, 16), \
        FLASH_WG8("+f", d, 24)                                              \
      : "l"(a), "l"(b), "r"(accumulate))
#define FLASH_MMA_SS128(TY)                                                 \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY              \
      " " FLASH_WG_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                  \
      : FLASH_WG64("+f", d)                                                 \
      : "l"(a), "l"(b), "r"(accumulate))

template <typename E, int N = 64>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "N = 64 or 128");
  constexpr bool kHalf = std::is_same_v<E, __half>;
  if constexpr (N == 64) {
    if constexpr (kHalf) FLASH_MMA_SS("f16"); else FLASH_MMA_SS("bf16");
  } else {
    if constexpr (kHalf) FLASH_MMA_SS128("f16"); else FLASH_MMA_SS128("bf16");
  }
}
#undef FLASH_MMA_SS
#undef FLASH_MMA_SS128

// The same for int8 A and B (k32), int32 d: exact.
template <int N = 64>
__device__ __forceinline__ void mma_s8_ss(int (&d)[N / 2], uint64_t a,
                                          uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "N = 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " FLASH_WG_REGS32
        ", %32, %33, p;\n}\n"
        : FLASH_WG8("+r", d, 0), FLASH_WG8("+r", d, 8),
          FLASH_WG8("+r", d, 16), FLASH_WG8("+r", d, 24)
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " FLASH_WG_REGS64
        ", %64, %65, p;\n}\n"
        : FLASH_WG64("+r", d)
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d += A B for one k16 step: A (64 x 16, in E) from registers in the
// accumulator's fragment layout (P in the forward; dS in dq; P^T and dS^T
// in dkv), B (16 x N) MN-major in shared memory (transpose bit set: V in
// the forward, K in dq, dO and q in dkv); d is 64 x N fp32, N = 32, 64 or
// 128.
#define FLASH_MMA_PV32(TY)                                                 \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15}, "                            \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                         \
      : FLASH_WG8("+f", d, 0), FLASH_WG8("+f", d, 8)                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
#define FLASH_MMA_PV64(TY)                                                 \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
      FLASH_WG_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"       \
      : FLASH_WG8("+f", d, 0), FLASH_WG8("+f", d, 8), FLASH_WG8("+f", d, 16), \
        FLASH_WG8("+f", d, 24)                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
#define FLASH_MMA_PV128(TY)                                                \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                           \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                           \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                           \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                           \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                           \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                         \
      : FLASH_WG8("+f", d, 0), FLASH_WG8("+f", d, 8), FLASH_WG8("+f", d, 16), \
        FLASH_WG8("+f", d, 24), FLASH_WG8("+f", d, 32),                    \
        FLASH_WG8("+f", d, 40), FLASH_WG8("+f", d, 48),                    \
        FLASH_WG8("+f", d, 56)                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename E, int N>
__device__ __forceinline__ void mma_pv(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 32 || N == 64 || N == 128, "N = 32, 64 or 128");
  constexpr bool kHalf = std::is_same_v<E, __half>;
  if constexpr (N == 32) {
    if constexpr (kHalf) FLASH_MMA_PV32("f16"); else FLASH_MMA_PV32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (kHalf) FLASH_MMA_PV64("f16"); else FLASH_MMA_PV64("bf16");
  } else {
    if constexpr (kHalf) FLASH_MMA_PV128("f16"); else FLASH_MMA_PV128("bf16");
  }
}
#undef FLASH_MMA_PV32
#undef FLASH_MMA_PV64
#undef FLASH_MMA_PV128

#undef FLASH_WG8
#undef FLASH_WG64
#undef FLASH_WG_REGS32
#undef FLASH_WG_REGS64

// Two fp32 values rounded to nearest into one word of E pairs (lo in the
// low half). Not saturating: an fp16 value past 65504 becomes inf, as the
// JAX kernels' astype(float16) makes it.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<E, __half>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The two fp32 values of a word of E pairs.
template <typename E>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (std::is_same_v<E, __half>)
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// e^x as 2^(x log2 e) by the special-function unit's `ex2.approx`
// (relative error about 2^-22, far inside the bf16 or fp16 rounding P
// takes next; results below the smallest normal flush to 0, as exp(-10000) does).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

}  // namespace wg
}  // namespace flash
