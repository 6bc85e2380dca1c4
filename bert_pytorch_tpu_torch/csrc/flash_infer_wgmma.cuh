// The tensor-core route of the serving attention kernels, for Hopper
// (sm_90a): flash_attention_infer.cu (fp scores, TPU kernel #4) and
// flash_attention_infer_int8.cu (int8 scores, TPU kernel #5) each supply a
// score tile; the online softmax, the PV product and the output are the one
// body below, as `_infer_stream` in bert_pytorch_tpu/ops/pallas/attention.py
// is shared by `_infer_fwd_kernel` and `_infer_fwd_kernel_int8`.
//
// The function and its numerics are those of flash_infer_stream.cuh (the
// CUDA-core route): s = raw * scale + key_bias (+ -10000 where the packed
// ids differ or q's id is 0; product and sum rounded apart, as the plain
// version rounds them), m from -1e30, l summing the unrounded
// probabilities, P rounded to bf16 before PV with fp32 accumulation,
// out = acc / l in bf16, keys past S at probability 0 by index and rows
// past S not written; only e^x differs, taken by the hardware's
// ex2.approx. Only bf16 v (and out) take this route.
//
// Design, one thread block per (batch*head, 64 query rows), one warpgroup
// (128 threads):
//   * TMA brings the q tile once and each 64-key K and V tile through a
//     2-stage ring in shared memory, completing on one mbarrier per stage
//     (the expected bytes are the full boxes: TMA counts zero-filled rows
//     too). Thread 0 issues tile j + 2 into the stage tile j used, once
//     every thread is past it, so the next tile is in flight while this
//     one is computed.
//   * The [B, S, H, D] layout stays: each tensor is a 4-D map (D, H, S, B)
//     with a box of (chunk, 1, 64, 1), so the ragged S edge zero-fills
//     inside the batch instead of reading the next batch's rows. A row of
//     up to 128 bytes is one box swizzled by its width (32, 64 or 128
//     bytes); a 256-byte row (bf16 D = 128) is two 128-byte boxes.
//   * S = Q K^T is `wgmma.mma_async` m64n64 with both operands K-major in
//     shared memory (k16 for bf16, k32 for int8 -> int32, exact); the
//     Scores object issues it and hands back raw fp32 products.
//   * The online softmax runs on the accumulator fragments: thread t of
//     warp w owns rows 16w + t/4 and 16w + t/4 + 8 and, per 8-key block j,
//     keys 8j + 2(t%4) and one more; row max and row sum reduce over the 4
//     threads of a quad with shuffles.
//   * P, rounded to bf16 in registers, is the A operand of the PV wgmma as
//     it stands (the S accumulator's fragment layout is the A-fragment
//     layout), and V is the B operand, MN-major (keys by D, D contiguous),
//     read with wgmma's transpose bit.
//   * The key bias and ids ([B, S] each) are read per key tile by each
//     thread for its own keys while the score wgmma runs: no per-head copy.
//   * The softmax's instructions on the CUDA cores, not the tensor cores,
//     set the time, so it is kept lean: e^x by one `ex2.approx`, and the
//     index checks for keys past S only on the ragged last tile.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_common.cuh"

namespace flash {
namespace wg {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // q rows per block, keys per tile (wgmma M)
constexpr int kStages = 2;

// A 64-row tile of rows of kRowBytes bytes, as TMA lays it out: chunks of
// up to 128 bytes per row (the swizzle span), each chunk 64 rows deep.
template <int kRowBytes>
struct Tile {
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes % 128 == 0,
                "rows of 32, 64 or a multiple of 128 bytes");
  static constexpr int kChunk = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kChunks = kRowBytes / kChunk;
  static constexpr int kBytes = kRows * kRowBytes;  // a multiple of 1024
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

// The 64 rows from s of one (b, h) head into a Tile<kRowBytes> at dst.
template <int kRowBytes, int kElem>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int h, int s, int b) {
  using T = Tile<kRowBytes>;
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
    tma_load(dst + c * kRows * T::kChunk, map, bar, c * T::kChunk / kElem, h,
             s, b);
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

// K-major operand (rows of K contiguous: the q and k tiles), at the k-step
// `step` of 32 bytes (k16 bf16 or k32 int8): 8-row groups 8 * chunk bytes
// apart; the leading offset is unused by swizzled K-major layouts.
template <int kRowBytes>
__device__ __forceinline__ uint64_t k_major(uint32_t base, int step) {
  using T = Tile<kRowBytes>;
  const int byte = step * 32;
  return descriptor(base + (byte / T::kChunk) * kRows * T::kChunk +
                        byte % T::kChunk,
                    16, 8 * T::kChunk, T::kChunk);
}

// MN-major B operand (the V tile: keys by D, D contiguous), at the key step
// `step` of 16 keys: the leading offset steps to the next chunk of D, the
// stride offset to the next 8 keys.
template <int kRowBytes>
__device__ __forceinline__ uint64_t mn_major(uint32_t base, int step) {
  using T = Tile<kRowBytes>;
  return descriptor(base + step * 16 * T::kChunk, kRows * T::kChunk,
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

// d (+)= A B^T for a 64 x 64 fp32 tile, bf16 A and B K-major in shared
// memory; `accumulate` 0 overwrites d.
__device__ __forceinline__ void mma_bf16_ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_WG8("+f", d, 0), FLASH_WG8("+f", d, 8), FLASH_WG8("+f", d, 16),
        FLASH_WG8("+f", d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same for int8 A and B (k32), int32 d: exact.
__device__ __forceinline__ void mma_s8_ss(int (&d)[32], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " FLASH_WG_REGS32
      ", %32, %33, p;\n}\n"
      : FLASH_WG8("+r", d, 0), FLASH_WG8("+r", d, 8), FLASH_WG8("+r", d, 16),
        FLASH_WG8("+r", d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += P V for one 16-key step: P (64 x 16 bf16) from registers, V
// (16 keys x N) MN-major in shared memory (transpose bit set); d is
// 64 x N fp32, N = 32, 64 or 128.
template <int N>
__device__ __forceinline__ void mma_pv(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void mma_pv<32>(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : FLASH_WG8("+f", d, 0), FLASH_WG8("+f", d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_pv<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_WG8("+f", d, 0), FLASH_WG8("+f", d, 8), FLASH_WG8("+f", d, 16),
        FLASH_WG8("+f", d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_pv<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FLASH_WG8("+f", d, 0), FLASH_WG8("+f", d, 8), FLASH_WG8("+f", d, 16),
        FLASH_WG8("+f", d, 24), FLASH_WG8("+f", d, 32),
        FLASH_WG8("+f", d, 40), FLASH_WG8("+f", d, 48),
        FLASH_WG8("+f", d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FLASH_WG8
#undef FLASH_WG_REGS32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
// (relative error about 2^-22, far inside the bf16 rounding P takes next;
// results below the smallest normal flush to 0, as exp(-10000) does).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The online softmax of one key tile on this thread's 32 accumulator
// elements (element e: row row0 + 8 * ((e >> 1) & 1), key k0 + 8 * (e >> 2)
// + col0 + (e & 1)), given the raw scores s and the bias kb and ids kid of
// its 16 keys: updates the running max m and this thread's share of the
// row sum l, leaves P in bf16 pairs (the A fragments of four k16 steps)
// and the factor alpha the output must be rescaled by. kFull: every key of
// the tile lies before S, so no key is masked by index.
template <bool kFull>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], const float (&kb)[16], const int (&kid)[16],
    const int (&qid)[2], bool segmented, float scale, int k0, int col0,
    int seq, float (&m)[2], float (&l)[2], float (&alpha)[2],
    uint32_t (&p)[16]) {
  float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e >> 1) & 1;
    const int c = 2 * (e >> 2) + (e & 1);
    float x = __fadd_rn(__fmul_rn(s[e], scale), kb[c]);  // no FMA
    if (segmented) x += seg_mask(qid[r], kid[c]);
    s[e] = x;
    if (kFull || k0 + 8 * (e >> 2) + col0 + (e & 1) < seq)
      tile_max[r] = fmaxf(tile_max[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(tile_max[r]));
    alpha[r] = exp_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = (e >> 1) & 1;
    float p0 = exp_approx(s[e] - m[r]);
    float p1 = exp_approx(s[e + 1] - m[r]);
    if (!kFull) {
      const int key = k0 + 8 * (e >> 2) + col0;
      p0 = key < seq ? p0 : 0.f;
      p1 = key + 1 < seq ? p1 : 0.f;
    }
    l[r] += p0 + p1;  // l sums the unrounded probabilities
    p[e >> 1] = pack_bf16(p0, p1);
  }
}

// Dynamic shared memory a kernel of this route asks for: the q tile, two
// K and two V stages (bf16 V, rows of 2 * head_dim bytes), three mbarriers,
// and 1024 bytes to align the base for the 128-byte swizzle.
template <class Scores, int D>
constexpr size_t smem_bytes() {
  return 1024 + Scores::kQBytes + kStages * Scores::kKBytes +
         kStages * Tile<2 * D>::kBytes + 3 * sizeof(uint64_t);
}

// The shared stream. `Scores` supplies:
//   kQBytes, kKBytes          the shared-memory bytes of its q and K tiles;
//   load_q(dst, bar, h, s, b) / load_k(...)
//                             issue the TMA loads of those tiles (thread 0);
//   issue(q, k, s)            start the score wgmma of q and K tiles at
//                             shared addresses q and k;
//   finish(s)                 wait for it and leave the raw fp32 products in
//                             s (the stream multiplies them by `scale`).
// Launch: grid (batch * heads, ceil(seq / 64)), kThreads threads,
// smem_bytes<Scores, D>() of dynamic shared memory.
template <int D, class Scores>
__device__ __forceinline__ void infer_stream(
    Scores& scores, float scale, const CUtensorMap* vmap,
    __nv_bfloat16* __restrict__ out, const float* __restrict__ key_bias,
    const int* __restrict__ seg, int seq, int heads, uint8_t* smem_raw) {
  using V = Tile<2 * D>;
  constexpr int kOut = D / 2;  // fp32 output values per thread
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int q0 = blockIdx.y * kRows;
  const long long tok0 = static_cast<long long>(b) * seq;
  const int num_kb = (seq + kRows - 1) / kRows;

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t k_s = q_s + Scores::kQBytes;
  const uint32_t v_s = k_s + kStages * Scores::kKBytes;
  const uint32_t bars = v_s + kStages * V::kBytes;  // full[0], full[1], q
  const uint32_t q_bar = bars + 8 * kStages;

  auto load_stage = [&](int j) {
    const int st = j % kStages;
    const uint32_t bar = bars + 8 * st;
    mbar_expect_tx(bar, Scores::kKBytes + V::kBytes);
    scores.load_k(k_s + st * Scores::kKBytes, bar, h, j * kRows, b);
    load_tile<2 * D, 2>(v_s + st * V::kBytes, vmap, bar, h, j * kRows, b);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, 1);
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, Scores::kQBytes);
    scores.load_q(q_s, q_bar, h, q0, b);
    for (int j = 0; j < kStages && j < num_kb; ++j) load_stage(j);
  }

  // This thread's two rows and its keys 8j + col0 (+1) of each tile.
  const int row0 = 16 * (tid >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const bool segmented = seg != nullptr;
  int qid[2] = {0, 0};
  if (segmented) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = q0 + row0 + 8 * r;
      qid[r] = s < seq ? seg[tok0 + s] : 0;
    }
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sum
  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < num_kb; ++j) {
    const int st = j % kStages;
    const int k0 = j * kRows;
    mbar_wait(bars + 8 * st, (j / kStages) & 1);

    float s[32];
    scores.issue(q_s, k_s + st * Scores::kKBytes, s);
    // The bias and ids of this thread's 16 keys, read while the MMA runs.
    const bool full = k0 + kRows <= seq;  // every key of the tile inside S
    float kb[16];
    int kid[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int key = k0 + 8 * (c >> 1) + col0 + (c & 1);
      const bool inside = full || key < seq;
      kb[c] = (key_bias != nullptr && inside) ? key_bias[tok0 + key] : 0.f;
      kid[c] = (segmented && inside) ? seg[tok0 + key] : 0;
    }
    scores.finish(s);

    float alpha[2];
    uint32_t p[16];  // P in bf16 pairs: the A fragments of four k16 steps
    if (full)
      softmax_tile<true>(s, kb, kid, qid, segmented, scale, k0, col0, seq, m,
                         l, alpha, p);
    else
      softmax_tile<false>(s, kb, kid, qid, segmented, scale, k0, col0, seq, m,
                          l, alpha, p);
#pragma unroll
    for (int i = 0; i < kOut; ++i) o[i] *= alpha[(i >> 1) & 1];

    pin(o);
    pin(p);
    wgmma_fence();
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const uint32_t a[4] = {p[4 * step], p[4 * step + 1], p[4 * step + 2],
                             p[4 * step + 3]};
      mma_pv<D>(o, a, mn_major<2 * D>(v_s + st * V::kBytes, step));
    }
    wgmma_commit();
    wgmma_wait();
    pin(o);

    __syncthreads();  // every read of this stage is done
    if (tid == 0 && j + kStages < num_kb) load_stage(j + kStages);
  }

  const long long row_stride = static_cast<long long>(heads) * D;
  const long long base = tok0 * row_stride + static_cast<long long>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + row0 + 8 * r;
    const float sum = quad_sum(l[r]);
    if (s >= seq) continue;
    __nv_bfloat16* dst = out + base + s * row_stride + col0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          o[4 * jj + 2 * r] / sum, o[4 * jj + 2 * r + 1] / sum);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) = v;
    }
  }
}

}  // namespace wg
}  // namespace flash
