// Forward-only fused attention with int8 scores for BERT serving, written by
// hand for Hopper.
//
// Replaces the TPU kernel `_infer_fwd_kernel_int8` + `_infer_stream`
// (bert_pytorch_tpu/ops/pallas/attention.py, called through
// `flash_attention_infer_int8`). q and k arrive already quantized to int8
// with one symmetric fp32 scale per (batch, head) over (S, D) (the wrapper
// quantizes them with plain tensor ops, as the JAX wrapper does with
// `quant.quantize_symmetric` outside its kernel). Per (batch, head):
//
//   s32 = q8 k8^T                                  (exact, int32)
//   s   = float(s32) * ((q_scale * k_scale) * scale) + key_bias[b, k]
//                                                  (+ -10000 where the
//                                                  packed ids differ or
//                                                  q's id is 0)
//   out = softmax(s) v                             (in v's dtype)
//
// The rescale is formed in that order once per (batch, head) slice a block
// takes, and everything after
// the raw product is the stream shared with the fp kernel #4: the same
// online softmax, P rounded to v's dtype before PV with fp32 accumulation,
// the same masking and edges.
//
// Two routes, chosen by the wrapper from v's dtype and head_dim before
// launch (ops/kernels/attention.py `infer_route`):
//
// * Tensor cores (`flash_infer_int8_wgmma_kernel`, v in bf16 with head_dim
//   32, 64 or 128: every int8 serving forward of the repo's configs). The
//   q8 and each K8 tile come by TMA (rows of head_dim bytes, swizzled by
//   that width: 64 bytes at D=64), both K-major, as 8-bit wgmma requires;
//   S is `wgmma.mma_async` m64nNk32 s8 x s8 -> s32 (N the key tile, 64 or
//   128; the tile geometry is the fp kernel's), exact, converted to
//   fp32 and multiplied by the rescale; the softmax, P V (bf16 P from
//   registers, V by TMA) and the output are #4's tensor-core stream
//   (flash_infer_wgmma.cuh). It replaces `__dp4a` products and fp32-FMA
//   PV on the CUDA cores, bound by shared-memory traffic (0.3765 ms at
//   S=512 against a 0.0075 ms bound). What bounds it now: as in #4, the
//   softmax's instruction issue on the CUDA cores, which the shared
//   stream keeps lean; the work itself is bound by bytes (q8 and k8 at
//   1 B an element, v and out at 2 B). At S=512 it reads 4.8x that bound,
//   a little under bf16 SDPA on the dequantized q and k (PERF.md).
// * CUDA cores (`flash_infer_int8_kernel`, v in fp32 and any other
//   head_dim): one thread block per (batch*head, 64-row q tile), 256
//   threads. The q rows and each 64-key K tile are staged in shared memory
//   as 32-bit words of four int8 values (rows padded to an odd word
//   stride, so the 16 key rows a half-warp reads fall in distinct banks);
//   each thread computes a 4 x 4 block of int32 scores with `__dp4a` (four
//   int8 products and their sum per instruction, exact); softmax and PV
//   from the CUDA-core stream (flash_infer_stream.cuh), V staged as fp32.
//   Bound by shared-memory traffic and the CUDA-core pipes.

#include <stdint.h>

#include "flash_infer_stream.cuh"
#include "flash_infer_wgmma.cuh"

namespace {

using flash::kPer;
using flash::kThreads;
using flash::kTile;

// The int8 score tile: rows of head_dim int8 values as head_dim / 4 words
// (head_dim, the row stride and every row's offset are multiples of 4, so
// element offsets divide into word offsets exactly).
struct Int8Scores {
  const int* q;  // q8 viewed as 32-bit words
  const int* k;  // k8 viewed as 32-bit words
  int* qs;       // [kTile][ldw]
  int* ks;       // [kTile][ldw]
  int seq, words, ldw;
  long long base, row_stride;  // in elements

  __device__ __forceinline__ void load_rows(const int* src, int* dst,
                                            int s0) const {
    for (int e = threadIdx.x; e < kTile * words; e += kThreads) {
      const int r = e / words;
      const int w = e - r * words;
      const int s = s0 + r;
      dst[r * ldw + w] = s < seq ? src[(base + s * row_stride) / 4 + w] : 0;
    }
  }

  __device__ __forceinline__ void load_queries(int q0) const {
    load_rows(q, qs, q0);
  }

  // The K words in a pass of their own (a quarter of the V pass's steps).
  __device__ __forceinline__ void load_keys(int k0) const {
    load_rows(k, ks, k0);
  }

  __device__ __forceinline__ void stage_key(int, int, bool,
                                            long long) const {}

  __device__ __forceinline__ void tile(float (&sc)[kPer][kPer]) const {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    int acc[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kPer; ++c) acc[i][c] = 0;
    for (int w = 0; w < words; ++w) {
      int qv[kPer], kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) qv[i] = qs[(ty + 16 * i) * ldw + w];
#pragma unroll
      for (int c = 0; c < kPer; ++c) kv[c] = ks[(tx + 16 * c) * ldw + w];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          acc[i][c] = __dp4a(qv[i], kv[c], acc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        sc[i][c] = static_cast<float>(acc[i][c]);
  }
};

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
flash_infer_int8_kernel(const int8_t* __restrict__ q8,
                        const int8_t* __restrict__ k8,
                        const T* __restrict__ v, T* __restrict__ out,
                        const float* __restrict__ q_scale,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ key_bias,
                        const int* __restrict__ seg, int seq, int heads,
                        int head_dim, float scale) {
  extern __shared__ float smem[];
  const int words = head_dim / 4;
  const int ldw = words + 1;  // odd stride: rows fall in distinct banks
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kTile;
  const long long row_stride = static_cast<long long>(heads) * head_dim;
  const long long base =
      static_cast<long long>(b) * seq * row_stride +
      static_cast<long long>(h) * head_dim;
  int* qs = reinterpret_cast<int*>(smem);
  Int8Scores scores{reinterpret_cast<const int*>(q8),
                    reinterpret_cast<const int*>(k8),
                    qs, qs + kTile * ldw, seq, words, ldw, base, row_stride};
  scores.load_queries(q0);
  const float rescale = (q_scale[bh] * k_scale[bh]) * scale;
  flash::infer_stream<T, kChunks>(
      scores, rescale, v, out, key_bias, seg, seq, head_dim, base,
      row_stride, static_cast<long long>(b) * seq, q0,
      smem + 2 * kTile * ldw);
}

template <typename T, int kChunks>
cudaError_t launch(const void* q8, const void* k8, const void* v, void* out,
                   const float* q_scale, const float* k_scale,
                   const float* key_bias, const int* seg, int batch, int seq,
                   int heads, int head_dim, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(int) * 2 * kTile * static_cast<size_t>(head_dim / 4 + 1) +
      flash::stream_smem_bytes(head_dim);
  cudaError_t err = cudaFuncSetAttribute(
      flash_infer_int8_kernel<T, kChunks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  flash_infer_int8_kernel<T, kChunks><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const T*>(v), static_cast<T*>(out), q_scale, k_scale,
      key_bias, seg, seq, heads, head_dim, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q8, const void* k8, const void* v,
                     void* out, const float* q_scale, const float* k_scale,
                     const float* key_bias, const int* seg, int batch,
                     int seq, int heads, int head_dim, float scale,
                     cudaStream_t stream) {
  if (head_dim <= 64)
    return launch<T, 4>(q8, k8, v, out, q_scale, k_scale, key_bias, seg,
                        batch, seq, heads, head_dim, scale, stream);
  return launch<T, 8>(q8, k8, v, out, q_scale, k_scale, key_bias, seg,
                      batch, seq, heads, head_dim, scale, stream);
}

// The tensor-core score tile: an int8 q8 tile and kN-key K8 tiles by TMA,
// exact int32 S by wgmma, handed on as fp32; the score scale of slice bh is
// (q_scale[bh] * k_scale[bh]) * scale.
template <int D, int kKeys>
struct WgmmaInt8Scores {
  static constexpr int kN = kKeys;
  static constexpr int kQBytes = flash::wg::Tile<D>::kBytes;
  static constexpr int kKBytes = flash::wg::Tile<D, kN>::kBytes;
  const CUtensorMap* qmap;
  const CUtensorMap* kmap;
  const float* q_scale;
  const float* k_scale;
  int acc[kN / 2];

  __device__ __forceinline__ void load_q(uint32_t dst, uint32_t bar, int h,
                                         int s, int b) const {
    flash::wg::load_tile<D, 1>(dst, qmap, bar, h, s, b);
  }
  __device__ __forceinline__ void load_k(uint32_t dst, uint32_t bar, int h,
                                         int s, int b) const {
    flash::wg::load_tile<D, 1, kN>(dst, kmap, bar, h, s, b);
  }
  __device__ __forceinline__ float head_scale(int bh, float scale) const {
    return (q_scale[bh] * k_scale[bh]) * scale;
  }
  __device__ __forceinline__ void issue(uint32_t qs, uint32_t ks,
                                        float (&)[kN / 2]) {
    flash::wg::pin(acc);
    flash::wg::wgmma_fence();
#pragma unroll
    for (int step = 0; step < D / 32; ++step)
      flash::wg::mma_s8_ss<kN>(acc, flash::wg::k_major<D>(qs, step),
                               flash::wg::k_major<D, kN>(ks, step),
                               step > 0);
    flash::wg::wgmma_commit();
  }
  __device__ __forceinline__ void finish(float (&s)[kN / 2]) {
    flash::wg::wgmma_wait();
    flash::wg::pin(acc);
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) s[e] = static_cast<float>(acc[e]);
  }
};

template <int D, int kBlockQ, int kBlockK>
__global__ void __launch_bounds__(kBlockQ / flash::wg::kRows *
                                  flash::wg::kThreads)
flash_infer_int8_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              __nv_bfloat16* __restrict__ out,
                              const float* __restrict__ q_scale,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ key_bias,
                              const int* __restrict__ seg, int seq,
                              int heads, float scale, int bh_block) {
  extern __shared__ float smem[];  // the same symbol as the CUDA-core kernel's
  WgmmaInt8Scores<D, kBlockK> scores{&qmap, &kmap, q_scale, k_scale};
  flash::wg::forward_stream<D, false, kBlockQ>(
      scores, scale, &vmap, out, key_bias, seg, seq, heads,
      reinterpret_cast<uint8_t*>(smem), flash::wg::Serve{}, bh_block);
}

template <int D, int kBlockQ, int kBlockK>
cudaError_t launch_wgmma(const void* q8, const void* k8, const void* v,
                         void* out, const float* q_scale,
                         const float* k_scale, const float* key_bias,
                         const int* seg, int batch, int seq, int heads,
                         float scale, int bh_block, cudaStream_t stream) {
  CUtensorMap maps[3];
  cudaError_t err = flash::wg::bshd_map(
      &maps[0], q8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
      flash::wg::Tile<D>::kChunk, batch, seq, heads, D);
  if (err == cudaSuccess)
    err = flash::wg::bshd_map(&maps[1], k8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              flash::wg::Tile<D>::kChunk, batch, seq, heads,
                              D);
  if (err == cudaSuccess)
    err = flash::wg::bshd_map(&maps[2], v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              2, flash::wg::Tile<2 * D>::kChunk, batch, seq,
                              heads, D);
  if (err != cudaSuccess) return err;
  using Scores = WgmmaInt8Scores<D, kBlockK>;
  constexpr size_t smem = flash::wg::smem_bytes<Scores, D, kBlockQ>();
  err = cudaFuncSetAttribute(flash_infer_int8_wgmma_kernel<D, kBlockQ, kBlockK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads / bh_block, (seq + kBlockQ - 1) / kBlockQ);
  flash_infer_int8_wgmma_kernel<D, kBlockQ, kBlockK>
      <<<grid, kBlockQ / flash::wg::kRows * flash::wg::kThreads, smem,
         stream>>>(maps[0], maps[1], maps[2],
                   static_cast<__nv_bfloat16*>(out), q_scale, k_scale,
                   key_bias, seg, seq, heads, scale, bh_block);
  return cudaGetLastError();
}

// The tile (block_q, block_k) this head dim instantiates, or
// cudaErrorInvalidValue: the fp kernel's (flash_attention_infer.cu).
template <int D>
cudaError_t dispatch_geometry(const void* q8, const void* k8, const void* v,
                              void* out, const float* q_scale,
                              const float* k_scale, const float* key_bias,
                              const int* seg, int batch, int seq, int heads,
                              float scale, int block_q, int block_k,
                              int bh_block, cudaStream_t stream) {
  if (block_q == 64 && block_k == 64)
    return launch_wgmma<D, 64, 64>(q8, k8, v, out, q_scale, k_scale,
                                   key_bias, seg, batch, seq, heads, scale,
                                   bh_block, stream);
  if constexpr (D == 64) {
    if (block_q == 64 && block_k == 128)
      return launch_wgmma<D, 64, 128>(q8, k8, v, out, q_scale, k_scale,
                                      key_bias, seg, batch, seq, heads,
                                      scale, bh_block, stream);
    if (block_q == 128 && block_k == 64)
      return launch_wgmma<D, 128, 64>(q8, k8, v, out, q_scale, k_scale,
                                      key_bias, seg, batch, seq, heads,
                                      scale, bh_block, stream);
    if (block_q == 128 && block_k == 128)
      return launch_wgmma<D, 128, 128>(q8, k8, v, out, q_scale, k_scale,
                                       key_bias, seg, batch, seq, heads,
                                       scale, bh_block, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The CUDA-core route. q8, k8: [B, S, H, D] int8, 4-byte aligned; v, out:
// [B, S, H, D] in dtype (0 = float32, 1 = bfloat16); q_scale, k_scale: [B, H] fp32.
// key_bias ([B, S] fp32) and seg ([B, S] int32) may each be null. Returns
// the launch's cudaError_t.
int flash_attention_infer_int8(const void* q8, const void* k8, const void* v,
                               void* out, const float* q_scale,
                               const float* k_scale, const float* key_bias,
                               const int* seg, int batch, int seq, int heads,
                               int head_dim, int dtype, float scale,
                               void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 ||
      head_dim > 128 || head_dim % 8 != 0 || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(q8) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(k8) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(q8, k8, v, out, q_scale, k_scale, key_bias, seg,
                            batch, seq, heads, head_dim, scale, s)
          : dispatch<__nv_bfloat16>(q8, k8, v, out, q_scale, k_scale,
                                    key_bias, seg, batch, seq, heads,
                                    head_dim, scale, s);
  return static_cast<int>(err);
}

// The tensor-core route: q8, k8 [B, S, H, D] int8 and v, out bfloat16,
// each 16-byte aligned, head_dim 32, 64 or 128; the scales, key_bias and
// seg as above; the tile geometry (block_q, block_k, bh_block) as for the
// fp kernel. Returns the launch's cudaError_t (cudaErrorInvalidValue for a
// geometry it does not take, cudaErrorSymbolNotFound if the driver has no
// cuTensorMapEncodeTiled).
int flash_attention_infer_int8_wgmma(const void* q8, const void* k8,
                                     const void* v, void* out,
                                     const float* q_scale,
                                     const float* k_scale,
                                     const float* key_bias, const int* seg,
                                     int batch, int seq, int heads,
                                     int head_dim, float scale, int block_q,
                                     int block_k, int bh_block,
                                     void* stream) {
  const void* ptrs[4] = {q8, k8, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || seq <= 0 || heads <= 0 || bh_block <= 0 ||
      (batch * heads) % bh_block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 32:
      err = dispatch_geometry<32>(q8, k8, v, out, q_scale, k_scale, key_bias,
                                  seg, batch, seq, heads, scale, block_q,
                                  block_k, bh_block, s);
      break;
    case 64:
      err = dispatch_geometry<64>(q8, k8, v, out, q_scale, k_scale, key_bias,
                                  seg, batch, seq, heads, scale, block_q,
                                  block_k, bh_block, s);
      break;
    case 128:
      err = dispatch_geometry<128>(q8, k8, v, out, q_scale, k_scale,
                                   key_bias, seg, batch, seq, heads, scale,
                                   block_q, block_k, bh_block, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_infer_int8_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
