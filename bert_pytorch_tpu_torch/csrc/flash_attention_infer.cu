// Forward-only fused attention for BERT serving, written by hand for Hopper.
//
// Replaces the TPU kernel `_infer_fwd_kernel` + `_infer_stream`
// (bert_pytorch_tpu/ops/pallas/attention.py, called through
// `flash_attention_infer`). Computes, per (batch, head):
//
//   s   = (q k^T) * scale + key_bias[b, k]   (+ -10000 where the packed
//                                            sequence ids of q and k differ
//                                            or q's id is 0)
//   out = softmax(s) v
//
// with fp32 scores, an fp32 online softmax (running max m, running sum l,
// fp32 accumulator) and, for bf16 inputs, P rounded to bf16 before the PV
// product (the Pallas kernel's `p.astype(v.dtype)`). Masking is additive
// (-10000), never -inf, and m starts at -1e30, so a row whose keys are all
// masked (a padded or all-pad row) still comes out finite, as on the TPU.
// q, k, v and out keep the model's [B, S, H, D] layout, so no transpose is
// launched around the kernel; the key bias and the sequence ids are read
// from [B, S] arrays, with no per-head copy.
//
// Two routes, chosen by the wrapper from dtype and head_dim before launch
// (ops/kernels/attention.py `infer_route`):
//
// * Tensor cores (`flash_infer_wgmma_kernel`, bf16 with head_dim 32, 64 or
//   128: every serving forward of the repo's configs). The score tile,
//   S = Q K^T by `wgmma.mma_async` m64n64k16 bf16 -> fp32 from TMA-loaded,
//   swizzled q and K tiles (`Bf16Scores`), the online softmax, P V (P from
//   registers, V by TMA through a 2-stage ring) and the output are the
//   stream shared with the int8 kernel and the training forward
//   (flash_infer_wgmma.cuh).
//   It replaces the CUDA-core route's fp32 FMA products, which were bound
//   by shared-memory bandwidth and the fp32 pipes (0.4802 ms at S=512
//   against a 0.0100 ms bound). What bounds it now: not the tensor cores
//   (QK^T and PV are ~1 clock of tensor-core work per score element) but
//   the softmax's instruction issue on the CUDA cores, ~10 instructions a
//   score element, so the stream keeps it lean: e^x by one `ex2.approx`,
//   index masks only on the ragged last tile, the bias read while the
//   score wgmma runs. At S=512 it reads 3.8x its byte bound, level with
//   SDPA (PERF.md). The route is a template on its tile geometry
//   (block_q, block_k) with a runtime bh_block (flash_infer_wgmma.cuh):
//   (64, 64) at every head dim, the four tiles of 64 and 128 at head dim
//   64 (`dispatch_geometry`), chosen per call by the wrapper from a
//   measured winner (ops/kernels/autotune.py) or the default (64, 64, 1).
// * CUDA cores (`flash_infer_kernel`, fp32 inputs and any other head_dim,
//   a multiple of 8 up to 128): one thread block per (batch*head, 64-row
//   q tile); q and each 64-key K tile staged in shared memory as fp32
//   (rows padded to an odd stride so column walks are free of bank
//   conflicts); each of the 256 threads computes a 4 x 4 block of the
//   score tile with fp32 FMAs; softmax and PV from the CUDA-core stream
//   (flash_infer_stream.cuh). Bound by shared-memory bandwidth and the
//   fp32 pipes.

#include "flash_infer_stream.cuh"
#include "flash_infer_wgmma.cuh"

namespace {

using flash::kPer;
using flash::kThreads;
using flash::kTile;
using flash::to_float;

// The fp score tile: q rows and K tiles staged as fp32, products by FMA.
template <typename T>
struct FloatScores {
  const T* q;
  const T* k;
  float* qs;  // [kTile][ld]
  float* ks;  // [kTile][ld]
  int seq, head_dim, ld;
  long long base, row_stride;

  __device__ __forceinline__ void load_queries(int q0) const {
    for (int e = threadIdx.x; e < kTile * head_dim; e += kThreads) {
      const int r = e / head_dim;
      const int d = e - r * head_dim;
      const int s = q0 + r;
      qs[r * ld + d] =
          s < seq ? to_float(q[base + s * row_stride + d]) : 0.f;
    }
  }

  // K elements are staged in the stream's V pass.
  __device__ __forceinline__ void load_keys(int) const {}

  __device__ __forceinline__ void stage_key(int r, int d, bool inside,
                                            long long off) const {
    ks[r * ld + d] = inside ? to_float(k[off]) : 0.f;
  }

  __device__ __forceinline__ void tile(float (&sc)[kPer][kPer]) const {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kPer; ++c) sc[i][c] = 0.f;
    for (int d = 0; d < head_dim; ++d) {
      float qv[kPer], kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) qv[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int c = 0; c < kPer; ++c) kv[c] = ks[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }
  }
};

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
flash_infer_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   const float* __restrict__ key_bias,
                   const int* __restrict__ seg, int seq, int heads,
                   int head_dim, float scale) {
  extern __shared__ float smem[];
  const int ld = head_dim + 1;  // odd stride: rows fall in distinct banks
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int q0 = blockIdx.y * kTile;
  const long long row_stride = static_cast<long long>(heads) * head_dim;
  const long long base =
      static_cast<long long>(b) * seq * row_stride +
      static_cast<long long>(h) * head_dim;
  FloatScores<T> scores{q, k, smem, smem + kTile * ld, seq, head_dim, ld,
                        base, row_stride};
  scores.load_queries(q0);
  flash::infer_stream<T, kChunks>(
      scores, scale, v, out, key_bias, seg, seq, head_dim, base, row_stride,
      static_cast<long long>(b) * seq, q0, smem + 2 * kTile * ld);
}

template <typename T, int kChunks>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const float* key_bias, const int* seg, int batch, int seq,
                   int heads, int head_dim, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * 2 * kTile * static_cast<size_t>(head_dim + 1) +
      flash::stream_smem_bytes(head_dim);
  cudaError_t err = cudaFuncSetAttribute(
      flash_infer_kernel<T, kChunks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  flash_infer_kernel<T, kChunks><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), key_bias, seg, seq,
      heads, head_dim, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     const float* key_bias, const int* seg, int batch,
                     int seq, int heads, int head_dim, float scale,
                     cudaStream_t stream) {
  if (head_dim <= 64)
    return launch<T, 4>(q, k, v, out, key_bias, seg, batch, seq, heads,
                        head_dim, scale, stream);
  return launch<T, 8>(q, k, v, out, key_bias, seg, batch, seq, heads,
                      head_dim, scale, stream);
}

template <int D, int kBlockQ, int kBlockK>
__global__ void __launch_bounds__(kBlockQ / flash::wg::kRows *
                                  flash::wg::kThreads)
flash_infer_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         __nv_bfloat16* __restrict__ out,
                         const float* __restrict__ key_bias,
                         const int* __restrict__ seg, int seq, int heads,
                         float scale, int bh_block) {
  extern __shared__ float smem[];  // the same symbol as the CUDA-core kernel's
  flash::wg::Bf16Scores<D, kBlockK> scores{&qmap, &kmap};
  flash::wg::forward_stream<D, false, kBlockQ>(
      scores, scale, &vmap, out, key_bias, seg, seq, heads,
      reinterpret_cast<uint8_t*>(smem), flash::wg::Serve{}, bh_block);
}

template <int D, int kBlockQ, int kBlockK>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, const float* key_bias, const int* seg,
                         int batch, int seq, int heads, float scale,
                         int bh_block, cudaStream_t stream) {
  constexpr int kChunk = flash::wg::Tile<2 * D>::kChunk;
  CUtensorMap maps[3];
  const void* srcs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = flash::wg::bshd_map(
        &maps[i], srcs[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kChunk, batch,
        seq, heads, D);
    if (err != cudaSuccess) return err;
  }
  using Scores = flash::wg::Bf16Scores<D, kBlockK>;
  constexpr size_t smem = flash::wg::smem_bytes<Scores, D, kBlockQ>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_infer_wgmma_kernel<D, kBlockQ, kBlockK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads / bh_block, (seq + kBlockQ - 1) / kBlockQ);
  flash_infer_wgmma_kernel<D, kBlockQ, kBlockK>
      <<<grid, kBlockQ / flash::wg::kRows * flash::wg::kThreads, smem,
         stream>>>(maps[0], maps[1], maps[2],
                   static_cast<__nv_bfloat16*>(out), key_bias, seg, seq,
                   heads, scale, bh_block);
  return cudaGetLastError();
}

// The tile (block_q, block_k) this head dim instantiates, or
// cudaErrorInvalidValue: every head dim takes (64, 64); head dim 64 also
// (64, 128), (128, 64) and (128, 128) (ops/kernels/autotune.py TILES).
template <int D>
cudaError_t dispatch_geometry(const void* q, const void* k, const void* v,
                              void* out, const float* key_bias,
                              const int* seg, int batch, int seq, int heads,
                              float scale, int block_q, int block_k,
                              int bh_block, cudaStream_t stream) {
  if (block_q == 64 && block_k == 64)
    return launch_wgmma<D, 64, 64>(q, k, v, out, key_bias, seg, batch, seq,
                                   heads, scale, bh_block, stream);
  if constexpr (D == 64) {
    if (block_q == 64 && block_k == 128)
      return launch_wgmma<D, 64, 128>(q, k, v, out, key_bias, seg, batch,
                                      seq, heads, scale, bh_block, stream);
    if (block_q == 128 && block_k == 64)
      return launch_wgmma<D, 128, 64>(q, k, v, out, key_bias, seg, batch,
                                      seq, heads, scale, bh_block, stream);
    if (block_q == 128 && block_k == 128)
      return launch_wgmma<D, 128, 128>(q, k, v, out, key_bias, seg, batch,
                                       seq, heads, scale, bh_block, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The CUDA-core route. dtype: 0 = float32, 1 = bfloat16. key_bias
// ([B, S] fp32) and seg ([B, S] int32) may each be null. Returns the
// launch's cudaError_t.
int flash_attention_infer(const void* q, const void* k, const void* v,
                          void* out, const float* key_bias, const int* seg,
                          int batch, int seq, int heads, int head_dim,
                          int dtype, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 ||
      head_dim > 128 || head_dim % 8 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, out, key_bias, seg, batch, seq, heads,
                            head_dim, scale, s)
          : dispatch<__nv_bfloat16>(q, k, v, out, key_bias, seg, batch, seq,
                                    heads, head_dim, scale, s);
  return static_cast<int>(err);
}

// The tensor-core route: q, k, v, out [B, S, H, D] bfloat16, 16-byte
// aligned, head_dim 32, 64 or 128; key_bias and seg as above; the tile
// geometry (block_q, block_k, bh_block): a tile dispatch_geometry
// instantiates for head_dim and a bh_block >= 1 dividing batch * heads
// (the default (64, 64, 1) takes any shape). Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a geometry it does not take,
// cudaErrorSymbolNotFound if the driver has no cuTensorMapEncodeTiled).
int flash_attention_infer_wgmma(const void* q, const void* k, const void* v,
                                void* out, const float* key_bias,
                                const int* seg, int batch, int seq,
                                int heads, int head_dim, float scale,
                                int block_q, int block_k, int bh_block,
                                void* stream) {
  const void* ptrs[4] = {q, k, v, out};
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
      err = dispatch_geometry<32>(q, k, v, out, key_bias, seg, batch, seq,
                                  heads, scale, block_q, block_k, bh_block,
                                  s);
      break;
    case 64:
      err = dispatch_geometry<64>(q, k, v, out, key_bias, seg, batch, seq,
                                  heads, scale, block_q, block_k, bh_block,
                                  s);
      break;
    case 128:
      err = dispatch_geometry<128>(q, k, v, out, key_bias, seg, batch, seq,
                                   heads, scale, block_q, block_k, bh_block,
                                   s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_infer_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
