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
// The rescale is formed in that order once per block, and everything after
// the raw product is the stream shared with the fp kernel #4
// (flash_infer_stream.cuh): the same online softmax, P rounded to v's
// dtype before PV with fp32 accumulation, the same masking and edges.
//
// Design: one thread block per (batch*head, 64-row q tile), 256 threads.
// The q rows and each 64-key K tile are staged in shared memory as 32-bit
// words of four int8 values (rows padded to an odd word stride, so the 16
// key rows a half-warp reads fall in distinct banks); each thread computes
// a 4 x 4 block of int32 scores with `__dp4a` (four int8 products and
// their sum per instruction, exact). V is staged as fp32 by the stream.
//
// What bounds it on the H100: the work itself is bound by bytes at these
// shapes (q8 and k8 at 1 B an element, v and out at 2 B in bf16, against
// QK^T at the int8 tensor-core rate of 1,979 TOP/s and PV at 989 TFLOP/s
// bf16). This first version runs both products on the CUDA cores
// (`__dp4a` for QK^T, fp32 FMA for PV from shared memory), so like #4 it
// is bound by shared-memory traffic and the CUDA-core pipes, far above
// that bound. What it does about it: the int8 tiles carry a quarter of the
// shared-memory bytes of #4's fp32 tiles into the score product and do four
// products per instruction; moving QK^T to `mma.sync`/`wgmma` int8 and PV
// to bf16 tensor cores is later work.

#include <stdint.h>

#include "flash_infer_stream.cuh"

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

}  // namespace

extern "C" {

// q8, k8: [B, S, H, D] int8, 4-byte aligned; v, out: [B, S, H, D] in
// dtype (0 = float32, 1 = bfloat16); q_scale, k_scale: [B, H] fp32.
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

const char* flash_attention_infer_int8_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
