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
//
// Design: one thread block per (batch*head, 64-row q tile); a loop over
// 64-key K/V tiles staged in shared memory (as fp32, rows padded to an odd
// stride so column walks are free of bank conflicts); 256 threads in a
// 16 x 16 grid, each owning a 4 x 4 block of the score tile and a
// 4 x (head_dim / 16) block of the output. The rows of one thread group
// live in one half-warp, so the row max and row sum reduce with shuffles
// and P crosses only a warp through shared memory. The key bias and the
// sequence ids are read from [B, S] arrays: no per-head copy is made.
// q, k, v and out keep the model's [B, S, H, D] layout, so no transpose is
// launched around the kernel. The ragged edge (S not a multiple of 64) is
// masked: keys past S get probability 0, rows past S are not written.
//
// What bounds it on the H100: the scores and PV products run on the CUDA
// cores in fp32 (FMA), fed from shared memory at two FMAs per load, so
// the kernel is bound by shared-memory bandwidth and the fp32 pipes, far
// from the tensor-core rate that bounds the work itself at S >= 128.
// Moving both products onto the tensor cores (`wgmma` on bf16 tiles fed by
// TMA, with a warp-specialised producer) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kBlockQ / 16;   // score rows per thread
constexpr int kKeys = kBlockK / 16;   // score columns per thread
constexpr int kPStride = kBlockK + 1;
constexpr float kNegInf = -1e30f;     // _NEG_INF of the Pallas kernel
constexpr float kMasked = -10000.0f;  // additive mask convention

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The value P takes in the PV product: rounded to the value dtype.
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

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
flash_infer_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   const float* __restrict__ key_bias,
                   const int* __restrict__ seg, int seq, int heads,
                   int head_dim, float scale) {
  extern __shared__ float smem[];
  const int ld = head_dim + 1;  // odd stride: rows fall in distinct banks
  float* qs = smem;                         // [kBlockQ][ld]
  float* ks = qs + kBlockQ * ld;            // [kBlockK][ld]
  float* vs = ks + kBlockK * ld;            // [kBlockK][ld]
  float* ps = vs + kBlockK * ld;            // [kBlockQ][kPStride]
  float* kb = ps + kBlockQ * kPStride;      // [kBlockK]
  int* kseg = reinterpret_cast<int*>(kb + kBlockK);  // [kBlockK]
  int* qseg = kseg + kBlockK;                         // [kBlockQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int q0 = blockIdx.y * kBlockQ;
  const long long row_stride = static_cast<long long>(heads) * head_dim;
  const long long base =
      static_cast<long long>(b) * seq * row_stride +
      static_cast<long long>(h) * head_dim;
  const long long tok0 = static_cast<long long>(b) * seq;
  const bool segmented = seg != nullptr;

  for (int e = tid; e < kBlockQ * head_dim; e += kThreads) {
    const int r = e / head_dim;
    const int d = e - r * head_dim;
    const int s = q0 + r;
    qs[r * ld + d] = s < seq ? to_float(q[base + s * row_stride + d]) : 0.f;
  }
  if (segmented && tid < kBlockQ) {
    const int s = q0 + tid;
    qseg[tid] = s < seq ? seg[tok0 + s] : 0;
  }

  float m[kRows], l[kRows], acc[kRows][kChunks];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[i][c] = 0.f;
  }

  const int num_kb = (seq + kBlockK - 1) / kBlockK;
  for (int j = 0; j < num_kb; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBlockK * head_dim; e += kThreads) {
      const int r = e / head_dim;
      const int d = e - r * head_dim;
      const int s = k0 + r;
      const bool inside = s < seq;
      const long long off = base + s * row_stride + d;
      ks[r * ld + d] = inside ? to_float(k[off]) : 0.f;
      vs[r * ld + d] = inside ? to_float(v[off]) : 0.f;
    }
    if (tid < kBlockK) {
      const int s = k0 + tid;
      kb[tid] = (key_bias != nullptr && s < seq) ? key_bias[tok0 + s] : 0.f;
      if (segmented) kseg[tid] = s < seq ? seg[tok0 + s] : 0;
    }
    __syncthreads();

    // Score block: rows ty + 16 i, keys tx + 16 c.
    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) sc[i][c] = 0.f;
    for (int d = 0; d < head_dim; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int c = 0; c < kKeys; ++c) kv[c] = ks[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kKeys; ++c)
          sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }

    // Online softmax over this key tile, one half-warp per row group.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      float tile_max = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int kk = tx + 16 * c;
        float s = sc[i][c] * scale + kb[kk];
        if (segmented) {
          const int qid = qseg[r];
          s += (qid == kseg[kk] && qid > 0) ? 0.f : kMasked;
        }
        sc[i][c] = s;
        if (k0 + kk < seq) tile_max = fmaxf(tile_max, s);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int kk = tx + 16 * c;
        const float p = (k0 + kk < seq) ? expf(sc[i][c] - m_new) : 0.f;
        row_sum += p;  // l sums the unrounded probabilities
        ps[r * kPStride + kk] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // P rows are written and read by the same half-warp

    const int keys = min(kBlockK, seq - k0);
    for (int kk = 0; kk < keys; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < head_dim ? vs[kk * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= seq) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = tx + 16 * c;
      if (d < head_dim)
        out[base + s * row_stride + d] = from_float<T>(acc[i][c] / l[i]);
    }
  }
}

template <typename T, int kChunks>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const float* key_bias, const int* seg, int batch, int seq,
                   int heads, int head_dim, float scale,
                   cudaStream_t stream) {
  const int ld = head_dim + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlockQ + 2 * kBlockK) * ld +
                       kBlockQ * kPStride + kBlockK) +
      sizeof(int) * (kBlockK + kBlockQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_infer_kernel<T, kChunks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. key_bias ([B, S] fp32) and seg
// ([B, S] int32) may each be null. Returns the launch's cudaError_t.
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

const char* flash_attention_infer_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
