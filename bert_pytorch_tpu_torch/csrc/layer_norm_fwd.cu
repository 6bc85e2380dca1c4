// Row LayerNorm forward for BERT, written by hand for Hopper.
//
// Replaces the TPU kernel `_ln_fwd_kernel` (bert_pytorch_tpu/ops/pallas/
// layernorm.py, called through `_ln_forward` and `layer_norm_pallas`).
// For x [rows, H] in fp32, bf16 or fp16 and fp32 scale/bias [H], per row:
//
//   mean = sum(x) / H                      (fp32)
//   var  = sum((x - mean)^2) / H           (two passes, as the TPU kernel)
//   rstd = rsqrt(var + eps)
//   out  = ((x - mean) * rstd) * scale + bias, cast to x's dtype (round
//          to nearest: an fp16 value past 65504 is inf, as on the TPU)
//
// and mean, rstd saved as fp32 [rows, 1] for the backward (plain PyTorch,
// as the JAX package's backward is plain XLA). A row whose values are all
// equal has var = 0 and rstd = rsqrt(eps) (1e6 at eps 1e-12), as on the
// TPU: nothing is guarded.
//
// Design: one warp per row, four rows per 128-thread block. The row lives
// in registers (at most 128 fp32 values a lane at H = 4096), so x is read
// from device memory once and both reductions are warp shuffles: no shared
// memory and no second read. Each lane loads 16 bytes at a time (8 bf16 or
// fp16, or 4 fp32, neighbouring lanes on neighbouring addresses) where H and every
// pointer allow it, and one element at a time otherwise. The affine step
// is rounded as the plain version rounds it (a multiply, then an add: no
// fused multiply-add), so with equal statistics the outputs are equal.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (plus 8 bytes of statistics a row) for about 7 fp32 operations, far
// below the card's ratio of operations to bytes; at [12288, 1024] bf16 the
// bound is 15 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;  // rows per block
constexpr int kMaxHidden = 4096;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);  // round to nearest even, as torch's cast
}

// kVec contiguous elements at p as floats: one 16-byte load where kVec
// fills it, else one load per element.
template <typename T, int kVec>
__device__ __forceinline__ void load(const T* p, float* out) {
  if constexpr (kVec * sizeof(T) == 16) {
    alignas(16) T tmp[kVec];
    *reinterpret_cast<uint4*>(tmp) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = to_float(tmp[i]);
  } else if constexpr (kVec % 4 == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      out[i] = t.x, out[i + 1] = t.y, out[i + 2] = t.z, out[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = to_float(p[i]);
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store(T* p, const float* in) {
  if constexpr (kVec * sizeof(T) == 16) {
    alignas(16) T tmp[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) tmp[i] = from_float<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(tmp);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) p[i] = from_float<T>(in[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// kVec: elements per load; kElems: the most elements one lane holds
// (a multiple of kVec). Lane l holds the chunks l, l + 32, l + 64, ...
// of kVec elements each.
template <typename T, int kVec, int kElems>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out,
                      float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, long long rows, int hidden,
                      float eps) {
  constexpr int kChunks = kElems / kVec;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * hidden;
  T* outr = out + row * hidden;
  const int n_chunks = hidden / kVec;

  float v[kElems];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = lane + 32 * j;
    if (c < n_chunks) {
      load<T, kVec>(xr + c * kVec, v + j * kVec);
#pragma unroll
      for (int i = 0; i < kVec; ++i) sum += v[j * kVec + i];
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(hidden);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (lane + 32 * j < n_chunks) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float d = v[j * kVec + i] - mean;
        v[j * kVec + i] = d;
        sq += d * d;
      }
    }
  }
  const float var = warp_sum(sq) / static_cast<float>(hidden);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = lane + 32 * j;
    if (c < n_chunks) {
      float s[kVec], b[kVec], y[kVec];
      load<float, kVec>(scale + c * kVec, s);
      load<float, kVec>(bias + c * kVec, b);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        y[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[j * kVec + i], rstd), s[i]),
                         b[i]);
      store<T, kVec>(outr + c * kVec, y);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int kVec, int kElems>
cudaError_t launch(const void* x, const float* scale, const float* bias,
                   void* out, float* mean, float* rstd, long long rows,
                   int hidden, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  layer_norm_fwd_kernel<T, kVec, kElems>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
          static_cast<const T*>(x), scale, bias, static_cast<T*>(out), mean,
          rstd, rows, hidden, eps);
  return cudaGetLastError();
}

// The smallest per-lane register row that holds `hidden` elements.
template <typename T, int kVec>
cudaError_t dispatch(const void* x, const float* scale, const float* bias,
                     void* out, float* mean, float* rstd, long long rows,
                     int hidden, float eps, cudaStream_t stream) {
  const int chunks_per_lane = (hidden / kVec + 31) / 32;
  const int per_lane = chunks_per_lane * kVec;
  if (per_lane <= 8)
    return launch<T, kVec, 8>(x, scale, bias, out, mean, rstd, rows, hidden,
                              eps, stream);
  if (per_lane <= 16)
    return launch<T, kVec, 16>(x, scale, bias, out, mean, rstd, rows, hidden,
                               eps, stream);
  if (per_lane <= 32)
    return launch<T, kVec, 32>(x, scale, bias, out, mean, rstd, rows, hidden,
                               eps, stream);
  if (per_lane <= 64)
    return launch<T, kVec, 64>(x, scale, bias, out, mean, rstd, rows, hidden,
                               eps, stream);
  return launch<T, kVec, 128>(x, scale, bias, out, mean, rstd, rows, hidden,
                              eps, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t run(const void* x, const float* scale, const float* bias,
                void* out, float* mean, float* rstd, long long rows,
                int hidden, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (hidden % kVec == 0 && aligned16(x) && aligned16(out) &&
      aligned16(scale) && aligned16(bias))
    return dispatch<T, kVec>(x, scale, bias, out, mean, rstd, rows, hidden,
                             eps, stream);
  return dispatch<T, 1>(x, scale, bias, out, mean, rstd, rows, hidden, eps,
                        stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. x and out [rows, hidden]
// contiguous, scale and bias [hidden] fp32, mean and rstd [rows] fp32.
// Returns the launch's cudaError_t.
int layer_norm_fwd(const void* x, const float* scale, const float* bias,
                   void* out, float* mean, float* rstd, long long rows,
                   int hidden, int dtype, float eps, void* stream) {
  if (rows <= 0 || hidden <= 0 || hidden > kMaxHidden ||
      (rows + kWarps - 1) / kWarps > 0x7fffffffLL ||
      dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0   ? run<float>(x, scale, bias, out, mean, rstd, rows, hidden,
                                eps, s)
      : dtype == 1 ? run<__nv_bfloat16>(x, scale, bias, out, mean, rstd, rows,
                                        hidden, eps, s)
                   : run<__half>(x, scale, bias, out, mean, rstd, rows, hidden,
                                 eps, s);
  return static_cast<int>(err);
}

const char* layer_norm_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
