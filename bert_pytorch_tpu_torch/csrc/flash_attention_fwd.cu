// Training flash-attention forward, written by hand for Hopper.
//
// Replaces the TPU kernel `_flash_fwd_kernel`
// (bert_pytorch_tpu/ops/pallas/attention.py, called through `_flash_forward`
// and `flash_attention`). Computes, per (batch, head):
//
//   s   = (q k^T) * scale + key_bias[b, k]   (+ -10000 where the packed
//                                            sequence ids differ or q's id
//                                            is 0)
//   p   = exp(s - m), with m the running row max seeded at -1e30
//   l   = sum of the UNDROPPED p, so lse = m + log(l) is the true
//         log-sum-exp the backward kernels recompute p from
//   out = sum(keep * p rounded to v's dtype) v / (l * (1 - rate))
//   lse -> [B*H, S] fp32
//
// with fp32 scores scaled after the product, an fp32 online softmax, P
// rounded to v's dtype before the PV product and fp32 accumulation, as the
// Pallas kernel does. The keep mask comes from the counter-based Philox of
// flash_attention_common.cuh, so the backward kernels regenerate it from
// the element coordinates alone. q, k, v, out keep the model's [B, S, H, D]
// layout and the key bias and sequence ids are read from [B, S] arrays:
// nothing is copied or transposed around the kernel. A ragged edge (S not
// a multiple of 64) is masked: keys past S get probability 0, rows past S
// are not written.
//
// Two routes, chosen by the wrapper from dtype and head_dim before launch
// (ops/kernels/attention.py `train_route`):
//
// * Tensor cores (`flash_fwd_wgmma_kernel`, bf16 with head_dim 32, 64 or
//   128: every training forward of the repo's configs). The serving
//   kernels' stream (flash_infer_wgmma.cuh) with its training additions:
//   one warpgroup per (batch*head, 64-row q tile); TMA brings q once and
//   K/V through a 2-stage ring; S = Q K^T and P V by `wgmma` (P from
//   registers); the online softmax on the accumulator fragments; the keep
//   mask drawn in registers for each thread's own elements while the score
//   wgmma runs (`keep_bits`: one Philox call per four keys of a row, the
//   two lanes that share them swapping halves), applied after l has summed
//   the undropped probabilities; lse written from the quad-reduced l with
//   the accurate log. It replaces the CUDA-core route's fp32 FMA products
//   (0.5199 ms at S=512 on an H100, against a 0.0101 ms bound). What
//   bounds it now: the CUDA cores, not the tensor cores: the softmax's
//   instructions and, with dropout, the Philox rounds (10 rounds of two
//   32-bit multiplies per four elements).
// * CUDA cores (`flash_fwd_kernel`, fp32 and any other head_dim, a multiple
//   of 8 up to 128): one thread block per (batch*head, 64-row q tile); a
//   loop over 64-key K/V tiles staged in shared memory as fp32 (odd row
//   stride, free of bank conflicts); 256 threads in a 16 x 16 grid, each
//   owning a 4 x 4 block of the score tile and a 4 x (head_dim / 16) block
//   of the output. A row's 16 owners form a half-warp, so the row max and
//   sum reduce with shuffles; the keep mask goes through a byte tile in
//   shared memory. Both products run on the CUDA cores in fp32 fed from
//   shared memory: bound by shared-memory bandwidth and the fp32 pipes.

#include "flash_attention_common.cuh"
#include "flash_infer_wgmma.cuh"

namespace {

using namespace flash;

template <typename T, int kChunks, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const float* __restrict__ key_bias,
                 const int* __restrict__ seg, int seq, int heads,
                 int head_dim, float scale, uint2 seed, uint32_t threshold,
                 float keep_scale) {
  extern __shared__ float smem[];
  const int ld = head_dim + 1;
  float* qs = smem;                        // [kTile][ld]
  float* ks = qs + kTile * ld;             // [kTile][ld]
  float* vs = ks + kTile * ld;             // [kTile][ld]
  float* ps = vs + kTile * ld;             // [kTile][kPStride]
  float* kb = ps + kTile * kPStride;       // [kTile]
  int* kseg = reinterpret_cast<int*>(kb + kTile);  // [kTile]
  int* qseg = kseg + kTile;                         // [kTile]
  uint8_t* keep = reinterpret_cast<uint8_t*>(qseg + kTile);  // [kTile^2]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kTile;
  const long long row_stride = static_cast<long long>(heads) * head_dim;
  const long long base = static_cast<long long>(b) * seq * row_stride +
                         static_cast<long long>(h) * head_dim;
  const long long tok0 = static_cast<long long>(b) * seq;
  const bool segmented = seg != nullptr;

  for (int e = tid; e < kTile * head_dim; e += kThreads) {
    const int r = e / head_dim;
    const int d = e - r * head_dim;
    const int s = q0 + r;
    qs[r * ld + d] = s < seq ? to_float(q[base + s * row_stride + d]) : 0.f;
  }
  if (segmented && tid < kTile) {
    const int s = q0 + tid;
    qseg[tid] = s < seq ? seg[tok0 + s] : 0;
  }

  float m[kPer], l[kPer], acc[kPer][kChunks];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[i][c] = 0.f;
  }

  const int num_kb = (seq + kTile - 1) / kTile;
  for (int j = 0; j < num_kb; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kTile * head_dim; e += kThreads) {
      const int r = e / head_dim;
      const int d = e - r * head_dim;
      const int s = k0 + r;
      const bool inside = s < seq;
      const long long off = base + s * row_stride + d;
      ks[r * ld + d] = inside ? to_float(k[off]) : 0.f;
      vs[r * ld + d] = inside ? to_float(v[off]) : 0.f;
    }
    if (tid < kTile) {
      const int s = k0 + tid;
      kb[tid] = (key_bias != nullptr && s < seq) ? key_bias[tok0 + s] : 0.f;
      if (segmented) kseg[tid] = s < seq ? seg[tok0 + s] : 0;
    }
    if (kDropout) fill_keep_tile<false>(keep, seed, threshold, bh, q0, k0);
    __syncthreads();

    // Score block: rows ty + 16 i, keys tx + 16 c.
    float sc[kPer][kPer];
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

    // Online softmax over this key tile, one half-warp per row group.
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
      float tile_max = kNegInf;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int kk = tx + 16 * c;
        float s = sc[i][c] * scale + kb[kk];
        if (segmented) s += seg_mask(qseg[r], kseg[kk]);
        sc[i][c] = s;
        if (k0 + kk < seq) tile_max = fmaxf(tile_max, s);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int kk = tx + 16 * c;
        float p = (k0 + kk < seq) ? expf(sc[i][c] - m_new) : 0.f;
        row_sum += p;  // l sums the undropped probabilities
        if (kDropout && !keep[r * kTile + kk]) p = 0.f;
        ps[r * kPStride + kk] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // P rows are written and read by the same half-warp

    const int keys = min(kTile, seq - k0);
    for (int kk = 0; kk < keys; ++kk) {
      float pv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) pv[i] = ps[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < head_dim ? vs[kk * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= seq) continue;
    const float denom = l[i] * keep_scale;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = tx + 16 * c;
      if (d < head_dim)
        out[base + s * row_stride + d] = from_float<T>(acc[i][c] / denom);
    }
    if (tx == 0) lse[static_cast<long long>(bh) * seq + s] = m[i] + logf(l[i]);
  }
}

template <typename T, int kChunks, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const float* key_bias, const int* seg,
                   int batch, int seq, int heads, int head_dim, float scale,
                   uint2 seed, uint32_t threshold, float keep_scale,
                   cudaStream_t stream) {
  const int ld = head_dim + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(3 * kTile) * ld +
                       kTile * kPStride + kTile) +
      sizeof(int) * (2 * kTile) + kTile * kTile;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kChunks, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  flash_fwd_kernel<T, kChunks, kDropout><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, key_bias, seg,
      seq, heads, head_dim, scale, seed, threshold, keep_scale);
  return cudaGetLastError();
}

template <typename T, int kChunks>
cudaError_t dispatch_dropout(bool dropout, const void* q, const void* k,
                             const void* v, void* out, float* lse,
                             const float* key_bias, const int* seg, int batch,
                             int seq, int heads, int head_dim, float scale,
                             uint2 seed, uint32_t threshold, float keep_scale,
                             cudaStream_t stream) {
  if (dropout)
    return launch<T, kChunks, true>(q, k, v, out, lse, key_bias, seg, batch,
                                    seq, heads, head_dim, scale, seed,
                                    threshold, keep_scale, stream);
  return launch<T, kChunks, false>(q, k, v, out, lse, key_bias, seg, batch,
                                   seq, heads, head_dim, scale, seed,
                                   threshold, keep_scale, stream);
}

template <typename T>
cudaError_t dispatch(bool dropout, const void* q, const void* k,
                     const void* v, void* out, float* lse,
                     const float* key_bias, const int* seg, int batch,
                     int seq, int heads, int head_dim, float scale,
                     uint2 seed, uint32_t threshold, float keep_scale,
                     cudaStream_t stream) {
  if (head_dim <= 64)
    return dispatch_dropout<T, 4>(dropout, q, k, v, out, lse, key_bias, seg,
                                  batch, seq, heads, head_dim, scale, seed,
                                  threshold, keep_scale, stream);
  return dispatch_dropout<T, 8>(dropout, q, k, v, out, lse, key_bias, seg,
                                batch, seq, heads, head_dim, scale, seed,
                                threshold, keep_scale, stream);
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(flash::wg::kThreads)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse,
                       const float* __restrict__ key_bias,
                       const int* __restrict__ seg, int seq, int heads,
                       float scale, uint2 seed, uint32_t threshold,
                       float keep_scale) {
  extern __shared__ float smem[];  // the same symbol as the CUDA-core kernel's
  wg::Bf16Scores<D> scores{&qmap, &kmap};
  wg::forward_stream<D, kDropout>(scores, scale, &vmap, out, key_bias, seg,
                                  seq, heads,
                                  reinterpret_cast<uint8_t*>(smem),
                                  wg::Train{lse, seed, threshold, keep_scale});
}

template <int D, bool kDropout>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, const float* key_bias,
                         const int* seg, int batch, int seq, int heads,
                         float scale, uint2 seed, uint32_t threshold,
                         float keep_scale, cudaStream_t stream) {
  constexpr int kChunk = wg::Tile<2 * D>::kChunk;
  CUtensorMap maps[3];
  const void* srcs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err =
        wg::bshd_map(&maps[i], srcs[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     kChunk, batch, seq, heads, D);
    if (err != cudaSuccess) return err;
  }
  constexpr size_t smem = wg::smem_bytes<wg::Bf16Scores<D>, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + wg::kRows - 1) / wg::kRows);
  flash_fwd_wgmma_kernel<D, kDropout>
      <<<grid, wg::kThreads, smem, stream>>>(
          maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), lse,
          key_bias, seg, seq, heads, scale, seed, threshold, keep_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_wgmma(bool dropout, const void* q, const void* k,
                           const void* v, void* out, float* lse,
                           const float* key_bias, const int* seg, int batch,
                           int seq, int heads, float scale, uint2 seed,
                           uint32_t threshold, float keep_scale,
                           cudaStream_t stream) {
  if (dropout)
    return launch_wgmma<D, true>(q, k, v, out, lse, key_bias, seg, batch, seq,
                                 heads, scale, seed, threshold, keep_scale,
                                 stream);
  return launch_wgmma<D, false>(q, k, v, out, lse, key_bias, seg, batch, seq,
                                heads, scale, seed, threshold, keep_scale,
                                stream);
}

}  // namespace

extern "C" {

// The CUDA-core route. dtype: 0 = float32, 1 = bfloat16. key_bias ([B, S]
// fp32) and seg ([B, S] int32) may each be null. dropout != 0 draws the
// keep mask from (seed_lo, seed_hi) with keep iff bits >= threshold;
// keep_scale = 1 - rate. Returns the launch's cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, float* lse, const float* key_bias,
                        const int* seg, int batch, int seq, int heads,
                        int head_dim, int dtype, float scale, int dropout,
                        uint32_t seed_lo, uint32_t seed_hi,
                        uint32_t threshold, float keep_scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 ||
      head_dim > 128 || head_dim % 8 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(dropout != 0, q, k, v, out, lse, key_bias, seg,
                            batch, seq, heads, head_dim, scale, seed,
                            threshold, keep_scale, s)
          : dispatch<__nv_bfloat16>(dropout != 0, q, k, v, out, lse,
                                    key_bias, seg, batch, seq, heads,
                                    head_dim, scale, seed, threshold,
                                    keep_scale, s);
  return static_cast<int>(err);
}

// The tensor-core route: q, k, v, out [B, S, H, D] bfloat16, 16-byte
// aligned, head_dim 32, 64 or 128; the other arguments as above. Returns
// the launch's cudaError_t (cudaErrorSymbolNotFound if the driver has no
// cuTensorMapEncodeTiled).
int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                              void* out, float* lse, const float* key_bias,
                              const int* seg, int batch, int seq, int heads,
                              int head_dim, float scale, int dropout,
                              uint32_t seed_lo, uint32_t seed_hi,
                              uint32_t threshold, float keep_scale,
                              void* stream) {
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || seq <= 0 || heads <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  const bool drop = dropout != 0;
  cudaError_t err;
  switch (head_dim) {
    case 32:
      err = dispatch_wgmma<32>(drop, q, k, v, out, lse, key_bias, seg, batch,
                               seq, heads, scale, seed, threshold,
                               keep_scale, s);
      break;
    case 64:
      err = dispatch_wgmma<64>(drop, q, k, v, out, lse, key_bias, seg, batch,
                               seq, heads, scale, seed, threshold,
                               keep_scale, s);
      break;
    case 128:
      err = dispatch_wgmma<128>(drop, q, k, v, out, lse, key_bias, seg,
                                batch, seq, heads, scale, seed, threshold,
                                keep_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
