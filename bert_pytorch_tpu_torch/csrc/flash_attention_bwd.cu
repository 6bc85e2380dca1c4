// Training flash-attention backward, written by hand for Hopper: two
// kernels, one per TPU kernel they replace
// (bert_pytorch_tpu/ops/pallas/attention.py, called through `_flash_bwd`):
//
//   flash_dq_kernel  <- `_flash_dq_kernel`:  per 64-row q tile, loop over
//                       key tiles;
//                       delta = rowsum(dO * O)  (computed by XLA outside
//                       the TPU kernels; folded in here and written out
//                       for the dkv kernel),
//                       p  = exp(s - lse)   (the forward's probabilities,
//                                            recomputed from lse),
//                       dA = dO v^T, dropped and scaled by 1/(1-r) where
//                            the keep mask drops,
//                       dS = p * (dA - delta),
//                       dQ = (dS rounded to k's dtype) k * scale;
//   flash_dkv_kernel <- `_flash_dkv_kernel`: per 64-key tile, loop over q
//                       tiles;
//                       dV    = (keep * p / (1-r) rounded to dO's dtype)^T dO,
//                       dK    = (dS rounded to q's dtype)^T q * scale,
//                       dbias = sum over q of dS (fp32).
//
// s is rebuilt exactly as the forward builds it (fp32 scores scaled after
// the product, the additive key bias, the packed -10000 mask) and the keep
// mask is regenerated from the element coordinates by the Philox of
// flash_attention_common.cuh, so the backward differentiates the forward
// that ran, with any tiling.
//
// Design: as the forward. One block of 256 threads (16 x 16) per
// (batch*head, 64-row tile); the tiles the inner loop walks are staged in
// shared memory as fp32 with an odd row stride; each thread owns a 4 x 4
// block of the [64 x 64] score tile and a 4 x (head_dim / 16) block of its
// output. The dq kernel's thread rows are query rows; the dkv kernel's are
// key rows, so its dS^T and P^T tiles are written and read back by the same
// half-warp and the dbias sum reduces with shuffles. No atomics: each
// output tile is owned by one block. q, k, v, dO, dq, dk, dv keep the
// model's [B, S, H, D] layout; lse, delta and dbias are [B*H, S] fp32; the
// key bias and sequence ids are read from [B, S].
//
// What bounds it on the H100: four products per tile pair (two for the
// scores and dA, two for the outputs) run on the CUDA cores in fp32 fed
// from shared memory, far from the tensor-core rate that bounds the work.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long base,
                                          long long row_stride, int row0,
                                          int seq, int head_dim, int ld) {
  for (int e = threadIdx.x; e < kTile * head_dim; e += kThreads) {
    const int r = e / head_dim;
    const int d = e - r * head_dim;
    const int s = row0 + r;
    dst[r * ld + d] = s < seq ? to_float(src[base + s * row_stride + d]) : 0.f;
  }
}

template <typename T, int kChunks, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ out,
                const T* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, T* __restrict__ dq,
                const float* __restrict__ key_bias,
                const int* __restrict__ seg, int seq, int heads, int head_dim,
                float scale, uint2 seed, uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  const int ld = head_dim + 1;
  float* qs = smem;                        // [kTile][ld]
  float* dos = qs + kTile * ld;            // [kTile][ld]
  float* ks = dos + kTile * ld;            // [kTile][ld]
  float* vs = ks + kTile * ld;             // [kTile][ld]
  float* dss = vs + kTile * ld;            // [kTile][kPStride]
  float* kb = dss + kTile * kPStride;      // [kTile]
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
  const long long stat0 = static_cast<long long>(bh) * seq;
  const bool segmented = seg != nullptr;

  load_tile(qs, q, base, row_stride, q0, seq, head_dim, ld);
  load_tile(dos, dout, base, row_stride, q0, seq, head_dim, ld);
  if (segmented && tid < kTile) {
    const int s = q0 + tid;
    qseg[tid] = s < seq ? seg[tok0 + s] : 0;
  }

  // delta = rowsum(dO * O) in fp32, and the rows' lse.
  float row_lse[kPer], row_delta[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = q0 + ty + 16 * i;
    float part = 0.f;
    if (s < seq) {
      for (int d = tx; d < head_dim; d += 16) {
        const long long off = base + s * row_stride + d;
        part = fmaf(to_float(dout[off]), to_float(out[off]), part);
      }
    }
    row_delta[i] = half_warp_sum(part);
    row_lse[i] = s < seq ? lse[stat0 + s] : 0.f;
    if (tx == 0 && s < seq) delta[stat0 + s] = row_delta[i];
  }

  float acc[kPer][kChunks];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[i][c] = 0.f;

  const int num_kb = (seq + kTile - 1) / kTile;
  for (int j = 0; j < num_kb; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile(ks, k, base, row_stride, k0, seq, head_dim, ld);
    load_tile(vs, v, base, row_stride, k0, seq, head_dim, ld);
    if (tid < kTile) {
      const int s = k0 + tid;
      kb[tid] = (key_bias != nullptr && s < seq) ? key_bias[tok0 + s] : 0.f;
      if (segmented) kseg[tid] = s < seq ? seg[tok0 + s] : 0;
    }
    if (kDropout) fill_keep_tile<false>(keep, seed, threshold, bh, q0, k0);
    __syncthreads();

    // Scores and dA = dO v^T: rows ty + 16 i, keys tx + 16 c.
    float sc[kPer][kPer], da[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kPer; ++c) sc[i][c] = da[i][c] = 0.f;
    for (int d = 0; d < head_dim; ++d) {
      float qv[kPer], dov[kPer], kv[kPer], vv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qv[i] = qs[(ty + 16 * i) * ld + d];
        dov[i] = dos[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        kv[c] = ks[(tx + 16 * c) * ld + d];
        vv[c] = vs[(tx + 16 * c) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
          da[i][c] = fmaf(dov[i], vv[c], da[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
      const bool row_ok = q0 + r < seq;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int kk = tx + 16 * c;
        float s = sc[i][c] * scale + kb[kk];
        if (segmented) s += seg_mask(qseg[r], kseg[kk]);
        const float p =
            (row_ok && k0 + kk < seq) ? expf(s - row_lse[i]) : 0.f;
        float a = da[i][c];
        if (kDropout) a = keep[r * kTile + kk] ? a * inv_keep : 0.f;
        dss[r * kPStride + kk] = round_to<T>(p * (a - row_delta[i]));
      }
    }
    __syncwarp();  // dS rows are written and read by the same half-warp

    const int keys = min(kTile, seq - k0);
    for (int kk = 0; kk < keys; ++kk) {
      float dsv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dsv[i] = dss[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = tx + 16 * c;
        const float kv = d < head_dim ? ks[kk * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= seq) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = tx + 16 * c;
      if (d < head_dim)
        dq[base + s * row_stride + d] = from_float<T>(acc[i][c] * scale);
    }
  }
}

template <typename T, int kChunks, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, float* __restrict__ dbias,
                 const float* __restrict__ key_bias,
                 const int* __restrict__ seg, int seq, int heads,
                 int head_dim, float scale, uint2 seed, uint32_t threshold,
                 float inv_keep) {
  extern __shared__ float smem[];
  const int ld = head_dim + 1;
  float* ks = smem;                        // [kTile][ld], this block's keys
  float* vs = ks + kTile * ld;             // [kTile][ld]
  float* qs = vs + kTile * ld;             // [kTile][ld], the q tile walked
  float* dos = qs + kTile * ld;            // [kTile][ld]
  float* pts = dos + kTile * ld;           // [kTile keys][kPStride]: P^T
  float* dsts = pts + kTile * kPStride;    // [kTile keys][kPStride]: dS^T
  float* lse_s = dsts + kTile * kPStride;  // [kTile]
  float* delta_s = lse_s + kTile;          // [kTile]
  int* qseg = reinterpret_cast<int*>(delta_s + kTile);  // [kTile]
  uint8_t* keep = reinterpret_cast<uint8_t*>(qseg + kTile);  // [kTile^2]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.y * kTile;
  const long long row_stride = static_cast<long long>(heads) * head_dim;
  const long long base = static_cast<long long>(b) * seq * row_stride +
                         static_cast<long long>(h) * head_dim;
  const long long tok0 = static_cast<long long>(b) * seq;
  const long long stat0 = static_cast<long long>(bh) * seq;
  const bool segmented = seg != nullptr;

  load_tile(ks, k, base, row_stride, k0, seq, head_dim, ld);
  load_tile(vs, v, base, row_stride, k0, seq, head_dim, ld);
  // This thread's key rows: k0 + ty + 16 i.
  float row_bias[kPer];
  int row_seg[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = k0 + ty + 16 * i;
    row_bias[i] = (key_bias != nullptr && s < seq) ? key_bias[tok0 + s] : 0.f;
    row_seg[i] = (segmented && s < seq) ? seg[tok0 + s] : 0;
  }

  float dk_acc[kPer][kChunks], dv_acc[kPer][kChunks], db[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  const int num_qb = (seq + kTile - 1) / kTile;
  for (int t = 0; t < num_qb; ++t) {
    const int q0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile(qs, q, base, row_stride, q0, seq, head_dim, ld);
    load_tile(dos, dout, base, row_stride, q0, seq, head_dim, ld);
    if (tid < kTile) {
      const int s = q0 + tid;
      lse_s[tid] = s < seq ? lse[stat0 + s] : 0.f;
      delta_s[tid] = s < seq ? delta[stat0 + s] : 0.f;
      if (segmented) qseg[tid] = s < seq ? seg[tok0 + s] : 0;
    }
    if (kDropout) fill_keep_tile<true>(keep, seed, threshold, bh, q0, k0);
    __syncthreads();

    // Transposed tiles: key rows ty + 16 i, query columns tx + 16 c.
    float sc[kPer][kPer], da[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kPer; ++c) sc[i][c] = da[i][c] = 0.f;
    for (int d = 0; d < head_dim; ++d) {
      float kv[kPer], vv[kPer], qv[kPer], dov[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        kv[i] = ks[(ty + 16 * i) * ld + d];
        vv[i] = vs[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        qv[c] = qs[(tx + 16 * c) * ld + d];
        dov[c] = dos[(tx + 16 * c) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          sc[i][c] = fmaf(kv[i], qv[c], sc[i][c]);
          da[i][c] = fmaf(vv[i], dov[c], da[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kr = ty + 16 * i;
      const bool key_ok = k0 + kr < seq;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int qc = tx + 16 * c;
        float s = sc[i][c] * scale + row_bias[i];
        if (segmented) s += seg_mask(qseg[qc], row_seg[i]);
        const float p =
            (key_ok && q0 + qc < seq) ? expf(s - lse_s[qc]) : 0.f;
        float a = da[i][c];
        float pv = p;
        if (kDropout) {
          const bool kept = keep[kr * kTile + qc];
          pv = kept ? p * inv_keep : 0.f;
          a = kept ? a * inv_keep : 0.f;
        }
        const float ds = p * (a - delta_s[qc]);
        pts[kr * kPStride + qc] = round_to<T>(pv);
        dsts[kr * kPStride + qc] = round_to<T>(ds);
        db[i] += ds;
      }
    }
    __syncwarp();  // P^T / dS^T rows are written and read by one half-warp

    const int rows = min(kTile, seq - q0);
    for (int qq = 0; qq < rows; ++qq) {
      float pv[kPer], dsv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pv[i] = pts[(ty + 16 * i) * kPStride + qq];
        dsv[i] = dsts[(ty + 16 * i) * kPStride + qq];
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = tx + 16 * c;
        const float dov = d < head_dim ? dos[qq * ld + d] : 0.f;
        const float qv = d < head_dim ? qs[qq * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float db_row = half_warp_sum(db[i]);
    const int s = k0 + ty + 16 * i;
    if (s >= seq) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = tx + 16 * c;
      if (d < head_dim) {
        const long long off = base + s * row_stride + d;
        dk[off] = from_float<T>(dk_acc[i][c] * scale);
        dv[off] = from_float<T>(dv_acc[i][c]);
      }
    }
    if (tx == 0) dbias[stat0 + s] = db_row;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int kChunks, bool kDropout>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* out, const void* dout, const float* lse,
                      float* delta, void* dq, const float* key_bias,
                      const int* seg, int batch, int seq, int heads,
                      int head_dim, float scale, uint2 seed,
                      uint32_t threshold, float inv_keep,
                      cudaStream_t stream) {
  const int ld = head_dim + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(4 * kTile) * ld +
                       kTile * kPStride + kTile) +
      sizeof(int) * (2 * kTile) + kTile * kTile;
  cudaError_t err = prepare(flash_dq_kernel<T, kChunks, kDropout>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  flash_dq_kernel<T, kChunks, kDropout><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), key_bias,
      seg, seq, heads, head_dim, scale, seed, threshold, inv_keep);
  return cudaGetLastError();
}

template <typename T, int kChunks, bool kDropout>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, float* dbias,
                       const float* key_bias, const int* seg, int batch,
                       int seq, int heads, int head_dim, float scale,
                       uint2 seed, uint32_t threshold, float inv_keep,
                       cudaStream_t stream) {
  const int ld = head_dim + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(4 * kTile) * ld +
                       2 * kTile * kPStride + 2 * kTile) +
      sizeof(int) * kTile + kTile * kTile;
  cudaError_t err = prepare(flash_dkv_kernel<T, kChunks, kDropout>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  flash_dkv_kernel<T, kChunks, kDropout><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), dbias, key_bias, seg, seq,
      heads, head_dim, scale, seed, threshold, inv_keep);
  return cudaGetLastError();
}

// One (dtype, head-dim chunks, dropout) instance of each kernel.
template <typename T, int kChunks, bool kDropout>
struct Bwd {
  static cudaError_t dq(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const float* lse,
                        float* delta, void* dq_, const float* key_bias,
                        const int* seg, int batch, int seq, int heads,
                        int head_dim, float scale, uint2 seed,
                        uint32_t threshold, float inv_keep,
                        cudaStream_t stream) {
    return launch_dq<T, kChunks, kDropout>(
        q, k, v, out, dout, lse, delta, dq_, key_bias, seg, batch, seq,
        heads, head_dim, scale, seed, threshold, inv_keep, stream);
  }
  static cudaError_t dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv,
                         float* dbias, const float* key_bias, const int* seg,
                         int batch, int seq, int heads, int head_dim,
                         float scale, uint2 seed, uint32_t threshold,
                         float inv_keep, cudaStream_t stream) {
    return launch_dkv<T, kChunks, kDropout>(
        q, k, v, dout, lse, delta, dk, dv, dbias, key_bias, seg, batch, seq,
        heads, head_dim, scale, seed, threshold, inv_keep, stream);
  }
};

// Calls F<T, chunks, dropout>::method(args...) for the runtime choices.
#define FLASH_BWD_DISPATCH(method, ...)                                     \
  do {                                                                      \
    const bool wide = head_dim > 64;                                        \
    if (dtype == 0) {                                                       \
      if (wide)                                                             \
        return dropout ? Bwd<float, 8, true>::method(__VA_ARGS__)           \
                       : Bwd<float, 8, false>::method(__VA_ARGS__);         \
      return dropout ? Bwd<float, 4, true>::method(__VA_ARGS__)             \
                     : Bwd<float, 4, false>::method(__VA_ARGS__);           \
    }                                                                       \
    if (wide)                                                               \
      return dropout ? Bwd<__nv_bfloat16, 8, true>::method(__VA_ARGS__)     \
                     : Bwd<__nv_bfloat16, 8, false>::method(__VA_ARGS__);   \
    return dropout ? Bwd<__nv_bfloat16, 4, true>::method(__VA_ARGS__)       \
                   : Bwd<__nv_bfloat16, 4, false>::method(__VA_ARGS__);     \
  } while (0)

bool bad_shape(int batch, int seq, int heads, int head_dim, int dtype) {
  return batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 ||
         head_dim > 128 || head_dim % 8 != 0 || (dtype != 0 && dtype != 1);
}

cudaError_t dq_entry(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* delta, void* dq, const float* key_bias,
                     const int* seg, int batch, int seq, int heads,
                     int head_dim, int dtype, float scale, bool dropout,
                     uint2 seed, uint32_t threshold, float inv_keep,
                     cudaStream_t stream) {
  FLASH_BWD_DISPATCH(dq, q, k, v, out, dout, lse, delta, dq, key_bias, seg,
                     batch, seq, heads, head_dim, scale, seed, threshold,
                     inv_keep, stream);
  return cudaErrorInvalidValue;  // not reached
}

cudaError_t dkv_entry(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, float* dbias,
                      const float* key_bias, const int* seg, int batch,
                      int seq, int heads, int head_dim, int dtype,
                      float scale, bool dropout, uint2 seed,
                      uint32_t threshold, float inv_keep,
                      cudaStream_t stream) {
  FLASH_BWD_DISPATCH(dkv, q, k, v, dout, lse, delta, dk, dv, dbias,
                     key_bias, seg, batch, seq, heads, head_dim, scale, seed,
                     threshold, inv_keep, stream);
  return cudaErrorInvalidValue;  // not reached
}

}  // namespace

extern "C" {

// dq and delta = rowsum(dO * O) from the forward's out and lse. dtype:
// 0 = float32, 1 = bfloat16; key_bias ([B, S] fp32) and seg ([B, S] int32)
// may each be null; lse and delta are [B*H, S] fp32. dropout != 0
// regenerates the forward's keep mask from (seed_lo, seed_hi, threshold);
// inv_keep = 1 / (1 - rate). Returns the launch's cudaError_t.
int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* delta, void* dq, const float* key_bias,
                       const int* seg, int batch, int seq, int heads,
                       int head_dim, int dtype, float scale, int dropout,
                       uint32_t seed_lo, uint32_t seed_hi,
                       uint32_t threshold, float inv_keep, void* stream) {
  if (bad_shape(batch, seq, heads, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dq_entry(
      q, k, v, out, dout, lse, delta, dq, key_bias, seg, batch, seq, heads,
      head_dim, dtype, scale, dropout != 0, make_uint2(seed_lo, seed_hi),
      threshold, inv_keep, static_cast<cudaStream_t>(stream)));
}

// dk, dv and dbias ([B*H, S] fp32, the sum over queries of dS) from lse and
// the delta the dq kernel wrote; the other arguments as for dq.
int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, float* dbias,
                        const float* key_bias, const int* seg, int batch,
                        int seq, int heads, int head_dim, int dtype,
                        float scale, int dropout, uint32_t seed_lo,
                        uint32_t seed_hi, uint32_t threshold, float inv_keep,
                        void* stream) {
  if (bad_shape(batch, seq, heads, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dkv_entry(
      q, k, v, dout, lse, delta, dk, dv, dbias, key_bias, seg, batch, seq,
      heads, head_dim, dtype, scale, dropout != 0,
      make_uint2(seed_lo, seed_hi), threshold, inv_keep,
      static_cast<cudaStream_t>(stream)));
}

const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
