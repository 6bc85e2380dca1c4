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
//   dkv kernels      <- `_flash_dkv_kernel`: per 64-key tile, loop over q
//                       tiles;
//                       dV    = (keep * p / (1-r) rounded to dO's dtype)^T dO,
//                       dK    = (dS rounded to q's dtype)^T q * scale,
//                       dbias = sum over q of dS (fp32).
//
// s is rebuilt exactly as the forward builds it (fp32 scores scaled after
// the product, the additive key bias, the packed -10000 mask) and the keep
// mask is regenerated from the element coordinates by the Philox of
// flash_attention_common.cuh, so the backward differentiates the forward
// that ran, with any tiling. No atomics: each output tile is owned by one
// block. q, k, v, dO, dq, dk, dv keep the model's [B, S, H, D] layout;
// lse, delta and dbias are [B*H, S] fp32; the key bias and sequence ids
// are read from [B, S].
//
// Each kernel has two routes, chosen by the wrapper from dtype and head_dim
// before launch (ops/kernels/attention.py `train_route`):
//
// * Tensor cores, dq (`flash_dq_wgmma_kernel`, bf16 or fp16 with head_dim
//   32, 64 or 128). One warpgroup per (batch*head, 64-row q tile). delta is
//   summed first, from O and dO in global memory (each lane of a quad a
//   quarter of its two rows, 16-byte loads, then a quad sum), while TMA
//   brings the q and dO tiles once and each 64-key K and V tile through a
//   2-stage ring (wgmma_common.cuh). Per key tile, three `wgmma` products
//   in the forward's shapes: S = Q K^T and dA = dO V^T from shared memory,
//   both operands K-major (m64n64k16), then dQ += dS K with dS from
//   registers (the S accumulator's fragments are, pair by pair, the A
//   fragments of a k16 step) and K as the MN-major B operand: one swizzled
//   K tile read through two descriptors. The rows are q rows, so lse and
//   delta are two per-thread constants read before the key loop; the key
//   bias and ids of the thread's 16 keys and the keep mask (`keep_bits`,
//   the forward's layout) are read and drawn while the score wgmmas run.
//   dQ stays in registers (head_dim / 2 fp32 a thread). What bounds it:
//   the CUDA cores (the elementwise dS and, with dropout, the Philox
//   rounds), not the tensor cores.
// * Tensor cores, dkv (`flash_dkv_wgmma_kernel`, bf16 or fp16 with head_dim
//   32 or 64: BERT-base and BERT-large). One warpgroup per (batch*head, 64-key
//   tile). TMA brings the K and V tiles once and each 64-row q and dO tile
//   through the 2-stage ring. Per q tile, four `wgmma` products, all in
//   the two shapes of the forward: S^T = K q^T and dA^T = V dO^T from
//   shared memory, both operands K-major (m64n64k16); then dV += P_drop^T
//   dO and dK += dS^T q with P_drop^T and dS^T from registers and dO and q
//   as the MN-major B operand, the same tiles read with the transpose bit.
//   The rows of the fragments are keys, so dbias sums over the quad at the
//   end and across q tiles in registers. lse, delta and the q ids are read
//   per tile by each thread for its own 16 q columns while the score
//   wgmmas run, and so is the keep mask (`keep_bits_t`): one Philox call
//   gives four neighbouring keys of one q row, which are rows of four
//   lanes, so each of the four draws a quarter of the calls they share and
//   they swap bytes by shuffles: no word is drawn twice. dK and dV stay in
//   registers (head_dim fp32 a thread), which is why head_dim 128 keeps
//   the CUDA-core route. What bounds it: the CUDA cores, as for dq.
//   Both tensor-core kernels are templates on the 16-bit element type:
//   the wgmma input type, the TMA maps' data type and the roundings of
//   dS, P and the outputs follow it, to nearest and not saturating, so an
//   fp16 dS or dV past 65504 is inf, as the Pallas kernels' astype makes
//   it.
// * CUDA cores (`flash_dq_kernel`, `flash_dkv_kernel`: fp32 and any other
//   head_dim): one block of 256 threads (16 x 16) per (batch*head, 64-row
//   tile); the tiles the inner loop walks are staged in shared memory as
//   fp32 with an odd row stride; each thread owns a 4 x 4 block of the
//   [64 x 64] score tile and a 4 x (head_dim / 16) block of its output.
//   The dq kernel's thread rows are query rows; the dkv kernel's are key
//   rows, so its dS^T and P^T tiles are written and read back by the same
//   half-warp and the dbias sum reduces with shuffles. The products (two
//   for the scores and dA, and one or two for the outputs) run on the CUDA
//   cores in fp32 fed from shared memory, far from the tensor-core rate
//   that bounds the work.

#include "flash_attention_common.cuh"
#include "wgmma_common.cuh"
#include "wgmma_dropout.cuh"

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
    if (dtype == 1) {                                                       \
      if (wide)                                                             \
        return dropout ? Bwd<__nv_bfloat16, 8, true>::method(__VA_ARGS__)   \
                       : Bwd<__nv_bfloat16, 8, false>::method(__VA_ARGS__); \
      return dropout ? Bwd<__nv_bfloat16, 4, true>::method(__VA_ARGS__)     \
                     : Bwd<__nv_bfloat16, 4, false>::method(__VA_ARGS__);   \
    }                                                                       \
    if (wide)                                                               \
      return dropout ? Bwd<__half, 8, true>::method(__VA_ARGS__)            \
                     : Bwd<__half, 8, false>::method(__VA_ARGS__);          \
    return dropout ? Bwd<__half, 4, true>::method(__VA_ARGS__)              \
                   : Bwd<__half, 4, false>::method(__VA_ARGS__);            \
  } while (0)

bool bad_shape(int batch, int seq, int heads, int head_dim, int dtype) {
  return batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 ||
         head_dim > 128 || head_dim % 8 != 0 || dtype < 0 || dtype > 2;
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

// -- the tensor-core routes --------------------------------------------------

// Dynamic shared memory of either tensor-core kernel: the two tiles it
// keeps (K and V in dkv, q and dO in dq), two stages of each of the two it
// walks, three mbarriers, and 1024 bytes to align the base for the
// 128-byte swizzle.
template <int D>
constexpr size_t bwd_smem_bytes() {
  return 1024 + (2 + 2 * wg::kStages) * wg::Tile<2 * D>::kBytes +
         (wg::kStages + 1) * sizeof(uint64_t);
}

// The TMA maps of q, k, v and dO ([B, S, H, D] in E), in that order.
template <typename E, int D>
cudaError_t qkvdo_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
                       const void* v, const void* dout, int batch, int seq,
                       int heads) {
  const void* srcs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = wg::bshd_map(
        &maps[i], srcs[i], wg::tma_type<E>(), 2, wg::Tile<2 * D>::kChunk,
        batch, seq, heads, D);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// -- the dkv kernel's tensor-core route --------------------------------------

// P_drop^T and dS^T of one tile pair on this thread's 32 elements of S^T
// and dA^T (raw products; layout as in wg::keep_bits_t), given the bias and
// ids of its two keys and lse, delta and ids of its 16 q columns: leaves
// both in E pairs (the A fragments of four k16 steps) and adds dS to
// the keys' dbias sums. kFull: every q row of the tile lies before S
// (else rows past S get probability 0 by index).
template <typename E, bool kFull, bool kDropout>
__device__ __forceinline__ void grad_tile(
    const float (&s)[32], const float (&da)[32], const float (&kb)[2],
    const int (&kid)[2], const float (&lse)[16], const float (&delta)[16],
    const int (&qid)[16], bool segmented, float scale, float inv_keep,
    uint32_t keep, int q0, int col0, int seq, float (&db)[2],
    uint32_t (&pt)[16], uint32_t (&dst)[16]) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = (e >> 1) & 1;
    float pv[2], ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = 2 * (e >> 2) + u;  // this thread's q column
      float x = __fadd_rn(__fmul_rn(s[e + u], scale), kb[r]);  // no FMA
      if (segmented) x += seg_mask(qid[c], kid[r]);
      float p = wg::exp_approx(x - lse[c]);
      if (!kFull && q0 + 8 * (e >> 2) + col0 + u >= seq) p = 0.f;
      float a = da[e + u];
      pv[u] = p;
      if (kDropout) {
        const bool kept = (keep >> (e + u)) & 1u;
        pv[u] = kept ? p * inv_keep : 0.f;
        a = kept ? a * inv_keep : 0.f;
      }
      ds[u] = p * (a - delta[c]);
      db[r] += ds[u];
    }
    pt[e >> 1] = wg::pack2<E>(pv[0], pv[1]);
    dst[e >> 1] = wg::pack2<E>(ds[0], ds[1]);
  }
}


// Launch: grid (batch * heads, ceil(seq / 64)), wg::kThreads threads,
// bwd_smem_bytes<D>() of dynamic shared memory.
template <typename E, int D, bool kDropout>
__global__ void __launch_bounds__(wg::kThreads)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       E* __restrict__ dk, E* __restrict__ dv,
                       float* __restrict__ dbias,
                       const float* __restrict__ key_bias,
                       const int* __restrict__ seg, int seq, int heads,
                       float scale, uint2 seed, uint32_t threshold,
                       float inv_keep) {
  using T = wg::Tile<2 * D>;
  constexpr int kRows = wg::kRows;
  constexpr int kStages = wg::kStages;
  constexpr int kAcc = D / 2;  // fp32 values of dK (and of dV) per thread
  extern __shared__ float smem[];  // the same symbol as the CUDA-core kernels'
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.y * kRows;
  const long long tok0 = static_cast<long long>(b) * seq;
  const long long stat0 = static_cast<long long>(bh) * seq;
  const int num_qb = (seq + kRows - 1) / kRows;

  const uint32_t raw = wg::smem_u32(smem);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + T::kBytes;
  const uint32_t q_s = v_s + T::kBytes;                   // kStages q tiles
  const uint32_t do_s = q_s + kStages * T::kBytes;        // kStages dO tiles
  const uint32_t bars = do_s + kStages * T::kBytes;       // full[0], full[1]
  const uint32_t kv_bar = bars + 8 * kStages;

  auto load_stage = [&](int t) {
    const int st = t % kStages;
    const uint32_t bar = bars + 8 * st;
    wg::mbar_expect_tx(bar, 2 * T::kBytes);
    wg::load_tile<2 * D, 2>(q_s + st * T::kBytes, &qmap, bar, h, t * kRows,
                            b);
    wg::load_tile<2 * D, 2>(do_s + st * T::kBytes, &domap, bar, h,
                            t * kRows, b);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) wg::mbar_init(bars + 8 * st, 1);
    wg::mbar_init(kv_bar, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect_tx(kv_bar, 2 * T::kBytes);
    wg::load_tile<2 * D, 2>(k_s, &kmap, kv_bar, h, k0, b);
    wg::load_tile<2 * D, 2>(v_s, &vmap, kv_bar, h, k0, b);
    for (int t = 0; t < kStages && t < num_qb; ++t) load_stage(t);
  }

  // This thread's two keys k0 + row0 (+ 8) and its q columns 8j + col0
  // (+ 1) of each q tile. Keys past S are not masked: they only reach
  // their own rows of dK, dV and dbias, which are not written.
  const int row0 = 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const bool segmented = seg != nullptr;
  float kb[2];
  int kid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + 8 * r;
    const bool inside = key < seq;
    kb[r] = (key_bias != nullptr && inside) ? key_bias[tok0 + key] : 0.f;
    kid[r] = (segmented && inside) ? seg[tok0 + key] : 0;
  }
  float dk_acc[kAcc], dv_acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float db[2] = {0.f, 0.f};  // this thread's share of its keys' dbias

  wg::mbar_wait(kv_bar, 0);
  for (int t = 0; t < num_qb; ++t) {
    const int st = t % kStages;
    const int q0 = t * kRows;
    const uint32_t qt = q_s + st * T::kBytes;
    const uint32_t dot = do_s + st * T::kBytes;
    wg::mbar_wait(bars + 8 * st, (t / kStages) & 1);

    float s[32], da[32];  // S^T and dA^T: keys by q
    wg::pin(s);
    wg::pin(da);
    wg::wgmma_fence();
#pragma unroll
    for (int step = 0; step < D / 16; ++step)
      wg::mma_ss<E>(s, wg::k_major<2 * D>(k_s, step),
                    wg::k_major<2 * D>(qt, step), step > 0);
#pragma unroll
    for (int step = 0; step < D / 16; ++step)
      wg::mma_ss<E>(da, wg::k_major<2 * D>(v_s, step),
                    wg::k_major<2 * D>(dot, step), step > 0);
    wg::wgmma_commit();
    // lse, delta and ids of this thread's 16 q columns, and with dropout
    // its keep bits, made while the MMAs run.
    const bool full = q0 + kRows <= seq;  // every q row of the tile inside S
    float lse_q[16], delta_q[16];
    int qid[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int q = q0 + 8 * (c >> 1) + col0 + (c & 1);
      const bool inside = full || q < seq;
      lse_q[c] = inside ? lse[stat0 + q] : 0.f;
      delta_q[c] = inside ? delta[stat0 + q] : 0.f;
      qid[c] = (segmented && inside) ? seg[tok0 + q] : 0;
    }
    uint32_t keep = ~0u;
    if constexpr (kDropout)
      keep = wg::keep_bits_t(seed, threshold, bh, q0, k0, warp, lane);
    wg::wgmma_wait();
    wg::pin(s);
    wg::pin(da);

    uint32_t pt[16], dst[16];  // P_drop^T and dS^T in E pairs
    if (full)
      grad_tile<E, true, kDropout>(s, da, kb, kid, lse_q, delta_q, qid,
                                   segmented, scale, inv_keep, keep, q0, col0,
                                   seq, db, pt, dst);
    else
      grad_tile<E, false, kDropout>(s, da, kb, kid, lse_q, delta_q, qid,
                                    segmented, scale, inv_keep, keep, q0,
                                    col0, seq, db, pt, dst);

    wg::pin(dk_acc);
    wg::pin(dv_acc);
    wg::pin(pt);
    wg::pin(dst);
    wg::wgmma_fence();
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const uint32_t a_p[4] = {pt[4 * step], pt[4 * step + 1],
                               pt[4 * step + 2], pt[4 * step + 3]};
      wg::mma_pv<E, D>(dv_acc, a_p, wg::mn_major<2 * D>(dot, step));
      const uint32_t a_ds[4] = {dst[4 * step], dst[4 * step + 1],
                                dst[4 * step + 2], dst[4 * step + 3]};
      wg::mma_pv<E, D>(dk_acc, a_ds, wg::mn_major<2 * D>(qt, step));
    }
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::pin(dk_acc);
    wg::pin(dv_acc);

    __syncthreads();  // every read of this stage is done
    if (tid == 0 && t + kStages < num_qb) load_stage(t + kStages);
  }

  const long long row_stride = static_cast<long long>(heads) * D;
  const long long base = tok0 * row_stride + static_cast<long long>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + 8 * r;
    const float db_row = wg::quad_sum(db[r]);
    if (key >= seq) continue;
    if ((lane & 3) == 0) dbias[stat0 + key] = db_row;
    const long long off = base + key * row_stride + col0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int i = 4 * jj + 2 * r;
      *reinterpret_cast<uint32_t*>(dk + off + 8 * jj) =
          wg::pack2<E>(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * jj) =
          wg::pack2<E>(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <typename E, int D, bool kDropout>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             float* dbias, const float* key_bias,
                             const int* seg, int batch, int seq, int heads,
                             float scale, uint2 seed, uint32_t threshold,
                             float inv_keep, cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err = qkvdo_maps<E, D>(maps, q, k, v, dout, batch, seq, heads);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = bwd_smem_bytes<D>();
  err = prepare(flash_dkv_wgmma_kernel<E, D, kDropout>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + wg::kRows - 1) / wg::kRows);
  flash_dkv_wgmma_kernel<E, D, kDropout>
      <<<grid, wg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<E*>(dk),
      static_cast<E*>(dv), dbias,
      key_bias, seg, seq, heads, scale, seed, threshold, inv_keep);
  return cudaGetLastError();
}

template <typename E, int D>
cudaError_t dispatch_dkv_wgmma(bool dropout, const void* q, const void* k,
                               const void* v, const void* dout,
                               const float* lse, const float* delta, void* dk,
                               void* dv, float* dbias, const float* key_bias,
                               const int* seg, int batch, int seq, int heads,
                               float scale, uint2 seed, uint32_t threshold,
                               float inv_keep, cudaStream_t stream) {
  if (dropout)
    return launch_dkv_wgmma<E, D, true>(q, k, v, dout, lse, delta, dk, dv,
                                        dbias, key_bias, seg, batch, seq,
                                        heads, scale, seed, threshold,
                                        inv_keep, stream);
  return launch_dkv_wgmma<E, D, false>(q, k, v, dout, lse, delta, dk, dv,
                                       dbias, key_bias, seg, batch, seq,
                                       heads, scale, seed, threshold,
                                       inv_keep, stream);
}

// -- the dq kernel's tensor-core route ---------------------------------------

// dS of one key tile on this thread's 32 elements of S and dA (raw
// products; element e at q row row0 + 8 * ((e >> 1) & 1) and key k0 +
// 8 * (e >> 2) + col0 + (e & 1), its keep bit bit e of `keep`), given lse,
// delta and ids of its two q rows and the bias and ids of its 16 keys:
// leaves dS in E pairs (the A fragments of four k16 steps). kFull:
// every key of the tile lies before S (else keys past S get probability 0
// by index: their K and V rows read as zeros, but exp(s - lse) there is
// not bounded, and inf * 0 would reach dQ).
template <typename E, bool kFull, bool kDropout>
__device__ __forceinline__ void dq_grad_tile(
    const float (&s)[32], const float (&da)[32], const float (&kb)[16],
    const int (&kid)[16], const float (&lse)[2], const float (&delta)[2],
    const int (&qid)[2], bool segmented, float scale, float inv_keep,
    uint32_t keep, int k0, int col0, int seq, uint32_t (&ds)[16]) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = (e >> 1) & 1;
    float v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = 2 * (e >> 2) + u;  // this thread's key
      float x = __fadd_rn(__fmul_rn(s[e + u], scale), kb[c]);  // no FMA
      if (segmented) x += seg_mask(qid[r], kid[c]);
      float p = wg::exp_approx(x - lse[r]);
      if (!kFull && k0 + 8 * (e >> 2) + col0 + u >= seq) p = 0.f;
      float a = da[e + u];
      if (kDropout) a = (keep >> (e + u)) & 1u ? a * inv_keep : 0.f;
      v[u] = p * (a - delta[r]);
    }
    ds[e >> 1] = wg::pack2<E>(v[0], v[1]);
  }
}

// Launch: grid (batch * heads, ceil(seq / 64)), wg::kThreads threads,
// bwd_smem_bytes<D>() of dynamic shared memory.
template <typename E, int D, bool kDropout>
__global__ void __launch_bounds__(wg::kThreads)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const E* __restrict__ out, const E* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ delta, E* __restrict__ dq,
                      const float* __restrict__ key_bias,
                      const int* __restrict__ seg, int seq, int heads,
                      float scale, uint2 seed, uint32_t threshold,
                      float inv_keep) {
  using T = wg::Tile<2 * D>;
  constexpr int kRows = wg::kRows;
  constexpr int kStages = wg::kStages;
  constexpr int kAcc = D / 2;  // fp32 values of dQ per thread
  extern __shared__ float smem[];  // the same symbol as the CUDA-core kernels'
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kRows;
  const long long tok0 = static_cast<long long>(b) * seq;
  const long long stat0 = static_cast<long long>(bh) * seq;
  const long long row_stride = static_cast<long long>(heads) * D;
  const long long base = tok0 * row_stride + static_cast<long long>(h) * D;
  const int num_kb = (seq + kRows - 1) / kRows;

  const uint32_t raw = wg::smem_u32(smem);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t do_s = q_s + T::kBytes;
  const uint32_t k_s = do_s + T::kBytes;            // kStages K tiles
  const uint32_t v_s = k_s + kStages * T::kBytes;   // kStages V tiles
  const uint32_t bars = v_s + kStages * T::kBytes;  // full[0], full[1]
  const uint32_t q_bar = bars + 8 * kStages;

  auto load_stage = [&](int j) {
    const int st = j % kStages;
    const uint32_t bar = bars + 8 * st;
    wg::mbar_expect_tx(bar, 2 * T::kBytes);
    wg::load_tile<2 * D, 2>(k_s + st * T::kBytes, &kmap, bar, h, j * kRows,
                            b);
    wg::load_tile<2 * D, 2>(v_s + st * T::kBytes, &vmap, bar, h, j * kRows,
                            b);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) wg::mbar_init(bars + 8 * st, 1);
    wg::mbar_init(q_bar, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect_tx(q_bar, 2 * T::kBytes);
    wg::load_tile<2 * D, 2>(q_s, &qmap, q_bar, h, q0, b);
    wg::load_tile<2 * D, 2>(do_s, &domap, q_bar, h, q0, b);
    for (int j = 0; j < kStages && j < num_kb; ++j) load_stage(j);
  }

  // This thread's two q rows q0 + row0 (+ 8) and its keys 8j + col0 (+ 1)
  // of each key tile. Rows past S are not masked: TMA reads their q and dO
  // as zeros, so their dA and delta are 0 and so is their dS, which reaches
  // only their own rows of dQ, which are not written.
  const int row0 = 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const bool segmented = seg != nullptr;
  float lse_q[2], delta_q[2];
  int qid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + row0 + 8 * r;
    const bool inside = q < seq;
    lse_q[r] = inside ? lse[stat0 + q] : 0.f;
    qid[r] = (segmented && inside) ? seg[tok0 + q] : 0;
    // delta = rowsum(dO * O) in fp32 while the tiles load: each lane of the
    // quad takes the 16-byte pieces lane % 4, + 4, ... of the row.
    float part = 0.f;
    if (inside) {
      const uint4* o_row =
          reinterpret_cast<const uint4*>(out + base + q * row_stride);
      const uint4* do_row =
          reinterpret_cast<const uint4*>(dout + base + q * row_stride);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const uint4 ov = o_row[4 * i + (lane & 3)];
        const uint4 dv = do_row[4 * i + (lane & 3)];
        const uint32_t o2[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t d2[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 of = wg::unpack2<E>(o2[t]);
          const float2 df = wg::unpack2<E>(d2[t]);
          part = fmaf(df.x, of.x, part);
          part = fmaf(df.y, of.y, part);
        }
      }
    }
    delta_q[r] = wg::quad_sum(part);
    if (inside && (lane & 3) == 0) delta[stat0 + q] = delta_q[r];
  }
  float dq_acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dq_acc[i] = 0.f;

  wg::mbar_wait(q_bar, 0);
  for (int j = 0; j < num_kb; ++j) {
    const int st = j % kStages;
    const int k0 = j * kRows;
    const uint32_t kt = k_s + st * T::kBytes;
    const uint32_t vt = v_s + st * T::kBytes;
    wg::mbar_wait(bars + 8 * st, (j / kStages) & 1);

    float s[32], da[32];  // S and dA: q rows by keys
    wg::pin(s);
    wg::pin(da);
    wg::wgmma_fence();
#pragma unroll
    for (int step = 0; step < D / 16; ++step)
      wg::mma_ss<E>(s, wg::k_major<2 * D>(q_s, step),
                    wg::k_major<2 * D>(kt, step), step > 0);
#pragma unroll
    for (int step = 0; step < D / 16; ++step)
      wg::mma_ss<E>(da, wg::k_major<2 * D>(do_s, step),
                    wg::k_major<2 * D>(vt, step), step > 0);
    wg::wgmma_commit();
    // The bias and ids of this thread's 16 keys, and with dropout its keep
    // bits, made while the MMAs run.
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
    uint32_t keep = ~0u;
    if constexpr (kDropout)
      keep = wg::keep_bits(seed, threshold, bh, q0 + row0, k0, lane);
    wg::wgmma_wait();
    wg::pin(s);
    wg::pin(da);

    uint32_t ds[16];  // dS in E pairs
    if (full)
      dq_grad_tile<E, true, kDropout>(s, da, kb, kid, lse_q, delta_q, qid,
                                      segmented, scale, inv_keep, keep, k0,
                                      col0, seq, ds);
    else
      dq_grad_tile<E, false, kDropout>(s, da, kb, kid, lse_q, delta_q, qid,
                                       segmented, scale, inv_keep, keep, k0,
                                       col0, seq, ds);

    wg::pin(dq_acc);
    wg::pin(ds);
    wg::wgmma_fence();
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const uint32_t a[4] = {ds[4 * step], ds[4 * step + 1], ds[4 * step + 2],
                             ds[4 * step + 3]};
      wg::mma_pv<E, D>(dq_acc, a, wg::mn_major<2 * D>(kt, step));
    }
    wg::wgmma_commit();
    wg::wgmma_wait();
    wg::pin(dq_acc);

    __syncthreads();  // every read of this stage is done
    if (tid == 0 && j + kStages < num_kb) load_stage(j + kStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + row0 + 8 * r;
    if (q >= seq) continue;
    E* dst = dq + base + q * row_stride + col0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int i = 4 * jj + 2 * r;
      *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
          wg::pack2<E>(dq_acc[i] * scale, dq_acc[i + 1] * scale);
    }
  }
}

template <typename E, int D, bool kDropout>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* out, const void* dout,
                            const float* lse, float* delta, void* dq,
                            const float* key_bias, const int* seg, int batch,
                            int seq, int heads, float scale, uint2 seed,
                            uint32_t threshold, float inv_keep,
                            cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err = qkvdo_maps<E, D>(maps, q, k, v, dout, batch, seq, heads);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = bwd_smem_bytes<D>();
  err = prepare(flash_dq_wgmma_kernel<E, D, kDropout>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + wg::kRows - 1) / wg::kRows);
  flash_dq_wgmma_kernel<E, D, kDropout>
      <<<grid, wg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const E*>(out),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dq), key_bias,
      seg, seq, heads, scale, seed, threshold, inv_keep);
  return cudaGetLastError();
}

template <typename E, int D>
cudaError_t dispatch_dq_wgmma(bool dropout, const void* q, const void* k,
                              const void* v, const void* out,
                              const void* dout, const float* lse,
                              float* delta, void* dq, const float* key_bias,
                              const int* seg, int batch, int seq, int heads,
                              float scale, uint2 seed, uint32_t threshold,
                              float inv_keep, cudaStream_t stream) {
  if (dropout)
    return launch_dq_wgmma<E, D, true>(q, k, v, out, dout, lse, delta, dq,
                                       key_bias, seg, batch, seq, heads,
                                       scale, seed, threshold, inv_keep,
                                       stream);
  return launch_dq_wgmma<E, D, false>(q, k, v, out, dout, lse, delta, dq,
                                      key_bias, seg, batch, seq, heads, scale,
                                      seed, threshold, inv_keep, stream);
}

// The dq tensor-core route's entry for the element type E.
template <typename E>
int dq_wgmma_entry(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, const float* key_bias,
                   const int* seg, int batch, int seq, int heads,
                   int head_dim, float scale, int dropout, uint32_t seed_lo,
                   uint32_t seed_hi, uint32_t threshold, float inv_keep,
                   void* stream) {
  const void* ptrs[6] = {q, k, v, out, dout, dq};
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
      err = dispatch_dq_wgmma<E, 32>(drop, q, k, v, out, dout, lse, delta, dq,
                                     key_bias, seg, batch, seq, heads, scale,
                                     seed, threshold, inv_keep, s);
      break;
    case 64:
      err = dispatch_dq_wgmma<E, 64>(drop, q, k, v, out, dout, lse, delta, dq,
                                     key_bias, seg, batch, seq, heads, scale,
                                     seed, threshold, inv_keep, s);
      break;
    case 128:
      err = dispatch_dq_wgmma<E, 128>(drop, q, k, v, out, dout, lse, delta,
                                      dq, key_bias, seg, batch, seq, heads,
                                      scale, seed, threshold, inv_keep, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dkv tensor-core route's entry for the element type E.
template <typename E>
int dkv_wgmma_entry(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, float* dbias, const float* key_bias,
                    const int* seg, int batch, int seq, int heads,
                    int head_dim, float scale, int dropout, uint32_t seed_lo,
                    uint32_t seed_hi, uint32_t threshold, float inv_keep,
                    void* stream) {
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
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
      err = dispatch_dkv_wgmma<E, 32>(drop, q, k, v, dout, lse, delta, dk, dv,
                                      dbias, key_bias, seg, batch, seq, heads,
                                      scale, seed, threshold, inv_keep, s);
      break;
    case 64:
      err = dispatch_dkv_wgmma<E, 64>(drop, q, k, v, dout, lse, delta, dk, dv,
                                      dbias, key_bias, seg, batch, seq, heads,
                                      scale, seed, threshold, inv_keep, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The dq kernel's CUDA-core route: dq and delta = rowsum(dO * O) from the
// forward's out and lse. dtype:
// 0 = float32, 1 = bfloat16, 2 = float16; key_bias ([B, S] fp32) and seg
// ([B, S] int32) may each be null; lse and delta are [B*H, S] fp32.
// dropout != 0 regenerates the forward's keep mask from (seed_lo, seed_hi,
// threshold); inv_keep = 1 / (1 - rate). Returns the launch's cudaError_t.
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

// The dq kernel's tensor-core route: q, k, v, out, dout, dq [B, S, H, D]
// bfloat16, 16-byte aligned, head_dim 32, 64 or 128; the other arguments as
// for flash_attention_dq. Returns the launch's cudaError_t
// (cudaErrorSymbolNotFound if the driver has no cuTensorMapEncodeTiled).
int flash_attention_dq_wgmma(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const float* lse, float* delta, void* dq,
                             const float* key_bias, const int* seg,
                             int batch, int seq, int heads, int head_dim,
                             float scale, int dropout, uint32_t seed_lo,
                             uint32_t seed_hi, uint32_t threshold,
                             float inv_keep, void* stream) {
  return dq_wgmma_entry<__nv_bfloat16>(
      q, k, v, out, dout, lse, delta, dq, key_bias, seg, batch, seq, heads,
      head_dim, scale, dropout, seed_lo, seed_hi, threshold, inv_keep,
      stream);
}

// The same for float16 tensors.
int flash_attention_dq_wgmma_fp16(const void* q, const void* k,
                                  const void* v, const void* out,
                                  const void* dout, const float* lse,
                                  float* delta, void* dq,
                                  const float* key_bias, const int* seg,
                                  int batch, int seq, int heads, int head_dim,
                                  float scale, int dropout, uint32_t seed_lo,
                                  uint32_t seed_hi, uint32_t threshold,
                                  float inv_keep, void* stream) {
  return dq_wgmma_entry<__half>(
      q, k, v, out, dout, lse, delta, dq, key_bias, seg, batch, seq, heads,
      head_dim, scale, dropout, seed_lo, seed_hi, threshold, inv_keep,
      stream);
}

// The dkv kernel's CUDA-core route: dk, dv and dbias ([B*H, S] fp32, the
// sum over queries of dS) from lse and the delta the dq kernel wrote; the
// other arguments as for dq.
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

// The dkv kernel's tensor-core route: q, k, v, dout, dk, dv [B, S, H, D]
// bfloat16, 16-byte aligned, head_dim 32 or 64; the other arguments as for
// flash_attention_dkv. Returns the launch's cudaError_t
// (cudaErrorSymbolNotFound if the driver has no cuTensorMapEncodeTiled).
int flash_attention_dkv_wgmma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv,
                              float* dbias, const float* key_bias,
                              const int* seg, int batch, int seq, int heads,
                              int head_dim, float scale, int dropout,
                              uint32_t seed_lo, uint32_t seed_hi,
                              uint32_t threshold, float inv_keep,
                              void* stream) {
  return dkv_wgmma_entry<__nv_bfloat16>(
      q, k, v, dout, lse, delta, dk, dv, dbias, key_bias, seg, batch, seq,
      heads, head_dim, scale, dropout, seed_lo, seed_hi, threshold, inv_keep,
      stream);
}

// The same for float16 tensors.
int flash_attention_dkv_wgmma_fp16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, float* dbias,
                                   const float* key_bias, const int* seg,
                                   int batch, int seq, int heads,
                                   int head_dim, float scale, int dropout,
                                   uint32_t seed_lo, uint32_t seed_hi,
                                   uint32_t threshold, float inv_keep,
                                   void* stream) {
  return dkv_wgmma_entry<__half>(
      q, k, v, dout, lse, delta, dk, dv, dbias, key_bias, seg, batch, seq,
      heads, head_dim, scale, dropout, seed_lo, seed_hi, threshold, inv_keep,
      stream);
}

const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
