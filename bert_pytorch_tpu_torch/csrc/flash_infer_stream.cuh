// The online-softmax + PV stream shared by the serving attention kernels:
// flash_attention_infer.cu (fp scores, TPU kernel #4) and
// flash_attention_infer_int8.cu (int8 scores, TPU kernel #5).
//
// The counterpart of `_infer_stream` in bert_pytorch_tpu/ops/pallas/
// attention.py, which the two TPU kernels share so that a fix to the stream
// can never diverge between them. Here, too, each kernel supplies only its
// score tile, as a `Scores` object with these members:
//
//   load_keys(k0)  stage the key tile starting at row k0 in shared memory
//                  in a pass of its own, or do nothing;
//   stage_key(r, d, inside, off)
//                  or stage element d of key row r inside the stream's pass
//                  over the V tile (`off` is the element's offset in the
//                  [B, S, H, D] layout, `inside` whether its row lies
//                  before S), so the key and value loads share one index
//                  computation. The fp kernel stages its K elements here;
//                  the int8 kernel, whose K tile is a quarter the words,
//                  is faster with a pass of its own (measured: PERF.md);
//   tile(sc)       fill sc[i][c] with the raw fp32 product of query row
//                  ty + 16 i and key tx + 16 c of the tile (the scale is
//                  applied by the stream);
//
// and the kernel has staged its query rows before it calls the stream (the
// stream's first barrier publishes them). Everything downstream is this one
// body: s = raw * scale + key_bias (+ the -10000 packed block-diagonal mask;
// the product and the sum rounded apart, no fused multiply-add),
// the fp32 online softmax (running max m from -1e30, running sum l of the
// unrounded probabilities), P rounded to v's dtype before the PV product
// with fp32 accumulation, and out = acc / l in v's dtype.
//
// Geometry: one block per (batch*head, 64-row q tile), 256 threads in a
// 16 x 16 grid; each thread owns a 4 x 4 block of the score tile (rows
// ty + 16 i, keys tx + 16 c) and a 4 x (head_dim / 16) block of the output.
// The rows of one thread group live in one half-warp, so row max and row
// sum reduce with shuffles and P crosses only a warp through shared memory.
// V is staged as fp32 with rows padded to an odd stride (free of bank
// conflicts). The ragged edge (S not a multiple of 64) is masked: keys past
// S get probability 0, rows past S are not written.

#pragma once

#include "flash_attention_common.cuh"

namespace flash {

// Shared memory the stream uses after the kernel's own score region:
// vs [kTile][head_dim + 1] fp32, ps [kTile][kPStride] fp32, the key bias
// [kTile] fp32, and the key and query sequence ids [kTile] int32 each.
inline size_t stream_smem_bytes(int head_dim) {
  return sizeof(float) * (static_cast<size_t>(kTile) * (head_dim + 1) +
                          kTile * kPStride + kTile) +
         sizeof(int) * 2 * kTile;
}

template <typename T, int kChunks, class Scores>
__device__ __forceinline__ void infer_stream(
    Scores& scores, float scale, const T* __restrict__ v, T* __restrict__ out,
    const float* __restrict__ key_bias, const int* __restrict__ seg, int seq,
    int head_dim, long long base, long long row_stride, long long tok0,
    int q0, float* smem) {
  const int ld = head_dim + 1;
  float* vs = smem;                                  // [kTile][ld]
  float* ps = vs + kTile * ld;                       // [kTile][kPStride]
  float* kb = ps + kTile * kPStride;                 // [kTile]
  int* kseg = reinterpret_cast<int*>(kb + kTile);    // [kTile]
  int* qseg = kseg + kTile;                          // [kTile]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const bool segmented = seg != nullptr;

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
    scores.load_keys(k0);
    for (int e = tid; e < kTile * head_dim; e += kThreads) {
      const int r = e / head_dim;
      const int d = e - r * head_dim;
      const int s = k0 + r;
      const bool inside = s < seq;
      const long long off = base + s * row_stride + d;
      scores.stage_key(r, d, inside, off);
      vs[r * ld + d] = inside ? to_float(v[off]) : 0.f;
    }
    if (tid < kTile) {
      const int s = k0 + tid;
      kb[tid] = (key_bias != nullptr && s < seq) ? key_bias[tok0 + s] : 0.f;
      if (segmented) kseg[tid] = s < seq ? seg[tok0 + s] : 0;
    }
    __syncthreads();

    float sc[kPer][kPer];
    scores.tile(sc);

    // Online softmax over this key tile, one half-warp per row group.
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
      float tile_max = kNegInf;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int kk = tx + 16 * c;
        // Product and sum rounded apart, as the plain version rounds
        // them: a fused multiply-add would round once, and next to a
        // -10000 bias (ulp ~1e-3) that flips scores of masked rows.
        float s = __fadd_rn(__fmul_rn(sc[i][c], scale), kb[kk]);
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
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = tx + 16 * c;
      if (d < head_dim)
        out[base + s * row_stride + d] = from_float<T>(acc[i][c] / l[i]);
    }
  }
}

}  // namespace flash
