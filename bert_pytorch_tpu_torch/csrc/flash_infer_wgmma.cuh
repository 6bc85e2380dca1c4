// The forward stream of the attention kernels' tensor-core route, for
// Hopper (sm_90a): the serving kernels flash_attention_infer.cu (fp scores,
// TPU kernel #4) and flash_attention_infer_int8.cu (int8 scores, #5) each
// supply a score tile, and the training forward flash_attention_fwd.cu (#1)
// supplies #4's; the online softmax, the PV product and the output are the
// one body below, as `_infer_stream` in bert_pytorch_tpu/ops/pallas/
// attention.py is shared by `_infer_fwd_kernel` and `_infer_fwd_kernel_int8`
// and `_flash_fwd_kernel` computes the same softmax with dropout and lse.
//
// The function and its numerics are those of flash_infer_stream.cuh and
// flash_attention_fwd.cu's CUDA-core kernel: s = raw * scale + key_bias
// (+ -10000 where the packed ids differ or q's id is 0; product and sum
// rounded apart, as the plain version rounds them), m from -1e30, l summing
// the unrounded, undropped probabilities, P (dropped where the keep mask
// drops) rounded to bf16 before PV with fp32 accumulation, out = acc / l
// (/ (1 - rate) in training) in bf16, keys past S at probability 0 by
// index and rows past S not written; only e^x differs, taken by the
// hardware's ex2.approx. Training also writes lse = m + log(l) (the
// accurate log) as [B*H, S] fp32. Only bf16 v (and out) take this route.
//
// Design, one thread block per (batch*head, 64 query rows), one warpgroup
// (128 threads), from the pieces of wgmma_common.cuh:
//   * TMA brings the q tile once and each 64-key K and V tile through a
//     2-stage ring in shared memory, completing on one mbarrier per stage.
//     Thread 0 issues tile j + 2 into the stage tile j used, once every
//     thread is past it, so the next tile is in flight while this one is
//     computed.
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
//   * Dropout (training) is drawn in registers for the thread's own
//     elements while the score wgmma runs (keep_bits, wgmma_dropout.cuh),
//     from the Philox of flash_attention_common.cuh: no shared-memory mask
//     tile.
//   * The softmax's instructions on the CUDA cores, not the tensor cores,
//     set the time, so it is kept lean: e^x by one `ex2.approx`, and the
//     index checks for keys past S only on the ragged last tile.

#pragma once

#include "flash_attention_common.cuh"
#include "wgmma_common.cuh"
#include "wgmma_dropout.cuh"

namespace flash {
namespace wg {

// The online softmax of one key tile on this thread's 32 accumulator
// elements (element e: row row0 + 8 * ((e >> 1) & 1), key k0 + 8 * (e >> 2)
// + col0 + (e & 1)), given the raw scores s and the bias kb and ids kid of
// its 16 keys: updates the running max m and this thread's share of the
// row sum l, leaves P in bf16 pairs (the A fragments of four k16 steps)
// and the factor alpha the output must be rescaled by. kFull: every key of
// the tile lies before S, so no key is masked by index. kDropout: l sums
// every probability, then P is zeroed where bit e of `keep` is 0.
template <bool kFull, bool kDropout>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], const float (&kb)[16], const int (&kid)[16],
    const int (&qid)[2], bool segmented, float scale, int k0, int col0,
    int seq, uint32_t keep, float (&m)[2], float (&l)[2], float (&alpha)[2],
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
    l[r] += p0 + p1;  // l sums the unrounded, undropped probabilities
    if (kDropout) {
      p0 = (keep >> e) & 1u ? p0 : 0.f;
      p1 = (keep >> (e + 1)) & 1u ? p1 : 0.f;
    }
    p[e >> 1] = pack_bf16(p0, p1);
  }
}

// The fp score tile of #4 and #1: bf16 q and K tiles by TMA, S = Q K^T by
// wgmma m64n64k16 (bf16 -> fp32).
template <int D>
struct Bf16Scores {
  static constexpr int kQBytes = Tile<2 * D>::kBytes;
  static constexpr int kKBytes = kQBytes;
  const CUtensorMap* qmap;
  const CUtensorMap* kmap;

  __device__ __forceinline__ void load_q(uint32_t dst, uint32_t bar, int h,
                                         int s, int b) const {
    load_tile<2 * D, 2>(dst, qmap, bar, h, s, b);
  }
  __device__ __forceinline__ void load_k(uint32_t dst, uint32_t bar, int h,
                                         int s, int b) const {
    load_tile<2 * D, 2>(dst, kmap, bar, h, s, b);
  }
  __device__ __forceinline__ void issue(uint32_t qs, uint32_t ks,
                                        float (&s)[32]) const {
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int step = 0; step < D / 16; ++step)
      mma_bf16_ss(s, k_major<2 * D>(qs, step), k_major<2 * D>(ks, step),
                  step > 0);
    wgmma_commit();
  }
  __device__ __forceinline__ void finish(float (&s)[32]) const {
    wgmma_wait();
    pin(s);
  }
};

// Dynamic shared memory a kernel of this route asks for: the q tile, two
// K and two V stages (bf16 V, rows of 2 * head_dim bytes), three mbarriers,
// and 1024 bytes to align the base for the 128-byte swizzle.
template <class Scores, int D>
constexpr size_t smem_bytes() {
  return 1024 + Scores::kQBytes + kStages * Scores::kKBytes +
         kStages * Tile<2 * D>::kBytes + 3 * sizeof(uint64_t);
}

// What the training forward adds to the stream. Serving passes Serve{}.
struct Serve {};
struct Train {
  float* lse;          // [B*H, S] fp32: m + log(l) of every row
  uint2 seed;          // the Philox key
  uint32_t threshold;  // keep iff the element's 32 bits are >= threshold
  float keep_scale;    // 1 - rate: out = acc / (l * keep_scale)
};

// The shared stream. `Scores` supplies:
//   kQBytes, kKBytes          the shared-memory bytes of its q and K tiles;
//   load_q(dst, bar, h, s, b) / load_k(...)
//                             issue the TMA loads of those tiles (thread 0);
//   issue(q, k, s)            start the score wgmma of q and K tiles at
//                             shared addresses q and k;
//   finish(s)                 wait for it and leave the raw fp32 products in
//                             s (the stream multiplies them by `scale`).
// `Extra` is Serve or Train; kDropout (Train only) draws the keep mask.
// Launch: grid (batch * heads, ceil(seq / 64)), kThreads threads,
// smem_bytes<Scores, D>() of dynamic shared memory.
template <int D, bool kDropout = false, class Scores, class Extra = Serve>
__device__ __forceinline__ void forward_stream(
    Scores& scores, float scale, const CUtensorMap* vmap,
    __nv_bfloat16* __restrict__ out, const float* __restrict__ key_bias,
    const int* __restrict__ seg, int seq, int heads, uint8_t* smem_raw,
    const Extra& extra = Extra{}) {
  constexpr bool kTrain = std::is_same_v<Extra, Train>;
  static_assert(kTrain || !kDropout, "dropout is training's");
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
    // The bias and ids of this thread's 16 keys, and in training with
    // dropout its keep bits, made while the MMA runs.
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
      keep = keep_bits(extra.seed, extra.threshold, blockIdx.x, q0 + row0,
                       k0, lane);
    scores.finish(s);

    float alpha[2];
    uint32_t p[16];  // P in bf16 pairs: the A fragments of four k16 steps
    if (full)
      softmax_tile<true, kDropout>(s, kb, kid, qid, segmented, scale, k0,
                                   col0, seq, keep, m, l, alpha, p);
    else
      softmax_tile<false, kDropout>(s, kb, kid, qid, segmented, scale, k0,
                                    col0, seq, keep, m, l, alpha, p);
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
    float denom = sum;
    if constexpr (kTrain) {
      denom = sum * extra.keep_scale;
      if ((lane & 3) == 0)
        extra.lse[static_cast<long long>(blockIdx.x) * seq + s] =
            m[r] + logf(sum);
    }
    __nv_bfloat16* dst = out + base + s * row_stride + col0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          o[4 * jj + 2 * r] / denom, o[4 * jj + 2 * r + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) = v;
    }
  }
}

}  // namespace wg
}  // namespace flash
