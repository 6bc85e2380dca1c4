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
// drops) rounded to v's 16-bit type before PV with fp32 accumulation,
// out = acc / l (/ (1 - rate) in training) in that type, keys past S at
// probability 0 by index and rows past S not written; only e^x differs,
// taken by the hardware's ex2.approx. Training also writes lse = m +
// log(l) (the accurate log) as [B*H, S] fp32. bf16 v (and out) take this
// route, and in training fp16 too: the stream is a template on the element
// type E (__nv_bfloat16 or __half), which sets the wgmma instructions'
// input type, the TMA maps' and the rounding of P and out (to nearest,
// not saturating).
//
// Design, from the pieces of wgmma_common.cuh. The tile geometry is
// (kBlockQ, kBlockK, bh_block): a thread block takes kBlockQ query rows
// (64: one warpgroup of 128 threads; 128: two warpgroups, each owning 64
// rows and sharing every K/V stage), keys kBlockK at a time (64 or 128,
// the N of the score wgmma), and walks bh_block (batch*head) slices in
// turn, so the grid is (batch * heads / bh_block, ceil(seq / kBlockQ)).
// Training and the serving default take (64, 64, 1); the serving kernels
// instantiate more tiles for a measured choice (ops/kernels/autotune.py).
//   * TMA brings the q tile of a slice once and each kBlockK-key K and V
//     tile through a 2-stage ring in shared memory, completing on one
//     mbarrier per stage. Thread 0 issues tile t + 2 into the stage tile t
//     used, once every thread is past it, so the next tile is in flight
//     while this one is computed; the ring runs on across slices, so the
//     next slice's first tiles load under this one's last, and its q tile
//     loads once every warpgroup's last score wgmma of this slice is done.
//   * S = Q K^T is `wgmma.mma_async` m64nN (N = kBlockK) with both operands
//     K-major in shared memory (k16 for bf16 and fp16, k32 for int8 ->
//     int32, exact); the Scores object issues it and hands back raw fp32
//     products.
//   * The online softmax runs on the accumulator fragments: thread t of
//     warp w owns rows 16w + t/4 and 16w + t/4 + 8 and, per 8-key block j,
//     keys 8j + 2(t%4) and one more; row max and row sum reduce over the 4
//     threads of a quad with shuffles.
//   * P, rounded to E in registers, is the A operand of the PV wgmma as
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

// The online softmax of one key tile of kN keys on this thread's kN / 2
// accumulator elements (element e: row row0 + 8 * ((e >> 1) & 1), key k0 +
// 8 * (e >> 2) + col0 + (e & 1)), given the raw scores s and the bias kb and
// ids kid of its kN / 4 keys: updates the running max m and this thread's
// share of the row sum l, leaves P in E pairs (the A fragments of kN / 16
// k16 steps) and the factor alpha the output must be rescaled by. kFull:
// every key of the tile lies before S, so no key is masked by index.
// kDropout (64-key tiles only): l sums every probability, then P is zeroed
// where bit e of `keep` is 0.
template <typename E, int kN, bool kFull, bool kDropout>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kN / 2], const float (&kb)[kN / 4], const int (&kid)[kN / 4],
    const int (&qid)[2], bool segmented, float scale, int k0, int col0,
    int seq, uint32_t keep, float (&m)[2], float (&l)[2], float (&alpha)[2],
    uint32_t (&p)[kN / 4]) {
  static_assert(kN == 64 || !kDropout, "the keep bits cover 64 keys");
  float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
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
  for (int e = 0; e < kN / 2; e += 2) {
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
    p[e >> 1] = pack2<E>(p0, p1);
  }
}

// The fp score tile of #4 and #1: a 64-row q tile and kN-key K tiles in the
// 16-bit type E by TMA, S = Q K^T by wgmma m64nNk16 (E -> fp32).
template <typename E, int D, int kKeys = kRows>
struct HalfScores {
  static constexpr int kN = kKeys;
  static constexpr int kQBytes = Tile<2 * D>::kBytes;
  static constexpr int kKBytes = Tile<2 * D, kN>::kBytes;
  const CUtensorMap* qmap;
  const CUtensorMap* kmap;

  __device__ __forceinline__ void load_q(uint32_t dst, uint32_t bar, int h,
                                         int s, int b) const {
    load_tile<2 * D, 2>(dst, qmap, bar, h, s, b);
  }
  __device__ __forceinline__ void load_k(uint32_t dst, uint32_t bar, int h,
                                         int s, int b) const {
    load_tile<2 * D, 2, kN>(dst, kmap, bar, h, s, b);
  }
  // The score scale of the (batch*head) slice bh: the stream's own.
  __device__ __forceinline__ float head_scale(int, float scale) const {
    return scale;
  }
  __device__ __forceinline__ void issue(uint32_t qs, uint32_t ks,
                                        float (&s)[kN / 2]) const {
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int step = 0; step < D / 16; ++step)
      mma_ss<E, kN>(s, k_major<2 * D>(qs, step), k_major<2 * D, kN>(ks, step),
                    step > 0);
    wgmma_commit();
  }
  __device__ __forceinline__ void finish(float (&s)[kN / 2]) const {
    wgmma_wait();
    pin(s);
  }
};

// The score tile of the bf16 serving kernel #4.
template <int D, int kKeys = kRows>
using Bf16Scores = HalfScores<__nv_bfloat16, D, kKeys>;

// Dynamic shared memory a kernel of this route asks for: kBlockQ / 64 q
// tiles, two K and two V stages of Scores::kN keys (16-bit V, rows of
// 2 * head_dim bytes), three mbarriers, and 1024 bytes to align the base
// for the 128-byte swizzle.
template <class Scores, int D, int kBlockQ = kRows>
constexpr size_t smem_bytes() {
  return 1024 + (kBlockQ / kRows) * Scores::kQBytes +
         kStages * Scores::kKBytes +
         kStages * Tile<2 * D, Scores::kN>::kBytes + 3 * sizeof(uint64_t);
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
//   kN                        keys per tile (kBlockK: 64 or 128);
//   kQBytes, kKBytes          the shared-memory bytes of a 64-row q tile and
//                             of a kN-key K tile;
//   load_q(dst, bar, h, s, b) / load_k(...)
//                             issue the TMA loads of those tiles (thread 0);
//   head_scale(bh, scale)     the score scale of slice bh;
//   issue(q, k, s)            start the score wgmma of q and K tiles at
//                             shared addresses q and k;
//   finish(s)                 wait for it and leave the raw fp32 products in
//                             s (the stream multiplies them by the scale).
// `Extra` is Serve or Train; kDropout (Train only) draws the keep mask.
// E, the type of v and out, is the type P is rounded to. kBlockQ: 64 or 128
// query rows per block (one or two warpgroups); bh_block: the (batch*head)
// slices each block walks, blockIdx.x * bh_block + g for g < bh_block.
// Launch: grid (batch * heads / bh_block, ceil(seq / kBlockQ)),
// kBlockQ / 64 * kThreads threads, smem_bytes<Scores, D, kBlockQ>() of
// dynamic shared memory.
template <int D, bool kDropout = false, int kBlockQ = kRows, class Scores,
          class Extra = Serve, typename E>
__device__ __forceinline__ void forward_stream(
    Scores& scores, float scale, const CUtensorMap* vmap,
    E* __restrict__ out, const float* __restrict__ key_bias,
    const int* __restrict__ seg, int seq, int heads, uint8_t* smem_raw,
    const Extra& extra = Extra{}, int bh_block = 1) {
  constexpr bool kTrain = std::is_same_v<Extra, Train>;
  static_assert(kTrain || !kDropout, "dropout is training's");
  static_assert(kBlockQ == kRows || kBlockQ == 2 * kRows, "64 or 128 rows");
  constexpr int kN = Scores::kN;
  constexpr int kGroups = kBlockQ / kRows;  // consumer warpgroups
  using V = Tile<2 * D, kN>;
  constexpr int kOut = D / 2;  // fp32 output values per thread
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int group = tid / kThreads;  // this thread's warpgroup
  const int q0 = blockIdx.y * kBlockQ + group * kRows;  // its first row
  const int num_kb = (seq + kN - 1) / kN;
  const int total = bh_block * num_kb;  // key tiles over the block's slices

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t k_s = q_s + kGroups * Scores::kQBytes;
  const uint32_t v_s = k_s + kStages * Scores::kKBytes;
  const uint32_t bars = v_s + kStages * V::kBytes;  // full[0], full[1], q
  const uint32_t q_bar = bars + 8 * kStages;

  // Slice g of this block: its (batch*head) index and (b, h).
  auto slice = [&](int g, int& b, int& h) {
    const int bh = blockIdx.x * bh_block + g;
    b = bh / heads;
    h = bh - b * heads;
    return bh;
  };
  auto load_q = [&](int g) {
    int b, h;
    slice(g, b, h);
    mbar_expect_tx(q_bar, kGroups * Scores::kQBytes);
#pragma unroll
    for (int w = 0; w < kGroups; ++w)
      scores.load_q(q_s + w * Scores::kQBytes, q_bar, h,
                    blockIdx.y * kBlockQ + w * kRows, b);
  };
  // Key tile t of the block: tile t % num_kb of slice t / num_kb.
  auto load_stage = [&](int t) {
    const int st = t % kStages;
    const int g = t / num_kb;
    const int j = t - g * num_kb;
    int b, h;
    slice(g, b, h);
    const uint32_t bar = bars + 8 * st;
    mbar_expect_tx(bar, Scores::kKBytes + V::kBytes);
    scores.load_k(k_s + st * Scores::kKBytes, bar, h, j * kN, b);
    load_tile<2 * D, 2, kN>(v_s + st * V::kBytes, vmap, bar, h, j * kN, b);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, 1);
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_q(0);
    for (int t = 0; t < kStages && t < total; ++t) load_stage(t);
  }

  // This thread's two rows and its keys 8j + col0 (+1) of each tile.
  const int row0 = 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const bool segmented = seg != nullptr;
  const uint32_t my_q = q_s + group * Scores::kQBytes;
  for (int g = 0; g < bh_block; ++g) {
    int b, h;
    const int bh = slice(g, b, h);
    const long long tok0 = static_cast<long long>(b) * seq;
    const float head_scale = scores.head_scale(bh, scale);
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

    mbar_wait(q_bar, g & 1);
    for (int j = 0; j < num_kb; ++j) {
      const int t = g * num_kb + j;
      const int st = t % kStages;
      const int k0 = j * kN;
      mbar_wait(bars + 8 * st, (t / kStages) & 1);

      float s[kN / 2];
      scores.issue(my_q, k_s + st * Scores::kKBytes, s);
      // The bias and ids of this thread's kN / 4 keys, and in training with
      // dropout its keep bits, made while the MMA runs.
      const bool full = k0 + kN <= seq;  // every key of the tile inside S
      float kb[kN / 4];
      int kid[kN / 4];
#pragma unroll
      for (int c = 0; c < kN / 4; ++c) {
        const int key = k0 + 8 * (c >> 1) + col0 + (c & 1);
        const bool inside = full || key < seq;
        kb[c] = (key_bias != nullptr && inside) ? key_bias[tok0 + key] : 0.f;
        kid[c] = (segmented && inside) ? seg[tok0 + key] : 0;
      }
      uint32_t keep = ~0u;
      if constexpr (kDropout)
        keep = keep_bits(extra.seed, extra.threshold, bh, q0 + row0, k0,
                         lane);
      scores.finish(s);
      if (j + 1 == num_kb && g + 1 < bh_block) {
        // Every warpgroup's score wgmmas of this slice are done with its q
        // tile: bring the next slice's.
        __syncthreads();
        if (tid == 0) load_q(g + 1);
      }

      float alpha[2];
      uint32_t p[kN / 4];  // P in E pairs: the A fragments of kN/16 k16 steps
      if (full)
        softmax_tile<E, kN, true, kDropout>(s, kb, kid, qid, segmented,
                                            head_scale, k0, col0, seq, keep,
                                            m, l, alpha, p);
      else
        softmax_tile<E, kN, false, kDropout>(s, kb, kid, qid, segmented,
                                             head_scale, k0, col0, seq, keep,
                                             m, l, alpha, p);
#pragma unroll
      for (int i = 0; i < kOut; ++i) o[i] *= alpha[(i >> 1) & 1];

      pin(o);
      pin(p);
      wgmma_fence();
#pragma unroll
      for (int step = 0; step < kN / 16; ++step) {
        const uint32_t a[4] = {p[4 * step], p[4 * step + 1], p[4 * step + 2],
                               p[4 * step + 3]};
        mma_pv<E, D>(o, a, mn_major<2 * D, kN>(v_s + st * V::kBytes, step));
      }
      wgmma_commit();
      wgmma_wait();
      pin(o);

      __syncthreads();  // every read of this stage is done
      if (tid == 0 && t + kStages < total) load_stage(t + kStages);
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
          extra.lse[static_cast<long long>(bh) * seq + s] = m[r] + logf(sum);
      }
      E* dst = out + base + s * row_stride + col0;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) = pack2<E>(
            o[4 * jj + 2 * r] / denom, o[4 * jj + 2 * r + 1] / denom);
    }
  }
}

}  // namespace wg
}  // namespace flash
