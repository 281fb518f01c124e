// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC'11): the counter-based generator of K-ATT's attention
// dropout mask, shared by the forward (attention.cu) and the backward
// (attention_bwd.cu) so both draw the same bit for the same logical
// (seed, offset, b, h, q, k). The plain PyTorch version in
// ops/fused_attention.py (`dropout_keep_mask`) computes the same bits with
// int64 tensor arithmetic.
//
// One call gives four 32-bit words: counter (k / 4, q, b * H + h, offset)
// draws the keys 4 (k / 4) .. 4 (k / 4) + 3 of row q, key k taking word
// k % 4, so a call serves four elements.

#pragma once

#include <stdint.h>

namespace etp {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// The four 32-bit words of Philox4x32-10 at counter (c0, c1, c2, c3) under
// key (k0, k1).
__device__ __forceinline__ uint4 philox4(uint32_t c0, uint32_t c1,
                                         uint32_t c2, uint32_t c3,
                                         uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The element is kept iff its word is below `threshold` =
// floor(keep * 2^32).
// heads: the launch's H; heads_total and head_base: the heads of the
// whole layer and the first of them this launch holds. A tensor-parallel
// rank's head h of sample b then draws at counter word b * heads_total +
// head_base + h, the word of that head in the layer's one global mask;
// one process launches with (H, 0), where the word is b * H + h.
struct DropoutParams {
  uint32_t seed_lo, seed_hi, offset, threshold;
  float inv_keep;
  uint32_t heads, heads_total, head_base;
};

// The counter word of the launch's (b * H + h).
__device__ __forceinline__ uint32_t global_bh(const DropoutParams& p,
                                              uint32_t bh) {
  return bh / p.heads * p.heads_total + p.head_base + bh % p.heads;
}

// The dropout draw of one attention probability (b * H + h, q, k).
__device__ __forceinline__ bool dropout_keep(const DropoutParams& p,
                                             uint32_t bh, uint32_t q,
                                             uint32_t k) {
  const uint4 w = philox4(k >> 2, q, global_bh(p, bh), p.offset, p.seed_lo,
                          p.seed_hi);
  const uint32_t x = (k & 2) ? ((k & 1) ? w.w : w.z) : ((k & 1) ? w.y : w.x);
  return x < p.threshold;
}

// The draws of one mma.sync m16n8 accumulator tile, for the whole warp
// (it shuffles): the thread (grp = lane / 4, tig = lane % 4) holds rows
// row0 and row0 + 8 (row0 = the tile's first row + grp) and keys key0 +
// 2 tig, + 1 (key0 = the tile's first key, a multiple of 8); keep[e] is
// the bit of its element e (row row0 + 8 (e / 2), key key0 + 2 tig +
// e % 2). The lanes tig and tig ^ 1 share each group of four keys: each
// draws the group for one of the two rows and hands the other lane the
// two words it needs, so a thread makes one call for four elements.
__device__ __forceinline__ void dropout_keep_tile(const DropoutParams& p,
                                                  uint32_t bh, uint32_t row0,
                                                  uint32_t key0, int tig,
                                                  bool* keep) {
  const bool odd = tig & 1;
  const uint4 w = philox4((key0 >> 2) + (tig >> 1), row0 + (odd ? 8 : 0),
                          global_bh(p, bh), p.offset, p.seed_lo, p.seed_hi);
  // even lanes keep words 0, 1 of their row and send 2, 3; odd lanes the
  // reverse
  const uint32_t ra = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const uint32_t rb = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  keep[0] = (odd ? ra : w.x) < p.threshold;              // row0
  keep[1] = (odd ? rb : w.y) < p.threshold;
  keep[2] = (odd ? w.z : ra) < p.threshold;              // row0 + 8
  keep[3] = (odd ? w.w : rb) < p.threshold;
}

// seed_offset: device int64[2] = {seed, offset}, drawn by the wrapper
// from the caller's torch.Generator, so no value crosses to the host.
__device__ __forceinline__ DropoutParams load_dropout(
    const long long* seed_offset, uint32_t threshold, float inv_keep,
    int heads, int heads_total, int head_base) {
  const unsigned long long s =
      static_cast<unsigned long long>(seed_offset[0]);
  return DropoutParams{static_cast<uint32_t>(s),
                       static_cast<uint32_t>(s >> 32),
                       static_cast<uint32_t>(seed_offset[1]),
                       threshold,
                       inv_keep,
                       static_cast<uint32_t>(heads),
                       static_cast<uint32_t>(heads_total),
                       static_cast<uint32_t>(head_base)};
}

}  // namespace etp
