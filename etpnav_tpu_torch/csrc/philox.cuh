// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC'11): the counter-based generator of K-ATT's attention
// dropout mask, shared by the forward (attention.cu) and the backward
// (attention_bwd.cu) so both draw the same bit for the same logical
// (seed, offset, b, h, q, k). The plain PyTorch version in
// ops/fused_attention.py (`dropout_keep_mask`) computes the same bits with
// int64 tensor arithmetic.

#pragma once

#include <stdint.h>

namespace etp {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// First 32-bit word of Philox4x32-10 at counter (c0, c1, c2, c3) under key
// (k0, k1).
__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1,
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
  return c0;
}

// The dropout draw of one attention probability: counter (key index k,
// query index q, b * H + h, offset), key (seed low, seed high). The element
// is kept iff the word is below `threshold` = floor(keep * 2^32).
struct DropoutParams {
  uint32_t seed_lo, seed_hi, offset, threshold;
  float inv_keep;
};

__device__ __forceinline__ bool dropout_keep(const DropoutParams& p,
                                             uint32_t bh, uint32_t q,
                                             uint32_t k) {
  return philox_word(k, q, bh, p.offset, p.seed_lo, p.seed_hi) <
         p.threshold;
}

// seed_offset: device int64[2] = {seed, offset}, drawn by the wrapper
// from the caller's torch.Generator, so no value crosses to the host.
__device__ __forceinline__ DropoutParams load_dropout(
    const long long* seed_offset, uint32_t threshold, float inv_keep) {
  const unsigned long long s =
      static_cast<unsigned long long>(seed_offset[0]);
  return DropoutParams{static_cast<uint32_t>(s),
                       static_cast<uint32_t>(s >> 32),
                       static_cast<uint32_t>(seed_offset[1]), threshold,
                       inv_keep};
}

}  // namespace etp
