// Pieces shared by the flash-attention kernels (the C entry points of
// flash_attn_fwd.cu and flash_attn_bwd.cu, and the _sm90 files): the head
// dim, the finite mask value, and the counter-based keep bits of attention
// dropout.
//
// The keep bits. Pallas seeds the TPU's hardware generator once per score
// tile (_tile_keep_mask, speech_ssl_compression_tpu/ops/flash_attention.py:49)
// and so ties the mask to the tile grid. Here the bits come from
// Philox-4x32-10 (Salmon et al., SC'11), one call for four adjacent keys:
//   counter = (key index / 4, query row, b * H + h, 0),  key = (seed lo, seed hi)
// and key `col` takes word col mod 4 of the call's four: keep iff
// bits < keep_threshold(p) (ops/dropout.py::keep_threshold). The bits are a
// function of (seed, b, h, row, col) alone, whatever the tiles, so the
// forward, both backward kernels and the plain PyTorch version
// (ops/dropout.py::attention_keep_mask) compute the same mask, and no mask
// is ever stored in device memory. keep_word() gives the bits of 32
// adjacent keys from eight calls (the bf16 kernels; the f32 kernels draw
// 16 keys from four calls the same way, split_tf32.cuh's keep_bits16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sslc {

constexpr int kD = 64;         // head dim (every shipped config)
constexpr float kNegInf = -1e30f;

// Attention dropout's parameters, passed by value to every kernel.
struct Dropout {
  int on;              // 0: no dropout (the mask is never computed)
  uint32_t threshold;  // keep iff bits < threshold
  float scale;         // 1 / (1 - p), applied to kept probabilities
  uint32_t seed_lo, seed_hi;
};

// One Philox-4x32 round on the counter (c0, c1, c2, c3) with key (k0, k1),
// then the key's Weyl step.
__device__ __forceinline__ void philox_round(uint32_t& c0, uint32_t& c1,
                                             uint32_t& c2, uint32_t& c3,
                                             uint32_t& k0, uint32_t& k1) {
  const uint32_t lo0 = 0xD2511F53u * c0;
  const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
  const uint32_t lo1 = 0xCD9E8D57u * c2;
  const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
  c0 = hi1 ^ c1 ^ k0;
  c1 = lo1;
  c2 = hi0 ^ c3 ^ k1;
  c3 = lo0;
  k0 += 0x9E3779B9u;
  k1 += 0xBB67AE85u;
}

// Philox-4x32-10 at counter (c0, c1, c2, 0), key (k0, k1): all four words.
__device__ __forceinline__ uint4 philox4(uint32_t c0, uint32_t c1, uint32_t c2,
                                         uint32_t k0, uint32_t k1) {
  uint32_t c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) philox_round(c0, c1, c2, c3, k0, k1);
  return make_uint4(c0, c1, c2, c3);
}

// The Dropout of a C entry point's arguments: the scale is 1 without
// dropout, and the 64-bit seed is the Philox key (seed lo, seed hi).
inline Dropout make_dropout(int use_dropout, unsigned int keep_threshold,
                            float keep_scale, unsigned long long seed) {
  return Dropout{use_dropout, keep_threshold, use_dropout ? keep_scale : 1.f,
                 (uint32_t)seed, (uint32_t)(seed >> 32)};
}

// The keep bits of keys key0 .. key0 + 31 of query row `row` (key0 a
// multiple of 4), bit c for key key0 + c: eight Philox calls, every word
// used.
__device__ __forceinline__ uint32_t keep_word(const Dropout& dp, int row,
                                              int key0, uint32_t bh) {
  uint32_t word = 0;
#pragma unroll 2
  for (int g = 0; g < 8; ++g) {
    const uint4 r = philox4(((uint32_t)key0 >> 2) + g, (uint32_t)row, bh,
                            dp.seed_lo, dp.seed_hi);
    word |= ((uint32_t)(r.x < dp.threshold) |
             ((uint32_t)(r.y < dp.threshold) << 1) |
             ((uint32_t)(r.z < dp.threshold) << 2) |
             ((uint32_t)(r.w < dp.threshold) << 3))
            << (4 * g);
  }
  return word;
}

}  // namespace sslc
