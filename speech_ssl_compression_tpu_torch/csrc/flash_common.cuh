// Pieces shared by the flash-attention kernels (flash_attn_fwd.cu and the
// _sm90 files): the tile geometry, the f32 staging of q/k/v tiles in shared
// memory, the bf16 rounding points, and the counter-based keep bits of
// attention dropout.
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
// is ever stored in device memory. keep() gives one score's bit, one call
// per score (the f32 forward); keep_word() the bits of 32 adjacent keys
// from eight calls (the bf16 kernels; the f32 backward draws 16 keys from
// four calls the same way).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sslc {

constexpr int kD = 64;         // head dim (every shipped config)
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 micro-tile each
constexpr int kLd = 68;        // padded smem row stride in floats; a multiple
                               // of 4 keeps float4 alignment, and rows land
                               // 4 banks apart
constexpr float kNegInf = -1e30f;

static_assert(kD == 64 && kBQ == 64 && kBK == 64,
              "the thread layouts assume 64 x 64 tiles");

// Copy rows [row0, row0 + n_valid) of a (T, 64) row-major slab into a
// (64, kLd) f32 shared tile; rows past n_valid are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n_valid, int tid) {
  for (int i = tid; i < kBQ * (kD / 4); i += kThreads) {
    const int r = i / (kD / 4);
    const int c4 = i % (kD / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) {
      val = reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * kD)[c4];
    }
    *reinterpret_cast<float4*>(dst + r * kLd + c4 * 4) = val;
  }
}

__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src,
                                          int row0, int n_valid, int tid) {
  for (int i = tid; i < kBQ * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c8 = i % (kD / 8);
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 hi = lo;
    if (r < n_valid) {
      const uint4 raw =
          reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kD)[c8];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h2[0]);
      const float2 b = __bfloat1622float2(h2[1]);
      const float2 c = __bfloat1622float2(h2[2]);
      const float2 d = __bfloat1622float2(h2[3]);
      lo = make_float4(a.x, a.y, b.x, b.y);
      hi = make_float4(c.x, c.y, d.x, d.y);
    }
    float* p = dst + r * kLd + c8 * 8;
    *reinterpret_cast<float4*>(p) = lo;
    *reinterpret_cast<float4*>(p + 4) = hi;
  }
}

// A value as an MXU-style dot in the input dtype sees it: unchanged for
// f32, rounded for bf16 (the Pallas kernels cast p, pd and ds to the input
// dtype before their dots).
__device__ __forceinline__ float round_in(float x, const float*) { return x; }
__device__ __forceinline__ float round_in(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store4(float* dst, const float* x) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* x) {
  __nv_bfloat162 v[2] = {__floats2bfloat162_rn(x[0], x[1]),
                         __floats2bfloat162_rn(x[2], x[3])};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(v);
}

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

// Word w (0..3) of the same draw: the first nine rounds, then of the last
// round only the product that word needs (words 0 and 1 come from the
// second multiplier times c2, words 2 and 3 from the first times c0). One
// score's bit costs about what the first word alone did.
__device__ __forceinline__ uint32_t philox4_word(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t k0,
                                                 uint32_t k1, int w) {
  uint32_t c3 = 0;
#pragma unroll
  for (int r = 0; r < 9; ++r) philox_round(c0, c1, c2, c3, k0, k1);
  const bool from_c0 = w & 2;
  const uint32_t m = from_c0 ? 0xD2511F53u : 0xCD9E8D57u;
  const uint32_t a = from_c0 ? c0 : c2;
  const uint32_t hi = __umulhi(m, a) ^ (from_c0 ? c3 ^ k1 : c1 ^ k0);
  return (w & 1) ? m * a : hi;
}

// The Dropout of a C entry point's arguments: the scale is 1 without
// dropout, and the 64-bit seed is the Philox key (seed lo, seed hi).
inline Dropout make_dropout(int use_dropout, unsigned int keep_threshold,
                            float keep_scale, unsigned long long seed) {
  return Dropout{use_dropout, keep_threshold, use_dropout ? keep_scale : 1.f,
                 (uint32_t)seed, (uint32_t)(seed >> 32)};
}

__device__ __forceinline__ bool keep(const Dropout& dp, int col, int row,
                                     uint32_t bh) {
  return philox4_word((uint32_t)col >> 2, (uint32_t)row, bh, dp.seed_lo,
                      dp.seed_hi, col & 3) < dp.threshold;
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
