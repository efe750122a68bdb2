// Pieces shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the tile geometry, the f32 staging of q/k/v/dO tiles
// in shared memory, the bf16 rounding points, and the counter-based keep
// bits of attention dropout.
//
// The keep bits. Pallas seeds the TPU's hardware generator once per score
// tile (_tile_keep_mask, speech_ssl_compression_tpu/ops/flash_attention.py:49)
// and so ties the mask to the tile grid. Here every score element draws its
// own bits from Philox-4x32-10 (Salmon et al., SC'11) with
//   counter = (key index, query row, b * H + h, 0),  key = (seed lo, seed hi)
// and keeps the first 32-bit word: keep iff bits < keep_threshold(p)
// (ops/dropout.py::keep_threshold). The bits are a function of
// (seed, b, h, row, col) alone, whatever the tiles, so the forward, both
// backward kernels and the plain PyTorch version
// (ops/dropout.py::attention_keep_mask) compute the same mask, and no mask
// is ever stored.

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
constexpr size_t kTileFloats = (size_t)kBQ * kLd;

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

// First word of Philox-4x32-10 at counter (c0, c1, c2, 0), key (k0, k1).
__device__ __forceinline__ uint32_t philox_bits(uint32_t c0, uint32_t c1,
                                                uint32_t c2, uint32_t k0,
                                                uint32_t k1) {
  uint32_t c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
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
  return c0;
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
  return philox_bits((uint32_t)col, (uint32_t)row, bh, dp.seed_lo,
                     dp.seed_hi) < dp.threshold;
}

}  // namespace sslc
