// Flash-attention forward for Hopper (sm_90a) in bf16: both products on the
// tensor cores (wgmma), K and V fed by TMA through a two-stage ring, with
// optional in-kernel attention dropout.
//
// Replaces, for bf16 inputs, the two Pallas TPU forward kernels of
// speech_ssl_compression_tpu/ops/flash_attention.py: _fa_fwd_kernel (both
// branches, dropout-free and dropout with _tile_keep_mask; launched by
// _flash_fwd_impl) and _fa_fwd_stream_kernel (launched by _flash_fwd_stream
// past T = 4096 and for rectangular q-vs-k attention). f32 inputs go to the
// split-TF32 kernel of flash_attn_fwd_f32_sm90.cu; flash_attn_fwd.cu's
// header states the function both compute: S = scale * (q . k) in f32 with
// the scale after the dot, + bias[key], -1e30 where the segments differ and
// where key > row under causal, -inf for keys past Tk; an online softmax
// over 64-key tiles with each tile's unnormalized p = exp(s - m_new)
// rounded to bf16 before P V; with dropout, l sums every p, P V sees p
// only where the keep bit is set, and O = acc / l / (1 - p); LSE = m +
// log(max(l, 1e-30)). The plain
// version, ops/flash_attention.py::_reference_fwd(..., block_k=64), rounds
// at the same points; exp is expf here, as in the f32 kernel. The
// scores come from another summation order, so a p that lies within their
// rounding of a bf16 rounding point may round the other way:
// ops/flash_attention.py::bf16_forward_straddle_bounds says how far that
// can move an output, and bf16_forward_straddle_flips whether it did.
//
// Design. One warpgroup (128 threads) per block, a block per (64-query
// tile, head, batch). Q is loaded once by TMA; K and V stream in 64-key
// tiles through a ring of two stages, each a TMA load (128-byte swizzle,
// the layout wgmma reads) that completes on the stage's mbarrier, so tile
// t + 1 arrives while tile t is computed. Per key tile:
//   S = Q K^T     wgmma, both operands in shared memory, f32 accumulator;
//   softmax       in registers on the accumulator layout (sm90_common.cuh:
//                 a thread holds 2 rows x 16 keys), the row max and sum
//                 reduced over the four threads of a row by two shuffles;
//   O += P V      P rounded to bf16 into register A fragments, V read
//                 transposed (MN-major) from the same stage.
// Under causal, key tiles above the diagonal are skipped; the element mask
// handles the diagonal tile. TMA fills rows past Tq or Tk with zeros: keys
// past Tk get -inf, never a score of 0, and rows past Tq are not written.
// Dropout: while S is computed, each thread draws the keep bits of 32
// adjacent keys of one query row (keep_word, flash_common.cuh: one Philox
// call for four keys, 128 threads x 32 keys = the 64 x 64 tile) into shared
// memory, and the threads read their scores' bits back: each bit is drawn
// once, outside the softmax's loop.
//
// What bounds it. At the serving shape (8 x 12 heads x 896 x 896 scores,
// d = 64) the two products are 4 d FLOPs per score, ~0.02 ms at 989
// TFLOP/s, and the bytes ~0.01 ms. The per-score scalar work on the CUDA
// cores is the larger part, so the design keeps it short: a key's bias and
// segment id are read from shared memory once for both of a thread's rows;
// only the last key tile and, under causal, the diagonal one test keys
// against Tk and rows; a kernel without segment ids skips their test. Each
// block runs its steps in sequence (product, scalar work, product); the
// 99-128 registers and 43 KB of shared memory of a block let four share an
// SM and overlap them. __expf in place of expf (2^(x log2 e) on the
// special-function unit) held 92-96 registers, five blocks per SM, and was
// 11-22% faster on an H100 with the same share of outputs differing from
// the plain version; it would leave the f32 kernel's function.
// Issuing the next tile's S before this tile's softmax, or P V of the
// previous tile beside this tile's S (FlashAttention-3's order), did not
// pay: the second score buffer and a deeper ring cost blocks per SM, and
// only the 1024 x 5000 shape, with few blocks, got faster.

#include <math.h>

#include "sm90_common.cuh"

namespace sslc {
namespace {

constexpr int kStages = 2;  // K/V ring
// Q, kStages x (K, V); bias and key segment ids per stage; the keep bits
// of one tile (64 rows x 2 words of 32 keys); 1 + kStages mbarriers; 1 KB
// to align the tiles to 1024 bytes.
constexpr size_t kFwdSmemBytes = (1 + 2 * kStages) * (size_t)kTileBytes +
                                 2 * kStages * kTile * 4 + 2 * kTile * 4 +
                                 (1 + kStages) * 8 + 1024;

// kDropout, kSeg: a kernel with and without dropout, with and without
// segment ids, so that each carries only the code its masks need.
template <bool kDropout, bool kSeg>
__global__ void __launch_bounds__(kWgThreads)
flash_attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const float* __restrict__ bias,
                           const int* __restrict__ segq,
                           const int* __restrict__ segk,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int Tq, int Tk,
                           int causal, float scale, Dropout dropout) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);
  uint8_t* s_k = s_q + kTileBytes;            // kStages
  uint8_t* s_v = s_k + kStages * kTileBytes;  // kStages
  float* s_bias = reinterpret_cast<float*>(s_v + kStages * kTileBytes);
  int* s_segk = reinterpret_cast<int*>(s_bias + kStages * kTile);
  uint32_t* s_keep = reinterpret_cast<uint32_t*>(s_segk + kStages * kTile);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_keep + 2 * kTile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  int n_tiles = (Tk + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, q0 / kTile + 1);

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // key tile kt's K and V land in stage kt % kStages
  if (tid == 0) {
    mbar_expect_tx(&bar[0], kTileBytes);
    tma_load_tile(s_q, &tm_q, &bar[0], q0, bh);
    for (int kt = 0; kt < min(kStages, n_tiles); ++kt)
      tma_load_pair(s_k + kt * kTileBytes, &tm_k, s_v + kt * kTileBytes,
                    &tm_v, &bar[1 + kt], kt * kTile, bh);
  }

  // this thread's rows: 16 warp + lane / 4 + 8 i of the tile
  int row[2], seg_r[2];
  float m_r[2], l_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + 16 * warp + (lane >> 2) + 8 * i;
    seg_r[i] = (kSeg && row[i] < Tq) ? segq[(size_t)b * Tq + row[i]] : 0;
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  float s[32], acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = acc[e] = 0.f;
  const uint64_t desc_q = tile_desc(s_q);
  mbar_wait(&bar[0], 0);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    const int stage = kt % kStages;
    const float* tb = s_bias + stage * kTile;
    const int* tseg = s_segk + stage * kTile;
    // this tile's key bias and segment ids (stage `stage` was last read
    // kStages iterations ago, before that iteration's closing barrier)
    {
      const int c = tid & (kTile - 1), key = k0 + c;
      if (tid < kTile) {
        s_bias[stage * kTile + c] = key < Tk ? bias[(size_t)b * Tk + key] : 0.f;
      } else if (kSeg) {
        s_segk[stage * kTile + c] = key < Tk ? segk[(size_t)b * Tk + key] : 0;
      }
    }
    mbar_wait(&bar[1 + stage], (kt / kStages) & 1);
    const uint64_t desc_k = tile_desc(s_k + stage * kTileBytes);
    const uint64_t desc_v = tile_desc(s_v + stage * kTileBytes);
    fence_regs(s);
    wgmma_fence();
    issue_tile_product(s, desc_q, desc_k);  // S = Q K^T
    wgmma_commit();
    if (kDropout) {  // row q0 + tid / 2, keys k0 + 32 (tid % 2) + 0..31
      s_keep[tid] = keep_word(dropout, q0 + (tid >> 1), k0 + 32 * (tid & 1), bh);
    }
    __syncthreads();  // the tile's bias, segment ids and keep bits
    wgmma_wait_all();
    fence_regs(s);

    float mx[2];
    if (k0 + kTile > Tk || (causal && k0 + kTile - 1 > q0)) {
      mask_scores<true, kSeg>(s, mx, tb, tseg, seg_r, causal, row, k0, Tk,
                              t4, scale);
    } else {
      mask_scores<false, kSeg>(s, mx, tb, tseg, seg_r, causal, row, k0, Tk,
                               t4, scale);
    }
    uint32_t p_frag[4][4];
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      // this row's keep bits, shifted so that key 8 c8' + j of the thread's
      // columns (c8' = c8 % 4) is bit 8 c8' + j of words[c8 / 4]
      uint32_t words[2] = {0u, 0u};
      if (kDropout) {
        const int r = row[i] - q0;
        words[0] = s_keep[2 * r] >> (2 * t4);
        words[1] = s_keep[2 * r + 1] >> (2 * t4);
      }
      float sum = 0.f;
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        float pv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = expf(s[4 * c8 + 2 * i + j] - m_new);
          sum += p;
          pv[j] = (!kDropout || ((words[c8 >> 2] >> (8 * (c8 & 3) + j)) & 1u))
                      ? p : 0.f;
        }
        p_frag[c8 >> 1][frag_reg(c8, i)] = pack_bf16(pv[0], pv[1]);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[i] = l_r[i] * alpha[i] + sum;
    }
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * c8 + e] *= alpha[e >> 1];
    }

    // O += P V, V read transposed from the same stage
    fence_regs(acc);
    wgmma_fence();
    issue_reg_product(acc, p_frag, desc_v);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // every thread is done with stage `stage` and s_keep
    if (tid == 0 && kt + kStages < n_tiles)
      tma_load_pair(s_k + stage * kTileBytes, &tm_k, s_v + stage * kTileBytes,
                    &tm_v, &bar[1 + stage], (kt + kStages) * kTile, bh);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Tq) continue;
    const float l_safe = fmaxf(l_r[i], 1e-30f);
    uint32_t* out =
        reinterpret_cast<uint32_t*>(o + ((size_t)bh * Tq + row[i]) * kD);
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int e = 4 * c8 + 2 * i;
      out[4 * c8 + t4] = pack_bf16(acc[e] / l_safe * dropout.scale,
                                   acc[e + 1] / l_safe * dropout.scale);
    }
    if (t4 == 0) lse[(size_t)bh * Tq + row[i]] = m_r[i] + logf(l_safe);
  }
}

}  // namespace

cudaError_t launch_fwd_sm90(const void* q, const void* k, const void* v,
                            const void* bias, const void* segq,
                            const void* segk, void* o, void* lse, int B,
                            int H, int Tq, int Tk, int causal,
                            const Dropout& dropout, cudaStream_t stream) {
  CUtensorMap maps[3];
  cudaError_t err;
  if ((err = make_tile_map(&maps[0], q, Tq, B * H)) != cudaSuccess) return err;
  if ((err = make_tile_map(&maps[1], k, Tk, B * H)) != cudaSuccess) return err;
  if ((err = make_tile_map(&maps[2], v, Tk, B * H)) != cudaSuccess) return err;
  const bool seg = segq != nullptr;
  const auto kernel =
      dropout.on ? (seg ? flash_attn_fwd_bf16_kernel<true, true>
                        : flash_attn_fwd_bf16_kernel<true, false>)
                 : (seg ? flash_attn_fwd_bf16_kernel<false, true>
                        : flash_attn_fwd_bf16_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kFwdSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kWgThreads, kFwdSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(bias),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Tq, Tk,
      causal, 0.125f /* 1/sqrt(64) */, dropout);
  return cudaGetLastError();
}

}  // namespace sslc
