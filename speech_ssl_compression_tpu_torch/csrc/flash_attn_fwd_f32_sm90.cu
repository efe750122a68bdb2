// Flash-attention forward for Hopper (sm_90a) in f32: both products on the
// tensor cores in split TF32 (wgmma), K and V fed by TMA, with optional
// in-kernel attention dropout.
//
// Replaces, for f32 inputs, the two Pallas TPU forward kernels of
// speech_ssl_compression_tpu/ops/flash_attention.py: _fa_fwd_kernel (both
// branches, dropout-free and dropout with _tile_keep_mask; launched by
// _flash_fwd_impl) and _fa_fwd_stream_kernel (launched by _flash_fwd_stream
// past T = 4096 and for rectangular q-vs-k attention). It computes the
// function flash_attn_fwd.cu's header states: S = scale * (q . k) with the
// scale after the dot, + bias[key], -1e30 where the segments differ and
// where key > row under causal, -inf for keys past Tk; an online softmax
// over the key tiles, p = exp(s - m_new) with expf; with dropout, l sums
// every p, P V sees p only where the keep bit is set (the Philox bits of
// flash_common.cuh, ops/dropout.py::attention_keep_bits), and O = acc / l /
// (1 - p); LSE = m + log(max(l, 1e-30)). Its plain version is
// ops/flash_attention.py::_reference_fwd; the checks hold the kernel to it
// run in float64.
//
// Split TF32 (split_tf32.cuh): every product is three TF32 products of hi
// and lo operands, so both products are f32-accurate, and
// torch.backends.cuda.matmul.allow_tf32 does not govern them.
//   S = Q K^T     Q (64 rows) and K (32 keys) are K-major as they lie: TMA
//                 brings raw f32 boxes, the split pass writes hi in place
//                 and lo beside; 24 m64n32k8 products into one accumulator.
//   O += P V      P as register A fragments, split in registers (split_reg,
//                 frag_idx); V^T hi and lo written by the split pass in
//                 perm_col order (V itself is MN-major for this product,
//                 which TF32 wgmma refuses); 12 m64n64k8 products.
//   The tensor cores truncate what they add into an accumulator, so each key
//   tile's P V goes into a fresh accumulator and joins the running O by the
//   online-softmax rescale, acc = alpha acc + tile, one f32 fma rounded to
//   nearest: no accumulator takes more than one tile's 96 terms.
//
// Design. One warpgroup (128 threads) per block, a block per (64-query
// tile, head, batch), three blocks per SM (73.5 KB of shared memory and at
// most 170 registers a thread each), so that the blocks' split passes and
// softmaxes overlap each other's products. Q is loaded once by TMA and
// split; K and V stream in 32-key tiles through one stage. Per key tile:
// the split pass (K hi in place and K lo; V^T hi and lo, into buffers of
// their own), S on the tensor cores while each thread draws the tile's
// keep bits (one Philox call for four keys, keep_bits16: 128 threads x 16
// keys = 64 rows x 32 keys, each bit drawn once); once S is done the raw
// tile is free, and the next tile's TMA load runs during this tile's masks
// and online softmax in registers on the accumulator layout (mask_scores:
// a key's bias and segment id read once for both of a thread's rows; only
// the last key tile and, under causal, the tiles at the diagonal test keys
// against Tk and rows), then P V. Under causal, key tiles above the
// diagonal are skipped. TMA fills rows past Tq or Tk with zeros: keys past
// Tk get -inf, and rows past Tq are not written.
//   Two stages and two blocks per SM (90 KB each) took 0.43-0.47 ms at the
// serving shape on one H100; one stage and three blocks 0.35 ms
// (tools/torch_split_timing.py, PERF.md).
//
// Where the split happens. At the serving shape each K and V tile is read
// by Tq / 64 = 14 query-tile blocks, which split it 14 times. A pre-pass
// writing K hi and lo and V^T hi and lo to device memory once would save
// that work, at 4x K and V's bytes written (~90 MB at serving) and every
// block then reading twice the bytes of the raw tiles from L2 (~1.2 GB
// against ~0.6 GB at serving): this kernel splits in shared memory.
//
// What bounds it. At the serving shape (8 x 12 heads x 896 x 896 scores,
// d = 64) the two products are 4 d FLOPs per score, 3 x that in TF32:
// ~0.12 ms at 495 TFLOP/s; the bytes ~0.01 ms. As for the bf16 forward,
// the per-score scalar work (masks, expf, the split of P) and here also
// the split pass run on the CUDA cores beside the products.

#include <math.h>

#include "split_tf32.cuh"

namespace sslc {
namespace {

// Q hi and lo; the K and V tile raw (K hi after the split); K lo; V^T hi
// and lo; the tile's key bias and segment ids; its keep bits (64 rows x 2
// halves of 16 keys); two mbarriers; 1 KB to align the tiles to 1024 bytes:
// 73.5 KB, three blocks per SM.
constexpr size_t kFwdF32SmemBytes =
    2 * (size_t)kResBytes + 2 * (size_t)kNBytes + kNBytes + 2 * kTBytes +
    2 * kN * 4 + kTile * 2 * 2 + 2 * 8 + 1024;

// kDropout, kSeg: a kernel with and without dropout, with and without
// segment ids, so that each carries only the code its masks need.
template <bool kDropout, bool kSeg>
__global__ void __launch_bounds__(kWgThreads, 3)
flash_attn_fwd_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ bias,
                          const int* __restrict__ segq,
                          const int* __restrict__ segk,
                          float* __restrict__ o, float* __restrict__ lse,
                          int H, int Tq, int Tk, int causal, float scale,
                          Dropout dropout) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);  // Q, hi after the split
  uint8_t* s_q_lo = s_q + kResBytes;
  uint8_t* s_k = s_q_lo + kResBytes;  // raw, hi after the split
  uint8_t* s_v = s_k + kNBytes;       // raw
  uint8_t* s_k_lo = s_v + kNBytes;
  uint8_t* s_vt = s_k_lo + kNBytes;  // V^T hi, then lo
  uint8_t* s_vt_lo = s_vt + kTBytes;
  float* s_bias = reinterpret_cast<float*>(s_vt_lo + kTBytes);
  int* s_segk = reinterpret_cast<int*>(s_bias + kN);
  uint16_t* s_keep = reinterpret_cast<uint16_t*>(s_segk + kN);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_keep + 2 * kTile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  int n_tiles = (Tk + kN - 1) / kN;
  if (causal) n_tiles = min(n_tiles, (q0 + kTile) / kN);

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Q on bar[0]; key tile kt's K and V on bar[1], phase kt % 2
  if (tid == 0) {
    mbar_expect_tx(&bar[0], kResBytes);
    tma_load_3d(s_q, &tm_q, &bar[0], 0, q0, bh);
    tma_load_3d(s_q + kResBox, &tm_q, &bar[0], 32, q0, bh);
    tma_load_rows<kN>(s_k, &tm_k, s_v, &tm_v, &bar[1], 0, bh);
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
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  const uint64_t desc_q = tile_desc(s_q), desc_q_lo = tile_desc(s_q_lo);
  const uint64_t desc_k = tile_desc(s_k), desc_k_lo = tile_desc(s_k_lo);
  const uint64_t desc_vt = tile_desc(s_vt), desc_vt_lo = tile_desc(s_vt_lo);
  mbar_wait(&bar[0], 0);
  // Q's split is fenced and synchronised with the first tile's
  split_tile<kTile, kWgThreads, false>(s_q, s_q_lo, nullptr, nullptr, tid);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kN;
    // this tile's key bias and segment ids (the last tile's readers passed
    // its closing barrier)
    {
      const int c = tid & (kN - 1), key = k0 + c;
      if (tid < kN) {
        s_bias[c] = key < Tk ? bias[(size_t)b * Tk + key] : 0.f;
      } else if (kSeg && tid < 2 * kN) {
        s_segk[c] = key < Tk ? segk[(size_t)b * Tk + key] : 0;
      }
    }
    mbar_wait(&bar[1], kt & 1);
    split_tile<kN, kWgThreads, false>(s_k, s_k_lo, nullptr, nullptr, tid);
    split_tile<kN, kWgThreads, true, false>(s_v, nullptr, s_vt, s_vt_lo, tid);
    fence_proxy_async();
    __syncthreads();  // every split of this tile is written

    float s[kN / 2];
    fence_regs(s);
    wgmma_fence();
    issue_split_product(s, desc_q, desc_q_lo, desc_k, desc_k_lo);
    wgmma_commit();
    if (kDropout) {  // row q0 + tid / 2, keys k0 + 16 (tid % 2) + 0..15
      s_keep[tid] = (uint16_t)keep_bits16(dropout, q0 + (tid >> 1),
                                          k0 + 16 * (tid & 1), bh);
    }
    wgmma_wait_all();
    fence_regs(s);
    // the tile's bias, segment ids and keep bits are written, and every
    // warp's S products are done with the raw K and V: the next tile's
    // load overlaps this tile's softmax and P V
    __syncthreads();
    if (tid == 0 && kt + 1 < n_tiles)
      tma_load_rows<kN>(s_k, &tm_k, s_v, &tm_v, &bar[1], k0 + kN, bh);

    float mx[2];
    if (k0 + kN > Tk || (causal && k0 + kN - 1 > q0)) {
      mask_scores<true, kSeg>(s, mx, s_bias, s_segk, seg_r, causal, row, k0,
                              Tk, t4, scale);
    } else {
      mask_scores<false, kSeg>(s, mx, s_bias, s_segk, seg_r, causal, row, k0,
                               Tk, t4, scale);
    }
    uint32_t p_hi[kN / 8][4], p_lo[kN / 8][4];
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      // this row's keep bits, bit c for key k0 + c
      uint32_t bits = 0u;
      if (kDropout) {
        const int r = row[i] - q0;
        bits = (uint32_t)s_keep[2 * r] | ((uint32_t)s_keep[2 * r + 1] << 16);
      }
      float sum = 0.f;
#pragma unroll
      for (int c8 = 0; c8 < kN / 8; ++c8) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = expf(s[4 * c8 + 2 * i + j] - m_new);
          sum += p;
          const float pv =
              (!kDropout || ((bits >> (8 * c8 + 2 * t4 + j)) & 1u)) ? p : 0.f;
          split_reg(pv, p_hi[c8][frag_idx(i, j)], p_lo[c8][frag_idx(i, j)]);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[i] = l_r[i] * alpha[i] + sum;
    }

    // this tile's P V into a fresh accumulator, then O = alpha O + P V
    float c[32];
    fence_regs(c);
    wgmma_fence();
    issue_split_reg_product<kN / 8>(c, p_hi, p_lo, desc_vt, desc_vt_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(c);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      acc[e] = fmaf(alpha[(e >> 1) & 1], acc[e], c[e]);
    __syncthreads();  // every thread is done with the splits, the bias,
                      // the segment ids and the keep bits
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Tq) continue;
    const float l_safe = fmaxf(l_r[i], 1e-30f);
    float* out = o + ((size_t)bh * Tq + row[i]) * kD;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int e = 4 * c8 + 2 * i;
      *reinterpret_cast<float2*>(out + 8 * c8 + 2 * t4) =
          make_float2(acc[e] / l_safe * dropout.scale,
                      acc[e + 1] / l_safe * dropout.scale);
    }
    if (t4 == 0) lse[(size_t)bh * Tq + row[i]] = m_r[i] + logf(l_safe);
  }
}

}  // namespace

cudaError_t launch_fwd_f32_sm90(const void* q, const void* k, const void* v,
                                const void* bias, const void* segq,
                                const void* segk, void* o, void* lse, int B,
                                int H, int Tq, int Tk, int causal,
                                const Dropout& dropout, cudaStream_t stream) {
  CUtensorMap maps[3];
  cudaError_t err;
  if ((err = make_f32_map(&maps[0], q, Tq, B * H, kTile)) != cudaSuccess)
    return err;
  if ((err = make_f32_map(&maps[1], k, Tk, B * H, kN)) != cudaSuccess)
    return err;
  if ((err = make_f32_map(&maps[2], v, Tk, B * H, kN)) != cudaSuccess)
    return err;
  const bool seg = segq != nullptr;
  const auto kernel =
      dropout.on ? (seg ? flash_attn_fwd_f32_kernel<true, true>
                        : flash_attn_fwd_f32_kernel<true, false>)
                 : (seg ? flash_attn_fwd_f32_kernel<false, true>
                        : flash_attn_fwd_f32_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kFwdF32SmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kWgThreads, kFwdF32SmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(bias),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<float*>(o), static_cast<float*>(lse), H, Tq, Tk, causal,
      0.125f /* 1/sqrt(64) */, dropout);
  return cudaGetLastError();
}

}  // namespace sslc
