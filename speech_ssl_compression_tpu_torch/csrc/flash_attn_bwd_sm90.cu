// Flash-attention backward for Hopper (sm_90a) in bf16: the dQ and dK/dV
// kernels on the tensor cores (wgmma), fed by TMA through a two-stage ring.
//
// Replaces, for bf16 inputs, the four Pallas TPU backward kernels of
// speech_ssl_compression_tpu/ops/flash_attention.py: _fa_bwd_dq_kernel and
// _fa_bwd_dkv_kernel (launched by _flash_bwd_impl) and their streamed
// versions _fa_bwd_dq_stream_kernel and _fa_bwd_dkv_stream_kernel (launched
// by _flash_bwd_stream). f32 inputs go to the split-TF32 kernels of
// flash_attn_bwd_f32_sm90.cu; flash_attn_bwd.cu's header states the
// arithmetic both routes share:
// S = scale * (q . k) with the forward's masks, P = exp(S - LSE),
// Pd = P o M / (1 - p), dPd = dO . V^T, dS = Pd o dPd - P o D, dS and Pd
// rounded to bf16 before their products, f32 accumulation, the scale on the
// f32 accumulators at the end, and D = rowsum(Pd o dPd) / rowsum(P) computed
// by the dQ kernel from its own P and written for the dK/dV kernel.
//
// Design. One warpgroup (128 threads) per block; two kernels, no atomics, so
// the same inputs give the same bits.
//   dQ: a block per (64-query tile, head, batch). Q and dO are loaded once;
//   K and V stream in 64-key tiles through a ring of two stages, each a TMA
//   load (128-byte swizzle, the layout wgmma reads) that completes on the
//   stage's mbarrier, so tile t + 1 arrives while tile t is computed. A
//   first pass over the key tiles computes S = Q K^T and dPd = dO V^T
//   (wgmma, both operands in shared memory) and the two row sums of D; a
//   second pass computes them again with the same instructions (so both
//   passes see bit-identical P), forms dS in registers, rounds it to bf16
//   and adds dS K into the f32 accumulator with wgmma, A from registers and
//   K read transposed (MN-major) from the same shared tile.
//   dK/dV: a block per (64-key tile, head, batch). K and V are loaded once;
//   Q, dO stream in 64-query tiles through the same kind of ring, and LSE,
//   D and the query segment ids beside them. It computes S^T = K Q^T and
//   dPd^T = V dO^T, so dS^T and Pd^T come out in the accumulator layout,
//   rows = keys, which is the layout of wgmma's A operand in registers:
//   dV += Pd^T dO and dK += dS^T Q take them from registers and read dO
//   and Q transposed from shared memory. Neither dS nor Pd goes through
//   shared or device memory.
//   Dropout: each thread draws the keep bits of 32 adjacent keys of one
//   query row (keep_word, flash_common.cuh) into shared memory, and the
//   threads read their scores' bits back. The dQ kernel keeps the bits of
//   its 64 rows for every key tile from its D pass (64 x Tk / 8 bytes, 6 KB
//   at Tk = 768, 32 KB at the dropout cap Tk = 4096) and its dQ pass reads
//   them, so each kernel draws each score's bit once.
//
// Padding. TMA fills rows past Tq or Tk with zeros; such rows and keys get
// P = Pd = 0, so they add nothing and their outputs are not written. Under
// causal, key tiles above the diagonal are skipped (dQ) and query tiles
// above it are skipped (dK/dV); the element mask handles the diagonal tile.
//
// What bounds it. At the training shape (4, 12, 768, 64) the products are
// 6 d (dQ) and 8 d (dK/dV) FLOPs per (query, key) pair: ~0.01 ms each at
// 989 TFLOP/s, and the bytes (~24-29 MB) ~0.008 ms. Measured on one H100
// SXM at 700 W (tools/torch_attention_timing.py, chip_smoke.py): dQ 0.22
// ms without dropout and 0.27-0.28 ms with p = 0.1, dK/dV 0.12 and 0.14-
// 0.15 ms, ~20x the bound. Neither the tensor cores nor the bytes set that
// pace: the per-score scalar work on the CUDA cores does (the masks, expf,
// dS, the bf16 packing; dQ does it twice, in the D pass and the dQ pass),
// with each block's steps in sequence (products, then scalar work, then
// the next products) and three blocks per SM to overlap them. The dropout
// draws are the rest: Philox-4x32-10, ~70-100 integer instructions a call.
// The design draws each keep bit once per kernel, one call for four keys
// (keep_word), which took dQ from 0.34 to 0.28 ms and dK/dV from 0.21 to
// 0.15 ms against one draw per score in each of the three passes. A fourth
// block per SM (<= 128 registers, no alignment slack) did not make dQ
// faster. dS is rounded as the plain version rounds it, (Pd dPd) - (P D)
// with each product rounded, not contracted into one fma.

#include <math.h>

#include "sm90_common.cuh"

namespace sslc {
namespace {

constexpr uint32_t kKeepTileWords = kTile * 2;  // 64 rows x 2 words of 32 keys
// Q, dO, 2 x K, 2 x V (dQ) or K, V, 2 x Q, 2 x dO (dK/dV); 3 f32 or int
// arrays of 2 x 64; 3 mbarriers; 1 KB to align the tiles to 1024 bytes.
constexpr size_t kFixedSmemBytes =
    6 * (size_t)kTileBytes + 3 * 2 * kTile * 4 + 4 * 8 + 1024;

__global__ void __launch_bounds__(kWgThreads)
flash_attn_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ bias,
                              const int* __restrict__ segq,
                              const int* __restrict__ segk,
                              const float* __restrict__ lse,
                              float* __restrict__ dd,
                              __nv_bfloat16* __restrict__ dq, int H, int Tq,
                              int Tk, int causal, float scale,
                              Dropout dropout) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);
  uint8_t* s_do = s_q + kTileBytes;
  uint8_t* s_k = s_do + kTileBytes;       // 2 stages
  uint8_t* s_v = s_k + 2 * kTileBytes;    // 2 stages
  float* s_bias = reinterpret_cast<float*>(s_v + 2 * kTileBytes);  // [2][64]
  int* s_segk = reinterpret_cast<int*>(s_bias + 2 * kTile);         // [2][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_segk + 2 * kTile);  // 3
  uint32_t* s_keep = reinterpret_cast<uint32_t*>(bar + 4);  // [tiles][128]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const bool use_seg = segq != nullptr;
  int n_tiles = (Tk + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, q0 / kTile + 1);
  const int n_iters = 2 * n_tiles;  // the D pass, then the dQ pass

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // iteration it reads K and V of key tile it % n_tiles from stage it % 2
  if (tid == 0) {
    tma_load_pair(s_q, &tm_q, s_do, &tm_do, &bar[0], q0, bh);
    for (int it = 0; it < 2; ++it)
      tma_load_pair(s_k + it * kTileBytes, &tm_k, s_v + it * kTileBytes,
                    &tm_v, &bar[1 + it], (it % n_tiles) * kTile, bh);
  }

  int row[2], seg_r[2];
  bool row_ok[2];
  float lse_r[2], l_r[2], dd_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + 16 * warp + (lane >> 2) + 8 * i;
    row_ok[i] = row[i] < Tq;
    lse_r[i] = row_ok[i] ? lse[(size_t)bh * Tq + row[i]] : 0.f;
    seg_r[i] = (use_seg && row_ok[i]) ? segq[(size_t)b * Tq + row[i]] : 0;
    l_r[i] = dd_r[i] = 0.f;
  }
  float s[32], dpd[32], acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dpd[e] = acc[e] = 0.f;
  const uint64_t desc_q = tile_desc(s_q), desc_do = tile_desc(s_do);
  mbar_wait(&bar[0], 0);

  for (int it = 0; it < n_iters; ++it) {
    const bool d_pass = it < n_tiles;
    const int kt = d_pass ? it : it - n_tiles;
    const int k0 = kt * kTile;
    const int stage = it & 1;
    const float* tb = s_bias + stage * kTile;
    const int* tseg = s_segk + stage * kTile;
    // this tile's key bias and segment ids (stage `stage` was last read
    // two iterations ago, before that iteration's closing barrier)
    {
      const int c = tid & (kTile - 1), key = k0 + c;
      if (tid < kTile) {
        s_bias[stage * kTile + c] = key < Tk ? bias[(size_t)b * Tk + key] : 0.f;
      } else if (use_seg) {
        s_segk[stage * kTile + c] = key < Tk ? segk[(size_t)b * Tk + key] : 0;
      }
    }
    mbar_wait(&bar[1 + stage], (it >> 1) & 1);
    const uint64_t desc_k = tile_desc(s_k + stage * kTileBytes);
    const uint64_t desc_v = tile_desc(s_v + stage * kTileBytes);
    fence_regs(s);
    fence_regs(dpd);
    wgmma_fence();
    issue_tile_product(s, desc_q, desc_k);      // S = Q K^T
    issue_tile_product(dpd, desc_do, desc_v);   // dPd = dO V^T
    wgmma_commit();
    uint32_t* keep_bits = s_keep + kt * kKeepTileWords;
    if (d_pass && dropout.on) {  // row tid / 2, keys 32 (tid % 2) + 0..31
      keep_bits[tid] =
          keep_word(dropout, q0 + (tid >> 1), k0 + 32 * (tid & 1), bh);
    }
    __syncthreads();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dpd);

    uint32_t ds_frag[4][4];
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * c8 + 2 * t4 + j;
          const int e = 4 * c8 + 2 * i + j;
          const int key = k0 + c;
          float p = 0.f, pd = 0.f;
          if (row_ok[i] && key < Tk) {
            float x = fmaf(s[e], scale, tb[c]);
            if (use_seg && seg_r[i] != tseg[c]) x = kNegInf;
            if (causal && key > row[i]) x = kNegInf;
            p = expf(x - lse_r[i]);
            pd = p;
            if (dropout.on) {
              const uint32_t w =
                  keep_bits[2 * (row[i] - q0) + (c >> 5)];
              pd = ((w >> (c & 31)) & 1u) ? p * dropout.scale : 0.f;
            }
          }
          if (d_pass) {
            l_r[i] += p;
            dd_r[i] = fmaf(pd, dpd[e], dd_r[i]);
            ds[j] = 0.f;
          } else {
            ds[j] = __fsub_rn(__fmul_rn(pd, dpd[e]), __fmul_rn(p, dd_r[i]));
          }
        }
        ds_frag[c8 >> 1][frag_reg(c8, i)] = pack_bf16(ds[0], ds[1]);
      }
    }

    if (!d_pass) {  // dQ += dS K, K read transposed from the same stage
      fence_regs(acc);
      wgmma_fence();
      issue_reg_product(acc, ds_frag, desc_k);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    } else if (it == n_tiles - 1) {  // D = rowsum(Pd o dPd) / rowsum(P)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], off);
          dd_r[i] += __shfl_xor_sync(0xffffffffu, dd_r[i], off);
        }
        dd_r[i] = l_r[i] > 0.f ? dd_r[i] / l_r[i] : 0.f;
        if (t4 == 0 && row_ok[i]) dd[(size_t)bh * Tq + row[i]] = dd_r[i];
      }
    }
    __syncthreads();  // every thread is done with stage `stage`
    if (tid == 0 && it + 2 < n_iters)
      tma_load_pair(s_k + stage * kTileBytes, &tm_k, s_v + stage * kTileBytes,
                    &tm_v, &bar[1 + stage], ((it + 2) % n_tiles) * kTile, bh);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dq + ((size_t)bh * Tq + row[i]) * kD);
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int e = 4 * c8 + 2 * i;
      out[4 * c8 + t4] = pack_bf16(scale * acc[e], scale * acc[e + 1]);
    }
  }
}

__global__ void __launch_bounds__(kWgThreads)
flash_attn_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ bias,
                               const int* __restrict__ segq,
                               const int* __restrict__ segk,
                               const float* __restrict__ lse,
                               const float* __restrict__ dd,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H, int Tq,
                               int Tk, int causal, float scale,
                               Dropout dropout) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_k = align_1024(smem_raw);
  uint8_t* s_v = s_k + kTileBytes;
  uint8_t* s_q = s_v + kTileBytes;        // 2 stages
  uint8_t* s_do = s_q + 2 * kTileBytes;   // 2 stages
  float* s_lse = reinterpret_cast<float*>(s_do + 2 * kTileBytes);  // [2][64]
  float* s_dd = s_lse + 2 * kTile;                                  // [2][64]
  int* s_segq = reinterpret_cast<int*>(s_dd + 2 * kTile);           // [2][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_segq + 2 * kTile);  // 3
  uint32_t* s_keep = reinterpret_cast<uint32_t*>(bar + 4);          // [128]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const bool use_seg = segq != nullptr;
  const int q_first = causal ? k0 / kTile : 0;
  const int n_iters = (Tq + kTile - 1) / kTile - q_first;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // iteration it reads Q and dO of query tile q_first + it from stage it % 2
  if (tid == 0) {
    tma_load_pair(s_k, &tm_k, s_v, &tm_v, &bar[0], k0, bh);
    for (int it = 0; it < min(2, n_iters); ++it)
      tma_load_pair(s_q + it * kTileBytes, &tm_q, s_do + it * kTileBytes,
                    &tm_do, &bar[1 + it], (q_first + it) * kTile, bh);
  }

  // this thread's keys: rows 16 warp + lane / 4 + 8 i of S^T
  int key[2], kr[2], segk_r[2];
  bool key_ok[2];
  float bias_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kr[i] = 16 * warp + (lane >> 2) + 8 * i;
    key[i] = k0 + kr[i];
    key_ok[i] = key[i] < Tk;
    bias_r[i] = key_ok[i] ? bias[(size_t)b * Tk + key[i]] : 0.f;
    segk_r[i] = (use_seg && key_ok[i]) ? segk[(size_t)b * Tk + key[i]] : 0;
  }
  float st[32], dpdt[32], dk_acc[32], dv_acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = dpdt[e] = dk_acc[e] = dv_acc[e] = 0.f;
  const uint64_t desc_k = tile_desc(s_k), desc_v = tile_desc(s_v);
  mbar_wait(&bar[0], 0);

  for (int it = 0; it < n_iters; ++it) {
    const int q0 = (q_first + it) * kTile;
    const int stage = it & 1;
    const float* t_lse = s_lse + stage * kTile;
    const float* t_dd = s_dd + stage * kTile;
    const int* t_seg = s_segq + stage * kTile;
    {  // this tile's LSE, D and query segment ids
      const int c = tid & (kTile - 1), qr = q0 + c;
      const bool ok = qr < Tq;
      if (tid < kTile) {
        s_lse[stage * kTile + c] = ok ? lse[(size_t)bh * Tq + qr] : 0.f;
        s_dd[stage * kTile + c] = ok ? dd[(size_t)bh * Tq + qr] : 0.f;
      } else if (use_seg) {
        s_segq[stage * kTile + c] = ok ? segq[(size_t)b * Tq + qr] : 0;
      }
    }
    mbar_wait(&bar[1 + stage], (it >> 1) & 1);
    const uint64_t desc_qt = tile_desc(s_q + stage * kTileBytes);
    const uint64_t desc_dot = tile_desc(s_do + stage * kTileBytes);
    fence_regs(st);
    fence_regs(dpdt);
    wgmma_fence();
    issue_tile_product(st, desc_k, desc_qt);     // S^T = K Q^T
    issue_tile_product(dpdt, desc_v, desc_dot);  // dPd^T = V dO^T
    wgmma_commit();
    if (dropout.on) {  // query row q0 + tid / 2, keys k0 + 32 (tid % 2) + ..
      s_keep[tid] = keep_word(dropout, q0 + (tid >> 1), k0 + 32 * (tid & 1), bh);
    }
    __syncthreads();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpdt);

    uint32_t pd_frag[4][4], ds_frag[4][4];
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float pdv[2], ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * c8 + 2 * t4 + j;  // query q0 + c
          const int e = 4 * c8 + 2 * i + j;
          const int qr = q0 + c;
          float p = 0.f, pd = 0.f;
          if (key_ok[i] && qr < Tq) {
            float x = fmaf(st[e], scale, bias_r[i]);
            if (use_seg && t_seg[c] != segk_r[i]) x = kNegInf;
            if (causal && key[i] > qr) x = kNegInf;
            p = expf(x - t_lse[c]);
            pd = p;
            if (dropout.on) {
              const uint32_t w = s_keep[2 * c + (kr[i] >> 5)];
              pd = ((w >> (kr[i] & 31)) & 1u) ? p * dropout.scale : 0.f;
            }
          }
          pdv[j] = pd;
          ds[j] = __fsub_rn(__fmul_rn(pd, dpdt[e]), __fmul_rn(p, t_dd[c]));
        }
        pd_frag[c8 >> 1][frag_reg(c8, i)] = pack_bf16(pdv[0], pdv[1]);
        ds_frag[c8 >> 1][frag_reg(c8, i)] = pack_bf16(ds[0], ds[1]);
      }
    }

    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    issue_reg_product(dv_acc, pd_frag, desc_dot);  // dV += Pd^T dO
    issue_reg_product(dk_acc, ds_frag, desc_qt);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // every thread is done with stage `stage` and s_keep
    if (tid == 0 && it + 2 < n_iters)
      tma_load_pair(s_q + stage * kTileBytes, &tm_q, s_do + stage * kTileBytes,
                    &tm_do, &bar[1 + stage], q0 + 2 * kTile, bh);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!key_ok[i]) continue;
    const size_t off = ((size_t)bh * Tk + key[i]) * kD;
    uint32_t* out_k = reinterpret_cast<uint32_t*>(dk + off);
    uint32_t* out_v = reinterpret_cast<uint32_t*>(dv + off);
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int e = 4 * c8 + 2 * i;
      out_k[4 * c8 + t4] = pack_bf16(scale * dk_acc[e], scale * dk_acc[e + 1]);
      out_v[4 * c8 + t4] = pack_bf16(dv_acc[e], dv_acc[e + 1]);
    }
  }
}

cudaError_t make_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
                      const void* v, const void* dout, int BH, int Tq,
                      int Tk) {
  cudaError_t err;
  if ((err = make_tile_map(&maps[0], q, Tq, BH)) != cudaSuccess) return err;
  if ((err = make_tile_map(&maps[1], k, Tk, BH)) != cudaSuccess) return err;
  if ((err = make_tile_map(&maps[2], v, Tk, BH)) != cudaSuccess) return err;
  return make_tile_map(&maps[3], dout, Tq, BH);
}

}  // namespace

cudaError_t launch_bwd_dq_sm90(const void* q, const void* k, const void* v,
                               const void* bias, const void* segq,
                               const void* segk, const void* dout,
                               const void* lse, void* dd, void* dq, int B,
                               int H, int Tq, int Tk, int causal,
                               const Dropout& dropout, cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err = make_maps(maps, q, k, v, dout, B * H, Tq, Tk);
  if (err != cudaSuccess) return err;
  // the D pass's keep bits of every key tile, for the dQ pass
  const size_t keep_bytes =
      dropout.on ? (size_t)((Tk + kTile - 1) / kTile) * kKeepTileWords * 4 : 0;
  const size_t smem = kFixedSmemBytes + keep_bytes;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_attn_bwd_dq_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kTile - 1) / kTile, H, B);
  flash_attn_bwd_dq_bf16_kernel<<<grid, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const float*>(lse), static_cast<float*>(dd),
      static_cast<__nv_bfloat16*>(dq), H, Tq, Tk, causal,
      0.125f /* 1/sqrt(64) */, dropout);
  return cudaGetLastError();
}

cudaError_t launch_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                const void* bias, const void* segq,
                                const void* segk, const void* dout,
                                const void* lse, const void* dd, void* dk,
                                void* dv, int B, int H, int Tq, int Tk,
                                int causal, const Dropout& dropout,
                                cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err = make_maps(maps, q, k, v, dout, B * H, Tq, Tk);
  if (err != cudaSuccess) return err;
  const size_t smem = kFixedSmemBytes + (size_t)kKeepTileWords * 4;
  err = cudaFuncSetAttribute(flash_attn_bwd_dkv_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + kTile - 1) / kTile, H, B);
  flash_attn_bwd_dkv_bf16_kernel<<<grid, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
      Tq, Tk, causal, 0.125f /* 1/sqrt(64) */, dropout);
  return cudaGetLastError();
}

}  // namespace sslc
