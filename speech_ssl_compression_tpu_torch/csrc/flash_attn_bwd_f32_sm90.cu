// Flash-attention backward for Hopper (sm_90a) in f32: the dQ and dK/dV
// kernels on the tensor cores in split TF32 (wgmma), fed by TMA through a
// two-stage ring.
//
// Replaces, for f32 inputs, the four Pallas TPU backward kernels of
// speech_ssl_compression_tpu/ops/flash_attention.py: _fa_bwd_dq_kernel and
// _fa_bwd_dkv_kernel (launched by _flash_bwd_impl) and their streamed
// versions _fa_bwd_dq_stream_kernel and _fa_bwd_dkv_stream_kernel (launched
// by _flash_bwd_stream), for every Tq and Tk. The function is the one
// flash_attn_bwd.cu's header states: S = scale * (q . k) with the
// forward's masks, P = exp(S - LSE), Pd = P o M / (1 - p), dPd = dO . V^T,
// dS = Pd o dPd - P o D, dQ = scale * dS K, dK = scale * dS^T Q,
// dV = Pd^T dO, f32 accumulation, the scale on the accumulators at the
// end, and D = rowsum(Pd o dPd) / rowsum(P) computed by the dQ kernel from
// its own P and written for the dK/dV kernel.
//
// Split TF32 (split_tf32.cuh says how: hi and lo of every operand, three
// TF32 products per f32 product, the transposed copies in perm_col order
// where a product sums over a tile's rows). Here the split pass transposes
// K (dQ = dS K reads K^T), Q and dO (dK = dS^T Q, dV = Pd^T dO); dS and Pd
// stay in registers as A fragments. torch.backends.cuda.matmul.allow_tf32
// does not govern these kernels: their products are f32-accurate. They
// are not rounded where the f32 plain version's products are, though, and
// that version lies up to ~2e-4 (max |d| / mean |ref|) from the exact
// function at a causal T = 1024, where key 0's gradients are ~90 times
// their mean: the checks hold these kernels to the plain version run in
// float64 (within 5e-5 at every case, on one H100).
//
// Design. Two kernels, no atomics, so the same inputs give the same bits.
// A block holds two consumer warpgroups (256 threads) that take alternate
// streamed tiles of 32 rows, each with its own two-stage TMA ring, split
// buffers and accumulators: while one runs its products, the other does
// its split pass and scalar work. Their sums meet at the end, added in a
// fixed order.
//   dQ: a block per (64-query tile, head, batch). Q and dO arrive once and
//   are split; K and V stream in 32-key tiles. A first pass over the key
//   tiles computes S = Q K^T and dPd = dO V^T (24 m64n32k8 products each)
//   and the two row sums of D, which the warpgroups then add; a second
//   pass computes S and dPd again with the same instructions (so both
//   passes see bit-identical P), forms dS in registers, splits it and
//   computes the tile's dS K with A from registers and K^T from shared
//   memory.
//   dK/dV: a block per (64-key tile, head, batch). K and V arrive once and
//   are split; Q and dO stream in 32-query tiles, with LSE, D and the query
//   segment ids beside them. It computes S^T = K Q^T and dPd^T = V dO^T,
//   so dS^T and Pd^T come out with rows = keys, the rows of wgmma's A
//   operand: the tile's Pd^T dO and dS^T Q take them from registers and
//   read dO^T and Q^T.
//   Sums over the streamed tiles: the tensor cores add into an f32
//   accumulator with truncation, a bias that grows with the number of
//   additions into one accumulator (1.4e-4 at 768 keys, 6e-4 at 5000,
//   against the plain version, when one accumulator took every tile). So
//   each tile's dQ, dK and dV product goes into a fresh accumulator, and
//   that is added to the running sum with f32 adds rounded to nearest.
//   D's two row sums: a thread sums its 8 keys of a tile, and adds that to
//   its running sums compensated (Kahan). Summed term by term (1024 terms
//   a thread at Tk = 8192) D kept ~2.5e-7 of its own size, and where a
//   row's dS K cancels dQ takes D's error times scale |P K| / |dQ|: at
//   T = 8192, on the last layer of a distilled 6-layer student,
//   chip_smoke.py's long phase measured dQ 1.04e-4 (max |d| / mean |ref|)
//   from float64, past the 1e-4 bar, and 3.97e-5 with the compensated sum
//   (one H100 at 700 W), no slower at 768 or 5000 keys.
//   Dropout: each keep bit is drawn once per kernel, one Philox call for
//   four keys (keep_bits16: a thread draws 16 keys of one row), into a
//   bitmask in shared memory. The dQ kernel keeps the bits of its 64 rows
//   for every key tile from its D pass for its dQ pass; the dK/dV kernel
//   draws each query tile's. The draws overlap the score products.
//
// Shared memory (bytes; 1 KB more to align the tiles to 1024):
//   dQ: Q, dO hi and lo 4 x 16 K; per warpgroup the K, V ring 2 x 2 x 8 K
//   (hi after the split, in place), K, V lo 2 x 8 K and K^T hi and lo
//   2 x 8 K; 192 K in all, the key bias and segment ids 0.5 K, and the
//   keep bits 64 x Tk / 8 (6 K at Tk = 768, 32 K at the dropout cap
//   Tk = 4096): <= 225.1 K of 227 K.
//   dK/dV: K, V hi and lo 4 x 16 K; per warpgroup the Q, dO ring
//   2 x 2 x 8 K, Q, dO lo 2 x 8 K and Q^T, dO^T hi and lo 4 x 8 K; 224 K in
//   all, LSE, D, segment ids and keep bits 1.25 K: 226.3 K.
// One block per SM, eight warps.
//
// What bounds it. At the training shape (4, 12, 768, 64) the split TF32
// products are 3 x 6 d (dQ, its D pass included: 3 x 10 d) and 3 x 8 d
// (dK/dV) TF32 FLOPs per (query, key) pair, ~0.11 and ~0.09 ms at
// 495 TFLOP/s; as f32-accurate work, 165 TFLOP/s (495 / 3) is the
// yardstick (chip_smoke.py's f32 peak). The bytes (~40-50 MB) take
// ~0.014 ms. Measured on one H100 at 700 W, with dropout 0.1: dQ 0.62 ms,
// dK/dV 0.36 ms, against 0.91 and 0.68 on the CUDA cores. With one
// warpgroup per block they took 0.95 and 0.61 ms, and cutting parts out
// showed what paced them: not the products (~10-15% each) but the work
// around them in sequence on four warps, the per-score scalar work (masks,
// expf, dS, the splits of dS and Pd), the split pass (~15%), and in dQ the
// K and V tiles read twice (the D pass) from L2. The second warpgroup
// overlaps those; PERF.md holds the times.

#include <math.h>

#include "split_tf32.cuh"

namespace sslc {
namespace {

constexpr int kWgs = 2;  // consumer warpgroups per block, on alternate tiles
constexpr int kBlockThreads = kWgs * kWgThreads;
constexpr int kKeepTileHalves = kTile * 2;  // 64 rows x 2 halves of 16 keys

// A warpgroup's own buffers: a two-stage ring of two raw tiles (hi after
// the split, in place), their lo, and the transposed tiles, hi and lo: one
// in dQ (K^T), two in dK/dV (Q^T, dO^T).
constexpr uint32_t kDqWgBytes = 2 * 2 * kNBytes + 2 * kNBytes + 2 * kTBytes;
constexpr uint32_t kDkvWgBytes = 2 * 2 * kNBytes + 2 * kNBytes + 4 * kTBytes;
constexpr size_t kBarBytes = 8 * 8;  // 1 + 2 per warpgroup, rounded up
// dQ: Q and dO hi and lo, each warpgroup's buffers, the key bias and
// segment ids of each warpgroup's tile, the mbarriers, 1 KB to align the
// tiles; the keep bits come on top.
constexpr size_t kDqFixedSmemBytes = 4 * (size_t)kResBytes +
                                     kWgs * (size_t)kDqWgBytes +
                                     kWgs * 2 * kN * 4 + kBarBytes + 1024;
// dK/dV: K and V hi and lo, each warpgroup's buffers, its tile's LSE, D
// and query segment ids, the mbarriers, its tile's keep bits, alignment.
constexpr size_t kDkvFixedSmemBytes =
    4 * (size_t)kResBytes + kWgs * (size_t)kDkvWgBytes + kWgs * 3 * kN * 4 +
    kBarBytes + kWgs * kN * 4 * 2 + 1024;

// sum += x, compensated: comp carries what the rounding of sum lost (the
// true sum is sum - comp); the _rn intrinsics are never contracted
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = __fsub_rn(x, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// The two score products of a tile, S = A_s B_s^T and dPd = A_d B_d^T;
// `between` runs while they are in flight.
template <typename Between>
__device__ __forceinline__ void score_products(
    float (&s)[kN / 2], float (&dpd)[kN / 2], uint64_t as_hi, uint64_t as_lo,
    uint64_t bs_hi, uint64_t bs_lo, uint64_t ad_hi, uint64_t ad_lo,
    uint64_t bd_hi, uint64_t bd_lo, Between&& between) {
  fence_regs(s);
  fence_regs(dpd);
  wgmma_fence();
  issue_split_product(s, as_hi, as_lo, bs_hi, bs_lo);
  issue_split_product(dpd, ad_hi, ad_lo, bd_hi, bd_lo);
  wgmma_commit();
  between();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dpd);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_attn_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ bias,
                             const int* __restrict__ segq,
                             const int* __restrict__ segk,
                             const float* __restrict__ lse,
                             float* __restrict__ dd, float* __restrict__ dq,
                             int H, int Tq, int Tk, int causal, float scale,
                             Dropout dropout) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);  // Q, hi after the split
  uint8_t* s_q_lo = s_q + kResBytes;
  uint8_t* s_do = s_q_lo + kResBytes;  // dO, hi after the split
  uint8_t* s_do_lo = s_do + kResBytes;
  uint8_t* s_wg0 = s_do_lo + kResBytes;  // each warpgroup's buffers
  float* s_bias0 = reinterpret_cast<float*>(s_wg0 + kWgs * kDqWgBytes);
  int* s_segk0 = reinterpret_cast<int*>(s_bias0 + kWgs * kN);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_segk0 + kWgs * kN);
  uint16_t* s_keep =  // [key tiles][64 rows x 2 halves]
      reinterpret_cast<uint16_t*>(reinterpret_cast<uint8_t*>(bar) +
                                  kBarBytes);

  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads, wtid = tid % kWgThreads;
  const int warp = wtid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const bool use_seg = segq != nullptr;
  int n_tiles = (Tk + kN - 1) / kN;
  if (causal) n_tiles = min(n_tiles, (q0 + kTile) / kN);
  // warpgroup wg takes key tiles wg, wg + 2, ...: its ring iteration
  // j < n_mine is the D pass on tile wg + 2 j, j >= n_mine the dQ pass on
  // tile wg + 2 (j - n_mine). The first warpgroup has the most tiles,
  // n_max; both pass the D step between the passes together.
  const int n_mine = (n_tiles - wg + 1) / 2;
  const int n_max = (n_tiles + 1) / 2;
  uint8_t* s_k = s_wg0 + wg * kDqWgBytes;  // 2 stages, hi after the split
  uint8_t* s_v = s_k + 2 * kNBytes;        // 2 stages, hi after the split
  uint8_t* s_k_lo = s_v + 2 * kNBytes;
  uint8_t* s_v_lo = s_k_lo + kNBytes;
  uint8_t* s_kt = s_v_lo + kNBytes;  // K^T hi, then lo
  uint8_t* s_kt_lo = s_kt + kTBytes;
  float* s_bias = s_bias0 + wg * kN;
  int* s_segk = s_segk0 + wg * kN;
  uint64_t* wg_bar = bar + 1 + 2 * wg;  // the two stages of the ring

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * kWgs; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_tile = [&](int j) {  // iteration j's K and V into stage j % 2
    const int kt = wg + 2 * (j % n_mine);
    tma_load_rows<kN>(s_k + (j & 1) * kNBytes, &tm_k,
                      s_v + (j & 1) * kNBytes, &tm_v, &wg_bar[j & 1],
                      kt * kN, bh);
  };
  if (tid == 0) tma_load_rows<kTile>(s_q, &tm_q, s_do, &tm_do, &bar[0], q0, bh);
  if (wtid == 0) {
    for (int j = 0; j < min(2, 2 * n_mine); ++j) load_tile(j);
  }

  int row[2], seg_r[2];
  bool row_ok[2];
  // D's row sums rowsum(P) and rowsum(Pd o dPd), each with its Kahan
  // compensation
  float lse_r[2], l_r[2], dd_r[2], l_c[2], dd_c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + 16 * warp + (lane >> 2) + 8 * i;
    row_ok[i] = row[i] < Tq;
    lse_r[i] = row_ok[i] ? lse[(size_t)bh * Tq + row[i]] : 0.f;
    seg_r[i] = (use_seg && row_ok[i]) ? segq[(size_t)b * Tq + row[i]] : 0;
    l_r[i] = dd_r[i] = l_c[i] = dd_c[i] = 0.f;
  }
  float s[kN / 2], dpd[kN / 2], acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  const uint64_t desc_q = tile_desc(s_q), desc_q_lo = tile_desc(s_q_lo);
  const uint64_t desc_do = tile_desc(s_do), desc_do_lo = tile_desc(s_do_lo);
  const uint64_t desc_k_lo = tile_desc(s_k_lo);
  const uint64_t desc_v_lo = tile_desc(s_v_lo);
  const uint64_t desc_kt = tile_desc(s_kt), desc_kt_lo = tile_desc(s_kt_lo);
  mbar_wait(&bar[0], 0);
  split_tile<kTile, kBlockThreads, false>(s_q, s_q_lo, nullptr, nullptr, tid);
  split_tile<kTile, kBlockThreads, false>(s_do, s_do_lo, nullptr, nullptr,
                                          tid);
  fence_proxy_async();
  __syncthreads();  // Q and dO are split

  for (int it = 0; it < 2 * n_max; ++it) {
    if (it == n_max) {
      // D = rowsum(Pd o dPd) / rowsum(P) over both warpgroups' key tiles,
      // their partial sums added in a fixed order; the K^T lo tiles are
      // idle between the passes
      float* part = reinterpret_cast<float*>(s_kt_lo);  // [64 rows][2]
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_r[i] = __fsub_rn(l_r[i], l_c[i]);
        dd_r[i] = __fsub_rn(dd_r[i], dd_c[i]);
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], off);
          dd_r[i] += __shfl_xor_sync(0xffffffffu, dd_r[i], off);
        }
        const int r = row[i] - q0;
        if (t4 == 0) {
          part[2 * r] = l_r[i];
          part[2 * r + 1] = dd_r[i];
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row[i] - q0;
        float l = 0.f, num = 0.f;
#pragma unroll
        for (int w = 0; w < kWgs; ++w) {
          const float* pw = reinterpret_cast<const float*>(
              s_wg0 + w * kDqWgBytes + (s_kt_lo - s_k));
          l += pw[2 * r];
          num += pw[2 * r + 1];
        }
        dd_r[i] = l > 0.f ? num / l : 0.f;
        if (wg == 0 && t4 == 0 && row_ok[i])
          dd[(size_t)bh * Tq + row[i]] = dd_r[i];
      }
      __syncthreads();  // both warpgroups have read the partials
    }
    const bool d_pass = it < n_max;
    const int i_tile = d_pass ? it : it - n_max;
    if (i_tile >= n_mine) continue;  // the second warpgroup has one less
    const int j = d_pass ? i_tile : n_mine + i_tile;  // its ring iteration
    const int kt = wg + 2 * i_tile;
    const int k0 = kt * kN;
    const int stage = j & 1;
    uint8_t* k_hi = s_k + stage * kNBytes;
    uint8_t* v_hi = s_v + stage * kNBytes;
    {  // this tile's key bias and segment ids
      const int c = wtid & (kN - 1), key = k0 + c;
      if (wtid < kN) {
        s_bias[c] = key < Tk ? bias[(size_t)b * Tk + key] : 0.f;
      } else if (wtid < 2 * kN && use_seg) {
        s_segk[c] = key < Tk ? segk[(size_t)b * Tk + key] : 0;
      }
    }
    mbar_wait(&wg_bar[stage], (j >> 1) & 1);
    split_tile<kN, kWgThreads, false>(v_hi, s_v_lo, nullptr, nullptr, wtid);
    if (d_pass) {
      split_tile<kN, kWgThreads, false>(k_hi, s_k_lo, nullptr, nullptr, wtid);
    } else {  // the dQ pass also reads K^T
      split_tile<kN, kWgThreads, true>(k_hi, s_k_lo, s_kt, s_kt_lo, wtid);
    }
    fence_proxy_async();
    wg_sync(wg);  // every split of this tile is written
    uint16_t* keep_bits = s_keep + kt * kKeepTileHalves;
    score_products(  // S = Q K^T, dPd = dO V^T
        s, dpd, desc_q, desc_q_lo, tile_desc(k_hi), desc_k_lo, desc_do,
        desc_do_lo, tile_desc(v_hi), desc_v_lo, [&] {
          if (d_pass && dropout.on) {  // row wtid / 2, keys 16 (wtid % 2) +
            keep_bits[wtid] = (uint16_t)keep_bits16(
                dropout, q0 + (wtid >> 1), k0 + 16 * (wtid & 1), bh);
          }
          wg_sync(wg);
        });

    uint32_t ds_hi[kN / 8][4], ds_lo[kN / 8][4];
    float l_t[2] = {0.f, 0.f}, dd_t[2] = {0.f, 0.f};  // this tile's sums
#pragma unroll
    for (int c8 = 0; c8 < kN / 8; ++c8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = 8 * c8 + 2 * t4 + jj;
          const int e = 4 * c8 + 2 * i + jj;
          const int key = k0 + c;
          float p = 0.f, pd = 0.f;
          if (row_ok[i] && key < Tk) {
            float x = fmaf(s[e], scale, s_bias[c]);
            if (use_seg && seg_r[i] != s_segk[c]) x = kNegInf;
            if (causal && key > row[i]) x = kNegInf;
            p = expf(x - lse_r[i]);
            pd = p;
            if (dropout.on) {
              const uint32_t w = keep_bits[2 * (row[i] - q0) + (c >> 4)];
              pd = ((w >> (c & 15)) & 1u) ? p * dropout.scale : 0.f;
            }
          }
          if (d_pass) {
            l_t[i] += p;
            dd_t[i] = fmaf(pd, dpd[e], dd_t[i]);
          } else {
            const float ds =
                __fsub_rn(__fmul_rn(pd, dpd[e]), __fmul_rn(p, dd_r[i]));
            split_reg(ds, ds_hi[c8][frag_idx(i, jj)],
                      ds_lo[c8][frag_idx(i, jj)]);
          }
        }
      }
    }

    if (d_pass) {  // the tile's row sums into the running ones
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kahan_add(l_r[i], l_c[i], l_t[i]);
        kahan_add(dd_r[i], dd_c[i], dd_t[i]);
      }
    } else {  // dQ += dS K, this tile's sum added in f32
      float c[32];
      fence_regs(c);
      wgmma_fence();
      issue_split_reg_product<kN / 8>(c, ds_hi, ds_lo, desc_kt, desc_kt_lo);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(c);
      add_tile(acc, c);
    }
    wg_sync(wg);  // the warpgroup is done with stage `stage` and the splits
    if (wtid == 0 && j + 2 < 2 * n_mine) load_tile(j + 2);
  }

  // the second warpgroup's dQ, through its idle lo tiles, into the first's
  float* other = reinterpret_cast<float*>(s_wg0 + kDqWgBytes + 4 * kNBytes);
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < 32; ++e) other[e * kWgThreads + wtid] = acc[e];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int e = 0; e < 32; ++e)
    acc[e] = __fadd_rn(acc[e], other[e * kWgThreads + wtid]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    float* out = dq + ((size_t)bh * Tq + row[i]) * kD;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int e = 4 * c8 + 2 * i;
      *reinterpret_cast<float2*>(out + 8 * c8 + 2 * t4) =
          make_float2(scale * acc[e], scale * acc[e + 1]);
    }
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_attn_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ bias,
                              const int* __restrict__ segq,
                              const int* __restrict__ segk,
                              const float* __restrict__ lse,
                              const float* __restrict__ dd,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int H, int Tq, int Tk, int causal, float scale,
                              Dropout dropout) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_k = align_1024(smem_raw);  // K, hi after the split
  uint8_t* s_k_lo = s_k + kResBytes;
  uint8_t* s_v = s_k_lo + kResBytes;  // V, hi after the split
  uint8_t* s_v_lo = s_v + kResBytes;
  uint8_t* s_wg0 = s_v_lo + kResBytes;  // each warpgroup's buffers
  float* s_lse0 = reinterpret_cast<float*>(s_wg0 + kWgs * kDkvWgBytes);
  float* s_dd0 = s_lse0 + kWgs * kN;
  int* s_segq0 = reinterpret_cast<int*>(s_dd0 + kWgs * kN);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_segq0 + kWgs * kN);
  uint16_t* s_keep0 =  // [warpgroup][32 rows x 4 quarters]
      reinterpret_cast<uint16_t*>(reinterpret_cast<uint8_t*>(bar) +
                                  kBarBytes);

  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads, wtid = tid % kWgThreads;
  const int warp = wtid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const bool use_seg = segq != nullptr;
  const int q_first = causal ? k0 / kN : 0;
  const int n_tiles = (Tq + kN - 1) / kN - q_first;
  // warpgroup wg takes query tiles q_first + wg, q_first + wg + 2, ...
  const int n_mine = (n_tiles - wg + 1) / 2;
  uint8_t* s_q = s_wg0 + wg * kDkvWgBytes;  // 2 stages, hi after the split
  uint8_t* s_do = s_q + 2 * kNBytes;        // 2 stages, hi after the split
  uint8_t* s_q_lo = s_do + 2 * kNBytes;
  uint8_t* s_do_lo = s_q_lo + kNBytes;
  uint8_t* s_qt = s_do_lo + kNBytes;  // Q^T hi, lo; dO^T hi, lo
  uint8_t* s_qt_lo = s_qt + kTBytes;
  uint8_t* s_dot = s_qt_lo + kTBytes;
  uint8_t* s_dot_lo = s_dot + kTBytes;
  float* s_lse = s_lse0 + wg * kN;
  float* s_dd = s_dd0 + wg * kN;
  int* s_segq = s_segq0 + wg * kN;
  uint16_t* s_keep = s_keep0 + wg * kN * 4;
  uint64_t* wg_bar = bar + 1 + 2 * wg;

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * kWgs; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_tile = [&](int j) {  // iteration j's Q and dO into stage j % 2
    tma_load_rows<kN>(s_q + (j & 1) * kNBytes, &tm_q,
                      s_do + (j & 1) * kNBytes, &tm_do, &wg_bar[j & 1],
                      (q_first + wg + 2 * j) * kN, bh);
  };
  if (tid == 0) tma_load_rows<kTile>(s_k, &tm_k, s_v, &tm_v, &bar[0], k0, bh);
  if (wtid == 0) {
    for (int j = 0; j < min(2, n_mine); ++j) load_tile(j);
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
  float st[kN / 2], dpdt[kN / 2], dk_acc[32], dv_acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  const uint64_t desc_k = tile_desc(s_k), desc_k_lo = tile_desc(s_k_lo);
  const uint64_t desc_v = tile_desc(s_v), desc_v_lo = tile_desc(s_v_lo);
  const uint64_t desc_q_lo = tile_desc(s_q_lo);
  const uint64_t desc_do_lo = tile_desc(s_do_lo);
  const uint64_t desc_qt = tile_desc(s_qt), desc_qt_lo = tile_desc(s_qt_lo);
  const uint64_t desc_dot = tile_desc(s_dot);
  const uint64_t desc_dot_lo = tile_desc(s_dot_lo);
  mbar_wait(&bar[0], 0);
  split_tile<kTile, kBlockThreads, false>(s_k, s_k_lo, nullptr, nullptr, tid);
  split_tile<kTile, kBlockThreads, false>(s_v, s_v_lo, nullptr, nullptr, tid);
  fence_proxy_async();
  __syncthreads();  // K and V are split

  for (int j = 0; j < n_mine; ++j) {
    const int q0 = (q_first + wg + 2 * j) * kN;
    const int stage = j & 1;
    uint8_t* q_hi = s_q + stage * kNBytes;
    uint8_t* do_hi = s_do + stage * kNBytes;
    {  // this tile's LSE, D and query segment ids
      const int c = wtid & (kN - 1), qr = q0 + c;
      const bool ok = qr < Tq;
      if (wtid < kN) {
        s_lse[c] = ok ? lse[(size_t)bh * Tq + qr] : 0.f;
      } else if (wtid < 2 * kN) {
        s_dd[c] = ok ? dd[(size_t)bh * Tq + qr] : 0.f;
      } else if (wtid < 3 * kN && use_seg) {
        s_segq[c] = ok ? segq[(size_t)b * Tq + qr] : 0;
      }
    }
    mbar_wait(&wg_bar[stage], (j >> 1) & 1);
    split_tile<kN, kWgThreads, true>(q_hi, s_q_lo, s_qt, s_qt_lo, wtid);
    split_tile<kN, kWgThreads, true>(do_hi, s_do_lo, s_dot, s_dot_lo, wtid);
    fence_proxy_async();
    wg_sync(wg);  // every split of this tile is written
    score_products(  // S^T = K Q^T, dPd^T = V dO^T
        st, dpdt, desc_k, desc_k_lo, tile_desc(q_hi), desc_q_lo, desc_v,
        desc_v_lo, tile_desc(do_hi), desc_do_lo, [&] {
          if (dropout.on) {  // query row q0 + wtid / 4, keys 16 (wtid % 4) +
            s_keep[wtid] = (uint16_t)keep_bits16(
                dropout, q0 + (wtid >> 2), k0 + 16 * (wtid & 3), bh);
          }
          wg_sync(wg);
        });

    uint32_t pd_hi[kN / 8][4], pd_lo[kN / 8][4];
    uint32_t ds_hi[kN / 8][4], ds_lo[kN / 8][4];
#pragma unroll
    for (int c8 = 0; c8 < kN / 8; ++c8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = 8 * c8 + 2 * t4 + jj;  // query q0 + c
          const int e = 4 * c8 + 2 * i + jj;
          const int qr = q0 + c;
          float p = 0.f, pd = 0.f;
          if (key_ok[i] && qr < Tq) {
            float x = fmaf(st[e], scale, bias_r[i]);
            if (use_seg && s_segq[c] != segk_r[i]) x = kNegInf;
            if (causal && key[i] > qr) x = kNegInf;
            p = expf(x - s_lse[c]);
            pd = p;
            if (dropout.on) {
              const uint32_t w = s_keep[4 * c + (kr[i] >> 4)];
              pd = ((w >> (kr[i] & 15)) & 1u) ? p * dropout.scale : 0.f;
            }
          }
          const float ds =
              __fsub_rn(__fmul_rn(pd, dpdt[e]), __fmul_rn(p, s_dd[c]));
          const int f = frag_idx(i, jj);
          split_reg(pd, pd_hi[c8][f], pd_lo[c8][f]);
          split_reg(ds, ds_hi[c8][f], ds_lo[c8][f]);
        }
      }
    }

    // this tile's Pd^T dO, then its dS^T Q, through one accumulator (two
    // would take the registers past 255)
    float c[32];
    fence_regs(c);
    wgmma_fence();
    issue_split_reg_product<kN / 8>(c, pd_hi, pd_lo, desc_dot, desc_dot_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(c);
    add_tile(dv_acc, c);  // dV += Pd^T dO
    wgmma_fence();
    issue_split_reg_product<kN / 8>(c, ds_hi, ds_lo, desc_qt, desc_qt_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(c);
    add_tile(dk_acc, c);  // dK += dS^T Q
    wg_sync(wg);  // the warpgroup is done with stage `stage`, the splits
                  // and its keep bits
    if (wtid == 0 && j + 2 < n_mine) load_tile(j + 2);
  }

  // the second warpgroup's dK and dV, through its idle transposed tiles,
  // into the first's
  float* other = reinterpret_cast<float*>(s_wg0 + kDkvWgBytes +
                                          6 * kNBytes);  // 32 KB
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      other[e * kWgThreads + wtid] = dk_acc[e];
      other[(32 + e) * kWgThreads + wtid] = dv_acc[e];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    dk_acc[e] = __fadd_rn(dk_acc[e], other[e * kWgThreads + wtid]);
    dv_acc[e] = __fadd_rn(dv_acc[e], other[(32 + e) * kWgThreads + wtid]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!key_ok[i]) continue;
    const size_t off = ((size_t)bh * Tk + key[i]) * kD;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int e = 4 * c8 + 2 * i;
      *reinterpret_cast<float2*>(dk + off + 8 * c8 + 2 * t4) =
          make_float2(scale * dk_acc[e], scale * dk_acc[e + 1]);
      *reinterpret_cast<float2*>(dv + off + 8 * c8 + 2 * t4) =
          make_float2(dv_acc[e], dv_acc[e + 1]);
    }
  }
}

// q, k, v, dout's maps; q and dout in boxes of q_rows rows, k and v of
// k_rows.
cudaError_t make_f32_maps(CUtensorMap (&maps)[4], const void* q,
                          const void* k, const void* v, const void* dout,
                          int BH, int Tq, int Tk, int q_rows, int k_rows) {
  cudaError_t err;
  if ((err = make_f32_map(&maps[0], q, Tq, BH, q_rows)) != cudaSuccess)
    return err;
  if ((err = make_f32_map(&maps[1], k, Tk, BH, k_rows)) != cudaSuccess)
    return err;
  if ((err = make_f32_map(&maps[2], v, Tk, BH, k_rows)) != cudaSuccess)
    return err;
  return make_f32_map(&maps[3], dout, Tq, BH, q_rows);
}

}  // namespace

cudaError_t launch_bwd_dq_f32_sm90(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* segq, const void* segk,
                                   const void* dout, const void* lse,
                                   void* dd, void* dq, int B, int H, int Tq,
                                   int Tk, int causal, const Dropout& dropout,
                                   cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err =
      make_f32_maps(maps, q, k, v, dout, B * H, Tq, Tk, kTile, kN);
  if (err != cudaSuccess) return err;
  // the D pass's keep bits of every key tile, for the dQ pass
  const size_t keep_bytes =
      dropout.on ? (size_t)((Tk + kN - 1) / kN) * kKeepTileHalves * 2 : 0;
  const size_t smem = kDqFixedSmemBytes + keep_bytes;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_attn_bwd_dq_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kTile - 1) / kTile, H, B);
  flash_attn_bwd_dq_f32_kernel<<<grid, kBlockThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const float*>(lse), static_cast<float*>(dd),
      static_cast<float*>(dq), H, Tq, Tk, causal, 0.125f /* 1/sqrt(64) */,
      dropout);
  return cudaGetLastError();
}

cudaError_t launch_bwd_dkv_f32_sm90(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* segq, const void* segk,
                                    const void* dout, const void* lse,
                                    const void* dd, void* dk, void* dv,
                                    int B, int H, int Tq, int Tk, int causal,
                                    const Dropout& dropout,
                                    cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err =
      make_f32_maps(maps, q, k, v, dout, B * H, Tq, Tk, kN, kTile);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attn_bwd_dkv_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDkvFixedSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + kTile - 1) / kTile, H, B);
  flash_attn_bwd_dkv_f32_kernel<<<grid, kBlockThreads, kDkvFixedSmemBytes,
                                  stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk, causal,
      0.125f /* 1/sqrt(64) */, dropout);
  return cudaGetLastError();
}

}  // namespace sslc
