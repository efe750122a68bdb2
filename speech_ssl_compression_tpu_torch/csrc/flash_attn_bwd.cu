// Flash-attention backward for Hopper (sm_90a), CUDA cores, f32 or bf16 in,
// with the forward's in-kernel attention dropout regenerated.
//
// Replaces the four Pallas TPU backward kernels of
// speech_ssl_compression_tpu/ops/flash_attention.py:
//   * _fa_bwd_dq_kernel and _fa_bwd_dkv_kernel, launched by _flash_bwd_impl,
//     which keep the whole K/V (or Q/dO) of one (b, h) resident in VMEM;
//   * _fa_bwd_dq_stream_kernel and _fa_bwd_dkv_stream_kernel, launched by
//     _flash_bwd_stream past T = 4096 and for rectangular q-vs-k attention
//     (the backward of flash_attention_kv_full), dropout-free.
// The resident/streamed split exists for the TPU's 16 MB scoped VMEM; here
// flash_attn_bwd_dq_kernel covers both dQ kernels and
// flash_attn_bwd_dkv_kernel both dK/dV kernels, for every Tq and Tk.
//
// Computes, with the forward's LSE (B, H, Tq) and D (B, H, Tq):
//   S   = scale * (q . k) in f32, scale AFTER the dot, the forward's masks
//   P   = exp(S - LSE)                  (the exact softmax)
//   Pd  = P o M * 1/(1-p)               (M: the forward's keep bits)
//   dPd = dO . V^T                      (f32)
//   dS  = Pd o dPd - P o D              (Pd AND P: with dropout they differ)
//   dQ  = scale * dS K,   dK = scale * dS^T Q,   dV = Pd^T dO
// As in the Pallas kernels, dS and Pd are cast to the input dtype before
// their products (rounded to bf16 for bf16 inputs), accumulation is f32,
// and the scale is applied to the f32 accumulators at the end.
//
// D. _flash_bwd_impl computes D = rowsum(dO o O) outside the kernels, from
// the forward's output. Here the dQ kernel computes D = rowsum(Pd o dPd) /
// rowsum(P) itself and writes it for the dK/dV kernel: the same number in
// exact arithmetic (rowsum(P) = 1 and sum_j Pd_ij dPd_ij = dO_i . O_i), but
// from the P that the backward itself recomputes, so that sum_j dS_ij
// cancels to rounding as it does in the softmax's own backward. With D from
// O, the forward's and the backward's roundings of P differ by ~1e-7, and
// the LSE leaves rowsum(P) ~1e-6 off 1; where a row's keys share a large
// common component those residuals reach dQ and dK: after 3 HuBERT updates
// they put layer 11's q/k projection gradients 1.3-1.7e-4 (rel. L2) from a
// float64 run, against 2e-5 for the dense path. The dQ kernel takes a first
// pass over the key tiles for the two row sums (S and dPd twice: ~1.7x the
// time of one pass).
//
// Padding. Query rows past Tq load q = dO = 0 and D = 0, so dS = 0 and Pd
// meets dO = 0: they add nothing. Keys past Tk get S = -inf, so P = 0.
// Under causal, key tiles above the diagonal are skipped (dQ) and query
// tiles above it are skipped (dK/dV), as the Pallas loop bounds do
// (:525-530, :599-604); the element mask handles the diagonal tile.
//
// Design. Two kernels, as JAX has, so that no gradient needs atomics and
// every run gives the same bits. dQ: one block of 256 threads per
// (64-query tile, head, batch), looping over key tiles. dK/dV: one block
// per (64-key tile, head, batch), looping over query tiles. In both, a
// thread owns a 4 x 4 micro-tile (rows ty + 16 i, keys tx + 16 j) of S and
// dPd, writes its dS (and Pd) into shared memory, and after a barrier owns
// rows ty + 16 i and dims 4 tx .. 4 tx + 3 of its f32 accumulators (dQ;
// dK and dV). Tiles are staged in shared memory as f32 with a 68-float row
// stride: dQ holds Q, dO, K, V and dS (87.5 KB), dK/dV holds K, V, Q, dO,
// Pd and dS (106 KB), both as dynamic shared memory.
//
// What bounds it. Per score the kernels do 64 FMAs each for S, dPd and one
// or two products with dS/Pd: 320 in dQ (192, and 128 in its first pass
// over the keys for D), 256 in dK/dV (S and dPd are recomputed by both),
// against ~50 FLOPs per byte of q/k/v/dO read: like the forward, bound by
// the CUDA cores' f32 FMA rate (67 TFLOP/s on an
// H100 SXM), and with dropout by the Philox draws (~100 integer
// instructions per score, in both kernels).
//
// What this simple design leaves on the table: the tensor cores (wgmma on
// bf16 tiles), TMA and a multi-stage ring for the loads, one fused kernel
// that computes S and dPd once (FlashAttention-2 computes dK/dV in one
// pass and adds dQ with atomics; this port keeps the deterministic
// two-kernel split), and causal skipping below tile granularity.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace sslc;

constexpr size_t kDqSmemBytes =
    (size_t)(5 * kTileFloats + kBK) * sizeof(float) + (size_t)kBK * sizeof(int);
constexpr size_t kDkvSmemBytes =
    (size_t)(6 * kTileFloats + kBK + 2 * kBQ) * sizeof(float) +
    (size_t)(kBK + kBQ) * sizeof(int);

// s[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c] over the 64 dims.
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < kD; c += 4) {
    float4 af[4], bf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      af[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLd + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bf[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(af[i].x, bf[j].x, x);
        x = fmaf(af[i].y, bf[j].y, x);
        x = fmaf(af[i].z, bf[j].z, x);
        x = fmaf(af[i].w, bf[j].w, x);
        s[i][j] = x;
      }
  }
}

// The masked, scaled score of (row, key): the forward's rules exactly.
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              float bias, int seg_r, int seg_k,
                                              bool use_seg, int causal, int row,
                                              int key) {
  float x = dot * scale + bias;
  if (use_seg && seg_r != seg_k) x = kNegInf;
  if (causal && key > row) x = kNegInf;
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const int* __restrict__ segq,
                         const int* __restrict__ segk,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ dd, T* __restrict__ dq,
                         int H, int Tq, int Tk, int causal, float scale,
                         Dropout dropout) {
  extern __shared__ float4 smem_f4[];
  float* sq = reinterpret_cast<float*>(smem_f4);
  float* sdo = sq + kTileFloats;
  float* sk = sdo + kTileFloats;
  float* sv = sk + kTileFloats;
  float* sds = sv + kTileFloats;
  float* sbias = sds + kTileFloats;
  int* ssegk = reinterpret_cast<int*>(sbias + kBK);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const bool use_seg = segq != nullptr;
  const int q_valid = min(kBQ, Tq - q0);

  const T* kb = k + bh * Tk * kD;
  const T* vb = v + bh * Tk * kD;
  const float* bias_b = bias + (size_t)b * Tk;

  load_tile(sq, q + bh * Tq * kD, q0, q_valid, tid);
  load_tile(sdo, dout + bh * Tq * kD, q0, q_valid, tid);

  int row[4], seg_row[4];
  float lse_r[4], dd_r[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty + 16 * i;
    const bool in = row[i] < Tq;
    seg_row[i] = (use_seg && in) ? segq[(size_t)b * Tq + row[i]] : 0;
    lse_r[i] = in ? lse[bh * Tq + row[i]] : 1.f;
    dd_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Tk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  // Stage key tile kt (K, V, bias, segments) and compute this thread's S
  // and dPd micro-tiles on it.
  auto stage = [&](int kt, float (&s)[4][4], float (&dpd)[4][4]) {
    const int k0 = kt * kBK;
    const int k_valid = min(kBK, Tk - k0);
    __syncthreads();  // the previous tile's readers of sk/sv/sds are done
    load_tile(sk, kb, k0, k_valid, tid);
    load_tile(sv, vb, k0, k_valid, tid);
    if (tid < kBK) {
      const bool in = tid < k_valid;
      sbias[tid] = in ? bias_b[k0 + tid] : 0.f;
      ssegk[tid] = (use_seg && in) ? segk[(size_t)b * Tk + k0 + tid] : 0;
    }
    __syncthreads();
    tile_dot(s, sq, sk, tx, ty);
    tile_dot(dpd, sdo, sv, tx, ty);
  };
  // P = exp(S - LSE) of element (i, j) of tile kt, and its dropped-out and
  // scaled Pd; both 0 outside the valid rows and keys.
  auto probs = [&](int kt, int i, int j, float s, float& pd) {
    const int k0 = kt * kBK;
    const int kc = tx + 16 * j;
    pd = 0.f;
    if (kc >= min(kBK, Tk - k0) || row[i] >= Tq) return 0.f;
    const float x = masked_score(s, scale, sbias[kc], seg_row[i], ssegk[kc],
                                 use_seg, causal, row[i], k0 + kc);
    const float p = expf(x - lse_r[i]);
    pd = p;
    if (dropout.on) {
      pd = keep(dropout, k0 + kc, row[i], (uint32_t)bh) ? p * dropout.scale
                                                        : 0.f;
    }
    return p;
  };

  {  // D = rowsum(Pd o dPd) / rowsum(P), written for dK/dV
    float l_r[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kt = 0; kt < n_tiles; ++kt) {
      float s[4][4], dpd[4][4];
      stage(kt, s, dpd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float pd;
          l_r[i] += probs(kt, i, j, s[i][j], pd);
          dd_r[i] = fmaf(pd, dpd[i][j], dd_r[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        dd_r[i] += __shfl_xor_sync(0xffffffffu, dd_r[i], off);
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], off);
      }
      dd_r[i] = l_r[i] > 0.f ? dd_r[i] / l_r[i] : 0.f;
      if (tx == 0 && row[i] < Tq) dd[bh * Tq + row[i]] = dd_r[i];
    }
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    float s[4][4], dpd[4][4];
    stage(kt, s, dpd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pd;
        const float p = probs(kt, i, j, s[i][j], pd);
        const float ds = pd * dpd[i][j] - p * dd_r[i];
        sds[(ty + 16 * i) * kLd + tx + 16 * j] = round_in(ds, q);
      }
    __syncthreads();

    // acc += dS K on rows ty + 16 i, dims 4 tx .. 4 tx + 3
#pragma unroll 4
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 df[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        df[i] = *reinterpret_cast<const float4*>(sds + (ty + 16 * i) * kLd + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kf[u] = *reinterpret_cast<const float4*>(sk + (kk + u) * kLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dr[4] = {df[i].x, df[i].y, df[i].z, df[i].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(dr[u], kf[u].x, acc[i][0]);
          acc[i][1] = fmaf(dr[u], kf[u].y, acc[i][1]);
          acc[i][2] = fmaf(dr[u], kf[u].z, acc[i][2]);
          acc[i][3] = fmaf(dr[u], kf[u].w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= Tq) continue;
    float out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = scale * acc[i][c];
    store4(dq + (bh * Tq + row[i]) * kD + 4 * tx, out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ bias,
                          const int* __restrict__ segq,
                          const int* __restrict__ segk,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dd, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int Tq, int Tk,
                          int causal, float scale, Dropout dropout) {
  extern __shared__ float4 smem_f4[];
  float* sk = reinterpret_cast<float*>(smem_f4);
  float* sv = sk + kTileFloats;
  float* sq = sv + kTileFloats;
  float* sdo = sq + kTileFloats;
  float* spd = sdo + kTileFloats;
  float* sds = spd + kTileFloats;
  float* sbias = sds + kTileFloats;
  float* slse = sbias + kBK;
  float* sdd = slse + kBQ;
  int* ssegk = reinterpret_cast<int*>(sdd + kBQ);
  int* ssegq = ssegk + kBK;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const bool use_seg = segq != nullptr;
  const int k_valid = min(kBK, Tk - k0);

  const T* qb = q + bh * Tq * kD;
  const T* dob = dout + bh * Tq * kD;

  load_tile(sk, k + bh * Tk * kD, k0, k_valid, tid);
  load_tile(sv, v + bh * Tk * kD, k0, k_valid, tid);
  if (tid < kBK) {
    const bool in = tid < k_valid;
    sbias[tid] = in ? bias[(size_t)b * Tk + k0 + tid] : 0.f;
    ssegk[tid] = (use_seg && in) ? segk[(size_t)b * Tk + k0 + tid] : 0;
  }

  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q_tiles = (Tq + kBQ - 1) / kBQ;
  const int q_first = causal ? k0 / kBQ : 0;

  for (int qt = q_first; qt < n_q_tiles; ++qt) {
    const int q0 = qt * kBQ;
    const int q_valid = min(kBQ, Tq - q0);
    __syncthreads();  // the previous tile's readers of sq/sdo/spd/sds are done
    load_tile(sq, qb, q0, q_valid, tid);
    load_tile(sdo, dob, q0, q_valid, tid);
    if (tid < kBQ) {
      const bool in = tid < q_valid;
      slse[tid] = in ? lse[bh * Tq + q0 + tid] : 1.f;
      sdd[tid] = in ? dd[bh * Tq + q0 + tid] : 0.f;
      ssegq[tid] = (use_seg && in) ? segq[(size_t)b * Tq + q0 + tid] : 0;
    }
    __syncthreads();

    // S and dPd on rows (queries) ty + 16 i, columns (keys) tx + 16 j
    float s[4][4], dpd[4][4];
    tile_dot(s, sq, sk, tx, ty);
    tile_dot(dpd, sdo, sv, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        float pd = 0.f, ds = 0.f;
        if (kc < k_valid && r < q_valid) {
          const float x = masked_score(s[i][j], scale, sbias[kc], ssegq[r],
                                       ssegk[kc], use_seg, causal, row,
                                       k0 + kc);
          const float p = expf(x - slse[r]);
          pd = p;
          if (dropout.on) {
            pd = keep(dropout, k0 + kc, row, (uint32_t)bh)
                     ? p * dropout.scale : 0.f;
          }
          ds = pd * dpd[i][j] - p * sdd[r];
        }
        spd[r * kLd + kc] = round_in(pd, q);
        sds[r * kLd + kc] = round_in(ds, q);
      }
    }
    __syncthreads();

    // dV += Pd^T dO and dK += dS^T Q on keys ty + 16 i, dims 4 tx .. 4 tx + 3
#pragma unroll 2
    for (int qq = 0; qq < kBQ; ++qq) {
      const float4 dof =
          *reinterpret_cast<const float4*>(sdo + qq * kLd + 4 * tx);
      const float4 qf = *reinterpret_cast<const float4*>(sq + qq * kLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = spd[qq * kLd + ty + 16 * i];
        const float dsv = sds[qq * kLd + ty + 16 * i];
        dv_acc[i][0] = fmaf(pv, dof.x, dv_acc[i][0]);
        dv_acc[i][1] = fmaf(pv, dof.y, dv_acc[i][1]);
        dv_acc[i][2] = fmaf(pv, dof.z, dv_acc[i][2]);
        dv_acc[i][3] = fmaf(pv, dof.w, dv_acc[i][3]);
        dk_acc[i][0] = fmaf(dsv, qf.x, dk_acc[i][0]);
        dk_acc[i][1] = fmaf(dsv, qf.y, dk_acc[i][1]);
        dk_acc[i][2] = fmaf(dsv, qf.z, dk_acc[i][2]);
        dk_acc[i][3] = fmaf(dsv, qf.w, dk_acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Tk) continue;
    float out_k[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) out_k[c] = scale * dk_acc[i][c];
    store4(dk + (bh * Tk + key) * kD + 4 * tx, out_k);
    store4(dv + (bh * Tk + key) * kD + 4 * tx, dv_acc[i]);
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* bias, const void* segq, const void* segk,
                      const void* dout, const void* lse, void* dd, void* dq,
                      int B, int H, int Tq, int Tk, int causal,
                      Dropout dropout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_attn_bwd_dq_kernel<T><<<grid, kThreads, kDqSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dd), static_cast<T*>(dq), H, Tq, Tk, causal,
      0.125f /* 1/sqrt(64) */, dropout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* bias, const void* segq, const void* segk,
                       const void* dout, const void* lse, const void* dd,
                       void* dk, void* dv, int B, int H, int Tq, int Tk,
                       int causal, Dropout dropout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkv_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + kBK - 1) / kBK, H, B);
  flash_attn_bwd_dkv_kernel<T><<<grid, kThreads, kDkvSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<T*>(dk), static_cast<T*>(dv),
      H, Tq, Tk, causal, 0.125f /* 1/sqrt(64) */, dropout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dout (B,H,Tq,64), k and v (B,H,Tk,64), contiguous, f32 (is_bf16 = 0)
// or bf16; bias (B,Tk) f32; segq (B,Tq) and segk (B,Tk) int32, both null
// without segments; lse (B,H,Tq) f32; dq like q; dd (B,H,Tq) f32 is an
// output: the kernel computes D = rowsum(Pd o dPd) / rowsum(P) and writes
// it there, for sslc_flash_attn_bwd_dkv. Dropout arguments as
// sslc_flash_attn_fwd's, with the forward's seed. Launches on `stream` of
// CUDA device `device` and returns cudaGetLastError() (0 on success).
int sslc_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                           const void* bias, const void* segq,
                           const void* segk, const void* dout,
                           const void* lse, void* dd, void* dq, int B, int H,
                           int Tq, int Tk, int causal, int is_bf16,
                           int use_dropout,
                           unsigned int keep_threshold,
                           float keep_scale, unsigned long long seed,
                           int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dropout =
      make_dropout(use_dropout, keep_threshold, keep_scale, seed);
  if (is_bf16) {
    return launch_dq<__nv_bfloat16>(q, k, v, bias, segq, segk, dout, lse, dd,
                                    dq, B, H, Tq, Tk, causal, dropout, s);
  }
  return launch_dq<float>(q, k, v, bias, segq, segk, dout, lse, dd, dq, B, H,
                          Tq, Tk, causal, dropout, s);
}

// As sslc_flash_attn_bwd_dq, with dd the D it wrote (an input here); dk
// and dv like k.
int sslc_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* bias, const void* segq,
                            const void* segk, const void* dout,
                            const void* lse, const void* dd, void* dk,
                            void* dv, int B, int H, int Tq, int Tk,
                            int causal, int is_bf16, int use_dropout,
                            unsigned int keep_threshold, float keep_scale,
                            unsigned long long seed, int device,
                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dropout =
      make_dropout(use_dropout, keep_threshold, keep_scale, seed);
  if (is_bf16) {
    return launch_dkv<__nv_bfloat16>(q, k, v, bias, segq, segk, dout, lse, dd,
                                     dk, dv, B, H, Tq, Tk, causal, dropout, s);
  }
  return launch_dkv<float>(q, k, v, bias, segq, segk, dout, lse, dd, dk, dv,
                           B, H, Tq, Tk, causal, dropout, s);
}

}  // extern "C"
