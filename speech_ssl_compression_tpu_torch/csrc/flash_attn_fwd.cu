// Flash-attention forward for Hopper (sm_90a), with optional in-kernel
// attention dropout: the C entry point for both input dtypes, and the f32
// kernel on the CUDA cores. bf16 inputs go to the tensor-core kernel of
// flash_attn_fwd_sm90.cu (wgmma, TMA), which computes the same function
// with the same rounding points.
//
// Replaces the two Pallas TPU forward kernels of
// speech_ssl_compression_tpu/ops/flash_attention.py:
//   * _fa_fwd_kernel (both branches: dropout-free and dropout, with
//     _tile_keep_mask), launched by _flash_fwd_impl, which keeps the whole
//     K/V of one (b, h) resident in VMEM;
//   * _fa_fwd_stream_kernel, launched by _flash_fwd_stream past T = 4096
//     and for rectangular q-vs-k attention (flash_attention_kv_full).
// The split between the two, and the tile planners beside them, exist for
// the TPU's 16 MB scoped VMEM; here one kernel covers every Tq and Tk.
//
// Computes, per (b, h, query row):
//   s    = scale * (q . k) in f32, scale = 1/sqrt(d) applied AFTER the dot
//   s   += bias[key]                        (0 or -1e30 for a padded key)
//   s    = -1e30 where segq[row] != segk[key]       (segment packing)
//   s    = -1e30 where key > row                    (causal, Tq == Tk)
//   O    = softmax(s) V by online softmax, LSE = m + log(max(l, 1e-30))
// The mask value is the finite -1e30, never -inf: a row whose keys are all
// masked still gives finite numbers. Keys past Tk (the ragged last tile)
// are removed with -inf, which only ever meets a finite row maximum.
// With bf16 inputs, P is rounded to bf16 before the P.V product, as the
// Pallas kernel casts p to the input dtype before its MXU dot.
//
// Dropout acts on the normalized probabilities, and the LSE stays exact
// (flash_attention.py:20-27): O = (P o M / (1 - p)) V with P = exp(S - LSE).
// The TPU kernel takes two passes over the keys for that (statistics, then
// P o M). This kernel takes one online-softmax pass: the row sum l adds
// every p, the P.V product sees p only where the keep bit M is set, and the
// output is acc / l / (1 - p). That is the same function; the one
// difference is where a bf16 P is rounded (the unnormalized p of each key
// tile, as in the dropout-free branch), and the plain version rounds there
// too. M comes from flash_common.cuh's counter-based generator, one draw
// per (row, key), so the backward kernels regenerate it.
//
// Design (f32). One block of 256 threads per (64-query tile, head,
// batch); a loop inside the block walks the 64-key tiles that the TPU
// walked as a sequential grid axis (under causal, up to the diagonal
// tile). Q, the current K and V tiles and the P tile are staged in shared
// memory as f32 (70 KB, dynamic shared memory). Each thread owns a 4 x 4
// register micro-tile of S (rows ty + 16 i, keys tx + 16 j) and of the
// output accumulator (rows ty + 16 i, dims 4 tx .. 4 tx + 3); the 16
// threads of a row share its max and sum by warp shuffles. The
// online-softmax statistics and the accumulator stay in f32 registers.
//
// What bounds it. At the serving shape (8 packed rows of 896 frames, 12
// heads, d = 64) each (b, h) reads 3 * 896 * 64 values and does
// 4 * 896^2 * 64 FLOPs: ~150 FLOPs per byte even with K/V re-read for every
// query tile, so the kernel is bound by its FLOPs, here on the CUDA cores'
// f32 FMA pipes (67 TFLOP/s peak on an H100 SXM), not by memory bandwidth.
// Dropout adds one Philox-4x32-10 draw per score, about 100 integer
// instructions beside the score's 128 FMAs, so the dropout variant issues
// nearly twice the instructions of the dropout-free one.
//
// Occupancy. ptxas gives the kernel 124-126 registers, so a block of 256
// threads holds ~32K of an SM's 64K registers: registers, not the 70 KB of
// shared memory (which would allow 3), cap it at 2 blocks (16 warps) per SM.
//
// What this simple design leaves on the table: TMA loads into a
// multi-stage ring so the next K/V tile arrives during this tile's math
// (here loads and math alternate behind __syncthreads), occupancy (the
// 4 x 4 S and accumulator micro-tiles hold the registers that cap it), and
// causal skipping below the diagonal's tile granularity. Those are later
// work. The tensor cores are not among them for f32: its bar (1e-4 against
// the plain version, TF32 off) leaves no room for TF32, and the kernel is
// within a few percent of SDPA's f32 time at the serving shape.

#include <math.h>

#include "flash_common.cuh"

namespace sslc {
// the bf16 kernel's launcher (flash_attn_fwd_sm90.cu)
cudaError_t launch_fwd_sm90(const void* q, const void* k, const void* v,
                            const void* bias, const void* segq,
                            const void* segk, void* o, void* lse, int B,
                            int H, int Tq, int Tk, int causal,
                            const Dropout& dropout, cudaStream_t stream);
}  // namespace sslc

namespace {

using namespace sslc;

constexpr size_t kSmemBytes =
    (size_t)(kBQ * kLd + 2 * kBK * kLd + kBQ * kLd + kBK) * sizeof(float) +
    (size_t)kBK * sizeof(int);

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const int* __restrict__ segq,
                      const int* __restrict__ segk, T* __restrict__ o,
                      float* __restrict__ lse, int H, int Tq, int Tk,
                      int causal, float scale, Dropout dropout) {
  extern __shared__ float4 smem_f4[];
  float* sq = reinterpret_cast<float*>(smem_f4);
  float* sk = sq + kBQ * kLd;
  float* sv = sk + kBK * kLd;
  float* sp = sv + kBK * kLd;
  float* sbias = sp + kBQ * kLd;
  int* ssegk = reinterpret_cast<int*>(sbias + kBK);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const bool use_seg = segq != nullptr;

  const T* qb = q + bh * Tq * kD;
  const T* kb = k + bh * Tk * kD;
  const T* vb = v + bh * Tk * kD;
  const float* bias_b = bias + (size_t)b * Tk;

  load_tile(sq, qb, q0, min(kBQ, Tq - q0), tid);

  int row[4];
  int seg_row[4];
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty + 16 * i;
    seg_row[i] =
        (use_seg && row[i] < Tq) ? segq[(size_t)b * Tq + row[i]] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Tk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    const int k_valid = min(kBK, Tk - k0);
    __syncthreads();  // the previous tile's readers of sk/sv/sp are done
    load_tile(sk, kb, k0, k_valid, tid);
    load_tile(sv, vb, k0, k_valid, tid);
    if (tid < kBK) {
      const bool in = tid < k_valid;
      sbias[tid] = in ? bias_b[k0 + tid] : 0.f;
      ssegk[tid] = (use_seg && in) ? segk[(size_t)b * Tk + k0 + tid] : 0;
    }
    __syncthreads();

    // S = Q K^T on this thread's micro-tile, f32 accumulation
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kD; c += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * kLd + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * kLd + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qf[i].x, kf[j].x, a);
          a = fmaf(qf[i].y, kf[j].y, a);
          a = fmaf(qf[i].z, kf[j].z, a);
          a = fmaf(qf[i].w, kf[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, masks, and the online-softmax update of this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        float x;
        if (kc >= k_valid) {
          x = -INFINITY;
        } else {
          x = s[i][j] * scale + sbias[kc];
          if (use_seg && seg_row[i] != ssegk[kc]) x = kNegInf;
          if (causal && k0 + kc > row[i]) x = kNegInf;
        }
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        const int kc = tx + 16 * j;
        const bool kept = !dropout.on || keep(dropout, k0 + kc, row[i],
                                              (uint32_t)bh);
        sp[(ty + 16 * i) * kLd + kc] = kept ? round_in(p, q) : 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      m[i] = m_new;
      l[i] = l[i] * alpha + row_sum;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V on rows ty + 16 i, dims 4 tx .. 4 tx + 3
#pragma unroll 4
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pf[4], vf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[i] = *reinterpret_cast<const float4*>(sp + (ty + 16 * i) * kLd + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vf[u] = *reinterpret_cast<const float4*>(sv + (kk + u) * kLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr[4] = {pf[i].x, pf[i].y, pf[i].z, pf[i].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(pr[u], vf[u].x, acc[i][0]);
          acc[i][1] = fmaf(pr[u], vf[u].y, acc[i][1]);
          acc[i][2] = fmaf(pr[u], vf[u].z, acc[i][2]);
          acc[i][3] = fmaf(pr[u], vf[u].w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= Tq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = acc[i][c] / l_safe * dropout.scale;
    store4(o + (bh * Tq + row[i]) * kD + 4 * tx, out);
    if (tx == 0) lse[bh * Tq + row[i]] = m[i] + logf(l_safe);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* segq, const void* segk,
                   void* o, void* lse, int B, int H, int Tq, int Tk,
                   int causal, Dropout dropout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_attn_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(segq), static_cast<const int*>(segk),
      static_cast<T*>(o), static_cast<float*>(lse), H, Tq, Tk, causal,
      0.125f /* 1/sqrt(64) */, dropout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,H,Tq,64), k and v (B,H,Tk,64), contiguous, f32 (is_bf16 = 0) or bf16;
// bias (B,Tk) f32; segq (B,Tq) and segk (B,Tk) int32, both null without
// segments; o like q; lse (B,H,Tq) f32; all on CUDA device `device`.
// With use_dropout, a probability is kept iff its Philox bits are below
// keep_threshold, and kept ones are scaled by keep_scale (flash_common.cuh).
// Launches on `stream` (a stream of that device) and returns
// cudaGetLastError() after the launch (0 on success).
int sslc_flash_attn_fwd(const void* q, const void* k, const void* v,
                        const void* bias, const void* segq, const void* segk,
                        void* o, void* lse, int B, int H, int Tq, int Tk,
                        int causal, int is_bf16, int use_dropout,
                        unsigned int keep_threshold, float keep_scale,
                        unsigned long long seed, int device, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // the caller's: make it the tensors' device before the launch
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dropout =
      make_dropout(use_dropout, keep_threshold, keep_scale, seed);
  if (is_bf16) {
    return launch_fwd_sm90(q, k, v, bias, segq, segk, o, lse, B, H, Tq, Tk,
                           causal, dropout, s);
  }
  return launch<float>(q, k, v, bias, segq, segk, o, lse, B, H, Tq, Tk,
                       causal, dropout, s);
}

const char* sslc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
