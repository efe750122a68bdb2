// Flash-attention backward for Hopper (sm_90a), with the forward's in-kernel
// attention dropout regenerated: the C entry points for both input dtypes.
// f32 inputs go to the split-TF32 kernels of flash_attn_bwd_f32_sm90.cu,
// bf16 inputs to the kernels of flash_attn_bwd_sm90.cu; both compute the
// function below, with the rounding points it states.
//
// Replaces the four Pallas TPU backward kernels of
// speech_ssl_compression_tpu/ops/flash_attention.py:
//   * _fa_bwd_dq_kernel and _fa_bwd_dkv_kernel, launched by _flash_bwd_impl,
//     which keep the whole K/V (or Q/dO) of one (b, h) resident in VMEM;
//   * _fa_bwd_dq_stream_kernel and _fa_bwd_dkv_stream_kernel, launched by
//     _flash_bwd_stream past T = 4096 and for rectangular q-vs-k attention
//     (the backward of flash_attention_kv_full), dropout-free.
// The resident/streamed split exists for the TPU's 16 MB scoped VMEM; here
// one dQ kernel covers both dQ kernels and one dK/dV kernel both dK/dV
// kernels, per dtype, for every Tq and Tk.
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
// pass over the key tiles for the two row sums, so it computes S and dPd
// twice.
//
// Padding. Query rows past Tq read q = dO = 0 and D = 0, so dS = 0 and Pd
// meets dO = 0: they add nothing. Keys past Tk get S = -inf, so P = 0.
// Under causal, key tiles above the diagonal are skipped (dQ) and query
// tiles above it are skipped (dK/dV), as the Pallas loop bounds do
// (:525-530, :599-604); the element mask handles the diagonal tile.
//
// Design. Two kernels, as JAX has, so that no gradient needs atomics and
// every run gives the same bits: dQ, a block per (64-query tile, head,
// batch) looping over key tiles, which also computes D; dK/dV, a block per
// (64-key tile, head, batch) looping over query tiles. Both dtypes run on
// the tensor cores (wgmma), fed by TMA through a two-stage ring, with each
// keep bit drawn once per kernel (one Philox call for four keys):
//   * f32 (flash_attn_bwd_f32_sm90.cu): split TF32, three TF32 products
//     per f32 product (hi/lo operands), so the products stay f32-accurate;
//     a split pass writes each tile's hi and lo, transposed where a
//     product sums over the tile's rows;
//   * bf16 (flash_attn_bwd_sm90.cu): bf16 operands, dS and Pd rounded to
//     bf16 in registers.
// Each file's header says what bounds its kernels and what its design
// does about it.

#include <math.h>

#include "flash_common.cuh"

namespace sslc {
// the kernels' launchers (flash_attn_bwd_f32_sm90.cu, flash_attn_bwd_sm90.cu)
cudaError_t launch_bwd_dq_f32_sm90(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* segq, const void* segk,
                                   const void* dout, const void* lse,
                                   void* dd, void* dq, int B, int H, int Tq,
                                   int Tk, int causal, const Dropout& dropout,
                                   cudaStream_t stream);
cudaError_t launch_bwd_dkv_f32_sm90(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* segq, const void* segk,
                                    const void* dout, const void* lse,
                                    const void* dd, void* dk, void* dv,
                                    int B, int H, int Tq, int Tk, int causal,
                                    const Dropout& dropout,
                                    cudaStream_t stream);
cudaError_t launch_bwd_dq_sm90(const void* q, const void* k, const void* v,
                               const void* bias, const void* segq,
                               const void* segk, const void* dout,
                               const void* lse, void* dd, void* dq, int B,
                               int H, int Tq, int Tk, int causal,
                               const Dropout& dropout, cudaStream_t stream);
cudaError_t launch_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                const void* bias, const void* segq,
                                const void* segk, const void* dout,
                                const void* lse, const void* dd, void* dk,
                                void* dv, int B, int H, int Tq, int Tk,
                                int causal, const Dropout& dropout,
                                cudaStream_t stream);
}  // namespace sslc

using namespace sslc;

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
    return launch_bwd_dq_sm90(q, k, v, bias, segq, segk, dout, lse, dd, dq, B,
                              H, Tq, Tk, causal, dropout, s);
  }
  return launch_bwd_dq_f32_sm90(q, k, v, bias, segq, segk, dout, lse, dd, dq,
                                B, H, Tq, Tk, causal, dropout, s);
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
    return launch_bwd_dkv_sm90(q, k, v, bias, segq, segk, dout, lse, dd, dk,
                               dv, B, H, Tq, Tk, causal, dropout, s);
  }
  return launch_bwd_dkv_f32_sm90(q, k, v, bias, segq, segk, dout, lse, dd, dk,
                                 dv, B, H, Tq, Tk, causal, dropout, s);
}

}  // extern "C"
