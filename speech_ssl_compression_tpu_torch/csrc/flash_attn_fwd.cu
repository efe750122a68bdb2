// Flash-attention forward for Hopper (sm_90a), with optional in-kernel
// attention dropout: the C entry point for both input dtypes. f32 inputs go
// to the split-TF32 kernel of flash_attn_fwd_f32_sm90.cu, bf16 inputs to
// the kernel of flash_attn_fwd_sm90.cu; both compute the function below.
//
// Replaces the two Pallas TPU forward kernels of
// speech_ssl_compression_tpu/ops/flash_attention.py:
//   * _fa_fwd_kernel (both branches: dropout-free and dropout, with
//     _tile_keep_mask), launched by _flash_fwd_impl, which keeps the whole
//     K/V of one (b, h) resident in VMEM;
//   * _fa_fwd_stream_kernel, launched by _flash_fwd_stream past T = 4096
//     and for rectangular q-vs-k attention (flash_attention_kv_full).
// The split between the two, and the tile planners beside them, exist for
// the TPU's 16 MB scoped VMEM; here one kernel per dtype covers every Tq
// and Tk.
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
// Design. Both dtypes run on the tensor cores (wgmma), K and V fed by TMA
// through a two-stage ring, with each keep bit drawn once (one Philox call
// for four keys):
//   * f32 (flash_attn_fwd_f32_sm90.cu): split TF32, three TF32 products
//     per f32 product (split_tf32.cuh), 32-key tiles, each tile's P V in a
//     fresh accumulator joined by the online-softmax rescale;
//   * bf16 (flash_attn_fwd_sm90.cu): bf16 operands, 64-key tiles, P rounded
//     to bf16 in registers.
// Each file's header says what bounds its kernel and what its design does
// about it.

#include <math.h>

#include "flash_common.cuh"

namespace sslc {
// the kernels' launchers (flash_attn_fwd_f32_sm90.cu, flash_attn_fwd_sm90.cu)
cudaError_t launch_fwd_f32_sm90(const void* q, const void* k, const void* v,
                                const void* bias, const void* segq,
                                const void* segk, void* o, void* lse, int B,
                                int H, int Tq, int Tk, int causal,
                                const Dropout& dropout, cudaStream_t stream);
cudaError_t launch_fwd_sm90(const void* q, const void* k, const void* v,
                            const void* bias, const void* segq,
                            const void* segk, void* o, void* lse, int B,
                            int H, int Tq, int Tk, int causal,
                            const Dropout& dropout, cudaStream_t stream);
}  // namespace sslc

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
  const sslc::Dropout dropout =
      sslc::make_dropout(use_dropout, keep_threshold, keep_scale, seed);
  if (is_bf16) {
    return sslc::launch_fwd_sm90(q, k, v, bias, segq, segk, o, lse, B, H, Tq,
                                 Tk, causal, dropout, s);
  }
  return sslc::launch_fwd_f32_sm90(q, k, v, bias, segq, segk, o, lse, B, H,
                                   Tq, Tk, causal, dropout, s);
}

const char* sslc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
