// Strided 1-D convolution for Hopper (sm_90a): the C entry points of the
// forward, dW and dX for both input dtypes, and the kernel that adds dW's
// partial sums. Every conv kernel runs on the tensor cores: f32 in split
// TF32 (conv1d_f32_sm90.cu), bf16 in bf16 (conv1d_sm90.cu); the C entry
// points below route each dtype there.
//
// Replaces the three Pallas TPU kernels of
// speech_ssl_compression_tpu/ops/conv1d.py:
//   * _fwd_kernel (launched by _conv1d_fwd):
//       out[b, t, o] = sum_j sum_c x[b, s t + j, c] w[j, c, o]
//     x (B, T_in, C), w (K, C, O), VALID, stride s, out (B, T_out, O) in x's
//     dtype, T_out = (T_in - K) / s + 1;
//   * _dw_kernel (launched by _conv1d_dw):
//       dW[j, c, o] = sum_{b, t} x[b, s t + j, c] dy[b, t, o]     (f32 out);
//   * _dx_kernel (launched by _conv1d_dx):
//       dX[b, i, c] = sum_{j, t : s t + j = i} sum_o dy[b, t, o] w[j, c, o]
//     in dy's dtype; rows no output reaches are 0.
// The TPU kernels fold the stride into the lane axis (a (B, T/s, s C) view)
// and pad rows (_SLACK) so every tap is a contiguous VMEM slice; those are
// layout tricks for the TPU's vector memory and are not carried over. Here
// each of the three is one implicit GEMM whose operands TMA gathers from x,
// w and dy (one map per stride phase for x), the two kernel files' headers
// say how.
//
// dW sums over B * T_out rows (98,300 at layer 1 of the training batch).
// One block per (j, C tile, O tile) would give 48 blocks for 132 SMs, so
// the rows are split into chunks (a deterministic split-K): each block sums
// one chunk into its own slot of an f32 scratch buffer, and
// conv1d_dw_reduce_kernel below adds the slots in chunk order. No atomics
// anywhere: every gradient is the same bits run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace sslc {
// the f32 forward, dW partial sums and dX (conv1d_f32_sm90.cu)
cudaError_t launch_conv1d_fwd_f32_sm90(const void* x, const void* w,
                                       void* wt, void* out, int B, int T_in,
                                       int C, int K, int O, int stride,
                                       cudaStream_t s);
cudaError_t launch_conv1d_dw_f32_sm90(const void* x, const void* dy,
                                      float* slots, int B, int T_in, int C,
                                      int K, int O, int stride, int chunk,
                                      int n_split, cudaStream_t s);
cudaError_t launch_conv1d_dx_f32_sm90(const void* dy, const void* w,
                                      void* ws, void* dx, int B, int T_in,
                                      int C, int K, int O, int stride,
                                      cudaStream_t s);
// the bf16 forward, dW partial sums and dX (conv1d_sm90.cu)
cudaError_t launch_conv1d_fwd_sm90(const void* x, const void* w, void* out,
                                   int B, int T_in, int C, int K, int O,
                                   int stride, cudaStream_t s);
cudaError_t launch_conv1d_dw_sm90(const void* x, const void* dy, float* slots,
                                  int B, int T_in, int C, int K, int O,
                                  int stride, int chunk, int n_split,
                                  cudaStream_t s);
cudaError_t launch_conv1d_dx_sm90(const void* dy, const void* w, void* dx,
                                  int B, int T_in, int C, int K, int O,
                                  int stride, cudaStream_t s);
}  // namespace sslc

namespace {

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dw[e] = sum over splits, in split order, of partial[split][e]
__global__ void conv1d_dw_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ dw, long long n,
                                        int n_split) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= n) return;
  float4 acc = load4(partial + e);
  for (int s = 1; s < n_split; ++s) {
    const float4 v = load4(partial + (size_t)s * n + e);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  *reinterpret_cast<float4*>(dw + e) = acc;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The partial sums (chunks of `chunk` reduction steps: 32 rows t of one
// batch for f32, 64 for bf16), then their fixed-order sum.
cudaError_t launch_dw(const void* x, const void* dy, void* partial, void* dw,
                      int B, int T_in, int C, int K, int O, int stride,
                      int chunk, int n_split, int is_bf16, cudaStream_t s) {
  float* slots = static_cast<float*>(n_split == 1 ? dw : partial);
  const cudaError_t err =
      is_bf16 ? sslc::launch_conv1d_dw_sm90(x, dy, slots, B, T_in, C, K, O,
                                            stride, chunk, n_split, s)
              : sslc::launch_conv1d_dw_f32_sm90(x, dy, slots, B, T_in, C, K,
                                                O, stride, chunk, n_split, s);
  if (err != cudaSuccess || n_split == 1) return err;
  const long long n = (long long)K * C * O;
  conv1d_dw_reduce_kernel<<<(unsigned)cdiv(n / 4, 256), 256, 0, s>>>(
      slots, static_cast<float*>(dw), n, n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, T_in, C), w (K, C, O), out (B, T_out, O); contiguous, f32
// (is_bf16 = 0) or bf16, 16-byte aligned, C and O multiples of 128,
// stride <= K and stride <= 8 (one TMA map per stride phase); f32 also
// takes `wt`, scratch of 2 O K C floats for w^T's split (null for bf16).
// Launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() after the launch (0 on success).
int sslc_conv1d_fwd(const void* x, const void* w, void* wt, void* out, int B,
                    int T_in, int C, int K, int O, int stride, int is_bf16,
                    int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return sslc::launch_conv1d_fwd_sm90(x, w, out, B, T_in, C, K, O, stride,
                                        s);
  return sslc::launch_conv1d_fwd_f32_sm90(x, w, wt, out, B, T_in, C, K, O,
                                          stride, s);
}

// dW (K, C, O) f32 from x (B, T_in, C) and dy (B, T_out, O) of one dtype,
// stride <= 8 (one TMA map per stride phase of x). The reduction is cut
// into n_split chunks of `chunk` steps of one batch row each, T_out / 32
// (f32) or T_out / 64 (bf16) rounded up a batch, in (b, t) order
// (ops/conv1d.py::dw_tile_splits). With n_split > 1, `partial` is f32
// scratch of n_split * K * C * O floats, summed into dw in chunk order.
int sslc_conv1d_dw(const void* x, const void* dy, void* partial, void* dw,
                   int B, int T_in, int C, int K, int O, int stride, int chunk,
                   int n_split, int is_bf16, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_dw(x, dy, partial, dw, B, T_in, C, K, O, stride, chunk,
                   n_split, is_bf16, static_cast<cudaStream_t>(stream));
}

// dX (B, T_in, C) in dy's dtype from dy (B, T_out, O) and w (K, C, O), any
// stride; f32 also takes `ws`, scratch of 2 K C O floats for w's split
// (null for bf16).
int sslc_conv1d_dx(const void* dy, const void* w, void* ws, void* dx, int B,
                   int T_in, int C, int K, int O, int stride, int is_bf16,
                   int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return sslc::launch_conv1d_dx_sm90(dy, w, dx, B, T_in, C, K, O, stride,
                                       s);
  return sslc::launch_conv1d_dx_f32_sm90(dy, w, ws, dx, B, T_in, C, K, O,
                                         stride, s);
}

}  // extern "C"
