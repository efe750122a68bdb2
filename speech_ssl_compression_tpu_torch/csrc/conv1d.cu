// Strided 1-D convolution for Hopper (sm_90a), CUDA cores, f32 accumulation:
// the forward, dW and dX kernels of the waveform frontend's layers 1-6, f32
// in, and the dX kernel for bf16 in. The bf16 forward and dW run on the
// tensor cores (conv1d_sm90.cu); the C entry points below route them there.
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
// each of the three is one implicit GEMM whose operands are gathered from
// x, w and dy by index arithmetic, with ragged edges masked in the kernel.
//
//   forward  rows (b, t) x cols o,          reduction over (j, c)
//   dW       rows c x cols o, one j per block, reduction over rows (b, t)
//   dX       rows (b, u) of one phase r = i mod s (i = s u + r) x cols c,
//            reduction over (q, o) with tap j = s q + r and t = u - q
//
// Design. One block of 256 threads computes a 128 x 128 output tile; each
// thread owns an 8 x 8 register micro-tile (rows 4 ty + {0..3} and
// 64 + 4 ty + {0..3}, columns likewise from tx). The reduction walks
// stages of 8, staged as f32 in two shared-memory buffers: the next stage's
// global loads go to registers while the current stage is multiplied, so
// each stage costs one __syncthreads. Each stage's 8 products are summed
// in a register tile before they join the running sum, which cuts the f32
// rounding of long sums (K C = 1536 terms in the forward) by ~3x. C and O
// are multiples of 128 (ops/conv1d.py::_validate), so column tiles and
// reduction stages never straddle a channel edge; rows are masked.
//
// dW sums over B * T_out rows (98,300 at layer 1 of the training batch).
// One block per (j, C tile, O tile) would give 48 blocks for 132 SMs, so
// the rows are split into chunks (a deterministic split-K): each block sums
// one chunk into its own slot of an f32 scratch buffer, and a second kernel
// adds the slots in a fixed order. No atomics anywhere: every gradient is
// the same bits run to run.
//
// What bounds it. Every kernel does 2 B T_out K C O FLOPs (300 GFLOP for
// one pass over layers 1-6 at the training batch) against at most a few
// hundred MB of traffic, so it is bound by arithmetic: the CUDA cores' f32
// FMA rate (67 TFLOP/s on an H100 SXM) here, also for bf16 dX. What this
// simple design leaves on the table: the tensor cores (conv1d_sm90.cu
// takes them for the bf16 forward and dW; TF32 breaks the f32 route's
// 1e-5 bar), TMA loads into a deeper ring, and occupancy (with the two
// 8 x 8 register tiles ptxas gives the kernels 197-219 registers, no
// spills: one block of 8 warps per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sslc {
// the bf16 forward and dW partial sums (conv1d_sm90.cu)
cudaError_t launch_conv1d_fwd_sm90(const void* x, const void* w, void* out,
                                   int B, int T_in, int C, int K, int O,
                                   int stride, cudaStream_t s);
cudaError_t launch_conv1d_dw_sm90(const void* x, const void* dy, float* slots,
                                  int B, int T_in, int C, int K, int O,
                                  int stride, int chunk, int n_split,
                                  cudaStream_t s);
}  // namespace sslc

namespace {

constexpr int kBM = 128;      // output rows per block
constexpr int kBN = 128;      // output columns per block
constexpr int kBK = 8;        // reduction depth of one shared-memory stage
constexpr int kThreads = 256;
constexpr int kLdA = kBM + 4;  // padded smem row strides (floats): a multiple
constexpr int kLdB = kBN + 4;  // of 4 keeps float4 alignment

// Four consecutive elements as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ float4 load4_or_zero(const T* p) {
  return p != nullptr ? load4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// A 4-element chunk of reduction indices k4 .. k4 + 3 of operand row `row`,
// written transposed into a (kBK, ld) tile: tile[k][row].
__device__ __forceinline__ void put_transposed(float* tile, int ld, int row,
                                               int k4, float4 v) {
  tile[(k4 + 0) * ld + row] = v.x;
  tile[(k4 + 1) * ld + row] = v.y;
  tile[(k4 + 2) * ld + row] = v.z;
  tile[(k4 + 3) * ld + row] = v.w;
}

// Row (or column) index of entry i of a thread's 8-wide micro-tile.
__device__ __forceinline__ int micro(int t, int i) {
  return (i < 4 ? 0 : 64) + 4 * t + (i & 3);
}

// One stage: acc[i][j] += sum_k A[k][row i] * B[k][col j], the stage's 8
// products summed in a register tile first.
__device__ __forceinline__ void multiply_stage(const float* As,
                                               const float* Bs, int tx,
                                               int ty, float acc[8][8]) {
  float part[8][8];
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * kLdA + 4 * ty);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + k * kLdA + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kLdB + 4 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * kLdB + 64 + 4 * tx);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part[i][j] = k == 0 ? a[i] * b[j] : fmaf(a[i], b[j], part[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
}

// The stage pipeline shared by the three kernels. `fetch(stage, a, b)`
// loads this thread's share of a stage into registers; `put(As, Bs, a, b)`
// stores it into one buffer's shared tiles.
template <typename Fetch, typename Put>
__device__ __forceinline__ void run_stages(int n_stages, float (*As)[kBK * kLdA],
                                           float (*Bs)[kBK * kLdB], int tx,
                                           int ty, float acc[8][8],
                                           Fetch fetch, Put put) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float4 ra, rb;
  fetch(0, ra, rb);
  put(As[0], Bs[0], ra, rb);
  __syncthreads();
  for (int st = 0; st < n_stages; ++st) {
    const int cur = st & 1;
    const bool more = st + 1 < n_stages;
    if (more) fetch(st + 1, ra, rb);
    multiply_stage(As[cur], Bs[cur], tx, ty, acc);
    if (more) put(As[cur ^ 1], Bs[cur ^ 1], ra, rb);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv1d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ out, int B, int T_in, int C, int K, int O,
                  int stride, int T_out) {
  __shared__ __align__(16) float As[2][kBK * kLdA];
  __shared__ __align__(16) float Bs[2][kBK * kLdB];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long M = (long long)B * T_out;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A: output row (b, t) reads x row s t + j, channels c0 + a_k4 .. + 3
  const int a_row = tid >> 1, a_k4 = (tid & 1) * 4;
  const T* a_base = nullptr;
  if (m0 + a_row < M) {
    const long long m = m0 + a_row;
    const long long b = m / T_out, t = m - b * T_out;
    a_base = x + (b * T_in + t * stride) * C + a_k4;
  }
  // B: reduction row (j, c0 + b_k) of w, columns n0 + b_n4 .. + 3
  const int b_k = tid >> 5, b_n4 = (tid & 31) * 4;
  const T* b_base = w + (size_t)b_k * O + n0 + b_n4;
  const int c_stages = C / kBK;

  auto fetch = [&](int st, float4& ra, float4& rb) {
    const int j = st / c_stages;
    const int c0 = (st - j * c_stages) * kBK;
    ra = load4_or_zero(a_base ? a_base + (size_t)j * C + c0 : nullptr);
    rb = load4(b_base + ((size_t)j * C + c0) * O);
  };
  auto put = [&](float* as, float* bs, float4 ra, float4 rb) {
    put_transposed(as, kLdA, a_row, a_k4, ra);
    store4(bs + b_k * kLdB + b_n4, rb);
  };
  float acc[8][8];
  run_stages(K * c_stages, As, Bs, tx, ty, acc, fetch, put);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + micro(ty, i);
    if (m >= M) continue;
    T* row = out + m * O + n0;
    store4(row + 4 * tx,
           make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    store4(row + 64 + 4 * tx,
           make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

// ---------------------------------------------------------------------------
// dW: per-chunk partial sums, then a fixed-order reduction over the chunks
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv1d_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 float* __restrict__ partial, int B, int T_in, int C, int K,
                 int O, int stride, int T_out, int chunk) {
  __shared__ __align__(16) float As[2][kBK * kLdA];
  __shared__ __align__(16) float Bs[2][kBK * kLdB];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int j = blockIdx.z % K;
  const int split = blockIdx.z / K;
  const long long M = (long long)B * T_out;
  const long long r_begin = (long long)split * chunk;
  const long long r_end = min(M, r_begin + chunk);
  const int n_stages = (int)((r_end - r_begin + kBK - 1) / kBK);

  // both operands: reduction row r = (b, t) of this stage, 4 contiguous
  // channels (A: x row s t + j) or output columns (B: dy row r)
  const int k = tid >> 5, k4 = (tid & 31) * 4;

  auto fetch = [&](int st, float4& ra, float4& rb) {
    const long long r = r_begin + (long long)st * kBK + k;
    if (r < r_end) {
      const long long b = r / T_out, t = r - b * T_out;
      ra = load4(x + (b * T_in + t * stride + j) * C + c0 + k4);
      rb = load4(dy + r * O + n0 + k4);
    } else {
      ra = rb = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put = [&](float* as, float* bs, float4 ra, float4 rb) {
    store4(as + k * kLdA + k4, ra);
    store4(bs + k * kLdB + k4, rb);
  };
  float acc[8][8];
  run_stages(n_stages, As, Bs, tx, ty, acc, fetch, put);

  float* slot = partial + ((size_t)split * K + j) * C * O;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = slot + (size_t)(c0 + micro(ty, i)) * O + n0;
    store4(row + 4 * tx,
           make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    store4(row + 64 + 4 * tx,
           make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
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
  store4(dw + e, acc);
}

// ---------------------------------------------------------------------------
// dX
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv1d_dx_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                 T* __restrict__ dx, int B, int T_in, int C, int K, int O,
                 int stride, int T_out, int U) {
  __shared__ __align__(16) float As[2][kBK * kLdA];
  __shared__ __align__(16) float Bs[2][kBK * kLdB];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r = blockIdx.z;  // phase: input rows i = s u + r
  const long long M = (long long)B * U;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int n_taps = (K - r + stride - 1) / stride;  // taps j = s q + r < K
  const int o_stages = O / kBK;

  // A: row (b, u) reads dy row t = u - q, outputs o0 + a_k4 .. + 3
  const int a_row = tid >> 1, a_k4 = (tid & 1) * 4;
  long long a_b = -1, a_u = 0;
  if (m0 + a_row < M) {
    const long long m = m0 + a_row;
    a_b = m / U;
    a_u = m - a_b * U;
    if (a_u * stride + r >= T_in) a_b = -1;  // past the input's end
  }
  // B (transposed): w[j, n0 + b_row, o0 + b_k4 .. + 3] -> Bs[k][b_row]
  const int b_row = a_row, b_k4 = a_k4;

  auto fetch = [&](int st, float4& ra, float4& rb) {
    const int q = st / o_stages;
    const int o0 = (st - q * o_stages) * kBK;
    const long long t = a_u - q;
    const T* pa = (a_b >= 0 && t >= 0 && t < T_out)
                      ? dy + (a_b * T_out + t) * O + o0 + a_k4
                      : nullptr;
    ra = load4_or_zero(pa);
    const int j = q * stride + r;
    rb = load4(w + ((size_t)j * C + n0 + b_row) * O + o0 + b_k4);
  };
  auto put = [&](float* as, float* bs, float4 ra, float4 rb) {
    put_transposed(as, kLdA, a_row, a_k4, ra);
    put_transposed(bs, kLdB, b_row, b_k4, rb);
  };
  float acc[8][8];
  run_stages(n_taps * o_stages, As, Bs, tx, ty, acc, fetch, put);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + micro(ty, i);
    if (m >= M) continue;
    const long long b = m / U, u = m - b * U;
    const long long row_in = u * stride + r;
    if (row_in >= T_in) continue;
    T* row = dx + (b * T_in + row_in) * C + n0;
    store4(row + 4 * tx,
           make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    store4(row + 64 + 4 * tx,
           make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

int out_len(int T_in, int K, int stride) { return (T_in - K) / stride + 1; }

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

cudaError_t launch_fwd_f32(const void* x, const void* w, void* out, int B,
                           int T_in, int C, int K, int O, int stride,
                           cudaStream_t s) {
  const int T_out = out_len(T_in, K, stride);
  const dim3 grid((unsigned)cdiv((long long)B * T_out, kBM), O / kBN);
  conv1d_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), B, T_in, C, K, O, stride, T_out);
  return cudaGetLastError();
}

// The partial sums (f32: chunks of `chunk` rows of B * T_out; bf16: of
// `chunk` 64-row steps, conv1d_sm90.cu), then their fixed-order sum.
cudaError_t launch_dw(const void* x, const void* dy, void* partial, void* dw,
                      int B, int T_in, int C, int K, int O, int stride,
                      int chunk, int n_split, int is_bf16, cudaStream_t s) {
  const int T_out = out_len(T_in, K, stride);
  float* slots = static_cast<float*>(n_split == 1 ? dw : partial);
  cudaError_t err;
  if (is_bf16) {
    err = sslc::launch_conv1d_dw_sm90(x, dy, slots, B, T_in, C, K, O, stride,
                                      chunk, n_split, s);
  } else {
    const dim3 grid(C / kBM, O / kBN, K * n_split);
    conv1d_dw_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), slots, B,
        T_in, C, K, O, stride, T_out, chunk);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || n_split == 1) return err;
  const long long n = (long long)K * C * O;
  conv1d_dw_reduce_kernel<<<(unsigned)cdiv(n / 4, 256), 256, 0, s>>>(
      slots, static_cast<float*>(dw), n, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const void* dy, const void* w, void* dx, int B,
                      int T_in, int C, int K, int O, int stride,
                      cudaStream_t s) {
  const int T_out = out_len(T_in, K, stride);
  const int U = (int)cdiv(T_in, stride);
  const dim3 grid((unsigned)cdiv((long long)B * U, kBM), C / kBN, stride);
  conv1d_dx_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w),
      static_cast<T*>(dx), B, T_in, C, K, O, stride, T_out, U);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, T_in, C), w (K, C, O), out (B, T_out, O); contiguous, f32
// (is_bf16 = 0) or bf16, 16-byte aligned, C and O multiples of 128,
// stride <= K (bf16: stride <= 8). Launches on `stream` of CUDA device
// `device` and returns cudaGetLastError() after the launch (0 on success).
int sslc_conv1d_fwd(const void* x, const void* w, void* out, int B, int T_in,
                    int C, int K, int O, int stride, int is_bf16, int device,
                    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return sslc::launch_conv1d_fwd_sm90(x, w, out, B, T_in, C, K, O, stride,
                                        s);
  return launch_fwd_f32(x, w, out, B, T_in, C, K, O, stride, s);
}

// dW (K, C, O) f32 from x (B, T_in, C) and dy (B, T_out, O) of one dtype.
// The reduction is cut into n_split chunks of `chunk` units: f32, rows of
// B * T_out (a multiple of 8); bf16, 64-row steps of one batch row each,
// T_out / 64 rounded up a batch, in (b, t) order
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

// dX (B, T_in, C) in dy's dtype from dy (B, T_out, O) and w (K, C, O).
int sslc_conv1d_dx(const void* dy, const void* w, void* dx, int B, int T_in,
                   int C, int K, int O, int stride, int is_bf16, int device,
                   void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dx<__nv_bfloat16>(dy, w, dx, B, T_in, C, K, O, stride, s);
  return launch_dx<float>(dy, w, dx, B, T_in, C, K, O, stride, s);
}

}  // extern "C"
