// Strided 1-D convolution for Hopper (sm_90a) in bf16: the forward, dW and
// dX kernels on the tensor cores (wgmma), their operands fed by TMA through
// a ring of shared-memory stages.
//
// Replaces, for bf16 inputs, the three Pallas TPU kernels of
// speech_ssl_compression_tpu/ops/conv1d.py:
//   * _fwd_kernel (launched by _conv1d_fwd):
//       out[b, t, o] = sum_j sum_c x[b, s t + j, c] w[j, c, o]   (bf16 out)
//   * _dw_kernel (launched by _conv1d_dw):
//       dW[j, c, o] = sum_{b, t} x[b, s t + j, c] dy[b, t, o]     (f32 out)
//   * _dx_kernel (launched by _conv1d_dx):
//       dX[b, i, c] = sum_{j, t : s t + j = i} sum_o dy[b, t, o] w[j, c, o]
//     (bf16 out; rows no output reaches are 0)
// with x (B, T_in, C), w (K, C, O), dy (B, T_out, O), T_out = (T_in - K) / s
// + 1. For f32 inputs the three run in split TF32 (conv1d_f32_sm90.cu,
// whose header states the same functions); conv1d.cu routes bf16 here. The
// kernels sum in
// f32 and round only their outputs, as the plain version
// (ops/conv1d.py::conv1d_strided_plain) does; the tensor cores add the
// products in another order, so an output whose f32 sum lies near a bf16
// rounding point may round the other way (one ulp).
//
// The stride, in TMA terms. Write a tap as j = s q + r (phase r = j mod s).
// The rows x[b, s t + j, :] for consecutive t are rows t + q of a matrix
// with base x + r C, row stride s C, n_r = (T_in - 1 - r) / s + 1 rows per
// batch and batch stride T_in C: one 3-D tensor map {C, n_r, B} per phase
// (ops/conv1d.py::phase_rows gives the same n_r), s maps for every tap. A
// tap only offsets the row coordinate by q; rows past n_r read as zeros
// and never reach the next batch's rows. Every row an output t < T_out
// reads lies below n_r. This is what the TPU kernel's stride fold did.
// The maps travel in the kernel's parameters, so the forward and dW take
// s <= kMaxStride (the wrapper raises past it). dX reads no x and stores
// its rows directly, so it takes any stride.
//
//   forward  rows (b, t) x cols o, reduction over (j, c): A = x rows
//            (K-major: 64 channels a box row), B = w[j] (MN-major: o is
//            contiguous); a row tile never straddles a batch.
//   dW       rows c x cols o, one tap j per block, reduction over rows
//            (b, t): A = x^T (MN-major: c is contiguous), B = dy
//            (MN-major); a reduction step is 64 rows t of one batch.
//   dX       one GEMM per phase r: input rows i = s u + r, so
//              dx[b, s u + r, c] = sum_q sum_o dy[b, u - q, o] w[s q + r, c, o]
//            over the taps q < ceil((K - r) / s). Rows (b, u < n_r) x cols
//            c, reduction over (q, o): A = dy rows u - q (K-major: o is
//            contiguous), B = w[j] with c as its rows (K-major: o runs
//            along the reduction). dy rows before 0 or past T_out read as
//            zeros (TMA fills a box that starts at a negative row too), so
//            the first and last rows need no masking, and a row no output
//            reaches sums zeros and stores 0. A row tile never straddles a
//            batch.
//
// Design. A block computes a 128 x 128 output tile with two consumer
// warpgroups (rows 0-63 and 64-127, m64n128k16 products, f32 accumulators,
// 64 registers a thread) and one producer warp. A ring stage holds one
// reduction step of 64: four 64 x 64 boxes (the two halves of A, the two
// of B: 32 KB), loaded by TMA with the 128-byte swizzle wgmma reads, and
// completing on the stage's "full" mbarrier; the consumers release a stage
// on its "empty" mbarrier once the products that read it are done, keeping
// one step's products in flight. Three stages (97 KB) let two blocks share
// an SM, so one block's epilogue overlaps the other's products.
// The forward rounds its tile to bf16 once and stores the rows t < T_out;
// dX likewise stores its rows u < n_r at input row s u + r, each element
// summed by one block in one fixed order (no split-K: the same bits run to
// run). The phase with the most taps (r = 0) has the longest reduction, so
// its blocks come first in the grid.
// dW keeps a deterministic split-K, as the f32 dW does: the batch's
// 64-row steps are cut into n_split chunks in (b, t) order
// (ops/conv1d.py::dw_tile_splits), each block sums one chunk for one tap
// into its own f32 slot, and conv1d.cu's reduce kernel adds the slots in
// chunk order: no atomics, the same bits run to run.
//
// What bounds it. Each kernel does 2 B T_out K C O FLOPs against a few
// hundred MB: ~150 GFLOP and ~0.3 GB at HuBERT's layer 1 in the training
// batch, so the tensor cores' rate bounds it (989 TFLOP/s bf16, ~0.16 ms),
// not the bytes (~0.09 ms at 3.35 TB/s). The design keeps the tensor cores
// fed from shared memory and leaves address work to TMA.

#include "sm90_common.cuh"

namespace sslc {
namespace {

constexpr int kMaxStride = 8;         // per-phase maps a launch can carry
constexpr int kConvTile = 128;        // output rows and columns per block
constexpr int kConvStep = 64;         // reduction depth of one ring stage
constexpr int kConvStages = 3;
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kConvThreads = 32 * (kConsumerWarps + 1);  // + the producer
constexpr uint32_t kStageBytes = 4 * kTileBytes;          // 32 KB
constexpr size_t kConvSmemBytes =
    kConvStages * (size_t)kStageBytes + 2 * kConvStages * 8 + 1024;

static_assert(kConvStep == kTile, "a ring box is one 64 x 64 tile");

struct PhaseMaps {
  CUtensorMap phase[kMaxStride];
};

// The ring: stage st's boxes at ring + st * kStageBytes (A0, A1, B0, B1),
// then kConvStages "full" and kConvStages "empty" mbarriers.
struct Ring {
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;

  __device__ Ring(uint8_t* smem_raw) {
    stages = align_1024(smem_raw);
    full = reinterpret_cast<uint64_t*>(stages + kConvStages * kStageBytes);
    empty = full + kConvStages;
  }
  __device__ uint8_t* stage(int st) const { return stages + st * kStageBytes; }
};

// Run by thread 0 before the block's first __syncthreads.
__device__ __forceinline__ void init_ring(const Ring& ring) {
  for (int i = 0; i < kConvStages; ++i) {
    mbar_init(&ring.full[i], 1);
    mbar_init(&ring.empty[i], kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's wait before it refills stage `st` for step kt: the
// consumers have released that stage's previous use.
__device__ __forceinline__ uint8_t* acquire_stage(const Ring& ring, int kt) {
  const int st = kt % kConvStages;
  if (kt >= kConvStages) mbar_wait(&ring.empty[st], (kt / kConvStages - 1) & 1);
  mbar_expect_tx(&ring.full[st], kStageBytes);
  return ring.stage(st);
}

// The consumers' loop over n_steps ring stages: wait for a stage, issue its
// four k16 products (A at a_offset in the stage, B at its third box; a_step
// and b_step are each operand's bytes per 16 along the reduction: 32 for a
// K-major operand, 2048 for an MN-major one), commit, and release the
// previous stage once its products are done.
template <int kTransA, int kTransB>
__device__ __forceinline__ void consume(const Ring& ring, int n_steps,
                                        uint32_t a_offset, uint32_t a_step,
                                        uint32_t b_step, float (&acc)[64]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_steps; ++kt) {
    const int st = kt % kConvStages;
    mbar_wait(&ring.full[st], (kt / kConvStages) & 1);
    const uint8_t* s = ring.stage(st);
    const uint64_t da = box_desc(s + a_offset, kTileBytes);
    const uint64_t db = box_desc(s + 2 * kTileBytes, kTileBytes);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128<kTransA, kTransB>(acc, da + kk * (a_step >> 4),
                                      db + kk * (b_step >> 4), 1);
    wgmma_commit();
    wgmma_wait<1>();  // step kt - 1's products are done with their stage
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&ring.empty[(kt - 1) % kConvStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Block tile: output rows t0 .. t0 + 127 of batch b (t_tiles row tiles a
// batch), columns n0 .. n0 + 127; the column tile runs fastest, so the
// O / 128 blocks that read one x row tile run together.
__global__ void __launch_bounds__(kConvThreads, 2)
conv1d_fwd_bf16_kernel(const __grid_constant__ PhaseMaps xm,
                       const __grid_constant__ CUtensorMap wm,
                       __nv_bfloat16* __restrict__ out, int C, int K, int O,
                       int stride, int T_out, int t_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const Ring ring(smem_raw);
  const int n_col = O / kConvTile;
  const int n0 = (blockIdx.x % n_col) * kConvTile;
  const int row_tile = blockIdx.x / n_col;
  const int b = row_tile / t_tiles;
  const int t0 = (row_tile % t_tiles) * kConvTile;
  const int c_steps = C / kConvStep;
  const int n_steps = K * c_steps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) init_ring(ring);
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer: step kt is tap j, channels c0
    if (lane == 0) {
      for (int kt = 0; kt < n_steps; ++kt) {
        const int j = kt / c_steps, c0 = (kt % c_steps) * kConvStep;
        const CUtensorMap* xmap = &xm.phase[j % stride];
        const int row = t0 + j / stride;
        uint8_t* s = acquire_stage(ring, kt);
        uint64_t* bar = &ring.full[kt % kConvStages];
        tma_load_3d(s, xmap, bar, c0, row, b);
        tma_load_3d(s + kTileBytes, xmap, bar, c0, row + kTile, b);
        tma_load_2d(s + 2 * kTileBytes, &wm, bar, n0, j * C + c0);
        tma_load_2d(s + 3 * kTileBytes, &wm, bar, n0 + kTile, j * C + c0);
      }
    }
    return;
  }

  // consumers: warpgroup wg computes output rows 64 wg .. 64 wg + 63; A is
  // K-major (step 16 channels: +32 bytes), B MN-major (16 rows: +2048)
  const int wg = warp >> 2;
  float acc[64];
  consume<0, 1>(ring, n_steps, wg * kTileBytes, 32, 2048, acc);

  // thread (warp, lane) holds rows 16 (warp % 4) + lane / 4 + 8 i of its
  // warpgroup's 64, columns 8 c8 + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * i;
    if (t >= T_out) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + ((size_t)b * T_out + t) * O + n0);
#pragma unroll
    for (int c8 = 0; c8 < 16; ++c8)
      dst[4 * c8 + (lane & 3)] =
          pack_bf16(acc[4 * c8 + 2 * i], acc[4 * c8 + 2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// dW: one f32 slot per (chunk, tap); conv1d.cu's reduce kernel adds them
// ---------------------------------------------------------------------------

// Block: channels c0 .. c0 + 127 (blockIdx.x), outputs n0 .. n0 + 127
// (blockIdx.y), tap j and chunk `split` (blockIdx.z = split K + j). Step i
// of the (b, t) order is batch i / t_steps, rows 64 (i % t_steps) .. + 63;
// the chunk is steps split * chunk .. min(total, (split + 1) chunk) - 1.
__global__ void __launch_bounds__(kConvThreads, 2)
conv1d_dw_bf16_kernel(const __grid_constant__ PhaseMaps xm,
                      const __grid_constant__ CUtensorMap dym,
                      float* __restrict__ partial, int C, int K, int O,
                      int stride, int t_steps, int total, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  const Ring ring(smem_raw);
  const int c0 = blockIdx.x * kConvTile;
  const int n0 = blockIdx.y * kConvTile;
  const int j = blockIdx.z % K;
  const int split = blockIdx.z / K;
  const int first = split * chunk;
  const int n_steps = max(0, min(total, first + chunk) - first);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) init_ring(ring);
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      const CUtensorMap* xmap = &xm.phase[j % stride];
      const int q = j / stride;
      for (int kt = 0; kt < n_steps; ++kt) {
        const int i = first + kt;
        const int b = i / t_steps, t = (i % t_steps) * kConvStep;
        uint8_t* s = acquire_stage(ring, kt);
        uint64_t* bar = &ring.full[kt % kConvStages];
        tma_load_3d(s, xmap, bar, c0, t + q, b);
        tma_load_3d(s + kTileBytes, xmap, bar, c0 + kTile, t + q, b);
        tma_load_3d(s + 2 * kTileBytes, &dym, bar, n0, t, b);
        tma_load_3d(s + 3 * kTileBytes, &dym, bar, n0 + kTile, t, b);
      }
    }
    return;
  }

  // warpgroup wg: channels 64 wg .. 64 wg + 63, A and B MN-major (step 16
  // rows: +2048 bytes)
  const int wg = warp >> 2;
  float acc[64];
  consume<1, 1>(ring, n_steps, wg * kTileBytes, 2048, 2048, acc);

  float* slot = partial + ((size_t)split * K + j) * C * O;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c0 + 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * i;
    float2* dst = reinterpret_cast<float2*>(slot + (size_t)c * O + n0);
#pragma unroll
    for (int c8 = 0; c8 < 16; ++c8)
      dst[4 * c8 + (lane & 3)] =
          make_float2(acc[4 * c8 + 2 * i], acc[4 * c8 + 2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// dX: one GEMM per stride phase, rounded to bf16 and stored directly
// ---------------------------------------------------------------------------

// Block: phase r, batch b, phase rows u0 .. u0 + 127, channels c0 .. c0 +
// 127; in the linear order (r, b, u tile, c tile) the column tile runs
// fastest (the C / 128 blocks that read one dy row tile run together) and
// phase 0 comes first. Step kt is tap q = kt / o_steps (j = s q + r),
// outputs o0 = 64 (kt % o_steps) .. + 63. u_tiles row tiles cover phase
// 0's n_0 rows; a later phase may have one row fewer, and a tile past its
// rows has nothing to do.
__global__ void __launch_bounds__(kConvThreads, 2)
conv1d_dx_bf16_kernel(const __grid_constant__ CUtensorMap dym,
                      const __grid_constant__ CUtensorMap wm,
                      __nv_bfloat16* __restrict__ dx, int B, int T_in, int C,
                      int K, int O, int stride, int u_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const int n_col = C / kConvTile;
  const int c0 = (blockIdx.x % n_col) * kConvTile;
  const int row_tile = blockIdx.x / n_col;
  const int u0 = (row_tile % u_tiles) * kConvTile;
  const int b = row_tile / u_tiles % B;
  const int r = row_tile / u_tiles / B;
  const int n_r = (T_in - 1 - r) / stride + 1;  // phase rows a batch
  if (u0 >= n_r) return;
  const Ring ring(smem_raw);
  const int o_steps = O / kConvStep;
  const int n_steps = (K - r + stride - 1) / stride * o_steps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) init_ring(ring);
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      for (int kt = 0; kt < n_steps; ++kt) {
        const int q = kt / o_steps, o0 = (kt % o_steps) * kConvStep;
        const int j = q * stride + r;
        uint8_t* s = acquire_stage(ring, kt);
        uint64_t* bar = &ring.full[kt % kConvStages];
        tma_load_3d(s, &dym, bar, o0, u0 - q, b);
        tma_load_3d(s + kTileBytes, &dym, bar, o0, u0 - q + kTile, b);
        tma_load_2d(s + 2 * kTileBytes, &wm, bar, o0, j * C + c0);
        tma_load_2d(s + 3 * kTileBytes, &wm, bar, o0, j * C + c0 + kTile);
      }
    }
    return;
  }

  // warpgroup wg: phase rows u0 + 64 wg .. + 63; A and B K-major (step 16
  // outputs o: +32 bytes)
  const int wg = warp >> 2;
  float acc[64];
  consume<0, 0>(ring, n_steps, wg * kTileBytes, 32, 32, acc);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = u0 + 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * i;
    if (u >= n_r) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        dx + ((size_t)b * T_in + (size_t)stride * u + r) * C + c0);
#pragma unroll
    for (int c8 = 0; c8 < 16; ++c8)
      dst[4 * c8 + (lane & 3)] =
          pack_bf16(acc[4 * c8 + 2 * i], acc[4 * c8 + 2 * i + 1]);
  }
}

// A bf16 tensor map with 64 x 64 boxes (rows past dims[1] read as zeros)
// and the 128-byte swizzle; strides in bytes.
cudaError_t make_box_map(CUtensorMap* map, const void* ptr, int rank,
                         const cuuint64_t* dims, const cuuint64_t* strides) {
  const cuuint32_t box[3] = {(cuuint32_t)kTile, (cuuint32_t)kTile, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
      dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// x's per-phase maps: phase r covers rows r, r + s, ... of every batch.
cudaError_t make_phase_maps(PhaseMaps* maps, const void* x, int B, int T_in,
                            int C, int stride) {
  if (stride < 1 || stride > kMaxStride) return cudaErrorInvalidValue;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(x);
  for (int r = 0; r < stride; ++r) {
    const cuuint64_t dims[3] = {(cuuint64_t)C,
                                (cuuint64_t)((T_in - 1 - r) / stride + 1),
                                (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)stride * C * 2,
                                   (cuuint64_t)T_in * C * 2};
    const cudaError_t err =
        make_box_map(&maps->phase[r], base + (size_t)r * C, 3, dims, strides);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// w (K, C, O) as K C rows of O: the box at (o0, j C + c0) is rows c0 ..
// c0 + 63 of tap j, outputs o0 .. o0 + 63.
cudaError_t make_w_map(CUtensorMap* map, const void* w, int K, int C, int O) {
  const cuuint64_t dims[2] = {(cuuint64_t)O, (cuuint64_t)K * C};
  const cuuint64_t strides[1] = {(cuuint64_t)O * 2};
  return make_box_map(map, w, 2, dims, strides);
}

// dy (B, T_out, O): the box at (o0, t, b) is rows t .. t + 63 of batch b;
// rows before 0 or past T_out read as zeros.
cudaError_t make_dy_map(CUtensorMap* map, const void* dy, int B, int T_out,
                        int O) {
  const cuuint64_t dims[3] = {(cuuint64_t)O, (cuuint64_t)T_out, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)O * 2, (cuuint64_t)T_out * O * 2};
  return make_box_map(map, dy, 3, dims, strides);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kConvSmemBytes);
}

}  // namespace

// x (B, T_in, C), w (K, C, O), out (B, T_out, O), bf16, contiguous.
cudaError_t launch_conv1d_fwd_sm90(const void* x, const void* w, void* out,
                                   int B, int T_in, int C, int K, int O,
                                   int stride, cudaStream_t s) {
  PhaseMaps xm = {};
  CUtensorMap wm;
  cudaError_t err = make_phase_maps(&xm, x, B, T_in, C, stride);
  if (err != cudaSuccess) return err;
  if ((err = make_w_map(&wm, w, K, C, O)) != cudaSuccess) return err;
  if ((err = allow_smem(conv1d_fwd_bf16_kernel)) != cudaSuccess) return err;
  const int T_out = (T_in - K) / stride + 1;
  const int t_tiles = (T_out + kConvTile - 1) / kConvTile;
  const unsigned grid = (unsigned)B * t_tiles * (O / kConvTile);
  conv1d_fwd_bf16_kernel<<<grid, kConvThreads, kConvSmemBytes, s>>>(
      xm, wm, static_cast<__nv_bfloat16*>(out), C, K, O, stride, T_out,
      t_tiles);
  return cudaGetLastError();
}

// dy (B, T_out, O) bf16; slots: n_split x (K, C, O) f32, chunk of `chunk`
// 64-row steps each (the last may be shorter).
cudaError_t launch_conv1d_dw_sm90(const void* x, const void* dy, float* slots,
                                  int B, int T_in, int C, int K, int O,
                                  int stride, int chunk, int n_split,
                                  cudaStream_t s) {
  PhaseMaps xm = {};
  CUtensorMap dym;
  cudaError_t err = make_phase_maps(&xm, x, B, T_in, C, stride);
  if (err != cudaSuccess) return err;
  const int T_out = (T_in - K) / stride + 1;
  if ((err = make_dy_map(&dym, dy, B, T_out, O)) != cudaSuccess) return err;
  if ((err = allow_smem(conv1d_dw_bf16_kernel)) != cudaSuccess) return err;
  const int t_steps = (T_out + kConvStep - 1) / kConvStep;
  const dim3 grid(C / kConvTile, O / kConvTile, K * n_split);
  conv1d_dw_bf16_kernel<<<grid, kConvThreads, kConvSmemBytes, s>>>(
      xm, dym, slots, C, K, O, stride, t_steps, B * t_steps, chunk);
  return cudaGetLastError();
}

// dy (B, T_out, O), w (K, C, O), dx (B, T_in, C), bf16, contiguous; any
// stride >= 1.
cudaError_t launch_conv1d_dx_sm90(const void* dy, const void* w, void* dx,
                                  int B, int T_in, int C, int K, int O,
                                  int stride, cudaStream_t s) {
  CUtensorMap dym, wm;
  const int T_out = (T_in - K) / stride + 1;
  cudaError_t err = make_dy_map(&dym, dy, B, T_out, O);
  if (err != cudaSuccess) return err;
  if ((err = make_w_map(&wm, w, K, C, O)) != cudaSuccess) return err;
  if ((err = allow_smem(conv1d_dx_bf16_kernel)) != cudaSuccess) return err;
  const int n_0 = (T_in + stride - 1) / stride;  // phase 0's rows a batch
  const int u_tiles = (n_0 + kConvTile - 1) / kConvTile;
  const unsigned grid = (unsigned)stride * B * u_tiles * (C / kConvTile);
  conv1d_dx_bf16_kernel<<<grid, kConvThreads, kConvSmemBytes, s>>>(
      dym, wm, static_cast<__nv_bfloat16*>(dx), B, T_in, C, K, O, stride,
      u_tiles);
  return cudaGetLastError();
}

}  // namespace sslc
