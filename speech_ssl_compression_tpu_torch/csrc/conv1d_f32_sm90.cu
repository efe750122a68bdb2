// Strided 1-D convolution forward for Hopper (sm_90a) in f32: the tensor
// cores in split TF32 (wgmma), x fed by TMA through a ring of shared-memory
// stages, one map per stride phase.
//
// Replaces, for f32 inputs, the Pallas TPU kernel
// speech_ssl_compression_tpu/ops/conv1d.py::_fwd_kernel (launched by
// _conv1d_fwd):
//     out[b, t, o] = sum_j sum_c x[b, s t + j, c] w[j, c, o]     (f32 out)
// with x (B, T_in, C), w (K, C, O), T_out = (T_in - K) / s + 1, VALID,
// stride s <= kF32MaxStride (the wrapper raises past it,
// ops/conv1d.py::phase_rows). Its plain version is
// ops/conv1d.py::conv1d_strided_plain; the checks hold the kernel to it run
// in float64, within 1e-5 (max |d| / mean |ref|).
//
// Split TF32 (split_tf32.cuh): every product is three TF32 products of hi
// and lo operands, so the sums are f32-accurate, and
// torch.backends.cuda.matmul.allow_tf32 does not govern them. One TF32
// product (~5e-4 relative) would miss the 1e-5 bar by far.
//   A = x rows (b, s t + j), K-major over c. TMA brings them raw through
//       one 3-D map {C, n_r, B} per stride phase r (conv1d_sm90.cu's
//       header says how a tap j = s q + r becomes a row offset q), boxes of
//       32 channels (128 bytes, the 128-byte swizzle); each consumer
//       warpgroup splits its 64 rows in shared memory, hi in place and lo
//       beside.
//   B = w[j], whose o is contiguous (MN-major), which TF32 wgmma refuses. So
//       a small kernel here (conv1d_split_w_kernel) writes w^T as (O, K C)
//       hi and lo into scratch once per call (w is at most 3 x 512 x 512
//       floats), and TMA reads 128 rows o of it, K-major, per stage.
// The sum runs over K C terms (1,536 at HuBERT's layers 1-4). The tensor
// cores truncate what they add into an accumulator, so no accumulator
// takes the whole sum: each stage's 32 channels (12 m64n128k8 products)
// go into a fresh accumulator, which joins the running sum with f32 adds
// rounded to nearest.
//
// Design. A block computes a 128 x 128 output tile (rows (b, t), columns
// o) with two consumer warpgroups (rows 0-63 and 64-127, m64n128k8
// products, 64 accumulator registers and 64 for the stage's product a
// thread) and one producer warp. A ring stage is one reduction step of 32
// channels of one tap: A raw (two 64 x 32 boxes, 16 KB), A lo (16 KB),
// B hi and lo (128 x 32 each, 32 KB): 64 KB, three stages, one block per
// SM. A warpgroup splits the next stage's A while its products of this
// stage run, and the other warpgroup's products overlap its adds. A row
// tile never straddles a batch; rows t >= T_out are not stored. Each
// output is summed by one block in one fixed order: the same bits run to
// run.
//
// What bounds it. 2 B T_out K C O FLOPs, 3 TF32 products each: at HuBERT's
// layers 1-6 in the training batch ~300 GFLOP f32, 1.8 ms at 165 TFLOP/s
// (495 / 3); the bytes ~0.3 GB, 0.09 ms. Each block reads its stages from
// L2: A once per column tile and tap, B hi and lo once per row tile, 48 KB
// a stage.

#include "split_tf32.cuh"

namespace sslc {
namespace {

constexpr int kF32MaxStride = 8;  // per-phase maps a launch can carry
constexpr int kF32Tile = 128;     // output rows and columns per block
constexpr int kF32Step = 32;      // channels of one ring stage
constexpr int kF32Stages = 3;
constexpr int kF32ConsumerWarps = 8;  // two warpgroups
constexpr int kF32Threads = 32 * (kF32ConsumerWarps + 1);  // + the producer
constexpr uint32_t kABox = 64 * 128;  // 8 KB: 64 rows x 32 floats
// A raw (hi after the split), A lo, B hi, B lo
constexpr uint32_t kF32StageBytes = 2 * 2 * kABox + 2 * kF32Tile * 128;
constexpr uint32_t kF32StageTx = 2 * kABox + 2 * kF32Tile * 128;  // by TMA
constexpr size_t kF32SmemBytes =
    kF32Stages * (size_t)kF32StageBytes + 2 * kF32Stages * 8 + 1024;

struct F32PhaseMaps {
  CUtensorMap phase[kF32MaxStride];
};

// Splits a 64-row box of 32 floats (TMA-loaded at `hi`) in place into hi
// and writes lo at the same offsets of `lo`; the warpgroup's thread t takes
// row t % 64.
__device__ __forceinline__ void split_box(uint8_t* hi, uint8_t* lo, int t) {
  const int r = t & 63;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const uint32_t off = swz_off(64, r, (t >> 6) + 2 * jj);
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    const float h[4] = {tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                        tf32_rna(x.w)};
    *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + off) =
        make_float4(tf32_rna(x.x - h[0]), tf32_rna(x.y - h[1]),
                    tf32_rna(x.z - h[2]), tf32_rna(x.w - h[3]));
  }
}

// d (+)= A B for a 64 x 128 x 8 TF32 step, both K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SSLC_WGMMA_D64
      ", %64, %65, p, 1, 1;\n"
      "}\n"
      : SSLC_WGMMA_D64_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// wt[h, o, j C + c] = (h = 0: hi, 1: lo) of w[j, c, o], read as (K C, O)
// rows: a 32 x 32 tile a block of 32 x 8 threads, transposed through
// shared memory so that both the reads and the writes are coalesced.
__global__ void __launch_bounds__(256)
conv1d_split_w_kernel(const float* __restrict__ w, float* __restrict__ wt,
                      int KC, int O) {
  __shared__ float tile[32][33];
  const int o0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < 32; i += 8)
    tile[i][tx] = w[(size_t)(r0 + i) * O + o0 + tx];
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const float x = tile[tx][i];  // w row r0 + tx, column o0 + i
    const float h = tf32_rna(x);
    const size_t at = (size_t)(o0 + i) * KC + r0 + tx;
    wt[at] = h;
    wt[(size_t)O * KC + at] = tf32_rna(x - h);
  }
}

// Block tile: output rows t0 .. t0 + 127 of batch b (t_tiles row tiles a
// batch), columns n0 .. n0 + 127; the column tile runs fastest, so the
// O / 128 blocks that read one x row tile run together. Step kt is tap
// j = kt / c_steps, channels c0 = 32 (kt % c_steps) .. + 31.
__global__ void __launch_bounds__(kF32Threads, 1)
conv1d_fwd_f32_kernel(const __grid_constant__ F32PhaseMaps xm,
                      const __grid_constant__ CUtensorMap wm,
                      float* __restrict__ out, int C, int K, int O,
                      int stride, int T_out, int t_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kF32Stages *
                                               kF32StageBytes);
  uint64_t* empty = full + kF32Stages;
  const int n_col = O / kF32Tile;
  const int n0 = (blockIdx.x % n_col) * kF32Tile;
  const int row_tile = blockIdx.x / n_col;
  const int b = row_tile / t_tiles;
  const int t0 = (row_tile % t_tiles) * kF32Tile;
  const int c_steps = C / kF32Step;
  const int n_steps = K * c_steps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kF32Stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kF32ConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kF32ConsumerWarps) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < n_steps; ++kt) {
        const int st = kt % kF32Stages;
        const int j = kt / c_steps, c0 = (kt % c_steps) * kF32Step;
        const CUtensorMap* xmap = &xm.phase[j % stride];
        const int row = t0 + j / stride;
        if (kt >= kF32Stages)
          mbar_wait(&empty[st], (kt / kF32Stages - 1) & 1);
        uint8_t* s = ring + st * kF32StageBytes;
        mbar_expect_tx(&full[st], kF32StageTx);
        tma_load_3d(s, xmap, &full[st], c0, row, b);
        tma_load_3d(s + kABox, xmap, &full[st], c0, row + 64, b);
        tma_load_3d(s + 4 * kABox, &wm, &full[st], j * C + c0, n0, 0);
        tma_load_3d(s + 4 * kABox + kF32Tile * 128, &wm, &full[st],
                    j * C + c0, n0, 1);
      }
    }
    return;
  }

  // consumers: warpgroup wg computes output rows 64 wg .. 64 wg + 63 from
  // its A box (raw, then hi, at stage + wg kABox; lo 2 kABox further)
  const int wg = warp >> 2, wtid = threadIdx.x & (kWgThreads - 1);
  auto a_hi = [&](int st) { return ring + st * kF32StageBytes + wg * kABox; };
  auto split = [&](int kt) {
    const int st = kt % kF32Stages;
    mbar_wait(&full[st], (kt / kF32Stages) & 1);
    split_box(a_hi(st), a_hi(st) + 2 * kABox, wtid);
    fence_proxy_async();
  };
  float acc[64], c[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  split(0);
  wg_sync(wg);
  for (int kt = 0; kt < n_steps; ++kt) {
    const int st = kt % kF32Stages;
    const uint64_t da = tile_desc(a_hi(st));
    const uint64_t db = tile_desc(ring + st * kF32StageBytes + 4 * kABox);
    const uint64_t as[3] = {da, da + (2 * kABox >> 4), da};
    const uint64_t bs[3] = {db + (kF32Tile * 128 >> 4), db, db};
    fence_regs(c);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p) {  // A_hi B_lo, A_lo B_hi, A_hi B_hi
#pragma unroll
      for (int kk = 0; kk < kF32Step / 8; ++kk)
        wgmma_tf32_n128(c, as[p] + kk * (32 >> 4), bs[p] + kk * (32 >> 4),
                        p > 0 || kk > 0);
    }
    wgmma_commit();
    if (kt + 1 < n_steps) split(kt + 1);
    wgmma_wait<0>();
    fence_regs(c);
    add_tile(acc, c);
    if (lane == 0) mbar_arrive(&empty[st]);
    wg_sync(wg);  // the warpgroup's split of step kt + 1 is written
  }

  // thread (warp, lane) holds rows 16 (warp % 4) + lane / 4 + 8 i of its
  // warpgroup's 64, columns 8 c8 + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * i;
    if (t >= T_out) continue;
    float2* dst =
        reinterpret_cast<float2*>(out + ((size_t)b * T_out + t) * O + n0);
#pragma unroll
    for (int c8 = 0; c8 < 16; ++c8)
      dst[4 * c8 + (lane & 3)] =
          make_float2(acc[4 * c8 + 2 * i], acc[4 * c8 + 2 * i + 1]);
  }
}

}  // namespace

// x (B, T_in, C), w (K, C, O), out (B, T_out, O), f32, contiguous; wt:
// scratch of 2 O K C floats for w^T's hi and lo. C and O multiples of 128,
// stride <= kF32MaxStride.
cudaError_t launch_conv1d_fwd_f32_sm90(const void* x, const void* w,
                                       void* wt, void* out, int B, int T_in,
                                       int C, int K, int O, int stride,
                                       cudaStream_t s) {
  if (stride < 1 || stride > kF32MaxStride) return cudaErrorInvalidValue;
  const int KC = K * C;
  conv1d_split_w_kernel<<<dim3(O / 32, KC / 32), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(wt), KC, O);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // x's phase r: rows r, r + s, ... of every batch
  F32PhaseMaps xm = {};
  const float* base = static_cast<const float*>(x);
  for (int r = 0; r < stride; ++r) {
    const cuuint64_t dims[3] = {(cuuint64_t)C,
                                (cuuint64_t)((T_in - 1 - r) / stride + 1),
                                (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)stride * C * 4,
                                   (cuuint64_t)T_in * C * 4};
    if ((err = make_f32_box_map(&xm.phase[r], base + (size_t)r * C, dims,
                                strides, 64)) != cudaSuccess)
      return err;
  }
  // w^T (2, O, K C): the box at (j C + c0, n0, h) is outputs n0 .. n0 +
  // 127, reduction rows j C + c0 .. + 31, hi (h = 0) or lo (1)
  CUtensorMap wm;
  const cuuint64_t w_dims[3] = {(cuuint64_t)KC, (cuuint64_t)O, 2};
  const cuuint64_t w_strides[2] = {(cuuint64_t)KC * 4,
                                   (cuuint64_t)O * KC * 4};
  if ((err = make_f32_box_map(&wm, wt, w_dims, w_strides, kF32Tile)) !=
      cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(conv1d_fwd_f32_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kF32SmemBytes)) != cudaSuccess)
    return err;
  const int T_out = (T_in - K) / stride + 1;
  const int t_tiles = (T_out + kF32Tile - 1) / kF32Tile;
  const unsigned grid = (unsigned)B * t_tiles * (O / kF32Tile);
  conv1d_fwd_f32_kernel<<<grid, kF32Threads, kF32SmemBytes, s>>>(
      xm, wm, static_cast<float*>(out), C, K, O, stride, T_out, t_tiles);
  return cudaGetLastError();
}

}  // namespace sslc
