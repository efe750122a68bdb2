// Strided 1-D convolution for Hopper (sm_90a) in f32: the forward, dW and
// dX kernels on the tensor cores in split TF32 (wgmma), their operands fed
// by TMA through a ring of shared-memory stages.
//
// Replaces, for f32 inputs, the three Pallas TPU kernels of
// speech_ssl_compression_tpu/ops/conv1d.py:
//   * _fwd_kernel (launched by _conv1d_fwd):
//       out[b, t, o] = sum_j sum_c x[b, s t + j, c] w[j, c, o]   (f32 out)
//   * _dw_kernel (launched by _conv1d_dw):
//       dW[j, c, o] = sum_{b, t} x[b, s t + j, c] dy[b, t, o]     (f32 out)
//   * _dx_kernel (launched by _conv1d_dx):
//       dX[b, i, c] = sum_{j, t : s t + j = i} sum_o dy[b, t, o] w[j, c, o]
//     (f32 out; rows no output reaches are 0)
// with x (B, T_in, C), w (K, C, O), dy (B, T_out, O), T_out = (T_in - K) / s
// + 1, VALID. The forward and dW read x through one TMA map per stride phase
// (conv1d_sm90.cu's header says how a tap j = s q + r becomes a row offset
// q), so they take s <= kF32MaxStride (the wrapper raises past it,
// ops/conv1d.py::phase_rows); dX reads no x and takes any stride. Their
// plain version is ops/conv1d.py::conv1d_strided_plain (dW and dX by
// autograd through it); the checks hold the kernels to it run in float64,
// within 1e-5 (forward and dX max |d| / mean |ref|, dW rel. L2).
//
// Split TF32 (split_tf32.cuh): every product is three TF32 products of hi
// and lo operands (hi = rna_tf32(v), lo = rna_tf32(v - hi)), the two small
// ones first, so the sums are f32-accurate, and
// torch.backends.cuda.matmul.allow_tf32 does not govern them. One TF32
// product (~5e-4 relative) would miss the 1e-5 bar by far. TF32 wgmma takes
// K-major operands only (its transpose flags exist for 16-bit types), so
// each operand must reach shared memory with the reduction contiguous:
//   forward  rows (b, t) x cols o, reduction over (j, c).
//            A = x rows (b, s t + j): K-major over c. TMA brings them raw
//            through the phase maps; each consumer warpgroup splits its 64
//            rows in shared memory, hi in place and lo beside (split_box).
//            B = w[j]: o is contiguous (MN-major). conv1d_split_w_kernel
//            writes w^T as (O, K C) hi and lo into scratch once per call,
//            and TMA reads 128 rows o of it, K-major.
//   dX       one GEMM per phase r: input rows i = s u + r, so
//              dx[b, s u + r, c] = sum_q sum_o dy[b, u - q, o] w[s q + r, c, o]
//            over the taps q < ceil((K - r) / s). Rows (b, u < n_r) x cols
//            c, reduction over (q, o): both operands are K-major already.
//            A = dy rows u - q (o contiguous), raw by TMA and split in
//            shared memory as the forward's A; rows before 0 or past T_out
//            read as zeros (TMA fills a box that starts at a negative row
//            too), so a row no output reaches sums zeros and stores 0.
//            B = w[j] with c as its rows and o along the reduction:
//            conv1d_split_w_dx_kernel writes w's hi and lo into scratch
//            once per call with no transpose ((2, K C, O): w is at most
//            3 x 512 x 512 floats, 6 MB), and TMA reads 128 rows c of it.
//   dW       rows c x cols o, one tap j per block, reduction over rows
//            (b, t): both operands are MN-major (c and o contiguous, the
//            reduction along t), so the split pass transposes both. TMA
//            brings 32 raw rows t of x (through the phase maps) and of dy,
//            128 channels and 128 outputs; the block's 256 consumer threads
//            write x^T and dy^T, hi and lo, 128 rows of 32 t each (the
//            K-major layout, split_tile<..., true, false, 128>), and free
//            the raw stage at once.
// The tensor cores truncate what they add into an accumulator, so no
// accumulator takes a whole sum: each reduction stage (32 channels of one
// tap, 32 outputs of one tap, or 32 rows t: 12 m64n128k8 products) goes
// into a fresh accumulator, which joins the running sum with f32 adds
// rounded to nearest.
//
// Design. A block computes a 128 x 128 output tile with two consumer
// warpgroups (rows 0-63 and 64-127, m64n128k8 products, 64 accumulator
// registers and 64 for the stage's product a thread) and one producer warp.
//   forward, dX: a ring stage is one reduction stage: A raw (two 64 x 32
//   boxes, 16 KB), A lo (16 KB), B hi and lo (128 x 32 each, 32 KB): 64 KB,
//   three stages, one block per SM. A warpgroup splits the next stage's A
//   while its products of this stage run. A row tile never straddles a
//   batch; the forward stores rows t < T_out, dX rows u < n_r at input row
//   s u + r, phase 0 (the most taps) first in the grid.
//   dW: a ring stage holds the raw x and dy rows of one step (eight 32 x 32
//   boxes, 32 KB), three stages; the split pass writes one of two
//   transposed buffers (x^T and dy^T hi and lo, 64 KB each), so the next
//   step's split overlaps this step's products, one barrier of the 256
//   consumer threads a step: 96 + 128 KB, one block per SM. A step is 32
//   rows t of one batch; the batch's steps are cut into n_split chunks in
//   (b, t) order (ops/conv1d.py::dw_tile_splits), each block sums one
//   chunk for one tap into its own f32 slot, and conv1d.cu's reduce kernel
//   adds the slots in chunk order: no atomics.
// Each output is summed in one fixed order: the same bits run to run.
//
// What bounds them. Each kernel does 2 B T_out K C O FLOPs, three TF32
// products each: at HuBERT's layers 1-6 in the training batch ~300 GFLOP
// f32, 1.8 ms at 165 TFLOP/s (495 / 3); the bytes ~0.3 GB, 0.09 ms. A
// block reads its stages from L2: the forward and dX 48 KB a stage, dW 32
// KB a step, and dW writes 64 KB of transposed hi and lo to shared memory
// a step besides the products' reads.

#include "split_tf32.cuh"

namespace sslc {
namespace {

constexpr int kF32MaxStride = 8;  // per-phase maps a launch can carry
constexpr int kF32Tile = 128;     // output rows and columns per block
constexpr int kF32Step = 32;      // reduction depth of one stage
constexpr int kF32Stages = 3;
constexpr int kF32ConsumerWarps = 8;  // two warpgroups
constexpr int kF32Threads = 32 * (kF32ConsumerWarps + 1);  // + the producer
constexpr uint32_t kABox = 64 * 128;  // 8 KB: 64 rows x 32 floats
constexpr uint32_t kBBox = kF32Tile * 128;  // 16 KB: 128 rows x 32 floats
// A raw (hi after the split), A lo, B hi, B lo
constexpr uint32_t kF32StageBytes = 2 * 2 * kABox + 2 * kBBox;
constexpr uint32_t kF32StageTx = 2 * kABox + 2 * kBBox;  // by TMA
constexpr size_t kF32SmemBytes =
    kF32Stages * (size_t)kF32StageBytes + 2 * kF32Stages * 8 + 1024;
// dW: raw x and dy rows of a step (four 32 x 32 boxes each), and the two
// transposed buffers: x^T hi, x^T lo, dy^T hi, dy^T lo (128 rows x 32)
constexpr uint32_t kDwBox = kF32Step * 128;  // 4 KB: 32 rows x 32 floats
constexpr uint32_t kDwRawBytes = 2 * 4 * kDwBox;  // 32 KB
constexpr uint32_t kDwTBytes = 4 * kBBox;         // 64 KB
constexpr size_t kDwSmemBytes = kF32Stages * (size_t)kDwRawBytes +
                                2 * (size_t)kDwTBytes + 2 * kF32Stages * 8 +
                                1024;

static_assert(kF32Step == 32, "a stage is one box of 32 floats a row");
static_assert(kDwSmemBytes <= 232448, "dW fits one SM's shared memory");

struct F32PhaseMaps {
  CUtensorMap phase[kF32MaxStride];
};

// The ring: kF32Stages stages of stage_bytes at a 1024-aligned base, then
// kF32Stages "full" and kF32Stages "empty" mbarriers after `extra` bytes.
struct F32Ring {
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;

  __device__ F32Ring(uint8_t* smem_raw, uint32_t stage_bytes,
                     uint32_t extra) {
    stages = align_1024(smem_raw);
    full = reinterpret_cast<uint64_t*>(stages + kF32Stages * stage_bytes +
                                       extra);
    empty = full + kF32Stages;
  }
};

// Run by thread 0 before the block's first __syncthreads.
__device__ __forceinline__ void init_f32_ring(const F32Ring& ring) {
  for (int i = 0; i < kF32Stages; ++i) {
    mbar_init(&ring.full[i], 1);
    mbar_init(&ring.empty[i], kF32ConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's wait before it refills stage kt % kF32Stages for step kt,
// and the bytes TMA will bring for it.
__device__ __forceinline__ uint64_t* acquire_f32_stage(const F32Ring& ring,
                                                       int kt, uint32_t tx) {
  const int st = kt % kF32Stages;
  if (kt >= kF32Stages)
    mbar_wait(&ring.empty[st], (kt / kF32Stages - 1) & 1);
  mbar_expect_tx(&ring.full[st], tx);
  return &ring.full[st];
}

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

// Issues c = A B over one 32-deep stage in split TF32, A (64 rows) and B
// (128 rows) K-major: A_hi B_lo, A_lo B_hi, A_hi B_hi, 4 k-steps each, the
// first overwriting c; then commits. The caller waits.
__device__ __forceinline__ void issue_split_n128(float (&c)[64],
                                                 uint64_t a_hi, uint64_t a_lo,
                                                 uint64_t b_hi,
                                                 uint64_t b_lo) {
  const uint64_t as[3] = {a_hi, a_lo, a_hi};
  const uint64_t bs[3] = {b_lo, b_hi, b_hi};
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
}

// The consumers of the forward and dX: n_steps ring stages of A raw (two
// 64-row boxes), A lo, B hi and lo. Warpgroup wg splits its A box (raw,
// then hi, at stage + wg kABox; lo 2 kABox further), splitting the next
// stage's while this stage's products run, and sums each stage's product
// into acc through a fresh accumulator.
__device__ __forceinline__ void consume_split_a(const F32Ring& ring,
                                                int n_steps,
                                                float (&acc)[64]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wtid = threadIdx.x & (kWgThreads - 1);
  auto stage = [&](int kt) {
    return ring.stages + (kt % kF32Stages) * kF32StageBytes;
  };
  auto a_hi = [&](int kt) { return stage(kt) + wg * kABox; };
  auto split = [&](int kt) {
    const int st = kt % kF32Stages;
    mbar_wait(&ring.full[st], (kt / kF32Stages) & 1);
    split_box(a_hi(kt), a_hi(kt) + 2 * kABox, wtid);
    fence_proxy_async();
  };
  float c[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  split(0);
  wg_sync(wg);
  for (int kt = 0; kt < n_steps; ++kt) {
    const uint64_t da = tile_desc(a_hi(kt));
    const uint64_t db = tile_desc(stage(kt) + 4 * kABox);
    issue_split_n128(c, da, da + (2 * kABox >> 4), db, db + (kBBox >> 4));
    if (kt + 1 < n_steps) split(kt + 1);
    wgmma_wait<0>();
    fence_regs(c);
    add_tile(acc, c);
    if (lane == 0) mbar_arrive(&ring.empty[kt % kF32Stages]);
    wg_sync(wg);  // the warpgroup's split of step kt + 1 is written
  }
}

// Stores a warpgroup's 64 x 128 f32 tile: thread (warp, lane) holds rows
// 16 (warp % 4) + lane / 4 + 8 i of its warpgroup's 64, columns
// 8 c8 + 2 (lane % 4) + {0, 1}; row_ptr(local row) is the row's first
// column, or null for a row not stored.
template <typename RowPtr>
__device__ __forceinline__ void store_tile(const float (&acc)[64],
                                           RowPtr row_ptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* row = row_ptr(64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2) +
                         8 * i);
    if (row == nullptr) continue;
    float2* dst = reinterpret_cast<float2*>(row);
#pragma unroll
    for (int c8 = 0; c8 < 16; ++c8)
      dst[4 * c8 + (lane & 3)] =
          make_float2(acc[4 * c8 + 2 * i], acc[4 * c8 + 2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// w's split into hi and lo: transposed for the forward, as it is for dX
// ---------------------------------------------------------------------------

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

// ws[h, e] = (h = 0: hi, 1: lo) of w[e] for the n = K C O entries of w, in
// w's own (K C, O) layout: 4 entries a thread.
__global__ void __launch_bounds__(256)
conv1d_split_w_dx_kernel(const float* __restrict__ w, float* __restrict__ ws,
                         long long n) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= n) return;
  const float4 x = *reinterpret_cast<const float4*>(w + e);
  const float h[4] = {tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                      tf32_rna(x.w)};
  *reinterpret_cast<float4*>(ws + e) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(ws + n + e) =
      make_float4(tf32_rna(x.x - h[0]), tf32_rna(x.y - h[1]),
                  tf32_rna(x.z - h[2]), tf32_rna(x.w - h[3]));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

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
  const F32Ring ring(smem_raw, kF32StageBytes, 0);
  const int n_col = O / kF32Tile;
  const int n0 = (blockIdx.x % n_col) * kF32Tile;
  const int row_tile = blockIdx.x / n_col;
  const int b = row_tile / t_tiles;
  const int t0 = (row_tile % t_tiles) * kF32Tile;
  const int c_steps = C / kF32Step;
  const int n_steps = K * c_steps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) init_f32_ring(ring);
  __syncthreads();

  if (warp == kF32ConsumerWarps) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < n_steps; ++kt) {
        const int j = kt / c_steps, c0 = (kt % c_steps) * kF32Step;
        const CUtensorMap* xmap = &xm.phase[j % stride];
        const int row = t0 + j / stride;
        uint64_t* bar = acquire_f32_stage(ring, kt, kF32StageTx);
        uint8_t* s = ring.stages + (kt % kF32Stages) * kF32StageBytes;
        tma_load_3d(s, xmap, bar, c0, row, b);
        tma_load_3d(s + kABox, xmap, bar, c0, row + 64, b);
        tma_load_3d(s + 4 * kABox, &wm, bar, j * C + c0, n0, 0);
        tma_load_3d(s + 4 * kABox + kBBox, &wm, bar, j * C + c0, n0, 1);
      }
    }
    return;
  }

  float acc[64];
  consume_split_a(ring, n_steps, acc);
  store_tile(acc, [&](int r) -> float* {
    const int t = t0 + r;
    return t < T_out ? out + ((size_t)b * T_out + t) * O + n0 : nullptr;
  });
}

// ---------------------------------------------------------------------------
// dX: one GEMM per stride phase, stored directly
// ---------------------------------------------------------------------------

// Block: phase r, batch b, phase rows u0 .. u0 + 127, channels c0 .. c0 +
// 127; in the linear order (r, b, u tile, c tile) the column tile runs
// fastest and phase 0 comes first. Step kt is tap q = kt / o_steps (j =
// s q + r), outputs o0 = 32 (kt % o_steps) .. + 31. u_tiles row tiles
// cover phase 0's n_0 rows; a tile past a later phase's rows has nothing
// to do.
__global__ void __launch_bounds__(kF32Threads, 1)
conv1d_dx_f32_kernel(const __grid_constant__ CUtensorMap dym,
                     const __grid_constant__ CUtensorMap wm,
                     float* __restrict__ dx, int B, int T_in, int C, int K,
                     int O, int stride, int u_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const int n_col = C / kF32Tile;
  const int c0 = (blockIdx.x % n_col) * kF32Tile;
  const int row_tile = blockIdx.x / n_col;
  const int u0 = (row_tile % u_tiles) * kF32Tile;
  const int b = row_tile / u_tiles % B;
  const int r = row_tile / u_tiles / B;
  const int n_r = (T_in - 1 - r) / stride + 1;  // phase rows a batch
  if (u0 >= n_r) return;
  const F32Ring ring(smem_raw, kF32StageBytes, 0);
  const int o_steps = O / kF32Step;
  const int n_steps = (K - r + stride - 1) / stride * o_steps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) init_f32_ring(ring);
  __syncthreads();

  if (warp == kF32ConsumerWarps) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < n_steps; ++kt) {
        const int q = kt / o_steps, o0 = (kt % o_steps) * kF32Step;
        const int j = q * stride + r;
        uint64_t* bar = acquire_f32_stage(ring, kt, kF32StageTx);
        uint8_t* s = ring.stages + (kt % kF32Stages) * kF32StageBytes;
        tma_load_3d(s, &dym, bar, o0, u0 - q, b);
        tma_load_3d(s + kABox, &dym, bar, o0, u0 - q + 64, b);
        tma_load_3d(s + 4 * kABox, &wm, bar, o0, j * C + c0, 0);
        tma_load_3d(s + 4 * kABox + kBBox, &wm, bar, o0, j * C + c0, 1);
      }
    }
    return;
  }

  float acc[64];
  consume_split_a(ring, n_steps, acc);
  store_tile(acc, [&](int row) -> float* {
    const int u = u0 + row;
    return u < n_r ? dx + ((size_t)b * T_in + (size_t)stride * u + r) * C + c0
                   : nullptr;
  });
}

// ---------------------------------------------------------------------------
// dW: one f32 slot per (chunk, tap); conv1d.cu's reduce kernel adds them
// ---------------------------------------------------------------------------

// Waits at the named barrier of the 256 consumer threads (1; the producer
// warp takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWgThreads) : "memory");
}

// Block: channels c0 .. c0 + 127 (blockIdx.x), outputs n0 .. n0 + 127
// (blockIdx.y), tap j and chunk `split` (blockIdx.z = split K + j). Step i
// of the (b, t) order is batch i / t_steps, rows 32 (i % t_steps) .. + 31
// (those past T_out read dy as zeros); the chunk is steps split * chunk ..
// min(total, (split + 1) chunk) - 1.
__global__ void __launch_bounds__(kF32Threads, 1)
conv1d_dw_f32_kernel(const __grid_constant__ F32PhaseMaps xm,
                     const __grid_constant__ CUtensorMap dym,
                     float* __restrict__ partial, int C, int K, int O,
                     int stride, int t_steps, int total, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  const F32Ring ring(smem_raw, kDwRawBytes, 2 * kDwTBytes);
  uint8_t* tbuf = ring.stages + kF32Stages * kDwRawBytes;  // two buffers
  const int c0 = blockIdx.x * kF32Tile;
  const int n0 = blockIdx.y * kF32Tile;
  const int j = blockIdx.z % K;
  const int split = blockIdx.z / K;
  const int first = split * chunk;
  const int n_steps = max(0, min(total, first + chunk) - first);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) init_f32_ring(ring);
  __syncthreads();

  if (warp == kF32ConsumerWarps) {  // producer
    if (lane == 0) {
      const CUtensorMap* xmap = &xm.phase[j % stride];
      const int q = j / stride;
      for (int kt = 0; kt < n_steps; ++kt) {
        const int i = first + kt;
        const int b = i / t_steps, t = (i % t_steps) * kF32Step;
        uint64_t* bar = acquire_f32_stage(ring, kt, kDwRawBytes);
        uint8_t* s = ring.stages + (kt % kF32Stages) * kDwRawBytes;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          tma_load_3d(s + m * kDwBox, xmap, bar, c0 + 32 * m, t + q, b);
          tma_load_3d(s + (4 + m) * kDwBox, &dym, bar, n0 + 32 * m, t, b);
        }
      }
    }
    return;
  }

  // consumers: the split pass of step kt writes x^T and dy^T hi and lo into
  // buffer kt % 2 and frees the raw stage; warpgroup wg computes channels
  // 64 wg .. 64 wg + 63 from x^T's rows there
  const int wg = warp >> 2;
  auto split_step = [&](int kt) {
    const int st = kt % kF32Stages;
    mbar_wait(&ring.full[st], (kt / kF32Stages) & 1);
    uint8_t* raw = ring.stages + st * kDwRawBytes;
    uint8_t* tb = tbuf + (kt & 1) * kDwTBytes;
    split_tile<kF32Step, 2 * kWgThreads, true, false, kF32Tile>(
        raw, nullptr, tb, tb + kBBox, threadIdx.x);
    split_tile<kF32Step, 2 * kWgThreads, true, false, kF32Tile>(
        raw + 4 * kDwBox, nullptr, tb + 2 * kBBox, tb + 3 * kBBox,
        threadIdx.x);
    fence_proxy_async();
    __syncwarp();  // the warp's reads of the raw stage are done
    if (lane == 0) mbar_arrive(&ring.empty[st]);
  };
  float acc[64], c[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  if (n_steps > 0) split_step(0);
  consumers_sync();
  for (int kt = 0; kt < n_steps; ++kt) {
    uint8_t* tb = tbuf + (kt & 1) * kDwTBytes;
    issue_split_n128(c, tile_desc(tb + wg * kABox),
                     tile_desc(tb + kBBox + wg * kABox),
                     tile_desc(tb + 2 * kBBox), tile_desc(tb + 3 * kBBox));
    if (kt + 1 < n_steps) split_step(kt + 1);
    wgmma_wait<0>();
    fence_regs(c);
    add_tile(acc, c);
    consumers_sync();  // step kt + 1's split is written, step kt's read
  }

  float* slot = partial + ((size_t)split * K + j) * C * O;
  store_tile(acc, [&](int row) -> float* {
    return slot + (size_t)(c0 + row) * O + n0;
  });
}

cudaError_t allow_f32_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// x's per-phase maps, read in boxes of box_rows rows x 32 floats: phase r
// covers rows r, r + s, ... of every batch.
cudaError_t make_f32_phase_maps(F32PhaseMaps* xm, const void* x, int B,
                                int T_in, int C, int stride, int box_rows) {
  if (stride < 1 || stride > kF32MaxStride) return cudaErrorInvalidValue;
  const float* base = static_cast<const float*>(x);
  for (int r = 0; r < stride; ++r) {
    const cuuint64_t dims[3] = {(cuuint64_t)C,
                                (cuuint64_t)((T_in - 1 - r) / stride + 1),
                                (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)stride * C * 4,
                                   (cuuint64_t)T_in * C * 4};
    const cudaError_t err = make_f32_box_map(&xm->phase[r],
                                             base + (size_t)r * C, dims,
                                             strides, box_rows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// dy (B, T_out, O) f32, read in boxes of box_rows rows x 32 floats; rows
// before 0 or past T_out read as zeros.
cudaError_t make_f32_dy_map(CUtensorMap* map, const void* dy, int B,
                            int T_out, int O, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)O, (cuuint64_t)T_out,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)O * 4,
                                 (cuuint64_t)T_out * O * 4};
  return make_f32_box_map(map, dy, dims, strides, box_rows);
}

}  // namespace

// x (B, T_in, C), w (K, C, O), out (B, T_out, O), f32, contiguous; wt:
// scratch of 2 O K C floats for w^T's hi and lo. C and O multiples of 128,
// stride <= kF32MaxStride.
cudaError_t launch_conv1d_fwd_f32_sm90(const void* x, const void* w,
                                       void* wt, void* out, int B, int T_in,
                                       int C, int K, int O, int stride,
                                       cudaStream_t s) {
  F32PhaseMaps xm = {};
  cudaError_t err = make_f32_phase_maps(&xm, x, B, T_in, C, stride, 64);
  if (err != cudaSuccess) return err;
  const int KC = K * C;
  conv1d_split_w_kernel<<<dim3(O / 32, KC / 32), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(wt), KC, O);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // w^T (2, O, K C): the box at (j C + c0, n0, h) is outputs n0 .. n0 +
  // 127, reduction rows j C + c0 .. + 31, hi (h = 0) or lo (1)
  CUtensorMap wm;
  const cuuint64_t w_dims[3] = {(cuuint64_t)KC, (cuuint64_t)O, 2};
  const cuuint64_t w_strides[2] = {(cuuint64_t)KC * 4,
                                   (cuuint64_t)O * KC * 4};
  if ((err = make_f32_box_map(&wm, wt, w_dims, w_strides, kF32Tile)) !=
      cudaSuccess)
    return err;
  if ((err = allow_f32_smem((const void*)conv1d_fwd_f32_kernel,
                            kF32SmemBytes)) != cudaSuccess)
    return err;
  const int T_out = (T_in - K) / stride + 1;
  const int t_tiles = (T_out + kF32Tile - 1) / kF32Tile;
  const unsigned grid = (unsigned)B * t_tiles * (O / kF32Tile);
  conv1d_fwd_f32_kernel<<<grid, kF32Threads, kF32SmemBytes, s>>>(
      xm, wm, static_cast<float*>(out), C, K, O, stride, T_out, t_tiles);
  return cudaGetLastError();
}

// x (B, T_in, C), dy (B, T_out, O) f32, contiguous; slots: n_split x
// (K, C, O) f32, chunk of `chunk` 32-row steps each (the last may be
// shorter). stride <= kF32MaxStride.
cudaError_t launch_conv1d_dw_f32_sm90(const void* x, const void* dy,
                                      float* slots, int B, int T_in, int C,
                                      int K, int O, int stride, int chunk,
                                      int n_split, cudaStream_t s) {
  F32PhaseMaps xm = {};
  CUtensorMap dym;
  cudaError_t err =
      make_f32_phase_maps(&xm, x, B, T_in, C, stride, kF32Step);
  if (err != cudaSuccess) return err;
  const int T_out = (T_in - K) / stride + 1;
  if ((err = make_f32_dy_map(&dym, dy, B, T_out, O, kF32Step)) != cudaSuccess)
    return err;
  if ((err = allow_f32_smem((const void*)conv1d_dw_f32_kernel,
                            kDwSmemBytes)) != cudaSuccess)
    return err;
  const int t_steps = (T_out + kF32Step - 1) / kF32Step;
  const dim3 grid(C / kF32Tile, O / kF32Tile, K * n_split);
  conv1d_dw_f32_kernel<<<grid, kF32Threads, kDwSmemBytes, s>>>(
      xm, dym, slots, C, K, O, stride, t_steps, B * t_steps, chunk);
  return cudaGetLastError();
}

// dy (B, T_out, O), w (K, C, O), dx (B, T_in, C), f32, contiguous; ws:
// scratch of 2 K C O floats for w's hi and lo. Any stride >= 1.
cudaError_t launch_conv1d_dx_f32_sm90(const void* dy, const void* w,
                                      void* ws, void* dx, int B, int T_in,
                                      int C, int K, int O, int stride,
                                      cudaStream_t s) {
  const long long n = (long long)K * C * O;
  conv1d_split_w_dx_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(ws), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap dym, wm;
  const int T_out = (T_in - K) / stride + 1;
  if ((err = make_f32_dy_map(&dym, dy, B, T_out, O, 64)) != cudaSuccess)
    return err;
  // w's split (2, K C, O): the box at (o0, j C + c0, h) is rows c0 .. c0 +
  // 127 of tap j, outputs o0 .. o0 + 31, hi (h = 0) or lo (1)
  const cuuint64_t w_dims[3] = {(cuuint64_t)O, (cuuint64_t)K * C, 2};
  const cuuint64_t w_strides[2] = {(cuuint64_t)O * 4, (cuuint64_t)n * 4};
  if ((err = make_f32_box_map(&wm, ws, w_dims, w_strides, kF32Tile)) !=
      cudaSuccess)
    return err;
  if ((err = allow_f32_smem((const void*)conv1d_dx_f32_kernel,
                            kF32SmemBytes)) != cudaSuccess)
    return err;
  const int n_0 = (T_in + stride - 1) / stride;  // phase 0's rows a batch
  const int u_tiles = (n_0 + kF32Tile - 1) / kF32Tile;
  const unsigned grid = (unsigned)stride * B * u_tiles * (C / kF32Tile);
  conv1d_dx_f32_kernel<<<grid, kF32Threads, kF32SmemBytes, s>>>(
      dym, wm, static_cast<float*>(dx), B, T_in, C, K, O, stride, u_tiles);
  return cudaGetLastError();
}

}  // namespace sslc
