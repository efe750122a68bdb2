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
// Split TF32. One TF32 product keeps 10 of the 23 mantissa bits (~5e-4
// relative), which the f32 bars (1e-4 against the plain version run in
// float64, the HuBERT gradients within 1e-4 of float64) do not allow. So
// every operand
// x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// (cvt.rna.tf32.f32: to nearest, ties away from zero), and each product
// a b is taken as the three TF32 products hi_a lo_b + lo_a hi_b +
// hi_a hi_b into one f32 accumulator, the two small ones first. The
// dropped lo_a lo_b and lo's own rounding are each <= 2^-22 |a b|: about
// 7e-7 relative in all, unbiased because hi is rounded to nearest (a
// truncated hi would leave lo with x's sign, and the dropped lo lo term
// would add up along a sum). tests/test_torch_flash_split_tf32.py checks
// this arithmetic against the Pallas backward on the CPU, with a control
// (hi hi alone) that fails the bar. torch.backends.cuda.matmul.allow_tf32
// does not govern these kernels: their products are f32-accurate. They
// are not rounded where the f32 plain version's products are, though, and
// that version lies up to ~2e-4 (max |d| / mean |ref|) from the exact
// function at a causal T = 1024, where key 0's gradients are ~90 times
// their mean: the checks hold these kernels to the plain version run in
// float64 (within 5e-5 at every case, on one H100).
//
// What wgmma allows for TF32 shapes the design. Both operands must be
// K-major (the transpose flags exist only for 16-bit types), so a product
// that sums over a tile's rows needs that tile transposed in shared
// memory: dQ = dS K reads K^T, dK = dS^T Q reads Q^T and dV = Pd^T dO reads
// dO^T. TMA does not transpose. So TMA brings each raw f32 tile (two boxes
// of 32 floats a row, the 128-byte swizzle), and the split pass reads it,
// writes hi back in place and lo beside it (the same offsets: the layout
// wgmma reads), and, where a product needs it, hi and lo transposed (64
// rows of dims, a column per key or query, swizzled the same way).
//   dS and Pd stay in registers. The S accumulator gives a thread columns
// 2 (l % 4) + j of each group of 8, but the TF32 A fragment of m64nNk8
// wants columns l % 4 and l % 4 + 4. A sum is order-free, so the fragment
// takes the accumulator's pair as it is, and the transposed copy of the
// other operand is written with its reduction rows in the same order
// (perm_col: key 2m of a group of 8 at column m, key 2m + 1 at m + 4).
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

#include "sm90_common.cuh"

namespace sslc {
namespace {

constexpr int kWgs = 2;  // consumer warpgroups per block, on alternate tiles
constexpr int kBlockThreads = kWgs * kWgThreads;
constexpr int kN = 32;  // rows of a streamed tile: keys (dQ), queries (dK/dV)
constexpr uint32_t kRowBytes = kD * 4;             // 256: one f32 row
constexpr uint32_t kResBytes = kTile * kRowBytes;  // 16 KB: 64 rows
constexpr uint32_t kResBox = kTile * 128;          // 8 KB: 64 rows x 32
constexpr uint32_t kNBytes = kN * kRowBytes;       // 8 KB: 32 rows
constexpr uint32_t kNBox = kN * 128;               // 4 KB: 32 rows x 32
constexpr uint32_t kTBox = kD * 128;     // a transposed box: 64 dims x 32
constexpr uint32_t kTBytes = kD * kN * 4;  // 8 KB: a transposed tile
constexpr int kKeepTileHalves = kTile * 2;  // 64 rows x 2 halves of 16 keys

static_assert(kTBytes == kTBox, "a transposed tile is one box");

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

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads by the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of the float4 (row r, dims 4 c4 .. 4 c4 + 3) in an f32 tile
// of n rows x 64 dims as TMA lays it out: two boxes of n rows x 32 floats
// (box 1 after box 0), rows of 128 bytes, 16-byte chunks swizzled by the
// row's position in its group of 8.
__device__ __forceinline__ uint32_t swz_off(int n, int r, int c4) {
  return (c4 >> 3) * n * 128 + r * 128 + (((c4 & 7) ^ (r & 7)) << 4);
}

// Byte offset of element (dim d, column col) of a transposed tile: 64 rows
// of dims, boxes of 32 columns (64 x 128 bytes), swizzled the same way.
__device__ __forceinline__ uint32_t swz_off_t(int d, int col) {
  return (col >> 5) * kTBox + d * 128 +
         ((((col & 31) >> 2) ^ (d & 7)) << 4) + ((col & 3) << 2);
}

// The column of key (or query) r in a transposed tile: within each group
// of 8, 2m goes to m and 2m + 1 to m + 4, the order in which the
// accumulator's pairs serve as the TF32 A fragment (see frag_idx).
__device__ __forceinline__ int perm_col(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// A fragment register of k-step c8 that takes accumulator register
// 4 c8 + 2 i + j (row 16 w + l / 4 + 8 i, column 8 c8 + 2 (l % 4) + j):
// registers 0..3 of the TF32 fragment hold (row, column) (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4), g = l / 4, t = l % 4, so column t
// stands for key 2t and column t + 4 for key 2t + 1.
__device__ __forceinline__ int frag_idx(int i, int j) { return i + 2 * j; }

// Splits the raw tile of n rows at `hi` (TMA-loaded) in place into hi and
// writes lo at the same offsets of `lo`; with kTrans, both also transposed
// into t_hi and t_lo, column perm_col(row). kThr threads take part, thread
// t taking row t % n: the 32 lanes of a warp take 32 rows, so neither the
// 16-byte reads and writes nor the transposed 4-byte writes conflict in a
// bank.
template <int n, int kThr, bool kTrans>
__device__ __forceinline__ void split_tile(uint8_t* hi, uint8_t* lo,
                                           uint8_t* t_hi, uint8_t* t_lo,
                                           int t) {
  constexpr int kGroups = kThr / n;
  const int r = t % n;
#pragma unroll
  for (int jj = 0; jj < 16 / kGroups; ++jj) {
    const int c4 = t / n + kGroups * jj;
    const uint32_t off = swz_off(n, r, c4);
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    const float h[4] = {tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                        tf32_rna(x.w)};
    const float l[4] = {tf32_rna(x.x - h[0]), tf32_rna(x.y - h[1]),
                        tf32_rna(x.z - h[2]), tf32_rna(x.w - h[3])};
    *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + off) = make_float4(l[0], l[1], l[2], l[3]);
    if (kTrans) {
      const int col = perm_col(r);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t t_off = swz_off_t(4 * c4 + u, col);
        *reinterpret_cast<float*>(t_hi + t_off) = h[u];
        *reinterpret_cast<float*>(t_lo + t_off) = l[u];
      }
    }
  }
}

// Waits at warpgroup wg's own named barrier (1 + wg; __syncthreads is 0).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads)
               : "memory");
}

// Rows row0 .. row0 + n - 1 of head bh of two (B*H, T, 64) f32 tensors,
// each as two boxes of 32 floats, completing together on `bar`.
template <int n>
__device__ __forceinline__ void tma_load_rows(uint8_t* dst_a,
                                              const CUtensorMap* a,
                                              uint8_t* dst_b,
                                              const CUtensorMap* b,
                                              uint64_t* bar, int row0,
                                              int bh) {
  mbar_expect_tx(bar, 2 * n * kRowBytes);
  tma_load_3d(dst_a, a, bar, 0, row0, bh);
  tma_load_3d(dst_a + n * 128, a, bar, 32, row0, bh);
  tma_load_3d(dst_b, b, bar, 0, row0, bh);
  tma_load_3d(dst_b + n * 128, b, bar, 32, row0, bh);
}

// The descriptor of k-step kk (8 columns) of a K-major f32 operand whose
// 32-column boxes lie box_bytes apart.
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int kk,
                                          uint32_t box_bytes) {
  return desc + (uint64_t)(((kk >> 2) * box_bytes + (kk & 3) * 32) >> 4);
}

#define SSLC_WGMMA_D16                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SSLC_WGMMA_D16_OPS(d)                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (+)= A B for a 64 x 32 x 8 TF32 step, both K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " SSLC_WGMMA_D16
      ", %16, %17, p, 1, 1;\n"
      "}\n"
      : SSLC_WGMMA_D16_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B for a 64 x 64 x 8 TF32 step, A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SSLC_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : SSLC_WGMMA_D_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// c = A B^T over the 64 dims in split TF32, A (64 rows) and B (kN rows)
// K-major: A_hi B_lo and A_lo B_hi, then A_hi B_hi, 8 k-steps each, the
// first overwriting c.
__device__ __forceinline__ void issue_split_product(float (&c)[kN / 2],
                                                    uint64_t a_hi,
                                                    uint64_t a_lo,
                                                    uint64_t b_hi,
                                                    uint64_t b_lo) {
  const uint64_t as[3] = {a_hi, a_lo, a_hi}, bs[3] = {b_lo, b_hi, b_hi};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk)
      wgmma_tf32_n32(c, kstep(as[p], kk, kResBox), kstep(bs[p], kk, kNBox),
                     p > 0 || kk > 0);
  }
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

// c = A B in split TF32, A (64 rows, kSteps x 8 columns) as hi and lo
// register fragments, B^T hi and lo K-major in transposed tiles (their
// columns in perm_col order): A_hi B_lo, A_lo B_hi, A_hi B_hi; the first
// step overwrites c.
template <int kSteps>
__device__ __forceinline__ void issue_split_reg_product(
    float (&c)[32], const uint32_t (&a_hi)[kSteps][4],
    const uint32_t (&a_lo)[kSteps][4], uint64_t bt_hi, uint64_t bt_lo) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_tf32_rs(c, a_hi[kk], kstep(bt_lo, kk, kTBox), kk > 0);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_tf32_rs(c, a_lo[kk], kstep(bt_hi, kk, kTBox), 1);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_tf32_rs(c, a_hi[kk], kstep(bt_hi, kk, kTBox), 1);
}

// acc += c with f32 adds, rounded to nearest.
__device__ __forceinline__ void add_tile(float (&acc)[32],
                                         const float (&c)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(acc[e], c[e]);
}

// hi and lo of x as TF32 register words.
__device__ __forceinline__ void split_reg(float x, uint32_t& hi,
                                          uint32_t& lo) {
  const float h = tf32_rna(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rna(x - h));
}

// The keep bits of keys key0 .. key0 + 15 of query row `row` (key0 a
// multiple of 4), bit c for key key0 + c: four Philox calls.
__device__ __forceinline__ uint32_t keep_bits16(const Dropout& dp, int row,
                                                int key0, uint32_t bh) {
  uint32_t bits = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint4 r = philox4(((uint32_t)key0 >> 2) + g, (uint32_t)row, bh,
                            dp.seed_lo, dp.seed_hi);
    bits |= ((uint32_t)(r.x < dp.threshold) |
             ((uint32_t)(r.y < dp.threshold) << 1) |
             ((uint32_t)(r.z < dp.threshold) << 2) |
             ((uint32_t)(r.w < dp.threshold) << 3))
            << (4 * g);
  }
  return bits;
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
  float lse_r[2], l_r[2], dd_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + 16 * warp + (lane >> 2) + 8 * i;
    row_ok[i] = row[i] < Tq;
    lse_r[i] = row_ok[i] ? lse[(size_t)bh * Tq + row[i]] : 0.f;
    seg_r[i] = (use_seg && row_ok[i]) ? segq[(size_t)b * Tq + row[i]] : 0;
    l_r[i] = dd_r[i] = 0.f;
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
            l_r[i] += p;
            dd_r[i] = fmaf(pd, dpd[e], dd_r[i]);
          } else {
            const float ds =
                __fsub_rn(__fmul_rn(pd, dpd[e]), __fmul_rn(p, dd_r[i]));
            split_reg(ds, ds_hi[c8][frag_idx(i, jj)],
                      ds_lo[c8][frag_idx(i, jj)]);
          }
        }
      }
    }

    if (!d_pass) {  // dQ += dS K, this tile's sum added in f32
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

// The TMA map of a contiguous (B*H, T, 64) f32 tensor, read in boxes of
// box_rows rows x 32 floats with the 128-byte swizzle; rows past T read
// as zeros.
cudaError_t make_f32_map(CUtensorMap* map, const void* ptr, int T, int BH,
                         int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)kRowBytes,
                                 (cuuint64_t)T * kRowBytes};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
