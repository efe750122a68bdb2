// Split TF32 on Hopper's tensor cores: the pieces shared by the f32 kernels
// that take an f32-accurate product as three TF32 wgmma products
// (flash_attn_fwd_f32_sm90.cu, flash_attn_bwd_f32_sm90.cu,
// conv1d_f32_sm90.cu).
//
// One TF32 product keeps 10 of the 23 mantissa bits (~5e-4 relative), which
// the f32 bars (1e-4 for attention, 1e-5 for the strided conv, against the
// plain version run in float64) do not allow. So every operand x is split
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (cvt.rna.tf32.f32: to
// nearest, ties away from zero), and each product a b is taken as the three
// TF32 products hi_a lo_b + lo_a hi_b + hi_a hi_b, the two small ones first.
// The dropped lo_a lo_b and lo's own rounding are each <= 2^-22 |a b|:
// about 7e-7 relative in all, unbiased because hi is rounded to nearest (a
// truncated hi would leave lo with x's sign, and the dropped lo lo term
// would add up along a sum). tests/test_torch_flash_split_tf32.py and
// tests/test_torch_conv1d_split_tf32.py check this arithmetic against the
// Pallas kernels on the CPU, each with a control (hi hi alone) that fails
// the bar.
//
// The tensor cores add each k-step's products into the accumulator and
// truncate the sum toward zero: a bias that grows with the number of
// additions into one accumulator. So a long sum goes through fresh
// accumulators, each taking a bounded share of it, joined with f32 adds
// rounded to nearest (add_tile).
//
// TF32 wgmma takes K-major operands only (the transpose flags exist only
// for 16-bit types). TMA brings raw f32 tiles as boxes of 32 floats a row
// (128 bytes, the 128-byte swizzle); split_tile writes hi back in place and
// lo beside it (the same offsets: the layout wgmma reads) and, where a
// product sums over the tile's rows, both transposed (64 rows of dims, a
// column per row of the tile, swizzled the same way). A product whose A
// operand comes from an accumulator takes it as register fragments: the S
// accumulator gives a thread columns 2 (l % 4) + j of each group of 8, but
// the TF32 A fragment of m64nNk8 wants columns l % 4 and l % 4 + 4. A sum is
// order-free, so the fragment takes the accumulator's pair as it is
// (frag_idx), and the transposed copy of the other operand is written with
// its reduction rows in the same order (perm_col: row 2m of a group of 8 at
// column m, row 2m + 1 at m + 4).

#pragma once

#include "sm90_common.cuh"

namespace sslc {
namespace {

constexpr int kN = 32;  // rows of a streamed tile (keys or queries)
constexpr uint32_t kRowBytes = kD * 4;             // 256: one f32 row
constexpr uint32_t kResBytes = kTile * kRowBytes;  // 16 KB: 64 rows
constexpr uint32_t kResBox = kTile * 128;          // 8 KB: 64 rows x 32
constexpr uint32_t kNBytes = kN * kRowBytes;       // 8 KB: 32 rows
constexpr uint32_t kNBox = kN * 128;               // 4 KB: 32 rows x 32
constexpr uint32_t kTBox = kD * 128;     // a transposed box: 64 dims x 32
constexpr uint32_t kTBytes = kD * kN * 4;  // 8 KB: a transposed tile

static_assert(kTBytes == kTBox, "a transposed tile is one box");

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
// into t_hi and t_lo, column perm_col(row). Without kPlain, only the
// transposed copies are written (the raw tile stays as it is). kThr threads
// take part, thread t taking row t % n: the 32 lanes of a warp take 32
// rows, so neither the 16-byte reads and writes nor the transposed 4-byte
// writes conflict in a bank.
template <int n, int kThr, bool kTrans, bool kPlain = true>
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
    if (kPlain) {
      *reinterpret_cast<float4*>(hi + off) =
          make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(lo + off) =
          make_float4(l[0], l[1], l[2], l[3]);
    }
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
template <int N>
__device__ __forceinline__ void add_tile(float (&acc)[N], const float (&c)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = __fadd_rn(acc[e], c[e]);
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

// A 3-D f32 tensor map (dims innermost first, strides in bytes) read in
// boxes of 32 floats x box_rows rows x 1 with the 128-byte swizzle; a box
// past the tensor's edge reads zeros there.
cudaError_t make_f32_box_map(CUtensorMap* map, const void* ptr,
                             const cuuint64_t (&dims)[3],
                             const cuuint64_t (&strides)[2], int box_rows) {
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a contiguous (B*H, T, 64) f32 tensor, read in boxes of
// box_rows rows x 32 floats; rows past T read as zeros.
cudaError_t make_f32_map(CUtensorMap* map, const void* ptr, int T, int BH,
                         int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)kRowBytes,
                                 (cuuint64_t)T * kRowBytes};
  return make_f32_box_map(map, ptr, dims, strides, box_rows);
}

}  // namespace
}  // namespace sslc
