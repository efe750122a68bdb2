// Pieces shared by the Hopper (sm_90a) bf16 kernels (flash_attn_fwd_sm90.cu,
// flash_attn_bwd_sm90.cu, conv1d_sm90.cu): the 64 x 64 bf16 tile, its TMA
// load into shared memory with the 128-byte swizzle, completing on an
// mbarrier, the wgmma descriptor of that tile, the two wgmma shapes the
// attention kernels use (both operands in shared memory; A from registers,
// B read transposed), and the accumulator layout. At the end, the pieces
// only the conv kernels use: TMA loads at any coordinates, the descriptor
// of an operand wider than one swizzle atom, and the m64n128k16 product
// with either operand K- or MN-major.

#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace sslc {
namespace {

constexpr int kWgThreads = 128;                 // one warpgroup
constexpr int kTile = 64;                       // rows or keys per tile
constexpr uint32_t kTileBytes = kTile * kD * 2;  // 8 KB: 64 rows of 128 bytes

static_assert(kD == 64, "one 128-byte swizzle row per tile row");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A load that
// never lands would hang the card: after ~10 s of clock the kernel traps,
// and its launch fails instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-row tile (rows row0 .. row0 + 63 of head bh) of a (B*H, T, 64)
// bf16 tensor into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row0,
                                              int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0),
      "r"(row0), "r"(bh)
      : "memory");
}

// Two tiles (rows row0 .. row0 + 63 of head bh of two tensors) that
// complete together on `bar`.
__device__ __forceinline__ void tma_load_pair(void* dst_a, const CUtensorMap* a,
                                              void* dst_b, const CUtensorMap* b,
                                              uint64_t* bar, int row0, int bh) {
  mbar_expect_tx(bar, 2 * kTileBytes);
  tma_load_tile(dst_a, a, bar, row0, bh);
  tma_load_tile(dst_b, b, bar, row0, bh);
}

// ----------------------------------------------------------------- wgmma

// Descriptor of a 64 x 64 bf16 tile in shared memory as TMA's 128-byte
// swizzle lays it out: rows of 128 bytes, groups of 8 rows 1024 bytes
// apart (the stride byte offset). The same descriptor serves a K-major
// operand (the 64 values of a row are the reduction dim; step 16 of them by
// adding 32 bytes) and an MN-major one (rows are the reduction dim; step 16
// rows by adding 2048 bytes), with the instruction's transpose flag.
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  uint64_t desc = (smem_addr(tile) & 0x3FFFF) >> 4;  // start address
  desc |= (uint64_t)1 << 16;                         // leading byte offset
  desc |= (uint64_t)(1024 >> 4) << 32;               // stride byte offset
  desc |= (uint64_t)1 << 62;                         // 128-byte swizzle
  return desc;
}
constexpr uint64_t kDescK16 = 32 >> 4;     // +16 values along a row
constexpr uint64_t kDescRows16 = 2048 >> 4;  // +16 rows

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define SSLC_WGMMA_D                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SSLC_WGMMA_D_OPS(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B for a 64 x 64 x 16 step, A and B K-major in shared memory.
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSLC_WGMMA_D
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SSLC_WGMMA_D_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B for a 64 x 64 x 16 step, A in registers (the accumulator
// layout's bf16 fragment), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSLC_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SSLC_WGMMA_D_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// c = A B^T over the 64 head dims: 4 K-major steps.
__device__ __forceinline__ void issue_tile_product(float (&c)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(c, desc_a + kk * kDescK16, desc_b + kk * kDescK16, kk);
}

// acc += A B with A (64 x 64, the reduction over 64 columns) as four bf16
// register fragments and B a 64-row tile read transposed.
__device__ __forceinline__ void issue_reg_product(float (&acc)[32],
                                                  const uint32_t (&a)[4][4],
                                                  uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_bt(acc, a[kk], desc_b + kk * kDescRows16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of a 64 x 64 wgmma result: thread (warp w, lane l)
// holds rows 16 w + l / 4 + 8 i (i = 0, 1) and columns 8 c8 + 2 (l % 4) + j
// (c8 = 0..7, j = 0, 1) at register 4 c8 + 2 i + j. As an A fragment over
// those columns, step kk takes columns 16 kk .. 16 kk + 15: register
// 2 (c8 % 2) + i of step c8 / 2 packs the pair j = 0, 1.
__device__ __forceinline__ int frag_reg(int c8, int i) {
  return 2 * (c8 & 1) + i;
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// The TMA map of a contiguous (B*H, T, 64) bf16 tensor, read in 64-row
// tiles with the 128-byte swizzle; rows past T read as zeros.
cudaError_t make_tile_map(CUtensorMap* map, const void* ptr, int T, int BH) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2,
                                 (cuuint64_t)T * kD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kD, (cuuint32_t)kTile, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------- the conv kernels' pieces

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// One box of a 2-D or 3-D tensor map at coordinates (c0, c1[, c2]),
// innermost first, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Descriptor of an operand made of 64-wide boxes as TMA's 128-byte swizzle
// lays them out (rows of 128 bytes, 8-row groups 1024 bytes apart: the
// stride byte offset). For an MN-major operand wider than one 128-byte
// atom (n = 128: two boxes side by side along N), the leading byte offset
// is the distance from one 64-wide box to the next; for a K-major operand,
// or an MN-major one 64 wide, it is not read.
__device__ __forceinline__ uint64_t box_desc(const void* box,
                                             uint32_t atom_bytes) {
  uint64_t desc = (smem_addr(box) & 0x3FFFF) >> 4;      // start address
  desc |= (uint64_t)((atom_bytes >> 4) & 0x3FFF) << 16;  // leading byte offset
  desc |= (uint64_t)(1024 >> 4) << 32;                   // stride byte offset
  desc |= (uint64_t)1 << 62;                             // 128-byte swizzle
  return desc;
}

template <int kGroups>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kGroups)
               : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define SSLC_WGMMA_D64                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define SSLC_WGMMA_D64_OPS(d)                                               \
  SSLC_WGMMA_D_OPS(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B for a 64 x 128 x 16 step, both operands in shared memory, B
// MN-major; A K-major (kTransA = 0) or MN-major (1). accumulate = 0
// overwrites d. The accumulator layout is the 64 x 64 one above, its
// column groups c8 running to 15.
template <int kTransA>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SSLC_WGMMA_D64
      ", %64, %65, p, 1, 1, %67, 1;\n"
      "}\n"
      : SSLC_WGMMA_D64_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA));
}

}  // namespace
}  // namespace sslc
