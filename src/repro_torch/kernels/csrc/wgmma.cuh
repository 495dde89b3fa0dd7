// Hopper building blocks shared by the port's tensor-core kernels
// (flash_attention.cu, flash_attention_bwd.cu, ssd_scan.cu,
// ssd_scan_bwd.cu): cp.async loads into shared memory, the swizzled tile
// layouts and the shared-memory matrix descriptors that wgmma reads, and
// the wgmma instructions themselves (sm_90a): bf16 products, and the TF32
// products and split-TF32 staging of B5's and B6's fp32 routes.
//
// Layouts (bf16 tiles; "row" is the strided dim of the tile):
//   * 128-byte swizzle: column atoms of 64 entries, [atom][row][128 B];
//     16-byte chunk c of a row r sits at (c XOR r) mod 8.  Read K-major
//     (a k16 slice is +32 bytes on the start address) or MN-major
//     (transposed; atoms LBO apart, 8-row groups 1024 bytes apart).
//   * 32-byte swizzle: blocks of 16 columns, [block][row][32 B]; the two
//     16-byte chunks of a row r swap when bit 2 of r is set.  Read K-major
//     (one k16 slice is one block, 8-row groups 256 bytes apart) or
//     MN-major (blocks LBO apart, a k16 step is +512 bytes).
// Every tile base is aligned to 1024 bytes, the longest swizzle period.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

typedef __nv_bfloat16 bf16;

constexpr uint32_t kSwRow = 128;  // bytes of one 128-byte-swizzled row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk c (entries 8c..8c+7) of row r in a tile
// of `rows` rows under the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (uint32_t)(c >> 3) * rows * kSwRow + (uint32_t)r * kSwRow +
         ((uint32_t)((c & 7) ^ (r & 7)) << 4);
}

// Byte offset of the 16-byte chunk c of row r in a tile of `rows` rows
// under the 32-byte swizzle.
__device__ __forceinline__ uint32_t swz32(int rows, int r, int c) {
  return (uint32_t)(c >> 1) * rows * 32u + (uint32_t)r * 32u +
         ((uint32_t)((c & 1) ^ ((r >> 2) & 1)) << 4);
}

// 16 bytes global -> shared, asynchronous; zero-fills when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// 4 bytes global -> shared, asynchronous (through L1); zero-fills when
// !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// all but the most recent group
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// cp.async and st.shared write through the generic proxy, wgmma reads
// through the async proxy: each thread fences its own writes before the
// barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, each in 16-byte units, and the layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
// 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return make_desc(addr, lbo, sbo, 1);
}
// K-major operand under the 128-byte swizzle: 8-row groups 1024 bytes
// apart; the leading offset is unused.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 8 * kSwRow);
}
// K-major operand under the 32-byte swizzle (layout type 3): 8-row groups
// 256 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t kmajor32_desc(uint32_t addr) {
  return make_desc(addr, 16, 8 * 32, 3);
}
// MN-major operand under the 32-byte swizzle: 16-column blocks `lbo`
// bytes apart, 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t mnmajor32_desc(uint32_t addr,
                                                   uint32_t lbo) {
  return make_desc(addr, lbo, 8 * 32, 3);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// what rounding to bf16 leaves of v: v = bf16(v) + bf16_rest(v), and
// bf16(bf16_rest(v)) carries v to ~16 significant bits, so a product taken
// once with each part (a "hi + lo" split) is exact to about 2^-16
__device__ __forceinline__ float bf16_rest(float v) {
  return v - __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi) {
  return pack_bf16(bf16_rest(lo), bf16_rest(hi));
}

// 2^x on the special-function unit (subnormal results flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator of an m64nN wgmma: thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 and 8 more, and in each 8-column block jb
// columns 8 jb + 2 (t % 4) + {0, 1}: d[4 jb + e] is row +8 (e >> 1),
// column +(e & 1).  Pairs of it, packed to bf16, are the A-register
// fragments of the next m64k16 product: keys 16 j..16 j + 15 are
// d[8 j..8 j + 7].

// D (64 x 16, fp32) (+)= A (64 x 16, bf16, shared, K-major) x
// B (16 x 16, bf16, shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, fp32) (+)= A (64 x 16, bf16, shared, M-major) x
// B (16 x 16, bf16, shared, N-major), both read transposed
// (imm-trans-a = imm-trans-b = 1); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, fp32) (+)= A (64 x 16, bf16, shared, K-major) x
// B (16 x 32, bf16, shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, fp32) (+)= A (64 x 16, bf16, shared, M-major) x
// B (16 x 32, bf16, shared, N-major), both read transposed
// (imm-trans-a = imm-trans-b = 1); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) (+)= A (64 x 16, bf16, shared, K-major) x
// B (16 x 64, bf16, shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) (+)= A (64 x 16, bf16, shared, M-major) x
// B (16 x 64, bf16, shared, N-major), both read transposed
// (imm-trans-a = imm-trans-b = 1); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) (+)= A (64 x 16, bf16, shared, M-major) x
// B (16 x 128, bf16, shared, N-major), both read transposed
// (imm-trans-a = imm-trans-b = 1); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, fp32) (+)= A (64 x 16, bf16, shared, K-major) x
// B (16 x 16, bf16, shared, N-major, so read transposed: imm-trans-b =
// 1); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_nt(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, fp32) (+)= A (64 x 16, bf16, shared, K-major) x
// B (16 x 32, bf16, shared, N-major, so read transposed: imm-trans-b =
// 1); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_nt(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) (+)= A (64 x 16, bf16, shared, K-major) x
// B (16 x 64, bf16, shared, N-major, so read transposed: imm-trans-b =
// 1); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_nt(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) (+)= A (64 x 16, bf16, shared, K-major) x
// B (16 x 128, bf16, shared, N-major, so read transposed: imm-trans-b =
// 1); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_nt(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, fp32) += A (64 x 16, bf16, registers) x B (16 x 16, bf16,
// shared, N-major, so read transposed: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 16, bf16, registers) x B (16 x 32, bf16,
// shared, N-major, so read transposed: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16, registers) x B (16 x 64, bf16,
// shared, N-major, so read transposed: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80, fp32) += A (64 x 16, bf16, registers) x B (16 x 80, bf16,
// shared, N-major, so read transposed: imm-trans-b = 1): one atom of 64
// columns and 16 of the next, LBO apart.
__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 96, fp32) += A (64 x 16, bf16, registers) x B (16 x 96, bf16,
// shared, N-major, so read transposed: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16, registers) x B (16 x 128, bf16,
// shared, N-major, so read transposed: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ---------------------------------------------------------------------------
// fp32 operands as split TF32 pairs (B5's and B6's fp32 routes)
// ---------------------------------------------------------------------------
// An fp32 value x is carried as hi = tf32(x) and lo = tf32(x - hi), each
// rounded to nearest (ties away) with the low 13 mantissa bits zero, the
// form wgmma's .tf32 operands read: x = hi + lo to ~2^-22 |x|.  A product
// a b is then lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b, ~2^-22, is
// dropped), three TF32 products into one fp32 accumulator.  TF32 wgmma
// reads both operands K-major only (no transpose), so an operand read
// along its rows is staged transposed.
//
// Tiles are fp32 under the 32-byte swizzle: [D / 8 blocks][rows][32 B],
// one block a k8 slice (kmajor32_desc of block kk at + kk * rows * 32),
// so no head dim needs padding (80 is ten blocks).

// a shared-memory base aligned up to the 32-byte swizzle's 256-byte period
__device__ __forceinline__ uint8_t* align256(uint8_t* p) {
  return p + ((256u - (smem_addr(p) & 255u)) & 255u);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The A fragment of an m64nNk8 TF32 product from 8 columns of an fp32
// accumulator (d[4 jb .. 4 jb + 3], see above): the fragment wants columns
// t % 4 and t % 4 + 4 of the thread's two rows, the accumulator holds
// 2 (t % 4) and 2 (t % 4) + 1.  Taking the latter as the former permutes
// the 8 columns as 0 2 4 6 1 3 5 7; the B operand's rows are staged in that
// order (split_raw_t), so the product is unchanged and no shuffle is
// needed.
__device__ __forceinline__ void frag_tf32(const float* d, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_tf32(d[0], hi[0], lo[0]);  // row g,     column 2 (t % 4)
  split_tf32(d[2], hi[1], lo[1]);  // row g + 8, column 2 (t % 4)
  split_tf32(d[1], hi[2], lo[2]);  // row g,     column 2 (t % 4) + 1
  split_tf32(d[3], hi[3], lo[3]);  // row g + 8, column 2 (t % 4) + 1
}

// The 16-byte chunks of a rows x D fp32 tile, as the 128 threads of a
// warpgroup take them: a warp takes 4 neighbouring chunks of 8
// neighbouring rows, so that 8 threads that store together fall in
// distinct banks.
template <int D, int ROWS>
__device__ __forceinline__ void chunk_of(int idx, int& r, int& c) {
  constexpr int kChunks = D / 4;
  c = (idx >> 3) % kChunks;
  r = (idx & 7) + 8 * (idx / (8 * kChunks));
}

// Chunk (r, c) of 4 fp32 entries split into the hi and lo tiles [D / 8][RS]
// [32 B] (rows [0, RS) of each k8 block): the K-major operand of a
// product over the D entries.
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, int rs,
                                            int r, int c, float4 x) {
  uint4 h, l;
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
  const uint32_t off = swz32(rs, r, c);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// ROWS rows of D fp32 entries, chunk (r, c) given by load(r, c), split
// into hi and lo tiles [D / 8][RS][32 B] (rows [0, ROWS) of each k8
// block): the K-major operand of a product over the D entries.  Loads B
// chunks a thread ahead of their stores.
template <int D, int ROWS, int B, int RS, typename Load>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo,
                                           Load load, int tid) {
  constexpr int kTotal = ROWS * D / 4;
  static_assert(D % 8 == 0 && ROWS % 8 == 0 && (D / 4) % 4 == 0, "tile");
#pragma unroll
  for (int i0 = 0; i0 < kTotal; i0 += B * 128) {
    float4 x[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int idx = i0 + i * 128 + tid;
      int r, c;
      chunk_of<D, ROWS>(idx, r, c);
      x[i] = idx < kTotal ? load(r, c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int idx = i0 + i * 128 + tid;
      if (idx >= kTotal) break;
      int r, c;
      chunk_of<D, ROWS>(idx, r, c);
      store_split(hi, lo, RS, r, c, x[i]);
    }
  }
}

// Rows [r0, r0 + ROWS) of an fp32 operand in device memory (rows `stride`
// entries apart, the head dim contiguous and 16-byte aligned; rows at or
// past `seq` read as zeros) into hi and lo tiles, as split_rows, 8
// chunks a thread in flight.
template <int D, int ROWS>
__device__ __forceinline__ void stage_tf32(uint8_t* hi, uint8_t* lo,
                                           const float* __restrict__ src,
                                           int64_t stride, int r0, int seq,
                                           int tid) {
  split_rows<D, ROWS, 8, ROWS>(hi, lo, [&](int r, int c) {
    return r0 + r < seq ? __ldg(reinterpret_cast<const float4*>(
                              src + (int64_t)(r0 + r) * stride + 4 * c))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }, tid);
}

// A raw stage of two fp32 operands in shared memory: ROWS rows of
// [DA entries of the first | DB of the second | 4 of padding], so that
// 8 rows' chunks at one column fall in distinct banks, then 2 * ROWS
// fp32 side values.
template <int DA, int DB, int ROWS>
__host__ __device__ constexpr int raw_floats() {
  return ROWS * (DA + DB + 4) + 2 * ROWS;
}

// Rows [r0, r0 + ROWS) of two operands (a: DA entries a row, b: DB; rows
// `as` and `bs` entries apart) into the raw stage at shared address dst
// by cp.async, 16 bytes a thread, zero-filled past `seq`; waited for with
// cp_async_wait_all.
template <int DA, int DB, int ROWS>
__device__ __forceinline__ void fetch_rows(uint32_t dst,
                                           const float* __restrict__ a,
                                           int64_t as,
                                           const float* __restrict__ b,
                                           int64_t bs, int r0, int seq,
                                           int tid) {
  constexpr int kCa = DA / 4, kC = (DA + DB) / 4, kStride = DA + DB + 4;
#pragma unroll 2
  for (int idx = tid; idx < ROWS * kC; idx += 128) {
    const int r = idx / kC, c = idx - r * kC;
    const bool ok = r0 + r < seq;
    const int64_t row = ok ? r0 + r : 0;
    const float* src = c < kCa ? a + row * as + 4 * c
                               : b + row * bs + 4 * (c - kCa);
    cp_async16(dst + (uint32_t)(r * kStride + 4 * c) * 4u, src, ok);
  }
}

// Columns [OFF, OFF + D) of a raw stage (rows STRIDE entries apart) into
// a pair tile [D / 8][hi: ROWS rows, lo: ROWS rows][32 B], 4 chunks a
// thread at a time: a k8 slice's hi rows are the B operand of an N = ROWS
// product, its hi and lo rows together that of an N = 2 ROWS product,
// which reads A once for hi_a hi_b and hi_a lo_b.
template <int D, int ROWS, int STRIDE, int OFF>
__device__ __forceinline__ void split_raw(uint8_t* pair, const float* raw,
                                          int tid) {
  split_rows<D, ROWS, 4, 2 * ROWS>(pair, pair + ROWS * 32, [&](int r, int c) {
    return *reinterpret_cast<const float4*>(raw + r * STRIDE + OFF + 4 * c);
  }, tid);
}

// Chunk (r, c) of 4 fp32 entries of a tile of ROWS rows split and
// transposed into hi and lo tiles [ROWS / 8][D][32 B] whose row d holds
// entry d of each of the ROWS rows: the K-major operand of a product over
// the ROWS rows.  With PERM, position j of each block of 8 holds row 2 j
// (j < 4) or 2 (j - 4) + 1, the order in which frag_tf32 takes an
// accumulator's columns, so that the product with an accumulator as the A
// operand is unchanged; without it, row j (the order of a K-major tile
// staged by split_rows).  The 4 threads of a warp that hold one row's 4
// chunks store their entries in a rotated order, so that a warp's 32
// stores fall in distinct banks.
template <int D, bool PERM>
__device__ __forceinline__ void store_split_t(uint8_t* hi, uint8_t* lo,
                                              int r, int c, float4 x) {
  const int a = r & 7;
  const int key = PERM ? (r & ~7) | ((a & 1) << 2) | (a >> 1) : r;
  const uint32_t base = (uint32_t)(key >> 3) * D * 32u
                        + (uint32_t)(key & 3) * 4u;
  const uint32_t half = (uint32_t)(key >> 2) & 1u;
#pragma unroll
  for (int e0 = 0; e0 < 4; ++e0) {
    const int e = (e0 + c) & 3;
    const float val = e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
    const int d = 4 * c + e;
    const uint32_t off = base + (uint32_t)d * 32u
                         + ((half ^ (((uint32_t)d >> 2) & 1u)) << 4);
    uint32_t h, l;
    split_tf32(val, h, l);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    *reinterpret_cast<uint32_t*>(lo + off) = l;
  }
}

// ROWS rows of D fp32 entries, chunk (r, c) given by load(r, c), split
// and transposed as store_split_t takes them.  Loads B chunks a thread
// ahead of their stores.
template <int D, int ROWS, int B, bool PERM, typename Load>
__device__ __forceinline__ void split_rows_t(uint8_t* hi, uint8_t* lo,
                                             Load load, int tid) {
  constexpr int kTotal = ROWS * D / 4;
  static_assert(D % 8 == 0 && ROWS % 8 == 0 && (D / 4) % 4 == 0, "tile");
#pragma unroll
  for (int i0 = 0; i0 < kTotal; i0 += B * 128) {
    float4 x[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int idx = i0 + i * 128 + tid;
      int r, c;
      chunk_of<D, ROWS>(idx, r, c);
      x[i] = idx < kTotal ? load(r, c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int idx = i0 + i * 128 + tid;
      if (idx >= kTotal) break;
      int r, c;
      chunk_of<D, ROWS>(idx, r, c);
      store_split_t<D, PERM>(hi, lo, r, c, x[i]);
    }
  }
}

// Columns [OFF, OFF + D) of a raw stage transposed, as split_rows_t with
// PERM: the B operand of a product whose A operand is an accumulator.
template <int D, int ROWS, int STRIDE, int OFF>
__device__ __forceinline__ void split_raw_t(uint8_t* hi, uint8_t* lo,
                                            const float* raw, int tid) {
  split_rows_t<D, ROWS, 4, true>(hi, lo, [&](int r, int c) {
    return *reinterpret_cast<const float4*>(raw + r * STRIDE + OFF + 4 * c);
  }, tid);
}

// D (64 x 16, fp32) (+)= A (64 x 8, tf32, shared, K-major) x
// B (8 x 16, tf32, shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, fp32) (+)= A (64 x 8, tf32, shared, K-major) x
// B (8 x 32, tf32, shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) (+)= A (64 x 8, tf32, shared, K-major) x
// B (8 x 64, tf32, shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) (+)= A (64 x 8, tf32, shared, K-major) x
// B (8 x 128, tf32, shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, fp32) += A (64 x 8, tf32, registers) x B (8 x 16, tf32,
// shared, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 8, tf32, registers) x B (8 x 32, tf32,
// shared, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 8, tf32, registers) x B (8 x 64, tf32,
// shared, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80, fp32) += A (64 x 8, tf32, registers) x B (8 x 80, tf32,
// shared, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[40],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 96, fp32) += A (64 x 8, tf32, registers) x B (8 x 96, tf32,
// shared, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 8, tf32, registers) x B (8 x 128, tf32,
// shared, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// The three products of split TF32 into one accumulator over K / 8 k8
// slices, the small terms first: lo_a hi_b and hi_a lo_b for every slice,
// then hi_a hi_b.  A and B are K-major tiles [K / 8][rows][32 B]: A's
// slices `sa` bytes apart, B's `sb`.
template <int K, int NACC>
__device__ __forceinline__ void mma3(float (&acc)[NACC], uint32_t ah,
                                     uint32_t al, uint32_t sa, uint32_t bh,
                                     uint32_t bl, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    wgmma_tf32(acc, kmajor32_desc(al + kk * sa), kmajor32_desc(bh + kk * sb),
               1);
    wgmma_tf32(acc, kmajor32_desc(ah + kk * sa), kmajor32_desc(bl + kk * sb),
               1);
  }
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    wgmma_tf32(acc, kmajor32_desc(ah + kk * sa), kmajor32_desc(bh + kk * sb),
               1);
}

// The same with A an accumulator's K / 2 values in registers, split and
// taken as frag_tf32 takes them (B staged by split_rows_t with PERM)
template <int K, int NACC>
__device__ __forceinline__ void mma3_rs(float (&acc)[NACC], const float* w,
                                        uint32_t bh, uint32_t bl,
                                        uint32_t sb) {
  uint32_t ph[K / 8][4], pl[K / 8][4];
#pragma unroll
  for (int j = 0; j < K / 8; ++j) frag_tf32(w + 4 * j, ph[j], pl[j]);
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    wgmma_tf32(acc, pl[j], kmajor32_desc(bh + j * sb));
    wgmma_tf32(acc, ph[j], kmajor32_desc(bl + j * sb));
  }
#pragma unroll
  for (int j = 0; j < K / 8; ++j)
    wgmma_tf32(acc, ph[j], kmajor32_desc(bh + j * sb));
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

}  // namespace wg
