// Tensor-core and asynchronous-copy primitives (PTX) shared by the kernels:
// - the hi/lo split of a float32 value into two TF32 values (gnn_common.cuh's
//   float32 products, "3xTF32": hi·hi + hi·lo + lo·hi);
// - wgmma m64n64k16 bf16 with both operands in shared memory and m64n64k8
//   and m64n32k8 tf32 with A from registers, through descriptors of the
//   128-byte swizzled layout (the layer routine of gnn_common.cuh); wgmma
//   m64n128k16 bf16, both operands in shared memory or A from registers
//   (rollout_chunk.cu);
// - cp.async 16-byte copies with zero fill;
// - ldmatrix / stmatrix: four 8 x 8 bf16 matrices between shared memory and
//   the pairs of a wgmma accumulator layout (rollout_chunk.cu's node-sized
//   epilogues);
// - the 128-byte swizzled layout that every wgmma operand tile of the kernels
//   is kept in: an element's place (sw128), a K-major k16 slice's descriptor
//   (sw128_desc) and the staging of a matrix into it by cp.async (stage_sw),
//   for tiles of any number of rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

using bf16 = __nv_bfloat16;

// ---- TF32 ------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo to ~2^-22 relative: hi = tf32(x), lo = tf32(x - hi) (the
// difference is exact in float32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Read-only global loads (ld.global.nc) of data no thread writes while the
// kernel runs (the activations the forward kernel kept, the weights).
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const bf16* p) { return __bfloat162float(__ldg(p)); }

// ---- cp.async -------------------------------------------------------------
// 16 bytes from global to shared memory; with `valid` false the 16 bytes are
// zeros and src is not read (it must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- ldmatrix / stmatrix ----------------------------------------------------
// Four 8 x 8 matrices of 16-bit values: lane l names row l % 8 of matrix l / 8
// (16 contiguous bytes, 16-byte aligned, any place in shared memory), and
// register m of lane l holds row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of
// matrix m, the lower column in the low half: the place of a pair of a wgmma
// accumulator layout (wgmma_m64n64k16 below) in each 8 x 8 block.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void stmatrix_x4(void* row, const uint32_t (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// ---- wgmma, bf16 ----------------------------------------------------------
// Operand tiles are kept in the 128-byte swizzled layout: blocks of rows of
// 64 bf16 (128 bytes), every 8 rows (1,024 bytes, 1,024-aligned) an atom, the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8). A tile whose rows are
// the M (or N) index and whose 64 columns are k is K-major; one whose rows are
// k and columns M (or N) is MN-major (the transposed operand of a dW = X^T dY
// product). The descriptor's start address, leading and stride byte offsets:
// for a K-major k16 slice, the rows' 8-row atoms lie 1,024 bytes apart
// (stride) and the slice starts 32 bytes per k16 step into the row; for an
// MN-major k16 slice (16 rows, one 64-wide atom column) both offsets are the
// 1,024 bytes between its two 8-row atoms, so the slice reads the same
// either way the hardware names them.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A B over one k16 step for a 64 x 64 tile of the warpgroup. TA / TB:
// 0 K-major, 1 MN-major. With accumulate 0 the old d is ignored. Thread t of
// the warpgroup holds, for i < 32, row 16 (t / 32) + (t % 32) / 4 + 8 ((i % 4)
// / 2) and column 8 (i / 4) + 2 (t % 4) + i % 2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (+)= A B over one k8 step of TF32 for a 64 x 64 tile of the warpgroup,
// A from registers (each warp's 16 rows as mma.sync m16n8k8's A fragment:
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)), B from shared memory,
// K-major (the only layout wgmma takes for tf32), in the 128-byte swizzled
// layout: 32 floats per row, a k8 step 32 bytes into it. Accumulators as in
// wgmma_m64n64k16.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// ... and for a 64 x 32 tile: accumulators as in wgmma_m64n64k16, for i < 16
// (columns 8 (i / 4) + 2 (t % 4) + i % 2).
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16], const uint32_t (&a)[4],
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// ---- wgmma m64n128k16, bf16 -----------------------------------------------
// d (+)= A B over one k16 step for a 64 x 128 tile of the warpgroup, both
// operands K-major in 128-byte swizzled shared memory, as wgmma_m64n64k16<0,
// 0>. With accumulate 0 the old d is ignored. Accumulators as in
// wgmma_m64n64k16, for i < 64.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- the 128-byte swizzled layout ------------------------------------------
// A matrix of R rows (R a multiple of 8) and up to 64 CB columns is kept as CB
// blocks of R rows x 64 bf16, block b at b R 64 elements; in each, the 16-byte
// chunk q of row r lies at chunk q ^ (r % 8) (desc_sw128's layout).

// The place of element (r, c) of such a matrix of R rows.
__device__ __forceinline__ int sw128(int r, int c, int R) {
  return (c >> 6) * (R * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// The descriptor of the K-major k16 slice ks (columns 16 ks ..) of rows r0 ..
// r0 + 63 (r0 a multiple of 8) of such a matrix of R rows.
__device__ __forceinline__ uint64_t sw128_desc(const bf16* m, int R, int r0, int ks) {
  return desc_sw128(m + (ks >> 2) * R * 64 + r0 * 64 + (ks & 3) * 16, 16, 1024);
}

// Rows [r0, r0 + R) and columns [c0, c0 + 64 CB) of src (row stride ld
// elements; rows >= rlim and columns >= clim read as zero; clim, ld and c0
// multiples of 8) into CB column blocks of R rows x 64, swizzled, by cp.async
// from threads tid = 0 .. nt - 1 (the block's, or a warpgroup's; nt a
// multiple of 8): thread tid copies the 16-byte chunk tid % 8 of every
// (nt / 8)-th row. Nothing waits or commits.
__device__ __forceinline__ void stage_sw(bf16* dst, const bf16* src, int ld, int r0, int R,
                                         int rlim, int c0, int CB, int clim, int tid, int nt) {
  const int c = tid & 7;
  for (int cb = 0; cb < CB; ++cb) {
    const int gc = c0 + cb * 64 + c * 8;
    for (int r = tid >> 3; r < R; r += nt >> 3) {
      const int gr = r0 + r;
      const bool ok = gr < rlim && gc < clim;
      cp_async16(dst + (size_t)cb * R * 64 + r * 64 + ((c ^ (r & 7)) << 3),
                 ok ? src + (size_t)gr * ld + gc : src, ok);
    }
  }
}

// ... with A from registers: each warp's 16 rows as mma.sync m16n8k16's A
// fragment, bf16 pairs (row g, columns 2t, 2t + 1), (g + 8, 2t ..), (g, 2t
// + 8 ..), (g + 8, 2t + 8 ..) for g = (t % 32) / 4, t = t % 4; B K-major in
// 128-byte swizzled shared memory. A layer's accumulators, bias, relu and
// rounding applied, are the next layer's A: the pairs of accumulators 8 ks
// .. 8 ks + 7 make k16 step ks's four registers. The registers must not
// change until the products are waited for.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Keep the compiler from moving reads or writes of wgmma's accumulators (or
// A registers) across the asynchronous products (place after wgmma_wait0).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

}  // namespace tc
