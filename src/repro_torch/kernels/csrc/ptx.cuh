// The inline PTX that the tensor-core tiles use, each behind a small
// device function: the int8 and binary MMAs, ldmatrix, cp.async with zero
// fill, and its group commit / wait.  Everything else in the kernels is
// plain CUDA C++.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

// d += a (16x32 int8, row) . b (32x8 int8, col), int32 accumulators; the
// fragment layout of mma.m16n8k32 (PTX ISA, "Matrix fragments for
// mma.m16n8k32"): lane = 4 * g + t holds
//   a[0] row g,   k 4t..4t+3     a[1] row g+8, k 4t..4t+3
//   a[2] row g,   k 16+4t..      a[3] row g+8, k 16+4t..
//   b[0] col g,   k 4t..4t+3     b[1] col g,   k 16+4t..
//   d[0..1] row g, cols 2t, 2t+1    d[2..3] row g+8, cols 2t, 2t+1
// Exact: a 512-deep int8 dot is below 2**24 in magnitude.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = c + popc(a & b): a 16 x 128 bits (row), b 128 x 8 bits (col), int32
// accumulators; the binary MMA (mma.m16n8k128 .b1 .and.popc, sm_80 and
// later).  Lane 4 g + t holds
//   a0 row g, k 32t..32t+31     a1 row g+8, the same k
//   b0 col g, the same k
//   c, d[0..1] row g, cols 2t, 2t+1    c, d[2..3] row g+8, cols 2t, 2t+1
// (scripts/bitcount_ab.py checks the layout on the card).  A count is
// exact whatever the order of k inside a word, as long as a and b share it.
__device__ __forceinline__ void mma_b1(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned b0, const int (&c)[4]) {
  asm(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(c[0]), "r"(c[1]), "r"(c[2]),
        "r"(c[3]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 16-byte matrices from shared memory: lane L gives the (16-byte
// aligned) address of row L % 8 of matrix L / 8, and lane 4 g + t receives
// in d[i] word t of row g of matrix i: mma_s8's fragment layout, for a[0..3]
// (rows g and g + 8, k words t and t + 4) or for two n8 tiles' b0, b1.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p))
      : "memory");
}

// 16 bytes global -> shared, bypassing L1; zeros where !valid (the
// source is then not read).  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zeros where !valid.  Both 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending of this thread's committed groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace repro_torch
