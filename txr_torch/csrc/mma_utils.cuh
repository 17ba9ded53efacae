// Small PTX wrappers shared by the tensor-core kernels of this directory:
// 16-byte asynchronous copies into shared memory, ldmatrix, and the
// mma.sync shapes the kernels use.  Fragment layouts (lane = 4*g + t):
//   A (16 rows x 32 bytes): a0 row g bytes 4t..4t+3, a1 row g+8 same bytes,
//                           a2 row g bytes 16+4t.., a3 row g+8 bytes 16+4t..
//   B (8 columns, 32 bytes of k each, k contiguous): b0 column g bytes
//                           4t..4t+3, b1 column g bytes 16+4t..
//   C (16 x 8): c0,c1 row g columns 2t,2t+1; c2,c3 row g+8.
// A byte pair is one bf16 element for m16n8k16 and two int8 for m16n8k32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace txr {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // src_bytes < 16 zero-fills the remainder of the 16-byte destination.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit elements; lane l supplies the address of row
// (l & 7) of matrix (l >> 3), and register j receives matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem_row) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16832(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace txr
