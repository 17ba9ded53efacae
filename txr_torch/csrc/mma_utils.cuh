// ldmatrix, the one warp-level fragment load the tensor-core kernels of this
// directory share.  Fragment layout of a 16 x 16 block of 16-bit elements as
// wgmma (and mma.sync.m16n8k16) take their A operand from registers
// (lane = 4*g + t): a0 row g elements 2t, 2t+1; a1 row g+8, same elements;
// a2 row g elements 8+2t, 9+2t; a3 row g+8, same elements.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace txr {

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

}  // namespace txr
