// Warp-level tensor-core helpers for the mma.sync kernels that read their
// operands with ldmatrix (flash_small.cu): the m16n8k16 bf16 product with
// f32 accumulation and the 8x8 matrix loads, plain and transposed, from
// shared memory. Device-inline; ops/_build.py hashes every csrc/*.cuh with
// each source, so an edit here rebuilds the libraries.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 g + t):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//     a2 = A[g][2t+8..], a3 = A[g+8][2t+8..], two bf16 a register.
//   B (16 x 8, "col"): b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g].
//   C (16 x 8, f32): c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
// An accumulator, packed to bf16 pairs, is therefore an A fragment of the
// next product: the C tiles of columns 16k..16k+7 and 16k+8..16k+15 give
// a0/a1 and a2/a3 of k-step k.
#pragma once

#include <stdint.h>

namespace {

// Four 8x8 bf16 matrices from shared memory; lane l supplies the address
// of row l % 8 of matrix l / 8, and register i of every lane receives its
// part of matrix i (row g, columns 2t and 2t + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// The same, each matrix transposed: register i receives rows 2t and
// 2t + 1 of column g of matrix i.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d (16 x 8, f32) += A (16 x 16, bf16) . B (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
