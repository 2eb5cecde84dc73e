// Tensor-core and asynchronous-copy building blocks for sm_90a, through
// inline PTX: the bf16 m16n8k16 and s8 m16n8k32 mma.sync fed by
// ldmatrix.x4 (P5's and P1's probes in mma_probe.cu, the tensor-core 2-NN
// body in knn_tc.cuh) and 16-byte cp.async copies into shared memory.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, q = lane % 4):
//   A (16 x 16, row-major) a0: row g, cols 2q..2q+1; a1: row g + 8;
//                          a2, a3: the same rows, cols 8 + 2q..
//   B (16 x 8, "col": B row n = output column n) b0: k 2q..2q+1 of
//                          column g; b1: k 8 + 2q..
//   C (16 x 8 f32) c0, c1: row g, cols 2q, 2q + 1; c2, c3: row g + 8.
// m16n8k32 with s8 operands has the same layout in bytes: a0 holds bytes
// 4q..4q+3 (k 4q..4q+3) of row g, a2 bytes 16 + 4q.., b0 and b1 the same
// bytes of column g; C is s32 where bf16's is f32. So one 16 x 32-byte
// tile of either type is read by the same ldmatrix.x4 addresses.
// ldmatrix.x4 loads four 8 x 8 b16 matrices (8 rows of 16 bytes), lane l
// giving the address of row l % 8 of matrix l / 8; rows padded to an odd
// number of 16-byte units read without bank conflicts.

#pragma once

#include <stdint.h>

namespace mma_sync {

__device__ __forceinline__ void ldmatrix_x4(unsigned& r0, unsigned& r1,
                                            unsigned& r2, unsigned& r3,
                                            const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a (16 x 16 bf16) . b (16 x 8 bf16), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a (16 x 32 s8) . b (32 x 8 s8), s32 accumulators; exact while the
// sums stay within int32
__device__ __forceinline__ void mma_s8(int* c, unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes global → shared, bypassing L1 (both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(addr), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma_sync
