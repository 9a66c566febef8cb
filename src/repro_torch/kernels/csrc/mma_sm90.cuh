// Device helpers shared by the tensor-core kernels (flash_attention.cu,
// moe_gmm.cu, matmul_requant.cu): ldmatrix fragment loads, the bf16
// m16n8k16 and the int8 m16n8k32 mma.sync, 16-byte cp.async copies with
// zero fill, and packing fp32 pairs to bf16.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..2t+1),
//                           a2 = (g, 2t+8..2t+9), a3 = (g + 8, 2t+8..2t+9)
//   B (16 x 8, "col"):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1)
// Each 32-bit register holds two bf16, the lower column (or k) in the low
// half.  ldmatrix.x4 loads four 8 x 8 b16 matrices: lane i gives the
// address of row i % 8 of matrix i / 8, and register j of lane l receives
// row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1 of matrix j (.trans: the
// transposed matrix).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b on the tensor cores: A 16 x 16 and B 16 x 8 in bf16, D in fp32
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on the tensor cores: A 16 x 32 and B 32 x 8 in int8, D in int32
// (exact: no saturation, the products and sums are integers).  Layout (PTX
// ISA, "Matrix fragments for mma.m16n8k32", .s8), g = lane / 4, t = lane % 4,
// each 32-bit register holding four int8 with the lowest k in the low byte:
//   A (16 x 32, row-major): a0 = (g, 4t..4t+3),      a1 = (g + 8, 4t..4t+3),
//                           a2 = (g, 4t+16..4t+19),  a3 = (g + 8, 4t+16..4t+19)
//   B (32 x 8, "col"):      b0 = (k 4t..4t+3, n g),  b1 = (k 4t+16..4t+19, n g)
//   C (16 x 8, int32):      c0, c1 = (g, 2t..2t+1),  c2, c3 = (g + 8, 2t..2t+1)
// Which k a register holds depends on t alone, the same in A and B, so a
// kernel may feed the k of a 32-wide step in any order that is a function of
// t and the register's place, as long as A and B agree (matmul_requant.cu
// does, so that each lane loads 16 consecutive k of W at once).
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, bypassing L1.  The first src_bytes come from
// src and the rest of the 16 are zero; with src_bytes = 0 nothing is read
// (src must still be a valid address).  dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two fp32 -> one register of two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma_sm90
