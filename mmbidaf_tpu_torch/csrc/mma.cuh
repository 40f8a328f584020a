// Tensor-core helpers of the bf16 kernels (K11-K13 in conv3x3.cu, K14 in
// winograd.cu): warp-level mma.sync on bf16 operands with f32 accumulators,
// ldmatrix to bring its fragments out of shared memory, and 16-byte cp.async
// copies with zero fill. Inline PTX, so the build needs no include path
// beyond the toolkit's; every instruction here exists from sm_80 on and is
// built for sm_90a.
//
// Fragment layouts of mma.m16n8k16.row.col (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), lane l, group g = l / 4, thread-in-group i = l % 4:
//   A [16 x 16] row-major: a0 = (g, 2i..2i+1), a1 = (g+8, 2i..), a2 = (g, 2i+8..),
//                          a3 = (g+8, 2i+8..);
//   B [16 x 8]:            b0 = (2i..2i+1, g), b1 = (2i+8.., g);
//   C/D [16 x 8] f32:      d0, d1 = (g, 2i..2i+1), d2, d3 = (g+8, 2i..2i+1).
// ldmatrix.x4 hands lane l the fragment of four 8x8 matrices whose row
// addresses come from lanes 8m..8m+7 (matrix m); for A at rows r0..r0+15,
// columns k0..k0+15, lane l gives row r0 + (l & 15), column k0 + 8 (l >> 4),
// and the four registers are a0..a3. For a B operand stored K-major (row =
// k, the n values contiguous) the .trans form gives b0, b1 of two n-tiles:
// lane l gives row k0 + (l & 15), column n0 + 8 (l >> 4).
#pragma once

#include <cuda_bf16.h>

namespace mmb {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a · b: one m16n8k16 product, bf16 operands, f32 accumulators. Each
// bf16 x bf16 product is exact in f32; the sums are taken in f32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, bypassing L1; with !pred nothing is read and
// the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two f32 values rounded to bf16 (nearest even) in one register, lo first.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace mmb
