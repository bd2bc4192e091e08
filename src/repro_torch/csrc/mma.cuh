// Tensor-core building blocks for sm_80+ (used on sm_90a): asynchronous
// 16-byte copies into shared memory, ldmatrix, the bf16 mma.sync
// m16n8k16 with f32 accumulation, and the hi/lo split of an f32 operand.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, c = lane % 4), each
// 32-bit register holding two bf16 (the lower index in the low half):
//   A (16 x 16, row major): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..),
//                           a3 (g+8, 2c+8..)
//   B (16 x 8, k x n):      b0 (k 2c..2c+1, n g), b1 (k 2c+8.., n g)
//   C (16 x 8, f32):        c0, c1 (g, 2c..2c+1), c2, c3 (g+8, 2c..2c+1)
// so the accumulators of two neighbouring n-tiles are, packed to bf16, the
// A fragment of one k-step of a following product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, register i receives matrix i in the A/B fragment layout.
// volatile keeps the loads in order with the barriers; the products below
// are not volatile, so the compiler may overlap them with the next loads.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: a B fragment from a row-major k x n tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b on the tensor cores: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even), x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// x = hi + lo + O(2^-17 |x|): hi = bf16(x), lo = bf16(x - hi). A product
// with an exact bf16 operand, run as hi and lo products accumulated in
// f32, keeps ~17 bits of the f32 operand instead of bf16's 8.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

}  // namespace repro
