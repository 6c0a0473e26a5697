// bf16 tensor-core building blocks for Hopper (sm_90a) kernels written with
// mma.sync: 16-byte cp.async copies into shared memory, ldmatrix fragment
// loads, the m16n8k16 bf16 x bf16 -> f32 product and the f32 -> bf16 pack
// that turns an accumulator into an A operand.
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA), for lane = 4 g + t
// (g = lane / 4 in 0..7, t = lane % 4):
//   A (16 x 16, row-major), four .b32 registers of two bf16 each:
//     a[0] = (row g,     cols 2t, 2t+1)    a[1] = (row g + 8, cols 2t, 2t+1)
//     a[2] = (row g,     cols 2t+8, 2t+9)  a[3] = (row g + 8, cols 2t+8, 2t+9)
//   B (16 x 8, "col": B[k][n] is read as the n-th row of an n-major tile),
//     two registers: b[0] = (rows k 2t, 2t+1; col n g), b[1] = rows k + 8;
//   C/D (16 x 8, f32), four registers: element i is at
//     row g + 8 (i / 2), col 2t + (i % 2).
// So the accumulators of two adjacent n8 tiles (cols 0-7 and 8-15) are, in
// the same lanes, the A operand of one k16 slice: a[0] = pack(c0[0], c0[1]),
// a[1] = pack(c0[2], c0[3]), a[2] = pack(c1[0], c1[1]), a[3] = pack(c1[2],
// c1[3]) — a product's output feeds the next product without leaving the
// registers (FlashAttention-2's reuse).
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8m..8m+7 give the row
// addresses of matrix m, and register m of every lane receives matrix m's
// (row g, cols 2t, 2t+1) — or, with .trans, its (rows 2t, 2t+1; col g).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sdml_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, through L2 only (both addresses 16-aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// 4 bytes global -> shared (both addresses 4-aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// c += a . b on the tensor cores: a 16 x 16 bf16, b 16 x 8 bf16, c 16 x 8 f32
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even, as torch's .to(bfloat16)); lo in
// the low half, the lower column of a fragment pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace sdml_mma
