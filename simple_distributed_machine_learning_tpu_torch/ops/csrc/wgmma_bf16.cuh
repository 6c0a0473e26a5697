// Hopper (sm_90a) building blocks for bf16 kernels on the warpgroup tensor
// cores: wgmma with operands in 128-byte-swizzled shared memory, TMA tile
// loads completing on an mbarrier, and the named barriers two warpgroups
// use to hand each other data.
//
// Shared tiles. A [64 rows, 64 columns] bf16 block is 8 KB: row r is 128
// bytes at r * 128, and its 16-byte chunk c sits at chunk c ^ (r % 8) (the
// 128-byte swizzle, as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it). A
// [64, 64 nb] tile is nb such blocks one after the other, block b holding
// columns [64 b, 64 b + 64). Every block starts on a 1024-byte boundary.
//
// wgmma (PTX ISA, warpgroup matrix multiply): D[64 x N] (+)= A[64 x 16] .
// B[16 x N] per instruction, summed in f32. Warp w of the warpgroup holds
// rows 16 w..16 w + 15 of D, in the mma.sync m16n8 layout per n8 tile j:
// d[4 j + i] is at row 16 w + g + 8 (i / 2), column 8 j + 2 t + (i % 2),
// for lane = 4 g + t. An A operand from registers is the mma.sync m16n8k16
// A fragment of the warp's 16 rows (mma_bf16.cuh), so two accumulator n8
// tiles, rounded to bf16, are the A operand of the next product.
// Descriptors (matrix descriptor format): bits 0-13 the start address >> 4,
// 16-29 the leading byte offset >> 4, 32-45 the stride byte offset >> 4,
// 62-63 the swizzle (1: 128 bytes).
// - K-major (the contraction along a tile row: x . y^T with x, y tiles of
//   rows): 8-row groups 1024 bytes apart (stride offset); the k16 step kk
//   of a block starts 32 kk bytes into it.
// - N-major (B[k][n] with n along a tile row: p . y with y a tile of rows):
//   the transpose bit set; 8-row groups (k) 1024 bytes apart (stride
//   offset), 64-column blocks (n) 8192 bytes apart (leading offset).

#pragma once

#include <cuda.h>
#include <stdint.h>

namespace sdml_wg {

constexpr uint32_t kBlockBytes = 64 * 64 * 2;   // one swizzled [64, 64] bf16 block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (r, c) of a swizzled bf16 tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * kBlockBytes + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// K-major operand: k16 step kk of a tile at saddr, from its row r0 (a
// multiple of 8)
__device__ __forceinline__ uint64_t desc_k(uint32_t saddr, int kk, int r0 = 0) {
  return desc(saddr + (kk >> 2) * kBlockBytes + (kk & 3) * 32 + r0 * 128, 16, 1024);
}

// N-major B operand: rows [k0, k0 + 16) of a tile at saddr, all its columns
__device__ __forceinline__ uint64_t desc_n(uint32_t saddr, int k0) {
  return desc(saddr + k0 * 128, kBlockBytes, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the accumulator registers of an asm operand list stay where the
// compiler put them until the wgmma that writes them is waited for
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- mbarriers, TMA, named barriers ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the arrival, where `on` (by default thread 0's), with `bytes` of TMA
// transactions to come; the other threads' instruction is predicated off
// (no branch: a branch around it would split the warpgroup ahead of the
// next wgmma)
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes,
                                            bool on = threadIdx.x == 0) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n"
      "@q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n"
      :: "r"(bar), "r"(bytes), "r"(static_cast<uint32_t>(on)) : "memory");
}
// a plain arrival where `on` (by default thread 0's)
__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool on = threadIdx.x == 0) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %1, 0;\n"
      "@q mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(bar), "r"(static_cast<uint32_t>(on)) : "memory");
}
// until the barrier's phase of parity `parity` has completed; the spin
// stays inside the asm, so the compiler sees no divergent loop before the
// wgmma that follows (labels are local to the braces, as CUTLASS's
// ClusterBarrier::wait has them)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// a [64 rows, 64 columns] box at (column c0, row r0, slab z) of a 3-D tensor
// map into dst (1024-aligned), completing on bar; issued by the thread where
// `on` alone, by default thread 0 (predicated, as mbar_expect)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int r0,
                                         int z, uint32_t bar, bool on = threadIdx.x == 0) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %6, 0;\n"
      "@q cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n}\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(z), "r"(bar),
         "r"(static_cast<uint32_t>(on))
      : "memory");
}

// predicated accesses, for the same reason: st.shared.f32, ld.global.f32
// (0 when off), st.shared.b32, st.global.v4, st.global.b16 and st.global.f32
__device__ __forceinline__ void st_shared_if(float* p, float v, bool on) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n@q st.shared.f32 [%0], %1;\n}\n"
               :: "r"(smem_addr(p)), "f"(v), "r"(static_cast<uint32_t>(on)) : "memory");
}
__device__ __forceinline__ float ld_global_if(const float* p, bool on) {
  float v;
  asm volatile("{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\nmov.f32 %0, 0f00000000;\n"
               "@q ld.global.f32 %0, [%1];\n}\n"
               : "=f"(v) : "l"(p), "r"(static_cast<uint32_t>(on)) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_b32_if(void* p, uint32_t v, bool on) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n@q st.shared.b32 [%0], %1;\n}\n"
               :: "r"(smem_addr(p)), "r"(v), "r"(static_cast<uint32_t>(on)) : "memory");
}
__device__ __forceinline__ void st_global_v4_if(void* p, const uint4& v, bool on) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.u32 q, %5, 0;\n"
               "@q st.global.v4.b32 [%0], {%1, %2, %3, %4};\n}\n"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w),
                  "r"(static_cast<uint32_t>(on)) : "memory");
}
__device__ __forceinline__ void st_global_b16_if(void* p, uint16_t v, bool on) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n@q st.global.b16 [%0], %1;\n}\n"
               :: "l"(p), "h"(v), "r"(static_cast<uint32_t>(on)) : "memory");
}
__device__ __forceinline__ void st_global_f32_if(float* p, float v, bool on) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n@q st.global.f32 [%0], %1;\n}\n"
               :: "l"(p), "f"(v), "r"(static_cast<uint32_t>(on)) : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
// bar.arrive by the warps where `on` (the same in every lane of a warp)
__device__ __forceinline__ void bar_arrive_if(int id, int n, bool on) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n@q bar.arrive %0, %1;\n}\n"
               :: "r"(id), "r"(n), "r"(static_cast<uint32_t>(on)) : "memory");
}

// 2^x on the special-function unit (ex2.approx.ftz: ~2^-22 relative), the
// softmax's exponential for bf16 outputs
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the products ---------------------------------------------------------------

// d[0..16) (+)= A . B, m64n32k16, A and B from shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..32) (+)= A . B, m64n64k16, A and B from shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..128) (+)= A . B, m64n256k16, A from registers (a: the mma.sync
// m16n8k16 A fragment of the warp's 16 rows), B from shared memory
// N-major (transposed)
__device__ __forceinline__ void wgmma_rs_n256_tb(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace sdml_wg
