// Split-TF32 (3xTF32) tensor-core building blocks for Hopper (sm_90a)
// kernels written with mma.sync: f32 operands on the TF32 tensor cores at
// close to f32 accuracy.
//
// TF32 keeps 10 of f32's 23 stored mantissa bits, so one TF32 product of
// f32 inputs is off by ~2^-11 relative. Split each operand as x = hi + lo,
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties
// away from zero (cvt.rna's rule); hi + lo keeps ~22 bits. a.b is then
// hi_a.lo_b + lo_a.hi_b + hi_a.hi_b, summed in f32 with the small terms
// first (CUTLASS's OpMultiplyAddFastF32); lo_a.lo_b (~2^-22 relative) is
// dropped. Each TF32 x TF32 product is exact in f32, so only the f32 sums
// round.
//
// Fragment layouts of mma.sync.m16n8k8 .tf32 (PTX ISA), for lane = 4 g + t
// (g = lane / 4 in 0..7, t = lane % 4):
//   A (16 x 8, row-major), four .b32 registers of one tf32 each:
//     a[0] = (row g, col t)      a[1] = (row g + 8, col t)
//     a[2] = (row g, col t + 4)  a[3] = (row g + 8, col t + 4)
//   B (8 x 8, "col": B[k][n] is the n-th row of an n-major tile), two:
//     b[0] = (row k t, col n g)  b[1] = (row k t + 4, col n g)
//   C/D (16 x 8, f32), four: element i is at row g + 8 (i / 2), col
//     2t + (i % 2).
// An accumulator's columns (2t, 2t + 1) are not an A fragment's (t, t + 4),
// but the order of a contraction is free: read an m16n8 accumulator as the
// A operand of a k8 slice whose column t is key 2t and column t + 4 is key
// 2t + 1 (acc_a_split), and load the B operand's rows in that order
// (lds_bt_split: rows 2t and 2t + 1). A product's output so feeds the next
// product without a shuffle.
//
// f32 tiles sit in shared memory with a row stride LD = DP + 4 floats
// (4 x an odd number, mod 32 banks): the 32 lanes of lds_a_split /
// lds_b_split (rows g, columns t) and of lds_bt_split (rows 2t, columns g)
// each hit 32 distinct banks.

#pragma once

#include <stdint.h>

namespace sdml_mma {

// x rounded to TF32 (nearest, ties away from zero), as a .b32 register
// whose low 13 bits are zero: also a valid f32
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32. lo rounds by integer arithmetic: adding half a
// TF32 ulp to the magnitude's bits and clearing the 13 low ones is cvt.rna's
// rule for every value but NaN, without the NaN test cvt.rna compiles to
// (a compare and a select per value). x - hi is NaN only for an infinite
// or NaN x, whose hi is then infinite or NaN: the products stay non-finite.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

struct SplitA {                                  // an A fragment, split
  uint32_t hi[4], lo[4];
};

struct SplitB {                                  // a B fragment, split
  uint32_t hi[2], lo[2];
};

// c += a . b on the tensor cores: a 16 x 8 tf32, b 8 x 8 tf32, c 16 x 8 f32
__device__ __forceinline__ void mma_tf32_1688(float (&c)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in split TF32: lo.hi and hi.lo, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a,
                                           const SplitB& b) {
  mma_tf32_1688(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32_1688(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32_1688(c, a.hi, b.hi[0], b.hi[1]);
}

// The A fragment of rows r0..r0+15, k8 slice ks (cols 8 ks..8 ks+7), of a
// row-major f32 tile with row stride LD
template <int LD>
__device__ __forceinline__ void lds_a_split(SplitA& f, const float* tile, int r0, int ks,
                                            int lane) {
  const float* p = tile + (r0 + (lane >> 2)) * LD + ks * 8 + (lane & 3);
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * LD], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * LD + 4], f.hi[3], f.lo[3]);
}

// The B fragment of an n8 tile whose n index is the tile row (rows
// n0..n0+7), k8 slice ks along the row: for s = x . y^T
template <int LD>
__device__ __forceinline__ void lds_b_split(SplitB& f, const float* tile, int n0, int ks,
                                            int lane) {
  const float* p = tile + (n0 + (lane >> 2)) * LD + ks * 8 + (lane & 3);
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4], f.hi[1], f.lo[1]);
}

// The B fragment of an n8 tile of columns d0..d0+7 whose k index is the
// tile row k0 + 2t (b[0]) and k0 + 2t + 1 (b[1]): for acc += p . y, with p
// an accumulator read by acc_a_split
template <int LD>
__device__ __forceinline__ void lds_bt_split(SplitB& f, const float* tile, int k0, int d0,
                                             int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * LD + d0 + (lane >> 2);
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[LD], f.hi[1], f.lo[1]);
}

// The same two B fragments from a tile split ahead into its hi and lo parts
// (split_tf32 of every element, stored as .b32 in two tiles of stride LD):
// four plain loads, no arithmetic
template <int LD>
__device__ __forceinline__ void lds_b_pre(SplitB& f, const float* hi, const float* lo, int n0,
                                          int ks, int lane) {
  const int o = (n0 + (lane >> 2)) * LD + ks * 8 + (lane & 3);
  f.hi[0] = __float_as_uint(hi[o]);
  f.hi[1] = __float_as_uint(hi[o + 4]);
  f.lo[0] = __float_as_uint(lo[o]);
  f.lo[1] = __float_as_uint(lo[o + 4]);
}
template <int LD>
__device__ __forceinline__ void lds_bt_pre(SplitB& f, const float* hi, const float* lo, int k0,
                                           int d0, int lane) {
  const int o = (k0 + 2 * (lane & 3)) * LD + d0 + (lane >> 2);
  f.hi[0] = __float_as_uint(hi[o]);
  f.hi[1] = __float_as_uint(hi[o + LD]);
  f.lo[0] = __float_as_uint(lo[o]);
  f.lo[1] = __float_as_uint(lo[o + LD]);
}

// An m16n8 accumulator as the A operand of one k8 slice, its columns
// relabelled: A col t = acc col 2t, A col t + 4 = acc col 2t + 1
__device__ __forceinline__ void acc_a_split(SplitA& f, const float (&c)[4]) {
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
}

}  // namespace sdml_mma
