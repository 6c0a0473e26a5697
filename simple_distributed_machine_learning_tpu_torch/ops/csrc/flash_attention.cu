// Causal flash attention for Hopper (sm_90a): the forward (K1) and the two
// backward passes, dq (K2) and dk/dv (K3), of the training path.
//
// Replaces simple_distributed_machine_learning_tpu/ops/flash_attention.py::
//   _flash_kernel (K1, :127), _dq_kernel (K2, :300) and _dkv_kernel (K3,
//   :338), the Pallas TPU kernels behind its jax.custom_vjp
//   flash_attention, each in two instantiations: bf16 and f32.
//
// What each computes, per (batch*head, 64-row tile), all in f32 from inputs
// in the input dtype E (float or bf16), scale = 1/sqrt(dh):
//   K1  for the k tiles up to the causal diagonal: s = (q.k^T) * scale,
//       masked where qpos < kpos or kpos >= T with the finite NEG_INF, folded
//       into a running (acc, l, m) online softmax; p is rounded to E before
//       p.v (the TPU kernel's p.astype(v.dtype)); o = acc / max(l, 1e-30)
//       in E, and l (unnormalised row sum) and m (row max) saved in f32.
//   K2  for the k tiles up to the diagonal: p = exp(s - m) * linv
//       recomputed from the saved statistics, dp = do.v^T,
//       ds = p * (dp - delta); dq += round_E(ds * scale) . k.
//   K3  for the q tiles from the diagonal on: the same p and ds;
//       dv += round_E(p)^T . do and dk += round_E(ds * scale)^T . q.
//   The backward masks add qpos < T. linv = 1/max(l, 1e-30) and
//   delta = rowsum(do * o) are plain torch in the wrapper, as they are plain
//   jnp in the JAX package's _flash_bwd.
// The TPU kernels carry (acc, l, m) or the dq / dk, dv sums across a
// sequential grid axis; here that axis is a loop inside one thread block.
// The backward stays two passes, as in the JAX design: no atomics, and the
// result does not depend on the order in which blocks run.
// The TPU kernels' 128-lane head padding and length-1 middle axis on l/m
// were Mosaic tiling workarounds and have no counterpart here. The TPU block
// sizes (flash_block_q/k) do not reach this file: its tiles are 64 x 64,
// sized for shared memory, and another blocking changes only the order of
// f32 sums (and, in bf16, which running max p is rounded against in K1).
//
// What bounds it. bf16, at the training shapes (B 16, H 8, T 256, dh 64):
// each kernel does ~1-2 GFLOP of causal products against ~17-26 MB of
// q/k/v/o/do traffic, so all three are bound by bytes (K1 17.0 MB, K2 21.4
// MB, K3 25.6 MB: ~5-8 us at 3.35 TB/s, against 1.1-2.2 us of products at
// the 989 TFLOP/s bf16 tensor-core rate). The f32 kernels do three TF32
// products per f32 one (split TF32, below): at the full-prefix decoder's
// K1 ([1|2, 8, 256, 64]) and the tiny training row's K1-K3 ([32, 4, 64,
// 32]) bytes bound them too (0.6-1.9 us), but those grids are 32-128
// blocks, so what bounds them in practice is the serial chain of the
// longest block: per k (or q) tile, the split-TF32 products, the softmax
// (K1: online) of 16 rows a warp, the copies and a barrier (chip_smoke.py
// phase 22 (a) times K1 f32 at T = 64, 128 and 256 for the cost of one k
// tile). Each q (or k/v) tile is read from device memory once per block
// and reused across the whole loop, and causal tiles past the diagonal
// are neither loaded nor computed.
//
// Two implementations, both on the tensor cores:
// - bf16 (K1, K2, K3: flash_*_kernel_bf16_mma): every product is mma.sync
//   m16n8k16, bf16 x bf16 summed in f32 — the same casts as the TPU
//   kernels' preferred_element_type=f32 dots, only the order of the f32
//   sums differs. 4 warps per 64-row tile, each owning 16 rows: in K1 and
//   K2, 16 q rows (K1: S = Q_w.K^T, the online softmax on the accumulator
//   fragments, then O += round(P).V; K2: S = Q_w.K^T, dP = dO_w.V^T, then
//   dq += dS.K); in K3, 16 k rows computing S^T = K_w.Q^T and dP^T =
//   V_w.dO^T directly, so that p^T and ds^T come out as the A operands of
//   dv += P^T.dO and dk += dS^T.Q. p and ds never leave the registers: an
//   m16n8 accumulator pair is repacked in place as a k16 A fragment
//   (mma_bf16.cuh). Tiles stay bf16 in shared memory (rows padded to dh +
//   8 so ldmatrix is free of bank conflicts; the head dim padded with
//   zeros to DP in {16, 32, 64, 128}), and a 2-stage cp.async ring copies
//   the next k/v (K1, K2) or q/dO + row-statistics (K3) tile while this
//   one is multiplied. Shared memory at dh 64: K1 45 KB a block (q + 2 x
//   (k, v)), so 4 blocks fit an SM; K2 and K3 55 KB. Inside the diagonal
//   tile each warp skips the 16- or 32-wide sub-blocks its causal mask
//   zeroes whole.
//   K1's online softmax runs per 16- or 32-key sub-block on the fragments:
//   a row's max and sum reduce over the quad of lanes that holds it
//   (__shfl_xor_sync 1, 2); l sums the unrounded f32 p, as the TPU kernel
//   does, and p is rounded to bf16 only as the A operand of O += P.V, so p
//   is rounded against the running max of the sub-blocks seen so far (the
//   TPU kernel: of its k blocks so far; the plain version: the final max).
//   m and l are saved in the natural units of the scaled scores, which K2
//   and K3 read back. A row wholly masked in a sub-block keeps m (the max
//   with NEG_INF) and gets p = 0 from the mask, never from exp(0) = 1.
// - f32 in split TF32 (K1, K2, K3: flash_*_kernel_tf32): single-pass TF32
//   keeps ~10 bits and would break the 1e-5 parity of f32 o and the 1e-4
//   parity of the f32 gradients; each operand split as hi + lo
//   (mma_tf32.cuh), a product is three mma.sync m16n8k8 (lo.hi + hi.lo,
//   then hi.hi) summed in f32, close to f32 accuracy. The bf16 kernels'
//   structure (the same fragments of S, dP, S^T, dP^T, the same softmax,
//   masks and sub-block skips) with f32 tiles in shared memory (rows
//   padded to DP + 4 floats, conflict-free for the 32-bit fragment loads)
//   and p, ds kept in f32. The accumulator's columns (2t, 2t + 1) are read
//   as the next product's A columns (t, t + 4) by relabelling the
//   contraction, and v (K1), k (K2) or do and q (K3) are loaded in that
//   order, so p and ds still never leave the registers. The streamed tiles
//   are split as their fragments are loaded; q_w (K1, dh <= 64), q_w and
//   do_w (K2, dh <= 32) and k_w, v_w (K3, dh <= 32) are split once and
//   held. Against the chain above, each block runs 8 warps: two groups of
//   4, each warp 16 rows, group g taking the columns [32 g, 32 g + 32) of
//   every tile of the other side, so two warps share each scheduler and
//   each walks half the products; at the end group 1's online-softmax
//   state (m, l, acc) merges into group 0's (K1) or its partial dq (K2) or
//   dk, dv sums (K3) are added through the idle stage buffers. Shared
//   memory: K1 q + 2 x (k, v), 87 KB at dh 64, 169 KB at 128; K2 q, do + 2
//   x (k, v), 102 KB / 198 KB; K3 k, v + 2 x (q, do, rows), 106 KB / 204
//   KB.
// Head dims above 128, which the JAX kernels take by padding to a multiple
// of 128 lanes, run the wide kernels (both dtypes, their section below):
// each keeps the block's own rows in shared memory (K1: 128 q rows a
// block), computes the scores once per tile pair up to dh 256 and keeps
// all of dh's output sums in registers (bf16 on wgmma fed by TMA, f32 in
// split TF32), past 256 in chunks of 256 columns, so that every head dim
// >= 1 fits a block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;                  // q rows and k rows per tile

struct Args {
  const void* q;       // [BH, T, dh], contiguous, all four in the dtype
  const void* k;
  const void* v;
  const void* dout;    // backward only
  void* o;             // K1 output
  float* l;            // [BH, T] f32, K1 output
  float* m;            // [BH, T] f32, K1 output / backward input
  const float* linv;   // [BH, T] f32, backward input
  const float* delta;  // [BH, T] f32, backward input
  void* dq;            // K2 output
  void* dk;            // K3 outputs
  void* dv;
  int T, dh;
  float scale;
  int vec;             // dh a multiple of 16 bytes and q/k/v/dout 16-byte
                       // aligned: rows copy as 16-byte cp.async chunks
                       // (tensor-core kernels)
};

// ---- K1-K3 in bf16: tensor cores -----------------------------------------------

constexpr int kMmaWarps = 4;                    // each warp owns 16 of the 64 rows
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kPad = 8;                         // bf16 per shared row past DP

// Shapes of the tensor-core kernels for a head dim padded to DP (a multiple
// of 16). The row stride LD = DP + 8 bf16 puts the 8 rows one ldmatrix
// reads 16 bytes apart modulo 128, in 8 distinct groups of 4 banks.
template <int DP>
struct MmaShape {
  static constexpr int LD = DP + kPad;
  static constexpr int KS = DP / 16;            // k16 slices along dh
  static constexpr int ND = DP / 8;             // n8 tiles along dh
  static constexpr int SUB = DP > 64 ? 16 : 32; // keys (K2) / queries (K3) per step
  static constexpr int NS = SUB / 8;            // n8 tiles of a score sub-block
  static constexpr int KSS = SUB / 16;          // k16 slices of a score sub-block
  static constexpr int TILE = kTile * LD;       // bf16 per [64, LD] tile
};

// rows [r0, r0 + 64) x columns [c0, c0 + DP) of a contiguous [T, dh] slab
// of E (bf16 or f32) into a [64, DP + W] shared tile, W = the E in 16 bytes
// (one chunk of row pad: MmaShape / Tf32Shape LD, kLdS, kLdR), by a block
// of NT threads: 16-byte cp.async chunks where the slab allows (vec; c0 a
// multiple of W), else element copies; rows at or past T and columns at or
// past dh are zero
template <int DP, int NT, typename E>
__device__ __forceinline__ void load_tile_async(E* dst, const E* src, int r0, int T, int dh,
                                                bool vec, int c0 = 0) {
  constexpr int W = 16 / sizeof(E), LD = DP + W, CH = DP / W;
  for (int i = threadIdx.x; i < kTile * CH; i += NT) {
    const int r = i / CH, c = c0 + (i - r * CH) * W;
    const int row = r0 + r;
    E* d = dst + r * LD + (c - c0);
    if (row < T && c < dh) {
      const E* s = src + static_cast<long long>(row) * dh + c;
      if (vec) {
        sdml_mma::cp_async16(d, s);             // vec: dh % W == 0, so c + W <= dh
      } else {
        for (int j = 0; j < W; ++j) d[j] = c + j < dh ? s[j] : E(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// per-row f32 statistics [r0, r0 + 64) by 4-byte cp.async (0 past T), by a
// block of NT threads
template <int NT = kMmaThreads>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int r0,
                                                int T) {
  for (int r = threadIdx.x; r < kTile; r += NT) {
    if (r0 + r < T) {
      sdml_mma::cp_async4(dst + r, src + r0 + r);
    } else {
      dst[r] = 0.f;
    }
  }
}

// two adjacent output columns (col even) of a [T, dh] bf16 row
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float x0, float x1,
                                           int col, int dh) {
  if ((dh & 1) == 0 && col + 1 < dh) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < dh) dst[0] = __float2bfloat16(x0);
    if (col + 1 < dh) dst[1] = __float2bfloat16(x1);
  }
}

// the A fragment of k16 slice kk from the accumulators of n8 tiles 2 kk and
// 2 kk + 1, each value rounded to bf16
template <int NS>
__device__ __forceinline__ void pack_a(uint32_t (&af)[4], const float (&c)[NS][4],
                                       int kk) {
  af[0] = sdml_mma::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  af[1] = sdml_mma::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  af[2] = sdml_mma::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  af[3] = sdml_mma::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Offsets (in bf16) of this lane's ldmatrix.x4 row address in a [64, LD]
// tile. a_off: the A operand of rows r0..r0+15, dh slice ks (matrices:
// rows 0-7 / 8-15 x cols 0-7, then the same at cols 8-15). b_off: the B
// operands of two n8 tiles whose n index is the tile row (rows r0..r0+7 and
// r0+8..r0+15), dh slice ks — non-transposed, for s = x.y^T. bt_off: the B
// operands of two n8 tiles of dh columns d0..d0+15 whose k index is the tile
// row (rows r0..r0+15) — read with .trans, for acc += p.y.
template <int LD>
__device__ __forceinline__ int a_off(int r0, int ks, int lane) {
  return (r0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int b_off(int r0, int ks, int lane) {
  return (r0 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 + ((lane >> 3) & 1) * 8;
}
template <int LD>
__device__ __forceinline__ int bt_off(int r0, int d0, int lane) {
  return (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + d0 + (lane >> 4) * 8;
}

// K1 in bf16: one block per (b*h, 64 q rows), warp w owning q rows
// 16w..16w+15; each lane holds the running (m, l) of its rows g and g + 8
template <int DP>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_kernel_bf16_mma(Args a) {
  using S = MmaShape<DP>;
  using bf16 = __nv_bfloat16;
  using namespace sdml_mma;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;    // the longest rows start first
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;

  extern __shared__ uint4 smem_mma[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma); // [64, LD]
  bf16* kv_s = q_s + S::TILE;                    // 2 stages of k, v [64, LD]

  const int q0 = qt * kTile;
  const int n_kt = (T + kTile - 1) / kTile;
  const int last = min(n_kt - 1, qt);
  load_tile_async<DP, kMmaThreads>(q_s, q, q0, T, dh, vec);
  load_tile_async<DP, kMmaThreads>(kv_s, k, 0, T, dh, vec);
  load_tile_async<DP, kMmaThreads>(kv_s + S::TILE, v, 0, T, dh, vec);
  cp_async_commit();

  const int wr = warp * 16;
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  // the last key any live row of this warp sees (-1: no live row)
  const int kmax = q0 + wr < T ? min(q0 + wr + 15, T - 1) : -1;

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[S::KS][4];                        // q_w as A operands
#pragma unroll
  for (int s = 0; s < S::KS; ++s) ldmatrix_x4(qa[s], q_s + a_off<S::LD>(wr, s, lane));
  float acc[S::ND][4];
#pragma unroll
  for (int n = 0; n < S::ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    if (kt < last) {                             // the next k, v tile, in flight
      bf16* nxt = kv_s + ((kt + 1) & 1) * 2 * S::TILE;
      load_tile_async<DP, kMmaThreads>(nxt, k, (kt + 1) * kTile, T, dh, vec);
      load_tile_async<DP, kMmaThreads>(nxt + S::TILE, v, (kt + 1) * kTile, T, dh, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();                          // this tile's copies have landed
    __syncthreads();
    const bf16* k_s = kv_s + (kt & 1) * 2 * S::TILE;
    const bf16* v_s = k_s + S::TILE;
    const int k0 = kt * kTile;
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += S::SUB) {
      const int kb = k0 + j0;
      if (kb > kmax) break;                      // past every live row's diagonal
      float s[S::NS][4];                         // [q row, key]
#pragma unroll
      for (int n = 0; n < S::NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
#pragma unroll
        for (int n2 = 0; n2 < S::NS / 2; ++n2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, k_s + b_off<S::LD>(j0 + 16 * n2, ks, lane));
          mma_bf16_16816(s[2 * n2], qa[ks], kf[0], kf[1]);
          mma_bf16_16816(s[2 * n2 + 1], qa[ks], kf[2], kf[3]);
        }
      }
      // element i of n8 tile n sits at row g + 8 (i / 2), key
      // kb + 8 n + 2 t4 + i % 2; live: qpos >= kpos and kpos < T
      bool live[S::NS][4];
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int n = 0; n < S::NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = kb + 8 * n + 2 * t4 + (i & 1);
          live[n][i] = (i < 2 ? r_lo : r_hi) >= kp && kp < T;
          s[n][i] = live[n][i] ? s[n][i] * a.scale : kNegInf;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {         // over the quad holding a row
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float c_lo = expf(m_lo - mn_lo), c_hi = expf(m_hi - mn_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int n = 0; n < S::NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = live[n][i] ? expf(s[n][i] - (i < 2 ? mn_lo : mn_hi)) : 0.f;
          s[n][i] = p;
          if (i < 2) sum_lo += p; else sum_hi += p;
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o);
      }
      l_lo = l_lo * c_lo + sum_lo;               // the unrounded f32 p
      l_hi = l_hi * c_hi + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int n = 0; n < S::ND; ++n) {
        acc[n][0] *= c_lo;
        acc[n][1] *= c_lo;
        acc[n][2] *= c_hi;
        acc[n][3] *= c_hi;
      }
      // acc += round_bf16(p) . v over this sub-block's keys
#pragma unroll
      for (int kk = 0; kk < S::KSS; ++kk) {
        uint32_t af[4];
        pack_a<S::NS>(af, s, kk);
#pragma unroll
        for (int d2 = 0; d2 < S::ND / 2; ++d2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v_s + bt_off<S::LD>(j0 + 16 * kk, 16 * d2, lane));
          mma_bf16_16816(acc[2 * d2], af, vf[0], vf[1]);
          mma_bf16_16816(acc[2 * d2 + 1], af, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                             // this stage is free for kt + 2
  }

  bf16* o = static_cast<bf16*>(a.o) + base;
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int n = 0; n < S::ND; ++n) {
    const int col = 8 * n + 2 * t4;
    if (r_lo < T) store_pair(o + static_cast<long long>(r_lo) * dh + col,
                             acc[n][0] / den_lo, acc[n][1] / den_lo, col, dh);
    if (r_hi < T) store_pair(o + static_cast<long long>(r_hi) * dh + col,
                             acc[n][2] / den_hi, acc[n][3] / den_hi, col, dh);
  }
  if (t4 == 0) {                                 // the quad's lanes agree
    if (r_lo < T) {
      a.l[rbase + r_lo] = l_lo;
      a.m[rbase + r_lo] = m_lo;
    }
    if (r_hi < T) {
      a.l[rbase + r_hi] = l_hi;
      a.m[rbase + r_hi] = m_hi;
    }
  }
}

// K2 in bf16: one block per (b*h, 64 q rows), warp w owning q rows 16w..16w+15
template <int DP>
__global__ void __launch_bounds__(kMmaThreads) flash_dq_kernel_bf16_mma(Args a) {
  using S = MmaShape<DP>;
  using bf16 = __nv_bfloat16;
  using namespace sdml_mma;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;    // the longest rows start first
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  const bf16* dout = static_cast<const bf16*>(a.dout) + base;

  extern __shared__ uint4 smem_mma[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma); // [64, LD]
  bf16* do_s = q_s + S::TILE;                    // [64, LD]
  bf16* kv_s = do_s + S::TILE;                   // 2 stages of k, v [64, LD]

  const int q0 = qt * kTile;
  const int n_kt = (T + kTile - 1) / kTile;
  const int last = min(n_kt - 1, qt);
  load_tile_async<DP, kMmaThreads>(q_s, q, q0, T, dh, vec);
  load_tile_async<DP, kMmaThreads>(do_s, dout, q0, T, dh, vec);
  load_tile_async<DP, kMmaThreads>(kv_s, k, 0, T, dh, vec);
  load_tile_async<DP, kMmaThreads>(kv_s + S::TILE, v, 0, T, dh, vec);
  cp_async_commit();

  // this lane's two rows g and g + 8 of the warp's 16, and their statistics
  const int wr = warp * 16;
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  const float m_lo = r_lo < T ? a.m[rbase + r_lo] : 0.f;
  const float m_hi = r_hi < T ? a.m[rbase + r_hi] : 0.f;
  const float li_lo = r_lo < T ? a.linv[rbase + r_lo] : 0.f;
  const float li_hi = r_hi < T ? a.linv[rbase + r_hi] : 0.f;
  const float dl_lo = r_lo < T ? a.delta[rbase + r_lo] : 0.f;
  const float dl_hi = r_hi < T ? a.delta[rbase + r_hi] : 0.f;
  // the last key any live row of this warp sees (-1: no live row)
  const int kmax = q0 + wr < T ? min(q0 + wr + 15, T - 1) : -1;

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[S::KS][4], da[S::KS][4];          // q_w, do_w as A operands
#pragma unroll
  for (int s = 0; s < S::KS; ++s) {
    ldmatrix_x4(qa[s], q_s + a_off<S::LD>(wr, s, lane));
    ldmatrix_x4(da[s], do_s + a_off<S::LD>(wr, s, lane));
  }
  float acc[S::ND][4];
#pragma unroll
  for (int n = 0; n < S::ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    if (kt < last) {                             // the next k, v tile, in flight
      bf16* nxt = kv_s + ((kt + 1) & 1) * 2 * S::TILE;
      load_tile_async<DP, kMmaThreads>(nxt, k, (kt + 1) * kTile, T, dh, vec);
      load_tile_async<DP, kMmaThreads>(nxt + S::TILE, v, (kt + 1) * kTile, T, dh, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();                          // this tile's copies have landed
    __syncthreads();
    const bf16* k_s = kv_s + (kt & 1) * 2 * S::TILE;
    const bf16* v_s = k_s + S::TILE;
    const int k0 = kt * kTile;
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += S::SUB) {
      const int kb = k0 + j0;
      if (kb > kmax) break;                      // past every live row's diagonal
      float s[S::NS][4], dp[S::NS][4];           // [q row, key] and [q row, key]
#pragma unroll
      for (int n = 0; n < S::NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
#pragma unroll
        for (int n2 = 0; n2 < S::NS / 2; ++n2) {
          uint32_t kf[4], vf[4];
          const int off = b_off<S::LD>(j0 + 16 * n2, ks, lane);
          ldmatrix_x4(kf, k_s + off);
          ldmatrix_x4(vf, v_s + off);
          mma_bf16_16816(s[2 * n2], qa[ks], kf[0], kf[1]);
          mma_bf16_16816(s[2 * n2 + 1], qa[ks], kf[2], kf[3]);
          mma_bf16_16816(dp[2 * n2], da[ks], vf[0], vf[1]);
          mma_bf16_16816(dp[2 * n2 + 1], da[ks], vf[2], vf[3]);
        }
      }
      // p and ds * scale in place of s; element i of n8 tile n sits at row
      // g + 8 (i / 2), key kb + 8 n + 2 t4 + i % 2
#pragma unroll
      for (int n = 0; n < S::NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool hi = i >= 2;
          const int qp = hi ? r_hi : r_lo;
          const int kp = kb + 8 * n + 2 * t4 + (i & 1);
          const bool live = qp >= kp && kp < T && qp < T;
          const float p =
              live ? expf(s[n][i] * a.scale - (hi ? m_hi : m_lo)) * (hi ? li_hi : li_lo)
                   : 0.f;
          s[n][i] = p * (dp[n][i] - (hi ? dl_hi : dl_lo)) * a.scale;
        }
      }
      // dq += round_bf16(ds * scale) . k over this sub-block's keys
#pragma unroll
      for (int kk = 0; kk < S::KSS; ++kk) {
        uint32_t af[4];
        pack_a<S::NS>(af, s, kk);
#pragma unroll
        for (int d2 = 0; d2 < S::ND / 2; ++d2) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, k_s + bt_off<S::LD>(j0 + 16 * kk, 16 * d2, lane));
          mma_bf16_16816(acc[2 * d2], af, kf[0], kf[1]);
          mma_bf16_16816(acc[2 * d2 + 1], af, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();                             // this stage is free for kt + 2
  }

  bf16* dq = static_cast<bf16*>(a.dq) + base;
#pragma unroll
  for (int n = 0; n < S::ND; ++n) {
    const int col = 8 * n + 2 * t4;
    if (r_lo < T) store_pair(dq + static_cast<long long>(r_lo) * dh + col, acc[n][0],
                             acc[n][1], col, dh);
    if (r_hi < T) store_pair(dq + static_cast<long long>(r_hi) * dh + col, acc[n][2],
                             acc[n][3], col, dh);
  }
}

// K3 in bf16: one block per (b*h, 64 k rows), warp w owning k rows
// 16w..16w+15; scores are computed transposed ([key, query]), so the row
// statistics m, linv, delta (per query) are per column, staged in shared
// memory with each q tile
template <int DP>
__global__ void __launch_bounds__(kMmaThreads) flash_dkv_kernel_bf16_mma(Args a) {
  using S = MmaShape<DP>;
  using bf16 = __nv_bfloat16;
  using namespace sdml_mma;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;                     // the longest columns start first
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  const bf16* dout = static_cast<const bf16*>(a.dout) + base;

  extern __shared__ uint4 smem_mma[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_mma); // [64, LD]
  bf16* v_s = k_s + S::TILE;                     // [64, LD]
  bf16* qd_s = v_s + S::TILE;                    // 2 stages of q, do [64, LD]
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * S::TILE);  // 2 x m, linv, delta [64]

  auto load_stage = [&](int stage, int qt) {
    bf16* dst = qd_s + 2 * stage * S::TILE;
    float* rows = st_s + 3 * kTile * stage;
    const int q0 = qt * kTile;
    load_tile_async<DP, kMmaThreads>(dst, q, q0, T, dh, vec);
    load_tile_async<DP, kMmaThreads>(dst + S::TILE, dout, q0, T, dh, vec);
    load_rows_async(rows, a.m + rbase, q0, T);
    load_rows_async(rows + kTile, a.linv + rbase, q0, T);
    load_rows_async(rows + 2 * kTile, a.delta + rbase, q0, T);
  };

  const int k0 = kt * kTile;
  const int n_qt = (T + kTile - 1) / kTile;
  load_tile_async<DP, kMmaThreads>(k_s, k, k0, T, dh, vec);
  load_tile_async<DP, kMmaThreads>(v_s, v, k0, T, dh, vec);
  load_stage(0, kt);                             // from the diagonal on
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16;
  const int kr0 = k0 + wr;                       // this warp's first key
  const bool live_w = kr0 < T;
  float acc_k[S::ND][4], acc_v[S::ND][4];
#pragma unroll
  for (int n = 0; n < S::ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;

  for (int qt = kt; qt < n_qt; ++qt) {
    const int stage = (qt - kt) & 1;
    if (qt + 1 < n_qt) load_stage(stage ^ 1, qt + 1);  // the next q tile, in flight
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* q_s = qd_s + 2 * stage * S::TILE;
    const bf16* do_s = q_s + S::TILE;
    const float* m_s = st_s + 3 * kTile * stage;
    const float* li_s = m_s + kTile;
    const float* dl_s = li_s + kTile;
    const int q0 = qt * kTile;
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += S::SUB) {
      const int qb = q0 + j0;
      if (!live_w || qb >= T) break;
      if (qb + S::SUB <= kr0) continue;          // every query precedes every key
      float st[S::NS][4], dpt[S::NS][4];         // s^T, dp^T: [key row, query]
#pragma unroll
      for (int n = 0; n < S::NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        // k_w, v_w re-read for every sub-block: held in registers across
        // the loop they cost K3 a block per SM at dh 64 (173 registers
        // against 160) and ran slower
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, k_s + a_off<S::LD>(wr, ks, lane));
        ldmatrix_x4(vf, v_s + a_off<S::LD>(wr, ks, lane));
#pragma unroll
        for (int n2 = 0; n2 < S::NS / 2; ++n2) {
          uint32_t qf[4], df[4];
          const int off = b_off<S::LD>(j0 + 16 * n2, ks, lane);
          ldmatrix_x4(qf, q_s + off);
          ldmatrix_x4(df, do_s + off);
          mma_bf16_16816(st[2 * n2], kf, qf[0], qf[1]);
          mma_bf16_16816(st[2 * n2 + 1], kf, qf[2], qf[3]);
          mma_bf16_16816(dpt[2 * n2], vf, df[0], df[1]);
          mma_bf16_16816(dpt[2 * n2 + 1], vf, df[2], df[3]);
        }
      }
      // p^T in place of s^T and ds^T * scale in place of dp^T; element i of
      // n8 tile n sits at key kr0 + g + 8 (i / 2), query column
      // j0 + 8 n + 2 t4 + i % 2 of the tile
#pragma unroll
      for (int n = 0; n < S::NS; ++n) {
        const int c = j0 + 8 * n + 2 * t4;
        const float mc[2] = {m_s[c], m_s[c + 1]};
        const float lc[2] = {li_s[c], li_s[c + 1]};
        const float dc[2] = {dl_s[c], dl_s[c + 1]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = i & 1;
          const int kp = kr0 + g + 8 * (i >> 1);
          const int qp = q0 + c + j;
          const bool live = qp >= kp && kp < T && qp < T;
          const float p = live ? expf(st[n][i] * a.scale - mc[j]) * lc[j] : 0.f;
          dpt[n][i] = p * (dpt[n][i] - dc[j]) * a.scale;
          st[n][i] = p;
        }
      }
      // dv += round_bf16(p)^T . do and dk += round_bf16(ds * scale)^T . q
#pragma unroll
      for (int kk = 0; kk < S::KSS; ++kk) {
        uint32_t pa[4], sa[4];
        pack_a<S::NS>(pa, st, kk);
        pack_a<S::NS>(sa, dpt, kk);
#pragma unroll
        for (int d2 = 0; d2 < S::ND / 2; ++d2) {
          uint32_t of[4], qf[4];
          const int off = bt_off<S::LD>(j0 + 16 * kk, 16 * d2, lane);
          ldmatrix_x4_trans(of, do_s + off);
          ldmatrix_x4_trans(qf, q_s + off);
          mma_bf16_16816(acc_v[2 * d2], pa, of[0], of[1]);
          mma_bf16_16816(acc_v[2 * d2 + 1], pa, of[2], of[3]);
          mma_bf16_16816(acc_k[2 * d2], sa, qf[0], qf[1]);
          mma_bf16_16816(acc_k[2 * d2 + 1], sa, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();                             // this stage is free for qt + 2
  }

  if (!live_w) return;
  bf16* dk = static_cast<bf16*>(a.dk) + base;
  bf16* dv = static_cast<bf16*>(a.dv) + base;
  const int r_lo = kr0 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int n = 0; n < S::ND; ++n) {
    const int col = 8 * n + 2 * t4;
    if (r_lo < T) {
      const long long at = static_cast<long long>(r_lo) * dh + col;
      store_pair(dk + at, acc_k[n][0], acc_k[n][1], col, dh);
      store_pair(dv + at, acc_v[n][0], acc_v[n][1], col, dh);
    }
    if (r_hi < T) {
      const long long at = static_cast<long long>(r_hi) * dh + col;
      store_pair(dk + at, acc_k[n][2], acc_k[n][3], col, dh);
      store_pair(dv + at, acc_v[n][2], acc_v[n][3], col, dh);
    }
  }
}

// ---- K1-K3 in f32: split TF32 on the tensor cores ----------------------------------

// 8 warps a block: two groups of 4, each warp owning 16 of the 64 rows (as
// in the bf16 kernels), group g taking the 32 columns [32 g, 32 g + 32) of
// every tile of the other side (keys in K1 and K2, queries in K3); the groups'
// partial results merge through shared memory at the end
constexpr int kTf32Warps = 8;
constexpr int kTf32Threads = 32 * kTf32Warps;
constexpr int kGroupCols = kTile / 2;

// Shapes of the split-TF32 kernels for a head dim padded to DP (a multiple
// of 16). The row stride LD = DP + 4 floats keeps every fragment load free
// of bank conflicts (mma_tf32.cuh).
template <int DP>
struct Tf32Shape {
  static constexpr int LD = DP + 4;
  static constexpr int KS = DP / 8;             // k8 slices along dh
  static constexpr int ND = DP / 8;             // n8 tiles along dh
  static constexpr int SUB = DP > 64 ? 16 : 32; // keys (K1, K2) / queries (K3) per step
  static constexpr int NS = SUB / 8;            // n8 tiles (and k8 slices) of a sub-block
  static constexpr int TILE = kTile * LD;       // floats per [64, LD] tile
};

static_assert(MmaShape<16>::LD - 16 == 16 / sizeof(__nv_bfloat16) &&
                  Tf32Shape<16>::LD - 16 == 16 / sizeof(float),
              "load_tile_async pads each shared row by one 16-byte chunk");

// two adjacent output columns (col even) of a [T, dh] f32 row
__device__ __forceinline__ void store_pair(float* dst, float x0, float x1, int col, int dh) {
  if ((dh & 1) == 0 && col + 1 < dh) {
    *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
  } else {
    if (col < dh) dst[0] = x0;
    if (col + 1 < dh) dst[1] = x1;
  }
}

// K1 in f32: one block per (b*h, 64 q rows), warp w owning q rows
// 16 (w % 4)..16 (w % 4) + 15 and the keys [32 g, 32 g + 32) of every k
// tile for group g = w / 4; each lane holds the running (m, l) of its rows
// g and g + 8 over its group's keys. The bf16 K1's structure, with every
// product in split TF32 and p kept in f32 (round_E is the identity); group
// 1's (m, l, acc) merge into group 0's at the end.
template <int DP>
__global__ void __launch_bounds__(kTf32Threads) flash_fwd_kernel_tf32(Args a) {
  using S = Tf32Shape<DP>;
  using namespace sdml_mma;
  // q_w's split fragments take DP registers a lane: held across the loop
  // up to dh 64, re-read from shared memory at 128
  constexpr bool kHoldQ = DP <= 64;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;    // the longest rows start first
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp >> 2;                    // this warp's half of each k tile
  const int g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;

  extern __shared__ uint4 smem_mma[];
  float* q_s = reinterpret_cast<float*>(smem_mma); // [64, LD]
  float* kv_s = q_s + S::TILE;                     // 2 stages of k, v [64, LD]

  const int q0 = qt * kTile;
  const int n_kt = (T + kTile - 1) / kTile;
  const int last = min(n_kt - 1, qt);
  load_tile_async<DP, kTf32Threads>(q_s, q, q0, T, dh, vec);
  load_tile_async<DP, kTf32Threads>(kv_s, k, 0, T, dh, vec);
  load_tile_async<DP, kTf32Threads>(kv_s + S::TILE, v, 0, T, dh, vec);
  cp_async_commit();

  const int wr = (warp & 3) * 16;
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  // the last key any live row of this warp sees (-1: no live row)
  const int kmax = q0 + wr < T ? min(q0 + wr + 15, T - 1) : -1;

  cp_async_wait<0>();
  __syncthreads();
  SplitA qa[kHoldQ ? S::KS : 1];                // q_w as A operands
  if constexpr (kHoldQ) {
#pragma unroll
    for (int s = 0; s < S::KS; ++s) lds_a_split<S::LD>(qa[s], q_s, wr, s, lane);
  }
  float acc[S::ND][4];
#pragma unroll
  for (int n = 0; n < S::ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    if (kt < last) {                             // the next k, v tile, in flight
      float* nxt = kv_s + ((kt + 1) & 1) * 2 * S::TILE;
      load_tile_async<DP, kTf32Threads>(nxt, k, (kt + 1) * kTile, T, dh, vec);
      load_tile_async<DP, kTf32Threads>(nxt + S::TILE, v, (kt + 1) * kTile, T, dh, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();                          // this tile's copies have landed
    __syncthreads();
    const float* k_s = kv_s + (kt & 1) * 2 * S::TILE;
    const float* v_s = k_s + S::TILE;
    const int k0 = kt * kTile;
#pragma unroll 1
    for (int j0 = grp * kGroupCols; j0 < (grp + 1) * kGroupCols; j0 += S::SUB) {
      const int kb = k0 + j0;
      if (kb > kmax) break;                      // past every live row's diagonal
      float s[S::NS][4];                         // [q row, key]
#pragma unroll
      for (int n = 0; n < S::NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        SplitA qf;
        if constexpr (kHoldQ) {
          qf = qa[ks];
        } else {
          lds_a_split<S::LD>(qf, q_s, wr, ks, lane);
        }
#pragma unroll
        for (int n = 0; n < S::NS; ++n) {
          SplitB kf;
          lds_b_split<S::LD>(kf, k_s, j0 + 8 * n, ks, lane);
          mma_3xtf32(s[n], qf, kf);
        }
      }
      // element i of n8 tile n sits at row g + 8 (i / 2), key
      // kb + 8 n + 2 t4 + i % 2; live: qpos >= kpos and kpos < T
      bool live[S::NS][4];
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int n = 0; n < S::NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = kb + 8 * n + 2 * t4 + (i & 1);
          live[n][i] = (i < 2 ? r_lo : r_hi) >= kp && kp < T;
          s[n][i] = live[n][i] ? s[n][i] * a.scale : kNegInf;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {         // over the quad holding a row
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float c_lo = expf(m_lo - mn_lo), c_hi = expf(m_hi - mn_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int n = 0; n < S::NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = live[n][i] ? expf(s[n][i] - (i < 2 ? mn_lo : mn_hi)) : 0.f;
          s[n][i] = p;
          if (i < 2) sum_lo += p; else sum_hi += p;
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o);
      }
      l_lo = l_lo * c_lo + sum_lo;
      l_hi = l_hi * c_hi + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int n = 0; n < S::ND; ++n) {
        acc[n][0] *= c_lo;
        acc[n][1] *= c_lo;
        acc[n][2] *= c_hi;
        acc[n][3] *= c_hi;
      }
      // acc += p . v over this sub-block's keys: n8 tile kk of p is the k8
      // slice of keys kb + 8 kk .. + 7, in acc_a_split's order
#pragma unroll
      for (int kk = 0; kk < S::NS; ++kk) {
        SplitA pa;
        acc_a_split(pa, s[kk]);
#pragma unroll
        for (int d = 0; d < S::ND; ++d) {
          SplitB vf;
          lds_bt_split<S::LD>(vf, v_s, j0 + 8 * kk, 8 * d, lane);
          mma_3xtf32(acc[d], pa, vf);
        }
      }
    }
    __syncthreads();                             // this stage is free for kt + 2
  }

  // group 1 hands its (m, l, acc) to group 0 through the (now idle) k/v
  // stages: acc as a [64, LD] tile, then m and l per row
  cp_async_wait<0>();
  float* acc_s = kv_s;
  float* ml_s = kv_s + S::TILE;
  const int row_lo = wr + g, row_hi = row_lo + 8;
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < S::ND; ++n) {
      const int col = 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(acc_s + row_lo * S::LD + col) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(acc_s + row_hi * S::LD + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
    if (t4 == 0) {
      ml_s[row_lo] = m_lo;
      ml_s[row_hi] = m_hi;
      ml_s[kTile + row_lo] = l_lo;
      ml_s[kTile + row_hi] = l_hi;
    }
  }
  __syncthreads();
  if (grp == 1) return;
  {
    // every live row has key 0 in group 0, so m_lo / m_hi are finite there
    const float m1_lo = ml_s[row_lo], m1_hi = ml_s[row_hi];
    const float mn_lo = fmaxf(m_lo, m1_lo), mn_hi = fmaxf(m_hi, m1_hi);
    const float c0_lo = expf(m_lo - mn_lo), c0_hi = expf(m_hi - mn_hi);
    const float c1_lo = expf(m1_lo - mn_lo), c1_hi = expf(m1_hi - mn_hi);
    l_lo = l_lo * c0_lo + ml_s[kTile + row_lo] * c1_lo;
    l_hi = l_hi * c0_hi + ml_s[kTile + row_hi] * c1_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < S::ND; ++n) {
      const int col = 8 * n + 2 * t4;
      const float2 x_lo = *reinterpret_cast<const float2*>(acc_s + row_lo * S::LD + col);
      const float2 x_hi = *reinterpret_cast<const float2*>(acc_s + row_hi * S::LD + col);
      acc[n][0] = acc[n][0] * c0_lo + x_lo.x * c1_lo;
      acc[n][1] = acc[n][1] * c0_lo + x_lo.y * c1_lo;
      acc[n][2] = acc[n][2] * c0_hi + x_hi.x * c1_hi;
      acc[n][3] = acc[n][3] * c0_hi + x_hi.y * c1_hi;
    }
  }

  float* o = static_cast<float*>(a.o) + base;
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int n = 0; n < S::ND; ++n) {
    const int col = 8 * n + 2 * t4;
    if (r_lo < T) store_pair(o + static_cast<long long>(r_lo) * dh + col,
                             acc[n][0] / den_lo, acc[n][1] / den_lo, col, dh);
    if (r_hi < T) store_pair(o + static_cast<long long>(r_hi) * dh + col,
                             acc[n][2] / den_hi, acc[n][3] / den_hi, col, dh);
  }
  if (t4 == 0) {                                 // the quad's lanes agree
    if (r_lo < T) {
      a.l[rbase + r_lo] = l_lo;
      a.m[rbase + r_lo] = m_lo;
    }
    if (r_hi < T) {
      a.l[rbase + r_hi] = l_hi;
      a.m[rbase + r_hi] = m_hi;
    }
  }
}

// K2 in f32: one block per (b*h, 64 q rows), warp w owning q rows
// 16 (w % 4)..16 (w % 4) + 15 and the keys [32 g, 32 g + 32) of every k
// tile for group g = w / 4. The bf16 K2's structure, with every product in
// split TF32 and ds kept in f32 (round_E is the identity): S = Q_w.K^T and
// dP = dO_w.V^T as K1's S, then dq += dS.K as K1's P.V (ds read through
// acc_a_split, k's rows loaded in its order). Each group sums a partial dq
// over its keys; group 1's is added to group 0's at the end.
template <int DP>
__global__ void __launch_bounds__(kTf32Threads) flash_dq_kernel_tf32(Args a) {
  using S = Tf32Shape<DP>;
  using namespace sdml_mma;
  // q_w's and do_w's split fragments take 2 DP registers a lane: held
  // across the loop up to dh 32, re-read from shared memory above
  constexpr bool kHoldQD = DP <= 32;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;    // the longest rows start first
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp >> 2;                    // this warp's half of each k tile
  const int g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;

  extern __shared__ uint4 smem_mma[];
  float* q_s = reinterpret_cast<float*>(smem_mma); // [64, LD]
  float* do_s = q_s + S::TILE;                     // [64, LD]
  float* kv_s = do_s + S::TILE;                    // 2 stages of k, v [64, LD]

  const int q0 = qt * kTile;
  const int n_kt = (T + kTile - 1) / kTile;
  const int last = min(n_kt - 1, qt);
  load_tile_async<DP, kTf32Threads>(q_s, q, q0, T, dh, vec);
  load_tile_async<DP, kTf32Threads>(do_s, dout, q0, T, dh, vec);
  load_tile_async<DP, kTf32Threads>(kv_s, k, 0, T, dh, vec);
  load_tile_async<DP, kTf32Threads>(kv_s + S::TILE, v, 0, T, dh, vec);
  cp_async_commit();

  // this lane's two rows g and g + 8 of the warp's 16, and their statistics
  const int wr = (warp & 3) * 16;
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  const float m_lo = r_lo < T ? a.m[rbase + r_lo] : 0.f;
  const float m_hi = r_hi < T ? a.m[rbase + r_hi] : 0.f;
  const float li_lo = r_lo < T ? a.linv[rbase + r_lo] : 0.f;
  const float li_hi = r_hi < T ? a.linv[rbase + r_hi] : 0.f;
  const float dl_lo = r_lo < T ? a.delta[rbase + r_lo] : 0.f;
  const float dl_hi = r_hi < T ? a.delta[rbase + r_hi] : 0.f;
  // the last key any live row of this warp sees (-1: no live row)
  const int kmax = q0 + wr < T ? min(q0 + wr + 15, T - 1) : -1;

  cp_async_wait<0>();
  __syncthreads();
  SplitA qa[kHoldQD ? S::KS : 1], da[kHoldQD ? S::KS : 1];  // q_w, do_w as A operands
  if constexpr (kHoldQD) {
#pragma unroll
    for (int s = 0; s < S::KS; ++s) {
      lds_a_split<S::LD>(qa[s], q_s, wr, s, lane);
      lds_a_split<S::LD>(da[s], do_s, wr, s, lane);
    }
  }
  float acc[S::ND][4];
#pragma unroll
  for (int n = 0; n < S::ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    if (kt < last) {                             // the next k, v tile, in flight
      float* nxt = kv_s + ((kt + 1) & 1) * 2 * S::TILE;
      load_tile_async<DP, kTf32Threads>(nxt, k, (kt + 1) * kTile, T, dh, vec);
      load_tile_async<DP, kTf32Threads>(nxt + S::TILE, v, (kt + 1) * kTile, T, dh, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();                          // this tile's copies have landed
    __syncthreads();
    const float* k_s = kv_s + (kt & 1) * 2 * S::TILE;
    const float* v_s = k_s + S::TILE;
    const int k0 = kt * kTile;
#pragma unroll 1
    for (int j0 = grp * kGroupCols; j0 < (grp + 1) * kGroupCols; j0 += S::SUB) {
      const int kb = k0 + j0;
      if (kb > kmax) break;                      // past every live row's diagonal
      float s[S::NS][4], dp[S::NS][4];           // [q row, key] and [q row, key]
#pragma unroll
      for (int n = 0; n < S::NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        SplitA qf, df;
        if constexpr (kHoldQD) {
          qf = qa[ks];
          df = da[ks];
        } else {
          lds_a_split<S::LD>(qf, q_s, wr, ks, lane);
          lds_a_split<S::LD>(df, do_s, wr, ks, lane);
        }
#pragma unroll
        for (int n = 0; n < S::NS; ++n) {
          SplitB kf, vf;
          lds_b_split<S::LD>(kf, k_s, j0 + 8 * n, ks, lane);
          lds_b_split<S::LD>(vf, v_s, j0 + 8 * n, ks, lane);
          mma_3xtf32(s[n], qf, kf);
          mma_3xtf32(dp[n], df, vf);
        }
      }
      // ds * scale in place of s; element i of n8 tile n sits at row
      // g + 8 (i / 2), key kb + 8 n + 2 t4 + i % 2
#pragma unroll
      for (int n = 0; n < S::NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool hi = i >= 2;
          const int qp = hi ? r_hi : r_lo;
          const int kp = kb + 8 * n + 2 * t4 + (i & 1);
          const bool live = qp >= kp && kp < T && qp < T;
          const float p =
              live ? expf(s[n][i] * a.scale - (hi ? m_hi : m_lo)) * (hi ? li_hi : li_lo)
                   : 0.f;
          s[n][i] = p * (dp[n][i] - (hi ? dl_hi : dl_lo)) * a.scale;
        }
      }
      // dq += (ds * scale) . k over this sub-block's keys: n8 tile kk of ds
      // is the k8 slice of keys kb + 8 kk .. + 7, in acc_a_split's order
#pragma unroll
      for (int kk = 0; kk < S::NS; ++kk) {
        SplitA sa;
        acc_a_split(sa, s[kk]);
#pragma unroll
        for (int d = 0; d < S::ND; ++d) {
          SplitB kf;
          lds_bt_split<S::LD>(kf, k_s, j0 + 8 * kk, 8 * d, lane);
          mma_3xtf32(acc[d], sa, kf);
        }
      }
    }
    __syncthreads();                             // this stage is free for kt + 2
  }

  // group 1 hands its partial dq to group 0 through the (now idle) k/v
  // stages, as a [64, LD] tile
  cp_async_wait<0>();
  float* dq_s = kv_s;
  const int row_lo = wr + g, row_hi = row_lo + 8;
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < S::ND; ++n) {
      const int col = 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(dq_s + row_lo * S::LD + col) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(dq_s + row_hi * S::LD + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int n = 0; n < S::ND; ++n) {
    const int col = 8 * n + 2 * t4;
    const float2 x_lo = *reinterpret_cast<const float2*>(dq_s + row_lo * S::LD + col);
    const float2 x_hi = *reinterpret_cast<const float2*>(dq_s + row_hi * S::LD + col);
    acc[n][0] += x_lo.x;
    acc[n][1] += x_lo.y;
    acc[n][2] += x_hi.x;
    acc[n][3] += x_hi.y;
  }
  float* dq = static_cast<float*>(a.dq) + base;
#pragma unroll
  for (int n = 0; n < S::ND; ++n) {
    const int col = 8 * n + 2 * t4;
    if (r_lo < T) store_pair(dq + static_cast<long long>(r_lo) * dh + col, acc[n][0],
                             acc[n][1], col, dh);
    if (r_hi < T) store_pair(dq + static_cast<long long>(r_hi) * dh + col, acc[n][2],
                             acc[n][3], col, dh);
  }
}

// K3 in f32: one block per (b*h, 64 k rows), warp w owning k rows
// 16 (w % 4)..16 (w % 4) + 15 and the queries [32 g, 32 g + 32) of every q
// tile for group g = w / 4, scores computed transposed ([key, query]) as in
// the bf16 K3, every product in split TF32; group 1's dk, dv sums are added
// to group 0's at the end
template <int DP>
__global__ void __launch_bounds__(kTf32Threads) flash_dkv_kernel_tf32(Args a) {
  using S = Tf32Shape<DP>;
  using namespace sdml_mma;
  // k_w's and v_w's split fragments take 2 DP registers a lane: held
  // across the loop up to dh 32, re-read from shared memory above
  constexpr bool kHoldKV = DP <= 32;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;                     // the longest columns start first
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp >> 2;                    // this warp's half of each q tile
  const int g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;

  extern __shared__ uint4 smem_mma[];
  float* k_s = reinterpret_cast<float*>(smem_mma); // [64, LD]
  float* v_s = k_s + S::TILE;                      // [64, LD]
  float* qd_s = v_s + S::TILE;                     // 2 stages of q, do [64, LD]
  float* st_s = qd_s + 4 * S::TILE;                // 2 x m, linv, delta [64]

  auto load_stage = [&](int stage, int qt) {
    float* dst = qd_s + 2 * stage * S::TILE;
    float* rows = st_s + 3 * kTile * stage;
    const int q0 = qt * kTile;
    load_tile_async<DP, kTf32Threads>(dst, q, q0, T, dh, vec);
    load_tile_async<DP, kTf32Threads>(dst + S::TILE, dout, q0, T, dh, vec);
    load_rows_async<kTf32Threads>(rows, a.m + rbase, q0, T);
    load_rows_async<kTf32Threads>(rows + kTile, a.linv + rbase, q0, T);
    load_rows_async<kTf32Threads>(rows + 2 * kTile, a.delta + rbase, q0, T);
  };

  const int k0 = kt * kTile;
  const int n_qt = (T + kTile - 1) / kTile;
  load_tile_async<DP, kTf32Threads>(k_s, k, k0, T, dh, vec);
  load_tile_async<DP, kTf32Threads>(v_s, v, k0, T, dh, vec);
  load_stage(0, kt);                             // from the diagonal on
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wr = (warp & 3) * 16;
  const int kr0 = k0 + wr;                       // this warp's first key
  const bool live_w = kr0 < T;
  SplitA ka[kHoldKV ? S::KS : 1], va[kHoldKV ? S::KS : 1];  // k_w, v_w as A operands
  if constexpr (kHoldKV) {
#pragma unroll
    for (int s = 0; s < S::KS; ++s) {
      lds_a_split<S::LD>(ka[s], k_s, wr, s, lane);
      lds_a_split<S::LD>(va[s], v_s, wr, s, lane);
    }
  }
  float acc_k[S::ND][4], acc_v[S::ND][4];
#pragma unroll
  for (int n = 0; n < S::ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;

  for (int qt = kt; qt < n_qt; ++qt) {
    const int stage = (qt - kt) & 1;
    if (qt + 1 < n_qt) load_stage(stage ^ 1, qt + 1);  // the next q tile, in flight
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* q_s = qd_s + 2 * stage * S::TILE;
    const float* do_s = q_s + S::TILE;
    const float* m_s = st_s + 3 * kTile * stage;
    const float* li_s = m_s + kTile;
    const float* dl_s = li_s + kTile;
    const int q0 = qt * kTile;
#pragma unroll 1
    for (int j0 = grp * kGroupCols; j0 < (grp + 1) * kGroupCols; j0 += S::SUB) {
      const int qb = q0 + j0;
      if (!live_w || qb >= T) break;
      if (qb + S::SUB <= kr0) continue;          // every query precedes every key
      float st[S::NS][4], dpt[S::NS][4];         // s^T, dp^T: [key row, query]
#pragma unroll
      for (int n = 0; n < S::NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        SplitA kf, vf;
        if constexpr (kHoldKV) {
          kf = ka[ks];
          vf = va[ks];
        } else {
          lds_a_split<S::LD>(kf, k_s, wr, ks, lane);
          lds_a_split<S::LD>(vf, v_s, wr, ks, lane);
        }
#pragma unroll
        for (int n = 0; n < S::NS; ++n) {
          SplitB qf, df;
          lds_b_split<S::LD>(qf, q_s, j0 + 8 * n, ks, lane);
          lds_b_split<S::LD>(df, do_s, j0 + 8 * n, ks, lane);
          mma_3xtf32(st[n], kf, qf);
          mma_3xtf32(dpt[n], vf, df);
        }
      }
      // p^T in place of s^T and ds^T * scale in place of dp^T; element i of
      // n8 tile n sits at key kr0 + g + 8 (i / 2), query column
      // j0 + 8 n + 2 t4 + i % 2 of the tile
#pragma unroll
      for (int n = 0; n < S::NS; ++n) {
        const int c = j0 + 8 * n + 2 * t4;
        const float mc[2] = {m_s[c], m_s[c + 1]};
        const float lc[2] = {li_s[c], li_s[c + 1]};
        const float dc[2] = {dl_s[c], dl_s[c + 1]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = i & 1;
          const int kp = kr0 + g + 8 * (i >> 1);
          const int qp = q0 + c + j;
          const bool live = qp >= kp && kp < T && qp < T;
          const float p = live ? expf(st[n][i] * a.scale - mc[j]) * lc[j] : 0.f;
          dpt[n][i] = p * (dpt[n][i] - dc[j]) * a.scale;
          st[n][i] = p;
        }
      }
      // dv += p^T . do and dk += (ds * scale)^T . q: n8 tile kk of p^T and
      // ds^T is the k8 slice of queries qb + 8 kk .. + 7, in acc_a_split's
      // order
#pragma unroll
      for (int kk = 0; kk < S::NS; ++kk) {
        SplitA pa, sa;
        acc_a_split(pa, st[kk]);
        acc_a_split(sa, dpt[kk]);
#pragma unroll
        for (int d = 0; d < S::ND; ++d) {
          SplitB of, qf;
          lds_bt_split<S::LD>(of, do_s, j0 + 8 * kk, 8 * d, lane);
          lds_bt_split<S::LD>(qf, q_s, j0 + 8 * kk, 8 * d, lane);
          mma_3xtf32(acc_v[d], pa, of);
          mma_3xtf32(acc_k[d], sa, qf);
        }
      }
    }
    __syncthreads();                             // this stage is free for qt + 2
  }

  // group 1 hands its dk, dv sums to group 0 through the (now idle) q/do
  // stages, as two [64, LD] tiles
  cp_async_wait<0>();
  float* dk_s = qd_s;
  float* dv_s = qd_s + S::TILE;
  const int row_lo = wr + g, row_hi = row_lo + 8;
  if (grp == 1 && live_w) {
#pragma unroll
    for (int n = 0; n < S::ND; ++n) {
      const int col = 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(dk_s + row_lo * S::LD + col) =
          make_float2(acc_k[n][0], acc_k[n][1]);
      *reinterpret_cast<float2*>(dk_s + row_hi * S::LD + col) =
          make_float2(acc_k[n][2], acc_k[n][3]);
      *reinterpret_cast<float2*>(dv_s + row_lo * S::LD + col) =
          make_float2(acc_v[n][0], acc_v[n][1]);
      *reinterpret_cast<float2*>(dv_s + row_hi * S::LD + col) =
          make_float2(acc_v[n][2], acc_v[n][3]);
    }
  }
  __syncthreads();
  if (grp == 1 || !live_w) return;
#pragma unroll
  for (int n = 0; n < S::ND; ++n) {
    const int col = 8 * n + 2 * t4;
    const float2 k_lo = *reinterpret_cast<const float2*>(dk_s + row_lo * S::LD + col);
    const float2 k_hi = *reinterpret_cast<const float2*>(dk_s + row_hi * S::LD + col);
    const float2 v_lo = *reinterpret_cast<const float2*>(dv_s + row_lo * S::LD + col);
    const float2 v_hi = *reinterpret_cast<const float2*>(dv_s + row_hi * S::LD + col);
    acc_k[n][0] += k_lo.x;
    acc_k[n][1] += k_lo.y;
    acc_k[n][2] += k_hi.x;
    acc_k[n][3] += k_hi.y;
    acc_v[n][0] += v_lo.x;
    acc_v[n][1] += v_lo.y;
    acc_v[n][2] += v_hi.x;
    acc_v[n][3] += v_hi.y;
  }
  float* dk = static_cast<float*>(a.dk) + base;
  float* dv = static_cast<float*>(a.dv) + base;
  const int r_lo = kr0 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int n = 0; n < S::ND; ++n) {
    const int col = 8 * n + 2 * t4;
    if (r_lo < T) {
      const long long at = static_cast<long long>(r_lo) * dh + col;
      store_pair(dk + at, acc_k[n][0], acc_k[n][1], col, dh);
      store_pair(dv + at, acc_v[n][0], acc_v[n][1], col, dh);
    }
    if (r_hi < T) {
      const long long at = static_cast<long long>(r_hi) * dh + col;
      store_pair(dk + at, acc_k[n][2], acc_k[n][3], col, dh);
      store_pair(dv + at, acc_v[n][2], acc_v[n][3], col, dh);
    }
  }
}

// ---- K1, K2 and K3 at head dims above 128: the wide kernels -------------------
//
// Replace _flash_kernel (K1, :127), _dq_kernel (K2, :300) and _dkv_kernel
// (K3, :338) of the JAX package's ops/flash_attention.py past dh 128, which
// the JAX kernels take by padding the head dim to a multiple of 128 lanes:
// bf16 flash_{fwd,dq,dkv}_kernel_wide_wgmma, f32 flash_{fwd,dq,dkv}_kernel_wide_tf32.
// The tilings above hold whole rows of dh in shared memory and whole output
// rows in registers; past 128 they do not fit (the f32 K1 at dh 256 would
// take 338 KB a block, past the 227 KB a block may have).
//
// What bounds them. At [2, 16, 2048, 256] K1 does ~0.07 TFLOP of causal
// products (s and p . v, each 2 x 64 x 64 x dh a tile pair), K2 and K3
// ~0.10-0.14 (s, dp and the output product), against 0.07-0.1 GB of
// q/k/v/o/do traffic: bound by operations (bf16 0.07-0.14 ms at 989
// TFLOP/s; f32 three TF32 products a product, 0.4-0.8 ms at 495). Their
// first design streamed the contraction in 256-byte slices with a [64, 64]
// score tile per 4-warp block and made the outputs in column chunks of
// 128 (K1, K2) or 64 (K3), recomputing the scores for every chunk and
// streaming the block's own rows again at every step: it was bound by what
// each step copied through L2 into shared memory.
//
// The design here, for every kernel and both dtypes: one launch, 8 warps a
// block; the block's own rows (K1: q; K2: q and do; K3: k and v) are loaded
// once and stay in shared memory; the other side's tiles (K1, K2: k, v; K3:
// q, do) stream through a 2-stage ring; the scores are computed once per
// tile pair over the whole contraction, and the output sums for all of dh
// stay in registers:
// - K1 owns 128 q rows a block: each half of 64 rows (a warpgroup in bf16;
//   4 warps of 16 rows in f32) takes all 64 keys of every k tile, so each
//   k/v tile that lands in shared memory serves 128 rows (half the L2
//   traffic per row of a 64-row block), and each half keeps its own
//   running (m, l, o): the online softmax takes a tile's 64 keys at once,
//   o is rescaled by exp(m_old - m_new), p is rounded to E only as the A
//   operand of o += p . v and l sums the unrounded f32 p; no merge. When a
//   block's last k tile lies past the first half's rows, bf16 computes that
//   half's fully masked products there (p = 0) rather than branch around
//   its wgmmas (below), f32 warps skip the tile.
// - K2 splits each k tile's 64 keys: half h computes s and dp for q x keys
//   [32 h, 32 h + 32), ds in registers, and dq_h += ds . k[those keys] over
//   every column; the two partial dq add through shared memory once, at
//   the end.
// - K3 in bf16 splits each q tile's 64 queries the same way (s^T, dp^T,
//   p^T and ds^T of 32 queries a half), then half 0 makes dv += p^T . do
//   and half 1 dk += ds^T . q over all 64 queries, each taking the other
//   half's operand fragments (bf16, 4 KB) through shared memory. In f32 K3
//   splits the products: half 0 s^T, p^T and dv, half 1 dp^T and dk, with
//   ds^T from half 0's p^T (f32, 16 KB).
// Past dh 256 the resident rows do not fit: the outputs are made in chunks
// of 256 columns, and for each chunk the scores are computed again over the
// whole contraction, with the own rows streamed beside the other side's
// (slices of 128 bf16 or 64 f32 columns), so the scores are computed
// ceil(dh / 256) times (twice at dh 512).
// - bf16: two warpgroups on wgmma (K1's s m64n64k16, K2 and K3's s and dp
//   m64n32k16, from shared memory, the chains unrolled; the outputs
//   m64n256k16 with p / ds as the A operand from registers and the other
//   side's tile as B, N-major). Tiles are [64, 64] blocks in the 128-byte
//   swizzle (wgmma_bf16.cuh); the ring is filled by TMA from one thread,
//   completing on an mbarrier per stage (by all threads with plain copies
//   when dh is not a multiple of 8 or a pointer is not 16-byte aligned,
//   which TMA cannot take). No branch that splits a warpgroup sits between
//   its wgmmas (K2 and K3: thread 0's TMA issue, the statistics and the
//   stores are predicated instructions), so ptxas keeps them asynchronous.
//   K1 issues its refills from one thread in a branch after the products'
//   waits, which ptxas also keeps asynchronous: an issue predicated in every
//   thread compiles to a loop over the lanes that every thread runs. K1's
//   two warpgroups take turns to issue their products, so that one's
//   softmax runs under the other's. The softmax's exponential is
//   ex2.approx with log2(e) folded into the scale. The outputs leave
//   through a swizzled bf16 tile in shared memory, in 16-byte rows. Shared
//   memory a block: K1 q 64 KB + 2 stages x (k, v) 64 KB, 193 KB; K2 and
//   K3 own 64 KB, 2 x 64 KB, exchange 16 KB, 210 KB.
// - f32: split TF32 on mma.sync (WarpTf32's fragments), the other side's
//   tiles in 64-column slices through a cp.async ring: K1 reads a k tile's
//   slices for the scores, then v's for p . v, each slice split into its
//   TF32 hi and lo parts once as it lands (not by each of the 8 warps that
//   read it); K2 and K3 read the other side twice per tile pair (for the
//   scores, then for the output product). The scores' slice sums stay
//   separate before they add (WarpTf32). Shared memory: K1 q 130 KB + 2 x
//   (slice, lo part) 34 KB, 198 KB; K2 and K3 own 130 KB, 2 stages x 34 KB,
//   K3 p 16 KB. K1 keeps 128 rows in f32 too: 8 warps of 16 rows x 64 keys
//   hold o (128 registers a lane) and s (32), as many as K2's dq and s, dp.
// p and ds are rounded to the input dtype only as the output product's
// operand, as in the narrow kernels; the sums are f32. m and l are K1's at
// dh <= 128 in every way but the order of the f32 sums.

constexpr int kBwdThreads = 256;                 // two groups of 4 warps
constexpr int kFwdRows = 2 * kTile;              // q rows of a wide K1 block
constexpr float kLog2e = 1.4426950408889634f;

// A warp's split-TF32 products (mma_tf32.cuh) for the f32 wide kernels:
//   xyT: s[n] += X[xr0 + 0..15, 0..KW) . Y[yr0 + 8 n + 0..7, 0..KW)^T;
//   pY:  acc[d] += P . Y[yr0 + 0..8 NN, 8 d + 0..7], P the warp's NN m16n8
//        accumulators (16 rows x 8 NN columns) as the A operand.
struct WarpTf32 {
  // A slice's products sum in fresh accumulators (1 / HALVES of the n8
  // tiles at a time: each half loads and splits x's fragments again, two
  // halves hold half the registers), added to s in f32 once per slice: the
  // tensor cores round their f32 sums toward zero, so one accumulator
  // carried through a 512-wide contraction (192 products a value) drifts
  // past the 1e-5 of l and m, where a slice's chain (24) stays as short as
  // the dh 64 kernels'. PRE: y is split ahead, its hi part at y and its lo
  // part at ylo.
  template <int LDX, int LDY, int NN, int KW, bool PRE = false, int HALVES = 2>
  static __device__ __forceinline__ void xyT(float (&s)[NN][4], const float* x, int xr0,
                                             const float* y, int yr0, int lane,
                                             const float* ylo = nullptr) {
    using namespace sdml_mma;
    constexpr int NH = NN / HALVES;
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      float part[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KW / 8; ++ks) {
        SplitA af;
        lds_a_split<LDX>(af, x, xr0, ks, lane);
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          SplitB bf;
          if constexpr (PRE) {
            lds_b_pre<LDY>(bf, y, ylo, yr0 + 8 * (h * NH + n), ks, lane);
          } else {
            lds_b_split<LDY>(bf, y, yr0 + 8 * (h * NH + n), ks, lane);
          }
          mma_3xtf32(part[n], af, bf);
        }
      }
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[h * NH + n][i] += part[n][i];
    }
  }
  // n8 tile kk of P is the k8 slice of Y's rows yr0 + 8 kk .. + 7, in
  // acc_a_split's order (lds_bt_split loads them so)
  template <int LDY, int NN, int ND, bool PRE = false>
  static __device__ __forceinline__ void pY(float (&acc)[ND][4], const float (&p)[NN][4],
                                            const float* y, int yr0, int lane,
                                            const float* ylo = nullptr) {
    using namespace sdml_mma;
#pragma unroll
    for (int kk = 0; kk < NN; ++kk) {
      SplitA pa;
      acc_a_split(pa, p[kk]);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        SplitB f;
        if constexpr (PRE) {
          lds_bt_pre<LDY>(f, y, ylo, yr0 + 8 * kk, 8 * d, lane);
        } else {
          lds_bt_split<LDY>(f, y, yr0 + 8 * kk, 8 * d, lane);
        }
        mma_3xtf32(acc[d], pa, f);
      }
    }
  }
};

template <int ND>
__device__ __forceinline__ void zero_acc(float (&c)[ND][4]) {
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
}


// The steps of a wide backward block: per other-side tile t (and, past dh
// 256, per output chunk c), `per` steps s, the first ns of them score
// steps. At dh <= 256 a bf16 step loads the tile and does both parts; an
// f32 tile takes ns score steps, then as many output steps (64-column
// slices); past 256 the score steps stream the contraction and the rest
// make chunk c.
struct WStep {
  int c, t, s;
  bool score, out;
};

__device__ __forceinline__ WStep wide_step(int i, int per, int ns, int ntiles, int t0) {
  WStep w;
  const int tile = i / per;
  w.s = i - tile * per;
  w.c = tile / ntiles;
  w.t = t0 + (tile - w.c * ntiles);
  w.score = w.s < ns;
  w.out = w.s >= ns;
  return w;
}

// ---- bf16: wgmma, TMA -------------------------------------------------------------

constexpr uint32_t kWgTile = 4 * sdml_wg::kBlockBytes;    // a [64, 256] tile, 32 KB
constexpr uint32_t kWgStage = 2 * kWgTile;                // two of them
constexpr uint32_t kWgP = 64 * 64 * 4;                    // K3's fragment exchange
constexpr size_t kWgSmem = 1024 + kWgStage * 3 + kWgP + 2 * 192 * 4 + 3 * 8;
constexpr size_t kWgFwdSmem = 1024 + kWgStage * 3 + 9 * 8;  // K1: q, 2 stages

struct WgMaps {
  const CUtensorMap* own_a;                      // K2: q, do; K3: k, v
  const CUtensorMap* own_b;
  const CUtensorMap* other_a;                    // K2: k, v; K3: q, do
  const CUtensorMap* other_b;
};

// rows [r0, r0 + 64) x column blocks [b0, b0 + nb) of x ([T, dh] of one
// b*h) into the swizzled tile at dst, by all threads with plain copies;
// zeros past T and dh
__device__ __forceinline__ void fill_swizzled(uint8_t* dst, const __nv_bfloat16* x, int b0,
                                              int nb, int r0, int T, int dh) {
  // a trip count the same in every thread (4096 elements a block)
  for (int i0 = 0; i0 < nb * 4096; i0 += kBwdThreads) {
    const int i = i0 + threadIdx.x;
    const int b = i >> 12, r = (i >> 6) & 63, cc = i & 63;
    const int row = r0 + r, col = (b0 + b) * 64 + cc;
    const bool in = row < T && col < dh;
    const __nv_bfloat16 val = x[in ? static_cast<long long>(row) * dh + col : 0];
    *reinterpret_cast<__nv_bfloat16*>(dst + sdml_wg::swz(r, b * 64 + cc)) =
        in ? val : __float2bfloat16(0.f);
  }
}

// One load of a wide bf16 step: column blocks [b0, b0 + nb) of rows
// [r0, r0 + 64) into dst
struct WgLoad {
  const CUtensorMap* map;
  const __nv_bfloat16* x;
  uint32_t off;
  int b0, nb, r0;
};

// Loads `n` tiles into the stage at base, completing on bar: TMA from
// thread 0, or plain copies by every thread and one arrival. Every thread
// of the block calls it.
// The TMA loads of `n` tiles into the stage at base, completing on bar,
// issued by the thread where `leader` (its arrival announces the bytes)
__device__ __forceinline__ void wg_tma(const WgLoad (&ld)[4], int n, uint8_t* base, int bh,
                                       uint32_t bar, bool leader) {
  using namespace sdml_wg;
  uint32_t bytes = 0;
  for (int j = 0; j < n; ++j) bytes += ld[j].nb * kBlockBytes;
  mbar_expect(bar, bytes, leader);
  for (int j = 0; j < n; ++j)
    for (int b = 0; b < ld[j].nb; ++b)
      tma_load(smem_addr(base + ld[j].off + b * kBlockBytes), ld[j].map, (ld[j].b0 + b) * 64,
               ld[j].r0, bh, bar, leader);
}

__device__ __forceinline__ void wg_fill(const WgLoad (&ld)[4], int n, uint8_t* base, int bh,
                                        int T, int dh, bool tma, uint32_t bar) {
  using namespace sdml_wg;
  if (tma) {
    wg_tma(ld, n, base, bh, bar, threadIdx.x == 0);  // thread 0's, as its arrival
  } else {
    for (int j = 0; j < n; ++j)
      fill_swizzled(base + ld[j].off, ld[j].x, ld[j].b0, ld[j].nb, ld[j].r0, T, dh);
    fence_async_smem();
    __syncthreads();
    mbar_arrive(bar);                            // thread 0's
  }
}

// The tiles of wide bf16 step w into a stage: at dh <= 256 the other side's
// tile t whole (a at 0, b at 32 KB); past 256, a score step's 128-column
// slice s of the other side's tile (a at 0, b at 32 KB) and of the own tile
// (a at 16 KB, b at 48 KB), an output step the other side's chunk c (a, and
// b when out_b)
__device__ __forceinline__ int wg_step_loads(WgLoad (&ld)[4], const WStep& w, bool split,
                                             bool out_b, int own_r0, int nbt,
                                             const WgMaps& m, const __nv_bfloat16* own_a,
                                             const __nv_bfloat16* own_b,
                                             const __nv_bfloat16* oth_a,
                                             const __nv_bfloat16* oth_b) {
  const int r0 = w.t * kTile;
  if (!split) {
    ld[0] = WgLoad{m.other_a, oth_a, 0, 0, nbt, r0};
    ld[1] = WgLoad{m.other_b, oth_b, kWgTile, 0, nbt, r0};
    return 2;
  }
  if (w.score) {
    const int b0 = 2 * w.s, nb = min(2, nbt - b0);
    ld[0] = WgLoad{m.other_a, oth_a, 0, b0, nb, r0};
    ld[1] = WgLoad{m.own_a, own_a, kWgTile / 2, b0, nb, own_r0};
    ld[2] = WgLoad{m.other_b, oth_b, kWgTile, b0, nb, r0};
    ld[3] = WgLoad{m.own_b, own_b, kWgTile + kWgTile / 2, b0, nb, own_r0};
    return 4;
  }
  const int b0 = 4 * w.c, nb = min(4, nbt - b0);
  ld[0] = WgLoad{m.other_a, oth_a, 0, b0, nb, r0};
  ld[1] = WgLoad{m.other_b, oth_b, kWgTile, b0, nb, r0};
  return out_b ? 2 : 1;
}

// the 64-column blocks of a score step's contraction: all of dh's at dh <=
// 256 (3 or 4), else those of 128-column slice s below dh (1 or 2)
__device__ __forceinline__ int wg_blocks(bool split, int s, int nbt) {
  return split ? min(2, nbt - 2 * s) : nbt;
}

// The score chains of one step, unrolled: d[c] (+)= X[c] . Y[c]^T over NB
// blocks (4 NB k16 steps, m64n32k16: 32 rows of Y from yr0) for each of the
// NC chains; sd 0 for a step that starts the sums. A loop with a run-time
// trip count would carry the accumulators through moves that serialize
// the wgmmas.
template <int NB, int NC>
__device__ __forceinline__ void wg_score_chains(float (*d[NC])[16], const uint32_t (&x)[NC],
                                                const uint32_t (&y)[NC], int yr0, int sd) {
  using namespace sdml_wg;
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_ss_n32(*d[c], desc_k(x[c], kk), desc_k(y[c], kk, yr0), sd || kk > 0);
}

template <int NC>
__device__ __forceinline__ void wg_scores(int nb, float (*d[NC])[16], const uint32_t (&x)[NC],
                                          const uint32_t (&y)[NC], int yr0, int sd) {
  switch (nb) {
    case 1: wg_score_chains<1, NC>(d, x, y, yr0, sd); break;
    case 2: wg_score_chains<2, NC>(d, x, y, yr0, sd); break;
    case 3: wg_score_chains<3, NC>(d, x, y, yr0, sd); break;
    default: wg_score_chains<4, NC>(d, x, y, yr0, sd); break;
  }
}

// the A fragment of k16 slice kk from accumulator n8 tiles 2 kk, 2 kk + 1
template <int N>
__device__ __forceinline__ void wg_pack(uint32_t (&af)[4], const float (&d)[N], int kk) {
  af[0] = sdml_mma::pack_bf16(d[8 * kk], d[8 * kk + 1]);
  af[1] = sdml_mma::pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  af[2] = sdml_mma::pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  af[3] = sdml_mma::pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

__device__ __forceinline__ uint8_t* align1024(void* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// The end of a chunk: a warpgroup's [64, 256] f32 accumulator rounded to
// bf16 into a swizzled [64, 256] tile at dst (32 KB) where `on`, then the
// tile copied out by the whole block in 16-byte rows (element stores when
// dh is not a multiple of 8 or a pointer not 16-byte aligned). Every store
// is predicated: no branch splits a warpgroup between its wgmmas.
__device__ __forceinline__ void wg_stage(uint8_t* dst, const float (&acc)[128], int warp,
                                         int g, int t4, bool on) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sdml_wg::st_shared_b32_if(dst + sdml_wg::swz(16 * warp + g + 8 * h, 8 * j + 2 * t4),
                                sdml_mma::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]),
                                on);
  }
}

// rows [r0, r0 + 64) x columns [c0, c0 + 256) of a [T, dh] bf16 output from
// the staged tile at src, by NT threads (t: this one's index among them)
template <int NT>
__device__ __forceinline__ void wg_copy_out(__nv_bfloat16* out, const uint8_t* src, int r0,
                                            int c0, int T, int dh, bool vec, int t) {
#pragma unroll
  for (int pass = 0; pass < 64 * 32 / NT; ++pass) {
    const int r = NT / 32 * pass + (t >> 5), ch = t & 31;
    const int row = r0 + r, col = c0 + 8 * ch;
    const uint4 v = *reinterpret_cast<const uint4*>(src + sdml_wg::swz(r, 8 * ch));
    __nv_bfloat16* at = out + static_cast<long long>(min(row, T - 1)) * dh;
    if (vec) {
      sdml_wg::st_global_v4_if(at + min(col, dh - 8), v, row < T && col < dh);
    } else {
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        sdml_wg::st_global_b16_if(at + min(col + k, dh - 1), e[k], row < T && col + k < dh);
    }
  }
}

// K2, wide, bf16: one block per (b*h, 64 q rows); warpgroup h takes keys
// [32 h, 32 h + 32) of every k tile. Per tile: s = q . k_h^T and dp =
// do . v_h^T (m64n32k16), ds in registers, dq_h += round(ds * scale) .
// k_h (m64n256k16); the two dq_h add through shared memory at the end of
// each 256-column chunk.
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dq_kernel_wide_wgmma(Args a, const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo) {
  using namespace sdml_wg;
  using bf16 = __nv_bfloat16;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;    // the longest rows start first
  const int T = a.T, dh = a.dh;
  const bool tma = a.vec != 0;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  const bf16* dout = static_cast<const bf16*>(a.dout) + base;
  bf16* dq = static_cast<bf16*>(a.dq) + base;

  extern __shared__ uint4 smem_mma[];
  uint8_t* own = align1024(smem_mma);            // q at 0, do at 32 KB
  uint8_t* stages = own + kWgStage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + 2 * kWgStage + kWgP + 2 * 192 * 4);
  const uint32_t bar0 = smem_addr(bars), bar_own = bar0 + 16;

  const int q0 = qt * kTile;
  const int last = min((T + kTile - 1) / kTile - 1, qt);
  const int nbt = (dh + 63) >> 6;
  const bool split = dh > 256;
  const int ns = split ? (dh + 127) >> 7 : 1;
  const int per = split ? ns + 1 : 1;
  const int nch = split ? (dh + 255) >> 8 : 1;
  const int ntiles = last + 1;
  const int nsteps = nch * ntiles * per;
  const WgMaps maps{&tq, &tdo, &tk, &tv};

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_init(bar_own, 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int i, int st) {
    WgLoad ld[4];
    WStep w = wide_step(i, per, split ? ns : 1, ntiles, 0);
    if (!split) w.score = w.out = true;
    const int n = wg_step_loads(ld, w, split, false, q0, nbt, maps, q, dout, k, v);
    wg_fill(ld, n, stages + st * kWgStage, bh, T, dh, tma, bar0 + 8 * st);
  };
  if (!split) {
    const WgLoad ld[4] = {WgLoad{&tq, q, 0, 0, nbt, q0},
                          WgLoad{&tdo, dout, kWgTile, 0, nbt, q0}, WgLoad{}, WgLoad{}};
    wg_fill(ld, 2, own, bh, T, dh, tma, bar_own);
  }
  issue(0, 0);
  if (nsteps > 1) issue(1, 1);

  const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
  const float m_lo = r_lo < T ? a.m[rbase + r_lo] : 0.f;
  const float m_hi = r_hi < T ? a.m[rbase + r_hi] : 0.f;
  const float li_lo = r_lo < T ? a.linv[rbase + r_lo] : 0.f;
  const float li_hi = r_hi < T ? a.linv[rbase + r_hi] : 0.f;
  const float dl_lo = r_lo < T ? a.delta[rbase + r_lo] : 0.f;
  const float dl_hi = r_hi < T ? a.delta[rbase + r_hi] : 0.f;
  // exp(s scale - m) as 2^(s scale log2 e - m log2 e)
  const float scale2 = a.scale * kLog2e, m2_lo = m_lo * kLog2e, m2_hi = m_hi * kLog2e;

  float acc[128], sc[16], dp[16];
#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    const int st = i & 1;
    WStep w = wide_step(i, per, split ? ns : 1, ntiles, 0);
    if (!split) w.score = w.out = true;
    if (i == 0 && !split) mbar_wait(bar_own, 0);
    mbar_wait(bar0 + 8 * st, (i >> 1) & 1);
    const uint32_t sa = smem_addr(stages + st * kWgStage);
    if (w.score) {
      const uint32_t x[2] = {split ? sa + kWgTile / 2 : smem_addr(own),
                             split ? sa + kWgTile + kWgTile / 2 : smem_addr(own) + kWgTile};
      const uint32_t y[2] = {sa, sa + kWgTile};
      float(*d[2])[16] = {&sc, &dp};
      hold(sc);
      hold(dp);
      fence();
      wg_scores<2>(wg_blocks(split, w.s, nbt), d, x, y, 32 * wg, w.s > 0);
      commit();
      wait_all();
      hold(sc);
      hold(dp);
    }
    if (w.out) {
      // ds * scale in place of s: element i of n8 tile j sits at row
      // 16 warp + g + 8 (i / 2), key 32 wg + 8 j + 2 t4 + i % 2
      const int kb = w.t * kTile + 32 * wg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const int qp = hi ? r_hi : r_lo;
          const int kp = kb + 8 * j + 2 * t4 + (e & 1);
          const bool live = qp >= kp && kp < T && qp < T;
          const float p = live ? exp2_approx(sc[4 * j + e] * scale2 - (hi ? m2_hi : m2_lo)) *
                                     (hi ? li_hi : li_lo)
                               : 0.f;
          sc[4 * j + e] = p * (dp[4 * j + e] - (hi ? dl_hi : dl_lo)) * a.scale;
        }
      }
      uint32_t af[2][4];
      wg_pack(af[0], sc, 0);
      wg_pack(af[1], sc, 1);
      hold(acc);
      fence();
      // the chunk's first tile starts the sums (acc is written only here,
      // never in a branch that splits a warpgroup)
      wgmma_rs_n256_tb(acc, af[0], desc_n(sa, 32 * wg), w.t > 0);
      wgmma_rs_n256_tb(acc, af[1], desc_n(sa, 32 * wg + 16), 1);
      commit();
      wait_all();
      hold(acc);
    }
    __syncthreads();                             // this stage is free for step i + 2
    if (i + 2 < nsteps) issue(i + 2, st);
    if (w.out && w.t == last) {                  // chunk c is complete
      // the two warpgroups' dq add through own's area (its rows are read
      // no more): warpgroup 1's partial out, then every thread adds (the
      // sum is warpgroup 0's; warpgroup 1's acc is started afresh by the
      // next chunk's first wgmma), staged as bf16 and copied out
      float* red = reinterpret_cast<float*>(own);
#pragma unroll
      for (int j = 0; j < 128; ++j) st_shared_if(red + j * 128 + wt, acc[j], wg == 1);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] += red[j * 128 + wt];
      __syncthreads();
      wg_stage(own, acc, warp, g, t4, wg == 0);
      __syncthreads();
      wg_copy_out<kBwdThreads>(dq, own, q0, 256 * w.c, T, dh, tma, tid);
      __syncthreads();
    }
  }
}

// K3, wide, bf16: one block per (b*h, 64 k rows), scores transposed
// ([key, query]). Warpgroup h takes queries [32 h, 32 h + 32) of every q
// tile from the diagonal on: s^T = k . q_h^T and dp^T = v . do_h^T
// (m64n32k16), p^T and ds^T in registers. Warpgroup 0 makes dv +=
// round(p)^T . do, warpgroup 1 dk += round(ds * scale)^T . q (m64n256k16):
// each hands the other its half of the A operand (bf16 fragments, 4 KB a
// warpgroup) through shared memory.
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dkv_kernel_wide_wgmma(Args a, const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo) {
  using namespace sdml_wg;
  using bf16 = __nv_bfloat16;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;                     // the longest columns start first
  const int T = a.T, dh = a.dh;
  const bool tma = a.vec != 0;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  const bf16* dout = static_cast<const bf16*>(a.dout) + base;

  extern __shared__ uint4 smem_mma[];
  uint8_t* own = align1024(smem_mma);            // k at 0, v at 32 KB
  uint8_t* stages = own + kWgStage;
  uint32_t* xf = reinterpret_cast<uint32_t*>(stages + 2 * kWgStage);  // [2][8][128]
  float* rows_s = reinterpret_cast<float*>(xf) + 64 * 64;  // 2 x (m, linv, delta) [64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows_s + 2 * 192);
  const uint32_t bar0 = smem_addr(bars), bar_own = bar0 + 16;

  const int k0 = kt * kTile;
  const int n_qt = (T + kTile - 1) / kTile;
  const int nbt = (dh + 63) >> 6;
  const bool split = dh > 256;
  const int ns = split ? (dh + 127) >> 7 : 1;
  const int per = split ? ns + 1 : 1;
  const int nch = split ? (dh + 255) >> 8 : 1;
  const int ntiles = n_qt - kt;
  const int nsteps = nch * ntiles * per;
  const WgMaps maps{&tk, &tv, &tq, &tdo};

  // thread tid < 192's row statistic of step i's q tile (m, linv, delta:
  // 64 each), loaded a step ahead; rows_s[192 (i & 1)..] holds step i's
  const bool stat_on = tid < 192;
  const float* stat_src = tid < 64 ? a.m : tid < 128 ? a.linv : a.delta;
  auto row_stat = [&](int i) {
    const int qp = wide_step(i, per, split ? ns : 1, ntiles, kt).t * kTile + (tid & 63);
    return ld_global_if(stat_src + rbase + min(qp, T - 1), stat_on && i < nsteps && qp < T);
  };
  st_shared_if(rows_s + (stat_on ? tid : 0), row_stat(0), stat_on);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_init(bar_own, 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int i, int st) {
    WgLoad ld[4];
    WStep w = wide_step(i, per, split ? ns : 1, ntiles, kt);
    if (!split) w.score = w.out = true;
    const int n = wg_step_loads(ld, w, split, true, k0, nbt, maps, k, v, q, dout);
    wg_fill(ld, n, stages + st * kWgStage, bh, T, dh, tma, bar0 + 8 * st);
  };
  if (!split) {
    const WgLoad ld[4] = {WgLoad{&tk, k, 0, 0, nbt, k0}, WgLoad{&tv, v, kWgTile, 0, nbt, k0},
                          WgLoad{}, WgLoad{}};
    wg_fill(ld, 2, own, bh, T, dh, tma, bar_own);
  }
  issue(0, 0);
  if (nsteps > 1) issue(1, 1);

  const int kr = k0 + 16 * warp + g;             // this lane's keys kr, kr + 8
  const float scale2 = a.scale * kLog2e;         // exp(x) as 2^(x log2 e)
  const bool w0 = wg == 0;
  float acc[128], sc[16], dp[16];
#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    const int st = i & 1;
    WStep w = wide_step(i, per, split ? ns : 1, ntiles, kt);
    if (!split) w.score = w.out = true;
    const int q0 = w.t * kTile;
    const float* rows = rows_s + st * 192;
    const float next_stat = row_stat(i + 1);     // stored at the step's end
    if (i == 0 && !split) mbar_wait(bar_own, 0);
    mbar_wait(bar0 + 8 * st, (i >> 1) & 1);
    const uint32_t sa = smem_addr(stages + st * kWgStage);
    if (w.score) {
      // k . q_h^T and v . do_h^T
      const uint32_t x[2] = {split ? sa + kWgTile / 2 : smem_addr(own),
                             split ? sa + kWgTile + kWgTile / 2 : smem_addr(own) + kWgTile};
      const uint32_t y[2] = {sa, sa + kWgTile};
      float(*d[2])[16] = {&sc, &dp};
      hold(sc);
      hold(dp);
      fence();
      wg_scores<2>(wg_blocks(split, w.s, nbt), d, x, y, 32 * wg, w.s > 0);
      commit();
      wait_all();
      hold(sc);
      hold(dp);
    }
    if (w.out) {
      // p^T in place of s^T, ds^T * scale in place of dp^T: element e of
      // n8 tile j sits at key kr + 8 (e / 2), query column 32 wg + 8 j +
      // 2 t4 + e % 2 of the tile
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 32 * wg + 8 * j + 2 * t4 + (e & 1);
          const int kp = kr + 8 * (e >> 1), qp = q0 + col;
          const bool live = qp >= kp && kp < T && qp < T;
          const float p = live ? exp2_approx(sc[4 * j + e] * scale2 - rows[col] * kLog2e) *
                                     rows[64 + col]
                               : 0.f;
          sc[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - rows[128 + col]) * a.scale;
        }
      }
      // this warpgroup's k16 slices 2 wg, 2 wg + 1 of p^T and ds^T; the
      // other warpgroup's half of the operand it multiplies (warpgroup 0
      // p^T, 1 ds^T) comes through shared memory. Selects, not branches,
      // pick each warpgroup's values: no branch that splits the two
      // warpgroups writes a register a wgmma reads.
      uint32_t ap[2][4], ad[2][4], got[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wg_pack(ap[kk], sc, kk);
        wg_pack(ad[kk], dp, kk);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          xf[(wg * 8 + kk * 4 + r) * 128 + wt] = w0 ? ad[kk][r] : ap[kk][r];
      }
      bar_sync(1, kBwdThreads);                  // both halves are in shared memory
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) got[kk][r] = xf[((1 - wg) * 8 + kk * 4 + r) * 128 + wt];
      // warpgroup 0: dv += p^T . do; 1: dk += ds^T . q; the chunk's first
      // tile starts the sums
      const uint32_t y = sa + (w0 ? kWgTile : 0);
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t mine = w0 ? ap[kk & 1][r] : ad[kk & 1][r];
          af[kk][r] = (kk >> 1) == wg ? mine : got[kk & 1][r];
        }
      hold(acc);
      fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n256_tb(acc, af[kk], desc_n(y, 16 * kk), kk > 0 || w.t > kt);
      commit();
      wait_all();
      hold(acc);
    }
    // step i + 1's statistics (its buffer was last read in step i - 1)
    st_shared_if(rows_s + 192 * (st ^ 1) + (stat_on ? tid : 0), next_stat, stat_on);
    __syncthreads();                             // this stage and the halves are free
    if (i + 2 < nsteps) issue(i + 2, st);
    if (w.out && w.t == n_qt - 1) {              // chunk c is complete
      // dv (warpgroup 0) and dk (1) staged in own's area (k, v are read no
      // more past dh 256 or after the last step), then copied out
      wg_stage(own + wg * kWgTile, acc, warp, g, t4, true);
      __syncthreads();
      wg_copy_out<kBwdThreads>(static_cast<bf16*>(a.dv) + base, own, k0, 256 * w.c, T, dh, tma,
                               tid);
      wg_copy_out<kBwdThreads>(static_cast<bf16*>(a.dk) + base, own + kWgTile, k0, 256 * w.c, T,
                               dh, tma, tid);
      __syncthreads();
    }
  }
}

// K1's score chain of one step, unrolled: s (+)= q . k^T over NB blocks
// (4 NB k16 steps, m64n64k16: all 64 keys of the tile); sd 0 for a step
// that starts the sums
template <int NB>
__device__ __forceinline__ void wg_qk_chain(float (&s)[32], uint32_t x, uint32_t y, int sd) {
  using namespace sdml_wg;
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) wgmma_ss_n64(s, desc_k(x, kk), desc_k(y, kk), sd || kk > 0);
}

// nb blocks: 3 or 4 up to dh 256 (q, k whole), 1 or 2 past it (slices)
template <bool SPLIT>
__device__ __forceinline__ void wg_qk(int nb, float (&s)[32], uint32_t x, uint32_t y, int sd) {
  if (SPLIT) {
    if (nb == 1) wg_qk_chain<1>(s, x, y, sd); else wg_qk_chain<2>(s, x, y, sd);
  } else {
    if (nb == 3) wg_qk_chain<3>(s, x, y, sd); else wg_qk_chain<4>(s, x, y, sd);
  }
}

// Step i of a wide K1 block: up to dh 256 k tile i, whole (no division on
// the way); past 256 the backward kernels' walk
template <bool SPLIT>
__device__ __forceinline__ WStep fwd_step(int i, int per, int ns, int ntiles) {
  if (!SPLIT) return WStep{0, i, 0, true, true};
  return wide_step(i, per, ns, ntiles, 0);
}

// max and sum over 8 values as a tree (4 deep rather than a chain of 8)
__device__ __forceinline__ float max8(const float (&x)[8]) {
  return fmaxf(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])),
               fmaxf(fmaxf(x[4], x[5]), fmaxf(x[6], x[7])));
}
__device__ __forceinline__ float sum8(const float (&x)[8]) {
  return ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
}

// The first row of the second 64-row half of a K1 block at q0: q0 + 64, or
// q0 again when that half lies wholly past T (its results are not stored,
// and every TMA box then starts inside the tensor)
__device__ __forceinline__ int second_half(int q0, int T) {
  return q0 + kTile < T ? q0 + kTile : q0;
}

// K1, wide, bf16: one block per (b*h, 128 q rows); warpgroup h owns rows
// [64 h, 64 h + 64) and takes all 64 keys of every k tile. Per tile: s =
// q_h . k^T (m64n64k16), the online softmax on the accumulators, o_h +=
// round(p) . v (m64n256k16, p the A operand from registers, v N-major).
// Up to dh 256 q stays in shared memory, a step is one k tile (k and v on
// a barrier each), and the warpgroups take turns to issue their products
// (named barriers 1 and 2: 0's s, 1's s, 0's p . v, 1's p . v, ...), so
// that one's softmax runs under the other's products; every warp arrives
// on a stage's empty barrier when its product has read it, and warpgroup
// 0's thread 0 refills it by TMA. Past 256 (SPLIT), per 256-column chunk of
// o, a tile takes ns score steps (128-column slices of q and k) and one
// step for v's chunk, in lockstep: the block refills a stage after a
// __syncthreads at the step's end (a refill inside the score or output
// branch, or the turns, made ptxas serialize that instantiation's wgmmas).
// Without TMA (Args::vec 0) every refill is the block's plain copies, after
// a __syncthreads.
template <bool SPLIT>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_fwd_kernel_wide_wgmma(Args a, const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv) {
  using namespace sdml_wg;
  using bf16 = __nv_bfloat16;
  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;    // the longest rows start first
  const int T = a.T, dh = a.dh;
  const bool tma = a.vec != 0;
  const int tid = threadIdx.x, wt = tid & 127;
  // up to dh 256 wg and warp are lane 0's, broadcast: uniform across the
  // warp to the compiler, so the descriptors built from them stay in
  // uniform registers (past 256 the broadcast costs a spill)
  const int wg = SPLIT ? tid >> 7 : __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = SPLIT ? wt >> 5 : __shfl_sync(0xffffffffu, wt >> 5, 0);
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  bf16* o = static_cast<bf16*>(a.o) + base;

  extern __shared__ uint4 smem_mma[];
  uint8_t* own = align1024(smem_mma);            // q: half h at 32 KB h; then o
  uint8_t* stages = own + kWgStage;
  // mbarriers: full (count 1) and empty (the arriving warps) per stage and
  // unit, unit 0 the scores' tiles (past 256 all of a step's), 1 v's; then
  // own's
  const uint32_t bar0 = smem_addr(stages + 2 * kWgStage);
  auto full = [&](int st, int u) { return bar0 + 8 * (2 * st + u); };
  auto empty = [&](int st, int u) { return bar0 + 32 + 8 * (2 * st + u); };
  const uint32_t bar_own = bar0 + 64;

  const int q0 = qb * kFwdRows, q1 = second_half(q0, T);
  const int last = min((T + kTile - 1) / kTile - 1, 2 * qb + 1);
  const int nbt = (dh + 63) >> 6;
  const int ns = SPLIT ? (dh + 127) >> 7 : 1;
  const int per = SPLIT ? ns + 1 : 1;
  const int nch = SPLIT ? (dh + 255) >> 8 : 1;
  const int ntiles = last + 1;
  const int nsteps = nch * ntiles * per;

  if (tid == 0) {
    for (int j = 0; j < 4; ++j) {
      mbar_init(bar0 + 8 * j, 1);
      mbar_init(bar0 + 32 + 8 * j, 8);
    }
    mbar_init(bar_own, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // step j's tiles of unit u: up to dh 256 k tile t whole (u 0, at 0) or
  // v's (u 1, at 32 KB); past 256 a score step's 128-column slice s of both
  // halves' q (at 0 and 16 KB) and of k (at 32 KB), an output step v's
  // chunk c (at 0)
  auto loads = [&](WgLoad (&ld)[4], int j, int u) {
    const WStep w = fwd_step<SPLIT>(j, per, ns, ntiles);
    const int r0 = w.t * kTile;
    if (!SPLIT) {
      ld[0] = u == 0 ? WgLoad{&tk, k, 0, 0, nbt, r0} : WgLoad{&tv, v, kWgTile, 0, nbt, r0};
      return 1;
    }
    if (w.score) {
      const int b0 = 2 * w.s, nb = min(2, nbt - b0);
      ld[0] = WgLoad{&tq, q, 0, b0, nb, q0};
      ld[1] = WgLoad{&tq, q, kWgTile / 2, b0, nb, q1};
      ld[2] = WgLoad{&tk, k, kWgTile, b0, nb, r0};
      return 3;
    }
    const int b0 = 4 * w.c;
    ld[0] = WgLoad{&tv, v, 0, b0, min(4, nbt - b0), r0};
    return 1;
  };
  // step j's TMA loads of unit u into stage j % 2, by one thread: a branch
  // around the issue, which holds no register a wgmma reads (an issue
  // predicated in every thread compiles to a loop over the lanes)
  auto tma_step = [&](int j, int u) {
    WgLoad ld[4];
    const int n = loads(ld, j, u);
    wg_tma(ld, n, stages + (j & 1) * kWgStage, bh, full(j & 1, u), true);
  };
  // this warpgroup's product on unit u of step i has completed. With TMA
  // up to dh 256, every warp arrives on the stage's empty barrier, and
  // warpgroup 0's thread 0 refills, where warpgroup 0 (ahead of 1) has time
  // to spare and 1 is done: after s of step i v's tile i + 1 (its stage's
  // v was step i - 1's), after p . v of step i k's tile i + 2. Otherwise
  // the block loads step i + 2's tiles together after a __syncthreads.
  auto release = [&](int i, int u) {
    const int st = i & 1, j = i + 2;
    if (tma && !SPLIT) {
      mbar_arrive(empty(st, u), lane == 0);
      const int jj = u == 0 ? i + 1 : i + 2, uu = 1 - u;
      if (tid == 0 && jj >= 2 && jj < nsteps) {
        mbar_wait(empty(jj & 1, uu), ((jj - 2) >> 1) & 1);
        tma_step(jj, uu);
      }
    } else {
      __syncthreads();
      if (j < nsteps) {
        WgLoad ld[4];
        const int n = loads(ld, j, u);
        wg_fill(ld, n, stages + st * kWgStage, bh, T, dh, tma, full(st, u));
      }
    }
  };
  const WgLoad own_ld[4] = {WgLoad{&tq, q, 0, 0, nbt, q0}, WgLoad{&tq, q, kWgTile, 0, nbt, q1},
                            WgLoad{}, WgLoad{}};
  if (tma && tid == 0) {
    if (!SPLIT) wg_tma(own_ld, 2, own, bh, bar_own, true);
    for (int j = 0; j < 2 && j < nsteps; ++j)
      for (int u = 0; u < (SPLIT ? 1 : 2); ++u) tma_step(j, u);
  } else if (!tma) {
    if (!SPLIT) wg_fill(own_ld, 2, own, bh, T, dh, false, bar_own);
    for (int j = 0; j < 2 && j < nsteps; ++j) {
      for (int u = 0; u < (SPLIT ? 1 : 2); ++u) {
        WgLoad ld[4];
        const int n = loads(ld, j, u);
        wg_fill(ld, n, stages + j * kWgStage, bh, T, dh, false, full(j, u));
      }
    }
  }
  if (!SPLIT) bar_arrive_if(1, kBwdThreads, wg == 1);  // warpgroup 0 issues first

  // this lane's rows r_lo, r_hi: element e of n8 tile j of s sits at row
  // r_lo + 8 (e / 2), key 8 j + 2 t4 + e % 2 of the tile
  const int r_lo = q0 + kTile * wg + 16 * warp + g, r_hi = r_lo + 8;
  const float scale2 = a.scale * kLog2e;         // exp(x) as 2^(x log2 e)
  float acc[128], sc[32];
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    const int st = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    const WStep w = fwd_step<SPLIT>(i, per, ns, ntiles);
    if (i == 0 && !SPLIT) mbar_wait(bar_own, 0);
    const uint32_t sa = smem_addr(stages + st * kWgStage);
    if (w.score) {
      mbar_wait(full(st, 0), ph);
      const uint32_t x = SPLIT ? sa + wg * (kWgTile / 2) : smem_addr(own) + wg * kWgTile;
      if (!SPLIT) bar_sync(1 + wg, kBwdThreads);  // this warpgroup's turn
      hold(sc);
      fence();
      wg_qk<SPLIT>(SPLIT ? min(2, nbt - 2 * w.s) : nbt, sc, x, SPLIT ? sa + kWgTile : sa,
                   w.s > 0);
      commit();
      if (!SPLIT) bar_arrive(2 - wg, kBwdThreads);  // the other's
      wait_all();
      hold(sc);
      if (!SPLIT) release(i, 0);
    }
    if (w.out) {
      // a chunk's first tile starts (m, l) afresh (selects: acc is started
      // by the chunk's first wgmma); keys past the diagonal or T are -inf
      const bool first = w.t == 0;
      m_lo = first ? kNegInf : m_lo;
      m_hi = first ? kNegInf : m_hi;
      l_lo = first ? 0.f : l_lo;
      l_hi = first ? 0.f : l_hi;
      // key 8 j + 2 t4 + e % 2 of the tile is live for a row while it is
      // at most the row's last live key (its own position, or T - 1); a
      // tile wholly below every row of the warpgroup and T needs no mask
      const int kb = w.t * kTile;
      const int lim_lo = min(r_lo, T - 1) - kb - 2 * t4, lim_hi = min(r_hi, T - 1) - kb - 2 * t4;
      if (kb + kTile - 1 > min(q0 + kTile * wg, T - 1)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = 8 * j + (e & 1) <= (e < 2 ? lim_lo : lim_hi) ? sc[4 * j + e] : -INFINITY;
      }
      float mx8_lo[8], mx8_hi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx8_lo[j] = fmaxf(sc[4 * j], sc[4 * j + 1]);
        mx8_hi[j] = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
      }
      float mx_lo = max8(mx8_lo), mx_hi = max8(mx8_hi);
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {      // over the quad holding a row
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
      }
      // m in the scaled scores' units (scale > 0: the max of s, scaled)
      const float mn_lo = fmaxf(m_lo, mx_lo * a.scale), mn_hi = fmaxf(m_hi, mx_hi * a.scale);
      const float c_lo = exp2_approx((m_lo - mn_lo) * kLog2e);
      const float c_hi = exp2_approx((m_hi - mn_hi) * kLog2e);
      const float mb_lo = mn_lo * kLog2e, mb_hi = mn_hi * kLog2e;
      float s8_lo[8], s8_hi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], scale2, e < 2 ? -mb_lo : -mb_hi));
        s8_lo[j] = sc[4 * j] + sc[4 * j + 1];
        s8_hi[j] = sc[4 * j + 2] + sc[4 * j + 3];
      }
      float sum_lo = sum8(s8_lo), sum_hi = sum8(s8_hi);
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, sh);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, sh);
      }
      l_lo = l_lo * c_lo + sum_lo;               // the unrounded f32 p
      l_hi = l_hi * c_hi + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        acc[4 * j] *= c_lo;
        acc[4 * j + 1] *= c_lo;
        acc[4 * j + 2] *= c_hi;
        acc[4 * j + 3] *= c_hi;
      }
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg_pack(af[kk], sc, kk);
      // o_h += round(p) . v over the tile's 64 keys; the chunk's first tile
      // starts the sums
      mbar_wait(full(st, SPLIT ? 0 : 1), ph);
      const uint32_t y = SPLIT ? sa : sa + kWgTile;
      if (!SPLIT) bar_sync(1 + wg, kBwdThreads);
      hold(acc);
      fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n256_tb(acc, af[kk], desc_n(y, 16 * kk), kk > 0 || w.t > 0);
      commit();
      // warpgroup 1's last products are the last turn: nothing waits on it
      if (!SPLIT) bar_arrive_if(2 - wg, kBwdThreads, wg == 0 || i + 1 < nsteps);
      wait_all();
      hold(acc);
      if (!SPLIT) release(i, 1);
    }
    if (SPLIT) release(i, 0);                    // outside the branches above
    if (w.out && w.t == last) {                  // chunk c is complete
      // o_h = acc / max(l, 1e-30), as a product with the reciprocal (an f32
      // ulp from the quotient, below o's bf16 rounding), staged in this
      // half's 32 KB of own's area (q is read no more past dh 256 or after
      // the last step), then copied out by the warpgroup; l and m once,
      // with the first chunk
      const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        acc[4 * j] *= inv_lo;
        acc[4 * j + 1] *= inv_lo;
        acc[4 * j + 2] *= inv_hi;
        acc[4 * j + 3] *= inv_hi;
      }
      uint8_t* half = own + wg * kWgTile;
      wg_stage(half, acc, warp, g, t4, true);
      const bool stat = w.c == 0 && t4 == 0;
      st_global_f32_if(a.l + rbase + min(r_lo, T - 1), l_lo, stat && r_lo < T);
      st_global_f32_if(a.m + rbase + min(r_lo, T - 1), m_lo, stat && r_lo < T);
      st_global_f32_if(a.l + rbase + min(r_hi, T - 1), l_hi, stat && r_hi < T);
      st_global_f32_if(a.m + rbase + min(r_hi, T - 1), m_hi, stat && r_hi < T);
      bar_sync(4 + wg, 128);
      wg_copy_out<128>(o, half, q0 + kTile * wg, 256 * w.c, T, dh, tma, wt);
      bar_sync(4 + wg, 128);
    }
  }
}

// ---- f32: split TF32 on mma.sync ----------------------------------------------------

constexpr int kSl = 64;                          // f32 columns of a streamed slice
constexpr int kLdS = kSl + 4;                    // its row stride
constexpr int kSlot = kTile * kLdS;              // floats of a slice tile
constexpr int kLdR = 256 + 4;                    // row stride of a resident tile
constexpr int kRes = kTile * kLdR;               // floats of a resident tile
// K2: own q, do + 2 stages x (k, v) slices; past dh 256: 64 KB for the
// partial-dq sum + 2 stages x (k, v, q, do) slices
constexpr size_t kTfDqSmem =
    sizeof(float) * (2 * kRes + 4 * kSlot > 16384 + 8 * kSlot ? 2 * kRes + 4 * kSlot
                                                              : 16384 + 8 * kSlot);
// K3: own k, v + 2 stages x (q, do) slices (past 256: 2 x 4 slices), p^T,
// 2 x the q tile's rows
constexpr size_t kTfDkvSmem =
    (2 * static_cast<size_t>(kRes) + 4 * kSlot + 64 * 64 + 2 * 192) * sizeof(float);

// K1: q's 128 rows + 2 stages x a k or v slice and its lo part; past dh
// 256 2 stages x (k, its lo part, q, q) slices
constexpr size_t kTfFwdSmem =
    sizeof(float) * (2 * kRes + 4 * kSlot > 8 * kSlot ? 2 * kRes + 4 * kSlot : 8 * kSlot);

// A [64, kSl] f32 slice at hi (row stride kLdS) split in place into its
// TF32 parts (mma_tf32.cuh's split_tf32): hi's at hi, lo's at lo; by all
// threads, 16-byte rows
__device__ __forceinline__ void split_slice(float* hi, float* lo) {
  for (int c = threadIdx.x; c < kTile * kSl / 4; c += kBwdThreads) {
    const int o = (c >> 4) * kLdS + (c & 15) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + o);
    uint4 h, l;
    sdml_mma::split_tf32(x.x, h.x, l.x);
    sdml_mma::split_tf32(x.y, h.y, l.y);
    sdml_mma::split_tf32(x.z, h.z, l.z);
    sdml_mma::split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

static_assert(kTfDqSmem <= 232448 && kTfDkvSmem <= 232448 && kTfFwdSmem <= 232448 &&
                  kWgSmem <= 232448 && kWgFwdSmem <= 232448,
              "a wide block fits the 227 KB a block may have");

// K2, wide, f32: one block per (b*h, 64 q rows); warp w owns q rows
// 16 (w % 4).. and keys [32 h, 32 h + 32) of every k tile, h = w / 4. Per
// tile: ns score steps (64-column slices of k and v: s += q_s . k_s^T,
// dp += do_s . v_s^T), then the output steps over the slices of k (dq_h
// += ds * scale . k_s, in f32); the two halves' dq add at the end.
__global__ void __launch_bounds__(kBwdThreads, 1) flash_dq_kernel_wide_tf32(Args a) {
  using namespace sdml_mma;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, rw = warp & 3, h = warp >> 2, wt = tid & 127;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;
  float* dq = static_cast<float*>(a.dq) + base;

  extern __shared__ uint4 smem_mma[];
  float* sm = reinterpret_cast<float*>(smem_mma);
  const bool split = dh > 256;
  float* own = sm;                               // q, do (dh <= 256)
  float* ring = split ? sm + 16384 : sm + 2 * kRes;
  const int slots = split ? 4 : 2;

  const int q0 = qt * kTile;
  const int last = min((T + kTile - 1) / kTile - 1, qt);
  const int nsl = (dh + kSl - 1) / kSl;
  const int ns = nsl;                            // score steps per tile
  const int per = ns + (split ? 4 : nsl);        // and output steps
  const int nch = split ? (dh + 255) / 256 : 1;
  const int ntiles = last + 1;
  const int nsteps = nch * ntiles * per;

  // score step s: k, v slices s (and past 256 q, do's); output step: k's
  // slice of chunk c
  auto issue = [&](int i, int stage) {
    const WStep w = wide_step(i, per, ns, ntiles, 0);
    float* dst = ring + stage * slots * kSlot;
    const int k0 = w.t * kTile;
    if (w.score) {
      load_tile_async<kSl, kBwdThreads>(dst, k, k0, T, dh, vec, w.s * kSl);
      load_tile_async<kSl, kBwdThreads>(dst + kSlot, v, k0, T, dh, vec, w.s * kSl);
      if (split) {
        load_tile_async<kSl, kBwdThreads>(dst + 2 * kSlot, q, q0, T, dh, vec, w.s * kSl);
        load_tile_async<kSl, kBwdThreads>(dst + 3 * kSlot, dout, q0, T, dh, vec, w.s * kSl);
      }
    } else {
      load_tile_async<kSl, kBwdThreads>(dst, k, k0, T, dh, vec,
                                        w.c * 256 + (w.s - ns) * kSl);
    }
  };

  if (!split) {
    load_tile_async<256, kBwdThreads>(own, q, q0, T, dh, vec);
    load_tile_async<256, kBwdThreads>(own + kRes, dout, q0, T, dh, vec);
  }
  issue(0, 0);
  cp_async_commit();

  const int r_lo = q0 + 16 * rw + g, r_hi = r_lo + 8;
  const float m_lo = r_lo < T ? a.m[rbase + r_lo] : 0.f;
  const float m_hi = r_hi < T ? a.m[rbase + r_hi] : 0.f;
  const float li_lo = r_lo < T ? a.linv[rbase + r_lo] : 0.f;
  const float li_hi = r_hi < T ? a.linv[rbase + r_hi] : 0.f;
  const float dl_lo = r_lo < T ? a.delta[rbase + r_lo] : 0.f;
  const float dl_hi = r_hi < T ? a.delta[rbase + r_hi] : 0.f;

  float acc[4][8][4], sc[4][4], dp[4][4];
#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    const int stage = i & 1;
    if (i + 1 < nsteps) issue(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const WStep w = wide_step(i, per, ns, ntiles, 0);
    const float* x = ring + stage * slots * kSlot;
    if (w.t == 0 && w.s == 0) {
#pragma unroll
      for (int o = 0; o < 4; ++o) zero_acc(acc[o]);
    }
    if (w.score) {
      if (w.s == 0) {
        zero_acc(sc);
        zero_acc(dp);
      }
      if (split) {
        WarpTf32::xyT<kLdS, kLdS, 4, kSl>(sc, x + 2 * kSlot, 16 * rw, x, 32 * h,
                                          lane);
        WarpTf32::xyT<kLdS, kLdS, 4, kSl>(dp, x + 3 * kSlot, 16 * rw, x + kSlot,
                                          32 * h, lane);
      } else {
        WarpTf32::xyT<kLdR, kLdS, 4, kSl>(sc, own + w.s * kSl, 16 * rw, x, 32 * h,
                                          lane);
        WarpTf32::xyT<kLdR, kLdS, 4, kSl>(dp, own + kRes + w.s * kSl, 16 * rw,
                                          x + kSlot, 32 * h, lane);
      }
      if (w.s == ns - 1) {
        // ds * scale in place of s: element e of n8 tile n sits at row
        // 16 rw + g + 8 (e / 2), key 32 h + 8 n + 2 t4 + e % 2
        const int kb = w.t * kTile + 32 * h;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e >= 2;
            const int qp = hi ? r_hi : r_lo;
            const int kp = kb + 8 * n + 2 * t4 + (e & 1);
            const bool live = qp >= kp && kp < T && qp < T;
            const float p =
                live ? expf(sc[n][e] * a.scale - (hi ? m_hi : m_lo)) * (hi ? li_hi : li_lo)
                     : 0.f;
            sc[n][e] = p * (dp[n][e] - (hi ? dl_hi : dl_lo)) * a.scale;
          }
        }
      }
    } else {
      const int o = w.s - ns;
#pragma unroll
      for (int oo = 0; oo < 4; ++oo)
        if (oo == o) WarpTf32::pY<kLdS, 4, 8>(acc[oo], sc, x, 32 * h, lane);
    }
    __syncthreads();                             // this stage is free for the step after next
    if (w.out && w.s == per - 1 && w.t == last) {  // chunk c is complete
      float* red = sm;                           // q, do are read no more (dh <= 256)
      if (h == 1) {
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) red[((o * 8 + n) * 4 + e) * 128 + wt] = acc[o][n][e];
      }
      __syncthreads();
      if (h == 0) {
#pragma unroll
        for (int o = 0; o < 4; ++o) {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[o][n][e] += red[((o * 8 + n) * 4 + e) * 128 + wt];
            const int col = w.c * 256 + o * kSl + 8 * n + 2 * t4;
            if (col < dh) {
              if (r_lo < T) store_pair(dq + static_cast<long long>(r_lo) * dh + col,
                                       acc[o][n][0], acc[o][n][1], col, dh);
              if (r_hi < T) store_pair(dq + static_cast<long long>(r_hi) * dh + col,
                                       acc[o][n][2], acc[o][n][3], col, dh);
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

// K3, wide, f32: one block per (b*h, 64 k rows), scores transposed; warp w
// owns k rows 16 (w % 4).. Half 0 (warps 0-3): s^T = k . q^T, p^T, dv +=
// p^T . do; half 1 (warps 4-7): dp^T = v . do^T, ds^T (p^T from half 0
// through shared memory), dk += ds^T . q. Per q tile: ns score
// steps over 64-column slices of q and do, then the output steps over the
// slices of do and q.
__global__ void __launch_bounds__(kBwdThreads, 1) flash_dkv_kernel_wide_tf32(Args a) {
  using namespace sdml_mma;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, rw = warp & 3, h = warp >> 2, wt = tid & 127;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;

  extern __shared__ uint4 smem_mma[];
  float* sm = reinterpret_cast<float*>(smem_mma);
  const bool split = dh > 256;
  float* own = sm;                               // k, v (dh <= 256)
  float* ring = split ? sm : sm + 2 * kRes;
  const int slots = split ? 4 : 2;
  float* pt = ring + 2 * slots * kSlot;          // p^T, [32][128]
  float* rows_s = pt + 64 * 64;                  // 2 x (m, linv, delta) [64]

  const int k0 = kt * kTile;
  const int n_qt = (T + kTile - 1) / kTile;
  const int nsl = (dh + kSl - 1) / kSl;
  const int ns = nsl;
  const int per = ns + (split ? 4 : nsl);
  const int nch = split ? (dh + 255) / 256 : 1;
  const int ntiles = n_qt - kt;
  const int nsteps = nch * ntiles * per;

  // score step s: q, do slices s (and past 256 k, v's), with the q tile's
  // rows at the last; output step: q's and do's slice of chunk c
  auto issue = [&](int i, int stage) {
    const WStep w = wide_step(i, per, ns, ntiles, kt);
    float* dst = ring + stage * slots * kSlot;
    const int q0 = w.t * kTile;
    const int c0 = w.score ? w.s * kSl : w.c * 256 + (w.s - ns) * kSl;
    load_tile_async<kSl, kBwdThreads>(dst, q, q0, T, dh, vec, c0);
    load_tile_async<kSl, kBwdThreads>(dst + kSlot, dout, q0, T, dh, vec, c0);
    if (w.score && split) {
      load_tile_async<kSl, kBwdThreads>(dst + 2 * kSlot, k, k0, T, dh, vec, c0);
      load_tile_async<kSl, kBwdThreads>(dst + 3 * kSlot, v, k0, T, dh, vec, c0);
    }
    if (w.s == ns - 1) {
      float* rows = rows_s + 192 * stage;
      load_rows_async<kBwdThreads>(rows, a.m + rbase, q0, T);
      load_rows_async<kBwdThreads>(rows + kTile, a.linv + rbase, q0, T);
      load_rows_async<kBwdThreads>(rows + 2 * kTile, a.delta + rbase, q0, T);
    }
  };

  if (!split) {
    load_tile_async<256, kBwdThreads>(own, k, k0, T, dh, vec);
    load_tile_async<256, kBwdThreads>(own + kRes, v, k0, T, dh, vec);
  }
  issue(0, 0);
  cp_async_commit();

  const int kr = k0 + 16 * rw + g;               // this lane's keys kr, kr + 8
  float acc[4][8][4], sc[8][4];
#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    const int stage = i & 1;
    if (i + 1 < nsteps) issue(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const WStep w = wide_step(i, per, ns, ntiles, kt);
    const float* x = ring + stage * slots * kSlot;
    if (w.t == kt && w.s == 0) {
#pragma unroll
      for (int o = 0; o < 4; ++o) zero_acc(acc[o]);
    }
    if (w.score) {
      if (w.s == 0) zero_acc(sc);
      // half 0: k . q^T; half 1: v . do^T
      if (split) {
        WarpTf32::xyT<kLdS, kLdS, 8, kSl>(sc, x + (2 + h) * kSlot, 16 * rw,
                                          x + h * kSlot, 0, lane);
      } else {
        WarpTf32::xyT<kLdR, kLdS, 8, kSl>(sc, own + h * kRes + w.s * kSl, 16 * rw,
                                          x + h * kSlot, 0, lane);
      }
      if (w.s == ns - 1) {
        // element e of n8 tile n sits at key kr + 8 (e / 2), query column
        // 8 n + 2 t4 + e % 2 of the tile
        const float* rows = rows_s + 192 * stage;
        const int q0 = w.t * kTile;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n + 2 * t4 + (e & 1);
            if (h == 0) {
              const int kp = kr + 8 * (e >> 1), qp = q0 + col;
              const bool live = qp >= kp && kp < T && qp < T;
              const float p = live ? expf(sc[n][e] * a.scale - rows[col]) * rows[64 + col]
                                   : 0.f;
              sc[n][e] = p;
              pt[(4 * n + e) * 128 + wt] = p;
            } else {
              sc[n][e] -= rows[128 + col];
            }
          }
        }
      }
    } else {
      const int o = w.s - ns;
      if (o == 0 && h == 1) {                    // ds^T from half 0's p^T
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] = pt[(4 * n + e) * 128 + wt] * sc[n][e] * a.scale;
      }
      // half 0: dv += p^T . do_s; half 1: dk += ds^T . q_s
      const float* y = x + (h == 0 ? kSlot : 0);
#pragma unroll
      for (int oo = 0; oo < 4; ++oo)
        if (oo == o) WarpTf32::pY<kLdS, 8, 8>(acc[oo], sc, y, 0, lane);
    }
    __syncthreads();                             // this stage and p^T are free
    if (w.out && w.s == per - 1 && w.t == n_qt - 1) {  // chunk c is complete
      float* out = static_cast<float*>(h == 0 ? a.dv : a.dk) + base;
      const int r_lo = kr, r_hi = kr + 8;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = w.c * 256 + o * kSl + 8 * n + 2 * t4;
          if (col >= dh) continue;
          if (r_lo < T) store_pair(out + static_cast<long long>(r_lo) * dh + col,
                                   acc[o][n][0], acc[o][n][1], col, dh);
          if (r_hi < T) store_pair(out + static_cast<long long>(r_hi) * dh + col,
                                   acc[o][n][2], acc[o][n][3], col, dh);
        }
      }
    }
  }
}

// K1, wide, f32: one block per (b*h, 128 q rows); warp w owns q rows
// 16 w..16 w + 15 and takes all 64 keys of every k tile. Per tile: ns score
// steps over 64-column slices of k (and past dh 256 of q: s += q_s . k_s^T),
// the online softmax at the last of them, then the output steps over the
// 64-column slices of v's chunk (o_s += p . v_s, in f32). Each k or v slice
// is split into its TF32 parts once, when it lands (split_slice), rather than
// by each of the 8 warps that read it. A warp whose rows all lie before a k
// tile skips its products there. SPLIT: dh > 256.
template <bool SPLIT>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_fwd_kernel_wide_tf32(Args a) {
  using namespace sdml_mma;
  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;    // the longest rows start first
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  float* o = static_cast<float*>(a.o) + base;

  extern __shared__ uint4 smem_mma[];
  float* sm = reinterpret_cast<float*>(smem_mma);
  float* own = sm;                               // q's 128 rows (dh <= 256)
  float* ring = SPLIT ? sm : sm + 2 * kRes;
  const int slots = SPLIT ? 4 : 2;              // k or v, its lo part (, q, q)

  const int q0 = qb * kFwdRows;
  const int last = min((T + kTile - 1) / kTile - 1, 2 * qb + 1);
  const int ns = (dh + kSl - 1) / kSl;           // score steps per tile
  const int per = ns + (SPLIT ? 4 : ns);         // and output steps
  const int nch = SPLIT ? (dh + 255) / 256 : 1;
  const int ntiles = last + 1;
  const int nsteps = nch * ntiles * per;

  // score step s: k's slice s (and past 256 q's, both halves); output
  // step: v's slice of chunk c
  auto issue = [&](int i, int stage) {
    const WStep w = wide_step(i, per, ns, ntiles, 0);
    float* dst = ring + stage * slots * kSlot;
    const int k0 = w.t * kTile;
    if (w.score) {
      load_tile_async<kSl, kBwdThreads>(dst, k, k0, T, dh, vec, w.s * kSl);
      if (SPLIT) {
        load_tile_async<kSl, kBwdThreads>(dst + 2 * kSlot, q, q0, T, dh, vec, w.s * kSl);
        load_tile_async<kSl, kBwdThreads>(dst + 3 * kSlot, q, q0 + kTile, T, dh, vec,
                                          w.s * kSl);
      }
    } else {
      load_tile_async<kSl, kBwdThreads>(dst, v, k0, T, dh, vec,
                                        w.c * 256 + (w.s - ns) * kSl);
    }
  };

  if (!SPLIT) {
    load_tile_async<256, kBwdThreads>(own, q, q0, T, dh, vec);
    load_tile_async<256, kBwdThreads>(own + kRes, q, q0 + kTile, T, dh, vec);
  }
  issue(0, 0);
  cp_async_commit();

  const int wr = 16 * warp;
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  // the last key any live row of this warp sees (-1: no live row)
  const int kmax = q0 + wr < T ? min(q0 + wr + 15, T - 1) : -1;
  float acc[4][8][4], sc[8][4];
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    const int stage = i & 1;
    if (i + 1 < nsteps) issue(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const WStep w = wide_step(i, per, ns, ntiles, 0);
    float* x = ring + stage * slots * kSlot;
    split_slice(x, x + kSlot);
    __syncthreads();
    if (w.t == 0 && w.s == 0) {                  // a new chunk
#pragma unroll
      for (int oo = 0; oo < 4; ++oo) zero_acc(acc[oo]);
      m_lo = m_hi = kNegInf;
      l_lo = l_hi = 0.f;
    }
    const bool live_w = w.t * kTile <= kmax;     // a row of this warp sees a key of tile t
    if (w.score && live_w) {
      if (w.s == 0) zero_acc(sc);
      if (SPLIT) {
        WarpTf32::xyT<kLdS, kLdS, 8, kSl, true>(sc, x + 2 * kSlot, wr, x, 0, lane, x + kSlot);
      } else {
        WarpTf32::xyT<kLdR, kLdS, 8, kSl, true, 1>(sc, own + w.s * kSl, wr, x, 0, lane,
                                                   x + kSlot);
      }
      if (w.s == ns - 1) {
        // element e of n8 tile n sits at row r_lo + 8 (e / 2), key
        // kb + 8 n + 2 t4 + e % 2; keys past the diagonal or T are -inf
        const int kb = w.t * kTile;
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kb + 8 * n + 2 * t4 + (e & 1);
            const bool live = (e < 2 ? r_lo : r_hi) >= kp && kp < T;
            sc[n][e] = live ? sc[n][e] * a.scale : -INFINITY;
          }
          mx_lo = fmaxf(mx_lo, fmaxf(sc[n][0], sc[n][1]));
          mx_hi = fmaxf(mx_hi, fmaxf(sc[n][2], sc[n][3]));
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {    // over the quad holding a row
          mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
          mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
        }
        const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
        const float c_lo = expf(m_lo - mn_lo), c_hi = expf(m_hi - mn_hi);
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(sc[n][e] - (e < 2 ? mn_lo : mn_hi));
            sc[n][e] = p;
            if (e < 2) sum_lo += p; else sum_hi += p;
          }
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, sh);
          sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, sh);
        }
        l_lo = l_lo * c_lo + sum_lo;
        l_hi = l_hi * c_hi + sum_hi;
        m_lo = mn_lo;
        m_hi = mn_hi;
#pragma unroll
        for (int oo = 0; oo < 4; ++oo) {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            acc[oo][n][0] *= c_lo;
            acc[oo][n][1] *= c_lo;
            acc[oo][n][2] *= c_hi;
            acc[oo][n][3] *= c_hi;
          }
        }
      }
    } else if (w.out && live_w) {
      const int o_s = w.s - ns;
#pragma unroll
      for (int oo = 0; oo < 4; ++oo)
        if (oo == o_s) WarpTf32::pY<kLdS, 8, 8, true>(acc[oo], sc, x, 0, lane, x + kSlot);
    }
    __syncthreads();                             // this stage is free for the step after next
    if (w.out && w.s == per - 1 && w.t == last) {  // chunk c is complete
      const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
      for (int oo = 0; oo < 4; ++oo) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = w.c * 256 + oo * kSl + 8 * n + 2 * t4;
          if (col < dh) {
            if (r_lo < T) store_pair(o + static_cast<long long>(r_lo) * dh + col,
                                     acc[oo][n][0] / den_lo, acc[oo][n][1] / den_lo, col, dh);
            if (r_hi < T) store_pair(o + static_cast<long long>(r_hi) * dh + col,
                                     acc[oo][n][2] / den_hi, acc[oo][n][3] / den_hi, col, dh);
          }
        }
      }
      if (w.c == 0 && t4 == 0) {                 // the quad's lanes agree
        if (r_lo < T) {
          a.l[rbase + r_lo] = l_lo;
          a.m[rbase + r_lo] = m_lo;
        }
        if (r_hi < T) {
          a.l[rbase + r_hi] = l_hi;
          a.m[rbase + r_hi] = m_hi;
        }
      }
    }
  }
}

// ---- launch --------------------------------------------------------------------

enum Pass { kForward = 0, kDq = 1, kDkv = 2 };

// a grid of (BH, ceil(T / rows)): a block per b*h and `rows` rows
cudaError_t launch_kernel(void (*kernel)(Args), const Args& a, int BH, int threads,
                          size_t smem, cudaStream_t stream, int rows = kTile) {
  const dim3 grid(BH, (a.T + rows - 1) / rows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_tf32(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  constexpr size_t tile = static_cast<size_t>(Tf32Shape<DP>::TILE) * sizeof(float);
  switch (pass) {
    case kForward:                               // q + 2 stages of k, v
      return launch_kernel(flash_fwd_kernel_tf32<DP>, a, BH, kTf32Threads, 5 * tile,
                           stream);
    case kDq:                                    // q, do + 2 stages of k, v
      return launch_kernel(flash_dq_kernel_tf32<DP>, a, BH, kTf32Threads, 6 * tile, stream);
    default:                                     // k, v + 2 stages of q, do, rows
      return launch_kernel(flash_dkv_kernel_tf32<DP>, a, BH, kTf32Threads,
                           6 * tile + 2 * 3 * kTile * sizeof(float), stream);
  }
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (the library links nothing past the runtime)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// the TMA map of a contiguous [BH, T, dh] bf16 tensor: [64, 64] boxes in the
// 128-byte swizzle, zeros past T and dh
bool tensor_map(CUtensorMap* map, const void* x, int BH, int T, int dh) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(T) * dh * 2};
  const cuuint32_t box[3] = {64, 64, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K1, K2 or K3 past dh 128 in bf16: TMA maps of q, k, v (and do) when the
// rows take 16-byte boxes (vec), else the kernel's plain copies
cudaError_t launch_wide_wgmma(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  CUtensorMap maps[4] = {};
  const int n_maps = pass == kForward ? 3 : 4;
  if (a.vec) {
    const void* xs[4] = {a.q, a.k, a.v, a.dout};
    for (int j = 0; j < n_maps; ++j)
      if (!tensor_map(&maps[j], xs[j], BH, a.T, a.dh)) return cudaErrorNotSupported;
  }
  cudaError_t err;
  if (pass == kForward) {
    auto fwd = a.dh > 256 ? flash_fwd_kernel_wide_wgmma<true> : flash_fwd_kernel_wide_wgmma<false>;
    err = cudaFuncSetAttribute(fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kWgFwdSmem));
    if (err != cudaSuccess) return err;
    const dim3 grid(BH, (a.T + kFwdRows - 1) / kFwdRows);
    fwd<<<grid, kBwdThreads, kWgFwdSmem, stream>>>(a, maps[0], maps[1], maps[2]);
    return cudaGetLastError();
  }
  auto kernel = pass == kDq ? flash_dq_kernel_wide_wgmma : flash_dkv_kernel_wide_wgmma;
  const dim3 grid(BH, (a.T + kTile - 1) / kTile);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kWgSmem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBwdThreads, kWgSmem, stream>>>(a, maps[0], maps[1], maps[2], maps[3]);
  return cudaGetLastError();
}

// past dh 128 the wide kernels: wgmma in bf16, split TF32 in f32
template <typename E>
cudaError_t launch_wide(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  if (sizeof(E) == 2) return launch_wide_wgmma(pass, a, BH, stream);
  switch (pass) {
    case kForward:
      return launch_kernel(a.dh > 256 ? flash_fwd_kernel_wide_tf32<true>
                                      : flash_fwd_kernel_wide_tf32<false>,
                           a, BH, kBwdThreads, kTfFwdSmem, stream, kFwdRows);
    case kDq:
      return launch_kernel(flash_dq_kernel_wide_tf32, a, BH, kBwdThreads, kTfDqSmem, stream);
    default:
      return launch_kernel(flash_dkv_kernel_wide_tf32, a, BH, kBwdThreads, kTfDkvSmem, stream);
  }
}

// f32: K1-K3 in split TF32 on the tensor cores, head dim padded to 16, 32,
// 64 or 128; above 128 the wide kernels
cudaError_t launch_f32(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  if (a.dh <= 16) return launch_tf32<16>(pass, a, BH, stream);
  if (a.dh <= 32) return launch_tf32<32>(pass, a, BH, stream);
  if (a.dh <= 64) return launch_tf32<64>(pass, a, BH, stream);
  if (a.dh <= 128) return launch_tf32<128>(pass, a, BH, stream);
  return launch_wide<float>(pass, a, BH, stream);
}

template <int DP>
cudaError_t launch_mma(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  constexpr size_t tile = static_cast<size_t>(MmaShape<DP>::TILE) * sizeof(__nv_bfloat16);
  switch (pass) {
    case kForward:                               // q + 2 stages of k, v
      return launch_kernel(flash_fwd_kernel_bf16_mma<DP>, a, BH, kMmaThreads, 5 * tile,
                           stream);
    case kDq:                                    // q, do + 2 stages of k, v
      return launch_kernel(flash_dq_kernel_bf16_mma<DP>, a, BH, kMmaThreads, 6 * tile,
                           stream);
    default:                                     // k, v + 2 stages of q, do, rows
      return launch_kernel(flash_dkv_kernel_bf16_mma<DP>, a, BH, kMmaThreads,
                           6 * tile + 2 * 3 * kTile * sizeof(float), stream);
  }
}

// the tensor-core K1-K3, head dim padded to 16, 32, 64 or 128; above 128
// the wide kernels
cudaError_t launch_bf16(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  if (a.dh <= 16) return launch_mma<16>(pass, a, BH, stream);
  if (a.dh <= 32) return launch_mma<32>(pass, a, BH, stream);
  if (a.dh <= 64) return launch_mma<64>(pass, a, BH, stream);
  if (a.dh <= 128) return launch_mma<128>(pass, a, BH, stream);
  return launch_wide<__nv_bfloat16>(pass, a, BH, stream);
}

// any head dim >= 1; T up to 65535 tiles (the grid's y axis)
int launch(Pass pass, Args a, int BH, int dtype, void* stream) {
  if (BH < 1 || BH > 2147483647 || a.T < 1 || a.T > 65535 * kTile || a.dh < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) |
                         reinterpret_cast<uintptr_t>(a.dout);
  // 16-byte chunks: 4 f32 or 8 bf16
  a.vec = a.dh % (dtype == 0 ? 4 : 8) == 0 && (ptrs & 15u) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_f32(pass, a, BH, st); break;
    case 1: err = launch_bf16(pass, a, BH, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// All tensors contiguous on the device: q, k, v, dout, o, dq, dk, dv
// [BH, T, dh] in the dtype (0 f32, 1 bf16); l, m, linv, delta [BH, T] f32.
// Each returns the launch's cudaError_t.
int sdml_flash_forward(const void* q, const void* k, const void* v, void* o, float* l,
                       float* m, int BH, int T, int dh, float scale, int dtype,
                       void* stream) {
  Args a{q, k, v, nullptr, o, l, m, nullptr, nullptr, nullptr, nullptr, nullptr,
         T, dh, scale};
  return launch(kForward, a, BH, dtype, stream);
}

int sdml_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                  const float* m, const float* linv, const float* delta, void* dq,
                  int BH, int T, int dh, float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, nullptr, nullptr, const_cast<float*>(m), linv, delta, dq,
         nullptr, nullptr, T, dh, scale};
  return launch(kDq, a, BH, dtype, stream);
}

int sdml_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const float* m, const float* linv, const float* delta, void* dk,
                   void* dv, int BH, int T, int dh, float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, nullptr, nullptr, const_cast<float*>(m), linv, delta, nullptr,
         dk, dv, T, dh, scale};
  return launch(kDkv, a, BH, dtype, stream);
}

const char* sdml_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
