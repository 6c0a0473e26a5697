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
// the contraction over dh streamed in 256-byte slices, the outputs made in
// column chunks, so that every head dim >= 1 fits a block.
// The next steps are wgmma and TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

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
// (one chunk of row pad: MmaShape / Tf32Shape / WideShape's LD), by a block
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

// ---- K1-K3 at head dims above 128, both dtypes: the wide kernels ------------------
//
// Past dh 128 the tilings above do not fit: their tiles hold whole rows of
// dh in shared memory (f32 K1-K3 at dh 256: 338-408 KB a block, past the
// 227 KB a block may have) and their accumulators whole rows of the output
// in registers (a warp's 16 rows of a 256-wide f32 accumulator are 128
// registers a thread; K3 holds two). The wide kernels bound both for every
// head dim:
// - the contraction over dh (s = q.k^T, dp = do.v^T) is streamed in slices
//   of DS columns, 256 bytes a row (128 bf16, 64 f32): a slice of each
//   operand is a [64, DS + pad] tile of 17 KB, and the score accumulators
//   of a warp are its 16 rows x 64 keys (or queries), whatever dh;
// - the outputs are produced in column chunks of DC (K1 o and K2 dq: 128;
//   K3 dk and dv: 64 each, so its two accumulators stay 64 registers), one
//   chunk after the other by a loop inside the block: for each chunk the
//   block walks its k (K3: q) tiles again and recomputes the scores over
//   the whole contraction. So the grid stays (b*h, 64-row tile), the other
//   side's tiles and the chunks are loops, and the products of the scores
//   are done once per chunk (at dh 256: K1 and K2 twice, K3 four times;
//   the price of any head dim in a bounded block).
// Every step of the walk copies at most two 17 KB tiles through a 2-stage
// cp.async ring (69.6 KB a block, 71.1 KB for K3 with its row statistics):
// a q and a k slice (s), a do and a v slice (dp), then the chunk's v (K1),
// k (K2) or do and q (K3) columns for the product that uses p or ds. Four
// warps each own 16 rows; p and ds stay in registers (the A operands of
// the next product, as above), through the same fragment code as the
// narrow kernels (WarpMma: mma.sync m16n8k16 bf16, or split TF32 m16n8k8
// f32). Each k tile runs as one 64-key block: the online softmax of K1
// takes the tile's max over all 64 keys at once (the narrow kernels: 16 or
// 32), and the diagonal tile computes its masked keys rather than skip
// them. m and l are K1's at dh <= 128 in every way but the order of the
// f32 sums; chunk 0 writes them.

constexpr int kWideWarps = 4;
constexpr int kWideThreads = 32 * kWideWarps;

// Shapes of the wide kernels for element type E (bf16 or f32)
template <typename E>
struct WideShape {
  static constexpr int PAD = 16 / sizeof(E);     // one 16-byte chunk of row pad
  static constexpr int DS = 256 / sizeof(E);     // contraction columns per slice
  static constexpr int LDS = DS + PAD;
  static constexpr int SLOT = kTile * LDS;       // elements of one slice tile
  static constexpr int DC = 128;                 // K1 o / K2 dq columns per chunk
  static constexpr int LDC = DC + PAD;
  static constexpr int DC3 = 64;                 // K3 dk, dv columns per chunk
  static constexpr int LDC3 = DC3 + PAD;
  static constexpr size_t STAGES = 4 * static_cast<size_t>(SLOT) * sizeof(E);
};

static_assert(kTile * WideShape<float>::LDC <= 2 * WideShape<float>::SLOT &&
                  kTile * WideShape<__nv_bfloat16>::LDC <= 2 * WideShape<__nv_bfloat16>::SLOT,
              "a K1 / K2 chunk tile fits one stage of two slots");
static_assert(WideShape<float>::LDC3 <= WideShape<float>::LDS &&
                  WideShape<__nv_bfloat16>::LDC3 <= WideShape<__nv_bfloat16>::LDS,
              "a K3 chunk tile fits one slot");

// A warp's products on the tensor cores, for the wide kernels:
//   xyT: s[n] += X[xr0 + 0..15, 0..KW) . Y[yr0 + 8 n + 0..7, 0..KW)^T;
//   pY:  acc[d] += round_E(P) . Y[yr0 + 0..8 NN, 8 d + 0..7], P the warp's NN
//        m16n8 accumulators (16 rows x 8 NN columns) as the A operand.
template <typename E>
struct WarpMma;

template <>
struct WarpMma<__nv_bfloat16> {
  using E = __nv_bfloat16;
  template <int LDX, int LDY, int NN, int KW>
  static __device__ __forceinline__ void xyT(float (&s)[NN][4], const E* x, int xr0,
                                             const E* y, int yr0, int lane) {
    using namespace sdml_mma;
#pragma unroll
    for (int ks = 0; ks < KW / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, x + a_off<LDX>(xr0, ks, lane));
#pragma unroll
      for (int n2 = 0; n2 < NN / 2; ++n2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, y + b_off<LDY>(yr0 + 16 * n2, ks, lane));
        mma_bf16_16816(s[2 * n2], af, bf[0], bf[1]);
        mma_bf16_16816(s[2 * n2 + 1], af, bf[2], bf[3]);
      }
    }
  }
  template <int LDY, int NN, int ND>
  static __device__ __forceinline__ void pY(float (&acc)[ND][4], const float (&p)[NN][4],
                                            const E* y, int yr0, int lane) {
    using namespace sdml_mma;
#pragma unroll
    for (int kk = 0; kk < NN / 2; ++kk) {
      uint32_t af[4];
      pack_a<NN>(af, p, kk);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, y + bt_off<LDY>(yr0 + 16 * kk, 16 * d2, lane));
        mma_bf16_16816(acc[2 * d2], af, f[0], f[1]);
        mma_bf16_16816(acc[2 * d2 + 1], af, f[2], f[3]);
      }
    }
  }
};

template <>
struct WarpMma<float> {
  // A slice's products sum in fresh accumulators (half the n8 tiles at a
  // time), added to s in f32 once per slice: the tensor cores round their
  // f32 sums toward zero, so one accumulator carried through a 512-wide
  // contraction (192 products a value) drifts past the 1e-5 of l and m,
  // where a slice's chain (24) stays as short as the dh 64 kernels'.
  template <int LDX, int LDY, int NN, int KW>
  static __device__ __forceinline__ void xyT(float (&s)[NN][4], const float* x, int xr0,
                                             const float* y, int yr0, int lane) {
    using namespace sdml_mma;
    constexpr int NH = NN / 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
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
          lds_b_split<LDY>(bf, y, yr0 + 8 * (h * NH + n), ks, lane);
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
  template <int LDY, int NN, int ND>
  static __device__ __forceinline__ void pY(float (&acc)[ND][4], const float (&p)[NN][4],
                                            const float* y, int yr0, int lane) {
    using namespace sdml_mma;
#pragma unroll
    for (int kk = 0; kk < NN; ++kk) {
      SplitA pa;
      acc_a_split(pa, p[kk]);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        SplitB f;
        lds_bt_split<LDY>(f, y, yr0 + 8 * kk, 8 * d, lane);
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

// A wide kernel walks (chunk c, other-side tile t in [t0, t1], step s in
// [0, last_s]) in that nesting; (c, t, s) becomes the step after it
__device__ __forceinline__ void next_step(int& c, int& t, int& s, int last_s, int t0, int t1) {
  if (++s > last_s) {
    s = 0;
    if (++t > t1) {
      t = t0;
      ++c;
    }
  }
}

// K1, wide: one block per (b*h, 64 q rows), warp w owning q rows
// 16w..16w+15. Per chunk c and k tile kt: ns steps of s += q_s.k_s^T, then
// the step that takes the online softmax over the tile's 64 keys and
// adds round_E(p) . v[:, chunk c].
template <typename E>
__global__ void __launch_bounds__(kWideThreads) flash_fwd_kernel_wide(Args a) {
  using S = WideShape<E>;
  using M = WarpMma<E>;
  using namespace sdml_mma;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;    // the longest rows start first
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const E* q = static_cast<const E*>(a.q) + base;
  const E* k = static_cast<const E*>(a.k) + base;
  const E* v = static_cast<const E*>(a.v) + base;
  E* o = static_cast<E*>(a.o) + base;

  extern __shared__ uint4 smem_mma[];
  E* ring = reinterpret_cast<E*>(smem_mma);      // 2 stages of 2 slots

  const int q0 = qt * kTile;
  const int last = min((T + kTile - 1) / kTile - 1, qt);
  const int ns = (dh + S::DS - 1) / S::DS;
  const int nch = (dh + S::DC - 1) / S::DC;
  const int wr = warp * 16;
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  const bool live_w = q0 + wr < T;               // this warp has a row below T

  // step s < ns: the q and k slices s of k tile kt; s == ns: v's chunk c
  auto issue = [&](int c, int kt, int s, int stage) {
    E* dst = ring + stage * 2 * S::SLOT;
    if (s < ns) {
      load_tile_async<S::DS, kWideThreads>(dst, q, q0, T, dh, vec, s * S::DS);
      load_tile_async<S::DS, kWideThreads>(dst + S::SLOT, k, kt * kTile, T, dh, vec,
                                           s * S::DS);
    } else {
      load_tile_async<S::DC, kWideThreads>(dst, v, kt * kTile, T, dh, vec, c * S::DC);
    }
  };

  float acc[S::DC / 8][4], sc[8][4];
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  int c = 0, kt = 0, s = 0, stage = 0;
  issue(0, 0, 0, 0);
  cp_async_commit();
#pragma unroll 1
  for (;;) {
    int nc = c, nkt = kt, nss = s;
    next_step(nc, nkt, nss, ns, 0, last);
    const bool more = nc < nch;
    if (more) issue(nc, nkt, nss, stage ^ 1);    // the next step's tiles, in flight
    cp_async_commit();
    cp_async_wait<1>();                          // this step's copies have landed
    __syncthreads();
    const E* x = ring + stage * 2 * S::SLOT;
    if (kt == 0 && s == 0) {                     // a new chunk
      zero_acc(acc);
      m_lo = m_hi = kNegInf;
      l_lo = l_hi = 0.f;
    }
    if (s == 0) zero_acc(sc);
    if (live_w && s < ns) {
      M::template xyT<S::LDS, S::LDS, 8, S::DS>(sc, x, wr, x + S::SLOT, 0, lane);
    } else if (live_w) {
      // element i of n8 tile n sits at row g + 8 (i / 2), key
      // kb + 8 n + 2 t4 + i % 2; live: qpos >= kpos and kpos < T
      const int kb = kt * kTile;
      bool live[8][4];
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = kb + 8 * n + 2 * t4 + (i & 1);
          live[n][i] = (i < 2 ? r_lo : r_hi) >= kp && kp < T;
          sc[n][i] = live[n][i] ? sc[n][i] * a.scale : kNegInf;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(sc[n][0], sc[n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[n][2], sc[n][3]));
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {      // over the quad holding a row
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float c_lo = expf(m_lo - mn_lo), c_hi = expf(m_hi - mn_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = live[n][i] ? expf(sc[n][i] - (i < 2 ? mn_lo : mn_hi)) : 0.f;
          sc[n][i] = p;
          if (i < 2) sum_lo += p; else sum_hi += p;
        }
      }
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
      for (int n = 0; n < S::DC / 8; ++n) {
        acc[n][0] *= c_lo;
        acc[n][1] *= c_lo;
        acc[n][2] *= c_hi;
        acc[n][3] *= c_hi;
      }
      M::template pY<S::LDC, 8, S::DC / 8>(acc, sc, x, 0, lane);
    }
    __syncthreads();                             // this stage is free for the step after next
    if (s == ns && kt == last) {                 // chunk c is complete
      const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
      for (int n = 0; n < S::DC / 8; ++n) {
        const int col = c * S::DC + 8 * n + 2 * t4;
        if (r_lo < T) store_pair(o + static_cast<long long>(r_lo) * dh + col,
                                 acc[n][0] / den_lo, acc[n][1] / den_lo, col, dh);
        if (r_hi < T) store_pair(o + static_cast<long long>(r_hi) * dh + col,
                                 acc[n][2] / den_hi, acc[n][3] / den_hi, col, dh);
      }
      if (c == 0 && t4 == 0) {                   // the quad's lanes agree
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
    if (!more) break;
    c = nc;
    kt = nkt;
    s = nss;
    stage ^= 1;
  }
}

// K2, wide: one block per (b*h, 64 q rows), warp w owning q rows
// 16w..16w+15. Per chunk c and k tile kt: ns steps of s += q_s.k_s^T, ns of
// dp += do_s.v_s^T, then the step that forms ds and adds
// round_E(ds * scale) . k[:, chunk c].
template <typename E>
__global__ void __launch_bounds__(kWideThreads) flash_dq_kernel_wide(Args a) {
  using S = WideShape<E>;
  using M = WarpMma<E>;
  using namespace sdml_mma;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;    // the longest rows start first
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const E* q = static_cast<const E*>(a.q) + base;
  const E* k = static_cast<const E*>(a.k) + base;
  const E* v = static_cast<const E*>(a.v) + base;
  const E* dout = static_cast<const E*>(a.dout) + base;
  E* dq = static_cast<E*>(a.dq) + base;

  extern __shared__ uint4 smem_mma[];
  E* ring = reinterpret_cast<E*>(smem_mma);      // 2 stages of 2 slots

  const int q0 = qt * kTile;
  const int last = min((T + kTile - 1) / kTile - 1, qt);
  const int ns = (dh + S::DS - 1) / S::DS;
  const int nch = (dh + S::DC - 1) / S::DC;
  const int wr = warp * 16;
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  const bool live_w = q0 + wr < T;
  const float m_lo = r_lo < T ? a.m[rbase + r_lo] : 0.f;
  const float m_hi = r_hi < T ? a.m[rbase + r_hi] : 0.f;
  const float li_lo = r_lo < T ? a.linv[rbase + r_lo] : 0.f;
  const float li_hi = r_hi < T ? a.linv[rbase + r_hi] : 0.f;
  const float dl_lo = r_lo < T ? a.delta[rbase + r_lo] : 0.f;
  const float dl_hi = r_hi < T ? a.delta[rbase + r_hi] : 0.f;

  // step s < ns: q and k slices s; s < 2 ns: do and v slices s - ns;
  // s == 2 ns: k's chunk c
  auto issue = [&](int c, int kt, int s, int stage) {
    E* dst = ring + stage * 2 * S::SLOT;
    const int k0 = kt * kTile;
    if (s < 2 * ns) {
      const bool d = s >= ns;
      const int c0 = (d ? s - ns : s) * S::DS;
      load_tile_async<S::DS, kWideThreads>(dst, d ? dout : q, q0, T, dh, vec, c0);
      load_tile_async<S::DS, kWideThreads>(dst + S::SLOT, d ? v : k, k0, T, dh, vec, c0);
    } else {
      load_tile_async<S::DC, kWideThreads>(dst, k, k0, T, dh, vec, c * S::DC);
    }
  };

  float acc[S::DC / 8][4], sc[8][4], dp[8][4];
  int c = 0, kt = 0, s = 0, stage = 0;
  issue(0, 0, 0, 0);
  cp_async_commit();
#pragma unroll 1
  for (;;) {
    int nc = c, nkt = kt, nss = s;
    next_step(nc, nkt, nss, 2 * ns, 0, last);
    const bool more = nc < nch;
    if (more) issue(nc, nkt, nss, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const E* x = ring + stage * 2 * S::SLOT;
    if (kt == 0 && s == 0) zero_acc(acc);
    if (s == 0) {
      zero_acc(sc);
      zero_acc(dp);
    }
    if (live_w && s < ns) {
      M::template xyT<S::LDS, S::LDS, 8, S::DS>(sc, x, wr, x + S::SLOT, 0, lane);
    } else if (live_w && s < 2 * ns) {
      M::template xyT<S::LDS, S::LDS, 8, S::DS>(dp, x, wr, x + S::SLOT, 0, lane);
    } else if (live_w) {
      // ds * scale in place of s; element i of n8 tile n sits at row
      // g + 8 (i / 2), key kb + 8 n + 2 t4 + i % 2
      const int kb = kt * kTile;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool hi = i >= 2;
          const int qp = hi ? r_hi : r_lo;
          const int kp = kb + 8 * n + 2 * t4 + (i & 1);
          const bool live = qp >= kp && kp < T && qp < T;
          const float p =
              live ? expf(sc[n][i] * a.scale - (hi ? m_hi : m_lo)) * (hi ? li_hi : li_lo)
                   : 0.f;
          sc[n][i] = p * (dp[n][i] - (hi ? dl_hi : dl_lo)) * a.scale;
        }
      }
      M::template pY<S::LDC, 8, S::DC / 8>(acc, sc, x, 0, lane);
    }
    __syncthreads();
    if (s == 2 * ns && kt == last) {             // chunk c is complete
#pragma unroll
      for (int n = 0; n < S::DC / 8; ++n) {
        const int col = c * S::DC + 8 * n + 2 * t4;
        if (r_lo < T) store_pair(dq + static_cast<long long>(r_lo) * dh + col, acc[n][0],
                                 acc[n][1], col, dh);
        if (r_hi < T) store_pair(dq + static_cast<long long>(r_hi) * dh + col, acc[n][2],
                                 acc[n][3], col, dh);
      }
    }
    if (!more) break;
    c = nc;
    kt = nkt;
    s = nss;
    stage ^= 1;
  }
}

// K3, wide: one block per (b*h, 64 k rows), warp w owning k rows
// 16w..16w+15, scores transposed ([key, query]) as in the narrow K3. Per
// chunk c and q tile qt from the diagonal on: ns steps of
// s^T += k_s.q_s^T, ns of dp^T += v_s.do_s^T, then the step that forms p^T
// and ds^T from the q tile's row statistics and adds round_E(p)^T .
// do[:, chunk c] to dv and round_E(ds * scale)^T . q[:, chunk c] to dk.
template <typename E>
__global__ void __launch_bounds__(kWideThreads) flash_dkv_kernel_wide(Args a) {
  using S = WideShape<E>;
  using M = WarpMma<E>;
  using namespace sdml_mma;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;                     // the longest columns start first
  const int T = a.T, dh = a.dh;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const E* q = static_cast<const E*>(a.q) + base;
  const E* k = static_cast<const E*>(a.k) + base;
  const E* v = static_cast<const E*>(a.v) + base;
  const E* dout = static_cast<const E*>(a.dout) + base;
  E* dk = static_cast<E*>(a.dk) + base;
  E* dv = static_cast<E*>(a.dv) + base;

  extern __shared__ uint4 smem_mma[];
  E* ring = reinterpret_cast<E*>(smem_mma);      // 2 stages of 2 slots
  float* st_s = reinterpret_cast<float*>(ring + 4 * S::SLOT);  // 2 x m, linv, delta [64]

  const int k0 = kt * kTile;
  const int n_qt = (T + kTile - 1) / kTile;
  const int ns = (dh + S::DS - 1) / S::DS;
  const int nch = (dh + S::DC3 - 1) / S::DC3;
  const int wr = warp * 16;
  const int kr0 = k0 + wr;                       // this warp's first key
  const bool live_w = kr0 < T;

  // step s < ns: k and q slices s; s < 2 ns: v and do slices s - ns;
  // s == 2 ns: do's and q's chunk c, and the q tile's row statistics
  auto issue = [&](int c, int qt, int s, int stage) {
    E* dst = ring + stage * 2 * S::SLOT;
    const int q0 = qt * kTile;
    if (s < 2 * ns) {
      const bool d = s >= ns;
      const int c0 = (d ? s - ns : s) * S::DS;
      load_tile_async<S::DS, kWideThreads>(dst, d ? v : k, k0, T, dh, vec, c0);
      load_tile_async<S::DS, kWideThreads>(dst + S::SLOT, d ? dout : q, q0, T, dh, vec, c0);
    } else {
      load_tile_async<S::DC3, kWideThreads>(dst, dout, q0, T, dh, vec, c * S::DC3);
      load_tile_async<S::DC3, kWideThreads>(dst + S::SLOT, q, q0, T, dh, vec, c * S::DC3);
      float* rows = st_s + 3 * kTile * stage;
      load_rows_async<kWideThreads>(rows, a.m + rbase, q0, T);
      load_rows_async<kWideThreads>(rows + kTile, a.linv + rbase, q0, T);
      load_rows_async<kWideThreads>(rows + 2 * kTile, a.delta + rbase, q0, T);
    }
  };

  float acc_k[S::DC3 / 8][4], acc_v[S::DC3 / 8][4], st[8][4], dpt[8][4];
  int c = 0, qt = kt, s = 0, stage = 0;
  issue(0, kt, 0, 0);
  cp_async_commit();
#pragma unroll 1
  for (;;) {
    int nc = c, nqt = qt, nss = s;
    next_step(nc, nqt, nss, 2 * ns, kt, n_qt - 1);
    const bool more = nc < nch;
    if (more) issue(nc, nqt, nss, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const E* x = ring + stage * 2 * S::SLOT;
    if (qt == kt && s == 0) {
      zero_acc(acc_k);
      zero_acc(acc_v);
    }
    if (s == 0) {
      zero_acc(st);
      zero_acc(dpt);
    }
    if (live_w && s < ns) {
      M::template xyT<S::LDS, S::LDS, 8, S::DS>(st, x, wr, x + S::SLOT, 0, lane);
    } else if (live_w && s < 2 * ns) {
      M::template xyT<S::LDS, S::LDS, 8, S::DS>(dpt, x, wr, x + S::SLOT, 0, lane);
    } else if (live_w) {
      // p^T in place of s^T and ds^T * scale in place of dp^T; element i of
      // n8 tile n sits at key kr0 + g + 8 (i / 2), query column
      // 8 n + 2 t4 + i % 2 of the tile
      const float* m_s = st_s + 3 * kTile * stage;
      const float* li_s = m_s + kTile;
      const float* dl_s = li_s + kTile;
      const int q0 = qt * kTile;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * t4;
        const float mc[2] = {m_s[col], m_s[col + 1]};
        const float lc[2] = {li_s[col], li_s[col + 1]};
        const float dc[2] = {dl_s[col], dl_s[col + 1]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = i & 1;
          const int kp = kr0 + g + 8 * (i >> 1);
          const int qp = q0 + col + j;
          const bool live = qp >= kp && kp < T && qp < T;
          const float p = live ? expf(st[n][i] * a.scale - mc[j]) * lc[j] : 0.f;
          dpt[n][i] = p * (dpt[n][i] - dc[j]) * a.scale;
          st[n][i] = p;
        }
      }
      M::template pY<S::LDC3, 8, S::DC3 / 8>(acc_v, st, x, 0, lane);
      M::template pY<S::LDC3, 8, S::DC3 / 8>(acc_k, dpt, x + S::SLOT, 0, lane);
    }
    __syncthreads();
    if (s == 2 * ns && qt == n_qt - 1 && live_w) {  // chunk c is complete
      const int r_lo = kr0 + g, r_hi = r_lo + 8;
#pragma unroll
      for (int n = 0; n < S::DC3 / 8; ++n) {
        const int col = c * S::DC3 + 8 * n + 2 * t4;
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
    if (!more) break;
    c = nc;
    qt = nqt;
    s = nss;
    stage ^= 1;
  }
}

// ---- launch --------------------------------------------------------------------

enum Pass { kForward = 0, kDq = 1, kDkv = 2 };

cudaError_t launch_kernel(void (*kernel)(Args), const Args& a, int BH, int threads,
                          size_t smem, cudaStream_t stream) {
  const dim3 grid(BH, (a.T + kTile - 1) / kTile);
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

template <typename E>
cudaError_t launch_wide(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  constexpr size_t ring = WideShape<E>::STAGES;  // 2 stages of 2 slice tiles
  switch (pass) {
    case kForward:
      return launch_kernel(flash_fwd_kernel_wide<E>, a, BH, kWideThreads, ring, stream);
    case kDq:
      return launch_kernel(flash_dq_kernel_wide<E>, a, BH, kWideThreads, ring, stream);
    default:                                     // and 2 x the q tile's rows
      return launch_kernel(flash_dkv_kernel_wide<E>, a, BH, kWideThreads,
                           ring + 2 * 3 * kTile * sizeof(float), stream);
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
