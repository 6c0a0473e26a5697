// Causal flash attention for Hopper (sm_90a): the forward (K1) and the two
// backward passes, dq (K2) and dk/dv (K3), of the training path.
//
// Replaces simple_distributed_machine_learning_tpu/ops/flash_attention.py::
//   _flash_kernel (K1), _dq_kernel (K2) and _dkv_kernel (K3),
// the Pallas TPU kernels behind its jax.custom_vjp flash_attention.
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
// What bounds it: at the training shapes (B 16, H 8, T 256, dh 64, bf16)
// each kernel does ~1-2 GFLOP of causal products against ~17-26 MB of
// q/k/v/o/do traffic, so all three are bound by bytes (K1 17.0 MB, K2 21.4
// MB, K3 25.6 MB: ~5-8 us at 3.35 TB/s, against 1.1-2.2 us of products at
// the 989 TFLOP/s bf16 tensor-core rate). Each q (or k/v) tile is read from
// device memory once per block and reused across the whole loop, and causal
// tiles past the diagonal are neither loaded nor computed.
//
// Two implementations:
// - SIMT, for f32 (K1, K2, K3): products on the CUDA cores in f32 from f32
//   shared-memory tiles (each thread a 4 x 4 score sub-tile and a 4 x (dh/16)
//   output sub-tile), scores in shared memory, a barrier between load,
//   scores, softmax and accumulate. Bound in practice by issuing FMAs and
//   the shared loads feeding them (8 loads per 16 FMAs), ~20x the byte
//   bound. f32 stays here: TF32 tensor cores would keep ~10 bits and break
//   the 1e-5 parity of f32 o and the 1e-4 parity of the f32 gradients.
// - Tensor cores, for bf16 (K1, K2, K3: flash_*_kernel_bf16_mma): every
//   product is mma.sync m16n8k16, bf16 x bf16 summed in f32 — the same
//   casts as the TPU kernels' preferred_element_type=f32 dots, only the
//   order of the f32 sums differs. 4 warps per 64-row tile, each owning 16
//   rows: in K1 and K2, 16 q rows (K1: S = Q_w.K^T, the online softmax on
//   the accumulator fragments, then O += round(P).V; K2: S = Q_w.K^T,
//   dP = dO_w.V^T, then dq += dS.K); in K3, 16 k rows computing S^T =
//   K_w.Q^T and dP^T = V_w.dO^T directly, so that p^T and ds^T come out as
//   the A operands of dv += P^T.dO and dk += dS^T.Q. p and ds never leave
//   the registers: an m16n8 accumulator pair is repacked in place as a k16
//   A fragment (mma_bf16.cuh). Tiles stay bf16 in shared memory (rows
//   padded to dh + 8 so ldmatrix is free of bank conflicts; the head dim
//   padded with zeros to DP in {16, 32, 64, 128}), and a 2-stage cp.async
//   ring copies the next k/v (K1, K2) or q/dO + row-statistics (K3) tile
//   while this one is multiplied. Shared memory at dh 64: K1 45 KB a block
//   (q + 2 x (k, v)), so 4 blocks fit an SM; K2 and K3 55 KB. Inside the
//   diagonal tile each warp skips the 16- or 32-wide sub-blocks its causal
//   mask zeroes whole.
//   K1's online softmax runs per 16- or 32-key sub-block on the fragments:
//   a row's max and sum reduce over the quad of lanes that holds it
//   (__shfl_xor_sync 1, 2); l sums the unrounded f32 p, as the TPU kernel
//   does, and p is rounded to bf16 only as the A operand of O += P.V, so p
//   is rounded against the running max of the sub-blocks seen so far (the
//   TPU kernel: of its k blocks so far; the plain version: the final max).
//   m and l are saved in the natural units of the scaled scores, which K2
//   and K3 read back. A row wholly masked in a sub-block keeps m (the max
//   with NEG_INF) and gets p = 0 from the mask, never from exp(0) = 1.
// The next steps are wgmma and TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;                  // q rows and k rows per tile
constexpr int kThreads = 256;              // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int kRows = kTile / 16;          // tile rows per thread: ty + 16 i
constexpr int kCols = kTile / 16;          // score columns per thread: tx + 16 j
constexpr int kLdS = kTile + 1;            // padded row stride of a score tile
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows [r0, r0 + 64) of a contiguous [T, dh] f32 slab into shared memory
// with row stride ld = dh + 1 (the pad keeps column reads conflict-free);
// rows at or past T are zero
__device__ void load_tile(float* dst, const float* src, int r0, int T, int dh) {
  const int ld = dh + 1;
  for (int i = threadIdx.x; i < kTile * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    const int row = r0 + r;
    dst[r * ld + d] = row < T ? src[static_cast<long long>(row) * dh + d] : 0.f;
  }
}

// per-row f32 statistics [r0, r0 + 64) (0 past T)
__device__ void load_rows(float* dst, const float* src, int r0, int T) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    dst[r] = r0 + r < T ? src[r0 + r] : 0.f;
  }
}

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
  int vec;             // dh % 8 == 0 and q/k/v/dout 16-byte aligned: rows
                       // copy as 16-byte cp.async chunks (bf16 kernels)
};

// s[i][j] = sum_d a[row_i][d] * b[col_j][d] over two [64, ld] tiles
__device__ __forceinline__ void tile_dots(float (&s)[kRows][kCols], const float* a,
                                          const float* b, int dh, int ty, int tx) {
  const int ld = dh + 1;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < dh; ++d) {
    float av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// ---- K1: forward (SIMT, f32) ---------------------------------------------------

template <int JD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  const int bh = blockIdx.x;
  const int n_tiles = gridDim.y;
  const int qt = n_tiles - 1 - blockIdx.y;      // the longest rows start first
  const int T = a.T, dh = a.dh, ld = dh + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const long long base = static_cast<long long>(bh) * T * dh;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [64, ld]
  float* k_s = q_s + kTile * ld;        // [64, ld]
  float* v_s = k_s + kTile * ld;        // [64, ld]
  float* p_s = v_s + kTile * ld;        // [64, kLdS] scores, then p
  float* c_s = p_s + kTile * kLdS;      // [64] this tile's rescale factor
  float* m_s = c_s + kTile;             // [64] running row max
  float* l_s = m_s + kTile;             // [64] running row sum

  const int q0 = qt * kTile;
  load_tile(q_s, q, q0, T, dh);
  for (int r = tid; r < kTile; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  int dcol[JD];                          // this thread's head-dim columns,
#pragma unroll                           // clamped in range (the clamped
  for (int j = 0; j < JD; ++j) {         // duplicates are never stored)
    dcol[j] = min(tx + 16 * j, dh - 1);
  }
  float acc[kRows][JD];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;

  const int n_kt = (T + kTile - 1) / kTile;
  const int last = min(n_kt - 1, (q0 + kTile - 1) / kTile);
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                     // the previous tile's readers are done
    load_tile(k_s, k, k0, T, dh);
    load_tile(v_s, v, k0, T, dh);
    __syncthreads();

    float s[kRows][kCols];
    tile_dots(s, q_s, k_s, dh, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        const bool live = qp >= kp && kp < T;
        p_s[r * kLdS + c] = live ? s[i][j] * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, two columns per lane
    for (int r = warp; r < kTile; r += kThreads / 32) {
      float* row = p_s + r * kLdS;
      const int qp = q0 + r;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const int kp0 = k0 + lane, kp1 = kp0 + 32;
      const float p0 = (qp >= kp0 && kp0 < T) ? expf(x0 - m_new) : 0.f;
      const float p1 = (qp >= kp1 && kp1 < T) ? expf(x1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[kRows], vv[JD];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < JD; ++j) vv[j] = v_s[c * ld + dcol[j]];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < JD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  float* o = static_cast<float*>(a.o) + base;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    if (qp >= T) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) o[static_cast<long long>(qp) * dh + d] = acc[i][j] / den;
    }
  }
  for (int r = tid; r < kTile; r += kThreads) {
    if (q0 + r < T) {
      a.l[static_cast<long long>(bh) * T + q0 + r] = l_s[r];
      a.m[static_cast<long long>(bh) * T + q0 + r] = m_s[r];
    }
  }
}

// SIMT K2/K3: p and ds of one (q tile, k tile) pair from the saved
// statistics, for this thread's 4 x 4 entries (q rows ty + 16 i, k columns tx + 16 j); s and dp
// are the raw q.k^T and do.v^T dots
__device__ __forceinline__ void recompute_p_ds(float (&s)[kRows][kCols],
                                               float (&dp)[kRows][kCols],
                                               const float* m_r, const float* li_r,
                                               const float* dl_r, int q0, int k0,
                                               int T, float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const int qp = q0 + r, kp = k0 + c;
      const bool live = qp >= kp && kp < T && qp < T;
      const float p = live ? expf(s[i][j] * scale - m_r[r]) * li_r[r] : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl_r[r]);
    }
  }
}

// ---- K2: dq (SIMT, f32) ----------------------------------------------------------

template <int JD>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  const int bh = blockIdx.x;
  const int n_tiles = gridDim.y;
  const int qt = n_tiles - 1 - blockIdx.y;
  const int T = a.T, dh = a.dh, ld = dh + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [64, ld]
  float* do_s = q_s + kTile * ld;       // [64, ld]
  float* k_s = do_s + kTile * ld;       // [64, ld]
  float* v_s = k_s + kTile * ld;        // [64, ld]
  float* ds_s = v_s + kTile * ld;       // [64, kLdS] round_E(ds * scale)
  float* m_r = ds_s + kTile * kLdS;     // [64]
  float* li_r = m_r + kTile;            // [64]
  float* dl_r = li_r + kTile;           // [64]

  const int q0 = qt * kTile;
  load_tile(q_s, q, q0, T, dh);
  load_tile(do_s, dout, q0, T, dh);
  load_rows(m_r, a.m + rbase, q0, T);
  load_rows(li_r, a.linv + rbase, q0, T);
  load_rows(dl_r, a.delta + rbase, q0, T);
  int dcol[JD];
#pragma unroll
  for (int j = 0; j < JD; ++j) dcol[j] = min(tx + 16 * j, dh - 1);
  float acc[kRows][JD];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;

  const int n_kt = (T + kTile - 1) / kTile;
  const int last = min(n_kt - 1, (q0 + kTile - 1) / kTile);
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(k_s, k, k0, T, dh);
    load_tile(v_s, v, k0, T, dh);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    tile_dots(s, q_s, k_s, dh, ty, tx);
    tile_dots(dp, do_s, v_s, dh, ty, tx);
    recompute_p_ds(s, dp, m_r, li_r, dl_r, q0, k0, T, a.scale, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        ds_s[(ty + 16 * i) * kLdS + tx + 16 * j] = dp[i][j] * a.scale;
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dv_[kRows], kv[JD];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dv_[i] = ds_s[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < JD; ++j) kv[j] = k_s[c * ld + dcol[j]];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < JD; ++j) acc[i][j] = fmaf(dv_[i], kv[j], acc[i][j]);
    }
  }

  float* dq = static_cast<float*>(a.dq) + base;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= T) continue;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) dq[static_cast<long long>(qp) * dh + d] = acc[i][j];
    }
  }
}

// ---- K3: dk, dv (SIMT, f32) ------------------------------------------------------

template <int JD>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;                    // the longest columns start first
  const int T = a.T, dh = a.dh, ld = dh + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;

  extern __shared__ float smem[];
  float* k_s = smem;                    // [64, ld]
  float* v_s = k_s + kTile * ld;        // [64, ld]
  float* q_s = v_s + kTile * ld;        // [64, ld]
  float* do_s = q_s + kTile * ld;       // [64, ld]
  float* p_s = do_s + kTile * ld;       // [64 q, kLdS] round_E(p)
  float* ds_s = p_s + kTile * kLdS;     // [64 q, kLdS] round_E(ds * scale)
  float* m_r = ds_s + kTile * kLdS;     // [64]
  float* li_r = m_r + kTile;
  float* dl_r = li_r + kTile;

  const int k0 = kt * kTile;
  load_tile(k_s, k, k0, T, dh);
  load_tile(v_s, v, k0, T, dh);
  int dcol[JD];
#pragma unroll
  for (int j = 0; j < JD; ++j) dcol[j] = min(tx + 16 * j, dh - 1);
  // this thread's dk/dv rows are k rows ty + 16 i, columns dcol[j]
  float acc_k[kRows][JD], acc_v[kRows][JD];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }

  const int n_qt = (T + kTile - 1) / kTile;
  for (int qt = k0 / kTile; qt < n_qt; ++qt) {   // from the diagonal on
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(q_s, q, q0, T, dh);
    load_tile(do_s, dout, q0, T, dh);
    load_rows(m_r, a.m + rbase, q0, T);
    load_rows(li_r, a.linv + rbase, q0, T);
    load_rows(dl_r, a.delta + rbase, q0, T);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];    // [q row ty + 16 i, k col tx + 16 j]
    tile_dots(s, q_s, k_s, dh, ty, tx);
    tile_dots(dp, do_s, v_s, dh, ty, tx);
    recompute_p_ds(s, dp, m_r, li_r, dl_r, q0, k0, T, a.scale, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int at = (ty + 16 * i) * kLdS + tx + 16 * j;
        p_s[at] = s[i][j];
        ds_s[at] = dp[i][j] * a.scale;
      }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float pv[kRows], dsv[kRows], dov[JD], qv[JD];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = p_s[r * kLdS + ty + 16 * i];
        dsv[i] = ds_s[r * kLdS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        dov[j] = do_s[r * ld + dcol[j]];
        qv[j] = q_s[r * ld + dcol[j]];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < JD; ++j) {
          acc_v[i][j] = fmaf(pv[i], dov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
        }
    }
  }

  float* dk = static_cast<float*>(a.dk) + base;
  float* dv = static_cast<float*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= T) continue;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) {
        dk[static_cast<long long>(kp) * dh + d] = acc_k[i][j];
        dv[static_cast<long long>(kp) * dh + d] = acc_v[i][j];
      }
    }
  }
}

// ---- K2, K3 in bf16: tensor cores ----------------------------------------------

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

// rows [r0, r0 + 64) of a contiguous [T, dh] bf16 slab into a [64, LD]
// shared tile: 16-byte cp.async chunks where the slab allows (vec), else
// element copies; rows at or past T and columns at or past dh are zero
template <int DP>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src, int r0,
                                               int T, int dh, bool vec) {
  constexpr int LD = MmaShape<DP>::LD, CH = DP / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += kMmaThreads) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const int row = r0 + r;
    __nv_bfloat16* d = dst + r * LD + c;
    if (row < T && c < dh) {
      const __nv_bfloat16* s = src + static_cast<long long>(row) * dh + c;
      if (vec) {
        sdml_mma::cp_async16(d, s);             // vec: dh % 8 == 0, so c + 8 <= dh
      } else {
        for (int j = 0; j < 8; ++j) d[j] = c + j < dh ? s[j] : __float2bfloat16(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// per-row f32 statistics [r0, r0 + 64) by 4-byte cp.async (0 past T)
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int r0,
                                                int T) {
  for (int r = threadIdx.x; r < kTile; r += kMmaThreads) {
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
  load_tile_bf16<DP>(q_s, q, q0, T, dh, vec);
  load_tile_bf16<DP>(kv_s, k, 0, T, dh, vec);
  load_tile_bf16<DP>(kv_s + S::TILE, v, 0, T, dh, vec);
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
      load_tile_bf16<DP>(nxt, k, (kt + 1) * kTile, T, dh, vec);
      load_tile_bf16<DP>(nxt + S::TILE, v, (kt + 1) * kTile, T, dh, vec);
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
  load_tile_bf16<DP>(q_s, q, q0, T, dh, vec);
  load_tile_bf16<DP>(do_s, dout, q0, T, dh, vec);
  load_tile_bf16<DP>(kv_s, k, 0, T, dh, vec);
  load_tile_bf16<DP>(kv_s + S::TILE, v, 0, T, dh, vec);
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
      load_tile_bf16<DP>(nxt, k, (kt + 1) * kTile, T, dh, vec);
      load_tile_bf16<DP>(nxt + S::TILE, v, (kt + 1) * kTile, T, dh, vec);
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
    load_tile_bf16<DP>(dst, q, q0, T, dh, vec);
    load_tile_bf16<DP>(dst + S::TILE, dout, q0, T, dh, vec);
    load_rows_async(rows, a.m + rbase, q0, T);
    load_rows_async(rows + kTile, a.linv + rbase, q0, T);
    load_rows_async(rows + 2 * kTile, a.delta + rbase, q0, T);
  };

  const int k0 = kt * kTile;
  const int n_qt = (T + kTile - 1) / kTile;
  load_tile_bf16<DP>(k_s, k, k0, T, dh, vec);
  load_tile_bf16<DP>(v_s, v, k0, T, dh, vec);
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

// ---- launch --------------------------------------------------------------------

enum Pass { kForward = 0, kDq = 1, kDkv = 2 };

size_t smem_bytes(Pass pass, int dh) {
  const size_t tile = static_cast<size_t>(kTile) * (dh + 1);
  const size_t score = static_cast<size_t>(kTile) * kLdS;
  switch (pass) {
    case kForward: return (3 * tile + score + 3 * kTile) * sizeof(float);
    case kDq: return (4 * tile + score + 3 * kTile) * sizeof(float);
    default: return (4 * tile + 2 * score + 3 * kTile) * sizeof(float);
  }
}

cudaError_t launch_kernel(void (*kernel)(Args), const Args& a, int BH, int threads,
                          size_t smem, cudaStream_t stream) {
  const dim3 grid(BH, (a.T + kTile - 1) / kTile);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the SIMT kernels, f32
template <int JD>
cudaError_t launch_simt(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  void (*kernel)(Args) = pass == kForward ? flash_fwd_kernel<JD>
                         : pass == kDq    ? flash_dq_kernel<JD>
                                          : flash_dkv_kernel<JD>;
  return launch_kernel(kernel, a, BH, kThreads, smem_bytes(pass, a.dh), stream);
}

cudaError_t launch_f32(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  return a.dh <= 64 ? launch_simt<4>(pass, a, BH, stream)
                    : launch_simt<8>(pass, a, BH, stream);
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

// the tensor-core K1-K3, head dim padded to 16, 32, 64 or 128
cudaError_t launch_bf16(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  if (a.dh <= 16) return launch_mma<16>(pass, a, BH, stream);
  if (a.dh <= 32) return launch_mma<32>(pass, a, BH, stream);
  if (a.dh <= 64) return launch_mma<64>(pass, a, BH, stream);
  return launch_mma<128>(pass, a, BH, stream);
}

int launch(Pass pass, Args a, int BH, int dtype, void* stream) {
  if (BH < 1 || BH > 2147483647 || a.T < 1 || a.T > 65535 * kTile || a.dh < 1 ||
      a.dh > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) |
                         reinterpret_cast<uintptr_t>(a.dout);
  a.vec = a.dh % 8 == 0 && (ptrs & 15u) == 0;
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
