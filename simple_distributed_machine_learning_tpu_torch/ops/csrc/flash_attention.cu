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
// q/k/v/o/do traffic, so on paper all three are bound by bytes (~5-8 us at
// 3.35 TB/s). This first version computes the products on the CUDA cores
// in f32 (SIMT FMAs from shared memory, each thread a 4 x 4 score sub-tile
// and a 4 x (dh/16) output sub-tile), so in practice it is bound by issuing
// those FMAs and the shared-memory loads that feed them (8 loads per 16
// FMAs), with a barrier between load, scores, softmax and accumulate: ~20x
// the byte bound on an H100. A bf16 x bf16 product is exact in f32, so
// only the order of sums differs from a tensor-core product. What the design
// does about the bytes: each q (or k/v) tile is read from device memory once
// per block and reused across the whole loop, the score matrix never leaves
// shared memory, and causal tiles past the diagonal are neither loaded nor
// computed. Tensor cores (wgmma), TMA and double buffering are the next
// steps; a simple kernel that is right comes first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;                  // q rows and k rows per tile
constexpr int kThreads = 256;              // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int kRows = kTile / 16;          // tile rows per thread: ty + 16 i
constexpr int kCols = kTile / 16;          // score columns per thread: tx + 16 j
constexpr int kLdS = kTile + 1;            // padded row stride of a score tile
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename E> __device__ __forceinline__ E from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to(bfloat16)
}

// x rounded through E (the TPU kernel's .astype(dtype) before a product)
template <typename E> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<E>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows [r0, r0 + 64) of a contiguous [T, dh] slab into shared memory as f32
// with row stride ld = dh + 1 (the pad keeps column reads conflict-free);
// rows at or past T are zero
template <typename E>
__device__ void load_tile(float* dst, const E* src, int r0, int T, int dh) {
  const int ld = dh + 1;
  for (int i = threadIdx.x; i < kTile * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    const int row = r0 + r;
    dst[r * ld + d] = row < T ? to_f32(src[static_cast<long long>(row) * dh + d]) : 0.f;
  }
}

// per-row f32 statistics [r0, r0 + 64) (0 past T)
__device__ void load_rows(float* dst, const float* src, int r0, int T) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    dst[r] = r0 + r < T ? src[r0 + r] : 0.f;
  }
}

struct Args {
  const void* q;       // [BH, T, dh], contiguous, all four in dtype E
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

// ---- K1: forward -------------------------------------------------------------

template <typename E, int JD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  const int bh = blockIdx.x;
  const int n_tiles = gridDim.y;
  const int qt = n_tiles - 1 - blockIdx.y;      // the longest rows start first
  const int T = a.T, dh = a.dh, ld = dh + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const long long base = static_cast<long long>(bh) * T * dh;
  const E* q = static_cast<const E*>(a.q) + base;
  const E* k = static_cast<const E*>(a.k) + base;
  const E* v = static_cast<const E*>(a.v) + base;

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
      row[lane] = round_to<E>(p0);
      row[lane + 32] = round_to<E>(p1);
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

  E* o = static_cast<E*>(a.o) + base;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    if (qp >= T) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) o[static_cast<long long>(qp) * dh + d] = from_f32<E>(acc[i][j] / den);
    }
  }
  for (int r = tid; r < kTile; r += kThreads) {
    if (q0 + r < T) {
      a.l[static_cast<long long>(bh) * T + q0 + r] = l_s[r];
      a.m[static_cast<long long>(bh) * T + q0 + r] = m_s[r];
    }
  }
}

// p and ds of one (q tile, k tile) pair from the saved statistics, for this
// thread's 4 x 4 entries (q rows ty + 16 i, k columns tx + 16 j); s and dp
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

// ---- K2: dq ------------------------------------------------------------------

template <typename E, int JD>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  const int bh = blockIdx.x;
  const int n_tiles = gridDim.y;
  const int qt = n_tiles - 1 - blockIdx.y;
  const int T = a.T, dh = a.dh, ld = dh + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const E* q = static_cast<const E*>(a.q) + base;
  const E* k = static_cast<const E*>(a.k) + base;
  const E* v = static_cast<const E*>(a.v) + base;
  const E* dout = static_cast<const E*>(a.dout) + base;

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
        ds_s[(ty + 16 * i) * kLdS + tx + 16 * j] = round_to<E>(dp[i][j] * a.scale);
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

  E* dq = static_cast<E*>(a.dq) + base;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= T) continue;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) dq[static_cast<long long>(qp) * dh + d] = from_f32<E>(acc[i][j]);
    }
  }
}

// ---- K3: dk, dv ----------------------------------------------------------------

template <typename E, int JD>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;                    // the longest columns start first
  const int T = a.T, dh = a.dh, ld = dh + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long base = static_cast<long long>(bh) * T * dh;
  const long long rbase = static_cast<long long>(bh) * T;
  const E* q = static_cast<const E*>(a.q) + base;
  const E* k = static_cast<const E*>(a.k) + base;
  const E* v = static_cast<const E*>(a.v) + base;
  const E* dout = static_cast<const E*>(a.dout) + base;

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
        p_s[at] = round_to<E>(s[i][j]);
        ds_s[at] = round_to<E>(dp[i][j] * a.scale);
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

  E* dk = static_cast<E*>(a.dk) + base;
  E* dv = static_cast<E*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= T) continue;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) {
        dk[static_cast<long long>(kp) * dh + d] = from_f32<E>(acc_k[i][j]);
        dv[static_cast<long long>(kp) * dh + d] = from_f32<E>(acc_v[i][j]);
      }
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

template <typename E, int JD>
cudaError_t launch_typed(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  const int n_tiles = (a.T + kTile - 1) / kTile;
  const size_t smem = smem_bytes(pass, a.dh);
  const dim3 grid(BH, n_tiles);
  void (*kernel)(Args) = pass == kForward ? flash_fwd_kernel<E, JD>
                         : pass == kDq    ? flash_dq_kernel<E, JD>
                                          : flash_dkv_kernel<E, JD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_dh(Pass pass, const Args& a, int BH, cudaStream_t stream) {
  return a.dh <= 64 ? launch_typed<E, 4>(pass, a, BH, stream)
                    : launch_typed<E, 8>(pass, a, BH, stream);
}

int launch(Pass pass, Args a, int BH, int dtype, void* stream) {
  if (BH < 1 || BH > 2147483647 || a.T < 1 || a.T > 65535 * kTile || a.dh < 1 ||
      a.dh > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dh<float>(pass, a, BH, st); break;
    case 1: err = launch_dh<__nv_bfloat16>(pass, a, BH, st); break;
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
