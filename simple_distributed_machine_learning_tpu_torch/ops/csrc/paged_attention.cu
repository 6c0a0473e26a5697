// Paged attention for Hopper (sm_90a): block-table gather + position-masked
// online-softmax attention in one pass, with int8/fp8 dequantisation fused.
//
// Replaces simple_distributed_machine_learning_tpu/ops/paged_attention.py::
// _paged_attn_kernel, the Pallas TPU kernel of the serving decode tick and
// of the speculative verify step.
//
// What it computes, for each slot s, head h and group g of at most 8 of the
// slot's K queries (one thread block each):
//   for the logical blocks kb = 0 .. qpos[s, last query of g] / bs
//   (clamped to NB):
//     phys = tables[s, kb]                 (read here; no scalar prefetch)
//     K/V rows of that block for head h, times the per-row f32 scales
//     when the pool is quantised
//     for each query j of the group: f32 scores * 1/sqrt(dh), masked to
//     kpos <= qpos[s, j], folded into an online softmax (m, l, acc) in f32
//   out[s, h, j, :] = acc / max(l, 1e-30)   (f32), for the group's rows j
// The TPU kernel's sequential k-block grid axis becomes parallel warps
// here, and its past-the-end clamp min(kb, last) the warps' loop bound. Its
// packed layout and 128-lane l/m scratch were TPU tiling workarounds: not
// needed.
//
// What bounds it: the decode tick does ~2 flops per K/V byte it reads, far
// below the card's ~295 ops per byte, so its bound is the bytes of the K/V
// rows up to each slot's position, read once: ~4 MB at the serving shapes
// (8 slots, 8 heads, dh 64, f32), ~1 us at 3.35 TB/s. That is less than one
// memory round trip per row a serial walk would take, so what sets the time
// is how many loads are in flight, not how many bytes they carry. The
// design:
// - Each (slot, head) block splits the slot's table across W warps (W = 16
//   for K = 1, the decode tick: one pass covers the 16 blocks of a
//   256-position slot at block size 16; W = 8 for K = 2..8, whose per-lane
//   output columns need more than the 128 registers a thread of a 512-thread
//   block may have). Warp w takes logical blocks
//   w, w + W, ...; no block barrier runs inside the key loop.
// - Inside a warp, lpr lanes (a power of two, the fewest whose 16-byte
//   loads cover dh; 8-byte for int8/fp8, so a lane holds at most 8 output
//   columns) read one row's [dh] slab, neighbouring lanes on neighbouring
//   addresses, and 32 / lpr such lane groups take rows g, g + 32/lpr, ...
//   of the block. Each lane group keeps its own (m, l, acc) for the K
//   queries in registers: its rows fold in one at a time, with the score
//   summed over the group's lanes by shuffles. A ring of PD rows per group
//   (4 for K = 1, else 2) is loaded ahead of the one being folded, across
//   paged-block boundaries, so every warp keeps several rows' bytes in
//   flight. Narrow values are dequantised in registers, times the row's
//   f32 scale.
// - The TPU kernel takes any number K of queries per slot (the speculative
//   verify step runs it at K = spec_k). A lane holds its output columns for
//   every query of its block in registers, so a block takes at most 8: the
//   grid's third axis splits the K queries into ceil(K / 8) groups of
//   consecutive queries, one launch for all of them. A group bounds its key
//   loop by its own last position (qpos is non-decreasing), so a group of
//   early queries stops early; it writes only its own rows of out. The cost:
//   each group reads the slot's K/V rows again, so at K = 16 the kernel
//   moves about twice the bytes of its bound.
// - The partial states merge once at the end: across a warp's lane groups
//   by shuffles, then across warps through shared memory behind a single
//   barrier (m* = max m_w; acc = sum acc_w exp(m_w - m*); l likewise), in a
//   fixed order, so the result does not depend on which warp ran first. A
//   state that saw no live row (l = 0) gets weight 0; a masked row never
//   enters a state, so its p is zero by the mask, not by the exponent.
// - An odd head dim or a pool view whose rows are not aligned to the load
//   width takes an element-wise load path inside the same kernel.
// - Head dims above 256 (the JAX kernel takes any): the 32 lanes of a warp
//   hold 256 output columns at most (8 each), so the output is made in
//   chunks of 256 columns, one block per chunk (the grid's third axis runs
//   over query groups x chunks). A block's ring loads its chunk's K and V
//   columns as above; each row's score also needs the K columns of the
//   other chunks, which its lanes read straight from the pool (no ring) and
//   dot with q read from device memory. So a row's K bytes are read once
//   per chunk, V's once: at dh 512 the kernel moves 1.5x its bound's
//   bytes, a price paid only past 256.
// The block table entries are read once per warp (a lane per entry, handed
// round by shuffles), qpos once per thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroupQueries = 8;   // queries one block takes

// Storage types: S is one stored element, V what a lane loads at once,
// f() an element's f32 value.
struct F32 {
  using S = uint32_t;
  using V = uint4;
  static __device__ __forceinline__ float f(S x) { return __uint_as_float(x); }
};
struct BF16 {
  using S = uint16_t;
  using V = uint4;
  static __device__ __forceinline__ float f(S x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
};
struct I8 {
  using S = uint8_t;
  using V = uint2;
  static __device__ __forceinline__ float f(S x) {
    return static_cast<float>(static_cast<int8_t>(x));
  }
};
struct E4M3 {
  using S = uint8_t;
  using V = uint2;
  static __device__ __forceinline__ float f(S x) {
    __nv_fp8_e4m3 v;
    v.__x = x;
    return static_cast<float>(v);
  }
};
struct E5M2 {
  using S = uint8_t;
  using V = uint2;
  static __device__ __forceinline__ float f(S x) {
    __nv_fp8_e5m2 v;
    v.__x = x;
    return static_cast<float>(v);
  }
};

// warps a block for up to kq queries, and rows a lane group keeps in
// flight with ncu loads per lane and row
__host__ __device__ constexpr int warps_for(int kq) { return kq == 1 ? 16 : 8; }
__host__ __device__ constexpr int depth_for(int kq, int ncu) { return kq == 1 && ncu == 1 ? 4 : 2; }

struct Args {
  const float* q;      // [S, H, K, dh], contiguous
  const void* kc;      // one layer's blocks [n_blocks, H, bs, dh], dh contiguous
  const void* vc;
  const float* ks;     // [n_blocks, H, bs] dequant scales, or null
  const float* vs;
  const int* tables;   // [S, NB], contiguous
  const int* qpos;     // [S, K], contiguous, non-decreasing along K
  float* out;          // [S, H, K, dh], contiguous
  int S, H, K, dh, bs, NB;
  int KG;              // queries per group: min(K, kGroupQueries)
  int lpr, lpr_log2;   // lanes per row (a power of two)
  int vec;             // rows load as whole V chunks (dh and strides allow)
  int nch;             // column chunks (dh > 256: ceil(dh / 256); else 1)
  long long k_sb, k_sh, k_sr, v_sb, v_sh, v_sr;        // element strides
  long long ks_sb, ks_sh, ks_sr, vs_sb, vs_sh, vs_sr;
  float scale;
};

// a ring row's element offset in the pool, kept only where a block reads
// the row's other column chunks (WIDE)
template <bool WIDE>
struct RowOffset {
  __device__ __forceinline__ void set(long long) {}
  __device__ __forceinline__ long long get() const { return 0; }
};
template <>
struct RowOffset<true> {
  long long off;
  __device__ __forceinline__ void set(long long o) { off = o; }
  __device__ __forceinline__ long long get() const { return off; }
};

template <class D, int KQ, int NCU, bool WIDE>
__global__ void __launch_bounds__(32 * warps_for(KQ)) paged_attn_kernel(Args a) {
  using S = typename D::S;
  using V = typename D::V;
  constexpr int W = warps_for(KQ), PD = depth_for(KQ, NCU);
  constexpr int CPL = sizeof(V) / sizeof(S);     // columns one load covers
  constexpr int NC = NCU * CPL;                  // columns a lane holds
  union Chunk {
    V v;
    S e[CPL];
  };
  struct Row {
    Chunk k[NCU], v[NCU];
    float ks, vs;
    RowOffset<WIDE> at;                          // WIDE: the K row's offset
  };

  const int s = blockIdx.x, h = blockIdx.y;
  // WIDE: the grid's third axis is (query group, column chunk ch)
  const int grp = WIDE ? blockIdx.z / a.nch : blockIdx.z;
  const int ch = WIDE ? blockIdx.z - grp * a.nch : 0;
  const int j0 = grp * a.KG;                     // the group's first query
  const int K = min(a.KG, a.K - j0);             // queries of this group
  const int dh = a.dh, bs = a.bs, lpr = a.lpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> a.lpr_log2, cl = lane & (lpr - 1);
  const int rpw = 32 >> a.lpr_log2;              // rows a warp load covers
  const int nstep = (bs + rpw - 1) / rpw;        // loads per paged block
  const int dhp = NCU * lpr * CPL;               // dh padded to the lanes (WIDE: a chunk)
  const int cb = ch * dhp;                       // the chunk's first column

  extern __shared__ float smem[];
  float* q_s = smem;                             // [K, dhp], 0 past dh (WIDE: the chunk's)
  float* red = q_s + K * dhp;                    // [W, K, dhp] warp accumulators
  float* ml = red + W * K * dhp;                 // [W, K, 2] warp (m, l)

  const long long row0 = (static_cast<long long>(s) * a.H + h) * a.K + j0;
  const float* qg = a.q + row0 * dh;
  for (int i = threadIdx.x; i < K * dhp; i += 32 * W) {
    const int j = i / dhp, d = i - j * dhp;
    q_s[i] = cb + d < dh ? qg[j * dh + cb + d] : 0.f;
  }
  int qp[KQ];
#pragma unroll
  for (int j = 0; j < KQ; ++j) qp[j] = a.qpos[static_cast<long long>(s) * a.K + j0 + min(j, K - 1)];
  const int last = a.qpos[static_cast<long long>(s) * a.K + j0 + K - 1];   // the group's newest
  const int n_kb = min(last / bs + 1, a.NB);
  const int n_items = warp < n_kb ? (n_kb - warp + W - 1) / W * nstep : 0;
  const int* table = a.tables + static_cast<long long>(s) * a.NB;
  const S* kc = static_cast<const S*>(a.kc);
  const S* vc = static_cast<const S*>(a.vc);
  const bool quant = a.ks != nullptr;

  // the load cursor: this warp's paged block l_kbl (logical W l_kbl + warp)
  // and row step l_step; lane i of the warp holds the table entry of its
  // blocks 32 r + i for the current round r
  int l_kbl = 0, l_step = 0, tab = 0;
  long long phys = 0;
  auto load = [&](Row& r) {
    if (l_step == 0) {
      if ((l_kbl & 31) == 0) {
        const int kb = warp + W * (l_kbl + lane);
        tab = kb < n_kb ? table[kb] : 0;
      }
      phys = __shfl_sync(kFull, tab, l_kbl & 31);
    }
    const int row = rg + l_step * rpw;
    const bool valid = row < bs && (warp + W * l_kbl) * bs + row <= last;
    const long long koff = phys * a.k_sb + h * a.k_sh + row * a.k_sr;
    const S* kr = kc + koff;
    const S* vr = vc + phys * a.v_sb + h * a.v_sh + row * a.v_sr;
    r.at.set(koff);
#pragma unroll
    for (int u = 0; u < NCU; ++u) {
      const int c0 = cb + (cl + u * lpr) * CPL;
      const bool on = valid && c0 < dh;
      if (a.vec) {
        r.k[u].v = on ? __ldg(reinterpret_cast<const V*>(kr + c0)) : V{};
        r.v[u].v = on ? __ldg(reinterpret_cast<const V*>(vr + c0)) : V{};
      } else {
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          const bool in = on && c0 + e < dh;
          r.k[u].e[e] = in ? kr[c0 + e] : S(0);
          r.v[u].e[e] = in ? vr[c0 + e] : S(0);
        }
      }
    }
    if (quant) {
      r.ks = valid ? a.ks[phys * a.ks_sb + h * a.ks_sh + row * a.ks_sr] : 0.f;
      r.vs = valid ? a.vs[phys * a.vs_sb + h * a.vs_sh + row * a.vs_sr] : 0.f;
    }
    if (++l_step == nstep) {
      l_step = 0;
      ++l_kbl;
    }
  };

  // this lane group's online softmax over the rows it has folded in; the
  // lane holds output columns (cl + u lpr) CPL + e
  float m[KQ], l[KQ], acc[KQ][NC];
#pragma unroll
  for (int j = 0; j < KQ; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[j][c] = 0.f;
  }
  // WIDE: query j's dot with the row's K columns outside this block's chunk,
  // read from the pool and q from device memory (0 past dh)
  auto other_dot = [&](const Row& r, int j) {
    const S* kr = kc + r.at.get();
    const float* qr = qg + j * dh;
    float dot = 0.f;
    for (int x = 0; x < a.nch; ++x) {
      if (x == ch) continue;
#pragma unroll
      for (int u = 0; u < NCU; ++u) {
        const int c0 = x * dhp + (cl + u * lpr) * CPL;
        if (c0 >= dh) continue;
        Chunk kk;
        if (a.vec) {
          kk.v = __ldg(reinterpret_cast<const V*>(kr + c0));
        } else {
#pragma unroll
          for (int e = 0; e < CPL; ++e) kk.e[e] = c0 + e < dh ? kr[c0 + e] : S(0);
        }
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          if (c0 + e < dh) {
            const float kf = quant ? D::f(kk.e[e]) * r.ks : D::f(kk.e[e]);
            dot = fmaf(__ldg(qr + c0 + e), kf, dot);
          }
        }
      }
    }
    return dot;
  };

  int c_kbl = 0, c_step = 0;
  auto fold = [&](const Row& r) {
    const int row = rg + c_step * rpw;
    const int pos = (warp + W * c_kbl) * bs + row;
    const bool valid = row < bs && pos <= last;
    float kf[NC], vf[NC];
#pragma unroll
    for (int u = 0; u < NCU; ++u) {
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        kf[u * CPL + e] = D::f(r.k[u].e[e]);
        vf[u * CPL + e] = D::f(r.v[u].e[e]);
        if (quant) {
          kf[u * CPL + e] *= r.ks;
          vf[u * CPL + e] *= r.vs;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
      if (j >= K) break;
      float dot = 0.f;
#pragma unroll
      for (int u = 0; u < NCU; ++u) {
        const float* qq = q_s + j * dhp + (cl + u * lpr) * CPL;
#pragma unroll
        for (int e = 0; e < CPL; ++e) dot = fmaf(qq[e], kf[u * CPL + e], dot);
      }
      if constexpr (WIDE) {
        if (valid) dot += other_dot(r, j);       // valid is one per warp (32 lanes a row)
      }
      for (int o = 1; o < lpr; o <<= 1) dot += __shfl_xor_sync(kFull, dot, o);
      if (valid && pos <= qp[j]) {               // a masked row stays out
        const float sc = dot * a.scale;
        const float mn = fmaxf(m[j], sc);
        const float corr = expf(m[j] - mn);
        const float p = expf(sc - mn);
        l[j] = l[j] * corr + p;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[j][c] = fmaf(p, vf[c], acc[j][c] * corr);
        m[j] = mn;
      }
    }
    if (++c_step == nstep) {
      c_step = 0;
      ++c_kbl;
    }
  };

  Row ring[PD];
#pragma unroll
  for (int u = 0; u < PD; ++u)
    if (u < n_items) load(ring[u]);
  __syncthreads();                               // q_s is written
  for (int i0 = 0; i0 < n_items; i0 += PD) {
#pragma unroll
    for (int u = 0; u < PD; ++u) {
      if (i0 + u < n_items) fold(ring[u]);
      if (i0 + u + PD < n_items) load(ring[u]);  // PD rows ahead
    }
  }

  // merge the warp's lane groups (same columns, other rows) pairwise
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
      if (j >= K) break;
      const float mo = __shfl_xor_sync(kFull, m[j], o);
      const float lo = __shfl_xor_sync(kFull, l[j], o);
      const float mn = fmaxf(m[j], mo);
      const float wa = l[j] > 0.f ? expf(m[j] - mn) : 0.f;
      const float wb = lo > 0.f ? expf(mo - mn) : 0.f;
      l[j] = l[j] * wa + lo * wb;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[j][c] = acc[j][c] * wa + __shfl_xor_sync(kFull, acc[j][c], o) * wb;
      }
      m[j] = mn;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
      if (j >= K) break;
      float* rj = red + (warp * K + j) * dhp;
#pragma unroll
      for (int u = 0; u < NCU; ++u)
#pragma unroll
        for (int e = 0; e < CPL; ++e) rj[(cl + u * lpr) * CPL + e] = acc[j][u * CPL + e];
      if (lane == 0) {
        ml[(warp * K + j) * 2] = m[j];
        ml[(warp * K + j) * 2 + 1] = l[j];
      }
    }
  }
  __syncthreads();

  // merge the warps, in warp order, into the chunk's ncol columns
  const int ncol = WIDE ? min(dhp, dh - cb) : dh;
  float* og = a.out + row0 * dh + cb;
  for (int i = threadIdx.x; i < K * ncol; i += 32 * W) {
    const int j = i / ncol, d = i - j * ncol;
    float mx = kNegInf;
    for (int w = 0; w < W; ++w) {
      if (ml[(w * K + j) * 2 + 1] > 0.f) mx = fmaxf(mx, ml[(w * K + j) * 2]);
    }
    float num = 0.f, den = 0.f;
    for (int w = 0; w < W; ++w) {
      const float lw = ml[(w * K + j) * 2 + 1];
      if (lw > 0.f) {
        const float e = expf(ml[(w * K + j) * 2] - mx);
        num = fmaf(red[(w * K + j) * dhp + d], e, num);
        den = fmaf(lw, e, den);
      }
    }
    og[j * dh + d] = num / fmaxf(den, 1e-30f);
  }
}

template <class D, int KQ, int NCU, bool WIDE>
cudaError_t launch_kq(const Args& a, cudaStream_t stream) {
  constexpr int W = warps_for(KQ);
  constexpr int CPL = sizeof(typename D::V) / sizeof(typename D::S);
  const size_t dhp = static_cast<size_t>(NCU) * a.lpr * CPL;
  const size_t smem = (a.KG * dhp * (1 + W) + 2 * W * static_cast<size_t>(a.KG)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<D, KQ, NCU, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long groups = static_cast<long long>((a.K + a.KG - 1) / a.KG) * a.nch;
  if (groups > 65535) return cudaErrorInvalidValue;   // the grid's z axis
  const dim3 grid(a.S, a.H, static_cast<unsigned>(groups));
  paged_attn_kernel<D, KQ, NCU, WIDE><<<grid, 32 * W, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class D, int NCU, bool WIDE>
cudaError_t launch_ncu(const Args& a, cudaStream_t stream) {
  if (a.KG == 1) return launch_kq<D, 1, NCU, WIDE>(a, stream);
  if (a.KG <= 4) return launch_kq<D, 4, NCU, WIDE>(a, stream);
  return launch_kq<D, kGroupQueries, NCU, WIDE>(a, stream);
}

bool aligned(const void* p, long long stride_elems[3], size_t elem, size_t chunk) {
  if (reinterpret_cast<uintptr_t>(p) % chunk != 0) return false;
  for (int i = 0; i < 3; ++i) {
    if ((stride_elems[i] * static_cast<long long>(elem)) % static_cast<long long>(chunk) != 0)
      return false;
  }
  return true;
}

template <class D>
cudaError_t launch(Args a, cudaStream_t stream) {
  using S = typename D::S;
  using V = typename D::V;
  constexpr int CPL = sizeof(V) / sizeof(S);
  const int cpr = (a.dh + CPL - 1) / CPL;        // loads a row takes
  a.lpr = 1;
  a.lpr_log2 = 0;
  while (a.lpr < cpr && a.lpr < 32) {
    a.lpr <<= 1;
    ++a.lpr_log2;
  }
  long long ks[3] = {a.k_sb, a.k_sh, a.k_sr}, vs[3] = {a.v_sb, a.v_sh, a.v_sr};
  a.vec = a.dh % CPL == 0 && aligned(a.kc, ks, sizeof(S), sizeof(V)) &&
          aligned(a.vc, vs, sizeof(S), sizeof(V));
  if (cpr <= a.lpr) return launch_ncu<D, 1, false>(a, stream);
  if constexpr (CPL == 4) {
    // f32 at 128 < dh <= 256: two loads a lane per row
    if (cpr <= 64) return launch_ncu<D, 2, false>(a, stream);
  }
  // dh > 256: chunks of 256 columns, 8 a lane (two f32 loads, one narrower)
  constexpr int kNcu = CPL == 4 ? 2 : 1;
  a.nch = (cpr + 32 * kNcu - 1) / (32 * kNcu);
  return launch_ncu<D, kNcu, true>(a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 int8, 3 float8_e4m3fn, 4 float8_e5m2.
// strides: k_sb, k_sh, k_sr, v_sb, v_sh, v_sr, ks_sb, ks_sh, ks_sr,
// vs_sb, vs_sh, vs_sr (elements). Any K (in groups of 8 along the grid's
// third axis), any dh >= 1. Returns the launch's cudaError_t.
int sdml_paged_attention(const float* q, const void* kc, const void* vc,
                         const float* ks, const float* vs, const int* tables,
                         const int* qpos, float* out, int S, int H, int K,
                         int dh, int bs, int NB, const long long* strides,
                         int dtype, void* stream) {
  if (S < 1 || H < 1 || H > 65535 || K < 1 ||
      (K + kGroupQueries - 1) / kGroupQueries > 65535 || dh < 1 || bs < 1 || NB < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, kc, vc, ks, vs, tables, qpos, out, S, H, K, dh, bs, NB,
         K < kGroupQueries ? K : kGroupQueries, 1, 0, 0, 1,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
         1.0f / sqrtf(static_cast<float>(dh))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<F32>(a, st); break;
    case 1: err = launch<BF16>(a, st); break;
    case 2: err = launch<I8>(a, st); break;
    case 3: err = launch<E4M3>(a, st); break;
    case 4: err = launch<E5M2>(a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* sdml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
