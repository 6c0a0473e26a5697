// Paged attention for Hopper (sm_90a): block-table gather + position-masked
// online-softmax attention in one pass, with int8/fp8 dequantisation fused.
//
// Replaces simple_distributed_machine_learning_tpu/ops/paged_attention.py::
// _paged_attn_kernel, the Pallas TPU kernel of the serving decode tick and
// of the speculative verify step.
//
// What it computes, for each slot s, head h and group g of at most 8 of the
// slot's K queries:
//   for the logical blocks kb = 0 .. qpos[s, last query of g] / bs
//   (clamped to NB):
//     phys = tables[s, kb]                 (read here; no scalar prefetch)
//     K/V rows of that block for head h, times the per-row f32 scales
//     when the pool is quantised
//     for each query j of the group: f32 scores * 1/sqrt(dh), masked to
//     kpos <= qpos[s, j], folded into an online softmax (m, l, acc) in f32
//   out[s, h, j, :] = acc / max(l, 1e-30)   (f32), for the group's rows j
// The TPU kernel's sequential k-block grid axis becomes parallel warps
// (and, past dh 128, parallel blocks) here, and its past-the-end clamp
// min(kb, last) their loop bound. Its packed layout and 128-lane l/m
// scratch were TPU tiling workarounds: not needed.
//
// What bounds it: the decode tick does ~2 flops per K/V byte it reads, far
// below the card's ~295 ops per byte, so its bound is the bytes of the K/V
// rows up to each slot's position, read once: ~4 MB at the serving shapes
// (8 slots, 8 heads, dh 64, f32), ~1 us at 3.35 TB/s. That is less than one
// memory round trip per row a serial walk would take, so what sets the time
// is how many loads are in flight, not how many bytes they carry.
//
// Two designs, chosen by head dim.
//
// Up to dh 128, paged_attn_kernel (one block per slot, head and query
// group; grid S x H x groups):
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
//
// Past dh 128, paged_attn_wide_kernel. Holding a row across one warp's
// lanes stops paying there: a row spans all 32 lanes, so each row's score
// is a serial shuffle tree, and the register ring holds one or two rows.
// So a wide block stages whole slabs in shared memory and works on a slab
// at a time:
// - The grid is (S x P) x H x groups, the P blocks of a (slot, head,
//   group) one thread-block cluster. P (1, 2, 4 or 8, the host's
//   key_parts) comes from H and NB alone: enough blocks per slot to cover
//   the card's 132 SMs, and a divisor of NB. It never depends on S or on
//   the other slots, so a slot's arithmetic is the same alone or in a
//   batch. Part p takes the slot's logical blocks [n p / P, n (p + 1) / P)
//   of its n = min(last / bs + 1, NB) live ones: one long request fills
//   the card as a batch does.
// - A block keeps all dh columns: q and the f32 accumulators in shared
//   memory, the output columns split over its 8 compute warps. So every
//   K/V byte is read once, at any head dim.
// - A ninth warp produces: it brings the part's [bs, dh] slabs of head h
//   in stages of R rows (R <= bs and <= 32, about 32 KB of K and V a
//   stage) into a ring of 2 stages, one lane issuing a bulk copy (1-D
//   TMA) for K, V and the scales, completing on the stage's `full`
//   mbarrier, and refills a stage once the compute warps have arrived on
//   its `empty` one. A view whose rows or strides are not 16-byte aligned
//   is copied element by element by the producer's lanes instead.
// - Per stage the compute warps take its rows, a warp's lanes splitting
//   the columns, and reduce the rows x queries partial scores together
//   (halving what a lane holds at each shuffle); after one named barrier
//   every warp folds each query's scores into its own copy of the online
//   softmax (one redux max, the exponents, the rescale factor; l kept per
//   lane and summed once at the end); then each thread rescales its
//   columns' accumulators once and adds p . V over the stage's rows. For
//   a quantised pool the K scale multiplies the score and the V scale p;
//   int8 converts by the exponent trick.
// - The P states merge once, through distributed shared memory: each
//   block writes its (m, l) into every block of the cluster, then after a
//   cluster barrier block p weighs the parts (a part that saw no live row
//   gets weight 0) and makes the output columns [p cw, (p + 1) cw), cw =
//   ceil(dh / P), from every block's accumulators in rank order; a second
//   barrier keeps every block's shared memory alive until the others have
//   read it.
// The block table entries are read once per warp (narrow; a lane per
// entry, handed round by shuffles) or once per block into shared memory
// (wide), qpos once per thread.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

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
  long long k_sb, k_sh, k_sr, v_sb, v_sh, v_sr;        // element strides
  long long ks_sb, ks_sh, ks_sr, vs_sb, vs_sh, vs_sr;
  float scale;
  int parts;           // wide: blocks a (slot, head, group) splits its table over
  int rows;            // wide: rows a stage holds
  int ntab;            // wide: table entries a block keeps in shared memory
  int sbulk;           // wide: the scales come by bulk copies too
};

template <class D, int KQ, int NCU>
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
  };

  const int s = blockIdx.x, h = blockIdx.y;
  const int j0 = blockIdx.z * a.KG;              // the group's first query
  const int K = min(a.KG, a.K - j0);             // queries of this group
  const int dh = a.dh, bs = a.bs, lpr = a.lpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> a.lpr_log2, cl = lane & (lpr - 1);
  const int rpw = 32 >> a.lpr_log2;              // rows a warp load covers
  const int nstep = (bs + rpw - 1) / rpw;        // loads per paged block
  const int dhp = NCU * lpr * CPL;               // dh padded to the lanes

  extern __shared__ float smem[];
  float* q_s = smem;                             // [K, dhp], 0 past dh
  float* red = q_s + K * dhp;                    // [W, K, dhp] warp accumulators
  float* ml = red + W * K * dhp;                 // [W, K, 2] warp (m, l)

  const long long row0 = (static_cast<long long>(s) * a.H + h) * a.K + j0;
  const float* qg = a.q + row0 * dh;
  for (int i = threadIdx.x; i < K * dhp; i += 32 * W) {
    const int j = i / dhp, d = i - j * dhp;
    q_s[i] = d < dh ? qg[j * dh + d] : 0.f;
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
    const S* kr = kc + phys * a.k_sb + h * a.k_sh + row * a.k_sr;
    const S* vr = vc + phys * a.v_sb + h * a.v_sh + row * a.v_sr;
#pragma unroll
    for (int u = 0; u < NCU; ++u) {
      const int c0 = (cl + u * lpr) * CPL;
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

  // merge the warps, in warp order
  float* og = a.out + row0 * dh;
  for (int i = threadIdx.x; i < K * dh; i += 32 * W) {
    const int j = i / dh, d = i - j * dh;
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
    og[i] = num / fmaxf(den, 1e-30f);
  }
}

template <class D, int KQ, int NCU>
cudaError_t launch_kq(const Args& a, cudaStream_t stream) {
  constexpr int W = warps_for(KQ);
  constexpr int CPL = sizeof(typename D::V) / sizeof(typename D::S);
  const size_t dhp = static_cast<size_t>(NCU) * a.lpr * CPL;
  const size_t smem = (a.KG * dhp * (1 + W) + 2 * W * static_cast<size_t>(a.KG)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<D, KQ, NCU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int groups = (a.K + a.KG - 1) / a.KG;
  paged_attn_kernel<D, KQ, NCU><<<dim3(a.S, a.H, groups), 32 * W, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class D, int NCU>
cudaError_t launch_ncu(const Args& a, cudaStream_t stream) {
  if (a.KG == 1) return launch_kq<D, 1, NCU>(a, stream);
  if (a.KG <= 4) return launch_kq<D, 4, NCU>(a, stream);
  return launch_kq<D, kGroupQueries, NCU>(a, stream);
}

bool aligned(const void* p, long long stride_elems[3], size_t elem, size_t chunk) {
  if (reinterpret_cast<uintptr_t>(p) % chunk != 0) return false;
  for (int i = 0; i < 3; ++i) {
    if ((stride_elems[i] * static_cast<long long>(elem)) % static_cast<long long>(chunk) != 0)
      return false;
  }
  return true;
}


// -- past dh 128: the wide kernel -------------------------------------------

constexpr int kNarrowHeadDim = 128;     // the kernel above up to here, then the wide one
constexpr int kWideWarps = 8;           // compute warps
constexpr int kWideCompute = 32 * kWideWarps;
constexpr int kWideThreads = kWideCompute + 32;   // and one producer warp
constexpr int kWideStages = 2;          // stages of the shared ring
constexpr int kWideRows = 32;           // rows a stage holds at most: a warp's lanes
constexpr int kWideStageBytes = 32768;  // K and V bytes a stage aims at
constexpr int kWideMaxParts = 8;        // a thread-block cluster's portable size
constexpr int kWideTable = 1024;        // a part's table entries kept in shared memory

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// byte offsets into a wide block's shared memory, for kq queries, stages
// of `rows` rows, and ntab table entries
struct WideSmem {
  int k, v, ks, vs, q, acc, sc, pw, ml, bar, tab, total;
};
__host__ __device__ inline WideSmem wide_smem(int kq, int dh, int rows, int elem, int ntab) {
  WideSmem w;
  const int stage = round16(rows * dh * elem);
  w.k = 0;                                       // [stages][rows][dh] stored K
  w.v = w.k + kWideStages * stage;               // and V
  w.ks = w.v + kWideStages * stage;              // [stages][32] f32 K scales
  w.vs = w.ks + kWideStages * kWideRows * 4;     // and V scales
  w.q = w.vs + kWideStages * kWideRows * 4;      // [kq][dh] f32 queries
  w.acc = w.q + round16(kq * dh * 4);            // [kq][dh] f32 accumulators
  w.sc = w.acc + round16(kq * dh * 4);           // [2][kq][32] a stage's scores
  w.pw = w.sc + 2 * kq * kWideRows * 4;          // [warps][kq][32] each warp's p
  w.ml = w.pw + kWideWarps * kq * kWideRows * 4; // [parts][2][kq] each part's (m, l)
  w.bar = w.ml + round16(kWideMaxParts * 2 * kq * 4);  // [2][stages] full, empty mbarriers
  w.tab = w.bar + round16(2 * kWideStages * 8);  // [ntab] the part's table entries
  w.total = w.tab + round16(ntab * 4);
  return w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// the issuing thread's arrival, with the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one bulk copy (1-D TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a stored element's f32 value in the wide kernel: D::f, but int8 by the
// exponent trick (2^23 + 128 + x is exact in f32), two full-rate ALU ops
// where the convert unit runs at a quarter of the rate
template <class D>
__device__ __forceinline__ float wide_f(typename D::S x) { return D::f(x); }
template <>
__device__ __forceinline__ float wide_f<I8>(uint8_t x) {
  return __int_as_float(0x4B000000 | (x ^ 0x80)) - 8388736.f;
}

// the warp sum of each of a lane's N values, halving what a lane holds at
// each shuffle step (offset O, H + H values to H): a lane ends with one
// sum in d[0], of value lane >> (5 - log2 N) (N <= 32, a power of two)
template <int O, int H, int N>
__device__ __forceinline__ void halve(float (&d)[N], int lane) {
  if constexpr (O > 0) {
    const bool up = lane & O;
    if constexpr (H >= 1) {
#pragma unroll
      for (int v = 0; v < H; ++v) {
        const float send = up ? d[v] : d[v + H];
        const float keep = up ? d[v + H] : d[v];
        d[v] = keep + __shfl_xor_sync(kFull, send, O);
      }
      halve<O / 2, H / 2>(d, lane);
    } else {
      d[0] += __shfl_xor_sync(kFull, d[0], O);
      halve<O / 2, 0>(d, lane);
    }
  }
}

// the warp's max of v: one redux on an order-keeping int image of the float
__device__ __forceinline__ float warp_max(float v) {
  const int i = __float_as_int(v);
  const int key = __reduce_max_sync(kFull, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// four stored elements as one load
template <int B> struct Load4;
template <> struct Load4<4> { using T = uint32_t; };
template <> struct Load4<8> { using T = uint2; };
template <> struct Load4<16> { using T = uint4; };

template <class D, int KQ>
__global__ void __launch_bounds__(kWideThreads, 1) paged_attn_wide_kernel(Args a) {
  using S = typename D::S;
  constexpr int ES = sizeof(S);                  // bytes a stored element
  using L4 = typename Load4<4 * ES>::T;
  union Quad {
    L4 v;
    S e[4];
  };
  cg::cluster_group cluster = cg::this_cluster();
  const int P = a.parts;
  const int part = blockIdx.x % P, s = blockIdx.x / P, h = blockIdx.y;
  const int j0 = blockIdx.z * a.KG;              // the group's first query
  const int K = min(a.KG, a.K - j0);             // queries of this group
  const int dh = a.dh, bs = a.bs, R = a.rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool quant = a.ks != nullptr;

  extern __shared__ __align__(16) unsigned char wsm[];
  const WideSmem L = wide_smem(KQ, dh, R, ES, a.ntab);
  S* k_ring = reinterpret_cast<S*>(wsm + L.k);
  S* v_ring = reinterpret_cast<S*>(wsm + L.v);
  float* ks_ring = reinterpret_cast<float*>(wsm + L.ks);
  float* vs_ring = reinterpret_cast<float*>(wsm + L.vs);
  float* q_s = reinterpret_cast<float*>(wsm + L.q);
  float* acc_s = reinterpret_cast<float*>(wsm + L.acc);
  float* sc_s = reinterpret_cast<float*>(wsm + L.sc);
  float* pw = reinterpret_cast<float*>(wsm + L.pw) + warp * KQ * kWideRows;  // this warp's p
  float* ml_s = reinterpret_cast<float*>(wsm + L.ml);
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + L.bar);   // a stage has landed
  uint64_t* empty = full + kWideStages;          // the compute warps are done with it
  int* tab_s = reinterpret_cast<int*>(wsm + L.tab);
  const int stage_elems = round16(R * dh * ES) / ES;

  // this part's logical blocks [lo, hi) of the slot's n_kb live ones, cut
  // in stages of R rows (nsub a paged block); the last block's rows stop
  // at the group's newest position
  const int* qrow = a.qpos + static_cast<long long>(s) * a.K + j0;
  const int* table = a.tables + static_cast<long long>(s) * a.NB;
  // the slot's table row on its way to L2 while qpos, which picks this
  // part's entries, is read
  if (tid * 32 < a.NB) asm volatile("prefetch.global.L2 [%0];" ::"l"(table + tid * 32));
  int qp[KQ];
#pragma unroll
  for (int j = 0; j < KQ; ++j) qp[j] = qrow[min(j, K - 1)];
  const int last = qp[KQ - 1];                   // the group's newest position
  const int n_kb = min(last / bs + 1, a.NB);
  const int lo = n_kb * part / P, hi = n_kb * (part + 1) / P;
  const int nsub = (bs + R - 1) / R;
  const int n_items =
      hi > lo ? (hi - 1 - lo) * nsub + (min(bs, last + 1 - (hi - 1) * bs) + R - 1) / R : 0;
  for (int i = tid; i < min(hi - lo, a.ntab); i += kWideThreads) tab_s[i] = table[lo + i];

  const long long row0 = (static_cast<long long>(s) * a.H + h) * a.K + j0;
  const float* qg = a.q + row0 * dh;
  for (int i = tid; i < KQ * dh; i += kWideThreads) {
    q_s[i] = i < K * dh ? qg[i] : 0.f;           // a query past the group's: 0
    acc_s[i] = 0.f;
  }
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kWideStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kWideWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this block has started: its shared memory may take the others' (m, l)
  // once every block has said so (the wait, before the first remote write)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const S* kc = static_cast<const S*>(a.kc);
  const S* vc = static_cast<const S*>(a.vc);
  // the producer warp: item i's K and V (and the scales of a quantised
  // pool) into stage i % kWideStages once the compute warps have freed it,
  // by bulk copies from one lane completing on the stage's `full` mbarrier
  // where rows and scales allow, else element by element by its lanes
  if (warp == kWideWarps) {
    for (int i = 0; i < n_items; ++i) {
      const int st = i % kWideStages;
      if (i >= kWideStages) mbar_wait(empty + st, ((i / kWideStages) - 1) & 1);
      const int kb = lo + i / nsub, r0 = (i % nsub) * R;
      const int n = min(min(R, bs - r0), last + 1 - (kb * bs + r0));
      const long long phys = kb - lo < a.ntab ? tab_s[kb - lo] : table[kb];
      const S* ksrc = kc + phys * a.k_sb + h * a.k_sh + r0 * a.k_sr;
      const S* vsrc = vc + phys * a.v_sb + h * a.v_sh + r0 * a.v_sr;
      const float* kss = quant ? a.ks + phys * a.ks_sb + h * a.ks_sh + r0 * a.ks_sr : nullptr;
      const float* vss = quant ? a.vs + phys * a.vs_sb + h * a.vs_sh + r0 * a.vs_sr : nullptr;
      S* kdst = k_ring + st * stage_elems;
      S* vdst = v_ring + st * stage_elems;
      if (!a.vec) {
        for (int x = lane; x < n * dh; x += 32) {
          const int r = x / dh, c = x - r * dh;
          kdst[x] = ksrc[r * a.k_sr + c];
          vdst[x] = vsrc[r * a.v_sr + c];
        }
      }
      if (quant && !(a.vec && a.sbulk) && lane < n) {
        ks_ring[st * kWideRows + lane] = kss[lane * a.ks_sr];
        vs_ring[st * kWideRows + lane] = vss[lane * a.vs_sr];
      }
      __syncwarp();
      if (lane == 0) {
        if (a.vec) {
          // the n rows are one contiguous run; scales in whole 16-byte
          // groups of 4 rows, inside the block's bs (a multiple of 4)
          const uint32_t bytes = n * dh * ES;
          const uint32_t sbytes = a.sbulk ? ((n + 3) & ~3) * 4 : 0;
          mbar_expect(full + st, 2 * bytes + 2 * sbytes);
          bulk_copy(kdst, ksrc, bytes, full + st);
          bulk_copy(vdst, vsrc, bytes, full + st);
          if (sbytes) {
            bulk_copy(ks_ring + st * kWideRows, kss, sbytes, full + st);
            bulk_copy(vs_ring + st * kWideRows, vss, sbytes, full + st);
          }
        } else {
          mbar_arrive(full + st);
        }
      }
    }
  }

  // the online softmax state, the same in every compute warp (each folds
  // the same scores in the same order): m, and l as each lane's share (its
  // rows' p, rescaled as m moves), summed over the lanes once at the end
  float m[KQ], l[KQ];
#pragma unroll
  for (int j = 0; j < KQ; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
  }

  for (int i = 0; warp < kWideWarps && i < n_items; ++i) {
    const int st = i % kWideStages;
    mbar_wait(full + st, (i / kWideStages) & 1);   // item i has landed
    const int kb = lo + i / nsub, r0 = (i % nsub) * R;
    const int pos0 = kb * bs + r0;               // the stage's first key position
    const int n = min(min(R, bs - r0), last + 1 - pos0);
    const S* kst = k_ring + st * stage_elems;
    const S* vst = v_ring + st * stage_elems;
    float* sc = sc_s + (i & 1) * KQ * kWideRows;   // this item's scores

    // scores: warp w takes rows w, w + 8, w + 16, w + 24; its lanes split
    // the columns, 4 neighbouring ones a lane where rows allow (K and q read
    // without bank conflicts). The warp's rows x queries partial sums then
    // reduce together, each shuffle step sending half of what a lane holds,
    // so a lane ends with one (row, query) sum, lane >> shift its index
    constexpr int RW = kWideRows / kWideWarps;   // rows a warp takes at most
    constexpr int NV = RW * KQ;                  // sums a warp reduces (<= 32)
    float dot[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) dot[v] = 0.f;
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp + rr * kWideWarps;
      if (r < n) {
        const S* kr = kst + r * dh;
        if (a.vec) {
#pragma unroll 1
          for (int c = lane * 4; c < dh; c += 128) {
            Quad k;
            k.v = *reinterpret_cast<const L4*>(kr + c);
            const float k0 = wide_f<D>(k.e[0]), k1 = wide_f<D>(k.e[1]);
            const float k2 = wide_f<D>(k.e[2]), k3 = wide_f<D>(k.e[3]);
#pragma unroll
            for (int j = 0; j < KQ; ++j) {
              const float4 qq = *reinterpret_cast<const float4*>(q_s + j * dh + c);
              float& d = dot[rr * KQ + j];
              d = fmaf(qq.x, k0, fmaf(qq.y, k1, fmaf(qq.z, k2, fmaf(qq.w, k3, d))));
            }
          }
        } else {
#pragma unroll 1
          for (int c = lane; c < dh; c += 32) {
            const float kf = wide_f<D>(kr[c]);
#pragma unroll
            for (int j = 0; j < KQ; ++j) {
              dot[rr * KQ + j] = fmaf(q_s[j * dh + c], kf, dot[rr * KQ + j]);
            }
          }
        }
      }
    }
    halve<16, NV / 2>(dot, lane);
    {
      constexpr int shift = NV == 32 ? 0 : NV == 16 ? 1 : NV == 8 ? 2 : NV == 4 ? 3 : 4;
      const int vi = lane >> shift, rr = vi / KQ, j = vi - rr * KQ;
      const int r = warp + rr * kWideWarps;
      if ((lane & ((1 << shift) - 1)) == 0 && r < n) {
        const float f = quant ? a.scale * ks_ring[st * kWideRows + r] : a.scale;
        sc[j * kWideRows + r] = dot[0] * f;
      }
    }
    // the compute warps only; sc alternates, so a warp still folding item
    // i - 1 reads the other buffer
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWideCompute) : "memory");

    // every warp folds the stage into its copy of the online softmax, once
    // a stage, a lane a row, and keeps the p it needs in its own slice
    float corr[KQ];
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
      corr[j] = 1.f;
      if (j < K) {
        const bool live = lane < n && pos0 + lane <= qp[j];   // a masked row stays out
        const float sj = live ? sc[j * kWideRows + lane] : kNegInf;
        const float m_new = fmaxf(m[j], warp_max(sj));
        const float pr = live ? expf(sj - m_new) : 0.f;
        corr[j] = expf(m[j] - m_new);
        l[j] = l[j] * corr[j] + pr;
        m[j] = m_new;
        pw[j * kWideRows + lane] = quant && lane < n ? pr * vs_ring[st * kWideRows + lane] : pr;
      } else {
        pw[j * kWideRows + lane] = 0.f;
      }
    }
    __syncwarp();

    // p . V: each thread rescales its columns once and adds the stage's rows
#pragma unroll 1
    for (int c = tid; c < dh; c += kWideCompute) {
      float o[KQ];
#pragma unroll
      for (int j = 0; j < KQ; ++j) o[j] = acc_s[j * dh + c] * corr[j];
      int r = 0;
      for (; r + 4 <= n; r += 4) {
        const float v0 = wide_f<D>(vst[r * dh + c]), v1 = wide_f<D>(vst[(r + 1) * dh + c]);
        const float v2 = wide_f<D>(vst[(r + 2) * dh + c]), v3 = wide_f<D>(vst[(r + 3) * dh + c]);
#pragma unroll
        for (int j = 0; j < KQ; ++j) {
          const float4 p4 = *reinterpret_cast<const float4*>(pw + j * kWideRows + r);
          o[j] = fmaf(p4.w, v3, fmaf(p4.z, v2, fmaf(p4.y, v1, fmaf(p4.x, v0, o[j]))));
        }
      }
      for (; r < n; ++r) {
        const float vf = wide_f<D>(vst[r * dh + c]);
#pragma unroll
        for (int j = 0; j < KQ; ++j) o[j] = fmaf(pw[j * kWideRows + r], vf, o[j]);
      }
#pragma unroll
      for (int j = 0; j < KQ; ++j) acc_s[j * dh + c] = o[j];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);      // this warp is done with the stage
  }
  __syncthreads();                               // the producer's lanes too
  // warp 0's (m, l) into every part's shared memory, at this part's place
#pragma unroll
  for (int j = 0; j < KQ; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l[j] += __shfl_xor_sync(kFull, l[j], o);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0 && lane < P) {
    float* dst = cluster.map_shared_rank(ml_s, lane) + part * 2 * KQ;
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
      dst[j] = m[j];
      dst[KQ + j] = l[j];
    }
  }

  // merge the P parts in rank order: each query's weights once, from the
  // (m, l) every part left here (a part that saw no live row weighs 0),
  // then block p makes columns [p cw, p cw + cw) from every part's
  // accumulators
  cluster.sync();
  float* wt = sc_s;                              // [KQ][kWideMaxParts], the scores are done
  if (tid < K) {
    float mp[kWideMaxParts], lp[kWideMaxParts];
    float mx = kNegInf;
#pragma unroll
    for (int x = 0; x < kWideMaxParts; ++x) {
      if (x < P) {
        mp[x] = ml_s[x * 2 * KQ + tid];
        lp[x] = ml_s[x * 2 * KQ + KQ + tid];
        if (lp[x] > 0.f) mx = fmaxf(mx, mp[x]);
      }
    }
    float den = 0.f;
#pragma unroll
    for (int x = 0; x < kWideMaxParts; ++x) {
      if (x < P) {
        mp[x] = lp[x] > 0.f ? expf(mp[x] - mx) : 0.f;
        den = fmaf(lp[x], mp[x], den);
      }
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
    for (int x = 0; x < kWideMaxParts; ++x) {
      if (x < P) wt[tid * kWideMaxParts + x] = mp[x] * inv;
    }
  }
  __syncthreads();
  const int cw = (dh + P - 1) / P;
  const int c0 = part * cw, ncol = max(0, min(dh, c0 + cw) - c0);
  float* og = a.out + row0 * dh;
  for (int e = tid; e < K * ncol; e += kWideThreads) {
    const int j = e / ncol, c = c0 + (e - j * ncol);
    float o = 0.f;
#pragma unroll
    for (int x = 0; x < kWideMaxParts; ++x) {
      if (x < P) {
        o = fmaf(cluster.map_shared_rank(acc_s, x)[j * dh + c], wt[j * kWideMaxParts + x], o);
      }
    }
    og[j * dh + c] = o;
  }
  cluster.sync();                                // the others have read this block
}

template <class D, int KQ>
cudaError_t launch_wide_kq(const Args& a, cudaStream_t stream) {
  const WideSmem L = wide_smem(KQ, a.dh, a.rows, static_cast<int>(sizeof(typename D::S)), a.ntab);
  if (L.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_wide_kernel<D, KQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.S * a.parts), a.H, (a.K + a.KG - 1) / a.KG);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.parts;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, paged_attn_wide_kernel<D, KQ>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class D>
cudaError_t launch_wide(Args a, cudaStream_t stream) {
  using S = typename D::S;
  constexpr int elem = sizeof(S);
  if (a.parts < 1 || a.parts > kWideMaxParts ||
      static_cast<long long>(a.S) * a.parts > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  // stages of about 32 KB of K and V
  a.rows = std::max(1, std::min({kWideStageBytes / (2 * a.dh * elem), kWideRows, a.bs}));
  if (a.rows >= 4) a.rows &= ~3;                 // whole 16-byte groups of scales
  a.ntab = std::min((a.NB + a.parts - 1) / a.parts, kWideTable);
  long long ks[3] = {a.k_sb, a.k_sh, a.k_sr}, vs[3] = {a.v_sb, a.v_sh, a.v_sr};
  // 16-byte copies of whole runs of rows, and 16-byte reads of them
  a.vec = (a.dh * elem) % 16 == 0 && a.k_sr == a.dh && a.v_sr == a.dh &&
          aligned(a.kc, ks, elem, 16) && aligned(a.vc, vs, elem, 16);
  long long kss[3] = {a.ks_sb, a.ks_sh, 4}, vss[3] = {a.vs_sb, a.vs_sh, 4};
  a.sbulk = a.ks != nullptr && a.ks_sr == 1 && a.vs_sr == 1 && a.bs % 4 == 0 &&
            a.rows % 4 == 0 && aligned(a.ks, kss, 4, 16) && aligned(a.vs, vss, 4, 16);
  if (a.KG == 1) return launch_wide_kq<D, 1>(a, stream);
  if (a.KG <= 4) return launch_wide_kq<D, 4>(a, stream);
  return launch_wide_kq<D, kGroupQueries>(a, stream);
}

template <class D>
cudaError_t launch(Args a, cudaStream_t stream) {
  if (a.dh > kNarrowHeadDim) return launch_wide<D>(a, stream);
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
  return launch_ncu<D, 1>(a, stream);           // dh <= 128: one load a lane per row
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 int8, 3 float8_e4m3fn, 4 float8_e5m2.
// strides: k_sb, k_sh, k_sr, v_sb, v_sh, v_sr, ks_sb, ks_sh, ks_sr,
// vs_sb, vs_sh, vs_sr (elements). Any K (in groups of 8 along the grid's
// third axis). parts: past dh 128, the blocks (1 to 8) each (slot, head,
// group) splits its table over; ignored up to 128. Any dh >= 1 whose wide
// blocks fit the card's shared memory. Returns the launch's cudaError_t.
int sdml_paged_attention(const float* q, const void* kc, const void* vc,
                         const float* ks, const float* vs, const int* tables,
                         const int* qpos, float* out, int S, int H, int K,
                         int dh, int bs, int NB, const long long* strides,
                         int dtype, int parts, void* stream) {
  if (S < 1 || H < 1 || H > 65535 || K < 1 ||
      (K + kGroupQueries - 1) / kGroupQueries > 65535 || dh < 1 || bs < 1 || NB < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, kc, vc, ks, vs, tables, qpos, out, S, H, K, dh, bs, NB,
         K < kGroupQueries ? K : kGroupQueries, 1, 0, 0,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
         1.0f / sqrtf(static_cast<float>(dh)), parts, 0, 0};
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
