// Paged attention for Hopper (sm_90a): block-table gather + position-masked
// online-softmax attention in one pass, with int8/fp8 dequantisation fused.
//
// Replaces simple_distributed_machine_learning_tpu/ops/paged_attention.py::
// _paged_attn_kernel, the Pallas TPU kernel of the serving decode tick.
//
// What it computes, for each slot s and head h (one thread block each):
//   for the logical blocks kb = 0 .. qpos[s, K-1] / bs (clamped to NB):
//     phys = tables[s, kb]                 (read here; no scalar prefetch)
//     K/V rows of that block for head h, times the per-row f32 scales
//     when the pool is quantised
//     for each of the K queries: f32 scores * 1/sqrt(dh), masked to
//     kpos <= qpos[s, j] with the finite NEG_INF, folded into the running
//     (acc, l, m) of an online softmax held in shared memory
//   out[s, h, j, :] = acc / max(l, 1e-30)   (f32)
// The TPU kernel's sequential k-block grid axis is the loop over kb here,
// and its past-the-end clamp min(kb, last) is the loop bound. Its packed
// layout and 128-lane l/m scratch were TPU tiling workarounds: not needed.
//
// What bounds it: the decode tick does ~2 flops per K/V byte it reads, far
// below the card's ~295 ops per byte, so its bound is the bytes of the K/V
// blocks up to each slot's position, read once. The design reads each of
// those rows exactly once per (slot, head), with neighbouring threads on
// neighbouring addresses, dequantises in registers on the way into shared
// memory (a quantised pool pays only its narrow bytes), and never writes a
// gathered copy or the score matrix to device memory. It does not yet use
// TMA, cp.async double buffering or wgmma: one block per (slot, head) is
// few blocks at small batch, which leaves bandwidth on the table.
// A simple kernel that is right comes first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 128;
constexpr size_t kSmemBudget = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Args {
  const float* q;      // [S, H, K, dh], contiguous
  const void* kc;      // one layer's blocks [n_blocks, H, bs, dh], dh contiguous
  const void* vc;
  const float* ks;     // [n_blocks, H, bs] dequant scales, or null
  const float* vs;
  const int* tables;   // [S, NB], contiguous
  const int* qpos;     // [S, K], contiguous, non-decreasing along K
  float* out;          // [S, H, K, dh], contiguous
  int S, H, K, dh, bs, NB, tile;
  long long k_sb, k_sh, k_sr, v_sb, v_sh, v_sr;        // element strides
  long long ks_sb, ks_sh, ks_sr, vs_sb, vs_sh, vs_sr;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(Args a) {
  const int s = blockIdx.x, h = blockIdx.y;
  const int K = a.K, dh = a.dh, tile = a.tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;               // [K, dh]
  float* acc = q_s + K * dh;       // [K, dh]
  float* k_s = acc + K * dh;       // [tile, dh]
  float* v_s = k_s + tile * dh;    // [tile, dh]
  float* p_s = v_s + tile * dh;    // [K, tile] scores, then probabilities
  float* m_s = p_s + K * tile;     // [K]
  float* l_s = m_s + K;            // [K]
  float* c_s = l_s + K;            // [K] this tile's rescale factor
  int* qp_s = reinterpret_cast<int*>(c_s + K);   // [K]

  const float* qg = a.q + (static_cast<long long>(s) * a.H + h) * K * dh;
  for (int i = tid; i < K * dh; i += kThreads) {
    q_s[i] = qg[i];
    acc[i] = 0.f;
  }
  for (int j = tid; j < K; j += kThreads) {
    m_s[j] = kNegInf;
    l_s[j] = 0.f;
    qp_s[j] = a.qpos[static_cast<long long>(s) * K + j];
  }
  __syncthreads();

  const T* kc = static_cast<const T*>(a.kc);
  const T* vc = static_cast<const T*>(a.vc);
  const int last_pos = qp_s[K - 1];
  int n_kb = last_pos / a.bs + 1;
  if (n_kb > a.NB) n_kb = a.NB;

  for (int kb = 0; kb < n_kb; ++kb) {
    const long long phys = a.tables[static_cast<long long>(s) * a.NB + kb];
    for (int r0 = 0; r0 < a.bs; r0 += tile) {
      const int base_pos = kb * a.bs + r0;
      if (base_pos > last_pos) break;   // uniform over the block
      const int rows = min(tile, a.bs - r0);

      // gather this tile's K/V rows of head h, dequantised to f32
      for (int i = tid; i < rows * dh; i += kThreads) {
        const int r = i / dh, d = i - r * dh;
        const long long row = r0 + r;
        float kv = to_f32(kc[phys * a.k_sb + h * a.k_sh + row * a.k_sr + d]);
        float vv = to_f32(vc[phys * a.v_sb + h * a.v_sh + row * a.v_sr + d]);
        if (a.ks != nullptr) {
          kv *= a.ks[phys * a.ks_sb + h * a.ks_sh + row * a.ks_sr];
          vv *= a.vs[phys * a.vs_sb + h * a.vs_sh + row * a.vs_sr];
        }
        k_s[i] = kv;
        v_s[i] = vv;
      }
      __syncthreads();

      // masked scores: one warp per (query, row) pair
      for (int pr = warp; pr < K * rows; pr += kWarps) {
        const int j = pr / rows, r = pr - j * rows;
        float dot = 0.f;
        for (int d = lane; d < dh; d += 32) dot += q_s[j * dh + d] * k_s[r * dh + d];
        dot = warp_sum(dot);
        if (lane == 0) {
          p_s[j * tile + r] = (base_pos + r <= qp_s[j]) ? dot * a.scale : kNegInf;
        }
      }
      __syncthreads();

      // online-softmax update: one warp per query
      for (int j = warp; j < K; j += kWarps) {
        float mx = kNegInf;
        for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[j * tile + r]);
        mx = warp_max(mx);
        const float m_prev = m_s[j];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int r = lane; r < rows; r += 32) {
          const float p = (base_pos + r <= qp_s[j]) ? expf(p_s[j * tile + r] - m_new) : 0.f;
          p_s[j * tile + r] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          c_s[j] = corr;
          l_s[j] = l_s[j] * corr + sum;
          m_s[j] = m_new;
        }
      }
      __syncthreads();

      for (int i = tid; i < K * dh; i += kThreads) {
        const int j = i / dh, d = i - j * dh;
        float o = acc[i] * c_s[j];
        for (int r = 0; r < rows; ++r) o += p_s[j * tile + r] * v_s[r * dh + d];
        acc[i] = o;
      }
      __syncthreads();
    }
  }

  float* og = a.out + (static_cast<long long>(s) * a.H + h) * K * dh;
  for (int i = tid; i < K * dh; i += kThreads) {
    og[i] = acc[i] / fmaxf(l_s[i / dh], 1e-30f);
  }
}

template <typename T>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  dim3 grid(a.S, a.H);
  paged_attn_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 int8, 3 float8_e4m3fn, 4 float8_e5m2.
// strides: k_sb, k_sh, k_sr, v_sb, v_sh, v_sr, ks_sb, ks_sh, ks_sr,
// vs_sb, vs_sh, vs_sr (elements). Returns the launch's cudaError_t.
int sdml_paged_attention(const float* q, const void* kc, const void* vc,
                         const float* ks, const float* vs, const int* tables,
                         const int* qpos, float* out, int S, int H, int K,
                         int dh, int bs, int NB, const long long* strides,
                         int dtype, void* stream) {
  const size_t fixed = (2 * static_cast<size_t>(K) * dh + 4 * K) * sizeof(float);
  const size_t per_row = (2 * static_cast<size_t>(dh) + K) * sizeof(float);
  if (S < 1 || H < 1 || K < 1 || dh < 1 || bs < 1 || NB < 1 || fixed + per_row > kSmemBudget) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile = static_cast<int>((kSmemBudget - fixed) / per_row);
  if (tile > bs) tile = bs;
  if (tile > kMaxTile) tile = kMaxTile;
  Args a{q, kc, vc, ks, vs, tables, qpos, out, S, H, K, dh, bs, NB, tile,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
         1.0f / sqrtf(static_cast<float>(dh))};
  const size_t smem = fixed + tile * per_row;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(a, smem, st); break;
    case 1: err = launch<__nv_bfloat16>(a, smem, st); break;
    case 2: err = launch<int8_t>(a, smem, st); break;
    case 3: err = launch<__nv_fp8_e4m3>(a, smem, st); break;
    case 4: err = launch<__nv_fp8_e5m2>(a, smem, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* sdml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
