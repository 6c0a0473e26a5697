// The kernel linter's grid fixture for Hopper (sm_90a): o = cast(cast(x,
// scratch) * 2) through a scratch of f32 or f16, one grid cell per row.
//
// Replaces simple_distributed_machine_learning_tpu/analysis/fixtures.py::
// _grid_kernel_report's `kern`, the Pallas TPU kernel the JAX linter traces
// for its write-race and scratch-dtype fixtures.
//
// What it computes, for each grid cell i (one thread block each) of R rows
// of C columns:
//   scratch[c] = S(x[i, c]) * S(2)     in the scratch type S (f32 or f16)
//   out[out_row[i], c] = float(scratch[c])
// out_row is an int32 device array the wrapper evaluates from the same
// LaunchSpec index map that the linter checks: the clean map gives i, the
// racing one 0 for every cell. So the race the linter reports is the race
// the card runs: every cell of the racing launch writes row 0, concurrently
// and in no order, and the rows no cell maps to keep what the wrapper
// filled them with (NaN).
//
// What bounds it: the fixture moves 4 x 128 f32 in and out (4 KB), ~1.2 ns
// at 3.35 TB/s, far below one launch; the launch itself is the time. So
// the design is plain: a thread per column, the scratch row in shared
// memory, no TMA, no tensor cores.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

struct F32 {
  using S = float;
  static __device__ __forceinline__ S from(float x) { return x; }
  static __device__ __forceinline__ S twice(S x) { return x * 2.0f; }
  static __device__ __forceinline__ float to(S x) { return x; }
};
struct F16 {
  using S = __half;
  static __device__ __forceinline__ S from(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ S twice(S x) {
    return __hmul(x, __float2half_rn(2.0f));
  }
  static __device__ __forceinline__ float to(S x) { return __half2float(x); }
};

template <typename T>
__global__ void grid_scratch_kernel(const float* __restrict__ x,
                                    float* __restrict__ out,
                                    const int* __restrict__ out_row, int C) {
  extern __shared__ unsigned char smem[];
  typename T::S* scratch = reinterpret_cast<typename T::S*>(smem);
  const int i = blockIdx.x;
  const float* xi = x + static_cast<long long>(i) * C;
  float* oi = out + static_cast<long long>(out_row[i]) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    scratch[c] = T::twice(T::from(xi[c]));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    oi[c] = T::to(scratch[c]);
  }
}

template <typename T>
cudaError_t launch(const float* x, float* out, const int* out_row, int R,
                   int C, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(C) * sizeof(typename T::S);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int threads = C < 128 ? ((C + 31) / 32) * 32 : 128;
  grid_scratch_kernel<T><<<R, threads, smem, st>>>(x, out, out_row, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch: 0 float32, 1 float16. x [R, C] and out [rows_out, C] f32,
// contiguous; out_row [R] int32, each in [0, rows_out). Returns the
// launch's cudaError_t.
int sdml_grid_scratch(const float* x, float* out, const int* out_row, int R,
                      int C, int scratch, void* stream) {
  if (R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (scratch) {
    case 0: err = launch<F32>(x, out, out_row, R, C, st); break;
    case 1: err = launch<F16>(x, out, out_row, R, C, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* sdml_grid_scratch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
