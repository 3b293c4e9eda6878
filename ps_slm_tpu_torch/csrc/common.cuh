// Helpers shared by the port's kernels: dtype conversion and the C-side
// error report.  Each kernel library includes this header and is built on
// its own (one nvcc per source), so nothing here needs external linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ps {

// dtype codes passed from Python (ps_slm_tpu_torch/_build.py::DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum over the block; every thread gets the total.  `red` holds >= 32
// floats of shared memory and may be reused right after the call.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();
  return total;
}

// Two sums over the block in one reduction (one set of barriers); every
// thread gets both totals.  `red` holds >= 32 float2 of shared memory.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* red) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : make_float2(0.f, 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float2 total = red[0];
  __syncthreads();
  return total;
}

}  // namespace ps

extern "C" const char* ps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
