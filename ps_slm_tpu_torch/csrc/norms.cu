// LayerNorm and RMSNorm, forward and backward, over the rows of a [N, d]
// matrix.
//
// Replaces the TPU kernels ps_slm_tpu/ops/norms.py::_ln_fwd_kernel,
// ::_rms_fwd_kernel, ::_ln_bwd_kernel and ::_rms_bwd_kernel: fp32
// statistics and accumulation, x, y and dx in the input dtype.  The forward
// kernels also write the fp32 per-row statistics (mu and rstd for
// LayerNorm, rstd for RMSNorm) that the backward kernels read.
//
// Backward, with xhat = (x - mu) * rstd (LayerNorm) or x * rstd (RMSNorm)
// and gw = g * w:
//   LayerNorm  dx = (gw - mean(gw) - xhat * mean(gw * xhat)) * rstd
//   RMSNorm    dx = (gw - xhat * mean(gw * xhat)) * rstd
//   dw = sum over rows of g * xhat, db = sum over rows of g.
// dw and db leave the kernel as per-block partial sums in an fp32
// [n_blocks, d] buffer, summed over blocks outside the kernel, as the TPU
// wrapper does.
//
// Bound: bytes.  A row is read and written once; the work is a handful of
// flops per element, far below the card's ~295 flop/byte ridge.
//
// Design: one block per row (forward) or per run of consecutive rows
// (backward), with a block-stride loop over d, so any width works (560 and
// 25 055 are not multiples of 128, which the TPU kernels required).  The
// forward statistics take two passes over the row (mean, then the centred
// variance, as the TPU kernel computes them) and the output a third; the
// backward takes one pass for the two means and one for dx.  The repeated
// reads of a row hit L1/L2, so device memory sees each row about once.  A
// thread owns the same columns in every row of its block, so it adds its
// columns' dw/db terms into the block's partial row with no race (the
// partial rows stay in L2 at the shapes of the main path).  Loads are
// scalar and coalesced; vector loads, several rows per block for narrow d
// and register-held partial sums are left for a later tuning pass.
#include "common.cuh"

namespace {

template <typename T>
__global__ void layer_norm_fwd_kernel(const T* __restrict__ x,
                                      const T* __restrict__ w,
                                      const T* __restrict__ b,
                                      T* __restrict__ y, float* __restrict__ mu,
                                      float* __restrict__ rstd, int d,
                                      float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) s += ps::to_f32(xr[i]);
  const float mean = ps::block_sum(s, red) / d;

  float s2 = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = ps::to_f32(xr[i]) - mean;
    s2 += c * c;
  }
  const float var = ps::block_sum(s2, red) / d;
  const float r = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = ps::to_f32(xr[i]) - mean;
    yr[i] = ps::from_f32<T>(c * r * ps::to_f32(w[i]) + ps::to_f32(b[i]));
  }
  if (threadIdx.x == 0) {
    mu[row] = mean;
    rstd[row] = r;
  }
}

template <typename T>
__global__ void rms_norm_fwd_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    T* __restrict__ y, float* __restrict__ rstd,
                                    int d, float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float s2 = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = ps::to_f32(xr[i]);
    s2 += v * v;
  }
  const float r = rsqrtf(ps::block_sum(s2, red) / d + eps);

  for (int i = threadIdx.x; i < d; i += blockDim.x)
    yr[i] = ps::from_f32<T>(ps::to_f32(xr[i]) * r * ps::to_f32(w[i]));
  if (threadIdx.x == 0) rstd[row] = r;
}

template <typename T>
__global__ void layer_norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ mu, const float* __restrict__ rstd,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ dw_part,
    float* __restrict__ db_part, int n, int d, int rows_per_block) {
  __shared__ float red[32];
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  float* dwb = dw_part + static_cast<long long>(blockIdx.x) * d;
  float* dbb = db_part + static_cast<long long>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    dwb[i] = 0.f;
    dbb[i] = 0.f;
  }
  for (int row = r0; row < r1; ++row) {
    const long long off = static_cast<long long>(row) * d;
    const float m = mu[row];
    const float r = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float xh = (ps::to_f32(x[off + i]) - m) * r;
      const float gw = ps::to_f32(g[off + i]) * ps::to_f32(w[i]);
      s1 += gw;
      s2 += gw * xh;
    }
    const float m1 = ps::block_sum(s1, red) / d;
    const float m2 = ps::block_sum(s2, red) / d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float xh = (ps::to_f32(x[off + i]) - m) * r;
      const float gv = ps::to_f32(g[off + i]);
      const float gw = gv * ps::to_f32(w[i]);
      dx[off + i] = ps::from_f32<T>((gw - m1 - xh * m2) * r);
      dwb[i] += gv * xh;
      dbb[i] += gv;
    }
  }
}

template <typename T>
__global__ void rms_norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ rstd, const T* __restrict__ g,
    T* __restrict__ dx, float* __restrict__ dw_part, int n, int d,
    int rows_per_block) {
  __shared__ float red[32];
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  float* dwb = dw_part + static_cast<long long>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) dwb[i] = 0.f;
  for (int row = r0; row < r1; ++row) {
    const long long off = static_cast<long long>(row) * d;
    const float r = rstd[row];
    float s = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float xh = ps::to_f32(x[off + i]) * r;
      s += ps::to_f32(g[off + i]) * ps::to_f32(w[i]) * xh;
    }
    const float m = ps::block_sum(s, red) / d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float xh = ps::to_f32(x[off + i]) * r;
      const float gv = ps::to_f32(g[off + i]);
      dx[off + i] = ps::from_f32<T>((gv * ps::to_f32(w[i]) - xh * m) * r);
      dwb[i] += gv * xh;
    }
  }
}

// Narrow rows use fewer threads so that each thread still has a few
// elements; 25 055-wide rows get the largest block.
int threads_for(int d) {
  if (d <= 1024) return 128;
  if (d <= 4096) return 256;
  return 1024;
}

}  // namespace

extern "C" int ps_layer_norm_fwd(int device, int dtype, const void* x,
                                 const void* w, const void* b, void* y,
                                 void* mu, void* rstd, int n, int d, float eps,
                                 void* stream) {
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(d);
  if (dtype == ps::kBFloat16) {
    using T = __nv_bfloat16;
    layer_norm_fwd_kernel<T><<<n, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(y), static_cast<float*>(mu),
        static_cast<float*>(rstd), d, eps);
  } else if (dtype == ps::kFloat32) {
    layer_norm_fwd_kernel<float><<<n, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y),
        static_cast<float*>(mu), static_cast<float*>(rstd), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ps_rms_norm_fwd(int device, int dtype, const void* x,
                               const void* w, void* y, void* rstd, int n,
                               int d, float eps, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(d);
  if (dtype == ps::kBFloat16) {
    using T = __nv_bfloat16;
    rms_norm_fwd_kernel<T><<<n, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
        static_cast<float*>(rstd), d, eps);
  } else if (dtype == ps::kFloat32) {
    rms_norm_fwd_kernel<float><<<n, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), static_cast<float*>(rstd), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward entry points take the number of blocks (the rows of the
// partial-sum buffers); block b takes rows [b * rpb, (b + 1) * rpb) with
// rpb = ceil(n / n_blocks), and a block left without rows writes zeros.
extern "C" int ps_layer_norm_bwd(int device, int dtype, const void* x,
                                 const void* w, const void* mu,
                                 const void* rstd, const void* g, void* dx,
                                 void* dw_part, void* db_part, int n, int d,
                                 int n_blocks, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(d);
  const int rpb = (n + n_blocks - 1) / n_blocks;
  if (dtype == ps::kBFloat16) {
    using T = __nv_bfloat16;
    layer_norm_bwd_kernel<T><<<n_blocks, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const float*>(mu), static_cast<const float*>(rstd),
        static_cast<const T*>(g), static_cast<T*>(dx),
        static_cast<float*>(dw_part), static_cast<float*>(db_part), n, d, rpb);
  } else if (dtype == ps::kFloat32) {
    layer_norm_bwd_kernel<float><<<n_blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(mu), static_cast<const float*>(rstd),
        static_cast<const float*>(g), static_cast<float*>(dx),
        static_cast<float*>(dw_part), static_cast<float*>(db_part), n, d, rpb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ps_rms_norm_bwd(int device, int dtype, const void* x,
                               const void* w, const void* rstd, const void* g,
                               void* dx, void* dw_part, int n, int d,
                               int n_blocks, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(d);
  const int rpb = (n + n_blocks - 1) / n_blocks;
  if (dtype == ps::kBFloat16) {
    using T = __nv_bfloat16;
    rms_norm_bwd_kernel<T><<<n_blocks, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const float*>(rstd), static_cast<const T*>(g),
        static_cast<T*>(dx), static_cast<float*>(dw_part), n, d, rpb);
  } else if (dtype == ps::kFloat32) {
    rms_norm_bwd_kernel<float><<<n_blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(rstd), static_cast<const float*>(g),
        static_cast<float*>(dx), static_cast<float*>(dw_part), n, d, rpb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
