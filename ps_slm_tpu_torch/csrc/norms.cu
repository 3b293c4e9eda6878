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
// repeated reads of a row hit L1/L2, so device memory sees each row about
// once.  The RMSNorm backward takes one pass for its mean and one for dx,
// and adds each row's dw terms into its block's partial row in device
// memory (L2).
//
// LayerNorm backward (its main-path shape is the projector's norm over the
// CTC posterior, 2560 x 25 055 bf16, one launch a training step): one
// block an SM, 896 threads for bf16 (512 for fp32), each block a run of
// consecutive rows.
//  * Each row's x and g cross device memory once: a thread loads its 28
//    columns (t + 896 j; 49 for fp32) into registers, one x, g pair a
//    register in bf16, for the two means and then for dx.  Columns past
//    25 088 are read again, from L2.
//  * Both means come from one block reduction (block_sum2).
//  * The block's dw and db partial rows stay in shared memory for its whole
//    run of rows (200 KB at 25 055 wide, so one block an SM) and are
//    written once at the end; a thread owns the same columns in every row,
//    so the read-modify-writes need no barrier.  Rows wider than 28 800
//    keep the partial rows in device memory instead.
//  * Loads are 2-byte and coalesced (a warp reads 64 contiguous bytes): d
//    is odd, so a row's start shifts its alignment from row to row, and
//    wide loads would move a thread's columns from row to row.  Measured
//    and dropped: 16-byte loads with the shift undone by shuffles (with dx
//    staged through shared memory for contiguous stores), w held in
//    registers, and 512, 768 or 1024 bf16 threads; all slower.  At 896
//    the bf16 kernel spills 216 bytes to L1, as every bf16 block shape
//    tried did (the loads in flight need the registers).
//  * An SM works on one row at a time, so its loads do not overlap its
//    reduction and dx pass: the likely reason, not measured, that the
//    kernel stays near 3x its bound.
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

// The LayerNorm backward's block: one block an SM (its partial rows take
// most of the SM's shared memory at the projector's width).  Thread t owns
// columns t + kThreads j and keeps the x and g of the first kCols of them,
// as one pair a register (two for fp32), from the first pass over the row
// to the second: 896 x 28 and 512 x 49 = 25 088 columns, the projector's
// 25 055 included.  Wider rows read their further columns again (from L2).
template <typename T>
struct LnBwd;
template <>
struct LnBwd<__nv_bfloat16> {
  static constexpr int kThreads = 896, kCols = 28;
};
template <>
struct LnBwd<float> {
  static constexpr int kThreads = 512, kCols = 49;
};
// dynamic shared memory for the fp32 dw and db partial rows (2 x 4 x d
// bytes, d <= 28 800); wider rows keep them in the global partial buffers
constexpr int LN_BWD_SMEM_MAX = 225 * 1024;

template <typename T>
struct XG;  // x and g of one column in one register (two for fp32)
template <>
struct XG<float> {
  float2 v;
  __device__ __forceinline__ void load(const float* x, const float* g, long long i) {
    v = make_float2(x[i], g[i]);
  }
  __device__ __forceinline__ float2 f32() const { return v; }
};
template <>
struct XG<__nv_bfloat16> {
  __nv_bfloat162 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                       long long i) {
    v = __halves2bfloat162(x[i], g[i]);
  }
  __device__ __forceinline__ float2 f32() const { return __bfloat1622float2(v); }
};

template <typename T>
__global__ void __launch_bounds__(LnBwd<T>::kThreads, 1) layer_norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ mu, const float* __restrict__ rstd,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ dw_part,
    float* __restrict__ db_part, int n, int d, int rows_per_block, int smem_part) {
  extern __shared__ float part_s[];  // [2][d]: dw, db partials when smem_part
  __shared__ float2 red[32];
  constexpr int THREADS = LnBwd<T>::kThreads, COLS = LnBwd<T>::kCols;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  const long long blk = static_cast<long long>(blockIdx.x) * d;
  // a thread touches only the columns it owns, so the partials need no
  // barrier between rows
  float* dwb = smem_part ? part_s : dw_part + blk;
  float* dbb = smem_part ? part_s + d : db_part + blk;
  for (int c = tid; c < d; c += THREADS) dwb[c] = dbb[c] = 0.f;

  for (int row = r0; row < r1; ++row) {
    const T* xr = x + static_cast<long long>(row) * d;
    const T* gr = g + static_cast<long long>(row) * d;
    T* dxr = dx + static_cast<long long>(row) * d;
    const float m = mu[row];
    const float r = rstd[row];

    // first pass: the row's x and g cross device memory once, into
    // registers; both means in one block reduction
    float2 s = make_float2(0.f, 0.f);
    auto add = [&](int c, float2 xg) {
      const float xh = (xg.x - m) * r;
      const float gw = xg.y * ps::to_f32(w[c]);
      s.x += gw;
      s.y += gw * xh;
    };
    XG<T> held[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = tid + j * THREADS;
      if (c < d) {
        held[j].load(xr, gr, c);
        add(c, held[j].f32());
      }
    }
    for (int c = tid + COLS * THREADS; c < d; c += THREADS) {
      XG<T> p;
      p.load(xr, gr, c);
      add(c, p.f32());
    }
    s = ps::block_sum2(s, red);
    const float m1 = s.x / d;
    const float m2 = s.y / d;

    // second pass, from registers: dx, and this row's dw and db terms
    // into the block's partial rows
    auto finish = [&](int c, float2 xg) {
      const float xh = (xg.x - m) * r;
      const float gw = xg.y * ps::to_f32(w[c]);
      dxr[c] = ps::from_f32<T>((gw - m1 - xh * m2) * r);
      dwb[c] += xg.y * xh;
      dbb[c] += xg.y;
    };
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = tid + j * THREADS;
      if (c < d) finish(c, held[j].f32());
    }
    for (int c = tid + COLS * THREADS; c < d; c += THREADS) {
      XG<T> p;
      p.load(xr, gr, c);
      finish(c, p.f32());
    }
  }
  if (smem_part)
    for (int c = tid; c < d; c += THREADS) {
      dw_part[blk + c] = dwb[c];
      db_part[blk + c] = dbb[c];
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
  // once, so that a launch inside CUDA-graph capture makes no attribute call
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(layer_norm_bwd_kernel<__nv_bfloat16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         LN_BWD_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(layer_norm_bwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, LN_BWD_SMEM_MAX);
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rpb = (n + n_blocks - 1) / n_blocks;
  const long long part_bytes = 2LL * d * static_cast<long long>(sizeof(float));
  const int smem_part = part_bytes <= LN_BWD_SMEM_MAX;
  const int smem = smem_part ? static_cast<int>(part_bytes) : 0;
  if (dtype == ps::kBFloat16) {
    using T = __nv_bfloat16;
    layer_norm_bwd_kernel<T><<<n_blocks, LnBwd<T>::kThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const float*>(mu), static_cast<const float*>(rstd),
        static_cast<const T*>(g), static_cast<T*>(dx),
        static_cast<float*>(dw_part), static_cast<float*>(db_part), n, d, rpb, smem_part);
  } else if (dtype == ps::kFloat32) {
    layer_norm_bwd_kernel<float><<<n_blocks, LnBwd<float>::kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(mu), static_cast<const float*>(rstd),
        static_cast<const float*>(g), static_cast<float*>(dx),
        static_cast<float*>(dw_part), static_cast<float*>(db_part), n, d, rpb, smem_part);
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
