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
// [n_blocks, d] buffer, summed over blocks after it: by PyTorch for the
// LayerNorm (as the TPU wrapper does), by rms_dw_sum_kernel for the
// RMSNorm.
//
// Bound: bytes.  A row is read and written once; the work is a handful of
// flops per element, far below the card's ~295 flop/byte ridge.
//
// LayerNorm forward: one block per row, with a block-stride loop over d,
// so any width works (560 and 25 055 are not multiples of 128, which the
// TPU kernels required).  The statistics take two passes over the row
// (mean, then the centred variance, as the TPU kernel computes them) and
// the output a third; the repeated reads of a row hit L1/L2, so device
// memory sees each row about once.
//
// RMSNorm, forward and backward (the LLM's 57 norms a pass, 1536 wide):
// two routes, picked by the wrapper from the width, the dtype and the
// pointers alone (ops/norms.py::rms_route).
//  * Vectorised route, for rows of d * esize bytes that are a multiple of
//    16 and at most RMS_MAX_CHUNKS * 32 * 16 = 3 584 (bf16 d <= 1 792, fp32
//    d <= 896), with 16-byte-aligned x, w, y or g, dx: one warp per row.
//    A lane holds its chunks c = lane + 32 j of the row (16-byte loads,
//    8 bf16 or 4 fp32 values each; 6 a lane at d = 1536 bf16, lanes past
//    the row's end idle) in registers from the load to the store, so a row
//    crosses device memory once and the statistic is a warp shuffle: no
//    shared memory and no barrier per row.  Blocks of RMS_WARPS warps walk
//    a run of consecutive rows, the warps taking turns; w is loaded once a
//    block.  The forward, and the backward without dw, load a warp's next
//    row before the current row's shuffle and stores, so two rows a warp
//    are in flight.  Backward with dw: a lane owns the same columns in
//    every row it takes and sums their dw terms in fp32 registers (those
//    registers take the place of the next row's), the block's warps add
//    theirs in shared memory in a fixed order, and each block writes one
//    partial row once.  Without dw (frozen weights, the training main
//    path) no dw is computed and no partial row exists.
//  * General route, any other width or a misaligned pointer: the forward
//    one block per row, a block-stride loop over d, the row read twice
//    (the second time from L1); the backward a block per run of rows, one
//    pass for the mean and one for dx, adding each row's dw terms into
//    its block's partial row in device memory (L2) unless dw is not
//    wanted.
//  * rms_dw_sum_kernel sums the partial rows over blocks in a fixed order
//    (16 warps a 32-column slice, then the warps' sums in warp order), in
//    the weight's dtype: dw is the same bits from run to run.
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
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

// the RMSNorm kernels' vectorised route: warps a block, and 16-byte chunks
// a lane at most (ops/norms.py::VEC_ROW_BYTES = RMS_MAX_CHUNKS * 32 * 16)
constexpr int RMS_WARPS = 4;
constexpr int RMS_MAX_CHUNKS = 7;

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

// The general route's backward; WG: dw partials wanted.
template <typename T, bool WG>
__global__ void rms_norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ rstd, const T* __restrict__ g,
    T* __restrict__ dx, float* __restrict__ dw_part, int n, int d,
    int rows_per_block) {
  __shared__ float red[32];
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  float* dwb = WG ? dw_part + static_cast<long long>(blockIdx.x) * d : nullptr;
  if (WG)
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
      if (WG) dwb[i] += gv * xh;
    }
  }
}

// 16 bytes of T as fp32 values: 8 bf16 or 4 fp32
template <typename T>
struct Pack;
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};
template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A lane's chunks lane + 32 j of one row of `chunks` 16-byte chunks, into
// registers; the chunks past the row's end are zeros.
template <int NCH>
__device__ __forceinline__ void load_chunks(const void* row, int lane, int chunks,
                                            uint4 (&v)[NCH]) {
  const uint4* p = static_cast<const uint4*>(row);
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < chunks ? __ldg(p + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The vectorised route's forward: a warp per row, RMS_WARPS warps a block
// taking turns on the block's rows, the next row loaded before the current
// one's shuffle and stores.
template <typename T, int NCH>
__global__ void __launch_bounds__(RMS_WARPS * 32) rms_norm_fwd_vec_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    float* __restrict__ rstd, int n, int d, int rows_per_block, float eps) {
  using P = Pack<T>;
  const int lane = threadIdx.x & 31;
  const int chunks = d / P::N;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  int row = r0 + (threadIdx.x >> 5);
  uint4 wv[NCH], xv[NCH];
  load_chunks<NCH>(w, lane, chunks, wv);
  if (row < r1) load_chunks<NCH>(x + static_cast<long long>(row) * d, lane, chunks, xv);
  for (; row < r1; row += RMS_WARPS) {
    const int next = row + RMS_WARPS;
    uint4 xn[NCH];
    if (next < r1) load_chunks<NCH>(x + static_cast<long long>(next) * d, lane, chunks, xn);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      float f[P::N];
      P::unpack(xv[j], f);
#pragma unroll
      for (int k = 0; k < P::N; ++k) s += f[k] * f[k];
    }
    const float r = rsqrtf(warp_sum(s) / d + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<long long>(row) * d);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) {
        float f[P::N], wf[P::N];
        P::unpack(xv[j], f);
        P::unpack(wv[j], wf);
#pragma unroll
        for (int k = 0; k < P::N; ++k) f[k] = f[k] * r * wf[k];
        yr[c] = P::pack(f);
      }
    }
    if (lane == 0) rstd[row] = r;
    if (next < r1) {
#pragma unroll
      for (int j = 0; j < NCH; ++j) xv[j] = xn[j];
    }
  }
}

// One row of the vectorised backward from the lane's x and g chunks in
// registers: dx, and with WG the row's dw terms added to the lane's acc.
template <typename T, int NCH, bool WG>
__device__ __forceinline__ void rms_bwd_row(const uint4 (&xv)[NCH], const uint4 (&gv)[NCH],
                                            const uint4 (&wv)[NCH], float r, int lane,
                                            int chunks, int d, uint4* dxr,
                                            float (&acc)[NCH][Pack<T>::N]) {
  using P = Pack<T>;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    float xf[P::N], gf[P::N], wf[P::N];
    P::unpack(xv[j], xf);
    P::unpack(gv[j], gf);
    P::unpack(wv[j], wf);
#pragma unroll
    for (int k = 0; k < P::N; ++k) s += gf[k] * wf[k] * (xf[k] * r);
  }
  const float m = warp_sum(s) / d;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = lane + 32 * j;
    if (c < chunks) {
      float xf[P::N], gf[P::N], wf[P::N], o[P::N];
      P::unpack(xv[j], xf);
      P::unpack(gv[j], gf);
      P::unpack(wv[j], wf);
#pragma unroll
      for (int k = 0; k < P::N; ++k) {
        const float xh = xf[k] * r;
        o[k] = (gf[k] * wf[k] - xh * m) * r;
        if (WG) acc[j][k] += gf[k] * xh;
      }
      dxr[c] = P::pack(o);
    }
  }
}

// The vectorised route's backward; WG: one dw partial row a block.
template <typename T, int NCH, bool WG>
__global__ void __launch_bounds__(RMS_WARPS * 32) rms_norm_bwd_vec_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ rstd,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ dw_part, int n, int d,
    int rows_per_block) {
  using P = Pack<T>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = d / P::N;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  int row = r0 + warp;
  float acc[NCH][P::N];  // this lane's columns' dw terms, over its rows (WG)
  if (WG) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
#pragma unroll
      for (int k = 0; k < P::N; ++k) acc[j][k] = 0.f;
    }
  }
  uint4 wv[NCH], xv[NCH], gv[NCH];
  load_chunks<NCH>(w, lane, chunks, wv);
  auto dx_row = [&](int r_) { return reinterpret_cast<uint4*>(dx + static_cast<long long>(r_) * d); };
  if constexpr (WG) {
    // the accumulators hold the registers a next row would take
    for (; row < r1; row += RMS_WARPS) {
      const long long off = static_cast<long long>(row) * d;
      load_chunks<NCH>(x + off, lane, chunks, xv);
      load_chunks<NCH>(g + off, lane, chunks, gv);
      rms_bwd_row<T, NCH, WG>(xv, gv, wv, rstd[row], lane, chunks, d, dx_row(row), acc);
    }
    __shared__ float part_s[RMS_MAX_CHUNKS * 32 * 8];
    // the warps' sums in warp order: the partial row is the same bits
    // from run to run
    for (int wi = 0; wi < RMS_WARPS; ++wi) {
      if (warp == wi) {
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int c = lane + 32 * j;
          if (c < chunks) {
#pragma unroll
            for (int k = 0; k < P::N; ++k) {
              const int i = c * P::N + k;
              part_s[i] = wi == 0 ? acc[j][k] : part_s[i] + acc[j][k];
            }
          }
        }
      }
      __syncthreads();
    }
    float* out = dw_part + static_cast<long long>(blockIdx.x) * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) out[i] = part_s[i];
  } else {
    float r = 0.f;
    if (row < r1) {
      const long long off = static_cast<long long>(row) * d;
      load_chunks<NCH>(x + off, lane, chunks, xv);
      load_chunks<NCH>(g + off, lane, chunks, gv);
      r = rstd[row];
    }
    for (; row < r1; row += RMS_WARPS) {
      const int next = row + RMS_WARPS;
      uint4 xn[NCH], gn[NCH];
      float rn = 0.f;
      if (next < r1) {
        const long long off = static_cast<long long>(next) * d;
        load_chunks<NCH>(x + off, lane, chunks, xn);
        load_chunks<NCH>(g + off, lane, chunks, gn);
        rn = rstd[next];
      }
      rms_bwd_row<T, NCH, WG>(xv, gv, wv, r, lane, chunks, d, dx_row(row), acc);
      if (next < r1) {
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          xv[j] = xn[j];
          gv[j] = gn[j];
        }
        r = rn;
      }
    }
  }
}

// dw[c] = sum over blocks b of part[b, c], in the weight's dtype: a block
// of 16 warps a 32-column slice, warp i summing blocks i, i + 16, ... in
// order, then warp 0 adding the 16 sums in warp order.
template <typename T>
__global__ void __launch_bounds__(512) rms_dw_sum_kernel(const float* __restrict__ part,
                                                         T* __restrict__ dw, int n_blocks,
                                                         int d) {
  __shared__ float red[16][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = warp; b < n_blocks; b += 16) s += part[static_cast<long long>(b) * d + c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) t += red[i][lane];
    dw[c] = ps::from_f32<T>(t);
  }
}

// f(std::integral_constant<int, nch>) for nch in 1..RMS_MAX_CHUNKS
template <typename F>
bool with_chunks(int nch, F&& f) {
  switch (nch) {
    case 1: f(std::integral_constant<int, 1>{}); return true;
    case 2: f(std::integral_constant<int, 2>{}); return true;
    case 3: f(std::integral_constant<int, 3>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 5: f(std::integral_constant<int, 5>{}); return true;
    case 6: f(std::integral_constant<int, 6>{}); return true;
    case 7: f(std::integral_constant<int, 7>{}); return true;
    default: return false;
  }
}
static_assert(RMS_MAX_CHUNKS == 7, "with_chunks covers 1..RMS_MAX_CHUNKS");

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) with T the element type of a dtype code; false for others
template <typename F>
bool with_dtype(int dtype, F&& f) {
  if (dtype == ps::kBFloat16) {
    f(Tag<__nv_bfloat16>{});
    return true;
  }
  if (dtype == ps::kFloat32) {
    f(Tag<float>{});
    return true;
  }
  return false;
}

// 16-byte chunks a lane for the vectorised route, or 0 where the route
// does not take these rows or pointers
int vec_chunks(int d, int esize, std::initializer_list<const void*> ptrs) {
  const long long bytes = static_cast<long long>(d) * esize;
  if (bytes % 16 != 0 || bytes > RMS_MAX_CHUNKS * 32 * 16) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  return static_cast<int>((bytes / 16 + 31) / 32);
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

// The general route's backward; dw_part null: no dw (frozen weights).
extern "C" int ps_rms_norm_bwd(int device, int dtype, const void* x,
                               const void* w, const void* rstd, const void* g,
                               void* dx, void* dw_part, int n, int d,
                               int n_blocks, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(d);
  const int rpb = (n + n_blocks - 1) / n_blocks;
  const bool known = with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const T* xp = static_cast<const T*>(x);
    const T* wp = static_cast<const T*>(w);
    const T* gp = static_cast<const T*>(g);
    const float* rp = static_cast<const float*>(rstd);
    float* pp = static_cast<float*>(dw_part);
    if (pp)
      rms_norm_bwd_kernel<T, true><<<n_blocks, threads, 0, st>>>(
          xp, wp, rp, gp, static_cast<T*>(dx), pp, n, d, rpb);
    else
      rms_norm_bwd_kernel<T, false><<<n_blocks, threads, 0, st>>>(
          xp, wp, rp, gp, static_cast<T*>(dx), nullptr, n, d, rpb);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The vectorised route (see the note at the top); the wrapper takes it only
// for rows and pointers it accepts, and these entry points refuse others.
// n_blocks blocks of RMS_WARPS warps, block b taking rows [b * rpb,
// (b + 1) * rpb) with rpb = ceil(n / n_blocks).
extern "C" int ps_rms_norm_fwd_vec(int device, int dtype, const void* x,
                                   const void* w, void* y, void* rstd, int n,
                                   int d, float eps, int n_blocks, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const int rpb = (n + n_blocks - 1) / n_blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool launched = false;
  with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    launched = with_chunks(vec_chunks(d, sizeof(T), {x, w, y}), [&](auto nch) {
      rms_norm_fwd_vec_kernel<T, decltype(nch)::value><<<n_blocks, RMS_WARPS * 32, 0, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
          static_cast<float*>(rstd), n, d, rpb, eps);
    });
  });
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dw_part null: no dw (frozen weights); else one partial row a block.
extern "C" int ps_rms_norm_bwd_vec(int device, int dtype, const void* x,
                                   const void* w, const void* rstd, const void* g,
                                   void* dx, void* dw_part, int n, int d,
                                   int n_blocks, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const int rpb = (n + n_blocks - 1) / n_blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool launched = false;
  with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    launched = with_chunks(vec_chunks(d, sizeof(T), {x, w, g, dx}), [&](auto nch) {
      constexpr int NCH = decltype(nch)::value;
      const T* xp = static_cast<const T*>(x);
      const T* wp = static_cast<const T*>(w);
      const T* gp = static_cast<const T*>(g);
      const float* rp = static_cast<const float*>(rstd);
      float* pp = static_cast<float*>(dw_part);
      if (pp)
        rms_norm_bwd_vec_kernel<T, NCH, true><<<n_blocks, RMS_WARPS * 32, 0, st>>>(
            xp, wp, rp, gp, static_cast<T*>(dx), pp, n, d, rpb);
      else
        rms_norm_bwd_vec_kernel<T, NCH, false><<<n_blocks, RMS_WARPS * 32, 0, st>>>(
            xp, wp, rp, gp, static_cast<T*>(dx), nullptr, n, d, rpb);
    });
  });
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dw = the sum over blocks of the backward's [n_blocks, d] fp32 partial
// rows, in the weight's dtype, in a fixed order.
extern "C" int ps_rms_norm_dw_sum(int device, int dtype, const void* dw_part,
                                  void* dw, int n_blocks, int d, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    rms_dw_sum_kernel<T><<<(d + 31) / 32, 512, 0, st>>>(
        static_cast<const float*>(dw_part), static_cast<T*>(dw), n_blocks, d);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
