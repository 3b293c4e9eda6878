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
// [n_blocks, d] buffer, summed over blocks after it by partial_sum_kernel
// in a fixed order (one launch for the LayerNorm's dw and db together).
//
// Bound: bytes.  A row is read and written once; the work is a handful of
// flops per element, far below the card's ~295 flop/byte ridge.
//
// Every forward computes the statistics as the TPU kernels do: the mean,
// then the centred variance mean((x - mean)^2) (LayerNorm) or mean(x^2)
// (RMSNorm), rstd = rsqrt(var + eps), in fp32, with no atomics (the same
// bits on every call).
//
// Forward (LayerNorm: the encoder's 142 norms a pass, 512 and 560 wide,
// and the projector's one over the 25 055-wide CTC posterior; RMSNorm: the
// LLM's 57 norms a pass, 1536 wide) and RMSNorm backward: routes picked by
// the wrapper from the width, the dtype and the pointers alone
// (ops/norms.py::rms_route, ::ln_route).
//  * Vectorised route, for rows of d * esize bytes that are a multiple of
//    16 and at most VEC_MAX_CHUNKS * 32 * 16 = 3 584 (bf16 d <= 1 792, fp32
//    d <= 896), with 16-byte-aligned x, w, b, y or g, dx: one warp per row.
//    A lane holds its chunks c = lane + 32 j of the row (16-byte loads,
//    8 bf16 or 4 fp32 values each; 2 a lane at d = 512 bf16, 6 at 1536,
//    lanes past the row's end idle) in registers from the load to the
//    store, so a row crosses device memory once and each statistic is a
//    warp shuffle (two for the LayerNorm's mean and centred variance): no
//    shared memory and no barrier per row.  One kernel template serves both
//    forwards (norm_fwd_vec_kernel, LN picks the LayerNorm).  Blocks of
//    VEC_WARPS warps walk a run of consecutive rows, the warps taking
//    turns; w (and b) are loaded once a block.  The forward, and the
//    backward without dw, load a warp's next row before the current row's
//    shuffles and stores, so two rows a warp are in flight.  Backward with
//    dw: a lane owns the same columns in
//    every row it takes and sums their dw terms in fp32 registers (those
//    registers take the place of the next row's), the block's warps add
//    theirs in shared memory in a fixed order, and each block writes one
//    partial row once.  Without dw (frozen weights, the training main
//    path) no dw is computed and no partial row exists.
//  * Staged and held routes (LayerNorm forward only), rows wider than the
//    vectorised cap: the projector's 25 055 columns, 50 110 bytes in bf16.
//    d is odd, so a row's start shifts its 16-byte alignment from row to
//    row (with a period of 8 rows in bf16).  LAYER_NORM_WIDE_DESIGN below
//    says which rows each of the two routes takes and what each measured.
//  * General route, any other width or a misaligned pointer: the forward
//    one block per row, a block-stride loop over d, the row read two
//    (RMSNorm) or three (LayerNorm: mean, centred variance, output) times,
//    the later reads from L1; the backward a block per run of rows, one
//    pass for the mean and one for dx, adding each row's dw terms into
//    its block's partial row in device memory (L2) unless dw is not
//    wanted.
//  * partial_sum_kernel sums the partial rows over blocks in a fixed order
//    (16 warps a 32-column slice, then the warps' sums in warp order), in
//    the weight's dtype, one buffer a grid row (the RMSNorm's dw; the
//    LayerNorm's dw and db in one launch): dw and db are the same bits from
//    run to run.
//
// LayerNorm backward: two routes, by the width, the dtype and the pointers
// alone (ops/norms.py::ln_bwd_route).
//
// The vectorised route (the rows the forward's vectorised route takes:
// bf16 d <= 1 792, fp32 d <= 896, whole 16-byte chunks, x, w, g and dx
// 16-byte aligned; the encoder's 560 / 512 and the q-former's 768 / 1536)
// is ln_bwd.cu's layer_norm_bwd_vec_kernel (LAYER_NORM_BWD_VEC_DESIGN
// there), built apart so that the two sources compile at once; the
// vectorised routes' shared pieces are in vec.cuh.
//
// The wide route (every other row: the projector's norm over the CTC
// posterior, 2560 x 25 055 bf16, one launch a training step): one
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

#include "common.cuh"
#include "mma.cuh"
#include "vec.cuh"

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
// dynamic shared memory a block may take: the LayerNorm backward's fp32 dw
// and db partial rows (2 x 4 x d bytes, d <= 28 800; wider rows keep them
// in the global partial buffers), the staged forward's ring of rows
constexpr int DYN_SMEM_MAX = 225 * 1024;

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

// The vectorised route's forward, LayerNorm (LN: b, mu) or RMSNorm: a warp
// per row, VEC_WARPS warps a block taking turns on the block's rows, the
// next row loaded before the current one's shuffles and stores.
template <typename T, int NCH, bool LN>
__global__ void __launch_bounds__(VEC_WARPS * 32) norm_fwd_vec_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    T* __restrict__ y, float* __restrict__ mu, float* __restrict__ rstd, int n, int d,
    int rows_per_block, float eps) {
  using P = Pack<T>;
  const int lane = threadIdx.x & 31;
  const int chunks = d / P::N;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  int row = r0 + (threadIdx.x >> 5);
  uint4 wv[NCH], bv[LN ? NCH : 1], xv[NCH];
  load_chunks<NCH>(w, lane, chunks, wv);
  if constexpr (LN) load_chunks<NCH>(b, lane, chunks, bv);
  if (row < r1) load_chunks<NCH>(x + static_cast<long long>(row) * d, lane, chunks, xv);
  for (; row < r1; row += VEC_WARPS) {
    const int next = row + VEC_WARPS;
    uint4 xn[NCH];
    if (next < r1) load_chunks<NCH>(x + static_cast<long long>(next) * d, lane, chunks, xn);
    float mean = 0.f, s = 0.f;
    if constexpr (LN) {
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        float f[P::N];
        P::unpack(xv[j], f);
#pragma unroll
        for (int k = 0; k < P::N; ++k) s += f[k];
      }
      mean = warp_sum(s) / d;
      s = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (!LN || lane + 32 * j < chunks) {   // the zeros past the row's end are not (0 - mean)^2
        float f[P::N];
        P::unpack(xv[j], f);
#pragma unroll
        for (int k = 0; k < P::N; ++k) {
          const float c = LN ? f[k] - mean : f[k];
          s += c * c;
        }
      }
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
        if constexpr (LN) {
          float bf[P::N];
          P::unpack(bv[j], bf);
#pragma unroll
          for (int k = 0; k < P::N; ++k) f[k] = (f[k] - mean) * r * wf[k] + bf[k];
        } else {
#pragma unroll
          for (int k = 0; k < P::N; ++k) f[k] = f[k] * r * wf[k];
        }
        yr[c] = P::pack(f);
      }
    }
    if (lane == 0) {
      if constexpr (LN) mu[row] = mean;
      rstd[row] = r;
    }
    if (next < r1) {
#pragma unroll
      for (int j = 0; j < NCH; ++j) xv[j] = xn[j];
    }
  }
}

// LAYER_NORM_WIDE_DESIGN.  Rows wider than the vectorised cap are read
// from device memory once and kept on chip for both statistics and the
// output.  Blocks of 1024 threads, one an SM.  Two routes, by the row's
// bytes alone (ln_staged_fits; ops/norms.py::ln_route):
//  * staged, for rows whose four buffers fit in shared memory (bf16 d <=
//    28 792, fp32 d <= 14 396; the projector's 25 055 bf16).  d is odd, so
//    a row's start shifts its 16-byte alignment from row to row, with a
//    period of P = 16 / gcd(row bytes % 16, 16) rows (8 at 25 055 bf16).
//    Block b takes rows of one class q = b % P only (rows q, q + P, ...; a
//    run of them), so all its rows share one shift, and it copies w and b
//    once into shared memory at that shift.  Each row's 16-byte granules
//    (the first and last also hold bytes of the rows beside it, or of the
//    memory beside the tensor, which are read and ignored: a granule never
//    crosses a page) arrive by one bulk copy (cp.async.bulk, issued by one
//    thread, completing on an mbarrier) into a ring of two row buffers.  A
//    thread moves its granules tid + 1024 j (4 at most) into registers and,
//    once the block's first reduction shows every thread has, the buffer
//    takes the row after next: two rows are in flight while the block
//    reduces and stores the current one.  Every access is 16 bytes: x and
//    the w and b granules from shared memory, y stored 16 bytes at a time
//    where y's shift is x's (the first and last granule element by
//    element).
//  * held, any wider row: a thread keeps its columns tid + 1024 j (25, two
//    bf16 or one fp32 a register) in registers from 2-byte coalesced loads;
//    columns past 25 600 are read again; w and b through L1.
// On an H100 SXM at 700 W, 2064 x 25 055 bf16 (bound 0.062 ms, bytes;
// chip_smoke.py --variants): staged 0.092 ms; held 0.13; the general
// kernel 0.18.  Measured and replaced on the way: the staged ring with
// one row in flight, read by 2-byte loads of x, w and b a thread a column
// (0.109) or by 16-byte granules (0.107), so not bound by instructions;
// the ring with two rows in flight filled by the block's 16-byte cp.async
// instead of one bulk copy (0.099); the held design at 512 bf16 threads x
// 49 columns, two blocks an SM, which spills (0.29).
constexpr int LN_WIDE_THREADS = 1024;
constexpr int LN_HELD_COLS = 25;
constexpr int LN_STAGED_GRANULES = 4;  // a thread's x granules a row

// A thread's values of one row at columns tid + THREADS j, j < COLS, in
// registers: one fp32 or two bf16 a register.
template <typename T, int COLS>
struct Held {
  T v[COLS];
  __device__ __forceinline__ void set(int j, T x) { v[j] = x; }
  __device__ __forceinline__ float get(int j) const { return v[j]; }
};
template <int COLS>
struct Held<__nv_bfloat16, COLS> {
  __nv_bfloat162 v[(COLS + 1) / 2];
  __device__ __forceinline__ void set(int j, __nv_bfloat16 x) {
    if (j & 1)
      v[j >> 1].y = x;
    else
      v[j >> 1].x = x;
  }
  __device__ __forceinline__ float get(int j) const {
    return __bfloat162float(j & 1 ? v[j >> 1].y : v[j >> 1].x);
  }
};

template <typename T>
__global__ void __launch_bounds__(LN_WIDE_THREADS, 1)
    layer_norm_fwd_held_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               const T* __restrict__ b, T* __restrict__ y,
                               float* __restrict__ mu, float* __restrict__ rstd, int n, int d,
                               int rows_per_block, float eps) {
  constexpr int THREADS = LN_WIDE_THREADS, COLS = LN_HELD_COLS;
  __shared__ float red[32];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + static_cast<long long>(row) * d;
    T* yr = y + static_cast<long long>(row) * d;
    Held<T, COLS> h;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = tid + j * THREADS;
      h.set(j, c < d ? xr[c] : ps::from_f32<T>(0.f));
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) s += h.get(j);  // zeros past the row's end
    for (int c = tid + COLS * THREADS; c < d; c += THREADS) s += ps::to_f32(xr[c]);
    const float mean = ps::block_sum(s, red) / d;
    s = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      if (tid + j * THREADS < d) {
        const float t = h.get(j) - mean;
        s += t * t;
      }
    for (int c = tid + COLS * THREADS; c < d; c += THREADS) {
      const float t = ps::to_f32(xr[c]) - mean;
      s += t * t;
    }
    const float r = rsqrtf(ps::block_sum(s, red) / d + eps);
    auto out = [&](int c, float v) {
      yr[c] = ps::from_f32<T>((v - mean) * r * ps::to_f32(w[c]) + ps::to_f32(b[c]));
    };
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      if (tid + j * THREADS < d) out(tid + j * THREADS, h.get(j));
    for (int c = tid + COLS * THREADS; c < d; c += THREADS) out(c, ps::to_f32(xr[c]));
    if (tid == 0) {
      mu[row] = mean;
      rstd[row] = r;
    }
  }
}

// the staged design's row buffer: the granules of a row at any shift
__host__ __device__ constexpr long long ln_stage_bytes(long long row_bytes) {
  return (row_bytes + 15 + 15) / 16 * 16;
}

// the staged route's rows: wider than the vectorised cap, with the four
// row buffers (w, b and the ring of two rows) in DYN_SMEM_MAX
constexpr bool ln_staged_fits(long long row_bytes) {
  return row_bytes > VEC_ROW_BYTES && 4 * ln_stage_bytes(row_bytes) <= DYN_SMEM_MAX;
}

// Dynamic shared memory: w, b, then the ring of two rows, each a buffer of
// stage_bytes holding a row's granules; element c of the block's rows (and
// of w and b) sits at byte shift + c * sizeof(T) of its buffer.  Each row
// arrives by one bulk copy (cp.async.bulk, the tensor memory accelerator)
// that one thread issues, completing on its buffer's mbarrier.
template <typename T>
__global__ void __launch_bounds__(LN_WIDE_THREADS, 1)
    layer_norm_fwd_staged_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                 const T* __restrict__ b, T* __restrict__ y,
                                 float* __restrict__ mu, float* __restrict__ rstd, int n, int d,
                                 int period, int stage_bytes, float eps) {
  using P = Pack<T>;
  constexpr int THREADS = LN_WIDE_THREADS, KH = LN_STAGED_GRANULES;
  extern __shared__ uint4 smem[];
  __shared__ float red[32];
  __shared__ uint64_t bars[2];  // one mbarrier a row buffer
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int tid = threadIdx.x;
  // this block's class q of rows q + period i, and its run of i
  const int q = blockIdx.x % period;
  if (q >= n) return;
  const int blocks = (gridDim.x - q + period - 1) / period;
  const int rows = (n - q + period - 1) / period;
  const int per = (rows + blocks - 1) / blocks;
  const int i0 = (blockIdx.x / period) * per;
  const int i1 = min(rows, i0 + per);
  if (i0 >= i1) return;
  const size_t row_bytes = sizeof(T) * d;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(x + static_cast<long long>(q) * d) & 15);
  const bool y_same = (reinterpret_cast<uintptr_t>(y + static_cast<long long>(q) * d) & 15) == shift;
  const int granules = static_cast<int>((shift + row_bytes + 15) >> 4);
  {
    T* ws = reinterpret_cast<T*>(base + shift);
    T* bs = reinterpret_cast<T*>(base + stage_bytes + shift);
    for (int c = tid; c < d; c += THREADS) {
      ws[c] = w[c];
      bs[c] = b[c];
    }
  }
  if (tid == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(ps::smem_addr(&bars[k])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto slot = [&](int i) { return (i - i0) % 2; };
  auto buffer = [&](int i) { return base + (2 + slot(i)) * stage_bytes; };
  // row q + period i into its buffer, by thread 0 (none past the
  // block's rows)
  auto issue = [&](int i) {
    if (tid != 0 || i >= i1) return;
    const unsigned char* g = reinterpret_cast<const unsigned char*>(
        reinterpret_cast<uintptr_t>(x + static_cast<long long>(q + period * i) * d) &
        ~uintptr_t(15));
    const uint32_t bar = ps::smem_addr(&bars[slot(i)]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(granules * 16)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(ps::smem_addr(buffer(i))),
        "l"(g), "r"(granules * 16), "r"(bar)
        : "memory");
  };
  // element e of granule k is column (16 k + sizeof(T) e - shift) / sizeof(T)
  auto column = [&](int k, int e) { return (16 * k - shift) / static_cast<int>(sizeof(T)) + e; };
  issue(i0);
  issue(i0 + 1);
  for (int i = i0; i < i1; ++i) {
    // the row's bytes have landed when its buffer's mbarrier completes
    // the phase of this use of the buffer
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n" ::"r"(ps::smem_addr(&bars[slot(i)])),
        "r"(((i - i0) / 2) & 1)
        : "memory");
    const long long row = q + static_cast<long long>(period) * i;
    const uint4* xs = reinterpret_cast<const uint4*>(buffer(i));
    uint4 xv[KH];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int k = tid + j * THREADS;
      if (k < granules) {
        xv[j] = xs[k];
        const bool whole = k > 0 && k < granules - 1;
        float f[P::N];
        P::unpack(xv[j], f);
#pragma unroll
        for (int e = 0; e < P::N; ++e)
          if (whole || (column(k, e) >= 0 && column(k, e) < d)) s += f[e];
      }
    }
    const float mean = ps::block_sum(s, red) / d;
    // every thread has its granules in registers (block_sum's barriers):
    // the buffer takes the row after next, two rows in flight
    issue(i + 2);
    s = 0.f;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int k = tid + j * THREADS;
      if (k < granules) {
        const bool whole = k > 0 && k < granules - 1;
        float f[P::N];
        P::unpack(xv[j], f);
#pragma unroll
        for (int e = 0; e < P::N; ++e)
          if (whole || (column(k, e) >= 0 && column(k, e) < d)) {
            const float t = f[e] - mean;
            s += t * t;
          }
      }
    }
    const float r = rsqrtf(ps::block_sum(s, red) / d + eps);
    T* yr = y + row * d;
    uint4* yg = reinterpret_cast<uint4*>(reinterpret_cast<uintptr_t>(yr) & ~uintptr_t(15));
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int k = tid + j * THREADS;
      if (k < granules) {
        float f[P::N], wf[P::N], bf[P::N];
        P::unpack(xv[j], f);
        P::unpack(smem[k], wf);
        P::unpack(smem[stage_bytes / 16 + k], bf);
#pragma unroll
        for (int e = 0; e < P::N; ++e) f[e] = (f[e] - mean) * r * wf[e] + bf[e];
        if (y_same && k > 0 && k < granules - 1) {
          yg[k] = P::pack(f);
        } else {
#pragma unroll
          for (int e = 0; e < P::N; ++e) {
            const int c = column(k, e);
            if (c >= 0 && c < d) yr[c] = ps::from_f32<T>(f[e]);
          }
        }
      }
    }
    if (tid == 0) {
      mu[row] = mean;
      rstd[row] = r;
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
__global__ void __launch_bounds__(VEC_WARPS * 32) rms_norm_bwd_vec_kernel(
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
    for (; row < r1; row += VEC_WARPS) {
      const long long off = static_cast<long long>(row) * d;
      load_chunks<NCH>(x + off, lane, chunks, xv);
      load_chunks<NCH>(g + off, lane, chunks, gv);
      rms_bwd_row<T, NCH, WG>(xv, gv, wv, rstd[row], lane, chunks, d, dx_row(row), acc);
    }
    __shared__ float part_s[VEC_MAX_CHUNKS * 32 * 8];
    // the warps' sums in warp order: the partial row is the same bits
    // from run to run
    for (int wi = 0; wi < VEC_WARPS; ++wi) {
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
    for (; row < r1; row += VEC_WARPS) {
      const int next = row + VEC_WARPS;
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

// out[c] = sum over blocks b of part[b, c], in the weight's dtype, for one
// (part, out) pair a grid row (blockIdx.y: 0 the first pair, 1 the second;
// the RMSNorm's dw, the LayerNorm's dw and db): a block of 16 warps a
// 32-column slice, warp i summing blocks i, i + 16, ... in order, then
// warp 0 adding the 16 sums in warp order.
template <typename T>
__global__ void __launch_bounds__(512) partial_sum_kernel(const float* __restrict__ part0,
                                                          T* __restrict__ out0,
                                                          const float* __restrict__ part1,
                                                          T* __restrict__ out1, int n_blocks,
                                                          int d) {
  __shared__ float red[16][33];
  const float* part = blockIdx.y ? part1 : part0;
  T* out = blockIdx.y ? out1 : out0;
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
    out[c] = ps::from_f32<T>(t);
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
                                         DYN_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(layer_norm_bwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_SMEM_MAX);
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rpb = (n + n_blocks - 1) / n_blocks;
  const long long part_bytes = 2LL * d * static_cast<long long>(sizeof(float));
  const int smem_part = part_bytes <= DYN_SMEM_MAX;
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
// n_blocks blocks of VEC_WARPS warps, block b taking rows [b * rpb,
// (b + 1) * rpb) with rpb = ceil(n / n_blocks).  The forward is the
// LayerNorm's with b and mu, the RMSNorm's with both null.
extern "C" int ps_norm_fwd_vec(int device, int dtype, const void* x, const void* w,
                               const void* b, void* y, void* mu, void* rstd, int n, int d,
                               float eps, int n_blocks, void* stream) {
  if (n_blocks <= 0 || (b == nullptr) != (mu == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const int rpb = (n + n_blocks - 1) / n_blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool launched = false;
  with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    launched = with_chunks(vec_chunks(d, sizeof(T), {x, w, b, y}), [&](auto nch) {
      constexpr int NCH = decltype(nch)::value;
      const T* xp = static_cast<const T*>(x);
      const T* wp = static_cast<const T*>(w);
      const T* bp = static_cast<const T*>(b);
      T* yp = static_cast<T*>(y);
      float* mp = static_cast<float*>(mu);
      float* rp = static_cast<float*>(rstd);
      if (b)
        norm_fwd_vec_kernel<T, NCH, true><<<n_blocks, VEC_WARPS * 32, 0, st>>>(
            xp, wp, bp, yp, mp, rp, n, d, rpb, eps);
      else
        norm_fwd_vec_kernel<T, NCH, false><<<n_blocks, VEC_WARPS * 32, 0, st>>>(
            xp, wp, nullptr, yp, nullptr, rp, n, d, rpb, eps);
    });
  });
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The LayerNorm forward's staged route (LAYER_NORM_WIDE_DESIGN), rows at
// any alignment that ln_staged_fits takes, in blocks of LN_WIDE_THREADS,
// at least one for each alignment class that has rows.  Refuses any other
// row.
extern "C" int ps_layer_norm_fwd_staged(int device, int dtype, const void* x, const void* w,
                                        const void* b, void* y, void* mu, void* rstd, int n,
                                        int d, float eps, int n_blocks, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  // once, so that a launch inside CUDA-graph capture makes no attribute call
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(layer_norm_fwd_staged_kernel<__nv_bfloat16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DYN_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(layer_norm_fwd_staged_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_SMEM_MAX);
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool launched = false;
  with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const long long row_bytes = static_cast<long long>(d) * sizeof(T);
    if (!ln_staged_fits(row_bytes)) return;
    const long long stage = ln_stage_bytes(row_bytes);
    int g = 16;  // gcd(row_bytes % 16, 16): the shift repeats every 16 / g rows
    while (row_bytes % g) g /= 2;
    const int period = 16 / g;
    layer_norm_fwd_staged_kernel<T>
        <<<max(n_blocks, min(period, n)), LN_WIDE_THREADS, 4 * stage, st>>>(
            static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
            static_cast<T*>(y), static_cast<float*>(mu), static_cast<float*>(rstd), n, d,
            period, static_cast<int>(stage), eps);
    launched = true;
  });
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The LayerNorm forward's held route (LAYER_NORM_WIDE_DESIGN), rows wider
// than the vectorised cap that the staged route cannot take, at any
// alignment, in blocks of LN_WIDE_THREADS.  Refuses any other row.
extern "C" int ps_layer_norm_fwd_held(int device, int dtype, const void* x, const void* w,
                                      const void* b, void* y, void* mu, void* rstd, int n,
                                      int d, float eps, int n_blocks, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const int rpb = (n + n_blocks - 1) / n_blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool launched = false;
  with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const long long row_bytes = static_cast<long long>(d) * sizeof(T);
    if (row_bytes <= VEC_ROW_BYTES || ln_staged_fits(row_bytes)) return;
    layer_norm_fwd_held_kernel<T><<<n_blocks, LN_WIDE_THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
        static_cast<T*>(y), static_cast<float*>(mu), static_cast<float*>(rstd), n, d, rpb,
        eps);
    launched = true;
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
        rms_norm_bwd_vec_kernel<T, NCH, true><<<n_blocks, VEC_WARPS * 32, 0, st>>>(
            xp, wp, rp, gp, static_cast<T*>(dx), pp, n, d, rpb);
      else
        rms_norm_bwd_vec_kernel<T, NCH, false><<<n_blocks, VEC_WARPS * 32, 0, st>>>(
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
    partial_sum_kernel<T><<<dim3((d + 31) / 32, 1), 512, 0, st>>>(
        static_cast<const float*>(dw_part), static_cast<T*>(dw), nullptr, nullptr, n_blocks, d);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dw and db = the sums over blocks of the LayerNorm backward's two
// [n_blocks, d] fp32 partial buffers (either route), in the weight's
// dtype, in a fixed order: one launch for both.
extern "C" int ps_layer_norm_dwdb_sum(int device, int dtype, const void* dw_part,
                                      const void* db_part, void* dw, void* db, int n_blocks,
                                      int d, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    partial_sum_kernel<T><<<dim3((d + 31) / 32, 2), 512, 0, st>>>(
        static_cast<const float*>(dw_part), static_cast<T*>(dw),
        static_cast<const float*>(db_part), static_cast<T*>(db), n_blocks, d);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
