// The LayerNorm backward's vectorised route (ops/norms.py::ln_bwd_route:
// `vec`), built apart from norms.cu so that the two compile at once.
//
// Replaces ps_slm_tpu/ops/norms.py::_ln_bwd_kernel for rows of a whole
// number of 16-byte chunks up to VEC_ROW_BYTES with 16-byte-aligned x, w, g
// and dx; norms.cu's layer_norm_bwd_kernel (the `wide` route) takes every
// other row, and its partial_sum_kernel sums either route's dw and db
// partial rows.  Bound: bytes, as every norm (norms.cu, the note at its
// top).
//
// LAYER_NORM_BWD_VEC_DESIGN.  The encoder's 560 and 512 (142 launches an
// encoder training step, 760 rows) and the q-former's 768 and 1536 (22 a
// step, 256 rows).  At those widths the wide kernel walked about 6 rows a
// block one at a time, 384 of its 896 threads without a column, two block
// barriers a row, and a PyTorch sum after it: 6x F.layer_norm's backward.
// Here one warp takes one row: a lane reads its x and g chunks (16-byte
// loads) into registers, holds w's for all of the block's rows, forms both
// means by warp shuffles (no block barrier per row) and writes dx as
// 16-byte stores.  With dw/db a lane adds its columns' g * xhat and g terms
// over its rows: in registers up to LN_BWD_REG_COLS columns a lane (d <=
// 768), else in its warp's rows of shared memory (1536: two register sets
// of 48 would spill), laid out so that neighbouring lanes touch
// neighbouring words; then the block's warps' sums are added in warp order
// into one dw and one db partial row (the same bits from run to run).
// Without dw/db no partial row exists and a warp loads its next row before
// the current one's shuffles and stores, as the RMSNorm backward's frozen
// path does.  Padded rows (g = 0) are computed like any other: they add
// nothing.
#include "common.cuh"
#include "vec.cuh"

namespace {

// the LayerNorm backward's vectorised route keeps a lane's dw and db terms
// in registers up to this many columns a lane, in shared memory above
constexpr int LN_BWD_REG_COLS = 24;

// The LayerNorm backward's vectorised route (LAYER_NORM_BWD_VEC_DESIGN at
// the top): a warp per row, VEC_WARPS warps a block taking turns on the
// block's run of rows.  WG: dw and db partial rows, one of each a block.
template <typename T, int NCH, bool WG>
__global__ void __launch_bounds__(VEC_WARPS * 32) layer_norm_bwd_vec_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ mu,
    const float* __restrict__ rstd, const T* __restrict__ g, T* __restrict__ dx,
    float* __restrict__ dw_part, float* __restrict__ db_part, int n, int d,
    int rows_per_block) {
  using P = Pack<T>;
  // a lane's dw and db terms in registers up to this many columns a lane
  // (bf16 d <= 768, fp32 d <= 768), else in its warp's shared-memory rows
  constexpr bool REGS = NCH * P::N <= LN_BWD_REG_COLS;
  constexpr int NA = REGS ? NCH : 1;
  extern __shared__ float acc_s[];  // WG: [VEC_WARPS][2][d], column c * N + k at k * chunks + c
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = d / P::N;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  int row = r0 + warp;
  float* dws = acc_s + 2LL * warp * d;  // this warp's sums (WG)
  float* dbs = dws + d;
  float accw[NA][P::N], accb[NA][P::N];
  if constexpr (WG) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = lane + 32 * j;
#pragma unroll
      for (int k = 0; k < P::N; ++k) {
        if constexpr (REGS) {
          accw[j][k] = accb[j][k] = 0.f;
        } else if (c < chunks) {
          dws[k * chunks + c] = dbs[k * chunks + c] = 0.f;
        }
      }
    }
  }
  uint4 wv[NCH], xv[NCH], gv[NCH];
  load_chunks<NCH>(w, lane, chunks, wv);

  // one row from the lane's x and g chunks: both means by warp shuffles,
  // dx as 16-byte stores, and with WG the row's dw and db terms added to
  // the lane's columns.  Every operation is spelled out (_rn intrinsics),
  // so no instantiation contracts it otherwise: dx is the same bits with
  // and without WG.
  auto one_row = [&](int r_, float m, float rs) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      float xf[P::N], gf[P::N], wf[P::N];
      P::unpack(xv[j], xf);
      P::unpack(gv[j], gf);
      P::unpack(wv[j], wf);
#pragma unroll
      for (int k = 0; k < P::N; ++k) {   // the zeros past the row's end add nothing
        const float gw = __fmul_rn(gf[k], wf[k]);
        s1 = __fadd_rn(s1, gw);
        s2 = __fmaf_rn(gw, __fmul_rn(__fsub_rn(xf[k], m), rs), s2);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / d, m2 = s2 / d;
    uint4* dxr = reinterpret_cast<uint4*>(dx + static_cast<long long>(r_) * d);
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
          const float xh = __fmul_rn(__fsub_rn(xf[k], m), rs);
          o[k] = __fmul_rn(__fsub_rn(__fsub_rn(__fmul_rn(gf[k], wf[k]), m1), __fmul_rn(xh, m2)),
                           rs);
          if constexpr (WG) {
            if constexpr (REGS) {
              accw[j][k] = __fmaf_rn(gf[k], xh, accw[j][k]);
              accb[j][k] = __fadd_rn(accb[j][k], gf[k]);
            } else {
              const int at = k * chunks + c;
              dws[at] = __fmaf_rn(gf[k], xh, dws[at]);
              dbs[at] = __fadd_rn(dbs[at], gf[k]);
            }
          }
        }
        dxr[c] = P::pack(o);
      }
    }
  };

  if constexpr (WG) {
    // the accumulators hold the registers a next row would take
    for (; row < r1; row += VEC_WARPS) {
      const long long off = static_cast<long long>(row) * d;
      load_chunks<NCH>(x + off, lane, chunks, xv);
      load_chunks<NCH>(g + off, lane, chunks, gv);
      one_row(row, mu[row], rstd[row]);
    }
    if constexpr (REGS) {
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int c = lane + 32 * j;
        if (c < chunks) {
#pragma unroll
          for (int k = 0; k < P::N; ++k) {
            dws[k * chunks + c] = accw[j][k];
            dbs[k * chunks + c] = accb[j][k];
          }
        }
      }
    }
    __syncthreads();
    // the warps' sums in warp order: the partial rows are the same bits
    // from run to run
    const long long blk = static_cast<long long>(blockIdx.x) * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const int at = (i % P::N) * chunks + i / P::N;
      float sw = acc_s[at], sb = acc_s[d + at];
#pragma unroll
      for (int wi = 1; wi < VEC_WARPS; ++wi) {
        sw += acc_s[2LL * wi * d + at];
        sb += acc_s[2LL * wi * d + d + at];
      }
      dw_part[blk + i] = sw;
      db_part[blk + i] = sb;
    }
  } else {
    float m = 0.f, rs = 0.f;
    if (row < r1) {
      const long long off = static_cast<long long>(row) * d;
      load_chunks<NCH>(x + off, lane, chunks, xv);
      load_chunks<NCH>(g + off, lane, chunks, gv);
      m = mu[row];
      rs = rstd[row];
    }
    for (; row < r1; row += VEC_WARPS) {
      const int next = row + VEC_WARPS;
      uint4 xn[NCH], gn[NCH];
      float mn = 0.f, rn = 0.f;
      if (next < r1) {
        const long long off = static_cast<long long>(next) * d;
        load_chunks<NCH>(x + off, lane, chunks, xn);
        load_chunks<NCH>(g + off, lane, chunks, gn);
        mn = mu[next];
        rn = rstd[next];
      }
      one_row(row, m, rs);
      if (next < r1) {
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          xv[j] = xn[j];
          gv[j] = gn[j];
        }
        m = mn;
        rs = rn;
      }
    }
  }
}

}  // namespace

// The LayerNorm backward's vectorised route (LAYER_NORM_BWD_VEC_DESIGN), for
// the rows and pointers vec_chunks takes; refuses others.  dw_part and
// db_part both null: no dw or db (frozen weights); else one partial row of
// each a block, the warps' sums in [VEC_WARPS][2][d] fp32 of dynamic
// shared memory.  n_blocks blocks of VEC_WARPS warps, block b taking rows
// [b * rpb, (b + 1) * rpb) with rpb = ceil(n / n_blocks).
extern "C" int ps_layer_norm_bwd_vec(int device, int dtype, const void* x, const void* w,
                                     const void* mu, const void* rstd, const void* g, void* dx,
                                     void* dw_part, void* db_part, int n, int d, int n_blocks,
                                     void* stream) {
  if (n_blocks <= 0 || (dw_part == nullptr) != (db_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const int rpb = (n + n_blocks - 1) / n_blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  bool launched = false;
  with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    launched = with_chunks(vec_chunks(d, sizeof(T), {x, w, g, dx}), [&](auto nch) {
      constexpr int NCH = decltype(nch)::value;
      const T* xp = static_cast<const T*>(x);
      const T* wp = static_cast<const T*>(w);
      const T* gp = static_cast<const T*>(g);
      const float* mp = static_cast<const float*>(mu);
      const float* rp = static_cast<const float*>(rstd);
      if (dw_part) {
        // once for each instantiation, so that a launch inside CUDA-graph
        // capture makes no attribute call: its widest row's sums
        static const cudaError_t configured = cudaFuncSetAttribute(
            layer_norm_bwd_vec_kernel<T, NCH, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            VEC_WARPS * 2 * NCH * 32 * Pack<T>::N * static_cast<int>(sizeof(float)));
        err = configured;
        if (err != cudaSuccess) return;
        const int smem = VEC_WARPS * 2 * d * static_cast<int>(sizeof(float));
        layer_norm_bwd_vec_kernel<T, NCH, true><<<n_blocks, VEC_WARPS * 32, smem, st>>>(
            xp, wp, mp, rp, gp, static_cast<T*>(dx), static_cast<float*>(dw_part),
            static_cast<float*>(db_part), n, d, rpb);
      } else {
        layer_norm_bwd_vec_kernel<T, NCH, false><<<n_blocks, VEC_WARPS * 32, 0, st>>>(
            xp, wp, mp, rp, gp, static_cast<T*>(dx), nullptr, nullptr, n, d, rpb);
      }
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
