// Grouped expert GEMMs of DeepSeek-V3's routed experts
// (ps_slm_tpu_torch/ops/moe.py), bf16 on the tensor cores with fp32
// accumulation.  Replaces no TPU kernel: the JAX package runs no mixture of
// experts.
//
// Rows reach a block through `sorted_ids`: the (token, choice) pairs sorted
// by expert, each expert's run padded to the tile's BM rows with the
// sentinel `n_pairs`; `tile_expert` holds each tile's expert, the expert
// count past the used tiles (ops/moe.py::align, vLLM's fused_moe layout).
// The grid is (tiles of the static bound, output column blocks); a block
// of an unused tile returns at once, so nothing's shape depends on the
// routing and a CUDA graph records the launch.  A block computes BN output
// columns of one tile: it gathers the tile's rows and streams one block of
// its expert's weights through a cp.async pipeline of STAGES stages of 64
// deep, so each (expert, tile) weight block is read once.
//
//   moe_grouped_gemm_gate_up: h[pair] = silu(x[token] . gate) * (x[token] . up)
//     over gate_up [E, 2I, H] (gate rows first), rounded once to bf16;
//   moe_grouped_gemm_down:    y[pair] = weight[pair] * (h[pair] . down)
//     over down [E, H, I], in fp32.
//
// Two shapes of block, chosen by the caller: decode steps (a few rows an
// expert, bytes bound) take tiles of 16 rows and 4 stages; prefills
// (thousands of rows, operations bound) tiles of 64 rows and 3 stages.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BK = 64;  // depth a stage: 8 chunks of 16 bytes a row

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// BM rows a tile, BN output columns a block, WM x WN warps (each TM x TN),
// STAGES stages in flight
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;
  static constexpr int MI = TM / 16, NI = TN / 8;
  static_assert(TM % 16 == 0 && TN % 16 == 0, "a warp's tile is whole 16 x 16 fragments");
};

using Small = Cfg<16, 64, 1, 4, 4>;       // decode steps
using LargeGateUp = Cfg<64, 64, 2, 2, 3>;  // prefills
using LargeDown = Cfg<64, 128, 2, 2, 3>;

template <class C, bool GATE_UP>
__host__ __device__ constexpr int b_rows() {
  return GATE_UP ? 2 * C::BN : C::BN;  // gate_up: BN gate rows, then BN up rows
}
template <class C, bool GATE_UP>
__host__ __device__ constexpr int smem_bytes() {
  return C::STAGES * (C::BM + b_rows<C, GATE_UP>()) * BK * static_cast<int>(sizeof(bf16));
}

// a: the rows (gate_up: x [T, K], a pair's row its token = pair / top_k;
// down: h [pairs, K], a pair's row itself); w: [E, n_total, K] with the
// output rows [0, N) (and, for gate_up, the up rows [N, 2N)); out: gate_up
// h [pairs, N] bf16, down y [pairs, N] fp32 times wts[pair].
template <class C, bool GATE_UP>
__device__ __forceinline__ void grouped(unsigned char* smem, const bf16* __restrict__ a,
                                        const bf16* __restrict__ w, void* __restrict__ out,
                                        const float* __restrict__ wts,
                                        const int* __restrict__ ids,
                                        const int* __restrict__ tile_expert, int n_pairs,
                                        int top_k, int K, int N, int n_exp) {
  constexpr int BR = b_rows<C, GATE_UP>();
  constexpr int A_ELEMS = C::BM * BK, B_ELEMS = BR * BK;
  __shared__ long long a_row[C::BM];  // element offset of each row in a, -1 for padding
  __shared__ int pair_of[C::BM];

  const int tile = blockIdx.x;
  const int e = tile_expert[tile];
  if (e >= n_exp) return;  // past the used tiles
  const int n0 = blockIdx.y * C::BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane >> 2, t4 = lane & 3;

  for (int r = tid; r < C::BM; r += C::THREADS) {
    const int pair = ids[tile * C::BM + r];
    const bool ok = pair < n_pairs;
    pair_of[r] = ok ? pair : -1;
    a_row[r] = ok ? static_cast<long long>(pair / top_k) * K : -1;
  }
  __syncthreads();

  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + C::STAGES * A_ELEMS;
  const int n_total = GATE_UP ? 2 * N : N;
  const bf16* we = w + static_cast<long long>(e) * n_total * K;

  auto stage = [&](int slot, int k0) {
    bf16* as = a_s + slot * A_ELEMS;
    bf16* bs = b_s + slot * B_ELEMS;
    for (int i = tid; i < C::BM * (BK / 8); i += C::THREADS) {
      const int r = i >> 3, c = (i & 7) << 3;
      const long long off = a_row[r];
      const bool ok = off >= 0 && k0 + c < K;
      ps::cp_async16(as + ps::swz<BK>(r, c), a + (ok ? off + k0 + c : 0), ok);
    }
    for (int i = tid; i < BR * (BK / 8); i += C::THREADS) {
      const int r = i >> 3, c = (i & 7) << 3;
      const int col = n0 + (r < C::BN ? r : r - C::BN);
      const int row = r < C::BN ? col : N + col;
      const bool ok = col < N && k0 + c < K;
      const long long off = static_cast<long long>(row) * K + k0 + c;
      ps::cp_async16(bs + ps::swz<BK>(r, c), we + (ok ? off : 0), ok);
    }
  };

  float acc[C::MI][C::NI][4];
  float acc_u[GATE_UP ? C::MI : 1][GATE_UP ? C::NI : 1][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[mi][ni][q] = 0.f;
        if constexpr (GATE_UP) acc_u[mi][ni][q] = 0.f;
      }

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) stage(s, s * BK);
    ps::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage kt has landed; every reader of stage kt - 1 is done
    const int next = kt + C::STAGES - 1;
    if (next < nk) stage(next % C::STAGES, next * BK);
    ps::cp_async_commit();
    const bf16* as = a_s + (kt % C::STAGES) * A_ELEMS;
    const bf16* bs = b_s + (kt % C::STAGES) * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[C::MI][4];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        ps::ldsm_x4(af[mi], ps::a_frag_addr<BK>(as, wm * C::TM + mi * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < C::NI / 2; ++np) {
        uint32_t bf[4];
        ps::ldsm_x4(bf, ps::bt_frag_addr<BK>(bs, wn * C::TN + np * 16, kk * 16, lane));
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi) {
          ps::mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          ps::mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
        if constexpr (GATE_UP) {
          ps::ldsm_x4(bf, ps::bt_frag_addr<BK>(bs, C::BN + wn * C::TN + np * 16, kk * 16, lane));
#pragma unroll
          for (int mi = 0; mi < C::MI; ++mi) {
            ps::mma_bf16(acc_u[mi][2 * np], af[mi], bf[0], bf[1]);
            ps::mma_bf16(acc_u[mi][2 * np + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }

  // C fragment: (row g, cols 2t, 2t+1) and (row g + 8, the same cols)
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pair = pair_of[wm * C::TM + mi * 16 + g + 8 * half];
      if (pair < 0) continue;
      const float wt = GATE_UP ? 1.f : wts[pair];
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        const int col = n0 + wn * C::TN + ni * 8 + 2 * t4;
        if (col >= N) continue;
        const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if constexpr (GATE_UP) {
          const float u0 = acc_u[mi][ni][2 * half], u1 = acc_u[mi][ni][2 * half + 1];
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                             static_cast<long long>(pair) * N + col) =
              __floats2bfloat162_rn(v0 / (1.f + __expf(-v0)) * u0, v1 / (1.f + __expf(-v1)) * u1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + static_cast<long long>(pair) * N +
                                     col) = make_float2(v0 * wt, v1 * wt);
        }
      }
    }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
    moe_grouped_gemm_gate_up(const bf16* __restrict__ x, const bf16* __restrict__ w,
                             bf16* __restrict__ h, const int* __restrict__ ids,
                             const int* __restrict__ tile_expert, int n_pairs, int top_k,
                             int hidden, int inter, int n_exp) {
  extern __shared__ __align__(128) unsigned char moe_smem[];
  grouped<C, true>(moe_smem, x, w, h, nullptr, ids, tile_expert, n_pairs, top_k, hidden, inter,
                   n_exp);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
    moe_grouped_gemm_down(const bf16* __restrict__ h, const bf16* __restrict__ w,
                          const float* __restrict__ wts, float* __restrict__ y,
                          const int* __restrict__ ids, const int* __restrict__ tile_expert,
                          int n_pairs, int inter, int hidden, int n_exp) {
  extern __shared__ __align__(128) unsigned char moe_smem[];
  grouped<C, false>(moe_smem, h, w, y, wts, ids, tile_expert, n_pairs, 1, inter, hidden, n_exp);
}

// once, so that a launch inside CUDA-graph capture makes no attribute call
cudaError_t configure() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(moe_grouped_gemm_gate_up<Small>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<Small, true>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_grouped_gemm_gate_up<LargeGateUp>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<LargeGateUp, true>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_grouped_gemm_down<Small>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<Small, false>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_grouped_gemm_down<LargeDown>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<LargeDown, false>());
    return e;
  }();
  return err;
}

template <class C>
int gate_up(const void* x, const void* w, void* h, const void* ids, const void* tile_expert,
            int n_pairs, int top_k, int tiles, int hidden, int inter, int n_exp,
            cudaStream_t st) {
  const dim3 grid(tiles, (inter + C::BN - 1) / C::BN);
  moe_grouped_gemm_gate_up<C><<<grid, C::THREADS, smem_bytes<C, true>(), st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(h),
      static_cast<const int*>(ids), static_cast<const int*>(tile_expert), n_pairs, top_k, hidden,
      inter, n_exp);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int down(const void* h, const void* w, const void* wts, void* y, const void* ids,
         const void* tile_expert, int n_pairs, int tiles, int inter, int hidden, int n_exp,
         cudaStream_t st) {
  const dim3 grid(tiles, (hidden + C::BN - 1) / C::BN);
  moe_grouped_gemm_down<C><<<grid, C::THREADS, smem_bytes<C, false>(), st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const float*>(wts),
      static_cast<float*>(y), static_cast<const int*>(ids), static_cast<const int*>(tile_expert),
      n_pairs, inter, hidden, n_exp);
  return static_cast<int>(cudaGetLastError());
}

bool dims_ok(int hidden, int inter, int tiles, int n_exp) {
  return hidden > 0 && inter > 0 && hidden % 8 == 0 && inter % 8 == 0 && tiles > 0 && n_exp > 0;
}

}  // namespace

// `large` picks the prefills' block shape (tiles of 64 rows) over the decode
// steps' (16 rows): sorted_ids must be padded to that tile (ops/moe.py's
// TILE_ROWS).
// h [n_pairs, inter] bf16 = silu(x . gate) * (x . up) of each pair's expert;
// x [T, hidden], w [n_exp, 2 inter, hidden], bf16; sorted_ids [tiles * BM],
// tile_expert [tiles] int32.
extern "C" int ps_moe_gate_up(int device, int large, const void* x, const void* w, void* h,
                              const void* sorted_ids, const void* tile_expert, int n_pairs,
                              int top_k, int tiles, int hidden, int inter, int n_exp,
                              void* stream) {
  if (!dims_ok(hidden, inter, tiles, n_exp) || top_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaError_t configured = configure();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return large ? gate_up<LargeGateUp>(x, w, h, sorted_ids, tile_expert, n_pairs, top_k, tiles,
                                      hidden, inter, n_exp, st)
               : gate_up<Small>(x, w, h, sorted_ids, tile_expert, n_pairs, top_k, tiles, hidden,
                                inter, n_exp, st);
}

// y [n_pairs, hidden] fp32 = wts[pair] * (h . down) of each pair's expert;
// h [n_pairs, inter], w [n_exp, hidden, inter], bf16; wts [n_pairs] fp32.
extern "C" int ps_moe_down(int device, int large, const void* h, const void* w, const void* wts,
                           void* y, const void* sorted_ids, const void* tile_expert, int n_pairs,
                           int tiles, int inter, int hidden, int n_exp, void* stream) {
  if (!dims_ok(hidden, inter, tiles, n_exp)) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaError_t configured = configure();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return large ? down<LargeDown>(h, w, wts, y, sorted_ids, tile_expert, n_pairs, tiles, inter,
                                 hidden, n_exp, st)
               : down<Small>(h, w, wts, y, sorted_ids, tile_expert, n_pairs, tiles, inter,
                             hidden, n_exp, st);
}
