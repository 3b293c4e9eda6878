// Flash-attention backward: dq, and dk/dv, with GQA, a per-batch-row valid
// key window and an optional causal mask.
//
// Replaces the TPU kernels ps_slm_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (called from _flash_bwd).  Same function: with the forward's
// fp32 log-sum-exp `lse` and delta = rowsum(dout * out) (computed outside the
// kernels, as _flash_bwd does),
//   p  = exp(q.k * scale - lse) on valid (query, key) pairs, else 0 (a
//        select, never a multiply by a 0/1 mask: a query row with no valid
//        key has lse = NEG_INF and exp overflows there)
//   ds = p * (dout.v - delta)
//   dq = sum over keys of ds * k * scale
//   dk = sum over queries and the query heads of the key's group of
//        ds * q * scale,  dv = the same sum of p * dout.
// Outputs are in the input dtype; every sum is fp32.
//
// Layout: q, dout, out, dq [B, S, Hq, 128]; k, v, dk, dv [B, T, Hkv, 128];
// lse and delta [B, Hq, S] fp32.  Query head h belongs to key/value head
// h / (Hq / Hkv).
//
// Bound: at the training shape (5 x 543, 12/2 heads, causal, D = 128, bf16)
// dq must move 22.5 MB and dk/dv 22.5 MB (6.7 us at 3.35 TB/s) and do 6 and
// 8 x 128 flops per valid pair, 6.8 and 9.1 GFLOP (6.9 and 9.2 us on the
// bf16 tensor cores): both sit near the ridge, dk/dv set by operations.
//
// In bf16 both dq and dk/dv are on the tensor cores.  fp32 keeps kernels
// that compute every product with fp32 FMAs from shared memory, because the
// bf16 tensor cores cannot take fp32 operands and TF32 (10-bit mantissa)
// would break the fp32 tolerances (2e-5 against the plain version, 1e-3 for
// the fp32 training path against the CPU).  The dtype alone picks the
// kernel.
//  * dq, fp32 (flash_dq_kernel<float>): one block of 256 threads per
//    (64-row query tile, query head, batch row).  It stages its q and dout
//    tiles once, then walks 64-row key/value tiles inside [kv_start,
//    kv_end) and at or below the diagonal, keeping dq in registers until
//    one store.  Thread (tr, tc) = (tid / 16, tid % 16) owns score rows
//    tr + 16 i and columns tc + 16 j (i, j < 4), then dq rows tr + 16 i by
//    head-dim columns tc + 16 j (j < 8).
//  * dq, bf16 (flash_dq_bf16_kernel): the same grid, launched in
//    descending query-tile order so that under a causal mask the longest
//    blocks (the last query tiles, 9 key tiles at the training shape)
//    start first; one warpgroup (4 warps) a block, warp w on query rows
//    16w..16w+15 as in flash_fwd.cu.  Per half key tile (32 keys; the
//    whole 64-key tile's S and dP beside dq spilled at 255 registers) each
//    warp computes S = Q K^T and dP = dO V^T with mma.sync.m16n8k16 (Q and
//    dO through ldmatrix at each 16-deep step, K and V as the transposed B
//    operand), takes ds = p (dp - delta) as a select on the valid pairs in
//    S's registers, and adds dS K into 64 fp32 registers, dS packed to
//    bf16 A fragments straight from registers (rounded once; the emulation
//    in tests/test_torch_flash_numerics.py shows that fits dq's bf16
//    tolerance, unlike dv's) and K through ldmatrix.trans: 192 mma.sync a
//    warp and key tile.  A half with no valid pair for the warp's rows
//    (above the diagonal, outside the window) is skipped.  Q and dO are
//    staged once; K and V are double-buffered with cp.async, the next key
//    tile copied while this one is computed.  96 KB of shared memory, two
//    blocks an SM.  dq has no cross-block sum: the same bits on every call.
//  * dk/dv, fp32: one block per (64-row key tile, key/value head, batch
//    row).  It stages its k and v tiles once, then loops over the Hq / Hkv
//    query heads of its group and the query tiles from the diagonal on,
//    computing the transposed scores (key rows x query columns) so that dk
//    and dv accumulate in registers, with no atomics and no second pass.
//    Shared rows are padded to 129 (65) floats against bank conflicts.
//  * dk/dv, bf16 (flash_dkv_bf16_kernel): that grid has 90 blocks at the
//    training shape for 132 SMs, and the first key tile's block walks 6
//    heads x 9 query tiles, 54 steps, so the longest block set the time.
//    Here the query-head loop is split over the grid: one block of two
//    warpgroups (8 warps, 256 threads) per (64-row key tile, QUERY head,
//    batch row), 540 blocks, the longest walking 9 query tiles, launched
//    in key-tile order so that under a causal mask the longest start
//    first.  Each block writes its head's fp32 partial dk and dv to a
//    [2, B, T, Hq, 128] scratch (the wrapper allocates it), and
//    dkv_reduce_kernel sums the Hq / Hkv partials of each key/value head
//    in a fixed order and rounds to bf16: no atomics, the same bits on
//    every call, at the cost of 33 MB written and read at the training
//    shape (~20 us at the memory rate, less from L2).
//    Warps w and w + 4 share key rows 16 (w % 4) .. + 15.  Each computes
//    S^T = K Q^T and dP^T = V dO^T for 32 of the 64 query columns with
//    mma.sync.m16n8k16 (bf16 operands, fp32 accumulation; mma.cuh), takes
//    p and ds as selects on the valid pairs in registers, and writes them
//    to shared memory split into bf16 hi + lo (lo = bf16(x - hi), ~16
//    significant bits).  After a barrier of the two warps, each takes one
//    head-dim half: dV += P^T dO and dK += dS^T Q over all 64 queries,
//    each product twice (hi and lo), with dO and Q through
//    ldmatrix.trans.  So dk and dv are 64 fp32 registers a thread (the
//    whole head dim in one warp, 128, spilled at 255), and no score is
//    computed twice.  One rounding of P and dS to bf16 (the forward's
//    choice, and FlashAttention-2/3's) breaks the bf16 tolerance of dv at
//    the training shape; tests/test_torch_flash_numerics.py emulates both.
//    K and V are staged once; q, dout, lse and delta are double-buffered
//    with cp.async, the next query tile copied while this one is
//    computed; tiles are swizzled as in flash_fwd.cu, and P^T / dS^T the
//    same way in 64-wide rows.  129 KB of shared memory: one block, 8
//    warps, an SM.
// Ragged S and T are handled by guards and zero-filled copies, with no
// padding of the inputs.  A key tile wholly outside the window writes
// zeros.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int ROW = D + 1;
constexpr int P_ROW = 64 + 1;
constexpr int DQ_SMEM_BYTES =
    (2 * BQ * ROW + 2 * BK * ROW + BQ * P_ROW) * static_cast<int>(sizeof(float));
constexpr int DKV_SMEM_BYTES =
    (2 * BK * ROW + 2 * BQ * ROW + 2 * BK * P_ROW + 2 * BQ) *
    static_cast<int>(sizeof(float));

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DKV_TC_THREADS = 256;  // two warpgroups
// k, v, 2 x q, 2 x dout (bf16 tiles), P^T and dS^T hi and lo (bf16, 64 x
// 64), 2 x lse, 2 x delta (fp32 rows)
constexpr int TC_DKV_SMEM_BYTES = (6 * ps::kTile + 4 * BK * BQ) * static_cast<int>(sizeof(bf16)) +
                                  4 * BQ * static_cast<int>(sizeof(float));
// q, dout, 2 x k, 2 x v (bf16 tiles): 96 KB, two blocks an SM
constexpr int TC_DQ_SMEM_BYTES = 6 * ps::kTile * static_cast<int>(sizeof(bf16));

// rows [row0, row0 + 64) of a [rows, heads, 128] tensor's head into a
// padded shared tile; rows past `rows` read as 0
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, long long row_stride) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int s = row0 + r;
    dst[r * ROW + c] = s < rows ? ps::to_f32(src[s * row_stride + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const int* __restrict__ kv_start,
                    const int* __restrict__ kv_end, int S, int Tk, int Hq,
                    int Hkv, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // [BQ][ROW]
  float* do_s = q_s + BQ * ROW;       // [BQ][ROW]
  float* k_s = do_s + BQ * ROW;       // [BK][ROW]
  float* v_s = k_s + BK * ROW;        // [BK][ROW]
  float* ds_s = v_s + BK * ROW;       // [BQ][P_ROW]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int start = kv_start[b];
  const int end = kv_end[b];

  const long long q_row = static_cast<long long>(Hq) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const long long q_off = (static_cast<long long>(b) * S * Hq + h) * D;
  const long long kv_off = (static_cast<long long>(b) * Tk * Hkv + hk) * D;
  const float* lse_b = lse + (static_cast<long long>(b) * Hq + h) * S;
  const float* delta_b = delta + (static_cast<long long>(b) * Hq + h) * S;

  load_tile(q_s, q + q_off, q0, S, q_row);
  load_tile(do_s, dout + q_off, q0, S, q_row);
  float lse_r[4], delta_r[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + tr + 16 * i;
    lse_r[i] = s < S ? lse_b[s] : 0.f;
    delta_r[i] = s < S ? delta_b[s] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int hi = causal ? min(end, q0 + BQ) : end;
  const int k_begin = (start / BK) * BK;
  for (int k0 = k_begin; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers of k_s, v_s, ds_s are done
    load_tile(k_s, k + kv_off, k0, Tk, kv_row);
    load_tile(v_s, v + kv_off, k0, Tk, kv_row);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(tr + 16 * i) * ROW + d];
        ov[i] = do_s[(tr + 16 * i) * ROW + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(tc + 16 * j) * ROW + d];
        vv[j] = v_s[(tc + 16 * j) * ROW + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        const bool ok = qpos < S && kpos >= start && kpos < end &&
                        (!causal || kpos <= qpos);
        const float p = ok ? expf(sc[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(tr + 16 * i) * P_ROW + tc + 16 * j] =
            ok ? p * (dp[i][j] - delta_r[i]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(tr + 16 * i) * P_ROW + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = k_s[c * ROW + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  T* dq_b = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + tr + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dq_b[s * q_row + tc + 16 * j] = ps::from_f32<T>(acc[i][j] * scale);
  }
}

__global__ void __launch_bounds__(ps::kTcThreads, 2)
    flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, const int* __restrict__ kv_start,
                         const int* __restrict__ kv_end, int B, int S, int Tk, int Hq,
                         int Hkv, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);   // [kTile], swizzled
  bf16* do_s = q_s + ps::kTile;                    // [kTile]
  bf16* k_s = do_s + ps::kTile;                    // [2][kTile]
  bf16* v_s = k_s + 2 * ps::kTile;                 // [2][kTile]

  // blocks in descending order of query tile, then query head and batch
  // row: under a causal mask the last query tiles walk the most key tiles,
  // so the longest blocks start first and the short ones fill the tail
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / (Hq * B)) * BQ;
  const int h = (blockIdx.x % (Hq * B)) % Hq;
  const int b = (blockIdx.x % (Hq * B)) / Hq;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int r_w = (threadIdx.x >> 5) * 16;  // this warp's first row of the tile
  const int g = lane >> 2, t4 = lane & 3;
  const int start = kv_start[b];
  const int end = kv_end[b];

  const long long q_row = static_cast<long long>(Hq) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const long long q_off = (static_cast<long long>(b) * S * Hq + h) * D;
  const bf16* kb = k + (static_cast<long long>(b) * Tk * Hkv + hk) * D;
  const bf16* vb = v + (static_cast<long long>(b) * Tk * Hkv + hk) * D;
  const float* lse_b = lse + (static_cast<long long>(b) * Hq + h) * S;
  const float* delta_b = delta + (static_cast<long long>(b) * Hq + h) * S;

  const int hi = causal ? min(end, q0 + BQ) : end;
  const int k_begin = (start / BK) * BK;
  const int n_tiles = hi > k_begin ? (hi - k_begin + BK - 1) / BK : 0;
  if (n_tiles > 0) {
    ps::stage_tile(q_s, q + q_off, q0, S, q_row);
    ps::stage_tile(do_s, dout + q_off, q0, S, q_row);
    ps::stage_tile(k_s, kb, k_begin, Tk, kv_row);
    ps::stage_tile(v_s, vb, k_begin, Tk, kv_row);
    ps::cp_async_commit();
  }

  // rows r_w + g (i = 0) and r_w + g + 8 (i = 1) of the tile: -lse in
  // log2 units and delta, then dq (unscaled) by 16 8-wide head-dim tiles
  float nl[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + r_w + g + 8 * i;
    nl[i] = s < S ? -lse_b[s] * LOG2E : 0.f;
    dl[i] = s < S ? delta_b[s] : 0.f;
  }
  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale2 = scale * LOG2E;

  for (int j = 0; j < n_tiles; ++j) {
    ps::cp_async_wait_all();
    __syncthreads();  // tile j has landed; every reader of tile j - 1 is done
    const int k0 = k_begin + j * BK;
    const bf16* ks = k_s + (j & 1) * ps::kTile;
    const bf16* vs = v_s + (j & 1) * ps::kTile;
    if (j + 1 < n_tiles) {
      ps::stage_tile(k_s + ((j + 1) & 1) * ps::kTile, kb, k0 + BK, Tk, kv_row);
      ps::stage_tile(v_s + ((j + 1) & 1) * ps::kTile, vb, k0 + BK, Tk, kv_row);
      ps::cp_async_commit();
    }

    // the tile's 64 keys in two halves of 32, so that S and dP of a half
    // (16 + 16 registers) sit beside dq's 64 without spilling
#pragma unroll 1
    for (int c0 = 0; c0 < BK; c0 += 32) {
      // a half with no valid pair for this warp's rows adds nothing
      const int kh = k0 + c0;
      if (kh >= end || kh + 32 <= start || (causal && kh > q0 + r_w + 15)) continue;
      // S = Q K^T and dP = dO V^T: 16 rows x 32 keys a warp, Q and dO read
      // through ldmatrix at each 16-deep step
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      // unrolled by 2 only: fully unrolled, the loads hoisted ahead of
      // their products spill
#pragma unroll 2
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t qa[4], oa[4];
        ps::ldsm_x4(qa, ps::a_frag_addr(q_s, r_w, kk * 16, lane));
        ps::ldsm_x4(oa, ps::a_frag_addr(do_s, r_w, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4], bv[4];
          ps::ldsm_x4(bk, ps::bt_frag_addr(ks, c0 + np * 16, kk * 16, lane));
          ps::ldsm_x4(bv, ps::bt_frag_addr(vs, c0 + np * 16, kk * 16, lane));
          ps::mma_bf16(sc[2 * np], qa, bk[0], bk[1]);
          ps::mma_bf16(sc[2 * np + 1], qa, bk[2], bk[3]);
          ps::mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
          ps::mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
        }
      }

      // p and ds as selects on the valid pairs (a query row with no valid
      // key has lse = NEG_INF, where exp overflows); ds in place of s
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int qpos = q0 + r_w + g + 8 * i;
          const int kpos = k0 + c0 + n * 8 + 2 * t4 + (e & 1);
          const bool ok = qpos < S && kpos >= start && kpos < end && (!causal || kpos <= qpos);
          const float p = exp2f(fmaf(sc[n][e], scale2, nl[i]));
          sc[n][e] = ok ? p * (dp[n][e] - dl[i]) : 0.f;
        }

      // dq += dS K: dS from the score registers, rounded to bf16 once; K
      // through ldmatrix.trans, its rows being this product's k index
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t sa[4];
        ps::c_to_a(sa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < 8; ++dp2) {
          uint32_t bk[4];
          ps::ldsm_x4_trans(bk, ps::b_frag_addr(ks, c0 + kk * 16, dp2 * 16, lane));
          ps::mma_bf16(acc[2 * dp2], sa, bk[0], bk[1]);
          ps::mma_bf16(acc[2 * dp2 + 1], sa, bk[2], bk[3]);
        }
      }
    }
  }

  // rows past S are not written; a tile with no key in its window writes
  // zeros
  bf16* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + r_w + g + 8 * i;
    if (s >= S) continue;
    bf16* row = dqb + s * q_row + 2 * t4;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

__global__ void __launch_bounds__(THREADS)
    flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, const int* __restrict__ kv_start,
                     const int* __restrict__ kv_end, int S, int Tk, int Hq,
                     int Hkv, float scale, int causal) {
  extern __shared__ float smem[];
  float* k_s = smem;                  // [BK][ROW]
  float* v_s = k_s + BK * ROW;        // [BK][ROW]
  float* q_s = v_s + BK * ROW;        // [BQ][ROW]
  float* do_s = q_s + BQ * ROW;       // [BQ][ROW]
  float* p_s = do_s + BQ * ROW;       // [BK][P_ROW], key rows x query columns
  float* ds_s = p_s + BK * P_ROW;     // [BK][P_ROW]
  float* lse_s = ds_s + BK * P_ROW;   // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int start = kv_start[b];
  const int end = kv_end[b];

  const long long q_row = static_cast<long long>(Hq) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const long long kv_off = (static_cast<long long>(b) * Tk * Hkv + hk) * D;

  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  if (k0 < end && k0 + BK > start) {
    load_tile(k_s, k + kv_off, k0, Tk, kv_row);
    load_tile(v_s, v + kv_off, k0, Tk, kv_row);
    // causal: query rows before the tile's first key see none of its keys
    const int q_begin = causal ? (k0 / BQ) * BQ : 0;
    for (int r = 0; r < n_rep; ++r) {
      const int h = hk * n_rep + r;
      const long long q_off = (static_cast<long long>(b) * S * Hq + h) * D;
      const float* lse_b = lse + (static_cast<long long>(b) * Hq + h) * S;
      const float* delta_b = delta + (static_cast<long long>(b) * Hq + h) * S;
      for (int q0 = q_begin; q0 < S; q0 += BQ) {
        __syncthreads();  // the previous tile's readers are done
        load_tile(q_s, q + q_off, q0, S, q_row);
        load_tile(do_s, dout + q_off, q0, S, q_row);
        if (tid < BQ) {
          const int s = q0 + tid;
          lse_s[tid] = s < S ? lse_b[s] : 0.f;
          delta_s[tid] = s < S ? delta_b[s] : 0.f;
        }
        __syncthreads();

        float sc[4][4], dp[4][4];  // [key row i][query column j]
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
        for (int d = 0; d < D; ++d) {
          float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kv[i] = k_s[(tr + 16 * i) * ROW + d];
            vv[i] = v_s[(tr + 16 * i) * ROW + d];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qv[j] = q_s[(tc + 16 * j) * ROW + d];
            ov[j] = do_s[(tc + 16 * j) * ROW + d];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
              dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
            }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = k0 + tr + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = tc + 16 * j;
            const int qpos = q0 + col;
            const bool ok = qpos < S && kpos >= start && kpos < end &&
                            (!causal || kpos <= qpos);
            const float p = ok ? expf(sc[i][j] * scale - lse_s[col]) : 0.f;
            p_s[(tr + 16 * i) * P_ROW + col] = p;
            ds_s[(tr + 16 * i) * P_ROW + col] =
                ok ? p * (dp[i][j] - delta_s[col]) : 0.f;
          }
        }
        __syncthreads();

#pragma unroll 2
        for (int c = 0; c < BQ; ++c) {
          float pv[4], dsv[4], ov[8], qv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pv[i] = p_s[(tr + 16 * i) * P_ROW + c];
            dsv[i] = ds_s[(tr + 16 * i) * P_ROW + c];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            ov[j] = do_s[c * ROW + tc + 16 * j];
            qv[j] = q_s[c * ROW + tc + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
              dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
            }
        }
      }
    }
  }

  float* dk_b = dk + kv_off;
  float* dv_b = dv + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + tr + 16 * i;
    if (t >= Tk) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dk_b[t * kv_row + tc + 16 * j] = dk_acc[i][j] * scale;
      dv_b[t * kv_row + tc + 16 * j] = dv_acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(DKV_TC_THREADS, 1)
    flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ part,
                          const int* __restrict__ kv_start,
                          const int* __restrict__ kv_end, int B, int S, int Tk,
                          int Hq, int Hkv, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(tc_smem);   // [kTile], swizzled
  bf16* v_s = k_s + ps::kTile;                     // [kTile]
  bf16* q_s = v_s + ps::kTile;                     // [2][kTile]
  bf16* do_s = q_s + 2 * ps::kTile;                // [2][kTile]
  // P^T and dS^T of one query tile, bf16 hi and lo: [4][BK][BQ], swizzled
  bf16* pt_s = do_s + 2 * ps::kTile;
  float* lse_s = reinterpret_cast<float*>(pt_s + 4 * BK * BQ);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                               // [2][BQ]
  bf16* p_hi = pt_s;
  bf16* p_lo = pt_s + BK * BQ;
  bf16* ds_hi = pt_s + 2 * BK * BQ;
  bf16* ds_lo = pt_s + 3 * BK * BQ;

  // blocks in order of key tile, then query head and batch row: with
  // causal masks the first key tiles walk the most query tiles, so the
  // longest blocks start first and the short ones fill the tail
  const int k0 = (blockIdx.x / (Hq * B)) * BK;
  const int h = (blockIdx.x % (Hq * B)) % Hq;
  const int b = (blockIdx.x % (Hq * B)) / Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r_w = (warp & 3) * 16;   // this warp's first key row of the tile
  const int c0 = (warp >> 2) * 32;   // its query columns for the scores ...
  const int d0 = (warp >> 2) * 64;   // ... and its head-dim columns of dk, dv
  const int g = lane >> 2, t4 = lane & 3;
  const int start = kv_start[b];
  const int end = kv_end[b];

  const long long q_row = static_cast<long long>(Hq) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const long long q_off = (static_cast<long long>(b) * S * Hq + h) * D;
  const long long kv_off = (static_cast<long long>(b) * Tk * Hkv + hk) * D;
  const float* lse_b = lse + (static_cast<long long>(b) * Hq + h) * S;
  const float* delta_b = delta + (static_cast<long long>(b) * Hq + h) * S;

  // query rows [q0, q0 + 64) of this head into buffer `buf`
  auto stage_q = [&](int q0, int buf) {
    ps::stage_tile<DKV_TC_THREADS>(q_s + buf * ps::kTile, q + q_off, q0, S, q_row);
    ps::stage_tile<DKV_TC_THREADS>(do_s + buf * ps::kTile, dout + q_off, q0, S, q_row);
    const int r = tid & (BQ - 1);
    const bool ok = q0 + r < S;
    if (tid < BQ)
      ps::cp_async4(lse_s + buf * BQ + r, lse_b + (ok ? q0 + r : 0), ok);
    else if (tid < 2 * BQ)
      ps::cp_async4(delta_s + buf * BQ + r, delta_b + (ok ? q0 + r : 0), ok);
    ps::cp_async_commit();
  };

  // key rows r_w + g (i = 0) and r_w + g + 8 (i = 1) by the 8 8-wide
  // head-dim tiles from d0: this head's share of dk (unscaled) and dv
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // causal: query rows before the tile's first key see none of its keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const bool in_window = k0 < end && k0 + BK > start;
  const int n_q = in_window && q_begin < S ? (S - q_begin + BQ - 1) / BQ : 0;
  if (n_q > 0) {
    ps::stage_tile<DKV_TC_THREADS>(k_s, k + kv_off, k0, Tk, kv_row);
    ps::stage_tile<DKV_TC_THREADS>(v_s, v + kv_off, k0, Tk, kv_row);
    stage_q(q_begin, 0);
  }
  const float scale2 = scale * LOG2E;

  for (int j = 0; j < n_q; ++j) {
    ps::cp_async_wait_all();
    __syncthreads();  // tile j has landed; every reader of tile j - 1 is done
    const int q0 = q_begin + j * BQ;
    const int buf = j & 1;
    if (j + 1 < n_q) stage_q(q0 + BQ, buf ^ 1);
    const bf16* qs = q_s + buf * ps::kTile;
    const bf16* dos = do_s + buf * ps::kTile;
    const float* ls = lse_s + buf * BQ;
    const float* ds_ = delta_s + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 key rows x 32 queries a warp
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ka[4], va[4];
      ps::ldsm_x4(ka, ps::a_frag_addr(k_s, r_w, kk * 16, lane));
      ps::ldsm_x4(va, ps::a_frag_addr(v_s, r_w, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bo[4];
        ps::ldsm_x4(bq, ps::bt_frag_addr(qs, c0 + np * 16, kk * 16, lane));
        ps::ldsm_x4(bo, ps::bt_frag_addr(dos, c0 + np * 16, kk * 16, lane));
        ps::mma_bf16(st[2 * np], ka, bq[0], bq[1]);
        ps::mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
        ps::mma_bf16(dpt[2 * np], va, bo[0], bo[1]);
        ps::mma_bf16(dpt[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // p and ds, each a select on the valid pairs (a query row with no
    // valid key has lse = NEG_INF, where exp overflows), into shared
    // memory as bf16 hi + lo for the warp that shares these key rows
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r_w + g + 8 * i;
        const int kpos = k0 + row;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + n * 8 + 2 * t4 + e;
          const int qpos = q0 + col;
          const bool ok = qpos < S && kpos >= start && kpos < end &&
                          (!causal || kpos <= qpos);
          p[e] = ok ? exp2f(fmaf(st[n][2 * i + e], scale2, -ls[col] * LOG2E)) : 0.f;
          ds[e] = ok ? p[e] * (dpt[n][2 * i + e] - ds_[col]) : 0.f;
        }
        const int at = ps::swz<BQ>(row, c0 + n * 8 + 2 * t4);
        ps::store_split(p_hi + at, p_lo + at, p[0], p[1]);
        ps::store_split(ds_hi + at, ds_lo + at, ds[0], ds[1]);
      }
    ps::bar_sync(1 + (warp & 3), 64);  // the two warps of these key rows

    // dv += P^T dO and dk += dS^T Q over this warp's head-dim half and all
    // 64 queries, each product twice (hi and lo), dO and Q through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], pl[4], sa[4], sl[4];
      ps::ldsm_x4(pa, ps::a_frag_addr<BQ>(p_hi, r_w, kk * 16, lane));
      ps::ldsm_x4(pl, ps::a_frag_addr<BQ>(p_lo, r_w, kk * 16, lane));
      ps::ldsm_x4(sa, ps::a_frag_addr<BQ>(ds_hi, r_w, kk * 16, lane));
      ps::ldsm_x4(sl, ps::a_frag_addr<BQ>(ds_lo, r_w, kk * 16, lane));
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bo[4], bq[4];
        ps::ldsm_x4_trans(bo, ps::b_frag_addr(dos, kk * 16, d0 + dp * 16, lane));
        ps::ldsm_x4_trans(bq, ps::b_frag_addr(qs, kk * 16, d0 + dp * 16, lane));
        ps::mma_bf16(dv[2 * dp], pa, bo[0], bo[1]);
        ps::mma_bf16(dv[2 * dp], pl, bo[0], bo[1]);
        ps::mma_bf16(dv[2 * dp + 1], pa, bo[2], bo[3]);
        ps::mma_bf16(dv[2 * dp + 1], pl, bo[2], bo[3]);
        ps::mma_bf16(dk[2 * dp], sa, bq[0], bq[1]);
        ps::mma_bf16(dk[2 * dp], sl, bq[0], bq[1]);
        ps::mma_bf16(dk[2 * dp + 1], sa, bq[2], bq[3]);
        ps::mma_bf16(dk[2 * dp + 1], sl, bq[2], bq[3]);
      }
    }
  }

  // this head's partials, fp32 [B, T, Hq, 128] each: dk's, then dv's; a key
  // tile outside the window writes zeros
  const long long part_half = static_cast<long long>(B) * Tk * q_row;
  float* dk_p = part + (static_cast<long long>(b) * Tk * Hq + h) * D + d0 + 2 * t4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + r_w + g + 8 * i;
    if (t >= Tk) continue;
    float* row = dk_p + t * q_row;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(row + n * 8) =
          make_float2(dk[n][2 * i] * scale, dk[n][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(row + part_half + n * 8) =
          make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// dk, dv [B, T, Hkv, 128] bf16 = the sums of the rep = Hq / Hkv partials of
// each key/value head, in a fixed order (so repeated calls give the same
// bits); four head-dim columns a thread
__global__ void dkv_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, long long n4, int Hkv, int rep) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const long long e = i * 4;          // element of [B, T, Hkv, D]
  const long long bt_hk = e / D;      // (b * T + t) * Hkv + hk
  const long long src = bt_hk * rep * D + e % D;  // head hk * rep of [B, T, Hq, D]
  const long long half = n4 * 4 * rep;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int r = 0; r < rep; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(part + src + r * D);
    const float4 c = *reinterpret_cast<const float4*>(part + half + src + r * D);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + e);
  __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + e);
  k2[0] = __floats2bfloat162_rn(sk.x, sk.y);
  k2[1] = __floats2bfloat162_rn(sk.z, sk.w);
  v2[0] = __floats2bfloat162_rn(sv.x, sv.y);
  v2[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const void* kv_start, const void* kv_end, int B, int S, int Tk,
              int Hq, int Hkv, float scale, int causal, cudaStream_t st) {
  // once per instantiation, so that a launch inside CUDA-graph capture
  // makes no attribute call
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM_BYTES);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_dq_kernel<T><<<grid, THREADS, DQ_SMEM_BYTES, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<const int*>(kv_start),
      static_cast<const int*>(kv_end), S, Tk, Hq, Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, const void* kv_start,
                   const void* kv_end, int B, int S, int Tk, int Hq, int Hkv, float scale,
                   int causal, cudaStream_t st) {
  // once, so that a launch inside CUDA-graph capture makes no attribute
  // call; the largest carveout, so that two blocks fit on an SM
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_dq_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_DQ_SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_dq_bf16_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int grid = ((S + BQ - 1) / BQ) * Hq * B;
  flash_dq_bf16_kernel<<<grid, ps::kTcThreads, TC_DQ_SMEM_BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq),
      static_cast<const int*>(kv_start), static_cast<const int*>(kv_end), B, S, Tk, Hq, Hkv,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv,
                   const void* kv_start, const void* kv_end, int B, int S, int Tk,
                   int Hq, int Hkv, float scale, int causal, cudaStream_t st) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DKV_SMEM_BYTES);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((Tk + BK - 1) / BK, Hkv, B);
  flash_dkv_f32_kernel<<<grid, THREADS, DKV_SMEM_BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const int*>(kv_start), static_cast<const int*>(kv_end), S,
      Tk, Hq, Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv,
                    void* part, const void* kv_start, const void* kv_end, int B,
                    int S, int Tk, int Hq, int Hkv, float scale, int causal,
                    cudaStream_t st) {
  // once, so that a launch inside CUDA-graph capture makes no attribute
  // call; the kernel needs the largest shared-memory carveout
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_dkv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TC_DKV_SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_dkv_bf16_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int grid = ((Tk + BK - 1) / BK) * Hq * B;
  flash_dkv_bf16_kernel<<<grid, DKV_TC_THREADS, TC_DKV_SMEM_BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(part), static_cast<const int*>(kv_start),
      static_cast<const int*>(kv_end), B, S, Tk, Hq, Hkv, scale, causal);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n4 = static_cast<long long>(B) * Tk * Hkv * (D / 4);
  constexpr int RED_THREADS = 256;
  dkv_reduce_kernel<<<static_cast<unsigned>((n4 + RED_THREADS - 1) / RED_THREADS),
                      RED_THREADS, 0, st>>>(static_cast<const float*>(part),
                                            static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                            n4, Hkv, Hq / Hkv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ps_flash_bwd_dq(int device, int dtype, const void* q,
                               const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               const void* kv_start, const void* kv_end, int B,
                               int S, int Tk, int Hq, int Hkv, int head_dim,
                               float scale, int causal, void* stream) {
  if (head_dim != D || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ps::kBFloat16)
    return launch_dq_bf16(q, k, v, dout, lse, delta, dq, kv_start, kv_end, B, S, Tk, Hq,
                          Hkv, scale, causal, st);
  if (dtype == ps::kFloat32)
    return launch_dq<float>(q, k, v, dout, lse, delta, dq, kv_start, kv_end,
                            B, S, Tk, Hq, Hkv, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ps_flash_bwd_dkv(int device, int dtype, const void* q,
                                const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                void* part, const void* kv_start,
                                const void* kv_end, int B, int S, int Tk,
                                int Hq, int Hkv, int head_dim, float scale,
                                int causal, void* stream) {
  if (head_dim != D || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ps::kBFloat16 && part != nullptr)
    return launch_dkv_bf16(q, k, v, dout, lse, delta, dk, dv, part, kv_start,
                           kv_end, B, S, Tk, Hq, Hkv, scale, causal, st);
  if (dtype == ps::kFloat32)
    return launch_dkv_f32(q, k, v, dout, lse, delta, dk, dv, kv_start, kv_end,
                          B, S, Tk, Hq, Hkv, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
