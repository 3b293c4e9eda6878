// Flash-attention forward with GQA, a per-batch-row valid key window and an
// optional causal mask.
//
// Replaces the TPU kernel ps_slm_tpu/ops/flash_attention.py::_fwd_kernel
// (called from _flash_fwd_impl).  Same function: online softmax in fp32,
// keys outside [kv_start[b], kv_end[b]) or above the diagonal masked, output
// in the input dtype and the fp32 log-sum-exp per query row.  A query row
// with no valid key gives out = 0 and lse = NEG_INF (-0.7 * FLT_MAX), never
// NaN.
//
// Layout: q [B, S, Hq, 128], k/v [B, T, Hkv, 128] (the public layout of the
// port's attention, so no transposes around the call), out like q,
// lse [B, Hq, S] fp32.  Query head h reads key/value head h / (Hq / Hkv).
//
// Bound.  At the main paths' bf16 shapes the function must move 8.5 MB
// (serving encoder, 4 x 516, 4/4 heads: 2.5 us at 3.35 TB/s) or 15.6 MB
// (LLM prefill, 4 x 543, 12/2 heads, causal: 4.7 us) and do 4 * 128 flops
// per valid (query, key) pair, 1.6 and ~3.5 GFLOP (1.6 and ~3.5 us on the
// bf16 tensor cores): ~185 flops per byte, just under the card's ~295 bf16
// ridge, so bytes set the least time, with operations close behind.  In
// fp32 the 67 TFLOP/s outside the tensor cores set it.
//
// bf16: flash_fwd_bf16_kernel, on the tensor cores.  One warpgroup (4 warps,
// 128 threads) per (64-row q tile, q head, batch row); warp w owns query
// rows 16w..16w+15.
//  * Both products are mma.sync.m16n8k16 with bf16 operands and fp32
//    accumulation (mma.cuh).  mma.sync and not wgmma: its fragments live in
//    known registers, so the scale, the window/causal select and the online
//    softmax run on the score accumulators in place, and P feeds P V as the
//    A operand straight from registers; with 144-432 blocks of at most 9 key
//    tiles the kernel is far from the tensor-core rate either way.
//  * The q tile's A fragments are loaded once (ldmatrix) and stay in 32
//    registers for the whole key loop; K feeds Q K^T through ldmatrix, V
//    feeds P V through ldmatrix.trans.
//  * Row max and row sum are quad shuffles (the 4 lanes that share a row);
//    m and l stay in registers, l summed per lane and reduced once at the
//    end.  Exponentials are exp2 of log2(e)-scaled scores.
//  * P is rounded to bf16 for P V only; l is summed from the fp32 P.  The
//    rounding is the one departure from the fp32 reference (as in
//    FlashAttention-2/3); tests/test_torch_flash_numerics.py shows it fits
//    the bf16 tolerance.
//  * K/V tiles are double-buffered: tile j + 1 is copied with cp.async
//    while tile j is computed.  Tiles are stored swizzled (16-byte chunk
//    c of row r at c ^ (r % 8)), so ldmatrix reads are free of bank
//    conflicts.  80 KB of shared memory a block (q 16 KB, 2 x K and 2 x V
//    16 KB), so two blocks fit on an SM and the encoder's 144 blocks make
//    one wave.
//  * Tiles wholly outside the window or above the diagonal are skipped;
//    ragged S and T are zero-filled by the copies and masked, with no
//    padding of the inputs.
//
// flash_fwd_mla_bf16_kernel is the same body (fwd_bf16) at q/k head dim 192
// and v head dim 128: DeepSeek-V3's latent attention in its expanded form
// (128 nope + 64 rope dims of q and k, 128 of v), for prefills.  Its q
// fragments take 48 registers (32 at 128), its tiles 104 KB of shared
// memory, so two blocks still fit on an SM.  bf16 only; its entry point is
// ps_flash_fwd_mla.  At a pool prefill (2 000 left-padded positions, a few
// hundred valid, 16 heads) the valid causal pairs set its work: 4 * 160
// flops a pair on average over q.k (192) and p.v (128).
//
// fp32: flash_fwd_f32_kernel, on fp32 FMAs from shared memory.  The bf16
// tensor cores cannot take fp32 operands, and TF32 (10-bit mantissa) would
// break the fp32 tolerances (2e-5 against the plain version, 1e-3 for the
// fp32 serving and training paths against the CPU).  One block of 256
// threads per (64-row q tile, q head, batch row); thread (tr, tc) =
// (tid / 16, tid % 16) owns score rows tr + 16 i and columns tc + 16 j
// (i, j < 4) and output rows tr + 16 i by head-dim columns tc + 16 j
// (j < 8); shared rows are padded to 129 floats against bank conflicts.
// The dtype alone picks the kernel.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float NEG_INF = -0.7f * 3.402823466e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int THREADS = 256;
constexpr int QK_STRIDE = D + 1;
constexpr int P_STRIDE = BK + 1;
constexpr int SMEM_FLOATS = BQ * QK_STRIDE + BK * QK_STRIDE + BK * D + BQ * P_STRIDE;
constexpr int SMEM_BYTES = SMEM_FLOATS * static_cast<int>(sizeof(float));

constexpr int TC_SMEM_BYTES = 5 * ps::kTile * static_cast<int>(sizeof(bf16));
// the MLA instantiation: q and two K tiles 192 wide, two V tiles 128 wide
// (104 KB, so two blocks still fit on an SM)
constexpr int MLA_DQK = 192;
constexpr int MLA_DV = 128;
constexpr int MLA_SMEM_BYTES =
    (BQ * MLA_DQK + 2 * BK * MLA_DQK + 2 * BK * MLA_DV) * static_cast<int>(sizeof(bf16));

__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, const int* __restrict__ kv_start,
                         const int* __restrict__ kv_end, int S, int Tk, int Hq,
                         int Hkv, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // [BQ][QK_STRIDE]
  float* k_s = q_s + BQ * QK_STRIDE;    // [BK][QK_STRIDE]
  float* v_s = k_s + BK * QK_STRIDE;    // [BK][D]
  float* p_s = v_s + BK * D;            // [BQ][P_STRIDE]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int start = kv_start[b];
  const int end = kv_end[b];

  // q[b, s, h, :] and k/v[b, t, hk, :]
  const long long q_row = static_cast<long long>(Hq) * D;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const float* qb = q + (static_cast<long long>(b) * S * Hq + h) * D;
  const float* kb = k + (static_cast<long long>(b) * Tk * Hkv + hk) * D;
  const float* vb = v + (static_cast<long long>(b) * Tk * Hkv + hk) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int s = q0 + r;
    q_s[r * QK_STRIDE + c] = s < S ? qb[s * q_row + c] : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  // keys a tile of this block may see: the window, and for causal rows
  // nothing past the tile's last query row
  const int hi = causal ? min(end, q0 + BQ) : end;
  const int k_begin = (start / BK) * BK;

  for (int k0 = k_begin; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int t = k0 + r;
      const bool in = t < Tk;
      k_s[r * QK_STRIDE + c] = in ? kb[t * kv_row + c] : 0.f;
      v_s[r * D + c] = in ? vb[t * kv_row + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(tr + 16 * i) * QK_STRIDE + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tc + 16 * j) * QK_STRIDE + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        ok[j] = kpos >= start && kpos < end && (!causal || kpos <= qpos);
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        p_s[(tr + 16 * i) * P_STRIDE + tc + 16 * j] = p;
        rs += p;
      }
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(tr + 16 * i) * P_STRIDE + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = v_s[c * D + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = o + (static_cast<long long>(b) * S * Hq + h) * D;
  float* lb = lse + (static_cast<long long>(b) * Hq + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + tr + 16 * i;
    if (s >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) ob[s * q_row + tc + 16 * j] = acc[i][j] / l_safe;
    if (tc == 0) lb[s] = l[i] == 0.f ? NEG_INF : m[i] + logf(l_safe);
  }
}

// The bf16 kernels' body over q/k rows of DQK and v rows of DV head dims
// (128 and 128, or latent attention's expanded 192 and 128); `smem` holds
// the q tile and two K and two V tiles, each 64 rows, swizzled.
template <int DQK, int DV>
__device__ __forceinline__ void fwd_bf16(unsigned char* smem, const bf16* __restrict__ q,
                                         const bf16* __restrict__ k, const bf16* __restrict__ v,
                                         bf16* __restrict__ o, float* __restrict__ lse,
                                         const int* __restrict__ kv_start,
                                         const int* __restrict__ kv_end, int S, int Tk, int Hq,
                                         int Hkv, float scale, int causal) {
  constexpr int QT = BQ * DQK, KT = BK * DQK, VT = BK * DV;
  bf16* q_s = reinterpret_cast<bf16*>(smem);   // [QT], swizzled
  bf16* k_s = q_s + QT;                         // [2][KT]
  bf16* v_s = k_s + 2 * KT;                     // [2][VT]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int r_w = (threadIdx.x >> 5) * 16;  // this warp's first row of the tile
  const int g = lane >> 2, t4 = lane & 3;
  const int start = kv_start[b];
  const int end = kv_end[b];

  const long long q_row = static_cast<long long>(Hq) * DQK;
  const long long k_row = static_cast<long long>(Hkv) * DQK;
  const long long v_row = static_cast<long long>(Hkv) * DV;
  const long long o_row = static_cast<long long>(Hq) * DV;
  const bf16* qb = q + (static_cast<long long>(b) * S * Hq + h) * DQK;
  const bf16* kb = k + (static_cast<long long>(b) * Tk * Hkv + hk) * DQK;
  const bf16* vb = v + (static_cast<long long>(b) * Tk * Hkv + hk) * DV;

  const int hi = causal ? min(end, q0 + BQ) : end;
  const int k_begin = (start / BK) * BK;
  const int n_tiles = hi > k_begin ? (hi - k_begin + BK - 1) / BK : 0;
  if (n_tiles > 0) {
    ps::stage_tile<ps::kTcThreads, DQK>(q_s, qb, q0, S, q_row);
    ps::stage_tile<ps::kTcThreads, DQK>(k_s, kb, k_begin, Tk, k_row);
    ps::stage_tile<ps::kTcThreads, DV>(v_s, vb, k_begin, Tk, v_row);
    ps::cp_async_commit();
  }

  // rows r_w + g (i = 0) and r_w + g + 8 (i = 1) of the tile: their max
  // (log2 units), this lane's share of their sum, and out by DV / 8 8-wide
  // head-dim tiles
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[DQK / 16][4];
  const float scale2 = scale * LOG2E;

  for (int j = 0; j < n_tiles; ++j) {
    ps::cp_async_wait_all();
    __syncthreads();  // tile j has landed; every reader of tile j - 1 is done
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        ps::ldsm_x4(qf[kk], ps::a_frag_addr<DQK>(q_s, r_w, kk * 16, lane));
    }
    const int k0 = k_begin + j * BK;
    const bf16* ks = k_s + (j & 1) * KT;
    const bf16* vs = v_s + (j & 1) * VT;
    if (j + 1 < n_tiles) {
      ps::stage_tile<ps::kTcThreads, DQK>(k_s + ((j + 1) & 1) * KT, kb, k0 + BK, Tk, k_row);
      ps::stage_tile<ps::kTcThreads, DV>(v_s + ((j + 1) & 1) * VT, vb, k0 + BK, Tk, v_row);
      ps::cp_async_commit();
    }

    // S = Q K^T: 16 rows x 64 keys a warp, as 8 tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ps::ldsm_x4(bk, ps::bt_frag_addr<DQK>(ks, np * 16, kk * 16, lane));
        ps::mma_bf16(sc[2 * np], qf[kk], bk[0], bk[1]);
        ps::mma_bf16(sc[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale and mask (a select), then the online-softmax update
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + r_w + g + 8 * (e >> 1);
        const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
        const bool ok = kpos >= start && kpos < end && (!causal || kpos <= qpos);
        sc[n][e] = ok ? sc[n][e] * scale2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no valid key yet keeps m = NEG_INF; exponents are taken
      // against 0 there, so its masked entries give exp2(NEG_INF) = 0
      m_use[i] = m_new == NEG_INF ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_use[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - m_use[e >> 1]);
        sc[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // out += P V: P from the score registers, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      ps::c_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t bv[4];
        ps::ldsm_x4_trans(bv, ps::b_frag_addr<DV>(vs, kk * 16, dp * 16, lane));
        ps::mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        ps::mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  bf16* ob = o + (static_cast<long long>(b) * S * Hq + h) * DV;
  float* lb = lse + (static_cast<long long>(b) * Hq + h) * S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int s = q0 + r_w + g + 8 * i;
    if (s >= S) continue;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    bf16* row = ob + s * o_row + 2 * t4;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (t4 == 0) lb[s] = l[i] == 0.f ? NEG_INF : m[i] * LN2 + logf(l[i]);
  }
}

__global__ void __launch_bounds__(ps::kTcThreads, 2)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, const int* __restrict__ kv_start,
                          const int* __restrict__ kv_end, int S, int Tk, int Hq,
                          int Hkv, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  fwd_bf16<D, D>(tc_smem, q, k, v, o, lse, kv_start, kv_end, S, Tk, Hq, Hkv, scale, causal);
}

// Latent attention's expanded prefill (DeepSeek-V3 MLA): q and k of 128
// nope + 64 rope dims, v of 128.  Its own name, so that a reader of the
// device trace tells it from the 128 route.
__global__ void __launch_bounds__(ps::kTcThreads, 2)
    flash_fwd_mla_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ o,
                              float* __restrict__ lse, const int* __restrict__ kv_start,
                              const int* __restrict__ kv_end, int S, int Tk, int Hq,
                              int Hkv, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  fwd_bf16<MLA_DQK, MLA_DV>(tc_smem, q, k, v, o, lse, kv_start, kv_end, S, Tk, Hq, Hkv, scale,
                            causal);
}

template <typename T, typename K>
int launch(K kernel, int smem_bytes, int threads, const void* q, const void* k, const void* v,
           void* o, void* lse, const void* kv_start, const void* kv_end, int B, int S, int Tk,
           int Hq, int Hkv, float scale, int causal, cudaStream_t st) {
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, threads, smem_bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_start),
      static_cast<const int*>(kv_end), S, Tk, Hq, Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// once per kernel, so that a launch inside CUDA-graph capture makes no
// attribute call; the bf16 kernel also asks for the largest shared-memory
// carveout, so that two of its blocks fit on an SM
cudaError_t configure() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_bf16_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_mla_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MLA_SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_mla_bf16_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

}  // namespace

extern "C" int ps_flash_fwd(int device, int dtype, const void* q,
                            const void* k, const void* v, void* o, void* lse,
                            const void* kv_start, const void* kv_end, int B,
                            int S, int Tk, int Hq, int Hkv, int head_dim,
                            float scale, int causal, void* stream) {
  if (head_dim != D || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaError_t configured = configure();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ps::kBFloat16)
    return launch<bf16>(flash_fwd_bf16_kernel, TC_SMEM_BYTES, ps::kTcThreads, q, k, v, o, lse,
                        kv_start, kv_end, B, S, Tk, Hq, Hkv, scale, causal, st);
  if (dtype == ps::kFloat32)
    return launch<float>(flash_fwd_f32_kernel, SMEM_BYTES, THREADS, q, k, v, o, lse, kv_start,
                         kv_end, B, S, Tk, Hq, Hkv, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Latent attention's expanded prefill: q/k head dim 192, v head dim 128,
// bf16 only; out [B, S, Hq, 128].
extern "C" int ps_flash_fwd_mla(int device, int dtype, const void* q, const void* k,
                                const void* v, void* o, void* lse, const void* kv_start,
                                const void* kv_end, int B, int S, int Tk, int Hq, int Hkv,
                                int qk_dim, int v_dim, float scale, int causal, void* stream) {
  if (dtype != ps::kBFloat16 || qk_dim != MLA_DQK || v_dim != MLA_DV || Hkv <= 0 ||
      Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaError_t configured = configure();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  return launch<bf16>(flash_fwd_mla_bf16_kernel, MLA_SMEM_BYTES, ps::kTcThreads, q, k, v, o,
                      lse, kv_start, kv_end, B, S, Tk, Hq, Hkv, scale, causal,
                      static_cast<cudaStream_t>(stream));
}
