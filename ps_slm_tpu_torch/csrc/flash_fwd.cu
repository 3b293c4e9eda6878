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
// Bound: at the serving shapes (S = T ~ 520, D = 128, bf16) the function
// does ~185 flops per byte it must move, just under the card's ~295 bf16
// ridge, so its least time is set by bytes; in fp32 (67 TFLOP/s without
// tensor cores) it is set by operations.  This first version computes both
// products with fp32 FMAs from shared memory (no tensor cores), so the fp32
// FMA rate is what limits it, far above either bound; wgmma/mma.sync tiles
// are a later tuning step.
//
// Design: one block of 256 threads per (64-row q tile, q head, batch row).
// The block stages its q tile once, then walks 64-row key/value tiles through
// shared memory, skipping tiles wholly outside the row's window or above the
// diagonal.  Thread (tr, tc) = (tid / 16, tid % 16) owns score rows
// tr + 16 i and columns tc + 16 j (i, j < 4), and output rows tr + 16 i by
// head-dim columns tc + 16 j (j < 8); the 16 threads that share a row sit in
// one half-warp, so row max and row sum are half-warp shuffles and m, l stay
// in registers.  Shared rows of q and k are padded to 129 floats so that the
// column reads are free of bank conflicts.  Ragged S and T are handled by
// guards and masks, with no padding of the inputs.
#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int QK_STRIDE = D + 1;
constexpr int P_STRIDE = BK + 1;
constexpr float NEG_INF = -0.7f * 3.402823466e38f;
constexpr int SMEM_FLOATS = BQ * QK_STRIDE + BK * QK_STRIDE + BK * D + BQ * P_STRIDE;
constexpr int SMEM_BYTES = SMEM_FLOATS * static_cast<int>(sizeof(float));

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + (static_cast<long long>(b) * S * Hq + h) * D;
  const T* kb = k + (static_cast<long long>(b) * Tk * Hkv + hk) * D;
  const T* vb = v + (static_cast<long long>(b) * Tk * Hkv + hk) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int s = q0 + r;
    q_s[r * QK_STRIDE + c] = s < S ? ps::to_f32(qb[s * q_row + c]) : 0.f;
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
      k_s[r * QK_STRIDE + c] = in ? ps::to_f32(kb[t * kv_row + c]) : 0.f;
      v_s[r * D + c] = in ? ps::to_f32(vb[t * kv_row + c]) : 0.f;
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

  T* ob = o + (static_cast<long long>(b) * S * Hq + h) * D;
  float* lb = lse + (static_cast<long long>(b) * Hq + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + tr + 16 * i;
    if (s >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ob[s * q_row + tc + 16 * j] = ps::from_f32<T>(acc[i][j] / l_safe);
    if (tc == 0) lb[s] = l[i] == 0.f ? NEG_INF : m[i] + logf(l_safe);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* kv_start, const void* kv_end, int B, int S, int Tk,
           int Hq, int Hkv, float scale, int causal, cudaStream_t st) {
  // once per instantiation, so that a launch inside CUDA-graph capture
  // makes no attribute call
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T><<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_start), static_cast<const int*>(kv_end), S,
      Tk, Hq, Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ps::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, lse, kv_start, kv_end, B, S, Tk,
                                 Hq, Hkv, scale, causal, st);
  if (dtype == ps::kFloat32)
    return launch<float>(q, k, v, o, lse, kv_start, kv_end, B, S, Tk, Hq, Hkv,
                         scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
