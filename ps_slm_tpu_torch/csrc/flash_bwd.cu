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
// Bound: at the training shapes (S = T = 543, D = 128, bf16) each kernel
// does ~6-8 flops x 128 per valid pair against a few MB of traffic, so its
// least time is set by operations on the bf16 tensor cores.  This first
// version computes every product with fp32 FMAs from shared memory (no
// tensor cores), as flash_fwd.cu does, so the fp32 FMA rate limits it;
// mma.sync/wgmma tiles are a later tuning step.
//
// Design.  The TPU grids walk the reduced dimension sequentially and carry
// the sum in scratch; here a block loops over it and keeps the sum in
// registers until a single store, so no atomics and no second pass are
// needed.
//  * dq: one block of 256 threads per (64-row query tile, query head, batch
//    row).  It stages its q and dout tiles once, then walks 64-row key/value
//    tiles inside [kv_start, kv_end) and at or below the diagonal.  Thread
//    (tr, tc) = (tid / 16, tid % 16) owns score rows tr + 16 i and columns
//    tc + 16 j (i, j < 4), then dq rows tr + 16 i by head-dim columns
//    tc + 16 j (j < 8).
//  * dkv: one block per (64-row key tile, key/value head, batch row).  It
//    stages its k and v tiles once, then loops over the Hq / Hkv query heads
//    of its group and over the query tiles from the diagonal on, computing
//    the transposed scores (key rows x query columns) so that dk and dv
//    accumulate in registers: thread (tr, tc) owns key rows tr + 16 i and
//    head-dim columns tc + 16 j.  A key tile wholly outside the window
//    writes zeros.
// Shared rows of 128 are padded to 129 floats and rows of 64 to 65, so the
// column reads are free of bank conflicts.  Ragged S and T are handled by
// guards and masks, with no padding of the inputs.
#include "common.cuh"

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const int* __restrict__ kv_start,
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

  T* dk_b = dk + kv_off;
  T* dv_b = dv + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + tr + 16 * i;
    if (t >= Tk) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dk_b[t * kv_row + tc + 16 * j] = ps::from_f32<T>(dk_acc[i][j] * scale);
      dv_b[t * kv_row + tc + 16 * j] = ps::from_f32<T>(dv_acc[i][j]);
    }
  }
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

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* kv_start, const void* kv_end, int B, int S, int Tk,
               int Hq, int Hkv, float scale, int causal, cudaStream_t st) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DKV_SMEM_BYTES);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((Tk + BK - 1) / BK, Hkv, B);
  flash_dkv_kernel<T><<<grid, THREADS, DKV_SMEM_BYTES, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const int*>(kv_start), static_cast<const int*>(kv_end), S,
      Tk, Hq, Hkv, scale, causal);
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
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, kv_start,
                                    kv_end, B, S, Tk, Hq, Hkv, scale, causal,
                                    st);
  if (dtype == ps::kFloat32)
    return launch_dq<float>(q, k, v, dout, lse, delta, dq, kv_start, kv_end,
                            B, S, Tk, Hq, Hkv, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ps_flash_bwd_dkv(int device, int dtype, const void* q,
                                const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                const void* kv_start, const void* kv_end,
                                int B, int S, int Tk, int Hq, int Hkv,
                                int head_dim, float scale, int causal,
                                void* stream) {
  if (head_dim != D || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ps::kBFloat16)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                     kv_start, kv_end, B, S, Tk, Hq, Hkv,
                                     scale, causal, st);
  if (dtype == ps::kFloat32)
    return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, kv_start,
                             kv_end, B, S, Tk, Hq, Hkv, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
