// Tensor-core building blocks of the bf16 flash kernels: asynchronous
// copies (cp.async), ldmatrix loads, the warp-level bf16 product
// mma.sync.m16n8k16 with fp32 accumulation, the XOR swizzle of the bf16
// tiles they share through shared memory, and a barrier of a few warps.
// All are sm_80 instructions that sm_90a runs at the mma.sync rate.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A 16x16, 4 regs of bf16x2: a0 (row g, cols 2t, 2t+1), a1 (row g + 8),
//     a2 (row g, cols 2t + 8, 2t + 9), a3 (row g + 8, cols 2t + 8, 2t + 9);
//   B 16x8, 2 regs: b0 (rows 2t, 2t+1, col g), b1 (rows 2t + 8, 2t + 9);
//   C 16x8, 4 fp32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g + 8).
// So the C fragments of two neighbouring 8-column tiles, packed to bf16,
// are the A fragment of one 16-deep step: a score tile becomes the left
// operand of the next product without leaving registers.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace ps {

constexpr int kTileCols = 128;             // head dim: 16 chunks of 16 bytes
constexpr int kTileRows = 64;
constexpr int kTile = kTileRows * kTileCols;
constexpr int kTcThreads = 128;            // one warpgroup, 16 tile rows a warp

// Element offset of (row, col) in a tile of COLS-wide bf16 rows (COLS a
// multiple of 64: 128, or 192 for latent attention's q and k): chunk c of
// row r is stored at chunk c ^ (r % 8), so the 8 rows that one ldmatrix
// phase reads, or one warp's fragment stores write, at the same logical
// chunk sit in 8 different bank groups.
template <int COLS = kTileCols>
__device__ __forceinline__ int swz(int row, int col) {
  return row * COLS + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared without a register round trip; when
// !valid nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of one head of a [rows, heads, COLS] bf16 tensor
// (row_stride = heads * COLS) into a swizzled tile, by the block's THREADS
// threads; rows past `rows` are zero-filled.
template <int THREADS = kTcThreads, int COLS = kTileCols>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row0, int rows, long long row_stride) {
  constexpr int kChunks = COLS / 8;         // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kTileRows * kChunks / THREADS; ++i) {
    const int idx = i * THREADS + static_cast<int>(threadIdx.x);
    const int r = idx / kChunks, c = (idx % kChunks) << 3;
    const bool ok = row0 + r < rows;
    cp_async16(dst + swz<COLS>(r, c), src + (ok ? (row0 + r) * row_stride + c : 0), ok);
  }
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Address of this lane's row for ldsm_x4 of an A fragment: rows
// [row0, row0 + 16) x cols [col0, col0 + 16) of a swizzled tile.
template <int COLS = kTileCols>
__device__ __forceinline__ const __nv_bfloat16* a_frag_addr(const __nv_bfloat16* tile,
                                                            int row0, int col0, int lane) {
  return tile + swz<COLS>(row0 + (lane & 15), col0 + ((lane >> 4) << 3));
}
// ... of ldsm_x4 for the B fragments of two 8-wide n tiles, where the
// tile's rows are the n index (B = tile^T, e.g. K in Q K^T): r[0], r[1]
// are (b0, b1) of rows [row0, row0 + 8), r[2], r[3] of the next 8.
template <int COLS = kTileCols>
__device__ __forceinline__ const __nv_bfloat16* bt_frag_addr(const __nv_bfloat16* tile,
                                                             int row0, int col0, int lane) {
  return tile + swz<COLS>(row0 + (lane & 7) + ((lane >> 4) << 3),
                          col0 + (((lane >> 3) & 1) << 3));
}
// ... of ldsm_x4_trans for the B fragments of two 8-wide n tiles, where the
// tile's rows are the k index (B = tile, e.g. V in P V): r[0], r[1] are
// (b0, b1) of cols [col0, col0 + 8), r[2], r[3] of the next 8.
template <int COLS = kTileCols>
__device__ __forceinline__ const __nv_bfloat16* b_frag_addr(const __nv_bfloat16* tile,
                                                            int row0, int col0, int lane) {
  return tile + swz<COLS>(row0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                          col0 + ((lane >> 4) << 3));
}

// c += a * b on the tensor cores: bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> one bf16x2 register, lo in the low half (round to nearest)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of one 16-deep step from the C fragments of the two
// 8-wide tiles c0 (cols 0-7) and c1 (cols 8-15), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Two neighbouring fp32 values into shared memory as bf16 hi = bf16(x)
// and lo = bf16(x - hi) (x - hi is exact in fp32): hi + lo carries ~16
// significant bits, and two products, with hi and with lo, stand for one
// with the fp32 value.
__device__ __forceinline__ void store_split(__nv_bfloat16* hi, __nv_bfloat16* lo, float x0,
                                            float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
}

// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads: the warps
// that share a piece of shared memory wait only for each other.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace ps
