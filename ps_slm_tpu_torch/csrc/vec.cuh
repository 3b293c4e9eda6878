// The vectorised norm routes' shared pieces (a warp per row from 16-byte
// loads): their limits, 16-byte packs of bf16 / fp32, a lane's chunks of a
// row, and the dispatch from a width, a dtype and the pointers to a kernel
// instantiation.  Included by norms.cu and ln_bwd.cu, each built on its own
// (one nvcc per source), so everything here has internal linkage.
#pragma once

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

// the vectorised route: warps a block, and 16-byte chunks a lane at most
// (ops/norms.py::VEC_ROW_BYTES = VEC_MAX_CHUNKS * 32 * 16)
constexpr int VEC_WARPS = 4;
constexpr int VEC_MAX_CHUNKS = 7;
constexpr int VEC_ROW_BYTES = VEC_MAX_CHUNKS * 32 * 16;

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

// f(std::integral_constant<int, nch>) for nch in 1..VEC_MAX_CHUNKS
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
static_assert(VEC_MAX_CHUNKS == 7, "with_chunks covers 1..VEC_MAX_CHUNKS");

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
// does not take these rows or pointers (a null pointer, an absent operand,
// passes)
int vec_chunks(int d, int esize, std::initializer_list<const void*> ptrs) {
  const long long bytes = static_cast<long long>(d) * esize;
  if (bytes % 16 != 0 || bytes > VEC_ROW_BYTES) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  return static_cast<int>((bytes / 16 + 31) / 32);
}

}  // namespace
