// Helpers shared by the kernels: element conversion, vector loads of N
// consecutive elements, warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr unsigned FULL_MASK = 0xffffffffu;

// dtype codes passed from Python (must match kernels/build.py)
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// Load N consecutive elements (N * sizeof(T) bytes, aligned to that size)
// and widen them to float.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  using R = typename Raw<N * sizeof(T)>::type;
  R r = *reinterpret_cast<const R*>(p);
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* in) {
  using R = typename Raw<N * sizeof(T)>::type;
  R r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<R*>(p) = r;
}

// N consecutive floats from shared memory: one vector load where N is 1, 2
// or 4 (the address is then aligned to N floats), 16-byte loads where N is
// a multiple of 4 (head_dim 256 gives a lane 8 dims), else N scalar loads
// (head_dim 80 gives a lane 3 dims).
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* out) {
  if constexpr (N == 1 || N == 2 || N == 4) {
    load_vec<float, N>(p, out);
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) load_vec<float, 4>(p + i, out + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

// Score post-processing shared by both kernels: scale, then optional tanh
// soft-cap (softcap <= 0 means none).
__device__ __forceinline__ float finish_score(float dot, float scale,
                                              float softcap) {
  float s = dot * scale;
  if (softcap > 0.f) s = softcap * tanhf(s / softcap);
  return s;
}

}  // namespace repro
