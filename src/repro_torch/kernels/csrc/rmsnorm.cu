// RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (the Pallas TPU kernel
// _rms_kernel).  Same function over rows x d: the fp32 mean of squares,
// rsqrt(var + eps), times (1 + scale) when zero_centered (else scale),
// output in x's dtype.  The TPU kernel is forward-only (JAX differentiates
// its jnp oracle); the backward here is the gradient of the same function:
//   r = rsqrt(mean(x^2) + eps), xh = x r, w = 1 + scale (or scale),
//   dx = r (g w - xh mean(g w xh)),  dscale = sum over rows of g xh.
//
// What bounds it on the H100: bytes.  A few FLOPs per element against 2
// (bf16) or 4 bytes read and written; at the training shape (8192 rows of
// 2048 bf16) the forward moves 67 MB (x in, y out, 32 KB of rstd), ~20 us
// at 3.35 TB/s, and the backward ~100 MB (x, g in, dx out).
//
// What this first design does about it:
//  * One CTA of 256 threads per row (forward) or per run of rows
//    (backward); each thread loads VEC consecutive elements as one 16-byte
//    vector where d and the pointers allow it (VEC = 8 bf16 or 4 fp32), and
//    one element otherwise, so any d and any row count are taken.  The TPU
//    kernel pads rows to 256-row blocks; here a row is a CTA, and nothing
//    is padded.
//  * The row is read twice (the sum of squares, then the scaling); the
//    second read comes from L1/L2 (a row is at most 20 KB at d = 5120).
//  * The forward also writes each row's fp32 rstd for the backward, so the
//    backward does not recompute the statistics.
//  * dscale is a sum over all rows.  No atomics: each backward CTA owns a
//    fixed run of rows and keeps its partial column sums in shared memory,
//    writes them to a (CTAs, d) fp32 scratch, and a second kernel sums the
//    CTAs' partials column by column in a fixed order.  The grid depends on
//    the row count alone, so the result is the same in every run.

#include "common.cuh"

using namespace repro;

namespace {

constexpr int THREADS = 256;
// most CTAs of the backward's first pass; the caller's scratch `part`
// holds min(rows, BWD_CTAS) * d floats (kernels/rmsnorm.py)
constexpr int BWD_CTAS = 256;

__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = lane < THREADS / 32 ? red[lane] : 0.f;
  return warp_sum(t);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
rms_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ y, float* __restrict__ rstd, int d, float eps,
               int zero_centered) {
  __shared__ float red[THREADS / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.f;
  for (int c = threadIdx.x * VEC; c < d; c += THREADS * VEC) {
    float v[VEC];
    load_vec<T, VEC>(xr + c, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += v[e] * v[e];
  }
  const float r = rsqrtf(block_sum(ss, red) / d + eps);
  if (threadIdx.x == 0) rstd[row] = r;
  for (int c = threadIdx.x * VEC; c < d; c += THREADS * VEC) {
    float v[VEC], w[VEC];
    load_vec<T, VEC>(xr + c, v);
    load_vec<T, VEC>(scale + c, w);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v[e] = v[e] * r * (zero_centered ? 1.f + w[e] : w[e]);
    store_vec<T, VEC>(yr + c, v);
  }
}

// First pass of the backward: dx of rows [r0, r1) and this CTA's partial
// column sums of g xh into part[blockIdx.x][d].
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
rms_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               const float* __restrict__ rstd, const T* __restrict__ g,
               T* __restrict__ dx, float* __restrict__ part, int rows, int d,
               int rows_per_cta, int zero_centered) {
  extern __shared__ float sdw[];  // [d] partial sums of g xh
  __shared__ float red[THREADS / 32];
  // thread-owned columns throughout, as in the loops below: no barrier
  for (int c = threadIdx.x * VEC; c < d; c += THREADS * VEC)
#pragma unroll
    for (int e = 0; e < VEC; ++e) sdw[c + e] = 0.f;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(rows, r0 + rows_per_cta);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + (long long)row * d;
    const T* gr = g + (long long)row * d;
    const float r = rstd[row];
    float dot = 0.f;  // sum of g w xh over the row
    for (int c = threadIdx.x * VEC; c < d; c += THREADS * VEC) {
      float xv[VEC], gv[VEC], w[VEC];
      load_vec<T, VEC>(xr + c, xv);
      load_vec<T, VEC>(gr + c, gv);
      load_vec<T, VEC>(scale + c, w);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = xv[e] * r;
        dot += gv[e] * (zero_centered ? 1.f + w[e] : w[e]) * xh;
        sdw[c + e] += gv[e] * xh;  // column c + e is this thread's alone
      }
    }
    const float mean = block_sum(dot, red) / d;
    T* dxr = dx + (long long)row * d;
    for (int c = threadIdx.x * VEC; c < d; c += THREADS * VEC) {
      float xv[VEC], gv[VEC], w[VEC], out[VEC];
      load_vec<T, VEC>(xr + c, xv);
      load_vec<T, VEC>(gr + c, gv);
      load_vec<T, VEC>(scale + c, w);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = xv[e] * r;
        const float gw = gv[e] * (zero_centered ? 1.f + w[e] : w[e]);
        out[e] = r * (gw - xh * mean);
      }
      store_vec<T, VEC>(dxr + c, out);
    }
  }
  float* pr = part + (long long)blockIdx.x * d;
  for (int c = threadIdx.x * VEC; c < d; c += THREADS * VEC)
#pragma unroll
    for (int e = 0; e < VEC; ++e) pr[c + e] = sdw[c + e];
}

// Second pass: dscale[c] = sum over the first pass's CTAs, in CTA order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rms_dscale_kernel(const float* __restrict__ part, T* __restrict__ dscale,
                  int n_part, int d) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int i = 0; i < n_part; ++i) s += part[(long long)i * d + c];
  dscale[c] = from_float<T>(s);
}

template <typename T>
bool vectorizable(int d, const void* const* ptrs, int n) {
  constexpr int VEC = 16 / sizeof(T);
  if (d % VEC) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<size_t>(ptrs[i]) % 16) return false;
  return true;
}

template <typename T>
cudaError_t fwd(const void* x, const void* scale, void* y, float* rstd,
                int rows, int d, float eps, int zc, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const void* ptrs[] = {x, scale, y};
  auto xt = static_cast<const T*>(x);
  auto st_ = static_cast<const T*>(scale);
  auto yt = static_cast<T*>(y);
  if (vectorizable<T>(d, ptrs, 3))
    rms_fwd_kernel<T, VEC><<<rows, THREADS, 0, st>>>(xt, st_, yt, rstd, d,
                                                      eps, zc);
  else
    rms_fwd_kernel<T, 1><<<rows, THREADS, 0, st>>>(xt, st_, yt, rstd, d,
                                                    eps, zc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* scale, const float* rstd,
                const void* g, void* dx, void* dscale, float* part, int rows,
                int d, int zc, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int n_part = rows < BWD_CTAS ? rows : BWD_CTAS;
  const int per = (rows + n_part - 1) / n_part;
  const size_t smem = sizeof(float) * d;
  const void* ptrs[] = {x, scale, g, dx};
  auto kern = vectorizable<T>(d, ptrs, 4) ? rms_bwd_kernel<T, VEC>
                                          : rms_bwd_kernel<T, 1>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<n_part, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), rstd,
      static_cast<const T*>(g), static_cast<T*>(dx), part, rows, d, per, zc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rms_dscale_kernel<T><<<(d + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, static_cast<T*>(dscale), n_part, d);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The caller has
// checked shapes, dtypes and contiguity; rows >= 1, d >= 1.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y,
                           void* rstd, int dtype, int rows, int d, float eps,
                           int zero_centered, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  if (dtype == DTYPE_F32)
    return (int)fwd<float>(x, scale, y, r, rows, d, eps, zero_centered, st);
  if (dtype == DTYPE_BF16)
    return (int)fwd<__nv_bfloat16>(x, scale, y, r, rows, d, eps,
                                   zero_centered, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rmsnorm_bwd(const void* x, const void* scale,
                           const void* rstd, const void* g, void* dx,
                           void* dscale, void* part, int dtype, int rows,
                           int d, int zero_centered, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  if (dtype == DTYPE_F32)
    return (int)bwd<float>(x, scale, r, g, dx, dscale, p, rows, d,
                           zero_centered, st);
  if (dtype == DTYPE_BF16)
    return (int)bwd<__nv_bfloat16>(x, scale, r, g, dx, dscale, p, rows, d,
                                   zero_centered, st);
  return (int)cudaErrorInvalidValue;
}
