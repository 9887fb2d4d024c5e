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
// (bf16) or 4 bytes moved: the forward reads x and writes y (and 4 bytes
// of rstd a row when the caller asks), the backward reads x and g and
// writes dx.  At the training shape (8192 rows of 2048 bf16) that is 67 MB
// forward, ~20 us at 3.35 TB/s, and 100 MB backward, ~30 us.
//
// The design (kernels/rmsnorm.py::launch_shape picks every launch shape on
// the host, from rows, d and the dtype):
//  * One read.  A row is shared by `tpr` threads.  Each loads its NPT
//    vectors of the row (16 bytes each, vectors li, li + tpr, ...) once,
//    and they stay in registers (NPT is a template constant): the sum of
//    squares and the scaling (forward), the dot g w xh and dx (backward)
//    read registers, never the row again.
//  * Packed rows.  A CTA holds threads / tpr rows at a time.  A thread's
//    columns are the same in every row, so it loads scale once and keeps
//    it for every row it takes.  In the forward a thread takes one row
//    (walking more rows a CTA was no faster on the card); in the backward
//    a CTA walks a run of rows_per_cta rows, each row's loads issued one
//    row ahead of its reduction.
//  * Registers bound the rows in flight on an SM, so a thread holds few
//    loads (at the slices' widths 4 or 5 in the packed forward, 2 in the
//    backward) and a row has many threads.  Left alone, the compiler keeps
//    the floats it converted from a packed row live across the row's
//    reduction, and hoists scale's out of the row loop; `opaque` makes it
//    convert again where the floats are used.
//  * Reductions: xor shuffles among a row's lanes (tpr a power of two up
//    to 32), and one shared-memory step over a row's warps only where a
//    row spans several (tpr a multiple of 32).
//  * dscale with no atomics and no per-element shared-memory
//    read-modify-write: each thread sums g xh of its own columns over the
//    rows it walks in fp32 registers; at the end the CTA adds its row
//    groups' sums in group order in shared memory and writes one row of
//    the (n_part, d) scratch, and a second kernel adds the n_part rows in
//    a fixed order.  n_part and the rows of each CTA depend on the row
//    count alone, so dx and dscale are bit-equal from call to call.
//  * Few rows (a decode step: 8 rows of 2048 to 5120) move 32 to 80 KB,
//    far too little to fill the card's memory pipes; the time is the
//    launch, one round trip to memory, the reduction and the store, so it
//    is bound by latency, not bytes.  There, and up to the slices'
//    prefills, each row gets a CTA of its own and as many threads as hold
//    two vectors each (or the fewest vectors a thread that fit a CTA): a
//    short chain of dependent steps.  Two vectors a thread matched or
//    beat one at the shapes timed on the card; packed rows win from ~2M
//    elements a call (kernels/rmsnorm.py FEW_ELEMS).
//  * Any d and any alignment: where d is not a multiple of the vector or
//    a pointer is not 16-byte aligned, the same kernels run with one
//    element a load (VEC = 1).
//  * The forward writes rstd only when given a pointer (the training
//    forward, for the backward); serving passes null.

#include "common.cuh"

using namespace repro;

namespace {

// kernels/rmsnorm.py sets both of these (NPTS, BUDGET); kernels/build.py
// hands them to nvcc in a header it includes first.
#if !defined(RMS_NPTS) || !defined(RMS_BUDGET)
#error "build with kernels/build.py, which passes RMS_NPTS and RMS_BUDGET"
#endif

// Loads (VEC elements each) a thread holds: the NPT instances compiled.
template <int... N> struct NptList {};
using Npts = NptList<RMS_NPTS>;

// Most threads a CTA for a thread that holds `elems` elements of a row:
// the first (elements, threads) pair of the budget that takes `elems`.
template <int E, int T, int... More>
__host__ __device__ constexpr int budget(int elems) {
  if constexpr (sizeof...(More) == 0) {
    return elems <= E ? T : 0;
  } else {
    return elems <= E ? T : budget<More...>(elems);
  }
}

__host__ __device__ constexpr int max_threads(int elems) {
  return budget<RMS_BUDGET>(elems);
}

template <typename T, int VEC>
using RawVec = typename Raw<VEC * sizeof(T)>::type;

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const RawVec<T, VEC>& r, float* out) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_float(e[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ RawVec<T, VEC> pack(const float* in) {
  RawVec<T, VEC> r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(in[i]);
  return r;
}

// Hide a packed vector's value from the compiler, so that it converts the
// vector to floats again where they are used: otherwise it keeps the
// converted floats live across the row's reduction, or hoists scale's out
// of the row loop, and the registers that costs halve the rows in flight.
template <typename R>
__device__ __forceinline__ void opaque(R& r) {
  if constexpr (sizeof(R) >= 4) {
    unsigned* u = reinterpret_cast<unsigned*>(&r);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(R) / 4); ++i)
      asm volatile("" : "+r"(u[i]));
  } else {
    asm volatile("" : "+h"(*reinterpret_cast<unsigned short*>(&r)));
  }
}

// The sum of v over the tpr threads of a row: a power of two up to 32, or
// a multiple of 32 (then red holds a float a warp).  Every thread of the
// CTA calls it with the same tpr.
__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
  if (tpr <= 32) {
    for (int o = tpr / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;
  }
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, wpr = tpr / 32;
  const int first = warp - warp % wpr;
  __syncthreads();  // red may still be read for the previous row
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < wpr; ++i) s += red[first + i];  // in warp order
  return s;
}

// This thread's loads of a row (or of scale): vectors li + j tpr, zero
// past the row or where the row is not `live`.
template <typename T, int VEC, int NPT>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, int li,
                                          int tpr, int nv, bool live,
                                          RawVec<T, VEC>* out) {
  const RawVec<T, VEC>* pv = reinterpret_cast<const RawVec<T, VEC>*>(p);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int v = li + j * tpr;
    out[j] = live && v < nv ? pv[v] : RawVec<T, VEC>{};
  }
}

// Row `row` of p where it is one of the CTA's rows (row < r1), else p,
// which is then not read.
template <typename T>
__device__ __forceinline__ const T* row_of(const T* p, int row, int r1,
                                           int d) {
  return p + (row < r1 ? (long long)row * d : 0);
}

// A thread walks the rows gi, gi + group, ... of its CTA's run (one row
// with the forward's plans: walking more was no faster on the card).
template <typename T, int VEC, int NPT>
__global__ void __launch_bounds__(max_threads(NPT * VEC))
rms_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ y, float* __restrict__ rstd, int rows, int d,
               int tpr, int rows_per_cta, float eps, int zero_centered) {
  using R = RawVec<T, VEC>;
  __shared__ float red[32];
  const int nv = d / VEC, group = blockDim.x / tpr;
  const int gi = threadIdx.x / tpr, li = threadIdx.x % tpr;
  R w[NPT];
  load_cols<T, VEC, NPT>(scale, li, tpr, nv, true, w);
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(rows, r0 + rows_per_cta);
  for (int base = r0; base < r0 + rows_per_cta; base += group) {
    const int row = base + gi;
    R xv[NPT];
    load_cols<T, VEC, NPT>(row_of(x, row, r1, d), li, tpr, nv, row < r1,
                           xv);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      float f[VEC];
      unpack<T, VEC>(xv[j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
    }
    const float r = rsqrtf(row_sum(ss, tpr, red) / d + eps);
    if (row < r1) {
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        opaque(xv[j]);
        opaque(w[j]);
      }
      if (rstd != nullptr && li == 0) rstd[row] = r;
      R* yr = reinterpret_cast<R*>(y + (long long)row * d);
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int v = li + j * tpr;
        if (v >= nv) continue;
        float f[VEC], s[VEC];
        unpack<T, VEC>(xv[j], f);
        unpack<T, VEC>(w[j], s);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          f[e] = f[e] * r * (zero_centered ? 1.f + s[e] : s[e]);
        yr[v] = pack<T, VEC>(f);
      }
    }
  }
}

// First pass of the backward: dx of the CTA's rows, and the CTA's sums of
// g xh, column by column, into part[blockIdx.x][d].  Dynamic shared
// memory: 32 floats for row_sum, then d for the CTA's sums.  A thread
// walks rows as in the forward, and issues each row's loads one row
// ahead, before the reduction of the row before, so that it has a row in
// flight while it reduces and stores the last.
template <typename T, int VEC, int NPT>
__global__ void __launch_bounds__(max_threads(NPT * VEC))
rms_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               const float* __restrict__ rstd, const T* __restrict__ g,
               T* __restrict__ dx, float* __restrict__ part, int rows, int d,
               int tpr, int rows_per_cta, int zero_centered) {
  using R = RawVec<T, VEC>;
  extern __shared__ float smem[];
  float* red = smem;
  float* sdw = smem + 32;
  const int nv = d / VEC, group = blockDim.x / tpr;
  const int gi = threadIdx.x / tpr, li = threadIdx.x % tpr;
  R w[NPT];
  load_cols<T, VEC, NPT>(scale, li, tpr, nv, true, w);
  float dw[NPT][VEC];  // sums of g xh over this thread's rows
#pragma unroll
  for (int j = 0; j < NPT; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) dw[j][e] = 0.f;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(rows, r0 + rows_per_cta);
  int row = r0 + gi;
  R xv[NPT], gv[NPT];
  load_cols<T, VEC, NPT>(row_of(x, row, r1, d), li, tpr, nv, row < r1, xv);
  load_cols<T, VEC, NPT>(row_of(g, row, r1, d), li, tpr, nv, row < r1, gv);
  float r = row < r1 ? rstd[row] : 0.f;
  for (int base = r0; base < r0 + rows_per_cta; base += group, row += group) {
    const int next = row + group;
    R xn[NPT], gn[NPT];
    load_cols<T, VEC, NPT>(row_of(x, next, r1, d), li, tpr, nv, next < r1,
                           xn);
    load_cols<T, VEC, NPT>(row_of(g, next, r1, d), li, tpr, nv, next < r1,
                           gn);
    const float rn = next < r1 ? rstd[next] : 0.f;
#pragma unroll
    for (int j = 0; j < NPT; ++j) opaque(w[j]);
    float dot = 0.f;  // g w xh over this thread's columns
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      float xf[VEC], gf[VEC], s[VEC];
      unpack<T, VEC>(xv[j], xf);
      unpack<T, VEC>(gv[j], gf);
      unpack<T, VEC>(w[j], s);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = xf[e] * r;
        dot += gf[e] * (zero_centered ? 1.f + s[e] : s[e]) * xh;
        dw[j][e] += gf[e] * xh;  // zero on a dead row or column
      }
    }
    const float mean = row_sum(dot, tpr, red) / d;
    if (row < r1) {
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        opaque(xv[j]);
        opaque(gv[j]);
        opaque(w[j]);
      }
      R* dxr = reinterpret_cast<R*>(dx + (long long)row * d);
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int v = li + j * tpr;
        if (v >= nv) continue;
        float xf[VEC], gf[VEC], s[VEC], out[VEC];
        unpack<T, VEC>(xv[j], xf);
        unpack<T, VEC>(gv[j], gf);
        unpack<T, VEC>(w[j], s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = xf[e] * r;
          const float gw = gf[e] * (zero_centered ? 1.f + s[e] : s[e]);
          out[e] = r * (gw - xh * mean);
        }
        dxr[v] = pack<T, VEC>(out);
      }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      xv[j] = xn[j];
      gv[j] = gn[j];
    }
    r = rn;
  }
  // the CTA's sums, in group order: group 0 stores, each next group adds
  for (int k = 0; k < group; ++k) {
    if (gi == k) {
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int v = li + j * tpr;
        if (v >= nv) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int c = v * VEC + e;
          sdw[c] = k == 0 ? dw[j][e] : sdw[c] + dw[j][e];
        }
      }
    }
    __syncthreads();
  }
  float* pr = part + (long long)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) pr[c] = sdw[c];
}

// Second pass: dscale[c] = the sum of part[.][c] over the n_part rows.  A
// CTA takes DS_COLS columns; its DS_SLICES warps sum interleaved rows, and
// the slices are added in slice order.
constexpr int DS_COLS = 32, DS_SLICES = 8;

template <typename T>
__global__ void __launch_bounds__(DS_COLS * DS_SLICES)
rms_dscale_kernel(const float* __restrict__ part, T* __restrict__ dscale,
                  int n_part, int d) {
  __shared__ float s[DS_SLICES][DS_COLS];
  const int lane = threadIdx.x % DS_COLS, slice = threadIdx.x / DS_COLS;
  const int c = blockIdx.x * DS_COLS + lane;
  float acc = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int i = slice; i < n_part; i += DS_SLICES)
      acc += part[(long long)i * d + c];
  }
  s[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && c < d) {
    float t = s[0][lane];
    for (int k = 1; k < DS_SLICES; ++k) t += s[k][lane];
    dscale[c] = from_float<T>(t);
  }
}

// A launch shape from kernels/rmsnorm.py::launch_shape.
struct Plan {
  int vec, npt, tpr, threads, rows_per_cta, grid;
};

struct FwdArgs {
  const void *x, *scale;
  void* y;
  float* rstd;
  int rows, d;
  float eps;
  int zc;
};

struct BwdArgs {
  const void *x, *scale;
  const float* rstd;
  const void* g;
  void *dx, *dscale;
  float* part;
  int rows, d, zc;
};

// Whether the kernels can run `p`: a vector of 16 bytes needs d a multiple
// of it and every row pointer 16-byte aligned; the threads must hold the
// row within the instance's register budget, and the CTAs cover the rows.
template <typename T>
bool plan_ok(const Plan& p, int rows, int d, const void* const* ptrs,
             int n) {
  constexpr int V = 16 / sizeof(T);
  if (p.vec == V) {
    if (d % V) return false;
    for (int i = 0; i < n; ++i)
      if (reinterpret_cast<size_t>(ptrs[i]) % 16) return false;
  } else if (p.vec != 1) {
    return false;
  }
  const bool tpr_ok = p.tpr >= 1 && (p.tpr <= 32
                                         ? (p.tpr & (p.tpr - 1)) == 0
                                         : p.tpr % 32 == 0);
  return tpr_ok && p.npt >= 1 && p.threads % 32 == 0 &&
         p.threads % p.tpr == 0 &&
         p.threads <= max_threads(p.npt * p.vec) &&
         (long long)p.tpr * p.npt >= d / p.vec && p.rows_per_cta >= 1 &&
         p.grid >= 1 && (long long)p.grid * p.rows_per_cta >= rows;
}

template <typename T, int VEC, int NPT>
cudaError_t launch(const Plan& p, const FwdArgs& a, cudaStream_t st) {
  rms_fwd_kernel<T, VEC, NPT><<<p.grid, p.threads, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.scale),
      static_cast<T*>(a.y), a.rstd, a.rows, a.d, p.tpr, p.rows_per_cta,
      a.eps, a.zc);
  return cudaGetLastError();
}

template <typename T, int VEC, int NPT>
cudaError_t launch(const Plan& p, const BwdArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * (32 + a.d);
  auto kern = rms_bwd_kernel<T, VEC, NPT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<p.grid, p.threads, smem, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.scale), a.rstd,
      static_cast<const T*>(a.g), static_cast<T*>(a.dx), a.part, a.rows,
      a.d, p.tpr, p.rows_per_cta, a.zc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rms_dscale_kernel<T><<<(a.d + DS_COLS - 1) / DS_COLS,
                         DS_COLS * DS_SLICES, 0, st>>>(
      a.part, static_cast<T*>(a.dscale), p.grid, a.d);
  return cudaGetLastError();
}

// The instance of p.vec and p.npt, or cudaErrorInvalidValue if none.
template <typename T, typename A, int... N>
cudaError_t dispatch(NptList<N...>, const Plan& p, const A& a,
                     cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  cudaError_t e = cudaErrorInvalidValue;
  (void)((p.npt == N &&
          ((e = p.vec == 1 ? launch<T, 1, N>(p, a, st)
                           : launch<T, V, N>(p, a, st)),
           true)) ||
         ...);
  return e;
}

template <typename T, typename A>
int run(const Plan& p, const A& a, const void* const* ptrs, int n,
        void* stream) {
  if (!plan_ok<T>(p, a.rows, a.d, ptrs, n)) return (int)cudaErrorInvalidValue;
  return (int)dispatch<T>(Npts{}, p, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Both return the cudaError_t of the launches (0 on success), and
// cudaErrorInvalidValue for a plan the kernels cannot run.  The caller has
// checked shapes, dtypes and contiguity; rows >= 1, d >= 1.  rstd may be
// null in the forward.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y,
                           void* rstd, int dtype, int rows, int d, float eps,
                           int zero_centered, int vec, int npt, int tpr,
                           int threads, int rows_per_cta, int grid,
                           void* stream) {
  const Plan p{vec, npt, tpr, threads, rows_per_cta, grid};
  const FwdArgs a{x, scale, y, static_cast<float*>(rstd), rows, d, eps,
                  zero_centered};
  const void* ptrs[] = {x, scale, y};
  if (dtype == DTYPE_F32) return run<float>(p, a, ptrs, 3, stream);
  if (dtype == DTYPE_BF16) return run<__nv_bfloat16>(p, a, ptrs, 3, stream);
  return (int)cudaErrorInvalidValue;
}

// part: (grid, d) fp32 scratch, one row a CTA.
extern "C" int rmsnorm_bwd(const void* x, const void* scale,
                           const void* rstd, const void* g, void* dx,
                           void* dscale, void* part, int dtype, int rows,
                           int d, int zero_centered, int vec, int npt,
                           int tpr, int threads, int rows_per_cta, int grid,
                           void* stream) {
  const Plan p{vec, npt, tpr, threads, rows_per_cta, grid};
  const BwdArgs a{x, scale, static_cast<const float*>(rstd), g, dx, dscale,
                  static_cast<float*>(part), rows, d, zero_centered};
  const void* ptrs[] = {x, scale, g, dx};
  if (dtype == DTYPE_F32) return run<float>(p, a, ptrs, 4, stream);
  if (dtype == DTYPE_BF16) return run<__nv_bfloat16>(p, a, ptrs, 4, stream);
  return (int)cudaErrorInvalidValue;
}
