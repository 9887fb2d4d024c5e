// The decode kernels of one (dtype, head dim): csrc/decode_attention.cu
// says what they compute and how.  kernels/build.py::UNITS compiles this
// file once for each pair, with DECODE_DTYPE (csrc/common.cuh's dtype
// code) and DECODE_HD set, and links the objects into the one library.

#include <type_traits>

#include "decode_attention.cuh"

#if !defined(DECODE_DTYPE) || !defined(DECODE_HD)
#error "decode_attention_hd.cu: compile with DECODE_DTYPE and DECODE_HD"
#endif

namespace repro {
namespace decode {
namespace {

template <int HD, int G>
constexpr size_t smem_bytes() {
  // sQ[G][HD], sP[NWARPS][G][32], sM/sL[NWARPS][G], sA[NWARPS][G][HD]
  return sizeof(float) *
         (G * HD + NWARPS * G * 32 + 2 * NWARPS * G + NWARPS * G * HD);
}

// One split of one (KV head, batch).  With o set (one split) it writes the
// output, and with lse set the row's log-sum-exp m + log l (-inf where no
// key is live, whose output is 0); else its partial (m, l, acc) goes to
// pm, pl, pacc, indexed [split][batch * H + head] (pacc with a trailing
// head dim).
template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, float* __restrict__ lse,
              float* __restrict__ pm, float* __restrict__ pl,
              float* __restrict__ pacc, int T_len,
              int KV, int window, float scale, float softcap,
              int split_len) {
  using L = PvLayout<T, HD, G>;
  constexpr int VEC = L::VEC, PV = L::PV, LPR = L::LPR, CPL = L::CPL;
  constexpr int RPW = L::RPW, NA = L::NA;
  static_assert(L::BUILT,
                "decode_kernel: a (head dim, G) pair that is not built");

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sP = sQ + G * HD;
  float* sM = sP + NWARPS * G * 32;
  float* sL = sM + NWARPS * G;
  float* sA = sL + NWARPS * G;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int H = KV * G;
  const long long rs = (long long)KV * HD;  // cache row stride
  const T* qb = q + ((long long)b * H + (long long)kvh * G) * HD;
  T* ob = o + ((long long)b * H + (long long)kvh * G) * HD;
  const T* kb = k + (long long)b * T_len * rs + (long long)kvh * HD;
  const T* vb = v + (long long)b * T_len * rs + (long long)kvh * HD;

  for (int i = tid; i < G * HD; i += THREADS) sQ[i] = to_float(qb[i]);

  // live positions of this split: [lo, hi), possibly empty.  A length
  // past T_len (a shard of a cache split over its sequence, lengths
  // relative to its first position) still places the window's start
  const int raw = max(lengths[b], 0), len = min(raw, T_len);
  const int lo = max(window > 0 ? max(0, raw - window) : 0,
                     split * split_len);
  const int hi = min(len, (split + 1) * split_len);
  __syncthreads();

  const int rg = lane / LPR, c0 = lane % LPR * PV;  // row group, 1st dim
  float m[G], l[G], acc[G][NA];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[g][i] = 0.f;
  }
  float* sPw = sP + warp * G * 32;

  for (int base = lo + warp * 32; base < hi; base += NWARPS * 32) {
    // scores: lane owns position base + lane (position base is always live)
    const int t = base + lane;
    const bool ok = t < hi;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (ok) {
      const T* kr = kb + t * rs;
#pragma unroll
      for (int d = 0; d < HD; d += VEC) {
        float kf[VEC];
        load_vec<T, VEC>(kr + d, kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qq =
                *reinterpret_cast<const float4*>(&sQ[g * HD + d + e]);
            s[g] += qq.x * kf[e] + qq.y * kf[e + 1] + qq.z * kf[e + 2] +
                    qq.w * kf[e + 3];
          }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sc = ok ? finish_score(s[g], scale, softcap) : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(sc));
      const float alpha = expf(m[g] - m_new);
      const float p = ok ? expf(sc - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[g][i] *= alpha;
      sPw[g * 32 + lane] = p;
    }
    __syncwarp();

    // acc += P V: row group rg takes rows rg, rg + RPW, ...
    const int nj = rg < RPW ? min(32, hi - base) : 0;
    const T* vr = vb + base * rs + c0;
#pragma unroll 4
    for (int j = rg; j < nj; j += RPW) {
      float vf[NA];
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci)
        load_vec<T, PV>(vr + j * rs + ci * LPR * PV, vf + ci * PV);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = sPw[g * 32 + j];
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[g][i] += pj * vf[i];
      }
    }
    __syncwarp();
  }

  // sum the row groups' accumulators into the first one's lanes
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      float sum = acc[g][i];
#pragma unroll
      for (int r = 1; r < RPW; ++r)
        sum += __shfl_sync(FULL_MASK, acc[g][i], (lane + r * LPR) & 31);
      acc[g][i] = sum;
    }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sM[warp * G + g] = m[g];
      sL[warp * G + g] = l[g];
    }
    if (lane < LPR)
#pragma unroll
      for (int i = 0; i < NA; ++i)
        sA[(warp * G + g) * HD + c0 + i / PV * LPR * PV + i % PV] =
            acc[g][i];
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += THREADS) {
    const int g = idx / HD, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sM[w * G + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float mw = sM[w * G + g];
      if (mw == -INFINITY) continue;  // this warp saw no live position
      const float f = expf(mw - mx);
      lsum += sL[w * G + g] * f;
      a += sA[(w * G + g) * HD + d] * f;
    }
    if (o != nullptr) {
      ob[idx] = from_float<T>(a / fmaxf(lsum, 1e-30f));
      if (lse != nullptr && d == 0)
        lse[(long long)b * H + (long long)kvh * G + g] =
            lsum > 0.f ? mx + logf(lsum) : -INFINITY;
    } else {
      const long long bh = (long long)split * gridDim.z * H +
                           (long long)b * H + (long long)kvh * G + g;
      pacc[bh * HD + d] = a;
      if (d == 0) {
        pm[bh] = mx;
        pl[bh] = lsum;
      }
    }
  }
}

// Merge the n_split partials of each (batch, head) in split order; a split
// with m = -inf (no live key) has weight 0.  One thread per output element;
// with lse set, the first of a row's threads writes its log-sum-exp.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ pm,
                      const float* __restrict__ pl,
                      const float* __restrict__ pacc, T* __restrict__ o,
                      float* __restrict__ lse, int BH, int n_split) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)BH * HD) return;
  const int bh = (int)(idx / HD), d = (int)(idx % HD);
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s * BH + bh]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = pm[s * BH + bh];
    if (ms == -INFINITY) continue;
    const float f = expf(ms - mx);
    lsum += pl[s * BH + bh] * f;
    a += pacc[((long long)s * BH + bh) * HD + d] * f;
  }
  o[idx] = from_float<T>(a / fmaxf(lsum, 1e-30f));
  if (lse != nullptr && d == 0)
    lse[bh] = lsum > 0.f ? mx + logf(lsum) : -INFINITY;
}

template <typename T, int HD, int G>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<HD, G>();
  auto kern = decode_kernel<T, HD, G>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int BH = a.B * a.KV * G;
  const int split_len =
      ((a.T_len + a.n_split - 1) / a.n_split + 31) / 32 * 32;
  float* pm = a.n_split > 1 ? a.part : nullptr;
  float* pl = pm ? pm + (long long)a.n_split * BH : nullptr;
  float* pacc = pm ? pl + (long long)a.n_split * BH : nullptr;
  dim3 grid(a.n_split, a.KV, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lengths,
      a.n_split > 1 ? nullptr : static_cast<T*>(a.o), a.lse, pm, pl, pacc,
      a.T_len, a.KV, a.window, a.scale, a.softcap, split_len);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return e;
  const long long n = (long long)BH * HD;
  decode_combine_kernel<T, HD>
      <<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, a.stream>>>(
          pm, pl, pacc, static_cast<T*>(a.o), a.lse, BH, a.n_split);
  return cudaGetLastError();
}

// The (head dim, G) pairs that are built: PvLayout::BUILT.
template <typename T, int HD, int G>
cudaError_t launch_if_built(const Args& a) {
  if constexpr (PvLayout<T, HD, G>::BUILT)
    return a.dry ? cudaSuccess : launch<T, HD, G>(a);
  else
    return cudaErrorInvalidValue;
}

}  // namespace

template <typename T, int HD>
cudaError_t launch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch_if_built<T, HD, 1>(a);
    case 2: return launch_if_built<T, HD, 2>(a);
    case 4: return launch_if_built<T, HD, 4>(a);
    case 6: return launch_if_built<T, HD, 6>(a);
    case 7: return launch_if_built<T, HD, 7>(a);
    case 8: return launch_if_built<T, HD, 8>(a);
    case 16: return launch_if_built<T, HD, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

using UnitT = std::conditional_t<DECODE_DTYPE == DTYPE_F32, float,
                                 __nv_bfloat16>;
template cudaError_t launch_g<UnitT, DECODE_HD>(int G, const Args& a);

}  // namespace decode
}  // namespace repro
