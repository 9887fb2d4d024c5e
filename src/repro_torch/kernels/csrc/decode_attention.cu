// Grouped-query decode attention (one new token per sequence) for Hopper
// (sm_90a), split over the cache's positions (flash-decoding).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas TPU kernel _dec_kernel).  Same function: q (B,1,H,hd) against a
// (B,T,KV,hd) cache, attending kpos in [max(0, len - window), len) for
// len = lengths[b]; optional tanh soft-cap; the G = H/KV query heads of one
// KV head share each loaded key and value; fp32 online softmax;
// out = acc / max(l, 1e-30) in the input dtype.  A sequence with
// lengths[b] == 0 gets 0, as _dec_kernel gives it; the oracle
// (kernels/ref.py) gives the mean of V there.  The model never passes a
// length of 0.
//
// What bounds it on the H100: the bytes of the cache.  Each cached key and
// value is read once and used for 4*G FLOPs per element pair, about
// G FLOP per byte in bf16, far below the ~295 FLOP/byte ridge; the least
// time is the live cache (sum of lengths x KV x hd x 2 tensors) over
// 3.35 TB/s.
//
// What the design does about it:
//  * Grid (n_split, KV, B).  A (B, KV) = (8, 8) grid alone filled 64 of
//    the card's 132 SMs; the host splits the allocated T into n_split
//    equal ranges (kernels/decode_attention.py::n_splits picks it from
//    B*KV and T alone, never from the lengths, which are on the device, so
//    the launch needs no sync): CTAs to fill every SM's 2048 threads, each
//    range at least 256 positions.
//  * Each CTA still holds all G query rows of its KV head, so every key and
//    value is read from device memory once.  It reads its own length (this
//    replaces the TPU's scalar prefetch) and streams only the live
//    positions of its range, [max(0, len - window), len) clipped to it.
//  * Its 8 warps stream disjoint 32-position chunks with independent
//    online-softmax state and merge (m, l, acc) through shared memory at
//    the end, which keeps 8 chunks of loads in flight per CTA.
//  * With one split the CTA writes the output.  With more, each writes its
//    fp32 partial (m, l, acc) to a scratch buffer and a second small
//    kernel merges the partials of each (batch, head) in split order, so
//    the result is bit-equal from call to call; no CTA waits on another.
//    A split with no live key (past len, or before len - window) leaves
//    m = -inf, l = 0, acc = 0, and the merge gives it weight 0 without
//    forming exp(-inf - (-inf)).
//  * Products stay on the CUDA cores in fp32: at G <= 16 query rows the
//    tensor cores' 64-row tiles would be mostly padding, and the bytes
//    bound the kernel, not the operations.
//  * Head dims 32, 64, 80, 128 and 256; G = 1, 2, 4, 6, 7, 8 and 16.  Keys
//    are read at the true head dim in 16-byte vectors (an 80-dim bf16 row
//    is ten), a lane a position.  In the PV product a lane reads a vector
//    of one value row, so a warp reads whole rows at once (three rows of
//    ten lanes at hd 80 bf16); the row groups' sums meet by shuffles at
//    the end.  At G = 16 the vectors are halved to keep the accumulators
//    in registers.  A row wider than 32 vectors (hd 256 in fp32, or at
//    G = 16) is covered by each lane taking CPL vectors 32 vectors apart.
//    A lane then holds G * hd / 32 accumulators; the pairs where that
//    passes 64, (256, 16) alone, are not built (PvLayout::BUILT, the one
//    statement of the rule), and the wrapper
//    (kernels/decode_attention.py::instantiated) refuses them; the
//    exported decode_attention_built lets a test hold the two together.
//    Shared memory comes to 72 KB at (256, 7) and 81 KB at (256, 8): two
//    CTAs an SM by shared memory, one by registers where a thread needs
//    more than 128 (bf16: 182 at (256, 7), 140 at (256, 8) and (128, 7);
//    -Xptxas -v on the card).

#include "common.cuh"

using namespace repro;

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;

template <int HD, int G>
constexpr size_t smem_bytes() {
  // sQ[G][HD], sP[NWARPS][G][32], sM/sL[NWARPS][G], sA[NWARPS][G][HD]
  return sizeof(float) *
         (G * HD + NWARPS * G * 32 + 2 * NWARPS * G + NWARPS * G * HD);
}

// The P V layout of (T, HD, G): a lane loads PV consecutive value dims of
// one row, CPL times, LPR vectors apart; LPR lanes cover a row, and a warp
// RPW rows at once (lanes past RPW * LPR idle); NA accumulators a lane a
// query row.  BUILT: the layout covers the row and a lane's G * NA
// accumulators fit 64 registers; the kernel asserts it and the launch
// switch instantiates only such pairs.
template <typename T, int HD, int G>
struct PvLayout {
  static constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte load
  static constexpr int PV = VEC * G <= 64 ? VEC : 64 / G;
  static constexpr int LPR = HD / PV < 32 ? HD / PV : 32;
  static constexpr int CPL = HD / (PV * LPR), RPW = 32 / LPR;
  static constexpr int NA = CPL * PV;
  static constexpr bool BUILT = CPL * PV * LPR == HD && G * NA <= 64;
};

// One split of one (KV head, batch).  With o set (one split) it writes the
// output; else its partial (m, l, acc) goes to pm, pl, pacc, indexed
// [split][batch * H + head] (pacc with a trailing head dim).
template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, float* __restrict__ pm,
              float* __restrict__ pl, float* __restrict__ pacc, int T_len,
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

  // live positions of this split: [lo, hi), possibly empty
  const int len = min(max(lengths[b], 0), T_len);
  const int lo = max(window > 0 ? max(0, len - window) : 0,
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
// with m = -inf (no live key) has weight 0.  One thread per output element.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ pm,
                      const float* __restrict__ pl,
                      const float* __restrict__ pacc, T* __restrict__ o,
                      int BH, int n_split) {
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
}

// Arguments shared by the launchers below.
struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* o;
  float* part;  // n_split > 1: pm, pl, pacc one after the other
  int B, T_len, KV, window, n_split;
  float scale, softcap;
  cudaStream_t stream;
  bool dry = false;  // only report whether the pair is built; launch nothing
};

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
      a.n_split > 1 ? nullptr : static_cast<T*>(a.o), pm, pl, pacc,
      a.T_len, a.KV, a.window, a.scale, a.softcap, split_len);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return e;
  const long long n = (long long)BH * HD;
  decode_combine_kernel<T, HD>
      <<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, a.stream>>>(
          pm, pl, pacc, static_cast<T*>(a.o), BH, a.n_split);
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

template <typename T>
cudaError_t launch_hd(int HD, int G, const Args& a) {
  switch (HD) {
    case 32: return launch_g<T, 32>(G, a);
    case 64: return launch_g<T, 64>(G, a);
    case 80: return launch_g<T, 80>(G, a);
    case 128: return launch_g<T, 128>(G, a);
    case 256: return launch_g<T, 256>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  The caller has
// checked shapes, dtypes, contiguity and 16-byte alignment; lengths is an
// int32 device array of B entries; with n_split > 1, part is fp32 scratch
// of n_split * B * H * (HD + 2) floats (null with one split).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, void* part, int dtype, int B,
                                    int T_len, int H, int KV, int HD,
                                    int window, float scale, float softcap,
                                    int n_split, void* stream) {
  if (KV < 1 || H % KV || n_split < 1 || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(lengths), o,
               static_cast<float*>(part), B, T_len, KV, window, n_split,
               scale, softcap, static_cast<cudaStream_t>(stream)};
  if (dtype == DTYPE_F32) return (int)launch_hd<float>(HD, H / KV, a);
  if (dtype == DTYPE_BF16)
    return (int)launch_hd<__nv_bfloat16>(HD, H / KV, a);
  return (int)cudaErrorInvalidValue;
}

// 1 where decode_attention_fwd launches (dtype, HD, G = H / KV), else 0:
// the launch switch itself, run without a launch.
extern "C" int decode_attention_built(int dtype, int HD, int G) {
  Args a{};
  a.dry = true;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == DTYPE_F32) e = launch_hd<float>(HD, G, a);
  if (dtype == DTYPE_BF16) e = launch_hd<__nv_bfloat16>(HD, G, a);
  return e == cudaSuccess ? 1 : 0;
}
