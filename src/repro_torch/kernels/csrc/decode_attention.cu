// Grouped-query decode attention (one new token per sequence) for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas TPU kernel _dec_kernel).  Same function: q (B,1,H,hd) against a
// (B,T,KV,hd) cache, attending kpos in [max(0, len - window), len) for
// len = lengths[b]; optional tanh soft-cap; the G = H/KV query heads of one
// KV head share each loaded key and value; fp32 online softmax;
// out = acc / max(l, 1e-30) in the input dtype.
//
// What bounds it on the H100: the bytes of the cache.  Each cached key and
// value is read once and used for 4*G FLOPs per element pair, about
// G FLOP per byte in bf16, far below the ~295 FLOP/byte ridge; the least
// time is the live cache (sum of lengths x KV x hd x 2 tensors) over
// 3.35 TB/s.
//
// What this first design does about it:
//  * One CTA per (KV head, batch) holds all G query rows of the group, so
//    every key and value is read from device memory once (the TPU kernel
//    does the same with its (G, hd) query tile).
//  * The CTA reads its own length from device memory (this replaces the
//    TPU's scalar prefetch) and loops only over [max(0, len - window),
//    len), so the bytes moved are the live cache, not the allocated one.
//  * Its 8 warps stream disjoint 32-position chunks with independent
//    online-softmax state and merge (m, l, acc) through shared memory at
//    the end, which keeps 8 chunks of loads in flight per CTA.
//  * A (B, KV) = (8, 8) grid fills only 64 of the card's 132 SMs, which caps
//    the bandwidth it can reach.  Splitting T across CTAs with a second
//    combining pass (flash-decoding) is left to a later change.
//  * Head dims 32, 64, 80 and 128.  Keys are read at the true head dim in
//    16-byte vectors (an 80-dim bf16 row is ten); in the PV product each
//    lane owns HDP / 32 value dims, HDP being the head dim rounded up to
//    whole lanes (96 for 80), and dims past the head dim are neither
//    loaded nor stored.

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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int T_len, int KV, int window, float scale,
              float softcap) {
  constexpr int HDP = (HD + 31) / 32 * 32;  // head dim in whole lanes
  constexpr int DPL = HDP / 32;        // value dims owned by one lane
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte key load

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sP = sQ + G * HD;
  float* sM = sP + NWARPS * G * 32;
  float* sL = sM + NWARPS * G;
  float* sA = sL + NWARPS * G;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int H = KV * G;
  const long long rs = (long long)KV * HD;  // cache row stride
  const T* qb = q + ((long long)b * H + (long long)kvh * G) * HD;
  T* ob = o + ((long long)b * H + (long long)kvh * G) * HD;
  const T* kb = k + (long long)b * T_len * rs + (long long)kvh * HD;
  const T* vb = v + (long long)b * T_len * rs + (long long)kvh * HD;

  for (int i = tid; i < G * HD; i += THREADS) sQ[i] = to_float(qb[i]);

  const int len = min(max(lengths[b], 0), T_len);
  const int lo = window > 0 ? max(0, len - window) : 0;
  __syncthreads();

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }
  float* sPw = sP + warp * G * 32;

  for (int base = lo + warp * 32; base < len; base += NWARPS * 32) {
    // scores: lane owns position base + lane (position base is always live)
    const int t = base + lane;
    const bool ok = t < len;
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
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
      sPw[g * 32 + lane] = p;
    }
    __syncwarp();

    // acc += P V: lane owns value dims lane*DPL .. lane*DPL + DPL - 1
    const int nj = min(32, len - base);
    const T* vr = vb + base * rs + lane * DPL;
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      float vf[DPL];
      if constexpr (HDP == HD) {
        load_vec<T, DPL>(vr + j * rs, vf);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          vf[i] = lane * DPL + i < HD ? to_float(vr[j * rs + i]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = sPw[g * 32 + j];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] += pj * vf[i];
      }
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sM[warp * G + g] = m[g];
      sL[warp * G + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (lane * DPL + i < HD)
        sA[(warp * G + g) * HD + lane * DPL + i] = acc[g][i];
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
    ob[idx] = from_float<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int T_len, int KV,
                   int window, float scale, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, G>();
  auto kern = decode_kernel<T, HD, G>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(KV, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), T_len, KV,
      window, scale, softcap);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v,
                     const int* lengths, void* o, int B, int T_len, int KV,
                     int window, float scale, float softcap,
                     cudaStream_t st) {
  switch (G) {
    case 1:
      return launch<T, HD, 1>(q, k, v, lengths, o, B, T_len, KV, window,
                              scale, softcap, st);
    case 2:
      return launch<T, HD, 2>(q, k, v, lengths, o, B, T_len, KV, window,
                              scale, softcap, st);
    case 4:
      return launch<T, HD, 4>(q, k, v, lengths, o, B, T_len, KV, window,
                              scale, softcap, st);
    case 8:
      return launch<T, HD, 8>(q, k, v, lengths, o, B, T_len, KV, window,
                              scale, softcap, st);
    case 16:
      return launch<T, HD, 16>(q, k, v, lengths, o, B, T_len, KV, window,
                               scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_hd(int HD, int G, const void* q, const void* k,
                      const void* v, const int* lengths, void* o, int B,
                      int T_len, int KV, int window, float scale,
                      float softcap, cudaStream_t st) {
  switch (HD) {
    case 32:
      return launch_g<T, 32>(G, q, k, v, lengths, o, B, T_len, KV, window,
                             scale, softcap, st);
    case 64:
      return launch_g<T, 64>(G, q, k, v, lengths, o, B, T_len, KV, window,
                             scale, softcap, st);
    case 80:
      return launch_g<T, 80>(G, q, k, v, lengths, o, B, T_len, KV, window,
                             scale, softcap, st);
    case 128:
      return launch_g<T, 128>(G, q, k, v, lengths, o, B, T_len, KV, window,
                              scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The caller has
// checked shapes, dtypes, contiguity and 16-byte alignment; lengths is an
// int32 device array of B entries.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int dtype, int B, int T_len,
                                    int H, int KV, int HD, int window,
                                    float scale, float softcap,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  const int G = H / KV;
  if (dtype == DTYPE_F32)
    return (int)launch_hd<float>(HD, G, q, k, v, lens, o, B, T_len, KV,
                                 window, scale, softcap, st);
  if (dtype == DTYPE_BF16)
    return (int)launch_hd<__nv_bfloat16>(HD, G, q, k, v, lens, o, B, T_len,
                                         KV, window, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}
