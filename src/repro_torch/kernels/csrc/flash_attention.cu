// Grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel _fa_kernel).  Same function: q (B,S,H,hd) against
// k, v (B,T,KV,hd) with kv head = h / (H/KV); optional causal mask with
// query positions offset by q_offset, sliding window (qpos - kpos < window),
// tanh soft-cap; fp32 running max m, sum l and accumulator;
// out = acc / max(l, 1e-30) in the input dtype.  When the caller passes
// an lse pointer (training: the backward needs it), each row's fp32
// log-sum-exp m + log(l) is written to lse[b][h][row] as well, and +inf for
// a row with no live key, so that the backward's exp(s - lse) is 0 there;
// the serving paths pass null and pay nothing for it.
//
// What bounds it on the H100: arithmetic.  Attention does 4*hd FLOPs per
// live (query, key) pair and reads each of q, k, v once, so its intensity
// grows with the prompt length: about S/2.5 FLOP per byte for causal GQA at
// H/KV = 4 and hd = 64, past the card's ~295 FLOP/byte ridge from S ~ 750.
// Below that (the slice's prompts of <= 512 tokens) the roofline bound is
// the bytes, but this kernel is held far below either by running its
// products on the CUDA cores in fp32.
//
// What this first design does about it:
//  * The TPU kernel runs its kv grid axis in order with (m, l, acc) carried
//    in VMEM scratch.  Here one CTA owns one (32-query tile, head, batch)
//    and loops over kv tiles itself; m, l and acc live in registers.
//  * The loop starts at the window's first live tile and stops at the
//    causal frontier of the tile's last row, so fully masked kv tiles cost
//    nothing (the TPU kernel skips them with pl.when).
//  * Ragged S and T edges are masked in the kernel: no S % 128 == 0 and no
//    q_offset == 0 requirement.
//  * Each K/V tile is staged once in shared memory as fp32 and shared by
//    the CTA's 4 warps x 8 query rows; scores and the PV product are fp32
//    FMAs on the CUDA cores.  No wgmma, TMA or warp specialisation yet:
//    moving both products onto the tensor cores is the next step.
//  * Head dims 32, 64, 80 and 128.  In the PV product each lane owns
//    HDP / 32 output dims, HDP being the head dim rounded up to whole
//    lanes (96 for 80).  Q and K are staged at the true head dim (q.k runs
//    over it in float4 steps); V is staged HDP wide with the pad columns
//    zeroed once, and the pad output dims are never stored.  Global loads
//    and stores stay at the true head dim: an 80-dim bf16 row is 160
//    bytes, ten 16-byte vectors.

#include "common.cuh"

using namespace repro;

namespace {

constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int RPW = 8;            // query rows per warp
constexpr int BQ = NWARPS * RPW;  // query rows per CTA

template <int HD>
struct Tile {
  static constexpr int HDP = (HD + 31) / 32 * 32;  // head dim in whole lanes
  static constexpr int BK = HD <= 64 ? 64 : 32;  // kv rows per tile
  static constexpr int KS = HD + 4;   // padded fp32 row stride of sQ, sK
  static constexpr int DPL = HDP / 32;  // output dims owned by one lane
  static constexpr int JPL = BK / 32;  // kv columns scored by one lane
  static constexpr size_t SMEM =
      sizeof(float) * (BQ * KS + BK * KS + BK * HDP + NWARPS * RPW * BK);
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int T_len, int H, int KV,
                 int causal, int window, float scale, float softcap,
                 int q_offset) {
  using C = Tile<HD>;
  constexpr int BK = C::BK, KS = C::KS, DPL = C::DPL, JPL = C::JPL;
  constexpr int HDP = C::HDP;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = HD / VEC;        // 16-byte loads per row

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [BQ][KS]
  float* sK = sQ + BQ * KS;     // [BK][KS]
  float* sV = sK + BK * KS;     // [BK][HDP]
  float* sP = sV + BK * HDP;    // [NWARPS * RPW][BK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qrs = (long long)H * HD;   // row stride of q and o
  const long long kvrs = (long long)KV * HD;  // row stride of k and v
  const T* qb = q + (long long)b * S * qrs + (long long)h * HD;
  T* ob = o + (long long)b * S * qrs + (long long)h * HD;
  const T* kb = k + (long long)b * T_len * kvrs + (long long)kvh * HD;
  const T* vb = v + (long long)b * T_len * kvrs + (long long)kvh * HD;

  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    float tmp[VEC];
    if (q0 + r < S) {
      load_vec<T, VEC>(qb + (q0 + r) * qrs + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sQ[r * KS + c + e] = tmp[e];
  }
  if constexpr (HDP != HD) {  // V's pad columns: zero once, never rewritten
    for (int i = tid; i < BK * (HDP - HD); i += THREADS)
      sV[(i / (HDP - HD)) * HDP + HD + i % (HDP - HD)] = 0.f;
  }

  // kv range of this CTA: window start of its first row to the causal
  // frontier of its last row
  const int n_rows = min(BQ, S - q0);
  const int pos_lo = q_offset + q0;
  const int pos_hi = pos_lo + n_rows - 1;
  int kv_end = T_len;
  if (causal) kv_end = min(kv_end, pos_hi + 1);
  int kv_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const int rbase = warp * RPW;

  for (int kt = kv_begin; kt < kv_end; kt += BK) {
    __syncthreads();  // the previous tile is consumed; sQ is visible
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int r = i / VPR, c = (i % VPR) * VEC;
      const int t = kt + r;
      float tk[VEC], tv[VEC];
      if (t < T_len) {
        load_vec<T, VEC>(kb + t * kvrs + c, tk);
        load_vec<T, VEC>(vb + t * kvrs + c, tv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sK[r * KS + c + e] = tk[e];
        sV[r * HDP + c + e] = tv[e];
      }
    }
    __syncthreads();

    // scores: lane owns kv columns lane + 32*c of the tile
    float s[RPW][JPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < JPL; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kk[JPL];
#pragma unroll
      for (int c = 0; c < JPL; ++c)
        kk[c] = *reinterpret_cast<const float4*>(&sK[(lane + 32 * c) * KS + d]);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&sQ[(rbase + r) * KS + d]);
#pragma unroll
        for (int c = 0; c < JPL; ++c)
          s[r][c] += qq.x * kk[c].x + qq.y * kk[c].y + qq.z * kk[c].z +
                     qq.w * kk[c].w;
      }
    }

    // online softmax, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = q0 + rbase + r;
      const int qpos = q_offset + row;
      float sc[JPL];
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < JPL; ++c) {
        const int kpos = kt + lane + 32 * c;
        bool ok = row < S && kpos < T_len;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        sc[c] = ok ? finish_score(s[r][c], scale, softcap) : -INFINITY;
        mt = fmaxf(mt, sc[c]);
      }
      mt = warp_max(mt);
      const float m_new = fmaxf(m[r], mt);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < JPL; ++c) {
        const float p = sc[c] == -INFINITY ? 0.f : expf(sc[c] - m_new);
        sP[(rbase + r) * BK + lane + 32 * c] = p;
        psum += p;
      }
      l[r] = l[r] * alpha + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();

    // acc += P V: lane owns output dims lane*DPL .. lane*DPL + DPL - 1
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        load_floats<DPL>(&sV[(j + jj) * HDP + lane * DPL], vv[jj]);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 pp =
            *reinterpret_cast<const float4*>(&sP[(rbase + r) * BK + j]);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[r][i] += pp.x * vv[0][i] + pp.y * vv[1][i] + pp.z * vv[2][i] +
                       pp.w * vv[3][i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + rbase + r;
    if (row >= S) continue;
    if (lse != nullptr && lane == 0)
      lse[((long long)b * H + h) * S + row] =
          l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float out[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = acc[r][i] * inv;
    if constexpr (HDP == HD) {
      store_vec<T, DPL>(ob + row * qrs + lane * DPL, out);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        if (lane * DPL + i < HD)
          ob[row * qrs + lane * DPL + i] = from_float<T>(out[i]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int T_len, int H, int KV,
                   int causal, int window, float scale, float softcap,
                   int q_offset, cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::SMEM;
  auto kern = flash_fwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, T_len, H, KV,
      causal, window, scale, softcap, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int HD, const void* q, const void* k, const void* v,
                      void* o, float* lse, int B, int S, int T_len, int H,
                      int KV, int causal, int window, float scale,
                      float softcap, int q_offset, cudaStream_t stream) {
  switch (HD) {
#define REPRO_CASE(D)                                                      \
  case D:                                                                  \
    return launch<T, D>(q, k, v, o, lse, B, S, T_len, H, KV, causal, window, \
                        scale, softcap, q_offset, stream);
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(80)
    REPRO_CASE(128)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The caller has
// checked shapes, dtypes, contiguity and 16-byte alignment.  lse is null or
// a (B, H, S) fp32 buffer.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int dtype, int B, int S, int T_len, int H,
                                   int KV, int HD, int causal, int window,
                                   float scale, float softcap, int q_offset,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == DTYPE_F32)
    return (int)launch_hd<float>(HD, q, k, v, o, l, B, S, T_len, H, KV,
                                 causal, window, scale, softcap, q_offset,
                                 st);
  if (dtype == DTYPE_BF16)
    return (int)launch_hd<__nv_bfloat16>(HD, q, k, v, o, l, B, S, T_len, H,
                                         KV, causal, window, scale, softcap,
                                         q_offset, st);
  return (int)cudaErrorInvalidValue;
}
