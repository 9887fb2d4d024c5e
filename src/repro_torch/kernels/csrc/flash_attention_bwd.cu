// Grouped-query flash attention, backward, for Hopper (sm_90a).
//
// Has no Pallas counterpart: the JAX package never differentiates its TPU
// kernel (src/repro/kernels/flash_attention.py::_fa_kernel); it
// differentiates the jnp oracle.  This is the gradient of the forward in
// flash_attention.cu, FA2-style: P is recomputed from the log-sum-exp the
// forward saved, so no (S, T) matrix is ever stored.  For each live
// (query i, key j) pair of head h (kv head h / G):
//   s = scale q_i.k_j, then s = cap tanh(s / cap) when softcapped,
//   p = exp(s - lse_i),  dp = dO_i.v_j,  D_i = dO_i.O_i,
//   ds = p (dp - D_i) (1 - tanh^2 when softcapped) scale,
//   dq_i += ds k_j,  dk_j += ds q_i,  dv_j += p dO_i.
// dk and dv sum over the G query heads of their kv head.  A row with no
// live key has lse = +inf (the forward's convention), so its p is 0.
//
// What bounds it on the H100: arithmetic, as for the forward (5 products
// per live pair instead of 2, 10 hd FLOPs a pair; at the training shape
// (4, 2048, 32/8, 64), causal, 172 GFLOP against ~60 MB of q, k, v, o, dO
// and the gradients).  This first design runs every product as fp32 FMAs
// on the CUDA cores, far below the tensor cores' rate; wgmma is later work.
//
// Design:
//  * Two kernels, no atomics, so the result is the same in every run.
//    dQ: one CTA per (32-query tile, head, batch) loops over the kv tiles
//    its rows can see (window start to causal frontier, as the forward),
//    with dq in registers.  dK/dV: one CTA per (kv tile, kv head, batch)
//    loops over the G query heads of its kv head and, for each, the
//    32-query tiles that can see the tile; dk and dv stay in registers.
//  * D = rowsum(dO * O) is recomputed in each pass from dO and O.
//  * Tiles are staged in shared memory as fp32.  Rows read one per lane
//    (the score products) have a stride of HDP + 4 floats (HDP = head dim
//    in whole lanes), so a warp's float4 loads hit distinct banks; the
//    pad columns are zeroed once and never stored, which gives head dim 80
//    the forward's scheme (a lane owns 3 of 96 dims in the dq/dk/dv
//    products).
//  * Ragged S and T are masked in the kernels.  q_offset must be 0 (the
//    wrapper raises otherwise): training attends full sequences.

#include "common.cuh"

using namespace repro;

namespace {

constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int RPW = 8;            // dQ pass: query rows per warp
constexpr int BQ = NWARPS * RPW;  // query rows per tile (both passes)

template <int HD>
struct Tile {
  static constexpr int HDP = (HD + 31) / 32 * 32;  // head dim in whole lanes
  static constexpr int BK = HD <= 64 ? 64 : 32;    // kv rows per tile
  static constexpr int KS = HD + 4;    // stride of rows read by broadcast
  static constexpr int LS = HDP + 4;   // stride of rows read one per lane
  static constexpr int DPL = HDP / 32;  // output dims owned by one lane
  static constexpr int JPL = BK / 32;   // dQ pass: kv columns per lane
  static constexpr int RPWK = BK / NWARPS;  // dK/dV pass: kv rows per warp
  // dQ pass: sQ, sdO [BQ][KS]; sK, sV [BK][LS]; sdS [BQ][BK]
  static constexpr size_t SMEM_DQ =
      sizeof(float) * (2 * BQ * KS + 2 * BK * LS + BQ * BK);
  // dK/dV pass: sK, sV [BK][KS]; sQ, sdO [BQ][LS]; sP, sdS [BK][BQ];
  // sL, sD [BQ]
  static constexpr size_t SMEM_DKV =
      sizeof(float) * (2 * BK * KS + 2 * BQ * LS + 2 * BK * BQ + 2 * BQ);
};

// Stage rows [r0, r0 + n) of a (rows, stride rs) matrix's head slice into
// shared memory as fp32 at row stride ss; rows past `rows` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int ss, const T* src,
                                      long long rs, int r0, int n, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = HD / VEC;
  for (int i = threadIdx.x; i < n * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    float tmp[VEC];
    if (r0 + r < rows) {
      load_vec<T, VEC>(src + (r0 + r) * rs + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * ss + c + e] = tmp[e];
  }
}

// Zero the pad columns [HD, HDP) of n rows at stride ss.
template <int HD>
__device__ __forceinline__ void zero_pad(float* dst, int ss, int n) {
  constexpr int PAD = Tile<HD>::HDP - HD;
  if constexpr (PAD > 0) {
    for (int i = threadIdx.x; i < n * PAD; i += THREADS)
      dst[(i / PAD) * ss + HD + i % PAD] = 0.f;
  }
}

// q.k over 4 dims, in the forward's order
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// p and dS of one live pair from its dots q.k and dO.v and its query
// row's lse and D.
__device__ __forceinline__ void pair_grad(float qk, float dov, float lse,
                                          float dd, float scale,
                                          float softcap, float* p,
                                          float* ds) {
  float s = qk * scale, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    s = softcap * t;
    dcap = 1.f - t * t;
  }
  *p = expf(s - lse);
  *ds = *p * (dov - dd) * dcap * scale;
}

__device__ __forceinline__ bool live(int i, int j, int S, int T_len,
                                     int causal, int window) {
  bool ok = i < S && j < T_len;
  if (causal) ok = ok && j <= i;
  if (window > 0) ok = ok && i - j < window;
  return ok;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const float* __restrict__ lse, const T* __restrict__ dO,
                    T* __restrict__ dq, int S, int T_len, int H, int KV,
                    int causal, int window, float scale, float softcap) {
  using C = Tile<HD>;
  constexpr int BK = C::BK, KS = C::KS, LS = C::LS, DPL = C::DPL;
  constexpr int JPL = C::JPL, HDP = C::HDP;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [BQ][KS]
  float* sdO = sQ + BQ * KS;     // [BQ][KS]
  float* sK = sdO + BQ * KS;     // [BK][LS]
  float* sV = sK + BK * LS;      // [BK][LS]
  float* sdS = sV + BK * LS;     // [BQ][BK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qrs = (long long)H * HD, kvrs = (long long)KV * HD;
  const long long qoff = (long long)b * S * qrs + (long long)h * HD;
  const long long kvoff = (long long)b * T_len * kvrs + (long long)kvh * HD;

  stage<T, HD>(sQ, KS, q + qoff, qrs, q0, BQ, S);
  stage<T, HD>(sdO, KS, dO + qoff, qrs, q0, BQ, S);
  zero_pad<HD>(sK, LS, BK);
  __syncthreads();

  // the warp's rows: lse and D = dO . O, warp-uniform
  const int rbase = warp * RPW;
  float l_r[RPW], d_r[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + rbase + r;
    float part = 0.f;
    if (row < S) {
      for (int c = lane; c < HD; c += 32)
        part += sdO[(rbase + r) * KS + c] * to_float(o[qoff + row * qrs + c]);
    }
    d_r[r] = warp_sum(part);
    l_r[r] = row < S ? lse[((long long)b * H + h) * S + row] : INFINITY;
  }

  const int n_rows = min(BQ, S - q0);
  int kv_end = T_len;
  if (causal) kv_end = min(kv_end, q0 + n_rows);
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  float acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;

  for (int kt = kv_begin; kt < kv_end; kt += BK) {
    __syncthreads();  // the previous tile is consumed
    stage<T, HD>(sK, LS, k + kvoff, kvrs, kt, BK, T_len);
    stage<T, HD>(sV, LS, v + kvoff, kvrs, kt, BK, T_len);
    __syncthreads();

    // q.k and dO.v: warp owns query rows, lane owns kv columns lane + 32c
    float qk[RPW][JPL], dov[RPW][JPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < JPL; ++c) qk[r][c] = dov[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 kk[JPL], vv[JPL];
#pragma unroll
      for (int c = 0; c < JPL; ++c) {
        kk[c] = *reinterpret_cast<const float4*>(&sK[(lane + 32 * c) * LS + d]);
        vv[c] = *reinterpret_cast<const float4*>(&sV[(lane + 32 * c) * LS + d]);
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&sQ[(rbase + r) * KS + d]);
        const float4 oo =
            *reinterpret_cast<const float4*>(&sdO[(rbase + r) * KS + d]);
#pragma unroll
        for (int c = 0; c < JPL; ++c) {
          qk[r][c] += dot4(qq, kk[c]);
          dov[r][c] += dot4(oo, vv[c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = q0 + rbase + r;
#pragma unroll
      for (int c = 0; c < JPL; ++c) {
        const int col = lane + 32 * c;
        float p = 0.f, ds = 0.f;
        if (live(row, kt + col, S, T_len, causal, window))
          pair_grad(qk[r][c], dov[r][c], l_r[r], d_r[r], scale, softcap, &p,
                    &ds);
        sdS[(rbase + r) * BK + col] = ds;
      }
    }
    __syncwarp();

    // dq += dS K: lane owns dims lane*DPL .. lane*DPL + DPL - 1
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float kk[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        load_floats<DPL>(&sK[(j + jj) * LS + lane * DPL], kk[jj]);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(&sdS[(rbase + r) * BK + j]);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[r][i] += d4.x * kk[0][i] + d4.y * kk[1][i] + d4.z * kk[2][i] +
                       d4.w * kk[3][i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + rbase + r;
    if (row >= S) continue;
    T* dst = dq + qoff + row * qrs + lane * DPL;
    if constexpr (HDP == HD) {
      store_vec<T, DPL>(dst, acc[r]);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        if (lane * DPL + i < HD) dst[i] = from_float<T>(acc[r][i]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const float* __restrict__ lse,
                      const T* __restrict__ dO, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int T_len, int H, int KV,
                      int causal, int window, float scale, float softcap) {
  using C = Tile<HD>;
  constexpr int BK = C::BK, KS = C::KS, LS = C::LS, DPL = C::DPL;
  constexpr int RPWK = C::RPWK, HDP = C::HDP;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;              // [BK][KS]
  float* sV = sK + BK * KS;      // [BK][KS]
  float* sQ = sV + BK * KS;      // [BQ][LS]
  float* sdO = sQ + BQ * LS;     // [BQ][LS]
  float* sP = sdO + BQ * LS;     // [BK][BQ]
  float* sdS = sP + BK * BQ;     // [BK][BQ]
  float* sL = sdS + BK * BQ;     // [BQ]
  float* sD = sL + BQ;           // [BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const long long qrs = (long long)H * HD, kvrs = (long long)KV * HD;
  const long long kvoff = (long long)b * T_len * kvrs + (long long)kvh * HD;

  stage<T, HD>(sK, KS, k + kvoff, kvrs, k0, BK, T_len);
  stage<T, HD>(sV, KS, v + kvoff, kvrs, k0, BK, T_len);
  zero_pad<HD>(sQ, LS, BQ);
  zero_pad<HD>(sdO, LS, BQ);

  // query rows that can see this kv tile: from its first key's causal
  // frontier to its last key's window end
  const int n_keys = min(BK, T_len - k0);
  int q_begin = causal ? k0 : 0;
  q_begin = (q_begin / BQ) * BQ;
  int q_end = S;
  if (window > 0) q_end = min(q_end, k0 + n_keys - 1 + window);

  const int rbase = warp * RPWK;
  float akk[RPWK][DPL], avv[RPWK][DPL];
#pragma unroll
  for (int r = 0; r < RPWK; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) akk[r][i] = avv[r][i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long qoff = (long long)b * S * qrs + (long long)h * HD;
    const float* lh = lse + ((long long)b * H + h) * S;
    for (int qt = q_begin; qt < q_end; qt += BQ) {
      __syncthreads();  // the previous tile is consumed
      stage<T, HD>(sQ, LS, q + qoff, qrs, qt, BQ, S);
      stage<T, HD>(sdO, LS, dO + qoff, qrs, qt, BQ, S);
      __syncthreads();
      // lse and D = dO . O of the tile's rows, 8 rows a warp
      for (int r = warp; r < BQ; r += NWARPS) {
        const int row = qt + r;
        float part = 0.f;
        if (row < S) {
          for (int c = lane; c < HD; c += 32)
            part += sdO[r * LS + c] * to_float(o[qoff + row * qrs + c]);
        }
        part = warp_sum(part);
        if (lane == 0) {
          sD[r] = part;
          sL[r] = row < S ? lh[row] : INFINITY;
        }
      }
      __syncthreads();

      // k.q and v.dO: warp owns kv rows, lane owns query column `lane`
      float qk[RPWK], dov[RPWK];
#pragma unroll
      for (int r = 0; r < RPWK; ++r) qk[r] = dov[r] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(&sQ[lane * LS + d]);
        const float4 oo =
            *reinterpret_cast<const float4*>(&sdO[lane * LS + d]);
#pragma unroll
        for (int r = 0; r < RPWK; ++r) {
          qk[r] += dot4(qq, *reinterpret_cast<const float4*>(
                                &sK[(rbase + r) * KS + d]));
          dov[r] += dot4(oo, *reinterpret_cast<const float4*>(
                                 &sV[(rbase + r) * KS + d]));
        }
      }
      // P^T and dS^T of the tile
      const int i = qt + lane;
      const float li = sL[lane], di = sD[lane];
#pragma unroll
      for (int r = 0; r < RPWK; ++r) {
        float p = 0.f, ds = 0.f;
        if (live(i, k0 + rbase + r, S, T_len, causal, window))
          pair_grad(qk[r], dov[r], li, di, scale, softcap, &p, &ds);
        sP[(rbase + r) * BQ + lane] = p;
        sdS[(rbase + r) * BQ + lane] = ds;
      }
      __syncwarp();

      // dv += P^T dO, dk += dS^T Q: lane owns dims lane*DPL ..
#pragma unroll 2
      for (int c = 0; c < BQ; c += 4) {
        float dd[4][DPL], qq[4][DPL];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          load_floats<DPL>(&sdO[(c + cc) * LS + lane * DPL], dd[cc]);
          load_floats<DPL>(&sQ[(c + cc) * LS + lane * DPL], qq[cc]);
        }
#pragma unroll
        for (int r = 0; r < RPWK; ++r) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(&sP[(rbase + r) * BQ + c]);
          const float4 s4 =
              *reinterpret_cast<const float4*>(&sdS[(rbase + r) * BQ + c]);
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            avv[r][e] += p4.x * dd[0][e] + p4.y * dd[1][e] + p4.z * dd[2][e] +
                         p4.w * dd[3][e];
            akk[r][e] += s4.x * qq[0][e] + s4.y * qq[1][e] + s4.z * qq[2][e] +
                         s4.w * qq[3][e];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPWK; ++r) {
    const int j = k0 + rbase + r;
    if (j >= T_len) continue;
    T* dkd = dk + kvoff + j * kvrs + lane * DPL;
    T* dvd = dv + kvoff + j * kvrs + lane * DPL;
    if constexpr (HDP == HD) {
      store_vec<T, DPL>(dkd, akk[r]);
      store_vec<T, DPL>(dvd, avv[r]);
    } else {
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (lane * DPL + e < HD) {
          dkd[e] = from_float<T>(akk[r][e]);
          dvd[e] = from_float<T>(avv[r][e]);
        }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dO, void* dq,
                   void* dk, void* dv, int B, int S, int T_len, int H, int KV,
                   int causal, int window, float scale, float softcap,
                   cudaStream_t st) {
  using C = Tile<HD>;
  auto qt = static_cast<const T*>(q);
  auto kt = static_cast<const T*>(k);
  auto vt = static_cast<const T*>(v);
  auto ot = static_cast<const T*>(o);
  auto dOt = static_cast<const T*>(dO);
  auto kq = flash_bwd_dq_kernel<T, HD>;
  auto kkv = flash_bwd_dkdv_kernel<T, HD>;
  cudaError_t e = allow_smem(kq, C::SMEM_DQ);
  if (e == cudaSuccess) e = allow_smem(kkv, C::SMEM_DKV);
  if (e != cudaSuccess) return e;
  kq<<<dim3((S + BQ - 1) / BQ, H, B), THREADS, C::SMEM_DQ, st>>>(
      qt, kt, vt, ot, lse, dOt, static_cast<T*>(dq), S, T_len, H, KV, causal,
      window, scale, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kkv<<<dim3((T_len + C::BK - 1) / C::BK, KV, B), THREADS, C::SMEM_DKV,
        st>>>(qt, kt, vt, ot, lse, dOt, static_cast<T*>(dk),
              static_cast<T*>(dv), S, T_len, H, KV, causal, window, scale,
              softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int HD, const void* q, const void* k, const void* v,
                      const void* o, const float* lse, const void* dO,
                      void* dq, void* dk, void* dv, int B, int S, int T_len,
                      int H, int KV, int causal, int window, float scale,
                      float softcap, cudaStream_t st) {
  switch (HD) {
#define REPRO_CASE(D)                                                      \
  case D:                                                                  \
    return launch<T, D>(q, k, v, o, lse, dO, dq, dk, dv, B, S, T_len, H,   \
                        KV, causal, window, scale, softcap, st);
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

// Returns the cudaError_t of the launches (0 on success).  The caller has
// checked shapes, dtypes, contiguity and 16-byte alignment; lse is the
// forward's (B, H, S) fp32 log-sum-exp; dq, dk, dv are written in full.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dO, void* dq,
                                   void* dk, void* dv, int dtype, int B,
                                   int S, int T_len, int H, int KV, int HD,
                                   int causal, int window, float scale,
                                   float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (dtype == DTYPE_F32)
    return (int)launch_hd<float>(HD, q, k, v, o, l, dO, dq, dk, dv, B, S,
                                 T_len, H, KV, causal, window, scale,
                                 softcap, st);
  if (dtype == DTYPE_BF16)
    return (int)launch_hd<__nv_bfloat16>(HD, q, k, v, o, l, dO, dq, dk, dv,
                                         B, S, T_len, H, KV, causal, window,
                                         scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}
