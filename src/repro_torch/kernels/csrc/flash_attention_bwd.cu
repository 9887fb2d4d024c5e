// Grouped-query flash attention, backward, for Hopper (sm_90a).
//
// Has no Pallas counterpart: the JAX package never differentiates its TPU
// kernel (src/repro/kernels/flash_attention.py::_fa_kernel); it
// differentiates the jnp oracle.  This is the gradient of the forward in
// flash_attention.cu, FA2-style: P is recomputed from the log-sum-exp the
// forward saved, so no (S, T) matrix is ever stored.  For each live
// (query i, key j) pair of head h (kv head h / G), with query position
// q_offset + i:
//   s = scale q_i.k_j, then s = cap tanh(s / cap) when softcapped,
//   p = exp(s - lse_i),  dp = dO_i.v_j,  D_i = dO_i.O_i,
//   ds = p (dp - D_i) (1 - tanh^2 when softcapped) scale,
//   dq_i += ds k_j,  dk_j += ds q_i,  dv_j += p dO_i.
// dk and dv sum over the G query heads of their kv head.  A row with no
// live key has lse = +inf (the forward's convention), so its p is 0.
//
// What bounds it on the H100: the operations at the training shape (4,
// 2048, 32/8, 64), causal: 5 products of 2 hd FLOPs a live pair, 172
// GFLOP against 168 MB of q, k, v, o, dO, lse and the gradients.  This design
// computes S and dP in both passes, 7 products a pair, so it can reach at
// most 5/7 of that bound.
//
// Two passes, no atomics, so the result is the same in every run: every
// CTA owns its output rows and sums them in a fixed order.
//  * dQ: one CTA per (query tile, head, batch) loops over the kv tiles its
//    rows can see (window start to causal frontier, as the forward), with
//    dq in registers.
//  * dK/dV: one CTA per (kv tile, kv head, batch) loops over the G query
//    heads of its kv head and, for each, the query tiles that can see the
//    tile; dk and dv stay in registers.
//  * Ragged S and T and q_offset are handled in the kernels.
//
// Two implementations, chosen by dtype inside the entry point:
//
// bf16, on the tensor cores (sm90_mma.cuh), three kernels:
//  * flash_bwd_dot_kernel: D = rowsum(dO * O), fp32 (B, H, S), into a
//    scratch buffer the wrapper allocates, so the dK/dV pass reads 64 rows
//    of D instead of a tile of O and one of dO per query tile.
//  * flash_bwd_dq_kernel_sm90, one warpgroup a CTA, 64 query rows: S = Q
//    K^T and dP = dO V^T by wgmma m64n64k16 (Q, dO resident; K, V read
//    K-major), p and dS on the fp32 fragments in registers, then dQ += dS
//    K by wgmma m64n{hd}k16 with dS rounded to bf16 as the register A
//    operand and K read MN-major.
//  * flash_bwd_dkdv_kernel_sm90, two warpgroups a CTA, 64 kv rows each,
//    sharing each Q/dO tile: S^T = K Q^T and dP^T = V dO^T (K, V
//    resident; Q, dO read K-major), then dV += P^T dO and dK += dS^T Q
//    with P^T and dS^T as bf16 register A operands and dO, Q read
//    MN-major.  The next tile's lse and D load while this tile's first
//    products run; each warpgroup skips the query tiles fully masked for
//    its keys.
//  * K/V tiles (dQ pass) and Q/dO tiles (dK/dV pass) arrive by cp.async
//    into a ring of two stages, as in the forward (and for its reasons:
//    the no-swizzle layout at any head dim, zero fill past the edge, no
//    tensor map).
//  * P and dS are rounded to bf16 as operands, as FA2, FA3 and SDPA do.
//  * Per CTA (-Xptxas -v on the card, no spills): dQ 6 tiles of 64 x hd
//    bf16, 48 KB at hd 64 and 60 KB at hd 80, 146 and 151 registers a
//    thread; dK/dV 8 tiles and 1 KB of lse and D, 65 KB and 81 KB, 198
//    and 210 registers.
//  * What keeps it from its bound besides the 7/5: as in the forward,
//    each product waits for the one before, and the elementwise p, dS
//    work sits between them on the same warpgroup; the dK/dV pass runs
//    one CTA (two warpgroups) an SM for its registers.
//
// fp32, flash_bwd_{dq,dkdv}_kernel, on the CUDA cores (TF32 would break
// the fp32 tolerance; fp32 is not on the main path):
//  * 32-query tiles; tiles staged in shared memory as fp32, every product
//    fp32 FMAs; D = rowsum(dO * O) recomputed in each pass from dO and O
//    (the entry point's delta is null).  Rows read one per lane (the
//    score products) have a stride of HDP + 4 floats (HDP = head dim in
//    whole lanes), so a warp's float4 loads hit distinct banks; the pad
//    columns are zeroed once and never stored, which gives head dim 80
//    the forward's scheme (a lane owns 3 of 96 dims in the dq/dk/dv
//    products).

#include <type_traits>

#include "common.cuh"
#include "sm90_mma.cuh"

using namespace repro;

namespace {

// ---------------------------------------------------------------------------
// fp32: the CUDA cores
// ---------------------------------------------------------------------------

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

// Whether query row i (at position qpos = q_offset + i) sees key j.
__device__ __forceinline__ bool live(int i, int qpos, int j, int S,
                                     int T_len, int causal, int window) {
  bool ok = i < S && j < T_len;
  if (causal) ok = ok && j <= qpos;
  if (window > 0) ok = ok && qpos - j < window;
  return ok;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const float* __restrict__ lse, const T* __restrict__ dO,
                    T* __restrict__ dq, int S, int T_len, int H, int KV,
                    int causal, int window, float scale, float softcap,
                    int q_offset) {
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
  if (causal) kv_end = min(kv_end, q_offset + q0 + n_rows);
  int kv_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
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
        if (live(row, q_offset + row, kt + col, S, T_len, causal, window))
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
                      int causal, int window, float scale, float softcap,
                      int q_offset) {
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
  int q_begin = causal ? max(0, k0 - q_offset) : 0;
  q_begin = (q_begin / BQ) * BQ;
  int q_end = S;
  if (window > 0) q_end = min(q_end, k0 + n_keys - 1 + window - q_offset);

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
        if (live(i, q_offset + i, k0 + rbase + r, S, T_len, causal,
                 window))
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
                   int q_offset, cudaStream_t st) {
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
      window, scale, softcap, q_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kkv<<<dim3((T_len + C::BK - 1) / C::BK, KV, B), THREADS, C::SMEM_DKV,
        st>>>(qt, kt, vt, ot, lse, dOt, static_cast<T*>(dk),
              static_cast<T*>(dv), S, T_len, H, KV, causal, window, scale,
              softcap, q_offset);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using sm90::bf16;
constexpr int WG = sm90::WARPGROUP;
constexpr int BN = 64;  // rows of a tile; each warpgroup owns 64 rows
constexpr float LOG2E = 1.4426950408889634f;

template <int HD, int WGS>
struct Smem {
  static constexpr int TILE = 64 * HD;  // elements of one 64-row tile
  // dQ: WGS tiles each of Q and dO, two stages of K and V
  static constexpr size_t DQ = sizeof(bf16) * (2 * WGS + 4) * TILE;
  // dK/dV: WGS tiles each of K and V, two stages of Q and dO; lse and D
  // of each stage's 64 query rows
  static constexpr size_t DKV =
      sizeof(bf16) * (2 * WGS + 4) * TILE + sizeof(float) * 4 * BN;
};

// D = rowsum(dO * O) of each query row, fp32 (B, H, S): one CTA per (64
// rows, head, batch), two threads a row.
template <int HD>
__global__ void __launch_bounds__(WG)
flash_bwd_dot_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                     float* __restrict__ delta, int S, int H) {
  const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
  const int row = blockIdx.x * 64 + r, h = blockIdx.y, b = blockIdx.z;
  float d = 0.f;
  if (row < S) {
    const long long off = ((long long)b * S + row) * H * HD +
                          (long long)h * HD + part * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; c += 8) {
      float a[8], g[8];
      load_vec<bf16, 8>(o + off + c, a);
      load_vec<bf16, 8>(dO + off + c, g);
#pragma unroll
      for (int e = 0; e < 8; ++e) d += a[e] * g[e];
    }
  }
  d += __shfl_xor_sync(FULL_MASK, d, 1);
  if (part == 0 && row < S) delta[((long long)b * H + h) * S + row] = d;
}

// p and dS of one pair from its raw q.k and dO.v and its row's lse and D;
// p = 0 where the row has no live key (lse = +inf)
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
  *p = exp2f((s - lse) * LOG2E);
  *ds = *p * (dov - dd) * dcap * scale;
}

// Store each warpgroup's 64 x HD fp32 accumulator fragment as bf16 rows
// [r0, r0 + 64 WGS) of a (rows, stride rs) matrix's head slice, through
// shared memory at sO (64 WGS x (HD + 8) bf16) for coalesced 16-byte
// stores.
template <int HD, int WGS>
__device__ __forceinline__ void store_rows(bf16* sO,
                                           const float (&acc)[HD / 2],
                                           bf16* dst, long long rs, int r0,
                                           int rows) {
  constexpr int OS = HD + 8;
  const int wg = threadIdx.x / WG;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2)
    *reinterpret_cast<uint32_t*>(
        &sO[(64 * wg + sm90::acc_row(i)) * OS + sm90::acc_col(i)]) =
        sm90::pack_bf16(acc[i], acc[i + 1]);
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * WGS * (HD / 8); i += WGS * WG) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * rs + c) =
          *reinterpret_cast<const uint4*>(&sO[r * OS + c]);
  }
}

// dQ: one CTA of WGS warpgroups per (64 WGS query rows, head, batch) loops
// over the kv tiles its rows can see, as the forward does; each
// warpgroup skips the tiles fully masked for its 64 rows.  S = Q K^T and
// dP = dO V^T (K and V read K-major), then dQ += dS K (K read MN-major),
// dQ in registers.
template <int HD, int WGS>
__global__ void __launch_bounds__(WGS * WG)
flash_bwd_dq_kernel_sm90(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const bf16* __restrict__ dO, bf16* __restrict__ dq,
                         int S, int T_len, int H, int KV, int causal,
                         int window, float scale, float softcap,
                         int q_offset) {
  constexpr int NT = WGS * WG, BM = 64 * WGS;
  constexpr int TILE = Smem<HD, WGS>::TILE, NS = BN / 2, NO = HD / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [WGS][TILE]
  bf16* sdO = sQ + WGS * TILE;                   // [WGS][TILE]
  bf16* sK = sdO + WGS * TILE;                   // [2][TILE]
  bf16* sV = sK + 2 * TILE;                      // [2][TILE]

  const int wg = threadIdx.x / WG;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qrs = (long long)H * HD, kvrs = (long long)KV * HD;
  const long long qoff = (long long)b * S * qrs + (long long)h * HD;
  const long long kvoff = (long long)b * T_len * kvrs + (long long)kvh * HD;
  const bf16* kb = k + kvoff;
  const bf16* vb = v + kvoff;

  const int pos_lo = q_offset + q0;
  int kv_end = T_len;
  if (causal) kv_end = min(kv_end, pos_lo + min(BM, S - q0));
  int kv_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  kv_begin = (kv_begin / BN) * BN;
  const int w_rows = min(64, S - q0 - 64 * wg);  // <= 0: no rows here
  const int w_lo = pos_lo + 64 * wg, w_hi = w_lo + w_rows - 1;
  int w_end = T_len;
  if (causal) w_end = min(w_end, w_hi + 1);
  const int w_begin = window > 0 ? max(0, w_lo - window + 1) : 0;

  sm90::load_tile<BM, HD, NT>(sQ, q + qoff, qrs, q0, S);
  sm90::load_tile<BM, HD, NT>(sdO, dO + qoff, qrs, q0, S);
  if (kv_begin < kv_end) {
    sm90::load_tile<BN, HD, NT>(sK, kb, kvrs, kv_begin, T_len);
    sm90::load_tile<BN, HD, NT>(sV, vb, kvrs, kv_begin, T_len);
  }
  sm90::cp_async_commit();
  // this thread's rows: lse (+inf past S, so that p is 0) and D
  const int r_a = sm90::acc_row(0);
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * wg + r_a + 8 * r;
    const long long at = ((long long)b * H + h) * S + row;
    lr[r] = row < S ? lse[at] : INFINITY;
    dr[r] = row < S ? delta[at] : 0.f;
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  const uint64_t d_q = sm90::desc_k_major<HD>(sQ + wg * TILE);
  const uint64_t d_do = sm90::desc_k_major<HD>(sdO + wg * TILE);

  int stage = 0;
  for (int kt = kv_begin; kt < kv_end; kt += BN, stage ^= 1) {
    if (kt + BN < kv_end) {
      sm90::load_tile<BN, HD, NT>(sK + (stage ^ 1) * TILE, kb, kvrs,
                                  kt + BN, T_len);
      sm90::load_tile<BN, HD, NT>(sV + (stage ^ 1) * TILE, vb, kvrs,
                                  kt + BN, T_len);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();

    if (w_rows > 0 && kt < w_end && kt + BN > w_begin) {
      const bf16* cK = sK + stage * TILE;
      const bf16* cV = sV + stage * TILE;
      float s[NS], dp[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
      const uint64_t d_k = sm90::desc_k_major<HD>(cK);
      const uint64_t d_v = sm90::desc_k_major<HD>(cV);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::Wgmma<BN>::ss(s, d_q + kk * sm90::K_MAJOR_STEP,
                               d_k + kk * sm90::K_MAJOR_STEP, kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::Wgmma<BN>::ss(dp, d_do + kk * sm90::K_MAJOR_STEP,
                               d_v + kk * sm90::K_MAJOR_STEP, kk > 0);
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      const bool edge = (causal && kt + BN - 1 > w_lo) ||
                        (window > 0 && kt <= w_hi - window) ||
                        kt + BN > T_len;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int hf = (i >> 1) & 1;
        float p, ds;
        pair_grad(s[i], dp[i], lr[hf], dr[hf], scale, softcap, &p, &ds);
        if (edge) {
          const int qpos = w_lo + r_a + 8 * hf;
          const int kpos = kt + sm90::acc_col(i);
          bool ok = kpos < T_len;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) ds = 0.f;
        }
        s[i] = ds;
      }

      // dQ += dS K, dS in bf16 registers as the A operand
      uint32_t da[BN / 16][4];
      sm90::acc_to_a(s, da);
      const uint64_t d_kt = sm90::desc_mn_major<HD>(cK);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::Wgmma<HD>::rs(acc, da[kk],
                            d_kt + kk * sm90::MN_MAJOR_STEP<HD>, 1);
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(acc);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  sm90::cp_async_wait<0>();
  __syncthreads();
  store_rows<HD, WGS>(sK, acc, dq + qoff, qrs, q0, S);
}

// dK/dV: one CTA of WGS warpgroups per (64 WGS kv rows, kv head, batch)
// loops over the G query heads of its kv head and, for each, the 64-row
// query tiles that can see its keys; the warpgroups share each Q/dO tile
// and each skips the tiles fully masked for its 64 keys.  S^T = K Q^T and
// dP^T = V dO^T (Q and dO read K-major), then dV += P^T dO and dK += dS^T
// Q (dO and Q read MN-major); dK and dV in registers.  The next tile's lse
// and D load while this tile's first products run.
template <int HD, int WGS>
__global__ void __launch_bounds__(WGS * WG)
flash_bwd_dkdv_kernel_sm90(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const bf16* __restrict__ dO,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int S, int T_len, int H, int KV, int causal,
                           int window, float scale, float softcap,
                           int q_offset) {
  constexpr int NT = WGS * WG, BM = 64 * WGS;
  constexpr int TILE = Smem<HD, WGS>::TILE, NS = BN / 2, NO = HD / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [WGS][TILE]
  bf16* sV = sK + WGS * TILE;                    // [WGS][TILE]
  bf16* sQ = sV + WGS * TILE;                    // [2][TILE]
  bf16* sdO = sQ + 2 * TILE;                     // [2][TILE]
  float* sL = reinterpret_cast<float*>(sdO + 2 * TILE);  // [2][BN]
  float* sD = sL + 2 * BN;                               // [2][BN]

  const int wg = threadIdx.x / WG;
  const int k0 = blockIdx.x * BM, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const long long qrs = (long long)H * HD, kvrs = (long long)KV * HD;
  const long long kvoff = (long long)b * T_len * kvrs + (long long)kvh * HD;

  // query rows that can see these keys: from the first key's causal
  // frontier to the last key's window end; the same for this warpgroup's
  // 64 keys
  const int n_keys = min(BM, T_len - k0);
  int q_begin = causal ? max(0, k0 - q_offset) : 0;
  q_begin = (q_begin / BN) * BN;
  int q_end = S;
  if (window > 0) q_end = min(q_end, k0 + n_keys - 1 + window - q_offset);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BN - 1) / BN : 0;
  const int n_it = G * n_qt;
  const int wk0 = k0 + 64 * wg;
  const int w_keys = min(64, T_len - wk0);  // <= 0: no keys here
  const int w_begin = causal ? wk0 - q_offset : 0;
  int w_end = S;
  if (window > 0) w_end = min(w_end, wk0 + w_keys - 1 + window - q_offset);
  // iteration it: head kvh * G + it / n_qt, query tile it % n_qt
  auto head_off = [&](int it) {
    return (long long)b * S * qrs + (long long)(kvh * G + it / n_qt) * HD;
  };
  auto stats_at = [&](int it) {
    return ((long long)b * H + kvh * G + it / n_qt) * S;
  };
  auto tile_row = [&](int it) { return q_begin + (it % n_qt) * BN; };
  // lse (+inf past S) and D of iteration it's 64 query rows into stage st
  auto load_stats = [&](int it, int st) {
    if (threadIdx.x < BN) {
      const int row = tile_row(it) + threadIdx.x;
      const long long at = stats_at(it) + row;
      sL[st * BN + threadIdx.x] = row < S ? lse[at] : INFINITY;
      sD[st * BN + threadIdx.x] = row < S ? delta[at] : 0.f;
    }
  };

  sm90::load_tile<BM, HD, NT>(sK, k + kvoff, kvrs, k0, T_len);
  sm90::load_tile<BM, HD, NT>(sV, v + kvoff, kvrs, k0, T_len);
  if (n_it > 0) {
    sm90::load_tile<BN, HD, NT>(sQ, q + head_off(0), qrs, tile_row(0), S);
    sm90::load_tile<BN, HD, NT>(sdO, dO + head_off(0), qrs, tile_row(0),
                                S);
    load_stats(0, 0);
  }
  sm90::cp_async_commit();

  const int r_a = sm90::acc_row(0);
  float akk[NO], avv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) akk[i] = avv[i] = 0.f;
  const uint64_t d_k = sm90::desc_k_major<HD>(sK + wg * TILE);
  const uint64_t d_v = sm90::desc_k_major<HD>(sV + wg * TILE);

  int stage = 0;
  for (int it = 0; it < n_it; ++it, stage ^= 1) {
    const int qt = tile_row(it);
    const bool more = it + 1 < n_it;
    if (more) {
      sm90::load_tile<BN, HD, NT>(sQ + (stage ^ 1) * TILE,
                                  q + head_off(it + 1), qrs,
                                  tile_row(it + 1), S);
      sm90::load_tile<BN, HD, NT>(sdO + (stage ^ 1) * TILE,
                                  dO + head_off(it + 1), qrs,
                                  tile_row(it + 1), S);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();

    const bool active = w_keys > 0 && qt + BN > w_begin && qt < w_end;
    if (active) {
      const bf16* cQ = sQ + stage * TILE;
      const bf16* cdO = sdO + stage * TILE;
      float st[NS], dpt[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) st[i] = dpt[i] = 0.f;
      const uint64_t d_q = sm90::desc_k_major<HD>(cQ);
      const uint64_t d_do = sm90::desc_k_major<HD>(cdO);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::Wgmma<BN>::ss(st, d_k + kk * sm90::K_MAJOR_STEP,
                               d_q + kk * sm90::K_MAJOR_STEP, kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::Wgmma<BN>::ss(dpt, d_v + kk * sm90::K_MAJOR_STEP,
                               d_do + kk * sm90::K_MAJOR_STEP, kk > 0);
      sm90::commit();
      if (more) load_stats(it + 1, stage ^ 1);
      sm90::wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      const float* cL = sL + stage * BN;
      const float* cD = sD + stage * BN;
      const bool edge =
          (causal && wk0 + 63 > q_offset + qt) ||
          (window > 0 && q_offset + qt + BN - 1 - wk0 >= window);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = sm90::acc_col(i);
        float p, ds;
        pair_grad(st[i], dpt[i], cL[c], cD[c], scale, softcap, &p, &ds);
        if (edge) {
          const int j = wk0 + r_a + 8 * ((i >> 1) & 1);
          const int qpos = q_offset + qt + c;
          bool ok = true;
          if (causal) ok = j <= qpos;
          if (window > 0) ok = ok && qpos - j < window;
          if (!ok) p = ds = 0.f;
        }
        st[i] = p;
        dpt[i] = ds;
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T in bf16 registers
      uint32_t pa[BN / 16][4], dsa[BN / 16][4];
      sm90::acc_to_a(st, pa);
      sm90::acc_to_a(dpt, dsa);
      const uint64_t d_dot = sm90::desc_mn_major<HD>(cdO);
      const uint64_t d_qt = sm90::desc_mn_major<HD>(cQ);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::Wgmma<HD>::rs(avv, pa[kk],
                            d_dot + kk * sm90::MN_MAJOR_STEP<HD>, 1);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::Wgmma<HD>::rs(akk, dsa[kk],
                            d_qt + kk * sm90::MN_MAJOR_STEP<HD>, 1);
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(avv);
      sm90::fence_regs(akk);
    } else if (more) {
      load_stats(it + 1, stage ^ 1);
    }
    __syncthreads();  // the stage and its lse, D are consumed
  }
  sm90::cp_async_wait<0>();
  __syncthreads();
  // dK through the K and V tiles, dV through the Q and dO stages
  store_rows<HD, WGS>(sK, akk, dk + kvoff, kvrs, k0, T_len);
  store_rows<HD, WGS>(sQ, avv, dv + kvoff, kvrs, k0, T_len);
}

template <typename K>
cudaError_t allow_smem_tc(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Warpgroups a CTA: dQ one, dK/dV two, the fastest of the four choices on
// the H100 at the training shape (PERF.md).
constexpr int WQ = 1, WKV = 2;

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dO, void* dq,
                   void* dk, void* dv, float* delta, int B, int S, int T_len,
                   int H, int KV, int causal, int window, float scale,
                   float softcap, int q_offset, cudaStream_t st) {
  auto qt = static_cast<const bf16*>(q);
  auto kt = static_cast<const bf16*>(k);
  auto vt = static_cast<const bf16*>(v);
  auto ot = static_cast<const bf16*>(o);
  auto dOt = static_cast<const bf16*>(dO);
  auto kq = flash_bwd_dq_kernel_sm90<HD, WQ>;
  auto kkv = flash_bwd_dkdv_kernel_sm90<HD, WKV>;
  constexpr size_t smem_q = Smem<HD, WQ>::DQ, smem_kv = Smem<HD, WKV>::DKV;
  cudaError_t e = allow_smem_tc(kq, smem_q);
  if (e == cudaSuccess) e = allow_smem_tc(kkv, smem_kv);
  if (e != cudaSuccess) return e;
  flash_bwd_dot_kernel<HD><<<dim3((S + 63) / 64, H, B), WG, 0, st>>>(
      ot, dOt, delta, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kq<<<dim3((S + 64 * WQ - 1) / (64 * WQ), H, B), WQ * WG, smem_q, st>>>(
      qt, kt, vt, lse, delta, dOt, static_cast<bf16*>(dq), S, T_len, H, KV,
      causal, window, scale, softcap, q_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kkv<<<dim3((T_len + 64 * WKV - 1) / (64 * WKV), KV, B), WKV * WG, smem_kv,
        st>>>(qt, kt, vt, lse, delta, dOt, static_cast<bf16*>(dk),
              static_cast<bf16*>(dv), S, T_len, H, KV, causal, window, scale,
              softcap, q_offset);
  return cudaGetLastError();
}

}  // namespace tc

// The entry point's dispatch on the head dim: the CUDA-core kernels for
// fp32, the tensor-core kernels for bf16.
template <typename T>
cudaError_t launch_hd(int HD, const void* q, const void* k, const void* v,
                      const void* o, const float* lse, const void* dO,
                      void* dq, void* dk, void* dv, float* delta, int B,
                      int S, int T_len, int H, int KV, int causal,
                      int window, float scale, float softcap, int q_offset,
                      cudaStream_t st) {
  switch (HD) {
#define REPRO_CASE(D)                                                        \
  case D:                                                                    \
    if constexpr (std::is_same_v<T, float>)                                  \
      return launch<float, D>(q, k, v, o, lse, dO, dq, dk, dv, B, S, T_len,  \
                              H, KV, causal, window, scale, softcap,         \
                              q_offset, st);                                 \
    else                                                                     \
      return tc::launch<D>(q, k, v, o, lse, dO, dq, dk, dv, delta, B, S,     \
                           T_len, H, KV, causal, window, scale, softcap,     \
                           q_offset, st);
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
// fp32 runs on the CUDA cores, bf16 on the tensor cores; delta is a
// (B, H, S) fp32 scratch buffer that the bf16 path fills with D (null for
// fp32).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dO, void* dq,
                                   void* dk, void* dv, void* delta,
                                   int dtype, int B,
                                   int S, int T_len, int H, int KV, int HD,
                                   int causal, int window, float scale,
                                   float softcap, int q_offset,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (dtype == DTYPE_F32)
    return (int)launch_hd<float>(HD, q, k, v, o, l, dO, dq, dk, dv, nullptr,
                                 B, S, T_len, H, KV, causal, window, scale,
                                 softcap, q_offset, st);
  if (dtype == DTYPE_BF16)
    return (int)launch_hd<__nv_bfloat16>(
        HD, q, k, v, o, l, dO, dq, dk, dv, static_cast<float*>(delta), B, S,
        T_len, H, KV, causal, window, scale, softcap, q_offset, st);
  return (int)cudaErrorInvalidValue;
}
