// Grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel _fa_kernel).  Same function: q (B,S,H,hd) against
// k, v (B,T,KV,hd) with kv head = h / (H/KV); optional causal mask with
// query positions offset by q_offset, sliding window (qpos - kpos < window),
// tanh soft-cap; fp32 running max m, sum l and accumulator;
// out = acc / max(l, 1e-30) in the input dtype.  When the caller passes
// an lse pointer (training: the backward needs it), each row's fp32
// log-sum-exp m + log(l) is written to lse[b][h][row] as well; the serving
// paths pass null and pay nothing for it.  A query row with no live key
// (a window and q_offset + S >= T + window) would get 0 and an LSE of +inf
// here, where the oracle (kernels/ref.py) gives the mean of V: the wrappers
// (kernels/flash_attention.py::rows_without_keys) refuse such inputs, so
// the kernels never see one.
//
// What bounds it on the H100: at the training shape (4, 2048, 32/8, 64),
// causal, the operations: 4 hd FLOPs a live (query, key) pair, 68.7 GFLOP
// against 42 MB of q, k, v and o, about S/2.5 FLOP a byte, past the card's
// ~295 FLOP/byte ridge from S ~ 750.  At the serving prefills (<= 512
// tokens) the bytes.
//
// Two kernels, chosen by dtype inside the entry point (a dispatch, not a
// fallback: a bf16 call never reaches the CUDA-core code):
//
// bf16, flash_fwd_kernel_sm90, on the tensor cores (sm90_mma.cuh):
//  * One CTA is two warpgroups (256 threads) and owns 128 query rows of
//    one (head, batch), 64 a warpgroup.  It loops over 64-row kv tiles
//    from the window's first live tile to the causal frontier of its last
//    row; the two warpgroups share each K/V tile (half the L2 traffic of
//    one warpgroup a CTA), and each skips the tiles that are fully masked
//    for its own rows (the TPU kernel skips them with pl.when).
//  * S = Q K^T by wgmma m64n64k16 with Q resident in shared memory and K
//    read K-major.  The online softmax runs on the fp32 accumulator
//    fragment in registers, in log2 units (scale and log2 e folded into
//    one multiply, exp2): a thread holds two rows, 32 scores of them; a
//    row's max and sum reduce over its 4 threads by __shfl_xor.  Scale,
//    softcap and the masks apply to the fragment; only tiles that cross
//    the causal frontier, the window's edge or T are masked.
//  * O += P V by wgmma m64n{hd}k16 with P rounded to bf16 in registers as
//    the A operand (the accumulator's layout is the A fragment's) and V
//    read MN-major (transposed) from the same tile layout as K.
//  * K and V tiles arrive by cp.async into a ring of two stages: the next
//    tile loads while wgmma runs on this one.  cp.async and not TMA: one
//    16-byte copy per thread fills the no-swizzle core-matrix layout at
//    any head dim (80 included), zero-fills rows past T, and needs no
//    tensor map from the driver API.
//  * Per CTA: shared memory 6 tiles of 64 x hd bf16 (two of Q, two stages
//    of K and V), 48 KB at hd 64 and 60 KB at hd 80; 124 registers a
//    thread at hd 64 and 126 at hd 80, no spills (-Xptxas -v on the
//    card), so two CTAs fit an SM.  O leaves through the K/V stages for
//    coalesced 16-byte stores.
//  * Head dim 256 (gemma-7b) keeps the same design: P V is one
//    m64n256k16 a K step, so a thread holds 128 output accumulators
//    beside its 32 scores, in 220 registers without a spill (-Xptxas -v
//    on the card); shared memory is 192 KB (196,608 bytes), one CTA of
//    two warpgroups an SM.  One warpgroup a CTA would not fit two CTAs
//    either (160 KB), and halving the kv tile or splitting the output
//    would leave the 128 accumulators as they are.
//  * What keeps it from its bound: each wgmma group is waited for before
//    the softmax that needs it, and the softmax before the next product,
//    so within a warpgroup the tensor cores idle while the CUDA cores
//    work; only the other warpgroups on the SM fill that gap.  No warp
//    specialisation, no ping-pong of the two warpgroups, no overlap of the
//    softmax with the next Q K^T (FA3's schedule), Q re-read from shared
//    memory for every tile, and 64-wide kv tiles.
//
// fp32, flash_fwd_kernel, on the CUDA cores (the first design; TF32 tensor
// cores would break the fp32 sweeps' 2e-5 tolerance, and fp32 is not on
// the main path):
//  * one CTA owns one (32-query tile, head, batch); m, l and acc live in
//    registers; each K/V tile is staged once in shared memory as fp32 and
//    shared by the CTA's 4 warps x 8 query rows; scores and the PV
//    product are fp32 FMAs.
//  * Head dims 32, 64, 80, 128 and 256.  In the PV product each lane owns
//    HDP / 32 output dims, HDP being the head dim rounded up to whole
//    lanes (96 for 80; 8 dims a lane at 256, with 32-row kv tiles and
//    103,424 bytes of shared memory, two CTAs an SM).  Q and K are staged at the true head dim (q.k runs
//    over it in float4 steps); V is staged HDP wide with the pad columns
//    zeroed once, and the pad output dims are never stored.
//
// Both mask ragged S and T edges in the kernel: no S % 64 == 0 and no
// q_offset == 0 requirement.

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
    if constexpr (HDP == HD) {  // 16-byte stores at most (hd 256: two)
      constexpr int SV = DPL * sizeof(T) <= 16 ? DPL : 16 / sizeof(T);
#pragma unroll
      for (int i = 0; i < DPL; i += SV)
        store_vec<T, SV>(ob + row * qrs + lane * DPL + i, out + i);
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


// ---------------------------------------------------------------------------
// bf16: the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using sm90::bf16;
constexpr int WG = sm90::WARPGROUP;
constexpr int BN = 64;  // kv rows a tile; each warpgroup owns 64 query rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// WGS tiles of Q (one a warpgroup), then a ring of two stages of K and V
template <int HD, int WGS>
struct Smem {
  static constexpr int TILE = 64 * HD;  // elements of one 64-row tile
  static constexpr size_t BYTES = sizeof(bf16) * (WGS + 4) * TILE;
};

// One CTA of WGS warpgroups owns 64 WGS query rows of one (head, batch):
// the warpgroups share each K/V tile, which halves the tiles' traffic from
// L2 at WGS = 2, and each runs its own 64 rows through the products.
template <int HD, int WGS>
__global__ void __launch_bounds__(WGS * WG)
flash_fwd_kernel_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int S, int T_len, int H,
                      int KV, int causal, int window, float scale,
                      float softcap, int q_offset) {
  constexpr int NT = WGS * WG, BM = 64 * WGS;
  constexpr int TILE = Smem<HD, WGS>::TILE;
  constexpr int NS = BN / 2;   // score accumulators a thread
  constexpr int NO = HD / 2;   // output accumulators a thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [WGS][TILE]
  bf16* sK = sQ + WGS * TILE;                    // [2][TILE]
  bf16* sV = sK + 2 * TILE;                      // [2][TILE]

  const int tid = threadIdx.x, lane = tid % 32, wg = tid / WG;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qrs = (long long)H * HD;   // row stride of q and o
  const long long kvrs = (long long)KV * HD;  // row stride of k and v
  const bf16* qb = q + (long long)b * S * qrs + (long long)h * HD;
  bf16* ob = o + (long long)b * S * qrs + (long long)h * HD;
  const bf16* kb = k + (long long)b * T_len * kvrs + (long long)kvh * HD;
  const bf16* vb = v + (long long)b * T_len * kvrs + (long long)kvh * HD;

  // kv range of the CTA (window start of its first row to the causal
  // frontier of its last) and of this warpgroup's 64 rows, which skips the
  // tiles that are fully masked for them
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

  sm90::load_tile<BM, HD, NT>(sQ, qb, qrs, q0, S);
  if (kv_begin < kv_end) {
    sm90::load_tile<BN, HD, NT>(sK, kb, kvrs, kv_begin, T_len);
    sm90::load_tile<BN, HD, NT>(sV, vb, kvrs, kv_begin, T_len);
  }
  sm90::cp_async_commit();

  // this thread's rows of its warpgroup's 64: r_a and r_a + 8; m and the
  // scores in log2 units (scale and log2 e folded into one multiply)
  const int r_a = sm90::acc_row(0);
  const float sl2 = softcap > 0.f ? softcap * LOG2E : scale * LOG2E;
  float acc[NO], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  const uint64_t dq = sm90::desc_k_major<HD>(sQ + wg * TILE);

  int stage = 0;
  for (int kt = kv_begin; kt < kv_end; kt += BN, stage ^= 1) {
    if (kt + BN < kv_end) {  // the next tile loads while this one runs
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
      // S = Q K^T
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      const uint64_t dk = sm90::desc_k_major<HD>(sK + stage * TILE);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::Wgmma<BN>::ss(s, dq + kk * sm90::K_MAJOR_STEP,
                               dk + kk * sm90::K_MAJOR_STEP, kk > 0);
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(s);

      // scale, cap and mask on the fragment; only tiles that cross the
      // causal frontier, the window's edge or T are masked
      const bool edge = (causal && kt + BN - 1 > w_lo) ||
                        (window > 0 && kt <= w_hi - window) ||
                        kt + BN > T_len;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int hf = (i >> 1) & 1;
        float x = softcap > 0.f ? sl2 * tanhf(s[i] * scale / softcap)
                                : s[i] * sl2;
        if (edge) {
          const int qpos = w_lo + r_a + 8 * hf;
          const int kpos = kt + sm90::acc_col(i);
          bool ok = kpos < T_len;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) x = -INFINITY;
        }
        s[i] = x;
        mx[hf] = fmaxf(mx[hf], x);
      }
      // online softmax: a row's 4 threads are lanes 4j .. 4j + 3
      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no live key
        alpha[r] = exp2f(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int hf = (i >> 1) & 1;
        s[i] = exp2f(s[i] - mu[hf]);
        l[hf] += s[i];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V, P in bf16 registers as the A operand
      uint32_t pa[BN / 16][4];
      sm90::acc_to_a(s, pa);
      const uint64_t dv = sm90::desc_mn_major<HD>(sV + stage * TILE);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::Wgmma<HD>::rs(acc, pa[kk],
                            dv + kk * sm90::MN_MAJOR_STEP<HD>, 1);
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(acc);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  sm90::cp_async_wait<0>();
  __syncthreads();

  // row sums over the row's 4 threads; the LSE; O through shared memory
  // (the K and V stages, row stride HD + 8) into coalesced 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    const int row = q0 + 64 * wg + r_a + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && row < S)
      lse[((long long)b * H + h) * S + row] =
          l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : INFINITY;
  }
  constexpr int OS = HD + 8;
  bf16* sO = sK;  // [BM][OS]
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int hf = (i >> 1) & 1;
    *reinterpret_cast<uint32_t*>(&sO[(64 * wg + sm90::acc_row(i)) * OS +
                                     sm90::acc_col(i)]) =
        sm90::pack_bf16(acc[i] * inv[hf], acc[i + 1] * inv[hf]);
  }
  __syncthreads();
  for (int i = tid; i < BM * (HD / 8); i += NT) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * qrs + c) =
          *reinterpret_cast<const uint4*>(&sO[r * OS + c]);
  }
}

// Two warpgroups a CTA: on the H100 faster than one, at the training shape
// and at the 512-token prefills (PERF.md).
constexpr int WGS = 2;

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int T_len, int H, int KV,
                   int causal, int window, float scale, float softcap,
                   int q_offset, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD, WGS>::BYTES;
  auto kern = flash_fwd_kernel_sm90<HD, WGS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((S + 64 * WGS - 1) / (64 * WGS), H, B);
  kern<<<grid, WGS * WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, T_len, H,
      KV, causal, window, scale, softcap, q_offset);
  return cudaGetLastError();
}

}  // namespace tc

// The entry point's dispatch on the head dim: the CUDA-core kernel for
// fp32, the tensor-core kernel for bf16.
template <typename T>
cudaError_t launch_hd(int HD, const void* q, const void* k, const void* v,
                      void* o, float* lse, int B, int S, int T_len, int H,
                      int KV, int causal, int window, float scale,
                      float softcap, int q_offset, cudaStream_t stream) {
  switch (HD) {
#define REPRO_CASE(D)                                                      \
  case D:                                                                  \
    if constexpr (std::is_same_v<T, float>)                                \
      return launch<float, D>(q, k, v, o, lse, B, S, T_len, H, KV, causal, \
                              window, scale, softcap, q_offset, stream);   \
    else                                                                   \
      return tc::launch<D>(q, k, v, o, lse, B, S, T_len, H, KV, causal,    \
                           window, scale, softcap, q_offset, stream);
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(80)
    REPRO_CASE(128)
    REPRO_CASE(256)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The caller has
// checked shapes, dtypes, contiguity and 16-byte alignment.  lse is null or
// a (B, H, S) fp32 buffer.  fp32 runs on the CUDA cores, bf16 on the tensor
// cores.
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
