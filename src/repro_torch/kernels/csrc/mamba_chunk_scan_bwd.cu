// Mamba-2 SSD chunk scan, backward, for Hopper (sm_90a).
//
// The gradient of src/repro/kernels/mamba_chunk_scan.py::mamba_chunk_scan
// (the Pallas TPU kernel _ssd_kernel, forward only: the JAX package
// differentiates its jnp chunked scan, repro/models/mamba2.py::
// _ssd_chunked, through XLA).  Same function as the exact reverse
// recurrence of kernels/ref.py::mamba_chunk_scan_bwd: from x (B,S,NH,HD),
// B and C (B,S,NS) and dy (B,S,NH,HD) in one dtype (fp32 or bf16), dt
// (B,S,NH), a and D (NH,), h0 (zeros if null) and dh_final (zeros if null)
// in fp32, it writes dx in x's dtype, ddt (B,S,NH), da and dD (NH,) and
// dh0 (B,NH,HD,NS, if asked) in fp32, and db and dc (B,S,NS) in x's dtype.
//
// The chunked form of the forward's header (csrc/mamba_chunk_scan.cu), run
// backward.  Per (batch, head) and chunk of Q rows, with F the running sum
// of l = dt a inside the chunk (F <= 0, non-increasing), H_in the state
// entering the chunk and dH the gradient of the state leaving it (dh_final
// at the last chunk):
//   S = C B^T, P = dy x^T, e[s][u] = exp(F_s - F_u) for u <= s, else 0
//   W = S e dt_u,  Pd = P e dt_u,  T = S e P,  dec_t = dt_t exp(F_Q - F_t)
//   dx  = W^T dy + dec (x) (B dH^T) + D dy
//   dB  = Pd^T C + dec (x) (x dH)                    (this head's share)
//   dC  = exp(F) (x) (dy H_in) + Pd B                (this head's share)
//   dF_s = exp(F_s) <dy_s, H_in C_s> + sum_u T[s][u] dt_u
//          - dt_s sum_u T[u][s] - dec_s q_s,   q_t = x_t^T dH B_t
//   dF_Q += exp(F_Q) <dH, H_in> + sum_u dec_u q_u
//   dl_t = sum_{s >= t} dF_s,  ddt_t = a dl_t + sum_s T[s][t] + exp(F_Q -
//          F_t) q_t,  da += sum_t dt_t dl_t,  dD += sum_t <dy_t, x_t>
//   dH <- exp(F_Q) dH + (exp(F) (x) dy)^T C   (dh0 after the first chunk)
// As in the forward, every exponent is <= 0 (the masked triangle is never
// exponentiated), so nothing overflows.
//
// What bounds it on the H100: the bytes.  At zamba2's training shape (B=4,
// S=2048, NH=80, HD=NS=64, bf16) it must read x and dy and write dx, 84 MB
// each, plus ~14 MB of dt, B, C, dh_final, ddt, db, dc: ~266 MB, 0.0795 ms
// at 3.35 TB/s; its ~38 GFLOP of products would take 0.038 ms on the bf16
// tensor cores.
//
// Two routes, chosen by dtype inside the entry point (a dispatch, not a
// fallback: a bf16 call never reaches the CUDA-core code).
//
// bf16, on the tensor cores (sm90_mma.cuh), chunk-parallel: four kernels.
// Both recurrences that cross chunks are linear and elementwise in the
// (HD, NS) state: the state entering chunk c + 1 is H_{c+1} = exp(F_Q^c)
// H_c + (dec^c x_c)^T B_c, and the gradient of the state leaving chunk
// c - 1 is dH_{c-1} = exp(F_Q^c) dH_c + (exp(F^c) dy_c)^T C_c.  Given both
// for every chunk, the rest is local to one chunk (the decomposition of
// Dao and Gu, arXiv 2405.21060, section 6).  The chunks are taken K at a
// time (segments), so that only the segments' boundary states cross CTAs:
//  1. ssd_bwd_states, one CTA a (head, segment, batch), walks the
//     segment's chunks forward and backward side by side, carrying each
//     recurrence from zero inside the segment, and stores its value at
//     every chunk (P, Q) and the segment's totals (T, U) in fp32 scratch
//     (2, B, NH, NC + NSEG, HD, NS).
//  2. ssd_bwd_scan, per (batch, head), four state elements a thread: the
//     two scans over segments, in place (T becomes the state entering each
//     segment, U the gradient of the state leaving it; dh0 is what the
//     reverse scan leaves), and each chunk's decays to its segment's
//     boundaries.
//  3. ssd_bwd_chunk, one CTA a (head group, chunk, batch).  H_in and dH
//     of a head are its segment's boundary state, decayed, plus P or Q,
//     staged by cp.async a phase ahead.  S = C B^T is formed once for the
//     group (it does not depend on the head) and kept in fp32 shared
//     memory.  Per head, P^T = x dy^T and P = dy x^T give W^T, Pd^T and Pd
//     in registers (an accumulator's layout is the A fragment's, so the
//     transposed product is formed, not the tile transposed), and
//       dx = dec (x) (B dH^T) + W^T dy + D dy
//       dB = dec (x) (x dH) + Pd^T C,   dC = exp(F) (x) (dy H_in) + Pd B,
//     each as a product with the state (three bf16 terms in shared
//     memory), scaled by rows after the product, and a register-A product
//     accumulated into it.  db and dc are summed over the group's heads
//     in head order in registers, so their partials are (B, NH / G, S,
//     NS); da and dD go to (B, NC, NH).  q, r and the sums of T come from
//     quad shuffles of the accumulators, dF's reverse running sum from a
//     warp scan, dD from P's diagonal.
//  4. ssd_bwd_reduce: db and dc over groups, da and dD over batch rows and
//     chunks, in a fixed order: no atomics, so two calls give the same
//     bits.
// Precision: as in the forward, every fp32 operand of a product (W^T,
// Pd^T, Pd, dH, H_in, dec x, exp(F) dy) goes in as three bf16 terms hi +
// mid + lo, small terms first, and sums stay in fp32; x, dy, B and C are
// bf16 already.  tests/test_torch_kernels.py emulates these roundings:
// every output within SSD_BWD_REL_L2_BF16, and any one of those operands
// rounded to one bf16 term lands past it.  Q = 64; HD and NS up to 128,
// multiples of 8, zero-padded to 64 or 128 in shared memory; G heads a
// group at NS <= 64 (one at a larger NS) and K chunks a segment are the
// host's (kernels/mamba_chunk_scan.py::bwd_group, BWD_SEGMENT).  What
// each part costs is measured in PERF.md.
//
// fp32, ssd_bwd_kernel, on the CUDA cores (the first design; exact FMAs,
// so the fp32 checks' 1e-5 holds).  One CTA of 256 threads per (head,
// batch): the chunk axis is a loop inside the CTA, so nothing crosses CTAs
// mid-scan.
//  * A forward pass first recomputes the state entering each chunk (the
//    forward kernel keeps it in registers and writes only h_final) into
//    fp32 scratch (B, NH, NC, HD, NS); the CTA reads its own states back.
//  * The reverse pass walks the chunks from last to first, carrying dH
//    (HD x NS, fp32) in shared memory.  Each chunk's x, dy, B, C, dt and
//    H_in sit in shared memory; its products are 64 x 64 register tiles
//    (tile_mma.cuh), rows padded by one float so strided reads are free of
//    bank conflicts.  The running and reverse sums of F and dF are warp
//    scans.
//  * Sums across heads (db, dc) and across batch rows (da, dD) go to
//    per-(batch, head) fp32 partials, which a second kernel adds up in a
//    fixed order: no atomics, so two calls give the same bits.
//  * Q = 64 where shared memory allows (HD or NS <= 64 with the other <=
//    128); at HD = NS = 128 the host picks Q = 32 (kernels/
//    mamba_chunk_scan.py::bwd_chunk).  The chunk length of the backward
//    does not have to be the forward's: the states are its own.
//  * Ragged S: the last chunk is padded with dt = 0 and x = B = C = dy = 0,
//    which adds nothing to any sum; padded rows are never stored.

#include "common.cuh"
#include "sm90_mma.cuh"
#include "tile_mma.cuh"

#include <type_traits>

using namespace repro;
using namespace repro::tiles;

namespace {

constexpr int MAX_DIM = 128;        // largest HD and NS taken
constexpr int MAX_SMEM = 232448;    // bytes of shared memory a CTA may use
constexpr int NVEC = 9;             // Q-long vectors in shared memory
constexpr int NWARP = THREADS / 32;

// floats of shared memory at chunk length Q (kernels/mamba_chunk_scan.py::
// bwd_smem_bytes computes the same)
size_t smem_floats(int Q, int HD, int NS) {
  // sX, sDY [Q][HD+1]; sB, sC [Q][NS+1]; sH, sHin [HD][NS+1];
  // sW, sP, sT [Q][Q+1]; NVEC vectors [Q]; NWARP + 2 scalars
  return 2 * (size_t)Q * (HD + 1) + 2 * (size_t)Q * (NS + 1) +
         2 * (size_t)HD * (NS + 1) + 3 * (size_t)Q * (Q + 1) +
         NVEC * (size_t)Q + NWARP + 2;
}

// rows [t0, t0 + nv) and columns [0, cols) of a matrix with row stride rs
// into dst (row stride ld, Q rows); rows past nv become zeros
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long rs, int t0, int nv,
                                          int cols, int Q) {
  for (int i = threadIdx.x; i < Q * cols; i += THREADS) {
    const int t = i / cols, k = i % cols;
    dst[t * ld + k] = t < nv ? src[(long long)(t0 + t) * rs + k] : 0.f;
  }
}

// Warp 0: F = the inclusive running sum of dt a over the chunk's Q rows (a
// lane owns Q / 32 consecutive rows), exp(F), dec = dt exp(F_Q - F), and
// exp(F_Q) into *efq.
__device__ __forceinline__ void chunk_decays(const float* sDt, float ah,
                                             int Q, float* sF, float* sEf,
                                             float* sDec, float* efq) {
  const int lane = threadIdx.x % 32, R = Q / 32, r0 = lane * R;
  float v[2] = {0.f, 0.f}, own = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (r < R) {
      v[r] = sDt[r0 + r] * ah;
      own += v[r];
    }
  float run = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(FULL_MASK, run, o);
    run += lane >= o ? up : 0.f;
  }
  const float ftot = __shfl_sync(FULL_MASK, run, 31);
  float f = run - own;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (r < R) {
      f += v[r];
      sF[r0 + r] = f;
      sEf[r0 + r] = expf(f);
      sDec[r0 + r] = expf(fminf(ftot - f, 0.f)) * sDt[r0 + r];
    }
  if (lane == 31) *efq = expf(ftot);
}

// the sum of v over the 16 threads of a row group (same ty, tx = 0..15)
__device__ __forceinline__ float row_group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ dskip,
               const float* __restrict__ h0, const float* __restrict__ dy,
               const float* __restrict__ dhf, float* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ dh0,
               float* __restrict__ states, float* __restrict__ dbp,
               float* __restrict__ dcp, float* __restrict__ dap,
               float* __restrict__ ddp, int S, int NH, int HD, int NS,
               int Q) {
  extern __shared__ __align__(16) float smem[];
  const int LX = HD + 1, LN = NS + 1, LQ = Q + 1;
  float* sX = smem;              // [Q][LX]
  float* sDY = sX + Q * LX;      // [Q][LX]
  float* sB = sDY + Q * LX;      // [Q][LN]
  float* sC = sB + Q * LN;       // [Q][LN]
  float* sH = sC + Q * LN;       // [HD][LN] the state, then dH
  float* sHin = sH + HD * LN;    // [HD][LN] the state entering the chunk
  float* sW = sHin + HD * LN;    // [Q][LQ] W
  float* sP = sW + Q * LQ;       // [Q][LQ] Pd
  float* sT = sP + Q * LQ;       // [Q][LQ] T
  float* sDt = sT + Q * LQ;      // [Q] dt
  float* sF = sDt + Q;           // [Q] running sum of dt a
  float* sEf = sF + Q;           // [Q] exp(F_t)
  float* sDec = sEf + Q;         // [Q] dt_t exp(F_Q - F_t)
  float* sQv = sDec + Q;         // [Q] q_t = x_t^T dH B_t
  float* sR = sQv + Q;           // [Q] exp(F_s) <dy_s, H_in C_s>
  float* sCT = sR + Q;           // [Q] sum_s T[s][t]
  float* sDF = sCT + Q;          // [Q] dL/dF_t
  float* sDot = sDF + Q;         // [Q] <dy_t, x_t>
  float* sRed = sDot + Q;        // [NWARP] a block sum's warp partials
  float* sEfq = sRed + NWARP;    // exp(F_Q)
  float* sHH = sEfq + 1;         // <dH, H_in>

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const float ah = a[h], dh = dskip[h];
  const long long xrs = (long long)NH * HD;  // row stride of x, dy, dx
  const long long xo = (long long)b * S * xrs + (long long)h * HD;
  const float* dtb = dt + (long long)b * S * NH + h;
  float* ddtb = ddt + (long long)b * S * NH + h;
  const float* bb = bm + (long long)b * S * NS;
  const float* cb = cm + (long long)b * S * NS;
  const long long bh = (long long)b * NH + h;
  const long long hoff = bh * HD * NS;
  const int NC = (S + Q - 1) / Q;
  float* st = states + bh * NC * HD * NS;
  float* dbh = dbp + bh * S * NS;
  float* dch = dcp + bh * S * NS;
  const int HN = HD * NS;

  // ---- forward: the state entering each chunk, to scratch ----
  for (int i = tid; i < HN; i += THREADS)
    sH[(i / NS) * LN + i % NS] = h0 ? h0[hoff + i] : 0.f;
  for (int c = 0; c < NC; ++c) {
    const int t0 = c * Q, nv = min(Q, S - t0);
    __syncthreads();  // the previous update of H is done
    for (int i = tid; i < HN; i += THREADS)
      st[(long long)c * HN + i] = sH[(i / NS) * LN + i % NS];
    if (c == NC - 1) break;  // the last chunk's output state is not needed
    load_rows(sX, LX, x + xo, xrs, t0, nv, HD, Q);
    load_rows(sB, LN, bb, NS, t0, nv, NS, Q);
    for (int t = tid; t < Q; t += THREADS)
      sDt[t] = t < nv ? dtb[(long long)(t0 + t) * NH] : 0.f;
    __syncthreads();
    if (warp == 0) chunk_decays(sDt, ah, Q, sF, sEf, sDec, sEfq);
    __syncthreads();
    for (int i = tid; i < Q * NS; i += THREADS) {  // fold the decay into B
      const int t = i / NS, n = i % NS;
      sB[t * LN + n] *= sDec[t];
    }
    __syncthreads();
    // H = exp(F_Q) H + x^T (dec B): rows d, cols n, K = live rows
    const float efq = *sEfq;
    for (int m0 = 0; m0 < HD; m0 += TILE)
      for (int n0 = 0; n0 < NS; n0 += TILE) {
        float acc[TM][TM];
        zero(acc);
        tile_mma(acc, sX, 1, LX, sB, LN, 1, nv, m0, n0, HD, NS, ty, tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int d = m0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            const int n = n0 + tx + 16 * j;
            if (d < HD && n < NS)
              sH[d * LN + n] = efq * sH[d * LN + n] + acc[i][j];
          }
        }
      }
  }

  // ---- reverse: dH from dh_final, chunk by chunk ----
  __syncthreads();
  for (int i = tid; i < HN; i += THREADS)
    sH[(i / NS) * LN + i % NS] = dhf ? dhf[hoff + i] : 0.f;
  float da_acc = 0.f, dd_acc = 0.f;  // warp 0's lanes
  for (int c = NC - 1; c >= 0; --c) {
    const int t0 = c * Q, nv = min(Q, S - t0);
    __syncthreads();  // the previous chunk is done with every buffer
    load_rows(sX, LX, x + xo, xrs, t0, nv, HD, Q);
    load_rows(sDY, LX, dy + xo, xrs, t0, nv, HD, Q);
    load_rows(sB, LN, bb, NS, t0, nv, NS, Q);
    load_rows(sC, LN, cb, NS, t0, nv, NS, Q);
    for (int t = tid; t < Q; t += THREADS)
      sDt[t] = t < nv ? dtb[(long long)(t0 + t) * NH] : 0.f;
    for (int i = tid; i < HN; i += THREADS)
      sHin[(i / NS) * LN + i % NS] = st[(long long)c * HN + i];
    __syncthreads();
    if (warp == 0) chunk_decays(sDt, ah, Q, sF, sEf, sDec, sEfq);
    __syncthreads();

    // S = C B^T and P = dy x^T (rows s, cols u); W, Pd and T from them
    {
      float as[TM][TM], ap[TM][TM];
      zero(as);
      zero(ap);
      tile_mma(as, sC, LN, 1, sB, 1, LN, NS, 0, 0, Q, Q, ty, tx);
      tile_mma(ap, sDY, LX, 1, sX, 1, LX, HD, 0, 0, Q, Q, ty, tx);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int s = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int u = tx + 16 * j;
          if (s < Q && u < Q) {
            const float e = u <= s ? expf(fminf(sF[s] - sF[u], 0.f)) : 0.f;
            const float me = as[i][j] * e;
            sW[s * LQ + u] = me * sDt[u];
            sP[s * LQ + u] = ap[i][j] * e * sDt[u];
            sT[s * LQ + u] = me * ap[i][j];
          }
        }
      }
    }
    {  // <dH, H_in>, warp partials
      float v = 0.f;
      for (int i = tid; i < HN; i += THREADS) {
        const int k = (i / NS) * LN + i % NS;
        v += sH[k] * sHin[k];
      }
      v = warp_sum(v);
      if (lane == 0) sRed[warp] = v;
    }
    for (int t = tid; t < Q; t += THREADS) {  // <dy_t, x_t>
      float v = 0.f;
      for (int d = 0; d < HD; ++d) v += sDY[t * LX + d] * sX[t * LX + d];
      sDot[t] = v;
    }
    __syncthreads();

    // dx = dec (x) (B dH^T) + W^T dy + D dy, and q_t = x_t . (B dH^T)_t
    {
      float qp[TM] = {0.f, 0.f, 0.f, 0.f};
      for (int n0 = 0; n0 < HD; n0 += TILE) {
        float acc[TM][TM];
        zero(acc);
        tile_mma(acc, sB, LN, 1, sH, 1, LN, NS, 0, n0, Q, HD, ty, tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int t = min(ty + 16 * i, Q - 1);
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            const int d = n0 + tx + 16 * j;
            if (d < HD) qp[i] += sX[t * LX + d] * acc[i][j];
            acc[i][j] *= sDec[t];
          }
        }
        tile_mma(acc, sW, 1, LQ, sDY, LX, 1, nv, 0, n0, Q, HD, ty, tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int t = ty + 16 * i;
          if (t >= nv) continue;
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            const int d = n0 + tx + 16 * j;
            if (d < HD)
              dx[xo + (long long)(t0 + t) * xrs + d] =
                  acc[i][j] + dh * sDY[t * LX + d];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float v = row_group_sum(qp[i]);
        if (tx == 0 && ty + 16 * i < Q) sQv[ty + 16 * i] = v;
      }
    }
    // this head's dB = dec (x) (x dH) + Pd^T C
    for (int n0 = 0; n0 < NS; n0 += TILE) {
      float acc[TM][TM];
      zero(acc);
      tile_mma(acc, sX, LX, 1, sH, LN, 1, HD, 0, n0, Q, NS, ty, tx);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float dec = sDec[min(ty + 16 * i, Q - 1)];
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] *= dec;
      }
      tile_mma(acc, sP, 1, LQ, sC, LN, 1, nv, 0, n0, Q, NS, ty, tx);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int t = ty + 16 * i;
        if (t >= nv) continue;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int n = n0 + tx + 16 * j;
          if (n < NS) dbh[(long long)(t0 + t) * NS + n] = acc[i][j];
        }
      }
    }
    // this head's dC = exp(F) (x) (dy H_in) + Pd B, and
    // r_s = exp(F_s) <(dy H_in)_s, C_s>
    {
      float rp[TM] = {0.f, 0.f, 0.f, 0.f};
      for (int n0 = 0; n0 < NS; n0 += TILE) {
        float acc[TM][TM];
        zero(acc);
        tile_mma(acc, sDY, LX, 1, sHin, LN, 1, HD, 0, n0, Q, NS, ty, tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int s = min(ty + 16 * i, Q - 1);
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n < NS) rp[i] += acc[i][j] * sC[s * LN + n];
            acc[i][j] *= sEf[s];
          }
        }
        tile_mma(acc, sP, LQ, 1, sB, LN, 1, nv, 0, n0, Q, NS, ty, tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int s = ty + 16 * i;
          if (s >= nv) continue;
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n < NS) dch[(long long)(t0 + s) * NS + n] = acc[i][j];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int s = ty + 16 * i;
        const float v = row_group_sum(rp[i]);
        if (tx == 0 && s < Q) sR[s] = sEf[min(s, Q - 1)] * v;
      }
    }
    // the column sums of T
    for (int u = tid; u < Q; u += THREADS) {
      float v = 0.f;
      for (int s = u; s < Q; ++s) v += sT[s * LQ + u];
      sCT[u] = v;
    }
    if (tid == 0) {
      float v = 0.f;
      for (int w = 0; w < NWARP; ++w) v += sRed[w];
      *sHH = v;
    }
    __syncthreads();

    // dF_s, and dy's rows scaled by exp(F) for the update of dH
    for (int s = tid; s < Q; s += THREADS) {
      float v = 0.f;
      for (int u = 0; u <= s; ++u) v += sT[s * LQ + u] * sDt[u];
      sDF[s] = sR[s] + v - sDt[s] * sCT[s] - sDec[s] * sQv[s];
    }
    for (int i = tid; i < Q * HD; i += THREADS) {
      const int t = i / HD, d = i % HD;
      sDY[t * LX + d] *= sEf[t];
    }
    __syncthreads();

    // warp 0: dl = the reverse running sum of dF (dF_Q takes the chunk's
    // own terms), ddt, and the da and dD partials
    if (warp == 0) {
      const int R = Q / 32;
      const float efq = *sEfq;
      float dq = 0.f;
      for (int r = 0; r < R; ++r) dq += sDec[lane * R + r] * sQv[lane * R + r];
      dq = warp_sum(dq);
      // a lane owns rows Q - 1 - (lane R + r), r < R: reversed order
      float v[2] = {0.f, 0.f}, own = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (r < R) {
          const int t = Q - 1 - (lane * R + r);
          v[r] = sDF[t] + (t == Q - 1 ? efq * *sHH + dq : 0.f);
          own += v[r];
        }
      float run = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(FULL_MASK, run, o);
        run += lane >= o ? up : 0.f;
      }
      float dl = run - own;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (r < R) {
          const int t = Q - 1 - (lane * R + r);
          dl += v[r];
          if (t < nv) {
            const float e = expf(fminf(sF[Q - 1] - sF[t], 0.f));
            ddtb[(long long)(t0 + t) * NH] = ah * dl + sCT[t] + e * sQv[t];
            da_acc += sDt[t] * dl;
            dd_acc += sDot[t];
          }
        }
    }
    // dH = exp(F_Q) dH + (exp(F) dy)^T C: rows d, cols n, K = live rows
    {
      const float efq = *sEfq;
      for (int m0 = 0; m0 < HD; m0 += TILE)
        for (int n0 = 0; n0 < NS; n0 += TILE) {
          float acc[TM][TM];
          zero(acc);
          tile_mma(acc, sDY, 1, LX, sC, LN, 1, nv, m0, n0, HD, NS, ty, tx);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int d = m0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < TM; ++j) {
              const int n = n0 + tx + 16 * j;
              if (d < HD && n < NS)
                sH[d * LN + n] = efq * sH[d * LN + n] + acc[i][j];
            }
          }
        }
    }
  }
  __syncthreads();
  if (dh0 != nullptr)
    for (int i = tid; i < HN; i += THREADS)
      dh0[hoff + i] = sH[(i / NS) * LN + i % NS];
  if (warp == 0) {
    da_acc = warp_sum(da_acc);
    dd_acc = warp_sum(dd_acc);
    if (lane == 0) {
      dap[bh] = da_acc;
      ddp[bh] = dd_acc;
    }
  }
}

// db and dc: the sum of the NP partials (B, NP, S, NS) of each batch row,
// in order (NP heads, or head groups); da and dD: the sum over R rows of
// the (R, NH) partials (R batch rows, or batch rows times chunks)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(const float* __restrict__ dbp, const float* __restrict__ dcp,
               const float* __restrict__ dap, const float* __restrict__ ddp,
               T* __restrict__ db, T* __restrict__ dc, float* __restrict__ da,
               float* __restrict__ dd, int B, int S, int NP, int NS, int NH,
               int R) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long per_b = (long long)S * NS;
  if (i < B * per_b) {
    const long long b = i / per_b, r = i % per_b;
    float sb = 0.f, sc = 0.f;
    for (int p = 0; p < NP; ++p) {
      const long long k = (b * NP + p) * per_b + r;
      sb += dbp[k];
      sc += dcp[k];
    }
    db[i] = from_float<T>(sb);
    dc[i] = from_float<T>(sc);
  }
  if (i < NH) {
    float sa = 0.f, sd = 0.f;
    for (int r = 0; r < R; ++r) {
      sa += dap[(long long)r * NH + i];
      sd += ddp[(long long)r * NH + i];
    }
    da[i] = sa;
    dd[i] = sd;
  }
}

template <typename T>
cudaError_t launch_reduce(const void* dbp, const void* dcp, const void* dap,
                          const void* ddp, void* db, void* dc, void* da,
                          void* dd, int B, int S, int NP, int NS, int NH,
                          int R, cudaStream_t stream) {
  const long long n = (long long)B * S * NS > NH ? (long long)B * S * NS : NH;
  ssd_bwd_reduce<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                      stream>>>(
      static_cast<const float*>(dbp), static_cast<const float*>(dcp),
      static_cast<const float*>(dap), static_cast<const float*>(ddp),
      static_cast<T*>(db), static_cast<T*>(dc), static_cast<float*>(da),
      static_cast<float*>(dd), B, S, NP, NS, NH, R);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* dt, const void* a,
                       const void* b, const void* c, const void* d,
                       const void* h0, const void* dy, const void* dhf,
                       void* dx, void* ddt, void* db, void* dc, void* da,
                       void* dd, void* dh0, void* states, void* dbp,
                       void* dcp, void* dap, void* ddp, int B, int S, int NH,
                       int HD, int NS, int Q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Q, HD, NS);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = ssd_bwd_kernel;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(NH, B), THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<const float*>(dy),
      static_cast<const float*>(dhf), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dh0),
      static_cast<float*>(states), static_cast<float*>(dbp),
      static_cast<float*>(dcp), static_cast<float*>(dap),
      static_cast<float*>(ddp), S, NH, HD, NS, Q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_reduce<float>(dbp, dcp, dap, ddp, db, dc, da, dd, B, S, NH,
                              NS, NH, B, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 on the tensor cores, chunk-parallel
// ---------------------------------------------------------------------------

namespace sm90b {

using sm90::bf16;

constexpr int QW = 64;                 // chunk rows
constexpr int NT = sm90::WARPGROUP;    // threads a CTA: one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint64_t KS = sm90::K_MAJOR_STEP;
constexpr int SCAN_BATCH = 8;          // segments a scan thread loads at once

// 2^x on the SFU, as in the forward (csrc/mamba_chunk_scan.cu)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Start copying rows [r0, r0 + QW) and columns [0, C) of a matrix with
// `rows` rows, `cols` columns (a multiple of 8) and row stride rs into a
// C-column tile; rows at or past `rows` and columns at or past `cols`
// become zeros.  The same trip count for every thread and no branch (a
// divergent path makes ptxas serialize the kernel's wgmma).
template <int C>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* src,
                                          long long rs, int r0, int rows,
                                          int cols) {
  constexpr int NC = C / 8;
  static_assert(QW * NC % NT == 0, "whole copies a thread");
#pragma unroll
  for (int k = 0; k < QW * NC / NT; ++k) {
    const int i = threadIdx.x + k * NT;
    const int g = i >> 3;
    const int r = (g / NC) * 8 + (i & 7), c = (g % NC) * 8;
    const bool ok = r0 + r < rows && c < cols;
    sm90::cp_async16(tile + sm90::tile_offset<C>(r, c),
                     ok ? src + (long long)(r0 + r) * rs + c : src, ok);
  }
}

// v0, v1 as three packed bf16 pairs hi, mid, lo with v = hi + mid + lo to
// fp32's 24 bits (each residual is exact in fp32)
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// F = the inclusive running sum of dt a over the chunk's QW rows, in log2
// units: every warp computes it, a lane rows 2 lane and 2 lane + 1 (their
// dt are dt0 and dt1); ftot is F at the last row.  Every kernel computes F
// by this code, so the scan's F_Q are the chunk kernels'.
__device__ __forceinline__ void chunk_f(float dt0, float dt1, float ah,
                                        float& f0, float& f1, float& ftot) {
  const int lane = threadIdx.x % 32;
  const float v0 = dt0 * ah * LOG2E, v1 = dt1 * ah * LOG2E;
  float run = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(FULL_MASK, run, o);
    run += lane >= o ? up : 0.f;
  }
  f1 = run;
  f0 = run - v1;
  ftot = __shfl_sync(FULL_MASK, run, 31);
}

// F, exp(F) and dec = dt exp(F_Q - F) of the chunk into shared memory;
// every warp writes the same values (no branch)
__device__ __forceinline__ void chunk_vectors(const float* dts, float ah,
                                              float* sF, float* sEf,
                                              float* sDec) {
  const int lane = threadIdx.x % 32;
  float f[2], ftot;
  chunk_f(dts[2 * lane], dts[2 * lane + 1], ah, f[0], f[1], ftot);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = 2 * lane + r;
    sF[t] = f[r];
    sEf[t] = exp2_sfu(f[r]);
    sDec[t] = exp2_sfu(fminf(ftot - f[r], 0.f)) * dts[t];
  }
}

// The A fragment, in the three terms of split3, of K step kk of (f (x)
// m)^T: this warp's 16 rows d from d0, element (d, u) = f_u m[u][d], for a
// QW x HDP tile m.  One ldmatrix .trans reads the four 8 x 8 core matrices
// of the tile that hold it, transposed into the fragment's layout.
template <int HDP>
__device__ __forceinline__ void mt_frag(const bf16* ms, int d0, int kk,
                                        const float* f,
                                        uint32_t (&a)[3][4]) {
  const int lane = threadIdx.x % 32, m = lane / 8;  // this lane's matrix
  const bf16* row = ms + sm90::tile_offset<HDP>(16 * kk + 8 * (m >> 1) +
                                                lane % 8,
                                                d0 + 8 * (m & 1));
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  uint32_t r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int u = sm90::acc_col(8 * kk + 2 * e);
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[e]));
    split3(f[u] * v.x, f[u + 1] * v.y, a[0][e], a[1][e], a[2][e]);
  }
}

// ---- 1. the two state recurrences inside each segment of K chunks ----

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// The state slots of (half, b, h): NC chunk slots, then NSEG segment
// slots.  Half 0 holds the state entering a chunk from the segment's own
// chunks (P), then each segment's total (T, which the scan turns into the
// state entering the segment); half 1 the same for the gradient of the
// state leaving a chunk (Q, then U, which becomes the gradient of the state
// leaving the segment).
template <typename T>
__device__ __forceinline__ T* state_slots(T* states, int half, int b, int h,
                                          int B, int NH, int NC, int NSEG,
                                          long long HN) {
  const long long per = (long long)(NC + NSEG) * HN;
  return states + ((long long)half * B * NH + (long long)b * NH + h) * per;
}

template <int HDP, int NSP>
struct StatesSmem {
  static constexpr int XT = QW * HDP, BT = QW * NSP, HT = HDP * NSP;
  // stages of (x, B, dt) for the forward walk and (dy, C, dt) for the
  // backward one (one at HD = NS = 128, where two do not fit); F, exp(F)
  // and the decay of each walk's chunk; the two running states, rows of
  // LR floats (padded so that the accumulator's float2 updates and the
  // row-wise float4 reads meet no bank conflict)
  static constexpr int STAGES = HT > 128 * 64 ? 1 : 2;
  static constexpr int LR = NSP + 8, RT = HDP * LR;
  static constexpr size_t BYTES =
      sizeof(bf16) * 2 * STAGES * (XT + BT) +
      sizeof(float) * (2 * STAGES * QW + 6 * QW + 2 * RT);
};

// Both walks' R = exp(F_Q) R + (f (x) m)^T n for their QW x HDP tiles m
// and QW x NSP tiles n, over rows [m0, m0 + 64) of HD: the two products
// are issued together, so that one's latency hides the other's.  R is in
// shared memory, rows of LR floats, walk w's at R + w * RT; ms, ns and v
// step by walk as the caller lays them out.
template <int HDP, int NSP>
__device__ __forceinline__ void state_steps(const bf16* ms, const bf16* ns,
                                            const float* v, int m0,
                                            float* R) {
  constexpr int XT = QW * HDP, BT = QW * NSP;
  const int warp = threadIdx.x / 32;
  uint32_t fa[2][QW / 16][3][4];
  float acc[2][NSP / 2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    // forward: dec x; backward: exp(F) dy (v holds F, exp(F), dec a walk)
    const float* f = v + 3 * w * QW + (w == 0 ? 2 * QW : QW);
#pragma unroll
    for (int kk = 0; kk < QW / 16; ++kk)
      mt_frag<HDP>(ms + w * XT, m0 + 16 * warp, kk, f, fa[w][kk]);
#pragma unroll
    for (int i = 0; i < NSP / 2; ++i) acc[w][i] = 0.f;
  }
  sm90::fence();
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const uint64_t dn = sm90::desc_mn_major<NSP>(ns + w * BT);
#pragma unroll
    for (int p = 2; p >= 0; --p)  // the small terms first
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk)
        sm90::Wgmma<NSP>::rs(acc[w], fa[w][kk][p],
                             dn + kk * sm90::MN_MAJOR_STEP<NSP>, 1);
  }
  sm90::commit();
  sm90::wait<0>();
  using L = StatesSmem<HDP, NSP>;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    sm90::fence_regs(acc[w]);
    const float efq = v[3 * w * QW + 2 * QW - 1];
#pragma unroll
    for (int i = 0; i < NSP / 2; i += 2) {
      float2* r = reinterpret_cast<float2*>(
          R + w * L::RT + (m0 + sm90::acc_row(i)) * L::LR + sm90::acc_col(i));
      const float2 o = *r;
      *r = make_float2(efq * o.x + acc[w][i], efq * o.y + acc[w][i + 1]);
    }
  }
}

// the running state R (rows of LR floats) to the fp32 (HD, NS) slot, in
// 16-byte row-wise stores
template <int HDP, int NSP>
__device__ __forceinline__ void store_state(const float* R, float* dst,
                                            int HD, int NS) {
  constexpr int LR = StatesSmem<HDP, NSP>::LR;
  const int n4 = NS / 4;
  for (int i = threadIdx.x; i < HD * n4; i += NT) {
    const int d = i / n4, n = (i % n4) * 4;
    *reinterpret_cast<float4*>(dst + (long long)d * NS + n) =
        *reinterpret_cast<const float4*>(R + d * LR + n);
  }
}

// One CTA a (head, segment, batch), two walks over the segment's chunks
// side by side, step r on chunk c_lo + r forward and c_hi - 1 - r
// backward.  Forward it carries R = the state from the segment's own
// chunks (R <- exp(F_Q) R + (dec x)^T B), storing R as it enters each
// chunk but the first (P) and as it leaves the last (T); backward it
// carries R <- exp(F_Q) R + (exp(F) dy)^T C, storing Q as it leaves each
// chunk but the last and U after the first.  The tiles of the next step
// load while this one computes.
template <int HDP, int NSP>
__global__ void __launch_bounds__(NT)
ssd_bwd_states(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, const bf16* __restrict__ dy,
               float* __restrict__ states, int S, int NH, int HD, int NS,
               int K) {
  using L = StatesSmem<HDP, NSP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NSTG = L::STAGES;
  bf16* sM = reinterpret_cast<bf16*>(smem_raw);  // [stage][walk][XT] x, dy
  bf16* sN = sM + 2 * NSTG * L::XT;              // [stage][walk][BT] B, C
  float* sDt = reinterpret_cast<float*>(sN + 2 * NSTG * L::BT);  // [.][.][QW]
  float* sV = sDt + 2 * NSTG * QW;  // [walk][F, exp(F), decay][QW]
  float* sR = sV + 6 * QW;   // [2 walks][HDP][LR] the running states

  const int tid = threadIdx.x;
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int NSEG = gridDim.y, B = gridDim.z;
  const int NC = (S + QW - 1) / QW;
  const int c_lo = k * K, kc = min(K, NC - c_lo);
  const long long xrs = (long long)NH * HD;
  const long long HN = (long long)HD * NS;
  const float ah = a[h];
  // walk w (0 forward with x and B, 1 backward with dy and C) at step r
  auto chunk_of = [&](int w, int r) {
    return w == 0 ? c_lo + r : c_lo + kc - 1 - r;
  };
  auto load_step = [&](int r, int st) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int t0 = chunk_of(w, r) * QW, i = 2 * st + w;
      load_rows<HDP>(sM + i * L::XT,
                     (w == 0 ? x : dy) + (long long)b * S * xrs +
                         (long long)h * HD,
                     xrs, t0, S, HD);
      load_rows<NSP>(sN + i * L::BT,
                     (w == 0 ? bm : cm) + (long long)b * S * NS, NS, t0, S,
                     NS);
      if (tid < QW) {
        const bool ok = t0 + tid < S;
        cp_async4(sDt + i * QW + tid,
                  ok ? dt + ((long long)b * S + t0 + tid) * NH + h : dt, ok);
      }
    }
  };
  if constexpr (NSTG == 2) {
    load_step(0, 0);
    sm90::cp_async_commit();
  }
  for (int i = tid; i < 2 * L::RT; i += NT) sR[i] = 0.f;
  for (int r = 0; r < kc; ++r) {
    const int st = r % NSTG;
    if constexpr (NSTG == 1) {
      __syncthreads();  // the last step is done with the tiles
      load_step(r, 0);
      sm90::cp_async_commit();
    }
    sm90::cp_async_wait<0>();
    __syncthreads();  // step r is in; the other stage is free
    if constexpr (NSTG == 2) {
      if (r + 1 < kc) load_step(r + 1, st ^ 1);
      sm90::cp_async_commit();
    }
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      float* v = sV + 3 * w * QW;
      chunk_vectors(sDt + (2 * st + w) * QW, ah, v, v + QW, v + 2 * QW);
      if (r > 0)  // R entering (forward) or leaving (backward) the chunk
        store_state<HDP, NSP>(
            sR + w * L::RT,
            state_slots(states, w, b, h, B, NH, NC, NSEG, HN) +
                (long long)chunk_of(w, r) * HN,
            HD, NS);
    }
    __syncthreads();  // the vectors are in
#pragma unroll
    for (int m0 = 0; m0 < HDP; m0 += 64)
      state_steps<HDP, NSP>(sM + 2 * st * L::XT, sN + 2 * st * L::BT, sV, m0,
                            sR);
  }
  __syncthreads();  // the last step's R is in
#pragma unroll
  for (int w = 0; w < 2; ++w)  // the segment's totals, T and U
    store_state<HDP, NSP>(
        sR + w * L::RT,
        state_slots(states, w, b, h, B, NH, NC, NSEG, HN) +
            (long long)(NC + k) * HN,
        HD, NS);
}

// ---- 2. the scans over segments, in place ----

// Per (batch, head), four state elements a thread: the state entering
// each segment, H_seg[k + 1] = D_k H_seg[k] + T_k from h0, and the
// gradient of the state leaving it, dH_end[k - 1] = D_k dH_end[k] + U_k
// from dh_final, with D_k = exp(the sum of F_Q over the segment's chunks);
// dh0 is what the second scan leaves.  The first CTA of each (batch,
// head) also writes, for each chunk c, exp(the sum of F_Q over the
// segment's chunks before c) to epre and (after c) to epost, both (B, NC,
// NH): the decays of the boundary states to chunk c.
__global__ void __launch_bounds__(NT)
ssd_bwd_scan(const float* __restrict__ dt, const float* __restrict__ a,
             const float* __restrict__ h0, const float* __restrict__ dhf,
             float* __restrict__ states, float* __restrict__ dh0,
             float* __restrict__ epre, float* __restrict__ epost, int S,
             int NH, int HN, int NC, int K) {
  extern __shared__ float sFt[];  // [NC] F_Q of each chunk, [NSEG] D_k
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int NSEG = (NC + K - 1) / K;
  float* sD = sFt + NC;
  const float ah = a[h];
  for (int c = warp; c < NC; c += NT / 32) {
    float v[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = c * QW + 2 * lane + r;
      v[r] = t < S ? dt[((long long)b * S + t) * NH + h] : 0.f;
    }
    float f0, f1, ftot;
    chunk_f(v[0], v[1], ah, f0, f1, ftot);
    if (lane == 0) sFt[c] = ftot;
  }
  __syncthreads();
  for (int k = tid; k < NSEG; k += NT) {
    float fsum = 0.f;
    for (int c = k * K; c < min(NC, k * K + K); ++c) fsum += sFt[c];
    sD[k] = exp2_sfu(fsum);
  }
  if (blockIdx.x == 0)
    for (int c = tid; c < NC; c += NT) {
      const int c_lo = c / K * K, c_hi = min(NC, c_lo + K);
      float pre = 0.f, post = 0.f;
      for (int cc = c_lo; cc < c; ++cc) pre += sFt[cc];
      for (int cc = c + 1; cc < c_hi; ++cc) post += sFt[cc];
      epre[((long long)b * NC + c) * NH + h] = exp2_sfu(pre);
      epost[((long long)b * NC + c) * NH + h] = exp2_sfu(post);
    }
  __syncthreads();
  const long long i = ((long long)blockIdx.x * NT + tid) * 4;
  if (i >= HN) return;
  const long long bh = (long long)b * NH + h;
  float4* __restrict__ hs = reinterpret_cast<float4*>(
      state_slots(states, 0, b, h, B, NH, NC, NSEG, HN) + NC * HN + i);
  float4* __restrict__ gs = reinterpret_cast<float4*>(
      state_slots(states, 1, b, h, B, NH, NC, NSEG, HN) + NC * HN + i);
  const long long step = HN / 4;
  float4 cur = make_float4(0.f, 0.f, 0.f, 0.f);
  if (h0 != nullptr)
    cur = make_float4(h0[bh * HN + i], h0[bh * HN + i + 1],
                      h0[bh * HN + i + 2], h0[bh * HN + i + 3]);
  // SCAN_BATCH segments' loads in flight before their stores: each
  // address is read once, before this thread overwrites it
  for (int k0 = 0; k0 < NSEG; k0 += SCAN_BATCH) {
    float4 t[SCAN_BATCH];
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      if (k0 + k < NSEG) t[k] = __ldg(hs + (k0 + k) * step);
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      if (k0 + k < NSEG) {
        hs[(k0 + k) * step] = cur;
        const float e = sD[k0 + k];
        cur = make_float4(e * cur.x + t[k].x, e * cur.y + t[k].y,
                          e * cur.z + t[k].z, e * cur.w + t[k].w);
      }
  }
  cur = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dhf != nullptr)
    cur = make_float4(dhf[bh * HN + i], dhf[bh * HN + i + 1],
                      dhf[bh * HN + i + 2], dhf[bh * HN + i + 3]);
  for (int k0 = NSEG - 1; k0 >= 0; k0 -= SCAN_BATCH) {
    float4 t[SCAN_BATCH];
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      if (k0 - k >= 0) t[k] = __ldg(gs + (k0 - k) * step);
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      if (k0 - k >= 0) {
        gs[(k0 - k) * step] = cur;
        const float e = sD[k0 - k];
        cur = make_float4(e * cur.x + t[k].x, e * cur.y + t[k].y,
                          e * cur.z + t[k].z, e * cur.w + t[k].w);
      }
  }
  if (dh0 != nullptr)
    *reinterpret_cast<float4*>(dh0 + bh * HN + i) = cur;
}

// ---- 3. the chunk-local backward ----

template <int HDP, int NSP>
struct ChunkSmem {
  static constexpr int XT = QW * HDP, BT = QW * NSP, HT = HDP * NSP;
  // row stride of S in fp32: the transposed reads (W^T, Pd^T) meet no
  // bank conflict, the direct ones (Pd) at most two-way
  static constexpr int LS = QW + 4;
  static constexpr int NV = 7;       // QW-long vectors
  // at HD, NS <= 64 the next state's two fp32 parts are staged in shared
  // memory by cp.async a phase ahead; larger ones are read from device
  // memory
  static constexpr bool STAGED = HT <= 64 * 64;
  // db and dc are summed over a group in registers at NS <= 64; a larger
  // NS takes groups of one head
  static constexpr bool SUMS = NSP == 64;
  // the group's dt and segment decays at the end
  static size_t bytes(int G) {
    return sizeof(bf16) * (2 * XT + 2 * BT + 3 * HT) +
           sizeof(float) * (QW * LS + NV * QW + 8 + (STAGED ? 2 * HT : 0) +
                            G * (QW + 2));
  }
};

// Element (d, n) (n a multiple of 4) of a staged state: rows of NSP
// floats whose 16-byte chunks are XOR-swizzled by row, so that the eight
// threads of a quarter-warp in split_state (four rows, two chunks each)
// read distinct banks.
template <int NSP>
__device__ __forceinline__ int staged_offset(int d, int n) {
  return d * NSP + 4 * ((n >> 2) ^ (2 * (d & 3)));
}

// Start copying the fp32 (HD, NS) parts of a state, seg and (unless null)
// own, to dst and dst + ht in the staged layout.
template <int NSP>
__device__ __forceinline__ void stage_state(float* dst, const float* seg,
                                            const float* own, int HD, int NS,
                                            int ht) {
  const int n4 = NS / 4;
  for (int i = threadIdx.x; i < HD * n4; i += NT) {
    const int d = i / n4, n = (i % n4) * 4;
    const int o = staged_offset<NSP>(d, n);
    sm90::cp_async16(dst + o, seg + (long long)d * NS + n, true);
    if (own != nullptr)
      sm90::cp_async16(dst + ht + o, own + (long long)d * NS + n, true);
  }
  sm90::cp_async_commit();
}

// Split the fp32 (HD, NS) state e seg + own (own null: zero; staged in
// shared memory where STG, else rows of NS in device memory) into the
// three bf16 terms of split3, as HDP x NSP tiles (zeros past HD and NS) at
// terms[p * HT].  Sixteen threads fill one 8 x 8 core matrix (128
// contiguous bytes a term), so the stores meet no bank conflict.  With
// DOT, returns this thread's share of <the state, the state the terms
// held before> (a thread reads back its own entries before it overwrites
// them; hi + mid + lo is that state exactly).
template <int HDP, int NSP, bool DOT, bool STG>
__device__ __forceinline__ float split_state(const float* seg, float e,
                                             const float* own, bf16* terms,
                                             int HD, int NS) {
  constexpr int HT = HDP * NSP, MC = NSP / 8;  // core matrices a row
  static_assert(HT / 4 % NT == 0, "whole passes");
  float dot = 0.f;
#pragma unroll 8
  for (int k = 0; k < HT / 4 / NT; ++k) {
    const int i = threadIdx.x + k * NT;
    const int m = i >> 4;  // the core matrix, its row and half row
    const int d = (m / MC) * 8 + ((i >> 1) & 7);
    const int n = (m % MC) * 8 + 4 * (i & 1);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (d < HD && n < NS) {
      const long long o =
          STG ? staged_offset<NSP>(d, n) : (long long)d * NS + n;
      const float4 u = *reinterpret_cast<const float4*>(seg + o);
      v = make_float4(e * u.x, e * u.y, e * u.z, e * u.w);
      if (own != nullptr) {
        const float4 w = *reinterpret_cast<const float4*>(own + o);
        v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
      }
    }
    const int off = sm90::tile_offset<NSP>(d, n);
    if constexpr (DOT) {
      float w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const uint2 o = *reinterpret_cast<const uint2*>(terms + p * HT + off);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&o.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&o.y));
        w[0] += lo.x;
        w[1] += lo.y;
        w[2] += hi.x;
        w[3] += hi.y;
      }
      dot += v.x * w[0] + v.y * w[1] + v.z * w[2] + v.w * w[3];
    }
    uint2 t[3];
    split3(v.x, v.y, t[0].x, t[1].x, t[2].x);
    split3(v.z, v.w, t[0].y, t[1].y, t[2].y);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(terms + p * HT + off) = t[p];
  }
  sm90::fence_proxy_async();
  return dot;
}

// the sum of v over the quad (the four threads that share a row of an
// accumulator)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// an NSP-wide accumulator (rows t, columns n) to rows [0, nv) and
// columns [0, NS) of the fp32 (S, NS) slice at part
template <int NSP>
__device__ __forceinline__ void store_rows(const float* acc, float* part,
                                           int nv, int NS) {
#pragma unroll
  for (int i = 0; i < NSP / 2; i += 2) {
    const int t = sm90::acc_row(i), n = sm90::acc_col(i);
    if (t < nv && n < NS)
      *reinterpret_cast<float2*>(part + (long long)t * NS + n) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// exp(F_s - F_u) for s >= u, else 0 (F in log2 units; no branch)
__device__ __forceinline__ float decay(const float* sF, int s, int u) {
  const float e = exp2_sfu(fminf(sF[s] - sF[u], 0.f));
  return s >= u ? e : 0.f;
}

template <int HDP, int NSP>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const bf16* __restrict__ bm,
              const bf16* __restrict__ cm, const float* __restrict__ dskip,
              const bf16* __restrict__ dy, const float* __restrict__ states,
              bf16* __restrict__ dx, float* __restrict__ ddt,
              float* __restrict__ dbp, float* __restrict__ dcp,
              float* __restrict__ dap, float* __restrict__ ddp, int S,
              int NH, int HD, int NS, int G, int K) {
  using L = ChunkSmem<HDP, NSP>;
  constexpr int LS = L::LS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);  // [QW][HDP]
  bf16* sDY = sX + L::XT;                        // [QW][HDP]
  bf16* sB = sDY + L::XT;                        // [QW][NSP]
  bf16* sC = sB + L::BT;                         // [QW][NSP]
  bf16* sTm = sC + L::BT;      // [3][HDP][NSP] dH, then H_in, in 3 terms
  float* sS = reinterpret_cast<float*>(sTm + 3 * L::HT);  // [QW][LS] C B^T
  float* sF = sS + QW * LS;    // running sum of dt a, times log2 e
  float* sEf = sF + QW;        // exp(F_t)
  float* sDec = sEf + QW;      // dt_t exp(F_Q - F_t)
  float* sQv = sDec + QW;      // q_t = x_t^T dH B_t
  float* sCT = sQv + QW;       // sum_s T[s][t]
  float* sTR = sCT + QW;       // sum_u T[t][u] dt_u
  float* sR = sTR + QW;        // exp(F_t) <dy_t, H_in C_t>
  float* sRed = sR + QW;       // warp partials: [4] <dH, H_in>, [4] dD
  float* sStg = sRed + 8;      // [2][HD * NS] the next state (STAGED)
  float* sDtA = sStg + (L::STAGED ? 2 * L::HT : 0);  // [G][QW] group's dt
  float* sEpre = sDtA + G * QW;  // [G] exp(F_Q summed over the segment's
  float* sEpost = sEpre + G;     // chunks before c), [G] (after c)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.y, B = gridDim.z, NG = gridDim.x;
  const int t0 = c * QW, nv = min(QW, S - t0);
  const int h_lo = g * G, nh = min(G, NH - h_lo);
  const int NSEG = (NC + K - 1) / K, k = c / K;
  const int c_lo = k * K, c_hi = min(NC, c_lo + K);  // the segment
  const long long xrs = (long long)NH * HD;
  const long long HN = (long long)HD * NS;
  const long long xb = (long long)b * S * xrs;
  // head h's parts of H_in (half 0) and dH (half 1): the segment's
  // boundary state, scaled, plus the chunk's own slot (none where it is
  // zero: P of the segment's first chunk, Q of its last)
  auto seg_part = [&](int half, int h) {
    return state_slots(states, half, b, h, B, NH, NC, NSEG, HN) +
           (long long)(NC + k) * HN;
  };
  auto own_part = [&](int half, int h) -> const float* {
    if (c == (half == 0 ? c_lo : c_hi - 1)) return nullptr;
    return state_slots(states, half, b, h, B, NH, NC, NSEG, HN) +
           (long long)c * HN;
  };
  auto stage = [&](int half, int h) {
    stage_state<NSP>(sStg, seg_part(half, h), own_part(half, h), HD, NS,
                     L::HT);
  };
  // split head j's H_in (half 0) or dH (half 1) into the terms
  auto split = [&](auto dot, int half, int j) {
    const int h = h_lo + j;
    const float e = half == 0 ? sEpre[j] : sEpost[j];
    const float* own = own_part(half, h);
    if constexpr (L::STAGED)
      return split_state<HDP, NSP, decltype(dot)::value, true>(
          sStg, e, own == nullptr ? nullptr : sStg + L::HT, sTm, HD, NS);
    else
      return split_state<HDP, NSP, decltype(dot)::value, false>(
          seg_part(half, h), e, own, sTm, HD, NS);
  };
  float* pb = dbp + (((long long)b * NG + g) * S + t0) * NS;
  float* pc = dcp + (((long long)b * NG + g) * S + t0) * NS;

  load_rows<NSP>(sB, bm + (long long)b * S * NS, NS, t0, S, NS);
  load_rows<NSP>(sC, cm + (long long)b * S * NS, NS, t0, S, NS);
  load_rows<HDP>(sX, x + xb + (long long)h_lo * HD, xrs, t0, S, HD);
  load_rows<HDP>(sDY, dy + xb + (long long)h_lo * HD, xrs, t0, S, HD);
  sm90::cp_async_commit();
  if constexpr (L::STAGED) stage(1, h_lo);
  for (int i = tid; i < nh * QW; i += NT) {
    const int j = i / QW, t = i % QW;
    sDtA[i] = t < nv ? dt[((long long)b * S + t0 + t) * NH + h_lo + j]
                     : 0.f;
  }
  // the decays of the boundary states to chunk c, which the scan left in
  // the da and dD partials' slots (this CTA's, replaced below)
  for (int j = tid; j < nh; j += NT) {
    sEpre[j] = dap[((long long)b * NC + c) * NH + h_lo + j];
    sEpost[j] = ddp[((long long)b * NC + c) * NH + h_lo + j];
  }
  float sums[2][L::SUMS ? NSP / 2 : 1];  // db, dc over the group's heads
#pragma unroll
  for (int i = 0; i < (L::SUMS ? NSP / 2 : 1); ++i)
    sums[0][i] = sums[1][i] = 0.f;
  sm90::cp_async_wait<0>();
  __syncthreads();

  // S = C B^T (rows s, columns u), once for the group
  {
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    const uint64_t dc_ = sm90::desc_k_major<NSP>(sC);
    const uint64_t db_ = sm90::desc_k_major<NSP>(sB);
    sm90::fence();
#pragma unroll
    for (int kk = 0; kk < NSP / 16; ++kk)
      sm90::Wgmma<64>::ss(sacc, dc_ + kk * KS, db_ + kk * KS, 1);
    sm90::commit();
    sm90::wait<0>();
    sm90::fence_regs(sacc);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sS[sm90::acc_row(i) * LS + sm90::acc_col(i)] = sacc[i];
  }

  const uint64_t dxk = sm90::desc_k_major<HDP>(sX);
  const uint64_t dyk = sm90::desc_k_major<HDP>(sDY);
  const uint64_t dym = sm90::desc_mn_major<HDP>(sDY);
  const uint64_t dbk = sm90::desc_k_major<NSP>(sB);
  const uint64_t dbm = sm90::desc_mn_major<NSP>(sB);
  const uint64_t dcm = sm90::desc_mn_major<NSP>(sC);
  uint64_t dtk[3], dtm[3];  // the state's terms, read K-major, MN-major
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    dtk[p] = sm90::desc_k_major<NSP>(sTm + p * L::HT);
    dtm[p] = sm90::desc_mn_major<NSP>(sTm + p * L::HT);
  }
  const int r0 = sm90::acc_row(0);  // this thread's rows r0 and r0 + 8
  uint32_t fa[QW / 16][3][4];       // a register-A operand in three terms
  float pt[32];                     // P^T, then P

  for (int j = 0; j < nh; ++j) {
    const int h = h_lo + j;
    const float ah = a[h], dskh = dskip[h];
    const float* dts = sDtA + j * QW;

    // dH in three terms (staged, or from device memory), the vectors
    sm90::cp_async_wait<0>();
    __syncthreads();  // this head's x, dy (and dH) are in; the last head
                      // is done with every buffer
    chunk_vectors(dts, ah, sF, sEf, sDec);
    split(std::false_type(), 1, j);
    __syncthreads();
    if constexpr (L::STAGED) stage(0, h);  // H_in

    // P^T = x dy^T (rows u, columns s) and B dH^T (rows t, columns d);
    // meanwhile W^T[u][s] = S[s][u] e[s][u] dt_u in three terms
    float dxa[HDP / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) pt[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dxa[i] = 0.f;
    sm90::fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      sm90::Wgmma<64>::ss(pt, dxk + kk * KS, dyk + kk * KS, 1);
#pragma unroll
    for (int p = 2; p >= 0; --p)
#pragma unroll
      for (int kk = 0; kk < NSP / 16; ++kk)
        sm90::Wgmma<HDP>::ss(dxa, dbk + kk * KS, dtk[p] + kk * KS, 1);
    sm90::commit();
#pragma unroll
    for (int kk = 0; kk < QW / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const int u = sm90::acc_row(i), s = sm90::acc_col(i);
        float w[2];
#pragma unroll
        for (int k = 0; k < 2; ++k)
          w[k] = sS[(s + k) * LS + u] * decay(sF, s + k, u) * dts[u];
        split3(w[0], w[1], fa[kk][0][e], fa[kk][1][e], fa[kk][2][e]);
      }
    sm90::wait<0>();
    sm90::fence_regs(pt);
    sm90::fence_regs(dxa);

    // q_t = x_t . (B dH^T)_t; dx = dec (x) (B dH^T) + W^T dy + D dy
    {
      float qp[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) {
        const int t = sm90::acc_row(i), d = sm90::acc_col(i);
        qp[(i >> 1) & 1] +=
            __bfloat162float(sX[sm90::tile_offset<HDP>(t, d)]) * dxa[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qp[r] = quad_sum(qp[r]);
        if (lane % 4 == 0) sQv[r0 + 8 * r] = qp[r];
      }
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) dxa[i] *= sDec[sm90::acc_row(i)];
    }
    sm90::fence();
#pragma unroll
    for (int p = 2; p >= 0; --p)
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk)
        sm90::Wgmma<HDP>::rs(dxa, fa[kk][p],
                             dym + kk * sm90::MN_MAJOR_STEP<HDP>, 1);
    sm90::commit();
    sm90::wait<0>();
    sm90::fence_regs(dxa);
#pragma unroll
    for (int i = 0; i < HDP / 2; i += 2) {
      const int t = sm90::acc_row(i), d = sm90::acc_col(i);
      if (t < nv && d < HD) {
        const int off = sm90::tile_offset<HDP>(t, d);
        *reinterpret_cast<__nv_bfloat162*>(
            dx + xb + (long long)(t0 + t) * xrs + (long long)h * HD + d) =
            __floats2bfloat162_rn(
                dxa[i] + dskh * __bfloat162float(sDY[off]),
                dxa[i + 1] + dskh * __bfloat162float(sDY[off + 1]));
      }
    }

    // this head's dB = dec (x) (x dH) + Pd^T C, Pd^T[u][s] = P[s][u]
    // e[s][u] dt_u in three terms; sum_s T[s][u] with T = S e P
    {
      float ct[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;
          const int u = sm90::acc_row(i), s = sm90::acc_col(i);
          float w[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float pe = pt[i + k] * decay(sF, s + k, u);
            w[k] = pe * dts[u];
            ct[(i >> 1) & 1] += sS[(s + k) * LS + u] * pe;
          }
          split3(w[0], w[1], fa[kk][0][e], fa[kk][1][e], fa[kk][2][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ct[r] = quad_sum(ct[r]);
        if (lane % 4 == 0) sCT[r0 + 8 * r] = ct[r];
      }
      float acc[NSP / 2];
#pragma unroll
      for (int i = 0; i < NSP / 2; ++i) acc[i] = 0.f;
      sm90::fence();
#pragma unroll
      for (int p = 2; p >= 0; --p)
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk)
          sm90::Wgmma<NSP>::template ss<1>(
              acc, dxk + kk * KS, dtm[p] + kk * sm90::MN_MAJOR_STEP<NSP>, 1);
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < NSP / 2; ++i) acc[i] *= sDec[sm90::acc_row(i)];
      sm90::fence();
#pragma unroll
      for (int p = 2; p >= 0; --p)
#pragma unroll
        for (int kk = 0; kk < QW / 16; ++kk)
          sm90::Wgmma<NSP>::rs(acc, fa[kk][p],
                               dcm + kk * sm90::MN_MAJOR_STEP<NSP>, 1);
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(acc);
      if constexpr (L::SUMS) {
#pragma unroll
        for (int i = 0; i < NSP / 2; ++i) sums[0][i] += acc[i];
      } else {
        store_rows<NSP>(acc, pb, nv, NS);  // G = 1: this head's partial
      }
    }

    // H_in in three terms (staged, or from device memory), and <dH, H_in>
    sm90::cp_async_wait<0>();
    __syncthreads();  // H_in is in; every warp is done with dH's terms
    {
      const float v = warp_sum(split(std::true_type(), 0, j));
      if (lane == 0) sRed[warp] = v;
    }
    __syncthreads();
    if constexpr (L::STAGED)
      if (j + 1 < nh) stage(1, h + 1);

    // P = dy x^T (rows s, columns u) and dy H_in (rows s, columns n)
    {
      float acc[NSP / 2];
#pragma unroll
      for (int i = 0; i < 32; ++i) pt[i] = 0.f;
#pragma unroll
      for (int i = 0; i < NSP / 2; ++i) acc[i] = 0.f;
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        sm90::Wgmma<64>::ss(pt, dyk + kk * KS, dxk + kk * KS, 1);
#pragma unroll
      for (int p = 2; p >= 0; --p)
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk)
          sm90::Wgmma<NSP>::template ss<1>(
              acc, dyk + kk * KS, dtm[p] + kk * sm90::MN_MAJOR_STEP<NSP>, 1);
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(pt);
      sm90::fence_regs(acc);
      // x and dy are read for the last time: the next head's come in
      if (j + 1 < nh) {
        load_rows<HDP>(sX, x + xb + (long long)(h + 1) * HD, xrs, t0, S,
                       HD);
        load_rows<HDP>(sDY, dy + xb + (long long)(h + 1) * HD, xrs, t0, S,
                       HD);
        sm90::cp_async_commit();
      }
      // Pd[s][u] = P[s][u] e[s][u] dt_u in three terms; sum_u T[s][u]
      // dt_u; the diagonal of P, <dy_s, x_s>, for dD
      float tr[2] = {0.f, 0.f}, rp[2] = {0.f, 0.f}, dd_p = 0.f;
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;
          const int s = sm90::acc_row(i), u = sm90::acc_col(i);
          float w[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            w[k] = pt[i + k] * decay(sF, s, u + k) * dts[u + k];
            tr[(i >> 1) & 1] += sS[s * LS + u + k] * w[k];
            dd_p += s == u + k ? pt[i + k] : 0.f;
          }
          split3(w[0], w[1], fa[kk][0][e], fa[kk][1][e], fa[kk][2][e]);
        }
      // r_s = exp(F_s) <(dy H_in)_s, C_s>, then dC = exp(F) (x) (dy H_in)
      // + Pd B
#pragma unroll
      for (int i = 0; i < NSP / 2; ++i) {
        const int s = sm90::acc_row(i), n = sm90::acc_col(i);
        rp[(i >> 1) & 1] +=
            acc[i] * __bfloat162float(sC[sm90::tile_offset<NSP>(s, n)]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tr[r] = quad_sum(tr[r]);
        rp[r] = quad_sum(rp[r]);
        if (lane % 4 == 0) {
          sTR[r0 + 8 * r] = tr[r];
          sR[r0 + 8 * r] = sEf[r0 + 8 * r] * rp[r];
        }
      }
      dd_p = warp_sum(dd_p);
      if (lane == 0) sRed[4 + warp] = dd_p;
#pragma unroll
      for (int i = 0; i < NSP / 2; ++i) acc[i] *= sEf[sm90::acc_row(i)];
      sm90::fence();
#pragma unroll
      for (int p = 2; p >= 0; --p)
#pragma unroll
        for (int kk = 0; kk < QW / 16; ++kk)
          sm90::Wgmma<NSP>::rs(acc, fa[kk][p],
                               dbm + kk * sm90::MN_MAJOR_STEP<NSP>, 1);
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(acc);
      if constexpr (L::SUMS) {
#pragma unroll
        for (int i = 0; i < NSP / 2; ++i) sums[1][i] += acc[i];
      } else {
        store_rows<NSP>(acc, pc, nv, NS);
      }
    }
    __syncthreads();  // the vectors are in

    // dF, its reverse running sum dl (a lane rows QW - 1 - (2 lane + r)),
    // ddt, and the da and dD partials; every warp computes, warp 0 stores
    {
      const float efq = sEf[QW - 1];
      const float hh = sRed[0] + sRed[1] + sRed[2] + sRed[3];
      const float dq = warp_sum(sDec[2 * lane] * sQv[2 * lane] +
                                sDec[2 * lane + 1] * sQv[2 * lane + 1]);
      float v[2], own = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = QW - 1 - (2 * lane + r);
        v[r] = sR[t] + sTR[t] - dts[t] * sCT[t] - sDec[t] * sQv[t] +
               (t == QW - 1 ? efq * hh + dq : 0.f);
        own += v[r];
      }
      float run = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(FULL_MASK, run, o);
        run += lane >= o ? up : 0.f;
      }
      float dl = run - own, da_p = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = QW - 1 - (2 * lane + r);
        dl += v[r];
        da_p += dts[t] * dl;
        if (warp == 0 && t < nv)
          ddt[((long long)b * S + t0 + t) * NH + h] =
              ah * dl + sCT[t] +
              exp2_sfu(fminf(sF[QW - 1] - sF[t], 0.f)) * sQv[t];
      }
      da_p = warp_sum(da_p);
      if (tid == 0) {
        dap[((long long)b * NC + c) * NH + h] = da_p;
        ddp[((long long)b * NC + c) * NH + h] =
            sRed[4] + sRed[5] + sRed[6] + sRed[7];
      }
    }
  }

  if constexpr (L::SUMS) {  // the group's db and dc to their partials
    store_rows<NSP>(sums[0], pb, nv, NS);
    store_rows<NSP>(sums[1], pc, nv, NS);
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int HDP, int NSP>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, const void* d,
                   const void* h0, const void* dy, const void* dhf,
                   void* dx, void* ddt, void* db, void* dc, void* da,
                   void* dd, void* dh0, void* states, void* dbp, void* dcp,
                   void* dap, void* ddp, int B, int S, int NH, int HD,
                   int NS, int G, int K, cudaStream_t stream) {
  const int NC = (S + QW - 1) / QW, NG = (NH + G - 1) / G, HN = HD * NS;
  const int NSEG = (NC + K - 1) / K;
  const bf16 *xp = static_cast<const bf16*>(x),
             *bp = static_cast<const bf16*>(b),
             *cp = static_cast<const bf16*>(c),
             *dyp = static_cast<const bf16*>(dy);
  const float *dtp = static_cast<const float*>(dt),
              *ap = static_cast<const float*>(a);
  float* st = static_cast<float*>(states);

  auto k1 = ssd_bwd_states<HDP, NSP>;
  constexpr size_t smem1 = StatesSmem<HDP, NSP>::BYTES;
  cudaError_t e = allow_smem(k1, smem1);
  if (e != cudaSuccess) return e;
  k1<<<dim3(NH, NSEG, B), NT, smem1, stream>>>(xp, dtp, ap, bp, cp, dyp, st,
                                               S, NH, HD, NS, K);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t smem2 = sizeof(float) * (NC + NSEG);
  if ((e = allow_smem(ssd_bwd_scan, smem2)) != cudaSuccess) return e;
  ssd_bwd_scan<<<dim3((HN / 4 + NT - 1) / NT, NH, B), NT, smem2, stream>>>(
      dtp, ap, static_cast<const float*>(h0), static_cast<const float*>(dhf),
      st, static_cast<float*>(dh0), static_cast<float*>(dap),
      static_cast<float*>(ddp), S, NH, HN, NC, K);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  auto k3 = ssd_bwd_chunk<HDP, NSP>;
  const size_t smem3 = ChunkSmem<HDP, NSP>::bytes(G);
  if ((e = allow_smem(k3, smem3)) != cudaSuccess) return e;
  k3<<<dim3(NG, NC, B), NT, smem3, stream>>>(
      xp, dtp, ap, bp, cp, static_cast<const float*>(d), dyp, st,
      static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dbp), static_cast<float*>(dcp),
      static_cast<float*>(dap), static_cast<float*>(ddp), S, NH, HD, NS, G,
      K);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  return launch_reduce<bf16>(dbp, dcp, dap, ddp, db, dc, da, dd, B, S, NG,
                             NS, NH, B * NC, stream);
}

}  // namespace sm90b

// Returns the cudaError_t of the launches (0 on success).  The caller has
// checked shapes, dtypes and contiguity, and allocated the fp32 scratch:
//  * fp32 (Q = 32 or 64, G = 1): states (B, NH, ceil(S / Q), HD, NS), dbp
//    and dcp (B, NH, S, NS), dap and ddp (B, NH);
//  * bf16 (Q = 64, G heads a group, at most 1 where NS > 64, segments of
//    K chunks, HD and NS multiples of 8, x, b, c, dy 16-byte aligned):
//    states (2, B, NH, NC + NSEG, HD, NS) with NC = ceil(S / 64) and NSEG
//    = ceil(NC / K), dbp and dcp (B, ceil(NH / G), S, NS), dap and ddp (B,
//    NC, NH).
// h0, dhf and dh0 may be null.
extern "C" int mamba_chunk_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* h0, const void* dy,
    const void* dhf, void* dx, void* ddt, void* db, void* dc, void* da,
    void* dd, void* dh0, void* states, void* dbp, void* dcp, void* dap,
    void* ddp, int dtype, int B, int S, int NH, int HD, int NS, int Q, int G,
    int K, void* stream) {
  if (HD < 1 || HD > MAX_DIM || NS < 1 || NS > MAX_DIM || S < 1 || B < 1 ||
      NH < 1 || G < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    if ((Q != 32 && Q != 64) || G != 1 || K != 1)
      return (int)cudaErrorInvalidValue;
    return (int)launch_f32(x, dt, a, b, c, d, h0, dy, dhf, dx, ddt, db, dc,
                           da, dd, dh0, states, dbp, dcp, dap, ddp, B, S, NH,
                           HD, NS, Q, st);
  }
  if (dtype != DTYPE_BF16 || HD % 8 || NS % 8 || Q != sm90b::QW ||
      (NS > 64 && G > 1))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto kern) {
    return (int)kern(x, dt, a, b, c, d, h0, dy, dhf, dx, ddt, db, dc, da, dd,
                     dh0, states, dbp, dcp, dap, ddp, B, S, NH, HD, NS, G, K,
                     st);
  };
  if (HD <= 64)
    return NS <= 64 ? go(sm90b::launch<64, 64>)
                    : go(sm90b::launch<64, 128>);
  return NS <= 64 ? go(sm90b::launch<128, 64>)
                  : go(sm90b::launch<128, 128>);
}
