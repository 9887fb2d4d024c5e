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
// each, plus ~10 MB of dt, B, C, dh_final, ddt, db, dc: ~262 MB, 0.078 ms
// at 3.35 TB/s; its ~38 GFLOP of products would take 0.038 ms on the bf16
// tensor cores.  This first design runs every product in fp32 on the CUDA
// cores (67 TFLOP/s), exact FMAs as in the fp32 forward, and writes and
// reads three scratch arrays, so it sits well above that bound; moving the
// products onto wgmma, as the bf16 forward does, is later work.
//
// Design.  One CTA of 256 threads per (head, batch), as in the forward: the
// chunk axis is a loop inside the CTA, so nothing crosses CTAs mid-scan.
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
#include "tile_mma.cuh"

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
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long rs, int t0, int nv,
                                          int cols, int Q) {
  for (int i = threadIdx.x; i < Q * cols; i += THREADS) {
    const int t = i / cols, k = i % cols;
    dst[t * ld + k] = t < nv ? to_float(src[(long long)(t0 + t) * rs + k])
                             : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dskip,
               const float* __restrict__ h0, const T* __restrict__ dy,
               const float* __restrict__ dhf, T* __restrict__ dx,
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
  const T* bb = bm + (long long)b * S * NS;
  const T* cb = cm + (long long)b * S * NS;
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
                  from_float<T>(acc[i][j] + dh * sDY[t * LX + d]);
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

// db and dc: the sum over heads of the per-head partials (B, NH, S, NS), in
// head order; da and dD: the sum over the batch of the (B, NH) partials
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(const float* __restrict__ dbp, const float* __restrict__ dcp,
               const float* __restrict__ dap, const float* __restrict__ ddp,
               T* __restrict__ db, T* __restrict__ dc, float* __restrict__ da,
               float* __restrict__ dd, int B, int S, int NH, int NS) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long per_b = (long long)S * NS;
  if (i < B * per_b) {
    const long long b = i / per_b, r = i % per_b;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < NH; ++h) {
      const long long k = (b * NH + h) * per_b + r;
      sb += dbp[k];
      sc += dcp[k];
    }
    db[i] = from_float<T>(sb);
    dc[i] = from_float<T>(sc);
  }
  if (i < NH) {
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < B; ++b) {
      sa += dap[(long long)b * NH + i];
      sd += ddp[(long long)b * NH + i];
    }
    da[i] = sa;
    dd[i] = sd;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, const void* d,
                   const void* h0, const void* dy, const void* dhf, void* dx,
                   void* ddt, void* db, void* dc, void* da, void* dd,
                   void* dh0, void* states, void* dbp, void* dcp, void* dap,
                   void* ddp, int B, int S, int NH, int HD, int NS, int Q,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Q, HD, NS);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = ssd_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(NH, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<const T*>(dy),
      static_cast<const float*>(dhf), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dh0),
      static_cast<float*>(states), static_cast<float*>(dbp),
      static_cast<float*>(dcp), static_cast<float*>(dap),
      static_cast<float*>(ddp), S, NH, HD, NS, Q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)B * S * NS > NH ? (long long)B * S * NS : NH;
  ssd_bwd_reduce<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                      stream>>>(
      static_cast<const float*>(dbp), static_cast<const float*>(dcp),
      static_cast<const float*>(dap), static_cast<const float*>(ddp),
      static_cast<T*>(db), static_cast<T*>(dc), static_cast<float*>(da),
      static_cast<float*>(dd), B, S, NH, NS);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  The caller has
// checked shapes, dtypes and contiguity, picked Q (32 or 64) and allocated
// the scratch: states (B, NH, ceil(S / Q), HD, NS), dbp and dcp (B, NH, S,
// NS), dap and ddp (B, NH), all fp32.  h0, dhf and dh0 may be null.
extern "C" int mamba_chunk_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* h0, const void* dy,
    const void* dhf, void* dx, void* ddt, void* db, void* dc, void* da,
    void* dd, void* dh0, void* states, void* dbp, void* dcp, void* dap,
    void* ddp, int dtype, int B, int S, int NH, int HD, int NS, int Q,
    void* stream) {
  if (HD < 1 || HD > MAX_DIM || NS < 1 || NS > MAX_DIM || S < 1 || B < 1 ||
      NH < 1 || (Q != 32 && Q != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kern) {
    return (int)kern(x, dt, a, b, c, d, h0, dy, dhf, dx, ddt, db, dc, da, dd,
                     dh0, states, dbp, dcp, dap, ddp, B, S, NH, HD, NS, Q,
                     st);
  };
  if (dtype == DTYPE_F32) return go(launch<float>);
  if (dtype == DTYPE_BF16) return go(launch<__nv_bfloat16>);
  return (int)cudaErrorInvalidValue;
}
