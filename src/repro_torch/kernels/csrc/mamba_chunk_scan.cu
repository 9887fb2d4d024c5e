// Mamba-2 SSD chunk scan, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mamba_chunk_scan.py::mamba_chunk_scan (the
// Pallas TPU kernel _ssd_kernel).  Same function as the sequential
// recurrence of kernels/ref.py::mamba_chunk_scan, per (batch, head):
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t,   y_t = h_t C_t + D x_t,
// with x (B,S,NH,HD), B and C (B,S,NS) in one dtype (fp32 or bf16), dt
// (B,S,NH), a and D (NH,) and the state h (B,NH,HD,NS) in fp32; h0 in
// (zeros if null), h_final out, y in x's dtype.
//
// It computes the recurrence chunk by chunk, as the TPU kernel does.  With
// F the running sum of dt a inside a chunk (F <= 0, non-increasing):
//   W[t][u]  = (C_t . B_u) exp(F_t - F_u) dt_u        for u <= t, else 0
//   y_t      = sum_u W[t][u] x_u + exp(F_t) (H C_t) + D x_t
//   H'       = exp(F_Q) H + sum_u exp(F_Q - F_u) dt_u x_u (x) B_u
// Every exponent is <= 0: exp(F_t) / exp(F_u) is never formed and the
// masked upper triangle of W is never exponentiated, so nothing overflows.
//
// What bounds it on the H100: the bytes.  At the zamba2 prefill (B=1,
// S=512, NH=80, HD=NS=64, bf16) it moves x and y (5.2 MB each), h0 and
// h_final (1.3 MB each) and a little of dt, B and C, ~13 MB or ~4 us at
// 3.35 TB/s; its ~0.85 GFLOP of products are <1 us on the bf16 tensor
// cores.  Both are far below what one CTA's chain of dependent chunks
// takes, so latency, not a roofline, sets its time.
//
// Two kernels, chosen by dtype inside the entry point (a dispatch, not a
// fallback: a bf16 call never reaches the CUDA-core code).
//
// Common to both: the TPU kernel runs the chunk axis as a sequential grid
// axis and carries the state in VMEM scratch.  Blocks on the H100 run in
// no order, so one CTA owns one (head, batch) and loops over chunks of
// Q = 64 rows itself, with the fp32 (HD, NS) state resident on chip for
// the whole sequence: it never goes to device memory between chunks.
// The grid is (NH, B): 80 CTAs at B = 1, fewer than the 132 SMs; a split
// of the sequence across CTAs did not pay at this shape (PERF.md).  The
// running sum F is a warp scan (shuffles) over the chunk.  Ragged S: the
// last chunk is padded with dt = 0, x = B = C = 0, which leaves the state
// untouched (decay exp(0) = 1, no input), as apply_mamba2's zero padding
// does; padded rows are never stored.
//
// bf16, ssd_kernel_sm90, on the tensor cores (sm90_mma.cuh).  The state
// H (HD x NS) is a wgmma accumulator that stays in fp32 registers across
// chunks; the state term of y is computed transposed, y^T = H C^T (HD x
// Q), so that H is its A operand straight from those registers:
//  * S = C B^T (t x u, K = NS): wgmma ss, both tiles read K-major.
//  * W[t][u] = S[t][u] exp(F_t - F_u) dt_u for u <= t, plus D on the
//    diagonal, formed in fp32 registers (2^x on the SFU, F in log2
//    units); the accumulator's layout is the A fragment's, so W goes
//    straight into W x (wgmma rs, x read MN-major), which includes D x.
//  * H C^T by wgmma rs with C read K-major; y = exp(F_t) (H C^T) + W x is
//    summed in fp32 in a staging buffer (the two have transposed
//    layouts) and leaves in coalesced 16-byte stores.
//  * H' = exp(F_Q) H + (decay x)^T B, decay_u = exp(F_Q - F_u) dt_u: the
//    accumulator scaled in registers, then wgmma rs with (decay x)^T
//    read by ldmatrix .trans from the x tile and B read MN-major,
//    accumulating into H.
//  * Precision.  The TPU kernel does all its arithmetic in fp32, and so
//    does the plain version.  x, B and C are bf16 already and go in as
//    they are.  Every fp32 operand (W, decay x and the state H) goes in as
//    three bf16 terms, hi + mid + lo, whose sum carries its 24-bit
//    mantissa, so each product is the fp32 product summed in fp32: y and
//    h_final stay within SSD_REL_L2_BF16 (rel. L2) of the plain version,
//    which is twice what the fp32 CUDA-core kernel reached.  One bf16 term
//    (W and decay x rounded once) would put them ~20x past it (PERF.md):
//    the state never becomes a single bf16 operand.  The tensor cores do
//    3x the products for it, 40 m64n64k16 a chunk at HD = NS = 64.  Their
//    fp32 sums are coarser than the CUDA cores' (PERF.md), so each product
//    adds its small terms first, and the state term and W x build up in
//    separate accumulators.
//  * Every wgmma operand in shared memory arrives by cp.async (x, B, C
//    and dt of the next chunk load into a second stage while this chunk
//    computes), so no proxy fence is needed: on the H100 a
//    fence.proxy.async waited for the in-flight prefetch (PERF.md).  No
//    wgmma runs on a divergent path (ptxas would serialize them all).
//    Tiles are 8 x 8 core matrices (sm90_mma.cuh).  HD and NS up to 64
//    run one warpgroup, HD up to 128 two (each owns 64 rows of H and
//    64 columns of y); HD and NS must be multiples of 8 and are
//    zero-padded to 64 or 128 in shared memory.
//
// fp32, ssd_kernel, on the CUDA cores (the first design; exact fp32 FMAs,
// so the fp32 sweeps' 2e-4 holds):
//  * Shared memory holds one chunk's x, B, C, the (Q, Q) score tile and
//    the state: 83 KB at HD = NS = 64, at most 182 KB at HD = NS = 128.
//  * The four products of a chunk (C B^T, W x, C H^T, (decay x)^T B) run
//    as 64 x 64 output tiles over 256 threads, each thread a 4 x 4
//    register tile (8 shared loads per 16 FMAs).  Row strides of NS + 1
//    and Q + 1 floats keep the strided operand reads free of bank
//    conflicts.

#include "common.cuh"
#include "sm90_mma.cuh"
#include "tile_mma.cuh"

using namespace repro;
using namespace repro::tiles;

namespace {

constexpr int Q = 64;              // chunk length
constexpr int MAX_DIM = 128;       // largest HD and NS taken

size_t smem_floats(int HD, int NS) {
  // sH[HD][NS+1], sX[Q][HD], sB/sC[Q][NS+1], sW[Q][Q+1], sDt/sF/sDec/sEf[Q]
  return (size_t)HD * (NS + 1) + (size_t)Q * HD + 2 * (size_t)Q * (NS + 1) +
         (size_t)Q * (Q + 1) + 4 * Q;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ dskip,
           const float* __restrict__ h0, T* __restrict__ y,
           float* __restrict__ hf, int S, int NH, int HD, int NS) {
  extern __shared__ __align__(16) float smem[];
  const int LN = NS + 1;                 // row stride of sH, sB, sC
  constexpr int LW = Q + 1;              // row stride of sW
  float* sH = smem;                      // [HD][LN]   state, fp32
  float* sX = sH + HD * LN;              // [Q][HD]
  float* sB = sX + Q * HD;               // [Q][LN]
  float* sC = sB + Q * LN;               // [Q][LN]
  float* sW = sC + Q * LN;               // [Q][LW]
  float* sDt = sW + Q * LW;              // [Q] dt
  float* sF = sDt + Q;                   // [Q] running sum of dt a
  float* sDec = sF + Q;                  // [Q] exp(F_Q - F_u) dt_u
  float* sEf = sDec + Q;                 // [Q] exp(F_t)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const float ah = a[h], dh = dskip[h];
  const long long xrs = (long long)NH * HD;  // row stride of x and y
  const T* xb = x + (long long)b * S * xrs + (long long)h * HD;
  T* yb = y + (long long)b * S * xrs + (long long)h * HD;
  const float* dtb = dt + (long long)b * S * NH + h;
  const T* bb = bm + (long long)b * S * NS;
  const T* cb = cm + (long long)b * S * NS;
  const long long hoff = ((long long)b * NH + h) * HD * NS;

  for (int i = tid; i < HD * NS; i += THREADS)
    sH[(i / NS) * LN + i % NS] = h0 ? h0[hoff + i] : 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int nv = min(Q, S - t0);  // live rows of this chunk
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < Q * HD; i += THREADS) {
      const int t = i / HD, d = i % HD;
      sX[i] = t < nv ? to_float(xb[(t0 + t) * xrs + d]) : 0.f;
    }
    for (int i = tid; i < Q * NS; i += THREADS) {
      const int t = i / NS, n = i % NS;
      const long long g = (long long)(t0 + t) * NS + n;
      sB[t * LN + n] = t < nv ? to_float(bb[g]) : 0.f;
      sC[t * LN + n] = t < nv ? to_float(cb[g]) : 0.f;
    }
    for (int t = tid; t < Q; t += THREADS)
      sDt[t] = t < nv ? dtb[(long long)(t0 + t) * NH] : 0.f;
    __syncthreads();

    if (warp == 0) {  // F = inclusive running sum of dt a; lane owns 2 rows
      const float v0 = sDt[2 * lane] * ah, v1 = sDt[2 * lane + 1] * ah;
      float run = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(FULL_MASK, run, o);
        if (lane >= o) run += up;
      }
      const float f1 = run, f0 = run - v1;
      const float ftot = __shfl_sync(FULL_MASK, run, 31);
      sF[2 * lane] = f0;
      sF[2 * lane + 1] = f1;
      sEf[2 * lane] = expf(f0);
      sEf[2 * lane + 1] = expf(f1);
      sDec[2 * lane] = expf(fminf(ftot - f0, 0.f)) * sDt[2 * lane];
      sDec[2 * lane + 1] = expf(fminf(ftot - f1, 0.f)) * sDt[2 * lane + 1];
    }
    __syncthreads();

    // W = (C B^T) masked and decayed: rows t, cols u, K = NS
    {
      float acc[TM][TM];
      zero(acc);
      tile_mma(acc, sC, LN, 1, sB, 1, LN, NS, 0, 0, Q, Q, ty, tx);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int u = tx + 16 * j;
          sW[t * LW + u] =
              u <= t ? acc[i][j] * expf(sF[t] - sF[u]) * sDt[u] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = exp(F_t) (C H^T) + W x + D x, in HD-wide passes of TILE columns
    for (int n0 = 0; n0 < HD; n0 += TILE) {
      float acc[TM][TM];
      zero(acc);
      tile_mma(acc, sC, LN, 1, sH, 1, LN, NS, 0, n0, Q, HD, ty, tx);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ef = sEf[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] *= ef;
      }
      tile_mma(acc, sW, LW, 1, sX, HD, 1, nv, 0, n0, Q, HD, ty, tx);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int t = ty + 16 * i;
        if (t >= nv) continue;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int d = n0 + tx + 16 * j;
          if (d < HD)
            yb[(t0 + t) * xrs + d] =
                from_float<T>(acc[i][j] + dh * sX[t * HD + d]);
        }
      }
    }
    // B is not read again before the state update: fold its decay in
    for (int i = tid; i < Q * NS; i += THREADS) {
      const int t = i / NS, n = i % NS;
      sB[t * LN + n] *= sDec[t];
    }
    __syncthreads();

    // H = exp(F_Q) H + x^T (decay B): rows d, cols n, K = live rows
    const float atot = expf(sF[Q - 1]);
    for (int m0 = 0; m0 < HD; m0 += TILE)
      for (int n0 = 0; n0 < NS; n0 += TILE) {
        float acc[TM][TM];
        zero(acc);
        tile_mma(acc, sX, 1, HD, sB, LN, 1, nv, m0, n0, HD, NS, ty, tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int d = m0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            const int n = n0 + tx + 16 * j;
            if (d < HD && n < NS)
              sH[d * LN + n] = atot * sH[d * LN + n] + acc[i][j];
          }
        }
      }
  }
  __syncthreads();
  for (int i = tid; i < HD * NS; i += THREADS)
    hf[hoff + i] = sH[(i / NS) * LN + i % NS];
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace sm90k {

using sm90::bf16;

constexpr int QW = 64;  // chunk rows; also the rows of a warpgroup's tile

// Shared memory of ssd_kernel_sm90<HDP, NSP>: two stages of the x (Q x
// HDP), B and C (Q x NSP) tiles, y staged in fp32 for coalesced stores (Q
// rows of HDP + 4), two stages of dt (a slot a thread), then F, exp(F) and
// the decay.
template <int HDP, int NSP>
struct Smem {
  static constexpr int XT = QW * HDP, BT = QW * NSP;
  static constexpr int YS = HDP + 4;  // row stride of the y staging
  static constexpr int NT = HDP / 64 * sm90::WARPGROUP;
  static constexpr size_t BYTES = sizeof(bf16) * (2 * XT + 4 * BT) +
                                  sizeof(float) * (QW * YS + 2 * NT + 3 * QW);
};

// 2^x on the SFU (ex2.approx.ftz: a relative error of about 2^-22, a
// subnormal result flushed to 0).  The library's exp2f checks its range
// with a branch, which on the H100 cut the W formation's parallelism
// (PERF.md).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// Start copying rows [r0, r0 + QW) and columns [0, C) of a matrix with
// `rows` rows, `cols` columns (a multiple of 8) and row stride rs into a
// C-column tile; rows at or past `rows` and columns at or past `cols`
// become zeros.  The same trip count for every thread and no branch: a
// divergent path here makes ptxas serialize the kernel's wgmma.
template <int C, int NT>
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

// The A fragment, in the three terms of split3, of K step kk of (decay
// x)^T: this warp's 16 rows d from d0, element (d, u) = f_u x[u][d].  One
// ldmatrix .trans reads the four 8 x 8 core matrices of the x tile (Q x
// HDP) that hold it, transposed into the fragment's layout.
template <int HDP>
__device__ __forceinline__ void xt_frag(const bf16* xs, int d0, int kk,
                                        const float* f,
                                        uint32_t (&a)[3][4]) {
  const int lane = threadIdx.x % 32, m = lane / 8;  // this lane's matrix
  const bf16* row = xs + sm90::tile_offset<HDP>(16 * kk + 8 * (m >> 1) +
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
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[e]));
    split3(f[u] * x.x, f[u + 1] * x.y, a[0][e], a[1][e], a[2][e]);
  }
}

template <int HDP, int NSP>
__global__ void __launch_bounds__(HDP / 64 * sm90::WARPGROUP, 1)
ssd_kernel_sm90(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const bf16* __restrict__ bm,
                const bf16* __restrict__ cm, const float* __restrict__ dskip,
                const float* __restrict__ h0, bf16* __restrict__ y,
                float* __restrict__ hf, int S, int NH, int HD, int NS) {
  using L = Smem<HDP, NSP>;
  constexpr int NT = L::NT;
  constexpr int NHA = NSP / 2;  // state accumulators a thread
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);  // [2][XT]
  bf16* sB = sX + 2 * L::XT;                     // [2][BT]
  bf16* sC = sB + 2 * L::BT;                     // [2][BT]
  float* sY = reinterpret_cast<float*>(sC + 2 * L::BT);  // [QW][YS]
  float* sDt = sY + QW * L::YS;  // [2][NT]
  float* sF = sDt + 2 * NT;      // running sum of dt a, times log2 e
  float* sEf = sF + QW;          // exp(F_t)
  float* sDec = sEf + QW;        // exp(F_Q - F_u) dt_u

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = tid / sm90::WARPGROUP, d0 = 64 * wg;  // this wg's rows
  const int dw0 = d0 + 16 * (warp % 4);                // this warp's
  const int h = blockIdx.x, b = blockIdx.y;
  const float ah = a[h], dh = dskip[h];
  const long long xrs = (long long)NH * HD;  // row stride of x and y
  const bf16* xb = x + (long long)b * S * xrs + (long long)h * HD;
  bf16* yb = y + (long long)b * S * xrs + (long long)h * HD;
  const float* dtb = dt + (long long)b * S * NH + h;
  const bf16* bb = bm + (long long)b * S * NS;
  const bf16* cb = cm + (long long)b * S * NS;
  const long long hoff = ((long long)b * NH + h) * HD * NS;

  auto load_chunk = [&](int st, int t0) {
    load_rows<HDP, NT>(sX + st * L::XT, xb, xrs, t0, S, HD);
    load_rows<NSP, NT>(sB + st * L::BT, bb, NS, t0, S, NS);
    load_rows<NSP, NT>(sC + st * L::BT, cb, NS, t0, S, NS);
    // dt: one copy a thread, threads past QW fill a spare slot with 0
    const bool ok = tid < QW && t0 + tid < S;
    cp_async4(sDt + st * NT + tid, ok ? dtb + (long long)(t0 + tid) * NH
                                      : dtb,
              ok);
  };
  load_chunk(0, 0);
  sm90::cp_async_commit();

  // the state, rows d0 + acc_row(i) and columns acc_col(i) of (HD, NS),
  // zero-padded past HD and NS
  float hacc[NHA];
#pragma unroll
  for (int i = 0; i < NHA; ++i) {
    const int d = d0 + sm90::acc_row(i), n = sm90::acc_col(i);
    hacc[i] = h0 != nullptr && d < HD && n < NS ? h0[hoff + d * NS + n]
                                                : 0.f;
  }

  int stage = 0;
  for (int t0 = 0; t0 < S; t0 += QW, stage ^= 1) {
    const int nv = min(QW, S - t0);  // live rows of this chunk
    sm90::cp_async_wait<0>();
    __syncthreads();  // this chunk is in; the other stage is free
    const bf16* xs = sX + stage * L::XT;
    const bf16* bs = sB + stage * L::BT;
    const bf16* cs = sC + stage * L::BT;
    const float* dts = sDt + stage * NT;
    const uint64_t dcs = sm90::desc_k_major<NSP>(cs);

    // S = C B^T (t x u) and y^T = H C^T (d x t); with two warpgroups each
    // computes S (no wgmma on a divergent path: ptxas would serialize
    // them all)
    float sacc[32], yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = yacc[i] = 0.f;
    sm90::fence();
    {
      const uint64_t dbs = sm90::desc_k_major<NSP>(bs);
#pragma unroll
      for (int kk = 0; kk < NSP / 16; ++kk)
        sm90::Wgmma<64>::ss(sacc, dcs + kk * sm90::K_MAJOR_STEP,
                            dbs + kk * sm90::K_MAJOR_STEP, kk > 0);
    }
    constexpr int KB = NSP == 64 ? 4 : 2;  // K steps a batch (registers)
#pragma unroll
    for (int k0 = 0; k0 < NSP / 16; k0 += KB) {
      uint32_t ha[KB][3][4];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * (k0 + kk) + 2 * e;
          split3(hacc[i], hacc[i + 1], ha[kk][0][e], ha[kk][1][e],
                 ha[kk][2][e]);
        }
      sm90::fence();
#pragma unroll
      for (int p = 2; p >= 0; --p)  // the small terms first
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
          sm90::Wgmma<64>::rs_kb(
              yacc, ha[kk][p], dcs + (k0 + kk) * sm90::K_MAJOR_STEP, 1);
      sm90::commit();
      if (k0 + KB < NSP / 16) sm90::wait<0>();
    }

    // while the tensor cores work: the next chunk's loads (past the end
    // they fill the free stage with zeros), and F = the inclusive running
    // sum of dt a, in log2 units.  No branch here (a divergent path with
    // a wgmma in flight serializes them all): every warp scans the chunk,
    // a lane two rows, and writes the same values.
    load_chunk(stage ^ 1, t0 + QW);
    sm90::cp_async_commit();
    {
      const float v0 = dts[2 * lane] * ah * LOG2E;
      const float v1 = dts[2 * lane + 1] * ah * LOG2E;
      float run = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(FULL_MASK, run, o);
        run += lane >= o ? up : 0.f;
      }
      const float f1 = run, f0 = run - v1;
      const float ftot = __shfl_sync(FULL_MASK, run, 31);
      sF[2 * lane] = f0;
      sF[2 * lane + 1] = f1;
      sEf[2 * lane] = exp2_sfu(f0);
      sEf[2 * lane + 1] = exp2_sfu(f1);
      sDec[2 * lane] = exp2_sfu(fminf(ftot - f0, 0.f)) * dts[2 * lane];
      sDec[2 * lane + 1] =
          exp2_sfu(fminf(ftot - f1, 0.f)) * dts[2 * lane + 1];
    }
    sm90::wait<0>();
    sm90::fence_regs(sacc);
    sm90::fence_regs(yacc);
    __syncthreads();  // F is visible

    // the state term exp(F_t) (H C^T) to the fp32 staging rows t (frees
    // its registers; W x is added below)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int d = d0 + sm90::acc_row(i), t = sm90::acc_col(i);
      sY[t * L::YS + d] = sEf[t] * yacc[i];
    }

    // W[t][u] = S[t][u] exp(F_t - F_u) dt_u for u <= t, plus D on the
    // diagonal, in three bf16 terms, as the A operand of W x (the
    // accumulator's layout is the A fragment's)
    uint32_t wa[QW / 16][3][4];
#pragma unroll
    for (int kk = 0; kk < QW / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const int t = sm90::acc_row(i), u = sm90::acc_col(i);
        float w[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          w[j] = (u + j <= t
                      ? sacc[i + j] *
                            exp2_sfu(fminf(sF[t] - sF[u + j], 0.f)) *
                            dts[u + j]
                      : 0.f) +
                 (u + j == t ? dh : 0.f);
        split3(w[0], w[1], wa[kk][0][e], wa[kk][1][e], wa[kk][2][e]);
      }

    // y' = W x (t x this warpgroup's 64 columns d), x read MN-major, into
    // S's registers
    {
      const uint64_t dx = sm90::desc_mn_major<HDP>(
          xs + sm90::tile_offset<HDP>(0, d0));
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
      sm90::fence();
#pragma unroll
      for (int p = 2; p >= 0; --p)
#pragma unroll
        for (int kk = 0; kk < QW / 16; ++kk)
          sm90::Wgmma<64>::rs(sacc, wa[kk][p],
                              dx + kk * sm90::MN_MAJOR_STEP<HDP>, 1);
      sm90::commit();
    }

    // meanwhile (decay x)^T in three terms
    uint32_t dxa[QW / 16][3][4];
#pragma unroll
    for (int kk = 0; kk < QW / 16; ++kk)
      xt_frag<HDP>(xs, dw0, kk, sDec, dxa[kk]);
    sm90::wait<0>();
    sm90::fence_regs(sacc);

    // H = exp(F_Q) H + (decay x)^T B, B read MN-major
    const float atot = sEf[QW - 1];
#pragma unroll
    for (int i = 0; i < NHA; ++i) hacc[i] *= atot;
    {
      const uint64_t dbm = sm90::desc_mn_major<NSP>(bs);
      sm90::fence();
#pragma unroll
      for (int p = 2; p >= 0; --p)
#pragma unroll
        for (int kk = 0; kk < QW / 16; ++kk)
          sm90::Wgmma<NSP>::rs(hacc, dxa[kk][p],
                               dbm + kk * sm90::MN_MAJOR_STEP<NSP>, 1);
      sm90::commit();
    }

    // y = exp(F_t) (H C^T) + W x (D x included), summed in fp32 in the
    // staging rows t: W x's owners add to what y^T's owners (the same
    // warpgroup) wrote
    if constexpr (NT == sm90::WARPGROUP)  // an immediate id: one barrier
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    else
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = sm90::acc_row(i), d = d0 + sm90::acc_col(i);
      sY[t * L::YS + d] += sacc[i];
    }
    sm90::wait<0>();
    sm90::fence_regs(hacc);
    __syncthreads();  // y is staged; this stage is consumed
#pragma unroll
    for (int k = 0; k < QW * (HDP / 8) / NT; ++k) {
      const int i = tid + k * NT;
      const int r = i / (HDP / 8), c = (i % (HDP / 8)) * 8;
      if (r < nv && c < HD) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; e += 4)
          *reinterpret_cast<float4*>(&v[e]) =
              *reinterpret_cast<const float4*>(&sY[r * L::YS + c + e]);
        store_vec<bf16, 8>(yb + (long long)(t0 + r) * xrs + c, v);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NHA; ++i) {
    const int d = d0 + sm90::acc_row(i), n = sm90::acc_col(i);
    if (d < HD && n < NS) hf[hoff + d * NS + n] = hacc[i];
  }
}

template <int HDP, int NSP>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, const void* d,
                   const void* h0, void* y, void* hf, int B, int S, int NH,
                   int HD, int NS, cudaStream_t stream) {
  constexpr size_t smem = Smem<HDP, NSP>::BYTES;
  auto kern = ssd_kernel_sm90<HDP, NSP>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(NH, B);
  kern<<<grid, HDP / 64 * sm90::WARPGROUP, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<bf16*>(y),
      static_cast<float*>(hf), S, NH, HD, NS);
  return cudaGetLastError();
}

}  // namespace sm90k

namespace {

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, const void* d,
                   const void* h0, void* y, void* hf, int B, int S, int NH,
                   int HD, int NS, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(HD, NS);
  auto kern = ssd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(NH, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hf), S, NH, HD, NS);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The caller has
// checked shapes, dtypes and contiguity, and for bf16 that HD and NS are
// multiples of 8 and x, b, c 16-byte aligned; h0 may be null (zero state).
extern "C" int mamba_chunk_scan_fwd(const void* x, const void* dt,
                                    const void* a, const void* b,
                                    const void* c, const void* d,
                                    const void* h0, void* y, void* hf,
                                    int dtype, int B, int S, int NH, int HD,
                                    int NS, void* stream) {
  if (HD < 1 || HD > MAX_DIM || NS < 1 || NS > MAX_DIM || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return (int)launch<float>(x, dt, a, b, c, d, h0, y, hf, B, S, NH, HD, NS,
                              st);
  if (dtype != DTYPE_BF16 || HD % 8 || NS % 8)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto kern) {
    return (int)kern(x, dt, a, b, c, d, h0, y, hf, B, S, NH, HD, NS, st);
  };
  if (HD <= 64)
    return NS <= 64 ? go(sm90k::launch<64, 64>) : go(sm90k::launch<64, 128>);
  return NS <= 64 ? go(sm90k::launch<128, 64>) : go(sm90k::launch<128, 128>);
}
