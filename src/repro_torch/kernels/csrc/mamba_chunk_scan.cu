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
// cores.  This first kernel runs the products as fp32 FMAs on the CUDA
// cores, which puts it far above that bound.
//
// What this first design does about it:
//  * The TPU kernel runs the chunk axis as a sequential grid axis and
//    carries the state in VMEM scratch.  Blocks on the H100 run in no
//    order, so one CTA owns one (head, batch) and loops over its chunks
//    itself, with the (HD, NS) fp32 state resident in shared memory for
//    the whole sequence: the state never goes to device memory between
//    chunks.
//  * Chunk length Q = 64 (the function does not depend on it), so one
//    chunk's x, B, C, the (Q, Q) score tile and the state fit in shared
//    memory: 83 KB at HD = NS = 64, at most 182 KB at HD = NS = 128.
//  * The four products of a chunk (C B^T, W x, C H^T, (decay x)^T B) run
//    as 64 x 64 output tiles over 256 threads, each thread a 4 x 4
//    register tile (8 shared loads per 16 FMAs).  Row strides of NS + 1
//    and Q + 1 floats keep the strided operand reads free of bank
//    conflicts.
//  * The running sum F is a warp scan (shuffles) over the chunk.
//  * Ragged S: the last chunk is padded in shared memory with dt = 0,
//    x = B = C = 0, which leaves the state untouched (decay exp(0) = 1, no
//    input), as apply_mamba2's zero padding does; padded rows are never
//    stored.
//  * The grid is (NH, B): 80 CTAs at B = 1, fewer than the 132 SMs.
//    Splitting the sequence across CTAs (a state-passing second pass) and
//    tensor-core products are later work.

#include "common.cuh"

using namespace repro;

namespace {

constexpr int Q = 64;              // chunk length
constexpr int THREADS = 256;       // 16 x 16; each owns a 4 x 4 tile
constexpr int TM = 4;              // rows (and cols) of a thread's tile
constexpr int TILE = 16 * TM;      // 64 x 64 output tile per pass
constexpr int MAX_DIM = 128;       // largest HD and NS taken

size_t smem_floats(int HD, int NS) {
  // sH[HD][NS+1], sX[Q][HD], sB/sC[Q][NS+1], sW[Q][Q+1], sDt/sF/sDec/sEf[Q]
  return (size_t)HD * (NS + 1) + (size_t)Q * HD + 2 * (size_t)Q * (NS + 1) +
         (size_t)Q * (Q + 1) + 4 * Q;
}

// acc[i][j] += sum_k A(m_i, k) * Bm(k, n_j) over k < K, for this thread's
// rows m_i = m0 + ty + 16 i and cols n_j = n0 + tx + 16 j, where
// A(m, k) = A[m * am + k * ak] and Bm(k, n) = Bm[k * bk + n * bn].  Rows
// >= M and cols >= N are clamped: computed, never stored by the caller.
__device__ __forceinline__ void tile_mma(float (&acc)[TM][TM],
                                         const float* A, int am, int ak,
                                         const float* Bm, int bk, int bn,
                                         int K, int m0, int n0, int M,
                                         int N, int ty, int tx) {
  int ar[TM], bc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    ar[i] = min(m0 + ty + 16 * i, M - 1) * am;
    bc[i] = min(n0 + tx + 16 * i, N - 1) * bn;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      av[i] = A[ar[i] + k * ak];
      bv[i] = Bm[k * bk + bc[i]];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
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
// checked shapes, dtypes and contiguity; h0 may be null (zero state).
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
  if (dtype == DTYPE_BF16)
    return (int)launch<__nv_bfloat16>(x, dt, a, b, c, d, h0, y, hf, B, S, NH,
                                      HD, NS, st);
  return (int)cudaErrorInvalidValue;
}
