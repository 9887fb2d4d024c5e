// 64 x 64 output tiles of a product in fp32 on the CUDA cores, for 256
// threads laid out 16 x 16 (tx = tid % 16, ty = tid / 16), each owning a
// 4 x 4 register tile.  Shared by the SSD kernels' CUDA-core paths.
#pragma once

namespace repro {
namespace tiles {

constexpr int THREADS = 256;  // 16 x 16
constexpr int TM = 4;         // rows (and cols) of a thread's tile
constexpr int TILE = 16 * TM;  // 64 x 64 output tile per pass

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

}  // namespace tiles
}  // namespace repro
