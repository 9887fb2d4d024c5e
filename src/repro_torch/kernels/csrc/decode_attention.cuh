// What the decode library's translation units share: the P V layout and
// its BUILT rule, the launch arguments and the declaration of the launch
// switch over G.
// csrc/decode_attention.cu holds the C entry points and the switch over
// the head dim; csrc/decode_attention_hd.cu holds the kernels, compiled
// once for each (dtype, head dim) (kernels/build.py::UNITS), so that the
// library's instances build in parallel.
#pragma once

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;

// The P V layout of (T, HD, G): a lane loads PV consecutive value dims of
// one row, CPL times, LPR vectors apart; LPR lanes cover a row, and a warp
// RPW rows at once (lanes past RPW * LPR idle); NA accumulators a lane a
// query row.  BUILT: the layout covers the row and a lane's G * NA
// accumulators fit 64 registers; the kernel asserts it and the launch
// switch instantiates only such pairs.
template <typename T, int HD, int G>
struct PvLayout {
  static constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte load
  static constexpr int PV = VEC * G <= 64 ? VEC : 64 / G;
  static constexpr int LPR = HD / PV < 32 ? HD / PV : 32;
  static constexpr int CPL = HD / (PV * LPR), RPW = 32 / LPR;
  static constexpr int NA = CPL * PV;
  static constexpr bool BUILT = CPL * PV * LPR == HD && G * NA <= 64;
};

// Arguments of the launchers.
struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* o;
  float* part;  // n_split > 1: pm, pl, pacc one after the other
  float* lse;   // null, or (B, H): m + log l, -inf for a row with no live key
  int B, T_len, KV, window, n_split;
  float scale, softcap;
  cudaStream_t stream;
  bool dry = false;  // only report whether the pair is built; launch nothing
};

// Launch decode for (T, HD) at G = H / KV, or with a.dry only report
// whether the pair is built (cudaErrorInvalidValue if not).  Defined in
// csrc/decode_attention_hd.cu, one instance in each (dtype, head dim) unit.
template <typename T, int HD>
cudaError_t launch_g(int G, const Args& a);

}  // namespace decode
}  // namespace repro
