// Grouped-query decode attention (one new token per sequence) for Hopper
// (sm_90a), split over the cache's positions (flash-decoding).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas TPU kernel _dec_kernel).  Same function: q (B,1,H,hd) against a
// (B,T,KV,hd) cache, attending kpos in [max(0, len - window), len) for
// len = lengths[b]; optional tanh soft-cap; the G = H/KV query heads of one
// KV head share each loaded key and value; fp32 online softmax;
// out = acc / max(l, 1e-30) in the input dtype.  A sequence with
// lengths[b] == 0 gets 0, as _dec_kernel gives it; the oracle
// (kernels/ref.py) gives the mean of V there.  The model never passes a
// length of 0 to the whole cache; a shard of a cache split over its
// sequence (kernels/sharded.py) gets such rows where its positions lie
// past a sequence's length or before its window.  With a non-null lse the
// kernel also writes each (batch, head) row's fp32 log-sum-exp m + log l,
// and -inf for a row with no live key, so that merging the shards'
// outputs by their log-sum-exps gives that shard weight 0.
//
// What bounds it on the H100: the bytes of the cache.  Each cached key and
// value is read once and used for 4*G FLOPs per element pair, about
// G FLOP per byte in bf16, far below the ~295 FLOP/byte ridge; the least
// time is the live cache (sum of lengths x KV x hd x 2 tensors) over
// 3.35 TB/s.
//
// What the design does about it:
//  * Grid (n_split, KV, B).  A (B, KV) = (8, 8) grid alone filled 64 of
//    the card's 132 SMs; the host splits the allocated T into n_split
//    equal ranges (kernels/decode_attention.py::n_splits picks it from
//    B*KV and T alone, never from the lengths, which are on the device, so
//    the launch needs no sync): CTAs to fill every SM's 2048 threads, each
//    range at least 256 positions.
//  * Each CTA still holds all G query rows of its KV head, so every key and
//    value is read from device memory once.  It reads its own length (this
//    replaces the TPU's scalar prefetch) and streams only the live
//    positions of its range, [max(0, len - window), len) clipped to it.
//  * Its 8 warps stream disjoint 32-position chunks with independent
//    online-softmax state and merge (m, l, acc) through shared memory at
//    the end, which keeps 8 chunks of loads in flight per CTA.
//  * With one split the CTA writes the output.  With more, each writes its
//    fp32 partial (m, l, acc) to a scratch buffer and a second small
//    kernel merges the partials of each (batch, head) in split order, so
//    the result is bit-equal from call to call; no CTA waits on another.
//    Whichever writes the output writes the log-sum-exp beside it when it
//    is asked for: a null test at run time, no template axis, so the
//    instances and the build stay as they were.
//    A split with no live key (past len, or before len - window) leaves
//    m = -inf, l = 0, acc = 0, and the merge gives it weight 0 without
//    forming exp(-inf - (-inf)).
//  * Products stay on the CUDA cores in fp32: at G <= 16 query rows the
//    tensor cores' 64-row tiles would be mostly padding, and the bytes
//    bound the kernel, not the operations.
//  * Head dims 32, 64, 80, 128 and 256; G = 1, 2, 4, 6, 7, 8 and 16.  Keys
//    are read at the true head dim in 16-byte vectors (an 80-dim bf16 row
//    is ten), a lane a position.  In the PV product a lane reads a vector
//    of one value row, so a warp reads whole rows at once (three rows of
//    ten lanes at hd 80 bf16); the row groups' sums meet by shuffles at
//    the end.  At G = 16 the vectors are halved to keep the accumulators
//    in registers.  A row wider than 32 vectors (hd 256 in fp32, or at
//    G = 16) is covered by each lane taking CPL vectors 32 vectors apart.
//    A lane then holds G * hd / 32 accumulators; the pairs where that
//    passes 64, (256, 16) alone, are not built (PvLayout::BUILT, the one
//    statement of the rule), and the wrapper
//    (kernels/decode_attention.py::instantiated) refuses them; the
//    exported decode_attention_built lets a test hold the two together.
//    Shared memory comes to 72 KB at (256, 7) and 81 KB at (256, 8): two
//    CTAs an SM by shared memory, one by registers where a thread needs
//    more than 128 (bf16: 182 at (256, 7), 140 at (256, 8) and (128, 7);
//    -Xptxas -v on the card).
//  * The 68 instances build as 10 translation units, one for each (dtype,
//    head dim) (csrc/decode_attention_hd.cu), beside this file's entry
//    points; kernels/build.py compiles them all at once and links them
//    into the one library.  PvLayout::BUILT stays one statement
//    (csrc/decode_attention.cuh), and so does the switch over G that
//    instantiates only built pairs (launch_g in decode_attention_hd.cu):
//    decode_attention_built runs that switch without a launch.

#include "decode_attention.cuh"

using namespace repro;
using namespace repro::decode;

namespace {

template <typename T>
cudaError_t launch_hd(int HD, int G, const Args& a) {
  switch (HD) {
    case 32: return launch_g<T, 32>(G, a);
    case 64: return launch_g<T, 64>(G, a);
    case 80: return launch_g<T, 80>(G, a);
    case 128: return launch_g<T, 128>(G, a);
    case 256: return launch_g<T, 256>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  The caller has
// checked shapes, dtypes, contiguity and 16-byte alignment; lengths is an
// int32 device array of B entries; with n_split > 1, part is fp32 scratch
// of n_split * B * H * (HD + 2) floats (null with one split); lse is null
// or a (B, H) fp32 array for the rows' log-sum-exps.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, void* part, void* lse,
                                    int dtype, int B, int T_len, int H,
                                    int KV, int HD, int window, float scale,
                                    float softcap, int n_split,
                                    void* stream) {
  if (KV < 1 || H % KV || n_split < 1 || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(lengths), o,
               static_cast<float*>(part), static_cast<float*>(lse), B,
               T_len, KV, window, n_split, scale, softcap,
               static_cast<cudaStream_t>(stream)};
  if (dtype == DTYPE_F32) return (int)launch_hd<float>(HD, H / KV, a);
  if (dtype == DTYPE_BF16)
    return (int)launch_hd<__nv_bfloat16>(HD, H / KV, a);
  return (int)cudaErrorInvalidValue;
}

// 1 where decode_attention_fwd launches (dtype, HD, G = H / KV), else 0:
// the launch switch itself, run without a launch.
extern "C" int decode_attention_built(int dtype, int HD, int G) {
  Args a{};
  a.dry = true;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == DTYPE_F32) e = launch_hd<float>(HD, G, a);
  if (dtype == DTYPE_BF16) e = launch_hd<__nv_bfloat16>(HD, G, a);
  return e == cudaSuccess ? 1 : 0;
}
