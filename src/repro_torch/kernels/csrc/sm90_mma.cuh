// Hopper (sm_90a) building blocks of the bf16 attention kernels:
//  * warpgroup matrix multiply-accumulate (wgmma.mma_async m64nNk16, bf16
//    operands, fp32 accumulators): A from shared memory at N = 64 (ss), A
//    from registers at N = 32, 64, 80 and 128 (rs); its fence, commit and
//    wait;
//  * the shared-memory matrix descriptor of the one tile layout below;
//  * the map from an accumulator register to its (row, column) of the
//    64-row tile, and the conversion of an fp32 accumulator into the bf16
//    A operand of the next product;
//  * asynchronous 16-byte copies (cp.async) that fill a tile, with zeros
//    for rows past the end of the matrix.
//
// Tile layout.  A tile of R rows by C bf16 columns (both multiples of 8)
// is stored as 8 x 8 core matrices, each 8 rows of 16 bytes in 128
// contiguous bytes, without swizzle ("interleave" in the PTX manual's
// words), core matrices along a row next to each other:
//   element (r, c) at (r / 8) * 8C + (c / 8) * 64 + (r % 8) * 8 + c % 8.
// Any C that is a multiple of 8 tiles this way (head dim 80 included,
// which the 64-element box of the 128-byte swizzle does not).  wgmma reads
// such a tile in either orientation:
//  * K-major, the tile's columns being the product's K (Q or K in
//    Q K^T): the leading byte offset is the step to the next core matrix
//    along K, 128 bytes; the stride byte offset the step to the next 8
//    rows, 16C bytes.  K step kk (16 columns) starts 256 kk bytes on;
//  * MN-major, the tile's rows being the product's K (V in P V): the
//    leading byte offset is the step to the next 8 rows (along K), 16C
//    bytes; the stride byte offset the step to the next 8 columns (along
//    N), 128 bytes; the transpose flag of B is set.  K step kk (16 rows)
//    starts 32C kk bytes on.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace repro {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int WARPGROUP = 128;

// offset in elements of (r, c) in a tile of C columns
template <int C>
__device__ __forceinline__ int tile_offset(int r, int c) {
  return (r >> 3) * (8 * C) + (c >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// descriptor of a C-column tile read K-major, and its K step in
// descriptor units (16 bytes)
template <int C>
__device__ __forceinline__ uint64_t desc_k_major(const bf16* tile) {
  return make_desc(tile, 128, 16 * C);
}
constexpr uint64_t K_MAJOR_STEP = 256 >> 4;

// descriptor of a C-column tile read MN-major, and its K step
template <int C>
__device__ __forceinline__ uint64_t desc_mn_major(const bf16* tile) {
  return make_desc(tile, 16 * C, 128);
}
template <int C>
constexpr uint64_t MN_MAJOR_STEP = (32 * C) >> 4;

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie registers to this point of the instruction stream: after wait(),
// so that no read of an accumulator moves above the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The (row, column) in the 64-row tile of accumulator register i of this
// thread: warp w of the warpgroup owns rows 16w .. 16w + 15; a thread
// holds rows lane / 4 and lane / 4 + 8 of them, in column pairs
// 2 (lane % 4) + 8j, + 1.
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x % WARPGROUP;
  return (t / 32) * 16 + (t % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 A operands of the K steps of a product whose A is an m64nN fp32
// accumulator (N = 2R): the accumulator's layout is that of the A
// fragment, 16 columns a step.
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R],
                                         uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [r0, r0 + R) of the C-column slice at src of a
// matrix with `rows` rows and a row stride of rs elements into a tile;
// rows at or past `rows` become zeros.  The NT threads of the CTA share
// the copies; eight consecutive threads fill one core matrix (128
// contiguous bytes of shared memory) from 8 rows.  A tile of 64n rows is n
// tiles of 64 rows one after the other.
template <int R, int C, int NT>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long long rs, int r0, int rows) {
  constexpr int NC = C / 8;
  for (int i = threadIdx.x; i < R * NC; i += NT) {
    const int g = i >> 3;
    const int r = (g / NC) * 8 + (i & 7), c = (g % NC) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(tile + tile_offset<C>(r, c),
               src + (ok ? (long long)(r0 + r) * rs : 0) + c, ok);
  }
}

// Warpgroup products m64nNk16, D (+)= A B, bf16 in, fp32 accumulators,
// for the N the kernels use: ss reads A (64 x 16, K-major) and B (K-major)
// through descriptors, at N = 64 (the scores, a 64-row tile wide); rs
// takes A from four registers of each thread (acc_to_a) and reads B
// MN-major (its transpose flag set), at N = the head dim.  accumulate = 0
// overwrites D.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<80> {
  __device__ __forceinline__ static void rs(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

}  // namespace sm90
}  // namespace repro
