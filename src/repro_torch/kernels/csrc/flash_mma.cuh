// Tensor-core building blocks shared by the bf16 flash-attention kernels
// (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu): bf16 tiles in
// 128-byte swizzled shared memory filled by 16-byte cp.async, wgmma
// descriptors and products, the tile-skipping and masking rules, and the
// epilogue that stores a warp's 16 rows through shared memory in 16-byte
// stores.  Raw PTX in inline asm, so nvcc builds a source in seconds.
//
// A warpgroup (four warps) multiplies 64 rows; warp w of it holds rows
// 16w .. 16w+15 of a register operand A and of the fp32 result D in the
// mma.m16n8k16 fragment layouts (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), lane = 4g + t:
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                           a3 (g+8, 2t+8..)
//   D (16 x 8 per n-tile)   d0, d1 (g, 2t..2t+1)  d2, d3 (g+8, 2t..2t+1)
// Two D tiles side by side (n 0..15) are, rounded to bf16 pairs, the A
// fragment of a 16 x 16 block, so P and dS feed the next product from
// registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;  // masked logit, as in the TPU kernel

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled where !valid (the
// source address must still be a valid one).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two floats rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of columns 16kk .. 16kk+15 from two D tiles (2kk, 2kk+1).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Sum (max) over the four lanes of a quad, which share a fragment row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ------------------------------------------------------- swizzled tiles

// head_dim as the tiles hold it: 16 is zero-padded to one 64-column block.
constexpr int tile_hd(int hd) { return hd < 64 ? 64 : hd; }

// A [ROWS][HD] bf16 tile (HD a multiple of 64): rows of HD / 8 chunks of 16
// bytes, cut into blocks of 64 columns stored one after the other, each
// [ROWS][8 chunks] with chunk c of row r at c ^ (r & 7): the 128-byte
// swizzle wgmma reads (rows of 128 bytes, 1024-byte atoms of 8 rows).
template <int ROWS, int HD>
struct Tile {
  static_assert(HD % 64 == 0, "whole 64-column blocks");
  // Element offset of chunk `chunk` of row `row`.
  __device__ __forceinline__ static int at(int row, int chunk) {
    return ((chunk / 8) * ROWS + row) * 64 + ((chunk % 8) ^ (row & 7)) * 8;
  }
};

// Rows [row0, row0 + ROWS) of one head, `stride` elements apart, into a
// swizzled [ROWS][HDP] tile: the HD columns from global memory, rows at or
// past n_rows and columns at or past HD zero-filled.  Issued by all THREADS
// threads; the caller commits the group.
template <int ROWS, int HD, int THREADS, int HDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t stride, int row0,
                                          int n_rows) {
  constexpr int CH = HDP / 8;
#pragma unroll
  for (int n = 0; n < (ROWS * CH + THREADS - 1) / THREADS; ++n) {
    const int i = n * THREADS + threadIdx.x;
    if (ROWS * CH % THREADS != 0 && i >= ROWS * CH) break;
    const int r = i / CH, c = i % CH;
    const int row = row0 + r;
    const bool ok = row < n_rows && c < HD / 8;
    cp_async16(dst + Tile<ROWS, HDP>::at(r, c),
               src + (ok ? static_cast<int64_t>(row) * stride + c * 8 : 0),
               ok);
  }
}

// A warp's 16 x HDP fp32 accumulator, rows g and g+8 scaled by s0 and s1,
// rounded once to bf16 and written to rows r0 .. r0+15 of a swizzled
// [ROWS][HDP] tile the warp owns; then their first HD columns are copied to
// global rows grow0 .. (those below n_rows) in 16-byte stores.
template <int ROWS, int HD, int HDP>
__device__ __forceinline__ void store_rows(bf16* tile, int r0,
                                           const float (&acc)[HDP / 8][4],
                                           float s0, float s1, bf16* dst,
                                           int64_t stride, int grow0,
                                           int n_rows, int lane) {
  using T = Tile<ROWS, HDP>;
  constexpr int CH = HD / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + T::at(r0 + g, j) + 2 * t) =
        pack_bf16(acc[j][0] * s0, acc[j][1] * s0);
    *reinterpret_cast<uint32_t*>(tile + T::at(r0 + g + 8, j) + 2 * t) =
        pack_bf16(acc[j][2] * s1, acc[j][3] * s1);
  }
  __syncwarp();
  static_assert(16 * CH % 32 == 0, "whole 16-byte chunks per lane");
#pragma unroll
  for (int n = 0; n < 16 * CH / 32; ++n) {
    const int i = n * 32 + lane;
    const int r = i / CH, c = i % CH;
    if (grow0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(grow0 + r) * stride +
                                c * 8) =
          *reinterpret_cast<const uint4*>(tile + T::at(r0 + r, c));
  }
}

// ------------------------------------------------------------------ wgmma
//
// Warpgroup products (D as N / 8 tiles of the layout above).  Operands in
// shared memory are read through a matrix descriptor of a Tile:
//   K-major (the reduction index along the row, as Q and K for Q K^T): a
//     k step of 16 columns moves the start address 32 bytes along the row
//     (64-column block kk / 4); rows come in 8-row atoms SBO = 1024 bytes
//     apart.
//   MN-major (the reduction index down the rows, as V for P V, read
//     transposed): a k step of 16 rows moves the start 2048 bytes; the
//     64-column blocks are LBO = rows * 128 bytes apart, 8-row atoms SBO =
//     1024 bytes apart.
// Shared memory written by cp.async must be made visible to wgmma's
// asynchronous proxy (fence_async_smem) before the barrier that publishes
// it.  A wgmma issues asynchronously: its accumulator and A registers must
// not be touched until wgmma_wait, and fence_operand pins them in place
// around it (the compiler would otherwise move their uses across the wait).

__device__ __forceinline__ uint64_t desc_sw128(const bf16* p, int lbo_bytes,
                                               int sbo_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
}

// Descriptor of the K-major operand of k step kk in a [ROWS][*] Tile: the
// 64 rows from r0 (A) or all ROWS rows (B, r0 = 0).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int r0, int kk) {
  return desc_sw128(tile + ((kk / 4) * ROWS + r0) * 64 + (kk % 4) * 16, 16,
                    1024);
}

// Descriptor of the MN-major operand of k step kk (rows 16kk .. 16kk+15)
// in a [ROWS][*] Tile.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return desc_sw128(tile + kk * 16 * 64, ROWS * 128, 1024);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e])::"memory");
}

// d (+)= A B, m64nNk16, A and B K-major in shared memory; accumulate = 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a,
                                         uint64_t b, int accumulate);
// d (+)= A B, m64nNk16, A from registers, B MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[16][4], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// ------------------------------------------------------------- masking
//
// Query row i (0 <= i < Sq) sits at key position i + off, off = Sk - Sq
// (queries right-aligned).  Pair (i, j) is live iff i < Sq, j < Sk, and
// j <= i + off when causal, j > i + off - window when windowed.  The tile
// walks below are mirrored by kernels/flash_attention.py (key_tiles,
// query_tiles, tile_needs_mask), which the CPU tests check against that
// definition.

struct Mask {
  int Sq, Sk, causal, window;
  __device__ __forceinline__ bool live(int i, int j) const {
    const int pos = i + Sk - Sq;
    return i < Sq && j < Sk && (!causal || j <= pos) &&
           (!window || j > pos - window);
  }
  // Whether some pair of query rows [q0, q0 + bq) x keys [k0, k0 + bk) is
  // not live (so the tile needs the per-element predicate).
  __device__ __forceinline__ bool needs_mask(int q0, int bq, int k0,
                                             int bk) const {
    const int off = Sk - Sq;
    const int q_last = min(q0 + bq, Sq) - 1;
    return k0 + bk > Sk || q0 + bq > Sq || (causal && k0 + bk - 1 > q0 + off) ||
           (window && k0 <= q_last + off - window);
  }
  // Key tiles of size bk holding a live key of query rows [q0, q0 + bq):
  // [*lo, *end).
  __device__ __forceinline__ void key_tiles(int q0, int bq, int bk, int* lo,
                                            int* end) const {
    const int off = Sk - Sq;
    const int q_last = min(q0 + bq, Sq) - 1;
    const int k_lo = window ? max(0, q0 + off - window + 1) : 0;
    const int k_hi = causal ? min(Sk - 1, q_last + off) : Sk - 1;
    *lo = k_lo / bk;
    *end = k_hi >= k_lo ? k_hi / bk + 1 : *lo;
  }
  // Query tiles of size bq holding a row that sees a key of [k0, k0 + bk):
  // [*lo, *end).
  __device__ __forceinline__ void query_tiles(int k0, int bk, int bq, int* lo,
                                              int* end) const {
    const int off = Sk - Sq;
    const int k_last = min(k0 + bk, Sk) - 1;
    const int q_lo = causal ? max(0, k0 - off) : 0;
    const int q_hi = window ? min(Sq - 1, k_last - off + window - 1) : Sq - 1;
    *lo = q_lo / bq;
    *end = q_hi >= q_lo ? q_hi / bq + 1 : *lo;
  }
};

}  // namespace flash_mma
