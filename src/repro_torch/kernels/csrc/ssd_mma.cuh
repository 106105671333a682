// Tensor-core helpers shared by the bf16 SSD scan (csrc/ssd_scan.cu) and its
// backward (csrc/ssd_scan_bwd.cu): the hi/lo split that stands for an fp32
// operand in two bf16 products, and the swizzled tiles of a state that the
// two state passes write in that split form.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_mma.cuh"

namespace ssd_mma {

namespace fm = flash_mma;

// Rounds the fp32 pair (a, b) to bf16 twice: hi = bf16(v), lo = bf16(v - hi).
// hi + lo carries ~16 bits of v's mantissa, so two bf16 products (hi, lo)
// into one fp32 accumulator stand for one product with the fp32 operand.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The hi and lo A fragments of k step kk from the accumulator n-tiles
// (2kk, 2kk + 1), as fm::c_to_a forms one.
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// A [P, N] state as a state pass writes it (row r's 8-entry group k: 16
// bytes of hi, then 16 bytes of lo) into the swizzled [PP][NP] tiles hi and
// lo (P and N padded to whole 64-column blocks), zero past P and N, by
// 16-byte cp.async from all the block's threads; the caller commits.
template <int P, int N>
__device__ __forceinline__ void load_state_split(fm::bf16* hi, fm::bf16* lo,
                                                 const float* state) {
  constexpr int PP = P < 64 ? 64 : P, NP = N < 64 ? 64 : N, CH = NP / 8;
  using ST = fm::Tile<PP, NP>;
  const char* src = reinterpret_cast<const char*>(state);
  for (int i = threadIdx.x; i < PP * CH; i += blockDim.x) {
    const int r = i / CH, k = i % CH;
    const bool ok = r < P && k < N / 8;
    const char* a =
        src + (ok ? (static_cast<int64_t>(r) * N + 8 * k) * 4 : 0);
    fm::cp_async16(hi + ST::at(r, k), a, ok);
    fm::cp_async16(lo + ST::at(r, k), a + 16, ok);
  }
}

}  // namespace ssd_mma
