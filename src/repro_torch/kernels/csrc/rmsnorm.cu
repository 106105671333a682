// RMSNorm forward and backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (rmsnorm /
// _rmsnorm_kernel): per row of x [rows, D],
//   y = x * rsqrt(mean(x^2) + eps) * scale
// in fp32, y in x's dtype.  The backward has no TPU counterpart (JAX
// differentiates the jnp norm); it is the backward of the port's
// autograd.Function (kernels/ops.py).  With g the upstream gradient and
// x^ = x * rstd it writes
//   dx = rstd * (g*s - x^ * mean(g*s*x^))   in x's dtype,
//   dscale = sum over rows of g * x^        in scale's dtype.
// x, dy and dx are float32, bfloat16 or float16 (one dtype); the scale any of
// the three, read and written through a runtime dtype code; 1 <= D <= 16384.
//
// Bound.  Both directions read each input row once and write each output row
// once, a few operations per element: the memory rate bounds them (the
// qwen2-7b train shape [8192, 3584] bf16 backward moves 176 MB, 53 us at
// 3.35 TB/s).  A decode call ([4, 1, D]) moves a few KB, so one launch and
// one round trip to device memory bound it.
//
// Forward, one pass, the row in registers.  bfloat16 and float16 rows are
// laid out by D and the rows:
//   a warp a row (D <= 2048 and at least NARROW_MIN_ROWS rows): FWD_WARPS
//     rows a block, 16-byte loads and stores, a warp-shuffle sum with no
//     __syncthreads;
//   a block a row (wider rows, or a few rows as decode gives): its threads
//     sized to D's 16-byte vectors, not the next power of two (224 threads
//     of two vectors at D 3584 bf16, 128 of eight at D 7168), a
//     shuffle-then-shared-memory sum, so a decode row spreads its loads.
// Aligned rows of one dtype (FAST) keep x and the scale in registers as the
// 16-byte vectors they were loaded as, half the registers of fp32, so more
// rows are in flight a SM; the scale is loaded with x, before the sum, so a
// row costs one round trip to memory.  float32 rows, at every D, go a block
// a row in the replaced Triton kernel's order of operations
// (rmsnorm_fwd_f32_kernel, below).
//
// Backward, persistent and pipelined.  A grid of one or two blocks a SM
// deals the rows by a fixed stride to "teams": a warp a row for D <= 2048
// (BWD_WARPS teams a block, the scale in fp32 shared memory), the whole
// block for wider rows (the scale's columns in registers).  Each team keeps
// a ring of stages in shared memory, each stage one row of x and one of dy;
// one thread of the team fills a stage with two 1-D bulk asynchronous copies
// (cp.async.bulk, the TMA's non-tensor form) that complete on the stage's
// mbarrier, while the team computes on the row before.  The stage counts
// (two for a warp, up to three for a block, two blocks a SM) are the
// fastest of those measured on an H100 (PERF.md): a SM holds 32 stages at
// D <= 1024 bf16, 16 at D 2048 and six of a block's rows at D 3584 and
// 7168.  Per row: one pass over the stage sums x^2 and g*s*x (one two-value
// team sum), a second writes dx with 16-byte stores and adds g*x^ to the
// thread's fp32 partials of dscale.  At
// the end each block folds its teams' partials, in team order, into one
// fp32 row of the caller's [blocks, D] scratch, and rmsnorm_dscale_kernel,
// launched as the backward's programmatic dependent (its launch overlaps
// the backward's tail), sums those rows per column in a fixed order
// (DSCALE_GROUPS strided groups, then the groups in order).  No atomics:
// two calls give bit-equal results.
//
// Rows whose base or width is not a multiple of 16 bytes take a plain-load
// path in the same kernels: the forward loads and stores element by
// element; the backward's team copies each row into a one-stage ring with
// plain loads.  Nothing falls back to the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int MAX_D = 16384;
constexpr int NARROW_MAX_D = 2048;      // a warp a row up to here
constexpr int NARROW_MIN_ROWS = 512;    // forward: fewer rows go a block a row
constexpr int FWD_WARPS = 4;            // forward, a warp a row: rows a block
constexpr int FWD_THREADS = 512;        // forward, a block a row: most threads
constexpr int FWD_WIDE_THREADS = 256;   // ... at 8 or more vectors a thread
constexpr int FWD_F32_THREADS = 1024;   // forward, float32: most threads a row
constexpr int F32_COLS = MAX_D / FWD_F32_THREADS;  // ... and columns a thread
constexpr int BWD_THREADS = 512;        // backward, a block a row: most threads
constexpr int BWD_WARPS = 8;            // backward, a warp a row: teams a block
constexpr int BWD_WARP_STAGES = 2;      // stages of a warp team's ring
constexpr int BWD_BLOCK_STAGES = 3;     // most stages of a block team's ring
constexpr int BWD_CTAS_PER_SM = 2;      // most backward blocks a SM
constexpr int SMEM_BUDGET = 192 * 1024; // dynamic shared memory a SM
constexpr int DSCALE_COLS = 16;
constexpr int DSCALE_GROUPS = 32;

enum : int { F32 = 0, BF16 = 1, F16 = 2 };

// A forward row's block keeps NV vectors of x and of the scale a thread in
// registers; at eight or more it takes at most 256 threads, so a thread may
// hold them all without spilling.
constexpr int fwd_block_threads(int nv) {
  return nv >= 8 ? FWD_WIDE_THREADS : FWD_THREADS;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

template <typename T>
constexpr int dtype_code() {
  return std::is_same<T, float>::value           ? F32
         : std::is_same<T, __nv_bfloat16>::value ? BF16
                                                 : F16;
}

__device__ __forceinline__ float load_any(const void* p, int dt, int i) {
  switch (dt) {
    case F32: return static_cast<const float*>(p)[i];
    case BF16: return to_f(static_cast<const __nv_bfloat16*>(p)[i]);
    default: return to_f(static_cast<const __half*>(p)[i]);
  }
}

__device__ __forceinline__ void store_any(void* p, int dt, int i, float v) {
  switch (dt) {
    case F32: static_cast<float*>(p)[i] = v; break;
    case BF16: static_cast<__nv_bfloat16*>(p)[i] = from_f<__nv_bfloat16>(v);
      break;
    default: static_cast<__half*>(p)[i] = from_f<__half>(v);
  }
}

// V = 16 / sizeof(T) elements: one 16-byte vector.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_f<T>(f[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Columns [col, col + V) of a row in device memory: one 16-byte load where
// the rows are aligned (vec), else element by element, 0 past D.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* row, int col, int D,
                                         bool vec, float (&f)[V]) {
  if (vec) {
    load_vec<T, V>(row + col, f);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      f[e] = col + e < D ? to_f(row[col + e]) : 0.f;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(T* row, int col, int D, bool vec,
                                          const float (&f)[V]) {
  if (vec) {
    store_vec<T, V>(row + col, f);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (col + e < D) row[col + e] = from_f<T>(f[e]);
  }
}

// The scale's columns [col, col + V): a 16-byte load where it is aligned and
// of x's dtype (svec), else element by element in its own dtype.
template <typename T, int V>
__device__ __forceinline__ void load_scale(const void* s, int sdt, int col,
                                           int D, bool svec,
                                           float (&f)[V]) {
  if (svec) {
    load_vec<T, V>(static_cast<const T*>(s) + col, f);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      f[e] = col + e < D ? load_any(s, sdt, col + e) : 0.f;
  }
}

// A row staged in shared memory (16-byte aligned): columns past D read 0.
template <typename T, int V>
__device__ __forceinline__ void load_stage(const T* row, int col, int D,
                                           float (&f)[V]) {
  load_vec<T, V>(row + col, f);
  if (col + V > D) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (col + e >= D) f[e] = 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane ends with the same sum.
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of two values over a team (a warp, or with BLOCK the whole block); every
// thread of the team gets the same sums, in the same fixed order.  BLOCK uses
// red[parity * 32 ...]; two calls in a row must alternate the parity.
template <bool BLOCK>
__device__ __forceinline__ float2 team_sum(float2 v, float2* red,
                                           int parity) {
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  if (!BLOCK) return v;
  float2* r = red + parity * 32;
  const int lane = threadIdx.x & 31;
  if (lane == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 s = lane < static_cast<int>(blockDim.x >> 5) ? r[lane]
                                                      : make_float2(0.f, 0.f);
  s.x = warp_sum(s.x);
  s.y = warp_sum(s.y);
  return s;
}

// One value, as team_sum: the forward's sum of squares.
template <bool BLOCK>
__device__ __forceinline__ float team_sum1(float v, float* red) {
  v = warp_sum(v);
  if (!BLOCK) return v;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f);
}

template <bool BLOCK>
__device__ __forceinline__ void team_sync() {
  if (BLOCK) __syncthreads();
  else __syncwarp();
}

// --- mbarriers and bulk copies (PTX) ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of parity `parity` completes; traps (a launch error,
// not a hang) if it has not after ~2^34 cycles (about 9 s).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// bytes (a multiple of 16) from 16-byte aligned global src to 16-byte aligned
// shared dst, completing on bar's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// --- forward ----------------------------------------------------------------

// FAST: x, out and the scale 16-byte aligned, D a multiple of V, the scale
// of x's dtype; the row and its scale stay in registers as loaded (16-byte
// vectors, not fp32), so more rows fit a SM.  Else (flags: 1 = x and out
// aligned, 2 = the scale aligned and of x's dtype) element loads where
// needed, in fp32.  The scale's loads go out with x's, before the sum, so a
// row costs one round trip to memory.
template <typename T, int NV, bool BLOCK, bool FAST>
__global__ void __launch_bounds__(BLOCK ? (NV >= 8 ? FWD_WIDE_THREADS
                                                  : FWD_THREADS)
                                        : 32 * FWD_WARPS)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                       T* __restrict__ out, int64_t rows, int D, int64_t xs,
                       float eps, int sdt, int flags) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[32];
  const int tsize = BLOCK ? static_cast<int>(blockDim.x) : 32;
  const int t = BLOCK ? threadIdx.x : (threadIdx.x & 31);
  const int64_t row =
      BLOCK ? static_cast<int64_t>(blockIdx.x)
            : static_cast<int64_t>(blockIdx.x) * FWD_WARPS + (threadIdx.x >> 5);
  if (!BLOCK && row >= rows) return;  // a whole warp; no block barrier follows
  const int nvec = (D + V - 1) / V;
  const T* xr = x + row * xs;
  T* orow = out + row * D;
  float ss = 0.f;
  if constexpr (FAST) {
    uint4 xq[NV], sq[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * tsize + t;
      if (j < nvec) {
        xq[v] = *reinterpret_cast<const uint4*>(xr + j * V);
        sq[v] = *reinterpret_cast<const uint4*>(static_cast<const T*>(scale) +
                                                 j * V);
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (v * tsize + t < nvec) {
        const T* e = reinterpret_cast<const T*>(&xq[v]);
#pragma unroll
        for (int i = 0; i < V; ++i) ss = fmaf(to_f(e[i]), to_f(e[i]), ss);
      }
    }
    const float tot = team_sum1<BLOCK>(ss, red);
    const float r = rsqrtf(tot / static_cast<float>(D) + eps);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * tsize + t;
      if (j < nvec) {
        const T* e = reinterpret_cast<const T*>(&xq[v]);
        const T* w = reinterpret_cast<const T*>(&sq[v]);
        float y[V];
#pragma unroll
        for (int i = 0; i < V; ++i) y[i] = to_f(e[i]) * r * to_f(w[i]);
        store_vec<T, V>(orow + j * V, y);
      }
    }
  } else {
    const bool vec = flags & 1, svec = flags & 2;
    float xv[NV][V], sv[NV][V];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * tsize + t;
      if (j < nvec) {
        load_row<T, V>(xr, j * V, D, vec, xv[v]);
        load_scale<T, V>(scale, sdt, j * V, D, svec, sv[v]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xv[v][e] = sv[v][e] = 0.f;
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(xv[v][e], xv[v][e], ss);
    const float tot = team_sum1<BLOCK>(ss, red);
    const float r = rsqrtf(tot / static_cast<float>(D) + eps);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * tsize + t;
      if (j < nvec) {
        float y[V];
#pragma unroll
        for (int e = 0; e < V; ++e) y[e] = xv[v][e] * r * sv[v][e];
        store_row<T, V>(orow, j * V, D, vec, y);
      }
    }
  }
}

// float32 rows, every D: one order of operations, that of the Triton kernel
// this source replaced at one column a thread.  A block a row of T threads
// (D's next power of two, at least a warp, at most FWD_F32_THREADS); thread t
// takes columns t, t + T, ... (at most F32_COLS).  Each lane's sum of squares
// (the first square rounded, the others fused) goes to its xor-16 partner,
// which adds its own squares to it, fused; then a butterfly of adds over the
// other lanes, the warps' sums by a butterfly on lane 0's, an approximate
// division by D (div.full), an approximate rsqrt (rsqrt.approx.ftz), and y =
// (rstd * x) * scale.  Where a thread takes one column (D 64 and 128 among
// them) this is the Triton kernel's order bit for bit (read from its PTX).
// float32 keeps that order because the float32 Mamba-2 reference checks
// (chip_smoke.py phase 4, tests/test_torch_cuda.py) sit at the rounding
// noise of this norm's output: the bf16/fp16 kernel's order (above), each
// call as close to the CPU's output, fails them (PERF.md).  Loads are 4 bytes
// wide; the models' bf16 traffic takes rmsnorm_fwd_kernel.
__device__ __forceinline__ float div_full(float a, float b) {
  float q;
  asm("div.full.f32 %0, %1, %2;" : "=f"(q) : "f"(a), "f"(b));
  return q;
}

__device__ __forceinline__ float rsqrt_approx_ftz(float a) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

__global__ void __launch_bounds__(FWD_F32_THREADS)
    rmsnorm_fwd_f32_kernel(const float* __restrict__ x,
                           const void* __restrict__ scale,
                           float* __restrict__ out, int D, int64_t xs,
                           float eps, int sdt) {
  __shared__ float part[FWD_F32_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31;
  const int T = static_cast<int>(blockDim.x), warps = T >> 5;
  const int64_t row = blockIdx.x;
  const float* xr = x + row * xs;
  float xv[F32_COLS];
#pragma unroll
  for (int i = 0; i < F32_COLS; ++i) {
    const int c = t + i * T;
    xv[i] = c < D ? xr[c] : 0.f;
  }
  float p = __fmul_rn(xv[0], xv[0]);
#pragma unroll
  for (int i = 1; i < F32_COLS; ++i) p = fmaf(xv[i], xv[i], p);
  float s = __shfl_xor_sync(0xffffffffu, p, 16);
#pragma unroll
  for (int i = 0; i < F32_COLS; ++i) s = fmaf(xv[i], xv[i], s);
#pragma unroll
  for (int o = 8; o; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) part[t >> 5] = s;
  __syncthreads();
  if (t < 32) {
    float q = lane < warps ? part[lane] : 0.f;
    for (int o = warps >> 1; o; o >>= 1)
      q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, o));
    __syncwarp();
    if (lane == 0) part[0] = q;
  }
  __syncthreads();
  const float r = rsqrt_approx_ftz(
      __fadd_rn(eps, div_full(part[0], static_cast<float>(D))));
  float* orow = out + row * D;
#pragma unroll
  for (int i = 0; i < F32_COLS; ++i) {
    const int c = t + i * T;
    if (c < D)
      orow[c] = __fmul_rn(__fmul_rn(r, xv[i]), load_any(scale, sdt, c));
  }
}

// --- backward ---------------------------------------------------------------

// Dynamic shared memory: teams * stages mbarriers (padded to 128 bytes), for
// warp teams the scale in fp32 (padded to 128 bytes), then each team's ring
// of `stages` stages of 2 * row_bytes (x, then dy).  flags:
// 1 = x, dy and dx rows 16-byte aligned and D a multiple of V (bulk copies
// and vector stores; else one plain-loaded stage); 2 = as the forward's.
template <typename T, int NV, bool BLOCK>
__global__ void __launch_bounds__(BLOCK ? BWD_THREADS : 32 * BWD_WARPS)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const void* __restrict__ scale, T* __restrict__ dx,
                       float* __restrict__ work, int64_t rows, int D,
                       int64_t xs, int64_t dys, float eps, int sdt, int flags,
                       int stages) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float2 red[64];
  const int teams = BLOCK ? 1 : static_cast<int>(blockDim.x >> 5);
  const int team = BLOCK ? 0 : static_cast<int>(threadIdx.x >> 5);
  const int tsize = BLOCK ? static_cast<int>(blockDim.x) : 32;
  const int t = BLOCK ? threadIdx.x : (threadIdx.x & 31);
  const bool vec = flags & 1, svec = flags & 2;
  const int nvec = (D + V - 1) / V;
  const uint32_t row_bytes = (D * sizeof(T) + 15) / 16 * 16;
  const uint32_t stage_bytes = 2 * row_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + team * stages;
  // Warp teams share one fp32 copy of the scale; a block team keeps its
  // columns' in registers.
  float* ssc = reinterpret_cast<float*>(
      smem + (teams * stages * 8 + 127) / 128 * 128);
  unsigned char* ring = reinterpret_cast<unsigned char*>(ssc) +
                        (BLOCK ? 0 : (D * 4 + 127) / 128 * 128);
  unsigned char* mine = ring + static_cast<size_t>(team) * stages * stage_bytes;

  // Team (block b, team w) takes the block's rows b + i * grid, i = w, w +
  // teams, ...: its k-th row is b + (w + k * teams) * grid.
  const int64_t step = static_cast<int64_t>(gridDim.x) * teams;
  const int64_t first = blockIdx.x + static_cast<int64_t>(team) * gridDim.x;
  const int n = first < rows ? static_cast<int>((rows - 1 - first) / step + 1)
                             : 0;
  const bool producer = t == 0;

  // Let the dscale sum's grid be scheduled now; it waits for this grid's
  // end (griddepcontrol.wait) before it reads work.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int i = 0; i < teams * stages; ++i)
      mbar_init(reinterpret_cast<uint64_t*>(smem) + i, 1);
    mbar_fence_init();
  }
  if (!BLOCK) {
    for (int i = threadIdx.x; i < (D + V - 1) / V * V; i += blockDim.x)
      ssc[i] = i < D ? load_any(scale, sdt, i) : 0.f;
  }
  __syncthreads();

  auto fetch = [&](int k) {  // the team's k-th row into stage k % stages
    const int s = k % stages;
    const int64_t r = first + k * step;
    unsigned char* dst = mine + s * stage_bytes;
    const uint32_t bytes = D * sizeof(T);
    mbar_expect_tx(bars + s, 2 * bytes);
    bulk_load(dst, x + r * xs, bytes, bars + s);
    bulk_load(dst + row_bytes, dy + r * dys, bytes, bars + s);
  };
  if (vec && producer)
    for (int k = 0; k < n && k < stages; ++k) fetch(k);

  float sc[BLOCK ? NV : 1][V], part[NV][V];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int j = v * tsize + t;
    if constexpr (BLOCK) {
      if (j < nvec) {
        load_scale<T, V>(scale, sdt, j * V, D, svec, sc[v]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) sc[v][e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) part[v][e] = 0.f;
  }
  // The scale of vector v's columns: registers, or the block's fp32 copy.
  auto scale_of = [&](int v, int j, float (&f)[V]) {
    if constexpr (BLOCK) {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = sc[v][e];
    } else {
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 q = *reinterpret_cast<const float4*>(ssc + j * V + e);
        f[e] = q.x;
        f[e + 1] = q.y;
        f[e + 2] = q.z;
        f[e + 3] = q.w;
      }
    }
  };

  const float inv_d = 1.f / static_cast<float>(D);
  for (int k = 0; k < n; ++k) {
    const int s = k % stages;
    const int64_t r = first + k * step;
    const T* sx = reinterpret_cast<const T*>(mine + s * stage_bytes);
    const T* sg = reinterpret_cast<const T*>(mine + s * stage_bytes +
                                             row_bytes);
    if (vec) {
      mbar_wait(bars + s, (k / stages) & 1);
    } else {
      T* wx = reinterpret_cast<T*>(mine);
      T* wg = reinterpret_cast<T*>(mine + row_bytes);
      team_sync<BLOCK>();  // the previous row's readers are done
      for (int i = t; i < D; i += tsize) {
        wx[i] = x[r * xs + i];
        wg[i] = dy[r * dys + i];
      }
      team_sync<BLOCK>();
    }
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * tsize + t;
      if (j < nvec) {
        float xv[V], gv[V], sv[V];
        load_stage<T, V>(sx, j * V, D, xv);
        load_stage<T, V>(sg, j * V, D, gv);
        scale_of(v, j, sv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss = fmaf(xv[e], xv[e], ss);
          sgx = fmaf(gv[e] * sv[e], xv[e], sgx);
        }
      }
    }
    const float2 tot = team_sum<BLOCK>(make_float2(ss, sgx), red, k & 1);
    // Every thread of the team has read row k - 1's stage (the block's
    // barrier in team_sum, or the warp's here): refill it.  A one-stage ring
    // refills after the row instead (below).
    if (vec && stages > 1 && k > 0 && k - 1 + stages < n) {
      if (!BLOCK) __syncwarp();
      if (producer) fetch(k - 1 + stages);
    }
    const float rstd = rsqrtf(tot.x * inv_d + eps);
    const float c = tot.y * rstd * inv_d;  // mean(g * s * x^)
    T* drow = dx + r * D;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * tsize + t;
      if (j < nvec) {
        float xv[V], gv[V], sv[V], d[V];
        load_stage<T, V>(sx, j * V, D, xv);
        load_stage<T, V>(sg, j * V, D, gv);
        scale_of(v, j, sv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = xv[e] * rstd;
          d[e] = rstd * (gv[e] * sv[e] - xh * c);
          part[v][e] = fmaf(gv[e], xh, part[v][e]);
        }
        store_row<T, V>(drow, j * V, D, vec, d);
      }
    }
    if (vec && stages == 1 && k + 1 < n) {
      team_sync<BLOCK>();
      if (producer) fetch(k + 1);
    }
  }

  // The block's partials into its row of work, teams summed in order.
  float* wrow = work + static_cast<int64_t>(blockIdx.x) * D;
  if (BLOCK) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * tsize + t;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (j < nvec && j * V + e < D) wrow[j * V + e] = part[v][e];
    }
    return;
  }
  __syncthreads();  // every team is done with the ring (all loads waited on)
  float* ps = reinterpret_cast<float*>(ring);  // [teams][D]
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int j = v * tsize + t;
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (j < nvec && j * V + e < D) ps[team * D + j * V + e] = part[v][e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float a = ps[c];
    for (int w = 1; w < teams; ++w) a += ps[w * D + c];
    wrow[c] = a;
  }
}

// dscale[c] = sum over the blocks' rows of work[:, c]: DSCALE_GROUPS groups of
// rows (i = g, g + GROUPS, ...) summed in order, then the groups in order.
__global__ void __launch_bounds__(DSCALE_COLS * DSCALE_GROUPS)
    rmsnorm_dscale_kernel(const float* __restrict__ work, int blocks, int D,
                          void* __restrict__ dscale, int sdt) {
  __shared__ float acc[DSCALE_GROUPS][DSCALE_COLS];
  // Launched as the backward's programmatic dependent: wait for its grid
  // (and its writes to work) here, not at the launch.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int c = threadIdx.x, g = threadIdx.y;
  const int col = blockIdx.x * DSCALE_COLS + c;
  float s = 0.f;
  if (col < D) {
#pragma unroll 8
    for (int i = g; i < blocks; i += DSCALE_GROUPS)
      s += work[static_cast<int64_t>(i) * D + col];
  }
  acc[g][c] = s;
  __syncthreads();
  if (g == 0 && col < D) {
    float t = acc[0][c];
    for (int w = 1; w < DSCALE_GROUPS; ++w) t += acc[w][c];
    store_any(dscale, sdt, col, t);
  }
}

__global__ void rmsnorm_empty_kernel() {}

// --- launchers --------------------------------------------------------------

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// f(std::integral_constant<int, nv>) for nv a power of two up to MAXNV.
template <int MAXNV, typename F>
int with_nv(int nv, F&& f) {
  switch (nv) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2:
      if constexpr (MAXNV >= 2) return f(std::integral_constant<int, 2>{});
      break;
    case 4:
      if constexpr (MAXNV >= 4) return f(std::integral_constant<int, 4>{});
      break;
    case 8:
      if constexpr (MAXNV >= 8) return f(std::integral_constant<int, 8>{});
      break;
    case 16:
      if constexpr (MAXNV >= 16) return f(std::integral_constant<int, 16>{});
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Most 16-byte vectors a thread takes: a lane of a narrow row, or a thread
// of a row's block (forward or backward).
template <typename T, bool BLOCK, bool BWD>
constexpr int max_nv() {
  return (BLOCK ? MAX_D / (BWD ? BWD_THREADS : FWD_WIDE_THREADS)
               : NARROW_MAX_D / 32) /
         static_cast<int>(16 / sizeof(T));
}

// Vectors a thread of a row's block takes (the fewest that keep it within
// `cap` threads), and its threads.
void block_shape(int nvec, int cap, int* nv, int* threads) {
  *nv = 1;
  while ((nvec + *nv - 1) / *nv > cap) *nv *= 2;
  *threads = ((nvec + *nv - 1) / *nv + 31) / 32 * 32;
}

template <typename T, bool BLOCK>
int launch_fwd_kernel(int nv, unsigned grid, int threads, const T* x,
                      const void* scale, int sdt, T* out, int64_t rows, int D,
                      int64_t xs, float eps, int flags, cudaStream_t st) {
  return with_nv<max_nv<T, BLOCK, false>()>(nv, [&](auto nvc) {
    constexpr int NV = decltype(nvc)::value;
    if ((flags & 3) == 3)
      rmsnorm_fwd_kernel<T, NV, BLOCK, true><<<grid, threads, 0, st>>>(
          x, scale, out, rows, D, xs, eps, sdt, flags);
    else
      rmsnorm_fwd_kernel<T, NV, BLOCK, false><<<grid, threads, 0, st>>>(
          x, scale, out, rows, D, xs, eps, sdt, flags);
    return static_cast<int>(cudaGetLastError());
  });
}

// A warp a row where D is narrow and the rows many; else a block a row, so
// that a few rows (decode) still spread their loads over many threads.
template <typename T>
int launch_fwd(const T* x, const void* scale, int sdt, T* out, int64_t rows,
               int D, int64_t xs, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = (D + V - 1) / V;
  const int flags =
      (D % V == 0 && aligned(x) && aligned(out) && xs % V == 0 ? 1 : 0) |
      (sdt == dtype_code<T>() && D % V == 0 && aligned(scale) ? 2 : 0);
  if (D <= NARROW_MAX_D && rows >= NARROW_MIN_ROWS)
    return launch_fwd_kernel<T, false>(
        pow2_at_least((nvec + 31) / 32),
        static_cast<unsigned>((rows + FWD_WARPS - 1) / FWD_WARPS),
        32 * FWD_WARPS, x, scale, sdt, out, rows, D, xs, eps, flags, st);
  // A few rows (decode): as many threads as take one or two vectors, for
  // the shortest round trip.  Many rows: up to 256 threads, and rows of more
  // than 512 vectors on about 128, more vectors a thread (the fastest of
  // those measured at D 3584 and 7168 on an H100).
  int nv, threads;
  block_shape(nvec,
              rows < NARROW_MIN_ROWS ? FWD_THREADS
              : nvec <= 512          ? FWD_WIDE_THREADS
                                     : FWD_WIDE_THREADS / 2,
              &nv, &threads);
  if (nv > max_nv<T, true, false>() ||
      threads > fwd_block_threads(nv))
    block_shape(nvec, FWD_WIDE_THREADS, &nv, &threads);
  return launch_fwd_kernel<T, true>(nv, static_cast<unsigned>(rows), threads,
                                    x, scale, sdt, out, rows, D, xs, eps,
                                    flags, st);
}

// float32: a block a row, of D's next power of two threads within [32,
// FWD_F32_THREADS].
int launch_fwd_f32(const float* x, const void* scale, int sdt, float* out,
                   int64_t rows, int D, int64_t xs, float eps,
                   cudaStream_t st) {
  int threads = pow2_at_least(D);
  threads = threads < 32                ? 32
            : threads > FWD_F32_THREADS ? FWD_F32_THREADS
                                        : threads;
  rmsnorm_fwd_f32_kernel<<<static_cast<unsigned>(rows), threads, 0, st>>>(
      x, scale, out, D, xs, eps, sdt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
struct BwdArgs {
  const T* x;
  const T* dy;
  const void* scale;
  T* dx;
  void* dscale;
  float* work;
  int work_rows;
  int64_t rows;
  int D;
  int64_t xs, dys;
  float eps;
  int sdt, flags, sms;
  int* grid;  // if set: the grid's blocks and teams a block, no launch
};

// The backward kernel with `teams` teams of `threads` threads and `stages`
// stages a team, on as many blocks as fit one or two a SM and the rows ask
// for, then the dscale sum over those blocks' rows of work.
template <typename T, bool BLOCK>
int launch_bwd_kernel(const BwdArgs<T>& a, int nv, int threads, int teams,
                      int stages, int smem, cudaStream_t st) {
  return with_nv<max_nv<T, BLOCK, true>()>(nv, [&](auto nvc) {
    auto kernel = rmsnorm_bwd_kernel<T, decltype(nvc)::value, BLOCK>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (per_sm > BWD_CTAS_PER_SM) per_sm = BWD_CTAS_PER_SM;
    const int64_t need = (a.rows + teams - 1) / teams;
    const int64_t most = static_cast<int64_t>(per_sm) * a.sms;
    const int blocks = static_cast<int>(need < most ? need : most);
    if (blocks > a.work_rows) return static_cast<int>(cudaErrorInvalidValue);
    if (a.grid) {
      a.grid[0] = blocks;
      a.grid[1] = teams;
      return 0;
    }
    kernel<<<blocks, threads, smem, st>>>(a.x, a.dy, a.scale, a.dx, a.work,
                                          a.rows, a.D, a.xs, a.dys, a.eps,
                                          a.sdt, a.flags, stages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((a.D + DSCALE_COLS - 1) / DSCALE_COLS);
    cfg.blockDim = dim3(DSCALE_COLS, DSCALE_GROUPS);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, rmsnorm_dscale_kernel, static_cast<const float*>(a.work),
        blocks, a.D, a.dscale, a.sdt));
  });
}

template <typename T>
int launch_bwd(BwdArgs<T> a, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int D = a.D;
  const int nvec = (D + V - 1) / V;
  const bool vec = D % V == 0 && aligned(a.x) && aligned(a.dy) &&
                   aligned(a.dx) && a.xs % V == 0 && a.dys % V == 0;
  a.flags = (vec ? 1 : 0) |
            (a.sdt == dtype_code<T>() && D % V == 0 && aligned(a.scale) ? 2
                                                                        : 0);
  const int stage = 2 * ((D * static_cast<int>(sizeof(T)) + 15) / 16 * 16);
  if (D > NARROW_MAX_D) {
    // Up to three stages where two blocks fit a SM; else two, one block.
    int nv, threads;
    block_shape(nvec, BWD_THREADS, &nv, &threads);
    int stages = vec ? BWD_BLOCK_STAGES : 1;
    while (stages > 1 && stages * stage > SMEM_BUDGET / 2) --stages;
    if (vec && stages < 2 && 2 * stage <= SMEM_BUDGET) stages = 2;
    const int smem = 128 + stages * stage;
    return launch_bwd_kernel<T, true>(a, nv, threads, 1, stages, smem, st);
  }
  const int stages = vec ? BWD_WARP_STAGES : 1;
  int teams = BWD_WARPS;
  while (teams > 1 && teams * stages * stage + D * 4 > SMEM_BUDGET) --teams;
  const int smem = (teams * stages * 8 + 127) / 128 * 128 +
                   (D * 4 + 127) / 128 * 128 + teams * stages * stage;
  return launch_bwd_kernel<T, false>(a, pow2_at_least((nvec + 31) / 32),
                                     32 * teams, teams, stages, smem, st);
}

template <typename T>
int bwd_as(const void* x, const void* scale, int sdt, const void* dy,
           void* dx, void* dscale, float* work, int work_rows, int64_t rows,
           int D, int64_t xs, int64_t dys, float eps, int sms, int* grid,
           cudaStream_t st) {
  return launch_bwd(
      BwdArgs<T>{static_cast<const T*>(x), static_cast<const T*>(dy), scale,
                 static_cast<T*>(dx), dscale, work, work_rows, rows, D, xs,
                 dys, eps, sdt, 0, sms, grid},
      st);
}

int bwd(int dtype, int sdtype, const void* x, const void* scale,
        const void* dy, void* dx, void* dscale, float* work, int work_rows,
        int64_t rows, int D, int64_t xs, int64_t dys, float eps, int sms,
        int* grid, cudaStream_t st) {
  switch (dtype) {
    case F32:
      return bwd_as<float>(x, scale, sdtype, dy, dx, dscale, work, work_rows,
                           rows, D, xs, dys, eps, sms, grid, st);
    case BF16:
      return bwd_as<__nv_bfloat16>(x, scale, sdtype, dy, dx, dscale, work,
                                   work_rows, rows, D, xs, dys, eps, sms,
                                   grid, st);
    default:
      return bwd_as<__half>(x, scale, sdtype, dy, dx, dscale, work, work_rows,
                            rows, D, xs, dys, eps, sms, grid, st);
  }
}

bool bad_args(int dtype, int sdtype, int64_t rows, int D) {
  return dtype < F32 || dtype > F16 || sdtype < F32 || sdtype > F16 ||
         rows < 1 || rows > INT32_MAX || D < 1 || D > MAX_D;
}

}  // namespace

// dtype and sdtype: 0 float32, 1 bfloat16, 2 float16 (x and out; scale).
// x [rows, D] with row stride x_stride (elements), the last dimension
// contiguous; out [rows, D] contiguous.
extern "C" int rmsnorm_fwd(int dtype, int sdtype, const void* x,
                           const void* scale, void* out, int64_t rows, int D,
                           int64_t x_stride, float eps, void* stream) {
  if (bad_args(dtype, sdtype, rows, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return launch_fwd_f32(static_cast<const float*>(x), scale, sdtype,
                            static_cast<float*>(out), rows, D, x_stride, eps,
                            st);
    case BF16:
      return launch_fwd(static_cast<const __nv_bfloat16*>(x), scale, sdtype,
                        static_cast<__nv_bfloat16*>(out), rows, D, x_stride,
                        eps, st);
    default:
      return launch_fwd(static_cast<const __half*>(x), scale, sdtype,
                        static_cast<__half*>(out), rows, D, x_stride, eps, st);
  }
}

// The forward's x and scale, the upstream gradient dy [rows, D] (row stride
// dy_stride, last dimension contiguous) -> dx [rows, D] contiguous in x's
// dtype and dscale [D] in scale's.  work: fp32 scratch of work_rows rows of
// D, at least BWD_CTAS_PER_SM rows a SM; sms: the card's SM count.
extern "C" int rmsnorm_bwd(int dtype, int sdtype, const void* x,
                           const void* scale, const void* dy, void* dx,
                           void* dscale, float* work, int work_rows,
                           int64_t rows, int D, int64_t x_stride,
                           int64_t dy_stride, float eps, int sms,
                           void* stream) {
  if (bad_args(dtype, sdtype, rows, D) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return bwd(dtype, sdtype, x, scale, dy, dx, dscale, work, work_rows, rows,
             D, x_stride, dy_stride, eps, sms, nullptr,
             static_cast<cudaStream_t>(stream));
}

// The grid rmsnorm_bwd takes on these arguments, launching nothing:
// grid[0] blocks, grid[1] teams a block (1 where a block takes a row).
extern "C" int rmsnorm_bwd_grid(int dtype, int sdtype, const void* x,
                                const void* scale, const void* dy,
                                const void* dx, int64_t rows, int D,
                                int64_t x_stride, int64_t dy_stride, int sms,
                                int* grid) {
  if (bad_args(dtype, sdtype, rows, D) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return bwd(dtype, sdtype, x, scale, dy, const_cast<void*>(dx), nullptr,
             nullptr, BWD_CTAS_PER_SM * sms, rows, D, x_stride, dy_stride,
             0.f, sms, grid, nullptr);
}

// An empty kernel: the launch floor the decode rows are measured against.
extern "C" int rmsnorm_empty(void* stream) {
  rmsnorm_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
