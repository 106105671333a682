// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan /
// _ssd_kernel / _segsum).  Per head h, with dA = dt * A[h] and cs its
// cumulative sum inside a chunk, each chunk computes
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (dual form)
//         + exp(cs_i) C_i . state                                 (carried state)
//   state = state exp(cs_last) + sum_j B_j exp(cs_last - cs_j) dt_j x_j
// B and C are shared by all heads (n_groups 1).  The state is fp32 and
// starts from the caller's initial state or zeros; y takes x's dtype.  Any
// S is taken: the partial last chunk is masked (the model's plain scan
// shrinks its chunk to gcd(S, chunk) instead, which is the same function).
//
// The C entry point picks the kernels by dtype.  This is not a fallback:
// each dtype has its own kernels and nothing reaches the other's.
//
// bfloat16 -- the SSD algorithm's chunk-parallel decomposition (Dao & Gu
// 2024, "Transformers are SSMs", section 6 / Listing 1) on the tensor
// cores, four kernels per call; only the short state recurrence between
// chunks is sequential:
//   0. ssd_cb_kernel, one block per (64-row query tile, chunk, row): C.B^T
//      of the chunk's causal tiles, wgmma on bf16 tiles (exact products,
//      fp32 sums), written to scratch once for all heads (B and C are
//      shared), so no head recomputes it.  A block owning all heads of a
//      query tile would keep C.B^T without scratch, but would need every
//      head's [P, N] state in shared memory and leave 128 blocks at the
//      serving shape; the scratch (5.2 MB of causal tiles there, read from
//      L2 once per head) lets step 3 run 1,024 blocks;
//   1. ssd_chunk_state_kernel, one block per (head, chunk, row): the
//      chunk's cumulative sum (a warp scan) and its local state
//      sum_j x_j^T B_j dt_j exp(total - cs_j) [P, N], wgmma over 64-row key
//      tiles, to scratch; and the chunk's total;
//   2. ssd_state_pass_kernel, one thread per 8 entries of a (row, head)'s
//      state: walks the chunks in order, writes the state entering each
//      chunk over its local state, and the final state;
//   3. ssd_chunk_out_kernel, one block per (head, chunk, row), 64 query rows
//      at a time: exp(cs) C.state_in^T plus (C.B^T o L o dt) x, where the
//      decay L = exp(cs_i - cs_j) is formed only where j <= i (no exp of a
//      -inf difference), in registers from step 0's C.B^T; the block walks
//      its (query tile, key tile) pairs as one pipeline, each pair's x and
//      C.B^T tiles loading while the pair before is computed.
// Every tile is bf16 in the 128-byte swizzled layout wgmma reads
// (csrc/flash_mma.cuh), loaded by 16-byte cp.async in two stages; x, B
// and C go in as the bf16 values they are.  An fp32 operand -- the
// weighted x of step 1, the state of step 3, and M = C.B^T o L o dt -- is
// split into hi = bf16(v) and lo = bf16(v - hi), two products into one
// fp32 accumulator: ~16 bits of mantissa where one bf16 rounding (8 bits)
// misses the 3e-2 tolerance (PERF.md).  The split doubles those products:
// ~28 GFLOP executed at the serving shape for the 13.2 GFLOP the function
// needs.  No atomics: two calls give bit-equal results.  The caller's
// workspace holds the scratch (Workspace below).  The loads need 16-byte
// aligned rows: base pointers, and the row strides of x, B and C, in
// multiples of 8 elements (the launcher checks).
//
// float32 -- ssd_scan_kernel, the CUDA-core kernel of the first port: one
// block per (head, row) walks the chunks with the [P, N] state in shared
// memory and runs its products as fp32 fmaf loops on 64-row tiles.  TF32
// or bf16 products would not hold float32's 2e-4 tolerance.
//
// Bound.  At the serving shape (B 4, S 2048, H 32, P 64, N 128, chunk 256,
// bf16 x/B/C) one call moves ~77 MB (x and y 33.6 MB each, B and C 2.1 MB
// each, dt 1 MB, the fp32 state 4.2 MB) and needs ~13 GFLOP with the
// causal half: ~23 us at the memory rate and ~13 us at the bf16
// tensor-core rate of an H100 SXM, so bytes bound it.  The bf16 design
// also moves its scratch: the local states written, read and rewritten
// and read again (4 x 33.6 MB), C.B^T read once per head (from L2), and x
// read twice.  Each block is one warpgroup that waits for its loads and
// products in turn; TMA loads, warp specialisation and fusing the steps
// are what remains (ROADMAP).
//
// Layout: x [B, S, H, P], Bm and Cm [B, S, N] read through their own
// batch/sequence(/head) strides with the last dimension contiguous, so the
// model's slices of the conv output need no copy; dt [B, S, H] fp32 by
// strides; A [H] fp32; the initial and final state [B, H, P, N] and y
// [B, S, H, P] contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_mma.cuh"
#include "ssd_mma.cuh"

namespace {

constexpr int TILE = 64;       // query / key rows of one tile of a chunk
constexpr int THREADS = 256;
constexpr int LDS = TILE + 1;  // padded row stride of the score tile

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* init;  // may be null: the state starts at zero
  void* y;
  float* state_out;
  int B, S, H, chunk;
  int64_t x_sb, x_ss, x_sh;
  int64_t dt_sb, dt_ss, dt_sh;
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  // bf16 only: the scratch (Workspace), chunks and 64-row tiles per chunk.
  float* local;
  float* totals;
  float* cb;
  int nc, QT;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int P, int N>
constexpr size_t smem_floats() {
  // state, C tile, B tile (rows padded to N + 1), x*dt tile, score tile.
  return (P + 2 * TILE) * (N + 1) + TILE * P + TILE * LDS;
}

// Stage rows [row0, row0 + TILE) of a [S, N] slice as fp32 with padded
// rows, zero-filling rows at or past n_rows.
template <typename T, int N>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  for (int i = threadIdx.x; i < TILE * N; i += THREADS) {
    const int r = i / N, c = i % N;
    dst[r * (N + 1) + c] =
        r < n_rows ? to_float(src[(row0 + r) * row_stride + c]) : 0.f;
  }
}

// Stage x*dt of rows [row0, row0 + TILE) of one head, times
// exp(total - cs) of the row when `decay` (the state update's weight).
template <typename T, int P>
__device__ __forceinline__ void load_xdt(float* dst, const T* x,
                                         int64_t row_stride, int row0,
                                         int n_rows, const float* dts,
                                         const float* cs, float total,
                                         bool decay) {
  for (int i = threadIdx.x; i < TILE * P; i += THREADS) {
    const int r = i / P, c = i % P;
    float v = 0.f;
    if (r < n_rows) {
      v = to_float(x[(row0 + r) * row_stride + c]) * dts[r];
      if (decay) v *= expf(total - cs[r]);
    }
    dst[i] = v;
  }
}

// cs[i] = sum_{k <= i} dts[k] * a for i < len, by the 32 lanes of one warp:
// each lane sums a contiguous segment, a shuffle scan adds the segments'
// offsets.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cs,
                                             int len, float a, int lane) {
  const int per = (len + 31) / 32;
  const int lo = min(lane * per, len), hi = min(lo + per, len);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += dts[i] * a;
    cs[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float base = incl - run;
  for (int i = lo; i < hi; ++i) cs[i] += base;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(Params p) {
  constexpr int LDN = N + 1;
  extern __shared__ float smem[];
  float* St = smem;               // [P][LDN]: the state carried across chunks
  float* Cs = St + P * LDN;       // [TILE][LDN]: C rows of the query tile
  float* Bs = Cs + TILE * LDN;    // [TILE][LDN]: B rows of the key tile
  float* Xs = Bs + TILE * LDN;    // [TILE][P]: x*dt rows of the key tile
  float* Ss = Xs + TILE * P;      // [TILE][LDS]: masked, decayed scores
  float* dts = Ss + TILE * LDS;   // [chunk]: dt of the chunk
  float* cs = dts + p.chunk;      // [chunk]: cumulative sum of dt*A

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a = p.A[h];
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* Bg = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* Cg = static_cast<const T*>(p.Cm) + b * p.c_sb;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  T* y = static_cast<T*>(p.y) + static_cast<int64_t>(b) * p.S * y_ss + h * P;
  const int64_t st_off = (static_cast<int64_t>(b) * p.H + h) * P * N;

  for (int i = tid; i < P * N; i += THREADS)
    St[(i / N) * LDN + i % N] = p.init ? p.init[st_off + i] : 0.f;

  // Score tile: a 16 x 16 thread grid, 4 x 4 scores per thread (rows
  // sy*4 + i, columns sx + 16*j).
  const int sx = tid % 16, sy = tid / 16;
  // [TILE, P] outputs: TX threads across P, RPT rows x CPT columns each
  // (rows ay*RPT + i, columns ax + TX*j).
  constexpr int TX = P < 32 ? P : 32;
  constexpr int TY = THREADS / TX;
  constexpr int RPT = TILE / TY;
  constexpr int CPT = P / TX;
  const int ax = tid % TX, ay = tid / TX;
  // [P, N] state update: NX threads across N, PPT rows x NPT columns each
  // (rows ny*PPT + i, columns nx + NX*k).
  constexpr int NX = N < 32 ? N : 32;
  constexpr int NY = THREADS / NX;
  constexpr int PPT = P / NY;
  constexpr int NPT = N / NX;
  const int nx = tid % NX, ny = tid / NX;
  static_assert(TILE % TY == 0 && P % TX == 0, "output mapping");
  static_assert(P % NY == 0 && PPT > 0 && N % NX == 0, "state mapping");
  static_assert(THREADS == 256 && TILE == 64, "score mapping is 16 x 16 x 4");

  for (int c0 = 0; c0 < p.S; c0 += p.chunk) {
    const int len = min(p.chunk, p.S - c0);
    __syncthreads();  // the previous chunk's dts, cs and St reads are done
    for (int i = tid; i < len; i += THREADS)
      dts[i] = dt[static_cast<int64_t>(c0 + i) * p.dt_ss];
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, cs, len, a, tid);
    __syncthreads();
    const float total = cs[len - 1];

    for (int q0 = 0; q0 < len; q0 += TILE) {
      __syncthreads();  // the previous query tile's C rows are consumed
      load_rows<T, N>(Cs, Cg, p.c_ss, c0 + q0, len - q0);
      __syncthreads();

      // The carried state: acc = exp(cs_i) * C_i . state[p, :].
      float acc[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RPT], sv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) cv[i] = Cs[(ay * RPT + i) * LDN + n];
#pragma unroll
        for (int j = 0; j < CPT; ++j) sv[j] = St[(ax + TX * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = q0 + ay * RPT + i;
        const float d = r < len ? expf(cs[r]) : 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] *= d;
      }

      // The dual form over key tiles up to and including the diagonal one.
      for (int k0 = 0; k0 <= q0; k0 += TILE) {
        __syncthreads();  // the previous key tile's B, x*dt and scores are consumed
        load_rows<T, N>(Bs, Bg, p.b_ss, c0 + k0, len - k0);
        load_xdt<T, P>(Xs, x, p.x_ss, c0 + k0, len - k0, dts + k0, cs + k0,
                       total, false);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(sy * 4 + i) * LDN + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(sx + 16 * j) * LDN + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + sy * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = k0 + sx + 16 * j;
            Ss[(sy * 4 + i) * LDS + sx + 16 * j] =
                (kj <= qi && qi < len) ? s[i][j] * expf(cs[qi] - cs[kj]) : 0.f;
          }
        }
        __syncthreads();  // scores written

#pragma unroll 4
        for (int c = 0; c < TILE; ++c) {
          float xv[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) xv[j] = Xs[c * P + ax + TX * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float sc = Ss[(ay * RPT + i) * LDS + c];
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(sc, xv[j], acc[i][j]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = q0 + ay * RPT + i;
        if (r >= len) continue;
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          y[(c0 + r) * y_ss + ax + TX * j] = from_float<T>(acc[i][j]);
      }
    }

    // State update: sum_j B_j exp(total - cs_j) dt_j x_j over the chunk.
    float sacc[PPT][NPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i)
#pragma unroll
      for (int k = 0; k < NPT; ++k) sacc[i][k] = 0.f;
    for (int k0 = 0; k0 < len; k0 += TILE) {
      __syncthreads();  // B, x*dt and scores of the last tile are consumed
      load_rows<T, N>(Bs, Bg, p.b_ss, c0 + k0, len - k0);
      load_xdt<T, P>(Xs, x, p.x_ss, c0 + k0, len - k0, dts + k0, cs + k0,
                     total, true);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        float xv[PPT], bv[NPT];
#pragma unroll
        for (int i = 0; i < PPT; ++i) xv[i] = Xs[j * P + ny * PPT + i];
#pragma unroll
        for (int k = 0; k < NPT; ++k) bv[k] = Bs[j * LDN + nx + NX * k];
#pragma unroll
        for (int i = 0; i < PPT; ++i)
#pragma unroll
          for (int k = 0; k < NPT; ++k) sacc[i][k] = fmaf(xv[i], bv[k], sacc[i][k]);
      }
    }
    // Every read of St in this chunk came before the barriers above, and
    // each thread rewrites only its own entries.
    const float decay = expf(total);
#pragma unroll
    for (int i = 0; i < PPT; ++i)
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        float* e = St + (ny * PPT + i) * LDN + nx + NX * k;
        *e = *e * decay + sacc[i][k];
      }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS)
    p.state_out[st_off + i] = St[(i / N) * LDN + i % N];
}

template <typename T, int P, int N>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (smem_floats<P, N>() + 2 * static_cast<size_t>(p.chunk));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, p.B);
  ssd_scan_kernel<T, P, N><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The (head_dim, state) pairs built: the test shapes and the Mamba-2 models'.
template <typename T>
int launch_shape(const Params& p, int P, int N, cudaStream_t stream) {
  if (P == 16 && N == 16) return launch<T, 16, 16>(p, stream);
  if (P == 32 && N == 64) return launch<T, 32, 64>(p, stream);
  if (P == 64 && N == 128) return launch<T, 64, 128>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------ bfloat16, tensor cores

namespace fm = flash_mma;

constexpr int KT = 64;         // rows of one query or key tile of a chunk
constexpr int WG = 128;        // one warpgroup per block
constexpr int PASS_THREADS = 256;
constexpr int PASS_BATCH = 4;   // chunks whose loads step 2 issues together

// Scratch of one bf16 call, carved from the caller's workspace: the chunks'
// local states (then, in place, the hi/lo split of the state entering each
// chunk) [B, nc, H, P, N] fp32; each chunk's total sum of dt*A [B, nc, H];
// C.B^T per (row, chunk) [B, nc, QT, QT] tiles of 64 x 64 fp32, each in
// the accumulator order of a warpgroup (float4 v of thread t at v * 128 + t).
struct Workspace {
  size_t local, totals, cb, bytes;  // offsets in bytes, and the total
};

__host__ __device__ inline size_t align256(size_t n) {
  return (n + 255) / 256 * 256;
}

inline Workspace workspace_layout(int B, int S, int H, int P, int N,
                                  int chunk) {
  const size_t nc = (S + chunk - 1) / chunk, qt = (chunk + KT - 1) / KT;
  Workspace w;
  w.local = 0;
  w.totals = align256(sizeof(float) * B * nc * H * P * N);
  w.cb = w.totals + align256(sizeof(float) * B * nc * H);
  w.bytes = w.cb + sizeof(float) * B * nc * qt * qt * KT * KT;
  return w;
}

using ssd_mma::c_to_a_split;
using ssd_mma::split2;
using ssd_mma::zero;

// dt of rows [c0, c0 + len) of one (row, head) into dts, and its cumulative
// sum times a into cs (warp 0).  Ends in a barrier.
__device__ __forceinline__ void stage_cumsum(const float* dt, int64_t dt_ss,
                                             int c0, int len, float a,
                                             float* dts, float* cs) {
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    dts[i] = dt[static_cast<int64_t>(c0 + i) * dt_ss];
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(dts, cs, len, a, threadIdx.x);
  __syncthreads();
}

template <int P, int N>
struct Bf16Cfg {
  static constexpr int PP = fm::tile_hd(P);  // P as the tiles hold it
  static constexpr int NP = fm::tile_hd(N);  // N as the tiles hold it
  static_assert(PP == 64, "one warpgroup of 64 rows covers P");
  // Step 0: C tile, B tiles in two stages.
  static constexpr size_t SMEM_CB = sizeof(fm::bf16) * 3 * KT * NP;
  // Step 1: x and B tiles in two stages (+ dt and its cumsum, by chunk).
  static constexpr size_t SMEM_STATE = sizeof(fm::bf16) * 2 * KT * (PP + NP);
  // Step 3: state hi and lo, C tile, x and G tiles in two stages (+ dt,
  // cumsum).
  static constexpr size_t SMEM_OUT =
      sizeof(fm::bf16) * (2 * PP * NP + KT * NP + 2 * KT * PP) +
      sizeof(float) * 2 * KT * KT;
};

// Step 0: C.B^T of one (query tile, chunk, row): G[i][j] = C_i . B_j for
// the key tiles up to the diagonal, wgmma with both operands K-major in
// shared memory, bf16 in and fp32 out, once for all heads.
template <int P, int N>
__global__ void __launch_bounds__(WG, 1) ssd_cb_kernel(Params p) {
  using Cfg = Bf16Cfg<P, N>;
  constexpr int NP = Cfg::NP;
  extern __shared__ __align__(1024) uint4 smem_tiles[];
  fm::bf16* Cs = reinterpret_cast<fm::bf16*>(smem_tiles);  // [KT][NP]
  fm::bf16* Bs = Cs + KT * NP;                              // [2][KT][NP]
  const int qt = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  if (qt * KT >= len) return;
  const fm::bf16* Cg = static_cast<const fm::bf16*>(p.Cm) + b * p.c_sb +
                       static_cast<int64_t>(c0) * p.c_ss;
  const fm::bf16* Bg = static_cast<const fm::bf16*>(p.Bm) + b * p.b_sb +
                       static_cast<int64_t>(c0) * p.b_ss;
  float* G = p.cb + ((static_cast<int64_t>(b) * p.nc + c) * p.QT + qt) *
                        p.QT * KT * KT;

  fm::load_tile<KT, N, WG, NP>(Cs, Cg, p.c_ss, qt * KT, len);
  fm::load_tile<KT, N, WG, NP>(Bs, Bg, p.b_ss, 0, len);
  fm::cp_async_commit();
  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    if (kt < qt)
      fm::load_tile<KT, N, WG, NP>(Bs + (st ^ 1) * KT * NP, Bg, p.b_ss,
                                   (kt + 1) * KT, len);
    fm::cp_async_commit();
    fm::cp_async_wait<1>();
    fm::fence_async_smem();
    __syncthreads();
    float g[KT / 8][4];
    zero(g);
    fm::fence_operand(g);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      fm::wgmma_ss<KT>(g, fm::desc_k<KT>(Cs, 0, kk),
                       fm::desc_k<KT>(Bs + st * KT * NP, 0, kk), 1);
    fm::wgmma_commit();
    fm::wgmma_wait<0>();
    fm::fence_operand(g);
    float4* out = reinterpret_cast<float4*>(G + kt * KT * KT);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
      out[j * WG + threadIdx.x] = make_float4(g[j][0], g[j][1], g[j][2], g[j][3]);
    __syncthreads();  // stage st consumed before it is loaded again
  }
}

// Step 1: the local state of one (head, chunk, row),
//   local[p][n] = sum_j x_j[p] dt_j exp(total - cs_j) B_j[n],
// as wgmma over the chunk's 64-row key tiles: the weighted x, fp32, is
// split into hi and lo bf16 A fragments built in registers from the x tile
// (rows p of the warpgroup, reduction over j), B is read MN-major from its
// tile.  Also writes the chunk's total sum of dt*A.
template <int P, int N>
__global__ void __launch_bounds__(WG, 3) ssd_chunk_state_kernel(Params p) {
  using Cfg = Bf16Cfg<P, N>;
  constexpr int PP = Cfg::PP, NP = Cfg::NP;
  using XT = fm::Tile<KT, PP>;
  extern __shared__ __align__(1024) uint4 smem_tiles[];
  fm::bf16* Xs = reinterpret_cast<fm::bf16*>(smem_tiles);  // [2][KT][PP]
  fm::bf16* Bs = Xs + 2 * KT * PP;                          // [2][KT][NP]
  float* wts = reinterpret_cast<float*>(Bs + 2 * KT * NP);  // [chunk]
  float* cs = wts + p.chunk;                                // [chunk]

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const fm::bf16* x = static_cast<const fm::bf16*>(p.x) + b * p.x_sb +
                      h * p.x_sh + static_cast<int64_t>(c0) * p.x_ss;
  const fm::bf16* Bg = static_cast<const fm::bf16*>(p.Bm) + b * p.b_sb +
                       static_cast<int64_t>(c0) * p.b_ss;

  fm::load_tile<KT, P, WG, PP>(Xs, x, p.x_ss, 0, len);
  fm::load_tile<KT, N, WG, NP>(Bs, Bg, p.b_ss, 0, len);
  fm::cp_async_commit();
  stage_cumsum(p.dt + b * p.dt_sb + h * p.dt_sh, p.dt_ss, c0, len, p.A[h],
               wts, cs);
  const float total = cs[len - 1];
  for (int i = threadIdx.x; i < len; i += WG)
    wts[i] = wts[i] * expf(total - cs[i]);  // dt_j exp(total - cs_j)
  const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  if (threadIdx.x == 0) p.totals[bch] = total;

  float acc[NP / 8][4];
  zero(acc);
  const int p0 = 16 * warp + g;  // this lane's state rows: p0, p0 + 8
  const int n_tiles = (len + KT - 1) / KT;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      fm::load_tile<KT, P, WG, PP>(Xs + (st ^ 1) * KT * PP, x, p.x_ss,
                                   (kt + 1) * KT, len);
      fm::load_tile<KT, N, WG, NP>(Bs + (st ^ 1) * KT * NP, Bg, p.b_ss,
                                   (kt + 1) * KT, len);
    }
    fm::cp_async_commit();
    fm::cp_async_wait<1>();
    fm::fence_async_smem();
    __syncthreads();  // tile kt landed; the weights are written
    const fm::bf16* Xt = Xs + st * KT * PP;
    // A fragments: rows p0 = 16 warp + g and p0 + 8, columns (key rows)
    // 16 kk + 2t + {0, 1, 8, 9}; rows at or past len weigh 0.
    uint32_t a_hi[KT / 16][4], a_lo[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      float v[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 16 * kk + 2 * t + (q & 1) + 8 * (q >> 1);
        const int jc = kt * KT + j;
        const float w = jc < len ? wts[jc] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pr = p0 + 8 * r;
          v[r][q] = __bfloat162float(Xt[XT::at(j, pr >> 3) + (pr & 7)]) * w;
        }
      }
      split2(v[0][0], v[0][1], a_hi[kk][0], a_lo[kk][0]);
      split2(v[1][0], v[1][1], a_hi[kk][1], a_lo[kk][1]);
      split2(v[0][2], v[0][3], a_hi[kk][2], a_lo[kk][2]);
      split2(v[1][2], v[1][3], a_hi[kk][3], a_lo[kk][3]);
    }
    const fm::bf16* Bt = Bs + st * KT * NP;
    fm::fence_operand(acc);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      fm::wgmma_rs<NP>(acc, a_hi[kk], fm::desc_mn<KT>(Bt, kk), 1);
      fm::wgmma_rs<NP>(acc, a_lo[kk], fm::desc_mn<KT>(Bt, kk), 1);
    }
    fm::wgmma_commit();
    fm::wgmma_wait<0>();
    fm::fence_operand(acc);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      fm::fence_operand(a_hi[kk]);
      fm::fence_operand(a_lo[kk]);
    }
    __syncthreads();  // stage st consumed before it is loaded again
  }

  // acc (j, e) is state row p0 + 8 (e >> 1), column 8j + 2t + (e & 1).
  float* local = p.local + bch * P * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pr = p0 + 8 * r;
    if (pr >= P) continue;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int n = 8 * j + 2 * t;
      if (n < N)
        *reinterpret_cast<float2*>(local + pr * N + n) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// Step 2: the states passed between chunks, for 8 consecutive entries of
// one (head, row)'s [P, N] state per thread: walking the chunks in order,
// state_in[c] = running (written over local[c] as hi/lo bf16 groups: the
// 32 bytes of 8 fp32 entries become 8 hi then 8 lo), running = running *
// exp(total_c) + local[c].  The running state starts from init or zero and
// ends in state_out.
__global__ void __launch_bounds__(PASS_THREADS) ssd_state_pass_kernel(
    Params p, int PN) {
  const int gi = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (8 * gi >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  float run[8];
  if (p.init) {
    const float4* src = reinterpret_cast<const float4*>(p.init + bh * PN) + 2 * gi;
    const float4 u = src[0], v = src[1];
    run[0] = u.x; run[1] = u.y; run[2] = u.z; run[3] = u.w;
    run[4] = v.x; run[5] = v.y; run[6] = v.z; run[7] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) run[e] = 0.f;
  }
  // Chunks in batches of PASS_BATCH: every load of a batch is issued before
  // its first store, so a thread waits on memory once per batch, not once
  // per chunk.
  for (int c0 = 0; c0 < p.nc; c0 += PASS_BATCH) {
    float4 loc[PASS_BATCH][2];
    float decay[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (c0 + k >= p.nc) break;
      const int64_t bch = (static_cast<int64_t>(b) * p.nc + c0 + k) * p.H + h;
      const float4* src = reinterpret_cast<const float4*>(p.local + bch * PN) + 2 * gi;
      loc[k][0] = src[0];
      loc[k][1] = src[1];
      decay[k] = p.totals[bch];
    }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (c0 + k >= p.nc) break;
      const int64_t bch = (static_cast<int64_t>(b) * p.nc + c0 + k) * p.H + h;
      uint4* slot = reinterpret_cast<uint4*>(p.local + bch * PN) + 2 * gi;
      uint4 hi, lo;
      split2(run[0], run[1], hi.x, lo.x);
      split2(run[2], run[3], hi.y, lo.y);
      split2(run[4], run[5], hi.z, lo.z);
      split2(run[6], run[7], hi.w, lo.w);
      slot[0] = hi;
      slot[1] = lo;
      const float d = expf(decay[k]);
      const float l[8] = {loc[k][0].x, loc[k][0].y, loc[k][0].z, loc[k][0].w,
                          loc[k][1].x, loc[k][1].y, loc[k][1].z, loc[k][1].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) run[e] = run[e] * d + l[e];
    }
  }
  float4* out = reinterpret_cast<float4*>(p.state_out + bh * PN) + 2 * gi;
  out[0] = make_float4(run[0], run[1], run[2], run[3]);
  out[1] = make_float4(run[4], run[5], run[6], run[7]);
}

// One 64 x 64 fp32 tile of step 0's C.B^T (in its accumulator order) into
// shared memory by 16-byte cp.async; the caller commits.
__device__ __forceinline__ void load_g(float* dst, const float* src) {
#pragma unroll
  for (int v = 0; v < KT * KT / 4 / WG; ++v) {
    const int i = (v * WG + threadIdx.x) * 4;
    fm::cp_async16(dst + i, src + i, true);
  }
}

// Step 3: y of one (head, chunk, row), 64 query rows at a time:
//   y_i = exp(cs_i) C_i . state_in  +  sum_{j <= i} G_ij exp(cs_i - cs_j) dt_j x_j
// The block walks its (query tile, key tile <= query tile) pairs as one
// pipeline: each step's x tile and step 0's C.B^T tile G arrive by
// cp.async in a two-stage ring while the step before is computed, and a
// query tile's C tile loads once the tile before has used its own.  At a
// query tile's first step the carried term is wgmma with C and the
// state's hi and lo tiles K-major in shared memory; at every step M = G o
// L o dt is formed in registers (the decay only where j <= i), split into
// hi and lo A fragments and multiplied by the x tile read MN-major.  After
// the diagonal step the tile's y leaves through the x stage just consumed.
template <int P, int N>
__global__ void __launch_bounds__(WG, 1) ssd_chunk_out_kernel(Params p) {
  using Cfg = Bf16Cfg<P, N>;
  constexpr int PP = Cfg::PP, NP = Cfg::NP;
  extern __shared__ __align__(1024) uint4 smem_tiles[];
  fm::bf16* Shi = reinterpret_cast<fm::bf16*>(smem_tiles);  // [PP][NP]
  fm::bf16* Slo = Shi + PP * NP;                            // [PP][NP]
  fm::bf16* Cs = Slo + PP * NP;                             // [KT][NP]
  fm::bf16* Xs = Cs + KT * NP;                              // [2][KT][PP]
  float* Gs = reinterpret_cast<float*>(Xs + 2 * KT * PP);   // [2][KT * KT]
  float* dts = Gs + 2 * KT * KT;                            // [chunk]
  float* cs = dts + p.chunk;                                // [chunk]

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const fm::bf16* x = static_cast<const fm::bf16*>(p.x) + b * p.x_sb +
                      h * p.x_sh + static_cast<int64_t>(c0) * p.x_ss;
  const fm::bf16* Cg = static_cast<const fm::bf16*>(p.Cm) + b * p.c_sb +
                       static_cast<int64_t>(c0) * p.c_ss;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  fm::bf16* y = static_cast<fm::bf16*>(p.y) +
                (static_cast<int64_t>(b) * p.S + c0) * y_ss + h * P;
  const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  const float* G0 = p.cb + (static_cast<int64_t>(b) * p.nc + c) * p.QT *
                               p.QT * KT * KT;

  // The state entering the chunk (step 2's hi/lo form).  With step 0's
  // tiles, the first group.
  ssd_mma::load_state_split<P, N>(Shi, Slo, p.local + bch * P * N);
  fm::load_tile<KT, N, WG, NP>(Cs, Cg, p.c_ss, 0, len);
  fm::load_tile<KT, P, WG, PP>(Xs, x, p.x_ss, 0, len);
  load_g(Gs, G0);
  fm::cp_async_commit();
  stage_cumsum(p.dt + b * p.dt_sb + h * p.dt_sh, p.dt_ss, c0, len, p.A[h],
               dts, cs);

  const int n_tiles = (len + KT - 1) / KT;
  const int r0 = 16 * warp + g;  // this lane's rows in a tile: r0, r0 + 8
  float acc[PP / 8][4];
  for (int s = 0, qt = 0, kt = 0;; ++s) {
    const int st = s & 1;
    int nq = qt, nk = kt + 1;  // the next step
    if (nk > nq) {
      nq = qt + 1;
      nk = 0;
    }
    const bool more = nq < n_tiles;
    if (more) {
      fm::load_tile<KT, P, WG, PP>(Xs + (st ^ 1) * KT * PP, x, p.x_ss,
                                   nk * KT, len);
      load_g(Gs + (st ^ 1) * KT * KT, G0 + (nq * p.QT + nk) * KT * KT);
    }
    fm::cp_async_commit();
    fm::cp_async_wait<1>();  // all but the next step's tiles have landed
    fm::fence_async_smem();
    __syncthreads();
    const int q0 = qt * KT;

    if (kt == 0) {  // the carried state, scaled by exp(cs_i)
      zero(acc);
      fm::fence_operand(acc);
      fm::wgmma_arrive();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        fm::wgmma_ss<PP>(acc, fm::desc_k<KT>(Cs, 0, kk),
                         fm::desc_k<PP>(Shi, 0, kk), 1);
        fm::wgmma_ss<PP>(acc, fm::desc_k<KT>(Cs, 0, kk),
                         fm::desc_k<PP>(Slo, 0, kk), 1);
      }
      fm::wgmma_commit();
      fm::wgmma_wait<0>();
      fm::fence_operand(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = q0 + r0 + 8 * r;
        const float d = i < len ? expf(cs[i]) : 0.f;
#pragma unroll
        for (int j = 0; j < PP / 8; ++j) {
          acc[j][2 * r] *= d;
          acc[j][2 * r + 1] *= d;
        }
      }
      if (qt + 1 < n_tiles) {  // C consumed: the next query tile's C
        __syncthreads();
        fm::load_tile<KT, N, WG, NP>(Cs, Cg, p.c_ss, q0 + KT, len);
        fm::cp_async_commit();
      }
    }

    // M = G o L o dt for query rows q0 + r0 (+8), keys k0 + 8j + 2t (+1).
    const int k0 = kt * KT;
    float m[KT / 8][4];
    const float4* Gt = reinterpret_cast<const float4*>(Gs + st * KT * KT);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const float4 v = Gt[j * WG + threadIdx.x];
      m[j][0] = v.x; m[j][1] = v.y; m[j][2] = v.z; m[j][3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + r0 + 8 * r;
      const float csi = i < len ? cs[i] : 0.f;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + 2 * t + e;
          float& v = m[j][2 * r + e];
          v = (kj <= i && i < len) ? v * expf(csi - cs[kj]) * dts[kj] : 0.f;
        }
    }
    uint32_t a_hi[KT / 16][4], a_lo[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      c_to_a_split(a_hi[kk], a_lo[kk], m[2 * kk], m[2 * kk + 1]);
    const fm::bf16* Xt = Xs + st * KT * PP;
    fm::fence_operand(acc);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      fm::wgmma_rs<PP>(acc, a_hi[kk], fm::desc_mn<KT>(Xt, kk), 1);
      fm::wgmma_rs<PP>(acc, a_lo[kk], fm::desc_mn<KT>(Xt, kk), 1);
    }
    fm::wgmma_commit();
    fm::wgmma_wait<0>();
    fm::fence_operand(acc);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      fm::fence_operand(a_hi[kk]);
      fm::fence_operand(a_lo[kk]);
    }
    __syncthreads();  // stage st consumed

    if (kt == qt) {
      // The warp's own rows of the consumed x stage take its y for 16-byte
      // stores; the next step loads into this stage only after the barrier.
      fm::store_rows<KT, P, PP>(Xs + st * KT * PP, 16 * warp, acc, 1.f, 1.f,
                                y, y_ss, q0 + 16 * warp, len, lane);
      __syncthreads();
    }
    if (!more) break;
    qt = nq;
    kt = nk;
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// The four steps on `stream`: C.B^T and the local states (independent),
// the state passing, the outputs.
template <int P, int N>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using Cfg = Bf16Cfg<P, N>;
  const size_t scan = 2 * sizeof(float) * static_cast<size_t>(p.chunk);
  const size_t s_state = Cfg::SMEM_STATE + scan, s_out = Cfg::SMEM_OUT + scan;
  int err = set_smem(ssd_cb_kernel<P, N>, Cfg::SMEM_CB);
  if (!err) err = set_smem(ssd_chunk_state_kernel<P, N>, s_state);
  if (!err) err = set_smem(ssd_chunk_out_kernel<P, N>, s_out);
  if (err) return err;
  ssd_cb_kernel<P, N><<<dim3(p.QT, p.nc, p.B), WG, Cfg::SMEM_CB, stream>>>(p);
  ssd_chunk_state_kernel<P, N><<<dim3(p.H, p.nc, p.B), WG, s_state, stream>>>(p);
  constexpr int PN = P * N;
  const int pass_blocks = (PN / 8 + PASS_THREADS - 1) / PASS_THREADS;
  ssd_state_pass_kernel<<<dim3(pass_blocks, p.H, p.B), PASS_THREADS, 0,
                          stream>>>(p, PN);
  ssd_chunk_out_kernel<P, N><<<dim3(p.H, p.nc, p.B), WG, s_out, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16_shape(const Params& p, int P, int N, cudaStream_t stream) {
  if (P == 16 && N == 16) return launch_bf16<16, 16>(p, stream);
  if (P == 32 && N == 64) return launch_bf16<32, 64>(p, stream);
  if (P == 64 && N == 128) return launch_bf16<64, 128>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the four
// tensor-core kernels, 16-byte aligned rows).  strides: 10 element strides,
// x (batch, sequence, head), dt (batch, sequence, head), Bm (batch,
// sequence) and Cm (batch, sequence).  init may be null.  workspace: for
// bfloat16, 256-byte aligned scratch of workspace_bytes, at least
// Workspace::bytes (float32 takes null).  Returns the CUDA error of the
// launches (0 on success); launches on `stream` and does not synchronise.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const float* dt,
                            const float* A, const void* Bm, const void* Cm,
                            const float* init, void* y, float* state_out,
                            int B, int S, int H, int P, int N, int chunk,
                            const int64_t* strides, void* workspace,
                            int64_t workspace_bytes, void* stream) {
  Params p{x, dt, A, Bm, Cm, init, y, state_out, B, S, H, chunk,
           strides[0], strides[1], strides[2],
           strides[3], strides[4], strides[5],
           strides[6], strides[7],
           strides[8], strides[9],
           nullptr, nullptr, nullptr,
           (S + chunk - 1) / chunk, (chunk + KT - 1) / KT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_shape<float>(p, P, N, s);
    case 1: {
      const Workspace w = workspace_layout(B, S, H, P, N, chunk);
      if (workspace == nullptr ||
          static_cast<size_t>(workspace_bytes) < w.bytes)
        return static_cast<int>(cudaErrorInvalidValue);
      char* base = static_cast<char*>(workspace);
      p.local = reinterpret_cast<float*>(base + w.local);
      p.totals = reinterpret_cast<float*>(base + w.totals);
      p.cb = reinterpret_cast<float*>(base + w.cb);
      return launch_bf16_shape(p, P, N, s);
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

