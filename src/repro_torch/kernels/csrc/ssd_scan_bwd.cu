// Backward of the Mamba-2 SSD chunked scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a), CUDA C++.
//
// The Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan / _ssd_kernel /
// _segsum) is forward-only: JAX differentiates the model's jnp scan.  This
// kernel is the gradient of the port's forward, so it has no TPU
// counterpart.  Its plain version is autograd through
// repro_torch.kernels.ref.ssd_scan_ref; kernels/ssd_scan.py's
// ssd_scan_bwd_phases mirrors these steps in plain torch for the CPU tests.
//
// Per chunk and head, with a_t = dt_t A, cs its cumulative sum inside the
// chunk, total the cs of the chunk's last valid row, L_ij = exp(cs_i - cs_j)
// for j <= i (never formed above the diagonal, where the exp of a positive
// difference of ~1e3 would overflow), G = C.B^T, D_ij = dy_i.x_j,
// W = L o dt_j o D, and S_in / dS_out the state entering the chunk and the
// gradient of the state leaving it:
//   dS_in  = exp(total) dS_out + sum_i exp(cs_i) dy_i (x) C_i
//   dC_i   = sum_{j<=i} W_ij B_j + exp(cs_i) S_in^T dy_i          (per head)
//   dB_j   = sum_{i>=j} W_ij C_i + exp(total - cs_j) dt_j dS_out^T x_j
//   w_j    = sum_{i>=j} (G o L)_ij dy_i + exp(total - cs_j) dS_out B_j
//   dx_j   = dt_j w_j
//   da_t   = sum_{j<t<=i} (G o W)_ij + sum_{t'>=t} dcs_t', where
//   dcs_t  = exp(cs_t) dy_t.(S_in C_t) - exp(total - cs_t) dt_t x_t.(dS_out
//            B_t), plus, on the last valid row, d total = exp(total)
//            <S_in, dS_out> + sum_j exp(total - cs_j) dt_j x_j.(dS_out B_j)
//   ddt_t  = A da_t + x_t.w_t
//   dA     = sum over rows and batch of da_t dt_t.
// The pairs' part of da is summed directly over the pairs (i, j) that
// straddle t (the "stable" form): written as a row sum of G o W less a
// column sum, as autograd through the plain scan has it, the two cancel,
// and over a whole chunk in fp32 that costs dA and ddt most of their
// digits where the chunk's terms are large.
// B and C are shared by the heads (n_groups 1): dB and dC sum over heads.
//
// Six kernels per call, on the caller's stream, over the caller's
// workspace (BwdWorkspace below):
//   0. ssd_bwd_cb_kernel, one block per (64-row query tile, chunk, row):
//      C.B^T of the chunk's causal tile pairs, fp32, once for all heads;
//   1. ssd_bwd_state_kernel, one block per (head, chunk, row): the chunk's
//      cumulative sum (a warp scan, as the forward's), its total, its local
//      state and its local d(state) [P, N];
//   2. ssd_bwd_pass_kernel, one thread per (row, head, state entry): the
//      states entering the chunks in order, the d(states) leaving them in
//      reverse, and d(initial state);
//   3. ssd_bwd_chunk_kernel, one block per (head, chunk, row): pass A walks
//      the query tiles I (dC, the pairs' part of da, over key tiles J <= I,
//      and the carried state's part of dcs), pass B the key tiles J (dB,
//      dx, x.w and the leaving state's part of dcs, over I >= J); then
//      d total, da, ddt and the chunk's share of dA;
//   4. ssd_bwd_reduce_kernel: dB and dC summed over heads in order;
//   5. ssd_bwd_dA_kernel: dA summed over (row, chunk) in order.
// No atomics: two calls give bit-equal results.  Every product is fp32 on
// the CUDA cores (fmaf), templated over the element type of x, B, C, dy and
// of dx, dB, dC (float or __nv_bfloat16); ddt, dA and d(initial state) are
// fp32.  The cumulative sums of dt*A, their reverse (da) and the sums into
// dA run in fp64 (chunk_cumsum says why).
//
// Bound.  At mamba2-370m's train shape (B 4, S 4096, H 32, P 64, N 128,
// chunk 256, bf16) the function reads x, dy, B, C, dt (145 MB) and writes
// dx, dB, dC, ddt (78 MB): 222 MB, ~66 us at the memory rate.  It needs
// ~95 GFLOP (dy.x, W.B, W^T.C and (G o L)^T.dy over the causal pairs, five
// [P, N] products per row and head: the local state and d(state), S_in^T
// dy, dS_out B, dS_out^T x), ~96 us at the bf16 tensor-core rate, so
// operations bound it.  This design runs them on the CUDA cores, each
// tile pair's D twice (once per pass), and moves its scratch besides: the
// per-head partial dB and dC [B, S, H, N] fp32 (537 MB written and read at
// that shape) and the [B, nc, H, P, N] states (67 MB each).  Tensor-core
// products, fusing the passes and summing heads in a block are what remain
// (ROADMAP B').
//
// Layout: x [B, S, H, P], Bm and Cm [B, S, N] through their own
// batch/sequence(/head) strides with the last dimension contiguous (the
// model's slices of its conv output); dt [B, S, H] fp32 by strides; A [H];
// dy, dx [B, S, H, P], dBm, dCm [B, S, N], ddt [B, S, H], the initial
// state, d(final state) and d(initial state) [B, H, P, N], all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 64;       // rows of a query or key tile of a chunk
constexpr int THREADS = 256;
constexpr int LDS = TILE;      // row stride of the W tile (broadcast reads)

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* init;    // may be null: the state starts at zero
  const void* dy;
  const float* dfinal;  // may be null: the final state's gradient is zero
  void* dx;
  float* ddt;
  float* dA;
  void* dBm;
  void* dCm;
  float* dinit;         // may be null: not asked for
  int B, S, H, chunk, nc, QT;
  int64_t x_sb, x_ss, x_sh;
  int64_t dt_sb, dt_ss, dt_sh;
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  // Scratch (BwdWorkspace).
  float* cb;       // [B, nc, QT, QT, TILE, TILE]: C.B^T tiles, row-major
  float* states;   // [B, nc, H, P, N]: local states, then states entering
  float* dstates;  // [B, nc, H, P, N]: local d(states), then d(leaving)
  float* totals;   // [B, nc, H]
  float* dA_part;  // [B, nc, H]
  float* dB_part;  // [B, S, H, N]
  float* dC_part;  // [B, S, H, N]
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

// Rows [0, TILE) of src (rows `row_stride` apart, W contiguous columns) as
// fp32 into dst with row stride `ld`, zero past n_rows.
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t row_stride, int n_rows) {
  for (int i = threadIdx.x; i < TILE * W; i += THREADS) {
    const int r = i / W, c = i % W;
    dst[r * ld + c] = r < n_rows ? to_float(src[r * row_stride + c]) : 0.f;
  }
}

// A contiguous fp32 [P, N] state into dst with row stride `ld`.
template <int P, int N>
__device__ __forceinline__ void load_state(float* dst, int ld,
                                           const float* src) {
  for (int i = threadIdx.x; i < P * N; i += THREADS)
    dst[(i / N) * ld + i % N] = src[i];
}

// cs[i] = sum_{k <= i} fp32(dts[k] * a) for i < len, summed in fp64 by the
// 32 lanes of one warp: each lane sums a contiguous segment, a shuffle scan
// adds the segments' offsets.  fp64, so that every exp argument below is a
// difference of cumulative sums exact to fp32 rounding of the difference:
// an fp32 scan errs by ~|cs| * 2^-24 per row, growing along the chunk, and
// |cs| reaches ~1e3 over a chunk at the model's A (torch's CPU cumsum, the
// plain version's, accumulates fp32 in fp64 too).
__device__ __forceinline__ void chunk_cumsum(const float* dts, double* cs,
                                             int len, float a, int lane) {
  const int per = (len + 31) / 32;
  const int lo = min(lane * per, len), hi = min(lo + per, len);
  double run = 0.0;
  for (int i = lo; i < hi; ++i) {
    run += static_cast<double>(dts[i] * a);
    cs[i] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const double base = incl - run;
  for (int i = lo; i < hi; ++i) cs[i] += base;
}

// exp of the fp64 exponent e, in fp32.
__device__ __forceinline__ float exp_of(double e) {
  return expf(static_cast<float>(e));
}

// dt of rows [c0, c0 + len) of one (row, head) into dts and its cumulative
// sum times a into cs (warp 0).  Ends in a barrier.
__device__ __forceinline__ void stage_cumsum(const float* dt, int64_t dt_ss,
                                             int c0, int len, float a,
                                             float* dts, double* cs) {
  for (int i = threadIdx.x; i < len; i += THREADS)
    dts[i] = dt[static_cast<int64_t>(c0 + i) * dt_ss];
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(dts, cs, len, a, threadIdx.x);
  __syncthreads();
}

// Sum of v over the TX lanes that share a row of a TX-wide thread mapping.
template <int TX>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Thread mapping of a [TILE, W] result: TX threads across W, R rows x C
// columns each (rows ty*R + r, columns tx + TX*c).
template <int W>
struct RowMap {
  static constexpr int TX = W < 32 ? W : 32;
  static constexpr int TY = THREADS / TX;
  static constexpr int R = TILE / TY;
  static constexpr int C = W / TX;
  static_assert(TILE % TY == 0 && W % TX == 0 && R > 0, "row mapping");
};

// ---------------------------------------------------------------- step 0

template <typename T, int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_cb_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int LDN = N + 1;
  float* Cs = smem;                // [TILE][LDN]: C rows of the query tile
  float* Bs = Cs + TILE * LDN;     // [TILE][LDN]: B rows of the key tile
  const int qt = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  const int q0 = qt * TILE;
  if (q0 >= len) return;  // a partial last chunk has fewer tiles
  const T* Cg = static_cast<const T*>(p.Cm) + b * p.c_sb +
                static_cast<int64_t>(c0 + q0) * p.c_ss;
  const T* Bg = static_cast<const T*>(p.Bm) + b * p.b_sb +
                static_cast<int64_t>(c0) * p.b_ss;
  float* out = p.cb + ((static_cast<int64_t>(b) * p.nc + c) * p.QT + qt) *
                          p.QT * TILE * TILE;
  load_rows<T, N>(Cs, LDN, Cg, p.c_ss, len - q0);
  const int sx = threadIdx.x % 16, sy = threadIdx.x / 16;
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // the previous key tile is consumed (and Cs written)
    load_rows<T, N>(Bs, LDN, Bg + static_cast<int64_t>(kt) * TILE * p.b_ss,
                    p.b_ss, len - kt * TILE);
    __syncthreads();
    float s[4][4] = {};
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
    float* tile = out + static_cast<int64_t>(kt) * TILE * TILE;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tile[(sy * 4 + i) * TILE + sx + 16 * j] = s[i][j];
  }
}

// ---------------------------------------------------------------- step 1

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_state_kernel(Params p) {
  constexpr int LDN = N + 1;
  extern __shared__ float smem[];
  float* Xs = smem;               // [TILE][P]: dt exp(total - cs) x rows
  float* Ys = Xs + TILE * P;      // [TILE][P]: exp(cs) dy rows
  float* Bs = Ys + TILE * P;      // [TILE][LDN]
  float* Cs = Bs + TILE * LDN;    // [TILE][LDN]
  // [chunk] fp64 cumulative sums (8-byte aligned: the floats above are an
  // even count), then [chunk] dt.
  double* cs = reinterpret_cast<double*>(Cs + TILE * LDN);
  float* dts = reinterpret_cast<float*>(cs + p.chunk);

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
               static_cast<int64_t>(c0) * p.x_ss;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  const T* dy = static_cast<const T*>(p.dy) +
                (static_cast<int64_t>(b) * p.S + c0) * y_ss + h * P;
  const T* Bg = static_cast<const T*>(p.Bm) + b * p.b_sb +
                static_cast<int64_t>(c0) * p.b_ss;
  const T* Cg = static_cast<const T*>(p.Cm) + b * p.c_sb +
                static_cast<int64_t>(c0) * p.c_ss;
  stage_cumsum(p.dt + b * p.dt_sb + h * p.dt_sh, p.dt_ss, c0, len, p.A[h],
               dts, cs);
  const double total = cs[len - 1];
  const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  if (threadIdx.x == 0) p.totals[bch] = static_cast<float>(total);

  // [P, N] mapping: NX threads across N, PPT rows x NPT columns each.
  constexpr int NX = N < 32 ? N : 32;
  constexpr int NY = THREADS / NX;
  constexpr int PPT = P / NY;
  constexpr int NPT = N / NX;
  static_assert(P % NY == 0 && PPT > 0 && N % NX == 0, "state mapping");
  const int nx = threadIdx.x % NX, ny = threadIdx.x / NX;
  float sacc[PPT][NPT] = {}, dacc[PPT][NPT] = {};
  for (int k0 = 0; k0 < len; k0 += TILE) {
    const int n_rows = len - k0;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < TILE * P; i += THREADS) {
      const int r = i / P, col = i % P;
      float xv = 0.f, yv = 0.f;
      if (r < n_rows) {
        const int t = k0 + r;
        xv = to_float(x[t * p.x_ss + col]) * dts[t] * exp_of(total - cs[t]);
        yv = to_float(dy[t * y_ss + col]) * exp_of(cs[t]);
      }
      Xs[i] = xv;
      Ys[i] = yv;
    }
    load_rows<T, N>(Bs, LDN, Bg + static_cast<int64_t>(k0) * p.b_ss, p.b_ss,
                    n_rows);
    load_rows<T, N>(Cs, LDN, Cg + static_cast<int64_t>(k0) * p.c_ss, p.c_ss,
                    n_rows);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < TILE; ++j) {
      float xv[PPT], yv[PPT], bv[NPT], cv[NPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        xv[i] = Xs[j * P + ny * PPT + i];
        yv[i] = Ys[j * P + ny * PPT + i];
      }
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        bv[k] = Bs[j * LDN + nx + NX * k];
        cv[k] = Cs[j * LDN + nx + NX * k];
      }
#pragma unroll
      for (int i = 0; i < PPT; ++i)
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          sacc[i][k] = fmaf(xv[i], bv[k], sacc[i][k]);
          dacc[i][k] = fmaf(yv[i], cv[k], dacc[i][k]);
        }
    }
  }
  float* st = p.states + bch * P * N;
  float* dst = p.dstates + bch * P * N;
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int e = (ny * PPT + i) * N + nx + NX * k;
      st[e] = sacc[i][k];
      dst[e] = dacc[i][k];
    }
}

// ---------------------------------------------------------------- step 2

// Thread e of (row b, head h) walks the chunks: forward, replacing each
// local state by the state entering its chunk; backward, replacing each
// local d(state) by the gradient of the state leaving its chunk.
__global__ void __launch_bounds__(THREADS) ssd_bwd_pass_kernel(Params p,
                                                               int PN) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t step = static_cast<int64_t>(p.H) * PN;  // one chunk
  const int64_t base = (static_cast<int64_t>(b) * p.nc * p.H + h) * PN + e;
  const float* tot = p.totals + static_cast<int64_t>(b) * p.nc * p.H + h;
  const int64_t own = (static_cast<int64_t>(b) * p.H + h) * PN + e;
  float run = p.init ? p.init[own] : 0.f;
  for (int c = 0; c < p.nc; ++c) {
    float* s = p.states + base + c * step;
    const float local = *s;
    *s = run;
    run = run * expf(tot[c * p.H]) + local;
  }
  run = p.dfinal ? p.dfinal[own] : 0.f;
  for (int c = p.nc - 1; c >= 0; --c) {
    float* s = p.dstates + base + c * step;
    const float local = *s;
    *s = run;
    run = run * expf(tot[c * p.H]) + local;
  }
  if (p.dinit) p.dinit[own] = run;
}

// ---------------------------------------------------------------- step 3

template <int P, int N>
struct ChunkCfg {
  static constexpr int LDP = P + 1;   // padded: read down columns
  static constexpr int LDN = N + 1;   // padded: the state is read down columns
  static constexpr int X = 0;                    // [TILE][LDP] x rows (J)
  static constexpr int Y = X + TILE * LDP;       // [TILE][LDP] dy rows (I)
  // [TILE][LDN] B rows (J); after pass A's pair loop S_in [P][LDN]; after
  // pass B's pair loop dS_out [P][LDN].
  static constexpr int Bt = Y + TILE * LDP;
  // [TILE][LDN] C rows (I); after pass B's pair loop B rows (J).
  static constexpr int Ct = Bt + TILE * LDN;
  static constexpr int Wt = Ct + TILE * LDN;     // [TILE][LDS] W, or G o L
  // [TILE][TILE + 1] E = G o W, then each row's exclusive prefix sums.
  static constexpr int Et = Wt + TILE * LDS;
  static constexpr int CP = Et + TILE * (TILE + 1);  // [4][TILE] column sums
  static constexpr int RED = CP + 4 * TILE;      // [THREADS / 32] sums
  static constexpr int FIXED = RED + THREADS / 32;
  static_assert(P <= TILE, "a state fits a tile's rows");
  static_assert(FIXED % 2 == 0, "the fp64 cumulative sums follow, aligned");
  static_assert(THREADS == 4 * TILE, "4 threads per row, 4 per column");
  // + cs [chunk] fp64, then dts, dcs, dap [chunk] fp32 each.
  static size_t bytes(int chunk) {
    return sizeof(float) * FIXED +
           (sizeof(double) + 3 * sizeof(float)) * static_cast<size_t>(chunk);
  }
};

// The 4 x 4 block (rows sy*4 + i, columns sx + 16*j) of D = Y X^T, Y and X
// [TILE][LDP].
template <int P>
__device__ __forceinline__ void dots(const float* Y, const float* X, int sy,
                                     int sx, float (&d)[4][4]) {
  constexpr int LDP = P + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < P; ++k) {
    float yv[4], xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) yv[i] = Y[(sy * 4 + i) * LDP + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = X[(sx + 16 * j) * LDP + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[i][j] = fmaf(yv[i], xv[j], d[i][j]);
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_chunk_kernel(Params p) {
  using Cfg = ChunkCfg<P, N>;
  constexpr int LDP = Cfg::LDP, LDN = Cfg::LDN;
  using MN = RowMap<N>;   // [TILE, N] results: dC, dB, S_in^T dy
  using MP = RowMap<P>;   // [TILE, P] results: w, dS_out B
  extern __shared__ float smem[];
  float* Xs = smem + Cfg::X;
  float* Ys = smem + Cfg::Y;
  float* Bs = smem + Cfg::Bt;
  float* Cs = smem + Cfg::Ct;
  float* Ws = smem + Cfg::Wt;
  float* Es = smem + Cfg::Et;
  float* cpart = smem + Cfg::CP;
  float* red = smem + Cfg::RED;
  double* cs = reinterpret_cast<double*>(smem + Cfg::FIXED);
  float* dts = reinterpret_cast<float*>(cs + p.chunk);
  float* dcs = dts + p.chunk;   // the state terms of d cs
  float* dap = dcs + p.chunk;   // the tile pairs' part of da
  constexpr int LDE = TILE + 1;

  const int tid = threadIdx.x, lane = tid % 32;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  const int n_tiles = (len + TILE - 1) / TILE;
  const float a = p.A[h];
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
               static_cast<int64_t>(c0) * p.x_ss;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  const int64_t row0 = static_cast<int64_t>(b) * p.S + c0;  // (b, c0) row
  const T* dy = static_cast<const T*>(p.dy) + row0 * y_ss + h * P;
  T* dx = static_cast<T*>(p.dx) + row0 * y_ss + h * P;
  const T* Bg = static_cast<const T*>(p.Bm) + b * p.b_sb +
                static_cast<int64_t>(c0) * p.b_ss;
  const T* Cg = static_cast<const T*>(p.Cm) + b * p.c_sb +
                static_cast<int64_t>(c0) * p.c_ss;
  const int64_t part_ss = static_cast<int64_t>(p.H) * N;
  float* dBp = p.dB_part + row0 * part_ss + h * N;
  float* dCp = p.dC_part + row0 * part_ss + h * N;
  const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  const float* S_in = p.states + bch * P * N;
  const float* dS_out = p.dstates + bch * P * N;
  const float* cb = p.cb + (static_cast<int64_t>(b) * p.nc + c) * p.QT *
                               p.QT * TILE * TILE;

  stage_cumsum(p.dt + b * p.dt_sb + h * p.dt_sh, p.dt_ss, c0, len, a, dts,
               cs);
  for (int i = tid; i < len; i += THREADS) dap[i] = 0.f;
  // ddt's row of this (row, chunk, head): x.w first, then da A + x.w.
  float* ddt = p.ddt + row0 * p.H + h;
  const double total = cs[len - 1];
  const int sx = tid % 16, sy = tid / 16;
  const int nxa = tid % MN::TX, nya = tid / MN::TX;
  const int pxa = tid % MP::TX, pya = tid / MP::TX;

  // ------------------------------------------- pass A: query tiles I
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // the previous tile's reads of Ys, Bs (S_in), Cs done
    load_rows<T, P>(Ys, LDP, dy + q0 * y_ss, y_ss, len - q0);
    float acc[MN::R][MN::C] = {};
    // This thread's row (tid / 4) of E summed over the earlier key tiles.
    float carry = 0.f;
    for (int kt = 0; kt <= qt; ++kt) {
      const int k0 = kt * TILE;
      __syncthreads();  // the previous key tile's Xs, Bs and Ws consumed
      load_rows<T, P>(Xs, LDP, x + k0 * p.x_ss, p.x_ss, len - k0);
      load_rows<T, N>(Bs, N, Bg + static_cast<int64_t>(k0) * p.b_ss, p.b_ss,
                      len - k0);
      __syncthreads();
      float d[4][4];
      dots<P>(Ys, Xs, sy, sx, d);
      const float* G = cb + (static_cast<int64_t>(qt) * p.QT + kt) * TILE *
                                TILE;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = sy * 4 + i, gi = q0 + ri;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cj = sx + 16 * j, gj = k0 + cj;
          float w = 0.f, e = 0.f;
          if (gj <= gi && gi < len) {
            w = exp_of(cs[gi] - cs[gj]) * dts[gj] * d[i][j];
            e = G[ri * TILE + cj] * w;
          }
          Ws[ri * LDS + cj] = w;
          Es[ri * LDE + cj] = e;
        }
      }
      __syncthreads();  // W and E written
      // dC_I += W B_J
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        float wv[MN::R], bv[MN::C];
#pragma unroll
        for (int r = 0; r < MN::R; ++r) wv[r] = Ws[(nya * MN::R + r) * LDS + j];
#pragma unroll
        for (int k = 0; k < MN::C; ++k) bv[k] = Bs[j * N + nxa + MN::TX * k];
#pragma unroll
        for (int r = 0; r < MN::R; ++r)
#pragma unroll
          for (int k = 0; k < MN::C; ++k) acc[r][k] = fmaf(wv[r], bv[k], acc[r][k]);
      }
      // The pairs' part of da_t = sum_{j < t <= i} E_ij, summed directly:
      // as a row sum of E less a column sum the two would cancel.  Each row
      // (4 threads of 16 columns) takes its exclusive prefix sums over j,
      // from `carry`; each column t then sums them over the rows i >= t.
      {
        float* er = Es + (tid / 4) * LDE + (tid % 4) * 16;
        float seg = 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) seg += er[k];
        float incl = seg;
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, incl, off, 4);
          if (tid % 4 >= off) incl += v;
        }
        float run = carry + incl - seg;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const float v = er[k];
          er[k] = run;
          run += v;
        }
        carry += __shfl_sync(0xffffffffu, incl, 3, 4);
      }
      __syncthreads();  // prefix sums written
      {
        const int t = tid % TILE, grp = tid / TILE;   // 16 rows a group
        float sum = 0.f;
#pragma unroll 4
        for (int r = 16 * grp; r < 16 * grp + 16; ++r) {
          const int gi = q0 + r;
          if (k0 + t <= gi && gi < len) sum += Es[r * LDE + t];
        }
        cpart[grp * TILE + t] = sum;
      }
      __syncthreads();  // column sums written
      if (tid < TILE && k0 + tid < len)
        dap[k0 + tid] += (cpart[tid] + cpart[TILE + tid]) +
                         (cpart[2 * TILE + tid] + cpart[3 * TILE + tid]);
    }
    __syncthreads();  // Bs and Ws consumed
    load_state<P, N>(Bs, LDN, S_in);
    load_rows<T, N>(Cs, N, Cg + static_cast<int64_t>(q0) * p.c_ss, p.c_ss,
                    len - q0);
    __syncthreads();
    // Z = dy_I S_in [TILE, N]: dC_I += exp(cs_i) Z_i, r_i = Z_i . C_i.
    float z[MN::R][MN::C] = {};
#pragma unroll 4
    for (int k = 0; k < P; ++k) {
      float yv[MN::R], sv[MN::C];
#pragma unroll
      for (int r = 0; r < MN::R; ++r) yv[r] = Ys[(nya * MN::R + r) * LDP + k];
#pragma unroll
      for (int m = 0; m < MN::C; ++m) sv[m] = Bs[k * LDN + nxa + MN::TX * m];
#pragma unroll
      for (int r = 0; r < MN::R; ++r)
#pragma unroll
        for (int m = 0; m < MN::C; ++m) z[r][m] = fmaf(yv[r], sv[m], z[r][m]);
    }
#pragma unroll
    for (int r = 0; r < MN::R; ++r) {
      const int ri = nya * MN::R + r, gi = q0 + ri;
      const float e = gi < len ? exp_of(cs[gi]) : 0.f;
      float part = 0.f;
#pragma unroll
      for (int m = 0; m < MN::C; ++m) {
        const int n = nxa + MN::TX * m;
        acc[r][m] = fmaf(e, z[r][m], acc[r][m]);
        part = fmaf(z[r][m], Cs[ri * N + n], part);
      }
      part = lane_sum<MN::TX>(part);
      if (gi < len) {
#pragma unroll
        for (int m = 0; m < MN::C; ++m)
          dCp[gi * part_ss + nxa + MN::TX * m] = acc[r][m];
        if (nxa == 0) dcs[gi] = e * part;
      }
    }
  }

  // ------------------------------------------- pass B: key tiles J
  float tq = 0.f;  // this thread's share of sum_j exp(total - cs_j) dt_j q_j
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's reads of Xs, Bs, Cs done
    load_rows<T, P>(Xs, LDP, x + k0 * p.x_ss, p.x_ss, len - k0);
    float accB[MN::R][MN::C] = {};
    float accU[MP::R][MP::C] = {};
    for (int qt = kt; qt < n_tiles; ++qt) {
      const int q0 = qt * TILE;
      __syncthreads();  // the previous query tile's Ys, Cs and Ws consumed
      load_rows<T, P>(Ys, LDP, dy + q0 * y_ss, y_ss, len - q0);
      load_rows<T, N>(Cs, N, Cg + static_cast<int64_t>(q0) * p.c_ss, p.c_ss,
                      len - q0);
      __syncthreads();
      float d[4][4];
      dots<P>(Ys, Xs, sy, sx, d);
      const float* G = cb + (static_cast<int64_t>(qt) * p.QT + kt) * TILE *
                                TILE;
      float gl[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = sy * 4 + i, gi = q0 + ri;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cj = sx + 16 * j, gj = k0 + cj;
          float l = 0.f, w = 0.f;
          if (gj <= gi && gi < len) {
            l = exp_of(cs[gi] - cs[gj]);
            w = l * dts[gj] * d[i][j];
            l *= G[ri * TILE + cj];
          }
          gl[i][j] = l;
          Ws[ri * LDS + cj] = w;
        }
      }
      __syncthreads();  // W written
      // dB_J += W^T C_I
#pragma unroll 4
      for (int i = 0; i < TILE; ++i) {
        float wv[MN::R], cv[MN::C];
#pragma unroll
        for (int r = 0; r < MN::R; ++r) wv[r] = Ws[i * LDS + nya * MN::R + r];
#pragma unroll
        for (int m = 0; m < MN::C; ++m) cv[m] = Cs[i * N + nxa + MN::TX * m];
#pragma unroll
        for (int r = 0; r < MN::R; ++r)
#pragma unroll
          for (int m = 0; m < MN::C; ++m)
            accB[r][m] = fmaf(wv[r], cv[m], accB[r][m]);
      }
      __syncthreads();  // W consumed
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ws[(sy * 4 + i) * LDS + sx + 16 * j] = gl[i][j];
      __syncthreads();  // G o L written
      // u_J += (G o L)^T dy_I
#pragma unroll 4
      for (int i = 0; i < TILE; ++i) {
        float mv[MP::R], yv[MP::C];
#pragma unroll
        for (int r = 0; r < MP::R; ++r) mv[r] = Ws[i * LDS + pya * MP::R + r];
#pragma unroll
        for (int m = 0; m < MP::C; ++m) yv[m] = Ys[i * LDP + pxa + MP::TX * m];
#pragma unroll
        for (int r = 0; r < MP::R; ++r)
#pragma unroll
          for (int m = 0; m < MP::C; ++m)
            accU[r][m] = fmaf(mv[r], yv[m], accU[r][m]);
      }
    }
    __syncthreads();  // Ys, Cs and Ws consumed
    load_state<P, N>(Bs, LDN, dS_out);
    load_rows<T, N>(Cs, N, Bg + static_cast<int64_t>(k0) * p.b_ss, p.b_ss,
                    len - k0);
    __syncthreads();
    // v = B_J dS_out^T [TILE, P]; w = u + exp(total - cs_j) v; dx = dt w;
    // x.w and x.v per row.
    float v[MP::R][MP::C] = {};
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float bv[MP::R], sv[MP::C];
#pragma unroll
      for (int r = 0; r < MP::R; ++r) bv[r] = Cs[(pya * MP::R + r) * N + n];
#pragma unroll
      for (int m = 0; m < MP::C; ++m) sv[m] = Bs[(pxa + MP::TX * m) * LDN + n];
#pragma unroll
      for (int r = 0; r < MP::R; ++r)
#pragma unroll
        for (int m = 0; m < MP::C; ++m) v[r][m] = fmaf(bv[r], sv[m], v[r][m]);
    }
#pragma unroll
    for (int r = 0; r < MP::R; ++r) {
      const int rj = pya * MP::R + r, gj = k0 + rj;
      const bool ok = gj < len;
      const float e = ok ? exp_of(total - cs[gj]) : 0.f;
      const float dtj = ok ? dts[gj] : 0.f;
      float pw = 0.f, pv = 0.f;
#pragma unroll
      for (int m = 0; m < MP::C; ++m) {
        const int col = pxa + MP::TX * m;
        const float xv = Xs[rj * LDP + col];
        const float w = fmaf(e, v[r][m], accU[r][m]);
        pw = fmaf(xv, w, pw);
        pv = fmaf(xv, v[r][m], pv);
        if (ok) dx[gj * y_ss + col] = from_float<T>(dtj * w);
      }
      pw = lane_sum<MP::TX>(pw);
      pv = lane_sum<MP::TX>(pv);
      if (ok && pxa == 0) {
        ddt[static_cast<int64_t>(gj) * p.H] = pw;
        const float q = e * dtj * pv;
        dcs[gj] -= q;
        tq += q;
      }
    }
    // dB_J += exp(total - cs_j) dt_j dS_out^T x_j.
    float s[MN::R][MN::C] = {};
#pragma unroll 4
    for (int k = 0; k < P; ++k) {
      float xv[MN::R], sv[MN::C];
#pragma unroll
      for (int r = 0; r < MN::R; ++r) xv[r] = Xs[(nya * MN::R + r) * LDP + k];
#pragma unroll
      for (int m = 0; m < MN::C; ++m) sv[m] = Bs[k * LDN + nxa + MN::TX * m];
#pragma unroll
      for (int r = 0; r < MN::R; ++r)
#pragma unroll
        for (int m = 0; m < MN::C; ++m) s[r][m] = fmaf(xv[r], sv[m], s[r][m]);
    }
#pragma unroll
    for (int r = 0; r < MN::R; ++r) {
      const int gj = k0 + nya * MN::R + r;
      if (gj >= len) continue;
      const float f = exp_of(total - cs[gj]) * dts[gj];
#pragma unroll
      for (int m = 0; m < MN::C; ++m)
        dBp[gj * part_ss + nxa + MN::TX * m] = fmaf(f, s[r][m], accB[r][m]);
    }
  }

  // ------------------------------------------- d total, ddt, dA
  // d total = exp(total) <S_in, dS_out> + sum_j exp(total - cs_j) dt_j q_j.
  float part = 0.f;
  for (int e = tid; e < P * N; e += THREADS) part = fmaf(S_in[e], dS_out[e], part);
  part = fmaf(exp_of(total), part, tq);
  part = lane_sum<32>(part);
  __syncthreads();  // dcs, dap and ddt's x.w complete; red free
  if (lane == 0) red[tid / 32] = part;
  __syncthreads();
  if (tid < 32) {
    float dtot = lane < THREADS / 32 ? red[lane] : 0.f;
    dtot = lane_sum<32>(dtot);
    // da = the reverse cumulative sum of dcs (+ d total on the last row),
    // in fp64 as the cumulative sums, plus the pairs' part: each lane takes
    // a contiguous segment; the segments' totals are summed from the right
    // by a shuffle scan.
    const int per = (len + 31) / 32;
    const int lo = min(lane * per, len), hi = min(lo + per, len);
    if (lane == 0) dcs[len - 1] += dtot;
    __syncwarp();
    double seg = 0.0;
    for (int i = lo; i < hi; ++i) seg += dcs[i];
    double incl = seg;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += v;
    }
    double run = incl - seg;   // the lanes to the right
    double da_dt = 0.0;
    for (int i = hi - 1; i >= lo; --i) {
      run += dcs[i];
      const float da = static_cast<float>(run + dap[i]);
      float* di = ddt + static_cast<int64_t>(i) * p.H;
      *di = fmaf(da, a, *di);   // x.w, written by pass B before the barrier
      da_dt += static_cast<double>(da) * dts[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      da_dt += __shfl_xor_sync(0xffffffffu, da_dt, off);
    if (lane == 0) p.dA_part[bch] = static_cast<float>(da_dt);
  }
}

// ---------------------------------------------------------------- step 4

// dBm and dCm of rows (b, s): the heads' partials summed in order.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce_kernel(Params p) {
  constexpr int ROWS = THREADS / N;
  static_assert(THREADS % N == 0, "rows per block");
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ROWS +
                      threadIdx.x / N;
  const int n = threadIdx.x % N;
  if (row >= static_cast<int64_t>(p.B) * p.S) return;
  const float* pb = p.dB_part + row * p.H * N + n;
  const float* pc = p.dC_part + row * p.H * N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < p.H; ++h) {
    sb += pb[h * N];
    sc += pc[h * N];
  }
  static_cast<T*>(p.dBm)[row * N + n] = from_float<T>(sb);
  static_cast<T*>(p.dCm)[row * N + n] = from_float<T>(sc);
}

// ---------------------------------------------------------------- step 5

__global__ void __launch_bounds__(THREADS) ssd_bwd_dA_kernel(Params p) {
  for (int h = threadIdx.x; h < p.H; h += THREADS) {
    double s = 0.0;
    for (int i = 0; i < p.B * p.nc; ++i) s += p.dA_part[i * p.H + h];
    p.dA[h] = static_cast<float>(s);
  }
}

// Scratch of one call, carved from the caller's workspace.
struct BwdWorkspace {
  size_t cb, states, dstates, totals, dA_part, dB_part, dC_part, bytes;
};

inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

inline BwdWorkspace bwd_workspace_layout(int B, int S, int H, int P, int N,
                                         int chunk) {
  const size_t nc = (S + chunk - 1) / chunk, qt = (chunk + TILE - 1) / TILE;
  const size_t f = sizeof(float);
  BwdWorkspace w;
  w.cb = 0;
  w.states = w.cb + align256(f * B * nc * qt * qt * TILE * TILE);
  w.dstates = w.states + align256(f * B * nc * H * P * N);
  w.totals = w.dstates + align256(f * B * nc * H * P * N);
  w.dA_part = w.totals + align256(f * B * nc * H);
  w.dB_part = w.dA_part + align256(f * B * nc * H);
  w.dC_part = w.dB_part + align256(f * B * S * H * N);
  w.bytes = w.dC_part + f * B * S * H * N;
  return w;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int P, int N>
int launch(const Params& p, cudaStream_t stream) {
  const size_t s_cb = sizeof(float) * 2 * TILE * (N + 1);
  const size_t s_state =
      sizeof(float) * (2 * TILE * P + 2 * TILE * (N + 1)) +
      (sizeof(double) + sizeof(float)) * static_cast<size_t>(p.chunk);
  const size_t s_chunk = ChunkCfg<P, N>::bytes(p.chunk);
  int err = set_smem(ssd_bwd_cb_kernel<T, N>, s_cb);
  if (!err) err = set_smem(ssd_bwd_state_kernel<T, P, N>, s_state);
  if (!err) err = set_smem(ssd_bwd_chunk_kernel<T, P, N>, s_chunk);
  if (err) return err;
  ssd_bwd_cb_kernel<T, N><<<dim3(p.QT, p.nc, p.B), THREADS, s_cb, stream>>>(p);
  ssd_bwd_state_kernel<T, P, N>
      <<<dim3(p.H, p.nc, p.B), THREADS, s_state, stream>>>(p);
  constexpr int PN = P * N;
  ssd_bwd_pass_kernel<<<dim3((PN + THREADS - 1) / THREADS, p.H, p.B), THREADS,
                        0, stream>>>(p, PN);
  ssd_bwd_chunk_kernel<T, P, N>
      <<<dim3(p.H, p.nc, p.B), THREADS, s_chunk, stream>>>(p);
  constexpr int ROWS = THREADS / N;
  const int64_t rows = static_cast<int64_t>(p.B) * p.S;
  ssd_bwd_reduce_kernel<T, N><<<static_cast<unsigned>((rows + ROWS - 1) / ROWS),
                                THREADS, 0, stream>>>(p);
  ssd_bwd_dA_kernel<<<1, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The (head_dim, state) pairs built: the forward's (ssd_scan.SHAPES).
template <typename T>
int launch_shape(const Params& p, int P, int N, cudaStream_t stream) {
  if (P == 16 && N == 16) return launch<T, 16, 16>(p, stream);
  if (P == 32 && N == 64) return launch<T, 32, 64>(p, stream);
  if (P == 64 && N == 128) return launch<T, 64, 128>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm, dy and dx, dBm, dCm).
// strides: 10 element strides, x (batch, sequence, head), dt (batch,
// sequence, head), Bm (batch, sequence) and Cm (batch, sequence).  init,
// dfinal and dinit may be null.  workspace: 256-byte aligned scratch of at
// least BwdWorkspace::bytes.  Returns the CUDA error of the launches (0 on
// success); launches on `stream` and does not synchronise.
extern "C" int ssd_scan_bwd(int dtype, const void* x, const float* dt,
                            const float* A, const void* Bm, const void* Cm,
                            const float* init, const void* dy,
                            const float* dfinal, void* dx, float* ddt,
                            float* dA, void* dBm, void* dCm, float* dinit,
                            int B, int S, int H, int P, int N, int chunk,
                            const int64_t* strides, void* workspace,
                            int64_t workspace_bytes, void* stream) {
  const BwdWorkspace w = bwd_workspace_layout(B, S, H, P, N, chunk);
  if (workspace == nullptr || static_cast<size_t>(workspace_bytes) < w.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(workspace);
  Params p{x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dBm, dCm, dinit,
           B, S, H, chunk, (S + chunk - 1) / chunk, (chunk + TILE - 1) / TILE,
           strides[0], strides[1], strides[2],
           strides[3], strides[4], strides[5],
           strides[6], strides[7],
           strides[8], strides[9],
           reinterpret_cast<float*>(base + w.cb),
           reinterpret_cast<float*>(base + w.states),
           reinterpret_cast<float*>(base + w.dstates),
           reinterpret_cast<float*>(base + w.totals),
           reinterpret_cast<float*>(base + w.dA_part),
           reinterpret_cast<float*>(base + w.dB_part),
           reinterpret_cast<float*>(base + w.dC_part)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_shape<float>(p, P, N, s);
    case 1: return launch_shape<__nv_bfloat16>(p, P, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
