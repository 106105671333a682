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
// The C entry point picks the kernels by dtype.  This is not a fallback:
// each dtype has its own kernels and nothing reaches the other's.
//
// float32 -- six CUDA-core kernels per call, on the caller's stream, over
// the caller's workspace (BwdWorkspace below):
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
// Every product is fp32 on the CUDA cores (fmaf): TF32 or bf16 products
// would not hold float32's tolerance.
//
// bfloat16 -- every product on the tensor cores (wgmma, with the forward's
// tools: csrc/flash_mma.cuh's swizzled tiles, descriptors and cp.async),
// seven kernels per call over the caller's workspace (TcWorkspace below):
//   0. ssd_bwd_local_kernel, one block per (head, chunk, row): the chunk's
//      cumulative sum in fp64, written with dt to scratch in 64-row tiles
//      (so no later kernel keeps a chunk's rows in shared memory), its
//      total, its local state sum_j (dt_j e^{total-cs_j} x_j)^T B_j and its
//      local d(state) sum_i (e^{cs_i} dy_i)^T C_i, as the forward's
//      ssd_chunk_state_kernel: the weighted rows split hi/lo into A
//      fragments, B and C read MN-major.  They cannot be fused into the
//      chunk kernels, which need every chunk's state pass first;
//   1. ssd_bwd_states_kernel, as the forward's ssd_state_pass_kernel: one
//      thread per 8 entries of a (row, head)'s state, 16-byte loads,
//      batches of chunks.  In reverse it writes the fp32 d(state) leaving
//      each chunk over the local d(state) and ends in d(initial state);
//      forward it writes the state entering each chunk as hi/lo bf16 over
//      the local state, and the d(state) as hi/lo over itself, and sums
//      <S_in, dS_out> per chunk from both in fp32 (a fixed-order block
//      sum, partials per block of the pass);
//   2. ssd_bwd_dc_kernel, one block per (group of HG heads, chunk, row),
//      walking (query tile I, key tile J <= I, head): G = C_I B_J^T once
//      per tile pair for the group, D = dy_I x_J^T per head (bf16 tiles,
//      exact products, fp32 sums), W = L o dt_j o D in registers with the
//      decay formed only where j <= i, E = G o W and the pairs' part of da
//      from E's row prefix sums (fp32, CUDA cores, the stable form), and
//      W summed over the group's heads before one product W B_J -> dC
//      (hi/lo A fragments, B_J MN-major): B and C are the heads' own, so
//      dC's pairs' term is a sum over heads of W.  G and W's head sum
//      wait in shared memory, so that dC and the step's tile keep the
//      registers without a spill;
//   3. ssd_bwd_dcs_kernel, one block per (head group x query tile, chunk,
//      row): Z = dy_I S_in per head (dy K-major, S_in hi/lo MN-major), the
//      carried state's part of dcs e^{cs_i} Z_i . C_i, and dC +=
//      sum_h e^{cs_i} Z into the group's partial.  Apart from step 2, as
//      S_in's two stages would leave step 2 one block per SM;
//   4. ssd_bwd_db_kernel, one block per (head group, chunk, row), walking
//      (key tile J, head, query tile I >= J): the transposed tiles formed
//      directly, G^T = B_J C_I^T and D^T = x_J dy_I^T (a register A
//      fragment has no cheap transpose, and keeping both orientations
//      through shared memory would cost a store and a barrier per tile
//      pair for what two small products give), W^T and (G o L)^T split
//      hi/lo for dB += W^T C_I and u += (G o L)^T dy_I, one product at a
//      time (dB and u hold 96 registers throughout); then per (J,
//      head) v = B_J dS_out^T (dS_out hi/lo), dx, x.w, the leaving state's
//      part of dcs, and dB += (e^{total-cs_j} dt_j x_J) dS_out (both split)
//      into the group's partial; last, one warp per head, d total, da
//      (the reverse cumulative sum in fp64), ddt and the chunk's share of
//      dA;
//   5. ssd_bwd_reduce_kernel: dB and dC summed over the head groups' fp32
//      partials [B, S, ceil(H / HG), N] in order;
//   6. ssd_bwd_dA_kernel, as for float32.
// Each tensor-core block is one warpgroup; its tiles arrive by 16-byte
// cp.async one step ahead in a two-stage ring.  An fp32 operand (the
// weighted rows of the local states, W, G o L, S_in, dS_out) is split into
// hi = bf16(v) and lo = bf16(v - hi), two products into one fp32
// accumulator (~16 bits), as in the forward: one bf16 rounding of W or
// G o L misses ddt's and dA's 1e-3 (kernels/ssd_scan.py's
// ssd_scan_bwd_phases mirrors both, with rounding="hi_lo" or "bf16").
// The loads need 16-byte aligned rows (the launcher checks).
//
// Both dtypes: no atomics, two calls give bit-equal results; ddt, dA and
// d(initial state) are fp32; the cumulative sums of dt*A, their reverse
// (da) and the sums into dA run in fp64 (chunk_cumsum says why), and every
// exp is taken of a difference of them, never of a cumulative sum alone
// above the diagonal.
//
// Bound.  At mamba2-370m's train shape (B 4, S 4096, H 32, P 64, N 128,
// chunk 256, bf16) the function reads x, dy, B, C, dt (145 MB) and writes
// dx, dB, dC, ddt (78 MB): 222 MB, ~66 us at the memory rate.  It needs
// ~95 GFLOP (dy.x, W.B, W^T.C and (G o L)^T.dy over the causal pairs, five
// [P, N] products per row and head: the local state and d(state), S_in^T
// dy, dS_out B, dS_out^T x), ~96 us at the bf16 tensor-core rate, so
// operations bound it.  The bf16 design executes about twice that on the
// tensor cores (the hi/lo splits, D in both orientations, G^T recomputed
// per head) and moves its scratch besides: the two [B, nc, H, P, N] fp32
// states (67 MB each, written, read and rewritten, then read by steps 3
// and 4) and the head groups' partial dB and dC (34 MB each).  Each block
// waits on its own products and loads in turn, two blocks to an SM (shared
// memory): TMA loads, warp specialisation and a deeper pipeline are what
// remain (ROADMAP B').
//
// Layout: x [B, S, H, P], Bm and Cm [B, S, N] through their own
// batch/sequence(/head) strides with the last dimension contiguous (the
// model's slices of its conv output); dt [B, S, H] fp32 by strides; A [H];
// dy, dx [B, S, H, P], dBm, dCm [B, S, N], ddt [B, S, H], the initial
// state, d(final state) and d(initial state) [B, H, P, N], all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_mma.cuh"
#include "ssd_mma.cuh"

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
  float* dB_part;  // [B, S, H, N]; bf16: [B, S, G, N], by head group
  float* dC_part;  // [B, S, H, N]; bf16: [B, S, G, N]
  // bf16 only (TcWorkspace): per (row, head, chunk), QTR = QT * TILE rows
  // (the chunk's rows padded to whole tiles, zero past the chunk).
  double* cs;      // [B, H, nc, QTR] cumulative sums of dt*A
  float* dtp;      // [B, H, nc, QTR] dt
  float* dcs;      // [B, H, nc, QTR] the carried state's part of d cs
  float* dap;      // [B, H, nc, QTR] the pairs' part of da
  float* qv;       // [B, H, nc, QTR] the leaving state's part of d cs, negated
  float* dots;     // [B, nc, H, NPB] <S_in, dS_out> by block of the pass
  int G, QTR, NPB; // head groups, padded chunk rows, blocks of the pass
};

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
template <int W>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int64_t row_stride, int n_rows) {
  for (int i = threadIdx.x; i < TILE * W; i += THREADS) {
    const int r = i / W, c = i % W;
    dst[r * ld + c] = r < n_rows ? src[r * row_stride + c] : 0.f;
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
  for (int i = threadIdx.x; i < len; i += blockDim.x)
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

template <int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_cb_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int LDN = N + 1;
  float* Cs = smem;                // [TILE][LDN]: C rows of the query tile
  float* Bs = Cs + TILE * LDN;     // [TILE][LDN]: B rows of the key tile
  const int qt = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  const int q0 = qt * TILE;
  if (q0 >= len) return;  // a partial last chunk has fewer tiles
  const float* Cg = static_cast<const float*>(p.Cm) + b * p.c_sb +
                static_cast<int64_t>(c0 + q0) * p.c_ss;
  const float* Bg = static_cast<const float*>(p.Bm) + b * p.b_sb +
                static_cast<int64_t>(c0) * p.b_ss;
  float* out = p.cb + ((static_cast<int64_t>(b) * p.nc + c) * p.QT + qt) *
                          p.QT * TILE * TILE;
  load_rows<N>(Cs, LDN, Cg, p.c_ss, len - q0);
  const int sx = threadIdx.x % 16, sy = threadIdx.x / 16;
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // the previous key tile is consumed (and Cs written)
    load_rows<N>(Bs, LDN, Bg + static_cast<int64_t>(kt) * TILE * p.b_ss,
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

template <int P, int N>
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
  const float* x = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh +
               static_cast<int64_t>(c0) * p.x_ss;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  const float* dy = static_cast<const float*>(p.dy) +
                (static_cast<int64_t>(b) * p.S + c0) * y_ss + h * P;
  const float* Bg = static_cast<const float*>(p.Bm) + b * p.b_sb +
                static_cast<int64_t>(c0) * p.b_ss;
  const float* Cg = static_cast<const float*>(p.Cm) + b * p.c_sb +
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
        xv = x[t * p.x_ss + col] * dts[t] * exp_of(total - cs[t]);
        yv = dy[t * y_ss + col] * exp_of(cs[t]);
      }
      Xs[i] = xv;
      Ys[i] = yv;
    }
    load_rows<N>(Bs, LDN, Bg + static_cast<int64_t>(k0) * p.b_ss, p.b_ss,
                    n_rows);
    load_rows<N>(Cs, LDN, Cg + static_cast<int64_t>(k0) * p.c_ss, p.c_ss,
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

template <int P, int N>
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
  const float* x = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh +
               static_cast<int64_t>(c0) * p.x_ss;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  const int64_t row0 = static_cast<int64_t>(b) * p.S + c0;  // (b, c0) row
  const float* dy = static_cast<const float*>(p.dy) + row0 * y_ss + h * P;
  float* dx = static_cast<float*>(p.dx) + row0 * y_ss + h * P;
  const float* Bg = static_cast<const float*>(p.Bm) + b * p.b_sb +
                static_cast<int64_t>(c0) * p.b_ss;
  const float* Cg = static_cast<const float*>(p.Cm) + b * p.c_sb +
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
    load_rows<P>(Ys, LDP, dy + q0 * y_ss, y_ss, len - q0);
    float acc[MN::R][MN::C] = {};
    // This thread's row (tid / 4) of E summed over the earlier key tiles.
    float carry = 0.f;
    for (int kt = 0; kt <= qt; ++kt) {
      const int k0 = kt * TILE;
      __syncthreads();  // the previous key tile's Xs, Bs and Ws consumed
      load_rows<P>(Xs, LDP, x + k0 * p.x_ss, p.x_ss, len - k0);
      load_rows<N>(Bs, N, Bg + static_cast<int64_t>(k0) * p.b_ss, p.b_ss,
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
    load_rows<N>(Cs, N, Cg + static_cast<int64_t>(q0) * p.c_ss, p.c_ss,
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
    load_rows<P>(Xs, LDP, x + k0 * p.x_ss, p.x_ss, len - k0);
    float accB[MN::R][MN::C] = {};
    float accU[MP::R][MP::C] = {};
    for (int qt = kt; qt < n_tiles; ++qt) {
      const int q0 = qt * TILE;
      __syncthreads();  // the previous query tile's Ys, Cs and Ws consumed
      load_rows<P>(Ys, LDP, dy + q0 * y_ss, y_ss, len - q0);
      load_rows<N>(Cs, N, Cg + static_cast<int64_t>(q0) * p.c_ss, p.c_ss,
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
    load_rows<N>(Cs, N, Bg + static_cast<int64_t>(k0) * p.b_ss, p.b_ss,
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
        if (ok) dx[gj * y_ss + col] = dtj * w;
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

// dBm and dCm of rows (b, s): the `parts` partials of each row (float32:
// one per head; bf16: one per head group) summed in order.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce_kernel(Params p,
                                                                 int parts) {
  constexpr int ROWS = THREADS / N;
  static_assert(THREADS % N == 0, "rows per block");
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ROWS +
                      threadIdx.x / N;
  const int n = threadIdx.x % N;
  if (row >= static_cast<int64_t>(p.B) * p.S) return;
  const float* pb = p.dB_part + row * parts * N + n;
  const float* pc = p.dC_part + row * parts * N + n;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < parts; ++k) {
    sb += pb[k * N];
    sc += pc[k * N];
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

template <int P, int N>
int launch(const Params& p, cudaStream_t stream) {
  const size_t s_cb = sizeof(float) * 2 * TILE * (N + 1);
  const size_t s_state =
      sizeof(float) * (2 * TILE * P + 2 * TILE * (N + 1)) +
      (sizeof(double) + sizeof(float)) * static_cast<size_t>(p.chunk);
  const size_t s_chunk = ChunkCfg<P, N>::bytes(p.chunk);
  int err = set_smem(ssd_bwd_cb_kernel<N>, s_cb);
  if (!err) err = set_smem(ssd_bwd_state_kernel<P, N>, s_state);
  if (!err) err = set_smem(ssd_bwd_chunk_kernel<P, N>, s_chunk);
  if (err) return err;
  ssd_bwd_cb_kernel<N><<<dim3(p.QT, p.nc, p.B), THREADS, s_cb, stream>>>(p);
  ssd_bwd_state_kernel<P, N>
      <<<dim3(p.H, p.nc, p.B), THREADS, s_state, stream>>>(p);
  constexpr int PN = P * N;
  ssd_bwd_pass_kernel<<<dim3((PN + THREADS - 1) / THREADS, p.H, p.B), THREADS,
                        0, stream>>>(p, PN);
  ssd_bwd_chunk_kernel<P, N>
      <<<dim3(p.H, p.nc, p.B), THREADS, s_chunk, stream>>>(p);
  constexpr int ROWS = THREADS / N;
  const int64_t rows = static_cast<int64_t>(p.B) * p.S;
  ssd_bwd_reduce_kernel<float, N><<<static_cast<unsigned>((rows + ROWS - 1) / ROWS),
                                THREADS, 0, stream>>>(p, p.H);
  ssd_bwd_dA_kernel<<<1, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ bfloat16, tensor cores

namespace fm = flash_mma;

constexpr int WG = 128;          // one warpgroup per tensor-core block
constexpr int HG = 8;            // heads whose dB and dC one block sums
constexpr int PASS_THREADS = 256;
constexpr int PASS_BATCH = 4;    // chunks whose loads step 1 issues together

using ssd_mma::c_to_a_split;
using ssd_mma::load_state_split;
using ssd_mma::split2;
using ssd_mma::zero;

// d (+)= A B, m64nNk16, A K-major and B MN-major in shared memory (a
// state's [P][N] tile read as the [K = P][N] operand); fm::wgmma_ss reads
// both K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss_bmn(float (&d)[N / 8][4], uint64_t a,
                                             uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss_bmn<64>(float (&d)[8][4], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_ss_bmn<128>(float (&d)[16][4],
                                                  uint64_t a, uint64_t b,
                                                  int accumulate) {
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
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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

__device__ __forceinline__ void mma_done() {
  fm::wgmma_commit();
  fm::wgmma_wait<0>();
}

template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) fm::fence_operand(a[kk]);
}

// Two consecutive bf16 (c even) of row `row` of a swizzled [ROWS][HD] tile,
// as floats.
template <int ROWS, int HD>
__device__ __forceinline__ float2 pair_at(const fm::bf16* tile, int row,
                                          int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      tile + fm::Tile<ROWS, HD>::at(row, c >> 3) + (c & 7)));
}

// fm::load_tile with its loop kept rolled: issued where the accumulators
// hold most registers, an unrolled loop's addresses, computed ahead, would
// spill them.
template <int ROWS, int HD, int HDP>
__device__ __forceinline__ void load_tile_rolled(fm::bf16* dst,
                                                 const fm::bf16* src,
                                                 int64_t stride, int row0,
                                                 int n_rows) {
  constexpr int CH = HDP / 8;
#pragma unroll 1
  for (int i = threadIdx.x; i < ROWS * CH; i += WG) {
    const int r = i / CH, c = i % CH, row = row0 + r;
    const bool ok = row < n_rows && c < HD / 8;
    fm::cp_async16(dst + fm::Tile<ROWS, HDP>::at(r, c),
                   src + (ok ? static_cast<int64_t>(row) * stride + c * 8 : 0),
                   ok);
  }
}

// `bytes` (a multiple of 16) of a padded per-row scratch array into shared
// memory by 16-byte cp.async.
__device__ __forceinline__ void load_row_tile(void* dst, const void* src,
                                              int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    fm::cp_async16(static_cast<char*>(dst) + 16 * i,
                   static_cast<const char*>(src) + 16 * i, true);
}

// Offset of chunk c's row 0 for (row b, head h) in the padded per-row
// scratch.
__device__ __forceinline__ int64_t row_base(const Params& p, int b, int h,
                                            int c) {
  return ((static_cast<int64_t>(b) * p.H + h) * p.nc + c) * p.QTR;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int align1k(int n) { return (n + 1023) / 1024 * 1024; }

template <int P, int N>
struct TcCfg {
  static constexpr int PP = fm::tile_hd(P);  // P as the tiles hold it
  static constexpr int NP = fm::tile_hd(N);  // N as the tiles hold it
  static_assert(PP == 64, "one warpgroup of 64 rows covers P");
  static constexpr int XT = 2 * TILE * PP;     // bytes of a [TILE][PP] tile
  static constexpr int NT = 2 * TILE * NP;     // bytes of a [TILE][NP] tile
  static constexpr int STT = 2 * PP * NP;    // bytes of a [PP][NP] tile
  // Step 0: x (dy) and B (C) tiles in two stages; then cs (fp64), dt and
  // the weights by chunk row.
  static constexpr int LOCAL = 2 * (XT + NT);
  // Step 2: C_I, B_J; two stages of dy_I, x_J, cs_I, cs_J (fp64) and
  // dt_J; G = C_I B_J^T and W's sum over heads in accumulator order, column
  // sums [2][4][TILE] and row carries [HG][TILE] (fp32).
  static constexpr int DC_STAGE = align1k(2 * XT + 2 * 8 * TILE + 4 * TILE);
  static constexpr int DC =
      2 * NT + 2 * DC_STAGE + 4 * (2 * TILE * TILE + 8 * TILE + HG * TILE);
  // Step 3: C_I; two stages of dy_I, S_in hi and lo, cs_I.
  static constexpr int DCS_STAGE = align1k(XT + 2 * STT + 8 * TILE);
  static constexpr int DCS = NT + 2 * DCS_STAGE;
  // Step 4: B_J; x_J in two stages (by (J, head)); the dx tile; two stages
  // of either (C_I, dy_I, cs_I) or (dS_out hi and lo); cs_J and dt_J in
  // two stages, with x_J.
  static constexpr int DB_STAGE = align1k(
      NT + XT + 8 * TILE > 2 * STT ? NT + XT + 8 * TILE : 2 * STT);
  static constexpr int DB = NT + 3 * XT + 2 * DB_STAGE + 2 * 12 * TILE;
};

// ---------------------------------------------------------------- step 0

// acc = sum_j (w_j a_j)^T b_j over rows [0, len): a [len, P] and b [len, N]
// bf16 rows (a_ss, b_ss apart), w fp32 in shared memory.  wgmma over 64-row
// tiles arriving in two stages (As, Bs), the weighted a split into hi and
// lo A fragments (rows p, reduction over j), b read MN-major: as
// csrc/ssd_scan.cu's ssd_chunk_state_kernel.  Its first barrier publishes
// w; it ends in a barrier.
template <int P, int N>
__device__ __forceinline__ void weighted_outer(
    float (&acc)[TcCfg<P, N>::NP / 8][4], fm::bf16* As, fm::bf16* Bs,
    const fm::bf16* a, int64_t a_ss, const fm::bf16* bm, int64_t b_ss,
    const float* w, int len) {
  constexpr int PP = TcCfg<P, N>::PP, NP = TcCfg<P, N>::NP;
  using AT = fm::Tile<TILE, PP>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = 16 * warp + g;
  const int n_tiles = (len + TILE - 1) / TILE;
  zero(acc);
  fm::load_tile<TILE, P, WG, PP>(As, a, a_ss, 0, len);
  fm::load_tile<TILE, N, WG, NP>(Bs, bm, b_ss, 0, len);
  fm::cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      fm::load_tile<TILE, P, WG, PP>(As + (st ^ 1) * TILE * PP, a, a_ss,
                                   (kt + 1) * TILE, len);
      fm::load_tile<TILE, N, WG, NP>(Bs + (st ^ 1) * TILE * NP, bm, b_ss,
                                   (kt + 1) * TILE, len);
    }
    fm::cp_async_commit();
    fm::cp_async_wait<1>();
    fm::fence_async_smem();
    __syncthreads();
    const fm::bf16* At = As + st * TILE * PP;
    uint32_t a_hi[TILE / 16][4], a_lo[TILE / 16][4];
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      float v[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 16 * kk + 2 * t + (q & 1) + 8 * (q >> 1);
        const int jc = kt * TILE + j;
        const float wj = jc < len ? w[jc] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pr = p0 + 8 * r;
          v[r][q] = __bfloat162float(At[AT::at(j, pr >> 3) + (pr & 7)]) * wj;
        }
      }
      split2(v[0][0], v[0][1], a_hi[kk][0], a_lo[kk][0]);
      split2(v[1][0], v[1][1], a_hi[kk][1], a_lo[kk][1]);
      split2(v[0][2], v[0][3], a_hi[kk][2], a_lo[kk][2]);
      split2(v[1][2], v[1][3], a_hi[kk][3], a_lo[kk][3]);
    }
    const fm::bf16* Bt = Bs + st * TILE * NP;
    fm::fence_operand(acc);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      fm::wgmma_rs<NP>(acc, a_hi[kk], fm::desc_mn<TILE>(Bt, kk), 1);
      fm::wgmma_rs<NP>(acc, a_lo[kk], fm::desc_mn<TILE>(Bt, kk), 1);
    }
    mma_done();
    fm::fence_operand(acc);
    fence_frags(a_hi);
    fence_frags(a_lo);
    __syncthreads();  // stage st consumed before it is loaded again
  }
}

// acc (j, e) is state row p0 + 8 (e >> 1), column 8j + 2t + (e & 1).
template <int P, int N>
__device__ __forceinline__ void store_state(
    float* dst, const float (&acc)[TcCfg<P, N>::NP / 8][4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int p0 = 16 * (threadIdx.x / 32) + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pr = p0 + 8 * r;
    if (pr >= P) continue;
#pragma unroll
    for (int j = 0; j < TcCfg<P, N>::NP / 8; ++j) {
      const int n = 8 * j + 2 * t;
      if (n < N)
        *reinterpret_cast<float2*>(dst + pr * N + n) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// Step 0, one (head, chunk, row): cs (fp64) and dt into the padded scratch,
// the chunk's total, its local state and its local d(state).
template <int P, int N>
__global__ void __launch_bounds__(WG) ssd_bwd_local_kernel(Params p) {
  using Cfg = TcCfg<P, N>;
  extern __shared__ __align__(1024) uint4 smem_tiles[];
  char* base = reinterpret_cast<char*>(smem_tiles);
  fm::bf16* As = reinterpret_cast<fm::bf16*>(base);                // [2][TILE][PP]
  fm::bf16* Bs = reinterpret_cast<fm::bf16*>(base + 2 * Cfg::XT);  // [2][TILE][NP]
  double* cs = reinterpret_cast<double*>(base + Cfg::LOCAL);       // [chunk]
  float* dts = reinterpret_cast<float*>(cs + p.chunk);             // [chunk]
  float* w = dts + p.chunk;                                        // [chunk]

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  const fm::bf16* x = static_cast<const fm::bf16*>(p.x) + b * p.x_sb +
                      h * p.x_sh + static_cast<int64_t>(c0) * p.x_ss;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  const fm::bf16* dy = static_cast<const fm::bf16*>(p.dy) +
                       (static_cast<int64_t>(b) * p.S + c0) * y_ss + h * P;
  const fm::bf16* Bg = static_cast<const fm::bf16*>(p.Bm) + b * p.b_sb +
                       static_cast<int64_t>(c0) * p.b_ss;
  const fm::bf16* Cg = static_cast<const fm::bf16*>(p.Cm) + b * p.c_sb +
                       static_cast<int64_t>(c0) * p.c_ss;
  stage_cumsum(p.dt + b * p.dt_sb + h * p.dt_sh, p.dt_ss, c0, len, p.A[h],
               dts, cs);
  const double total = cs[len - 1];
  const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  if (threadIdx.x == 0) p.totals[bch] = static_cast<float>(total);
  const int64_t rb = row_base(p, b, h, c);
  for (int r = threadIdx.x; r < p.QTR; r += WG) {
    p.cs[rb + r] = r < len ? cs[r] : 0.0;
    p.dtp[rb + r] = r < len ? dts[r] : 0.f;
  }
  for (int i = threadIdx.x; i < len; i += WG)
    w[i] = dts[i] * exp_of(total - cs[i]);  // dt_j exp(total - cs_j)
  float acc[Cfg::NP / 8][4];
  weighted_outer<P, N>(acc, As, Bs, x, p.x_ss, Bg, p.b_ss, w, len);
  store_state<P, N>(p.states + bch * P * N, acc);
  for (int i = threadIdx.x; i < len; i += WG) w[i] = exp_of(cs[i]);
  weighted_outer<P, N>(acc, As, Bs, dy, y_ss, Cg, p.c_ss, w, len);
  store_state<P, N>(p.dstates + bch * P * N, acc);
}

// ---------------------------------------------------------------- step 1

__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 c = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}
__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
// 8 fp32 entries as 8 hi then 8 lo bf16, in the same 32 bytes.
__device__ __forceinline__ void store8_split(float* dst, const float (&v)[8]) {
  uint4 hi, lo;
  split2(v[0], v[1], hi.x, lo.x);
  split2(v[2], v[3], hi.y, lo.y);
  split2(v[4], v[5], hi.z, lo.z);
  split2(v[6], v[7], hi.w, lo.w);
  reinterpret_cast<uint4*>(dst)[0] = hi;
  reinterpret_cast<uint4*>(dst)[1] = lo;
}

// Step 1: thread gi of (head h, row b) owns entries [8 gi, 8 gi + 8) of
// every chunk's [P, N] state.  In reverse, running = d(final state) or 0;
// the gradient of the state leaving chunk c is written (fp32) over its
// local d(state), running = running * exp(total_c) + local d(state); the
// end is d(initial state).  Forward, running = initial state or 0; the
// state entering chunk c is written as hi/lo over its local state, the
// leaving gradient as hi/lo over itself, and <S_in, dS_out> of the block's
// entries, from both in fp32, summed in a fixed order into dots.  Chunks in
// batches of PASS_BATCH: a batch's loads are issued before its first store.
__global__ void __launch_bounds__(PASS_THREADS) ssd_bwd_states_kernel(
    Params p, int PN) {
  __shared__ float red[PASS_BATCH][PASS_THREADS / 32];
  const int gi = blockIdx.x * PASS_THREADS + threadIdx.x;
  const bool on = 8 * gi < PN;  // threads past the state only join barriers
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t own = (static_cast<int64_t>(b) * p.H + h) * PN + 8 * gi;
  const int64_t step = static_cast<int64_t>(p.H) * PN;  // one chunk
  const int64_t at0 = (static_cast<int64_t>(b) * p.nc * p.H + h) * PN + 8 * gi;
  const float* tot = p.totals + static_cast<int64_t>(b) * p.nc * p.H + h;
  float run[8];
  if (on && p.dfinal) {
    load8(p.dfinal + own, run);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) run[e] = 0.f;
  }
  for (int c1 = p.nc - 1; c1 >= 0; c1 -= PASS_BATCH) {
    float loc[PASS_BATCH][8], decay[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (c1 - k < 0) break;
      if (on) load8(p.dstates + at0 + (c1 - k) * step, loc[k]);
      decay[k] = tot[(c1 - k) * p.H];
    }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (c1 - k < 0 || !on) break;
      store8(p.dstates + at0 + (c1 - k) * step, run);
      const float d = expf(decay[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) run[e] = run[e] * d + loc[k][e];
    }
  }
  if (on && p.dinit) store8(p.dinit + own, run);

  if (on && p.init) {
    load8(p.init + own, run);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) run[e] = 0.f;
  }
  for (int c0 = 0; c0 < p.nc; c0 += PASS_BATCH) {
    const int kn = min(PASS_BATCH, p.nc - c0);
    float loc[PASS_BATCH][8], ds[PASS_BATCH][8], decay[PASS_BATCH];
    float dot[PASS_BATCH] = {};
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (k >= kn) break;
      if (on) {
        load8(p.states + at0 + (c0 + k) * step, loc[k]);
        load8(p.dstates + at0 + (c0 + k) * step, ds[k]);
      }
      decay[k] = tot[(c0 + k) * p.H];
    }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (k >= kn || !on) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot[k] = fmaf(run[e], ds[k][e], dot[k]);
      store8_split(p.states + at0 + (c0 + k) * step, run);
      store8_split(p.dstates + at0 + (c0 + k) * step, ds[k]);
      const float d = expf(decay[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) run[e] = run[e] * d + loc[k][e];
    }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      const float v = warp_sum(dot[k]);
      if (lane == 0) red[k][warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < kn) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < PASS_THREADS / 32; ++w) s += red[threadIdx.x][w];
      p.dots[((static_cast<int64_t>(b) * p.nc + c0 + threadIdx.x) * p.H + h) *
                 p.NPB + blockIdx.x] = s;
    }
    __syncthreads();  // red consumed
  }
}

// ---------------------------------------------------------------- step 2

// Step 2, one (head group, chunk, row): dC's pairs' term summed over the
// group's heads into its partial, and each head's pairs' part of da.  The
// block walks (query tile I, key tile J <= I, head) as one pipeline: each
// step's dy_I, x_J, cs_I, cs_J and dt_J arrive in a two-stage ring while
// the step before is computed; C_I and B_J load at the first step of their
// tile pair.  G = C_I B_J^T, formed at the pair's first head, and the sum
// of W over the group's heads stay in shared memory in accumulator order
// (each thread reads and writes its own fragment), which keeps dC and the
// step's tiles in registers without a spill.
template <int P, int N>
__global__ void __launch_bounds__(WG, 1) ssd_bwd_dc_kernel(Params p) {
  using Cfg = TcCfg<P, N>;
  constexpr int PP = Cfg::PP, NP = Cfg::NP;
  extern __shared__ __align__(1024) uint4 smem_tiles[];
  char* base = reinterpret_cast<char*>(smem_tiles);
  fm::bf16* Cs = reinterpret_cast<fm::bf16*>(base);            // [TILE][NP]
  fm::bf16* Bs = reinterpret_cast<fm::bf16*>(base + Cfg::NT);  // [TILE][NP]
  char* stages = base + 2 * Cfg::NT;                           // [2] stages
  float4* Gs = reinterpret_cast<float4*>(stages + 2 * Cfg::DC_STAGE);  // [TILE / 8][WG]
  float4* Wsum = Gs + TILE / 8 * WG;                             // [TILE / 8][WG]
  float* cpart = reinterpret_cast<float*>(Wsum + TILE / 8 * WG); // [2][4][TILE]
  float* carry = cpart + 8 * TILE;                               // [HG][TILE]

  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  const int h0 = grp * HG, nh = min(HG, p.H - h0);
  const int nt = (len + TILE - 1) / TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp + g;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  const int64_t row0 = static_cast<int64_t>(b) * p.S + c0;
  const fm::bf16* x = static_cast<const fm::bf16*>(p.x) + b * p.x_sb +
                      static_cast<int64_t>(c0) * p.x_ss;
  const fm::bf16* dy = static_cast<const fm::bf16*>(p.dy) + row0 * y_ss;
  const fm::bf16* Bg = static_cast<const fm::bf16*>(p.Bm) + b * p.b_sb +
                       static_cast<int64_t>(c0) * p.b_ss;
  const fm::bf16* Cg = static_cast<const fm::bf16*>(p.Cm) + b * p.c_sb +
                       static_cast<int64_t>(c0) * p.c_ss;

  // The stage of step (I, J, hh): dy_I, x_J (head h0 + hh), cs_I, cs_J, dt_J.
  auto issue = [&](int I, int J, int hh, int st) {
    char* sp = stages + st * Cfg::DC_STAGE;
    const int h = h0 + hh;
    const int64_t rb = row_base(p, b, h, c);
    fm::load_tile<TILE, P, WG, PP>(reinterpret_cast<fm::bf16*>(sp), dy + h * P,
                                 y_ss, I * TILE, len);
    fm::load_tile<TILE, P, WG, PP>(reinterpret_cast<fm::bf16*>(sp + Cfg::XT),
                                 x + h * p.x_sh, p.x_ss, J * TILE, len);
    load_row_tile(sp + 2 * Cfg::XT, p.cs + rb + I * TILE, 8 * TILE);
    load_row_tile(sp + 2 * Cfg::XT + 8 * TILE, p.cs + rb + J * TILE, 8 * TILE);
    load_row_tile(sp + 2 * Cfg::XT + 16 * TILE, p.dtp + rb + J * TILE, 4 * TILE);
  };

  issue(0, 0, 0, 0);
  fm::cp_async_commit();
  float dC[NP / 8][4];
  int s = 0;
  for (int I = 0; I < nt; ++I) {
    const int q0 = I * TILE;
    zero(dC);
    for (int J = 0; J <= I; ++J) {
      const int k0 = J * TILE;
      for (int hh = 0; hh < nh; ++hh, ++s) {
        const int st = s & 1;
        if (hh == 0) {  // the tile pair's C_I (at J = 0) and B_J
          __syncthreads();  // the previous pair's products are done with them
          if (J == 0) fm::load_tile<TILE, N, WG, NP>(Cs, Cg, p.c_ss, q0, len);
          fm::load_tile<TILE, N, WG, NP>(Bs, Bg, p.b_ss, k0, len);
          fm::cp_async_commit();
        }
        if (hh + 1 < nh)
          issue(I, J, hh + 1, st ^ 1);
        else if (J < I)
          issue(I, J + 1, 0, st ^ 1);
        else if (I + 1 < nt)
          issue(I + 1, 0, 0, st ^ 1);
        fm::cp_async_commit();
        fm::cp_async_wait<1>();  // all but the next step's tiles have landed
        fm::fence_async_smem();
        __syncthreads();
        const char* sp = stages + st * Cfg::DC_STAGE;
        const fm::bf16* dyS = reinterpret_cast<const fm::bf16*>(sp);
        const fm::bf16* xS = reinterpret_cast<const fm::bf16*>(sp + Cfg::XT);
        const double* csI = reinterpret_cast<const double*>(sp + 2 * Cfg::XT);
        const double* csJ = csI + TILE;
        const float* dtJ = reinterpret_cast<const float*>(csJ + TILE);

        float D[TILE / 8][4];
        if (hh == 0) {
          zero(D);
          fm::fence_operand(D);
          fm::wgmma_arrive();
#pragma unroll
          for (int kk = 0; kk < NP / 16; ++kk)
            fm::wgmma_ss<TILE>(D, fm::desc_k<TILE>(Cs, 0, kk),
                             fm::desc_k<TILE>(Bs, 0, kk), 1);
          mma_done();
          fm::fence_operand(D);
#pragma unroll
          for (int j = 0; j < TILE / 8; ++j)
            Gs[j * WG + tid] = make_float4(D[j][0], D[j][1], D[j][2], D[j][3]);
        }
        zero(D);
        fm::fence_operand(D);
        fm::wgmma_arrive();
#pragma unroll
        for (int kk = 0; kk < PP / 16; ++kk)
          fm::wgmma_ss<TILE>(D, fm::desc_k<TILE>(dyS, 0, kk),
                           fm::desc_k<TILE>(xS, 0, kk), 1);
        mma_done();
        fm::fence_operand(D);

        // W = L o dt_j o D, summed into Wsum; E = G o W in D's registers.
        // (j, e) of a fragment is row r0 + 8 (e >> 1), column 8j + 2t +
        // (e & 1).
        double csi[2];
        bool rok[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          rok[rr] = q0 + r0 + 8 * rr < len;
          csi[rr] = csI[r0 + 8 * rr];
        }
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const float4 g4 = Gs[j * WG + tid];
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
          float wv[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            const double csj = csJ[col];
            const float dtj = dtJ[col];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const bool ok = k0 + col <= q0 + r0 + 8 * rr && rok[rr];
              float& d = D[j][2 * rr + e];
              wv[2 * rr + e] = ok ? exp_of(csi[rr] - csj) * dtj * d : 0.f;
              d = gv[2 * rr + e] * wv[2 * rr + e];
            }
          }
          float4 w4 = make_float4(wv[0], wv[1], wv[2], wv[3]);
          if (hh > 0) {
            const float4 o = Wsum[j * WG + tid];
            w4 = make_float4(o.x + w4.x, o.y + w4.y, o.z + w4.z, o.w + w4.w);
          }
          Wsum[j * WG + tid] = w4;
        }
        // The pairs' part of da_t = sum_{j < t <= i} E_ij: each row's
        // exclusive prefix sums over j (from the carry of the earlier key
        // tiles; quad scans across the four lanes of a row), then each
        // column t summed over the rows i >= t.
        float* cr = carry + hh * TILE;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float run = J == 0 ? 0.f : cr[r0 + 8 * rr];
#pragma unroll
          for (int j = 0; j < TILE / 8; ++j) {
            const float a = D[j][2 * rr], pr = a + D[j][2 * rr + 1];
            float incl = pr;
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              const float v = __shfl_up_sync(0xffffffffu, incl, off, 4);
              if (t >= off) incl += v;
            }
            const float tot = __shfl_sync(0xffffffffu, incl, 3, 4);
            D[j][2 * rr] = run + (incl - pr);
            D[j][2 * rr + 1] = run + (incl - pr) + a;
            run += tot;
          }
          __syncwarp();
          if (t == 0) cr[r0 + 8 * rr] = run;
        }
        float* cp = cpart + st * 4 * TILE + warp * TILE;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            float v = 0.f;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              if (k0 + col <= q0 + r0 + 8 * rr && rok[rr]) v += D[j][2 * rr + e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) cp[col] = v;
          }
        __syncthreads();  // column sums written; stage st consumed
        if (tid < TILE) {
          const float* cq = cpart + st * 4 * TILE;
          const float v = (cq[tid] + cq[TILE + tid]) + (cq[2 * TILE + tid] + cq[3 * TILE + tid]);
          float* d = p.dap + row_base(p, b, h0 + hh, c) + k0 + tid;
          *d = I == J ? v : *d + v;
        }
        if (hh == nh - 1) {  // dC_I += (W summed over the heads) B_J
          uint32_t a_hi[TILE / 16][4], a_lo[TILE / 16][4];
#pragma unroll
          for (int kk = 0; kk < TILE / 16; ++kk) {
            const float4 w0 = Wsum[2 * kk * WG + tid];
            const float4 w1 = Wsum[(2 * kk + 1) * WG + tid];
            const float c0[4] = {w0.x, w0.y, w0.z, w0.w};
            const float c1[4] = {w1.x, w1.y, w1.z, w1.w};
            c_to_a_split(a_hi[kk], a_lo[kk], c0, c1);
          }
          fm::fence_operand(dC);
          fm::wgmma_arrive();
#pragma unroll
          for (int kk = 0; kk < TILE / 16; ++kk) {
            fm::wgmma_rs<NP>(dC, a_hi[kk], fm::desc_mn<TILE>(Bs, kk), 1);
            fm::wgmma_rs<NP>(dC, a_lo[kk], fm::desc_mn<TILE>(Bs, kk), 1);
          }
          mma_done();
          fm::fence_operand(dC);
          fence_frags(a_hi);
          fence_frags(a_lo);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = q0 + r0 + 8 * rr;
      if (i >= len) continue;
      float* out = p.dC_part + ((row0 + i) * p.G + grp) * N;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int n = 8 * j + 2 * t;
        if (n < N)
          *reinterpret_cast<float2*>(out + n) =
              make_float2(dC[j][2 * rr], dC[j][2 * rr + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- step 3

// Step 3, one (head group, query tile, chunk, row): per head Z = dy_I S_in
// (wgmma, dy K-major, S_in's hi and lo tiles MN-major), the carried
// state's part of d cs, dcs_i = exp(cs_i) Z_i . C_i, and dC_I +=
// sum_h exp(cs_i) Z added to the group's partial (step 2 wrote it).  Each
// head's dy_I, S_in and cs_I arrive in a two-stage ring.
template <int P, int N>
__global__ void __launch_bounds__(WG, 1) ssd_bwd_dcs_kernel(Params p) {
  using Cfg = TcCfg<P, N>;
  constexpr int PP = Cfg::PP, NP = Cfg::NP;
  extern __shared__ __align__(1024) uint4 smem_tiles[];
  char* base = reinterpret_cast<char*>(smem_tiles);
  fm::bf16* Cs = reinterpret_cast<fm::bf16*>(base);  // [TILE][NP]
  char* stages = base + Cfg::NT;                     // [2] stages

  const int grp = blockIdx.x / p.QT, qt = blockIdx.x % p.QT;
  const int c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  const int q0 = qt * TILE;
  if (q0 >= len) return;  // a partial last chunk has fewer tiles
  const int h0 = grp * HG, nh = min(HG, p.H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp + g;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  const int64_t row0 = static_cast<int64_t>(b) * p.S + c0;
  const fm::bf16* dy = static_cast<const fm::bf16*>(p.dy) + row0 * y_ss;
  const fm::bf16* Cg = static_cast<const fm::bf16*>(p.Cm) + b * p.c_sb +
                       static_cast<int64_t>(c0) * p.c_ss;

  auto issue = [&](int hh, int st) {
    char* sp = stages + st * Cfg::DCS_STAGE;
    const int h = h0 + hh;
    const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
    fm::load_tile<TILE, P, WG, PP>(reinterpret_cast<fm::bf16*>(sp), dy + h * P,
                                 y_ss, q0, len);
    load_state_split<P, N>(reinterpret_cast<fm::bf16*>(sp + Cfg::XT),
                           reinterpret_cast<fm::bf16*>(sp + Cfg::XT + Cfg::STT),
                           p.states + bch * P * N);
    load_row_tile(sp + Cfg::XT + 2 * Cfg::STT, p.cs + row_base(p, b, h, c) + q0,
                  8 * TILE);
  };

  fm::load_tile<TILE, N, WG, NP>(Cs, Cg, p.c_ss, q0, len);
  issue(0, 0);
  fm::cp_async_commit();
  float acc[NP / 8][4];
  zero(acc);
  bool rok[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) rok[rr] = q0 + r0 + 8 * rr < len;
  for (int hh = 0; hh < nh; ++hh) {
    const int st = hh & 1;
    if (hh + 1 < nh) issue(hh + 1, st ^ 1);
    fm::cp_async_commit();
    fm::cp_async_wait<1>();
    fm::fence_async_smem();
    __syncthreads();
    const char* sp = stages + st * Cfg::DCS_STAGE;
    const fm::bf16* dyS = reinterpret_cast<const fm::bf16*>(sp);
    const fm::bf16* Shi = reinterpret_cast<const fm::bf16*>(sp + Cfg::XT);
    const fm::bf16* Slo = reinterpret_cast<const fm::bf16*>(sp + Cfg::XT + Cfg::STT);
    const double* csI = reinterpret_cast<const double*>(sp + Cfg::XT + 2 * Cfg::STT);
    float z[NP / 8][4];
    zero(z);
    fm::fence_operand(z);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < PP / 16; ++kk) {
      wgmma_ss_bmn<NP>(z, fm::desc_k<TILE>(dyS, 0, kk), fm::desc_mn<PP>(Shi, kk), 1);
      wgmma_ss_bmn<NP>(z, fm::desc_k<TILE>(dyS, 0, kk), fm::desc_mn<PP>(Slo, kk), 1);
    }
    mma_done();
    fm::fence_operand(z);
    const int64_t rb = row_base(p, b, h0 + hh, c);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      const float e = rok[rr] ? exp_of(csI[r]) : 0.f;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const float2 cv = pair_at<TILE, NP>(Cs, r, 8 * j + 2 * t);
        part = fmaf(z[j][2 * rr], cv.x, part);
        part = fmaf(z[j][2 * rr + 1], cv.y, part);
        acc[j][2 * rr] = fmaf(e, z[j][2 * rr], acc[j][2 * rr]);
        acc[j][2 * rr + 1] = fmaf(e, z[j][2 * rr + 1], acc[j][2 * rr + 1]);
      }
      part = fm::quad_sum(part);
      if (t == 0 && rok[rr]) p.dcs[rb + q0 + r] = e * part;
    }
    __syncthreads();  // stage st consumed before it is loaded again
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (!rok[rr]) continue;
    float* out = p.dC_part + ((row0 + q0 + r0 + 8 * rr) * p.G + grp) * N;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int n = 8 * j + 2 * t;
      if (n < N) {
        float2* o = reinterpret_cast<float2*>(out + n);
        const float2 v = *o;
        *o = make_float2(v.x + acc[j][2 * rr], v.y + acc[j][2 * rr + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- step 4

// A transposed tile of step 4 in accumulator fragments, (jj, e) at row j0 +
// 8 (e >> 1) of a key tile and column q0 + 8jj + 2t + (e & 1) of a query
// tile, times L_ij f_j: L = exp(cs_i - cs_j) formed only where j <= i <
// len, and 0 elsewhere; cs_i from the query tile's cumulative sums, cs_j
// and f_j the fragment's two rows'.
__device__ __forceinline__ void decay_t(float (&T)[TILE / 8][4],
                                        const double* csI,
                                        const double (&csj)[2],
                                        const float (&f)[2], int j0, int q0,
                                        int t, int len) {
#pragma unroll
  for (int jj = 0; jj < TILE / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * jj + 2 * t + e, i = q0 + col;
      const double csi = csI[col];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const bool ok = j0 + 8 * rr <= i && i < len;
        T[jj][2 * rr + e] *= ok ? exp_of(csi - csj[rr]) * f[rr] : 0.f;
      }
    }
}

// The end of step 4 for one (head, chunk, row), by one warp: d total =
// exp(total) <S_in, dS_out> + sum_j q_j, da_t = sum_{t' >= t} (dcs_t' -
// q_t' + d total on the last row) + dap_t (the reverse cumulative sum in
// fp64, each lane a contiguous segment, the segments' totals summed from
// the right by a shuffle scan), ddt_t = A da_t + x_t.w_t (step 4 wrote x.w
// into ddt) and the chunk's share of dA, sum_t da_t dt_t.
__device__ __forceinline__ void finish_head(const Params& p, int b, int c,
                                            int h, int len, int lane) {
  const int64_t rb = row_base(p, b, h, c);
  const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  const double total = p.cs[rb + len - 1];
  const float a = p.A[h];
  float dot = 0.f;
  for (int k = 0; k < p.NPB; ++k) dot += p.dots[bch * p.NPB + k];
  const int per = (len + 31) / 32;
  const int lo = min(lane * per, len), hi = min(lo + per, len);
  double sq = 0.0;
  for (int i = lo; i < hi; ++i) sq += p.qv[rb + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const double dtot = static_cast<double>(exp_of(total) * dot) + sq;
  auto dcs_at = [&](int i) {
    const double v = static_cast<double>(p.dcs[rb + i] - p.qv[rb + i]);
    return i == len - 1 ? v + dtot : v;
  };
  double seg = 0.0;
  for (int i = lo; i < hi; ++i) seg += dcs_at(i);
  double incl = seg;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += v;
  }
  double run = incl - seg;  // the lanes to the right
  double da_dt = 0.0;
  float* ddt = p.ddt + (static_cast<int64_t>(b) * p.S + c * p.chunk) * p.H + h;
  for (int i = hi - 1; i >= lo; --i) {
    run += dcs_at(i);
    const float da = static_cast<float>(run + p.dap[rb + i]);
    float* di = ddt + static_cast<int64_t>(i) * p.H;
    *di = fmaf(da, a, *di);
    da_dt += static_cast<double>(da) * p.dtp[rb + i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    da_dt += __shfl_xor_sync(0xffffffffu, da_dt, off);
  if (lane == 0) p.dA_part[bch] = static_cast<float>(da_dt);
}

// Step 4, one (head group, chunk, row): dB summed over the group's heads
// into its partial, dx, x.w (into ddt) and the leaving state's part of d
// cs; then, one warp per head, finish_head.  The block walks (key tile J,
// head, query tile I >= J, then the state) as one pipeline: each step's
// C_I, dy_I and cs_I, or dS_out's hi and lo tiles, arrive in a two-stage
// ring while the step before is computed; x_J, cs_J and dt_J arrive with
// the first step of (J, head), in two stages by (J, head); B_J loads at
// the first step of J.
template <int P, int N>
__global__ void __launch_bounds__(WG, 1) ssd_bwd_db_kernel(Params p) {
  using Cfg = TcCfg<P, N>;
  constexpr int PP = Cfg::PP, NP = Cfg::NP;
  using XTile = fm::Tile<TILE, PP>;
  extern __shared__ __align__(1024) uint4 smem_tiles[];
  char* base = reinterpret_cast<char*>(smem_tiles);
  fm::bf16* Bs = reinterpret_cast<fm::bf16*>(base);                     // [TILE][NP]
  fm::bf16* Xs = reinterpret_cast<fm::bf16*>(base + Cfg::NT);           // [2][TILE][PP]
  fm::bf16* DXs = reinterpret_cast<fm::bf16*>(base + Cfg::NT + 2 * Cfg::XT);  // [TILE][PP]
  char* stages = base + Cfg::NT + 3 * Cfg::XT;                          // [2] stages
  char* xrows = stages + 2 * Cfg::DB_STAGE;   // [2] (cs_J [TILE] fp64, dt_J [TILE])

  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
  const int h0 = grp * HG, nh = min(HG, p.H - h0);
  const int nt = (len + TILE - 1) / TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp + g;
  const int64_t y_ss = static_cast<int64_t>(p.H) * P;
  const int64_t row0 = static_cast<int64_t>(b) * p.S + c0;
  const fm::bf16* x = static_cast<const fm::bf16*>(p.x) + b * p.x_sb +
                      static_cast<int64_t>(c0) * p.x_ss;
  const fm::bf16* dy = static_cast<const fm::bf16*>(p.dy) + row0 * y_ss;
  fm::bf16* dx = static_cast<fm::bf16*>(p.dx) + row0 * y_ss;
  const fm::bf16* Bg = static_cast<const fm::bf16*>(p.Bm) + b * p.b_sb +
                       static_cast<int64_t>(c0) * p.b_ss;
  const fm::bf16* Cg = static_cast<const fm::bf16*>(p.Cm) + b * p.c_sb +
                       static_cast<int64_t>(c0) * p.c_ss;

  // The stage of step k of (J, hh): k < nt - J the query tile I = J + k,
  // k = nt - J the state; at k = 0 also x_J, cs_J and dt_J into their
  // (J, hh) stage.
  auto issue = [&](int J, int hh, int k, int st) {
    char* sp = stages + st * Cfg::DB_STAGE;
    const int h = h0 + hh;
    const int64_t rb = row_base(p, b, h, c);
    if (k == 0) {
      const int xs = (J * nh + hh) & 1;
      load_tile_rolled<TILE, P, PP>(Xs + xs * TILE * PP, x + h * p.x_sh, p.x_ss,
                                   J * TILE, len);
      load_row_tile(xrows + xs * 12 * TILE, p.cs + rb + J * TILE, 8 * TILE);
      load_row_tile(xrows + xs * 12 * TILE + 8 * TILE, p.dtp + rb + J * TILE,
                    4 * TILE);
    }
    if (J + k < nt) {
      const int I = J + k;
      load_tile_rolled<TILE, N, NP>(reinterpret_cast<fm::bf16*>(sp), Cg,
                                   p.c_ss, I * TILE, len);
      load_tile_rolled<TILE, P, PP>(reinterpret_cast<fm::bf16*>(sp + Cfg::NT),
                                   dy + h * P, y_ss, I * TILE, len);
      load_row_tile(sp + Cfg::NT + Cfg::XT, p.cs + rb + I * TILE, 8 * TILE);
    } else {
      const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
      load_state_split<P, N>(reinterpret_cast<fm::bf16*>(sp),
                             reinterpret_cast<fm::bf16*>(sp + Cfg::STT),
                             p.dstates + bch * P * N);
    }
  };

  issue(0, 0, 0, 0);
  fm::cp_async_commit();
  float dB[NP / 8][4], u[PP / 8][4];
  int s = 0;
  for (int J = 0; J < nt; ++J) {
    const int k0 = J * TILE;
    zero(dB);
    for (int hh = 0; hh < nh; ++hh) {
      const int h = h0 + hh;
      const int xs = (J * nh + hh) & 1;
      const fm::bf16* xS = Xs + xs * TILE * PP;
      const double* csJ = reinterpret_cast<const double*>(xrows + xs * 12 * TILE);
      const float* dtJ = reinterpret_cast<const float*>(csJ + TILE);
      const int64_t rb = row_base(p, b, h, c);
      zero(u);
      for (int k = 0; k <= nt - J; ++k, ++s) {
        const int st = s & 1;
        if (hh == 0 && k == 0) {  // B_J
          __syncthreads();  // the previous J's products are done with it
          fm::load_tile<TILE, N, WG, NP>(Bs, Bg, p.b_ss, k0, len);
          fm::cp_async_commit();
        }
        if (k < nt - J)
          issue(J, hh, k + 1, st ^ 1);
        else if (hh + 1 < nh)
          issue(J, hh + 1, 0, st ^ 1);
        else if (J + 1 < nt)
          issue(J + 1, 0, 0, st ^ 1);
        fm::cp_async_commit();
        fm::cp_async_wait<1>();
        fm::fence_async_smem();
        __syncthreads();
        const char* sp = stages + st * Cfg::DB_STAGE;
        double csj[2];
        float dtj[2];
        bool rok[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          rok[rr] = k0 + r0 + 8 * rr < len;
          csj[rr] = csJ[r0 + 8 * rr];
          dtj[rr] = dtJ[r0 + 8 * rr];
        }

        if (k < nt - J) {  // query tile I: dB += W^T C_I, u += (G o L)^T dy_I
          const int q0 = (J + k) * TILE;
          const fm::bf16* CsI = reinterpret_cast<const fm::bf16*>(sp);
          const fm::bf16* dyS = reinterpret_cast<const fm::bf16*>(sp + Cfg::NT);
          const double* csI = reinterpret_cast<const double*>(sp + Cfg::NT + Cfg::XT);
          // D^T = x_J dy_I^T, then W^T = L o dt_j o D^T split hi/lo for dB
          // += W^T C_I; then G^T = B_J C_I^T, (G o L)^T split hi/lo for u +=
          // (G o L)^T dy_I.  One product at a time keeps dB, u and the
          // tile in registers without a spill; L is formed once per product.
          float T[TILE / 8][4];
          zero(T);
          fm::fence_operand(T);
          fm::wgmma_arrive();
#pragma unroll
          for (int kk = 0; kk < PP / 16; ++kk)
            fm::wgmma_ss<TILE>(T, fm::desc_k<TILE>(xS, 0, kk),
                             fm::desc_k<TILE>(dyS, 0, kk), 1);
          mma_done();
          fm::fence_operand(T);
          decay_t(T, csI, csj, dtj, k0 + r0, q0, t, len);
          uint32_t a_hi[TILE / 16][4], a_lo[TILE / 16][4];
#pragma unroll
          for (int kk = 0; kk < TILE / 16; ++kk)
            c_to_a_split(a_hi[kk], a_lo[kk], T[2 * kk], T[2 * kk + 1]);
          fm::fence_operand(dB);
          fm::wgmma_arrive();
#pragma unroll
          for (int kk = 0; kk < TILE / 16; ++kk) {
            fm::wgmma_rs<NP>(dB, a_hi[kk], fm::desc_mn<TILE>(CsI, kk), 1);
            fm::wgmma_rs<NP>(dB, a_lo[kk], fm::desc_mn<TILE>(CsI, kk), 1);
          }
          mma_done();
          fm::fence_operand(dB);
          fence_frags(a_hi);
          fence_frags(a_lo);
          zero(T);
          fm::fence_operand(T);
          fm::wgmma_arrive();
#pragma unroll
          for (int kk = 0; kk < NP / 16; ++kk)
            fm::wgmma_ss<TILE>(T, fm::desc_k<TILE>(Bs, 0, kk),
                             fm::desc_k<TILE>(CsI, 0, kk), 1);
          mma_done();
          fm::fence_operand(T);
          const float one[2] = {1.f, 1.f};
          decay_t(T, csI, csj, one, k0 + r0, q0, t, len);
#pragma unroll
          for (int kk = 0; kk < TILE / 16; ++kk)
            c_to_a_split(a_hi[kk], a_lo[kk], T[2 * kk], T[2 * kk + 1]);
          fm::fence_operand(u);
          fm::wgmma_arrive();
#pragma unroll
          for (int kk = 0; kk < TILE / 16; ++kk) {
            fm::wgmma_rs<PP>(u, a_hi[kk], fm::desc_mn<TILE>(dyS, kk), 1);
            fm::wgmma_rs<PP>(u, a_lo[kk], fm::desc_mn<TILE>(dyS, kk), 1);
          }
          mma_done();
          fm::fence_operand(u);
          fence_frags(a_hi);
          fence_frags(a_lo);
        } else {  // the state: v = B_J dS_out^T, s = x_J dS_out
          const fm::bf16* Shi = reinterpret_cast<const fm::bf16*>(sp);
          const fm::bf16* Slo = reinterpret_cast<const fm::bf16*>(sp + Cfg::STT);
          const double total = p.cs[rb + len - 1];
          float ej[2];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            ej[rr] = rok[rr] ? exp_of(total - csj[rr]) : 0.f;
          {
            float v[PP / 8][4];
            zero(v);
            fm::fence_operand(v);
            fm::wgmma_arrive();
#pragma unroll
            for (int kk = 0; kk < NP / 16; ++kk) {
              fm::wgmma_ss<PP>(v, fm::desc_k<TILE>(Bs, 0, kk),
                               fm::desc_k<PP>(Shi, 0, kk), 1);
              fm::wgmma_ss<PP>(v, fm::desc_k<TILE>(Bs, 0, kk),
                               fm::desc_k<PP>(Slo, 0, kk), 1);
            }
            mma_done();
            fm::fence_operand(v);
            // w = u + exp(total - cs_j) v (into u); x.w and x.v per row.
            float xw[2] = {0.f, 0.f}, xv[2] = {0.f, 0.f};
#pragma unroll
            for (int jj = 0; jj < PP / 8; ++jj)
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                const float2 xp = pair_at<TILE, PP>(xS, r0 + 8 * rr, 8 * jj + 2 * t);
                float& u0 = u[jj][2 * rr];
                float& u1 = u[jj][2 * rr + 1];
                u0 = fmaf(ej[rr], v[jj][2 * rr], u0);
                u1 = fmaf(ej[rr], v[jj][2 * rr + 1], u1);
                xw[rr] = fmaf(xp.x, u0, fmaf(xp.y, u1, xw[rr]));
                xv[rr] = fmaf(xp.x, v[jj][2 * rr], fmaf(xp.y, v[jj][2 * rr + 1], xv[rr]));
              }
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              xw[rr] = fm::quad_sum(xw[rr]);
              xv[rr] = fm::quad_sum(xv[rr]);
              const int j = k0 + r0 + 8 * rr;
              if (t == 0 && rok[rr]) {
                p.ddt[(row0 + j) * p.H + h] = xw[rr];
                p.qv[rb + j] = ej[rr] * dtj[rr] * xv[rr];
              }
            }
          }
          // dx = dt_j w, through the dx tile in 16-byte stores.
          fm::store_rows<TILE, P, PP>(DXs, 16 * warp, u, dtj[0], dtj[1],
                                    dx + h * P, y_ss, k0 + 16 * warp, len,
                                    lane);
          // dB += (exp(total - cs_j) dt_j x_j) dS_out: the weighted x rows
          // split hi/lo into A fragments (rows j, reduction over p) and
          // dS_out's hi and lo tiles read MN-major, three products (all but
          // lo x lo) straight into dB.
          uint32_t a_hi[PP / 16][4], a_lo[PP / 16][4];
#pragma unroll
          for (int kk = 0; kk < PP / 16; ++kk) {
            float v[2][4];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const float f = ej[rr] * dtj[rr];
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const float2 xp = pair_at<TILE, PP>(xS, r0 + 8 * rr,
                                                  16 * kk + 8 * hf + 2 * t);
                v[rr][2 * hf] = f * xp.x;
                v[rr][2 * hf + 1] = f * xp.y;
              }
            }
            split2(v[0][0], v[0][1], a_hi[kk][0], a_lo[kk][0]);
            split2(v[1][0], v[1][1], a_hi[kk][1], a_lo[kk][1]);
            split2(v[0][2], v[0][3], a_hi[kk][2], a_lo[kk][2]);
            split2(v[1][2], v[1][3], a_hi[kk][3], a_lo[kk][3]);
          }
          fm::fence_operand(dB);
          fm::wgmma_arrive();
#pragma unroll
          for (int kk = 0; kk < PP / 16; ++kk) {
            fm::wgmma_rs<NP>(dB, a_hi[kk], fm::desc_mn<PP>(Shi, kk), 1);
            fm::wgmma_rs<NP>(dB, a_lo[kk], fm::desc_mn<PP>(Shi, kk), 1);
            fm::wgmma_rs<NP>(dB, a_hi[kk], fm::desc_mn<PP>(Slo, kk), 1);
          }
          mma_done();
          fm::fence_operand(dB);
          fence_frags(a_hi);
          fence_frags(a_lo);
        }
        __syncthreads();  // stage st (and, at the state, x_J) consumed
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = k0 + r0 + 8 * rr;
      if (j >= len) continue;
      float* out = p.dB_part + ((row0 + j) * p.G + grp) * N;
#pragma unroll
      for (int jn = 0; jn < NP / 8; ++jn) {
        const int n = 8 * jn + 2 * t;
        if (n < N)
          *reinterpret_cast<float2*>(out + n) =
              make_float2(dB[jn][2 * rr], dB[jn][2 * rr + 1]);
      }
    }
  }
  __syncthreads();  // every x.w and q of the group's heads is written
  for (int hh = warp; hh < nh; hh += WG / 32)
    finish_head(p, b, c, h0 + hh, len, lane);
}

// Scratch of one bf16 call, carved from the caller's workspace: per (row,
// head, chunk) padded to whole tiles, the cumulative sums (fp64), dt, the
// state parts of d cs, the pairs' part of da; per (row, chunk, head) the
// totals, <S_in, dS_out> by block of the pass, the shares of dA; the
// states and their gradients [B, nc, H, P, N] fp32 (then hi/lo in place);
// the head groups' partial dB and dC [B, S, G, N] fp32.
struct TcWorkspace {
  size_t cs, dtp, dcs, dap, qv, totals, dots, dA_part, states, dstates,
      dB_part, dC_part, bytes;
};

inline TcWorkspace tc_workspace_layout(int B, int S, int H, int P, int N,
                                       int chunk) {
  const size_t nc = (S + chunk - 1) / chunk, qt = (chunk + TILE - 1) / TILE;
  const size_t rows = B * H * nc * qt * TILE, G = (H + HG - 1) / HG;
  const size_t npb = (P * N / 8 + PASS_THREADS - 1) / PASS_THREADS;
  const size_t f = sizeof(float);
  TcWorkspace w;
  w.cs = 0;
  w.dtp = w.cs + align256(sizeof(double) * rows);
  w.dcs = w.dtp + align256(f * rows);
  w.dap = w.dcs + align256(f * rows);
  w.qv = w.dap + align256(f * rows);
  w.totals = w.qv + align256(f * rows);
  w.dots = w.totals + align256(f * B * nc * H);
  w.dA_part = w.dots + align256(f * B * nc * H * npb);
  w.states = w.dA_part + align256(f * B * nc * H);
  w.dstates = w.states + align256(f * B * nc * H * P * N);
  w.dB_part = w.dstates + align256(f * B * nc * H * P * N);
  w.dC_part = w.dB_part + align256(f * B * S * G * N);
  w.bytes = w.dC_part + f * B * S * G * N;
  return w;
}

// The seven steps on `stream`.
template <int P, int N>
int launch_tc(const Params& p, cudaStream_t stream) {
  using Cfg = TcCfg<P, N>;
  const size_t s_local = Cfg::LOCAL +
      (sizeof(double) + 2 * sizeof(float)) * static_cast<size_t>(p.chunk);
  int err = set_smem(ssd_bwd_local_kernel<P, N>, s_local);
  if (!err) err = set_smem(ssd_bwd_dc_kernel<P, N>, Cfg::DC);
  if (!err) err = set_smem(ssd_bwd_dcs_kernel<P, N>, Cfg::DCS);
  if (!err) err = set_smem(ssd_bwd_db_kernel<P, N>, Cfg::DB);
  if (err) return err;
  ssd_bwd_local_kernel<P, N>
      <<<dim3(p.H, p.nc, p.B), WG, s_local, stream>>>(p);
  ssd_bwd_states_kernel<<<dim3(p.NPB, p.H, p.B), PASS_THREADS, 0, stream>>>(
      p, P * N);
  ssd_bwd_dc_kernel<P, N><<<dim3(p.G, p.nc, p.B), WG, Cfg::DC, stream>>>(p);
  ssd_bwd_dcs_kernel<P, N>
      <<<dim3(p.G * p.QT, p.nc, p.B), WG, Cfg::DCS, stream>>>(p);
  ssd_bwd_db_kernel<P, N><<<dim3(p.G, p.nc, p.B), WG, Cfg::DB, stream>>>(p);
  constexpr int ROWS = THREADS / N;
  const int64_t rows = static_cast<int64_t>(p.B) * p.S;
  ssd_bwd_reduce_kernel<fm::bf16, N>
      <<<static_cast<unsigned>((rows + ROWS - 1) / ROWS), THREADS, 0,
         stream>>>(p, p.G);
  ssd_bwd_dA_kernel<<<1, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc_shape(const Params& p, int P, int N, cudaStream_t stream) {
  if (P == 16 && N == 16) return launch_tc<16, 16>(p, stream);
  if (P == 32 && N == 64) return launch_tc<32, 64>(p, stream);
  if (P == 64 && N == 128) return launch_tc<64, 128>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The (head_dim, state) pairs built: the forward's (ssd_scan.SHAPES).
int launch_shape(const Params& p, int P, int N, cudaStream_t stream) {
  if (P == 16 && N == 16) return launch<16, 16>(p, stream);
  if (P == 32 && N == 64) return launch<32, 64>(p, stream);
  if (P == 64 && N == 128) return launch<64, 128>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Bytes of the workspace one call of ssd_scan_bwd needs (dtype and shape as
// there; chunk as the kernels see it, min(chunk, S)), or -1 for another
// dtype.
extern "C" int64_t ssd_scan_bwd_workspace_bytes(int dtype, int B, int S,
                                                int H, int P, int N,
                                                int chunk) {
  if (dtype == 0) return bwd_workspace_layout(B, S, H, P, N, chunk).bytes;
  if (dtype == 1) return tc_workspace_layout(B, S, H, P, N, chunk).bytes;
  return -1;
}

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the
// tensor-core kernels, 16-byte aligned rows of x, Bm, Cm and dy and bases
// of the states) for x, Bm, Cm, dy and dx, dBm, dCm.  strides: 10 element
// strides, x (batch, sequence, head), dt (batch, sequence, head), Bm
// (batch, sequence) and Cm (batch, sequence).  init, dfinal and dinit may
// be null.  workspace: 256-byte aligned scratch of at least
// ssd_scan_bwd_workspace_bytes.  Returns
// the CUDA error of the launches (0 on success); launches on `stream` and
// does not synchronise.
extern "C" int ssd_scan_bwd(int dtype, const void* x, const float* dt,
                            const float* A, const void* Bm, const void* Cm,
                            const float* init, const void* dy,
                            const float* dfinal, void* dx, float* ddt,
                            float* dA, void* dBm, void* dCm, float* dinit,
                            int B, int S, int H, int P, int N, int chunk,
                            const int64_t* strides, void* workspace,
                            int64_t workspace_bytes, void* stream) {
  const int64_t need =
      ssd_scan_bwd_workspace_bytes(dtype, B, S, H, P, N, chunk);
  if (need < 0 || workspace == nullptr || workspace_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(workspace);
  const int qt = (chunk + TILE - 1) / TILE;
  Params p{x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dBm, dCm, dinit,
           B, S, H, chunk, (S + chunk - 1) / chunk, qt,
           strides[0], strides[1], strides[2],
           strides[3], strides[4], strides[5],
           strides[6], strides[7],
           strides[8], strides[9]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  if (dtype == 0) {
    const BwdWorkspace w = bwd_workspace_layout(B, S, H, P, N, chunk);
    p.cb = f(w.cb);
    p.states = f(w.states);
    p.dstates = f(w.dstates);
    p.totals = f(w.totals);
    p.dA_part = f(w.dA_part);
    p.dB_part = f(w.dB_part);
    p.dC_part = f(w.dC_part);
    return launch_shape(p, P, N, s);
  }
  const TcWorkspace w = tc_workspace_layout(B, S, H, P, N, chunk);
  p.cs = reinterpret_cast<double*>(base + w.cs);
  p.dtp = f(w.dtp);
  p.dcs = f(w.dcs);
  p.dap = f(w.dap);
  p.qv = f(w.qv);
  p.totals = f(w.totals);
  p.dots = f(w.dots);
  p.dA_part = f(w.dA_part);
  p.states = f(w.states);
  p.dstates = f(w.dstates);
  p.dB_part = f(w.dB_part);
  p.dC_part = f(w.dC_part);
  p.G = (H + HG - 1) / HG;
  p.QTR = qt * TILE;
  p.NPB = (P * N / 8 + PASS_THREADS - 1) / PASS_THREADS;
  return launch_tc_shape(p, P, N, s);
}
