// Flash attention backward for Hopper (sm_90a), CUDA C++.
//
// The gradient of the forward in csrc/flash_attention.cu: dQ, dK and dV of
// self-attention (Sq == Sk), and of attention without the causal mask over
// keys of another length (Sq != Sk: cross-attention), from q, k, v, the
// forward's output o, the upstream gradient dO and the forward's per-row
// log-sum-exp lse.  The Pallas TPU kernel repro/kernels/flash_attention.py is
// forward-only (JAX differentiates its jnp attention), so this kernel has no
// TPU counterpart; it is the backward of the port's autograd.Function
// (kernels/ops.py).  The probabilities are recomputed, never stored:
//   P = exp(q k^T * scale - lse)    (0 where masked)
//   D_i = rowsum(dO * O)_i
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// GQA: key/value head j serves query heads j*G .. j*G + G-1 (G = H / KV),
// and its dK/dV sum over those heads.  Causal and sliding-window masks as
// in the forward, queries right-aligned to the keys (query row i sits at
// key position i + Sk - Sq); the causal mask needs Sq == Sk (the launcher
// raises otherwise).  Any sequence lengths (the ragged edges are masked).
// Masked entries get P = 0 from a predicate, so a row with no live key (lse =
// -1e30 + log(1e-30)) never forms exp(inf) or inf - inf.
//
// Design: two passes from one launch call, both without atomics, so the
// same inputs give bit-equal gradients.
//  1. dQ pass, one block per (query tile, query head, batch row): stages Q
//     and dO, computes D for its rows (written to a [B, H, Sq] fp32 buffer
//     for pass 2), then walks the live key tiles as the forward does and
//     accumulates dQ in registers.
//  2. dK/dV pass, one block per (key tile, KV head, batch row): keeps its K
//     and V tiles in shared memory and walks the G query heads' live query
//     tiles, accumulating dK and dV in registers; it owns its rows of
//     dK/dV, so nothing is summed across blocks.
// Two kernels implement each pass, chosen by dtype in the C entry point:
//
// bfloat16 -- flash_bwd_dq_bf16_kernel and flash_bwd_dkv_bf16_kernel, on the
// tensor cores (wgmma) with the forward's building blocks in
// csrc/flash_mma.cuh: bf16 tiles in 128-byte swizzled shared memory, the
// streamed tiles double-buffered by 16-byte cp.async, two warpgroups of 64
// rows.  Pass 1 (128 query rows, key tiles of 128): S = Q K^T and
// dP = dO V^T with both operands in shared memory, P = exp2(S scale log2e -
// lse log2e) (0 where masked), dS = P (dP - D) rounded to bf16 in
// registers, dQ += dS K with dS as A from registers and K read
// transposed.  Pass 2 (128 key rows, query tiles of 64 with their lse and
// D): S^T = K Q^T, P^T, dV += P^T dO issued with dP^T = V dO^T, dS^T =
// P^T (dP^T - D), dK += dS^T Q; P^T and dS^T stay in registers as A
// operands, dK and dV are fp32 register accumulators the block owns.  Only
// tiles that cross the diagonal, the window edge or a ragged end take the
// per-element mask.  Shared memory at hd 128: 192.5 KB (pass 1: Q, dO, two
// stages of K and V) and 129 KB (pass 2: K, V, two stages of Q and dO).
// wgmma beat the same passes on mma.sync with ldmatrix fragments, and these
// tiles beat 64-key (pass 1) and 32-query (pass 2) ones, on the card
// (PERF.md).
//
// float32 -- flash_bwd_dq_kernel and flash_bwd_dkv_kernel, the CUDA-core
// kernels of the first port: fp32 tiles in shared memory (four 64 x (hd+1)
// tiles plus one or two 64 x 65 score tiles: 149 KB and 166 KB at head_dim
// 128, one block per SM).  Float32 runs no tensor-core product: TF32 would
// not hold the float32 tolerance.
//
// Bound.  Five products of the forward's size (the recomputed scores, dP,
// dV, dK, dQ): 2.5x the forward's work, 601 GFLOP at the train shape (B 2,
// S 4096, H 28, KV 4, hd 128, causal), 0.608 ms at the bf16 tensor-core
// rate of an H100 SXM, so operations bound it.  The two passes recompute
// S and dP in each, seven products where one fused pass with atomic dQ
// would do five: 841 GFLOP executed, 1.4x the bound's count, the price of
// deterministic gradients without atomics.
//
// Layout: q/o/dO/dQ [B, Sq, H, hd], k/v/dK/dV [B, Sk, KV, hd], each with its
// own (batch, sequence, head) strides in elements and head_dim contiguous;
// q/o/dO/dQ hold Sq rows, k/v/dK/dV Sk rows; lse and D contiguous
// [B, H, Sq] fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_mma.cuh"

namespace {

constexpr int BLOCK = 64;  // query and key tile rows
constexpr int THREADS = 256;
constexpr int LDP = BLOCK + 1;  // padded row stride of a score tile

enum { Q, K, V, O, DO, DQ, DK, DV, N_TENSORS };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, Sq]
  float* delta;      // [B, H, Sq], written by pass 1, read by pass 2
  void* dq;
  void* dk;
  void* dv;
  int B, H, KV, Sq, Sk;
  int64_t sb[N_TENSORS], ss[N_TENSORS], sh[N_TENSORS];
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

static_assert(THREADS == 4 * BLOCK, "four threads per tile row");

template <int HD>
constexpr size_t smem_dq() {
  // Q, dO, K, V tiles; dS tile; lse and D per query row.
  return sizeof(float) * (4 * BLOCK * (HD + 1) + BLOCK * LDP + 2 * BLOCK);
}

template <int HD>
constexpr size_t smem_dkv() {
  // K, V, Q, dO tiles; P and dS tiles; lse and D per query row.
  return sizeof(float) * (4 * BLOCK * (HD + 1) + 2 * BLOCK * LDP + 2 * BLOCK);
}

// Stage rows [row0, row0 + BLOCK) of one head into shared memory as fp32,
// zero-filling rows at or past n_rows.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < BLOCK * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int row = row0 + r;
    dst[r * LD + d] = row < n_rows ? to_float(src[row * row_stride + d]) : 0.f;
  }
}

// Query row qi sees key kj (queries right-aligned to the keys).
__device__ __forceinline__ bool is_live(const Params& p, int qi, int kj) {
  if (qi >= p.Sq || kj >= p.Sk) return false;
  const int pos = qi + p.Sk - p.Sq;
  if (p.causal && kj > pos) return false;
  if (p.window && kj <= pos - p.window) return false;
  return true;
}

// Scores and dP of one 64 x 64 tile pair: s = Q_r . K_c, dp = dO_r . V_c for
// rows sy*4 + i and columns sx + 16*j (a 16 x 16 thread grid, 4 x 4 each).
template <int HD>
__device__ __forceinline__ void tile_products(const float* Qs, const float* dOs,
                                              const float* Ks, const float* Vs,
                                              int sx, int sy, float (&s)[4][4],
                                              float (&dp)[4][4]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(sy * 4 + i) * LD + d];
      gv[i] = dOs[(sy * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(sx + 16 * j) * LD + d];
      vv[j] = Vs[(sx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BLOCK][LD]
  float* dOs = Qs + BLOCK * LD;      // [BLOCK][LD]
  float* Ks = dOs + BLOCK * LD;      // [BLOCK][LD]
  float* Vs = Ks + BLOCK * LD;       // [BLOCK][LD]
  float* dSs = Vs + BLOCK * LD;      // [BLOCK][LDP]
  float* lse_s = dSs + BLOCK * LDP;  // per query row
  float* D_s = lse_s + BLOCK;        // per query row

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int64_t rows = (static_cast<int64_t>(b) * p.H + h) * p.Sq;

  const T* q = static_cast<const T*>(p.q) + b * p.sb[Q] + h * p.sh[Q];
  const T* k = static_cast<const T*>(p.k) + b * p.sb[K] + kvh * p.sh[K];
  const T* v = static_cast<const T*>(p.v) + b * p.sb[V] + kvh * p.sh[V];
  const T* o = static_cast<const T*>(p.o) + b * p.sb[O] + h * p.sh[O];
  const T* dout = static_cast<const T*>(p.dout) + b * p.sb[DO] + h * p.sh[DO];
  T* dq = static_cast<T*>(p.dq) + b * p.sb[DQ] + h * p.sh[DQ];

  load_tile<T, HD>(Qs, q, p.ss[Q], q0, p.Sq);
  load_tile<T, HD>(dOs, dout, p.ss[DO], q0, p.Sq);
  __syncthreads();
  {
    // D = rowsum(dO * O): four neighbouring lanes per row, combined by
    // shuffles.
    const int r = tid / 4, part = tid % 4;
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < p.Sq)
      for (int d = part; d < HD; d += 4)
        acc = fmaf(dOs[r * LD + d], to_float(o[qi * p.ss[O] + d]), acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      D_s[r] = acc;
      lse_s[r] = qi < p.Sq ? p.lse[rows + qi] : 0.f;
      if (qi < p.Sq) p.delta[rows + qi] = acc;
    }
  }

  const int sx = tid % 16, sy = tid / 16;
  constexpr int TX = HD < 32 ? HD : 32;
  constexpr int TY = THREADS / TX;
  constexpr int RPT = BLOCK / TY;
  constexpr int CPT = HD / TX;
  const int ax = tid % TX, ay = tid / TX;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // Key tiles any row of this query tile sees, as in the forward.
  const int off = p.Sk - p.Sq;
  const int q_last = min(q0 + BLOCK, p.Sq) - 1;
  const int k_lo = p.window ? max(0, q0 + off - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.Sk - 1, q_last + off) : p.Sk - 1;
  const int t_lo = k_lo / BLOCK;
  const int t_end = k_hi >= k_lo ? k_hi / BLOCK + 1 : t_lo;

  for (int t = t_lo; t < t_end; ++t) {
    const int k0 = t * BLOCK;
    __syncthreads();  // D/lse staged; the previous tile's K and dS consumed
    load_tile<T, HD>(Ks, k, p.ss[K], k0, p.Sk);
    load_tile<T, HD>(Vs, v, p.ss[V], k0, p.Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_products<HD>(Qs, dOs, Ks, Vs, sx, sy, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sy * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sx + 16 * j;
        float ds = 0.f;
        if (is_live(p, q0 + r, k0 + c)) {
          const float pr = expf(s[i][j] * p.scale - lse_s[r]);
          ds = pr * (dp[i][j] - D_s[r]);
        }
        dSs[r * LDP + c] = ds;
      }
    }
    __syncthreads();  // dS written

#pragma unroll 4
    for (int c = 0; c < BLOCK; ++c) {
      float kv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[c * LD + ax + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float ds = dSs[(ay * RPT + i) * LDP + c];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + ay * RPT + i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      dq[qi * p.ss[DQ] + ax + TX * j] = from_float<T>(acc[i][j] * p.scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BLOCK][LD], this block's keys
  float* Vs = Ks + BLOCK * LD;       // [BLOCK][LD]
  float* Qs = Vs + BLOCK * LD;       // [BLOCK][LD], the current query tile
  float* dOs = Qs + BLOCK * LD;      // [BLOCK][LD]
  float* Ps = dOs + BLOCK * LD;      // [BLOCK][LDP], query rows x key cols
  float* dSs = Ps + BLOCK * LDP;     // [BLOCK][LDP]
  float* lse_s = dSs + BLOCK * LDP;  // per query row
  float* D_s = lse_s + BLOCK;        // per query row

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BLOCK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;

  const T* k = static_cast<const T*>(p.k) + b * p.sb[K] + kvh * p.sh[K];
  const T* v = static_cast<const T*>(p.v) + b * p.sb[V] + kvh * p.sh[V];
  T* dk = static_cast<T*>(p.dk) + b * p.sb[DK] + kvh * p.sh[DK];
  T* dv = static_cast<T*>(p.dv) + b * p.sb[DV] + kvh * p.sh[DV];

  load_tile<T, HD>(Ks, k, p.ss[K], k0, p.Sk);
  load_tile<T, HD>(Vs, v, p.ss[V], k0, p.Sk);

  const int sx = tid % 16, sy = tid / 16;
  // Accumulator mapping: key rows ay*RPT + i, head_dim columns ax + TX*j.
  constexpr int TX = HD < 32 ? HD : 32;
  constexpr int TY = THREADS / TX;
  constexpr int RPT = BLOCK / TY;
  constexpr int CPT = HD / TX;
  const int ax = tid % TX, ay = tid / TX;
  float acc_dk[RPT][CPT], acc_dv[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  // Query tiles with a row that sees a key of this tile.
  const int off = p.Sk - p.Sq;
  const int k_last = min(k0 + BLOCK, p.Sk) - 1;
  const int q_lo = p.causal ? max(0, k0 - off) : 0;
  const int q_hi =
      p.window ? min(p.Sq - 1, k_last - off + p.window - 1) : p.Sq - 1;
  const int t_lo = q_lo / BLOCK;
  const int t_end = q_hi >= q_lo ? q_hi / BLOCK + 1 : t_lo;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t rows = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    const T* q = static_cast<const T*>(p.q) + b * p.sb[Q] + h * p.sh[Q];
    const T* dout =
        static_cast<const T*>(p.dout) + b * p.sb[DO] + h * p.sh[DO];
    for (int t = t_lo; t < t_end; ++t) {
      const int q0 = t * BLOCK;
      __syncthreads();  // the previous tile's Q, dO, P and dS consumed
      load_tile<T, HD>(Qs, q, p.ss[Q], q0, p.Sq);
      load_tile<T, HD>(dOs, dout, p.ss[DO], q0, p.Sq);
      if (tid < BLOCK) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < p.Sq ? p.lse[rows + qi] : 0.f;
        D_s[tid] = qi < p.Sq ? p.delta[rows + qi] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_products<HD>(Qs, dOs, Ks, Vs, sx, sy, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sy * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sx + 16 * j;
          float pr = 0.f, ds = 0.f;
          if (is_live(p, q0 + r, k0 + c)) {
            pr = expf(s[i][j] * p.scale - lse_s[r]);
            ds = pr * (dp[i][j] - D_s[r]);
          }
          Ps[r * LDP + c] = pr;
          dSs[r * LDP + c] = ds;
        }
      }
      __syncthreads();  // P and dS written

#pragma unroll 4
      for (int r = 0; r < BLOCK; ++r) {
        float gv[CPT], qv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          gv[j] = dOs[r * LD + ax + TX * j];
          qv[j] = Qs[r * LD + ax + TX * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int c = ay * RPT + i;
          const float pr = Ps[r * LDP + c];
          const float ds = dSs[r * LDP + c];
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            acc_dv[i][j] = fmaf(pr, gv[j], acc_dv[i][j]);
            acc_dk[i][j] = fmaf(ds, qv[j], acc_dk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kj = k0 + ay * RPT + i;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      dk[kj * p.ss[DK] + ax + TX * j] = from_float<T>(acc_dk[i][j] * p.scale);
      dv[kj * p.ss[DV] + ax + TX * j] = from_float<T>(acc_dv[i][j]);
    }
  }
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t dq_smem = smem_dq<HD>();
  constexpr size_t dkv_smem = smem_dkv<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, HD><<<dim3((p.Sq + BLOCK - 1) / BLOCK, p.H, p.B),
                               THREADS, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<T, HD><<<dim3((p.Sk + BLOCK - 1) / BLOCK, p.KV, p.B),
                                THREADS, dkv_smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------ bfloat16, tensor cores

namespace fm = flash_mma;

template <int HD>
struct Bf16Bwd {
  static constexpr int BM = 128;  // pass 1: query rows per block
  static constexpr int BN = 128;  // pass 1: key rows per tile
  static constexpr int BK = 128;  // pass 2: key rows per block
  // pass 2: query rows per tile; the dK and dV accumulators take 128
  // registers a thread at hd 128, so the scores' tile is half of BK.
  static constexpr int BQ = 64;
  static constexpr int HDP = fm::tile_hd(HD);  // head_dim in the tiles
  static constexpr int THREADS = 256;  // a warpgroup per 64 rows of the block
  // Pass 1: Q, dO, two stages of K and V; D per row.
  static constexpr size_t SMEM_DQ =
      sizeof(fm::bf16) * (2 * BM + 4 * BN) * HDP + sizeof(float) * BM;
  // Pass 2: K, V, two stages of Q and dO; two stages of lse and D.
  static constexpr size_t SMEM_DKV =
      sizeof(fm::bf16) * (2 * BK + 4 * BQ) * HDP + sizeof(float) * 4 * BQ;
  static_assert(THREADS == 128 * BM / 64 && THREADS == 128 * BK / 64,
                "a warpgroup per 64 rows");
  static_assert(THREADS == 2 * BM, "D: two threads per query row");
};

template <int HD>
__global__ void __launch_bounds__(Bf16Bwd<HD>::THREADS, 1)
    flash_bwd_dq_bf16_kernel(Params p) {
  using Cfg = Bf16Bwd<HD>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, HDP = Cfg::HDP;
  constexpr int THREADS = Cfg::THREADS;
  constexpr int NS = BN / 8;   // score n-tiles
  constexpr int NO = HDP / 8;  // dQ n-tiles
  extern __shared__ __align__(1024) uint4 smem_tiles[];
  fm::bf16* Qs = reinterpret_cast<fm::bf16*>(smem_tiles);  // [BM][HDP]
  fm::bf16* dOs = Qs + BM * HDP;                            // [BM][HDP]
  fm::bf16* Ks = dOs + BM * HDP;                            // [2][BN][HDP]
  fm::bf16* Vs = Ks + 2 * BN * HDP;                         // [2][BN][HDP]
  float* D_s = reinterpret_cast<float*>(Vs + 2 * BN * HDP);  // [BM]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;  // warpgroup: query rows 64 wg .. 64 wg + 63
  const int tq = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest rows first
  const int kvh = h / (p.H / p.KV);
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: +0, +8
  const int64_t rows = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const fm::Mask mask{p.Sq, p.Sk, p.causal, p.window};

  const fm::bf16* q =
      static_cast<const fm::bf16*>(p.q) + b * p.sb[Q] + h * p.sh[Q];
  const fm::bf16* k =
      static_cast<const fm::bf16*>(p.k) + b * p.sb[K] + kvh * p.sh[K];
  const fm::bf16* v =
      static_cast<const fm::bf16*>(p.v) + b * p.sb[V] + kvh * p.sh[V];
  const fm::bf16* o =
      static_cast<const fm::bf16*>(p.o) + b * p.sb[O] + h * p.sh[O];
  const fm::bf16* dout =
      static_cast<const fm::bf16*>(p.dout) + b * p.sb[DO] + h * p.sh[DO];
  fm::bf16* dq = static_cast<fm::bf16*>(p.dq) + b * p.sb[DQ] + h * p.sh[DQ];

  int t_lo, t_end;
  mask.key_tiles(q0, BM, BN, &t_lo, &t_end);

  fm::load_tile<BM, HD, THREADS, HDP>(Qs, q, p.ss[Q], q0, p.Sq);
  fm::load_tile<BM, HD, THREADS, HDP>(dOs, dout, p.ss[DO], q0, p.Sq);
  if (t_lo < t_end) {
    fm::load_tile<BN, HD, THREADS, HDP>(Ks, k, p.ss[K], t_lo * BN, p.Sk);
    fm::load_tile<BN, HD, THREADS, HDP>(Vs, v, p.ss[V], t_lo * BN, p.Sk);
  }
  fm::cp_async_commit();
  {
    // D = rowsum(dO * O) while the tiles load: two threads per row,
    // 16-byte loads, combined by a shuffle.
    const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
    const int qi = q0 + r;
    float d = 0.f;
    if (qi < p.Sq) {
#pragma unroll
      for (int c = part; c < HD / 8; c += 2) {
        const uint4 ov = *reinterpret_cast<const uint4*>(
            o + static_cast<int64_t>(qi) * p.ss[O] + c * 8);
        const uint4 gv = *reinterpret_cast<const uint4*>(
            dout + static_cast<int64_t>(qi) * p.ss[DO] + c * 8);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 of = __bfloat1622float2(o2[i]);
          const float2 gf = __bfloat1622float2(g2[i]);
          d = fmaf(gf.x, of.x, d);
          d = fmaf(gf.y, of.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (part == 0) {
      D_s[r] = d;
      if (qi < p.Sq) p.delta[rows + qi] = d;
    }
  }
  __syncthreads();  // D_s is written
  float lse2[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < p.Sq ? p.lse[rows + row] * fm::LOG2E : 0.f;
    Dr[r] = D_s[row - q0];
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float scale_log2 = p.scale * fm::LOG2E;

  for (int t = t_lo; t < t_end; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_end) {
      fm::load_tile<BN, HD, THREADS, HDP>(Ks + (st ^ 1) * BN * HDP, k, p.ss[K],
                                          (t + 1) * BN, p.Sk);
      fm::load_tile<BN, HD, THREADS, HDP>(Vs + (st ^ 1) * BN * HDP, v, p.ss[V],
                                          (t + 1) * BN, p.Sk);
    }
    fm::cp_async_commit();
    fm::cp_async_wait<1>();  // Q, dO and tile t have landed
    fm::fence_async_smem();
    __syncthreads();
    const fm::bf16* Kt = Ks + st * BN * HDP;
    const fm::bf16* Vt = Vs + st * BN * HDP;

    // S = Q K^T and dP = dO V^T for the warpgroup's 64 rows.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    fm::fence_operand(s);
    fm::fence_operand(dp);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      fm::wgmma_ss<BN>(s, fm::desc_k<BM>(Qs, wg * 64, kk),
                       fm::desc_k<BN>(Kt, 0, kk), 1);
      fm::wgmma_ss<BN>(dp, fm::desc_k<BM>(dOs, wg * 64, kk),
                       fm::desc_k<BN>(Vt, 0, kk), 1);
    }
    fm::wgmma_commit();
    fm::wgmma_wait<0>();
    fm::fence_operand(s);
    fm::fence_operand(dp);

    // Element (j, e) is row row0 + 8 * (e >> 1), key k0 + 8j + 2tq + (e & 1);
    // dS replaces dP in place.
    const int k0 = t * BN;
    const bool masked = mask.needs_mask(q0, BM, k0, BN);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
        if (masked &&
            !mask.live(row0 + 8 * (e >> 1), k0 + 8 * j + 2 * tq + (e & 1)))
          pe = 0.f;
        dp[j][e] = pe * (dp[j][e] - Dr[e >> 1]);
      }
    // dQ += dS K: dS, rounded to bf16, is A from registers; K is B read
    // transposed (MN-major).
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      fm::c_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
    fm::fence_operand(acc);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      fm::wgmma_rs<HDP>(acc, da[kk], fm::desc_mn<BN>(Kt, kk), 1);
    fm::wgmma_commit();
    fm::wgmma_wait<0>();
    fm::fence_operand(acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fm::fence_operand(da[kk]);
    __syncthreads();  // stage st consumed before it is loaded again
  }
  // The warp's own rows of the Q tile take its dQ (after the tile's copy
  // has landed, should the block have had no key tile).
  fm::cp_async_wait<0>();
  __syncthreads();
  fm::store_rows<BM, HD, HDP>(Qs, warp * 16, acc, p.scale, p.scale, dq,
                              p.ss[DQ], q0 + warp * 16, p.Sq, lane);
}

template <int HD>
__global__ void __launch_bounds__(Bf16Bwd<HD>::THREADS, 1)
    flash_bwd_dkv_bf16_kernel(Params p) {
  using Cfg = Bf16Bwd<HD>;
  constexpr int BK = Cfg::BK, BQ = Cfg::BQ, HDP = Cfg::HDP;
  constexpr int THREADS = Cfg::THREADS;
  constexpr int NS = BQ / 8;   // score n-tiles (query columns)
  constexpr int NO = HDP / 8;  // dK/dV n-tiles
  extern __shared__ __align__(1024) uint4 smem_tiles[];
  fm::bf16* Ks = reinterpret_cast<fm::bf16*>(smem_tiles);  // [BK][HDP]
  fm::bf16* Vs = Ks + BK * HDP;                             // [BK][HDP]
  fm::bf16* Qs = Vs + BK * HDP;                             // [2][BQ][HDP]
  fm::bf16* dOs = Qs + 2 * BQ * HDP;                        // [2][BQ][HDP]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * HDP);  // [2][BQ]
  float* D_s = lse_s + 2 * BQ;                                  // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;  // warpgroup: keys 64 wg .. 64 wg + 63
  const int tq = lane & 3;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // causal: the first key tiles are longest
  const int G = p.H / p.KV;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // this lane's keys: +0, +8
  const fm::Mask mask{p.Sq, p.Sk, p.causal, p.window};

  const fm::bf16* k =
      static_cast<const fm::bf16*>(p.k) + b * p.sb[K] + kvh * p.sh[K];
  const fm::bf16* v =
      static_cast<const fm::bf16*>(p.v) + b * p.sb[V] + kvh * p.sh[V];
  fm::bf16* dk = static_cast<fm::bf16*>(p.dk) + b * p.sb[DK] + kvh * p.sh[DK];
  fm::bf16* dv = static_cast<fm::bf16*>(p.dv) + b * p.sb[DV] + kvh * p.sh[DV];

  int t_lo, t_end;
  mask.query_tiles(k0, BK, BQ, &t_lo, &t_end);
  const int n_tiles = t_end - t_lo;
  const int n_iter = G * n_tiles;  // (query head, query tile) pairs

  // Q, dO, lse and D of iteration `it` into stage `st`.
  auto load_iter = [&](int it, int st) {
    const int h = kvh * G + it / n_tiles;
    const int q0 = (t_lo + it % n_tiles) * BQ;
    const fm::bf16* q =
        static_cast<const fm::bf16*>(p.q) + b * p.sb[Q] + h * p.sh[Q];
    const fm::bf16* dout =
        static_cast<const fm::bf16*>(p.dout) + b * p.sb[DO] + h * p.sh[DO];
    fm::load_tile<BQ, HD, THREADS, HDP>(Qs + st * BQ * HDP, q, p.ss[Q], q0,
                                        p.Sq);
    fm::load_tile<BQ, HD, THREADS, HDP>(dOs + st * BQ * HDP, dout, p.ss[DO],
                                        q0, p.Sq);
    const int64_t rows = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
      const int c = i % BQ;
      const bool ok = q0 + c < p.Sq;
      const float* src = (i < BQ ? p.lse : p.delta) + rows + (ok ? q0 + c : 0);
      fm::cp_async4((i < BQ ? lse_s : D_s) + st * BQ + c, src, ok);
    }
  };

  fm::load_tile<BK, HD, THREADS, HDP>(Ks, k, p.ss[K], k0, p.Sk);
  fm::load_tile<BK, HD, THREADS, HDP>(Vs, v, p.ss[V], k0, p.Sk);
  fm::cp_async_commit();
  if (n_iter > 0) load_iter(0, 0);
  fm::cp_async_commit();

  float acc_dk[NO][4], acc_dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  const float scale_log2 = p.scale * fm::LOG2E;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1;
    if (it + 1 < n_iter) load_iter(it + 1, st ^ 1);
    fm::cp_async_commit();
    fm::cp_async_wait<1>();  // K, V and iteration it have landed
    fm::fence_async_smem();
    __syncthreads();
    const int q0 = (t_lo + it % n_tiles) * BQ;
    const fm::bf16* Qt = Qs + st * BQ * HDP;
    const fm::bf16* dOt = dOs + st * BQ * HDP;
    const float* lse_t = lse_s + st * BQ;
    const float* D_t = D_s + st * BQ;

    // S^T = K Q^T for the warpgroup's 64 keys; element (j, e) is key
    // key0 + 8 * (e >> 1), query q0 + 8j + 2tq + (e & 1).  P^T replaces it.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    fm::fence_operand(s);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      fm::wgmma_ss<BQ>(s, fm::desc_k<BK>(Ks, wg * 64, kk),
                       fm::desc_k<BQ>(Qt, 0, kk), 1);
    fm::wgmma_commit();
    fm::wgmma_wait<0>();
    fm::fence_operand(s);
    const bool masked = mask.needs_mask(q0, BQ, k0, BK);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1);
        float pe = exp2f(fmaf(s[j][e], scale_log2, -lse_t[c] * fm::LOG2E));
        if (masked && !mask.live(q0 + c, key0 + 8 * (e >> 1))) pe = 0.f;
        s[j][e] = pe;
      }

    // dV += P^T dO (P^T from registers, dO read transposed), and
    // dP^T = V dO^T, issued together.
    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      fm::c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    float dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
    fm::fence_operand(acc_dv);
    fm::fence_operand(dp);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      fm::wgmma_rs<HDP>(acc_dv, pa[kk], fm::desc_mn<BQ>(dOt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      fm::wgmma_ss<BQ>(dp, fm::desc_k<BK>(Vs, wg * 64, kk),
                       fm::desc_k<BQ>(dOt, 0, kk), 1);
    fm::wgmma_commit();
    fm::wgmma_wait<0>();
    fm::fence_operand(acc_dv);
    fm::fence_operand(dp);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) fm::fence_operand(pa[kk]);

    // dS^T = P^T (dP^T - D), then dK += dS^T Q (Q read transposed).
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - D_t[8 * j + 2 * tq + (e & 1)]);
    uint32_t da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      fm::c_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
    fm::fence_operand(acc_dk);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      fm::wgmma_rs<HDP>(acc_dk, da[kk], fm::desc_mn<BQ>(Qt, kk), 1);
    fm::wgmma_commit();
    fm::wgmma_wait<0>();
    fm::fence_operand(acc_dk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) fm::fence_operand(da[kk]);
    __syncthreads();  // stage st consumed before it is loaded again
  }
  // The warp's own rows of the K and V tiles take its dK and dV (after the
  // tiles' copies have landed, should no query row see these keys).
  fm::cp_async_wait<0>();
  __syncthreads();
  fm::store_rows<BK, HD, HDP>(Ks, warp * 16, acc_dk, p.scale, p.scale, dk,
                              p.ss[DK], k0 + warp * 16, p.Sk, lane);
  fm::store_rows<BK, HD, HDP>(Vs, warp * 16, acc_dv, 1.f, 1.f, dv, p.ss[DV],
                              k0 + warp * 16, p.Sk, lane);
}

template <int HD>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using Cfg = Bf16Bwd<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::SMEM_DQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Cfg::SMEM_DKV));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_bf16_kernel<HD>
      <<<dim3(p.H, p.B, (p.Sq + Cfg::BM - 1) / Cfg::BM), Cfg::THREADS,
         Cfg::SMEM_DQ, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_bf16_kernel<HD>
      <<<dim3(p.KV, p.B, (p.Sk + Cfg::BK - 1) / Cfg::BK), Cfg::THREADS,
         Cfg::SMEM_DKV, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16_hd(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch_bf16<16>(p, stream);
    case 64: return launch_bf16<64>(p, stream);
    case 128: return launch_bf16<128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the tensor-core
// kernels, which need 16-byte aligned rows as the forward does).  strides:
// 24 element strides, the (batch, sequence, head) strides of q, k, v, o,
// dout, dq, dk and dv in that order.  lse: the forward's [B, H, Sq] fp32
// log-sum-exp; delta: a [B, H, Sq] fp32 scratch buffer.  Launches the dQ
// pass, then the dK/dV pass, on `stream` without synchronising; returns the
// first CUDA error (0 on success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int H, int KV, int Sq, int Sk,
                                   int head_dim,
                                   const int64_t* strides, float scale,
                                   int causal, int window, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  for (int t = 0; t < N_TENSORS; ++t) {
    p.sb[t] = strides[3 * t];
    p.ss[t] = strides[3 * t + 1];
    p.sh[t] = strides[3 * t + 2];
  }
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float>(p, head_dim, s);
    case 1: return launch_bf16_hd(p, head_dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
