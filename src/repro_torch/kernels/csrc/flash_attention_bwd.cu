// Flash attention backward for Hopper (sm_90a), plain CUDA C++.
//
// The gradient of the forward in csrc/flash_attention.cu for
// self-attention (Sq == Sk): dQ, dK and dV from q, k, v, the forward's
// output o, the upstream gradient dO and the forward's per-row log-sum-exp
// lse.  The Pallas TPU kernel repro/kernels/flash_attention.py is
// forward-only (JAX differentiates its jnp attention), so this kernel has no
// TPU counterpart; it is the backward of the port's autograd.Function
// (kernels/ops.py).  The probabilities are recomputed, never stored:
//   P = exp(q k^T * scale - lse)    (0 where masked)
//   D_i = rowsum(dO * O)_i
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// GQA: key/value head j serves query heads j*G .. j*G + G-1 (G = H / KV),
// and its dK/dV sum over those heads.  Causal and sliding-window masks as
// in the forward; any sequence length (the ragged edge is masked).  Masked
// entries get P = 0 from a predicate, so a row with no live key (lse =
// -1e30 + log(1e-30)) never forms exp(inf) or inf - inf.
//
// Design: two kernels from one launch call, both without atomics.
//  1. flash_bwd_dq_kernel, one block per (64-query tile, query head, batch
//     row): stages Q and dO, computes D for its rows (written to a [B, H, S]
//     fp32 buffer for pass 2), then walks the live key tiles as the forward
//     does and accumulates dQ in registers.
//  2. flash_bwd_dkv_kernel, one block per (64-key tile, KV head, batch row):
//     keeps its K and V tiles in shared memory and walks the G query heads'
//     live query tiles, accumulating dK and dV in registers; it owns its
//     rows of dK/dV, so nothing is summed across blocks.
// Products run on the fp32 CUDA cores from fp32 tiles in shared memory, as
// in the forward (four 64 x (hd+1) tiles plus one or two 64 x 65 score
// tiles: 149 KB and 166 KB at head_dim 128, one block per SM).
//
// Bound.  Five products of the forward's size (the recomputed scores, dP,
// dV, dK, dQ): 2.5x the forward's work, 601 GFLOP at the train shape (B 2,
// S 4096, H 28, KV 4, hd 128, causal), 0.608 ms at the bf16 tensor-core
// rate of an H100 SXM, so operations bound it.  This first kernel runs on
// the fp32 CUDA cores without tensor cores, TMA or pipelining; making it
// fast is later work.
//
// Layout: q/o/dO/dQ [B, S, H, hd], k/v/dK/dV [B, S, KV, hd], each with its
// own (batch, sequence, head) strides in elements and head_dim contiguous;
// lse and D contiguous [B, H, S] fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
  const float* lse;  // [B, H, S]
  float* delta;      // [B, H, S], written by pass 1, read by pass 2
  void* dq;
  void* dk;
  void* dv;
  int B, H, KV, S;
  int64_t sb[N_TENSORS], ss[N_TENSORS], sh[N_TENSORS];
  float scale;
  int causal, window;
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

__device__ __forceinline__ bool is_live(const Params& p, int qi, int kj) {
  if (qi >= p.S || kj >= p.S) return false;
  if (p.causal && kj > qi) return false;
  if (p.window && kj <= qi - p.window) return false;
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
  const int64_t rows = (static_cast<int64_t>(b) * p.H + h) * p.S;

  const T* q = static_cast<const T*>(p.q) + b * p.sb[Q] + h * p.sh[Q];
  const T* k = static_cast<const T*>(p.k) + b * p.sb[K] + kvh * p.sh[K];
  const T* v = static_cast<const T*>(p.v) + b * p.sb[V] + kvh * p.sh[V];
  const T* o = static_cast<const T*>(p.o) + b * p.sb[O] + h * p.sh[O];
  const T* dout = static_cast<const T*>(p.dout) + b * p.sb[DO] + h * p.sh[DO];
  T* dq = static_cast<T*>(p.dq) + b * p.sb[DQ] + h * p.sh[DQ];

  load_tile<T, HD>(Qs, q, p.ss[Q], q0, p.S);
  load_tile<T, HD>(dOs, dout, p.ss[DO], q0, p.S);
  __syncthreads();
  {
    // D = rowsum(dO * O): four neighbouring lanes per row, combined by
    // shuffles.
    const int r = tid / 4, part = tid % 4;
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < p.S)
      for (int d = part; d < HD; d += 4)
        acc = fmaf(dOs[r * LD + d], to_float(o[qi * p.ss[O] + d]), acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      D_s[r] = acc;
      lse_s[r] = qi < p.S ? p.lse[rows + qi] : 0.f;
      if (qi < p.S) p.delta[rows + qi] = acc;
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
  const int q_last = min(q0 + BLOCK, p.S) - 1;
  const int k_lo = p.window ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? q_last : p.S - 1;
  const int t_lo = k_lo / BLOCK;
  const int t_end = k_hi >= k_lo ? k_hi / BLOCK + 1 : t_lo;

  for (int t = t_lo; t < t_end; ++t) {
    const int k0 = t * BLOCK;
    __syncthreads();  // D/lse staged; the previous tile's K and dS consumed
    load_tile<T, HD>(Ks, k, p.ss[K], k0, p.S);
    load_tile<T, HD>(Vs, v, p.ss[V], k0, p.S);
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
    if (qi >= p.S) continue;
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

  load_tile<T, HD>(Ks, k, p.ss[K], k0, p.S);
  load_tile<T, HD>(Vs, v, p.ss[V], k0, p.S);

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
  const int k_last = min(k0 + BLOCK, p.S) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window ? min(p.S - 1, k_last + p.window - 1) : p.S - 1;
  const int t_lo = q_lo / BLOCK;
  const int t_end = q_hi >= q_lo ? q_hi / BLOCK + 1 : t_lo;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t rows = (static_cast<int64_t>(b) * p.H + h) * p.S;
    const T* q = static_cast<const T*>(p.q) + b * p.sb[Q] + h * p.sh[Q];
    const T* dout =
        static_cast<const T*>(p.dout) + b * p.sb[DO] + h * p.sh[DO];
    for (int t = t_lo; t < t_end; ++t) {
      const int q0 = t * BLOCK;
      __syncthreads();  // the previous tile's Q, dO, P and dS consumed
      load_tile<T, HD>(Qs, q, p.ss[Q], q0, p.S);
      load_tile<T, HD>(dOs, dout, p.ss[DO], q0, p.S);
      if (tid < BLOCK) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < p.S ? p.lse[rows + qi] : 0.f;
        D_s[tid] = qi < p.S ? p.delta[rows + qi] : 0.f;
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
    if (kj >= p.S) continue;
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
  const int tiles = (p.S + BLOCK - 1) / BLOCK;
  flash_bwd_dq_kernel<T, HD>
      <<<dim3(tiles, p.H, p.B), THREADS, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<T, HD>
      <<<dim3(tiles, p.KV, p.B), THREADS, dkv_smem, stream>>>(p);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 24 element strides, the
// (batch, sequence, head) strides of q, k, v, o, dout, dq, dk and dv in that
// order.  lse: the forward's [B, H, S] fp32 log-sum-exp; delta: a [B, H, S]
// fp32 scratch buffer.  Launches the dQ pass, then the dK/dV pass, on
// `stream` without synchronising; returns the first CUDA error (0 on
// success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int H, int KV, int S, int head_dim,
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
  p.S = S;
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
    case 1: return launch_hd<__nv_bfloat16>(p, head_dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
