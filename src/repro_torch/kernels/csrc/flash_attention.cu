// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel): softmax(q k^T * scale + mask) v as an
// online softmax over K tiles, with GQA (query head h reads KV head
// h*KV/H), causal and sliding-window masks, queries right-aligned when
// Sq < Sk, wholly masked tiles skipped, masked logits -1e30 and the
// denominator clamped at 1e-30.  Running max, sum and accumulator are fp32;
// the output takes q's dtype.  Where the caller passes an lse buffer (the
// train path), each query row's log-sum-exp m + log(max(l, 1e-30)) is
// written there in fp32 for the backward (csrc/flash_attention_bwd.cu); a
// null pointer skips it, so serving does the same work as without it.
//
// Two kernels, chosen by dtype in the C entry point (not a fallback: each
// dtype has exactly one kernel, and nothing else reaches the other):
//
// bfloat16 -- flash_fwd_bf16_kernel, on the tensor cores (wgmma),
// FlashAttention-2's shape on Hopper.  One block per (128 query rows, query
// head, batch row): two warpgroups of 64 rows, eight warps of 16 rows; the
// grid's slowest axis walks the query tiles in reverse, so the longest
// causal rows start first.  Q is staged once in bf16 shared memory; K and V
// tiles of 128 rows run through a two-stage ring, the next tile loading by
// 16-byte cp.async while the current one is used.  Every tile is bf16 in the
// 128-byte swizzled layout wgmma reads (csrc/flash_mma.cuh; head_dim 16 is
// zero-padded to 64 columns there).  S = Q K^T is wgmma.m64n128k16 with both
// operands in shared memory (bf16 in, fp32 accumulate); the scores and the
// online softmax stay in registers (quad shuffles, exp2f with scale *
// log2(e) folded in); P is rounded to bf16 in registers and is the A
// operand of O += P V (wgmma with A from registers, V read transposed).
// Only tiles that cross the diagonal, the window edge or the ragged end
// take the per-element mask; wholly masked tiles are not visited.  The
// output is normalised in fp32, rounded once to bf16 and stored in 16-byte
// stores through shared memory.  Shared memory: 160 KB at hd 128 (Q 32 KB,
// K and V in two stages 128 KB); 255 registers, one block per SM.  Key
// tiles of 128 beat tiles of 64 on the card, and wgmma beat the same kernel
// on mma.sync with ldmatrix fragments (PERF.md).
//
// float32 -- flash_fwd_kernel, the CUDA-core kernel of the first port: one
// block per (64-query tile, query head, batch row) loops over the K tiles,
// staged in shared memory as fp32; scores go to shared memory, four threads
// per query row update the online softmax, and P V accumulates in
// registers (83 KB at hd 128).  Float32 runs no tensor-core product: TF32
// would not hold the float32 tolerance of 2e-5.
//
// Bound.  At the serving shape (B 4, H 28, KV 4, S 512, hd 128, causal,
// bf16) the work is ~7.5 GFLOP over ~34 MB of q/k/v/o: ~7.6 us at the
// tensor-core rate and ~10 us at the memory rate of an H100 SXM (989
// TFLOP/s bf16, 3.35 TB/s), so bytes bound it; at the train shape (B 2,
// S 4096) 240 GFLOP, 0.24 ms, so operations bound it.  The bf16 kernel
// waits for each product before the softmax that follows it, so the
// tensor cores idle while the softmax runs; TMA loads, warp
// specialisation (a producer warp, two consumer warpgroups taking turns)
// and packing a KV head's query heads into one block are what remains
// (ROADMAP).
//
// Layout: q [B, Sq, H, hd], k/v [B, Sk, KV, hd], o [B, Sq, H, hd], each
// with its own batch/sequence/head strides (in elements) and head_dim
// contiguous, so the model's [B, S, H, hd] tensors need no transpose.  The
// ragged edge (S not a multiple of a tile) is masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_mma.cuh"

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 256;
constexpr int LDP = BLOCK_K + 1;  // padded row stride of the score tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq] fp32, or null
  int B, H, KV, Sq, Sk;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
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

static_assert(BLOCK_Q == BLOCK_K, "load_tile stages square tiles");
static_assert(THREADS == 4 * BLOCK_Q, "four threads per query row");

template <int HD>
constexpr size_t smem_bytes() {
  // Q tile + one K/V tile (rows padded to HD + 1), score tile, m/l/alpha.
  return sizeof(float) *
         ((BLOCK_Q + BLOCK_K) * (HD + 1) + BLOCK_Q * LDP + 3 * BLOCK_Q);
}

// Stage rows [row0, row0 + BLOCK_K) of one head into shared memory as
// fp32, zero-filling rows at or past n_rows.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < BLOCK_K * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int row = row0 + r;
    dst[r * LD + d] = row < n_rows ? to_float(src[row * row_stride + d]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd_kernel(Params p) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BLOCK_Q][LD]
  float* KVs = Qs + BLOCK_Q * LD;    // [BLOCK_K][LD]: K, then V, of one tile
  float* Ps = KVs + BLOCK_K * LD;    // [BLOCK_Q][LDP]: scores, then probs
  float* m_s = Ps + BLOCK_Q * LDP;   // running max per query row
  float* l_s = m_s + BLOCK_Q;        // running sum per query row
  float* a_s = l_s + BLOCK_Q;        // rescale factor of the current tile

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * p.KV / p.H;
  const int off = p.Sk - p.Sq;  // queries are right-aligned

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile<T, HD>(Qs, q, p.q_ss, q0, p.Sq);
  if (tid < BLOCK_Q) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // Score mapping: a 16 x 16 thread grid, 4 x 4 scores per thread
  // (rows sy*4 + i, columns sx + 16*j).
  const int sx = tid % 16, sy = tid / 16;
  // Accumulator mapping: TX threads across head_dim, RPT rows x CPT
  // columns per thread (rows ay*RPT + i, columns ax + TX*j).
  constexpr int TX = HD < 32 ? HD : 32;
  constexpr int TY = THREADS / TX;
  constexpr int RPT = BLOCK_Q / TY;
  constexpr int CPT = HD / TX;
  const int ax = tid % TX, ay = tid / TX;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // Key range any row of this tile can see; tiles outside it are skipped.
  const int q_last = min(q0 + BLOCK_Q, p.Sq) - 1;
  const int k_lo = p.window ? max(0, q0 + off - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.Sk - 1, q_last + off) : p.Sk - 1;
  const int t_lo = k_lo / BLOCK_K;
  const int t_end = k_hi >= k_lo ? k_hi / BLOCK_K + 1 : t_lo;

  for (int t = t_lo; t < t_end; ++t) {
    const int k0 = t * BLOCK_K;
    __syncthreads();  // Q staged; the previous tile's V and P are consumed
    load_tile<T, HD>(KVs, k, p.k_ss, k0, p.Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(sy * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(sx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sy * 4 + i;
      const int q_pos = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sx + 16 * j;
        const int k_pos = k0 + c;
        bool live = k_pos < p.Sk;
        if (p.causal) live = live && k_pos <= q_pos;
        if (p.window) live = live && k_pos > q_pos - p.window;
        Ps[r * LDP + c] = live ? s[i][j] * p.scale : NEG_INF;
      }
    }
    __syncthreads();  // scores written, K no longer read

    load_tile<T, HD>(KVs, v, p.v_ss, k0, p.Sk);
    {
      // Online softmax: four neighbouring lanes share a row, 16 columns
      // each, and combine their max and sum by shuffles.
      constexpr int COLS = BLOCK_K / 4;
      const int r = tid / 4, part = tid % 4;
      float* row = Ps + r * LDP + part * COLS;
      const float m_prev = m_s[r];
      float m_new = m_prev;
#pragma unroll
      for (int c = 0; c < COLS; ++c) m_new = fmaxf(m_new, row[c]);
      m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
      m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float e = expf(row[c] - m_new);
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();  // V staged, probabilities and alpha ready

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float alpha = a_s[ay * RPT + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BLOCK_K; ++c) {
      float vv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = KVs[c * LD + ax + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pr = Ps[(ay * RPT + i) * LDP + c];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pr, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // l_s final (also when no tile was live)

  if (p.lse != nullptr && tid < BLOCK_Q && q0 + tid < p.Sq)
    p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ay * RPT + i;
    const int qi = q0 + r;
    if (qi >= p.Sq) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      o[qi * p.o_ss + ax + TX * j] = from_float<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + BLOCK_Q - 1) / BLOCK_Q, p.H, p.B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------ bfloat16, tensor cores

namespace fm = flash_mma;

template <int HD>
struct Bf16Fwd {
  static constexpr int BM = 128;                   // query rows per block
  static constexpr int BN = 128;                   // key rows per tile
  static constexpr int HDP = fm::tile_hd(HD);      // head_dim in the tiles
  static constexpr int THREADS = 128 * (BM / 64);  // a warpgroup per 64 rows
  // Q, then K and V in two stages each.
  static constexpr size_t SMEM = sizeof(fm::bf16) * (BM + 4 * BN) * HDP;
  static_assert(BN / 2 <= 64, "a 64-bit mask covers a lane's scores");
};

template <int HD>
__global__ void __launch_bounds__(Bf16Fwd<HD>::THREADS, 1)
    flash_fwd_bf16_kernel(Params p) {
  using Cfg = Bf16Fwd<HD>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, HDP = Cfg::HDP;
  constexpr int THREADS = Cfg::THREADS;
  constexpr int NS = BN / 8;   // score n-tiles
  constexpr int NO = HDP / 8;  // output n-tiles
  extern __shared__ __align__(1024) uint4 smem_tiles[];
  fm::bf16* Qs = reinterpret_cast<fm::bf16*>(smem_tiles);  // [BM][HDP]
  fm::bf16* Ks = Qs + BM * HDP;                             // [2][BN][HDP]
  fm::bf16* Vs = Ks + 2 * BN * HDP;                         // [2][BN][HDP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;  // warpgroup: query rows 64 wg .. 64 wg + 63
  const int tq = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest rows first
  const int kvh = h * p.KV / p.H;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: +0, +8
  const fm::Mask mask{p.Sq, p.Sk, p.causal, p.window};

  const fm::bf16* q =
      static_cast<const fm::bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const fm::bf16* k =
      static_cast<const fm::bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const fm::bf16* v =
      static_cast<const fm::bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  fm::bf16* out = static_cast<fm::bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  int t_lo, t_end;
  mask.key_tiles(q0, BM, BN, &t_lo, &t_end);

  fm::load_tile<BM, HD, THREADS, HDP>(Qs, q, p.q_ss, q0, p.Sq);
  if (t_lo < t_end) {
    fm::load_tile<BN, HD, THREADS, HDP>(Ks, k, p.k_ss, t_lo * BN, p.Sk);
    fm::load_tile<BN, HD, THREADS, HDP>(Vs, v, p.v_ss, t_lo * BN, p.Sk);
  }
  fm::cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // Running max (log2 units) and this lane's part of the running sum.
  float m[2] = {fm::NEG_INF, fm::NEG_INF}, l[2] = {0.f, 0.f};
  const float scale_log2 = p.scale * fm::LOG2E;

  for (int t = t_lo; t < t_end; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_end) {  // the next tile loads while this one is used
      fm::load_tile<BN, HD, THREADS, HDP>(Ks + (st ^ 1) * BN * HDP, k, p.k_ss,
                                          (t + 1) * BN, p.Sk);
      fm::load_tile<BN, HD, THREADS, HDP>(Vs + (st ^ 1) * BN * HDP, v, p.v_ss,
                                          (t + 1) * BN, p.Sk);
    }
    fm::cp_async_commit();
    fm::cp_async_wait<1>();  // Q and tile t have landed
    fm::fence_async_smem();
    __syncthreads();
    const fm::bf16* Kt = Ks + st * BN * HDP;
    const fm::bf16* Vt = Vs + st * BN * HDP;

    // S = Q K^T for the warpgroup's 64 rows (K-major A and B).
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    fm::fence_operand(s);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      fm::wgmma_ss<BN>(s, fm::desc_k<BM>(Qs, wg * 64, kk),
                       fm::desc_k<BN>(Kt, 0, kk), 1);
    fm::wgmma_commit();
    fm::wgmma_wait<0>();
    fm::fence_operand(s);

    // Element (j, e) is row row0 + 8 * (e >> 1), key k0 + 8j + 2tq + (e & 1);
    // bit 4j + e of `dead` says it is not live (only on masked tiles).
    const int k0 = t * BN;
    uint64_t dead = 0;
    if (mask.needs_mask(q0, BM, k0, BN)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!mask.live(row0 + 8 * (e >> 1), k0 + 8 * j + 2 * tq + (e & 1)))
            dead |= uint64_t{1} << (4 * j + e);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] =
            (dead >> (4 * j + e)) & 1 ? fm::NEG_INF : s[j][e] * scale_log2;
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fm::quad_max(mx);
      alpha[r] = exp2f(m[r] - mx);
      m[r] = mx;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe =
            (dead >> (4 * j + e)) & 1 ? 0.f : exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = pe;
        rowsum[e >> 1] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += P V: P, rounded to bf16, is A from registers; V is B read
    // transposed (MN-major).
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      fm::c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    fm::fence_operand(acc);
    fm::wgmma_arrive();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      fm::wgmma_rs<HDP>(acc, pa[kk], fm::desc_mn<BN>(Vt, kk), 1);
    fm::wgmma_commit();
    fm::wgmma_wait<0>();
    fm::fence_operand(acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fm::fence_operand(pa[kk]);
    __syncthreads();  // stage st consumed before it is loaded again
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(fm::quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / denom;
    const int row = row0 + 8 * r;
    if (p.lse != nullptr && tq == 0 && row < p.Sq)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + row] =
          m[r] * fm::LN2 + logf(denom);
  }
  // The warp's own rows of the Q tile take its output.
  fm::store_rows<BM, HD, HDP>(Qs, warp * 16, acc, inv[0], inv[1], out,
                              p.o_ss, q0 + warp * 16, p.Sq, lane);
}

template <int HD>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using Cfg = Bf16Fwd<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, p.B, (p.Sq + Cfg::BM - 1) / Cfg::BM);
  flash_fwd_bf16_kernel<HD><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16_hd(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch_bf16<16>(p, stream);
    case 32: return launch_bf16<32>(p, stream);
    case 64: return launch_bf16<64>(p, stream);
    case 128: return launch_bf16<128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor-core kernel, which needs 16-byte aligned rows: base pointers, and
// the batch, sequence and head strides of dimensions longer than one, in
// multiples of 8 elements).  strides: 12 element strides, the
// (batch, sequence, head) strides of q, k, v and o in that order.  lse: a
// contiguous [B, H, Sq] fp32 buffer for the rows' log-sum-exp, or null.
// Returns the CUDA error of the launch (0 on success); launches on `stream`
// and does not synchronise.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int B, int H,
                                   int KV, int Sq, int Sk, int head_dim,
                                   const int64_t* strides, float scale,
                                   int causal, int window, void* stream) {
  Params p{q, k, v, o, lse, B, H, KV, Sq, Sk,
           strides[0], strides[1], strides[2],
           strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8],
           strides[9], strides[10], strides[11],
           scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float>(p, head_dim, s);
    case 1: return launch_bf16_hd(p, head_dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
