// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan /
// _ssd_kernel / _segsum).  Per head h, with dA = dt * A[h] and cs its
// cumulative sum inside a chunk, each chunk computes
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (dual form)
//         + exp(cs_i) C_i . state                                 (carried state)
//   state = state exp(cs_last) + sum_j B_j exp(cs_last - cs_j) dt_j x_j
// B and C are shared by all heads (n_groups 1).  The state is fp32 and
// starts from the caller's initial state or zeros; y takes x's dtype.  x*dt
// is formed in fp32, as the Pallas kernel forms it.
//
// Design.  The TPU kernel walks the chunks on a sequential ("arbitrary")
// grid axis with the [head_block, P, N] state in VMEM.  Blocks on Hopper
// run in no order, so one thread block owns one (head, batch row) and walks
// the chunks in a loop, keeping its [P, N] state (32 KB at P 64, N 128) in
// shared memory for the whole sequence.  A whole chunk does not fit (at
// Q 256, N 128 the C and B rows alone take 256 KB in fp32), so inside a
// chunk the block tiles by 64 query rows: the carried-state term first,
// then an inner loop over 64-row key tiles up to the diagonal, each giving
// a masked, decayed [64, 64] score tile and its product with x*dt.  The
// decay exp(cs_i - cs_j) is taken only where j <= i; elsewhere the score is
// written as 0, so no exp of -inf differences is ever formed.  A last pass
// over the chunk's key tiles accumulates the state update in registers.
// The chunk's cumulative sum is a warp scan in shared memory.  The partial
// last chunk of a sequence that is not a multiple of the chunk is masked
// here, so any S is taken; the model's plain scan shrinks its chunk to
// gcd(S, chunk) instead, which is the same function.
//
// Bound.  At the serving shape (B 4, S 2048, H 32, P 64, N 128, chunk 256,
// bf16 x/B/C) one call moves ~77 MB (x and y 33.6 MB each, B and C 2.1 MB
// each, dt 1 MB, the fp32 state 4.2 MB) and does ~13 GFLOP with the causal
// half: ~23 us at the memory rate and ~13 us at the bf16 tensor-core rate
// of an H100 SXM, so bytes bound it.  This first kernel runs its products
// on the fp32 CUDA cores from shared memory, recomputes the C.B^T tiles in
// every head's block and uses 128 blocks on 132 SMs, so it sits far above
// that bound; tensor-core tiles are later work.
//
// Layout: x [B, S, H, P], Bm and Cm [B, S, N] read through their own
// batch/sequence(/head) strides with the last dimension contiguous, so the
// model's slices of the conv output need no copy; dt [B, S, H] fp32 by
// strides; A [H] fp32; the initial and final state [B, H, P, N] and y
// [B, S, H, P] contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y).  strides: 10 element
// strides, x (batch, sequence, head), dt (batch, sequence, head), Bm
// (batch, sequence) and Cm (batch, sequence).  init may be null.  Returns
// the CUDA error of the launch (0 on success); launches on `stream` and
// does not synchronise.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const float* dt,
                            const float* A, const void* Bm, const void* Cm,
                            const float* init, void* y, float* state_out,
                            int B, int S, int H, int P, int N, int chunk,
                            const int64_t* strides, void* stream) {
  Params p{x, dt, A, Bm, Cm, init, y, state_out, B, S, H, chunk,
           strides[0], strides[1], strides[2],
           strides[3], strides[4], strides[5],
           strides[6], strides[7],
           strides[8], strides[9]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_shape<float>(p, P, N, s);
    case 1: return launch_shape<__nv_bfloat16>(p, P, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
