// AdamW's step over every leaf of a parameter tree, for Hopper (sm_90a),
// CUDA C++: three launches a step, whatever the number of leaves.
//
// Replaces no TPU kernel: the JAX package's AdamW (repro/optim/adamw.py) is
// plain jnp, which XLA fuses.  Eager PyTorch does not, and its per-leaf loop
// (optim/adamw.py's plain version) streams each leaf through device memory
// some twenty times.  Per element, in fp32, in JAX's order:
//   g32 = float(g) * scale
//   m   = b1*m + (1-b1)*g32
//   v   = b2*v + ((1-b2)*g32)*g32
//   u   = (m / b1c) / (sqrt(v / b2c) + eps),   u += wd * float(p) if decayed
//   p   = p + round_p(-lr * u)                 (the sum rounded to p's dtype)
// each operation rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), so that no contraction moves m and v off the plain loop's.
//
// Bound.  The memory rate: the global norm reads g once, the update reads
// p, g, m and v and writes p, m and v, a few dozen operations an element.
// With bf16 p and g and fp32 moments that is 24 bytes a parameter (2.90 B
// parameters of mixtral-8x22b's layer: 69.5 GB, 20.8 ms at 3.35 TB/s).  So
// each launch touches each byte once, in 16-byte loads and stores.
//
// Layout.  Every leaf is cut into chunks of CHUNK elements (the last one
// ragged), so no chunk straddles two leaves, and a block takes one chunk.
// The leaves' pointers and sizes sit in a table on the device (the caller
// keeps it while the parameters and moments stay where they are); the
// gradients' pointers, new each step, come in an array of their own.  Small
// leaves share the launches of the large ones: a model of ~435 leaves takes
// three launches a step as one of 4 does.
//   adamw_sumsq   a block a chunk: the sum of the chunk's squares of g, in
//                 fp32, a warp-shuffle then shared-memory sum in a fixed
//                 order, written as one double partial.  No atomics.
//   adamw_finish  one block: the partials summed in double in a fixed order;
//                 gnorm = sqrt(sum), scale = min(clip / (gnorm + 1e-9), 1),
//                 both written to the device (no host sync).
//   adamw_update  a block a chunk: the step above, the scale read from the
//                 device.
// p and g float32 or bf16 (a leaf's dtype in its meta word), m and v
// float32.  Offsets are 64-bit: one expert leaf's fp32 moment is 3.2 GB.  A chunk
// whose four pointers are not 16-byte aligned takes scalar loads (a leaf
// that is a view at an odd offset); chunks start at multiples of 8
// elements, so an aligned leaf's chunks are aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum : int { F32 = 0, BF16 = 1 };   // kernels/adamw.py DTYPES

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int64_t CHUNK = 65536;   // elements a chunk; kernels/adamw.py
constexpr int VEC = 8;             // elements a thread handles at a time
constexpr int FINISH_THREADS = 1024;

// The leaf table: int64 rows of n_leaves entries, in this order.
enum : int { ROW_P = 0, ROW_M, ROW_V, ROW_NUMEL, ROW_META, ROWS };
// meta: bits 0-3 the dtype of p (and g), bit 8 the decay flag.

struct Hyper {
  float b1, omb1, b2, omb2, b1c, b2c, eps, neg_lr, wd;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements at an aligned address, in 16-byte pieces, as fp32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* out) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int piece = 0; piece < VEC / PER; ++piece) {
    uint4 raw = reinterpret_cast<const uint4*>(src)[piece];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) out[piece * PER + i] = to_f(e[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const float* in) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int piece = 0; piece < VEC / PER; ++piece) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) e[i] = from_f<T>(in[piece * PER + i]);
    reinterpret_cast<uint4*>(dst)[piece] = raw;
  }
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// A chunk: its leaf and its first element.
struct Chunk {
  int leaf;
  int64_t start, len;
};

__device__ __forceinline__ Chunk chunk_of(const int64_t* chunks,
                                          const int64_t* table,
                                          int64_t n_leaves) {
  const int64_t c = chunks[blockIdx.x];
  Chunk k;
  k.leaf = static_cast<int>(c >> 32);
  k.start = (c & 0xffffffffLL) * CHUNK;
  const int64_t numel = table[ROW_NUMEL * n_leaves + k.leaf];
  k.len = numel - k.start < CHUNK ? numel - k.start : CHUNK;
  return k;
}

// The block's sum of ``v`` over its threads, in a fixed order; valid in
// thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* shared, int warps) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < warps ? shared[lane] : T(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename G>
__device__ float chunk_sumsq(const G* g, int64_t len) {
  float acc = 0.f;
  const int64_t nvec = aligned16(g) ? len / VEC : 0;
  for (int64_t i = threadIdx.x; i < nvec; i += THREADS) {
    float f[VEC];
    load_vec(g + i * VEC, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc = __fmaf_rn(f[j], f[j], acc);
  }
  for (int64_t i = nvec * VEC + threadIdx.x; i < len; i += THREADS) {
    const float f = to_f(g[i]);
    acc = __fmaf_rn(f, f, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
adamw_sumsq_kernel(const int64_t* __restrict__ chunks,
                   const int64_t* __restrict__ table, int64_t n_leaves,
                   const int64_t* __restrict__ grads,
                   double* __restrict__ partials) {
  __shared__ float shared[WARPS];
  const Chunk k = chunk_of(chunks, table, n_leaves);
  const int dtype =
      static_cast<int>(table[ROW_META * n_leaves + k.leaf] & 0xf);
  const void* g = reinterpret_cast<const void*>(grads[k.leaf]);
  float acc;
  if (dtype == F32)
    acc = chunk_sumsq(static_cast<const float*>(g) + k.start, k.len);
  else
    acc = chunk_sumsq(static_cast<const __nv_bfloat16*>(g) + k.start, k.len);
  acc = block_sum(acc, shared, WARPS);
  if (threadIdx.x == 0) partials[blockIdx.x] = static_cast<double>(acc);
}

__global__ void __launch_bounds__(FINISH_THREADS)
adamw_finish_kernel(const double* __restrict__ partials, int64_t n,
                    float clip, float* __restrict__ out) {
  __shared__ double shared[FINISH_THREADS / 32];
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < n; i += FINISH_THREADS) acc += partials[i];
  acc = block_sum(acc, shared, FINISH_THREADS / 32);
  if (threadIdx.x == 0) {
    const float gnorm = static_cast<float>(sqrt(acc));
    const float s = __fdiv_rn(clip, __fadd_rn(gnorm, 1e-9f));
    out[0] = gnorm;
    out[1] = s > 1.f ? 1.f : s;   // NaN stays NaN, as torch.clamp keeps it
  }
}

// One element's step; p in and out as fp32 (out already rounded to P).
template <typename P>
__device__ __forceinline__ void step(float& p, float g, float& m, float& v,
                                     float scale, bool decay,
                                     const Hyper& h) {
  const float g32 = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g32));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g32), g32));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.b2c)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m, h.b1c), den);
  if (decay) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  const float d = to_f(from_f<P>(__fmul_rn(h.neg_lr, u)));
  p = to_f(from_f<P>(__fadd_rn(p, d)));
}

template <typename P>
__device__ void chunk_update(P* p, const P* g, float* m, float* v,
                             int64_t len, float scale, bool decay,
                             const Hyper& h) {
  const bool fast = aligned16(p) && aligned16(g) && aligned16(m) &&
                    aligned16(v);
  const int64_t nvec = fast ? len / VEC : 0;
  for (int64_t i = threadIdx.x; i < nvec; i += THREADS) {
    const int64_t at = i * VEC;
    float pf[VEC], gf[VEC], mf[VEC], vf[VEC];
    load_vec(g + at, gf);
    load_vec(p + at, pf);
    load_vec(m + at, mf);
    load_vec(v + at, vf);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      step<P>(pf[j], gf[j], mf[j], vf[j], scale, decay, h);
    store_vec(p + at, pf);
    store_vec(m + at, mf);
    store_vec(v + at, vf);
  }
  for (int64_t i = nvec * VEC + threadIdx.x; i < len; i += THREADS) {
    float pf = to_f(p[i]), mf = m[i], vf = v[i];
    step<P>(pf, to_f(g[i]), mf, vf, scale, decay, h);
    p[i] = from_f<P>(pf);
    m[i] = mf;
    v[i] = vf;
  }
}

template <typename P>
__device__ __forceinline__ void update_as(const int64_t* table,
                                         int64_t n_leaves, const Chunk& k,
                                         const void* g, float scale,
                                         bool decay, const Hyper& h) {
  auto row = [&](int r) { return table[r * n_leaves + k.leaf]; };
  chunk_update(reinterpret_cast<P*>(row(ROW_P)) + k.start,
               static_cast<const P*>(g) + k.start,
               reinterpret_cast<float*>(row(ROW_M)) + k.start,
               reinterpret_cast<float*>(row(ROW_V)) + k.start, k.len, scale,
               decay, h);
}

__global__ void __launch_bounds__(THREADS)
adamw_update_kernel(const int64_t* __restrict__ chunks,
                    const int64_t* __restrict__ table, int64_t n_leaves,
                    const int64_t* __restrict__ grads,
                    const float* __restrict__ scale_at, Hyper h) {
  const Chunk k = chunk_of(chunks, table, n_leaves);
  const int64_t meta = table[ROW_META * n_leaves + k.leaf];
  const bool decay = (meta >> 8) & 1;
  const float scale = scale_at[0];
  const void* g = reinterpret_cast<const void*>(grads[k.leaf]);
  if (static_cast<int>(meta & 0xf) == F32)
    update_as<float>(table, n_leaves, k, g, scale, decay, h);
  else
    update_as<__nv_bfloat16>(table, n_leaves, k, g, scale, decay, h);
}

bool bad_grid(int64_t n) { return n < 1 || n > 0x7fffffffLL; }

}  // namespace

// Each entry point launches on ``stream`` and returns cudaGetLastError().
// chunks: n_chunks int64 (leaf << 32 | index of the chunk in its leaf);
// table: ROWS x n_leaves int64 (p, m, v pointers, numel, meta); grads:
// n_leaves int64 gradient pointers, of p's dtype.

// partials[c] = sum over chunk c of g^2.
extern "C" int adamw_sumsq(const int64_t* chunks, int64_t n_chunks,
                           const int64_t* table, int64_t n_leaves,
                           const int64_t* grads, double* partials,
                           void* stream) {
  if (bad_grid(n_chunks) || n_leaves < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  adamw_sumsq_kernel<<<static_cast<unsigned>(n_chunks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      chunks, table, n_leaves, grads, partials);
  return static_cast<int>(cudaGetLastError());
}

// out[0] = sqrt(sum of the n values), out[1] = min(clip / (out[0] + 1e-9), 1).
extern "C" int adamw_finish(const double* values, int64_t n, float clip,
                            float* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  adamw_finish_kernel<<<1, FINISH_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(values, n, clip,
                                                             out);
  return static_cast<int>(cudaGetLastError());
}

// The step of every chunk, g scaled by *scale.
extern "C" int adamw_update(const int64_t* chunks, int64_t n_chunks,
                            const int64_t* table, int64_t n_leaves,
                            const int64_t* grads, const float* scale,
                            float b1, float omb1, float b2, float omb2,
                            float b1c, float b2c, float eps, float neg_lr,
                            float wd, void* stream) {
  if (bad_grid(n_chunks) || n_leaves < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{b1, omb1, b2, omb2, b1c, b2c, eps, neg_lr, wd};
  adamw_update_kernel<<<static_cast<unsigned>(n_chunks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      chunks, table, n_leaves, grads, scale, h);
  return static_cast<int>(cudaGetLastError());
}
