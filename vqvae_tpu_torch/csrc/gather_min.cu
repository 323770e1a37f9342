// Column-wise min over randomly gathered rows for Hopper (sm_90a): kernel K4.
//
// Replaces the Pallas TPU kernel _gather_min_kernel of
// tools/bench_pallas_gather.py (:39), reached through pl.pallas_call in
// pallas_gather_min (:101): the access pattern of the ELL relaxation's sweep,
//   out[0, c] = min_j d[idx[j], c]      d (N, K) f32, idx (R,) int32,
// with jnp.minimum's semantics: +inf when nothing is gathered, and a NaN in
// any gathered value of a column makes that column NaN (fminf would drop
// it). Min is exact, so the result is bitwise that of the plain version
// (vqvae_tpu_torch/ops/gather_min.py gather_min_reference) in any order.
//
// Design. The TPU kernel walks CHUNK = 1024 indices per grid step with an
// S-deep ring of one-row DMAs into VMEM and a sequential min into the output
// block. Here blocks run in parallel: block (x, y) takes chunk x of idx
// (kChunk = 1024 indices, staged in shared memory) and column tile y of
// kThreads vectors (float4 when K % 4 == 0, else float). Each thread owns one
// column vector; when a row is narrower than the tile, the block's threads
// split into G row groups (G = kThreads / tile), each walking every G-th
// index. Each thread issues kUnroll independent row loads before it reduces
// them, so several rows are in flight per warp, which hides the latency the
// TPU's DMA ring hides. Groups then reduce through shared memory and the
// block writes one partial row (n_chunks, K); a second launch reduces the
// partial rows column by column into the (1, K) result.
//
// Bound. R*K*4 gathered bytes over HBM (3.35 TB/s): 1.28 ms at R = 2^20,
// K = 1024, against 2^30 compares, 0.016 ms at the 67 TFLOP/s f32 rate, so
// the kernel is bound by bytes. Measured times are in PERF.md
// (chip_smoke.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;
constexpr int kUnroll = 4;

__device__ __forceinline__ float min_nan(float m, float v) {
  // jnp.minimum: NaN wins, from either side
  return (v < m || v != v) ? v : m;
}

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T inf() {
    return make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
  }
  static __device__ __forceinline__ T min(T a, T b) {
    return make_float4(min_nan(a.x, b.x), min_nan(a.y, b.y),
                       min_nan(a.z, b.z), min_nan(a.w, b.w));
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T inf() { return INFINITY; }
  static __device__ __forceinline__ T min(T a, T b) { return min_nan(a, b); }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
};

// partial[chunk, :] = min over this chunk's gathered rows, per column tile
template <int VEC>
__global__ void __launch_bounds__(kThreads)
gather_min_partial(const float* __restrict__ d, const int* __restrict__ idx,
                   int r, int k, float* __restrict__ partial) {
  using V = Vec<VEC>;
  using T = typename V::T;
  __shared__ int s_idx[kChunk];
  __shared__ T s_red[kThreads];

  const int row0 = blockIdx.x * kChunk;
  const int rows = min(kChunk, r - row0);
  for (int i = threadIdx.x; i < rows; i += kThreads) s_idx[i] = idx[row0 + i];
  __syncthreads();

  const int kv = k / VEC;                    // vectors per row
  const int v0 = blockIdx.y * kThreads;      // first vector of the tile
  const int tile = min(kThreads, kv - v0);   // vectors in the tile
  const int groups = kThreads / tile;        // row groups
  const int g = threadIdx.x / tile;
  const int lane = threadIdx.x % tile;
  const bool active = g < groups;
  const float* col = d + (int64_t)(v0 + lane) * VEC;

  T acc = V::inf();
  if (active) {
    int i = g;
    for (; i + (kUnroll - 1) * groups < rows; i += kUnroll * groups) {
      T x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        x[u] = V::load(col + (int64_t)s_idx[i + u * groups] * k);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = V::min(acc, x[u]);
    }
    for (; i < rows; i += groups) {
      acc = V::min(acc, V::load(col + (int64_t)s_idx[i] * k));
    }
  }
  s_red[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < tile) {
    T m = s_red[threadIdx.x];
    for (int gg = 1; gg < groups; ++gg) {
      m = V::min(m, s_red[gg * tile + threadIdx.x]);
    }
    V::store(partial + (int64_t)blockIdx.x * k + (int64_t)(v0 + lane) * VEC,
             m);
  }
}

// out[c] = min over the partial rows of column c
__global__ void __launch_bounds__(kThreads)
gather_min_reduce(const float* __restrict__ partial, int n_chunks, int k,
                  float* __restrict__ out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= k) return;
  float m = INFINITY;
  for (int ch = 0; ch < n_chunks; ++ch) {
    m = min_nan(m, partial[(int64_t)ch * k + c]);
  }
  out[c] = m;
}

template <int VEC>
cudaError_t launch(const float* d, const int* idx, int r, int k,
                   float* partial, float* out, cudaStream_t stream) {
  const int n_chunks = (r + kChunk - 1) / kChunk;
  const int kv = k / VEC;
  const dim3 grid((unsigned)n_chunks, (unsigned)((kv + kThreads - 1) /
                                                 kThreads));
  gather_min_partial<VEC><<<grid, kThreads, 0, stream>>>(d, idx, r, k,
                                                         partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gather_min_reduce<<<(k + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, n_chunks, k, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the partial buffer the wrapper allocates: one per chunk of idx.
int gather_min_chunks(int r) { return (r + kChunk - 1) / kChunk; }

// d (n, k) f32 row-major, contiguous; idx (r,) int32 with 0 <= idx < n
// (checked by the caller); partial (gather_min_chunks(r), k) f32 scratch;
// out (k,) f32. r >= 1. Launches on `stream` without synchronising;
// returns cudaGetLastError().
int gather_min_launch(const void* d, const void* idx, int r, int k,
                      void* partial, void* out, void* stream) {
  if (r <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const float* df = static_cast<const float*>(d);
  const int* ii = static_cast<const int*>(idx);
  float* pf = static_cast<float*>(partial);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (k % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(df) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(pf) % 16 == 0);
  return (int)(vec4 ? launch<4>(df, ii, r, k, pf, of, s)
                    : launch<1>(df, ii, r, k, pf, of, s));
}

const char* gather_min_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
