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
// Bound. A repeated row does not change a min, so the function needs each
// distinct gathered row once: at the gather-min tool's 2^20 random indices
// into N = 196,608 rows about N(1 - e^(-R/N)) = 195,660 rows are present,
// 0.80 GB at K = 1024, 0.240 ms at 3.35 TB/s. The compares (one per value)
// take 0.003 ms at 67 TFLOP/s f32, so the kernel is bound by bytes.
//
// Two routes, both hand kernels; the wrapper picks one by a rule on
// (R, N, K) (ops/gather_min.py gather_min_route):
//
// Gather route (the first design). The TPU kernel walks CHUNK = 1024
// indices per grid step with an S-deep ring of one-row DMAs into VMEM.
// Here block (x, y) takes chunk x of idx (kChunk indices, staged in shared
// memory) and column tile y of kThreads vectors (float4 when K % 4 == 0 and
// the pointers are 16-byte aligned, else float). Each thread owns one
// column vector; when a row is narrower than the tile, the block's threads
// split into G row groups (G = kThreads / tile), each walking every G-th
// index, with kUnroll independent row loads in flight. It reads one row per
// index: R*K*4 bytes, 5.3 times the distinct rows at the tool's shapes, so
// it only wins where the indices are a handful (a few serial steps of one
// block, no pass over N) or the rows are narrow and d sits in L2.
//
// Scan route (the presence design). (1) The 32-bit flags of the N rows are
// cleared (cudaMemsetAsync) and one thread per index stores
// flag[idx[j]] = 1: every writer stores the same word, so plain stores
// suffice, and the 4N bytes (786 KB at the tool's N) stay in L2. Words, not
// bytes: fewer rows share a 32-byte sector, so the scattered stores of many
// indices contend less there. (2) Blocks take contiguous ranges of rows of
// d. A block reads its range's flags kStage rows at a time, four a thread
// as one 16-byte load, and compacts the present rows' ids into shared
// memory (a block-wide prefix sum of the counts); then it walks that list
// as the gather route walks its chunk, with the same column tiles, row
// groups and kUnroll rows in flight. Each present row is read once and an
// absent one not at all, so a NaN in an absent row never reaches the
// output, and a sparse or large N costs one coalesced pass over the flags.
// The grid is sized to the blocks the card holds at once (a few per SM),
// so every range is about equal. Each block writes one partial row.
//
// Both routes end in gather_min_reduce: a (32 columns x 32 row groups)
// block min-reduces the partial rows of 32 columns. Offsets into d are
// 64-bit. Measured times are in PERF.md (chip_smoke.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;
constexpr int kUnroll = 4;
constexpr int kScanBlocksPerSM = 4;
constexpr int kStage = 4 * kThreads;  // rows of flags a scan block compacts
constexpr int kReduceCols = 32;
constexpr int kReduceGroups = 32;

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

// The column tile and row group of this thread: tile y of kThreads vectors,
// and G = kThreads / tile row groups when a row is narrower than the tile.
struct Tile {
  int tile, groups, g, lane, v0;
  __device__ Tile(int kv) {
    v0 = blockIdx.y * kThreads;
    tile = min(kThreads, kv - v0);
    groups = kThreads / tile;
    g = threadIdx.x / tile;
    lane = threadIdx.x % tile;
  }
  __device__ bool active() const { return g < groups; }
};

// The min over the block's row groups of each thread's accumulator, stored
// as the block's partial row.
template <int VEC>
__device__ __forceinline__ void write_partial(
    typename Vec<VEC>::T acc, const Tile& t, int k, float* partial) {
  using V = Vec<VEC>;
  __shared__ typename V::T s_red[kThreads];
  s_red[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < t.tile) {
    typename V::T m = s_red[threadIdx.x];
    for (int gg = 1; gg < t.groups; ++gg) {
      m = V::min(m, s_red[gg * t.tile + threadIdx.x]);
    }
    V::store(partial + (int64_t)blockIdx.x * k +
                 (int64_t)(t.v0 + t.lane) * VEC,
             m);
  }
}

// acc = min(acc, rows[i] of this thread's column vector) over the rows of
// its row group among rows[0..count), kUnroll loads in flight
template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T min_rows(
    typename Vec<VEC>::T acc, const float* col, int k, const int* rows,
    int count, const Tile& t) {
  using V = Vec<VEC>;
  if (!t.active()) return acc;
  const int groups = t.groups;
  int i = t.g;
  for (; i + (kUnroll - 1) * groups < count; i += kUnroll * groups) {
    typename V::T x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = V::load(col + (int64_t)rows[i + u * groups] * k);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = V::min(acc, x[u]);
  }
  for (; i < count; i += groups) {
    acc = V::min(acc, V::load(col + (int64_t)rows[i] * k));
  }
  return acc;
}

// partial[chunk, :] = min over this chunk's gathered rows, per column tile
template <int VEC>
__global__ void __launch_bounds__(kThreads)
gather_min_partial(const float* __restrict__ d, const int* __restrict__ idx,
                   int r, int k, float* __restrict__ partial) {
  using V = Vec<VEC>;
  using T = typename V::T;
  __shared__ int s_idx[kChunk];

  const int row0 = blockIdx.x * kChunk;
  const int rows = min(kChunk, r - row0);
  for (int i = threadIdx.x; i < rows; i += kThreads) s_idx[i] = idx[row0 + i];
  __syncthreads();

  const Tile t(k / VEC);
  const float* col = d + (int64_t)(t.v0 + t.lane) * VEC;
  const T acc = min_rows<VEC>(V::inf(), col, k, s_idx, rows, t);
  write_partial<VEC>(acc, t, k, partial);
}

// flag[idx[j]] = 1 for every index (flags cleared before)
__global__ void __launch_bounds__(kThreads)
gather_min_presence(const int* __restrict__ idx, int r,
                    unsigned* __restrict__ flags) {
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < r;
       j += gridDim.x * kThreads) {
    flags[idx[j]] = 1u;
  }
}

// partial[b, :] = min over the present rows of rows [b*span, (b+1)*span);
// span is a multiple of 4 and the flags are padded with zeros to a multiple
// of 4, so each thread's four flags lie in one range
template <int VEC>
__global__ void __launch_bounds__(kThreads)
gather_min_scan(const float* __restrict__ d, const uint4* __restrict__ flags4,
                int n, int k, int span, float* __restrict__ partial) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int kWarpsPerBlock = kThreads / 32;
  __shared__ int s_rows[kStage];
  __shared__ int s_warp[kWarpsPerBlock];
  const int row0 = blockIdx.x * span;
  const int row1 = min(n, row0 + span);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  const Tile t(k / VEC);
  const float* col = d + (int64_t)(t.v0 + t.lane) * VEC;
  T acc = V::inf();
  for (int base = row0; base < row1; base += kStage) {
    // compact the present rows among base .. base + kStage - 1
    const int first = base + 4 * threadIdx.x;
    const uint4 f =
        first < row1 ? __ldg(flags4 + first / 4) : make_uint4(0, 0, 0, 0);
    const unsigned present[4] = {f.x, f.y, f.z, f.w};
    const int count = (f.x != 0) + (f.y != 0) + (f.z != 0) + (f.w != 0);
    int incl = count;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int off = incl - count, total = 0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      const int v = s_warp[w];
      if (w < warp) off += v;
      total += v;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (present[b]) s_rows[off++] = first + b;
    }
    __syncthreads();
    acc = min_rows<VEC>(acc, col, k, s_rows, total, t);
    __syncthreads();  // s_rows and s_warp are rewritten by the next stage
  }
  write_partial<VEC>(acc, t, k, partial);
}

// out[c] = min over the n_part partial rows of column c; block (32 columns
// x 32 row groups), each group walking every 32nd partial row
__global__ void __launch_bounds__(kReduceCols * kReduceGroups)
gather_min_reduce(const float* __restrict__ partial, int n_part, int k,
                  float* __restrict__ out) {
  __shared__ float s_red[kReduceGroups][kReduceCols + 1];
  const int c = blockIdx.x * kReduceCols + threadIdx.x;
  float m = INFINITY;
  if (c < k) {
    int p = threadIdx.y;
    for (; p + 3 * kReduceGroups < n_part; p += 4 * kReduceGroups) {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x[u] = partial[(int64_t)(p + u * kReduceGroups) * k + c];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) m = min_nan(m, x[u]);
    }
    for (; p < n_part; p += kReduceGroups) {
      m = min_nan(m, partial[(int64_t)p * k + c]);
    }
  }
  s_red[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0 && c < k) {
    for (int gg = 1; gg < kReduceGroups; ++gg) {
      m = min_nan(m, s_red[gg][threadIdx.x]);
    }
    out[c] = m;
  }
}

cudaError_t launch_reduce(const float* partial, int n_part, int k, float* out,
                          cudaStream_t stream) {
  gather_min_reduce<<<(k + kReduceCols - 1) / kReduceCols,
                      dim3(kReduceCols, kReduceGroups), 0, stream>>>(
      partial, n_part, k, out);
  return cudaGetLastError();
}

int column_tiles(int k, int vec) {
  return (k / vec + kThreads - 1) / kThreads;
}

bool use_vec4(const void* d, const void* partial, int k) {
  return (k % 4 == 0) && (reinterpret_cast<uintptr_t>(d) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(partial) % 16 == 0);
}

template <int VEC>
cudaError_t launch_gather(const float* d, const int* idx, int r, int k,
                          float* partial, float* out, cudaStream_t stream) {
  const int n_chunks = (r + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)n_chunks, (unsigned)column_tiles(k, VEC));
  gather_min_partial<VEC><<<grid, kThreads, 0, stream>>>(d, idx, r, k,
                                                         partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(partial, n_chunks, k, out, stream);
}

// Row ranges of the scan route: about kScanBlocksPerSM blocks per SM over
// all column tiles, at least 4 rows each; -1 if the current device cannot
// be queried.
int scan_ranges(int n, int k) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return -1;
  }
  const int target = sms * kScanBlocksPerSM / column_tiles(k, k % 4 ? 1 : 4);
  const int most = (n + 3) / 4;
  return target < 1 ? 1 : (target < most ? target : most);
}

template <int VEC>
cudaError_t launch_scan(const float* d, const int* idx, int n, int r, int k,
                        unsigned* flags, int ranges, float* partial,
                        float* out, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      flags, 0, (size_t)(n + 3) / 4 * 4 * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  int presence_blocks = (r + kThreads - 1) / kThreads;
  if (presence_blocks > 8192) presence_blocks = 8192;
  gather_min_presence<<<presence_blocks, kThreads, 0, stream>>>(idx, r,
                                                                flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int span = ((n + ranges - 1) / ranges + 3) / 4 * 4;
  const dim3 grid((unsigned)ranges, (unsigned)column_tiles(k, VEC));
  gather_min_scan<VEC><<<grid, kThreads, 0, stream>>>(
      d, reinterpret_cast<const uint4*>(flags), n, k, span, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(partial, ranges, k, out, stream);
}

}  // namespace

extern "C" {

// Partial rows of the gather route: one per chunk of idx.
int gather_min_chunks(int r) { return (r + kChunk - 1) / kChunk; }

// Row ranges of the scan route for d (n, k) on the current device: its
// partial rows (-1 when the device cannot be queried).
int gather_min_scan_ranges(int n, int k) { return scan_ranges(n, k); }

// Gather route. d (n, k) f32 row-major, contiguous; idx (r,) int32 with
// 0 <= idx < n (checked by the caller); partial (gather_min_chunks(r), k)
// f32 scratch; out (k,) f32. r >= 1. Launches on `stream` without
// synchronising; returns cudaGetLastError().
int gather_min_launch(const void* d, const void* idx, int r, int k,
                      void* partial, void* out, void* stream) {
  if (r <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const float* df = static_cast<const float*>(d);
  const int* ii = static_cast<const int*>(idx);
  float* pf = static_cast<float*>(partial);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(use_vec4(d, partial, k)
                   ? launch_gather<4>(df, ii, r, k, pf, of, s)
                   : launch_gather<1>(df, ii, r, k, pf, of, s));
}

// Scan route. d, idx, out as above; flags: n 32-bit words of scratch,
// rounded up to a multiple of 4 words, 16-byte aligned (cleared here);
// partial (ranges, k) f32 scratch, one row per range of rows
// (gather_min_scan_ranges(n, k), or any count from 1 to (n + 3) / 4).
// n, r >= 1.
int gather_min_scan_launch(const void* d, const void* idx, int n, int r,
                           int k, void* flags, int ranges, void* partial,
                           void* out, void* stream) {
  if (n <= 0 || r <= 0 || k <= 0 || ranges <= 0 || ranges > (n + 3) / 4 ||
      reinterpret_cast<uintptr_t>(flags) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* df = static_cast<const float*>(d);
  const int* ii = static_cast<const int*>(idx);
  unsigned* fl = static_cast<unsigned*>(flags);
  float* pf = static_cast<float*>(partial);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(use_vec4(d, partial, k)
                   ? launch_scan<4>(df, ii, n, r, k, fl, ranges, pf, of, s)
                   : launch_scan<1>(df, ii, n, r, k, fl, ranges, pf, of, s));
}

const char* gather_min_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
