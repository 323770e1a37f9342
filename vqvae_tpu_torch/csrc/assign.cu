// Nearest-code assignment for Hopper (sm_90a): kernel K3.
//
// Replaces the Pallas TPU kernel _assign_kernel of
// vqvae_tpu/ops/pallas_assign.py (:33), reached through pl.pallas_call in
// _assign_device (:60) and nearest_codes (:84). The quality stage calls it
// twice per run (vqvae_tpu/cli/quality_checks.py nearest_medoid_assign).
//
// What it computes, for each row z of Z (N, D) against the codebook C (K, D):
//   d2_k  = |c_k|^2 - 2 z.c_k            (the TPU formula, not sum (z-c)^2)
//   idx   = the first k with the smallest d2_k (strict <, so ties go to the
//           lowest code, as jnp.argmin does)
//   dist  = max(d2_idx + |z|^2, 0)
// Dot products and squared norms are f32 fused multiply-add chains over
// d = 0..D-1 on the CUDA cores (no tensor cores, no TF32): the JAX kernel
// runs its product at Precision.HIGHEST because bf16 flips ~0.6 % of the
// argmins. The plain PyTorch version is vqvae_tpu_torch/ops/assign.py
// nearest_codes_reference.
//
// Bound. 2*N*K*D f32 FLOP for the products (plus one subtract and one
// compare per pair) against N*D*4 + K*D*4 bytes in and 12 bytes out per row:
// at the quality stage's 160,000 x 512 x 16 that is 2.6e9 FLOP, 0.039 ms at
// the H100's 67 TFLOP/s f32 peak, against 12 MB of traffic, 0.004 ms at
// 3.35 TB/s; at the vanilla presets' 1,000 x 512 x 128, 1.3e8 FLOP, 0.002 ms:
// so the kernel is bound by operations, and at a few thousand rows by the
// latency of its launches.
//
// Design. The TPU kernel pads D to 128 lanes and N to 1024-row tiles and
// keeps the whole (tile, K) distance block in VMEM. Here codes are padded
// with zeros to DT, the next supported width >= D (zero columns add exact
// zeros to every chain). Two paths:
// - D <= 16 (assign_prep, then assign_rows): assign_prep copies the
//   codebook into a scratch (K, DT) layout and takes each |c|^2 once;
//   assign_rows is persistent, as many blocks as the card holds at once. A
//   block stages the codebook (chunks of KC codes; at K <= KC once for all
//   its tiles), then walks tiles of 32*R rows: every lane holds R rows in
//   registers, and the block's kWarps warps split the chunk's codes into
//   contiguous ranges. A code read from shared memory is a broadcast
//   float4 load reused for R rows: R*4 FMAs per load. 4 warps, 4 rows a
//   lane and at most 170 registers a thread (3 blocks an SM) were the
//   fastest of the shapes tried on an H100 at 160,000 x 16 x 512; staging
//   straight from the codebook, with |c|^2 taken in every block, was
//   slower there (PERF.md).
// - D >= kTiledMinDim (assign_tiled): one launch (two where the codes are
//   split, below), no scratch copy: every block stages its codes straight
//   from C into shared memory, 64 at a time by cp.async into two buffers
//   (the next chunk lands while the block computes on this one), and
//   takes each code's |c|^2 inside its product loop. A register-blocked
//   product: a block owns a tile of 64 rows and a slice of the codes;
//   row and code tiles sit in shared memory with rows DT + 4 floats apart
//   (an odd number of float4s, so the eight lanes of a quarter warp that
//   read eight rows hit distinct banks). Each of the 128 threads keeps 8
//   rows x 4 codes of dot products in registers: per 4 columns it loads 8
//   + 4 float4s and issues 128 independent FMAs, so the FMA pipe, not
//   shared memory or the latency of one chain, sets the pace. Each thread
//   keeps a running (best, index) per row; the 16 lanes that share a row
//   merge by shuffles, by (value, then index).
// - Few rows leave most SMs idle: 1,000 rows are 16 tiles. So the codes
//   are split into slices, as many as give the busiest SM the least work
//   (tiled_split); each block writes its slice's (best,
//   index) per row, and assign_merge takes, per row, the first smallest
//   over the slices in code order (earlier slices hold lower indices, so
//   strict < keeps jnp.argmin's first index) and the distance. With one
//   slice the main kernel writes the outputs itself.
// Measured times are in PERF.md (chip_smoke.py, tools/tune_assign.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStageFloats = 8192;  // 32 KB of staged codes per chunk
constexpr int kMaxChunkCodes = 1024;
// the narrowest padded width the tiled kernel takes (below it, the rows
// path; at D = 32 the tiled kernel is the faster of the two: PERF.md)
constexpr int kTiledMinDim = 32;
constexpr int kTileRows = 64;   // rows of a tiled block
constexpr int kTileCodes = 64;  // codes of a staged chunk
constexpr int kTiledThreads = 128;
constexpr int kMergeThreads = 256;

__host__ __device__ constexpr int chunk_codes(int dt) {
  return kStageFloats / dt < kMaxChunkCodes ? kStageFloats / dt
                                            : kMaxChunkCodes;
}

// the FMA chain of |v|^2 over the DT floats of v (16-byte aligned)
template <int DT>
__device__ __forceinline__ float sq_chain(const float* v) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float s = 0.0f;
#pragma unroll
  for (int j4 = 0; j4 < DT / 4; ++j4) {
    const float4 a = v4[j4];
    s = fmaf(a.x, a.x, s);
    s = fmaf(a.y, a.y, s);
    s = fmaf(a.z, a.z, s);
    s = fmaf(a.w, a.w, s);
  }
  return s;
}

// 16 bytes from global to shared memory without the registers; src_bytes
// 0 zero-fills (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) of src (rows of d floats) into dst (rows of `ld`
// floats, 16-byte aligned), zero-padded to DT columns and to `cap` rows:
// by cp.async when the rows are whole float4s on 16-byte boundaries
// (complete after the next cp_async_wait), else with plain loads and
// stores
template <int DT, int THREADS>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int r0, int rows, int cap, int d,
                                           bool vec, float* dst, int ld) {
  if (vec) {
    const int d4 = d / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int e = threadIdx.x; e < cap * (DT / 4); e += THREADS) {
      const int r = e / (DT / 4);
      const int c4 = e - r * (DT / 4);
      const bool in = r < rows && c4 < d4;
      cp_async16(dst + r * ld + 4 * c4,
                 s4 + (in ? (int64_t)(r0 + r) * d4 + c4 : 0), in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < cap * DT; e += THREADS) {
      const int r = e / DT;
      const int j = e - r * DT;
      dst[r * ld + j] = (r < rows && j < d)
                            ? __ldg(src + (int64_t)(r0 + r) * d + j)
                            : 0.0f;
    }
  }
}

// ---- D <= 16: rows in registers, codes split over the block's warps ----

// cbp[c, :] = cb[c, :] zero-padded to DT; sq[c] = the FMA chain of |c|^2
template <int DT>
__global__ void __launch_bounds__(128)
assign_prep(const float* __restrict__ cb, int k, int d,
            float* __restrict__ cbp, float* __restrict__ sq) {
  const int c = blockIdx.x * 128 + threadIdx.x;
  if (c >= k) return;
  float v[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) v[j] = j < d ? cb[(int64_t)c * d + j] : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (j < d) s = fmaf(v[j], v[j], s);
    cbp[(int64_t)c * DT + j] = v[j];
  }
  sq[c] = s;
}

template <int DT, int R>
__global__ void __launch_bounds__(kThreads, 3)
assign_rows(const float* __restrict__ z, const float* __restrict__ cbp,
            const float* __restrict__ sq, int n, int d, int k,
            int64_t* __restrict__ out_idx, float* __restrict__ out_dist) {
  constexpr int KC = chunk_codes(DT);
  constexpr int TILE = 32 * R;
  __shared__ __align__(16) float s_cb[KC * DT];
  __shared__ float s_sq[KC];
  __shared__ float s_best[kWarps][TILE];
  __shared__ int s_arg[kWarps][TILE];
  __shared__ float s_zsq[TILE];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (n + TILE - 1) / TILE;
  // rows of exactly DT floats on 16-byte boundaries load as float4
  const bool vec_rows =
      d == DT && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  const int n_chunks = (k + KC - 1) / KC;
  int staged = -1;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE;
    float zr[R][DT];
    float best[R];
    int arg[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r * 32 + lane;
      if (vec_rows && row < n) {
        const float4* zv = reinterpret_cast<const float4*>(z) +
                           (int64_t)row * (DT / 4);
#pragma unroll
        for (int j4 = 0; j4 < DT / 4; ++j4) {
          const float4 v = __ldg(zv + j4);
          zr[r][4 * j4 + 0] = v.x;
          zr[r][4 * j4 + 1] = v.y;
          zr[r][4 * j4 + 2] = v.z;
          zr[r][4 * j4 + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          zr[r][j] = (row < n && j < d) ? __ldg(z + (int64_t)row * d + j)
                                        : 0.0f;
        }
      }
      best[r] = INFINITY;
      arg[r] = INT_MAX;
    }

    for (int ch = 0; ch < n_chunks; ++ch) {
      const int k0 = ch * KC;
      const int kc = min(KC, k - k0);
      if (ch != staged) {
        __syncthreads();  // the previous chunk is no longer read
        const float4* src = reinterpret_cast<const float4*>(cbp) +
                            (int64_t)k0 * (DT / 4);
        float4* dst = reinterpret_cast<float4*>(s_cb);
        for (int e = threadIdx.x; e < kc * (DT / 4); e += kThreads) {
          dst[e] = __ldg(src + e);
        }
        for (int c = threadIdx.x; c < kc; c += kThreads) {
          s_sq[c] = __ldg(sq + k0 + c);
        }
        __syncthreads();
        staged = ch;
      }
      // this warp's contiguous range of the chunk's codes
      const int per = (kc + kWarps - 1) / kWarps;
      const int c0 = warp * per;
      const int c1 = min(kc, c0 + per);
#pragma unroll 2
      for (int c = c0; c < c1; ++c) {
        const float4* code = reinterpret_cast<const float4*>(s_cb + c * DT);
        float dot[R];
#pragma unroll
        for (int r = 0; r < R; ++r) dot[r] = 0.0f;
#pragma unroll
        for (int j4 = 0; j4 < DT / 4; ++j4) {
          const float4 v = code[j4];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            dot[r] = fmaf(zr[r][4 * j4 + 0], v.x, dot[r]);
            dot[r] = fmaf(zr[r][4 * j4 + 1], v.y, dot[r]);
            dot[r] = fmaf(zr[r][4 * j4 + 2], v.z, dot[r]);
            dot[r] = fmaf(zr[r][4 * j4 + 3], v.w, dot[r]);
          }
        }
        const float csq = s_sq[c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d2 = csq - 2.0f * dot[r];  // 2*dot is exact: fused or not
          if (d2 < best[r]) {
            best[r] = d2;
            arg[r] = k0 + c;
          }
        }
      }
    }

    // merge the warps' (best, index) per row: smaller value, then lower index
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s_best[warp][r * 32 + lane] = best[r];
      s_arg[warp][r * 32 + lane] = arg[r];
    }
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float zsq = 0.0f;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          if (j < d) zsq = fmaf(zr[r][j], zr[r][j], zsq);
        }
        s_zsq[r * 32 + lane] = zsq;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < TILE; t += kThreads) {
      float b = s_best[0][t];
      int a = s_arg[0][t];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float v = s_best[w][t];
        const int i = s_arg[w][t];
        if (v < b || (v == b && i < a)) {
          b = v;
          a = i;
        }
      }
      const int row = row0 + t;
      if (row < n) {
        out_idx[row] = a == INT_MAX ? 0 : a;  // no d2 below +inf: code 0
        out_dist[row] = fmaxf(b + s_zsq[t], 0.0f);
      }
    }
    __syncthreads();  // the merge buffers are free for the next tile
  }
}

// ---- D >= kTiledMinDim: 64 rows x 64 codes, 8 x 4 a thread ----

__host__ __device__ constexpr int tiled_ld(int dt) { return dt + 4; }

// the z tile, two code buffers, |c|^2 and |z|^2
__host__ __device__ constexpr size_t tiled_smem_bytes(int dt) {
  return ((size_t)(kTileRows + 2 * kTileCodes) * tiled_ld(dt) + kTileCodes +
          kTileRows) * sizeof(float);
}

// One block: row tile blockIdx.x, code slice blockIdx.y (chunks [cs * y,
// cs * (y + 1)) of kTileCodes codes). gridDim.y == 1: writes idx and dist;
// else the slice's (best f32 bits, index) per row to part[y * n + row],
// and slice 0 writes |z|^2 to zsq. The next chunk of codes comes by
// cp.async into the second buffer while the block computes on the
// current one; each code's |c|^2 is taken in the product loop (lanes 0-15
// of warp w add code tx + 16 w's own squares, the same FMA chain), so no
// pass waits on it.
template <int DT>
__global__ void __launch_bounds__(kTiledThreads)
assign_tiled(const float* __restrict__ z, const float* __restrict__ cb,
              int n, int d, int k, int cs, int64_t* __restrict__ out_idx,
              float* __restrict__ out_dist, int2* __restrict__ part,
              float* __restrict__ zsq) {
  constexpr int LD = tiled_ld(DT);
  constexpr int LD4 = LD / 4;
  extern __shared__ float4 smem4[];
  float* s_z = reinterpret_cast<float*>(smem4);  // [kTileRows][LD]
  float* s_c = s_z + kTileRows * LD;              // [2][kTileCodes][LD]
  float* s_csq = s_c + 2 * kTileCodes * LD;       // [kTileCodes]
  float* s_zsq = s_csq + kTileCodes;              // [kTileRows]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // codes tx + 16 j
  const int ty = tid >> 4;  // rows ty + 8 i
  const bool sq_lane = (ty & 1) == 0;  // takes |c|^2 of code tx + 16 (ty/2)
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, n - row0);
  const int c_lo = blockIdx.y * cs * kTileCodes;
  const int c_hi = min(k, c_lo + cs * kTileCodes);
  const int n_ch = (c_hi - c_lo + kTileCodes - 1) / kTileCodes;
  const bool vec_z = d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  const bool vec_c = d % 4 == 0 && reinterpret_cast<uintptr_t>(cb) % 16 == 0;

  stage_rows<DT, kTiledThreads>(z, row0, rows, kTileRows, d, vec_z, s_z,
                                LD);
  stage_rows<DT, kTiledThreads>(cb, c_lo, min(kTileCodes, c_hi - c_lo),
                                kTileCodes, d, vec_c, s_c, LD);
  cp_async_commit();

  float best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    arg[i] = INT_MAX;
  }
  const float4* z4 = reinterpret_cast<const float4*>(s_z);

  for (int ch = 0; ch < n_ch; ++ch) {
    const int k0 = c_lo + ch * kTileCodes;
    const int kc = min(kTileCodes, c_hi - k0);
    if (ch + 1 < n_ch) {  // its buffer was last read before the last sync
      const int k1 = k0 + kTileCodes;
      stage_rows<DT, kTiledThreads>(
          cb, k1, min(kTileCodes, c_hi - k1), kTileCodes, d, vec_c,
          s_c + ((ch + 1) & 1) * kTileCodes * LD, LD);
      cp_async_commit();
      cp_async_wait<1>();  // this chunk (and the z tile) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... for every thread; the last epilogue is done
    if (ch == 0 && tid < kTileRows) s_zsq[tid] = sq_chain<DT>(s_z + tid * LD);
    const float4* c4 =
        reinterpret_cast<const float4*>(s_c + (ch & 1) * kTileCodes * LD);

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
    float csq = 0.0f;
#pragma unroll 4
    for (int q = 0; q < DT / 4; ++q) {
      float4 cv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cv[j] = c4[(tx + 16 * j) * LD4 + q];
      if (sq_lane) {
        const float4 own = c4[(tx + 8 * ty) * LD4 + q];
        csq = fmaf(own.x, own.x, csq);
        csq = fmaf(own.y, own.y, csq);
        csq = fmaf(own.z, own.z, csq);
        csq = fmaf(own.w, own.w, csq);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 zv = z4[(ty + 8 * i) * LD4 + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(zv.x, cv[j].x, acc[i][j]);
          acc[i][j] = fmaf(zv.y, cv[j].y, acc[i][j]);
          acc[i][j] = fmaf(zv.z, cv[j].z, acc[i][j]);
          acc[i][j] = fmaf(zv.w, cv[j].w, acc[i][j]);
        }
      }
    }
    if (sq_lane) s_csq[tx + 8 * ty] = tx + 8 * ty < kc ? csq : INFINITY;
    __syncthreads();  // every |c|^2 is written; the buffer is free
    // codes tx + 16 j in increasing order: strict < keeps the first index
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float c2 = s_csq[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d2 = c2 - 2.0f * acc[i][j];
        if (d2 < best[i]) {
          best[i] = d2;
          arg[i] = k0 + tx + 16 * j;
        }
      }
    }
  }

  // the 16 lanes of a row (tx) merge: smaller value, then lower index
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int a = __shfl_xor_sync(0xffffffffu, arg[i], off);
      if (v < best[i] || (v == best[i] && a < arg[i])) {
        best[i] = v;
        arg[i] = a;
      }
    }
  }
  if (tx != 0) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r >= rows) continue;
    const int row = row0 + r;
    if (gridDim.y == 1) {
      out_idx[row] = arg[i] == INT_MAX ? 0 : arg[i];
      out_dist[row] = fmaxf(best[i] + s_zsq[r], 0.0f);
    } else {
      part[(int64_t)blockIdx.y * n + row] =
          make_int2(__float_as_int(best[i]), arg[i]);
      if (blockIdx.y == 0) zsq[row] = s_zsq[r];
    }
  }
}

// per row: the first smallest of the slices' (best, index), in slice order
__global__ void __launch_bounds__(kMergeThreads)
assign_merge(const int2* __restrict__ part, const float* __restrict__ zsq,
             int n, int slices, int64_t* __restrict__ out_idx,
             float* __restrict__ out_dist) {
  const int row = blockIdx.x * kMergeThreads + threadIdx.x;
  if (row >= n) return;
  float b = INFINITY;
  int a = INT_MAX;
  for (int s = 0; s < slices; ++s) {
    const int2 p = part[(int64_t)s * n + row];
    const float v = __int_as_float(p.x);
    if (v < b) {
      b = v;
      a = p.y;
    }
  }
  out_idx[row] = a == INT_MAX ? 0 : a;
  out_dist[row] = fmaxf(b + zsq[row], 0.0f);
}

// the card's SMs, asked once per process
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) {
      cached = 0;
      return err;
    }
  }
  *sms = cached;
  return cudaSuccess;
}

// (chunks a slice, slices) of the tiled grid. A block's time grows with
// its chunks (plus its z tile's staging, about kStageCost of a chunk), and
// the busiest SM runs ceil(blocks / SMs) blocks, so the split taken is the
// one with the least ceil(tiles * slices / SMs) * (chunks a slice +
// kStageCost), plus kMergeCost chunk-times for the merge launch when the
// codes are split. On 132 SMs, 512 codes (8 chunks): 1,000 rows (16
// tiles) take 8 slices; 10,000 and 60,000 rows take 4 (unsplit, 938 tiles
// would give the busiest SMs 8 blocks against a mean of 7.1).
constexpr float kStageCost = 0.1f;
constexpr float kMergeCost = 0.5f;

struct Split {
  int cs;
  int slices;
};

template <int DT>
cudaError_t tiled_split(int n, int k, Split* out) {
  static bool ready = false;  // the kernel's shared memory, set up once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_tiled<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tiled_smem_bytes(DT));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const int chunks = (k + kTileCodes - 1) / kTileCodes;
  float best = INFINITY;
  out->cs = chunks;
  out->slices = 1;
  for (int cs = chunks; cs >= 1; --cs) {
    const int slices = (chunks + cs - 1) / cs;
    if ((chunks + slices - 1) / slices != cs) continue;  // same split
    const int64_t per_sm_blocks = (tiles * slices + sms - 1) / sms;
    const float cost = per_sm_blocks * (cs + kStageCost) +
                       (slices > 1 ? kMergeCost : 0.0f);
    if (cost < best) {
      best = cost;
      out->cs = cs;
      out->slices = slices;
    }
  }
  return cudaSuccess;
}

int padded_dim(int d) {
  int dt = 4;
  while (dt < d) dt *= 2;
  return dt;
}

// scratch bytes of the tiled path: the slices' (best, index) and |z|^2
// per row when the codes are split; -1 on an error
template <int DT>
int64_t tiled_work_bytes(int n, int k) {
  Split s;
  if (tiled_split<DT>(n, k, &s) != cudaSuccess) return -1;
  return s.slices > 1 ? (int64_t)n * (s.slices * (int64_t)sizeof(int2) +
                                      (int64_t)sizeof(float))
                      : 0;
}

// work: the padded codebook (k, DT) and |c|^2 (k,)
template <int DT, int R>
cudaError_t launch_rows(const float* z, const float* cb, int n, int d, int k,
                        void* work, int64_t* out_idx, float* out_dist,
                        cudaStream_t stream) {
  float* cbp = static_cast<float*>(work);
  float* sq = cbp + (size_t)k * DT;
  assign_prep<DT><<<(k + 127) / 128, 128, 0, stream>>>(cb, k, d, cbp, sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // blocks of this kernel an SM holds at once: a property of the compiled
  // kernel, asked once per process
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, assign_rows<DT, R>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + 32 * R - 1) / (32 * R);
  int grid = sms * per_sm;
  if (grid > n_tiles) grid = n_tiles;
  assign_rows<DT, R><<<grid, kThreads, 0, stream>>>(z, cbp, sq, n, d, k,
                                                    out_idx, out_dist);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_tiled(const float* z, const float* cb, int n, int d, int k,
                         void* work, int64_t* out_idx, float* out_dist,
                         cudaStream_t stream) {
  Split s;
  cudaError_t err = tiled_split<DT>(n, k, &s);
  if (err != cudaSuccess) return err;
  int2* part = static_cast<int2*>(work);
  float* zsq = reinterpret_cast<float*>(part + (size_t)s.slices * n);
  const dim3 grid((unsigned)((n + kTileRows - 1) / kTileRows),
                  (unsigned)s.slices);
  assign_tiled<DT><<<grid, kTiledThreads, tiled_smem_bytes(DT), stream>>>(
      z, cb, n, d, k, s.cs, out_idx, out_dist, part, zsq);
  err = cudaGetLastError();
  if (err != cudaSuccess || s.slices == 1) return err;
  assign_merge<<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                 stream>>>(part, zsq, n, s.slices, out_idx, out_dist);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch assign_launch takes for these shapes (0: none; -1: a
// CUDA error). 1 <= d <= 128. Below the tiled widths: the padded codebook
// and |c|^2; tiled, the slices' partial results when the codes are split,
// which they are only while the row tiles fall short of filling the card
// evenly, so the scratch stays a few MB.
int assign_work_bytes(int n, int d, int k) {
  const int dt = padded_dim(d);
  if (n <= 0 || k <= 0 || d > 128) return 0;
  if (dt < kTiledMinDim) {  // the padded codebook and |c|^2
    const int64_t bytes = (int64_t)k * (dt + 1) * (int64_t)sizeof(float);
    return bytes > INT_MAX ? -1 : (int)bytes;
  }
  const int64_t bytes = dt == 32   ? tiled_work_bytes<32>(n, k)
                        : dt == 64 ? tiled_work_bytes<64>(n, k)
                                   : tiled_work_bytes<128>(n, k);
  return bytes > INT_MAX ? -1 : (int)bytes;
}

// z (n, d) and cb (k, d) f32 row-major, contiguous; work:
// assign_work_bytes(n, d, k) bytes (16-byte aligned); out_idx (n,) int64
// and out_dist (n,) f32. 1 <= d <= 128. Launches on `stream` without
// synchronising; returns the first CUDA error.
int assign_launch(const void* z, const void* cb, int n, int d, int k,
                  void* work, void* out_idx, void* out_dist, void* stream) {
  if (n <= 0 || d <= 0 || d > 128 || k <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* zf = static_cast<const float*>(z);
  const float* cf = static_cast<const float*>(cb);
  int64_t* oi = static_cast<int64_t*>(out_idx);
  float* od = static_cast<float*>(out_dist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dt = padded_dim(d);
  cudaError_t err;
  if (dt >= kTiledMinDim) {
    if (dt == 32) {
      err = launch_tiled<32>(zf, cf, n, d, k, work, oi, od, s);
    } else if (dt == 64) {
      err = launch_tiled<64>(zf, cf, n, d, k, work, oi, od, s);
    } else {
      err = launch_tiled<128>(zf, cf, n, d, k, work, oi, od, s);
    }
    return (int)err;
  }
  // 4 rows a lane: 4 * DT query floats stay in registers (<= 64)
  if (dt == 4) {
    err = launch_rows<4, 4>(zf, cf, n, d, k, work, oi, od, s);
  } else if (dt == 8) {
    err = launch_rows<8, 4>(zf, cf, n, d, k, work, oi, od, s);
  } else {
    err = launch_rows<16, 4>(zf, cf, n, d, k, work, oi, od, s);
  }
  return (int)err;
}

const char* assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
