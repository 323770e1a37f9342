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
// 3.35 TB/s, so the kernel is bound by operations.
//
// Design. The TPU kernel pads D to 128 lanes and N to 1024-row tiles and
// keeps the whole (tile, K) distance block in VMEM. Here:
// - assign_prep runs once per call: it copies the codebook into a scratch
//   (K, DT) layout zero-padded to DT (the next supported width >= D) and
//   computes each |c|^2 once.
// - assign_kernel is persistent: as many blocks as the card holds at once
//   (the occupancy of this kernel times the SMs, at most one per tile). A
//   block stages the codebook (chunks of KC codes; at K <= KC once for all
//   its tiles) with 16-byte copies, then walks tiles of 32*R rows: every
//   lane holds R rows in registers (DT floats each, zero beyond D; 16-byte
//   loads when D == DT), and the block's kWarps warps split the chunk's
//   codes into contiguous ranges, so one tile is fine-grained enough to
//   balance the waves. A code read from shared memory is a broadcast
//   float4 load reused for R rows: R*4 FMAs per load. Each warp keeps a
//   running (best, index) per row in code order (strict <); the block
//   merges the warps' pairs in shared memory by (value, then index), which
//   keeps the first index on ties across the split and across chunks.
// - 4 warps a block and at most 170 registers a thread (3 blocks an SM) were
//   the fastest of the shapes tried on an H100 at the quality stage's
//   160,000 x 16 x 512 (8 warps, 2 or 4 blocks an SM, 2 or 8 rows a lane,
//   1, 2 or 4 codes unrolled), and 16-byte row loads beat scalar ones.
// Measured times are in PERF.md (chip_smoke.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStageFloats = 8192;  // 32 KB of staged codes per chunk
constexpr int kMaxChunkCodes = 1024;

__host__ __device__ constexpr int chunk_codes(int dt) {
  return kStageFloats / dt < kMaxChunkCodes ? kStageFloats / dt
                                            : kMaxChunkCodes;
}

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
__global__ void __launch_bounds__(kThreads, DT * R <= 64 ? 3 : 1)
assign_kernel(const float* __restrict__ z, const float* __restrict__ cbp,
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

template <int DT, int R>
cudaError_t launch(const float* z, const float* cb, int n, int d, int k,
                   float* cbp, float* sq, int64_t* out_idx, float* out_dist,
                   cudaStream_t stream) {
  assign_prep<DT><<<(k + 127) / 128, 128, 0, stream>>>(cb, k, d, cbp, sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // blocks of this kernel an SM holds at once: a property of the compiled
  // kernel, asked once per process
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, assign_kernel<DT, R>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + 32 * R - 1) / (32 * R);
  int grid = sms * per_sm;
  if (grid > n_tiles) grid = n_tiles;
  assign_kernel<DT, R><<<grid, kThreads, 0, stream>>>(z, cbp, sq, n, d, k,
                                                      out_idx, out_dist);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Width each code is padded to in the scratch codebook: the next supported
// width >= d (4, 8, 16, 32, 64 or 128).
int assign_padded_dim(int d) {
  int dt = 4;
  while (dt < d) dt *= 2;
  return dt;
}

// z (n, d) and cb (k, d) f32 row-major, contiguous; cbp (k,
// assign_padded_dim(d)) and sq (k,) f32 scratch; out_idx (n,) int64 and
// out_dist (n,) f32. 1 <= d <= 128. Launches on `stream` without
// synchronising; returns the first CUDA error.
int assign_launch(const void* z, const void* cb, int n, int d, int k,
                  void* cbp, void* sq, void* out_idx, void* out_dist,
                  void* stream) {
  if (n <= 0 || d <= 0 || d > 128 || k <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* zf = static_cast<const float*>(z);
  const float* cf = static_cast<const float*>(cb);
  float* pf = static_cast<float*>(cbp);
  float* sf = static_cast<float*>(sq);
  int64_t* oi = static_cast<int64_t*>(out_idx);
  float* od = static_cast<float*>(out_dist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows per lane: R * DT query floats stay in registers (<= 64, or 128 at
  // the widest latent)
  cudaError_t err;
  if (d <= 4) {
    err = launch<4, 4>(zf, cf, n, d, k, pf, sf, oi, od, s);
  } else if (d <= 8) {
    err = launch<8, 4>(zf, cf, n, d, k, pf, sf, oi, od, s);
  } else if (d <= 16) {
    err = launch<16, 4>(zf, cf, n, d, k, pf, sf, oi, od, s);
  } else if (d <= 32) {
    err = launch<32, 2>(zf, cf, n, d, k, pf, sf, oi, od, s);
  } else if (d <= 64) {
    err = launch<64, 1>(zf, cf, n, d, k, pf, sf, oi, od, s);
  } else {
    err = launch<128, 1>(zf, cf, n, d, k, pf, sf, oi, od, s);
  }
  return (int)err;
}

const char* assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
