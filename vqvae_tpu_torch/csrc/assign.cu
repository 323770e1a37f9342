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
// Design. The TPU kernel pads D to 128 lanes and N to 1024-row tiles and
// keeps the whole (tile, K) distance block in VMEM. Here nothing is padded
// in memory: each thread holds R query rows in registers (DT floats each, DT
// the next supported width >= D, zero beyond D), the block stages the
// codebook through shared memory in chunks of KC codes (zero-filled to DT,
// with |c|^2 computed once per code by the staging thread), and each thread
// walks the chunk keeping a running (best, index) per row. A code read from
// shared memory is a broadcast float4 load shared by all lanes and reused
// for R rows, so the loop is R*4 FMAs per shared-memory load. Any K fits:
// chunks are walked in order, so the strict < keeps the first minimum.
//
// Bound. 2*N*K*D f32 FLOP for the products (plus one subtract and one
// compare per pair) against N*D*4 + K*D*4 bytes in and 12 bytes out per row:
// at the quality stage's 160,000 x 512 x 16 that is 2.6e9 FLOP, 0.04 ms at
// the H100's 67 TFLOP/s f32 peak, against 12 MB of traffic, 0.004 ms at
// 3.35 TB/s, so the kernel is bound by operations. Measured times are in
// PERF.md (chip_smoke.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStageFloats = 8192;  // 32 KB of staged codes per chunk

template <int DT, int R>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ z, const float* __restrict__ cb,
              int n, int d, int k, int64_t* __restrict__ out_idx,
              float* __restrict__ out_dist) {
  constexpr int KC = kStageFloats / DT;  // codes per chunk
  __shared__ __align__(16) float s_cb[kStageFloats];
  __shared__ float s_sq[KC];

  const int row0 = (blockIdx.x * kThreads + threadIdx.x) * R;
  float zr[R][DT];
  float best[R];
  int best_k[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      zr[r][j] = (row < n && j < d) ? z[(int64_t)row * d + j] : 0.0f;
    }
    best[r] = INFINITY;
    best_k[r] = 0;
  }

  for (int k0 = 0; k0 < k; k0 += KC) {
    const int kc = min(KC, k - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < KC * DT; e += kThreads) {
      const int c = e / DT, j = e % DT;
      s_cb[e] = (c < kc && j < d) ? cb[(int64_t)(k0 + c) * d + j] : 0.0f;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kc; c += kThreads) {
      float sq = 0.0f;
      for (int j = 0; j < d; ++j) sq = fmaf(s_cb[c * DT + j], s_cb[c * DT + j], sq);
      s_sq[c] = sq;
    }
    __syncthreads();

    for (int c = 0; c < kc; ++c) {
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
      const float sq = s_sq[c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d2 = sq - 2.0f * dot[r];  // 2*dot is exact: fused or not
        if (d2 < best[r]) {
          best[r] = d2;
          best_k[r] = k0 + c;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row < n) {
      float zsq = 0.0f;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        if (j < d) zsq = fmaf(zr[r][j], zr[r][j], zsq);
      }
      out_idx[row] = best_k[r];
      out_dist[row] = fmaxf(best[r] + zsq, 0.0f);
    }
  }
}

template <int DT, int R>
cudaError_t launch(const float* z, const float* cb, int n, int d, int k,
                   int64_t* out_idx, float* out_dist, cudaStream_t stream) {
  const int rows_per_block = kThreads * R;
  const unsigned grid = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  assign_kernel<DT, R><<<grid, kThreads, 0, stream>>>(z, cb, n, d, k, out_idx,
                                                      out_dist);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// z (n, d) and cb (k, d) f32 row-major, contiguous; out_idx (n,) int64 and
// out_dist (n,) f32. 1 <= d <= 128. Launches on `stream` without
// synchronising; returns cudaGetLastError().
int assign_launch(const void* z, const void* cb, int n, int d, int k,
                  void* out_idx, void* out_dist, void* stream) {
  if (n <= 0 || d <= 0 || d > 128 || k <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* zf = static_cast<const float*>(z);
  const float* cf = static_cast<const float*>(cb);
  int64_t* oi = static_cast<int64_t*>(out_idx);
  float* od = static_cast<float*>(out_dist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows per thread: R * DT query floats stay in registers (<= 64)
  cudaError_t err;
  if (d <= 4) {
    err = launch<4, 4>(zf, cf, n, d, k, oi, od, s);
  } else if (d <= 8) {
    err = launch<8, 4>(zf, cf, n, d, k, oi, od, s);
  } else if (d <= 16) {
    err = launch<16, 4>(zf, cf, n, d, k, oi, od, s);
  } else if (d <= 32) {
    err = launch<32, 2>(zf, cf, n, d, k, oi, od, s);
  } else if (d <= 64) {
    err = launch<64, 1>(zf, cf, n, d, k, oi, od, s);
  } else {
    err = launch<128, 1>(zf, cf, n, d, k, oi, od, s);
  }
  return (int)err;
}

const char* assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
