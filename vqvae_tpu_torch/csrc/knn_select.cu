// Fused kNN candidate selection for Hopper (sm_90a): kernels K1 and K2.
//
// Replaces the Pallas TPU kernels of vqvae_tpu/ops/pallas_knn.py:
//   K1 = _select_kernel_packed (:124), the default (vqvae_tpu/ops/knn.py:385)
//   K2 = _select_kernel        (:58),  taken when the effective bins is not
//                                      a power of two (knn.py:165-172)
// Both reach pl.pallas_call through fused_select (pallas_knn.py:245).
//
// What it computes, for each query row q and database row g:
//   d = [-2q; |q|^2; 1] . [x_g; 1; |x_g|^2]   (cosine: [-q; 1] . [x_g; 1]),
// padded rows g >= n_valid set to +inf. Slot = g mod bins keeps the two
// smallest values seen; after the whole database, the k_sel smallest of the
// 2*bins accumulator entries come out in ascending order, the lowest
// accumulator column winning ties (column c < bins is the slot's best,
// bins + c its second).
//   K1 (packed): d is clamped >= 0 and its f32 bits carry the block id
//     g div bins in the low blk_bits mantissa bits, so one i32 compare
//     orders (distance, block). Decoded: dist = key & ~lo_mask as f32,
//     index = block * bins + slot, -1 where dist is not finite.
//   K2 (unpacked): (f32 distance, i32 row) pairs, strict < so the earlier
//     row wins ties; +inf never enters, so unfilled entries keep id -1.
// The plain PyTorch version is vqvae_tpu_torch/ops/knn_select.py
// fused_select_reference; the exact f32 re-rank stays in PyTorch.
//
// Design. The TPU kernel keeps sel_tile=128 query rows of 2*bins keys in
// VMEM and walks db tiles along a sequential grid axis. Here the grid runs
// over blocks of R query rows, in no order, and the database walk is a loop
// inside the block:
// - One thread owns one slot s (two when bins > 512) for all R rows and
//   keeps its 2*R accumulator entries in registers across the whole walk:
//   it reads database rows s, s+bins, s+2*bins, ... (neighbouring threads
//   read neighbouring rows, so each sub-block of bins rows is one
//   coalesced sweep) and needs no barrier until the walk ends. The R query
//   rows sit in shared memory and every distance reads them as broadcast
//   float4 loads.
// - After the walk the accumulators go to shared memory (R * 2 * bins
//   entries: 8 B each packed, 16 B unpacked) and one warp per query row
//   peels off the k_sel minima: each lane scans its strided share of the
//   2*bins entries, a butterfly shuffle reduces (value, column)
//   lexicographically, and the picked entry is overwritten (packed: INT_MAX,
//   unpacked: +inf) exactly as the Pallas kernel does.
// - The result does not depend on the tiling: slot and block id are
//   functions of the global row, blk_bits comes from the padded database
//   size, and each slot sees its rows in increasing order.
//
// Bound. Per (query, row) pair: D+2 multiply-adds (the padded d_aug) and one
// top-2 compare, on CUDA cores in f32 (the Pallas kernel's own selection
// precision is the MXU default; the exact re-rank restores exact
// distances). At the codebook stage's shape (983,040 x 983,040, D=16) that
// is 3.5e13 FLOP (0.52 s at the H100's 67 TFLOP/s f32 peak) plus 9.7e11
// compares, so the kernel is bound by operations, not by HBM: the inputs
// are 63 MB. Rows per block R is the lever on database traffic: every block
// re-reads the d_aug*4-byte rows of the whole database, N^2 * d_aug * 4 / R
// bytes in all (4.8 TB from L2 at R=16, d_aug=20 — one L2 pass of ~1 s at
// ~5 TB/s), so R is as large as the shared-memory accumulator allows:
// R=16 packed (128 KB at bins=1024); unpacked, R=8 at bins=1024 (128 KB)
// and R=16 at bins <= 768 (193 KB at 768). Unpacked, a thread holds 4*R
// accumulator registers plus R partial sums, so R=16 meets the
// 128-register cap of __launch_bounds__(512) and spills 32 B. Capping
// unpacked R at 8 removes the spill but made K2 at bins 768 slower on an
// H100 (PERF.md, chip_smoke.py): the doubled database re-reads cost more
// than the spill, so the spill stays. Each thread
// computes R independent dot products per database row, which gives the
// FMA pipes R-way instruction-level parallelism; the broadcast query loads
// (one LDS.128 per 4 FMAs) are the next limit. Measured times are in
// PERF.md (chip_smoke.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBigI32 = 0x7fffffff;
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory

template <int R, bool PACKED>
__global__ void __launch_bounds__(kMaxThreads)
select_kernel(const float4* __restrict__ qa, const float4* __restrict__ xa,
              int qp, int np, int d4, int n_valid, int bins, int k_sel,
              int blk_bits, float* __restrict__ out_d,
              int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float4* sq = smem4;                                   // [R][d4]
  const int width = 2 * bins;                           // accumulator columns
  int* acc_k = reinterpret_cast<int*>(sq + R * d4);     // [R][width] keys
  float* acc_d = reinterpret_cast<float*>(acc_k);       // unpacked distances
  int* acc_i = acc_k + R * width;                       // unpacked row ids

  const int row0 = blockIdx.x * R;
  for (int idx = threadIdx.x; idx < R * d4; idx += blockDim.x) {
    const int r = idx / d4;
    sq[idx] = (row0 + r < qp) ? qa[(size_t)(row0 + r) * d4 + idx % d4]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int lo_mask = (1 << blk_bits) - 1;
  const int hi_mask = ~lo_mask;
  const int n_sb = np / bins;

  for (int s = threadIdx.x; s < bins; s += blockDim.x) {
    int k1[R], k2[R];
    float a1[R], a2[R];
    int i1[R], i2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (PACKED) {
        k1[r] = kBigI32;
        k2[r] = kBigI32;
      } else {
        a1[r] = INFINITY;
        a2[r] = INFINITY;
        i1[r] = -1;
        i2[r] = -1;
      }
    }
    for (int sb = 0; sb < n_sb; ++sb) {
      const int g = sb * bins + s;
      const float4* xr = xa + (size_t)g * d4;
      float d[R];
#pragma unroll
      for (int r = 0; r < R; ++r) d[r] = 0.f;
      for (int c = 0; c < d4; ++c) {
        const float4 xv = __ldg(xr + c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv = sq[r * d4 + c];
          d[r] = fmaf(qv.x, xv.x, d[r]);
          d[r] = fmaf(qv.y, xv.y, d[r]);
          d[r] = fmaf(qv.z, xv.z, d[r]);
          d[r] = fmaf(qv.w, xv.w, d[r]);
        }
      }
      const bool valid = g < n_valid;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (PACKED) {
          const float dv = valid ? fmaxf(d[r], 0.f) : INFINITY;
          const int key = (__float_as_int(dv) & hi_mask) | sb;
          if (key < k2[r]) {
            if (key < k1[r]) {
              k2[r] = k1[r];
              k1[r] = key;
            } else {
              k2[r] = key;
            }
          }
        } else {
          const float dv = valid ? d[r] : INFINITY;
          if (dv < a2[r]) {
            if (dv < a1[r]) {
              a2[r] = a1[r];
              i2[r] = i1[r];
              a1[r] = dv;
              i1[r] = g;
            } else {
              a2[r] = dv;
              i2[r] = g;
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (PACKED) {
        acc_k[r * width + s] = k1[r];
        acc_k[r * width + bins + s] = k2[r];
      } else {
        acc_d[r * width + s] = a1[r];
        acc_d[r * width + bins + s] = a2[r];
        acc_i[r * width + s] = i1[r];
        acc_i[r * width + bins + s] = i2[r];
      }
    }
  }
  __syncthreads();

  // extraction: one warp per query row, k_sel rounds of a warp argmin
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    const int row = row0 + r;
    if (row >= qp) break;  // warp-uniform; later rows are out of range too
    for (int t = 0; t < k_sel; ++t) {
      int bc = kBigI32;
      int bk = kBigI32;
      float bd = INFINITY;
      for (int c = lane; c < width; c += 32) {
        if (PACKED) {
          const int v = acc_k[r * width + c];
          if (v < bk || (v == bk && c < bc)) {
            bk = v;
            bc = c;
          }
        } else {
          const float v = acc_d[r * width + c];
          if (v < bd || (v == bd && c < bc)) {
            bd = v;
            bc = c;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
        if (PACKED) {
          const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
          if (ok < bk || (ok == bk && oc < bc)) {
            bk = ok;
            bc = oc;
          }
        } else {
          const float od = __shfl_xor_sync(0xffffffffu, bd, off);
          if (od < bd || (od == bd && oc < bc)) {
            bd = od;
            bc = oc;
          }
        }
      }
      if (lane == 0) {
        const size_t o = (size_t)row * k_sel + t;
        if (PACKED) {
          const float dist = __int_as_float(bk & hi_mask);
          const int cid = (bk & lo_mask) * bins + (bc & (bins - 1));
          out_d[o] = dist;
          out_i[o] = isfinite(dist) ? cid : -1;
          acc_k[r * width + bc] = kBigI32;
        } else {
          out_d[o] = bd;
          out_i[o] = acc_i[r * width + bc];
          acc_d[r * width + bc] = INFINITY;
        }
      }
      __syncwarp();
    }
  }
}

// Largest R of 16, 8, 4, 2, 1 that fits shared memory (see the note above
// for why unpacked R=16 is kept despite its spill).
int rows_per_block(int bins, int d4, int packed) {
  const size_t entry = packed ? 8 : 16;  // bytes per slot and query row
  for (int r = 16; r >= 1; r /= 2) {
    if ((size_t)r * (d4 * 16 + bins * entry) <= (size_t)kMaxSmem) return r;
  }
  return 0;
}

template <int R, bool PACKED>
cudaError_t launch(const float4* qa, const float4* xa, int qp, int np, int d4,
                   int n_valid, int bins, int k_sel, int blk_bits,
                   float* out_d, int* out_i, cudaStream_t stream) {
  const int per_thread = (bins + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((bins + per_thread - 1) / per_thread + 31) / 32 * 32;
  const size_t smem = (size_t)R * (d4 * 16 + bins * (PACKED ? 8 : 16));
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel<R, PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((qp + R - 1) / R);
  select_kernel<R, PACKED><<<grid, threads, smem, stream>>>(
      qa, xa, qp, np, d4, n_valid, bins, k_sel, blk_bits, out_d, out_i);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t dispatch(int rows, const float4* qa, const float4* xa, int qp,
                     int np, int d4, int n_valid, int bins, int k_sel,
                     int blk_bits, float* out_d, int* out_i,
                     cudaStream_t stream) {
  switch (rows) {
    case 16:
      return launch<16, PACKED>(qa, xa, qp, np, d4, n_valid, bins, k_sel,
                                blk_bits, out_d, out_i, stream);
    case 8:
      return launch<8, PACKED>(qa, xa, qp, np, d4, n_valid, bins, k_sel,
                               blk_bits, out_d, out_i, stream);
    case 4:
      return launch<4, PACKED>(qa, xa, qp, np, d4, n_valid, bins, k_sel,
                               blk_bits, out_d, out_i, stream);
    case 2:
      return launch<2, PACKED>(qa, xa, qp, np, d4, n_valid, bins, k_sel,
                               blk_bits, out_d, out_i, stream);
    case 1:
      return launch<1, PACKED>(qa, xa, qp, np, d4, n_valid, bins, k_sel,
                               blk_bits, out_d, out_i, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// qa (qp, d_aug) and xa (np, d_aug) f32 row-major with d_aug % 4 == 0 and
// np % bins == 0; out_d (qp, k_sel) f32 and out_i (qp, k_sel) i32. Launches
// on `stream` without synchronising; returns cudaGetLastError().
int knn_select_launch(const void* qa, const void* xa, int qp, int np,
                      int d_aug, int n_valid, int bins, int k_sel, int packed,
                      int blk_bits, void* out_d, void* out_i, void* stream) {
  if (qp <= 0 || np <= 0 || bins <= 0 || np % bins || d_aug % 4 ||
      k_sel <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int d4 = d_aug / 4;
  const int rows = rows_per_block(bins, d4, packed);
  const float4* q = static_cast<const float4*>(qa);
  const float4* x = static_cast<const float4*>(xa);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      packed ? dispatch<true>(rows, q, x, qp, np, d4, n_valid, bins, k_sel,
                              blk_bits, od, oi, s)
             : dispatch<false>(rows, q, x, qp, np, d4, n_valid, bins, k_sel,
                               blk_bits, od, oi, s);
  return (int)err;
}

const char* knn_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
