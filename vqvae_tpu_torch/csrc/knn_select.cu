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
// as one f32 fused multiply-add chain over the augmented columns in order
// (the rounding of a plain f32 product of the augmented operands), padded
// rows g >= n_valid set to +inf. Slot = g mod bins keeps the two smallest
// values seen; after the whole database, the k_sel smallest of the 2*bins
// accumulator entries come out in ascending order, the lowest accumulator
// column winning ties (column c < bins is the slot's best, bins + c its
// second).
//   K1 (packed): d is clamped >= 0 and its f32 bits carry the block id
//     g div bins in the low blk_bits mantissa bits, so one i32 compare
//     orders (distance, block). Decoded: dist = key & ~lo_mask as f32,
//     index = block * bins + slot, -1 where dist is not finite.
//   K2 (unpacked): (f32 distance, i32 row) pairs, strict < so the earlier
//     row wins ties; +inf never enters, so unfilled entries keep id -1.
// The plain PyTorch version is vqvae_tpu_torch/ops/knn_select.py
// fused_select_reference; the exact f32 re-rank stays in PyTorch.
//
// Bound. Per (query, row) pair the work is a D-term product and one top-2
// compare. On the tensor cores at f32-equivalent precision (three TF32
// passes, 495 TFLOP/s) the product of 16,384 x 983,040 pairs at D = 16 is
// 3.1 ms and the compares (int32 at 33.5 T/s) 0.5 ms, so operations bound
// the kernel; its inputs are 63 MB (19 us of HBM). The CUDA-core f32 loop
// of the first version (D+2 multiply-adds a pair at 67 TFLOP/s) was bound
// at 9.1 ms and ran at 50 ms: it issued about 35 instructions a pair and
// each block of 16 query rows streamed the whole augmented database
// (78.6 MB, more than the 50 MB L2). Here the product takes two walks of
// three passes (mma.sync reaches about 325 of the 495 TFLOP/s), and a
// pair costs a few instructions beside it.
//
// Design: two walks over the database on the tensor cores bound each query
// row's answer; only the few rows inside the bound get the exact chain.
// - prep_kernel splits the first D (cross-term) columns of every query and
//   database row into TF32 hi/lo parts, once, in the fragment order of
//   mma.sync.m16n8k8: each operand fragment is then one conflict-free
//   128-bit load. The tail columns are kept apart: alpha = qa[D] per query
//   row, beta = xa[D+1] per database row (+inf where padded).
// - walk_kernel: a warp owns 32 query rows (two m16 fragments) and its
//   block's 32 contiguous slots [s0, s0+32); a block walks the
//   super-blocks sb = 0 .. np/bins-1, and step sb's tile is database rows
//   sb*bins + s0 + [0, 32), brought by cp.async into a ring of stages.
//   At D <= 16 (2 k-steps, the codebook stage) and 24 < D <= 32 (4
//   k-steps, CIFAR's latent) the query fragments stay in registers for
//   the whole walk (32 or 64 registers a thread) and a block of 4 warps
//   shares each tile; other widths read them from shared memory every
//   step: there the fragments cost a 128-bit load per mma pair, and the
//   query records (80 floats a row at D = 32) fill the SM's shared memory
//   at 8 warps, too few to hide the tiles' latency.
//   Each accumulator element keeps one (query row, slot) pair for the
//   whole walk: its fragment starts at beta and adds q.x as three TF32
//   products (lo*hi + hi*lo + hi*hi); plus alpha it is within eps =
//   2^-15 S of the exact chain (S bounds the sum of the terms' magnitudes;
//   the rounding error is below 2^-17 S). The first walk, over every
//   second super-block (every fourth for k_sel <= 24), keeps each
//   element's two smallest approximations: three min/max operations a
//   pair, no branch.
// - bound_kernel, a warp per query row: the k_sel-th smallest of those
//   2*bins entries bounds the exact k_sel-th entry of the whole walk from
//   above, within eps (a slot's top-2 over part of its rows is no smaller
//   than over all of them), so every row that can reach the answer has an
//   approximation below V + 2 eps (packed: plus the truncation bucket).
//   That is the row's threshold T. The warp reads the row once into
//   registers (64 entries a lane at bins 1024); the k_sel-th smallest of
//   the lanes' minima is at least the row's k_sel-th smallest entry, so
//   for k_sel <= 32 only the entries at or below it (a few dozen) are
//   gathered and selected from; more than kBoundCap of them, or k_sel >
//   32, take the first design's k_sel passes over the row in memory
//   (8 KB a row, bound by the cache's bandwidth).
// - The second walk, over every super-block, recomputes the
//   approximations and appends each row g below T to the query row's
//   candidate list: about 2*k_sel rows of 983,040 at the codebook stage,
//   so one compare a pair and one branch a thread and step, taken about
//   once in 500 steps.
// - final_kernel, a warp per query row: the exact chain of each candidate,
//   its rank within its slot (the slot's first two are the accumulator
//   entries), and the k_sel smallest entries by (key, column): the
//   binned top-2 and extraction of the Pallas kernel, restricted to the
//   rows that can matter. A row whose list overflows, or holds fewer than
//   k_sel entries, is settled in full instead: each slot's exact top-2 by
//   the warp's lanes (every 32nd block, merged by shuffles), then k_sel
//   rounds of a warp argmin that overwrite the picked entry.
// - So every value that leaves the kernel is the exact chain, and the
//   result does not depend on the tiling: slot and block id are functions
//   of the global row, blk_bits comes from the padded database size, and
//   ties are broken as a sequential walk in row order breaks them.
// Measured times are in PERF.md (chip_smoke.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBigI32 = 0x7fffffff;
constexpr int kInfBits = 0x7f800000;
constexpr int kSlots = 32;            // slots (tile columns) per block
constexpr int kTiles = kSlots / 8;    // n8 column tiles per warp
constexpr int kElems = 4 * kTiles;    // elements per thread and m16 fragment
constexpr int kMaxSmem = 232448;      // 227 KB: a block's dynamic smem
constexpr float kEpsScale = 1.0f / 32768.0f;  // eps = 2^-15 S
constexpr int kRowWarps = 8;          // warps (query rows) per block of
                                      // the per-row kernels
constexpr int kPrepThreads = 256;
constexpr int kCap = 384;             // candidate list length per query row
constexpr int kBoundPer = 64;         // first-walk entries a lane holds in
                                      // registers (2*bins <= 2048)
constexpr int kBoundCap = 512;        // entries under the bound kernel's
                                      // threshold it gathers at most

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D = A (16x8, row) * B (8x8, col) + D, TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(fill ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(fill ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The exact selection value: one f32 FMA chain over the augmented columns
// in order, starting from 0 (the first version's, and at the codebook
// stage's shapes cuBLAS's, rounding of the f32 product).
__device__ __forceinline__ float exact_value(const float* qrow,
                                             const float* xrow, int d4) {
  const float4* q = reinterpret_cast<const float4*>(qrow);
  const float4* x = reinterpret_cast<const float4*>(xrow);
  float d = 0.f;
  for (int c = 0; c < d4; ++c) {
    const float4 qv = __ldg(q + c);
    const float4 xv = __ldg(x + c);
    d = fmaf(qv.x, xv.x, d);
    d = fmaf(qv.y, xv.y, d);
    d = fmaf(qv.z, xv.z, d);
    d = fmaf(qv.w, xv.w, d);
  }
  return d;
}

// A row's split record is 16*ks floats: per k-step of 8 columns and per
// thread-in-group t, {hi(c), hi(c+4), lo(c), lo(c+4)} with c = 8*ks + t.
// In shared memory rows are 16 (mod 32) floats apart, so the 8 rows a
// warp's quarter reads at once fall on distinct banks.
__host__ __device__ __forceinline__ int record_stride(int ks) {
  return 16 * ks + ((ks & 1) ? 0 : 16);
}

__host__ __device__ __forceinline__ size_t align4(size_t n) {
  return (n + 3) & ~(size_t)3;
}

// The work buffer: query records, query terms (alpha, |q_D|), database
// records, database beta, the maxima of |x_D| and |beta| over the valid
// database rows, and per query row its threshold, candidate count and
// candidate list.
struct Work {
  float* qrec;
  float* qterm;
  float* xrec;
  float* xbeta;
  float* maxes;
  float* thr;
  int* count;
  int* list;
};

size_t work_floats(int qp, int np, int ks) {
  return align4((size_t)qp * 16 * ks) + align4((size_t)qp * 2) +
         align4((size_t)np * 16 * ks) + align4((size_t)np) + 4 +
         2 * align4((size_t)qp) + (size_t)qp * kCap;
}

Work carve(float* base, int qp, int np, int ks) {
  Work w;
  w.qrec = base;
  w.qterm = w.qrec + align4((size_t)qp * 16 * ks);
  w.xrec = w.qterm + align4((size_t)qp * 2);
  w.xbeta = w.xrec + align4((size_t)np * 16 * ks);
  w.maxes = w.xbeta + align4((size_t)np);
  w.thr = w.maxes + 4;
  w.count = reinterpret_cast<int*>(w.thr + align4((size_t)qp));
  w.list = w.count + align4((size_t)qp);
  return w;
}

// One thread per row of qa (is_db = 0) or xa (is_db = 1): the split record
// and the row's terms; database rows also raise the maxima of |x_D| and
// |beta| over the valid rows (as f32 bits: non-negative floats order as
// their bits do).
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const float* __restrict__ a, int rows, int d_aug, int d,
            int ks_count, int n_valid, int is_db, float* __restrict__ rec,
            float* __restrict__ term, unsigned* __restrict__ maxes) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = row < rows;
  const float* src = a + (size_t)(in_range ? row : 0) * d_aug;
  float n = 0.f;
  if (in_range) {
    float4* out =
        reinterpret_cast<float4*>(rec + (size_t)row * 16 * ks_count);
    for (int qd = 0; qd < 4 * ks_count; ++qd) {
      const int c0 = 8 * (qd >> 2) + (qd & 3);
      const int c1 = c0 + 4;
      const float v0 = c0 < d ? src[c0] : 0.f;
      const float v1 = c1 < d ? src[c1] : 0.f;
      const float h0 = __uint_as_float(to_tf32(v0));
      const float h1 = __uint_as_float(to_tf32(v1));
      out[qd] = make_float4(h0, h1, __uint_as_float(to_tf32(v0 - h0)),
                            __uint_as_float(to_tf32(v1 - h1)));
    }
    for (int c = 0; c < d; ++c) n = fmaf(src[c], src[c], n);
    n = sqrtf(n);
  }
  if (!is_db) {
    if (in_range) {
      term[2 * (size_t)row] = src[d];
      term[2 * (size_t)row + 1] = n;
    }
    return;
  }
  const float beta = in_range && d + 1 < d_aug ? src[d + 1] : 0.f;
  const bool valid = in_range && row < n_valid;
  if (in_range) term[row] = valid ? beta : INFINITY;
  const unsigned mn =
      __reduce_max_sync(0xffffffffu, valid ? __float_as_uint(n) : 0u);
  const unsigned mb = __reduce_max_sync(
      0xffffffffu, valid ? __float_as_uint(fabsf(beta)) : 0u);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(maxes, mn);
    atomicMax(maxes + 1, mb);
  }
}

// eps of a query row: 2^-15 times a bound on the sum of the magnitudes of
// its terms against any valid database row
__device__ __forceinline__ float row_eps(const Work& work, int r) {
  return kEpsScale * fmaf(work.qterm[2 * (size_t)r + 1], work.maxes[0],
                          fabsf(work.qterm[2 * (size_t)r]) + work.maxes[1]);
}

// Shared memory of walk_kernel, in floats: the query records (when they
// are not held in registers), the query rows' thresholds, and a ring of
// `stages` database tiles (records and beta).
size_t walk_smem_floats(int rows, int ks, int stages, bool query_records) {
  const size_t stride = record_stride(ks);
  return (query_records ? stride * rows : 0) + rows +
         stages * (stride * kSlots + kSlots);
}

// Blocks of walk_kernel an SM must hold, for the register budget: with
// the query fragments in registers at ks = 2, three; at ks = 4 (64
// registers of fragments) three for the second walk, two for the first,
// whose two running minima per element take 64 more; from shared memory,
// one (its ring and records fill the SM first).
__host__ __device__ constexpr int walk_min_blocks(int ks, bool collect) {
  return ks == 2 ? 3 : ks > 2 ? (collect ? 3 : 2) : 1;
}

// A warp owns 32 query rows (two m16 fragments) and the block's 32 slots;
// KS > 0: the query fragments (KS k-steps) sit in registers for the whole
// walk, else they are read from shared memory every step.
// COLLECT = false: the first walk, over every `every`-th super-block,
// writing each element's two smallest approximations (without alpha) to tb
// (qp, 2*bins) at columns s and bins + s. COLLECT = true: the second walk,
// over all super-blocks (every = 1), appending every valid row whose
// approximation is at most the query row's threshold to its list.
template <int KS, int WARPS, int STAGES, bool COLLECT>
__global__ void __launch_bounds__(32 * WARPS, walk_min_blocks(KS, COLLECT))
walk_kernel(Work work, int qp, int ks_count, int n_valid, int bins,
            int n_sb, int every, float* __restrict__ tb) {
  constexpr int kRows = 32 * WARPS;
  constexpr int kE = 2 * kElems;            // elements per thread
  constexpr int kA = KS ? KS : 1;
  extern __shared__ float4 smem4[];
  const int ksn = KS ? KS : ks_count;
  const int stride = record_stride(ksn);
  const int rec_len = 16 * ksn;             // floats of a record in memory
  float* sq = reinterpret_cast<float*>(smem4);  // [kRows][stride], KS == 0
  float* s_thr = sq + (KS ? 0 : kRows * stride);
  float* ring = s_thr + kRows;  // STAGES x ([kSlots][stride], beta[kSlots])
  const int stage_len = kSlots * stride + kSlots;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const int s0 = blockIdx.y * kSlots;
  const int chunks = rec_len / 4;

  // the tile of step i (super-block i * every) into ring stage i % STAGES
  // (slots >= bins zero-filled; their elements are never written out or
  // collected)
  const int n_steps = (n_sb + every - 1) / every;
  auto load_tile = [&](int i) {
    const int sb = i * every;
    float* dst = ring + (i % STAGES) * stage_len;
    for (int idx = tid; idx < kSlots * chunks; idx += blockDim.x) {
      const int t = idx / chunks;
      const int c = idx - t * chunks;
      const bool in_range = s0 + t < bins;
      const size_t g = in_range ? (size_t)sb * bins + s0 + t : 0;
      cp_async16(dst + t * stride + 4 * c, work.xrec + g * rec_len + 4 * c,
                 in_range);
    }
    for (int t = tid; t < kSlots; t += blockDim.x) {
      const bool in_range = s0 + t < bins;
      const size_t g = in_range ? (size_t)sb * bins + s0 + t : 0;
      cp_async4(dst + kSlots * stride + t, work.xbeta + g, in_range);
    }
  };
  // this thread's query rows: my_r[2*mb + h] = 32*warp + 16*mb + grp + 8*h
  int my_r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) my_r[k] = 32 * warp + 8 * k + grp;
  uint4 afr[2][kA][2];
  if (KS) {
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
      for (int ks = 0; ks < kA; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + my_r[2 * mb + h];
          afr[mb][ks][h] = r < qp ? *reinterpret_cast<const uint4*>(
                                        work.qrec + (size_t)r * rec_len +
                                        16 * ks + 4 * tig)
                                  : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  } else {
    for (int idx = tid; idx < kRows * chunks; idx += blockDim.x) {
      const int t = idx / chunks;
      const int c = idx - t * chunks;
      const bool in_range = row0 + t < qp;
      const size_t r = in_range ? (size_t)row0 + t : 0;
      cp_async16(sq + t * stride + 4 * c, work.qrec + r * rec_len + 4 * c,
                 in_range);
    }
  }
  float t_row[4] = {0.f, 0.f, 0.f, 0.f};
  if (COLLECT) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = row0 + my_r[k];
      t_row[k] = r < qp ? work.thr[r] : -INFINITY;
    }
  }
  // tiles 0 .. STAGES-2 in flight, one commit group each
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_steps) load_tile(i);
    cp_async_commit();
  }

  // element e = 16*mb + 4*j + q: query row my_r[2*mb + (q >> 1)], tile
  // column 8*j + 2*tig + (q & 1)
  float m1[kE], m2[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) m1[e] = m2[e] = INFINITY;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i has landed
    __syncthreads();  // ... for every thread; step i-1 is done
    if (i + STAGES - 1 < n_steps) load_tile(i + STAGES - 1);  // its stage
    cp_async_commit();
    const int sb = i * every;
    const float* xs = ring + (i % STAGES) * stage_len;
    const float* beta = xs + kSlots * stride;

    float f[2][kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const float2 b =
          *reinterpret_cast<const float2*>(beta + 8 * j + 2 * tig);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        f[mb][j][0] = f[mb][j][2] = b.x;
        f[mb][j][1] = f[mb][j][3] = b.y;
      }
    }
#pragma unroll
    for (int ks = 0; ks < ksn; ++ks) {
      uint4 b[kTiles];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        b[j] = *reinterpret_cast<const uint4*>(
            xs + (8 * j + grp) * stride + 16 * ks + 4 * tig);
      }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        uint4 a0, a1;
        if (KS) {
          a0 = afr[mb][KS ? ks : 0][0];
          a1 = afr[mb][KS ? ks : 0][1];
        } else {
          a0 = *reinterpret_cast<const uint4*>(
              sq + my_r[2 * mb] * stride + 16 * ks + 4 * tig);
          a1 = *reinterpret_cast<const uint4*>(
              sq + my_r[2 * mb + 1] * stride + 16 * ks + 4 * tig);
        }
        // small products first; consecutive products are independent
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          mma_tf32(f[mb][j], a0.z, a1.z, a0.w, a1.w, b[j].x, b[j].y);
        }
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          mma_tf32(f[mb][j], a0.x, a1.x, a0.y, a1.y, b[j].z, b[j].w);
        }
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          mma_tf32(f[mb][j], a0.x, a1.x, a0.y, a1.y, b[j].x, b[j].y);
        }
      }
    }
    if (!COLLECT) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float v = f[e >> 4][(e >> 2) & 3][e & 3];
        m2[e] = fminf(m2[e], fmaxf(m1[e], v));
        m1[e] = fminf(m1[e], v);
      }
      continue;
    }
    // one branch per step, taken when any element is at its threshold
    float low = INFINITY;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      low = fminf(low, f[e >> 4][(e >> 2) & 3][e & 3] -
                           t_row[2 * (e >> 4) + ((e >> 1) & 1)]);
    }
    if (low <= 0.f) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int k = 2 * (e >> 4) + ((e >> 1) & 1);
        if (f[e >> 4][(e >> 2) & 3][e & 3] <= t_row[k]) {
          const int s = s0 + 8 * ((e >> 2) & 3) + 2 * tig + (e & 1);
          const int g = sb * bins + s;
          if (s < bins && g < n_valid) {
            const int r = row0 + my_r[k];
            const int c = atomicAdd(work.count + r, 1);
            if (c < kCap) work.list[(size_t)r * kCap + c] = g;
          }
        }
      }
    }
  }
  if (COLLECT) return;
  const int width = 2 * bins;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int r = row0 + my_r[2 * (e >> 4) + ((e >> 1) & 1)];
    const int s = s0 + 8 * ((e >> 2) & 3) + 2 * tig + (e & 1);
    if (r >= qp || s >= bins) continue;
    tb[(size_t)r * width + s] = m1[e];
    tb[(size_t)r * width + bins + s] = m2[e];
  }
}

// The k-th smallest of a warp's row of n values, consumed (each round
// overwrites the picked value with +inf).
__device__ float warp_kth_smallest(float* v, int n, int k, int lane) {
  float best = INFINITY;
  for (int t = 0; t < k; ++t) {
    float bv = INFINITY;
    int bc = kBigI32;
    for (int c = lane; c < n; c += 32) {
      if (v[c] < bv) {
        bv = v[c];
        bc = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (ov < bv || (ov == bv && oc < bc)) {
        bv = ov;
        bc = oc;
      }
    }
    best = bv;
    if (lane == 0 && bc != kBigI32) v[bc] = INFINITY;
    __syncwarp();
  }
  return best;
}

// The k-th smallest of a warp's row of n <= 32 * kBoundPer values when k
// <= 32, or +inf with *done false where this route does not settle it.
// Each lane holds its n / 32 entries in registers. The k-th smallest of
// the 32 lanes' minima, T, has k lanes' minima at or below it, so the
// row's k-th smallest lies among the entries <= T: usually a few dozen.
// Those are gathered into `buf` (kBoundCap floats), and rounds of a warp
// minimum retire every entry equal to it until k are retired.
__device__ float warp_kth_registers(const float* __restrict__ v, int n,
                                    int k, int lane, float* buf,
                                    bool* done) {
  float r[kBoundPer];
  float lm = INFINITY;
#pragma unroll
  for (int j = 0; j < kBoundPer; ++j) {
    const int c = lane + 32 * j;
    r[j] = c < n ? v[c] : INFINITY;
    lm = fminf(lm, r[j]);
  }
  *done = false;
  if (k > 32) return INFINITY;
  // T: the lane minimum of rank k - 1 (ties by lane)
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float o = __shfl_sync(0xffffffffu, lm, j);
    rank += o < lm || (o == lm && j < lane);
  }
  const unsigned at_k = __ballot_sync(0xffffffffu, rank == k - 1);
  const float t = __shfl_sync(0xffffffffu, lm, __ffs(at_k) - 1);
  if (!(t < INFINITY)) return INFINITY;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kBoundPer; ++j) mine += r[j] <= t;
  int incl = mine;  // inclusive prefix over the lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  if (total > kBoundCap) return INFINITY;
  int at = incl - mine;
#pragma unroll
  for (int j = 0; j < kBoundPer; ++j) {
    if (r[j] <= t) buf[at++] = r[j];
  }
  __syncwarp();
  float w[kBoundCap / 32];
#pragma unroll
  for (int i = 0; i < kBoundCap / 32; ++i) {
    const int c = lane + 32 * i;
    w[i] = c < total ? buf[c] : INFINITY;
  }
  __syncwarp();
  // total >= k finite entries: a round always retires one or more
  for (;;) {
    float m = INFINITY;
#pragma unroll
    for (int i = 0; i < kBoundCap / 32; ++i) m = fminf(m, w[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    int c = 0;
#pragma unroll
    for (int i = 0; i < kBoundCap / 32; ++i) {
      if (w[i] == m) {
        ++c;
        w[i] = INFINITY;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (c >= k) {
      *done = true;
      return m;
    }
    k -= c;
  }
}

// A warp per query row: its threshold from the first walk's entries, and
// an empty candidate list. The k_sel-th smallest of the 2*bins entries
// comes from registers (warp_kth_registers) where it can, else from
// k_sel rounds over the row in memory (warp_kth_smallest).
template <bool PACKED>
__global__ void __launch_bounds__(32 * kRowWarps)
bound_kernel(Work work, float* __restrict__ tb, int qp, int bins, int k_sel,
             int blk_bits) {
  __shared__ float s_buf[kRowWarps][kBoundCap];
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowWarps + wid;
  if (row >= qp) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  float* entries = tb + (size_t)row * 2 * bins;
  bool done = false;
  float v = INFINITY;
  if (2 * bins <= 32 * kBoundPer) {
    v = warp_kth_registers(entries, 2 * bins, k_sel, lane, s_buf[wid],
                           &done);
  }
  if (!done) v = warp_kth_smallest(entries, 2 * bins, k_sel, lane);
  if (lane != 0) return;
  const float alpha = work.qterm[2 * (size_t)row];
  const float eps = row_eps(work, row);
  float t = v + 2.f * eps;
  if (PACKED) {
    // every row whose key can reach the k_sel-th entry's truncation bucket
    const int lo_mask = (1 << blk_bits) - 1;
    const float hi = fmaxf(v + alpha + eps, 0.f);
    t = __int_as_float((__float_as_int(hi) | lo_mask) + 1) - alpha + eps;
  }
  work.thr[row] = v < INFINITY ? t : INFINITY;
  work.count[row] = 0;
}

// (value, row) pairs in lexicographic order; an empty entry is
// (+inf, INT_MAX)
__device__ __forceinline__ bool pair_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// The exact top-2 of slot s over the whole database, by the warp: lane l
// walks blocks l, l+32, ... and the lanes' top-2 lists merge by shuffles.
// Packed entries are keys (in i1, i2); unpacked, (distance, row) pairs.
template <bool PACKED>
__device__ void settle_slot(const float* qrow, const float* xa, int d_aug,
                            int n_valid, int bins, int n_sb, int hi_mask,
                            int s, int lane, int* rk, float* rd, int* ri) {
  const int d4 = d_aug / 4;
  float a1 = INFINITY, a2 = INFINITY;
  int i1 = kBigI32, i2 = kBigI32;
  for (int sb = lane; sb < n_sb; sb += 32) {
    const int g = sb * bins + s;
    if (PACKED) {
      int key = (kInfBits & hi_mask) | sb;
      if (g < n_valid) {
        const float dv =
            fmaxf(exact_value(qrow, xa + (size_t)g * d_aug, d4), 0.f);
        key = (__float_as_int(dv) & hi_mask) | sb;
      }
      if (key < i2) {
        if (key < i1) {
          i2 = i1;
          i1 = key;
        } else {
          i2 = key;
        }
      }
    } else if (g < n_valid) {
      const float dv = exact_value(qrow, xa + (size_t)g * d_aug, d4);
      if (dv < INFINITY && pair_less(dv, g, a2, i2)) {
        if (pair_less(dv, g, a1, i1)) {
          a2 = a1;
          i2 = i1;
          a1 = dv;
          i1 = g;
        } else {
          a2 = dv;
          i2 = g;
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float b1 = __shfl_xor_sync(0xffffffffu, a1, off);
    const float b2 = __shfl_xor_sync(0xffffffffu, a2, off);
    const int j1 = __shfl_xor_sync(0xffffffffu, i1, off);
    const int j2 = __shfl_xor_sync(0xffffffffu, i2, off);
    // the two smallest of the sorted pairs (1, 2) and (b1/j1, b2/j2)
    const bool first = PACKED ? j1 < i1 : pair_less(b1, j1, a1, i1);
    if (first) {
      const bool second = PACKED ? j2 < i1 : pair_less(b2, j2, a1, i1);
      a2 = second ? b2 : a1;
      i2 = second ? j2 : i1;
      a1 = b1;
      i1 = j1;
    } else if (PACKED ? j1 < i2 : pair_less(b1, j1, a2, i2)) {
      a2 = b1;
      i2 = j1;
    }
  }
  if (lane == 0) {
    if (PACKED) {
      rk[s] = i1;
      rk[bins + s] = i2;
    } else {
      rd[s] = a1;
      rd[bins + s] = a2;
      ri[s] = i1 == kBigI32 ? -1 : i1;
      ri[bins + s] = i2 == kBigI32 ? -1 : i2;
    }
  }
  __syncwarp();
}

// The row's answer the long way: every slot's exact top-2 into the row's
// accumulator (2*bins entries of acc, acc_i), then k_sel rounds of a warp
// argmin over them, each overwriting its pick.
template <bool PACKED>
__device__ void settle_row(const float* qrow, const float* xa, int d_aug,
                           int n_valid, int bins, int n_sb, int k_sel,
                           int blk_bits, int lane, int* rk, int* ri,
                           float* od, int* oi) {
  const int width = 2 * bins;
  const int lo_mask = (1 << blk_bits) - 1;
  const int hi_mask = ~lo_mask;
  float* rd = reinterpret_cast<float*>(rk);
  for (int s = 0; s < bins; ++s) {
    settle_slot<PACKED>(qrow, xa, d_aug, n_valid, bins, n_sb, hi_mask, s,
                        lane, rk, rd, ri);
  }
  for (int t = 0; t < k_sel; ++t) {
    int bc = kBigI32;
    int bk = kBigI32;
    float bd = INFINITY;
    for (int c = lane; c < width; c += 32) {
      if (PACKED) {
        const int v = rk[c];
        if (v < bk || (v == bk && c < bc)) {
          bk = v;
          bc = c;
        }
      } else {
        const float v = rd[c];
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
        const float odv = __shfl_xor_sync(0xffffffffu, bd, off);
        if (odv < bd || (odv == bd && oc < bc)) {
          bd = odv;
          bc = oc;
        }
      }
    }
    if (lane == 0) {
      if (PACKED) {
        const float dist = __int_as_float(bk & hi_mask);
        od[t] = dist;
        oi[t] = isfinite(dist) ? (bk & lo_mask) * bins + (bc & (bins - 1))
                               : -1;
        rk[bc] = kBigI32;
      } else {
        od[t] = bd;
        oi[t] = ri[bc];
        rd[bc] = INFINITY;
      }
    }
    __syncwarp();
  }
}

// A warp per query row: the exact values of its candidates, each one's
// rank within its slot (ranks 0 and 1 are the slot's accumulator entries,
// in columns s and bins + s), and the k_sel smallest entries by (key or
// distance, column). Rows whose list overflowed or holds fewer than k_sel
// entries take settle_row.
template <bool PACKED>
__global__ void __launch_bounds__(32 * kRowWarps)
final_kernel(const float* __restrict__ qa, const float* __restrict__ xa,
             Work work, int* __restrict__ acc, int* __restrict__ acc_i,
             int qp, int d_aug, int n_valid, int bins, int n_sb, int k_sel,
             int blk_bits, float* __restrict__ out_d,
             int* __restrict__ out_i) {
  __shared__ int s_key[kRowWarps][kCap];  // packed keys, or f32 distances
  __shared__ int s_row[kRowWarps][kCap];
  __shared__ int s_col[kRowWarps][kCap];
  const int wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowWarps + wid;
  if (row >= qp) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int lo_mask = (1 << blk_bits) - 1;
  const int hi_mask = ~lo_mask;
  const float* qrow = qa + (size_t)row * d_aug;
  float* od = out_d + (size_t)row * k_sel;
  int* oi = out_i + (size_t)row * k_sel;
  int* key = s_key[wid];
  float* dist = reinterpret_cast<float*>(key);
  int* grow = s_row[wid];
  int* col = s_col[wid];
  const int n = work.count[row];
  if (n <= kCap) {
    const int* list = work.list + (size_t)row * kCap;
    for (int c = lane; c < n; c += 32) {
      const int g = list[c];
      const float e = exact_value(qrow, xa + (size_t)g * d_aug, d_aug / 4);
      grow[c] = g;
      if (PACKED) {
        key[c] = (__float_as_int(fmaxf(e, 0.f)) & hi_mask) | (g / bins);
      } else {
        dist[c] = e < INFINITY ? e : NAN;  // +inf and NaN never enter
      }
    }
    __syncwarp();
    // rank within the slot: the slot's top-2 as a walk in row order keeps
    int entries = 0;
    for (int c = lane; c < n; c += 32) {
      const int s = grow[c] % bins;
      int rank = 0;
      bool keep = PACKED || dist[c] == dist[c];
      for (int c2 = 0; c2 < n && keep; ++c2) {
        if (c2 == c || grow[c2] % bins != s) continue;
        if (PACKED ? key[c2] < key[c]
                   : pair_less(dist[c2], grow[c2], dist[c], grow[c])) {
          ++rank;
        }
      }
      keep = keep && rank < 2;
      col[c] = keep ? s + rank * bins : -1;
      entries += keep;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      entries += __shfl_xor_sync(0xffffffffu, entries, off);
    }
    __syncwarp();
    if (entries >= k_sel) {
      // position of each entry among the entries by (value, column)
      for (int c = lane; c < n; c += 32) {
        if (col[c] < 0) continue;
        int pos = 0;
        for (int c2 = 0; c2 < n; ++c2) {
          if (col[c2] < 0) continue;
          const bool less =
              PACKED ? (key[c2] < key[c] ||
                        (key[c2] == key[c] && col[c2] < col[c]))
                     : pair_less(dist[c2], col[c2], dist[c], col[c]);
          pos += less;
        }
        if (pos < k_sel) {
          if (PACKED) {
            const float dv = __int_as_float(key[c] & hi_mask);
            od[pos] = dv;
            oi[pos] = isfinite(dv) ? grow[c] : -1;
          } else {
            od[pos] = dist[c];
            oi[pos] = grow[c];
          }
        }
      }
      return;
    }
  }
  settle_row<PACKED>(qrow, xa, d_aug, n_valid, bins, n_sb, k_sel, blk_bits,
                     lane, acc + (size_t)row * 2 * bins,
                     PACKED ? nullptr : acc_i + (size_t)row * 2 * bins, od,
                     oi);
}

template <int KS, int WARPS, int STAGES, bool COLLECT>
cudaError_t launch_walk(const Work& work, int qp, int np, int ks,
                        int n_valid, int bins, int every, float* tb,
                        cudaStream_t stream) {
  const size_t smem = walk_smem_floats(32 * WARPS, ks, STAGES, KS == 0) * 4;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<KS, WARPS, STAGES, COLLECT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((qp + 32 * WARPS - 1) / (32 * WARPS)),
                  (unsigned)((bins + kSlots - 1) / kSlots));
  walk_kernel<KS, WARPS, STAGES, COLLECT>
      <<<grid, 32 * WARPS, smem, stream>>>(work, qp, ks, n_valid, bins,
                                            np / bins, every, tb);
  return cudaGetLastError();
}

// D in (8, 16], the codebook stage's width, and D in (24, 32], CIFAR's:
// the query fragments in registers (32 and 64 registers a thread), 128
// query rows a block, and a ring deep enough that a tile has several
// steps to arrive (eight stages of 6.3 KB at D = 16, six of 10.4 KB at
// D = 32: three blocks an SM fit in shared memory). Other widths up to 128: fragments in shared
// memory, 64 rows and three stages.
template <bool COLLECT>
cudaError_t walk(const Work& work, int qp, int np, int ks, int n_valid,
                 int bins, int every, float* tb, cudaStream_t stream) {
  if (ks == 2) {
    return launch_walk<2, 4, 8, COLLECT>(work, qp, np, ks, n_valid, bins,
                                         every, tb, stream);
  }
  if (ks == 4) {
    return launch_walk<4, 4, 6, COLLECT>(work, qp, np, ks, n_valid, bins,
                                         every, tb, stream);
  }
  return launch_walk<0, 2, 3, COLLECT>(work, qp, np, ks, n_valid, bins,
                                       every, tb, stream);
}

template <bool PACKED>
cudaError_t launch(const float* qa, const float* xa, float* work_base,
                   int qp, int np, int d_aug, int d, int n_valid, int bins,
                   int k_sel, int blk_bits, int* acc, int* acc_i,
                   float* out_d, int* out_i, cudaStream_t stream) {
  const int ks = (d + 7) / 8;
  const Work work = carve(work_base, qp, np, ks);
  float* tb = reinterpret_cast<float*>(acc);
  const unsigned rows_grid = (unsigned)((qp + kRowWarps - 1) / kRowWarps);
  cudaError_t err =
      cudaMemsetAsync(work.maxes, 0, 2 * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  prep_kernel<<<(qp + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0,
                stream>>>(qa, qp, d_aug, d, ks, 0, 0, work.qrec, work.qterm,
                          nullptr);
  prep_kernel<<<(np + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0,
                stream>>>(xa, np, d_aug, d, ks, n_valid, 1, work.xrec,
                          work.xbeta,
                          reinterpret_cast<unsigned*>(work.maxes));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the first walk sees every `every`-th super-block: its k_sel-th entry
  // still bounds the answer from above, with about every * k_sel rows
  // under the bound, kept at most a quarter of the list
  const int every = 16 * k_sel <= kCap ? 4 : 8 * k_sel <= kCap ? 2 : 1;
  err = walk<false>(work, qp, np, ks, n_valid, bins, every, tb, stream);
  if (err != cudaSuccess) return err;
  bound_kernel<PACKED><<<rows_grid, 32 * kRowWarps, 0, stream>>>(
      work, tb, qp, bins, k_sel, blk_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = walk<true>(work, qp, np, ks, n_valid, bins, 1, tb, stream);
  if (err != cudaSuccess) return err;
  final_kernel<PACKED><<<rows_grid, 32 * kRowWarps, 0, stream>>>(
      qa, xa, work, acc, acc_i, qp, d_aug, n_valid, bins, np / bins, k_sel,
      blk_bits, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the work buffer that knn_select_launch takes for these shapes.
int knn_select_work_floats(int qp, int np, int d) {
  return (int)work_floats(qp, np, (d + 7) / 8);
}

// qa (qp, d_aug) and xa (np, d_aug) f32 row-major, d_aug % 4 == 0,
// np % bins == 0 and np / bins < 65536, in the layout of
// ops/knn_select.py _augment: columns [0, d) hold the cross term's
// operands, xa[:, d] == 1, a pair's tail terms sum to qa[d] + xa[d+1]
// (qa[d+1] == 1 wherever xa[d+1] != 0), and later columns are zero.
// work: knn_select_work_floats(qp, np, d) f32. Scratch: acc (qp, 2*bins)
// of 4-byte entries and acc_i (qp, 2*bins) i32 (unpacked only). Outputs
// out_d (qp, k_sel) f32 and out_i (qp, k_sel) i32. Launches the
// preparation, the two walks, the bound and the final pass on `stream`
// without synchronising; returns cudaGetLastError().
int knn_select_launch(const void* qa, const void* xa, int qp, int np,
                      int d_aug, int d, int n_valid, int bins, int k_sel,
                      int packed, int blk_bits, void* work, void* acc,
                      void* acc_i, void* out_d, void* out_i, void* stream) {
  if (qp <= 0 || np <= 0 || bins <= 0 || np % bins || d_aug % 4 ||
      d <= 0 || d >= d_aug || k_sel <= 0 || np / bins > 0xffff) {
    return (int)cudaErrorInvalidValue;
  }
  const float* q = static_cast<const float*>(qa);
  const float* x = static_cast<const float*>(xa);
  float* w = static_cast<float*>(work);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  int* a = static_cast<int*>(acc);
  int* ai = static_cast<int*>(acc_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      packed ? launch<true>(q, x, w, qp, np, d_aug, d, n_valid, bins, k_sel,
                            blk_bits, a, ai, od, oi, s)
             : launch<false>(q, x, w, qp, np, d_aug, d, n_valid, bins, k_sel,
                             blk_bits, a, ai, od, oi, s);
  return (int)err;
}

const char* knn_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
