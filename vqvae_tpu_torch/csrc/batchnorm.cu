// Training-mode batch normalization with flax's statistics for Hopper
// (sm_90a): the VAE's BatchNorm (models/vae.py) as two kernels forward and
// two backward.
//
// Replaces no TPU kernel: the JAX package leaves flax's nn.BatchNorm to XLA,
// which fuses the statistics, the normalization and its gradient. The plain
// version (ops/batchnorm.py batch_norm_train_reference) is a chain of about
// 55 small torch ops a norm and a training step (float64 casts, products,
// channel sums, the per-channel arithmetic), which moves about 204 bytes an
// element. These kernels keep the same float64 arithmetic in registers and
// move float32 alone:
//
//   bn_stats  x -> per-channel sum x, sum x^2 (float64) and the count
//   (the caller sums those 2C + 1 numbers over the mesh's ranks)
//   bn_apply  y = (bias - mean * mul) + x * mul, mul = rsqrt(var + eps) *
//             scale, with flax's fast variance max(E[x^2] - mean^2, 0); the
//             running statistics m * running + (1 - m) * batch in float32,
//             num_batches_tracked + 1; mean and rsqrt(var + eps) saved
//   bn_grad_sums   dy, x -> per-channel sum dy, sum dy * xhat (float64),
//             xhat = (x - mean) * inv, and their float32 roundings: the
//             shift's and the scale's gradients
//   (the caller sums the float64 sums over the mesh's ranks)
//   bn_grad_input  dx = mul * dy - mul * E[dy] - xhat * mul * E[dy * xhat]
//
// Each float64 result is rounded once to float32, as in the plain version;
// products and sums are written with round-to-nearest intrinsics, so the
// compiler fuses none of them and each rounds as the plain version's torch
// op does. Only the order of the float64 sums differs.
//
// Bound: bytes. x is read twice and y written forward, x and dy read twice
// and dx written backward: 32 bytes an element, 0.39 GB at the FashionMNIST
// step's 12.16 M norm elements, 0.116 ms at 3.35 TB/s; the largest input
// (256 x 64 x 16 x 16, 16.8 MB) fits in the 50 MB L2, where the second read
// usually finds it. The float64 work, a few operations an element, is far
// under the card's float64 rate.
//
// Layouts: NCHW-contiguous and channels-last (the encoder's convolutions of
// an NHWC input hand over the latter), each read in place; y takes x's
// layout and dx dy's. Grid, for the layout that drives a kernel (x forward,
// dy backward):
//   channels-last: blocks of 32 channels (one warp reads 32 neighbouring
//     floats of a row) x 8 rows, grid (channel tiles, parts); a block walks
//     its part of the N*H*W rows;
//   NCHW: blocks of 256 threads over one channel's N*H*W values, grid
//     (channels, parts).
// The wrapper picks parts so that the grid is a few waves of the card's
// SMs (the smallest norm, 256 x 256 x 4 x 4, still fills 132).
//
// Reductions are deterministic, with no floating-point atomics: each block
// sums its values in a fixed order (each thread in order, then a fixed tree
// over the block) and writes one partial per channel; the last block of a
// column to arrive (an integer ticket) sums the column's partials in part
// order and resets its ticket to 0 for the next launch on the stream. So a
// launch repeats itself bit for bit on a card. Offsets are 32-bit (the
// wrapper checks numel < 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                 // channels of a channels-last block
constexpr int kLanes = kThreads / kTile;  // its rows in flight

struct Dims {
  int n, c, s;  // batch, channels, H*W
  int parts;    // blocks along N*H*W (grid.y)
};

// Offset of (n, c, s) in a tensor of the other layout than the driving one
// (cl: channels-last).
__device__ __forceinline__ int other_offset(bool cl, const Dims& d, int n,
                                            int c, int s) {
  return cl ? (n * d.s + s) * d.c + c : (n * d.c + c) * d.s + s;
}

// This thread's channel: its lane of the block's tile (channels-last), or
// the block's channel (NCHW); may be >= C in the last tile.
template <bool CL>
__device__ __forceinline__ int channel() {
  return CL ? blockIdx.x * kTile + threadIdx.x : blockIdx.x;
}

// f(od, oo) for each element of this thread: od its offset in the driving
// layout CL, oo in the other tensor's layout OCL.
template <bool CL, bool OCL, typename F>
__device__ __forceinline__ void visit(const Dims& d, F& f) {
  const int c = channel<CL>();
  if (c >= d.c) return;
  const int m = d.n * d.s;  // rows (channels-last) or values of a channel
  const int lo = (int)((int64_t)m * blockIdx.y / d.parts);
  const int hi = (int)((int64_t)m * (blockIdx.y + 1) / d.parts);
  if (CL) {
#pragma unroll 4
    for (int r = lo + threadIdx.y; r < hi; r += kLanes) {
      const int od = r * d.c + c;
      int oo = od;
      if (CL != OCL) {
        const int n = r / d.s;
        oo = other_offset(OCL, d, n, c, r - n * d.s);
      }
      f(od, oo);
    }
  } else {
    int j = lo + threadIdx.x;
    int n = j / d.s, s = j - n * d.s;
    const int dn = kThreads / d.s, ds = kThreads - dn * d.s;
#pragma unroll 4
    for (; j < hi; j += kThreads) {
      const int od = (n * d.c + c) * d.s + s;
      f(od, CL == OCL ? od : other_offset(OCL, d, n, c, s));
      n += dn;
      s += ds;
      if (s >= d.s) {
        s -= d.s;
        ++n;
      }
    }
  }
}

// The block's sum of each thread's (a, b) per channel, in a fixed order:
// valid in the threads of row 0 (channels-last) or thread 0 (NCHW).
template <bool CL>
__device__ __forceinline__ void block_sum(double& a, double& b) {
  __shared__ double red[2][kThreads];
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (CL) {
    red[0][t] = a;
    red[1][t] = b;
    __syncthreads();
    if (threadIdx.y == 0) {
      for (int l = 1; l < kLanes; ++l) {
        a = __dadd_rn(a, red[0][l * kTile + threadIdx.x]);
        b = __dadd_rn(b, red[1][l * kTile + threadIdx.x]);
      }
    }
  } else {
    for (int off = 16; off > 0; off >>= 1) {
      a = __dadd_rn(a, __shfl_down_sync(0xffffffffu, a, off));
      b = __dadd_rn(b, __shfl_down_sync(0xffffffffu, b, off));
    }
    if (t % 32 == 0) {
      red[0][t / 32] = a;
      red[1][t / 32] = b;
    }
    __syncthreads();
    if (t == 0) {
      for (int w = 1; w < kThreads / 32; ++w) {
        a = __dadd_rn(a, red[0][w]);
        b = __dadd_rn(b, red[1][w]);
      }
    }
  }
  __syncthreads();  // red is reused
}

// Whether this thread holds a block sum (block_sum's owner of a channel).
template <bool CL>
__device__ __forceinline__ bool owner() {
  return CL ? threadIdx.y == 0 : threadIdx.x == 0;
}

// Sums (a, b) per channel over the grid: each block writes its partials
// (partial[part][0..C) and [C..2C)), and the last block of the column sums
// them in part order and calls fin(c, a, b) in the owner threads. Returns
// nothing to the other blocks.
template <bool CL, typename Fin>
__device__ __forceinline__ void grid_sum(double a, double b, const Dims& d,
                                         double* partial, unsigned* tickets,
                                         Fin& fin) {
  __shared__ bool last;
  const int c = channel<CL>();
  block_sum<CL>(a, b);
  double* mine = partial + (size_t)blockIdx.y * 2 * d.c;
  if (owner<CL>() && c < d.c) {
    mine[c] = a;
    mine[d.c + c] = b;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    last = atomicAdd(&tickets[blockIdx.x], 1u) == (unsigned)d.parts - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  a = 0.0;
  b = 0.0;
  if (c < d.c) {
    const int first = CL ? threadIdx.y : threadIdx.x;
    const int step = CL ? kLanes : kThreads;
    for (int p = first; p < d.parts; p += step) {
      const double* part = partial + (size_t)p * 2 * d.c;
      a = __dadd_rn(a, __ldcg(part + c));
      b = __dadd_rn(b, __ldcg(part + d.c + c));
    }
  }
  block_sum<CL>(a, b);
  if (owner<CL>() && c < d.c) fin(c, a, b);
  if (threadIdx.x == 0 && threadIdx.y == 0) tickets[blockIdx.x] = 0u;
}

// ---- forward --------------------------------------------------------------

struct StatsSum {
  const float* x;
  double a = 0.0, b = 0.0;
  __device__ void operator()(int od, int) {
    const double v = x[od];
    a = __dadd_rn(a, v);
    b = __dadd_rn(b, __dmul_rn(v, v));  // exact: a float32 squared
  }
};

struct StatsOut {
  double* stats;
  int c;
  __device__ void operator()(int ch, double a, double b) {
    stats[ch] = a;
    stats[c + ch] = b;
  }
};

template <bool CL>
__global__ void __launch_bounds__(kThreads)
    bn_stats(const float* __restrict__ x, Dims d, double* partial,
             unsigned* tickets, double* stats) {
  StatsSum acc{x};
  visit<CL, CL>(d, acc);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&
      threadIdx.y == 0) {
    stats[2 * d.c] = (double)d.n * d.s;
  }
  StatsOut out{stats, d.c};
  grid_sum<CL>(acc.a, acc.b, d, partial, tickets, out);
}

// torch.clamp_min(v, lo): NaN stays NaN (fmax would drop it)
__device__ __forceinline__ double clamp_min(double v, double lo) {
  return v < lo ? lo : v;
}

// The count of the (all-reduced) stats, as the plain version: max(count, 1)
__device__ __forceinline__ double count_of(const double* stats, int C) {
  return clamp_min(stats[2 * C], 1.0);
}

// mean, var = max(E[x^2] - mean^2, 0) and inv = rsqrt(var + eps) of
// channel c from the (all-reduced) stats, as the plain version
__device__ __forceinline__ void mean_inv(const double* stats, int C, int c,
                                         double eps, double& mean,
                                         double& inv, double& var) {
  const double n = count_of(stats, C);
  mean = __ddiv_rn(stats[c], n);
  var = clamp_min(
      __dsub_rn(__ddiv_rn(stats[C + c], n), __dmul_rn(mean, mean)), 0.0);
  inv = __drcp_rn(__dsqrt_rn(__dadd_rn(var, eps)));
}

struct Apply {
  const float* x;
  float* y;
  double shift, mul;
  __device__ void operator()(int od, int) {
    y[od] = __double2float_rn(__dadd_rn(shift, __dmul_rn((double)x[od], mul)));
  }
};

template <bool CL>
__global__ void __launch_bounds__(kThreads)
    bn_apply(const float* __restrict__ x, float* __restrict__ y, Dims d,
             const double* __restrict__ stats, const float* weight,
             const float* bias, double eps, float keep, float take,
             float* running_mean, float* running_var, long long* tracked,
             double* saved) {
  const int c = channel<CL>();
  if (c >= d.c) return;
  double mean, inv, var;
  mean_inv(stats, d.c, c, eps, mean, inv, var);
  const double mul = __dmul_rn(inv, (double)weight[c]);
  Apply f{x, y, __dsub_rn((double)bias[c], __dmul_rn(mean, mul)), mul};
  if (blockIdx.y == 0 && owner<CL>()) {
    // float32, as m * running + (1 - m) * batch on float32 tensors
    running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]),
                                __fmul_rn(take, __double2float_rn(mean)));
    running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]),
                               __fmul_rn(take, __double2float_rn(var)));
    saved[c] = mean;
    saved[d.c + c] = inv;
    if (c == 0) *tracked += 1;
  }
  visit<CL, CL>(d, f);
}

// ---- backward -------------------------------------------------------------

// xhat = (-mean * inv) + x * inv, as the plain version's addcmul
struct Xhat {
  const float* x;
  double shift, inv;
  __device__ __forceinline__ double at(int o) const {
    return __dadd_rn(shift, __dmul_rn((double)x[o], inv));
  }
};

struct GradSum {
  const float* dy;
  Xhat xh;
  double a = 0.0, b = 0.0;
  __device__ void operator()(int od, int oo) {
    const double g = dy[od];
    a = __dadd_rn(a, g);
    b = __dadd_rn(b, __dmul_rn(g, xh.at(oo)));
  }
};

struct GradOut {
  double* local;
  float* dweight;
  float* dbias;
  int c;
  __device__ void operator()(int ch, double a, double b) {
    local[ch] = a;
    local[c + ch] = b;
    dbias[ch] = __double2float_rn(a);
    dweight[ch] = __double2float_rn(b);
  }
};

__device__ __forceinline__ Xhat xhat_of(const float* x, const double* saved,
                                        int C, int c) {
  const double inv = saved[C + c];
  return Xhat{x, __dmul_rn(-saved[c], inv), inv};
}

template <bool CL, bool XCL>
__global__ void __launch_bounds__(kThreads)
    bn_grad_sums(const float* __restrict__ dy, const float* __restrict__ x,
                 Dims d, const double* __restrict__ saved, double* partial,
                 unsigned* tickets, double* local, float* dweight,
                 float* dbias) {
  const int c = channel<CL>();
  Xhat xh{x, 0.0, 0.0};  // a thread past the last channel reads nothing
  if (c < d.c) xh = xhat_of(x, saved, d.c, c);
  GradSum acc{dy, xh};
  visit<CL, XCL>(d, acc);
  GradOut out{local, dweight, dbias, d.c};
  grid_sum<CL>(acc.a, acc.b, d, partial, tickets, out);
}

struct GradInput {
  const float* dy;
  float* dx;
  Xhat xh;
  double mul, shift, slope;
  __device__ void operator()(int od, int oo) {
    const double t = __dadd_rn(shift, __dmul_rn((double)dy[od], mul));
    dx[od] = __double2float_rn(__dadd_rn(t, __dmul_rn(xh.at(oo), slope)));
  }
};

template <bool CL, bool XCL>
__global__ void __launch_bounds__(kThreads)
    bn_grad_input(const float* __restrict__ dy, const float* __restrict__ x,
                  float* __restrict__ dx, Dims d,
                  const double* __restrict__ stats,
                  const double* __restrict__ total,
                  const double* __restrict__ saved, const float* weight) {
  const int c = channel<CL>();
  if (c >= d.c) return;
  const double n = count_of(stats, d.c);
  const double mul = __dmul_rn((double)weight[c], saved[d.c + c]);
  GradInput f{dy, dx, xhat_of(x, saved, d.c, c), mul,
              __dmul_rn(-mul, __ddiv_rn(total[c], n)),
              __dmul_rn(-mul, __ddiv_rn(total[d.c + c], n))};
  visit<CL, XCL>(d, f);
}

dim3 grid_of(const Dims& d, bool cl) {
  return dim3(cl ? (d.c + kTile - 1) / kTile : d.c, d.parts);
}

dim3 block_of(bool cl) { return cl ? dim3(kTile, kLanes) : dim3(kThreads); }

bool valid(int n, int c, int s, int parts) {
  return n > 0 && c > 0 && s > 0 && parts > 0 && parts <= 65535 &&
         (int64_t)n * c * s < ((int64_t)1 << 31);
}

}  // namespace

extern "C" {

// x (n, c, s = H*W) float32, NCHW-contiguous (cl = 0) or channels-last
// (cl = 1); partial (parts, 2c) float64 scratch; tickets: one unsigned per
// column of the grid (ceil(c / 32) channels-last, c NCHW), 0 on entry and
// left 0; stats (2c + 1) float64: sum x, sum x^2, then n * s. Launches on
// `stream` without synchronising; returns cudaGetLastError().
int bn_forward_stats(const void* x, int n, int c, int s, int cl, int parts,
                     void* partial, void* tickets, void* stats,
                     void* stream) {
  if (!valid(n, c, s, parts)) return (int)cudaErrorInvalidValue;
  const Dims d{n, c, s, parts};
  const float* xf = static_cast<const float*>(x);
  double* pp = static_cast<double*>(partial);
  unsigned* tk = static_cast<unsigned*>(tickets);
  double* st = static_cast<double*>(stats);
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (cl) {
    bn_stats<true><<<grid_of(d, true), block_of(true), 0, st_>>>(xf, d, pp,
                                                                tk, st);
  } else {
    bn_stats<false><<<grid_of(d, false), block_of(false), 0, st_>>>(
        xf, d, pp, tk, st);
  }
  return (int)cudaGetLastError();
}

// y (x's shape and layout) from x and the all-reduced stats; weight, bias,
// running_mean, running_var (c,) float32; tracked one int64; saved (2c)
// float64 receives mean and rsqrt(var + eps); keep = m and take = 1 - m as
// float32 (flax's momentum m).
int bn_forward_apply(const void* x, void* y, int n, int c, int s, int cl,
                     int parts, const void* stats, const void* weight,
                     const void* bias, double eps, float keep, float take,
                     void* running_mean, void* running_var, void* tracked,
                     void* saved, void* stream) {
  if (!valid(n, c, s, parts)) return (int)cudaErrorInvalidValue;
  const Dims d{n, c, s, parts};
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
#define BN_APPLY_ARGS                                                       \
  static_cast<const float*>(x), static_cast<float*>(y), d,                  \
      static_cast<const double*>(stats), static_cast<const float*>(weight), \
      static_cast<const float*>(bias), eps, keep, take,                     \
      static_cast<float*>(running_mean), static_cast<float*>(running_var),  \
      static_cast<long long*>(tracked), static_cast<double*>(saved)
  if (cl) {
    bn_apply<true><<<grid_of(d, true), block_of(true), 0, st_>>>(
        BN_APPLY_ARGS);
  } else {
    bn_apply<false><<<grid_of(d, false), block_of(false), 0, st_>>>(
        BN_APPLY_ARGS);
  }
#undef BN_APPLY_ARGS
  return (int)cudaGetLastError();
}

// dy (n, c, s) float32 in its layout (dy_cl), x in its own (x_cl); saved
// from bn_forward_apply; partial, tickets as bn_forward_stats; local (2c)
// float64: this rank's sum dy and sum dy * xhat; dweight, dbias (c,)
// float32: their roundings.
int bn_backward_sums(const void* dy, const void* x, int n, int c, int s,
                     int dy_cl, int x_cl, int parts, const void* saved,
                     void* partial, void* tickets, void* local,
                     void* dweight, void* dbias, void* stream) {
  if (!valid(n, c, s, parts)) return (int)cudaErrorInvalidValue;
  const Dims d{n, c, s, parts};
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
#define BN_SUMS_ARGS                                                       \
  static_cast<const float*>(dy), static_cast<const float*>(x), d,          \
      static_cast<const double*>(saved), static_cast<double*>(partial),    \
      static_cast<unsigned*>(tickets), static_cast<double*>(local),        \
      static_cast<float*>(dweight), static_cast<float*>(dbias)
  const dim3 g = grid_of(d, dy_cl), b = block_of(dy_cl);
  if (dy_cl && x_cl) {
    bn_grad_sums<true, true><<<g, b, 0, st_>>>(BN_SUMS_ARGS);
  } else if (dy_cl) {
    bn_grad_sums<true, false><<<g, b, 0, st_>>>(BN_SUMS_ARGS);
  } else if (x_cl) {
    bn_grad_sums<false, true><<<g, b, 0, st_>>>(BN_SUMS_ARGS);
  } else {
    bn_grad_sums<false, false><<<g, b, 0, st_>>>(BN_SUMS_ARGS);
  }
#undef BN_SUMS_ARGS
  return (int)cudaGetLastError();
}

// dx (dy's shape and layout) from dy, x, stats (for the count), total (2c)
// float64: the all-reduced sums of bn_backward_sums, saved and weight.
int bn_backward_input(const void* dy, const void* x, void* dx, int n, int c,
                      int s, int dy_cl, int x_cl, int parts,
                      const void* stats, const void* total, const void* saved,
                      const void* weight, void* stream) {
  if (!valid(n, c, s, parts)) return (int)cudaErrorInvalidValue;
  const Dims d{n, c, s, parts};
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
#define BN_INPUT_ARGS                                                      \
  static_cast<const float*>(dy), static_cast<const float*>(x),             \
      static_cast<float*>(dx), d, static_cast<const double*>(stats),       \
      static_cast<const double*>(total), static_cast<const double*>(saved), \
      static_cast<const float*>(weight)
  const dim3 g = grid_of(d, dy_cl), b = block_of(dy_cl);
  if (dy_cl && x_cl) {
    bn_grad_input<true, true><<<g, b, 0, st_>>>(BN_INPUT_ARGS);
  } else if (dy_cl) {
    bn_grad_input<true, false><<<g, b, 0, st_>>>(BN_INPUT_ARGS);
  } else if (x_cl) {
    bn_grad_input<false, true><<<g, b, 0, st_>>>(BN_INPUT_ARGS);
  } else {
    bn_grad_input<false, false><<<g, b, 0, st_>>>(BN_INPUT_ARGS);
  }
#undef BN_INPUT_ARGS
  return (int)cudaGetLastError();
}

const char* bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
