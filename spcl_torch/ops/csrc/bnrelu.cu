// Fused BatchNorm + ReLU in train mode on float32 NCHW tensors.
//
// Replaces no TPU kernel: spcl_tpu leaves BatchNorm + ReLU to XLA, which
// fuses them into its convolutions' neighbours. On the H100 the port's plain
// path ran them as cuDNN's NCHW BatchNorm and two ReLU passes, far below the
// card's byte bound (`ops/bnrelu_cuda.py` has the numbers).
//
// What bounds it: bytes. Per channel the work is a handful of operations an
// element, so every pass is a read (and a write) of the activation at
// 3.35 TB/s. The four kernels make the eight passes the function needs:
//
//   bnrelu_fwd_stats   read x                  per-channel sum, sum of squares
//   bnrelu_fwd_apply   read x, write y         y = max((x - mean) * w + b, 0)
//   bnrelu_bwd_sums    read dy, x              sum dz, sum dz * xhat
//   bnrelu_bwd_apply   read dy, x, write dx    dx = w (dz - mean dz - xhat mean dz xhat)
//
// with w = weight * invstd, xhat = (x - mean) * invstd and dz = dy where the
// forward's pre-activation is > 0, else 0 (the ReLU mask is recomputed from
// x with the forward's own operations, so both kernels take the same mask).
//
// Design: a block owns a tile of one channel's N x HW elements (blockIdx.y
// is the channel), read as 16-byte float4 where HW % 4 == 0, with UNROLL
// loads in flight a thread. The reductions keep each thread's sum in
// float64 (3.0 M elements a channel at 60 x 224 x 224 keep float32
// accuracy); the block's sums go to a per-channel partials buffer and the
// last block of a channel to arrive (a ticket counter, left at zero after
// every launch, so CUDA graph replays find it zero) adds the partials in
// tile order, so that the result does not depend on the blocks' order. That
// block also derives the channel's statistics: mean and 1 / sqrt(var + eps)
// from the biased variance, the running mean and the running variance
// (Bessel's factor) of nn.BatchNorm2d with momentum, and
// num_batches_tracked. Products and sums of the apply passes round in the
// order the plain versions in `ops/bnrelu_cuda.py` compute them: no
// contraction into fused multiply-adds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

template <int V> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ void get(const T& t, float (&v)[4]) {
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ T make(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void get(const T& t, float (&v)[1]) { v[0] = t; }
  static __device__ __forceinline__ T make(const float (&v)[1]) { return v[0]; }
};

// The layout of one launch: a channel's units (float4 or float) are
// u = n * hwu + i; n = u / hwu by a multiply-high and a shift (m, s from the
// wrapper, exact for u < 2^31).
struct Geo {
  int C;
  unsigned hwu, units, tile, m, s;
};

__device__ __forceinline__ size_t unit_offset(const Geo& g, unsigned u, int c) {
  const unsigned n = (__umulhi(g.m, u) + u) >> g.s;
  const unsigned i = u - n * g.hwu;
  return ((size_t)n * g.C + c) * g.hwu + i;
}

__device__ __forceinline__ float pre_activation(float x, float mean, float w, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), w), b);
}

// Sums of a and b over the block, in a fixed order; thread 0 holds them.
__device__ __forceinline__ void block_sum2(double& a, double& b) {
  __shared__ double sa[NWARP], sb[NWARP];
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(FULL, a, o);
    b += __shfl_xor_sync(FULL, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.0;
    b = 0.0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      a += sa[w];
      b += sb[w];
    }
  }
  __syncthreads();
}

// The block's (a, b) into the channel's partials; in the last block of the
// channel to arrive, the channel's sums in tile order (thread 0 holds them)
// and true; false in every other block.
__device__ __forceinline__ bool channel_sums(double& a, double& b, double* __restrict__ part,
                                             unsigned* __restrict__ ticket, int c) {
  __shared__ int s_last;
  const unsigned tiles = gridDim.x;
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    double* p = part + ((size_t)c * tiles + blockIdx.x) * 2;
    p[0] = a;
    p[1] = b;
    __threadfence();
    s_last = atomicAdd(ticket + c, 1u) == tiles - 1;
  }
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  a = 0.0;
  b = 0.0;
  for (unsigned t = threadIdx.x; t < tiles; t += NT) {
    const double* p = part + ((size_t)c * tiles + t) * 2;
    a += __ldcg(p);
    b += __ldcg(p + 1);
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) ticket[c] = 0u;
  return true;
}

template <int V>
__global__ void __launch_bounds__(NT)
bnrelu_fwd_stats_kernel(const float* __restrict__ x, Geo g, double count,
                        double* __restrict__ part, unsigned* __restrict__ ticket,
                        float* __restrict__ stats, float* __restrict__ running_mean,
                        float* __restrict__ running_var, long long* __restrict__ tracked,
                        float keep, float momentum, double eps, int update) {
  using T = typename Vec<V>::T;
  const T* xv = reinterpret_cast<const T*>(x);
  const int c = blockIdx.y;
  const unsigned u0 = blockIdx.x * g.tile, u1 = min(u0 + g.tile, g.units);
  double s = 0.0, q = 0.0;
  for (unsigned u = u0 + threadIdx.x; u < u1; u += NT * UNROLL) {
    T r[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      if (u + k * NT < u1) r[k] = __ldg(xv + unit_offset(g, u + k * NT, c));
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (u + k * NT < u1) {
        float v[V];
        Vec<V>::get(r[k], v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const double d = v[j];
          s += d;
          q += d * d;
        }
      }
    }
  }
  if (!channel_sums(s, q, part, ticket, c)) return;
  if (threadIdx.x != 0) return;
  const double mean = s / count;
  const double var = fmax(q / count - mean * mean, 0.0);
  const float mean_f = (float)mean;
  stats[c] = mean_f;
  stats[g.C + c] = (float)(1.0 / sqrt(var + eps));
  if (update) {
    const float unbiased = (float)(count > 1.0 ? var * (count / (count - 1.0)) : var);
    running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep), __fmul_rn(mean_f, momentum));
    running_var[c] = __fadd_rn(__fmul_rn(running_var[c], keep), __fmul_rn(unbiased, momentum));
    if (c == 0) *tracked += 1;
  }
}

template <int V>
__global__ void __launch_bounds__(NT)
bnrelu_fwd_apply_kernel(const float* __restrict__ x, Geo g, const float* __restrict__ stats,
                        const float* __restrict__ weight, const float* __restrict__ bias,
                        float* __restrict__ y) {
  using T = typename Vec<V>::T;
  const T* xv = reinterpret_cast<const T*>(x);
  T* yv = reinterpret_cast<T*>(y);
  const int c = blockIdx.y;
  const float mean = stats[c], w = __fmul_rn(weight[c], stats[g.C + c]), b = bias[c];
  const unsigned u0 = blockIdx.x * g.tile, u1 = min(u0 + g.tile, g.units);
  for (unsigned u = u0 + threadIdx.x; u < u1; u += NT * UNROLL) {
    T r[UNROLL];
    size_t off[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (u + k * NT < u1) {
        off[k] = unit_offset(g, u + k * NT, c);
        r[k] = __ldg(xv + off[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (u + k * NT < u1) {
        float v[V];
        Vec<V>::get(r[k], v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = pre_activation(v[j], mean, w, b);
          v[j] = t < 0.f ? 0.f : t;  // NaN passes, as torch.relu
        }
        yv[off[k]] = Vec<V>::make(v);
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(NT)
bnrelu_bwd_sums_kernel(const float* __restrict__ dy, const float* __restrict__ x, Geo g,
                       double count, const float* __restrict__ stats,
                       const float* __restrict__ weight, const float* __restrict__ bias,
                       double* __restrict__ part, unsigned* __restrict__ ticket,
                       float* __restrict__ bstats, float* __restrict__ dweight,
                       float* __restrict__ dbias) {
  using T = typename Vec<V>::T;
  const T* dv = reinterpret_cast<const T*>(dy);
  const T* xv = reinterpret_cast<const T*>(x);
  const int c = blockIdx.y;
  const float mean = stats[c], invstd = stats[g.C + c];
  const float w = __fmul_rn(weight[c], invstd), b = bias[c];
  const unsigned u0 = blockIdx.x * g.tile, u1 = min(u0 + g.tile, g.units);
  double s = 0.0, q = 0.0;
  for (unsigned u = u0 + threadIdx.x; u < u1; u += NT * UNROLL) {
    T rd[UNROLL], rx[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (u + k * NT < u1) {
        const size_t off = unit_offset(g, u + k * NT, c);
        rd[k] = __ldg(dv + off);
        rx[k] = __ldg(xv + off);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (u + k * NT < u1) {
        float d[V], v[V];
        Vec<V>::get(rd[k], d);
        Vec<V>::get(rx[k], v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float dz = pre_activation(v[j], mean, w, b) > 0.f ? d[j] : 0.f;
          const float xhat = __fmul_rn(__fsub_rn(v[j], mean), invstd);
          s += (double)dz;
          q += (double)dz * (double)xhat;
        }
      }
    }
  }
  if (!channel_sums(s, q, part, ticket, c)) return;
  if (threadIdx.x != 0) return;
  dbias[c] = (float)s;
  dweight[c] = (float)q;
  bstats[c] = (float)(s / count);
  bstats[g.C + c] = (float)(q / count);
}

template <int V>
__global__ void __launch_bounds__(NT)
bnrelu_bwd_apply_kernel(const float* __restrict__ dy, const float* __restrict__ x, Geo g,
                        const float* __restrict__ stats, const float* __restrict__ bstats,
                        const float* __restrict__ weight, const float* __restrict__ bias,
                        float* __restrict__ dx) {
  using T = typename Vec<V>::T;
  const T* dv = reinterpret_cast<const T*>(dy);
  const T* xv = reinterpret_cast<const T*>(x);
  T* ov = reinterpret_cast<T*>(dx);
  const int c = blockIdx.y;
  const float mean = stats[c], invstd = stats[g.C + c];
  const float w = __fmul_rn(weight[c], invstd), b = bias[c];
  const float mdz = bstats[c], mdzx = bstats[g.C + c];
  const unsigned u0 = blockIdx.x * g.tile, u1 = min(u0 + g.tile, g.units);
  for (unsigned u = u0 + threadIdx.x; u < u1; u += NT * UNROLL) {
    T rd[UNROLL], rx[UNROLL];
    size_t off[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (u + k * NT < u1) {
        off[k] = unit_offset(g, u + k * NT, c);
        rd[k] = __ldg(dv + off[k]);
        rx[k] = __ldg(xv + off[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (u + k * NT < u1) {
        float d[V], v[V];
        Vec<V>::get(rd[k], d);
        Vec<V>::get(rx[k], v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float dz = pre_activation(v[j], mean, w, b) > 0.f ? d[j] : 0.f;
          const float xhat = __fmul_rn(__fsub_rn(v[j], mean), invstd);
          d[j] = __fmul_rn(w, __fsub_rn(__fsub_rn(dz, mdz), __fmul_rn(xhat, mdzx)));
        }
        ov[off[k]] = Vec<V>::make(d);
      }
    }
  }
}

Geo make_geo(int C, unsigned hwu, unsigned units, unsigned tile, unsigned m, unsigned s) {
  Geo g;
  g.C = C;
  g.hwu = hwu;
  g.units = units;
  g.tile = tile;
  g.m = m;
  g.s = s;
  return g;
}

dim3 grid_of(unsigned tiles, int C) { return dim3(tiles, (unsigned)C); }

}  // namespace

extern "C" {

int bnrelu_threads() { return NT; }

// `stats` float32 [2, C]: mean, 1 / sqrt(var + eps); `part` float64
// [C, tiles, 2] scratch; `ticket` C unsigned counters, zero before and after.
int bnrelu_fwd_stats(const float* x, int vec, int C, unsigned hwu, unsigned units,
                     unsigned tile, unsigned tiles, unsigned m, unsigned s, double count,
                     double* part, unsigned* ticket, float* stats, float* running_mean,
                     float* running_var, long long* tracked, float keep, float momentum,
                     double eps, int update, cudaStream_t stream) {
  const Geo g = make_geo(C, hwu, units, tile, m, s);
  if (vec)
    bnrelu_fwd_stats_kernel<4><<<grid_of(tiles, C), NT, 0, stream>>>(
        x, g, count, part, ticket, stats, running_mean, running_var, tracked, keep, momentum,
        eps, update);
  else
    bnrelu_fwd_stats_kernel<1><<<grid_of(tiles, C), NT, 0, stream>>>(
        x, g, count, part, ticket, stats, running_mean, running_var, tracked, keep, momentum,
        eps, update);
  return (int)cudaGetLastError();
}

int bnrelu_fwd_apply(const float* x, int vec, int C, unsigned hwu, unsigned units,
                     unsigned tile, unsigned tiles, unsigned m, unsigned s, const float* stats,
                     const float* weight, const float* bias, float* y, cudaStream_t stream) {
  const Geo g = make_geo(C, hwu, units, tile, m, s);
  if (vec)
    bnrelu_fwd_apply_kernel<4><<<grid_of(tiles, C), NT, 0, stream>>>(x, g, stats, weight,
                                                                     bias, y);
  else
    bnrelu_fwd_apply_kernel<1><<<grid_of(tiles, C), NT, 0, stream>>>(x, g, stats, weight,
                                                                     bias, y);
  return (int)cudaGetLastError();
}

// `bstats` float32 [2, C]: mean dz, mean dz * xhat; dweight, dbias [C].
int bnrelu_bwd_sums(const float* dy, const float* x, int vec, int C, unsigned hwu,
                    unsigned units, unsigned tile, unsigned tiles, unsigned m, unsigned s,
                    double count, const float* stats, const float* weight, const float* bias,
                    double* part, unsigned* ticket, float* bstats, float* dweight, float* dbias,
                    cudaStream_t stream) {
  const Geo g = make_geo(C, hwu, units, tile, m, s);
  if (vec)
    bnrelu_bwd_sums_kernel<4><<<grid_of(tiles, C), NT, 0, stream>>>(
        dy, x, g, count, stats, weight, bias, part, ticket, bstats, dweight, dbias);
  else
    bnrelu_bwd_sums_kernel<1><<<grid_of(tiles, C), NT, 0, stream>>>(
        dy, x, g, count, stats, weight, bias, part, ticket, bstats, dweight, dbias);
  return (int)cudaGetLastError();
}

int bnrelu_bwd_apply(const float* dy, const float* x, int vec, int C, unsigned hwu,
                     unsigned units, unsigned tile, unsigned tiles, unsigned m, unsigned s,
                     const float* stats, const float* bstats, const float* weight,
                     const float* bias, float* dx, cudaStream_t stream) {
  const Geo g = make_geo(C, hwu, units, tile, m, s);
  if (vec)
    bnrelu_bwd_apply_kernel<4><<<grid_of(tiles, C), NT, 0, stream>>>(dy, x, g, stats, bstats,
                                                                     weight, bias, dx);
  else
    bnrelu_bwd_apply_kernel<1><<<grid_of(tiles, C), NT, 0, stream>>>(dy, x, g, stats, bstats,
                                                                     weight, bias, dx);
  return (int)cudaGetLastError();
}

}  // extern "C"
