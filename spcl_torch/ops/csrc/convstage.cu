// Fused small-channel encoder stage (conv3x3 -> BN -> ReLU -> conv3x3 -> BN ->
// ReLU -> 2x2 max-pool) with its backward, CUDA C++ for Hopper (sm_90a), plain
// C interface for ctypes. Tensors are channels-last float32 [B, H, W, C] with
// C in {16, 32}; convolution weights are [3, 3, Ci, Co].
//
// Replaces the seven Pallas TPU kernel bodies that run through `_pc`
// (spcl_tpu/experimental/packed_block_pallas.py:595), one C function each:
//   convstage_conv      <- _k_conv     (:245)  z0 = conv(x, w0); sum z0, sum z0^2
//   convstage_bnconv    <- _k_bnconv   (:283)  z1 = conv(relu(z0*inv0+shift0), w1); sums
//   convstage_bnpool    <- _k_bnpool   (:315)  e = relu(z1*inv1+shift1); p = maxpool2x2(e)
//   convstage_poolsums  <- _k_poolsums (:346)  dy1 = (poolbwd(dp)+de)*[y1>=0]; sum dy1, sum dy1*z1
//   convstage_dz1       <- _k_dz1      (:374)  dz1 = c0*dy1 + c1 + c2*z1
//   convstage_dwprev    <- _k_dwprev   (:412)  dW1 = sum a0^T dz1; dy0 = conv1^T(dz1)*[y0>=0]; sums
//   convstage_dwdx      <- _k_dwdx     (:471)  dz0 = c0*dy0+c1+c2*z0; dW0 = sum x^T dz0; dx = conv0^T(dz0)
// The per-channel coefficient arithmetic between the passes stays outside,
// as it does on the TPU.
//
// Design. The TPU kernels pack W*C into 128 lanes and turn each convolution
// into nine banded 128x128 matmuls for the matrix unit; none of that is kept.
// Here a convolution is direct: a block of 256 threads takes a 16x16 pixel
// tile, stages the tile with its one-pixel halo (BN and ReLU applied while
// loading, zeros outside the image) and the whole weight tensor (at most
// 36 KB) in shared memory, and each thread computes every output channel of
// one pixel in registers. Results go back through shared memory so that global
// stores are whole 64/128-byte pixel rows. The backward kernels use the
// identity dW[u,v] = sum_p a[p] (x) g[p-(u-1,v-1)] so that only the gradient
// tile needs a halo; each thread owns a few (ci, co) pairs of all nine taps
// and slides a 3x3 register window of g along the tile rows, keeping its dW
// accumulators in registers across all tiles of the block. The pool passes
// are elementwise over 2x2 windows; the backward routes dp to the FIRST
// maximum in scan order (r0,c0),(r0,c1),(r1,c0),(r1,c1).
//
// Reductions across blocks. The TPU grid is sequential and carries its sums
// in scratch; Hopper blocks run in no order. Chosen here: no atomics. Every
// block walks a fixed set of tiles (tile t goes to block t mod gridDim), sums
// in a fixed order, and writes its partial to a workspace; a second small
// kernel (`reduce_kernel`) adds the partials in block order in float64. Two
// runs on the same inputs give the same bits. BN statistics are accumulated
// per block in float64 (the H100 runs float64 adds at half the float32 rate),
// so E[z^2] - E[z]^2 over millions of elements keeps its digits.
//
// Arithmetic kept from the TPU kernels: BN applied as z*inv + shift (product
// and sum rounded separately, see bn_apply); ReLU mask y >= 0 in the backward;
// BN backward as c0*dy + c1 + c2*z; float32 FMA in the convolutions (no TF32,
// no tensor cores).
//
// Bound on the H100. Each pass must read and write its stage tensors once
// (193 MB each at 60x224x224x16), which at 3.35 TB/s is 0.06-0.25 ms per
// pass; the convolutions need 2*9*Ci*Co FLOPs per pixel, 13.9 GFLOP for the
// 16->16 convolution at 224^2, which at the float32 peak of 67 TFLOP/s is
// 0.21 ms. The forward passes are close to balanced between the two; the
// backward conv passes (two products) are bound by operations. This simple
// version issues one shared-memory load per 4 FMAs (weights are re-read for
// every pixel), so it runs well below the float32 peak: measured on an H100
// 80GB HBM3 at 700 W by chip_smoke.py, the convolution passes take 2.7-3.4x
// their bound and the elementwise pool passes 1.2-2.2x (PERF.md has the
// table). Tensor cores (wgmma on TF32/bf16 tiles) and TMA loads are the
// later step.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;                 // tile height (pixels)
constexpr int TW = 16;                 // tile width
constexpr int NT = TH * TW;            // threads per block, one per tile pixel
constexpr int HALO_W = TW + 2;
constexpr int HALO_N = (TH + 2) * (TW + 2);
constexpr int PAD = 4;                 // floats of padding per shared-memory pixel row

// z*inv + shift with two roundings (no contraction into one FMA), the same
// bits as the plain PyTorch version's mul and add, so that both take the same
// ReLU masks and pool maxima from the same inputs.
__device__ __forceinline__ float bn_apply(float z, float inv, float shift) {
  return __fadd_rn(__fmul_rn(z, inv), shift);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Fixed-order block reduction of per-thread float64 channel sums. Thread
// `tid` holds the sums of channel tid % C over its own pixels; NT / C threads
// share a channel. Writes partial[block][which][c].
template <int C>
__device__ __forceinline__ void write_channel_partials(double a0, double a1,
                                                       double* __restrict__ partial) {
  __shared__ double s_red[2 * NT];
  const int tid = threadIdx.x;
  s_red[tid] = a0;
  s_red[NT + tid] = a1;
  __syncthreads();
  if (tid < C) {
    double r0 = 0.0, r1 = 0.0;
    for (int g = 0; g < NT / C; ++g) {
      r0 += s_red[g * C + tid];
      r1 += s_red[NT + g * C + tid];
    }
    partial[((size_t)blockIdx.x * 2 + 0) * C + tid] = r0;
    partial[((size_t)blockIdx.x * 2 + 1) * C + tid] = r1;
  }
}

// ------------------------------------------------------------------ forward conv
// out = conv3x3(act(in), w), zero padding 1, plus per-block partial sums of
// out and out^2 per channel. act = relu(in*inv+shift) when BN_IN, else identity.
template <int CI, int CO, bool BN_IN>
__global__ void __launch_bounds__(NT)
conv_fwd_kernel(const float* __restrict__ in, const float* __restrict__ coef,
                const float* __restrict__ w, float* __restrict__ out,
                double* __restrict__ partial, int B, int H, int W) {
  constexpr int SI = CI + PAD;
  constexpr int SO = CO + PAD;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                    // [9][CI][CO]
  float* s_buf = smem + 9 * CI * CO;    // input halo tile [HALO_N][SI], then output tile [NT][SO]
  __shared__ float s_coef[2 * CI];

  const int tid = threadIdx.x;
  for (int i = tid; i < 9 * CI * CO; i += NT) s_w[i] = w[i];
  if constexpr (BN_IN) {
    for (int i = tid; i < 2 * CI; i += NT) s_coef[i] = coef[i];
  }
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  const int py = tid / TW, px = tid % TW;
  const int rc = tid % CO, rg = tid / CO;
  constexpr int NG = NT / CO;
  double tot0 = 0.0, tot1 = 0.0;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / (tiles_y * tiles_x);
    const int r = t % (tiles_y * tiles_x);
    const int y0 = (r / tiles_x) * TH, x0 = (r % tiles_x) * TW;
    __syncthreads();  // the previous tile's readers of s_buf are done
    for (int i = tid; i < HALO_N * (CI / 4); i += NT) {
      const int c4 = i % (CI / 4), hp = i / (CI / 4);
      const int gy = y0 + hp / HALO_W - 1, gx = x0 + hp % HALO_W - 1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = ld4(in + (((size_t)b * H + gy) * W + gx) * CI + c4 * 4);
        if constexpr (BN_IN) {
          const float* iv = s_coef + c4 * 4;
          const float* sh = s_coef + CI + c4 * 4;
          v.x = fmaxf(bn_apply(v.x, iv[0], sh[0]), 0.f);
          v.y = fmaxf(bn_apply(v.y, iv[1], sh[1]), 0.f);
          v.z = fmaxf(bn_apply(v.z, iv[2], sh[2]), 0.f);
          v.w = fmaxf(bn_apply(v.w, iv[3], sh[3]), 0.f);
        }
      }
      st4(s_buf + hp * SI + c4 * 4, v);
    }
    __syncthreads();

    float acc[CO];
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[o] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int u = tap / 3, v = tap % 3;
      const float* ip = s_buf + ((py + u) * HALO_W + (px + v)) * SI;
      const float* wp = s_w + tap * CI * CO;
#pragma unroll
      for (int c4 = 0; c4 < CI / 4; ++c4) {
        const float4 a4 = ld4(ip + c4 * 4);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int o4 = 0; o4 < CO / 4; ++o4) {
            const float4 ww = ld4(wp + (c4 * 4 + k) * CO + o4 * 4);
            acc[o4 * 4 + 0] = fmaf(av[k], ww.x, acc[o4 * 4 + 0]);
            acc[o4 * 4 + 1] = fmaf(av[k], ww.y, acc[o4 * 4 + 1]);
            acc[o4 * 4 + 2] = fmaf(av[k], ww.z, acc[o4 * 4 + 2]);
            acc[o4 * 4 + 3] = fmaf(av[k], ww.w, acc[o4 * 4 + 3]);
          }
        }
      }
    }
    __syncthreads();  // every read of the input tile is done; reuse it for the output
    const bool inside = (y0 + py < H) && (x0 + px < W);
#pragma unroll
    for (int o4 = 0; o4 < CO / 4; ++o4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (inside) v = make_float4(acc[o4 * 4], acc[o4 * 4 + 1], acc[o4 * 4 + 2], acc[o4 * 4 + 3]);
      st4(s_buf + tid * SO + o4 * 4, v);
    }
    __syncthreads();
    for (int i = tid; i < NT * (CO / 4); i += NT) {
      const int c4 = i % (CO / 4), p = i / (CO / 4);
      const int gy = y0 + p / TW, gx = x0 + p % TW;
      if (gy < H && gx < W)
        st4(out + (((size_t)b * H + gy) * W + gx) * CO + c4 * 4, ld4(s_buf + p * SO + c4 * 4));
    }
    float s0 = 0.f, s1 = 0.f;  // pixels outside the image hold zeros
    for (int p = rg; p < NT; p += NG) {
      const float z = s_buf[p * SO + rc];
      s0 += z;
      s1 = fmaf(z, z, s1);
    }
    tot0 += (double)s0;
    tot1 += (double)s1;
  }
  write_channel_partials<CO>(tot0, tot1, partial);
}

// ------------------------------------------------------------------ backward conv
// For a forward z = conv3x3(a, w) with a [.., CI], z [.., CO], given g = dz:
//   d_in[p, ci]      = sum_{u,v,co} g[p-(u-1,v-1), co] * w[u,v,ci,co]
//   dW[u,v,ci,co]    = sum_p a[p, ci] * g[p-(u-1,v-1), co]
// PREV (the dwprev pass, CI == CO): a = relu(zprev*inv+shift) recomputed,
//   g = g_src; d_in is masked by [y >= 0] and its sums with zprev are taken.
// !PREV (the dwdx pass): a = a_src, g = c0*g_src + c1 + c2*g_z inside the image.
template <int CI, int CO, bool PREV>
__global__ void __launch_bounds__(NT)
conv_bwd_kernel(const float* __restrict__ a_src, const float* __restrict__ a_coef,
                const float* __restrict__ g_src, const float* __restrict__ g_z,
                const float* __restrict__ g_coef, const float* __restrict__ w,
                float* __restrict__ d_in, float* __restrict__ dw_partial,
                double* __restrict__ sum_partial, int B, int H, int W) {
  constexpr int SA = CI + PAD;
  constexpr int SG = CO + PAD;
  constexpr int CPT = CI * CO / NT;     // consecutive co per thread in the dW phase
  constexpr int NCG = CO / CPT;
  static_assert(CPT >= 1 && CI * CO % NT == 0, "dW mapping needs CI*CO >= 256");
  static_assert(!PREV || CI == CO, "the dwprev pass has CI == CO");
  extern __shared__ __align__(16) float smem[];
  float* s_wt = smem;                        // [9][CO][CI] (transposed)
  float* s_g = s_wt + 9 * CI * CO;           // [HALO_N][SG]; later d_in * zprev [NT][SG]
  float* s_a = s_g + HALO_N * SG;            // [NT][SA]; later d_in [NT][SA]
  __shared__ float s_coef[3 * CO];

  const int tid = threadIdx.x;
  for (int i = tid; i < 9 * CI * CO; i += NT) {
    const int tap = i / (CI * CO), ci = (i / CO) % CI, co = i % CO;
    s_wt[(tap * CO + co) * CI + ci] = w[i];
  }
  if constexpr (PREV) {
    for (int i = tid; i < 2 * CI; i += NT) s_coef[i] = a_coef[i];
  } else {
    for (int i = tid; i < 3 * CO; i += NT) s_coef[i] = g_coef[i];
  }
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  const int py = tid / TW, px = tid % TW;
  const int ci_w = tid / NCG, co_w = (tid % NCG) * CPT;
  const int rc = tid % CI, rg = tid / CI;
  constexpr int NG = NT / CI;

  float dw[9][CPT];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int k = 0; k < CPT; ++k) dw[tap][k] = 0.f;
  double tot0 = 0.0, tot1 = 0.0;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / (tiles_y * tiles_x);
    const int r = t % (tiles_y * tiles_x);
    const int y0 = (r / tiles_x) * TH, x0 = (r % tiles_x) * TW;
    __syncthreads();  // the previous tile's readers of s_g / s_a are done
    for (int i = tid; i < HALO_N * (CO / 4); i += NT) {
      const int c4 = i % (CO / 4), hp = i / (CO / 4);
      const int gy = y0 + hp / HALO_W - 1, gx = x0 + hp % HALO_W - 1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t off = (((size_t)b * H + gy) * W + gx) * CO + c4 * 4;
        v = ld4(g_src + off);
        if constexpr (!PREV) {
          const float4 z = ld4(g_z + off);
          const float* k0 = s_coef + c4 * 4;
          const float* k1 = s_coef + CO + c4 * 4;
          const float* k2 = s_coef + 2 * CO + c4 * 4;
          v.x = fmaf(k0[0], v.x, fmaf(k2[0], z.x, k1[0]));
          v.y = fmaf(k0[1], v.y, fmaf(k2[1], z.y, k1[1]));
          v.z = fmaf(k0[2], v.z, fmaf(k2[2], z.z, k1[2]));
          v.w = fmaf(k0[3], v.w, fmaf(k2[3], z.w, k1[3]));
        }
      }
      st4(s_g + hp * SG + c4 * 4, v);
    }
    for (int i = tid; i < NT * (CI / 4); i += NT) {
      const int c4 = i % (CI / 4), p = i / (CI / 4);
      const int gy = y0 + p / TW, gx = x0 + p % TW;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy < H && gx < W) {
        v = ld4(a_src + (((size_t)b * H + gy) * W + gx) * CI + c4 * 4);
        if constexpr (PREV) {  // keep y before the ReLU: the mask needs its sign
          const float* iv = s_coef + c4 * 4;
          const float* sh = s_coef + CI + c4 * 4;
          v.x = bn_apply(v.x, iv[0], sh[0]);
          v.y = bn_apply(v.y, iv[1], sh[1]);
          v.z = bn_apply(v.z, iv[2], sh[2]);
          v.w = bn_apply(v.w, iv[3], sh[3]);
        }
      }
      st4(s_a + p * SA + c4 * 4, v);
    }
    __syncthreads();

    // ---- dW: thread (ci_w, co_w..co_w+CPT-1), all nine taps. For pixel
    // (y, x) tap (u, v) reads g at halo position (y+2-u, x+2-v).
#pragma unroll 1
    for (int y = 0; y < TH; ++y) {
      float win[3][3][CPT];
#pragma unroll
      for (int rr = 0; rr < 3; ++rr)
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          win[rr][1][k] = s_g[((y + rr) * HALO_W + 0) * SG + co_w + k];
          win[rr][2][k] = s_g[((y + rr) * HALO_W + 1) * SG + co_w + k];
        }
#pragma unroll
      for (int x = 0; x < TW; ++x) {
#pragma unroll
        for (int rr = 0; rr < 3; ++rr)
#pragma unroll
          for (int k = 0; k < CPT; ++k) {
            win[rr][0][k] = win[rr][1][k];
            win[rr][1][k] = win[rr][2][k];
            win[rr][2][k] = s_g[((y + rr) * HALO_W + x + 2) * SG + co_w + k];
          }
        float a = s_a[(y * TW + x) * SA + ci_w];
        if constexpr (PREV) a = fmaxf(a, 0.f);
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v)
#pragma unroll
            for (int k = 0; k < CPT; ++k)
              dw[u * 3 + v][k] = fmaf(a, win[2 - u][2 - v][k], dw[u * 3 + v][k]);
      }
    }

    // ---- d_in: thread = pixel (py, px), every input channel
    float acc[CI];
#pragma unroll
    for (int i = 0; i < CI; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int u = tap / 3, v = tap % 3;
      const float* gp = s_g + ((py + 2 - u) * HALO_W + (px + 2 - v)) * SG;
      const float* wp = s_wt + tap * CO * CI;
#pragma unroll
      for (int o4 = 0; o4 < CO / 4; ++o4) {
        const float4 g4 = ld4(gp + o4 * 4);
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int i4 = 0; i4 < CI / 4; ++i4) {
            const float4 ww = ld4(wp + (o4 * 4 + k) * CI + i4 * 4);
            acc[i4 * 4 + 0] = fmaf(gv[k], ww.x, acc[i4 * 4 + 0]);
            acc[i4 * 4 + 1] = fmaf(gv[k], ww.y, acc[i4 * 4 + 1]);
            acc[i4 * 4 + 2] = fmaf(gv[k], ww.z, acc[i4 * 4 + 2]);
            acc[i4 * 4 + 3] = fmaf(gv[k], ww.w, acc[i4 * 4 + 3]);
          }
        }
      }
    }
    const bool inside = (y0 + py < H) && (x0 + px < W);
    if constexpr (PREV) {  // ReLU mask from this pixel's own y, still in s_a
#pragma unroll
      for (int i4 = 0; i4 < CI / 4; ++i4) {
        const float4 yv = ld4(s_a + tid * SA + i4 * 4);
        if (!(yv.x >= 0.f)) acc[i4 * 4 + 0] = 0.f;
        if (!(yv.y >= 0.f)) acc[i4 * 4 + 1] = 0.f;
        if (!(yv.z >= 0.f)) acc[i4 * 4 + 2] = 0.f;
        if (!(yv.w >= 0.f)) acc[i4 * 4 + 3] = 0.f;
      }
    }
    __syncthreads();  // every read of s_a and s_g is done; reuse both
    const size_t own = (((size_t)b * H + (y0 + py)) * W + (x0 + px)) * CI;
#pragma unroll
    for (int i4 = 0; i4 < CI / 4; ++i4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (inside) v = make_float4(acc[i4 * 4], acc[i4 * 4 + 1], acc[i4 * 4 + 2], acc[i4 * 4 + 3]);
      st4(s_a + tid * SA + i4 * 4, v);
      if constexpr (PREV) {
        float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        if (inside) z = ld4(a_src + own + i4 * 4);
        st4(s_g + tid * SG + i4 * 4, make_float4(v.x * z.x, v.y * z.y, v.z * z.z, v.w * z.w));
      }
    }
    __syncthreads();
    for (int i = tid; i < NT * (CI / 4); i += NT) {
      const int c4 = i % (CI / 4), p = i / (CI / 4);
      const int gy = y0 + p / TW, gx = x0 + p % TW;
      if (gy < H && gx < W)
        st4(d_in + (((size_t)b * H + gy) * W + gx) * CI + c4 * 4, ld4(s_a + p * SA + c4 * 4));
    }
    if constexpr (PREV) {
      float s0 = 0.f, s1 = 0.f;
      for (int p = rg; p < NT; p += NG) {
        s0 += s_a[p * SA + rc];
        s1 += s_g[p * SG + rc];
      }
      tot0 += (double)s0;
      tot1 += (double)s1;
    }
  }

#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int k = 0; k < CPT; ++k)
      dw_partial[(((size_t)blockIdx.x * 9 + tap) * CI + ci_w) * CO + co_w + k] = dw[tap][k];
  if constexpr (PREV) write_channel_partials<CI>(tot0, tot1, sum_partial);
}

// ------------------------------------------------------------------ pool passes
// One thread per (2x2 window, 4 channels). `item` -> offsets of the window's
// four pixels (scan order) in the [B,H,W,C] tensor and of the pooled pixel.
struct Window {
  size_t off[4];
  size_t pooled;
  int c4;
};

__device__ __forceinline__ Window window_of(size_t item, int H, int W, int C) {
  const int c4n = C / 4, hp = H / 2, wp = W / 2;
  Window wd;
  wd.c4 = (int)(item % c4n);
  size_t q = item / c4n;
  const int xp = (int)(q % wp);
  q /= wp;
  const int yp = (int)(q % hp);
  const size_t b = q / hp;
  const size_t base = ((b * H + 2 * yp) * W + 2 * xp) * C + wd.c4 * 4;
  wd.off[0] = base;
  wd.off[1] = base + C;
  wd.off[2] = base + (size_t)W * C;
  wd.off[3] = base + (size_t)W * C + C;
  wd.pooled = ((b * hp + yp) * wp + xp) * C + wd.c4 * 4;
  return wd;
}

__device__ __forceinline__ void unpack4(float4 v, float* o) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__global__ void __launch_bounds__(NT)
bnpool_kernel(const float* __restrict__ z1, const float* __restrict__ coef,
              float* __restrict__ e, float* __restrict__ p, int B, int H, int W, int C) {
  const size_t total = (size_t)B * (H / 2) * (W / 2) * (C / 4);
  for (size_t item = (size_t)blockIdx.x * NT + threadIdx.x; item < total;
       item += (size_t)gridDim.x * NT) {
    const Window wd = window_of(item, H, W, C);
    float inv[4], sh[4], m[4];
    unpack4(ld4(coef + wd.c4 * 4), inv);
    unpack4(ld4(coef + C + wd.c4 * 4), sh);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float z[4];
      unpack4(ld4(z1 + wd.off[j]), z);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        z[k] = fmaxf(bn_apply(z[k], inv[k], sh[k]), 0.f);
        m[k] = j == 0 ? z[k] : fmaxf(m[k], z[k]);
      }
      st4(e + wd.off[j], make_float4(z[0], z[1], z[2], z[3]));
    }
    st4(p + wd.pooled, make_float4(m[0], m[1], m[2], m[3]));
  }
}

// dy1 of one window: pool backward to the first maximum plus the skip
// cotangent, masked by [y >= 0]. dp / de may be null (no cotangent).
__device__ __forceinline__ void window_dy(const Window& wd, const float* __restrict__ z1,
                                          const float* __restrict__ coef,
                                          const float* __restrict__ dp,
                                          const float* __restrict__ de, int C,
                                          float (&z)[4][4], float (&dy)[4][4]) {
  float inv[4], sh[4], y[4][4], g[4];
  unpack4(ld4(coef + wd.c4 * 4), inv);
  unpack4(ld4(coef + C + wd.c4 * 4), sh);
  if (dp != nullptr) {
    unpack4(ld4(dp + wd.pooled), g);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unpack4(ld4(z1 + wd.off[j]), z[j]);
    if (de != nullptr) {
      unpack4(ld4(de + wd.off[j]), dy[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) dy[j][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) y[j][k] = bn_apply(z[j][k], inv[k], sh[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float e0 = fmaxf(y[0][k], 0.f), e1 = fmaxf(y[1][k], 0.f);
    const float e2 = fmaxf(y[2][k], 0.f), e3 = fmaxf(y[3][k], 0.f);
    const float m = fmaxf(fmaxf(e0, e1), fmaxf(e2, e3));
    const int first = (e0 == m) ? 0 : (e1 == m) ? 1 : (e2 == m) ? 2 : 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float da = dy[j][k] + (j == first ? g[k] : 0.f);
      dy[j][k] = (y[j][k] >= 0.f) ? da : 0.f;
    }
  }
}

__global__ void __launch_bounds__(NT)
poolsums_kernel(const float* __restrict__ z1, const float* __restrict__ coef,
                const float* __restrict__ dp, const float* __restrict__ de,
                double* __restrict__ partial, int B, int H, int W, int C) {
  // gridDim.x * NT is a multiple of C / 4, so a thread keeps its channels
  const size_t total = (size_t)B * (H / 2) * (W / 2) * (C / 4);
  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
  for (size_t item = (size_t)blockIdx.x * NT + threadIdx.x; item < total;
       item += (size_t)gridDim.x * NT) {
    const Window wd = window_of(item, H, W, C);
    float z[4][4], dy[4][4];
    window_dy(wd, z1, coef, dp, de, C, z, dy);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s0[k] += dy[j][k];
        s1[k] = fmaf(dy[j][k], z[j][k], s1[k]);
      }
  }
  __shared__ double s_red[NT][8];
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s_red[tid][k] = (double)s0[k];
    s_red[tid][4 + k] = (double)s1[k];
  }
  __syncthreads();
  const int c4n = C / 4;
  for (int j = tid; j < 2 * C; j += NT) {
    const int which = j / C, c = j % C;
    double r = 0.0;
    for (int t = c / 4; t < NT; t += c4n) r += s_red[t][which * 4 + c % 4];
    partial[((size_t)blockIdx.x * 2 + which) * C + c] = r;
  }
}

__global__ void __launch_bounds__(NT)
dz1_kernel(const float* __restrict__ z1, const float* __restrict__ coef,
           const float* __restrict__ dcoef, const float* __restrict__ dp,
           const float* __restrict__ de, float* __restrict__ dz, int B, int H, int W, int C) {
  const size_t total = (size_t)B * (H / 2) * (W / 2) * (C / 4);
  for (size_t item = (size_t)blockIdx.x * NT + threadIdx.x; item < total;
       item += (size_t)gridDim.x * NT) {
    const Window wd = window_of(item, H, W, C);
    float z[4][4], dy[4][4], k0[4], k1[4], k2[4];
    window_dy(wd, z1, coef, dp, de, C, z, dy);
    unpack4(ld4(dcoef + wd.c4 * 4), k0);
    unpack4(ld4(dcoef + C + wd.c4 * 4), k1);
    unpack4(ld4(dcoef + 2 * C + wd.c4 * 4), k2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = fmaf(k0[k], dy[j][k], fmaf(k2[k], z[j][k], k1[k]));
      st4(dz + wd.off[j], make_float4(o[0], o[1], o[2], o[3]));
    }
  }
}

// out[j] = sum over blocks of part[block][j], in block order, in float64
template <typename T>
__global__ void reduce_kernel(const T* __restrict__ part, int nblocks, int n,
                              double* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  double s = 0.0;
  for (int b = 0; b < nblocks; ++b) s += (double)part[(size_t)b * n + j];
  out[j] = s;
}

// ------------------------------------------------------------------ launches
int grid_for_tiles(int B, int H, int W, int max_blocks) {
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  return (int)(tiles < max_blocks ? tiles : max_blocks);
}

template <typename T>
cudaError_t reduce(const T* part, int nblocks, int n, double* out, cudaStream_t stream) {
  reduce_kernel<T><<<(n + 127) / 128, 128, 0, stream>>>(part, nblocks, n, out);
  return cudaGetLastError();
}

template <int CI, int CO, bool BN_IN>
cudaError_t launch_conv_fwd(const float* in, const float* coef, const float* w, float* out,
                            double* partial, double* sums, int B, int H, int W,
                            int max_blocks, cudaStream_t stream) {
  constexpr int in_floats = HALO_N * (CI + PAD), out_floats = NT * (CO + PAD);
  constexpr size_t dyn =
      sizeof(float) * (9 * CI * CO + (in_floats > out_floats ? in_floats : out_floats));
  auto kernel = conv_fwd_kernel<CI, CO, BN_IN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  const int grid = grid_for_tiles(B, H, W, max_blocks);
  kernel<<<grid, NT, dyn, stream>>>(in, coef, w, out, partial, B, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce<double>(partial, grid, 2 * CO, sums, stream);
}

template <int CI, int CO, bool PREV>
cudaError_t launch_conv_bwd(const float* a_src, const float* a_coef, const float* g_src,
                            const float* g_z, const float* g_coef, const float* w,
                            float* d_in, float* dw_partial, double* dw, double* sum_partial,
                            double* sums, int B, int H, int W, int max_blocks,
                            cudaStream_t stream) {
  constexpr size_t dyn =
      sizeof(float) * (9 * CI * CO + HALO_N * (CO + PAD) + NT * (CI + PAD));
  auto kernel = conv_bwd_kernel<CI, CO, PREV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  const int grid = grid_for_tiles(B, H, W, max_blocks);
  kernel<<<grid, NT, dyn, stream>>>(a_src, a_coef, g_src, g_z, g_coef, w, d_in, dw_partial,
                                    sum_partial, B, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = reduce<float>(dw_partial, grid, 9 * CI * CO, dw, stream);
  if (err != cudaSuccess) return err;
  if (PREV) return reduce<double>(sum_partial, grid, 2 * CI, sums, stream);
  return cudaSuccess;
}

bool dims_ok(int B, int H, int W) { return B > 0 && H > 0 && W > 0; }

bool pool_dims_ok(int B, int H, int W, int C) {
  return dims_ok(B, H, W) && H % 2 == 0 && W % 2 == 0 && (C == 16 || C == 32);
}

// blocks of the elementwise pool passes: enough to cover the windows, at most
// max_blocks (NT is a multiple of C / 4, so any block count keeps a thread's channels)
int grid_for_windows(int B, int H, int W, int C, int max_blocks) {
  const long items = (long)B * (H / 2) * (W / 2) * (C / 4);
  const long blocks = (items + NT - 1) / NT;
  return (int)(blocks < max_blocks ? blocks : max_blocks);
}

}  // namespace

extern "C" {

// Side of the square pixel tile a block works on.
int convstage_tile() { return TH; }

// Workspaces, for a grid of at most `max_blocks` blocks: `partial` float64
// [max_blocks, 2, C] statistics partials, `dw_partial` float32
// [max_blocks, 9, Ci, Co] weight-gradient partials. `sums` is float64 [2, C],
// `dw` float64 [9, Ci, Co]; `coef` float32 [2, C] = (inv, shift), `dcoef`
// float32 [3, C] = (c0, c1, c2); `dp` / `de` may be null.

int convstage_conv(const float* x, const float* w, float* z, double* partial, double* sums,
                   int B, int H, int W, int ci, int co, int max_blocks, void* stream) {
  if (!dims_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ci == 16 && co == 16)
    return (int)launch_conv_fwd<16, 16, false>(x, nullptr, w, z, partial, sums, B, H, W, max_blocks, s);
  if (ci == 16 && co == 32)
    return (int)launch_conv_fwd<16, 32, false>(x, nullptr, w, z, partial, sums, B, H, W, max_blocks, s);
  if (ci == 32 && co == 32)
    return (int)launch_conv_fwd<32, 32, false>(x, nullptr, w, z, partial, sums, B, H, W, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

int convstage_bnconv(const float* z0, const float* coef, const float* w, float* z1,
                     double* partial, double* sums, int B, int H, int W, int c,
                     int max_blocks, void* stream) {
  if (!dims_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (c == 16)
    return (int)launch_conv_fwd<16, 16, true>(z0, coef, w, z1, partial, sums, B, H, W, max_blocks, s);
  if (c == 32)
    return (int)launch_conv_fwd<32, 32, true>(z0, coef, w, z1, partial, sums, B, H, W, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

int convstage_bnpool(const float* z1, const float* coef, float* e, float* p, int B, int H,
                     int W, int c, int max_blocks, void* stream) {
  if (!pool_dims_ok(B, H, W, c)) return (int)cudaErrorInvalidValue;
  bnpool_kernel<<<grid_for_windows(B, H, W, c, max_blocks), NT, 0, (cudaStream_t)stream>>>(
      z1, coef, e, p, B, H, W, c);
  return (int)cudaGetLastError();
}

int convstage_poolsums(const float* z1, const float* coef, const float* dp, const float* de,
                       double* partial, double* sums, int B, int H, int W, int c,
                       int max_blocks, void* stream) {
  if (!pool_dims_ok(B, H, W, c)) return (int)cudaErrorInvalidValue;
  const int grid = grid_for_windows(B, H, W, c, max_blocks);
  poolsums_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(z1, coef, dp, de, partial, B, H, W, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce<double>(partial, grid, 2 * c, sums, (cudaStream_t)stream);
}

int convstage_dz1(const float* z1, const float* coef, const float* dcoef, const float* dp,
                  const float* de, float* dz, int B, int H, int W, int c, int max_blocks,
                  void* stream) {
  if (!pool_dims_ok(B, H, W, c)) return (int)cudaErrorInvalidValue;
  dz1_kernel<<<grid_for_windows(B, H, W, c, max_blocks), NT, 0, (cudaStream_t)stream>>>(
      z1, coef, dcoef, dp, de, dz, B, H, W, c);
  return (int)cudaGetLastError();
}

int convstage_dwprev(const float* dz, const float* zprev, const float* coef, const float* w,
                     float* dyprev, float* dw_partial, double* dw, double* sum_partial,
                     double* sums, int B, int H, int W, int c, int max_blocks, void* stream) {
  if (!dims_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (c == 16)
    return (int)launch_conv_bwd<16, 16, true>(zprev, coef, dz, nullptr, nullptr, w, dyprev,
                                              dw_partial, dw, sum_partial, sums, B, H, W,
                                              max_blocks, s);
  if (c == 32)
    return (int)launch_conv_bwd<32, 32, true>(zprev, coef, dz, nullptr, nullptr, w, dyprev,
                                              dw_partial, dw, sum_partial, sums, B, H, W,
                                              max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

int convstage_dwdx(const float* z0, const float* dy0, const float* dcoef, const float* x,
                   const float* w, float* dx, float* dw_partial, double* dw, int B, int H,
                   int W, int ci, int co, int max_blocks, void* stream) {
  if (!dims_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ci == 16 && co == 16)
    return (int)launch_conv_bwd<16, 16, false>(x, nullptr, dy0, z0, dcoef, w, dx, dw_partial,
                                               dw, nullptr, nullptr, B, H, W, max_blocks, s);
  if (ci == 16 && co == 32)
    return (int)launch_conv_bwd<16, 32, false>(x, nullptr, dy0, z0, dcoef, w, dx, dw_partial,
                                               dw, nullptr, nullptr, B, H, W, max_blocks, s);
  if (ci == 32 && co == 32)
    return (int)launch_conv_bwd<32, 32, false>(x, nullptr, dy0, z0, dcoef, w, dx, dw_partial,
                                               dw, nullptr, nullptr, B, H, W, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
