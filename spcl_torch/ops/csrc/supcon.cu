// Fused self-paced SupCon: forward per-row statistics and the dz backward,
// CUDA C++ for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of spcl_tpu/ops/supcon_pallas.py:
//   supcon_fwd_kernel  <- _denom_kernel (:121, pass A) + _loss_kernel (:142, pass B)
//   supcon_bwd_kernel  <- _bwd_kernel (:167)
//
// What they compute, over an independent (rows x cols) rectangle whose rows
// and columns carry their own z / label / valid / global-row-id vectors:
//   s_ij   = z_i . z_j / T - 1/T           (max-subtraction by exactly 1/T)
//   a_ij   = [gid_i != gid_j] v_i v_j      (valid off-diagonal pairs)
//   p_ij   = [lab_i == lab_j] a_ij         (positives)
//   pass A: denom_i = sum_j exp(s_ij) over a_ij (masked in log space before
//           exp, so padded columns never give inf*0), c_i = sum_j p_ij
//   pass B: logp_ij = s_ij - log(denom_i + 1e-16), w = hard/soft/none weight,
//           rawloss_i = sum_j p w logp, spsum_i = sum_j p w
//   bwd:    dz_i = sum_j (G_ij + G_ji) z_j / T, the column term G_ji from the
//           columns' own row statistics (the similarity matrix is symmetric).
//
// Design. On the TPU the column blocks were a sequential grid axis carrying
// sums in scratch memory; here blocks run in parallel, so each block OWNS a
// tile of 32 rows and loops over every 32-column tile itself. The forward
// sweeps the columns twice inside one kernel (pass B needs the finished row
// denominator, which the block itself holds). Each warp owns 4 rows, each
// lane one column of the tile, so every per-row sum is a per-lane running
// sum closed by one warp shuffle reduction — no atomics, no second pass, and
// nothing of the [2N, 2N] matrix ever leaves registers. The backward keeps
// its [32, D] dz accumulator in shared memory and writes it once.
// Arithmetic is float32 FMA (no TF32, no tensor cores), z tiles staged
// through shared memory in 32-deep chunks.
//
// Bound on the H100. The work is two [rows, D] x [D, cols] products per
// call (the forward recomputes s in pass B; the backward computes s and
// G @ z), so at large 2N it is bound by float32 operations (67 TFLOP/s
// without tensor cores), and at the paper's 2N = 60 it is far below launch
// latency. This simple tiling issues ~5 shared-memory loads per 4 FMAs, so
// it runs well below the float32 peak; wgmma on TF32/bf16 tiles fed by TMA
// is the next step.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;             // rows owned by one block
constexpr int kCols = 32;             // columns per tile (one per lane)
constexpr int kDepth = 32;            // z chunk staged per iteration
constexpr int kWarps = 8;             // 256 threads
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr float kEps = 1e-16f;
constexpr float kNegBig = -1e30f;

enum Mode { kModeNone = 0, kModeHard = 1, kModeSoft = 2 };

__device__ __forceinline__ float pair_weight(float logp, float gamma, int mode) {
  if (mode == kModeHard) return (-logp <= gamma) ? 1.0f : 0.0f;
  if (mode == kModeSoft) return fmaxf(1.0f + logp / gamma, 0.0f);
  return 1.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i] = z_{r0 + warp + 8i} . z_{c0 + lane}, chunked over the depth.
__device__ __forceinline__ void tile_dot(const float* __restrict__ zr,
                                         const float* __restrict__ zc,
                                         int r0, int c0, int d,
                                         float (*zr_s)[kDepth + 1],
                                         float (*zc_s)[kDepth + 1],
                                         float acc[kRowsPerWarp]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < d; k0 += kDepth) {
    __syncthreads();  // every reader of the previous chunk is done
    for (int e = tid; e < kRows * kDepth; e += blockDim.x) {
      const int r = e / kDepth;
      const int k = e % kDepth;
      const int kk = k0 + k;
      zr_s[r][k] = kk < d ? zr[(size_t)(r0 + r) * d + kk] : 0.0f;
      zc_s[r][k] = kk < d ? zc[(size_t)(c0 + r) * d + kk] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kDepth; ++k) {
      const float b = zc_s[lane][k];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        acc[i] = fmaf(zr_s[warp + kWarps * i][k], b, acc[i]);
    }
  }
}

__global__ void __launch_bounds__(256)
supcon_fwd_kernel(const float* __restrict__ zr, const float* __restrict__ zc,
                  const float* __restrict__ lab_r, const float* __restrict__ lab_c,
                  const float* __restrict__ val_r, const float* __restrict__ val_c,
                  const float* __restrict__ gid_r, const float* __restrict__ gid_c,
                  int cols, int d, float inv_t, float gamma, int mode,
                  float* __restrict__ denom_out, float* __restrict__ c_out,
                  float* __restrict__ rawloss_out, float* __restrict__ spsum_out) {
  __shared__ float zr_s[kRows][kDepth + 1];
  __shared__ float zc_s[kCols][kDepth + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows;

  float labr[kRowsPerWarp], valr[kRowsPerWarp], gidr[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp + kWarps * i;
    labr[i] = lab_r[r];
    valr[i] = val_r[r];
    gidr[i] = gid_r[r];
  }

  // ---- pass A: denominators and positive counts
  float den[kRowsPerWarp], cnt[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) den[i] = cnt[i] = 0.0f;
  for (int c0 = 0; c0 < cols; c0 += kCols) {
    float acc[kRowsPerWarp];
    tile_dot(zr, zc, r0, c0, d, zr_s, zc_s, acc);
    const int c = c0 + lane;
    const float labc = lab_c[c], valc = val_c[c], gidc = gid_c[c];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float s = acc[i] * inv_t - inv_t;
      const float a = (gidc != gidr[i] ? 1.0f : 0.0f) * valc * valr[i];
      const float p = (labc == labr[i] ? 1.0f : 0.0f) * a;
      den[i] += expf(a > 0.0f ? s : kNegBig);
      cnt[i] += p;
    }
  }
  float logden[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    den[i] = warp_sum(den[i]);
    cnt[i] = warp_sum(cnt[i]);
    logden[i] = logf(den[i] + kEps);
    if (lane == 0) {
      const int r = r0 + warp + kWarps * i;
      denom_out[r] = den[i];
      c_out[r] = cnt[i];
    }
  }

  // ---- pass B: self-paced weighted log-likelihood sums
  float raw[kRowsPerWarp], sps[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) raw[i] = sps[i] = 0.0f;
  for (int c0 = 0; c0 < cols; c0 += kCols) {
    float acc[kRowsPerWarp];
    tile_dot(zr, zc, r0, c0, d, zr_s, zc_s, acc);
    const int c = c0 + lane;
    const float labc = lab_c[c], valc = val_c[c], gidc = gid_c[c];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float s = acc[i] * inv_t - inv_t;
      const float a = (gidc != gidr[i] ? 1.0f : 0.0f) * valc * valr[i];
      const float p = (labc == labr[i] ? 1.0f : 0.0f) * a;
      const float logp = s - logden[i];
      const float pw = p * pair_weight(logp, gamma, mode);
      raw[i] += pw * logp;
      sps[i] += pw;
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    raw[i] = warp_sum(raw[i]);
    sps[i] = warp_sum(sps[i]);
    if (lane == 0) {
      const int r = r0 + warp + kWarps * i;
      rawloss_out[r] = raw[i];
      spsum_out[r] = sps[i];
    }
  }
}

// G term of one side: -(m * scale) * (p w / max(c, 1) - a * softmax).
__device__ __forceinline__ float g_term(float s, float p, float e, float c, float denom,
                                        float a_stat, float valid, float gamma,
                                        float scale, int mode) {
  const float m = (c > 0.0f ? 1.0f : 0.0f) * valid;
  const float logp = s - logf(denom + kEps);
  const float w = pair_weight(logp, gamma, mode);
  const float softmax = e / (denom + kEps);
  return -(m * scale) * (p * w / fmaxf(c, 1.0f) - a_stat * softmax);
}

__global__ void __launch_bounds__(256)
supcon_bwd_kernel(const float* __restrict__ zr, const float* __restrict__ zc,
                  const float* __restrict__ lab_r, const float* __restrict__ lab_c,
                  const float* __restrict__ val_r, const float* __restrict__ val_c,
                  const float* __restrict__ gid_r, const float* __restrict__ gid_c,
                  const float* __restrict__ c_r, const float* __restrict__ c_c,
                  const float* __restrict__ den_r, const float* __restrict__ den_c,
                  const float* __restrict__ a_r, const float* __restrict__ a_c,
                  int cols, int d, float inv_t, float gamma,
                  const float* __restrict__ scale_ptr, int mode,
                  float* __restrict__ dz) {
  extern __shared__ float dz_s[];  // [kRows][d] accumulator
  __shared__ float zr_s[kRows][kDepth + 1];
  __shared__ float zc_s[kCols][kDepth + 1];
  __shared__ float g_s[kRows][kCols + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows;
  const float scale = *scale_ptr;

  float labr[kRowsPerWarp], valr[kRowsPerWarp], gidr[kRowsPerWarp];
  float cr[kRowsPerWarp], denr[kRowsPerWarp], ar[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp + kWarps * i;
    labr[i] = lab_r[r];
    valr[i] = val_r[r];
    gidr[i] = gid_r[r];
    cr[i] = c_r[r];
    denr[i] = den_r[r];
    ar[i] = a_r[r];
  }
  // each thread owns the same (row, depth) accumulator elements throughout
  for (int k0 = 0; k0 < d; k0 += kDepth) {
    if (k0 + lane < d) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        dz_s[(warp + kWarps * i) * d + k0 + lane] = 0.0f;
    }
  }

  for (int c0 = 0; c0 < cols; c0 += kCols) {
    float acc[kRowsPerWarp];
    tile_dot(zr, zc, r0, c0, d, zr_s, zc_s, acc);
    const int c = c0 + lane;
    const float labc = lab_c[c], valc = val_c[c], gidc = gid_c[c];
    const float cc = c_c[c], denc = den_c[c], ac = a_c[c];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float s = acc[i] * inv_t - inv_t;
      const float a = (gidc != gidr[i] ? 1.0f : 0.0f) * valc * valr[i];
      const float p = (labc == labr[i] ? 1.0f : 0.0f) * a;
      const float e = expf(a > 0.0f ? s : kNegBig);
      const float g_row = g_term(s, p, e, cr[i], denr[i], ar[i], valr[i], gamma, scale, mode);
      const float g_col = g_term(s, p, e, cc, denc, ac, valc, gamma, scale, mode);
      g_s[warp + kWarps * i][lane] = (g_row + g_col) * inv_t;
    }
    // dz[rows, :] += G[rows, tile] @ z[tile, :], chunked over the depth
    for (int k0 = 0; k0 < d; k0 += kDepth) {
      __syncthreads();  // G written; previous readers of zc_s done
      for (int e = threadIdx.x; e < kCols * kDepth; e += blockDim.x) {
        const int j = e / kDepth;
        const int k = e % kDepth;
        const int kk = k0 + k;
        zc_s[j][k] = kk < d ? zc[(size_t)(c0 + j) * d + kk] : 0.0f;
      }
      __syncthreads();
      if (k0 + lane < d) {
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = warp + kWarps * i;
          float sum = 0.0f;
#pragma unroll 8
          for (int j = 0; j < kCols; ++j) sum = fmaf(g_s[r][j], zc_s[j][lane], sum);
          dz_s[r * d + k0 + lane] += sum;
        }
      }
    }
  }
  for (int k0 = 0; k0 < d; k0 += kDepth) {
    if (k0 + lane < d) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        dz[(size_t)(r0 + r) * d + k0 + lane] = dz_s[r * d + k0 + lane];
      }
    }
  }
}

bool shapes_ok(int rows, int cols, int d) {
  return rows > 0 && cols > 0 && d > 0 && rows % kRows == 0 && cols % kCols == 0;
}

}  // namespace

extern "C" {

// Rows and columns must be padded to a multiple of this.
int supcon_tile() { return kRows; }

int supcon_fwd(const float* zr, const float* zc, const float* lab_r, const float* lab_c,
               const float* val_r, const float* val_c, const float* gid_r,
               const float* gid_c, int rows, int cols, int d, float inv_t, float gamma,
               int mode, float* denom, float* c, float* rawloss, float* spsum,
               void* stream) {
  if (!shapes_ok(rows, cols, d)) return (int)cudaErrorInvalidValue;
  supcon_fwd_kernel<<<rows / kRows, kWarps * 32, 0, (cudaStream_t)stream>>>(
      zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c, cols, d, inv_t, gamma, mode,
      denom, c, rawloss, spsum);
  return (int)cudaGetLastError();
}

int supcon_bwd(const float* zr, const float* zc, const float* lab_r, const float* lab_c,
               const float* val_r, const float* val_c, const float* gid_r,
               const float* gid_c, const float* c_r, const float* c_c,
               const float* den_r, const float* den_c, const float* a_r,
               const float* a_c, int rows, int cols, int d, float inv_t, float gamma,
               const float* scale, int mode, float* dz, void* stream) {
  if (!shapes_ok(rows, cols, d)) return (int)cudaErrorInvalidValue;
  const size_t dyn = (size_t)kRows * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      supcon_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  supcon_bwd_kernel<<<rows / kRows, kWarps * 32, dyn, (cudaStream_t)stream>>>(
      zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c, c_r, c_c, den_r, den_c, a_r, a_c,
      cols, d, inv_t, gamma, scale, mode, dz);
  return (int)cudaGetLastError();
}

}  // extern "C"
