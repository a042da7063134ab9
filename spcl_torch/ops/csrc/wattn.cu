// Shifted-window multi-head self-attention of the Swin Transformer block,
// float32, windows of 7 x 7 tokens, head size 32.
//
// Replaces no TPU kernel: spcl_tpu has no transformer. The plain versions
// and the layout are in `ops/wattn_cuda.py`; in short, for window w and
// head h of a B x H x W image whose block is shifted by `shift`:
//
//   token (i, j) of the window sits at shifted position (y, x) = (wy 7 + i,
//   wx 7 + j) and is the image's token ((y + shift) mod H, (x + shift) mod W)
//   S[a][b]  = sum_d (q[a][d] * scale) k[b][d] + table[bin(a, b)][h]
//              (+ -100 where the regions of a and b differ, shift > 0)
//   P        = softmax over b;  out[a] = sum_b P[a][b] v[b]
//
// qkv is [B, H, W, 3C] in the image's order, columns (q|k|v, head, d): the
// roll and the window partition are folded into the addressing, so no
// rolled or partitioned copy exists. bin(a, b) = (dy + 6) 13 + (dx + 6) with
// (dy, dx) = a's window coordinates minus b's; the region of a shifted
// coordinate p along an axis of n is [p >= n - 7] + [p >= n - shift], the
// published 3 x 3 labelling.
//
// Design: one block of 128 threads per (window, head). The window's 49
// tokens are padded to 64 rows in shared memory (q, k, v, dO row-major,
// rows of 36 floats; the 64 x 64 probabilities P and dS, rows of 68), the
// padding zero, and every product is a float32 FMA on the CUDA cores,
// register-tiled from 16-byte shared loads (thread t: r = t / 8, c = t % 8):
//   64 x 64 products over d (S = q k^T, dP = dO v^T): rows r + 16 i (i < 4),
//     columns c + 8 j (j < 8), 32 outputs a thread; the 8 threads of a row
//     are 8 neighbouring lanes, so the softmax's and rowsum's reductions are
//     three shuffles;
//   64 x 32 products over keys (out = P v, dq = dS k): rows r + 16 i, d 4c..4c+3;
//   64 x 32 products over queries (dv = P^T dO, dk = dS^T q): rows 4r..4r+3,
//     d 4c..4c+3.
// Each output's sum runs over d, keys or queries in order. What bounds it:
// bytes. A token's head reads 3 x 128 bytes and writes 128 in the forward,
// for 4 x 49 x 32 FLOPs (12 FLOP a byte); the backward reads 4 x 128 and
// writes 3 x 128 for 8 x 49 x 32 (14 a byte); both under the card's
// float32 ridge (67 TFLOP/s over 3.35 TB/s = 20). The padding to 64 costs
// 1.7x the FLOPs of the 49 x 49 products.
//
// The backward recomputes P, then dv = P^T dO, dP = dO v^T, dS = P (dP -
// rowsum(dP P)), dq = scale dS k, dk = dS^T (q scale), each written once to
// dqkv (every token's head belongs to exactly one window). The bias table's
// gradient is a sum over every window: each block sums its dS over the 169
// table entries in a fixed order into part[(h 169 + bin) windows + w], and
// wattn_dbias adds a row of part in window order (float64, one warp a row,
// a fixed shuffle tree): no float atomic, so the result does not depend on
// the blocks' order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WS = 7;
constexpr int N = WS * WS;          // tokens of a window
constexpr int NP = 64;              // tokens padded
constexpr int NB = 52;              // keys summed over in P v and dS k (>= N, a multiple of 4)
constexpr int HD = 32;              // head size
constexpr int BINS = (2 * WS - 1) * (2 * WS - 1);
constexpr int NT = 128;
constexpr int NWARP = NT / 32;
constexpr int LQ = HD + 4;          // row of q, k, v, dO in shared memory
constexpr int LP = NP + 4;          // row of P, dS
constexpr int OPS = NP * LQ;        // floats of one operand
constexpr int BWD_SMEM = (4 * OPS + NP * LP) * 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr float MASKED = -100.0f;

struct Geo {
  int H, W, C, heads, shift, nwx, nwin_img;
};

// What a block shares: the window's image tokens, their region labels, the
// head's column of the bias table.
struct Window {
  size_t tok[N];
  int reg[NP];
  float tab[BINS];
};

__device__ __forceinline__ int region(int p, int n, int shift) {
  return (p >= n - WS) + (p >= n - shift);
}

__device__ void setup(Window& w, const Geo& g, int win, int head,
                      const float* __restrict__ table) {
  const int b = win / g.nwin_img;
  const int r = win - b * g.nwin_img;
  const int wy = r / g.nwx, wx = r - (r / g.nwx) * g.nwx;
  for (int t = threadIdx.x; t < NP; t += NT) {
    if (t < N) {
      const int ys = wy * WS + t / WS, xs = wx * WS + t % WS;   // shifted position
      int y = ys + g.shift, x = xs + g.shift;
      if (y >= g.H) y -= g.H;
      if (x >= g.W) x -= g.W;
      w.tok[t] = ((size_t)b * g.H + y) * g.W + x;
      w.reg[t] = region(ys, g.H, g.shift) * 3 + region(xs, g.W, g.shift);
    } else {
      w.reg[t] = -1;
    }
  }
  for (int i = threadIdx.x; i < BINS; i += NT) w.tab[i] = table[i * g.heads + head];
}

// a [NP][LQ] operand: columns col..col+31 of the window's tokens' rows of
// `stride` floats (times `mul` where `scaled`), rows N..NP-1 zero
__device__ __forceinline__ void load_op(float* __restrict__ dst, const float* __restrict__ src,
                                        const size_t* tok, size_t stride, int col, float mul,
                                        bool scaled) {
  for (int u = threadIdx.x; u < NP * (HD / 4); u += NT) {
    const int t = u / (HD / 4), c = (u % (HD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < N) {
      v = *reinterpret_cast<const float4*>(src + tok[t] * stride + col + c);
      if (scaled) { v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul; }
    }
    *reinterpret_cast<float4*>(dst + t * LQ + c) = v;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]); acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]); acc[3] = fmaf(a, b.w, acc[3]);
}

// acc[i][j] = sum_d A[r + 16 i][d] B[c + 8 j][d]
__device__ __forceinline__ void tile_nt(const float* A, const float* B, int r, int c,
                                        float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int d0 = 0; d0 < HD; d0 += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (r + 16 * i) * LQ + d0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b = ld4(B + (c + 8 * j) * LQ + d0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = acc[i][j];
        x = fmaf(a[i].x, b.x, x); x = fmaf(a[i].y, b.y, x);
        x = fmaf(a[i].z, b.z, x); x = fmaf(a[i].w, b.w, x);
        acc[i][j] = x;
      }
    }
  }
}

// acc[i][:] = sum_{b < NB} P[r + 16 i][b] X[b][4c..4c+3]
__device__ __forceinline__ void tile_nn(const float* P, const float* X, int r, int c,
                                        float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#pragma unroll 1
  for (int b0 = 0; b0 < NB; b0 += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ld4(P + (r + 16 * i) * LP + b0);
    const float4 x0 = ld4(X + (b0 + 0) * LQ + 4 * c), x1 = ld4(X + (b0 + 1) * LQ + 4 * c);
    const float4 x2 = ld4(X + (b0 + 2) * LQ + 4 * c), x3 = ld4(X + (b0 + 3) * LQ + 4 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fma4(acc[i], p[i].x, x0); fma4(acc[i], p[i].y, x1);
      fma4(acc[i], p[i].z, x2); fma4(acc[i], p[i].w, x3);
    }
  }
}

// acc[i][:] = sum_{a < N} P[a][4r + i] X[a][4c..4c+3]
__device__ __forceinline__ void tile_tn(const float* P, const float* X, int r, int c,
                                        float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#pragma unroll 7
  for (int a = 0; a < N; ++a) {
    const float4 p = ld4(P + a * LP + 4 * r), x = ld4(X + a * LQ + 4 * c);
    fma4(acc[0], p.x, x); fma4(acc[1], p.y, x); fma4(acc[2], p.z, x); fma4(acc[3], p.w, x);
  }
}

__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v + __shfl_xor_sync(FULL, v, 4);
}

__device__ __forceinline__ float max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 4));
}

// P = softmax((q scale) k^T + bias (+ mask)) into p[NP][LP] (padded keys 0;
// a padded query row is a uniform row, never stored)
__device__ void probs(const Window& w, const Geo& g, const float* q, const float* k,
                      float* p) {
  const int r = threadIdx.x / 8, c = threadIdx.x % 8;
  float s[4][8];
  tile_nt(q, k, r, c, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = r + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = c + 8 * j;
      if (b >= N) {
        s[i][j] = -INFINITY;
      } else if (a < N) {
        const int bin = (a / WS - b / WS + WS - 1) * (2 * WS - 1) + (a % WS - b % WS + WS - 1);
        float x = s[i][j] + w.tab[bin];
        if (g.shift && w.reg[a] != w.reg[b]) x += MASKED;
        s[i][j] = x;
      }
    }
    float m = s[i][0];
#pragma unroll
    for (int j = 1; j < 8; ++j) m = fmaxf(m, s[i][j]);
    m = max8(m);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = expf(s[i][j] - m);
      sum += s[i][j];
    }
    sum = sum8(sum);
#pragma unroll
    for (int j = 0; j < 8; ++j) p[a * LP + c + 8 * j] = s[i][j] / sum;
  }
}

__global__ void __launch_bounds__(NT, 4) wattn_fwd_kernel(const float* __restrict__ qkv,
                                                          const float* __restrict__ table,
                                                          float* __restrict__ out, Geo g,
                                                          float scale) {
  __shared__ __align__(16) float q[OPS], k[OPS], v[OPS];
  __shared__ __align__(16) float p[NP * LP];
  __shared__ Window w;
  const int win = blockIdx.x, head = blockIdx.y;
  setup(w, g, win, head, table);
  __syncthreads();
  const size_t row = 3 * (size_t)g.C;
  load_op(q, qkv, w.tok, row, head * HD, scale, true);
  load_op(k, qkv, w.tok, row, g.C + head * HD, 1.0f, false);
  load_op(v, qkv, w.tok, row, 2 * g.C + head * HD, 1.0f, false);
  __syncthreads();
  probs(w, g, q, k, p);
  __syncthreads();
  const int r = threadIdx.x / 8, c = threadIdx.x % 8;
  float o[4][4];
  tile_nn(p, v, r, c, o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = r + 16 * i;
    if (a < N)
      *reinterpret_cast<float4*>(out + w.tok[a] * g.C + head * HD + 4 * c) =
          make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
  }
}

__global__ void __launch_bounds__(NT, 3) wattn_bwd_kernel(const float* __restrict__ qkv,
                                                          const float* __restrict__ dout,
                                                          const float* __restrict__ table,
                                                          float* __restrict__ dqkv,
                                                          float* __restrict__ part, Geo g,
                                                          float scale, int windows) {
  extern __shared__ float4 dyn[];
  float* q = reinterpret_cast<float*>(dyn);
  float* k = q + OPS;
  float* v = k + OPS;
  float* dO = v + OPS;
  float* p = dO + OPS;   // P, then dS
  __shared__ Window w;
  const int win = blockIdx.x, head = blockIdx.y;
  setup(w, g, win, head, table);
  __syncthreads();
  const size_t row = 3 * (size_t)g.C;
  load_op(q, qkv, w.tok, row, head * HD, scale, true);
  load_op(k, qkv, w.tok, row, g.C + head * HD, 1.0f, false);
  load_op(v, qkv, w.tok, row, 2 * g.C + head * HD, 1.0f, false);
  load_op(dO, dout, w.tok, g.C, head * HD, 1.0f, false);
  __syncthreads();
  probs(w, g, q, k, p);
  __syncthreads();
  const int r = threadIdx.x / 8, c = threadIdx.x % 8;
  {  // dv = P^T dO
    float acc[4][4];
    tile_tn(p, dO, r, c, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = 4 * r + i;
      if (b < N)
        *reinterpret_cast<float4*>(dqkv + w.tok[b] * row + 2 * g.C + head * HD + 4 * c) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  float ds[4][8];
  tile_nt(dO, v, r, c, ds);   // dP
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = r + 16 * i;
    float pr[8], dot = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pr[j] = p[a * LP + c + 8 * j];
      dot = fmaf(pr[j], ds[i][j], dot);
    }
    dot = sum8(dot);
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[i][j] = pr[j] * (ds[i][j] - dot);
  }
  __syncthreads();   // every read of P is done: dS takes its place
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) p[(r + 16 * i) * LP + c + 8 * j] = ds[i][j];
  __syncthreads();
  {  // dq = scale dS k
    float acc[4][4];
    tile_nn(p, k, r, c, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = r + 16 * i;
      if (a < N)
        *reinterpret_cast<float4*>(dqkv + w.tok[a] * row + head * HD + 4 * c) =
            make_float4(acc[i][0] * scale, acc[i][1] * scale, acc[i][2] * scale,
                        acc[i][3] * scale);
    }
  }
  {  // dk = dS^T (q scale)
    float acc[4][4];
    tile_tn(p, q, r, c, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = 4 * r + i;
      if (b < N)
        *reinterpret_cast<float4*>(dqkv + w.tok[b] * row + g.C + head * HD + 4 * c) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  // the window's sum of dS over each table entry, pairs in row-major order
  for (int bin = threadIdx.x; bin < BINS; bin += NT) {
    const int dy = bin / (2 * WS - 1) - (WS - 1), dx = bin % (2 * WS - 1) - (WS - 1);
    float acc = 0.0f;
    for (int ay = max(0, dy); ay < min(WS, WS + dy); ++ay)
      for (int ax = max(0, dx); ax < min(WS, WS + dx); ++ax)
        acc += p[(ay * WS + ax) * LP + (ay - dy) * WS + (ax - dx)];
    part[((size_t)head * BINS + bin) * windows + win] = acc;
  }
}

// dtable[bin][head] = sum over windows of part[(head BINS + bin) windows + w]
__global__ void __launch_bounds__(NT) wattn_dbias_kernel(const float* __restrict__ part,
                                                         float* __restrict__ dtable,
                                                         int rows, int windows, int heads) {
  const int r = blockIdx.x * NWARP + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float* src = part + (size_t)r * windows;
  double acc = 0.0;
  for (int w = lane; w < windows; w += 32) acc += (double)src[w];
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  if (lane == 0) {
    const int head = r / BINS, bin = r % BINS;
    dtable[bin * heads + head] = (float)acc;
  }
}

Geo make_geo(int H, int W, int C, int heads, int shift) {
  Geo g;
  g.H = H; g.W = W; g.C = C; g.heads = heads; g.shift = shift;
  g.nwx = W / WS;
  g.nwin_img = (H / WS) * (W / WS);
  return g;
}

}  // namespace

extern "C" {

int wattn_fwd(const float* qkv, const float* table, float* out, int B, int H, int W, int C,
              int heads, int shift, float scale, cudaStream_t stream) {
  const Geo g = make_geo(H, W, C, heads, shift);
  const dim3 grid(B * g.nwin_img, heads);
  wattn_fwd_kernel<<<grid, NT, 0, stream>>>(qkv, table, out, g, scale);
  return (int)cudaGetLastError();
}

int wattn_bwd(const float* qkv, const float* dout, const float* table, float* dqkv,
              float* part, int B, int H, int W, int C, int heads, int shift, float scale,
              cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        wattn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const Geo g = make_geo(H, W, C, heads, shift);
  const int windows = B * g.nwin_img;
  const dim3 grid(windows, heads);
  wattn_bwd_kernel<<<grid, NT, BWD_SMEM, stream>>>(qkv, dout, table, dqkv, part, g, scale,
                                                   windows);
  return (int)cudaGetLastError();
}

int wattn_dbias(const float* part, float* dtable, int rows, int windows,
                cudaStream_t stream) {
  const int heads = rows / BINS;
  wattn_dbias_kernel<<<(rows + NWARP - 1) / NWARP, NT, 0, stream>>>(part, dtable, rows,
                                                                     windows, heads);
  return (int)cudaGetLastError();
}

}  // extern "C"
