// Fused small-channel encoder stage (conv3x3 -> BN -> ReLU -> conv3x3 -> BN ->
// ReLU -> 2x2 max-pool) with its backward, CUDA C++ for Hopper (sm_90a), plain
// C interface for ctypes. Activation tensors are channels-last [B, H, W, C]
// with C in {16, 32}, stored in float32 or in bfloat16 (the `bf` argument of
// every entry point); convolution weights are float32 [3, 3, Ci, Co], BN
// coefficients float32, statistics and weight gradients float64.
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
// A block of 256 threads (8 warps) walks 16x16 pixel tiles and stages each in
// shared memory with its one-pixel halo, zeros outside the image. The pool
// passes are elementwise over 2x2 windows; the backward routes dp to the
// FIRST maximum in scan order (r0,c0),(r0,c1),(r1,c0),(r1,c1).
//
// The float32 convolutions run on the tensor cores in 3xTF32 (mma.sync.m16n8k8,
// TF32 in, float32 out): every operand x is split into hi = x with its low 13
// mantissa bits cleared (a TF32 value) and lo = x - hi (exact), and each
// product is accumulated as lo*hi + hi*lo + hi*hi. The MMA reads the top 11
// significant bits of lo; with the dropped lo*lo term that leaves about 1e-6
// relative per product, the float32 order (one TF32 pass would leave 5e-4).
// A 16-pixel row of the tile is one m16 fragment:
//   forward  (conv_fwd_kernel): implicit GEMM, M = pixels, N = Co, K = 9*Ci;
//            warp w owns tile rows 2w, 2w+1 and every output channel.
//   backward (conv_bwd_kernel), two products on one staged pair of tiles:
//     d_in   implicit GEMM, M = pixels, N = Ci, K = 9*Co, with the weights
//            transposed; warp w owns rows 2w, 2w+1; each (v, k chunk)
//            accumulates its three u afresh and is added on the CUDA cores
//            (add_rn);
//     dW     nine GEMMs, M = Ci, N = Co, K = the tile's pixels, using
//            dW[u,v] = sum_p a[p] (x) g[p-(u-1,v-1)] so that only the gradient
//            tile needs a halo; warp w owns one (16 ci x 8 co) block of all nine
//            taps over a share of the tile's rows, accumulated in registers
//            per tile and added to the block's sum after each tile (2 x 36
//            floats a thread).
// What bounds these passes on the card is the instruction stream around the
// MMAs (fragment loads from shared memory and operand splits), so the design
// cuts it: the weights are staged once per block in fragment order, split
// there for the forward (one 16-byte load per lane and fragment) and split at
// use for d_in, whose tiles leave no room for both halves; an activation
// fragment is loaded and split once for the three taps of a kernel column
// that use it (the two rows of a warp read four halo rows across u); dW keeps
// the split gradient fragments of three halo rows in registers as a window
// that slides down the tile, so each tile row loads one new halo row instead
// of three. Consecutive MMAs go to different accumulators. Shared-memory
// rows are padded so that the fragment loads are free of bank conflicts (dW's
// gradient loads have at most two-way conflicts). The next tile's halo tiles
// are copied with cp.async into a second buffer while this tile computes
// (where two fit beside the weights, else one); the thread that
// copied a chunk then applies BN + ReLU (bnconv), keeps y0 = BN(z0) for the
// mask (dwprev) or forms dz0 = c0*dy0 + c1 + c2*z0 (dwdx) in place, inside
// the image only. Outputs go straight from the accumulator fragments to
// global memory: the four lanes of a quad write 32 contiguous bytes of one
// pixel. The grid is the resident block count (occupancy), at most one block
// per tile.
//
// bfloat16 (`Arch.dtype: bfloat16`, `dtype_name="bfloat16"` of
// fused_packed_block, :611-613). Every kernel takes the storage type of its
// activations; the rounding points are the Pallas kernels': activations and
// cotangents are stored in bf16 (z0, z1, e, p, dz1, dy0, dx), the operands of
// every product are bf16 values (the weights are rounded as they are staged,
// BN + ReLU of a convolution's input and dz0 of dwdx as their tiles are,
// `_a_rows` :276-281 and `dz_rows` :488-497), products accumulate in float32,
// and the statistics are taken from the float32 values before they are rounded
// (`_k_conv` :261-265, `_k_dwprev` :451-461). The pool selects its maximum
// among the bf16-rounded e (`_pool_cands` :82-102), the ReLU mask reads the
// unrounded y. Every bf16 convolution runs on bf16 tensor cores,
// mma.sync.m16n8k16 (twice the K of the TF32 instruction at twice its rate),
// in two kernels of its own (conv_fwd_bf16_kernel for conv and bnconv,
// conv_bwd_bf16_kernel for dwdx and dwprev; see their section): the tiles
// stay bf16 in shared memory (16-byte cp.async, two buffers, the BN + ReLU or
// dz0 transform rounded in place, dwprev's mask kept as bits) and ldmatrix
// feeds the fragments. The same implicit GEMMs and the same flush structure
// as the float32 kernels: dW per tile and d_in per (v, k chunk) added on the
// CUDA cores. The byte-bound passes read and write 2-byte elements (8-byte
// loads of 4 channels), except poolsums, whose bf16 kernel of its own
// (poolsums_bf16_kernel) loads 16 bytes (8 channels) a lane. What bounds
// the bf16 convolutions: their bytes (2-byte activations, 0.02-0.09 ms at
// B=60) lie above their operations at the bf16 tensor-core peak (989
// TFLOP/s). By instruction count, not profiled, the instructions around the
// MMAs (fragment loads, the tile transforms, the epilogue's stores and sums)
// outweigh the MMAs on mma.sync (PERF.md, open questions).
//
// Reductions across blocks. The TPU grid is sequential and carries its sums
// in scratch; Hopper blocks run in no order. Chosen here: no atomics. Every
// block walks a fixed set of tiles (tile t goes to block t mod gridDim), sums
// in a fixed order (warp shuffles, then per-warp float64 slots), and writes
// its partial to a workspace; a second small kernel
// (`convstage_reduce_kernel`) adds the partials in block order in float64.
// poolsums instead adds them inside its one launch (see its note below).
// Two runs on the same inputs give the same bits. BN statistics are
// accumulated per block in float64, so E[z^2] - E[z]^2 over millions of
// elements keeps its digits.
//
// Arithmetic kept from the TPU kernels: BN applied as z*inv + shift (product
// and sum rounded separately, see bn_apply); ReLU mask y >= 0 in the backward;
// BN backward as (c0*dy + c1) + c2*z, each operation rounded in that order
// (bn_bwd), as spcl_tpu and the plain versions write it: dz1 and dz0 equal
// the plain versions' bit for bit.
//
// Bound on the H100. Each pass must read and write its stage tensors once
// (193 MB each at 60x224x224x16), which at 3.35 TB/s is 0.06-0.25 ms per
// pass. A 3x3 convolution needs 2*9*Ci*Co FLOPs per pixel, 13.9 GFLOP for the
// 16->16 convolution at 224^2: 0.21 ms at the float32 FMA peak of 67 TFLOP/s,
// and, as three TF32 products, 0.084 ms at the TF32 tensor-core peak of 495
// TFLOP/s. On the tensor cores the forward 16->16 pass at 224^2 is therefore
// bound by its 385 MB (0.115 ms), the 32->32 pass at 112^2 by its operations
// (0.084 ms), and the backward passes, two products each, are near balance
// (0.17 ms). mma.sync reaches only part of the tensor-core peak (wgmma is the
// way to all of it); the measured times against both bounds are in PERF.md
// (chip_smoke.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

template <class E>
constexpr bool is_bf16 = std::is_same<E, bf16>::value;

constexpr int TH = 16;                 // tile height (pixels)
constexpr int TW = 16;                 // tile width = the M of one mma fragment
constexpr int NT = TH * TW;            // threads per block
constexpr int NWARP = NT / 32;         // 8 warps; warp w owns tile rows 2w, 2w+1
constexpr int HALO_W = TW + 2;
constexpr int HALO_N = (TH + 2) * (TW + 2);
constexpr int PAD = 4;                 // floats of padding per shared-memory pixel row

// z*inv + shift with two roundings (no contraction into one FMA), the same
// bits as the plain PyTorch version's mul and add, so that both take the same
// ReLU masks and pool maxima from the same inputs.
__device__ __forceinline__ float bn_apply(float z, float inv, float shift) {
  return __fadd_rn(__fmul_rn(z, inv), shift);
}

// The BatchNorm backward c0*dy + c1 + c2*z in the plain version's order,
// (c0*dy + c1) + c2*z, each operation rounded (no contraction): the same bits
// as the plain PyTorch version and spcl_tpu (`_k_dz1`, `dz_rows`), so that
// dz1 and dwdx's bf16 operand dz0 round to the same values.
__device__ __forceinline__ float bn_bwd(float dy, float z, float c0, float c1, float c2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c0, dy), c1), __fmul_rn(c2, z));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// ------------------------------------------------------------------ storage types
// Two bf16 in one 32-bit word (element 0 low) <-> two floats: exact widening.
__device__ __forceinline__ float2 bf2_to_f2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ uint32_t f2_to_bf2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float4 bf4_to_f4(uint2 u) {
  const float2 lo = bf2_to_f2(u.x), hi = bf2_to_f2(u.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// x rounded to the storage type and back (identity for float32)
template <class E>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (is_bf16<E>) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// 4 / 2 consecutive elements of E as floats, and stores that round to E
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  return bf4_to_f4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ void store4(float* p, float4 v) { st4(p, v); }
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(f2_to_bf2(v.x, v.y), f2_to_bf2(v.z, v.w));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return bf2_to_f2(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = f2_to_bf2(a, b);
}

// chunk i (4 elements) of p, streamed (__ldcs: evict first) or read-only (__ldg)
__device__ __forceinline__ float4 ldcs4(const float* p, size_t i) {
  return __ldcs(reinterpret_cast<const float4*>(p) + i);
}
__device__ __forceinline__ float4 ldcs4(const bf16* p, size_t i) {
  return bf4_to_f4(__ldcs(reinterpret_cast<const uint2*>(p) + i));
}
__device__ __forceinline__ float4 ldg4(const float* p, size_t i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}
__device__ __forceinline__ float4 ldg4(const bf16* p, size_t i) {
  return bf4_to_f4(__ldg(reinterpret_cast<const uint2*>(p) + i));
}

// ------------------------------------------------------------------ 3xTF32
// x = hi + lo: hi = x with its low 13 mantissa bits cleared (a TF32 value),
// lo = x - hi, exact in float32 and below 2^-10 |x|; the MMA reads the top 11
// significant bits of lo, so what is lost is below 2^-21 |x|. Two
// instructions an element.
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  return {hi, __float_as_uint(__fsub_rn(x, __uint_as_float(hi)))};
}

// A fragment of m16n8k8 (row-major 16x8): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4) with g = lane/4, t = lane%4. B (8x8): b0 (t, g), b1 (t+4, g).
// C/D (16x8): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  const Split s0 = split(a0), s1 = split(a1), s2 = split(a2), s3 = split(a3);
  return {{s0.hi, s1.hi, s2.hi, s3.hi}, {s0.lo, s1.lo, s2.lo, s3.lo}};
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  return {{s0.hi, s1.hi}, {s0.lo, s1.lo}};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i][j] += a[i]*b[j] in 3xTF32: the small terms first, then hi*hi, each
// pass over all MI x NJ accumulators so that consecutive MMAs are independent.
template <int MI, int NJ>
__device__ __forceinline__ void mma3(float (&d)[MI][NJ][4], const FragA* a, const FragB* b) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(d[i][j], a[i].lo, b[j].hi);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(d[i][j], a[i].hi, b[j].lo);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(d[i][j], a[i].hi, b[j].hi);
}

// d[i][j] += p[i][j] on the CUDA cores (round to nearest). The tensor cores
// do not round their float32 accumulation to nearest: an error of each MMA
// follows the accumulator it adds into, and over a long chain that is the
// running partial sum, not the products. Where the outputs' sum over pixels
// cancels (d_in of a BatchNorm-projected gradient, whose sums feed the BN
// backward), a chain's error does not cancel with it; short chains into
// fresh accumulators, added here, keep each MMA's error near its own
// products (scripts/measure_stage_accuracy.py holds both passes to float64).
template <int MI, int NJ>
__device__ __forceinline__ void add_rn(float (&d)[MI][NJ][4], const float (&p)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) d[i][j][k] = __fadd_rn(d[i][j][k], p[i][j][k]);
}

// ------------------------------------------------------------------ channel sums
// Per-channel sums of one tile from the accumulator layout: each lane holds
// s[nf][j] for channel nf*8 + 2t + j over its own pixels; the eight lanes of
// one t are summed by shuffles (fixed order) and lane t of warp w adds the
// result into its float64 slot s_tot[w][which][c]. No two lanes share a slot.
template <int NF>
__device__ __forceinline__ void add_tile_sums(const float (&s)[NF][2], int which,
                                              double* s_tot, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = s[nf][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) s_tot[(warp * 2 + which) * C + nf * 8 + 2 * lane + j] += (double)v;
    }
}

// partial[block][which][c] = sum over warps, in warp order, of s_tot[w][which][c]
__device__ __forceinline__ void write_sum_partials(const double* s_tot, int C,
                                                   double* __restrict__ partial) {
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += NT) {
    double r = 0.0;
    for (int w = 0; w < NWARP; ++w) r += s_tot[w * 2 * C + i];
    partial[(size_t)blockIdx.x * 2 * C + i] = r;
  }
}

// Weights [3,3,Ci,Co] as B fragments in shared memory, one entry per lane:
// entry ((tap*KC + kc)*NF + nf)*32 + lane holds {B(t, g), B(t+4, g)} of the
// 8x8 block (k = kc*8.., n = nf*8..), where B(k, n) = w[tap][k][n] for the
// forward (K = Ci, N = Co) and w[tap][n][k] for d_in (TRANS: K = Co, N = Ci).
template <int CI, int CO, bool TRANS>
__device__ __forceinline__ float2 weight_pair(const float* __restrict__ w, int i) {
  constexpr int KD = TRANS ? CO : CI, ND = TRANS ? CI : CO;
  constexpr int KC = KD / 8, NF = ND / 8;
  const int lane = i % 32, nf = (i / 32) % NF, kc = (i / (32 * NF)) % KC;
  const int tap = i / (32 * NF * KC);
  const int k0 = kc * 8 + lane % 4, n = nf * 8 + lane / 4;
  const float* wt = w + tap * CI * CO;
  return TRANS ? make_float2(wt[n * CO + k0], wt[n * CO + k0 + 4])
               : make_float2(wt[k0 * CO + n], wt[(k0 + 4) * CO + n]);
}

// ------------------------------------------------------------------ tile staging
// cp.async copies global -> shared without registers; a source size of 0
// writes 16 zero bytes (pixels outside the image).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int tile, int tiles_y, int tiles_x) {
  const int r = tile % (tiles_y * tiles_x);
  return {tile / (tiles_y * tiles_x), (r / tiles_x) * TH, (r % tiles_x) * TW};
}

// Chunk i (CW channels, 16 bytes of float32 or of bf16) of a staged tile of
// C channels: its pixel q, its channel group c4 and its image position; HALO
// tiles are (TH+2) x (TW+2) pixels from (y0-1, x0-1), the others TH x TW
// from (y0, x0).
template <bool HALO, int C, int CW = 4>
struct Chunk {
  static constexpr int C4 = C / CW, NPIX = HALO ? HALO_N : NT, TOTAL = NPIX * C4;
  int q, c4, gy, gx;
  bool inside;
  __device__ __forceinline__ Chunk(int i, const Tile& T, int H, int W) {
    q = i / C4;
    c4 = i % C4;
    constexpr int RW = HALO ? HALO_W : TW, OFF = HALO ? 1 : 0;
    gy = T.y0 + q / RW - OFF;
    gx = T.x0 + q % RW - OFF;
    inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
};

// Start this thread's cp.async copies of a tile of float32 `src` [B,H,W,C]
// into s [NPIX][S]; they land at cp_async_wait_all.
template <bool HALO, int C, int S>
__device__ __forceinline__ void copy_tile(const float* __restrict__ src, float* s,
                                          const Tile& T, int H, int W) {
  for (int i = threadIdx.x; i < Chunk<HALO, C>::TOTAL; i += NT) {
    const Chunk<HALO, C> k(i, T, H, W);
    const float* from =
        k.inside ? src + (((size_t)T.b * H + k.gy) * W + k.gx) * C + k.c4 * 4 : src;
    cp_async16(s + k.q * S + k.c4 * 4, from, k.inside);
  }
}

// After this thread's copies landed: v = f(v, offset, c4) on its own chunks
// inside the image (those outside stay 0).
template <bool HALO, int C, int S, class F>
__device__ __forceinline__ void transform_tile(float* s, const Tile& T, int H, int W, F f) {
  for (int i = threadIdx.x; i < Chunk<HALO, C>::TOTAL; i += NT) {
    const Chunk<HALO, C> k(i, T, H, W);
    if (!k.inside) continue;
    const int off = k.q * S + k.c4 * 4;
    st4(s + off, f(ld4(s + off), off, k.c4));
  }
}

// relu(v*inv + shift) (RELU) or v*inv + shift, channels c4*4..c4*4+3
template <bool RELU>
__device__ __forceinline__ float4 bn4(float4 v, const float* inv, const float* shift) {
  v.x = bn_apply(v.x, inv[0], shift[0]);
  v.y = bn_apply(v.y, inv[1], shift[1]);
  v.z = bn_apply(v.z, inv[2], shift[2]);
  v.w = bn_apply(v.w, inv[3], shift[3]);
  if (RELU) v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
  return v;
}

// Shared memory of the float32 conv kernels, in floats: the backward
// double-buffers its tiles where both copies fit beside the weights (and, for
// the dwdx form, the single z tile).
template <int CI, int CO>
__host__ __device__ constexpr int fwd_smem_floats() {
  return 2 * 9 * CI * CO + 2 * HALO_N * (CI + PAD);
}

template <int CI, int CO, bool PREV>
__host__ __device__ constexpr int bwd_smem_floats(int buffers) {
  return 9 * CI * CO + buffers * (HALO_N * (CO + PAD) + NT * (CI + 2 * PAD)) +
         (PREV ? 0 : HALO_N * (CO + PAD));
}

template <int CI, int CO, bool PREV>
__host__ __device__ constexpr int bwd_buffers() {
  return 4 * bwd_smem_floats<CI, CO, PREV>(2) <= 220 * 1024 ? 2 : 1;
}

// Blocks per SM to size registers for (__launch_bounds__): two where two
// blocks' shared memory fits, else one, which leaves a thread 255 registers.
__host__ __device__ constexpr int min_blocks(int smem_floats) {
  return 4 * smem_floats <= 110 * 1024 ? 2 : 1;
}

// ------------------------------------------------------------------ forward conv
// float32: out = conv3x3(act(in), w), zero padding 1, plus per-block partial
// sums of out and out^2 per channel. act = relu(in*inv+shift) when BN_IN, else
// identity.
template <int CI, int CO, bool BN_IN>
__global__ void __launch_bounds__(NT, min_blocks(fwd_smem_floats<CI, CO>()))
conv_fwd_kernel(const float* __restrict__ in, const float* __restrict__ coef,
                const float* __restrict__ w, float* __restrict__ out,
                double* __restrict__ partial, int B, int H, int W) {
  constexpr int SI = CI + PAD;          // pixel stride: the A loads hit 32 distinct banks
  constexpr int KC = CI / 8, NF = CO / 8;
  extern __shared__ __align__(16) float smem[];
  uint4* s_wf = reinterpret_cast<uint4*>(smem);     // [9][KC][NF][32] B fragments, split
  float* const s_buf = smem + 2 * 9 * CI * CO;      // two input halo tiles [HALO_N][SI]
  __shared__ float s_coef[2 * CI];
  __shared__ double s_tot[NWARP * 2 * CO];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 9 * CI * CO / 2; i += NT) {  // split once: {hi, hi, lo, lo}
    const float2 p = weight_pair<CI, CO, false>(w, i);
    const Split a = split(p.x), c = split(p.y);
    s_wf[i] = make_uint4(a.hi, c.hi, a.lo, c.lo);
  }
  if constexpr (BN_IN) {
    for (int i = tid; i < 2 * CI; i += NT) s_coef[i] = coef[i];
  }
  for (int i = tid; i < NWARP * 2 * CO; i += NT) s_tot[i] = 0.0;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  // this thread's copies of `tile` into buffer `into`
  auto copy = [&](int tile, int into) {
    copy_tile<true, CI, SI>(in, s_buf + into * HALO_N * SI, tile_at(tile, tiles_y, tiles_x), H,
                            W);
  };
  // BN and ReLU inside the image
  auto bn_relu = [&](float4 v, int, int c4) {
    return bn4<true>(v, s_coef + c4 * 4, s_coef + CI + c4 * 4);
  };
  __syncthreads();  // s_coef is read by other threads' transforms
  if ((int)blockIdx.x < ntiles) copy(blockIdx.x, 0);
  cp_async_commit();

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const Tile T = tile_at(tile, tiles_y, tiles_x);
    const int b = T.b, y0 = T.y0, x0 = T.x0;
    float* s_in = s_buf + buf * HALO_N * SI;
    cp_async_wait_all();
    if constexpr (BN_IN) {  // zeros outside the image stay 0
      transform_tile<true, CI, SI>(s_in, T, H, W, bn_relu);
    }
    __syncthreads();  // this tile is staged; every thread is done with the other buffer
    // the next tile's copies run under this tile's MMAs
    if (tile + (int)gridDim.x < ntiles) copy(tile + gridDim.x, buf ^ 1);
    cp_async_commit();

    float acc[2][NF][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][nf][k] = 0.f;
    // pixel (row 2*warp+mi, column g or g+8) reads halo (row+u, column+v):
    // for one v the warp's two rows need halo rows 2*warp..2*warp+3, split
    // once and used by all three u
#pragma unroll 1
    for (int v = 0; v < 3; ++v) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        FragA ar[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* p = s_in + ((2 * warp + r) * HALO_W + g + v) * SI + kc * 8 + t;
          ar[r] = frag_a(p[0], p[8 * SI], p[4], p[8 * SI + 4]);
        }
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          FragB bf[NF];
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            const uint4 q = s_wf[(((3 * u + v) * KC + kc) * NF + nf) * 32 + lane];
            bf[nf] = {{q.x, q.y}, {q.z, q.w}};
          }
          mma3<2, NF>(acc, ar + u, bf);
        }
      }
    }

    // epilogue: pixel (row 2*warp+mi, column g + 8*h), channels nf*8 + 2t + j
    float s0[NF][2], s1[NF][2];
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) s0[nf][0] = s0[nf][1] = s1[nf][0] = s1[nf][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gy = y0 + 2 * warp + mi, gx = x0 + g + 8 * h;
        if (gy >= H || gx >= W) continue;  // outside the image: not stored, not summed
        float* o = out + (((size_t)b * H + gy) * W + gx) * CO + 2 * t;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const float z0 = acc[mi][nf][2 * h], z1 = acc[mi][nf][2 * h + 1];
          store2(o + nf * 8, z0, z1);
          s0[nf][0] += z0;
          s0[nf][1] += z1;
          s1[nf][0] = fmaf(z0, z0, s1[nf][0]);
          s1[nf][1] = fmaf(z1, z1, s1[nf][1]);
        }
      }
    add_tile_sums<NF>(s0, 0, s_tot, CO);
    add_tile_sums<NF>(s1, 1, s_tot, CO);
  }
  cp_async_wait_all();
  write_sum_partials(s_tot, CO, partial);
}

// ------------------------------------------------------------------ backward conv
// float32. For a forward z = conv3x3(a, w) with a [.., CI], z [.., CO], given g = dz:
//   d_in[p, ci]      = sum_{u,v,co} g[p-(u-1,v-1), co] * w[u,v,ci,co]
//   dW[u,v,ci,co]    = sum_p a[p, ci] * g[p-(u-1,v-1), co]
// PREV (the dwprev pass, CI == CO): a = relu(zprev*inv+shift) recomputed,
//   g = g_src; d_in is masked by [y >= 0] and its sums with zprev are taken.
// !PREV (the dwdx pass): a = a_src, g = c0*g_src + c1 + c2*g_z inside the image.
template <int CI, int CO, bool PREV>
__global__ void __launch_bounds__(
    NT, min_blocks(bwd_smem_floats<CI, CO, PREV>(bwd_buffers<CI, CO, PREV>())))
conv_bwd_kernel(const float* __restrict__ a_src, const float* __restrict__ a_coef,
                const float* __restrict__ g_src, const float* __restrict__ g_z,
                const float* __restrict__ g_coef, const float* __restrict__ w,
                float* __restrict__ d_in, float* __restrict__ dw_partial,
                double* __restrict__ sum_partial, int B, int H, int W) {
  constexpr int SG = CO + PAD;          // d_in's A loads conflict-free, dW's B loads <= 2-way
  constexpr int SA = CI + 2 * PAD;      // dW's A loads (pixel along t) conflict-free
  constexpr int KCI = CO / 8, NFI = CI / 8;   // d_in: K chunks over co, N fragments over ci
  // dW: warp -> (16-ci block mt, 8-co block nt) and a group of RPG tile rows
  constexpr int MT = CI / 16, NTW = CO / 8, PAIRS = MT * NTW;
  constexpr int KG = NWARP / PAIRS, RPG = TH / KG;
  static_assert(PAIRS * KG == NWARP && KG * RPG == TH, "dW warp mapping");
  static_assert(!PREV || CI == CO, "the dwprev pass has CI == CO");
  constexpr int NBUF = bwd_buffers<CI, CO, PREV>();
  constexpr bool PREFETCH = NBUF == 2;              // the next tile's copies under this one's
  constexpr int BUF = HALO_N * SG + NT * SA;        // one gradient halo tile + one activation tile
  extern __shared__ __align__(16) float smem[];
  float2* s_wf = reinterpret_cast<float2*>(smem);   // [9][KCI][NFI][32] B fragments of d_in
  float* const s_buf = smem + 9 * CI * CO;          // NBUF x {g halo [HALO_N][SG], a [NT][SA]}
  float* const s_z = s_buf + NBUF * BUF;            // !PREV: z0 halo [HALO_N][SG]
  __shared__ float s_coef[3 * CO];
  __shared__ double s_tot[NWARP * 2 * CI];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 9 * CI * CO / 2; i += NT) s_wf[i] = weight_pair<CI, CO, true>(w, i);
  if constexpr (PREV) {
    for (int i = tid; i < 2 * CI; i += NT) s_coef[i] = a_coef[i];
  } else {
    for (int i = tid; i < 3 * CO; i += NT) s_coef[i] = g_coef[i];
  }
  for (int i = tid; i < NWARP * 2 * CI; i += NT) s_tot[i] = 0.0;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  const int pair = warp % PAIRS, kg = warp / PAIRS;
  const int mt = pair / NTW, nt = pair % NTW;

  // copies of one tile: g (halo) and a into buffer `into`, z0 (halo) for dwdx
  auto copy = [&](int tile, int into) {
    const Tile T = tile_at(tile, tiles_y, tiles_x);
    copy_tile<true, CO, SG>(g_src, s_buf + into * BUF, T, H, W);
    copy_tile<false, CI, SA>(a_src, s_buf + into * BUF + HALO_N * SG, T, H, W);
    if constexpr (!PREV) copy_tile<true, CO, SG>(g_z, s_z, T, H, W);
  };
  // PREV: y0 = BN(z0) before the ReLU (the mask needs its sign)
  auto bn_only = [&](float4 v, int, int c4) {
    return bn4<false>(v, s_coef + c4 * 4, s_coef + CI + c4 * 4);
  };
  // !PREV: dz0 = c0*dy0 + c1 + c2*z0
  auto dz0_of = [&](float4 v, float4 z, int c4) {
    const float* k0 = s_coef + c4 * 4;
    const float* k1 = s_coef + CO + c4 * 4;
    const float* k2 = s_coef + 2 * CO + c4 * 4;
    return make_float4(bn_bwd(v.x, z.x, k0[0], k1[0], k2[0]), bn_bwd(v.y, z.y, k0[1], k1[1], k2[1]),
                       bn_bwd(v.z, z.z, k0[2], k1[2], k2[2]), bn_bwd(v.w, z.w, k0[3], k1[3], k2[3]));
  };

  // tap (u, v) at dw[u][0][v]: one mma3 block per kernel row. The MMAs of one
  // tile accumulate into dwt, which is then added to the block's running sum
  // dw on the CUDA cores: one tensor-core chain through every tile of the
  // block (hundreds at B=96) lost accuracy in proportion to the batch
  // (scripts/measure_stage_accuracy.py).
  float dw[3][1][3][4], dwt[3][1][3][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int k = 0; k < 4; ++k) dw[tap / 3][0][tap % 3][k] = 0.f;
  __syncthreads();  // s_coef is read by other threads' transforms
  if (PREFETCH && (int)blockIdx.x < ntiles) copy(blockIdx.x, 0);
  cp_async_commit();

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= NBUF - 1) {
    const Tile T = tile_at(tile, tiles_y, tiles_x);
    const int b = T.b, y0 = T.y0, x0 = T.x0;
    float* s_g = s_buf + buf * BUF;
    float* s_a = s_g + HALO_N * SG;
    if constexpr (!PREFETCH) {
      __syncthreads();  // every thread is done with the previous tile
      copy(tile, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    if constexpr (PREV) {
      transform_tile<false, CI, SA>(s_a, T, H, W, bn_only);
    } else {  // inside the image
      transform_tile<true, CO, SG>(s_g, T, H, W, [&](float4 v, int off, int c4) {
        return dz0_of(v, ld4(s_z + off), c4);
      });
    }
    __syncthreads();  // this tile is staged; every thread is done with the other buffer
    if constexpr (PREFETCH) {  // the next tile's copies run under this tile's MMAs
      if (tile + (int)gridDim.x < ntiles) copy(tile + gridDim.x, buf ^ 1);
      cp_async_commit();
    }

    // ---- dW: rows y0g.., 8 pixels per k step; A(ci, p) = a[p][ci] is
    // shared by the nine taps, B(p, co) = g at halo (y+2-u, x+2-v). Tile row
    // y uses halo rows y..y+2, so the split B fragments of one halo row (its
    // three v shifts) stay in a window of three rows and serve three tile rows.
    const int y0g = kg * RPG;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int k = 0; k < 4; ++k) dwt[tap / 3][0][tap % 3][k] = 0.f;
#pragma unroll 1
    for (int kh = 0; kh < 2; ++kh) {
      FragB win[3][3];  // halo row h at win[(h - y0g) % 3], shift v
      auto load_row = [&](int h, FragB(&dst)[3]) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float* pg = s_g + (h * HALO_W + kh * 8 + t + 2 - v) * SG + nt * 8 + g;
          dst[v] = frag_b(pg[0], pg[4 * SG]);
        }
      };
      load_row(y0g, win[0]);
      load_row(y0g + 1, win[1]);
#pragma unroll
      for (int yy = 0; yy < RPG; ++yy) {
        load_row(y0g + yy + 2, win[(yy + 2) % 3]);
        const float* pa = s_a + ((y0g + yy) * TW + kh * 8 + t) * SA + mt * 16 + g;
        float av[4] = {pa[0], pa[8], pa[4 * SA], pa[4 * SA + 8]};
        if constexpr (PREV) {  // a = relu(y); pixels outside the image hold 0
#pragma unroll
          for (int k = 0; k < 4; ++k) av[k] = fmaxf(av[k], 0.f);
        }
        const FragA af = frag_a(av[0], av[1], av[2], av[3]);
#pragma unroll
        for (int u = 0; u < 3; ++u) mma3<1, 3>(dwt[u], &af, win[(yy + 2 - u) % 3]);
      }
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int k = 0; k < 4; ++k) dw[tap / 3][0][tap % 3][k] += dwt[tap / 3][0][tap % 3][k];

    // ---- d_in: pixel (row 2*warp+mi, column g / g+8), every input channel
    float acc[2][NFI][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nf = 0; nf < NFI; ++nf)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][nf][k] = 0.f;
    // pixel (row 2*warp+mi, column g / g+8) reads halo (row+2-u, column+2-v):
    // halo rows 2*warp..2*warp+3, split once per (v, kc) and used by all u
#pragma unroll 1
    for (int v = 0; v < 3; ++v) {
#pragma unroll
      for (int kc = 0; kc < KCI; ++kc) {
        FragA ar[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* p = s_g + ((2 * warp + r) * HALO_W + g + 2 - v) * SG + kc * 8 + t;
          ar[r] = frag_a(p[0], p[8 * SG], p[4], p[8 * SG + 4]);
        }
        float part[2][NFI][4] = {};  // one chain over the three u, then added
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          FragB bf[NFI];
#pragma unroll
          for (int nf = 0; nf < NFI; ++nf) {
            const float2 bw = s_wf[(((3 * u + v) * KCI + kc) * NFI + nf) * 32 + lane];
            bf[nf] = frag_b(bw.x, bw.y);
          }
          mma3<2, NFI>(part, ar + 2 - u, bf);
        }
        add_rn<2, NFI>(acc, part);
      }
    }

    float s0[NFI][2], s1[NFI][2];
#pragma unroll
    for (int nf = 0; nf < NFI; ++nf) s0[nf][0] = s0[nf][1] = s1[nf][0] = s1[nf][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int py = 2 * warp + mi, px = g + 8 * h;
        const int gy = y0 + py, gx = x0 + px;
        if (gy >= H || gx >= W) continue;  // outside the image: not stored, not summed
        const size_t own = (((size_t)b * H + gy) * W + gx) * CI + 2 * t;
#pragma unroll
        for (int nf = 0; nf < NFI; ++nf) {
          float d0 = acc[mi][nf][2 * h], d1 = acc[mi][nf][2 * h + 1];
          if constexpr (PREV) {  // ReLU mask from this pixel's own y; sums with zprev
            const float2 yv =
                *reinterpret_cast<const float2*>(s_a + (py * TW + px) * SA + nf * 8 + 2 * t);
            const float2 z = load2(a_src + own + nf * 8);
            if (!(yv.x >= 0.f)) d0 = 0.f;
            if (!(yv.y >= 0.f)) d1 = 0.f;
            s0[nf][0] += d0;
            s0[nf][1] += d1;
            s1[nf][0] += d0 * z.x;
            s1[nf][1] += d1 * z.y;
          }
          store2(d_in + own + nf * 8, d0, d1);
        }
      }
    if constexpr (PREV) {
      add_tile_sums<NFI>(s0, 0, s_tot, CI);
      add_tile_sums<NFI>(s1, 1, s_tot, CI);
    }
  }

  // dW partial of this block: the KG row groups' accumulators added in group
  // order through shared memory (the tiles' buffers are free now)
  cp_async_wait_all();
  __syncthreads();
  float* s_dw = smem;  // [KG][9][CI][CO]
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ci = mt * 16 + g + 8 * (k >> 1), co = nt * 8 + 2 * t + (k & 1);
      s_dw[((kg * 9 + tap) * CI + ci) * CO + co] = dw[tap / 3][0][tap % 3][k];
    }
  __syncthreads();
  for (int i = tid; i < 9 * CI * CO; i += NT) {
    float s = 0.f;
    for (int k = 0; k < KG; ++k) s += s_dw[k * 9 * CI * CO + i];
    dw_partial[(size_t)blockIdx.x * 9 * CI * CO + i] = s;
  }
  if constexpr (PREV) write_sum_partials(s_tot, CI, sum_partial);
}

// ------------------------------------------------------------------ bf16 on bf16 tensor cores
// The four convolution passes in bfloat16: bf16 tiles in shared memory, never
// widened, fed to mma.sync.m16n8k16 (bf16 in, float32 out) through ldmatrix.
// Two templates: conv_fwd_bf16_kernel (conv, and bnconv with BN_IN) and
// conv_bwd_bf16_kernel (dwdx, and dwprev with PREV), over Ci -> Co in
// {16 -> 16, 16 -> 32, 32 -> 32}.
//
// Tiles. A halo tile and the backward's activation tile are staged as bf16
// with 16-byte cp.async.cg copies (8 channels a chunk, zeros for pixels
// outside the image) into one of two buffers, so the next tile's copies run
// under this tile's MMAs. A pixel row is padded by BPAD bf16 (16 bytes):
// strides of 48 B (16 channels) and 80 B (32) put the eight 16-byte rows of
// an ldmatrix phase on eight distinct bank groups. The thread that copied a
// chunk then transforms it in float32 and rounds back to bf16 in place,
// inside the image only (halo zeros stay 0: BN(0) is not 0, nor is dz0 at
// dy0 = z0 = 0); one barrier a tile. The transforms: BN + ReLU (bnconv,
// dwprev's activation) and dz0 = c0*dy0 + c1 + c2*z0 (dwdx's gradient, from
// a z0 halo tile of one unpadded buffer: only the transform reads it, so
// its next copy is issued after the tile's barrier with the others).
// dwprev's ReLU mask [y0 >= 0] is taken there from the unrounded float32 y0
// and kept as one bit per channel in the pixel's padding (a tiny negative y0
// would round to -0.0 in bf16, and -0.0 >= 0 holds).
constexpr int BPAD = 8;  // bf16 of padding per shared-memory pixel row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: lane l gives the address of row l % 8 of 8x8 matrix l / 8 (16
// bytes, 8 bf16); lane (g, t) receives elements (g, 2t..2t+1) of each matrix,
// or with .trans elements (2t..2t+1, g)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a b, m16n8k16, bf16 operands (two a 32-bit word, the lower k in the
// low half), float32 accumulation. A (16x16): a0 (g, 2t..), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..); B (16x8): b0 (2t.., g), b1 (2t+8.., g);
// C/D as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Weights [3,3,CI,CO] rounded to bf16 as m16n8k16 B fragments of a K x N
// product, two 8-column blocks a 16-byte entry: entry ((tap*KC + kc)*NP +
// j)*32 + lane holds, for nf = 2j and 2j+1, {B(k0, n), B(k0+1, n)} and
// {B(k0+8, n), B(k0+9, n)} with k0 = kc*16 + 2t, n = nf*8 + g. Forward: K =
// CI, N = CO, B(k, n) = w[tap][k][n]; TRANS (d_in): K = CO, N = CI, B(k, n) =
// w[tap][n][k]. w[tap] is [CI][CO], row stride CO in both.
template <int CI, int CO, bool TRANS>
__device__ __forceinline__ uint4 weight_frag_bf16(const float* __restrict__ w, int i) {
  constexpr int KC = (TRANS ? CO : CI) / 16, NP = (TRANS ? CI : CO) / 16;
  const int lane = i % 32, j = (i / 32) % NP, kc = (i / (32 * NP)) % KC;
  const int tap = i / (32 * NP * KC);
  const int k0 = kc * 16 + 2 * (lane % 4);
  const float* wt = w + tap * CI * CO;
  auto at = [&](int k, int n) { return TRANS ? wt[n * CO + k] : wt[k * CO + n]; };
  uint32_t r[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = (2 * j + h) * 8 + lane / 4;
    r[2 * h] = f2_to_bf2(at(k0, n), at(k0 + 1, n));
    r[2 * h + 1] = f2_to_bf2(at(k0 + 8, n), at(k0 + 9, n));
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// The ND / 8 B fragments of (tap, kc) of a K = KD, N = ND product from
// weight_frag_bf16's layout
template <int KD, int ND>
__device__ __forceinline__ void load_wfrag(const uint4* s_wf, int tap, int kc, int lane,
                                           uint32_t (&b)[ND / 8][2]) {
  constexpr int KC = KD / 16, NP = ND / 16;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const uint4 q = s_wf[((tap * KC + kc) * NP + j) * 32 + lane];
    b[2 * j][0] = q.x;
    b[2 * j][1] = q.y;
    b[2 * j + 1][0] = q.z;
    b[2 * j + 1][1] = q.w;
  }
}

// Start this thread's 16-byte cp.async copies of a bf16 tile of `src`
// [B,H,W,C] (8 channels a chunk) into s [NPIX][S]; outside the image: zeros.
template <bool HALO, int C, int S>
__device__ __forceinline__ void copy_tile_bf16(const bf16* __restrict__ src, bf16* s,
                                               const Tile& T, int H, int W) {
  for (int i = threadIdx.x; i < Chunk<HALO, C, 8>::TOTAL; i += NT) {
    const Chunk<HALO, C, 8> k(i, T, H, W);
    const bf16* from =
        k.inside ? src + (((size_t)T.b * H + k.gy) * W + k.gx) * C + k.c4 * 8 : src;
    cp_async16(s + k.q * S + k.c4 * 8, from, k.inside);
  }
}

// 8 bf16 (16 bytes) widened to floats
__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f2 = bf2_to_f2(w4[j]);
    v[2 * j] = f2.x;
    v[2 * j + 1] = f2.y;
  }
}

// After this thread's copies landed: f(v, q, c8) on the 8 values (widened)
// of each of its own chunks inside the image, rounded back to bf16 in place;
// chunks outside stay 0.
template <bool HALO, int C, int S, class F>
__device__ __forceinline__ void transform_tile_bf16(bf16* s, const Tile& T, int H, int W, F f) {
  for (int i = threadIdx.x; i < Chunk<HALO, C, 8>::TOTAL; i += NT) {
    const Chunk<HALO, C, 8> k(i, T, H, W);
    if (!k.inside) continue;
    uint4* p = reinterpret_cast<uint4*>(s + k.q * S + k.c4 * 8);
    float v[8];
    unpack8(*p, v);
    f(v, k.q, k.c4);
    *p = make_uint4(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]), f2_to_bf2(v[4], v[5]),
                    f2_to_bf2(v[6], v[7]));
  }
}

// Dynamic shared memory (bytes) of the two kernels: the B fragments, two
// buffers of each tile, and dwdx's (!PREV) z0 halo tile.
template <int CI, int CO>
__host__ __device__ constexpr int fwd_bf16_smem() {
  return 9 * CI * CO * 2 + 2 * HALO_N * (CI + BPAD) * 2;
}

template <int CI, int CO, bool PREV>
__host__ __device__ constexpr int bwd_bf16_smem() {
  return 9 * CI * CO * 2 + 2 * (HALO_N * (CO + BPAD) + NT * (CI + BPAD)) * 2 +
         (PREV ? 0 : HALO_N * CO * 2);
}

// Blocks per SM that __launch_bounds__ sizes the registers for: the forward
// 4 at 16 -> 16 (64 registers) and 2 with 32 output channels (bnconv C32 at
// 3, 80 registers, spilled and ran 8% slower on the H100); the backward 2
// with 16 input channels and 1 with 32: dW's running and per-tile sums alone
// hold 72 floats a thread. Each fits the SM's 228 KB of shared memory (a
// block: its dynamic bytes, its static sums, at most 4.5 KB, and 1 KB the
// card reserves).
template <int CI, int CO>
constexpr int fwd_bf16_blocks = CI == 16 && CO == 16 ? 4 : 2;
template <int CI>
constexpr int bwd_bf16_blocks = CI == 16 ? 2 : 1;
static_assert(4 * (fwd_bf16_smem<16, 16>() + 5632) <= 228 * 1024 &&
                  2 * (fwd_bf16_smem<16, 32>() + 5632) <= 228 * 1024 &&
                  2 * (fwd_bf16_smem<32, 32>() + 5632) <= 228 * 1024 &&
                  2 * (bwd_bf16_smem<16, 16, true>() + 5632) <= 228 * 1024 &&
                  2 * (bwd_bf16_smem<16, 16, false>() + 5632) <= 228 * 1024 &&
                  2 * (bwd_bf16_smem<16, 32, false>() + 5632) <= 228 * 1024,
              "the blocks per SM fit in shared memory");

// bf16 forward: out = conv3x3(act(in), w rounded to bf16), stored in bf16,
// plus per-block partial sums of the float32 out and out^2; act =
// relu(in*inv+shift) rounded to bf16 (BN_IN: bnconv, CI == CO), else the
// input as stored (conv). Implicit GEMM as conv_fwd_kernel's: M = 16 pixels
// of a tile row, N = CO, K = 16 input channels a step, warp w owns tile rows
// 2w, 2w+1; an A fragment (one ldmatrix.x4) of each of the four halo rows
// 2w..2w+3 serves the three taps u of a kernel column v.
template <int CI, int CO, bool BN_IN>
__global__ void __launch_bounds__(NT, fwd_bf16_blocks<CI, CO>)
conv_fwd_bf16_kernel(const bf16* __restrict__ in, const float* __restrict__ coef,
                     const float* __restrict__ w, bf16* __restrict__ out,
                     double* __restrict__ partial, int B, int H, int W) {
  static_assert(!BN_IN || CI == CO, "the bnconv pass has CI == CO");
  constexpr int S = CI + BPAD;
  constexpr int KC = CI / 16, NF = CO / 8;
  constexpr int TILE = HALO_N * S;
  extern __shared__ __align__(16) float smem[];
  uint4* const s_wf = reinterpret_cast<uint4*>(smem);               // [9][KC][NF/2][32]
  bf16* const s_tiles = reinterpret_cast<bf16*>(smem) + 9 * CI * CO;  // 2 x [HALO_N][S]
  __shared__ float s_coef[2 * CI];
  __shared__ double s_tot[NWARP * 2 * CO];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 9 * CI * CO / 8; i += NT) s_wf[i] = weight_frag_bf16<CI, CO, false>(w, i);
  if constexpr (BN_IN) {
    for (int i = tid; i < 2 * CI; i += NT) s_coef[i] = coef[i];
  }
  for (int i = tid; i < NWARP * 2 * CO; i += NT) s_tot[i] = 0.0;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  auto copy = [&](int tile, int into) {
    copy_tile_bf16<true, CI, S>(in, s_tiles + into * TILE, tile_at(tile, tiles_y, tiles_x), H,
                                W);
  };
  // BN and ReLU (rounded to bf16 by the store: the product's operand)
  auto bn_relu = [&](float (&v)[8], int, int c8) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = fmaxf(bn_apply(v[j], s_coef[c8 * 8 + j], s_coef[CI + c8 * 8 + j]), 0.f);
  };
  __syncthreads();  // s_coef is read by other threads' transforms
  if ((int)blockIdx.x < ntiles) copy(blockIdx.x, 0);
  cp_async_commit();
  // this lane's ldmatrix row: pixel column lrow of the M block, channel lk of the K step
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const Tile T = tile_at(tile, tiles_y, tiles_x);
    bf16* const s_in = s_tiles + buf * TILE;
    cp_async_wait_all();
    if constexpr (BN_IN) transform_tile_bf16<true, CI, S>(s_in, T, H, W, bn_relu);
    __syncthreads();  // this tile is staged; every thread is done with the other buffer
    // the next tile's copies run under this tile's MMAs
    if (tile + (int)gridDim.x < ntiles) copy(tile + gridDim.x, buf ^ 1);
    cp_async_commit();

    float acc[2][NF][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][nf][k] = 0.f;
    // pixel (row 2w+mi, column m) reads halo (row+u, m+v)
    const uint32_t a_base = smem_u32(s_in + (2 * warp * HALO_W + lrow) * S + lk);
#pragma unroll 1
    for (int v = 0; v < 3; ++v) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ar[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ldsm_x4(ar[r], a_base + ((r * HALO_W + v) * S + kc * 16) * 2);
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          uint32_t bw[NF][2];
          load_wfrag<CI, CO>(s_wf, 3 * u + v, kc, lane, bw);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int nf = 0; nf < NF; ++nf) mma_bf16(acc[mi][nf], ar[mi + u], bw[nf]);
        }
      }
    }

    // epilogue: pixel (row 2*warp+mi, column g + 8*h), channels nf*8 + 2t + j;
    // stored in bf16, summed from the float32 accumulators
    float s0[NF][2], s1[NF][2];
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) s0[nf][0] = s0[nf][1] = s1[nf][0] = s1[nf][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gy = T.y0 + 2 * warp + mi, gx = T.x0 + g + 8 * h;
        if (gy >= H || gx >= W) continue;  // outside the image: not stored, not summed
        bf16* o = out + (((size_t)T.b * H + gy) * W + gx) * CO + 2 * t;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const float z0 = acc[mi][nf][2 * h], z1 = acc[mi][nf][2 * h + 1];
          store2(o + nf * 8, z0, z1);
          s0[nf][0] += z0;
          s0[nf][1] += z1;
          s1[nf][0] = fmaf(z0, z0, s1[nf][0]);
          s1[nf][1] = fmaf(z1, z1, s1[nf][1]);
        }
      }
    add_tile_sums<NF>(s0, 0, s_tot, CO);
    add_tile_sums<NF>(s1, 1, s_tot, CO);
  }
  cp_async_wait_all();
  write_sum_partials(s_tot, CO, partial);
}

// bf16 backward, for a forward z = conv3x3(a, w) with a [.., CI], z [.., CO]
// and w rounded to bf16, given g = dz (both operands bf16 values):
//   dW[u,v,ci,co] = sum_p a[p, ci] * g[p-(u-1,v-1), co]
//   d_in[p, ci]   = sum_{u,v,co} g[p-(u-1,v-1), co] * w[u,v,ci,co]
// PREV (dwprev, CI == CO): a = relu(y0) rounded to bf16, y0 = zprev*inv +
//   shift, g = dz1 as stored; d_in = dy0 is masked by [y0 >= 0], and per-block
//   partial sums of the float32 dy0 and dy0*zprev are taken.
// !PREV (dwdx): a = x as stored, g = dz0 = c0*dy0 + c1 + c2*z0 rounded to
//   bf16 inside the image; d_in = dx, no mask, no sums.
// d_in is stored in bf16.
//   dW: nine GEMMs, M = 16 ci, N = 8 co, K = the 16 pixels of one tile row:
//       A(ci, p) = a[p][ci] (ldmatrix.x4.trans of the activation tile),
//       B(p, co) = g at halo (y+2-u, x+2-v) (ldmatrix.x2.trans); warp ->
//       (16-ci block, 8-co block, group of RPG tile rows) as conv_bwd_kernel,
//       the B fragments of three halo rows kept as a window sliding down;
//       accumulated per tile, then added to the block's sum on the CUDA cores.
//   d_in: implicit GEMM as the forward's, M = 16 pixels, K = CO (16-channel
//       chunks of the g tile), N = CI with the transposed weights, warp w
//       owning rows 2w, 2w+1; each (v, 16-channel k chunk) is one chain of
//       three k16 MMAs into a fresh accumulator, added with add_rn.
template <int CI, int CO, bool PREV>
__global__ void __launch_bounds__(NT, bwd_bf16_blocks<CI>)
conv_bwd_bf16_kernel(const bf16* __restrict__ a_src, const float* __restrict__ a_coef,
                     const bf16* __restrict__ g_src, const bf16* __restrict__ g_z,
                     const float* __restrict__ g_coef, const float* __restrict__ w,
                     bf16* __restrict__ d_in, float* __restrict__ dw_partial,
                     double* __restrict__ sum_partial, int B, int H, int W) {
  static_assert(!PREV || CI == CO, "the dwprev pass has CI == CO");
  constexpr int SG = CO + BPAD, SA = CI + BPAD;  // pixel strides of the g and a tiles
  constexpr int KCI = CO / 16, NFI = CI / 8;     // d_in: K chunks over co, N fragments over ci
  constexpr int MT = CI / 16, NTW = CO / 8, PAIRS = MT * NTW;
  constexpr int KG = NWARP / PAIRS, RPG = TH / KG;
  static_assert(PAIRS * KG == NWARP && KG * RPG == TH, "dW warp mapping");
  constexpr int GT = HALO_N * SG, AT = NT * SA;
  static_assert(9 * CI * CO * 4 * KG <= bwd_bf16_smem<CI, CO, PREV>(), "dW partials fit");
  extern __shared__ __align__(16) float smem[];
  uint4* const s_wf = reinterpret_cast<uint4*>(smem);  // [9][KCI][NFI/2][32], d_in's
  bf16* const s_gt = reinterpret_cast<bf16*>(smem) + 9 * CI * CO;  // 2 x g halo [HALO_N][SG]
  bf16* const s_at = s_gt + 2 * GT;  // 2 x a [NT][SA]; PREV: the mask bytes in each pixel's pad
  bf16* const s_z = s_at + 2 * AT;   // !PREV: z0 halo [HALO_N][CO], one buffer
  __shared__ float s_coef[PREV ? 2 * CI : 3 * CO];
  __shared__ double s_tot[PREV ? NWARP * 2 * CI : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 9 * CI * CO / 8; i += NT) s_wf[i] = weight_frag_bf16<CI, CO, true>(w, i);
  if constexpr (PREV) {
    for (int i = tid; i < 2 * CI; i += NT) s_coef[i] = a_coef[i];
    for (int i = tid; i < NWARP * 2 * CI; i += NT) s_tot[i] = 0.0;
  } else {
    for (int i = tid; i < 3 * CO; i += NT) s_coef[i] = g_coef[i];
  }
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  const int pair = warp % PAIRS, kg = warp / PAIRS;
  const int mt = pair / NTW, nt = pair % NTW;
  auto copy = [&](int tile, int into) {
    const Tile T = tile_at(tile, tiles_y, tiles_x);
    copy_tile_bf16<true, CO, SG>(g_src, s_gt + into * GT, T, H, W);
    copy_tile_bf16<false, CI, SA>(a_src, s_at + into * AT, T, H, W);
    if constexpr (!PREV) copy_tile_bf16<true, CO, CO>(g_z, s_z, T, H, W);
  };
  // ldmatrix rows of this lane: d_in's A (pixel column lrow, channel lk);
  // dW's A (pixel tp, ci offset tc); dW's B (pixel lane % 16)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;
  const int tp = (lane & 7) + (lane >> 4) * 8, tc = ((lane >> 3) & 1) * 8;

  // tap 3u+v; dwt: this tile's MMAs, dw: the block's running sum
  float dw[9][4], dwt[9][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int k = 0; k < 4; ++k) dw[tap][k] = 0.f;
  __syncthreads();  // s_coef is read by other threads' transforms
  if ((int)blockIdx.x < ntiles) copy(blockIdx.x, 0);
  cp_async_commit();

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const Tile T = tile_at(tile, tiles_y, tiles_x);
    bf16* const s_g = s_gt + buf * GT;
    bf16* const s_a = s_at + buf * AT;
    cp_async_wait_all();
    if constexpr (PREV) {
      // a0 = relu(y0) rounded to bf16 in place; the mask [y0 >= 0] of the
      // unrounded y0, bit j of byte c8 in the pixel's pad
      transform_tile_bf16<false, CI, SA>(s_a, T, H, W, [&](float (&v)[8], int q, int c8) {
        unsigned bits = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y = bn_apply(v[j], s_coef[c8 * 8 + j], s_coef[CI + c8 * 8 + j]);
          bits |= (y >= 0.f ? 1u : 0u) << j;
          v[j] = fmaxf(y, 0.f);
        }
        reinterpret_cast<unsigned char*>(s_a + q * SA + CI)[c8] = (unsigned char)bits;
      });
    } else {
      // dz0 rounded to bf16 in place, from the z0 chunk this thread copied
      transform_tile_bf16<true, CO, SG>(s_g, T, H, W, [&](float (&v)[8], int q, int c8) {
        float z[8];
        unpack8(*reinterpret_cast<const uint4*>(s_z + q * CO + c8 * 8), z);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c8 * 8 + j;
          v[j] = bn_bwd(v[j], z[j], s_coef[c], s_coef[CO + c], s_coef[2 * CO + c]);
        }
      });
    }
    __syncthreads();  // this tile is staged; every thread is done with the other buffers
    if (tile + (int)gridDim.x < ntiles) copy(tile + gridDim.x, buf ^ 1);
    cp_async_commit();

    // ---- dW: tile row y = y0g + yy; halo row h at win[(h - y0g) % 3]
    const int y0g = kg * RPG;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int k = 0; k < 4; ++k) dwt[tap][k] = 0.f;
    {
      const uint32_t g_base = smem_u32(s_g + (lane & 15) * SG + nt * 8);
      const uint32_t a_base = smem_u32(s_a + tp * SA + mt * 16 + tc);
      uint32_t win[3][3][2];
      auto load_row = [&](int h, uint32_t(&dst)[3][2]) {
#pragma unroll
        for (int v = 0; v < 3; ++v)
          ldsm_x2_trans(dst[v], g_base + ((h * HALO_W + 2 - v) * SG) * 2);
      };
      load_row(y0g, win[0]);
      load_row(y0g + 1, win[1]);
#pragma unroll
      for (int yy = 0; yy < RPG; ++yy) {
        load_row(y0g + yy + 2, win[(yy + 2) % 3]);
        uint32_t af[4];
        ldsm_x4_trans(af, a_base + ((y0g + yy) * TW * SA) * 2);
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v) mma_bf16(dwt[3 * u + v], af, win[(yy + 2 - u) % 3][v]);
      }
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int k = 0; k < 4; ++k) dw[tap][k] += dwt[tap][k];

    // ---- d_in: pixel (row 2w+mi, column m) reads halo (row+2-u, m+2-v)
    float acc[2][NFI][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nf = 0; nf < NFI; ++nf)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][nf][k] = 0.f;
    // dwdx takes the k chunks one at a time: unrolled, dwdx 16 -> 32 spilled at
    // its 128 registers and ran 9% slower on the H100, while dwprev C32 ran 4%
    // faster unrolled
    const uint32_t d_base = smem_u32(s_g + (2 * warp * HALO_W + lrow) * SG + lk);
#pragma unroll 1
    for (int v = 0; v < 3; ++v) {
#pragma unroll (PREV ? KCI : 1)
      for (int kc = 0; kc < KCI; ++kc) {
        uint32_t ar[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ldsm_x4(ar[r], d_base + ((r * HALO_W + 2 - v) * SG + kc * 16) * 2);
        float part[2][NFI][4] = {};  // one chain over the three u, then added
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          uint32_t bw[NFI][2];
          load_wfrag<CO, CI>(s_wf, 3 * u + v, kc, lane, bw);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int nf = 0; nf < NFI; ++nf) mma_bf16(part[mi][nf], ar[mi + 2 - u], bw[nf]);
        }
        add_rn<2, NFI>(acc, part);
      }
    }

    // epilogue; PREV: masked by this pixel's bits, summed with zprev (of the
    // float32 dy0 before it is stored in bf16)
    float s0[NFI][2], s1[NFI][2];
#pragma unroll
    for (int nf = 0; nf < NFI; ++nf) s0[nf][0] = s0[nf][1] = s1[nf][0] = s1[nf][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int py = 2 * warp + mi, px = g + 8 * h;
        const int gy = T.y0 + py, gx = T.x0 + px;
        if (gy >= H || gx >= W) continue;  // outside the image: not stored, not summed
        const size_t own = (((size_t)T.b * H + gy) * W + gx) * CI + 2 * t;
#pragma unroll
        for (int nf = 0; nf < NFI; ++nf) {
          float d0 = acc[mi][nf][2 * h], d1 = acc[mi][nf][2 * h + 1];
          if constexpr (PREV) {
            const unsigned char* mask =
                reinterpret_cast<const unsigned char*>(s_a + (py * TW + px) * SA + CI);
            const unsigned m = mask[nf] >> (2 * t);
            const float2 z = load2(a_src + own + nf * 8);
            if (!(m & 1u)) d0 = 0.f;
            if (!(m & 2u)) d1 = 0.f;
            s0[nf][0] += d0;
            s0[nf][1] += d1;
            s1[nf][0] += d0 * z.x;
            s1[nf][1] += d1 * z.y;
          }
          store2(d_in + own + nf * 8, d0, d1);
        }
      }
    if constexpr (PREV) {
      add_tile_sums<NFI>(s0, 0, s_tot, CI);
      add_tile_sums<NFI>(s1, 1, s_tot, CI);
    }
  }

  // dW partial of this block: the KG row groups' sums added in group order
  // through shared memory (the tiles' buffers are free now)
  cp_async_wait_all();
  __syncthreads();
  float* s_dw = smem;  // [KG][9][CI][CO]
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ci = mt * 16 + g + 8 * (k >> 1), co = nt * 8 + 2 * t + (k & 1);
      s_dw[((kg * 9 + tap) * CI + ci) * CO + co] = dw[tap][k];
    }
  __syncthreads();
  for (int i = tid; i < 9 * CI * CO; i += NT) {
    float s = 0.f;
    for (int k = 0; k < KG; ++k) s += s_dw[k * 9 * CI * CO + i];
    dw_partial[(size_t)blockIdx.x * 9 * CI * CO + i] = s;
  }
  if constexpr (PREV) write_sum_partials(s_tot, CI, sum_partial);
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

// e is rounded to E before the maximum is taken (rounding keeps the order)
template <class E>
__global__ void __launch_bounds__(NT)
bnpool_kernel(const E* __restrict__ z1, const float* __restrict__ coef,
              E* __restrict__ e, E* __restrict__ p, int B, int H, int W, int C) {
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
      unpack4(load4(z1 + wd.off[j]), z);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        z[k] = rnd<E>(fmaxf(bn_apply(z[k], inv[k], sh[k]), 0.f));
        m[k] = j == 0 ? z[k] : fmaxf(m[k], z[k]);
      }
      store4(e + wd.off[j], make_float4(z[0], z[1], z[2], z[3]));
    }
    store4(p + wd.pooled, make_float4(m[0], m[1], m[2], m[3]));
  }
}

// dy1 of one window: pool backward to the first maximum (among the e rounded
// to E) plus the skip cotangent, masked by [y >= 0]. dp / de may be null (no
// cotangent).
template <class E>
__device__ __forceinline__ void window_dy(const Window& wd, const E* __restrict__ z1,
                                          const float* __restrict__ coef,
                                          const E* __restrict__ dp,
                                          const E* __restrict__ de, int C,
                                          float (&z)[4][4], float (&dy)[4][4]) {
  float inv[4], sh[4], y[4][4], g[4];
  unpack4(ld4(coef + wd.c4 * 4), inv);
  unpack4(ld4(coef + C + wd.c4 * 4), sh);
  if (dp != nullptr) {
    unpack4(load4(dp + wd.pooled), g);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unpack4(load4(z1 + wd.off[j]), z[j]);
    if (de != nullptr) {
      unpack4(load4(de + wd.off[j]), dy[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) dy[j][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) y[j][k] = bn_apply(z[j][k], inv[k], sh[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float e0 = rnd<E>(fmaxf(y[0][k], 0.f)), e1 = rnd<E>(fmaxf(y[1][k], 0.f));
    const float e2 = rnd<E>(fmaxf(y[2][k], 0.f)), e3 = rnd<E>(fmaxf(y[3][k], 0.f));
    const float m = fmaxf(fmaxf(e0, e1), fmaxf(e2, e3));
    const int first = (e0 == m) ? 0 : (e1 == m) ? 1 : (e2 == m) ? 2 : 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float da = dy[j][k] + (j == first ? g[k] : 0.f);
      dy[j][k] = (y[j][k] >= 0.f) ? da : 0.f;
    }
  }
}

// poolsums <- _k_poolsums (spcl_tpu/experimental/packed_block_pallas.py:346):
// (sum dy1, sum dy1*z1) per channel, dy1 = (poolbwd(dp) + de) * [y1 >= 0],
// in float64, in ONE launch.
//
// Bound: the bytes. z1 and de are read once, dp once per window: 2.25 x
// px x C x 4 B with de (0.129 ms at 60x224x224x16, 0.065 ms at
// 60x112x112x32) and 1.25 x px x C x 4 B without it, as on the pretrain path
// (0.072 / 0.036 ms); about 9 operations an element, far below the
// float32 peak.
//
// What set the pace before: a grid of 4 x 2 blocks an SM ended with a serial
// pass over shared memory in every block and a second launch in which one
// block of 2C threads added ~1000 float64 partials each, one L2 load after
// another (0.04-0.06 ms whatever the shape). Here:
//   - Streaming. A lane owns one 16-byte chunk (a pixel, 4 channels) of the
//     upper row of a row pair and the chunk below it; neighbouring lanes hold
//     neighbouring chunks, so every warp load is 512 contiguous bytes. The
//     two columns of a 2x2 window are lanes l and l ^ C/4: one shuffle of the
//     pair's column maxima and one of eight mask bits route dp to the first
//     maximum in scan order (r0,c0),(r0,c1),(r1,c0),(r1,c1). Both lanes of a
//     pair load the window's dp chunk in the same instruction (one request).
//     One kernel per (C, dp present, de present): an absent cotangent's
//     loads, registers and routing are compiled out (the de-absent kernel
//     keeps fewer registers, so more blocks stay resident), and the float64
//     sums of a thread's runs live in shared memory, not in registers. The
//     blocks are persistent: the grid is the clusters resident at once
//     (cudaOccupancyMaxActiveClusters), fewer where that would leave threads
//     without a chunk, and the chunks go round-robin so that a thread keeps
//     its 4 channels.
//   - Order. A thread adds in float32 over at most PS_RUN = 8 of its chunks
//     (16 terms a channel and sum), then adds that run to float64; every
//     later sum is float64 in a fixed order: a shuffle butterfly over the
//     lanes that share channels, the 8 warps in order, the 8 blocks of a
//     cluster in block-rank order (each block stores its sums into the
//     rank-0 block's shared memory through distributed shared memory; one
//     cluster barrier), and the clusters by a fixed tree (thread t adds
//     clusters t / 2C, t / 2C + K, ... for sum t % 2C, K = 256 / 2C; then
//     the K slots in order).
//   - One launch. The cluster's rank-0 block writes its cluster's partial,
//     fences, and takes a ticket from a counter; the block that takes the
//     last ticket adds every cluster's partial in the order above and sets
//     the counter back to 0. The atomic only elects who adds, never the
//     order, so two runs give the same bits; the counter is zero before and
//     after every launch (and every CUDA graph replay), and the wrapper
//     makes it once per device with torch.zeros. Launches that share a
//     counter must not run at the same time (one stream). Chosen over a
//     cooperative launch with a grid-wide barrier: that holds every block
//     until the slowest has streamed its last chunk, and cluster launches
//     (cudaLaunchKernelEx, as supcon.cu) are captured in CUDA graphs like
//     any kernel; here all blocks but one leave as soon as their cluster's
//     partial is written.
// poolsums_kernel is the float32 kernel; bfloat16 activations go to
// poolsums_bf16_kernel (below), whose lanes own 8 channels. Both end in
// poolsums_combine.
constexpr int PS_CLUSTER = 8;  // blocks of a cluster (the portable most)
constexpr int PS_RUN = 8;      // chunks a float32 run holds before it goes to float64

// The cluster barrier in two halves (PTX barrier.cluster): the poolsums
// kernels arrive at entry and wait before the first store into another
// block's shared memory, which must have started by then; the wait costs
// nothing after the stream.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The fixed-order combine of the poolsums kernels after their stream: each
// thread holds the float64 sums of its V channels (d0: sum dy, d1: sum
// dy*z; lane l holds channels (l % (C / V)) * V ..), added by the butterfly,
// the warps, the cluster's blocks and the tree over clusters described
// above; the ticket elects the block that adds the clusters. The butterfly
// runs as a reduce-scatter: at each lane bit, a lane keeps half of its
// values and adds its partner's of that half, so that it shuffles half as
// many as the step before; each sum is added in the butterfly's pairs (and
// a + b == b + a), to the same bits, with C / 16 values a lane left.
template <int C, int V>
__device__ __forceinline__ void poolsums_combine(double (&d0)[V], double (&d1)[V],
                                                 double* __restrict__ cluster_part,
                                                 unsigned int* __restrict__ ticket,
                                                 double* __restrict__ sums) {
  constexpr int L = C / V;         // lanes of one pixel
  constexpr int S = 2 * C;         // the sums: [sum dy | sum dy*z] x C
  constexpr int K = NT / S;        // slots of the final tree
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ double s_warp[NWARP][S];
  __shared__ double s_gather[PS_CLUSTER][S];  // the lead's: each block's sums, by rank
  __shared__ double s_tree[NT];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // lanes that share channels: the lane bits above L
  double vals[2 * V];  // [sum dy | sum dy*z] of the lane's channels
#pragma unroll
  for (int k = 0; k < V; ++k) {
    vals[k] = d0[k];
    vals[V + k] = d1[k];
  }
  int at = 0;          // vals[t] holds the lane's value at + t
  constexpr int STEPS = L == 2 ? 4 : L == 4 ? 3 : 2;  // log2(32 / L) lane bits
#pragma unroll
  for (int step = 0; step < STEPS; ++step) {
    const int off = 16 >> step, n = (2 * V) >> step;
    const bool upper = lane & off;
#pragma unroll
    for (int t = 0; t < V; ++t) {  // a constant bound, so that vals stays in registers
      if (t < n / 2) {
        const double keep = upper ? vals[n / 2 + t] : vals[t],
                     give = upper ? vals[t] : vals[n / 2 + t];
        vals[t] = keep + __shfl_xor_sync(FULL, give, off);
      }
    }
    at += upper ? n / 2 : 0;
  }
#pragma unroll
  for (int t = 0; t < C / 16; ++t) {
    const int j = at + t;
    s_warp[warp][(j < V ? 0 : C - V) + (lane % L) * V + j] = vals[t];
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();  // every block of the cluster has started (cluster_arrive at entry)
  if (tid < S) {  // this block's sums, into the lead's shared memory
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) v += s_warp[w][tid];
    cluster.map_shared_rank(&s_gather[0][0], 0)[cluster.block_rank() * S + tid] = v;
  }
  cluster.sync();  // the lead's gather is whole; the other blocks leave
  if (cluster.block_rank() != 0) return;
  const unsigned clusters = gridDim.x / PS_CLUSTER;
  if (tid < S) {  // the cluster's partial, in block-rank order
    double v = 0.0;
#pragma unroll
    for (int b = 0; b < PS_CLUSTER; ++b) v += s_gather[b][tid];
    cluster_part[(size_t)(blockIdx.x / PS_CLUSTER) * S + tid] = v;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == clusters - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  {
    double v = 0.0;
#pragma unroll 8
    for (unsigned p = tid / S; p < clusters; p += K)  // loads ahead of the adds
      v += __ldcg(cluster_part + (size_t)p * S + tid % S);
    s_tree[tid] = v;
  }
  __syncthreads();
  if (tid < S) {
    double v = 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) v += s_tree[k * S + tid];
    sums[tid] = v;
  }
  if (tid == 0) *ticket = 0u;
}

template <int C, bool DP, bool DE, class E>
__global__ void __launch_bounds__(NT, 3)
poolsums_kernel(const E* __restrict__ z1, const float* __restrict__ coef,
                const E* __restrict__ dp, const E* __restrict__ de,
                double* __restrict__ cluster_part, unsigned int* __restrict__ ticket,
                double* __restrict__ sums, int B, int H, int W) {
  constexpr int C4 = C / 4;        // chunks of one pixel
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ double s_acc[8][NT];  // this thread's float64 sums of its runs
  cluster_arrive();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c4 = lane % C4;                 // the grid stride keeps a thread's channels
  const bool right = (lane / C4) & 1;       // column 1 of its window (W is even)
  const unsigned wc4 = (unsigned)W * C4;    // chunks of one pixel row
  const unsigned total = (unsigned)B * (unsigned)(H / 2) * wc4;
  float inv[4], sh[4];
  unpack4(ld4(coef + c4 * 4), inv);
  unpack4(ld4(coef + C + c4 * 4), sh);
#pragma unroll
  for (int j = 0; j < 8; ++j) s_acc[j][tid] = 0.0;

  float f0[4] = {0.f, 0.f, 0.f, 0.f}, f1[4] = {0.f, 0.f, 0.f, 0.f};
  int run = 0;
  for (unsigned base = blockIdx.x * NT + warp * 32; base < total; base += gridDim.x * NT) {
    // pairs are whole (total is a multiple of 2 * C4): a lane and its partner
    // are live together; dead lanes hold zeros and still shuffle
    const unsigned i = base + lane;
    float z[2][4], dy[2][4], g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) z[0][k] = z[1][k] = dy[0][k] = dy[1][k] = g[k] = 0.f;
    if (i < total) {
      const unsigned rp = i / wc4, rem = i - rp * wc4;   // row pair, chunk in the row
      const size_t q = (size_t)i + (size_t)rp * wc4;     // upper chunk (row 2 rp)
      unpack4(ldcs4(z1, q), z[0]);
      unpack4(ldcs4(z1, q + wc4), z[1]);
      if (DE) {
        unpack4(ldcs4(de, q), dy[0]);
        unpack4(ldcs4(de, q + wc4), dy[1]);
      }
      if (DP) unpack4(ldg4(dp, (size_t)rp * (wc4 / 2) + (rem / (2 * C4)) * C4 + c4), g);
    }
    float y[2][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      y[0][k] = bn_apply(z[0][k], inv[k], sh[k]);
      y[1][k] = bn_apply(z[1][k], inv[k], sh[k]);
    }
    if (DP) {
      unsigned bits = 0;   // bit 2k + r: this column's row r holds the window maximum
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float e0 = rnd<E>(fmaxf(y[0][k], 0.f)), e1 = rnd<E>(fmaxf(y[1][k], 0.f));
        const float mine = fmaxf(e0, e1);
        const float m = fmaxf(mine, __shfl_xor_sync(FULL, mine, C4));
        bits |= (unsigned)(e0 == m) << (2 * k) | (unsigned)(e1 == m) << (2 * k + 1);
      }
      const unsigned other = __shfl_xor_sync(FULL, bits, C4);
      const unsigned lb = right ? other : bits, rb = right ? bits : other;
      const int col = right ? 1 : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // first maximum in scan order: left r0, right r0, left r1, else right r1
        const int first = (lb >> (2 * k)) & 1 ? 0
                          : (rb >> (2 * k)) & 1 ? 1
                          : (lb >> (2 * k + 1)) & 1 ? 2 : 3;
        dy[0][k] += first == col ? g[k] : 0.f;
        dy[1][k] += first == 2 + col ? g[k] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float d = y[r][k] >= 0.f ? dy[r][k] : 0.f;
        f0[k] += d;
        f1[k] = fmaf(d, z[r][k], f1[k]);
      }
    }
    if (++run == PS_RUN) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_acc[k][tid] += (double)f0[k];
        s_acc[4 + k][tid] += (double)f1[k];
        f0[k] = f1[k] = 0.f;
      }
      run = 0;
    }
  }
  double d0[4], d1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d0[k] = s_acc[k][tid] + (double)f0[k];
    d1[k] = s_acc[4 + k][tid] + (double)f1[k];
  }
  poolsums_combine<C, 4>(d0, d1, cluster_part, ticket, sums);
}

// Two floats rounded to bf16 (to nearest even) with negatives clamped to 0;
// hi in the upper half.
__device__ __forceinline__ uint32_t relu_bf16x2(float hi, float lo) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the lane's coefficients (a pair) from shared memory, at each use: volatile,
// so that they are not hoisted into 16 registers for the whole loop
__device__ __forceinline__ float2 ld_shared2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

// One chunk of poolsums_bf16_kernel (zc, ec: z1 and de of rows 0 and 1; gc:
// dp) into the thread's float32 runs f0 (sum dy) and f1 (sum dy*z), a pair
// of channels at a time; coef: the lane's 8 inv, then its 8 shift, in
// shared memory. code0 / code1: 3 - the scan position of the lane's rows 0
// and 1.
template <int C, bool DP, bool DE>
__device__ __forceinline__ void poolsums_bf16_chunk(const uint4 (&zc)[2], const uint4 (&ec)[2],
                                                    uint4 gc, const float* coef,
                                                    uint32_t code0, uint32_t code1,
                                                    float (&f0)[8], float (&f1)[8]) {
  const uint32_t zw[2][4] = {{zc[0].x, zc[0].y, zc[0].z, zc[0].w},
                             {zc[1].x, zc[1].y, zc[1].z, zc[1].w}};
  const uint32_t ew[2][4] = {{ec[0].x, ec[0].y, ec[0].z, ec[0].w},
                             {ec[1].x, ec[1].y, ec[1].z, ec[1].w}};
  const uint32_t gw[4] = {gc.x, gc.y, gc.z, gc.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // channels 2j (low halves) and 2j + 1 (high)
    const float2 inv = ld_shared2(coef + 2 * j), sh = ld_shared2(coef + 8 + 2 * j);
    float z[2][2], y[2][2], dy[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 zf = bf2_to_f2(zw[r][j]);
      z[r][0] = zf.x;
      z[r][1] = zf.y;
      y[r][0] = bn_apply(zf.x, inv.x, sh.x);
      y[r][1] = bn_apply(zf.y, inv.y, sh.y);
      const float2 ef = DE ? bf2_to_f2(ew[r][j]) : make_float2(0.f, 0.f);
      dy[r][0] = ef.x;
      dy[r][1] = ef.y;
    }
    if (DP) {
      const float2 g = bf2_to_f2(gw[j]);
      const uint32_t w0 = relu_bf16x2(y[0][1], y[0][0]) & 0x7fff7fffu;
      const uint32_t w1 = relu_bf16x2(y[1][1], y[1][0]) & 0x7fff7fffu;
      const uint32_t k0[2] = {w0 << 16 | code0, (w0 & 0xffff0000u) | code0};
      const uint32_t k1[2] = {w1 << 16 | code1, (w1 & 0xffff0000u) | code1};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t mine = max(k0[h], k1[h]);
        const uint32_t m = max(mine, __shfl_xor_sync(0xffffffffu, mine, C / 8));
        const float gh = h ? g.y : g.x;
        if (k0[h] == m) dy[0][h] += gh;
        if (k1[h] == m) dy[1][h] += gh;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (y[r][h] >= 0.f) {
          f0[2 * j + h] += dy[r][h];
          f1[2 * j + h] = fmaf(dy[r][h], z[r][h], f1[2 * j + h]);
        }
  }
}

// poolsums_bf16_kernel: the same sums from bfloat16 z1, dp and de, with a
// lane layout of its own. Made as poolsums_kernel<bf16>, a lane loaded 8
// bytes (4 channels) a chunk: half a float32 lane's bytes for the same index
// division, shuffles and float64 spills, so its time followed the elements,
// not the bytes (93% of float32's time for half the bytes, 42-45% of its
// byte bound without de). Here:
//   - Sixteen-byte lanes. A lane owns one uint4 (8 channels) of the upper
//     row of a row pair and the uint4 below it; C/8 lanes make a pixel, the
//     window's other column is lane l ^ C/8, and the window's dp is one
//     uint4 that both lanes of the pair load in one request. A warp load is
//     512 contiguous bytes, as in float32.
//   - Loads ahead, registers kept. Without de (the pretrain path) a thread
//     issues the loads of its next chunk (i + stride) before it computes
//     chunk i; with de the chunk's own loads are the ones in flight (a
//     prefetch would take 20 more registers than the 80 of three blocks an
//     SM, and spill). A chunk is computed two channels at a time, and the
//     lane's BN coefficients are read from shared memory at each use, not
//     held in 16 registers. The place of a chunk in its pixel row is kept by
//     increments of the stride (one division before the loop), and the upper
//     row's chunk is q = 2i - that place.
//   - Routing by keys. An element's key is its rounded e = relu(y) (bf16
//     bits, two at a time by cvt.rn.relu.bf16x2, the sign bit cleared so
//     that -0 is 0) above 3 - its scan position: the four keys of a window
//     differ, and the largest is its first maximum in scan order. The larger
//     of the lane's two keys goes to the partner in one shuffle a channel;
//     an element whose key is the window's takes dp.
//   - Order. As float32: a thread adds its chunks i, i + stride, ... in
//     turn (row 0, then row 1, a channel), in float32 runs of PS_RUN chunks
//     (16 terms a channel-sum), each run then added to float64; the loads
//     ahead change no order. Its 16 float64 sums live in shared memory
//     (s_acc[16][NT], 32 KB a block), not in registers, as in float32.
//   - Residency. 72-80 registers a thread and 39-43 KB of shared memory a
//     block: three blocks an SM, 45 clusters of 8 resident on an H100 with
//     de and without (the float32 kernel without de: 62). Capped at 64
//     registers for four blocks an SM (62 clusters), it was slower.
//   - The combine is poolsums_combine with V = 8, on the same cluster grid.
template <int C, bool DP, bool DE>
__global__ void __launch_bounds__(NT, 3)
poolsums_bf16_kernel(const bf16* __restrict__ z1, const float* __restrict__ coef,
                     const bf16* __restrict__ dp, const bf16* __restrict__ de,
                     double* __restrict__ cluster_part, unsigned int* __restrict__ ticket,
                     double* __restrict__ sums, int B, int H, int W) {
  constexpr int C8 = C / 8;         // chunks of one pixel
  constexpr bool PREFETCH = !DE;    // the next chunk's loads ahead (see above)
  __shared__ double s_acc[16][NT];  // this thread's float64 sums of its runs
  __shared__ __align__(16) float s_coef[C8][16];  // a lane group's 8 inv, then 8 shift
  cluster_arrive();

  const int tid = threadIdx.x, lane = tid & 31;
  const int c8 = lane % C8;                 // the grid stride keeps a thread's channels
  const bool right = (lane / C8) & 1;       // column 1 of its window (W is even)
  const uint32_t code0 = right ? 2u : 3u, code1 = right ? 0u : 1u;
  const unsigned wc8 = (unsigned)W * C8;    // chunks of one pixel row
  const unsigned total = (unsigned)B * (unsigned)(H / 2) * wc8;
  const unsigned stride = gridDim.x * NT, step = stride % wc8;
  const uint4* zq = reinterpret_cast<const uint4*>(z1);
  const uint4* eq = reinterpret_cast<const uint4*>(de);
  const uint4* gq = reinterpret_cast<const uint4*>(dp);
  unsigned base = blockIdx.x * NT + (tid - lane);
  unsigned rem = (base + lane) % wc8;       // chunk i's place in its pixel row
  // pairs are whole (total is a multiple of 2 * C8): a lane and its partner
  // are live together; dead lanes hold zeros and still shuffle
  auto load = [&](unsigned i, uint4 (&zc)[2], uint4 (&ec)[2], uint4& gc) {
    zc[0] = zc[1] = ec[0] = ec[1] = gc = make_uint4(0u, 0u, 0u, 0u);
    if (i < total) {
      const unsigned q = 2 * i - rem;       // upper chunk: i + (row pair) * wc8
      zc[0] = __ldcs(zq + q);
      zc[1] = __ldcs(zq + q + wc8);
      if (DE) {
        ec[0] = __ldcs(eq + q);
        ec[1] = __ldcs(eq + q + wc8);
      }
      if (DP) gc = __ldg(gq + (i / (2 * C8)) * C8 + c8);
    }
    rem += step;
    if (rem >= wc8) rem -= wc8;
  };
  uint4 zc[2], ec[2], gc;
  load(base + lane, zc, ec, gc);  // in flight while the block stages its coefficients
  if (tid < 2 * C) s_coef[(tid % C) / 8][(tid / C) * 8 + tid % 8] = coef[tid];
#pragma unroll
  for (int j = 0; j < 16; ++j) s_acc[j][tid] = 0.0;
  __syncthreads();

  float f0[8], f1[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) f0[k] = f1[k] = 0.f;
  int run = 0;
  for (; base < total; base += stride) {
    uint4 zn[2], en[2], gn;
    if (PREFETCH) load(base + stride + lane, zn, en, gn);  // in flight while chunk i computes
    poolsums_bf16_chunk<C, DP, DE>(zc, ec, gc, s_coef[c8], code0, code1, f0, f1);
    if (++run == PS_RUN) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s_acc[k][tid] += (double)f0[k];
        s_acc[8 + k][tid] += (double)f1[k];
        f0[k] = f1[k] = 0.f;
      }
      run = 0;
    }
    if (PREFETCH) {
      zc[0] = zn[0];
      zc[1] = zn[1];
      gc = gn;
    } else {
      load(base + stride + lane, zc, ec, gc);
    }
  }
  double d0[8], d1[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    d0[k] = s_acc[k][tid] + (double)f0[k];
    d1[k] = s_acc[8 + k][tid] + (double)f1[k];
  }
  poolsums_combine<C, 8>(d0, d1, cluster_part, ticket, sums);
}

template <class E>
__global__ void __launch_bounds__(NT)
dz1_kernel(const E* __restrict__ z1, const float* __restrict__ coef,
           const float* __restrict__ dcoef, const E* __restrict__ dp,
           const E* __restrict__ de, E* __restrict__ dz, int B, int H, int W, int C) {
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
      for (int k = 0; k < 4; ++k) o[k] = bn_bwd(dy[j][k], z[j][k], k0[k], k1[k], k2[k]);
      store4(dz + wd.off[j], make_float4(o[0], o[1], o[2], o[3]));
    }
  }
}

// out[j] = sum over blocks of part[block][j], in block order, in float64
template <typename T>
__global__ void convstage_reduce_kernel(const T* __restrict__ part, int nblocks, int n,
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
  convstage_reduce_kernel<T><<<(n + 127) / 128, 128, 0, stream>>>(part, nblocks, n, out);
  return cudaGetLastError();
}

// Blocks for a persistent conv kernel: one per tile, at most max_blocks (the
// size of the partials workspace) and at most what is resident at once, so
// that every block starts together and the tiles spread evenly.
template <typename K>
cudaError_t conv_grid(K kernel, size_t dyn, int B, int H, int W, int max_blocks, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, dyn);
  if (err != cudaSuccess) return err;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  *grid = grid_for_tiles(B, H, W, resident < max_blocks ? resident : max_blocks);
  return cudaSuccess;
}

// The bf16 kernels ask for the SM's largest shared-memory carveout (several
// blocks a SM), once per device; `done` is the caller's, one per kernel
// instantiation (a bit per device)
template <class K>
cudaError_t prefer_shared(K kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (err != cudaSuccess || (done.load() & bit)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// A forward convolution pass (conv, or bnconv with BN_IN) on E: float32
// conv_fwd_kernel or bf16 conv_fwd_bf16_kernel, then the sums' reduction.
template <int CI, int CO, bool BN_IN, class E>
cudaError_t launch_conv_fwd(const void* in, const float* coef, const float* w, void* out,
                            double* partial, double* sums, int B, int H, int W,
                            int max_blocks, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err;
  if constexpr (is_bf16<E>) {
    constexpr size_t dyn = fwd_bf16_smem<CI, CO>();
    auto kernel = conv_fwd_bf16_kernel<CI, CO, BN_IN>;
    static std::atomic<unsigned> carveout_set{0};
    err = prefer_shared(kernel, carveout_set);
    if (err == cudaSuccess) err = conv_grid(kernel, dyn, B, H, W, max_blocks, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, dyn, stream>>>(static_cast<const bf16*>(in), coef, w,
                                      static_cast<bf16*>(out), partial, B, H, W);
  } else {
    constexpr size_t dyn = sizeof(float) * fwd_smem_floats<CI, CO>();
    auto kernel = conv_fwd_kernel<CI, CO, BN_IN>;
    err = conv_grid(kernel, dyn, B, H, W, max_blocks, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, dyn, stream>>>(static_cast<const float*>(in), coef, w,
                                      static_cast<float*>(out), partial, B, H, W);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce<double>(partial, grid, 2 * CO, sums, stream);
}

// A backward convolution pass (dwdx, or dwprev with PREV) on E: float32
// conv_bwd_kernel or bf16 conv_bwd_bf16_kernel, then the reductions.
template <int CI, int CO, bool PREV, class E>
cudaError_t launch_conv_bwd(const void* a_src, const float* a_coef, const void* g_src,
                            const void* g_z, const float* g_coef, const float* w,
                            void* d_in, float* dw_partial, double* dw, double* sum_partial,
                            double* sums, int B, int H, int W, int max_blocks,
                            cudaStream_t stream) {
  int grid = 0;
  cudaError_t err;
  if constexpr (is_bf16<E>) {
    constexpr size_t dyn = bwd_bf16_smem<CI, CO, PREV>();
    auto kernel = conv_bwd_bf16_kernel<CI, CO, PREV>;
    static std::atomic<unsigned> carveout_set{0};
    err = prefer_shared(kernel, carveout_set);
    if (err == cudaSuccess) err = conv_grid(kernel, dyn, B, H, W, max_blocks, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, dyn, stream>>>(static_cast<const bf16*>(a_src), a_coef,
                                      static_cast<const bf16*>(g_src),
                                      static_cast<const bf16*>(g_z), g_coef, w,
                                      static_cast<bf16*>(d_in), dw_partial, sum_partial, B, H,
                                      W);
  } else {
    constexpr size_t dyn =
        sizeof(float) * bwd_smem_floats<CI, CO, PREV>(bwd_buffers<CI, CO, PREV>());
    auto kernel = conv_bwd_kernel<CI, CO, PREV>;
    err = conv_grid(kernel, dyn, B, H, W, max_blocks, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, dyn, stream>>>(static_cast<const float*>(a_src), a_coef,
                                      static_cast<const float*>(g_src),
                                      static_cast<const float*>(g_z), g_coef, w,
                                      static_cast<float*>(d_in), dw_partial, sum_partial, B, H,
                                      W);
  }
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

// The poolsums kernel of a variant: float32 or bfloat16 activations.
template <int C, bool DP, bool DE, class E>
constexpr auto poolsums_fn() {
  if constexpr (is_bf16<E>) return poolsums_bf16_kernel<C, DP, DE>;
  else return poolsums_kernel<C, DP, DE, E>;
}

// channels a lane of the poolsums kernel owns
template <class E>
constexpr int PS_LANE_CHANNELS = is_bf16<E> ? 8 : 4;

// poolsums: clusters of PS_CLUSTER blocks the card holds at once, per
// kernel variant, found once per process.
template <int C, bool DP, bool DE, class E>
cudaError_t poolsums_resident(int* clusters) {
  static int resident = -1;
  if (resident < 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(PS_CLUSTER, 1, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = PS_CLUSTER;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&n, poolsums_fn<C, DP, DE, E>(), &cfg);
    if (err != cudaSuccess) return err;
    if (n <= 0) return cudaErrorInvalidConfiguration;
    resident = n;
  }
  *clusters = resident;
  return cudaSuccess;
}

// Calls fn.template run<C, DP, DE>() for the kernel variant of the operands.
template <class Fn>
cudaError_t poolsums_variant(int c, bool dp, bool de, Fn& fn) {
  if (c == 16) {
    if (dp) return de ? fn.template run<16, true, true>() : fn.template run<16, true, false>();
    return de ? fn.template run<16, false, true>() : fn.template run<16, false, false>();
  }
  if (dp) return de ? fn.template run<32, true, true>() : fn.template run<32, true, false>();
  return de ? fn.template run<32, false, true>() : fn.template run<32, false, false>();
}

template <class E>
struct PoolsumsResident {
  int* out;
  template <int C, bool DP, bool DE>
  cudaError_t run() { return poolsums_resident<C, DP, DE, E>(out); }
};

// The clusters of a poolsums launch: those resident at once, fewer where
// that would leave threads without a chunk. The chunk index and the grid
// stride stay below 2^31.
template <class E>
cudaError_t poolsums_clusters(int B, int H, int W, int C, bool dp, bool de, int* clusters,
                              int* resident) {
  PoolsumsResident<E> fn{resident};
  cudaError_t err = poolsums_variant(C, dp, de, fn);
  if (err != cudaSuccess) return err;
  const long chunks = (long)B * (H / 2) * W * (C / PS_LANE_CHANNELS<E>);
  const long per_cluster = (long)PS_CLUSTER * NT;
  const long need = (chunks + per_cluster - 1) / per_cluster;
  if (chunks + (long)*resident * per_cluster >= (1L << 31)) return cudaErrorInvalidValue;
  *clusters = (int)(need < *resident ? need : *resident);
  return cudaSuccess;
}

template <class E>
struct PoolsumsLaunch {
  const E *z1;
  const float* coef;
  const E *dp, *de;
  double* cluster_part;
  unsigned int* ticket;
  double* sums;
  int B, H, W, clusters;
  cudaStream_t stream;
  template <int C, bool DP, bool DE>
  cudaError_t run() {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(clusters * PS_CLUSTER, 1, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = PS_CLUSTER;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, poolsums_fn<C, DP, DE, E>(), z1, coef, dp, de,
                                         cluster_part, ticket, sums, B, H, W);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
};

template <class E>
int poolsums_plan(int B, int H, int W, int c, int has_dp, int has_de, int* out) {
  if (!pool_dims_ok(B, H, W, c)) return (int)cudaErrorInvalidValue;
  int clusters = 0, resident = 0;
  cudaError_t err = poolsums_clusters<E>(B, H, W, c, has_dp, has_de, &clusters, &resident);
  if (err != cudaSuccess) return (int)err;
  const int v[5] = {clusters, PS_CLUSTER, resident, PS_RUN, PS_LANE_CHANNELS<E>};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

template <class E>
int poolsums(const void* z1, const float* coef, const void* dp, const void* de,
             double* cluster_part, double* sums, unsigned int* ticket, int B, int H, int W,
             int c, int max_clusters, cudaStream_t stream) {
  if (!pool_dims_ok(B, H, W, c)) return (int)cudaErrorInvalidValue;
  int clusters = 0, resident = 0;
  cudaError_t err = poolsums_clusters<E>(B, H, W, c, dp != nullptr, de != nullptr, &clusters,
                                         &resident);
  if (err != cudaSuccess) return (int)err;
  if (clusters > max_clusters) return (int)cudaErrorInvalidValue;
  PoolsumsLaunch<E> fn{static_cast<const E*>(z1), coef, static_cast<const E*>(dp),
                       static_cast<const E*>(de), cluster_part, ticket, sums, B, H, W,
                       clusters, stream};
  return (int)poolsums_variant(c, dp != nullptr, de != nullptr, fn);
}

template <class E>
int conv(const void* x, const float* w, void* z, double* partial, double* sums, int B, int H,
         int W, int ci, int co, int max_blocks, cudaStream_t s) {
  if (!dims_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  if (ci == 16 && co == 16)
    return (int)launch_conv_fwd<16, 16, false, E>(x, nullptr, w, z, partial, sums, B, H, W,
                                                  max_blocks, s);
  if (ci == 16 && co == 32)
    return (int)launch_conv_fwd<16, 32, false, E>(x, nullptr, w, z, partial, sums, B, H, W,
                                                  max_blocks, s);
  if (ci == 32 && co == 32)
    return (int)launch_conv_fwd<32, 32, false, E>(x, nullptr, w, z, partial, sums, B, H, W,
                                                  max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

template <class E>
int bnconv(const void* z0, const float* coef, const float* w, void* z1, double* partial,
           double* sums, int B, int H, int W, int c, int max_blocks, cudaStream_t s) {
  if (!dims_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  if (c == 16)
    return (int)launch_conv_fwd<16, 16, true, E>(z0, coef, w, z1, partial, sums, B, H, W,
                                                 max_blocks, s);
  if (c == 32)
    return (int)launch_conv_fwd<32, 32, true, E>(z0, coef, w, z1, partial, sums, B, H, W,
                                                 max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

template <class E>
int dwprev(const void* dz, const void* zprev, const float* coef, const float* w, void* dyprev,
           float* dw_partial, double* dw, double* sum_partial, double* sums, int B, int H,
           int W, int c, int max_blocks, cudaStream_t s) {
  if (!dims_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  if (c == 16)
    return (int)launch_conv_bwd<16, 16, true, E>(zprev, coef, dz, nullptr, nullptr, w, dyprev,
                                                 dw_partial, dw, sum_partial, sums, B, H, W,
                                                 max_blocks, s);
  if (c == 32)
    return (int)launch_conv_bwd<32, 32, true, E>(zprev, coef, dz, nullptr, nullptr, w, dyprev,
                                                 dw_partial, dw, sum_partial, sums, B, H, W,
                                                 max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

template <class E>
int dwdx(const void* z0, const void* dy0, const float* dcoef, const void* x, const float* w,
         void* dx, float* dw_partial, double* dw, int B, int H, int W, int ci, int co,
         int max_blocks, cudaStream_t s) {
  if (!dims_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  if (ci == 16 && co == 16)
    return (int)launch_conv_bwd<16, 16, false, E>(x, nullptr, dy0, z0, dcoef, w, dx,
                                                  dw_partial, dw, nullptr, nullptr, B, H, W,
                                                  max_blocks, s);
  if (ci == 16 && co == 32)
    return (int)launch_conv_bwd<16, 32, false, E>(x, nullptr, dy0, z0, dcoef, w, dx,
                                                  dw_partial, dw, nullptr, nullptr, B, H, W,
                                                  max_blocks, s);
  if (ci == 32 && co == 32)
    return (int)launch_conv_bwd<32, 32, false, E>(x, nullptr, dy0, z0, dcoef, w, dx,
                                                  dw_partial, dw, nullptr, nullptr, B, H, W,
                                                  max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Side of the square pixel tile a block works on.
int convstage_tile() { return TH; }

// Every entry point takes the activation tensors as untyped pointers and
// `bf`: 0 when they are float32, 1 when they are bfloat16. Workspaces, for a
// grid of at most `max_blocks` blocks: `partial` float64 [max_blocks, 2, C]
// statistics partials, `dw_partial` float32 [max_blocks, 9, Ci, Co]
// weight-gradient partials. `sums` is float64 [2, C], `dw` float64
// [9, Ci, Co]; `w` float32 [3, 3, Ci, Co] (rounded to bf16 as it is staged
// when bf = 1); `coef`
// float32 [2, C] = (inv, shift), `dcoef` float32 [3, C] = (c0, c1, c2); `dp` /
// `de` may be null.

int convstage_conv(const void* x, const float* w, void* z, double* partial, double* sums,
                   int B, int H, int W, int ci, int co, int max_blocks, int bf, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf ? conv<bf16>(x, w, z, partial, sums, B, H, W, ci, co, max_blocks, s)
            : conv<float>(x, w, z, partial, sums, B, H, W, ci, co, max_blocks, s);
}

int convstage_bnconv(const void* z0, const float* coef, const float* w, void* z1,
                     double* partial, double* sums, int B, int H, int W, int c,
                     int max_blocks, int bf, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf ? bnconv<bf16>(z0, coef, w, z1, partial, sums, B, H, W, c, max_blocks, s)
            : bnconv<float>(z0, coef, w, z1, partial, sums, B, H, W, c, max_blocks, s);
}

int convstage_bnpool(const void* z1, const float* coef, void* e, void* p, int B, int H,
                     int W, int c, int max_blocks, int bf, void* stream) {
  if (!pool_dims_ok(B, H, W, c)) return (int)cudaErrorInvalidValue;
  const int grid = grid_for_windows(B, H, W, c, max_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf)
    bnpool_kernel<bf16><<<grid, NT, 0, s>>>(static_cast<const bf16*>(z1), coef,
                                            static_cast<bf16*>(e), static_cast<bf16*>(p), B,
                                            H, W, c);
  else
    bnpool_kernel<float><<<grid, NT, 0, s>>>(static_cast<const float*>(z1), coef,
                                             static_cast<float*>(e), static_cast<float*>(p),
                                             B, H, W, c);
  return (int)cudaGetLastError();
}

// The launch plan of convstage_poolsums at this shape, with dp and de
// present (1) or absent (0): out = {clusters, blocks a cluster, clusters
// resident at once, chunks a float32 run holds, channels a lane owns}.
// Returns a cudaError_t.
int convstage_poolsums_plan(int B, int H, int W, int c, int has_dp, int has_de, int bf,
                            int* out) {
  return bf ? poolsums_plan<bf16>(B, H, W, c, has_dp, has_de, out)
            : poolsums_plan<float>(B, H, W, c, has_dp, has_de, out);
}

// `cluster_part` float64 [max_clusters, 2, C] scratch; `ticket` one unsigned
// int that is 0 before the call and is 0 again after it.
int convstage_poolsums(const void* z1, const float* coef, const void* dp, const void* de,
                       double* cluster_part, double* sums, unsigned int* ticket, int B,
                       int H, int W, int c, int max_clusters, int bf, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf ? poolsums<bf16>(z1, coef, dp, de, cluster_part, sums, ticket, B, H, W, c,
                             max_clusters, s)
            : poolsums<float>(z1, coef, dp, de, cluster_part, sums, ticket, B, H, W, c,
                              max_clusters, s);
}

int convstage_dz1(const void* z1, const float* coef, const float* dcoef, const void* dp,
                  const void* de, void* dz, int B, int H, int W, int c, int max_blocks,
                  int bf, void* stream) {
  if (!pool_dims_ok(B, H, W, c)) return (int)cudaErrorInvalidValue;
  const int grid = grid_for_windows(B, H, W, c, max_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf)
    dz1_kernel<bf16><<<grid, NT, 0, s>>>(static_cast<const bf16*>(z1), coef, dcoef,
                                         static_cast<const bf16*>(dp),
                                         static_cast<const bf16*>(de), static_cast<bf16*>(dz),
                                         B, H, W, c);
  else
    dz1_kernel<float><<<grid, NT, 0, s>>>(static_cast<const float*>(z1), coef, dcoef,
                                          static_cast<const float*>(dp),
                                          static_cast<const float*>(de),
                                          static_cast<float*>(dz), B, H, W, c);
  return (int)cudaGetLastError();
}

int convstage_dwprev(const void* dz, const void* zprev, const float* coef, const float* w,
                     void* dyprev, float* dw_partial, double* dw, double* sum_partial,
                     double* sums, int B, int H, int W, int c, int max_blocks, int bf,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf ? dwprev<bf16>(dz, zprev, coef, w, dyprev, dw_partial, dw, sum_partial, sums, B,
                           H, W, c, max_blocks, s)
            : dwprev<float>(dz, zprev, coef, w, dyprev, dw_partial, dw, sum_partial, sums, B,
                            H, W, c, max_blocks, s);
}

int convstage_dwdx(const void* z0, const void* dy0, const float* dcoef, const void* x,
                   const float* w, void* dx, float* dw_partial, double* dw, int B, int H,
                   int W, int ci, int co, int max_blocks, int bf, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf ? dwdx<bf16>(z0, dy0, dcoef, x, w, dx, dw_partial, dw, B, H, W, ci, co,
                         max_blocks, s)
            : dwdx<float>(z0, dy0, dcoef, x, w, dx, dw_partial, dw, B, H, W, ci, co,
                          max_blocks, s);
}

}  // extern "C"
