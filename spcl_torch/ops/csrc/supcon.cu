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
// Bound on the H100. The work is one [rows, D] x [D, cols] product for s
// (forward) and that product plus G @ z_cols (backward); the rest is O(rows
// x cols) elementwise work. The tolerances of the callers are float32's, and
// s carries 1/T = 14.3x the rounding of the dot product, so one TF32 pass
// (about 1e-3 of a unit-vector dot product) is not enough: the products run
// in 3xTF32 on the tensor cores. Every operand x is split into hi = x with
// its low 13 mantissa bits cleared (a TF32 value) and lo = x - hi (exact),
// and each product is accumulated in float32 by mma.sync.m16n8k8 TF32 as
// lo*hi + hi*lo + hi*hi (the MMA reads the top 11 significant bits of lo;
// the dropped terms leave about 1e-6 relative), in short chains whose sums
// are added on the CUDA cores (add_rn below). The bound is therefore the
// larger of the bytes (z read once, the vectors, the outputs written once)
// over 3.35 TB/s and 3 x the product's FLOPs over 495 TFLOP/s TF32: at
// 2N = 3840, D = 256, 0.046 ms forward and 0.092 ms backward; at the paper's
// 2N = 60 the bytes bound it (~0.00003 ms) and launch latency sets the time.
//
// Design. On the TPU the column blocks were a sequential grid axis carrying
// sums in scratch memory. Here one THREAD-BLOCK CLUSTER owns a tile of 64
// rows, and its S blocks split the column sweep: block q of the cluster owns
// the contiguous 32-column tiles [q*T/S, (q+1)*T/S) of the T tiles. The host
// chooses S (1..16) per shape from the row tiles, the column tiles and
// cudaOccupancyMaxActiveClusters, counting waves of clusters times the tiles
// a block sweeps, so that at large 2N the grid fills the card and at small
// 2N the sweep is one tile (2N = 60: two blocks, each loading its row tile
// and its one column tile at once; there is no depth-chunk loop).
//   - Operands. The block stages its row tile in shared memory once; each
//     warp then keeps its A fragments (32 rows x a quarter of the depth, 64
//     floats a thread) in registers for the whole sweep, and the staging
//     area is reused (forward: kept s tiles; backward: the partial dz). The
//     column tiles (z at full depth, zero-padded to 256, and the column
//     vectors) stream through two buffers: tile i + 1 is copied while tile
//     i computes, its z rows by the copy engine (one cp.async.bulk a row,
//     completing on the buffer's mbarrier), its vectors by cp.async.
//   - s tile (64 x 32): warp w computes rows 32 (w & 1).. against all 32
//     columns over depth quarter w >> 1, 2 x 4 fragments, so each k-step
//     issues 24 independent MMAs. Depth is summed over, so A and B share a
//     permuted depth order in which one 16-byte load gives a lane its B
//     values for two k-steps (odd rows are shifted by 8 floats, so these
//     loads are free of bank conflicts). The four quarters' partial tiles
//     go through shared memory and are added in order by the epilogue, in
//     which each thread owns one row and 8 consecutive columns.
//   - Forward: pass A sums exp and the positive count per row and keeps the
//     tile's s (and its column vectors) in shared memory for pass B, up to
//     15 tiles; pass B recomputes only tiles beyond that (none at 2N = 60,
//     126, 1024, 3840 or on the strips of chip_smoke.py). Per-row partial
//     sums (the four lanes of a row, then the cluster) go to shared memory;
//     after cluster.sync() every block adds the S partials in block-rank
//     order through distributed shared memory (map_shared_rank), so each
//     holds the same log(denom + eps); pass B's are added the same way and
//     block rank 0 writes the four outputs.
//   - Backward: per column tile, s, e and G = (g_row + g_col) / T go to a
//     shared G tile (reciprocals of max(c, 1) and denom + eps in place of
//     divisions; the column side's log and reciprocals computed once a tile,
//     not once for each of the 64 rows), then warp w accumulates dz[64 rows, depth 32 w..] += G @
//     z_tile in registers (4 x 4 fragments, 3xTF32) from the column tile
//     already in shared memory. After the sweep the [64, D] partials are
//     added across the cluster through distributed shared memory in
//     block-rank order, each block one slice, and written once.
// No atomics: every sum across lanes, warps and blocks has a fixed order, so
// two runs on the same inputs give the same bits. A cluster.sync() follows
// every read of another block's shared memory before that memory is
// overwritten or its block exits. D is at most 256 (the projection head's
// width); the wrapper refuses more.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;        // rows/cols padding of the operands (supcon_tile)
constexpr int BM = 64;           // rows of one row tile (one cluster)
constexpr int BN = 32;           // columns of one column tile
constexpr int NT = 256;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int DP = 256;          // depth held in shared memory (zeros past D): the most D
constexpr int SD = DP + 8;       // row stride of z tiles (odd rows start 8 floats in)
constexpr int KS = DP / 8;       // k-steps of the s product
constexpr int KQ = 4;            // warp w takes rows 32 (w & 1).. and k-steps quarter w >> 1
constexpr int KSW = KS / KQ;     // k-steps of one warp
constexpr int PS = BN;           // row stride of the partial s tiles (swizzled, part_col)
constexpr int GS = BN + 4;       // row stride of the G tile (4 mod 32)
constexpr int NJ_DZ = DP / 8 / NWARP;  // depth fragments of dz per warp
constexpr int NVEC_FWD = 3;      // column vectors staged per tile: lab, val, gid
constexpr int NVEC_BWD = 6;      //   + c, denom, a
constexpr int NSTAGE = 2;        // column tiles in flight or in use per block
constexpr int MAX_CLUSTER = 16;
constexpr int SMEM_OPTIN = 232448;  // shared memory a block may use on Hopper
constexpr float kEps = 1e-16f;
constexpr float kNegBig = -1e30f;

enum Mode { kModeNone = 0, kModeHard = 1, kModeSoft = 2 };

// ------------------------------------------------------------------ shared memory
// Offsets in floats. Forward: the row tile is staged at 0 and, once each
// warp holds its A fragments in registers, the same region keeps the s tiles
// for pass B (KEEP_MAX of them). Backward: the row tile at 0, later the
// block's partial dz.
constexpr int STAGE_FWD = BN * SD + NVEC_FWD * BN;
constexpr int STAGE_BWD = BN * SD + NVEC_BWD * BN;
constexpr int KEEP_TILE = BM * BN + NVEC_FWD * BN;
constexpr int PART = KQ * BM * PS;   // partial s tiles of the four depth quarters
constexpr int FWD_FIXED = NSTAGE * STAGE_FWD + PART + 4 * BM + 2 * BM;
constexpr int KEEP_MAX = (SMEM_OPTIN / 4 - FWD_FIXED) / KEEP_TILE;
constexpr int F_KEEP = 0;
constexpr int F_RING = KEEP_MAX * KEEP_TILE > BM * SD ? KEEP_MAX * KEEP_TILE : BM * SD;
constexpr int F_PART = F_RING + NSTAGE * STAGE_FWD;
constexpr int F_PSUM = F_PART + PART;   // [pass A: denom, c | pass B: rawloss, spsum][BM]
constexpr int F_TOT = F_PSUM + 4 * BM;  // [denom, c][BM] over the cluster
constexpr int FWD_FLOATS = F_TOT + 2 * BM;
constexpr int B_RING = BM * SD;
constexpr int B_PART = B_RING + NSTAGE * STAGE_BWD;
constexpr int B_G = B_PART + PART;
constexpr int B_CST = B_G + BM * GS;   // [log(denom + eps), 1 / (denom + eps), 1 / max(c, 1)][BN]
constexpr int BWD_FLOATS = B_CST + 3 * BN;
static_assert(4 * FWD_FLOATS <= SMEM_OPTIN && 4 * BWD_FLOATS <= SMEM_OPTIN, "shared memory");
static_assert(KEEP_MAX >= 1 && BM * DP <= BM * SD, "layout");

// ------------------------------------------------------------------ 3xTF32
// x = hi + lo: hi = x rounded to the nearest TF32 value (ties away from zero:
// add half of the 13 low mantissa bits' unit, then clear them), lo = x - hi,
// exact in float32; the MMA reads the top 11 significant bits of lo. Rounding
// hi to nearest gives lo either sign, so the truncation of lo and the
// dropped lo*lo term do not all lean one way. (convstage.cu clears the bits.)
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(__fsub_rn(x, __uint_as_float(hi)))};
}

// A fragment of m16n8k8 (row-major 16x8): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4) with g = lane/4, t = lane%4. B (8x8, k x n): b0 (t, g),
// b1 (t+4, g). C/D (16x8): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
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
// pass over all MI x NJ accumulators so that consecutive MMAs are independent
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
// do not round their float32 accumulation to nearest but toward zero: over a
// chain of MMAs the error follows the running partial sum, and where every
// product has one sign (the dot products of features that all point one way,
// as an untrained network's do) it adds up, 50-70x plain float32's in denom
// and dz (scripts/measure_supcon_accuracy.py). So the products run in short
// chains into fresh accumulators, added here: s one k-step at a time, dz one
// column tile at a time.
template <int MI, int NJ>
__device__ __forceinline__ void add_rn(float (&d)[MI][NJ][4], const float (&p)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) d[i][j][k] = __fadd_rn(d[i][j][k], p[i][j][k]);
}

// ------------------------------------------------------------------ staging
// The row tile and the column vectors are copied by cp.async (a source size
// of 0 writes zeros: rows past the operand). The z rows of a column tile are
// copied by the copy engine, one cp.async.bulk per row, completing on the
// mbarrier of the tile's buffer, in place of 2048 16-byte cp.async a tile in
// the load/store queue ahead of the products' fragment loads.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Where element (r, k) of a staged z tile lies: odd rows are shifted by 8
// floats, so that the 16-byte fragment loads of two neighbouring rows fall
// on disjoint banks (SD = 8 mod 32).
__device__ __forceinline__ int z_at(int r, int k) { return r * SD + k + 8 * (r & 1); }

// Rows [r0, r0 + n) of src [*, d] into dst [n][SD] (z_at), zeros for rows at
// or past `limit` and for the depth past d (d % 4 == 0, 16-byte aligned rows).
__device__ __forceinline__ void issue_rows(float* dst, const float* __restrict__ src, int r0,
                                           int n, int limit, int d) {
  for (int i = threadIdx.x; i < n * (DP / 4); i += NT) {
    const int r = i / (DP / 4), k = (i % (DP / 4)) * 4;
    const bool in = r0 + r < limit && k < d;
    cp_async16(dst + z_at(r, k), in ? src + (size_t)(r0 + r) * d + k : src, in);
  }
}

// The column operands of one launch: z and up to six per-column vectors.
struct Cols {
  const float* z;
  const float* v[NVEC_BWD];  // lab, val, gid, (c, denom, a)
  int nvec;
};

// A block's ring of NSTAGE column-tile buffers, each with its mbarrier, and
// the parity of each mbarrier's next phase (bit j for buffer j).
struct Ring {
  float* buf;
  uint64_t* bar;
  int stage;
  uint32_t parity;
};

// Column tile `tile` into buffer j: its z rows by the copy engine (lanes 0-3
// of each warp, one row each: issuing all 32 from one warp stalls that warp
// longer; the depth past d stays zero from the kernel's start), its vectors
// [nvec][BN] by cp.async. The buffer's readers passed a barrier before this,
// which orders their reads before the copy engine's writes.
__device__ __forceinline__ void issue_tile(const Ring& R, int j, const Cols& C, int tile, int d) {
  float* st = R.buf + j * R.stage;
  if (threadIdx.x == 0) mbar_expect_tx(&R.bar[j], BN * d * 4);
  if ((threadIdx.x & 31) < BN / NWARP) {
    const int r = (threadIdx.x >> 5) * (BN / NWARP) + (threadIdx.x & 31);
    bulk_copy(st + z_at(r, 0), C.z + (size_t)(tile * BN + r) * d, d * 4, &R.bar[j]);
  }
  const int i = threadIdx.x;
  if (i < C.nvec * BN) {
    const int v = i / BN, c = i - v * BN;
    const float* p = C.v[0];
#pragma unroll
    for (int u = 1; u < NVEC_BWD; ++u)
      if (v == u) p = C.v[u];
    cp_async4(st + BN * SD + i, p + tile * BN + c);
  }
}

// Zero the ring where d < DP (the copy engine writes only d floats a row),
// and set up its mbarriers. Before any copy; ends with a barrier.
__device__ __forceinline__ void ring_init(Ring& R, int d) {
  if (d < DP)
    for (int i = threadIdx.x; i < NSTAGE * R.stage; i += NT) R.buf[i] = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < NSTAGE; ++j) mbar_init(&R.bar[j]);
    fence_mbar_init();
  }
  R.parity = 0;
  __syncthreads();
}

// The column sweep of one block over tiles [first, last) through the ring:
// tile i + NSTAGE - 1 is copied while tile i computes. Whatever the caller
// issued before by cp.async (the row tile) completes with the first tile;
// hook() runs once after it landed. f(z tile, vectors, tile).
template <class H, class F>
__device__ __forceinline__ void sweep(Ring& R, const Cols& C, int first, int last, int d,
                                      H hook, F f) {
#pragma unroll
  for (int j = 0; j < NSTAGE - 1; ++j) {
    if (first + j < last) issue_tile(R, j, C, first + j, d);
    cp_async_commit();
  }
  for (int i = first; i < last; ++i) {
    const int j = (i - first) % NSTAGE;
    cp_async_wait<NSTAGE - 2>();
    mbar_wait(&R.bar[j], (R.parity >> j) & 1);
    R.parity ^= 1u << j;
    __syncthreads();  // tile i landed; every reader of tile i - 1 is done
    const int ahead = i + NSTAGE - 1;
    if (ahead < last) issue_tile(R, (ahead - first) % NSTAGE, C, ahead, d);
    cp_async_commit();
    if (i == first) hook();
    float* st = R.buf + j * R.stage;
    f(st, st + BN * SD, i);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ------------------------------------------------------------------ products
// The depth order of the s product. Depth is summed over, so A and B only
// need the same order: within each 16 depths, k-step 2p + h takes MMA
// k-index t from depth 16p + 4t + 2h and t + 4 from the depth after it, so a
// lane reads the four values of two k-steps as one float4.
//
// The A fragments of warp w from the staged row tile: rows 32 (w & 1) + 16 mi
// + g (+8), depths 64 (w >> 1).. . They stay in registers for the sweep.
__device__ __forceinline__ void load_a(const float* rt, float (&a)[2][KSW][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, w = threadIdx.x >> 5;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float* r = rt + z_at(32 * (w & 1) + 16 * mi + 8 * hr + g, 8 * KSW * (w >> 1) + 4 * t);
#pragma unroll
      for (int p = 0; p < KSW / 2; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(r + 16 * p);
        a[mi][2 * p][hr] = v.x;
        a[mi][2 * p][2 + hr] = v.y;
        a[mi][2 * p + 1][hr] = v.z;
        a[mi][2 * p + 1][2 + hr] = v.w;
      }
    }
}

// Column of a partial s tile: 4-float chunks XOR-swizzled by the row, so that
// the fragment stores (rows g of a half-warp) and the epilogue's float4
// loads (two rows per quarter-warp) are free of bank conflicts.
__device__ __forceinline__ int part_col(int row, int col) {
  return (((col >> 2) ^ (((row & 3) << 1) ^ (row & 1))) << 2) | (col & 3);
}

// Warp w's share of the s tile: rows 32 (w & 1).. (two m16 fragments) x the
// tile's 32 columns (four n8 fragments) over its quarter of the depth, in
// 3xTF32, written to part[w >> 1][row][col].
__device__ __forceinline__ void s_partial(const float (&a)[2][KSW][4], const float* ct,
                                          float* part) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, w = threadIdx.x >> 5;
  const float* cb = ct + z_at(g, 8 * KSW * (w >> 1) + 4 * t);  // rows 8 nj + g
  float acc[2][4][4] = {};
#pragma unroll
  for (int p = 0; p < KSW / 2; ++p) {
    float4 v[4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) v[nj] = *reinterpret_cast<const float4*>(cb + nj * 8 * SD + 16 * p);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      FragA fa[2];
      FragB fb[4];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        fb[nj] = h ? frag_b(v[nj].z, v[nj].w) : frag_b(v[nj].x, v[nj].y);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float(&x)[4] = a[mi][2 * p + h];
        fa[mi] = frag_a(x[0], x[1], x[2], x[3]);
      }
      float step[2][4][4] = {};  // one k-step afresh
      mma3<2, 4>(step, fa, fb);
      add_rn<2, 4>(acc, step);
    }
  }
  const int row = (w >> 1) * BM + 32 * (w & 1) + g;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row + 16 * mi + 8 * hr;
        *reinterpret_cast<float2*>(part + r * PS + part_col(r, 8 * nj + 2 * t)) =
            make_float2(acc[mi][nj][2 * hr], acc[mi][nj][2 * hr + 1]);
      }
}

// s of the epilogue's eight elements, row er, columns ec..ec+7: the four
// depth quarters added in order.
__device__ __forceinline__ void s_sum(const float* part, int er, int ec, float (&s)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.0f;
#pragma unroll
  for (int q = 0; q < KQ; ++q) {
    const float* p = part + (q * BM + er) * PS;
    const float4 u = *reinterpret_cast<const float4*>(p + part_col(er, ec));
    const float4 v = *reinterpret_cast<const float4*>(p + part_col(er, ec + 4));
    s[0] += u.x;
    s[1] += u.y;
    s[2] += u.z;
    s[3] += u.w;
    s[4] += v.x;
    s[5] += v.y;
    s[6] += v.z;
    s[7] += v.w;
  }
}

// Eight consecutive values of a staged column vector.
__device__ __forceinline__ void vec8(const float* v, float (&out)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(v);
  const float4 w = *reinterpret_cast<const float4*>(v + 4);
  out[0] = u.x;
  out[1] = u.y;
  out[2] = u.z;
  out[3] = u.w;
  out[4] = w.x;
  out[5] = w.y;
  out[6] = w.z;
  out[7] = w.w;
}

// acc[mi][nj] += G[64 rows, tile] @ z_tile[:, depth fragment w + 8 nj] in
// 3xTF32: A = the G tile (row-major, stride GS), B = the z tile read by
// (column j, depth). (Its B loads have two-way bank conflicts.)
__device__ __forceinline__ void gz_tile(const float* gt, const float* ct,
                                        float (&acc)[4][NJ_DZ][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, w = threadIdx.x >> 5;
  float part[4][NJ_DZ][4] = {};  // this tile afresh, added to acc at its end
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    FragA a[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const float* gr = gt + (16 * mi + g) * GS + 8 * kk + t;
      a[mi] = frag_a(gr[0], gr[8 * GS], gr[4], gr[8 * GS + 4]);
    }
    FragB b[NJ_DZ];
#pragma unroll
    for (int nj = 0; nj < NJ_DZ; ++nj) {
      const int col = 8 * (w + NWARP * nj) + g;
      b[nj] = frag_b(ct[z_at(8 * kk + t, col)], ct[z_at(8 * kk + t + 4, col)]);
    }
    mma3<4, NJ_DZ>(part, a, b);
  }
  add_rn<4, NJ_DZ>(acc, part);
}

// ------------------------------------------------------------------ elementwise
__device__ __forceinline__ float pair_weight(float logp, float gamma, float inv_gamma, int mode) {
  if (mode == kModeHard) return (-logp <= gamma) ? 1.0f : 0.0f;
  if (mode == kModeSoft) return fmaxf(1.0f + logp * inv_gamma, 0.0f);
  return 1.0f;
}

// G term of one side: -(m * scale) * (p w / max(c, 1) - a * softmax), with
// the reciprocals 1 / max(c, 1) and 1 / (denom + eps) of the side's row.
__device__ __forceinline__ float g_term(float s, float p, float e, float c, float rc,
                                        float rden, float logden, float a_stat, float valid,
                                        float gamma, float inv_gamma, float scale, int mode) {
  const float m = (c > 0.0f ? 1.0f : 0.0f) * valid;
  const float w = pair_weight(s - logden, gamma, inv_gamma, mode);
  return -(m * scale) * (p * w * rc - a_stat * (e * rden));
}

__device__ __forceinline__ float row_value(const float* __restrict__ p, int r, int rows,
                                           float fill) {
  return r < rows ? p[r] : fill;
}

// The sum over the four lanes of an epilogue row, in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------------ forward
__global__ void __launch_bounds__(NT, 1)
supcon_fwd_kernel(const float* __restrict__ zr, Cols C, const float* __restrict__ lab_r,
                  const float* __restrict__ val_r, const float* __restrict__ gid_r, int rows,
                  int cols, int d, float inv_t, float gamma, int mode,
                  float* __restrict__ denom_out, float* __restrict__ c_out,
                  float* __restrict__ rawloss_out, float* __restrict__ spsum_out) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  float* keep = smem + F_KEEP;
  float *part = smem + F_PART, *psum = smem + F_PSUM, *tot = smem + F_TOT;
  const int tid = threadIdx.x;
  const int er = tid >> 2, ec = (tid & 3) * 8;  // epilogue: row er, columns ec..ec+7
  const int r0 = blockIdx.y * BM;
  const int ctiles = cols / BN;
  const int first = q * ctiles / S, last = (q + 1) * ctiles / S;
  const int kept = min(last - first, KEEP_MAX);
  const float inv_gamma = 1.0f / gamma;
  const float labr = row_value(lab_r, r0 + er, rows, -7.0f);
  const float valr = row_value(val_r, r0 + er, rows, 0.0f);
  const float gidr = row_value(gid_r, r0 + er, rows, -3.0f);
  __shared__ uint64_t bars[NSTAGE];
  Ring R = {smem + F_RING, bars, STAGE_FWD, 0};
  ring_init(R, d);
  issue_rows(smem + F_KEEP, zr, r0, BM, rows, d);  // completes with the first tile
  float a[2][KSW][4];

  // ---- pass A: denominators and positive counts; keep s for pass B
  float den = 0.0f, cnt = 0.0f;
  sweep(R, C, first, last, d, [&] { load_a(smem + F_KEEP, a); },
        [&](const float* ct, const float* cv, int tile) {
          s_partial(a, ct, part);
          __syncthreads();  // the partials are complete; every warp holds its A
          float s[8], lab[8], val[8], gid[8];
          s_sum(part, er, ec, s);
          vec8(cv + ec, lab);
          vec8(cv + BN + ec, val);
          vec8(cv + 2 * BN + ec, gid);
          const bool keep_it = tile - first < kept;
          float* kt = keep + (tile - first) * KEEP_TILE;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float sv = s[j] * inv_t - inv_t;
            const float av = (gid[j] != gidr ? 1.0f : 0.0f) * val[j] * valr;
            den += expf(av > 0.0f ? sv : kNegBig);
            cnt += (lab[j] == labr ? 1.0f : 0.0f) * av;
            if (keep_it) kt[j * NT + tid] = sv;
          }
          if (keep_it && tid < NVEC_FWD * BN) kt[BM * BN + tid] = cv[tid];
        });
  den = quad_sum(den);
  cnt = quad_sum(cnt);
  if ((tid & 3) == 0) {
    psum[er] = den;
    psum[BM + er] = cnt;
  }
  cluster.sync();
  if (tid < 2 * BM) {  // totals over the cluster, in block-rank order
    float v = 0.0f;
    for (int b = 0; b < S; ++b) v += cluster.map_shared_rank(psum, b)[tid];
    tot[tid] = v;  // tot[0][r] = denom, tot[1][r] = c
  }
  __syncthreads();
  const float logden = logf(tot[er] + kEps);

  // ---- pass B: self-paced weighted log-likelihood sums
  float raw = 0.0f, sps = 0.0f;
  auto pass_b = [&](const float (&s)[8], const float* cv) {
    float lab[8], val[8], gid[8];
    vec8(cv + ec, lab);
    vec8(cv + BN + ec, val);
    vec8(cv + 2 * BN + ec, gid);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float av = (gid[j] != gidr ? 1.0f : 0.0f) * val[j] * valr;
      const float p = (lab[j] == labr ? 1.0f : 0.0f) * av;
      const float logp = s[j] - logden;
      const float pw = p * pair_weight(logp, gamma, inv_gamma, mode);
      raw += pw * logp;
      sps += pw;
    }
  };
  for (int k = 0; k < kept; ++k) {
    const float* kt = keep + k * KEEP_TILE;
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = kt[j * NT + tid];
    pass_b(s, kt + BM * BN);
  }
  sweep(R, C, first + kept, last, d, [] {},
        [&](const float* ct, const float* cv, int) {
          s_partial(a, ct, part);
          __syncthreads();
          float s[8];
          s_sum(part, er, ec, s);
#pragma unroll
          for (int j = 0; j < 8; ++j) s[j] = s[j] * inv_t - inv_t;
          pass_b(s, cv);
        });
  raw = quad_sum(raw);
  sps = quad_sum(sps);
  if ((tid & 3) == 0) {
    psum[2 * BM + er] = raw;
    psum[3 * BM + er] = sps;
  }
  cluster.sync();
  if (q == 0 && tid < BM && r0 + tid < rows) {
    float rl = 0.0f, sp = 0.0f;
    for (int b = 0; b < S; ++b) {
      const float* pb = cluster.map_shared_rank(psum, b);
      rl += pb[2 * BM + tid];
      sp += pb[3 * BM + tid];
    }
    denom_out[r0 + tid] = tot[tid];
    c_out[r0 + tid] = tot[BM + tid];
    rawloss_out[r0 + tid] = rl;
    spsum_out[r0 + tid] = sp;
  }
  cluster.sync();  // no block leaves while rank 0 reads its partials
}

// ------------------------------------------------------------------ backward
__global__ void __launch_bounds__(NT, 1)
supcon_bwd_kernel(const float* __restrict__ zr, Cols C, const float* __restrict__ lab_r,
                  const float* __restrict__ val_r, const float* __restrict__ gid_r,
                  const float* __restrict__ c_r, const float* __restrict__ den_r,
                  const float* __restrict__ a_r, int rows, int cols, int d, float inv_t,
                  float gamma, const float* __restrict__ scale_ptr, int mode,
                  float* __restrict__ dz) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  float* rt = smem;
  float *part = smem + B_PART, *gt = smem + B_G, *cst = smem + B_CST;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int er = tid >> 2, ec = (tid & 3) * 8;
  const int r0 = blockIdx.y * BM;
  const int ctiles = cols / BN;
  const int first = q * ctiles / S, last = (q + 1) * ctiles / S;
  const float scale = *scale_ptr;
  const float inv_gamma = 1.0f / gamma;
  const float labr = row_value(lab_r, r0 + er, rows, -7.0f);
  const float valr = row_value(val_r, r0 + er, rows, 0.0f);
  const float gidr = row_value(gid_r, r0 + er, rows, -3.0f);
  const float cr = row_value(c_r, r0 + er, rows, 0.0f);
  const float denr = row_value(den_r, r0 + er, rows, 0.0f);
  const float ar = row_value(a_r, r0 + er, rows, 0.0f);
  const float logdr = logf(denr + kEps), rdenr = __frcp_rn(denr + kEps);
  const float rcr = __frcp_rn(fmaxf(cr, 1.0f));
  __shared__ uint64_t bars[NSTAGE];
  Ring R = {smem + B_RING, bars, STAGE_BWD, 0};
  ring_init(R, d);
  issue_rows(rt, zr, r0, BM, rows, d);
  float a[2][KSW][4];

  float acc[4][NJ_DZ][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ_DZ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;

  sweep(R, C, first, last, d, [&] { load_a(rt, a); },
        [&](const float* ct, const float* cv, int) {
          if (tid < BN) {  // the column side's terms of G, once a tile
            const float den = cv[4 * BN + tid];
            cst[tid] = logf(den + kEps);
            cst[BN + tid] = __frcp_rn(den + kEps);
            cst[2 * BN + tid] = __frcp_rn(fmaxf(cv[3 * BN + tid], 1.0f));
          }
          s_partial(a, ct, part);
          __syncthreads();  // the partials and the column terms are complete
          float s[8], lab[8], val[8], gid[8], cc[8], ac[8], logdc[8], rdenc[8], rcc[8];
          s_sum(part, er, ec, s);
          vec8(cv + ec, lab);
          vec8(cv + BN + ec, val);
          vec8(cv + 2 * BN + ec, gid);
          vec8(cv + 3 * BN + ec, cc);
          vec8(cv + 5 * BN + ec, ac);
          vec8(cst + ec, logdc);
          vec8(cst + BN + ec, rdenc);
          vec8(cst + 2 * BN + ec, rcc);
          float gv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float sv = s[j] * inv_t - inv_t;
            const float av = (gid[j] != gidr ? 1.0f : 0.0f) * val[j] * valr;
            const float p = (lab[j] == labr ? 1.0f : 0.0f) * av;
            const float ex = expf(av > 0.0f ? sv : kNegBig);
            const float g_row = g_term(sv, p, ex, cr, rcr, rdenr, logdr, ar, valr, gamma,
                                       inv_gamma, scale, mode);
            const float g_col = g_term(sv, p, ex, cc[j], rcc[j], rdenc[j], logdc[j], ac[j],
                                       val[j], gamma, inv_gamma, scale, mode);
            gv[j] = (g_row + g_col) * inv_t;
          }
          float* gp = gt + er * GS + ec;
          *reinterpret_cast<float4*>(gp) = make_float4(gv[0], gv[1], gv[2], gv[3]);
          *reinterpret_cast<float4*>(gp + 4) = make_float4(gv[4], gv[5], gv[6], gv[7]);
          __syncthreads();  // the G tile is complete
          gz_tile(gt, ct, acc);
        });

  // ---- the block's partial dz [BM][DP] (row-major) over the row tile's buffer
  float* pz = rt;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ_DZ; ++nj) {
      const int col = 8 * (warp + NWARP * nj) + 2 * t;
      *reinterpret_cast<float2*>(pz + (16 * mi + g) * DP + col) =
          make_float2(acc[mi][nj][0], acc[mi][nj][1]);
      *reinterpret_cast<float2*>(pz + (16 * mi + g + 8) * DP + col) =
          make_float2(acc[mi][nj][2], acc[mi][nj][3]);
    }
  cluster.sync();
  // block q adds its slice of the partials of every block, in block-rank order
  constexpr int n4 = BM * DP / 4;
  for (int i = q * n4 / S + tid; i < (q + 1) * n4 / S; i += NT) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int b = 0; b < S; ++b) {
      const float4 u = cluster.map_shared_rank(reinterpret_cast<float4*>(pz), b)[i];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int r = i / (DP / 4), col = (i % (DP / 4)) * 4;
    if (r0 + r < rows) {
      float* out = dz + (size_t)(r0 + r) * d + col;
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d) out[e] = vals[e];
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// ------------------------------------------------------------------ launch plan
bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// z of depth d % 4 == 0 (at most DP) with 16-byte aligned rows; rows and
// columns padded to kTile.
bool shapes_ok(const float* zr, const float* zc, int rows, int cols, int d) {
  return rows > 0 && cols > 0 && d > 0 && d <= DP && d % 4 == 0 && rows % kTile == 0 &&
         cols % kTile == 0 && aligned16(zr) && aligned16(zc);
}

struct Plan {
  int cluster, row_tiles, tiles_per_block, kept, active_clusters, smem;
};

// Per kernel, once: whether clusters of more than 8 are allowed, and per
// cluster size the number of clusters the card holds at once.
struct KernelInfo {
  bool ready = false;
  int active[MAX_CLUSTER + 1] = {};
};

KernelInfo g_info[2];

template <class K>
cudaError_t kernel_info(K kernel, int which, int smem, KernelInfo** out) {
  KernelInfo& I = g_info[which];
  if (!I.ready) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const bool nonportable =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
        cudaSuccess;
    cudaGetLastError();  // a refusal only limits the cluster size to 8
    for (int s = 1; s <= MAX_CLUSTER; ++s) {
      I.active[s] = 0;
      if (s > 8 && !nonportable) continue;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(s, 1, 1);
      cfg.blockDim = dim3(NT, 1, 1);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = s;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
        cudaGetLastError();
        n = 0;
      }
      I.active[s] = n;
    }
    I.ready = true;
  }
  *out = &I;
  return cudaSuccess;
}

// The cluster size S for a launch: the least estimated time, counting waves
// of clusters (rows / 64 of them, `active` at once) times the column tiles a
// block sweeps (the forward's recomputed tiles twice, the backward's two
// products twice) plus a fixed cost per block (row tile, cluster sums).
template <class K>
cudaError_t make_plan(K kernel, int which, int rows, int cols, Plan* P) {
  const bool bwd = which == 1;
  const int smem = 4 * (bwd ? BWD_FLOATS : FWD_FLOATS);
  KernelInfo* I = nullptr;
  cudaError_t err = kernel_info(kernel, which, smem, &I);
  if (err != cudaSuccess) return err;
  const int row_tiles = (rows + BM - 1) / BM, ctiles = cols / BN;
  long best = -1;
  *P = {};
  for (int s = 1; s <= MAX_CLUSTER && s <= ctiles; ++s) {
    if (I->active[s] <= 0) continue;
    const int per = (ctiles + s - 1) / s;
    const int kept = per < KEEP_MAX ? per : KEEP_MAX;
    const long work = bwd ? 4L * per : 2L * per + 2L * (per - kept);
    const long waves = (row_tiles + I->active[s] - 1) / I->active[s];
    const long cost = waves * (work + 3);
    if (best < 0 || cost < best) {
      best = cost;
      *P = {s, row_tiles, per, bwd ? 0 : kept, I->active[s], smem};
    }
  }
  return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <class K, class... Args>
cudaError_t launch(K kernel, const Plan& P, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.cluster, P.row_tiles, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = P.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = P.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows and columns must be padded to a multiple of this.
int supcon_tile() { return kTile; }

// The launch plan of supcon_fwd (which 0) or supcon_bwd (which 1) at this
// shape: out = {cluster size, row tiles, column tiles per block, tiles whose
// s the forward keeps, clusters resident at once, dynamic shared memory
// bytes, most tiles the forward can keep}. Returns a cudaError_t.
int supcon_plan(int which, int rows, int cols, int d, int* out) {
  if (rows <= 0 || cols <= 0 || rows % kTile || cols % kTile || d <= 0 || d > DP ||
      (which != 0 && which != 1))
    return (int)cudaErrorInvalidValue;
  Plan P;
  cudaError_t err = which ? make_plan(supcon_bwd_kernel, 1, rows, cols, &P)
                          : make_plan(supcon_fwd_kernel, 0, rows, cols, &P);
  if (err != cudaSuccess) return (int)err;
  const int v[7] = {P.cluster, P.row_tiles, P.tiles_per_block, P.kept, P.active_clusters,
                    P.smem, which ? 0 : KEEP_MAX};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

int supcon_fwd(const float* zr, const float* zc, const float* lab_r, const float* lab_c,
               const float* val_r, const float* val_c, const float* gid_r,
               const float* gid_c, int rows, int cols, int d, float inv_t, float gamma,
               int mode, float* denom, float* c, float* rawloss, float* spsum,
               void* stream) {
  if (!shapes_ok(zr, zc, rows, cols, d)) return (int)cudaErrorInvalidValue;
  Plan P;
  cudaError_t err = make_plan(supcon_fwd_kernel, 0, rows, cols, &P);
  if (err != cudaSuccess) return (int)err;
  const Cols C = {zc, {lab_c, val_c, gid_c, lab_c, lab_c, lab_c}, NVEC_FWD};
  return (int)launch(supcon_fwd_kernel, P, (cudaStream_t)stream, zr, C, lab_r, val_r, gid_r,
                     rows, cols, d, inv_t, gamma, mode, denom, c, rawloss, spsum);
}

int supcon_bwd(const float* zr, const float* zc, const float* lab_r, const float* lab_c,
               const float* val_r, const float* val_c, const float* gid_r,
               const float* gid_c, const float* c_r, const float* c_c,
               const float* den_r, const float* den_c, const float* a_r,
               const float* a_c, int rows, int cols, int d, float inv_t, float gamma,
               const float* scale, int mode, float* dz, void* stream) {
  if (!shapes_ok(zr, zc, rows, cols, d)) return (int)cudaErrorInvalidValue;
  Plan P;
  cudaError_t err = make_plan(supcon_bwd_kernel, 1, rows, cols, &P);
  if (err != cudaSuccess) return (int)err;
  const Cols C = {zc, {lab_c, val_c, gid_c, c_c, den_c, a_c}, NVEC_BWD};
  return (int)launch(supcon_bwd_kernel, P, (cudaStream_t)stream, zr, C, lab_r, val_r, gid_r,
                     c_r, den_r, a_r, rows, cols, d, inv_t, gamma, scale, mode, dz);
}

}  // extern "C"
