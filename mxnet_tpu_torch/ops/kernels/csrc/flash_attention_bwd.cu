// Flash-attention backward for Hopper (sm_90a), float32: dq and dk/dv.
//
// Replaces: mxnet_tpu_flash_attention_dq (mxnet_tpu/ops/pallas/attention.py:208)
// and mxnet_tpu_flash_attention_dkv (attention.py:243), the backward of
// every transformer training step with the attention kernels on.
//
// Both recompute the probabilities from the forward's log-sum-exp, as
// _p_block (attention.py:195) does, in the JAX order of operations:
//   s  = (q . k) * scale, masked keys (k >= length, or k > q if causal)
//        give p = 0
//   p  = 0 if masked or lse == -inf, else exp(s - lse)
//   dp = do . v;  delta = rowsum(do * o)
//   ds = p * (dp - delta) * scale
//   dq = sum_k ds k;  dk = sum_q ds q;  dv = sum_q p do
// A row with no visible key (length 0) has lse == -inf and gives dq == 0
// and nothing to dk/dv; no NaN is formed.
//
// What bounds them on the H100: at BERT-base training shapes (B*H 1152,
// S 128, D 64) dq does 3 and dk/dv 4 products of 2*S*S*D flops per
// (batch, head): 7.2 and 9.7 GFLOP against 0.23 and 0.26 GB of q, k, v,
// o, do in and gradients out. Both run their products on the tensor
// cores in 3xTF32 (3 x 7.2 and 3 x 9.7 GFLOP at 495 TFLOP/s, 0.044 and
// 0.059 ms), so their bytes at 3.35 TB/s (0.068 and 0.079 ms) bound
// them.
//
// Head dims. Every D from 1 to 128 runs, through instances built at the
// padded widths W = 16, 32, 64 and 128 (the smallest W >= D, which the
// wrapper passes: attention.py head_width), each for D == W (FULL: the row
// stride a constant, the code of a kernel built for that D alone) and for
// D < W. The tiles hold W columns (32 at W 16, whose rows then keep the
// swizzle's four 8-float groups), columns past D zero-filled by the copy
// (src-size 0), so every product over W is the product over D and only
// the D real columns are written. Where D % 4 != 0 a row of an (n, D)
// matrix does not start on 16 bytes, and the copies go 4 bytes at a time.
// At W 128 a warp owns one m16 tile (16 rows), not two, so that its dQ,
// or dK and dV, accumulators stay the 64 or 128 floats a thread of W 64,
// and a block is 8 warps, one an SM (192 KB and 225 KB of tiles): dq
// 128 queries, dk/dv 128 keys a block at every width (Shape below).
//
// Design. Each output tile is owned by one block, so no sum crosses
// blocks and there is no atomicAdd (results are deterministic); the TPU
// grid's sequential walk becomes a loop inside the block.
//   * dq (namespace dqk below): four warps, each owning 32 query rows
//     (eight of 16 at W 128), run S = Q K^T, dP = dO V^T and dQ += dS K
//     as m16n8k8 TF32 mma products in 3xTF32, its scores and gradients in
//     mma fragments, K/V double-buffered by cp.async into swizzled tiles;
//     its own note below.
//   * dk/dv (namespace dkvk): the same helpers transposed: four warps,
//     each owning 32 key rows (eight of 16 at W 128), run S^T = K Q^T,
//     dP^T = V dO^T, dV += P^T dO and dK += dS^T Q, the query tiles (Q,
//     dO, O and lse) double-buffered; its own note below.
//   * delta is recomputed by each kernel from do and o, as the TPU kernels
//     do, so the two launches stay independent.
//
// bf16 (AMP): dq and dk/dv are kernels of their own on the bf16 tensor
// cores (rows 2b and 3b: csrc/flash_attention_dq_bf16.cu,
// csrc/flash_attention_dkv_bf16.cu); they round ds (and p) to bf16 before
// the products that take them, another function.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// ---- dq and dk/dv: the products on the tensor cores in 3xTF32 ----
//
// Why the tensor cores here and not in the forward: the forward must stay
// bitwise equal to the decode kernel (flash_attention_fwd.cu), so every
// score there is one float32 fma chain in a fixed order; dq, dk and dv
// have no such contract, only the 1e-5 tier (relative to their max abs),
// which 3xTF32 holds: x = big + small with big = tf32(x) and small =
// tf32(x - big) (big rounded to nearest on the 10-bit mantissa, small
// toward zero) keeps 21 of x's 24 bits, and big.big + big.small +
// small.big drops only the small.small term (2^-22 relative), summed in
// float32 by the mma.

// The instances at padded width W: rows a block owns, the tiles' row
// stride RS in floats (at least 32: four 8-float groups), and the m16
// tiles a warp of dq and dk/dv (MT) and of dk/dv for D < W (one where two
// would hold more accumulators than 255 registers and spill: every
// instance at W 128, and dk/dv's D < W at W 64, whose 4-byte copies and
// column predicates cost registers the D == W instance does not spend). A kernel of MT tiles a warp runs 8 / MT warps, 128 rows a block,
// and two blocks an SM at MT 2, one at MT 1 (Warps below).
template <int W>
struct Shape {
  static constexpr int ROWS = 128;                    // rows a block owns
  static constexpr int RS = W + (32 - W) * (W < 32);  // floats a row, >= 32
  static constexpr int CHUNKS = W / 4;          // 16-byte chunks staged a row
  static constexpr int MT = 2 - (W > 64);
  static constexpr int DKV_MT_PART = 2 - (W >= 64);
  // dq: the Q and dO tiles, two K and two V tiles of DQ_BK keys (96 KB at
  // W 64: two blocks an SM)
  static constexpr int DQ_BK = 32;
  static constexpr int DQ_SMEM_BYTES = (2 * ROWS * RS + 4 * DQ_BK * RS) * 4;
  // dk/dv: the K and V tiles, two Q, dO and O tiles of DKV_BQ queries, two
  // lse and delta rows (112.5 KB at W 64: two blocks an SM)
  static constexpr int DKV_BQ = 32;
  static constexpr int DKV_SMEM_BYTES =
      (2 * ROWS * RS + 6 * DKV_BQ * RS + 4 * DKV_BQ) * 4;
};

// The warps of a kernel of MT m16 tiles a warp
template <int MT>
struct Warps {
  static constexpr int WARPS = 8 / MT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = MT;  // blocks an SM
};

// lane offsets a row of RS floats keeps: of its first NX column groups
template <int RS>
constexpr int NX = RS / 8 < 8 ? RS / 8 : 8;

// the lane's offset of column group k (any) from its offsets o of the
// first NX groups (xo or yo[e] of lane_offsets)
template <int RS>
__device__ __forceinline__ int group(const int (&o)[NX<RS>], int k) {
  return o[k % NX<RS>] + 8 * NX<RS> * (k / NX<RS>);
}

// Namespace dqk holds the helpers both kernels share and the dq kernel.
namespace dqk {

// Float offset of (row, col) in a tile of RS-float rows, no padding: the
// 8-float group of the column XOR-ed with two bits of the row. The warps'
// fragment loads then hit distinct banks: the float2 loads of rows 8m + g
// (A, and B of S and dP: lanes g = 0-3 of a half-warp, columns 8kk + 2tq)
// and the scalar loads of rows 8m + 2tq (+ 1) (B of dS.K, columns
// 8n + g); a 16-byte staging copy keeps its chunk whole. For a row 8m + u
// (u < 8) the XOR is that of u alone, flipped by 2 when m is odd, and it
// moves a group only within its aligned four, so the kernel precomputes
// each lane's offsets of the first NX groups once (NX = RS / 8, at most
// 8) and adds 8 NX floats for each NX groups after them (group()).
template <int RS>
__device__ __forceinline__ int swz(int row, int col) {
  return row * RS + (col ^ (((row ^ (row >> 2)) & 3) << 3));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// one float; src-size 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows row0 .. row0 + ROWS - 1 of an (n, d) matrix into a swizzled tile
// by NT threads: thread t copies chunk t % CHUNKS of rows t / CHUNKS + i
// NT / CHUNKS by cp.async; rows >= n and columns >= d become zeros
// (src-size 0). FULL (d == W): one 16-byte copy a chunk; else d % 4 == 0:
// one 16-byte copy a chunk inside the row, else four of 4 bytes (the row
// does not start on 16 bytes). The caller commits the group.
template <int W, bool FULL, int ROWS, int NT>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int n, int d, int t) {
  constexpr int RS = Shape<W>::RS;
  constexpr int CHUNKS = Shape<W>::CHUNKS;
  static_assert(ROWS * CHUNKS % NT == 0 && NT % CHUNKS == 0, "stage");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NT; ++i) {
    const int idx = t + i * NT;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const bool valid = row0 + r < n;
    const float* row = src + (size_t)(valid ? row0 + r : 0) * d;
    float* at = dst + swz<RS>(r, 4 * c);
    if (FULL) {
      cp_async16(at, row + 4 * c, valid);
    } else if ((d & 3) == 0) {
      const bool in = valid && 4 * c < d;
      cp_async16(at, in ? row + 4 * c : row, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = valid && 4 * c + e < d;
        cp_async4(at + e, in ? row + 4 * c + e : row, in);
      }
    }
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float exp2f_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = big + small, as CUTLASS's fast 3xTF32 splits it: big = tf32(x)
// rounded to nearest, ties away from zero, on the 10-bit mantissa (the
// bits of cvt.rna.tf32.f32, which ptxas expands to a longer sequence than
// this add-and-mask; finite inputs), small = x - big (exact) handed to
// the mma whole, which reads a tf32 operand's top 19 bits: small rounded
// toward zero. Three instructions an element.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a . b: one m16n8k8 product, tf32 operands, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m][n0 + n] += A[m] . B[n] over the M m-tiles and N n-tiles in
// 3xTF32, the small terms first: each B fragment is split once for all
// m-tiles, and each pass leaves M x N independent accumulators in flight
template <int M, int N, int NA>
__device__ __forceinline__ void mma3(float (&acc)[M][NA][4], int n0,
                                     const float (&a)[M][4],
                                     const float (&b)[N][2]) {
  uint32_t ab[M][4], as[M][4], bb[N][2], bs[N][2];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[m][e], ab[m][e], as[m][e]);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b[n][0], bb[n][0], bs[n][0]);
    split(b[n][1], bb[n][1], bs[n][1]);
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[m][n0 + n], as[m], bb[n]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[m][n0 + n], ab[m], bs[n]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[m][n0 + n], ab[m], bb[n]);
}

// acc = A B^T for the warp's 16 M rows (m-tile m: wrow + 16m + g and
// wrow + 16m + 8 + g, wrow a multiple of 16) of the tile `at` against the
// first 8 N rows of `bt`, over the width: S = Q K^T and dP = dO V^T in dq,
// S^T = K Q^T and dP^T = V dO^T in dk/dv. The k index (d) is permuted
// within each 8-group alike in A and B (the mma's column t holds d = 2t,
// column t + 4 holds d = 2t + 1), so each lane's A and B values are
// float2 loads; group(xo, k) is the lane's offset of column group k in a
// row 8m + g with m even (group(xo, k ^ 2): m odd).
template <int W, int M, int N>
__device__ __forceinline__ void product_nt(float (&acc)[M][N][4],
                                           const float* at, const float* bt,
                                           int wrow,
                                           const int (&xo)[NX<Shape<W>::RS>]) {
  constexpr int RS = Shape<W>::RS;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    float a[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float2 lo = ld2(at + (wrow + 16 * m) * RS + group<RS>(xo, kk));
      const float2 hi =
          ld2(at + (wrow + 16 * m + 8) * RS + group<RS>(xo, kk ^ 2));
      a[m][0] = lo.x;
      a[m][1] = hi.x;
      a[m][2] = lo.y;
      a[m][3] = hi.y;
    }
    float b[N][2];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float2 x =
          ld2(bt + 8 * n * RS + group<RS>(xo, kk ^ ((n & 1) << 1)));
      b[n][0] = x.x;
      b[n][1] = x.y;
    }
    mma3(acc, 0, a, b);
  }
}

// acc += P B for the warp's M m-tiles, P (16 rows x 8 KT columns) straight
// from an accumulator of product_nt and B the first 8 KT rows of the tile
// `bt` (W columns, W / 8 n-tiles, taken 8 at a time): dQ += dS K in dq,
// dV += P^T dO and dK += dS^T Q in dk/dv. k-step kk takes P's columns 8kk
// .. 8kk + 7 (A column t <- column 2t from element 0 / 2, t + 4 <- 2t + 1
// from element 1 / 3), so no shuffle moves the accumulator layout into
// the operand layout; B n-tile n is bt[rows][8n .. 8n + 7] with the same
// row order. group(yo[e], n) is the lane's offset of column group n in a
// row 8m + 2tq + e with m even.
template <int W, int M, int KT>
__device__ __forceinline__ void product_pb(
    float (&acc)[M][W / 8][4], const float (&p)[M][KT][4], const float* bt,
    const int (&yo)[2][NX<Shape<W>::RS>]) {
  constexpr int RS = Shape<W>::RS;
  constexpr int NT = W / 8;
  constexpr int NC = NT < 8 ? NT : 8;  // n-tiles a pass
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    float a[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      a[m][0] = p[m][kk][0];
      a[m][1] = p[m][kk][2];
      a[m][2] = p[m][kk][1];
      a[m][3] = p[m][kk][3];
    }
    const int flip = (kk & 1) << 1;
#pragma unroll
    for (int c = 0; c < NT / NC; ++c) {
      float b[NC][2];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int nn = NC * c + n;
        b[n][0] = bt[8 * kk * RS + group<RS>(yo[0], nn ^ flip)];
        b[n][1] = bt[8 * kk * RS + group<RS>(yo[1], nn ^ flip)];
      }
      mma3(acc, NC * c, a, b);
    }
  }
}

// acc[m][n] of product_pb into rows row0 + 16m + g (elements 0, 1) and
// + 8 (2, 3), dims 8n + 2tq + 0/1, of an (n, d) matrix: one 8-byte store a
// pair (FULL), else the columns < d a float at a time (a row of d columns
// need not start on 8 bytes); rows >= n skipped
template <int W, bool FULL, int M>
__device__ __forceinline__ void store_rows(const float (&acc)[M][W / 8][4],
                                           float* out, int row0, int n,
                                           int d, int g, int tq) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * m + 8 * h + g;
      if (r < n) {
        float* row = out + (size_t)r * d + 2 * tq;
#pragma unroll
        for (int c = 0; c < W / 8; ++c) {
          if (FULL) {
            *reinterpret_cast<float2*>(row + 8 * c) =
                make_float2(acc[m][c][2 * h], acc[m][c][2 * h + 1]);
          } else {
            if (8 * c + 2 * tq < d) row[8 * c] = acc[m][c][2 * h];
            if (8 * c + 2 * tq + 1 < d) row[8 * c + 1] = acc[m][c][2 * h + 1];
          }
        }
      }
    }
}

// the lane's fragment offsets (floats; see swz) of the first NX column
// groups: in a row 8m + g, m even (xo), and in a row 8m + 2tq + e, m even
// (yo[e])
template <int RS>
__device__ __forceinline__ void lane_offsets(int g, int tq,
                                             int (&xo)[NX<RS>],
                                             int (&yo)[2][NX<RS>]) {
  const int sg = (g ^ (g >> 2)) & 3;
#pragma unroll
  for (int kk = 0; kk < NX<RS>; ++kk)
    xo[kk] = g * RS + 8 * (kk ^ sg) + 2 * tq;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int u = 2 * tq + e;
    const int su = (u ^ (u >> 2)) & 3;
#pragma unroll
    for (int n = 0; n < NX<RS>; ++n) yo[e][n] = u * RS + 8 * (n ^ su) + g;
  }
}

// lse and delta = rowsum(dO * O) of the thread's rows (element h of
// m-tile m: row wrow + 16m + 8h + g), from the staged dO tile and O in
// device memory: lane l < 16 MT sums row wrow + l, and shuffles hand each
// lane its rows. FULL: 16-byte loads of O, else a float at a time over
// the d real columns
template <int W, bool FULL, int MT>
__device__ __forceinline__ void row_stats(float (&lse_r)[MT][2],
                                          float (&delta_r)[MT][2],
                                          const float* lse, const float* o,
                                          const float* dos, int q0, int sq,
                                          int d, int wrow, int lane, int g) {
  constexpr int RS = Shape<W>::RS;
  const int row = wrow + lane;
  float acc = 0.f;
  if (lane < 16 * MT && q0 + row < sq) {
    const float* orow = o + (size_t)(q0 + row) * d;
    if (FULL) {
#pragma unroll
      for (int c = 0; c < W; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(dos + swz<RS>(row, c));
        const float4 b = *reinterpret_cast<const float4*>(orow + c);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    } else {
      for (int c = 0; c < d; ++c)
        acc = fmaf(dos[swz<RS>(row, c)], orow[c], acc);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + 8 * h + g;  // of the warp's 16 MT
      delta_r[m][h] = __shfl_sync(0xffffffffu, acc, r);
      const int qi = q0 + wrow + r;
      lse_r[m][h] = qi < sq ? lse[qi] : -CUDART_INF_F;
    }
}

// Design. A block of WARPS warps owns a 128-row query tile of one (batch,
// head); blocks walk items (batch*head, query tile) with the query tiles
// of a head adjacent, so a head's K and V are read from memory once and
// from L2 after; two blocks an SM (one at W 128). Warp w owns rows 16 MT
// w .. + 16 MT - 1, MT m16 tiles (two; one at W 128), and keeps their
// scores, dP, dS and dQ in mma fragments (registers) throughout; every K
// and V fragment a lane loads and splits serves its m-tiles. Per 32-key
// tile:
//   S = Q K^T and dP = dO V^T (four m16n8 tiles each an m-tile, k over
//   d), then p and ds in place in the fragments, then dQ += dS K with dS
//   as the A operand straight from dP's fragments: the key index is
//   permuted within each 8-group alike in A and B (column t <- key 2t,
//   t + 4 <- key 2t + 1), so no shuffle moves the accumulator layout into
//   the operand layout. Every product is 3xTF32 (m16n8k8, three mma
//   each).
// Q and dO are staged once, K and V double-buffered: the next tile's
// 16-byte cp.async copies run while this one is computed, one block
// barrier a tile; tiles swizzled without padding, every fragment address
// a precomputed lane offset plus a constant. delta and lse stay in
// registers. Key tiles past the block's last visible key are not walked;
// a block with none writes zeros; the masks are skipped where a whole
// tile is visible to every row.
template <int W, bool FULL, int MT = Shape<W>::MT>
__global__ void __launch_bounds__(Warps<MT>::THREADS, Warps<MT>::MIN_BLOCKS)
flash_attention_dq_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ o,
                          const float* __restrict__ lse,
                          const float* __restrict__ dout,
                          const int* __restrict__ lengths,
                          float* __restrict__ dq, int heads, int sq, int sk,
                          int d_arg, float scale, int causal) {
  using S = Shape<W>;
  constexpr int THREADS = Warps<MT>::THREADS;
  constexpr int BQ = S::ROWS;     // query rows a block
  constexpr int BK = S::DQ_BK;    // keys a tile
  constexpr int NS = BK / 8;      // the tile's m16n8 key tiles
  constexpr int QTILE = BQ * S::RS;
  constexpr int KTILE = BK * S::RS;
  const int d = FULL ? W : d_arg;  // the real head dim: the row stride
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [BQ][RS] swizzled
  float* dos = qs + QTILE;     // [BQ][RS] swizzled
  float* ks = dos + QTILE;     // 2 x [BK][RS] swizzled
  float* vs = ks + 2 * KTILE;  // 2 x [BK][RS] swizzled

  const int qtiles = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / heads;
  const int q0 = (blockIdx.x % qtiles) * BQ;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wrow = 16 * MT * w;  // the thread's rows: wrow + 16m + 8h + g
  const size_t qoff = (size_t)bh * sq * d;
  const float* kb = k + (size_t)bh * sk * d;
  const float* vb = v + (size_t)bh * sk * d;

  int xo[NX<S::RS>], yo[2][NX<S::RS>];
  lane_offsets<S::RS>(g, tq, xo, yo);

  const int len = max(0, min(lengths[b], sk));
  int kend = len;  // one past the last key any row of the block sees
  if (causal) kend = min(kend, min(q0 + BQ, sq));
  const int ntiles = (kend + BK - 1) / BK;

  float acc[MT][W / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  if (ntiles > 0) {
    stage<W, FULL, BQ, THREADS>(qs, q + qoff, q0, sq, d, t);
    stage<W, FULL, BQ, THREADS>(dos, dout + qoff, q0, sq, d, t);
    stage<W, FULL, BK, THREADS>(ks, kb, 0, sk, d, t);
    stage<W, FULL, BK, THREADS>(vs, vb, 0, sk, d, t);
    cp_async_commit();
  }
  float lse_r[MT][2] = {}, delta_r[MT][2] = {}, lse2[MT][2] = {};
  // exp(x) = 2^(x log2 e): the scores and lse pre-scaled, one fma and
  // ex2.approx an element
  const float scale2 = scale * LOG2E;
  for (int j = 0; j < ntiles; ++j) {
    const int kbase = j * BK;
    cp_async_wait_all();  // tile j (and at j == 0 Q and dO) has landed
    __syncthreads();      // visible to all; tile j - 1 consumed
    if (j + 1 < ntiles) {
      stage<W, FULL, BK, THREADS>(ks + ((j + 1) & 1) * KTILE, kb, kbase + BK,
                                  sk, d, t);
      stage<W, FULL, BK, THREADS>(vs + ((j + 1) & 1) * KTILE, vb, kbase + BK,
                                  sk, d, t);
      cp_async_commit();
    }
    if (j == 0)
      row_stats<W, FULL>(lse_r, delta_r, lse + (size_t)bh * sq, o + qoff,
                         dos, q0, sq, d, wrow, lane, g);
    const float* kt = ks + (j & 1) * KTILE;
    const float* vt = vs + (j & 1) * KTILE;

    if (j == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) lse2[m][h] = lse_r[m][h] * LOG2E;
    }
    float s[MT][NS][4], dp[MT][NS][4];
    product_nt<W>(s, qs, kt, wrow, xo);
    product_nt<W>(dp, dos, vt, wrow, xo);
    // p = exp(s * scale - lse) = 2^(s * scale log2 e - lse log2 e)
    // (ex2.approx), 0 where masked or lse == -inf (the exponential taken
    // unconditionally, selected after); ds = p * (dp - delta) * scale,
    // in dp's registers. Element e of n-tile n of m-tile m: row wrow +
    // 16m + 8 (e >> 1) + g, key kbase + 8n + 2tq + (e & 1). In a tile
    // visible to every row of the block no row has lse == -inf, and
    // nothing is masked.
    const bool whole = q0 + BQ <= sq && kbase + BK <= len &&
                       (!causal || kbase + BK - 1 <= q0);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_i = lse_r[m][e >> 1];
          const float delta_i = delta_r[m][e >> 1];
          const float ex = exp2f_approx(s[m][n][e] * scale2 - lse2[m][e >> 1]);
          float p = ex;
          if (!whole) {
            const int qi = q0 + wrow + 16 * m + 8 * (e >> 1) + g;
            const int kj = kbase + 8 * n + 2 * tq + (e & 1);
            const bool vis = lse_i != -CUDART_INF_F && kj < len &&
                             (!causal || kj <= qi);
            p = vis ? ex : 0.f;
          }
          dp[m][n][e] = p * (dp[m][n][e] - delta_i) * scale;
        }
    // dQ += dS K: k-step jj takes keys 8jj .. 8jj + 7
    product_pb<W>(acc, dp, kt, yo);
  }
  store_rows<W, FULL>(acc, dq + qoff, q0 + wrow, sq, d, g, tq);
}

}  // namespace dqk

// ---- dk/dv: dq's helpers on the transposed problem ----
namespace dkvk {

using dqk::LOG2E;
using dqk::cp_async16;
using dqk::cp_async4;
using dqk::cp_async_commit;
using dqk::cp_async_wait_all;
using dqk::exp2f_approx;
using dqk::lane_offsets;
using dqk::ld2;
using dqk::product_nt;
using dqk::product_pb;
using dqk::stage;
using dqk::store_rows;
using dqk::swz;

// the Q, dO and O tiles of query rows row0 .. row0 + BQ - 1 and their
// lse, each lse by the thread that copies its row's first chunk (rows >= n
// become zeros). The caller commits the group.
template <int W, bool FULL, int THREADS>
__device__ __forceinline__ void stage_queries(float* qt, float* dot,
                                              float* ot, float* lse_t,
                                              const float* q,
                                              const float* dout,
                                              const float* o,
                                              const float* lse, int row0,
                                              int n, int d, int t) {
  using S = Shape<W>;
  constexpr int BQ = S::DKV_BQ;
  constexpr int CHUNKS = S::CHUNKS;
  stage<W, FULL, BQ, THREADS>(qt, q, row0, n, d, t);
  stage<W, FULL, BQ, THREADS>(dot, dout, row0, n, d, t);
  stage<W, FULL, BQ, THREADS>(ot, o, row0, n, d, t);
#pragma unroll
  for (int i = 0; i < BQ * CHUNKS / THREADS; ++i) {
    const int idx = t + i * THREADS;
    if (idx % CHUNKS == 0) {
      const int r = idx / CHUNKS;
      const bool valid = row0 + r < n;
      cp_async4(lse_t + r, lse + (valid ? row0 + r : 0), valid);
    }
  }
}

// delta = rowsum(dO * O) of the staged query tile and its lse (-inf past
// row n): every thread reads back only the chunks it copied itself
// (visible to it after its cp.async wait, no barrier), the CHUNKS threads
// of a row sum their chunks by shuffles, and the first writes the row's
// delta and, past n, lse = -inf
template <int W, int THREADS>
__device__ __forceinline__ void query_stats(float* lse_t, float* delta_t,
                                            const float* dot,
                                            const float* ot, int row0,
                                            int n, int t) {
  using S = Shape<W>;
  constexpr int BQ = S::DKV_BQ;
  constexpr int CHUNKS = S::CHUNKS;
#pragma unroll
  for (int i = 0; i < BQ * CHUNKS / THREADS; ++i) {
    const int idx = t + i * THREADS;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const float4 a =
        *reinterpret_cast<const float4*>(dot + swz<S::RS>(r, 4 * c));
    const float4 b =
        *reinterpret_cast<const float4*>(ot + swz<S::RS>(r, 4 * c));
    float acc = a.x * b.x;
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
#pragma unroll
    for (int x = 1; x < CHUNKS; x <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, x);
    if (c == 0) {
      delta_t[r] = acc;
      if (row0 + r >= n) lse_t[r] = -CUDART_INF_F;
    }
  }
}

// Design. A block of WARPS warps owns a 128-key tile of one (batch, head)
// (at S 128 the whole head: Q, dO and O are read once); blocks walk items
// (batch*head, key tile) with the key tiles of a head adjacent, so a
// longer head's Q, dO and O come from L2 after the first; two blocks an
// SM (one at W 128). Warp w owns keys 16 MT w .. + 16 MT - 1, MT m16
// tiles (two; one at W 128), and keeps S^T, dP^T, P^T, dS^T, dK and dV in
// mma fragments (registers) throughout; every Q and dO fragment a lane
// loads and splits serves its m-tiles.
// K and V are staged once; per 32-query tile:
//   S^T = K Q^T and dP^T = V dO^T (four m16n8 query tiles, k over d), then
//   p and ds in place in the fragments, then dV += P^T dO and dK += dS^T Q
//   with P^T and dS^T as the A operand straight from the fragments: the
//   query index is permuted within each 8-group alike in A and B, as dq
//   permutes keys (product_pb). Every product is 3xTF32.
// The query tiles (Q, dO, O, lse) are double-buffered: the next tile's
// cp.async copies run while this one is computed, then each thread waits
// for its own copies and sums delta of the chunks it copied
// (query_stats), and one block barrier a tile publishes tile and
// statistics. In the transposed fragments lse and delta vary along n:
// each lane reads those of queries 8n + 2tq (+ 1) as float2. A causal
// block starts at the first query tile that sees its keys; a block past
// the length walks nothing and writes zeros; the masks are skipped where
// a whole tile is visible to every key.
template <int W, bool FULL,
          int MT = FULL ? Shape<W>::MT : Shape<W>::DKV_MT_PART>
__global__ void __launch_bounds__(Warps<MT>::THREADS, Warps<MT>::MIN_BLOCKS)
flash_attention_dkv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ o,
                           const float* __restrict__ lse,
                           const float* __restrict__ dout,
                           const int* __restrict__ lengths,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int heads, int sq, int sk, int d_arg, float scale,
                           int causal) {
  using S = Shape<W>;
  constexpr int THREADS = Warps<MT>::THREADS;
  constexpr int BK = S::ROWS;     // keys a block
  constexpr int BQ = S::DKV_BQ;   // queries a tile
  constexpr int NQ = BQ / 8;      // the tile's m16n8 query tiles
  constexpr int KTILE = BK * S::RS;
  constexpr int QTILE = BQ * S::RS;
  const int d = FULL ? W : d_arg;  // the real head dim: the row stride
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                // [BK][RS] swizzled
  float* vs = ks + KTILE;          // [BK][RS] swizzled
  float* qs = vs + KTILE;          // 2 x [BQ][RS] swizzled
  float* dos = qs + 2 * QTILE;     // 2 x [BQ][RS] swizzled
  float* os = dos + 2 * QTILE;     // 2 x [BQ][RS] swizzled
  float* lse_s = os + 2 * QTILE;   // 2 x [BQ]
  float* delta_s = lse_s + 2 * BQ;  // 2 x [BQ]

  const int ktiles = (sk + BK - 1) / BK;
  const int bh = blockIdx.x / ktiles;
  const int b = bh / heads;
  const int k0 = (blockIdx.x % ktiles) * BK;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wrow = 16 * MT * w;  // keys k0 + wrow + 16m + 8h + g
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  const float* qb = q + qoff;
  const float* dob = dout + qoff;
  const float* ob = o + qoff;
  const float* lseb = lse + (size_t)bh * sq;

  int xo[NX<S::RS>], yo[2][NX<S::RS>];
  lane_offsets<S::RS>(g, tq, xo, yo);

  const int len = max(0, min(lengths[b], sk));
  // no query sees a key at or past the length; a causal key k is seen
  // only by queries q >= k
  const int qbegin = causal ? k0 / BQ * BQ : 0;
  const int ntiles = k0 < len ? max(0, (sq - qbegin + BQ - 1) / BQ) : 0;

  float dka[MT][W / 8][4], dva[MT][W / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[m][n][e] = dva[m][n][e] = 0.f;

  if (ntiles > 0) {
    stage<W, FULL, BK, THREADS>(ks, k + koff, k0, sk, d, t);
    stage<W, FULL, BK, THREADS>(vs, v + koff, k0, sk, d, t);
    stage_queries<W, FULL, THREADS>(qs, dos, os, lse_s, qb, dob, ob, lseb,
                                    qbegin, sq, d, t);
    cp_async_commit();
    cp_async_wait_all();
    query_stats<W, THREADS>(lse_s, delta_s, dos, os, qbegin, sq, t);
  }
  // exp(x) = 2^(x log2 e): the scores and lse pre-scaled, one fma and
  // ex2.approx an element
  const float scale2 = scale * LOG2E;
  for (int j = 0; j < ntiles; ++j) {
    const int q0 = qbegin + j * BQ;
    const int cur = j & 1;
    const int nxt = cur ^ 1;
    __syncthreads();  // tile j and its statistics visible; j - 1 consumed
    if (j + 1 < ntiles) {
      stage_queries<W, FULL, THREADS>(qs + nxt * QTILE, dos + nxt * QTILE,
                                      os + nxt * QTILE, lse_s + nxt * BQ, qb,
                                      dob, ob, lseb, q0 + BQ, sq, d, t);
      cp_async_commit();
    }
    const float* qt = qs + cur * QTILE;
    const float* dot = dos + cur * QTILE;
    float st[MT][NQ][4], dpt[MT][NQ][4];
    product_nt<W>(st, ks, qt, wrow, xo);
    product_nt<W>(dpt, vs, dot, wrow, xo);
    // lse (and pre-scaled) and delta of the lane's queries q0 + 8n + 2tq
    // + 0/1
    float lq[NQ][2], l2[NQ][2], dl[NQ][2];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 x = ld2(lse_s + cur * BQ + 8 * n + 2 * tq);
      const float2 y = ld2(delta_s + cur * BQ + 8 * n + 2 * tq);
      lq[n][0] = x.x;
      lq[n][1] = x.y;
      l2[n][0] = x.x * LOG2E;
      l2[n][1] = x.y * LOG2E;
      dl[n][0] = y.x;
      dl[n][1] = y.y;
    }
    // p = 2^(s scale log2 e - lse log2 e) (ex2.approx), 0 where masked or
    // lse == -inf; ds = p (dp - delta) scale, in dp's registers. Element e
    // of n-tile n of m-tile m: key k0 + wrow + 16m + 8 (e >> 1) + g, query
    // q0 + 8n + 2tq + (e & 1). In a tile visible to every key of the block
    // no query has lse == -inf, and nothing is masked.
    const bool whole = q0 + BQ <= sq && k0 + BK <= len &&
                       (!causal || k0 + BK - 1 <= q0);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = exp2f_approx(st[m][n][e] * scale2 - l2[n][e & 1]);
          float p = ex;
          if (!whole) {
            const int kj = k0 + wrow + 16 * m + 8 * (e >> 1) + g;
            const int qi = q0 + 8 * n + 2 * tq + (e & 1);
            const bool vis = lq[n][e & 1] != -CUDART_INF_F && kj < len &&
                             (!causal || kj <= qi);
            p = vis ? ex : 0.f;
          }
          st[m][n][e] = p;
          dpt[m][n][e] = p * (dpt[m][n][e] - dl[n][e & 1]) * scale;
        }
    product_pb<W>(dva, st, dot, yo);  // dV += P^T dO
    product_pb<W>(dka, dpt, qt, yo);  // dK += dS^T Q
    if (j + 1 < ntiles) {
      cp_async_wait_all();
      query_stats<W, THREADS>(lse_s + nxt * BQ, delta_s + nxt * BQ,
                              dos + nxt * QTILE, os + nxt * QTILE, q0 + BQ,
                              sq, t);
    }
  }
  store_rows<W, FULL>(dka, dk + koff, k0 + wrow, sk, d, g, tq);
  store_rows<W, FULL>(dva, dv + koff, k0 + wrow, sk, d, g, tq);
}

}  // namespace dkvk

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int W, bool FULL>
cudaError_t dq_launch(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* dout,
                      const void* lengths, void* dq, int batch, int heads,
                      int sq, int sk, int d, float scale, int causal,
                      cudaStream_t stream) {
  using S = Shape<W>;
  constexpr int THREADS = Warps<S::MT>::THREADS;
  auto* kernel = dqk::flash_attention_dq_kernel<W, FULL>;
  cudaError_t err = set_smem(kernel, S::DQ_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // one block an item: (batch*head, query tile), the tiles of a head
  // adjacent
  const long long items =
      (long long)batch * heads * ((sq + S::ROWS - 1) / S::ROWS);
  if (items == 0) return cudaSuccess;
  kernel<<<(unsigned)items, THREADS, S::DQ_SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const int*>(lengths), static_cast<float*>(dq), heads, sq,
      sk, d, scale, causal);
  return cudaGetLastError();
}

template <int W, bool FULL>
cudaError_t dkv_launch(const void* q, const void* k, const void* v,
                       const void* o, const void* lse, const void* dout,
                       const void* lengths, void* dk, void* dv, int batch,
                       int heads, int sq, int sk, int d, float scale,
                       int causal, cudaStream_t stream) {
  using S = Shape<W>;
  constexpr int THREADS =
      Warps<FULL ? S::MT : S::DKV_MT_PART>::THREADS;
  auto* kernel = dkvk::flash_attention_dkv_kernel<W, FULL>;
  cudaError_t err = set_smem(kernel, S::DKV_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // one block an item: (batch*head, key tile), the tiles of a head
  // adjacent
  const long long items =
      (long long)batch * heads * ((sk + S::ROWS - 1) / S::ROWS);
  if (items == 0) return cudaSuccess;
  kernel<<<(unsigned)items, THREADS, S::DKV_SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const int*>(lengths), static_cast<float*>(dk),
      static_cast<float*>(dv), heads, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

// the padded widths built, each for D == W and for D < W
#define MX_BWD_WIDTHS(X) X(16) X(32) X(64) X(128)

}  // namespace

// ---- host entry points ----
// q, o, do (B*H, Sq, D); k, v (B*H, Sk, D); lse (B*H, Sq) float32; lengths
// (B,) int32; outputs dq (B*H, Sq, D) or dk, dv (B*H, Sk, D). All
// contiguous on the device, float32. width is the padded width of the
// instance (16, 32, 64 or 128; 1 <= D <= width, attention.py head_width).
// Each returns the cudaError_t of its launch.
extern "C" int mx_flash_attention_dq(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* lse, const void* dout,
                                     const void* lengths, void* dq,
                                     int batch, int heads, int sq, int sk,
                                     int d, int width, float scale,
                                     int causal, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > width) return cudaErrorInvalidValue;
  switch (width) {
#define X(W)                                                                \
  case W:                                                                   \
    return d == W ? dq_launch<W, true>(q, k, v, o, lse, dout, lengths, dq,  \
                                       batch, heads, sq, sk, d, scale,      \
                                       causal, st)                          \
                  : dq_launch<W, false>(q, k, v, o, lse, dout, lengths, dq, \
                                        batch, heads, sq, sk, d, scale,     \
                                        causal, st);
    MX_BWD_WIDTHS(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int mx_flash_attention_dkv(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      const void* lengths, void* dk,
                                      void* dv, int batch, int heads, int sq,
                                      int sk, int d, int width, float scale,
                                      int causal, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > width) return cudaErrorInvalidValue;
  switch (width) {
#define X(W)                                                                 \
  case W:                                                                    \
    return d == W ? dkv_launch<W, true>(q, k, v, o, lse, dout, lengths, dk,  \
                                        dv, batch, heads, sq, sk, d, scale,  \
                                        causal, st)                          \
                  : dkv_launch<W, false>(q, k, v, o, lse, dout, lengths, dk, \
                                         dv, batch, heads, sq, sk, d, scale, \
                                         causal, st);
    MX_BWD_WIDTHS(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block in bytes, rows a block owns and rows a
// staged tile of the instance at padded width `width` (0: not built), so
// the wrappers can hold their geometry (attention.py dq_geometry,
// dkv_geometry) to the kernels' layout.
#define MX_BWD_ENTRY(NAME, FIELD)   \
  extern "C" int NAME(int width) {  \
    switch (width) {                \
      case 16:                      \
        return Shape<16>::FIELD;    \
      case 32:                      \
        return Shape<32>::FIELD;    \
      case 64:                      \
        return Shape<64>::FIELD;    \
      case 128:                     \
        return Shape<128>::FIELD;   \
      default:                      \
        return 0;                   \
    }                               \
  }
MX_BWD_ENTRY(mx_flash_attention_dq_smem, DQ_SMEM_BYTES)
MX_BWD_ENTRY(mx_flash_attention_dq_block_q, ROWS)
MX_BWD_ENTRY(mx_flash_attention_dq_block_k, DQ_BK)
MX_BWD_ENTRY(mx_flash_attention_dkv_smem, DKV_SMEM_BYTES)
MX_BWD_ENTRY(mx_flash_attention_dkv_block_k, ROWS)
MX_BWD_ENTRY(mx_flash_attention_dkv_block_q, DKV_BQ)
