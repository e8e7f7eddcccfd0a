// Flash-attention backward for Hopper (sm_90a), float32: dq, and dk/dv.
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
// (batch, head): 7.2 and 9.7 GFLOP against ~0.23-0.26 GB of q, k, v, o,
// do in and gradients out. dk/dv runs on the CUDA cores, so the float32
// rate (67 TFLOP/s) bounds it; dq runs its products on the tensor cores in
// 3xTF32 (3 x 7.2 GFLOP at 495 TFLOP/s, 0.044 ms), so its 226 MB at
// 3.35 TB/s (0.068 ms) bound it.
//
// Design. Each output tile is owned by one block, so no sum crosses
// blocks and there is no atomicAdd (results are deterministic); the TPU
// grid's sequential walk becomes a loop inside the block. Tiles are 64
// rows.
//   * dq (namespace dqk below): four warps, each owning 32 query rows,
//     run S = Q K^T, dP = dO V^T and dQ += dS K as m16n8k8 TF32 mma
//     products in 3xTF32, its scores and gradients in mma fragments, K/V
//     double-buffered by cp.async into swizzled tiles; its own note below.
//   * dk/dv: grid (B*H, ceil(Sk/64)), 256 threads (16 x 16), each owning
//     a 4 x 4 patch of every 64 x 64 product, accumulated in registers
//     from 16-byte shared-memory loads (register tiling, as a SIMT GEMM
//     does). The block stages its K and V tiles once, then walks the query
//     tiles: S and dP (thread: query rows 4*ty + r, keys tx + 16*c), P and
//     dS into shared memory, then dV += P^T dO and dK += dS^T Q (thread:
//     keys 4*ty + r, dims 4*tx + c). A causal block starts at the first
//     query tile that can see its keys; a block wholly past the length
//     sees no query at all. Staged tiles have rows of 68 floats: with the
//     strided key ownership (tx + 16*c) every 16-byte load of a
//     quarter-warp hits distinct banks.
//   * delta is recomputed by each kernel from do and o, as the TPU kernels
//     do, so the two launches stay independent.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int D = 64;         // head dim: the instance the slice needs
constexpr int T = 64;         // rows of every tile (queries or keys)
constexpr int LD = D + 4;     // padded row stride of a staged tile, floats
constexpr int THREADS = 256;  // 16 x 16, each owning 4 x 4 outputs
constexpr int TILE = T * LD;  // floats of one staged tile

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows [base, base + T) of src (n rows of D floats) into dst (T rows of
// LD floats), zeros past row n; coalesced 16-byte loads
__device__ __forceinline__ void stage(float* dst, const float* src, int base,
                                      int n) {
  for (int idx = threadIdx.x; idx < T * D / 4; idx += THREADS) {
    const int r = idx / (D / 4);
    const int c = idx % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (base + r < n)
      x = reinterpret_cast<const float4*>(src + (size_t)(base + r) * D)[c];
    *reinterpret_cast<float4*>(dst + r * LD + 4 * c) = x;
  }
}

// lse and delta = rowsum(do * o) of query rows [base, base + T), from the
// staged dO tile and o in device memory; four threads per row
__device__ __forceinline__ void row_stats(float* lse_s, float* delta_s,
                                          const float* lse, const float* o,
                                          const float* dos, int base, int n) {
  const int r = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const bool ok = base + r < n;
  float acc = 0.f;
  if (ok) {
    const float* orow = o + (size_t)(base + r) * D + part * (D / 4);
    const float* drow = dos + r * LD + part * (D / 4);
#pragma unroll
    for (int k = 0; k < D / 4; k += 4) {
      const float4 a = ld4(drow + k);
      const float4 w = ld4(orow + k);
      acc = fmaf(a.x, w.x, acc);
      acc = fmaf(a.y, w.y, acc);
      acc = fmaf(a.z, w.z, acc);
      acc = fmaf(a.w, w.w, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    delta_s[r] = acc;
    lse_s[r] = ok ? lse[base + r] : -CUDART_INF_F;
  }
}

// one product of two staged tiles over D: out[r][c] = a[4 ty + r] .
// b[tx + 16 c]
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float out[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = ld4(a + (4 * ty + r) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = ld4(b + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = out[r][c];
        s = fmaf(av[r].x, bv[c].x, s);
        s = fmaf(av[r].y, bv[c].y, s);
        s = fmaf(av[r].z, bv[c].z, s);
        s = fmaf(av[r].w, bv[c].w, s);
        out[r][c] = s;
      }
  }
}

// p and ds of the thread's 4 x 4 (query 4 ty + r, key tx + 16 c) from the
// staged Q, dO (query tile at qbase) and K, V (key tile at kbase), into
// ps and dss, both [query][key]
__device__ __forceinline__ void probs(const float* qs, const float* dos,
                                      const float* ks, const float* vs,
                                      const float* lse_s,
                                      const float* delta_s, float* ps,
                                      float* dss, int qbase, int kbase,
                                      int sq, int len, float scale,
                                      int causal, int ty, int tx) {
  float s[4][4], dp[4][4];
  tile_dot(qs, ks, ty, tx, s);
  tile_dot(dos, vs, ty, tx, dp);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    const int qi = qbase + i;
    const float lse_i = lse_s[i];
    const float delta_i = delta_s[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const int kj = kbase + j;
      const bool vis = qi < sq && kj < len && (!causal || kj <= qi);
      const float p = (vis && lse_i != -CUDART_INF_F)
                          ? expf(s[r][c] * scale - lse_i)
                          : 0.f;
      ps[i * LD + j] = p;
      dss[i * LD + j] = p * (dp[r][c] - delta_i) * scale;
    }
  }
}

// ---- dq: the three products on the tensor cores in 3xTF32 ----
//
// Why the tensor cores here and not in the forward: the forward must stay
// bitwise equal to the decode kernel (flash_attention_fwd.cu), so every
// score there is one float32 fma chain in a fixed order; dq has no such
// contract, only the 1e-5 tier (relative to its max abs), which 3xTF32
// holds: x = big + small with big = tf32(x) and small = tf32(x - big)
// (big rounded to nearest on the 10-bit mantissa, small toward zero) keeps
// 21 of x's 24 bits, and big.big + big.small + small.big drops only the
// small.small term (2^-22 relative), summed in float32 by the mma.
namespace dqk {

constexpr int MT = 2;             // m16 tiles (16 query rows) a warp
constexpr int WARPS = 4;
constexpr int BQ = 16 * MT * WARPS;  // query rows a block
constexpr int BK = 32;            // keys a tile
constexpr int NS = BK / 8;        // the tile's m16n8 key tiles
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNKS = D / 4;     // 16-byte chunks a row
// shared memory: the Q and dO tiles, two K and two V tiles (96 KB: two
// blocks an SM)
constexpr int QTILE = BQ * D;
constexpr int KTILE = BK * D;
constexpr size_t SMEM_BYTES = (2 * QTILE + 4 * KTILE) * sizeof(float);

// Float offset of (row, col) in a tile of D-float rows, no padding: the
// 8-float group of the column XOR-ed with two bits of the row. The warps'
// fragment loads then hit distinct banks: the float2 loads of rows 8m + g
// (A, and B of S and dP: lanes g = 0-3 of a half-warp, columns 8kk + 2tq)
// and the scalar loads of rows 8m + 2tq (+ 1) (B of dS.K, columns
// 8n + g); a 16-byte staging copy keeps its chunk whole. For a row 8m + u
// (u < 8) the XOR is that of u alone, flipped by 2 when m is odd, so the
// kernel precomputes each lane's offsets once.
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + (col ^ (((row ^ (row >> 2)) & 3) << 3));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows row0 .. row0 + ROWS - 1 of an (n, D) matrix into a swizzled tile;
// rows >= n become zeros (src-size 0). The caller commits the group.
template <int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int n, int t) {
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    const int idx = t + i * THREADS;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const bool valid = row0 + r < n;
    cp_async16(dst + swz(r, 4 * c),
               src + (size_t)(valid ? row0 + r : 0) * D + 4 * c, valid);
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

// acc[m][n] += A[m] . B[n] over the MT m-tiles and N n-tiles in 3xTF32,
// the small terms first: each B fragment is split once for both m-tiles,
// and each pass leaves MT x N independent accumulators in flight
template <int N>
__device__ __forceinline__ void mma3(float (&acc)[MT][N][4],
                                     const float (&a)[MT][4],
                                     const float (&b)[N][2]) {
  uint32_t ab[MT][4], as[MT][4], bb[N][2], bs[N][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[m][e], ab[m][e], as[m][e]);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b[n][0], bb[n][0], bs[n][0]);
    split(b[n][1], bb[n][1], bs[n][1]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[m][n], as[m], bb[n]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[m][n], ab[m], bs[n]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[m][n], ab[m], bb[n]);
}

// acc = A B^T for the warp's 32 rows (m-tile m: wrow + 16m + g and
// wrow + 16m + 8 + g) of the BQ-row tile `at` against the BK rows of
// `bt`, over D: S = Q K^T, dP = dO V^T. The k index (d) is permuted within
// each 8-group alike in A and B (the mma's column t holds d = 2t, column
// t + 4 holds d = 2t + 1), so each lane's A and B values are float2
// loads; xo[k] is the lane's offset of column group k in a row 8m + g
// with m even (xo[k ^ 2]: m odd).
__device__ __forceinline__ void product_nt(float (&acc)[MT][NS][4],
                                           const float* at, const float* bt,
                                           int wrow, const int (&xo)[8]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    float a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float2 lo = ld2(at + (wrow + 16 * m) * D + xo[kk]);
      const float2 hi = ld2(at + (wrow + 16 * m + 8) * D + xo[kk ^ 2]);
      a[m][0] = lo.x;
      a[m][1] = hi.x;
      a[m][2] = lo.y;
      a[m][3] = hi.y;
    }
    float b[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 x = ld2(bt + 8 * n * D + xo[kk ^ ((n & 1) << 1)]);
      b[n][0] = x.x;
      b[n][1] = x.y;
    }
    mma3<NS>(acc, a, b);
  }
}

// lse and delta = rowsum(dO * O) of the thread's rows (element h of
// m-tile m: row 32w + 16m + 8h + g), from the staged dO tile and O in
// device memory: lane l sums row 32w + l, and shuffles hand each lane its
// rows
__device__ __forceinline__ void row_stats(float (&lse_r)[MT][2],
                                          float (&delta_r)[MT][2],
                                          const float* lse, const float* o,
                                          const float* dos, int q0, int sq,
                                          int w, int lane, int g) {
  const int row = 32 * w + lane;
  float acc = 0.f;
  if (q0 + row < sq) {
    const float* orow = o + (size_t)(q0 + row) * D;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(dos + swz(row, c));
      const float4 b = *reinterpret_cast<const float4*>(orow + c);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + 8 * h + g;  // of the warp's 32
      delta_r[m][h] = __shfl_sync(0xffffffffu, acc, r);
      const int qi = q0 + 32 * w + r;
      lse_r[m][h] = qi < sq ? lse[qi] : -CUDART_INF_F;
    }
}

// Design. A block of 4 warps owns a 128-row query tile of one (batch,
// head); blocks walk items (batch*head, query tile) with the query tiles
// of a head adjacent, so a head's K and V are read from memory once and
// from L2 after; two blocks an SM. Warp w owns rows 32w .. 32w + 31, two
// m16 tiles, and keeps their scores, dP, dS and dQ in mma fragments
// (registers) throughout; every K and V fragment a lane loads and splits
// serves both m-tiles. Per 32-key tile:
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
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_dq_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ o,
                          const float* __restrict__ lse,
                          const float* __restrict__ dout,
                          const int* __restrict__ lengths,
                          float* __restrict__ dq, int heads, int sq, int sk,
                          float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [BQ][D] swizzled
  float* dos = qs + QTILE;     // [BQ][D] swizzled
  float* ks = dos + QTILE;     // 2 x [BK][D] swizzled
  float* vs = ks + 2 * KTILE;  // 2 x [BK][D] swizzled

  const int qtiles = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / heads;
  const int q0 = (blockIdx.x % qtiles) * BQ;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wrow = 32 * w;  // the thread's rows: wrow + 16m + 8h + g
  const size_t qoff = (size_t)bh * sq * D;
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;

  // the lane's fragment offsets (floats; see swz): column group k of a
  // row 8m + g, m even (xo), and column group n of a row 8m + 2tq + e,
  // m even (yo[e])
  int xo[8], yo[2][8];
  {
    const int sg = (g ^ (g >> 2)) & 3;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) xo[kk] = g * D + 8 * (kk ^ sg) + 2 * tq;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = 2 * tq + e;
      const int su = (u ^ (u >> 2)) & 3;
#pragma unroll
      for (int n = 0; n < 8; ++n) yo[e][n] = u * D + 8 * (n ^ su) + g;
    }
  }

  const int len = max(0, min(lengths[b], sk));
  int kend = len;  // one past the last key any row of the block sees
  if (causal) kend = min(kend, min(q0 + BQ, sq));
  const int ntiles = (kend + BK - 1) / BK;

  float acc[MT][8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  if (ntiles > 0) {
    stage<BQ>(qs, q + qoff, q0, sq, t);
    stage<BQ>(dos, dout + qoff, q0, sq, t);
    stage<BK>(ks, kb, 0, sk, t);
    stage<BK>(vs, vb, 0, sk, t);
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
      stage<BK>(ks + ((j + 1) & 1) * KTILE, kb, kbase + BK, sk, t);
      stage<BK>(vs + ((j + 1) & 1) * KTILE, vb, kbase + BK, sk, t);
      cp_async_commit();
    }
    if (j == 0)
      row_stats(lse_r, delta_r, lse + (size_t)bh * sq, o + qoff, dos, q0,
                sq, w, lane, g);
    const float* kt = ks + (j & 1) * KTILE;
    const float* vt = vs + (j & 1) * KTILE;

    if (j == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) lse2[m][h] = lse_r[m][h] * LOG2E;
    }
    float s[MT][NS][4], dp[MT][NS][4];
    product_nt(s, qs, kt, wrow, xo);
    product_nt(dp, dos, vt, wrow, xo);
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
    // dQ += dS K: k-step jj takes keys 8jj .. 8jj + 7 (A column t <- key
    // 2t from element 0 / 2, t + 4 <- key 2t + 1 from element 1 / 3); B
    // n-tile n is K[keys][8n .. 8n + 7] with the same key order
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      float a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        a[m][0] = dp[m][jj][0];
        a[m][1] = dp[m][jj][2];
        a[m][2] = dp[m][jj][1];
        a[m][3] = dp[m][jj][3];
      }
      const int flip = (jj & 1) << 1;
      float bk[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        bk[n][0] = kt[8 * jj * D + yo[0][n ^ flip]];
        bk[n][1] = kt[8 * jj * D + yo[1][n ^ flip]];
      }
      mma3<8>(acc, a, bk);
    }
  }
  // acc[m][n]: rows wrow + 16m + g (elements 0, 1) and + 8 (2, 3), dims
  // 8n + 2tq + 0/1
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + wrow + 16 * m + 8 * h + g;
      if (qi < sq) {
        float* row = dq + qoff + (size_t)qi * D + 2 * tq;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(row + 8 * n) =
              make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
      }
    }
}

}  // namespace dqk

__global__ void __launch_bounds__(THREADS)
flash_attention_dkv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ o,
                           const float* __restrict__ lse,
                           const float* __restrict__ dout,
                           const int* __restrict__ lengths,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int heads, int sq, int sk, float scale,
                           int causal) {
  extern __shared__ float smem[];
  float* ks = smem;             // [T][LD] key tile
  float* vs = ks + TILE;        // [T][LD] value tile
  float* qs = vs + TILE;        // [T][LD] query tile
  float* dos = qs + TILE;       // [T][LD] dO of the query tile
  float* ps = dos + TILE;       // [T][LD] P, [query][key]
  float* dss = ps + TILE;       // [T][LD] dS, [query][key]
  float* lse_s = dss + TILE;    // [T]
  float* delta_s = lse_s + T;   // [T]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int k0 = blockIdx.y * T;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* qb = q + (size_t)bh * sq * D;
  const float* dob = dout + (size_t)bh * sq * D;
  const float* ob = o + (size_t)bh * sq * D;
  const float* lseb = lse + (size_t)bh * sq;

  stage(ks, k + (size_t)bh * sk * D, k0, sk);
  stage(vs, v + (size_t)bh * sk * D, k0, sk);

  float dka[4][4], dva[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[r][c] = dva[r][c] = 0.f;

  const int len = max(0, min(lengths[b], sk));
  // no query sees a key at or past the length; a causal key k is seen
  // only by queries q >= k
  const int qbegin = causal ? k0 : 0;
  const int qend = k0 < len ? sq : 0;
  for (int i0 = qbegin; i0 < qend; i0 += T) {
    __syncthreads();  // the previous tile is consumed (and ks/vs staged)
    stage(qs, qb, i0, sq);
    stage(dos, dob, i0, sq);
    __syncthreads();
    row_stats(lse_s, delta_s, lseb, ob, dos, i0, sq);
    __syncthreads();
    probs(qs, dos, ks, vs, lse_s, delta_s, ps, dss, i0, k0, sq, len, scale,
          causal, ty, tx);
    __syncthreads();
    // dV[4 ty + r][4 tx + c] += sum_i P[i][4 ty + r] dO[i][4 tx + c]
    // dK[4 ty + r][4 tx + c] += sum_i dS[i][4 ty + r] Q[i][4 tx + c]
#pragma unroll 2
    for (int i = 0; i < T; ++i) {
      const float4 p4 = ld4(ps + i * LD + 4 * ty);
      const float4 s4 = ld4(dss + i * LD + 4 * ty);
      const float4 g4 = ld4(dos + i * LD + 4 * tx);
      const float4 q4 = ld4(qs + i * LD + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = comp(p4, r);
        const float sr = comp(s4, r);
        dva[r][0] = fmaf(pr, g4.x, dva[r][0]);
        dva[r][1] = fmaf(pr, g4.y, dva[r][1]);
        dva[r][2] = fmaf(pr, g4.z, dva[r][2]);
        dva[r][3] = fmaf(pr, g4.w, dva[r][3]);
        dka[r][0] = fmaf(sr, q4.x, dka[r][0]);
        dka[r][1] = fmaf(sr, q4.y, dka[r][1]);
        dka[r][2] = fmaf(sr, q4.z, dka[r][2]);
        dka[r][3] = fmaf(sr, q4.w, dka[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + 4 * ty + r;
    if (kj < sk) {
      const size_t at = ((size_t)bh * sk + kj) * D + 4 * tx;
      *reinterpret_cast<float4*>(dk + at) =
          make_float4(dka[r][0], dka[r][1], dka[r][2], dka[r][3]);
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(dva[r][0], dva[r][1], dva[r][2], dva[r][3]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// ---- host entry points ----
// q, o, do (B*H, Sq, D); k, v (B*H, Sk, D); lse (B*H, Sq); lengths (B,)
// int32; outputs dq (B*H, Sq, D) or dk, dv (B*H, Sk, D). All contiguous
// float32 on the device, 16-byte aligned. Each returns the cudaError_t of
// its launch.
extern "C" int mx_flash_attention_dq(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* lse, const void* dout,
                                     const void* lengths, void* dq,
                                     int batch, int heads, int sq, int sk,
                                     int d, float scale, int causal,
                                     void* stream) {
  if (d != D) return cudaErrorInvalidValue;
  const size_t smem = dqk::SMEM_BYTES;
  cudaError_t err = set_smem(dqk::flash_attention_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  // one block an item: (batch*head, query tile), the tiles of a head
  // adjacent
  const long long items =
      (long long)batch * heads * ((sq + dqk::BQ - 1) / dqk::BQ);
  if (items == 0) return cudaSuccess;
  const dim3 grid((unsigned)items);
  dqk::flash_attention_dq_kernel<<<grid, dqk::THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const int*>(lengths), static_cast<float*>(dq), heads, sq,
      sk, scale, causal);
  return cudaGetLastError();
}

extern "C" int mx_flash_attention_dkv(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      const void* lengths, void* dk,
                                      void* dv, int batch, int heads, int sq,
                                      int sk, int d, float scale, int causal,
                                      void* stream) {
  if (d != D) return cudaErrorInvalidValue;
  const size_t smem = (6 * TILE + 2 * T) * sizeof(float);
  cudaError_t err = set_smem(flash_attention_dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (sk + T - 1) / T);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  flash_attention_dkv_kernel<<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const int*>(lengths), static_cast<float*>(dk),
      static_cast<float*>(dv), heads, sq, sk, scale, causal);
  return cudaGetLastError();
}
