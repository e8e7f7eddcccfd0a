// bf16 tensor-core building blocks of the flash kernels' bf16 instances
// (Hopper, sm_90a): swizzled 64-column bf16 tiles in shared memory,
// 16-byte cp.async staging, ldmatrix fragment loads and the
// mma.sync.m16n8k16 bf16 product with float32 sums.
//
// A tile row is D = 64 bf16 = 128 bytes = 8 16-byte chunks; chunk c of
// row r sits at chunk c ^ (r & 7), so the 8 rows an ldmatrix matrix reads
// at one chunk fall in 8 different bank groups, with no padding.
//
// Fragments of mma.m16n8k16 (g = lane / 4, tq = lane % 4; two bf16 a
// register, the lower column in the low half):
//   A (16 x 16): a0 (row g, cols 2tq, 2tq + 1), a1 (row g + 8, the same),
//                a2 (row g, cols 2tq + 8, + 9), a3 (row g + 8, the same)
//   B (16 x 8):  b0 (rows 2tq, 2tq + 1, col g), b1 (rows 2tq + 8, + 9)
//   C (16 x 8):  c0, c1 (row g, cols 2tq, 2tq + 1), c2, c3 (row g + 8)
// So a C fragment pair of n-tiles 2j, 2j + 1 is the A fragment of k-step j
// packed to bf16 (flash's P and dS go straight from the accumulators into
// the next product), and two lane patterns of ldmatrix.x4 cover every
// operand read from a tile (the A pattern, and the B pattern below).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace mx_mma {

constexpr int D = 64;                 // head dim of the instances built
constexpr int ROW_BYTES = D * 2;      // a bf16 row
constexpr int CHUNKS = ROW_BYTES / 16;  // 16-byte chunks a row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// byte offset of chunk c of row r in a swizzled tile
__device__ __forceinline__ uint32_t off(int r, int c) {
  return (uint32_t)(r * ROW_BYTES + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// one float; src-size 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows row0 .. row0 + ROWS - 1 of an (n, D) bf16 matrix into the swizzled
// tile at `tile` by NT threads, 16 bytes a copy (thread t: chunks t + i
// NT); rows >= n become zeros. The caller commits the group.
template <int ROWS, int NT>
__device__ __forceinline__ void stage_rows(uint32_t tile,
                                           const __nv_bfloat16* src,
                                           int row0, int n, int t) {
  static_assert(ROWS * CHUNKS % NT == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NT; ++i) {
    const int idx = t + i * NT;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const bool valid = row0 + r < n;
    cp_async16(tile + off(r, c),
               src + (size_t)(valid ? row0 + r : 0) * D + 8 * c, valid);
  }
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and gets element (l / 4, 2 (l % 4) .. + 1) of each
// (.trans: element (2 (l % 4) .. + 1, l / 4), the matrix transposed).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The lane's (row, chunk) in a 16-row, 2-chunk block of a tile for the two
// ldmatrix.x4 patterns:
//   A pattern: matrices (rows 0-7, chunk 0), (8-15, 0), (0-7, 1), (8-15, 1)
//     -> an A fragment of 16 rows x 16 columns (a row-major operand); with
//     .trans, the B fragments of two n-tiles (chunk 0, chunk 1) of a
//     row-major (k, n) operand whose 16 k rows are the block's rows;
//   B pattern: matrices (rows 0-7, chunk 0), (0-7, 1), (8-15, 0), (8-15, 1)
//     -> the B fragments of two n-tiles (rows 0-7, rows 8-15) of an
//     operand stored n-major, (n, k): the 16 k columns are the 2 chunks.
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_chunk(int lane) { return lane >> 4; }
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_chunk(int lane) { return (lane >> 3) & 1; }

// d += a . b: m16n8k16, bf16 operands, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[n] = A . B over D for the 16 rows at `arow` of tile `at` (A pattern)
// against the N n-tiles of tile `bt` from its row 0 (B pattern): the 16 x
// 8N scores of a warp, S = Q K^T, S^T = K Q^T, dP^T = V dO^T
template <int N>
__device__ __forceinline__ void product_nt(float (&acc)[N][4], uint32_t at,
                                           uint32_t bt, int arow, int lane) {
  static_assert(N % 2 == 0, "n-tiles in pairs");
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, at + off(arow + a_row(lane), 2 * kk + a_chunk(lane)));
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, bt + off(16 * np + b_row(lane), 2 * kk + b_chunk(lane)));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[8] += P . B: P the warp's 16 x 16K operand from accumulators p
// (n-tiles 2j, 2j + 1 -> k-step j, each value rounded to bf16, to nearest
// even) and B the first 16K rows of the row-major (k, D) tile `bt` (A
// pattern, .trans): out += P V, dV += P^T dO, dK += dS^T Q
template <int K2>
__device__ __forceinline__ void product_pv(float (&acc)[8][4],
                                           const float (&p)[2 * K2][4],
                                           uint32_t bt, int lane) {
#pragma unroll
  for (int j = 0; j < K2; ++j) {
    const uint32_t a[4] = {mx_bf16::pack2(p[2 * j][0], p[2 * j][1]),
                           mx_bf16::pack2(p[2 * j][2], p[2 * j][3]),
                           mx_bf16::pack2(p[2 * j + 1][0], p[2 * j + 1][1]),
                           mx_bf16::pack2(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, bt + off(16 * j + a_row(lane), 2 * dp + a_chunk(lane)));
      mma(acc[2 * dp], a, b[0], b[1]);
      mma(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// 2^x, ex2.approx (2^-inf = +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulators acc[8] (rows g, g + 8 of the warp's 16 at `row0` of tile
// `tile`; columns 8n + 2tq, + 1) times mul[h] (h: the row half), rounded
// to bf16 into the tile, then the 16 rows copied to rows grow0 .. of the
// (n, D) matrix dst by 16-byte stores (rows >= n skipped). The tile rows
// are the warp's own: no other warp reads or writes them.
__device__ __forceinline__ void store_rows(const float (&acc)[8][4],
                                           const float (&mul)[2],
                                           unsigned char* tile, int row0,
                                           __nv_bfloat16* dst, int grow0,
                                           int n, int lane) {
  const int g = lane >> 2;
  const int tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + off(row0 + g + 8 * h, c) +
                                   4 * tq) =
          mx_bf16::pack2(acc[c][2 * h] * mul[h], acc[c][2 * h + 1] * mul[h]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CHUNKS / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    if (grow0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(grow0 + r) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(tile + off(row0 + r, c));
  }
}

}  // namespace mx_mma
