// bf16 tensor-core building blocks of the flash kernels' bf16 instances
// (Hopper, sm_90a): swizzled bf16 tiles in shared memory, cp.async
// staging, ldmatrix fragment loads and the mma.sync.m16n8k16 bf16 product
// with float32 sums.
//
// Widths. Every helper takes the padded width W (16, 32, 64 or 128: the
// instance's, attention.py head_width) as a template argument. A tile row
// is W bf16 = 2W bytes = W / 8 16-byte chunks, and holds the head dim's D
// <= W real columns; columns D .. W - 1 are zeros, so every product over W
// is the product over D. Chunk c of row r sits at chunk c ^ s(r) with s(r)
// = (r >> SHIFT) & MASK: the 8 rows an ldmatrix matrix reads at one chunk
// then fall in 8 different 16-byte bank groups with no padding (W >= 64:
// s = r & 7, rows of 128 or 256 bytes; W 32: two rows a 128-byte line, s =
// (r >> 1) & 3; W 16: four rows a line, s = (r >> 2) & 1).
//
// Staging a row of an (n, D) bf16 matrix: where D % 8 == 0 its chunks are
// 16-byte aligned and come by 16-byte cp.async, chunks past D zero-filled
// by the copy (src-size 0). Where D % 8 != 0 a row does not start on 16
// bytes, and no cp.async copies 2 bytes: such a chunk is staged through
// registers (eight 2-byte loads, zeros past D, one 16-byte shared store),
// which the same barrier as the copies publishes (stage_rows).
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

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The row layout of a tile at padded width W
template <int W>
struct Row {
  static_assert(W == 16 || W == 32 || W == 64 || W == 128, "a width built");
  static constexpr int BYTES = 2 * W;       // a bf16 row
  static constexpr int CHUNKS = W / 8;      // 16-byte chunks a row
  // the swizzle: chunk c of row r at c ^ ((r >> SHIFT) & MASK), 2^SHIFT
  // rows a phase (4, 2, 1, 1 at W 16, 32, 64, 128), min(CHUNKS, 8) - 1
  static constexpr int SHIFT = (W < 64) + (W < 32);
  static constexpr int MASK = (CHUNKS - 1) & 7;
};

// byte offset of chunk c of row r in a swizzled tile
template <int W>
__device__ __forceinline__ uint32_t off(int r, int c) {
  return (uint32_t)(r * Row<W>::BYTES +
                    ((c ^ ((r >> Row<W>::SHIFT) & Row<W>::MASK)) << 4));
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

// 16 bytes into shared memory from registers
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 w) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w)
               : "memory");
}

// bf16 columns 8c .. 8c + 7 of a row at `row` of d columns, zeros past d,
// by 2-byte loads (a row of d % 8 != 0 columns is not 16-byte aligned)
__device__ __forceinline__ uint4 narrow_chunk(const __nv_bfloat16* row,
                                              int c, int d) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(row);
  uint32_t u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int col = 8 * c + 2 * k;
    const uint32_t lo = col < d ? s[col] : 0u;
    const uint32_t hi = col + 1 < d ? s[col + 1] : 0u;
    u[k] = lo | (hi << 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// chunk c of row r (of rows row0 .. at the tile) from the (n, d) bf16
// matrix src: zeros past row n or column d. FULL: d == W, every chunk one
// 16-byte cp.async
template <int W, bool FULL>
__device__ __forceinline__ void stage_chunk(uint32_t tile,
                                            const __nv_bfloat16* src,
                                            int row0, int n, int d, int r,
                                            int c) {
  const bool valid = row0 + r < n;
  if (FULL) {
    cp_async16(tile + off<W>(r, c),
               src + (size_t)(valid ? row0 + r : 0) * W + 8 * c, valid);
    return;
  }
  const __nv_bfloat16* row = src + (size_t)(valid ? row0 + r : 0) * d;
  if ((d & 7) == 0) {
    const bool in = valid && 8 * c < d;
    cp_async16(tile + off<W>(r, c), in ? row + 8 * c : row, in);
  } else {
    st_shared16(tile + off<W>(r, c),
                valid ? narrow_chunk(row, c, d) : make_uint4(0u, 0u, 0u, 0u));
  }
}

// rows row0 .. row0 + ROWS - 1 of an (n, d) bf16 matrix into the swizzled
// tile at `tile` by NT threads (thread t: chunks t + i NT; fewer chunks
// than threads leave the last threads idle); rows >= n and columns >= d
// become zeros. The caller commits the group; a barrier after its wait
// publishes the copies and the register-staged chunks alike.
template <int W, bool FULL, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(uint32_t tile,
                                           const __nv_bfloat16* src,
                                           int row0, int n, int d, int t) {
  constexpr int N = ROWS * Row<W>::CHUNKS;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int idx = t + i * NT;
    if (N % NT == 0 || idx < N)
      stage_chunk<W, FULL>(tile, src, row0, n, d, idx / Row<W>::CHUNKS,
                           idx % Row<W>::CHUNKS);
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

// acc[n] = A . B over the width (W / 16 k-steps) for the 16 rows at `arow`
// of tile `at` (A pattern) against the N n-tiles of tile `bt` from its row
// 0 (B pattern): the 16 x 8N scores of a warp, S = Q K^T, S^T = K Q^T,
// dP^T = V dO^T
template <int W, int N>
__device__ __forceinline__ void product_nt(float (&acc)[N][4], uint32_t at,
                                           uint32_t bt, int arow, int lane) {
  static_assert(N % 2 == 0, "n-tiles in pairs");
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, at + off<W>(arow + a_row(lane), 2 * kk + a_chunk(lane)));
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, bt + off<W>(16 * np + b_row(lane), 2 * kk + b_chunk(lane)));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[W / 8] += P . B: P the warp's 16 x 16K operand from accumulators p
// (n-tiles 2j, 2j + 1 -> k-step j, each value rounded to bf16, to nearest
// even) and B the first 16K rows of the row-major (k, W) tile `bt` (A
// pattern, .trans; W / 8 n-tiles in pairs): out += P V, dV += P^T dO,
// dK += dS^T Q
template <int W, int K2>
__device__ __forceinline__ void product_pv(float (&acc)[W / 8][4],
                                           const float (&p)[2 * K2][4],
                                           uint32_t bt, int lane) {
#pragma unroll
  for (int j = 0; j < K2; ++j) {
    const uint32_t a[4] = {mx_bf16::pack2(p[2 * j][0], p[2 * j][1]),
                           mx_bf16::pack2(p[2 * j][2], p[2 * j][3]),
                           mx_bf16::pack2(p[2 * j + 1][0], p[2 * j + 1][1]),
                           mx_bf16::pack2(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int dp = 0; dp < W / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, bt + off<W>(16 * j + a_row(lane),
                                   2 * dp + a_chunk(lane)));
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

// Accumulators acc[W / 8] (rows g, g + 8 of the warp's 16 at `row0` of
// tile `tile`; columns 8n + 2tq, + 1) times mul[h] (h: the row half),
// rounded to bf16 into the tile, then the 16 rows copied to rows grow0 ..
// of the (n, d) matrix dst (rows >= n skipped): by 16-byte stores where d
// % 8 == 0, chunks past d skipped; else element by element, columns < d.
// The tile rows are the warp's own: no other warp reads or writes them.
template <int W, bool FULL>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 8][4],
                                           const float (&mul)[2],
                                           unsigned char* tile, int row0,
                                           __nv_bfloat16* dst, int grow0,
                                           int n, int d, int lane) {
  constexpr int CHUNKS = Row<W>::CHUNKS;
  const int g = lane >> 2;
  const int tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < W / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + off<W>(row0 + g + 8 * h, c) +
                                   4 * tq) =
          mx_bf16::pack2(acc[c][2 * h] * mul[h], acc[c][2 * h + 1] * mul[h]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < (16 * CHUNKS + 31) / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    if ((16 * CHUNKS % 32 == 0 || idx < 16 * CHUNKS) && grow0 + r < n) {
      const uint4 w = *reinterpret_cast<const uint4*>(tile +
                                                      off<W>(row0 + r, c));
      __nv_bfloat16* row = dst + (size_t)(grow0 + r) * d;
      if (FULL || (d & 7) == 0) {
        if (FULL || 8 * c < d)
          *reinterpret_cast<uint4*>(row + 8 * c) = w;
      } else {
        const uint32_t u[4] = {w.x, w.y, w.z, w.w};
        unsigned short* s = reinterpret_cast<unsigned short*>(row);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * c + e < d)
            s[8 * c + e] = (unsigned short)(u[e >> 1] >> (16 * (e & 1)));
      }
    }
  }
}

}  // namespace mx_mma
