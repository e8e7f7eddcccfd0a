// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces: mxnet_tpu_flash_attention_fwd (mxnet_tpu/ops/pallas/attention.py:111),
// the TPU kernel of every prefill, of the whole-sequence reference forward
// of the decode model and of the BERT training forward.
//
// What bounds it on the H100:
//   * at the training shape (B 96, H 12, S 128, D 64) float32 operations:
//     4.83 GFLOP against 151 MB of q, k, v and out, 72 us at 67 TFLOP/s on
//     the CUDA cores against 45 us at 3.35 TB/s. Beside the fmas each score
//     costs an expf (~15 instructions) and the tiles' shared-memory loads;
//   * at the serving shape (one sequence, 12 heads, S 256, causal) latency:
//     0.08 GFLOP and 3 MB are microseconds of work, so what counts is how
//     many SMs run blocks and how long one block's chain of tiles takes.
//
// Head dims. Every D from 1 to 128 runs, through instances built at four
// padded widths DP = 16, 32, 64 and 128 (the smallest DP >= D, which the
// wrapper passes: attention.py head_width): the D real columns of Q, K and V are copied into shared
// memory and columns D .. DP - 1 are zero-filled by the copy (src-size 0),
// so each score is the chain over DP whose last DP - D terms are fma(0, 0,
// s) = s; only the D real columns of out are written. Where D % 4 != 0 a
// row of an (n, D) matrix does not start on 16 bytes, and the copies go 4
// bytes at a time. Each width is built twice: for D == DP (FULL, d a
// constant: the code of a kernel built for that D alone) and for D < DP.
// DP 128 keeps one K and one V buffer (two would take 262,144 bytes
// alone), so there the next tile is staged after the tile before it is
// consumed; its query tiles are 64 or 32 rows.
//
// Design. A work item is one (batch*head, BQ-row query tile); blocks of
// 256 threads (8 warps), at most one an SM, walk items blockIdx.x,
// + gridDim.x, ... (persistent), each item's keys in K_BLOCK = 128 tiles:
//   * register micro-tiles. Scores: thread (tx, ty) = (t % 16, t / 16)
//     owns rows ty*TM .. + TM - 1 (TM = BQ / 16) and keys tx, tx + 16, ...,
//     tx + 112 of the tile: TM x 8 independent fma chains, for each d-chunk
//     8 K and TM Q 16-byte loads. P.V: thread (t % 8, t / 8) owns rows
//     (t / 8)*PM .. + PM - 1 (PM = BQ / 32) and DP / 8 d columns, VEC
//     (4, or 2 at DP 16) at a time: at DP 64 the columns 4(t % 8) .. + 3 and
//     32 + 4(t % 8) .. + 3; PM x DP / 8 accumulators kept in registers
//     across tiles, for each key one P and DP / 32 V 16-byte loads;
//   * warp w owns the rows w*BQ/8 .. + BQ/8 - 1 in both mappings: their Q
//     rows, scores, row maxima (a shuffle butterfly over the 16 threads of a
//     row group, exact in any order), weights, corr, sums and outputs never
//     leave the warp, so warps meet only at the block barrier that hands
//     over a K/V tile, and one warp's softmax overlaps another's fmas;
//   * Q, K and the key-major P tile are stored with the 16-byte chunk index
//     XOR-ed with three bits of the row (two at DP 16, whose rows hold four
//     chunks) (swizzle), so the rows a warp reads or writes at once fall in
//     different bank groups with no padding: the Q tile, two K and two V
//     tiles and the P tile fit one block at BQ 128 and DP 64 (230,912
//     bytes);
//   * staging with cp.async: the next K/V tile of the block's stream (the
//     item's next tile or the next item's first) is copied into the other
//     buffer while the current tile is computed; each warp copies its next
//     item's Q rows once its last scores of the item are done. One block
//     barrier a tile (two at DP 128). Rows past Sq or Sk are zero-filled by
//     the copy (src-size 0), so the inputs are never padded;
//   * masks are computed, not loaded: k < lengths[b], k < Sk and, if
//     causal, k <= q, and skipped where the whole tile is visible to every
//     row; tiles wholly past an item's last visible key are not walked;
//   * BQ is picked by the wrapper (attention.py fwd_geometry) among the
//     width's instances (128 or 32; 64 or 32 at DP 128): the largest
//     whose items fill the 132 SMs, else the smallest, so that short
//     sequences still spread (96 blocks at the serving shape).
//
// Decode bit-identity. Each score is one chain of fmas, sequential over d
// from 0 to DP, whichever thread runs it; the tile max is exact in any
// order; the weight sum (one lane a row) and every accumulator run
// sequentially over the tile's keys in order; rescale, weights and finish
// are the expressions of online_softmax.cuh. The decode kernel
// (flash_decode_fwd.cu) pads to the same DP with the same zeros, so every
// row's out and lse are bitwise what it gives at that position, for every
// D and BQ (only tiles a row cannot see differ, and they change nothing).
//
// bf16 (AMP, row 1b) is another kernel, on the bf16 tensor cores
// (csrc/flash_attention_fwd_bf16.cu): it rounds p to bf16 before P.V, so
// it computes another function, with no bit-identity contract (decode
// stays float32).
//
// Tensor cores are deliberately not used for float32 inputs: TF32 keeps 10
// mantissa bits and breaks the 1e-5 tier; 3xTF32 would hold the tier but
// reorders every dot product inside the mma, which breaks bit identity with
// the decode kernel unless that kernel moves to the same mma arithmetic.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "online_softmax.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16;                // score threads along the keys
constexpr int TN = mx::K_BLOCK / TX;  // keys a thread scores
constexpr int DX = 8;                 // P.V threads along d
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layout in floats: the Q tile, NBUF K tiles, NBUF V tiles,
// the P tile, and the per-row corr, m and l of the block's rows.
template <int DP, int BQ, int NBUF>
struct Layout {
  static constexpr int TM = BQ / 16;  // rows a thread scores
  static constexpr int PM = BQ / 32;  // rows a thread accumulates in P.V
  static constexpr int q = 0;
  static constexpr int k = q + BQ * DP;
  static constexpr int v = k + NBUF * mx::K_BLOCK * DP;
  static constexpr int p = v + NBUF * mx::K_BLOCK * DP;
  static constexpr int corr = p + mx::K_BLOCK * BQ;
  static constexpr int m = corr + BQ;
  static constexpr int l = m + BQ;
  static constexpr int floats = l + BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Swizzled offsets (floats). A 16-byte chunk's bank group is its index mod
// 8; XOR-ing the chunk index with SWZ bits of the row spreads the rows a
// warp reads at once over the bank groups:
//   Q row r, chunk c: the two row groups of a warp (r / TM) differ;
//   K key j, chunk c: the 16 keys tx, tx + 16, ... of a half-warp;
//   P key j, row r:   the TM-row chunks written for 16 keys at once.
template <int DP>
constexpr int SWZ = (DP / 4 < 8 ? DP / 4 : 8) - 1;

template <int DP, int TM>
__device__ __forceinline__ int q_off(int r, int c) {
  return r * DP + ((c ^ ((r / TM) & SWZ<DP>)) << 2);
}

template <int DP>
__device__ __forceinline__ int k_off(int j, int c) {
  return j * DP + ((c ^ (j & SWZ<DP>)) << 2);
}

template <int BQ>
__device__ __forceinline__ int p_off(int j, int r) {
  return j * BQ + (((r >> 2) ^ (j & 7)) << 2) + (r & 3);
}

// cp.async of 16 or 4 bytes; `valid` false zero-fills dst, reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Chunk c (columns 4c .. 4c + 3) of row `row` of an (n, d) matrix at
// `base` into dst (16 bytes of shared memory); an invalid row and columns
// >= d become zeros. d % 4 == 0: one 16-byte copy, else four of 4 bytes
// (the row does not start on 16 bytes).
__device__ __forceinline__ void copy_chunk(float* dst, const float* base,
                                           int row, bool valid, int c,
                                           int d) {
  const float* src = base + (size_t)(valid ? row : 0) * d;
  if ((d & 3) == 0) {
    const bool in = valid && 4 * c < d;
    cp_async<16>(dst, in ? src + 4 * c : src, in);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = valid && 4 * c + e < d;
      cp_async<4>(dst + e, in ? src + 4 * c + e : src, in);
    }
  }
}

// Copy rows row0 .. row0 + ROWS - 1 of an (n, d) matrix into dst, chunk c
// of row r at off(r, c); rows >= n and columns >= d become zeros. The
// caller commits the group.
template <int DP, int ROWS, typename Off>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int n, int d, int t, Off off) {
  constexpr int CHUNKS = DP / 4;
  static_assert(ROWS * CHUNKS % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    const int idx = t + i * THREADS;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    copy_chunk(dst + off(r, c), src, row0 + r, row0 + r < n, c, d);
  }
}

// VEC outputs of a row at o (16 or 8 bytes)
template <int VEC>
__device__ __forceinline__ void store_vec(float* o, const float* a) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
  else
    *reinterpret_cast<float2*>(o) = make_float2(a[0], a[1]);
}

// VEC consecutive floats of a V row
template <int VEC>
__device__ __forceinline__ void load_vec(float (&x)[VEC], const float* a) {
  if constexpr (VEC == 4) {
    const float4 y = *reinterpret_cast<const float4*>(a);
    x[0] = y.x; x[1] = y.y; x[2] = y.z; x[3] = y.w;
  } else {
    const float2 y = *reinterpret_cast<const float2*>(a);
    x[0] = y.x; x[1] = y.y;
  }
}

// PM consecutive floats of P row j from row r (r % PM == 0)
template <int BQ, int PM>
__device__ __forceinline__ void load_p(float (&p)[PM], const float* ps,
                                       int j, int r) {
  static_assert(PM == 4 || PM == 2 || PM == 1,
                "the instances built: BQ 128, 64 and 32");
  const float* a = ps + p_off<BQ>(j, r);
  if constexpr (PM == 4) {
    const float4 x = *reinterpret_cast<const float4*>(a);
    p[0] = x.x; p[1] = x.y; p[2] = x.z; p[3] = x.w;
  } else if constexpr (PM == 2) {
    const float2 x = *reinterpret_cast<const float2*>(a);
    p[0] = x.x; p[1] = x.y;
  } else {
    p[0] = *a;
  }
}

template <int DP, int BQ, int NBUF, bool FULL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ lengths,
                           float* __restrict__ out,
                           float* __restrict__ lse,
                           int bhs, int heads, int sq, int sk, int d_arg,
                           float scale, int causal) {
  using L = Layout<DP, BQ, NBUF>;
  constexpr int TM = L::TM;
  constexpr int PM = L::PM;
  constexpr int R = BQ / 8;  // rows a warp
  constexpr int CHUNKS = DP / 4;        // 16-byte chunks a row
  constexpr int QCOPIES = (R * CHUNKS + 31) / 32;  // a lane's Q chunks
  constexpr int VEC = DP / DX < 4 ? DP / DX : 4;   // P.V columns a load
  constexpr int NV = DP / (DX * VEC);   // P.V loads a key
  constexpr int NC = NV * VEC;          // P.V columns a thread
  static_assert(NBUF == 1 || NBUF == 2, "one or two K/V buffers");
  static_assert(L::bytes <= 232448, "the layout fits a block");
  const int d = FULL ? DP : d_arg;  // the real head dim
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::q;     // [BQ][DP] swizzled, scaled in place
  float* ks = smem + L::k;     // NBUF x [K_BLOCK][DP] swizzled
  float* vs = smem + L::v;     // NBUF x [K_BLOCK][DP]
  float* ps = smem + L::p;     // [K_BLOCK][BQ] swizzled weights, key-major
  float* cs = smem + L::corr;  // [BQ] this tile's corr of each row
  float* ms = smem + L::m;     // [BQ] final m of each row
  float* ls = smem + L::l;     // [BQ] final l of each row

  const int t = threadIdx.x;
  const int lane = t % 32;
  // warp w owns rows wr0 .. wr0 + R - 1 of the item: their Q rows, scores,
  // weights and outputs never leave it
  const int wr0 = (t / 32) * R;
  // scores: thread (tx, ty) owns rows r0 .. r0 + TM - 1 and keys
  // tx, tx + 16, ..., tx + 112 of the tile
  const int tx = t % TX;
  const int r0 = (t / TX) * TM;
  // P.V: thread (dx, t / 8) owns rows pr0 .. pr0 + PM - 1 and the d
  // columns VEC (dx + DX n) .. + VEC - 1, n < NV
  const int dx = t % DX;
  const int pr0 = (t / DX) * PM;
  const int qtiles = (sq + BQ - 1) / BQ;
  const int nitems = bhs * qtiles;

  // work item i: query rows (i % qtiles) * BQ .. of batch*head i / qtiles
  auto visible = [&](int item) {  // one past the last key a row can see
    const int q0 = (item % qtiles) * BQ;
    int kend = max(0, min(lengths[item / qtiles / heads], sk));
    if (causal) kend = min(kend, min(q0 + BQ, sq));
    return kend;
  };
  auto next_with_keys = [&](int item) {
    while (item < nitems && visible(item) == 0) item += gridDim.x;
    return item;
  };
  auto k_at = [](int r, int c) { return k_off<DP>(r, c); };
  auto v_at = [](int r, int c) { return r * DP + 4 * c; };
  // K(j) and V(j) of an item, by the whole block
  auto stage_kv = [&](int item, int j, int buf) {
    const size_t bh = item / qtiles;
    stage<DP, mx::K_BLOCK>(ks + buf * mx::K_BLOCK * DP,
                           k + bh * sk * d, j * mx::K_BLOCK, sk, d, t, k_at);
    stage<DP, mx::K_BLOCK>(vs + buf * mx::K_BLOCK * DP,
                           v + bh * sk * d, j * mx::K_BLOCK, sk, d, t, v_at);
  };
  // the warp's own Q rows of an item; lane copies chunks lane + 32 i
  auto stage_q = [&](int item) {
    const float* qb = q + (size_t)(item / qtiles) * sq * d;
    const int q0 = (item % qtiles) * BQ;
#pragma unroll
    for (int i = 0; i < QCOPIES; ++i) {
      const int idx = lane + 32 * i;
      if (R * CHUNKS % 32 == 0 || idx < R * CHUNKS) {
        const int r = wr0 + idx / CHUNKS;
        const int c = idx % CHUNKS;
        copy_chunk(qs + q_off<DP, TM>(r, c), qb, q0 + r, q0 + r < sq, c, d);
      }
    }
  };

  // The block walks items blockIdx.x, + gridDim.x, ...: one stream of
  // tiles, K/V(next) staged while the tile before it is computed (NBUF 2)
  // or once it is consumed (NBUF 1), and each warp's next Q rows once its
  // last scores of the item are done.
  int buf = 0;  // K/V buffer of the current tile
  {
    const int first = next_with_keys(blockIdx.x);
    if (first < nitems) {
      stage_q(first);
      stage_kv(first, 0, 0);
      cp_async_commit();
    }
  }

  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int bh = item / qtiles;
    const int q0 = (item % qtiles) * BQ;
    const int len = max(0, min(lengths[bh / heads], sk));
    const int ntiles = (visible(item) + mx::K_BLOCK - 1) / mx::K_BLOCK;

    float m[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) m[i] = -CUDART_INF_F;
    float acc[PM][NC];
#pragma unroll
    for (int i = 0; i < PM; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    float l = 0.f;  // of row wr0 + lane, for lane < R

    for (int j = 0; j < ntiles; ++j) {
      const int kbase = j * mx::K_BLOCK;
      cp_async_wait<0>();  // K(j), V(j) and (j == 0) Q have landed
      if (j == 0) {
        // scale the Q chunks this lane copied
#pragma unroll
        for (int i = 0; i < QCOPIES; ++i) {
          const int idx = lane + 32 * i;
          if (R * CHUNKS % 32 == 0 || idx < R * CHUNKS) {
            float4* a = reinterpret_cast<float4*>(
                qs + q_off<DP, TM>(wr0 + idx / CHUNKS, idx % CHUNKS));
            float4 x = *a;
            x.x = __fmul_rn(x.x, scale);
            x.y = __fmul_rn(x.y, scale);
            x.z = __fmul_rn(x.z, scale);
            x.w = __fmul_rn(x.w, scale);
            *a = x;
          }
        }
      }
      __syncthreads();  // visible to all; the tile before consumed
      // the item whose Q this warp stages, if any, and the K/V tile the
      // block stages next: (kv_item, kv_tile), kv_item == nitems for none
      int next = nitems;
      int kv_item = item, kv_tile = j + 1;
      if (j + 1 >= ntiles) {
        next = next_with_keys(item + gridDim.x);
        kv_item = next;
        kv_tile = 0;
      }
      if constexpr (NBUF == 2) {
        if (kv_item < nitems) {
          stage_kv(kv_item, kv_tile, buf ^ 1);
          cp_async_commit();
        }
      }

      // scores: TM x TN chains, each sequential over d from 0
      const float* kt = ks + buf * mx::K_BLOCK * DP;
      float s[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) s[i][n] = 0.f;
#pragma unroll 1
      for (int c = 0; c < CHUNKS; ++c) {
        float4 kv[TN];
#pragma unroll
        for (int n = 0; n < TN; ++n)
          kv[n] = *reinterpret_cast<const float4*>(
              kt + k_off<DP>(tx + TX * n, c));
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + q_off<DP, TM>(r0 + i, c));
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            float a = s[i][n];
            a = __fmaf_rn(qv.x, kv[n].x, a);
            a = __fmaf_rn(qv.y, kv[n].y, a);
            a = __fmaf_rn(qv.z, kv[n].z, a);
            a = __fmaf_rn(qv.w, kv[n].w, a);
            s[i][n] = a;
          }
        }
      }
      if (next < nitems) {
        __syncwarp();  // the warp's Q rows are read
        stage_q(next);
        cp_async_commit();
      }

      // masks (none where the whole tile is visible to every row), the
      // row max over the 16 threads of a row group, the weights; each step
      // over all TM rows at once, so that their chains interleave
      const bool whole = q0 + BQ <= sq && kbase + mx::K_BLOCK <= len &&
                         (!causal || kbase + mx::K_BLOCK - 1 <= q0);
      if (!whole) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int qi = q0 + r0 + i;
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const int kp = kbase + tx + TX * n;
            if (!(qi < sq && kp < len && (!causal || kp <= qi)))
              s[i][n] = -CUDART_INF_F;
          }
        }
      }
      float tmax[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        tmax[i] = s[i][0];
#pragma unroll
        for (int n = 1; n < TN; ++n) tmax[i] = fmaxf(tmax[i], s[i][n]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < TM; ++i)
          tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(FULL, tmax[i], off));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float safe_m, corr;
        mx::rescale(m[i], tmax[i], safe_m, corr);
        if (tx == 0) cs[r0 + i] = corr;
#pragma unroll
        for (int n = 0; n < TN; ++n) s[i][n] = mx::weight(s[i][n], safe_m);
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int key = tx + TX * n;
        if constexpr (TM >= 4) {
#pragma unroll
          for (int h = 0; h < TM; h += 4)
            *reinterpret_cast<float4*>(ps + p_off<BQ>(key, r0 + h)) =
                make_float4(s[h][n], s[h + 1][n], s[h + 2][n], s[h + 3][n]);
        } else {
          *reinterpret_cast<float2*>(ps + p_off<BQ>(key, r0)) =
              make_float2(s[0][n], s[1][n]);
        }
      }
      __syncwarp();  // the warp's weights and corr are written

      // P.V: PM x NC chains, each sequential over the tile's keys
      const float* vt = vs + buf * mx::K_BLOCK * DP;
#pragma unroll
      for (int i = 0; i < PM; ++i) {
        const float cr = cs[pr0 + i];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = __fmul_rn(acc[i][c], cr);
      }
#pragma unroll 16
      for (int jj = 0; jj < mx::K_BLOCK; ++jj) {
        float p[PM];
        load_p<BQ, PM>(p, ps, jj, pr0);
        float vv[NV][VEC];
#pragma unroll
        for (int n = 0; n < NV; ++n)
          load_vec<VEC>(vv[n], vt + jj * DP + VEC * (dx + DX * n));
#pragma unroll
        for (int i = 0; i < PM; ++i)
#pragma unroll
          for (int n = 0; n < NV; ++n)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][n * VEC + e] =
                  __fmaf_rn(p[i], vv[n][e], acc[i][n * VEC + e]);
      }
      // the weight sum of row wr0 + lane, sequential over the tile's keys
      if (lane < R) {
        float psum = 0.f;
#pragma unroll 8
        for (int jj = 0; jj < mx::K_BLOCK; ++jj)
          psum = __fadd_rn(psum, ps[p_off<BQ>(jj, wr0 + lane)]);
        l = __fmaf_rn(l, cs[wr0 + lane], psum);
      }
      if constexpr (NBUF == 1) {
        __syncthreads();  // every read of K(j) and V(j) is done
        if (kv_item < nitems) {
          stage_kv(kv_item, kv_tile, 0);
          cp_async_commit();
        }
      } else {
        buf ^= 1;
      }
    }

    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) ms[r0 + i] = m[i];
    }
    if (lane < R) ls[wr0 + lane] = l;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      const int qi = q0 + pr0 + i;
      if (qi < sq) {
        const float li = ls[pr0 + i];
        float* orow = out + ((size_t)bh * sq + qi) * d;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int col = VEC * (dx + DX * n);
          float o[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            o[e] = mx::finish_out(acc[i][n * VEC + e], li);
          if (d == DP) {
            store_vec<VEC>(orow + col, o);
          } else {
            // the real columns alone, a float at a time (a row of out
            // need not start on VEC floats)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              if (col + e < d) orow[col + e] = o[e];
          }
        }
      }
    }
    if (lane < R && q0 + wr0 + lane < sq)
      lse[(size_t)bh * sq + q0 + wr0 + lane] = mx::finish_lse(ms[wr0 + lane],
                                                             l);
    __syncwarp();  // ms and ls are read before the next item writes them
  }
}

template <int DP, int BQ, int NBUF, bool FULL>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lengths, float* out, float* lse, int batch,
                   int heads, int sq, int sk, int d, float scale, int causal,
                   int blocks, cudaStream_t stream) {
  using L = Layout<DP, BQ, NBUF>;
  auto* kernel = flash_attention_fwd_kernel<DP, BQ, NBUF, FULL>;
  // the shared-memory attribute once per device (and instance)
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::bytes);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  if (batch * heads == 0 || sq == 0) return cudaSuccess;
  if (blocks <= 0) return cudaErrorInvalidValue;
  kernel<<<blocks, THREADS, L::bytes, stream>>>(
      q, k, v, lengths, out, lse, batch * heads, heads, sq, sk, d, scale,
      causal);
  return cudaGetLastError();
}

// The instances built, X(padded width, query rows a work item, K/V
// buffers), each for D == DP and for D < DP: DP 128 holds one K and one
// V buffer
#define MX_FWD_INSTANCES(X) \
  X(16, 128, 2) X(16, 32, 2) X(32, 128, 2) X(32, 32, 2) X(64, 128, 2) \
  X(64, 32, 2) X(128, 64, 1) X(128, 32, 1)

}  // namespace

// ---- host entry point ----
// q (B*H, Sq, D), k/v (B*H, Sk, D), lengths (B,) int32, out (B*H, Sq, D),
// lse (B*H, Sq) float32; all contiguous on the device, 16-byte aligned, all
// float32 but lengths. width is the padded width the instance is built at
// (16, 32, 64 or 128; 1 <= D <= width) and bq the query rows a work item,
// both from attention.py (head_width, fwd_geometry): 128 or 32, or 64 or
// 32 at width 128. Returns the cudaError_t of the launch.
extern "C" int mx_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, void* lse, int batch,
                                      int heads, int sq, int sk, int d,
                                      int width, float scale, int causal,
                                      int bq, int blocks, void* stream) {
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  const auto* lf = static_cast<const int*>(lengths);
  auto* ot = static_cast<float*>(out);
  auto* sf = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > width) return cudaErrorInvalidValue;
  switch (width * 1000 + bq) {
#define X(DP, BQ, NBUF)                                                 \
  case DP * 1000 + BQ:                                                  \
    return d == DP ? launch<DP, BQ, NBUF, true>(qt, kt, vt, lf, ot, sf,   \
                                                batch, heads, sq, sk, d,  \
                                                scale, causal, blocks, st) \
                   : launch<DP, BQ, NBUF, false>(qt, kt, vt, lf, ot, sf,  \
                                                 batch, heads, sq, sk, d, \
                                                 scale, causal, blocks, st);
    MX_FWD_INSTANCES(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory in bytes of the instance built at padded width
// width and bq query rows a work item (0: not built), so the wrapper can
// hold its geometry to the kernel's layout.
extern "C" int mx_flash_attention_fwd_smem(int bq, int width) {
  switch (width * 1000 + bq) {
#define X(DP, BQ, NBUF) \
  case DP * 1000 + BQ:  \
    return (int)Layout<DP, BQ, NBUF>::bytes;
    MX_FWD_INSTANCES(X)
#undef X
    default:
      return 0;
  }
}
