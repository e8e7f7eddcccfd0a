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
// Design. A work item is one (batch*head, BQ-row query tile); blocks of
// 256 threads (8 warps), at most one an SM, walk items blockIdx.x,
// + gridDim.x, ... (persistent), each item's keys in K_BLOCK = 128 tiles:
//   * register micro-tiles. Scores: thread (tx, ty) = (t % 16, t / 16)
//     owns rows ty*TM .. + TM - 1 (TM = BQ / 16) and keys tx, tx + 16, ...,
//     tx + 112 of the tile: TM x 8 independent fma chains, for each d-chunk
//     8 K and TM Q 16-byte loads. P.V: thread (t % 8, t / 8) owns rows
//     (t / 8)*PM .. + PM - 1 (PM = BQ / 32) and d columns 4(t % 8) .. + 3
//     and 32 + 4(t % 8) .. + 3: PM x 8 accumulators kept in registers across
//     tiles, for each key one P and two V 16-byte loads;
//   * warp w owns the rows w*BQ/8 .. + BQ/8 - 1 in both mappings: their Q
//     rows, scores, row maxima (a shuffle butterfly over the 16 threads of a
//     row group, exact in any order), weights, corr, sums and outputs never
//     leave the warp, so warps meet only at the block barrier that hands
//     over a K/V tile, and one warp's softmax overlaps another's fmas;
//   * Q, K and the key-major P tile are stored with the 16-byte chunk index
//     XOR-ed with three bits of the row (swizzle), so the rows a warp reads
//     or writes at once fall in different bank groups with no padding: the
//     Q tile, two K and two V tiles and the P tile fit one block at BQ 128
//     (230,912 bytes);
//   * staging with 16-byte cp.async: the next K/V tile of the block's stream
//     (the item's next tile or the next item's first) is copied into the
//     other buffer while the current tile is computed; each warp copies its
//     next item's Q rows once its last scores of the item are done. One
//     block barrier a tile. Rows past Sq or Sk are zero-filled by the copy
//     (src-size 0), so the inputs are never padded;
//   * masks are computed, not loaded: k < lengths[b], k < Sk and, if
//     causal, k <= q, and skipped where the whole tile is visible to every
//     row; tiles wholly past an item's last visible key are not walked;
//   * BQ is 128 or 32, picked by the wrapper (attention.py fwd_geometry):
//     128 where its items fill the 132 SMs, else 32, so that short
//     sequences still spread (96 blocks at the serving shape).
//
// Decode bit-identity. Each score is one chain of fmas, sequential over d
// from 0, whichever thread runs it; the tile max is exact in any order; the
// weight sum (one lane a row) and every accumulator run sequentially over
// the tile's keys in order; rescale, weights and finish are the
// expressions of online_softmax.cuh. So every row's out and lse are
// bitwise what the decode kernel (flash_decode_fwd.cu) gives at that
// position, for every BQ (only tiles a row cannot see differ, and they
// change nothing).
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

constexpr int D = 64;
constexpr int THREADS = 256;
constexpr int TX = 16;                // score threads along the keys
constexpr int TN = mx::K_BLOCK / TX;  // keys a thread scores
constexpr int DX = 8;                 // P.V threads along d
constexpr int CHUNKS = D / 4;         // 16-byte chunks a row of Q, K or V
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layout in floats: the Q tile, two K tiles, two V tiles, the
// P tile, and the per-row corr, m and l of the block's rows.
template <int BQ>
struct Layout {
  static constexpr int TM = BQ / 16;  // rows a thread scores
  static constexpr int PM = BQ / 32;  // rows a thread accumulates in P.V
  static constexpr int q = 0;
  static constexpr int k = q + BQ * D;
  static constexpr int v = k + 2 * mx::K_BLOCK * D;
  static constexpr int p = v + 2 * mx::K_BLOCK * D;
  static constexpr int corr = p + mx::K_BLOCK * BQ;
  static constexpr int m = corr + BQ;
  static constexpr int l = m + BQ;
  static constexpr int floats = l + BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Swizzled offsets (floats). A 16-byte chunk's bank group is its index mod
// 8; XOR-ing the chunk index with three bits of the row spreads the rows a
// warp reads at once over the bank groups:
//   Q row r, chunk c: the two row groups of a warp (r / TM) differ;
//   K key j, chunk c: the 16 keys tx, tx + 16, ... of a half-warp;
//   P key j, row r:   the TM-row chunks written for 16 keys at once.
template <int TM>
__device__ __forceinline__ int q_off(int r, int c) {
  return r * D + ((c ^ ((r / TM) & 7)) << 2);
}

__device__ __forceinline__ int k_off(int j, int c) {
  return j * D + ((c ^ (j & 7)) << 2);
}

template <int BQ>
__device__ __forceinline__ int p_off(int j, int r) {
  return j * BQ + (((r >> 2) ^ (j & 7)) << 2) + (r & 3);
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy rows row0 .. row0 + ROWS - 1 of an (n, D) matrix into dst, chunk c
// of row r at off(r, c), by 16-byte cp.async; rows >= n become zeros. The
// caller commits the group.
template <int ROWS, typename Off>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int n, int t, Off off) {
  static_assert(ROWS * CHUNKS % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    const int idx = t + i * THREADS;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const bool valid = row0 + r < n;
    cp_async16(dst + off(r, c),
               src + (size_t)(valid ? row0 + r : 0) * D + 4 * c, valid);
  }
}

// four outputs of a row, at o: one 16-byte store
__device__ __forceinline__ void store4(float* o, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}

// PM consecutive floats of P row j from row r (r % PM == 0)
template <int BQ, int PM>
__device__ __forceinline__ void load_p(float (&p)[PM], const float* ps,
                                       int j, int r) {
  static_assert(PM == 4 || PM == 1, "the instances built: BQ 128 and 32");
  const float* a = ps + p_off<BQ>(j, r);
  if constexpr (PM == 4) {
    const float4 x = *reinterpret_cast<const float4*>(a);
    p[0] = x.x; p[1] = x.y; p[2] = x.z; p[3] = x.w;
  } else {
    p[0] = *a;
  }
}

template <int BQ>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ lengths,
                           float* __restrict__ out,
                           float* __restrict__ lse,
                           int bhs, int heads, int sq, int sk, float scale,
                           int causal) {
  using L = Layout<BQ>;
  constexpr int TM = L::TM;
  constexpr int PM = L::PM;
  constexpr int R = BQ / 8;  // rows a warp
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::q;     // [BQ][D] swizzled, scaled in place
  float* ks = smem + L::k;     // 2 x [K_BLOCK][D] swizzled
  float* vs = smem + L::v;     // 2 x [K_BLOCK][D]
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
  // P.V: thread (dx, t / 8) owns rows pr0 .. pr0 + PM - 1 and the d columns
  // 4dx .. 4dx + 3 and 32 + 4dx .. 32 + 4dx + 3
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
  auto k_at = [](int r, int c) { return k_off(r, c); };
  auto v_at = [](int r, int c) { return r * D + 4 * c; };
  // K(j) and V(j) of an item, by the whole block
  auto stage_kv = [&](int item, int j, int buf) {
    const size_t bh = item / qtiles;
    stage<mx::K_BLOCK>(ks + buf * mx::K_BLOCK * D, k + bh * sk * D,
                       j * mx::K_BLOCK, sk, t, k_at);
    stage<mx::K_BLOCK>(vs + buf * mx::K_BLOCK * D, v + bh * sk * D,
                       j * mx::K_BLOCK, sk, t, v_at);
  };
  // the warp's own Q rows of an item; lane copies chunks lane + 32 i
  auto stage_q = [&](int item) {
    const float* qb = q + (size_t)(item / qtiles) * sq * D;
    const int q0 = (item % qtiles) * BQ;
#pragma unroll
    for (int i = 0; i < R * CHUNKS / 32; ++i) {
      const int r = wr0 + (lane + 32 * i) / CHUNKS;
      const int c = (lane + 32 * i) % CHUNKS;
      const bool valid = q0 + r < sq;
      cp_async16(qs + q_off<TM>(r, c),
                 qb + (size_t)(valid ? q0 + r : 0) * D + 4 * c, valid);
    }
  };

  // The block walks items blockIdx.x, + gridDim.x, ...: one stream of
  // tiles, K/V(next) staged while the tile before it is computed, and each
  // warp's next Q rows once its last scores of the item are done.
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
    float acc[PM][8];
#pragma unroll
    for (int i = 0; i < PM; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    float l = 0.f;  // of row wr0 + lane, for lane < R

    for (int j = 0; j < ntiles; ++j) {
      const int kbase = j * mx::K_BLOCK;
      cp_async_wait<0>();  // K(j), V(j) and (j == 0) Q have landed
      if (j == 0) {
        // scale the Q chunks this lane copied
#pragma unroll
        for (int i = 0; i < R * CHUNKS / 32; ++i) {
          float4* a = reinterpret_cast<float4*>(
              qs + q_off<TM>(wr0 + (lane + 32 * i) / CHUNKS,
                             (lane + 32 * i) % CHUNKS));
          float4 x = *a;
          x.x = __fmul_rn(x.x, scale);
          x.y = __fmul_rn(x.y, scale);
          x.z = __fmul_rn(x.z, scale);
          x.w = __fmul_rn(x.w, scale);
          *a = x;
        }
      }
      __syncthreads();  // visible to all; the tile before consumed
      int next = nitems;  // the item whose Q this warp stages, if any
      if (j + 1 < ntiles) {
        stage_kv(item, j + 1, buf ^ 1);
        cp_async_commit();
      } else {
        next = next_with_keys(item + gridDim.x);
        if (next < nitems) {
          stage_kv(next, 0, buf ^ 1);
          cp_async_commit();
        }
      }

      // scores: TM x TN chains, each sequential over d from 0
      const float* kt = ks + buf * mx::K_BLOCK * D;
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
          kv[n] = *reinterpret_cast<const float4*>(kt +
                                                   k_off(tx + TX * n, c));
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + q_off<TM>(r0 + i, c));
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

      // P.V: PM x 8 chains, each sequential over the tile's keys
      const float* vt = vs + buf * mx::K_BLOCK * D;
#pragma unroll
      for (int i = 0; i < PM; ++i) {
        const float cr = cs[pr0 + i];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = __fmul_rn(acc[i][c], cr);
      }
#pragma unroll 16
      for (int jj = 0; jj < mx::K_BLOCK; ++jj) {
        float p[PM];
        load_p<BQ, PM>(p, ps, jj, pr0);
        const float4 v0 =
            *reinterpret_cast<const float4*>(vt + jj * D + 4 * dx);
        const float4 v1 =
            *reinterpret_cast<const float4*>(vt + jj * D + 32 + 4 * dx);
#pragma unroll
        for (int i = 0; i < PM; ++i) {
          acc[i][0] = __fmaf_rn(p[i], v0.x, acc[i][0]);
          acc[i][1] = __fmaf_rn(p[i], v0.y, acc[i][1]);
          acc[i][2] = __fmaf_rn(p[i], v0.z, acc[i][2]);
          acc[i][3] = __fmaf_rn(p[i], v0.w, acc[i][3]);
          acc[i][4] = __fmaf_rn(p[i], v1.x, acc[i][4]);
          acc[i][5] = __fmaf_rn(p[i], v1.y, acc[i][5]);
          acc[i][6] = __fmaf_rn(p[i], v1.z, acc[i][6]);
          acc[i][7] = __fmaf_rn(p[i], v1.w, acc[i][7]);
        }
      }
      // the weight sum of row wr0 + lane, sequential over the tile's keys
      if (lane < R) {
        float psum = 0.f;
#pragma unroll 8
        for (int jj = 0; jj < mx::K_BLOCK; ++jj)
          psum = __fadd_rn(psum, ps[p_off<BQ>(jj, wr0 + lane)]);
        l = __fmaf_rn(l, cs[wr0 + lane], psum);
      }
      buf ^= 1;
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
        float* orow = out + ((size_t)bh * sq + qi) * D;
        store4(orow + 4 * dx, mx::finish_out(acc[i][0], li),
               mx::finish_out(acc[i][1], li), mx::finish_out(acc[i][2], li),
               mx::finish_out(acc[i][3], li));
        store4(orow + 32 + 4 * dx, mx::finish_out(acc[i][4], li),
               mx::finish_out(acc[i][5], li), mx::finish_out(acc[i][6], li),
               mx::finish_out(acc[i][7], li));
      }
    }
    if (lane < R && q0 + wr0 + lane < sq)
      lse[(size_t)bh * sq + q0 + wr0 + lane] = mx::finish_lse(ms[wr0 + lane],
                                                             l);
    __syncwarp();  // ms and ls are read before the next item writes them
  }
}

template <int BQ>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lengths, float* out, float* lse, int batch,
                   int heads, int sq, int sk, float scale, int causal,
                   int blocks, cudaStream_t stream) {
  // the shared-memory attribute once per device
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_attention_fwd_kernel<BQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout<BQ>::bytes);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  if (batch * heads == 0 || sq == 0) return cudaSuccess;
  if (blocks <= 0) return cudaErrorInvalidValue;
  flash_attention_fwd_kernel<BQ><<<blocks, THREADS, Layout<BQ>::bytes,
                                   stream>>>(
      q, k, v, lengths, out, lse, batch * heads, heads, sq, sk, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// ---- host entry point ----
// q (B*H, Sq, D), k/v (B*H, Sk, D), lengths (B,) int32, out (B*H, Sq, D),
// lse (B*H, Sq) float32; all contiguous on the device, 16-byte aligned, all
// float32 but lengths. bq (query rows a work item: 128 or 32) comes from
// attention.py fwd_geometry. Returns the cudaError_t of the launch.
extern "C" int mx_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, void* lse, int batch,
                                      int heads, int sq, int sk, int d,
                                      float scale, int causal, int bq,
                                      int blocks, void* stream) {
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  const auto* lf = static_cast<const int*>(lengths);
  auto* ot = static_cast<float*>(out);
  auto* sf = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  if (d != D) return cudaErrorInvalidValue;  // the instance the port needs
  switch (bq) {
    case 128:
      return launch<128>(qt, kt, vt, lf, ot, sf, batch, heads, sq, sk,
                         scale, causal, blocks, st);
    case 32:
      return launch<32>(qt, kt, vt, lf, ot, sf, batch, heads, sq, sk, scale,
                        causal, blocks, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the bq instance in bytes (0: not built), so the
// wrapper can hold its geometry to the kernel's layout.
extern "C" int mx_flash_attention_fwd_smem(int bq) {
  switch (bq) {
    case 128: return (int)Layout<128>::bytes;
    case 32: return (int)Layout<32>::bytes;
    default: return 0;
  }
}
