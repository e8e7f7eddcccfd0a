// Flash-attention forward for Hopper (sm_90a), bf16 on the tensor cores
// (row 1b: AMP's forward).
//
// Replaces: mxnet_tpu_flash_attention_fwd (mxnet_tpu/ops/pallas/attention.py:111)
// for bf16 q, k and v: out bf16, lse float32. The float32 instance stays
// csrc/flash_attention_fwd.cu (bitwise the decode kernel); this one has
// no such contract (decode stays float32), only the reference's bf16
// tier, 0.02 absolute of the float32 result on the same bf16 inputs
// (mxnet_tpu/ops/pallas/__main__.py:88-103).
//
// Function (attention.py flash_attention_bf16_reference is its plain
// version): per 128-key tile, in order, with x the scores in log2 units
// (each product and sum below rounded on its own: no fused multiply-add),
//   x    = (q . k) * (scale log2 e), float32 sums of exact bf16 products;
//          masked keys (k >= length, k >= Sk, causal k > q) at -inf
//   m'   = max(m, max_j x_j); safe = m' or 0 if -inf; corr = 2^(m - safe)
//   p_j  = 2^(x_j - safe)                        (float32, ex2.approx)
//   l'   = l corr + sum_j p_j                    (the float32 p)
//   acc' = acc corr + sum_j bf16(p_j) v_j        (p rounded to nearest even)
// then out = bf16(acc * (1 / max(l, 1e-20))), lse = safe ln 2 + log l (l > 0),
// else -inf and out 0. The only roundings beyond float32's are p before
// P.V and the output.
//
// What bounds it on the H100: at AMP's training shape (B 96, H 12, S 128,
// D 64) bytes: 75.5 MB of q, k, v and out plus 0.6 MB of lse, 0.0227 ms at
// 3.35 TB/s, against 4.83 GFLOP, 0.0049 ms at 989 TFLOP/s. So mma.sync
// suffices; what counts is keeping copies in flight.
//
// Head dims. Every D from 1 to 128 runs, through instances built at the
// padded widths W = 16, 32, 64 and 128 (the smallest W >= D, which the
// wrapper passes: attention.py head_width), each for D == W (FULL: the
// row stride a constant) and for D < W. Tiles hold W columns, those past
// D zero (mma_bf16.cuh: 16-byte cp.async where D % 8 == 0, else rows
// staged through registers, since no cp.async copies 2 bytes), so every
// product over W is the product over D; only the D real columns of out
// are written. At W 128 the 128-row query tile's O accumulators (64
// floats a thread) and the scores (64) do not fit two blocks an SM at 128
// registers, and its 160 KB of tiles do not fit twice either: one block
// an SM there (MIN_BLOCKS below), 8 warps of 16 rows as at every width.
//
// Design. One block of 8 warps a work item (batch*head, 128-query tile),
// two blocks an SM up to width 64 (80 KB of shared memory at 64 and at most
// 128 registers a thread each), so one block's copies run while the other
// computes; warp w
// owns query rows 16w .. 16w + 15 throughout:
//   * staging: Q, K and V arrive as raw bf16 by 16-byte cp.async into
//     swizzled tiles (mma_bf16.cuh); K and V are double-buffered, the next
//     key tile's copies issued before this one is computed. Rows past Sq
//     or Sk are zero-filled by the copy (src-size 0), never padded;
//   * S = Q K^T: mma.sync m16n8k16 bf16, float32 sums, Q and K fed by
//     ldmatrix: 16 x 128 scores a warp, 64 floats a thread;
//   * the online softmax runs on the accumulators in registers: the row
//     max by two quad shuffles (a row's 128 keys lie on the 4 lanes of a
//     quad), masks computed (skipped where the whole tile is visible),
//     each lane's share of l in float32, summed over the quad at the end;
//   * P.V: p rounded to bf16 and packed straight into the A fragments (C
//     fragments of n-tiles 2j, 2j + 1 are A's k-step j), V by
//     ldmatrix.trans; out accumulates in float32 registers;
//   * the output: each warp rounds its 16 rows once into its own rows of
//     the Q tile, then 16-byte stores; lse by one lane a row.
// Key tiles past the item's last visible key are not walked; an item with
// none writes zeros and -inf.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma_bf16.cuh"

namespace {

using namespace mx_mma;

// the tiles of the instance at padded width W
template <int W>
struct Fwd {
  static constexpr int BQ = 128;  // query rows a work item
  static constexpr int BK = 128;  // keys a tile: the reference's K_BLOCK
  static constexpr int WARPS = BQ / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TILE = 128 * 2 * W;  // bytes of a 128-row tile
  // shared memory: the Q tile, then K and V of buffer 0, K and V of
  // buffer 1
  static constexpr int SMEM_BYTES = TILE + 2 * 2 * BK * 2 * W;
  static constexpr int MIN_BLOCKS = 2 - (W > 64);  // blocks an SM
};

template <int W, bool FULL>
__global__ void __launch_bounds__(Fwd<W>::THREADS, Fwd<W>::MIN_BLOCKS)
flash_attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const int* __restrict__ lengths,
                                __nv_bfloat16* __restrict__ out,
                                float* __restrict__ lse, int heads, int sq,
                                int sk, int d_arg, float scale, int causal) {
  using G = Fwd<W>;
  constexpr int BQ = G::BQ;
  constexpr int BK = G::BK;
  constexpr int THREADS = G::THREADS;
  constexpr int TILE = G::TILE;
  const int d = FULL ? W : d_arg;  // the real head dim: the row stride
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t kv0 = qs + TILE;  // K(buf) at kv0 + buf * 2 TILE, V + TILE

  const int qtiles = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x % qtiles) * BQ;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const __nv_bfloat16* qb = q + (size_t)bh * sq * d;
  const __nv_bfloat16* kb = k + (size_t)bh * sk * d;
  const __nv_bfloat16* vb = v + (size_t)bh * sk * d;

  const int len = max(0, min(lengths[bh / heads], sk));
  int kend = len;  // one past the last key any row of the item sees
  if (causal) kend = min(kend, min(q0 + BQ, sq));
  const int ntiles = (kend + BK - 1) / BK;
  const float scale2 = scale * LOG2E;
  const int r0 = q0 + 16 * w + g;  // the lane's rows r0 and r0 + 8

  float o[W / 8][4];
#pragma unroll
  for (int c = 0; c < W / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // the lane's share of each row's sum

  if (ntiles > 0) {
    stage_rows<W, FULL, BQ, THREADS>(qs, qb, q0, sq, d, t);
    stage_rows<W, FULL, BK, THREADS>(kv0, kb, 0, sk, d, t);
    stage_rows<W, FULL, BK, THREADS>(kv0 + TILE, vb, 0, sk, d, t);
    cp_async_commit();
  }
  for (int j = 0; j < ntiles; ++j) {
    const int kbase = j * BK;
    const uint32_t kt = kv0 + (j & 1) * 2 * TILE;
    cp_async_wait_all();  // K(j), V(j) and (j == 0) Q have landed
    __syncthreads();      // visible to all; tile j - 1 consumed
    if (j + 1 < ntiles) {
      const uint32_t nt = kv0 + ((j + 1) & 1) * 2 * TILE;
      stage_rows<W, FULL, BK, THREADS>(nt, kb, kbase + BK, sk, d, t);
      stage_rows<W, FULL, BK, THREADS>(nt + TILE, vb, kbase + BK, sk, d, t);
      cp_async_commit();
    }

    float s[BK / 8][4];
    product_nt<W>(s, qs, kt, 16 * w, lane);

    // x = s * scale log2 e, masked; element e of n-tile n: row r0 +
    // 8 (e >> 1), key kbase + 8n + 2tq + (e & 1)
    const bool whole =
        kbase + BK <= len && (!causal || kbase + BK - 1 <= q0);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[n][e], scale2);
        if (!whole) {
          const int kp = kbase + 8 * n + 2 * tq + (e & 1);
          const int qi = r0 + 8 * (e >> 1);
          if (!(kp < len && (!causal || kp <= qi))) x = -CUDART_INF_F;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float safe[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      safe[h] = m_new == -CUDART_INF_F ? 0.f : m_new;
      corr[h] = exp2_approx(__fsub_rn(m[h], safe[h]));  // m -inf: 0
      m[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(__fsub_rn(s[n][e], safe[e >> 1]));
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), rs[h]);
#pragma unroll
    for (int c = 0; c < W / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] *= corr[e >> 1];
    product_pv<W, BK / 16>(o, s, kt + TILE, lane);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-20f);
  }
  // the warp's Q rows are its own and read: they take its output rows
  store_rows<W, FULL>(o, inv, smem, 16 * w, out + (size_t)bh * sq * d,
                      q0 + 16 * w, sq, d, lane);
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = r0 + 8 * h;
      if (qi < sq)
        lse[(size_t)bh * sq + qi] =
            l[h] > 0.f ? __fadd_rn(__fmul_rn(m[h], LN2), logf(l[h]))
                       : -CUDART_INF_F;
    }
  }
}

template <int W, bool FULL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, void* lse, int batch,
                   int heads, int sq, int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  using G = Fwd<W>;
  auto* kernel = flash_attention_fwd_bf16_kernel<W, FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long items =
      (long long)batch * heads * ((sq + G::BQ - 1) / G::BQ);
  if (items == 0) return cudaSuccess;
  kernel<<<(unsigned)items, G::THREADS, G::SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), heads, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

// the padded widths built, each for D == W and for D < W
#define MX_BF16_WIDTHS(X) X(16) X(32) X(64) X(128)

}  // namespace

// ---- host entry points ----
// q (B*H, Sq, D), k/v (B*H, Sk, D), out (B*H, Sq, D) bf16; lengths (B,)
// int32; lse (B*H, Sq) float32; all contiguous on the device. width is
// the padded width of the instance (16, 32, 64 or 128; 1 <= D <= width,
// attention.py head_width). One block a (batch*head, 128-query tile), the
// tiles of a head adjacent. Returns the cudaError_t of the launch.
extern "C" int mx_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* lse, int batch, int heads, int sq, int sk, int d,
    int width, float scale, int causal, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > width) return cudaErrorInvalidValue;
  switch (width) {
#define X(W)                                                              \
  case W:                                                                 \
    return d == W ? launch<W, true>(q, k, v, lengths, out, lse, batch,    \
                                    heads, sq, sk, d, scale, causal, st)  \
                  : launch<W, false>(q, k, v, lengths, out, lse, batch,   \
                                     heads, sq, sk, d, scale, causal, st);
    MX_BF16_WIDTHS(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block in bytes and query rows a work item of the
// instance at padded width `width` (0: not built), so the wrapper can hold
// its geometry (attention.py fwd_bf16_geometry) to the kernel's layout.
extern "C" int mx_flash_attention_fwd_bf16_smem(int width) {
  switch (width) {
#define X(W) \
  case W:    \
    return Fwd<W>::SMEM_BYTES;
    MX_BF16_WIDTHS(X)
#undef X
    default:
      return 0;
  }
}
extern "C" int mx_flash_attention_fwd_bf16_block_q(int width) {
  switch (width) {
#define X(W) \
  case W:    \
    return Fwd<W>::BQ;
    MX_BF16_WIDTHS(X)
#undef X
    default:
      return 0;
  }
}
