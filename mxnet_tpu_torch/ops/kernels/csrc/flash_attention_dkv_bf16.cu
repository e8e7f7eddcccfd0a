// Flash-attention dk/dv for Hopper (sm_90a), bf16 on the tensor cores
// (row 3b: AMP's backward).
//
// Replaces: mxnet_tpu_flash_attention_dkv (mxnet_tpu/ops/pallas/attention.py:243)
// for bf16 q, k, v, o and do: dk and dv bf16, lse float32. The float32
// instance stays csrc/flash_attention_bwd.cu (3xTF32); this one holds the
// reference's bf16 tier, not bit identity with it.
//
// Function (attention.py flash_attention_dkv_bf16_reference is its plain
// version), each product and sum rounded on its own (no fused
// multiply-add) unless it is a tensor-core sum:
//   s     = q . k, float32 sums of exact bf16 products
//   p     = 2^(s (scale log2 e) - lse log2 e)    (float32, ex2.approx);
//           0 where masked (k >= length, k >= Sk, causal k > q) or
//           lse == -inf
//   delta = rowsum(do * o), float32
//   dp    = do . v;  ds = (p (dp - delta)) scale  (float32)
//   dv    = sum_q bf16(p) do;  dk = sum_q bf16(ds) q  (float32 sums)
// each rounded once to bf16 at the end. The only roundings beyond
// float32's are p and ds before their products, and the outputs.
//
// What bounds it on the H100: at AMP's training shape (B 96, H 12, S 128,
// D 64) bytes: 132 MB of q, k, v, o, do in and dk, dv out plus 0.6 MB of
// lse, 0.0396 ms at 3.35 TB/s, against 9.66 GFLOP, 0.0098 ms at 989
// TFLOP/s on bf16 tensor cores.
//
// Head dims. Every D from 1 to 128 runs, through instances built at the
// padded widths W = 16, 32, 64 and 128 (attention.py head_width), each for
// D == W (FULL) and D < W, columns past D zero in the tiles (mma_bf16.cuh:
// rows of D % 8 != 0 columns staged through registers). A warp's dK and
// dV accumulators are W floats a thread, 128 at W 128: there a block owns
// 64 keys (4 warps) and may take 255 registers a thread, two blocks an
// SM (BK and MIN_BLOCKS below).
//
// Design. One block of 8 warps a (batch*head, 128-key block) (4 warps and
// 64 keys at W 128), the key blocks of a head adjacent, two blocks an SM
// (57 KB of shared memory and at most 128 registers a thread at W 64), so
// no sum crosses blocks: no atomics, deterministic results. Warp w owns keys 16w .. 16w + 15 and keeps S^T,
// P^T, dP^T, dS^T, dK and dV in mma fragments:
//   * K and V are staged once as raw bf16 by 16-byte cp.async into
//     swizzled tiles; the block walks 32-query tiles of Q, dO, O and lse,
//     double-buffered: the next tile's copies run while this one is
//     computed. Each thread copies its 16-byte chunks of Q, dO and O (one
//     of each at W 64); after its own wait it sums its chunks of dO * O,
//     W / 8 lanes a row by shuffles give delta (one block barrier a tile publishes tile and
//     statistics). Rows past Sq or Sk are zero-filled by the copy, and
//     past Sq lse reads -inf;
//   * per tile: S^T = K Q^T (mma.sync m16n8k16 bf16, float32 sums, K and
//     Q by ldmatrix), P^T in place, dV += bf16(P^T) dO (P^T packed
//     straight into A fragments, dO by ldmatrix.trans), dP^T = V dO^T,
//     dS^T in place, dK += bf16(dS^T) Q;
//   * in the transposed fragments lse and delta vary along n: each lane
//     reads those of queries 8n + 2tq (+ 1) as float2;
//   * the output: each warp rounds its dK and dV rows once into its own
//     rows of the K and V tiles, then 16-byte stores.
// A causal block starts at the first query tile that sees its keys; a
// block past the length walks nothing and writes zeros; the masks are
// skipped where a whole tile is visible to every key.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma_bf16.cuh"

namespace {

using namespace mx_mma;

// the tiles of the instance at padded width W
template <int W>
struct Dkv {
  static constexpr int BK = 128 - 64 * (W > 64);  // keys a block
  static constexpr int BQ = 32;                 // queries a tile
  static constexpr int WARPS = BK / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int KTILE = BK * 2 * W;
  static constexpr int QTILE = BQ * 2 * W;
  // shared memory: K, V, two buffers of the Q, dO and O tiles, two lse and
  // two delta rows
  static constexpr int SMEM_BYTES = 2 * KTILE + 2 * 3 * QTILE + 2 * 2 * BQ * 4;
  static constexpr int MIN_BLOCKS = 2;  // blocks an SM
};

template <int W, bool FULL>
__global__ void __launch_bounds__(Dkv<W>::THREADS, Dkv<W>::MIN_BLOCKS)
flash_attention_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ o,
                                const float* __restrict__ lse,
                                const __nv_bfloat16* __restrict__ dout,
                                const int* __restrict__ lengths,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int heads,
                                int sq, int sk, int d_arg, float scale,
                                int causal) {
  using G = Dkv<W>;
  constexpr int BK = G::BK;
  constexpr int BQ = G::BQ;
  constexpr int THREADS = G::THREADS;
  constexpr int KTILE = G::KTILE;
  constexpr int QTILE = G::QTILE;
  constexpr int CHUNKS = Row<W>::CHUNKS;
  // a query tile's chunks, and each thread's passes over them
  constexpr int QCH = BQ * CHUNKS;
  constexpr int PASSES = (QCH + THREADS - 1) / THREADS;
  // tile offsets in bytes
  constexpr int K_AT = 0;
  constexpr int V_AT = KTILE;
  constexpr int QBUF_AT = 2 * KTILE;  // buffer b: Q, dO, O at + b * 3 QTILE
  constexpr int LSE_AT = QBUF_AT + 2 * 3 * QTILE;  // 2 x [BQ] floats
  constexpr int DELTA_AT = LSE_AT + 2 * BQ * 4;    // 2 x [BQ] floats
  static_assert(QCH % 32 == 0, "whole warps of chunks");
  const int d = FULL ? W : d_arg;  // the real head dim: the row stride
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  float* const lse_s = reinterpret_cast<float*>(smem + LSE_AT);
  float* const delta_s = reinterpret_cast<float*>(smem + DELTA_AT);

  const int ktiles = (sk + BK - 1) / BK;
  const int bh = blockIdx.x / ktiles;
  const int k0 = (blockIdx.x % ktiles) * BK;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  const float* lseb = lse + (size_t)bh * sq;

  const int len = max(0, min(lengths[bh / heads], sk));
  // no query sees a key at or past the length; a causal key k is seen
  // only by queries q >= k
  const int qbegin = causal ? k0 / BQ * BQ : 0;
  const int ntiles = k0 < len ? max(0, (sq - qbegin + BQ - 1) / BQ) : 0;
  const float scale2 = scale * LOG2E;

  // the Q, dO and O tiles of query rows row0 .. row0 + BQ - 1 into buffer
  // b and their lse, by the thread that copies its row's first chunk; the
  // caller commits the group
  auto stage_queries = [&](int b, int row0) {
    const uint32_t at = base + QBUF_AT + b * 3 * QTILE;
    stage_rows<W, FULL, BQ, THREADS>(at, q + qoff, row0, sq, d, t);
    stage_rows<W, FULL, BQ, THREADS>(at + QTILE, dout + qoff, row0, sq, d,
                                     t);
    stage_rows<W, FULL, BQ, THREADS>(at + 2 * QTILE, o + qoff, row0, sq, d,
                                     t);
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int idx = t + i * THREADS;
      if ((QCH % THREADS == 0 || idx < QCH) && idx % CHUNKS == 0) {
        const int r = idx / CHUNKS;
        const bool valid = row0 + r < sq;
        cp_async4(base + LSE_AT + (b * BQ + r) * 4,
                  lseb + (valid ? row0 + r : 0), valid);
      }
    }
  };
  // delta = rowsum(dO * O) of buffer b from the chunks this thread copied
  // (visible to it after its own wait, no barrier), the CHUNKS lanes of a
  // row summed by shuffles; past Sq lse = -inf. Warps past the tile's
  // chunks (QCH < THREADS) hold none and skip it whole.
  auto query_stats = [&](int b, int row0) {
    const unsigned char* at = smem + QBUF_AT + b * 3 * QTILE;
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int idx = t + i * THREADS;
      if (QCH % THREADS == 0 || idx < QCH) {
        const int r = idx / CHUNKS;
        const int c = idx % CHUNKS;
        float x[8], y[8];
        mx_bf16::widen8(
            *reinterpret_cast<const uint4*>(at + QTILE + off<W>(r, c)), x);
        mx_bf16::widen8(
            *reinterpret_cast<const uint4*>(at + 2 * QTILE + off<W>(r, c)),
            y);
        float acc = __fmul_rn(x[0], y[0]);
#pragma unroll
        for (int e = 1; e < 8; ++e) acc = __fmaf_rn(x[e], y[e], acc);
#pragma unroll
        for (int s = 1; s < CHUNKS; s <<= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, s);
        if (c == 0) {
          delta_s[b * BQ + r] = acc;
          if (row0 + r >= sq) lse_s[b * BQ + r] = -CUDART_INF_F;
        }
      }
    }
  };

  float dka[W / 8][4], dva[W / 8][4];
#pragma unroll
  for (int c = 0; c < W / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;

  if (ntiles > 0) {
    stage_rows<W, FULL, BK, THREADS>(base + K_AT, k + koff, k0, sk, d, t);
    stage_rows<W, FULL, BK, THREADS>(base + V_AT, v + koff, k0, sk, d, t);
    stage_queries(0, qbegin);
    cp_async_commit();
    cp_async_wait_all();
    query_stats(0, qbegin);
  }
  const int kj0 = k0 + 16 * w + g;  // the lane's keys kj0 and kj0 + 8
  for (int j = 0; j < ntiles; ++j) {
    const int q0 = qbegin + j * BQ;
    const int cur = j & 1;
    __syncthreads();  // tile j and its statistics visible; j - 1 consumed
    if (j + 1 < ntiles) {
      stage_queries(cur ^ 1, q0 + BQ);
      cp_async_commit();
    }
    const uint32_t qt = base + QBUF_AT + cur * 3 * QTILE;
    const uint32_t dot = qt + QTILE;
    const float* lq = lse_s + cur * BQ;
    const float* dl = delta_s + cur * BQ;

    // P^T: element e of n-tile n: key kj0 + 8 (e >> 1), query q0 + 8n +
    // 2tq + (e & 1). In a tile visible to every key of the block no query
    // has lse == -inf, and nothing is masked.
    float st[BQ / 8][4];
    product_nt<W>(st, base + K_AT, qt, 16 * w, lane);
    const bool whole = q0 + BQ <= sq && k0 + BK <= len &&
                       (!causal || k0 + BK - 1 <= q0);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 lv = *reinterpret_cast<const float2*>(lq + 8 * n + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float li = (e & 1) ? lv.y : lv.x;
        const float p = exp2_approx(__fsub_rn(__fmul_rn(st[n][e], scale2),
                                              __fmul_rn(li, LOG2E)));
        bool vis = true;
        if (!whole) {
          const int kj = kj0 + 8 * (e >> 1);
          const int qi = q0 + 8 * n + 2 * tq + (e & 1);
          vis = li != -CUDART_INF_F && kj < len && (!causal || kj <= qi);
        }
        st[n][e] = vis ? p : 0.f;
      }
    }
    product_pv<W, BQ / 16>(dva, st, dot, lane);  // dV += P^T dO

    float dpt[BQ / 8][4];
    product_nt<W>(dpt, base + V_AT, dot, 16 * w, lane);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 dd = *reinterpret_cast<const float2*>(dl + 8 * n + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[n][e] = __fmul_rn(
            __fmul_rn(st[n][e], __fsub_rn(dpt[n][e], (e & 1) ? dd.y : dd.x)),
            scale);
    }
    product_pv<W, BQ / 16>(dka, dpt, qt, lane);  // dK += dS^T Q

    if (j + 1 < ntiles) {
      cp_async_wait_all();
      query_stats(cur ^ 1, q0 + BQ);
    }
  }
  // the warp's K and V rows are its own and read: they take its dK and dV
  const float one[2] = {1.f, 1.f};
  store_rows<W, FULL>(dka, one, smem + K_AT, 16 * w, dk + koff, k0 + 16 * w,
                      sk, d, lane);
  store_rows<W, FULL>(dva, one, smem + V_AT, 16 * w, dv + koff, k0 + 16 * w,
                      sk, d, lane);
}

template <int W, bool FULL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* lse, const void* dout,
                   const void* lengths, void* dk, void* dv, int batch,
                   int heads, int sq, int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  using G = Dkv<W>;
  auto* kernel = flash_attention_dkv_bf16_kernel<W, FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long items =
      (long long)batch * heads * ((sk + G::BK - 1) / G::BK);
  if (items == 0) return cudaSuccess;
  kernel<<<(unsigned)items, G::THREADS, G::SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

// the padded widths built, each for D == W and for D < W
#define MX_BF16_WIDTHS(X) X(16) X(32) X(64) X(128)

}  // namespace

// ---- host entry points ----
// q, o, do (B*H, Sq, D) and k, v, dk, dv (B*H, Sk, D) bf16; lse (B*H, Sq)
// float32; lengths (B,) int32. All contiguous on the device. width is the
// padded width of the instance (16, 32, 64 or 128; 1 <= D <= width). One
// block a (batch*head, key block). Returns the cudaError_t of the launch.
extern "C" int mx_flash_attention_dkv_bf16(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* lse, const void* dout,
                                           const void* lengths, void* dk,
                                           void* dv, int batch, int heads,
                                           int sq, int sk, int d, int width,
                                           float scale, int causal,
                                           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > width) return cudaErrorInvalidValue;
  switch (width) {
#define X(W)                                                              \
  case W:                                                                 \
    return d == W ? launch<W, true>(q, k, v, o, lse, dout, lengths, dk,   \
                                    dv, batch, heads, sq, sk, d, scale,   \
                                    causal, st)                           \
                  : launch<W, false>(q, k, v, o, lse, dout, lengths, dk,  \
                                     dv, batch, heads, sq, sk, d, scale,  \
                                     causal, st);
    MX_BF16_WIDTHS(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block in bytes, keys a block and queries a tile
// of the instance at padded width `width` (0: not built), so the wrapper
// can hold its geometry (attention.py dkv_bf16_geometry) to the kernel's
// layout.
#define MX_DKV_ENTRY(NAME, FIELD)   \
  extern "C" int NAME(int width) {  \
    switch (width) {                \
      case 16:                      \
        return Dkv<16>::FIELD;      \
      case 32:                      \
        return Dkv<32>::FIELD;      \
      case 64:                      \
        return Dkv<64>::FIELD;      \
      case 128:                     \
        return Dkv<128>::FIELD;     \
      default:                      \
        return 0;                   \
    }                               \
  }
MX_DKV_ENTRY(mx_flash_attention_dkv_bf16_smem, SMEM_BYTES)
MX_DKV_ENTRY(mx_flash_attention_dkv_bf16_block_k, BK)
MX_DKV_ENTRY(mx_flash_attention_dkv_bf16_block_q, BQ)
