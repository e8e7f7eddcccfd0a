// Flash-attention dq for Hopper (sm_90a), bf16 on the tensor cores
// (row 2b: AMP's backward).
//
// Replaces: mxnet_tpu_flash_attention_dq (mxnet_tpu/ops/pallas/attention.py:208)
// for bf16 q, k, v, o and do: dq bf16, lse float32. The float32 instance
// stays csrc/flash_attention_bwd.cu (3xTF32); this one holds the
// reference's bf16 tier, not bit identity with it.
//
// Function (attention.py flash_attention_dq_bf16_reference is its plain
// version), each product and sum rounded on its own (no fused
// multiply-add) unless it is a tensor-core sum:
//   s     = q . k, float32 sums of exact bf16 products
//   p     = 2^(s (scale log2 e) - lse log2 e)    (float32, ex2.approx);
//           0 where masked (k >= length, k >= Sk, causal k > q) or
//           lse == -inf
//   delta = rowsum(do * o), float32
//   dp    = do . v;  ds = (p (dp - delta)) scale  (float32)
//   dq    = sum_k bf16(ds) k  (float32 sums)
// rounded once to bf16 at the end. The only roundings beyond float32's are
// ds before its product, and the output.
//
// What bounds it on the H100: at AMP's training shape (B 96, H 12, S 128,
// D 64) bytes: 113 MB of q, k, v, o, do in and dq out plus 0.6 MB of lse,
// 0.0341 ms at 3.35 TB/s, against 7.25 GFLOP (three products), 0.0073 ms
// at 989 TFLOP/s on bf16 tensor cores.
//
// Head dims. Every D from 1 to 128 runs, through instances built at the
// padded widths W = 16, 32, 64 and 128 (attention.py head_width), each for
// D == W (FULL) and D < W, columns past D zero in the tiles (mma_bf16.cuh:
// rows of D % 8 != 0 columns staged through registers). At W 128 the dq
// accumulators double (64 floats a thread) and the tiles take 192 KB: one
// block an SM there (MIN_BLOCKS below), the same 128-query items.
//
// Design. One block of 8 warps a work item (batch*head, 128-query tile),
// the query tiles of a head adjacent, two blocks an SM up to width 64 (96
// KB of shared memory at 64, at most 128 registers a thread), so no sum
// crosses blocks: no atomics, deterministic results. Warp w owns query
// rows 16w .. 16w + 15 and keeps S, P, dP, dS and dQ in mma fragments:
//   * Q and dO are staged once as raw bf16 by 16-byte cp.async into
//     swizzled tiles (mma_bf16.cuh); the block walks 128-key tiles of K
//     and V (one at S 128), double-buffered: the next tile's copies are
//     issued before this one is computed. Rows past Sq or Sk are
//     zero-filled by the copy;
//   * each lane holds its two rows' lse (-inf past Sq) and delta =
//     rowsum(dO * O): O arrives by 16-byte loads into registers while the
//     first copies fly and is summed against the staged dO, W / 8 lanes a
//     row by shuffles; O is never staged;
//   * per 32 keys of a tile (four steps a tile, so S, dP and dQ take 16 +
//     16 + 32 floats a thread): S = Q K^T (mma.sync m16n8k16 bf16, float32
//     sums, Q and K by ldmatrix), P, dP = dO V^T (V by ldmatrix), dS in
//     dP's registers, dQ += bf16(dS) K (dS packed straight from the C
//     fragments into A fragments, K by ldmatrix.trans);
//   * the output: each warp rounds its dQ rows once into its own rows of
//     the Q tile, then 16-byte stores.
// Key tiles past the item's last visible key are not walked (a causal item
// stops at its last query); an item with none writes zeros; the masks are
// skipped where a whole tile is visible to every row. A row whose lse is
// -inf (no visible key) takes ds = 0 by the mask: no inf * 0 is formed.
// Chosen by tools/probe_flash_bf16_variants.py dq at the training shape on
// an H100 SXM (700 W): 128-key tiles ran 4 % faster than 64-key ones; 64
// keys a step spilled 236 bytes and ran 26 % slower, as did one block an
// SM (237 registers, no spill).
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma_bf16.cuh"

namespace {

using namespace mx_mma;

// the tiles of the instance at padded width W
template <int W>
struct Dq {
  static constexpr int BQ = 128;  // query rows a work item
  static constexpr int BK = 128;  // keys a tile
  static constexpr int KS = 32;   // keys a step
  static constexpr int WARPS = BQ / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int QTILE = BQ * 2 * W;
  static constexpr int KTILE = BK * 2 * W;
  // shared memory: the Q and dO tiles, then K and V of buffer 0, K and V
  // of buffer 1
  static constexpr int SMEM_BYTES = 2 * QTILE + 2 * 2 * KTILE;
  static constexpr int MIN_BLOCKS = 2 - (W > 64);  // blocks an SM
};

// 16 bytes of data read once: the read-only path, no L1 line
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  uint4 w;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
      : "l"(p));
  return w;
}

template <int W, bool FULL>
__global__ void __launch_bounds__(Dq<W>::THREADS, Dq<W>::MIN_BLOCKS)
flash_attention_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ o,
                               const float* __restrict__ lse,
                               const __nv_bfloat16* __restrict__ dout,
                               const int* __restrict__ lengths,
                               __nv_bfloat16* __restrict__ dq, int heads,
                               int sq, int sk, int d_arg, float scale,
                               int causal) {
  using G = Dq<W>;
  constexpr int BQ = G::BQ;
  constexpr int BK = G::BK;
  constexpr int KS = G::KS;
  constexpr int THREADS = G::THREADS;
  constexpr int QTILE = G::QTILE;
  constexpr int KTILE = G::KTILE;
  constexpr int CHUNKS = Row<W>::CHUNKS;
  constexpr int ROW_BYTES = Row<W>::BYTES;
  // the lane's O chunks: 16 rows x CHUNKS a warp, OC a lane; RPI rows a
  // pass of the warp (chunk 32 i + lane: row RPI i + lane / CHUNKS)
  constexpr int OC = 16 * CHUNKS / 32 > 0 ? 16 * CHUNKS / 32 : 1;
  constexpr int RPI = 32 / CHUNKS;
  // tile offsets in bytes
  constexpr int Q_AT = 0;
  constexpr int DO_AT = QTILE;
  constexpr int KV_AT = 2 * QTILE;  // buffer b: K at + b * 2 KTILE, V + KTILE
  static_assert(BK % KS == 0 && KS % 16 == 0, "whole steps of k-steps");
  const int d = FULL ? W : d_arg;  // the real head dim: the row stride
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  const int qtiles = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x % qtiles) * BQ;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t qoff = (size_t)bh * sq * d;
  const __nv_bfloat16* kb = k + (size_t)bh * sk * d;
  const __nv_bfloat16* vb = v + (size_t)bh * sk * d;

  const int len = max(0, min(lengths[bh / heads], sk));
  int kend = len;  // one past the last key any row of the item sees
  if (causal) kend = min(kend, min(q0 + BQ, sq));
  const int ntiles = (kend + BK - 1) / BK;
  const float scale2 = scale * LOG2E;
  const int r0 = q0 + 16 * w + g;  // the lane's rows r0 and r0 + 8

  float acc[W / 8][4];
#pragma unroll
  for (int c = 0; c < W / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  // the lane's O chunks (zeros past Sq and past D)
  uint4 ov[OC];
  // lse log2 e (-inf past Sq) and delta of the lane's rows r0, r0 + 8
  float lse2[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float delta[2] = {0.f, 0.f};
  if (ntiles > 0) {
    stage_rows<W, FULL, BQ, THREADS>(base + Q_AT, q + qoff, q0, sq, d, t);
    stage_rows<W, FULL, BQ, THREADS>(base + DO_AT, dout + qoff, q0, sq, d,
                                     t);
    stage_rows<W, FULL, BK, THREADS>(base + KV_AT, kb, 0, sk, d, t);
    stage_rows<W, FULL, BK, THREADS>(base + KV_AT + KTILE, vb, 0, sk, d, t);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < OC; ++i) {
      const int qi = q0 + 16 * w + RPI * i + lane / CHUNKS;
      const int c = lane % CHUNKS;
      const __nv_bfloat16* row = o + qoff + (size_t)qi * d;
      if (qi >= sq || (!FULL && 8 * c >= d))
        ov[i] = make_uint4(0u, 0u, 0u, 0u);
      else if (FULL || (d & 7) == 0)
        ov[i] = load16(row + 8 * c);
      else
        ov[i] = narrow_chunk(row, c, d);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < sq)
        lse2[h] = __fmul_rn(lse[(size_t)bh * sq + r0 + 8 * h], LOG2E);
  }

  for (int j = 0; j < ntiles; ++j) {
    const int kbase = j * BK;
    const uint32_t kt = base + KV_AT + (j & 1) * 2 * KTILE;
    const uint32_t vt = kt + KTILE;
    cp_async_wait_all();  // K(j), V(j) and (j == 0) Q and dO have landed
    __syncthreads();      // visible to all; tile j - 1 consumed
    if (j + 1 < ntiles) {
      const uint32_t nt = base + KV_AT + ((j + 1) & 1) * 2 * KTILE;
      stage_rows<W, FULL, BK, THREADS>(nt, kb, kbase + BK, sk, d, t);
      stage_rows<W, FULL, BK, THREADS>(nt + KTILE, vb, kbase + BK, sk, d, t);
      cp_async_commit();
    }
    if (j == 0) {
      // delta: each lane sums its chunks of dO * O, the CHUNKS lanes of a
      // row add theirs by shuffles; row u of the warp's 16 then lies in
      // part[u / RPI] of lanes CHUNKS (u % RPI) ..
      float part[OC];
#pragma unroll
      for (int i = 0; i < OC; ++i) {
        float x[8], y[8];
        mx_bf16::widen8(ov[i], x);
        mx_bf16::widen8(*reinterpret_cast<const uint4*>(
                            smem + DO_AT +
                            off<W>(16 * w + RPI * i + lane / CHUNKS,
                                   lane % CHUNKS)),
                        y);
        float a = __fmul_rn(x[0], y[0]);
#pragma unroll
        for (int e = 1; e < 8; ++e) a = __fmaf_rn(x[e], y[e], a);
#pragma unroll
        for (int s = 1; s < CHUNKS; s <<= 1)
          a += __shfl_xor_sync(0xffffffffu, a, s);
        part[i] = a;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // row g + 8h of the warp's
        const int u = g + 8 * h;
#pragma unroll
        for (int i = 0; i < OC; ++i)
          if (i >= 8 * h / RPI && i <= (8 * h + 7) / RPI) {
            const float x =
                __shfl_sync(0xffffffffu, part[i], CHUNKS * (u % RPI));
            if (u / RPI == i) delta[h] = x;
          }
      }
    }

    // element e of n-tile n of a step: row r0 + 8 (e >> 1), key kbase +
    // KS h + 8n + 2tq + (e & 1). In a tile visible to every row of the item
    // no row has lse == -inf, and nothing is masked.
    const bool whole = q0 + BQ <= sq && kbase + BK <= len &&
                       (!causal || kbase + BK - 1 <= q0);
#pragma unroll
    for (int h = 0; h < BK / KS; ++h) {
      const uint32_t ks = kt + h * KS * ROW_BYTES;
      float s[KS / 8][4], dp[KS / 8][4];
      product_nt<W>(s, base + Q_AT, ks, 16 * w, lane);         // S = Q K^T
      product_nt<W>(dp, base + DO_AT, vt + h * KS * ROW_BYTES,  // dP = dO V^T
                    16 * w, lane);
#pragma unroll
      for (int n = 0; n < KS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(
              __fsub_rn(__fmul_rn(s[n][e], scale2), lse2[e >> 1]));
          bool vis = true;
          if (!whole) {
            const int kj = kbase + h * KS + 8 * n + 2 * tq + (e & 1);
            const int qi = r0 + 8 * (e >> 1);
            vis = lse2[e >> 1] != -CUDART_INF_F && kj < len &&
                  (!causal || kj <= qi);
          }
          dp[n][e] = vis ? __fmul_rn(__fmul_rn(p, __fsub_rn(
                                                      dp[n][e],
                                                      delta[e >> 1])),
                                     scale)
                         : 0.f;
        }
      product_pv<W, KS / 16>(acc, dp, ks, lane);  // dQ += dS K
    }
  }
  // the warp's Q rows are its own and read: they take its dQ rows
  const float one[2] = {1.f, 1.f};
  store_rows<W, FULL>(acc, one, smem + Q_AT, 16 * w, dq + qoff, q0 + 16 * w,
                      sq, d, lane);
}

template <int W, bool FULL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* lse, const void* dout,
                   const void* lengths, void* dq, int batch, int heads,
                   int sq, int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  using G = Dq<W>;
  auto* kernel = flash_attention_dq_bf16_kernel<W, FULL>;
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
      static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(dq),
      heads, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

// the padded widths built, each for D == W and for D < W
#define MX_BF16_WIDTHS(X) X(16) X(32) X(64) X(128)

}  // namespace

// ---- host entry points ----
// q, o, do, dq (B*H, Sq, D) and k, v (B*H, Sk, D) bf16; lse (B*H, Sq)
// float32; lengths (B,) int32. All contiguous on the device. width is the
// padded width of the instance (16, 32, 64 or 128; 1 <= D <= width). One
// block a (batch*head, 128-query tile), the tiles of a head adjacent.
// Returns the cudaError_t of the launch.
extern "C" int mx_flash_attention_dq_bf16(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* lse, const void* dout,
                                          const void* lengths, void* dq,
                                          int batch, int heads, int sq,
                                          int sk, int d, int width,
                                          float scale, int causal,
                                          void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > width) return cudaErrorInvalidValue;
  switch (width) {
#define X(W)                                                              \
  case W:                                                                 \
    return d == W ? launch<W, true>(q, k, v, o, lse, dout, lengths, dq,   \
                                    batch, heads, sq, sk, d, scale,       \
                                    causal, st)                           \
                  : launch<W, false>(q, k, v, o, lse, dout, lengths, dq,  \
                                     batch, heads, sq, sk, d, scale,      \
                                     causal, st);
    MX_BF16_WIDTHS(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block in bytes, query rows a work item and keys
// a tile of the instance at padded width `width` (0: not built), so the
// wrapper can hold its geometry (attention.py dq_bf16_geometry) to the
// kernel's layout.
#define MX_DQ_ENTRY(NAME, FIELD)    \
  extern "C" int NAME(int width) {  \
    switch (width) {                \
      case 16:                      \
        return Dq<16>::FIELD;       \
      case 32:                      \
        return Dq<32>::FIELD;       \
      case 64:                      \
        return Dq<64>::FIELD;       \
      case 128:                     \
        return Dq<128>::FIELD;      \
      default:                      \
        return 0;                   \
    }                               \
  }
MX_DQ_ENTRY(mx_flash_attention_dq_bf16_smem, SMEM_BYTES)
MX_DQ_ENTRY(mx_flash_attention_dq_bf16_block_q, BQ)
MX_DQ_ENTRY(mx_flash_attention_dq_bf16_block_k, BK)
