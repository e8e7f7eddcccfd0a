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
// Design. One block of 8 warps a work item (batch*head, 128-query tile),
// the query tiles of a head adjacent, two blocks an SM (96 KB of shared
// memory, at most 128 registers a thread), so no sum crosses blocks: no
// atomics, deterministic results. Warp w owns query rows 16w .. 16w + 15
// and keeps S, P, dP, dS and dQ in mma fragments:
//   * Q and dO are staged once as raw bf16 by 16-byte cp.async into
//     swizzled tiles (mma_bf16.cuh); the block walks 128-key tiles of K
//     and V (one at S 128), double-buffered: the next tile's copies are
//     issued before this one is computed. Rows past Sq or Sk are
//     zero-filled by the copy;
//   * each lane holds its two rows' lse (-inf past Sq) and delta =
//     rowsum(dO * O): O arrives by 16-byte loads into registers while the
//     first copies fly and is summed against the staged dO, 8 lanes a row
//     by shuffles; O is never staged;
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

constexpr int BQ = 128;  // query rows a work item
constexpr int BK = 128;  // keys a tile
constexpr int KS = 32;   // keys a step
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int QTILE = BQ * ROW_BYTES;
constexpr int KTILE = BK * ROW_BYTES;
// shared memory: the Q and dO tiles, then K and V of buffer 0, K and V of
// buffer 1
constexpr int SMEM_BYTES = 2 * QTILE + 2 * 2 * KTILE;
static_assert(BK % KS == 0 && KS % 16 == 0, "whole steps of k-steps");
static_assert(16 * CHUNKS == 4 * 32, "four chunks of O a lane");

// tile offsets in bytes
constexpr int Q_AT = 0;
constexpr int DO_AT = QTILE;
constexpr int KV_AT = 2 * QTILE;  // buffer b: K at + b * 2 KTILE, V + KTILE

// 16 bytes of data read once: the read-only path, no L1 line
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  uint4 w;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
      : "l"(p));
  return w;
}

__global__ void __launch_bounds__(THREADS, 2)
flash_attention_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ o,
                               const float* __restrict__ lse,
                               const __nv_bfloat16* __restrict__ dout,
                               const int* __restrict__ lengths,
                               __nv_bfloat16* __restrict__ dq, int heads,
                               int sq, int sk, float scale, int causal) {
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
  const size_t qoff = (size_t)bh * sq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * sk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * sk * D;

  const int len = max(0, min(lengths[bh / heads], sk));
  int kend = len;  // one past the last key any row of the item sees
  if (causal) kend = min(kend, min(q0 + BQ, sq));
  const int ntiles = (kend + BK - 1) / BK;
  const float scale2 = scale * LOG2E;
  const int r0 = q0 + 16 * w + g;  // the lane's rows r0 and r0 + 8

  float acc[8][4];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  // the lane's O chunks: chunk 32 i + lane of the warp's 16 rows x 8, so
  // row 4 i + lane / 8 (of the warp's), chunk lane % 8; zeros past Sq
  uint4 ov[4];
  // lse log2 e (-inf past Sq) and delta of the lane's rows r0, r0 + 8
  float lse2[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float delta[2] = {0.f, 0.f};
  if (ntiles > 0) {
    stage_rows<BQ, THREADS>(base + Q_AT, q + qoff, q0, sq, t);
    stage_rows<BQ, THREADS>(base + DO_AT, dout + qoff, q0, sq, t);
    stage_rows<BK, THREADS>(base + KV_AT, kb, 0, sk, t);
    stage_rows<BK, THREADS>(base + KV_AT + KTILE, vb, 0, sk, t);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 16 * w + 4 * i + (lane >> 3);
      ov[i] = qi < sq ? load16(o + qoff + (size_t)qi * D + 8 * (lane & 7))
                      : make_uint4(0u, 0u, 0u, 0u);
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
      stage_rows<BK, THREADS>(nt, kb, kbase + BK, sk, t);
      stage_rows<BK, THREADS>(nt + KTILE, vb, kbase + BK, sk, t);
      cp_async_commit();
    }
    if (j == 0) {
      // delta: each lane sums its 4 chunks of dO * O, the 8 lanes of a row
      // add theirs by shuffles; row u of the warp's 16 then lies in
      // part[u / 4] of lanes 8 (u % 4) .. + 7
      float part[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x[8], y[8];
        mx_bf16::widen8(ov[i], x);
        mx_bf16::widen8(*reinterpret_cast<const uint4*>(
                            smem + DO_AT +
                            off(16 * w + 4 * i + (lane >> 3), lane & 7)),
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
        const float lo = __shfl_sync(0xffffffffu, part[2 * h], 8 * (g & 3));
        const float hi =
            __shfl_sync(0xffffffffu, part[2 * h + 1], 8 * (g & 3));
        delta[h] = (g >> 2) ? hi : lo;
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
      product_nt(s, base + Q_AT, ks, 16 * w, lane);         // S = Q K^T
      product_nt(dp, base + DO_AT, vt + h * KS * ROW_BYTES,  // dP = dO V^T
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
      product_pv<KS / 16>(acc, dp, ks, lane);  // dQ += dS K
    }
  }
  // the warp's Q rows are its own and read: they take its dQ rows
  const float one[2] = {1.f, 1.f};
  store_rows(acc, one, smem + Q_AT, 16 * w, dq + qoff, q0 + 16 * w, sq,
             lane);
}

}  // namespace

// ---- host entry points ----
// q, o, do, dq (B*H, Sq, D) and k, v (B*H, Sk, D) bf16; lse (B*H, Sq)
// float32; lengths (B,) int32. All contiguous on the device, 16-byte
// aligned. One block a (batch*head, 128-query tile), the tiles of a head
// adjacent. Returns the cudaError_t of the launch.
extern "C" int mx_flash_attention_dq_bf16(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* lse, const void* dout,
                                          const void* lengths, void* dq,
                                          int batch, int heads, int sq,
                                          int sk, int d, float scale,
                                          int causal, void* stream) {
  if (d != D) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_dq_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long items = (long long)batch * heads * ((sq + BQ - 1) / BQ);
  if (items == 0) return cudaSuccess;
  flash_attention_dq_bf16_kernel<<<(unsigned)items, THREADS, SMEM_BYTES,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(dq),
      heads, sq, sk, scale, causal);
  return cudaGetLastError();
}

// Dynamic shared memory a block in bytes, query rows a work item and keys
// a tile, so the wrapper can hold its geometry (attention.py
// dq_bf16_geometry) to the kernel's layout.
extern "C" int mx_flash_attention_dq_bf16_smem() { return SMEM_BYTES; }
extern "C" int mx_flash_attention_dq_bf16_block_q() { return BQ; }
extern "C" int mx_flash_attention_dq_bf16_block_k() { return BK; }
