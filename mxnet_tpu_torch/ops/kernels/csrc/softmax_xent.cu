// Fused softmax + cross-entropy head for Hopper (sm_90a), float32, and
// bf16 logits and dlogits: forward and backward.
//
// Replaces: mxnet_tpu_softmax_xent_fwd (mxnet_tpu/ops/pallas/xent.py:37)
// and mxnet_tpu_softmax_xent_bwd (xent.py:49), the loss head of every
// training step with SoftmaxCrossEntropyLoss (BERT's MLM head at V 30522,
// its NSP head at V 2, ResNet's at V 1000).
//
//   forward   m = max_c x_c;  z = sum_c exp(x_c - m)
//             logp_c = (x_c - m) - log z
//             nll = -logp[label], or 0 when label is outside [0, V)
//             (the TPU kernel's iota compare matches no class then)
//   backward  dx_c = g * (exp(logp_c) - [c == label])
//
// What bounds them on the H100: bytes. Per element the forward does a
// handful of flops against 4 bytes read and 4 written (logp is the saved
// residual, as xent.py:97 saves it), the backward reads logp and writes
// dx: at the MLM shape (1920 x 30522) each moves 2 x 234 MB, 0.14 ms at
// 3.35 TB/s.
//
// Forward design: the row is read from device memory once. Three
// instances, picked by xent.py xent_geometry from V (the INSTANCES table
// below; xent.py mirrors it):
//   * WARP_ROW (V <= WARP_V): one warp a row, the row in registers (32
//     values a lane, coalesced scalar loads), max and exp-sum by warp
//     butterflies; the NSP and ResNet heads;
//   * CLUSTER_ROW: a thread-block cluster of C <= 8 CTAs owns a row, CTA
//     k the columns [k chunk, (k + 1) chunk). Each CTA copies its chunk
//     into shared memory once: the 16-byte-aligned middle by one bulk
//     copy (cp.async.bulk, TMA 1-D) completing on an mbarrier, the at
//     most 3 + 3 unaligned head and tail elements by scalar loads (a row
//     of odd V, or of V = 2 mod 4, starts off a 16-byte boundary, and
//     neither the copy nor a 16-byte access may cross the row's ends).
//     The buffer keeps the global address's alignment (column c at
//     position c - c0 + h0, h0 = the chunk's start mod 4), so its float4
//     slots map onto aligned float4s of x and of logp; positions outside
//     the chunk hold -inf, so the reductions run branch-free over whole
//     slots with four independent chains a thread. Each CTA reduces its
//     (max, exp-sum) from shared memory, the CTAs exchange them through
//     distributed shared memory (mapa / ld.shared::cluster) after a
//     cluster barrier, and every CTA merges the C partials in rank order:
//     the same operations on the same values, so all CTAs of a row hold a
//     bitwise identical max and log z. Then each CTA writes its logp from
//     shared memory in 16-byte stores (scalar at the two ends); the CTA
//     holding the label's column writes nll. A CTA arrives on a second
//     cluster barrier once its partials have been read and waits on it
//     before it exits, so no CTA's shared memory goes while a peer reads.
//     C is the fewest CTAs whose chunk is at most CHUNK_TARGET floats
//     (64 KB: three CTAs an SM, so one row's stores overlap other rows'
//     loads); V 30522 takes 2, which measured faster on the H100 than
//     1, 4 or 8 (chip_smoke.py times each size);
//   * TWO_PASS (V past what 8 CTAs hold, 8 x MAX_CHUNK): one block of 256
//     threads a row, reading the row twice (a running max / exp-sum, then
//     logp): the first form of this kernel, kept for such widths.
// Every output element is written by one thread: no atomics.
//
// bf16 logits (net.cast('bfloat16'); the reference kernel widens them,
// xent.py:37-47): every instance is a template over the logits' type T.
// A logit widens to float exactly as it is loaded, and everything after
// is the float32 instance's arithmetic, so nll and logp (float32, as the
// reference writes them) are bitwise the float32 kernel's on the widened
// logits. A bulk copy cannot widen, so the cluster instance's bf16 chunk
// lands raw in a bf16 staging region in the float buffer's place: its
// 16-byte-aligned middle by one bulk copy on the same mbarrier, the at
// most 7 + 7 unaligned head and tail elements by scalar loads (Staged
// below). Every pass then reads a float4 slot of the float32 instance's
// buffer as 8 bytes of the staging region, widened (exact), so the
// reductions and stores see the same values in the same order: 2 (chunk +
// 8) bytes of shared memory a CTA, not 4 (chunk + 4), so more CTAs an SM.
// Its geometry is the float32 instance's (the same cluster sizes and
// chunks): at V 30522 two CTAs a row measured fastest for bf16 logits too
// (chip_smoke.py times each size), and one geometry keeps the two
// instances' bits equal at every V.
//
// Backward design: no element needs another, so the (rows, V) tensor is
// one flat stream of n = rows x V elements (csrc/stream.cuh, as the
// epilogue kernels: one float4 of logp a thread, one block a tile, dx
// stored evict-first from the L2's size on, the partition from
// epilogue.py epilogue_geometry). Rows of V = 2 mod 4 or odd V start off
// a 16-byte boundary; the stream does not care, since a vector may span
// rows. A vector finds the row and column of its first element by one
// multiply-high division by V (the host's fast_divisor), and each further
// element steps from the one before: column V wraps to column 0 of the
// next row, more than once in a vector where V < 4. g[row] and
// label[row] are read through the read-only path, with an L1 line (all
// the vectors of a row read the same one). Each element is
// g * (expf(logp) - [col == label]), the expression of the block-a-row
// kernel this replaces, so the result is bitwise the same.
//
// The stream indexes in 32 bits. A tensor of more than INT32_MAX
// elements is launched in chunks of whole rows (xent.py
// xent_bwd_geometry), each from a 16-byte-aligned element: a chunk whose
// first row starts off the boundary begins `lead` (< 4, < V) elements
// earlier, with the end of the row before, which the chunk before it
// leaves out. labels and g then point at that row.
//
// bf16 dlogits (xent.py:118-124 writes dx in the logits' dtype): the
// stream at 8 elements a vector (two float4 loads of logp, one 16-byte
// store of 8 bf16), each element the float32 expression rounded once to
// nearest even, so bitwise the float32 kernel's result, rounded. Its
// chunks start on 8-element (16-byte) boundaries, lead < 8.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "stream.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// ---- the forward's instances (xent.py XENT_INSTANCES mirrors this) ----
enum Instance { WARP_ROW = 0, CLUSTER_ROW = 1, TWO_PASS = 2 };
constexpr int WARP_V = 1024;              // widest row a warp holds
constexpr int PER_LANE = WARP_V / 32;     // values a lane
constexpr int CLUSTER_MAX = 8;            // portable cluster size
constexpr int HEADER = 128;               // mbarrier, partials, scratch
constexpr int SMEM_MAX = 232448;          // a block's shared memory
// columns of a CTA's chunk: a multiple of 4, buffer of chunk + 4 floats
// (bf16 logits take the same chunks)
constexpr int MAX_CHUNK = ((SMEM_MAX - HEADER) / 4 - 4) & ~3;
constexpr int CHUNK_TARGET = 16384;

struct InstanceInfo {
  int instance, threads, most_cluster, most_chunk;
};
constexpr InstanceInfo INSTANCES[] = {
    {WARP_ROW, THREADS, 1, WARP_V},
    {CLUSTER_ROW, THREADS, CLUSTER_MAX, MAX_CHUNK},
    {TWO_PASS, THREADS, 1, 0},
};

// the cluster instance's dynamic shared memory at `chunk` columns a CTA
// over logits of `itemsize` bytes: the float buffer, or for bf16 its
// staging region (chunk + 8 bf16) in its place
__host__ __device__ constexpr int cluster_smem_bytes(int chunk,
                                                     int itemsize) {
  return HEADER + (itemsize == 2 ? 2 * (chunk + 8) : 4 * (chunk + 4));
}

// a logit as float: bf16 widens exactly (the top half of a float)
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one logit read through the read-only path, as float
__device__ __forceinline__ float ldg_logit(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_logit(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// merge (m2, z2) into (m, z): z sums exp(x - m) over its elements
__device__ __forceinline__ void merge(float& m, float& z, float m2,
                                      float z2) {
  const float mn = fmaxf(m, m2);
  if (mn == -CUDART_INF_F) return;  // both empty
  z = z * expf(m - mn) + z2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// every lane ends with the same bits: each step adds the same two values
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// ---- WARP_ROW ----
template <class T>
__global__ void __launch_bounds__(THREADS)
softmax_xent_fwd_warp_kernel(const T* __restrict__ x,
                             const int* __restrict__ labels,
                             float* __restrict__ nll,
                             float* __restrict__ logp,
                             int rows, int v) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const T* xr = x + (size_t)r * v;
  float e[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int c = lane + 32 * i;
    e[i] = c < v ? ldg_logit(xr + c) : -CUDART_INF_F;
  }
  float mc[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                 -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) mc[i & 3] = fmaxf(mc[i & 3], e[i]);
  const float m = warp_max(fmaxf(fmaxf(mc[0], mc[1]), fmaxf(mc[2], mc[3])));
  const float shift = m == -CUDART_INF_F ? 0.f : m;
  float zc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) zc[i & 3] += expf(e[i] - shift);
  const float logz = logf(warp_sum((zc[0] + zc[1]) + (zc[2] + zc[3])));
  const int lab = labels[r];
  float* lr = logp + (size_t)r * v;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int c = lane + 32 * i;
    if (c < v) {
      const float lp = (e[i] - m) - logz;
      lr[c] = lp;
      if (c == lab) nll[r] = -lp;
    }
  }
  if (lane == 0 && !(lab >= 0 && lab < v)) nll[r] = 0.f;
}

// ---- CLUSTER_ROW ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the float at shared address `local` in the CTA of cluster rank `rank`
__device__ __forceinline__ float ld_peer(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte-aligned global `src` to shared
// `dst`, reported to the mbarrier as transaction bytes; the logits are
// read once, so they leave L2 first
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 policy;\n"
      "createpolicy.fractional.L2::evict_first.b64 policy, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], policy;\n}\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A CTA's share of a row: columns [c0, c0 + len) at buffer positions
// [h0, h0 + len); the bulk copy takes positions [lo, lo + body) (lo a
// multiple of 4), the threads the rest of the nq float4 slots
// (tests/test_torch_xent.py runs this arithmetic in Python).
struct Chunk {
  int c0, len, h0, lo, body, nq;
};

__device__ __forceinline__ Chunk chunk_of(size_t row_start, int v, int chunk,
                                          int rank) {
  Chunk k;
  k.c0 = rank * chunk;
  k.len = max(0, min(v, k.c0 + chunk) - k.c0);
  k.h0 = (int)((row_start + k.c0) & 3);
  const int head = min(k.len, (4 - k.h0) & 3);
  k.lo = k.h0 + head;
  k.body = (k.len - head) & ~3;
  k.nq = (k.h0 + k.len + 3) >> 2;
  return k;
}

// bf16 logits: the CTA's columns sit at staging indices [h8, h8 + len) of
// a bf16 region (h8 = the chunk's start mod 8), so staging index 0 is
// 16-byte aligned in x and in shared memory; the bulk copy takes indices
// [lo, lo + body) (lo a multiple of 8), the threads the at most 7 + 7
// before and after. h8 - h0 is 0 or 4, so buffer slot i (positions 4i ..
// 4i + 3) holds staging indices 4 (i + off4) .. + 3 (tests/test_torch_
// xent.py runs this arithmetic in Python).
struct Staged {
  int h8, lo, body, off4;
};

__device__ __forceinline__ Staged staged_of(size_t row_start,
                                            const Chunk& k) {
  Staged s;
  s.h8 = (int)((row_start + k.c0) & 7);
  const int head = min(k.len, (8 - s.h8) & 7);
  s.lo = s.h8 + head;
  s.body = (k.len - head) & ~7;
  s.off4 = (s.h8 - k.h0) >> 2;
  return s;
}

// buffer slot i from the staging region, widened (exact); positions
// outside the chunk are -inf
__device__ __forceinline__ float4 widen_slot(const unsigned short* stage,
                                             const Staged& sg,
                                             const Chunk& k, int i) {
  const uint2 u = reinterpret_cast<const uint2*>(stage)[i + sg.off4];
  float e[4] = {__uint_as_float(u.x << 16),
                __uint_as_float(u.x & 0xffff0000u),
                __uint_as_float(u.y << 16),
                __uint_as_float(u.y & 0xffff0000u)};
  const int p = 4 * i;
  if (!(p >= k.h0 && p + 3 < k.h0 + k.len)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!(p + j >= k.h0 && p + j < k.h0 + k.len)) e[j] = -CUDART_INF_F;
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
softmax_xent_fwd_cluster_kernel(const T* __restrict__ x,
                                const int* __restrict__ labels,
                                float* __restrict__ nll,
                                float* __restrict__ logp,
                                int v, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* part = reinterpret_cast<float*>(smem + 8);    // this CTA's m, z
  float* red_m = reinterpret_cast<float*>(smem + 16);  // [WARPS]
  float* red_z = reinterpret_cast<float*>(smem + 48);  // [WARPS]
  float* stat = reinterpret_cast<float*>(smem + 80);   // the row's m, log z
  float* buf = reinterpret_cast<float*>(smem + HEADER);

  const uint32_t rank = cluster_rank();
  const uint32_t csize = cluster_size();
  const int r = blockIdx.x / csize;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const size_t row_start = (size_t)r * v;
  const Chunk k = chunk_of(row_start, v, chunk, rank);
  const uint32_t bar_a = smem_u32(bar);
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // bf16 rows: raw bf16 in place of the float buffer (chunk + 8 of them)
  unsigned short* stage = reinterpret_cast<unsigned short*>(smem + HEADER);
  const Staged sg = staged_of(row_start, k);
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  // buffer slot i as the float32 instance holds it; bf16 widens it from
  // the staging region wherever it is read
  auto slot = [&](int i) {
    if constexpr (BF16)
      return widen_slot(stage, sg, k, i);
    else
      return b4[i];
  };
  // buffer position p (inside the chunk) likewise
  auto slot_at = [&](int p) {
    if constexpr (BF16)
      return __uint_as_float((uint32_t)stage[p + 4 * sg.off4] << 16);
    else
      return buf[p];
  };

  if (t == 0) mbar_init(bar_a, 1);
  __syncthreads();
  if constexpr (!BF16) {
    const T* xc = x + row_start + k.c0 - k.h0;  // buffer position 0
    if (t == 0) {
      if (k.body > 0) {
        mbar_expect_tx(bar_a, 4 * k.body);
        bulk_load(smem_u32(buf + k.lo), xc + k.lo, 4 * k.body, bar_a);
      } else {
        mbar_arrive(bar_a);
      }
    }
    // the slots' other positions: head (below lo, at most 4) by threads
    // 0-3, tail and pad (from lo + body, at most 6) by threads 4-11
    if (t < 12) {
      const int p = t < 4 ? t : k.lo + k.body + (t - 4);
      if ((t < 4 ? p < k.lo : p < 4 * k.nq)) {
        const bool in = p >= k.h0 && p < k.h0 + k.len;
        buf[p] = in ? widen(xc[p]) : -CUDART_INF_F;
      }
    }
  } else {
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(
        x + row_start + k.c0 - sg.h8);  // staging index 0
    if (t == 0) {
      if (sg.body > 0) {
        mbar_expect_tx(bar_a, 2 * sg.body);
        bulk_load(smem_u32(stage + sg.lo), xs + sg.lo, 2 * sg.body, bar_a);
      } else {
        mbar_arrive(bar_a);
      }
    }
    // the head (below lo, at most 7) by threads 0-7, the tail (from lo +
    // body, at most 7) by threads 8-15, raw
    if (t < 16) {
      const int p = t < 8 ? sg.h8 + t : sg.lo + sg.body + (t - 8);
      if (t < 8 ? p < sg.lo : p < sg.h8 + k.len) stage[p] = __ldg(xs + p);
    }
  }
  mbar_wait(bar_a, 0);
  __syncthreads();

  // the CTA's (max, exp-sum) over its slots, four chains a thread
  float mc[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                 -CUDART_INF_F};
#pragma unroll 4
  for (int i = t; i < k.nq; i += THREADS) {
    const float4 a = slot(i);
    mc[0] = fmaxf(mc[0], a.x);
    mc[1] = fmaxf(mc[1], a.y);
    mc[2] = fmaxf(mc[2], a.z);
    mc[3] = fmaxf(mc[3], a.w);
  }
  float m = warp_max(fmaxf(fmaxf(mc[0], mc[1]), fmaxf(mc[2], mc[3])));
  if (lane == 0) red_m[w] = m;
  __syncthreads();
  m = red_m[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) m = fmaxf(m, red_m[i]);
  const float shift = m == -CUDART_INF_F ? 0.f : m;
  float zc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int i = t; i < k.nq; i += THREADS) {
    const float4 a = slot(i);
    zc[0] += expf(a.x - shift);
    zc[1] += expf(a.y - shift);
    zc[2] += expf(a.z - shift);
    zc[3] += expf(a.w - shift);
  }
  const float z = warp_sum((zc[0] + zc[1]) + (zc[2] + zc[3]));
  if (lane == 0) red_z[w] = z;
  __syncthreads();
  if (t == 0) {
    float zs = red_z[0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) zs += red_z[i];
    part[0] = m;
    part[1] = zs;
  }
  cluster_arrive();  // the partials are written
  cluster_wait();
  if (t == 0) {
    // every CTA of the row merges the same partials in rank order
    const uint32_t pm = smem_u32(part), pz = smem_u32(part + 1);
    float gm = -CUDART_INF_F, gz = 0.f;
    for (uint32_t i = 0; i < csize; ++i)
      merge(gm, gz, ld_peer(pm, i), ld_peer(pz, i));
    stat[0] = gm;
    stat[1] = logf(gz);
  }
  __syncthreads();
  cluster_arrive();  // the peers' partials are read; wait before exit
  const float gm = stat[0];
  const float logz = stat[1];

  // logp from shared memory: whole slots as aligned float4s, the two end
  // slots element by element
  float* lc = logp + row_start + k.c0 - k.h0;
#pragma unroll 4
  for (int i = t; i < k.nq; i += THREADS) {
    const float4 a = slot(i);
    const int p = 4 * i;
    float4 o;
    o.x = (a.x - gm) - logz;
    o.y = (a.y - gm) - logz;
    o.z = (a.z - gm) - logz;
    o.w = (a.w - gm) - logz;
    if (p >= k.h0 && p + 3 < k.h0 + k.len) {  // streaming: read much later
      __stcs(reinterpret_cast<float4*>(lc + p), o);
    } else {
      const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p + e >= k.h0 && p + e < k.h0 + k.len) lc[p + e] = ov[e];
    }
  }
  if (t == 0) {
    const int lab = labels[r];
    if (lab >= k.c0 && lab < k.c0 + k.len)
      nll[r] = -((slot_at(lab - k.c0 + k.h0) - gm) - logz);
    else if (rank == 0 && !(lab >= 0 && lab < v))
      nll[r] = 0.f;
  }
  cluster_wait();
}

// ---- TWO_PASS ----
template <class T>
__global__ void __launch_bounds__(THREADS)
softmax_xent_fwd_two_pass_kernel(const T* __restrict__ x,
                                 const int* __restrict__ labels,
                                 float* __restrict__ nll,
                                 float* __restrict__ logp,
                                 int v) {
  __shared__ float wm[WARPS], wz[WARPS];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const T* xr = x + (size_t)r * v;
  float* lr = logp + (size_t)r * v;

  float m = -CUDART_INF_F, z = 0.f;
  for (int c = t; c < v; c += THREADS) {
    const float xv = widen(xr[c]);
    if (xv > m) {
      z = z * expf(m - xv) + 1.f;  // exp(-inf) == 0 on the first element
      m = xv;
    } else {
      z += expf(xv - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, z, __shfl_xor_sync(FULL, m, off), __shfl_xor_sync(FULL, z, off));
  if ((t & 31) == 0) {
    wm[t >> 5] = m;
    wz[t >> 5] = z;
  }
  __syncthreads();
  m = wm[0];
  z = wz[0];
  for (int w = 1; w < WARPS; ++w) merge(m, z, wm[w], wz[w]);
  const float logz = logf(z);

  const int lab = labels[r];
  const bool hit = lab >= 0 && lab < v;
  for (int c = t; c < v; c += THREADS) {
    const float lp = (widen(xr[c]) - m) - logz;
    lr[c] = lp;
    if (c == lab) nll[r] = -lp;
  }
  if (!hit && t == 0) nll[r] = 0.f;
}

// ---- backward ----
using mx_stream::Divisor;
using mx_stream::Idx;

// elements of dx a 16-byte vector: 4 floats, 8 bf16
template <class T>
__host__ __device__ constexpr int vec_of() {
  return std::is_same<T, float>::value ? mx_stream::VEC : mx_stream::VEC_BF16;
}

// The backward's stream over a chunk of n elements, dx of type T (float
// or bf16): element i lies in row `row` (of labels and g) at column
// `col`; the first `lead` elements end the row before the chunk's first
// whole row.
template <bool EVICT, class T>
struct XentBwd {
  static constexpr int V = vec_of<T>();
  const float* logp;
  const int* labels;
  const float* g;
  T* dx;
  Divisor v;
  Idx lead;
  struct In {
    float a[V];
    Idx row, col;
  };
  __device__ __forceinline__ Idx at(Idx i, Idx& col) const {
    if (i < lead) {
      col = v.d - lead + i;
      return 0;
    }
    const Idx t = i - lead;
    const Idx q = v.div(t);
    col = t - q * v.d;
    return q + (lead != 0);
  }
  // (row, col) of element i + 1 from those of element i
  __device__ __forceinline__ void step(Idx& row, Idx& col) const {
    if (++col == v.d) {
      col = 0;
      ++row;
    }
  }
  __device__ __forceinline__ float one(float lp, Idx row, Idx col) const {
    const float gr = __ldg(g + row);
    const int lab = __ldg(labels + row);
    return gr * (expf(lp) - ((int)col == lab ? 1.f : 0.f));
  }
  __device__ __forceinline__ In load(Idx i) const {
    In x;
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      const float4 f = mx_stream::load4(logp + i + q);
      x.a[q] = f.x;
      x.a[q + 1] = f.y;
      x.a[q + 2] = f.z;
      x.a[q + 3] = f.w;
    }
    x.row = at(i, x.col);
    return x;
  }
  __device__ __forceinline__ void store(Idx i, const In& x) const {
    float d[V];
    Idx row = x.row, col = x.col;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e) step(row, col);
      d[e] = one(x.a[e], row, col);
    }
    if constexpr (std::is_same<T, float>::value)
      mx_stream::store4<EVICT>(dx + i, make_float4(d[0], d[1], d[2], d[3]));
    else
      mx_stream::store8<EVICT>(dx + i, d);
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    Idx col;
    const Idx row = at(i, col);
    const float d = one(logp[i], row, col);
    if constexpr (std::is_same<T, float>::value)
      dx[i] = d;
    else
      dx[i] = __float2bfloat16_rn(d);
  }
};

template <bool EVICT, class T>
__global__ void __launch_bounds__(mx_stream::THREADS)
softmax_xent_bwd_kernel(const float* __restrict__ logp,
                        const int* __restrict__ labels,
                        const float* __restrict__ g, T* __restrict__ dx,
                        Idx n, Idx tiles, Divisor v, Idx lead) {
  mx_stream::stream<vec_of<T>()>(
      XentBwd<EVICT, T>{logp, labels, g, dx, v, lead}, n, tiles);
}

template <class T>
cudaError_t launch_cluster(const T* x, const int* labels, float* nll,
                           float* logp, int rows, int v, int cluster,
                           int chunk, cudaStream_t stream) {
  // the shared-memory attribute once per device and instance
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(softmax_xent_fwd_cluster_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cluster_smem_bytes(MAX_CHUNK, (int)sizeof(T)));
    if (err != cudaSuccess) return err;
    // the whole carveout as shared memory, so small chunks stack up to
    // seven CTAs an SM
    err = cudaFuncSetAttribute(softmax_xent_fwd_cluster_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * (unsigned)cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = cluster_smem_bytes(chunk, (int)sizeof(T));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, softmax_xent_fwd_cluster_kernel<T>, x,
                           labels, nll, logp, v, chunk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the forward on logits of type T, by the instance the caller picked
template <class T>
int forward(const void* logits, const void* labels, void* nll, void* logp,
            int rows, int v, int instance, int cluster, int chunk,
            void* stream) {
  const auto* x = static_cast<const T*>(logits);
  const auto* lab = static_cast<const int*>(labels);
  auto* n = static_cast<float*>(nll);
  auto* lp = static_cast<float*>(logp);
  auto st = static_cast<cudaStream_t>(stream);
  if (rows < 0 || v < 0 || instance < WARP_ROW || instance > TWO_PASS ||
      cluster < 1 || cluster > INSTANCES[instance].most_cluster)
    return cudaErrorInvalidValue;
  switch (instance) {
    case WARP_ROW:
      if (v > INSTANCES[WARP_ROW].most_chunk) return cudaErrorInvalidValue;
      if (rows == 0 || v == 0) return cudaSuccess;
      softmax_xent_fwd_warp_kernel<T>
          <<<(rows + WARPS - 1) / WARPS, THREADS, 0, st>>>(x, lab, n, lp,
                                                           rows, v);
      return cudaGetLastError();
    case CLUSTER_ROW:
      // every CTA of the cluster holds at least one column
      if (chunk % 4 != 0 || chunk < 4 ||
          chunk > INSTANCES[CLUSTER_ROW].most_chunk ||
          (long long)chunk * cluster < v ||
          (long long)chunk * (cluster - 1) >= v)
        return cudaErrorInvalidValue;
      if (rows == 0) return cudaSuccess;
      return launch_cluster<T>(x, lab, n, lp, rows, v, cluster, chunk, st);
    default:  // TWO_PASS
      if (rows == 0 || v == 0) return cudaSuccess;
      softmax_xent_fwd_two_pass_kernel<T><<<rows, THREADS, 0, st>>>(
          x, lab, n, lp, v);
      return cudaGetLastError();
  }
}

// the backward over one chunk with dx of type T
template <class T>
int backward(const void* logp, const void* labels, const void* g, void* dx,
             long long n, long long v, unsigned v_mul, int v_shift,
             long long lead, int evict, long long tiles, void* stream) {
  constexpr int V = vec_of<T>();
  if (n == 0) return cudaSuccess;
  Divisor vd;
  if (n < 0 || n > INT32_MAX || !mx_stream::divisor(v, v_mul, v_shift, vd) ||
      lead < 0 || lead >= V || lead >= v || lead > n)
    return cudaErrorInvalidValue;
  const unsigned grid = mx_stream::stream_grid<V>(n, tiles);
  if (grid == 0) return cudaErrorInvalidValue;
  const auto* lp = static_cast<const float*>(logp);
  const auto* lab = static_cast<const int*>(labels);
  const auto* gp = static_cast<const float*>(g);
  auto* dp = static_cast<T*>(dx);
  auto st = static_cast<cudaStream_t>(stream);
  if (evict)
    softmax_xent_bwd_kernel<true, T><<<grid, mx_stream::THREADS, 0, st>>>(
        lp, lab, gp, dp, (Idx)n, (Idx)tiles, vd, (Idx)lead);
  else
    softmax_xent_bwd_kernel<false, T><<<grid, mx_stream::THREADS, 0, st>>>(
        lp, lab, gp, dp, (Idx)n, (Idx)tiles, vd, (Idx)lead);
  return cudaGetLastError();
}

}  // namespace

// ---- host entry points ----
// logits / logp / dx (rows, V), labels (rows,) int32, nll / g (rows,);
// all contiguous on the device, float32 unless stated. Each returns the
// cudaError_t of its launch. The forward's instance, cluster and chunk
// come from xent.py xent_geometry; a combination the instance does not
// take is refused (cudaErrorInvalidValue).
extern "C" int mx_softmax_xent_fwd(const void* logits, const void* labels,
                                   void* nll, void* logp, int rows, int v,
                                   int instance, int cluster, int chunk,
                                   void* stream) {
  return forward<float>(logits, labels, nll, logp, rows, v, instance,
                        cluster, chunk, stream);
}

// The same over bf16 logits; nll and logp float32.
extern "C" int mx_softmax_xent_fwd_bf16(const void* logits,
                                        const void* labels, void* nll,
                                        void* logp, int rows, int v,
                                        int instance, int cluster, int chunk,
                                        void* stream) {
  return forward<__nv_bfloat16>(logits, labels, nll, logp, rows, v, instance,
                                cluster, chunk, stream);
}

// Dynamic shared memory of the forward's instance at `chunk` columns a CTA
// over logits of `itemsize` bytes (4: float32, 2: bf16) in bytes (-1: no
// such instance), so the wrapper can hold xent_geometry to the kernel's
// layout.
extern "C" int mx_softmax_xent_fwd_smem(int instance, int chunk,
                                        int itemsize) {
  if (itemsize != 4 && itemsize != 2) return -1;
  switch (instance) {
    case WARP_ROW:
    case TWO_PASS:
      return 0;
    case CLUSTER_ROW:
      return chunk >= 0 && chunk <= MAX_CHUNK
                 ? cluster_smem_bytes(chunk, itemsize)
                 : -1;
    default:
      return -1;
  }
}

// The backward over one chunk (xent.py xent_bwd_geometry): n elements
// of logp / dx from a 16-byte-aligned element, labels / g from the row of
// its first element; v with its divisor (v_mul, v_shift); lead (< 4, <
// v) elements of that row before the first whole row; evict and tiles
// of the chunk's stream partition (epilogue.py epilogue_geometry). A
// combination the stream does not take is refused.
extern "C" int mx_softmax_xent_bwd(const void* logp, const void* labels,
                                   const void* g, void* dx, long long n,
                                   long long v, unsigned v_mul, int v_shift,
                                   long long lead, int evict,
                                   long long tiles, void* stream) {
  return backward<float>(logp, labels, g, dx, n, v, v_mul, v_shift, lead,
                         evict, tiles, stream);
}

// The same writing bf16 dx: the chunk starts on an 8-element boundary,
// lead < 8, and evict and tiles are epilogue_geometry's at 2 bytes an
// element.
extern "C" int mx_softmax_xent_bwd_bf16(const void* logp, const void* labels,
                                        const void* g, void* dx, long long n,
                                        long long v, unsigned v_mul,
                                        int v_shift, long long lead,
                                        int evict, long long tiles,
                                        void* stream) {
  return backward<__nv_bfloat16>(logp, labels, g, dx, n, v, v_mul, v_shift,
                                 lead, evict, tiles, stream);
}
