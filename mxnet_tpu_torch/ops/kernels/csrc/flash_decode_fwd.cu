// Single-token flash-decode attention for Hopper (sm_90a), float32.
//
// Replaces: mxnet_tpu_flash_decode_fwd (mxnet_tpu/ops/pallas/attention.py:423),
// the TPU kernel of every decode step of the slot-cache engine, and
// flash_paged_decode_attention (attention.py:508), which gathers each slot's
// pages through its page table and then runs that kernel. One body serves
// both, as two instances that differ only in where a tile's K and V rows are
// staged from (the row policies SlotRows and PagedRows below):
//   * slot cache (slots, max_len, U): row kp of slot s at (s * max_len + kp)
//     * U + h * D;
//   * page pool (pages, ps, U) with tables (slots, max_pages), ps a power of
//     two: row kp at (table[s][kp >> log2 ps] * ps + (kp & (ps - 1))) * U +
//     h * D. The 128 threads of a tile's keys look up their row's offset
//     once a tile, into shared memory, before the copies (a tile spans 128 /
//     ps pages below ps 128, lies in one page above); the view is max_pages
//     * ps keys, and a table entry outside the pool reads the trash page 0.
//     The offsets are in floats and 32 bits, so that each copy adds one to
//     its base and multiplies nothing.
// Each staged row is the same D floats in both layouts and a key past the
// slot's position gets weight exactly 0 whatever its row holds, so the
// paged instance is bitwise the slot instance over the same K/V: no gather
// of the view into device memory, which would move slots x view x U floats
// for K and again for V in every layer of every step.
//
// What bounds it on the H100: memory. Each (slot, head) reads the K and V
// rows of its live prefix once -- 2 * (position + 1) * D * 4 bytes -- and
// does 4 * D flops per key, about 0.5 flop per byte, far below the card's
// balance point. At 8 slots and a full 512-row cache that is 25 MB per
// layer; the live prefix is usually much less.
//
// The arithmetic is the walk of online_softmax.cuh, bit for bit: the key
// axis from 0 in K_BLOCK = 128-key tiles, tile j folded into (m, l, acc)
// by rescale / weight and a sequential fma chain over its keys. Only the
// fold of l and acc is ordered; everything before it depends on the
// earlier tiles through the running max alone, and a max is exact in any
// order. So the tiles run in parallel and only the fold is a chain:
//   * grid (C, slots, heads), C = min(8, ceil(max_len / 128)): the C CTAs
//     of a (slot, head) form a thread-block cluster, and CTA r owns tiles
//     r, r + C, r + 2C, ..., one a round (max_len 512: C 4, 384 CTAs of
//     256 threads at 8 slots x 12 heads). A round's shared memory holds
//     one tile, so every max_len runs; a CTA whose tile lies past the
//     slot's position loads nothing but still arrives at every cluster
//     barrier. Where the slot's visible keys fit in one tile, no CTA
//     touches another's shared memory: the cluster skips its barriers
//     and the CTAs with no tile leave at once;
//   * parallel part, per CTA: all 256 threads stage the K and V tile by
//     cp.async with every copy in flight at once and no register staged
//     (3 CTAs an SM at DP 64; the cache read in place in its (slots, max_len, U)
//     layout, K rows padded to DP + 1 floats so that thread j reading key
//     row j has no bank conflicts; V is waited for only before the
//     weights are written, so it lands while the keys are scored);
//     thread j < 128 scores key j with mx::tile_score; the tile max goes
//     through warp shuffles; a cluster barrier; then the CTA reads the
//     maxima of the earlier tiles of its round over distributed shared
//     memory (mapa), folds them into the round's carried max with fmaxf
//     (exact in any order, so this is the walk's running max m_{j-1}),
//     and calls mx::rescale(m_{j-1}, tmax_j) and mx::weight as the walk
//     does: its safe_m, corr and weights are the walk's bits; the psum
//     thread sums the weights in key order (psum);
//   * ordered part, the only chain: l_j = fma(l_{j-1}, corr_j, psum_j) and
//     acc_j = fma chain over tile j's keys from acc_{j-1} * corr_j, tile
//     after tile. Each CTA folds its own tile from its own shared memory
//     and hands its DP accumulators and l to the CTA of the next tile by
//     st.async into that CTA's shared memory (16 bytes a store), each
//     store completing its bytes on that CTA's mbarrier, which expects
//     DP + 1 floats a phase and which its threads wait on. (Rank 0 folding
//     every tile from its peers' shared memory after a second cluster
//     barrier gives the same bits and was slower on the H100.)
//     The CTA of the last tile writes out = mx::finish_out(acc, l) once.
//     A cluster barrier ends each round, so no CTA reuses or releases
//     shared memory that a peer still writes. A slot with no visible key
//     (position < 0, or max_len 0) writes finish_out(0, 0) from rank 0.
//
// Head dims. Every D from 1 to 128 runs, through instances built at the
// forward kernel's padded widths DP = 16, 32, 64 and 128 (the smallest
// DP >= D): the D real columns of q, K and V are staged and columns D ..
// DP - 1 are zero-filled by the copy, so tile_score is the forward
// kernel's chain over DP (its last DP - D terms fma(0, 0, s) = s) and
// prefill rows stay bitwise this kernel's output at every D. The DP chain
// threads t < DP fold and hand off all DP accumulators (the padded ones
// are zeros), 16 bytes a store; only the D real columns are written. The
// psum thread lies past the chain threads: 64, or 128 at DP 128, where
// threads 128-255 otherwise only stage. Where D % 4 != 0 a head's row
// does not start on 16 bytes and V is copied 4 bytes at a time. Each
// width is built for D == DP (FULL, d a constant) and for D < DP. At DP
// 128 the padded K and the V tile take 133 KB of shared memory, so one CTA
// fits an SM, not the three of DP 64.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace {

constexpr int THREADS = 2 * mx::K_BLOCK;  // 256: all stage, 128 score
constexpr int CLUSTER_MAX = 8;            // portable cluster size
constexpr int SCORE_WARPS = mx::K_BLOCK / 32;

template <int DP>
struct Smem {
  float ks[mx::K_BLOCK * (DP + 1)];  // K tile, rows padded
  float vs[mx::K_BLOCK * DP];        // V tile
  float ps[mx::K_BLOCK];             // weights
  float qs[DP];                      // scaled query, zeros past d
  alignas(16) float acc_in[DP];      // the previous tile's acc
  float wmax[SCORE_WARPS];
  float tmax;                       // this tile's score max
  float safe_m, corr, psum;         // this tile's rescale, weight sum
  float l_in;                       // the previous tile's l
  unsigned long long bar;           // acc_in / l_in written
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// `p` (this CTA's shared memory) in the CTA of cluster rank `rank`, as a
// generic pointer: plain loads and stores through it reach that CTA's
// shared memory, and the compiler may batch them
template <class T>
__device__ __forceinline__ T* peer(T* p, uint32_t rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;\n"
      : "=l"(out)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// cp.async of `bytes` (4 or 16) from global `src` to shared `dst`;
// `valid` false zero-fills `dst` and reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = smem_u32(dst);
  const int n = valid ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival on the mbarrier at shared address `bar` that also expects
// `bytes` of asynchronous stores before its phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// shared address `local` in the CTA of cluster rank `rank`
__device__ __forceinline__ uint32_t peer_u32(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// asynchronous stores into a peer's shared memory (cluster addresses),
// each completing its bytes on the peer's mbarrier `bar`
__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t dst, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Row policies: where row kp of a (slot, head)'s keys and values lies, as
// an offset in floats from the slot's first row.
// The slot cache: a slot's rows are contiguous, max_len of them.
struct SlotRows {
  static constexpr bool PAGED = false;
  static constexpr int SMEM = 0;  // no shared memory of its own
  const float* keys;
  const float* values;
  __device__ __forceinline__ size_t first(int slot, int max_len) const {
    return (size_t)slot * max_len;
  }
  // row kp; `prow` unused
  static __device__ __forceinline__ size_t offset(const unsigned*, int,
                                                  int kp, int units) {
    return (size_t)kp * units;
  }
};

// The page pool: a slot's rows through its page table. The pool holds
// fewer than 2^32 floats (the host entry refuses more), so a row's offset
// fits 32 bits.
struct PagedRows {
  static constexpr bool PAGED = true;
  static constexpr int SMEM = mx::K_BLOCK * (int)sizeof(unsigned);  // prow
  const float* keys;
  const float* values;
  const int* tables;  // (slots, max_pages)
  int max_pages;
  int log2_ps;
  int pages;
  __device__ __forceinline__ size_t first(int, int) const { return 0; }
  // the offset of the slot's key kp (< view) in the pool, from its table
  // entry; an entry outside the pool reads the trash page 0
  __device__ __forceinline__ unsigned pool_offset(int slot, int kp,
                                                  int units) const {
    const int pg = __ldg(tables + (size_t)slot * max_pages + (kp >> log2_ps));
    const unsigned page = (unsigned)pg < (unsigned)pages ? pg : 0u;
    return ((page << log2_ps) | (unsigned)(kp & ((1 << log2_ps) - 1))) *
           (unsigned)units;
  }
  // row r of the tile, looked up once a tile into `prow`
  static __device__ __forceinline__ size_t offset(const unsigned* prow, int r,
                                                  int, int) {
    return (size_t)prow[r];
  }
};

template <int DP, bool FULL, class Rows>
__global__ void __launch_bounds__(THREADS, 3)
flash_decode_fwd_kernel(const float* __restrict__ q, Rows rows,
                        const int* __restrict__ positions,
                        float* __restrict__ out,
                        int max_len, int units, int d_arg, float scale) {
  constexpr int KS = DP + 1;
  constexpr int QUADS = DP / 4;
  // outside the DP chain threads; 64 as before DP 128
  constexpr int PSUM_THREAD = DP > 64 ? DP : 64;
  // the chain threads' lanes of a warp, for the hand-off's shuffles
  constexpr unsigned CHAIN = DP >= 32 ? 0xffffffffu : (1u << DP) - 1u;
  static_assert(mx::K_BLOCK * QUADS % THREADS == 0, "tile / threads");
  static_assert(PSUM_THREAD < THREADS && DP <= PSUM_THREAD,
                "the psum thread lies past the DP chain");
  static_assert(sizeof(Smem<DP>) + Rows::SMEM <= 232448,
                "the tile fits a block");
  const int d = FULL ? DP : d_arg;  // the real head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(smem_raw);
  // the paged instance's pool offset of each key of the tile
  unsigned* prow = reinterpret_cast<unsigned*>(smem_raw + sizeof(Smem<DP>));

  const int t = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int csize = (int)gridDim.x;
  const int slot = blockIdx.y;
  const int h = blockIdx.z;
  const int pos = positions[slot];
  const int last = min(pos, max_len - 1);  // last visible key
  const int ntiles = last < 0 ? 0 : last / mx::K_BLOCK + 1;
  const int rounds = (ntiles + csize - 1) / csize;

  // max_len: the view's length (max_pages * ps for the paged instance)
  const size_t row0 = rows.first(slot, max_len);
  const float* kb = rows.keys + row0 * units + h * d;
  const float* vb = rows.values + row0 * units + h * d;
  float* orow = out + (size_t)slot * units + h * d;

  if (t < DP)
    sm.qs[t] = t < d ? __fmul_rn(q[(size_t)slot * units + h * d + t], scale)
                     : 0.f;
  constexpr int HANDOFF_BYTES = (DP + 1) * (int)sizeof(float);  // acc, l
  if (t == 0) {
    mbar_init(smem_u32(&sm.bar), 1);
    mbar_expect_tx(smem_u32(&sm.bar), HANDOFF_BYTES);  // phase 0 armed
  }
  // one tile: rank 0 alone, no cluster barrier (nor any peer access)
  const bool alone = ntiles == 1;
  if (ntiles == 0 || (alone && rank != 0)) {
    // no visible key: the walk's untouched (l, acc)
    if (ntiles == 0 && rank == 0 && t < d)
      orow[t] = mx::finish_out(0.f, 0.f);
    return;  // before any barrier
  }

  float m_carry = -CUDART_INF_F;  // max over the earlier rounds' tiles
  uint32_t waits = 0;             // phases of sm.bar consumed

  for (int g = 0; g < rounds; ++g) {
    const int j = g * csize + (int)rank;  // this CTA's tile this round
    const bool has = j < ntiles;          // uniform over the CTA
    const int kbase = j * mx::K_BLOCK;
    float s = -CUDART_INF_F;
    if (has) {
      if constexpr (Rows::PAGED) {
        if (t < mx::K_BLOCK && kbase + t < max_len)
          prow[t] = rows.pool_offset(slot, kbase + t, units);
        __syncthreads();
      }
      // all of the tile's copies in flight at once, no registers staged:
      // K a float at a time into its padded rows, then V 16 bytes at a
      // time (a float at a time where d % 4 != 0); rows past max_len and
      // columns past d are zero-filled
#pragma unroll 8
      for (int idx = t; idx < mx::K_BLOCK * DP; idx += THREADS) {
        const int kp = kbase + idx / DP;
        const bool in = kp < max_len && idx % DP < d;
        cp_async<4>(sm.ks + (idx / DP) * KS + idx % DP,
                    kb + Rows::offset(prow, in ? idx / DP : 0, in ? kp : 0,
                                      units) + (in ? idx % DP : 0),
                    in);
      }
      cp_async_commit();
      if ((d & 3) == 0) {
#pragma unroll 8
        for (int idx = t; idx < mx::K_BLOCK * QUADS; idx += THREADS) {
          const int kp = kbase + idx / QUADS;
          const bool in = kp < max_len && 4 * (idx % QUADS) < d;
          cp_async<16>(sm.vs + 4 * idx,
                       vb + Rows::offset(prow, in ? idx / QUADS : 0,
                                         in ? kp : 0, units) +
                           (in ? 4 * (idx % QUADS) : 0),
                       in);
        }
      } else {
#pragma unroll 8
        for (int idx = t; idx < mx::K_BLOCK * DP; idx += THREADS) {
          const int kp = kbase + idx / DP;
          const bool in = kp < max_len && idx % DP < d;
          cp_async<4>(sm.vs + idx,
                      vb + Rows::offset(prow, in ? idx / DP : 0,
                                        in ? kp : 0, units) +
                          (in ? idx % DP : 0),
                      in);
        }
      }
      cp_async_commit();
      cp_async_wait<1>();  // this thread's K copies have landed
      __syncthreads();
      if (t < mx::K_BLOCK) {
        if (kbase + t <= last) s = mx::tile_score<DP>(sm.qs, sm.ks + t * KS);
        float wm = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, o));
        if ((t & 31) == 0) sm.wmax[t >> 5] = wm;
      }
      __syncthreads();
      if (t == 0) {
        float tm = sm.wmax[0];
#pragma unroll
        for (int w = 1; w < SCORE_WARPS; ++w) tm = fmaxf(tm, sm.wmax[w]);
        sm.tmax = tm;
      }
    }
    if (!alone) cluster_sync();  // every tile max of the round is written

    if (has) {
      if (t == 0) {
        // m_{j-1}: the earlier rounds' max, then the earlier ranks' tiles
        float m = m_carry;
        for (uint32_t r = 0; r < rank; ++r)
          m = fmaxf(m, *peer(&sm.tmax, r));
        mx::rescale(m, sm.tmax, sm.safe_m, sm.corr);
      }
      __syncthreads();
      if (t < mx::K_BLOCK) sm.ps[t] = mx::weight(s, sm.safe_m);
      cp_async_wait<0>();  // and its V copies
      __syncthreads();
      if (t == PSUM_THREAD) {
        float psum = 0.f;
        for (int jj = 0; jj < mx::K_BLOCK; ++jj)
          psum = __fadd_rn(psum, sm.ps[jj]);
        sm.psum = psum;
      }
    }
    if (t == 0 && g + 1 < rounds) {
      // a later round exists, so every tile of this one is live
      for (int r = 0; r < csize; ++r)
        m_carry = fmaxf(m_carry, *peer(&sm.tmax, (uint32_t)r));
    }

    if (has) {
      float lt = 0.f, at = 0.f;
      if (t < DP && j > 0) {
        mbar_wait_cluster(smem_u32(&sm.bar), waits & 1u);
        if (t == 0) mbar_expect_tx(smem_u32(&sm.bar), HANDOFF_BYTES);
        lt = sm.l_in;
        at = sm.acc_in[t];
      }
      if (j > 0) ++waits;
      if (t < DP) {
        // acc's fold, the walk's expressions in its order
        at = __fmul_rn(at, sm.corr);
#pragma unroll 16
        for (int jj = 0; jj < mx::K_BLOCK; ++jj)
          at = __fmaf_rn(sm.ps[jj], sm.vs[jj * DP + t], at);
      }
      __syncthreads();  // psum is written
      if (t < DP) {
        lt = __fmaf_rn(lt, sm.corr, sm.psum);
        if (j + 1 == ntiles) {
          if (t < d) orow[t] = mx::finish_out(at, lt);
        } else {
          // four columns a store: thread 4c sends columns 4c .. 4c + 3
          const float a1 = __shfl_down_sync(CHAIN, at, 1);
          const float a2 = __shfl_down_sync(CHAIN, at, 2);
          const float a3 = __shfl_down_sync(CHAIN, at, 3);
          if ((t & 3) == 0) {
            const uint32_t next = (rank + 1) % (uint32_t)csize;
            const uint32_t bar = peer_u32(smem_u32(&sm.bar), next);
            st_async(peer_u32(smem_u32(sm.acc_in + t), next),
                     make_float4(at, a1, a2, a3), bar);
            if (t == 0) st_async(peer_u32(smem_u32(&sm.l_in), next), lt,
                                 bar);
          }
        }
      }
    }
    if (!alone) cluster_sync();  // no peer reads or writes this round
  }
}

template <int DP, bool FULL, class Rows>
cudaError_t launch(const float* q, Rows rows, const int* positions,
                   float* out, int slots, int max_len, int heads, int d,
                   float scale, cudaStream_t stream) {
  auto* kernel = flash_decode_fwd_kernel<DP, FULL, Rows>;
  constexpr int SMEM_BYTES = (int)sizeof(Smem<DP>) + Rows::SMEM;
  // the shared-memory attribute once per device (and instance)
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  if (slots == 0) return cudaSuccess;
  const int tiles = (max_len + mx::K_BLOCK - 1) / mx::K_BLOCK;
  // max_len 0: a cluster of one whose CTAs find no tile
  const int cluster = tiles < CLUSTER_MAX ? (tiles > 0 ? tiles : 1)
                                          : CLUSTER_MAX;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)slots, (unsigned)heads);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, rows, positions, out, max_len,
                           heads * d, d, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instance built at padded width DP (d <= DP)
template <int DP, class Rows>
cudaError_t launch_dp(const float* q, Rows rows, const int* positions,
                      float* out, int slots, int max_len, int heads, int d,
                      float scale, cudaStream_t stream) {
  return d == DP ? launch<DP, true>(q, rows, positions, out, slots, max_len,
                                    heads, d, scale, stream)
                 : launch<DP, false>(q, rows, positions, out, slots, max_len,
                                     heads, d, scale, stream);
}

// the instance built at padded width ``width`` (16, 32, 64 or 128; d <=
// width): attention.py head_width
template <class Rows>
cudaError_t launch_width(const float* q, Rows rows, const int* positions,
                         float* out, int slots, int max_len, int heads,
                         int d, int width, float scale,
                         cudaStream_t stream) {
  switch (width) {
    case 16:
      return launch_dp<16>(q, rows, positions, out, slots, max_len, heads, d,
                           scale, stream);
    case 32:
      return launch_dp<32>(q, rows, positions, out, slots, max_len, heads, d,
                           scale, stream);
    case 64:
      return launch_dp<64>(q, rows, positions, out, slots, max_len, heads, d,
                           scale, stream);
    case 128:
      return launch_dp<128>(q, rows, positions, out, slots, max_len, heads,
                            d, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---- host entry point ----
// q (slots, U), keys/values (slots, max_len, U), positions (slots,) int32,
// out (slots, U); all contiguous on the device, 16-byte aligned, U =
// heads*D, 1 <= D <= width, the padded width of the instance (16, 32, 64 or
// 128: attention.py head_width). Returns the cudaError_t of the launch.
extern "C" int mx_flash_decode_fwd(const void* q, const void* keys,
                                   const void* values, const void* positions,
                                   void* out, int slots, int max_len,
                                   int units, int heads, int width,
                                   float scale, void* stream) {
  const int d = heads > 0 ? units / heads : 0;
  if (heads <= 0 || units != heads * d || d < 1 || d > width || slots < 0 ||
      max_len < 0 || heads > 65535 || slots > 65535)
    return cudaErrorInvalidValue;
  const SlotRows rows = {static_cast<const float*>(keys),
                        static_cast<const float*>(values)};
  return launch_width(static_cast<const float*>(q), rows,
                      static_cast<const int*>(positions),
                      static_cast<float*>(out), slots, max_len, heads, d,
                      width, scale, static_cast<cudaStream_t>(stream));
}

// q (slots, U), key_pool/value_pool (pages, page_size, U), tables (slots,
// max_pages) int32, positions (slots,) int32, out (slots, U); all contiguous
// on the device, 16-byte aligned, U = heads*D (1 <= D <= width, as for
// mx_flash_decode_fwd), page_size a power of two.
// Slot s attends keys <= positions[s] of its view, the max_pages * page_size
// rows its table names. Returns the cudaError_t of the launch.
extern "C" int mx_flash_paged_decode_fwd(const void* q, const void* key_pool,
                                         const void* value_pool,
                                         const void* tables,
                                         const void* positions, void* out,
                                         int slots, int max_pages,
                                         int page_size, int pages, int units,
                                         int heads, int width, float scale,
                                         void* stream) {
  int log2_ps = 0;
  while (log2_ps < 30 && (1 << log2_ps) < page_size) ++log2_ps;
  const int d = heads > 0 ? units / heads : 0;
  if (heads <= 0 || units != heads * d || d < 1 || d > width || slots < 0 ||
      max_pages < 0 ||
      pages < 1 || page_size < 1 || (1 << log2_ps) != page_size ||
      heads > 65535 || slots > 65535 ||
      (long long)max_pages * page_size > 0x7fffffffLL ||
      (long long)pages * page_size * units > 0xffffffffLL)
    return cudaErrorInvalidValue;
  const PagedRows rows = {static_cast<const float*>(key_pool),
                          static_cast<const float*>(value_pool),
                          static_cast<const int*>(tables), max_pages,
                          log2_ps, pages};
  return launch_width(static_cast<const float*>(q), rows,
                      static_cast<const int*>(positions),
                      static_cast<float*>(out), slots, max_pages * page_size,
                      heads, d, width, scale,
                      static_cast<cudaStream_t>(stream));
}
