// bf16 matrix products for Hopper (sm_90a) on TMA and wgmma: the four
// variants of the matmul probe. Y (M, N) = bf16(A (M, K) . B (K, N)),
// every operand row-major, the sum taken in float32 and rounded to bf16
// once, every row written.
//
// Replaces the four Pallas variants of tools/probe_matmul_pipeline.py:
//   pallas_cur (:41)    grid (m, n), a float32 accumulator tile (acc_ref)
//                       cast to the output block;
//   pallas_noacc (:65)  grid (m, n), the dot cast straight to the output
//                       block;
//   pallas_ws (:88)     grid (n, m): the weight tile stays while A and Y
//                       stream;
//   pallas_ep (:112)    the same (n, m) walk as one hand-built
//                       double-buffered pipeline (emit_pipeline).
// The TPU kernels leave rows past (M // bm) * bm unwritten (their grid is
// M // bm); here every row is computed.
//
// What bounds them on the H100 at the probe's eight shapes (ResNet-50's
// 1x1 convs at batch 128): bytes at shapes 1-6, where 2 (MK + KN + MN)
// bytes at 3.35 TB/s take longer than 2MKN flops at 989 TFLOP/s (A of
// 12.8-205 MB against a B of at most 0.5 MB; Y of 205 MB at shape 1);
// operations at shapes 7-8 (6272 x 512 x 2048 and 6272 x 2048 x 512).
// The design reads A once from memory, keeps enough copies in flight to
// cover the memory's latency, writes Y in whole 32-byte sectors or more,
// and feeds the tensor cores through wgmma, their only route to the full
// rate.
//
// The mainloop, shared by the four variants. A block has one or two
// consumer warpgroups (CWG; 64 rows of the tile each, BM = 64 CWG) and one
// producer warp. The producer's lane 0 issues TMA loads of K slices of 64
// (128 bytes of bf16) into an S-stage ring guarded by full / empty
// mbarriers: A as one BM x 64 box, B (row-major, N contiguous) as BN / 64
// boxes of 64 k rows x 64 columns, all with the 128-byte swizzle. Each
// consumer warpgroup waits for a stage, issues four
// wgmma.m64nBNk16.f32.bf16.bf16 (A K-major, B MN-major through the
// transpose bit; both from shared memory by descriptor) into float32
// registers, commits, and releases the previous stage once the wgmma
// group reading it has retired (wait_group 1), so one group stays in
// flight. TMA zero-fills loads past M, N and K, so any M >= 1 and K, N
// multiples of 8 work; a B box wholly past N is not loaded at all
// (columns of Y depend on their own columns of B only, and are clipped or
// masked). L2 policies: B (read by every tile of its column) and an A
// that more than one column of tiles reads are kept (evict_last; for cur
// and noacc, whose readers of an A tile run together, 1-3 % faster than
// evict_normal at probe shapes 6-7); an A read once and Y are streamed
// (evict_first).
//
// The epilogues. ws and ep round the accumulators to bf16 pairs
// (__floats2bfloat162_rn) and write them, one 64 x 64 box at a time, in
// the same 128-byte swizzle (bank-conflict free) to shared memory, from
// where one thread stores each box with TMA, asynchronously, clipped at M
// and N. cur and noacc store Y from the threads, 16 bytes a store
// (st.global with an evict_first policy), masked at M and N (N is a
// multiple of 8, so an 8-column group never straddles it).
//
//   ws     one block a tile, m fastest across the grid: consecutive blocks
//          share the K x BN weight tile in L2 while A and Y stream. The Y
//          boxes overlay the drained ring, and the ring has no more stages
//          than the tile has K slices. Below 8 K slices a BN of 256 runs
//          64 x 256 tiles with one consumer warpgroup, so that a
//          128-register accumulator leaves room for two blocks an SM and
//          one block's loads overlap the other's stores (at K = 64, probe
//          shape 1, a tile is one slice and nothing inside it can
//          overlap); from 8 on, 128 x 256 tiles, one block an SM, four
//          stages. BN covers N up to 256, so A is read once there.
//   ep     persistent: SMs x blocks-an-SM blocks, each walking its tiles
//          (blockIdx.x, + gridDim.x, ...) in (n outer, m inner) order, 128
//          rows a tile. The producer runs ahead across tile boundaries, so
//          the next tile's slices load while the consumers run this tile's
//          epilogue, and the TMA stores of a tile overlap the next tile's
//          mainloop. Each warpgroup stages its Y boxes in two buffers
//          beside the ring, in turn, each reused once the store two boxes
//          back has read it; so even BN 256 keeps four stages. setmaxnreg
//          is not used: the producer is one warp, 32 of the 288 threads,
//          and releasing its registers would give each consumer thread
//          less than 8 more.
//   cur    one block a tile, n fastest across the grid (the TPU's (m, n)
//          order): tile t at (t / tiles_n, t % tiles_n), so the blocks
//          that read one A tile run together and A leaves memory once at
//          any N. The epilogue stages the float32 accumulator tile in
//          shared memory over the drained ring (acc_ref), in rows of BN
//          floats whose 16-byte chunks are XOR-swizzled: chunk c of row r
//          sits at c ^ ((c >> 3) & 1) ^ 2 (r & 3), so the fragments'
//          8-byte writes (a half-warp: 4 rows x 2 chunks) and the 16-byte
//          reads of a row (a quarter-warp: 8 chunks 32 bytes apart) each
//          meet every bank once. After a named barrier a warpgroup reads
//          its 64 rows back, BN / 8 threads a row, 8 floats a thread,
//          rounds each element once and stores 16 bytes: a warp writes
//          whole rows of Y (at BN 256, 512 contiguous bytes a store).
//          Measured against the other way, rounding into a swizzled bf16
//          box for a TMA store: the stores from the threads took 0.462 ms
//          over the probe's eight shapes, the TMA store 0.494 and more at
//          every shape (a third pass over shared memory, 1.5x the
//          staging). Tiles and stages as ws; shared memory max(ring, BM x
//          BN x 4).
//   noacc  the same tile walk; Y gets no shared memory. Each thread holds
//          two columns of every 8-column group of rows r and r + 8; a 4 x
//          4 transpose within the quad (two butterfly stages of shuffles,
//          in registers) gives each thread 8 contiguous columns, so each
//          16-byte store writes 64 contiguous bytes of a row a quad. The
//          shared memory is the ring alone. Tiles as ws, but below 8 K
//          slices 128 x 128 in place of 64 x 256 (both two blocks an SM;
//          the wider tile ran 2-6 % slower at probe shapes 1, 4 and 6).
//
// Not taken, after measurement on the card: clusters of two blocks along
// M sharing each B slice by TMA multicast (the same time as the cluster
// without multicast, and both slower than no cluster), and L2 promotion
// of 128 bytes or none (no faster than 256).
//
// The wrapper (matmul.py matmul_geometry) picks the tile from the built
// instances, the stages, the grid and the shared-memory bytes; run()
// refuses a geometry that no instance has.
//
// Rounding: products of bf16 are exact in float32; the tensor cores sum
// them in float32 in their own order. Two orders differ by a bf16 ulp in a
// few elements: callers hold Y to the float64 product, not to another
// order bitwise.
#include <cuda.h>  // CUtensorMap and its enums only; libcuda is reached
                   // through the runtime's entry-point query, not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int BK = 64;            // K slice: 64 bf16, one 128-byte row
constexpr int ROW = 128;          // bytes of a swizzled shared-memory row
constexpr int PANEL = 64 * ROW;   // 64 rows x 64 bf16: a B box, a Y box
constexpr int ALIGN = 1024;       // the 128-byte swizzle repeats every 8 rows
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may take

// the variants, numbered as the INSTANCES table and the entry points do
enum Variant { WS = 0, EP = 1, CUR = 2, NOACC = 3 };

template <int BN, int CWG>
struct Tile {
  static constexpr int BM = 64 * CWG;
  static constexpr int THREADS = 128 * CWG + 32;  // consumers + producer
  static constexpr int A_BYTES = BM * ROW;        // BM rows x 64 k
  static constexpr int STAGE = A_BYTES + (BN / 64) * PANEL;
};

// Bytes of dynamic shared memory a block takes: alignment slack, then the
// ring of `stages` stages and the staging space, then a full and an empty
// mbarrier a stage. ws stages the whole BM x BN bf16 tile over the
// drained ring, cur the float32 tile; ep keeps two 64 x 64 Y boxes a
// warpgroup beside the ring, used in turn; noacc stages nothing.
__host__ __device__ constexpr int staging_bytes(int v, int bm, int bn) {
  return v == WS ? bm * bn * 2
                 : v == EP ? 2 * (bm / 64) * PANEL
                           : v == CUR ? bm * bn * 4 : 0;
}

__host__ __device__ constexpr int region_bytes(int v, int bm, int bn,
                                               int stages) {
  return v == EP ? stages * (bm + bn) * ROW + staging_bytes(v, bm, bn)
                 : (stages * (bm + bn) * ROW > staging_bytes(v, bm, bn)
                        ? stages * (bm + bn) * ROW
                        : staging_bytes(v, bm, bn));
}

__host__ __device__ constexpr int layout_bytes(int v, int bm, int bn,
                                               int stages) {
  return ALIGN + region_bytes(v, bm, bn, stages) + 16 * stages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
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

// Spin until the phase of parity `parity` has completed.
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

// ---- L2 policies ----
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// ---- TMA ----
// box at (column c, row r) of the tensor map -> shared memory, reported to
// the mbarrier as bytes, kept in L2 by `policy`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c, int r, uint32_t bar,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar),
      "l"(policy)
      : "memory");
}

// shared memory -> the box at (column c, row r), clipped at the edges
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c, int r,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%1, %2}], [%3], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(r), "r"(src), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// all but the thread's N latest store groups have read their shared
// memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes become visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ----
// Shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets (16-byte units), layout type 1 at bit
// 62. A (K-major): rows of 128 bytes, 8-row groups 1024 bytes apart (the
// stride offset); its leading offset is unused. B (MN-major): 64 columns
// a 128-byte row, 8-row groups of k 1024 bytes apart (the stride offset),
// 64-column panels PANEL bytes apart (the leading offset).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lead >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across the async
// wgmma window
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N float32, the warpgroup's fragments) = A . B + (scale_d ? d : 0)
// for A 64 x 16 (K-major) and B 16 x N (MN-major, imm-trans-b 1)
template <int N>
struct Wgmma;

#define MX_ACC8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : MX_ACC8(0),
        MX_ACC8(8),
        MX_ACC8(16),
        MX_ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : MX_ACC8(0),
        MX_ACC8(8),
        MX_ACC8(16),
        MX_ACC8(24),
        MX_ACC8(32),
        MX_ACC8(40),
        MX_ACC8(48),
        MX_ACC8(56)
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : MX_ACC8(0),
        MX_ACC8(8),
        MX_ACC8(16),
        MX_ACC8(24),
        MX_ACC8(32),
        MX_ACC8(40),
        MX_ACC8(48),
        MX_ACC8(56),
        MX_ACC8(64),
        MX_ACC8(72),
        MX_ACC8(80),
        MX_ACC8(88),
        MX_ACC8(96),
        MX_ACC8(104),
        MX_ACC8(112),
        MX_ACC8(120)
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

#undef MX_ACC8

// two floats rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float a,
                                             float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// 16 bytes to global memory, kept in L2 by `policy`
__device__ __forceinline__ void st_global16(void* p, uint32_t a, uint32_t b,
                                            uint32_t c, uint32_t d,
                                            uint64_t policy) {
  asm volatile(
      "st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(
          p),
      "r"(a), "r"(b), "r"(c), "r"(d), "l"(policy)
      : "memory");
}

// cur's float32 staging: the 16-byte chunk c of row r sits at this chunk
// of the row (bits 0-2 permuted, so within its 128-byte line)
__device__ __forceinline__ int staged_chunk(int r, int c) {
  return c ^ ((c >> 3) & 1) ^ ((r & 3) << 1);
}

// noacc: thread q of a quad holds v[j] = columns 2q, 2q + 1 of 8-column
// group j; afterwards v[j] = columns 2j, 2j + 1 of group q. Two butterfly
// stages: with lane q ^ 1 the groups of the other parity change hands,
// with lane q ^ 2 the other half; last, the four words are put in column
// order.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool odd = q & 1, high = q & 2;
  // keep groups q & 1 and 2 + (q & 1); receive the partner's words there
  const uint32_t a0 = odd ? v[1] : v[0], a1 = odd ? v[3] : v[2];
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  // keep group q: columns of lanes q, q ^ 1; receive those of q ^ 2, q ^ 3
  const uint32_t k0 = high ? a1 : a0, k1 = high ? r1 : r0;
  const uint32_t u0 = __shfl_xor_sync(0xffffffffu, high ? a0 : a1, 2);
  const uint32_t u1 = __shfl_xor_sync(0xffffffffu, high ? r0 : r1, 2);
  // w[d] holds the columns of lane q ^ d: v[c] = w[c ^ q]
  const uint32_t x0 = odd ? k1 : k0, x1 = odd ? k0 : k1;
  const uint32_t x2 = odd ? u1 : u0, x3 = odd ? u0 : u1;
  v[0] = high ? x2 : x0;
  v[1] = high ? x3 : x1;
  v[2] = high ? x0 : x2;
  v[3] = high ? x1 : x3;
}

struct Shape {
  int m, n, k;
  // ws, ep: tile t at (t % tiles_m, t / tiles_m); cur, noacc: at
  // (t / tiles_n, t % tiles_n)
  int tiles_m, tiles_n, tiles;
  int stages;
  void* y;  // cur, noacc: Y's storage (ws and ep store by tensor map)
};

// (m0, n0) of tile t
template <int V, int BM, int BN>
__device__ __forceinline__ int2 origin(int t, const Shape& p) {
  return V >= CUR ? make_int2((t / p.tiles_n) * BM, (t % p.tiles_n) * BN)
                  : make_int2((t % p.tiles_m) * BM, (t / p.tiles_m) * BN);
}

// The block's tiles: blockIdx.x, then (ep) every gridDim.x-th after it.
template <int BN, int CWG, int V>
__device__ __forceinline__ void gemm(const CUtensorMap* ta,
                                     const CUtensorMap* tb,
                                     const CUtensorMap* ty, const Shape& p) {
  using T = Tile<BN, CWG>;
  constexpr bool ep = V == EP;  // persistent, staging beside the ring
  extern __shared__ unsigned char smem[];
  const uint32_t ring = (smem_u32(smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const int S = p.stages;
  const uint32_t staging = ep ? ring + S * T::STAGE : ring;
  const uint32_t full = ring + region_bytes(V, T::BM, BN, S);
  const uint32_t empty = full + 8 * S;
  const int kt = (p.k + BK - 1) / BK;
  const int step = ep ? (int)gridDim.x : p.tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CWG);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CWG) {  // the producer warp
    if (lane != 0) return;
    // B is read by every tile of its column; A by every tile of its row
    const uint64_t keep = evict_last();
    const uint64_t a_policy = p.tiles_n > 1 ? keep : evict_first();
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += step) {
      const int2 o = origin<V, T::BM, BN>(t, p);
      const int m0 = o.x, n0 = o.y;
      // B boxes of this tile that hold a column < N
      const int panels = min(BN / 64, (p.n - n0 + 63) / 64);
      const int bytes = T::A_BYTES + panels * PANEL;
      for (int s = 0; s < kt; ++s) {
        mbar_wait(empty + 8 * stage, phase ^ 1);  // the first pass is free
        const uint32_t bar = full + 8 * stage;
        const uint32_t dst = ring + stage * T::STAGE;
        mbar_expect_tx(bar, bytes);
        tma_load(dst, ta, s * BK, m0, bar, a_policy);
        for (int j = 0; j < panels; ++j)
          tma_load(dst + T::A_BYTES + j * PANEL, tb, n0 + 64 * j, s * BK,
                   bar, keep);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4, tid = threadIdx.x % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // ws, ep: the warpgroup's Y boxes, ws BN / 64 of them, ep two used in
  // turn; cur: its 64 float32 rows
  const uint32_t mine = staging + wg * staging_bytes(V, 64, BN);
  // fragment rows r and r + 8 of the warpgroup's 64; (r + 8) % 8 == r % 8
  const int r = (warp % 4) * 16 + lane / 4;
  int stage = 0;
  uint32_t phase = 0;
  uint32_t turn = 0;  // ep: the staging buffer of the next Y box
  for (int t = blockIdx.x; t < p.tiles; t += step) {
    const int2 o = origin<V, T::BM, BN>(t, p);
    const int m0 = o.x, n0 = o.y;
    int held = -1;  // the stage the wgmma group in flight reads
    for (int s = 0; s < kt; ++s) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a = ring + stage * T::STAGE + wg * 64 * ROW;
      const uint32_t b = ring + stage * T::STAGE + T::A_BYTES;
      wgmma_fence();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // A: 16 k = 32 bytes along the swizzled row; B: 16 k rows
        Wgmma<BN>::mma(acc, descriptor(a + kk * 32, 16, 8 * ROW),
                       descriptor(b + kk * 16 * ROW, PANEL, 8 * ROW),
                       (s | kk) != 0);
      wgmma_commit();
      fence_operands(acc);
      if (held >= 0) {
        wgmma_wait<1>();
        if (tid == 0) mbar_arrive(empty + 8 * held);
      }
      held = stage;
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (tid == 0) mbar_arrive(empty + 8 * held);

    if constexpr (V == NOACC) {
      // straight from the fragments: after the quad's transpose, lane q
      // holds 8-column group 4 b + q of its row
      const uint64_t y_policy = evict_first();
      const int q = lane % 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows r, r + 8
        const int gm = m0 + 64 * wg + r + 8 * h;
#pragma unroll
        for (int b = 0; b < BN / 32; ++b) {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = 4 * (4 * b + j) + 2 * h;
            v[j] = pack_bf16(acc[c], acc[c + 1]);
          }
          quad_transpose(v, q);
          const int gn = n0 + 8 * (4 * b + q);
          if (gm < p.m && gn < p.n)
            st_global16(static_cast<__nv_bfloat16*>(p.y) +
                            (size_t)gm * p.n + gn,
                        v[0], v[1], v[2], v[3], y_policy);
        }
      }
    } else if constexpr (V == CUR) {
      // the float32 tile over the drained ring, once every warpgroup is
      // done with it; fragment i of 8 columns: chunks 2 i and 2 i + 1
      named_barrier(1, 128 * CWG);
      const int q = lane % 4;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const uint32_t at =
            mine + r * BN * 4 + staged_chunk(r, 2 * i + q / 2) * 16 +
            (q % 2) * 8;
        st_shared_f2(at, acc[4 * i], acc[4 * i + 1]);
        st_shared_f2(at + 8 * BN * 4, acc[4 * i + 2], acc[4 * i + 3]);
      }
      named_barrier(2 + wg, 128);
      // read back: BN / 8 threads a row, 8 columns a thread
      const uint64_t y_policy = evict_first();
      constexpr int TR = BN / 8;
      const int g = tid % TR;
#pragma unroll 4
      for (int row = tid / TR; row < 64; row += 128 / TR) {
        const uint32_t at = mine + row * BN * 4;
        const float4 lo = ld_shared_f4(at + staged_chunk(row, 2 * g) * 16);
        const float4 hi =
            ld_shared_f4(at + staged_chunk(row, 2 * g + 1) * 16);
        const int gm = m0 + 64 * wg + row, gn = n0 + 8 * g;
        if (gm < p.m && gn < p.n)
          st_global16(static_cast<__nv_bfloat16*>(p.y) +
                          (size_t)gm * p.n + gn,
                      pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                      pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w),
                      y_policy);
      }
    } else {
      // one 64 x 64 Y box at a time. ws: box j of the tile over the
      // ring, once every warpgroup is done with it. ep: the two buffers
      // in turn, each once the store from it two boxes back has read it
      // (every box commits one store group, empty where the box lies past
      // M or N).
      if (!ep) named_barrier(1, 128 * CWG);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j) {
        const uint32_t box = mine + (ep ? (turn++ & 1) : j) * PANEL;
        if (ep) {
          if (tid == 0) bulk_wait_read<1>();
          named_barrier(2 + wg, 128);
        }
        // fragment i of 8 columns: 16-byte chunk i of the row, stored at
        // chunk i ^ (r % 8)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 4 * (8 * j + i);
          const uint32_t at =
              box + r * ROW + ((i ^ (r % 8)) * 16) + (lane % 4) * 4;
          st_shared(at, pack_bf16(acc[c], acc[c + 1]));
          st_shared(at + 8 * ROW, pack_bf16(acc[c + 2], acc[c + 3]));
        }
        fence_proxy_async();
        named_barrier(2 + wg, 128);
        if (tid == 0) {
          if (m0 + 64 * wg < p.m && n0 + 64 * j < p.n)
            tma_store(ty, box, n0 + 64 * j, m0 + 64 * wg, evict_first());
          bulk_commit();
        }
      }
    }
  }
  // the block's shared memory must outlive the TMA stores' reads of it
  if (V <= EP && tid == 0) bulk_wait_read<0>();
}

template <int BN, int CWG, int BLOCKS>
__global__ void __launch_bounds__(Tile<BN, CWG>::THREADS, BLOCKS)
    matmul_ws_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap ty, Shape p) {
  gemm<BN, CWG, WS>(&ta, &tb, &ty, p);
}

template <int BN, int CWG, int BLOCKS>
__global__ void __launch_bounds__(Tile<BN, CWG>::THREADS, BLOCKS)
    matmul_ep_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap ty, Shape p) {
  gemm<BN, CWG, EP>(&ta, &tb, &ty, p);
}

template <int BN, int CWG, int BLOCKS>
__global__ void __launch_bounds__(Tile<BN, CWG>::THREADS, BLOCKS)
    matmul_cur_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap ty, Shape p) {
  gemm<BN, CWG, CUR>(&ta, &tb, &ty, p);
}

template <int BN, int CWG, int BLOCKS>
__global__ void __launch_bounds__(Tile<BN, CWG>::THREADS, BLOCKS)
    matmul_noacc_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap ty, Shape p) {
  gemm<BN, CWG, NOACC>(&ta, &tb, &ty, p);
}

// ---- host ----

// The built instances: variant (0 ws, 1 ep, 2 cur, 3 noacc), BM, BN, the
// most stages and the blocks an SM the kernel's registers are bounded
// for. matmul.py's _INSTANCES mirrors this table.
struct Instance {
  int variant, bm, bn, stages, blocks;
};
constexpr Instance INSTANCES[] = {
    {0, 128, 64, 4, 2}, {0, 128, 128, 3, 2}, {0, 64, 256, 2, 2},
    {0, 128, 256, 4, 1}, {1, 128, 64, 8, 1}, {1, 128, 128, 6, 1},
    {1, 128, 256, 4, 1}, {2, 128, 64, 4, 2}, {2, 128, 128, 3, 2},
    {2, 64, 256, 2, 2}, {2, 128, 256, 4, 1}, {3, 128, 64, 4, 2},
    {3, 128, 128, 3, 2}, {3, 128, 256, 4, 1},
};
constexpr int N_INSTANCES = sizeof(INSTANCES) / sizeof(INSTANCES[0]);
constexpr int MAX_DEVICES = 64;

using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, Shape);

Kernel kernel_of(int i) {
  switch (i) {
    case 0: return matmul_ws_kernel<64, 2, 2>;
    case 1: return matmul_ws_kernel<128, 2, 2>;
    case 2: return matmul_ws_kernel<256, 1, 2>;
    case 3: return matmul_ws_kernel<256, 2, 1>;
    case 4: return matmul_ep_kernel<64, 2, 1>;
    case 5: return matmul_ep_kernel<128, 2, 1>;
    case 6: return matmul_ep_kernel<256, 2, 1>;
    case 7: return matmul_cur_kernel<64, 2, 2>;
    case 8: return matmul_cur_kernel<128, 2, 2>;
    case 9: return matmul_cur_kernel<256, 1, 2>;
    case 10: return matmul_cur_kernel<256, 2, 1>;
    case 11: return matmul_noacc_kernel<64, 2, 2>;
    case 12: return matmul_noacc_kernel<128, 2, 2>;
    case 13: return matmul_noacc_kernel<256, 2, 1>;
    default: return nullptr;
  }
}

int instance_of(int v, int bm, int bn) {
  for (int i = 0; i < N_INSTANCES; ++i)
    if (INSTANCES[i].variant == v && INSTANCES[i].bm == bm &&
        INSTANCES[i].bn == bn)
      return i;
  return -1;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime has loaded
EncodeTiled encoder() {
  static std::atomic<EncodeTiled> cached{nullptr};
  EncodeTiled fn = cached.load(std::memory_order_acquire);
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                          cudaEnableDefault, &status);
#endif
  if (e != cudaSuccess || status != cudaDriverEntryPointSuccess || !p)
    return nullptr;
  fn = reinterpret_cast<EncodeTiled>(p);
  cached.store(fn, std::memory_order_release);
  return fn;
}

// A rows x cols row-major bf16 matrix, moved in boxes of box_rows x 64
// columns with the 128-byte swizzle; reads past the edges give zeros.
cudaError_t tensor_map(CUtensorMap* map, EncodeTiled encode, const void* base,
                       int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Once for each instance and device: the dynamic shared-memory attribute
// (above 48 KB it has to be asked for, or the launch is refused), set to
// the instance's largest layout.
cudaError_t setup(int i, Kernel kernel) {
  static std::atomic<bool> done[N_INSTANCES][MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[i][dev].load(std::memory_order_acquire)) return cudaSuccess;
  const Instance& in = INSTANCES[i];
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           layout_bytes(in.variant, in.bm, in.bn, in.stages));
  if (e == cudaSuccess) done[i][dev].store(true, std::memory_order_release);
  return e;
}

int run(int v, const void* a, const void* b, void* y, int m, int n, int k,
        int bm, int bn, int bk, int stages, int grid, int smem,
        void* stream) {
  if (m < 0 || n < 0 || k < 1 || n % 8 != 0 || k % 8 != 0)
    return cudaErrorInvalidValue;
  const int i = instance_of(v, bm, bn);
  if (i < 0 || bk != BK || stages < 1 || stages > INSTANCES[i].stages ||
      smem != layout_bytes(v, bm, bn, stages) || smem > SMEM_MAX)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const long long tiles_m = (m + bm - 1) / bm, tiles_n = (n + bn - 1) / bn;
  const long long tiles = tiles_m * tiles_n;
  if (tiles > INT_MAX || grid < 1 || grid > tiles ||
      (v != EP && grid != tiles))
    return cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  // cur and noacc store Y from the threads: their ty stays unused
  CUtensorMap ta, tb, ty = {};
  cudaError_t e;
  if ((e = tensor_map(&ta, encode, a, m, k, bm)) != cudaSuccess ||
      (e = tensor_map(&tb, encode, b, k, n, BK)) != cudaSuccess ||
      (v <= EP && (e = tensor_map(&ty, encode, y, m, n, 64)) != cudaSuccess))
    return e;
  const Kernel kernel = kernel_of(i);
  if ((e = setup(i, kernel)) != cudaSuccess) return e;
  const Shape p{m, n, k, (int)tiles_m, (int)tiles_n, (int)tiles, stages, y};
  kernel<<<grid, 128 * (bm / 64) + 32, smem,
           static_cast<cudaStream_t>(stream)>>>(ta, tb, ty, p);
  return cudaGetLastError();
}

}  // namespace

// a (m, k), b (k, n), y (m, n): bf16, contiguous, 16-byte aligned; k and n
// multiples of 8, k >= 1. bm, bn, bk, stages, grid and smem come from
// matmul.py matmul_geometry; a geometry no instance has is refused
// (cudaErrorInvalidValue). Each returns the cudaError_t of its launch.
extern "C" int mx_matmul_ws(const void* a, const void* b, void* y, int m,
                            int n, int k, int bm, int bn, int bk, int stages,
                            int grid, int smem, void* stream) {
  return run(WS, a, b, y, m, n, k, bm, bn, bk, stages, grid, smem, stream);
}

extern "C" int mx_matmul_ep(const void* a, const void* b, void* y, int m,
                            int n, int k, int bm, int bn, int bk, int stages,
                            int grid, int smem, void* stream) {
  return run(EP, a, b, y, m, n, k, bm, bn, bk, stages, grid, smem, stream);
}

extern "C" int mx_matmul_cur(const void* a, const void* b, void* y, int m,
                             int n, int k, int bm, int bn, int bk,
                             int stages, int grid, int smem, void* stream) {
  return run(CUR, a, b, y, m, n, k, bm, bn, bk, stages, grid, smem, stream);
}

extern "C" int mx_matmul_noacc(const void* a, const void* b, void* y, int m,
                               int n, int k, int bm, int bn, int bk,
                               int stages, int grid, int smem,
                               void* stream) {
  return run(NOACC, a, b, y, m, n, k, bm, bn, bk, stages, grid, smem,
             stream);
}

// Dynamic shared memory of an instance of variant v at `stages` stages,
// in bytes (0: no such instance or stage count), so the wrapper can hold
// its geometry to the kernel's layout.
extern "C" int mx_matmul_sm90_smem(int v, int bm, int bn, int stages) {
  const int i = instance_of(v, bm, bn);
  if (i < 0 || stages < 1 || stages > INSTANCES[i].stages) return 0;
  return layout_bytes(v, bm, bn, stages);
}
