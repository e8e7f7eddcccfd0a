// bf16 matrix products on the tensor cores for Hopper (sm_90a), on the
// mma.sync mainloop: Y (M, N) = bf16(A (M, K) . B (K, N)), every operand
// row-major, the sum taken in float32 and rounded to bf16 once.
//
// Replaces two of the four Pallas variants of tools/probe_matmul_pipeline.py,
// the repo's probe of a hand-written matmul against the compiler's on
// ResNet-50's 1x1-conv shapes (bf16, batch 128, M = B*H*W):
//   pallas_cur   (:41)  f32 scratch accumulator, grid (m, n), m outer
//   pallas_noacc (:65)  the dot cast straight to the output block
// with one template and two C entry points, mx_matmul_cur and _noacc. The
// other two, pallas_ws (:88) and pallas_ep (:112), run on TMA and wgmma in
// matmul_sm90.cu. The TPU kernels leave rows past (M // bm) * bm unwritten
// (their grid is M // bm); here every row is computed.
//
// What bounds them on the H100: bytes at six of the probe's eight shapes
// (K or N of 64-256 against M of 25088-401408: 2 * (MK + KN + MN) bytes
// take longer at 3.35 TB/s than 2MKN flops at 989 TFLOP/s), operations
// at the last two (6272 x 512 x 2048 and 6272 x 2048 x 512). So the
// design reads A once, keeps B in L2, and writes Y with full sectors;
// the tensor cores only have to keep up.
//
// Design. The TPU tile (bm 1024 x full K, 4 MB at K 2048) does not fit
// in 227 KB of shared memory; here a block of 256 threads (8 warps, 2
// along M x 4 along N) computes a 128 x 128 tile of Y (128 x 64 where
// N <= 64) and walks K in slices of 32. Each slice of A (128 x 32) and B
// (32 x BN) goes to shared memory by 16-byte cp.async copies into a
// two-stage ring, so the next slice is in flight while the tensor cores
// work on this one; rows past M and columns past N or K are zero-filled
// (src-size 0), so any M >= 1 works and K, N need only be multiples of 8
// (each row starts on 16 bytes). Rows are padded by 16 bytes (A pitch 80
// B, B pitch 272 or 144 B) so that the eight rows of each ldmatrix phase
// fall in eight different bank groups. Each warp owns a 64 x 32 (64 x 16)
// piece: per 16-deep step it loads A fragments with ldmatrix.x4 and B
// fragments with ldmatrix.x4.trans (B is row-major (K, N), the mma wants
// it column-major), then issues mma.sync.m16n8k16 bf16 x bf16 -> f32 into
// 64 (32) float32 accumulators a thread.
//
// The variants, both with grid (m, n), n fastest: consecutive blocks
// share the A tile in L2 (the TPU's m-outer order).
//   cur    the epilogue stages the f32 accumulator tile in shared memory
//          (as acc_ref does; 69632 B, dynamic shared memory), then each
//          thread reads 8 floats, rounds them and writes 16 bytes: rows
//          of Y go out in full sectors.
//   noacc  the accumulator registers are rounded to bf16 pairs and stored
//          straight from the fragments (4 bytes a thread, 16 bytes a row
//          per warp store).
// The kernel template keeps the (n, m) order (N_OUTER) it was written
// with; no entry point launches it that way any more.
//
// Rounding: products of bf16 are exact in f32; the tensor cores sum them
// in f32 in their own order, and __floats2bfloat162_rn rounds to nearest
// even, as .to(torch.bfloat16) does. Two f32 summation orders differ by a
// bf16 ulp in a few elements: callers hold Y to the float64 product, not
// to another order bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int WM = BM / WARPS_M;  // 64 rows a warp
constexpr int MT = WM / 16;       // m16 tiles a warp
constexpr int STAGES = 2;
constexpr int A_LD = BK + 8;      // bf16 pitch of an A row: 80 bytes
constexpr int A_STAGE = BM * A_LD;

template <int BN>
struct Tile {
  static constexpr int WN = BN / WARPS_N;  // 32 or 16 columns a warp
  static constexpr int NT = WN / 8;        // n8 tiles a warp (even)
  static constexpr int B_LD = BN + 8;      // bf16 pitch of a B row
  static constexpr int B_STAGE = BK * B_LD;
  static constexpr int PIPE_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
  static constexpr int C_LD = BN + 8;      // f32 pitch of the staged tile
  static constexpr int STAGED_BYTES = BM * C_LD * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a (16 x 16, row) . b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Problem {
  const bf16* a;
  const bf16* b;
  bf16* y;
  int m, n, k;
  int tiles_m, tiles_n;
};

// Issue the copies of k-slice [k0, k0 + BK) of the tile at (m0, n0).
template <int BN>
__device__ __forceinline__ void load_slice(const Problem& p, bf16* as,
                                           bf16* bs, int m0, int n0,
                                           int k0) {
  constexpr int A_CHUNKS = BM * BK / 8;
  constexpr int B_CHUNKS = BK * BN / 8;
#pragma unroll
  for (int c = threadIdx.x; c < A_CHUNKS; c += THREADS) {
    const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    const int gr = m0 + r, gk = k0 + kc;
    const bool ok = gr < p.m && gk < p.k;
    cp_async16(as + r * A_LD + kc,
               ok ? p.a + (size_t)gr * p.k + gk : p.a, ok);
  }
#pragma unroll
  for (int c = threadIdx.x; c < B_CHUNKS; c += THREADS) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const int gk = k0 + r, gn = n0 + nc;
    const bool ok = gk < p.k && gn < p.n;
    cp_async16(bs + r * Tile<BN>::B_LD + nc,
               ok ? p.b + (size_t)gk * p.n + gn : p.b, ok);
  }
}

// acc += the warp's piece of A-slice . B-slice, both in shared memory.
template <int BN>
__device__ __forceinline__ void mma_slice(
    float (&acc)[MT][Tile<BN>::NT][4], const bf16* as, const bf16* bs,
    int warp_m, int warp_n, int lane) {
  constexpr int NT = Tile<BN>::NT;
  constexpr int B_LD = Tile<BN>::B_LD;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      // lanes 0-15: rows 0-15 at column kk; lanes 16-31: at kk + 8
      ldmatrix_x4(a[mt], as + (warp_m * WM + mt * 16 + (lane & 15)) * A_LD +
                             kk + (lane >> 4) * 8);
    uint32_t b[NT][2];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // lanes 0-15: k rows kk..kk+15 at column n; lanes 16-31: at n + 8;
      // .trans hands each thread (k = 2 * (lane % 4) + {0, 1}, n = lane /
      // 4), the col-major B fragment
      uint32_t r[4];
      ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * B_LD +
                               warp_n * Tile<BN>::WN + np * 16 +
                               (lane >> 4) * 8);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// Round the accumulators to bf16 pairs and store them from the fragments:
// c0, c1 at (row g, columns 2t, 2t + 1), c2, c3 at row g + 8, with g =
// lane / 4, t = lane % 4.
template <int BN>
__device__ __forceinline__ void store_direct(
    const Problem& p, float (&acc)[MT][Tile<BN>::NT][4], int m0, int n0,
    int warp_m, int warp_n, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = m0 + warp_m * WM + mt * 16 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < Tile<BN>::NT; ++nt) {
      const int col = n0 + warp_n * Tile<BN>::WN + nt * 8 + (lane & 3) * 2;
      if (col >= p.n) continue;
      if (row < p.m)
        *reinterpret_cast<__nv_bfloat162*>(p.y + (size_t)row * p.n + col) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < p.m)
        *reinterpret_cast<__nv_bfloat162*>(p.y + (size_t)(row + 8) * p.n +
                                           col) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// Stage the f32 tile in shared memory (over the drained ring), then write
// Y in 16-byte row chunks. A thread of an odd chunk reads its second
// float4 first, which spreads a warp's reads over all bank groups.
template <int BN>
__device__ __forceinline__ void store_staged(
    const Problem& p, float (&acc)[MT][Tile<BN>::NT][4], float* cs, int m0,
    int n0, int warp_m, int warp_n, int lane) {
  constexpr int C_LD = Tile<BN>::C_LD;
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = warp_m * WM + mt * 16 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < Tile<BN>::NT; ++nt) {
      const int c = warp_n * Tile<BN>::WN + nt * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(cs + r * C_LD + c) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(cs + (r + 8) * C_LD + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
  constexpr int CH = BN / 8;  // 16-byte chunks of a Y row
#pragma unroll
  for (int c = threadIdx.x; c < BM * CH; c += THREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    const int gr = m0 + r, gc = n0 + cc;
    if (gr >= p.m || gc >= p.n) continue;
    const int h = (c & 1) * 4;
    const float4 first =
        *reinterpret_cast<const float4*>(cs + r * C_LD + cc + h);
    const float4 second =
        *reinterpret_cast<const float4*>(cs + r * C_LD + cc + (h ^ 4));
    const float4 lo = h ? second : first, hi = h ? first : second;
    *reinterpret_cast<uint4*>(p.y + (size_t)gr * p.n + gc) =
        make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                   pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
  }
}

// cur (STAGED, m outer), noacc (m outer), ws (N_OUTER): one block a tile.
template <int BN, bool STAGED, bool N_OUTER>
__global__ void __launch_bounds__(THREADS, 2)
    matmul_tile_kernel(Problem p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + STAGES * A_STAGE;
  const int t = blockIdx.x;
  const int tm = N_OUTER ? t % p.tiles_m : t / p.tiles_n;
  const int tn = N_OUTER ? t / p.tiles_m : t % p.tiles_n;
  const int m0 = tm * BM, n0 = tn * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  float acc[MT][Tile<BN>::NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Tile<BN>::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const int kt = (p.k + BK - 1) / BK;
  load_slice<BN>(p, as, bs, m0, n0, 0);
  cp_async_commit();
  for (int s = 0; s < kt; ++s) {
    cp_async_wait_all();
    __syncthreads();  // slice s landed; every warp is done with s - 1
    if (s + 1 < kt)
      load_slice<BN>(p, as + ((s + 1) & 1) * A_STAGE,
                     bs + ((s + 1) & 1) * Tile<BN>::B_STAGE, m0, n0,
                     (s + 1) * BK);
    cp_async_commit();
    mma_slice<BN>(acc, as + (s & 1) * A_STAGE,
                  bs + (s & 1) * Tile<BN>::B_STAGE, warp_m, warp_n, lane);
  }
  if (STAGED)
    store_staged<BN>(p, acc, reinterpret_cast<float*>(smem), m0, n0, warp_m,
                     warp_n, lane);
  else
    store_direct<BN>(p, acc, m0, n0, warp_m, warp_n, lane);
}

enum Variant { CUR, NOACC };

constexpr int MAX_DEVICES = 64;

// Once for each kernel instance and device: the dynamic shared-memory
// attribute (above 48 KB it has to be asked for, or the launch is
// refused).
template <int BN>
cudaError_t setup(Variant v, void (*kernel)(Problem), int smem, int dev) {
  static std::atomic<bool> done[2][MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[v][dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) done[v][dev].store(true, std::memory_order_release);
  return e;
}

template <int BN>
cudaError_t launch(Variant v, Problem p, cudaStream_t s) {
  p.tiles_m = (p.m + BM - 1) / BM;
  p.tiles_n = (p.n + BN - 1) / BN;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  void (*kernel)(Problem);
  int smem = Tile<BN>::PIPE_BYTES;
  if (v == CUR) {
    kernel = matmul_tile_kernel<BN, true, false>;
    if (Tile<BN>::STAGED_BYTES > smem) smem = Tile<BN>::STAGED_BYTES;
  } else {
    kernel = matmul_tile_kernel<BN, false, false>;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = setup<BN>(v, kernel, smem, dev)) != cudaSuccess) return e;
  kernel<<<(unsigned)tiles, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

int run(Variant v, const void* a, const void* b, void* y, int m, int n,
        int k, void* stream) {
  if (m < 0 || n < 0 || k < 1 || n % 8 != 0 || k % 8 != 0)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  Problem p{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
            static_cast<bf16*>(y), m, n, k, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n <= 64 ? launch<64>(v, p, s) : launch<128>(v, p, s);
}

}  // namespace

// a (m, k), b (k, n), y (m, n): bf16, contiguous, 16-byte aligned; k and
// n multiples of 8, k >= 1. Each returns the cudaError_t of its launch.
extern "C" int mx_matmul_cur(const void* a, const void* b, void* y, int m,
                             int n, int k, void* stream) {
  return run(CUR, a, b, y, m, n, k, stream);
}

extern "C" int mx_matmul_noacc(const void* a, const void* b, void* y, int m,
                               int n, int k, void* stream) {
  return run(NOACC, a, b, y, m, n, k, stream);
}
