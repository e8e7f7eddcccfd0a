// Greedy non-maximum suppression keep mask for Hopper (sm_90a), float32.
//
// Replaces: _nms_kernel (mxnet_tpu/ops/pallas/nms.py:29, called through
// _nms_call :69 and greedy_nms_keep :85), the sequential core of box_nms
// and of SSD's MultiBoxDetection. For each image, over boxes already
// sorted by descending score:
//
//   keep = valid
//   for i in [0, n_iter):          n_iter = N, or min(topk, N)
//     if keep[i]:
//       for j > i with keep[j] (and cls[j] == cls[i] when class-aware):
//         inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
//         iou   = inter / (((area[j] + area[i]) - inter) + 1e-12)
//         if iou > thresh: keep[j] = 0
//
// Boxes past position n_iter never suppress, but stay kept when valid:
// the TPU kernel's rule, kept on purpose. max and min propagate NaN, as
// jnp.maximum / jnp.minimum do, so a box with a NaN coordinate neither
// suppresses nor is suppressed, and inf coordinates follow IEEE
// arithmetic, as in the JAX package (its kernel, run by the Pallas
// interpreter, extracts box i exactly).
//
// What bounds it on the H100: by count, the IoUs, at most n_iter x N of
// ~16 flops (0.76 GFLOP for 16 images of 7378 boxes at n_iter 400: 0.01
// ms at 67 TFLOP/s) over ~22 bytes a box (3.6 MB: 1 us at 3.35 TB/s);
// and the walk's order. Whether box i suppresses box j does not depend on
// the walk; only whether box i is still kept does. So the work splits in
// three launches, only the middle one a chain:
//   * nms_keep_mask_kernel, fully parallel: a block of 64 threads for
//     each (image, 64-row block of i < n_iter, 64-column block at or
//     right of it); thread i tests its row box against the block's 64
//     column boxes (staged in shared memory) and writes one 64-bit word,
//     bit j set iff j > i, the classes match and iou > thresh. Words are
//     stored column block major, mask[b][word][i], so a block's stores
//     are one coalesced run. A box with a NaN coordinate gets a NaN
//     class key, which no key equals (its IoU would be NaN, never above
//     thresh); when thresh >= 0 a pair that does not overlap in both x
//     and y sets no bit (its IoU is 0 or NaN), so the clamps and the
//     division run only for overlapping boxes. Otherwise every
//     expression is the walk's, in its order, in explicitly rounded
//     intrinsics (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn), which nvcc
//     never contracts into an FMA: each step rounds once, as the plain
//     PyTorch version's separate ops do;
//   * nms_keep_scan_kernel, the ordered walk, a block of 256 threads an
//     image (at most 8192 boxes, 128 words, an image: the wrapper raises
//     above). The walk over 64-row block rb needs only word column rb of
//     the mask, rows 0 .. 64 rb + 63 (contiguous in the column-major
//     layout), so the next two columns come into shared memory by
//     cp.async while block rb is walked. The threads OR together the
//     column's words of the kept rows of the earlier blocks (the removed
//     bits of word rb so far); then thread 0 walks the block's 64 rows in
//     order on that one word, box i kept iff valid and its bit not
//     removed, OR-ing in its diagonal word. Box i's test is the walk's:
//     every earlier kept box has removed what it removes before step i.
//     It writes the rows' kept bits and the walked words' removed bits;
//   * nms_keep_finish_kernel, parallel again, a warp a 64-box word: a word
//     the walk finished takes its removed bits, a word right of the walked
//     rows ORs its column over the kept rows; then keep = valid &
//     ~removed, a byte a box.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int WORD = 64;            // boxes a mask word
constexpr int MAX_WORDS = 128;      // 8192 boxes an image
constexpr int SCAN_THREADS = 256;
constexpr int RING = 3;             // mask columns in flight in the walk

// torch.maximum: NaN if either is NaN (fmaxf would return the other)
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// the class id (0 when class-agnostic), or NaN for a box with a NaN
// coordinate: keys compare equal only between NaN-free boxes, for which
// fminf / fmaxf are the NaN-propagating min / max
__device__ __forceinline__ float box_key(float4 b, float c) {
  const bool nan = b.x != b.x || b.y != b.y || b.z != b.z || b.w != b.w;
  return nan ? __int_as_float(0x7fc00000) : c;
}

template <bool CLS>
__global__ void __launch_bounds__(WORD)
nms_keep_mask_kernel(const float4* __restrict__ boxes,
                     const float* __restrict__ cls, u64* __restrict__ mask,
                     int n, int n_iter, int words, float thresh) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  if (cb < rb) return;  // every bit there would have j < i
  __shared__ float4 cbox[WORD];
  __shared__ float2 cak[WORD];  // area, key
  const int t = threadIdx.x;
  const size_t base = (size_t)blockIdx.z * n;
  const int j0 = cb * WORD;
  if (j0 + t < n) {
    const float4 b = boxes[base + j0 + t];
    cbox[t] = b;
    cak[t] = make_float2(box_area(b),
                         box_key(b, CLS ? cls[base + j0 + t] : 0.f));
  }
  __syncthreads();
  const int i = rb * WORD + t;
  if (i >= n_iter) return;
  const float4 bi = boxes[base + i];
  const float ai = box_area(bi);
  const float ki = box_key(bi, CLS ? cls[base + i] : 0.f);
  const int ncol = min(WORD, n - j0);
  u64 word = 0;
  if (!(thresh < 0.f)) {
    // a pair that does not overlap in x or y (dx or dy <= 0 or NaN) has
    // inter 0 or NaN, so 0 / den or NaN, never above a thresh >= 0 (nor
    // a NaN one); where both are > 0 the clamps are the identity
#pragma unroll 4
    for (int k = 0; k < ncol; ++k) {
      const float4 bj = cbox[k];
      const float2 ak = cak[k];
      const float dx = __fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x));
      const float dy = __fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y));
      if (ak.y == ki && dx > 0.f && dy > 0.f) {
        const float inter = __fmul_rn(dx, dy);
        const float den =
            __fadd_rn(__fsub_rn(__fadd_rn(ak.x, ai), inter), 1e-12f);
        if (__fdiv_rn(inter, den) > thresh) word |= 1ull << k;
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < ncol; ++k) {
      const float4 bj = cbox[k];
      const float2 ak = cak[k];
      const float iw =
          max_nan(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 0.f);
      const float ih =
          max_nan(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float den =
          __fadd_rn(__fsub_rn(__fadd_rn(ak.x, ai), inter), 1e-12f);
      if (ak.y == ki && __fdiv_rn(inter, den) > thresh) word |= 1ull << k;
    }
  }
  if (cb == rb) word &= t == WORD - 1 ? 0ull : ~0ull << (t + 1);  // j > i
  mask[((size_t)blockIdx.z * words + cb) * n_iter + i] = word;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but this thread's RING - 1 newest groups of copies have landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1) : "memory");
}

__device__ __forceinline__ u64 warp_or(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(~0u, v, o);
  return v;
}

// mask word column c, rows [0, min(64 (c + 1), n_iter)): every row that
// can set a bit in word c
__device__ __forceinline__ void stage_column(u64* buf, const u64* mb, int c,
                                             int n_iter) {
  const int rows = min(WORD * (c + 1), n_iter);
  const u64* src = mb + (size_t)c * n_iter;
  for (int i = threadIdx.x; i < rows; i += SCAN_THREADS)
    cp_async8(buf + i, src + i);
}

// The ordered walk of one image over its n_iter rows; writes the kept
// bits of the rows and the final removed bits of words [0, blocks).
__global__ void __launch_bounds__(SCAN_THREADS)
nms_keep_scan_kernel(const u64* __restrict__ mask,
                     const uint8_t* __restrict__ valid,
                     u64* __restrict__ state, int n, int n_iter, int words) {
  extern __shared__ __align__(16) u64 sbuf[];  // [RING][n_iter]: columns
  __shared__ u64 vw[MAX_WORDS];   // valid bits of the rows walked
  __shared__ u64 kw[MAX_WORDS];   // kept bits of the rows walked
  __shared__ u64 part[SCAN_THREADS / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t base = (size_t)blockIdx.x * n;
  const u64* mb = mask + (size_t)blockIdx.x * words * n_iter;
  u64* kept_out = state + (size_t)blockIdx.x * 2 * MAX_WORDS;
  u64* removed_out = kept_out + MAX_WORDS;
  const int blocks = (n_iter + WORD - 1) / WORD;

#pragma unroll
  for (int c = 0; c < RING - 1; ++c) {
    if (c < blocks) stage_column(sbuf + c * n_iter, mb, c, n_iter);
    cp_async_commit();
  }
  if (t < blocks) {  // valid word t: its 64 loads in flight at once
    const uint8_t* vp = valid + base + t * WORD;
    const int len = min(WORD, n - t * WORD);
    u64 v = 0;
#pragma unroll
    for (int k = 0; k < WORD; ++k)
      if (k < len && vp[k]) v |= 1ull << k;
    vw[t] = v;
  }
  for (int rb = 0; rb < blocks; ++rb) {
    const int ahead = rb + RING - 1;
    if (ahead < blocks)
      stage_column(sbuf + (ahead % RING) * n_iter, mb, ahead, n_iter);
    cp_async_commit();
    cp_async_wait_ring();  // column rb is in (this thread's copies)
    __syncthreads();       // ... every thread's; vw, kw of earlier blocks
    const u64* col = sbuf + (rb % RING) * n_iter;
    // word rb as the kept rows of the earlier blocks leave it
    u64 acc = 0;
    for (int i = t; i < rb * WORD; i += SCAN_THREADS)
      acc |= (kw[i / WORD] >> (i % WORD) & 1) ? col[i] : 0ull;
    acc = warp_or(acc);
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (t == 0) {
      u64 gone = 0;
#pragma unroll
      for (int w = 0; w < SCAN_THREADS / 32; ++w) gone |= part[w];
      const int rows = min(WORD, n_iter - rb * WORD);
      const u64 cand = vw[rb] & (rows == WORD ? ~0ull : (1ull << rows) - 1);
      const u64* diag = col + rb * WORD;
      u64 kept = 0;
#pragma unroll
      for (int k = 0; k < WORD; ++k) {
        const u64 d = k < rows ? diag[k] : 0ull;  // off the chain
        const bool take = (cand >> k & 1) && !(gone >> k & 1);
        kept |= take ? 1ull << k : 0ull;
        gone |= take ? d : 0ull;
      }
      kw[rb] = kept;
      kept_out[rb] = kept;
      removed_out[rb] = gone;
    }
    __syncthreads();  // the column is read: a later stage may refill it
  }
}

// keep = valid & ~removed for 64-box words, a warp a word: the words the
// walk finished, and the others OR-ed over the kept rows of their column.
__global__ void __launch_bounds__(SCAN_THREADS)
nms_keep_finish_kernel(const u64* __restrict__ mask,
                       const uint8_t* __restrict__ valid,
                       const u64* __restrict__ state,
                       uint8_t* __restrict__ keep, int n, int n_iter,
                       int words) {
  __shared__ u64 kw[MAX_WORDS];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = blockIdx.x * (SCAN_THREADS / 32) + (t >> 5);
  const int blocks = (n_iter + WORD - 1) / WORD;
  const u64* kept_in = state + (size_t)blockIdx.y * 2 * MAX_WORDS;
  if (t < blocks) kw[t] = kept_in[t];
  __syncthreads();
  if (w >= words) return;
  u64 removed;
  if (w < blocks) {
    removed = kept_in[MAX_WORDS + w];
  } else {
    const u64* colw = mask + ((size_t)blockIdx.y * words + w) * n_iter;
    u64 acc = 0;
#pragma unroll 8
    for (int i = lane; i < n_iter; i += 32)
      acc |= (kw[i / WORD] >> (i % WORD) & 1) ? colw[i] : 0ull;
    removed = warp_or(acc);
  }
  const size_t base = (size_t)blockIdx.y * n;
#pragma unroll
  for (int k = lane; k < WORD; k += 32) {
    const int j = w * WORD + k;
    if (j < n)
      keep[base + j] = (uint8_t)(valid[base + j] && !(removed >> k & 1));
  }
}

size_t scan_smem_bytes(int n_iter) {
  return RING * (size_t)n_iter * sizeof(u64);
}

}  // namespace

// boxes (batch, n, 4) float32 corner boxes sorted by descending score,
// 16-byte aligned; valid (batch, n) uint8; cls (batch, n) float32 or null
// (class-agnostic); keep (batch, n) uint8, written; mask scratch of
// batch * (ceil(n / 64) * n_iter + 256) 64-bit words: the mask words
// (batch, ceil(n / 64), n_iter), then each image's kept and removed words.
// The mask, walk and finish kernels run in order on the stream.
extern "C" int mx_nms_keep(const void* boxes, const void* valid,
                           const void* cls, void* keep, void* mask,
                           int batch, int n, int n_iter, float thresh,
                           void* stream) {
  if (batch < 0 || n < 0 || n > WORD * MAX_WORDS || n_iter < 0 ||
      n_iter > n || batch > 65535)
    return cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n + WORD - 1) / WORD;
  const int blocks = (n_iter + WORD - 1) / WORD;
  u64* m = static_cast<u64*>(mask);
  u64* state = m + (size_t)batch * words * n_iter;
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  cudaError_t err = cudaSuccess;
  if (blocks > 0) {
    const dim3 grid((unsigned)words, (unsigned)blocks, (unsigned)batch);
    const float4* b = static_cast<const float4*>(boxes);
    const float* c = static_cast<const float*>(cls);
    if (c != nullptr)
      nms_keep_mask_kernel<true><<<grid, WORD, 0, s>>>(b, c, m, n, n_iter,
                                                       words, thresh);
    else
      nms_keep_mask_kernel<false><<<grid, WORD, 0, s>>>(b, c, m, n, n_iter,
                                                        words, thresh);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    // the shared-memory attribute once per device, at the most rows
    static bool attr_set[64] = {};
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!attr_set[dev]) {
      err = cudaFuncSetAttribute(nms_keep_scan_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)scan_smem_bytes(WORD * MAX_WORDS));
      if (err != cudaSuccess) return err;
      attr_set[dev] = true;
    }
    nms_keep_scan_kernel<<<(unsigned)batch, SCAN_THREADS,
                           scan_smem_bytes(n_iter), s>>>(m, v, state, n,
                                                         n_iter, words);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    const dim3 grid((unsigned)((words + SCAN_THREADS / 32 - 1) /
                               (SCAN_THREADS / 32)),
                    (unsigned)batch);
    nms_keep_finish_kernel<<<grid, SCAN_THREADS, 0, s>>>(
        m, v, state, static_cast<uint8_t*>(keep), n, n_iter, words);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
