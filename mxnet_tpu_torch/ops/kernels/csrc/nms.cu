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
// What bounds it on the H100: neither bytes nor operations, but the
// dependence chain. The work is at most n_iter x N IoUs of ~16 flops
// (0.76 GFLOP for 16 images of 7378 boxes at n_iter 400: 0.01 ms at
// 67 TFLOP/s) over ~22 bytes a box (3.6 MB: 1 us at 3.35 TB/s); but
// iteration i needs keep[i] after every earlier iteration, so one image
// is n_iter steps in sequence, each a barrier and a pass over its boxes.
//
// Design. One block of 512 threads per image, all images in one launch.
// The TPU kernel keeps the packed (8, Npad) rows in VMEM and extracts box
// i by one-hot sums because it cannot index lanes dynamically; here each
// thread holds PER = ceil(N / 512) candidate boxes (x1, y1, x2, y2, area,
// class, and a keep bit) in registers, strided (box j lives in thread
// j % 512, so every thread has work until the end), and reads box i
// straight from device memory, a broadcast load that L1 serves. The keep
// bits also live in shared memory (one byte a box) so that every thread
// can read keep[i]: one barrier a step makes it final, and a suppressed
// i skips the step uniformly. A thread clears only its own boxes' bits,
// so there are no atomics. PER is a template parameter (1-16): at most
// 8192 boxes an image; the wrapper raises above.
//
// Rounding. The IoU uses explicitly rounded intrinsics (__fsub_rn,
// __fmul_rn, __fadd_rn, __fdiv_rn), which nvcc never contracts into an
// FMA, in the TPU kernel's order ((area + a_i) - inter) + 1e-12: every
// step rounds once, as the plain PyTorch version's separate ops do, so
// the keep masks are bitwise equal to it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_PER = 16;

// torch.maximum / torch.minimum: NaN if either is NaN (fmaxf / fminf
// would return the other operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

template <int PER, bool CLS>
__global__ void __launch_bounds__(THREADS)
nms_keep_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ cls, uint8_t* __restrict__ keep,
                int n, int n_iter, float thresh) {
  __shared__ uint8_t keep_s[THREADS * PER];
  const int t = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * n;
  const float4* bx = boxes + base;
  float x1[PER], y1[PER], x2[PER], y2[PER], area[PER], cid[PER];
  unsigned kb = 0;  // bit k: keep bit of box t + k * THREADS
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = t + k * THREADS;
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    float c = 0.f;
    if (j < n) {
      b = bx[j];
      if (CLS) c = cls[base + j];
      const uint8_t v = valid[base + j] != 0;
      keep_s[j] = v;
      kb |= (unsigned)v << k;
    }
    x1[k] = b.x;
    y1[k] = b.y;
    x2[k] = b.z;
    y2[k] = b.w;
    area[k] = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
    cid[k] = c;
  }
  for (int i = 0; i < n_iter; ++i) {
    // keep[i] is final: every earlier step (and the initialisation above)
    // has ended
    __syncthreads();
    if (!keep_s[i]) continue;  // the same for every thread
    const float4 bi = bx[i];
    const float ci = CLS ? cls[base + i] : 0.f;
    const float ai = __fmul_rn(__fsub_rn(bi.z, bi.x), __fsub_rn(bi.w, bi.y));
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = t + k * THREADS;
      if (j <= i || !((kb >> k) & 1u)) continue;
      if (CLS && cid[k] != ci) continue;
      const float iw = max_nan(__fsub_rn(min_nan(x2[k], bi.z),
                                         max_nan(x1[k], bi.x)), 0.f);
      const float ih = max_nan(__fsub_rn(min_nan(y2[k], bi.w),
                                         max_nan(y1[k], bi.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float den =
          __fadd_rn(__fsub_rn(__fadd_rn(area[k], ai), inter), 1e-12f);
      if (__fdiv_rn(inter, den) > thresh) {
        kb &= ~(1u << k);
        keep_s[j] = 0;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = t + k * THREADS;
    if (j < n) keep[base + j] = (uint8_t)((kb >> k) & 1u);
  }
}

template <int PER>
void launch(bool class_aware, unsigned grid, cudaStream_t s,
            const float4* b, const uint8_t* v, const float* c, uint8_t* k,
            int n, int n_iter, float thresh) {
  if (class_aware)
    nms_keep_kernel<PER, true><<<grid, THREADS, 0, s>>>(b, v, c, k, n,
                                                         n_iter, thresh);
  else
    nms_keep_kernel<PER, false><<<grid, THREADS, 0, s>>>(b, v, c, k, n,
                                                          n_iter, thresh);
}

}  // namespace

// boxes (batch, n, 4) float32 corner boxes sorted by descending score,
// 16-byte aligned; valid (batch, n) uint8; cls (batch, n) float32 or null
// (class-agnostic); keep (batch, n) uint8, written. One block an image.
extern "C" int mx_nms_keep(const void* boxes, const void* valid,
                           const void* cls, void* keep, int batch, int n,
                           int n_iter, float thresh, void* stream) {
  if (batch == 0 || n == 0) return cudaSuccess;
  if (batch < 0 || n < 0 || n > THREADS * MAX_PER || n_iter < 0 ||
      n_iter > n)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b = static_cast<const float4*>(boxes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* c = static_cast<const float*>(cls);
  uint8_t* k = static_cast<uint8_t*>(keep);
  const bool aware = c != nullptr;
  const unsigned grid = (unsigned)batch;
  if (n <= THREADS)
    launch<1>(aware, grid, s, b, v, c, k, n, n_iter, thresh);
  else if (n <= 2 * THREADS)
    launch<2>(aware, grid, s, b, v, c, k, n, n_iter, thresh);
  else if (n <= 4 * THREADS)
    launch<4>(aware, grid, s, b, v, c, k, n, n_iter, thresh);
  else if (n <= 8 * THREADS)
    launch<8>(aware, grid, s, b, v, c, k, n, n_iter, thresh);
  else
    launch<16>(aware, grid, s, b, v, c, k, n, n_iter, thresh);
  return cudaGetLastError();
}
