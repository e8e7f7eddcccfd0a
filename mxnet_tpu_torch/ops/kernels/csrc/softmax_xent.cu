// Fused softmax + cross-entropy head for Hopper (sm_90a), float32:
// forward and backward.
//
// Replaces: mxnet_tpu_softmax_xent_fwd (mxnet_tpu/ops/pallas/xent.py:37)
// and mxnet_tpu_softmax_xent_bwd (xent.py:49), the loss head of every
// training step with SoftmaxCrossEntropyLoss (BERT's MLM head at V 30522
// and its NSP head at V 2).
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
// Design. One block of 256 threads per row, the rows in parallel (the TPU
// kernel took 8-row blocks in a sequential grid). The forward reads its
// row twice: once for a running (max, exp-sum) per thread, merged across
// the block with warp shuffles, and once to write logp; so it moves 1.5x
// its bound's bytes rather than the 2x of a separate max pass. Loads are
// scalar and coalesced: a row of odd V is not 16-byte aligned. V = 2 (the
// NSP head) takes the same path with 254 idle threads. Every output
// element is written by one thread: no atomics.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// merge (m2, z2) into (m, z): z sums exp(x - m) over its elements
__device__ __forceinline__ void merge(float& m, float& z, float m2,
                                      float z2) {
  const float mn = fmaxf(m, m2);
  if (mn == -CUDART_INF_F) return;  // both empty
  z = z * expf(m - mn) + z2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(THREADS)
softmax_xent_fwd_kernel(const float* __restrict__ x,
                        const int* __restrict__ labels,
                        float* __restrict__ nll, float* __restrict__ logp,
                        int v) {
  __shared__ float wm[WARPS], wz[WARPS];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const float* xr = x + (size_t)r * v;
  float* lr = logp + (size_t)r * v;

  float m = -CUDART_INF_F, z = 0.f;
  for (int c = t; c < v; c += THREADS) {
    const float xv = xr[c];
    if (xv > m) {
      z = z * expf(m - xv) + 1.f;  // exp(-inf) == 0 on the first element
      m = xv;
    } else {
      z += expf(xv - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, z, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, z, off));
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
    const float lp = (xr[c] - m) - logz;
    lr[c] = lp;
    if (c == lab) nll[r] = -lp;
  }
  if (!hit && t == 0) nll[r] = 0.f;
}

__global__ void __launch_bounds__(THREADS)
softmax_xent_bwd_kernel(const float* __restrict__ logp,
                        const int* __restrict__ labels,
                        const float* __restrict__ g, float* __restrict__ dx,
                        int v) {
  const int r = blockIdx.x;
  const int lab = labels[r];
  const float gr = g[r];
  const float* lr = logp + (size_t)r * v;
  float* dr = dx + (size_t)r * v;
  for (int c = threadIdx.x; c < v; c += THREADS)
    dr[c] = gr * (expf(lr[c]) - (c == lab ? 1.f : 0.f));
}

}  // namespace

// ---- host entry points ----
// logits / logp / dx (rows, V), labels (rows,) int32, nll / g (rows,);
// all contiguous on the device, float32 unless stated. Each returns the
// cudaError_t of its launch.
extern "C" int mx_softmax_xent_fwd(const void* logits, const void* labels,
                                   void* nll, void* logp, int rows, int v,
                                   void* stream) {
  if (rows == 0 || v == 0) return cudaSuccess;
  softmax_xent_fwd_kernel<<<rows, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels),
      static_cast<float*>(nll), static_cast<float*>(logp), v);
  return cudaGetLastError();
}

extern "C" int mx_softmax_xent_bwd(const void* logp, const void* labels,
                                   const void* g, void* dx, int rows, int v,
                                   void* stream) {
  if (rows == 0 || v == 0) return cudaSuccess;
  softmax_xent_bwd_kernel<<<rows, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logp), static_cast<const int*>(labels),
      static_cast<const float*>(g), static_cast<float*>(dx), v);
  return cudaGetLastError();
}
