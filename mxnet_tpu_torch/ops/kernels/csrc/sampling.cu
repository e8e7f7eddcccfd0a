// The sampler's noise: one gumbel draw a (row, column) from a threefry2x32
// key a row, as the reference's ``jax.random.gumbel(key, (V,))`` draws
// them under each row's key (mxnet_tpu/serving/decode/sampling.py:121-123).
//
// No Pallas kernel computes this: it stands for the XLA fusion of the
// reference's noise, as csrc/multi_tensor_update.cu stands for its traced
// update. The bits are JAX's, integer for integer: column j of a row draws
// threefry2x32(key, (0, j)) and XORs the two output words
// (jax/_src/prng.py _threefry_random_bits_partitionable, with
// jax_threefry_partitionable on), 20 rounds with the key injected every
// four; the uniform keeps the top 23 bits as a mantissa in [1, 2), minus
// 1, clamped to [tiny, 1) (jax/_src/random.py uniform); the gumbel is
// -log(-log(u)) (random.py _gumbel) with the correctly rounded logf, not
// __logf, so it lies within an ULP or two of torch.log's.
//
// One thread a (row, column): the work is ~125 integer operations and two
// logarithms an element against 4 bytes written, so it is bound by
// operations, and at the decode step's 8 x 30522 draws by its launch. Each
// thread reads its row's two key words through the read-only cache. With
// ``uniform`` set the kernel writes u instead of the gumbel value, which
// the card check holds bitwise against the plain version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr float TINY = 1.17549435e-38f;   // finfo(float32).tiny

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  const int rot[4] = {r0, r1, r2, r3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x0 += x1;
    x1 = __funnelshift_l(x1, x1, rot[i]);
    x1 ^= x0;
  }
}

__global__ void threefry_gumbel_kernel(const uint32_t* __restrict__ keys,
                                       float* __restrict__ out, int v,
                                       int uniform) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= v) return;
  const int row = blockIdx.y;
  const uint32_t k0 = __ldg(keys + 2 * row);
  const uint32_t k1 = __ldg(keys + 2 * row + 1);
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  uint32_t x0 = 0u + k0;
  uint32_t x1 = static_cast<uint32_t>(col) + k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
  const uint32_t bits = x0 ^ x1;
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(f + TINY, TINY);
  out[static_cast<size_t>(row) * v + col] =
      uniform ? u : -logf(-logf(u));
}

}  // namespace

extern "C" int mx_threefry_gumbel(const void* keys, void* out, int rows,
                                  int v, int uniform, void* stream) {
  if (rows == 0 || v == 0) return 0;
  const dim3 grid((v + THREADS - 1) / THREADS, rows);
  threefry_gumbel_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<float*>(out), v,
      uniform);
  return static_cast<int>(cudaGetLastError());
}
