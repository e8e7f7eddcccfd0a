// Online-softmax arithmetic shared by the flash-prefill and flash-decode
// kernels: the CUDA spelling of online_softmax_block
// (mxnet_tpu/ops/pallas/attention.py:81).
//
// Decode bit-identity: both kernels walk the key axis from 0 in fixed
// K_BLOCK steps and combine each tile with exactly these expressions, in
// this order, with explicitly rounded intrinsics so that the compiler
// cannot contract them differently in the two kernels:
//   score    s_j = sum_d (q_d * scale) * k_jd      (one chain of fmas,
//            sequential over d from 0, whichever thread runs it: the
//            decode kernel's tile_score, the prefill kernel's register
//            micro-tiles)
//   rescale  m' = max(m, max_j s_j); safe = m' or 0 if -inf;
//            corr = m == -inf ? 0 : exp(m - safe)
//   weights  p_j = s_j == -inf ? 0 : exp(s_j - safe)
//   l'       = l * corr + (sum_j p_j)              (sequential over j)
//   acc'_d   = (acc_d * corr) + p_0 v_0d + p_1 v_1d + ...  (sequential fma
//            over the tile's keys in order)
// A masked key has s = -inf and contributes exactly 0.0, and a tile wholly
// past a row's last visible key leaves (m, l, acc) bit-for-bit unchanged
// (corr == 1, p == 0), so either kernel may skip such tiles.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace mx {

constexpr int K_BLOCK = 128;

template <int D>
__device__ __forceinline__ float tile_score(const float* qs, const float* k) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = __fmaf_rn(qs[d], k[d], s);
  return s;
}

// Fold the tile's score maximum into the running max m; returns the
// shift used for this tile's weights (safe_m) and the factor (corr) that
// rescales the carried l and acc.
// The exponentials are taken unconditionally and the -inf case selected
// after (expf(-inf) is 0 as well): the same values as the guarded form, but
// a thread's weights are then independent instructions the scheduler can
// interleave, not one branch each.
__device__ __forceinline__ void rescale(float& m, float tile_max,
                                        float& safe_m, float& corr) {
  const float m_new = fmaxf(m, tile_max);
  safe_m = (m_new == -CUDART_INF_F) ? 0.f : m_new;
  const float e = expf(__fsub_rn(m, safe_m));
  corr = (m == -CUDART_INF_F) ? 0.f : e;
  m = m_new;
}

__device__ __forceinline__ float weight(float s, float safe_m) {
  const float e = expf(__fsub_rn(s, safe_m));
  return (s == -CUDART_INF_F) ? 0.f : e;
}

// Normalised output and log-sum-exp of a finished row (the fully-masked
// row gives 0 and -inf, as the TPU kernel's guards do).
__device__ __forceinline__ float finish_out(float acc, float l) {
  return __fdiv_rn(acc, fmaxf(l, 1e-20f));
}

__device__ __forceinline__ float finish_lse(float m, float l) {
  const float safe_m = (m == -CUDART_INF_F) ? 0.f : m;
  return l > 0.f ? __fadd_rn(safe_m, logf(fmaxf(l, 1e-20f)))
                 : -CUDART_INF_F;
}

}  // namespace mx
