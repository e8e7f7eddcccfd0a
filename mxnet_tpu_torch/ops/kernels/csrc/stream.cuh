// The 16-byte stream of the elementwise kernels for Hopper (sm_90a),
// float32, shared by csrc/epilogue.cu (the BN apply and the activation
// forward and backward) and csrc/softmax_xent.cu (the xent backward).
//
// DRAM latency times 3.35 TB/s asks for 15-20 KB of loads in flight on
// every SM, and a grid-stride loop of one 4-byte load a thread, whose
// i < n guard keeps the next load from issuing early, keeps at most 8 KB
// (16 KB for two inputs). Here a block takes one tile of THREADS x VEC
// floats: each thread one float4 load of each input (ld.global.nc, no L1
// allocation: every byte is read once), then one float4 store, with no
// guard; with 8 blocks an SM that is 32 KB of loads in flight (64 KB for
// two inputs). Two or four vectors a thread and a persistent grid
// measured no faster (tools/probe_epilogue_variants.py builds them). An
// output of at least the L2's size, which cannot stay there, is stored
// evict-first (st.global.cs, EVICT), measured 1-3 % faster; a smaller
// one is stored normally, faster for it, and stays in L2 for the layer
// that reads it next. One block past the whole tiles takes the rest:
// whole vectors, fewer than a tile, then the n % 4 scalars. The
// partition (EVICT, tiles) comes from epilogue.py epilogue_geometry; the
// entry points refuse tiles that do not match n (stream_grid).
//
// Indices are 32-bit (Idx): n is at most INT32_MAX, so no index formed
// (i + stride, a tile past the last) wraps; a larger tensor is refused,
// or launched in pieces (xent.py xent_bwd_geometry).
//
// An Op of the stream holds the kernel's pointers and gives
//   In load(Idx i)                 the inputs of the vector at i,
//   void store(Idx i, const In&)   its output,
//   void scalar(Idx i)             element i alone (the tail).
//
// bf16 (the instances of the epilogue kernels on bf16 activations, and
// the xent backward's bf16 dlogits): a 16-byte vector is
// VEC_BF16 = 8 elements, so a tile is THREADS x 8 and the tail n % 8
// (stream<VEC_BF16>, stream_grid<VEC_BF16>). load8 widens the 8 bf16 of a
// vector to float exactly (a shift), store8 rounds 8 floats to bf16 once,
// to nearest even (bf16.cuh): arithmetic in float32 between.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace mx_stream {

constexpr int THREADS = 256;
constexpr int VEC = 4;  // floats in a 16-byte vector
constexpr int TILE = THREADS * VEC;  // the stream's floats a block
constexpr int VEC_BF16 = 8;  // bf16 elements in a 16-byte vector
using Idx = uint32_t;

// one 16-byte load of an input read once: the read-only path, no L1 line
__device__ __forceinline__ float4 load4(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// one 16-byte store; EVICT: streaming (st.global.cs), evicted first
template <bool EVICT>
__device__ __forceinline__ void store4(float* p, float4 v) {
  if (EVICT)
    __stcs(reinterpret_cast<float4*>(p), v);
  else
    *reinterpret_cast<float4*>(p) = v;
}

using mx_bf16::load8;  // the 8 bf16 of a vector of an input, as floats

// 8 floats rounded to bf16 into one 16-byte store (EVICT as store4)
template <bool EVICT>
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&f)[VEC_BF16]) {
  using mx_bf16::pack2;
  const uint4 v = make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                             pack2(f[4], f[5]), pack2(f[6], f[7]));
  if (EVICT)
    __stcs(reinterpret_cast<uint4*>(p), v);
  else
    *reinterpret_cast<uint4*>(p) = v;
}

// op over n elements, V of them a 16-byte vector (VEC floats, VEC_BF16
// bf16): block b < tiles takes tile b, one vector of each input a thread;
// block `tiles`, where n is not a whole number of tiles, the whole vectors
// past them and the n % V scalars
template <int V = VEC, class Op>
__device__ __forceinline__ void stream(const Op& op, Idx n, Idx tiles) {
  const Idx i = (Idx)blockIdx.x * (THREADS * V) + threadIdx.x * V;
  if (blockIdx.x < tiles) {
    op.store(i, op.load(i));
    return;
  }
  const Idx whole = n & ~(Idx)(V - 1);
  if (i < whole) op.store(i, op.load(i));
  if (whole + threadIdx.x < n) op.scalar(whole + threadIdx.x);
}

// A divisor d in [1, 2^31) as a multiply-high (Granlund-Montgomery, as
// CUTLASS's FastDivmod): for d >= 2, l = ceil(log2 d), mul = ceil(2^(31 +
// l) / d) < 2^32 and shift = l - 1, and i / d = umulhi(i, mul) >> shift
// for every i < 2^31; d = 1 has mul 0 and i / 1 = i. The host computes
// mul and shift (epilogue.py fast_divisor, held there to exact division).
struct Divisor {
  Idx d, mul, shift;
  __device__ __forceinline__ Idx div(Idx i) const {
    return mul ? __umulhi(i, mul) >> shift : i;
  }
};

// the Divisor of d from the host's (mul, shift); false when d is not in
// [1, 2^31) or the shift is not one a 32-bit quotient takes
inline bool divisor(long long d, unsigned mul, int shift, Divisor& out) {
  out = {(Idx)d, (Idx)mul, (Idx)shift};
  return d >= 1 && d <= INT32_MAX && shift >= 0 && shift < 32;
}

// the stream's grid (epilogue.py epilogue_geometry) at V elements a
// vector: one block a whole tile, one more for the rest; 0 when `tiles`
// is not n's
template <int V = VEC>
inline unsigned stream_grid(long long n, long long tiles) {
  constexpr long long tile = (long long)THREADS * V;
  if (tiles != n / tile) return 0;
  return (unsigned)(tiles + (n % tile != 0));
}

}  // namespace mx_stream
