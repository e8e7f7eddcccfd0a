// bf16 <-> float32 for the AMP instances of the kernels (Hopper, sm_90a).
//
// A bf16 is the top half of a float32, so widening is exact: a shift.
// Narrowing rounds once, to nearest even (__floats2bfloat162_rn), as
// PyTorch's .to(torch.bfloat16) does. A kernel's bf16 instance widens its
// inputs as it loads them and keeps the float32 instance's arithmetic, so
// it is bitwise that instance on the widened inputs, rounded.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mx_bf16 {

// the 8 bf16 of a 16-byte word (element 2k in the low half of word k) as
// 8 floats
__device__ __forceinline__ void widen8(uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

// two floats as one word of two bf16, each rounded to nearest even
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 consecutive bf16 at p (16-byte aligned) as floats: one 16-byte load
// of data read once, the read-only path with no L1 line (as cp.async.cg
// bypasses L1 for the float32 instances)
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&f)[8]) {
  uint4 w;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
      : "l"(p));
  widen8(w, f);
}

}  // namespace mx_bf16
