// Elementwise epilogue kernels for Hopper (sm_90a), float32 and bf16: the BatchNorm
// apply (+ activation) forward and backward, the activation forward and
// its save-output backward, and the residual add (+ activation).
//
// Replaces, in mxnet_tpu/ops/pallas/epilogue.py:
//   mxnet_tpu_bn_act_fwd  (:124)  out = act((x - mean[c]) * scale[c] + beta[c])
//   mxnet_tpu_bn_act_bwd  (:136)  dx  = g * act'(out) * scale[c]
//   mxnet_tpu_act_fwd     (:234)  out = act(x)
//   mxnet_tpu_act_bwd     (:239)  dx  = g * act'(out)
//   mxnet_tpu_add_act_fwd (:297)  out = act(x + y)
// act' is computed from the OUTPUT alone (the save-output residual
// contract of ops/nn.py _act_core), for the covered set: identity, relu,
// sigmoid, tanh, softrelu, softsign, leaky (slope > 0).
//
// What bounds them on the H100: bytes. Each does a few flops per element
// against 8-12 bytes moved; the ResNet-50 step runs ~1.36 G elements
// through bn_act_fwd alone, 3.2 ms at 3.35 TB/s.
//
// Design. The TPU kernels flatten to (rows, 128) tiles padded to 256-row
// blocks in VMEM, with the per-channel coefficients broadcast into
// (rows, 1) columns. None of that is carried over: every kernel walks
// the n elements unpadded.
//
// The BN apply and the activation forward and backward are 16-byte
// streams (csrc/stream.cuh: one float4 of each input a thread, one block
// a tile, evict-first stores from the L2's size on), partitioned by
// epilogue.py epilogue_geometry; the entry points refuse tiles that do
// not match n.
//
// The BN apply's channel, (i / inner) % C, costs two divisions by
// runtime values, some 15-20 integer instructions each. The host turns
// inner and C into multiply-high divisors (Divisor, Channels), a vector
// divides its first index only, and its other elements step from there;
// a multiply-high division of every element measured no slower
// (tools/probe_epilogue_variants.py per_elem): the loads in flight, not
// the channel, set the time.
//
// The float32 add+act kernel still walks the elements in one grid-stride
// loop of coalesced 4-byte loads, 256 threads a block, on grid_for's grid.
//
// Every kernel also takes bf16 activations (AMP and net.cast('bfloat16');
// the reference kernels' contract, epilogue.py:26-27, 124-142, 234-244,
// 297-299): each element widens to float exactly, the activation, the BN
// apply and their gradients run in float32 with the same expressions as
// the float32 instances, and the result rounds to bf16 once, to nearest
// even. So a bf16 instance is bitwise the float32 instance on the widened
// inputs, rounded. The BN apply's per-channel scale, mean and beta stay
// float32, as the reference passes them. The bf16 instances are streams
// with 8 elements a 16-byte vector (stream<VEC_BF16>), add+act's too.
//
// The activation is a template parameter, so each instance is
// straight-line code. Indices are 32-bit (Idx): a tensor of more than
// INT32_MAX elements is refused (the wrappers raise first).
//
// Rounding. (x - mean) * scale + beta and x + y use explicitly rounded
// intrinsics (__fsub_rn, __fmul_rn, __fadd_rn), which nvcc never
// contracts into an FMA: every arithmetic step rounds once, as the plain
// PyTorch versions' separate ops do, so identity, relu, leaky, add+relu
// and the BN apply (and all the backward rules built from products and
// compares) are bitwise equal to them. The backward is the product
// g * act'(out), not a select, so a NaN in g stays NaN where out <= 0,
// as in the plain version. The transcendental activations use expf /
// tanhf / log1pf (full-precision, no fast-math) and agree to a couple of
// ulps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream.cuh"

using namespace mx_stream;

namespace {

enum Act {
  IDENTITY = 0,
  RELU = 1,
  SIGMOID = 2,
  TANH = 3,
  SOFTRELU = 4,
  SOFTSIGN = 5,
  LEAKY = 6
};

template <int A>
__device__ __forceinline__ float act_fwd(float x, float slope) {
  if (A == RELU) return x < 0.f ? 0.f : x;  // NaN propagates
  if (A == SIGMOID) return 1.f / __fadd_rn(1.f, expf(-x));
  if (A == TANH) return tanhf(x);
  // softplus as logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|))
  if (A == SOFTRELU) return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
  if (A == SOFTSIGN) return x / __fadd_rn(fabsf(x), 1.f);
  if (A == LEAKY) return x >= 0.f ? x : __fmul_rn(slope, x);
  return x;  // IDENTITY
}

// d act / d x from the output alone
template <int A>
__device__ __forceinline__ float act_grad(float out, float slope) {
  if (A == RELU) return out > 0.f ? 1.f : 0.f;
  if (A == SIGMOID) return __fmul_rn(out, __fsub_rn(1.f, out));
  if (A == TANH) return __fsub_rn(1.f, __fmul_rn(out, out));
  if (A == SOFTRELU) return __fsub_rn(1.f, expf(-out));
  if (A == SOFTSIGN) {
    const float a = __fsub_rn(1.f, fabsf(out));
    return __fmul_rn(a, a);
  }
  if (A == LEAKY) return out >= 0.f ? 1.f : slope;
  return 1.f;  // IDENTITY
}

template <int A, bool EVICT>
struct ActFwd {
  const float* x;
  float* out;
  float slope;
  struct In {
    float4 a;
  };
  __device__ __forceinline__ In load(Idx i) const { return {load4(x + i)}; }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    store4<EVICT>(out + i, make_float4(act_fwd<A>(v.a.x, slope),
                                       act_fwd<A>(v.a.y, slope),
                                       act_fwd<A>(v.a.z, slope),
                                       act_fwd<A>(v.a.w, slope)));
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    out[i] = act_fwd<A>(x[i], slope);
  }
};

template <int A, bool EVICT>
struct ActBwd {
  const float* g;
  const float* out;
  float* dx;
  float slope;
  struct In {
    float4 a, o;  // g, out
  };
  __device__ __forceinline__ In load(Idx i) const {
    return {load4(g + i), load4(out + i)};
  }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    store4<EVICT>(dx + i,
                  make_float4(__fmul_rn(v.a.x, act_grad<A>(v.o.x, slope)),
                              __fmul_rn(v.a.y, act_grad<A>(v.o.y, slope)),
                              __fmul_rn(v.a.z, act_grad<A>(v.o.z, slope)),
                              __fmul_rn(v.a.w, act_grad<A>(v.o.w, slope))));
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    dx[i] = __fmul_rn(g[i], act_grad<A>(out[i], slope));
  }
};

// bf16: one 16-byte vector of 8 elements of each input a thread
template <int A, bool EVICT>
struct ActFwdBf16 {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  float slope;
  struct In {
    float a[VEC_BF16];
  };
  __device__ __forceinline__ In load(Idx i) const {
    In v;
    load8(x + i, v.a);
    return v;
  }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    float y[VEC_BF16];
#pragma unroll
    for (int e = 0; e < VEC_BF16; ++e) y[e] = act_fwd<A>(v.a[e], slope);
    store8<EVICT>(out + i, y);
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    out[i] = __float2bfloat16_rn(act_fwd<A>(__bfloat162float(x[i]), slope));
  }
};

template <int A, bool EVICT>
struct ActBwdBf16 {
  const __nv_bfloat16* g;
  const __nv_bfloat16* out;
  __nv_bfloat16* dx;
  float slope;
  struct In {
    float a[VEC_BF16], o[VEC_BF16];  // g, out
  };
  __device__ __forceinline__ In load(Idx i) const {
    In v;
    load8(g + i, v.a);
    load8(out + i, v.o);
    return v;
  }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    float d[VEC_BF16];
#pragma unroll
    for (int e = 0; e < VEC_BF16; ++e)
      d[e] = __fmul_rn(v.a[e], act_grad<A>(v.o[e], slope));
    store8<EVICT>(dx + i, d);
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    dx[i] = __float2bfloat16_rn(__fmul_rn(
        __bfloat162float(g[i]), act_grad<A>(__bfloat162float(out[i]), slope)));
  }
};

template <int A, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_act_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             __nv_bfloat16* __restrict__ out, Idx n,
                             Idx tiles, float slope) {
  stream<VEC_BF16>(ActFwdBf16<A, EVICT>{x, out, slope}, n, tiles);
}

template <int A, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_act_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                             const __nv_bfloat16* __restrict__ out,
                             __nv_bfloat16* __restrict__ dx, Idx n,
                             Idx tiles, float slope) {
  stream<VEC_BF16>(ActBwdBf16<A, EVICT>{g, out, dx, slope}, n, tiles);
}

template <int A, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_act_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
                        Idx n, Idx tiles, float slope) {
  stream(ActFwd<A, EVICT>{x, out, slope}, n, tiles);
}

template <int A, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_act_bwd_kernel(const float* __restrict__ g,
                        const float* __restrict__ out,
                        float* __restrict__ dx, Idx n, Idx tiles,
                        float slope) {
  stream(ActBwd<A, EVICT>{g, out, dx, slope}, n, tiles);
}

// Where element i of x, (outer, C, inner) around the BN axis, lies: its
// channel (i / inner) % C and its offset r in the channel's run of inner
// elements, by two divisions of the first element of a vector; the next
// element steps from there.
struct Channels {
  Divisor inner, c;
  __device__ __forceinline__ Idx at(Idx i, Idx& r) const {
    const Idx q = inner.div(i);
    r = i - q * inner.d;
    return q - c.div(q) * c.d;
  }
  // (ch, r) of element i + 1 from those of element i: a run ends at
  // inner, and the channel after C - 1 is 0 (the next outer index)
  __device__ __forceinline__ void step(Idx& ch, Idx& r) const {
    if (++r == inner.d) {
      r = 0;
      ch = ch + 1 == c.d ? 0 : ch + 1;
    }
  }
};

// one coefficient of a (C,) vector: the read-only path, with an L1 line
// (each is read by every vector of its channel)
__device__ __forceinline__ float coef(const float* p, Idx ch) {
  return __ldg(p + ch);
}

template <int A>
__device__ __forceinline__ float bn_fwd(float x, float s, float m, float b,
                                        float slope) {
  return act_fwd<A>(__fadd_rn(__fmul_rn(__fsub_rn(x, m), s), b), slope);
}

template <int A>
__device__ __forceinline__ float bn_bwd(float g, float o, float s,
                                        float slope) {
  return __fmul_rn(__fmul_rn(g, act_grad<A>(o, slope)), s);
}

// The BN apply's stream: a vector finds the channel of its first element
// by division, and each further element steps from the one before (inner
// < 4 crosses more than one run in a vector, and C - 1 wraps to 0).
template <int A, bool EVICT>
struct BnFwd {
  const float* x;
  const float* scale;
  const float* mean;
  const float* beta;
  float* out;
  Channels chans;
  float slope;
  struct In {
    float4 a;
    Idx ch, r;
  };
  __device__ __forceinline__ In load(Idx i) const {
    In v;
    v.a = load4(x + i);
    v.ch = chans.at(i, v.r);
    return v;
  }
  __device__ __forceinline__ float one(float xi, Idx ch) const {
    return bn_fwd<A>(xi, coef(scale, ch), coef(mean, ch), coef(beta, ch),
                     slope);
  }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    float4 y;
    Idx ch = v.ch, r = v.r;
    y.x = one(v.a.x, ch);
    chans.step(ch, r);
    y.y = one(v.a.y, ch);
    chans.step(ch, r);
    y.z = one(v.a.z, ch);
    chans.step(ch, r);
    y.w = one(v.a.w, ch);
    store4<EVICT>(out + i, y);
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    Idx r;
    out[i] = one(x[i], chans.at(i, r));
  }
};

template <int A, bool EVICT>
struct BnBwd {
  const float* g;
  const float* out;
  const float* scale;
  float* dx;
  Channels chans;
  float slope;
  struct In {
    float4 a, o;  // g, out
    Idx ch, r;
  };
  __device__ __forceinline__ In load(Idx i) const {
    In v;
    v.a = load4(g + i);
    // identity's derivative is 1: its backward never reads the output
    v.o = A == IDENTITY ? make_float4(0.f, 0.f, 0.f, 0.f) : load4(out + i);
    v.ch = chans.at(i, v.r);
    return v;
  }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    float4 d;
    Idx ch = v.ch, r = v.r;
    d.x = bn_bwd<A>(v.a.x, v.o.x, coef(scale, ch), slope);
    chans.step(ch, r);
    d.y = bn_bwd<A>(v.a.y, v.o.y, coef(scale, ch), slope);
    chans.step(ch, r);
    d.z = bn_bwd<A>(v.a.z, v.o.z, coef(scale, ch), slope);
    chans.step(ch, r);
    d.w = bn_bwd<A>(v.a.w, v.o.w, coef(scale, ch), slope);
    store4<EVICT>(dx + i, d);
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    Idx r;
    dx[i] = bn_bwd<A>(g[i], A == IDENTITY ? 0.f : out[i],
                      coef(scale, chans.at(i, r)), slope);
  }
};

template <int A, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_bn_act_fwd_kernel(const float* __restrict__ x,
                           const float* __restrict__ scale,
                           const float* __restrict__ mean,
                           const float* __restrict__ beta,
                           float* __restrict__ out, Idx n, Idx tiles,
                           Channels chans, float slope) {
  stream(BnFwd<A, EVICT>{x, scale, mean, beta, out, chans, slope}, n,
         tiles);
}

template <int A, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_bn_act_bwd_kernel(const float* __restrict__ g,
                           const float* __restrict__ out,
                           const float* __restrict__ scale,
                           float* __restrict__ dx, Idx n, Idx tiles,
                           Channels chans, float slope) {
  stream(BnBwd<A, EVICT>{g, out, scale, dx, chans, slope}, n, tiles);
}

// bf16: x (or g and out) and the result bf16, 8 elements a vector, the
// coefficients float32; each further element of a vector steps from the
// one before (inner < 8 crosses more than one run)
template <int A, bool EVICT>
struct BnFwdBf16 {
  const __nv_bfloat16* x;
  const float* scale;
  const float* mean;
  const float* beta;
  __nv_bfloat16* out;
  Channels chans;
  float slope;
  struct In {
    float a[VEC_BF16];
    Idx ch, r;
  };
  __device__ __forceinline__ In load(Idx i) const {
    In v;
    load8(x + i, v.a);
    v.ch = chans.at(i, v.r);
    return v;
  }
  __device__ __forceinline__ float one(float xi, Idx ch) const {
    return bn_fwd<A>(xi, coef(scale, ch), coef(mean, ch), coef(beta, ch),
                     slope);
  }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    float y[VEC_BF16];
    Idx ch = v.ch, r = v.r;
#pragma unroll
    for (int e = 0; e < VEC_BF16; ++e) {
      if (e) chans.step(ch, r);
      y[e] = one(v.a[e], ch);
    }
    store8<EVICT>(out + i, y);
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    Idx r;
    out[i] = __float2bfloat16_rn(one(__bfloat162float(x[i]), chans.at(i, r)));
  }
};

template <int A, bool EVICT>
struct BnBwdBf16 {
  const __nv_bfloat16* g;
  const __nv_bfloat16* out;
  const float* scale;
  __nv_bfloat16* dx;
  Channels chans;
  float slope;
  struct In {
    float a[VEC_BF16], o[VEC_BF16];  // g, out
    Idx ch, r;
  };
  __device__ __forceinline__ In load(Idx i) const {
    In v;
    load8(g + i, v.a);
    // identity's derivative is 1: its backward never reads the output
    if (A == IDENTITY) {
#pragma unroll
      for (int e = 0; e < VEC_BF16; ++e) v.o[e] = 0.f;
    } else {
      load8(out + i, v.o);
    }
    v.ch = chans.at(i, v.r);
    return v;
  }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    float d[VEC_BF16];
    Idx ch = v.ch, r = v.r;
#pragma unroll
    for (int e = 0; e < VEC_BF16; ++e) {
      if (e) chans.step(ch, r);
      d[e] = bn_bwd<A>(v.a[e], v.o[e], coef(scale, ch), slope);
    }
    store8<EVICT>(dx + i, d);
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    Idx r;
    dx[i] = __float2bfloat16_rn(bn_bwd<A>(
        __bfloat162float(g[i]),
        A == IDENTITY ? 0.f : __bfloat162float(out[i]),
        coef(scale, chans.at(i, r)), slope));
  }
};

template <int A, bool EVICT>
struct AddActFwdBf16 {
  const __nv_bfloat16* x;
  const __nv_bfloat16* y;
  __nv_bfloat16* out;
  float slope;
  struct In {
    float a[VEC_BF16], b[VEC_BF16];
  };
  __device__ __forceinline__ In load(Idx i) const {
    In v;
    load8(x + i, v.a);
    load8(y + i, v.b);
    return v;
  }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    float o[VEC_BF16];
#pragma unroll
    for (int e = 0; e < VEC_BF16; ++e)
      o[e] = act_fwd<A>(__fadd_rn(v.a[e], v.b[e]), slope);
    store8<EVICT>(out + i, o);
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    out[i] = __float2bfloat16_rn(act_fwd<A>(
        __fadd_rn(__bfloat162float(x[i]), __bfloat162float(y[i])), slope));
  }
};

template <int A, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_bn_act_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                const float* __restrict__ scale,
                                const float* __restrict__ mean,
                                const float* __restrict__ beta,
                                __nv_bfloat16* __restrict__ out, Idx n,
                                Idx tiles, Channels chans, float slope) {
  stream<VEC_BF16>(
      BnFwdBf16<A, EVICT>{x, scale, mean, beta, out, chans, slope}, n, tiles);
}

template <int A, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_bn_act_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                                const __nv_bfloat16* __restrict__ out,
                                const float* __restrict__ scale,
                                __nv_bfloat16* __restrict__ dx, Idx n,
                                Idx tiles, Channels chans, float slope) {
  stream<VEC_BF16>(BnBwdBf16<A, EVICT>{g, out, scale, dx, chans, slope}, n,
                   tiles);
}

template <int A, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_add_act_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ y,
                                 __nv_bfloat16* __restrict__ out, Idx n,
                                 Idx tiles, float slope) {
  stream<VEC_BF16>(AddActFwdBf16<A, EVICT>{x, y, out, slope}, n, tiles);
}

template <int A>
__global__ void __launch_bounds__(THREADS)
epilogue_add_act_fwd_kernel(const float* __restrict__ x,
                            const float* __restrict__ y,
                            float* __restrict__ out, Idx n, float slope) {
  const Idx stride = (Idx)gridDim.x * THREADS;
  for (Idx i = (Idx)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    out[i] = act_fwd<A>(__fadd_rn(x[i], y[i]), slope);
}

// blocks for n elements: one element per thread up to 8 blocks of 256
// threads on every SM (2048 threads, the SM's limit), then the
// grid-stride loop takes the rest
unsigned grid_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;  // the H100 SXM
  }
  const long long want = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * 8;
  return (unsigned)(want < cap ? want : cap);
}

// run the launch (the variadic argument) with the activation code bound
// to a compile-time constant A; an unknown code is an error of the caller
#define MX_ACT_DISPATCH(act, ...)                                     \
  switch (act) {                                                      \
    case IDENTITY: { constexpr int A = IDENTITY; __VA_ARGS__; break; } \
    case RELU:     { constexpr int A = RELU;     __VA_ARGS__; break; } \
    case SIGMOID:  { constexpr int A = SIGMOID;  __VA_ARGS__; break; } \
    case TANH:     { constexpr int A = TANH;     __VA_ARGS__; break; } \
    case SOFTRELU: { constexpr int A = SOFTRELU; __VA_ARGS__; break; } \
    case SOFTSIGN: { constexpr int A = SOFTSIGN; __VA_ARGS__; break; } \
    case LEAKY:    { constexpr int A = LEAKY;    __VA_ARGS__; break; } \
    default: return cudaErrorInvalidValue;                            \
  }

// the same with the store kind bound to a compile-time constant E
#define MX_EVICT_DISPATCH(evict, ...)                                  \
  if (evict) {                                                         \
    constexpr bool E = true;                                           \
    __VA_ARGS__;                                                       \
  } else {                                                             \
    constexpr bool E = false;                                          \
    __VA_ARGS__;                                                       \
  }

// the BN apply's grid, the stream's at V elements a vector, with chans
// filled from the divisors of inner and c; 0 when one is refused, or
// `tiles` is not n's
template <int V = VEC>
unsigned bn_grid(long long n, long long c, long long inner,
                 unsigned inner_mul, int inner_shift, unsigned c_mul,
                 int c_shift, long long tiles, Channels& chans) {
  if (!divisor(inner, inner_mul, inner_shift, chans.inner) ||
      !divisor(c, c_mul, c_shift, chans.c))
    return 0;
  return stream_grid<V>(n, tiles);
}

}  // namespace

// ---- host entry points ----
// Every tensor is float32 (the *_bf16 entries: see there), contiguous,
// 16-byte aligned, on the device. n
// is the element count, at most INT32_MAX; for the BN kernels x is
// (outer, C, inner) around the BN axis and scale / mean / beta are (C,).
// act is the Act code above, slope the leaky slope. Each returns the
// cudaError_t of its launch.
// The BN entry points: c and inner as above, (inner_mul, inner_shift)
// and (c_mul, c_shift) their divisors (epilogue.py bn_geometry), evict
// and tiles as for the activation kernels below.
extern "C" int mx_bn_act_fwd(const void* x, const void* scale,
                             const void* mean, const void* beta, void* out,
                             long long n, long long c, long long inner,
                             unsigned inner_mul, int inner_shift,
                             unsigned c_mul, int c_shift, int act,
                             float slope, int evict, long long tiles,
                             void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  Channels ch;
  const unsigned grid = bn_grid(n, c, inner, inner_mul, inner_shift, c_mul,
                                c_shift, tiles, ch);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* mp = static_cast<const float*>(mean);
  const float* bp = static_cast<const float*>(beta);
  float* op = static_cast<float*>(out);
  MX_ACT_DISPATCH(act, MX_EVICT_DISPATCH(
      evict, epilogue_bn_act_fwd_kernel<A, E><<<grid, THREADS, 0, s>>>(
                 xp, sp, mp, bp, op, (Idx)n, (Idx)tiles, ch, slope)));
  return cudaGetLastError();
}

extern "C" int mx_bn_act_bwd(const void* g, const void* out,
                             const void* scale, void* dx, long long n,
                             long long c, long long inner,
                             unsigned inner_mul, int inner_shift,
                             unsigned c_mul, int c_shift, int act,
                             float slope, int evict, long long tiles,
                             void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  Channels ch;
  const unsigned grid = bn_grid(n, c, inner, inner_mul, inner_shift, c_mul,
                                c_shift, tiles, ch);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* op = static_cast<const float*>(out);
  const float* sp = static_cast<const float*>(scale);
  float* dp = static_cast<float*>(dx);
  MX_ACT_DISPATCH(act, MX_EVICT_DISPATCH(
      evict, epilogue_bn_act_bwd_kernel<A, E><<<grid, THREADS, 0, s>>>(
                 gp, op, sp, dp, (Idx)n, (Idx)tiles, ch, slope)));
  return cudaGetLastError();
}

// evict (0 or 1): evict-first stores; tiles: n / (THREADS * VEC), the
// whole tiles of the stream's partition of n
extern "C" int mx_act_fwd(const void* x, void* out, long long n, int act,
                          float slope, int evict, long long tiles,
                          void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned grid = stream_grid(n, tiles);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  MX_ACT_DISPATCH(act, MX_EVICT_DISPATCH(
      evict, epilogue_act_fwd_kernel<A, E><<<grid, THREADS, 0, s>>>(
                 xp, op, (Idx)n, (Idx)tiles, slope)));
  return cudaGetLastError();
}

extern "C" int mx_act_bwd(const void* g, const void* out, void* dx,
                          long long n, int act, float slope, int evict,
                          long long tiles, void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned grid = stream_grid(n, tiles);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* op = static_cast<const float*>(out);
  float* dp = static_cast<float*>(dx);
  MX_ACT_DISPATCH(act, MX_EVICT_DISPATCH(
      evict, epilogue_act_bwd_kernel<A, E><<<grid, THREADS, 0, s>>>(
                 gp, op, dp, (Idx)n, (Idx)tiles, slope)));
  return cudaGetLastError();
}

// The bf16 instances of mx_act_fwd / mx_act_bwd: every tensor bf16,
// tiles n / (THREADS * VEC_BF16) (epilogue.py epilogue_geometry at 2 bytes
// an element), evict from an output of the L2's size in bytes.
extern "C" int mx_act_fwd_bf16(const void* x, void* out, long long n,
                               int act, float slope, int evict,
                               long long tiles, void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned grid = stream_grid<VEC_BF16>(n, tiles);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* op = static_cast<__nv_bfloat16*>(out);
  MX_ACT_DISPATCH(act, MX_EVICT_DISPATCH(
      evict, epilogue_act_fwd_bf16_kernel<A, E><<<grid, THREADS, 0, s>>>(
                 xp, op, (Idx)n, (Idx)tiles, slope)));
  return cudaGetLastError();
}

extern "C" int mx_act_bwd_bf16(const void* g, const void* out, void* dx,
                               long long n, int act, float slope, int evict,
                               long long tiles, void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned grid = stream_grid<VEC_BF16>(n, tiles);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* op = static_cast<const __nv_bfloat16*>(out);
  auto* dp = static_cast<__nv_bfloat16*>(dx);
  MX_ACT_DISPATCH(act, MX_EVICT_DISPATCH(
      evict, epilogue_act_bwd_bf16_kernel<A, E><<<grid, THREADS, 0, s>>>(
                 gp, op, dp, (Idx)n, (Idx)tiles, slope)));
  return cudaGetLastError();
}

extern "C" int mx_add_act_fwd(const void* x, const void* y, void* out,
                              long long n, int act, float slope,
                              void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n);
  const float* xp = static_cast<const float*>(x);
  const float* yp = static_cast<const float*>(y);
  float* op = static_cast<float*>(out);
  MX_ACT_DISPATCH(act, epilogue_add_act_fwd_kernel<A><<<grid, THREADS, 0, s>>>(
                           xp, yp, op, (Idx)n, slope));
  return cudaGetLastError();
}

// The bf16 instances of mx_bn_act_fwd / mx_bn_act_bwd / mx_add_act_fwd:
// x, y, g, out and dx bf16, scale / mean / beta float32; tiles n /
// (THREADS * VEC_BF16) (epilogue.py epilogue_geometry at 2 bytes an
// element), evict from an output of the L2's size in bytes.
extern "C" int mx_bn_act_fwd_bf16(const void* x, const void* scale,
                                  const void* mean, const void* beta,
                                  void* out, long long n, long long c,
                                  long long inner, unsigned inner_mul,
                                  int inner_shift, unsigned c_mul,
                                  int c_shift, int act, float slope,
                                  int evict, long long tiles, void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  Channels ch;
  const unsigned grid = bn_grid<VEC_BF16>(n, c, inner, inner_mul,
                                          inner_shift, c_mul, c_shift, tiles,
                                          ch);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* mp = static_cast<const float*>(mean);
  const float* bp = static_cast<const float*>(beta);
  auto* op = static_cast<__nv_bfloat16*>(out);
  MX_ACT_DISPATCH(act, MX_EVICT_DISPATCH(
      evict, epilogue_bn_act_fwd_bf16_kernel<A, E><<<grid, THREADS, 0, s>>>(
                 xp, sp, mp, bp, op, (Idx)n, (Idx)tiles, ch, slope)));
  return cudaGetLastError();
}

extern "C" int mx_bn_act_bwd_bf16(const void* g, const void* out,
                                  const void* scale, void* dx, long long n,
                                  long long c, long long inner,
                                  unsigned inner_mul, int inner_shift,
                                  unsigned c_mul, int c_shift, int act,
                                  float slope, int evict, long long tiles,
                                  void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  Channels ch;
  const unsigned grid = bn_grid<VEC_BF16>(n, c, inner, inner_mul,
                                          inner_shift, c_mul, c_shift, tiles,
                                          ch);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* op = static_cast<const __nv_bfloat16*>(out);
  const float* sp = static_cast<const float*>(scale);
  auto* dp = static_cast<__nv_bfloat16*>(dx);
  MX_ACT_DISPATCH(act, MX_EVICT_DISPATCH(
      evict, epilogue_bn_act_bwd_bf16_kernel<A, E><<<grid, THREADS, 0, s>>>(
                 gp, op, sp, dp, (Idx)n, (Idx)tiles, ch, slope)));
  return cudaGetLastError();
}

extern "C" int mx_add_act_fwd_bf16(const void* x, const void* y, void* out,
                                   long long n, int act, float slope,
                                   int evict, long long tiles,
                                   void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned grid = stream_grid<VEC_BF16>(n, tiles);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* yp = static_cast<const __nv_bfloat16*>(y);
  auto* op = static_cast<__nv_bfloat16*>(out);
  MX_ACT_DISPATCH(act, MX_EVICT_DISPATCH(
      evict, epilogue_add_act_fwd_bf16_kernel<A, E><<<grid, THREADS, 0, s>>>(
                 xp, yp, op, (Idx)n, (Idx)tiles, slope)));
  return cudaGetLastError();
}
