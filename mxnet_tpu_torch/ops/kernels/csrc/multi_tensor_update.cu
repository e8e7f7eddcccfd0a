// The whole-model optimizer update for Hopper (sm_90a): one launch applies
// one optimizer's rule to every tensor of a list.
//
// Replaces the XLA fusion of the reference's traced update
// (mxnet_tpu/optimizer/fused.py:119-147 over ops/optimizer_ops.py), which
// ParallelTrainer compiles into its one program; on the port's eager step
// it takes the place of one chain of about 12 elementwise launches a
// parameter (optimizer/fused.py, ops/kernels/multi_tensor.py).
//
// Instances: RULE x FORM. The rules are the reference's fusable
// optimizers (optimizer/optimizer.py): SGD without and with momentum,
// AdamW, Adam, NAG without and with momentum, Signum's signsgd (momentum
// 0) and signum, FTML, DCASGD without and with momentum, AdaGrad,
// RMSProp plain and centered (rmspropalex), AdaDelta, Ftrl, Adamax and
// Test. The forms:
//   F32     float32 weight, gradient and state;
//   LOW     bf16 weight, gradient and state, no master (a net after
//           cast('bfloat16') without multi_precision): SGD, SGD with
//           momentum and AdamW only;
//   MASTER  bf16 weight and gradient, float32 master and state
//           (multi_precision): the master is updated, the weight is the
//           master rounded (it is written, never read).
//
// The list. The host (multi_tensor.py pack_table) writes one Entry a
// tensor: its pointers (weight, gradient, up to three states, master),
// its length, its first chunk and its float32 hyperparameters (a: the lr,
// or the rule's per-tensor factor; wd; b: the rule's second per-tensor
// factor), and ships the table in one asynchronous copy from a pinned
// buffer each step, since the gradients are new tensors each step. A
// tensor is cut into chunks of CHUNK elements; chunk0 is the prefix sum
// of the chunks before it. Block b takes chunk b: it finds its tensor by
// a binary search over chunk0 (the last entry whose chunk0 <= b) and its
// offset (b - chunk0) * CHUNK. Each thread takes VEC = 8 consecutive
// elements UNROLL times: one 16-byte load of each bf16 input, two of each
// float32 one, where every pointer of the tensor is 16-byte aligned (flag
// VECTOR) and the 8 lie inside the tensor; else the elements one by one
// (the tail). A null gradient reads as zeros (a parameter the loss does
// not reach).
//
// Rounding. Every float32 operation is one explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc
// never contracts into an FMA, in the order of the plain PyTorch ops
// (optimizer/optimizer.py and ops/optimizer_ops.py): each op of the plain
// version rounds once, and so does each step here, so the kernel is
// bitwise its plain version. sign, abs, the clamps, the NaN-propagating
// maximum and the select are exact, as torch's are. The host converts
// each Python scalar where PyTorch converts it: a scalar multiplying a
// float32 tensor is the double rounded to float32 (so 1 - beta1 is formed
// in double, then rounded); a per-tensor factor (Adam's bias-corrected
// lr, FTML's (1 - beta1^t) / lr and 1 - beta2^t, Adamax's lr / (1 -
// beta1^t), Signum's 1 - lr wd_lh) is formed in double on the host, as
// the plain loop forms it, then rounded; a division by a scalar (FTML's
// and Ftrl's) is a true division on both sides (the plain ops divide by
// a 0-dim float32 tensor, never by the reciprocal). The LOW form's
// constants are first rounded to bf16 (optimizer_ops.low_scalar), where
// the reference's weak Python floats take the weight's dtype. rbf rounds
// to bf16 (nearest even) and widens back, where the LOW form of the plain
// version rounds: AdamW's g, m and v chains after each op, the
// denominator twice, and every store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;     // elements a thread takes at a time
constexpr int UNROLL = 4;  // times a thread takes VEC elements a chunk
constexpr long long CHUNK = (long long)THREADS * VEC * UNROLL;

enum Rule {
  SGD = 0, SGD_MOM = 1, ADAMW = 2, ADAM = 3, NAG = 4, NAG_MOM = 5,
  SIGNSGD = 6, SIGNUM = 7, FTML = 8, DCASGD = 9, DCASGD_MOM = 10,
  ADAGRAD = 11, RMSPROP = 12, RMSPROPALEX = 13, ADADELTA = 14, FTRL = 15,
  ADAMAX = 16, TEST = 17
};
enum Form { F32 = 0, LOW = 1, MASTER = 2 };
enum Flag { WD_ON = 1, VECTOR = 2 };

// the state tensors a rule keeps, by rule in the enum's order
// (multi_tensor.py STATES mirrors it), in the order of its optimizer's
// state: SGD_MOM / NAG_MOM / SIGNUM the momentum; ADAMW / ADAM (mean,
// var); FTML (d, v, z); DCASGD the previous weight, DCASGD_MOM (momentum,
// previous weight); ADAGRAD the history; RMSPROP n, RMSPROPALEX (n, g,
// delta); ADADELTA (acc_g, acc_delta); FTRL (z, n); ADAMAX (m, u); TEST
// its state (written, never read)
__host__ __device__ constexpr int states_of(int rule) {
  constexpr int STATES[] = {0, 1, 2, 2, 0, 1, 0, 1, 3,
                            1, 2, 1, 1, 3, 2, 2, 2, 1};
  static_assert(sizeof(STATES) / sizeof(STATES[0]) == TEST + 1,
                "a count for every rule");
  return STATES[rule];
}

// one tensor of the list, as multi_tensor.py ENTRY packs it
struct Entry {
  void* w;            // weight: float (F32) or bf16
  const void* g;      // gradient, the weight's dtype; null reads as zeros
  void* s1;           // the rule's first state; null without
  void* s2;           // its second; null without
  void* s3;           // its third (FTML, RMSPROPALEX); null otherwise
  float* w32;         // the float32 master (MASTER); null otherwise
  long long n;        // elements
  long long chunk0;   // the first chunk of this tensor
  float a;            // lr, or the rule's per-tensor factor, float32
  float wd;           // weight decay, float32
  float b;            // the rule's second per-tensor factor, float32
  int flags;          // WD_ON: the rule adds wd * w (wd != 0); VECTOR
};
static_assert(offsetof(Entry, w) == 0, "Entry layout");
static_assert(offsetof(Entry, g) == 8, "Entry layout");
static_assert(offsetof(Entry, s1) == 16, "Entry layout");
static_assert(offsetof(Entry, s2) == 24, "Entry layout");
static_assert(offsetof(Entry, s3) == 32, "Entry layout");
static_assert(offsetof(Entry, w32) == 40, "Entry layout");
static_assert(offsetof(Entry, n) == 48, "Entry layout");
static_assert(offsetof(Entry, chunk0) == 56, "Entry layout");
static_assert(offsetof(Entry, a) == 64, "Entry layout");
static_assert(offsetof(Entry, wd) == 68, "Entry layout");
static_assert(offsetof(Entry, b) == 72, "Entry layout");
static_assert(offsetof(Entry, flags) == 76, "Entry layout");
static_assert(sizeof(Entry) == 80, "Entry layout");

// the scalars every tensor of a launch shares, float32 as the host
// rounded them for the rule and form (multi_tensor.py launch_scalars):
// beta1 / c1 = 1 - beta1 also carry RMSProp's gamma1, AdaDelta's rho and
// Signum's momentum; beta2 / c2 RMSProp's gamma2; k0 DCASGD's lamda,
// Ftrl's lamda1 or RMSProp's clip_weights (k_on), k1 Ftrl's beta
struct Scalars {
  float rescale, clip, momentum, beta1, beta2, c1, c2, eps, lr, k0, k1;
  int clip_on, k_on;
};

// one tensor's hyperparameters
struct Hyper {
  float a, wd, b;
  bool wd_on;
};

template <int FORM>
struct Types {
  using W = float;
  using S = float;
};
template <>
struct Types<LOW> {
  using W = __nv_bfloat16;
  using S = __nv_bfloat16;
};
template <>
struct Types<MASTER> {
  using W = __nv_bfloat16;
  using S = float;
};

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ld1(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld1(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st1(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st1(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void ld8(const float* p, float (&f)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p,
                                    float (&f)[VEC]) {
  mx_bf16::widen8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void st8(float* p, const float (&f)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void st8(__nv_bfloat16* p, const float (&f)[VEC]) {
  using mx_bf16::pack2;
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
      pack2(f[6], f[7]));
}

// torch.clamp(g, lo, hi): NaN stays NaN; lo > hi gives hi
__device__ __forceinline__ float clamp(float g, float lo, float hi) {
  return g != g ? g : fminf(fmaxf(g, lo), hi);
}

// torch.sign: 1, -1, or +0 (for zeros of either sign and NaN)
__device__ __forceinline__ float sgn(float x) {
  return __fsub_rn((float)(0.f < x), (float)(x < 0.f));
}

// torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float maxnan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// one element: w is the weight the rule updates (the widened weight, or
// the master), g the widened gradient, s1-s3 the widened state
template <int RULE, int FORM>
__device__ __forceinline__ void update(float& w, float g, float& s1,
                                       float& s2, float& s3, const Hyper& h,
                                       const Scalars& sc) {
  if (RULE == ADAMW && FORM == LOW) {
    g = rbf(__fmul_rn(g, sc.rescale));
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    s1 = rbf(__fadd_rn(rbf(__fmul_rn(s1, sc.beta1)),
                       rbf(__fmul_rn(g, sc.c1))));
    s2 = rbf(__fadd_rn(rbf(__fmul_rn(s2, sc.beta2)),
                       rbf(__fmul_rn(rbf(__fmul_rn(g, g)), sc.c2))));
    const float den = rbf(__fadd_rn(rbf(__fsqrt_rn(s2)), sc.eps));
    const float q = __fdiv_rn(rbf(__fmul_rn(s1, sc.lr)), den);
    w = __fsub_rn(w, __fmul_rn(h.a, __fadd_rn(q, __fmul_rn(w, h.wd))));
    return;
  }
  g = __fmul_rn(g, sc.rescale);
  if (RULE == ADAMW) {
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    s1 = __fadd_rn(__fmul_rn(s1, sc.beta1), __fmul_rn(g, sc.c1));
    s2 = __fadd_rn(__fmul_rn(s2, sc.beta2), __fmul_rn(__fmul_rn(g, g), sc.c2));
    const float den = __fadd_rn(__fsqrt_rn(s2), sc.eps);
    const float q = __fdiv_rn(__fmul_rn(s1, sc.lr), den);
    w = __fsub_rn(w, __fmul_rn(h.a, __fadd_rn(q, __fmul_rn(w, h.wd))));
  } else if (RULE == SGD || RULE == SGD_MOM) {
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    if (h.wd_on) g = __fadd_rn(g, __fmul_rn(w, h.wd));
    if (RULE == SGD) {
      w = __fsub_rn(w, __fmul_rn(g, h.a));
    } else {
      s1 = __fsub_rn(__fmul_rn(s1, sc.momentum), __fmul_rn(g, h.a));
      w = __fadd_rn(w, s1);
    }
  } else if (RULE == ADAM) {
    // Adam.update: wd folds in before the clip, a the bias-corrected lr
    if (h.wd_on) g = __fadd_rn(g, __fmul_rn(h.wd, w));
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    s1 = __fadd_rn(__fmul_rn(s1, sc.beta1), __fmul_rn(g, sc.c1));
    s2 = __fadd_rn(__fmul_rn(s2, sc.beta2), __fmul_rn(__fmul_rn(g, g), sc.c2));
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(h.a, s1),
                               __fadd_rn(__fsqrt_rn(s2), sc.eps)));
  } else if (RULE == NAG || RULE == NAG_MOM) {
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    if (RULE == NAG) {
      w = __fsub_rn(w, __fmul_rn(h.a, __fadd_rn(g, __fmul_rn(h.wd, w))));
    } else {
      s1 = __fadd_rn(__fadd_rn(__fmul_rn(sc.momentum, s1), g),
                     __fmul_rn(h.wd, w));
      w = __fsub_rn(w, __fmul_rn(h.a, __fadd_rn(__fmul_rn(sc.momentum, s1),
                                                g)));
    }
  } else if (RULE == SIGNSGD) {
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    w = __fsub_rn(w, __fmul_rn(h.a, __fadd_rn(sgn(g), __fmul_rn(h.wd, w))));
  } else if (RULE == SIGNUM) {
    // b = 1 - lr wd_lh; c1 = 1 - momentum
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    if (h.wd_on) g = __fadd_rn(g, __fmul_rn(h.wd, w));
    s1 = __fsub_rn(__fmul_rn(sc.momentum, s1), __fmul_rn(sc.c1, g));
    w = __fadd_rn(__fmul_rn(h.b, w), __fmul_rn(h.a, sgn(s1)));
  } else if (RULE == FTML) {
    // (s1, s2, s3) = (d, v, z); a = (1 - beta1^t) / lr, b = 1 - beta2^t
    if (h.wd_on) g = __fadd_rn(g, __fmul_rn(h.wd, w));
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    s2 = __fadd_rn(__fmul_rn(sc.beta2, s2), __fmul_rn(sc.c2, __fmul_rn(g, g)));
    const float d = __fmul_rn(h.a, __fadd_rn(__fsqrt_rn(__fdiv_rn(s2, h.b)),
                                             sc.eps));
    const float sigma = __fsub_rn(d, __fmul_rn(sc.beta1, s1));
    s3 = __fsub_rn(__fadd_rn(__fmul_rn(sc.beta1, s3), __fmul_rn(sc.c1, g)),
                   __fmul_rn(sigma, w));
    s1 = d;
    w = __fdiv_rn(-s3, d);
  } else if (RULE == DCASGD || RULE == DCASGD_MOM) {
    // DCASGD: s1 the previous weight; DCASGD_MOM: (s1, s2) = (mom, prev)
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    float& prev = RULE == DCASGD ? s1 : s2;
    const float comp = __fmul_rn(__fmul_rn(__fmul_rn(sc.k0, g), g),
                                 __fsub_rn(w, prev));
    float delta = __fmul_rn(-h.a, __fadd_rn(__fadd_rn(g, __fmul_rn(h.wd, w)),
                                            comp));
    if (RULE == DCASGD_MOM) {
      s1 = __fadd_rn(__fmul_rn(sc.momentum, s1), delta);
      delta = s1;
    }
    prev = w;
    w = __fadd_rn(w, delta);
  } else if (RULE == ADAGRAD) {
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    s1 = __fadd_rn(s1, __fmul_rn(g, g));
    w = __fsub_rn(w, __fmul_rn(h.a, __fadd_rn(
                             __fdiv_rn(g, __fsqrt_rn(__fadd_rn(s1, sc.eps))),
                             __fmul_rn(h.wd, w))));
  } else if (RULE == RMSPROP || RULE == RMSPROPALEX) {
    // beta1 / c1 gamma1, beta2 gamma2; RMSPROPALEX (s1, s2, s3) = (n, g,
    // delta)
    if (h.wd_on) g = __fadd_rn(g, __fmul_rn(h.wd, w));
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    s1 = __fadd_rn(__fmul_rn(sc.beta1, s1), __fmul_rn(sc.c1, __fmul_rn(g, g)));
    if (RULE == RMSPROP) {
      w = __fsub_rn(w, __fdiv_rn(__fmul_rn(h.a, g),
                                 __fsqrt_rn(__fadd_rn(s1, sc.eps))));
    } else {
      s2 = __fadd_rn(__fmul_rn(sc.beta1, s2), __fmul_rn(sc.c1, g));
      const float den = __fsqrt_rn(
          __fadd_rn(__fsub_rn(s1, __fmul_rn(s2, s2)), sc.eps));
      s3 = __fsub_rn(__fmul_rn(sc.beta2, s3),
                     __fdiv_rn(__fmul_rn(h.a, g), den));
      w = __fadd_rn(w, s3);
    }
    if (sc.k_on) w = clamp(w, -sc.k0, sc.k0);
  } else if (RULE == ADADELTA) {
    // beta1 / c1 rho; (s1, s2) = (acc_g, acc_delta)
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    s1 = __fadd_rn(__fmul_rn(sc.beta1, s1), __fmul_rn(__fmul_rn(sc.c1, g), g));
    const float step = __fmul_rn(
        __fdiv_rn(__fsqrt_rn(__fadd_rn(s2, sc.eps)),
                  __fsqrt_rn(__fadd_rn(s1, sc.eps))),
        g);
    s2 = __fadd_rn(__fmul_rn(sc.beta1, s2),
                   __fmul_rn(__fmul_rn(sc.c1, step), step));
    w = __fsub_rn(__fsub_rn(w, step), __fmul_rn(h.wd, w));
  } else if (RULE == FTRL) {
    // (s1, s2) = (z, n); a the lr (a divisor), k0 lamda1, k1 beta
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    const float n = __fadd_rn(s2, __fmul_rn(g, g));
    const float sigma = __fdiv_rn(__fsub_rn(__fsqrt_rn(n), __fsqrt_rn(s2)),
                                  h.a);
    s1 = __fsub_rn(__fadd_rn(s1, g), __fmul_rn(sigma, w));
    s2 = n;
    w = fabsf(s1) > sc.k0
            ? __fdiv_rn(-__fsub_rn(s1, __fmul_rn(sgn(s1), sc.k0)),
                        __fadd_rn(__fdiv_rn(__fadd_rn(__fsqrt_rn(n), sc.k1),
                                            h.a),
                                  h.wd))
            : 0.f;
  } else if (RULE == ADAMAX) {
    // (s1, s2) = (m, u); a = lr / (1 - beta1^t); wd folds in always,
    // before the clip
    g = __fadd_rn(g, __fmul_rn(h.wd, w));
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    s1 = __fadd_rn(__fmul_rn(sc.beta1, s1), __fmul_rn(sc.c1, g));
    s2 = maxnan(__fmul_rn(sc.beta2, s2), fabsf(g));
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(h.a, s1), s2));
  } else if (RULE == TEST) {
    w = __fadd_rn(w, g);
    s1 = w;
  }
}

// the entry of chunk b: the last one whose chunk0 <= b (multi_tensor.py
// chunk_of mirrors it)
__device__ __forceinline__ int entry_of(const Entry* table, int tensors,
                                        long long b) {
  int lo = 0, hi = tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].chunk0 <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

template <int RULE, int FORM>
__global__ void __launch_bounds__(THREADS)
    multi_tensor_update_kernel(const Entry* __restrict__ table, int tensors,
                               Scalars sc) {
  using W = typename Types<FORM>::W;
  using S = typename Types<FORM>::S;
  constexpr int STATES = states_of(RULE);
  constexpr bool HAS_S1 = STATES >= 1, HAS_S2 = STATES >= 2,
                 HAS_S3 = STATES >= 3;
  constexpr bool READ_S1 = HAS_S1 && RULE != TEST;
  const long long b = blockIdx.x;
  const Entry e = table[entry_of(table, tensors, b)];
  W* w = static_cast<W*>(e.w);
  const W* gp = static_cast<const W*>(e.g);
  S* s1p = static_cast<S*>(e.s1);
  S* s2p = static_cast<S*>(e.s2);
  S* s3p = static_cast<S*>(e.s3);
  float* w32 = e.w32;
  const Hyper h = {e.a, e.wd, e.b, (e.flags & WD_ON) != 0};
  const long long base = (b - e.chunk0) * CHUNK + threadIdx.x * VEC;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + (long long)u * THREADS * VEC;
    if (i >= e.n) break;
    if ((e.flags & VECTOR) && i + VEC <= e.n) {
      float wb[VEC], g[VEC], s1[VEC], s2[VEC], s3[VEC];
      if (FORM == MASTER)
        ld8(w32 + i, wb);
      else
        ld8(w + i, wb);
      if (gp) {
        ld8(gp + i, g);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) g[k] = 0.f;
      }
      if (READ_S1) ld8(s1p + i, s1);
      if (HAS_S2) ld8(s2p + i, s2);
      if (HAS_S3) ld8(s3p + i, s3);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        update<RULE, FORM>(wb[k], g[k], s1[k], s2[k], s3[k], h, sc);
      if (HAS_S1) st8(s1p + i, s1);
      if (HAS_S2) st8(s2p + i, s2);
      if (HAS_S3) st8(s3p + i, s3);
      if (FORM == MASTER) st8(w32 + i, wb);
      st8(w + i, wb);
    } else {
      const long long end = i + VEC < e.n ? i + VEC : e.n;
      for (long long j = i; j < end; ++j) {
        float wb = FORM == MASTER ? w32[j] : ld1(w, j);
        const float g = gp ? ld1(gp, j) : 0.f;
        float s1 = READ_S1 ? ld1(s1p, j) : 0.f;
        float s2 = HAS_S2 ? ld1(s2p, j) : 0.f;
        float s3 = HAS_S3 ? ld1(s3p, j) : 0.f;
        update<RULE, FORM>(wb, g, s1, s2, s3, h, sc);
        if (HAS_S1) st1(s1p, j, s1);
        if (HAS_S2) st1(s2p, j, s2);
        if (HAS_S3) st1(s3p, j, s3);
        if (FORM == MASTER) w32[j] = wb;
        st1(w, j, wb);
      }
    }
  }
}

template <int RULE>
cudaError_t launch_form(int form, unsigned grid, const Entry* table,
                        int tensors, const Scalars& sc, cudaStream_t s) {
  switch (form) {
    case F32:
      multi_tensor_update_kernel<RULE, F32><<<grid, THREADS, 0, s>>>(
          table, tensors, sc);
      break;
    case LOW:
      // the bf16 form without a master: SGD, SGD_MOM and ADAMW only
      if constexpr (RULE <= ADAMW) {
        multi_tensor_update_kernel<RULE, LOW><<<grid, THREADS, 0, s>>>(
            table, tensors, sc);
        break;
      } else {
        return cudaErrorInvalidValue;
      }
    case MASTER:
      multi_tensor_update_kernel<RULE, MASTER><<<grid, THREADS, 0, s>>>(
          table, tensors, sc);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// rule: a Rule (multi_tensor.py RULES in order); form: 0 float32, 1 bf16
// without a master, 2 bf16 with a float32 master. table: `tensors` Entry
// records in device memory, chunk0 ascending from 0; chunks: the total,
// one block each. The scalars: multi_tensor.py launch_scalars, in order.
extern "C" int mx_multi_tensor_update(int rule, int form, const void* table,
                                      int tensors, long long chunks,
                                      float rescale, float clip, int clip_on,
                                      float momentum, float beta1,
                                      float beta2, float c1, float c2,
                                      float eps, float lr, float k0,
                                      float k1, int k_on, void* stream) {
  if (chunks == 0) return cudaSuccess;
  if (tensors <= 0 || chunks < 0 || chunks > INT32_MAX)
    return cudaErrorInvalidValue;
  const Scalars sc = {rescale, clip, momentum, beta1, beta2, c1,
                      c2,      eps,  lr,       k0,    k1,    clip_on,
                      k_on};
  const Entry* t = static_cast<const Entry*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)chunks;
  switch (rule) {
#define MX_RULE(R) \
  case R:          \
    return launch_form<R>(form, grid, t, tensors, sc, s);
    MX_RULE(SGD)
    MX_RULE(SGD_MOM)
    MX_RULE(ADAMW)
    MX_RULE(ADAM)
    MX_RULE(NAG)
    MX_RULE(NAG_MOM)
    MX_RULE(SIGNSGD)
    MX_RULE(SIGNUM)
    MX_RULE(FTML)
    MX_RULE(DCASGD)
    MX_RULE(DCASGD_MOM)
    MX_RULE(ADAGRAD)
    MX_RULE(RMSPROP)
    MX_RULE(RMSPROPALEX)
    MX_RULE(ADADELTA)
    MX_RULE(FTRL)
    MX_RULE(ADAMAX)
    MX_RULE(TEST)
#undef MX_RULE
    default:
      return cudaErrorInvalidValue;
  }
}
