// The whole-model optimizer update for Hopper (sm_90a): one launch applies
// SGD, SGD with momentum or AdamW to every tensor of a list.
//
// Replaces the XLA fusion of the reference's traced update
// (mxnet_tpu/optimizer/fused.py:119-147 over ops/optimizer_ops.py), which
// ParallelTrainer compiles into its one program; on the port's eager step
// it takes the place of one chain of about 12 elementwise launches a
// parameter (optimizer/fused.py, ops/kernels/multi_tensor.py).
//
// Instances: RULE (SGD, SGD_MOM, ADAMW) x FORM:
//   F32     float32 weight, gradient and state;
//   LOW     bf16 weight, gradient and state, no master (a net after
//           cast('bfloat16') without multi_precision);
//   MASTER  bf16 weight and gradient, float32 master and state
//           (multi_precision): the master is updated, the weight is the
//           master rounded (it is written, never read).
//
// The list. The host (multi_tensor.py pack_table) writes one Entry a
// tensor: its pointers, its length, its first chunk and its float32
// hyperparameters (lr or AdamW's eta, wd), and ships the table in one
// asynchronous copy from a pinned buffer each step, since the gradients
// are new tensors each step. A tensor is cut into chunks of CHUNK
// elements; chunk0 is the prefix sum of the chunks before it. Block b
// takes chunk b: it finds its tensor by a binary search over chunk0 (the
// last entry whose chunk0 <= b) and its offset (b - chunk0) * CHUNK.
// Each thread takes VEC = 8 consecutive elements UNROLL times: one
// 16-byte load of each bf16 input, two of each float32 one, where every
// pointer of the tensor is 16-byte aligned (flag VECTOR) and the 8 lie
// inside the tensor; else the elements one by one (the tail). A null
// gradient reads as zeros (a parameter the loss does not reach).
//
// Rounding. Every float32 operation is one explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc
// never contracts into an FMA, in the order of the plain PyTorch ops
// (ops/optimizer_ops.py): each op of the plain version rounds once, and
// so does each step here, so the kernel is bitwise its plain version. The
// host converts each Python scalar where PyTorch converts it: a scalar
// multiplying a float32 tensor is the double rounded to float32 (so
// 1 - beta1 is formed in double, then rounded); the LOW form's constants
// are first rounded to bf16 (optimizer_ops.low_scalar), where the
// reference's weak Python floats take the weight's dtype. rbf rounds to
// bf16 (nearest even) and widens back, where the LOW form of the plain
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

enum Rule { SGD = 0, SGD_MOM = 1, ADAMW = 2 };
enum Form { F32 = 0, LOW = 1, MASTER = 2 };
enum Flag { WD_ON = 1, VECTOR = 2 };

// one tensor of the list, as multi_tensor.py ENTRY packs it
struct Entry {
  void* w;            // weight: float (F32) or bf16
  const void* g;      // gradient, the weight's dtype; null reads as zeros
  void* s1;           // SGD momentum or AdamW mean; null without
  void* s2;           // AdamW var; null otherwise
  float* w32;         // the float32 master (MASTER); null otherwise
  long long n;        // elements
  long long chunk0;   // the first chunk of this tensor
  float a;            // lr (SGD) or eta (AdamW), float32
  float wd;           // weight decay, float32
  int flags;          // WD_ON: SGD adds wd * w (wd != 0); VECTOR: aligned
  int pad;
};
static_assert(offsetof(Entry, w) == 0, "Entry layout");
static_assert(offsetof(Entry, g) == 8, "Entry layout");
static_assert(offsetof(Entry, s1) == 16, "Entry layout");
static_assert(offsetof(Entry, s2) == 24, "Entry layout");
static_assert(offsetof(Entry, w32) == 32, "Entry layout");
static_assert(offsetof(Entry, n) == 40, "Entry layout");
static_assert(offsetof(Entry, chunk0) == 48, "Entry layout");
static_assert(offsetof(Entry, a) == 56, "Entry layout");
static_assert(offsetof(Entry, wd) == 60, "Entry layout");
static_assert(offsetof(Entry, flags) == 64, "Entry layout");
static_assert(sizeof(Entry) == 72, "Entry layout");

// the scalars every tensor of a launch shares, float32 as the host
// rounded them for the form
struct Scalars {
  float rescale, clip, momentum, beta1, beta2, c1, c2, eps, lr;
  int clip_on;
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

// torch.clamp(g, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp(float g, float lo, float hi) {
  return g != g ? g : fminf(fmaxf(g, lo), hi);
}

// one element: wb is the weight the rule updates (the widened weight, or
// the master), g the widened gradient, s1 / s2 the widened state
template <int RULE, int FORM>
__device__ __forceinline__ void update(float& wb, float g, float& s1,
                                       float& s2, float a, float wd,
                                       bool wd_on, const Scalars& sc) {
  if (RULE == ADAMW && FORM == LOW) {
    g = rbf(__fmul_rn(g, sc.rescale));
    if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
    s1 = rbf(__fadd_rn(rbf(__fmul_rn(s1, sc.beta1)),
                       rbf(__fmul_rn(g, sc.c1))));
    s2 = rbf(__fadd_rn(rbf(__fmul_rn(s2, sc.beta2)),
                       rbf(__fmul_rn(rbf(__fmul_rn(g, g)), sc.c2))));
    const float den = rbf(__fadd_rn(rbf(__fsqrt_rn(s2)), sc.eps));
    const float q = __fdiv_rn(rbf(__fmul_rn(s1, sc.lr)), den);
    wb = __fsub_rn(wb, __fmul_rn(a, __fadd_rn(q, __fmul_rn(wb, wd))));
    return;
  }
  g = __fmul_rn(g, sc.rescale);
  if (sc.clip_on) g = clamp(g, -sc.clip, sc.clip);
  if (RULE == ADAMW) {
    s1 = __fadd_rn(__fmul_rn(s1, sc.beta1), __fmul_rn(g, sc.c1));
    s2 = __fadd_rn(__fmul_rn(s2, sc.beta2), __fmul_rn(__fmul_rn(g, g), sc.c2));
    const float den = __fadd_rn(__fsqrt_rn(s2), sc.eps);
    const float q = __fdiv_rn(__fmul_rn(s1, sc.lr), den);
    wb = __fsub_rn(wb, __fmul_rn(a, __fadd_rn(q, __fmul_rn(wb, wd))));
    return;
  }
  if (wd_on) g = __fadd_rn(g, __fmul_rn(wb, wd));
  if (RULE == SGD) {
    wb = __fsub_rn(wb, __fmul_rn(g, a));
  } else {
    s1 = __fsub_rn(__fmul_rn(s1, sc.momentum), __fmul_rn(g, a));
    wb = __fadd_rn(wb, s1);
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
  constexpr bool HAS_S1 = RULE != SGD;
  constexpr bool HAS_S2 = RULE == ADAMW;
  const long long b = blockIdx.x;
  const Entry e = table[entry_of(table, tensors, b)];
  W* w = static_cast<W*>(e.w);
  const W* gp = static_cast<const W*>(e.g);
  S* s1p = static_cast<S*>(e.s1);
  S* s2p = static_cast<S*>(e.s2);
  float* w32 = e.w32;
  const bool wd_on = e.flags & WD_ON;
  const long long base = (b - e.chunk0) * CHUNK + threadIdx.x * VEC;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + (long long)u * THREADS * VEC;
    if (i >= e.n) break;
    if ((e.flags & VECTOR) && i + VEC <= e.n) {
      float wb[VEC], g[VEC], s1[VEC], s2[VEC];
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
      if (HAS_S1) ld8(s1p + i, s1);
      if (HAS_S2) ld8(s2p + i, s2);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        update<RULE, FORM>(wb[k], g[k], s1[k], s2[k], e.a, e.wd, wd_on, sc);
      if (HAS_S1) st8(s1p + i, s1);
      if (HAS_S2) st8(s2p + i, s2);
      if (FORM == MASTER) st8(w32 + i, wb);
      st8(w + i, wb);
    } else {
      const long long end = i + VEC < e.n ? i + VEC : e.n;
      for (long long j = i; j < end; ++j) {
        float wb = FORM == MASTER ? w32[j] : ld1(w, j);
        const float g = gp ? ld1(gp, j) : 0.f;
        float s1 = HAS_S1 ? ld1(s1p, j) : 0.f;
        float s2 = HAS_S2 ? ld1(s2p, j) : 0.f;
        update<RULE, FORM>(wb, g, s1, s2, e.a, e.wd, wd_on, sc);
        if (HAS_S1) st1(s1p, j, s1);
        if (HAS_S2) st1(s2p, j, s2);
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
      multi_tensor_update_kernel<RULE, LOW><<<grid, THREADS, 0, s>>>(
          table, tensors, sc);
      break;
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

// rule: 0 SGD, 1 SGD with momentum, 2 AdamW; form: 0 float32, 1 bf16
// without a master, 2 bf16 with a float32 master. table: `tensors`
// Entry records in device memory, chunk0 ascending from 0; chunks: the
// total, one block each.
extern "C" int mx_multi_tensor_update(int rule, int form, const void* table,
                                      int tensors, long long chunks,
                                      float rescale, float clip, int clip_on,
                                      float momentum, float beta1,
                                      float beta2, float c1, float c2,
                                      float eps, float lr, void* stream) {
  if (chunks == 0) return cudaSuccess;
  if (tensors <= 0 || chunks < 0 || chunks > INT32_MAX)
    return cudaErrorInvalidValue;
  const Scalars sc = {rescale, clip, momentum, beta1, beta2,
                      c1,      c2,   eps,      lr,    clip_on};
  const Entry* t = static_cast<const Entry*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)chunks;
  switch (rule) {
    case SGD:
      return launch_form<SGD>(form, grid, t, tensors, sc, s);
    case SGD_MOM:
      return launch_form<SGD_MOM>(form, grid, t, tensors, sc, s);
    case ADAMW:
      return launch_form<ADAMW>(form, grid, t, tensors, sc, s);
    default:
      return cudaErrorInvalidValue;
  }
}
