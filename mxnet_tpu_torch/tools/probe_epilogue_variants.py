"""Check and time the stream kernels of ``csrc/epilogue.cu`` beside
variants of their design and beside the library calls, on the card: the
activation kernels (``act_fwd``, ``act_bwd``) at every relu and
residual-join shape of the ResNet-50 v1 training step at batch 128, the
BN apply (``bn_act_fwd``, ``bn_act_bwd``, identity, as the step runs
them) at its nine BatchNorm shapes.

    python -m mxnet_tpu_torch.tools.probe_epilogue_variants [act|bn]

(both families without an argument). Candidates of the activation
kernels, each a function of the kernel's inputs that allocates its
output as the wrappers do:

  * ``shipped``: the wrappers ``act_forward`` / ``act_backward``, at the
    geometry :func:`epilogue_geometry` picks;
  * ``u1_st``, ``u1_cs``: the built library's C entry points with normal
    (``st``) or evict-first (``cs``) stores at every size;
  * :data:`UNROLLED` (``u2_st`` ... ``u4_cs_p4``): U vectors of each
    input a thread, loaded before any is computed, normal or evict-first
    stores, one block a tile of 1024 x U floats or a persistent grid of 8
    or 4 blocks an SM walking the tiles: kernels of their own
    (:data:`_UNROLLED_SRC`, relu only) appended to the source;
  * ``scalar``, ``ldg``, ``plain``, ``l2_256``, ``ld_cs``: the source with
    exact text substitutions (each must occur once) or an appended
    kernel, called at the shipped geometry: :data:`SOURCE_VARIANTS` says
    what each changes (``scalar`` is the grid-stride loop of one 4-byte
    load a thread that the stream replaced, under entry points of its
    own);
  * ``library``: ``torch.relu`` / ``aten.threshold_backward(g, out, 0)``.

Of the BN apply (:data:`BN_SHAPES`, identity):

  * ``shipped``: the wrappers ``bn_act_forward`` / ``bn_act_backward``;
  * ``scalar``: the grid-stride kernels of one 4-byte load a thread and
    two divisions an element that the stream replaced (appended to the
    source as kernels of their own, like the activation ``scalar``);
  * ``per_elem``: the stream with one multiply-high division of every
    element (:data:`_PER_ELEM`), so that the cost of finding the channel
    shows (the shipped kernels divide a vector's first element and step
    the others);
  * ``library``: ``F.batch_norm(training=False)`` (with ``scale =
    gamma * rsqrt(var + eps)``, held to the plain version within 1e-5 of
    its max abs) / ``torch.mul(g, scale[c])``.

Every source variant is built with the port's nvcc flags into the
ignored ``ops/kernels/_build/variants/``. Every candidate is first held
bitwise to the plain version (relu at each shape; relu and leaky at 5
and 9102 elements, a rest and a tail; the BN apply at :data:`BN_ODD`,
inners 49, 143 and 5, and at each shape). Then, shape by shape, the
candidates are timed in turns (in an order that starts one candidate
later at each shape, never with ``shipped``, then in reverse, so that no
candidate always goes first) by the probe's ``slope_ms`` over inputs
rotated past twice the L2. A line a candidate and shape gives both
turns' device ms and the share of the bytes bound (8 bytes an element
forward, 12 backward, 8 for either BN kernel, at 3.35 TB/s); then each
candidate's sum over one step's launches, the shapes weighted by how
many the step runs (:data:`FWD_SHAPES`, :data:`BWD_SHAPES`,
:data:`BN_SHAPES`); then ptxas's registers and
spills of each kernel instance; then whether ``aten._add_relu``
(``relu(x + y)``) runs on the card, and if it does its time beside
``add_act_fwd``; last, one JSON line with every number. Needs a card;
raises without one.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

from mxnet_tpu_torch.tools.probe_matmul_pipeline import (PEAK_BYTES_S, card,
                                                          cold_copies,
                                                          slope_ms)

# (shape, launches in one ResNet-50 v1 step at batch 128): the stem relu
# and the two relus of each bottleneck, at their stage's width
FWD_SHAPES = (((128, 64, 112, 112), 1), ((128, 64, 56, 56), 6),
              ((128, 128, 28, 28), 8), ((128, 256, 14, 14), 12),
              ((128, 512, 7, 7), 6))
# the backward also runs once a residual join (the add+relu's gradient)
BWD_SHAPES = FWD_SHAPES + (((128, 256, 56, 56), 3), ((128, 512, 28, 28), 4),
                           ((128, 1024, 14, 14), 6), ((128, 2048, 7, 7), 3))
ODD_SIZES = (5, 9102)
JOIN = (128, 256, 56, 56)
# (shape, launches in one ResNet-50 v1 step at batch 128) of every
# BatchNorm: the stem, then the three of each bottleneck and the
# projection shortcut of each stage's first one
BN_SHAPES = (((128, 64, 112, 112), 1), ((128, 64, 56, 56), 6),
             ((128, 256, 56, 56), 4), ((128, 128, 28, 28), 8),
             ((128, 512, 28, 28), 5), ((128, 256, 14, 14), 12),
             ((128, 1024, 14, 14), 7), ((128, 512, 7, 7), 6),
             ((128, 2048, 7, 7), 4))
BN_ODD = ((2, 4, 7, 7), (3, 7, 11, 13), (1, 1, 1, 5))
BN_EPS = 1e-5
BYTES_PER_ELEMENT = {'act_fwd': 8, 'act_bwd': 12, 'bn_act_fwd': 8,
                     'bn_act_bwd': 8}

# name -> (unroll, evict-first stores, blocks an SM or None for one block a
# tile), run by the appended kernels of _UNROLLED_SRC
UNROLLED = {'u2_st': (2, False, None), 'u2_cs': (2, True, None),
            'u4_st': (4, False, None), 'u4_cs': (4, True, None),
            'u1_cs_p8': (1, True, 8), 'u4_cs_p4': (4, True, 4)}

_LOAD = 'ld.global.nc.L1::no_allocate.v4.f32'
# the grid-stride kernels of one 4-byte load a thread, on grid_for's grid
_SCALAR = r'''
namespace {
template <int A>
__global__ void __launch_bounds__(THREADS)
epilogue_act_fwd_scalar_kernel(const float* __restrict__ x,
                               float* __restrict__ out, Idx n, float slope) {
  const Idx stride = (Idx)gridDim.x * THREADS;
  for (Idx i = (Idx)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    out[i] = act_fwd<A>(x[i], slope);
}

template <int A>
__global__ void __launch_bounds__(THREADS)
epilogue_act_bwd_scalar_kernel(const float* __restrict__ g,
                               const float* __restrict__ out,
                               float* __restrict__ dx, Idx n, float slope) {
  const Idx stride = (Idx)gridDim.x * THREADS;
  for (Idx i = (Idx)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    dx[i] = __fmul_rn(g[i], act_grad<A>(out[i], slope));
}
}  // namespace

extern "C" int mx_act_fwd_scalar(const void* x, void* out, long long n,
                                 int act, float slope, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n);
  MX_ACT_DISPATCH(act, epilogue_act_fwd_scalar_kernel<A><<<grid, THREADS, 0,
                                                          s>>>(
                           static_cast<const float*>(x),
                           static_cast<float*>(out), (Idx)n, slope));
  return cudaGetLastError();
}

extern "C" int mx_act_bwd_scalar(const void* g, const void* out, void* dx,
                                 long long n, int act, float slope,
                                 void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n);
  MX_ACT_DISPATCH(act, epilogue_act_bwd_scalar_kernel<A><<<grid, THREADS, 0,
                                                          s>>>(
                           static_cast<const float*>(g),
                           static_cast<const float*>(out),
                           static_cast<float*>(dx), (Idx)n, slope));
  return cudaGetLastError();
}

namespace {
template <int A>
__global__ void __launch_bounds__(THREADS)
epilogue_bn_act_fwd_scalar_kernel(const float* __restrict__ x,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ mean,
                                  const float* __restrict__ beta,
                                  float* __restrict__ out, Idx n, Idx c,
                                  Idx inner, float slope) {
  const Idx stride = (Idx)gridDim.x * THREADS;
  for (Idx i = (Idx)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const Idx ch = (i / inner) % c;
    const float y = __fadd_rn(
        __fmul_rn(__fsub_rn(x[i], mean[ch]), scale[ch]), beta[ch]);
    out[i] = act_fwd<A>(y, slope);
  }
}

template <int A>
__global__ void __launch_bounds__(THREADS)
epilogue_bn_act_bwd_scalar_kernel(const float* __restrict__ g,
                                  const float* __restrict__ out,
                                  const float* __restrict__ scale,
                                  float* __restrict__ dx, Idx n, Idx c,
                                  Idx inner, float slope) {
  const Idx stride = (Idx)gridDim.x * THREADS;
  for (Idx i = (Idx)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const Idx ch = (i / inner) % c;
    dx[i] = __fmul_rn(__fmul_rn(g[i], act_grad<A>(out[i], slope)),
                      scale[ch]);
  }
}
}  // namespace

extern "C" int mx_bn_act_fwd_scalar(const void* x, const void* scale,
                                    const void* mean, const void* beta,
                                    void* out, long long n, int c,
                                    long long inner, int act, float slope,
                                    void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX || c <= 0 || inner <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n);
  MX_ACT_DISPATCH(act, epilogue_bn_act_fwd_scalar_kernel<A><<<grid, THREADS,
                                                             0, s>>>(
                           static_cast<const float*>(x),
                           static_cast<const float*>(scale),
                           static_cast<const float*>(mean),
                           static_cast<const float*>(beta),
                           static_cast<float*>(out), (Idx)n, (Idx)c,
                           (Idx)inner, slope));
  return cudaGetLastError();
}

extern "C" int mx_bn_act_bwd_scalar(const void* g, const void* out,
                                    const void* scale, void* dx, long long n,
                                    int c, long long inner, int act,
                                    float slope, void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n > INT32_MAX || c <= 0 || inner <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n);
  MX_ACT_DISPATCH(act, epilogue_bn_act_bwd_scalar_kernel<A><<<grid, THREADS,
                                                             0, s>>>(
                           static_cast<const float*>(g),
                           static_cast<const float*>(out),
                           static_cast<const float*>(scale),
                           static_cast<float*>(dx), (Idx)n, (Idx)c,
                           (Idx)inner, slope));
  return cudaGetLastError();
}
'''
# the BN apply's stream with one multiply-high division of every element
# (the shipped kernels divide a vector's first only), identity
_PER_ELEM = r'''
namespace {
template <bool EVICT>
struct BnFwdPerElem {
  const float* x;
  const float* scale;
  const float* mean;
  const float* beta;
  float* out;
  Channels chans;
  struct In {
    float4 a;
  };
  __device__ __forceinline__ In load(Idx i) const { return {load4(x + i)}; }
  __device__ __forceinline__ float one(float xi, Idx i) const {
    Idx r;
    const Idx ch = chans.at(i, r);
    return bn_fwd<IDENTITY>(xi, coef(scale, ch), coef(mean, ch),
                            coef(beta, ch), 0.f);
  }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    store4<EVICT>(out + i, make_float4(one(v.a.x, i), one(v.a.y, i + 1),
                                       one(v.a.z, i + 2), one(v.a.w, i + 3)));
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    out[i] = one(x[i], i);
  }
};

template <bool EVICT>
struct BnBwdPerElem {
  const float* g;
  const float* scale;
  float* dx;
  Channels chans;
  struct In {
    float4 a;
  };
  __device__ __forceinline__ In load(Idx i) const { return {load4(g + i)}; }
  __device__ __forceinline__ float one(float gi, Idx i) const {
    Idx r;
    return bn_bwd<IDENTITY>(gi, 0.f, coef(scale, chans.at(i, r)), 0.f);
  }
  __device__ __forceinline__ void store(Idx i, const In& v) const {
    store4<EVICT>(dx + i, make_float4(one(v.a.x, i), one(v.a.y, i + 1),
                                      one(v.a.z, i + 2), one(v.a.w, i + 3)));
  }
  __device__ __forceinline__ void scalar(Idx i) const {
    dx[i] = one(g[i], i);
  }
};

template <bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_bn_act_fwd_per_elem_kernel(const float* __restrict__ x,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ beta,
                                    float* __restrict__ out, Idx n,
                                    Idx tiles, Channels chans) {
  stream(BnFwdPerElem<EVICT>{x, scale, mean, beta, out, chans}, n, tiles);
}

template <bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_bn_act_bwd_per_elem_kernel(const float* __restrict__ g,
                                    const float* __restrict__ scale,
                                    float* __restrict__ dx, Idx n,
                                    Idx tiles, Channels chans) {
  stream(BnBwdPerElem<EVICT>{g, scale, dx, chans}, n, tiles);
}
}  // namespace

// the shipped entry points' arguments, identity only (act must be 0)
extern "C" int mx_bn_act_fwd_per_elem(const void* x, const void* scale,
                                      const void* mean, const void* beta,
                                      void* out, long long n, long long c,
                                      long long inner, unsigned inner_mul,
                                      int inner_shift, unsigned c_mul,
                                      int c_shift, int act, float slope,
                                      int evict, long long tiles,
                                      void* stream) {
  if (n <= 0 || n > INT32_MAX || act != IDENTITY)
    return cudaErrorInvalidValue;
  Channels ch;
  const unsigned grid = bn_grid(n, c, inner, inner_mul, inner_shift, c_mul,
                                c_shift, tiles, ch);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_EVICT_DISPATCH(evict,
      epilogue_bn_act_fwd_per_elem_kernel<E><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<const float*>(mean), static_cast<const float*>(beta),
          static_cast<float*>(out), (Idx)n, (Idx)tiles, ch));
  return cudaGetLastError();
}

extern "C" int mx_bn_act_bwd_per_elem(const void* g, const void* out,
                                      const void* scale, void* dx,
                                      long long n, long long c,
                                      long long inner, unsigned inner_mul,
                                      int inner_shift, unsigned c_mul,
                                      int c_shift, int act, float slope,
                                      int evict, long long tiles,
                                      void* stream) {
  if (n <= 0 || n > INT32_MAX || act != IDENTITY)
    return cudaErrorInvalidValue;
  Channels ch;
  const unsigned grid = bn_grid(n, c, inner, inner_mul, inner_shift, c_mul,
                                c_shift, tiles, ch);
  if (grid == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_EVICT_DISPATCH(evict,
      epilogue_bn_act_bwd_per_elem_kernel<E><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(g), static_cast<const float*>(scale),
          static_cast<float*>(dx), (Idx)n, (Idx)tiles, ch));
  return cudaGetLastError();
}
'''
# U vectors of each input a thread over tiles of TILE * U floats, shared
# out over `grid` blocks (grid-stride where it is smaller than the tiles);
# the grid's last block also takes the rest and the tail
_UNROLLED_SRC = r'''
namespace {
template <int U, class Op>
__device__ __forceinline__ void stream_unrolled(const Op& op, Idx n,
                                                Idx tiles) {
  constexpr Idx BIG = (Idx)TILE * U;
  for (Idx t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Idx base = t * BIG + threadIdx.x * VEC;
    typename Op::In v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = op.load(base + u * TILE);
#pragma unroll
    for (int u = 0; u < U; ++u) op.store(base + u * TILE, v[u]);
  }
  if (blockIdx.x != gridDim.x - 1) return;
  const Idx whole = n & ~(Idx)(VEC - 1);
  for (Idx i = tiles * BIG + threadIdx.x * VEC; i < whole; i += TILE)
    op.store(i, op.load(i));
  if (whole + threadIdx.x < n) op.scalar(whole + threadIdx.x);
}

template <int U, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_act_fwd_unrolled_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, Idx n, Idx tiles) {
  stream_unrolled<U>(ActFwd<RELU, EVICT>{x, out, 0.f}, n, tiles);
}

template <int U, bool EVICT>
__global__ void __launch_bounds__(THREADS)
epilogue_act_bwd_unrolled_kernel(const float* __restrict__ g,
                                 const float* __restrict__ out,
                                 float* __restrict__ dx, Idx n, Idx tiles) {
  stream_unrolled<U>(ActBwd<RELU, EVICT>{g, out, dx, 0.f}, n, tiles);
}

bool unrolled_ok(long long n, int unroll, long long tiles, long long grid) {
  return tiles == n / ((long long)TILE * unroll) && grid >= 1 &&
         grid <= tiles + 1;
}
}  // namespace

#define MX_UNROLL_DISPATCH(unroll, evict, ...)                          \
  switch (unroll) {                                                     \
    case 1: { constexpr int U = 1; MX_EVICT_DISPATCH(evict, __VA_ARGS__); \
              break; }                                                  \
    case 2: { constexpr int U = 2; MX_EVICT_DISPATCH(evict, __VA_ARGS__); \
              break; }                                                  \
    case 4: { constexpr int U = 4; MX_EVICT_DISPATCH(evict, __VA_ARGS__); \
              break; }                                                  \
    default: return cudaErrorInvalidValue;                              \
  }

// relu; unroll 1, 2 or 4; tiles = n / (TILE * unroll); 1 <= grid <= tiles + 1
extern "C" int mx_act_fwd_unrolled(const void* x, void* out, long long n,
                                   int unroll, int evict, long long tiles,
                                   int grid, void* stream) {
  if (n == 0) return cudaSuccess;
  if (!unrolled_ok(n, unroll, tiles, grid)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_UNROLL_DISPATCH(unroll, evict,
      epilogue_act_fwd_unrolled_kernel<U, E><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), (Idx)n,
          (Idx)tiles));
  return cudaGetLastError();
}

extern "C" int mx_act_bwd_unrolled(const void* g, const void* out, void* dx,
                                   long long n, int unroll, int evict,
                                   long long tiles, int grid, void* stream) {
  if (n == 0) return cudaSuccess;
  if (!unrolled_ok(n, unroll, tiles, grid)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_UNROLL_DISPATCH(unroll, evict,
      epilogue_act_bwd_unrolled_kernel<U, E><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(g), static_cast<const float*>(out),
          static_cast<float*>(dx), (Idx)n, (Idx)tiles));
  return cudaGetLastError();
}
'''
# name -> (what it changes, [(text, replacement)], appended source)
SOURCE_VARIANTS = {
    'unrolled': ('U vectors a thread, persistent grids (the UNROLLED '
                 'candidates)', [], _UNROLLED_SRC),
    'scalar': ('the grid-stride loop of one 4-byte load a thread, 8 blocks '
               'an SM at most', [], _SCALAR),
    'ldg': ('loads allocate in L1 (ld.global.nc.v4)',
            [(_LOAD, 'ld.global.nc.v4.f32')], ''),
    'plain': ('loads by the coherent path (ld.global.v4)',
              [(_LOAD, 'ld.global.v4.f32')], ''),
    'l2_256': ('loads ask L2 for 256-byte lines (.L2::256B)',
               [(_LOAD, 'ld.global.nc.L1::no_allocate.L2::256B.v4.f32')],
               ''),
    'ld_cs': ('loads evict first (ld.global.cs.v4)',
              [(_LOAD, 'ld.global.cs.v4.f32')], ''),
    'per_elem': ('the BN apply dividing every element', [], _PER_ELEM),
}
# the variants that build act kernels the probe times (the others are
# built for the BN apply alone)
ACT_VARIANTS = ('scalar', 'ldg', 'plain', 'l2_256', 'ld_cs')

_ENTRY = re.compile(r'epilogue_((?:bn_)?act_(?:fwd|bwd)'
                    r'(?:_scalar|_unrolled|_per_elem)?)'
                    r'_kernelI((?:L[ib]\d+E)+)E')


def kernel_resources(log):
    """{'kernel<template arguments>': (registers, spill bytes)} of the
    stream kernels in ptxas's ``-v`` lines ``log``: ``act_fwd<A,E>`` (act
    code, evict-first stores), ``act_fwd_scalar<A>``,
    ``act_fwd_unrolled<U,E>``, ``bn_act_fwd<A,E>``,
    ``bn_act_fwd_scalar<A>``, ``bn_act_fwd_per_elem<E>`` and the same for
    the backward kernels."""
    found, key = {}, None
    for ln in log.splitlines():
        if 'Compiling entry function' in ln:
            m = _ENTRY.search(ln)
            key = None if m is None else '%s<%s>' % (m.group(1), ','.join(
                re.findall(r'L[ib](\d+)E', m.group(2))))
            if key:
                found[key] = [0, 0]
        elif key:
            found[key][1] += sum(int(n) for n in re.findall(
                r'(\d+) bytes spill (?:stores|loads)', ln))
            regs = re.search(r'Used (\d+) registers', ln)
            if regs:
                found[key][0] = int(regs.group(1))
    return {k: tuple(v) for k, v in found.items()}


def _nvcc(build, cu, so):
    home = build._cuda_home()
    cmd = [os.path.join(home, 'bin', 'nvcc'), *build.NVCC_FLAGS, '-Xlinker',
           '-rpath=' + os.path.join(home, 'lib64'), '-o', so, cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def _start_variant(build, name, subs, extra):
    text = build.source_text('epilogue')
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError('variant %s: %r occurs %d times'
                               % (name, old[:60], text.count(old)))
        text = text.replace(old, new)
    out = os.path.join(build._BUILD_DIR, 'variants')
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, 'epilogue_%s.cu' % name)
    with open(cu, 'w') as f:
        f.write(text + extra)
    so = cu[:-3] + '.so'
    return _nvcc(build, cu, so), so


def _reap(proc, what):
    out, err = proc.communicate(timeout=600)
    log = (out + err).decode('utf-8', 'replace')
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed on %s:\n%s' % (what, log))
    return log


def _entry(lib, name, types):
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = ctypes.c_int, types
    return fn


def _act_candidates(torch, kernels, epi, libs):
    """{kernel: {name: fn(*inputs) -> output}} for act_fwd (inputs x) and
    act_bwd (inputs g, out); relu throughout."""
    from mxnet_tpu_torch.ops.kernels._launch import ptr, raise_on, stream
    from mxnet_tpu_torch.ops.kernels.attention import SMS
    relu = epi.ACT_TYPES.index('relu')
    i64, i32, f32, vp = (ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                         ctypes.c_void_p)

    def fwd(fn, *lead, args=lambda n: ()):
        def run(x):
            out = torch.empty_like(x)
            n = x.numel()
            raise_on('act_fwd', fn(ptr(x), ptr(out), n, *lead, *args(n),
                                   stream(x.device)))
            return out
        return run

    def bwd(fn, *lead, args=lambda n: ()):
        def run(g, out):
            dx = torch.empty_like(out)
            n = out.numel()
            raise_on('act_bwd', fn(ptr(g), ptr(out), ptr(dx), n, *lead,
                                   *args(n), stream(out.device)))
            return dx
        return run

    def shipped(evict=None):
        def args(n):
            g = epi.epilogue_geometry(n)
            return int(g.evict if evict is None else evict), g.tiles
        return args

    def unrolled(unroll, evict, per_sm):
        def args(n):
            tiles = n // (epi.EPI_TILE * unroll)
            grid = tiles + (1 if n % (epi.EPI_TILE * unroll) else 0)
            if per_sm is not None:
                grid = min(grid, per_sm * SMS)
            return unroll, int(evict), tiles, grid
        return args

    fwd_types = [vp, vp, i64, i32, f32, i32, i64, vp]
    bwd_types = [vp, vp, vp, i64, i32, f32, i32, i64, vp]
    built = libs['built']
    cands = {
        'act_fwd': {'shipped': lambda x: kernels.act_forward(x, 'relu')},
        'act_bwd': {'shipped': lambda g, out: kernels.act_backward(
            g, out, 'relu')}}
    for name, evict in (('u1_st', False), ('u1_cs', True)):
        cands['act_fwd'][name] = fwd(_entry(built, 'mx_act_fwd', fwd_types),
                                     relu, 0.0, args=shipped(evict))
        cands['act_bwd'][name] = bwd(_entry(built, 'mx_act_bwd', bwd_types),
                                     relu, 0.0, args=shipped(evict))
    lib = libs['unrolled']
    for name, (unroll, evict, per_sm) in UNROLLED.items():
        cands['act_fwd'][name] = fwd(
            _entry(lib, 'mx_act_fwd_unrolled', [vp, vp, i64, i32, i32, i64,
                                               i32, vp]),
            args=unrolled(unroll, evict, per_sm))
        cands['act_bwd'][name] = bwd(
            _entry(lib, 'mx_act_bwd_unrolled', [vp, vp, vp, i64, i32, i32,
                                               i64, i32, vp]),
            args=unrolled(unroll, evict, per_sm))
    for name in ACT_VARIANTS:
        lib = libs[name]
        if name == 'scalar':
            cands['act_fwd'][name] = fwd(_entry(
                lib, 'mx_act_fwd_scalar', fwd_types[:5] + [vp]), relu, 0.0)
            cands['act_bwd'][name] = bwd(_entry(
                lib, 'mx_act_bwd_scalar', bwd_types[:6] + [vp]), relu, 0.0)
        else:
            cands['act_fwd'][name] = fwd(_entry(lib, 'mx_act_fwd', fwd_types),
                                         relu, 0.0, args=shipped())
            cands['act_bwd'][name] = bwd(_entry(lib, 'mx_act_bwd', bwd_types),
                                         relu, 0.0, args=shipped())
    cands['act_fwd']['library'] = torch.relu
    cands['act_bwd']['library'] = (
        lambda g, out: torch.ops.aten.threshold_backward(g, out, 0))
    return cands


def _bn_candidates(torch, F, kernels, epi, libs):
    """{kernel: {name: fn(*inputs) -> output}} for bn_act_fwd (inputs x,
    scale, mean, beta and the library's var, gamma) and bn_act_bwd
    (inputs g, out, scale); identity throughout, the coefficients along
    axis 1."""
    from mxnet_tpu_torch.ops.kernels._launch import ptr, raise_on, stream
    i64, i32, u32, f32, vp = (ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_uint, ctypes.c_float, ctypes.c_void_p)
    stream_types = [i64, i64, i64, u32, i32, u32, i32, i32, f32, i32, i64,
                    vp]
    scalar_types = [i64, i32, i64, i32, f32, vp]

    def around(t):
        return t.numel(), t.shape[1], t[0, 0].numel()

    def stream_args(t):
        n, c, inner = around(t)
        g = epi.bn_geometry(n, c, inner)
        return (n, c, inner, g.inner.mul, g.inner.shift, g.c.mul,
                g.c.shift, 0, 0.0, int(g.evict), g.tiles)

    def scalar_args(t):
        n, c, inner = around(t)
        return n, c, inner, 0, 0.0

    def fwd(fn, args):
        def run(x, scale, mean, beta, *_):
            out = torch.empty_like(x)
            raise_on('bn_act_fwd', fn(ptr(x), ptr(scale), ptr(mean),
                                      ptr(beta), ptr(out), *args(x),
                                      stream(x.device)))
            return out
        return run

    def bwd(fn, args):
        def run(g, out, scale):
            dx = torch.empty_like(out)
            raise_on('bn_act_bwd', fn(ptr(g), ptr(out), ptr(scale),
                                      ptr(dx), *args(out),
                                      stream(out.device)))
            return dx
        return run

    cands = {
        'bn_act_fwd': {'shipped': lambda x, scale, mean, beta, *_:
                       kernels.bn_act_forward(x, scale, mean, beta)},
        'bn_act_bwd': {'shipped': lambda g, out, scale:
                       kernels.bn_act_backward(g, out, scale)}}
    for name, suffix, types, args in (
            ('scalar', '_scalar', [vp] * 5 + scalar_types, scalar_args),
            ('per_elem', '_per_elem', [vp] * 5 + stream_types,
             stream_args)):
        lib = libs[name]
        cands['bn_act_fwd'][name] = fwd(
            _entry(lib, 'mx_bn_act_fwd' + suffix, types), args)
        cands['bn_act_bwd'][name] = bwd(
            _entry(lib, 'mx_bn_act_bwd' + suffix, types[1:]), args)
    cands['bn_act_fwd']['library'] = (
        lambda x, scale, mean, beta, var, gamma: F.batch_norm(
            x, mean, var, gamma, beta, training=False, eps=BN_EPS))
    cands['bn_act_bwd']['library'] = (
        lambda g, out, scale: torch.mul(g, scale.view(1, -1, 1, 1)))
    return cands


def _inputs(torch, kernel, shape, gen):
    x = torch.randn(shape, generator=gen, device='cuda') * 3
    if kernel == 'act_fwd':
        return (x,)
    g = torch.randn(shape, generator=gen, device='cuda')
    if kernel == 'act_bwd':
        return g, torch.relu(x)
    c = shape[1]
    gamma = torch.rand(c, generator=gen, device='cuda') + 0.5
    var = torch.rand(c, generator=gen, device='cuda') + 0.5
    mean, beta = (torch.randn(c, generator=gen, device='cuda')
                  for _ in range(2))
    scale = torch.rsqrt(var + BN_EPS) * gamma
    if kernel == 'bn_act_fwd':
        return x, scale, mean, beta, var, gamma
    return g, x, scale


def _plain(kernels, kernel, inputs):
    if kernel == 'act_fwd':
        return kernels.act_forward_reference(inputs[0], 'relu')
    if kernel == 'act_bwd':
        return kernels.act_backward_reference(*inputs, 'relu')
    if kernel == 'bn_act_fwd':
        return kernels.bn_act_forward_reference(*inputs[:4])
    return kernels.bn_act_backward_reference(*inputs)


def _agrees(kernel, name, got, want):
    """Bitwise, but for ``batch_norm``'s own arithmetic (the library
    forward): within 1e-5 of the plain result's max abs."""
    if kernel == 'bn_act_fwd' and name == 'library':
        return bool((got - want).abs().max() <= 1e-5 * want.abs().max())
    return bool(got.equal(want))


def _check(torch, kernels, cands, gen):
    """Every candidate against the plain version at the odd sizes, relu
    for the act kernels, identity for the BN apply (the library too);
    the shipped act kernels also with leaky."""
    for kernel, fns in cands.items():
        bn = kernel.startswith('bn_')
        for shape in BN_ODD if bn else [(n,) for n in ODD_SIZES]:
            inputs = _inputs(torch, kernel, shape, gen)
            want = _plain(kernels, kernel, inputs)
            for name, fn in fns.items():
                if not _agrees(kernel, name, fn(*inputs), want):
                    raise AssertionError('%s %s disagrees with the plain '
                                         'version at %s' % (kernel, name,
                                                            shape))
    if 'act_fwd' not in cands:
        return
    for n in ODD_SIZES:
        x, g = (torch.randn(n, generator=gen, device='cuda')
                for _ in range(2))
        out = kernels.act_forward(x, 'leaky', 0.25)
        if not (torch.equal(out, kernels.act_forward_reference(
                x, 'leaky', 0.25)) and torch.equal(
                kernels.act_backward(g, out, 'leaky', 0.25),
                kernels.act_backward_reference(g, out, 'leaky', 0.25))):
            raise AssertionError('leaky disagrees at %d elements' % n)


def _time_shape(torch, kernels, kernel, fns, shape, start, gen, log):
    """Check every candidate at ``shape``, then time each in two turns:
    the candidates in order from the ``start``-th on, wrapping, then in
    reverse."""
    inputs = _inputs(torch, kernel, shape, gen)
    want = _plain(kernels, kernel, inputs)
    for name, fn in fns.items():
        if not _agrees(kernel, name, fn(*inputs), want):
            raise AssertionError('%s %s disagrees with the plain version at '
                                 '%s' % (kernel, name, shape))
    del want
    nbytes = sum(t.numel() * 4 for t in inputs)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(cold_copies(nbytes) - 1)]
    times = {name: [] for name in fns}
    names = list(fns)
    order = names[start % len(names):] + names[:start % len(names)]
    for name in order + order[::-1]:
        fn = fns[name]
        times[name].append(slope_ms(
            torch, lambda i, fn=fn: fn(*copies[i % len(copies)])))
    n = inputs[0].numel()
    bound = n * BYTES_PER_ELEMENT[kernel] / PEAK_BYTES_S * 1e3
    log('%s %s: %s timed first' % (kernel, shape, order[0]))
    for name in names:
        t = statistics.mean(times[name])
        log('%s %s %s: device ms %s, share of the %.4f ms bound %.3f'
            % (kernel, shape, name, ' / '.join('%.4f' % v
                                               for v in times[name]),
               bound, bound / t))
    return {'bound_ms': bound, 'first': order[0], 'times': times}


def _add_relu(torch, kernels, gen, log):
    """Whether ``aten._add_relu`` runs on the card; if it does, it is held
    bitwise to add_act_fwd's plain version at the first join shape and
    timed beside add_act_fwd (device ms)."""
    x, y = (torch.randn(JOIN, generator=gen, device='cuda')
            for _ in range(2))
    try:
        got = torch.ops.aten._add_relu(x, y)
    except NotImplementedError as exc:
        msg = str(exc).splitlines()[0]
        log('aten._add_relu has no CUDA kernel: %s' % msg)
        return {'runs': False, 'error': msg}
    if not torch.equal(got, kernels.add_act_forward_reference(x, y, 'relu')):
        raise AssertionError('aten._add_relu disagrees with relu(x + y)')
    copies = [(x, y)] + [(x.clone(), y.clone()) for _ in range(
        cold_copies(8 * x.numel()) - 1)]
    row = {'runs': True}
    for name, fn in (('add_act_fwd', lambda x, y: kernels.add_act_forward(
            x, y, 'relu')), ('_add_relu', torch.ops.aten._add_relu)):
        row[name] = slope_ms(torch, lambda i, fn=fn: fn(*copies[i % len(
            copies)]))
    log('aten._add_relu runs on the card, %s: device ms %.4f, add_act_fwd '
        '%.4f' % (JOIN, row['_add_relu'], row['add_act_fwd']))
    return row


# the source variants each family's candidates need
FAMILY_VARIANTS = {'act': ('unrolled',) + ACT_VARIANTS,
                   'bn': ('scalar', 'per_elem')}


def main(argv=None):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import epilogue as epi
    argv = sys.argv[1:] if argv is None else argv
    families = argv or ['act', 'bn']
    if not set(families) <= set(FAMILY_VARIANTS):
        raise SystemExit('usage: probe_epilogue_variants [act|bn]')
    if not torch.cuda.is_available():
        raise RuntimeError('probe_epilogue_variants: no CUDA device')

    def log(line):
        print(line, flush=True)

    dev = card()
    log(dev)
    wanted = sorted({v for f in families for v in FAMILY_VARIANTS[f]})
    started = {n: _start_variant(_build, n, *SOURCE_VARIANTS[n][1:])
               for n in wanted}
    shipped = _build._start('epilogue')
    ptxas = {}
    if shipped is not None:
        ptxas['built'] = _build._finish('epilogue', shipped, 600)
    libs = {'built': _build.load('epilogue')}
    for name, (proc, so) in started.items():
        ptxas[name] = _reap(proc, 'variant ' + name)
        libs[name] = ctypes.CDLL(so)
    gen = torch.Generator(device='cuda').manual_seed(10)
    cands, plan = {}, []
    if 'act' in families:
        cands.update(_act_candidates(torch, kernels, epi, libs))
        plan += [('act_fwd', FWD_SHAPES), ('act_bwd', BWD_SHAPES)]
    if 'bn' in families:
        cands.update(_bn_candidates(torch, F, kernels, epi, libs))
        plan += [('bn_act_fwd', BN_SHAPES), ('bn_act_bwd', BN_SHAPES)]
    _check(torch, kernels, cands, gen)
    log('every candidate agrees with the plain version at the odd sizes '
        '(bitwise; batch_norm within 1e-5 of the max abs)')
    result = {'card': dev, 'kernels': {}}
    for kernel, shapes in plan:
        rows = {}
        # the first timed turn can read high: the order starts one
        # candidate later at each shape, never with the shipped kernel
        for k, (shape, _) in enumerate(shapes):
            rows[shape] = _time_shape(torch, kernels, kernel, cands[kernel],
                                      shape, k + 1, gen, log)
            torch.cuda.empty_cache()
        bound = sum(w * rows[s]['bound_ms'] for s, w in shapes)
        launches = sum(w for _, w in shapes)
        elements = sum(w * torch.Size(s).numel() for s, w in shapes)
        sums = {name: sum(w * statistics.mean(rows[s]['times'][name])
                          for s, w in shapes) for name in cands[kernel]}
        log('%s over one step (%d launches, %.1f M elements), bound %.4f ms: '
            '%s' % (kernel, launches, elements / 1e6, bound, ', '.join(
                '%s %.4f ms (%.3f)' % (name, t, bound / t)
                for name, t in sums.items())))
        result['kernels'][kernel] = {
            'step_bound_ms': bound, 'step_ms': sums,
            'shapes': {str(s): r for s, r in rows.items()}}
    resources = {name: kernel_resources(text)
                 for name, text in ptxas.items()}
    for name, found in resources.items():
        log('ptxas %s (kernel<act code or unroll, evict-first>: registers, '
            'spill bytes): %s'
            % (name, dict(sorted(found.items()))))
    if 'built' not in ptxas:
        log('ptxas built: the library was current, not rebuilt')
    result['ptxas'] = resources
    if 'act' in families:
        result['add_relu'] = _add_relu(torch, kernels, gen, log)
    log(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
