"""Elementwise epilogue kernels: CUDA kernels and their plain PyTorch
versions.

The counterpart of ``mxnet_tpu/ops/pallas/epilogue.py``. Five kernels, all
in ``csrc/epilogue.cu``, float32 and bf16, over the tensor's elements
unpadded:

  * :func:`bn_act_forward` replaces ``mxnet_tpu_bn_act_fwd``
    (epilogue.py:124): ``act((x - mean) * scale + beta)`` with (C,)
    coefficients along ``axis``;
  * :func:`bn_act_backward` replaces ``mxnet_tpu_bn_act_bwd`` (:136):
    ``dx = g * act'(out) * scale``;
  * :func:`act_forward` replaces ``mxnet_tpu_act_fwd`` (:234): ``act(x)``;
  * :func:`act_backward` replaces ``mxnet_tpu_act_bwd`` (:239):
    ``g * act'(out)``, from the output alone;

these four stream 16-byte vectors, in whole tiles of
``EPI_THREADS * EPI_VEC`` floats and a rest, as :func:`epilogue_geometry`
partitions the elements, an output of at least the L2's size stored
evict-first; the BN apply finds the channel of a vector's first element
by two multiply-high divisions (:func:`fast_divisor`,
:func:`bn_geometry`) and steps the others from it;
  * :func:`add_act_forward` replaces ``mxnet_tpu_add_act_fwd`` (:297):
    ``act(x + y)``.

bf16 (AMP and ``net.cast('bfloat16')``): every entry point takes its
activations (``x``, ``y``, ``g``, ``out``) all float32 or all bfloat16
and launches that dtype's instance (counted as ``<kernel>.bf16``, e.g.
``bn_act_fwd.bf16``), whose stream has 8 elements a 16-byte vector
(``epilogue_geometry(n, 2)``); the BN apply's (C,) ``scale``, ``mean``
and ``beta`` stay float32 at either dtype, as the reference passes them.
Mixed activation dtypes, fp16 and other types raise ``TypeError``. An
instance widens on load, computes in float32 as the float32 one and
rounds once, so it is bitwise the float32 kernel on the widened input,
rounded; the plain versions widen, compute in float32 and round to the
input dtype.

``act'`` comes from the output alone (:func:`act_grad_from_out`), for the
covered set :data:`ACT_TYPES`; ``None`` means identity. Three
``torch.autograd.Function``s wire them as the JAX custom_vjps do:
:class:`ActFunction` saves the output only, :class:`AddActFunction`
gives ``dx, dx`` from the output, :class:`BnApplyFunction` takes ``dx``
from the ``bn_act_backward`` kernel and the coefficient gradients
``dscale``, ``dmean``, ``dbeta`` from plain reductions, as
``_bn_apply_bwd`` (:162-181) does outside its kernel.

Wrapper rules as in ``attention.py``: a CPU tensor takes the plain version
(the ``*_reference`` functions), a CUDA tensor launches the kernel or
raises, and each launch is counted. A CUDA input that is not contiguous
(the global average pool's backward hands over an expanded view) or not
16-byte aligned is copied into a dense tensor first.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ._launch import (check_inputs as _check_inputs, count as _count,
                      dense as _dense, instance as _instance,
                      io_dtype as _io_dtype, on_cpu as _on_cpu, ptr as _ptr,
                      raise_on as _raise_on, require as _require,
                      stream as _stream)

__all__ = ['ACT_TYPES', 'MAX_ELEMENTS', 'EPI_THREADS', 'EPI_VEC',
           'EPI_TILE', 'EpilogueGeometry', 'epilogue_geometry',
           'Divisor', 'fast_divisor', 'BnGeometry',
           'bn_geometry', 'act_reference',
           'act_grad_from_out', 'act_forward', 'act_forward_reference',
           'act_backward', 'act_backward_reference', 'add_act_forward',
           'add_act_forward_reference', 'bn_act_forward',
           'bn_act_forward_reference', 'bn_act_backward',
           'bn_act_backward_reference', 'ActFunction', 'AddActFunction',
           'BnApplyFunction', 'fused_act', 'fused_add_act',
           'fused_bn_apply']

# the activations the kernels cover, by the code csrc/epilogue.cu reads
ACT_TYPES = ('identity', 'relu', 'sigmoid', 'tanh', 'softrelu', 'softsign',
             'leaky')
_CODE = {name: i for i, name in enumerate(ACT_TYPES)}


def _code(act_type):
    name = 'identity' if act_type is None else act_type
    try:
        return _CODE[name]
    except KeyError:
        raise ValueError('unsupported epilogue act_type %r (have %s)'
                         % (act_type, ', '.join(ACT_TYPES)))


def act_reference(x, act_type, slope=0.0):
    """``act(x)`` in float32, the expressions of ``_act_apply``
    (epilogue.py:45-63): softrelu is ``logaddexp(x, 0)``, leaky
    ``where(x >= 0, x, slope * x)``."""
    name = ACT_TYPES[_code(act_type)]
    if name == 'relu':
        return torch.relu(x)
    if name == 'sigmoid':
        return torch.sigmoid(x)
    if name == 'tanh':
        return torch.tanh(x)
    if name == 'softrelu':
        return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
    if name == 'softsign':
        return x / (x.abs() + 1)
    if name == 'leaky':
        return torch.where(x >= 0, x, slope * x)
    return x


def act_grad_from_out(out, act_type, slope=0.0):
    """``d act / d x`` from the output alone, the closed forms of
    ``_act_grad_from_out`` (epilogue.py:66-85)."""
    name = ACT_TYPES[_code(act_type)]
    one = torch.ones_like(out)
    if name == 'relu':
        return (out > 0).to(out.dtype)
    if name == 'sigmoid':
        return out * (1 - out)
    if name == 'tanh':
        return 1 - out * out
    if name == 'softrelu':
        return 1 - torch.exp(-out)
    if name == 'softsign':
        a = 1 - out.abs()
        return a * a
    if name == 'leaky':
        return torch.where(out >= 0, one, slope * one)
    return one


def _lib(entry, nargs):
    from . import _build
    fn = getattr(_build.load('epilogue'), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = nargs
    return fn


_P, _N, _I, _U, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_uint, ctypes.c_float)
# the kernels index elements in 32 bits
MAX_ELEMENTS = 2 ** 31 - 1

# the stream of the BN apply, the activation kernels and the xent
# backward (csrc/stream.cuh): threads a block, floats a vector (one of
# each input a thread), floats a tile (a block); an output of at least
# the L2's 50 MB is stored evict-first, as tools/probe_epilogue_variants.py
# measured fastest on the H100 at ResNet-50's relu and join shapes
EPI_THREADS = 256
EPI_VEC = 4
EPI_TILE = EPI_THREADS * EPI_VEC
EPI_EVICT_BYTES = 50 * 10 ** 6

EpilogueGeometry = collections.namedtuple(
    'EpilogueGeometry', 'evict tiles body rest tail grid')


def epilogue_geometry(n, itemsize=4):
    """Launch geometry of the stream kernels for ``n`` elements of
    ``itemsize`` bytes (4: float32, 2: bf16), as an
    :class:`EpilogueGeometry`: a 16-byte vector holds ``vec = 16 //
    itemsize`` elements (:data:`EPI_VEC` floats), a tile ``EPI_THREADS *
    vec``; ``tiles`` whole tiles (``body`` elements), one block each, and
    one block more (``grid`` counts it) for the ``rest`` (whole vectors
    past the tiles, fewer than a tile) and the ``tail`` of ``n % vec``
    scalars; ``evict``: the output, ``itemsize * n`` bytes, is at least
    :data:`EPI_EVICT_BYTES` and is stored evict-first."""
    vec = 16 // itemsize
    tile = EPI_THREADS * vec
    tiles = n // tile
    body = tiles * tile
    tail = n % vec
    rest = n - body - tail
    return EpilogueGeometry(itemsize * n >= EPI_EVICT_BYTES, tiles, body,
                            rest, tail, tiles + (1 if rest or tail else 0))


Divisor = collections.namedtuple('Divisor', 'd mul shift')


def fast_divisor(d):
    """The divisor ``d`` in [1, 2**31) as csrc/stream.cuh ``Divisor``
    divides by it: ``i // d == (i * mul >> 32) >> shift`` for every
    ``i < 2**31`` (Granlund-Montgomery, as CUTLASS's ``FastDivmod``), with
    ``l = ceil(log2 d)``, ``mul = ceil(2**(31 + l) / d)``, below 2**32,
    and ``shift = l - 1``; ``d = 1`` has ``mul = 0`` (the kernel then
    takes ``i`` itself). The kernel takes these numbers as given: this
    function is the one place they are computed."""
    d = int(d)
    if not 1 <= d <= MAX_ELEMENTS:
        raise ValueError('fast_divisor: %d is not in [1, 2**31)' % d)
    if d == 1:
        return Divisor(1, 0, 0)
    l = (d - 1).bit_length()
    return Divisor(d, -(-(1 << (31 + l)) // d), l - 1)


BnGeometry = collections.namedtuple(
    'BnGeometry', EpilogueGeometry._fields + ('inner', 'c'))


def bn_geometry(n, c, inner, itemsize=4):
    """Launch geometry of the BN apply kernels for ``n`` elements of
    ``itemsize`` bytes (4: float32, 2: bf16) of a tensor (outer, ``c``,
    ``inner``) around the BN axis, as a :class:`BnGeometry`: the stream's
    partition and store kind of :func:`epilogue_geometry` and the
    :class:`Divisor` of ``inner`` and of ``c``."""
    return BnGeometry(*epilogue_geometry(n, itemsize), fast_divisor(inner),
                      fast_divisor(c))


def _launch(kernel, entry, argtypes, tensors, result, *scalars,
            coeffs=None):
    """Check ``tensors`` (name -> input of ``result``'s dtype), the
    float32 per-channel vectors ``coeffs`` (name -> tensor) and
    ``result``, launch ``entry`` with all of them in that order on the
    current stream and count it under ``kernel``; returns ``result``."""
    named = dict(tensors)
    dtypes = dict.fromkeys(named, result.dtype)
    for label, t in (coeffs or {}).items():
        named[label] = t
        dtypes[label] = torch.float32
    named['result'] = result
    dtypes['result'] = result.dtype
    _check_inputs(kernel, named, dtypes)
    _require(result.numel() <= MAX_ELEMENTS, '%s: %d elements, more than '
             'the %d the kernel indexes' % (kernel, result.numel(),
                                            MAX_ELEMENTS))
    device = result.device
    with torch.cuda.device(device):
        err = _lib(entry, argtypes)(*[_ptr(t) for t in named.values()],
                                    *scalars, _stream(device))
    _raise_on(kernel, err)
    _count(kernel)
    return result


def _empty(like, dtype=torch.float32):
    return torch.empty(like.shape, dtype=dtype, device=like.device)


def _same_shape(kernel, a, b):
    _require(a.shape == b.shape, '%s: shapes %r and %r differ'
             % (kernel, tuple(a.shape), tuple(b.shape)))


# -- activation forward / backward -------------------------------------------


def act_forward_reference(x, act_type, slope=0.0):
    """Plain PyTorch version of :func:`act_forward`."""
    return act_reference(x.float(), act_type, slope).to(x.dtype)


def act_forward(x, act_type, slope=0.0):
    """``act(x)``, any shape, float32 or bfloat16."""
    code = _code(act_type)
    dt = _io_dtype('act_forward', {'x': x})
    if _on_cpu('act_forward', x):
        return act_forward_reference(x, act_type, slope)
    x = _dense(x)
    name, entry = _instance('act_fwd', 'mx_act_fwd', dt)
    geom = epilogue_geometry(x.numel(), x.element_size())
    return _launch(name, entry, [_P, _P, _N, _I, _F, _I, _N, _P],
                   {'x': x}, _empty(x, dt), x.numel(), code, float(slope),
                   int(geom.evict), geom.tiles)


def act_backward_reference(g, out, act_type, slope=0.0):
    """Plain PyTorch version of :func:`act_backward`."""
    of = out.float()
    return (g.float() * act_grad_from_out(of, act_type, slope)).to(out.dtype)


def act_backward(g, out, act_type, slope=0.0):
    """``g * act'(out)``, the gradient of ``act`` from its output; ``g``
    and ``out`` both float32 or both bfloat16."""
    code = _code(act_type)
    dt = _io_dtype('act_backward', {'g': g, 'out': out})
    if _on_cpu('act_backward', out):
        return act_backward_reference(g, out, act_type, slope)
    _same_shape('act_backward', g, out)
    g, out = _dense(g), _dense(out)
    name, entry = _instance('act_bwd', 'mx_act_bwd', dt)
    geom = epilogue_geometry(out.numel(), out.element_size())
    return _launch(name, entry, [_P, _P, _P, _N, _I, _F, _I, _N, _P],
                   {'g': g, 'out': out}, _empty(out, dt), out.numel(), code,
                   float(slope), int(geom.evict), geom.tiles)


def add_act_forward_reference(x, y, act_type='relu', slope=0.0):
    """Plain PyTorch version of :func:`add_act_forward`."""
    return act_reference(x.float() + y.float(), act_type,
                         slope).to(x.dtype)


def add_act_forward(x, y, act_type='relu', slope=0.0):
    """``act(x + y)`` of two tensors of one shape, both float32 or both
    bfloat16."""
    code = _code(act_type)
    dt = _io_dtype('add_act_forward', {'x': x, 'y': y})
    if _on_cpu('add_act_forward', x):
        return add_act_forward_reference(x, y, act_type, slope)
    _same_shape('add_act_forward', x, y)
    x, y = _dense(x), _dense(y)
    name, entry = _instance('add_act_fwd', 'mx_add_act_fwd', dt)
    if dt == torch.float32:
        return _launch(name, entry, [_P, _P, _P, _N, _I, _F, _P],
                       {'x': x, 'y': y}, _empty(x), x.numel(), code,
                       float(slope))
    geom = epilogue_geometry(x.numel(), x.element_size())
    return _launch(name, entry, [_P, _P, _P, _N, _I, _F, _I, _N, _P],
                   {'x': x, 'y': y}, _empty(x, dt), x.numel(), code,
                   float(slope), int(geom.evict), geom.tiles)


# -- BatchNorm apply forward / backward --------------------------------------


def _channel_shape(x, axis):
    ax = axis % x.dim()
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    return ax, shape


def _around(x, ax):
    """(C, inner) of ``x`` split as (outer, C, inner) around axis
    ``ax``."""
    inner = 1
    for s in x.shape[ax + 1:]:
        inner *= s
    return x.shape[ax], inner


# the BN entry points' scalars after the tensors: n, c, inner, inner's
# and c's divisors, act, slope, evict, tiles, stream
_BN_ARGS = [_N, _N, _N, _U, _I, _U, _I, _I, _F, _I, _N, _P]


def _bn_args(n, c, inner, code, slope, itemsize=4):
    # an empty tensor launches nothing (the entry points return first),
    # and its C or inner may be 0, which no divisor takes
    geom = bn_geometry(n, max(c, 1), max(inner, 1), itemsize)
    return (n, c, inner, geom.inner.mul, geom.inner.shift, geom.c.mul,
            geom.c.shift, code, float(slope), int(geom.evict), geom.tiles)


def bn_act_forward_reference(x, scale, mean, beta, axis=1, act_type=None,
                             slope=0.0):
    """Plain PyTorch version of :func:`bn_act_forward`: the expression
    order of ``_bn_train_fwd_impl`` (ops/nn.py:830)."""
    _, shape = _channel_shape(x, axis)
    y = (x.float() - mean.float().reshape(shape)) \
        * scale.float().reshape(shape) + beta.float().reshape(shape)
    return act_reference(y, act_type, slope).to(x.dtype)


def bn_act_forward(x, scale, mean, beta, axis=1, act_type=None, slope=0.0):
    """``act((x - mean) * scale + beta)`` with (C,) float32 coefficients
    along ``axis`` of ``x`` (float32 or bfloat16)."""
    code = _code(act_type)
    dt = _io_dtype('bn_act_forward', {'x': x})
    if _on_cpu('bn_act_forward', x):
        return bn_act_forward_reference(x, scale, mean, beta, axis,
                                        act_type, slope)
    ax, _ = _channel_shape(x, axis)
    c, inner = _around(x, ax)
    for label, v in (('scale', scale), ('mean', mean), ('beta', beta)):
        _require(tuple(v.shape) == (c,), 'bn_act_forward: %s has shape %r, '
                 'expected (%d,)' % (label, tuple(v.shape), c))
    x, scale, mean, beta = (_dense(t) for t in (x, scale, mean, beta))
    name, entry = _instance('bn_act_fwd', 'mx_bn_act_fwd', dt)
    return _launch(name, entry, [_P] * 5 + _BN_ARGS, {'x': x}, _empty(x, dt),
                   *_bn_args(x.numel(), c, inner, code, slope,
                             x.element_size()),
                   coeffs={'scale': scale, 'mean': mean, 'beta': beta})


def bn_act_backward_reference(g, out, scale, axis=1, act_type=None,
                              slope=0.0):
    """Plain PyTorch version of :func:`bn_act_backward`."""
    _, shape = _channel_shape(out, axis)
    of = out.float()
    dx = g.float() * act_grad_from_out(of, act_type, slope) \
        * scale.float().reshape(shape)
    return dx.to(out.dtype)


def bn_act_backward(g, out, scale, axis=1, act_type=None, slope=0.0):
    """``g * act'(out) * scale`` with (C,) float32 ``scale`` along
    ``axis``; ``g`` and ``out`` both float32 or both bfloat16."""
    code = _code(act_type)
    dt = _io_dtype('bn_act_backward', {'g': g, 'out': out})
    if _on_cpu('bn_act_backward', out):
        return bn_act_backward_reference(g, out, scale, axis, act_type,
                                         slope)
    _same_shape('bn_act_backward', g, out)
    ax, _ = _channel_shape(out, axis)
    c, inner = _around(out, ax)
    _require(tuple(scale.shape) == (c,), 'bn_act_backward: scale has shape '
             '%r, expected (%d,)' % (tuple(scale.shape), c))
    g, out, scale = _dense(g), _dense(out), _dense(scale)
    name, entry = _instance('bn_act_bwd', 'mx_bn_act_bwd', dt)
    return _launch(name, entry, [_P] * 4 + _BN_ARGS, {'g': g, 'out': out},
                   _empty(out, dt),
                   *_bn_args(out.numel(), c, inner, code, slope,
                             out.element_size()),
                   coeffs={'scale': scale})


# -- autograd wiring ----------------------------------------------------------


class ActFunction(torch.autograd.Function):
    """``_act_kernel_core`` (epilogue.py:257-273): the residual is the
    output only."""

    @staticmethod
    def forward(ctx, x, act_type, slope):
        out = act_forward(x, act_type, slope)
        ctx.save_for_backward(out)
        ctx.act_type, ctx.slope = act_type, slope
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        return act_backward(g, out, ctx.act_type, ctx.slope), None, None


class AddActFunction(torch.autograd.Function):
    """``_add_act_core`` (epilogue.py:300-319): both addends' gradients
    are ``g * act'(out)``, one ``act_bwd`` launch."""

    @staticmethod
    def forward(ctx, x, y, act_type, slope):
        out = add_act_forward(x, y, act_type, slope)
        ctx.save_for_backward(out)
        ctx.act_type, ctx.slope = act_type, slope
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        dx = act_backward(g, out, ctx.act_type, ctx.slope)
        return dx, dx, None, None


class BnApplyFunction(torch.autograd.Function):
    """``_bn_apply_core`` (epilogue.py:148-184): ``dx`` from the
    ``bn_act_bwd`` kernel; ``dscale``, ``dmean`` and ``dbeta`` as plain
    reductions over every axis but ``axis``."""

    @staticmethod
    def forward(ctx, x, scale, mean, beta, axis, act_type, slope):
        out = bn_act_forward(x, scale, mean, beta, axis, act_type, slope)
        ctx.save_for_backward(out, scale, mean, x)
        ctx.axis, ctx.act_type, ctx.slope = axis, act_type, slope
        return out

    @staticmethod
    def backward(ctx, g):
        out, scale, mean, x = ctx.saved_tensors
        axis, act_type, slope = ctx.axis, ctx.act_type, ctx.slope
        dx = bn_act_backward(g, out, scale, axis, act_type, slope)
        dscale = dmean = dbeta = None
        if any(ctx.needs_input_grad[1:4]):
            ax, shape = _channel_shape(out, axis)
            red = tuple(i for i in range(out.dim()) if i != ax)
            local = g.float() * act_grad_from_out(out.float(), act_type,
                                                  slope)
            cen = x.float() - mean.float().reshape(shape)
            dscale = torch.sum(local * cen, dim=red).to(scale.dtype)
            sum_local = torch.sum(local, dim=red)
            dmean = (-sum_local * scale.float()).to(mean.dtype)
            dbeta = sum_local.to(scale.dtype)
        return dx, dscale, dmean, dbeta, None, None, None


def fused_act(x, act_type, slope=0.0):
    """Activation with the save-output backward (``fused_act``,
    epilogue.py:276)."""
    return ActFunction.apply(x, act_type, float(slope))


def fused_add_act(x, y, act_type='relu', slope=0.0):
    """``act(x + y)`` with ``d/dx = d/dy = g * act'(out)``
    (``fused_add_act``, epilogue.py:325)."""
    return AddActFunction.apply(x, y, act_type, float(slope))


def fused_bn_apply(x, scale, mean, beta, axis=1, act_type=None, slope=0.0):
    """``act((x - mean) * scale + beta)`` with (C,) coefficients along
    ``axis``, differentiable in ``x`` and the coefficients
    (``fused_bn_apply``, epilogue.py:187)."""
    return BnApplyFunction.apply(x, scale, mean, beta, int(axis), act_type,
                                 float(slope))
