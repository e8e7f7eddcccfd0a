"""Elementwise, scalar, broadcast and reduction ops, the counterpart of
``mxnet_tpu/ops/math.py``.

Each body is the JAX body's expression in torch, in its order of
operations (``rint`` as ``ceil(x - 0.5)``, ``round`` half away from
zero, ``gamma`` as ``exp(lgamma(x))``, the comparison ops cast to the
operands' result type), so the elementwise ops agree with the JAX
package bit for bit and the transcendental ones within the libraries'
ULPs. None of them is a Pallas kernel in the JAX package: XLA fuses
them there, and here they are plain torch.
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .registry import alias, register


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_UNARY = {
    'abs': torch.abs, 'sign': torch.sign,
    'rint': lambda x: torch.ceil(x - 0.5), 'ceil': torch.ceil,
    'floor': torch.floor, 'trunc': torch.trunc, 'fix': torch.trunc,
    'square': torch.square, 'sqrt': torch.sqrt,
    'cbrt': _cbrt, 'exp': torch.exp, 'log': torch.log,
    'log10': torch.log10, 'log2': torch.log2, 'log1p': torch.log1p,
    'expm1': torch.expm1,
    'sin': torch.sin, 'cos': torch.cos, 'tan': torch.tan,
    'arcsin': torch.asin, 'arccos': torch.acos, 'arctan': torch.atan,
    'sinh': torch.sinh, 'cosh': torch.cosh, 'tanh': torch.tanh,
    'arcsinh': torch.asinh, 'arccosh': torch.acosh,
    'arctanh': torch.atanh,
    'degrees': lambda x: x * (180.0 / math.pi),
    'radians': lambda x: x * (math.pi / 180.0),
    'negative': torch.neg, 'reciprocal': lambda x: 1.0 / x,
    'rsqrt': torch.rsqrt, 'rcbrt': lambda x: 1.0 / _cbrt(x),
    'erf': torch.erf, 'erfinv': torch.erfinv,
    'gamma': lambda x: torch.exp(_lgamma(x)),
    'gammaln': lambda x: _lgamma(x),
    'logical_not': lambda x: (x == 0).to(x.dtype),
    'sigmoid': torch.sigmoid, 'softsign': lambda x: x / (1 + torch.abs(x)),
    'relu': torch.relu,
    'hard_sigmoid': lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    'isnan': torch.isnan, 'isinf': torch.isinf,
    'round': lambda x: torch.where(x >= 0, torch.floor(x + 0.5),
                                   torch.ceil(x - 0.5)),
}

_LANCZOS_G = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)


def _lgamma(x):
    """log|Gamma(x)| by XLA's Lanczos approximation (``Lgamma`` of XLA's
    math library, which ``jax.lax.lgamma`` lowers to), step for step in
    the input's dtype, with Euler's reflection below 1/2: the JAX op's
    value, which a correctly rounded lgamma misses by up to ~100 ULPs."""
    one_half = 0.5
    need_to_reflect = x < one_half
    z = torch.where(need_to_reflect, -x, x - 1.0)
    acc = torch.full_like(z, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        acc = acc + c / (z + float(i) + 1.0)
    t = (_LANCZOS_G + 0.5) + z
    log_t = math.log(_LANCZOS_G + 0.5) + torch.log1p(z / (_LANCZOS_G + 0.5))
    log_y = (math.log(2.0) + math.log(math.pi)) / 2 + \
        (z + one_half - t / log_t) * log_t + torch.log(acc)
    abs_x = torch.abs(x)
    frac = abs_x - torch.floor(abs_x)
    frac = torch.where(frac > 0.5, 1.0 - frac, frac)
    denom = torch.log(torch.sin(math.pi * frac))
    reflection = torch.where(torch.isfinite(denom),
                             math.log(math.pi) - denom - log_y, -denom)
    out = torch.where(need_to_reflect, reflection, log_y)
    return torch.where(torch.isinf(x), torch.full_like(x, math.inf), out)


def _floatify(x):
    """jnp's unary math on an integer array computes in float32."""
    return x if x.is_floating_point() else x.to(torch.float32)


for _name, _fn in _UNARY.items():
    def _mk(fn, name):
        exact = name in ('abs', 'sign', 'negative', 'square', 'isnan',
                         'isinf', 'logical_not', 'relu', 'ceil', 'floor',
                         'trunc', 'fix', 'rint', 'round')

        def _op(data):
            return fn(data if exact else _floatify(data))
        _op.__name__ = name
        return _op
    register(_name)(_mk(_fn, _name))

alias('negative', '_np_negative')
alias('abs', '_np_absolute')


@register('clip')
def clip(data, *, a_min=None, a_max=None):
    """Clip values to [a_min, a_max]."""
    return torch.clamp(data, a_min, a_max)


@register('smooth_l1')
def smooth_l1(data, *, scalar=1.0):
    s2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data * data,
                       absd - 0.5 / s2)


@register('Cast', aliases=('cast',))
def cast(data, *, dtype='float32'):
    return data.to(torch_dtype(dtype))


@register('_copy', aliases=('identity',))
def _copy(data):
    return data.clone()


@register('BlockGrad', aliases=('stop_gradient',))
def block_grad(data):
    return data.detach()


@register('make_loss', aliases=('MakeLoss',))
def make_loss(data, *, grad_scale=1.0, valid_thresh=0.0,
              normalization='null'):
    return data


@register('shape_array')
def shape_array(data):
    return torch.tensor(data.shape, dtype=torch.int32, device=data.device)


@register('size_array')
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register('zeros_like')
def zeros_like(data):
    return torch.zeros_like(data)


@register('ones_like')
def ones_like(data):
    return torch.ones_like(data)


# ---------------------------------------------------------------------------
# binary elementwise + broadcast
# ---------------------------------------------------------------------------

def _div(a, b):
    return torch.true_divide(a, b)


_BINARY = {
    'add': torch.add, 'sub': torch.sub, 'mul': torch.mul,
    'div': _div, 'mod': torch.remainder, 'power': torch.pow,
    'maximum': torch.maximum, 'minimum': torch.minimum,
    'hypot': lambda a, b: torch.hypot(_floatify(a), _floatify(b)),
    'equal': torch.eq, 'not_equal': torch.ne,
    'greater': torch.gt, 'greater_equal': torch.ge,
    'lesser': torch.lt, 'lesser_equal': torch.le,
    'logical_and': lambda a, b: (a != 0) & (b != 0),
    'logical_or': lambda a, b: (a != 0) | (b != 0),
    'logical_xor': lambda a, b: (a != 0) ^ (b != 0),
}

_CMP = {'equal', 'not_equal', 'greater', 'greater_equal', 'lesser',
        'lesser_equal', 'logical_and', 'logical_or', 'logical_xor'}

for _name, _fn in _BINARY.items():
    def _mk2(fn, cmp):
        def _op(lhs, rhs):
            out = fn(lhs, rhs)
            if cmp:
                out = out.to(torch.result_type(lhs, rhs))
            return out
        return _op
    _f = _mk2(_fn, _name in _CMP)
    # elemwise_* and broadcast_* share the body: torch broadcasts both
    register('elemwise_%s' % _name, num_inputs=2)(_f)
    register('broadcast_%s' % _name, num_inputs=2)(_f)

alias('elemwise_add', '_plus', '_Plus', '_add')
alias('elemwise_sub', '_minus', '_Minus', '_sub')
alias('elemwise_mul', '_mul', '_Mul')
alias('elemwise_div', '_div', '_Div')
alias('broadcast_mod', '_mod', '_Mod')
alias('broadcast_power', '_power', '_Power', '_pow')
alias('broadcast_maximum', '_maximum', '_Maximum')
alias('broadcast_minimum', '_minimum', '_Minimum')
alias('broadcast_hypot', '_hypot')
alias('broadcast_equal', '_equal')
alias('broadcast_not_equal', '_not_equal')
alias('broadcast_greater', '_greater')
alias('broadcast_greater_equal', '_greater_equal')
alias('broadcast_lesser', '_lesser')
alias('broadcast_lesser_equal', '_lesser_equal')
alias('broadcast_logical_and', '_logical_and')
alias('broadcast_logical_or', '_logical_or')
alias('broadcast_logical_xor', '_logical_xor')


@register('_grad_add', num_inputs=2)
def _grad_add(lhs, rhs):
    return lhs + rhs


@register('add_n', num_inputs=-1, key_var_num_args='num_args',
          aliases=('ElementWiseSum', '_sum'))
def add_n(args, *, num_args=None):
    """Sum of N arrays, left to right."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


def _scalar_like(x, s):
    """``s`` as a 0-d tensor of the dtype jnp's weak scalar gives."""
    return torch.as_tensor(s, device=x.device).to(torch.result_type(x, s))


_SCALAR = {
    '_plus_scalar': lambda x, s: x + s,
    '_minus_scalar': lambda x, s: x - s,
    '_rminus_scalar': lambda x, s: s - x,
    '_mul_scalar': lambda x, s: x * s,
    '_div_scalar': lambda x, s: torch.true_divide(x, s),
    '_rdiv_scalar': lambda x, s: torch.true_divide(s, x),
    '_mod_scalar': lambda x, s: torch.remainder(x, s),
    '_rmod_scalar': lambda x, s: torch.remainder(_scalar_like(x, s), x),
    '_power_scalar': lambda x, s: torch.pow(x, s),
    '_rpower_scalar': lambda x, s: torch.pow(s, x),
    '_hypot_scalar': lambda x, s: torch.hypot(x, torch.full_like(x, s)),
    '_maximum_scalar': lambda x, s: torch.maximum(x, _scalar_like(x, s)),
    '_minimum_scalar': lambda x, s: torch.minimum(x, _scalar_like(x, s)),
    '_equal_scalar': lambda x, s: (x == s).to(x.dtype),
    '_not_equal_scalar': lambda x, s: (x != s).to(x.dtype),
    '_greater_scalar': lambda x, s: (x > s).to(x.dtype),
    '_greater_equal_scalar': lambda x, s: (x >= s).to(x.dtype),
    '_lesser_scalar': lambda x, s: (x < s).to(x.dtype),
    '_lesser_equal_scalar': lambda x, s: (x <= s).to(x.dtype),
    '_logical_and_scalar': lambda x, s: ((x != 0) & (s != 0)).to(x.dtype),
    '_logical_or_scalar': lambda x, s: ((x != 0) | (s != 0)).to(x.dtype),
    '_logical_xor_scalar': lambda x, s: ((x != 0) ^ (s != 0)).to(x.dtype),
    '_scatter_plus_scalar': lambda x, s: x + s,
    '_scatter_minus_scalar': lambda x, s: x - s,
}

for _name, _fn in _SCALAR.items():
    def _mks(fn):
        def _op(data, *, scalar=1.0):
            return fn(data, scalar)
        return _op
    register(_name)(_mks(_fn))

alias('_plus_scalar', '_PlusScalar')
alias('_minus_scalar', '_MinusScalar')
alias('_mul_scalar', '_MulScalar')
alias('_div_scalar', '_DivScalar')


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _norm_axis(axis):
    if axis is None or axis == () or axis == []:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(data, ax):
    """A tuple of dims for torch (every dim for None)."""
    if ax is None:
        return tuple(range(data.dim()))
    return (ax,) if isinstance(ax, int) else ax


def _prod(data, dim, keepdim):
    out = data
    for d in sorted((a % data.dim() for a in dim), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _nanprod(data, dim, keepdim):
    return _prod(torch.where(torch.isnan(data), torch.ones_like(data),
                             data), dim, keepdim)


_REDUCERS = {
    'sum': lambda d, dim, k: torch.sum(d, dim=dim, keepdim=k),
    'mean': lambda d, dim, k: torch.mean(_floatify(d), dim=dim, keepdim=k),
    'prod': _prod,
    'nansum': lambda d, dim, k: torch.nansum(d, dim=dim, keepdim=k),
    'nanprod': _nanprod,
    'max': lambda d, dim, k: torch.amax(d, dim=dim, keepdim=k),
    'min': lambda d, dim, k: torch.amin(d, dim=dim, keepdim=k),
    '_square_sum': lambda d, dim, k: torch.sum(torch.square(d), dim=dim,
                                               keepdim=k),
}


def _reduce(fn):
    def _op(data, *, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis)
        if exclude and ax is not None:
            if isinstance(ax, int):
                ax = (ax,)
            ax = tuple(i for i in range(data.dim()) if i not in
                       tuple(a % data.dim() for a in ax))
        if data.dim() == 0:
            return fn(data.reshape(1), (0,), False).reshape(())
        return fn(data, _dims(data, ax), bool(keepdims))
    return _op


for _name, _fn in _REDUCERS.items():
    register(_name, aliases=('square_sum',) if _name == '_square_sum'
             else ())(_reduce(_fn))

alias('sum', 'sum_axis')
alias('max', 'max_axis')
alias('min', 'min_axis')


@register('norm')
def norm(data, *, ord=2, axis=None, keepdims=False, out_dtype=None):
    dim = _dims(data, _norm_axis(axis))
    if ord == 1:
        out = torch.sum(torch.abs(data), dim=dim, keepdim=bool(keepdims))
    else:
        out = torch.sqrt(torch.sum(torch.square(data), dim=dim,
                                   keepdim=bool(keepdims)))
    if out_dtype is not None:
        out = out.to(torch_dtype(out_dtype))
    return out


def _arg(fn):
    def _op(data, *, axis=None, keepdims=False):
        if axis is None:
            return fn(data.reshape(-1)).to(torch.float32)
        return fn(data, dim=int(axis), keepdim=bool(keepdims)).to(
            torch.float32)
    return _op


register('argmax')(_arg(torch.argmax))
register('argmin')(_arg(torch.argmin))


@register('argmax_channel')
def argmax_channel(data):
    return torch.argmax(data, dim=-1).to(torch.float32)


# ---------------------------------------------------------------------------
# broadcast shape manipulation
# ---------------------------------------------------------------------------

@register('broadcast_to')
def broadcast_to(data, *, shape=None):
    shape = tuple(int(s) if int(s) != 0 else data.shape[i]
                  for i, s in enumerate(shape))
    return torch.broadcast_to(data, shape)


@register('broadcast_axis', aliases=('broadcast_axes',))
def broadcast_axis(data, *, axis=None, size=None):
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    sizes = size if isinstance(size, (list, tuple)) else (size,)
    shape = list(data.shape)
    for a, s in zip(axes, sizes):
        shape[int(a)] = int(s)
    return torch.broadcast_to(data, tuple(shape))


@register('broadcast_like', num_inputs=2)
def broadcast_like(lhs, rhs, *, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return torch.broadcast_to(lhs, rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[int(la)] = rhs.shape[int(ra)]
    return torch.broadcast_to(lhs, tuple(shape))


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _t(x):
    return x.permute(*reversed(range(x.dim())))


@register('dot', num_inputs=2)
def dot(lhs, rhs, *, transpose_a=False, transpose_b=False,
        forward_stype=None):
    """MXNet's dot: the last axis of lhs against the first of rhs (after
    the optional transposes)."""
    a = _t(lhs) if transpose_a else lhs
    b = _t(rhs) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register('batch_dot', num_inputs=2)
def batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False,
              forward_stype=None):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register('khatri_rao', num_inputs=-1, key_var_num_args='num_args')
def khatri_rao(args, *, num_args=None):
    out = args[0]
    for m in args[1:]:
        n = out.shape[0] * m.shape[0]
        out = (out[:, None, :] * m[None, :, :]).reshape(n, -1)
    return out
