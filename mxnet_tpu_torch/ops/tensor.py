"""Shape, slicing, indexing, init and ordering ops, the counterpart of
``mxnet_tpu/ops/tensor.py``.

The bodies are the JAX bodies in torch: ``Reshape`` keeps MXNet's special
codes (0 keep, -1 infer, -2 copy the rest, -3 merge two, -4 split one),
``take`` clips or wraps its indices, the ordering ops sort ascending and
flip for ``is_ascend=False``. The init ops (``_zeros``, ``_arange``, ...)
take ``ctx``: a context or device, None for the current context.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from ..context import resolve_device
from .registry import register


# ---------------------------------------------------------------------------
# reshape / transpose family
# ---------------------------------------------------------------------------

def infer_reshape(src_shape, target):
    """MXNet's extended reshape codes 0, -1, -2, -3, -4."""
    src = list(src_shape)
    out = []
    i = 0
    t = list(target)
    j = 0
    while j < len(t):
        d = int(t[j])
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            d1, d2 = int(t[j + 1]), int(t[j + 2])
            cur = src[i]
            i += 1
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            j += 2
        else:
            out.append(d)
            i += 1
        j += 1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in src_shape:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register('Reshape', aliases=('reshape',))
def reshape(data, *, shape=None, reverse=False, target_shape=None,
            keep_highest=False):
    if target_shape is not None and shape is None:
        shape = target_shape
    if reverse:
        newshape = infer_reshape(tuple(data.shape)[::-1],
                                 list(shape)[::-1])[::-1]
    else:
        newshape = infer_reshape(tuple(data.shape), shape)
    return torch.reshape(data, newshape)


@register('Flatten', aliases=('flatten',))
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@register('transpose')
def transpose(data, *, axes=None):
    if axes is None or len(axes) == 0:
        return data.permute(*reversed(range(data.dim())))
    return data.permute(*(int(a) for a in axes))


@register('SwapAxis', aliases=('swapaxes',))
def swapaxes(data, *, dim1=0, dim2=0):
    return torch.swapaxes(data, int(dim1), int(dim2))


@register('expand_dims')
def expand_dims(data, *, axis=0):
    return torch.unsqueeze(data, int(axis))


@register('squeeze')
def squeeze(data, *, axis=None):
    if axis is None:
        return torch.squeeze(data)
    ax = tuple(axis) if isinstance(axis, (tuple, list)) else (int(axis),)
    return torch.squeeze(data, dim=ax)


@register('reshape_like', num_inputs=2)
def reshape_like(lhs, rhs, *, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    if lhs_begin is None:
        return torch.reshape(lhs, rhs.shape)
    lb = int(lhs_begin or 0)
    le = int(lhs_end) if lhs_end is not None else lhs.dim()
    rb = int(rhs_begin or 0)
    re_ = int(rhs_end) if rhs_end is not None else rhs.dim()
    new = tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_]) \
        + tuple(lhs.shape[le:])
    return torch.reshape(lhs, new)


@register('depth_to_space')
def depth_to_space(data, *, block_size=1):
    n, c, h, w = data.shape
    b = int(block_size)
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register('space_to_depth')
def space_to_depth(data, *, block_size=1):
    n, c, h, w = data.shape
    b = int(block_size)
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# ---------------------------------------------------------------------------
# slicing / concat / stack / split
# ---------------------------------------------------------------------------

def _norm_slice(shape, begin, end, step=None):
    idx = []
    for i in range(len(shape)):
        if i < len(begin):
            s = (step[i] if step is not None and i < len(step) and step[i]
                 else 1)
            idx.append(slice(begin[i], end[i], int(s)))
        else:
            idx.append(slice(None))
    return tuple(idx)


def _take_slices(data, idx):
    """``data[idx]`` for slices, negative steps included (torch's basic
    indexing has no negative step: those axes flip first)."""
    flips = []
    plain = []
    for ax, sl in enumerate(idx):
        if sl.step is not None and sl.step < 0:
            n = data.shape[ax]
            start, stop, step = sl.indices(n)
            # positions start, start+step, ... (> stop) of the original
            # are positions n-1-start, ... of the flipped axis
            flips.append(ax)
            plain.append(slice(n - 1 - start, n - 1 - stop, -step))
        else:
            plain.append(sl)
    if flips:
        data = torch.flip(data, dims=flips)
    return data[tuple(plain)]


@register('slice')
def slice_op(data, *, begin=None, end=None, step=None):
    return _take_slices(data, _norm_slice(data.shape, begin, end, step))


@register('slice_axis')
def slice_axis(data, *, axis=0, begin=0, end=None):
    axis = int(axis) % data.dim()
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register('slice_like', num_inputs=2)
def slice_like(lhs, rhs, *, axes=None):
    if axes is None or len(axes) == 0:
        axes = range(min(lhs.dim(), rhs.dim()))
    idx = [slice(None)] * lhs.dim()
    for a in axes:
        a = int(a) % lhs.dim()
        idx[a] = slice(0, rhs.shape[a])
    return lhs[tuple(idx)]


@register('_slice_assign', num_inputs=2, aliases=('_crop_assign',))
def _slice_assign(lhs, rhs, *, begin=None, end=None, step=None):
    out = lhs.clone()
    out[_norm_slice(lhs.shape, begin, end, step)] = rhs
    return out


@register('_slice_assign_scalar', aliases=('_crop_assign_scalar',))
def _slice_assign_scalar(data, *, scalar=0.0, begin=None, end=None,
                         step=None):
    out = data.clone()
    out[_norm_slice(data.shape, begin, end, step)] = scalar
    return out


@register('Concat', num_inputs=-1, key_var_num_args='num_args',
          aliases=('concat',))
def concat(args, *, num_args=None, dim=1):
    return torch.cat(list(args), dim=int(dim))


@register('_rnn_param_concat', num_inputs=-1, key_var_num_args='num_args')
def _rnn_param_concat(args, *, num_args=None, dim=0):
    return torch.cat([a.reshape(-1) for a in args], dim=0)


@register('stack', num_inputs=-1, key_var_num_args='num_args')
def stack(args, *, num_args=None, axis=0):
    return torch.stack(list(args), dim=int(axis))


def _split_even(data, n, axis):
    if data.shape[axis] % n:
        raise ValueError('array split does not result in an equal '
                         'division: %d into %d' % (data.shape[axis], n))
    return list(torch.split(data, data.shape[axis] // n, dim=axis))


@register('SliceChannel', num_outputs=-1, aliases=('split',))
def split(data, *, num_outputs=1, axis=1, squeeze_axis=False):
    parts = _split_even(data, int(num_outputs), int(axis))
    if squeeze_axis:
        parts = [torch.squeeze(p, dim=int(axis)) for p in parts]
    return tuple(parts)


@register('_split_v2', num_outputs=-1, aliases=('split_v2',))
def split_v2(data, *, indices_or_sections=1, axis=0, squeeze_axis=False,
             sections=0):
    ax = int(axis)
    if sections:
        parts = _split_even(data, int(sections), ax)
    elif isinstance(indices_or_sections, int):
        parts = _split_even(data, indices_or_sections, ax)
    else:
        parts = list(torch.tensor_split(
            data, [int(i) for i in indices_or_sections], dim=ax))
    if squeeze_axis:
        parts = [torch.squeeze(p, dim=ax) for p in parts]
    return tuple(parts)


@register('tile')
def tile(data, *, reps=None):
    return torch.tile(data, tuple(int(r) for r in reps))


@register('repeat')
def repeat(data, *, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), int(repeats))
    return torch.repeat_interleave(data, int(repeats), dim=int(axis))


@register('reverse', aliases=('flip',))
def reverse(data, *, axis=0):
    ax = axis if isinstance(axis, (list, tuple)) else (int(axis),)
    return torch.flip(data, dims=tuple(int(a) for a in ax))


@register('Pad', aliases=('pad',))
def pad(data, *, mode='constant', pad_width=None, constant_value=0.0):
    pairs = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
             for i in range(len(pad_width) // 2)]
    flat = []
    for lo, hi in reversed(pairs):          # F.pad: last axis first
        flat.extend([lo, hi])
    while flat and flat[-2:] == [0, 0]:     # the unpadded leading axes
        flat = flat[:-2]
    if mode == 'constant':
        return F.pad(data, flat, mode='constant', value=constant_value)
    tmode = {'edge': 'replicate', 'reflect': 'reflect'}[mode]
    return F.pad(data, flat, mode=tmode)


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

@register('take', num_inputs=2)
def take(a, indices, *, axis=0, mode='clip'):
    ax = int(axis) % a.dim()
    n = a.shape[ax]
    idx = indices.to(torch.int64)
    idx = torch.remainder(idx, n) if mode == 'wrap' \
        else torch.clamp(idx, 0, n - 1)
    out = torch.index_select(a, ax, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:ax]) + tuple(indices.shape)
                       + tuple(a.shape[ax + 1:]))


@register('batch_take', num_inputs=2)
def batch_take(a, indices):
    return torch.gather(a, 1, indices.to(torch.int64)[:, None])[:, 0]


@register('pick', num_inputs=2, aliases=('choose_element_0index',))
def pick(data, index, *, axis=-1, keepdims=False, mode='clip'):
    ax = int(axis) % data.dim()
    idx = index.to(torch.int64)
    idx = torch.remainder(idx, data.shape[ax]) if mode == 'wrap' \
        else torch.clamp(idx, 0, data.shape[ax] - 1)
    out = torch.gather(data, ax, torch.unsqueeze(idx, ax))
    return out if keepdims else torch.squeeze(out, dim=ax)


@register('one_hot')
def one_hot(indices, *, depth=None, on_value=1.0, off_value=0.0,
            dtype='float32'):
    ind = indices.to(torch.int64)
    depth = int(depth)
    valid = (ind >= 0) & (ind < depth)
    oh = F.one_hot(torch.where(valid, ind, torch.zeros_like(ind)), depth)
    oh = (oh * valid[..., None]).to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


def _nd_index(indices):
    ind = indices.to(torch.int64)
    return tuple(ind[i] for i in range(ind.shape[0]))


@register('gather_nd', num_inputs=2)
def gather_nd(data, indices):
    return data[_nd_index(indices)]


@register('scatter_nd', num_inputs=2)
def scatter_nd(data, indices, *, shape=None):
    out = torch.zeros(tuple(int(s) for s in shape), dtype=data.dtype,
                      device=data.device)
    return out.index_put(_nd_index(indices), data)


@register('_scatter_set_nd', num_inputs=3)
def _scatter_set_nd(lhs, indices, rhs, *, shape=None):
    return lhs.index_put(_nd_index(indices), rhs)


@register('where', num_inputs=3)
def where(condition, x, y):
    cond = condition if condition.dtype == torch.bool else condition != 0
    return torch.where(cond, x, y)


@register('boolean_mask', num_inputs=2, aliases=('_contrib_boolean_mask',))
def boolean_mask(data, index, *, axis=0):
    """Rows of ``data`` where ``index`` is non-zero (a data-dependent
    shape: the CUDA path syncs to read the count)."""
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, int(axis), keep)


@register('_ravel_multi_index', num_inputs=1, aliases=('ravel_multi_index',))
def ravel_multi_index(data, *, shape=None):
    idx = data.to(torch.int32)
    out = torch.zeros(idx.shape[1:], dtype=torch.int32, device=data.device)
    for i, d in enumerate(int(s) for s in shape):
        out = out * d + idx[i]
    return out.to(torch.float32)


@register('_unravel_index', num_inputs=1, aliases=('unravel_index',))
def unravel_index(data, *, shape=None):
    rem = data.to(torch.int32)
    outs = []
    for d in tuple(int(s) for s in shape)[::-1]:
        outs.append(torch.remainder(rem, d))
        rem = torch.div(rem, d, rounding_mode='floor')
    return torch.stack(outs[::-1], dim=0).to(torch.float32)


# ---------------------------------------------------------------------------
# init ops
# ---------------------------------------------------------------------------

@register('_zeros', num_inputs=0)
def _zeros(*, shape=None, ctx=None, dtype='float32'):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                       device=resolve_device(ctx))


@register('_zeros_without_dtype', num_inputs=0)
def _zeros_without_dtype(*, shape=None, ctx=None, dtype=None):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype or 'float32'),
                       device=resolve_device(ctx))


@register('_ones', num_inputs=0)
def _ones(*, shape=None, ctx=None, dtype='float32'):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype),
                      device=resolve_device(ctx))


@register('_full', num_inputs=0)
def _full(*, shape=None, value=0.0, ctx=None, dtype='float32'):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                      device=resolve_device(ctx))


@register('_eye', num_inputs=0)
def _eye(*, N=0, M=0, k=0, ctx=None, dtype='float32'):
    n, m, k = int(N), int(M) or int(N), int(k)
    rows = torch.arange(n, device=resolve_device(ctx))[:, None]
    cols = torch.arange(m, device=resolve_device(ctx))[None, :]
    return (cols - rows == k).to(torch_dtype(dtype))


def arange_values(start, stop, step, repeat, dtype, device):
    """``jnp.arange`` then ``jnp.repeat``: the values start + i * step,
    in float64 rounded once to ``dtype``."""
    if stop is None:
        start, stop = 0.0, start
    n = max(0, -(-(float(stop) - float(start)) // float(step)))
    out = (float(start) + torch.arange(int(n), dtype=torch.float64,
                                       device=device) * float(step))
    out = out.to(torch_dtype(dtype))
    if int(repeat) > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register('_arange', num_inputs=0)
def _arange(*, start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            ctx=None, dtype='float32'):
    return arange_values(start, stop, step, repeat, dtype, resolve_device(ctx))


@register('_linspace', num_inputs=0)
def _linspace(*, start=0.0, stop=None, num=50, endpoint=True, ctx=None,
              dtype='float32'):
    num = int(num)
    if endpoint:
        return torch.linspace(start, stop, num, dtype=torch_dtype(dtype),
                              device=resolve_device(ctx))
    step = (stop - start) / num
    return (start + torch.arange(num, dtype=torch.float64,
                                 device=resolve_device(ctx)) * step).to(
        torch_dtype(dtype))


@register('_identity_with_attr_like_rhs', num_inputs=2)
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------

@register('sort')
def sort(data, *, axis=-1, is_ascend=True):
    if axis is None:
        data, axis = data.reshape(-1), -1
    out = torch.sort(data, dim=int(axis), stable=True).values
    return out if is_ascend else torch.flip(out, dims=(int(axis),))


@register('argsort')
def argsort(data, *, axis=-1, is_ascend=True, dtype='float32'):
    if axis is None:
        data, axis = data.reshape(-1), -1
    out = torch.argsort(data, dim=int(axis), stable=True)
    if not is_ascend:
        out = torch.flip(out, dims=(int(axis),))
    return out.to(torch_dtype(dtype))


@register('topk', num_outputs=-1)
def topk(data, *, axis=-1, k=1, ret_typ='indices', is_ascend=False,
         dtype='float32'):
    """Top-k along ``axis``: the largest k (the smallest for
    ``is_ascend``), largest first, ties to the lower index."""
    ax = int(axis) % data.dim() if axis is not None else data.dim() - 1
    x = torch.movedim(data, ax, -1)
    key = -x if is_ascend else x
    order = torch.argsort(key, dim=-1, descending=True, stable=True)
    idx = order[..., :int(k)]
    vals = torch.gather(x, -1, idx)
    vals = torch.movedim(vals, -1, ax)
    idx_m = torch.movedim(idx, -1, ax)
    if ret_typ == 'value':
        return vals
    if ret_typ == 'both':
        return vals, idx_m.to(torch_dtype(dtype))
    if ret_typ == 'mask':
        mask = torch.zeros_like(x).scatter(-1, idx, 1)
        return torch.movedim(mask, -1, ax)
    return idx_m.to(torch_dtype(dtype))


@register('diag')
def diag(data, *, k=0, axis1=0, axis2=1):
    if data.dim() == 1:
        return torch.diag(data, int(k))
    return torch.diagonal(data, offset=int(k), dim1=int(axis1),
                          dim2=int(axis2))


@register('_histogram', num_inputs=1, aliases=('histogram',), num_outputs=2)
def histogram(data, *, bin_cnt=10, range=None):
    """``jnp.histogram``: ``bin_cnt`` equal bins over ``range`` (the data's
    span without one), the last edge inclusive; int32 counts."""
    x = data.reshape(-1)
    if range is not None:
        lo, hi = float(range[0]), float(range[1])
    else:
        lo, hi = float(x.min()), float(x.max())
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
    n = int(bin_cnt)
    edges = torch.linspace(lo, hi, n + 1, dtype=x.dtype, device=x.device)
    pos = torch.searchsorted(edges, x.contiguous(), right=True) - 1
    pos = torch.where(x == edges[-1], torch.full_like(pos, n - 1), pos)
    keep = (pos >= 0) & (pos < n)
    cnt = torch.zeros(n, dtype=torch.int64, device=x.device).index_add_(
        0, pos[keep], torch.ones_like(pos[keep]))
    return cnt.to(torch.int32), edges


@register('_shuffle', needs_rng=True, aliases=('shuffle',))
def shuffle(gen, data):
    perm = torch.randperm(data.shape[0], generator=gen, device=gen.device)
    return data[perm.to(data.device)]


@register('_sparse_retain', num_inputs=2, aliases=('sparse_retain',))
def sparse_retain(data, indices):
    """Keep only the rows listed in ``indices``; the others become 0."""
    idx = indices.to(torch.int64).reshape(-1)
    out = torch.zeros_like(data)
    out[idx] = data[idx]
    return out


@register('_scatter_elemwise_div', num_inputs=2)
def scatter_elemwise_div(lhs, rhs):
    """lhs / rhs where lhs is non-zero, 0 elsewhere."""
    return torch.where(lhs != 0, lhs / rhs, torch.zeros_like(lhs))


@register('cast_storage')
def cast_storage(data, *, stype='default'):
    """Dense storage backs every storage type: the values pass
    through."""
    return data


@register('_getitem')
def getitem(data, *, _key=None):
    return data[_key]
