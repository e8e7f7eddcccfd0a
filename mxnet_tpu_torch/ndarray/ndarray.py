"""NDArray: the imperative array, the counterpart of
``mxnet_tpu/ndarray/ndarray.py``.

An :class:`NDArray` is a thin holder of one ``torch.Tensor`` (``_data``),
as the JAX package's holds one ``jax.Array``. Its ops go through the op
registry (:func:`invoke`): inside ``autograd.record()`` with torch's grad
mode on, outside it under ``torch.no_grad()``. A kernel op on a CUDA
tensor launches its kernel (the op's function routes through
``ops/kernels``); there is no other path.

In-place forms (``x[:] = v``, ``x += y`` outside ``record()``) write into
the tensor's storage, so an array that views a gluon parameter keeps
viewing it; inside ``record()`` ``x += y`` rebinds ``x`` to the recorded
result, as the JAX package's functional update does.

``save`` / ``load`` write and read the reference's ``.params`` container
(``kMXAPINDArrayListMagic`` 0x112, one ``NDARRAY_V2_MAGIC`` record an
array, then the names), byte for byte the JAX package's; bfloat16 is
stored as float32, as there.
"""
from __future__ import annotations

import struct

import numpy as onp
import torch

from .. import autograd
from .. import random as _random
from ..base import dtype_name, numeric_types, torch_dtype
from ..context import Context, resolve_device
from ..ops import registry as _registry

__all__ = ['NDArray', 'array', 'zeros', 'ones', 'full', 'empty', 'arange',
           'invoke', 'concatenate', 'moveaxis', 'maximum', 'minimum',
           'save', 'load', 'load_fobj', 'waitall']


def _place(t, ctx):
    return t if ctx is None else t.to(resolve_device(ctx))


class NDArray:
    """Multi-dimensional array over one ``torch.Tensor``."""

    __slots__ = ('_data', '_grad', '_grad_req', '_grad_fresh',
                 '__weakref__')

    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(onp.asarray(data),
                                   device=resolve_device(ctx))
        else:
            data = _place(data, ctx)
        self._data = data
        self._grad = None
        self._grad_req = 'null'
        self._grad_fresh = False

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy's dtype of the array (``torch.bfloat16`` for bfloat16,
        which numpy lacks)."""
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return onp.dtype(dtype_name(self._data.dtype))

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return Context.of(self._data.device)

    ctx = context

    @property
    def stype(self):
        return 'default'

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return self.transpose()

    # -- engine semantics --------------------------------------------------
    def wait_to_read(self):
        """Block until the value is computed: a sync of the current
        stream of the array's card (nothing on the CPU)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def wait_to_write(self):
        self.wait_to_read()

    # -- conversion --------------------------------------------------------
    def asnumpy(self):
        """A host numpy copy (bfloat16 widens to float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a if dtype is None else a.astype(dtype)

    def asscalar(self):
        if self.size != 1:
            raise ValueError('The current array is not a scalar')
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError('The truth value of an NDArray with multiple '
                         'elements is ambiguous.')

    def __len__(self):
        if self.ndim == 0:
            raise TypeError('len() of unsized object')
        return self.shape[0]

    def __repr__(self):
        return '%s\n<NDArray %s @%s>' % (
            str(self.asnumpy()), 'x'.join(str(s) for s in self.shape),
            self.context)

    def astype(self, dtype, copy=True):
        if not copy and self._data.dtype == torch_dtype(dtype):
            return self
        return invoke('Cast', [self], {'dtype': dtype_name(dtype)})

    def copy(self):
        return invoke('_copy', [self], {})

    def copyto(self, other):
        """Copy into ``other`` (an NDArray: in place, in its dtype) or to a
        context (a new array)."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return self.as_in_context(other)
        raise TypeError('copyto target must be NDArray or Context')

    def as_in_context(self, context):
        if context == self.context:
            return self
        with autograd.grad_enabled():
            return NDArray(self._data.to(context.torch_device()))

    as_in_ctx = as_in_context

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req='write', stype=None):
        """Attach a zero gradient buffer and mark the array a recorded
        leaf."""
        autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._data))], grad_req)

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- indexing ----------------------------------------------------------
    @staticmethod
    def _index(key):
        def one(k):
            if isinstance(k, NDArray):
                k = k._data
                return k if not k.is_floating_point() else k.to(torch.int64)
            return k
        if isinstance(key, tuple):
            return tuple(one(k) for k in key)
        return one(key)

    def __getitem__(self, key):
        with autograd.grad_enabled():
            return NDArray(self._data[self._index(key)])

    def __setitem__(self, key, value):
        idx = self._index(key)
        if isinstance(value, NDArray):
            value = value._data
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                self._data[idx] = value.to(self._data.dtype)
            elif isinstance(value, numeric_types) and not isinstance(
                    value, onp.ndarray):
                self._data[idx] = value
            else:
                self._data[idx] = torch.as_tensor(
                    onp.asarray(value), dtype=self._data.dtype,
                    device=self._data.device)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    # -- arithmetic (through the op registry) -------------------------------
    _SCALAR_OPS = {
        'broadcast_add': ('_plus_scalar', '_plus_scalar'),
        'broadcast_sub': ('_minus_scalar', '_rminus_scalar'),
        'broadcast_mul': ('_mul_scalar', '_mul_scalar'),
        'broadcast_div': ('_div_scalar', '_rdiv_scalar'),
        'broadcast_mod': ('_mod_scalar', '_rmod_scalar'),
        'broadcast_power': ('_power_scalar', '_rpower_scalar'),
        'broadcast_equal': ('_equal_scalar', '_equal_scalar'),
        'broadcast_not_equal': ('_not_equal_scalar', '_not_equal_scalar'),
        'broadcast_greater': ('_greater_scalar', '_lesser_scalar'),
        'broadcast_greater_equal': ('_greater_equal_scalar',
                                    '_lesser_equal_scalar'),
        'broadcast_lesser': ('_lesser_scalar', '_greater_scalar'),
        'broadcast_lesser_equal': ('_lesser_equal_scalar',
                                   '_greater_equal_scalar'),
        'broadcast_maximum': ('_maximum_scalar', '_maximum_scalar'),
        'broadcast_minimum': ('_minimum_scalar', '_minimum_scalar'),
    }

    def _binary(self, opname, other, reflect=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reflect else (self, other)
            return invoke(opname, [a, b], {})
        if isinstance(other, numeric_types) and not isinstance(
                other, onp.ndarray):
            sname = self._SCALAR_OPS[opname][1 if reflect else 0]
            return invoke(sname, [self], {'scalar': float(other)})
        if isinstance(other, (onp.ndarray, list, tuple, torch.Tensor)):
            return self._binary(opname, NDArray(
                torch.as_tensor(onp.asarray(other) if not isinstance(
                    other, torch.Tensor) else other,
                    device=self._data.device)), reflect)
        return NotImplemented

    def __add__(self, o): return self._binary('broadcast_add', o)
    def __radd__(self, o): return self._binary('broadcast_add', o)
    def __sub__(self, o): return self._binary('broadcast_sub', o)
    def __rsub__(self, o): return self._binary('broadcast_sub', o, True)
    def __mul__(self, o): return self._binary('broadcast_mul', o)
    def __rmul__(self, o): return self._binary('broadcast_mul', o)
    def __truediv__(self, o): return self._binary('broadcast_div', o)
    def __rtruediv__(self, o): return self._binary('broadcast_div', o, True)
    def __mod__(self, o): return self._binary('broadcast_mod', o)
    def __rmod__(self, o): return self._binary('broadcast_mod', o, True)
    def __pow__(self, o): return self._binary('broadcast_power', o)
    def __rpow__(self, o): return self._binary('broadcast_power', o, True)
    def __eq__(self, o): return self._binary('broadcast_equal', o)
    def __ne__(self, o): return self._binary('broadcast_not_equal', o)
    def __gt__(self, o): return self._binary('broadcast_greater', o)
    def __ge__(self, o): return self._binary('broadcast_greater_equal', o)
    def __lt__(self, o): return self._binary('broadcast_lesser', o)
    def __le__(self, o): return self._binary('broadcast_lesser_equal', o)
    def __neg__(self): return invoke('negative', [self], {})
    def __abs__(self): return invoke('abs', [self], {})
    def __hash__(self): return id(self)

    def _inplace(self, opname, o):
        out = self._binary(opname, o)
        if out is NotImplemented:
            return out
        t = out._data
        if autograd.is_recording() or t.shape != self._data.shape \
                or t.dtype != self._data.dtype:
            self._data = t            # the recorded result
        else:
            with torch.no_grad():
                self._data.copy_(t)   # the same storage, leaf kept
        return self

    def __iadd__(self, o): return self._inplace('broadcast_add', o)
    def __isub__(self, o): return self._inplace('broadcast_sub', o)
    def __imul__(self, o): return self._inplace('broadcast_mul', o)
    def __itruediv__(self, o): return self._inplace('broadcast_div', o)

    # -- method sugar delegating to ops ------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return invoke('Reshape', [self], {'shape': shape, **kwargs})

    def reshape_like(self, other):
        return invoke('reshape_like', [self, other], {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return invoke('transpose', [self], {'axes': axes if axes else None})

    def flatten(self):
        return invoke('Flatten', [self], {})

    def expand_dims(self, axis):
        return invoke('expand_dims', [self], {'axis': axis})

    def squeeze(self, axis=None):
        return invoke('squeeze', [self], {'axis': axis})

    def swapaxes(self, dim1, dim2):
        return invoke('SwapAxis', [self], {'dim1': dim1, 'dim2': dim2})

    def flip(self, axis):
        return invoke('reverse', [self], {'axis': axis})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke('SliceChannel', [self],
                      {'num_outputs': num_outputs, 'axis': axis,
                       'squeeze_axis': squeeze_axis})

    def slice(self, begin, end, step=None):
        return invoke('slice', [self], {'begin': begin, 'end': end,
                                        'step': step})

    def slice_axis(self, axis, begin, end):
        return invoke('slice_axis', [self],
                      {'axis': axis, 'begin': begin, 'end': end})

    def take(self, indices, axis=0, mode='clip'):
        return invoke('take', [self, indices], {'axis': axis, 'mode': mode})

    def one_hot(self, depth, **kw):
        return invoke('one_hot', [self], {'depth': depth, **kw})

    def clip(self, a_min, a_max):
        return invoke('clip', [self], {'a_min': a_min, 'a_max': a_max})

    def tile(self, reps):
        return invoke('tile', [self], {'reps': reps})

    def broadcast_to(self, shape):
        return invoke('broadcast_to', [self], {'shape': shape})

    def broadcast_like(self, other):
        return invoke('broadcast_like', [self, other], {})

    def pad(self, mode='constant', pad_width=None, constant_value=0.0):
        return invoke('Pad', [self], {'mode': mode, 'pad_width': pad_width,
                                      'constant_value': constant_value})

    def topk(self, **kw):
        return invoke('topk', [self], kw)

    def argsort(self, **kw):
        return invoke('argsort', [self], kw)

    def sort(self, **kw):
        return invoke('sort', [self], kw)


def _unary_method(name, opname=None):
    opname = opname or name

    def _m(self, *, axis=None, keepdims=False, **kw):
        attrs = dict(kw)
        op = _registry.get(opname)
        if 'axis' in op.attr_names:
            attrs['axis'] = axis
        if 'keepdims' in op.attr_names:
            attrs['keepdims'] = keepdims
        return invoke(opname, [self], attrs)
    _m.__name__ = name
    return _m


for _n in ['abs', 'sqrt', 'square', 'exp', 'log', 'sigmoid', 'relu', 'tanh',
           'sin', 'cos', 'sign', 'round', 'rint', 'floor', 'ceil',
           'sum', 'mean', 'prod', 'max', 'min', 'argmax', 'argmin', 'norm',
           'softmax', 'log_softmax']:
    setattr(NDArray, _n, _unary_method(_n))


# ---------------------------------------------------------------------------
# op invocation
# ---------------------------------------------------------------------------

def _tensor_of(x, device):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(onp.asarray(x, dtype=onp.float32)
                           if isinstance(x, (int, float)) else
                           onp.asarray(x), device=device)


def _write_back(tgt, t):
    """``tgt`` takes the value ``t``: into its storage where it can (it
    stays the same leaf), else rebound."""
    if tgt._data is t:
        return
    if not autograd.is_recording() and t.shape == tgt._data.shape \
            and t.dtype == tgt._data.dtype:
        with torch.no_grad():
            tgt._data.copy_(t)
    else:
        tgt._data = t


def invoke(opname, nd_inputs, attrs, out=None):
    """Run a registered op on NDArrays: the tensors in, torch's grad mode
    on inside ``autograd.record()`` and off outside it, the outputs
    wrapped. ``out`` (an NDArray or a list) receives the outputs; an op
    with ``mutate_idx`` writes its outputs back into those inputs."""
    op = _registry.get(opname) if isinstance(opname, str) else opname
    flat = list(nd_inputs)
    device = next((x._data.device for x in flat if isinstance(x, NDArray)),
                  None)
    tensors = [_tensor_of(x, device if device is not None
                          else resolve_device(None)) for x in flat]
    attrs = {k: v for k, v in attrs.items() if v is not None or k == 'axis'}
    if 'training' in op.attr_names and 'training' not in attrs:
        attrs['training'] = autograd.is_training()
    fn = op.bind_attrs(**attrs)
    args = [tensors] if op.num_inputs == -1 else tensors
    if op.needs_rng:
        dev = tensors[0].device if tensors \
            else resolve_device(attrs.get('ctx'))
        args = [_random.generator(dev)] + args
    with autograd.grad_enabled():
        res = fn(*args)
    single = not isinstance(res, (tuple, list))
    outs = [res] if single else list(res)
    outputs = [NDArray(t) for t in outs]
    if out is not None:
        out_list = out if isinstance(out, (list, tuple)) else [out]
        for tgt, src in zip(out_list, outputs):
            if tgt is not None:
                _write_back(tgt, src._data)
        return out
    if op.mutate_idx and not autograd.is_recording():
        for out_i, in_i in enumerate(op.mutate_idx):
            if in_i < len(flat) and isinstance(flat[in_i], NDArray) \
                    and out_i < len(outputs):
                _write_back(flat[in_i], outputs[out_i]._data)
        return outputs[0] if single or len(outputs) == 1 else tuple(outputs)
    return outputs[0] if single else tuple(outputs)


# ---------------------------------------------------------------------------
# creation / io
# ---------------------------------------------------------------------------

def _device(ctx):
    return resolve_device(ctx)


def array(source_array, ctx=None, dtype=None):
    """An array of ``source_array`` on ``ctx`` (the current context for
    None): numpy sources keep their dtype (float64 becomes float32),
    Python lists are float32."""
    if isinstance(source_array, NDArray):
        t = source_array._data.detach()
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return NDArray(t.to(_device(ctx)).clone())
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach()
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return NDArray(t.to(_device(ctx)).clone())
    if dtype is None:
        if isinstance(source_array, onp.ndarray):
            arr = source_array
            if arr.dtype == onp.float64:
                arr = arr.astype(onp.float32)
        else:
            arr = onp.asarray(source_array, dtype=onp.float32)
        return NDArray(torch.as_tensor(onp.ascontiguousarray(arr),
                                       device=_device(ctx)))
    dt = torch_dtype(dtype)
    if dt == torch.bfloat16:
        arr = onp.asarray(source_array, dtype=onp.float32)
        return NDArray(torch.as_tensor(arr, device=_device(ctx)).to(dt))
    arr = onp.asarray(source_array, dtype=dtype_name(dtype))
    return NDArray(torch.as_tensor(onp.ascontiguousarray(arr),
                                   device=_device(ctx)))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype='float32', **kwargs):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype='float32', **kwargs):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype='float32', **kwargs):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx=None, dtype='float32'):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype='float32'):
    from ..ops.tensor import arange_values
    return NDArray(arange_values(start, stop, step, repeat, dtype,
                                 _device(ctx)))


def concatenate(arrays, axis=0, always_copy=True):
    return invoke('Concat', list(arrays), {'dim': axis,
                                           'num_args': len(arrays)})


def moveaxis(tensor, source, destination):
    with autograd.grad_enabled():
        return NDArray(torch.movedim(tensor._data, source, destination))


def maximum(lhs, rhs):
    """Elementwise max with scalar / broadcast handling."""
    if isinstance(lhs, NDArray):
        return lhs._binary('broadcast_maximum', rhs)
    if isinstance(rhs, NDArray):
        return rhs._binary('broadcast_maximum', lhs)
    return max(lhs, rhs)


def minimum(lhs, rhs):
    """Elementwise min (the twin of :func:`maximum`)."""
    if isinstance(lhs, NDArray):
        return lhs._binary('broadcast_minimum', rhs)
    if isinstance(rhs, NDArray):
        return rhs._binary('broadcast_minimum', lhs)
    return min(lhs, rhs)


def waitall():
    """Block until every card has finished its queued work."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# save / load: the reference's .params container. Little-endian:
#   uint64 0x112 magic, uint64 reserved, uint64 count,
#   count x [uint32 0xF993FAC9, int32 stype (0 dense), int32 ndim,
#            ndim x int64 shape, int32 dev_type, int32 dev_id,
#            int32 type_flag, raw bytes],
#   uint64 name count, names as (uint64 len + bytes).
# ---------------------------------------------------------------------------

_MX_LIST_MAGIC = 0x112
_MX_V2_MAGIC = 0xF993FAC9
_MX_TYPE_FLAGS = {0: 'float32', 1: 'float64', 2: 'float16', 3: 'uint8',
                  4: 'int32', 5: 'int8', 6: 'int64'}
_MX_FLAG_OF = {v: k for k, v in _MX_TYPE_FLAGS.items()}


def _host(arr):
    if isinstance(arr, NDArray):
        return arr.asnumpy()
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return onp.asarray(arr)


def _mx_save_one(f, arr):
    a = onp.ascontiguousarray(_host(arr))
    if a.dtype.name not in _MX_FLAG_OF:
        a = a.astype(onp.float32)
    f.write(struct.pack('<Ii', _MX_V2_MAGIC, 0))
    f.write(struct.pack('<i', a.ndim))
    f.write(struct.pack('<%dq' % a.ndim, *a.shape))
    f.write(struct.pack('<ii', 1, 0))
    f.write(struct.pack('<i', _MX_FLAG_OF[a.dtype.name]))
    f.write(a.tobytes())


def _mx_load_one(f):
    magic, = struct.unpack('<I', f.read(4))
    if magic != _MX_V2_MAGIC:
        if magic == 0xF993FAC8:
            ndim, = struct.unpack('<i', f.read(4))
            shape = struct.unpack('<%dq' % ndim, f.read(8 * ndim))
        else:
            ndim = magic
            shape = struct.unpack('<%dI' % ndim, f.read(4 * ndim))
    else:
        stype, = struct.unpack('<i', f.read(4))
        if stype not in (-1, 0):
            raise ValueError('sparse .params entries are not supported '
                             '(storage type %d)' % stype)
        ndim, = struct.unpack('<i', f.read(4))
        shape = struct.unpack('<%dq' % ndim, f.read(8 * ndim))
    f.read(8)
    type_flag, = struct.unpack('<i', f.read(4))
    dtype = onp.dtype(_MX_TYPE_FLAGS[type_flag])
    n = int(onp.prod(shape)) if shape else 1
    data = onp.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)
    return data.reshape(shape).copy()


def save(fname, data):
    """Save NDArrays (a list, or a dict by name) in the reference .params
    container."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    with open(fname, 'wb') as f:
        f.write(struct.pack('<QQ', _MX_LIST_MAGIC, 0))
        f.write(struct.pack('<Q', len(arrays)))
        for a in arrays:
            _mx_save_one(f, a)
        f.write(struct.pack('<Q', len(names)))
        for n in names:
            nb = n.encode('utf-8')
            f.write(struct.pack('<Q', len(nb)))
            f.write(nb)


def load_numpy(fname):
    """A .params file as host numpy arrays: a dict by name, or a list."""
    with open(fname, 'rb') as f:
        return load_fobj(f, what=fname, wrap=False)


def load(fname, ctx=None):
    """Load a .params file onto ``ctx`` (the current context for None)."""
    with open(fname, 'rb') as f:
        return load_fobj(f, what=fname, ctx=ctx)


def load_fobj(f, what='<buffer>', ctx=None, wrap=True):
    """Parse the .params container from a binary file object."""
    magic, _ = struct.unpack('<QQ', f.read(16))
    if magic != _MX_LIST_MAGIC:
        raise ValueError('invalid NDArray file %s' % what)
    count, = struct.unpack('<Q', f.read(8))
    arrays = [_mx_load_one(f) for _ in range(count)]
    nname, = struct.unpack('<Q', f.read(8))
    names = []
    for _ in range(nname):
        ln, = struct.unpack('<Q', f.read(8))
        names.append(f.read(ln).decode('utf-8'))
    if wrap:
        dev = _device(ctx)
        arrays = [NDArray(torch.as_tensor(a, device=dev)) for a in arrays]
    if names:
        return dict(zip(names, arrays))
    return arrays

