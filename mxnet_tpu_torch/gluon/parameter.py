"""Gluon ``Parameter`` / ``Constant`` / ``ParameterDict``, the counterpart
of ``mxnet_tpu/gluon/parameter.py``.

A gluon :class:`Parameter` owns one ``torch.nn.Parameter`` (``tensor``)
and is not one: gluon's ``Parameter.grad()`` is a method where torch's
``.grad`` is an attribute. The block that declares the parameter
registers that torch parameter under the same attribute, so
``state_dict``, ``Module.parameters()``, the captured training steps,
``FusedUpdate`` and ``Block.cast`` see plain torch parameters. The
gradient buffer is the torch parameter's ``.grad`` (made on first
need): :meth:`grad` views it, ``autograd.backward`` writes or adds into
it, and ``FusedUpdate`` reads it.

``data()`` is an ``NDArray`` over the torch parameter, the variable the
imperative autograd records. A shape with a 0 (``Dense(in_units=0)``)
defers the allocation to the first forward, after :meth:`initialize`
recorded the initializer (``DeferredInitializationError`` before that).
A layer built with its shape known allocates at construction, on its
``device``: the port's blocks could always be filled by ``init_params``
or ``params_from_jax`` without ``initialize``; ``initialize`` fills such
a parameter until something has (an initializer, ``set_data``, a load).
"""
from __future__ import annotations

import warnings
import weakref
from collections import OrderedDict

import numpy as onp
import torch

from .. import initializer
from ..base import MXNetError, dtype_name, torch_dtype
from ..context import Context, cpu, current_context, resolve_device
from ..ndarray import ndarray as nd
from ..ndarray.ndarray import NDArray

__all__ = ['DeferredInitializationError', 'Parameter', 'Constant',
           'ParameterDict', 'tensor_types']

tensor_types = (NDArray,)

_VALID_GRAD_REQS = ('write', 'add', 'null')
_FIXED_INITS = {'zeros': 0.0, 'zero': 0.0, 'ones': 1.0, 'one': 1.0}


class DeferredInitializationError(MXNetError):
    """A deferred parameter was read before the first forward fixed its
    shape."""


def _shapes_compatible(declared, concrete):
    return len(declared) == len(concrete) and all(
        d in (0, -1, c) for d, c in zip(declared, concrete))


def _known(shape):
    return bool(shape) and all(int(d) > 0 for d in shape)


def _fixed_value(init):
    """The constant a 'zeros' / 'ones' init (name or instance) fills,
    else None."""
    if isinstance(init, str):
        return _FIXED_INITS.get(init.lower())
    if type(init) is initializer.Zero:
        return 0.0
    if type(init) is initializer.One:
        return 1.0
    return None


def _brief(names, limit=3):
    names = list(names)
    if len(names) > limit:
        return "['%s', ..., '%s']" % ("', '".join(names[:limit - 1]),
                                      names[-1])
    return str(names)


class Parameter:
    """One weight of a block: its torch parameter, gradient request,
    initializer and lr / wd multipliers."""

    def __init__(self, name, grad_req='write', shape=None, dtype='float32',
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype='default', grad_stype='default'):
        self.name, self.init = name, init
        self.lr_mult, self.wd_mult = lr_mult, wd_mult
        self._tensor = None
        self._data = None
        self._owners = []
        self._deferred_init = ()
        self._initialized = False
        self._ctx_list = None
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._shape = (shape,) if isinstance(shape, int) else \
            (tuple(shape) if shape is not None else None)
        self._dtype = dtype_name(dtype)
        self._grad_req = None
        self.grad_req = grad_req
        if stype != 'default' or grad_stype != 'default':
            raise NotImplementedError('the port has dense storage only')

    def __repr__(self):
        return 'Parameter %s (shape=%s, dtype=%s)' % (
            self.name, self.shape, self.dtype)

    # -- declarative attributes --------------------------------------------

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _VALID_GRAD_REQS:
            raise AssertionError(
                "grad_req must be one of 'write', 'add', or 'null', "
                "but got '%s'" % req)
        if not self._differentiable:
            req = 'null'
        changed, self._grad_req = self._grad_req != req, req
        if changed and self._tensor is not None:
            self._mark()

    @property
    def dtype(self):
        return self._dtype

    @dtype.setter
    def dtype(self, dtype):
        self.cast(dtype)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is not None and \
                not _shapes_compatible(self._shape, new_shape):
            raise AssertionError(
                'Expected shape %s is incompatible with given shape %s.'
                % (str(new_shape), str(self._shape)))
        self._shape = new_shape

    @property
    def tensor(self):
        """The ``torch.nn.Parameter`` (None while the shape is
        deferred)."""
        return self._tensor

    # -- the torch parameter -------------------------------------------------

    def _attach(self, module, attr):
        """Register the torch parameter on ``module`` as ``attr`` (now and
        whenever it is replaced)."""
        self._owners.append((module, attr))
        module._parameters[attr] = self._tensor

    def _mark(self):
        """The torch parameter's grad flag and the autograd leaf from
        ``grad_req``."""
        t = self._tensor
        req = self._grad_req
        t.requires_grad_(req != 'null')
        self._data = NDArray(t)
        if req == 'null':
            t.grad = None
            return
        t._mx_var = weakref.ref(self._data)
        self._data._grad_req = req
        self._data._grad = _GradView(t)

    def _set_tensor(self, t):
        """Adopt ``t`` as the storage: in place when the torch parameter
        exists with its shape, dtype and device, else as a new torch
        parameter registered on every owner."""
        cur = self._tensor
        if cur is not None and cur.shape == t.shape and \
                cur.dtype == t.dtype and cur.device == t.device:
            with torch.no_grad():
                cur.copy_(t)
            return
        self._tensor = torch.nn.Parameter(t.detach(), requires_grad=False)
        for mod, attr in self._owners:
            mod._parameters[attr] = self._tensor
        self._mark()

    def _allocate(self, device, value=None):
        """Allocate the torch parameter on ``device`` (filled with
        ``value``, or left as allocated); the layers call this at
        construction when the shape is known."""
        t = torch.empty(self._shape, dtype=torch_dtype(self._dtype),
                        device=device)
        fixed = _fixed_value(self.init) if value is None else value
        if fixed is not None:
            t.fill_(fixed)
            self._initialized = True
        self._set_tensor(t)
        self._ctx_list = [Context.of(t.device)]

    # -- materialisation ---------------------------------------------------

    def _check_and_get(self, arr):
        if arr is not None and self._initialized:
            return arr
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                'initialization was deferred. Actual initialization '
                'happens during the first forward pass. Please pass one '
                'batch of data through the network before accessing '
                'Parameters.' % self.name)
        raise RuntimeError(
            "Parameter '%s' has not been initialized. Note that you "
            'should initialize parameters and create Trainer with '
            'Block.collect_params() instead of Block.params because the '
            'later does not include Parameters of nested child Blocks'
            % self.name)

    def _load_init(self, data, ctx=None, cast_dtype=False,
                   dtype_source='current'):
        """Adopt a loaded array (numpy or NDArray), reconciling the
        declared shape and dtype."""
        arr = data.asnumpy() if isinstance(data, NDArray) \
            else onp.asarray(data)
        if self.shape:
            if not _shapes_compatible(self.shape, arr.shape):
                raise AssertionError(
                    "Failed loading Parameter '%s' from saved params: "
                    'shape incompatible expected %s vs saved %s'
                    % (self.name, str(self.shape), str(arr.shape)))
        self._shape = tuple(arr.shape)
        if cast_dtype and dtype_source == 'saved':
            self._dtype = dtype_name(arr.dtype)
        t = torch.as_tensor(arr).to(torch_dtype(self._dtype))
        self._deferred_init = ()
        self._set_tensor(t.to(self._device(ctx)))
        self._initialized = True

    def _device(self, ctx=None):
        """Where the storage goes: ``ctx`` given, else where it is, else
        the initialize call's context, else the current context."""
        if ctx is not None:
            ctx = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
            return resolve_device(ctx)
        if self._tensor is not None:
            return self._tensor.device
        if self._ctx_list:
            return resolve_device(self._ctx_list[0])
        return resolve_device(None)

    def _finish_deferred_init(self, device=None):
        """Allocate and initialize now that the shape is known (at the
        first forward, on ``device``: the initialize call's context, or
        the input's device)."""
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        if not _known(self.shape):
            raise AssertionError(
                "Cannot initialize Parameter '%s' because it has invalid "
                'shape: %s. Please specify in_units, in_channels, etc '
                'for `Block`s.' % (self.name, str(self.shape)))
        self._deferred_init = ()
        host = nd.zeros(self.shape, ctx=cpu(),
                        dtype='float32' if self._dtype == 'bfloat16'
                        else self._dtype)
        resolved = initializer.create(default_init if init is None
                                      else init)
        desc = initializer.InitDesc(self.name)
        if isinstance(resolved, initializer.Initializer):
            resolved._init_weight(desc, host)
        else:
            resolved(desc, host)
        dev = resolve_device(ctx[0]) if ctx else (
            device if device is not None else self._device())
        self._set_tensor(host._data.to(torch_dtype(self._dtype)).to(dev))
        self._ctx_list = [Context.of(dev)]
        self._initialized = True

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize now, or record the initializer for the first
        forward when the shape is still unknown."""
        if default_init is None:
            default_init = initializer.Uniform()
        if self._initialized and not force_reinit:
            return
        if isinstance(ctx, Context):
            ctx = [ctx]
        if init is None:
            init = self.init if self.init is not None else default_init
        if not _known(self.shape) and not self._allow_deferred_init:
            raise ValueError(
                "Cannot initialize Parameter '%s' because it has "
                'invalid shape: %s.' % (self.name, str(self.shape)))
        self._deferred_init = (init, list(ctx) if ctx else None,
                               default_init)
        if _known(self.shape):
            self._finish_deferred_init()

    def reset_ctx(self, ctx):
        """Move the storage (or the pending initialization) to ``ctx``."""
        ctx = ctx if isinstance(ctx, (list, tuple)) else [ctx]
        if self._tensor is not None:
            self._set_tensor(self._tensor.detach().to(
                resolve_device(ctx[0])))
            self._ctx_list = list(ctx)
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, list(ctx), default_init)
        else:
            raise ValueError(
                "Cannot reset context for Parameter '%s' because it has "
                'not been initialized.' % self.name)

    def set_data(self, data):
        """Overwrite the value in place (the same torch parameter and
        gradient buffer)."""
        arr = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(onp.asarray(data))
        self.shape = tuple(arr.shape)
        if self._tensor is None:
            if not self._deferred_init:
                raise AssertionError(
                    "Parameter '%s' has not been initialized" % self.name)
            self._load_init(arr.detach().cpu().numpy()
                            if arr.dtype != torch.bfloat16
                            else arr.float().cpu().numpy())
            return
        with torch.no_grad():
            self._tensor.copy_(arr)
        self._initialized = True

    # -- accessors ---------------------------------------------------------

    def data(self, ctx=None):
        """The value, an ``NDArray`` over the torch parameter."""
        return self._check_and_get(self._data)

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient buffer, an ``NDArray`` over the torch parameter's
        ``.grad`` (zeros until a backward writes it)."""
        if self._tensor is not None and self._grad_req == 'null':
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % self.name)
        self._check_and_get(self._data)
        return NDArray(self._data._grad.buffer())

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._tensor is not None:
            return self._ctx_list or [Context.of(self._tensor.device)]
        if self._deferred_init:
            return self._deferred_init[1] or [current_context()]
        raise RuntimeError(
            "Parameter '%s' has not been initialized" % self.name)

    def zero_grad(self):
        """Set the gradient buffer to 0 in place."""
        t = self._tensor
        if t is not None and t.grad is not None:
            t.grad.zero_()
        if self._data is not None:
            self._data._grad_fresh = False

    def cast(self, dtype):
        """Cast the storage to ``dtype`` in place (the same torch
        parameter); the gradient buffer is dropped."""
        self._dtype = dtype_name(dtype)
        t = self._tensor
        if t is not None:
            with torch.no_grad():
                t.data = t.data.to(torch_dtype(dtype))
            t.grad = None


class _GradView:
    """The gradient buffer of a parameter: the torch parameter's
    ``.grad``, made (zeros) on first need."""

    __slots__ = ('_t',)

    def __init__(self, t):
        self._t = t

    def buffer(self):
        t = self._t
        if t.grad is None or t.grad.shape != t.shape or \
                t.grad.dtype != t.dtype:
            t.grad = torch.zeros_like(t, memory_format=torch.preserve_format)
        return t.grad

    @property
    def _data(self):
        return self.buffer()


class Constant(Parameter):
    """A value that takes no gradient."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd.array(value, ctx=cpu())
        self.value = value

        class _CopyValue(initializer.Initializer):
            def _init_weight(self, _, arr):
                arr[:] = value.asnumpy()

        init_name = 'Constant_{}_{}'.format(name, id(self))
        initializer._INITIALIZER_REGISTRY[init_name.lower()] = _CopyValue
        super().__init__(name, grad_req='null', shape=value.shape,
                         dtype=dtype_name(value._data.dtype),
                         init=init_name)

    def __repr__(self):
        return 'Constant %s (shape=%s, dtype=%s)' % (
            self.name, self.shape, self.dtype)

    @property
    def grad_req(self):
        return 'null'

    @grad_req.setter
    def grad_req(self, req):
        if req != 'null':
            warnings.warn('Constant parameter "{}" does not support '
                          'grad_req other than "null", and new value "{}" '
                          'is ignored.'.format(self.name, req))
        self._grad_req = 'null'


def _merge_declared_shape(requested, stored):
    if len(requested) != len(stored):
        return None
    merged = []
    for want, have in zip(requested, stored):
        if want == have:
            merged.append(want)
        elif want in (0, -1):
            merged.append(have)
        elif have in (0, -1):
            merged.append(want)
        else:
            return None
    return tuple(merged)


class ParameterDict:
    """Ordered name -> :class:`Parameter` mapping with optional
    sharing."""

    def __init__(self, prefix='', shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __repr__(self):
        head = self._prefix + ' ' if self._prefix else ''
        body = '\n'.join('  %s' % (v,) for v in self.values())
        return '{0}(\n{1}\n)'.format(head, body)

    def __iter__(self):
        return iter(self._params)

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def tensors(self):
        """{name: torch.nn.Parameter}, in order: the torch view of the
        dict (the port's training and serving code reads it)."""
        out = OrderedDict()
        for name, p in self._params.items():
            if p._tensor is None:
                raise DeferredInitializationError(
                    "Parameter '%s' is not allocated yet (its shape is "
                    'deferred to the first forward)' % name)
            out[name] = p._tensor
        return out

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            borrowed = self._shared._params[name]
            self._params[name] = borrowed
            return borrowed
        return None

    def _reconcile(self, param, name, attrs):
        for key, want in attrs.items():
            have = getattr(param, key, None)
            if have is None:
                setattr(param, key, want)
                continue
            if key == 'shape' and len(want) == len(have):
                merged = _merge_declared_shape(tuple(want), have)
                if merged is not None:
                    param._shape = merged
                    continue
            elif key == 'dtype' and dtype_name(want) == dtype_name(have):
                continue
            if want is not None and want != have:
                raise AssertionError(
                    "Cannot retrieve Parameter '%s' because desired "
                    'attribute does not match with stored for attribute '
                    "'%s': desired '%s' vs stored '%s'."
                    % (name, key, str(want), str(have)))

    def get(self, name, **kwargs):
        """Fetch (or create) ``prefix + name``, reconciling the declared
        attributes."""
        full = self.prefix + name
        entry = self._get_impl(full)
        if entry is None:
            entry = self._params[full] = Parameter(full, **kwargs)
        else:
            self._reconcile(entry, full, kwargs)
        return entry

    def get_constant(self, name, value=None):
        full = self.prefix + name
        param = self._get_impl(full)
        if param is None:
            if value is None:
                raise KeyError(
                    "No constant named '{}'. Please specify value if you "
                    'want to create a new constant.'.format(full))
            param = self._params[full] = Constant(full, value)
        elif value is not None:
            if not isinstance(param, Constant):
                raise AssertionError(
                    "Parameter '{}' already exists but it is not a "
                    'constant.'.format(full))
            if isinstance(value, NDArray):
                value = value.asnumpy()
            if param.shape != onp.shape(value) or \
                    not (param.value.asnumpy() == value).all():
                raise AssertionError(
                    "Constant '{}' already exists but its value doesn't "
                    'match new value'.format(full))
        return param

    def update(self, other):
        """Adopt every Parameter of ``other`` (identity-checked on name
        collisions)."""
        for name, param in other.items():
            mine = self._params.setdefault(name, param)
            if mine is not param:
                raise AssertionError(
                    'Cannot update self with other because they have '
                    "different Parameters with the same name '%s'" % name)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = initializer.Uniform()
        if verbose and hasattr(init, 'set_verbosity'):
            init.set_verbosity(verbose=verbose)
        for p in self.values():
            p.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def list_ctx(self):
        if not self._params:
            raise AssertionError('ParameterDict contains no parameters')
        ctxs = set()
        for p in self.values():
            ctxs.update(p.list_ctx())
        return list(ctxs)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=''):
        """Write host copies keyed by (prefix-stripped) name in the
        reference .params container."""
        table = {}
        for p in self.values():
            if not p.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be striped before saving, but "
                    "Parameter's name '%s' does not start with '%s'"
                    % (strip_prefix, p.name, strip_prefix))
            table[p.name[len(strip_prefix):]] = p.data()
        nd.save(filename, table)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix='', cast_dtype=False,
             dtype_source='current'):
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise AssertionError(
                        "restore_prefix is '%s' but Parameter name '%s' "
                        'does not start with it' % (restore_prefix, name))
        strip = len(restore_prefix)
        loaded = {
            restore_prefix + (k[4:] if k.startswith(('arg:', 'aux:'))
                              else k): v
            for k, v in nd.load_numpy(filename).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise AssertionError(
                        "Parameter '%s' is missing in file '%s', which "
                        'contains parameters: %s. Set allow_missing=True '
                        'to ignore missing parameters.'
                        % (name[strip:], filename, _brief(loaded.keys())))
        for name, value in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter '%s' loaded from file '%s' is not "
                        'present in ParameterDict, which contains '
                        'parameters %s. Set ignore_extra=True to ignore.'
                        % (name[strip:], filename,
                           _brief(self._params.keys())))
                continue
            self._params[name]._load_init(value, ctx, cast_dtype=cast_dtype,
                                          dtype_source=dtype_source)


def _wrap_tensor(name, t):
    """A gluon Parameter around an existing torch parameter (a module that
    registered one directly)."""
    p = Parameter(name, grad_req='write' if t.requires_grad else 'null',
                  shape=tuple(t.shape), dtype=dtype_name(t.dtype))
    p._tensor = t
    p._mark()
    # a weight waits for ``initialize`` (or a load); a bias or statistic
    # was filled when its module made it
    p._initialized = not name.endswith('weight')
    return p

