"""The port's ``Block`` / ``HybridBlock``, the counterpart of
``mxnet_tpu/gluon/block.py``.

A :class:`Block` is a ``torch.nn.Module`` with gluon's naming, parameters
and calling convention:

  * names: a block's ``prefix`` is its own part of the gluon names; a
    parameter's name in :meth:`collect_params` joins the prefixes of the
    enclosing blocks and its own (``stage1_conv0_weight``), as the JAX
    net's ``collect_params()`` does minus the model's own auto-numbered
    prefix (``resnetv10_``). A block made inside ``with
    parent.name_scope():`` with no prefix takes its alias and the scope's
    next count (``conv0_``, ``dense1_``), as in gluon; outside any scope
    it takes its class's fixed default (a layer's alias and ``_``, ''
    for containers and models), the part the port's names leave out;
  * parameters: ``self.weight = self.params.get('weight', ...)`` makes a
    gluon :class:`~.parameter.Parameter` and registers its torch
    parameter on the module as ``weight`` (``self.weight`` in a forward
    is that torch tensor); ``collect_params()`` is a
    :class:`~.parameter.ParameterDict` of gluon parameters, and its
    ``tensors()`` the torch ones. A parameter used twice (BERT's tied
    decoder weight) is one entry;
  * ``initialize``, ``hybridize`` (flags only: the forward is the same),
    ``cast``, ``save_parameters`` / ``load_parameters`` (structural
    names, ``features.0.weight``, in the reference .params container),
    forward hooks, ``apply`` and ``summary``;
  * a call on ``NDArray``s unwraps them, runs the module with torch's
    grad mode on inside ``autograd.record()`` and off outside it, and
    wraps the outputs. A call on tensors is a plain module call.

Training: a layer trains when ``autograd.is_training()`` is on (inside
``record()``, ``train_mode()``) or its module was put in training with
``Module.train()`` (:func:`training`); a new block starts with
``training`` False.

:meth:`Block.cast` casts every parameter in place, as ``Block.cast``
(block.py:360-365) and ``Parameter.cast`` (parameter.py:334-339) do:
``net.cast('bfloat16')`` then trains in bf16 on bf16 data, with the
layers that keep float32 (``BatchNorm``) overriding it.
"""
from __future__ import annotations

import re
import threading
import warnings
from collections import OrderedDict

import numpy as onp
import torch

from .. import autograd
from ..base import dtype_name, torch_dtype as _torch_dtype
from ..ndarray import ndarray as nd
from ..ndarray.ndarray import NDArray
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _wrap_tensor)

__all__ = ['Block', 'HybridBlock', 'params_from_jax', 'torch_dtype',
           'training', 'DeferredInitializationError', 'Parameter',
           'ParameterDict']

_DTYPES = ('float32', 'bfloat16', 'float16')


def torch_dtype(dtype):
    """The ``torch.dtype`` of ``dtype``: a ``torch.dtype``, or a name
    ('float32', 'bfloat16', 'float16') as the JAX package takes them."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in _DTYPES:
        raise TypeError('unknown dtype %r (have %s)'
                        % (dtype, ', '.join(sorted(_DTYPES))))
    return _torch_dtype(str(dtype))


def training(module):
    """Whether a layer computes in training mode: ``autograd`` says so or
    its module was put in training."""
    return autograd.is_training() or module.training


class _BlockScope:
    """A block's naming scope: the children made inside it count per
    alias (a block made with ``prefix=''`` opens none)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old = None

    @staticmethod
    def current():
        return getattr(_BlockScope._current, 'value', None)

    def next_prefix(self, hint):
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return '%s%d_' % (hint, n)

    def __enter__(self):
        if not self._block._empty_prefix:
            self._old = _BlockScope.current()
            _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if not self._block._empty_prefix:
            _BlockScope._current.value = self._old


def _flatten(args):
    """Nested lists of NDArrays / tensors -> (leaves, format)."""
    if isinstance(args, (list, tuple)):
        pairs = [_flatten(a) for a in args]
        return [leaf for sub, _ in pairs for leaf in sub], \
            [fmt for _, fmt in pairs]
    return [args], 0


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(a) for a in x)
    return x


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(a) for a in x)
    return x


def _has_nd(args):
    args = list(args)
    return any(isinstance(a, NDArray) or (isinstance(a, (list, tuple))
                                          and _has_nd(a)) for a in args)


class _HookHandle:
    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()


class Block(torch.nn.Module):
    """``torch.nn.Module`` with gluon's names, parameters and calls."""

    _unscoped_prefix = ''

    def __init__(self, prefix=None, params=None):
        super().__init__()
        # a block made with prefix '' numbers its children in the
        # enclosing scope, as in gluon
        self._empty_prefix = prefix == ''
        if prefix is None:
            scope = _BlockScope.current()
            prefix = scope.next_prefix(self._alias()) if scope is not None \
                else self._unscoped_prefix
        self.prefix = prefix
        # shared parameters are looked up under the sharing dict's prefix
        self._params = ParameterDict(
            prefix if params is None else params.prefix, params)
        self._reg_params = OrderedDict()
        self._scope = _BlockScope(self)
        self.training = False

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            reg = self.__dict__.get('_reg_params')
            if reg is None:
                raise AttributeError('Block.__init__ must run before a '
                                     'Parameter is assigned')
            if name in reg and reg[name] is not value:
                raise AssertionError(
                    'Overriding Parameter attribute %s is not allowed. If '
                    'you want to share parameters between blocks, please '
                    "set 'params' at Block construction instead." % name)
            reg[name] = value
            self.__dict__.pop(name, None)
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def name(self):
        return self.prefix[:-1] if self.prefix.endswith('_') else \
            self.prefix

    def name_scope(self):
        """The scope in which children made without a prefix are
        numbered in this block."""
        return self._scope

    @property
    def params(self):
        """This block's own parameter dictionary (not its children's)."""
        return self._params

    def collect_params(self, select=None):
        """A :class:`ParameterDict` of this block's and its descendants'
        parameters by gluon name, in registration order, filtered by the
        regex ``select``."""
        out = ParameterDict(self.prefix)
        _collect(self, '', out._params)
        if select:
            pattern = re.compile(select)
            for k in [k for k in out._params if not pattern.match(k)]:
                del out._params[k]
        return out

    def register_child(self, block, name=None):
        """Register a child block (by position when ``name`` is None)."""
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    def register_forward_pre_hook(self, hook):
        return _HookHandle(super().register_forward_pre_hook(hook))

    def register_forward_hook(self, hook):
        return _HookHandle(super().register_forward_hook(hook))

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize this block's and its descendants' parameters."""
        from .. import initializer as _init_mod
        if init is None:
            init = _init_mod.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Hybridize the HybridBlocks below (flags only in the port: the
        forward is the non-hybridized one)."""
        for child in self._modules.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    @torch.no_grad()
    def cast(self, dtype):
        """Cast the parameters of this block and of its children to
        ``dtype`` (a name such as ``'bfloat16'`` or a ``torch.dtype``), in
        place: each stays the same torch parameter, with its
        ``requires_grad``, and any gradient it holds is dropped (the JAX
        ``Parameter.cast`` re-creates it). Returns ``self``."""
        dt = torch_dtype(dtype)
        for child in self._modules.values():
            _cast_module(child, dt)
        _cast_params(self._parameters.values(), dt)
        for p in self._reg_params.values():
            p._dtype = dtype_name(p._tensor.dtype if p._tensor is not None
                                  else dt)
        return self

    # -- save / load ---------------------------------------------------------

    def _collect_params_with_prefix(self, prefix=''):
        out = OrderedDict()
        _structural(self, prefix, out)
        return out

    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters by structural name (``features.0.weight``)
        in the reference .params container."""
        params = self._collect_params_with_prefix()
        if deduplicate:
            reverse = {v: k for k, v in params.items()}
            params = {v: k for k, v in reverse.items()}
        nd.save(filename, {k: v.data() for k, v in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source='current'):
        """Load parameters saved by :meth:`save_parameters` (or, for a
        file without structural names, by ``collect_params().save``)."""
        loaded = nd.load_numpy(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any('.' in key for key in loaded):
            del loaded
            self.collect_params().load(
                filename, ctx, allow_missing, ignore_extra, self.prefix,
                cast_dtype=cast_dtype, dtype_source=dtype_source)
            return
        if not allow_missing:
            absent = [n for n in params if n not in loaded]
            if absent:
                raise AssertionError(
                    "Parameter '%s' is missing in file '%s'. Set "
                    'allow_missing=True to ignore missing parameters.'
                    % (absent[0], filename))
        for name in loaded:
            if name in params:
                params[name]._load_init(loaded[name], ctx,
                                        cast_dtype=cast_dtype,
                                        dtype_source=dtype_source)
            elif not ignore_extra:
                raise ValueError(
                    "Parameter '%s' loaded from file '%s' is not present "
                    'in this block. Set ignore_extra=True to ignore.'
                    % (name, filename))

    def save_params(self, filename):
        warnings.warn('save_params is deprecated. Please use '
                      'save_parameters.')
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        warnings.warn('load_params is deprecated. Please use '
                      'load_parameters.')
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    # -- calls -------------------------------------------------------------

    def __call__(self, *args, **kwargs):
        if _has_nd(args) or _has_nd(kwargs.values()):
            with autograd.grad_enabled():
                out = super().__call__(*_unwrap(args), **{
                    k: _unwrap(v) for k, v in kwargs.items()})
            return _wrap(out)
        return super().__call__(*args, **kwargs)

    def summary(self, *inputs):
        """Print a per-layer table of output shapes and parameter
        counts."""
        summary = OrderedDict()
        seen = set()
        hooks = []

        def shape_str(args):
            flat, _ = _flatten(args)
            shapes = [tuple(x.shape) if isinstance(x, (NDArray,
                                                       torch.Tensor))
                      else None for x in flat]
            return str(shapes[0] if len(shapes) == 1 else shapes)

        def register(block):
            def hook(block, _, outputs):
                key = '%s-%i' % (block.__class__.__name__, len(summary) + 1)
                n = 0
                for p in block._reg_params.values():
                    size = int(onp.prod(p.shape)) if p.shape else 0
                    n += size
                    seen.add(p)
                summary[key] = {'output_shape': shape_str(outputs),
                                'n_params': n}
            if isinstance(block, Block):
                hooks.append(block.register_forward_hook(hook))

        self.apply(register)
        try:
            self(*inputs)
            print('-' * 80)
            print('{:>20}  {:>42} {:>15}'.format('Layer (type)',
                                                 'Output Shape', 'Param #'))
            print('=' * 80)
            total = 0
            for layer, row in summary.items():
                print('{:>20}  {:>42} {:>15}'.format(
                    layer, row['output_shape'], row['n_params']))
                total += row['n_params']
            print('=' * 80)
            print('Total params: ' + str(total))
            print('-' * 80)
        finally:
            for h in hooks:
                h.detach()


class HybridBlock(Block):
    """A block that may be hybridized. The port records the flags
    (``active``, ``static_alloc``, ``static_shape``) and runs the same
    forward either way (a captured forward is ROADMAP A10's item).

    A subclass may define ``hybrid_forward(F, x, *args, **params)`` as in
    gluon: ``F`` is ``mx.nd``, ``x`` and ``args`` are NDArrays and each
    of the block's own parameters is passed by name as an NDArray."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = []

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._flags = [('static_alloc', static_alloc),
                       ('static_shape', static_shape)] + list(kwargs.items())
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def forward(self, x, *args):
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise NotImplementedError
        from .. import ndarray as F
        params = {k: p.data() for k, p in self._reg_params.items()}
        with autograd.grad_enabled():
            out = self.hybrid_forward(F, _wrap(x), *_wrap(args), **params)
        return _unwrap(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _cast_module(mod, dtype):
    """A child's cast: a Block's own (``BatchNorm`` keeps float32); a
    plain container (BERT's ``ModuleList`` of cells) casts its children
    and parameters the same way."""
    if isinstance(mod, Block):
        mod.cast(dtype)
    elif mod is not None:
        for child in mod._modules.values():
            _cast_module(child, dtype)
        _cast_params(mod._parameters.values(), dtype)


def _cast_params(params, dtype):
    for p in params:
        if p is not None:
            p.data = p.data.to(dtype)
            p.grad = None


def _reg(mod):
    """A module's gluon parameters by attribute: a Block's registered
    ones, and a gluon Parameter made around each torch parameter a module
    registered directly."""
    reg = mod.__dict__.get('_reg_params')
    if reg is None:
        reg = mod.__dict__.setdefault('_mx_reg_params', OrderedDict())
    for name, t in mod._parameters.items():
        if t is not None and name not in reg:
            prefix = getattr(mod, 'prefix', '') or ''
            reg[name] = p = _wrap_tensor(prefix + name, t)
            p._owners.append((mod, name))
        elif name in reg and t is not None and reg[name]._tensor is not t:
            reg[name]._tensor = t          # re-registered by its module
            reg[name]._mark()
    return reg


def _collect(mod, pre, out):
    if isinstance(mod, Block):
        pre = pre + mod.prefix
    seen = {id(p) for p in out.values()}
    for name, p in _reg(mod).items():
        if id(p) not in seen:
            full = pre + name
            if len(full) > len(p.name):
                p.name = full
            out[full] = p
            seen.add(id(p))
    for child in mod._modules.values():
        if child is not None:
            _collect(child, pre, out)


def _structural(mod, prefix, out):
    dot = prefix + '.' if prefix else ''
    for key, p in _reg(mod).items():
        out[dot + key] = p
    for name, child in mod._modules.items():
        if child is not None:
            _structural(child, dot + name, out)


# a block's auto-numbered prefix: its alias and a count (``lstm0_``;
# an RNN layer's alias is its mode, ``rnn_relu0_`` / ``rnn_tanh0_``)
_AUTO_PREFIX = re.compile(r'^(?:rnn_relu|rnn_tanh|[a-z]+)\d+_')


@torch.no_grad()
def params_from_jax(jax_params, net):
    """Copy a JAX net's parameters into ``net``.

    ``jax_params`` maps each name of the JAX net's ``collect_params()``
    (e.g. ``bertmodel0_enc_layer0_attn_qkv_weight``,
    ``resnetv10_stage1_batchnorm0_running_var``) to an array, float32 or
    bfloat16 (a bf16 value widens to float32 exactly). The model's
    auto-numbered prefix is stripped; every remaining name must be a
    parameter of ``net`` with the same shape, and every parameter of
    ``net`` must be given, or this raises. Parameters that take no
    gradient (moving statistics) are copied too. Each value lands in the
    dtype the parameter has: a float32 value into a bf16 parameter (a net
    after ``cast('bfloat16')``) rounds to nearest even, as the JAX
    package's ``astype`` does. The parameters count as initialized.
    Returns ``net``."""
    params = net.collect_params()
    mine = params.tensors()
    given = {}
    for name, value in jax_params.items():
        short = _AUTO_PREFIX.sub('', name, count=1)
        if short in given:
            raise ValueError('params_from_jax: %r and another name both map '
                             'to %r' % (name, short))
        given[short] = value
    unknown = sorted(set(given) - set(mine))
    missing = sorted(set(mine) - set(given))
    if unknown or missing:
        raise ValueError('params_from_jax: names do not match the net '
                         '(unknown %s, missing %s)' % (unknown, missing))
    for name, p in mine.items():
        arr = onp.asarray(given[name]).astype(onp.float32)
        if arr.shape != tuple(p.shape):
            raise ValueError('params_from_jax: %s has shape %r, the net %r'
                             % (name, arr.shape, tuple(p.shape)))
        p.copy_(torch.from_numpy(arr))
        params[name]._initialized = True
    return net

