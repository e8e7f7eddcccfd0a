"""Core layers of the BERT and ResNet paths and of the gluon loop, the
counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` (``Sequential`` /
``HybridSequential`` :22-78, ``Dense`` :80, ``Dropout`` :124,
``BatchNorm`` :167, ``Embedding`` :245, ``Flatten`` :270,
``InstanceNorm`` :281, ``LayerNorm`` :315). ``Activation`` lives in
``activations.py`` and is exported here too.

Parameters keep the JAX layouts (``Dense`` weight (units, in_units),
``Embedding`` weight (input_dim, output_dim)), names (``weight``,
``bias``, ``gamma``, ``beta``, ``running_mean``, ``running_var``) and
initializers (``weight_initializer`` None: the model's initializer fills
them, through ``initialize(init)``, ``init_params`` or
``params_from_jax``; bias and beta ``'zeros'``, gamma and the running
variance ``'ones'``, the running mean ``'zeros'``). ``in_units=0`` /
``in_channels=0`` defer the shape to the first forward, as the JAX layers
infer it; with the shape given a layer allocates its parameters at
construction on ``device`` (the constant ones filled, the weights left to
the initializer).
"""
from __future__ import annotations

import torch

from ... import random as _random
from ...context import resolve_device
from ...ops import nn as ops
from ..block import Block, HybridBlock, torch_dtype, training
from .activations import Activation

__all__ = ['Activation', 'BatchNorm', 'Dense', 'Dropout', 'Embedding',
           'Flatten', 'HybridLambda', 'HybridSequential', 'InstanceNorm',
           'Lambda', 'LayerNorm', 'Sequential']


def _declare(block, name, shape, init, device, grad_req='write',
             differentiable=True):
    """``block.<name>``: a gluon parameter of ``shape`` (a 0 defers it),
    allocated now on ``device`` when the shape is known."""
    p = block.params.get(name, shape=shape, init=init,
                         allow_deferred_init=True, grad_req=grad_req,
                         differentiable=differentiable)
    setattr(block, name, p)
    if p._tensor is None and all(int(d) > 0 for d in shape):
        p._allocate(resolve_device(device))
    return p


def _materialize(block, x, shapes):
    """Fix the deferred shapes (``{name: shape}``) from the first input
    ``x`` and allocate them on its device."""
    for name, shape in shapes.items():
        p = block._reg_params[name]
        if p._tensor is None:
            p.shape = shape
            if not p._deferred_init:
                raise p._check_and_get(None)
            p._finish_deferred_init(x.device)


class Sequential(Block):
    """Blocks applied in order; the children are named by their position,
    so they add nothing to the gluon names but their own prefixes."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x):
        for b in self._modules.values():
            x = b(x)
        return x

    def __getitem__(self, key):
        picked = list(self._modules.values())[key]
        if not isinstance(picked, list):
            return picked
        sub = type(self)(prefix=self.prefix)
        sub.add(*picked)
        return sub

    def __len__(self):
        return len(self._modules)


class HybridSequential(Sequential, HybridBlock):
    """Sequential of hybridizable blocks."""

    forward = Sequential.forward


class Dense(HybridBlock):
    """Fully connected: ``act(x W^T + b)``."""

    _unscoped_prefix = 'dense_'

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype='float32', weight_initializer=None,
                 bias_initializer='zeros', in_units=0, prefix=None,
                 params=None, device=None):
        super().__init__(prefix, params)
        self._units, self._in_units, self._flatten = units, in_units, flatten
        with self.name_scope():
            _declare(self, 'weight', (units, in_units), weight_initializer,
                     device)
            if use_bias:
                _declare(self, 'bias', (units,), bias_initializer, device)
            else:
                self.bias = None
            self.act = None if activation is None else \
                Activation(activation, prefix=activation + '_')

    def forward(self, x):
        if self.weight is None:
            fan_in = 1
            for d in (x.shape[1:] if self._flatten else x.shape[-1:]):
                fan_in *= int(d)
            _materialize(self, x, {'weight': (self._units, fan_in)})
        out = ops.fully_connected(x, self.weight, self.bias,
                                  flatten=self._flatten)
        return out if self.act is None else self.act(out)


class Dropout(HybridBlock):
    """Inverted dropout; the identity at rate 0 or in inference mode.

    The mask comes from ``self.generator`` when a trainer set one
    (``ParallelTrainer`` owns and seeds one per net), else from the
    generator of the input's device (``mx.random``)."""

    _unscoped_prefix = 'dropout_'

    def __init__(self, rate, axes=(), prefix=None):
        super().__init__(prefix)
        if axes:
            raise NotImplementedError('Dropout: axes= is not ported')
        self._rate = rate
        self.generator = None

    def forward(self, x):
        train = training(self)
        gen = self.generator
        if gen is None and train and self._rate > 0:
            gen = _random.generator(x.device)
        return ops.dropout(x, self._rate, gen, train)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` with moving statistics.

    ``running_mean`` and ``running_var`` take no gradient (``grad_req
    'null'``); ``gamma`` / ``beta`` take none when ``scale`` / ``center``
    is off. In training mode (:func:`~..block.training`, and not
    ``use_global_stats``) the batch statistics normalize and the moving
    averages are updated in place, as ``keep * running + (1 - keep) *
    batch`` with ``keep = momentum``; otherwise the moving statistics
    normalize (``ops.nn.batch_norm``). ``use_global_stats`` may be set on
    a built net to fine-tune it with its BatchNorm statistics frozen.

    :meth:`cast` to float16 or bfloat16 keeps gamma, beta and the moving
    statistics float32 (``BatchNorm.cast``, basic_layers.py:208-219): the
    op mixes low-precision activations with them, returns the
    activations' dtype and the batch statistics in the moving
    statistics' dtype, so the moving averages accumulate in float32."""

    _unscoped_prefix = 'batchnorm_'

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer='zeros', gamma_initializer='ones',
                 running_mean_initializer='zeros',
                 running_variance_initializer='ones', in_channels=0,
                 prefix=None, params=None, device=None):
        super().__init__(prefix, params)
        self._axis, self._momentum, self._epsilon = axis, momentum, epsilon
        self._fix_gamma = not scale
        self.use_global_stats = use_global_stats
        c = (in_channels,)
        with self.name_scope():
            _declare(self, 'gamma', c, gamma_initializer, device,
                     'write' if scale else 'null')
            _declare(self, 'beta', c, beta_initializer, device,
                     'write' if center else 'null')
            _declare(self, 'running_mean', c, running_mean_initializer,
                     device, 'null', differentiable=False)
            _declare(self, 'running_var', c, running_variance_initializer,
                     device, 'null', differentiable=False)

    def cast(self, dtype):
        dt = torch_dtype(dtype)
        return super().cast(torch.float32 if dt in (torch.float16,
                                                     torch.bfloat16) else dt)

    def forward(self, x):
        if self.gamma is None:
            c = (int(x.shape[self._axis]),)
            _materialize(self, x, dict.fromkeys(
                ('gamma', 'beta', 'running_mean', 'running_var'), c))
        train = training(self)
        out, mean, var = ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, fix_gamma=self._fix_gamma,
            use_global_stats=self.use_global_stats, axis=self._axis,
            training=train)
        if train and not self.use_global_stats:
            keep = self._momentum
            with torch.no_grad():
                self.running_mean.copy_(keep * self.running_mean
                                        + (1 - keep) * mean)
                self.running_var.copy_(keep * self.running_var
                                       + (1 - keep) * var)
        return out


class Flatten(HybridBlock):
    """Collapse all axes but the first."""

    _unscoped_prefix = 'flatten_'

    def forward(self, x):
        return ops.flatten(x)


class Embedding(HybridBlock):
    """Integer indices -> rows of a learned (input_dim, output_dim)
    table."""

    _unscoped_prefix = 'embedding_'

    def __init__(self, input_dim, output_dim, dtype='float32',
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None, device=None):
        super().__init__(prefix, params)
        with self.name_scope():
            _declare(self, 'weight', (input_dim, output_dim),
                     weight_initializer, device)

    def forward(self, x):
        return ops.embedding(x, self.weight)


class InstanceNorm(HybridBlock):
    """Per-sample, per-channel normalization over the spatial axes
    (``InstanceNorm`` op): ``(x - mean) / sqrt(var + eps) * gamma +
    beta``; gamma (ones) takes no gradient unless ``scale``, beta (zeros)
    none unless ``center``. ``axis`` other than 1 is swapped in and back
    out, as the JAX layer does."""

    _unscoped_prefix = 'instancenorm_'

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer='zeros', gamma_initializer='ones',
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(prefix, params)
        self._axis, self._epsilon = axis, epsilon
        self.in_channels = in_channels
        c = (in_channels,)
        with self.name_scope():
            _declare(self, 'gamma', c, gamma_initializer, device,
                     'write' if scale else 'null')
            _declare(self, 'beta', c, beta_initializer, device,
                     'write' if center else 'null')

    def forward(self, x):
        if self.gamma is None:
            _materialize(self, x, dict.fromkeys(
                ('gamma', 'beta'), (int(x.shape[self._axis]),)))
        if self._axis == 1:
            return ops.instance_norm(x, self.gamma, self.beta,
                                     eps=self._epsilon)
        out = ops.instance_norm(x.transpose(1, self._axis), self.gamma,
                                self.beta, eps=self._epsilon)
        return out.transpose(1, self._axis)


class LayerNorm(HybridBlock):
    """Normalize over one axis with a learned affine (gamma 1, beta 0)."""

    _unscoped_prefix = 'layernorm_'

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer='zeros', gamma_initializer='ones',
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(prefix, params)
        self._axis, self._epsilon = axis, epsilon
        c = (in_channels,)
        with self.name_scope():
            _declare(self, 'gamma', c, gamma_initializer, device,
                     'write' if scale else 'null')
            _declare(self, 'beta', c, beta_initializer, device,
                     'write' if center else 'null')

    def forward(self, x):
        if self.gamma is None:
            c = (int(x.shape[self._axis]),)
            _materialize(self, x, {'gamma': c, 'beta': c})
        return ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)


def _nd_function(function, eager):
    """An op name or a callable, as ``Lambda`` / ``HybridLambda`` take
    them: a name resolves to ``mx.nd.<name>`` (called ``F.<name>`` for a
    HybridLambda)."""
    from ... import ndarray as nd
    if isinstance(function, str):
        if not hasattr(nd, function):
            raise ValueError('Function name %s is not found in ndarray.'
                             % function)
        op = getattr(nd, function)
        return (op if eager else (lambda F, *a: op(*a))), function
    if callable(function):
        return function, getattr(function, '__name__', 'custom')
    raise ValueError('Unrecognized function in lambda: %s of type %s'
                     % (function, type(function)))


class Lambda(Block):
    """A function (or an ``nd`` op name) as a block, on NDArrays."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix)
        self._func_impl, self._func_name = _nd_function(function, True)

    def forward(self, *args):
        from ..block import _unwrap, _wrap
        return _unwrap(self._func_impl(*_wrap(args)))


class HybridLambda(HybridBlock):
    """A function ``f(F, x, *args)`` (or an op name) as a hybrid
    block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix)
        self._func, self._func_name = _nd_function(function, False)

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)
