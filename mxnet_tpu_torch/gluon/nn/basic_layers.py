"""Core layers of the BERT and ResNet paths, the counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py`` (``HybridSequential`` :73,
``Dense`` :80, ``Dropout`` :124, ``BatchNorm`` :167, ``Embedding`` :245,
``Flatten`` :270, ``LayerNorm`` :315) and of ``Activation`` in
``mxnet_tpu/gluon/nn/activations.py``.

Parameters keep the JAX layouts (``Dense`` weight (units, in_units),
``Embedding`` weight (input_dim, output_dim)) and names (``weight``,
``bias``, ``gamma``, ``beta``, ``running_mean``, ``running_var``). The
JAX layers infer ``in_units`` / ``in_channels`` at the first call; a
``torch.nn.Module`` allocates at construction, so the port needs them up
front. Weights are allocated uninitialised (the JAX layers'
``weight_initializer`` is None too: the model's initializer fills them,
here ``init_params`` or ``params_from_jax`` of the model zoo); biases and
beta start at 0, gamma and the running variance at 1, the running mean at
0, the JAX layers' default initializers.
"""
from __future__ import annotations

import torch

from ...context import resolve_device
from ...ops import nn as ops
from ..block import Block, torch_dtype

__all__ = ['Activation', 'BatchNorm', 'Dense', 'Dropout', 'Embedding',
           'Flatten', 'HybridSequential', 'LayerNorm']


def _param(shape, device, fill=None, requires_grad=True):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if fill is not None:
        t.fill_(fill)
    return torch.nn.Parameter(t, requires_grad=requires_grad)


class HybridSequential(Block):
    """Blocks applied in order; the children are named by their position,
    so they add nothing to the gluon names but their own prefixes."""

    def __init__(self, prefix=''):
        super().__init__(prefix)

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)

    def forward(self, x):
        for b in self._modules.values():
            x = b(x)
        return x


class Activation(Block):
    """Elementwise activation chosen by name (``ops.nn.activation``)."""

    def __init__(self, activation, prefix=None):
        super().__init__(activation + '_' if prefix is None else prefix)
        self._kind = activation

    def forward(self, x):
        return ops.activation(x, self._kind)


class Dense(Block):
    """Fully connected: ``act(x W^T + b)``."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 in_units=0, prefix='dense_', device=None):
        super().__init__(prefix)
        if in_units <= 0:
            raise ValueError('Dense: the port allocates at construction and '
                             'needs in_units > 0, got %r' % (in_units,))
        device = resolve_device(device)
        self._units, self._in_units, self._flatten = units, in_units, flatten
        self.weight = _param((units, in_units), device)
        self.bias = _param((units,), device, 0.0) if use_bias else None
        self.act = None if activation is None else Activation(activation)

    def forward(self, x):
        out = ops.fully_connected(x, self.weight, self.bias,
                                  flatten=self._flatten)
        return out if self.act is None else self.act(out)


class Dropout(Block):
    """Inverted dropout; the identity at rate 0 or in inference mode.

    The mask comes from ``self.generator``, a ``torch.Generator`` on the
    layer's device that the trainer sets (``ParallelTrainer`` owns and
    seeds one per net); training with a rate above 0 and no generator
    raises rather than drawing from the global RNG."""

    def __init__(self, rate, prefix='dropout_'):
        super().__init__(prefix)
        self._rate = rate
        self.generator = None

    def forward(self, x):
        return ops.dropout(x, self._rate, self.generator, self.training)


class BatchNorm(Block):
    """Batch normalization over ``axis`` with moving statistics.

    ``running_mean`` and ``running_var`` are parameters that take no
    gradient (``grad_req='null'`` in the JAX layer); ``gamma`` /
    ``beta`` take none when ``scale`` / ``center`` is off. In training
    mode (and not ``use_global_stats``) the batch statistics normalize
    and the moving averages are updated in place, as
    ``keep * running + (1 - keep) * batch`` with ``keep = momentum``;
    otherwise the moving statistics normalize (``ops.nn.batch_norm``).
    ``use_global_stats`` may be set on a built net to fine-tune it with
    its BatchNorm statistics frozen.

    :meth:`cast` to float16 or bfloat16 keeps gamma, beta and the moving
    statistics float32 (``BatchNorm.cast``, basic_layers.py:208-219): the
    op mixes low-precision activations with them, returns the
    activations' dtype and the batch statistics in the moving
    statistics' dtype, so the moving averages accumulate in float32."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 prefix='batchnorm_', device=None):
        super().__init__(prefix)
        if in_channels <= 0:
            raise ValueError('BatchNorm: the port allocates at construction '
                             'and needs in_channels > 0, got %r'
                             % (in_channels,))
        device = resolve_device(device)
        self._axis, self._momentum, self._epsilon = axis, momentum, epsilon
        self._fix_gamma = not scale
        self.use_global_stats = use_global_stats
        self.gamma = _param((in_channels,), device, 1.0, requires_grad=scale)
        self.beta = _param((in_channels,), device, 0.0, requires_grad=center)
        self.running_mean = _param((in_channels,), device, 0.0,
                                   requires_grad=False)
        self.running_var = _param((in_channels,), device, 1.0,
                                  requires_grad=False)

    def cast(self, dtype):
        dt = torch_dtype(dtype)
        return super().cast(torch.float32 if dt in (torch.float16,
                                                     torch.bfloat16) else dt)

    def forward(self, x):
        train = self.training and not self.use_global_stats
        out, mean, var = ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, fix_gamma=self._fix_gamma,
            use_global_stats=self.use_global_stats, axis=self._axis,
            training=self.training)
        if train:
            keep = self._momentum
            with torch.no_grad():
                self.running_mean.copy_(keep * self.running_mean
                                        + (1 - keep) * mean)
                self.running_var.copy_(keep * self.running_var
                                       + (1 - keep) * var)
        return out


class Flatten(Block):
    """Collapse all axes but the first."""

    def __init__(self, prefix='flatten_'):
        super().__init__(prefix)

    def forward(self, x):
        return ops.flatten(x)


class Embedding(Block):
    """Integer indices -> rows of a learned (input_dim, output_dim)
    table."""

    def __init__(self, input_dim, output_dim, prefix='embedding_',
                 device=None):
        super().__init__(prefix)
        self.weight = _param((input_dim, output_dim),
                             resolve_device(device))

    def forward(self, x):
        return ops.embedding(x, self.weight)


class LayerNorm(Block):
    """Normalize over one axis with a learned affine (gamma 1, beta 0)."""

    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0,
                 prefix='layernorm_', device=None):
        super().__init__(prefix)
        if in_channels <= 0:
            raise ValueError('LayerNorm: the port allocates at construction '
                             'and needs in_channels > 0, got %r'
                             % (in_channels,))
        device = resolve_device(device)
        self._axis, self._epsilon = axis, epsilon
        self.gamma = _param((in_channels,), device, 1.0)
        self.beta = _param((in_channels,), device, 0.0)

    def forward(self, x):
        return ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)
