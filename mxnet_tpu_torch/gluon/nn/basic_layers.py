"""Core layers of the BERT path, the counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py`` (``Dense`` :80, ``Dropout`` :124,
``Embedding`` :245, ``LayerNorm`` :315) and of ``Activation`` in
``mxnet_tpu/gluon/nn/activations.py``.

Parameters keep the JAX layouts (``Dense`` weight (units, in_units),
``Embedding`` weight (input_dim, output_dim)) and names (``weight``,
``bias``, ``gamma``, ``beta``). The JAX layers infer ``in_units`` at the
first call; a ``torch.nn.Module`` allocates at construction, so the port
needs it up front. Weights are allocated uninitialised (the JAX layers'
``weight_initializer`` is None too: the model's initializer fills them,
here ``bert.init_params`` or ``bert.params_from_jax``); biases and beta
start at 0 and gamma at 1, the JAX layers' default initializers.
"""
from __future__ import annotations

import torch

from ...context import resolve_device
from ...ops import nn as ops
from ..block import Block

__all__ = ['Activation', 'Dense', 'Dropout', 'Embedding', 'LayerNorm']


def _param(shape, device, fill=None):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if fill is not None:
        t.fill_(fill)
    return torch.nn.Parameter(t)


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
