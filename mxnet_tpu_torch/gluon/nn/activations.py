"""Activation layers, the counterpart of
``mxnet_tpu/gluon/nn/activations.py`` (``Activation`` :38, ``LeakyReLU``
:57, ``PReLU`` :72, ``ELU`` :87, ``SELU`` :98, ``Swish`` :105, ``GELU``
:116).

Each is a thin dispatcher onto an op of ``ops/nn.py``, as there:
``Activation`` onto :func:`~mxnet_tpu_torch.ops.nn.activation` (relu,
sigmoid, tanh, softrelu and softsign on the epilogue kernels' rows 7 /
8); ``LeakyReLU`` onto the ``leaky`` kind of
:func:`~mxnet_tpu_torch.ops.nn.leaky_relu` (rows 7 / 8 for a slope > 0);
``PReLU`` onto its ``prelu`` kind with a learned ``alpha`` (a (1,)
parameter, ``Constant(0.25)`` by default); ``ELU`` / ``SELU`` onto its
``elu`` / ``selu`` kinds (the JAX op's save-output backward); ``GELU``
onto its ``gelu`` kind; ``Swish`` is ``x * sigmoid(beta x)``, plain, as
the JAX block computes it.
"""
from __future__ import annotations

import torch

from ... import initializer as _init
from ...ops import nn as ops
from ..block import HybridBlock

__all__ = ['Activation', 'LeakyReLU', 'ELU', 'SELU', 'PReLU', 'Swish', 'GELU']


class _ActBlock(HybridBlock):
    """The shared repr: the class name and a configured constant."""

    def _reprarg(self):
        return ''

    def __repr__(self):
        return '{}({})'.format(type(self).__name__, self._reprarg())


class Activation(_ActBlock):
    """Elementwise activation chosen by name (``ops.nn.activation``)."""

    def __init__(self, activation, prefix=None):
        self._kind = activation
        super().__init__(prefix)

    @property
    def _unscoped_prefix(self):
        return self._kind + '_'

    def _alias(self):
        return self._kind

    def _reprarg(self):
        return self._kind

    def forward(self, x):
        return ops.activation(x, self._kind)


class LeakyReLU(_ActBlock):
    """``max(x, 0) + alpha min(x, 0)`` with a fixed non-negative slope."""

    _unscoped_prefix = 'leakyrelu_'

    def __init__(self, alpha, prefix=None):
        assert alpha >= 0, \
            'Slope coefficient for LeakyReLU must be no less than 0.'
        self._slope = alpha
        super().__init__(prefix)

    def _reprarg(self):
        return self._slope

    def forward(self, x):
        return ops.leaky_relu(x, 'leaky', self._slope)


class PReLU(HybridBlock):
    """LeakyReLU whose slope is a learned (1,) parameter ``alpha``."""

    _unscoped_prefix = 'prelu_'

    def __init__(self, alpha_initializer=None, prefix=None, params=None,
                 device=None):
        from .basic_layers import _declare
        super().__init__(prefix, params)
        if alpha_initializer is None:
            alpha_initializer = _init.Constant(0.25)
        with self.name_scope():
            _declare(self, 'alpha', (1,), alpha_initializer, device)

    def forward(self, x):
        return ops.leaky_relu(x, 'prelu', gamma=self.alpha)


class ELU(_ActBlock):
    """``x`` above zero, ``alpha (exp(x) - 1)`` below."""

    _unscoped_prefix = 'elu_'

    def __init__(self, alpha=1.0, prefix=None):
        self._slope = alpha
        super().__init__(prefix)

    def forward(self, x):
        return ops.leaky_relu(x, 'elu', self._slope)


class SELU(_ActBlock):
    """The self-normalising ELU with the SNN paper's scale and alpha."""

    _unscoped_prefix = 'selu_'

    def forward(self, x):
        return ops.leaky_relu(x, 'selu')


class Swish(_ActBlock):
    """``x * sigmoid(beta x)``."""

    _unscoped_prefix = 'swish_'

    def __init__(self, beta=1.0, prefix=None):
        self._scale = beta
        super().__init__(prefix)

    def forward(self, x):
        return x * torch.sigmoid(x * self._scale)


class GELU(_ActBlock):
    """The Gaussian error linear unit, ``x Phi(x)`` (the exact erf
    form)."""

    _unscoped_prefix = 'gelu_'

    def forward(self, x):
        return ops.leaky_relu(x, 'gelu')
