"""Convolution and pooling layers, the counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py`` (``_Conv`` :48, ``Conv2D`` :164,
``MaxPool2D`` :255, ``GlobalAvgPool2D`` :326), NCHW only.

``Conv2D`` keeps the JAX weight layout (channels, in_channels // groups,
kh, kw), names (``weight``, ``bias``) and initializers (weight None, bias
``'zeros'``); ``in_channels=0`` defers the shape to the first forward, as
the JAX layer infers it. ``activation`` applies an ``Activation`` after
the convolution, as there.
"""
from __future__ import annotations

from ...ops import nn as ops
from ..block import HybridBlock
from .basic_layers import Activation, _declare, _materialize

__all__ = ['Conv2D', 'MaxPool2D', 'GlobalAvgPool2D']


def _check_layout(layout):
    if layout != 'NCHW':
        raise NotImplementedError('the port has NCHW layers only, got %r'
                                  % (layout,))


class Conv2D(HybridBlock):
    """2-D convolution: ``act(conv(x, W) + b)``."""

    _unscoped_prefix = 'conv_'

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout='NCHW', activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', in_channels=0, prefix=None,
                 params=None, device=None):
        super().__init__(prefix, params)
        _check_layout(layout)
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self._channels, self._groups, self._kernel = channels, groups, k
        self._kwargs = dict(stride=strides, pad=padding, dilate=dilation,
                            num_group=groups)
        with self.name_scope():
            _declare(self, 'weight', (channels, in_channels // groups) + k,
                     weight_initializer, device)
            if use_bias:
                _declare(self, 'bias', (channels,), bias_initializer,
                         device)
            else:
                self.bias = None
            self.act = None if activation is None else \
                Activation(activation, prefix=activation + '_')

    def _alias(self):
        return 'conv'

    def forward(self, x):
        if self.weight is None:
            _materialize(self, x, {'weight': (
                self._channels, int(x.shape[1]) // self._groups)
                + self._kernel})
        out = ops.convolution(x, self.weight, self.bias, **self._kwargs)
        return out if self.act is None else self.act(out)


class MaxPool2D(HybridBlock):
    """Max pooling over NCHW windows (``ceil_mode`` is not ported)."""

    _unscoped_prefix = 'pool_'

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout='NCHW', ceil_mode=False, prefix=None):
        super().__init__(prefix)
        _check_layout(layout)
        if ceil_mode:
            raise NotImplementedError('MaxPool2D: ceil_mode is not ported')
        self._kwargs = dict(kernel=pool_size,
                            stride=pool_size if strides is None else strides,
                            pad=padding)

    def _alias(self):
        return 'pool'

    def forward(self, x):
        return ops.pooling(x, pool_type='max', **self._kwargs)


class GlobalAvgPool2D(HybridBlock):
    """Mean over each (H, W) plane; keeps the (N, C, 1, 1) shape."""

    _unscoped_prefix = 'pool_'

    def __init__(self, layout='NCHW', prefix=None):
        super().__init__(prefix)
        _check_layout(layout)

    def _alias(self):
        return 'pool'

    def forward(self, x):
        return ops.pooling(x, pool_type='avg', global_pool=True)
