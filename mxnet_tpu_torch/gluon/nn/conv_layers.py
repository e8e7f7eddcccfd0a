"""Convolution and pooling layers of the ResNet path, the counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py`` (``_Conv`` :48, ``Conv2D`` :164,
``MaxPool2D`` :255, ``GlobalAvgPool2D`` :326), NCHW only.

``Conv2D`` keeps the JAX weight layout (channels, in_channels // groups,
kh, kw) and names (``weight``, ``bias``). The JAX layer infers
``in_channels`` at the first call; the port allocates at construction and
needs it up front, as ``Dense`` needs ``in_units``.
"""
from __future__ import annotations

from ...context import resolve_device
from ...ops import nn as ops
from ..block import Block
from .basic_layers import _param

__all__ = ['Conv2D', 'MaxPool2D', 'GlobalAvgPool2D']


def _check_layout(layout):
    if layout != 'NCHW':
        raise NotImplementedError('the port has NCHW layers only, got %r'
                                  % (layout,))


class Conv2D(Block):
    """2-D convolution: ``conv(x, W) + b``."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout='NCHW', use_bias=True,
                 in_channels=0, prefix='conv_', device=None):
        super().__init__(prefix)
        _check_layout(layout)
        if in_channels <= 0:
            raise ValueError('Conv2D: the port allocates at construction '
                             'and needs in_channels > 0, got %r'
                             % (in_channels,))
        device = resolve_device(device)
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self._kwargs = dict(stride=strides, pad=padding, dilate=dilation,
                            num_group=groups)
        self.weight = _param((channels, in_channels // groups) + k, device)
        self.bias = _param((channels,), device, 0.0) if use_bias else None

    def forward(self, x):
        return ops.convolution(x, self.weight, self.bias, **self._kwargs)


class MaxPool2D(Block):
    """Max pooling over NCHW windows (``ceil_mode`` is not ported)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout='NCHW', ceil_mode=False, prefix='pool_'):
        super().__init__(prefix)
        _check_layout(layout)
        if ceil_mode:
            raise NotImplementedError('MaxPool2D: ceil_mode is not ported')
        self._kwargs = dict(kernel=pool_size,
                            stride=pool_size if strides is None else strides,
                            pad=padding)

    def forward(self, x):
        return ops.pooling(x, pool_type='max', **self._kwargs)


class GlobalAvgPool2D(Block):
    """Mean over each (H, W) plane; keeps the (N, C, 1, 1) shape."""

    def __init__(self, layout='NCHW', prefix='pool_'):
        super().__init__(prefix)
        _check_layout(layout)

    def forward(self, x):
        return ops.pooling(x, pool_type='avg', global_pool=True)
