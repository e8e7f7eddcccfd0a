"""Convolution, pooling and padding layers, the counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py`` (``_Conv`` :48-158, ``Conv1D`` -
``Conv3DTranspose`` :164-186, ``_Pooling`` :189-245, the pools :255-333,
``ReflectionPad2D`` :336), channels-first layouts only (NCW, NCHW,
NCDHW).

``_Conv`` keeps the JAX weight layouts -- (channels, in_channels //
groups, *kernel) for a convolution, (in_channels, channels // groups,
*kernel) for a transposed one -- names (``weight``, ``bias``) and
initializers (weight None, bias ``'zeros'``); ``in_channels=0`` defers the
shape to the first forward, as the JAX layer infers it. ``activation``
applies an ``Activation`` after the convolution, as there. The
transposed convolutions take ``output_padding`` (the op's ``adj``). The
pools take ``ceil_mode`` (the ``full`` convention) and, for average
pooling, ``count_include_pad``; a global pool reduces each plane.
"""
from __future__ import annotations

from ...ops import nn as ops
from ...ops import tensor as _tensor_ops
from ..block import HybridBlock
from .activations import Activation
from .basic_layers import _declare, _materialize

__all__ = ['Conv1D', 'Conv2D', 'Conv3D', 'Conv1DTranspose',
           'Conv2DTranspose', 'Conv3DTranspose', 'MaxPool1D', 'MaxPool2D',
           'MaxPool3D', 'AvgPool1D', 'AvgPool2D', 'AvgPool3D',
           'GlobalMaxPool1D', 'GlobalMaxPool2D', 'GlobalMaxPool3D',
           'GlobalAvgPool1D', 'GlobalAvgPool2D', 'GlobalAvgPool3D',
           'ReflectionPad2D']

# the channels-first layout of each spatial rank
_LAYOUTS = {1: 'NCW', 2: 'NCHW', 3: 'NCDHW'}


def _check_layout(layout, ndim):
    if layout != _LAYOUTS[ndim]:
        raise NotImplementedError('the port has channels-first layers only '
                                  '(%s), got %r' % (_LAYOUTS[ndim], layout))


def _ndtuple(value, n, what):
    """An int broadcast to an ``n``-tuple; an explicit tuple checked."""
    if isinstance(value, int):
        return (value,) * n
    t = tuple(int(v) for v in value)
    if len(t) != n:
        raise AssertionError('%s must be a number or a list of %d ints'
                             % (what, n))
    return t


class _Conv(HybridBlock):
    """A convolution (``transpose`` False) or transposed convolution of
    ``len(kernel_size)`` spatial axes: ``act(op(x, W) + b)``."""

    _unscoped_prefix = 'conv_'

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer='zeros',
                 transpose=False, output_padding=0, prefix=None, params=None,
                 device=None):
        super().__init__(prefix, params)
        ndim = len(kernel_size)
        self._channels, self._groups = channels, groups
        self._kernel, self._transpose = tuple(kernel_size), transpose
        self._kwargs = dict(stride=_ndtuple(strides, ndim, 'strides'),
                            pad=_ndtuple(padding, ndim, 'padding'),
                            dilate=_ndtuple(dilation, ndim, 'dilation'),
                            num_group=groups)
        if transpose:
            self._kwargs['adj'] = self.outpad = self.out_pad = _ndtuple(
                output_padding, ndim, 'output_padding')
        with self.name_scope():
            _declare(self, 'weight', self._weight_shape(in_channels),
                     weight_initializer, device)
            if use_bias:
                _declare(self, 'bias', (channels,), bias_initializer,
                         device)
            else:
                self.bias = None
            self.act = None if activation is None else \
                Activation(activation, prefix=activation + '_')

    def _weight_shape(self, in_channels):
        g = self._groups
        if self._transpose:
            return (in_channels, self._channels // g) + self._kernel
        return (self._channels, in_channels // g) + self._kernel

    def _alias(self):
        return 'conv'

    def forward(self, x):
        if self.weight is None:
            _materialize(self, x, {'weight': self._weight_shape(
                int(x.shape[1]))})
        op = ops.deconvolution if self._transpose else ops.convolution
        out = op(x, self.weight, self.bias, **self._kwargs)
        return out if self.act is None else self.act(out)


def _conv(ndim, transpose):
    if transpose:
        def __init__(self, channels, kernel_size, strides=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     layout=_LAYOUTS[ndim], activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer='zeros',
                     in_channels=0, prefix=None, params=None, device=None):
            _check_layout(layout, ndim)
            _Conv.__init__(self, channels,
                           _ndtuple(kernel_size, ndim, 'kernel_size'),
                           strides, padding, dilation, groups, in_channels,
                           activation, use_bias, weight_initializer,
                           bias_initializer, True, output_padding, prefix,
                           params, device)
    else:
        def __init__(self, channels, kernel_size, strides=1, padding=0,
                     dilation=1, groups=1, layout=_LAYOUTS[ndim],
                     activation=None, use_bias=True, weight_initializer=None,
                     bias_initializer='zeros', in_channels=0, prefix=None,
                     params=None, device=None):
            _check_layout(layout, ndim)
            _Conv.__init__(self, channels,
                           _ndtuple(kernel_size, ndim, 'kernel_size'),
                           strides, padding, dilation, groups, in_channels,
                           activation, use_bias, weight_initializer,
                           bias_initializer, False, 0, prefix, params,
                           device)
    return __init__


class Conv1D(_Conv):
    """1-D convolution over NCW."""
    __init__ = _conv(1, False)


class Conv2D(_Conv):
    """2-D convolution over NCHW."""
    __init__ = _conv(2, False)


class Conv3D(_Conv):
    """3-D convolution over NCDHW."""
    __init__ = _conv(3, False)


class Conv1DTranspose(_Conv):
    """1-D transposed convolution over NCW."""
    __init__ = _conv(1, True)


class Conv2DTranspose(_Conv):
    """2-D transposed convolution over NCHW."""
    __init__ = _conv(2, True)


class Conv3DTranspose(_Conv):
    """3-D transposed convolution over NCDHW."""
    __init__ = _conv(3, True)


class _Pooling(HybridBlock):
    """Pooling of ``len(pool_size)`` spatial axes (``ops.nn.pooling``)."""

    _unscoped_prefix = 'pool_'

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, prefix=None):
        super().__init__(prefix)
        ndim = len(pool_size)
        _check_layout(layout, ndim)
        self._kwargs = dict(
            kernel=tuple(pool_size),
            stride=tuple(pool_size) if strides is None
            else _ndtuple(strides, ndim, 'strides'),
            pad=_ndtuple(padding, ndim, 'padding'), global_pool=global_pool,
            pool_type=pool_type,
            pooling_convention='full' if ceil_mode else 'valid')
        if count_include_pad is not None:
            self._kwargs['count_include_pad'] = count_include_pad

    def _alias(self):
        return 'pool'

    def forward(self, x):
        return ops.pooling(x, **self._kwargs)


def _pool(ndim, pool_type, ceil_first):
    """A pool's ``__init__`` with the reference's positional order: 3-D max
    and 2-D / 3-D average pooling take ``ceil_mode`` before ``layout``;
    only average pooling takes ``count_include_pad``."""
    default = (2,) * ndim if ndim > 1 else 2

    def init(self, pool_size, strides, padding, ceil_mode, layout,
             count_include_pad, prefix):
        if pool_type != 'avg' and count_include_pad is not None:
            raise TypeError('count_include_pad is only valid for average '
                            'pooling')
        _Pooling.__init__(self, _ndtuple(pool_size, ndim, 'pool_size'),
                          strides, padding, ceil_mode, False, pool_type,
                          layout, count_include_pad, prefix)
    if pool_type == 'avg' and ceil_first:
        def __init__(self, pool_size=default, strides=None, padding=0,
                     ceil_mode=False, layout=_LAYOUTS[ndim],
                     count_include_pad=True, prefix=None):
            init(self, pool_size, strides, padding, ceil_mode, layout,
                 count_include_pad, prefix)
    elif pool_type == 'avg':
        def __init__(self, pool_size=default, strides=None, padding=0,
                     layout=_LAYOUTS[ndim], ceil_mode=False,
                     count_include_pad=True, prefix=None):
            init(self, pool_size, strides, padding, ceil_mode, layout,
                 count_include_pad, prefix)
    elif ceil_first:
        def __init__(self, pool_size=default, strides=None, padding=0,
                     ceil_mode=False, layout=_LAYOUTS[ndim], prefix=None):
            init(self, pool_size, strides, padding, ceil_mode, layout, None,
                 prefix)
    else:
        def __init__(self, pool_size=default, strides=None, padding=0,
                     layout=_LAYOUTS[ndim], ceil_mode=False, prefix=None):
            init(self, pool_size, strides, padding, ceil_mode, layout, None,
                 prefix)
    return __init__


def _global_pool(ndim, pool_type):
    def __init__(self, layout=_LAYOUTS[ndim], prefix=None):
        _Pooling.__init__(self, (1,) * ndim, None, 0, True, True, pool_type,
                          layout, prefix=prefix)
    return __init__


class MaxPool1D(_Pooling):
    """Max pooling over NCW."""
    __init__ = _pool(1, 'max', False)


class MaxPool2D(_Pooling):
    """Max pooling over NCHW."""
    __init__ = _pool(2, 'max', False)


class MaxPool3D(_Pooling):
    """Max pooling over NCDHW."""
    __init__ = _pool(3, 'max', True)


class AvgPool1D(_Pooling):
    """Average pooling over NCW."""
    __init__ = _pool(1, 'avg', False)


class AvgPool2D(_Pooling):
    """Average pooling over NCHW."""
    __init__ = _pool(2, 'avg', True)


class AvgPool3D(_Pooling):
    """Average pooling over NCDHW."""
    __init__ = _pool(3, 'avg', True)


class GlobalMaxPool1D(_Pooling):
    """The max of each NCW plane; keeps the (N, C, 1) shape."""
    __init__ = _global_pool(1, 'max')


class GlobalMaxPool2D(_Pooling):
    """The max of each (H, W) plane; keeps the (N, C, 1, 1) shape."""
    __init__ = _global_pool(2, 'max')


class GlobalMaxPool3D(_Pooling):
    """The max of each (D, H, W) volume."""
    __init__ = _global_pool(3, 'max')


class GlobalAvgPool1D(_Pooling):
    """The mean of each NCW plane."""
    __init__ = _global_pool(1, 'avg')


class GlobalAvgPool2D(_Pooling):
    """The mean of each (H, W) plane; keeps the (N, C, 1, 1) shape."""
    __init__ = _global_pool(2, 'avg')


class GlobalAvgPool3D(_Pooling):
    """The mean of each (D, H, W) volume."""
    __init__ = _global_pool(3, 'avg')


class ReflectionPad2D(HybridBlock):
    """Reflection padding of an NCHW tensor: ``padding`` an int (each side
    of H and W) or the op's 8-tuple ``pad_width``."""

    _unscoped_prefix = 'reflectionpad2d_'

    def __init__(self, padding=0, prefix=None):
        super().__init__(prefix)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0) + (padding,) * 4
        if len(padding) != 8:
            raise AssertionError('padding must be an int or an 8-tuple')
        self._padding = tuple(padding)

    def forward(self, x):
        return _tensor_ops.pad(x, mode='reflect', pad_width=self._padding)
