"""ResNet v1 (post-activation), depths 18-152, the counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` (``_ResidualCell`` :24,
``ResNetV1`` :166, ``resnet_spec`` :176, ``get_resnet`` :185).

The blocks and parameter names are the JAX model's, so
:func:`params_from_jax` carries a JAX net's weights (moving statistics
included) over one to one. The JAX names carry per-scope counters
(``resnetv10_conv0_weight``, ``resnetv10_stage1_conv3_weight``,
``resnetv10_stage1_batchnorm0_running_var``, ``resnetv10_dense0_bias``):
the stem and the classifier count in the model's scope, each stage counts
its convs and BatchNorms in its own, in construction order (a cell's body
before its downsample branch). The port builds the same prefixes with
:class:`_Names`.

What the v1 cell is (``resnet.py:39-78``): conv -> BN (-> relu) for each
step of the plan, then ``relu(body + shortcut)`` through the add+act
kernel. The bottleneck's stride sits on its first 1x1 conv, and both of
its 1x1 convs carry biases (checkpoint parity with the reference). The
v2 (pre-activation) nets are not ported yet (ROADMAP: "the rest of
training").

Weights: ``net.initialize(mx.init.Xavier())`` fills a net as the
bench does (the BatchNorm constants are set when the layers are made);
:func:`init_params` fills it from a numpy seed with the bench's
initializer, Xavier (uniform, avg, magnitude 3); BatchNorm gamma and the
running variance are 1, beta, biases and the running mean 0.
"""
from __future__ import annotations

import numpy as onp
import torch

from ...context import resolve_device
from ...ops import nn as ops
from ..block import Block, params_from_jax
from ..nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                  HybridSequential, MaxPool2D)
from .stamp import zoo_constructor

__all__ = ['ResNetV1', 'BasicBlockV1', 'BottleneckV1', 'resnet_spec',
           'get_resnet', 'resnet18_v1', 'resnet34_v1', 'resnet50_v1',
           'resnet101_v1', 'resnet152_v1', 'init_params', 'params_from_jax']


class _Names:
    """Gluon's per-scope name counters: ``_Names()('conv')`` gives
    ``conv0_``, then ``conv1_``, ..."""

    def __init__(self):
        self._next = {}

    def __call__(self, kind):
        n = self._next.get(kind, 0)
        self._next[kind] = n + 1
        return '%s%d_' % (kind, n)


class _ResidualCell(Block):
    """One v1 residual unit: two 3x3 convs (basic) or 1x1 -> 3x3 -> 1x1
    with ``channels // 4`` inside (bottleneck), each followed by a
    BatchNorm and all but the last by a relu; the shortcut is the input
    or a strided 1x1 conv + BatchNorm when ``downsample``. ``names`` is
    the enclosing stage's counter."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 bottleneck=False, names=None, device=None):
        super().__init__('')
        names = _Names() if names is None else names
        inner = channels // 4 if bottleneck else channels
        # (out_channels, kernel, stride, pad, use_bias)
        if bottleneck:
            plan = [(inner, 1, stride, 0, True), (inner, 3, 1, 1, False),
                    (channels, 1, 1, 0, True)]
        else:
            plan = [(inner, 3, stride, 1, False), (channels, 3, 1, 1, False)]
        self.body = HybridSequential()
        cin = in_channels
        for j, (ch, k, s, p, bias) in enumerate(plan):
            self.body.add(
                Conv2D(ch, k, s, p, use_bias=bias, in_channels=cin,
                       prefix=names('conv'), device=device),
                BatchNorm(in_channels=ch, prefix=names('batchnorm'),
                          device=device))
            if j + 1 < len(plan):
                self.body.add(Activation('relu'))
            cin = ch
        self.downsample = None
        if downsample:
            self.downsample = HybridSequential()
            self.downsample.add(
                Conv2D(channels, 1, stride, use_bias=False,
                       in_channels=in_channels, prefix=names('conv'),
                       device=device),
                BatchNorm(in_channels=channels, prefix=names('batchnorm'),
                          device=device))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return ops.add_relu(self.body(x), residual)


class BasicBlockV1(_ResidualCell):
    """Two 3x3 convs (ResNet-18/34)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, downsample, in_channels,
                         bottleneck=False, **kwargs)


class BottleneckV1(_ResidualCell):
    """1x1 -> 3x3 -> 1x1 with the stride on the first 1x1 (ResNet-50 and
    deeper)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, downsample, in_channels,
                         bottleneck=True, **kwargs)


class ResNetV1(Block):
    """Stem (7x7/2 conv, BN, relu, 3x3/2 max pool; a 3x3/1 conv when
    ``thumbnail``), the residual stages, a global average pool and the
    classifier. ``in_channels`` is the image's (3); the JAX net infers
    it from the first batch."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, in_channels=3, prefix='', device=None):
        super().__init__(prefix)
        if len(layers) != len(channels) - 1:
            raise ValueError('ResNetV1: %d stages need %d channel widths, '
                             'got %d' % (len(layers), len(layers) + 1,
                                         len(channels)))
        device = resolve_device(device)
        names = _Names()
        f = HybridSequential()
        if thumbnail:
            f.add(Conv2D(channels[0], 3, 1, 1, use_bias=False,
                         in_channels=in_channels, prefix=names('conv'),
                         device=device))
        else:
            f.add(Conv2D(channels[0], 7, 2, 3, use_bias=False,
                         in_channels=in_channels, prefix=names('conv'),
                         device=device),
                  BatchNorm(in_channels=channels[0],
                            prefix=names('batchnorm'), device=device),
                  Activation('relu'), MaxPool2D(3, 2, 1))
        in_ch = channels[0]
        for i, n in enumerate(layers):
            stage = HybridSequential(prefix='stage%d_' % (i + 1))
            stage_names = _Names()
            out_ch = channels[i + 1]
            stage.add(block(out_ch, 1 if i == 0 else 2, out_ch != in_ch,
                            in_channels=in_ch, names=stage_names,
                            device=device))
            for _ in range(n - 1):
                stage.add(block(out_ch, 1, False, in_channels=out_ch,
                                names=stage_names, device=device))
            f.add(stage)
            in_ch = out_ch
        f.add(GlobalAvgPool2D())
        self.features = f
        self.output = Dense(classes, in_units=channels[-1],
                            prefix=names('dense'), device=device)

    def forward(self, x):
        return self.output(self.features(x))


# depth -> (bottleneck?, per-stage cell counts, stage channels)
resnet_spec = {
    18: (False, [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: (False, [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: (True, [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: (True, [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: (True, [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


@zoo_constructor
def get_resnet(version, num_layers, pretrained=False, device=None,
               **kwargs):
    """A ResNet v1 of ``num_layers`` (18, 34, 50, 101 or 152). The weights
    are allocated, not set: fill them with :func:`init_params` or
    :func:`params_from_jax`. ``device`` None means ``cuda``."""
    if num_layers not in resnet_spec:
        raise ValueError('Invalid number of layers: %d. Options are %s'
                         % (num_layers, sorted(resnet_spec)))
    if version != 1:
        raise NotImplementedError('ResNet v%s is not ported yet (ROADMAP: '
                                  '"the rest of training"); the port '
                                  'has v1' % (version,))
    if pretrained:
        raise NotImplementedError('the port has no model store: fill the '
                                  'weights with init_params or '
                                  'params_from_jax')
    bottleneck, layers, channels = resnet_spec[num_layers]
    block = BottleneckV1 if bottleneck else BasicBlockV1
    return ResNetV1(block, layers, channels, device=device, **kwargs)


def _variant(depth):
    def build(**kwargs):
        return get_resnet(1, depth, **kwargs)
    build.__name__ = 'resnet%d_v1' % depth
    build.__doc__ = 'ResNet-%d v1 model.' % depth
    return zoo_constructor(build)


resnet18_v1 = _variant(18)
resnet34_v1 = _variant(34)
resnet50_v1 = _variant(50)
resnet101_v1 = _variant(101)
resnet152_v1 = _variant(152)


def _xavier_scale(shape, magnitude=3.0):
    """The bound of Xavier's uniform draw with factor 'avg'
    (``Xavier._init_weight``, initializer.py:252-276)."""
    receptive = float(onp.prod(shape[2:])) if len(shape) > 2 else 1.0
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return float(onp.sqrt(magnitude / ((fan_in + fan_out) / 2.0)))


@torch.no_grad()
def init_params(net, seed=0):
    """Fill every parameter of ``net`` from a numpy seed: weights
    uniform in +-sqrt(3 / ((fan_in + fan_out) / 2)), BatchNorm gamma and
    running variance 1, beta, biases and running mean 0. Parameters are
    drawn in sorted name order, so the values do not depend on the device
    or on the order of construction. Returns ``net``."""
    rng = onp.random.default_rng(seed)
    params = net.collect_params().tensors()
    for name in sorted(params):
        p = params[name]
        if name.endswith(('gamma', 'running_var')):
            p.fill_(1.0)
        elif name.endswith(('beta', 'bias', 'running_mean')):
            p.zero_()
        else:
            bound = _xavier_scale(tuple(p.shape))
            w = rng.uniform(-bound, bound, tuple(p.shape)).astype(onp.float32)
            p.copy_(torch.from_numpy(w))
    for p in net.collect_params().values():
        p._initialized = True
    return net
