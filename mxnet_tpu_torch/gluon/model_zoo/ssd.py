"""SSD single-shot detector, the counterpart of
``mxnet_tpu/gluon/model_zoo/ssd.py`` (``_conv_block`` :21, ``_Act`` :33,
``SSD`` :38, ``MultiBoxDetection`` :126, ``ssd_300`` :134).

One block computes, for every scale, the anchors
(:func:`~mxnet_tpu_torch.ops.contrib.multibox_prior`), the class head and
the box head, and returns them concatenated over the scales:

  * anchors   (1, N, 4)
  * cls_preds (B, N, num_classes + 1)
  * box_preds (B, N * 4)

The backbone is the JAX model's simple BN-conv one: per stage two 3x3
convs without bias, each followed by an inference-mode BatchNorm (one
``bn_act_fwd`` kernel launch each) and a plain relu, then a 2x2 max pool.
``ssd_300`` has 14 such BatchNorms and 5 scales; at 300 x 300 px its
feature maps are 37, 18, 9, 4 and 2 pixels wide, 7378 anchors.

The blocks and parameter names are the JAX model's, so
:func:`params_from_jax` carries a JAX net's weights over one to one
(``base_hybridsequential0_conv0_weight``,
``hybridsequential3_batchnorm1_running_var``, ``cls4_bias``), in the JAX
net's order. ``in_channels`` (the image's, 3) is given up front: the port
allocates at construction. :func:`init_params` is the ResNet zoo's
(Xavier, uniform, avg, magnitude 3, from a numpy seed; biases and beta 0,
gamma 1, moving statistics 0 / 1). ``MultiBoxTarget`` (training) is not
ported yet.
"""
from __future__ import annotations

import torch

from ...context import resolve_device
from ...ops import contrib
from ...ops import nn as ops
from ..block import Block, params_from_jax
from ..nn import BatchNorm, Conv2D, HybridSequential, MaxPool2D
from .resnet import _Names, init_params
from .stamp import zoo_constructor

__all__ = ['SSD', 'ssd_300', 'MultiBoxDetection', 'SSDDetector',
           'ssd_detector', 'init_params', 'params_from_jax']


class _Act(Block):
    """The JAX model's relu block (``F.relu``, no kernel)."""

    def forward(self, x):
        return ops.relu(x)


def _conv_block(channels, in_channels, prefix, device, num=2):
    """``num`` x (3x3 conv, BatchNorm, relu), then a 2x2 max pool."""
    blk = HybridSequential(prefix=prefix)
    names = _Names()
    cin = in_channels
    for _ in range(num):
        blk.add(Conv2D(channels, 3, padding=1, use_bias=False,
                       in_channels=cin, prefix=names('conv'), device=device),
                BatchNorm(in_channels=channels, prefix=names('batchnorm'),
                          device=device),
                _Act())
        cin = channels
    blk.add(MaxPool2D(2, 2))
    return blk


class SSD(Block):
    """Single-shot detector over a simple BN-conv backbone: per scale a
    3x3 class head (A * (num_classes + 1) channels), a 3x3 box head (A *
    4) and the scale's anchors, A = len(sizes) + len(ratios) - 1."""

    def __init__(self, num_classes, sizes, ratios, base_channels=(16, 32,
                 64), scale_channels=(128, 128, 128), in_channels=3,
                 prefix='', device=None):
        super().__init__(prefix)
        if len(sizes) != len(ratios):
            raise ValueError('SSD: %d sizes but %d ratios (one of each per '
                             'scale)' % (len(sizes), len(ratios)))
        device = resolve_device(device)
        self.num_classes = num_classes
        self._sizes = [tuple(s) for s in sizes]
        self._ratios = [tuple(r) for r in ratios]
        self.base = HybridSequential(prefix='base_')
        base_names = _Names()
        cin = in_channels
        for ch in base_channels:
            self.base.add(_conv_block(ch, cin, base_names('hybridsequential'),
                                      device))
            cin = ch
        # registration order, and so the order of collect_params, is the
        # JAX model's: the base, then per scale its stage, class and box
        # head
        names = _Names()
        self.stages, self.cls_heads, self.box_heads = [], [], []
        for i in range(len(sizes)):
            if i > 0:
                ch = scale_channels[min(i - 1, len(scale_channels) - 1)]
                stage = _conv_block(ch, cin, names('hybridsequential'),
                                    device)
                self.add_module('stage%d' % i, stage)
                self.stages.append(stage)
                cin = ch
            na = len(self._sizes[i]) + len(self._ratios[i]) - 1
            cls = Conv2D(na * (num_classes + 1), 3, padding=1,
                         in_channels=cin, prefix='cls%d_' % i, device=device)
            box = Conv2D(na * 4, 3, padding=1, in_channels=cin,
                         prefix='box%d_' % i, device=device)
            self.add_module('cls_head%d' % i, cls)
            self.add_module('box_head%d' % i, box)
            self.cls_heads.append(cls)
            self.box_heads.append(box)

    def forward(self, x):
        feats = self.base(x)
        anchors, cls_preds, box_preds = [], [], []
        for i, (cls, box) in enumerate(zip(self.cls_heads, self.box_heads)):
            if i > 0:
                feats = self.stages[i - 1](feats)
            anchors.append(contrib.multibox_prior(
                feats, sizes=self._sizes[i], ratios=self._ratios[i],
                clip=True))
            c = cls(feats)     # (B, A * (C + 1), H, W)
            b = box(feats)     # (B, A * 4, H, W)
            # (B, ch, H, W) -> (B, H * W * A, per anchor): row-major over
            # the map, anchor minor, MultiBoxPrior's order
            cls_preds.append(c.permute(0, 2, 3, 1).reshape(
                c.shape[0], -1, self.num_classes + 1))
            box_preds.append(b.permute(0, 2, 3, 1).reshape(b.shape[0], -1))
        return (torch.cat(anchors, dim=1), torch.cat(cls_preds, dim=1),
                torch.cat(box_preds, dim=1))


class MultiBoxDetection(Block):
    """Inference head: softmax over the classes, then
    :func:`~mxnet_tpu_torch.ops.contrib.multibox_detection` (class-aware
    NMS through the ``nms`` kernel) -> (B, N, 6) rows ``[id, score, x1,
    y1, x2, y2]``, -1 where suppressed."""

    def __init__(self, nms_threshold=0.45, threshold=0.01, nms_topk=400,
                 variances=(0.1, 0.1, 0.2, 0.2), prefix=''):
        super().__init__(prefix)
        self._kw = dict(nms_threshold=nms_threshold, threshold=threshold,
                        nms_topk=nms_topk, variances=tuple(variances))

    def forward(self, anchors, cls_preds, box_preds):
        probs = ops.softmax(cls_preds, axis=-1).transpose(1, 2)
        return contrib.multibox_detection(probs, box_preds, anchors,
                                          **self._kw)


@zoo_constructor
def ssd_300(num_classes=20, **kwargs):
    """SSD-300's anchor configuration (``example/ssd/symbol_factory.py``
    ``get_config('vgg16_reduced', 300)``): five scales with the standard
    size ladder. ``device`` None means ``cuda``; the weights are
    allocated, not set (:func:`init_params`, :func:`params_from_jax`)."""
    sizes = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79)]
    ratios = [(1.0, 2.0, 0.5)] * 2 + [(1.0, 2.0, 0.5, 3.0, 1.0 / 3)] * 3
    return SSD(num_classes, sizes, ratios, **kwargs)


class SSDDetector(Block):
    """An SSD and its :class:`MultiBoxDetection` as one block, the block
    detection serving freezes: images (B, 3, H, W) in, detections (B, N,
    6) out. Its parameters are the SSD's, under the SSD's names."""

    def __init__(self, net, **kwargs):
        super().__init__()
        self.net = net
        self.det = MultiBoxDetection(**kwargs)

    def forward(self, x):
        return self.det(*self.net(x))


@zoo_constructor
def ssd_detector(net, nms_threshold=0.45, threshold=0.01, nms_topk=400,
                 variances=(0.1, 0.1, 0.2, 0.2), device=None):
    """:class:`SSDDetector` over ``net`` (a zoo SSD such as
    :func:`ssd_300`'s, which it keeps, weights and all). ``device`` is
    ``net``'s: the detection head holds no parameters."""
    del device
    return SSDDetector(net, nms_threshold=nms_threshold,
                       threshold=threshold, nms_topk=nms_topk,
                       variances=variances)
