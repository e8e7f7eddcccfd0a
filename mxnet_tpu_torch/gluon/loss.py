"""Losses of the port, the counterpart of ``mxnet_tpu/gluon/loss.py``:
the same classes, constructor signatures and expressions, each an
elementwise cost handed to ``Loss._reduce`` (sample weights, the scalar
weight, the mean over every axis but the batch axis).

``SoftmaxCrossEntropyLoss``'s sparse-label, from-logits=False case over
the last axis runs the fused softmax-xent kernels (the branch
``MXNET_TPU_PALLAS=xent`` selects in the JAX loss); its other cases are
the JAX loss's log-softmax spelling. The logit losses' ``softplus`` is
the ``softrelu`` activation, an act kernel on a card, as the JAX losses
reach it through ``Activation``. ``CTCLoss`` is ``F.ctc_loss`` over the
log-softmax, the blank the last class, as the JAX op's optax call.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..amp import cast_op_inputs as _amp
from ..ops import nn as ops
from .block import HybridBlock

__all__ = ['Loss', 'L2Loss', 'L1Loss', 'SigmoidBinaryCrossEntropyLoss',
           'SigmoidBCELoss', 'SoftmaxCrossEntropyLoss', 'SoftmaxCELoss',
           'KLDivLoss', 'CTCLoss', 'HuberLoss', 'HingeLoss',
           'SquaredHingeLoss', 'LogisticLoss', 'TripletLoss',
           'PoissonNLLLoss', 'CosineEmbeddingLoss']


def _softplus(x):
    """log(1 + exp(x)), the logit losses' building block."""
    return ops.activation(x, 'softrelu')


def _match_shape(arr, like):
    """``arr`` viewed with ``like``'s shape ((B,) and (B, 1) labels
    alike)."""
    return arr.reshape(like.shape)


class Loss(HybridBlock):
    """Common base: holds the scalar weight and batch axis, owns the
    weighting + reduction pipeline."""

    def __init__(self, weight, batch_axis, prefix=None):
        super().__init__(prefix)
        self._weight, self._batch_axis = weight, batch_axis

    def __repr__(self):
        return '%s(batch_axis=%s, w=%s)' % (
            type(self).__name__, self._batch_axis, self._weight)

    def _reduce(self, cost, sample_weight=None, scale=None, mean=True):
        """sample_weight * cost, times the scalar weight (``scale``
        overrides it), then the mean over every axis but the batch
        axis."""
        if sample_weight is not None:
            cost = cost * sample_weight
        w = self._weight if scale is None else scale
        if w is not None:
            if not isinstance(w, (int, float)):
                raise TypeError('loss weight must be a number')
            cost = cost * w
        if not mean:
            return cost
        axes = [a for a in range(cost.dim())
                if a != self._batch_axis % cost.dim()]
        return torch.mean(cost, dim=axes) if axes else cost


class L2Loss(Loss):
    """1/2 |pred - label|^2, the per-sample mean."""

    def __init__(self, weight=1., batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix)

    def forward(self, pred, label, sample_weight=None):
        err = pred - _match_shape(label, pred)
        half = (1. if self._weight is None else self._weight) / 2
        return self._reduce(torch.square(err), sample_weight, scale=half)


class L1Loss(Loss):
    """|pred - label|, the per-sample mean."""

    def __init__(self, weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix)

    def forward(self, pred, label, sample_weight=None):
        err = pred - _match_shape(label, pred)
        return self._reduce(torch.abs(err), sample_weight)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE over logits (the default: ``relu(z) - z y + softplus(-|z|)``)
    or probabilities; ``pos_weight`` rescales the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 prefix=None):
        super().__init__(weight, batch_axis, prefix)
        self._from_sigmoid = from_sigmoid

    @staticmethod
    def _logit_bce(z, y, pos_weight):
        stable_sp = _softplus(-torch.abs(z))
        if pos_weight is None:
            return torch.relu(z) - z * y + stable_sp
        lw = 1 + (pos_weight - 1) * y
        return z - z * y + lw * (stable_sp + torch.relu(-z))

    @staticmethod
    def _prob_bce(p, y, pos_weight):
        tiny = 1e-12
        pos = torch.log(p + tiny) * y
        neg = torch.log(1. - p + tiny) * (1. - y)
        if pos_weight is not None:
            pos = pos * pos_weight
        return -(pos + neg)

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _match_shape(label, pred)
        kernel = self._prob_bce if self._from_sigmoid else self._logit_bce
        return self._reduce(kernel(pred, label, pos_weight), sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy after an (optional) internal log-softmax.
    ``sparse_label`` picks the target class's log-probability; dense
    labels dot against the full distribution."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix)
        self._axis, self._sparse_label, self._from_logits = (
            axis, sparse_label, from_logits)

    def forward(self, pred, label, sample_weight=None):
        if self._sparse_label and not self._from_logits \
                and self._axis in (-1, None):
            nll = ops.fused_softmax_xent(pred, label)
            return self._reduce(nll, sample_weight)
        if not self._from_logits:
            pred, = _amp('log_softmax', pred)     # a keep-fp32 op under AMP
        logp = pred if self._from_logits \
            else torch.log_softmax(pred, dim=self._axis)
        if self._sparse_label:
            idx = label.to(torch.int64).reshape(
                logp.shape[:self._axis % logp.dim()] + (1,)
                + logp.shape[self._axis % logp.dim() + 1:])
            nll = -torch.gather(logp, self._axis, idx)
        else:
            nll = -torch.sum(logp * label.reshape(logp.shape),
                             dim=self._axis, keepdim=True)
        return self._reduce(nll, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """sum label * (log label - log pred)."""

    def __init__(self, from_logits=True, axis=-1, weight=None,
                 batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix)
        self._from_logits, self._axis = from_logits, axis

    def forward(self, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else ops.log_softmax(pred, axis=self._axis)
        div = label * (torch.log(label + 1e-12) - logp)
        return self._reduce(div, sample_weight)


class CTCLoss(Loss):
    """Connectionist Temporal Classification over NTC or TNC activations
    and NT or TN labels (padded with 0 when no lengths are given); the
    blank is the last class."""

    def __init__(self, layout='NTC', label_layout='NT', weight=None,
                 prefix=None):
        if layout not in ('NTC', 'TNC'):
            raise AssertionError(
                'Only layouts NTC and TNC are supported, got %s' % layout)
        if label_layout not in ('NT', 'TN'):
            raise AssertionError(
                'Only label layouts NT and TN are supported, got %s'
                % label_layout)
        self._layout, self._label_layout = layout, label_layout
        super().__init__(weight, label_layout.index('N'), prefix)

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == 'NTC':
            pred = pred.transpose(0, 1)
        if self._label_layout == 'TN':
            label = label.transpose(0, 1)
        t, b, _ = pred.shape
        lab = label.to(torch.int64)
        data_len = torch.full((b,), t, dtype=torch.int64) \
            if pred_lengths is None else pred_lengths.to(torch.int64)
        label_len = torch.sum(lab != 0, dim=-1) if label_lengths is None \
            else label_lengths.to(torch.int64)
        logp = torch.log_softmax(pred.float(), dim=-1)
        nll = F.ctc_loss(logp, lab, data_len.cpu(), label_len.cpu(),
                         blank=pred.shape[-1] - 1, reduction='none',
                         zero_infinity=False).to(pred.dtype)
        return self._reduce(nll, sample_weight, mean=False)


class HuberLoss(Loss):
    """Quadratic inside +-rho, linear outside."""

    def __init__(self, rho=1, weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        r = torch.abs(pred - _match_shape(label, pred))
        quad = torch.square(r) * (0.5 / self._rho)
        lin = r - 0.5 * self._rho
        return self._reduce(torch.where(r > self._rho, lin, quad),
                            sample_weight)


class HingeLoss(Loss):
    """relu(margin - pred * label), labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        gap = self._margin - pred * _match_shape(label, pred)
        return self._reduce(torch.relu(gap), sample_weight)


class SquaredHingeLoss(Loss):
    """relu(margin - pred * label)^2."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        gap = self._margin - pred * _match_shape(label, pred)
        return self._reduce(torch.square(torch.relu(gap)), sample_weight)


class LogisticLoss(Loss):
    """log(1 + exp(-pred * label)) in the stable BCE form; ``signed``
    labels in {-1, 1}, ``binary`` in {0, 1}."""

    def __init__(self, weight=None, batch_axis=0, label_format='signed',
                 prefix=None):
        super().__init__(weight, batch_axis, prefix)
        if label_format not in ('signed', 'binary'):
            raise ValueError('label_format can only be signed or binary, '
                             'recieved %s.' % label_format)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        y = _match_shape(label, pred)
        if self._label_format == 'signed':
            y = (y + 1.0) / 2.0
        cost = torch.relu(pred) - pred * y + _softplus(-torch.abs(pred))
        return self._reduce(cost, sample_weight)


class TripletLoss(Loss):
    """relu(|a - pos|^2 - |a - neg|^2 + margin)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix)
        self._margin = margin

    def forward(self, pred, positive, negative):
        d_pos = torch.square(_match_shape(positive, pred) - pred)
        d_neg = torch.square(_match_shape(negative, pred) - pred)
        diff = d_pos - d_neg
        axes = [a for a in range(diff.dim())
                if a != self._batch_axis % diff.dim()]
        gap = torch.sum(diff, dim=axes)
        return self._reduce(torch.relu(gap + self._margin), mean=False)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood (``compute_full`` adds Stirling's
    log(target!) for targets > 1); a scalar mean."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, prefix=None):
        super().__init__(weight, batch_axis, prefix)
        self._from_logits, self._compute_full = from_logits, compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        t = _match_shape(target, pred)
        if self._from_logits:
            nll = torch.exp(pred) - t * pred
        else:
            nll = pred - t * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = t * torch.log(t) - t + 0.5 * torch.log(
                2 * math.pi * t)
            nll = nll + torch.where(t > 1, stirling,
                                    torch.zeros_like(stirling))
        return torch.mean(self._reduce(nll, sample_weight, mean=False))


class CosineEmbeddingLoss(Loss):
    """1 - cos(x1, x2) for positive pairs, relu(cos - margin) for
    negative ones."""

    def __init__(self, weight=None, batch_axis=0, margin=0, prefix=None):
        super().__init__(weight, batch_axis, prefix)
        self._margin = margin

    @staticmethod
    def _cos_sim(a, b):
        dot = torch.sum(a * b, dim=-1).reshape((-1, 1))
        na = torch.sqrt(torch.sum(torch.square(a), dim=-1)).reshape((-1, 1))
        nb = torch.sqrt(torch.sum(torch.square(b), dim=-1)).reshape((-1, 1))
        floor = torch.full((1, 1), 1e-12, dtype=dot.dtype, device=dot.device)
        return dot / torch.maximum(na * nb, floor)

    def forward(self, input1, input2, label, sample_weight=None):
        sim = self._cos_sim(_match_shape(input1, input2), input2)
        y = label.reshape((-1, 1))
        zero = torch.zeros((1, 1), dtype=sim.dtype, device=sim.device)
        cost = torch.where(y == 1, 1.0 - sim,
                           torch.maximum(zero, sim - self._margin))
        return self._reduce(cost, sample_weight)
