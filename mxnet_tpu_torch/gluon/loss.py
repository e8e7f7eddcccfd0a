"""Losses of the port, the counterpart of ``mxnet_tpu/gluon/loss.py``
(``Loss._reduce`` :43-68, ``SoftmaxCrossEntropyLoss`` :134-160).

The sparse-label, from-logits=False case over the last axis runs the
fused softmax-xent kernels (the branch ``MXNET_TPU_PALLAS=xent`` selects
in the JAX loss); the other cases are the JAX loss's plain log-softmax
spelling.
"""
from __future__ import annotations

import torch

from ..amp import cast_op_inputs as _amp
from ..ops import nn as ops
from .block import Block

__all__ = ['Loss', 'SoftmaxCrossEntropyLoss', 'SoftmaxCELoss']


class Loss(Block):
    """Common base: holds the scalar weight and batch axis, owns the
    weighting + reduction pipeline."""

    def __init__(self, weight, batch_axis, prefix=''):
        super().__init__(prefix)
        self._weight, self._batch_axis = weight, batch_axis

    def _reduce(self, cost, sample_weight=None):
        """sample_weight * cost, times the scalar weight, then the mean
        over every axis but the batch axis."""
        if sample_weight is not None:
            cost = cost * sample_weight
        if self._weight is not None:
            if not isinstance(self._weight, (int, float)):
                raise TypeError('loss weight must be a number')
            cost = cost * self._weight
        axes = [a for a in range(cost.dim())
                if a != self._batch_axis % cost.dim()]
        return torch.mean(cost, dim=axes) if axes else cost


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy after an (optional) internal log-softmax.
    ``sparse_label`` picks the target class's log-probability; dense
    labels dot against the full distribution."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, prefix=''):
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
