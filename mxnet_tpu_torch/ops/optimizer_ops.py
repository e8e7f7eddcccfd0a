"""Optimizer update ops, the counterpart of ``mxnet_tpu/ops/optimizer_ops.py``.

Only AdamW is ported (the BERT-pretraining optimizer). The JAX package
computes it outside any Pallas kernel, as plain elementwise XLA; here it
is plain PyTorch. Unlike the JAX op, which returns new arrays, the port
updates ``weight``, ``mean`` and ``var`` in place: the update then holds
no second copy of the model and its Adam state. The expressions and their
order are the JAX op's.
"""
from __future__ import annotations

import torch

__all__ = ['adamw_update']


@torch.no_grad()
def adamw_update(weight, grad, mean, var, rescale_grad=1.0, *, lr=1.0,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=None):
    """AdamW with decoupled weight decay (``_adamw_update``,
    optimizer_ops.py:139-152), in place::

        g = grad * rescale_grad, clipped to [-clip, clip] if clip > 0
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g^2
        w = w - eta * (lr * m / (sqrt(v) + epsilon) + wd * w)

    Returns (weight, mean, var), the tensors passed in.
    """
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * torch.square(g))
    step = lr * mean / (torch.sqrt(var) + epsilon) + wd * weight
    weight.sub_(eta * step)
    return weight, mean, var
