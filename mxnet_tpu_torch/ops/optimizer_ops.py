"""Optimizer update ops, the counterpart of ``mxnet_tpu/ops/optimizer_ops.py``.

Ported: AdamW (the BERT-pretraining optimizer) and SGD with and without
momentum (the ResNet one), dense gradients only. The JAX package computes
them outside any Pallas kernel, as plain elementwise XLA; here they are
plain PyTorch. Unlike the JAX ops, which return new arrays, the port
updates the weight and its state in place: the update then holds no
second copy of the model and its optimizer state. The expressions and
their order are the JAX ops'.
"""
from __future__ import annotations

import torch

__all__ = ['adamw_update', 'sgd_update', 'sgd_mom_update']


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


def _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight):
    """``clip(grad * rescale_grad) + wd * weight``, the SGD family's order
    (``_rescale_clip``, optimizer_ops.py:20-31): clip before the wd
    term."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd != 0:
        g = g + wd * weight
    return g


@torch.no_grad()
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """Plain SGD (``sgd_update``, optimizer_ops.py:57), in place:
    ``w = w - lr * g``. Returns ``weight``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    return weight.sub_(lr * g)


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """SGD with momentum (``sgd_mom_update``, optimizer_ops.py:67), in
    place::

        mom = momentum * mom - lr * g
        w = w + mom

    Returns (weight, mom), the tensors passed in."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    mom.mul_(momentum).sub_(lr * g)
    weight.add_(mom)
    return weight, mom
