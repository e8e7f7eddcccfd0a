"""Fused softmax + cross-entropy head: CUDA kernels and their plain
PyTorch versions.

The counterpart of ``mxnet_tpu/ops/pallas/xent.py``. Two kernels, both in
``csrc/softmax_xent.cu``, float32:

  * :func:`softmax_xent_forward` replaces ``mxnet_tpu_softmax_xent_fwd``
    (xent.py:37): per row the max, the exp-sum, ``logp = x - m - log z``
    and ``nll = -logp[label]`` from one read of the logits for the
    statistics and one for ``logp``;
  * :func:`softmax_xent_backward` replaces ``mxnet_tpu_softmax_xent_bwd``
    (xent.py:49): ``dx = g * (exp(logp) - onehot(label))``.

:func:`fused_softmax_xent_rows` wires them through
:class:`SoftmaxXentFunction`, which saves ``logp`` as ``_xent_fwd``
(xent.py:97) does. A label outside [0, V) matches no class, as the TPU
kernel's iota compare matches none: its ``nll`` is 0 and its gradient has
no ``-1`` term. Labels of any numeric dtype are cast to int32 (a float
label truncates, as ``astype(int32)`` does).

Wrapper rules as in ``attention.py``: a CPU tensor takes the plain version
(:func:`softmax_xent_forward_reference`,
:func:`softmax_xent_backward_reference`), a CUDA tensor launches the
kernel or raises, inputs are checked, each launch is counted.
"""
from __future__ import annotations

import ctypes

import torch

from ._launch import (check_inputs as _check_inputs, count as _count,
                      on_cpu as _on_cpu, ptr as _ptr, raise_on as _raise_on,
                      require as _require, stream as _stream)

__all__ = ['fused_softmax_xent_rows', 'fused_softmax_xent_rows_reference',
           'SoftmaxXentFunction', 'softmax_xent_forward',
           'softmax_xent_forward_reference', 'softmax_xent_backward',
           'softmax_xent_backward_reference']


def _onehot(labels, v, device):
    cls = torch.arange(v, device=device, dtype=torch.int32)
    return (cls[None, :] == labels.reshape(-1, 1)).float()


def softmax_xent_forward_reference(logits, labels):
    """Plain PyTorch version of the forward kernel: (nll (rows,) float32,
    logp (rows, V) float32)."""
    xf = logits.float()
    m = torch.amax(xf, dim=-1, keepdim=True)
    z = torch.sum(torch.exp(xf - m), dim=-1, keepdim=True)
    logp = xf - m - torch.log(z)
    lab = labels.to(device=logits.device, dtype=torch.int32)
    nll = -torch.sum(logp * _onehot(lab, logp.shape[-1], logp.device),
                     dim=-1)
    return nll, logp


def softmax_xent_backward_reference(logp, labels, g, dtype=torch.float32):
    """Plain PyTorch version of the backward kernel: dx (rows, V) in
    ``dtype``; ``g`` is a scalar or (rows,)."""
    lab = labels.to(device=logp.device, dtype=torch.int32)
    gr = _rows_g(g, logp.shape[0], logp.device)
    dx = gr[:, None] * (torch.exp(logp) - _onehot(lab, logp.shape[-1],
                                                  logp.device))
    return dx.to(dtype)


def _rows_g(g, rows, device):
    g = torch.as_tensor(g, dtype=torch.float32, device=device)
    return g.reshape(-1).expand(rows).contiguous()


def _lib(entry):
    from . import _build
    fn = getattr(_build.load('softmax_xent'), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
    return fn


def softmax_xent_forward(logits, labels):
    """Per-row ``nll`` (rows,) and ``logp`` (rows, V), both float32, of
    (rows, V) logits and (rows,) labels."""
    if _on_cpu('softmax_xent_forward', logits, '(rows, V)'):
        return softmax_xent_forward_reference(logits, labels)
    rows, v = logits.shape
    lab = labels.to(dtype=torch.int32).reshape(-1).contiguous()
    _require(lab.shape[0] == rows, 'softmax_xent_forward: %d labels for '
             '%d rows' % (lab.shape[0], rows))
    _check_inputs('softmax_xent_forward', {'logits': logits, 'labels': lab},
                  {'logits': torch.float32, 'labels': torch.int32})
    nll = torch.empty((rows,), dtype=torch.float32, device=logits.device)
    logp = torch.empty_like(logits)
    with torch.cuda.device(logits.device):
        err = _lib('mx_softmax_xent_fwd')(
            _ptr(logits), _ptr(lab), _ptr(nll), _ptr(logp), rows, v,
            _stream(logits.device))
    _raise_on('softmax_xent_fwd', err)
    _count('softmax_xent_fwd')
    return nll, logp


def softmax_xent_backward(logp, labels, g, dtype=torch.float32):
    """dlogits (rows, V) in ``dtype`` from the saved ``logp``, the labels
    and the cotangent ``g`` of ``nll`` (a scalar or (rows,))."""
    if _on_cpu('softmax_xent_backward', logp, '(rows, V)'):
        return softmax_xent_backward_reference(logp, labels, g, dtype)
    rows, v = logp.shape
    _require(dtype == torch.float32, 'softmax_xent_backward: the kernel '
             'writes float32, got %s' % dtype)
    lab = labels.to(dtype=torch.int32).reshape(-1).contiguous()
    gr = _rows_g(g, rows, logp.device)
    _require(lab.shape[0] == rows, 'softmax_xent_backward: %d labels for '
             '%d rows' % (lab.shape[0], rows))
    _check_inputs('softmax_xent_backward',
                  {'logp': logp, 'labels': lab, 'g': gr},
                  {'logp': torch.float32, 'labels': torch.int32,
                   'g': torch.float32})
    dx = torch.empty_like(logp)
    with torch.cuda.device(logp.device):
        err = _lib('mx_softmax_xent_bwd')(
            _ptr(logp), _ptr(lab), _ptr(gr), _ptr(dx), rows, v,
            _stream(logp.device))
    _raise_on('softmax_xent_bwd', err)
    _count('softmax_xent_bwd')
    return dx


class SoftmaxXentFunction(torch.autograd.Function):
    """The ``_xent_core`` custom_vjp (xent.py:70-131): the forward kernel
    saves ``logp``; the backward kernel is the closed form
    ``g * (softmax - onehot)``. No gradient flows to the labels."""

    @staticmethod
    def forward(ctx, logits, labels):
        nll, logp = softmax_xent_forward(logits, labels)
        ctx.save_for_backward(logp, labels)
        ctx.dtype = logits.dtype
        return nll

    @staticmethod
    def backward(ctx, g):
        logp, labels = ctx.saved_tensors
        return softmax_xent_backward(logp, labels, g, ctx.dtype), None


def fused_softmax_xent_rows(logits, labels):
    """Per-row negative log-likelihood (rows,) float32 of (rows, V)
    logits; differentiable in the logits through the saved-logp closed
    form."""
    return SoftmaxXentFunction.apply(logits, labels)


def fused_softmax_xent_rows_reference(logits, labels):
    """Plain PyTorch version of :func:`fused_softmax_xent_rows`,
    differentiable by autograd. Its gradient agrees with the closed form
    for labels in [0, V); for a label outside, autograd of the constant
    0 gives 0 where the closed form gives ``g * softmax``."""
    return softmax_xent_forward_reference(logits, labels)[0]
