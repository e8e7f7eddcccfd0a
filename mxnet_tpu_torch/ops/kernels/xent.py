"""Fused softmax + cross-entropy head: CUDA kernels and their plain
PyTorch versions.

The counterpart of ``mxnet_tpu/ops/pallas/xent.py``. Two kernels, both in
``csrc/softmax_xent.cu``, float32:

  * :func:`softmax_xent_forward` replaces ``mxnet_tpu_softmax_xent_fwd``
    (xent.py:37): per row the max, the exp-sum, ``logp = x - m - log z``
    and ``nll = -logp[label]``, the logits read once. Its instance comes
    from :func:`xent_geometry`: a warp a row (V <= 1024), a thread-block
    cluster a row with the row held in the CTAs' shared memory, or for
    rows wider than a cluster holds, a block a row reading it twice;
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

import collections
import ctypes

import torch

from .attention import SMEM_BLOCK_MAX
from ._launch import (check_inputs as _check_inputs, count as _count,
                      on_cpu as _on_cpu, ptr as _ptr, raise_on as _raise_on,
                      require as _require, stream as _stream)

__all__ = ['XENT_INSTANCES', 'XentGeometry', 'xent_geometry',
           'fused_softmax_xent_rows',
           'fused_softmax_xent_rows_reference',
           'SoftmaxXentFunction', 'softmax_xent_forward',
           'softmax_xent_forward_reference', 'softmax_xent_backward',
           'softmax_xent_backward_reference']


# the forward's instances, in the order of the C enum Instance
# (csrc/softmax_xent.cu), which the constants below mirror
XENT_INSTANCES = ('warp', 'cluster', 'two_pass')
XENT_THREADS = 256
XENT_WARP_V = 1024          # widest row one warp holds in registers
XENT_CLUSTER_MAX = 8        # CTAs a cluster (the portable size)
XENT_HEADER = 128           # bytes of mbarrier, partials and scratch
# floats of a CTA's chunk (a multiple of 4; its buffer holds chunk + 4)
XENT_CHUNK_MAX = ((SMEM_BLOCK_MAX - XENT_HEADER) // 4 - 4) & ~3
XENT_CHUNK_TARGET = 16384   # 64 KB a CTA: three CTAs an SM

XentGeometry = collections.namedtuple(
    'XentGeometry', 'instance cluster chunk smem threads grid')


def _chunk(v, cluster):
    per = -(-v // cluster)
    return 4 * -(-per // 4)


def _cluster_geometry(rows, v, cluster):
    """The cluster instance's geometry at ``cluster`` CTAs a row; raises
    where a CTA of it would hold no column or its chunk does not fit."""
    chunk = _chunk(v, cluster)
    _require(1 <= cluster <= XENT_CLUSTER_MAX and chunk <= XENT_CHUNK_MAX
             and (cluster - 1) * chunk < v,
             'xent_geometry: no cluster instance of %r CTAs for V %d'
             % (cluster, v))
    return XentGeometry('cluster', cluster, chunk,
                        XENT_HEADER + 4 * (chunk + 4), XENT_THREADS,
                        rows * cluster)


def xent_geometry(rows, v):
    """The forward kernel's instance for (rows, V) logits, as a
    :class:`XentGeometry` (instance, CTAs a cluster, floats a CTA's chunk,
    dynamic shared memory bytes a CTA, threads a block, blocks).

    ``warp`` for V <= :data:`XENT_WARP_V` (eight rows a block); else
    ``cluster``, the fewest of 1, 2, 4, 8 CTAs a row whose chunk (V / CTAs
    rounded up to a multiple of 4) is at most :data:`XENT_CHUNK_TARGET`
    floats, or 8 while the chunk fits a block's shared memory
    (:data:`XENT_CHUNK_MAX`); past that ``two_pass``, a block a row."""
    if v <= XENT_WARP_V:
        return XentGeometry('warp', 1, v, 0, XENT_THREADS,
                            -(-rows // (XENT_THREADS // 32)))
    cluster = next((c for c in (1, 2, 4, 8)
                    if _chunk(v, c) <= XENT_CHUNK_TARGET), XENT_CLUSTER_MAX)
    if _chunk(v, cluster) > XENT_CHUNK_MAX:
        return XentGeometry('two_pass', 1, v, 0, XENT_THREADS, rows)
    return _cluster_geometry(rows, v, cluster)


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
    lib = _build.load('softmax_xent')
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fwd = entry == 'mx_softmax_xent_fwd'
        if fwd:
            # the kernel's layout against xent_geometry's
            smem = lib.mx_softmax_xent_fwd_smem
            smem.restype = ctypes.c_int
            smem.argtypes = [ctypes.c_int] * 2
            for chunk in (4, XENT_CHUNK_TARGET, XENT_CHUNK_MAX):
                built = smem(XENT_INSTANCES.index('cluster'), chunk)
                want = XENT_HEADER + 4 * (chunk + 4)
                _require(built == want, 'softmax_xent_fwd: xent_geometry '
                         'gives %d bytes at chunk %d, the kernel takes %d'
                         % (want, chunk, built))
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (
            5 if fwd else 2) + [ctypes.c_void_p]
    return fn


def softmax_xent_forward(logits, labels):
    """Per-row ``nll`` (rows,) and ``logp`` (rows, V), both float32, of
    (rows, V) logits and (rows,) labels, by the instance
    :func:`xent_geometry` picks."""
    if _on_cpu('softmax_xent_forward', logits, '(rows, V)'):
        return softmax_xent_forward_reference(logits, labels)
    rows, v = logits.shape
    geom = xent_geometry(rows, v)
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
            XENT_INSTANCES.index(geom.instance), geom.cluster, geom.chunk,
            _stream(logits.device))
    _raise_on('softmax_xent_fwd', err)
    _count('softmax_xent_fwd', geom.instance)
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
