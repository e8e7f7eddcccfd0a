"""Fused softmax + cross-entropy head: CUDA kernels and their plain
PyTorch versions.

The counterpart of ``mxnet_tpu/ops/pallas/xent.py``. Two kernels, both in
``csrc/softmax_xent.cu``, float32 and bf16:

  * :func:`softmax_xent_forward` replaces ``mxnet_tpu_softmax_xent_fwd``
    (xent.py:37): per row the max, the exp-sum, ``logp = x - m - log z``
    and ``nll = -logp[label]``, the logits read once. Its instance comes
    from :func:`xent_geometry`: a warp a row (V <= 1024), a thread-block
    cluster a row with the row held in the CTAs' shared memory, or for
    rows wider than a cluster holds, a block a row reading it twice;
  * :func:`softmax_xent_backward` replaces ``mxnet_tpu_softmax_xent_bwd``
    (xent.py:49): ``dx = g * (exp(logp) - onehot(label))``, a 16-byte
    stream over the rows x V elements as the epilogue kernels stream
    theirs, in chunks of whole rows past 2**31 - 1 elements
    (:func:`xent_bwd_geometry`).

bf16 (``net.cast('bfloat16')``): the forward takes float32 or bfloat16
logits and writes ``nll`` and ``logp`` float32 either way, as the
reference kernel does (xent.py:85-93); the backward writes ``dx`` in
float32 or bfloat16 (the logits' dtype, xent.py:118-124) from the float32
``logp``. Their bf16 instances count as ``softmax_xent_fwd.bf16`` /
``softmax_xent_bwd.bf16``; each is bitwise the float32 kernel on the
widened logits (the backward: its result, rounded once). fp16 and other
types raise ``TypeError``.

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
from .epilogue import MAX_ELEMENTS, epilogue_geometry, fast_divisor
from ._launch import (check_inputs as _check_inputs, count as _count,
                      instance as _instance, io_dtype as _io_dtype,
                      on_cpu as _on_cpu, ptr as _ptr, raise_on as _raise_on,
                      require as _require, stream as _stream)

__all__ = ['XENT_INSTANCES', 'XentGeometry', 'xent_geometry',
           'xent_cluster_smem',
           'XentBwdChunk', 'xent_bwd_geometry',
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
# columns of a CTA's chunk (a multiple of 4; its float buffer holds chunk
# + 4), for float32 and bf16 logits alike
XENT_CHUNK_MAX = ((SMEM_BLOCK_MAX - XENT_HEADER) // 4 - 4) & ~3
XENT_CHUNK_TARGET = 16384   # 64 KB a CTA: three CTAs an SM

XentGeometry = collections.namedtuple(
    'XentGeometry', 'instance cluster chunk smem threads grid')


def _chunk(v, cluster):
    per = -(-v // cluster)
    return 4 * -(-per // 4)


def xent_cluster_smem(chunk, itemsize=4):
    """Dynamic shared memory bytes of a cluster CTA holding ``chunk``
    columns of logits of ``itemsize`` bytes (4: float32, 2: bf16): the
    header and a float buffer of chunk + 4, or for bf16 logits a bf16
    staging region of chunk + 8 in its place."""
    _require(itemsize in (4, 2), 'xent_geometry: logits of %r bytes an '
             'element are not built (have 4, 2)' % (itemsize,))
    return XENT_HEADER + (2 * (chunk + 8) if itemsize == 2
                          else 4 * (chunk + 4))


def _cluster_geometry(rows, v, cluster, itemsize=4):
    """The cluster instance's geometry at ``cluster`` CTAs a row over
    logits of ``itemsize`` bytes; raises where a CTA of it would hold no
    column or its chunk does not fit."""
    chunk = _chunk(v, cluster)
    _require(1 <= cluster <= XENT_CLUSTER_MAX and chunk <= XENT_CHUNK_MAX
             and (cluster - 1) * chunk < v,
             'xent_geometry: no cluster instance of %r CTAs for V %d'
             % (cluster, v))
    return XentGeometry('cluster', cluster, chunk,
                        xent_cluster_smem(chunk, itemsize), XENT_THREADS,
                        rows * cluster)


def xent_geometry(rows, v, itemsize=4):
    """The forward kernel's instance for (rows, V) logits of ``itemsize``
    bytes an element (4: float32, 2: bf16), as a :class:`XentGeometry`
    (instance, CTAs a cluster, columns a CTA's chunk, dynamic shared
    memory bytes a CTA, threads a block, blocks).

    ``warp`` for V <= :data:`XENT_WARP_V` (eight rows a block); else
    ``cluster``, the fewest of 1, 2, 4, 8 CTAs a row whose chunk (V / CTAs
    rounded up to a multiple of 4) is at most :data:`XENT_CHUNK_TARGET`
    columns, or 8 while the chunk fits a block's float buffer
    (:data:`XENT_CHUNK_MAX`); past that ``two_pass``, a block a row. Only
    the shared memory depends on ``itemsize``: bf16 logits take the
    float32 instance's cluster sizes and chunks, and so its bits."""
    if v <= XENT_WARP_V:
        return XentGeometry('warp', 1, v, 0, XENT_THREADS,
                            -(-rows // (XENT_THREADS // 32)))
    cluster = next((c for c in (1, 2, 4, 8)
                    if _chunk(v, c) <= XENT_CHUNK_TARGET), XENT_CLUSTER_MAX)
    if _chunk(v, cluster) > XENT_CHUNK_MAX:
        return XentGeometry('two_pass', 1, v, 0, XENT_THREADS, rows)
    return _cluster_geometry(rows, v, cluster, itemsize)


XentBwdChunk = collections.namedtuple(
    'XentBwdChunk', 'row start n lead geom')


def xent_bwd_geometry(rows, v, itemsize=4):
    """The backward kernel's launches for (rows, V) ``logp`` and a dx of
    ``itemsize`` bytes an element (4: float32, 2: bf16), as ``(chunks,
    divisor)``: the :func:`fast_divisor` of V and one
    :class:`XentBwdChunk` a launch. The kernel indexes a launch's
    elements in 32 bits, so a tensor of more than :data:`MAX_ELEMENTS`
    elements goes in chunks of whole rows. A 16-byte vector of dx holds
    ``vec = 16 // itemsize`` elements (4 or 8). A chunk's elements are
    ``[start, start + n)`` of the flat (rows, V), ``start`` a multiple
    of ``vec`` (16-byte aligned in dx and in logp: the stream loads and
    stores whole vectors); its labels and g start at row ``row``. Where
    the first whole row of a chunk starts off the boundary, the chunk
    begins ``lead`` (< vec, < V) elements earlier with the end of row
    ``row``, which the chunk before it leaves out. ``geom`` is the
    chunk's :func:`epilogue_geometry` at ``itemsize``. A chunk holds a
    multiple of ``vec`` rows where that fits, and then no lead is
    needed; a row wider than ``MAX_ELEMENTS - (vec - 1)`` cannot be
    chunked and is refused (ValueError), unless the whole tensor fits
    one launch."""
    n = rows * v
    if n == 0:
        return (), None
    vec = 16 // itemsize
    if n <= MAX_ELEMENTS:
        return ((XentBwdChunk(0, 0, n, 0, epilogue_geometry(n, itemsize)),),
                fast_divisor(v))
    per = (MAX_ELEMENTS - (vec - 1)) // v
    _require(per >= 1, 'softmax_xent_backward: a row of %d elements is '
             'wider than the %d a launch indexes'
             % (v, MAX_ELEMENTS - (vec - 1)))
    if per >= vec:
        per -= per % vec
    firsts = range(0, rows, per)
    starts = [f * v & ~(vec - 1) for f in firsts] + [n]
    chunks = []
    for k, first in enumerate(firsts):
        lead = first * v - starts[k]
        size = starts[k + 1] - starts[k]
        chunks.append(XentBwdChunk(first - (lead != 0), starts[k], size,
                                   lead, epilogue_geometry(size, itemsize)))
    return tuple(chunks), fast_divisor(v)


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
        fn.restype = ctypes.c_int
        if entry.startswith('mx_softmax_xent_bwd'):
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_void_p]
            return fn
        if entry.startswith('mx_softmax_xent_fwd'):
            # the kernel's layout against xent_geometry's
            smem = lib.mx_softmax_xent_fwd_smem
            smem.restype = ctypes.c_int
            smem.argtypes = [ctypes.c_int] * 3
            for item in (4, 2):
                for chunk in (4, XENT_CHUNK_TARGET, XENT_CHUNK_MAX):
                    built = smem(XENT_INSTANCES.index('cluster'), chunk, item)
                    want = xent_cluster_smem(chunk, item)
                    _require(built == want, 'softmax_xent_fwd: xent_geometry '
                             'gives %d bytes at chunk %d (%d-byte logits), '
                             'the kernel takes %d'
                             % (want, chunk, item, built))
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    return fn


def softmax_xent_forward(logits, labels):
    """Per-row ``nll`` (rows,) and ``logp`` (rows, V), both float32, of
    (rows, V) float32 or bfloat16 logits and (rows,) labels, by the
    instance :func:`xent_geometry` picks."""
    dt = _io_dtype('softmax_xent_forward', {'logits': logits})
    if _on_cpu('softmax_xent_forward', logits, '(rows, V)'):
        return softmax_xent_forward_reference(logits, labels)
    rows, v = logits.shape
    geom = xent_geometry(rows, v, logits.element_size())
    lab = labels.to(dtype=torch.int32).reshape(-1).contiguous()
    _require(lab.shape[0] == rows, 'softmax_xent_forward: %d labels for '
             '%d rows' % (lab.shape[0], rows))
    _check_inputs('softmax_xent_forward', {'logits': logits, 'labels': lab},
                  {'logits': dt, 'labels': torch.int32})
    nll = torch.empty((rows,), dtype=torch.float32, device=logits.device)
    logp = torch.empty((rows, v), dtype=torch.float32, device=logits.device)
    name, entry = _instance('softmax_xent_fwd', 'mx_softmax_xent_fwd', dt)
    with torch.cuda.device(logits.device):
        err = _lib(entry)(
            _ptr(logits), _ptr(lab), _ptr(nll), _ptr(logp), rows, v,
            XENT_INSTANCES.index(geom.instance), geom.cluster, geom.chunk,
            _stream(logits.device))
    _raise_on(name, err)
    _count(name, geom.instance)
    return nll, logp


def softmax_xent_backward(logp, labels, g, dtype=torch.float32):
    """dlogits (rows, V) in ``dtype`` (float32 or bfloat16) from the
    saved float32 ``logp``, the labels and the cotangent ``g`` of
    ``nll`` (a scalar or (rows,)); one launch a chunk of
    :func:`xent_bwd_geometry`, counted once a call."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('softmax_xent_backward: dx in %s is not built (have '
                        'torch.float32, torch.bfloat16)' % (dtype,))
    if _on_cpu('softmax_xent_backward', logp, '(rows, V)'):
        return softmax_xent_backward_reference(logp, labels, g, dtype)
    rows, v = logp.shape
    lab = labels.to(dtype=torch.int32).reshape(-1).contiguous()
    gr = _rows_g(g, rows, logp.device)
    _require(lab.shape[0] == rows, 'softmax_xent_backward: %d labels for '
             '%d rows' % (lab.shape[0], rows))
    _check_inputs('softmax_xent_backward',
                  {'logp': logp, 'labels': lab, 'g': gr},
                  {'logp': torch.float32, 'labels': torch.int32,
                   'g': torch.float32})
    dx = torch.empty((rows, v), dtype=dtype, device=logp.device)
    chunks, div = xent_bwd_geometry(rows, v, dx.element_size())
    if not chunks:
        return dx
    name, entry = _instance('softmax_xent_bwd', 'mx_softmax_xent_bwd', dtype)
    fn = _lib(entry)
    with torch.cuda.device(logp.device):
        for c in chunks:
            err = fn(_at(logp, c.start), _at(lab, c.row), _at(gr, c.row),
                     _at(dx, c.start), c.n,
                     v, div.mul, div.shift, c.lead, int(c.geom.evict),
                     c.geom.tiles, _stream(logp.device))
            _raise_on(name, err)
    _count(name)
    return dx


def _at(t, element):
    """The device address of element ``element`` of ``t``."""
    return ctypes.c_void_p(t.data_ptr() + element * t.element_size())


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
