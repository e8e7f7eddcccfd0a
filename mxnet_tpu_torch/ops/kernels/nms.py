"""Greedy non-maximum suppression: the CUDA kernel and its plain PyTorch
version.

The counterpart of ``mxnet_tpu/ops/pallas/nms.py`` (``_nms_kernel`` :29,
``_nms_call`` :69, ``greedy_nms_keep`` :85). :func:`greedy_nms_keep`
launches ``mx_nms_keep`` of ``csrc/nms.cu`` once for a whole batch of
images, where the JAX package ``vmap``s its kernel per image. The TPU
kernel's packed (8, Npad) layout and its lane padding are not carried
over: the kernel reads the (B, N, 4) boxes as they are.

Semantics, all the TPU kernel's (``nms.py:29-64``):

  * ``n_iter = N`` when ``topk < 0``, else ``min(topk, N)``: boxes past
    position ``n_iter`` never suppress, but stay kept when valid;
  * box ``i`` suppresses box ``j`` when ``j > i``, ``i`` is still kept,
    ``iou > thresh`` (``thresh`` as float32, as JAX's weak-typed scalar
    is) and, with ``cls_id``, both have the same class id;
  * ``iou = inter / (((area_j + area_i) - inter) + 1e-12)``;
  * the keep mask starts at ``valid``; max and min propagate NaN, as
    ``jnp.maximum`` / ``jnp.minimum`` do, so a box with a NaN coordinate
    neither suppresses nor is suppressed (the JAX kernel, run by the
    Pallas interpreter, extracts box ``i`` exactly).

The kernel is three launches on the stream (``csrc/nms.cu``): a
parallel pass writes, for every box ``i < n_iter``, one 64-bit word a
64-box column block whose bit ``j`` says that ``i`` would suppress ``j``
(scratch from PyTorch's caching allocator, :func:`nms_scratch_words`);
one ordered walk an image then keeps box ``i < n_iter`` when it is valid
and no earlier kept row removed it; a parallel pass ORs the kept rows'
words into each box's removed bit and writes ``valid & ~removed``.

Wrapper rules as in ``epilogue.py``: a CPU tensor takes the plain version
(:func:`greedy_nms_keep_reference`), a CUDA tensor launches the kernel or
raises, and each call is counted once.
"""
from __future__ import annotations

import ctypes

import torch

from ._launch import (check_inputs as _check_inputs, count as _count,
                      dense as _dense, on_cpu as _on_cpu, ptr as _ptr,
                      raise_on as _raise_on, require as _require,
                      stream as _stream)

__all__ = ['MAX_BOXES', 'greedy_nms_keep', 'greedy_nms_keep_reference',
           'nms_iterations']

# the scan's tables hold 128 words of 64 boxes an image
MAX_BOXES = 8192
MASK_WORD = 64   # boxes a mask word


def nms_iterations(n, topk=-1):
    """``n_iter`` of ``nms.py:105``: every box, or the first ``topk``."""
    return n if topk is None or topk < 0 else min(int(topk), n)


def nms_mask_words(n):
    """Mask words a row of ``n`` boxes takes: ``ceil(n / 64)``."""
    return -(-n // MASK_WORD)


def nms_scratch_words(batch, n, n_iter):
    """64-bit words of the kernel's scratch: the mask words (batch,
    ceil(n / 64), n_iter), then each image's 128 kept and 128 removed
    words."""
    return batch * (nms_mask_words(n) * n_iter + 2 * MAX_BOXES // MASK_WORD)


def _batched(boxes, valid, cls_id):
    """(B, N, 4) boxes, (B, N) valid and class ids, and whether the
    caller gave one image (N, 4)."""
    single = boxes.dim() == 2
    if single:
        boxes, valid = boxes[None], valid[None]
        cls_id = None if cls_id is None else cls_id[None]
    _require(boxes.dim() == 3 and boxes.shape[-1] == 4,
             'greedy_nms_keep: boxes must be (N, 4) or (B, N, 4), got %r'
             % (tuple(boxes.shape),))
    _require(tuple(valid.shape) == tuple(boxes.shape[:2]),
             'greedy_nms_keep: valid has shape %r, boxes %r'
             % (tuple(valid.shape), tuple(boxes.shape)))
    _require(cls_id is None or tuple(cls_id.shape) == tuple(boxes.shape[:2]),
             'greedy_nms_keep: cls_id has shape %r, boxes %r'
             % (None if cls_id is None else tuple(cls_id.shape),
                tuple(boxes.shape)))
    return boxes, valid, cls_id, single


def greedy_nms_keep_reference(boxes, valid, thresh, topk=-1, cls_id=None):
    """Plain PyTorch version of :func:`greedy_nms_keep`: a loop over the
    ``n_iter`` steps of tensor ops over the batch, in the kernel's
    arithmetic."""
    b, v, c, single = _batched(boxes, valid, cls_id)
    b = b.float()
    x1, y1, x2, y2 = b.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    keep = v.bool().clone()
    n = b.shape[1]
    idx = torch.arange(n, device=b.device)
    t = torch.tensor(thresh, dtype=torch.float32, device=b.device)
    eps = torch.tensor(1e-12, dtype=torch.float32, device=b.device)
    cf = None if c is None else c.float()
    for i in range(nms_iterations(n, topk)):
        s = slice(i, i + 1)
        ai = (x2[:, s] - x1[:, s]) * (y2[:, s] - y1[:, s])
        iw = torch.clamp_min(torch.minimum(x2, x2[:, s])
                             - torch.maximum(x1, x1[:, s]), 0)
        ih = torch.clamp_min(torch.minimum(y2, y2[:, s])
                             - torch.maximum(y1, y1[:, s]), 0)
        inter = iw * ih
        iou = inter / (((area + ai) - inter) + eps)
        sup = (iou > t) & (idx > i) & keep[:, s]
        if cf is not None:
            sup = sup & (cf == cf[:, s])
        keep = keep & ~sup
    return keep[0] if single else keep


def _lib():
    from . import _build
    fn = _build.load('nms').mx_nms_keep
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
    return fn


def greedy_nms_keep(boxes, valid, thresh, topk=-1, cls_id=None):
    """Greedy NMS keep mask for score-sorted corner boxes.

    ``boxes`` (N, 4) or (B, N, 4), each image sorted by descending score;
    ``valid`` (N,) / (B, N) bool; ``cls_id`` None (class-agnostic) or
    (N,) / (B, N) class ids, when only same-class boxes suppress each
    other. Returns the (N,) / (B, N) bool keep mask. On a CUDA tensor one
    call of the kernel (its mask, walk and finish launches) covers the
    batch; at most :data:`MAX_BOXES` boxes an image."""
    if _on_cpu('greedy_nms_keep', boxes):
        return greedy_nms_keep_reference(boxes, valid, thresh, topk, cls_id)
    b, v, c, single = _batched(boxes, valid, cls_id)
    bsz, n = b.shape[0], b.shape[1]
    _require(n <= MAX_BOXES, 'greedy_nms_keep: %d boxes an image, more than '
             'the %d the kernel holds' % (n, MAX_BOXES))
    keep = torch.empty((bsz, n), dtype=torch.bool, device=b.device)
    if bsz == 0 or n == 0:
        return keep[0] if single else keep
    b, v = _dense(b.float()), _dense(v.to(torch.bool))
    named = {'boxes': b, 'valid': v, 'keep': keep}
    dtypes = {'boxes': torch.float32, 'valid': torch.bool,
              'keep': torch.bool}
    if c is not None:
        c = _dense(c.float())
        named['cls_id'], dtypes['cls_id'] = c, torch.float32
    _check_inputs('greedy_nms_keep', named, dtypes)
    n_iter = nms_iterations(n, topk)
    mask = torch.empty(nms_scratch_words(bsz, n, n_iter), dtype=torch.int64,
                       device=b.device)
    with torch.cuda.device(b.device):
        err = _lib()(_ptr(b), _ptr(v),
                     ctypes.c_void_p(None if c is None else c.data_ptr()),
                     _ptr(keep), _ptr(mask), bsz, n, n_iter, float(thresh),
                     _stream(b.device))
    _raise_on('nms', err)
    _count('nms')
    return keep[0] if single else keep
