"""Detection ops of the SSD serving path, the counterpart of the detection
block of ``mxnet_tpu/ops/contrib.py``: :func:`box_iou` (:149),
:func:`_nms_single` (:167), :func:`box_nms` (:181-222),
:func:`multibox_prior` (:258-286) and :func:`multibox_detection`
(:356-394).

Plain PyTorch around one kernel: the greedy suppression of
:func:`box_nms` goes through ``ops/kernels`` ``greedy_nms_keep`` (the
``nms`` kernel on a CUDA tensor, its plain version on a CPU tensor), one
call for the whole batch where the JAX op ``vmap``s per image. The sorts
are stable, as ``jnp.argsort`` is. Each body keeps the JAX body's order of
operations; a Python float meets a float32 tensor as JAX's weak-typed
scalar does, rounded to float32. ``MultiBoxTarget`` (training) is not
ported yet.
"""
from __future__ import annotations

import math

import torch

from .kernels import greedy_nms_keep

__all__ = ['box_iou', 'box_nms', 'multibox_prior', 'multibox_detection']


def _center_to_corner(b):
    x, y, w, h = b.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)


def box_iou(lhs, rhs, format='corner'):
    """IoU of every box of ``lhs`` (..., N, 4) with every box of ``rhs``
    (..., M, 4): (..., N, M). ``format`` 'corner' (x1, y1, x2, y2) or
    'center' (x, y, w, h)."""
    if format == 'center':
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    a = lhs[..., :, None, :]
    b = rhs[..., None, :, :]
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp_min(br - tl, 0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-12)


def _nms_single(boxes, scores, valid, overlap_thresh, topk, cls_id=None):
    """Greedy NMS of (B, N) candidates in their own order: sort each image
    by descending score, run the keep kernel once over the batch, and map
    the mask back to the input order."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    sort = order[..., None].expand(boxes.shape)
    keep = greedy_nms_keep(
        torch.gather(boxes, -2, sort), torch.gather(valid, -1, order),
        overlap_thresh, topk,
        cls_id=None if cls_id is None else torch.gather(cls_id, -1, order))
    return torch.empty_like(keep).scatter_(-1, order, keep)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format='corner'):
    """Non-maximum suppression of (N, K) or (B, N, K) rows holding a score
    at ``score_index`` and a box at ``coord_start:coord_start + 4``
    (``in_format`` 'corner' or 'center'). A row is a candidate when its
    score exceeds ``valid_thresh`` (and, with ``id_index`` and
    ``background_id`` both >= 0, its id is not the background's). With
    ``id_index >= 0`` and not ``force_suppress`` only rows of one id
    suppress each other. Suppressed and invalid rows become -1; the kept
    rows come first, by descending score. Only the first ``topk``
    candidates suppress (all when ``topk < 0``), the TPU kernel's rule:
    later ones stay kept when valid."""
    batched = data.dim() == 3
    x = data if batched else data[None]
    scores = x[..., score_index]
    # dynamic_slice_in_dim clamps the start so that 4 columns fit
    start = min(max(int(coord_start), 0), x.shape[-1] - 4)
    boxes = x[..., start:start + 4]
    if in_format == 'center':
        boxes = _center_to_corner(boxes)
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (x[..., id_index] != background_id)
    ids = x[..., id_index] if id_index >= 0 and not force_suppress else None
    keep = _nms_single(boxes, scores, valid, overlap_thresh, int(topk),
                       cls_id=ids)
    out = torch.where(keep[..., None], x, -torch.ones_like(x))
    neg_s = torch.where(keep, -scores, torch.full_like(scores, math.inf))
    order = torch.argsort(neg_s, dim=-1, stable=True)
    out = torch.gather(out, 1, order[..., None].expand(out.shape))
    return out if batched else out[0]


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors of an (N, C, H, W) feature map: (1, H * W * A, 4)
    corner boxes, row-major over the map with the A anchors of a position
    minor: ``sizes[0]`` with each ratio, then each other size with
    ``ratios[0]``."""
    h, w = data.shape[2], data.shape[3]
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    dev = data.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing='ij')
    whs = [(sizes[0] * math.sqrt(r), sizes[0] / math.sqrt(r))
           for r in ratios]
    whs += [(s * math.sqrt(ratios[0]), s / math.sqrt(ratios[0]))
            for s in sizes[1:]]
    # bw / 2 and bh / 2 are Python floats, rounded to float32 where they
    # meet the grid, as in the JAX op
    anchors = [torch.stack([cxg - bw / 2, cyg - bh / 2, cxg + bw / 2,
                            cyg + bh / 2], dim=-1) for bw, bh in whs]
    out = torch.stack(anchors, dim=2).reshape(-1, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out[None]


def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode SSD predictions into detections: ``cls_prob`` (B, C, N)
    class probabilities, ``loc_pred`` (B, N * 4) offsets, ``anchor`` (1, N,
    4) corner anchors -> (B, N, 6) rows ``[id, score, x1, y1, x2, y2]``
    after class-aware :func:`box_nms` (``force_suppress`` for
    class-agnostic); rows at or below ``threshold`` and suppressed rows are
    -1."""
    n = cls_prob.shape[2]
    var = torch.tensor(variances, dtype=torch.float32, device=cls_prob.device)
    anchors = anchor[0]
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    # the class with the highest probability, background excluded
    probs = cls_prob[:, 1:] if background_id == 0 else cls_prob
    score, cid = torch.max(probs, dim=1)
    cid = cid.to(torch.float32)
    loc = loc_pred.reshape(-1, n, 4)
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw
    h = torch.exp(loc[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    cid = torch.where(score > threshold, cid, torch.full_like(cid, -1.0))
    dets = torch.cat([cid[..., None], score[..., None], boxes], dim=-1)
    return box_nms(dets, overlap_thresh=nms_threshold,
                   valid_thresh=threshold, topk=nms_topk, coord_start=2,
                   score_index=1, id_index=0, background_id=-1,
                   force_suppress=force_suppress)


# -- under their reference names (ops/registry.py) --------------------------

from .registry import register as _register  # noqa: E402


@_register('_contrib_box_iou', num_inputs=2)
def _box_iou_op(lhs, rhs, *, format='corner'):
    return box_iou(lhs, rhs, format=format)


@_register('_contrib_box_nms', num_inputs=1, aliases=('_contrib_nms',))
def _box_nms_op(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
                coord_start=2, score_index=1, id_index=-1, background_id=-1,
                force_suppress=False, in_format='corner',
                out_format='corner'):
    return box_nms(data, overlap_thresh=overlap_thresh,
                   valid_thresh=valid_thresh, topk=topk,
                   coord_start=coord_start, score_index=score_index,
                   id_index=id_index, background_id=background_id,
                   force_suppress=force_suppress, in_format=in_format)


@_register('_contrib_MultiBoxPrior', num_inputs=1)
def _multibox_prior_op(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                       steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    return multibox_prior(data, sizes=sizes, ratios=ratios, clip=clip,
                          steps=steps, offsets=offsets)


@_register('_contrib_MultiBoxDetection', num_inputs=3)
def _multibox_detection_op(cls_prob, loc_pred, anchor, *, clip=True,
                           threshold=0.01, background_id=0,
                           nms_threshold=0.5, force_suppress=False,
                           variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    return multibox_detection(cls_prob, loc_pred, anchor, clip=clip,
                              threshold=threshold,
                              background_id=background_id,
                              nms_threshold=nms_threshold,
                              force_suppress=force_suppress,
                              variances=variances, nms_topk=nms_topk)
