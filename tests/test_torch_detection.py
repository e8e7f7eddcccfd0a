"""Port parity: the detection ops of the port
(``mxnet_tpu_torch/ops/contrib.py``) against the JAX package's
(``mxnet_tpu/ops/contrib.py``): ``box_iou``, ``multibox_prior``,
``box_nms`` and ``multibox_detection``, on the same numpy inputs.

On the CPU the port's suppression runs the ``nms`` kernel's plain version
and the JAX side its Pallas kernel in the interpreter.

Tolerances, float32:
  * ``box_iou``: 2 ulp (``rtol`` 2.4e-7): XLA may contract the
    ``area_a + area_b - inter`` of a product into an FMA;
  * ``multibox_prior``: 1 ulp (``rtol`` 1.2e-7) on the coordinates of
    both anchor ladders of ``ssd_300``, at its five map sizes: the offsets
    ``bw / 2`` are Python floats rounded to float32 in both, and
    ``(i + 0.5) * step`` rounds the same;
  * ``box_nms``: exact. Its rows are copies of the input rows or -1, and
    each case asserts that every IoU that decides a keep bit lies more
    than 1e-5 from the threshold in float64, so an ulp of FMA cannot flip
    it;
  * ``multibox_detection``: ids and scores exact (the same probabilities
    give the same argmax, max and stable sort order), coordinates to
    1e-6 (the decode's ``loc * var * aw + acx`` may be an FMA in XLA),
    after the same margin check on the decoded boxes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import _iou64
from mxnet_tpu.ops import contrib as jax_contrib
from mxnet_tpu_torch.ops import contrib as port_contrib
from mxnet_tpu_torch.ops import kernels

torch.set_num_threads(1)
MARGIN = 1e-5
SSD_SIZES = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79)]
SSD_RATIOS = [(1.0, 2.0, 0.5)] * 2 + [(1.0, 2.0, 0.5, 3.0, 1.0 / 3)] * 3
SSD_MAPS = (37, 18, 9, 4, 2)


def _corner_boxes(rs, shape, scale=0.3):
    xy = rs.rand(*shape, 2)
    wh = rs.rand(*shape, 2) * scale
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def _assert_margins(boxes, scores, valid, thresh, topk, ids=None):
    """Every IoU between a valid candidate among the first ``n_iter`` by
    score and a later valid candidate (of its id, when ``ids`` is given)
    lies more than MARGIN from ``thresh``, in float64."""
    order = np.argsort(-scores, kind='stable')
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    n_iter = kernels.nms_iterations(len(scores), topk)
    decides = (rank[:, None] < rank[None, :]) & (rank[:, None] < n_iter) \
        & valid[:, None] & valid[None, :]
    if ids is not None:
        decides &= ids[:, None] == ids[None, :]
    worst = np.abs(_iou64(boxes, boxes) - thresh)[decides].min(
        initial=np.inf)
    assert worst > MARGIN, ('an IoU lies %.3g from thresh: pick another '
                            'seed' % worst)


@pytest.mark.parametrize('fmt', ['corner', 'center'])
def test_box_iou_matches_jax(fmt):
    rs = np.random.RandomState(0)
    lhs, rhs = _corner_boxes(rs, (2, 7)), _corner_boxes(rs, (2, 5))
    if fmt == 'center':
        lhs[..., 2:] -= lhs[..., :2]
        rhs[..., 2:] -= rhs[..., :2]
    got = port_contrib.box_iou(torch.from_numpy(lhs), torch.from_numpy(rhs),
                               format=fmt).numpy()
    want = np.asarray(jax_contrib.box_iou(jnp.asarray(lhs), jnp.asarray(rhs),
                                          format=fmt))
    assert got.shape == (2, 7, 5)
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=1e-12)


@pytest.mark.parametrize('scale', range(5))
def test_multibox_prior_matches_jax(scale):
    hw = SSD_MAPS[scale]
    data = np.zeros((1, 4, hw, hw + 1), np.float32)
    for clip in (True, False):
        got = port_contrib.multibox_prior(
            torch.from_numpy(data), sizes=SSD_SIZES[scale],
            ratios=SSD_RATIOS[scale], clip=clip).numpy()
        want = np.asarray(jax_contrib.multibox_prior(
            jnp.asarray(data), sizes=SSD_SIZES[scale],
            ratios=SSD_RATIOS[scale], clip=clip))
        na = len(SSD_SIZES[scale]) + len(SSD_RATIOS[scale]) - 1
        assert got.shape == want.shape == (1, hw * (hw + 1) * na, 4)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=1e-30)


def test_multibox_prior_steps_and_offsets():
    data = np.zeros((1, 1, 5, 3), np.float32)
    kw = dict(sizes=(0.3,), ratios=(1.0, 2.0), steps=(0.25, 0.2),
              offsets=(0.3, 0.6))
    got = port_contrib.multibox_prior(torch.from_numpy(data), **kw).numpy()
    want = np.asarray(jax_contrib.multibox_prior(jnp.asarray(data), **kw))
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=1e-30)


def _nms_data(seed, b, n, k=6, classes=3, coord_start=2, score_index=1,
              id_index=0, center=False):
    rs = np.random.RandomState(seed)
    data = rs.rand(b, n, k).astype(np.float32)
    boxes = _corner_boxes(rs, (b, n))
    if center:
        boxes = np.concatenate([(boxes[..., :2] + boxes[..., 2:]) / 2,
                                boxes[..., 2:] - boxes[..., :2]], axis=-1)
    data[..., coord_start:coord_start + 4] = boxes
    data[..., score_index] = rs.rand(b, n)
    if id_index >= 0:
        data[..., id_index] = rs.randint(0, classes, (b, n))
    return data


NMS_CASES = {
    'agnostic': dict(kw=dict(overlap_thresh=0.5, valid_thresh=0.1)),
    'class_aware_topk': dict(kw=dict(overlap_thresh=0.3, valid_thresh=0.05,
                                     topk=40, id_index=0)),
    'background': dict(kw=dict(overlap_thresh=0.3, id_index=0,
                               background_id=0, topk=200)),
    'force_suppress': dict(kw=dict(overlap_thresh=0.4, id_index=0,
                                   force_suppress=True, topk=30)),
    'center': dict(kw=dict(overlap_thresh=0.45, valid_thresh=0.2,
                           id_index=0, in_format='center'),
                   data=dict(center=True)),
    'layout': dict(kw=dict(overlap_thresh=0.35, coord_start=1,
                           score_index=0, id_index=5),
                   data=dict(coord_start=1, score_index=0, id_index=5)),
    'unbatched': dict(kw=dict(overlap_thresh=0.5, id_index=0), b=None),
}


@pytest.mark.parametrize('case', sorted(NMS_CASES))
def test_box_nms_matches_jax(case):
    spec = NMS_CASES[case]
    kw = dict(spec['kw'])
    b = spec.get('b', 2)
    data = _nms_data(sorted(NMS_CASES).index(case), b or 1, 150,
                     **spec.get('data', {}))
    full = dict(overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
                coord_start=2, score_index=1, id_index=-1, background_id=-1,
                force_suppress=False, in_format='corner')
    full.update(kw)
    for img in data:
        scores = img[:, full['score_index']]
        boxes = img[:, full['coord_start']:full['coord_start'] + 4]
        if full['in_format'] == 'center':
            boxes = np.concatenate([boxes[:, :2] - boxes[:, 2:] / 2,
                                    boxes[:, :2] + boxes[:, 2:] / 2], axis=1)
        valid = scores > full['valid_thresh']
        ids = img[:, full['id_index']] if full['id_index'] >= 0 else None
        if ids is not None and full['background_id'] >= 0:
            valid &= ids != full['background_id']
        _assert_margins(boxes, scores, valid, full['overlap_thresh'],
                        full['topk'],
                        None if full['force_suppress'] else ids)
    x = data if b else data[0]
    got = port_contrib.box_nms(torch.from_numpy(x), **kw).numpy()
    want = np.asarray(jax_contrib.box_nms(jnp.asarray(x), **kw))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    kept = got[..., full['score_index']] >= 0
    assert kept.any() and (~kept).any()
    # kept rows first, by descending score; the rest are -1
    for img, k in zip(got.reshape((-1,) + got.shape[-2:]),
                      kept.reshape(-1, kept.shape[-1])):
        assert k[:k.sum()].all() and (img[k.sum():] == -1).all()
        s = img[:k.sum(), full['score_index']]
        assert (np.diff(s) <= 0).all()


def _detection_inputs(seed, b=2, classes=5):
    rs = np.random.RandomState(seed)
    maps = [np.zeros((1, 1, hw, hw), np.float32) for hw in (8, 4)]
    anchors = np.concatenate([np.asarray(jax_contrib.multibox_prior(
        jnp.asarray(m), sizes=SSD_SIZES[i], ratios=SSD_RATIOS[i], clip=True))
        for i, m in enumerate(maps)], axis=1)
    n = anchors.shape[1]
    logits = rs.randn(b, classes + 1, n).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    loc = (rs.randn(b, n * 4) * 0.5).astype(np.float32)
    return prob.astype(np.float32), loc, anchors


@pytest.mark.parametrize('seed,kw', [
    (0, dict(nms_threshold=0.45, threshold=0.01, nms_topk=400)),
    (1, dict(nms_threshold=0.5, threshold=0.2, nms_topk=30,
             force_suppress=True)),
    (2, dict(nms_threshold=0.3, threshold=0.05, clip=False,
             background_id=-1)),
])
def test_multibox_detection_matches_jax(seed, kw):
    prob, loc, anchors = _detection_inputs(seed)
    args = [torch.from_numpy(a) for a in (prob, loc, anchors)]
    got = port_contrib.multibox_detection(*args, **kw).numpy()
    want = np.asarray(jax_contrib.multibox_detection(
        *[jnp.asarray(a) for a in (prob, loc, anchors)], **kw))
    # the decoded candidates, unsuppressed (an IoU never exceeds 1.1)
    cand = port_contrib.multibox_detection(
        *args, **dict(kw, nms_threshold=1.1, nms_topk=-1)).numpy()
    for img in cand:
        ok = img[:, 0] >= 0
        _assert_margins(img[:, 2:], img[:, 1], ok, kw['nms_threshold'],
                        kw['nms_topk'] if 'nms_topk' in kw else -1,
                        None if kw.get('force_suppress') else img[:, 0])
    assert got.shape == (2, anchors.shape[1], 6)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=1e-6)
    kept = got[..., 0] >= 0
    assert kept.any() and (kept.sum(axis=1) < (cand[..., 0] >= 0).sum(1)).all()
