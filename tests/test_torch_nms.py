"""Port parity: the greedy-NMS keep mask of the port
(``mxnet_tpu_torch.ops.kernels.greedy_nms_keep``) against the JAX
package's (``mxnet_tpu/ops/pallas/nms.py``, its Pallas kernel in the
interpreter on the CPU) and against a float32 numpy greedy loop.

On the CPU the port's wrapper runs its plain PyTorch version, a loop of
tensor ops in the CUDA kernel's arithmetic. Boxes come from a numpy seed
and go to both.

Exactness. A keep bit depends on ``iou > thresh``; XLA on the CPU may
contract ``a - b * c`` into an FMA, so an IoU within an ulp or two of
``thresh`` could flip between the two frameworks. Each case therefore
asserts that every IoU that decides something -- box ``i < n_iter``
against a later box, both valid, same class when class-aware -- lies more
than 1e-5 from ``thresh`` in float64, and then requires the keep masks to
be equal. The numpy loop of ``tests/test_control_flow.py`` rounds each
step in float32 in the kernel's order, so it needs no margin.

The CUDA kernel (``csrc/nms.cu``) runs only on the card: the last test
is marked ``cuda`` and skips here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas.nms import greedy_nms_keep as jax_nms_keep
from mxnet_tpu_torch.ops import kernels

torch.set_num_threads(1)
MARGIN = 1e-5


def _boxes(seed, n, classes=0, dup=False, zero_area=False):
    rs = np.random.RandomState(seed)
    xy = rs.rand(n, 2)
    wh = rs.rand(n, 2) * 0.3
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    if dup:             # every third box repeats the one before it
        boxes[1::3] = boxes[0:n - 1:3][:len(boxes[1::3])]
    if zero_area:       # every fifth box has no width
        boxes[2::5, 2] = boxes[2::5, 0]
    valid = rs.rand(n) > 0.2
    cls = rs.randint(0, classes, n).astype(np.float32) if classes else None
    return boxes, valid, cls


def _iou64(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    iw = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
    inter = iw * ih
    area = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
    return inter / (area - inter + 1e-12)


def _assert_margins(boxes, valid, thresh, topk, cls):
    n = len(boxes)
    n_iter = kernels.nms_iterations(n, topk)
    worst = np.inf
    for i in range(n_iter):
        for j in range(i + 1, n):
            if not (valid[i] and valid[j]):
                continue
            if cls is not None and cls[i] != cls[j]:
                continue
            worst = min(worst, abs(_iou64(boxes[i], boxes[j]) - thresh))
    assert worst > MARGIN, ('an IoU lies %.3g from thresh: pick another '
                            'seed' % worst)


def _np_greedy(boxes, valid, thresh):
    """``tests/test_control_flow.py:310-327``: float32 steps."""
    n = len(boxes)
    keep = valid.copy()
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in range(n):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if not keep[j]:
                continue
            ix1 = max(boxes[i, 0], boxes[j, 0])
            iy1 = max(boxes[i, 1], boxes[j, 1])
            ix2 = min(boxes[i, 2], boxes[j, 2])
            iy2 = min(boxes[i, 3], boxes[j, 3])
            inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
            iou = inter / (areas[i] + areas[j] - inter + 1e-12)
            if iou > thresh:
                keep[j] = False
    return keep


def _jax(boxes, valid, thresh, topk, cls):
    return np.asarray(jax_nms_keep(
        jnp.asarray(boxes), jnp.asarray(valid), thresh, topk,
        cls_id=None if cls is None else jnp.asarray(cls)))


def _port(boxes, valid, thresh, topk, cls):
    return kernels.greedy_nms_keep(
        torch.from_numpy(boxes), torch.from_numpy(valid), thresh, topk,
        cls_id=None if cls is None else torch.from_numpy(cls)).numpy()


CASES = [
    # (seed, n, classes, topk, thresh, dup, zero_area)
    (0, 50, 0, -1, 0.5, False, False),      # N < 128
    (1, 200, 3, -1, 0.3, False, False),     # not a multiple of 128
    (2, 200, 0, 37, 0.3, False, False),     # topk < N
    (3, 129, 4, 60, 0.45, True, True),      # duplicates, zero areas
    (4, 300, 2, 500, 0.2, True, False),     # topk > N
]


@pytest.mark.parametrize('seed,n,classes,topk,thresh,dup,zero_area', CASES)
def test_keep_matches_jax(seed, n, classes, topk, thresh, dup, zero_area):
    boxes, valid, cls = _boxes(seed, n, classes, dup, zero_area)
    _assert_margins(boxes, valid, thresh, topk, cls)
    got = _port(boxes, valid, thresh, topk, cls)
    want = _jax(boxes, valid, thresh, topk, cls)
    assert got.dtype == np.bool_ and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    if dup:
        # a valid duplicate of a kept box is always suppressed
        assert got.sum() < valid.sum()


@pytest.mark.parametrize('seed,n,thresh', [(5, 50, 0.5), (6, 333, 0.3)])
def test_keep_matches_numpy_greedy(seed, n, thresh):
    boxes, valid, _ = _boxes(seed, n, dup=True, zero_area=True)
    np.testing.assert_array_equal(_port(boxes, valid, thresh, -1, None),
                                  _np_greedy(boxes, valid, thresh))


def test_batched_is_one_call_per_batch_and_matches_per_image():
    cases = [_boxes(10 + b, 150, 3) for b in range(3)]
    boxes = np.stack([c[0] for c in cases])
    valid = np.stack([c[1] for c in cases])
    cls = np.stack([c[2] for c in cases])
    got = kernels.greedy_nms_keep(torch.from_numpy(boxes),
                                  torch.from_numpy(valid), 0.4, 100,
                                  cls_id=torch.from_numpy(cls)).numpy()
    assert got.shape == (3, 150)
    for b in range(3):
        _assert_margins(boxes[b], valid[b], 0.4, 100, cls[b])
        np.testing.assert_array_equal(got[b], _jax(boxes[b], valid[b], 0.4,
                                                   100, cls[b]))
    # on the CPU the plain version runs: no kernel launch is counted
    assert kernels.launch_counts()['nms'] == 0


def test_all_invalid_keeps_nothing():
    boxes, _, _ = _boxes(7, 140)
    valid = np.zeros(140, bool)
    got = _port(boxes, valid, 0.5, -1, None)
    assert not got.any()
    np.testing.assert_array_equal(got, _jax(boxes, valid, 0.5, -1, None))


@pytest.mark.parametrize('bad,at', [(np.nan, 40), (np.nan, 0),
                                    (np.inf, 40), (-np.inf, 3)])
def test_non_finite_coordinate_as_jax(bad, at):
    """max and min propagate NaN, as ``jnp.maximum`` / ``jnp.minimum`` do:
    a box with a NaN coordinate neither suppresses nor is suppressed,
    and the other boxes suppress as before; an inf coordinate follows IEEE
    arithmetic. The JAX kernel (in the interpreter) extracts box ``i``
    exactly, so the NaN stays in its own box."""
    boxes, valid, _ = _boxes(8, 100, dup=True)
    boxes[at, 1] = bad
    valid[at] = True
    finite = np.isfinite(boxes).all(axis=1)
    _assert_margins(boxes, valid & finite, 0.3, -1, None)
    want = _jax(boxes, valid, 0.3, -1, None)
    np.testing.assert_array_equal(_port(boxes, valid, 0.3, -1, None), want)
    assert want.sum() < valid.sum()
    if np.isnan(bad):
        assert want[at]
        np.testing.assert_array_equal(np.delete(want, at), _np_greedy(
            np.delete(boxes, at, 0), np.delete(valid, at), 0.3))


def test_threshold_compared_in_float32():
    """``thresh`` meets the float32 IoU as a float32, as JAX's weak-typed
    scalar does: a double a third of an ulp below the IoU rounds to it, so
    ``iou > thresh`` is false and both boxes stay; one ulp below, the
    second box goes."""
    boxes = np.array([[0, 0, 1, 1], [0.25, 0, 1.25, 1]], np.float32)
    valid = np.ones(2, bool)
    one, inter = np.float32(1), np.float32(0.75)
    iou = inter / (((one + one) - inter) + np.float32(1e-12))
    below = np.nextafter(iou, np.float32(0))
    for thresh, keep in ((float(iou) - (float(iou) - float(below)) / 3,
                          [True, True]), (float(below), [True, False])):
        np.testing.assert_array_equal(_port(boxes, valid, thresh, -1, None),
                                      keep)
        np.testing.assert_array_equal(_jax(boxes, valid, thresh, -1, None),
                                      keep)


def test_wrapper_rejects_bad_shapes():
    boxes = torch.zeros(2, 5, 3)
    with pytest.raises(ValueError):
        kernels.greedy_nms_keep(boxes, torch.ones(2, 5, dtype=torch.bool),
                                0.5)
    with pytest.raises(ValueError):
        kernels.greedy_nms_keep(torch.zeros(2, 5, 4),
                                torch.ones(2, 4, dtype=torch.bool), 0.5)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """``csrc/nms.cu`` against the plain version on the card, bitwise:
    class-aware and not, topk, N below and above one block's width, a NaN
    coordinate; one launch per batch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel is CUDA C++ for sm_90a '
                    'and has no CPU mode')
    for seed, (b, n, classes, topk) in enumerate(
            [(3, 100, 3, -1), (2, 1100, 0, 400), (2, 7378, 20, 400)]):
        cases = [_boxes(seed * 10 + i, n, classes, dup=True)
                 for i in range(b)]
        boxes = torch.tensor(np.stack([c[0] for c in cases]), device='cuda')
        if seed == 1:
            boxes[1, 7, 2] = float('nan')
        valid = torch.tensor(np.stack([c[1] for c in cases]), device='cuda')
        cls = None if not classes else torch.tensor(
            np.stack([c[2] for c in cases]), device='cuda')
        kernels.reset_launch_counts()
        got = kernels.greedy_nms_keep(boxes, valid, 0.45, topk, cls_id=cls)
        torch.cuda.synchronize()
        assert kernels.launch_counts()['nms'] == 1
        want = kernels.greedy_nms_keep_reference(boxes, valid, 0.45, topk,
                                                 cls_id=cls)
        assert torch.equal(got, want)
