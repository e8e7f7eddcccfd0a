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
is marked ``cuda`` and skips here. Its schedule -- a parallel mask of
64-bit suppression words, an ordered walk of 64-row blocks on one word
column each, a parallel finish -- runs here as ``_bitmask_keep``, held
bitwise to the plain version and to the JAX kernel.
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


WORD = kernels.nms.MASK_WORD


def _words(bits):
    """(..., m) bool -> (..., ceil(m / 64)) Python ints, bit k of word w
    for column 64 w + k."""
    pad = -bits.shape[-1] % WORD
    bits = np.concatenate([bits, np.zeros(bits.shape[:-1] + (pad,), bool)],
                          -1)
    packed = np.packbits(bits, axis=-1, bitorder='little')
    words = packed.reshape(bits.shape[:-1] + (-1, 8)).view('<u8')[..., 0]
    return [[int(x) for x in row] for row in np.atleast_2d(words)]


def _bitmask_keep(boxes, valid, thresh, topk, cls):
    """``csrc/nms.cu``'s schedule in float32 numpy: the mask kernel's
    words (class keys, NaN for a box with a NaN coordinate; fminf / fmaxf;
    for thresh >= 0 only pairs overlapping in x and y get the division),
    the walk of 64-row blocks on word column rb alone, then the finish of
    the words right of the walked rows."""
    n = len(boxes)
    n_iter = kernels.nms_iterations(n, topk)
    words = kernels.nms.nms_mask_words(n)
    blocks = kernels.nms.nms_mask_words(n_iter)
    b = boxes.astype(np.float32)
    x1, y1, x2, y2 = b.T
    area = (x2 - x1) * (y2 - y1)
    key = np.zeros(n, np.float32) if cls is None else cls.astype(np.float32)
    key = np.where(np.isnan(b).any(1), np.float32(np.nan), key)
    t = np.float32(thresh)
    r = slice(0, n_iter)
    with np.errstate(invalid='ignore', divide='ignore', over='ignore'):
        dx = np.fmin(x2[None, :], x2[r, None]) - np.fmax(x1[None, :],
                                                          x1[r, None])
        dy = np.fmin(y2[None, :], y2[r, None]) - np.fmax(y1[None, :],
                                                          y1[r, None])
        if not t < 0:
            inter = dx * dy
            near = (dx > 0) & (dy > 0)
        else:
            iw = np.where(np.isnan(dx), dx, np.maximum(dx, np.float32(0)))
            ih = np.where(np.isnan(dy), dy, np.maximum(dy, np.float32(0)))
            inter = iw * ih
            near = np.ones_like(inter, bool)
        den = ((area[None, :] + area[r, None]) - inter) + np.float32(1e-12)
        iou = inter / den
    idx = np.arange(n)
    bits = (near & (key[None, :] == key[r, None]) & (iou > t)
            & (idx[None, :] > idx[r, None]))
    rows = _words(bits) if n_iter else []          # [i][w]
    col = [[rows[i][w] for i in range(n_iter)] for w in range(words)]
    vw = _words(np.asarray(valid, bool)[None])[0]
    kept_w, removed = [0] * blocks, [0] * words
    for rb in range(blocks):
        gone = 0
        for i in range(rb * WORD):
            if kept_w[i // WORD] >> (i % WORD) & 1:
                gone |= col[rb][i]
        span = min(WORD, n_iter - rb * WORD)
        for k in range(span):
            if vw[rb] >> k & 1 and not gone >> k & 1:
                kept_w[rb] |= 1 << k
                gone |= col[rb][rb * WORD + k]
        removed[rb] = gone
    for w in range(blocks, words):
        for i in range(n_iter):
            if kept_w[i // WORD] >> (i % WORD) & 1:
                removed[w] |= col[w][i]
    return np.array([bool(vw[j // WORD] >> (j % WORD) & 1)
                     and not removed[j // WORD] >> (j % WORD) & 1
                     for j in range(n)])


# the word and row-block edges of the kernel's schedule: N and topk on
# either side of 64, N past two words; class-aware where n + topk is odd
EDGES = [(n, topk) for n in (63, 64, 65, 129) for topk in (63, 64, 65, -1)]


@pytest.mark.parametrize('seed,n,classes,topk,thresh,dup,zero_area', CASES)
def test_bitmask_schedule_matches_greedy_and_jax(seed, n, classes, topk,
                                                 thresh, dup, zero_area):
    boxes, valid, cls = _boxes(seed, n, classes, dup, zero_area)
    got = _bitmask_keep(boxes, valid, thresh, topk, cls)
    np.testing.assert_array_equal(got, _port(boxes, valid, thresh, topk,
                                             cls))
    _assert_margins(boxes, valid, thresh, topk, cls)
    np.testing.assert_array_equal(got, _jax(boxes, valid, thresh, topk, cls))


@pytest.mark.parametrize('n,topk', EDGES)
def test_bitmask_schedule_at_word_edges(n, topk):
    classes = 3 if (n + topk) % 2 else 0
    boxes, valid, cls = _boxes(20 + n + topk, n, classes, dup=n == 129,
                               zero_area=n == 65)
    got = _bitmask_keep(boxes, valid, 0.3, topk, cls)
    np.testing.assert_array_equal(got, _port(boxes, valid, 0.3, topk, cls))
    _assert_margins(boxes, valid, 0.3, topk, cls)
    np.testing.assert_array_equal(got, _jax(boxes, valid, 0.3, topk, cls))


@pytest.mark.parametrize('bad,at,classes', [(np.nan, 40, 0), (np.nan, 0, 3),
                                            (np.inf, 64, 0),
                                            (-np.inf, 3, 3)])
def test_bitmask_schedule_non_finite_and_negative_thresh(bad, at, classes):
    """NaN and inf coordinates through the class keys and the fast path,
    and thresh < 0, where the kernel takes the walk's clamps: every pair
    whose IoU is not NaN suppresses."""
    boxes, valid, cls = _boxes(9, 100, classes, dup=True)
    boxes[at, 2] = bad
    valid[at] = True
    for thresh in (0.3, -0.25):
        got = _bitmask_keep(boxes, valid, thresh, -1, cls)
        np.testing.assert_array_equal(got, _port(boxes, valid, thresh, -1,
                                                 cls))
        finite = np.isfinite(boxes).all(axis=1)
        _assert_margins(boxes, valid & finite, thresh, -1, cls)
        np.testing.assert_array_equal(got, _jax(boxes, valid, thresh, -1,
                                                cls))


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
