"""Port parity: the SSD detector of the port
(``mxnet_tpu_torch.gluon.model_zoo.ssd``) against the JAX package's,
from the same weights on the same images.

Two nets, both built in the JAX package (``mx.init.Xavier()``, moving
statistics from a numpy seed, BatchNorm in inference mode) and carried
into the port by ``params_from_jax``:
  * the tiny SSD of ``tests/test_image_ssd.py:167-171`` (3 classes, two
    scales, 320 anchors) on 2 x 3 x 32 x 32 images;
  * ``ssd_300(20)`` at full width on 1 x 3 x 128 x 128, the smallest
    input on which all five of its scales are non-empty (16, 8, 4, 2 and
    1 pixels wide; 1406 anchors).

Heads (anchors, class and box predictions): within 1e-5 of each head's
max abs (measured 8.5e-7: up to fourteen convolutions summed in other
orders).

Detections (``MultiBoxDetection()``: softmax, decode, class-aware NMS at
0.45, top 400): the kept rows of each image, matched one to one, with
equal class ids and scores and coordinates within 1e-5. Rows whose
scores lie within an ulp or two of each other may come out in either
order, so rows are matched as a set, not by position. The set is only
decidable when no decision sits on a knife's edge, so each case first
asserts its margins, in float64 from the JAX side's values. The two
sides' class probabilities differ by ``d`` (measured in float64 from
both sides' heads: 6.1e-8 for the tiny net, 1.7e-8 for ``ssd_300``; the
test requires ``d <= 1e-6``); every score lies more than ``4 d`` from the
0.01 threshold, every kept row's top class more than ``4 d`` above its
second, every IoU that decides a keep bit more than 1e-5 from 0.45, and
the scores of every same-class pair that overlaps above it, whose order
decides which survives, more than ``4 d`` apart, as do the 400th and
401st scores. 1406 near-uniform 21-way softmaxes put top-2 gaps as close
as 3e-7, so a fixed 1e-5 margin would reject every seed. The float64
decode, the margins and the matching are ``chip_smoke.py``'s, which its
phase 6a holds the card's detections to in the same way.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from chip_smoke import _decode64, detection_margin, match_detections
from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo import ssd as jax_ssd
from mxnet_tpu_torch.gluon.model_zoo import ssd as port_ssd
from mxnet_tpu_torch.ops import kernels

torch.set_num_threads(1)
HEAD_REL = 1e-5
PROB_DIFF = 1e-6
DET_TOL = 1e-5
TINY = dict(num_classes=3, sizes=[(0.2, 0.3), (0.5, 0.6)],
            ratios=[(1.0, 2.0, 0.5)] * 2, base_channels=(8, 16),
            scale_channels=(16,))
NETS = {'tiny': ((2, 3, 32, 32), 320), 'ssd_300': ((1, 3, 128, 128), 1406)}


def _nets(which):
    if which == 'tiny':
        return jax_ssd.SSD(**TINY), port_ssd.SSD(device='cpu', **TINY)
    return jax_ssd.ssd_300(20), port_ssd.ssd_300(20, device='cpu')


@pytest.fixture(scope='module', params=sorted(NETS))
def case(request):
    """Both nets' heads and detections, as numpy."""
    which = request.param
    shape, anchors = NETS[which]
    jnet, pnet = _nets(which)
    jnet.initialize(mx.init.Xavier())
    x = np.random.RandomState(0).uniform(-1, 1, shape).astype('float32')
    xs = nd.array(x)
    jnet(xs)                                        # deferred shapes
    params = jnet.collect_params()
    rs = np.random.RandomState(1)
    for name, p in params.items():
        if name.endswith('running_mean'):
            p.set_data(nd.array(0.1 * rs.randn(*p.shape).astype('float32')))
        elif name.endswith('running_var'):
            p.set_data(nd.array((0.5 + rs.rand(*p.shape)).astype('float32')))
    jheads = jnet(xs)
    jdet = jax_ssd.MultiBoxDetection()(*jheads).asnumpy()
    weights = {n: p.data().asnumpy() for n, p in params.items()}
    port_ssd.params_from_jax(weights, pnet)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        pheads = pnet(torch.from_numpy(x))
        pdet = port_ssd.MultiBoxDetection()(*pheads).numpy()
    return dict(which=which, anchors=anchors, names=list(params),
                jheads=[h.asnumpy() for h in jheads],
                pheads=[h.numpy() for h in pheads], jdet=jdet, pdet=pdet,
                launches=kernels.launch_counts(), pnet=pnet)


def test_names_match_jax(case):
    names = list(case['pnet'].collect_params())
    assert names == [n[len('ssd0_'):] for n in case['names']]
    if case['which'] == 'ssd_300':
        assert len(names) == 90
        assert names[0] == 'base_hybridsequential0_conv0_weight'
        assert 'hybridsequential3_batchnorm1_running_var' in names
        assert names[-1] == 'box4_bias'


def test_heads_match_jax(case):
    n = case['anchors']
    b = case['jheads'][1].shape[0]
    shapes = [(1, n, 4), (b, n, case['pnet'].num_classes + 1), (b, n * 4)]
    for got, want, shape in zip(case['pheads'], case['jheads'], shapes):
        assert got.shape == want.shape == shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= HEAD_REL, err
    # the anchors: multibox_prior, to an ulp
    np.testing.assert_allclose(case['pheads'][0], case['jheads'][0],
                               rtol=1.2e-7, atol=1e-30)
    # on the CPU the plain versions ran: no kernel launch is counted
    assert not any(case['launches'].values())


def test_detections_match_jax(case):
    jheads, jdet, pdet = case['jheads'], case['jdet'], case['pdet']
    assert pdet.shape == jdet.shape == (jheads[1].shape[0],
                                        case['anchors'], 6)
    for (prob, boxes), (pprob, _), got, want in zip(
            _decode64(*jheads), _decode64(*case['pheads']), pdet, jdet):
        d = np.abs(prob - pprob).max()
        assert d <= PROB_DIFF
        assert detection_margin(prob, boxes, max(4 * d, 1e-9)) > 1
        assert match_detections(got, want, DET_TOL) > 0
        # suppressed and invalid rows are -1 and come last
        kept = got[:, 0] >= 0
        assert kept[:kept.sum()].all() and (got[~kept] == -1).all()
        assert np.isfinite(got).all()
