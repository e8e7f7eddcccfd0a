"""The port's losses (``mxnet_tpu_torch/gluon/loss.py``) against the JAX
package's, on the CPU: every loss of the zoo on the same inputs, with and
without sample weights and a scalar weight, the per-sample values and the
gradient with respect to the prediction within 1e-5 of their magnitude
(the transcendental ones differ by ULPs; CTC sums its alpha recursion in
another order).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx

TOL = 1e-5
RS = np.random.RandomState(0)
PRED = RS.randn(6, 5).astype('float32')
REG_LAB = RS.randn(6, 5).astype('float32')
SIGNED = np.sign(RS.randn(6, 5)).astype('float32')
BINARY = (RS.rand(6, 5) > 0.5).astype('float32')
PROB = (1 / (1 + np.exp(-PRED))).astype('float32')
DIST = np.exp(RS.randn(6, 5)).astype('float32')
DIST = (DIST / DIST.sum(1, keepdims=True)).astype('float32')
CLS = RS.randint(0, 5, (6,)).astype('float32')
SW = RS.rand(6, 1).astype('float32')
POS = (RS.rand(6, 5) * 3).astype('float32')

# name: (make(loss module), inputs after pred (sample_weight and
# pos_weight positional, as the reference's __call__ takes them), kwargs)
CASES = {
    'l2': (lambda L: L.L2Loss(), [REG_LAB], {}),
    'l2_weighted': (lambda L: L.L2Loss(weight=0.5), [REG_LAB, SW], {}),
    'l1': (lambda L: L.L1Loss(), [REG_LAB], {}),
    'sigmoid_bce_logits': (lambda L: L.SigmoidBCELoss(), [BINARY], {}),
    'sigmoid_bce_pos_weight': (lambda L: L.SigmoidBinaryCrossEntropyLoss(),
                               [BINARY, None, POS[:1]], {}),
    'sigmoid_bce_probs': (lambda L: L.SigmoidBCELoss(from_sigmoid=True),
                          [BINARY], {}),
    'softmax_ce_sparse': (lambda L: L.SoftmaxCrossEntropyLoss(), [CLS], {}),
    'softmax_ce_dense': (lambda L: L.SoftmaxCELoss(sparse_label=False),
                         [DIST], {}),
    'softmax_ce_from_logits': (lambda L: L.SoftmaxCELoss(from_logits=True),
                               [CLS], {}),
    'kl_div': (lambda L: L.KLDivLoss(), [DIST], {}),
    'kl_div_softmax': (lambda L: L.KLDivLoss(from_logits=False), [DIST],
                       {}),
    'huber': (lambda L: L.HuberLoss(rho=0.7), [REG_LAB, SW], {}),
    'hinge': (lambda L: L.HingeLoss(), [SIGNED], {}),
    'squared_hinge': (lambda L: L.SquaredHingeLoss(margin=1.5), [SIGNED],
                      {}),
    'logistic_signed': (lambda L: L.LogisticLoss(), [SIGNED], {}),
    'logistic_binary': (lambda L: L.LogisticLoss(label_format='binary'),
                        [BINARY], {}),
    'triplet': (lambda L: L.TripletLoss(margin=0.5),
                [REG_LAB, REG_LAB[::-1].copy()], {}),
    'poisson_nll': (lambda L: L.PoissonNLLLoss(), [POS], {}),
    'poisson_nll_full': (lambda L: L.PoissonNLLLoss(from_logits=False,
                                                    compute_full=True),
                         [POS], {}),
    'cosine_embedding': (lambda L: L.CosineEmbeddingLoss(margin=0.1),
                         [REG_LAB, SIGNED[:, 0].copy()], {}),
}


def _run(mx, make, extra, kwargs, pred, ctx=None):
    x = mx.nd.array(pred, ctx=ctx)
    x.attach_grad()
    args = [None if a is None else mx.nd.array(a, ctx=ctx) for a in extra]
    kw = {k: mx.nd.array(v, ctx=ctx) for k, v in kwargs.items()}
    with mx.autograd.record():
        loss = make(mx.gluon.loss)(x, *args, **kw)
    loss.backward()
    return loss.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize('name', sorted(CASES))
def test_loss_matches_jax(name):
    make, extra, kwargs = CASES[name]
    pred = PROB if name in ('sigmoid_bce_probs',) else (
        np.abs(PRED) + 0.1 if name == 'poisson_nll_full' else PRED)
    want = _run(jmx, make, extra, kwargs, pred)
    with pmx.cpu():
        got = _run(pmx, make, extra, kwargs, pred)
    for g, w, what in zip(got, want, ('loss', 'grad')):
        assert g.shape == w.shape, (name, what)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg='%s %s' % (name, what))


@pytest.mark.parametrize('layout', ['NTC', 'TNC'])
def test_ctc_loss_matches_jax(layout):
    rs = np.random.RandomState(1)
    acts = rs.randn(2, 7, 5).astype('float32')          # N, T, C
    if layout == 'TNC':
        acts = acts.transpose(1, 0, 2).copy()
    label = np.array([[1, 2, 2], [3, 1, 0]], np.float32)  # 0-padded
    outs = []
    for mx, ctx in ((jmx, None), (pmx, pmx.cpu())):
        c = ctx or jmx.cpu()
        with c:
            x = mx.nd.array(acts)
            x.attach_grad()
            with mx.autograd.record():
                loss = mx.gluon.loss.CTCLoss(layout=layout)(
                    x, mx.nd.array(label))
            loss.backward()
            outs.append((loss.asnumpy(), x.grad.asnumpy()))
    (jl, jg), (pl, pg) = outs
    np.testing.assert_allclose(pl, jl, rtol=TOL)
    np.testing.assert_allclose(pg, jg, rtol=0, atol=TOL * np.abs(jg).max())


def test_zoo_names_are_the_jax_names():
    from mxnet_tpu.gluon import loss as jl
    from mxnet_tpu_torch.gluon import loss as pl
    assert sorted(pl.__all__) == sorted(jl.__all__)
