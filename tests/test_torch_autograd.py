"""The port's imperative autograd (``mxnet_tpu_torch/autograd.py``)
against the JAX package's, on the CPU: the cases of
``tests/test_autograd.py``, each run through both packages on the same
inputs, each package held to the case's own expectation and the two to
each other within 1e-6 (float32 tolerance: the ops agree to a few ULPs,
tests/test_torch_ops_registry.py).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx

TOL = 1e-6


def _simple_grad(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with ag.record():
        y = (x * x).sum()
    y.backward()
    assert np.allclose(x.grad.asnumpy(), 2 * x.asnumpy())
    return [x.grad.asnumpy()]


def _chain(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array([0.5, 1.0])
    x.attach_grad()
    with ag.record():
        y = nd.exp(nd.sin(x)).sum()
    y.backward()
    expected = np.exp(np.sin(x.asnumpy())) * np.cos(x.asnumpy())
    assert np.allclose(x.grad.asnumpy(), expected, atol=1e-5)
    return [x.grad.asnumpy(), y.asnumpy()]


def _multi_variable(mx):
    nd, ag = mx.nd, mx.autograd
    a, b = nd.array([2.0]), nd.array([3.0])
    a.attach_grad()
    b.attach_grad()
    with ag.record():
        c = a * b + a
    c.backward()
    assert np.allclose(a.grad.asnumpy(), [4.0])
    assert np.allclose(b.grad.asnumpy(), [2.0])
    return [a.grad.asnumpy(), b.grad.asnumpy()]


def _reuse_variable(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array([3.0])
    x.attach_grad()
    with ag.record():
        y = x * x * x
    y.backward()
    assert np.allclose(x.grad.asnumpy(), [27.0])
    return [x.grad.asnumpy()]


def _head_gradient(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    with ag.record():
        y = x * 2
    y.backward(nd.array([10.0, 100.0]))
    assert np.allclose(x.grad.asnumpy(), [20.0, 200.0])
    return [x.grad.asnumpy()]


def _grad_req_add(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array([1.0])
    x.attach_grad(grad_req='add')
    for _ in range(3):
        with ag.record():
            y = x * 2
        y.backward()
    assert np.allclose(x.grad.asnumpy(), [6.0])
    return [x.grad.asnumpy()]


def _write_overwrites(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array([1.0])
    x.attach_grad()
    for _ in range(3):
        with ag.record():
            y = x * 2
        y.backward()
    assert np.allclose(x.grad.asnumpy(), [2.0])
    return [x.grad.asnumpy()]


def _detach_blocks(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array([2.0])
    x.attach_grad()
    with ag.record():
        y = x * x
        z = y.detach() * x
    z.backward()
    assert np.allclose(x.grad.asnumpy(), [4.0])
    return [x.grad.asnumpy()]


def _stop_gradient_op(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array([2.0])
    x.attach_grad()
    with ag.record():
        y = nd.BlockGrad(x * x) * x
    y.backward()
    assert np.allclose(x.grad.asnumpy(), [4.0])
    return [x.grad.asnumpy()]


def _is_recording_training(mx):
    ag = mx.autograd
    seen = [ag.is_recording(), ag.is_training()]
    with ag.record():
        seen += [ag.is_recording(), ag.is_training()]
        with ag.predict_mode():
            seen.append(ag.is_training())
    with ag.record(train_mode=False):
        seen.append(ag.is_training())
    with ag.pause():
        seen.append(ag.is_recording())
    with ag.train_mode():
        seen.append(ag.is_training())
    assert seen == [False, False, True, True, False, False, False, True]
    return [np.array(seen)]


def _grad_api(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array([2.0])
    with ag.record():
        x.attach_grad()
        y = x * x
    g = ag.grad(y, x)
    assert np.allclose(g.asnumpy(), [4.0])
    return [g.asnumpy()]


def _grad_create_graph(mx):
    """Second order: d/dx of (dy/dx * x) for y = x^3 is 9 x^2."""
    nd, ag = mx.nd, mx.autograd
    x = nd.array([1.0, 2.0, -0.5])
    x.attach_grad()
    with ag.record():
        y = x * x * x
        d1 = ag.grad(y, x, create_graph=True)
        z = (d1 * x).sum()
    z.backward()
    assert np.allclose(d1.asnumpy(), 3 * x.asnumpy() ** 2)
    assert np.allclose(x.grad.asnumpy(), 9 * x.asnumpy() ** 2)
    return [d1.asnumpy(), x.grad.asnumpy()]


def _mark_variables(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array([1.0, 2.0])
    g = nd.zeros((2,))
    ag.mark_variables([x], [g])
    with ag.record():
        y = (x * x).sum()
    y.backward()
    assert np.allclose(x.grad.asnumpy(), [2.0, 4.0])
    return [x.grad.asnumpy()]


def _custom_function(mx):
    nd, ag = mx.nd, mx.autograd

    class Sigmoid(ag.Function):
        def forward(self, x):
            y = nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    x = nd.array([0.0, 1.0])
    x.attach_grad()
    with ag.record():
        y = Sigmoid()(x)
    y.backward()
    s = 1 / (1 + np.exp(-x.asnumpy()))
    assert np.allclose(x.grad.asnumpy(), s * (1 - s), atol=1e-6)
    return [y.asnumpy(), x.grad.asnumpy()]


def _softmax_output_grad(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.array(np.random.RandomState(0).randn(4, 3).astype('f'))
    label = nd.array([0, 1, 2, 1])
    x.attach_grad()
    with ag.record():
        out = nd.SoftmaxOutput(x, label)
    out.backward()
    sm = out.asnumpy()
    oh = np.eye(3)[label.asnumpy().astype(int)]
    assert np.allclose(x.grad.asnumpy(), sm - oh, atol=1e-6)
    return [out.asnumpy(), x.grad.asnumpy()]


def _dropout_modes(mx):
    nd, ag = mx.nd, mx.autograd
    x = nd.ones((100, 100))
    with ag.record(train_mode=False):
        y = nd.Dropout(x, p=0.5)
    assert np.allclose(y.asnumpy(), 1.0)
    with ag.record(train_mode=True):
        y = nd.Dropout(x, p=0.5)
    frac = (y.asnumpy() == 0).mean()
    assert 0.4 < frac < 0.6
    kept = y.asnumpy()[y.asnumpy() != 0]
    assert np.allclose(kept, 2.0)
    return []                 # the masks are each package's own bits


def _outside_record_no_graph(mx):
    """Outside record() nothing is recorded, even on a marked array."""
    nd, ag = mx.nd, mx.autograd
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * x
    with ag.record():
        z = (x * 3).sum()
    z.backward()
    assert np.allclose(x.grad.asnumpy(), [3.0, 3.0])
    return [y.asnumpy(), x.grad.asnumpy()]


CASES = {f.__name__.lstrip('_'): f for f in (
    _simple_grad, _chain, _multi_variable, _reuse_variable, _head_gradient,
    _grad_req_add, _write_overwrites, _detach_blocks, _stop_gradient_op,
    _is_recording_training, _grad_api, _grad_create_graph, _mark_variables,
    _custom_function, _softmax_output_grad, _dropout_modes,
    _outside_record_no_graph)}


@pytest.mark.parametrize('case', sorted(CASES))
def test_autograd_matches_jax(case):
    want = CASES[case](jmx)
    with pmx.cpu():
        got = CASES[case](pmx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=0,
                                   atol=TOL * max(1.0, np.abs(w).max()))


def test_nd_ops_outside_record_run_without_grad():
    """Outside record() the port's ops run under torch.no_grad(): the
    result holds no graph even for an array with a gradient attached."""
    with pmx.cpu():
        x = pmx.nd.array([1.0, 2.0])
        x.attach_grad()
        y = x * 2 + 1
        assert not y._data.requires_grad and y._data.grad_fn is None
        with pmx.autograd.record():
            z = x * 2
        assert z._data.grad_fn is not None


def test_grad_fresh_marks_written_leaves():
    """backward() sets the written leaves' fresh mark, for the Trainer's
    stale-gradient check; an unreached leaf keeps its mark off."""
    with pmx.cpu():
        a, b = pmx.nd.array([1.0]), pmx.nd.array([2.0])
        a.attach_grad()
        b.attach_grad()
        with pmx.autograd.record():
            y = a * 3
        y.backward()
        assert a._grad_fresh and not b._grad_fresh


def test_no_card_no_cpu_context_raises():
    """With no card and no CPU asked for, creating an array raises (the
    port never falls back to the CPU by itself)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default context resolves')
    with pytest.raises(RuntimeError, match='CUDA'):
        pmx.nd.array([1.0])
