"""Port parity: the fused softmax-xent head of the port (the forward and
backward kernels behind ``SoftmaxXentFunction``) against
``fused_softmax_xent_rows`` of the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions and the
JAX kernels run through the Pallas interpreter, with
``MXNET_TPU_PALLAS=attention,xent`` set as the JAX package's own tests set
it. Logits, labels and cotangents come from a numpy seed and go to both.
Tolerance: 1e-6 absolute. Both sides compute the same float32
expressions per row (max, exp-sum, log, subtract); only the order of the
exp-sum differs, which moves ``logp`` by a few ulps of ``log z``.

The kernels themselves (CUDA, sm_90a) run only on the card: the test
marked ``cuda`` in ``test_torch_attention_bwd.py`` compares them with
their plain versions there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import config, nd
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.ops.pallas import xent as jax_xent
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops import nn as port_nn

torch.set_num_threads(1)
TOL = 1e-6


@pytest.fixture(scope='module', autouse=True)
def kernels_on():
    config.set('MXNET_TPU_PALLAS', 'attention,xent')
    yield
    config.unset('MXNET_TPU_PALLAS')


def _case(seed, rows, v):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(rows, v) * 3).astype('float32')
    labels = rs.randint(0, v, rows).astype('int32')
    labels[rows // 2] = v          # out of range: matches no class
    g = rs.randn(rows).astype('float32')
    return logits, labels, g


def _jax_nll_and_vjp(logits, labels, g):
    nll, vjp = jax.vjp(
        lambda x: jax_xent.fused_softmax_xent_rows(x, jnp.asarray(labels)),
        jnp.asarray(logits))
    return np.asarray(nll), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize('rows,v', [(13, 2), (5, 100), (19, 257)])
@pytest.mark.parametrize('g_kind', ['row', 'scalar'])
def test_fused_xent_matches_jax(rows, v, g_kind):
    logits, labels, g = _case(rows * v, rows, v)
    if g_kind == 'scalar':
        g = np.full((rows,), 0.37, 'float32')
    want_nll, want_dx = _jax_nll_and_vjp(logits, labels, g)

    x = torch.tensor(logits, requires_grad=True)
    nll = kernels.fused_softmax_xent_rows(x, torch.tensor(labels))
    np.testing.assert_allclose(nll.detach().numpy(), want_nll, rtol=0,
                               atol=TOL)
    assert nll[rows // 2].item() == 0.0   # the out-of-range label
    gt = torch.tensor(g)
    if g_kind == 'scalar':
        # a scalar cotangent reaches the backward as one number
        (dx,) = torch.autograd.grad(nll.sum() * 0.37, x)
        _, logp = kernels.softmax_xent_forward(x.detach(),
                                               torch.tensor(labels))
        direct = kernels.softmax_xent_backward(logp, torch.tensor(labels),
                                               0.37)
        np.testing.assert_allclose(direct.numpy(), want_dx, rtol=0, atol=TOL)
    else:
        (dx,) = torch.autograd.grad(nll, x, gt)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=0, atol=TOL)
    # the out-of-range row's gradient is g times the softmax alone (no
    # -1 term)
    r = rows // 2
    soft = torch.softmax(torch.tensor(logits[r]), dim=0) * float(g[r])
    np.testing.assert_allclose(dx[r].numpy(), soft.numpy(), rtol=0,
                               atol=TOL)


def test_float_labels_truncate_as_astype_int32():
    logits, labels, _ = _case(3, 6, 10)
    flabels = labels.astype('float32') + 0.75
    want, _ = _jax_nll_and_vjp(logits, flabels, np.ones(6, 'float32'))
    got = kernels.fused_softmax_xent_rows(torch.tensor(logits),
                                          torch.tensor(flabels))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_plain_backward_matches_autograd_of_reference():
    """In-range labels only: for a label outside [0, V) the closed form
    (the TPU kernel's and the port's) still gives g * softmax, while
    autograd of the constant 0 nll gives 0."""
    logits, labels, g = _case(7, 11, 37)
    labels[11 // 2] = 3
    x = torch.tensor(logits, requires_grad=True)
    lab = torch.tensor(labels)
    nll = kernels.fused_softmax_xent_rows_reference(x, lab)
    (auto,) = torch.autograd.grad(nll, x, torch.tensor(g))
    _, logp = kernels.softmax_xent_forward_reference(x.detach(), lab)
    plain = kernels.softmax_xent_backward_reference(logp, lab,
                                                    torch.tensor(g))
    np.testing.assert_allclose(plain.numpy(), auto.numpy(), rtol=0,
                               atol=TOL)


def test_loss_block_takes_the_fused_head_and_counts_nothing_on_cpu():
    """SoftmaxCrossEntropyLoss (sparse labels, from logits) reduces the
    fused head's (rows, 1) nll to (rows,) as the JAX loss does."""
    kernels.reset_launch_counts()
    logits, labels, _ = _case(5, 4, 3)
    pred = torch.tensor(logits.reshape(2, 2, 3))
    got = port_loss.SoftmaxCrossEntropyLoss()(pred, torch.tensor(
        labels.reshape(2, 2)))
    want, _ = _jax_nll_and_vjp(logits, labels, np.ones(4, 'float32'))
    np.testing.assert_allclose(got.numpy(), want.reshape(2, 2).mean(1),
                               rtol=0, atol=TOL)
    head = port_nn.fused_softmax_xent(pred, torch.tensor(labels))
    assert head.shape == (2, 2, 1)
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize('kw,pred_shape', [
    (dict(), (6, 9)),
    (dict(from_logits=True, weight=2.0), (6, 9)),
    (dict(sparse_label=False), (6, 9)),
    (dict(axis=1), (4, 5, 3)),
])
def test_softmax_ce_loss_matches_jax(kw, pred_shape):
    """Every branch of the loss block: the fused head, from-logits,
    dense labels and another class axis, with a sample weight."""
    rs = np.random.RandomState(len(kw))
    pred = rs.randn(*pred_shape).astype('float32')
    if kw.get('from_logits'):
        pred = np.log(np.exp(pred) / np.exp(pred).sum(-1, keepdims=True))
    axis = kw.get('axis', -1)
    classes = pred_shape[axis]
    if kw.get('sparse_label', True):
        lead = tuple(np.delete(pred_shape, axis % len(pred_shape)))
        label = rs.randint(0, classes, lead).astype('float32')
    else:
        label = rs.rand(*pred_shape).astype('float32')
        label /= label.sum(-1, keepdims=True)
    sw = rs.rand(pred_shape[0], 1).astype('float32')
    want = jax_loss.SoftmaxCrossEntropyLoss(**kw)(
        nd.array(pred), nd.array(label), nd.array(sw)).asnumpy()
    got = port_loss.SoftmaxCrossEntropyLoss(**kw)(
        torch.tensor(pred), torch.tensor(label), torch.tensor(sw))
    assert tuple(got.shape) == want.shape == (pred_shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_wrappers_reject_other_devices_and_bad_shapes():
    x = torch.zeros(4, 3, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.softmax_xent_forward(x, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.softmax_xent_backward(x, torch.zeros(4, dtype=torch.int32),
                                      1.0)
    with pytest.raises(ValueError, match='expected \\(rows, V\\)'):
        kernels.softmax_xent_forward(torch.zeros(3), torch.zeros(3))
