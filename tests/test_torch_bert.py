"""Port parity: the BERT pretraining slice of the port (model, MLM + NSP
loss, AdamW, ``ParallelTrainer.step``) against the JAX package's.

One tiny BERT (2 layers, units 32, hidden 64, 2 heads, vocab 50,
max_length 16, dropout 0) is built in the JAX package with
``MXNET_TPU_PALLAS=attention,epilogue,xent`` (its flash-attention,
epilogue and softmax-xent kernels run in the Pallas interpreter; the
pooler's tanh takes the act kernels' save-output core, as in the port), filled with numpy-seeded weights,
and carried into the port by ``bert.params_from_jax``. The JAX side runs
once per module (forward, ``autograd.record()`` gradients, three
``ParallelTrainer`` AdamW steps); the port's tests compare against it.
``valid_length`` is [8, 5], so the second sequence's padded keys are
masked in every layer.

Tolerances, all float32:
  * forward outputs: 2e-5 absolute on O(1) values -- two layers of
    matmuls, LayerNorms and a blockwise attention softmax summed in
    another order;
  * gradients: 1e-4 relative to each gradient's max abs -- the backward
    sums over every token and, for the tied word embedding, over both
    uses;
  * losses over three AdamW steps: 1e-5 relative; parameters after them:
    2e-5 absolute (three updates move a weight by ~3 lr = 3e-3, and Adam
    divides by sqrt(v) + eps, which amplifies the gradient's rounding).
    The key bias is the exception: its exact gradient is 0, so Adam
    turns rounding noise into steps of ~lr either way, and its entries
    are held only to the steps' size.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import autograd, config, nd
from mxnet_tpu import parallel as jax_parallel
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo import bert as jax_bert
from mxnet_tpu_torch import parallel as port_parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon.model_zoo import bert as port_bert
from mxnet_tpu_torch.ops import kernels

torch.set_num_threads(1)

CFG = dict(vocab_size=50, max_length=16, units=32, hidden_size=64,
           num_layers=2, num_heads=2, dropout=0.0)
VOCAB = CFG['vocab_size']
HYPER = {'learning_rate': 1e-3, 'wd': 0.01}
STEPS = 3
FWD_TOL = 2e-5
GRAD_REL = 1e-4
LOSS_REL = 1e-5
PARAM_TOL = 2e-5


def _batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, VOCAB, (2, 8)).astype('float32')
    tt = (rs.rand(2, 8) > 0.5).astype('float32')
    vl = np.array([8, 5], 'float32')
    mp = rs.randint(0, 8, (2, 3)).astype('float32')
    mlm_y = rs.randint(0, VOCAB, (2, 3)).astype('float32')
    nsp_y = rs.randint(0, 2, (2,)).astype('float32')
    return [ids, tt, vl, mp], [mlm_y, nsp_y]


def _weights(names_shapes):
    """Random weights from a numpy seed: every tensor, biases and
    LayerNorm affines included, so each path carries a signal."""
    rs = np.random.RandomState(1)
    out = {}
    for name, shape in names_shapes:
        w = rs.randn(*shape).astype('float32')
        if name.endswith('gamma'):
            out[name] = 1.0 + 0.1 * w
        elif name.endswith(('bias', 'beta')):
            out[name] = 0.1 * w
        else:
            out[name] = 0.2 * w
    return out


def _pretrain_loss(L, reshape):
    def fn(outs, labels):
        _, _, mlm, nsp = outs
        my, ny = labels
        return (L(reshape(mlm, (-1, VOCAB)), reshape(my, (-1,))).mean()
                + L(nsp, ny).mean())
    return fn


@pytest.fixture(scope='module')
def ref():
    """Everything the JAX package computes for the slice, as numpy."""
    config.set('MXNET_TPU_PALLAS', 'attention,epilogue,xent')
    try:
        net = jax_bert.get_bert(**CFG)
        net.initialize(mx.init.Xavier())
        x, y = _batch()
        xs, ys = [nd.array(a) for a in x], [nd.array(a) for a in y]
        net(*xs)                                    # deferred shapes
        params = net.collect_params()
        weights = _weights([(n, p.shape) for n, p in params.items()])
        for n, p in params.items():
            p.set_data(nd.array(weights[n]))
        outs = [o.asnumpy() for o in net(*xs)]
        loss_fn = _pretrain_loss(jax_loss.SoftmaxCrossEntropyLoss(),
                                 lambda a, s: a.reshape(s))
        with autograd.record():
            loss = loss_fn(net(*xs), ys)
        loss.backward()
        grads = {n: p.grad().asnumpy() for n, p in params.items()}
        mesh = jax_parallel.create_mesh({'dp': 1},
                                        devices=jax.devices()[:1])
        pt = jax_parallel.ParallelTrainer(net, loss_fn, 'adamw',
                                          dict(HYPER), mesh)
        losses = [float(pt.step(xs, ys).asnumpy()) for _ in range(STEPS)]
        after = {n: p.data().asnumpy() for n, p in params.items()}
    finally:
        config.unset('MXNET_TPU_PALLAS')
    return dict(weights=weights, outs=outs, loss=float(loss.asnumpy()),
                grads=grads, losses=losses, after=after)


def _port_net(ref):
    net = port_bert.get_bert(device='cpu', **CFG)
    return port_bert.params_from_jax(ref['weights'], net)


def _port_loss_fn():
    return _pretrain_loss(port_loss.SoftmaxCrossEntropyLoss(),
                          lambda a, s: a.reshape(s))


def _short(name):
    return name.split('_', 1)[1]


def _inputs():
    x, y = _batch()
    return [torch.tensor(a) for a in x], [torch.tensor(a) for a in y]


def test_every_jax_parameter_maps_to_one_port_parameter(ref):
    net = _port_net(ref)
    mine = net.collect_params().tensors()
    jax_names = sorted(ref['weights'])
    assert all(n.startswith('bertmodel') for n in jax_names)
    assert sorted(_short(n) for n in jax_names) == sorted(mine)
    assert len(mine) == len(jax_names) == 46
    for n in jax_names:
        assert tuple(mine[_short(n)].shape) == ref['weights'][n].shape
    # the MLM decoder is tied: one Parameter, listed once
    assert 'decoder_weight' not in mine and \
        net.word_embed.weight is mine['word_weight']
    # a missing or unknown name is refused
    partial = dict(ref['weights'])
    partial.pop(jax_names[0])
    with pytest.raises(ValueError, match='missing'):
        port_bert.params_from_jax(partial, net)
    partial[jax_names[0] + '_extra'] = ref['weights'][jax_names[0]]
    with pytest.raises(ValueError, match='unknown'):
        port_bert.params_from_jax(partial, net)


def test_forward_matches_jax(ref):
    net = _port_net(ref)
    xs, _ = _inputs()
    with torch.no_grad():
        outs = net(*xs)
    assert [tuple(o.shape) for o in outs] == \
        [(2, 8, 32), (2, 32), (2, 3, VOCAB), (2, 2)]
    for name, a, b in zip(('seq', 'pooled', 'mlm', 'nsp'), outs,
                          ref['outs']):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=FWD_TOL,
                                   err_msg=name)


def test_step0_gradients_match_jax(ref):
    net = _port_net(ref)
    xs, ys = _inputs()
    kernels.reset_launch_counts()
    loss = _port_loss_fn()(net(*xs), ys)
    loss.backward()
    assert abs(loss.item() - ref['loss']) <= LOSS_REL * abs(ref['loss'])
    mine = net.collect_params().tensors()
    for n, want in ref['grads'].items():
        p = mine[_short(n)]
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        tol = GRAD_REL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=n)
    # cross-attention projections are owned but unused: zero gradient
    assert not ref['grads']['bertmodel0_enc_layer0_attn_query_weight'].any()
    # CPU tensors take the plain versions: no kernel launch counted
    assert not any(kernels.launch_counts().values())


def test_three_adamw_steps_match_jax(ref):
    net = _port_net(ref)
    xs, ys = _inputs()
    pt = port_parallel.ParallelTrainer(net, _port_loss_fn(), 'adamw',
                                       dict(HYPER))
    losses = [pt.step(xs, ys).item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref['losses'], rtol=LOSS_REL, atol=0)
    assert losses[-1] < losses[0]
    assert pt.num_update == STEPS and pt.learning_rate == 1e-3
    mine = net.collect_params().tensors()
    for n, want in ref['after'].items():
        got = mine[_short(n)].detach().numpy()
        if n.endswith('attn_qkv_bias'):
            # the key bias shifts every score of a query by the same
            # amount, so its exact gradient is 0 and both frameworks
            # see rounding noise, which Adam scales to steps of ~lr in
            # either direction: bound those entries by the steps' size
            u = CFG['units']
            np.testing.assert_allclose(got[u:2 * u], want[u:2 * u], rtol=0,
                                       atol=2 * STEPS * HYPER['learning_rate'],
                                       err_msg=n)
            got, want = np.delete(got, np.s_[u:2 * u]), \
                np.delete(want, np.s_[u:2 * u])
        np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_TOL,
                                   err_msg=n)
    # weight decay reached a parameter with no gradient at all
    q = mine['enc_layer0_attn_query_weight'].detach().numpy()
    w0 = ref['weights']['bertmodel0_enc_layer0_attn_query_weight']
    assert np.abs(q).sum() < np.abs(w0).sum()


def test_trainer_refuses_what_is_not_ported(ref):
    net = _port_net(ref)
    fn = _port_loss_fn()
    tail = 'multi-GPU, robustness layers and the tail'
    for kw, item in (({'mesh': {'dp': 2}}, 'mesh of 2 devices.*' + tail),
                     ({'zero': True}, 'ZeRO.*' + tail),
                     ({'guardrail': True}, 'guardrail.*' + tail),
                     ({'amp': 'fp16'}, 'loss scaling.*guardrail.*' + tail)):
        with pytest.raises(NotImplementedError, match=item):
            port_parallel.ParallelTrainer(net, fn, 'adamw', dict(HYPER),
                                          **kw)
    port_parallel.ParallelTrainer(net, fn, 'adamw', dict(HYPER),
                                  mesh={'dp': 1})


def test_dropout_draws_from_the_trainers_generator(ref):
    """With dropout on, two trainers seeded alike take the same step and
    the global RNG is untouched."""
    xs, ys = _inputs()
    cfg = dict(CFG, dropout=0.1)
    losses = []
    state = torch.random.get_rng_state()
    for _ in range(2):
        net = port_bert.params_from_jax(
            ref['weights'], port_bert.get_bert(device='cpu', **cfg))
        pt = port_parallel.ParallelTrainer(net, _port_loss_fn(), 'adamw',
                                           dict(HYPER), seed=7)
        losses.append([pt.step(xs, ys).item() for _ in range(2)])
    assert losses[0] == losses[1]
    assert losses[0][0] != pytest.approx(ref['losses'][0], rel=1e-6)
    assert torch.equal(torch.random.get_rng_state(), state)
