"""Port parity: BERT trained the way ``bench_bert`` trains it on the
accelerator -- after ``net.cast('bfloat16')``, no AMP, AdamW on bf16
weights, without and with ``multi_precision`` (bench.py:261-306) --
against the JAX package's.

The net is the bench's CPU BERT (bench.py:278-281: 2 layers, units 32,
hidden 64, 4 heads, vocab 100, max_length 32) at dropout 0 (the JAX
package's threefry masks cannot be drawn in PyTorch), with numpy-seeded
weights carried over by ``params_from_jax`` and the bench's CPU batch
(2 x 16 tokens, 2 masked, bench.py:291-296). The JAX side runs with
``MXNET_TPU_PALLAS=attention,epilogue,xent``, its kernels in the Pallas
interpreter as its own tests run them; with the xent family on, the
loss comes out bf16 in both packages (without it the JAX loss is
float32). Its forward and step-0 gradients are traced as its trainer
traces them (``pure_forward_fn`` under ``jax.value_and_grad``), and its
``ParallelTrainer`` takes three AdamW steps (lr 1e-4, wd 0.01).

Tolerances, no looser than ``tests/test_torch_resnet_bf16.py`` holds the
cast ResNet to:
  * the cast parameters: bitwise the JAX net's, all bf16;
  * the step-0 loss within rtol 1e-2 (measured 2e-3), outputs and loss
    bf16;
  * the step-0 gradients, bf16: no farther (whole-net L2) from the JAX
    package's bf16 gradients than those lie from its float32 ones
    (measured 0.0123 against 0.0136), cosine >= 0.9;
  * three trainer steps: losses within rtol 6e-2 (measured 1.1e-2, one
    bf16 ULP of a loss near 5.5); the AdamW state (and the masters)
    within 6e-2 (whole-net L2, relative; measured 1.2e-2), its dtypes
    the JAX package's; the weights' update pointing the same way (cosine
    >= 0.9): Adam's normalized step turns the bf16 noise of a near-zero
    gradient into a full step either way (whole-net L2 of the updates'
    difference measured 0.13);
  * one "Accumulating with bfloat16" warning a parameter without
    ``multi_precision``, as many as the JAX package gives, none with it;
  * dropout on bf16: ``data * mask / keep`` with ``keep`` taking bf16,
    byte for byte the JAX expression on the port's mask, forward and
    backward.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import config, nd
from mxnet_tpu import parallel as jax_parallel
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo import bert as jax_bert
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu.parallel.train_step import pure_forward_fn
from mxnet_tpu_torch import parallel as port_parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon.model_zoo import bert as port_bert
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops import nn as port_nn

torch.set_num_threads(1)

BF = torch.bfloat16
CFG = dict(vocab_size=100, max_length=32, units=32, hidden_size=64,
           num_layers=2, num_heads=4, dropout=0.0)
VOCAB = CFG['vocab_size']
HYPER = {'learning_rate': 1e-4, 'wd': 0.01}
STEPS = 3
LOSS_RTOL = 1e-2
TRAJ_RTOL = 6e-2
FORMS = ('cast', 'cast_mp')


def _batch():
    """bench.py:291-296 at the CPU sizes: batch 2, 16 tokens, 2 masked."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, VOCAB, (2, 16)).astype('float32')
    tt = (rs.rand(2, 16) > 0.5).astype('float32')
    vl = np.full((2,), 16, np.float32)
    mp = rs.randint(0, 16, (2, 2)).astype('float32')
    mlm_y = rs.randint(0, VOCAB, (2, 2)).astype('float32')
    nsp_y = rs.randint(0, 2, (2,)).astype('float32')
    return [ids, tt, vl, mp], [mlm_y, nsp_y]


def _weights(names_shapes):
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


def _pretrain_loss(L):
    def fn(outs, labels):
        _, _, mlm, nsp = outs
        my, ny = labels
        return (L(mlm.reshape((-1, VOCAB)), my.reshape((-1,))).mean()
                + L(nsp, ny).mean())
    return fn


def _short(name):
    return name.split('_', 1)[1]


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _jax_net(weights, cast):
    net = jax_bert.get_bert('bert_12_768_12', **CFG)
    net.initialize(mx.init.Xavier())
    net(*[nd.array(a) for a in _batch()[0]])        # deferred shapes
    for n, p in net.collect_params().items():
        p.set_data(nd.array(weights[_short(n)]))
    if cast:
        net.cast('bfloat16')
    return net


def _jax_step0(weights, cast):
    """Loss, output dtypes and gradients as the trainer traces them."""
    net = _jax_net(weights, cast)
    fwd, _, plist = pure_forward_fn(net, training=True)
    x, y = _batch()
    loss_fn = _pretrain_loss(jax_loss.SoftmaxCrossEntropyLoss())

    def loss_of(pa):
        outs, _ = fwd(jax.random.PRNGKey(0), list(pa),
                      [jnp.asarray(a) for a in x])
        loss = loss_fn([NDArray(o) for o in outs],
                       [NDArray(jnp.asarray(a)) for a in y])
        return jnp.mean(loss._data), outs

    (loss, outs), grads = jax.value_and_grad(loss_of, has_aux=True)(
        [p.data()._data for p in plist])
    return dict(loss=float(_f32(loss)), loss_dtype=str(loss.dtype),
                out_dtypes=[str(o.dtype) for o in outs],
                params={_short(p.name): p.data()._data for p in plist},
                grads={_short(p.name): _f32(g) for p, g in zip(plist, grads)},
                grad_dtypes={_short(p.name): str(g.dtype)
                             for p, g in zip(plist, grads)})


def _jax_train(weights, mp):
    net = _jax_net(weights, True)
    x, y = _batch()
    mesh = jax_parallel.create_mesh({'dp': 1}, devices=jax.devices()[:1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        pt = jax_parallel.ParallelTrainer(
            net, _pretrain_loss(jax_loss.SoftmaxCrossEntropyLoss()),
            'adamw', dict(HYPER, multi_precision=mp), mesh)
        losses = [float(_f32(pt.step([nd.array(a) for a in x],
                                     [nd.array(a) for a in y]).asnumpy()))
                  for _ in range(STEPS)]
    return dict(losses=losses,
                warnings=sum('Accumulating with bfloat16' in str(c.message)
                             for c in caught),
                after=[_f32(a) for a in pt._param_arrays],
                leaves=[_f32(a) for a in pt._state_leaves],
                leaf_dtypes=sorted({str(a.dtype) for a in pt._state_leaves}),
                param_dtypes=sorted({str(a.dtype)
                                     for a in pt._param_arrays}))


@pytest.fixture(scope='module')
def ref():
    config.set('MXNET_TPU_PALLAS', 'attention,epilogue,xent')
    try:
        net = jax_bert.get_bert('bert_12_768_12', **CFG)
        net.initialize(mx.init.Xavier())
        net(*[nd.array(a) for a in _batch()[0]])
        weights = _weights([(_short(n), p.shape)
                            for n, p in net.collect_params().items()])
        out = dict(weights=weights, f32=_jax_step0(weights, False),
                   bf16=_jax_step0(weights, True))
        for form in FORMS:
            out[form] = _jax_train(weights, form == 'cast_mp')
    finally:
        config.unset('MXNET_TPU_PALLAS')
    return out


def _port_net(ref):
    net = port_bert.get_bert(device='cpu', **CFG)
    port_bert.params_from_jax(ref['weights'], net)
    return net.cast('bfloat16')


def _inputs():
    x, y = _batch()
    return [torch.tensor(a) for a in x], [torch.tensor(a) for a in y]


def test_cast_parameters_equal_jax_bitwise(ref):
    mine = _port_net(ref).collect_params().tensors()
    theirs = ref['bf16']['params']
    assert sorted(mine) == sorted(theirs)
    for n, want in theirs.items():
        assert mine[n].dtype == BF and str(want.dtype) == 'bfloat16', n
        assert torch.equal(mine[n].detach().float(),
                           torch.from_numpy(_f32(want))), n


def _flat(grads, names):
    return np.concatenate([np.asarray(grads[n], np.float64).ravel()
                           for n in names])


def test_loss_and_step0_gradients_match_jax(ref):
    want = ref['bf16']
    net = _port_net(ref)
    xs, ys = _inputs()
    kernels.reset_launch_counts()
    net.train(True)
    outs = net(*xs)
    loss = _pretrain_loss(port_loss.SoftmaxCrossEntropyLoss())(outs, ys)
    loss = loss.mean()
    loss.backward()
    net.train(False)
    assert [str(o.dtype).replace('torch.', '') for o in outs] \
        == want['out_dtypes'] == ['bfloat16'] * 4
    assert loss.dtype == BF and want['loss_dtype'] == 'bfloat16'
    np.testing.assert_allclose(loss.float().item(), want['loss'],
                               rtol=LOSS_RTOL)
    mine = net.collect_params().tensors()
    names = sorted(want['grads'])
    got = {}
    for n in names:
        g = mine[n].grad
        assert g is None or str(g.dtype).replace('torch.', '') \
            == want['grad_dtypes'][n], n
        got[n] = (np.zeros_like(want['grads'][n]) if g is None
                  else g.float().numpy())
    got = _flat(got, names)
    theirs, f32 = _flat(want['grads'], names), _flat(ref['f32']['grads'],
                                                      names)
    assert np.linalg.norm(got - theirs) <= np.linalg.norm(theirs - f32)
    assert got @ theirs / np.linalg.norm(got) / np.linalg.norm(theirs) \
        >= 0.9
    # CPU tensors take the plain versions: no kernel launch counted
    assert not any(kernels.launch_counts().values())


def _state_leaves(pt, mp):
    out = []
    for s in pt._states:
        out += [s[0], s[1][0], s[1][1]] if mp else [s[0], s[1]]
    return out


def _rel(got, want):
    num = sum(((a - b) ** 2).sum() for a, b in zip(got, want))
    return float(np.sqrt(num / sum((b ** 2).sum() for b in want)))


@pytest.mark.parametrize('form', FORMS)
def test_three_adamw_steps_match_jax(ref, form):
    mp = form == 'cast_mp'
    want = ref[form]
    net = _port_net(ref)
    before = [p.detach().float().numpy().copy() for p in net.parameters()]
    xs, ys = _inputs()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        pt = port_parallel.ParallelTrainer(
            net, _pretrain_loss(port_loss.SoftmaxCrossEntropyLoss()),
            'adamw', dict(HYPER, multi_precision=mp))
        losses = [pt.step(xs, ys).float().item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want['losses'], rtol=TRAJ_RTOL,
                               atol=0)
    warned = sum('Accumulating with bfloat16' in str(c.message)
                 for c in caught)
    assert warned == want['warnings'] == (0 if mp else len(before))
    assert sorted({str(p.dtype).replace('torch.', '')
                   for p in net.parameters()}) == want['param_dtypes'] \
        == ['bfloat16']
    leaves = _state_leaves(pt, mp)
    assert sorted({str(t.dtype).replace('torch.', '') for t in leaves}) \
        == want['leaf_dtypes'] == (['float32'] if mp else ['bfloat16'])
    assert _rel([t.float().numpy() for t in leaves], want['leaves']) \
        <= TRAJ_RTOL
    after = [p.detach().float().numpy() for p in net.parameters()]
    mine = np.concatenate([(a - b).ravel() for a, b in zip(after, before)])
    theirs = np.concatenate([(a - b).ravel()
                             for a, b in zip(want['after'], before)])
    assert mine @ theirs / np.linalg.norm(mine) / np.linalg.norm(theirs) \
        >= 0.9


def test_dropout_on_bf16_divides_by_keep_in_bf16_as_jax():
    """``data * mask / keep`` on bf16: the reference's ``keep`` is a weak
    Python float, bf16 0.8984375 for 0.9; forward and backward byte for
    byte the JAX expression on the port's mask."""
    rs = np.random.RandomState(4)
    x = torch.tensor(rs.randn(64, 33).astype('float32')).to(BF)
    x.requires_grad_(True)
    gen = torch.Generator().manual_seed(3)
    out = port_nn.dropout(x, 0.1, gen, training=True)
    g = torch.tensor(rs.randn(64, 33).astype('float32')).to(BF)
    out.backward(g)
    mask = (out != 0).float().numpy()
    assert 0.8 < mask.mean() < 0.97

    def jax_dropout(a, m):
        return a * m.astype(a.dtype) / (1.0 - 0.1)
    jx = jnp.asarray(x.detach().float().numpy()).astype(jnp.bfloat16)
    want, vjp = jax.vjp(lambda a: jax_dropout(a, jnp.asarray(mask)), jx)
    want_g, = vjp(jnp.asarray(g.float().numpy()).astype(jnp.bfloat16))
    assert out.dtype == x.grad.dtype == BF and str(want.dtype) == 'bfloat16'
    assert torch.equal(out.detach().float(), torch.from_numpy(_f32(want)))
    assert torch.equal(x.grad.float(), torch.from_numpy(_f32(want_g)))
