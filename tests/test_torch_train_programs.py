"""The training step's other entry points in the port -- ``step_n``,
``step_accum``, ``build``, ``snapshot`` / ``restore`` and
``set_learning_rate`` of ``ParallelTrainer`` -- against the JAX package's
(``mxnet_tpu/parallel/train_step.py``), and the hypers a captured window
resolves ahead.

The nets are the existing trainer tests' kinds: the tiny BERT of
``tests/test_torch_bert.py`` (2 layers, units 32, vocab 50, AdamW) and the
narrow v1 ResNet of ``tests/test_torch_resnet.py`` (``[2, 1, 1, 1]`` x
``[8, 16, 32, 64, 128]``, 10 classes, SGD with momentum at lr 0.001), with
numpy-seeded weights carried into the port by ``params_from_jax``. The
JAX side runs its plain ops (the Pallas knob off). On the CPU every body
of the port runs uncaptured, the plain version of the CUDA graphs a card
replays; the ``cuda``-marked test holds the captured steps against the
eager bodies on a card and skips here.

Tolerances are the ones the trainer tests hold a step to: BERT losses
1e-5 relative and parameters 2e-5 absolute (``tests/test_torch_bert.py``),
the attention key bias (exact gradient 0, so AdamW turns rounding noise
into steps of ~lr) held to the steps' size; ResNet losses 1e-4 relative
(``tests/test_torch_resnet_sgd.py``'s one-step tier: a new batch a step
moves the BatchNorm statistics, and the second loss parts by 1.2e-5) and
parameters 5e-5 absolute (``tests/test_torch_resnet.py``).
``step_accum`` is also held to one step on the full batch at the
reference's own bar (``tests/test_elastic.py:295-305``: loss 1e-5
absolute, parameters rtol 1e-5 / atol 1e-6, the key bias excepted as
above), with ``num_update`` 1. Within the port, ``step_n`` and a restored
run are bitwise their plain steps.
"""
import warnings

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import parallel as port_parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon.model_zoo import bert as port_bert
from mxnet_tpu_torch.gluon.model_zoo import resnet as port_resnet
from mxnet_tpu_torch.ops.kernels import multi_tensor
from mxnet_tpu_torch.optimizer import fused, optimizer as port_opt

torch.set_num_threads(1)

CFG = dict(vocab_size=50, max_length=16, units=32, hidden_size=64,
           num_layers=2, num_heads=2, dropout=0.0)
VOCAB = CFG['vocab_size']
HYPER = {'learning_rate': 1e-3, 'wd': 0.01}
LR2 = 5e-4
N = 3
LOSS_REL = 1e-5
PARAM_TOL = 2e-5
RN_LOSS_REL = 1e-4
LAYERS, CHANNELS, CLASSES = [2, 1, 1, 1], [8, 16, 32, 64, 128], 10
RN_HYPER = {'learning_rate': 0.001, 'momentum': 0.9, 'wd': 1e-4}
RN_PARAM_TOL = 5e-5


def _bert_batches(n, batch=2, seed=0):
    """``n`` MLM + NSP batches of ``batch`` 8-token sequences, stacked on
    a leading steps dim: ([ids, tt, vl, mp], [mlm_y, nsp_y])."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (n, batch, 8)).astype('float32')
    tt = (rs.rand(n, batch, 8) > 0.5).astype('float32')
    vl = rs.randint(3, 9, (n, batch)).astype('float32')
    mp = rs.randint(0, 8, (n, batch, 3)).astype('float32')
    mlm_y = rs.randint(0, VOCAB, (n, batch, 3)).astype('float32')
    nsp_y = rs.randint(0, 2, (n, batch)).astype('float32')
    return [ids, tt, vl, mp], [mlm_y, nsp_y]


def _weights(names_shapes, resnet=False):
    """Random weights from a numpy seed, every tensor carrying a signal
    (the two trainer tests' draws)."""
    rs = np.random.RandomState(1)
    out = {}
    for name, shape in names_shapes:
        w = rs.randn(*shape).astype('float32')
        if name.endswith('gamma'):
            out[name] = 1.0 + 0.1 * w
        elif name.endswith(('bias', 'beta', 'running_mean')):
            out[name] = 0.1 * w
        elif name.endswith('running_var'):
            out[name] = (0.5 + rs.rand(*shape)).astype('float32')
        elif resnet:
            fan_in = int(np.prod(shape[1:]))
            out[name] = w * np.float32(np.sqrt(2.0 / fan_in))
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


def _params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _jax():
    """The JAX package's modules, imported where they are used (so that
    the cuda test runs where only the port is installed)."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import nd, parallel
    from mxnet_tpu.gluon import loss
    from mxnet_tpu.gluon.model_zoo import bert
    from mxnet_tpu.gluon.model_zoo.vision import resnet
    mesh = parallel.create_mesh({'dp': 1}, devices=jax.devices()[:1])
    return mx, nd, parallel, loss, bert, resnet, mesh


@pytest.fixture(scope='module')
def bert_ref():
    """The JAX trainer's step_n, a step after set_learning_rate, and
    step_accum, as numpy."""
    mx, nd, jax_parallel, jax_loss, jax_bert, _, mesh = _jax()
    X, Y = _bert_batches(N)
    net = jax_bert.get_bert(**CFG)
    net.initialize(mx.init.Xavier())
    net(*[nd.array(a[0]) for a in X])               # deferred shapes
    params = net.collect_params()
    weights = _weights([(n, p.shape) for n, p in params.items()])
    for n, p in params.items():
        p.set_data(nd.array(weights[n]))
    fn = _pretrain_loss(jax_loss.SoftmaxCrossEntropyLoss())
    pt = jax_parallel.ParallelTrainer(net, fn, 'adamw', dict(HYPER), mesh)
    losses = pt.step_n([nd.array(a) for a in X],
                       [nd.array(a) for a in Y]).asnumpy()
    after_n = _params(net)
    pt.set_learning_rate(LR2)
    lr_loss = float(pt.step([nd.array(a[0]) for a in X],
                            [nd.array(a[0]) for a in Y]).asnumpy())
    after_lr = _params(net)
    for n, p in params.items():
        p.set_data(nd.array(weights[n]))
    xa, ya = _bert_batches(1, batch=4, seed=5)
    xa, ya = [nd.array(a[0]) for a in xa], [nd.array(a[0]) for a in ya]
    pt2 = jax_parallel.ParallelTrainer(net, fn, 'adamw', dict(HYPER), mesh)
    pt2.build(xa, ya)
    acc_loss = float(pt2.step_accum(xa, ya, 2).asnumpy())
    return dict(weights=weights, losses=losses, after_n=after_n,
                lr_loss=lr_loss, after_lr=after_lr, acc_loss=acc_loss,
                after_acc=_params(net), acc_updates=pt2.num_update)


def _port_bert(weights, dropout=0.0):
    net = port_bert.get_bert(device='cpu', **dict(CFG, dropout=dropout))
    return port_bert.params_from_jax(weights, net)


def _port_trainer(net, seed=0):
    fn = _pretrain_loss(port_loss.SoftmaxCrossEntropyLoss())
    return port_parallel.ParallelTrainer(net, fn, 'adamw', dict(HYPER),
                                         seed=seed)


def _t(arrays):
    return [torch.tensor(a) for a in arrays]


def _hold_bert(net, want, steps, lr=HYPER['learning_rate']):
    """Parameters against the JAX package's at the BERT tier, the key
    bias held to the steps' size."""
    mine = net.collect_params().tensors()
    u = CFG['units']
    for n, w in want.items():
        got = mine[n.split('_', 1)[1]].detach().numpy()
        if n.endswith('attn_qkv_bias'):
            np.testing.assert_allclose(got[u:2 * u], w[u:2 * u], rtol=0,
                                       atol=2 * steps * lr, err_msg=n)
            got, w = np.delete(got, np.s_[u:2 * u]), \
                np.delete(w, np.s_[u:2 * u])
        np.testing.assert_allclose(got, w, rtol=0, atol=PARAM_TOL,
                                   err_msg=n)


def test_step_n_and_set_learning_rate_match_jax(bert_ref):
    X, Y = _bert_batches(N)
    net = _port_bert(bert_ref['weights'])
    pt = _port_trainer(net)
    losses = pt.step_n(_t(X), _t(Y))
    assert losses.shape == (N,) and pt.num_update == N
    np.testing.assert_allclose(losses.numpy(), bert_ref['losses'],
                               rtol=LOSS_REL, atol=0)
    _hold_bert(net, bert_ref['after_n'], N)
    pt.set_learning_rate(LR2)
    assert pt.learning_rate == LR2
    loss = pt.step(_t([a[0] for a in X]), _t([a[0] for a in Y])).item()
    assert abs(loss - bert_ref['lr_loss']) <= LOSS_REL * abs(
        bert_ref['lr_loss'])
    _hold_bert(net, bert_ref['after_lr'], N + 1)


def test_step_n_is_bitwise_n_steps():
    """With dropout drawing from the trainer's generator: step_n over n
    batches equals n steps, losses and parameters bit for bit."""
    X, Y = _bert_batches(N)
    w = _weights([(n, tuple(p.shape)) for n, p in port_bert.get_bert(
        device='cpu', **CFG).collect_params().tensors().items()])
    w = {'bertmodel0_' + n: v for n, v in w.items()}
    runs = []
    for window in (True, False):
        net = _port_bert(w, dropout=0.1)
        pt = _port_trainer(net, seed=7)
        if window:
            losses = pt.step_n(_t(X), _t(Y))
        else:
            losses = torch.stack([pt.step(_t([a[k] for a in X]),
                                          _t([a[k] for a in Y]))
                                  for k in range(N)])
        runs.append((losses, [p.detach().clone()
                              for p in net.collect_params().tensors().values()],
                     pt.num_update))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][2] == runs[1][2] == N


def test_step_n_refuses_what_the_reference_refuses():
    net = port_bert.init_params(port_bert.get_bert(device='cpu', **CFG), 0)
    pt = _port_trainer(net)
    X, Y = _bert_batches(2)
    with pytest.raises(ValueError, match='at least one data'):
        pt.step_n([], _t(Y))
    with pytest.raises(ValueError, match='at least one data'):
        pt.step_n([None], _t(Y))
    with pytest.raises(ValueError, match='zero-length'):
        pt.step_n(_t([a[:0] for a in X]), _t([a[:0] for a in Y]))
    pt.step_n(_t(X), _t(Y))
    with pytest.raises(ValueError, match='signature'):
        pt.step_n(_t(X) + [None], _t(Y))
    with pytest.raises(ValueError, match='signature'):
        pt.step(_t([a[0] for a in X]), _t([Y[0][0]]))
    with pytest.raises(ValueError, match='does not split'):
        pt.step_accum(_t([a[0] for a in X]), _t([a[0] for a in Y]), 3)
    assert pt.num_update == 2


def test_step_accum_matches_jax_and_one_full_batch_step(bert_ref):
    xa, ya = _bert_batches(1, batch=4, seed=5)
    xa, ya = _t([a[0] for a in xa]), _t([a[0] for a in ya])
    net = _port_bert(bert_ref['weights'])
    pt = _port_trainer(net)
    assert pt.build(xa, ya) is pt
    snap = pt.snapshot()
    one = pt.step(xa, ya).item()
    params_one = {n: p.detach().clone()
                  for n, p in net.collect_params().tensors().items()}
    pt.restore(snap)
    acc = pt.step_accum(xa, ya, 2).item()
    assert pt.num_update == bert_ref['acc_updates'] == 1
    assert abs(acc - bert_ref['acc_loss']) <= LOSS_REL * abs(
        bert_ref['acc_loss'])
    _hold_bert(net, bert_ref['after_acc'], 1)
    # the reference's bar against one step on the full batch
    assert abs(one - acc) < 1e-5
    u = CFG['units']
    for n, p in net.collect_params().tensors().items():
        got, want = p.detach().numpy(), params_one[n].numpy()
        if n.endswith('attn_qkv_bias'):
            np.testing.assert_allclose(got[u:2 * u], want[u:2 * u], rtol=0,
                                       atol=2 * HYPER['learning_rate'])
            got, want = np.delete(got, np.s_[u:2 * u]), \
                np.delete(want, np.s_[u:2 * u])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    # accum <= 1 is a step
    pt.restore(snap)
    assert pt.step_accum(xa, ya, 1).item() == one


def _resnet_batches(n):
    """``n`` batches of ``tests/test_torch_resnet.py``'s shape on a
    leading steps dim."""
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (n, 4, 3, 64, 64)).astype('float32')
    y = rs.randint(0, CLASSES, (n, 4)).astype('float32')
    return x, y


@pytest.fixture(scope='module')
def resnet_ref():
    mx, nd, jax_parallel, jax_loss, _, jax_resnet, mesh = _jax()
    X, Y = _resnet_batches(N)
    net = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, LAYERS, CHANNELS,
                              classes=CLASSES)
    net.initialize(mx.init.Xavier())
    net(nd.array(X[0]))                             # deferred shapes
    params = net.collect_params()
    weights = _weights([(n, p.shape) for n, p in params.items()],
                       resnet=True)
    for n, p in params.items():
        p.set_data(nd.array(weights[n]))
    pt = jax_parallel.ParallelTrainer(net, jax_loss.SoftmaxCrossEntropyLoss(),
                                      'sgd', dict(RN_HYPER), mesh)
    losses = pt.step_n(nd.array(X), nd.array(Y)).asnumpy()
    return dict(weights=weights, losses=losses, after=_params(net))


def _port_resnet(weights):
    net = port_resnet.ResNetV1(port_resnet.BottleneckV1, LAYERS, CHANNELS,
                               classes=CLASSES, device='cpu')
    return port_resnet.params_from_jax(weights, net)


def test_resnet_step_n_matches_jax_and_snapshot_rewinds(resnet_ref):
    X, Y = _resnet_batches(N)
    net = _port_resnet(resnet_ref['weights'])
    pt = port_parallel.ParallelTrainer(
        net, port_loss.SoftmaxCrossEntropyLoss(), 'sgd', dict(RN_HYPER))
    pt.build(torch.tensor(X[0]), torch.tensor(Y[0]))
    snap = pt.snapshot()
    losses = pt.step_n(torch.tensor(X), torch.tensor(Y))
    np.testing.assert_allclose(losses.numpy(), resnet_ref['losses'],
                               rtol=RN_LOSS_REL, atol=0)
    mine = net.collect_params().tensors()
    for n, want in resnet_ref['after'].items():
        np.testing.assert_allclose(mine[n.split('_', 1)[1]].detach().numpy(),
                                   want, rtol=0, atol=RN_PARAM_TOL,
                                   err_msg=n)
    # the rewind covers parameters, moving statistics, momentum and
    # counts: the same three steps again, bit for bit
    after = {n: p.detach().clone() for n, p in mine.items()}
    counts = dict(pt._opt._index_update_count)
    pt.restore(snap)
    assert pt.num_update == 0 and not pt._opt._index_update_count
    again = torch.stack([pt.step(torch.tensor(X[k]), torch.tensor(Y[k]))
                         for k in range(N)])
    assert torch.equal(again, losses)
    assert all(torch.equal(p, after[n]) for n, p in mine.items())
    assert pt._opt._index_update_count == counts and pt.num_update == N


def test_snapshot_rewinds_the_generator_and_refuses_before_build():
    net = port_bert.init_params(
        port_bert.get_bert(device='cpu', **dict(CFG, dropout=0.1)), 0)
    pt = _port_trainer(net, seed=3)
    with pytest.raises(RuntimeError, match='before the step is built'):
        pt.snapshot()
    with pytest.raises(RuntimeError, match='un-built'):
        pt.restore({})
    X, Y = _bert_batches(3)
    pt.step(_t([a[0] for a in X]), _t([a[0] for a in Y]))
    snap = pt.snapshot()
    first = [pt.step(_t([a[k] for a in X]), _t([a[k] for a in Y])).item()
             for k in (1, 2)]
    pt.restore(snap)
    again = [pt.step(_t([a[k] for a in X]), _t([a[k] for a in Y])).item()
             for k in (1, 2)]
    assert first == again and pt.num_update == 3


def _update(rule, form, seed=0):
    """A FusedUpdate over odd-length CPU parameters of ``form`` under
    ``rule`` (its optimizer at phase 2's hyperparameters), an lr
    multiplier and a wd multiplier of 0 on one."""
    import chip_smoke
    gen = torch.Generator().manual_seed(seed)
    dt = torch.float32 if form == 'float32' else torch.bfloat16
    params = [(i, torch.nn.Parameter(torch.randn(n, generator=gen).to(dt)))
              for i, n in enumerate((7, 9000, 1, 300))]
    kw = dict(chip_smoke.FUSED_HYPER[rule], learning_rate=0.01, wd=1e-3,
              multi_precision=form == 'master')
    opt = port_opt.create(chip_smoke.RULE_OPTIMIZER.get(rule, rule), **kw)
    opt.idx2name = {i: 'p%d_weight' % i for i, _ in params}
    opt.set_lr_mult({1: 0.5})
    opt.set_wd_mult({'p2_weight': 0.0})
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        states = [opt.create_state_multi_precision(i, p.detach())
                  for i, p in params]
    return params, fused.FusedUpdate(opt, params, states,
                                     torch.device('cpu'))


@pytest.mark.parametrize('rule,form', [
    (r, f) for r in multi_tensor.RULES for f in multi_tensor.FORMS
    if f != 'low' or r in multi_tensor.LOW_RULES])
def test_hypers_resolved_ahead_equal_single_resolutions(rule, form):
    """A captured window resolves n steps' hypers before its first
    replay; its columns equal, bit for bit, what n single resolutions
    pack into the table, step by step (Adam's and AdamW's bias-corrected
    lr, FTML's and Adamax's factors from each step's count)."""
    n = 4
    params, ahead = _update(rule, form)
    grads = [torch.zeros_like(p) for _, p in params]
    bindings = ahead.bind()
    for poses, b in bindings:
        b.pack([grads[k] for k in poses])
    cols = [ahead.columns(bindings, *ahead._hypers()[:3]) for _ in range(n)]
    _, single = _update(rule, form)
    for k in range(n):
        a, wd, b, _ = single._hypers()
        want = []
        for poses, plan in single._plans():
            tab = plan.table([grads[j] for j in poses], [a[j] for j in poses],
                             [wd[j] for j in poses], [b[j] for j in poses])
            want.append(np.stack([tab['a'].view(np.int32),
                                  tab['wd'].view(np.int32),
                                  tab['b'].view(np.int32),
                                  tab['flags'].astype(np.int32)], axis=1))
        np.testing.assert_array_equal(cols[k], np.concatenate(want))
    if rule in ('adamw', 'adam', 'ftml', 'adamax'):
        assert cols[0][0, 0] != cols[1][0, 0]       # the lr moves with t


@pytest.mark.cuda
@pytest.mark.parametrize('dropout', [0.0, 0.1])
def test_captured_steps_bitwise_eager_steps_on_card(dropout):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the step is a CUDA graph over '
                    'kernels built for sm_90a')
    from mxnet_tpu_torch.ops import kernels
    X, Y = _bert_batches(6)
    runs = {}
    # head dim 64, the width phase 4b trains; deterministic algorithms
    # on both sides, since the MLM gather's backward scatter-adds with
    # atomics by default (two eager runs differ too)
    cfg = dict(CFG, units=128, dropout=dropout)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for capture in (True, False):
            net = port_bert.init_params(port_bert.get_bert(device='cuda',
                                                           **cfg), 0)
            pt = _port_trainer(net, seed=7)
            pt.capture = capture
            kernels.reset_launch_counts()
            losses = [pt.step(
                [torch.tensor(a[k], device='cuda') for a in X],
                [torch.tensor(a[k], device='cuda') for a in Y])
                for k in range(6)]
            runs[capture] = (torch.stack(losses),
                             [p.detach().clone() for p in net.parameters()],
                             kernels.launch_counts(), pt.compile_count)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    assert runs[True][3] == 1 and runs[False][3] == 0
    assert torch.equal(runs[True][0], runs[False][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                 runs[False][1]))
    assert runs[True][2] == runs[False][2]
