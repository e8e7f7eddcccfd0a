"""The port's ``gluon.Trainer`` (``gluon/trainer.py`` over the
whole-model update, ``optimizer/fused.py``) against the JAX package's, on
the CPU.

The trainer cases of ``tests/test_gluon.py`` in the port, and the
reference's own loop (``record()`` / ``backward()`` /
``trainer.step(batch)``) for 3 steps in both packages from the same
weights (carried by ``params_from_jax``): SGD with momentum and AdamW,
with an ``lr_mult`` and a ``wd_mult`` on some parameters and a
``FactorScheduler``, on ``resnet18_v1(thumbnail=True)`` at 32 px and on
LeNet. On LeNet each step's loss agrees within 1e-5 of the first loss and
every
parameter within 1e-5 of its largest magnitude after the 3 steps (float32
products summed in another order).

On ResNet-18 the JAX package's own float32 gradient is not that close to
the exact one: XLA's CPU reductions sum the BatchNorm statistics and
their backward over a whole channel (16384 values a channel at stage 1)
one after another, and the one-pass ``sum(dy x) - mean sum(dy)`` form
cancels, so its gradient stands about 6e-3 of the largest gradient from
a float64 run of the same net, where the port's stands within 2e-6
(torch sums pairwise). The ResNet cases therefore hold the port's first
loss to the JAX package's within 1e-5, its gradient to the float64
reference within 1e-5 of the largest gradient, and the JAX package's
within 1e-2; the 3-step losses within 1e-3 of the first loss and the
weights within 1e-2 of the net's largest weight magnitude (the JAX
gradient's error is of the net's scale, not of each tensor's: a
parameter that starts at 0 or a gradient element the error flips under
AdamW, whose step divides by sqrt(v), moves by it whole).
"""
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import gluon as pgluon
from mxnet_tpu_torch.gluon import nn as pnn
from mxnet_tpu_torch.gluon.block import params_from_jax

LOSS_REL = 1e-5
W_REL = 1e-5
STEPS = 3


def _p(mx, gluon, shape=(4,)):
    p = gluon.Parameter('w', shape=shape)
    p.initialize(init='ones')
    return p


def test_trainer_sgd_matches_manual():
    with pmx.cpu():
        p = _p(pmx, pgluon)
        trainer = pgluon.Trainer({'w': p}, 'sgd',
                                 {'learning_rate': 0.5, 'momentum': 0.0})
        with pmx.autograd.record():
            loss = (p.data() * p.data()).sum()
        loss.backward()
        trainer.step(1)
        np.testing.assert_allclose(p.data().asnumpy(), np.zeros(4),
                                   atol=1e-6)


def test_trainer_states_roundtrip(tmp_path):
    fname = str(tmp_path / 'trainer.states')
    with pmx.cpu():
        p = _p(pmx, pgluon)
        trainer = pgluon.Trainer({'w': p}, 'sgd',
                                 {'learning_rate': 0.1, 'momentum': 0.9})
        for _ in range(2):
            with pmx.autograd.record():
                loss = (p.data() * p.data()).sum()
            loss.backward()
            trainer.step(1)
        trainer.save_states(fname)
        w_saved = p.data().asnumpy().copy()
        with pmx.autograd.record():
            loss = (p.data() * p.data()).sum()
        loss.backward()
        trainer.step(1)
        after = p.data().asnumpy().copy()
        p.set_data(pmx.nd.array(w_saved))
        trainer.load_states(fname)
        with pmx.autograd.record():
            loss = (p.data() * p.data()).sum()
        loss.backward()
        trainer.step(1)
        np.testing.assert_array_equal(p.data().asnumpy(), after)
        assert isinstance(trainer.get_states_bytes(), bytes)


def test_trainer_update_on_kvstore_is_one_device():
    with pmx.cpu():
        p = _p(pmx, pgluon)
        tr = pgluon.Trainer({'w': p}, 'sgd', {'learning_rate': 0.5},
                            kvstore='device', update_on_kvstore=True)
        with pmx.autograd.record():
            loss = (p.data() * p.data()).sum()
        loss.backward()
        tr.allreduce_grads()
        tr.update(1)
        np.testing.assert_allclose(p.data().asnumpy(), np.zeros(4),
                                   atol=1e-6)


def test_trainer_stale_grad():
    with pmx.cpu():
        p = _p(pmx, pgluon, (2,))
        tr = pgluon.Trainer({'w': p}, 'sgd', {'learning_rate': 0.5})
        with pytest.raises(UserWarning):
            tr.step(1)
        tr.step(1, ignore_stale_grad=True)
        np.testing.assert_array_equal(p.data().asnumpy(), np.ones(2))


def test_itruediv_keeps_leaf():
    with pmx.cpu():
        w = pmx.nd.ones((3,))
        w.attach_grad()
        w /= 2
        with pmx.autograd.record():
            loss = (w * w).sum()
        loss.backward()
        np.testing.assert_allclose(w.grad.asnumpy(), w.asnumpy() * 2)


def test_learning_rate_and_scheduler():
    with pmx.cpu():
        p = _p(pmx, pgluon)
        tr = pgluon.Trainer({'w': p}, 'sgd', {'learning_rate': 0.5})
        assert tr.learning_rate == 0.5
        tr.set_learning_rate(0.25)
        assert tr.learning_rate == 0.25
        sched = pmx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
        tr2 = pgluon.Trainer({'w': p}, 'sgd', {'learning_rate': 0.5,
                                               'lr_scheduler': sched})
        with pytest.raises(UserWarning):
            tr2.set_learning_rate(0.1)


def test_adam_runs_its_plain_update_on_the_cpu():
    """Off the card the plain per-parameter loop runs any optimizer of the
    port: Adam here matches the JAX Trainer's Adam steps within 1e-5."""
    for mx, gluon, ctx in ((jmx, jgluon, jmx.cpu()),
                           (pmx, pgluon, pmx.cpu())):
        with ctx:
            p = gluon.Parameter('w', shape=(3,))
            p.initialize(init='ones')
            tr = gluon.Trainer({'w': p}, 'adam', {'learning_rate': 0.1})
            for _ in range(2):
                with mx.autograd.record():
                    loss = (p.data() * p.data() * 3).sum()
                loss.backward()
                tr.step(1)
            if mx is jmx:
                want = p.data().asnumpy()
            else:
                got = p.data().asnumpy()
    # the JAX Trainer computes Adam's bias correction in float32 (0.999
    # rounded to float32 makes 1 - 0.999^t 1e-5 off), the port in float64
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.cuda
def test_adam_on_the_card_raises_fused_update_error():
    """On the card ``gluon.Trainer('adam')`` (once refused with
    ``FusedUpdateError``) takes one launch of the whole-model update's
    ``adam`` rule a step, bitwise the plain per-parameter loop over the
    same parameters on the card (``chip_smoke.check_gluon_rule``)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel is CUDA C++ for sm_90a '
                    'and has no CPU mode')
    import chip_smoke
    from mxnet_tpu_torch.ops import kernels
    assert chip_smoke.check_gluon_rule(torch, pmx, kernels, 'adam') == {
        ('multi_tensor_update', 'adam'): 3}


def test_guardrail_is_not_ported():
    with pmx.cpu():
        tr = pgluon.Trainer({'w': _p(pmx, pgluon)}, 'sgd')
        with pytest.raises(NotImplementedError):
            tr.attach_guardrail(object())


# -- the reference's loop in both packages ----------------------------------------

def _lenet(nn):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(6, 5, activation='tanh'), nn.MaxPool2D(2, 2),
                nn.Conv2D(8, 5, activation='tanh'), nn.MaxPool2D(2, 2),
                nn.Flatten(), nn.Dense(32, activation='tanh'),
                nn.Dense(10))
    return net


def _resnet(nn, package):
    return package.gluon.model_zoo.vision.resnet18_v1(thumbnail=True,
                                                      classes=10)


NETS = {
    'lenet': (lambda mx, nn: _lenet(nn), (8, 1, 28, 28)),
    'resnet18_v1_thumbnail': (lambda mx, nn: _resnet(nn, mx), (16, 3, 32, 32)),
}
# AdamW at its usual lr: its step divides by sqrt(v), so the
# float32-sum differences of two correct gradients (a few ULPs) move the
# weights by a share of lr, not of the gradient
OPTS = {
    'sgd_momentum': ('sgd', {'learning_rate': 0.01, 'momentum': 0.9,
                             'wd': 1e-4}),
    'adamw': ('adamw', {'learning_rate': 1e-3, 'wd': 0.01}),
}


def _batch(shape):
    rs = np.random.RandomState(5)
    return (rs.uniform(-1, 1, shape).astype('float32'),
            rs.randint(0, 10, (shape[0],)).astype('float32'))


def _loop(mx, nn, gluon, make, x, y, opt, hypers, weights=None):
    """3 steps of the reference's loop; (losses, params after, the
    initial params) as numpy."""
    net = make(mx, nn)
    net.initialize(mx.init.Xavier())
    net(mx.nd.array(x[:1]))                     # the deferred shapes
    if weights is not None:
        params_from_jax(weights, net)
    params = net.collect_params()
    init = {k: v.data().asnumpy().copy() for k, v in params.items()}
    # an lr_mult on the classifier, no decay on the biases
    for k, p in params.items():
        if 'dense' in k:
            p.lr_mult = 2.0
        if k.endswith('bias'):
            p.wd_mult = 0.0
    sched = mx.lr_scheduler.FactorScheduler(
        step=1, factor=0.5, base_lr=hypers['learning_rate'])
    trainer = gluon.Trainer(params, opt, dict(hypers, lr_scheduler=sched))
    L = gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = mx.nd.array(x), mx.nd.array(y)
    losses = []
    for _ in range(STEPS):
        with mx.autograd.record():
            loss = L(net(xs), ys)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return losses, {k: v.data().asnumpy() for k, v in params.items()}, init


# (loss, weight) tolerances of the 3-step loop, the losses relative to
# the first loss, the weights to each tensor's largest magnitude: LeNet's
# sums are short enough for XLA's CPU reductions; ResNet's are not (the
# module docstring)
LOOP_TOL = {'lenet': (LOSS_REL, W_REL, 'tensor'),
            'resnet18_v1_thumbnail': (1e-3, 1e-2, 'net')}


@pytest.mark.parametrize('opt', sorted(OPTS))
@pytest.mark.parametrize('net', sorted(NETS))
def test_three_step_loop_matches_jax(net, opt):
    make, shape = NETS[net]
    x, y = _batch(shape)
    jmx.random.seed(0)
    jl, jp, jinit = _loop(jmx, jnn, jgluon, make, x, y, *OPTS[opt])
    with pmx.cpu():
        pl, pp, _ = _loop(pmx, pnn, pgluon, make, x, y, *OPTS[opt],
                          weights=jinit)
    loss_rel, w_rel, scope = LOOP_TOL[net]
    top = max(float(np.abs(w).max()) for w in jp.values())
    assert abs(pl[0] - jl[0]) <= LOSS_REL * abs(jl[0])
    np.testing.assert_allclose(pl, jl, rtol=0, atol=loss_rel * abs(jl[0]))
    assert pl[-1] < pl[0]
    assert len(pp) == len(jp)
    for jk, want in jp.items():
        got = pp[_strip(jk)]
        tol = w_rel * (float(np.abs(want).max()) if scope == 'tensor'
                       else top)
        err = float(np.abs(got.astype(np.float64) - want).max())
        assert err <= tol, '%s: %.3g (limit %.3g)' % (jk, err, tol)


def _f64_grads(pnet, x, y, weights=None):
    """The summed softmax cross-entropy of ``pnet``'s ResNet on ``(x, y)``
    and its gradient, in float64: the same modules, ``weights`` (a dict by
    gluon name, numpy; the net's own by default), plain torch functional
    ops (two-pass BatchNorm statistics), no kernel. Returns (loss,
    {name: gradient})."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.gluon.block import Block
    from mxnet_tpu_torch.gluon.model_zoo.resnet import _ResidualCell
    params = pnet.collect_params()
    if weights is None:
        weights = {k: p.tensor.detach().double().numpy()
                   for k, p in params.items()}
    W = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for k, v in weights.items()}
    names = {}

    def prefixes(mod, pre):
        if isinstance(mod, Block):
            pre = pre + mod.prefix
        names[id(mod)] = pre
        for c in mod._modules.values():
            prefixes(c, pre)

    def run(mod, h):
        n = names[id(mod)]
        if isinstance(mod, pnn.Conv2D):
            k = mod._kwargs
            return F.conv2d(h, W[n + 'weight'], W.get(n + 'bias'),
                            stride=k['stride'], padding=k['pad'])
        if isinstance(mod, pnn.BatchNorm):
            return F.batch_norm(h, None, None, W[n + 'gamma'],
                                W[n + 'beta'], training=True, eps=1e-5)
        if isinstance(mod, pnn.Activation):
            return torch.relu(h)
        if isinstance(mod, pnn.MaxPool2D):
            k = mod._kwargs
            return F.max_pool2d(h, k['kernel'], k['stride'], k['pad'])
        if isinstance(mod, pnn.GlobalAvgPool2D):
            return h.mean(dim=(2, 3), keepdim=True)
        if isinstance(mod, pnn.Dense):
            return h.reshape(h.shape[0], -1) @ W[n + 'weight'].t() \
                + W[n + 'bias']
        if isinstance(mod, _ResidualCell):
            res = h if mod.downsample is None else run(mod.downsample, h)
            return torch.relu(run(mod.body, h) + res)
        for c in mod._modules.values():
            h = run(c, h)
        return h

    prefixes(pnet, '')
    out = run(pnet, torch.tensor(x, dtype=torch.float64))
    lab = torch.tensor(y).long()[:, None]
    loss = (-torch.log_softmax(out, -1).gather(1, lab)).sum()
    loss.backward()
    return float(loss), {k: v.grad.numpy() for k, v in W.items()
                         if v.grad is not None}


def test_resnet_gradient_against_float64():
    """The gradient behind the ResNet loop: the port's within 1e-5 of
    the largest gradient from the float64 reference, the JAX package's
    within 1e-2 (its CPU reductions, the module docstring)."""
    make, shape = NETS['resnet18_v1_thumbnail']
    x, y = _batch(shape)
    jmx.random.seed(0)
    jnet = make(jmx, jnn)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[:1]))
    L = jgluon.loss.SoftmaxCrossEntropyLoss()
    with jmx.autograd.record():
        jl = L(jnet(jmx.nd.array(x)), jmx.nd.array(y))
    jl.backward()
    jgrad = {_strip(k): p.grad().asnumpy()
             for k, p in jnet.collect_params().items()
             if p.grad_req != 'null'}
    weights = {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    with pmx.cpu():
        pnet = make(pmx, pnn)
        pnet.initialize()
        pnet(pmx.nd.array(x[:1]))
        params_from_jax(weights, pnet)
        PL = pgluon.loss.SoftmaxCrossEntropyLoss()
        with pmx.autograd.record():
            pl = PL(pnet(pmx.nd.array(x)), pmx.nd.array(y))
        pl.backward()
        pgrad = {k: p.grad().asnumpy()
                 for k, p in pnet.collect_params().items()
                 if p.grad_req != 'null'}
        _, truth = _f64_grads(pnet, x, y)
    np.testing.assert_allclose(pl.asnumpy(), jl.asnumpy(), rtol=LOSS_REL)
    top = max(float(np.abs(g).max()) for g in truth.values())
    port_gap = max(float(np.abs(pgrad[k] - g).max()) for k, g in truth.items())
    jax_gap = max(float(np.abs(jgrad[k] - g).max()) for k, g in truth.items())
    assert port_gap <= 1e-5 * top, (port_gap, top)
    assert jax_gap <= 1e-2 * top, (jax_gap, top)


def _strip(name):
    return re.sub(r'^(?:[a-z]+)\d+_', '', name, count=1)


# -- the reference's two scripts, small, on the CPU ------------------------------

def _digits(n=512):
    """``examples/train_mnist.py``'s synthetic digits (its ``get_data``
    without a data directory), ``n`` of them."""
    rs = np.random.RandomState(0)
    y = rs.randint(0, 10, n)
    x = rs.rand(n, 1, 28, 28).astype('float32') * 0.1
    for i, k in enumerate(y):
        x[i, 0, :k + 2, :k + 2] += 0.9
    return x, y.astype('float32')


def _train_gluon(mx, nn, gluon, x, y, batches, weights=None):
    """``train_gluon``'s loop (``examples/train_mnist.py:80-109``), its
    LeNet at the script's widths, ``batches`` batches of 64 of one epoch;
    (each batch's mean loss, the accuracy, the weights after the first
    forward)."""
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(20, 5, activation='tanh'), nn.MaxPool2D(2, 2),
                nn.Conv2D(50, 5, activation='tanh'), nn.MaxPool2D(2, 2),
                nn.Flatten(), nn.Dense(500, activation='tanh'),
                nn.Dense(10))
    net.initialize(mx.init.Xavier())
    net.hybridize(static_alloc=True, static_shape=True)
    net(mx.nd.array(x[:1]))
    if weights is not None:
        params_from_jax(weights, net)
    init = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    L = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': 0.05, 'momentum': 0.9})
    metric = mx.metric.Accuracy()
    np.random.seed(7)                       # the iterator's shuffle
    train = mx.io.NDArrayIter(x, y, batch_size=64, shuffle=True,
                              label_name='softmax_label')
    train.reset()
    metric.reset()
    losses = []
    for i, batch in enumerate(train):
        if i == batches:
            break
        xb, yb = batch.data[0], batch.label[0]
        with mx.autograd.record():
            out = net(xb)
            loss = L(out, yb)
        loss.backward()
        trainer.step(64)
        metric.update([yb], [out])
        losses.append(float(loss.mean().asscalar()))
    return losses, metric.get()[1], init


def test_train_gluon_loop_matches_jax():
    """``train_gluon``'s loop over its synthetic digits (NDArrayIter,
    Accuracy, SGD with momentum) for 6 batches: each batch's loss within
    1e-5 of the first loss, the accuracy equal."""
    x, y = _digits()
    jl, jacc, jinit = _train_gluon(jmx, jnn, jgluon, x, y, 6)
    with pmx.cpu():
        pl, pacc, _ = _train_gluon(pmx, pnn, pgluon, x, y, 6, weights=jinit)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOSS_REL * jl[0])
    assert pacc == jacc and pl[-1] < pl[0]


def test_bench_resnet_eager_loop_matches_jax():
    """``bench.py``'s ResNet-50 eager loop at its CPU size (batch 8 at 64
    px, ``resnet50_v1()``, ``initialize(Xavier())``, ``hybridize``, SGD lr
    0.1 momentum 0.9 wd 1e-4), 2 steps from the same weights. The first
    loss within 1e-4 of the JAX package's (53 training-mode BatchNorms
    whose statistics XLA's CPU sums in sequence: the module docstring)
    and within 1e-5 of a float64 run of the same net. The step is large
    and ill-conditioned: a 2 x 2 stage-4 map leaves 32 values a BatchNorm
    channel, whose one-pass float32 variance (the reference's
    ``_bn_train_core``, both packages) puts the gradient ~1.5e-2 of its
    largest value from float64, and the second loss moves by several
    percent with the summation order alone (torch's thread count). So
    the second loss is held only to be finite and below the first."""
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (8, 3, 64, 64)).astype('float32')
    y = rs.randint(0, 1000, (8,)).astype('float32')
    out = {}
    for name, mx, gluon, ctx in (('jax', jmx, jgluon, None),
                                 ('port', pmx, pgluon, pmx.cpu())):
        with (ctx or jmx.cpu()):
            net = mx.gluon.model_zoo.vision.resnet50_v1()
            net.initialize(mx.init.Xavier())
            net(mx.nd.array(x[:1]))
            if name == 'port':
                params_from_jax(out['weights'], net)
                pnet = net
            else:
                out['weights'] = {k: v.data().asnumpy() for k, v in
                                  net.collect_params().items()}
            net.hybridize(static_alloc=True, static_shape=True)
            L = gluon.loss.SoftmaxCrossEntropyLoss()
            trainer = gluon.Trainer(net.collect_params(), 'sgd',
                                    {'learning_rate': 0.1, 'momentum': 0.9,
                                     'wd': 1e-4})
            losses = []
            for _ in range(2):
                with mx.autograd.record():
                    loss = L(net(mx.nd.array(x)), mx.nd.array(y))
                loss.backward()
                trainer.step(8)
                losses.append(float(loss.mean().asscalar()))
            out[name] = losses
    jl, pl = out['jax'], out['port']
    assert abs(pl[0] - jl[0]) <= 1e-4 * abs(jl[0])
    w0 = {_strip(k): v for k, v in out['weights'].items()}
    train = [k for k, p in pnet.collect_params().items()
             if p.grad_req != 'null']
    first, _ = _f64_grads(pnet, x, y, {k: w0[k] for k in train})
    assert abs(pl[0] - first / 8) <= 1e-5 * abs(first / 8)
    assert np.isfinite(pl[1]) and pl[1] < pl[0]
