"""Port parity: ResNet v1 trained in bf16 by both of the reference's routes,
against the JAX package's.

Route A is ``ParallelTrainer(..., amp='bf16')`` on the float32 net: the
policy casts convolutions and the dense layer down to bf16, so BatchNorm,
the relus and the residual joins see bf16 activations (the inference BN
apply and every join on the bf16 kernel instances), while the loss head
widens to float32. Route B is ``net.cast('bfloat16')`` on bf16 images with
no policy (``bench_resnet``, bench.py:207-228): every weight bf16 but
BatchNorm's, which keeps float32 gamma, beta and moving statistics; the
logits reach the softmax-xent head in bf16 and the gradient leaves it in
bf16; SGD without ``multi_precision`` updates bf16 weights and momentum,
with it a float32 master.

On the CPU the port's wrappers run their plain versions; the JAX package
runs with ``MXNET_TPU_PALLAS=epilogue,xent``, its kernels in the Pallas
interpreter, as its own tests run them. The JAX forward and step-0
gradients are traced as its trainer traces them (``pure_forward_fn`` under
``jax.value_and_grad``, under the policy's scope for route A).

Tolerances:
  * the plain versions of the bf16 kernel instances against the JAX
    kernels on the same bf16 values: bitwise for the exact acts (identity,
    relu, leaky, softsign), forward and backward, and add+act; within 2
    bf16 ULPs beyond the float32 tier (5e-7 of the max abs) for the
    transcendental ones (measured 1); the xent head's float32 nll
    and logp within 1e-5, its bf16 dlogits within 1 ULP beyond 1e-5 of
    their max abs;
  * the narrow ResNet (``tests/test_torch_resnet.py``'s, 4 x 3 x 64 x 64,
    lr 0.001): loss within rtol 1e-2 (measured 2.7e-3); three SGD steps'
    losses within rtol 6e-2, the reference's bf16 trajectory tier
    (measured 1.4e-2: the JAX trainer's one-program step rounds its bf16
    elsewhere than its own traced forward, whose step-0 loss lies 5.5e-3
    from the trainer's, so ``tests/test_torch_amp.py``'s 1e-2 leaves no
    room). Its step-0
    gradients in bf16 are noise-bound, in the JAX package too: training-
    mode BatchNorm over 16-4096 values a channel cancels the gradient's
    terms, and bf16's 8 bits leave the JAX package's own bf16 gradients
    0.457 (whole-net L2, relative) from its float32 ones, a single
    tensor 1.41 of its max abs, where the float32 frameworks agree to
    4.5e-5. So the port's bf16 gradients are held to the JAX package's
    bf16 gradients no farther (whole-net L2) than those lie from the JAX
    package's float32 ones (measured 0.377 against 0.457), pointing the
    same way (cosine >= 0.9, measured 0.929), and in the same dtypes; the
    per-tensor 2e-2 tier of ``tests/test_torch_amp.py`` holds for BERT's
    LayerNorm, not here;
  * the optimizer ops on bf16 weights: byte for byte (the float32
    masters of the mp ops: within XLA's fused multiply-add, one rounding
    of each product);
  * bf16 against float32 over 10 steps at lr 0.001: rtol 6e-2, both
    falling (``tests/test_amp.py:152-164``; measured 3.7e-2 route A,
    5.4e-2 route B, 4.5e-2 with ``multi_precision``).
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import amp as jax_amp
from mxnet_tpu import config, nd
from mxnet_tpu import parallel as jax_parallel
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu.ops import optimizer_ops as jax_opt
from mxnet_tpu.ops.pallas import epilogue as jax_epi
from mxnet_tpu.ops.pallas import xent as jax_xent
from mxnet_tpu.optimizer import SGD as JaxSGD
from mxnet_tpu.parallel.train_step import pure_forward_fn
from mxnet_tpu_torch import parallel as port_parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon import nn as port_gnn
from mxnet_tpu_torch.gluon.model_zoo import resnet as port_resnet
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops import optimizer_ops as port_opt
from mxnet_tpu_torch.optimizer import optimizer as port_optmod

torch.set_num_threads(1)

BF = torch.bfloat16
LAYERS, CHANNELS, CLASSES = [2, 1, 1, 1], [8, 16, 32, 64, 128], 10
HYPER = {'learning_rate': 0.001, 'momentum': 0.9, 'wd': 1e-4}
STEPS = 3
LOSS_RTOL = 1e-2
TRAJ_RTOL = 6e-2
EXACT_ACTS = ('identity', 'relu', 'leaky', 'softsign')
ULP_ACTS = ('sigmoid', 'tanh', 'softrelu')
ROUTES = ('amp', 'cast', 'cast_mp')
ULP = 5e-7                 # the float32 tier of the transcendental acts


def _ulps(got, want, tier=0.0):
    import chip_smoke
    return chip_smoke.bf16_ulps(torch, got, want, tier)


def _to_torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


def _pair(a):
    """(bf16 tensor, bf16 JAX array) of the same values."""
    t = torch.tensor(a).to(BF)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.fixture(scope='module', autouse=True)
def kernels_on():
    config.set('MXNET_TPU_PALLAS', 'epilogue,xent')
    yield
    config.unset('MXNET_TPU_PALLAS')


# ---------------------------------------------------------------------------
# the plain versions of rows 5b, 6b, 9b, 10b and 11b against the JAX kernels
# ---------------------------------------------------------------------------


def _assert_bf16(got, want, act, what):
    """Bitwise for the exact acts; for the transcendental ones within 2
    bf16 ULPs beyond the float32 tier, 5e-7 of the max abs (a gradient
    from the output, ``1 - exp(-out)`` near 0, cancels to values many of
    whose own ULPs one float32 ULP of ``exp`` moves)."""
    assert got.dtype == BF, what
    if act in EXACT_ACTS:
        assert torch.equal(got, want), what
    else:
        tier = ULP * float(want.float().abs().max())
        assert _ulps(got, want, tier) <= 2, what


@pytest.mark.parametrize('act', EXACT_ACTS + ULP_ACTS)
@pytest.mark.parametrize('shape,axis', (((4, 16, 9, 11), 1),
                                        ((2, 5, 7, 3), -1)))
def test_bn_apply_and_add_act_bf16_plain_versions_match_jax(shape, axis,
                                                            act):
    """Rows 5b / 6b / 9b: the BN apply forward and backward on bf16 data
    with float32 (C,) coefficients, and add+act on two bf16 tensors,
    against ``fused_bn_apply`` / ``fused_add_act`` of the JAX package on
    the same bf16 values; the backward from the JAX forward's output."""
    rs = np.random.RandomState(11)
    x, y = (rs.randn(*shape).astype('float32') * 3 for _ in range(2))
    g = rs.randn(*shape).astype('float32')
    c = shape[axis]
    coeffs = [(rs.rand(c) + 0.5).astype('float32'),
              rs.randn(c).astype('float32'), rs.randn(c).astype('float32')]
    slope = 0.25 if act == 'leaky' else 0.0
    (xt, jx), (yt, jy), (gt, jg) = _pair(x), _pair(y), _pair(g)
    jout, vjp = jax.vjp(lambda a: jax_epi.fused_bn_apply(
        a, *[jnp.asarray(v) for v in coeffs], axis=axis,
        act_type=None if act == 'identity' else act, slope=slope), jx)
    jdx, = vjp(jg)
    assert jout.dtype == jdx.dtype == jnp.bfloat16
    ct = [torch.tensor(v) for v in coeffs]
    out = kernels.bn_act_forward(xt, *ct, axis, act, slope)
    _assert_bf16(out, _to_torch(jout).to(BF), act, 'bn_act_fwd')
    jo = _to_torch(jout).to(BF)
    dx = kernels.bn_act_backward(gt, jo, ct[0], axis, act, slope)
    _assert_bf16(dx, _to_torch(jdx).to(BF), act, 'bn_act_bwd')
    jsum = jax_epi.fused_add_act(jx, jy, act, slope)
    _assert_bf16(kernels.add_act_forward(xt, yt, act, slope),
                 _to_torch(jsum).to(BF), act, 'add_act_fwd')


@pytest.mark.parametrize('rows,v', ((37, 1000), (5, 30522)))
def test_xent_bf16_logits_plain_versions_match_jax(rows, v):
    """Rows 10b / 11b: bf16 logits give float32 nll and logp within 1e-5
    of the JAX kernel's (``_xent_fwd_impl`` in the interpreter), and the
    backward writes bf16 dlogits within 1 ULP beyond 1e-5 of their max
    abs of the JAX vjp's, labels out of range included."""
    rs = np.random.RandomState(12)
    lt, jl = _pair((rs.randn(rows, v) * 3).astype('float32'))
    lab = rs.randint(0, v, rows).astype('int32')
    lab[0], lab[1] = -1, v
    nll, logp = jax_xent._xent_fwd_impl(jl, jnp.asarray(lab), True)
    pn, pl = kernels.softmax_xent_forward(lt, torch.tensor(lab))
    assert pn.dtype == pl.dtype == torch.float32
    np.testing.assert_allclose(pn.numpy(), np.asarray(nll), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pl.numpy(), np.asarray(logp), rtol=0,
                               atol=1e-5)
    g = rs.rand(rows).astype('float32')
    _, vjp = jax.vjp(lambda a: jax_xent.fused_softmax_xent_rows(
        a, jnp.asarray(lab)), jl)
    jdx, = vjp(jnp.asarray(g))
    assert jdx.dtype == jnp.bfloat16
    dx = kernels.softmax_xent_backward(pl, torch.tensor(lab),
                                       torch.tensor(g), BF)
    want = _to_torch(jdx)
    assert dx.dtype == BF
    assert _ulps(dx, want, 1e-5 * float(want.abs().max())) <= 1
    # through the autograd Function: bf16 in, float32 nll, bf16 gradient
    lr = lt.clone().requires_grad_(True)
    kernels.fused_softmax_xent_rows(lr, torch.tensor(lab)).backward(
        torch.tensor(g))
    assert lr.grad.dtype == BF


def test_ops_keep_the_dtypes_of_the_jax_ops():
    """``batch_norm`` (training and inference), ``add_relu`` and
    ``fused_softmax_xent`` on bf16 data: the outputs' and the returned
    statistics' dtypes are the JAX ops'. Training returns bf16 data with
    float32 batch statistics (the moving statistics' dtype); inference
    passes bf16 through with the moving statistics as they are; the xent
    head returns its nll in the logits' dtype."""
    from mxnet_tpu.ops import nn as jax_nn
    from mxnet_tpu_torch.ops import nn as port_nn
    rs = np.random.RandomState(13)
    x = (rs.randn(4, 6, 5, 5) * 2).astype('float32')
    xt, jx = _pair(x)
    gamma, beta, mm = (rs.randn(6).astype('float32') for _ in range(3))
    mv = (rs.rand(6) + 0.5).astype('float32')
    jargs = [jnp.asarray(a) for a in (gamma, beta, mm, mv)]
    pargs = [torch.tensor(a) for a in (gamma, beta, mm, mv)]
    for training in (True, False):
        jo = jax_nn.batch_norm(jx, *jargs, eps=1e-5, fix_gamma=False,
                               training=training)
        po = port_nn.batch_norm(xt, *pargs, eps=1e-5, fix_gamma=False,
                                training=training)
        assert [str(t.dtype) for t in jo] == [
            str(t.dtype).replace('torch.', '') for t in po] == [
                'bfloat16', 'float32', 'float32']
        want = _to_torch(jo[0]).to(BF)
        assert _ulps(po[0], want) <= 1, training
        for a, b in zip(po[1:], jo[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    yt, jy = _pair(rs.randn(4, 6, 5, 5).astype('float32'))
    ja = jax_nn.add_relu(jx, jy)
    pa = port_nn.add_relu(xt, yt)
    assert pa.dtype == BF and ja.dtype == jnp.bfloat16
    assert torch.equal(pa, _to_torch(ja).to(BF))
    lt, jl = _pair(rs.randn(3, 4, 10).astype('float32'))
    lab = rs.randint(0, 10, (3, 4)).astype('float32')
    jn = jax_nn.fused_softmax_xent(jl, jnp.asarray(lab))
    pn = port_nn.fused_softmax_xent(lt, torch.tensor(lab))
    assert jn.dtype == jnp.bfloat16 and pn.dtype == BF
    assert tuple(pn.shape) == jn.shape == (3, 4, 1)
    assert torch.equal(pn, _to_torch(jn).to(BF))


# ---------------------------------------------------------------------------
# the optimizer ops and the low-precision protocol
# ---------------------------------------------------------------------------


def _opt_inputs(n=4099, seed=14):
    rs = np.random.RandomState(seed)
    return [rs.randn(n).astype('float32'),
            (rs.randn(n) * 0.1).astype('float32'),
            (rs.randn(n) * 0.01).astype('float32')]


def _traced(op, arrays, momentum=None):
    """The JAX op as the trainer traces it (train_step.py:576,
    optimizer/fused.py:119-147): lr, wd and rescale_grad float32 scalar
    operands, the outputs pinned back to the stored dtypes."""
    def fn(lr, wd, rescale, *arrs):
        kw = dict(lr=lr, wd=wd, rescale_grad=rescale)
        if momentum is not None:
            kw['momentum'] = momentum
        out = op(*arrs, **kw)
        out = out if isinstance(out, tuple) else (out,)
        return tuple(o.astype(a.dtype) for o, a in zip(
            out, [arrs[0]] + [arrs[i] for i in range(2, len(arrs))]))
    hyper = (np.float32(0.1), np.float32(1e-4), np.float32(1.0))
    return [_to_torch(o) for o in jax.jit(fn)(*hyper, *arrays)]


@pytest.mark.parametrize('momentum', (None, 0.9))
def test_sgd_ops_on_bf16_weights_match_jax_byte_for_byte(momentum):
    """``sgd_update`` / ``sgd_mom_update`` on bf16 weight, gradient and
    momentum: the traced JAX op widens to float32 (its lr, wd and
    rescale are float32 operands), multiplies the widened momentum by
    0.9 rounded to bf16 and rounds once at the end; the port's bytes
    equal its bytes."""
    w, g, m = _opt_inputs()
    (wt, jw), (gt, jg), (mt, jm) = _pair(w), _pair(g), _pair(m)
    kw = dict(lr=0.1, wd=1e-4, rescale_grad=1.0)
    if momentum is None:
        want, = _traced(jax_opt.sgd_update, (jw, jg))
        port_opt.sgd_update(wt, gt, **kw)
        assert torch.equal(wt, want.to(BF))
        return
    want_w, want_m = _traced(jax_opt.sgd_mom_update, (jw, jg, jm), 0.9)
    port_opt.sgd_mom_update(wt, gt, mt, momentum=0.9, **kw)
    assert wt.dtype == mt.dtype == BF
    assert torch.equal(wt, want_w.to(BF)) and torch.equal(mt, want_m.to(BF))


def _assert_f32_fused(got, want, *terms):
    """XLA on the CPU contracts the float32 masters' multiply-adds into
    fused ones (measured: ``wd * w32 + g``, ``momentum * mom - lr * g``
    and ``w32 - lr * g`` each round once), where the port's ops round
    each product as PyTorch's separate ops do: the two differ by the
    products' roundings, at most 2^-22 of the terms' magnitudes summed
    (``terms``), as ``tests/test_torch_epilogue.py`` bounds the BN
    apply's."""
    bound = 2.0 ** -22 * sum(t.abs() for t in terms)
    assert ((got - want).abs() <= bound).all()


@pytest.mark.parametrize('momentum', (None, 0.9))
def test_mp_sgd_ops_match_jax_byte_for_byte(momentum):
    """``mp_sgd_update`` / ``mp_sgd_mom_update``: a bf16 weight and
    gradient with a float32 master (and float32 momentum), all arithmetic
    float32, the weight the master rounded: the bf16 weight byte for byte
    the JAX op's, the float32 master and momentum within the bound of
    the JAX op's fused multiply-adds (``_assert_f32_fused``)."""
    w, g, m = _opt_inputs(seed=15)
    (wt, jw), (gt, jg) = _pair(w), _pair(g)
    w32 = wt.float()
    old, step = w32.clone(), 0.1 * gt.float()
    kw = dict(lr=0.1, wd=1e-4, rescale_grad=1.0)
    if momentum is None:
        want_w, want_32 = _traced(jax_opt.mp_sgd_update,
                                  (jw, jg, jnp.asarray(w32.numpy())))
        port_opt.mp_sgd_update(wt, gt, w32, **kw)
        assert torch.equal(wt, want_w.to(BF))
        _assert_f32_fused(w32, want_32, old, step)
        return
    mom = torch.tensor(m)
    want_w, want_m, want_32 = _traced(
        jax_opt.mp_sgd_mom_update,
        (jw, jg, jnp.asarray(m), jnp.asarray(w32.numpy())), 0.9)
    port_opt.mp_sgd_mom_update(wt, gt, mom, w32, momentum=0.9, **kw)
    assert wt.dtype == BF and mom.dtype == w32.dtype == torch.float32
    assert torch.equal(wt, want_w.to(BF))
    _assert_f32_fused(mom, want_m, 0.9 * torch.tensor(m), step)
    _assert_f32_fused(w32, want_32, old, 0.9 * torch.tensor(m), step)


def test_bf16_master_weight_protocol_and_warning():
    """``tests/test_amp.py:409-428``: under ``multi_precision`` a bf16
    weight gets a float32 master, the update runs on it and the weight
    mirrors it rounded, as in the JAX package; without it,
    ``create_state_multi_precision`` warns naming bfloat16 and keeps the
    state in bf16. AdamW keeps bf16 (mean, var) for a bf16 weight without
    it, warning as SGD does (``tests/test_torch_adamw_bf16.py`` holds its
    update)."""
    w = np.linspace(-1, 1, 8).astype('float32')
    g = np.full((8,), 0.25, np.float32)
    jopt = JaxSGD(learning_rate=0.5, momentum=0.9, multi_precision=True)
    w16 = nd.array(w, dtype='bfloat16')
    jstate = jopt.create_state_multi_precision(0, w16)
    jopt.update_multi_precision(0, w16, nd.array(g, dtype='bfloat16'),
                                jstate)
    popt = port_optmod.SGD(learning_rate=0.5, momentum=0.9,
                           multi_precision=True)
    wt = torch.tensor(w).to(BF)
    state = popt.create_state_multi_precision(0, wt)
    master, mom = state
    assert master.dtype == mom.dtype == torch.float32
    popt.update_multi_precision(0, wt, torch.tensor(g).to(BF), state)
    assert torch.equal(wt, master.to(BF))
    assert torch.equal(master, _to_torch(jstate[0].asnumpy()))
    assert torch.equal(wt, _to_torch(w16.asnumpy()).to(BF))
    with pytest.warns(UserWarning, match='bfloat16'):
        st = port_optmod.SGD(learning_rate=0.5, momentum=0.9) \
            .create_state_multi_precision(1, wt)
    assert st.dtype == BF
    with pytest.warns(UserWarning, match='bfloat16'):
        JaxSGD(learning_rate=0.5).create_state_multi_precision(1, w16)
    with pytest.warns(UserWarning, match='bfloat16'):
        mean, var = port_optmod.AdamW().create_state_multi_precision(0, wt)
    assert mean.dtype == var.dtype == BF


# ---------------------------------------------------------------------------
# Block.cast and BatchNorm.cast
# ---------------------------------------------------------------------------


def test_cast_keeps_batchnorm_float32_and_statistics_update_in_float32():
    """``tests/test_amp.py:430-452``: after ``cast('bfloat16')`` the
    layers' weights are bf16, a BatchNorm's gamma, beta and moving
    statistics float32; a training forward on bf16 data returns bf16 and
    moves the moving statistics, in float32. The parameters stay the
    same objects; ``cast('float32')`` widens them back exactly."""
    net = port_gnn.HybridSequential()
    dense = port_gnn.Dense(8, in_units=5, device='cpu')
    bn = port_gnn.BatchNorm(in_channels=8, device='cpu')
    net.add(dense, bn)
    with torch.no_grad():
        dense.weight.copy_(torch.randn(8, 5))
    before = {n: id(p) for n, p in net.collect_params().tensors().items()}
    w32 = dense.weight.detach().clone()
    assert net.cast('bfloat16') is net
    dtypes = {n: p.dtype for n, p in net.collect_params().tensors().items()}
    assert dtypes == {'dense_weight': BF, 'dense_bias': BF,
                      'batchnorm_gamma': torch.float32,
                      'batchnorm_beta': torch.float32,
                      'batchnorm_running_mean': torch.float32,
                      'batchnorm_running_var': torch.float32}
    assert {n: id(p) for n, p in net.collect_params().tensors().items()} == before
    assert torch.equal(dense.weight, w32.to(BF))
    assert dense.weight.requires_grad
    assert not bn.running_var.requires_grad
    net.train(True)
    out = net(torch.randn(8, 5).to(BF))
    assert out.dtype == BF
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    assert float((bn.running_var - 1).abs().sum()) > 0
    net.cast('float32')
    assert dense.weight.dtype == torch.float32
    assert torch.equal(dense.weight, w32.to(BF).float())


# ---------------------------------------------------------------------------
# the narrow ResNet under each route against the JAX package
# ---------------------------------------------------------------------------


def _batch():
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (4, 3, 64, 64)).astype('float32')
    y = rs.randint(0, CLASSES, (4,)).astype('float32')
    return x, y


def _weights(names_shapes):
    """``tests/test_torch_resnet.py``'s weights: He-scaled convs and
    dense, gamma near 1, beta, biases and running means near 0, running
    variances in [0.5, 1.5)."""
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
        else:
            fan_in = int(np.prod(shape[1:]))
            out[name] = w * np.float32(np.sqrt(2.0 / fan_in))
    return out


def _short(name):
    return name.split('_', 1)[1]


def _hyper(route):
    return dict(HYPER, multi_precision=route == 'cast_mp')


def _jax_route(route, weights, steps=STEPS):
    """The JAX package's narrow ResNet under ``route`` ('f32': neither
    route): loss, output dtype and step-0 gradients as its trainer traces
    them, the cast parameters' values, then ``steps`` trainer steps'
    losses."""
    net = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, LAYERS, CHANNELS,
                              classes=CLASSES)
    net.initialize(mx.init.Xavier())
    x, y = _batch()
    net(nd.array(x))                                # deferred shapes
    short = {_short(n): w for n, w in weights.items()}
    for n, p in net.collect_params().items():
        p.set_data(nd.array(short[_short(n)]))
    amp = 'bf16' if route == 'amp' else None
    if route.startswith('cast'):
        net.cast('bfloat16')
        x = jnp.asarray(x).astype(jnp.bfloat16)
    policy = jax_amp.resolve(amp) if amp else None
    L = jax_loss.SoftmaxCrossEntropyLoss()
    fwd, _, plist = pure_forward_fn(net, training=True)

    def loss_of(pa, data, label):
        with jax_amp.scope(policy):
            outs, _ = fwd(jax.random.PRNGKey(0), list(pa), [data])
            loss = L(NDArray(outs[0]), NDArray(label))
        lv = loss._data
        if policy is not None:
            lv = lv.astype(jnp.float32)
        return jnp.mean(lv), outs

    (loss, outs), grads = jax.value_and_grad(loss_of, has_aux=True)(
        [p.data()._data for p in plist], jnp.asarray(x), jnp.asarray(y))
    params = {_short(p.name): _to_torch(p.data()._data).to(
        BF if p.data()._data.dtype == jnp.bfloat16 else torch.float32)
        for p in plist}
    trainable = {_short(p.name) for p in plist if p.grad_req != 'null'}
    mesh = jax_parallel.create_mesh({'dp': 1}, devices=jax.devices()[:1])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        pt = jax_parallel.ParallelTrainer(net, L, 'sgd', _hyper(route),
                                          mesh, amp=amp)
        xs = nd.array(np.asarray(jnp.asarray(x).astype(jnp.float32)),
                      dtype=str(x.dtype))
        losses = [float(np.asarray(pt.step(xs, nd.array(_batch()[1]))
                                   .asnumpy(), dtype=np.float32))
                  for _ in range(steps)]
    return dict(loss=float(np.asarray(loss, dtype=np.float32)),
                out_dtype=str(outs[0].dtype), params=params,
                grads={_short(p.name): np.asarray(
                    g.astype(jnp.float32)) for p, g in zip(plist, grads)
                    if _short(p.name) in trainable},
                grad_dtypes={_short(p.name): str(g.dtype)
                             for p, g in zip(plist, grads)
                             if _short(p.name) in trainable},
                losses=losses)


@pytest.fixture(scope='module')
def ref():
    """Everything the JAX package computes for the two routes, as numpy
    and tensors; ``cast`` and ``cast_mp`` share the forward."""
    net = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, LAYERS, CHANNELS,
                              classes=CLASSES)
    net.initialize(mx.init.Xavier())
    net(nd.array(_batch()[0]))
    weights = _weights([(n, p.shape) for n, p in net.collect_params().items()])
    out = {'weights': weights,
           'f32_grads': _jax_route('f32', weights, steps=0)['grads']}
    for route in ROUTES:
        out[route] = _jax_route(route, weights)
    return out


def _port_route(route, weights):
    """The port's narrow ResNet and batch for ``route``, from the JAX
    weights (float32, then cast as the JAX side casts them)."""
    net = port_resnet.ResNetV1(port_resnet.BottleneckV1, LAYERS, CHANNELS,
                               classes=CLASSES, device='cpu')
    port_resnet.params_from_jax(weights, net)
    x, y = (torch.tensor(a) for a in _batch())
    if route != 'amp':
        net.cast('bfloat16')
        x = x.to(BF)
    return net, x, y


@pytest.mark.parametrize('route', ROUTES)
def test_cast_parameters_equal_jax_bitwise(ref, route):
    """float32 -> bf16 rounds to nearest even in both packages: after
    ``cast('bfloat16')`` every parameter holds the JAX net's bits, in its
    dtype (BatchNorm float32, the rest bf16); route A keeps float32
    masters."""
    net, _, _ = _port_route(route, ref['weights'])
    mine = net.collect_params().tensors()
    assert sorted(mine) == sorted(ref[route]['params'])
    for n, want in ref[route]['params'].items():
        assert mine[n].dtype == want.dtype, n
        assert torch.equal(mine[n].detach(), want), n
        bn = '_batchnorm' in '_' + n
        assert want.dtype == (torch.float32 if route == 'amp' or bn
                              else BF), n


def _port_step0(route, net, x, y):
    from mxnet_tpu_torch import amp as port_amp
    net.train(True)
    with port_amp.scope(port_amp.bf16() if route == 'amp' else None):
        logits = net(x)
        loss = port_loss.SoftmaxCrossEntropyLoss()(logits, y)
    if route == 'amp':
        loss = loss.float()
    loss = loss.mean()
    loss.backward()
    net.train(False)
    return logits, loss


def _flat(grads):
    """The gradients of the parameters whose gradient is not exactly 0
    (the conv biases feeding a BatchNorm are), as one float64 vector."""
    return np.concatenate([np.asarray(grads[n], np.float64).ravel()
                           for n in sorted(grads)
                           if not ('_conv' in '_' + n and
                                   n.endswith('_bias'))])


@pytest.mark.parametrize('route', ROUTES[:2])
def test_loss_and_step0_gradients_match_jax(ref, route):
    """Each route's loss within rtol 1e-2 of the JAX package's, and its
    step-0 gradients in the JAX package's dtypes (route A's logits bf16,
    gradients float32 at the masters; route B's logits and loss bf16,
    gradients bf16 but BatchNorm's), no farther from the JAX package's
    bf16 gradients than those lie from its float32 ones, cosine >= 0.9
    (the module docstring)."""
    want = ref[route]
    net, x, y = _port_route(route, ref['weights'])
    kernels.reset_launch_counts()
    logits, loss = _port_step0(route, net, x, y)
    assert str(logits.dtype).replace('torch.', '') == want['out_dtype'] \
        == 'bfloat16'
    assert loss.dtype == (torch.float32 if route == 'amp' else BF)
    np.testing.assert_allclose(loss.float().item(), want['loss'],
                               rtol=LOSS_RTOL)
    mine = net.collect_params().tensors()
    for n in want['grads']:
        assert str(mine[n].grad.dtype).replace('torch.', '') \
            == want['grad_dtypes'][n], n
    got = _flat({n: mine[n].grad.float().numpy() for n in want['grads']})
    theirs, f32 = _flat(want['grads']), _flat(ref['f32_grads'])
    noise = np.linalg.norm(theirs - f32)
    assert np.linalg.norm(got - theirs) <= noise
    assert got @ theirs / np.linalg.norm(got) / np.linalg.norm(theirs) \
        >= 0.9
    # CPU tensors take the plain versions: no kernel launch counted
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize('route', ROUTES)
def test_three_sgd_steps_match_jax(ref, route):
    """Three ``ParallelTrainer`` SGD steps under each route (route B
    with and without ``multi_precision``): losses within rtol 6e-2 of
    the JAX trainer's (the module docstring); the parameters keep their dtypes, and the SGD
    state is float32 masters and momentum under ``multi_precision`` or
    amp, bf16 momentum (beside BatchNorm's float32) without."""
    net, x, y = _port_route(route, ref['weights'])
    dtypes = {n: p.dtype for n, p in net.collect_params().tensors().items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        pt = port_parallel.ParallelTrainer(
            net, port_loss.SoftmaxCrossEntropyLoss(), 'sgd', _hyper(route),
            amp='bf16' if route == 'amp' else False)
        losses = [pt.step(x, y).float().item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref[route]['losses'],
                               rtol=TRAJ_RTOL, atol=0)
    assert {n: p.dtype for n, p in net.collect_params().tensors().items()} == dtypes
    states = set()
    for s in pt._states:
        for t in (s if isinstance(s, tuple) else (s,)):
            states.add(t.dtype)
    warned = [w for w in caught if 'bfloat16' in str(w.message)]
    if route == 'cast':
        assert states == {BF, torch.float32} and warned
    else:
        assert states == {torch.float32} and not warned


@pytest.mark.parametrize('route', ROUTES)
def test_bf16_trajectory_tracks_float32(route):
    """The port's bf16 routes against its float32 over 10 SGD steps on
    one batch from the same weights: within rtol 6e-2, both falling
    (``tests/test_amp.py:152-164``'s tier)."""
    weights = _weights([('resnetv10_' + n, tuple(p.shape)) for n, p in
                        port_resnet.ResNetV1(
                            port_resnet.BottleneckV1, LAYERS, CHANNELS,
                            classes=CLASSES, device='cpu')
                        .collect_params().tensors().items()])
    runs = {}
    for r in ('f32', route):
        net, x, y = _port_route('amp' if r == 'f32' else r, weights)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            pt = port_parallel.ParallelTrainer(
                net, port_loss.SoftmaxCrossEntropyLoss(), 'sgd', _hyper(r),
                amp='bf16' if r == 'amp' else False)
            runs[r] = [pt.step(x, y).float().item() for _ in range(10)]
    l32, l16 = runs['f32'], runs[route]
    assert all(np.isfinite(l16))
    np.testing.assert_allclose(l16, l32, rtol=TRAJ_RTOL)
    assert l16[-1] < l16[0] and l32[-1] < l32[0]


def _todays_steps(net, x, y, n):
    """The float32 SGD step as ``ParallelTrainer.step`` ran it before the
    low-precision protocol: ``create_state`` and ``update`` for every
    parameter that takes a gradient."""
    opt = port_optmod.create('sgd', **HYPER)
    named = list(net.collect_params().tensors().items())
    opt.idx2name = {i: k for i, (k, _) in enumerate(named)}
    params = [(i, p) for i, (_, p) in enumerate(named) if p.requires_grad]
    states = [opt.create_state(i, p.detach()) for i, p in params]
    L = port_loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(n):
        for _, p in params:
            p.grad = None
        net.train(True)
        loss = torch.mean(L(net(x), y))
        net.train(False)
        loss.backward()
        with torch.no_grad():
            for (i, p), s in zip(params, states):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                opt.update(i, p.data, g, s)
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize('amp', ('off', None))
def test_amp_off_is_bitwise_todays_float32_path(ref, monkeypatch, amp):
    """``amp='off'`` (or unset) on the float32 net: the trainer's losses
    and parameters are bitwise the float32 step before the low-precision
    protocol."""
    monkeypatch.delenv('MXNET_TPU_AMP', raising=False)
    want_net, x, y = _port_route('amp', ref['weights'])
    want = _todays_steps(want_net, x, y, STEPS)
    net, _, _ = _port_route('amp', ref['weights'])
    pt = port_parallel.ParallelTrainer(
        net, port_loss.SoftmaxCrossEntropyLoss(), 'sgd', dict(HYPER),
        amp=amp)
    assert pt.amp == 'off'
    assert [pt.step(x, y).item() for _ in range(STEPS)] == want
    theirs = want_net.collect_params().tensors()
    for n, p in net.collect_params().tensors().items():
        assert torch.equal(p, theirs[n]), n
