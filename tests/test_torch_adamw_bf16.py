"""Port parity: AdamW on bf16 weights, without and with float32 masters,
against the JAX package's traced update.

``bench_bert`` trains BERT-base after ``net.cast('bfloat16')`` with AdamW
and no ``multi_precision`` (bench.py:285-306): bf16 weights and bf16
(mean, var). The JAX trainer traces ``AdamW.update`` (optimizer.py:474-
483) with its lr, wd, ``t`` and ``rescale_grad`` as float32 scalars
(``optimizer/fused.py`` ``_HyperPatch``), so ``_adamw_update`` gets a bf16
``rescale`` array, float32 ``eta`` and ``wd`` and weak Python constants
that take bf16. ``ops/optimizer_ops.py``'s module docstring says where
XLA on the CPU rounds to bf16 and where it keeps float32.

Tolerances:
  * the op (``adamw_update`` on bf16 tensors) against ``_adamw_update``
    traced that way, with the same float32 eta and wd: byte for byte
    (weight, mean and var), with and without rescale and clip;
  * ``mp_adamw_update`` against ``_mp_adamw_update`` (its float32 hypers
    traced as well): the bf16 weight byte for byte but at most one
    element in 10^4 one bf16 ULP off (measured 0), the float32 master,
    mean and var within 2^-22 of the terms they sum (XLA on the CPU
    contracts the float32 multiply-adds into fused ones, one rounding of
    each product), as ``tests/test_torch_resnet_bf16.py`` bounds the mp
    SGD ops;
  * three ``update_multi_precision`` steps of the optimizer against the
    JAX optimizer traced as its trainer traces it, each from the same
    weight and state: the port computes ``eta`` in double and rounds it
    to float32 where the op multiplies, the reference in float32 on the
    device, where ``1 - 0.999^t`` cancels its rounding, so the two
    ``eta`` lie up to ~1e-4 apart (relative). Without a master the mean
    and var are byte for byte and the weight within one bf16 ULP plus
    that share of the step (``ETA_REL * STEP_MAX * lr``) in at most 0.1 %
    of its elements (measured 0.03 %); with one, the bf16 weight the
    same, the float32 mean, var and master within 2^-22 of the terms
    they sum, the master also within that share of the step;
  * the warning of ``create_state_multi_precision``: one per bf16 weight
    without ``multi_precision``, as in the JAX package, none with it;
  * float32 AdamW unchanged: the op bitwise its expression before bf16
    was ported.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu.ops import optimizer_ops as jax_opt
from mxnet_tpu.optimizer import AdamW as JaxAdamW
from mxnet_tpu.optimizer.fused import (_HyperPatch, _flatten_state,
                                       apply_traced_updates)
from mxnet_tpu_torch.ops import optimizer_ops as port_opt
from mxnet_tpu_torch.optimizer import optimizer as port_optmod

torch.set_num_threads(1)

BF = torch.bfloat16
N = 100003
LR = 1e-3
# the reference's eta, lr * (1 - 0.999^t)^0.5 / (1 - 0.9^t) in float32,
# lies this far (relative) from the port's, formed in double: 1 - 0.999^t
# cancels its float32 rounding up to ~1e-4 at t = 1
ETA_REL = 1e-4
# Adam's step m / (sqrt(v) + eps) + wd * w is at most ~1 / sqrt(1 -
# beta2) ~ 3.2 in magnitude at t = 1 (here < 4)
STEP_MAX = 4.0


def _to_torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


def _inputs(seed, n=N):
    rs = np.random.RandomState(seed)
    return (rs.randn(n).astype('float32'),
            (rs.randn(n) * 1e-2).astype('float32'),
            (rs.randn(n) * 1e-3).astype('float32'),
            (np.abs(rs.randn(n)) * 1e-5).astype('float32'))


def _bf16(a):
    t = torch.tensor(a).to(BF)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _eta(t, lr=1e-4):
    return lr * (1 - 0.999 ** t) ** 0.5 / (1 - 0.9 ** t)


@pytest.mark.parametrize('t,rescale,clip', [(1, 1.0, None), (5, 0.37, None),
                                            (2, 1.0, 0.004),
                                            (7, 3.0, 0.0031)])
def test_adamw_op_on_bf16_matches_jax_byte_for_byte(t, rescale, clip):
    w, g, m, v = _inputs(t)
    (wt, jw), (gt, jg), (mt, jm), (vt, jv) = (_bf16(a) for a in (w, g, m, v))
    eta = _eta(t)

    def fn(eta, wd, resc, w, g, m, v):
        # the reference's nd.full((1,), rescale_grad, dtype=weight.dtype)
        r = jnp.full((1,), resc, dtype=jnp.bfloat16)
        kw = dict(lr=1.0, eta=eta, wd=wd, beta1=0.9, beta2=0.999,
                  epsilon=1e-8)
        if clip is not None:
            kw['clip_gradient'] = clip
        out = jax_opt.adamw_update(w, g, m, v, r, **kw)
        return tuple(o.astype(jnp.bfloat16) for o in out)
    want = [_to_torch(o) for o in jax.jit(fn)(
        np.float32(eta), np.float32(0.01), np.float32(rescale), jw, jg, jm,
        jv)]
    out = port_opt.adamw_update(wt, gt, mt, vt, rescale, lr=1.0, eta=eta,
                                wd=0.01, clip_gradient=clip)
    assert out[0] is wt and out[1] is mt and out[2] is vt
    for name, got, ref in zip(('weight', 'mean', 'var'), (wt, mt, vt), want):
        assert got.dtype == BF, name
        assert torch.equal(got.float(), ref), name


def _fused_bound(got, want, terms):
    bound = 2.0 ** -22 * sum(x.abs() for x in terms)
    return bool(((got - want).abs() <= bound).all())


def test_mp_adamw_update_matches_jax():
    w, g, m, v = _inputs(11)
    (wt, jw), (gt, jg) = _bf16(w), _bf16(g)
    w32, mean, var = wt.float(), torch.tensor(m), torch.tensor(v)
    eta, wd = _eta(3, 1e-3), 0.01

    def fn(eta, wd, resc, w, g, m, v, w32):
        out = jax_opt.mp_adamw_update(w, g, m, v, w32,
                                      jnp.full((1,), resc, jnp.float32),
                                      lr=1.0, eta=eta, wd=wd)
        return tuple(o.astype(a.dtype) for o, a in zip(out, (w, m, v, w32)))
    jw_, jm_, jv_, j32 = (_to_torch(o) for o in jax.jit(fn)(
        np.float32(eta), np.float32(wd), np.float32(1.0), jw, jg,
        jnp.asarray(m), jnp.asarray(v), jnp.asarray(w32.numpy())))
    old32, g32 = w32.clone(), gt.float()
    out = port_opt.mp_adamw_update(wt, gt, mean, var, w32, 1.0, lr=1.0,
                                   eta=eta, wd=wd)
    assert out[0] is wt and out[3] is w32
    assert wt.dtype == BF and w32.dtype == mean.dtype == torch.float32
    assert int((wt.float() != jw_).sum()) <= N // 10 ** 4
    assert _fused_bound(mean, jm_, (0.9 * torch.tensor(m), 0.1 * g32))
    assert _fused_bound(var, jv_, (0.999 * torch.tensor(v),
                                   1e-3 * g32 * g32))
    step = var.sqrt()
    assert _fused_bound(w32, j32, (old32, eta * (mean / (step + 1e-8)),
                                   eta * wd * old32))


def _traced_optimizer(mp, w0):
    """The JAX AdamW traced as ``ParallelTrainer`` traces it: one jitted
    ``apply_traced_updates`` under ``_HyperPatch``, float32 hypers."""
    jopt = JaxAdamW(learning_rate=1e-3, wd=0.01, multi_precision=mp)
    jopt.idx2name = {0: 'a_weight'}
    jw = jnp.asarray(w0).astype(jnp.bfloat16)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        state = jopt.create_state_multi_precision(0, NDArray(jw))
    leaves = []
    templates = [_flatten_state(state, leaves)]

    def fn(lrs, wds, ts, rescale, w, g, *leaves):
        with _HyperPatch(jopt, [0], lrs, wds, ts, rescale):
            new_w, new_leaves = apply_traced_updates(
                jopt, [0], [w], [g], templates, list(leaves))
        return new_w[0], tuple(new_leaves)
    return jax.jit(fn), jw, [l._data for l in leaves]


@pytest.mark.parametrize('mp', [False, True], ids=['no master', 'master'])
def test_adamw_optimizer_three_steps_match_jax_traced_update(mp):
    """Each step from the same weight and state (the port's tensors take
    the JAX step's results before the next), ``t`` 1, 2, 3 per index."""
    rs = np.random.RandomState(3)
    w0 = (rs.randn(N) * 0.05).astype('float32')
    grads = [(rs.randn(N) * 1e-2).astype('float32') for _ in range(3)]
    fn, jw, leaves = _traced_optimizer(mp, w0)
    opt = port_optmod.AdamW(learning_rate=LR, wd=0.01, multi_precision=mp)
    opt.idx2name = {0: 'a_weight'}
    wt = torch.tensor(w0).to(BF)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        state = opt.create_state_multi_precision(0, wt)
    mine = [state[0], *state[1]] if mp else list(state)
    for t, g in enumerate(grads, 1):
        olds = [x.clone() for x in mine]
        g32 = torch.tensor(g).to(BF).float()
        jw, leaves = fn(np.array([LR], 'float32'),
                        np.array([0.01], 'float32'),
                        np.array([t], 'float32'), np.float32(1.0), jw,
                        jnp.asarray(g).astype(jnp.bfloat16), *leaves)
        opt.update_multi_precision(0, wt, torch.tensor(g).to(BF), state)
        assert opt._index_update_count[0] == t
        ref = _to_torch(jw)
        off = (wt.float() - ref).abs()
        assert wt.dtype == BF
        assert int((off > 0).sum()) <= N // 1000
        assert bool((off <= _ulp_bf16(torch.maximum(wt.float().abs(),
                                                    ref.abs()))
                     + ETA_REL * STEP_MAX * LR).all())
        for k, (got, want) in enumerate(zip(mine, leaves)):
            want = _to_torch(want)
            if not mp:
                assert got.dtype == BF and torch.equal(got.float(), want)
                continue
            assert got.dtype == torch.float32
            # the terms each float32 result sums (XLA fuses their
            # multiply-adds)
            terms = ((olds[0], got - olds[0]), (0.9 * olds[1], 0.1 * g32),
                     (0.999 * olds[2], 1e-3 * g32 * g32))[k]
            bound = 2.0 ** -22 * sum(x.abs() for x in terms) \
                + (ETA_REL * STEP_MAX * LR if k == 0 else 0.0)
            assert bool(((got - want).abs() <= bound).all()), k
        # the next step starts from the reference's weight and state
        wt.copy_(ref)
        for got, want in zip(mine, leaves):
            got.copy_(_to_torch(want))


def _ulp_bf16(x):
    """One bf16 ULP at each element of ``x``."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def test_warning_per_bf16_weight_as_jax():
    ws = [np.full((3,), 0.5, np.float32) for _ in range(5)]
    counts = {}
    for pkg, opt in (('jax', JaxAdamW()), ('port', port_optmod.AdamW())):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            for i, w in enumerate(ws):
                if pkg == 'jax':
                    st = opt.create_state_multi_precision(
                        i, NDArray(jnp.asarray(w).astype(jnp.bfloat16)))
                    assert str(st[0].dtype) == 'bfloat16'
                else:
                    st = opt.create_state_multi_precision(
                        i, torch.tensor(w).to(BF))
                    assert st[0].dtype == st[1].dtype == BF
        counts[pkg] = [str(c.message) for c in caught
                       if 'Accumulating with bfloat16' in str(c.message)]
    assert len(counts['port']) == len(counts['jax']) == len(ws)
    assert counts['port'] == counts['jax']
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        master, (mean, var) = port_optmod.AdamW(
            multi_precision=True).create_state_multi_precision(
                0, torch.tensor(ws[0]).to(BF))
    assert not caught
    assert master.dtype == mean.dtype == var.dtype == torch.float32


def test_float32_adamw_op_unchanged():
    """The float32 op is the expression it was before bf16 weights were
    ported: its ops in the same order, bit for bit."""
    w, g, m, v = (torch.tensor(a) for a in _inputs(21, 4097))
    want_w, want_m, want_v = w.clone(), m.clone(), v.clone()
    gg = torch.clamp(g * 0.5, -0.01, 0.01)
    want_m.mul_(0.9).add_((1 - 0.9) * gg)
    want_v.mul_(0.999).add_((1 - 0.999) * torch.square(gg))
    want_w.sub_(2e-4 * (1.0 * want_m / (torch.sqrt(want_v) + 1e-8)
                        + 0.01 * want_w))
    port_opt.adamw_update(w, g, m, v, 0.5, lr=1.0, eta=2e-4, wd=0.01,
                          clip_gradient=0.01)
    assert torch.equal(w, want_w) and torch.equal(m, want_m) \
        and torch.equal(v, want_v)
