"""Port parity: the optimizer zoo of the port (``optimizer/optimizer.py``:
Signum, FTML, DCASGD, NAG, SGLD, ccSGD, AdaGrad, RMSProp, AdaDelta, Ftrl,
Adamax, Nadam, LBSGD, Test) against the JAX package's classes.

Three updates of three parameters from the same numpy-seeded weights and
gradients through each package's ``update_multi_precision``, with the
reference's bookkeeping: an lr and a wd multiplier, per-index update
counts (one index starts late), ``rescale_grad``, ``clip_gradient``, wd;
momentum 0 and not 0, RMSProp plain and centered. Each weight and state
tensor within 1e-5 of its largest magnitude (the JAX ops round their
Python-float hyperparameters to float32 as weak types, the port's the
same; a few float32 ULPs apart). SGLD's deterministic part is held so
with its noise set to zero in both packages, its noise by its law: the
mean and variance of 10^5 draws against N(0, lr).
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu import nd
from mxnet_tpu import optimizer as jax_optimizer
from mxnet_tpu_torch import optimizer as port_optimizer
from mxnet_tpu_torch.optimizer import optimizer as port_optmod

REL = 1e-5
SHAPES = ((5, 7), (11,), (3, 2, 2))
NAMES = {0: 'p0_weight', 1: 'p1_bias', 2: 'p2_weight'}
BASE = dict(rescale_grad=0.5, clip_gradient=0.3, wd=1e-3)
# (optimizer, hyperparameters beside BASE)
CASES = [
    ('signum', dict(learning_rate=0.01, momentum=0.0)),
    ('signum', dict(learning_rate=0.01, momentum=0.9, wd_lh=0.01)),
    ('ftml', dict(learning_rate=0.01)),
    ('ftml', dict(learning_rate=0.05, beta1=0.7, clip_gradient=None)),
    ('dcasgd', dict(learning_rate=0.1, momentum=0.0)),
    ('dcasgd', dict(learning_rate=0.1, momentum=0.9, lamda=0.1)),
    ('nag', dict(learning_rate=0.1, momentum=0.0)),
    ('nag', dict(learning_rate=0.1, momentum=0.9)),
    ('sgld', dict(learning_rate=0.01)),
    ('ccsgd', dict(learning_rate=0.1, momentum=0.9)),
    ('adagrad', dict(learning_rate=0.1)),
    ('rmsprop', dict(learning_rate=0.01)),
    ('rmsprop', dict(learning_rate=0.01, centered=True, clip_weights=1.5)),
    ('adadelta', dict(rho=0.9)),
    ('ftrl', dict(learning_rate=0.1, lamda1=0.01)),
    ('adamax', dict(learning_rate=0.002)),
    ('adamax', dict(learning_rate=0.002, clip_gradient=None, wd=0.0)),
    ('nadam', dict(learning_rate=0.01)),
    ('lbsgd', dict(learning_rate=0.5, momentum=0.9)),
    ('lbsgd', dict(learning_rate=0.5)),
    ('test', dict()),
]


def _data(seed=0):
    rs = np.random.RandomState(seed)
    ws = [rs.randn(*s).astype('float32') for s in SHAPES]
    gs = [[rs.randn(*s).astype('float32') for s in SHAPES]
          for _ in range(3)]
    return ws, gs


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _flat(s)]
    return [state]


def _setup(opt):
    opt.idx2name = dict(NAMES)
    opt.set_lr_mult({'p1_bias': 0.5})
    opt.set_wd_mult({2: 3.0})
    # index 2 starts late: its update count runs ahead
    opt._index_update_count[2] = 4
    return opt


def _run(name, hyper, zero_noise=None):
    """Three steps in each package; returns ([jax tensors], [port
    tensors]) per step: weights then state tensors."""
    ws, gs = _data()
    kw = dict(BASE, **hyper)
    jopt = _setup(jax_optimizer.create(name, **kw))
    popt = _setup(port_optimizer.create(name, **kw))
    jw = [nd.array(w) for w in ws]
    pw = [torch.tensor(w) for w in ws]
    jst = [jopt.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    pst = [popt.create_state_multi_precision(i, w) for i, w in enumerate(pw)]
    steps = []
    for step in range(3):
        for i in range(len(SHAPES)):
            jopt.update_multi_precision(i, jw[i], nd.array(gs[step][i]),
                                        jst[i])
            popt.update_multi_precision(i, pw[i], torch.tensor(gs[step][i]),
                                        pst[i])
        want = [w.asnumpy() for w in jw] + [t.asnumpy() for s in jst
                                             for t in _flat(s)]
        got = [w.numpy().copy() for w in pw] + [t.numpy().copy()
                                                for s in pst
                                                for t in _flat(s)]
        steps.append((want, got))
        assert popt._index_update_count == jopt._index_update_count
        assert popt.num_update == jopt.num_update
    return steps


def _close(want, got, what):
    assert len(want) == len(got), what
    for k, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape, (what, k)
        scale = float(np.abs(a).max())
        err = float(np.abs(a - b).max())
        assert err <= REL * max(scale, 1e-30), (what, k, err, scale)


@pytest.mark.parametrize('case', range(len(CASES)),
                         ids=['%s-%d' % (c[0], k) for k, c in
                              enumerate(CASES)])
def test_optimizer_matches_jax_over_three_steps(case, monkeypatch):
    name, hyper = CASES[case]
    if name == 'sgld':
        # the deterministic part: the noise zero in both packages
        from mxnet_tpu.ndarray import random as jax_random
        monkeypatch.setattr(jax_random, 'normal',
                            lambda loc, scale, shape=None, dtype=None, **k:
                            nd.zeros(shape, dtype=dtype))
        monkeypatch.setattr(port_optmod, '_sgld_noise',
                            lambda weight, lr: torch.zeros_like(weight))
    for step, (want, got) in enumerate(_run(name, hyper)):
        _close(want, got, '%s step %d' % (name, step))


def test_registry_resolves_every_name_and_fusable_flags():
    """Every JAX optimizer name resolves in the port, to a class of the
    same name, defaults and ``fusable`` flag."""
    for key, jcls in jax_optimizer.opt_registry.items():
        pcls = port_optimizer.opt_registry[key]
        assert pcls.__name__ == jcls.__name__
        assert pcls.fusable == jcls.fusable, key
        jopt, popt = jcls(), pcls()
        for attr, val in vars(jopt).items():
            if isinstance(val, (int, float, bool)) and not attr.startswith(
                    '_') and attr != 'aggregate_num' and \
                    attr != 'begin_num_update':
                assert getattr(popt, attr) == val, (key, attr)
    assert {k for k, c in port_optimizer.opt_registry.items()
            if not c.fusable} == {'sgld', 'nadam', 'lbsgd'}


def test_sgld_noise_law():
    """SGLD with zero gradients and wd 0 moves each weight by its noise
    alone: over 10^5 draws, mean 0 and variance lr, each within five of
    its standard errors; the draws come from the port's generator of the
    weight's device (a seed repeats them)."""
    from mxnet_tpu_torch import random as port_random
    n, lr = 100000, 0.01
    draws = []
    for _ in range(2):
        port_random.seed(7)
        opt = port_optimizer.create('sgld', learning_rate=lr)
        w = torch.zeros(n)
        opt.update(0, w, torch.zeros(n), None)
        draws.append(w.double())
    assert torch.equal(draws[0], draws[1])
    x = draws[0]
    mean, var = float(x.mean()), float(x.var())
    assert abs(mean) <= 5 * math.sqrt(lr / n), mean
    assert abs(var - lr) <= 5 * lr * math.sqrt(2.0 / (n - 1)), var
