"""Port parity: AdamW and SGD of the port (``ops.optimizer_ops`` and the
``optimizer.AdamW`` / ``optimizer.SGD`` bookkeeping) against the JAX
package's.

Three updates from the same numpy-seeded weights and gradients. The port
updates in place, the JAX op returns new arrays; the expressions are the
same, so the tolerance is a few float32 ulps of O(1) weights: 1e-6
absolute.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import nd
from mxnet_tpu import optimizer as jax_optimizer
from mxnet_tpu.ops import optimizer_ops as jax_ops
from mxnet_tpu_torch import optimizer as port_optimizer
from mxnet_tpu_torch.ops import optimizer_ops as port_ops

TOL = 1e-6


def _arrays(seed, shape=(5, 7)):
    rs = np.random.RandomState(seed)
    w = rs.randn(*shape).astype('float32')
    grads = [rs.randn(*shape).astype('float32') * 3 for _ in range(3)]
    return w, grads


@pytest.mark.parametrize('clip', [None, 1.5])
def test_adamw_update_matches_jax_over_three_steps(clip):
    w, grads = _arrays(0)
    jw, jm, jv = jnp.asarray(w), jnp.zeros(w.shape), jnp.zeros(w.shape)
    pw = torch.tensor(w)
    pm, pv = torch.zeros_like(pw), torch.zeros_like(pw)
    for t, g in enumerate(grads, 1):
        eta = 1e-2 * (1 - 0.999 ** t) ** 0.5 / (1 - 0.9 ** t)
        kw = dict(lr=1.0, eta=eta, wd=0.01,
                  clip_gradient=-1.0 if clip is None else clip)
        jw, jm, jv = jax_ops.adamw_update(jw, jnp.asarray(g), jm, jv,
                                          jnp.float32(0.5), **kw)
        kw['clip_gradient'] = clip
        out = port_ops.adamw_update(pw, torch.tensor(g), pm, pv, 0.5, **kw)
        assert out[0] is pw and out[1] is pm and out[2] is pv
        for name, a, b in (('weight', pw, jw), ('mean', pm, jm),
                           ('var', pv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL, err_msg='%s t=%d'
                                       % (name, t))


def test_adamw_optimizer_t_eta_and_wd_on_every_parameter():
    """Per-index update counts from 1, eta from each index's own t, and
    weight decay on a ``_bias`` parameter too: the trainer fills
    ``idx2name`` after ``__init__`` built the wd table from none."""
    names = {0: 'net_dense_weight', 1: 'net_dense_bias'}
    hyper = {'learning_rate': 1e-2, 'wd': 0.1}
    jopt = jax_optimizer.create('adamw', **hyper)
    popt = port_optimizer.create('adamw', **hyper)
    jopt.idx2name = dict(names)
    popt.idx2name = dict(names)
    ws = {i: _arrays(10 + i, (4, 3) if i == 0 else (4,)) for i in names}
    jw = {i: nd.array(ws[i][0]) for i in names}
    pw = {i: torch.tensor(ws[i][0]) for i in names}
    jst = {i: jopt.create_state(i, jw[i]) for i in names}
    pst = {i: popt.create_state(i, pw[i]) for i in names}
    # index 1 starts one update late: its t runs behind index 0's
    schedule = [[0], [0, 1], [0, 1], [1]]
    for step, indices in enumerate(schedule):
        for i in indices:
            g = ws[i][1][min(step, 2)]
            jopt.update(i, jw[i], nd.array(g), jst[i])
            popt.update(i, pw[i], torch.tensor(g), pst[i])
            assert popt._index_update_count[i] == \
                jopt._index_update_count[i]
            np.testing.assert_allclose(pw[i].numpy(), jw[i].asnumpy(),
                                       rtol=0, atol=TOL,
                                       err_msg='index %d step %d'
                                       % (i, step))
    assert popt._index_update_count == {0: 3, 1: 3}
    assert popt.num_update == jopt.num_update == 3
    assert popt._get_wd(1) == jopt._get_wd(1) == pytest.approx(0.1)


def test_wd_mult_follows_names_known_at_init():
    opt = port_optimizer.create('adamw', wd=0.1,
                                param_idx2name={0: 'a_weight', 1: 'a_bias'})
    assert opt._get_wd(0) == pytest.approx(0.1) and opt._get_wd(1) == 0.0
    # every optimizer of the reference is ported: an unknown name raises
    with pytest.raises(ValueError, match='Cannot find optimizer'):
        port_optimizer.create('no_such_optimizer')


@pytest.mark.parametrize('momentum', [0.0, 0.9])
@pytest.mark.parametrize('wd,clip', [(0.0, None), (1e-4, None),
                                     (0.01, 1.5)])
def test_sgd_updates_match_jax_over_three_steps(momentum, wd, clip):
    w, grads = _arrays(1)
    jw, jm = jnp.asarray(w), jnp.zeros(w.shape)
    pw = torch.tensor(w)
    pm = torch.zeros_like(pw)
    for t, g in enumerate(grads, 1):
        kw = dict(lr=0.1, wd=wd, rescale_grad=0.5,
                  clip_gradient=-1.0 if clip is None else clip)
        if momentum:
            jw, jm = jax_ops.sgd_mom_update(jw, jnp.asarray(g), jm,
                                            momentum=momentum, **kw)
        else:
            jw = jax_ops.sgd_update(jw, jnp.asarray(g), **kw)
        kw['clip_gradient'] = clip
        if momentum:
            out = port_ops.sgd_mom_update(pw, torch.tensor(g), pm,
                                          momentum=momentum, **kw)
            assert out[0] is pw and out[1] is pm
            np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0,
                                       atol=TOL, err_msg='mom t=%d' % t)
        else:
            assert port_ops.sgd_update(pw, torch.tensor(g), **kw) is pw
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0,
                                   atol=TOL, err_msg='weight t=%d' % t)


@pytest.mark.parametrize('momentum', [0.0, 0.9])
def test_sgd_optimizer_matches_jax_with_wd_on_every_parameter(momentum):
    """The registered ``sgd``: state only with momentum, weight decay on
    a ``_bias`` parameter too (the names arrive after ``__init__``)."""
    names = {0: 'net_conv_weight', 1: 'net_batchnorm_beta'}
    hyper = {'learning_rate': 0.1, 'momentum': momentum, 'wd': 1e-2,
             'clip_gradient': 2.0}
    jopt = jax_optimizer.create('sgd', **hyper)
    popt = port_optimizer.create('sgd', **hyper)
    assert isinstance(popt, port_optimizer.SGD)
    jopt.idx2name = dict(names)
    popt.idx2name = dict(names)
    ws = {i: _arrays(20 + i, (4, 3) if i == 0 else (4,)) for i in names}
    jw = {i: nd.array(ws[i][0]) for i in names}
    pw = {i: torch.tensor(ws[i][0]) for i in names}
    jst = {i: jopt.create_state(i, jw[i]) for i in names}
    pst = {i: popt.create_state(i, pw[i]) for i in names}
    assert (pst[0] is None) == (momentum == 0.0)
    for step in range(3):
        for i in names:
            g = ws[i][1][step]
            jopt.update(i, jw[i], nd.array(g), jst[i])
            popt.update(i, pw[i], torch.tensor(g), pst[i])
            np.testing.assert_allclose(pw[i].numpy(), jw[i].asnumpy(),
                                       rtol=0, atol=TOL,
                                       err_msg='index %d step %d'
                                       % (i, step))
    assert popt._index_update_count == {0: 3, 1: 3}
    assert popt._get_wd(1) == jopt._get_wd(1) == pytest.approx(1e-2)
    # the decay moved the beta: without it the same steps land elsewhere
    nowd = port_optimizer.create('sgd', **dict(hyper, wd=0.0))
    nowd.idx2name = dict(names)
    beta = torch.tensor(ws[1][0])
    state = nowd.create_state(1, beta)
    for step in range(3):
        nowd.update(1, beta, torch.tensor(ws[1][1][step]), state)
    assert (beta - pw[1]).abs().max().item() > 1e3 * TOL
