"""The port's initializers (``mxnet_tpu_torch/initializer.py``) against
the JAX package's, on the CPU: the deterministic ones bit for bit, the
random ones by their bound and first two moments against the JAX
initializer's draw on the same shape (the port draws from an explicit
torch generator, the JAX package from numpy's global RNG: the bits
differ by design). The moments are held to 5 standard errors of the
draw (``n`` = 20000 values: mean within 5 sigma / sqrt(n), standard
deviation within 5 sigma / sqrt(2 n), a Gaussian's).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx

SHAPE = (100, 50, 2, 2)            # 20000 values, fan_in 200, fan_out 400
N = int(np.prod(SHAPE))


def _fill(mx, init, name='fc_weight', shape=SHAPE, ctx=None):
    arr = mx.nd.zeros(shape, ctx=ctx)
    init(mx.init.InitDesc(name), arr)
    return arr.asnumpy()


def _both(make, name='fc_weight', shape=SHAPE):
    jmx.random.seed(0)
    np.random.seed(0)
    want = _fill(jmx, make(jmx), name, shape)
    pmx.random.seed(0)
    got = _fill(pmx, make(pmx), name, shape, ctx=pmx.cpu())
    return got, want


@pytest.mark.parametrize('case', [
    ('zero', lambda mx: mx.init.Zero(), 'w_weight'),
    ('one', lambda mx: mx.init.One(), 'w_weight'),
    ('constant', lambda mx: mx.init.Constant(0.25), 'w_weight'),
    ('bilinear', lambda mx: mx.init.Bilinear(), 'up_weight'),
    ('lstm_bias', lambda mx: mx.init.LSTMBias(forget_bias=1.5), 'l_bias'),
    ('bias_suffix', lambda mx: mx.init.Uniform(), 'fc_bias'),
    ('gamma_suffix', lambda mx: mx.init.Xavier(), 'bn_gamma'),
    ('beta_suffix', lambda mx: mx.init.Xavier(), 'bn_beta'),
    ('running_mean_suffix', lambda mx: mx.init.Xavier(), 'bn_running_mean'),
    ('running_var_suffix', lambda mx: mx.init.Xavier(), 'bn_running_var'),
    ('moving_var_suffix', lambda mx: mx.init.Normal(), 'bn_moving_var'),
], ids=lambda c: c[0])
def test_deterministic_initializers_are_bitwise(case):
    _, make, name = case
    shape = (8, 4, 3, 3) if 'weight' in name else (16,)
    got, want = _both(make, name, shape)
    np.testing.assert_array_equal(got, want)


def test_load_and_mixed_are_bitwise():
    """Load (the arg: / aux: prefixes stripped, a default for the rest)
    under Mixed's first-match dispatch, the same arrays in both."""
    rs = np.random.RandomState(3)
    table = {'arg:a_weight': rs.randn(3, 4).astype('float32')}
    outs = []
    for mx in (jmx, pmx):
        load = mx.init.Load({k: mx.nd.array(v, ctx=mx.cpu())
                             for k, v in table.items()},
                            default_init=mx.init.Constant(3.0))
        mixed = mx.init.Mixed(['.*bias', '.*'],
                              [mx.init.Constant(2.0), load])
        arrs = [mx.nd.zeros(s, ctx=mx.cpu()) for s in ((3, 4), (5,), (2, 2))]
        for name, a in zip(('a_weight', 'fc_bias', 'other_weight'), arrs):
            mixed(name, a)
        outs.append([a.asnumpy() for a in arrs])
    np.testing.assert_array_equal(outs[1][0], table['arg:a_weight'])
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(g, w)


def test_create_and_dumps_match():
    for name in ('xavier', 'uniform', 'normal', 'zeros', 'ones',
                 'msraprelu', 'orthogonal'):
        assert type(pmx.init.create(name)).__name__ == \
            type(jmx.init.create(name)).__name__
    assert pmx.init.Xavier(magnitude=2).dumps() == \
        jmx.init.Xavier(magnitude=2).dumps()


RANDOM = {
    'uniform': (lambda mx: mx.init.Uniform(0.3), 0.3, 'uniform'),
    'normal': (lambda mx: mx.init.Normal(0.2), None, 'normal'),
    'xavier_uniform': (lambda mx: mx.init.Xavier(), np.sqrt(3.0 / 300),
                       'uniform'),
    'xavier_gaussian_in': (lambda mx: mx.init.Xavier(
        rnd_type='gaussian', factor_type='in', magnitude=2), None,
        'normal'),
    'msraprelu': (lambda mx: mx.init.MSRAPrelu(), None, 'normal'),
}


@pytest.mark.parametrize('name', sorted(RANDOM))
def test_random_initializers_have_the_jax_moments(name):
    make, bound, kind = RANDOM[name]
    got, want = _both(make)
    assert got.dtype == want.dtype == np.float32
    sigma = float(want.std())
    if bound is not None:
        assert np.abs(got).max() <= bound and np.abs(want).max() <= bound
        assert np.abs(got).max() > 0.99 * bound
    assert abs(float(got.mean()) - float(want.mean())) <= \
        2 * 5 * sigma / np.sqrt(N)
    assert abs(float(got.std()) - sigma) <= 2 * 5 * sigma / np.sqrt(2 * N)


def test_orthogonal_is_orthonormal_as_jax():
    got, want = _both(lambda mx: mx.init.Orthogonal(scale=1.0),
                      shape=(20, 40))
    for m in (got, want):
        np.testing.assert_allclose(m @ m.T, np.eye(20), atol=1e-5)


def test_explicit_generator_draws_are_reproducible():
    a = pmx.nd.zeros((4, 5), ctx=pmx.cpu())
    b = pmx.nd.zeros((4, 5), ctx=pmx.cpu())
    pmx.init.Xavier(generator=torch.Generator().manual_seed(7))('w_weight',
                                                                  a)
    pmx.init.Xavier(generator=torch.Generator().manual_seed(7))('w_weight',
                                                                  b)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert np.abs(a.asnumpy()).max() > 0


def test_seed_resets_the_host_generator():
    outs = []
    for _ in range(2):
        pmx.random.seed(11)
        outs.append(_fill(pmx, pmx.init.Normal(1.0), ctx=pmx.cpu()))
    np.testing.assert_array_equal(outs[0], outs[1])
