"""``mx.nd.random``: the samplers, the counterpart of
``mxnet_tpu/ndarray/random.py``; each draws from the generator of the
device it samples on (``mx.random.seed`` resets them)."""
from __future__ import annotations

from .ndarray import NDArray, invoke
from ..random import seed  # noqa: F401  (mx.nd.random.seed)


def _sample(opname, shape, dtype, ctx, kw):
    return invoke(opname, [], {'shape': shape, 'dtype': dtype, 'ctx': ctx,
                               **kw})


def uniform(low=0.0, high=1.0, shape=(1,), dtype='float32', ctx=None,
            out=None, **kwargs):
    if isinstance(low, NDArray):
        return invoke('_sample_uniform', [low, high], {'shape': shape})
    return _sample('_random_uniform', shape, dtype, ctx,
                   {'low': float(low), 'high': float(high)})


def normal(loc=0.0, scale=1.0, shape=(1,), dtype='float32', ctx=None,
           out=None, **kwargs):
    if isinstance(loc, NDArray):
        return invoke('_sample_normal', [loc, scale], {'shape': shape})
    return _sample('_random_normal', shape, dtype, ctx,
                   {'loc': float(loc), 'scale': float(scale)})


def randn(*shape, dtype='float32', loc=0.0, scale=1.0, ctx=None, **kwargs):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def randint(low, high=None, shape=(1,), dtype='int32', ctx=None, out=None,
            **kwargs):
    if high is None:
        low, high = 0, low
    return _sample('_random_randint', shape, dtype, ctx,
                   {'low': int(low), 'high': int(high)})


def poisson(lam=1.0, shape=(1,), dtype='float32', ctx=None, out=None, **kw):
    if isinstance(lam, NDArray):
        return invoke('_sample_poisson', [lam], {'shape': shape})
    return _sample('_random_poisson', shape, dtype, ctx, {'lam': float(lam)})


def exponential(scale=1.0, shape=(1,), dtype='float32', ctx=None, out=None,
                **kw):
    if isinstance(scale, NDArray):
        return invoke('_sample_exponential', [1.0 / scale], {'shape': shape})
    return _sample('_random_exponential', shape, dtype, ctx,
                   {'lam': 1.0 / float(scale)})


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype='float32', ctx=None,
          out=None, **kw):
    if isinstance(alpha, NDArray):
        return invoke('_sample_gamma', [alpha, beta], {'shape': shape})
    return _sample('_random_gamma', shape, dtype, ctx,
                   {'alpha': float(alpha), 'beta': float(beta)})


def negative_binomial(k=1, p=1, shape=(1,), dtype='float32', ctx=None,
                      out=None, **kw):
    return _sample('_random_negative_binomial', shape, dtype, ctx,
                   {'k': int(k), 'p': float(p)})


def generalized_negative_binomial(mu=1, alpha=1, shape=(1,), dtype='float32',
                                  ctx=None, out=None, **kw):
    return _sample('_random_generalized_negative_binomial', shape, dtype, ctx,
                   {'mu': float(mu), 'alpha': float(alpha)})


def multinomial(data, shape=(), get_prob=False, dtype='int32', **kwargs):
    return invoke('_sample_multinomial', [data],
                  {'shape': shape, 'get_prob': get_prob, 'dtype': dtype})


def shuffle(data, **kwargs):
    return invoke('_shuffle', [data], {})
