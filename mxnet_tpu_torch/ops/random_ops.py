"""Random sampling ops, the counterpart of ``mxnet_tpu/ops/random_ops.py``.

Each op takes the ``torch.Generator`` to draw from as its first argument
(``needs_rng``): the eager frontend passes the generator of the device
the output lies on (:func:`mxnet_tpu_torch.random.generator`), which
``mx.random.seed`` resets. The distributions and parameterizations are
the JAX ops'; the bits are torch's.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from ..context import resolve_device
from .registry import alias, register


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _uniform(gen, shp, dt, dev, lo=0.0, hi=1.0):
    u = torch.rand(shp, generator=gen, dtype=torch.float32, device=dev)
    return (lo + (hi - lo) * u).to(dt)


def _normal(gen, shp, dt, dev, loc=0.0, scale=1.0):
    z = torch.randn(shp, generator=gen, dtype=torch.float32, device=dev)
    return (loc + scale * z).to(dt)


def _gamma(gen, alpha, shp, dev):
    a = torch.broadcast_to(torch.as_tensor(alpha, dtype=torch.float32,
                                           device=dev), shp).contiguous()
    return torch._standard_gamma(a, generator=gen)


def _poisson(gen, lam, shp, dev):
    rate = torch.broadcast_to(torch.as_tensor(lam, dtype=torch.float32,
                                              device=dev), shp).contiguous()
    return torch.poisson(rate, generator=gen)


def _exponential(gen, shp, dev):
    return torch.empty(shp, dtype=torch.float32,
                       device=dev).exponential_(1.0, generator=gen)


def _neg_binom(gen, k, p, shp, dev):
    lam = _gamma(gen, k, shp, dev) * ((1 - p) / p)
    return _poisson(gen, lam, shp, dev)


def _gen_neg_binom(gen, mu, alpha, shp, dev):
    if isinstance(alpha, (int, float)) and alpha == 0:
        return _poisson(gen, mu, shp, dev)
    r = 1.0 / alpha if isinstance(alpha, (int, float)) \
        else 1.0 / torch.clamp(alpha, min=1e-12)
    p = r / (r + mu)
    lam = _gamma(gen, r, shp, dev) * ((1 - p) / p)
    return _poisson(gen, lam, shp, dev)


_SAMPLERS = {
    'uniform': lambda g, s, dt, dev, kw: _uniform(
        g, s, dt, dev, kw.get('low', 0.0), kw.get('high', 1.0)),
    'normal': lambda g, s, dt, dev, kw: _normal(
        g, s, dt, dev, kw.get('loc', 0.0), kw.get('scale', 1.0)),
    'gamma': lambda g, s, dt, dev, kw: (
        _gamma(g, kw.get('alpha', 1.0), s, dev)
        * kw.get('beta', 1.0)).to(dt),
    'exponential': lambda g, s, dt, dev, kw: (
        _exponential(g, s, dev) / kw.get('lam', 1.0)).to(dt),
    'poisson': lambda g, s, dt, dev, kw: _poisson(
        g, kw.get('lam', 1.0), s, dev).to(dt),
    'negative_binomial': lambda g, s, dt, dev, kw: _neg_binom(
        g, kw.get('k', 1), kw.get('p', 1.0), s, dev).to(dt),
    'generalized_negative_binomial': lambda g, s, dt, dev, kw:
        _gen_neg_binom(g, kw.get('mu', 1.0), kw.get('alpha', 1.0), s,
                       dev).to(dt),
}


def _reg_sampler(name, sample_fn):
    # 'gamma' stays the unary gamma function (mx.nd.gamma is tgamma)
    @register('_random_%s' % name, num_inputs=0, needs_rng=True,
              aliases=(name,) if name not in ('randint', 'gamma') else ())
    def _op(gen, *, shape=None, ctx=None, dtype='float32', **kw):
        return sample_fn(gen, _shape(shape), torch_dtype(dtype or 'float32'),
                         resolve_device(ctx), kw)

    @register('_random_%s_like' % name, num_inputs=1, needs_rng=True)
    def _op_like(gen, data, **kw):
        return sample_fn(gen, tuple(data.shape), data.dtype, data.device, kw)


for _name, _fn in _SAMPLERS.items():
    _reg_sampler(_name, _fn)

alias('_random_normal', 'normal', '_sample_normal_like')
alias('_random_uniform', 'uniform')
alias('_random_exponential', 'exponential')
alias('_random_poisson', 'poisson')
alias('_random_normal', 'random_normal')
alias('_random_uniform', 'random_uniform')
alias('_random_exponential', 'random_exponential')
alias('_random_poisson', 'random_poisson')
alias('_random_gamma', 'random_gamma')
alias('_random_negative_binomial', 'random_negative_binomial')
alias('_random_generalized_negative_binomial',
      'random_generalized_negative_binomial')
alias('_random_negative_binomial', 'negative_binomial')
alias('_random_generalized_negative_binomial',
      'generalized_negative_binomial')


@register('_random_randint', num_inputs=0, needs_rng=True,
          aliases=('randint', 'random_randint'))
def randint(gen, *, low=0, high=None, shape=None, ctx=None, dtype='int32'):
    return torch.randint(int(low), int(high), _shape(shape), generator=gen,
                         device=resolve_device(ctx),
                         dtype=torch_dtype(dtype or 'int32'))


# -- per-row parameterized samplers ------------------------------------------

def _reg_multisample(name, fn, nparam):
    @register('_sample_%s' % name, num_inputs=nparam, needs_rng=True)
    def _op(gen, *params, shape=None, dtype='float32'):
        shp = _shape(shape)
        p0 = params[0]
        full = tuple(p0.shape) + shp
        bshape = tuple(p0.shape) + (1,) * len(shp)
        ps = [p.reshape(bshape) for p in params]
        return fn(gen, full, p0.device, *ps).to(torch_dtype(dtype or
                                                            'float32'))


_reg_multisample('uniform', lambda g, s, dev, lo, hi:
                 lo + (hi - lo) * torch.rand(s, generator=g, device=dev), 2)
_reg_multisample('normal', lambda g, s, dev, mu, sigma:
                 mu + sigma * torch.randn(s, generator=g, device=dev), 2)
_reg_multisample('gamma', lambda g, s, dev, alpha, beta:
                 _gamma(g, alpha, s, dev) * beta, 2)
_reg_multisample('exponential', lambda g, s, dev, lam:
                 _exponential(g, s, dev) / lam, 1)
_reg_multisample('poisson', lambda g, s, dev, lam:
                 _poisson(g, lam, s, dev), 1)
_reg_multisample('negative_binomial', lambda g, s, dev, k, p:
                 _neg_binom(g, k, p, s, dev), 2)
_reg_multisample('generalized_negative_binomial', lambda g, s, dev, mu, a:
                 _gen_neg_binom(g, mu, a, s, dev), 2)


@register('_sample_multinomial', num_inputs=1, needs_rng=True,
          aliases=('sample_multinomial',), num_outputs=-1)
def sample_multinomial(gen, data, *, shape=None, get_prob=False,
                       dtype='int32'):
    shp = _shape(shape)
    n = 1
    for s in shp:
        n *= s
    n = max(n, 1)
    probs = torch.clamp(data, min=1e-30).reshape(-1, data.shape[-1])
    out = torch.multinomial(probs, n, replacement=True, generator=gen)
    lead = () if data.dim() == 1 else (data.shape[0],)
    out_shape = lead + (shp or ())
    idx = out.reshape(out_shape)
    res = idx.to(torch_dtype(dtype))
    if get_prob:
        logp = torch.log_softmax(torch.log(probs), dim=-1)
        lp = torch.gather(logp, 1, out).reshape(out_shape)
        return res, lp
    return res


@register('_sample_unique_zipfian', num_inputs=0, needs_rng=True,
          num_outputs=2)
def sample_unique_zipfian(gen, *, range_max=None, shape=None):
    """Log-uniform candidates, unique per row, padded with 0."""
    shp = _shape(shape) or (1,)
    n = int(shp[-1])
    rows = 1
    for d in shp[:-1]:
        rows *= int(d)
    dev = gen.device
    out = torch.zeros((rows, n), dtype=torch.int32, device=dev)
    for r in range(rows):
        u = torch.rand(2 * n, generator=gen, device=dev)
        cand = (torch.exp(u * torch.log(torch.tensor(float(range_max))))
                - 1).to(torch.int32)
        uniq = torch.unique(cand)[:n]
        out[r, :uniq.numel()] = uniq
    cnt = torch.ones((rows, n), dtype=torch.int32, device=dev)
    return out.reshape(shp), cnt.reshape(shp)
