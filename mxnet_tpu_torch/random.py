"""``mx.random``: the seeded generators of the imperative surface, the
counterpart of ``mxnet_tpu/random.py``.

The JAX package keeps one process-global PRNG key chain that ``seed``
resets and every random op splits. The port keeps one
``torch.Generator`` per device instead: :func:`seed` resets the
generator of every device (``ctx='all'``) or of one context, and an op
that draws (a sampler, dropout without a trainer's generator) draws from
the generator of the device its output lies on (:func:`generator`). The
bits are torch's, not the reference's threefry: the same seed gives the
same draws in the port, not the JAX package's draws.

The initializers draw on the host (:func:`host_generator`, the CPU
generator), so a net initialized under one seed holds the same weights
on the CPU and on the card.
"""
from __future__ import annotations

import threading

import torch

__all__ = ['seed', 'generator', 'host_generator', 'uniform', 'normal',
           'randn', 'randint', 'poisson',
           'exponential', 'gamma', 'negative_binomial',
           'generalized_negative_binomial', 'multinomial', 'shuffle']

_lock = threading.Lock()
_generators = {}          # torch.device -> torch.Generator
_seed = [0]


def _key(device):
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def generator(device):
    """The generator of ``device`` (made on first use, seeded with the
    last :func:`seed`)."""
    key = _key(device)
    with _lock:
        gen = _generators.get(key)
        if gen is None:
            gen = torch.Generator(device=key)
            gen.manual_seed(_seed[0])
            _generators[key] = gen
        return gen


def host_generator():
    """The CPU generator, which the initializers draw from."""
    return generator('cpu')


def seed(seed_state, ctx='all'):
    """Seed the generators: every device's with ``ctx='all'`` (the devices
    not used yet start from this seed too), else only ``ctx``'s (a
    :class:`~mxnet_tpu_torch.context.Context` or a device)."""
    s = int(seed_state)
    with _lock:
        if isinstance(ctx, str) and ctx == 'all':
            _seed[0] = s
            for gen in _generators.values():
                gen.manual_seed(s)
            return
    from .context import Context
    dev = ctx.torch_device() if isinstance(ctx, Context) else ctx
    generator(dev).manual_seed(s)


def _delegate(name):
    def fn(*args, **kwargs):
        from .ndarray import random as _ndr
        return getattr(_ndr, name)(*args, **kwargs)
    fn.__name__ = name
    return fn


uniform = _delegate('uniform')
normal = _delegate('normal')
randn = _delegate('randn')
randint = _delegate('randint')
poisson = _delegate('poisson')
exponential = _delegate('exponential')
gamma = _delegate('gamma')
negative_binomial = _delegate('negative_binomial')
generalized_negative_binomial = _delegate('generalized_negative_binomial')
multinomial = _delegate('multinomial')
shuffle = _delegate('shuffle')
