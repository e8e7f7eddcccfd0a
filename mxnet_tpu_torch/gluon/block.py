"""The port's block base, the counterpart of ``mxnet_tpu/gluon/block.py``.

A :class:`Block` is a ``torch.nn.Module`` with a gluon name prefix, so
that :meth:`Block.collect_params` names every parameter as the JAX net's
``collect_params()`` does (minus the model's own auto-numbered prefix,
such as ``bertmodel0_``): the prefixes of the enclosing blocks, joined,
then the parameter's name. A parameter used twice (BERT's tied decoder
weight) is one entry.

As in gluon, a block computes in inference mode until a trainer switches
it to training (``Module.train()``): a new block starts with
``training`` False, and dropout is the identity there.
"""
from __future__ import annotations

import re

import numpy as onp
import torch

__all__ = ['Block', 'params_from_jax']


class Block(torch.nn.Module):
    """``torch.nn.Module`` with a gluon name ``prefix``."""

    def __init__(self, prefix=''):
        super().__init__()
        self.prefix = prefix
        self.training = False

    def collect_params(self):
        """{gluon name: Parameter}, in registration order."""
        out = {}
        _collect(self, '', out)
        return out


def _collect(mod, pre, out):
    if isinstance(mod, Block):
        pre = pre + mod.prefix
    seen = {id(p) for p in out.values()}
    for name, p in mod._parameters.items():
        if p is not None and id(p) not in seen:
            out[pre + name] = p
    for child in mod._modules.values():
        if child is not None:
            _collect(child, pre, out)


_AUTO_PREFIX = re.compile(r'^[a-z]+\d+_')


@torch.no_grad()
def params_from_jax(jax_params, net):
    """Copy a JAX net's parameters into ``net``.

    ``jax_params`` maps each name of the JAX net's ``collect_params()``
    (e.g. ``bertmodel0_enc_layer0_attn_qkv_weight``,
    ``resnetv10_stage1_batchnorm0_running_var``) to an array. The model's
    auto-numbered prefix is stripped; every remaining name must be a
    parameter of ``net`` with the same shape, and every parameter of
    ``net`` must be given, or this raises. Parameters that take no
    gradient (moving statistics) are copied too. Returns ``net``."""
    mine = net.collect_params()
    given = {}
    for name, value in jax_params.items():
        short = _AUTO_PREFIX.sub('', name, count=1)
        if short in given:
            raise ValueError('params_from_jax: %r and another name both map '
                             'to %r' % (name, short))
        given[short] = value
    unknown = sorted(set(given) - set(mine))
    missing = sorted(set(mine) - set(given))
    if unknown or missing:
        raise ValueError('params_from_jax: names do not match the net '
                         '(unknown %s, missing %s)' % (unknown, missing))
    for name, p in mine.items():
        arr = onp.array(given[name], dtype=onp.float32)
        if arr.shape != tuple(p.shape):
            raise ValueError('params_from_jax: %s has shape %r, the net %r'
                             % (name, arr.shape, tuple(p.shape)))
        p.copy_(torch.from_numpy(arr))
    return net
