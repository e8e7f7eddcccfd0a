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

:meth:`Block.cast` casts every parameter in place, as ``Block.cast``
(block.py:360-365) and ``Parameter.cast`` (parameter.py:334-339) do:
``net.cast('bfloat16')`` then trains in bf16 on bf16 data, with the
layers that keep float32 (``BatchNorm``) overriding it.
"""
from __future__ import annotations

import re

import numpy as onp
import torch

__all__ = ['Block', 'params_from_jax', 'torch_dtype']

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}


def torch_dtype(dtype):
    """The ``torch.dtype`` of ``dtype``: a ``torch.dtype``, or a name
    ('float32', 'bfloat16', 'float16') as the JAX package takes them."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    if name not in _DTYPES:
        raise TypeError('unknown dtype %r (have %s)'
                        % (dtype, ', '.join(sorted(_DTYPES))))
    return _DTYPES[name]


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

    @torch.no_grad()
    def cast(self, dtype):
        """Cast the parameters of this block and of its children to
        ``dtype`` (a name such as ``'bfloat16'`` or a ``torch.dtype``), in
        place: each stays the same ``Parameter``, with its
        ``requires_grad``, and any gradient it holds is dropped (the JAX
        ``Parameter.cast`` re-creates it). Returns ``self``."""
        dt = torch_dtype(dtype)
        for child in self._modules.values():
            _cast_module(child, dt)
        _cast_params(self._parameters.values(), dt)
        return self


def _cast_module(mod, dtype):
    """A child's cast: a Block's own (``BatchNorm`` keeps float32); a
    plain container (BERT's ``ModuleList`` of cells) casts its children
    and parameters the same way."""
    if isinstance(mod, Block):
        mod.cast(dtype)
    elif mod is not None:
        for child in mod._modules.values():
            _cast_module(child, dtype)
        _cast_params(mod._parameters.values(), dtype)


def _cast_params(params, dtype):
    for p in params:
        if p is not None:
            p.data = p.data.to(dtype)
            p.grad = None


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


# a block's auto-numbered prefix: its alias and a count (``lstm0_``;
# an RNN layer's alias is its mode, ``rnn_relu0_`` / ``rnn_tanh0_``)
_AUTO_PREFIX = re.compile(r'^(?:rnn_relu|rnn_tanh|[a-z]+)\d+_')


@torch.no_grad()
def params_from_jax(jax_params, net):
    """Copy a JAX net's parameters into ``net``.

    ``jax_params`` maps each name of the JAX net's ``collect_params()``
    (e.g. ``bertmodel0_enc_layer0_attn_qkv_weight``,
    ``resnetv10_stage1_batchnorm0_running_var``) to an array, float32 or
    bfloat16 (a bf16 value widens to float32 exactly). The model's
    auto-numbered prefix is stripped; every remaining name must be a
    parameter of ``net`` with the same shape, and every parameter of
    ``net`` must be given, or this raises. Parameters that take no
    gradient (moving statistics) are copied too. Each value lands in the
    dtype the parameter has: a float32 value into a bf16 parameter (a net
    after ``cast('bfloat16')``) rounds to nearest even, as the JAX
    package's ``astype`` does. Returns ``net``."""
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
        arr = onp.asarray(given[name]).astype(onp.float32)
        if arr.shape != tuple(p.shape):
            raise ValueError('params_from_jax: %s has shape %r, the net %r'
                             % (name, arr.shape, tuple(p.shape)))
        p.copy_(torch.from_numpy(arr))
    return net
