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

import torch

__all__ = ['Block']


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
