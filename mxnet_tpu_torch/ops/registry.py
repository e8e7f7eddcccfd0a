"""The port's op registry, the counterpart of ``mxnet_tpu/ops/registry.py``.

Each op is a torch function ``fn(*tensors, **attrs) -> tensor | tuple``
under its reference name (``FullyConnected``, ``broadcast_add``, ...),
with the JAX registry's metadata: ``num_inputs`` (-1: the first argument
is a list, as ``add_n`` / ``Concat``), ``num_outputs``,
``key_var_num_args``, ``needs_rng`` (the function then takes a
``torch.Generator`` as its first argument: the frontend passes the
generator of the output's device, :func:`mxnet_tpu_torch.random.generator`)
and ``mutate_idx`` (inputs the eager frontend updates in place with the
matching outputs: the optimizer update ops). Gradients are torch's
autograd over the function; a kernel op routes through ``ops/kernels``
as its function always does (a CUDA tensor launches the kernel, a CPU one
runs its plain version).

``mx.nd.<name>`` is generated from this table (``ndarray/register.py``).
The ops come from ``ops/math.py``, ``ops/tensor.py``,
``ops/random_ops.py`` and the registrations at the end of ``ops/nn.py``,
``ops/optimizer_ops.py`` and ``ops/contrib.py`` (:func:`load_all`).
"""
from __future__ import annotations

import functools
import inspect

__all__ = ['Operator', 'register', 'get', 'list_ops', 'alias', 'OPS',
           'load_all']

OPS = {}


class Operator:
    """A registered op: its name, function and metadata (see the module
    docstring)."""

    __slots__ = ('name', 'fn', 'num_inputs', 'num_outputs',
                 'key_var_num_args', 'needs_rng', 'mutate_idx', 'doc',
                 'attr_names')

    def __init__(self, name, fn, num_inputs=1, num_outputs=1,
                 key_var_num_args=None, needs_rng=False, mutate_idx=(),
                 doc=None):
        self.name = name
        self.fn = fn
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.key_var_num_args = key_var_num_args
        self.needs_rng = needs_rng
        self.mutate_idx = tuple(mutate_idx)
        self.doc = doc or (fn.__doc__ if fn else None)
        try:
            sig = inspect.signature(fn)
            self.attr_names = [p.name for p in sig.parameters.values()
                               if p.kind == inspect.Parameter.KEYWORD_ONLY]
        except (TypeError, ValueError):
            self.attr_names = []

    def bind_attrs(self, **attrs):
        """``fn`` with its attributes bound."""
        return functools.partial(self.fn, **attrs) if attrs else self.fn

    def __repr__(self):
        return 'Operator(%s)' % self.name


def register(name, num_inputs=1, num_outputs=1, key_var_num_args=None,
             needs_rng=False, mutate_idx=(), aliases=()):
    """Decorator registering a torch function as the op ``name`` (and
    ``aliases``)."""
    def _reg(fn):
        op = Operator(name, fn, num_inputs=num_inputs,
                      num_outputs=num_outputs,
                      key_var_num_args=key_var_num_args,
                      needs_rng=needs_rng, mutate_idx=mutate_idx)
        OPS[name] = op
        for al in aliases:
            OPS[al] = op
        return fn
    return _reg


def alias(existing, *names):
    op = OPS[existing]
    for n in names:
        OPS[n] = op


def get(name):
    load_all()
    return OPS[name]


def list_ops():
    load_all()
    return sorted(OPS.keys())


_LOADED = []


def load_all():
    """Import every module that registers ops (once)."""
    if _LOADED:
        return
    _LOADED.append(True)
    from . import contrib, math, nn, optimizer_ops, random_ops, tensor  # noqa: F401
