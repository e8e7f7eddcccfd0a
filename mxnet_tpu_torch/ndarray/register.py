"""Generate the eager op namespace (``mx.nd.<Name>``) from the port's op
registry, the counterpart of ``mxnet_tpu/ndarray/register.py``: one
wrapper a registered name, with the reference's call convention
(positional NDArray inputs, keyword attributes, optional ``out=``)."""
from __future__ import annotations

import sys
import types

from ..ops import registry as _registry
from .ndarray import invoke


def _make_wrapper(name, op):
    if op.num_inputs == -1:
        def wrapper(*args, out=None, name=None, **attrs):
            data = []
            for a in args:
                if isinstance(a, (list, tuple)):
                    data.extend(a)
                else:
                    data.append(a)
            if op.key_var_num_args and op.key_var_num_args not in attrs:
                attrs[op.key_var_num_args] = len(data)
            return invoke(op, data, attrs, out=out)
    elif op.num_inputs == 0:
        def wrapper(out=None, name=None, **attrs):
            return invoke(op, [], attrs, out=out)
    else:
        def wrapper(*args, out=None, name=None, **attrs):
            return invoke(op, list(args), attrs, out=out)
    wrapper.__name__ = name
    wrapper.__doc__ = op.doc
    return wrapper


def init_op_module(module_name, target_module):
    """Populate ``target_module`` with one wrapper a registered name."""
    _registry.load_all()
    for name, op in sorted(_registry.OPS.items()):
        setattr(target_module, name, _make_wrapper(name, op))
    return target_module


def make_op_module(fullname):
    mod = types.ModuleType(fullname, 'auto-generated op wrappers')
    init_op_module(fullname, mod)
    sys.modules[fullname] = mod
    return mod
