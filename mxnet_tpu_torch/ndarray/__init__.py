"""``mx.nd``: the imperative array and its ops, the counterpart of
``mxnet_tpu/ndarray``. Every registered op is a module attribute
(``mx.nd.FullyConnected``) and sits under ``.op`` / ``._internal``."""
import sys as _sys

from .ndarray import (NDArray, array, zeros, ones, full, empty, arange,
                      invoke, concatenate, moveaxis, maximum, minimum,
                      save, load, load_fobj, waitall)
from . import register as _register

op = _register.make_op_module(__name__ + '.op')
_internal = op

_mod = _sys.modules[__name__]
for _name in dir(op):
    if not _name.startswith('__') and not hasattr(_mod, _name):
        setattr(_mod, _name, getattr(op, _name))

from . import random  # noqa: E402,F401
