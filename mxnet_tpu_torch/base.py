"""Shared names of the imperative surface, the port's copy of what it
needs from ``mxnet_tpu/base.py``: the error class, the number and string
types the frontends test against, and the dtype names.

The JAX package names dtypes with numpy's; the port keeps those names
(``'float32'``, ``numpy.float32``) and maps them onto ``torch`` dtypes.
numpy has no bfloat16, so ``'bfloat16'`` and ``torch.bfloat16`` stand for
it on both sides.
"""
from __future__ import annotations

import numbers

import numpy as onp
import torch

__all__ = ['MXNetError', 'numeric_types', 'string_types', 'torch_dtype',
           'dtype_name']


class MXNetError(RuntimeError):
    """Error of the imperative surface (the reference's ``MXNetError``)."""


numeric_types = (float, int, onp.generic, numbers.Number)
string_types = (str,)

_TORCH = {'float32': torch.float32, 'float64': torch.float64,
          'float16': torch.float16, 'bfloat16': torch.bfloat16,
          'uint8': torch.uint8, 'int8': torch.int8, 'int32': torch.int32,
          'int64': torch.int64, 'bool': torch.bool}
_NAME = {v: k for k, v in _TORCH.items()}


def dtype_name(dtype):
    """The name of ``dtype`` ('float32', 'bfloat16', ...): a name, a
    numpy dtype or type, or a ``torch.dtype``; None means float32."""
    if dtype is None:
        return 'float32'
    if isinstance(dtype, torch.dtype):
        return _NAME[dtype]
    if isinstance(dtype, str):
        name = dtype
    else:
        name = str(dtype) if str(dtype) == 'bfloat16' \
            else onp.dtype(dtype).name
    if name not in _TORCH:
        raise TypeError('unsupported dtype %r (have %s)'
                        % (dtype, ', '.join(sorted(_TORCH))))
    return name


def torch_dtype(dtype):
    """The ``torch.dtype`` of ``dtype`` (see :func:`dtype_name`)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH[dtype_name(dtype)]

