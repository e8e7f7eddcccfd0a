"""bf16 matrix products on the tensor cores: the four CUDA kernels of the
matmul probe and their plain PyTorch version.

The counterpart of the Pallas bodies and of ``lax_mm`` in
``tools/probe_matmul_pipeline.py`` (:35-139): ``Y = bf16(A . B)`` for ``A``
(M, K) and ``B`` (K, N) in bf16, the sum taken in float32. The four
variants (``csrc/matmul.cu``) compute the same ``Y`` and differ only in
how they schedule it on the card:

  * ``cur``   -- ``pallas_cur`` :41: blocks in (m, n) order, the float32
    accumulator staged in shared memory before the cast;
  * ``noacc`` -- ``pallas_noacc`` :65: the same order, the accumulator
    registers cast and stored straight from the fragments;
  * ``ws``    -- ``pallas_ws`` :88: (n, m) order, so that consecutive
    blocks share the weight tile;
  * ``ep``    -- ``pallas_ep`` :112: persistent blocks walking (n, m)
    tiles through one double-buffered copy ring (``emit_pipeline``).

The TPU's ``bm`` and ``bn`` are VMEM tile sizes; the port does not take
them: its tile is 128 x 128 (128 x 64 for N <= 64) with K in slices of
32, chosen for Hopper's shared memory (``csrc/matmul.cu``). The TPU
kernels' grid is ``M // bm``, so they leave the rows past
``(M // bm) * bm`` unwritten; the port computes every row.

Wrapper rules as in ``nms.py``: the inputs are checked on any device (bf16,
2-D, contiguous, matching K, K and N multiples of 8 so that every row
starts on 16 bytes, K >= 8); a CPU tensor then takes the plain version
(:func:`matmul_reference`), a CUDA tensor launches the kernel or raises,
and each launch is counted under ``matmul_<variant>``.
"""
from __future__ import annotations

import ctypes

import torch

from ._launch import (check_inputs as _check_inputs, count as _count,
                      on_cpu as _on_cpu, ptr as _ptr, raise_on as _raise_on,
                      require as _require, stream as _stream)

__all__ = ['VARIANTS', 'matmul', 'matmul_reference', 'matmul_cur',
           'matmul_noacc', 'matmul_ws', 'matmul_ep']

VARIANTS = ('cur', 'noacc', 'ws', 'ep')
# the kernels take M, N and K as 32-bit ints
_MAX_DIM = 2 ** 31 - 1


def matmul_reference(a, b):
    """Plain PyTorch version: ``bf16(float32(a) @ float32(b))``, every row
    computed."""
    return (a.float() @ b.float()).to(torch.bfloat16)


def _check(kernel, a, b, variant):
    _require(variant in VARIANTS, 'matmul: unknown variant %r (have %s)'
             % (variant, ', '.join(VARIANTS)))
    _require(a.dim() == 2 and b.dim() == 2, '%s: a and b must be 2-D, got '
             '%r and %r' % (kernel, tuple(a.shape), tuple(b.shape)))
    _require(a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16,
             '%s: a and b must be bfloat16, got %s and %s'
             % (kernel, a.dtype, b.dtype))
    (m, k), n = a.shape, b.shape[1]
    _require(b.shape[0] == k, '%s: a is %r, b is %r: K differs'
             % (kernel, tuple(a.shape), tuple(b.shape)))
    _require(k >= 8 and k % 8 == 0 and n % 8 == 0, '%s: K = %d and N = %d '
             'must be multiples of 8 (each row starts on 16 bytes), K >= 8'
             % (kernel, k, n))
    _require(max(m, n, k) <= _MAX_DIM, '%s: a dimension exceeds %d'
             % (kernel, _MAX_DIM))
    _require(a.is_contiguous() and b.is_contiguous(),
             '%s: a and b must be contiguous' % kernel)


def _lib(variant):
    from . import _build
    fn = getattr(_build.load('matmul'), 'mx_matmul_' + variant)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
    return fn


def matmul(a, b, variant='cur', out=None):
    """``bf16(a @ b)`` for bf16 ``a`` (M, K) and ``b`` (K, N) by the
    kernel ``variant`` (one of :data:`VARIANTS`); ``out``, when given, is
    the bf16 (M, N) tensor to write (else one is allocated with
    ``torch.empty``)."""
    kernel = 'matmul_%s' % variant
    _check(kernel, a, b, variant)
    m, n = a.shape[0], b.shape[1]
    if out is not None:
        _require(tuple(out.shape) == (m, n), '%s: out is %r, expected %r'
                 % (kernel, tuple(out.shape), (m, n)))
    if _on_cpu(kernel, a):
        y = matmul_reference(a, b)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    _check_inputs(kernel, {'a': a, 'b': b, 'y': out},
                  dict.fromkeys(('a', 'b', 'y'), torch.bfloat16))
    if m == 0 or n == 0:
        return out
    device = a.device
    with torch.cuda.device(device):
        err = _lib(variant)(_ptr(a), _ptr(b), _ptr(out), m, n, a.shape[1],
                            _stream(device))
    _raise_on(kernel, err)
    _count(kernel)
    return out


def matmul_cur(a, b, out=None):
    return matmul(a, b, 'cur', out)


def matmul_noacc(a, b, out=None):
    return matmul(a, b, 'noacc', out)


def matmul_ws(a, b, out=None):
    return matmul(a, b, 'ws', out)


def matmul_ep(a, b, out=None):
    return matmul(a, b, 'ep', out)
