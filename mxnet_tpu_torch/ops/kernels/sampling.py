"""The sampler's noise: threefry2x32 gumbel draws, the CUDA kernel and its
plain PyTorch version.

No Pallas kernel computes it. It stands for the XLA fusion of the
reference's noise, ``jax.vmap(lambda k: jax.random.gumbel(k, (V,)))`` over
one raw key a row (``mxnet_tpu/serving/decode/sampling.py:121-123``), as
the whole-model optimizer update stands for the reference's traced update.
The bits are JAX's, integer for integer, so that a sampled token of the port
is the JAX package's wherever the two runs' perturbed scores are not a
near-tie:

  * column ``j`` of a row draws ``threefry2x32(key, (0, j))`` and XORs the
    two output words (``jax/_src/prng.py``
    ``_threefry_random_bits_partitionable``, ``iota_2x32_shape``), 20
    rounds, the key injected every four (``threefry2x32`` there);
  * the uniform keeps the top 23 bits as a mantissa in [1, 2), minus 1,
    then ``max(tiny, u * (1 - tiny) + tiny)`` in float32, which is ``u``,
    or ``tiny`` where ``u`` is 0 (``random.py`` ``uniform``);
  * the gumbel value is ``-log(-log(u))`` (``random.py`` ``_gumbel``).

:func:`threefry_gumbel` launches ``mx_threefry_gumbel`` of
``csrc/sampling.cu`` once a call, a thread a (row, column), and counts it as
``threefry_gumbel``. Its plain version :func:`threefry_gumbel_reference`
does the uint32 arithmetic in int64 with masks (about 150 tensor ops: the
reason for a kernel inside a decode step that is bound by its launch
count). A CPU tensor takes the plain version, a CUDA tensor the kernel or
an error.
"""
from __future__ import annotations

import ctypes

import torch

from ._launch import (check_inputs as _check_inputs, count as _count,
                      dense as _dense, on_cpu as _on_cpu, ptr as _ptr,
                      raise_on as _raise_on, require as _require,
                      stream as _stream)

__all__ = ['ROTATIONS', 'threefry2x32_reference', 'threefry_bits_reference',
           'uniform_from_bits', 'threefry_gumbel',
           'threefry_gumbel_reference']

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
MASK32 = 0xFFFFFFFF
TINY = float(torch.finfo(torch.float32).tiny)
MAX_ROWS = 65535           # the kernel's grid y


def threefry2x32_reference(k0, k1, x0, x1):
    """threefry2x32 of the counters (``x0``, ``x1``) under the key (``k0``,
    ``k1``): int64 tensors holding uint32 values (broadcast together), the
    two output words as int64 tensors. Every add is masked to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _keys64(keys):
    """(rows, 2) key words (int32 bits, or any int type holding uint32
    values) as int64 columns (rows, 1)."""
    k = keys.to(torch.int64) & MASK32
    return k[:, 0:1], k[:, 1:2]


def threefry_bits_reference(keys, v):
    """JAX's 32 random bits of each row's key over ``v`` columns: (rows,
    v) int64 holding uint32 values."""
    k0, k1 = _keys64(keys)
    cols = torch.arange(v, dtype=torch.int64, device=keys.device)[None, :]
    x0, x1 = threefry2x32_reference(k0, k1, torch.zeros_like(cols), cols)
    return x0 ^ x1


def uniform_from_bits(bits):
    """The float32 uniform on [tiny, 1) of JAX's ``uniform`` from its 32
    bits (int64 holding uint32 values)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + TINY, TINY)


def threefry_gumbel_reference(keys, v, uniform=False):
    """Plain version of :func:`threefry_gumbel`: the gumbel draws (or,
    with ``uniform``, the uniforms they come from) of each row's key,
    (rows, v) float32."""
    u = uniform_from_bits(threefry_bits_reference(keys, v))
    return u if uniform else -torch.log(-torch.log(u))


def _lib():
    from . import _build
    fn = _build.load('sampling').mx_threefry_gumbel
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def threefry_gumbel(keys, v, uniform=False):
    """Gumbel noise of the sampler: ``keys`` (rows, 2), one raw threefry
    key a row as int32 bits (int64 holding uint32 values on the CPU too),
    -> (rows, ``v``) float32, column ``j`` of row ``r`` JAX's
    ``jax.random.gumbel(keys[r], (v,))[j]``. ``uniform`` writes the
    uniforms instead (the card check's bitwise view of the bits). On a
    CUDA tensor one launch of the kernel, which takes int32 keys."""
    if _on_cpu('threefry_gumbel', keys, '(rows, 2)'):
        return threefry_gumbel_reference(keys, v, uniform)
    rows, v = keys.shape[0], int(v)
    _require(keys.shape[1] == 2, 'threefry_gumbel: keys must be (rows, 2), '
             'got %r' % (tuple(keys.shape),))
    _require(rows <= MAX_ROWS, 'threefry_gumbel: %d rows, more than the %d '
             'the grid holds' % (rows, MAX_ROWS))
    keys = _dense(keys)
    out = torch.empty((rows, v), dtype=torch.float32, device=keys.device)
    _check_inputs('threefry_gumbel', {'keys': keys, 'out': out},
                  {'keys': torch.int32, 'out': torch.float32})
    with torch.cuda.device(keys.device):
        err = _lib()(_ptr(keys), _ptr(out), rows, v, int(bool(uniform)),
                     _stream(keys.device))
    _raise_on('threefry_gumbel', err)
    _count('threefry_gumbel')
    return out
