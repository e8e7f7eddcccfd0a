"""bf16 matrix products on the tensor cores: the four CUDA kernels of the
matmul probe and their plain PyTorch version.

The counterpart of the Pallas bodies and of ``lax_mm`` in
``tools/probe_matmul_pipeline.py`` (:35-139): ``Y = bf16(A . B)`` for ``A``
(M, K) and ``B`` (K, N) in bf16, the sum taken in float32. The four
variants compute the same ``Y`` and differ only in how they schedule it
on the card:

  * ``cur``   -- ``pallas_cur`` :41: blocks in (m, n) order, the float32
    accumulator staged in shared memory before the cast;
  * ``noacc`` -- ``pallas_noacc`` :65: the same order, the accumulator
    registers cast and stored straight from the fragments;
  * ``ws``    -- ``pallas_ws`` :88: one block a tile in (n, m) order, so
    that consecutive blocks share the weight tile;
  * ``ep``    -- ``pallas_ep`` :112: persistent blocks walking (n, m)
    tiles through one copy ring that runs across tiles
    (``emit_pipeline``).

All four run the TMA-fed ``wgmma`` mainloop of ``csrc/matmul_sm90.cu`` (K
in slices of 64), whose tile, ring depth, grid and shared memory come from
:func:`matmul_geometry`; the C side refuses a geometry it has no instance
of. The TPU's ``bm`` and ``bn`` are VMEM tile sizes; the port does not
take them. The TPU kernels' grid is ``M // bm``, so they leave the rows
past ``(M // bm) * bm`` unwritten; the port computes every row.

Wrapper rules as in ``nms.py``: the inputs are checked on any device (bf16,
2-D, contiguous, matching K, K and N multiples of 8 so that every row
starts on 16 bytes, K >= 8); a CPU tensor then takes the plain version
(:func:`matmul_reference`), a CUDA tensor launches the kernel or raises,
and each launch is counted under ``matmul_<variant>``.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ._launch import (check_inputs as _check_inputs, count as _count,
                      on_cpu as _on_cpu, ptr as _ptr, raise_on as _raise_on,
                      require as _require, stream as _stream)
from .attention import SMEM_BLOCK_MAX, SMS

__all__ = ['VARIANTS', 'SM90_BN', 'MatmulGeometry', 'matmul_geometry',
           'matmul', 'matmul_reference', 'matmul_cur', 'matmul_noacc',
           'matmul_ws', 'matmul_ep']

VARIANTS = ('cur', 'noacc', 'ws', 'ep')
# the variants as csrc/matmul_sm90.cu numbers them (its Variant enum)
_C_VARIANTS = ('ws', 'ep', 'cur', 'noacc')
# the kernels take M, N and K as 32-bit ints
_MAX_DIM = 2 ** 31 - 1

# The instances csrc/matmul_sm90.cu builds (its INSTANCES table):
# (variant, BM, BN) -> (the most ring stages, blocks an SM its registers
# are bounded for). BM is 64 a consumer warpgroup.
_INSTANCES = {
    ('ws', 128, 64): (4, 2), ('ws', 128, 128): (3, 2),
    ('ws', 64, 256): (2, 2), ('ws', 128, 256): (4, 1),
    ('ep', 128, 64): (8, 1), ('ep', 128, 128): (6, 1),
    ('ep', 128, 256): (4, 1),
    ('cur', 128, 64): (4, 2), ('cur', 128, 128): (3, 2),
    ('cur', 64, 256): (2, 2), ('cur', 128, 256): (4, 1),
    ('noacc', 128, 64): (4, 2), ('noacc', 128, 128): (3, 2),
    ('noacc', 128, 256): (4, 1),
}
SM90_BN = (64, 128, 256)
# ws, cur and noacc take their 128 x 256 tile (one block an SM) from this
# many K slices on; below, tiles two blocks an SM, whose loads and stores
# overlap
_DEEP = 8
_BK = 64                    # K slice: 64 bf16, one 128-byte swizzled row
_ROW = 128                  # bytes of a swizzled shared-memory row
_ALIGN = 1024               # the 128-byte swizzle's period; slack for it
_SM_SMEM = 233472           # shared memory of an SM (228 KB)
_BLOCK_RESERVED = 1024      # shared memory the system keeps a block

MatmulGeometry = collections.namedtuple(
    'MatmulGeometry', 'bm bn bk stages grid smem per_sm tiles')
MatmulGeometry.__doc__ = (
    'Launch geometry of a matmul kernel: the tile (bm, bn, bk), the ring '
    'stages, the grid, the bytes of shared memory a block, the blocks an SM '
    'and the output tiles.')


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


def _smem_bytes(variant, bm, bn, stages):
    """The kernel's layout (``layout_bytes``): alignment slack, the ring of
    ``stages`` stages (a BM x 64 A box and a 64 x BN B slice, 128 bytes a
    row), the staging (ws: the BM x BN bf16 tile over the drained ring;
    cur: the float32 tile over it; ep: two 64 x 64 bf16 boxes a warpgroup
    beside it; noacc: none), and a full and an empty mbarrier a stage."""
    ring = stages * (bm + bn) * _ROW
    if variant == 'ep':
        region = ring + 2 * bm * 64 * 2
    else:
        region = max(ring, bm * bn * {'ws': 2, 'cur': 4, 'noacc': 0}[variant])
    return _ALIGN + region + 16 * stages


def _pick_tile(variant, k, n):
    """(BM, BN): the smallest built BN that covers N (one tile across N, so
    A is read once), 256 past it, with BM 128. Below :data:`_DEEP` K slices
    the one-block-a-tile variants take two blocks an SM in place of BN
    256: ws and cur a 64 x 256 tile, noacc (no staging) 128 x 128, which
    ran faster there (probe shapes 1, 4 and 6)."""
    bn = next((b for b in SM90_BN if n <= b), SM90_BN[-1])
    if variant != 'ep' and bn == 256 and -(-k // _BK) < _DEEP:
        return (128, 128) if variant == 'noacc' else (64, 256)
    return 128, bn


def matmul_geometry(variant, m, k, n):
    """Launch geometry of the ``variant`` kernel for ``A`` (M, K) . ``B``
    (K, N), as a :class:`MatmulGeometry`.

    The tile from :func:`_pick_tile`, the ring's depth from the instance.
    ``ws``, ``cur`` and ``noacc`` take one block a tile (grid = tiles) and
    a ring no deeper than the tile's K slices, so that at K = 64 the
    staging tile (ws, cur) sets the shared memory; ``ep`` takes the
    instance's full ring and a persistent grid of min(tiles, SMS x blocks
    an SM). Blocks an SM are the fewer of what the registers are bounded
    for and what the shared memory allows."""
    _require(variant in VARIANTS, 'matmul_geometry: unknown variant %r '
             '(have %s)' % (variant, ', '.join(VARIANTS)))
    bm, bn = _pick_tile(variant, k, n)
    most, reg_blocks = _INSTANCES[(variant, bm, bn)]
    stages = most if variant == 'ep' else min(most, -(-k // _BK))
    smem = _smem_bytes(variant, bm, bn, stages)
    per_sm = min(reg_blocks, _SM_SMEM // (smem + _BLOCK_RESERVED))
    tiles = -(-m // bm) * -(-n // bn)
    grid = min(tiles, SMS * per_sm) if variant == 'ep' else tiles
    assert smem <= SMEM_BLOCK_MAX and per_sm >= 1
    return MatmulGeometry(bm, bn, _BK, stages, grid, smem, per_sm, tiles)


def _lib(variant):
    from . import _build
    lib = _build.load('matmul_sm90')
    fn = getattr(lib, 'mx_matmul_' + variant)
    if fn.argtypes is None:
        lib.mx_matmul_sm90_smem.restype = ctypes.c_int
        lib.mx_matmul_sm90_smem.argtypes = [ctypes.c_int] * 4
        for (v, bm, bn), (most, _) in _INSTANCES.items():
            for stages in range(1, most + 1):
                built = lib.mx_matmul_sm90_smem(_C_VARIANTS.index(v), bm,
                                                bn, stages)
                want = _smem_bytes(v, bm, bn, stages)
                _require(built == want, 'matmul_%s: matmul_geometry gives '
                         '%d bytes at BM %d BN %d and %d stages, the kernel '
                         'takes %d' % (v, want, bm, bn, stages, built))
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
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
    device, k = a.device, a.shape[1]
    geometry = matmul_geometry(variant, m, k, n)[:6]
    with torch.cuda.device(device):
        err = _lib(variant)(_ptr(a), _ptr(b), _ptr(out), m, n, k, *geometry,
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
