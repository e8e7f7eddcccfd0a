"""Port parity: the bf16 matmul kernels of the port
(``mxnet_tpu_torch.ops.kernels.matmul``) and its probe
(``mxnet_tpu_torch.tools.probe_matmul_pipeline``) against the JAX probe
``tools/probe_matmul_pipeline.py``: ``lax_mm`` and the four Pallas
variants, run in TPU interpret mode on the CPU.

On the CPU the port's wrappers run the plain version, ``bf16(float32(a) @
float32(b))``. Inputs come from a numpy seed and are rounded to bf16 on
both sides.

Tolerance. The bf16 products are exact in float32; a float32 sum in any
order, rounded once to bf16, lies within

    |y - y64| <= ulp_bf16(|y64|) + K * 2**-23 * (|a| @ |b|)

of the float64 product ``y64`` of the same bf16 inputs (one bf16 ulp, and
twice the first-order error bound of a float32 sum of K terms). Every
result here -- ``lax_mm``, each Pallas variant, the port's plain version
and each wrapper -- is held to that bound, computed in numpy below.

The Pallas variants' grid is ``M // bm``: rows past ``(M // bm) * bm`` are
never written, and come back NaN in the interpreter. The port computes
them (``test_tail_rows``). ``pallas_ep`` goes through ``emit_pipeline``,
which asks for the TPU generation; the test patches that one function to
answer 5 while it runs.

The CUDA kernels (all four variants in ``csrc/matmul_sm90.cu``) run only
on the card: the last test is marked ``cuda`` and skips here. What
surrounds them here is the launch geometry of the four variants
(``matmul_geometry``), held to the kernel's layout and instance table, and
mirrors of ``ep``'s tile walk, of ``cur`` and ``noacc``'s (m, n) walk, of
``cur``'s float32 staging layout and of ``noacc``'s quad transpose.
"""
import functools
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax._src.pallas.mosaic import pipeline as _pipeline
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import MATMUL_ODD
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels import attention as port_attention
from mxnet_tpu_torch.tools import probe_matmul_pipeline as port_probe

torch.set_num_threads(1)
VARIANTS = ('cur', 'noacc', 'ws', 'ep')

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'tools', 'probe_matmul_pipeline.py')
_spec = importlib.util.spec_from_file_location('jax_probe_matmul', _PATH)
jax_probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_probe)

CASES = [
    # (M, K, N, bm, bn) of the Pallas call; M % bm == 0 but in the tail case
    (256, 64, 128, 256, 128),
    (512, 256, 64, 256, 64),       # N 64, as at probe shape 2
    (128, 1024, 128, 128, 128),    # K 1024
    (64, 2048, 128, 64, 128),      # K 2048, as at probe shape 8
    (512, 512, 256, 512, 256),
    (384, 128, 256, 256, 128),     # M % bm = 128: the tail rows
]


def _ids(case):
    return 'M%d-K%d-N%d-bm%d-bn%d' % case


@functools.lru_cache(maxsize=None)
def _inputs(m, k, n, seed=0):
    """numpy float32 values of the bf16 inputs, and the float64 bound."""
    rs = np.random.RandomState(seed + m + 7 * k + 13 * n)
    a = torch.from_numpy(rs.randn(m, k).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rs.randn(k, n).astype(np.float32)).bfloat16()
    a32, b32 = a.float().numpy(), b.float().numpy()
    a64, b64 = a32.astype(np.float64), b32.astype(np.float64)
    y64 = a64 @ b64
    _, e = np.frexp(y64)
    ulp = np.where(y64 == 0, 0.0, np.ldexp(1.0, e - 8))
    allowed = ulp + k * 2.0 ** -23 * (np.abs(a64) @ np.abs(b64))
    return a32, b32, y64, allowed


def _within(y, y64, allowed, what):
    y = np.asarray(y, np.float64)
    assert y.shape == y64.shape, what
    err = np.abs(y - y64)
    worst = np.max(err / np.maximum(allowed, 1e-300))
    assert np.all(err <= allowed), '%s: |y - y64| / bound = %.3g' % (
        what, worst)


def _torch_in(m, k, n):
    a32, b32, _, _ = _inputs(m, k, n)
    return (torch.from_numpy(a32).to(torch.bfloat16),
            torch.from_numpy(b32).to(torch.bfloat16))


def _jax_in(m, k, n):
    a32, b32, _, _ = _inputs(m, k, n)
    return (jnp.asarray(a32).astype(jnp.bfloat16),
            jnp.asarray(b32).astype(jnp.bfloat16))


def _f32(y):
    return np.asarray(jnp.asarray(y).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _lax(m, k, n):
    return _f32(jax_probe.lax_mm(*_jax_in(m, k, n)))


@functools.lru_cache(maxsize=None)
def _pallas(variant, m, k, n, bm, bn):
    fn = getattr(jax_probe, 'pallas_' + variant)
    generation = _pipeline._get_tpu_generation
    _pipeline._get_tpu_generation = lambda: 5
    try:
        with pltpu.force_tpu_interpret_mode():
            return _f32(fn(*_jax_in(m, k, n), bm, bn))
    finally:
        _pipeline._get_tpu_generation = generation


def test_inputs_round_alike():
    """numpy float32 -> bf16 rounds to nearest even in both frameworks."""
    a, _ = _torch_in(256, 64, 128)
    ja, _ = _jax_in(256, 64, 128)
    np.testing.assert_array_equal(a.float().numpy(), _f32(ja))


@pytest.mark.parametrize('case', CASES, ids=_ids)
def test_reference_matches_lax_mm(case):
    m, k, n, _, _ = case
    _, _, y64, allowed = _inputs(m, k, n)
    _within(_lax(m, k, n), y64, allowed, 'lax_mm')
    y = kernels.matmul_reference(*_torch_in(m, k, n))
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, n)
    _within(y.float().numpy(), y64, allowed, 'matmul_reference')


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('case', CASES, ids=_ids)
def test_port_matches_jax(case, variant):
    """The port's wrapper, ``lax_mm`` and the Pallas variant, each within
    the float64 bound (the Pallas variant on the rows it writes)."""
    m, k, n, bm, bn = case
    _, _, y64, allowed = _inputs(m, k, n)
    y = getattr(kernels, 'matmul_' + variant)(*_torch_in(m, k, n))
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, n)
    _within(y.float().numpy(), y64, allowed, 'matmul_' + variant)
    rows = (m // bm) * bm
    _within(_pallas(variant, m, k, n, bm, bn)[:rows], y64[:rows],
            allowed[:rows], 'pallas_' + variant)
    _within(_lax(m, k, n), y64, allowed, 'lax_mm')


@pytest.mark.parametrize('variant', VARIANTS)
def test_tail_rows(variant):
    """M 384, bm 256: the Pallas grid covers rows 0-255 only; rows 256-383
    are NaN in the interpreter (unwritten), where ``lax_mm`` and the port
    compute them."""
    m, k, n, bm, bn = CASES[-1]
    assert m % bm
    rows = (m // bm) * bm
    _, _, y64, allowed = _inputs(m, k, n)
    got = _pallas(variant, m, k, n, bm, bn)
    assert np.isnan(got[rows:]).all()
    assert np.isfinite(got[:rows]).all()
    port = getattr(kernels, 'matmul_' + variant)(
        *_torch_in(m, k, n)).float().numpy()
    assert np.isfinite(port[rows:]).all()
    _within(port[rows:], y64[rows:], allowed[rows:], 'port tail rows')
    _within(_lax(m, k, n)[rows:], y64[rows:], allowed[rows:],
            'lax_mm tail rows')


@pytest.mark.parametrize('m,k,n', [(1, 72, 64), (77, 8, 136),
                                   (6349, 72, 16)])
def test_odd_shapes_match_lax_mm(m, k, n):
    """M of 1 and past a tile, K and N multiples of 8 only: every variant
    against ``lax_mm`` (the Pallas variants need M % bm == 0)."""
    _, _, y64, allowed = _inputs(m, k, n)
    _within(_lax(m, k, n), y64, allowed, 'lax_mm')
    for variant in VARIANTS:
        y = kernels.matmul(*_torch_in(m, k, n), variant)
        _within(y.float().numpy(), y64, allowed, variant)


def test_out_argument_is_written():
    a, b = _torch_in(256, 64, 128)
    out = torch.full((256, 128), float('nan'), dtype=torch.bfloat16)
    assert kernels.matmul(a, b, 'ep', out=out) is out
    _, _, y64, allowed = _inputs(256, 64, 128)
    _within(out.float().numpy(), y64, allowed, 'out')
    with pytest.raises(ValueError):
        kernels.matmul(a, b, 'cur', out=torch.empty(256, 64,
                                                    dtype=torch.bfloat16))


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize('what,a,b,variant', [
    ('dtype', torch.zeros(16, 8), _bf16(8, 8), 'cur'),
    ('rank', _bf16(2, 16, 8), _bf16(8, 8), 'noacc'),
    ('K mismatch', _bf16(16, 8), _bf16(16, 8), 'ws'),
    ('K not a multiple of 8', _bf16(16, 12), _bf16(12, 8), 'ep'),
    ('N not a multiple of 8', _bf16(16, 8), _bf16(8, 20), 'cur'),
    ('K of 0', _bf16(16, 0), _bf16(0, 8), 'cur'),
    ('not contiguous', _bf16(8, 16).t(), _bf16(8, 8), 'ws'),
    ('unknown variant', _bf16(16, 8), _bf16(8, 8), 'tiled'),
])
def test_wrapper_refuses(what, a, b, variant):
    with pytest.raises(ValueError):
        kernels.matmul(a, b, variant)


@pytest.mark.parametrize('what,a,b,variant,out', [
    ('dtype', torch.zeros(16, 64), _bf16(64, 64), 'ws', None),
    ('rank', _bf16(16, 64), _bf16(1, 64, 64), 'ep', None),
    ('K mismatch', _bf16(16, 64), _bf16(72, 64), 'ws', None),
    ('N not a multiple of 8', _bf16(16, 64), _bf16(64, 100), 'ep', None),
    ('K not a multiple of 8', _bf16(16, 4), _bf16(4, 8), 'ws', None),
    ('not contiguous', _bf16(16, 64), _bf16(64, 64).t(), 'ep', None),
    ('out shape', _bf16(16, 64), _bf16(64, 64), 'ws', _bf16(16, 72)),
    ('out shape', _bf16(16, 64), _bf16(64, 64), 'ep', _bf16(64, 16)),
])
def test_wgmma_variants_refuse(what, a, b, variant, out):
    """``ws`` and ``ep`` refuse what every variant refused before they moved
    to the wgmma mainloop."""
    with pytest.raises(ValueError):
        kernels.matmul(a, b, variant, out=out)


_matmul = importlib.import_module('mxnet_tpu_torch.ops.kernels.matmul')
_SM90_SRC = os.path.join(os.path.dirname(_matmul.__file__), 'csrc',
                         'matmul_sm90.cu')
GEOMETRY_SHAPES = [tuple(s) for s in port_probe.SHAPES] + list(MATMUL_ODD)


def _gid(shape):
    return 'M%d-K%d-N%d' % shape


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('shape', GEOMETRY_SHAPES, ids=_gid)
def test_matmul_geometry(shape, variant):
    """At the probe's eight shapes and every odd shape of chip_smoke: a
    built instance, shared memory within a block's 232,448 bytes and the
    blocks an SM within the SM's 228 KB; ws, cur and noacc one block a tile
    with a ring no deeper than the tile's K slices, ep a persistent grid of
    min(tiles, 132 x blocks an SM) and a ring of at least 4 stages and 48
    KB."""
    m, k, n = shape
    g = kernels.matmul_geometry(variant, m, k, n)
    assert (variant, g.bm, g.bn) in _matmul._INSTANCES
    most, reg_blocks = _matmul._INSTANCES[(variant, g.bm, g.bn)]
    assert g.bk == 64 and g.bn in _matmul.SM90_BN and g.bm in (64, 128)
    kt = -(-k // 64)
    # BN covers N where an instance does (A is read once); noacc takes 128
    # x 128 tiles in place of BN 256 below 8 K slices
    if variant == 'noacc' and n > 128 and kt < 8:
        assert (g.bm, g.bn) == (128, 128)
    else:
        assert g.bn >= n or g.bn == 256
    assert g.smem == _matmul._smem_bytes(variant, g.bm, g.bn, g.stages)
    assert g.smem <= port_attention.SMEM_BLOCK_MAX == 232448
    assert 1 <= g.per_sm <= reg_blocks
    assert g.per_sm * (g.smem + 1024) <= 233472
    assert g.tiles == -(-m // g.bm) * -(-n // g.bn)
    ring = g.stages * (g.bm + g.bn) * 128
    if variant == 'ep':
        assert g.grid == min(g.tiles, 132 * g.per_sm)
        assert g.stages == most >= 4 and ring >= 48 * 1024
        # two 64 x 64 bf16 staging boxes a consumer warpgroup
        assert g.smem == 1024 + ring + 2 * g.bm * 64 * 2 + 16 * g.stages
        return
    assert g.grid == g.tiles
    assert g.stages == min(most, kt)
    # ws: the bf16 tile over the drained ring; cur: the float32 tile;
    # noacc: the ring alone
    staged = {'ws': 2, 'cur': 4, 'noacc': 0}[variant] * g.bm * g.bn
    assert g.smem == 1024 + max(ring, staged) + 16 * g.stages


@pytest.mark.parametrize('shape,ws,ep,cur,noacc', [
    # (M, K, N): ws, cur and noacc (bm, bn, stages, per_sm), ep (bm, bn,
    # stages, grid)
    ((401408, 64, 256), (64, 256, 1, 2), (128, 256, 4, 132),
     (64, 256, 1, 2), (128, 128, 1, 2)),
    ((401408, 256, 64), (128, 64, 4, 2), (128, 64, 8, 132),
     (128, 64, 4, 2), (128, 64, 4, 2)),
    ((100352, 512, 128), (128, 128, 3, 2), (128, 128, 6, 132),
     (128, 128, 3, 2), (128, 128, 3, 2)),
    ((100352, 128, 512), (64, 256, 2, 2), (128, 256, 4, 132),
     (64, 256, 2, 2), (128, 128, 2, 2)),
    ((25088, 1024, 256), (128, 256, 4, 1), (128, 256, 4, 132),
     (128, 256, 4, 1), (128, 256, 4, 1)),
    ((25088, 256, 1024), (64, 256, 2, 2), (128, 256, 4, 132),
     (64, 256, 2, 2), (128, 128, 3, 2)),
    ((6272, 512, 2048), (128, 256, 4, 1), (128, 256, 4, 132),
     (128, 256, 4, 1), (128, 256, 4, 1)),
    ((6272, 2048, 512), (128, 256, 4, 1), (128, 256, 4, 98),
     (128, 256, 4, 1), (128, 256, 4, 1)),
    ((1, 64, 256), (64, 256, 1, 2), (128, 256, 4, 1), (64, 256, 1, 2),
     (128, 128, 1, 2)),
], ids=lambda x: str(x))
def test_matmul_geometry_picks(shape, ws, ep, cur, noacc):
    """BN covers N up to 256, so at probe shape 1 each variant but noacc
    reads A once; below 8 K slices ws and cur take 64 x 256 tiles two
    blocks an SM (at K 64 a one-stage ring), noacc 128 x 128 tiles two
    blocks an SM, and from 8 on all three take 128 x 256 tiles one block
    an SM; ep takes 128-row tiles and one block an SM."""
    for variant, want in (('ws', ws), ('cur', cur), ('noacc', noacc)):
        g = kernels.matmul_geometry(variant, *shape)
        assert (g.bm, g.bn, g.stages, g.per_sm) == want
    g = kernels.matmul_geometry('ep', *shape)
    assert (g.bm, g.bn, g.stages, g.grid) == ep


@pytest.mark.parametrize('variant', ('tiled', 'splitk', 'CUR'))
def test_matmul_geometry_refuses_other_variants(variant):
    with pytest.raises(ValueError, match='unknown variant'):
        kernels.matmul_geometry(variant, 128, 64, 64)


def test_instances_mirror_the_source():
    """``_INSTANCES`` is the C table ``INSTANCES`` (variant, BM, BN, stages,
    blocks an SM), each entry launched by the kernel of its variant and
    template arguments (BN, consumer warpgroups = BM / 64, blocks an SM),
    and the layout formula is the C one."""
    src = open(_SM90_SRC).read()
    names = ('ws', 'ep', 'cur', 'noacc')
    assert 'enum Variant { WS = 0, EP = 1, CUR = 2, NOACC = 3 };' in src
    assert _matmul._C_VARIANTS == names
    table = re.search(r'INSTANCES\[\] = \{(.*?)\};', src, re.S).group(1)
    rows = [tuple(int(x) for x in r.split(','))
            for r in re.findall(r'\{([\d, ]+)\}', table)]
    assert {(names[v], bm, bn): (stages, blocks)
            for v, bm, bn, stages, blocks in rows} == _matmul._INSTANCES
    assert {names[r[0]] for r in rows} == set(VARIANTS)
    kernels_of = re.findall(r'case (\d+): return matmul_(\w+)_kernel<(\d+), '
                            r'(\d+), (\d+)>;', src)
    assert len(kernels_of) == len(rows)
    for i, v, bn, cwg, blocks in kernels_of:
        variant, bm, bn_, _, blocks_ = rows[int(i)]
        assert (names[variant], bm, bn_, blocks_) == (
            v, 64 * int(cwg), int(bn), int(blocks))
    for v in names:
        assert re.search(r'__global__ void __launch_bounds__\(Tile<BN, '
                         r'CWG>::THREADS, BLOCKS\)\s+matmul_%s_kernel\(' % v,
                         src)
        assert 'gemm<BN, CWG, %s>(&ta, &tb, &ty, p);' % v.upper() in src
    assert 'ALIGN + region_bytes(v, bm, bn, stages) + 16 * stages' in src


def _ep_walk(m, k, n):
    """Mirror of the ep kernel's loops (``gemm<BN, CWG, true>``): block b
    takes tiles b, b + grid, ...; tile t sits at (t % tiles_m, t //
    tiles_m); the producer walks (tile, k slice) pairs through the ring of
    ``stages`` stages with a phase bit that flips at each wrap, and the
    consumers walk the same pairs. Returns {block: [(m0, n0), ...]} and
    each block's (stage, phase, m0, n0, k0) sequence."""
    g = kernels.matmul_geometry('ep', m, k, n)
    tiles_m = -(-m // g.bm)
    kt = -(-k // g.bk)
    walk, ring = {}, {}
    for b in range(g.grid):
        stage = phase = 0
        seq = []
        for t in range(b, g.tiles, g.grid):
            m0, n0 = (t % tiles_m) * g.bm, (t // tiles_m) * g.bn
            walk.setdefault(b, []).append((m0, n0))
            for s in range(kt):
                seq.append((stage, phase, m0, n0, s * g.bk))
                stage += 1
                if stage == g.stages:
                    stage, phase = 0, phase ^ 1
        ring[b] = seq
    return g, walk, ring


@pytest.mark.parametrize('shape', [tuple(s) for s in port_probe.SHAPES] + [
    (1, 512, 1024), (515, 200, 96), (6349, 72, 136)], ids=_gid)
def test_ep_tile_walk(shape):
    """Every output tile is visited exactly once; each block walks its tiles
    in (n outer, m inner) order; at any moment the blocks work on a window
    of consecutive tiles (sharing B's tile in L2); a stage is refilled only
    after the ring wrapped, with the other phase."""
    m, k, n = shape
    g, walk, ring = _ep_walk(m, k, n)
    seen = [t for tiles in walk.values() for t in tiles]
    want = [(tm * g.bm, tn * g.bn) for tn in range(-(-n // g.bn))
            for tm in range(-(-m // g.bm))]
    assert sorted(seen) == sorted(want) and len(set(seen)) == g.tiles
    for tiles in walk.values():
        assert tiles == sorted(tiles, key=lambda mn: (mn[1], mn[0]))
    # the i-th tile of every block lies within one window of grid tiles
    rounds = max(len(t) for t in walk.values())
    for i in range(rounds):
        ids = [want.index(t[i]) for t in walk.values() if len(t) > i]
        assert max(ids) - min(ids) < g.grid
    for seq in ring.values():
        for j, (stage, phase, *_) in enumerate(seq):
            assert (stage, phase) == (j % g.stages, (j // g.stages) % 2)


def _mn_walk(variant, m, k, n):
    """Mirror of cur and noacc's loops (``gemm<BN, CWG, CUR / NOACC>``,
    ``origin``): block b takes tile b alone (grid = tiles), at (b //
    tiles_n, b % tiles_n); its producer and consumers walk the tile's K
    slices through the ring with a phase bit that flips at each wrap.
    Returns the geometry, [(m0, n0)] by block and each block's (stage,
    phase, k0) sequence."""
    g = kernels.matmul_geometry(variant, m, k, n)
    tiles_n = -(-n // g.bn)
    walk = [((b // tiles_n) * g.bm, (b % tiles_n) * g.bn)
            for b in range(g.grid)]
    ring = [(s % g.stages, (s // g.stages) % 2, s * g.bk)
            for s in range(-(-k // g.bk))]
    return g, walk, ring


@pytest.mark.parametrize('variant', ('cur', 'noacc'))
@pytest.mark.parametrize('shape', [tuple(s) for s in port_probe.SHAPES] + [
    (1, 512, 1024), (515, 200, 96), (6349, 72, 520), (77, 1024, 40),
    (4109, 64, 264)], ids=_gid)
def test_mn_tile_walk(shape, variant):
    """Every output tile is visited exactly once, n fastest: the blocks that
    share an A tile (one row of tiles) are consecutive, and so run together
    and read A from memory once; the ring's stage and phase advance as in
    ``ep``'s walk."""
    m, k, n = shape
    g, walk, ring = _mn_walk(variant, m, k, n)
    tiles_n = -(-n // g.bn)
    want = [(tm * g.bm, tn * g.bn) for tm in range(-(-m // g.bm))
            for tn in range(tiles_n)]
    assert g.grid == g.tiles == len(want)
    assert walk == want and len(set(walk)) == g.tiles
    rows = {}
    for b, (m0, _) in enumerate(walk):
        rows.setdefault(m0, []).append(b)
    for blocks in rows.values():
        assert blocks == list(range(blocks[0], blocks[0] + tiles_n))
    for j, (stage, phase, k0) in enumerate(ring):
        assert (stage, phase) == (j % g.stages, (j // g.stages) % 2)
    assert ring[-1][2] < k <= ring[-1][2] + g.bk


def _c_body(name):
    """The body of the device function ``name`` in csrc/matmul_sm90.cu."""
    src = open(_SM90_SRC).read()
    start = src.index('{\n', src.index(' %s(' % name)) + 2
    return src[start:src.index('\n}\n', start)]


def _staged_chunk(r, c):
    expr = re.fullmatch(r'\s*return ([^;]+);\s*', _c_body('staged_chunk'))
    return eval(expr.group(1), {}, {'r': r, 'c': c})


def _banks(addresses, width):
    """Wavefronts over the banks: the most distinct 4-byte words any of the
    32 banks serves for accesses of ``width`` bytes at ``addresses``."""
    words = {}
    for a in addresses:
        for w in range(a // 4, (a + width) // 4):
            words.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in words.values())


@pytest.mark.parametrize('bn', (64, 128, 256))
def test_cur_staging_layout(bn):
    """``staged_chunk`` (parsed from the source) places each 16-byte chunk
    of a float32 row within its own 128-byte line, once; the fragments'
    8-byte writes (each half-warp: 4 rows x 2 chunks) and the read-back's
    16-byte loads (each quarter-warp: 8 chunks of a row, 32 bytes apart)
    meet every bank once; and the read-back returns every element of the
    warpgroup's 64 rows where the fragments put it."""
    pitch, chunks = bn * 4, bn // 4
    for r in range(64):
        placed = [_staged_chunk(r, c) for c in range(chunks)]
        assert sorted(placed) == list(range(chunks))
        assert all(p // 8 == c // 8 for c, p in enumerate(placed))
    # fragment writes: warp w, lane l holds rows 16 w + l / 4 (+ 8), columns
    # 8 i + 2 (l % 4) + (0, 1) as acc[4 i + (0, 1)] (+ (2, 3))
    staged = {}
    for warp in range(4):
        for i in range(bn // 8):
            for half in range(2):
                at = []
                for lane in range(16 * half, 16 * half + 16):
                    q = lane % 4
                    for dr in (0, 8):
                        r = warp * 16 + lane // 4 + dr
                        a = (r * pitch + _staged_chunk(r, 2 * i + q // 2) * 16
                             + (q % 2) * 8)
                        if dr == 0:
                            at.append(a)
                        col = 8 * i + 2 * q
                        staged[a], staged[a + 4] = (r, col), (r, col + 1)
                assert _banks(at, 8) == 1
    assert len(staged) == 64 * bn
    # read back: bn / 8 threads a row, 8 columns a thread
    tr = bn // 8
    for h in range(2):
        for first in range(0, 128, 8):
            assert _banks([(t // tr) * pitch
                           + _staged_chunk(t // tr, 2 * (t % tr) + h) * 16
                           for t in range(first, first + 8)], 16) == 1
    for tid in range(128):
        g = tid % tr
        for row in range(tid // tr, 64, 128 // tr):
            got = [staged[row * pitch + _staged_chunk(row, 2 * g + h) * 16
                          + 4 * e] for h in range(2) for e in range(4)]
            assert got == [(row, 8 * g + c) for c in range(8)]


def _run_quad_transpose(values):
    """Run ``quad_transpose`` as written in the source on the four lanes of
    a quad in lockstep: each statement for every lane, a shuffle reading
    the partner lane's values from before the statement."""
    body = re.sub(r'//[^\n]*', '', _c_body('quad_transpose'))
    envs = [{'q': q, 'v': list(values[q])} for q in range(4)]

    def python(expr):
        expr = re.sub(r'__shfl_xor_sync\(0xffffffffu, (.+?), (\d)\)',
                      r'shfl("\1", \2)', expr)
        return re.sub(r'(\w+) \? ([\w\[\]]+) : ([\w\[\]]+)',
                      r'(\2 if \1 else \3)', expr)

    for statement in filter(None, (st.strip() for st in body.split(';'))):
        statement = re.sub(r'^const (bool|uint32_t) ', '', statement)
        parts = [p.split(' = ', 1) for p in re.split(r', (?=\w+ = )',
                                                     statement)]
        before = [dict(e, v=list(e['v'])) for e in envs]
        for q, env in enumerate(envs):
            def shfl(expr, lane_xor, q=q):
                return eval(python(expr), {}, before[q ^ lane_xor])
            for lhs, rhs in parts:
                value = eval(python(rhs), {'shfl': shfl}, before[q])
                index = re.fullmatch(r'v\[(\d)\]', lhs)
                if index:
                    env['v'][int(index.group(1))] = value
                else:
                    env[lhs] = value
                    before[q][lhs] = value
    return [env['v'] for env in envs]


def test_noacc_quad_transpose():
    """``quad_transpose`` as written: lane q starts with columns 2 q, 2 q +
    1 of each of four 8-column groups and ends with the 8 columns of group
    q in order, so noacc's 16-byte store at column 8 (4 b + q) is whole."""
    got = _run_quad_transpose([[(q, j) for j in range(4)] for q in range(4)])
    assert got == [[(c, q) for c in range(4)] for q in range(4)]


@pytest.mark.parametrize('shape', [(6349, 72, 520), (77, 1024, 40),
                                   (4109, 64, 264), (1, 64, 256)], ids=_gid)
def test_mn_stores_cover_y(shape):
    """cur and noacc store 16 bytes (8 columns) where row < M and column <
    N, over every tile of the walk: the stores cover Y exactly once."""
    m, k, n = shape
    for variant in ('cur', 'noacc'):
        g, walk, _ = _mn_walk(variant, m, k, n)
        covered = np.zeros((m, n), np.int64)
        for m0, n0 in walk:
            for r in range(m0, min(m0 + g.bm, m)):
                for c in range(n0, n0 + g.bn, 8):
                    if c < n:
                        covered[r, c:c + 8] += 1
        assert (covered == 1).all()


def test_cpu_run_counts_no_launch():
    kernels.reset_launch_counts()
    a, b = _torch_in(256, 64, 128)
    for variant in VARIANTS:
        kernels.matmul(a, b, variant)
    counts = kernels.launch_counts()
    assert all(counts['matmul_' + v] == 0 for v in VARIANTS)
    assert set('matmul_' + v for v in VARIANTS) <= set(kernels.KERNELS)


def test_probe_shapes_are_the_jax_probes():
    assert [tuple(s) for s in port_probe.SHAPES] == [
        tuple(s) for s in jax_probe.SHAPES]


@pytest.mark.parametrize('shape,ms,by', [
    ((401408, 64, 256), 0.0767, 'bytes'),
    ((401408, 256, 64), 0.0767, 'bytes'),
    ((100352, 512, 128), 0.0384, 'bytes'),
    ((100352, 128, 512), 0.0384, 'bytes'),
    ((25088, 1024, 256), 0.0193, 'bytes'),
    ((25088, 256, 1024), 0.0193, 'bytes'),
    ((6272, 512, 2048), 0.0133, 'operations'),
    ((6272, 2048, 512), 0.0133, 'operations'),
])
def test_probe_bounds(shape, ms, by):
    """max(bytes / 3.35 TB/s, flops / 989 TFLOP/s): each shape is 13.15
    GFLOP; six are bound by bytes, the last two by operations."""
    got, got_by = port_probe.bound_ms(*shape)
    assert round(got, 4) == ms and got_by == by
    assert port_probe.work(*shape)[1] == 13153337344


def test_probe_float64_bound_is_the_tests():
    """The probe's bound equals the one stated here, and a result two bf16
    ulps off somewhere leaves it (at K 64 the bound is about an ulp)."""
    a, b = _torch_in(256, 64, 128)
    _, _, y64, allowed = _inputs(256, 64, 128)
    p64, p_allowed = port_probe.float64_bound(a, b)
    np.testing.assert_allclose(p64.numpy(), y64, rtol=0, atol=0)
    np.testing.assert_allclose(p_allowed.numpy(), allowed, rtol=1e-12)
    y = kernels.matmul_reference(a, b)
    assert port_probe.bound_ratio(y, p64, p_allowed) <= 1
    y.view(torch.int16)[3, 5] += 2
    assert port_probe.bound_ratio(y, p64, p_allowed) > 1
    y[0, 0] = float('nan')
    assert not port_probe.bound_ratio(y, p64, p_allowed) <= 1


def test_probe_cold_copies_exceed_l2():
    """Each timed set of inputs exceeds twice the L2, with one copy to
    spare at most: at the probe's shapes, and at a decode step's keys and
    values (8 x 512 x 768 float32, twice)."""
    sizes = [2 * (m * k + k * n) for m, k, n in port_probe.SHAPES]
    for nbytes in sizes + [2 * 8 * 512 * 768 * 4]:
        copies = port_probe.cold_copies(nbytes)
        assert copies * nbytes > 2 * port_probe.L2_BYTES
        assert (copies - 1) * nbytes <= 2 * port_probe.L2_BYTES


def test_probe_raises_without_a_card(monkeypatch):
    """No unavailable artifact, no caught failure: the probe raises."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        port_probe.main(['2'])


@pytest.mark.cuda
def test_kernels_match_plain_version_on_card():
    """``csrc/matmul_sm90.cu`` on the card at odd shapes, every instance of
    the four variants among them: each variant within the float64 bound
    and within twice it of the plain version, every row of a NaN-filled
    output written; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for sm_90a '
                    'and have no CPU mode')
    for m, k, n in [(1, 64, 256), (6349, 512, 2048), (300, 72, 64),
                    (129, 1024, 64), (257, 2048, 520), (1000, 256, 8),
                    (1024, 64, 128), (515, 200, 96), (131, 256, 256),
                    (1, 512, 1024), (6349, 72, 520), (77, 1024, 40),
                    (4109, 64, 264)]:
        a, b = (t.cuda() for t in _torch_in(m, k, n))
        y64, allowed = port_probe.float64_bound(a, b)
        plain = kernels.matmul_reference(a, b)
        for variant in VARIANTS:
            out = torch.full((m, n), float('nan'), dtype=torch.bfloat16,
                             device='cuda')
            kernels.reset_launch_counts()
            kernels.matmul(a, b, variant, out=out)
            torch.cuda.synchronize()
            assert kernels.launch_counts()['matmul_' + variant] == 1
            assert port_probe.bound_ratio(out, y64, allowed) <= 1
            assert port_probe.bound_ratio(out, plain.double(),
                                          2 * allowed) <= 1
