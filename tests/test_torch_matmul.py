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

The CUDA kernels (``csrc/matmul.cu``) run only on the card: the last test
is marked ``cuda`` and skips here.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax._src.pallas.mosaic import pipeline as _pipeline
from jax.experimental.pallas import tpu as pltpu

from mxnet_tpu_torch.ops import kernels
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
    """``csrc/matmul.cu`` on the card at odd shapes: each variant within
    the float64 bound and within twice it of the plain version, every row
    of a NaN-filled output written; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for sm_90a '
                    'and have no CPU mode')
    for m, k, n in [(1, 64, 256), (6349, 512, 2048), (300, 72, 64),
                    (129, 1024, 64), (257, 2048, 520), (1000, 256, 8)]:
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
