"""Port parity: the fused softmax-xent head of the port (the forward and
backward kernels behind ``SoftmaxXentFunction``) against
``fused_softmax_xent_rows`` of the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions and the
JAX kernels run through the Pallas interpreter, with
``MXNET_TPU_PALLAS=attention,xent`` set as the JAX package's own tests set
it. Logits, labels and cotangents come from a numpy seed and go to both.
Tolerance: 1e-6 absolute. Both sides compute the same float32
expressions per row (max, exp-sum, log, subtract); only the order of the
exp-sum differs, which moves ``logp`` by a few ulps of ``log z``.

The kernels themselves (CUDA, sm_90a) run only on the card: the test
marked ``cuda`` in ``test_torch_attention_bwd.py`` compares them with
their plain versions there.
"""
import importlib
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import config, nd
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.ops.pallas import xent as jax_xent
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops import nn as port_nn

torch.set_num_threads(1)
TOL = 1e-6


@pytest.fixture(scope='module', autouse=True)
def kernels_on():
    config.set('MXNET_TPU_PALLAS', 'attention,xent')
    yield
    config.unset('MXNET_TPU_PALLAS')


def _case(seed, rows, v):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(rows, v) * 3).astype('float32')
    labels = rs.randint(0, v, rows).astype('int32')
    labels[rows // 2] = v          # out of range: matches no class
    g = rs.randn(rows).astype('float32')
    return logits, labels, g


def _jax_nll_and_vjp(logits, labels, g):
    nll, vjp = jax.vjp(
        lambda x: jax_xent.fused_softmax_xent_rows(x, jnp.asarray(labels)),
        jnp.asarray(logits))
    return np.asarray(nll), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize('rows,v', [(13, 2), (5, 100), (19, 257)])
@pytest.mark.parametrize('g_kind', ['row', 'scalar'])
def test_fused_xent_matches_jax(rows, v, g_kind):
    logits, labels, g = _case(rows * v, rows, v)
    if g_kind == 'scalar':
        g = np.full((rows,), 0.37, 'float32')
    want_nll, want_dx = _jax_nll_and_vjp(logits, labels, g)

    x = torch.tensor(logits, requires_grad=True)
    nll = kernels.fused_softmax_xent_rows(x, torch.tensor(labels))
    np.testing.assert_allclose(nll.detach().numpy(), want_nll, rtol=0,
                               atol=TOL)
    assert nll[rows // 2].item() == 0.0   # the out-of-range label
    gt = torch.tensor(g)
    if g_kind == 'scalar':
        # a scalar cotangent reaches the backward as one number
        (dx,) = torch.autograd.grad(nll.sum() * 0.37, x)
        _, logp = kernels.softmax_xent_forward(x.detach(),
                                               torch.tensor(labels))
        direct = kernels.softmax_xent_backward(logp, torch.tensor(labels),
                                               0.37)
        np.testing.assert_allclose(direct.numpy(), want_dx, rtol=0, atol=TOL)
    else:
        (dx,) = torch.autograd.grad(nll, x, gt)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=0, atol=TOL)
    # the out-of-range row's gradient is g times the softmax alone (no
    # -1 term)
    r = rows // 2
    soft = torch.softmax(torch.tensor(logits[r]), dim=0) * float(g[r])
    np.testing.assert_allclose(dx[r].numpy(), soft.numpy(), rtol=0,
                               atol=TOL)


def test_float_labels_truncate_as_astype_int32():
    logits, labels, _ = _case(3, 6, 10)
    flabels = labels.astype('float32') + 0.75
    want, _ = _jax_nll_and_vjp(logits, flabels, np.ones(6, 'float32'))
    got = kernels.fused_softmax_xent_rows(torch.tensor(logits),
                                          torch.tensor(flabels))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_plain_backward_matches_autograd_of_reference():
    """In-range labels only: for a label outside [0, V) the closed form
    (the TPU kernel's and the port's) still gives g * softmax, while
    autograd of the constant 0 nll gives 0."""
    logits, labels, g = _case(7, 11, 37)
    labels[11 // 2] = 3
    x = torch.tensor(logits, requires_grad=True)
    lab = torch.tensor(labels)
    nll = kernels.fused_softmax_xent_rows_reference(x, lab)
    (auto,) = torch.autograd.grad(nll, x, torch.tensor(g))
    _, logp = kernels.softmax_xent_forward_reference(x.detach(), lab)
    plain = kernels.softmax_xent_backward_reference(logp, lab,
                                                    torch.tensor(g))
    np.testing.assert_allclose(plain.numpy(), auto.numpy(), rtol=0,
                               atol=TOL)


def test_loss_block_takes_the_fused_head_and_counts_nothing_on_cpu():
    """SoftmaxCrossEntropyLoss (sparse labels, from logits) reduces the
    fused head's (rows, 1) nll to (rows,) as the JAX loss does."""
    kernels.reset_launch_counts()
    logits, labels, _ = _case(5, 4, 3)
    pred = torch.tensor(logits.reshape(2, 2, 3))
    got = port_loss.SoftmaxCrossEntropyLoss()(pred, torch.tensor(
        labels.reshape(2, 2)))
    want, _ = _jax_nll_and_vjp(logits, labels, np.ones(4, 'float32'))
    np.testing.assert_allclose(got.numpy(), want.reshape(2, 2).mean(1),
                               rtol=0, atol=TOL)
    head = port_nn.fused_softmax_xent(pred, torch.tensor(labels))
    assert head.shape == (2, 2, 1)
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize('kw,pred_shape', [
    (dict(), (6, 9)),
    (dict(from_logits=True, weight=2.0), (6, 9)),
    (dict(sparse_label=False), (6, 9)),
    (dict(axis=1), (4, 5, 3)),
])
def test_softmax_ce_loss_matches_jax(kw, pred_shape):
    """Every branch of the loss block: the fused head, from-logits,
    dense labels and another class axis, with a sample weight."""
    rs = np.random.RandomState(len(kw))
    pred = rs.randn(*pred_shape).astype('float32')
    if kw.get('from_logits'):
        pred = np.log(np.exp(pred) / np.exp(pred).sum(-1, keepdims=True))
    axis = kw.get('axis', -1)
    classes = pred_shape[axis]
    if kw.get('sparse_label', True):
        lead = tuple(np.delete(pred_shape, axis % len(pred_shape)))
        label = rs.randint(0, classes, lead).astype('float32')
    else:
        label = rs.rand(*pred_shape).astype('float32')
        label /= label.sum(-1, keepdims=True)
    sw = rs.rand(pred_shape[0], 1).astype('float32')
    want = jax_loss.SoftmaxCrossEntropyLoss(**kw)(
        nd.array(pred), nd.array(label), nd.array(sw)).asnumpy()
    got = port_loss.SoftmaxCrossEntropyLoss(**kw)(
        torch.tensor(pred), torch.tensor(label), torch.tensor(sw))
    assert tuple(got.shape) == want.shape == (pred_shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_wrappers_take_bf16_and_refuse_fp16():
    """The forward takes bf16 logits and writes float32 nll and logp; the
    backward writes float32 or bf16 dlogits from float32 logp; fp16
    logits or dlogits raise ``TypeError``."""
    bf = torch.bfloat16
    logits = torch.randn(4, 7).to(bf)
    lab = torch.tensor([0, 6, -1, 3])
    nll, logp = kernels.softmax_xent_forward(logits, lab)
    assert nll.dtype == logp.dtype == torch.float32
    assert kernels.softmax_xent_backward(logp, lab, 1.0, bf).dtype == bf
    with pytest.raises(TypeError):
        kernels.softmax_xent_forward(logits.half(), lab)
    with pytest.raises(TypeError):
        kernels.softmax_xent_backward(logp, lab, 1.0, torch.float16)


def test_wrappers_reject_other_devices_and_bad_shapes():
    x = torch.zeros(4, 3, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.softmax_xent_forward(x, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.softmax_xent_backward(x, torch.zeros(4, dtype=torch.int32),
                                      1.0)
    with pytest.raises(ValueError, match='expected \\(rows, V\\)'):
        kernels.softmax_xent_forward(torch.zeros(3), torch.zeros(3))


# ---------------------------------------------------------------------------
# the forward kernel's instances and its cluster arithmetic, as the CUDA
# source writes them (csrc/softmax_xent.cu), run in Python
# ---------------------------------------------------------------------------

_xent = importlib.import_module('mxnet_tpu_torch.ops.kernels.xent')
_SRC = os.path.join(os.path.dirname(_xent.__file__), 'csrc',
                    'softmax_xent.cu')
GEOMETRY_V = [1, 2, 1000, 1024, 1025, 16384, 16385, 30522, 30523, 50000,
              200003, 464608, 464609, 600000]


def _source():
    return open(_SRC).read()


def _const(src, name):
    return int(re.search(r'constexpr int %s = (\d+);' % name, src).group(1))


def test_instance_table_mirrors_the_source():
    """``XENT_INSTANCES`` and the limits are the C enum, constants and
    ``INSTANCES`` table; the shared-memory formula is the C one, for
    float32 and for bf16 logits."""
    src = _source()
    assert ('enum Instance { WARP_ROW = 0, CLUSTER_ROW = 1, TWO_PASS = 2 };'
            in src)
    assert _xent.XENT_INSTANCES == ('warp', 'cluster', 'two_pass')
    for name, want in (('THREADS', _xent.XENT_THREADS),
                       ('WARP_V', _xent.XENT_WARP_V),
                       ('CLUSTER_MAX', _xent.XENT_CLUSTER_MAX),
                       ('HEADER', _xent.XENT_HEADER),
                       ('SMEM_MAX', _xent.SMEM_BLOCK_MAX),
                       ('CHUNK_TARGET', _xent.XENT_CHUNK_TARGET)):
        assert _const(src, name) == want, name
    assert ('constexpr int MAX_CHUNK = ((SMEM_MAX - HEADER) / 4 - 4) & ~3;'
            in src)
    assert _xent.XENT_CHUNK_MAX == 58076
    table = re.search(r'INSTANCES\[\] = \{(.*?)\};', src, re.S).group(1)
    rows = re.findall(r'\{(\w+), (\w+), (\w+), (\w+)\}', table)
    names = {'WARP_ROW': 'warp', 'CLUSTER_ROW': 'cluster',
             'TWO_PASS': 'two_pass'}
    values = {'THREADS': _xent.XENT_THREADS, 'CLUSTER_MAX': 8,
              'WARP_V': _xent.XENT_WARP_V, 'MAX_CHUNK': _xent.XENT_CHUNK_MAX}
    got = [(names[i], values.get(t, t), int(values.get(c, c)),
            int(values.get(k, k))) for i, t, c, k in rows]
    assert got == [('warp', 256, 1, 1024), ('cluster', 256, 8, 58076),
                   ('two_pass', 256, 1, 0)]
    assert ('return HEADER + (itemsize == 2 ? 2 * (chunk + 8) : 4 * (chunk '
            '+ 4));' in src)
    for chunk in (4, 16384, 58076):
        assert _xent.xent_cluster_smem(chunk) == 128 + 4 * (chunk + 4)
        assert _xent.xent_cluster_smem(chunk, 2) == 128 + 2 * (chunk + 8)
    with pytest.raises(ValueError):
        _xent.xent_cluster_smem(16384, 8)


def test_card_cases_reach_every_instance_and_cluster_size():
    """chip_smoke's xent cases launch every instance of the forward, the
    cluster at 2, 4 and 8 CTAs a row (8 with a chunk above the 16384-float
    target), and rows starting at every offset mod 16 bytes."""
    from chip_smoke import XENT_SHAPES
    geoms = [kernels.xent_geometry(rows, v) for rows, v in XENT_SHAPES]
    assert {g.instance for g in geoms} == set(kernels.XENT_INSTANCES)
    clusters = {g.cluster for g in geoms if g.instance == 'cluster'}
    assert clusters == {2, 4, 8}
    assert any(g.cluster == 8 and g.chunk > _xent.XENT_CHUNK_TARGET
               for g in geoms if g.instance == 'cluster')
    assert {r * v * 4 % 16 for rows, v in XENT_SHAPES
            for r in range(rows)} == {0, 4, 8, 12}


_KERNEL_NAME = re.compile(
    r'__global__ void __launch_bounds__\([\w:]+\)\s+(\w+)\(')


def test_forward_kernels_carry_the_profile_key():
    """Every kernel of the source, the backward's too, holds
    'softmax_xent' in its name, the key by which chip_smoke's profiles
    count the 'xent kernels' group."""
    from chip_smoke import BERT_GROUPS, RESNET_GROUPS
    names = _KERNEL_NAME.findall(_source())
    assert len(names) == 4
    for groups in (BERT_GROUPS, RESNET_GROUPS):
        keys = dict((g, k) for g, k, _ in groups)['xent kernels']
        assert all(any(key in name for key in keys) for name in names)


def _ceil(a, b):
    return -(-a // b)


def _chunk_of(row_start, v, chunk, rank):
    """``chunk_of`` of the source: (c0, len, h0, lo, body, nq)."""
    c0 = rank * chunk
    n = max(0, min(v, c0 + chunk) - c0)
    h0 = (row_start + c0) & 3
    head = min(n, (4 - h0) & 3)
    return c0, n, h0, h0 + head, (n - head) & ~3, (h0 + n + 3) >> 2


@pytest.mark.parametrize('v', GEOMETRY_V)
@pytest.mark.parametrize('rows', [1, 7, 1920])
def test_xent_geometry(rows, v):
    """A warp a row up to 1024 columns; above, the fewest CTAs a cluster
    whose chunk is at most 16384 floats, or 8 while a chunk fits a block;
    past that a block a row. A cluster's chunks tile the row exactly,
    every CTA holding a column; its shared memory stays within a block's
    232,448 bytes; at most 8 CTAs a cluster."""
    g = kernels.xent_geometry(rows, v)
    assert g.instance in kernels.XENT_INSTANCES and g.threads == 256
    if v <= 1024:
        assert g == ('warp', 1, v, 0, 256, -(-rows // 8))
        return
    if v > 8 * _xent.XENT_CHUNK_MAX:
        assert g == ('two_pass', 1, v, 0, 256, rows)
        return
    assert g.instance == 'cluster' and 1 <= g.cluster <= 8
    assert g.grid == rows * g.cluster
    assert g.chunk % 4 == 0 and g.smem == 128 + 4 * (g.chunk + 4)
    assert g.smem <= 232448
    smaller = [c for c in (1, 2, 4, 8) if c < g.cluster]
    assert g.chunk <= 16384 or g.cluster == 8
    assert all(_ceil(_ceil(v, c), 4) * 4 > 16384 for c in smaller)
    spans = [_chunk_of(0, v, g.chunk, k)[:2] for k in range(g.cluster)]
    assert all(n >= 1 for _, n in spans)
    assert sum(n for _, n in spans) == v
    assert [c0 for c0, _ in spans] == [sum(n for _, n in spans[:k])
                                       for k in range(g.cluster)]


@pytest.mark.parametrize('v,cluster', [(30522, 4), (30523, 4), (30522, 2),
                                       (30523, 8), (1025, 1), (8193, 2),
                                       (464608, 8), (1027, 8), (50000, 4),
                                       (200003, 8)])
def test_cluster_chunks_cover_each_row_once_aligned(v, cluster):
    """Every row's chunks as the CTAs load and store them, for rows
    starting at each offset mod 16 bytes: the bulk copy reads 16-byte
    aligned whole 16-byte units inside the chunk into 16-byte aligned
    buffer positions; threads 0-3 and 4-11 fill the rest of the used
    float4 slots; together they cover every slot position once, each
    column of the chunk exactly once and nothing outside the row; the
    16-byte logp stores land on aligned addresses inside the chunk; the
    buffer fits the chunk + 4 floats allocated."""
    g = _xent._cluster_geometry(3, v, cluster)
    for r in range(4):
        row_start = r * v
        cols = []
        for rank in range(cluster):
            c0, n, h0, lo, body, nq = _chunk_of(row_start, v, g.chunk, rank)
            assert 4 * nq <= g.chunk + 4
            assert lo % 4 == 0 and lo <= 4 and body % 4 == 0
            if body:
                src = row_start + c0 - h0 + lo      # element index into x
                assert src % 4 == 0                 # 16-byte aligned
                assert c0 <= c0 + lo - h0 and c0 + lo - h0 + body <= c0 + n
            filled = list(range(lo, lo + body))
            for t in range(12):
                p = t if t < 4 else lo + body + (t - 4)
                if p < lo if t < 4 else p < 4 * nq:
                    filled.append(p)
            assert sorted(filled) == list(range(4 * nq))
            cols += [c0 + p - h0 for p in range(4 * nq)
                     if h0 <= p < h0 + n]
            for i in range(nq):
                p = 4 * i
                if h0 <= p and p + 3 < h0 + n:
                    assert (row_start + c0 - h0 + p) % 4 == 0
        assert cols == list(range(v))


def _staged_of(row_start, v, chunk, rank):
    """``staged_of`` of the source for bf16 logits: (h8, lo, body, off4)
    beside the chunk's (c0, len, h0, nq)."""
    c0, n, h0, _, _, nq = _chunk_of(row_start, v, chunk, rank)
    h8 = (row_start + c0) & 7
    head = min(n, (8 - h8) & 7)
    return (c0, n, h0, nq), (h8, h8 + head, (n - head) & ~7, (h8 - h0) >> 2)


@pytest.mark.parametrize('v', GEOMETRY_V)
@pytest.mark.parametrize('rows', [1, 1920])
def test_bf16_xent_geometry(rows, v):
    """bf16 logits take the float32 instance's instance, cluster size and
    chunks (so its bits, and the size that measured fastest for both at V
    30522); only a cluster CTA's shared memory differs: the header and a
    bf16 staging region of chunk + 8 in the float buffer's place, within
    a block's 232,448 bytes."""
    g = kernels.xent_geometry(rows, v, 2)
    f = kernels.xent_geometry(rows, v)
    assert g._replace(smem=f.smem) == f
    if g.instance == 'cluster':
        assert g.smem == 128 + 2 * (g.chunk + 8) <= 232448
        assert g.smem < f.smem
    else:
        assert g.smem == f.smem == 0


@pytest.mark.parametrize('v,cluster', [(30522, 2), (30522, 4), (30523, 2),
                                       (30523, 8), (1025, 1), (8193, 2),
                                       (1027, 8), (50000, 4), (200003, 8),
                                       (464608, 8), (13, 1)])
def test_bf16_staging_covers_each_chunk_once_aligned(v, cluster):
    """bf16 logits, for rows starting at each offset mod 16 bytes: the bulk
    copy reads whole 16-byte units of x inside the chunk into 16-byte
    aligned staging positions; threads 0-7 and 8-15 take the rest of the
    chunk; together each column of the chunk lands once, at staging index
    c - c0 + h8, and nothing outside the row is read. Buffer slot i of the
    float32 instance (positions 4i .. 4i + 3) reads staging indices 4 (i +
    off4) .. + 3, which hold exactly the columns the float32 buffer holds
    there, and stay inside the chunk + 8 bf16 allocated."""
    chunk = _xent._chunk(v, cluster)
    for r in range(8):
        row_start = r * v
        cols = []
        for rank in range(cluster):
            (c0, n, h0, nq), (h8, lo, body, off4) = _staged_of(
                row_start, v, chunk, rank)
            if n == 0:
                continue
            assert off4 in (0, 1) and lo % 8 == 0 and body % 8 == 0
            assert h8 <= lo <= h8 + n and lo + body <= h8 + n
            if body:
                assert (row_start + c0 - h8 + lo) % 8 == 0   # 16 bytes in x
            landed = list(range(lo, lo + body))
            for t in range(16):
                p = h8 + t if t < 8 else lo + body + (t - 8)
                if p < lo if t < 8 else p < h8 + n:
                    landed.append(p)
            assert sorted(landed) == list(range(h8, h8 + n))
            for i in range(nq):
                for e in range(4):
                    p = 4 * i + e
                    idx = 4 * (i + off4) + e
                    assert idx < chunk + 8
                    if h0 <= p < h0 + n:
                        assert idx - h8 == p - h0       # the same column
                        cols.append(c0 + idx - h8)
        assert cols == list(range(v))


def _f32(x):
    return np.float32(x)


def _merge(m, z, m2, z2):
    """``merge`` of the source, in float32."""
    mn = max(m, m2)
    if mn == -np.inf:
        return m, z
    return mn, _f32(z * np.exp(_f32(m - mn)) + z2 * np.exp(_f32(m2 - mn)))


@pytest.mark.parametrize('cluster', [2, 4, 8])
def test_rank_ordered_merge_gives_every_rank_the_same_log_z(cluster):
    """Each CTA of a row merges the cluster's (max, exp-sum) partials in
    rank order, so every rank's log z is bitwise the same and within 1e-6
    of the float64 log-sum-exp; from 3 CTAs on, a merge that started from
    the CTA's own partial would not be the same on every rank (two
    partials commute)."""
    rs = np.random.RandomState(11)
    differs = 0
    for row in range(100):
        x = (rs.randn(30522) * 3).astype('float32')
        g = _xent._cluster_geometry(1, x.size, cluster)
        parts = []
        for rank in range(g.cluster):
            seg = x[rank * g.chunk:(rank + 1) * g.chunk]
            m = seg.max()
            parts.append((m, np.exp(seg - m, dtype=np.float32).sum(
                dtype=np.float32)))
        logz = []
        for rank in range(g.cluster):
            gm, gz = _f32(-np.inf), _f32(0)
            for m, z in parts:                       # rank order
                gm, gz = _merge(gm, gz, m, z)
            logz.append((gm, np.log(gz)))
            om, oz = _f32(-np.inf), _f32(0)           # own partial first
            for m, z in parts[rank:] + parts[:rank]:
                om, oz = _merge(om, oz, m, z)
            differs += (om, np.log(oz)) != logz[-1]
        assert len(set(logz)) == 1
        gm, lz = logz[0]
        x64 = x.astype(np.float64)
        want = np.log(np.exp(x64 - x64.max()).sum())
        # a tenth of the card check's 1e-5 on logp = (x - m) - log z
        assert gm == x.max() and abs(lz - want) <= 1e-6
    assert (differs > 0) == (cluster > 2)


# ---------------------------------------------------------------------------
# the backward kernel: a 16-byte stream over the flat rows x V elements
# (csrc/stream.cuh), a vector's row and column from one division by V, in
# chunks of whole rows past 2**31 - 1 elements (xent_bwd_geometry)
# ---------------------------------------------------------------------------

_epi = importlib.import_module('mxnet_tpu_torch.ops.kernels.epilogue')
_HEADER = os.path.join(os.path.dirname(_SRC), 'stream.cuh')
MAX = _epi.MAX_ELEMENTS


def _kernel_div(i, div):
    """``Divisor::div`` of csrc/stream.cuh: the high 32 bits of
    ``i * mul``, shifted; ``mul`` 0 (d = 1) gives ``i``."""
    return (i * div.mul >> 32) >> div.shift if div.mul else i


def _bwd_at(i, div, lead):
    """``XentBwd::at``: (row, column) of chunk element i, the row counted
    from the one that labels and g point at."""
    if i < lead:
        return 0, div.d - lead + i
    t = i - lead
    q = _kernel_div(t, div)
    return q + (lead != 0), t - q * div.d


def _bwd_step(row, col, v):
    """``XentBwd::step``: the next element's (row, column)."""
    col += 1
    return (row + 1, 0) if col == v else (row, col)


def _bwd_walk(n, div, lead):
    """(element, row, column) of every element of an n-element chunk as
    the stream visits it (``stream`` in csrc/stream.cuh): a vector's
    first element by ``at``, the three after it by ``step``; the scalars
    of the tail by ``at``."""
    geom = _epi.epilogue_geometry(n)
    whole = n - n % 4
    for b in range(geom.grid):
        for t in range(_epi.EPI_THREADS):
            i = b * _epi.EPI_TILE + t * 4
            if b < geom.tiles or i < whole:
                row, col = _bwd_at(i, div, lead)
                for e in range(4):
                    yield i + e, row, col
                    row, col = _bwd_step(row, col, div.d)
            if b >= geom.tiles and whole + t < n:
                yield (whole + t,) + _bwd_at(whole + t, div, lead)


@pytest.mark.parametrize('v', [1, 2, 3, 4, 5, 6, 7, 8, 9, 1000, 30522])
def test_bwd_stepping_matches_divmod(v):
    """Every element's (row, column) as a vector of the backward stream
    steps to it equals ``divmod`` of its flat index, over whole tiles, the
    rest and a tail, for V below 4 (a vector crossing rows, more than once
    at V 1-3) and above; and in a chunk that starts at any row r from the
    16-byte boundary at or below it, its ``lead`` elements ending row
    r - 1 (V >= 4, where lead < V)."""
    rows = max(3, -(-3 * _epi.EPI_TILE // v) + 5)
    n = rows * v
    chunks, div = kernels.xent_bwd_geometry(rows, v)
    assert len(chunks) == 1 and chunks[0][:4] == (0, 0, n, 0)
    assert sorted(_bwd_walk(n, div, 0)) == [(i,) + divmod(i, v)
                                            for i in range(n)]
    if v < 4:
        return
    for first in (1, 2, 3, rows // 2, rows - 1):
        start = first * v & ~3
        lead = first * v - start
        base = first - (lead != 0)
        walked = [(start + i, base + r, c)
                  for i, r, c in _bwd_walk(n - start, div, lead)]
        assert sorted(walked) == [(i,) + divmod(i, v)
                                  for i in range(start, n)]


def _assert_chunks(rows, v, itemsize=4):
    """``xent_bwd_geometry``'s chunks for a dx of ``itemsize`` bytes an
    element: a vector of ``vec = 16 // itemsize`` elements (4 floats, 8
    bf16) sets the alignment and the most a lead may be."""
    vec = 16 // itemsize
    chunks, div = kernels.xent_bwd_geometry(rows, v, itemsize)
    n = rows * v
    assert div == _epi.fast_divisor(v)
    assert chunks[0].start == 0 and chunks[0].lead == 0
    firsts = []
    end = 0
    for c in chunks:
        assert c.start == end and c.start % vec == 0   # 16-byte aligned
        assert 1 <= c.n <= MAX and 0 <= c.lead < min(vec, v)
        first = c.row + (c.lead != 0)                  # first whole row
        assert c.start + c.lead == first * v
        assert c.geom == _epi.epilogue_geometry(c.n, itemsize)
        firsts.append(first)
        end = c.start + c.n
    assert end == n
    # each chunk ends at the 16-byte boundary at or below the next one's
    # first row: the rows are covered once, in order
    assert firsts == sorted(set(firsts)) and firsts[0] == 0
    for k, c in enumerate(chunks[:-1]):
        assert c.start + c.n == firsts[k + 1] * v & ~(vec - 1)
    if len(firsts) > 1 and firsts[1] >= vec:
        assert all(f % firsts[1] == 0 for f in firsts)
        assert firsts[1] % vec == 0 and all(c.lead == 0 for c in chunks)
    return chunks


@pytest.mark.parametrize('rows,v', [
    (2 ** 31 - 1, 1), (2 ** 31, 1), (2 ** 31 + 5, 1), (2 ** 30, 2),
    (2 ** 30 + 1, 2), (715827883, 3), (715827882, 3), (70359, 30522),
    (70356, 30522), (70360, 30523), (1920 * 40, 30522), (3, 2 ** 30 + 1),
    (5, 2 ** 29 + 3), (2, 2 ** 31 - 4), (7, 2 ** 30 - 2), (1, 2 ** 31 - 1),
    (9, 715827883)])
@pytest.mark.parametrize('itemsize', (4, 2))
def test_bwd_chunks_cover_every_row_once(rows, v, itemsize):
    """``xent_bwd_geometry`` around 2**31 elements, for a float32 dx and
    a bf16 one: one launch up to 2**31 - 1 of them; past that chunks of
    whole rows, a multiple of 4 (bf16: 8) rows each where that fits (no
    lead), each chunk 16-byte aligned in logp and dx, under 2**31
    elements, starting where the one before ends, every row in exactly
    one chunk's whole rows. A row wider than a launch less a vector's
    tail is refused past one launch (bf16: 2**31 - 4 elements).
    Arithmetic only: no tensor."""
    vec = 16 // itemsize
    if rows * v > MAX and v > MAX - (vec - 1):
        with pytest.raises(ValueError, match='wider than'):
            kernels.xent_bwd_geometry(rows, v, itemsize)
        return
    chunks = _assert_chunks(rows, v, itemsize)
    assert (len(chunks) == 1) == (rows * v <= MAX)


def test_bwd_geometry_refuses_rows_no_launch_holds():
    """A row wider than 2**31 - 4 elements in a tensor past one launch
    cannot be chunked: a typed error. Alone it is one launch; empty
    tensors launch nothing."""
    with pytest.raises(ValueError, match='wider than'):
        kernels.xent_bwd_geometry(2, MAX - 2)
    assert len(kernels.xent_bwd_geometry(1, MAX)[0]) == 1
    assert kernels.xent_bwd_geometry(0, 30522) == ((), None)
    assert kernels.xent_bwd_geometry(5, 0) == ((), None)


def test_bwd_stream_is_the_epilogue_stream():
    """The backward streams with the epilogue kernels' code: both sources
    include csrc/stream.cuh, whose threads, vector and tile are
    epilogue.py's, and neither holds a copy of it; the backward is one
    kernel, the stream over ``XentBwd``."""
    hdr = open(_HEADER).read()
    assert _const(hdr, 'THREADS') == _epi.EPI_THREADS
    assert _const(hdr, 'VEC') == _epi.EPI_VEC == 4
    assert 'constexpr int TILE = THREADS * VEC;' in hdr
    assert _epi.EPI_TILE == _epi.EPI_THREADS * _epi.EPI_VEC
    epi = open(os.path.join(os.path.dirname(_SRC), 'epilogue.cu')).read()
    for src in (_source(), epi):
        assert '#include "stream.cuh"' in src
        for piece in ('ld.global.nc.L1::no_allocate.v4.f32',
                      'struct Divisor', 'void stream(', 'using Idx =',
                      'unsigned stream_grid('):
            assert piece in hdr and piece not in src, piece
    assert 'mx_stream::stream<vec_of<T>()>(\n      XentBwd<EVICT, T>{' \
        in _source()


def test_bwd_kernel_carries_the_profile_key():
    """The backward kernel, one template over the store kind and dx's
    type (float32, bf16), is named with 'softmax_xent', so phase 4b's and
    5b's 'xent kernels' groups count it."""
    names = [n for n in _KERNEL_NAME.findall(_source()) if 'bwd' in n]
    assert names == ['softmax_xent_bwd_kernel']
    assert 'template <bool EVICT, class T>\n__global__ void ' \
        '__launch_bounds__(mx_stream::THREADS)\nsoftmax_xent_bwd_kernel(' \
        in _source()


def test_card_bwd_cases_reach_every_path_of_the_stream():
    """chip_smoke's backward cases, by their labels' pattern alone: n % 4
    takes each of 0-3, n lies below one tile and on whole tiles, one-hot
    elements fall on a vector's first and last lane and on a vector that
    crosses rows, at V 1, 2, 3, 5, 1000, 30522 and 30523, with labels -1
    and V."""
    from chip_smoke import (XENT_BWD_CASES, XENT_BWD_LABELS,
                            xent_bwd_paths)
    labels = [[XENT_BWD_LABELS[r % 4](v) if r < 8 else -1
               for r in range(rows)] for rows, v in XENT_BWD_CASES]
    paths = xent_bwd_paths(XENT_BWD_CASES, labels)
    assert {0, 3} <= paths.pop('onehot_lanes')
    assert paths == dict(n_mod_4={0, 1, 2, 3}, below_tile=True,
                         whole_tiles=True, onehot_crossing=True)
    assert {v for _, v in XENT_BWD_CASES} == {1, 2, 3, 5, 1000, 30522,
                                             30523}
    assert all(rows >= 4 for rows, v in XENT_BWD_CASES if v % 2)
