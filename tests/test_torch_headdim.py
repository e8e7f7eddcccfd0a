"""Port parity at every head dim: the float32 flash forward, decode and
paged decode of ``mxnet_tpu_torch.ops.kernels`` and a ``TransformerLM``
served at head dims other than 64, against the JAX package.

The port's kernels take every head dim D from 1 to 128 (instances at the
padded widths 16, 32, 64 and 128, columns past D zero in shared memory);
on the CPU its wrappers run their plain versions, and the JAX kernels run
through the Pallas interpreter, as the JAX package's own tests run them.
Inputs are numpy arrays from a seed, given to both. Tolerances: 1e-5
absolute for the kernel functions (the flash kernels' reduction tier);
greedy tokens equal for the models, whose weights cross by
``params_from_jax``. The geometry checks hold ``fwd_geometry`` within
a block's shared memory at every D (the card's first load holds it to
the kernel's layout at every width). The kernels against their plain
versions at each new D on the card: ``test_torch_headdim_card.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import config as jax_config
from mxnet_tpu.ops.pallas import attention as jax_attn
from mxnet_tpu.serving.decode.model import \
    init_transformer_lm as jax_init_lm
from mxnet_tpu.serving.decode.paged import pages_for
from mxnet_tpu.serving.decode.program import DecodeProgram as JaxProgram
from mxnet_tpu.serving.decode.program import PagedDecodeProgram as JaxPaged
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels import attention as port_attn
from mxnet_tpu_torch.serving import decode as port

torch.set_num_threads(1)
ATOL = 1e-5
DIMS = (1, 6, 8, 80, 128)


def _np(*arrays):
    return [torch.tensor(a) for a in arrays]


# -- the kernel functions against the JAX kernels --------------------------


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('d', DIMS)
def test_flash_attention_matches_jax_at_head_dim(d, causal):
    rs = np.random.RandomState(d + 131 * causal)
    seq = 37
    q, k, v = (rs.randn(2, 2, seq, d).astype('float32') for _ in range(3))
    # batch 1 sees no key at all: its rows come out 0
    lengths = np.array([seq - 5, 0], 'int32')
    want = np.asarray(jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=jnp.asarray(lengths), causal=causal))
    got, lse = kernels.flash_attention_with_lse(
        *_np(q, k, v), lengths=torch.tensor(lengths), causal=causal)
    assert got.shape == (2, 2, seq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert not got[1].any() and torch.isneginf(lse[1]).all()


@pytest.mark.parametrize('d', DIMS)
def test_flash_decode_matches_jax_at_head_dim(d):
    rs = np.random.RandomState(d)
    slots, heads, max_len = 3, 3, 300
    u = heads * d
    q = rs.randn(slots, u).astype('float32')
    keys = rs.randn(slots, max_len, u).astype('float32')
    values = rs.randn(slots, max_len, u).astype('float32')
    positions = np.array([0, 130, max_len - 1], 'int32')
    want = np.asarray(jax_attn.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(values),
        jnp.asarray(positions), heads))
    got = kernels.flash_decode_attention(*_np(q, keys, values, positions),
                                         heads)
    assert got.shape == (slots, u)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize('d', DIMS)
def test_flash_paged_decode_matches_jax_at_head_dim(d):
    rs = np.random.RandomState(50 + d)
    slots, heads, page_size, max_pages = 3, 2, 16, 9
    u = heads * d
    pages = slots * max_pages + 1
    kpool = rs.randn(pages, page_size, u).astype('float32')
    vpool = rs.randn(pages, page_size, u).astype('float32')
    tables = (1 + rs.permutation(pages - 1)[:slots * max_pages]).reshape(
        slots, max_pages).astype('int32')
    positions = np.array([3, 70, max_pages * page_size - 1], 'int32')
    q = rs.randn(slots, u).astype('float32')
    want = np.asarray(jax_attn.flash_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(tables), jnp.asarray(positions), heads))
    args = _np(q, kpool, vpool, tables, positions)
    got = kernels.flash_paged_decode_attention(*args, heads=heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # bitwise the slot decode over the gathered view
    view = [p[torch.tensor(tables).long()].reshape(slots, -1, u)
            for p in args[1:3]]
    slot = kernels.flash_decode_attention(args[0], *view, args[4], heads)
    assert torch.equal(got, slot)


# -- geometry ----------------------------------------------------------------


@pytest.mark.parametrize('d', range(1, kernels.HEAD_DIM_MAX + 1))
def test_fwd_geometry_fits_and_covers_at_every_head_dim(d):
    width = kernels.head_width(d)
    assert width in kernels.HEAD_WIDTHS and d <= width
    assert width == min(w for w in kernels.HEAD_WIDTHS if w >= d)
    buffers = 1 if width > 64 else 2
    for bq in kernels.fwd_block_qs(d):
        for sq in (1, 17, 200, 513):
            got_bq, blocks, smem = kernels.fwd_geometry(1, 3, sq, bq, d=d)
            tiles = -(-sq // bq)
            assert got_bq == bq
            assert tiles * bq >= sq > (tiles - 1) * bq
            assert 0 < blocks <= min(3 * tiles, port_attn.SMS)
        floats = (bq * width + 2 * buffers * 128 * width + 128 * bq
                  + 3 * bq)
        assert smem == 4 * floats <= port_attn.SMEM_BLOCK_MAX
    for sq in (1, 256, 4096):
        bq, blocks, _ = kernels.fwd_geometry(2, 16, sq, d=d)
        assert bq in kernels.fwd_block_qs(d)


def test_fwd_geometry_keeps_head_dim_64():
    # the default head dim is 64, the instances and bytes of before
    assert kernels.fwd_block_qs() == kernels.fwd_block_qs(64) == (128, 32)
    for bq in (128, 32):
        assert kernels.fwd_geometry(1, 1, 1, bq) == \
            kernels.fwd_geometry(1, 1, 1, bq, d=64)
    assert kernels.fwd_block_qs(128) == (64, 32)
    with pytest.raises(ValueError, match='not built'):
        kernels.fwd_geometry(1, 12, 256, 128, d=128)


@pytest.mark.parametrize('d', [0, 129, 256])
def test_head_dims_past_the_instances_are_refused_typed(d):
    for call in (lambda: kernels.head_width(d),
                 lambda: kernels.fwd_geometry(1, 1, 1, d=d),
                 lambda: kernels.fwd_block_qs(d)):
        with pytest.raises(kernels.HeadDimError, match='ROADMAP B1'):
            call()
    assert issubclass(kernels.HeadDimError, ValueError)


# -- TransformerLM at head dims 8 and 128 against the JAX package ----------


@pytest.fixture
def knob():
    """Restore the JAX package's pallas knob after the test."""
    yield
    jax_config.unset('MXNET_TPU_PALLAS')


LMS = {8: dict(vocab=61, units=32, hidden=64, layers=2, heads=4,
               max_len=48),
       128: dict(vocab=61, units=256, hidden=512, layers=2, heads=2,
                 max_len=48)}
PROMPTS = ([7, 2, 9], [1, 5, 3, 3, 8, 0, 11, 4, 6, 30, 12])


def _slot_greedy(prog, prompt, n, slot=1):
    cache = prog.new_cache()
    cache, tok, _ = prog.run_prefill(cache, prompt, slot)
    got, pos = [tok], len(prompt)
    while len(got) < n:
        tk = np.zeros(prog.slots, 'int32')
        ps = np.zeros(prog.slots, 'int32')
        tk[slot], ps[slot] = got[-1], pos
        cache, toks, _ = prog.run_step(cache, tk, ps)
        got.append(int(toks[slot]))
        pos += 1
    return got


def _paged_greedy(prog, prompt, n, slot=1):
    pool = prog.new_cache()
    table = np.zeros((prog.slots, prog.max_pages), 'int32')
    table[slot] = np.arange(1, prog.max_pages + 1)
    npages = pages_for(len(prompt), prog.page_size)
    pool, tok, _ = prog.run_prefill(pool, prompt, list(table[slot, :npages]))
    got, pos = [tok], len(prompt)
    while len(got) < n:
        tk = np.zeros(prog.slots, 'int32')
        ps = np.zeros(prog.slots, 'int32')
        tk[slot], ps[slot] = got[-1], pos
        pool, toks, _ = prog.run_step(pool, tk, ps, table)
        got.append(int(toks[slot]))
        pos += 1
    return got


@pytest.mark.parametrize('paged', [False, True])
@pytest.mark.parametrize('d', sorted(LMS))
def test_transformer_lm_greedy_tokens_equal_jax_at_head_dim(knob, d, paged):
    cfg = LMS[d]
    assert cfg['units'] // cfg['heads'] == d
    jmodel, np_params = jax_init_lm(**cfg)
    pmodel, _ = port.init_transformer_lm(**cfg)
    pparams = port.params_from_jax(np_params, 'cpu')
    jax_config.set('MXNET_TPU_PALLAS', 'attention')
    kw = dict(slots=2, prefill_buckets=(4, 16))
    if paged:
        jprog = JaxPaged(jmodel, np_params, page_size=8, **kw)
        pprog = port.freeze_decode(pmodel, pparams, page_size=8,
                                   device='cpu', **kw)
        run = _paged_greedy
    else:
        jprog = JaxProgram(jmodel, np_params, **kw)
        pprog = port.freeze_decode(pmodel, pparams, paged=False,
                                   device='cpu', **kw)
        run = _slot_greedy
    assert isinstance(pprog, port.PagedDecodeProgram) == paged
    for prompt in PROMPTS:
        assert run(pprog, prompt, 10) == run(jprog, prompt, 10), prompt

