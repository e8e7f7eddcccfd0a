"""Port parity of the paged decode cache: ``mxnet_tpu_torch``'s page pool,
allocator, prefix trie, paged decode kernel (its plain version on the
CPU), paged model paths, ``PagedDecodeProgram`` and the engine's paged
scheduling (prefix sharing, copy-on-write, typed pool exhaustion, LRU
eviction, speculative decoding) against the JAX package's.

The model is ``test_torch_decode.py``'s kind (vocab 19, units 16, 2
layers, 4 heads), max_len 32-64. Inputs come from numpy seeds and go to
both packages; the JAX Pallas kernels run through the interpreter, as the
JAX package's own tests run them. Tolerances: the host math and the pool
ops exact; the paged decode attention 1e-5 absolute (the flash kernels'
reduction tier); logits atol 1e-4 / rtol 1e-5 (float32 matmuls and layer
norms summed in another order by each framework); greedy tokens equal.
Within the port, paged token streams are bitwise the slot cache's and
the uncached forward's (the reference's own bar,
``tests/test_paged_decode.py``).
"""
import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import config as jax_config
from mxnet_tpu.ops.pallas import attention as jax_attn
from mxnet_tpu.serving.decode import engine as jax_engine
from mxnet_tpu.serving.decode import paged as jax_paged
from mxnet_tpu.serving.decode.model import \
    init_transformer_lm as jax_init_lm
from mxnet_tpu.serving.decode.program import \
    PagedDecodeProgram as JaxPagedProgram
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.serving import (BackpressureError, InferenceSession,
                                     freeze_decode)
from mxnet_tpu_torch.serving.decode import (DecodeEngine, DecodeProgram,
                                            PagedDecodeProgram,
                                            init_transformer_lm)
from mxnet_tpu_torch.serving.decode import paged as port_paged
from mxnet_tpu_torch.serving.decode.paged import (TRASH_PAGE, PageAllocator,
                                                  PagedCacheSpec, PrefixCache,
                                                  pages_for, pool_bytes)

torch.set_num_threads(1)

CFG = dict(vocab=19, units=16, hidden=24, layers=2, heads=4)
ATOL = 1e-5


def _model(max_len=48, layers=2, seed=0):
    return init_transformer_lm(**dict(CFG, layers=layers, max_len=max_len,
                                      seed=seed))


def _paged(model, params, **kw):
    return PagedDecodeProgram(model, params, device='cpu', **kw)


def _slot(model, params, **kw):
    return DecodeProgram(model, params, device='cpu', **kw)


def _greedy_reference(model, params, prompt, n):
    """n greedy tokens of the uncached forward, rerun after every
    token."""
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    toks, out = list(prompt), []
    with torch.inference_mode():
        for _ in range(n):
            logits = model.full_forward(p, torch.tensor([toks]))
            out.append(int(logits[0, -1].argmax()))
            toks.append(out[-1])
    return out


def _run_engine(prog, requests, **engine_kw):
    """All requests through one engine; results in submission order."""
    engine_kw.setdefault('timeout_s', 60.0)
    engine_kw.setdefault('max_queue', len(requests) + 4)
    eng = DecodeEngine(prog, **engine_kw)
    try:
        streams = [eng.generate(p, max_new_tokens=n) for p, n in requests]
        outs = [s.result(60) for s in streams]
        stats = eng.stats()
    finally:
        eng.close()
    return outs, stats


# -- host-side pool math against the JAX package ------------------------------


def test_paged_spec_round_trip_and_pool_bytes_equal_jax():
    entries = {'k': ((16,), 'float32'), 'v': ((16,), 'float32')}
    spec = PagedCacheSpec(entries, 8, 60)
    jspec = jax_paged.PagedCacheSpec(entries, 8, 60)
    assert spec.max_pages == jspec.max_pages == 8
    assert spec.to_json() == jspec.to_json()
    again = PagedCacheSpec.from_json(json.loads(json.dumps(spec.to_json())))
    assert again.entries == spec.entries
    assert (again.page_size, again.max_pages) == (8, 8)
    for pages in (2, 5, 257):
        assert pool_bytes(spec, pages) == jax_paged.pool_bytes(jspec, pages)
    assert pool_bytes(spec, 5) == 5 * 8 * 16 * 4 * 2
    assert [pages_for(n, 16) for n in (0, 1, 16, 17)] == [
        jax_paged.pages_for(n, 16) for n in (0, 1, 16, 17)] == [0, 1, 1, 2]
    with pytest.raises(ValueError):
        PagedCacheSpec({'k': ((4,), 'float32')}, 12, 48)   # not 2**k


def _script(mod):
    """One scripted run of alloc / ref / release / register / lookup /
    release_leaf / evict_lru over a module's PageAllocator and
    PrefixCache; returns every result in order."""
    a = mod.PageAllocator(10)
    pc = mod.PrefixCache(4, a)
    out = []
    p1 = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]          # 2 full pages + 2
    ids1 = a.alloc(3)
    pc.register(p1, ids1)
    out += [ids1, [a.refcount(p) for p in ids1], len(pc)]
    out += [pc.lookup(p1), pc.lookup(p1 + [11, 12]),
            pc.lookup([1, 2, 3, 4, 9]), pc.lookup([1, 2, 3, 99])]
    for p in ids1:
        a.release(p)
    out += [a.free_pages, a.stats()]
    p2 = [5, 5, 5, 5, 6, 6]
    ids2 = a.alloc(2)
    pc.register(p2, ids2)
    a.ref(ids2[1])
    out += [a.refcount(ids2[1]), pc.release_leaf(ids2[1]),
            pc.release_leaf(ids1[0]), pc.release_leaf(ids1[2]),
            a.refcount(ids2[1])]
    out += [a.alloc(20), a.can_alloc(5)]
    p3 = [7] * 12                                   # 3 full pages
    ids3 = a.alloc(3)
    pc.register(p3, ids3)
    for p in ids3 + ids2:
        a.release(p)
    out += [pc.lookup(p3), pc.lookup(p1)]
    out += [pc.evict_lru(8), a.free_pages, len(pc), pc.evictions]
    out += [pc.evict_lru(9), a.free_pages, len(pc), pc.evictions,
            pc.lookup(p1), pc.lookup(p3), a.stats()]
    a.reset()
    pc.clear()
    out += [a.stats(), len(pc), a.alloc(2)]
    return out


def test_allocator_and_prefix_cache_script_equals_jax():
    assert _script(port_paged) == _script(jax_paged)


def test_allocator_alloc_release_refcount():
    a = PageAllocator(6)                # pages 1..5 usable
    ids = a.alloc(3)
    assert sorted(ids) == [1, 2, 3]
    assert a.free_pages == 2
    assert a.alloc(3) is None           # partial grants never happen
    a.ref(ids[0])
    a.release(ids[0])
    assert a.refcount(ids[0]) == 1
    a.release(ids[0])
    assert a.refcount(ids[0]) == 0 and a.free_pages == 3
    with pytest.raises(ValueError):
        a.release(ids[0])               # a double free is a bug
    with pytest.raises(ValueError):
        a.ref(99)
    a.reset()
    assert a.free_pages == 5
    with pytest.raises(ValueError):
        PageAllocator(1)


def test_prefix_cache_lru_eviction_leaf_first():
    a = PageAllocator(8)                # 7 usable
    pc = PrefixCache(4, a)
    p1 = [1, 2, 3, 4, 5, 6, 7, 8]
    ids1 = a.alloc(2)
    pc.register(p1, ids1)
    for p in ids1:
        a.release(p)                    # owner retired; registry holds
    ids2 = a.alloc(1)
    pc.register([9, 9, 9, 9], ids2)
    a.release(ids2[0])
    assert a.free_pages == 4
    freed = pc.evict_lru(6)
    assert a.free_pages >= 6 and len(freed) >= 2
    assert pc.lookup(p1) == ([], 0)     # the older chain went first


# -- pool ops: exact against the JAX package ----------------------------------


def _pool(rs, pages=7, ps=4, u=6):
    return rs.randn(pages, ps, u).astype('float32')


def test_pool_ops_equal_jax():
    rs = np.random.RandomState(0)
    pool = _pool(rs)
    tables = np.array([[3, 0, 6], [1, 2, 5]], 'int32')
    got = port_paged.gather_pages(torch.tensor(pool), torch.tensor(tables))
    want = jax_paged.gather_pages(jnp.asarray(pool), jnp.asarray(tables))
    assert got.shape == (2, 12, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))

    rows = rs.randn(3, 6).astype('float32')
    ids, offs = np.array([2, 5, 0], 'int32'), np.array([1, 3, 0], 'int32')
    t = torch.tensor(pool)
    assert port_paged.write_paged_rows(
        t, torch.tensor(rows), torch.tensor(ids).long(),
        torch.tensor(offs).long()) is t
    want = jax_paged.write_paged_rows(jnp.asarray(pool), jnp.asarray(rows),
                                      jnp.asarray(ids), jnp.asarray(offs))
    assert np.array_equal(t.numpy(), np.asarray(want))

    chunk = rs.randn(2, 3, 6).astype('float32')
    ids = np.array([[4, 4, 6], [1, 1, 1]], 'int32')
    offs = np.array([[2, 3, 0], [0, 1, 2]], 'int32')
    t = torch.tensor(pool)
    port_paged.write_paged_chunk(t, torch.tensor(chunk),
                                 torch.tensor(ids).long(),
                                 torch.tensor(offs).long())
    want = jax_paged.write_paged_chunk(jnp.asarray(pool), jnp.asarray(chunk),
                                       jnp.asarray(ids), jnp.asarray(offs))
    assert np.array_equal(t.numpy(), np.asarray(want))

    prompt = rs.randn(12, 6).astype('float32')
    ids = np.array([4, 1, TRASH_PAGE], 'int32')
    t = torch.tensor(pool)
    port_paged.write_prefill_pages(t, torch.tensor(prompt),
                                   torch.tensor(ids).long())
    want = jax_paged.write_prefill_pages(jnp.asarray(pool),
                                         jnp.asarray(prompt),
                                         jnp.asarray(ids))
    assert np.array_equal(t.numpy(), np.asarray(want))

    t = torch.tensor(pool)
    port_paged.copy_page(t, 3, 6)
    want = jax_paged.copy_page(jnp.asarray(pool), 3, 6)
    assert np.array_equal(t.numpy(), np.asarray(want))
    spec = PagedCacheSpec({'k': ((6,), 'float32')}, 4, 16)
    fresh = port_paged.init_pool(spec, 3, torch.device('cpu'))
    assert fresh['k'].shape == (3, 4, 6) and not fresh['k'].any()


# -- the paged decode kernel's plain version ----------------------------------


def _paged_case(rs, page_size, max_len=40, slots=3, heads=2, u=32):
    """K/V of ``slots`` sequences scattered into a pool through shuffled
    page tables, the trash page and the unused pages full of large finite
    garbage; returns (q, key pool, value pool, tables, positions, the
    slot-layout K, V)."""
    max_pages = pages_for(max_len, page_size)
    view = max_pages * page_size
    pages = slots * max_pages + 3
    keys = rs.randn(slots, view, u).astype('float32')
    values = rs.randn(slots, view, u).astype('float32')
    kpool = (rs.randn(pages, page_size, u) * 1e30).astype('float32')
    vpool = (rs.randn(pages, page_size, u) * 1e30).astype('float32')
    order = rs.permutation(np.arange(1, pages))
    tables = order[:slots * max_pages].reshape(slots, max_pages) \
        .astype('int32')
    for s in range(slots):
        for j, pg in enumerate(tables[s]):
            kpool[pg] = keys[s, j * page_size:(j + 1) * page_size]
            vpool[pg] = values[s, j * page_size:(j + 1) * page_size]
    positions = np.array([0, max_len // 2, max_len - 1], 'int32')[:slots]
    # entries wholly past a slot's position point at the trash page
    for s, p in enumerate(positions):
        tables[s, p // page_size + 1:] = TRASH_PAGE
        keys[s, (p // page_size + 1) * page_size:] = 0.0
        values[s, (p // page_size + 1) * page_size:] = 0.0
    q = rs.randn(slots, u).astype('float32')
    return q, kpool, vpool, tables, positions, keys, values


@pytest.mark.parametrize('page_size', [8, 16, 128])
def test_flash_paged_decode_matches_jax(page_size):
    rs = np.random.RandomState(page_size)
    q, kpool, vpool, tables, positions, keys, values = _paged_case(
        rs, page_size)
    want = np.asarray(jax_attn.flash_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(tables), jnp.asarray(positions), 2))
    args = [torch.tensor(a) for a in (q, kpool, vpool, tables, positions)]
    kernels.reset_launch_counts()
    got = kernels.flash_paged_decode_attention(*args, heads=2)
    assert not any(kernels.launch_counts().values())   # plain version
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # bitwise the slot decode over the same K/V: the keys past each
    # position (garbage in the pool, zeros in the slot layout) weigh 0
    slot = kernels.flash_decode_attention(
        torch.tensor(q), torch.tensor(keys), torch.tensor(values),
        torch.tensor(positions), 2)
    assert torch.equal(got, slot)
    assert torch.equal(got, kernels.flash_paged_decode_attention_reference(
        *args, heads=2))


def _pool_offset(table, kp, log2_ps, pages, units):
    """``PagedRows::pool_offset`` of ``csrc/flash_decode_fwd.cu``, in
    32-bit unsigned arithmetic."""
    pg = int(table[kp >> log2_ps])
    page = pg if 0 <= pg < pages else 0
    row = (page << log2_ps) | (kp & ((1 << log2_ps) - 1))
    return (row * units) & 0xffffffff


@pytest.mark.parametrize('page_size', [1, 8, 16, 128, 256])
def test_paged_kernel_row_addressing_walks_the_gathered_view(page_size):
    """The paged instance stages row kp of a slot from the pool offset
    ``pool_offset(kp)`` (the kernel's arithmetic, tile by tile, rows past
    the view zero-filled): those rows are exactly the view the plain
    version gathers, for tables with entries outside the pool too."""
    rs = np.random.RandomState(page_size)
    pages, max_pages, u = 9, pages_for(300, page_size), 3
    log2_ps = page_size.bit_length() - 1
    view = max_pages * page_size
    pool = rs.randn(pages, page_size, u).astype('float32')
    table = rs.randint(0, pages, max_pages).astype('int32')
    bad = table.copy()              # entries outside the pool
    bad[1::4] = pages + 2
    bad[2::4] = -1
    for tab in (table, bad):
        flat = pool.reshape(-1)
        safe = np.where((tab >= 0) & (tab < pages), tab, 0)
        want = pool[safe].reshape(view, u)
        for kbase in range(0, view, 128):
            for r in range(128):
                kp = kbase + r
                if kp >= view:
                    break
                at = _pool_offset(tab, kp, log2_ps, pages, u)
                assert np.array_equal(flat[at:at + u], want[kp]), (kp, at)
    # the plain version reads the same rows where every entry is valid
    got = port_paged.gather_pages(torch.tensor(pool),
                                  torch.tensor(table[None]))
    assert np.array_equal(got[0].numpy(), pool[table].reshape(view, u))


@pytest.mark.cuda
def test_paged_kernel_bitwise_slot_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are CUDA C++ for '
                    'sm_90a and have no CPU mode')
    import chip_smoke
    # raises unless bitwise the slot kernel and within 1e-5 of the plain
    # version at every page size, view and position it checks
    assert chip_smoke.check_paged_kernel(torch, kernels,
                                         torch.device('cuda')) <= ATOL


def test_flash_paged_decode_checks():
    q = torch.zeros(2, 32)
    pool = torch.zeros(3, 8, 32)
    tables = torch.zeros(2, 4, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match='divisible'):
        kernels.flash_paged_decode_attention(q, pool, pool, tables, pos, 3)
    with pytest.raises(ValueError, match='slots, U'):
        kernels.flash_paged_decode_attention(q[0], pool, pool, tables, pos, 2)
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.flash_paged_decode_attention(q.to('meta'), pool, pool,
                                             tables, pos, 2)


# -- the paged model paths and program against the JAX package ----------------


@pytest.fixture(scope='module')
def models():
    jmodel, np_params = jax_init_lm(**dict(CFG, max_len=48))
    pmodel, _ = _model(max_len=48)
    return jmodel, np_params, pmodel, {k: torch.tensor(v)
                                       for k, v in np_params.items()}


@pytest.fixture
def knob():
    """Restore the JAX package's pallas knob after the test."""
    yield
    jax_config.unset('MXNET_TPU_PALLAS')


@pytest.mark.parametrize('pallas', ['attention', '0'])
@pytest.mark.parametrize('page_size', [8, 16])
def test_paged_prefill_step_verify_logits_match_jax(models, knob, pallas,
                                                    page_size):
    jmodel, np_params, pmodel, pparams = models
    jax_config.set('MXNET_TPU_PALLAS', pallas)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    spec = pmodel.paged_spec(page_size)
    pages = 2 * spec.max_pages + 1
    jpool = jax_paged.init_pool(jmodel.paged_spec(page_size), pages)
    ppool = port_paged.init_pool(spec, pages, torch.device('cpu'))
    rs = np.random.RandomState(page_size)
    tables = np.zeros((2, spec.max_pages), 'int32')
    tables[:, :] = np.arange(1, pages).reshape(2, spec.max_pages)
    positions = []
    for s, n in enumerate((5, 11)):
        bucket = 16
        toks = np.zeros((1, bucket), 'int32')
        toks[0, :n] = rs.randint(0, CFG['vocab'], n)
        ids = tables[s, :pages_for(bucket, page_size)]
        jpool, jl = jmodel.paged_prefill(jp, jpool, jnp.asarray(toks),
                                         jnp.int32(n), jnp.asarray(ids))
        ppool, pl = pmodel.paged_prefill(pparams, ppool,
                                         torch.tensor(toks).long(), n,
                                         torch.tensor(ids).long())
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-5)
        positions.append(n)
    for name in ppool:
        np.testing.assert_allclose(ppool[name].numpy(),
                                   np.asarray(jpool[name]), atol=1e-4,
                                   rtol=1e-5)
    positions = np.array(positions, 'int32')
    for _ in range(3):
        toks = rs.randint(0, CFG['vocab'], 2).astype('int32')
        jpool, jl = jmodel.paged_step(jp, jpool, jnp.asarray(toks),
                                      jnp.asarray(positions),
                                      jnp.asarray(tables))
        ppool, pl = pmodel.paged_step(pparams, ppool,
                                      torch.tensor(toks).long(),
                                      torch.tensor(positions),
                                      torch.tensor(tables))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-5)
        positions = positions + 1
    chunk = rs.randint(0, CFG['vocab'], (2, 3)).astype('int32')
    jpool, jl = jmodel.paged_verify(jp, jpool, jnp.asarray(chunk),
                                    jnp.asarray(positions),
                                    jnp.asarray(tables))
    ppool, pl = pmodel.paged_verify(pparams, ppool,
                                    torch.tensor(chunk).long(),
                                    torch.tensor(positions),
                                    torch.tensor(tables))
    assert pl.shape == (2, 3, CFG['vocab'])
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-5)
    for name in ppool:
        np.testing.assert_allclose(ppool[name].numpy(),
                                   np.asarray(jpool[name]), atol=1e-4,
                                   rtol=1e-5)


def _paged_greedy(prog, prompt, n, slot=1):
    """Prefill + greedy steps through a JAX or a port PagedDecodeProgram,
    the slot's pages laid out in order from page 1."""
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


@pytest.mark.parametrize('prompt', ([7, 2, 9], [1, 5, 3, 3, 8, 0, 11, 4, 6]))
def test_greedy_tokens_equal_jax_paged_program(models, knob, prompt):
    jmodel, np_params, pmodel, _pp = models
    jax_config.set('MXNET_TPU_PALLAS', 'attention')
    jprog = JaxPagedProgram(jmodel, np_params, slots=2,
                            prefill_buckets=(4, 16), page_size=8)
    pprog = freeze_decode(pmodel, np_params, slots=2,
                          prefill_buckets=(4, 16), page_size=8,
                          device='cpu')
    assert isinstance(pprog, PagedDecodeProgram)
    assert pprog.pages == jprog.pages and pprog.max_pages == jprog.max_pages
    assert pprog.cache_bytes() == jprog.cache_bytes()
    assert _paged_greedy(pprog, prompt, 12) == _paged_greedy(jprog, prompt,
                                                             12)


def test_engine_streams_and_counts_equal_jax_engine(models):
    """The same requests, prefix hits among them, through the JAX engine
    over its paged program and the port's: the same tokens and the same
    prefill, hit and copy counts."""
    jmodel, np_params, pmodel, _pp = models
    base = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    requests = [(base, 6), (base, 6), (base + [7, 7], 5), ([8, 8, 2], 4),
                (base[:8], 5)]
    jprog = JaxPagedProgram(jmodel, np_params, slots=2,
                            prefill_buckets=(4, 16), page_size=8)
    jeng = jax_engine.DecodeEngine(jprog, timeout_s=120.0)
    try:
        want = [jeng.generate(p, max_new_tokens=n).result(120)
                for p, n in requests]
        jst = jeng.stats()['counts']
    finally:
        jeng.close()
    pprog = _paged(pmodel, np_params, slots=2, prefill_buckets=(4, 16),
                   page_size=8)
    eng = DecodeEngine(pprog, timeout_s=60.0)
    try:
        got = [eng.generate(p, max_new_tokens=n).result(60)
               for p, n in requests]
        st = eng.stats()['counts']
    finally:
        eng.close()
    assert got == want
    for key in ('prefills', 'prefix_hits', 'prefix_tokens_saved',
                'cow_copies', 'tokens'):
        assert st[key] == jst[key], key


# -- the engine's paged scheduling (tests/test_paged_decode.py's bar) ---------


@pytest.mark.parametrize('page_size', [8, 16, 128])
def test_paged_bit_identity_across_page_sizes_and_churn(page_size):
    """More sequences than slots (churn, retire, reuse) through a slot
    engine and a paged engine: token streams bitwise equal to each other
    and to the uncached reference. At page size 128 the view (128 rows)
    outgrows max_len (48)."""
    model, params = _model(max_len=48)
    rs = np.random.RandomState(3)
    requests = [(list(rs.randint(1, 18, rs.randint(2, 9))),
                 int(rs.randint(3, 8))) for _ in range(6)]
    slot_outs, _ = _run_engine(_slot(model, params, slots=2,
                                     prefill_buckets=(4, 8)), requests)
    paged_outs, st = _run_engine(
        _paged(model, params, slots=2, prefill_buckets=(4, 8),
               page_size=page_size), requests)
    assert paged_outs == slot_outs
    for (prompt, _n), out in zip(requests, paged_outs):
        assert out == _greedy_reference(model, params, prompt, len(out))
    assert st['free_slots'] == 2 and st['active'] == 0
    # what the pool still holds is the prefix registry's
    assert st['pages']['pages_used'] <= st['pages']['prefix_entries']


def test_prefix_hit_stream_identical_and_cow_diverges():
    """B admits on A's registered prefix (no prefill runs for it), C
    writes past the shared rows into its own copy: all three streams are
    the uncached reference's."""
    model, params = _model(max_len=64)
    prog = _paged(model, params, slots=2, prefill_buckets=(4, 8, 16),
                  page_size=8)
    base = [7, 2, 9, 4, 1, 3, 5, 8, 6, 2]       # 10 tokens: a partial page
    eng = DecodeEngine(prog, timeout_s=60.0)
    try:
        a_out = eng.generate(base, max_new_tokens=6).result(60)
        b_out = eng.generate(base, max_new_tokens=6).result(60)
        c_out = eng.generate(base + [11, 12], max_new_tokens=6).result(60)
        st = eng.stats()
    finally:
        eng.close()
    assert a_out == _greedy_reference(model, params, base, 6)
    assert b_out == a_out
    assert c_out == _greedy_reference(model, params, base + [11, 12], 6)
    assert st['counts']['prefix_hits'] >= 2
    assert st['counts']['prefix_tokens_saved'] > 0
    assert st['counts']['prefills'] == 1


def test_prefix_hit_concurrent_sharers_copy_on_write():
    """Two sequences join the same registered partial page at once (three
    holders): the first writer copies the page, and both streams are the
    reference's."""
    model, params = _model(max_len=64)
    prog = _paged(model, params, slots=3, prefill_buckets=(8,),
                  page_size=8)
    base = [3, 1, 4, 1, 5, 9]           # a partial page
    ref = _greedy_reference(model, params, base, 6)
    eng = DecodeEngine(prog, timeout_s=60.0)
    try:
        for _attempt in range(10):
            # register the prefix without its owner writing the tail
            eng.generate(base, max_new_tokens=1).result(60)
            d = eng.generate([7, 2, 8], max_new_tokens=12)
            b = eng.generate(base, max_new_tokens=6)
            c = eng.generate(base, max_new_tokens=6)
            assert b.result(60) == ref
            assert c.result(60) == ref
            d.result(60)
            st = eng.stats()
            if st['counts']['cow_copies'] >= 1:
                break
    finally:
        eng.close()
    assert st['counts']['prefix_hits'] >= 2
    assert st['counts']['cow_copies'] >= 1
    assert st['free_slots'] == 3


def test_prefix_cache_off_runs_all_prefills():
    model, params = _model()
    prog = _paged(model, params, slots=2, prefill_buckets=(8,), page_size=8)
    outs, st = _run_engine(prog, [([5, 3, 1], 4)] * 3, prefix_cache=False)
    assert outs[0] == outs[1] == outs[2]
    assert st['counts']['prefills'] == 3
    assert st['counts']['prefix_hits'] == 0
    assert 'prefix_entries' not in st['pages']


def test_pool_exhaustion_mid_stream_typed_backpressure():
    """A pool too small for the generation fails the stream typed at the
    page boundary, frees its slot, and the engine serves on."""
    model, params = _model(max_len=48)
    prog = _paged(model, params, slots=2, prefill_buckets=(4,), page_size=8,
                  pages=2)              # one usable page
    eng = DecodeEngine(prog, timeout_s=30.0, prefix_cache=False)
    try:
        s = eng.generate([1, 2, 3], max_new_tokens=30)
        with pytest.raises(BackpressureError):
            s.result(30)
        assert s.finish_reason == 'error' and len(s.tokens) >= 1
        for _ in range(500):
            if eng.stats()['free_slots'] == 2:
                break
            threading.Event().wait(0.01)
        st = eng.stats()
        assert st['free_slots'] == 2 and st['counts']['pool_exhausted'] >= 1
        ok = eng.generate([4, 5], max_new_tokens=3)
        assert ok.result(30) == _greedy_reference(model, params, [4, 5], 3)
    finally:
        eng.close()


def test_pool_exhaustion_at_admission_typed():
    model, params = _model(max_len=48)
    prog = _paged(model, params, slots=2, prefill_buckets=(16,), page_size=8,
                  pages=2)
    eng = DecodeEngine(prog, timeout_s=30.0, prefix_cache=False)
    try:
        s = eng.generate([1, 2, 3, 4, 5, 6, 7, 8, 9], max_new_tokens=2)
        with pytest.raises(BackpressureError):
            s.result(30)
        st = eng.stats()
        assert st['counts']['pool_exhausted'] >= 1
        assert st['free_slots'] == 2 and st['pages']['pages_used'] == 0
    finally:
        eng.close()


def test_registered_prefixes_evicted_lru_under_pressure():
    model, params = _model(max_len=48)
    prog = _paged(model, params, slots=1, prefill_buckets=(8,), page_size=8,
                  pages=3)              # 2 usable pages
    eng = DecodeEngine(prog, timeout_s=60.0)
    try:
        eng.generate([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=3).result(60)
        out = eng.generate([9, 8, 7, 6, 5, 4, 3, 2],
                           max_new_tokens=3).result(60)
        st = eng.stats()
    finally:
        eng.close()
    assert out == _greedy_reference(model, params, [9, 8, 7, 6, 5, 4, 3, 2],
                                    3)
    assert st['counts']['page_evictions'] >= 1


class _FailingProgram:
    """A paged program whose ``fail_at``-th step raises."""

    def __init__(self, prog, fail_at):
        self._prog, self._n, self.fail_at = prog, 0, fail_at

    def __getattr__(self, name):
        return getattr(self._prog, name)

    def run_step(self, *args, **extras):
        self._n += 1
        if self._n == self.fail_at:
            raise RuntimeError('device lost')
        return self._prog.run_step(*args, **extras)


def test_failed_step_fails_streams_and_rebuilds_the_pool():
    """A failed device call fails the streams it carried (not degraded:
    the port has no CPU fallback yet), resets the allocator and the
    prefix registry with the pool, and the engine serves clean after."""
    model, params = _model(max_len=48)
    prog = _FailingProgram(_paged(model, params, slots=2,
                                  prefill_buckets=(8,), page_size=8), 2)
    ref = _greedy_reference(model, params, [1, 2, 3], 5)
    eng = DecodeEngine(prog, timeout_s=60.0)
    try:
        streams = [eng.generate([1, 2, 3], max_new_tokens=5)
                   for _ in range(2)]
        for s in streams:
            with pytest.raises(RuntimeError, match='device lost'):
                s.result(60)
        ok = eng.generate([1, 2, 3], max_new_tokens=5)
        assert ok.result(60) == ref
        st = eng.stats()
    finally:
        eng.close()
    assert st['free_slots'] == 2
    assert st['counts']['retired'].get('error') == 2
    # nothing of the failed run is left held: the clean run's own tail
    # write took its partial page's registration back
    assert st['pages']['pages_used'] == st['pages']['prefix_entries'] == 0


def test_failed_step_empties_the_pool_before_any_admission():
    """The pool's host state resets as the failed step is handled, as the
    reference's except paths rebuild at once: ``stats()['pages']`` and
    ``cache_accounting()`` read an empty pool before any new request (the
    prompts' prefix registrations went with it)."""
    model, params = _model(max_len=48)
    prog = _FailingProgram(_paged(model, params, slots=2,
                                  prefill_buckets=(8,), page_size=8), 2)
    eng = DecodeEngine(prog, timeout_s=60.0)
    try:
        streams = [eng.generate([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=5)
                   for _ in range(2)]
        for s in streams:
            with pytest.raises(RuntimeError, match='device lost'):
                s.result(60)
        for _ in range(500):
            st = eng.stats()
            if st['free_slots'] == 2 and st['pages']['pages_used'] == 0:
                break
            threading.Event().wait(0.01)
        acc = eng.cache_accounting()
    finally:
        eng.close()
    assert st['free_slots'] == 2
    assert st['counts']['retired'].get('error') == 2
    assert st['pages']['pages_used'] == st['pages']['prefix_entries'] == 0
    pool = acc['pool']
    assert pool['pages_used'] == 0 and pool['pages_free'] == pool['pages_total']


# -- speculative decoding -----------------------------------------------------


def test_spec_decoding_with_self_draft_accepts_everything():
    model, params = _model(max_len=64)
    target = _paged(model, params, slots=2, prefill_buckets=(4, 8),
                    page_size=8, spec_k=2)
    draft = _slot(model, params, slots=2, prefill_buckets=(4, 8))
    requests = [([7, 2, 9], 8), ([1, 2, 3, 4, 5], 8)]
    plain = _paged(model, params, slots=2, prefill_buckets=(4, 8),
                   page_size=8)
    want, _ = _run_engine(plain, requests)
    outs, st = _run_engine(target, requests, draft=draft)
    assert outs == want
    assert st['spec']['proposed'] > 0
    assert st['spec']['acceptance_rate'] >= 0.9
    assert st['counts']['steps'] < sum(len(o) for o in outs)


def test_spec_decoding_small_draft_correct_and_counted():
    model, params = _model(max_len=64)
    dmodel, dparams = init_transformer_lm(vocab=19, units=16, hidden=16,
                                          layers=1, heads=2, max_len=64,
                                          seed=5)
    target = _paged(model, params, slots=2, prefill_buckets=(4, 8),
                    page_size=8, spec_k=3)
    draft = _slot(dmodel, dparams, slots=2, prefill_buckets=(4, 8))
    requests = [([7, 2, 9], 8), ([4, 4, 2, 1], 8)]
    outs, st = _run_engine(target, requests, draft=draft)
    for (prompt, _n), out in zip(requests, outs):
        assert out == _greedy_reference(model, params, prompt, len(out))
    assert st['spec']['k'] == 3 and st['spec']['proposed'] > 0
    assert 0.0 <= st['spec']['acceptance_rate'] <= 1.0
    assert st['counts']['spec_rounds'] > 0


def test_spec_draft_cache_has_no_holes_after_full_acceptance():
    """A fully accepted round moves past the last proposal's position;
    the draft must still have written that row, or later rounds attend a
    zero row."""
    model, params = _model(max_len=64)
    target = _paged(model, params, slots=1, prefill_buckets=(4,),
                    page_size=8, spec_k=2)
    draft = _slot(model, params, slots=1, prefill_buckets=(4,))
    eng = DecodeEngine(target, timeout_s=60.0, draft=draft)
    try:
        out = eng.generate([7, 2, 9], max_new_tokens=12).result(60)
        st = eng.stats()
        assert st['spec']['acceptance_rate'] == 1.0
        k0 = eng._draft_cache['l0_k'][0].numpy()        # (max_len, U)
        for pos in range(3 + len(out) - 1):
            assert np.abs(k0[pos]).sum() > 0, 'draft KV hole at %d' % pos
    finally:
        eng.close()
    assert out == _greedy_reference(model, params, [7, 2, 9], 12)


def test_spec_stream_length_parity_at_max_len_wall():
    model, params = init_transformer_lm(vocab=19, units=16, hidden=24,
                                        layers=2, heads=4, max_len=16)
    plain = _paged(model, params, slots=1, prefill_buckets=(4,), page_size=8)
    want, _ = _run_engine(plain, [([7, 2, 9], 50)])
    target = _paged(model, params, slots=1, prefill_buckets=(4,),
                    page_size=8, spec_k=2)
    draft = _slot(model, params, slots=1, prefill_buckets=(4,))
    got, _ = _run_engine(target, [([7, 2, 9], 50)], draft=draft)
    assert got == want
    assert len(got[0]) == 16 - 3        # filled to the wall


def test_spec_requires_paged_target_and_matching_slots():
    model, params = _model()
    draft = _slot(model, params, slots=2, prefill_buckets=(4,))
    with pytest.raises(ValueError, match='paged target'):
        DecodeEngine(_slot(model, params, slots=2, prefill_buckets=(4,)),
                     draft=draft)
    with pytest.raises(ValueError, match='spec_k > 0'):
        DecodeEngine(_paged(model, params, slots=2, prefill_buckets=(4,),
                            page_size=8, spec_k=0), draft=draft)
    with pytest.raises(ValueError, match='slots'):
        DecodeEngine(_paged(model, params, slots=3, prefill_buckets=(4,),
                            page_size=8, spec_k=2), draft=draft)
    paged_draft = _paged(model, params, slots=2, prefill_buckets=(4,),
                         page_size=8)
    with pytest.raises(ValueError, match='slot-cache'):
        DecodeEngine(_paged(model, params, slots=2, prefill_buckets=(4,),
                            page_size=8, spec_k=2), draft=paged_draft)


def test_spec_draft_stays_in_lockstep_through_prefix_extension():
    """A prefix hit streams its suffix through plain paged ticks before
    speculation resumes; those ticks step the draft too, so the stream
    stays exact with high acceptance."""
    model, params = _model(max_len=64)
    target = _paged(model, params, slots=2, prefill_buckets=(8,),
                    page_size=8, spec_k=2)
    draft = _slot(model, params, slots=2, prefill_buckets=(8,))
    base = [3, 1, 4, 1, 5, 9]
    ref = _greedy_reference(model, params, base, 8)
    with InferenceSession(target, timeout_s=60.0, draft=draft) as sess:
        sess.generate(base, max_new_tokens=1).result(60)
        assert sess.generate(base, max_new_tokens=8).result(60) == ref
        st = sess.stats()
    assert st['counts']['prefix_hits'] >= 1
    assert st['spec']['proposed'] > 0
    assert st['spec']['acceptance_rate'] >= 0.9


# -- accounting ---------------------------------------------------------------


def test_pool_bytes_accounting_and_per_sequence():
    model, params = _model(max_len=48)
    prog = _paged(model, params, slots=4, prefill_buckets=(8,), page_size=8,
                  pages=13)
    assert prog.cache_bytes() == 13 * 8 * 16 * 4 * 2 * 2
    assert prog.page_bytes() == 8 * 16 * 4 * 2 * 2
    assert prog.per_sequence_bytes(12) == 2 * prog.page_bytes()
    assert prog.per_sequence_bytes() == 6 * prog.page_bytes()
    slot = _slot(model, params, slots=4, prefill_buckets=(8,))
    assert prog.cache_bytes() < slot.cache_bytes()
    assert slot.per_sequence_bytes() == slot.cache_bytes() // 4


def test_engine_cache_accounting_and_stats():
    model, params = _model(max_len=48)
    prog = _paged(model, params, slots=2, prefill_buckets=(8,), page_size=8)
    assert prog.pages == 2 * 6 + 1 and prog.max_pages == 6
    with InferenceSession(prog, timeout_s=30) as sess:
        sess.generate([5, 3, 1], max_new_tokens=3).result(30)
        st = sess.stats()
    acct = st['cache']
    assert acct['paged'] is True and st['paged'] is True
    assert acct['cache_bytes'] == prog.cache_bytes() == st['cache_bytes']
    assert acct['page_bytes'] == prog.page_bytes()
    assert acct['per_sequence_bytes_amortized'] >= prog.page_bytes()
    assert acct['max_concurrent_sequences_per_gb'] > 0
    assert st['pages']['pages_total'] == prog.pages - 1
    slot = _slot(model, params, slots=2, prefill_buckets=(8,))
    with InferenceSession(slot, timeout_s=30) as sess:
        st = sess.stats()
    assert st['cache']['paged'] is False and 'pages' not in st
    assert st['cache']['per_sequence_bytes_amortized'] == \
        slot.cache_bytes() // 2
