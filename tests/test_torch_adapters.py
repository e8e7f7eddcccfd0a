"""Port parity of multi-adapter (LoRA) serving: ``mxnet_tpu_torch``'s
adapter artifacts, pool, registry, adapted model paths and engine against
the JAX package's (``mxnet_tpu/serving/adapters/__init__.py``,
``decode/model.py:295-330``).

A small model (vocab 23, units 16, 2 layers, 4 heads) and its adapters
come from numpy seeds in both packages. What is held: artifacts cross in
both directions bit-exact with equal digests, and a changed byte is a typed
``ValueError``; the pool's dedup, refcounts, LRU eviction and typed
exhaustion; the registry's resolution; logits with adapters within 1e-5 of
the JAX programs' (the flash kernels' reduction tier) and greedy tokens
equal, over the slot and the paged cache; the base row byte for byte the
program without adapters; the prefix cache's adapter namespaces; and an
8-adapter greedy / sampled / speculative mix building no program.
"""
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.serving import adapters as jax_adapters
from mxnet_tpu.serving.decode import paged as jax_paged
from mxnet_tpu.serving.decode.model import \
    init_transformer_lm as jax_init_lm
from mxnet_tpu.serving.decode.program import \
    freeze_decode as jax_freeze_decode
from mxnet_tpu_torch.serving import BackpressureError, freeze_decode
from mxnet_tpu_torch.serving import adapters
from mxnet_tpu_torch.serving.decode import (DecodeEngine, DecodeModel,
                                            init_transformer_lm)
from mxnet_tpu_torch.serving.decode import paged as port_paged

torch.set_num_threads(1)

CFG = dict(vocab=23, units=16, hidden=24, layers=2, heads=4, max_len=96)
RANK = 4
TOL = 1e-5
PROMPT = [3, 5, 7, 11, 13]


@pytest.fixture(scope='module')
def models():
    jmodel, np_params = jax_init_lm(**CFG)
    pmodel, _ = init_transformer_lm(**CFG)
    return jmodel, pmodel, np_params


def _adapter(pkg, model, seed, rank=RANK, scale=50.0):
    # scale 50: a random 0.05-std A / B product is small; the effect
    # tests need the delta to move an argmax
    return pkg.init_adapter(model, rank=rank, seed=seed, scale=scale,
                            name='ad%d' % seed)


# -- the artifact -----------------------------------------------------------------


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_artifacts_cross_bit_exact_both_ways(models, tmp_path, writer):
    jmodel, pmodel, _ = models
    jad, pad = _adapter(jax_adapters, jmodel, 3), _adapter(adapters, pmodel, 3)
    assert jad.digest == pad.digest
    path = str(tmp_path / 'ad')
    if writer == 'jax':
        jax_adapters.save_adapter(path, jad)
        got = adapters.load_adapter(path)
    else:
        adapters.save_adapter(path, pad)
        got = jax_adapters.load_adapter(path)
    src = jad if writer == 'jax' else pad
    assert (got.name, got.rank, got.scale, got.digest) == \
        (src.name, src.rank, src.scale, src.digest)
    assert sorted(got.arrays) == sorted(src.arrays)
    for k, v in src.arrays.items():
        assert got.arrays[k].dtype == v.dtype
        assert got.arrays[k].tobytes() == v.tobytes(), k
    assert got.targets() == src.targets()


@pytest.mark.parametrize('target', ['MANIFEST.json', 'params.npz',
                                    'params.npz value'])
def test_a_changed_byte_is_a_typed_load_error(models, tmp_path, target):
    """A digit of the manifest's scale, a raw byte in the middle of the
    stored archive (its CRC then fails), or one array value written back
    as a valid archive (the reference's test): each a ``ValueError``, in
    both packages where the archive still reads."""
    _jm, pmodel, _ = models
    path = str(tmp_path / 'ad')
    adapters.save_adapter(path, _adapter(adapters, pmodel, 1))
    f = os.path.join(path, target.split()[0])
    with open(f, 'rb') as fh:
        data = bytearray(fh.read())
    if target == 'MANIFEST.json':
        at = data.index(b'"scale"') + 9
        data[at:at + 1] = b'7' if data[at:at + 1] != b'7' else b'8'
    elif target == 'params.npz':
        data[len(data) // 2] ^= 0x40
    else:
        arrays = dict(adapters.load_adapter(path).arrays)
        key = sorted(arrays)[0]
        arrays[key] = arrays[key].copy()
        arrays[key].flat[0] += 1.0
        np.savez(f, **arrays)
    if target != 'params.npz value':
        with open(f, 'wb') as fh:
            fh.write(bytes(data))
    with pytest.raises(ValueError):
        adapters.load_adapter(path)
    if target != 'params.npz':
        with pytest.raises(ValueError, match='digest'):
            jax_adapters.load_adapter(path)


def test_spec_and_padding_equal_jax(models):
    jmodel, pmodel, _ = models
    jspec = jax_adapters.AdapterSpec.for_model(jmodel, RANK, 3)
    pspec = adapters.AdapterSpec.for_model(pmodel, RANK, 3)
    assert pspec.to_manifest() == jspec.to_manifest()
    assert pspec.pool_bytes() == jspec.pool_bytes()
    assert adapters.AdapterSpec.from_manifest(jspec.to_manifest()) == pspec
    with pytest.raises(ValueError, match='capacity'):
        adapters.AdapterSpec(pspec.targets, RANK, 1)
    low = _adapter(adapters, pmodel, 2, rank=2, scale=3.0)
    want = jax_adapters.AdapterPool(jspec)._padded(
        _adapter(jax_adapters, jmodel, 2, rank=2, scale=3.0))
    got = adapters.AdapterPool(pspec, device='cpu')._padded(low)
    for k, (a, b) in want.items():
        assert got[k][0].tobytes() == a.tobytes()
        assert got[k][1].tobytes() == b.tobytes()
    with pytest.raises(ValueError, match='exceeds pool rank'):
        adapters.AdapterPool(pspec, device='cpu')._padded(
            _adapter(adapters, pmodel, 2, rank=RANK + 1))


# -- the pool and the registry ---------------------------------------------------


def test_pool_dedup_refcount_lru_and_exhaustion(models):
    _jm, pmodel, _ = models
    spec = adapters.AdapterSpec.for_model(pmodel, RANK, 3)   # 2 rows + base
    pool = adapters.AdapterPool(spec, device='cpu')
    a, b, c = (_adapter(adapters, pmodel, s) for s in (10, 11, 12))
    ia = pool.load(a)
    assert pool.load(a) == ia                  # dedup: a reference more
    ib = pool.load(b)
    assert {ia, ib} == {1, 2}
    tree = pool.device_tree()
    padded = pool._padded(a)
    for k, (da, db) in tree.items():
        assert torch.equal(da[ia], torch.from_numpy(padded[k][0]))
        assert torch.equal(db[ib], torch.from_numpy(pool._padded(b)[k][1]))
        assert not da[0].any() and not db[0].any()      # the base row
    with pytest.raises(adapters.AdapterExhaustedError) as err:
        pool.load(c)                           # every row pinned
    assert isinstance(err.value, BackpressureError)
    assert (err.value.depth, err.value.limit) == (3, 3)
    pool.release(ia)
    pool.release(ia)
    pool.release(ib)
    pool.acquire(ib)                           # b used last: a is the LRU
    pool.release(ib)
    ic = pool.load(c)
    assert ic == ia and pool.index_of(a.digest) is None
    assert pool.index_of(c.digest) == ic and pool.index_of(b.digest) == ib
    st = pool.stats()
    assert (st['resident'], st['pinned'], st['loads'], st['evictions']) == \
        (2, 1, 3, 1)
    assert st['pool_bytes'] == spec.pool_bytes()
    pool.release(0)                            # the base is never released
    with pytest.raises(KeyError):
        adapters.AdapterPool(spec, device='cpu').acquire(1)


def test_pool_binds_a_programs_tensors_in_place(models):
    _jm, pmodel, np_params = models
    prog = freeze_decode(pmodel, np_params, slots=2, prefill_buckets=(8,),
                         paged=False, adapter_rank=RANK, adapter_slots=3,
                         device='cpu')
    pool = adapters.AdapterPool(prog.adapter_spec, device='cpu')
    ia = pool.load(_adapter(adapters, pmodel, 4))
    ptrs = {k: (a.data_ptr(), b.data_ptr()) for k, (a, b) in prog.apool.items()}
    pool.bind(prog.apool)
    assert pool.device_tree() == prog.apool
    assert {k: (a.data_ptr(), b.data_ptr())
            for k, (a, b) in pool.device_tree().items()} == ptrs
    ib = pool.load(_adapter(adapters, pmodel, 5))
    for k, (a, b) in prog.apool.items():
        assert a[ia].any() and a[ib].any() and not a[0].any()
    other = adapters.AdapterSpec.for_model(pmodel, RANK + 1, 3)
    with pytest.raises(ValueError, match='spec asks'):
        adapters.AdapterPool(other, device='cpu').bind(prog.apool)


def test_registry_resolves_and_rejects_ids(models, tmp_path):
    _jm, pmodel, _ = models
    spec = adapters.AdapterSpec.for_model(pmodel, RANK, 4)
    root = str(tmp_path)
    adapters.save_adapter(os.path.join(root, 'disk'),
                          _adapter(adapters, pmodel, 20))
    reg = adapters.AdapterRegistry(adapters.AdapterPool(spec, device='cpu'),
                                   root=root)
    reg.register('mem', _adapter(adapters, pmodel, 21))
    for base in adapters.AdapterRegistry.BASE_IDS:
        assert reg.acquire(base) == 0 and reg.host_tree(base) is None
    im, idisk = reg.acquire('mem'), reg.acquire('disk')
    assert 0 < im != idisk > 0
    assert reg.ids() == ['disk', 'mem']
    assert reg.acquire('disk') == idisk        # loaded once, refcounted
    tree = reg.host_tree('disk')
    assert sorted(tree) == sorted(spec.targets)
    with pytest.raises(KeyError, match='unknown adapter id'):
        reg.acquire('nope')
    reg.release(idisk)
    assert reg.pool.stats()['pinned'] == 2


# -- the adapted model paths -----------------------------------------------------


def _pools(models, kind):
    """(JAX program, its pool tree, port program) with two resident
    adapters (rows 1, 2) of the same seeds."""
    jmodel, pmodel, np_params = models
    args = dict(slots=2, prefill_buckets=(8,), adapter_rank=RANK,
                adapter_slots=3, paged=kind == 'paged')
    if kind == 'paged':
        args['page_size'] = 8
    jprog = jax_freeze_decode(jmodel, np_params, **args)
    pprog = freeze_decode(pmodel, np_params, device='cpu', **args)
    jpool = jax_adapters.AdapterPool(jprog.adapter_spec)
    ppool = adapters.AdapterPool(pprog.adapter_spec)
    ppool.bind(pprog.apool)
    for seed in (30, 31):
        assert jpool.load(_adapter(jax_adapters, jmodel, seed)) == \
            ppool.load(_adapter(adapters, pmodel, seed))
    return jprog, jpool.device_tree(), pprog


def _run(prog, kind, aidx, apool=None):
    """Slot 0 prefills PROMPT under adapter row ``aidx[0]``, slot 1
    ``PROMPT[:3]`` under ``aidx[1]``; then three steps. Every call's
    tokens and logits."""
    kw = {} if apool is None else {'apool': apool}
    cache = prog.new_cache()
    tables = np.zeros((2, getattr(prog, 'max_pages', 1)), 'int32')
    out, last, pos = [], np.zeros(2, 'int32'), np.zeros(2, 'int32')
    for s, prompt in enumerate((PROMPT, PROMPT[:3])):
        if kind == 'paged':
            tables[s] = 1 + s * prog.max_pages + np.arange(prog.max_pages)
            where = [int(tables[s, 0])]
        else:
            where = s
        cache, tok, logits = prog.run_prefill(cache, prompt, where,
                                              aidx=aidx[s], **kw)
        out.append(([tok], np.asarray(logits)))
        last[s], pos[s] = tok, len(prompt)
    for _ in range(3):
        args = (cache, last, pos) + ((tables,) if kind == 'paged' else ())
        cache, toks, logits = prog.run_step(*args, aidx=aidx, **kw)
        out.append((list(np.asarray(toks)), np.asarray(logits)))
        last, pos = np.asarray(toks, 'int32'), pos + 1
    return out


@pytest.mark.parametrize('kind', ['slot', 'paged'])
def test_adapted_logits_and_tokens_equal_jax(models, kind):
    jprog, jtree, pprog = _pools(models, kind)
    for aidx in ([1, 2], [2, 0]):
        got = _run(pprog, kind, aidx)
        want = _run(jprog, kind, aidx, apool=jtree)
        for (gt, gl), (wt, wl) in zip(got, want):
            assert gt == list(np.asarray(wt).reshape(-1))
            np.testing.assert_allclose(gl, wl.reshape(gl.shape), atol=TOL,
                                       rtol=TOL)
    # the adapters move the logits
    base = _run(pprog, kind, [0, 0])
    assert not np.allclose(base[0][1], got[0][1], atol=1e-3)


@pytest.mark.parametrize('kind', ['slot', 'paged'])
def test_base_row_is_the_program_without_adapters(models, kind):
    _jp, _jt, pprog = _pools(models, kind)
    jmodel, pmodel, np_params = models
    args = dict(slots=2, prefill_buckets=(8,), paged=kind == 'paged',
                device='cpu')
    if kind == 'paged':
        args['page_size'] = 8
    plain = freeze_decode(pmodel, np_params, **args)
    assert plain.adapter_spec is None
    got, want = _run(pprog, kind, [0, 0]), _run(plain, kind, [0, 0])
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt and np.array_equal(gl, wl)


def test_family_without_lora_targets_is_refused(models):
    _jm, pmodel, np_params = models

    class NoLora(DecodeModel):
        family = 'no_lora'

    with pytest.raises(TypeError, match='no LoRA targets'):
        freeze_decode(NoLora(dict(vocab=3, max_len=8)), np_params,
                      adapter_rank=2, device='cpu')


# -- the engine ----------------------------------------------------------------------


def test_prefix_cache_namespaces_equal_jax():
    def script(mod):
        alloc = mod.PageAllocator(16)
        cache = mod.PrefixCache(4, alloc)
        prompt = list(range(10))
        ids = alloc.alloc(3)
        cache.register(prompt, ids, namespace='a')
        out = [cache.lookup(prompt), cache.lookup(prompt, namespace='a'),
               cache.lookup(prompt, namespace='b')]
        ids2 = alloc.alloc(3)
        cache.register(prompt, ids2)
        out += [cache.lookup(prompt), cache.lookup(prompt, namespace='a'),
                len(cache), alloc.stats()]
        return out
    got, want = script(port_paged), script(jax_paged)
    assert got == want
    assert got[0] == ([], 0) and got[1][1] == 10 and got[2] == ([], 0)


def test_engine_prefix_hits_stay_in_their_namespace(models):
    """The same prompt under adapter A, then the base, then A again: the
    base run never lands on A's pages; A's second run does, and every
    stream equals the one a fresh engine serves."""
    _jm, pmodel, np_params = models
    prompt = list(range(1, 20))

    def engine():
        prog = freeze_decode(pmodel, np_params, slots=2,
                             prefill_buckets=(32,), page_size=8,
                             adapter_rank=RANK, adapter_slots=3,
                             device='cpu')
        reg = adapters.AdapterRegistry(adapters.AdapterPool(
            prog.adapter_spec))
        reg.register('A', _adapter(adapters, pmodel, 40))
        return DecodeEngine(prog, adapters=reg, timeout_s=60)

    outs, hits = [], []
    with engine() as eng:
        for ad in ('A', None, 'A'):
            before = eng.stats()['counts']['prefix_hits']
            outs.append(eng.generate(prompt, max_new_tokens=4,
                                     adapter=ad).result(60))
            hits.append(eng.stats()['counts']['prefix_hits'] - before)
    assert hits == [0, 0, 1]
    for ad, out in zip(('A', None), outs):
        with engine() as fresh:
            assert fresh.generate(prompt, max_new_tokens=4,
                                  adapter=ad).result(60) == out
    assert outs[0] == outs[2] != outs[1]


def test_engine_rejects_unknown_and_unserved_adapters(models):
    _jm, pmodel, np_params = models
    plain = freeze_decode(pmodel, np_params, slots=2, prefill_buckets=(8,),
                          paged=False, device='cpu')
    with pytest.raises(ValueError, match='without an adapter_spec'):
        DecodeEngine(plain, adapters='/nonexistent')
    with DecodeEngine(plain, timeout_s=30) as eng:
        with pytest.raises(ValueError, match='serves no adapters'):
            eng.generate(PROMPT, adapter='A')
    prog = freeze_decode(pmodel, np_params, slots=2, prefill_buckets=(8,),
                         paged=False, adapter_rank=RANK, adapter_slots=3,
                         device='cpu')
    other = adapters.AdapterRegistry(adapters.AdapterPool(
        adapters.AdapterSpec.for_model(pmodel, RANK, 4), device='cpu'))
    with pytest.raises(ValueError, match='does not match'):
        DecodeEngine(prog, adapters=other)
    with DecodeEngine(prog, timeout_s=30) as eng:
        stream = eng.generate(PROMPT, max_new_tokens=2, adapter='nope')
        with pytest.raises(KeyError, match='unknown adapter id'):
            stream.result(30)
        assert eng.stats()['counts']['adapter_rejects'] == 1
        assert len(eng.generate(PROMPT, max_new_tokens=2).result(30)) == 2
        assert eng.stats()['free_slots'] == 2


def test_pinned_pool_rejects_typed_and_recovers(models):
    """Two adapters pinned by live sequences in a pool of two rows: a
    third adapter's request fails with AdapterExhaustedError; once they
    retire it is served."""
    _jm, pmodel, np_params = models
    prog = freeze_decode(pmodel, np_params, slots=3, prefill_buckets=(8,),
                         paged=False, adapter_rank=RANK, adapter_slots=3,
                         device='cpu')
    reg = adapters.AdapterRegistry(adapters.AdapterPool(prog.adapter_spec))
    for i in range(3):
        reg.register('ad%d' % i, _adapter(adapters, pmodel, 50 + i))
    with DecodeEngine(prog, adapters=reg, timeout_s=60) as eng:
        long = [eng.generate(PROMPT, max_new_tokens=60, adapter='ad%d' % i)
                for i in range(2)]
        for _ in range(6000):
            if reg.pool.stats()['pinned'] == 2:
                break
            time.sleep(0.005)
        third = eng.generate(PROMPT, max_new_tokens=2, adapter='ad2')
        with pytest.raises(adapters.AdapterExhaustedError):
            third.result(60)
        for s in long:
            s.result(60)
        assert len(eng.generate(PROMPT, max_new_tokens=2,
                                adapter='ad2').result(60)) == 2
        assert eng.stats()['counts']['adapter_rejects'] == 1
    assert reg.pool.stats()['pinned'] == 0


def test_adapter_mix_builds_no_program(models):
    """Eight adapters through a pool of five rows (evictions), greedy and
    sampled, with and without speculation: the programs built at start
    are the only ones, and each adapter's greedy stream is the one it
    gets alone."""
    _jm, pmodel, np_params = models
    prog = freeze_decode(pmodel, np_params, slots=4, prefill_buckets=(8,),
                         page_size=8, spec_k=2, adapter_rank=RANK,
                         adapter_slots=5, device='cpu')
    draft = freeze_decode(pmodel, np_params, slots=4, prefill_buckets=(8,),
                          paged=False, device='cpu')
    reg = adapters.AdapterRegistry(adapters.AdapterPool(prog.adapter_spec))
    for i in range(8):
        reg.register('ad%d' % i, _adapter(adapters, pmodel, 60 + i))
    with DecodeEngine(prog, draft=draft, adapters=reg, timeout_s=60) as eng:
        built = (prog.compile_count, draft.compile_count)
        assert built == (4, 2)
        streams = [eng.generate(PROMPT, max_new_tokens=6,
                                adapter='ad%d' % (i % 8),
                                temperature=0.8 * (i % 2), top_p=0.9, seed=i)
                   for i in range(16)]
        outs = [s.result(60) for s in streams]
        st = eng.stats()
    assert (prog.compile_count, draft.compile_count) == built
    assert st['counts']['spec_rounds'] > 0
    assert st['counts']['sampled_tokens'] == 8 * 6
    assert reg.pool.stats()['evictions'] > 0
    with DecodeEngine(freeze_decode(
            pmodel, np_params, slots=4, prefill_buckets=(8,), page_size=8,
            adapter_rank=RANK, adapter_slots=5, device='cpu'),
            adapters=reg, timeout_s=60) as alone:
        for i in (0, 2):
            assert alone.generate(PROMPT, max_new_tokens=6,
                                  adapter='ad%d' % i).result(60) == outs[i]
    assert len({tuple(o) for o in outs[0::2]}) > 1
    assert all(len(o) == 6 for o in outs)
