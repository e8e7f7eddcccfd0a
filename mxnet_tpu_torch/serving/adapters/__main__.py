"""Self-test of the multi-adapter serving path, the port of
``mxnet_tpu/serving/adapters/__main__.py``.

``python -m mxnet_tpu_torch.serving.adapters`` builds the reference's
tiny TransformerLM (vocabulary 61, units 32, 4 heads: head dim 8; the
draft 16 units, 2 heads), stamps a directory of seeded LoRA artifacts and
drives the adapter path end to end through the port's own modules, on
the card unless ``--device cpu`` is given. Every leg prints one line; the
verdict ``{"ok": ..., "checks": {leg: "ok" | problem}}`` goes to
``--out`` (default ``ADAPTERS_SELFTEST.json``) and the exit code is 0
only when every leg passed.

Legs, at the reference's widths, seeds, adapter counts, ranks and
scales:

  1 artifact         the save / load round trip is bit-exact and its
                     digest stable; a value changed in params.npz or the
                     manifest is a ValueError, not a quiet wrong fine-tune;
                     a directory that is no adapter artifact is refused.
  2 pool             row 0 is the reserved all-zero base; loading one
                     digest twice takes one row; release drops the pin
                     but keeps the row warm; a full pool evicts the LRU
                     unpinned row; with every row pinned the next load
                     raises the typed AdapterExhaustedError (a
                     BackpressureError).
  3 zero_retrace     after warm-up traffic, 8 adapters rotate through
                     mixed greedy / sampled paged and speculative traffic
                     with no program built by the rotation, in the target
                     or the draft (the port's ``compile_count``, where the
                     reference reads its ``trace_counts``): switching
                     adapters is an int32 input, never a new program.
  4 temp0_identity   the program carrying the sampling and adapter extras
                     at temperature 0 is token for token the program
                     without them, and adapter "base" is no adapter.
  5 sampled_spec     same seed, same prompt: speculative and plain
                     decoding emit the same sampled stream (coupled
                     rejection sampling keeps the target's law token for
                     token).
  6 prefix_isolation adapter ids namespace the prefix cache: a chain
                     registered under one id is invisible under another,
                     and one prompt served under two adapters never
                     shares KV.

Usage::

    python -m mxnet_tpu_torch.serving.adapters --device cpu --out A.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as onp

VOCAB = 61
PROMPT = [3, 5, 7, 11, 13]


def _model():
    from ..decode.model import init_transformer_lm
    return init_transformer_lm(VOCAB, units=32, hidden=64, layers=2,
                               heads=4, max_len=96, seed=0)


def _draft(device):
    from ..decode.model import init_transformer_lm
    from ..decode.program import freeze_decode
    dm, dp = init_transformer_lm(VOCAB, units=16, hidden=32, layers=1,
                                 heads=2, max_len=96, seed=9)
    return freeze_decode(dm, dp, slots=4, prefill_buckets=(16, 32),
                         paged=False, sample_args=True, device=device)


def _stamp_adapters(root, model, n, rank=4):
    from . import init_adapter, save_adapter
    paths = []
    for i in range(n):
        ad = init_adapter(model, rank=rank, seed=100 + i, scale=50.0,
                          name='ad%d' % i)
        paths.append(save_adapter(os.path.join(root, 'ad%d' % i), ad))
    return paths


def check_artifact(tmp):
    from . import init_adapter, load_adapter, save_adapter
    model, _ = _model()
    ad = init_adapter(model, rank=4, seed=1, scale=2.5, name='round')
    path = save_adapter(os.path.join(tmp, 'round'), ad)
    back = load_adapter(path)
    if back.digest != ad.digest:
        return 'digest changed across save/load'
    if back.scale != ad.scale or back.rank != ad.rank:
        return 'manifest fields changed across save/load'
    for key, arr in ad.arrays.items():
        if not onp.array_equal(back.arrays[key], arr):
            return 'array %s not bit-exact after roundtrip' % key
    # the params blob rewritten with one value nudged: the manifest's
    # digest is stale, so the load must refuse it, typed
    blob = os.path.join(path, 'params.npz')
    arrays = dict(back.arrays)
    key = sorted(arrays)[0]
    arrays[key] = arrays[key].copy()
    arrays[key].flat[0] += 1.0
    onp.savez(blob, **arrays)
    try:
        load_adapter(path)
        return 'tampered params.npz loaded without complaint'
    except ValueError:
        pass
    # the manifest tampered (scale 2.5 -> 9.5) on a fresh copy
    path2 = save_adapter(os.path.join(tmp, 'round2'), ad)
    man = os.path.join(path2, 'MANIFEST.json')
    with open(man) as f:
        doc = f.read()
    with open(man, 'w') as f:
        f.write(doc.replace('2.5', '9.5'))
    try:
        load_adapter(path2)
        return 'tampered manifest loaded without complaint'
    except ValueError:
        pass
    # a directory that is not an adapter artifact
    bogus = os.path.join(tmp, 'bogus')
    os.makedirs(bogus)
    with open(os.path.join(bogus, 'MANIFEST.json'), 'w') as f:
        json.dump({'schema': 'mxnet_tpu.frozen.v1'}, f)
    try:
        load_adapter(bogus)
        return 'non-adapter artifact loaded without complaint'
    except ValueError:
        pass
    return None


def check_pool(device):
    from ..batcher import BackpressureError
    from . import (AdapterExhaustedError, AdapterPool, AdapterSpec,
                   init_adapter)
    model, _ = _model()
    spec = AdapterSpec.for_model(model, rank=4, capacity=3)
    pool = AdapterPool(spec, device=device)
    st = pool.stats()
    if st['resident'] != 0 or st['capacity'] != 3:
        return 'fresh pool stats wrong: %r' % (st,)
    ads = [init_adapter(model, rank=4, seed=10 + i, name='p%d' % i)
           for i in range(3)]
    i0 = pool.load(ads[0])
    if i0 == 0:
        return 'user adapter landed on the reserved base row 0'
    if pool.load(ads[0]) != i0:
        return 'same digest loaded twice occupied two rows'
    if pool.stats()['resident'] != 1:
        return 'dedup did not dedup: %r' % (pool.stats(),)
    pool.release(i0)  # from the double load; still pinned once
    i1 = pool.load(ads[1])
    # the pool is full (base + 2 user rows); the pin on ads[0] dropped,
    # the next load must evict that row, not fail
    pool.release(i0)
    i2 = pool.load(ads[2])
    if i2 != i0:
        return 'LRU eviction did not reuse the unpinned row'
    if pool.index_of(ads[0].digest) is not None:
        return 'evicted adapter still resolvable by digest'
    # both user rows pinned: typed exhaustion
    try:
        pool.load(ads[0])
        return 'pinned-full pool accepted another adapter'
    except AdapterExhaustedError as exc:
        if not isinstance(exc, BackpressureError):
            return 'AdapterExhaustedError is not a BackpressureError'
    pool.release(i1)
    pool.release(i2)
    if pool.load(ads[0]) not in (i1, i2):
        return 'released rows not reused after unpin'
    return None


def check_zero_retrace(tmp, device):
    from ..decode.engine import DecodeEngine
    from ..decode.program import freeze_decode
    model, params = _model()
    n_adapters = 8
    root = os.path.join(tmp, 'fleet')
    _stamp_adapters(root, model, n_adapters)
    paged = freeze_decode(model, params, slots=4,
                          prefill_buckets=(16, 32), paged=True,
                          page_size=8, pages=96, spec_k=3,
                          sample_args=True, adapter_rank=4,
                          adapter_slots=n_adapters + 1, device=device)
    draft = _draft(device)
    with DecodeEngine(paged, draft=draft, adapters=root,
                      name='retrace') as eng:
        # warm-up: greedy, sampled and adapter-carrying streams
        list(eng.generate(PROMPT, max_new_tokens=6))
        list(eng.generate(PROMPT, max_new_tokens=6, temperature=0.7,
                          seed=1))
        list(eng.generate(PROMPT, max_new_tokens=6, adapter='ad0'))
        built = paged.compile_count
        draft_built = draft.compile_count
        for i in range(2 * n_adapters):
            list(eng.generate([2 + i, 9, 4, 8], max_new_tokens=8,
                              adapter='ad%d' % (i % n_adapters),
                              temperature=0.5 if i % 2 else 0.0,
                              seed=i))
        if paged.compile_count != built:
            return ('adapter/sampling rotation built target programs: '
                    '%d -> %d (%s)' % (built, paged.compile_count,
                                       sorted(paged.compile_seconds)))
        if draft.compile_count != draft_built:
            return 'adapter/sampling rotation built draft programs'
        st = eng.stats()
        if st['adapters']['resident'] != n_adapters:
            return ('%d adapters served but only %d resident'
                    % (n_adapters, st['adapters']['resident']))
    return None


def check_temp0_identity(tmp, device):
    from ..decode.engine import DecodeEngine
    from ..decode.program import freeze_decode
    model, params = _model()
    root = os.path.join(tmp, 'temp0')
    _stamp_adapters(root, model, 1)
    legacy = freeze_decode(model, params, slots=4,
                           prefill_buckets=(16, 32), paged=False,
                           sample_args=False, device=device)
    extras = freeze_decode(model, params, slots=4,
                           prefill_buckets=(16, 32), paged=False,
                           sample_args=True, adapter_rank=4,
                           adapter_slots=4, device=device)
    with DecodeEngine(legacy, name='t0-leg') as e1:
        ref = list(e1.generate(PROMPT, max_new_tokens=10))
    with DecodeEngine(extras, adapters=root, name='t0-ext') as e2:
        got = list(e2.generate(PROMPT, max_new_tokens=10))
        base = list(e2.generate(PROMPT, max_new_tokens=10,
                                adapter='base'))
    if got != ref:
        return ('temperature-0 extras stream differs from the legacy '
                'program: %r vs %r' % (got, ref))
    if base != ref:
        return 'adapter="base" is not bit-identical to no adapter'
    return None


def check_sampled_spec(tmp, device):
    from ..decode.engine import DecodeEngine
    from ..decode.program import freeze_decode
    model, params = _model()
    root = os.path.join(tmp, 'spec')
    _stamp_adapters(root, model, 2)
    paged = freeze_decode(model, params, slots=4,
                          prefill_buckets=(16, 32), paged=True,
                          page_size=8, pages=64, spec_k=3,
                          sample_args=True, adapter_rank=4,
                          adapter_slots=4, device=device)
    draft = _draft(device)
    with DecodeEngine(paged, draft=draft, adapters=root,
                      name='spec') as spec_eng, \
            DecodeEngine(paged, adapters=root, name='plain') as plain_eng:
        for i in range(4):
            kw = dict(max_new_tokens=12, temperature=0.9, top_p=0.85,
                      seed=77 + i)
            if i % 2:
                kw['adapter'] = 'ad%d' % (i % 2)
            a = list(spec_eng.generate([5, 6, 7], **kw))
            b = list(plain_eng.generate([5, 6, 7], **kw))
            if a != b:
                return ('seed %d: speculative %r != plain %r'
                        % (77 + i, a, b))
        st = spec_eng.stats()
        if not st['spec'].get('accepted'):
            return 'speculative path never accepted a draft token'
    return None


def check_prefix_isolation(tmp, device):
    from ..decode.engine import DecodeEngine
    from ..decode.paged import PageAllocator, PrefixCache
    from ..decode.program import freeze_decode
    # unit level: chains registered under one namespace are invisible to
    # every other namespace
    alloc = PageAllocator(pages=16)
    cache = PrefixCache(page_size=4, allocator=alloc)
    cache.register(list(range(12)), alloc.alloc(3), namespace='ad0')
    _, covered = cache.lookup(list(range(12)), namespace='ad1')
    if covered:
        return 'namespace ad1 saw %d tokens of an ad0 chain' % covered
    _, covered = cache.lookup(list(range(12)), namespace='ad0')
    if covered != 12:
        return 'owning namespace lost its own chain'
    _, covered = cache.lookup(list(range(12)))
    if covered:
        return 'null namespace saw a namespaced chain'
    # engine level: one prompt under two adapters gives each adapter's
    # own stream, and base traffic after adapter traffic still matches a
    # cold base engine (no KV bleeds through the cache)
    model, params = _model()
    root = os.path.join(tmp, 'iso')
    _stamp_adapters(root, model, 2)
    # long enough to span whole pages, so the cache has chains to hit
    prompt = [(3 * i + 1) % VOCAB for i in range(20)]
    paged = freeze_decode(model, params, slots=4,
                          prefill_buckets=(16, 32), paged=True,
                          page_size=8, pages=64, sample_args=True,
                          adapter_rank=4, adapter_slots=4, device=device)
    with DecodeEngine(paged, adapters=root, name='iso-cold') as cold:
        want_base = list(cold.generate(prompt, max_new_tokens=8))
    with DecodeEngine(paged, adapters=root, name='iso') as eng:
        a0 = list(eng.generate(prompt, max_new_tokens=8, adapter='ad0'))
        a0_again = list(eng.generate(prompt, max_new_tokens=8,
                                     adapter='ad0'))
        a1 = list(eng.generate(prompt, max_new_tokens=8, adapter='ad1'))
        base = list(eng.generate(prompt, max_new_tokens=8))
        st = eng.stats()
    if a0 != a0_again:
        return 'same adapter, same prompt: streams differ'
    if a0 == a1:
        return 'two different adapters produced the same stream'
    if base != want_base:
        return ('base stream after adapter traffic differs from a cold '
                'engine: %r vs %r' % (base, want_base))
    if not st['counts'].get('prefix_tokens_saved'):
        return 'prefix cache never hit inside one namespace'
    return None


def run_legs(tmp, device):
    """The six legs in order: {leg: 'ok' | problem}, a line each."""
    legs = [('artifact', lambda: check_artifact(tmp)),
            ('pool', lambda: check_pool(device)),
            ('zero_retrace', lambda: check_zero_retrace(tmp, device)),
            ('temp0_identity', lambda: check_temp0_identity(tmp, device)),
            ('sampled_spec', lambda: check_sampled_spec(tmp, device)),
            ('prefix_isolation',
             lambda: check_prefix_isolation(tmp, device))]
    checks = {}
    for name, fn in legs:
        try:
            problem = fn()
        except Exception as exc:
            import traceback
            traceback.print_exc()
            problem = '%s: %s' % (type(exc).__name__, exc)
        checks[name] = problem or 'ok'
        print('adapters selftest %-16s %s' % (name, checks[name]),
              flush=True)
    return checks


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m mxnet_tpu_torch.serving.adapters',
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--out', default='ADAPTERS_SELFTEST.json')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                   help='where the programs run')
    args = p.parse_args(argv)
    from ...context import resolve_device
    device = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        checks = run_legs(tmp, device)
    ok = all(v == 'ok' for v in checks.values())
    verdict = {'ok': ok, 'checks': checks}
    from ...resilience.checkpoint import atomic_write_bytes
    atomic_write_bytes(args.out, (json.dumps(
        verdict, indent=1, sort_keys=True) + '\n').encode())
    print('adapters selftest: %s -> %s' % ('OK' if ok else 'FAIL', args.out),
          flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
