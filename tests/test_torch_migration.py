"""Port parity of live decode migration: ``DecodeEngine.export_sequence``
/ ``export_all`` / ``import_sequence`` and ``generate(request_id=,
prefill_only=)`` of ``mxnet_tpu_torch`` against the JAX package's
(``tests/test_migration.py``, without its gateway-journal tests).

The model is the reference test's (vocab 23, units 16, hidden 32, one
layer, two heads, max_len 64), its weights from a numpy seed, both
packages on the CPU (the port's kernels through their plain versions).
Tolerance: greedy tokens equal, token for token; sampled tokens equal at
the same seed in the same package. A spliced stream (the source's emitted
tokens and the destination's continuation) equals the stream of an engine
that never migrated it, and the destination runs no prefill for a live
payload. Across packages a payload exported by one engine continues in
the other, and both give the JAX package's unmigrated tokens.
"""
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu.serving.decode import DecodeEngine as JaxEngine
from mxnet_tpu.serving.decode import PagedDecodeProgram as JaxPaged
from mxnet_tpu.serving.decode import init_transformer_lm as jax_init_lm
from mxnet_tpu_torch.resilience.policy import (CircuitBreaker,
                                               CircuitOpenError)
from mxnet_tpu_torch.serving import BackpressureError, BatcherClosed
from mxnet_tpu_torch.serving.adapters import (AdapterPool, AdapterRegistry,
                                              AdapterSpec, init_adapter)
from mxnet_tpu_torch.serving.decode import (SEQSTATE_SCHEMA, DecodeEngine,
                                            DecodeProgram, DrainTimeout,
                                            PagedDecodeProgram, SeqStateError,
                                            init_transformer_lm)

torch.set_num_threads(1)

CFG = dict(vocab=23, units=16, hidden=32, layers=1, heads=2)
PROMPT = [3, 5, 7, 11, 2, 9, 4, 6, 8, 10]
WAIT = 60


def _model(max_len=64, seed=0):
    return init_transformer_lm(**dict(CFG, max_len=max_len, seed=seed))


def _paged(model, params, page_size, pages, **kw):
    kw.setdefault('slots', 2)
    kw.setdefault('prefill_buckets', (8, 16))
    return PagedDecodeProgram(model, params, page_size=page_size, pages=pages,
                              device='cpu', **kw)


def _slot(model, params, **kw):
    kw.setdefault('slots', 2)
    kw.setdefault('prefill_buckets', (8, 16))
    return DecodeProgram(model, params, device='cpu', **kw)


def _reference(prog, prompt, n, **kw):
    eng = DecodeEngine(prog, timeout_s=WAIT)
    try:
        return eng.generate(prompt, max_new_tokens=n, **kw).result(WAIT)
    finally:
        eng.close()


def _export_after_first_token(eng, prompt, n, **kw):
    """Admit, wait for the stream to go live (a token), export."""
    s = eng.generate(prompt, max_new_tokens=n, **kw)
    next(iter(s))
    payload = eng.export_sequence(s, timeout=30)
    assert s.finish_reason == 'migrated' and s.exception() is None
    return s, payload


def _continue_on(dst, payload):
    """Import and splice: the handed-off prefix and the new tokens."""
    return list(payload['emitted']) + list(dst.import_sequence(payload,
                                                               timeout=30))


def _storage(prog):
    return {k: t.data_ptr() for k, t in prog._cache.items()}


# -- round trips ---------------------------------------------------------------


@pytest.mark.parametrize('src_ps,dst_ps',
                         [(8, 8), (8, 16), (16, 128), (128, 8)])
def test_roundtrip_bit_identical_across_page_sizes(src_ps, dst_ps):
    """The rows re-chunk to the destination's pages; the spliced stream
    equals the unmigrated one, the destination runs no prefill, and
    neither pool is replaced."""
    model, params = _model()
    pages = {8: 32, 16: 16, 128: 2}
    n = 20
    want = _reference(_paged(model, params, src_ps, pages[src_ps]), PROMPT, n)
    sprog = _paged(model, params, src_ps, pages[src_ps])
    dprog = _paged(model, params, dst_ps, pages[dst_ps])
    src = DecodeEngine(sprog, timeout_s=WAIT)
    dst = DecodeEngine(dprog, timeout_s=WAIT)
    held = (_storage(sprog), _storage(dprog))
    try:
        _s, payload = _export_after_first_token(src, PROMPT, n)
        assert payload['schema'] == SEQSTATE_SCHEMA
        assert payload['kind'] == 'paged'
        assert payload['page_size'] == src_ps
        got = _continue_on(dst, payload)
        assert got == want
        sc, dc = src.stats()['counts'], dst.stats()['counts']
        assert dc['prefills'] == 0
        assert sc['migrated_out'] == 1 and dc['migrated_in'] == 1
        assert sc['handoff_pages'] == -(-payload['pos'] // src_ps)
        assert dc['handoff_pages'] == -(-payload['pos'] // dst_ps)
        assert (_storage(sprog), _storage(dprog)) == held
    finally:
        src.close()
        dst.close()


def test_export_midstream_with_churn_leaves_neighbors_intact():
    model, params = _model()
    n = 16
    other = [1, 2, 3, 4]
    want_mig = _reference(_paged(model, params, 8, 32), PROMPT, n)
    want_other = _reference(_paged(model, params, 8, 32), other, n)
    src = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    dst = DecodeEngine(_paged(model, params, 16, 16), timeout_s=WAIT)
    try:
        neighbor = src.generate(other, max_new_tokens=n)
        _s, payload = _export_after_first_token(src, PROMPT, n)
        assert _continue_on(dst, payload) == want_mig
        assert neighbor.result(WAIT) == want_other
        assert dst.stats()['counts']['prefills'] == 0
    finally:
        src.close()
        dst.close()


def test_queued_sequence_exports_cold_and_readmits():
    """A queued sequence exports ``cold`` and lands through the
    destination's ordinary admission (one prefill)."""
    model, params = _model()
    n = 8
    want = _reference(_paged(model, params, 8, 32), PROMPT, n)
    src = DecodeEngine(_paged(model, params, 8, 32, slots=1), timeout_s=WAIT)
    dst = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    try:
        hog = src.generate([2, 4, 6], max_new_tokens=32)
        queued = src.generate(PROMPT, max_new_tokens=n)
        payload = src.export_sequence(queued, timeout=30)
        assert payload['kind'] == 'cold' and payload['emitted'] == []
        assert queued.finish_reason == 'migrated'
        assert dst.import_sequence(payload, timeout=30).result(WAIT) == want
        dc = dst.stats()['counts']
        assert dc['prefills'] == 1 and dc['migrated_in'] == 0
        hog.cancel()
    finally:
        src.close()
        dst.close()


def test_prefix_hit_sequence_migrates_bit_identical():
    model, params = _model()
    base = [7, 2, 9, 4, 1, 3, 5, 8, 6, 2]
    n = 8
    want = _reference(_paged(model, params, 8, 32), base, n)
    src = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    dst = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    try:
        assert src.generate(base, max_new_tokens=n).result(WAIT) == want
        _s, payload = _export_after_first_token(src, base, n)
        assert _continue_on(dst, payload) == want
        assert src.stats()['counts']['prefix_hits'] >= 1
        assert dst.stats()['counts']['prefills'] == 0
    finally:
        src.close()
        dst.close()


def test_spec_decode_source_migrates_to_plain_engine():
    model, params = _model()
    n = 12
    want = _reference(_paged(model, params, 8, 32), PROMPT, n)
    src = DecodeEngine(_paged(model, params, 8, 32, spec_k=2),
                       draft=_slot(model, params), timeout_s=WAIT)
    dst = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    try:
        _s, payload = _export_after_first_token(src, PROMPT, n)
        assert payload['kind'] == 'paged'
        assert _continue_on(dst, payload) == want
        assert dst.stats()['counts']['prefills'] == 0
    finally:
        src.close()
        dst.close()


def test_plain_source_migrates_into_speculative_engine():
    """The destination's draft is re-synced by its prefill: the
    continuation is the target's greedy stream and the draft still
    proposes (its acceptance is counted)."""
    model, params = _model()
    n = 16
    want = _reference(_paged(model, params, 8, 32), PROMPT, n)
    src = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    dst = DecodeEngine(_paged(model, params, 16, 16, spec_k=2),
                       draft=_slot(model, params), timeout_s=WAIT)
    try:
        _s, payload = _export_after_first_token(src, PROMPT, n)
        assert _continue_on(dst, payload) == want
        st = dst.stats()
        assert st['counts']['prefills'] == 0
        assert st['spec']['accepted'] > 0
    finally:
        src.close()
        dst.close()


def test_slot_state_exports_and_splices():
    """A slot-cache engine hands off its slot's rows (``slot`` kind) and
    the continuation is bit-identical; the slot cache is written in
    place."""
    model, params = _model()
    n = 14
    want = _reference(_slot(model, params), PROMPT, n)
    dprog = _slot(model, params)
    src = DecodeEngine(_slot(model, params), timeout_s=WAIT)
    dst = DecodeEngine(dprog, timeout_s=WAIT)
    held = _storage(dprog)
    try:
        _s, payload = _export_after_first_token(src, PROMPT, n)
        assert payload['kind'] == 'slot'
        assert sorted(payload['entries']) == ['l0_k', 'l0_v']
        assert payload['entries']['l0_k']['shape'] == [64, 16]
        assert _continue_on(dst, payload) == want
        assert dst.stats()['counts']['prefills'] == 0
        assert src.stats()['counts']['migrated_out'] == 1
        assert dst.stats()['counts']['migrated_in'] == 1
        assert _storage(dprog) == held
    finally:
        src.close()
        dst.close()


def test_export_all_drains_queued_and_live_at_one_boundary():
    """``export_all``: the queued sequence ``cold``, the live ones
    ``paged``; every stream finishes ``migrated`` and every payload
    continues to its unmigrated stream."""
    model, params = _model()
    n = 12
    prompts = [PROMPT, [1, 2, 3, 4], [5, 6, 7]]
    wants = [_reference(_paged(model, params, 8, 32), p, n) for p in prompts]
    src = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    dst = DecodeEngine(_paged(model, params, 16, 16, slots=3),
                       timeout_s=WAIT)
    try:
        streams = [src.generate(p, max_new_tokens=n, request_id='r%d' % i)
                   for i, p in enumerate(prompts)]
        for s in streams[:2]:
            next(iter(s))
        payloads = src.export_all(timeout=30)
        assert sorted(p['kind'] for p in payloads) == ['cold', 'paged',
                                                       'paged']
        assert all(s.finish_reason == 'migrated' for s in streams)
        assert src.stats()['counts']['migrated_out'] == 3
        by_rid = {p['request_id']: p for p in payloads}
        live = [by_rid[r] for r in ('r0', 'r1')]
        for i, p in enumerate(live):
            assert _continue_on(dst, p) == wants[i]
        assert dst.import_sequence(by_rid['r2']).result(WAIT) == wants[2]
        dc = dst.stats()['counts']
        assert dc['prefills'] == 1 and dc['migrated_in'] == 2
    finally:
        src.close()
        dst.close()


# -- sampling and adapters -----------------------------------------------------


def test_sampled_and_adapter_payloads_continue_exactly():
    """A sampled stream under an adapter exports its sampling block and
    adapter id; an engine with the same registry continues it to the
    unmigrated stream (keys from (seed, position)); an engine without an
    adapter pool or without sampling args refuses the payload typed."""
    model, params = _model()
    ad = init_adapter(model, 4, seed=3, scale=5.0)

    def prog(page_size, pages, rank=4):
        return _paged(model, params, page_size, pages, sample_args=True,
                      adapter_spec=AdapterSpec.for_model(model, rank, 3)) \
            if rank else _paged(model, params, page_size, pages,
                                sample_args=False)

    def engine(p):
        reg = AdapterRegistry(AdapterPool(p.adapter_spec, device='cpu'))
        reg.register('A', ad)
        return DecodeEngine(p, adapters=reg, timeout_s=WAIT)

    law = dict(adapter='A', temperature=0.9, top_p=0.8, seed=11)
    n = 16
    ref = engine(prog(8, 32))
    try:
        want = ref.generate(PROMPT, max_new_tokens=n, **law).result(WAIT)
    finally:
        ref.close()
    src, dst = engine(prog(8, 32)), engine(prog(16, 16))
    bare = DecodeEngine(prog(8, 32, rank=0), timeout_s=WAIT)
    try:
        _s, payload = _export_after_first_token(src, PROMPT, n, **law)
        assert payload['adapter_id'] == 'A'
        assert payload['sampling'] == {'temperature': 0.9,
                                       'top_p': pytest.approx(0.8),
                                       'seed': 11}
        with pytest.raises(SeqStateError, match='adapter'):
            bare.import_sequence(payload)
        no_ad = dict(payload)
        del no_ad['adapter_id']
        from mxnet_tpu_torch.serving.decode.seqstate import _digest
        no_ad['digest'] = _digest(no_ad)
        with pytest.raises(SeqStateError, match='sampling'):
            bare.import_sequence(no_ad)
        assert bare.stats()['free_slots'] == 2
        assert _continue_on(dst, payload) == want
        assert dst.stats()['counts']['prefills'] == 0
        assert dst.stats()['counts']['sampled_tokens'] > 0
    finally:
        src.close()
        dst.close()
        bare.close()


# -- request_id and prefill_only -----------------------------------------------


def test_request_id_admission_is_at_most_once():
    """A second admission under the same request id cancels the older
    stream; other ids are untouched."""
    model, params = _model()
    prog = _paged(model, params, 8, 32)
    release = threading.Event()
    step = prog.run_step

    def slow(*a, **kw):
        release.wait(0.05)
        return step(*a, **kw)

    prog.run_step = slow
    eng = DecodeEngine(prog, timeout_s=WAIT)
    try:
        first = eng.generate(PROMPT, max_new_tokens=40, request_id='rid')
        other = eng.generate([1, 2, 3], max_new_tokens=4, request_id='x')
        next(iter(first))
        second = eng.generate(PROMPT, max_new_tokens=6, request_id='rid')
        release.set()
        assert len(second.result(WAIT)) == 6
        first._done.wait(WAIT)
        assert first.finish_reason == 'cancelled'
        assert len(other.result(WAIT)) == 4
    finally:
        release.set()
        eng.close()


def test_prefill_only_exports_at_boundary_bit_identical():
    model, params = _model()
    n = 16
    want = _reference(_paged(model, params, 8, 32), PROMPT, n)
    src = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    dst = DecodeEngine(_paged(model, params, 16, 16), timeout_s=WAIT)
    try:
        s = src.generate(PROMPT, max_new_tokens=n, prefill_only=True)
        assert list(s) == want[:1]
        assert s.finish_reason == 'migrated'
        payload = s.seqstate
        assert payload is s.seqstate            # built once
        assert payload['schema'] == SEQSTATE_SCHEMA
        assert payload['kind'] == 'paged'
        assert payload['emitted'] == want[:1]
        assert set(s.export_seconds) == {'gather_s', 'build_s'}
        assert _continue_on(dst, payload) == want
        sc, dc = src.stats()['counts'], dst.stats()['counts']
        assert sc['prefill_exports'] == 1 and sc['migrated_out'] == 1
        assert dc['prefills'] == 0 and dc['migrated_in'] == 1
    finally:
        src.close()
        dst.close()


def test_prefill_only_max_new_one_finishes_locally():
    model, params = _model()
    want = _reference(_paged(model, params, 8, 32), PROMPT, 1)
    eng = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    try:
        s = eng.generate(PROMPT, max_new_tokens=1, prefill_only=True)
        assert list(s) == want
        assert s.finish_reason == 'length'
        assert s.seqstate is None
        assert eng.stats()['counts']['prefill_exports'] == 0
    finally:
        eng.close()


def test_prefill_only_prefix_hit_exports_extending_state():
    """A prefix hit exports before any token: ``emitted`` is empty,
    ``pos`` the covered rows, and the importer steps the suffix itself."""
    model, params = _model()
    base = [7, 2, 9, 4, 1, 3, 5, 8, 6, 2]
    n = 10
    want = _reference(_paged(model, params, 8, 32), base, n)
    src = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    dst = DecodeEngine(_paged(model, params, 16, 16), timeout_s=WAIT)
    try:
        assert src.generate(base, max_new_tokens=n).result(WAIT) == want
        s = src.generate(base, max_new_tokens=n, prefill_only=True)
        assert list(s) == []
        assert s.finish_reason == 'migrated'
        payload = s.seqstate
        assert payload['emitted'] == [] and payload['pos'] == 8
        assert payload['last_token'] == base[8]
        assert _continue_on(dst, payload) == want
        assert src.stats()['counts']['prefix_hits'] >= 1
        assert src.stats()['counts']['prefill_exports'] == 1
        assert dst.stats()['counts']['prefills'] == 0
    finally:
        src.close()
        dst.close()


# -- typed refusals and pressure -----------------------------------------------


def test_torn_and_mismatched_payloads_rejected_typed():
    model, params = _model()
    src = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    slot_src = DecodeEngine(_slot(model, params), timeout_s=WAIT)
    small = DecodeEngine(_paged(*_model(max_len=10), 8, 8, slots=1,
                                prefill_buckets=(8,)), timeout_s=WAIT)
    try:
        _s, payload = _export_after_first_token(src, PROMPT, 8)
        with pytest.raises(SeqStateError):
            src.import_sequence(dict(payload, pos=payload['pos'] + 1))
        with pytest.raises(SeqStateError):
            src.import_sequence(dict(payload,
                                     schema='mxnet_tpu.seqstate.v2'))
        with pytest.raises(SeqStateError):
            src.import_sequence({k: v for k, v in payload.items()
                                 if k != 'emitted'})
        # the cache family, both ways
        with pytest.raises(SeqStateError, match='slot-cache'):
            slot_src.import_sequence(payload)
        _s2, slot_payload = _export_after_first_token(slot_src, PROMPT, 8)
        with pytest.raises(SeqStateError, match='paged engine'):
            src.import_sequence(slot_payload)
        # past max_len
        with pytest.raises(SeqStateError, match='max_len'):
            small.import_sequence(payload)
        for eng in (src, slot_src, small):
            assert eng.stats()['active'] == 0
    finally:
        src.close()
        slot_src.close()
        small.close()


def test_import_refused_typed_under_pool_pressure_then_retries():
    model, params = _model(max_len=128)
    n = 8
    long_prompt = [1 + (i % 21) for i in range(30)]

    def prog():
        return _paged(model, params, 8, 9, prefill_buckets=(32, 64))

    want = _reference(prog(), long_prompt, n)
    src = DecodeEngine(prog(), timeout_s=WAIT)
    dst = DecodeEngine(prog(), timeout_s=WAIT)
    try:
        # pos 31 at the boundary: the import needs 4 of the 8 usable pages
        _s, payload = _export_after_first_token(src, long_prompt, n)
        # the hog pins 5 pages for its whole 20-token decode
        hog = dst.generate([2 + (i % 19) for i in range(38)],
                           max_new_tokens=20)
        next(iter(hog))
        before = dst.stats()
        assert before['pages']['pages_free'] <= 3
        with pytest.raises(BackpressureError):
            dst.import_sequence(payload, timeout=20)
        after = dst.stats()
        assert after['counts']['migrated_in'] == 0
        assert after['counts']['pool_exhausted'] >= 1
        assert after['free_slots'] == 1
        assert after['pages']['pages_free'] <= before['pages']['pages_free']
        hog.cancel()
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if dst.stats()['free_slots'] == 2:
                break
            time.sleep(0.02)
        pre = dst.stats()['counts']['prefills']
        assert _continue_on(dst, payload) == want
        post = dst.stats()['counts']
        assert post['migrated_in'] == 1 and post['prefills'] == pre
    finally:
        src.close()
        dst.close()


def test_import_into_a_lost_cache_with_the_breaker_open_refused_typed():
    """After a failed cache rebuild an import builds the cache through
    ``_ensure_cache``; with the breaker open it fails typed and gives its
    slot back."""
    model, params = _model()
    src = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    breaker = CircuitBreaker(failure_threshold=1, reset_timeout=600.0)
    dst = DecodeEngine(_paged(model, params, 8, 32), breaker=breaker,
                       timeout_s=WAIT)
    try:
        _s, payload = _export_after_first_token(src, PROMPT, 8)
        dst._cache, dst._cache_lost = None, True
        breaker.record_failure()
        assert breaker.state == 'open'
        with pytest.raises(CircuitOpenError, match='lost its cache'):
            dst.import_sequence(payload)
        assert dst.stats()['free_slots'] == 2
        assert dst.stats()['counts']['migrated_in'] == 0
    finally:
        src.close()
        dst.close()


def test_export_of_a_finished_or_unknown_stream_refused_typed():
    model, params = _model()
    eng = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    try:
        s = eng.generate(PROMPT, max_new_tokens=3)
        s.result(WAIT)
        with pytest.raises(SeqStateError):
            eng.export_sequence(s)
        assert eng.export_all() == []
    finally:
        eng.close()
    with pytest.raises(BatcherClosed):
        eng.export_sequence(s)


# -- the bounded drain and closing ---------------------------------------------


def test_close_drain_timeout_fails_wedged_stream_typed():
    model, params = _model()
    prog = _slot(model, params)
    eng = DecodeEngine(prog, timeout_s=WAIT)
    release = threading.Event()
    stepped = threading.Event()
    orig_step = prog.run_step

    def wedged(*a, **kw):
        stepped.set()
        release.wait(20.0)
        return orig_step(*a, **kw)

    prog.run_step = wedged
    try:
        s = eng.generate(PROMPT, max_new_tokens=8)
        assert stepped.wait(20.0)
        t0 = time.monotonic()
        eng.close(drain=True, timeout=0.3)
        assert time.monotonic() - t0 < 10.0
        release.set()
        with pytest.raises(DrainTimeout):
            s.result(5)
        assert s.finish_reason == 'error'
        assert eng.stats()['counts']['drain_timeouts'] == 1
    finally:
        release.set()
        eng.close()


def test_close_fails_the_migrations_it_orphans():
    """An import queued behind a wedged step is never serviced: close
    fails it with BatcherClosed instead of leaving its caller waiting."""
    model, params = _model()
    src = DecodeEngine(_paged(model, params, 8, 32), timeout_s=WAIT)
    prog = _paged(model, params, 8, 32)
    dst = DecodeEngine(prog, timeout_s=WAIT)
    release = threading.Event()
    stepped = threading.Event()
    orig_step = prog.run_step

    def wedged(*a, **kw):
        stepped.set()
        release.wait(20.0)
        return orig_step(*a, **kw)

    try:
        _s, payload = _export_after_first_token(src, PROMPT, 8)
        prog.run_step = wedged
        dst.generate([1, 2, 3], max_new_tokens=4)
        assert stepped.wait(20.0)
        box = {}

        def land():
            try:
                dst.import_sequence(payload, timeout=30)
            except Exception as exc:  # noqa: BLE001 - the type is checked
                box['exc'] = exc

        t = threading.Thread(target=land)
        t.start()
        time.sleep(0.1)
        dst.close(drain=True, timeout=0.3)
        t.join(10)
        assert isinstance(box.get('exc'), BatcherClosed)
    finally:
        release.set()
        src.close()
        dst.close()


# -- across packages ------------------------------------------------------------


@pytest.fixture(scope='module')
def jax_weights():
    jmodel, np_params = jax_init_lm(vocab=CFG['vocab'], units=CFG['units'],
                                    hidden=CFG['hidden'],
                                    layers=CFG['layers'], heads=CFG['heads'],
                                    max_len=64, seed=0)
    pmodel, _ = _model()
    return jmodel, pmodel, {k: np.asarray(v) for k, v in np_params.items()}


def _jax_paged(jmodel, np_params, page_size, pages):
    return JaxPaged(jmodel, np_params, slots=2, prefill_buckets=(8, 16),
                    page_size=page_size, pages=pages)


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
@pytest.mark.parametrize('mode', ['midstream', 'prefill_only'])
def test_payload_continues_across_packages(jax_weights, direction, mode):
    """A payload one package's engine exports continues in the other's,
    across page sizes (8 to 16); the spliced stream is the JAX package's
    unmigrated greedy stream, and the destination runs no prefill."""
    jmodel, pmodel, np_params = jax_weights
    n = 14
    ref = JaxEngine(_jax_paged(jmodel, np_params, 8, 32), timeout_s=WAIT)
    try:
        want = ref.generate(PROMPT, max_new_tokens=n).result(WAIT)
    finally:
        ref.close()
    port_src = direction == 'port_to_jax'
    src = DecodeEngine(_paged(pmodel, np_params, 8, 32), timeout_s=WAIT) \
        if port_src else JaxEngine(_jax_paged(jmodel, np_params, 8, 32),
                                   timeout_s=WAIT)
    dst = JaxEngine(_jax_paged(jmodel, np_params, 16, 16), timeout_s=WAIT) \
        if port_src else DecodeEngine(_paged(pmodel, np_params, 16, 16),
                                      timeout_s=WAIT)
    try:
        if mode == 'prefill_only':
            s = src.generate(PROMPT, max_new_tokens=n, prefill_only=True,
                             request_id='x')
            assert list(s) == want[:1] and s.finish_reason == 'migrated'
            payload = s.seqstate
        else:
            _s, payload = _export_after_first_token(src, PROMPT, n)
        assert payload['kind'] == 'paged'
        got = list(payload['emitted']) + list(
            dst.import_sequence(payload, timeout=30))
        assert got == want
        assert dst.stats()['counts']['prefills'] == 0
        assert dst.stats()['counts']['migrated_in'] == 1
    finally:
        src.close()
        dst.close()


def test_cold_and_sampled_payloads_continue_across_packages(jax_weights):
    """A cold payload, and a sampled one, exported by the JAX engine
    continue in the port's as the port's own unmigrated streams (sampling
    is held within one package)."""
    jmodel, pmodel, np_params = jax_weights
    n = 10
    law = dict(temperature=0.7, top_p=0.9, seed=5)
    want_greedy = _reference(_paged(pmodel, np_params, 8, 32), PROMPT, n)
    want_sampled = _reference(_paged(pmodel, np_params, 8, 32), PROMPT, n,
                              **law)
    src = JaxEngine(_jax_paged(jmodel, np_params, 8, 32), timeout_s=WAIT)
    dst = DecodeEngine(_paged(pmodel, np_params, 16, 16), timeout_s=WAIT)
    try:
        _s, sampled = _export_after_first_token(src, PROMPT, n, **law)
        assert sampled['sampling']['seed'] == 5
        hog = src.generate([1, 2], max_new_tokens=40)
        busy = src.generate([3, 4], max_new_tokens=40)
        queued = src.generate(PROMPT, max_new_tokens=n)
        cold = src.export_sequence(queued, timeout=30)
        hog.cancel()
        busy.cancel()
        assert cold['kind'] == 'cold'
        assert dst.import_sequence(cold).result(WAIT) == want_greedy
        got = list(sampled['emitted']) + list(dst.import_sequence(sampled))
        assert got == want_sampled
    finally:
        src.close()
        dst.close()


def test_import_counts_are_the_references(jax_weights):
    """ROADMAP C5: one ``cold`` and two ``paged`` payloads of the JAX
    engine's ``export_all`` go into a JAX engine and a port engine; the
    two destinations count alike: a live import counts in
    ``migrated_in`` and ``handoff_pages``, a cold one is an ordinary
    admission (a request and a prefill, no ``migrated_in``)."""
    jmodel, pmodel, np_params = jax_weights
    n = 8
    src = JaxEngine(_jax_paged(jmodel, np_params, 8, 32), timeout_s=WAIT)
    try:
        streams = [src.generate(p, max_new_tokens=n, request_id='r%d' % i)
                   for i, p in enumerate((PROMPT, [1, 2, 3, 4], [5, 6, 7]))]
        for s in streams[:2]:
            next(iter(s))
        payloads = src.export_all(timeout=30)
    finally:
        src.close()
    assert sorted(p['kind'] for p in payloads) == ['cold', 'paged', 'paged']
    dsts = {'jax': JaxEngine(_jax_paged(jmodel, np_params, 16, 16),
                             timeout_s=WAIT),
            'port': DecodeEngine(_paged(pmodel, np_params, 16, 16),
                                 timeout_s=WAIT)}
    counts, outs = {}, {}
    try:
        for name, eng in dsts.items():
            outs[name] = [eng.import_sequence(p, timeout=30).result(WAIT)
                          for p in payloads]
            c = eng.stats()['counts']
            counts[name] = {k: c[k] for k in ('migrated_in', 'requests',
                                              'prefills', 'handoff_pages')}
    finally:
        for eng in dsts.values():
            eng.close()
    assert counts['port'] == counts['jax']
    assert counts['port']['migrated_in'] == 2
    assert counts['port']['prefills'] == 1
    assert outs['port'] == outs['jax']
