"""Port parity of the visible degraded path: ``DecodeProgram.fallback_generate``,
the decode engine's breaker contract (``_device``: degrade, abort or fail
loudly) and the one-shot session's ``run_fallback`` / ``status()``,
against the JAX package's, on the CPU.

A small causal LM (vocab 23, units 16, 2 layers, 4 heads, max_len 48)
and its adapters come from numpy seeds in both packages. What is held:
the CPU fallback's tokens equal the JAX package's ``fallback_generate``
and the port's own program, greedy, sampled and adapted, slot and paged;
under the same ``MXNET_TPU_FAULT`` spec the port's engine gives the JAX
engine's tokens, ``degraded`` flags, error classes and retired counts
(slot, paged, speculative; greedy, sampled and adapter streams), each
engine's first tick held until every request is queued, so both number
their device calls alike; worker crashes and preemptions abort typed and
the breaker's half-open probe recovers (a fake clock); a kernel's launch
failure and any other bug-shaped error fail loudly, never degraded; the
one-shot session degrades to ``run_fallback``, reads ``degraded`` then
``ok``, and fails a crashed batch typed, as the JAX session does.
"""
import os
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (the JAX package's config registry)
from mxnet_tpu import nd as jax_nd
from mxnet_tpu import serving as jax_serving
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.resilience import policy as jax_policy
from mxnet_tpu.serving import adapters as jax_adapters
from mxnet_tpu.serving.decode import engine as jax_engine
from mxnet_tpu.serving.decode.model import \
    init_transformer_lm as jax_init_lm
from mxnet_tpu.serving.decode.program import \
    freeze_decode as jax_freeze_decode
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops.kernels.errors import KernelLaunchFailure
from mxnet_tpu_torch.resilience import policy as port_policy
from mxnet_tpu_torch.serving import adapters
from mxnet_tpu_torch.serving.decode import (DecodeEngine, freeze_decode,
                                            init_transformer_lm)

torch.set_num_threads(1)

CFG = dict(vocab=23, units=16, hidden=24, layers=2, heads=4, max_len=48)
BUCKETS = (4, 16)
RANK = 4
TEMP, TOP_P = 0.8, 0.9
WAIT = 120


@pytest.fixture(scope='module')
def models():
    jmodel, np_params = jax_init_lm(**CFG)
    pmodel, _ = init_transformer_lm(**CFG)
    return jmodel, pmodel, np_params


def _arm(monkeypatch, spec):
    """Script ``spec`` for both packages, each with a fresh injector (an
    unchanged value would keep an earlier case's spent counts)."""
    monkeypatch.setenv('MXNET_TPU_FAULT', '')
    jax_policy.get_injector()
    port_policy.get_injector()
    if spec:
        monkeypatch.setenv('MXNET_TPU_FAULT', spec)


def _adapter(pkg, model, seed):
    return pkg.init_adapter(model, rank=RANK, seed=seed, scale=50.0,
                            name='ad%d' % seed)


def _registry(pkg, prog, model):
    reg = pkg.AdapterRegistry(pkg.AdapterPool(prog.adapter_spec))
    for seed in (30, 31):
        reg.register('ad%d' % seed, _adapter(pkg, model, seed))
    return reg


def _programs(models, paged, spec_k=0, adapters_on=False):
    """(JAX program, its draft or None, port program, its draft or None)
    at the same configuration."""
    jmodel, pmodel, np_params = models
    args = dict(slots=4, prefill_buckets=BUCKETS, paged=paged)
    if paged:
        args.update(page_size=8, spec_k=spec_k)
    if adapters_on:
        args.update(adapter_rank=RANK, adapter_slots=3)
    jprog = jax_freeze_decode(jmodel, np_params, **args)
    pprog = freeze_decode(pmodel, np_params, device='cpu', **args)
    jdraft = pdraft = None
    if spec_k:
        dargs = dict(slots=4, prefill_buckets=BUCKETS, paged=False)
        jdraft = jax_freeze_decode(jmodel, np_params, **dargs)
        pdraft = freeze_decode(pmodel, np_params, device='cpu', **dargs)
    return jprog, jdraft, pprog, pdraft


# -- the CPU fallback --------------------------------------------------------

KINDS = {'greedy': (None, 0.0), 'sampled': (None, TEMP),
         'adapter': ('ad30', 0.0), 'adapter sampled': ('ad31', TEMP)}


@pytest.mark.parametrize('kind', sorted(KINDS))
@pytest.mark.parametrize('paged', [False, True], ids=['slot', 'paged'])
def test_fallback_generate_equals_jax_and_the_port_program(models, paged,
                                                           kind):
    jmodel, pmodel, np_params = models
    aid, temp = KINDS[kind]
    jprog, _, pprog, _ = _programs(models, paged, adapters_on=True)
    jreg = _registry(jax_adapters, jprog, jmodel)
    preg = _registry(adapters, pprog, pmodel)
    jad = jreg.host_tree(aid) if aid else None
    pad = preg.host_tree(aid) if aid else None
    if aid:
        for k, (a, b) in jad.items():
            assert np.array_equal(pad[k][0], a)
            assert np.array_equal(pad[k][1], b)
    prompt = [3, 5, 7, 11, 13, 2]
    kw = dict(temperature=temp, top_p=TOP_P, seed=5)
    want = jprog.fallback_generate(prompt, 9, **dict(kw, ad=jad))
    got = pprog.fallback_generate(prompt, 9, **dict(kw, ad=pad))
    assert got == want and len(got) == 9
    # the port's own program, on the CPU, through the engine
    eng = DecodeEngine(pprog, timeout_s=WAIT, adapters=preg)
    try:
        s = eng.generate(prompt, max_new_tokens=9, adapter=aid, **kw)
        assert s.result(WAIT) == got and not s.degraded
        # the fallback continues a stream from where it got to
        tail = pprog.fallback_generate(prompt + got[:4], 5,
                                       **dict(kw, ad=pad))
        assert tail == got[4:]
    finally:
        eng.close()


def test_fallback_generate_stops_at_eos_and_the_cache_end(models):
    _jm, pmodel, np_params = models
    prog = freeze_decode(pmodel, np_params, slots=2, prefill_buckets=BUCKETS,
                         device='cpu')
    full = prog.fallback_generate([1, 2, 3], 6)
    eos = full[2]
    assert prog.fallback_generate([1, 2, 3], 6, eos_id=eos) == \
        full[:full.index(eos) + 1]
    long = list(range(1, 20)) * 2            # 38 of max_len 48 tokens
    assert len(prog.fallback_generate(long, 30)) == CFG['max_len'] - len(long)


def test_fallback_reads_the_host_copy_only(models):
    """The fallback decodes from the host copy taken when the program was
    made: the program's device parameters (the card's, on a card) are not
    read."""
    _jm, pmodel, np_params = models
    prog = freeze_decode(pmodel, np_params, slots=2, prefill_buckets=BUCKETS,
                         device='cpu', paged=False)
    want = prog.fallback_generate([4, 4, 2], 5)
    prog.params = {k: torch.full_like(v, float('nan'))
                   for k, v in prog.params.items()}
    assert prog.fallback_generate([4, 4, 2], 5) == want
    assert all(not t.is_cuda for t in prog._params_host.values())


# -- the engine under scripted faults, against the JAX engine --------------


def _held(eng):
    """Hold the engine's first tick until every request is queued: it then
    admits them in order in one tick, so the two engines number their
    device calls alike."""
    go = threading.Event()
    tick = eng._tick

    def held():
        go.wait(WAIT)
        tick()

    eng._tick = held
    return go


def _drive(eng, reqs):
    go = _held(eng)
    try:
        streams = [eng.generate(r['prompt'], max_new_tokens=r['n'],
                                adapter=r.get('adapter'),
                                temperature=r.get('temperature', 0.0),
                                top_p=TOP_P, seed=r.get('seed', 0))
                   for r in reqs]
        go.set()
        out = []
        for s in streams:
            try:
                out.append(('ok', s.result(WAIT)))
            except Exception as exc:     # the class name is compared
                out.append((type(exc).__name__, list(s.tokens)))
    finally:
        go.set()
        eng.close()
    st = eng.stats()
    return dict(
        streams=out, degraded=[s.degraded for s in streams],
        reasons=[s.finish_reason for s in streams],
        retired=st['counts']['retired'],
        fallback_tokens=st['counts']['fallback_tokens'],
        prefills=st['counts']['prefills'], engine_degraded=st['degraded'],
        breaker=st['breaker'], free_slots=st['free_slots'])


PROMPTS = ([3, 1, 4, 1, 5, 9, 2], [8, 8, 2], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8],
           [6, 5])

CASES = {
    # (paged, spec_k, adapters, fault spec, request kinds)
    'slot greedy, a step lost': (
        False, 0, False, 'device_loss@serving.decode.5:1', 'gggg'),
    'slot, a prefill lost': (
        False, 0, False, 'device_unavailable@serving.decode.1:1', 'gsgs'),
    'paged sampled, a step stalled': (
        True, 0, False, 'tunnel_stall@serving.decode.6:1', 'gsss'),
    'paged adapters, a step lost': (
        True, 0, True, 'device_loss@serving.decode.5:1', 'gsAB'),
    'paged, the breaker opens': (
        True, 0, False, 'device_loss@serving.decode:3', 'gsgs'),
    'speculative, a verify lost': (
        True, 2, False, 'device_loss@serving.decode.12:1', 'gsgg'),
    'slot, a worker crash': (
        False, 0, False, 'worker_crash@serving.decode.5:1', 'gsgg'),
    'paged, a preemption': (
        True, 0, False, 'preempt@serving.decode.6:1', 'gggs'),
}


def _requests(kinds):
    reqs = []
    for i, (k, prompt) in enumerate(zip(kinds, PROMPTS)):
        r = dict(prompt=prompt, n=6 + i, seed=i)
        if k in 'sB':
            r['temperature'] = TEMP
        if k in 'AB':
            r['adapter'] = 'ad30' if k == 'A' else 'ad31'
        reqs.append(r)
    return reqs


@pytest.mark.parametrize('case', sorted(CASES))
def test_engine_under_a_fault_equals_the_jax_engine(models, monkeypatch,
                                                    case):
    jmodel, pmodel, _np = models
    paged, spec_k, adapters_on, spec, kinds = CASES[case]
    reqs = _requests(kinds)
    jprog, jdraft, pprog, pdraft = _programs(models, paged, spec_k,
                                             adapters_on)
    jkw, pkw = {}, {}
    if adapters_on:
        jkw['adapters'] = _registry(jax_adapters, jprog, jmodel)
        pkw['adapters'] = _registry(adapters, pprog, pmodel)
    _arm(monkeypatch, spec)
    want = _drive(jax_engine.DecodeEngine(jprog, timeout_s=WAIT,
                                          draft=jdraft, **jkw), reqs)
    built = pprog.warmup().compile_count
    got = _drive(DecodeEngine(pprog, timeout_s=WAIT, draft=pdraft, **pkw),
                 reqs)
    assert got == want
    assert pprog.compile_count == built       # a trip builds no program
    assert got['free_slots'] == 4
    aborted = spec.split('@')[0] in ('worker_crash', 'preempt')
    if aborted:
        assert not any(got['degraded'])
        assert got['retired'].get('aborted', 0) >= 1
        assert got['fallback_tokens'] == 0
    else:
        assert any(got['degraded']) and got['fallback_tokens'] > 0
        assert all(s[0] == 'ok' for s in got['streams'])


def test_degraded_streams_give_the_healthy_tokens(models, monkeypatch):
    """The same requests healthy and under a lost step: the same tokens,
    the tripped streams marked and counted, the breaker closed."""
    _jm, pmodel, np_params = models
    reqs = _requests('gsgs')
    prog = freeze_decode(pmodel, np_params, slots=4, prefill_buckets=BUCKETS,
                         page_size=8, device='cpu')
    _arm(monkeypatch, '')
    healthy = _drive(DecodeEngine(prog, timeout_s=WAIT), reqs)
    _arm(monkeypatch, 'device_loss@serving.decode.6:1')
    tripped = _drive(DecodeEngine(prog, timeout_s=WAIT), reqs)
    assert tripped['streams'] == healthy['streams']
    assert all(tripped['degraded']) and not any(healthy['degraded'])
    assert tripped['retired'] == {'degraded': 4}
    assert tripped['fallback_tokens'] == sum(
        len(t) for _s, t in healthy['streams']) - 4 - 2 * 4
    assert healthy['fallback_tokens'] == 0
    assert tripped['breaker'] == 'closed' and tripped['engine_degraded']


# -- the reference's engine tests (test_decode.py, test_paged_decode.py) ----


class _Failing:
    """A program whose device calls numbered in ``fail`` raise
    ``error()``."""

    def __init__(self, prog, fail, error):
        self._prog, self._fail, self._error = prog, set(fail), error
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._prog, name)

    def _call(self, fn, *args, **kwargs):
        n, self.calls = self.calls, self.calls + 1
        if n in self._fail:
            raise self._error()
        return fn(*args, **kwargs)

    def run_prefill(self, *args, **kwargs):
        return self._call(self._prog.run_prefill, *args, **kwargs)

    def run_step(self, *args, **kwargs):
        return self._call(self._prog.run_step, *args, **kwargs)


def _slot_prog(models, slots=2):
    _jm, pmodel, np_params = models
    return freeze_decode(pmodel, np_params, slots=slots,
                         prefill_buckets=BUCKETS, paged=False, device='cpu')


def _healthy(models, prompt, n):
    return _slot_prog(models).fallback_generate(prompt, n)


def test_engine_device_failure_completes_degraded(models, monkeypatch):
    """A transient device failure mid-decode completes every in-flight
    sequence on the fallback with the same tokens."""
    _arm(monkeypatch, '')
    prog = _Failing(_slot_prog(models), [2], lambda: port_policy
                    .DeviceLossError('device_loss', 'serving.decode'))
    eng = DecodeEngine(prog, timeout_s=WAIT)
    try:
        a = eng.generate([1, 2], max_new_tokens=6)
        b = eng.generate([3, 4], max_new_tokens=6)
        assert a.result(WAIT) == _healthy(models, [1, 2], 6)
        assert b.result(WAIT) == _healthy(models, [3, 4], 6)
        assert a.degraded or b.degraded
        assert eng.stats()['counts']['fallback_tokens'] > 0
    finally:
        eng.close()


def _wait_for(cond, budget=30.0):
    ev = threading.Event()
    for _ in range(int(budget / 0.01)):
        if cond():
            return True
        ev.wait(0.01)
    return cond()


@pytest.mark.parametrize('kind,exc_name', [
    ('worker_crash', 'WorkerCrashError'), ('preempt', 'PreemptionSignal')])
@pytest.mark.parametrize('read', ['result', 'iterate'])
def test_mid_stream_fault_aborts_typed_and_recovers(models, monkeypatch,
                                                    kind, exc_name, read):
    """A worker crash / a preemption mid-decode aborts the stream with the
    typed error after the tokens it had (read whole or token by token),
    frees its slot, and after the breaker's reset (a fake clock) the
    half-open probe serves the next request on the card."""
    exc_type = getattr(port_policy, exc_name)
    clock = [0.0]
    breaker = port_policy.CircuitBreaker(failure_threshold=1,
                                         reset_timeout=0.2,
                                         clock=lambda: clock[0])
    _arm(monkeypatch, '%s@serving.decode.2:1' % kind)
    eng = DecodeEngine(_slot_prog(models), timeout_s=WAIT, breaker=breaker)
    try:
        s = eng.generate([1, 2], max_new_tokens=6)
        streamed = []
        with pytest.raises(exc_type):
            if read == 'result':
                s.result(WAIT)
            else:
                for tok in s:
                    streamed.append(tok)
        assert s.finish_reason == 'error' and not s.degraded
        assert len(s.tokens) >= 2                  # aborted mid-stream
        assert streamed == (s.tokens if read == 'iterate' else [])
        assert s.tokens == _healthy(models, [1, 2], 6)[:len(s.tokens)]
        assert _wait_for(lambda: eng.stats()['free_slots'] == 2)
        st = eng.stats()
        assert st['counts']['retired'].get('aborted') == 1
        assert st['breaker'] == 'open' and st['degraded']
        assert exc_name in st['error']
        clock[0] += 0.25
        assert eng.stats()['breaker'] == 'half-open'
        ok = eng.generate([3, 4], max_new_tokens=3)
        assert ok.result(WAIT) == _healthy(models, [3, 4], 3)
        assert not ok.degraded
        st = eng.stats()
        assert st['breaker'] == 'closed' and not st['degraded']
        assert st['counts']['fallback_tokens'] == 0
    finally:
        eng.close()


def test_engine_degraded_fallback_runs_off_worker_thread(models,
                                                         monkeypatch):
    """A trip does not serialize the CPU fallback into the scheduler:
    while a degraded completion is held, the engine admits and decodes a
    fresh sequence."""
    _arm(monkeypatch, '')
    release, entered = threading.Event(), threading.Event()

    class _SlowFallback(_Failing):
        def fallback_generate(self, *args, **kwargs):
            entered.set()
            release.wait(WAIT)
            return self._prog.fallback_generate(*args, **kwargs)

    prog = _SlowFallback(_slot_prog(models), [1], lambda: port_policy
                         .DeviceUnavailableError('device_unavailable', 's'))
    eng = DecodeEngine(prog, timeout_s=WAIT)
    try:
        victim = eng.generate([1, 2], max_new_tokens=4)
        assert entered.wait(WAIT)
        fresh = eng.generate([5, 6], max_new_tokens=3)
        assert fresh.result(WAIT) == _healthy(models, [5, 6], 3)
        assert not fresh.degraded and not victim.done()
        release.set()
        assert victim.result(WAIT) == _healthy(models, [1, 2], 4)
        assert victim.degraded
    finally:
        release.set()
        eng.close()


class _GatedFallback(_Failing):
    """A _Failing program whose CPU fallback records the thread it runs
    on, and after the first token of a completion signals ``first`` and
    waits for ``release`` (or sleeps ``pause`` seconds)."""

    def __init__(self, prog, fail, error, pause=None):
        super().__init__(prog, fail, error)
        self.first, self.release = threading.Event(), threading.Event()
        self.pause = pause
        self.threads = set()

    def fallback_generate(self, *args, on_token=None, **kwargs):
        self.threads.add(threading.get_ident())
        n = [0]

        def gated(tok):
            go_on = on_token(tok)
            n[0] += 1
            if n[0] == 1:
                self.first.set()
                if self.pause is not None:
                    threading.Event().wait(self.pause)
                else:
                    self.release.wait(WAIT)
            return go_on

        return self._prog.fallback_generate(*args, on_token=gated, **kwargs)


def _fallback_threads():
    return [t for t in threading.enumerate()
            if t.name.endswith('-fallback')]


def test_engine_degraded_completions_share_one_fallback_worker(models,
                                                               monkeypatch):
    """While the card keeps failing, every degraded admission queues for
    the one fallback worker: no thread a trip; the queued sequences
    complete in turn with their healthy tokens."""
    _arm(monkeypatch, '')
    prompts = [[1, 2], [3, 4], [5, 6, 7], [2, 2]]
    prog = _GatedFallback(_slot_prog(models), range(1000), lambda: port_policy
                          .DeviceUnavailableError('device_unavailable', 's'))
    before = len(_fallback_threads())
    eng = DecodeEngine(prog, timeout_s=WAIT)
    try:
        streams = [eng.generate(p, max_new_tokens=4) for p in prompts]
        assert prog.first.wait(WAIT)
        assert _wait_for(lambda: len(eng._fallback_q) == len(prompts) - 1)
        assert len(_fallback_threads()) - before == 1
        prog.release.set()
        assert [s.result(WAIT) for s in streams] == \
            [_healthy(models, p, 4) for p in prompts]
        assert all(s.degraded for s in streams)
        assert len(prog.threads) == 1
        st = eng.stats()
        assert st['counts']['fallback_tokens'] == 4 * len(prompts)
        assert st['degraded'] and st['breaker'] == 'open'
    finally:
        prog.release.set()
        eng.close()
    assert len(_fallback_threads()) == before


@pytest.mark.parametrize('stop', ['cancel', 'deadline'])
def test_engine_fallback_stops_at_a_cancel_or_the_budget(models,
                                                         monkeypatch, stop):
    """A degraded completion checks the client's cancel and the request's
    budget between tokens: it ends there, with the healthy tokens it had
    emitted, and the fallback worker goes on to the next."""
    from mxnet_tpu_torch.serving.batcher import RequestTimeout
    _arm(monkeypatch, '')
    deadline = stop == 'deadline'
    prog = _GatedFallback(_slot_prog(models), [0], lambda: port_policy
                          .DeviceLossError('device_loss', 's'),
                          pause=0.3 if deadline else None)
    eng = DecodeEngine(prog, timeout_s=0.2 if deadline else WAIT)
    try:
        victim = eng.generate([1, 2], max_new_tokens=8)
        if deadline:
            with pytest.raises(RequestTimeout):
                victim.result(WAIT)
            assert eng.stats()['counts']['timeouts'] == 1
        else:
            assert prog.first.wait(WAIT)
            victim.cancel()
            prog.release.set()
            assert _wait_for(victim.done)
            assert victim.finish_reason == 'cancelled'
            assert victim.tokens == _healthy(models, [1, 2], 1)
        assert victim.tokens == _healthy(models, [1, 2], 8)[
            :len(victim.tokens)]
        assert len(victim.tokens) <= 1
        assert eng.stats()['counts']['fallback_tokens'] == \
            len(victim.tokens)
    finally:
        prog.release.set()
        eng.close()


@pytest.mark.parametrize('mode', ['oneshot', 'decode'])
def test_idle_session_stays_ok_under_a_short_watchdog_budget(
        models, monkeypatch, tmp_path, mode):
    """The watchdog's heartbeat is armed only while a call is in flight: a
    session idle for longer than its budget still reads ``ok``, its
    breaker closed, and no stall is recorded or written."""
    _arm(monkeypatch, '')
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('MXNET_TPU_WATCHDOG_STEP_S', '0.2')
    monkeypatch.setenv('MXNET_TPU_WATCHDOG_POLL_S', '0.01')
    if mode == 'oneshot':
        _jf, program, x = _mlps()
    else:
        program = _slot_prog(models)
    with serving.InferenceSession(program, deadline_ms=1.0, max_batch=1,
                                  timeout_s=WAIT) as sess:
        if mode == 'oneshot':
            sess.infer(x[0], timeout=WAIT)
        else:
            sess.generate([1, 2], max_new_tokens=3).result(WAIT)
        threading.Event().wait(0.6)
        st = sess.status()
        assert (st['status'], st['breaker'], st['error']) == \
            ('ok', 'closed', None)
        assert sess._watchdog.last_record is None
    assert list(tmp_path.iterdir()) == []


def test_paged_degraded_fallback_rebuilds_pool_and_matches_tokens(
        models, monkeypatch):
    """A transient failure mid-paged-decode: the in-flight sequences
    complete degraded with the same tokens, the allocator and the prefix
    registry reset with the pool, and the engine serves after."""
    _jm, pmodel, np_params = models
    prog = freeze_decode(pmodel, np_params, slots=2, prefill_buckets=(8,),
                         page_size=8, device='cpu')
    ref = prog.fallback_generate([1, 2, 3], 5)
    _arm(monkeypatch, 'device_loss@serving.decode:3')
    eng = DecodeEngine(prog, timeout_s=WAIT)
    try:
        streams = [eng.generate([1, 2, 3], max_new_tokens=5)
                   for _ in range(3)]
        assert [s.result(WAIT) for s in streams] == [ref] * 3
        assert any(s.degraded for s in streams)
        _arm(monkeypatch, '')
        ok = eng.generate([1, 2, 3], max_new_tokens=5)
        assert ok.result(WAIT) == ref
        st = eng.stats()
        assert st['free_slots'] == 2
        assert st['breaker'] == 'open'    # three failures in a row
    finally:
        eng.close()


@pytest.mark.parametrize('error', [
    lambda: KernelLaunchFailure('flash_paged_decode_fwd launch failed: '
                              'cudaError_t 700 INTERNAL'),
    lambda: RuntimeError('device lost'),
    lambda: ValueError('bad dtype in custom model')],
    ids=['kernel launch', 'runtime', 'value'])
def test_bug_shaped_failures_fail_loudly_never_degraded(models, monkeypatch,
                                                        error):
    """A kernel's launch failure (even with a transient marker in its
    message) and any other bug-shaped error fail the streams they carried
    with that error: nothing runs on the CPU, and the engine serves on
    after."""
    _arm(monkeypatch, '')
    prog = _Failing(_slot_prog(models), [2], error)
    eng = DecodeEngine(prog, timeout_s=WAIT)
    try:
        streams = [eng.generate(p, max_new_tokens=5) for p in ([1, 2], [3])]
        for s in streams:
            with pytest.raises(type(error())):
                s.result(WAIT)
            assert not s.degraded and s.finish_reason == 'error'
        ok = eng.generate([4, 5], max_new_tokens=3)
        assert ok.result(WAIT) == _healthy(models, [4, 5], 3)
        assert _wait_for(lambda: eng.stats()['free_slots'] == 2)
        st = eng.stats()
        assert st['counts']['fallback_tokens'] == 0
        assert not st['degraded'] and st['breaker'] == 'closed'
        assert st['counts']['retired'].get('degraded', 0) == 0
    finally:
        eng.close()


def test_a_failing_cache_rebuild_degrades_instead_of_wedging(models,
                                                             monkeypatch):
    """After a trip the cache rebuild raises too (a dead context): the
    retired streams still complete on the CPU, the engine reads degraded
    with the breaker counting (the trip and the failed rebuild), the next
    admission degrades while the rebuild keeps failing (the third failure
    opens the breaker), and once the breaker lets a probe through and the
    rebuild succeeds it serves on the card again."""
    _arm(monkeypatch, '')
    inner = _slot_prog(models)
    broken = {'on': False}

    class _DeadContext(_Failing):
        def new_cache(self):
            if broken['on']:
                raise RuntimeError('CUDA error: an illegal memory access '
                                   'was encountered')
            return self._prog.new_cache()

    def lost():
        broken['on'] = True
        return port_policy.DeviceLossError('device_loss', 'serving.decode')

    prog = _DeadContext(inner, [1], lost)
    clock = [0.0]
    eng = DecodeEngine(prog, timeout_s=WAIT, breaker=port_policy
                       .CircuitBreaker(3, 30.0, clock=lambda: clock[0]))
    try:
        first = eng.generate([1, 2], max_new_tokens=5)
        assert first.result(WAIT) == _healthy(models, [1, 2], 5)
        assert first.degraded
        st = eng.stats()
        assert st['degraded'] and 'cache rebuild' in st['error']
        assert st['breaker'] == 'closed'
        second = eng.generate([3, 4], max_new_tokens=3)
        assert second.result(WAIT) == _healthy(models, [3, 4], 3)
        assert second.degraded and eng.stats()['breaker'] == 'open'
        broken['on'] = False
        refused = eng.generate([7, 1], max_new_tokens=2)
        assert refused.result(WAIT) == _healthy(models, [7, 1], 2)
        assert refused.degraded           # the open breaker: no card call
        clock[0] += 31.0
        third = eng.generate([5, 6], max_new_tokens=3)
        assert third.result(WAIT) == _healthy(models, [5, 6], 3)
        assert not third.degraded and not eng.stats()['degraded']
        assert eng.stats()['free_slots'] == 2
    finally:
        eng.close()


def test_scripted_hang_writes_the_artifact_and_degrades(models, monkeypatch,
                                                        tmp_path):
    """``hang@serving.decode.<k>:1`` through a decode session: the
    watchdog's check writes the stall artifact (phase ``decode``) and the
    in-flight streams complete degraded with the healthy tokens."""
    import json
    _jm, pmodel, np_params = models
    monkeypatch.setenv('MXNET_TPU_WATCHDOG_POLL_S', '3600')
    prog = freeze_decode(pmodel, np_params, slots=2, prefill_buckets=BUCKETS,
                         page_size=8, device='cpu')
    ref = [prog.fallback_generate(p, 5) for p in ([1, 2, 3], [4, 4])]
    _arm(monkeypatch, 'hang@serving.decode.3:1')
    path = str(tmp_path / 'STALL.json')
    with serving.InferenceSession(prog, timeout_s=WAIT,
                                  stall_artifact=path) as sess:
        go = _held(sess._engine)
        streams = [sess.generate(p, max_new_tokens=5)
                   for p in ([1, 2, 3], [4, 4])]
        go.set()
        assert [s.result(WAIT) for s in streams] == ref
        assert all(s.degraded for s in streams)
        st = sess.status()
        assert st['status'] == 'degraded' and 'TunnelStallError' in \
            st['error']
        ok = sess.generate([1, 2, 3], max_new_tokens=5)
        assert ok.result(WAIT) == ref[0] and not ok.degraded
        assert sess.status()['status'] == 'ok'
    with open(path) as f:
        art = json.load(f)
    assert art['schema'] == 'mxnet_tpu.stall.v1'
    assert art['phase'] == 'decode' and art['step'] == 3
    assert art['waited_s'] > art['budget_s']


def test_decode_status_record_has_the_references_keys(models):
    jmodel, pmodel, np_params = models
    jprog, _, pprog, _ = _programs(models, True)
    records = []
    for pkg, prog in ((jax_serving, jprog), (serving, pprog)):
        with pkg.InferenceSession(prog, watchdog=False,
                                  timeout_s=WAIT) as sess:
            sess.generate([5, 3, 1], max_new_tokens=3).result(WAIT)
            records.append(sess.status())
    want, got = records
    assert sorted(got) == sorted(want)
    for key in ('status', 'mode', 'breaker', 'error', 'prefill_buckets',
                'slots', 'max_len', 'paged'):
        assert got[key] == want[key], key
    for key in ('degraded', 'breaker', 'error', 'pending', 'active',
                'free_slots'):
        assert got['decode'][key] == want['decode'][key], key


# -- the one-shot session (test_serving.py), against the JAX session ------


def _mlps():
    """The same Dense(16, relu) -> Dense(4) net in both packages, frozen
    with a ladder up to 4."""
    jnet = jax_nn.HybridSequential()
    jnet.add(jax_nn.Dense(16, activation='relu', in_units=8),
             jax_nn.Dense(4, in_units=16))
    jnet.initialize()
    pnet = nn.HybridSequential()
    pnet.add(nn.Dense(16, activation='relu', in_units=8, device='cpu'),
             nn.Dense(4, in_units=16, device='cpu'))
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for jp, pp in zip(jnet.collect_params().values(), pnet.parameters()):
            w = rs.randn(*pp.shape).astype('float32')
            jp.set_data(jax_nd.array(w))
            pp.copy_(torch.from_numpy(w))
    x = np.random.RandomState(1).randn(6, 8).astype('float32')
    jnet.hybridize()
    jnet(jax_nd.array(x[:1]))
    return (jax_serving.freeze(jnet, data_shapes=[('data', (8,))],
                               max_batch=4),
            serving.freeze(pnet, data_shapes=[('data', (8,))], max_batch=4),
            x)


def _session_run(pkg, frozen, x, n):
    with pkg.InferenceSession(frozen, deadline_ms=1.0, max_batch=1,
                              watchdog=False, timeout_s=WAIT) as sess:
        outs = [sess.infer(x[i], timeout=WAIT)[0] for i in range(n)]
        st = sess.status()
    return outs, {k: st[k] for k in ('status', 'breaker', 'batches')}


@pytest.mark.parametrize('spec,n', [('device_loss@serving:3', 4),
                                    ('device_loss@serving:1', 2),
                                    ('device_unavailable@serving.1:1', 3),
                                    ('', 2)])
def test_session_degrades_to_run_fallback_as_the_jax_session(monkeypatch,
                                                             spec, n):
    jfrozen, pfrozen, x = _mlps()
    _arm(monkeypatch, spec)
    jouts, jst = _session_run(jax_serving, jfrozen, x, n)
    pouts, pst = _session_run(serving, pfrozen, x, n)
    assert pst == jst
    for i, (po, jo) in enumerate(zip(pouts, jouts)):
        np.testing.assert_allclose(po, jo, atol=1e-5, rtol=1e-5)
        assert np.array_equal(po, pfrozen.run([x[i:i + 1]])[0][0])
        assert np.array_equal(po, pfrozen.run_fallback([x[i:i + 1]])[0][0])
    if spec == 'device_loss@serving:3':
        assert pst == {'status': 'degraded', 'breaker': 'open',
                       'batches': {'accel': 0, 'fallback': 4}}
    if spec == 'device_loss@serving:1':
        assert pst == {'status': 'ok', 'breaker': 'closed',
                       'batches': {'accel': 1, 'fallback': 1}}


def test_session_status_goes_degraded_then_ok(monkeypatch):
    _jf, pfrozen, x = _mlps()
    _arm(monkeypatch, 'tunnel_stall@serving:1')
    with serving.InferenceSession(pfrozen, deadline_ms=1.0, max_batch=1,
                                  watchdog=False) as sess:
        sess.infer(x[0], timeout=WAIT)
        st = sess.status()
        assert st['status'] == 'degraded' and st['mode'] == 'oneshot'
        assert st['error'].startswith('TunnelStallError')
        out = sess.infer_batch([x[:3]])[0]
        st = sess.status()
    assert st['status'] == 'ok' and st['error'] is None
    assert st['batches'] == {'accel': 1, 'fallback': 1}
    assert np.array_equal(out, pfrozen.run([x[:3]])[0])


@pytest.mark.parametrize('kind,exc_name', [
    ('worker_crash', 'WorkerCrashError'), ('preempt', 'PreemptionSignal')])
def test_session_serve_aborts_typed_as_the_jax_session(monkeypatch, kind,
                                                       exc_name):
    jfrozen, pfrozen, x = _mlps()
    got = {}
    for name, pkg, frozen in (('jax', jax_serving, jfrozen),
                              ('port', serving, pfrozen)):
        _arm(monkeypatch, '%s@serving:1' % kind)
        with pkg.InferenceSession(frozen, deadline_ms=1.0,
                                  watchdog=False) as sess:
            with pytest.raises(Exception) as ei:
                sess.infer(x[0], timeout=WAIT)
            out = sess.infer(x[1], timeout=WAIT)[0]
            st = sess.status()
        got[name] = (type(ei.value).__name__, st['batches'], st['status'],
                     out)
    assert got['port'][:3] == got['jax'][:3]
    assert got['port'][0] == exc_name
    np.testing.assert_allclose(got['port'][3], got['jax'][3], atol=1e-5)
    assert np.array_equal(got['port'][3], pfrozen.run([x[1:2]])[0][0])


def test_session_real_hang_detected_by_the_watchdog_monitor(monkeypatch,
                                                            tmp_path):
    """A real hang (the device call blocks; no scripted fault): the
    monitor thread writes the stall artifact, counts a breaker failure
    and reads the session degraded while the worker is still blocked; the
    batch completes once the call returns."""
    import json
    _arm(monkeypatch, '')
    _jf, pfrozen, x = _mlps()
    gate = threading.Event()
    real_run = pfrozen.run

    def hung_run(arrays, n=None):
        gate.wait(WAIT)
        return real_run(arrays, n)

    pfrozen.run = hung_run
    monkeypatch.setenv('MXNET_TPU_WATCHDOG_STEP_S', '0.15')
    monkeypatch.setenv('MXNET_TPU_WATCHDOG_POLL_S', '0.05')
    stall = str(tmp_path / 'STALL.json')
    sess = serving.InferenceSession(pfrozen, deadline_ms=1.0, max_batch=1,
                                    timeout_s=WAIT, stall_artifact=stall)
    try:
        fut = sess.submit(x[0])
        assert _wait_for(lambda: sess.status()['status'] == 'degraded',
                         WAIT)
        assert os.path.exists(stall)
        with open(stall) as f:
            art = json.load(f)
        assert art['phase'] == 'infer' and art['budget_s'] == 0.15
        assert sess.status()['error'].startswith('stall: infer phase')
        gate.set()
        assert np.array_equal(fut.result(WAIT)[0], real_run([x[:1]])[0][0])
        assert sess.status()['status'] == 'ok'
    finally:
        gate.set()
        sess.close()
