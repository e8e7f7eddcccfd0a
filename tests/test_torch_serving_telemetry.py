"""Port parity of the serving telemetry: the ``mxnet_tpu_serve_*`` series
and the flight events the port's decode engine, session, micro-batcher,
adapter pool and gateway emit, against the JAX package's, on the CPU.

One scripted scenario runs through the JAX package's engines and session
and then through the port's, from the same numpy weights (a causal LM at
vocab 64, units 128, 2 layers, 2 heads: head dim 64), each package
recording into its own registry and recorder:

  * engine A (paged, page size 8, 7 usable pages, prefix cache, a slot
    draft with ``spec_k`` 2, an adapter pool of one row, 2 slots, queue
    depth 2): a queue-full reject with the first tick held, a prefix hit
    beside its donor, speculative steps, a prompt the pool cannot hold
    (LRU evictions, then ``pool_exhausted``), an adapter load, its
    eviction by a second adapter, an unknown adapter, a ``prefill_only``
    export, a ``cold`` import;
  * engine B (paged, page size 16, behind an ``InferenceSession``): a
    ``cold`` export of a held request, the import of A's export;
  * A again under ``MXNET_TPU_FAULT=device_loss@serving.decode:3``: two
    fallbacks, then the breaker opens (the ring dumps, reason
    ``breaker``);
  * a drain of B's endpoint.

Every phase waits for its streams and for the engine's worker to go idle,
so the runs are the same sequence. What is held: the serve series' deltas
are equal (counters and gauges exactly, histograms by count) and every
declared serve series is present; the flight events are equal, in order,
in kind and every field but ``ts`` / ``mono``, the text of ``error`` and
the seconds a timer read (``seconds``, ``duration_s``); the breaker's
dumps hold the same events. The micro-batcher (a queue-full reject, a
doomed request shed, the batches) and the one-shot session under a
breaker-opening fault are held the same way. The gateway half runs the
reference's fake-replica tests through both gateways (as
``tests/test_torch_gateway.py`` does) and holds the events of ROADMAP C3
(``gateway_resume``, ``gateway_resume_failed``, ``gateway_journal_capped``,
``seq_handoff`` at each stage, ``tenant_reject``), and a drain through
both gateways over the port's replicas (``gateway_migrate``).
"""
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

import test_gateway as tg
import test_migration as tm
import test_torch_degraded as td
import test_torch_gateway as ttg
from mxnet_tpu import observability as jax_obs
from mxnet_tpu import serving as jax_serving
from mxnet_tpu.resilience import policy as jax_policy
from mxnet_tpu.serving import adapters as jax_adapters
from mxnet_tpu.serving import batcher as jax_batcher
from mxnet_tpu.serving import gateway as jax_gw
from mxnet_tpu.serving.decode import engine as jax_engine
from mxnet_tpu.serving.decode.model import \
    init_transformer_lm as jax_init_lm
from mxnet_tpu.serving.decode.program import \
    freeze_decode as jax_freeze_decode
from mxnet_tpu.serving.server import ServingHTTPServer as JaxHTTPServer
from mxnet_tpu_torch import observability as port_obs
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.resilience import policy as port_policy
from mxnet_tpu_torch.serving import adapters as port_adapters
from mxnet_tpu_torch.serving import batcher as port_batcher
from mxnet_tpu_torch.serving import gateway as port_gw
from mxnet_tpu_torch.serving.decode import (DecodeEngine, freeze_decode,
                                            init_transformer_lm)

torch.set_num_threads(1)

CFG = dict(vocab=64, units=128, hidden=128, layers=2, heads=2, max_len=96)
WAIT = 120
PREFIX = 'mxnet_tpu_serve_'
# fields whose value a timer read, and the free text of an error
TIMED = ('ts', 'mono', 'seconds', 'duration_s', 'est_batch_ms')

P = [5, 9, 2, 7, 11, 3, 8, 1, 4, 6, 13, 10, 12, 14, 15, 16, 17, 18, 19, 20]
PKGS = {
    'jax': dict(obs=jax_obs, policy=jax_policy, adapters=jax_adapters,
                freeze=jax_freeze_decode, Engine=jax_engine.DecodeEngine,
                Session=jax_serving.InferenceSession, Server=JaxHTTPServer,
                batcher=jax_batcher, gw=jax_gw),
    'port': dict(obs=port_obs, policy=port_policy, adapters=port_adapters,
                 freeze=freeze_decode, Engine=DecodeEngine,
                 Session=serving.InferenceSession,
                 Server=serving.ServingHTTPServer, batcher=port_batcher,
                 gw=port_gw),
}


@pytest.fixture(autouse=True)
def _telemetry(tmp_path):
    """Both packages' telemetry on, each recorder empty and dumping into
    this test's directory; both as they were, after."""
    saved = []
    for name, pkg in PKGS.items():
        obs = pkg['obs']
        obs.set_enabled(True)
        rec = obs.get_recorder()
        saved.append((obs, rec, rec.path, rec._enabled))
        rec.clear()
        obs.configure_flight(path=str(tmp_path / ('%s.jsonl' % name)),
                             enabled=True)
    yield
    for obs, rec, path, enabled in saved:
        obs.set_enabled(None)
        rec.path, rec._enabled = path, enabled


@pytest.fixture(scope='module')
def models():
    jmodel, np_params = jax_init_lm(**CFG)
    pmodel, _ = init_transformer_lm(**CFG)
    return {'jax': jmodel, 'port': pmodel}, \
        {k: np.asarray(v) for k, v in np_params.items()}


def _arm(monkeypatch, spec):
    """Script ``spec`` for both packages, each injector parsed afresh."""
    monkeypatch.setenv('MXNET_TPU_FAULT', '')
    jax_policy.get_injector()
    port_policy.get_injector()
    if spec:
        monkeypatch.setenv('MXNET_TPU_FAULT', spec)


# -- reading the registry and the recorder -----------------------------------

def _serve_series(obs):
    """{(name, labels): (type, value or count)} of every serve series."""
    out = {}
    for name, fam in obs.snapshot().items():
        if not name.startswith(PREFIX):
            continue
        for s in fam['series']:
            key = (name, tuple(sorted(s['labels'].items())))
            out[key] = (fam['type'], s['count'] if fam['type'] ==
                        'histogram' else s['value'])
    return out


def _delta(before, after):
    """Counters and histogram counts as deltas (the ones that moved: an
    earlier test in the process may have made a series this run leaves
    alone), gauges as they end."""
    out = {}
    for key, (typ, v) in after.items():
        if typ == 'gauge':
            out[key] = v
        elif v != before.get(key, (typ, 0))[1]:
            out[key] = v - before.get(key, (typ, 0))[1]
    return out


def _norm(events, urls=()):
    """Events without their timed fields or error text, request ids and
    the given URLs normalised."""
    out = []
    for ev in events:
        ev = {k: v for k, v in ev.items() if k not in TIMED}
        if 'error' in ev:
            ev['error'] = str(ev['error']).split(':')[0]
        out.append(ev)
    text = json.dumps(out, sort_keys=True)
    text = re.sub(r'gw\d+-(\d+)', r'gw-\1', text)
    for i, url in enumerate(urls):
        text = text.replace(url, 'url%d' % i)
    return json.loads(text)


# -- the engines' scenario ---------------------------------------------------

class _Gate:
    """Wraps an engine's tick: the first waits for :meth:`open`; ``busy``
    reads True while a tick runs."""

    def __init__(self, eng, held=False):
        self.go = threading.Event()
        if not held:
            self.go.set()
        self.busy = False
        self.eng = eng
        tick = eng._tick

        def gated():
            self.go.wait(WAIT)
            self.busy = True
            try:
                tick()
            finally:
                self.busy = False

        eng._tick = gated

    def open(self):
        self.go.set()

    def idle(self):
        """Wait until the worker has no work and is out of its tick (the
        tick's gauges are then set)."""
        deadline = time.monotonic() + WAIT
        eng = self.eng
        while time.monotonic() < deadline:
            with eng._lock:
                work = eng._pending or eng._active or eng._migrations
            if not work and not self.busy:
                time.sleep(0.02)
                if not self.busy:
                    return
            time.sleep(0.005)
        raise AssertionError('engine did not go idle')


def _programs(pkg, model, np_params):
    f = pkg['freeze']
    a = f(model, np_params, slots=2, prefill_buckets=(16, 64), paged=True,
          page_size=8, pages=8, spec_k=2, adapter_rank=4, adapter_slots=2,
          **({} if pkg is PKGS['jax'] else {'device': 'cpu'}))
    draft = f(model, np_params, slots=2, prefill_buckets=(16, 64),
              paged=False, **({} if pkg is PKGS['jax'] else
                              {'device': 'cpu'}))
    b = f(model, np_params, slots=2, prefill_buckets=(16, 64), paged=True,
          page_size=16, pages=8,
          **({} if pkg is PKGS['jax'] else {'device': 'cpu'}))
    return a, draft, b


def _registry(pkg, prog, model):
    ad = pkg['adapters']
    reg = ad.AdapterRegistry(ad.AdapterPool(prog.adapter_spec))
    for seed in (1, 2):
        reg.register('ad%d' % seed, ad.init_adapter(
            model, rank=4, seed=seed, scale=1.0, name='ad%d' % seed))
    return reg


def _result(stream):
    try:
        return ('ok', stream.result(WAIT))
    except Exception as exc:     # the class name is compared
        return (type(exc).__name__, list(stream.tokens))


def _scenario(name, models, monkeypatch, tmp_path):
    """One package's run: (serve deltas, events, the breaker's dump,
    what the clients saw)."""
    pkg = PKGS[name]
    model, np_params = models[0][name], models[1]
    obs = pkg['obs']
    before = _serve_series(obs)
    _arm(monkeypatch, '')
    prog_a, draft, prog_b = _programs(pkg, model, np_params)
    if name == 'jax':      # the port's engines build their programs
        prog_a.warmup()
        draft.warmup()
    eng = pkg['Engine'](prog_a, max_queue=2, timeout_s=WAIT, draft=draft,
                        prefix_cache=True,
                        adapters=_registry(pkg, prog_a, model))
    skw = {'warmup': True} if name == 'jax' else {}
    sess_b = pkg['Session'](prog_b, watchdog=False, timeout_s=WAIT, **skw)
    eng_b = sess_b._engine
    seen = []
    try:
        # 1. queue full while the first tick is held; a prefix hit beside
        # its donor, then speculative steps
        gate = _Gate(eng, held=True)
        s1 = eng.generate(P, max_new_tokens=6)
        s2 = eng.generate(P + [21, 22], max_new_tokens=6)
        with pytest.raises(Exception) as info:
            eng.generate([30, 31], max_new_tokens=2)
        seen.append(type(info.value).__name__)
        gate.open()
        seen += [_result(s1), _result(s2)]
        gate.idle()
        # 2. a prompt the pool cannot hold, after evicting the prefixes
        seen.append(_result(eng.generate(list(range(2, 62)),
                                         max_new_tokens=2)))
        gate.idle()
        # 3. an adapter loads, a second evicts it (one row), an unknown
        # one is refused; one sampled stream
        for aid, temp in (('ad1', 0.0), ('ad2', 0.7), ('nope', 0.0)):
            seen.append(_result(eng.generate(
                [40, 41, 42, 43, 44], max_new_tokens=3, adapter=aid,
                temperature=temp, seed=3)))
            gate.idle()
        # 4. a prefill_only export into B; a cold export out of B into A
        s = eng.generate([50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61],
                         max_new_tokens=8, prefill_only=True)
        seen.append(_result(s))
        payload = s.seqstate
        gate.idle()
        gate_b = _Gate(eng_b, held=True)
        held = eng_b.generate([33, 34, 35], max_new_tokens=4,
                              request_id='rc')
        cold = eng_b.export_sequence(held)
        gate_b.open()
        seen.append((held.finish_reason, cold['kind']))
        seen.append(_result(eng_b.import_sequence(payload)))
        gate_b.idle()
        seen.append(_result(eng.import_sequence(cold)))
        gate.idle()
        # 5. three transient faults: two fallbacks, then the breaker opens
        _arm(monkeypatch, 'device_loss@serving.decode:3')
        for first in (24, 25, 26):
            r = eng.generate([first, 3, 4], max_new_tokens=3)
            seen.append(_result(r) + (r.degraded,))
            gate.idle()
        _arm(monkeypatch, '')
        seen.append(eng.stats()['breaker'])
        # 6. a drain of B's endpoint
        srv = pkg['Server'](sess_b, 0)
        srv.begin_drain(reason='test', handoff_timeout_s=0.5)
        assert srv.wait_drained(WAIT)
        seen.append(srv.drain_result['sequences'])
        stats = eng.stats()['counts']
    finally:
        eng.close()
        sess_b.close()
    events = obs.get_recorder().events()
    header, dumped = obs.read_flight(str(tmp_path / ('%s.jsonl' % name)))
    return dict(series=_delta(before, _serve_series(obs)), events=events,
                dump=(header['reason'], dumped), seen=seen, counts=stats)


def test_engine_session_telemetry_equals_the_jax_packages(models,
                                                          monkeypatch,
                                                          tmp_path):
    want = _scenario('jax', models, monkeypatch, tmp_path)
    got = _scenario('port', models, monkeypatch, tmp_path)
    assert got['seen'] == want['seen']
    kinds = [e['kind'] for e in got['events']]
    # the scenario reached every site it scripts
    for kind in ('serve_compile', 'serve_reject', 'prefix_hit',
                 'decode_admit', 'page_alloc', 'page_evict', 'decode_retire',
                 'adapter_load', 'adapter_evict', 'adapter_reject',
                 'seq_export', 'seq_import', 'serve_fallback',
                 'breaker_open', 'drain_begin', 'drain_complete'):
        assert kind in kinds, kind
    assert _norm(got['events']) == _norm(want['events'])
    # every series the port emits, the reference emits, with its value
    assert got['series'] == want['series']
    declared = {f.name for f in vars(port_obs.serving_instruments()).values()}
    assert {k[0] for k in got['series']} >= declared - {
        PREFIX + n for n in ('batches_total', 'batch_size',
                             'request_seconds', 'fallback_batches_total')}
    # the registry moved with the engine's own counts (engine A's)
    s = {k[0]: v for k, v in got['series'].items() if not k[1]}
    assert s[PREFIX + 'spec_proposed_total'] == \
        got['counts']['spec_proposed'] > 0
    assert s[PREFIX + 'prefix_hits_total'] == got['counts']['prefix_hits'] \
        == 1
    assert s[PREFIX + 'breaker_trips_total'] == 1
    assert s[PREFIX + 'degraded'] == 1.0
    # the breaker's dump: the ring up to the trip, the reference's
    assert got['dump'][0] == want['dump'][0] == 'breaker'
    assert got['dump'][1][-1]['kind'] == 'breaker_open'
    assert _norm(got['dump'][1]) == _norm(want['dump'][1])


# -- the micro-batcher and the one-shot session ------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _batcher_run(name):
    """A full queue, then a flush, then a doomed request shed (the recent
    batch latency outlasts its budget), on a fake clock."""
    pkg = PKGS[name]
    obs = pkg['obs']
    before = _serve_series(obs)
    clock = _Clock()
    gate = threading.Event()
    calls = []

    def runner(stacked, n):
        calls.append(n)
        gate.wait(WAIT)
        clock.t += 2.0                  # every batch takes 2 s
        return [stacked[0] * 2.0]

    b = pkg['batcher'].MicroBatcher(runner, max_batch=2, deadline_ms=1.0,
                                    max_queue=2, timeout_s=3.0, clock=clock)
    try:
        f1, f2 = b.submit(np.ones(3)), b.submit(np.ones(3))
        refused = None
        try:
            b.submit(np.ones(3))
        except Exception as exc:
            refused = type(exc).__name__
        gate.set()
        out = [f1.result(WAIT)[0].tolist(), f2.result(WAIT)[0].tolist()]
        # 2 s a batch now: a request with less budget is doomed at dequeue
        clock.t += 0.5
        f3 = b.submit(np.ones(3))
        clock.t += 2.0
        try:
            f3.result(WAIT)
            doomed = 'served'
        except Exception as exc:
            doomed = type(exc).__name__
    finally:
        gate.set()
        b.close()
    return dict(series=_delta(before, _serve_series(obs)),
                events=obs.get_recorder().events(),
                seen=[refused, out, doomed, calls])


def test_batcher_telemetry_equals_the_jax_packages():
    want, got = _batcher_run('jax'), _batcher_run('port')
    assert got['seen'] == want['seen']
    assert got['seen'][0] == 'BackpressureError'
    assert got['series'] == want['series']
    assert _norm(got['events']) == _norm(want['events'])
    assert [e['kind'] for e in got['events']] == ['serve_reject',
                                                  'serve_shed_doomed']


@pytest.mark.parametrize('spec,n', [('device_loss@serving:3', 4),
                                    ('device_unavailable@serving.1:1', 3)])
def test_session_trip_telemetry_equals_the_jax_packages(monkeypatch, spec,
                                                        n, tmp_path):
    """The one-shot session under a scripted fault: ``serve_fallback``,
    then (three failures) ``breaker_open`` and the dump; the fallback
    batches and the degraded gauge."""
    jfrozen, pfrozen, x = td._mlps()
    runs = {}
    for name, frozen in (('jax', jfrozen), ('port', pfrozen)):
        obs = PKGS[name]['obs']
        before = _serve_series(obs)
        _arm(monkeypatch, spec)
        _outs, st = td._session_run(jax_serving if name == 'jax'
                                    else serving, frozen, x, n)
        runs[name] = dict(series=_delta(before, _serve_series(obs)),
                          events=obs.get_recorder().events(), st=st)
    want, got = runs['jax'], runs['port']
    assert got['st'] == want['st']
    assert got['series'] == want['series']
    assert _norm(got['events']) == _norm(want['events'])
    kinds = [e['kind'] for e in got['events']]
    assert 'serve_fallback' in kinds
    if spec == 'device_loss@serving:3':
        assert kinds.count('breaker_open') == 1
        header, dumped = port_obs.read_flight(str(tmp_path / 'port.jsonl'))
        assert header['reason'] == 'breaker'
        assert dumped[-1]['kind'] == 'breaker_open'


# -- the gateway's events (ROADMAP C3) ----------------------------------------

C3 = {
    'test_resume_splices_midstream_death': {'gateway_resume'},
    'test_resume_budget_exhausted_typed_replica_lost': {
        'gateway_resume', 'gateway_resume_failed'},
    'test_disagg_handoff_splices_bit_identical': {'seq_handoff'},
    'test_disagg_import_refusal_retries_next_decode': {'seq_handoff'},
    'test_disagg_refusals_exhaust_budget_fall_back_monolithic': {
        'seq_handoff'},
    'test_tenant_admission_over_http': {'tenant_reject'},
}
STAGES = {
    'test_disagg_handoff_splices_bit_identical': ['export', 'spliced'],
    'test_disagg_import_refusal_retries_next_decode': [
        'export', 'retry', 'spliced'],
    'test_disagg_refusals_exhaust_budget_fall_back_monolithic': [
        'export', 'retry', 'retry', 'fallback'],
}


def _gateway_events(fn, name, monkeypatch, ports=None):
    obs = PKGS[name]['obs']
    obs.get_recorder().clear()
    _text, ports = ttg._scenario(fn, name, monkeypatch, ports)
    events = [e for e in obs.get_recorder().events()
              if e['kind'].startswith(('gateway_', 'seq_handoff',
                                       'tenant_'))]
    return sorted(map(json.dumps, _norm(events))), ports, events


@pytest.mark.parametrize('test', sorted(C3) + ['journal_cap'])
def test_gateway_events_equal_the_jax_gateways(test, monkeypatch):
    fn = tm.test_gateway_journal_cap_readmits_original_prompt \
        if test == 'journal_cap' else getattr(tg, test)
    want, ports, _ = _gateway_events(fn, 'jax', monkeypatch)
    got, _, events = _gateway_events(fn, 'port', monkeypatch, ports)
    assert got == want
    kinds = {e['kind'] for e in events}
    if test == 'journal_cap':
        assert 'gateway_journal_capped' in kinds
    else:
        assert C3[test] <= kinds
    if test in STAGES:
        assert [e['stage'] for e in events] == STAGES[test]


def _hold_step_for_export(rep, step):
    """Hold decode step number ``step`` of ``rep`` until an export is
    queued at its engine (the drain's), so that the drain lands after
    exactly ``step`` tokens of the stream, however the host is loaded:
    the held step then emits token ``step`` + 1 and the next tick
    services the export first. ``gateway_migrate`` records how many
    tokens the gateway relayed before the move, which is compared."""
    eng = rep.sess._engine
    run_step = eng.program.run_step
    calls = [0]

    def held(*a, **kw):
        calls[0] += 1
        if calls[0] == step:
            deadline = time.monotonic() + WAIT
            while not eng._migrations:
                assert time.monotonic() < deadline, 'no export was queued'
                time.sleep(0.002)
        return run_step(*a, **kw)
    eng.program.run_step = held


def test_gateway_migrate_event_through_both_gateways(monkeypatch):
    """A replica drains mid-stream behind each gateway: the stream lands
    by ``/import`` on the other replica, and each gateway records
    ``gateway_migrate`` once (port replicas both times). The drained
    replica's step 4 waits for the drain's export, so both gateways relay
    the same 5 tokens before the move."""
    jmodel, np_params = jax_init_lm(**ttg.CFG)
    weights = (jmodel, serving.init_transformer_lm(**ttg.CFG)[0],
               {k: np.asarray(v) for k, v in np_params.items()})
    runs = {}
    for name in ('jax', 'port'):
        reps = [ttg._Replica(weights, 8, 32, step_s=0.01),
                ttg._Replica(weights, 16, 16)]
        gw = ttg._gateway(PKGS[name]['gw'], [r.url for r in reps])
        PKGS[name]['obs'].get_recorder().clear()
        try:
            target = next(r for r in reps
                          if r.url == gw.affinity_target(ttg.PROMPT))
            dest = next(r for r in reps if r is not target)
            _hold_step_for_export(target, 4)
            import http.client
            conn = http.client.HTTPConnection('127.0.0.1', gw.port,
                                              timeout=WAIT)
            conn.request('POST', '/generate', body=json.dumps(
                {'tokens': ttg.PROMPT, 'max_new_tokens': 20}).encode(),
                headers={'Content-Type': 'application/json'})
            n = 0
            for raw in conn.getresponse():
                doc = json.loads(raw)
                if doc.get('done'):
                    break
                n += 1
                if n == 4:
                    target.srv.begin_drain(reason='test')
            conn.close()
            assert target.srv.wait_drained(timeout=WAIT)
            events = [e for e in PKGS[name]['obs'].get_recorder().events()
                      if e['kind'].startswith('gateway_')]
            runs[name] = _norm(events, urls=(dest.url,))
        finally:
            gw.stop()
            for rep in reps:
                rep.close()
    assert runs['port'] == runs['jax']
    assert [e['kind'] for e in runs['port']] == ['gateway_migrate']
    assert runs['port'][0]['to_url'] == 'url0'
    assert runs['port'][0]['tokens'] == 5
