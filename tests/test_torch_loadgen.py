"""Port parity of the load and chaos harness: ``mxnet_tpu_torch.loadgen``
against the JAX package's ``mxnet_tpu/loadgen``, on the CPU.

The reference's ``tests/test_loadgen.py`` twinned over the port
(schedules, percentile and artifact math, the live rig over real HTTP:
both routes, a streamed TTFT, overload shedding with Retry-After, a chaos
burst with recovery and zero hang, the full scripted soak in the slow
tier, the dispatcher's open-loop accounting, the client's retries), and
``tests/test_gateway.py``'s two rig drills (failover, tenants; slow). On
top of those, the port against the reference itself: the same schedules
for the same seeds, the same ``mxnet_tpu.slo.v1`` documents for the same
records, and a port ``ServingRig`` and a reference one, the decode weights
carried across by ``params_from_jax`` and the MLP's into the port's gluon
layers, serving the same ``/generate`` tokens and ``/predict`` outputs
(1e-6). One CLI run (the disaggregated drill, traced) writes its artifact.
"""
import json
import random
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.loadgen import (build_schedule, latency_summary,
                                     percentile, summarize)
from mxnet_tpu_torch.loadgen.client import RequestRecord
from mxnet_tpu_torch.loadgen.report import SLO_SCHEMA, build_artifact

torch.set_num_threads(1)

HTTP_S = 30
PREDICT_ATOL = 1e-6


# ---------------------------------------------------------------------------
# schedule: pure, deterministic math
# ---------------------------------------------------------------------------

def test_schedule_deterministic_given_seed():
    kw = dict(qps=80.0, duration_s=2.0,
              mix={'predict': 0.6, 'generate': 0.4}, seed=11)
    a = build_schedule(**kw)
    b = build_schedule(**kw)
    assert [(x.t, x.kind, x.rid) for x in a] \
        == [(x.t, x.kind, x.rid) for x in b]
    c = build_schedule(qps=80.0, duration_s=2.0,
                       mix={'predict': 0.6, 'generate': 0.4}, seed=12)
    assert [(x.t, x.kind) for x in c] != [(x.t, x.kind) for x in a]


def test_schedule_rate_mix_and_ordering():
    arr = build_schedule(200.0, 5.0,
                         mix={'predict': 0.75, 'generate': 0.25},
                         seed=3)
    # ~1000 arrivals, Poisson noise well under 20%
    assert 800 < len(arr) < 1200
    assert all(0.0 <= x.t < 5.0 for x in arr)
    assert all(a.t <= b.t for a, b in zip(arr, arr[1:]))
    gen = sum(1 for x in arr if x.kind == 'generate')
    assert 0.15 < gen / len(arr) < 0.35
    assert [x.rid for x in arr] == list(range(len(arr)))


def test_schedule_fixed_rate_and_validation():
    arr = build_schedule(10.0, 1.0, seed=0, poisson=False)
    gaps = [b.t - a.t for a, b in zip(arr, arr[1:])]
    assert all(abs(g - 0.1) < 1e-9 for g in gaps)
    with pytest.raises(ValueError):
        build_schedule(0.0, 1.0)
    with pytest.raises(ValueError):
        build_schedule(10.0, -1.0)
    with pytest.raises(ValueError):
        build_schedule(10.0, 1.0, mix={'predict': -1.0})


@pytest.mark.parametrize('seed', (0, 1, 11, 7919))
@pytest.mark.parametrize('kw', (
    dict(qps=80.0, duration_s=2.0, mix={'predict': 0.6, 'generate': 0.4}),
    dict(qps=200.0, duration_s=1.0, mix=None),
    dict(qps=12.0, duration_s=4.0, mix={'generate': 1.0}),
    dict(qps=10.0, duration_s=1.0, mix={'predict': 0.3, 'generate': 0.7},
         poisson=False)), ids=('mixed', 'predict', 'generate', 'fixed'))
def test_schedule_is_the_references(seed, kw):
    """The same seed gives the reference's arrivals, time for time."""
    from mxnet_tpu.loadgen import build_schedule as ref_schedule
    got = [(a.t, a.kind, a.rid) for a in build_schedule(seed=seed, **kw)]
    want = [(a.t, a.kind, a.rid) for a in ref_schedule(seed=seed, **kw)]
    assert got == want and got


# ---------------------------------------------------------------------------
# report: percentiles, taxonomy, artifact schema
# ---------------------------------------------------------------------------

def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert percentile(vals, 50) == 50
    assert percentile(vals, 99) == 99
    assert percentile(vals, 100) == 100
    assert percentile(vals, 0) == 1
    assert percentile([], 50) is None
    with pytest.raises(ValueError):
        percentile(vals, 101)


def test_latency_summary_ms():
    s = latency_summary([0.010, 0.020, 0.500])
    assert s['n'] == 3 and s['p50_ms'] == 20.0 \
        and s['max_ms'] == 500.0


def _rec(rid, kind='predict', status=200, error=None, lat=0.01,
         retry_after=None, resolved=True, degraded=False, cls=RequestRecord):
    r = cls(rid, kind, 0.0)
    r.fired_at = 100.0
    r.done_at = 100.0 + lat
    r.status = status
    r.error_class = error
    r.retry_after_s = retry_after
    r.resolved = resolved
    r.degraded = degraded
    return r


def test_summarize_taxonomy_goodput_and_unresolved():
    recs = [_rec(0), _rec(1, lat=0.05, degraded=True),
            _rec(2, status=429, error='shed_backpressure', lat=0.002,
                 retry_after=1.0),
            _rec(3, status=504, error='timeout_budget', lat=2.0),
            _rec(4, status=None, error='client_timeout',
                 resolved=False)]
    m = summarize(recs)
    assert m['offered'] == 5 and m['admitted'] == 2 \
        and m['served_ok'] == 2
    assert m['shed'] == 1 and m['degraded'] == 1
    assert m['unresolved'] == 1
    assert m['errors'] == {'ok': 2, 'shed_backpressure': 1,
                           'timeout_budget': 1, 'client_timeout': 1}
    assert m['goodput'] == pytest.approx(0.4)
    assert m['availability'] == pytest.approx(0.4)
    assert m['retry_after'] == {'n': 1, 'max_s': 1.0}
    assert m['admitted_latency']['n'] == 2
    assert m['shed_latency']['p99_ms'] == 2.0


def test_generate_metrics_ttft_tpot():
    r = RequestRecord(0, 'generate', 0.0)
    r.fired_at = 10.0
    r.first_at = 10.2
    r.done_at = 10.8
    r.tokens = 4
    r.status = 200
    r.resolved = True
    m = summarize([r])
    assert m['generate']['ttft']['p50_ms'] == pytest.approx(200.0)
    assert m['generate']['tpot']['p50_ms'] == pytest.approx(200.0)


def test_build_artifact_schema_and_verdicts():
    doc = build_artifact('overload', {'qps': 10}, {'offered': 1},
                         verdicts={'a': True, 'b': False})
    assert doc['schema'] == SLO_SCHEMA
    assert doc['ok'] is False
    assert doc['verdicts'] == {'a': True, 'b': False}
    json.dumps(doc)     # artifact must be JSON-serializable


def _random_records(cls, seed, n=300):
    """``n`` records of every outcome from ``seed``: served, degraded,
    resumed, shed (with and without Retry-After), typed errors,
    unresolved, streamed with tokens."""
    rs = random.Random(seed)
    outcomes = ((200, None), (200, None), (429, 'shed_backpressure'),
                (504, 'timeout_budget'), (500, 'aborted'),
                (None, 'client_timeout'), (200, 'stream_ReplicaLost'),
                (503, 'unavailable'), (None, 'net_error'))
    recs = []
    for rid in range(n):
        kind = rs.choice(('predict', 'generate'))
        status, error = rs.choice(outcomes)
        r = _rec(rid, kind, status, error, lat=rs.uniform(0.001, 2.0),
                 retry_after=rs.choice((None, 1.0, 2.5))
                 if status in (429, 503) else None,
                 resolved=rs.random() > 0.05, degraded=rs.random() < 0.1,
                 cls=cls)
        if kind == 'generate' and status == 200:
            r.first_at = r.fired_at + rs.uniform(0.0005, 0.5)
            r.tokens = rs.randint(0, 12)
        r.resumed = rs.choice((0, 0, 1))
        r.retries = rs.choice((0, 0, 2))
        r.trace_id = '%032x' % rs.getrandbits(128)
        recs.append(r)
    return recs


@pytest.mark.parametrize('seed', (0, 1, 2))
def test_summarize_and_artifact_are_the_references(seed):
    """The same records give the reference's metric block and artifact
    (with faults, server and verdicts), and the same record JSON."""
    from mxnet_tpu.loadgen import report as ref_report
    from mxnet_tpu.loadgen.client import RequestRecord as RefRecord
    port = _random_records(RequestRecord, seed)
    ref = _random_records(RefRecord, seed)
    assert [r.to_json() for r in port] == [r.to_json() for r in ref]
    mp, mr = summarize(port), ref_report.summarize(ref)
    assert mp == mr
    for q in (0, 50, 99, 99.9, 100):
        lat = [r.latency_s() for r in port]
        assert percentile(lat, q) == ref_report.percentile(lat, q)
    args = ('chaos', {'qps': 20.0, 'seed': seed}, mp)
    kw = dict(faults=[{'kind': 'preempt', 'consumed': True,
                       'recovery_s': 0.5}],
              server={'generate': {'leaked_slots': 0}},
              verdicts={'zero_unresolved': seed != 1, 'b': True})
    assert json.dumps(build_artifact(*args, **kw), sort_keys=True) == \
        json.dumps(ref_report.build_artifact(*args, **kw), sort_keys=True)


# ---------------------------------------------------------------------------
# the live rig over real HTTP (one build amortized across tests)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def rig():
    from mxnet_tpu_torch.loadgen.harness import ServingRig
    r = ServingRig(device='cpu')
    yield r
    r.close()


@pytest.fixture(autouse=True)
def no_faults(monkeypatch):
    """Each test starts and ends without a scripted fault."""
    from mxnet_tpu_torch.resilience import policy
    monkeypatch.delenv('MXNET_TPU_FAULT', raising=False)
    policy.get_injector()
    yield
    policy.get_injector()


def test_rig_dual_session_routes(rig):
    base = 'http://127.0.0.1:%d' % rig.port
    req = urllib.request.Request(
        base + '/predict',
        data=json.dumps({'data': [0.1] * 8}).encode(),
        headers={'Content-Type': 'application/json'})
    body = json.loads(urllib.request.urlopen(req, timeout=20).read())
    assert len(body['outputs'][0]) == 4
    req = urllib.request.Request(
        base + '/generate',
        data=json.dumps({'tokens': [1, 2, 3], 'max_new_tokens': 3,
                         'stream': False}).encode(),
        headers={'Content-Type': 'application/json'})
    body = json.loads(urllib.request.urlopen(req, timeout=30).read())
    assert len(body['tokens']) == 3
    status = json.loads(urllib.request.urlopen(
        base + '/status', timeout=10).read())
    assert 'predict' in status and 'generate' in status
    assert status['generate']['mode'] == 'decode'
    health = json.loads(urllib.request.urlopen(
        base + '/healthz', timeout=10).read())
    assert health['ok'] is True


def test_rig_streamed_generate_records_ttft(rig):
    from mxnet_tpu_torch.loadgen.client import LoadClient
    client = LoadClient('127.0.0.1', rig.port, timeout_s=20.0)
    rec = RequestRecord(0, 'generate', 0.0)
    client.generate(rec, [2, 3, 4], max_new_tokens=4)
    assert rec.resolved and rec.status == 200
    assert rec.error_class is None
    assert rec.tokens == 4
    assert rec.ttft_s() is not None and rec.ttft_s() >= 0.0
    assert rec.tpot_s() is not None


def test_overload_sheds_fast_429_with_retry_after(rig):
    """Overload at a rate far past the decode queue's capacity: the
    excess must resolve as 429s carrying Retry-After, every record
    must resolve, and nothing may leak server-side."""
    from mxnet_tpu_torch.loadgen.harness import run_overload
    doc = run_overload(rig, capacity_qps=24.0, duration_s=2.0,
                       seed=5)
    m = doc['metrics']
    assert m['unresolved'] == 0
    assert doc['verdicts']['zero_unresolved']
    # open-loop accounting: every arrival is a record
    assert m['offered'] == sum(m['errors'].values())
    if m['shed']:
        # every 429 advertised a Retry-After backoff
        assert m['retry_after']['n'] == m['shed']
    # drain proof
    assert doc['server']['generate']['leaked_slots'] == 0
    assert doc['server']['generate']['pending'] == 0


def test_chaos_single_burst_recovers_and_zero_hang(rig):
    """Mini chaos soak: one device_unavailable burst mid-traffic —
    the burst must be consumed, the endpoint must report healthy
    again within the ceiling, every request must resolve, and no
    decode slot may leak."""
    from mxnet_tpu_torch.loadgen.harness import run_chaos
    script = ((0.25, 'device_unavailable',
               'device_unavailable@serving:3,'
               'device_unavailable@serving.decode:1'),)
    doc = run_chaos(rig, qps=15.0, duration_s=4.0, seed=7,
                    script=script)
    assert len(doc['faults']) == 1
    fault = doc['faults'][0]
    assert fault['consumed'], fault
    assert fault['recovery_s'] is not None, fault
    assert doc['verdicts']['all_faults_recovered']
    assert doc['verdicts']['zero_unresolved']
    assert doc['verdicts']['no_leaked_slots']
    assert doc['metrics']['offered'] > 0


@pytest.mark.slow
def test_chaos_full_script_soak(rig):
    """The full scripted soak (device_unavailable burst, tunnel
    stall, worker crash, preemption mid-stream) at sustained rate."""
    from mxnet_tpu_torch.loadgen.harness import run_chaos
    doc = run_chaos(rig, qps=20.0, duration_s=12.0, seed=1)
    kinds = [f['kind'] for f in doc['faults']]
    assert kinds == ['device_unavailable', 'tunnel_stall',
                     'worker_crash', 'preempt']
    assert all(f['consumed'] for f in doc['faults'])
    assert doc['verdicts']['all_faults_recovered'], doc['faults']
    assert doc['verdicts']['zero_unresolved']
    assert doc['verdicts']['no_leaked_slots']
    assert doc['metrics']['availability'] >= 0.5, doc['metrics']


# ---------------------------------------------------------------------------
# dispatcher: open-loop accounting without a server
# ---------------------------------------------------------------------------

def test_dispatcher_saturation_is_counted_not_dropped():
    """Arrivals above the in-flight bound resolve as
    client_saturated — the open-loop contract forbids silently
    thinning the offered load."""
    from mxnet_tpu_torch.loadgen.harness import Dispatcher

    class _StuckClient:
        timeout_s = 1.0

        def predict(self, rec, data):
            gate.wait(5.0)
            rec.resolved = True

        def generate(self, rec, tokens, max_new_tokens=8):
            gate.wait(5.0)
            rec.resolved = True

    gate = threading.Event()
    disp = Dispatcher(_StuckClient(), max_inflight=2)
    arrivals = build_schedule(200.0, 0.05, seed=0)
    assert len(arrivals) >= 4
    records, threads = disp.run(arrivals)
    try:
        saturated = [r for r in records
                     if r.error_class == 'client_saturated']
        assert len(records) == len(arrivals)
        assert saturated, 'expected arrivals past the bound'
        assert all(r.resolved for r in saturated)
    finally:
        gate.set()
        assert disp.drain(threads, 5.0) == 0


def test_request_record_derived_metrics_none_safe():
    r = RequestRecord(0, 'predict', 0.0)
    assert r.latency_s() is None and r.ttft_s() is None \
        and r.tpot_s() is None
    assert r.to_json()['resolved'] is False


# ---------------------------------------------------------------------------
# resume taxonomy + client Retry-After backoff
# ---------------------------------------------------------------------------

def test_summarize_counts_resumed_streams_as_success():
    clean = _rec(0, kind='generate')
    resumed = _rec(1, kind='generate')
    resumed.resumed = 1
    retried = _rec(2, status=429, error='shed_backpressure')
    retried.retries = 2
    m = summarize([clean, resumed, retried])
    assert m['resumed_streams'] == 1
    assert m['retried'] == 1
    assert m['served_ok'] == 2          # the resumed stream is OK
    assert m['goodput'] == pytest.approx(2 / 3)
    j = resumed.to_json()
    assert j['resumed'] == 1 and j['retries'] == 0


def test_client_retries_honor_retry_after_with_cap():
    """On 429/503 with retry budget, the client sleeps the replica's
    Retry-After (capped) and re-fires; the record keeps its original
    fired_at and counts every retry."""
    from mxnet_tpu_torch.loadgen.client import LoadClient
    sleeps = []
    client = LoadClient('127.0.0.1', 1, retries=2, retry_cap_s=0.5,
                        sleep=sleeps.append)
    outcomes = [(429, 3.0), (503, 0.2), (200, None)]

    def attempt(rec):
        if rec.fired_at is None:
            rec.fired_at = 100.0
        status, ra = outcomes[rec.retries]
        rec.status = status
        rec.retry_after_s = ra
        rec.error_class = None if status == 200 else 'shed'
        rec.resolved = True

    rec = RequestRecord(0, 'predict', 0.0)
    client._with_retries(rec, attempt)
    assert rec.status == 200 and rec.retries == 2
    assert sleeps == [0.5, 0.2]         # 3.0 capped to 0.5
    assert rec.fired_at == 100.0        # original firing instant kept


def test_client_retries_default_off():
    """The knob default (0 retries) keeps the one-shot open-loop
    behavior the overload verdicts are calibrated on."""
    from mxnet_tpu_torch.loadgen.client import LoadClient
    client = LoadClient('127.0.0.1', 1)
    assert client.retries == 0
    calls = []

    def attempt(rec):
        calls.append(1)
        rec.status = 429
        rec.resolved = True

    rec = RequestRecord(0, 'predict', 0.0)
    client._with_retries(rec, attempt)
    assert len(calls) == 1 and rec.status == 429


# ---------------------------------------------------------------------------
# the port's rig against the reference's, on the same weights
# ---------------------------------------------------------------------------

def carried_rig(ref, **kw):
    """A port ``ServingRig`` on the CPU serving the reference rig
    ``ref``'s weights: the decode LM's through ``params_from_jax`` (the
    reference's ``init_transformer_lm`` at the same widths and seed), the
    trained MLP's copied into the port's two ``Dense`` layers."""
    from mxnet_tpu.serving.decode import init_transformer_lm as jax_init
    from mxnet_tpu_torch.gluon.nn import Dense
    from mxnet_tpu_torch.loadgen.harness import ServingRig
    from mxnet_tpu_torch.serving import decode as port_decode
    port_init = port_decode.init_transformer_lm

    def init(**widths):
        model, _ = port_init(**widths)
        _jm, jax_params = jax_init(**widths)
        return model, {k: t.numpy() for k, t in port_decode.params_from_jax(
            {k: np.asarray(v) for k, v in jax_params.items()},
            device='cpu').items()}

    with mock.patch.object(port_decode, 'init_transformer_lm', init):
        rig = ServingRig(device='cpu', **kw)
    if rig.predict_session is not None:
        arg = ref.predict_session.frozen._arg_np
        dense = [m for m in rig.predict_session.frozen.block.modules()
                 if isinstance(m, Dense)]
        with torch.no_grad():
            for layer, fc in zip(dense, ('fc1', 'fc2')):
                layer.weight.copy_(torch.tensor(arg[fc + '_weight']))
                layer.bias.copy_(torch.tensor(arg[fc + '_bias']))
    return rig


def _http(port, path, payload):
    req = urllib.request.Request(
        'http://127.0.0.1:%d%s' % (port, path),
        data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    return json.loads(urllib.request.urlopen(req, timeout=HTTP_S).read())


def _ndjson(port, payload):
    req = urllib.request.Request(
        'http://127.0.0.1:%d/generate' % port,
        data=json.dumps(dict(payload, stream=True)).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=HTTP_S) as resp:
        return [json.loads(line) for line in resp if line.strip()]


def test_rig_serves_the_references():
    """The same requests through a reference rig and a port rig on the
    same weights: the ``/generate`` streams line for line (greedy, and a
    prefix-sharing pair), the ``/predict`` outputs within 1e-6."""
    from mxnet_tpu.loadgen.harness import Dispatcher as RefDispatcher
    from mxnet_tpu.loadgen.harness import ServingRig as RefRig
    from mxnet_tpu_torch.loadgen.harness import Dispatcher
    ref = RefRig()
    port = None
    try:
        port = carried_rig(ref)
        for rid in range(6):
            assert Dispatcher._predict_payload(rid) == \
                RefDispatcher._predict_payload(rid)
            data = Dispatcher._predict_payload(rid)
            got = np.asarray(_http(port.port, '/predict',
                                   {'data': data})['outputs'])
            want = np.asarray(_http(ref.port, '/predict',
                                    {'data': data})['outputs'])
            assert got.shape == want.shape == (1, 4)
            np.testing.assert_allclose(got, want, rtol=0, atol=PREDICT_ATOL)
        prompts = [Dispatcher._generate_payload(rid) for rid in range(6)]
        prompts += [[5, 9, 2, 11, 7, 1, 3, 4]] * 2      # a prefix hit
        for tokens in prompts:
            body = {'tokens': tokens, 'max_new_tokens': port.max_new_tokens}
            assert _ndjson(port.port, body) == _ndjson(ref.port, body)
        pst = port.server_stats()['generate']
        rst = ref.server_stats()['generate']
        assert pst['prefix_hits'] == rst['prefix_hits'] >= 1
        assert {k: pst[k] for k in ('pending', 'active', 'free_slots',
                                    'leaked_slots', 'retired')} == \
            {k: rst[k] for k in ('pending', 'active', 'free_slots',
                                 'leaked_slots', 'retired')}
    finally:
        ref.close()
        if port is not None:
            port.close()


def _settled_stats(rig, budget_s=10.0):
    """``rig.server_stats()`` once its engine has retired every request
    and released its adapter pins, waiting at most ``budget_s``. A stream
    ends (its done line written) before the engine retires the sequence
    and unpins its adapter row, so a read right after the response can
    see the request still active and its row still pinned."""
    deadline = time.monotonic() + budget_s
    while True:
        st = rig.server_stats()
        gen = st['generate']
        if (gen['pending'] == 0 and gen['active'] == 0
                and gen.get('adapters', {}).get('pinned', 0) == 0) \
                or time.monotonic() > deadline:
            return st
        time.sleep(0.01)


def test_server_stats_keys_are_the_references():
    """``server_stats()`` reads the same engine and batcher keys in both
    packages, the adapter pool's among them."""
    from mxnet_tpu.loadgen.harness import ServingRig as RefRig
    ref = RefRig(predict=False, adapter_fleet=2, warmup=False)
    port = None
    try:
        port = carried_rig(ref, predict=False, adapter_fleet=2,
                           warmup=False)
        _ndjson(port.port, {'tokens': [1, 2, 3], 'max_new_tokens': 2,
                            'adapter': 'ad1'})
        _ndjson(ref.port, {'tokens': [1, 2, 3], 'max_new_tokens': 2,
                           'adapter': 'ad1'})
        got, want = _settled_stats(port), _settled_stats(ref)
        assert got.keys() == want.keys()
        assert got['generate'].keys() == want['generate'].keys()
        assert got['generate']['adapters'] == want['generate']['adapters']
        assert got['generate']['sampled_tokens'] == \
            want['generate']['sampled_tokens']
    finally:
        ref.close()
        if port is not None:
            port.close()


def test_cli_writes_the_artifact(tmp_path, capsys):
    """``python -m mxnet_tpu_torch.loadgen --mode disagg``: the traced
    prefill / decode drill over four replicas, every verdict met, the
    artifact written."""
    from mxnet_tpu_torch.loadgen.__main__ import main
    out = tmp_path / 'SLO.json'
    assert main(['--mode', 'disagg', '--device', 'cpu', '--out',
                 str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc['schema'] == SLO_SCHEMA and doc['mode'] == 'disagg'
    assert doc['ok'] and all(doc['verdicts'].values())
    assert doc['verdicts']['trace_complete']
    assert doc['metrics']['trace']['critical_path']['n'] == 8
    assert 'loadgen disagg: OK' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# tests/test_gateway.py's rig drills (slow tier)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def failover_rig():
    from mxnet_tpu_torch.loadgen.harness import GatewayRig
    rig = GatewayRig(replicas=2, health_period_s=0.25, predict=False,
                     slots=4, max_new_tokens=48, decode_max_queue=16,
                     decode_prefill_buckets=(64,), decode_max_len=128,
                     decode_pages=64, device='cpu')
    yield rig
    rig.close()


@pytest.mark.slow
def test_kill_replica_mid_stream_bit_identical(failover_rig):
    """>= 8 concurrent streams, the replica serving them killed
    mid-generation: zero client-visible error lines and every completed
    token stream bit-identical to the unkilled reference run."""
    from mxnet_tpu_torch.loadgen.harness import run_gateway_failover
    doc = run_gateway_failover(failover_rig, streams=8, seed=3)
    v = doc['verdicts']
    assert v['zero_error_lines'], doc['metrics']
    assert v['token_streams_bit_identical'], doc['metrics']
    assert v['indices_contiguous_no_dupes'], doc['metrics']
    assert v['zero_unresolved'], doc['metrics']
    assert v['resume_engaged'], doc['metrics']
    assert doc['metrics']['resumed_streams'] >= 1
    assert doc['metrics']['gateway']['resumes'] >= 1


@pytest.mark.slow
def test_two_tenant_burst_isolation():
    """The burst tenant sheds typed per-tenant 429s with Retry-After
    while the steady tenant rides inside its SLO."""
    from mxnet_tpu_torch.loadgen.harness import GatewayRig, run_tenants
    rig = GatewayRig(replicas=2, health_period_s=0.25, predict=False,
                     slots=4, decode_max_queue=16, device='cpu',
                     gateway_kwargs=dict(tenant_rps=8.0,
                                         tenant_burst=8.0,
                                         tenant_max_inflight=32))
    try:
        doc = run_tenants(rig, duration_s=3.0, seed=2)
        v = doc['verdicts']
        assert v['burst_shed_typed_429'], doc['metrics']['burst']
        assert v['steady_never_shed'], doc['metrics']['steady']
        assert v['burst_retry_after_honored']
        assert v['zero_unresolved']
        tenants = doc['metrics']['gateway']['tenants']
        assert tenants['burst']['shed'], tenants
        assert not tenants['steady']['shed'], tenants
    finally:
        rig.close()
