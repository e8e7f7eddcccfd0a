"""Port parity of the telemetry core (``mxnet_tpu_torch/observability``):
the flight recorder, the instrument bags, the exporters, the self-test
CLI and the watchdog's and preemption handler's telemetry, against the
JAX package's (``mxnet_tpu/observability``, ``mxnet_tpu/resilience``), on
the CPU.

The twins of ``tests/test_observability.py``'s recorder and exporter
tests run on the port's modules. Beside them: every series the
reference's ``serving_instruments``, ``trainer_instruments`` and
``gateway_instruments`` declare has the port's name, type, help and
labels; the same events dumped by both recorders under one clock are the
same bytes; a scripted watchdog stall and a preemption exit record the
same events through both packages and dump the ring with the reference's
reason; the heartbeat gauge follows the port's idle rule (an idle
watchdog reads 0, only an armed heartbeat ages); the self-test's eight
legs pass on the CPU.
"""
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from mxnet_tpu import observability as jax_obs
from mxnet_tpu.observability import recorder as jax_recorder
from mxnet_tpu.resilience import policy as jax_policy
from mxnet_tpu.resilience import preempt as jax_preempt
from mxnet_tpu.resilience import watchdog as jax_watchdog
from mxnet_tpu_torch import observability as obs
from mxnet_tpu_torch.observability import (__main__ as cli, emit, export,
                                           metrics, recorder)
from mxnet_tpu_torch.resilience import policy as port_policy
from mxnet_tpu_torch.resilience import preempt as port_preempt
from mxnet_tpu_torch.resilience import watchdog as port_watchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _telemetry_on():
    """The master switches of both packages on, whatever the environment,
    and both process recorders as they were, after."""
    metrics.set_enabled(True)
    jax_obs.set_enabled(True)
    saved = [(r, r.path, r.name, r.capacity, r._enabled)
             for r in (recorder.get_recorder(), jax_recorder.get_recorder())]
    yield
    metrics.set_enabled(None)
    jax_obs.set_enabled(None)
    for rec, path, name, capacity, enabled in saved:
        rec.path, rec.name, rec._enabled = path, name, enabled
        if rec.capacity != capacity:
            rec.capacity = capacity
            rec._ring = type(rec._ring)(rec._ring, maxlen=capacity)


# -- the flight recorder -------------------------------------------------------

def test_flight_ring_bounds_and_dump(tmp_path):
    rec = recorder.FlightRecorder(capacity=4, name='t')
    rec.set_enabled(True)
    for i in range(10):
        rec.record('step', step=i)
    evs = rec.events()
    assert [e['step'] for e in evs] == [6, 7, 8, 9]
    assert rec.stats() == {'capacity': 4, 'recorded': 10, 'kept': 4,
                           'dropped': 6, 'dumps': 0}
    path = str(tmp_path / 'F.jsonl')
    assert rec.dump(path=path, reason='unit') == path
    header, events = recorder.read_flight(path)
    assert header['schema'] == obs.FLIGHT_SCHEMA == 'mxnet_tpu.flight.v1'
    assert header['dropped'] == 6 and header['events'] == 4
    assert header['reason'] == 'unit' and header['name'] == 't'
    assert events[-1] == evs[-1]
    with open(path) as f:
        for ln in f.read().splitlines():
            json.loads(ln)
    assert rec.stats()['dumps'] == 1


def test_flight_read_rejects_wrong_schema(tmp_path):
    p = tmp_path / 'bad.jsonl'
    p.write_text('{"schema": "nope"}\n')
    with pytest.raises(ValueError):
        recorder.read_flight(str(p))
    (tmp_path / 'empty.jsonl').write_text('')
    with pytest.raises(ValueError):
        recorder.read_flight(str(tmp_path / 'empty.jsonl'))


def test_flight_disabled_records_and_dumps_nothing(tmp_path):
    rec = recorder.FlightRecorder(capacity=4)
    rec.set_enabled(False)
    rec.record('step', step=1)
    assert rec.events() == []
    assert rec.dump(path=str(tmp_path / 'x.jsonl')) is None
    assert not (tmp_path / 'x.jsonl').exists()
    # the master switch wins over the recorder's own
    rec.set_enabled(True)
    metrics.set_enabled(False)
    rec.record('step', step=2)
    assert rec.events() == [] and rec.dump(str(tmp_path / 'y')) is None


def test_flight_excepthook_dumps_on_crash(tmp_path):
    path = tmp_path / 'C.jsonl'
    code = ('import sys; sys.path.insert(0, %r)\n'
            'from mxnet_tpu_torch.observability import recorder\n'
            'recorder.configure_flight(path=%r)\n'
            'recorder.install_excepthook()\n'
            'recorder.record_event("step", step=3)\n'
            'raise RuntimeError("boom")\n' % (ROOT, str(path)))
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and 'boom' in r.stderr
    header, events = recorder.read_flight(str(path))
    assert header['reason'] == 'crash'
    assert [e['kind'] for e in events] == ['step', 'crash']
    assert 'boom' in events[-1]['error']


def test_flight_rank_suffix_is_the_references():
    for args in (('FLIGHT.jsonl', 0, 1), ('FLIGHT.jsonl', 1, 2),
                 ('/x/F', 3, 4), ('a.b.jsonl', 0, 2)):
        assert recorder._rank_suffixed(*args) == \
            jax_recorder._rank_suffixed(*args)
    assert recorder._rank_suffixed('FLIGHT.jsonl', 1, 2) == 'FLIGHT.r1.jsonl'


class _Clock:
    """A time module whose clocks stand still."""

    @staticmethod
    def time():
        return 1700000000.25

    @staticmethod
    def monotonic():
        return 12.5


def test_flight_artifact_bytes_are_the_references(tmp_path, monkeypatch):
    """The same events through both recorders, under one frozen clock: the
    same header and event lines, byte for byte."""
    blobs = []
    for mod in (jax_recorder, recorder):
        monkeypatch.setattr(mod, 'time', _Clock)
        rec = mod.FlightRecorder(capacity=3, name='serve', clock=_Clock.time)
        rec.set_enabled(True)
        for i in range(5):
            rec.record('decode_admit', slot=i % 2, prompt_len=7 + i,
                       prefix_tokens=0)
        rec.record('breaker_open', step=4, error='DeviceLossError: x')
        path = str(tmp_path / ('%s.jsonl' % mod.__name__))
        assert rec.dump(path=path, reason='breaker') == path
        with open(path, 'rb') as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]
    assert blobs[1].count(b'\n') == 4


def test_configure_flight_resizes_and_renames(tmp_path):
    rec = recorder.configure_flight(path=str(tmp_path / 'G.jsonl'),
                                    capacity=3, name='unit', enabled=True)
    assert rec is recorder.get_recorder()
    for i in range(5):
        recorder.record_event('unit_evt', i=i)
    assert [e['i'] for e in rec.events()] == [2, 3, 4]
    path = recorder.flight_dump(reason='manual')
    assert path == str(tmp_path / 'G.jsonl')
    header, _ = recorder.read_flight(path)
    assert header['name'] == 'unit' and header['capacity'] == 3


# -- the instrument bags --------------------------------------------------------

BAGS = ('serving_instruments', 'trainer_instruments', 'gateway_instruments')


def _declared(bag):
    return {attr: (fam.name, fam.type, fam.help, tuple(fam.label_names))
            for attr, fam in vars(bag).items()}


@pytest.mark.parametrize('bag', BAGS)
def test_every_series_is_the_references(bag):
    """Name, type, help and labels of every series the bag declares, read
    from both packages' registries."""
    want = _declared(getattr(jax_obs, bag)())
    got = _declared(getattr(obs, bag)())
    assert got == want
    reg = {f.name: f for f in metrics.get_registry().families()}
    for name, typ, help_, labels in got.values():
        fam = reg[name]
        assert (fam.type, fam.help, tuple(fam.label_names)) == \
            (typ, help_, labels)


def test_serving_bag_is_whole():
    assert len(vars(obs.serving_instruments())) == 32 == \
        len(vars(jax_obs.serving_instruments()))
    assert set(obs.__all__) >= {
        'FLIGHT_SCHEMA', 'FlightRecorder', 'get_recorder', 'record_event',
        'flight_dump', 'configure_flight', 'install_excepthook',
        'read_flight', 'write_prometheus', 'write_jsonl',
        'PrometheusServer', 'maybe_start_http_server', 'summary',
        'serving_instruments', 'trainer_instruments'}


def test_summary_has_the_references_keys():
    obs.serving_instruments().tokens.inc(3)
    got, want = obs.summary(), jax_obs.summary()
    assert set(got) == set(want) == {'enabled', 'flight', 'trace',
                                     'metrics'}
    assert set(got['flight']) == set(want['flight'])
    tok = got['metrics']['mxnet_tpu_serve_tokens_total']
    assert tok['type'] == 'counter' and tok['series'][0]['value'] >= 3
    lat = got['metrics']['mxnet_tpu_serve_ttft_seconds']
    assert lat['type'] == 'histogram' and 'avg' in lat['series'][0]


def test_emit_helpers_are_silent_while_off():
    metrics.set_enabled(False)
    assert emit.serving() is None
    n = recorder.get_recorder().stats()['recorded']
    emit.event('unit_off', a=1)
    emit.dump('unit')
    assert recorder.get_recorder().stats()['recorded'] == n
    metrics.set_enabled(True)
    assert emit.serving() is obs.serving_instruments()


# -- exporters ---------------------------------------------------------------------

def test_prometheus_schema_counter_monotonic_and_buckets():
    c = obs.counter('unit_req_total', help='n')
    h = obs.histogram('unit_lat_seconds', labels=('path',))
    c.inc(2)
    h.labels(path='/x').observe(0.125)
    h.labels(path='/x').observe(0.25)
    types, s1 = export.parse_prometheus(export.prometheus_text())
    assert types['unit_req_total'] == 'counter'
    assert types['unit_lat_seconds'] == 'histogram'
    c.inc()
    _, s2 = export.parse_prometheus(export.prometheus_text())

    def get(samples, name, **labels):
        return [v for n, lab, v in samples if n == name
                and all(lab.get(k) == vv for k, vv in labels.items())]

    assert get(s2, 'unit_req_total')[0] > get(s1, 'unit_req_total')[0]
    buckets = [(lab['le'], v) for n, lab, v in s1
               if n == 'unit_lat_seconds_bucket' and lab.get('path') == '/x']
    vals = [v for _, v in buckets]
    assert vals == sorted(vals), 'buckets must be cumulative'
    assert buckets[-1][0] == '+Inf'
    assert buckets[-1][1] == get(s1, 'unit_lat_seconds_count',
                                 path='/x')[0] == 2
    assert get(s1, 'unit_lat_seconds_sum', path='/x')[0] == \
        pytest.approx(0.375)


def test_prometheus_text_is_the_references():
    """One snapshot rendered by both packages' exporters."""
    reg = metrics.MetricsRegistry()
    reg.counter('a_total', help='x "y"\nz', labels=('k',)).labels(
        k='q"1').inc(2)
    reg.histogram('b_seconds').observe(0.3)
    reg.gauge('c').set(-1.5)
    snap = reg.snapshot()
    assert export.prometheus_text(snap) == \
        jax_obs.export.prometheus_text(snap)


def test_http_server_off_by_default_and_serves_when_asked(monkeypatch):
    monkeypatch.delenv('MXNET_TPU_TELEMETRY_HTTP_PORT', raising=False)
    assert export.maybe_start_http_server() is None
    monkeypatch.setenv('MXNET_TPU_TELEMETRY_HTTP_PORT', '0')
    assert export.maybe_start_http_server() is None
    obs.counter('http_unit_total').inc()
    with export.PrometheusServer(0) as srv:
        assert srv.port > 0 and srv.host == '127.0.0.1'
        body = urllib.request.urlopen(
            'http://127.0.0.1:%d/metrics' % srv.port, timeout=10
        ).read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen('http://127.0.0.1:%d/other' % srv.port,
                                   timeout=10)
    export.parse_prometheus(body)
    assert 'http_unit_total' in body


def test_write_prometheus_and_jsonl(tmp_path):
    obs.counter('file_unit_total').inc()
    p = export.write_prometheus(str(tmp_path / 'm.prom'))
    with open(p) as f:
        export.parse_prometheus(f.read())
    j = export.write_jsonl(str(tmp_path / 'm.jsonl'), extra={'run': 1})
    with open(j) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[-1] == {'run': 1}
    assert any(d.get('name') == 'file_unit_total' for d in lines)


# -- the self-test ---------------------------------------------------------------------

def test_selftest_legs_one_to_four_pass(tmp_path, capsys):
    """Legs 1-4 pass, and since the training telemetry was ported so do
    5-7 (spans, train, bit_identical), on the CPU: eight legs, none
    skipped."""
    out = str(tmp_path / 'OBS.json')
    assert cli.main(['--out', out, '--device', 'cpu']) == 0
    with open(out) as f:
        verdict = json.load(f)
    assert verdict['ok'] is True
    checks = verdict['checks']
    for leg in ('registry', 'disabled', 'trace', 'flight', 'exporters'):
        assert checks[leg] == 'ok', (leg, checks[leg])
    for leg in ('spans', 'train', 'bit_identical'):
        assert checks[leg] == 'ok', (leg, checks[leg])
    assert len(checks) == 8
    assert 'selftest: OK' in capsys.readouterr().out


# -- the watchdog and the preemption handler ------------------------------------------

def _flight_of(mod, path):
    rec = mod.get_recorder()
    rec.clear()
    mod.configure_flight(path=path, enabled=True)
    return rec


def _kinds_fields(events, drop=('ts', 'mono')):
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def test_watchdog_stall_records_and_dumps_as_the_reference(tmp_path):
    """Beats, then a check past the budget: both packages record the
    heartbeats then the stall, and dump the ring with reason 'stall'."""
    got = {}
    for name, wd_mod, rec_mod in (('jax', jax_watchdog, jax_recorder),
                                  ('port', port_watchdog, recorder)):
        path = str(tmp_path / ('%s.jsonl' % name))
        _flight_of(rec_mod, path)
        fake = [100.0]
        wd = wd_mod.Watchdog(budgets={'step': 50.0}, clock=lambda: fake[0],
                             artifact_path=str(tmp_path / 'S.json'))
        for step in range(3):
            wd.beat(step=step, phase='step')
        fake[0] = 160.0
        with pytest.raises(Exception) as info:
            wd.check()
        assert type(info.value).__name__ == 'TunnelStallError'
        header, events = rec_mod.read_flight(path)
        assert header['reason'] == 'stall'
        got[name] = _kinds_fields(events)
    assert got['port'] == got['jax']
    assert [e['kind'] for e in got['port']] == ['watchdog_heartbeat'] * 3 \
        + ['stall']
    assert got['port'][-1] == {'kind': 'stall', 'phase': 'step', 'step': 2,
                               'waited_s': 60.0, 'budget_s': 50.0,
                               'process_id': 0}


def test_heartbeat_age_gauge_follows_the_idle_rule():
    """The reference's gauge test, then the port's rule: ``idle()``
    disarms the heartbeat and reads 0; an idle watchdog never ages."""
    fake = [100.0]
    wd = port_watchdog.Watchdog(budgets={'step': 50.0},
                                clock=lambda: fake[0])
    age = obs.trainer_instruments().heartbeat_age
    wd.beat(step=1, phase='step')
    assert age.value == 0.0
    fake[0] = 130.0
    assert wd.stalled() is None
    assert age.value == pytest.approx(30.0)
    wd.idle()
    assert age.value == 0.0
    fake[0] = 1000.0                       # idle for ages: no stall
    assert wd.stalled() is None and age.value == 0.0
    wd.check()                             # nothing armed: no raise
    wd.beat(step=2)
    fake[0] = 1010.0
    assert wd.stalled() is None and age.value == pytest.approx(10.0)


def test_monitor_thread_stall_dumps_the_ring(tmp_path):
    path = str(tmp_path / 'M.jsonl')
    _flight_of(recorder, path)
    seen = []
    wd = port_watchdog.Watchdog(budgets={'infer': 0.05}, poll_s=0.02,
                                on_stall=seen.append)
    wd.beat(step=7, phase='infer')
    wd.start()
    try:
        import time
        deadline = time.monotonic() + 10
        while not seen and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        wd.stop()
    assert seen and seen[0]['step'] == 7
    header, events = recorder.read_flight(path)
    assert header['reason'] == 'stall'
    kinds = [e['kind'] for e in events]
    assert kinds.index('watchdog_heartbeat') < kinds.index('stall')


def test_preempt_events_and_exit_dump_as_the_reference(tmp_path):
    """A scripted preempt at step 2, the drain's save and the exit: the
    same events through both handlers, and the exit dumps with reason
    'preempt' before it raises."""
    got = {}
    for name, pre, pol, rec_mod in (
            ('jax', jax_preempt, jax_policy, jax_recorder),
            ('port', port_preempt, port_policy, recorder)):
        path = str(tmp_path / ('%s.jsonl' % name))
        _flight_of(rec_mod, path)
        h = pre.PreemptionHandler(
            injector=pol.FaultInjector('preempt@train.step.2'))
        flags = [h.check(step) for step in range(4)]
        assert flags == [False, False, True, True]
        h.drain(lambda: 'ckpt-2')
        with pytest.raises(pre.Preempted) as info:
            h.exit(step=2)
        assert info.value.code == 75
        header, events = rec_mod.read_flight(path)
        assert header['reason'] == 'preempt'
        got[name] = _kinds_fields(events)
    assert got['port'] == got['jax']
    assert [e['kind'] for e in got['port']] == ['preempt', 'preempt_exit']
    assert got['port'][-1]['checkpoint'] == 'ckpt-2'
    assert got['port'][-1]['exit_code'] == 75
