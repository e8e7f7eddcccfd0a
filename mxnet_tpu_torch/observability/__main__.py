"""Observability self-test of the port, the port of
``mxnet_tpu/observability/__main__.py``, in eight legs:

  1. registry  -- counter / gauge / histogram math, label children,
                  power-of-two bucket placement, snapshot shape,
                  redeclaration-mismatch rejection.
  2. disabled  -- with telemetry off, mutators change nothing and
                  allocate nothing a call (tracemalloc), nor do the flight
                  recorder's ``record``, the serving paths' emit helpers
                  and a step-phase span with the profiler idle.
  2b. trace    -- the request-tracing header round trip, the span
                  buffer's bound and NDJSON drain, and the disabled path
                  allocating nothing a span.
  3. flight    -- ring overflow drops the oldest, a dump round-trips
                  through ``read_flight`` with the v1 schema, a torn tail
                  line is tolerated.
  4. exporters -- Prometheus text parses under the schema check (counter
                  monotonic across scrapes, cumulative histogram buckets
                  ending at the count); the file and JSONL writers; the
                  HTTP server is off by default and serves when asked.

  5. spans     -- a phase span lands in the phase histogram.
  6. train     -- a small ``ParallelTrainer`` run (a 16-16-4 MLP, SGD,
                  4 steps of batch 8, weights drawn with numpy) moves the
                  step, example and compile / step seconds series and
                  records ``step`` flight events. On a card its steps are
                  captured programs: the ``compile`` events are 1 +
                  ``compile_count`` (the first build, then each capture)
                  and ``step_seconds`` counts the rest. The reference's
                  collective-bytes check is its ``dp > 1`` branch, which
                  the one-device port never reaches.
  7. bit_identical -- telemetry on and off train to bit-identical
                  parameters (the instruments live on the host).

Legs 1-5 touch no tensor; legs 6-7 run on ``--device`` (``cuda``, the
default, or ``cpu``). The verdict is the reference's, ``{"ok": ...,
"checks": {leg: "ok" | problem}}``, written to ``--out``; the exit code
is 0 when all eight legs passed, else 1.

Usage::

    python -m mxnet_tpu_torch.observability --device cpu --out OBS.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tracemalloc

FEATURES = 16
CLASSES = 4


def _grew(before, after, impl_files):
    """Bytes and blocks the files ``impl_files`` gained between two
    tracemalloc snapshots."""
    impl = {os.path.abspath(f) for f in impl_files}
    grew = nalloc = 0
    for stat in after.compare_to(before, 'filename'):
        if os.path.abspath(stat.traceback[0].filename) in impl \
                and stat.size_diff > 0:
            grew += stat.size_diff
            nalloc += stat.count_diff
    return grew, nalloc


def check_registry():
    from . import metrics
    reg = metrics.MetricsRegistry()
    c = reg.counter('c_total', help='h')
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5, c.value
    try:
        c.inc(-1)
        return 'negative counter inc not rejected'
    except ValueError:
        pass
    g = reg.gauge('g', labels=('k',))
    g.labels(k='a').set(4)
    g.labels(k='a').inc()
    g.labels(k='b').dec(2)
    assert g.labels(k='a').value == 5.0
    assert g.labels(k='b').value == -2.0
    h = reg.histogram('h_seconds')
    h.observe(1.0)      # an exact power of two lands in le=1.0
    h.observe(0.75)     # in (0.5, 1.0]
    h.observe(1e9)      # the +Inf bucket
    idx_1 = metrics.P2_BOUNDS.index(1.0)
    buckets = h.buckets()
    assert buckets[idx_1] - (buckets[idx_1 - 1] if idx_1 else 0) == 2, \
        'power-of-two placement wrong: %r' % (buckets,)
    assert buckets[-1] == h.count == 3
    assert abs(h.sum - (1.75 + 1e9)) < 1e-3
    try:
        reg.counter('g')        # a type mismatch with the gauge
        return 'metric type mismatch not rejected'
    except ValueError:
        pass
    snap = reg.snapshot()
    # every snapshot carries the process-identity stamp
    assert set(snap) == {'c_total', 'g', 'h_seconds', 'mxnet_tpu_process'}
    stamp = snap['mxnet_tpu_process']['series'][0]['labels']
    assert set(stamp) == {'process_id', 'process_count'}
    assert snap['h_seconds']['series'][0]['buckets'][-1] == 3
    return None


def check_disabled():
    from . import emit, metrics, recorder, spans
    from .. import profiler
    reg = metrics.MetricsRegistry()
    c = reg.counter('d_total')
    g = reg.gauge('d_gauge')
    h = reg.histogram('d_seconds')
    c.inc()
    prev_counter = c.value
    rec = recorder.FlightRecorder(capacity=8, name='selftest')
    metrics.set_enabled(False)
    try:
        def calls():
            c.inc()
            g.set(1.0)
            h.observe(0.5)
            rec.record('step')
            emit.event('step')
            emit.serving()
            with spans.span('step'):
                pass

        for _ in range(4):          # warm any lazy state
            calls()
        tracemalloc.start()
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            calls()
        after = tracemalloc.take_snapshot()
        tracemalloc.stop()
        # the bar is no allocation a CALL: CPython may heap-materialize a
        # frame or two (O(1)), never O(calls)
        grew, nalloc = _grew(before, after, (metrics.__file__,
                                             recorder.__file__,
                                             emit.__file__, spans.__file__,
                                             profiler.__file__))
        if nalloc > 100 or grew > 4096:
            return ('disabled-path mutators allocated %d bytes / %d blocks '
                    'over 7000 calls (per-call allocation)' % (grew, nalloc))
        if c.value != prev_counter or g.value != 0.0 or h.count != 0:
            return 'disabled-path mutators changed metric state'
        if rec.events() or rec.stats()['recorded']:
            return 'disabled recorder recorded'
    finally:
        metrics.set_enabled(None)
    return None


def check_trace():
    from . import trace
    ctx = trace.TraceContext.new()
    hop = trace.parse_header(ctx.to_header())
    if hop is None or hop.trace_id != ctx.trace_id:
        return 'trace header did not round-trip'
    trace.set_enabled(True)
    try:
        buf = trace.SpanBuffer(capacity=4, site='selftest')
        root = ctx.child()
        buf.emit('gw.request', root, 0.0, 1.0)
        for _ in range(6):
            with buf.span('gw.relay', root):
                pass
        st = buf.stats()
        if st['buffered'] != 4 or st['dropped'] != 3:
            return 'buffer bound broken: %r' % (st,)
        if len(trace.read_ndjson(buf.ndjson())) != 4:
            return 'ndjson drain lost records'
    finally:
        trace.set_enabled(None)
    trace.set_enabled(False)
    try:
        buf = trace.SpanBuffer(capacity=4, site='selftest')
        for _ in range(4):                    # warm lazy state
            with buf.span('x', ctx):
                pass
            buf.emit('y', ctx.child(), 0.0, 1.0)
        tracemalloc.start()
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with buf.span('x', ctx):
                pass
        after = tracemalloc.take_snapshot()
        tracemalloc.stop()
        grew, nalloc = _grew(before, after, (trace.__file__,))
        if nalloc > 100 or grew > 4096:
            return ('disabled-path spans allocated %d bytes / %d blocks over '
                    '1000 calls (per-call allocation)' % (grew, nalloc))
        if buf.read() or buf.stats()['emitted'] != 0:
            return 'disabled-path spans reached the buffer'
    finally:
        trace.set_enabled(None)
    return None


def check_flight(tmpdir):
    from .recorder import FLIGHT_SCHEMA, FlightRecorder, read_flight
    rec = FlightRecorder(capacity=8, name='selftest')
    rec.set_enabled(True)
    for i in range(20):
        rec.record('step', step=i)
    rec.record('stall', step=19, phase='step')
    events = rec.events()
    assert len(events) == 8, len(events)
    assert events[-1]['kind'] == 'stall'
    assert events[0]['step'] == 13       # the oldest 13 of 21 dropped
    path = os.path.join(tmpdir, 'FLIGHT.jsonl')
    assert rec.dump(path=path, reason='selftest') == path
    header, parsed = read_flight(path)
    assert header['schema'] == FLIGHT_SCHEMA
    assert header['dropped'] == 13 and header['events'] == 8
    assert [e['kind'] for e in parsed] == [e['kind'] for e in events]
    with open(path, 'a') as f:          # a torn tail line
        f.write('{"kind": "trunc')
    _header2, parsed2 = read_flight(path)
    assert len(parsed2) == 8
    return None


def check_exporters(tmpdir):
    import urllib.request

    from . import export, metrics
    c = metrics.counter('selftest_requests_total', help='n')
    h = metrics.histogram('selftest_latency_seconds', labels=('path',))
    c.inc(3)
    h.labels(path='/a').observe(0.1)
    h.labels(path='/a').observe(0.2)
    text1 = export.prometheus_text()
    types, samples1 = export.parse_prometheus(text1)
    assert types['selftest_requests_total'] == 'counter'
    assert types['selftest_latency_seconds'] == 'histogram'
    c.inc(2)
    _, samples2 = export.parse_prometheus(export.prometheus_text())

    def sample(samples, name, **labels):
        for n, lab, v in samples:
            if n == name and all(lab.get(k) == v2
                                 for k, v2 in labels.items()):
                return v
        raise AssertionError('sample %s%r missing' % (name, labels))

    v1 = sample(samples1, 'selftest_requests_total')
    v2 = sample(samples2, 'selftest_requests_total')
    assert v2 > v1, 'counter not monotonic (%r -> %r)' % (v1, v2)
    buckets = [(lab['le'], v) for n, lab, v in samples1
               if n == 'selftest_latency_seconds_bucket'
               and lab.get('path') == '/a']
    vals = [v for _, v in buckets]
    assert vals == sorted(vals), 'buckets not cumulative'
    count = sample(samples1, 'selftest_latency_seconds_count', path='/a')
    assert buckets[-1][0] == '+Inf' and buckets[-1][1] == count == 2
    ssum = sample(samples1, 'selftest_latency_seconds_sum', path='/a')
    assert abs(ssum - 0.3) < 1e-9
    p = export.write_prometheus(os.path.join(tmpdir, 'metrics.prom'))
    with open(p) as f:
        export.parse_prometheus(f.read())
    export.write_jsonl(os.path.join(tmpdir, 'metrics.jsonl'),
                       snapshot=metrics.snapshot())
    with open(os.path.join(tmpdir, 'metrics.jsonl')) as f:
        for ln in f:
            json.loads(ln)
    assert export.maybe_start_http_server() is None, \
        'HTTP server started without MXNET_TPU_TELEMETRY_HTTP_PORT'
    with export.PrometheusServer(0) as srv:
        body = urllib.request.urlopen(
            'http://127.0.0.1:%d/metrics' % srv.port, timeout=5).read()
    export.parse_prometheus(body.decode())
    return None


def check_spans():
    from . import spans
    child = spans.phase_histogram('sync')
    before = child.count
    with spans.span('sync'):
        pass
    assert child.count == before + 1, 'span did not record'
    return None


def _mlp_trainer(device, seed):
    """A Dense(16, relu) -> Dense(4) MLP over 16 features, its weights
    drawn with numpy from ``seed`` (Xavier's uniform range), behind a
    one-device ``ParallelTrainer`` (softmax cross-entropy, SGD lr 0.1);
    and a batch of 8 from the same seed."""
    import numpy as np
    import torch
    from ..gluon import loss as gloss
    from ..gluon import nn
    from ..parallel import ParallelTrainer
    rs = np.random.RandomState(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation='relu', in_units=FEATURES,
                     prefix='dense0_', device=device),
            nn.Dense(CLASSES, in_units=16, prefix='dense1_', device=device))
    with torch.no_grad():
        for name, p in net.collect_params().tensors().items():
            if name.endswith('weight'):
                s = np.sqrt(6.0 / sum(p.shape))
                p.copy_(torch.from_numpy(
                    rs.uniform(-s, s, p.shape).astype('float32')))
    pt = ParallelTrainer(net, gloss.SoftmaxCrossEntropyLoss(), 'sgd',
                         {'learning_rate': 0.1}, seed=seed)
    x = torch.tensor(rs.randn(8, FEATURES).astype('float32'), device=device)
    y = torch.tensor(rs.randint(0, CLASSES, (8,)).astype('float32'),
                     device=device)
    return net, pt, x, y


def check_train(device):
    from . import get_recorder, trainer_instruments
    net, pt, x, y = _mlp_trainer(device, 7)
    inst = trainer_instruments()
    steps0, examples0 = inst.steps.value, inst.examples.value
    compile0, step0 = inst.compile_seconds.count, inst.step_seconds.count
    get_recorder().clear()
    nsteps = 4
    for _ in range(nsteps):
        pt.step(x, y)
    assert inst.steps.value == steps0 + nsteps
    assert inst.examples.value == examples0 + nsteps * 8
    assert inst.compile_seconds.count > compile0, \
        'first-step compile not recorded'
    assert inst.step_seconds.count - step0 >= nsteps - 1 - pt.compile_count
    kinds = [e['kind'] for e in get_recorder().events()]
    assert kinds.count('step') >= nsteps, kinds[-10:]
    # the port's own counts: the first build, then a capture a signature
    # on a card (none on the CPU)
    builds = 1 + pt.compile_count
    assert kinds.count('compile') == builds, (kinds, pt.compile_count)
    assert inst.compile_seconds.count - compile0 == builds
    assert inst.step_seconds.count - step0 == nsteps - builds
    return None


def check_bit_identical(device):
    """Telemetry on and off train to bit-identical parameters: the
    instruments live on the host dispatch path, the step is the same."""
    import hashlib
    import numpy as np
    from . import metrics as _metrics

    def run(enabled):
        _metrics.set_enabled(enabled)
        try:
            net, pt, x, y = _mlp_trainer(device, 5)
            for _ in range(5):
                pt.step(x, y)
            h = hashlib.sha256()
            for name, p in sorted(net.collect_params().tensors().items()):
                h.update(np.ascontiguousarray(
                    p.detach().cpu().numpy(), dtype='<f4').tobytes())
            return h.hexdigest()
        finally:
            _metrics.set_enabled(None)

    on, off = run(True), run(False)
    if on != off:
        return ('telemetry changed training numerics: on=%s off=%s'
                % (on[:12], off[:12]))
    return None


def run_legs(tmpdir, device):
    """``{leg: 'ok' | problem}``, each leg printed as it ends."""
    checks = {}
    legs = [('registry', check_registry),
            ('disabled', check_disabled),
            ('trace', check_trace),
            ('flight', lambda: check_flight(tmpdir)),
            ('exporters', lambda: check_exporters(tmpdir)),
            ('spans', check_spans),
            ('train', lambda: check_train(device)),
            ('bit_identical', lambda: check_bit_identical(device))]
    for name, fn in legs:
        try:
            problem = fn()
        except Exception as exc:
            import traceback
            traceback.print_exc()
            problem = '%s: %s' % (type(exc).__name__, exc)
        checks[name] = problem or 'ok'
        print('selftest %-13s %s' % (name, checks[name]), flush=True)
    return checks


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m mxnet_tpu_torch.observability',
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--out', default='OBS_SELFTEST.json')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                   help='where the train and bit_identical legs run')
    args = p.parse_args(argv)
    from ..context import resolve_device
    device = resolve_device(args.device)

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        checks = run_legs(tmp, device)
    ok = all(v == 'ok' for v in checks.values())
    verdict = {'ok': ok, 'checks': checks}
    from ..resilience.checkpoint import atomic_write_bytes
    atomic_write_bytes(args.out, (json.dumps(
        verdict, indent=1, sort_keys=True) + '\n').encode())
    print('selftest: %s -> %s' % ('OK' if ok else 'FAIL', args.out),
          flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
