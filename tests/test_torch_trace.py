"""Port parity of request tracing and the metrics exposition
(``mxnet_tpu_torch/observability/trace.py``, ``metrics.py``,
``export.py``) against the JAX package's.

The 15 tests of ``tests/test_trace.py`` run against the port: their
module's ``trace`` is the port's and their gateway the port's
``ServingGateway`` (10 pure tests: the header round trip, malformed
headers, the buffer's bounds and NDJSON cursor, the disabled no-op,
stitch / verdict / skew / TTFT decomposition / critical path; 5 over the
reference's fake NDJSON replicas: one trace id across relay, failover
resume and the prefill / decode handoff, ``GET /trace`` and the
tracing-off stream). Then one synthetic span set through both packages'
``stitch``, ``tree_verdict``, ``normalize_skew``, ``waterfall``,
``decompose_ttft`` and ``critical_path``, and one set of series through
both packages' registries and ``prometheus_text``: equal outputs.
"""
import copy
import inspect
import json

import pytest

import test_trace as tt
from mxnet_tpu.observability import export as jax_export
from mxnet_tpu.observability import metrics as jax_metrics
from mxnet_tpu.observability import trace as jax_trace
from mxnet_tpu_torch.observability import export as port_export
from mxnet_tpu_torch.observability import metrics as port_metrics
from mxnet_tpu_torch.observability import trace as port_trace
from mxnet_tpu_torch.serving import gateway as port_gw

PURE = ('test_header_round_trip',
        'test_buffer_bounds_drop_oldest',
        'test_buffer_ndjson_round_trip_and_torn_line',
        'test_disabled_path_is_a_shared_noop',
        'test_enabled_span_with_none_ctx_is_noop',
        'test_stitch_complete_tree_and_verdict',
        'test_stitch_orphan_and_multi_root_fail_verdict',
        'test_normalize_skew_pulls_remote_site_into_root_timeline',
        'test_ttft_decomposition_and_critical_path')
MALFORMED = 'test_malformed_header_is_none_not_an_error'
OVER_FAKES = ('test_gateway_propagates_trace_and_emits_request_tree',
              'test_failover_resume_propagates_same_trace_id',
              'test_disagg_handoff_propagates_same_trace_id',
              'test_gateway_trace_endpoint_drains_with_cursor',
              'test_tracing_off_forwards_nothing_and_streams_identically')
# the reference's parameters of the malformed-header test
BAD_HEADERS = [None, '', 'garbage', '00-abc',
               '00-%s-%s' % ('a' * 32, 'b' * 16), '00-zz-yy-01',
               '00-' + 'g' * 32 + '-' + 'b' * 16 + '-01']


def test_every_reference_trace_test_is_mirrored():
    names = {n for n, f in vars(tt).items()
             if n.startswith('test_') and inspect.isfunction(f)}
    assert len(PURE) + 1 + len(OVER_FAKES) == 15
    assert names == set(PURE) | {MALFORMED} | set(OVER_FAKES)


@pytest.fixture()
def on_port(monkeypatch):
    """The reference test module with the port's trace module and
    gateway; the port's trace flag back to its knob afterwards."""
    monkeypatch.setattr(tt, 'trace', port_trace)
    monkeypatch.setattr(tt, 'ServingGateway', port_gw.ServingGateway)
    yield
    port_trace.set_enabled(None)


def _run(name, **given):
    fn = getattr(tt, name)
    args, teardown = [], []
    for param in inspect.signature(fn).parameters:
        if param in given:
            args.append(given[param])
            continue
        port_trace.set_enabled(True)       # the reference's ``traced``
        if param == 'traced':
            args.append(None)
            continue
        assert param == 'fake_pair', param
        a, b = tt._Fake(), tt._Fake()
        gw = port_gw.ServingGateway([a.url, b.url], port=0,
                                    health_period_s=30.0, timeout_s=5.0,
                                    resume=True, resume_max=2,
                                    affinity=True).start()
        args.append((gw, {a.url: a, b.url: b}))
        teardown += [gw.stop, a.close, b.close]
    try:
        fn(*args)
    finally:
        for stop in teardown:
            stop()
        port_trace.set_enabled(None)


@pytest.mark.parametrize('name', PURE + OVER_FAKES)
def test_reference_trace_test_on_the_port(name, on_port):
    _run(name)


@pytest.mark.parametrize('bad', BAD_HEADERS)
def test_malformed_header_on_the_port(bad, on_port):
    _run(MALFORMED, bad=bad)


def _span(site, tid, span, parent, name, t0, t1, **attrs):
    rec = {'site': site, 'trace': tid, 'span': span, 'parent': parent,
           'name': name, 't0': t0, 't1': t1}
    if attrs:
        rec['attrs'] = attrs
    return rec


def _synthetic():
    """Two traces over three sites with skewed clocks: a disaggregated
    request (prefill replica, handoff, decode replica) and a plain one
    with a torn buffer (an orphan)."""
    a, b = 'a' * 32, 'b' * 32
    return [
        _span('gateway', a, 'g1', None, 'gw.request', 10.0, 12.0),
        _span('gateway', a, 'g2', 'g1', 'gw.route', 10.0, 10.01),
        _span('gateway', a, 'g3', 'g1', 'gw.relay', 10.01, 10.6),
        _span('r1', a, 'p1', 'g3', 'eng.queue_wait', 50.02, 50.05),
        _span('r1', a, 'p2', 'g3', 'eng.prefill', 50.05, 50.4),
        _span('gateway', a, 'g4', 'g1', 'gw.handoff', 10.6, 10.9),
        _span('r2', a, 'd0', 'g4', 'eng.import', -3.3, -3.2),
        _span('r2', a, 'd1', 'g4', 'eng.first_token', -3.2, -3.15),
        _span('r2', a, 'd2', 'g4', 'eng.steps', -3.15, -2.0, steps=20),
        _span('gateway', a, 'g5', 'g1', 'gw.splice', 10.9, 10.9,
              kind='handoff'),
        _span('gateway', b, 'h1', None, 'gw.request', 20.0, 20.5),
        _span('gateway', b, 'h2', 'h1', 'gw.relay', 20.01, 20.49),
        _span('r1', b, 'q1', 'h2', 'eng.prefill', 60.1, 60.2),
        _span('r1', b, 'q2', 'h2', 'eng.first_token', 60.2, 60.21),
        _span('r1', b, 'q3', 'zz', 'eng.steps', 60.21, 60.4, steps=4),
        _span('r1', b, 'q3', 'h2', 'eng.steps', 60.21, 60.4, steps=4),
    ]


def _analysis(mod, records):
    lines = (''.join(json.dumps(r) + '\n' for r in records)
             + '{"torn": ').encode()
    trees = mod.stitch(mod.read_ndjson(lines))
    out = {}
    for tid, tree in sorted(trees.items()):
        verdict = mod.tree_verdict(tree)
        offsets = mod.normalize_skew(tree)
        out[tid] = dict(tree=copy.deepcopy(tree), verdict=verdict,
                        offsets=offsets, waterfall=mod.waterfall(tree),
                        ttft=mod.decompose_ttft(tree))
    out['critical_path'] = mod.critical_path(list(trees.values()))
    return out


def test_stitch_and_critical_path_agree():
    got = _analysis(port_trace, _synthetic())
    want = _analysis(jax_trace, _synthetic())
    assert got == want
    assert got['a' * 32]['verdict'] is True
    assert got['a' * 32]['ttft'] is not None
    assert got['critical_path']['n'] == 2


def _series(mod):
    reg = mod.MetricsRegistry()
    reg.counter('mxnet_tpu_gateway_requests_total', help='requests').inc(3)
    fam = reg.counter('mxnet_tpu_gateway_tenant_rejected_total',
                      help='per-tenant\nrejections',
                      labels=('tenant', 'reason'))
    fam.labels(tenant='burst', reason='rate_limit').inc(7)
    fam.labels(tenant='a"b\\c', reason='fair_share').inc()
    reg.gauge('mxnet_tpu_gateway_healthy_replicas').set(2)
    hist = reg.histogram('mxnet_tpu_gateway_handoff_seconds', help='s')
    for v in (0.0, 1e-6, 2 ** -17, 0.003, 0.25, 0.5, 1.0, 3.0, 1e4):
        hist.observe(v)
    return reg.snapshot()


def test_prometheus_text_agrees(monkeypatch):
    """One set of series through both registries: the snapshots, their
    exposition and its parse are equal."""
    for mod in (port_metrics, jax_metrics):
        monkeypatch.setattr(mod._state, 'enabled', True)
    got, want = _series(port_metrics), _series(jax_metrics)
    assert got == want
    text = port_export.prometheus_text(got)
    assert text == jax_export.prometheus_text(want)
    assert port_export.parse_prometheus(text) == \
        jax_export.parse_prometheus(text)
    assert 'mxnet_tpu_gateway_handoff_seconds_bucket{le="+Inf"} 9' in text
