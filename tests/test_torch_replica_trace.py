"""Port parity of the replica's half of request tracing: the ``srv.*``
spans of ``mxnet_tpu_torch.serving.ServingHTTPServer`` and the ``eng.*``
spans of its ``DecodeEngine``, against the JAX package's
(``mxnet_tpu/serving/server.py:538-541, 603-626, 880-900``,
``mxnet_tpu/serving/decode/engine.py:422-437``), on the CPU.

Each package's load-harness rig (a frozen MLP behind ``/predict``, a paged
decode LM behind ``/generate``; the port's on the reference's weights)
serves the same traced requests: a prefill, a prefix hit, a
``prefill_only`` export and its ``/import``, a ``/predict`` and a ``GET
/drain``. What is held:

  * each request's spans in the replica's buffer: names, parentage and
    attributes (``ttft_s`` a non-negative number on both sides) equal to
    the reference's, the ``eng.*`` spans nested under the handler's span,
    which is the client's root (a bare ``X-Mxnet-Trace`` identity);
  * ``GET /trace?since=`` the reference's cursor behaviour;
  * with tracing off, a request carrying the header leaves no span and no
    context, and streams what a traced one streams;
  * through the port's ``ServingGateway`` and two port replicas (prefill
    and decode classes), the stitched tree is one and complete, and
    ``decompose_ttft`` reads its engine phases.
"""
import json
import time
import urllib.request
from unittest import mock

import pytest
import torch
from test_torch_loadgen import carried_rig

from mxnet_tpu.observability import trace as ref_trace
from mxnet_tpu_torch.observability import trace

torch.set_num_threads(1)

HTTP_S = 30
SPAN_WAIT_S = 10.0
PROMPT = [5, 9, 2, 11, 7, 1, 3, 4]      # a whole page: a later hit
# each request, and the spans the replica emits for it
REQUESTS = (
    ('prefill', '/generate', {'tokens': PROMPT, 'max_new_tokens': 4},
     {'srv.generate', 'eng.queue_wait', 'eng.prefill', 'eng.first_token',
      'eng.steps'}),
    ('prefix hit', '/generate', {'tokens': PROMPT, 'max_new_tokens': 5},
     {'srv.generate', 'eng.queue_wait', 'eng.first_token', 'eng.steps'}),
    ('prefill_only', '/generate', {'tokens': [3, 8, 13],
                                   'max_new_tokens': 6,
                                   'prefill_only': True,
                                   'request_id': 'po-1'},
     {'srv.generate', 'eng.queue_wait', 'eng.prefill', 'eng.first_token',
      'eng.export'}),
    ('import', '/import', None,
     {'srv.import', 'eng.import', 'eng.steps'}),
    ('predict', '/predict', {'data': [0.25] * 8}, {'srv.predict'}),
    ('drain', '/drain?request_id=po-1', None, {'srv.drain'}),
)


@pytest.fixture(scope='module')
def rigs():
    """(reference rig, port rig), both with tracing switched on."""
    from mxnet_tpu.loadgen.harness import ServingRig as RefRig
    ref = RefRig()
    port = None
    try:
        port = carried_rig(ref)
        yield ref, port
    finally:
        ref.close()
        if port is not None:
            port.close()


@pytest.fixture
def traced():
    trace.set_enabled(True)
    ref_trace.set_enabled(True)
    try:
        yield
    finally:
        trace.set_enabled(None)
        ref_trace.set_enabled(None)


def _call(port, path, body, header=None):
    """One request; a /generate answers its NDJSON lines, anything else
    its JSON body."""
    headers = {'Content-Type': 'application/json'}
    if header is not None:
        headers[trace.TRACE_HEADER] = header
    req = urllib.request.Request(
        'http://127.0.0.1:%d%s' % (port, path),
        data=None if body is None else json.dumps(body).encode(),
        headers=headers)
    with urllib.request.urlopen(req, timeout=HTTP_S) as resp:
        raw = resp.read()
    if path in ('/generate', '/import'):
        return [json.loads(line) for line in raw.splitlines() if line]
    return json.loads(raw)


def _spans(buf, trace_id, names):
    """The buffer's spans of ``trace_id`` once ``names`` are all there
    (the last ones land after the client's done line)."""
    deadline = time.monotonic() + SPAN_WAIT_S
    while True:
        got = [r for r in buf.read() if r['trace'] == trace_id]
        if names <= {r['name'] for r in got} \
                or time.monotonic() > deadline:
            return got
        time.sleep(0.01)


def _shape(spans):
    """Each span as (name, its parent's name, its attributes), the
    parent of a root None and ``ttft_s`` replaced by its type, sorted."""
    by_id = {s['span']: s['name'] for s in spans}
    out = []
    for s in spans:
        attrs = dict(s.get('attrs') or {})
        if 'ttft_s' in attrs:
            assert attrs['ttft_s'] >= 0.0
            attrs['ttft_s'] = 'float'
        parent = s['parent']
        out.append((s['name'], None if parent is None
                    else by_id.get(parent, 'missing'),
                    json.dumps(attrs, sort_keys=True)))
    return sorted(out)


def _drive(rig, trace_mod, seqstate=None):
    """The requests of ``REQUESTS`` through ``rig``, each under a fresh
    bare identity of ``trace_mod``; returns {label: (spans, answer)}."""
    out = {}
    for label, path, body, names in REQUESTS:
        ctx = trace_mod.TraceContext.new()
        if label == 'import':
            body = {'seqstate': seqstate}
        answer = _call(rig.port, path, body, ctx.to_header())
        if label == 'prefill_only':
            seqstate = answer[-1]['seqstate']
        spans = _spans(rig.server._trace_buf, ctx.trace_id, names)
        assert {s['name'] for s in spans} == names, (label, spans)
        out[label] = (spans, answer)
    return out


def test_replica_spans_are_the_references(rigs, traced):
    """The same six requests through the reference replica and the
    port's: span for span the same names, parents and attributes, the
    handler's span the root and every engine span under it; the same
    tokens."""
    ref, port = rigs
    want = _drive(ref, ref_trace)
    got = _drive(port, trace)
    for label, _path, _body, _names in REQUESTS:
        spans, answer = got[label]
        assert _shape(spans) == _shape(want[label][0]), label
        roots = [s for s in spans if s['parent'] is None]
        assert len(roots) == 1 and roots[0]['name'].startswith('srv.')
        assert roots[0]['site'] == 'replica:%d' % port.port
        for s in spans:
            assert s['t0'] <= s['t1']
            if s['name'].startswith('eng.'):
                assert s['parent'] == roots[0]['span'], (label, s)
        if label in ('prefill', 'prefix hit', 'import'):
            assert answer == want[label][1], label
    steps = {label: [s['attrs'] for s in got[label][0]
                     if s['name'] == 'eng.steps']
             for label in ('prefill', 'prefix hit', 'import')}
    assert steps['prefill'] == [{'tokens': 4, 'steps': 3,
                                 'reason': 'length'}]
    assert steps['prefix hit'] == [{'tokens': 5, 'steps': 4,
                                    'reason': 'length'}]


def _cursor_walk(port):
    """What ``GET /trace`` answers at cursors 0, the head's, two before
    it, and a malformed one."""
    def get(query):
        with urllib.request.urlopen('http://127.0.0.1:%d/trace%s'
                                    % (port, query), timeout=HTTP_S) as r:
            ctype = r.headers.get('Content-Type')
            lines = r.read().decode().splitlines()
        head = json.loads(lines[0])
        recs = [json.loads(x) for x in lines[1:]]
        assert head['count'] == len(recs) and ctype == \
            'application/x-ndjson'
        return head, recs

    head, recs = get('')
    n = head['cursor']
    tail_head, tail = get('?since=%d' % (n - 2))
    end_head, end = get('?since=%d' % n)
    bad_head, bad = get('?since=x')
    return dict(keys=sorted(head), schema=head['schema'],
                all=head['count'] == n == len(recs)
                and [r['seq'] for r in recs] == list(range(1, n + 1)),
                tail=[r['seq'] for r in tail] == [n - 1, n]
                and tail_head['cursor'] == n,
                end=(end_head['count'], end, end_head['cursor'] == n),
                bad=bad_head['count'] == n and len(bad) == n)


def test_trace_cursor_is_the_references(rigs, traced):
    """``GET /trace?since=N``: a header line (schema, site, cursor,
    count), then the records after N, oldest first; N at the cursor
    gives none, a malformed N reads as 0; as the reference's."""
    ref, port = rigs
    for rig, mod in ((ref, ref_trace), (port, trace)):
        ctx = mod.TraceContext.new()
        _call(rig.port, '/predict', {'data': [0.5] * 8}, ctx.to_header())
        _call(rig.port, '/predict', {'data': [0.5] * 8}, ctx.to_header())
        _spans(rig.server._trace_buf, ctx.trace_id, {'srv.predict'})
    got, want = _cursor_walk(port.port), _cursor_walk(ref.port)
    assert got == want
    assert got['all'] and got['tail'] and got['bad']
    assert got['end'] == (0, [], True)


def test_tracing_off_is_a_noop(rigs):
    """Tracing off (the default): a request carrying the header opens no
    span, parses nothing, attaches no context to the sequence, and
    streams what the same request streams traced, and what the
    reference's replica streams."""
    ref, port = rigs
    assert not trace.enabled()
    buf = port.server._trace_buf
    before = buf.stats()['emitted']
    eng = port.decode_session._engine
    seen = []
    admit = eng._admit_paged

    def spy(seq, slot):
        seen.append(seq.trace)
        return admit(seq, slot)

    body = {'tokens': [4, 4, 6, 1], 'max_new_tokens': 6}
    header = trace.TraceContext.new().to_header()
    with mock.patch.object(eng, '_admit_paged', spy):
        off = _call(port.port, '/generate', body, header)
        plain = _call(port.port, '/generate', body)
    assert seen == [None, None]
    assert buf.stats()['emitted'] == before
    assert off == plain == _call(ref.port, '/generate', body, header)
    trace.set_enabled(True)
    try:
        ctx = trace.TraceContext.new()
        on = _call(port.port, '/generate', body, ctx.to_header())
        assert _spans(buf, ctx.trace_id, {'eng.steps'})
    finally:
        trace.set_enabled(None)
    assert on == off


def test_gateway_and_two_replicas_stitch_one_tree():
    """A traced request through the port's gateway over a prefill and a
    decode replica of the port: one complete tree from the three
    buffers, the replicas' srv.* and eng.* spans in it, and
    ``decompose_ttft`` reading the queue and prefill phases from the
    engine's spans."""
    from mxnet_tpu_torch.loadgen.harness import GatewayRig
    rig = GatewayRig(replicas=2, classes=('prefill', 'decode'),
                     health_period_s=0.25, predict=False, slots=4,
                     max_new_tokens=12, decode_prefill_buckets=(16,),
                     decode_max_len=64, device='cpu')
    trace.set_enabled(True)
    try:
        ctx = trace.TraceContext.new()
        lines = _call(rig.port, '/generate',
                      {'tokens': [7, 3, 9, 1, 2], 'max_new_tokens': 12},
                      ctx.to_header())
        assert lines[-1]['done'] and 'error' not in lines[-1]
        assert [x['index'] for x in lines[:-1]] == list(range(12))
        names = {'gw.request', 'gw.relay', 'gw.handoff', 'srv.generate',
                 'srv.import', 'eng.queue_wait', 'eng.prefill',
                 'eng.first_token', 'eng.export', 'eng.import',
                 'eng.steps'}
        deadline = time.monotonic() + SPAN_WAIT_S
        while True:
            recs = list(rig.gateway._trace_buf.read())
            for rep in rig.replicas:
                recs.extend(rep.server._trace_buf.read())
            recs = [r for r in recs if r['trace'] == ctx.trace_id]
            tree = trace.stitch(recs).get(ctx.trace_id)
            if (tree is not None and trace.tree_verdict(tree)
                    and names <= {r['name'] for r in recs}) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.02)
    finally:
        trace.set_enabled(None)
        rig.close()
    assert names <= {r['name'] for r in recs}, sorted(
        r['name'] for r in recs)
    assert trace.tree_verdict(tree) is True and not tree['orphans']
    sites = {r['site'] for r in recs}
    assert sites == {'gateway'} | {'replica:%d' % r.port
                                   for r in rig.replicas}
    eng_sites = {r['name']: r['site'] for r in recs
                 if r['name'] in ('eng.prefill', 'eng.import')}
    assert eng_sites == {'eng.prefill': 'replica:%d' % rig.replicas[0].port,
                         'eng.import': 'replica:%d' % rig.replicas[1].port}
    trace.normalize_skew(tree)
    ttft, parts = trace.decompose_ttft(tree)
    assert ttft > 0 and parts['queue'] > 0 and parts['prefill'] > 0
    assert abs(sum(parts.values()) - ttft) < 1e-6
    cp = trace.critical_path([tree])
    assert cp['n'] == 1 and cp['tpot']['p50_ms'] > 0
