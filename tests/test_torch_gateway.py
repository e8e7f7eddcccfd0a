"""Port parity of the serving gateway (``mxnet_tpu_torch/serving/gateway.py``)
against the JAX package's (``mxnet_tpu/serving/gateway.py``).

Differential over the reference's own tests: each primitive and
fake-replica test of ``tests/test_gateway.py`` (and
``tests/test_migration.py``'s journal-cap test) runs twice on fresh fakes,
through the JAX package's ``ServingGateway`` and then through the port's,
with the fakes of the second run on the ports of the first (the
affinity hash is over the replicas' URLs). Each run makes the test's own
assertions; then the two runs must agree: the client's lines, status
codes and headers (``Retry-After`` among them), the request bodies each
fake received and every gateway's ``stats()``, with the request ids
(``gw<port>-<seq>``) normalised to ``gw-<seq>``.

Over the port's real replicas on the CPU (``tests/test_torch_drain.py``'s
model: vocab 23, units 16, one layer, two heads; the JAX package's numpy
parameters in both packages), the client's tokens are the JAX package's
unmigrated greedy stream, token for token, with the indices unbroken:
failover on a typed abort (the port's fault injector at
``serving.decode``), failover on a subprocess replica killed by SIGKILL,
the drain (``GET /drain`` then ``POST /import``, no prefill on the
target), the disaggregated prefill / decode path (no prefill on the
decode side), and two mixed fleets (the port's gateway over a JAX
``prefill`` replica and a port ``decode`` replica, the JAX gateway over
the reverse). Every HTTP call and wait has its own timeout.
"""
import inspect
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import test_gateway as tg
import test_migration as tm
from mxnet_tpu import observability as jax_obs
from mxnet_tpu.serving import gateway as jax_gw
from mxnet_tpu.serving.decode import DecodeEngine as JaxEngine
from mxnet_tpu.serving.decode import PagedDecodeProgram as JaxPaged
from mxnet_tpu.serving.decode import init_transformer_lm as jax_init_lm
from mxnet_tpu_torch import observability as port_obs
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.resilience import policy as port_policy
from mxnet_tpu_torch.serving import gateway as port_gw
from mxnet_tpu_torch.serving.decode import PagedDecodeProgram

torch.set_num_threads(1)

PACKAGES = {'jax': jax_gw, 'port': port_gw}
_FAKE = tg._FakeReplica
_READ = tg._read_stream
HTTP_S = 30

# -- the reference's tests, through both gateways -----------------------------

PURE = ('test_prefix_fingerprint_keys_on_all_but_last_token',
        'test_rendezvous_removing_member_only_moves_its_keys',
        'test_rendezvous_order_is_a_permutation',
        'test_token_bucket_math_with_fake_clock',
        'test_token_bucket_zero_rate_never_fills',
        'test_tenant_admission_fair_share_and_release',
        'test_tenant_admission_rate_limit_reason_and_hint',
        'test_probe_stagger_phases_distinct_and_deterministic')
OVER_FAKES = ('test_resume_splices_midstream_death',
              'test_resume_dedups_replayed_indices',
              'test_resume_withholds_typed_abort_and_resumes',
              'test_resume_budget_exhausted_typed_replica_lost',
              'test_resume_retries_typed_503_refusal',
              'test_resume_off_preserves_plain_contract',
              'test_affinity_routes_same_prefix_to_one_replica',
              'test_tenant_admission_over_http',
              'test_disagg_handoff_splices_bit_identical',
              'test_disagg_picks_least_loaded_decode',
              'test_disagg_import_refusal_retries_next_decode',
              'test_disagg_refusals_exhaust_budget_fall_back_monolithic',
              'test_disagg_decode_death_mid_splice_resumes',
              'test_probe_marks_draining_distinct_from_dead',
              'test_decode_class_down_degrades_monolithic',
              'test_disagg_all_down_sheds_typed_with_retry_after',
              'test_forward_plain_reroutes_draining_503',
              'test_class_map_env_assigns_replica_classes')
# mirrored below over the port's registry; the rig tests need loadgen
NOT_MIRRORED = ('test_gateway_instruments_registered',
                'test_kill_replica_mid_stream_bit_identical',
                'test_two_tenant_burst_isolation')
_PATCHED = ('TenantAdmission', 'TokenBucket', '_probe_jitter_frac',
            'prefix_fingerprint', 'rendezvous_rank')


def test_every_reference_gateway_test_is_mirrored():
    names = {n for n, f in vars(tg).items()
             if n.startswith('test_') and inspect.isfunction(f)}
    assert len(PURE) + len(OVER_FAKES) == 26
    assert names == set(PURE) | set(OVER_FAKES) | set(NOT_MIRRORED)


class _Run:
    """One package's run of one scenario: the reference test module's
    gateway, primitives, fakes and stream reader swapped for recording
    ones. ``ports`` pins the fakes to an earlier run's ports, in order."""

    def __init__(self, pkg, monkeypatch, ports=None):
        mod = PACKAGES[pkg]
        self.gateways, self.fakes, self.streams = [], [], []
        self.ports = list(ports) if ports is not None else None
        run = self

        class Gateway(mod.ServingGateway):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                if self.admission is not None:
                    # a 429's retry_after_s is read off the bucket's
                    # clock: one that steps 1 ms a read, alike in both
                    # runs
                    self.admission._clock = _StepClock()
                run.gateways.append(self)

        class Fake(_FAKE):
            def __init__(self):
                self.ctl = {'healthy': True, 'requests': []}
                self._httpd = _bind(run.ports.pop(0)
                                    if run.ports is not None else 0)
                self._httpd.ctl = self.ctl
                self.port = self._httpd.server_address[1]
                self._thread = threading.Thread(
                    target=self._httpd.serve_forever, daemon=True)
                self._thread.start()
                run.fakes.append(self)

        def read(port, payload, headers=None, timeout=10.0):
            out = _READ(port, payload, headers=headers, timeout=timeout)
            run.streams.append(out)
            return out

        self.Gateway = Gateway
        monkeypatch.setattr(tg, 'ServingGateway', Gateway)
        monkeypatch.setattr(jax_gw, 'ServingGateway', Gateway)
        monkeypatch.setattr(tg, '_FakeReplica', Fake)
        monkeypatch.setattr(tg, '_read_stream', read)
        for name in _PATCHED:
            monkeypatch.setattr(tg, name, getattr(mod, name))

    def transcript(self):
        """Everything the clients and the fakes saw, and every gateway's
        stats; request ids normalised."""
        for gw in self.gateways:
            _settle(gw)
        doc = {'streams': [{k: v for k, v in s.items() if k != 'headers'}
                           | {'headers': {k: v for k, v in
                                          s['headers'].items()
                                          if k not in ('Date', 'Server')}}
                           for s in self.streams],
               'bodies': [f.ctl['requests'] for f in self.fakes],
               'stats': [gw.stats() for gw in self.gateways]}
        return re.sub(r'gw\d+-(\d+)', r'gw-\1',
                      json.dumps(doc, sort_keys=True))


class _StepClock:
    def __init__(self):
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return 1000.0 + 1e-3 * self.reads


def _bind(port, budget=5.0):
    deadline = time.monotonic() + budget
    while True:
        try:
            return tg._FakeServer(('127.0.0.1', port), tg._FakeHandler)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _settle(gw, budget=5.0):
    """The client has its done line before the handler thread releases
    the tenant's admission: wait for every release."""
    deadline = time.monotonic() + budget
    while gw.admission is not None and time.monotonic() < deadline and any(
            t['inflight'] for t in gw.admission.stats().values()):
        time.sleep(0.01)


def _fixture(name, run):
    """The reference's ``fake_pair`` / ``disagg_quad`` fixtures, built
    from the run's classes: (the value, its teardown)."""
    if name == 'fake_pair':
        a, b = tg._FakeReplica(), tg._FakeReplica()
        gw = run.Gateway([a.url, b.url], port=0, health_period_s=30.0,
                         timeout_s=5.0, resume=True, resume_max=2,
                         affinity=True).start()
        return (gw, {a.url: a, b.url: b}), [gw.stop, a.close, b.close]
    reps = [tg._FakeReplica() for _ in range(4)]
    classes = ('prefill', 'prefill', 'decode', 'decode')
    gw = run.Gateway([(r.url, c) for r, c in zip(reps, classes)],
                     port=0, health_period_s=30.0, timeout_s=5.0,
                     resume=True, resume_max=2, affinity=True,
                     handoff_timeout_s=5.0, handoff_retries=2).start()
    return (gw, reps), [gw.stop] + [r.close for r in reps]


def _scenario(fn, pkg, monkeypatch, ports=None):
    """Run ``fn`` (a reference test) through package ``pkg``: its own
    assertions hold; returns (its transcript, the fakes' ports)."""
    with monkeypatch.context() as mp:
        run = _Run(pkg, mp, ports)
        args, teardown = [], []
        for param in inspect.signature(fn).parameters:
            if param == 'monkeypatch':
                args.append(mp)
            else:
                value, stop = _fixture(param, run)
                args.append(value)
                teardown += stop
        try:
            fn(*args)
            return run.transcript(), [f.port for f in run.fakes]
        finally:
            for stop in teardown:
                stop()


@pytest.mark.parametrize('name', PURE + OVER_FAKES)
def test_reference_gateway_test_agrees(name, monkeypatch):
    fn = getattr(tg, name)
    want, ports = _scenario(fn, 'jax', monkeypatch)
    got, _ = _scenario(fn, 'port', monkeypatch, ports)
    assert got == want


def test_journal_cap_readmits_original_prompt_agrees(monkeypatch):
    """``tests/test_migration.py``'s journal-cap test through both."""
    fn = tm.test_gateway_journal_cap_readmits_original_prompt
    want, ports = _scenario(fn, 'jax', monkeypatch)
    got, _ = _scenario(fn, 'port', monkeypatch, ports)
    assert got == want
    assert '"journal_capped": true' in got


@pytest.mark.parametrize('cause', ['die_after', 'abort_after'])
def test_lost_done_line_after_the_last_token_finishes_from_the_journal(
        cause):
    """A replica lost after it streamed every requested token but before
    its done line: the port's gateway finishes the stream from the
    journal and re-admits nothing (a re-admission would ask for 0 new
    tokens, which a real replica refuses with a 400). The JAX package's
    gateway re-admits here; the port does not copy that."""
    a, b = _FAKE(), _FAKE()
    gw = port_gw.ServingGateway([a.url, b.url], port=0,
                                health_period_s=30.0, timeout_s=5.0,
                                resume=True, resume_max=2,
                                affinity=True).start()
    try:
        by_url = {a.url: a, b.url: b}
        target, survivor = tg._target_and_survivor(gw, by_url)
        target.ctl[cause] = 6
        r = _READ(gw.port, {'tokens': tg._PROMPT, 'max_new_tokens': 6,
                            'stream': True}, timeout=HTTP_S)
        assert r['error'] is None and r['status'] == 200
        assert r['tokens'] == tg._expected_tokens(tg._PROMPT, 6)
        assert r['indices'] == list(range(6))
        done = r['done']
        assert 'error' not in done and 'resumed' not in done
        assert done['finish_reason'] == 'length'
        assert done['tokens'] == r['tokens'] and done['request_id']
        assert survivor.ctl['requests'] == []
        st = gw.stats()
        assert st['resumes'] == 0 and st['resume_failures'] == 0
    finally:
        gw.stop()
        a.close()
        b.close()


class _PausingHandler(tg._FakeHandler):
    """The reference's fake replica, whose ``/import`` stream stops for
    ``ctl['pause_s']`` seconds after its ``ctl['pause_after']``-th
    token."""

    def _chunk(self, obj):
        super()._chunk(obj)
        ctl = self.server.ctl
        if 'token' in obj and self.path.rstrip('/') == '/import':
            ctl['sent'] = ctl.get('sent', 0) + 1
            if ctl['sent'] == ctl.get('pause_after'):
                time.sleep(ctl['pause_s'])


def test_spliced_stream_outlives_the_handoff_timeout():
    """The handoff timeout bounds the hop to the decode replica (the
    POST, the import, the first byte), not the gaps of its stream after
    the splice: a decode replica that pauses longer than that timeout
    between two tokens still finishes the client's stream, with no
    resume. The JAX package's gateway keeps the hop's timeout on the
    spliced socket; its read then times out, and the relay ends as if the
    client had gone, with no done line (a keep-alive client waits out its
    own budget). The port does not copy that."""
    prefill, decode = _FAKE(), _FAKE()
    decode._httpd.RequestHandlerClass = _PausingHandler
    decode.ctl.update(pause_after=3, pause_s=3.0)
    gw = port_gw.ServingGateway([(prefill.url, 'prefill'),
                                 (decode.url, 'decode')], port=0,
                                health_period_s=30.0, timeout_s=10.0,
                                resume=True, resume_max=2, affinity=True,
                                handoff_timeout_s=1.5,
                                handoff_retries=2).start()
    try:
        r = _READ(gw.port, {'tokens': tg._PROMPT, 'max_new_tokens': 8,
                            'stream': True}, timeout=HTTP_S)
        assert r['error'] is None and r['status'] == 200
        assert r['tokens'] == tg._expected_tokens(tg._PROMPT, 8)
        assert r['indices'] == list(range(8))
        assert r['done']['finish_reason'] == 'length'
        assert 'resumed' not in r['done']
        st = gw.stats()
        assert st['handoff'] == {'spliced': 1, 'retries': 0,
                                 'fallbacks': 0}
        assert st['resumes'] == 0
    finally:
        gw.stop()
        prefill.close()
        decode.close()


def test_pure_functions_agree():
    """The routing and admission primitives give the reference's values,
    step for step."""
    for toks in ([5], [5, 11, 7, 2], list(range(40)), [0, 0]):
        for adapter in (None, '', 'base', 'ad3'):
            assert port_gw.prefix_fingerprint(toks, adapter) == \
                jax_gw.prefix_fingerprint(toks, adapter)
    members = ['http://127.0.0.1:%d' % p for p in range(8000, 8006)]
    for k in range(50):
        key = port_gw.prefix_fingerprint([k, k + 1])
        assert port_gw.rendezvous_rank(key, members) == \
            jax_gw.rendezvous_rank(key, members)
    for url in members:
        assert port_gw._probe_jitter_frac(url) == \
            jax_gw._probe_jitter_frac(url)
    for raw in (b'{"status": "draining"}', b'{"error_class": "Draining"}',
                b'{"ok": false}', b'not json', '{"status": "draining"}'):
        assert port_gw._draining_body(raw) == jax_gw._draining_body(raw)

    def script(mod):
        now = [0.0]
        adm = mod.TenantAdmission(rps=2.0, burst=3.0, max_inflight=4,
                                  weights={'b': 2.0},
                                  clock=lambda: now[0])
        out = []
        for i in range(12):
            out.append(adm.admit('ab'[i % 2]))
            if i % 3 == 2:
                adm.release('a')
            now[0] += 0.2
        return out, adm.stats()

    assert script(port_gw) == script(jax_gw)


def test_gateway_instruments_registered():
    """The reference's instruments test over the port's registry, and
    every gateway series declared as the reference declares it."""
    inst = port_obs.gateway_instruments()
    inst.resumes.inc()
    inst.tenant_rejected.labels(tenant='t', reason='rate_limit').inc()
    snap = port_obs.snapshot()
    assert 'mxnet_tpu_gateway_resumes_total' in snap
    assert 'mxnet_tpu_gateway_tenant_rejected_total' in snap
    jax_obs.gateway_instruments()
    port_fams = {f.name: f for f in port_obs.get_registry().families()}
    jax_fams = {f.name: f for f in jax_obs.get_registry().families()}
    names = [n for n in jax_fams if n.startswith('mxnet_tpu_gateway_')]
    assert len(names) == 14
    for n in names:
        assert (port_fams[n].type, port_fams[n].help,
                port_fams[n].label_names) == \
            (jax_fams[n].type, jax_fams[n].help, jax_fams[n].label_names)


def test_class_map_env_reads_the_ports_config(monkeypatch):
    """``MXNET_TPU_GATEWAY_CLASS_MAP`` through ``mxnet_tpu_torch.config``:
    the port's gateway assigns the classes the reference's does."""
    from mxnet_tpu_torch import config as port_config
    monkeypatch.setenv('MXNET_TPU_GATEWAY_CLASS_MAP',
                       'http://h1:18471=prefill,http://h2:18471=decode')
    assert port_config.get('MXNET_TPU_GATEWAY_CLASS_MAP') == \
        'http://h1:18471=prefill,http://h2:18471=decode'
    urls = ['http://h1:18471', 'http://h2:18471', 'http://h3:18471']
    gws = [mod.ServingGateway(urls, port=0) for mod in (port_gw, jax_gw)]
    assert [[r.cls for r in gw.replicas] for gw in gws] == \
        [['prefill', 'decode', 'both']] * 2
    assert all(gw.disaggregated for gw in gws)


# -- the port's real replicas on the CPU --------------------------------------

CFG = dict(vocab=23, units=16, hidden=32, layers=1, heads=2, max_len=64)
PROMPT = [3, 5, 7, 11, 2, 9, 4, 6, 8, 10]


@pytest.fixture(scope='module')
def weights():
    jmodel, np_params = jax_init_lm(**CFG)
    pmodel, _ = serving.init_transformer_lm(**CFG)
    return jmodel, pmodel, {k: np.asarray(v) for k, v in np_params.items()}


@pytest.fixture(scope='module')
def want(weights):
    """The JAX package's unmigrated greedy stream of PROMPT, 20 tokens."""
    jmodel, _pm, np_params = weights
    eng = JaxEngine(JaxPaged(jmodel, np_params, slots=2,
                             prefill_buckets=(8, 16), page_size=8, pages=32),
                    timeout_s=HTTP_S)
    try:
        return eng.generate(PROMPT, max_new_tokens=20).result(HTTP_S)
    finally:
        eng.close()


class _Replica:
    """A started endpoint over one decode session: the port's (``jax``
    False) or the JAX package's."""

    def __init__(self, weights, page_size, pages, jax=False, step_s=0.0):
        jmodel, pmodel, np_params = weights
        if jax:
            from mxnet_tpu import serving as jax_serving
            from mxnet_tpu.serving.server import ServingHTTPServer
            self.sess = jax_serving.InferenceSession(
                JaxPaged(jmodel, np_params, slots=2, prefill_buckets=(8, 16),
                         page_size=page_size, pages=pages), watchdog=False,
                timeout_s=HTTP_S)
            self.srv = ServingHTTPServer(self.sess, port=0).start()
        else:
            prog = PagedDecodeProgram(pmodel, np_params, slots=2,
                                      prefill_buckets=(8, 16),
                                      page_size=page_size, pages=pages,
                                      device='cpu')
            if step_s:
                run_step = prog.run_step

                def slow(*a, **kw):
                    time.sleep(step_s)
                    return run_step(*a, **kw)
                prog.run_step = slow
            self.sess = serving.InferenceSession(prog, watchdog=False,
                                                 timeout_s=HTTP_S)
            self.srv = serving.ServingHTTPServer(self.sess, 0).start()
        self.url = 'http://127.0.0.1:%d' % self.srv.port

    def counts(self):
        return self.sess._engine.stats()['counts']

    def close(self):
        self.srv.stop()
        self.sess.close()


def _gateway(mod, replicas, **kw):
    kw.setdefault('affinity', True)
    return mod.ServingGateway(replicas, port=0, health_period_s=30.0,
                              timeout_s=HTTP_S, resume=True, resume_max=2,
                              handoff_timeout_s=HTTP_S, **kw).start()


def _clean(r, want, n):
    """A whole, unbroken, error-free client stream of the wanted tokens."""
    assert r['error'] is None and r['status'] == 200, r
    assert r['tokens'] == want[:n] and r['indices'] == list(range(n))
    assert 'error' not in r['done'] and r['done']['tokens'] == r['tokens']


def _arm(monkeypatch, spec):
    monkeypatch.setenv('MXNET_TPU_FAULT', '')
    port_policy.get_injector()
    monkeypatch.setenv('MXNET_TPU_FAULT', spec)


def test_typed_abort_resumes_on_a_port_replica(weights, want, monkeypatch):
    """A worker crash on the serving replica ends its stream with a typed
    abort line; the gateway withholds it and resumes on the other
    replica with prompt + emitted: the client's stream is the JAX
    package's, once."""
    reps = [_Replica(weights, 8, 32), _Replica(weights, 8, 32)]
    gw = _gateway(port_gw, [r.url for r in reps])
    try:
        target = next(r for r in reps if r.url == gw.affinity_target(PROMPT))
        survivor = next(r for r in reps if r is not target)
        _arm(monkeypatch, 'worker_crash@serving.decode.3:1')
        r = tg._read_stream(gw.port, {'tokens': PROMPT, 'max_new_tokens': 16,
                                      'stream': True}, timeout=HTTP_S)
        _clean(r, want, 16)
        assert r['done']['resumed'] == 1
        assert target.counts()['retired'].get('aborted') == 1
        assert survivor.counts()['prefills'] == 1
        assert gw.stats()['resumes'] == 1
    finally:
        _arm(monkeypatch, '')
        gw.stop()
        for rep in reps:
            rep.close()


CHILD = r'''
import sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.serving.decode import PagedDecodeProgram
model, _ = serving.init_transformer_lm(vocab=23, units=16, hidden=32,
                                       layers=1, heads=2, max_len=64)
params = dict(np.load(sys.argv[2]))
prog = PagedDecodeProgram(model, params, slots=2, prefill_buckets=(8, 16),
                          page_size=8, pages=32, device='cpu')
run_step = prog.run_step


def slow(*a, **kw):
    time.sleep(0.05)          # the kill lands mid-stream
    return run_step(*a, **kw)


prog.run_step = slow
sess = serving.InferenceSession(prog, watchdog=False, timeout_s=30)
srv = serving.ServingHTTPServer(sess, 0).start()
print('READY %d' % srv.port, flush=True)
sys.stdin.read()
'''


def test_sigkilled_process_replica_resumes_on_the_other(weights, want,
                                                        tmp_path):
    """A replica in its own process dies by SIGKILL mid-stream (a
    transport death); the gateway marks it down, resumes on the other
    replica and the client's stream is the JAX package's, indices
    unbroken, ``resumed`` 1; the gateway's ``/healthz`` reads
    ``degraded``."""
    import http.client
    np.savez(tmp_path / 'params.npz', **weights[2])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('MXNET_TPU_')}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, '-c', CHILD, root,
                             str(tmp_path / 'params.npz')],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, text=True)
    other = _Replica(weights, 8, 32)
    gw = None
    try:
        line = proc.stdout.readline()
        assert line.startswith('READY '), proc.stderr.read()
        child_url = 'http://127.0.0.1:%d' % int(line.split()[1])
        # round-robin: the first stream goes to the first replica, the
        # child
        gw = _gateway(port_gw, [child_url, other.url], affinity=False)
        conn = http.client.HTTPConnection('127.0.0.1', gw.port,
                                          timeout=HTTP_S)
        conn.request('POST', '/generate', body=json.dumps(
            {'tokens': PROMPT, 'max_new_tokens': 16}).encode(),
            headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        tokens, indices, done = [], [], None
        for raw in resp:
            doc = json.loads(raw)
            if doc.get('done'):
                done = doc
                break
            tokens.append(doc['token'])
            indices.append(doc['index'])
            if len(tokens) == 3:
                proc.kill()
                proc.wait(HTTP_S)
        conn.close()
        assert done is not None and 'error' not in done, done
        assert tokens == want[:16] == done['tokens']
        assert indices == list(range(16)) and done['resumed'] == 1
        assert other.counts()['prefills'] == 1
        health = json.loads(urllib.request.urlopen(
            gw.base_url + '/healthz', timeout=HTTP_S).read())
        assert health['status'] == 'degraded' and health['healthy'] == 1
        assert gw.stats()['resumes'] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(HTTP_S)
        if gw is not None:
            gw.stop()
        other.close()


def test_drain_through_the_gateway_imports_without_prefill(weights, want):
    """The serving replica drains mid-stream: its done line says
    ``migrated``, the gateway polls ``GET /drain?request_id=``, lands the
    payload on the other replica with ``POST /import`` (no prefill there)
    and splices the continuation: the JAX package's stream, unbroken."""
    reps = [_Replica(weights, 8, 32, step_s=0.01), _Replica(weights, 16, 16)]
    gw = _gateway(port_gw, [r.url for r in reps])
    try:
        target = next(r for r in reps if r.url == gw.affinity_target(PROMPT))
        dest = next(r for r in reps if r is not target)
        import http.client
        conn = http.client.HTTPConnection('127.0.0.1', gw.port,
                                          timeout=HTTP_S)
        conn.request('POST', '/generate', body=json.dumps(
            {'tokens': PROMPT, 'max_new_tokens': 20}).encode(),
            headers={'Content-Type': 'application/json'})
        tokens, indices, done = [], [], None
        for raw in conn.getresponse():
            doc = json.loads(raw)
            if doc.get('done'):
                done = doc
                break
            tokens.append(doc['token'])
            indices.append(doc['index'])
            if len(tokens) == 4:
                target.srv.begin_drain(reason='test')
        conn.close()
        assert done is not None and 'error' not in done, done
        assert tokens == want == done['tokens']
        assert indices == list(range(20))
        assert done['migrated'] == 1 and done['resumed'] == 0
        c = dest.counts()
        assert c['prefills'] == 0 and c['migrated_in'] == 1
        assert gw.stats()['migrations']['spliced'] == 1
        assert target.srv.wait_drained(timeout=HTTP_S)
        assert target.srv.drain_result['handed_off'] == 1
    finally:
        gw.stop()
        for rep in reps:
            rep.close()


@pytest.mark.parametrize('fleet', ['port', 'port_gateway_jax_prefill',
                                   'jax_gateway_port_prefill'])
def test_disaggregated_prefill_decode(weights, want, fleet):
    """``prefill_only`` on the prefill replica, its done line's payload
    POSTed to the decode replica, which runs no prefill: the JAX package's
    stream. The mixed fleets exchange the payload across packages."""
    mod = jax_gw if fleet == 'jax_gateway_port_prefill' else port_gw
    prefill = _Replica(weights, 8, 32, jax=fleet == 'port_gateway_jax_prefill')
    decode = _Replica(weights, 16, 16, jax=fleet == 'jax_gateway_port_prefill')
    gw = _gateway(mod, [(prefill.url, 'prefill'), (decode.url, 'decode')])
    try:
        r = tg._read_stream(gw.port, {'tokens': PROMPT, 'max_new_tokens': 12,
                                      'stream': True}, timeout=HTTP_S)
        _clean(r, want, 12)
        assert r['done']['finish_reason'] == 'length'
        p, d = prefill.counts(), decode.counts()
        assert d['prefills'] == 0 and d['migrated_in'] == 1
        assert p['prefill_exports'] == 1 and p['migrated_out'] == 1
        assert gw.stats()['handoff'] == {'spliced': 1, 'retries': 0,
                                         'fallbacks': 0}
    finally:
        gw.stop()
        prefill.close()
        decode.close()
