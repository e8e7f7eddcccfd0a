"""Port parity of the replica's drain and import endpoints: the HTTP
lifecycle of ``ServingHTTPServer`` (``begin_drain``, ``GET /drain``,
``POST /import``, ``serve_until_drained``, ``install_preempt_hook``) and
``resilience.preempt`` of ``mxnet_tpu_torch`` against the JAX package's
(``tests/test_migration.py``'s ``test_server_drain_hands_off_over_http``
and ``test_server_prefill_only_hands_off_over_http``, and
``mxnet_tpu/resilience/preempt.py``).

The model is ``tests/test_torch_migration.py``'s (vocab 23, units 16,
one layer, two heads, max_len 64), both packages on the CPU. Greedy
tokens are held for equality: a stream handed from one endpoint to
another over HTTP is the JAX package's unmigrated stream, its indices
0..n-1 unbroken. A draining replica answers 503 (``draining`` on
``/healthz``, ``Draining`` with ``Retry-After: 1`` on every POST), and a
process whose endpoint drains after SIGTERM exits with the resumable code
75. Every HTTP call and wait has its own timeout.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from mxnet_tpu.resilience import preempt as jax_preempt
from mxnet_tpu.serving.decode import DecodeEngine as JaxEngine
from mxnet_tpu.serving.decode import PagedDecodeProgram as JaxPaged
from mxnet_tpu.serving.decode import init_transformer_lm as jax_init_lm
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.resilience import policy as port_policy
from mxnet_tpu_torch.resilience import preempt
from mxnet_tpu_torch.serving.decode import PagedDecodeProgram

torch.set_num_threads(1)

CFG = dict(vocab=23, units=16, hidden=32, layers=1, heads=2, max_len=64)
PROMPT = [3, 5, 7, 11, 2, 9, 4, 6, 8, 10]
HTTP_S = 30
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def weights():
    jmodel, np_params = jax_init_lm(**CFG)
    pmodel, _ = serving.init_transformer_lm(**CFG)
    return jmodel, pmodel, np_params


def _want(weights, n, prompt=PROMPT):
    """The JAX package's unmigrated greedy stream."""
    jmodel, _pm, np_params = weights
    eng = JaxEngine(JaxPaged(jmodel, np_params, slots=2,
                             prefill_buckets=(8, 16), page_size=8, pages=32),
                    timeout_s=HTTP_S)
    try:
        return eng.generate(prompt, max_new_tokens=n).result(HTTP_S)
    finally:
        eng.close()


def _session(weights, page_size, pages, **kw):
    _jm, pmodel, np_params = weights
    kw.setdefault('slots', 2)
    prog = PagedDecodeProgram(pmodel, np_params, prefill_buckets=(8, 16),
                              page_size=page_size, pages=pages,
                              device='cpu', **kw)
    return serving.InferenceSession(prog, watchdog=False, timeout_s=HTTP_S)


def _ndjson(url, payload):
    """(tokens, indices, done line) of one streamed POST."""
    resp = urllib.request.urlopen(urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'}), timeout=HTTP_S)
    tokens, indices, done = [], [], None
    for raw in resp:
        raw = raw.strip()
        if not raw:
            continue
        doc = json.loads(raw)
        if doc.get('done'):
            done = doc
            break
        tokens.append(doc['token'])
        indices.append(doc['index'])
    return tokens, indices, done


def _call(method, url, payload=None):
    """(code, headers, parsed body) of one request."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={'Content-Type': 'application/json'})
    try:
        resp = urllib.request.urlopen(req, timeout=HTTP_S)
        return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), json.loads(err.read())


def test_server_drain_hands_off_over_http(weights):
    """The replica's drain: /healthz 503 ``draining``, new work and
    imports shed 503 ``Draining`` with Retry-After, the in-flight stream
    finishes ``migrated`` with its request id (no error line), ``GET
    /drain`` serves its payload, another endpoint continues it with no
    prefill and the indices unbroken, and the drain records rc 75."""
    n = 20
    want = _want(weights, n)
    sess_a = _session(weights, 8, 32)
    sess_b = _session(weights, 16, 16)
    slow_step = sess_a.program.run_step

    def step(*a, **kw):
        time.sleep(0.01)          # the drain lands mid-stream
        return slow_step(*a, **kw)

    sess_a.program.run_step = step
    srv_a = serving.ServingHTTPServer(sess_a, 0).start()
    srv_b = serving.ServingHTTPServer(sess_b, 0).start()
    base_a = 'http://127.0.0.1:%d' % srv_a.port
    base_b = 'http://127.0.0.1:%d' % srv_b.port
    try:
        req = {'tokens': PROMPT, 'max_new_tokens': n, 'stream': True,
               'request_id': 'rid-mig'}
        resp = urllib.request.urlopen(urllib.request.Request(
            base_a + '/generate', data=json.dumps(req).encode(),
            headers={'Content-Type': 'application/json'}), timeout=HTTP_S)
        tokens, indices, done = [], [], None
        for raw in resp:
            doc = json.loads(raw)
            if doc.get('done'):
                done = doc
                break
            tokens.append(doc['token'])
            indices.append(doc['index'])
            if len(tokens) == 4:
                assert srv_a.begin_drain(reason='test') is srv_a
                srv_a.begin_drain(reason='again')       # idempotent
        assert done['finish_reason'] == 'migrated' and 'error' not in done
        assert done['request_id'] == 'rid-mig'
        assert 'seqstate' not in done
        assert srv_a.draining

        code, _h, body = _call('GET', base_a + '/healthz')
        assert (code, body) == (503, {'ok': False, 'status': 'draining'})
        for path in ('/generate', '/import', '/predict'):
            code, headers, body = _call('POST', base_a + path, req)
            assert code == 503 and body['error_class'] == 'Draining', path
            assert headers.get('Retry-After') == '1'

        # the done line can beat the drain worker's publication: poll
        deadline = time.monotonic() + 15.0
        payload = None
        while time.monotonic() < deadline:
            code, _h, snap = _call('GET', base_a + '/drain?request_id=nope')
            assert code == 200 and snap['sequences'] == []
            code, _h, snap = _call('GET',
                                   base_a + '/drain?request_id=rid-mig')
            assert snap['schema'] == 'mxnet_tpu.drain.v1'
            if snap['sequences']:
                payload = snap['sequences'][0]
                break
            time.sleep(0.05)
        assert payload is not None and payload['request_id'] == 'rid-mig'
        assert payload['emitted'] == tokens

        toks2, idx2, done2 = _ndjson(base_b + '/import',
                                     {'seqstate': payload, 'stream': True})
        assert done2['finish_reason'] in ('length', 'eos')
        assert done2['request_id'] == 'rid-mig'
        assert tokens + toks2 == want == done2['tokens']
        assert indices + idx2 == list(range(n))
        assert sess_b._engine.stats()['counts']['prefills'] == 0

        assert srv_a.wait_drained(timeout=30)
        res = srv_a.drain_result
        assert res['rc'] == 75 and res['reason'] == 'test'
        assert res['sequences'] == 1 and res['handed_off'] == 1
        code, _h, snap = _call('GET', base_a + '/drain')
        assert snap['complete'] and snap['pending'] == 0
    finally:
        srv_a.stop()
        srv_b.stop()
        sess_a.close()
        sess_b.close()


def test_server_prefill_only_hands_off_over_http(weights):
    """``prefill_only`` streams the boundary token and puts the payload
    on the done line (streamed and plain); ``/import`` with
    ``start_index`` splices the continuation on another endpoint."""
    n = 12
    want = _want(weights, n)
    sess_a = _session(weights, 8, 32)
    sess_b = _session(weights, 16, 16)
    srv_a = serving.ServingHTTPServer(sess_a, 0).start()
    srv_b = serving.ServingHTTPServer(sess_b, 0).start()
    base_a = 'http://127.0.0.1:%d' % srv_a.port
    base_b = 'http://127.0.0.1:%d' % srv_b.port
    try:
        tokens, indices, done = _ndjson(
            base_a + '/generate',
            {'tokens': PROMPT, 'max_new_tokens': n, 'stream': True,
             'prefill_only': True, 'request_id': 'rid-po'})
        assert done['finish_reason'] == 'migrated'
        assert done['seqstate']['schema'] == 'mxnet_tpu.seqstate.v1'
        assert tokens == want[:1] and indices == [0]
        toks2, idx2, done2 = _ndjson(
            base_b + '/import', {'seqstate': done['seqstate'],
                                 'stream': True, 'start_index': 1})
        assert done2['finish_reason'] in ('length', 'eos')
        assert tokens + toks2 == want
        assert indices + idx2 == list(range(n))
        # the plain body carries it too
        code, _h, body = _call('POST', base_a + '/generate', {
            'tokens': PROMPT, 'max_new_tokens': n, 'stream': False,
            'prefill_only': True})
        assert code == 200 and body['finish_reason'] == 'migrated'
        code, _h, body2 = _call('POST', base_b + '/import', {
            'seqstate': body['seqstate'], 'stream': False})
        assert code == 200 and body2['tokens'] == want
        assert sess_b._engine.stats()['counts']['prefills'] == 0
        assert sess_a._engine.stats()['counts']['prefill_exports'] == 2
    finally:
        srv_a.stop()
        srv_b.stop()
        sess_a.close()
        sess_b.close()


def test_import_endpoint_refusals_and_pool_pressure(weights):
    """``/import`` answers 400 without a ``seqstate`` object, for a torn
    payload and for a bad ``start_index`` on ``/generate``; an import into
    a replica with no free slot is 429 with Retry-After, and the same
    payload lands once the slot frees."""
    n = 10
    want = _want(weights, n)
    sess_a = _session(weights, 8, 32)
    sess_b = _session(weights, 8, 32, slots=1)
    srv_b = serving.ServingHTTPServer(sess_b, 0).start()
    base_b = 'http://127.0.0.1:%d' % srv_b.port
    try:
        s = sess_a.generate(PROMPT, max_new_tokens=n, prefill_only=True)
        s.result(HTTP_S)
        payload = s.seqstate
        assert _call('POST', base_b + '/import', {})[0] == 400
        assert _call('POST', base_b + '/import', {'seqstate': [1]})[0] == 400
        torn = json.loads(json.dumps(payload))
        torn['entries']['l0_k']['data'] = 'A' + \
            torn['entries']['l0_k']['data'][1:]
        code, _h, body = _call('POST', base_b + '/import',
                               {'seqstate': torn})
        assert code == 400 and 'torn' in body['error']
        assert _call('POST', base_b + '/generate', {
            'tokens': [1, 2], 'start_index': 'x'})[0] == 400
        hog = sess_b.generate([1, 2, 3], max_new_tokens=50)
        next(iter(hog))
        code, headers, body = _call('POST', base_b + '/import',
                                    {'seqstate': payload, 'stream': False})
        assert code == 429 and int(headers['Retry-After']) >= 1
        assert 'retry_after_s' in body
        hog.cancel()
        deadline = time.monotonic() + HTTP_S
        while sess_b._engine.stats()['free_slots'] != 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        code, _h, body = _call('POST', base_b + '/import',
                               {'seqstate': payload, 'stream': False})
        assert code == 200 and body['tokens'] == want
    finally:
        srv_b.stop()
        sess_a.close()
        sess_b.close()


def test_serve_until_drained_raises_preempted_with_the_resumable_code(
        weights, monkeypatch):
    """An idle replica's drain completes at once; ``serve_until_drained``
    raises ``Preempted`` (a SystemExit) with rc 75, or the knob's code."""
    sess = _session(weights, 8, 32)
    srv = serving.ServingHTTPServer(sess, 0).start()
    try:
        srv.begin_drain(reason='maintenance')
        with pytest.raises(preempt.Preempted) as exc:
            srv.serve_until_drained(timeout=HTTP_S)
        assert isinstance(exc.value, SystemExit)
        assert exc.value.code == 75 and exc.value.reason == 'maintenance'
        assert srv.drain_result['sequences'] == 0
        monkeypatch.setenv('MXNET_TPU_PREEMPT_EXIT_CODE', '76')
        assert preempt.resumable_exit_code() == 76 == \
            jax_preempt.resumable_exit_code()
    finally:
        srv.stop()
        sess.close()


CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.serving.decode import PagedDecodeProgram
model, params = serving.init_transformer_lm(vocab=23, units=16, hidden=32,
                                            layers=1, heads=2, max_len=64)
prog = PagedDecodeProgram(model, params, slots=2, prefill_buckets=(8, 16),
                          page_size=8, pages=32, device='cpu')
sess = serving.InferenceSession(prog, watchdog=False, timeout_s=30)
srv = serving.ServingHTTPServer(sess, 0).start()
srv.install_preempt_hook(poll_s=0.01)
print('READY %d' % srv.port, flush=True)
try:
    srv.serve_until_drained(timeout=60)
finally:
    print('DRAINED ' + json.dumps(srv.drain_result), flush=True)
    srv.stop()
'''


def test_sigterm_drains_a_serving_process_that_exits_75():
    """A real process: its endpoint's preemption hook turns SIGTERM into
    a drain, ``/healthz`` answers 503 ``draining``, and the process exits
    with the resumable code once the drain completes."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('MXNET_TPU_')}
    proc = subprocess.Popen([sys.executable, '-c', CHILD, ROOT],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env=env, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith('READY '), proc.stderr.read()
        port = int(line.split()[1])
        code, _h, body = _call('GET', 'http://127.0.0.1:%d/healthz' % port)
        assert (code, body['status']) == (200, 'ok')
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
        out = proc.stdout.read()
        assert rc == 75, proc.stderr.read()
        res = json.loads(out.split('DRAINED ', 1)[1])
        assert res['rc'] == 75 and res['reason'] == 'signal SIGTERM'
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


def _script(mod, injector):
    """One run of the handler protocol; every observable in order."""
    h = mod.PreemptionHandler(injector=injector, grace_s=5.0, exit_code=75)
    out = [h.stop_requested]
    for step in range(4):
        out.append(h.check(step))
    out.append(h.reason)
    out.append(h.drain(lambda: 'ckpt-3'))
    try:
        h.exit(3)
    except mod.Preempted as exc:
        out += [exc.code, exc.step, exc.checkpoint, exc.reason, str(exc)]
    h.request_stop('again')
    out.append(h.reason)
    return out


def test_preemption_handler_protocol_is_the_references():
    """The same scripted ``preempt`` fault at step 2 through both
    packages' handlers: the same flags, reason, drain and exit."""
    from mxnet_tpu.resilience import policy as jax_policy
    got = _script(preempt, port_policy.FaultInjector('preempt@train.step.2'))
    want = _script(jax_preempt,
                   jax_policy.FaultInjector('preempt@train.step.2'))
    assert got == want
    assert got[1:5] == [False, False, True, True]
    assert got[-6] == 75 and got[-4] == 'ckpt-3'


def test_preempt_handler_chains_and_uninstalls_signal_handlers():
    seen = []
    old = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        h = preempt.PreemptionHandler(signals=(signal.SIGUSR1,)).install()
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5
        while not h.stop_requested and time.monotonic() < deadline:
            time.sleep(0.01)
        assert h.stop_requested and h.reason == 'signal SIGUSR1'
        assert seen == [signal.SIGUSR1]
        h.uninstall()
        # a thread other than the main one cannot install: a no-op
        box = []
        t = threading.Thread(target=lambda: box.append(
            preempt.PreemptionHandler().install()._installed))
        t.start()
        t.join(5)
        assert box == [False]
    finally:
        signal.signal(signal.SIGUSR1, old)
