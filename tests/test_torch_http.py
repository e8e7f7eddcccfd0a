"""Port parity of the serving endpoint: ``ServingHTTPServer`` and
``maybe_start_http_server`` of ``mxnet_tpu_torch.serving`` against the JAX
package's (``mxnet_tpu/serving/server.py:465-1200``), and the session's
``MXNET_TPU_SERVE_SPEC_DRAFT`` knob, on the CPU.

A small causal LM (vocab 50, units 32, 2 layers, 4 heads, max_len 64)
from a numpy seed and a small one-shot net of the port. What is held:

  * ``/predict`` (``data`` and ``instances``) and ``/generate`` (chunked
    NDJSON and ``stream: false``) return the session's own results, greedy,
    sampled and adapted;
  * for greedy requests on the same weights, the port's ``/generate``
    bodies equal the JAX package's ``ServingHTTPServer``'s, line for line;
  * the status-code taxonomy (``tests/test_serving.py:754-840``,
    ``tests/test_decode.py:692``): 200 (``degraded`` when the CPU served),
    429 with ``Retry-After`` from a full queue and past ``max_concurrent``,
    504, 503 on a closed session, 500 typed, 400, 404, and ``/healthz``
    503 while the breaker is open; ``GET /drain`` on a one-shot session
    is an empty snapshot and ``POST /import`` a 400, ``/trace`` 404; the
    fleet's ``/generate`` keys are served (``request_id`` echoed,
    ``start_index`` offsetting the indices, ``seqstate`` on a
    ``prefill_only`` done line); a client that goes away cancels its
    stream;
  * the server is off by default and on with ``MXNET_TPU_SERVE_HTTP_PORT``;
    ``MXNET_TPU_SERVE_SPEC_DRAFT`` loads a session's draft.

Every HTTP call and wait has its own timeout.
"""
import http.client
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (the JAX package's config registry)
from mxnet_tpu import serving as jax_serving
from mxnet_tpu.resilience import policy as jax_policy
from mxnet_tpu.serving.decode.model import \
    init_transformer_lm as jax_init_lm
from mxnet_tpu.serving.decode.program import \
    freeze_decode as jax_freeze_decode
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.resilience import policy as port_policy
from mxnet_tpu_torch.resilience.policy import (CircuitBreaker,
                                               WorkerCrashError)
from mxnet_tpu_torch.serving import adapters
from mxnet_tpu_torch.serving.batcher import (BackpressureError,
                                             BatcherClosed, RequestTimeout)
from mxnet_tpu_torch.serving.decode import (DecodeProgram,
                                            init_transformer_lm)

torch.set_num_threads(1)

CFG = dict(vocab=50, units=32, hidden=48, layers=2, heads=4, max_len=64)
ARGS = dict(slots=3, prefill_buckets=(8, 16), page_size=8)
TEMP, TOP_P = 0.8, 0.9
WAIT = 60
HTTP_S = 30
PROMPTS = ([5, 9, 2, 44, 7, 1], [3, 3, 8], [11, 20, 31, 42, 1, 2, 3, 4, 5])


@pytest.fixture(scope='module')
def weights():
    jmodel, np_params = jax_init_lm(**CFG)
    pmodel, _ = init_transformer_lm(**CFG)
    return jmodel, pmodel, np_params


@pytest.fixture(autouse=True)
def no_faults(monkeypatch):
    """Each test starts without scripted faults, both packages' injectors
    re-read."""
    monkeypatch.setenv('MXNET_TPU_FAULT', '')
    jax_policy.get_injector()
    port_policy.get_injector()
    monkeypatch.delenv('MXNET_TPU_FAULT')


def _program(weights, **kw):
    _jm, pmodel, np_params = weights
    return serving.freeze_decode(pmodel, np_params, device='cpu',
                                 **dict(ARGS, **kw))


def _post(port, path, payload, headers=None, raw=None):
    """(code, headers, parsed JSON body) of one POST."""
    req = urllib.request.Request(
        'http://127.0.0.1:%d%s' % (port, path),
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers=dict({'Content-Type': 'application/json'}, **(headers or {})))
    try:
        resp = urllib.request.urlopen(req, timeout=HTTP_S)
        return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as err:
        body = err.read()
        try:
            body = json.loads(body)
        except ValueError:
            body = body.decode()
        return err.code, dict(err.headers), body


def _get(port, path):
    try:
        resp = urllib.request.urlopen('http://127.0.0.1:%d%s' % (port, path),
                                      timeout=HTTP_S)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        body = err.read()
        try:
            body = json.loads(body)
        except ValueError:
            body = body.decode()
        return err.code, body


def _stream(port, payload, headers=None):
    """(status, content type, the NDJSON lines) of one streamed
    /generate."""
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=HTTP_S)
    try:
        conn.request('POST', '/generate', body=json.dumps(payload).encode(),
                     headers=dict({'Content-Type': 'application/json'},
                                  **(headers or {})))
        resp = conn.getresponse()
        raw = resp.read().decode()
        return resp.status, resp.getheader('Content-Type'), \
            [json.loads(ln) for ln in raw.strip().split('\n') if ln]
    finally:
        conn.close()


def _mlp(features=8, classes=4):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation='relu', in_units=features,
                     device='cpu'),
            nn.Dense(classes, in_units=16, device='cpu'))
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype('float32')))
    return net


def _x(n=3, features=8):
    return np.random.RandomState(1).randn(n, features).astype('float32')


def _wait(cond, what, budget=WAIT):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError('timed out waiting for %s' % what)


# -- the routes return the session's results ---------------------------------


def test_predict_data_and_instances_return_the_sessions_results():
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            buckets=(1, 2, 4))
    x = _x()
    with serving.InferenceSession(frozen, max_batch=1, timeout_s=WAIT) \
            as sess, serving.ServingHTTPServer(sess, 0) as srv:
        want = [sess.infer(row)[0] for row in x]
        code, _h, body = _post(srv.port, '/predict', {'data': x[0].tolist()})
        assert code == 200
        assert np.array_equal(np.asarray(body['outputs'][0], 'float32'),
                              want[0])
        code, _h, body = _post(srv.port, '/predict',
                               {'instances': x.tolist()})
        assert code == 200 and len(body['outputs']) == 3
        for got, w in zip(body['outputs'], want):
            assert np.array_equal(np.asarray(got[0], 'float32'), w)
        code, body = _get(srv.port, '/status')
        assert code == 200 and body['mode'] == 'oneshot'
        assert body['batches']['accel'] == 7


@pytest.mark.parametrize('temperature', [0.0, TEMP], ids=['greedy',
                                                          'sampled'])
def test_generate_ndjson_and_plain_return_the_sessions_tokens(weights,
                                                              temperature):
    prog = _program(weights)
    with serving.InferenceSession(prog, timeout_s=WAIT) as sess, \
            serving.ServingHTTPServer(sess, 0) as srv:
        for seed, prompt in enumerate(PROMPTS):
            want = sess.generate(prompt, max_new_tokens=7,
                                 temperature=temperature, top_p=TOP_P,
                                 seed=seed).result(WAIT)
            req = {'tokens': prompt, 'max_new_tokens': 7, 'seed': seed,
                   'temperature': temperature, 'top_p': TOP_P}
            code, ctype, lines = _stream(srv.port, req)
            assert code == 200 and ctype == 'application/x-ndjson'
            assert lines[:-1] == [{'token': t, 'index': i}
                                  for i, t in enumerate(want)]
            assert lines[-1] == {'done': True, 'tokens': want,
                                 'finish_reason': 'length',
                                 'degraded': False}
            code, _h, body = _post(srv.port, '/generate',
                                   dict(req, stream=False))
            assert code == 200
            assert body == {'tokens': want, 'finish_reason': 'length',
                            'degraded': False}
        assert sess.status()['status'] == 'ok'


def test_generate_eos_finishes_the_stream(weights):
    prog = _program(weights)
    with serving.InferenceSession(prog, timeout_s=WAIT) as sess, \
            serving.ServingHTTPServer(sess, 0) as srv:
        full = sess.generate(PROMPTS[0], max_new_tokens=6).result(WAIT)
        code, _ct, lines = _stream(srv.port, {'tokens': PROMPTS[0],
                                              'max_new_tokens': 6,
                                              'eos_id': full[2]})
        stop = full.index(full[2]) + 1
        assert code == 200 and lines[-1]['tokens'] == full[:stop]
        assert lines[-1]['finish_reason'] == 'eos'


def test_generate_adapter_from_body_or_header(weights):
    _jm, pmodel, _np = weights
    prog = _program(weights, adapter_rank=4, adapter_slots=3)
    reg = adapters.AdapterRegistry(adapters.AdapterPool(prog.adapter_spec))
    for i in (0, 1):
        reg.register('ad%d' % i, adapters.init_adapter(
            pmodel, rank=4, seed=30 + i, scale=50.0, name='ad%d' % i))
    with serving.InferenceSession(prog, timeout_s=WAIT, adapters=reg) \
            as sess, serving.ServingHTTPServer(sess, 0) as srv:
        want = {a: sess.generate(PROMPTS[1], max_new_tokens=6,
                                 adapter=a).result(WAIT)
                for a in (None, 'ad0', 'ad1')}
        assert want['ad0'] != want[None] or want['ad1'] != want[None]
        req = {'tokens': PROMPTS[1], 'max_new_tokens': 6, 'stream': False}
        for adapter in ('ad0', 'ad1'):
            code, _h, body = _post(srv.port, '/generate', req,
                                   headers={'X-Mxnet-Adapter': adapter})
            assert code == 200 and body['tokens'] == want[adapter]
        # the body wins over the header
        code, _h, body = _post(srv.port, '/generate',
                               dict(req, adapter='ad1'),
                               headers={'X-Mxnet-Adapter': 'ad0'})
        assert code == 200 and body['tokens'] == want['ad1']


def test_generate_bodies_equal_the_jax_servers(weights):
    """Greedy requests on the same weights: the port's /generate answers
    the JAX package's, NDJSON lines and plain bodies alike."""
    jmodel, _pm, np_params = weights
    jprog = jax_freeze_decode(jmodel, np_params, **ARGS)
    prog = _program(weights)
    reqs = [{'tokens': p, 'max_new_tokens': 6} for p in PROMPTS]
    got = {}
    for name, sess in (('jax', jax_serving.InferenceSession(
            jprog, timeout_s=WAIT)), ('port', serving.InferenceSession(
                prog, timeout_s=WAIT))):
        try:
            srv = (jax_serving.ServingHTTPServer if name == 'jax'
                   else serving.ServingHTTPServer)(sess, 0)
            with srv:
                got[name] = [(_stream(srv.port, r)[2],
                              _post(srv.port, '/generate',
                                    dict(r, stream=False))[2]) for r in reqs]
                got[name + ' healthz'] = _get(srv.port, '/healthz')
                got[name + ' 400'] = _post(srv.port, '/generate',
                                           {'max_new_tokens': 2})[::2]
                got[name + ' bad json'] = _post(srv.port, '/predict', None,
                                                raw=b'{nope')[::2]
        finally:
            sess.close()
    for key in ('', ' healthz', ' 400', ' bad json'):
        assert got['port' + key] == got['jax' + key], key


# -- the status codes ----------------------------------------------------------


class _FakeOneShotSession:
    """Duck-typed stand-in for InferenceSession: the HTTP layer's status
    codes without a model (the reference test's)."""

    def __init__(self, status='ok', fail=None, block=None):
        self._batcher = types.SimpleNamespace(timeout_s=5.0)
        self._engine = None
        self._status = status
        self._fail = fail
        self._block = block
        self.entered = threading.Event()

    def status(self):
        return {'status': self._status, 'breaker': 'closed'}

    def retry_after_hint(self):
        return 2.5

    def infer(self, x, timeout=None):
        if self._block is not None:
            self.entered.set()
            self._block.wait(10)
        if self._fail is not None:
            raise self._fail
        return [np.asarray([1.0, 2.0])]

    def submit(self, x):
        raise AssertionError('unused')


def test_healthz_503_when_unhealthy_200_when_ok():
    sess = _FakeOneShotSession(status='degraded')
    with serving.ServingHTTPServer(sess, 0) as srv:
        assert _get(srv.port, '/healthz') == (503, {'ok': False,
                                                    'status': 'degraded'})
        sess._status = 'ok'
        assert _get(srv.port, '/healthz') == (200, {'ok': True,
                                                    'status': 'ok'})


@pytest.mark.parametrize('fail, code', [
    (BackpressureError(5, 4), 429), (RequestTimeout('lapsed'), 504),
    (BatcherClosed('closed'), 503),
    (WorkerCrashError('worker_crash', 'serving'), 500),
    (ValueError('bad shape'), 400), (RuntimeError('a bug'), 500)],
    ids=['429', '504', '503', '500-crash', '400', '500-bug'])
def test_http_status_taxonomy(fail, code):
    sess = _FakeOneShotSession(fail=fail)
    with serving.ServingHTTPServer(sess, 0) as srv:
        got, headers, body = _post(srv.port, '/predict', {'data': [0.0]})
    assert got == code
    if code == 429:
        assert body['retry_after_s'] == 2.5
        assert int(headers['Retry-After']) == 3      # ceil(2.5)
        assert body['depth'] == 5 and body['limit'] == 4
    elif code == 500:
        assert body['error_class'] == type(fail).__name__
        assert type(fail).__name__ in body['error']
    else:
        assert 'error' in body


def test_http_400_and_404():
    sess = _FakeOneShotSession()
    with serving.ServingHTTPServer(sess, 0) as srv:
        assert _post(srv.port, '/predict', None, raw=b'{nope')[::2] == \
            (400, {'error': 'bad JSON'})
        assert _post(srv.port, '/predict', {'x': 1})[::2] == \
            (400, {'error': "need 'data' or 'instances'"})
        assert _post(srv.port, '/predict', [1, 2])[0] == 400
        for path in ('/nope', '/trace'):
            assert _get(srv.port, path)[0] == 404, path
            assert _post(srv.port, path, {'data': [0.0]})[0] == 404, path
        # the drain routes: an empty snapshot, and no import without a
        # decode session; their other method is no route
        assert _get(srv.port, '/drain') == (200, {
            'schema': 'mxnet_tpu.drain.v1', 'draining': False,
            'complete': False, 'pending': 0, 'sequences': []})
        code, _h, body = _post(srv.port, '/import', {'seqstate': {}})
        assert code == 400 and 'decode-mode' in body['error']
        assert _post(srv.port, '/drain', {'data': [0.0]})[0] == 404
        assert _get(srv.port, '/import')[0] == 404
        # the 404s left the keep-alive state intact for the next request
        assert _post(srv.port, '/predict', {'data': [0.0]})[0] == 200


def test_http_concurrency_gate_sheds_429():
    block = threading.Event()
    sess = _FakeOneShotSession(block=block)
    with serving.ServingHTTPServer(sess, 0, max_concurrent=1) as srv:
        results = {}
        t = threading.Thread(target=lambda: results.update(
            first=_post(srv.port, '/predict', {'data': [0.0]})))
        t.start()
        assert sess.entered.wait(5.0)
        code, headers, body = _post(srv.port, '/predict', {'data': [0.0]})
        assert code == 429 and 'concurrency limit' in body['error']
        assert body['limit'] == 1 and int(headers['Retry-After']) == 3
        block.set()
        t.join(10)
        assert results['first'][0] == 200


def test_http_concurrency_shed_keeps_keepalive_in_sync():
    block = threading.Event()
    sess = _FakeOneShotSession(block=block)
    with serving.ServingHTTPServer(sess, 0, max_concurrent=1) as srv:
        t = threading.Thread(target=lambda: _post(srv.port, '/predict',
                                                  {'data': [0.0]}))
        t.start()
        try:
            assert sess.entered.wait(5.0)
            conn = http.client.HTTPConnection('127.0.0.1', srv.port,
                                              timeout=HTTP_S)
            body = json.dumps({'data': [0.0] * 64}).encode()
            hdrs = {'Content-Type': 'application/json',
                    'Content-Length': str(len(body))}
            conn.request('POST', '/predict', body=body, headers=hdrs)
            resp = conn.getresponse()
            assert resp.status == 429
            resp.read()
            block.set()
            t.join(10)
            # the same connection: the retry parses as a fresh request
            conn.request('POST', '/predict', body=body, headers=hdrs)
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read()
            conn.close()
        finally:
            block.set()
            t.join(10)


def test_http_429_from_a_full_queue_carries_the_sessions_hint(weights):
    """A real session past its queue: the one-shot batcher's and the
    decode engine's own Retry-After."""
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            buckets=(1,))
    gate = threading.Event()
    run = frozen.run

    def blocked(arrays, n=None):
        gate.wait(10)
        return run(arrays, n)

    frozen.run = blocked
    x = _x()
    with serving.InferenceSession(frozen, max_batch=1, max_queue=1,
                                  timeout_s=WAIT) as sess, \
            serving.ServingHTTPServer(sess, 0) as srv:
        futs = [sess.submit(x[0])]
        _wait(lambda: sess.stats()['queue']['depth'] == 0, 'the worker')
        futs.append(sess.submit(x[1]))          # the queue is full
        code, headers, body = _post(srv.port, '/predict',
                                    {'data': x[2].tolist()})
        assert code == 429 and body['depth'] == 1 and body['limit'] == 1
        hint = sess.retry_after_hint()
        assert body['retry_after_s'] == pytest.approx(hint, rel=0.5)
        assert int(headers['Retry-After']) >= 1
        gate.set()
        for f in futs:
            f.result(WAIT)
    prog = _program(weights)
    with serving.InferenceSession(prog, max_queue=0, timeout_s=WAIT) \
            as sess, serving.ServingHTTPServer(sess, 0) as srv:
        code, headers, body = _post(srv.port, '/generate',
                                    {'tokens': [1, 2], 'stream': False})
        assert code == 429 and body['limit'] == 0
        assert body['retry_after_s'] == sess.retry_after_hint() == \
            sess._engine.retry_after_hint()
        assert int(headers['Retry-After']) == max(1, int(
            body['retry_after_s'] + 0.999))


def test_http_504_when_the_budget_lapses():
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            buckets=(1,))
    gate = threading.Event()
    run = frozen.run
    frozen.run = lambda arrays, n=None: (gate.wait(10), run(arrays, n))[1]
    with serving.InferenceSession(frozen, max_batch=1, timeout_s=0.3) \
            as sess, serving.ServingHTTPServer(sess, 0) as srv:
        try:
            code, _h, body = _post(srv.port, '/predict',
                                   {'data': _x()[0].tolist()})
        finally:
            gate.set()
    assert code == 504 and body['error']


def test_http_503_on_a_closed_session(weights):
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            buckets=(1,))
    sess = serving.InferenceSession(frozen, timeout_s=WAIT)
    dsess = serving.InferenceSession(_program(weights), timeout_s=WAIT)
    sess.close()
    dsess.close()
    with serving.ServingHTTPServer(sess, 0, decode_session=dsess) as srv:
        assert _post(srv.port, '/predict', {'data': [0.0] * 8})[0] == 503
        code, _h, body = _post(srv.port, '/generate', {'tokens': [1, 2]})
        assert code == 503 and 'closed' in body['error']


@pytest.mark.parametrize('kind', ['worker_crash', 'preempt'])
def test_generate_stream_fault_typed_error_line_and_recovery(
        weights, monkeypatch, kind):
    """A fault mid-stream ends the NDJSON stream with a typed error line
    and frees the slot; after the breaker's half-open window the same
    session serves clean; the same fault on a plain request is a typed
    500 (``tests/test_decode.py:692``)."""
    names = {'worker_crash': 'WorkerCrashError',
             'preempt': 'PreemptionSignal'}
    prog = _program(weights)
    sess = serving.InferenceSession(
        prog, timeout_s=10.0,
        breaker=CircuitBreaker(failure_threshold=1, reset_timeout=0.2))
    try:
        want = sess.generate([3, 4], max_new_tokens=3).result(WAIT)
        with serving.ServingHTTPServer(sess, 0) as srv:
            monkeypatch.setenv('MXNET_TPU_FAULT',
                               '%s@serving.decode.%d:1'
                               % (kind, sess._engine._op_seq + 2))
            code, _ct, lines = _stream(srv.port, {'tokens': [1, 2],
                                                  'max_new_tokens': 6})
            assert code == 200
            assert any('token' in ln for ln in lines)
            last = lines[-1]
            assert last['done'] is True
            assert last['error_class'] == names[kind]
            assert names[kind] in last['error']
            _wait(lambda: sess.stats()['free_slots'] == ARGS['slots'],
                  'the slot')
            time.sleep(0.25)
            code, _h, body = _post(srv.port, '/generate',
                                   {'tokens': [3, 4], 'max_new_tokens': 3,
                                    'stream': False})
            assert code == 200
            assert body == {'tokens': want, 'finish_reason': 'length',
                            'degraded': False}
            monkeypatch.setenv('MXNET_TPU_FAULT',
                               '%s@serving.decode.%d:1'
                               % (kind, sess._engine._op_seq))
            code, _h, body = _post(srv.port, '/generate',
                                   {'tokens': [3, 4], 'max_new_tokens': 3,
                                    'stream': False})
            assert code == 500 and body['error_class'] == names[kind]
    finally:
        sess.close()


def test_degraded_stream_and_healthz_503_while_the_breaker_is_open(
        weights, monkeypatch):
    """A transient fault: the stream completes on the CPU with the healthy
    tokens, its done line ``degraded: true``; /healthz and /status read
    503 / degraded while the breaker is open."""
    prog = _program(weights)
    frozen = serving.freeze(_mlp(), data_shapes=[('data', (8,))],
                            buckets=(1,))
    with serving.InferenceSession(frozen, timeout_s=WAIT) as osess, \
            serving.InferenceSession(
                prog, timeout_s=WAIT,
                breaker=CircuitBreaker(failure_threshold=1,
                                       reset_timeout=300.0)) as sess, \
            serving.ServingHTTPServer(osess, 0,
                                      decode_session=sess) as srv:
        want = sess.generate(PROMPTS[0], max_new_tokens=8).result(WAIT)
        assert _get(srv.port, '/healthz') == (200, {'ok': True,
                                                    'status': 'ok'})
        monkeypatch.setenv('MXNET_TPU_FAULT', 'device_loss@serving.decode')
        code, _ct, lines = _stream(srv.port, {'tokens': PROMPTS[0],
                                              'max_new_tokens': 8})
        assert code == 200
        assert [ln['token'] for ln in lines[:-1]] == want
        assert lines[-1] == {'done': True, 'tokens': want,
                             'finish_reason': 'length', 'degraded': True}
        assert sess.status()['breaker'] == 'open'
        assert _get(srv.port, '/healthz') == (503, {'ok': False,
                                                    'status': 'degraded'})
        code, body = _get(srv.port, '/status')
        assert code == 200 and body['status'] == 'degraded'
        assert body['predict']['status'] == 'ok'
        assert body['generate']['status'] == 'degraded'
        assert body['generate']['decode']['counts']['fallback_tokens'] \
            == len(want)


def test_fleet_keys_answer_400_not_ported(weights):
    """The fleet's ``/generate`` keys, once refused ``NotPorted``, are
    served: ``request_id`` is echoed on the done line, ``start_index``
    offsets the streamed indices, and a ``prefill_only`` done line carries
    the ``seqstate``; a bad ``start_index`` and the other bad bodies are
    still 400."""
    prog = _program(weights)
    with serving.InferenceSession(prog, timeout_s=WAIT) as sess, \
            serving.ServingHTTPServer(sess, 0) as srv:
        want = sess.generate(PROMPTS[0], max_new_tokens=5).result(WAIT)
        code, _ct, lines = _stream(srv.port, {
            'tokens': PROMPTS[0], 'max_new_tokens': 5, 'request_id': 'r1',
            'start_index': 7})
        assert code == 200
        assert [ln['index'] for ln in lines[:-1]] == list(range(7, 12))
        assert lines[-1] == {'done': True, 'tokens': want,
                             'finish_reason': 'length', 'degraded': False,
                             'request_id': 'r1'}
        code, _h, body = _post(srv.port, '/generate', {
            'tokens': PROMPTS[0], 'max_new_tokens': 5, 'stream': False,
            'prefill_only': True, 'request_id': 'r2'})
        assert code == 200 and body['finish_reason'] == 'migrated'
        assert body['tokens'] == want[:1] and body['request_id'] == 'r2'
        assert body['seqstate']['kind'] == 'paged'
        assert body['seqstate']['request_id'] == 'r2'
        assert body['seqstate']['emitted'] == want[:1]
        assert sess.stats()['counts']['prefill_exports'] == 1
        assert _post(srv.port, '/generate', {'tokens': [1, 2],
                                             'start_index': 'x'})[0] == 400
        for bad in ({'tokens': [1, 2], 'temperature': 'hot'},
                    {'tokens': [1, 2], 'temperature': -1.0},
                    {'tokens': []}, {'tokens': list(range(40))},
                    {'tokens': [1, 2], 'adapter': 'nope'}):
            assert _post(srv.port, '/generate', bad)[0] == 400, bad
        # /predict on a decode session is the caller's error
        assert _post(srv.port, '/predict', {'data': [0.0]})[0] == 400


def test_client_that_goes_away_cancels_its_stream(weights):
    prog = _program(weights)
    step = prog.run_step

    def slow(*args, **kw):
        time.sleep(0.02)
        return step(*args, **kw)

    prog.run_step = slow
    with serving.InferenceSession(prog, timeout_s=WAIT) as sess, \
            serving.ServingHTTPServer(sess, 0) as srv:
        sock = socket.create_connection(('127.0.0.1', srv.port),
                                        timeout=HTTP_S)
        body = json.dumps({'tokens': [1, 2, 3], 'max_new_tokens': 50})
        sock.sendall(('POST /generate HTTP/1.1\r\nHost: x\r\n'
                      'Content-Type: application/json\r\n'
                      'Content-Length: %d\r\n\r\n%s'
                      % (len(body), body)).encode())
        assert b'"token"' in sock.recv(4096) or b'"token"' in sock.recv(4096)
        sock.close()
        _wait(lambda: sess.stats()['counts']['retired'].get('cancelled'),
              'the cancel')
        st = sess.stats()
        assert st['counts']['tokens'] < 50
        _wait(lambda: sess.stats()['free_slots'] == ARGS['slots'],
              'the slot')


# -- the knobs -------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_server_is_off_by_default_and_on_with_the_port_knob(monkeypatch):
    sess = _FakeOneShotSession()
    monkeypatch.delenv('MXNET_TPU_SERVE_HTTP_PORT', raising=False)
    assert serving.maybe_start_http_server(sess) is None
    monkeypatch.setenv('MXNET_TPU_SERVE_HTTP_PORT', '0')
    assert serving.maybe_start_http_server(sess) is None
    port = _free_port()
    monkeypatch.setenv('MXNET_TPU_SERVE_HTTP_PORT', str(port))
    srv = serving.maybe_start_http_server(sess)
    try:
        assert srv is not None and srv.port == port and \
            srv.host == '127.0.0.1'
        assert _get(port, '/healthz') == (200, {'ok': True, 'status': 'ok'})
    finally:
        srv.stop()


def test_max_concurrent_knob_sets_the_gate(monkeypatch):
    monkeypatch.setenv('MXNET_TPU_SERVE_MAX_CONCURRENT', '3')
    assert serving.ServingHTTPServer(_FakeOneShotSession(), 0) \
        .max_concurrent == 3
    assert serving.ServingHTTPServer(_FakeOneShotSession(), 0,
                                     max_concurrent=0).max_concurrent == 0


def test_spec_draft_knob_loads_the_draft(weights, tmp_path, monkeypatch):
    draft = _program(weights, paged=False)
    art = draft.save(str(tmp_path / 'draft.frozen'))
    plain = _program(weights)
    with serving.InferenceSession(plain, timeout_s=WAIT) as sess:
        want = [sess.generate(p, max_new_tokens=8).result(WAIT)
                for p in PROMPTS]
    monkeypatch.setenv('MXNET_TPU_SERVE_SPEC_DRAFT', art)
    with serving.InferenceSession(_program(weights), timeout_s=WAIT) as sess:
        assert sess.draft is None       # spec_k 0: no speculation, no load
    target = _program(weights, spec_k=2)
    with serving.InferenceSession(target, timeout_s=WAIT) as sess, \
            serving.ServingHTTPServer(sess, 0) as srv:
        assert isinstance(sess.draft, DecodeProgram)
        assert not sess.draft.paged and sess.draft.device.type == 'cpu'
        got = [_post(srv.port, '/generate',
                     {'tokens': p, 'max_new_tokens': 8,
                      'stream': False})[2]['tokens'] for p in PROMPTS]
        spec = sess.stats()['spec']
    assert got == want
    assert spec['proposed'] > 0 and spec['acceptance_rate'] >= 0.9
