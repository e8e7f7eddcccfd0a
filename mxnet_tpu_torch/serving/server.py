"""InferenceSession and ServingHTTPServer, the port of
``mxnet_tpu/serving/server.py`` (:64-157, 224-1200): the request path a
serving frontend talks to, and the JSON endpoint over it.

Two modes, chosen by the program:

  * a :class:`~.freeze.FrozenProgram` (one-shot inference) is served
    behind the flush :class:`~.batcher.MicroBatcher`: ``submit`` ->
    admission control (bounded queue, typed
    :class:`~.batcher.BackpressureError`) -> micro-batch flush
    (``max_batch`` or ``deadline_ms``) -> pad to the bucket -> the block
    on the program's device -> outputs copied to the host -> unpad ->
    per-request futures;
  * a :class:`~.decode.DecodeProgram` (slot or paged) goes to the
    continuous-batching :class:`~.decode.engine.DecodeEngine`
    (:meth:`InferenceSession.generate`); ``draft=`` (a slot program)
    turns on speculative decoding for a paged program with ``spec_k > 0``,
    and ``adapters=`` (an ``AdapterRegistry`` or an artifact root) backs the
    adapter ids of a program built with an adapter pool.

Failure path: every device-side batch runs under a circuit breaker
(threshold ``MXNET_TPU_SERVE_BREAKER``, reset after 30 s) and a stall
watchdog (``watchdog=True``; budget ``MXNET_TPU_WATCHDOG_STEP_S``, its
artifact at ``stall_artifact``), at the fault-injection site ``serving``
(the watchdog's beats at ``serving.infer``; a decode session's engine and
watchdog at ``serving.decode``). A transient failure, or a batch the open
breaker refuses, is re-served on the CPU by
:meth:`~.freeze.FrozenProgram.run_fallback`: the requests complete
degraded, counted in ``status()['batches']['fallback']``. A worker crash
or a preemption notice fails the batch with that typed error; anything
else, a kernel's build or launch failure among them, fails it loudly.
:meth:`InferenceSession.status` reads ``degraded`` while the card is
failing and ``ok`` after the next batch it serves. The watchdog's monitor
thread, for a call that blocks for real, writes the stall artifact
(where ``stall_artifact`` names one), counts a breaker failure and marks
the session degraded; the heartbeat is armed only while a batch is on the
card, so an idle session stays ``ok``. The degraded / error record is a
:class:`~.health.Health`, as the decode engine's is.

Knob defaults come from ``MXNET_TPU_SERVE_*`` (``mxnet_tpu_torch/config.py``);
constructor arguments win. Arguments of the other mode are ignored, as in
the JAX session. A paged program with ``spec_k > 0`` and no ``draft=``
loads its draft from the ``MXNET_TPU_SERVE_SPEC_DRAFT`` artifact, when the
knob names one, on the program's device.

:class:`ServingHTTPServer` is the reference's stdlib endpoint, off by
default (:func:`maybe_start_http_server` starts it only for a nonzero
``MXNET_TPU_SERVE_HTTP_PORT``), bound to 127.0.0.1: ``GET /status`` and
``/healthz``, ``POST /predict`` and ``/generate`` (chunked NDJSON or one
JSON body), with the reference's bodies and status codes, and the
replica's half of the serving fleet: a ``/generate`` body's
``request_id`` (echoed on the done line), ``start_index`` (offsets the
streamed indices) and ``prefill_only`` (the ``seqstate`` payload on the
done line), ``POST /import`` (continue a payload here) and ``GET
/drain`` (the payloads of a drain), with the drain lifecycle
(:meth:`ServingHTTPServer.begin_drain`, ``serve_until_drained``,
``install_preempt_hook``: SIGTERM drains and the process exits 75). Its
handler threads only call the sessions' ``infer`` / ``submit`` /
``generate`` and the engine's export / import, which its worker services:
the decode engine's worker alone touches the card.

Request tracing (``MXNET_TPU_TRACE``, the reference's
``server.py:538-541, 603-626, 880-900``): each endpoint has its own
``SpanBuffer`` (site ``replica:<port>``), which its engines'
``trace_sink`` points at. An admitted POST opens ``srv.generate``,
``srv.predict`` or ``srv.import`` under the ``X-Mxnet-Trace`` header's
context and activates it on the handler thread, so the engine's ``eng.*``
spans nest under it; ``GET /drain`` opens ``srv.drain``, and ``GET
/trace?since=N`` answers the buffer's NDJSON. With tracing off nothing is
parsed or allocated: the shared null span.

Telemetry (``MXNET_TPU_TELEMETRY``, the reference's ``server.py:304-396,
1072-1166``): a trip sets ``mxnet_tpu_serve_degraded`` and records
``breaker_open`` (dumping the flight ring) or ``serve_fallback``
(:class:`~.health.Health`), a fallback batch counts
``mxnet_tpu_serve_fallback_batches_total``, and a drain counts
``mxnet_tpu_serve_drains_total``, records ``drain_begin`` and, when it
completes, ``drain_complete`` and ``mxnet_tpu_serve_drain_seconds``.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as onp

from .. import config as _config
from ..observability import emit as _emit
from ..observability import trace as _trace
from ..resilience.policy import (CircuitBreaker, CircuitOpenError,
                                 PreemptionSignal, WorkerCrashError, inject,
                                 is_transient)
from ..resilience.preempt import (Preempted, PreemptionHandler,
                                  resumable_exit_code)
from ..resilience.watchdog import Watchdog
from .batcher import (BackpressureError, BatcherClosed, MicroBatcher,
                      RequestTimeout)
from .decode.engine import DecodeEngine
from .decode.program import DecodeProgram, load_decode
from .freeze import FrozenProgram
from .health import Health

__all__ = ['InferenceSession', 'ServingHTTPServer', 'maybe_start_http_server']

# an HTTP handler's longest wait when MXNET_TPU_SERVE_TIMEOUT_S=0 disables
# the per-request budget: a handler thread never blocks for ever
_HTTP_MAX_WAIT_S = 300.0
DRAIN_SCHEMA = 'mxnet_tpu.drain.v1'


def _pick(value, knob):
    return value if value is not None else _config.get(knob)


class InferenceSession:
    """Serve a :class:`FrozenProgram` (:meth:`submit`, :meth:`infer`,
    :meth:`infer_batch`) or a :class:`DecodeProgram` (:meth:`generate`).
    Warm a frozen program's buckets first with
    :meth:`FrozenProgram.warmup`; a decode program's engine builds its
    programs (and the draft's) as the session starts.

    ``breaker`` (default: ``MXNET_TPU_SERVE_BREAKER`` failures, 30 s
    reset) and ``watchdog`` (True: a stall watchdog at site
    ``serving.infer`` or ``serving.decode`` whose monitor thread runs
    until :meth:`close`; ``stall_artifact`` its artifact's path, None
    for none: the record is then only logged) guard the
    device calls (see the module)."""

    def __init__(self, program, max_batch=None, deadline_ms=None,
                 max_queue=None, timeout_s=None, name=None,
                 max_new_tokens=None, prefill_interleave=None, draft=None,
                 adapters=None, breaker=None, watchdog=True,
                 stall_artifact=None):
        self.name = name or getattr(program, 'name', None)
        max_queue = int(_pick(max_queue, 'MXNET_TPU_SERVE_QUEUE_DEPTH'))
        timeout_s = float(_pick(timeout_s, 'MXNET_TPU_SERVE_TIMEOUT_S'))
        decode = isinstance(program, DecodeProgram)
        if not decode and not isinstance(program, FrozenProgram):
            raise TypeError('InferenceSession serves a FrozenProgram or a '
                            'DecodeProgram; got %s (use serving.freeze / '
                            'freeze_decode first)' % type(program).__name__)
        self.program = program
        self._lock = threading.Lock()
        self._engine = self._batcher = None
        self.draft = None
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=max(1, int(_config.get(
                'MXNET_TPU_SERVE_BREAKER'))), reset_timeout=30.0)
        self._watchdog = None
        if watchdog:
            phase = 'decode' if decode else 'infer'
            self._watchdog = Watchdog(
                budgets={phase: float(_config.get(
                    'MXNET_TPU_WATCHDOG_STEP_S'))},
                artifact_path=stall_artifact, name=self.name,
                site='serving.' + phase,
                on_stall=(lambda rec: self._engine.on_stall(rec))
                if decode else self._on_real_stall)
            # a real hang blocks the worker inside the device call: only
            # the monitor thread can see the stale heartbeat
            self._watchdog.start()
        if decode:
            if draft is None and program.paged and int(program.spec_k) > 0:
                draft_path = _config.get('MXNET_TPU_SERVE_SPEC_DRAFT')
                if draft_path:
                    draft = load_decode(str(draft_path),
                                        device=program.device)
            self.draft = draft
            self._engine = DecodeEngine(
                program, max_queue=max_queue, timeout_s=timeout_s,
                max_new_tokens=int(_pick(max_new_tokens,
                                         'MXNET_TPU_SERVE_MAX_NEW_TOKENS')),
                prefill_interleave=int(_pick(
                    prefill_interleave,
                    'MXNET_TPU_SERVE_PREFILL_INTERLEAVE')),
                name=self.name, draft=draft, adapters=adapters,
                breaker=self._breaker, watchdog=self._watchdog)
            return
        self.frozen = program
        top = program.policy.max_batch
        max_batch = int(max_batch if max_batch is not None else
                        min(top, _config.get('MXNET_TPU_SERVE_MAX_BATCH')))
        if max_batch > top:
            raise ValueError('max_batch %d exceeds the largest bucket %d'
                             % (max_batch, top))
        self._by_bucket = {}
        self._batch_seq = 0
        self._accel_batches = self._fallback_batches = 0
        self._health = Health(self._breaker, 'serving %s' % self.name)
        self._batcher = MicroBatcher(
            self._run_batch, max_batch=max_batch,
            deadline_ms=float(_pick(deadline_ms,
                                    'MXNET_TPU_SERVE_DEADLINE_MS')),
            max_queue=max_queue, timeout_s=timeout_s, name=self.name,
            example_shapes=[s for _n, s, _dt in program.data_descs])

    # -- one-shot requests -------------------------------------------------

    def _require_oneshot(self, what):
        if self._batcher is None:
            raise TypeError('%s serves one-shot programs; this session '
                            'wraps a DecodeProgram: use generate()' % what)

    def submit(self, *arrays):
        """Enqueue one single-example request; returns a Future whose
        result is the list of per-example output arrays."""
        self._require_oneshot('submit')
        return self._batcher.submit(*arrays)

    def infer(self, *arrays, timeout=None):
        """Blocking single-request inference through the batcher."""
        self._require_oneshot('infer')
        return self._batcher.infer(*arrays, timeout=timeout)

    def infer_batch(self, arrays):
        """Run an already-stacked batch (one array per input, n rows)
        through the bucketed program directly, on the caller's thread,
        under the breaker as a batch of the queue is: the bulk path; the
        queue is for concurrent single requests."""
        self._require_oneshot('infer_batch')
        arrays = list(arrays)
        n = onp.asarray(arrays[0]).shape[0]
        return self._serve(arrays, n, self._next_seq())

    def _next_seq(self):
        with self._lock:
            seq = self._batch_seq
            self._batch_seq += 1
        return seq

    def _run_batch(self, stacked, n):
        # the batcher's worker: the program runs on its device and
        # returns host arrays, so the futures resolve with data on the host
        outs = self._serve(stacked, n, self._next_seq())
        bucket = self.frozen.policy.bucket_for(n)
        with self._lock:
            self._by_bucket[bucket] = self._by_bucket.get(bucket, 0) + 1
        return outs

    def _on_real_stall(self, record):
        """The watchdog monitor's escalation: a batch overran its budget
        with the worker still inside the device call."""
        self._health.stalled(record)

    def _execute_accel(self, stacked, n, seq):
        inject('serving',
               ('device_loss', 'device_unavailable', 'tunnel_stall',
                'worker_crash', 'preempt'), step=seq)
        if self._watchdog is not None:
            # a scripted hang@serving.infer aged the heartbeat at beat():
            # check() writes the stall artifact and raises
            # TunnelStallError into the breaker
            self._watchdog.check()
        return self.frozen.run(stacked, n)

    def _serve(self, stacked, n, seq):
        """One batch on the card under the breaker: degraded to
        ``run_fallback`` on a transient failure or an open breaker, failed
        typed on a worker crash or a preemption notice, re-raised
        otherwise."""
        if self._watchdog is not None:
            self._watchdog.beat(step=seq, phase='infer')
        was_open = self._breaker.state == 'open'
        try:
            try:
                outs = self._breaker.call(self._execute_accel, stacked, n,
                                          seq)
            finally:
                # armed for the call only: an idle session never stalls
                if self._watchdog is not None:
                    self._watchdog.idle()
        except (WorkerCrashError, PreemptionSignal) as exc:
            # the work itself died: fail the batch typed (the breaker
            # counted the failure, so repeated crashes still open it)
            self._health.failed(exc, 'batch %d' % seq, was_open, step=seq)
            raise
        except Exception as exc:
            if not (is_transient(exc) or isinstance(exc, CircuitOpenError)):
                raise               # bug-shaped: fail the requests loudly
            self._health.failed(exc, 'batch %d' % seq, was_open, step=seq)
            outs = self.frozen.run_fallback(stacked, n)
            with self._lock:
                self._fallback_batches += 1
            inst = _emit.serving()
            if inst is not None:
                inst.fallbacks.inc()
            return outs
        self._health.recovered()
        with self._lock:
            self._accel_batches += 1
        return outs

    # -- generation --------------------------------------------------------

    def generate(self, tokens, max_new_tokens=None, eos_id=None,
                 request_id=None, prefill_only=False, trace=None,
                 adapter=None, temperature=None, top_p=None, seed=None):
        """Stream a generation: returns a
        :class:`~.decode.engine.GenerateStream` (iterate per token, or
        ``.result(timeout)`` for the whole sequence). ``request_id`` keeps
        one stream a request (a second admission cancels the first);
        ``prefill_only`` finishes ``'migrated'`` at the prefill boundary
        with the payload on ``stream.seqstate``; ``trace`` (a
        ``TraceContext``) nests the engine's spans under it. ``adapter``
        picks the adapter and ``temperature`` / ``top_p`` / ``seed`` the
        sampling law (the engine's defaults: the base, greedy)."""
        if self._engine is None:
            raise TypeError('generate() needs a DecodeProgram session (use '
                            'serving.freeze_decode)')
        kwargs = {'max_new_tokens': max_new_tokens, 'eos_id': eos_id}
        for key, value in (('request_id', request_id),
                           ('prefill_only', prefill_only or None),
                           ('trace', trace), ('adapter', adapter),
                           ('temperature', temperature), ('top_p', top_p),
                           ('seed', seed)):
            if value is not None:
                kwargs[key] = value
        return self._engine.generate(tokens, **kwargs)

    # -- lifecycle ---------------------------------------------------------

    def retry_after_hint(self):
        """Estimated seconds until a newly admitted request could be
        served: the engine's or the batcher's estimate, the
        ``Retry-After`` of an HTTP 429."""
        if self._engine is not None:
            return self._engine.retry_after_hint()
        return self._batcher.retry_after_hint()

    def stats(self):
        """The decode engine's stats, or for a one-shot session the
        batcher's queue stats, the bucket ladder, the buckets run and the
        batches run by bucket."""
        if self._engine is not None:
            return self._engine.stats()
        with self._lock:
            by_bucket = dict(sorted(self._by_bucket.items()))
        return {'name': self.name, 'buckets': list(self.frozen.policy.buckets),
                'compiled': self.frozen.compile_count,
                'batches_by_bucket': by_bucket,
                'queue': self._batcher.stats()}

    def status(self):
        """The session's state, the reference's record: ``status`` ``ok``
        or ``degraded``, ``name``, ``breaker`` and ``error``; for decode
        ``mode``, the engine's stats under ``decode`` and the program's
        ladder, slots, max_len and programs built (and ``paged`` for a
        paged program); for one-shot ``mode`` and the batches served on
        the card and on the CPU (``batches``), the ladder, the buckets run
        and the queue."""
        if self._engine is not None:
            stats = self._engine.stats()
            prog = self.program
            record = {
                'status': 'degraded' if stats['degraded'] else 'ok',
                'name': self.name,
                'mode': 'decode',
                'breaker': stats['breaker'],
                'error': stats['error'],
                'decode': stats,
                'prefill_buckets': list(prog.policy.buckets),
                'slots': prog.slots,
                'max_len': prog.max_len,
                'compiled': prog.compile_count,
            }
            if prog.paged:
                record['paged'] = {'page_size': prog.page_size,
                                   'pages': prog.pages,
                                   'max_pages': prog.max_pages,
                                   'spec_k': int(prog.spec_k)}
            return record
        with self._lock:
            record = {
                'status': 'degraded' if self._health.degraded else 'ok',
                'name': self.name,
                'mode': 'oneshot',
                'breaker': self._breaker.state,
                'error': self._health.error,
                'batches': {'accel': self._accel_batches,
                            'fallback': self._fallback_batches},
            }
        record['buckets'] = list(self.frozen.policy.buckets)
        record['compiled'] = self.frozen.compile_count
        record['queue'] = self._batcher.stats()
        return record

    def close(self, drain=True, timeout=30.0):
        if self._engine is not None:
            self._engine.close(drain=drain, timeout=timeout)
        else:
            self._batcher.close(drain=drain, timeout=timeout)
        if self._watchdog is not None:
            self._watchdog.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _wait_s(session):
    """A handler's wait for ``session``'s result: its per-request budget,
    else :data:`_HTTP_MAX_WAIT_S`."""
    src = session._batcher if session._batcher is not None \
        else session._engine
    return src.timeout_s or _HTTP_MAX_WAIT_S


class ServingHTTPServer:
    """Stdlib JSON endpoint over an :class:`InferenceSession`, the
    reference's (``mxnet_tpu/serving/server.py:465-1200``). Routes::

        GET  /status    the session's status() (with a decode_session:
                        {"status": worst, "predict": ..., "generate": ...})
        GET  /healthz   {"ok": true|false, "status": ...}: 200 when every
                        session reads ok, 503 otherwise (breaker open,
                        degraded, or "draining")
        GET  /drain     the mxnet_tpu.drain.v1 snapshot: the payloads a
                        drain exported (?request_id= picks one); serving a
                        payload marks it handed off
        GET  /trace     mxnet_tpu.trace.v1 span records as NDJSON: a
                        header line {"schema", "site", "cursor", "count"},
                        then each record with seq > ?since= (default 0)
        POST /predict   {"data": [...]} one example, or
                        {"instances": [[...], ...]} many
                        -> {"outputs": ...}
        POST /generate  {"tokens": [...], "max_new_tokens", "eos_id",
                         "stream", "adapter" (or the X-Mxnet-Adapter
                         header), "temperature", "top_p", "seed",
                         "request_id", "start_index", "prefill_only"}:
                        stream true (the default) answers chunked NDJSON,
                        a {"token", "index"} line a token (the index from
                        start_index on), then {"done": true, "tokens",
                        "finish_reason", "degraded"} with "request_id"
                        and, after prefill_only, "seqstate" on it (a
                        failure mid-stream: "error" / "error_class"; a
                        "migrated" finish is no error); stream false one
                        {"tokens", "finish_reason", "degraded", ...} body
        POST /import    {"seqstate": {...}, "stream", "start_index"}:
                        continue a payload here, answered as /generate;
                        the indices continue at len(emitted) unless
                        start_index says otherwise

    ``decode_session`` mounts a second, decode session behind
    ``/generate`` and ``/import``. Status codes: 200 served (``degraded``
    when the CPU did the work), 429 shed by a full queue, a full pool at
    import or past ``max_concurrent`` in-flight POSTs (default
    ``MXNET_TPU_SERVE_MAX_CONCURRENT``, 0: unbounded), each with
    ``Retry-After``, 504 the per-request budget lapsed, 503 the session
    closed or the replica draining (``error_class`` ``Draining``,
    ``Retry-After: 1``), 500 typed (``error_class``) on an aborted request
    or a bug, 400 a caller's error (bad JSON, shapes, a prompt past the
    ladder, a bad ``start_index``, a refused payload), 404 any other path.
    Binds ``host`` (127.0.0.1); port 0 picks a free one, read back from
    :attr:`port` after :meth:`start`.

    The drain (:meth:`begin_drain`): ``/healthz`` answers 503 ``draining``,
    every POST sheds 503 ``Draining`` after its body is read, every
    sequence in flight is exported and served over ``GET /drain``, and
    once every payload is fetched (or ``MXNET_TPU_SERVE_DRAIN_TIMEOUT_S``
    passes) the sessions close and :attr:`drain_result` records the
    resumable exit code."""

    def __init__(self, session, port, host='127.0.0.1', decode_session=None,
                 max_concurrent=None):
        self.session = session
        self.decode_session = decode_session
        self.host = host
        self.port = int(port)
        self.max_concurrent = int(
            max_concurrent if max_concurrent is not None
            else _config.get('MXNET_TPU_SERVE_MAX_CONCURRENT'))
        self._httpd = None
        self._thread = None
        self._draining = False
        self._drain_lock = threading.Lock()
        self._drain_payloads = []
        self._drain_unserved = set()
        self._drain_result = None
        self._drain_done = threading.Event()
        self._drain_thread = None
        self._preempt = None
        self._preempt_stop = threading.Event()
        self._preempt_thread = None
        # one buffer an endpoint, not the process's: a process hosting a
        # fleet keeps a site a replica (the bound port, set at start)
        self._trace_buf = _trace.SpanBuffer(site='replica:%d' % self.port)

    def _statuses(self):
        st = self.session.status()
        if self.decode_session is None:
            return st, st['status']
        dst = self.decode_session.status()
        worst = st['status'] if st['status'] != 'ok' else dst['status']
        return {'status': worst, 'predict': st, 'generate': dst}, worst

    def _gen_session(self):
        return self.decode_session if self.decode_session is not None \
            else self.session

    def _retry_after(self, path):
        src = self._gen_session() if path in ('/generate', '/import') \
            else self.session
        try:
            return float(src.retry_after_hint())
        except Exception:  # noqa: BLE001 - a hint, never a failure
            return 1.0

    def start(self):
        if self._httpd is not None:
            return self
        srv = self
        gate = threading.BoundedSemaphore(self.max_concurrent) \
            if self.max_concurrent > 0 else None

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 so /generate can stream chunked NDJSON; every other
            # response carries its Content-Length
            protocol_version = 'HTTP/1.1'

            def _json(self, code, payload, headers=None):
                body = (json.dumps(payload, sort_keys=True) + '\n').encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _shed(self, path, payload):
                hint = srv._retry_after(path)
                payload['retry_after_s'] = hint
                self._json(429, payload, headers={
                    'Retry-After': str(max(1, int(hint + 0.999)))})

            def _sender(self):
                # the X-Mxnet-Trace context; with tracing off nothing is
                # parsed, and a None context opens the shared null span
                if not _trace.enabled():
                    return None
                return _trace.parse_header(
                    self.headers.get(_trace.TRACE_HEADER))

            def _drain_body(self):
                # an unread body on a keep-alive connection would be parsed
                # as the next request line
                try:
                    length = int(self.headers.get('Content-Length', 0) or 0)
                    if length:
                        self.rfile.read(length)
                except (ValueError, OSError):
                    pass

            def do_GET(self):
                parsed = urlparse(self.path)
                path = parsed.path.rstrip('/')
                if path == '/status':
                    self._json(200, srv._statuses()[0])
                elif path == '/healthz':
                    # a load balancer keys on the code: an unhealthy or
                    # draining replica answers 503, the body keeps the detail
                    if srv._draining:
                        self._json(503, {'ok': False, 'status': 'draining'})
                        return
                    worst = srv._statuses()[1]
                    ok = worst == 'ok'
                    self._json(200 if ok else 503,
                               {'ok': ok, 'status': worst})
                elif path == '/drain':
                    rid = (parse_qs(parsed.query).get('request_id')
                           or [None])[0]
                    with srv._trace_buf.span('srv.drain', self._sender(),
                                             request_id=rid):
                        self._json(200, srv._drain_snapshot(rid))
                elif path == '/trace':
                    # the records after the caller's cursor, which it
                    # advances to the header line's
                    try:
                        since = int((parse_qs(parsed.query).get('since')
                                     or ['0'])[0] or 0)
                    except (TypeError, ValueError):
                        since = 0
                    body = srv._trace_buf.ndjson(since)
                    self.send_response(200)
                    self.send_header('Content-Type', 'application/x-ndjson')
                    self.send_header('Content-Length', str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def do_POST(self):
                path = self.path.rstrip('/')
                if path not in ('/predict', '/generate', '/import'):
                    self._drain_body()
                    self.send_error(404)
                    return
                if srv._draining:
                    # this replica is leaving: new work and imports alike
                    # shed typed before any byte streams
                    self._drain_body()
                    self._json(503, {'error': 'replica draining (sequences '
                                              'are being handed off)',
                                     'error_class': 'Draining'},
                               headers={'Retry-After': '1'})
                    return
                if gate is not None and not gate.acquire(blocking=False):
                    self._drain_body()
                    self._shed(path, {
                        'error': 'serving concurrency limit reached; shed '
                                 'load or retry with backoff',
                        'limit': srv.max_concurrent})
                    return
                # the request's span, a child of the sender's, over the
                # parse, the admission and the whole streamed answer
                name = {'/generate': 'srv.generate',
                        '/import': 'srv.import'}.get(path, 'srv.predict')
                try:
                    with srv._trace_buf.span(name, self._sender()) as sp, \
                            _trace.activate(sp.ctx):
                        self._admitted(path)
                finally:
                    if gate is not None:
                        gate.release()

            def _admitted(self, path):
                try:
                    length = int(self.headers.get('Content-Length', 0))
                    req = json.loads(self.rfile.read(length) or b'{}')
                    if not isinstance(req, dict):
                        raise ValueError('not a JSON object')
                except ValueError:
                    self._json(400, {'error': 'bad JSON'})
                    return
                session = srv.session
                try:
                    if path == '/generate':
                        self._generate(req)
                    elif path == '/import':
                        self._import(req)
                    elif 'instances' in req:
                        wait_s = _wait_s(session)
                        futs = [session.submit(onp.asarray(x))
                                for x in req['instances']]
                        outs = [[o.tolist() for o in f.result(wait_s)]
                                for f in futs]
                        self._json(200, {'outputs': outs})
                    elif 'data' in req:
                        outs = session.infer(onp.asarray(req['data']),
                                             timeout=_wait_s(session))
                        self._json(200, {'outputs': [o.tolist()
                                                     for o in outs]})
                    else:
                        self._json(400, {'error': "need 'data' or "
                                                  "'instances'"})
                except BackpressureError as exc:
                    self._shed(path, {'error': str(exc), 'depth': exc.depth,
                                      'limit': exc.limit})
                except (RequestTimeout, _FutureTimeout) as exc:
                    self._json(504, {'error': str(exc)
                                     or 'request timed out'})
                except BatcherClosed as exc:
                    self._json(503, {'error': str(exc)})
                except (ValueError, TypeError) as exc:
                    # admission-time validation: shapes, arity, a prompt
                    # past the ladder, the wrong route for the session, a
                    # refused payload (SeqStateError is a ValueError)
                    self._json(400, {'error': str(exc)})
                except Exception as exc:  # noqa: BLE001 - a typed 500
                    self._json(500, {'error': '%s: %s'
                                     % (type(exc).__name__, exc),
                                     'error_class': type(exc).__name__})

            def _generate(self, req):
                gen = srv._gen_session()
                tokens = req.get('tokens')
                if not tokens:
                    self._json(400, {'error': "need 'tokens'"})
                    return
                # the fleet's resume plumbing: start_index offsets the
                # streamed indices of a spliced continuation, request_id
                # dedups re-admissions and rides the done line
                try:
                    start_index = int(req.get('start_index', 0) or 0)
                except (TypeError, ValueError):
                    self._json(400, {'error': "bad 'start_index'"})
                    return
                request_id = req.get('request_id')
                kwargs = {'max_new_tokens': req.get('max_new_tokens'),
                          'eos_id': req.get('eos_id')}
                if request_id is not None:
                    kwargs['request_id'] = request_id
                if req.get('prefill_only'):
                    kwargs['prefill_only'] = True
                # the body wins over the header (the gateway's relay)
                adapter = req.get('adapter')
                if adapter is None:
                    adapter = self.headers.get('X-Mxnet-Adapter')
                if adapter is not None:
                    kwargs['adapter'] = adapter
                try:
                    for key, cast in (('temperature', float),
                                      ('top_p', float), ('seed', int)):
                        val = req.get(key)
                        if val is not None:
                            kwargs[key] = cast(val)
                except (TypeError, ValueError):
                    self._json(400, {'error': 'bad sampling parameters'})
                    return
                # the engine's eng.* spans nest under this handler's span
                # (the context rides the sequence to the worker)
                tctx = _trace.current()
                if tctx is not None:
                    kwargs['trace'] = tctx
                stream = gen.generate(tokens, **kwargs)
                self._answer(gen, req, stream, start_index, request_id)

            def _import(self, req):
                gen = srv._gen_session()
                if getattr(gen, '_engine', None) is None:
                    self._json(400, {'error': '/import needs a decode-mode '
                                              'session'})
                    return
                payload = req.get('seqstate')
                if not isinstance(payload, dict):
                    self._json(400, {'error': "need 'seqstate' (a "
                                              "mxnet_tpu.seqstate.v1 object)"})
                    return
                tctx = _trace.current()
                stream = gen._engine.import_sequence(payload, trace=tctx) \
                    if tctx is not None else gen._engine.import_sequence(
                        payload)
                # numbering continues after the handed-off prefix, unless
                # the caller (a gateway's relayed watermark) says otherwise
                start_index = len(payload.get('emitted') or [])
                if req.get('start_index') is not None:
                    try:
                        start_index = int(req['start_index'])
                    except (TypeError, ValueError):
                        pass
                self._answer(gen, req, stream, start_index,
                             payload.get('request_id'))

            def _answer(self, gen, req, stream, start_index, request_id):
                if req.get('stream', True):
                    self._stream_ndjson(stream, start_index, request_id)
                    return
                toks = stream.result(_wait_s(gen))
                self._json(200, _done(stream, toks, request_id))

            def _chunk(self, obj):
                data = (json.dumps(obj, sort_keys=True) + '\n').encode()
                self.wfile.write(b'%x\r\n%s\r\n' % (len(data), data))
                # each token leaves now, not in a burst at the end
                self.wfile.flush()

            def _stream_ndjson(self, stream, start_index, request_id):
                self.send_response(200)
                self.send_header('Content-Type', 'application/x-ndjson')
                self.send_header('Transfer-Encoding', 'chunked')
                self.end_headers()
                try:
                    for i, tok in enumerate(stream):
                        self._chunk({'token': tok, 'index': start_index + i})
                    done = _done(stream, stream.tokens, request_id)
                    done['done'] = True
                    self._chunk(done)
                except OSError:
                    # the client went away: free its slot, and never write
                    # to the dead socket again
                    stream.cancel()
                    return
                except Exception as exc:  # noqa: BLE001 - on the last line
                    # a failure mid-stream: the headers are gone, the
                    # error rides the last line
                    stream.cancel()
                    try:
                        self._chunk({'done': True,
                                     'error': '%s: %s'
                                     % (type(exc).__name__, exc),
                                     'error_class': type(exc).__name__,
                                     'tokens': stream.tokens})
                    except OSError:
                        return
                try:
                    self.wfile.write(b'0\r\n\r\n')
                    self.wfile.flush()
                except OSError:
                    pass

            def log_message(self, *args):
                pass            # no line on stderr a request

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            # a deep listen backlog: a burst of connections queues in the
            # kernel instead of stalling in TCP retransmits
            request_queue_size = 128

            def handle_error(self, request, client_address):
                import sys
                # a client hanging up is normal serving weather
                if isinstance(sys.exc_info()[1],
                              (ConnectionError, TimeoutError)):
                    return
                ThreadingHTTPServer.handle_error(self, request,
                                                 client_address)

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]     # port 0 resolved
        # the site names the bound port; the engines' spans land here, so
        # that GET /trace serves them
        self._trace_buf.site = 'replica:%d' % self.port
        for sess in (self.session, self.decode_session):
            eng = getattr(sess, '_engine', None)
            if eng is not None:
                eng.trace_sink = self._trace_buf
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name='mxnet-tpu-torch-serving-http')
        self._thread.start()
        return self

    # -- the drain (a fleet's graceful handoff) ------------------------------

    @property
    def draining(self):
        return self._draining

    @property
    def drain_result(self):
        """``{'rc', 'reason', 'sequences', 'handed_off', 'duration_s'}``
        once the drain completed (``rc`` the resumable exit code), else
        None."""
        with self._drain_lock:
            return dict(self._drain_result) if self._drain_result else None

    def install_preempt_hook(self, handler=None, poll_s=0.05):
        """SIGTERM / SIGINT drain this endpoint: the signal only sets the
        handler's flag, a watcher thread sees it (every ``poll_s``) and
        calls :meth:`begin_drain`. ``handler`` shares a
        :class:`~..resilience.preempt.PreemptionHandler`; by default one is
        made and installed (from the main thread). Pair it with
        :meth:`serve_until_drained` on the main thread. Returns the
        handler."""
        if self._preempt is not None:
            return self._preempt
        if handler is None:
            handler = PreemptionHandler().install()
        self._preempt = handler

        def watch():
            while not self._preempt_stop.wait(poll_s):
                if handler.stop_requested:
                    self.begin_drain(reason=handler.reason or 'preempted')
                    return

        self._preempt_thread = threading.Thread(
            target=watch, daemon=True, name='mxnet-tpu-torch-serving-preempt')
        self._preempt_thread.start()
        return handler

    def begin_drain(self, reason='requested', handoff_timeout_s=None):
        """Start a graceful drain (idempotent): ``/healthz`` answers 503
        ``draining``, every POST sheds 503 ``Draining``, every sequence in
        flight is exported and served over ``GET /drain``, and the drain's
        result records once the payloads are handed off or
        ``handoff_timeout_s`` (``MXNET_TPU_SERVE_DRAIN_TIMEOUT_S``)
        passes. Returns the server."""
        with self._drain_lock:
            if self._draining:
                return self
            self._draining = True
        if handoff_timeout_s is None:
            handoff_timeout_s = _config.get('MXNET_TPU_SERVE_DRAIN_TIMEOUT_S')
        t0 = time.monotonic()
        inst = _emit.serving()
        if inst is not None:
            inst.drains.inc()
        _emit.event('drain_begin', reason=reason)
        self._drain_thread = threading.Thread(
            target=self._drain_worker,
            args=(reason, t0, float(handoff_timeout_s)),
            daemon=True, name='mxnet-tpu-torch-serving-drain')
        self._drain_thread.start()
        return self

    def wait_drained(self, timeout=None):
        """Block until the drain completed; True when it has."""
        return self._drain_done.wait(timeout)

    def serve_until_drained(self, timeout=None):
        """A serving process's main thread: block until a drain
        completes, then raise :class:`~..resilience.preempt.Preempted`,
        so that the process exits with the resumable code (75) a
        scheduler restarts."""
        self._drain_done.wait(timeout)
        res = self.drain_result or {}
        raise Preempted(res.get('rc', resumable_exit_code()),
                        reason=res.get('reason', 'drained'))

    def _drain_snapshot(self, request_id=None):
        """The ``GET /drain`` body; a payload served is handed off."""
        with self._drain_lock:
            picked = [i for i, p in enumerate(self._drain_payloads)
                      if request_id is None
                      or p.get('request_id') == request_id]
            self._drain_unserved.difference_update(picked)
            return {'schema': DRAIN_SCHEMA,
                    'draining': self._draining,
                    'complete': self._drain_done.is_set(),
                    'pending': len(self._drain_unserved),
                    'sequences': [self._drain_payloads[i] for i in picked]}

    def _drain_worker(self, reason, t0, handoff_timeout_s):
        sessions = [s for s in (self.session, self.decode_session)
                    if s is not None
                    and getattr(s, '_engine', None) is not None]
        payloads = []
        for s in sessions:
            try:
                payloads.extend(s._engine.export_all())
            except Exception:
                logging.exception('drain: export_all failed on session %r',
                                  getattr(s, 'name', s))
        with self._drain_lock:
            self._drain_payloads = payloads
            self._drain_unserved = set(range(len(payloads)))
        # the handoff window: a gateway fetches the payloads over GET
        # /drain; with no consumer the replica moves on when it closes
        deadline = t0 + handoff_timeout_s
        while payloads and time.monotonic() < deadline:
            with self._drain_lock:
                if not self._drain_unserved:
                    break
            time.sleep(0.02)
        for s in sessions:
            try:
                s.close(drain=True)
            except Exception:
                logging.exception('drain: close failed on session %r',
                                  getattr(s, 'name', s))
        dt = time.monotonic() - t0
        with self._drain_lock:
            handed = len(payloads) - len(self._drain_unserved)
            self._drain_result = {
                'rc': resumable_exit_code(), 'reason': reason,
                'sequences': len(payloads), 'handed_off': handed,
                'duration_s': round(dt, 3)}
        self._drain_done.set()
        inst = _emit.serving()
        if inst is not None:
            inst.drain_seconds.observe(dt)
        _emit.event('drain_complete', reason=reason, sequences=len(payloads),
                    handed_off=handed, duration_s=round(dt, 3))

    def stop(self):
        self._preempt_stop.set()
        if self._preempt_thread is not None:
            self._preempt_thread.join(timeout=2.0)
            self._preempt_thread = None
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        self._httpd = self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def _done(stream, tokens, request_id):
    """A generation's last line (or plain body): the tokens, the finish,
    whether the CPU served, and the request id and a ``prefill_only``
    payload where there are."""
    out = {'tokens': tokens, 'finish_reason': stream.finish_reason,
           'degraded': stream.degraded}
    seqstate = getattr(stream, 'seqstate', None)
    if seqstate is not None:
        out['seqstate'] = seqstate
    if request_id is not None:
        out['request_id'] = request_id
    return out


def maybe_start_http_server(session):
    """Start the endpoint over ``session`` when
    ``MXNET_TPU_SERVE_HTTP_PORT`` is a nonzero port; returns the started
    server, or None (the default: the server is off)."""
    port = int(_config.get('MXNET_TPU_SERVE_HTTP_PORT') or 0)
    if not port:
        return None
    return ServingHTTPServer(session, port).start()
