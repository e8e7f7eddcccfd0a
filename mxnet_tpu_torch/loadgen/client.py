"""The per-request HTTP client and the record every request resolves
into, the port of ``mxnet_tpu/loadgen/client.py``.

One :class:`RequestRecord` a scheduled arrival, whatever happens to it:
served (possibly degraded), shed with a 429, timed out, aborted with a
typed 500, a stream ended by a typed error line, a socket error, or a
client-side timeout. ``resolved`` flips exactly once (the zero-hang
invariant of the chaos soak is "every record resolved at drain"), and
``error_class`` is the taxonomy key the SLO artifact aggregates by.

stdlib ``http.client``, one connection a request over real sockets: the
harness measures the serving stack through the HTTP surface production
traffic uses. With tracing on (``MXNET_TPU_TRACE``) every request carries
a client-minted ``X-Mxnet-Trace`` identity.
"""
from __future__ import annotations

import http.client
import json
import socket
import time

from ..observability import trace as _trace

__all__ = ['RequestRecord', 'LoadClient']

# taxonomy: HTTP status -> error class (200 handled separately)
_STATUS_CLASS = {
    429: 'shed_backpressure',
    504: 'timeout_budget',
    503: 'unavailable',
    400: 'bad_request',
}


def _knob(name, default):
    try:
        from .. import config as _config
        v = _config.get(name)
        return default if v is None else v
    except Exception:
        return default


class RequestRecord:
    """Everything measured about one open-loop request."""

    __slots__ = ('rid', 'kind', 'scheduled_t', 'fired_at', 'first_at',
                 'done_at', 'status', 'error_class', 'tokens',
                 'degraded', 'retry_after_s', 'resolved', 'detail',
                 'resumed', 'retries', 'trace_id')

    def __init__(self, rid, kind, scheduled_t):
        self.rid = rid
        self.kind = kind
        self.scheduled_t = scheduled_t   # schedule-relative seconds
        self.fired_at = None             # monotonic timestamps
        self.first_at = None             # first response byte/line
        self.done_at = None
        self.status = None               # HTTP status, None = no reply
        self.error_class = None          # None = served clean
        self.tokens = 0                  # generate: tokens streamed
        self.degraded = False
        self.retry_after_s = None        # parsed Retry-After on 429
        self.resolved = False
        self.detail = None               # short error text
        self.resumed = 0                 # gateway mid-stream resumes
        self.retries = 0                 # client Retry-After retries
        self.trace_id = None             # distributed trace identity

    # -- derived metrics ---------------------------------------------------

    @property
    def ok(self):
        return self.status == 200 and self.error_class is None

    def latency_s(self):
        if self.fired_at is None or self.done_at is None:
            return None
        return self.done_at - self.fired_at

    def ttft_s(self):
        if self.fired_at is None or self.first_at is None:
            return None
        return self.first_at - self.fired_at

    def tpot_s(self):
        """Time per output token AFTER the first (generate only)."""
        if self.first_at is None or self.done_at is None \
                or self.tokens < 2:
            return None
        return (self.done_at - self.first_at) / (self.tokens - 1)

    def to_json(self):
        return {'rid': self.rid, 'kind': self.kind,
                'scheduled_t': round(self.scheduled_t, 6),
                'status': self.status,
                'error_class': self.error_class,
                'latency_s': self.latency_s(),
                'ttft_s': self.ttft_s(), 'tokens': self.tokens,
                'degraded': self.degraded,
                'retry_after_s': self.retry_after_s,
                'resolved': self.resolved,
                'resumed': self.resumed,
                'retries': self.retries,
                'trace_id': self.trace_id}


class LoadClient:
    """Fires one request per call against a live serving endpoint.

    ``timeout_s`` is the CLIENT-side socket budget: even a wedged
    server resolves every record (error_class ``client_timeout``) —
    the harness never hangs on the system under test.

    ``headers`` ride on every POST (e.g. the gateway's tenant
    header). ``retries`` > 0 honors a 429/503's Retry-After with a
    capped backoff sleep before re-firing — recorded on the record's
    ``retries`` counter, never silent; the default (the
    ``MXNET_TPU_LOADGEN_RETRIES`` knob, 0) keeps the one-shot
    open-loop behavior the overload verdicts are calibrated on.
    """

    def __init__(self, host, port, timeout_s=10.0,
                 clock=time.monotonic, headers=None, retries=None,
                 retry_cap_s=None, sleep=time.sleep):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.headers = dict(headers or {})
        self.retries = int(
            retries if retries is not None
            else _knob('MXNET_TPU_LOADGEN_RETRIES', 0))
        self.retry_cap_s = float(
            retry_cap_s if retry_cap_s is not None
            else _knob('MXNET_TPU_LOADGEN_RETRY_CAP_S', 2.0))
        self._clock = clock
        self._sleep = sleep

    # -- internals ---------------------------------------------------------

    def _post(self, path, payload, rec=None):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        body = json.dumps(payload).encode()
        # one request per connection: 'close' tells the server not to
        # hold the socket for keep-alive, so tearing the client down
        # never looks like a mid-request reset on the server side
        headers = {'Content-Type': 'application/json',
                   'Content-Length': str(len(body)),
                   'Connection': 'close'}
        headers.update(self.headers)
        if rec is not None and _trace.enabled():
            # client-minted bare identity: the serving side's first
            # span becomes the tree root; each RETRY attempt is its
            # own trace, the record keeps the served attempt's id
            ctx = _trace.TraceContext.new()
            rec.trace_id = ctx.trace_id
            headers[_trace.TRACE_HEADER] = ctx.to_header()
        conn.request('POST', path, body=body, headers=headers)
        return conn

    @staticmethod
    def _parse_retry_after(headers):
        if headers is None:
            return None
        ra = headers.get('Retry-After')
        if ra is None:
            return None
        try:
            return float(ra)
        except ValueError:
            return None

    def _with_retries(self, rec, attempt):
        """Run ``attempt(rec)``; on a 429/503 with retry budget left,
        back off (Retry-After, capped) and re-fire. The record keeps
        its ORIGINAL fired_at — backoff time is real latency the
        open-loop accounting must see — and counts every retry."""
        attempt(rec)
        while (rec.status in (429, 503)
               and rec.retries < self.retries):
            hint = rec.retry_after_s if rec.retry_after_s is not None \
                else 0.05
            self._sleep(max(0.0, min(float(hint), self.retry_cap_s)))
            rec.retries += 1
            # reset per-attempt outcome; fired_at / retries persist
            rec.first_at = None
            rec.done_at = None
            rec.status = None
            rec.error_class = None
            rec.tokens = 0
            rec.degraded = False
            rec.detail = None
            rec.resumed = 0
            rec.resolved = False
            attempt(rec)
        return rec

    @staticmethod
    def _classify(rec, status, headers):
        rec.status = status
        if status == 200:
            return
        rec.error_class = _STATUS_CLASS.get(status,
                                            'server_error')
        if status in (429, 503) and headers is not None:
            ra = headers.get('Retry-After')
            if ra is not None:
                try:
                    rec.retry_after_s = float(ra)
                except ValueError:
                    pass

    # -- request kinds -----------------------------------------------------

    def predict(self, rec, data):
        """POST /predict with one example; fills ``rec`` in place.
        Retries 429/503 with capped Retry-After backoff when the
        client's retry budget allows."""
        return self._with_retries(
            rec, lambda r: self._predict_once(r, data))

    def _predict_once(self, rec, data):
        if rec.fired_at is None:
            rec.fired_at = self._clock()
        conn = None
        try:
            conn = self._post('/predict', {'data': data}, rec=rec)
            resp = conn.getresponse()
            raw = resp.read()
            rec.first_at = self._clock()
            self._classify(rec, resp.status, resp.headers)
            if resp.status == 200:
                pass                      # body checked by tests, not
            elif resp.status == 500:      # the hot loop
                try:
                    rec.detail = json.loads(raw).get('error_class')
                    if rec.detail in ('WorkerCrashError',
                                      'PreemptionSignal'):
                        rec.error_class = 'aborted'
                except ValueError:
                    pass
        except socket.timeout:
            rec.error_class = 'client_timeout'
        except OSError as exc:
            rec.error_class = 'net_error'
            rec.detail = str(exc)[:120]
        finally:
            if conn is not None:
                conn.close()
            rec.done_at = self._clock()
            rec.resolved = True
        return rec

    def generate(self, rec, tokens, max_new_tokens=8, extra=None):
        """POST /generate with stream=true; reads the NDJSON lines as
        they arrive (TTFT = first line, TPOT from the line spacing).
        A typed mid-stream error line resolves the record with
        error_class ``stream_<Class>``; a stream the gateway resumed
        across a replica loss resolves CLEAN with ``rec.resumed`` > 0
        (success-with-resume, not a failure). Retries 429/503 with
        capped Retry-After backoff when the retry budget allows.
        ``extra`` merges additional body fields into the request —
        the multi-adapter workload rides it (``adapter``,
        ``temperature`` / ``top_p`` / ``seed``)."""
        return self._with_retries(
            rec,
            lambda r: self._generate_once(r, tokens, max_new_tokens,
                                          extra))

    def _generate_once(self, rec, tokens, max_new_tokens=8,
                       extra=None):
        if rec.fired_at is None:
            rec.fired_at = self._clock()
        body = {'tokens': tokens, 'max_new_tokens': max_new_tokens,
                'stream': True}
        if extra:
            body.update(extra)
        conn = None
        try:
            conn = self._post('/generate', body, rec=rec)
            resp = conn.getresponse()
            self._classify(rec, resp.status, resp.headers)
            if resp.status != 200:
                resp.read()
                return rec
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                if rec.first_at is None:
                    rec.first_at = self._clock()
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if 'token' in obj:
                    rec.tokens += 1
                if obj.get('done'):
                    rec.degraded = bool(obj.get('degraded'))
                    rec.resumed = int(obj.get('resumed', 0) or 0)
                    if obj.get('error'):
                        rec.error_class = 'stream_%s' % (
                            obj.get('error_class') or 'error')
                        rec.detail = str(obj['error'])[:160]
                    break
        except socket.timeout:
            rec.error_class = 'client_timeout'
        except OSError as exc:
            rec.error_class = 'net_error'
            rec.detail = str(exc)[:120]
        finally:
            if conn is not None:
                conn.close()
            rec.done_at = self._clock()
            rec.resolved = True
        return rec

    def get_json(self, path):
        """GET a JSON route (/status, /healthz); returns
        (status_code, payload|None) and never raises."""
        conn = None
        try:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
            conn.request('GET', path,
                         headers={'Connection': 'close'})
            resp = conn.getresponse()
            raw = resp.read()
            try:
                return resp.status, json.loads(raw)
            except ValueError:
                return resp.status, None
        except OSError:
            return None, None
        finally:
            if conn is not None:
                conn.close()
