"""Dynamic micro-batching queue with admission control, the port of
``mxnet_tpu/serving/batcher.py`` (:109-503).

A serving frontend receives requests one at a time, but the card wants
batch work. The micro-batcher aggregates concurrent single-example
requests into one device batch under two triggers -- ``max_batch``
requests waiting (flush at once) or the oldest request aging past
``deadline_ms`` (the latency bound) -- and hands the batched outputs back
to per-request futures in submission order.

Admission control keeps overload typed instead of silent:

  * bounded queue depth: a submit against a full queue raises
    :class:`BackpressureError` at once (the caller sheds load or retries
    with backoff; nothing blocks without bound);
  * per-request timeout: a request that waits longer than ``timeout_s``
    fails with :class:`RequestTimeout`, even while the worker is stuck in
    a runner (a reaper thread scans for it), and a request whose budget
    cannot outlast a batch of recent latency is shed when it is dequeued.

Thread-safety: ``submit`` is callable from any number of threads; row
*i* of a batch maps back to its *i*-th request, popped in arrival order.
The runner runs on the single worker thread. One lock (``self._lock``,
with ``self._wake`` a Condition over it) guards the queue, the in-flight
list and the counters; nothing that can run user code (the runner,
``Future.set_result`` / ``set_exception``, whose done-callbacks fire
inline) runs under it, and neither does a telemetry emit.

Telemetry (the reference's, ``batcher.py:228-236, 383-387, 444-451``):
``mxnet_tpu_serve_requests_total`` and ``_queue_depth`` at admission; a
full queue counts ``mxnet_tpu_serve_rejected_total{reason="queue_full"}``
and records ``serve_reject``; a doomed request shed at dequeue counts
``{reason="shed_doomed"}`` and records ``serve_shed_doomed``; each batch
served counts ``mxnet_tpu_serve_batches_total`` and observes
``_batch_size`` and each request's ``_request_seconds``.

numpy + stdlib only: the queue math is testable with a fake runner and
a fake clock.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout

import numpy as onp

from ..observability import emit as _emit

__all__ = ['BackpressureError', 'RequestTimeout', 'BatcherClosed',
           'MicroBatcher']


class BackpressureError(RuntimeError):
    """Typed queue-full rejection (HTTP 429 / retry-after upstream).
    Carries the observed depth and the configured limit."""

    def __init__(self, depth, limit):
        super().__init__('serving queue full (%d/%d pending); shed '
                         'load or retry with backoff' % (depth, limit))
        self.depth = depth
        self.limit = limit


class RequestTimeout(TimeoutError):
    """A request aged past its per-request budget before (or while)
    being served."""


class BatcherClosed(RuntimeError):
    """Submit against a closed batcher or engine."""


class _Request:
    __slots__ = ('arrays', 'future', 'enqueued_at', 'deadline_at',
                 'expiring')

    def __init__(self, arrays, future, enqueued_at, deadline_at):
        self.arrays = arrays
        self.future = future
        self.enqueued_at = enqueued_at
        self.deadline_at = deadline_at
        # set under the lock when a timeout scan collects this request;
        # the failure is delivered after release, so without the flag a
        # second scan in that window would collect (and count) it twice
        self.expiring = False


class MicroBatcher:
    """Futures-based dynamic micro-batching over a runner callable.

    ``runner(inputs, n)`` receives one numpy array per model input -- each
    the axis-0 stack of ``n`` single-example request arrays -- and returns
    a list of output arrays whose axis 0 maps back to the requests; it
    runs on the worker thread. Bucket padding is the runner's concern.
    ``example_shapes`` (per-example shapes, no batch axis, one per input)
    makes admission validate ranks exactly. ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(self, runner, max_batch=64, deadline_ms=5.0,
                 max_queue=256, timeout_s=30.0, name='serving',
                 clock=time.monotonic, example_shapes=None):
        if max_batch < 1:
            raise ValueError('max_batch must be >= 1')
        self._runner = runner
        self.example_shapes = [tuple(s) for s in example_shapes] \
            if example_shapes is not None else None
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.timeout_s = float(timeout_s) if timeout_s else None
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue = []
        self._inflight = []      # popped into a running batch
        self._closed = False
        self._submitted = 0
        self._completed = 0
        self._rejected = 0
        self._timeouts = 0
        self._batches = 0
        self._shed_doomed = 0
        # moving average of recent runner (device batch) latency: the
        # basis of doomed-request shedding and of retry_after_hint; None
        # until the first batch completes
        self._ema_batch_s = None
        self._flushes = {'full': 0, 'deadline': 0, 'drain': 0}
        self._thread = threading.Thread(
            target=self._worker, daemon=True,
            name='mxnet-tpu-torch-%s-batcher' % name)
        self._thread.start()
        # the reaper: per-request timeouts must fire even while the worker
        # is blocked inside a stuck runner, when its own scan cannot run
        self._reaper = None
        if self.timeout_s:
            self._reaper = threading.Thread(
                target=self._reap_loop, daemon=True,
                name='mxnet-tpu-torch-%s-reaper' % name)
            self._reaper.start()

    # -- submission --------------------------------------------------------

    def _normalize(self, arrays):
        """Resolve each request array to its per-example shape. With
        declared ``example_shapes`` an explicit leading batch axis of 1 is
        told apart by rank (a genuine (1, h, w) example is never taken for
        a batched (h, w) one) and a wrong rank is a typed error at
        admission, not a failure mid-batch."""
        if self.example_shapes is None:
            return arrays
        if len(arrays) != len(self.example_shapes):
            raise ValueError('request has %d input(s); model takes %d'
                             % (len(arrays), len(self.example_shapes)))
        out = []
        for arr, shape in zip(arrays, self.example_shapes):
            if arr.ndim == len(shape) + 1 and arr.shape[0] == 1:
                arr = arr[0]              # explicit batch axis of 1
            elif arr.ndim != len(shape):
                raise ValueError('request input of shape %r does not match '
                                 'the per-example shape %r'
                                 % (arr.shape, shape))
            out.append(arr)
        return out

    def submit(self, *arrays):
        """Enqueue one request (one array per model input, per-example
        shape) and return its :class:`concurrent.futures.Future`, whose
        result is the list of that request's output rows. Raises
        :class:`BackpressureError` when the queue is at depth and
        :class:`BatcherClosed` after :meth:`close`."""
        arrays = self._normalize([onp.asarray(a) for a in arrays])
        now = self._clock()
        fut = Future()
        rejected_depth = None
        with self._lock:
            if self._closed:
                raise BatcherClosed('batcher %r is closed' % self.name)
            depth = len(self._queue)
            if depth >= self.max_queue:
                self._rejected += 1
                rejected_depth = depth
            else:
                deadline_at = now + self.timeout_s if self.timeout_s \
                    else None
                self._queue.append(_Request(arrays, fut, now, deadline_at))
                self._submitted += 1
                depth = len(self._queue)
                self._wake.notify()
        # admission telemetry outside the lock
        inst = _emit.serving()
        if rejected_depth is not None:
            if inst is not None:
                inst.rejected.labels(reason='queue_full').inc()
                inst.queue_depth.set(rejected_depth)
            _emit.event('serve_reject', reason='queue_full',
                        depth=rejected_depth, limit=self.max_queue)
            raise BackpressureError(rejected_depth, self.max_queue)
        if inst is not None:
            inst.requests.inc()
            inst.queue_depth.set(depth)
        return fut

    def infer(self, *arrays, timeout=None):
        """Blocking submit + wait. ``timeout`` defaults to the
        per-request budget; a lapse raises :class:`RequestTimeout`."""
        fut = self.submit(*arrays)
        wait = timeout if timeout is not None else self.timeout_s
        try:
            return fut.result(wait)
        except _FutTimeout:
            fut.cancel()
            raise RequestTimeout('request not served within %.3fs'
                                 % wait) from None

    # -- worker ------------------------------------------------------------

    def _collect_expired_locked(self, now, fails):
        """Collect requests past their budget into ``fails`` as (future,
        exception) pairs, and drop cancelled queued ones. Covers the queue
        and the requests already popped into a batch whose runner is
        stuck. The caller holds the lock; :meth:`_fail_expired` fails the
        futures after it is released."""
        kept = []
        for req in self._queue:
            if req.deadline_at is not None and now >= req.deadline_at \
                    and not req.expiring and not req.future.done():
                req.expiring = True
                self._timeouts += 1
                fails.append((req.future, RequestTimeout(
                    'request waited %.3fs in queue (budget %.3fs)'
                    % (now - req.enqueued_at, self.timeout_s))))
            elif not req.future.cancelled():
                kept.append(req)
        self._queue = kept
        for req in self._inflight:
            if req.deadline_at is not None and now >= req.deadline_at \
                    and not req.expiring and not req.future.done():
                req.expiring = True
                self._timeouts += 1
                fails.append((req.future, RequestTimeout(
                    'request in-flight %.3fs without a result (budget '
                    '%.3fs; runner stuck?)'
                    % (now - req.enqueued_at, self.timeout_s))))

    @staticmethod
    def _fail_expired(fails):
        """Deliver collected failures; the caller must NOT hold the lock.
        A concurrent ``cancel()`` may win the race: that request is done
        already."""
        for fut, exc in fails:
            if fut.done():
                continue
            try:
                fut.set_exception(exc)
            except Exception:
                pass

    def _reap_loop(self):
        """Timeout scan independent of the worker."""
        while True:
            time.sleep(min(0.05, max(self.timeout_s / 4.0, 0.005)))
            fails = []
            with self._lock:
                if self._closed and not self._queue:
                    return
                self._collect_expired_locked(self._clock(), fails)
            self._fail_expired(fails)

    def _shed_doomed_locked(self, batch, now, fails):
        """Fail, at dequeue, the requests whose budget will lapse before a
        batch of recent latency could return (the reaper would expire
        them mid-batch); returns the rest."""
        est = self._ema_batch_s
        if not est:
            return batch
        kept = []
        for req in batch:
            if req.deadline_at is not None and not req.expiring \
                    and not req.future.done() \
                    and now + est > req.deadline_at:
                req.expiring = True
                self._shed_doomed += 1
                fails.append((req.future, RequestTimeout(
                    'shed at dequeue: %.0fms of budget left but recent '
                    'batches take ~%.0fms (doomed)'
                    % (max(0.0, req.deadline_at - now) * 1e3, est * 1e3))))
            else:
                kept.append(req)
        return kept

    def _take_batch(self):
        """Block until a batch is due; pop and return it (FIFO) as
        (requests, cause), or (None, None) once closed and drained."""
        while True:
            fails = []
            result = None
            shed = 0
            with self._lock:
                if self._queue:
                    self._collect_expired_locked(self._clock(), fails)
                if not self._queue:
                    if self._closed:
                        result = (None, None)
                    else:
                        self._wake.wait(0.05)
                else:
                    now = self._clock()
                    oldest = self._queue[0].enqueued_at
                    cause = None
                    if len(self._queue) >= self.max_batch:
                        cause = 'full'
                    elif self._closed:
                        cause = 'drain'
                    elif now - oldest >= self.deadline_s:
                        cause = 'deadline'
                    if cause is None:
                        self._wake.wait(
                            min(self.deadline_s - (now - oldest), 0.05))
                    else:
                        batch = self._queue[:self.max_batch]
                        del self._queue[:len(batch)]
                        taken = len(batch)
                        batch = self._shed_doomed_locked(batch, now, fails)
                        shed = taken - len(batch)
                        est_ms = (self._ema_batch_s or 0.0) * 1e3
                        self._inflight = batch
                        self._flushes[cause] += 1
                        result = (batch, cause)
            self._fail_expired(fails)
            if shed:
                inst = _emit.serving()
                if inst is not None:
                    inst.rejected.labels(reason='shed_doomed').inc(shed)
                _emit.event('serve_shed_doomed', count=shed,
                            est_batch_ms=est_ms)
            if result is not None:
                return result

    def _worker(self):
        while True:
            batch, cause = self._take_batch()
            if batch is None:
                return
            self._run_batch(batch, cause)

    def _run_batch(self, batch, cause):
        # the reaper may have expired (or a client cancelled) requests
        # between the pop and this flush: scan once more and stack only
        # the live ones, in their FIFO order, so no device row is spent
        # on a future nobody can read
        fails = []
        with self._lock:
            self._collect_expired_locked(self._clock(), fails)
            batch = [req for req in batch
                     if not req.future.done() and not req.expiring]
            self._inflight = batch
        self._fail_expired(fails)
        if not batch:
            return
        n = len(batch)
        t0 = self._clock()
        try:
            stacked = [onp.stack([req.arrays[i] for req in batch])
                       for i in range(len(batch[0].arrays))]
            outputs = self._runner(stacked, n)
        except BaseException as exc:  # noqa: BLE001 - relayed to futures
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(exc)
            return
        finally:
            with self._lock:
                self._inflight = []
        dt = self._clock() - t0
        with self._lock:
            self._batches += 1
            self._completed += n
            self._ema_batch_s = dt if self._ema_batch_s is None \
                else 0.7 * self._ema_batch_s + 0.3 * dt
            depth = len(self._queue)
        for i, req in enumerate(batch):
            if not req.future.done():
                req.future.set_result([onp.asarray(out)[i]
                                       for out in outputs])
        inst = _emit.serving()
        if inst is not None:
            inst.batches.inc()
            inst.batch_size.observe(n)
            inst.queue_depth.set(depth)
            for req in batch:
                inst.latency.observe(max(0.0, (t0 + dt) - req.enqueued_at))

    # -- lifecycle / introspection ----------------------------------------

    def stats(self):
        with self._lock:
            return {'depth': len(self._queue),
                    'submitted': self._submitted,
                    'completed': self._completed,
                    'rejected': self._rejected,
                    'timeouts': self._timeouts,
                    'shed_doomed': self._shed_doomed,
                    'batches': self._batches,
                    'flushes': dict(self._flushes),
                    'closed': self._closed}

    def retry_after_hint(self):
        """Estimated seconds until a newly admitted request could be
        served: the queue depth in batches times the recent batch
        latency (a ``Retry-After`` for a 429)."""
        with self._lock:
            depth = len(self._queue)
            est = self._ema_batch_s
        if est is None:
            est = max(self.deadline_s, 0.01)
        return max(0.05, (depth / float(self.max_batch) + 1.0) * est)

    def close(self, drain=True, timeout=10.0):
        """Stop accepting requests; drain the queue (or fail the pending
        futures with :class:`BatcherClosed` when ``drain`` is False) and
        join the worker."""
        fails = []
        with self._lock:
            self._closed = True
            if not drain:
                fails = [(req.future, BatcherClosed('batcher closed'))
                         for req in self._queue if not req.future.done()]
                self._queue = []
            self._wake.notify_all()
        self._fail_expired(fails)
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
