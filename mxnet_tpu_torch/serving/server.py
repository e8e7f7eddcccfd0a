"""InferenceSession, the port of ``mxnet_tpu/serving/server.py``
(:64-157, 224-449): the request path a serving frontend talks to.

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
the JAX session. Not ported: the HTTP endpoint, and loading the draft from
the ``MXNET_TPU_SERVE_SPEC_DRAFT`` artifact (ROADMAP: "Frozen-artifact
persistence").
"""
from __future__ import annotations

import threading

import numpy as onp

from .. import config as _config
from ..resilience.policy import (CircuitBreaker, CircuitOpenError,
                                 PreemptionSignal, WorkerCrashError, inject,
                                 is_transient)
from ..resilience.watchdog import Watchdog
from .batcher import MicroBatcher
from .decode.engine import DecodeEngine
from .decode.program import DecodeProgram
from .freeze import FrozenProgram
from .health import Health

__all__ = ['InferenceSession']


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
            self._health.failed(exc, 'batch %d' % seq, was_open)
            raise
        except Exception as exc:
            if not (is_transient(exc) or isinstance(exc, CircuitOpenError)):
                raise               # bug-shaped: fail the requests loudly
            self._health.failed(exc, 'batch %d' % seq, was_open)
            outs = self.frozen.run_fallback(stacked, n)
            with self._lock:
                self._fallback_batches += 1
            return outs
        self._health.recovered()
        with self._lock:
            self._accel_batches += 1
        return outs

    # -- generation --------------------------------------------------------

    def generate(self, tokens, max_new_tokens=None, eos_id=None,
                 adapter=None, temperature=None, top_p=None, seed=None):
        """Stream a generation: returns a
        :class:`~.decode.engine.GenerateStream` (iterate per token, or
        ``.result(timeout)`` for the whole sequence). ``adapter`` picks the
        adapter and ``temperature`` / ``top_p`` / ``seed`` the sampling law
        (the engine's defaults: the base, greedy)."""
        if self._engine is None:
            raise TypeError('generate() needs a DecodeProgram session (use '
                            'serving.freeze_decode)')
        kwargs = {'max_new_tokens': max_new_tokens, 'eos_id': eos_id}
        for key, value in (('adapter', adapter), ('temperature', temperature),
                           ('top_p', top_p), ('seed', seed)):
            if value is not None:
                kwargs[key] = value
        return self._engine.generate(tokens, **kwargs)

    # -- lifecycle ---------------------------------------------------------

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
