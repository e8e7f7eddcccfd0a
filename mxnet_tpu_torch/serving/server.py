"""InferenceSession, the port of ``mxnet_tpu/serving/server.py``
(:64-157, 224-245, 322-356): the request path a serving frontend talks
to.

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

Knob defaults come from ``MXNET_TPU_SERVE_*`` (``mxnet_tpu_torch/config.py``);
constructor arguments win. Arguments of the other mode are ignored, as in
the JAX session. Not ported: the circuit breaker and the CPU fallback
(ROADMAP: "breaker / watchdog and the visible degraded path") -- a
failing batch fails its requests --, the stall
watchdog, the HTTP endpoint, and loading the draft from the
``MXNET_TPU_SERVE_SPEC_DRAFT`` artifact (ROADMAP: "Frozen-artifact
persistence").
"""
from __future__ import annotations

import threading

from .. import config as _config
from .batcher import MicroBatcher
from .decode.engine import DecodeEngine
from .decode.program import DecodeProgram
from .freeze import FrozenProgram

__all__ = ['InferenceSession']


def _pick(value, knob):
    return value if value is not None else _config.get(knob)


class InferenceSession:
    """Serve a :class:`FrozenProgram` (:meth:`submit`, :meth:`infer`,
    :meth:`infer_batch`) or a :class:`DecodeProgram` (:meth:`generate`).
    Warm a frozen program's buckets first with
    :meth:`FrozenProgram.warmup`; a decode program's engine builds its
    programs (and the draft's) as the session starts."""

    def __init__(self, program, max_batch=None, deadline_ms=None,
                 max_queue=None, timeout_s=None, name=None,
                 max_new_tokens=None, prefill_interleave=None, draft=None,
                 adapters=None):
        self.name = name or getattr(program, 'name', None)
        max_queue = int(_pick(max_queue, 'MXNET_TPU_SERVE_QUEUE_DEPTH'))
        timeout_s = float(_pick(timeout_s, 'MXNET_TPU_SERVE_TIMEOUT_S'))
        self._engine = self._batcher = None
        if isinstance(program, DecodeProgram):
            self._engine = DecodeEngine(
                program, max_queue=max_queue, timeout_s=timeout_s,
                max_new_tokens=int(_pick(max_new_tokens,
                                         'MXNET_TPU_SERVE_MAX_NEW_TOKENS')),
                prefill_interleave=int(_pick(
                    prefill_interleave,
                    'MXNET_TPU_SERVE_PREFILL_INTERLEAVE')),
                name=self.name, draft=draft, adapters=adapters)
            self.program = program
            return
        if not isinstance(program, FrozenProgram):
            raise TypeError('InferenceSession serves a FrozenProgram or a '
                            'DecodeProgram; got %s (use serving.freeze / '
                            'freeze_decode first)' % type(program).__name__)
        self.program = self.frozen = program
        top = program.policy.max_batch
        max_batch = int(max_batch if max_batch is not None else
                        min(top, _config.get('MXNET_TPU_SERVE_MAX_BATCH')))
        if max_batch > top:
            raise ValueError('max_batch %d exceeds the largest bucket %d'
                             % (max_batch, top))
        self._lock = threading.Lock()
        self._by_bucket = {}
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
        through the bucketed program directly, on the caller's thread:
        the bulk path; the queue is for concurrent single requests."""
        self._require_oneshot('infer_batch')
        return self.frozen.run(list(arrays))

    def _run_batch(self, stacked, n):
        # the batcher's worker: the program runs on its device and
        # returns host arrays, so the futures resolve with data on the host
        outs = self.frozen.run(stacked, n)
        bucket = self.frozen.policy.bucket_for(n)
        with self._lock:
            self._by_bucket[bucket] = self._by_bucket.get(bucket, 0) + 1
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

    def close(self, drain=True, timeout=30.0):
        if self._engine is not None:
            self._engine.close(drain=drain, timeout=timeout)
        else:
            self._batcher.close(drain=drain, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
