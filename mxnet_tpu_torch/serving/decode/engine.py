"""Continuous batching over the slot cache or the paged cache, the port
of ``mxnet_tpu/serving/decode/engine.py``.

Sequences join and leave the in-flight decode batch at token
granularity. The engine schedules a fixed register file of ``slots``
sequences:

  * a finished sequence (EOS / max-new / max_len / timeout / cancel)
    retires its slot at the very next token boundary;
  * a pending request is admitted into a free slot by one bucketed
    prefill, interleaved between decode steps (``prefill_interleave``
    per step while sequences are in flight; an idle engine admits up to
    every free slot);
  * every decode step advances ALL live slots one token.

Admission control and typed errors carry over: a bounded pending queue
raises :class:`BackpressureError`, a reaper thread independent of the
worker enforces the per-request budget with :class:`RequestTimeout`,
and a closed engine raises :class:`BatcherClosed`.

**Paged scheduling** (``program.paged``): the engine owns the host state
of the page pool: a :class:`~.paged.PageAllocator` free list with
refcounts, a page allocated when a sequence's position crosses into it,
a :class:`~.paged.PrefixCache` that lands a prompt on the registered
pages of an earlier one (no prefill runs for them; the rest of the
prompt streams through decode steps), copy-on-write before any write
into a shared page, and LRU eviction of cached prefixes under pool
pressure. An exhausted pool fails the stream with
:class:`BackpressureError`, at admission or mid-stream, never a stall.
**Speculative decoding**: with a ``draft`` program and ``spec_k > 0``,
a tick runs the draft ``spec_k`` single steps to propose tokens and one
target ``run_verify`` to score all ``spec_k + 1`` positions; the longest
greedy-matching prefix is accepted, plus the target's own token at the
first mismatch. Rejected K/V rows stay masked until overwritten.

**Sampling and adapters**: a request carries its sampling law
(``temperature`` 0 is greedy; ``top_p``; ``seed``) and its adapter id.
Each call fills the program's extras a row a slot: the temperature, the
top-p and the key :func:`~.sampling.key_for` of (seed, the position of the
logits row), and the adapter's pool row, pinned from admission to
retirement (an unknown id or a pool with every row pinned fails that
request typed). A sampled speculative tick gives the draft the keys the
verify pass uses at the same positions, so the draft proposes what the
target would sample and the greedy acceptance walk is unchanged; every
emitted token is the target's own draw. The prefix cache is namespaced by
adapter id.

The scheduler is numpy + threading around a duck-typed program
(``slots``, ``max_len``, ``max_prompt_len()``, ``new_cache()``,
``run_prefill``, ``run_step``; a paged one adds ``page_size``, ``pages``,
``max_pages``, ``spec_k``, ``run_copy_page`` and ``run_verify``; a
``warmup()``, where there is one, builds every program of the target and
the draft as the engine starts); the worker thread alone owns the device
cache, which the program hands out (``new_cache()``: its own storage,
zeroed, since its captured programs are bound to it).

**Resilience**: every device call (a prefill, a step, the draft's prefill
and steps, verify, copy_page) runs under a circuit breaker and, when one
is given, a stall watchdog, and fires the fault-injection site
``serving.decode`` with the engine's device op index as its step
(``MXNET_TPU_FAULT=device_loss@serving.decode.5:1``). A failure is sorted
three ways. A transient fault (:func:`~...resilience.is_transient`: an
injected fault, a stall, a connection or deadline error), or a call the
open breaker refuses, completes the streams it carried on the CPU with the
same tokens (the program's ``fallback_generate``, on one fallback worker
that completes them in turn and checks the client's cancel and the
request's budget between tokens), each marked ``degraded`` and its tokens
counted in ``fallback_tokens``; ``stats()`` reads ``degraded`` until a
device call succeeds again (the record is a :class:`~..health.Health`,
as the one-shot session's is). The watchdog's heartbeat is armed only
while a device call is in flight, so an idle engine never stalls. A worker
crash or a preemption notice fails them with that typed error
(``retired['aborted']``). Anything else, a kernel's build or launch
failure among them, is a bug: it fails them loudly
(``retired['error']``). After any failure the cache is rebuilt, which
zeroes the program's own storage and builds no program.

**Live migration** (the reference's ``engine.py:1613-2003``): a sequence's
state is a portable ``mxnet_tpu.seqstate.v1`` payload (:mod:`.seqstate`).
:meth:`DecodeEngine.export_sequence` retires a sequence here (its stream
finishes ``'migrated'``) and returns its payload: ``cold`` while it is
queued, else ``paged`` (its ``pos`` K/V rows through its page table) or
``slot``; :meth:`DecodeEngine.export_all` exports everything in flight,
the live sequences at one tick boundary. :meth:`DecodeEngine.import_sequence`
lands a payload and continues it with no prefill: the rows re-chunk to
this engine's page size, the same adapter is pinned again, the draft is
re-synced by its prefill, and the returned stream's iterator yields only
the continuation. Export and import run on the worker between ticks (it
alone owns the cache); the worker only gathers and copies the rows, and
the document (base64 and the digest) is built on the calling thread.
``generate(request_id=)`` keeps at most one stream a request id (a second
admission cancels the first), and ``generate(prefill_only=True)`` exports
at the prefill boundary: the stream finishes ``'migrated'`` with the
payload on ``stream.seqstate`` (a prefix hit exports the extending state
before any token). A ``cold`` import is an ordinary admission: as in the
reference, only a live import counts in ``migrated_in`` (a cold export
counts in ``migrated_out``).

**Request tracing** (the reference's ``engine.py:422-437``): an admission
or an import given ``trace=`` (an ``observability.trace.TraceContext``,
the HTTP handler's ``srv.*`` span) emits the reference's ``eng.*`` spans
under it into :attr:`DecodeEngine.trace_sink` (the server's span buffer;
None: the process buffer), with wall-clock times taken on the worker:
``eng.queue_wait`` at admission, ``eng.prefill`` and ``eng.first_token``
after a prefill (a prefix hit's first token from a step), ``eng.steps``
when the sequence retires, ``eng.export`` (``kind='cold'`` for a queued
one) and ``eng.import``. An untraced sequence pays one None check a site;
an emit never raises into the scheduler.
"""
from __future__ import annotations

import collections
import logging
import queue as _queue
import threading
import time

import numpy as onp

from ... import config as _config
from ...resilience.policy import (CircuitBreaker, CircuitOpenError,
                                  PreemptionSignal, WorkerCrashError, inject,
                                  is_transient)
from ..adapters import AdapterPool, AdapterRegistry
from ..batcher import BackpressureError, BatcherClosed, RequestTimeout
from ..health import Health
from .paged import TRASH_PAGE, PageAllocator, PrefixCache, pages_for
from .sampling import key_for
from .seqstate import SeqStateError, build_payload, decode_payload

__all__ = ['GenerateStream', 'DecodeEngine', 'DrainTimeout']

_DONE = object()          # stream sentinel


class DrainTimeout(RequestTimeout):
    """A draining close's budget expired with this stream in flight."""


class GenerateStream:
    """Per-request handle: iterate tokens as they decode, or block for
    the full sequence with :meth:`result`.

    A failed request raises its typed error from the iterator and from
    :meth:`result` alike. ``ttft_s`` is the seconds from admission to
    the first token, once it exists (for an imported stream, from its
    import to its first continuation token). ``degraded`` turns True when
    any part of the generation ran on the CPU fallback. A
    ``prefill_only`` stream that finished ``'migrated'`` carries its
    payload in :attr:`seqstate`; ``export_seconds`` holds an exported
    stream's ``{'gather_s', 'build_s'}``: the rows' gather and copy on the
    worker, and the document's build."""

    def __init__(self, prompt_len):
        self.prompt_len = int(prompt_len)
        self.tokens = []
        self.finish_reason = None   # eos | length | error | closed | migrated
        self.ttft_s = None
        self.degraded = False
        self.export_seconds = None
        self._q = _queue.Queue()
        self._done = threading.Event()
        self._exc = None
        self._cancelled = False
        # a prefill_only export: the payload's fields, set before the
        # finish, built into the document at the first read
        self._seqstate_lock = threading.Lock()
        self._seqstate_spec = None
        self._seqstate = None

    @property
    def seqstate(self):
        """The payload a ``prefill_only`` export left, else None; built
        on the reading thread (once), not on the engine's worker."""
        with self._seqstate_lock:
            if self._seqstate is None and self._seqstate_spec is not None:
                self._seqstate = _build(self._seqstate_spec, self)
                self._seqstate_spec = None
            return self._seqstate

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _DONE:
                if self._exc is not None:
                    raise self._exc
                return
            yield item

    def result(self, timeout=None):
        """Block until the generation finishes; returns the token list
        or raises the request's typed error."""
        if not self._done.wait(timeout):
            raise RequestTimeout(
                'generation not finished within %r s' % (timeout,))
        if self._exc is not None:
            raise self._exc
        return list(self.tokens)

    def cancel(self):
        """Retire this sequence at the next token boundary."""
        self._cancelled = True

    def done(self):
        return self._done.is_set()

    def exception(self):
        return self._exc

    def _emit(self, token):
        self.tokens.append(int(token))
        self._q.put(int(token))

    def _finish(self, reason, exc=None):
        if self._done.is_set():
            return
        self.finish_reason = reason
        self._exc = exc
        self._done.set()
        self._q.put(_DONE)


def _build(spec, stream):
    """The document of an export's fields ``spec``; its build time joins
    the gather's on ``stream.export_seconds``."""
    t0 = time.perf_counter()
    payload = build_payload(**spec)
    seconds = dict(stream.export_seconds or {})
    seconds['build_s'] = time.perf_counter() - t0
    stream.export_seconds = seconds
    return payload


class _DegradedPath(Exception):
    """A device call failed transiently or the breaker is open: finish
    the work on the CPU fallback."""


class _AbortPath(Exception):
    """A device call died in a way that kills the work itself (a worker
    crash, a preemption notice): the streams fail with the typed error
    ``exc`` instead of completing degraded."""

    def __init__(self, exc):
        super().__init__(str(exc))
        self.exc = exc


class _Seq:
    """One admitted request's scheduling state."""

    __slots__ = ('stream', 'prompt', 'max_new', 'eos_id', 'slot', 'pos',
                 'last_token', 'enqueued_at', 'deadline_at', 'table',
                 'pages', 'adapter_id', 'adapter_idx', 'temperature',
                 'top_p', 'seed', 'prefill_only', 'trace')

    def __init__(self, stream, prompt, max_new, eos_id, enqueued_at,
                 deadline_at, adapter_id=None, temperature=0.0, top_p=1.0,
                 seed=0, prefill_only=False):
        self.stream = stream
        # export at the prefill boundary instead of entering the steps
        self.prefill_only = bool(prefill_only)
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.slot = None
        self.pos = None            # next cache write position
        self.last_token = None
        self.enqueued_at = enqueued_at
        self.deadline_at = deadline_at
        # paged: the page table (int32, max_pages entries, trash-filled)
        # and the pool pages this sequence holds a ref on
        self.table = None
        self.pages = []
        # the adapter it decodes under (its pool row pinned at admission)
        # and its sampling law (temperature 0 is greedy; keys from (seed,
        # absolute position))
        self.adapter_id = adapter_id
        self.adapter_idx = 0
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = int(seed)
        # request tracing: {'ctx', 'enq' (wall s), 'last' (the last phase
        # boundary), 'first_w' (the first token's, None once the steps
        # are emitted), 'tok0' (tokens present at attach)}, or None
        self.trace = None

    @property
    def extending(self):
        """True while a prefix-hit sequence still feeds its unshared
        prompt suffix through decode steps (nothing is emitted until its
        last prompt token is fed)."""
        return self.pos is not None and self.pos < len(self.prompt)


class DecodeEngine:
    """Continuous-batching scheduler over a decode program, slot or
    paged.

    ``prefix_cache`` (None: ``MXNET_TPU_SERVE_PREFIX_CACHE``) shares
    prompt prefixes on a paged program; ``draft`` (a slot
    :class:`~.program.DecodeProgram` with the target's slots) turns on
    speculative decoding on a paged program with ``spec_k > 0``;
    ``adapters`` (an :class:`~..adapters.AdapterRegistry`, or an artifact
    root; None: ``MXNET_TPU_SERVE_ADAPTER_DIR``) serves the adapter ids of
    a program built with an adapter pool. ``breaker`` (default
    ``CircuitBreaker(3, 30.0)``) guards the device calls and ``watchdog``
    (a :class:`~...resilience.Watchdog`, or None) times them."""

    def __init__(self, program, max_queue=256, timeout_s=30.0,
                 max_new_tokens=64, prefill_interleave=1, name='decode',
                 draft=None, prefix_cache=None, adapters=None, breaker=None,
                 watchdog=None):
        self.program = program
        self.slots = int(program.slots)
        self.max_queue = int(max_queue)
        self.timeout_s = float(timeout_s) if timeout_s else None
        self.default_max_new = int(max_new_tokens)
        self.prefill_interleave = max(1, int(prefill_interleave))
        self.name = name
        # the span buffer the eng.* spans go to: the HTTP server points
        # it at its own (one site a replica); None is the process buffer
        self.trace_sink = None
        self._breaker = breaker if breaker is not None else \
            CircuitBreaker(failure_threshold=3, reset_timeout=30.0)
        self._watchdog = watchdog
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._pending = []                 # FIFO of _Seq
        self._active = {}                  # slot -> _Seq
        self._free = list(range(self.slots))
        self._cache = None                 # built lazily on the worker
        self._cache_lost = False           # a rebuild after a fault failed
        self._closed = False
        self._health = Health(self._breaker, 'decode %s' % name)
        self._op_seq = 0                   # device calls, the fault steps
        self._ema_step_s = None            # recent step latency (hints)
        # degraded completions: one worker, started at the first trip,
        # takes them in turn from the queue until close() lets it go
        self._fallback_q = collections.deque()
        self._fallback_cv = threading.Condition(self._lock)
        self._fallback_worker = None
        self._fallback_seq = None          # the one it is completing
        self._fallback_exit = False
        self._counts = {'requests': 0, 'rejected': 0, 'tokens': 0,
                        'prefills': 0, 'steps': 0, 'timeouts': 0,
                        'fallback_tokens': 0,
                        'drain_timeouts': 0, 'step_seconds': 0.0,
                        'retired': {}, 'prefix_hits': 0,
                        'prefix_tokens_saved': 0, 'spec_proposed': 0,
                        'spec_accepted': 0, 'spec_rounds': 0,
                        'cow_copies': 0, 'pool_exhausted': 0,
                        'page_evictions': 0, 'sampled_tokens': 0,
                        'adapter_rejects': 0, 'migrated_out': 0,
                        'migrated_in': 0, 'prefill_exports': 0,
                        'handoff_pages': 0}
        # request_id -> its newest stream: a second admission under the
        # same id cancels the older stream (at most one decode a request)
        self._requests = {}
        # export / import requests the worker services between ticks:
        # (op, arg, result box, done event)
        self._migrations = []
        # paged scheduling: the host side of the page pool
        self.paged = bool(getattr(program, 'paged', False))
        self._allocator = self._prefix = None
        if self.paged:
            self._allocator = PageAllocator(program.pages)
            if prefix_cache is None:
                prefix_cache = _config.get('MXNET_TPU_SERVE_PREFIX_CACHE')
            if prefix_cache:
                self._prefix = PrefixCache(program.page_size,
                                           self._allocator)
        # speculative decoding: the draft proposes spec_k tokens a tick,
        # the target verifies them in one call
        self._draft = self._draft_cache = None
        self.spec_k = 0
        if draft is not None:
            spec_k = int(getattr(program, 'spec_k', 0))
            if not self.paged or not spec_k:
                raise ValueError(
                    'speculative decoding needs a paged target program '
                    'with spec_k > 0 (got paged=%r spec_k=%r)'
                    % (self.paged, spec_k))
            if int(draft.slots) != self.slots:
                raise ValueError('draft slots %d != target slots %d'
                                 % (int(draft.slots), self.slots))
            if getattr(draft, 'paged', False):
                raise ValueError(
                    'the draft must be a slot-cache program (freeze it '
                    'with paged=False)')
            dm = getattr(draft, 'model', None)
            if dm is not None and not getattr(dm, 'supports_paging', True):
                raise ValueError(
                    'draft family %r cannot roll back rejected proposals '
                    '(it needs a position-addressed cache)' % (dm.family,))
            self._draft = draft
            self.spec_k = spec_k
        # adapters: ids -> rows of the pool the program reads; a given
        # registry's pool must have the program's geometry, and its
        # storage becomes the program's pool tensors
        self._adapters = None
        aspec = getattr(program, 'adapter_spec', None)
        if aspec is not None:
            if adapters is None:
                adapters = _config.get('MXNET_TPU_SERVE_ADAPTER_DIR')
            if isinstance(adapters, AdapterRegistry):
                ps = adapters.pool.spec
                if ps != aspec:
                    raise ValueError(
                        'adapter registry pool (rank=%d capacity=%d) does not '
                        'match the program\'s adapter_spec (rank=%d '
                        'capacity=%d): the pool\'s shapes are the programs\''
                        % (ps.rank, ps.capacity, aspec.rank, aspec.capacity))
            else:
                adapters = AdapterRegistry(AdapterPool(aspec),
                                           root=adapters or None)
            adapters.pool.bind(program.apool)
            self._adapters = adapters
        elif adapters is not None:
            raise ValueError('adapters given but the program was frozen '
                             'without an adapter_spec (freeze with '
                             'adapter_rank > 0)')
        self.sample_args = bool(getattr(program, 'sample_args', False))
        # whether the programs carry extras at all (the per-slot arrays
        # are not even built when not)
        self._extras_on = self.sample_args or aspec is not None
        # every program the engine can run is built before the first
        # request, as the reference's server warms its program; no
        # request builds one afterwards
        for prog in (program, draft):
            if callable(getattr(prog, 'warmup', None)):
                prog.warmup()
        self._worker = threading.Thread(
            target=self._run, daemon=True,
            name='mxnet-tpu-torch-%s-decode' % name)
        self._worker.start()
        self._reaper = None
        if self.timeout_s:
            self._reaper = threading.Thread(
                target=self._reap_loop, daemon=True,
                name='mxnet-tpu-torch-%s-decode-reaper' % name)
            self._reaper.start()

    # -- request tracing ---------------------------------------------------

    def _trace_span(self, seq, name, t0, t1, **attrs):
        """One ``eng.*`` span under the sequence's trace context, with
        explicit wall times (the worker has no ambient context). A no-op
        for an untraced sequence; never raises into the scheduler."""
        tr = seq.trace
        if tr is None:
            return
        sink = self.trace_sink
        try:
            if sink is None:
                from ...observability import trace as _tr
                sink = _tr.get_buffer()
            sink.emit(name, tr['ctx'].child(), t0, t1, **attrs)
        except Exception:  # noqa: BLE001 - tracing never fails a request
            pass

    def _trace_first_token(self, seq):
        """``eng.first_token`` of a sequence whose first token comes from
        a step (a prefix hit, an extending import)."""
        tr = seq.trace
        if tr is not None and not seq.stream.tokens:
            w = time.time()
            self._trace_span(seq, 'eng.first_token', tr['last'], w,
                             ttft_s=round(w - tr['enq'], 6))
            tr['first_w'] = w

    # -- submission --------------------------------------------------------

    def generate(self, tokens, max_new_tokens=None, eos_id=None,
                 adapter=None, temperature=0.0, top_p=1.0, seed=0,
                 request_id=None, prefill_only=False, trace=None):
        """Admit one prompt; returns its :class:`GenerateStream`.

        ``request_id`` makes the admission idempotent: a second admission
        under the same id (a gateway re-admitting after a failover)
        cancels the older stream at its next token boundary.
        ``prefill_only`` runs the prefill (its first token streamed as
        usual), then exports the sequence instead of stepping it: the
        stream finishes ``'migrated'`` with the payload on
        ``stream.seqstate``; a first-token EOS or ``max_new_tokens=1``
        finishes normally. ``trace`` (a ``TraceContext``) attaches the
        request's trace: the engine emits its ``eng.*`` spans under it.

        ``adapter`` picks the adapter (an id of the engine's registry;
        None, '' or 'base' is the frozen base); ``temperature`` (0:
        greedy, byte for byte the greedy program's tokens), ``top_p`` and
        ``seed`` the sampling law. Both are values of the programs'
        extras: any mix in one batch builds no program.

        Raises :class:`BackpressureError` when the pending queue is at
        depth, ``ValueError`` for an empty or over-long prompt, a bad
        sampling law or an adapter this engine does not serve (typed at
        admission, not mid-decode), :class:`BatcherClosed` after
        :meth:`close`."""
        prompt = [int(t) for t in onp.asarray(tokens).reshape(-1)]
        if not prompt:
            raise ValueError('empty prompt')
        if len(prompt) > self.program.max_prompt_len():
            raise ValueError(
                'prompt of %d tokens exceeds the top prefill bucket %d'
                % (len(prompt), self.program.max_prompt_len()))
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.default_max_new)
        if max_new < 1:
            raise ValueError('max_new_tokens must be >= 1')
        temperature = float(temperature)
        top_p = float(top_p)
        if temperature < 0:
            raise ValueError('temperature must be >= 0')
        if not 0 < top_p <= 1:
            raise ValueError('top_p must be in (0, 1]')
        if temperature > 0 and not self.sample_args:
            raise ValueError(
                'sampled decoding requested (temperature=%g) but the program '
                'was frozen without sampling args (freeze with '
                'sample_args=True)' % temperature)
        if adapter not in AdapterRegistry.BASE_IDS and self._adapters is None:
            raise ValueError(
                'adapter %r requested but this engine serves no adapters '
                '(freeze with adapter_rank > 0 and point '
                'MXNET_TPU_SERVE_ADAPTER_DIR at the artifacts)' % (adapter,))
        now = time.monotonic()
        stream = GenerateStream(len(prompt))
        seq = _Seq(stream, prompt, max_new, eos_id, now,
                   now + self.timeout_s if self.timeout_s else None,
                   adapter_id=(None if adapter in AdapterRegistry.BASE_IDS
                               else str(adapter)),
                   temperature=temperature, top_p=top_p, seed=seed,
                   prefill_only=prefill_only)
        if trace is not None:
            w = time.time()
            seq.trace = {'ctx': trace, 'enq': w, 'last': w, 'first_w': None,
                         'tok0': 0}
        with self._lock:
            if self._closed:
                raise BatcherClosed('decode engine %r is closed'
                                    % self.name)
            depth = len(self._pending)
            if depth >= self.max_queue:
                self._counts['rejected'] += 1
                raise BackpressureError(depth, self.max_queue)
            self._pending.append(seq)
            self._counts['requests'] += 1
            superseded = self._note_request_locked(request_id, stream)
            self._wake.notify()
        if superseded is not None and not superseded.done():
            superseded.cancel()
        return stream

    def _note_request_locked(self, request_id, stream):
        """Map ``request_id`` to ``stream`` (under the lock); returns the
        stream it supersedes, if any. Finished streams leave the map once
        it outgrows everything that can be in flight."""
        if request_id is None:
            return None
        superseded = self._requests.get(request_id)
        self._requests[request_id] = stream
        if len(self._requests) > 4 * (self.max_queue + self.slots):
            self._requests = {k: s for k, s in self._requests.items()
                              if not s.done()}
        return superseded

    # -- reaper (budget enforcement independent of the worker) -------------

    def _reap_loop(self):
        while True:
            time.sleep(min(0.05, max(self.timeout_s / 4.0, 0.005)))
            with self._lock:
                if self._closed and not self._pending \
                        and not self._active and not self._fallback_q:
                    return
                now = time.monotonic()
                kept = []
                for seq in self._pending:
                    if seq.deadline_at is not None \
                            and now >= seq.deadline_at:
                        self._counts['timeouts'] += 1
                        seq.stream._finish('error', RequestTimeout(
                            'request waited %.3fs in queue (budget '
                            '%.3fs)' % (now - seq.enqueued_at,
                                        self.timeout_s)))
                    elif seq.stream._cancelled:
                        seq.stream._finish('cancelled')
                    else:
                        kept.append(seq)
                self._pending = kept
                # degraded sequences still queued for the fallback worker
                kept = collections.deque()
                for seq in self._fallback_q:
                    if seq.deadline_at is not None \
                            and now >= seq.deadline_at:
                        self._counts['timeouts'] += 1
                        seq.stream._finish('error', RequestTimeout(
                            'request waited %.3fs for the CPU fallback '
                            '(budget %.3fs)' % (now - seq.enqueued_at,
                                                self.timeout_s)))
                    elif seq.stream._cancelled:
                        seq.stream._finish('cancelled')
                    else:
                        kept.append(seq)
                self._fallback_q = kept
                # active sequences past budget: fail the stream now (the
                # client unblocks even while the worker is inside a
                # device call); the worker frees the slot at the next
                # token boundary
                for seq in self._active.values():
                    if seq.deadline_at is not None \
                            and now >= seq.deadline_at \
                            and not seq.stream.done():
                        self._counts['timeouts'] += 1
                        seq.stream._finish('error', RequestTimeout(
                            'generation exceeded its %.3fs budget '
                            'mid-stream (%d tokens emitted)'
                            % (self.timeout_s,
                               len(seq.stream.tokens))))

    # -- worker ------------------------------------------------------------

    def _run(self):
        while True:
            with self._lock:
                while not self._pending and not self._active \
                        and not self._migrations:
                    if self._closed:
                        return
                    self._wake.wait(0.05)
            try:
                self._tick()
            except Exception:           # pragma: no cover - last resort
                logging.exception('decode engine %s: scheduler tick '
                                  'failed', self.name)
                time.sleep(0.01)

    def _tick(self):
        """One scheduler iteration: retire abandoned slots, admit
        prefills, advance the live batch one token; migrations are
        serviced first, at the token boundary."""
        self._retire_abandoned()
        self._service_migrations()
        budget = self.prefill_interleave if self._active else self.slots
        while budget > 0:
            with self._lock:
                if not self._pending or not self._free:
                    break
                seq = self._pending.pop(0)
                slot = self._free.pop(0)
            if self.paged:
                self._admit_paged(seq, slot)
            else:
                self._admit(seq, slot)
            budget -= 1
        if self._active:
            self._step()

    def _retire_abandoned(self):
        """Free slots whose stream is already done (reaper timeout or
        client cancel)."""
        with self._lock:
            doomed = [(slot, seq) for slot, seq in self._active.items()
                      if seq.stream.done() or seq.stream._cancelled]
        for slot, seq in doomed:
            if seq.stream._cancelled and not seq.stream.done():
                seq.stream._finish('cancelled')
            self._retire(slot, seq, seq.stream.finish_reason
                         or 'cancelled')

    def _retire(self, slot, seq, reason):
        with self._lock:
            if self._active.get(slot) is seq:
                del self._active[slot]
                self._free.append(slot)
                self._counts['retired'][reason] = \
                    self._counts['retired'].get(reason, 0) + 1
                # drop the sequence's page holds; pages the prefix
                # registry still holds stay for later hits
                self._release_pages_locked(seq)
        # the adapter row's pin goes outside the lock (the pool has its own)
        self._release_adapter(seq)
        tr = seq.trace
        if tr is not None and tr['first_w'] is not None:
            # this engine's segment of the request's step loop (a migrated
            # sequence closes its segment here, the importer opens its own)
            w = time.time()
            ntok = len(seq.stream.tokens) - tr['tok0']
            steps = max(0, ntok - 1)
            if steps and w > tr['first_w']:
                self._trace_span(seq, 'eng.steps', tr['first_w'], w,
                                 tokens=ntok, steps=steps, reason=reason)
            tr['first_w'] = None

    # -- paged pool bookkeeping (worker thread only) ------------------------

    def _rebuild_cache(self):
        """The device cache zeroed: at first use, and after a failed
        device call (the in-place updates may have left it half written;
        the program zeroes its own storage, which its graphs write, and
        builds no program). The pool's host state describes the old pool,
        so it resets with it; callers retire (and release) their slots
        first."""
        if self._allocator is not None:
            with self._lock:
                self._allocator.reset()
                if self._prefix is not None:
                    self._prefix.clear()
        self._cache = self._draft_cache = None
        self._cache = self.program.new_cache()
        if self._draft is not None:
            self._draft_cache = self._draft.new_cache()

    def _reset_cache(self):
        """:meth:`_rebuild_cache` after a failed device call. After a
        real fault the card's context may be unusable, and then the
        rebuild raises: the engine is left without a cache, degraded, with
        the breaker counting the failure, and the next admission tries
        again (:meth:`_ensure_cache`); nothing here raises."""
        try:
            self._rebuild_cache()
        except Exception as exc:
            # admissions degrade until a rebuild succeeds
            self._cache_lost = True
            self._health.lost('cache rebuild', exc)

    def _ensure_cache(self):
        """The cache, built at first use. After a failed rebuild it is
        rebuilt only when the breaker lets a call through; a refusal or
        another failure degrades the request being admitted."""
        if self._cache is not None:
            return
        if not self._cache_lost:
            self._rebuild_cache()
            return
        if self._breaker.state == 'open':
            raise _DegradedPath()
        try:
            self._rebuild_cache()
        except Exception as exc:
            self._health.lost('cache rebuild', exc)
            raise _DegradedPath() from exc
        self._cache_lost = False

    def _release_pages_locked(self, seq):
        if self._allocator is not None and seq.pages:
            for p in seq.pages:
                self._allocator.release(p)
            seq.pages = []

    def _free_slot(self, seq, slot):
        """Give back a slot that never went live, its pages and its
        adapter row's pin."""
        with self._lock:
            self._release_pages_locked(seq)
            self._free.append(slot)
        self._release_adapter(seq)

    def _alloc_pages(self, n):
        """``n`` fresh pages, evicting LRU cached prefixes under pool
        pressure; None when the pool is exhausted."""
        with self._lock:
            ids = self._allocator.alloc(n)
            if ids is None and self._prefix is not None:
                evicted = self._prefix.evict_lru(n)
                self._counts['page_evictions'] += len(evicted)
                ids = self._allocator.alloc(n)
        return ids

    def _fail_pool_exhausted(self, seq):
        """An exhausted pool is typed backpressure, never a stall: the
        stream fails with BackpressureError and the client backs off."""
        with self._lock:
            self._counts['pool_exhausted'] += 1
            depth = len(self._pending)
        seq.stream._finish('error', BackpressureError(depth, self.max_queue))

    def _ensure_writable(self, seq, first_pos, last_pos):
        """Make every page this tick writes (positions ``first_pos ..
        last_pos`` of ``seq``) private: allocate pages at boundary
        crossings, copy shared pages on write. Returns False when the
        pool is exhausted (after LRU eviction); a failed copy raises as
        :meth:`_device` sorts it."""
        ps = self.program.page_size
        for pi in range(int(first_pos) // ps, int(last_pos) // ps + 1):
            page = int(seq.table[pi])
            if page == TRASH_PAGE:
                ids = self._alloc_pages(1)
                if ids is None:
                    return False
                seq.table[pi] = ids[0]
                with self._lock:
                    seq.pages.append(ids[0])
                continue
            with self._lock:
                shared = self._allocator.refcount(page) > 1
                if shared and self._prefix is not None \
                        and self._allocator.refcount(page) == 2 \
                        and self._prefix.release_leaf(page):
                    # the registry was the only other holder: its
                    # registration goes instead of a copy
                    shared = self._allocator.refcount(page) > 1
            if not shared:
                continue
            # copy-on-write: the first divergent write into a shared
            # page lands in this sequence's own copy
            ids = self._alloc_pages(1)
            if ids is None:
                return False
            self._cache = self._device(self.program.run_copy_page,
                                       self._cache, page, ids[0])
            with self._lock:
                self._allocator.release(page)
                seq.pages.remove(page)
                seq.pages.append(ids[0])
                self._counts['cow_copies'] += 1
            seq.table[pi] = ids[0]
        return True

    # -- device calls under the breaker and the watchdog --------------------

    def _next_op(self):
        with self._lock:
            op = self._op_seq
            self._op_seq += 1
        return op

    def _execute(self, fn, step, *args, **kwargs):
        """One device call: the scripted faults of ``serving.decode`` fire
        first (before a replay, so a captured program stays whole), then
        the watchdog's check (a scripted ``hang`` aged the heartbeat at
        :meth:`_device`'s beat)."""
        inject('serving.decode',
               ('device_loss', 'device_unavailable', 'tunnel_stall',
                'worker_crash', 'preempt'), step=step)
        if self._watchdog is not None:
            self._watchdog.check()
        return fn(*args, **kwargs)

    def _device(self, fn, *args, **kwargs):
        """Run one device call under the breaker. A transient failure or
        an open breaker raises :class:`_DegradedPath` after recording the
        trip; a worker crash or a preemption notice :class:`_AbortPath`;
        anything else (a kernel's build or launch failure among them)
        propagates as it is. The watchdog's heartbeat is armed for the
        call only: an idle engine never reads as stalled."""
        step = self._next_op()
        if self._watchdog is not None:
            self._watchdog.beat(step=step, phase='decode')
        was_open = self._breaker.state == 'open'
        try:
            out = self._breaker.call(self._execute, fn, step, *args,
                                     **kwargs)
        except (WorkerCrashError, PreemptionSignal) as exc:
            # the breaker counted the failure (breaker.call)
            self._health.failed(exc, 'device call %s' % step, was_open)
            raise _AbortPath(exc) from exc
        except Exception as exc:
            if not (is_transient(exc)
                    or isinstance(exc, CircuitOpenError)):
                raise               # bug-shaped: surface loudly
            self._health.failed(exc, 'device call %s' % step, was_open)
            raise _DegradedPath() from exc
        finally:
            if self._watchdog is not None:
                self._watchdog.idle()
        self._health.recovered()
        return out

    def on_stall(self, record):
        """The watchdog monitor's escalation (wired by the session): a
        device call overran its budget with the worker still inside
        it."""
        self._health.stalled(record)

    # -- the programs' sampling / adapter extras ----------------------------

    def _release_adapter(self, seq):
        if self._adapters is not None and seq.adapter_idx:
            self._adapters.release(seq.adapter_idx)
            seq.adapter_idx = 0

    def _admit_adapter(self, seq, slot):
        """Pin the sequence's adapter row at admission (a cold adapter is
        written into the pool once, a warm one is a refcount). On failure
        (an unknown id; every row pinned) this request fails typed and
        its slot frees. Returns False when admission must stop."""
        if seq.adapter_id is None or self._adapters is None:
            return True
        try:
            seq.adapter_idx = self._adapters.acquire(seq.adapter_id)
            return True
        except (KeyError, ValueError, OSError, RuntimeError) as exc:
            # an unknown id, a bad artifact, a full pool (a
            # BackpressureError) or a failed write of the row
            with self._lock:
                self._free.append(slot)
                self._counts['adapter_rejects'] += 1
            seq.stream._finish('error', exc)
            return False

    def _prefill_extras(self, seq):
        """The extras of one ``run_prefill``: the key of the logits row at
        ``len(prompt) - 1``, the adapter row; {} without extras."""
        if not self._extras_on:
            return {}
        kw = {}
        if self.sample_args and seq.temperature > 0:
            kw['temps'] = [seq.temperature]
            kw['top_ps'] = [seq.top_p]
            kw['keys'] = key_for(seq.seed, len(seq.prompt) - 1)[None]
        if self._adapters is not None:
            kw['aidx'] = [seq.adapter_idx]
        return kw

    def _step_extras(self, active, spec_c=0):
        """The extras of one step a row a slot, or of one verify pass
        (``spec_c`` keys a slot, at positions ``pos .. pos + spec_c - 1``:
        the keys the plain path would use there); {} without extras."""
        if not self._extras_on:
            return {}
        kw = {}
        if self.sample_args:
            temps = onp.zeros(self.slots, 'float32')
            top_ps = onp.ones(self.slots, 'float32')
            keys = onp.zeros((self.slots, spec_c, 2) if spec_c
                             else (self.slots, 2), 'uint32')
            for slot, seq in active.items():
                if seq.temperature <= 0:
                    continue
                temps[slot] = seq.temperature
                top_ps[slot] = seq.top_p
                if spec_c:
                    for c in range(spec_c):
                        keys[slot, c] = key_for(seq.seed, seq.pos + c)
                else:
                    keys[slot] = key_for(seq.seed, seq.pos)
            kw.update(temps=temps, top_ps=top_ps, keys=keys)
        if self._adapters is not None:
            aidx = onp.zeros(self.slots, 'int32')
            for slot, seq in active.items():
                aidx[slot] = seq.adapter_idx
            kw['aidx'] = aidx
        return kw

    def _draft_step_extras(self, active, off):
        """The draft's proposal for position ``pos + off`` drawn with the
        key the verify pass uses there: when the draft agrees with the
        target, it proposes the very token the target samples."""
        temps = onp.zeros(self.slots, 'float32')
        top_ps = onp.ones(self.slots, 'float32')
        keys = onp.zeros((self.slots, 2), 'uint32')
        for slot, seq in active.items():
            if seq.temperature <= 0:
                continue
            temps[slot] = seq.temperature
            top_ps[slot] = seq.top_p
            keys[slot] = key_for(seq.seed, seq.pos + off)
        return {'temps': temps, 'top_ps': top_ps, 'keys': keys}

    def _admit(self, seq, slot):
        """Prefill one pending request into ``slot`` (join)."""
        if seq.stream.done() or seq.stream._cancelled:
            if not seq.stream.done():
                seq.stream._finish('cancelled')
            with self._lock:
                self._free.append(slot)
            return
        self._trace_queue_wait(seq)
        if not self._admit_adapter(seq, slot):
            return
        try:
            self._ensure_cache()
            self._cache, tok, _logits = self._device(
                self.program.run_prefill, self._cache,
                onp.asarray(seq.prompt, 'int32'), slot,
                **self._prefill_extras(seq))
        except _DegradedPath:
            self._free_slot(seq, slot)
            self._spawn_fallback([seq])
            return
        except _AbortPath as ab:
            # a worker crash / preemption at prefill fails THIS request
            # typed; the client retries
            self._free_slot(seq, slot)
            seq.stream._finish('error', ab.exc)
            return
        except Exception as exc:
            # bug-shaped: fail THIS request loudly, never leak its slot,
            # its adapter pin or leave its stream blocking
            self._free_slot(seq, slot)
            seq.stream._finish('error', exc)
            logging.exception('decode %s: prefill failed', self.name)
            return
        self._join(seq, slot, tok)

    def _trace_queue_wait(self, seq):
        tr = seq.trace
        if tr is not None:
            w0 = time.time()
            self._trace_span(seq, 'eng.queue_wait', tr['enq'], w0)
            tr['last'] = w0

    def _join(self, seq, slot, tok):
        """A prefilled sequence joins the batch with its first token."""
        tr = seq.trace
        if tr is not None:
            w1 = time.time()
            self._trace_span(seq, 'eng.prefill', tr['last'], w1,
                             tokens=len(seq.prompt))
            self._trace_span(seq, 'eng.first_token', tr['last'], w1,
                             ttft_s=round(w1 - tr['enq'], 6))
            tr['last'] = tr['first_w'] = w1
        with self._lock:
            self._counts['prefills'] += 1
            self._counts['tokens'] += 1
            if seq.temperature > 0:
                self._counts['sampled_tokens'] += 1
            # registered BEFORE the finish check so a first-token EOS /
            # max_new=1 retirement flows through _retire
            self._active[slot] = seq
        seq.slot = slot
        seq.pos = len(seq.prompt)
        seq.last_token = int(tok)
        self._emit_token(seq, tok)
        reason = self._finished_reason(seq, int(tok))
        if reason is not None:
            seq.stream._finish(reason)
            self._retire(slot, seq, reason)
        elif seq.prefill_only:
            self._export_at_boundary(seq, slot)

    def _export_at_boundary(self, seq, slot):
        """A ``prefill_only`` sequence at its prefill boundary: export it
        (the payload's fields stashed on the stream, the document built
        where it is read) and finish ``'migrated'``. A failed export fails
        this request typed and frees its slot and pages."""
        try:
            self._do_export(seq.stream, stash=True)
            with self._lock:
                self._counts['prefill_exports'] += 1
        except BaseException as exc:
            if not seq.stream.done():
                seq.stream._finish('error', exc)
                self._retire(slot, seq, 'error')
            logging.exception('decode %s: prefill-boundary export failed',
                              self.name)

    def _admit_paged(self, seq, slot):
        """Paged join: a prefix-cache hit references the registered pages
        and streams the rest of the prompt through decode steps (no
        prefill runs for the shared pages); a miss allocates pages and
        runs one bucketed prefill into them. A refused sequence gives
        back its slot and pages before its stream fails."""
        if seq.stream.done() or seq.stream._cancelled:
            if not seq.stream.done():
                seq.stream._finish('cancelled')
            with self._lock:
                self._free.append(slot)
            return
        self._trace_queue_wait(seq)
        if not self._admit_adapter(seq, slot):
            return
        prompt = seq.prompt
        n = len(prompt)
        seq.table = onp.full(self.program.max_pages, TRASH_PAGE, 'int32')
        try:
            self._ensure_cache()
            shared, covered = [], 0
            if self._prefix is not None:
                # namespaced by adapter id: an adapter's K/V rows for the
                # same tokens differ, so a hit never crosses adapters
                with self._lock:
                    shared, covered = self._prefix.lookup(
                        prompt, namespace=seq.adapter_id)
                # leave >= 1 prompt token to step on: its logits give
                # the first generated token
                covered = min(covered, n - 1)
            if covered > 0:
                with self._lock:
                    for p in shared:
                        self._allocator.ref(p)
                    seq.pages = list(shared)
                    self._counts['prefix_hits'] += 1
                    self._counts['prefix_tokens_saved'] += covered
                seq.table[:len(shared)] = shared
                if self._draft is not None:
                    # the draft has no prefix cache: prefill it whole
                    self._draft_cache, _t, _l = self._device(
                        self._draft.run_prefill, self._draft_cache,
                        onp.asarray(prompt, 'int32'), slot)
                seq.slot = slot
                seq.pos = covered
                seq.last_token = int(prompt[covered])
                with self._lock:
                    self._active[slot] = seq
                if seq.prefill_only:
                    # the extending state, before any token: the importer
                    # streams the unshared suffix through its own steps
                    self._export_at_boundary(seq, slot)
                return
            ids = self._alloc_pages(pages_for(n, self.program.page_size))
            if ids is None:
                self._free_slot(seq, slot)
                self._fail_pool_exhausted(seq)
                return
            with self._lock:
                seq.pages = list(ids)
            seq.table[:len(ids)] = ids
            self._cache, tok, _logits = self._device(
                self.program.run_prefill, self._cache,
                onp.asarray(prompt, 'int32'), ids,
                **self._prefill_extras(seq))
            if self._draft is not None:
                self._draft_cache, _t, _l = self._device(
                    self._draft.run_prefill, self._draft_cache,
                    onp.asarray(prompt, 'int32'), slot)
            if self._prefix is not None:
                with self._lock:
                    self._prefix.register(prompt, ids,
                                          namespace=seq.adapter_id)
        except _DegradedPath:
            self._free_slot(seq, slot)
            self._spawn_fallback([seq])
            return
        except _AbortPath as ab:
            self._free_slot(seq, slot)
            seq.stream._finish('error', ab.exc)
            return
        except Exception as exc:
            self._free_slot(seq, slot)
            seq.stream._finish('error', exc)
            logging.exception('decode %s: paged prefill failed', self.name)
            return
        self._join(seq, slot, tok)

    @staticmethod
    def _emit_token(seq, tok):
        """Stream one generated token; the first sets the TTFT (a
        prefix-hit sequence earns its first token from a decode step)."""
        if seq.stream.ttft_s is None:
            seq.stream.ttft_s = max(0.0, time.monotonic() - seq.enqueued_at)
        seq.stream._emit(tok)

    def _finished_reason(self, seq, tok):
        if seq.eos_id is not None and tok == seq.eos_id:
            return 'eos'
        if len(seq.stream.tokens) >= seq.max_new:
            return 'length'
        if seq.pos + 1 >= self.program.max_len:
            return 'length'
        return None

    def _step(self):
        """Advance every live slot one token; a paged engine runs the
        page-table step, or the speculative tick when every live slot
        allows it (none extending, ``pos + spec_k < max_len``)."""
        with self._lock:
            active = dict(self._active)
        if not active:
            return
        if self.paged:
            if self._draft is not None and all(
                    not s.extending
                    and s.pos + self.spec_k < self.program.max_len
                    for s in active.values()):
                self._spec_step(active)
            else:
                self._paged_step(active)
            return
        tokens = onp.zeros(self.slots, 'int32')
        positions = onp.zeros(self.slots, 'int32')
        for slot, seq in active.items():
            tokens[slot] = seq.last_token
            positions[slot] = seq.pos
        t0 = time.monotonic()
        try:
            self._cache, toks, _logits = self._device(
                self.program.run_step, self._cache, tokens, positions,
                **self._step_extras(active))
        except _DegradedPath:
            self._degrade_inflight(active)
            return
        except _AbortPath as ab:
            self._fail_inflight(active, ab.exc, 'aborted')
            return
        except Exception as exc:
            logging.exception('decode %s: step failed', self.name)
            self._fail_inflight(active, exc, 'error')
            return
        dt = time.monotonic() - t0
        with self._lock:
            self._counts['steps'] += 1
            self._counts['tokens'] += len(active)
            self._note_step_locked(dt)
        sampled = 0
        for slot, seq in active.items():
            if seq.stream.done() or seq.stream._cancelled:
                continue            # retired at the next tick
            tok = int(toks[slot])
            seq.pos += 1
            seq.last_token = tok
            self._emit_token(seq, tok)
            sampled += seq.temperature > 0
            reason = self._finished_reason(seq, tok)
            if reason is not None:
                seq.stream._finish(reason)
                self._retire(slot, seq, reason)
        with self._lock:
            self._counts['sampled_tokens'] += sampled

    def _fail_inflight(self, active, exc, reason):
        """A device call aborted (``reason`` 'aborted': a worker crash, a
        preemption notice) or failed bug-shaped ('error'): fail the
        streams it carried with ``exc``, retire their slots (and pages),
        then rebuild the cache at once, as the reference's except paths
        do: the pool's host state (free list, refcounts, prefix
        registrations) resets with it, so ``stats()`` and
        :meth:`cache_accounting` read the empty pool before any new
        admission."""
        for slot, seq in active.items():
            seq.stream._finish('error', exc)
            self._retire(slot, seq, reason)
        self._reset_cache()

    def _page_faults(self, active, lookahead=0):
        """Before a step: allocate pages at boundary crossings and copy
        shared pages on write for every live slot, positions ``pos ..
        pos + lookahead``. An exhausted pool fails that stream typed and
        drops it from this tick."""
        for slot, seq in list(active.items()):
            if seq.stream.done() or seq.stream._cancelled:
                continue
            if not self._ensure_writable(seq, seq.pos, seq.pos + lookahead):
                self._fail_pool_exhausted(seq)
                self._retire(slot, seq, 'error')
                del active[slot]
        return active

    def _paged_step(self, active):
        """One decode step through the page tables. A slot still
        extending (a prefix hit feeding its prompt suffix) feeds prompt
        tokens and emits nothing until its last prompt token's logits
        give its first generated token. With a draft, the draft's cache
        steps too, so that its history has no hole at these positions."""
        tokens = onp.zeros(self.slots, 'int32')
        positions = onp.zeros(self.slots, 'int32')
        tables = onp.zeros((self.slots, self.program.max_pages), 'int32')
        t0 = time.monotonic()
        try:
            active = self._page_faults(active)
            if not active:
                return
            for slot, seq in active.items():
                tokens[slot] = seq.last_token
                positions[slot] = seq.pos
                tables[slot] = seq.table
            self._cache, toks, _logits = self._device(
                self.program.run_step, self._cache, tokens, positions,
                tables, **self._step_extras(active))
            if self._draft is not None:
                self._draft_cache, _t, _l = self._device(
                    self._draft.run_step, self._draft_cache, tokens,
                    positions)
        except _DegradedPath:
            self._degrade_inflight(active)
            return
        except _AbortPath as ab:
            self._fail_inflight(active, ab.exc, 'aborted')
            return
        except Exception as exc:
            logging.exception('decode %s: paged step failed', self.name)
            self._fail_inflight(active, exc, 'error')
            return
        dt = time.monotonic() - t0
        emitted = sampled = 0
        for slot, seq in active.items():
            if seq.stream.done() or seq.stream._cancelled:
                continue            # retired at the next tick
            fed = seq.pos
            seq.pos += 1
            if fed < len(seq.prompt) - 1:
                # extending: the next prompt token feeds
                seq.last_token = int(seq.prompt[seq.pos])
                continue
            tok = int(toks[slot])
            seq.last_token = tok
            self._trace_first_token(seq)
            self._emit_token(seq, tok)
            emitted += 1
            sampled += seq.temperature > 0
            reason = self._finished_reason(seq, tok)
            if reason is not None:
                seq.stream._finish(reason)
                self._retire(slot, seq, reason)
        with self._lock:
            self._counts['steps'] += 1
            self._counts['tokens'] += emitted
            self._counts['sampled_tokens'] += sampled
            self._note_step_locked(dt)

    def _spec_step(self, active):
        """Speculative tick: the draft proposes ``spec_k`` tokens (that
        many draft steps), the target scores all ``spec_k + 1`` positions
        in one verify call, and the longest greedy-matching prefix is
        accepted plus the target's token at the first mismatch: 1 to
        ``spec_k + 1`` tokens a sequence for one target pass."""
        k = self.spec_k
        C = k + 1
        inputs = onp.zeros((self.slots, C), 'int32')
        positions = onp.zeros(self.slots, 'int32')
        tables = onp.zeros((self.slots, self.program.max_pages), 'int32')
        t0 = time.monotonic()
        try:
            active = self._page_faults(active, lookahead=k)
            if not active:
                return
            for slot, seq in active.items():
                inputs[slot, 0] = seq.last_token
                positions[slot] = seq.pos
                tables[slot] = seq.table
            # coupled proposals when both programs sample; a greedy draft
            # under sampled verify stays right (every emitted token is a
            # target draw), it only accepts less
            couple = self.sample_args and getattr(self._draft, 'sample_args',
                                                  False)
            cur = inputs[:, 0].copy()
            for c in range(1, C):
                self._draft_cache, dtoks, _l = self._device(
                    self._draft.run_step, self._draft_cache, cur,
                    positions + (c - 1),
                    **(self._draft_step_extras(active, c - 1) if couple
                       else {}))
                cur = onp.asarray(dtoks, 'int32').copy()
                inputs[:, c] = cur
            # feed the last proposal too (its output is dropped): a fully
            # accepted round moves past pos + k, and this is the only
            # write of that draft row; skipped, every later proposal
            # would attend a zero row there
            self._draft_cache, _t, _l = self._device(
                self._draft.run_step, self._draft_cache, cur, positions + k)
            self._cache, vtoks, _logits = self._device(
                self.program.run_verify, self._cache, inputs, positions,
                tables, **self._step_extras(active, spec_c=C))
        except _DegradedPath:
            self._degrade_inflight(active)
            return
        except _AbortPath as ab:
            self._fail_inflight(active, ab.exc, 'aborted')
            return
        except Exception as exc:
            logging.exception('decode %s: speculative step failed',
                              self.name)
            self._fail_inflight(active, exc, 'error')
            return
        dt = time.monotonic() - t0
        emitted_total = accepted_total = proposed_total = sampled_total = 0
        for slot, seq in active.items():
            if seq.stream.done() or seq.stream._cancelled:
                continue            # its proposals were never judged
            proposed_total += k
            # the target's token at index c predicts position pos + c + 1;
            # the draft's next proposal is accepted while it matches
            emitted = []
            adv = 1
            for c in range(C):
                emitted.append(int(vtoks[slot, c]))
                if c < k and int(inputs[slot, c + 1]) == emitted[-1]:
                    adv += 1
                    continue
                break
            p0 = seq.pos
            seq.pos = p0 + adv
            seq.last_token = emitted[-1]
            accepted_total += adv - 1
            reason = None
            for i, tok in enumerate(emitted):
                self._trace_first_token(seq)
                self._emit_token(seq, tok)
                emitted_total += 1
                sampled_total += seq.temperature > 0
                # each token's finish check at its own position p0 + i + 1
                if seq.eos_id is not None and tok == seq.eos_id:
                    reason = 'eos'
                elif len(seq.stream.tokens) >= seq.max_new:
                    reason = 'length'
                elif p0 + i + 2 >= self.program.max_len:
                    reason = 'length'
                if reason is not None:
                    break
            if reason is not None:
                seq.stream._finish(reason)
                self._retire(slot, seq, reason)
        with self._lock:
            self._counts['steps'] += 1
            self._counts['spec_rounds'] += 1
            self._counts['spec_proposed'] += proposed_total
            self._counts['spec_accepted'] += accepted_total
            self._counts['tokens'] += emitted_total
            self._counts['sampled_tokens'] += sampled_total
            self._note_step_locked(dt)

    # -- live migration (seqstate export / import) --------------------------

    def _submit_migration(self, op, arg):
        """Queue an export or import for the worker; returns its (result
        box, done event)."""
        box, ev = {}, threading.Event()
        with self._wake:
            if self._closed:
                raise BatcherClosed('decode engine %r is closed' % self.name)
            self._migrations.append((op, arg, box, ev))
            self._wake.notify()
        return box, ev

    @staticmethod
    def _await_migration(op, box, ev, timeout):
        if not ev.wait(timeout):
            raise RequestTimeout('sequence %s not serviced within %r s '
                                 '(worker wedged?)' % (op, timeout))
        if 'error' in box:
            raise box['error']
        return box['result']

    def _service_migrations(self):
        """The worker, at the tick boundary: every queued export and
        import (the sequences sit on a token boundary, the cache is
        still)."""
        while True:
            with self._lock:
                if not self._migrations:
                    return
                op, arg, box, ev = self._migrations.pop(0)
            try:
                if op == 'export':
                    box['result'] = self._do_export(arg)
                else:
                    box['result'] = self._do_import(arg)
            except Exception as exc:
                box['error'] = exc
            ev.set()

    @staticmethod
    def _sampling_of(seq):
        """The payload's sampling block: None for a greedy sequence."""
        if seq.temperature <= 0:
            return None
        return {'temperature': seq.temperature, 'top_p': seq.top_p,
                'seed': seq.seed}

    def _request_id_for_locked(self, stream):
        for rid, s in self._requests.items():
            if s is stream:
                return rid
        return None

    def _export_cold(self, seq, rid):
        """The payload of a sequence taken off the queue; its stream
        finishes ``'migrated'``."""
        seq.stream.export_seconds = {'gather_s': 0.0}
        payload = _build(dict(
            kind='cold', prompt=seq.prompt, emitted=[], pos=0,
            last_token=None, max_new=seq.max_new, eos_id=seq.eos_id,
            request_id=rid, adapter_id=seq.adapter_id,
            sampling=self._sampling_of(seq)), seq.stream)
        seq.stream._finish('migrated')
        with self._lock:
            self._counts['migrated_out'] += 1
        w = time.time()
        self._trace_span(seq, 'eng.export', w, w, kind='cold')
        return payload

    def export_sequence(self, stream, timeout=30.0):
        """Snapshot one sequence into a ``mxnet_tpu.seqstate.v1`` payload
        and retire it here: its stream finishes ``'migrated'`` (no error;
        the importer continues it). A queued sequence exports ``cold``; a
        live one ``paged`` or ``slot``, gathered on the worker at the
        next tick boundary. Raises :class:`SeqStateError` for a finished
        or unknown stream (one completing on the CPU fallback among
        them), :class:`BatcherClosed` after :meth:`close`."""
        cold = None
        with self._lock:
            if self._closed:
                raise BatcherClosed('decode engine %r is closed' % self.name)
            for i, seq in enumerate(self._pending):
                if seq.stream is stream:
                    cold = self._pending.pop(i)
                    break
            rid = self._request_id_for_locked(stream)
        if cold is not None:
            return self._export_cold(cold, rid)
        spec = self._await_migration(
            'export', *self._submit_migration('export', stream), timeout)
        return _build(spec, stream)

    def export_all(self, timeout=30.0):
        """Export every sequence in flight (a drain): the queued ones
        ``cold``, the live ones at one tick boundary, so that the snapshot
        is of one moment. A sequence that finished before its export ran
        is skipped. Returns the payloads, the queued ones first."""
        with self._lock:
            if self._closed:
                return []
            cold = [s for s in self._pending if not s.stream.done()]
            self._pending = []
            rids = [self._request_id_for_locked(s.stream) for s in cold]
            live = [s.stream for s in self._active.values()]
        payloads = [self._export_cold(seq, rid)
                    for seq, rid in zip(cold, rids)]
        queued = []
        for stream in live:
            try:
                queued.append((stream, self._submit_migration('export',
                                                              stream)))
            except BatcherClosed:
                break
        # every gather first, then the documents: a build holds the
        # interpreter lock for most of its time, and would slow the
        # worker's gathers down if they overlapped
        specs = []
        for stream, (box, ev) in queued:
            try:
                specs.append((stream, self._await_migration(
                    'export', box, ev, timeout)))
            except (SeqStateError, BatcherClosed):
                continue            # finished before its export ran
        return payloads + [_build(spec, stream) for stream, spec in specs]

    def _do_export(self, stream, stash=False):
        """The worker's half of an export: the rows gathered and copied
        to the host, the sequence retired (its stream finished
        ``'migrated'``). Returns the payload's fields; ``stash`` leaves
        them on the stream (``prefill_only``)."""
        with self._lock:
            found = None
            for slot, seq in self._active.items():
                if seq.stream is stream:
                    found = (slot, seq)
                    break
            rid = self._request_id_for_locked(stream)
        if found is None or stream.done():
            raise SeqStateError(
                'sequence is not live in this engine (finished with %r or '
                'never admitted)' % (stream.finish_reason,))
        slot, seq = found
        t0 = time.perf_counter()
        w0 = time.time()
        npages = 0
        spec = dict(prompt=seq.prompt, emitted=list(stream.tokens),
                    pos=seq.pos, last_token=seq.last_token,
                    max_new=seq.max_new, eos_id=seq.eos_id, request_id=rid,
                    adapter_id=seq.adapter_id,
                    sampling=self._sampling_of(seq))
        if self.paged:
            ps = self.program.page_size
            npages = pages_for(seq.pos, ps)
            entries = self.program.export_pages(
                self._cache, [int(p) for p in seq.table[:npages]])
            spec.update(kind='paged', page_size=ps,
                        entries={k: v[:seq.pos] for k, v in entries.items()})
        else:
            spec.update(kind='slot', entries=self.program.export_slot_state(
                self._cache, slot))
        stream.export_seconds = {'gather_s': time.perf_counter() - t0}
        if stash:
            # before the finish: the done event wakes a reader of seqstate
            with stream._seqstate_lock:
                stream._seqstate_spec = spec
        stream._finish('migrated')
        self._retire(slot, seq, 'migrated')
        with self._lock:
            self._counts['migrated_out'] += 1
            self._counts['handoff_pages'] += npages
        self._trace_span(seq, 'eng.export', w0, time.time(), pages=npages,
                         kind=spec['kind'])
        return spec

    def import_sequence(self, payload, timeout=30.0, trace=None):
        """Land an exported sequence in this engine and continue it with
        no prefill (``prefills`` unchanged): K/V rows re-chunked to this
        engine's page size and written into its pool, or the slot's rows
        into a free slot. Returns the continuation's
        :class:`GenerateStream`: ``tokens`` holds the whole sequence, the
        handed-off prefix included, and the iterator yields only the new
        tokens. A ``cold`` payload is an ordinary admission. ``trace``
        attaches the request's trace (``eng.import``, then the
        continuation's spans).

        Raises :class:`SeqStateError` for a torn, version-mismatched or
        incompatible payload (an adapter pinned into an engine without a
        pool, sampling into one without sampling args, a paged payload
        into a slot engine or the reverse, a sequence past ``max_len`` or
        ``max_pages``), :class:`BackpressureError` when no slot or no
        pages are free (everything given back), ``CircuitOpenError`` when
        the cache was lost and the breaker is open, :class:`BatcherClosed`
        after :meth:`close`."""
        state = decode_payload(payload)
        state['trace'] = trace
        if state['adapter_id'] is not None and self._adapters is None:
            raise SeqStateError('payload pins adapter %r but this engine '
                                'serves no adapter pool'
                                % (state['adapter_id'],))
        if state['sampling'] is not None and not self.sample_args:
            raise SeqStateError('payload carries sampling state but this '
                                'engine\'s programs have no sampling args')
        if state['kind'] == 'cold':
            samp = state['sampling'] or {}
            # never prefilled at the source: an ordinary admission, which
            # counts as a request, not in migrated_in
            return self.generate(
                state['prompt'], max_new_tokens=state['max_new'],
                eos_id=state['eos_id'], request_id=state['request_id'],
                adapter=state['adapter_id'],
                temperature=samp.get('temperature', 0.0),
                top_p=samp.get('top_p', 1.0), seed=samp.get('seed', 0),
                trace=trace)
        if state['kind'] == 'paged' and not self.paged:
            raise SeqStateError('paged seqstate cannot land in a slot-cache '
                                'engine')
        if state['kind'] == 'slot' and self.paged:
            raise SeqStateError('slot seqstate cannot land in a paged engine')
        if state['pos'] + 1 >= self.program.max_len:
            raise SeqStateError('sequence at pos=%d does not fit this engine '
                                '(max_len=%d)' % (state['pos'],
                                                  self.program.max_len))
        if self.paged and pages_for(state['pos'] + 1,
                                    self.program.page_size) \
                > self.program.max_pages:
            raise SeqStateError('sequence needs more pages than this engine '
                                'maps a sequence (max_pages=%d)'
                                % self.program.max_pages)
        return self._await_migration(
            'import', *self._submit_migration('import', state), timeout)

    def _do_import(self, state):
        """The worker's half of an import: a slot, the adapter pinned
        again, the rows written, the sequence live."""
        w0 = time.time()
        prompt, emitted, pos = state['prompt'], state['emitted'], state['pos']
        with self._lock:
            if not self._free:
                raise BackpressureError(len(self._pending), self.max_queue)
            slot = self._free.pop(0)
        ids, aidx = [], 0
        try:
            if state['adapter_id'] is not None:
                # the same adapter before any write: a warm row is a
                # refcount, a cold one is written into the pool
                try:
                    aidx = self._adapters.acquire(state['adapter_id'])
                except BackpressureError:
                    raise
                except Exception as exc:
                    raise SeqStateError('cannot re-pin adapter %r at import: '
                                        '%s' % (state['adapter_id'], exc))
            try:
                self._ensure_cache()
            except _DegradedPath:
                raise CircuitOpenError(
                    'decode engine %r lost its cache and its breaker is '
                    'open: no import until a rebuild succeeds' % self.name)
            if self.paged:
                ps = self.program.page_size
                ids = self._alloc_pages(pages_for(pos, ps)) or []
                if not ids:
                    with self._lock:
                        self._counts['pool_exhausted'] += 1
                        depth = len(self._pending)
                    raise BackpressureError(depth, self.max_queue)
                # the rows are free of page geometry: pad the tail page with
                # zeros (the pool's initial state, masked until overwritten)
                rows = {}
                for name, arr in state['arrays'].items():
                    pad = onp.zeros((len(ids) * ps - pos,) + arr.shape[1:],
                                    arr.dtype)
                    rows[name] = onp.concatenate([arr, pad], axis=0)
                try:
                    self._cache = self.program.import_pages(self._cache,
                                                            rows, ids)
                except ValueError as exc:
                    raise SeqStateError('seqstate incompatible with this '
                                        'engine: %s' % (exc,))
            else:
                try:
                    self._cache = self.program.import_slot_state(
                        self._cache, state['arrays'], slot)
                except ValueError as exc:
                    raise SeqStateError('seqstate incompatible with this '
                                        'engine: %s' % (exc,))
        except BaseException:
            with self._lock:
                if self._allocator is not None:
                    for p in ids:
                        self._allocator.release(p)
                self._free.append(slot)
            if aidx:
                self._adapters.release(aidx)
            raise
        now = time.monotonic()
        stream = GenerateStream(len(prompt))
        # the source streamed these: the full list stays (budgets, done
        # lines), the iterator yields the continuation only
        stream.tokens = list(emitted)
        samp = state['sampling'] or {}
        seq = _Seq(stream, prompt, state['max_new'], state['eos_id'], now,
                   now + self.timeout_s if self.timeout_s else None,
                   adapter_id=state['adapter_id'],
                   temperature=samp.get('temperature', 0.0),
                   top_p=samp.get('top_p', 1.0), seed=samp.get('seed', 0))
        seq.adapter_idx = aidx
        seq.slot = slot
        seq.pos = pos
        seq.last_token = state['last_token']
        if self.paged:
            seq.table = onp.full(self.program.max_pages, TRASH_PAGE, 'int32')
            seq.table[:len(ids)] = ids
            seq.pages = list(ids)
            if self._prefix is not None and pos >= len(prompt):
                # later prompts sharing it hit, as after an admission
                with self._lock:
                    self._prefix.register(prompt, ids,
                                          namespace=seq.adapter_id)
            if self._draft is not None:
                # re-sync the draft from the fed context; a failure (a
                # context past its top bucket among them) only lowers
                # acceptance: every emitted token is the target's
                try:
                    self._draft_cache, _t, _l = self._draft.run_prefill(
                        self._draft_cache,
                        onp.asarray((prompt + emitted)[:pos], 'int32'), slot)
                except Exception:
                    logging.warning('decode %s: draft re-sync failed on '
                                    'import; speculation accepts less',
                                    self.name, exc_info=True)
        if state['trace'] is not None:
            w1 = time.time()
            seq.trace = {'ctx': state['trace'], 'enq': w0, 'last': w1,
                         'first_w': w1 if emitted else None,
                         'tok0': len(emitted)}
            self._trace_span(seq, 'eng.import', w0, w1, pages=len(ids),
                             kind=state['kind'], tokens=len(emitted))
        with self._lock:
            self._counts['requests'] += 1
            self._counts['migrated_in'] += 1
            self._counts['handoff_pages'] += len(ids)
            superseded = self._note_request_locked(state['request_id'],
                                                   stream)
            self._active[slot] = seq
        if superseded is not None and not superseded.done():
            superseded.cancel()
        return stream

    # -- degraded completion -----------------------------------------------

    def _fallback_stop(self, seq):
        """True when a degraded completion ends before its next token:
        its stream is done (a close that does not drain), the client
        cancelled it, or its budget ran out (the reaper watches the batch
        and the fallback queue, not the completion in progress)."""
        stream = seq.stream
        if stream.done():
            return True
        if stream._cancelled:
            stream._finish('cancelled')
            return True
        if seq.deadline_at is not None \
                and time.monotonic() >= seq.deadline_at:
            with self._lock:
                self._counts['timeouts'] += 1
            stream._finish('error', RequestTimeout(
                'generation exceeded its %.3fs budget on the CPU fallback '
                '(%d tokens emitted)' % (self.timeout_s, len(stream.tokens))))
            return True
        return False

    def _fallback_complete(self, seq):
        """Finish one sequence, from wherever it got to, on the CPU
        fallback: the same math and the same emission rule (the argmax,
        or the ``(seed, position)``-keyed sampler, the adapter's delta
        applied on the host), so the same tokens, streamed as they
        decode."""
        if self._fallback_stop(seq):
            return
        stream = seq.stream
        stream.degraded = True
        remaining = seq.max_new - len(stream.tokens)
        room = self.program.max_len - (len(seq.prompt)
                                       + len(stream.tokens)) - 1
        remaining = min(remaining, max(0, room) + 1)

        def on_token(tok):
            if self._fallback_stop(seq):
                return False
            with self._lock:
                self._counts['fallback_tokens'] += 1
                self._counts['tokens'] += 1
            self._emit_token(seq, tok)
            if seq.eos_id is not None and tok == seq.eos_id:
                stream._finish('eos')
                return False
            return True

        try:
            ad = None
            if self._adapters is not None and seq.adapter_id is not None:
                ad = self._adapters.host_tree(seq.adapter_id)
            self.program.fallback_generate(
                seq.prompt + stream.tokens, remaining, seq.eos_id,
                temperature=seq.temperature, top_p=seq.top_p,
                seed=seq.seed, ad=ad, on_token=on_token)
        except Exception as exc:     # the fallback itself failed: typed
            stream._finish('error', exc)
            return
        stream._finish('length')     # unless it ended already

    def _spawn_fallback(self, seqs):
        """Queue degraded completions for the fallback worker, started at
        the first trip. The CPU fallback decodes eagerly at tens of ms a
        token at full width on torch's whole intra-op pool, so one worker
        completes the sequences in turn, off the scheduler, which keeps
        serving on the card meanwhile. The worker reads no CUDA tensor."""
        with self._lock:
            closed = self._fallback_exit
            if not closed:
                self._fallback_q.extend(seqs)
                self._fallback_cv.notify()
            start = not closed and self._fallback_worker is None
            if start:
                self._fallback_worker = threading.Thread(
                    target=self._fallback_loop, daemon=True,
                    name='mxnet-tpu-torch-%s-fallback' % self.name)
        if closed:
            # close() gave up on the scheduler mid-call: no worker is left
            # to complete these
            for seq in seqs:
                seq.stream._finish('closed', BatcherClosed(
                    'decode engine closed'))
            return
        if not start:
            return
        try:
            self._fallback_worker.start()
        except Exception as exc:     # never leave a stream waiting
            with self._lock:
                doomed = list(self._fallback_q)
                self._fallback_q.clear()
                self._fallback_worker = None
            for seq in doomed:
                seq.stream._finish('error', exc)
            raise

    def _fallback_loop(self):
        """The fallback worker: one queued sequence at a time, until
        :meth:`close` lets it go with the queue empty."""
        while True:
            with self._lock:
                while not self._fallback_q and not self._fallback_exit:
                    self._fallback_cv.wait()
                if not self._fallback_q:
                    return
                seq = self._fallback_seq = self._fallback_q.popleft()
            try:
                self._fallback_complete(seq)
            except Exception as exc:    # never leave a stream waiting
                logging.exception('decode %s: degraded completion failed',
                                  self.name)
                seq.stream._finish('error', exc)
            finally:
                with self._lock:
                    self._fallback_seq = None

    def _degrade_inflight(self, active):
        """A transient fault or an open breaker mid-decode: every
        in-flight sequence retires (its pages and adapter pin released)
        and completes degraded on the CPU fallback; the cache is rebuilt
        for the card's next calls. The completion is spawned whatever the
        rebuild does, so no stream is stranded."""
        try:
            for slot, seq in active.items():
                self._retire(slot, seq, 'degraded')
            self._reset_cache()
        finally:
            self._spawn_fallback(list(active.values()))

    # -- introspection and shutdown ----------------------------------------

    def _note_step_locked(self, dt):
        """Count a step's seconds and fold them into the recent step
        latency that :meth:`retry_after_hint` reads (under the lock)."""
        self._counts['step_seconds'] += dt
        self._ema_step_s = dt if self._ema_step_s is None \
            else 0.7 * self._ema_step_s + 0.3 * dt

    def retry_after_hint(self):
        """Estimated seconds until a newly admitted generation could get a
        slot: the pending requests ahead (and this one) times a
        sequence's service time (the default budget times the recent step
        latency, 0.02 s before the first step) over the slots; at least
        0.05. The ``Retry-After`` of an HTTP 429 (the reference's,
        ``engine.py:2081``)."""
        with self._lock:
            pending = len(self._pending)
            est = self._ema_step_s
        if est is None:
            est = 0.02
        per_seq = est * max(1, self.default_max_new)
        return max(0.05, (pending + 1) * per_seq / float(max(1, self.slots)))

    def cache_accounting(self):
        """The cache's device bytes and what a sequence holds of them: for
        a paged program the pool's real residency, the pool's occupancy
        and the bytes the live sequences hold each (one page when idle,
        what a new sequence costs at least); for a slot program its
        slots x max_len rows, the worst case for every sequence."""
        prog = self.program
        out = {'paged': self.paged, 'cache_bytes': int(prog.cache_bytes())}
        per_seq = getattr(prog, 'per_sequence_bytes', None)
        amort = out['per_sequence_bytes_max'] = \
            int(per_seq()) if callable(per_seq) else None
        if self.paged:
            with self._lock:
                out['pool'] = self._allocator.stats()
                live = len(self._active)
                live_pages = sum(len(s.pages)
                                 for s in self._active.values())
            pb = out['page_bytes'] = int(prog.page_bytes())
            amort = live_pages * pb // live if live else pb
        out['per_sequence_bytes_amortized'] = amort
        if amort:
            out['max_concurrent_sequences_per_gb'] = (1 << 30) // amort
        return out

    def stats(self):
        with self._lock:
            out = {
                'pending': len(self._pending),
                'active': len(self._active),
                'free_slots': len(self._free),
                'slots': self.slots,
                'closed': self._closed,
                'paged': self.paged,
                'degraded': self._health.degraded,
                'breaker': self._breaker.state,
                'error': self._health.error,
                'counts': {k: (dict(v) if isinstance(v, dict) else v)
                           for k, v in self._counts.items()},
            }
            if self._allocator is not None:
                out['pages'] = self._allocator.stats()
                if self._prefix is not None:
                    out['pages']['prefix_entries'] = len(self._prefix)
            if self._draft is not None:
                proposed = self._counts['spec_proposed']
                out['spec'] = {
                    'k': self.spec_k, 'proposed': proposed,
                    'accepted': self._counts['spec_accepted'],
                    'acceptance_rate': round(
                        self._counts['spec_accepted'] / proposed, 4)
                    if proposed else None}
        if self._adapters is not None:
            out['adapters'] = self._adapters.pool.stats()
        out['cache_bytes'] = int(self.program.cache_bytes())
        out['cache'] = self.cache_accounting()
        return out

    def close(self, drain=True, timeout=30.0):
        """Stop admissions; ``drain=True`` lets in-flight AND queued
        generations finish, the degraded completions on the CPU among
        them, ``drain=False`` fails them with :class:`BatcherClosed`. A
        drain is bounded by ``timeout``: the streams left then fail with
        :class:`DrainTimeout`."""
        with self._lock:
            self._closed = True
            if not drain:
                for seq in self._pending:
                    seq.stream._finish('closed', BatcherClosed(
                        'decode engine closed'))
                self._pending = []
                for seq in self._active.values():
                    seq.stream._finish('closed', BatcherClosed(
                        'decode engine closed'))
            self._wake.notify_all()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending and not self._active:
                    break
            time.sleep(0.01)
        leftovers = []
        with self._lock:
            if drain and (self._pending or self._active):
                leftovers = list(self._pending) + list(
                    self._active.values())
                self._pending = []
                for slot, seq in list(self._active.items()):
                    del self._active[slot]
                    self._free.append(slot)
                    self._release_pages_locked(seq)
                self._counts['drain_timeouts'] += len(leftovers)
            # migrations the worker will never service now
            orphans = list(self._migrations)
            self._migrations = []
        for _op, _arg, box, ev in orphans:
            box['error'] = BatcherClosed(
                'decode engine %r closed before the migration was serviced'
                % self.name)
            ev.set()
        for seq in leftovers:
            self._release_adapter(seq)
            seq.stream._finish('error', DrainTimeout(
                'stream unfinished after the %.1fs drain budget '
                '(%d tokens emitted)' % (timeout, len(seq.stream.tokens))))
        self._worker.join(max(0.1, deadline - time.monotonic()))
        # degraded completions run on the fallback worker: a drain waits
        # for them within the same budget; what is left then ends typed
        with self._lock:
            self._fallback_exit = True
            self._fallback_cv.notify_all()
            worker = self._fallback_worker
        if drain and worker is not None:
            worker.join(max(0.1, deadline - time.monotonic()))
        with self._lock:
            left = [s for s in list(self._fallback_q) + [self._fallback_seq]
                    if s is not None and not s.stream.done()]
            self._fallback_q.clear()
            if drain:
                self._counts['drain_timeouts'] += len(left)
        for seq in left:
            if not drain:
                seq.stream._finish('closed', BatcherClosed(
                    'decode engine closed'))
                continue
            seq.stream._finish('error', DrainTimeout(
                'degraded stream unfinished after the %.1fs drain budget '
                '(%d tokens emitted)' % (timeout, len(seq.stream.tokens))))
        if self._reaper is not None:
            self._reaper.join(1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
