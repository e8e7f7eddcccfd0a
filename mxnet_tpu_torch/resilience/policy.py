"""Fault-handling policies and the scripted fault injector, the port of
``mxnet_tpu/resilience/policy.py``.

Everything takes injectable ``clock`` / ``sleep`` / ``rng`` hooks, so the
backoff math runs under a fake clock with no real sleeping. The injector
is the deterministic stand-in for faults a test cannot produce on demand
(a lost card, a stalled call, a crashed worker), so the recovery paths
run in the tests instead of first in production.

One rule is the port's own: a kernel that fails to build or to launch
(:class:`~mxnet_tpu_torch.ops.kernels.errors.KernelError`) is never
transient, whatever its message holds, so such a failure is never
completed on the CPU. Apart from it :func:`is_transient` keeps the
reference's rule and markers.
"""
from __future__ import annotations

import random
import threading
import time

from .. import config as _config
from ..ops.kernels.errors import KernelError

__all__ = ['ResilienceError', 'RetryExhausted', 'TimeoutExpired',
           'CircuitOpenError', 'InjectedFault', 'DeviceUnavailableError',
           'TunnelStallError', 'WorkerCrashError', 'PreemptionSignal',
           'HangError', 'DeviceLossError', 'is_transient',
           'Retry', 'Timeout', 'Deadline', 'CircuitBreaker',
           'FaultInjector', 'get_injector', 'inject', 'poison']


class ResilienceError(RuntimeError):
    """Base for errors raised by the resilience layer itself."""


class RetryExhausted(ResilienceError):
    """All retry attempts failed; ``last_error`` holds the final cause."""

    def __init__(self, message, attempts=0, last_error=None, elapsed=0.0):
        super().__init__(message)
        self.attempts = attempts
        self.last_error = last_error
        self.elapsed = elapsed


class TimeoutExpired(ResilienceError):
    """A wall-clock budget ran out."""


class CircuitOpenError(ResilienceError):
    """The circuit breaker is open: calls are refused without trying."""


class InjectedFault(RuntimeError):
    """A scripted fault from the :class:`FaultInjector`.

    ``no_backoff`` marks the fault as deterministic: retry policies skip
    the backoff sleep for it, so fault-injected runs finish in seconds.
    """

    no_backoff = True

    def __init__(self, kind, site, message=None):
        super().__init__(message or 'injected fault %r at site %r'
                         % (kind, site))
        self.kind = kind
        self.site = site


class DeviceUnavailableError(InjectedFault):
    """Scripted analog of a backend that cannot be reached
    (``UNAVAILABLE``)."""


class TunnelStallError(InjectedFault):
    """Scripted analog of a call that overran its deadline
    (``DEADLINE_EXCEEDED``); also what the stall watchdog raises."""


class WorkerCrashError(InjectedFault):
    """Scripted analog of a worker dying mid-batch."""


class PreemptionSignal(InjectedFault):
    """Scripted analog of a SIGTERM preemption notice from the resource
    manager."""


class HangError(InjectedFault):
    """Scripted analog of a call that never returns. Consumed by
    ``Watchdog.beat``: the heartbeat goes stale, so the stall detection
    path runs without real waiting."""


class DeviceLossError(InjectedFault):
    """Scripted analog of a device lost mid-run."""


# Substrings that mark an error as transient infrastructure trouble
# (retry-worthy) rather than a deterministic bug: the reference's list.
_TRANSIENT_MARKERS = ('UNAVAILABLE', 'DEADLINE_EXCEEDED', 'INTERNAL',
                      'remote_compile', 'Connection reset',
                      'Socket closed', 'failed to connect',
                      'tunnel', 'Unable to initialize backend')


def is_transient(exc):
    """True when ``exc`` looks like transient infrastructure failure. A
    kernel's build or launch failure never does, before any marker is
    read (an nvcc or cuBLAS message may carry ``INTERNAL``)."""
    if isinstance(exc, KernelError):
        return False
    if isinstance(exc, InjectedFault):
        return True
    if isinstance(exc, (ConnectionError, TimeoutError, TimeoutExpired)):
        return True
    msg = str(exc)
    return any(marker in msg for marker in _TRANSIENT_MARKERS)


class Retry:
    """Exponential backoff with jitter, capped per delay and by an
    optional total deadline.

    delay(k) = min(max_delay, base_delay * multiplier**(k - 1)) * (1 + U(-j, j))

    ``predicate`` decides which exceptions are retried (default:
    :func:`is_transient`); anything else propagates at once. When every
    attempt fails, raises :class:`RetryExhausted` carrying the attempt
    count and the last cause.
    """

    def __init__(self, max_attempts=5, base_delay=1.0, multiplier=2.0,
                 max_delay=60.0, jitter=0.1, deadline=None,
                 predicate=is_transient, retry_on=(Exception,),
                 sleep=time.sleep, clock=time.monotonic, rng=None,
                 on_retry=None):
        if max_attempts < 1:
            raise ValueError('max_attempts must be >= 1')
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.predicate = predicate
        self.retry_on = retry_on
        self._sleep = sleep
        self._clock = clock
        self._rng = rng or random.Random()
        self._on_retry = on_retry

    def delay(self, attempt):
        """Backoff before retry number ``attempt`` (1-based), jittered."""
        raw = min(self.max_delay,
                  self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            raw *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, raw)

    def call(self, fn, *args, **kwargs):
        start = self._clock()
        last = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as exc:  # noqa: PERF203 - retry loop
                if not self.predicate(exc):
                    raise
                last = exc
                if attempt == self.max_attempts:
                    break
                pause = 0.0 if getattr(exc, 'no_backoff', False) \
                    else self.delay(attempt)
                elapsed = self._clock() - start
                if self.deadline is not None and \
                        elapsed + pause >= self.deadline:
                    break  # no budget for another attempt
                if self._on_retry is not None:
                    self._on_retry(attempt, exc, pause)
                if pause:
                    self._sleep(pause)
        raise RetryExhausted(
            'gave up after %d attempt(s) in %.1fs; last error: %s: %s'
            % (attempt, self._clock() - start,
               type(last).__name__, last),
            attempts=attempt, last_error=last,
            elapsed=self._clock() - start)

    def __call__(self, fn):
        """Decorator form: ``@Retry(...)``."""
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        wrapped.__name__ = getattr(fn, '__name__', 'retried')
        return wrapped


class Deadline:
    """Cooperative wall-clock budget: cheap to check, clock-injectable."""

    def __init__(self, seconds, clock=time.monotonic):
        self.seconds = float(seconds)
        self._clock = clock
        self._start = clock()

    def elapsed(self):
        return self._clock() - self._start

    def remaining(self):
        return self.seconds - self.elapsed()

    def expired(self):
        return self.remaining() <= 0.0

    def check(self, label=''):
        """Raise :class:`TimeoutExpired` once the budget is spent."""
        if self.expired():
            raise TimeoutExpired(
                'deadline of %.1fs expired after %.1fs%s'
                % (self.seconds, self.elapsed(),
                   (' (%s)' % label) if label else ''))


class Timeout:
    """Wall-clock budget for a blocking callable.

    ``run`` executes the callable on a daemon thread and raises
    :class:`TimeoutExpired` when the budget lapses. The thread cannot be
    killed, so the callable may still be running after the raise: the
    caller treats the resource it holds as poisoned.
    """

    def __init__(self, seconds, clock=time.monotonic):
        self.seconds = float(seconds)
        self._clock = clock

    def deadline(self):
        return Deadline(self.seconds, clock=self._clock)

    def run(self, fn, *args, **kwargs):
        box = {}

        def target():
            try:
                box['result'] = fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 - relayed below
                box['error'] = exc

        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join(self.seconds)
        if t.is_alive():
            raise TimeoutExpired('call exceeded %.1fs budget'
                                 % self.seconds)
        if 'error' in box:
            raise box['error']
        return box.get('result')


class CircuitBreaker:
    """Stop hammering a failing dependency: after ``failure_threshold``
    consecutive failures the circuit opens and calls raise
    :class:`CircuitOpenError` without running. After ``reset_timeout``
    one probe call is let through (half-open); success closes the
    circuit, failure re-opens it.
    """

    def __init__(self, failure_threshold=5, reset_timeout=30.0,
                 clock=time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at = None

    @property
    def state(self):
        with self._lock:
            if self._opened_at is None:
                return 'closed'
            if self._clock() - self._opened_at >= self.reset_timeout:
                return 'half-open'
            return 'open'

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._opened_at = None

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._opened_at = self._clock()

    def call(self, fn, *args, **kwargs):
        with self._lock:
            # snapshot under the lock: a concurrent record_success may
            # clear _opened_at between the state check and the message
            failures, opened_at = self._failures, self._opened_at
        if opened_at is not None and \
                self._clock() - opened_at < self.reset_timeout:
            raise CircuitOpenError(
                'circuit open after %d consecutive failures; retry in '
                '%.1fs' % (failures, self.reset_timeout -
                           (self._clock() - opened_at)))
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result


# ---------------------------------------------------------------------------
# Scripted fault injection
# ---------------------------------------------------------------------------

_FAULT_CLASSES = {
    'device_unavailable': DeviceUnavailableError,
    'tunnel_stall': TunnelStallError,
    'worker_crash': WorkerCrashError,
    'preempt': PreemptionSignal,
    'hang': HangError,
    'device_loss': DeviceLossError,
}

# Value faults: instead of raising, these corrupt a tensor with the
# scripted non-finite value (``nan@grads:2`` poisons two steps' worth).
# Consumed through :meth:`FaultInjector.poison`, never :meth:`fire`.
_VALUE_FAULTS = {
    'nan': float('nan'),
    'inf': float('inf'),
}

# the reference's messages, word for word: is_transient reads them
_FAULT_MESSAGES = {
    'device_unavailable': "injected: Unable to initialize backend "
                          "'tpu': UNAVAILABLE: tunnel down",
    'tunnel_stall': 'injected: DEADLINE_EXCEEDED: device tunnel stalled',
    'worker_crash': 'injected: dataloader worker crashed mid-batch',
    'preempt': 'injected: SIGTERM preemption notice from the resource '
               'manager',
    'hang': 'injected: compiled step stopped heartbeating (hung '
            'collective)',
    'device_loss': 'injected: restart came back with fewer devices',
}


class _FaultEntry:
    __slots__ = ('kind', 'site', 'remaining')

    def __init__(self, kind, site=None, count=-1):
        self.kind = kind
        self.site = site          # None = any site honoring the kind
        self.remaining = count    # -1 = fire forever


class FaultInjector:
    """Deterministically raises scripted faults at named sites.

    Spec grammar (also the ``MXNET_TPU_FAULT`` value): a comma list of
    ``kind[@site][:count]`` --

      device_unavailable                every matching site, forever
      device_unavailable:2              the first two firings only
      worker_crash@serving:1            one crash at one site
      device_loss@serving.decode.12:1   one firing at op 12 only

    Sites pass the fault kinds they honor to :meth:`fire`; an entry
    matches when its kind is honored there and its site (if given)
    equals the site name. Counts are consumed in spec order.

    Step-qualified sites: a per-step site passes its step (the decode
    engine its device op index) to :meth:`fire`, which then also matches
    entries scripted against ``<site>.<step>``.
    """

    def __init__(self, spec=''):
        self.spec = spec or ''
        self._lock = threading.Lock()
        self._entries = []
        for raw in self.spec.split(','):
            raw = raw.strip()
            if not raw:
                continue
            count = -1
            if ':' in raw:
                raw, _, cnt = raw.rpartition(':')
                try:
                    count = int(cnt)
                except ValueError:
                    raise ValueError('bad fault count in %r' % self.spec)
            kind, _, site = raw.partition('@')
            if kind not in _FAULT_CLASSES and kind not in _VALUE_FAULTS:
                raise ValueError(
                    'unknown fault kind %r (known: %s)'
                    % (kind, ', '.join(sorted(_FAULT_CLASSES) +
                                       sorted(_VALUE_FAULTS))))
            self._entries.append(_FaultEntry(kind, site or None, count))

    def __bool__(self):
        return bool(self._entries)

    @staticmethod
    def _site_names(site, step):
        if step is None:
            return (site,)
        return (site, '%s.%d' % (site, step))

    def pending(self, site, kinds, step=None):
        """True if :meth:`fire` would raise at ``site`` (no consume)."""
        with self._lock:
            return self._match(self._site_names(site, step),
                               kinds) is not None

    def _match(self, sites, kinds):
        for entry in self._entries:
            if entry.remaining == 0:
                continue
            if entry.kind not in kinds:
                continue
            if entry.site is not None and entry.site not in sites:
                continue
            return entry
        return None

    def fire(self, site, kinds, step=None):
        """Raise the first scripted fault matching ``site`` / ``kinds``,
        consuming one firing; no-op when nothing matches. ``step``
        also matches ``<site>.<step>``-qualified entries."""
        with self._lock:
            entry = self._match(self._site_names(site, step), kinds)
            if entry is None:
                return
            if entry.remaining > 0:
                entry.remaining -= 1
        raise _FAULT_CLASSES[entry.kind](
            entry.kind, site, _FAULT_MESSAGES[entry.kind])

    def poison(self, site, kinds=('nan', 'inf')):
        """Consume one scripted value fault (``nan`` / ``inf``) at
        ``site`` and return the float to fold into a tensor there; 0.0
        when nothing is scripted. Never raises."""
        with self._lock:
            entry = self._match((site,), kinds)
            if entry is None:
                return 0.0
            if entry.remaining > 0:
                entry.remaining -= 1
        return _VALUE_FAULTS[entry.kind]


_ENV_KNOB = 'MXNET_TPU_FAULT'
_injector_cache = ('', FaultInjector(''))
_injector_lock = threading.Lock()


def get_injector():
    """The process-global injector scripted by ``MXNET_TPU_FAULT`` (read
    through the port's ``config.get``). Re-parsed whenever the value
    changes; firing counts persist while it stays the same."""
    spec = _config.get(_ENV_KNOB) or ''
    global _injector_cache
    with _injector_lock:
        cached_spec, cached = _injector_cache
        if cached_spec != spec:
            cached = FaultInjector(spec)
            _injector_cache = (spec, cached)
        return cached


def inject(site, kinds, injector=None, step=None):
    """Fire the (given or knob-scripted) injector at ``site`` for the
    fault ``kinds`` that site honors."""
    inj = injector if injector is not None else get_injector()
    if inj:
        inj.fire(site, kinds, step=step)


def poison(site, kinds=('nan', 'inf'), injector=None):
    """The value fault scripted at ``site`` (``nan`` / ``inf``), or 0.0
    when none is pending."""
    inj = injector if injector is not None else get_injector()
    return inj.poison(site, kinds) if inj else 0.0
