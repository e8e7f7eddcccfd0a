"""The health record a serving path keeps beside its circuit breaker:
whether it is degraded and the last error, as ``status()`` /
``stats()`` report them. The decode engine and the one-shot session
each own one.

A failed device call marks the path degraded with the error's text (the
breaker already counted it, through ``breaker.call``); a stall the
watchdog's monitor saw, or a failure outside a breaker call (a cache
rebuild), also counts a breaker failure; the next device call that
succeeds clears the record.

The trip's telemetry is the reference's, emitted here for both paths
(the reference's ``DecodeEngine._note_failure`` and
``InferenceSession._note_failure``): ``mxnet_tpu_serve_degraded`` reads 1
while degraded and 0 after a success; a failure that just opened the
breaker counts ``mxnet_tpu_serve_breaker_trips_total``, records
``breaker_open`` and dumps the flight ring (reason ``breaker``), any
other failure records ``serve_fallback``. The warning and the record are
written first: telemetry never hides the failure.
"""
from __future__ import annotations

import logging
import threading

from ..observability import emit as _emit

__all__ = ['Health']


class Health:
    """``degraded`` / ``error`` of one serving path (``label`` names it in
    the warnings), guarded by a lock of its own."""

    def __init__(self, breaker, label):
        self.breaker = breaker
        self.label = label
        self._lock = threading.Lock()
        self._error = None           # None: healthy

    @property
    def error(self):
        with self._lock:
            return self._error

    @property
    def degraded(self):
        return self.error is not None

    def _set(self, error):
        with self._lock:
            self._error = error

    def failed(self, exc, what, was_open, step=None):
        """A device call ``what`` (the path's op or batch index ``step``)
        raised ``exc`` inside ``breaker.call``: degraded, with a warning
        that names the error and the breaker's state."""
        error = '%s: %s' % (type(exc).__name__, exc)
        self._set(error)
        state = self.breaker.state
        newly_open = state != 'closed' and not was_open
        logging.warning('%s: %s failed (%s); breaker %s%s', self.label,
                        what, error, state,
                        ', just opened' if newly_open else '')
        inst = _emit.serving()
        if inst is not None:
            inst.degraded.set(1.0)
            if newly_open:
                inst.breaker_trips.inc()
        if newly_open:
            # the trip lands in the ring, then the ring dumps: the
            # post-mortem sees the requests that led up to it
            _emit.event('breaker_open', step=step, error=error)
            _emit.dump('breaker')
        else:
            _emit.event('serve_fallback', step=step, error=error)

    def lost(self, what, exc):
        """A failure outside a breaker call (a cache rebuild): counted by
        the breaker, degraded, warned."""
        self.breaker.record_failure()
        error = '%s: %s: %s' % (what, type(exc).__name__, exc)
        self._set(error)
        logging.warning('%s: %s; breaker %s', self.label, error,
                        self.breaker.state)
        self._gauge(1.0)

    def stalled(self, record):
        """The watchdog monitor's escalation: a device call overran its
        budget with the caller still inside it."""
        self._set('stall: %s phase stalled %.1fs (budget %.1fs)'
                  % (record.get('phase'), record.get('waited_s', 0.0),
                     record.get('budget_s', 0.0)))
        self.breaker.record_failure()
        self._gauge(1.0)

    def recovered(self):
        self._set(None)
        self._gauge(0.0)

    @staticmethod
    def _gauge(value):
        inst = _emit.serving()
        if inst is not None:
            inst.degraded.set(value)
