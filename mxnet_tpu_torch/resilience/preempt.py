"""Graceful preemption: a SIGTERM drain and a resumable exit, the port of
``mxnet_tpu/resilience/preempt.py``.

A fleet's usual interruption is a notice, not a crash: the resource
manager sends SIGTERM and reclaims the machine a grace period later. The
contract:

  1. :class:`PreemptionHandler` catches SIGTERM / SIGINT (chaining a
     handler installed before it) and records a stop *request*: nothing
     else happens in the signal frame;
  2. a driver polls :meth:`PreemptionHandler.check` at its boundaries (a
     serving endpoint's watcher thread, ``ServingHTTPServer
     .install_preempt_hook``); the first boundary after the signal drains
     (:meth:`PreemptionHandler.drain` runs a save under the
     ``MXNET_TPU_PREEMPT_GRACE_S`` budget);
  3. the process exits with the resumable code
     (``MXNET_TPU_PREEMPT_EXIT_CODE``, 75 = BSD EX_TEMPFAIL) by raising
     :class:`Preempted`, a ``SystemExit``: an undecorated process exits
     with that code, and a supervisor restarts it.

The scripted fault kind ``preempt`` fires through :meth:`check`'s site
(``MXNET_TPU_FAULT=preempt@train.step.12:1``), so the protocol runs on the
CPU with no real signal.

The flight recorder gets the reference's events: ``preempt`` (step,
reason) at the first boundary that sees the stop (recorded on the
polling thread, never in the signal frame) and ``preempt_exit`` (step,
checkpoint, reason, exit code) before :meth:`PreemptionHandler.exit` dumps
the ring (reason ``preempt``) and raises. The reference's ``drain`` also
calls ``record_event('checkpoint', kind='emergency', ...)``, which its
recorder's own ``kind`` parameter refuses (a TypeError its ``except``
swallows), so it records nothing there, and neither does the port. A serving endpoint drains
through its own watcher (``ServingHTTPServer.install_preempt_hook`` reads
``stop_requested``), as the reference's does, so it records the drain's
events instead. ``ParallelTrainer.attach_preemption`` polls it at every
step boundary and drains through the trainer's checkpoint manager
(``parallel/train_step.py``).
"""
from __future__ import annotations

import signal
import threading
import time
import warnings

from .. import config as _config
from ..observability import emit as _emit
from .policy import Deadline, PreemptionSignal, TimeoutExpired, inject

__all__ = ['Preempted', 'PreemptionHandler', 'resumable_exit_code']


def resumable_exit_code():
    """The exit code that marks a run as preempted but resumable (knob
    ``MXNET_TPU_PREEMPT_EXIT_CODE``, 75)."""
    return int(_config.get('MXNET_TPU_PREEMPT_EXIT_CODE'))


class Preempted(SystemExit):
    """Raised at a boundary after a preemption drain. A ``SystemExit``:
    uncaught, the process exits with the resumable code and no traceback.
    Carries ``step``, ``checkpoint`` (what the drain's save returned, or
    None) and ``reason`` (the signal's name or the injected fault)."""

    def __init__(self, code, step=None, checkpoint=None, reason=None):
        super().__init__(code)
        self.step = step
        self.checkpoint = checkpoint
        self.reason = reason

    def __str__(self):
        return ('preempted at step %s (%s); emergency checkpoint: %s; '
                'exiting with resumable rc %s'
                % (self.step, self.reason, self.checkpoint, self.code))


class PreemptionHandler:
    """The graceful stop of one process::

        handler = PreemptionHandler().install()      # or: with ...:
        for step in range(n):
            if handler.check(step):                  # a boundary
                handler.drain(lambda: save(step))
                handler.exit(step)                   # raises Preempted
            work()

    The signal only sets a flag; everything else happens at the next
    boundary, on the driver's thread."""

    def __init__(self, signals=None, exit_code=None, grace_s=None,
                 injector=None, clock=time.monotonic):
        self.signals = tuple(signals) if signals is not None \
            else (signal.SIGTERM, signal.SIGINT)
        self._explicit_exit_code = exit_code
        self._grace_s = grace_s
        self._injector = injector
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = False
        self.reason = None
        self.checkpoint_path = None
        self._announced = False
        self._previous = {}
        self._installed = False

    # -- signal plumbing ---------------------------------------------------

    @property
    def exit_code(self):
        return self._explicit_exit_code if self._explicit_exit_code \
            is not None else resumable_exit_code()

    @property
    def grace_s(self):
        if self._grace_s is not None:
            return float(self._grace_s)
        return float(_config.get('MXNET_TPU_PREEMPT_GRACE_S'))

    def install(self):
        """Register the signal handlers. Only the main thread can: from
        another, nothing is registered, and the injected and explicit
        stops still work."""
        if self._installed:
            return self
        try:
            for sig in self.signals:
                self._previous[sig] = signal.signal(sig, self._on_signal)
            self._installed = True
        except ValueError:
            self._previous = {}
        return self

    def uninstall(self):
        for sig, old in self._previous.items():
            try:
                signal.signal(sig, old)
            except (ValueError, TypeError):
                pass
        self._previous = {}
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def _on_signal(self, signum, frame):
        self.request_stop('signal %s' % signal.Signals(signum).name)
        prev = self._previous.get(signum)
        # chain a Python handler installed before this one; the default
        # and ignore dispositions are replaced, not called
        if callable(prev) and prev not in (signal.SIG_DFL, signal.SIG_IGN):
            prev(signum, frame)

    # -- the driver's protocol ---------------------------------------------

    @property
    def stop_requested(self):
        return self._stop

    def request_stop(self, reason='requested'):
        """Ask for a stop at the next boundary (safe from a signal frame
        and any thread: one flag)."""
        with self._lock:
            if not self._stop:
                self._stop = True
                self.reason = reason

    def check(self, step=None, site='train.step'):
        """A boundary's poll: fires a scripted ``preempt`` fault of
        ``site`` / ``step``, then reports whether a stop is pending."""
        try:
            inject(site, ('preempt',), injector=self._injector, step=step)
        except PreemptionSignal as sig:
            self.request_stop(str(sig))
        if self._stop and not self._announced:
            # recorded here, on the polling thread: the signal frame
            # never takes the recorder's lock
            self._announced = True
            _emit.event('preempt', step=step, reason=self.reason)
        return self._stop

    def drain(self, save):
        """Run ``save()`` (its result recorded as ``checkpoint_path``)
        under the grace budget. A save that overruns the budget is
        warned about, not raised: on a real preemption the machine would
        have gone mid-write, and the atomic write leaves the last complete
        checkpoint."""
        deadline = Deadline(self.grace_s, clock=self._clock)
        try:
            self.checkpoint_path = save()
            deadline.check('preemption drain')
        except TimeoutExpired:
            warnings.warn(
                'preemption drain overran the %.1fs grace budget '
                '(MXNET_TPU_PREEMPT_GRACE_S): on a real preemption this '
                'checkpoint would have been lost; shrink the checkpoint or '
                'raise the grace budget' % self.grace_s)
        return self.checkpoint_path

    def exit(self, step=None):
        """Raise :class:`Preempted` with the resumable exit code, after
        the flight ring is dumped (reason ``preempt``)."""
        _emit.event('preempt_exit', step=step, checkpoint=self.checkpoint_path,
                    reason=self.reason or 'preempted',
                    exit_code=self.exit_code)
        _emit.dump('preempt')
        raise Preempted(self.exit_code, step=step,
                        checkpoint=self.checkpoint_path,
                        reason=self.reason or 'preempted')
