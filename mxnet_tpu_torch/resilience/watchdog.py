"""Stall watchdog, the port of ``mxnet_tpu/resilience/watchdog.py``:
detect a device call that stopped making progress.

A hung call blocks inside the runtime with no exception and no progress.
The watchdog makes the stall a structured, budgeted event:

  * callers :meth:`Watchdog.beat` at every call boundary, phase-tagged
    (``compile`` gets a much larger budget than ``step``);
  * :meth:`Watchdog.check` compares the heartbeat's age with the current
    phase's budget (the ``MXNET_TPU_WATCHDOG_*_S`` knobs); a breach
    writes the stall artifact (``mxnet_tpu.stall.v1``: phase, step,
    waited and budget seconds, a stack of every live thread) and raises
    :class:`~.policy.TunnelStallError`, which :func:`~.policy.is_transient`
    takes as transient, so the serving paths complete the work degraded;
  * :meth:`Watchdog.start` runs the same check on a daemon thread, for a
    caller blocked inside the runtime: the thread cannot raise into it,
    so it writes the artifact, logs and calls ``on_stall``.

The scripted fault kind ``hang`` (``MXNET_TPU_FAULT=hang@serving.decode.3:1``)
makes :meth:`beat` at step 3 age the heartbeat past the budget instead of
refreshing it, so detection, artifact and escalation run with an
untouched wall clock.

Two differences from the reference, both for a serving path that can sit
idle: :meth:`Watchdog.idle` disarms the heartbeat after a call returns, so
only a call in flight can stall (the reference's heartbeat ages between
calls too); and the artifact is written only where ``artifact_path``
says (the reference defaults to ``STALL.json`` in the working directory):
without one the record stays in ``last_record`` and the log.

One lock, ``self._lock``, guards only the heartbeat, phase and step
fields; the injector, the ``on_stall`` callback, the artifact write and
the telemetry run outside it, on copies taken under it.

Telemetry, the reference's (``watchdog.py:172-200, 232-247``): a beat
records ``watchdog_heartbeat`` (step, phase) and sets
``mxnet_tpu_watchdog_heartbeat_age_seconds`` to 0, a check sets it to the
heartbeat's age, and a stall records ``stall`` (phase, step, waited and
budget seconds) and dumps the flight ring (reason ``stall``), after the
artifact is written: telemetry never hides the stall. Under the idle rule
above, :meth:`Watchdog.idle` sets the gauge to 0 too, so an idle path
reads 0 and only an armed heartbeat ages.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback

from .. import config as _config
from ..observability import emit as _emit
from ..observability import metrics as _metrics
from ..observability import trainer_instruments
from .checkpoint import atomic_write_bytes
from .policy import HangError, TunnelStallError, inject

__all__ = ['STALL_SCHEMA', 'Watchdog', 'stall_record']

STALL_SCHEMA = 'mxnet_tpu.stall.v1'

# phase -> the knob of its default stall budget (seconds)
_BUDGET_KNOBS = {
    'compile': 'MXNET_TPU_WATCHDOG_COMPILE_S',
    'step': 'MXNET_TPU_WATCHDOG_STEP_S',
    'collective': 'MXNET_TPU_WATCHDOG_COLLECTIVE_S',
}


def _thread_stacks():
    """One formatted stack a live thread."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for ident, frame in sys._current_frames().items():
        stacks[names.get(ident, 'thread-%d' % ident)] = \
            ''.join(traceback.format_stack(frame))
    return stacks


def stall_record(phase, step, waited_s, budget_s, name='train'):
    """The stall artifact's payload (schema ``mxnet_tpu.stall.v1``; every
    key always present)."""
    return {
        'schema': STALL_SCHEMA,
        'name': name,
        'phase': phase,
        'step': None if step is None else int(step),
        'waited_s': round(float(waited_s), 3),
        'budget_s': round(float(budget_s), 3),
        'pid': os.getpid(),
        'thread_stacks': _thread_stacks(),
    }


def _set_age(seconds):
    """``mxnet_tpu_watchdog_heartbeat_age_seconds`` (a telemetry emit:
    never raises)."""
    if not _metrics.enabled():
        return
    try:
        trainer_instruments().heartbeat_age.set(seconds)
    except Exception:
        pass


class Watchdog:
    """Heartbeat-against-budget stall detector.

    ``budgets`` overrides the per-phase stall budgets (seconds); the
    defaults come from the ``MXNET_TPU_WATCHDOG_*_S`` knobs. ``clock``
    is injectable, so the budget math runs under a fake clock. ``site``
    is the fault-injection site :meth:`beat` fires at
    (``serving.infer`` for a one-shot session, ``serving.decode`` for a
    decode engine).
    """

    def __init__(self, budgets=None, artifact_path=None, name='train',
                 clock=time.monotonic, injector=None, on_stall=None,
                 poll_s=None, site='train.step'):
        self.budgets = {ph: float(_config.get(knob))
                        for ph, knob in _BUDGET_KNOBS.items()}
        self.budgets.update(budgets or {})
        self.site = site
        self.artifact_path = artifact_path     # None: no file
        self.name = name
        self._clock = clock
        self._injector = injector
        self._on_stall = on_stall
        self._poll_s = poll_s
        self._lock = threading.Lock()
        self._phase = 'compile'     # the first beat covers the first build
        self._step = None
        self._last = None           # None: not armed yet
        self._stop = threading.Event()
        self._thread = None
        self.last_record = None

    # -- heartbeat ---------------------------------------------------------

    def budget_for(self, phase):
        return float(self.budgets.get(phase,
                                      self.budgets.get('step', 300.0)))

    def beat(self, step=None, phase=None):
        """Refresh the heartbeat at a call boundary.

        A scripted ``hang`` fault for this site and step does the
        opposite: it ages the heartbeat one full budget into the past, a
        call that stopped making progress, so the next :meth:`check` (or
        the monitor thread) takes the real detection path.
        """
        now = self._clock()
        # the injector runs outside the lock; its verdict is folded in
        hang = False
        try:
            inject(self.site, ('hang',), injector=self._injector,
                   step=step)
        except HangError:
            hang = True
        with self._lock:
            if phase is not None:
                self._phase = phase
            cur_phase = self._phase
            self._step = step
            self._last = (now - self.budget_for(cur_phase) - 1.0) \
                if hang else now
        if not hang:
            self._telemetry_beat(step, cur_phase)

    def idle(self):
        """Disarm the heartbeat after a call returns: nothing is in
        flight, so nothing can stall until the next :meth:`beat`, and the
        age gauge reads 0."""
        with self._lock:
            self._last = None
        _set_age(0.0)

    @staticmethod
    def _telemetry_beat(step, phase):
        """The age gauge back to 0 and a heartbeat event, so a dump after
        a stall shows where the beats stopped. ``phase`` is the caller's
        copy taken under the lock."""
        if _metrics.enabled():
            _set_age(0.0)
            _emit.event('watchdog_heartbeat', step=step, phase=phase)

    def phase(self, phase):
        """Switch phase (``compile`` / ``step`` / ``collective``, or a
        serving phase) and refresh the heartbeat under its budget."""
        with self._lock:
            step = self._step
        self.beat(step=step, phase=phase)

    # -- detection ---------------------------------------------------------

    def stalled(self):
        """(waited_s, budget_s, phase, step) when the heartbeat is older
        than the phase's budget, else None."""
        with self._lock:
            if self._last is None:
                return None
            waited = self._clock() - self._last
            budget = self.budget_for(self._phase)
            phase, step = self._phase, self._step
        _set_age(waited)
        if waited <= budget:
            return None
        return waited, budget, phase, step

    def check(self):
        """Raise :class:`TunnelStallError` (after writing the stall
        artifact) when the current phase overran its budget; no-op
        otherwise. Callers run it right after the blocking call a
        :meth:`beat` preceded."""
        hit = self.stalled()
        if hit is None:
            return
        waited, budget, phase, step = hit
        self._emit(waited, budget, phase, step)
        raise TunnelStallError(
            'tunnel_stall', 'watchdog',
            'watchdog: %s phase stalled %.1fs (budget %.1fs) at step '
            '%s — stall artifact at %s'
            % (phase, waited, budget, step, self.artifact_path or 'none'))

    def _emit(self, waited, budget, phase, step):
        self.last_record = stall_record(phase, step, waited, budget,
                                        name=self.name)
        if self.artifact_path:
            try:
                atomic_write_bytes(
                    self.artifact_path,
                    (json.dumps(self.last_record, indent=1, sort_keys=True)
                     + '\n').encode())
            except OSError as exc:   # diagnostics must not mask the stall
                logging.error('watchdog: could not write stall artifact '
                              '%s: %s', self.artifact_path, exc)
        # the stall lands in the flight ring, then the ring dumps: the
        # last events of the run beside the stall record
        _emit.event('stall', phase=phase,
                    step=None if step is None else int(step),
                    waited_s=round(float(waited), 3),
                    budget_s=round(float(budget), 3))
        _emit.dump('stall')
        logging.error('watchdog: %s phase stalled %.1fs (budget %.1fs) '
                      'at step %s; artifact: %s', phase, waited, budget,
                      step, self.artifact_path)

    # -- background monitor ------------------------------------------------

    def start(self):
        """Run the stall check on a daemon thread (for callers blocked
        inside the runtime). The thread cannot raise into the blocked
        caller: it writes the artifact, logs, calls ``on_stall(record)``
        once a stall, and keeps watching (a later beat re-arms it)."""
        if self._thread is not None:
            return self
        poll = self._poll_s if self._poll_s is not None \
            else float(_config.get('MXNET_TPU_WATCHDOG_POLL_S'))
        self._stop.clear()

        def monitor():
            fired_at = None
            while not self._stop.wait(poll):
                hit = self.stalled()
                if hit is None:
                    fired_at = None
                    continue
                waited, budget, phase, step = hit
                with self._lock:
                    beat_id = self._last
                if fired_at == beat_id:
                    continue          # one artifact a distinct stall
                fired_at = beat_id
                self._emit(waited, budget, phase, step)
                if self._on_stall is not None:
                    try:
                        self._on_stall(self.last_record)
                    except Exception:
                        logging.exception('watchdog on_stall callback '
                                          'failed')

        self._thread = threading.Thread(target=monitor, daemon=True,
                                        name='mxnet-tpu-torch-watchdog')
        self._thread.start()
        return self

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
