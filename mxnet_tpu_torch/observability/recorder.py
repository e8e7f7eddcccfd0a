"""FlightRecorder: a crash-surviving ring of structured events, the port
of ``mxnet_tpu/observability/recorder.py``, whole.

A post-mortem of a stalled or reclaimed replica otherwise starts from the
log alone. The recorder keeps the last N events of the serving and
resilience paths (admissions, rejections, page allocation and eviction,
prefix hits, retirements, exports and imports, breaker trips, fallbacks,
watchdog heartbeats, stalls, drains, preemption) in a bounded in-memory
ring, and dumps them as a ``mxnet_tpu.flight.v1`` artifact the moment
something escalates:

  * a watchdog stall (``resilience/watchdog.py`` ``_emit``),
  * a breaker that just opened (``serving/health.py`` ``failed``),
  * a preemption exit (``resilience/preempt.py`` ``exit``),
  * an uncaught exception (optional :func:`install_excepthook`),
  * or an explicit :meth:`FlightRecorder.dump`.

Artifact format, the reference's byte for byte: JSON Lines. Line 1 is the
header::

    {"capacity": N, "dropped": D, "dumped_at": ..., "events": kept,
     "name": ..., "pid": ..., "process_count": ..., "process_id": ...,
     "reason": "stall", "recorded": total, "schema": "mxnet_tpu.flight.v1"}

followed by one JSON object an event, oldest first (keys sorted)::

    {"kind": "stall", "mono": ..., "process_id": 0, "ts": <unix s>, ...}

so a torn tail (a dump raced by the OOM killer) still leaves every
complete line parseable. Dumps go through the resilience layer's atomic
write. With more than one process (the launcher's ``DMLC_*``
environment), each rank dumps to its own file: ``FLIGHT.jsonl`` becomes
``FLIGHT.r1.jsonl``.

Overhead: :meth:`FlightRecorder.record` on a disabled recorder is one flag
read and allocates nothing; enabled, it is one dict and a deque append
(the deque bounds memory; no I/O until a dump). Stdlib only.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque

from . import metrics as _metrics
from . import trace as _trace
from .metrics import _process_info

__all__ = ['FLIGHT_SCHEMA', 'FlightRecorder', 'get_recorder',
           'record_event', 'flight_dump', 'configure_flight',
           'install_excepthook', 'uninstall_excepthook', 'read_flight']

FLIGHT_SCHEMA = 'mxnet_tpu.flight.v1'
_DEFAULT_CAPACITY = 2048


def _knob(name, default):
    try:
        from ..config import get as _cfg
        v = _cfg(name)
        return default if v is None else v
    except Exception:
        return default


def _rank_suffixed(path, process_id, process_count):
    """FLIGHT.jsonl -> FLIGHT.r1.jsonl when more than one process can dump:
    two ranks never write one file. A single process keeps the path."""
    if process_count <= 1:
        return path
    root, ext = os.path.splitext(path)
    return '%s.r%d%s' % (root, process_id, ext)


class FlightRecorder:
    """Bounded ring of structured events with atomic JSONL dumps."""

    def __init__(self, capacity=None, path=None, clock=time.time,
                 name='train'):
        if capacity is None:
            capacity = int(_knob('MXNET_TPU_FLIGHT_CAPACITY',
                                 _DEFAULT_CAPACITY))
        self.capacity = max(1, int(capacity))
        self.path = path
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._ring = deque(maxlen=self.capacity)
        self._recorded = 0
        self._dumps = 0
        self._enabled = None     # None: resolved from the knob at first use

    # -- enable plumbing ---------------------------------------------------

    @property
    def enabled(self):
        if not _metrics.enabled():
            return False         # the master switch wins
        if self._enabled is None:
            self._enabled = bool(_knob('MXNET_TPU_FLIGHT', True))
        return self._enabled

    def set_enabled(self, value):
        self._enabled = None if value is None else bool(value)

    # -- recording ---------------------------------------------------------

    def record(self, kind, **fields):
        """Append one event; the oldest drops when the ring is full. Each
        event is stamped with the writing ``process_id``, a ``mono``
        monotonic time (the order on one host survives a wall-clock
        step) and, when a request's trace context is bound to this
        thread, its ``trace_id``."""
        if not self.enabled:
            return
        ev = {'ts': round(self._clock(), 6),
              'mono': round(time.monotonic(), 6), 'kind': kind,
              'process_id': _process_info()[0]}
        tid = _trace.current_trace_id()
        if tid is not None and 'trace_id' not in fields:
            ev['trace_id'] = tid
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)
            self._recorded += 1

    def events(self):
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._recorded = 0

    def stats(self):
        with self._lock:
            kept = len(self._ring)
            return {'capacity': self.capacity, 'recorded': self._recorded,
                    'kept': kept, 'dropped': self._recorded - kept,
                    'dumps': self._dumps}

    # -- dumping -----------------------------------------------------------

    def dump(self, path=None, reason='manual'):
        """Write the ring as a ``mxnet_tpu.flight.v1`` JSONL artifact.

        Never raises: a dump runs inside the crash, stall, breaker and
        preemption paths, where a second failure must not hide the first.
        Returns the path written, or None (also when the recorder is
        disabled: a disabled run leaves no artifact)."""
        if not self.enabled:
            return None
        path = path or self.path or \
            str(_knob('MXNET_TPU_FLIGHT_PATH', 'FLIGHT.jsonl'))
        proc_id, proc_count = _process_info()
        path = _rank_suffixed(path, proc_id, proc_count)
        with self._lock:
            events = list(self._ring)
            recorded = self._recorded
        header = {
            'schema': FLIGHT_SCHEMA,
            'name': self.name,
            'reason': reason,
            'pid': os.getpid(),
            'process_id': proc_id,
            'process_count': proc_count,
            'dumped_at': round(self._clock(), 6),
            'capacity': self.capacity,
            'recorded': recorded,
            'dropped': recorded - len(events),
            'events': len(events),
        }
        lines = [json.dumps(header, sort_keys=True)]
        lines.extend(json.dumps(ev, sort_keys=True, default=str)
                     for ev in events)
        payload = ('\n'.join(lines) + '\n').encode()
        try:
            from ..resilience.checkpoint import atomic_write_bytes
            atomic_write_bytes(path, payload)
            with self._lock:
                self._dumps += 1
            return path
        except OSError as exc:
            logging.error('flight recorder: could not write %s: %s',
                          path, exc)
            return None


def read_flight(path):
    """Parse a flight artifact back into ``(header, events)``; raises
    ValueError when the header is not a valid v1 header. An incomplete
    last line (a torn dump) is skipped."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError('%s: empty flight artifact' % path)
    header = json.loads(lines[0])
    if header.get('schema') != FLIGHT_SCHEMA:
        raise ValueError('%s: schema %r != %r'
                         % (path, header.get('schema'), FLIGHT_SCHEMA))
    events = []
    for ln in lines[1:]:
        try:
            events.append(json.loads(ln))
        except ValueError:
            continue      # a torn tail line
    return header, events


_default_recorder = FlightRecorder()


def get_recorder():
    return _default_recorder


def record_event(kind, **fields):
    """Record one event on the process's recorder."""
    _default_recorder.record(kind, **fields)


def flight_dump(path=None, reason='manual'):
    return _default_recorder.dump(path=path, reason=reason)


def configure_flight(path=None, capacity=None, name=None, enabled=None):
    """Point the process's recorder at a dump path, resize its ring,
    rename it or switch it (None leaves a field as it is)."""
    rec = _default_recorder
    if path is not None:
        rec.path = path
    if name is not None:
        rec.name = name
    if capacity is not None:
        capacity = max(1, int(capacity))
        if capacity != rec.capacity:
            with rec._lock:
                rec.capacity = capacity
                rec._ring = deque(rec._ring, maxlen=capacity)
    if enabled is not None:
        rec.set_enabled(enabled)
    return rec


_prev_excepthook = None


def install_excepthook():
    """Dump the ring on any uncaught exception (reason ``crash``), then
    chain the previous hook. Idempotent."""
    global _prev_excepthook
    if _prev_excepthook is not None:
        return
    _prev_excepthook = sys.excepthook

    def _hook(exc_type, exc, tb):
        if not issubclass(exc_type, (SystemExit, KeyboardInterrupt)):
            _default_recorder.record('crash', error='%s: %s'
                                     % (exc_type.__name__, exc))
            _default_recorder.dump(reason='crash')
        _prev_excepthook(exc_type, exc, tb)

    sys.excepthook = _hook


def uninstall_excepthook():
    global _prev_excepthook
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
