"""Profiler: a chrome://tracing file of user scopes and the torch device
trace, the port of ``mxnet_tpu/profiler.py``.

The MXNet-shaped API of the reference (``set_config`` / ``set_state`` /
``dump`` / ``dumps``, ``Task`` / ``Frame`` / ``Event`` / ``Counter`` /
``Marker`` / ``scope``), over its in-process chrome trace of user scopes,
so that :func:`dump` always writes a chrome://tracing file. Where the
reference reaches for ``jax.profiler``, the port uses PyTorch's:

  * ``set_state('run')`` starts ``torch.profiler.profile`` (the CPU, and
    CUDA where a card is present) in place of
    ``jax.profiler.start_trace``;
  * ``set_state('stop')`` and ``dump(finished=True)`` end it and write its
    trace beside the chrome file, as ``<filename stem>_torch.json`` in
    place of the reference's ``<stem>_xplane`` directory;
  * :class:`scope` forwards to ``torch.profiler.record_function`` in place
    of ``jax.profiler.TraceAnnotation``, so a scope names its kernels in
    the device trace.

:class:`op_span` fences the device before its stop stamp while the
profiler runs, so a span covers execution and not only the launch. A
fence that fails raises: it is a device error, and the reference's
``except: pass`` around it would hide the device.

``MXNET_PROFILER_AUTOSTART`` (``mxnet_tpu_torch/config.py``) starts the
profiler when the package is imported. Nothing here imports torch until
a trace starts or a scope opens.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ['set_config', 'profiler_set_config', 'set_state',
           'profiler_set_state', 'dump', 'dumps', 'aggregate_stats',
           'pause', 'resume', 'record_op', 'is_running', 'op_span',
           'torch_trace_path', 'torch_session', 'Task', 'Frame', 'Event',
           'Counter', 'Marker', 'scope']

_config = {'filename': 'profile.json', 'profile_all': False,
           'profile_symbolic': True, 'profile_imperative': True,
           'profile_memory': False, 'profile_api': False,
           'aggregate_stats': False}
_state = {'running': False, 'torch': None}
_events = []
_lock = threading.Lock()


def set_config(**kwargs):
    """Configure the profiler (the reference's ``set_config``)."""
    _config.update(kwargs)


profiler_set_config = set_config


def torch_trace_path():
    """Where the torch trace of a run lands: ``<filename stem>_torch.json``
    beside the chrome file."""
    fname = _config.get('filename', 'profile.json')
    return os.path.splitext(fname)[0] + '_torch.json'


def set_state(state='stop', profile_process='worker'):
    """Start or stop profiling (the reference's ``set_state``). ``'run'``
    also starts ``torch.profiler.profile``; ``'stop'`` ends it and writes
    its trace to :func:`torch_trace_path`. A profiler that fails to start
    or to write raises."""
    if state == 'run':
        _state['running'] = True
        if _state['torch'] is None:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            _state['torch'] = prof
    elif state == 'stop':
        prof, _state['torch'] = _state['torch'], None
        _state['running'] = False
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(torch_trace_path())
    else:
        raise ValueError("state must be 'run' or 'stop'")


profiler_set_state = set_state


def torch_session():
    """The running ``torch.profiler.profile``, or None."""
    return _state['torch']


def pause(profile_process='worker'):
    _state['running'] = False


def resume(profile_process='worker'):
    _state['running'] = True


def _emit(ph, name, cat, ts, dur=None, args=None):
    ev = {'ph': ph, 'name': name, 'cat': cat, 'pid': os.getpid(),
          'tid': threading.get_ident(), 'ts': ts * 1e6}
    if dur is not None:
        ev['dur'] = dur * 1e6
    if args:
        ev['args'] = args
    with _lock:
        _events.append(ev)


def aggregate_stats(reset=False):
    """Per-scope aggregates ``{name: {category, count, total_ms, min_ms,
    max_ms, avg_ms}}`` from the event buffer (the reference's
    ``AggregateStats``)."""
    with _lock:
        table = {}
        for ev in _events:
            if ev['ph'] != 'X':
                continue
            dur = ev.get('dur', 0.0) / 1e3
            rec = table.get(ev['name'])
            if rec is None:
                table[ev['name']] = rec = {
                    'category': ev.get('cat', 'user'), 'count': 0,
                    'total_ms': 0.0, 'min_ms': dur, 'max_ms': dur}
            rec['count'] += 1
            rec['total_ms'] += dur
            rec['min_ms'] = min(rec['min_ms'], dur)
            rec['max_ms'] = max(rec['max_ms'], dur)
        for rec in table.values():
            rec['avg_ms'] = rec['total_ms'] / max(rec['count'], 1)
        if reset:
            _events.clear()
    return table


_SORT_KEYS = {'total': 'total_ms', 'avg': 'avg_ms', 'min': 'min_ms',
              'max': 'max_ms', 'count': 'count'}


def dumps(reset=False, format='table', sort_by='total', ascending=False):
    """Aggregate stats as a text table (or JSON with ``format='json'``),
    the reference's ``dumps`` with its sort options."""
    table = aggregate_stats(reset=reset)
    if format == 'json':
        return json.dumps(table, sort_keys=True)
    if sort_by not in _SORT_KEYS:
        raise ValueError('sort_by must be one of %s' % sorted(_SORT_KEYS))
    key = _SORT_KEYS[sort_by]
    rows = sorted(table.items(), key=lambda kv: kv[1][key],
                  reverse=not ascending)
    lines = ['%-40s %-10s %8s %12s %10s %10s %10s'
             % ('Name', 'Category', 'Calls', 'Total ms', 'Min ms',
                'Max ms', 'Avg ms')]
    for name, r in rows:
        lines.append('%-40s %-10s %8d %12.3f %10.3f %10.3f %10.3f'
                     % (name, r['category'], r['count'], r['total_ms'],
                        r['min_ms'], r['max_ms'], r['avg_ms']))
    return '\n'.join(lines)


def record_op(name, start, stop):
    """Record one operator span while the profiler runs (the reference's
    ``profile_imperative`` hook)."""
    if _state['running'] and _config.get('profile_imperative', True):
        _emit('X', name, 'operator', start, stop - start)


def is_running():
    return _state['running']


class op_span:
    """The dispatch paths' timing guard: nothing while the profiler is
    idle; while it runs, times the block and calls ``sync`` (a device
    fence) before the stop stamp, so the span covers the execution, not
    only the launch. ``sync`` raising propagates."""

    __slots__ = ('name', 'sync', '_t0')

    def __init__(self, name, sync=None):
        self.name, self.sync = name, sync

    def __enter__(self):
        self._t0 = time.perf_counter() if _state['running'] else None
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return
        if exc[0] is None and self.sync is not None:
            self.sync()
        record_op(self.name, self._t0, time.perf_counter())


def dump(finished=True, profile_process='worker'):
    """Write the chrome://tracing JSON (the reference's ``dump``).

    ``finished=True`` (the default) ends collection: profiling stops (the
    torch trace is written beside the file) and the events written leave
    the buffer, so a later ``dump(False)`` does not emit them again.
    ``finished=False`` writes a snapshot and keeps collecting."""
    fname = _config.get('filename', 'profile.json')
    with _lock:
        snapshot = list(_events)
    data = {'traceEvents': snapshot, 'displayTimeUnit': 'ms'}
    with open(fname, 'w') as f:
        json.dump(data, f)
    if finished:
        # only after a successful write, and exactly the events written:
        # appends that raced the write stay for the next dump
        with _lock:
            del _events[:len(snapshot)]
        if _state['running'] or _state['torch'] is not None:
            set_state('stop')
    return fname


class _Scoped:
    """Named profiling objects with start / stop."""

    _cat = 'user'

    def __init__(self, name):
        self.name = name
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is None:
            return
        now = time.perf_counter()
        _emit('X', self.name, self._cat, self._start, now - self._start)
        self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class Task(_Scoped):
    """Profile a task (the reference's ``Task``)."""
    _cat = 'task'

    def __init__(self, domain=None, name='task'):
        super().__init__(name)


class Frame(_Scoped):
    _cat = 'frame'

    def __init__(self, domain=None, name='frame'):
        super().__init__(name)


class Event(_Scoped):
    _cat = 'event'

    def __init__(self, name='event'):
        super().__init__(name)


class Counter:
    """A numeric counter in the trace (the reference's ``Counter``);
    ``increment`` / ``decrement`` are thread-safe (the read-modify-write
    under a lock of the counter's own)."""

    def __init__(self, domain=None, name='counter', value=0):
        self.name = name
        self._vlock = threading.Lock()
        self._value = value
        self.set_value(value)

    def set_value(self, value):
        with self._vlock:
            self._value = value
        _emit('C', self.name, 'counter', time.perf_counter(),
              args={'value': value})

    def increment(self, delta=1):
        with self._vlock:
            self._value = value = self._value + delta
        _emit('C', self.name, 'counter', time.perf_counter(),
              args={'value': value})
        return self     # the __iadd__ alias must rebind to the Counter

    def decrement(self, delta=1):
        return self.increment(-delta)

    __iadd__ = increment
    __isub__ = decrement


class Marker:
    """An instant marker (the reference's ``Marker``)."""

    def __init__(self, domain=None, name='marker'):
        self.name = name

    def mark(self, scope='process'):
        _emit('i', self.name, 'marker', time.perf_counter())


class scope(_Scoped):
    """Context manager annotating a region in the chrome trace, forwarded
    to ``torch.profiler.record_function`` so the region also names its
    kernels in the torch trace."""

    def __init__(self, name='scope'):
        super().__init__(name)
        self._fn = None

    def __enter__(self):
        super().__enter__()
        import torch
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self._fn is not None:
            self._fn.__exit__(*exc)
            self._fn = None
        super().__exit__(*exc)
