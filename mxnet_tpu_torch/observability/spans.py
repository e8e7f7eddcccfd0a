"""Step-phase spans, the port of ``mxnet_tpu/observability/spans.py``:
data-wait / step / sync / checkpoint / compile.

Attribution of step time is the visibility problem: a slow run looks the
same from outside whether the input pipeline starves the card, the step
regressed, or checkpointing blocks the loop. A span times one phase of
one step and lands the duration in the ``mxnet_tpu_phase_seconds``
histogram family (labelled by phase), so a run's phase split is readable
from any exporter with no trace tooling.

When the port's profiler runs (``mxnet_tpu_torch/profiler.py``), the same
span also opens a ``profiler.scope('phase:<name>')``, which itself
forwards to ``torch.profiler.record_function``: the phases appear in the
chrome trace and in the torch device trace under the same names. When a
request-trace context is bound to the thread (``trace.activate``), the
span lands in the trace buffer too.

Telemetry off, profiler idle and no trace context: a span is two flag
reads and allocates nothing.
"""
from __future__ import annotations

import time

from .. import profiler as _profiler
from . import metrics as _metrics
from . import trace as _trace

__all__ = ['PHASES', 'span', 'phase_histogram']

PHASES = ('data_wait', 'step', 'sync', 'checkpoint', 'compile')

_hist_family = None
_children = {}


def phase_histogram(phase):
    """The histogram child for one phase (cached; hot paths hold it)."""
    global _hist_family
    child = _children.get(phase)
    if child is None:
        if _hist_family is None:
            _hist_family = _metrics.histogram(
                'mxnet_tpu_phase_seconds',
                help='wall seconds per step phase', labels=('phase',))
        child = _hist_family.labels(phase=phase)
        _children[phase] = child
    return child


class span:
    """Context manager timing one phase occurrence::

        with span('data_wait'):
            batch = next(feed)

    Records into the phase histogram when telemetry is on, into the
    profiler (chrome trace and torch trace) while it runs, and into the
    request-trace span buffer when a trace context is bound to this
    thread; nothing otherwise."""

    __slots__ = ('phase', '_t0', '_w0', '_prof')

    def __init__(self, phase):
        self.phase = phase
        self._t0 = None
        self._w0 = None
        self._prof = None

    def __enter__(self):
        prof_running = _profiler.is_running()
        tracing = _trace.current() is not None
        if not _metrics.enabled() and not prof_running and not tracing:
            return self
        self._t0 = time.perf_counter()
        if tracing:
            self._w0 = time.time()
        if prof_running:
            self._prof = _profiler.scope('phase:%s' % self.phase)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof = None
        if _metrics.enabled():
            phase_histogram(self.phase).observe(
                time.perf_counter() - self._t0)
        if self._w0 is not None:
            _trace.emit_phase(self.phase, self._w0, time.time())
            self._w0 = None
        self._t0 = None
