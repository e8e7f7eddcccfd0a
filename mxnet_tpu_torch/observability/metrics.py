"""Lock-cheap metrics registry: labelled Counters / Gauges / Histograms,
the port of ``mxnet_tpu/observability/metrics.py``, whole.

Design constraints, in order:

  1. *Near-zero overhead when disabled*: every mutator starts with one
     attribute read of a shared flag object and returns: no lock, no
     allocation, no string formatting.
  2. *Thread-safe when enabled*: one small lock per metric child.
  3. *Fixed memory*: histograms use fixed power-of-two buckets indexed
     by ``math.frexp``: O(1) observe, no per-sample allocation, and the
     same bucket layout in every process (and in the reference), so
     artifacts merge.

Stdlib only; the enable flag resolves lazily from ``MXNET_TPU_TELEMETRY``
(``mxnet_tpu_torch/config.py``, on by default).
"""
from __future__ import annotations

import math
import os
import threading

__all__ = ['Counter', 'Gauge', 'Histogram', 'MetricsRegistry',
           'get_registry', 'counter', 'gauge', 'histogram', 'enabled',
           'set_enabled', 'snapshot', 'reset']


class _State:
    """Shared enable flag; a plain attribute so the disabled fast path
    is a single LOAD_ATTR."""

    __slots__ = ('enabled',)

    def __init__(self):
        self.enabled = None      # None = resolve from config on first use


_state = _State()


def _resolve_enabled():
    try:
        from ..config import get as _cfg
        _state.enabled = bool(_cfg('MXNET_TPU_TELEMETRY'))
    except Exception:       # config not importable (early bootstrap)
        _state.enabled = True
    return _state.enabled


def enabled():
    """Master telemetry switch (``MXNET_TPU_TELEMETRY``; overridable at
    runtime with :func:`set_enabled`). Hot paths call this before
    building any event payload."""
    e = _state.enabled
    if e is None:
        return _resolve_enabled()
    return e


def set_enabled(value):
    """Runtime override of the master switch (the bench A/B toggles
    this around its timed windows). ``None`` re-resolves from config."""
    _state.enabled = None if value is None else bool(value)
    return _state.enabled


class _Child:
    """One (metric, label-values) time series."""

    __slots__ = ('_lock', '_value')

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self):
        return self._value


class Counter(_Child):
    """Monotonically increasing count."""

    __slots__ = ()

    def inc(self, amount=1.0):
        if not _state.enabled and not enabled():
            return
        if amount < 0:
            raise ValueError('counters only go up (inc(%r))' % amount)
        with self._lock:
            self._value += amount


class Gauge(_Child):
    """Point-in-time value."""

    __slots__ = ()

    def set(self, value):
        if not _state.enabled and not enabled():
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        if not _state.enabled and not enabled():
            return
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)


# power-of-two bucket exponents: 2^-17 (~7.6 us) .. 2^9 (512); one
# fixed layout for every histogram so cross-run artifacts line up
_EMIN = -17
_EMAX = 9
P2_BOUNDS = tuple(2.0 ** e for e in range(_EMIN, _EMAX + 1))


class Histogram:
    """Fixed power-of-two-bucket histogram (``le`` bounds
    :data:`P2_BOUNDS` plus +Inf). ``observe`` is O(1): the bucket index
    comes from ``math.frexp``, not a bisect."""

    __slots__ = ('_lock', '_buckets', '_sum', '_count')

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets = [0] * (len(P2_BOUNDS) + 1)   # +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        if not _state.enabled and not enabled():
            return
        v = float(value)
        if v <= P2_BOUNDS[0]:
            idx = 0
        else:
            # frexp: v = m * 2^e with m in [0.5, 1)  =>  v in (2^(e-1), 2^e]
            e = math.frexp(v)[1]
            if v == 2.0 ** (e - 1):    # exact power of two: lower bucket
                e -= 1
            idx = min(e - _EMIN, len(P2_BOUNDS))
            if idx < 0:
                idx = 0
        with self._lock:
            self._buckets[idx] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def buckets(self):
        """Cumulative (Prometheus-style) counts per ``le`` bound,
        ending with the +Inf bucket == count."""
        return self.read()[2]

    def read(self):
        """One consistent ``(count, sum, cumulative_buckets)`` under a
        single lock acquisition — exporters use this so a concurrent
        observe() cannot skew +Inf-bucket vs _count in one scrape."""
        with self._lock:
            raw = list(self._buckets)
            count, total = self._count, self._sum
        out, acc = [], 0
        for n in raw:
            acc += n
            out.append(acc)
        return count, total, out


_TYPES = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}


class _Family:
    """One named metric with a fixed label schema; children are cached
    per label-value tuple (hold the child in hot paths)."""

    __slots__ = ('name', 'type', 'help', 'label_names', '_children',
                 '_lock', '_default_child')

    def __init__(self, name, typ, help='', labels=()):
        self.name = name
        self.type = typ
        self.help = help
        self.label_names = tuple(labels)
        self._children = {}
        self._lock = threading.Lock()
        # unlabeled families get their single child eagerly so the
        # module-level conveniences delegate with zero allocation (the
        # child's own flag check handles the disabled path)
        self._default_child = None if self.label_names \
            else self._children.setdefault((), _TYPES[typ]())

    def labels(self, **kv):
        if tuple(sorted(kv)) != tuple(sorted(self.label_names)):
            raise ValueError(
                'metric %s has labels %r, got %r'
                % (self.name, self.label_names, tuple(sorted(kv))))
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key,
                                                  _TYPES[self.type]())
        return child

    def _default(self):
        if self._default_child is None:
            raise ValueError('metric %s is labeled (%r); use .labels()'
                             % (self.name, self.label_names))
        return self._default_child

    # unlabeled conveniences so `registry.counter('x').inc()` works;
    # allocation-free when disabled (the child checks the flag)
    def inc(self, amount=1.0):
        self._default().inc(amount)

    def set(self, value):
        self._default().set(value)

    def dec(self, amount=1.0):
        self._default().dec(amount)

    def observe(self, value):
        self._default().observe(value)

    @property
    def value(self):
        return self._default().value

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum

    def buckets(self):
        return self._default().buckets()

    def series(self):
        """[(label_values_tuple, child)] sorted for stable export."""
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Process-wide table of metric families.

    Re-declaring a name returns the existing family (idempotent — the
    instrumented modules can be imported in any order) but a type or
    label-schema mismatch is a hard error: two writers disagreeing on
    what ``x_total`` means is a bug, not a merge."""

    def __init__(self):
        self._families = {}
        self._lock = threading.Lock()

    def _declare(self, name, typ, help, labels):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != typ or fam.label_names != tuple(labels):
                    raise ValueError(
                        'metric %s re-declared as %s%r (was %s%r)'
                        % (name, typ, tuple(labels), fam.type,
                           fam.label_names))
                return fam
            fam = _Family(name, typ, help=help, labels=labels)
            self._families[name] = fam
            return fam

    def counter(self, name, help='', labels=()):
        return self._declare(name, 'counter', help, labels)

    def gauge(self, name, help='', labels=()):
        return self._declare(name, 'gauge', help, labels)

    def histogram(self, name, help='', labels=()):
        return self._declare(name, 'histogram', help, labels)

    def families(self):
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def snapshot(self):
        """Plain-data dump of every series: the bench/status-JSON and
        JSONL exporters serialize this directly.

        Every snapshot is stamped with a synthetic
        ``mxnet_tpu_process`` gauge (labels ``process_id`` /
        ``process_count``, value 1) so multi-host artifacts merge
        without guessing which rank wrote them. The stamp is shaped
        exactly like a real family, so exporters need no special
        casing — it renders as
        ``mxnet_tpu_process{process_id="0",process_count="2"} 1``."""
        out = {'mxnet_tpu_process': _process_family()}
        for fam in self.families():
            series = []
            for values, child in fam.series():
                labels = dict(zip(fam.label_names, values))
                if fam.type == 'histogram':
                    count, total, buckets = child.read()
                    series.append({'labels': labels,
                                   'count': count,
                                   'sum': total,
                                   'buckets': buckets,
                                   'le': list(P2_BOUNDS) + ['+Inf']})
                else:
                    series.append({'labels': labels,
                                   'value': child.value})
            out[fam.name] = {'type': fam.type, 'help': fam.help,
                             'series': series}
        return out

    def reset(self):
        """Zero every series IN PLACE (tests / selftest isolation).

        Families and children survive so instrument handles cached by
        hot paths (trainer/kv/dispatch bags, span histograms) stay
        wired to the registry — dropping families would silently orphan
        them and exporters would report no activity forever after."""
        for fam in self.families():
            for _, child in fam.series():
                if isinstance(child, Histogram):
                    with child._lock:
                        child._buckets = [0] * len(child._buckets)
                        child._sum = 0.0
                        child._count = 0
                else:
                    with child._lock:
                        child._value = 0.0


_proc_info_cache = None


def _launcher_info():
    """(worker_id, num_workers) from the launcher's environment (the
    reference's ``_dist_init._env_request``: ``DMLC_ROLE`` absent or
    ``worker``, ``DMLC_PS_ROOT_URI`` set and ``DMLC_NUM_WORKER`` > 1),
    else (0, 1)."""
    if os.environ.get('DMLC_ROLE') not in (None, '', 'worker'):
        return (0, 1)
    try:
        nworker = int(os.environ.get('DMLC_NUM_WORKER', '1'))
        wid = int(os.environ.get('DMLC_WORKER_ID', '0'))
    except ValueError:
        return (0, 1)
    if not os.environ.get('DMLC_PS_ROOT_URI') or nworker <= 1:
        return (0, 1)
    return (wid, nworker)


def _process_info():
    """(process_id, process_count) from the launcher's environment,
    cached after the first read (identity cannot change after import)."""
    global _proc_info_cache
    if _proc_info_cache is None:
        _proc_info_cache = _launcher_info()
    return _proc_info_cache


def _process_family():
    pid, count = _process_info()
    return {'type': 'gauge',
            'help': 'process identity stamp (process_id/process_count '
                    'labels; docs/DISTRIBUTED.md)',
            'series': [{'labels': {'process_id': str(pid),
                                   'process_count': str(count)},
                        'value': 1.0}]}


_default_registry = MetricsRegistry()


def get_registry():
    return _default_registry


def counter(name, help='', labels=()):
    return _default_registry.counter(name, help=help, labels=labels)


def gauge(name, help='', labels=()):
    return _default_registry.gauge(name, help=help, labels=labels)


def histogram(name, help='', labels=()):
    return _default_registry.histogram(name, help=help, labels=labels)


def snapshot():
    return _default_registry.snapshot()


def reset():
    _default_registry.reset()
