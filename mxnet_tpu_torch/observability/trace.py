"""Request-scoped distributed tracing, the port of
``mxnet_tpu/observability/trace.py``, whole.

A request that crosses gateway -> prefill replica -> seqstate handoff
-> decode replica leaves fragments in N processes. This module gives
those fragments one identity: a propagated trace context
(trace_id / span_id / parent_id) carried hop to hop in a
W3C-traceparent-shaped ``X-Mxnet-Trace`` header, plus a bounded
per-process :class:`SpanBuffer` of versioned ``mxnet_tpu.trace.v1``
span records, served over ``GET /trace`` (NDJSON, since-cursor). The
stitcher (:func:`stitch`, :func:`tree_verdict`, :func:`normalize_skew`,
:func:`waterfall`, :func:`decompose_ttft`, :func:`critical_path`) puts
the buffers back together into per-request trees, with per-hop
clock-skew normalization anchored on the gateway's send/receive bounds.

Telemetry contract (the reference's):

  * off by default: ``MXNET_TPU_TRACE=1`` turns it on;
  * the disabled path is near-allocation-free: one attribute read in
    :func:`enabled` / :func:`current_trace_id`, no context objects, no
    header parsing;
  * lock-cheap when enabled: one small lock per buffer, held only to
    append a pre-built record;
  * stdlib only.

Header format (W3C traceparent shaped)::

    X-Mxnet-Trace: 00-<32 hex trace_id>-<16 hex span_id>-01

An all-zero span_id means "no parent": the receiver starts a root
span. Span records are flat JSON objects::

    {"seq": 7, "site": "replica:8001", "trace": "4b..", "span": "9c..",
     "parent": "00..", "name": "srv.generate", "t0": 1754...,
     "t1": 1754..., "attrs": {"path": "/generate"}}
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

__all__ = [
    'TRACE_SCHEMA', 'TRACE_HEADER', 'NO_PARENT', 'TraceContext',
    'SpanBuffer', 'enabled', 'set_enabled', 'get_buffer',
    'current', 'current_trace_id', 'activate', 'emit_phase',
    'parse_header', 'stitch', 'normalize_skew', 'tree_verdict',
    'waterfall', 'critical_path', 'read_ndjson',
]

TRACE_SCHEMA = 'mxnet_tpu.trace.v1'
TRACE_HEADER = 'X-Mxnet-Trace'
NO_PARENT = '0' * 16


def _knob(name, default):
    try:
        from ..config import get as _cfg
        return _cfg(name)
    except Exception:
        return default


class _State:
    """Shared enable flag; a plain attribute so the disabled fast path
    is a single LOAD_ATTR (the metrics._State pattern)."""

    __slots__ = ('enabled',)

    def __init__(self):
        self.enabled = None     # None = resolve from config on first use


_state = _State()


def _resolve_enabled():
    _state.enabled = bool(_knob('MXNET_TPU_TRACE', False))
    return _state.enabled


def enabled():
    """Tracing master switch (``MXNET_TPU_TRACE``, default off;
    overridable at runtime with :func:`set_enabled`). Request paths
    call this before building any context or span payload."""
    e = _state.enabled
    if e is None:
        return _resolve_enabled()
    return e


def set_enabled(value):
    """Runtime override (drills toggle this around their windows).
    ``None`` re-resolves from config on next use."""
    _state.enabled = None if value is None else bool(value)
    return _state.enabled


def _new_id(nbytes):
    return os.urandom(nbytes).hex()


class TraceContext:
    """One hop's identity: the trace and the span under which this
    process's work nests. ``child()`` mints the next hop."""

    __slots__ = ('trace_id', 'span_id', 'parent_id')

    def __init__(self, trace_id, span_id, parent_id=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def new(cls):
        """Fresh bare trace identity: no span opened yet, so the first
        span created under it becomes the tree root (loadgen mints one
        of these per request and sends the all-zero-span header)."""
        return cls(_new_id(16), None, None)

    def child(self):
        """Context for a span nested under this one."""
        return TraceContext(self.trace_id, _new_id(8), self.span_id)

    def to_header(self):
        return '00-%s-%s-01' % (self.trace_id,
                                self.span_id or NO_PARENT)

    def __repr__(self):
        return ('TraceContext(%s, span=%s, parent=%s)'
                % (self.trace_id, self.span_id, self.parent_id))


def parse_header(value):
    """Parse an ``X-Mxnet-Trace`` header into a context whose
    ``span_id`` names the *sender's* span (the parent for spans opened
    here). Returns None on anything malformed — a bad header must
    never fail a request."""
    if not value:
        return None
    parts = value.strip().split('-')
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if span_id == NO_PARENT:
        span_id = None
    return TraceContext(trace_id, span_id, None)


# ---------------------------------------------------------------------------
# ambient (thread-local) context: serving handler threads + training
# paths bind it so step phases and flight events pick up trace_id

_tls = threading.local()


def current():
    """The thread's active context, or None."""
    if not _state.enabled and not enabled():
        return None
    return getattr(_tls, 'ctx', None)


def current_trace_id():
    """Fast trace_id probe for event stampers (flight recorder): one
    flag read when tracing is off."""
    if not _state.enabled and not enabled():
        return None
    ctx = getattr(_tls, 'ctx', None)
    return ctx.trace_id if ctx is not None else None


class activate:
    """Bind a context to the current thread for the ``with`` body.
    ``activate(None)`` is a no-op (handlers can wrap unconditionally).
    """

    __slots__ = ('_ctx', '_prev')

    def __init__(self, ctx):
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        if self._ctx is not None:
            self._prev = getattr(_tls, 'ctx', None)
            _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        if self._ctx is not None:
            _tls.ctx = self._prev
        return False


# ---------------------------------------------------------------------------
# span buffer


class _LiveSpan:
    """Open span handle: carries the child context for propagation
    (``span.ctx.to_header()`` on outbound hops) and emits on exit."""

    __slots__ = ('_buf', 'name', 'ctx', 'attrs', '_t0')

    def __init__(self, buf, name, ctx, attrs):
        self._buf = buf
        self.name = name
        self.ctx = ctx
        self.attrs = attrs
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        if self._buf is not None and self._t0 is not None:
            self._buf.emit(self.name, self.ctx, self._t0, time.time(),
                           **self.attrs)
        self._t0 = None
        return False


class _NullSpan:
    """Disabled-path span: shared singleton, allocates nothing."""

    __slots__ = ()
    ctx = None
    attrs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class SpanBuffer:
    """Bounded per-process buffer of finished ``mxnet_tpu.trace.v1``
    span records. Each record gets a monotonically increasing ``seq``
    so readers (``GET /trace?since=N``) drain incrementally without
    server-side cursors; overflow drops oldest."""

    def __init__(self, capacity=None, site=None, clock=time.time):
        if capacity is None:
            capacity = int(_knob('MXNET_TPU_TRACE_BUFFER', 4096))
        self.site = site or 'pid:%d' % os.getpid()
        self._clock = clock
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=max(1, int(capacity)))
        self._emitted = 0

    def emit(self, name, ctx, t0, t1, **attrs):
        """Append one finished span under ``ctx`` (its span_id IS this
        span; parent from ``ctx.parent_id``). No-op when tracing is
        off or ctx is None, so call sites need no guard."""
        if ctx is None or (not _state.enabled and not enabled()):
            return None
        rec = {'site': self.site, 'trace': ctx.trace_id,
               'span': ctx.span_id, 'parent': ctx.parent_id,
               'name': name, 't0': round(t0, 6), 't1': round(t1, 6)}
        if attrs:
            rec['attrs'] = attrs
        with self._lock:
            self._emitted += 1
            rec['seq'] = self._emitted
            self._ring.append(rec)
        return rec

    def span(self, name, ctx, **attrs):
        """Scoped child span under ``ctx``::

            with buf.span('gw.relay', ctx, url=url) as sp:
                headers[TRACE_HEADER] = sp.ctx.to_header()
                ...

        Returns a shared no-op when tracing is off or ctx is None."""
        if ctx is None or (not _state.enabled and not enabled()):
            return _NULL_SPAN
        return _LiveSpan(self, name, ctx.child(), attrs)

    def read(self, since=0):
        """Records with seq > since, oldest first."""
        with self._lock:
            return [r for r in self._ring if r['seq'] > since]

    def stats(self):
        with self._lock:
            return {'site': self.site, 'emitted': self._emitted,
                    'buffered': len(self._ring),
                    'dropped': self._emitted - len(self._ring),
                    'capacity': self._ring.maxlen,
                    'enabled': enabled()}

    def clear(self):
        with self._lock:
            self._ring.clear()

    def ndjson(self, since=0):
        """The ``GET /trace`` payload: one header line (schema, site,
        cursor) then one line per record (drain-style: the client
        advances its own ``since`` cursor to the returned ``cursor``).
        """
        recs = self.read(since)
        with self._lock:
            cursor = self._emitted
        head = {'schema': TRACE_SCHEMA, 'site': self.site,
                'cursor': cursor, 'count': len(recs)}
        lines = [json.dumps(head, sort_keys=True)]
        lines.extend(json.dumps(r, sort_keys=True) for r in recs)
        return ('\n'.join(lines) + '\n').encode()


_buffer = None
_buffer_lock = threading.Lock()


def get_buffer():
    """Process-default buffer (training paths, step phases).
    Serving processes use per-server buffers so one test process can
    host a whole fleet with distinct sites."""
    global _buffer
    if _buffer is None:
        with _buffer_lock:
            if _buffer is None:
                _buffer = SpanBuffer()
    return _buffer


def emit_phase(phase, t0, t1):
    """Step-phase hook: land a step-phase occurrence as a trace span
    under the ambient context (one flag read when tracing is off)."""
    if not _state.enabled and not enabled():
        return
    ctx = getattr(_tls, 'ctx', None)
    if ctx is None:
        return
    get_buffer().emit('phase.%s' % phase, ctx.child(), t0, t1)


# ---------------------------------------------------------------------------
# stitching (trace reports and drill verdicts)


def read_ndjson(lines):
    """Parse ``GET /trace`` NDJSON (bytes, str, or line iterable) into
    span records, skipping header lines and torn/truncated lines (the
    read_flight contract)."""
    if isinstance(lines, bytes):
        lines = lines.decode('utf-8', 'replace').splitlines()
    elif isinstance(lines, str):
        lines = lines.splitlines()
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue                       # torn tail line
        if not isinstance(rec, dict) or 'span' not in rec:
            continue                       # header / foreign line
        if 'trace' not in rec or 'name' not in rec:
            continue
        out.append(rec)
    return out


def stitch(records):
    """Group span records into per-trace trees. Returns
    ``{trace_id: tree}`` where tree is::

        {'spans': {span_id: record}, 'roots': [span_id...],
         'orphans': [span_id...], 'children': {span_id: [span_id...]}}

    A root has no parent; an orphan names a parent that is absent from
    the collected set (a torn buffer or an unscraped process).
    Duplicate span_ids keep the first record seen."""
    traces = {}
    for rec in records:
        tree = traces.setdefault(rec['trace'],
                                 {'spans': {}, 'roots': [],
                                  'orphans': [], 'children': {}})
        tree['spans'].setdefault(rec['span'], rec)
    for tree in traces.values():
        spans = tree['spans']
        for sid, rec in spans.items():
            parent = rec.get('parent')
            if parent in (None, '', NO_PARENT):
                tree['roots'].append(sid)
            elif parent in spans:
                tree['children'].setdefault(parent, []).append(sid)
            else:
                tree['orphans'].append(sid)
        for kids in tree['children'].values():
            kids.sort(key=lambda s: spans[s]['t0'])
        tree['roots'].sort(key=lambda s: spans[s]['t0'])
    return traces


def tree_verdict(tree):
    """Completeness check for one stitched tree: exactly one root,
    zero orphans, every span reachable from the root."""
    if len(tree['roots']) != 1 or tree['orphans']:
        return False
    seen = set()
    stack = list(tree['roots'])
    while stack:
        sid = stack.pop()
        if sid in seen:
            continue
        seen.add(sid)
        stack.extend(tree['children'].get(sid, ()))
    return len(seen) == len(tree['spans'])


def normalize_skew(tree):
    """Shift each remote site's wall-clocks into the root site's
    timeline, per hop, anchored on the parent span's send/receive
    bounds: a child span on another site must fit inside its
    cross-site parent (the gateway relay/handoff span), so the offset
    is clamped to ``[p.t0 - c.t0, p.t1 - c.t1]`` with the NTP-style
    midpoint estimate inside that interval. Mutates t0/t1 in place and
    returns ``{site: offset_seconds}``."""
    spans = tree['spans']
    if not tree['roots']:
        return {}
    root_site = spans[tree['roots'][0]].get('site')
    offsets = {root_site: 0.0}
    # BFS from the root; resolve a site's offset at its first
    # cross-site edge (gateway bounds), intersecting across parallel
    # edges into the same site for a tighter clamp
    bounds = {}
    order = list(tree['roots'])
    i = 0
    while i < len(order):
        sid = order[i]
        i += 1
        rec = spans[sid]
        psite = rec.get('site')
        for kid in tree['children'].get(sid, ()):
            krec = spans[kid]
            ksite = krec.get('site')
            if ksite != psite and ksite not in offsets:
                base = offsets.get(psite, 0.0)
                lo = (rec['t0'] + base) - krec['t0']
                hi = (rec['t1'] + base) - krec['t1']
                if hi < lo:                 # child outlasts parent
                    lo = hi = (lo + hi) / 2.0
                b = bounds.get(ksite)
                bounds[ksite] = (lo, hi) if b is None else \
                    (max(b[0], lo), min(b[1], hi))
            order.append(kid)
    for site, (lo, hi) in bounds.items():
        offsets[site] = (lo + hi) / 2.0 if lo <= hi else lo
    for rec in spans.values():
        off = offsets.get(rec.get('site'))
        if off:
            rec['t0'] = round(rec['t0'] + off, 6)
            rec['t1'] = round(rec['t1'] + off, 6)
    return offsets


def waterfall(tree):
    """Depth-first per-request waterfall rows (after skew
    normalization): ``[{'name', 'site', 'depth', 'start_ms',
    'dur_ms'}, ...]`` with start relative to the root span."""
    if not tree['roots']:
        return []
    t_root = tree['spans'][tree['roots'][0]]['t0']
    rows = []

    def walk(sid, depth):
        rec = tree['spans'][sid]
        rows.append({'name': rec['name'], 'site': rec.get('site'),
                     'depth': depth,
                     'start_ms': round((rec['t0'] - t_root) * 1e3, 3),
                     'dur_ms': round((rec['t1'] - rec['t0']) * 1e3,
                                     3)})
        for kid in tree['children'].get(sid, ()):
            walk(kid, depth + 1)

    for root in tree['roots']:
        walk(root, 0)
    return rows


# TTFT decomposition: phase label -> span names that account for it.
# Components are clipped to [root.t0, first-token instant] so a span
# that straddles the first token only contributes its pre-TTFT part.
TTFT_PHASES = (
    ('queue', ('eng.queue_wait',)),
    ('prefill', ('eng.prefill',)),
    ('handoff', ('gw.handoff', 'eng.export', 'eng.import')),
    ('first_step', ('eng.first_token',)),
)


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def decompose_ttft(tree):
    """One trace's TTFT split: ``(ttft_s, {phase: seconds})`` with an
    ``other`` residual, or None when the tree never reached a first
    token. Handoff/export/import time that overlaps prefill (the prefill-
    boundary export) is attributed once, to the earlier phase."""
    if not tree['roots']:
        return None
    spans = tree['spans'].values()
    root = tree['spans'][tree['roots'][0]]
    first = [s for s in spans if s['name'] == 'eng.first_token']
    if not first:
        return None
    t_first = min(s['t1'] for s in first)
    ttft = t_first - root['t0']
    if ttft <= 0:
        return None
    parts = {}
    covered = []                      # claimed [t0, t1) intervals
    for label, names in TTFT_PHASES:
        if label == 'first_step':
            continue                  # residual-defined below
        total = 0.0
        for s in spans:
            if s['name'] not in names:
                continue
            lo, hi = max(s['t0'], root['t0']), min(s['t1'], t_first)
            # subtract already-claimed overlap so phases sum <= ttft
            for clo, chi in covered:
                cut_lo, cut_hi = max(lo, clo), min(hi, chi)
                if cut_hi > cut_lo:
                    hi -= (cut_hi - cut_lo)
            if hi > lo:
                total += hi - lo
                covered.append((max(s['t0'], root['t0']),
                                min(s['t1'], t_first)))
        parts[label] = total
    accounted = sum(parts.values())
    first_step = max(0.0, min(s['t1'] - s['t0'] for s in first))
    first_step = min(first_step, max(0.0, ttft - accounted))
    parts['first_step'] = first_step
    parts['other'] = max(0.0, ttft - accounted - first_step)
    return ttft, parts


def critical_path(trees):
    """Aggregate TTFT/TPOT critical-path attribution across stitched
    trees: percentiles of TTFT plus, for each percentile, the phase
    decomposition of the trace *at* that percentile (e.g. "p99 TTFT =
    14% queue + 31% prefill + 42% handoff + 13% first decode step")."""
    rows = []
    tpots = []
    for tree in trees:
        d = decompose_ttft(tree)
        if d is not None:
            rows.append(d)
        for s in tree['spans'].values():
            if s['name'] == 'eng.steps':
                attrs = s.get('attrs') or {}
                steps = attrs.get('steps')
                if steps:
                    tpots.append((s['t1'] - s['t0']) / steps)
    rows.sort(key=lambda r: r[0])
    tpots.sort()
    out = {'n': len(rows), 'ttft': {}, 'tpot': {}}
    for q, label in ((0.5, 'p50'), (0.99, 'p99')):
        row = _percentile(rows, q)
        if row is None:
            continue
        ttft, parts = row
        out['ttft'][label] = {
            'ttft_ms': round(ttft * 1e3, 3),
            'share_pct': {k: round(100.0 * v / ttft, 1)
                          for k, v in parts.items()},
            'ms': {k: round(v * 1e3, 3) for k, v in parts.items()},
        }
        tp = _percentile(tpots, q)
        if tp is not None:
            out['tpot'][label + '_ms'] = round(tp * 1e3, 3)
    return out
