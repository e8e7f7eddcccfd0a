"""Prometheus text exposition of the metrics registry, the port of
``mxnet_tpu/observability/export.py:29-111``: :func:`prometheus_text`
renders a registry snapshot (the gateway's ``GET /metrics`` appends it),
and :func:`parse_prometheus` reads the format back for schema checks.
The file writers, the stdlib ``/metrics`` server and the TensorBoard
export are not ported yet (ROADMAP A11).
"""
from __future__ import annotations

import re

from . import metrics as _metrics

__all__ = ['prometheus_text', 'parse_prometheus']

_LABEL_ESC = {'\\': '\\\\', '\n': '\\n', '"': '\\"'}


def _esc(value):
    return ''.join(_LABEL_ESC.get(c, c) for c in str(value))


def _fmt_labels(labels, extra=None):
    items = list(labels.items()) + (list(extra.items()) if extra else [])
    if not items:
        return ''
    return '{%s}' % ','.join('%s="%s"' % (k, _esc(v)) for k, v in items)


def _fmt_value(v):
    if v == float('inf'):
        return '+Inf'
    return repr(float(v))


def prometheus_text(snapshot=None):
    """Render a registry snapshot in the Prometheus exposition format."""
    snap = snapshot if snapshot is not None else _metrics.snapshot()
    lines = []
    for name in sorted(snap):
        fam = snap[name]
        if fam.get('help'):
            lines.append('# HELP %s %s'
                         % (name, fam['help'].replace('\n', ' ')))
        lines.append('# TYPE %s %s' % (name, fam['type']))
        for series in fam['series']:
            labels = series.get('labels', {})
            if fam['type'] == 'histogram':
                bounds = series['le']
                for le, cum in zip(bounds, series['buckets']):
                    le_s = '+Inf' if le == '+Inf' else _fmt_value(le)
                    lines.append('%s_bucket%s %d' % (
                        name, _fmt_labels(labels, {'le': le_s}), cum))
                lines.append('%s_sum%s %s'
                             % (name, _fmt_labels(labels),
                                _fmt_value(series['sum'])))
                lines.append('%s_count%s %d'
                             % (name, _fmt_labels(labels),
                                series['count']))
            else:
                lines.append('%s%s %s' % (name, _fmt_labels(labels),
                                          _fmt_value(series['value'])))
    return '\n'.join(lines) + '\n'


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$')


def parse_prometheus(text):
    """Minimal exposition-format parser used by the schema checks:
    returns ``(types, samples)`` with ``samples`` a list of
    ``(name, {label: value}, float)``. Raises ValueError on a line
    that is neither comment, blank, nor valid sample."""
    types = {}
    samples = []
    for ln in text.splitlines():
        if not ln.strip():
            continue
        if ln.startswith('# TYPE '):
            _, _, rest = ln.partition('# TYPE ')
            name, _, typ = rest.partition(' ')
            types[name] = typ.strip()
            continue
        if ln.startswith('#'):
            continue
        m = _SAMPLE_RE.match(ln)
        if m is None:
            raise ValueError('unparseable exposition line: %r' % ln)
        labels = {}
        raw = m.group('labels')
        if raw:
            for part in re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', raw):
                labels[part[0]] = part[1]
        v = m.group('value')
        value = float('inf') if v == '+Inf' else float(v)
        samples.append((m.group('name'), labels, value))
    return types, samples
