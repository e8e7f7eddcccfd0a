"""Exporters of the metrics registry, the port of
``mxnet_tpu/observability/export.py`` but its TensorBoard export:

  * :func:`prometheus_text` renders a registry snapshot in the Prometheus
    text exposition format (the gateway's ``GET /metrics`` appends it),
    :func:`parse_prometheus` reads it back for schema checks;
  * :func:`write_prometheus` writes it to a file atomically (the
    textfile-collector pattern), :func:`write_jsonl` one JSON object a
    metric family;
  * :class:`PrometheusServer` serves ``GET /metrics`` from a stdlib HTTP
    server bound to 127.0.0.1, off unless asked for:
    :func:`maybe_start_http_server` starts one only when
    ``MXNET_TPU_TELEMETRY_HTTP_PORT`` is nonzero (port 0 given to the
    class resolves to an ephemeral port).

Stdlib only.
"""
from __future__ import annotations

import json
import re
import threading

from . import metrics as _metrics

__all__ = ['prometheus_text', 'write_prometheus', 'write_jsonl',
           'PrometheusServer', 'maybe_start_http_server',
           'parse_prometheus']

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


def write_prometheus(path, snapshot=None):
    """Atomic file export (the textfile-collector pattern)."""
    from ..resilience.checkpoint import atomic_write_bytes
    atomic_write_bytes(path, prometheus_text(snapshot).encode())
    return path


def write_jsonl(path, snapshot=None, extra=None):
    """One JSON object a metric family, plus an optional trailer."""
    from ..resilience.checkpoint import atomic_write_bytes
    snap = snapshot if snapshot is not None else _metrics.snapshot()
    lines = [json.dumps({'name': name, **snap[name]}, sort_keys=True)
             for name in sorted(snap)]
    if extra:
        lines.append(json.dumps(extra, sort_keys=True, default=str))
    atomic_write_bytes(path, ('\n'.join(lines) + '\n').encode())
    return path


class PrometheusServer:
    """Stdlib ``/metrics`` endpoint, bound to 127.0.0.1. Off unless
    constructed (or ``MXNET_TPU_TELEMETRY_HTTP_PORT`` set for
    :func:`maybe_start_http_server`); port 0 picks a free port, read back
    from :attr:`port` after :meth:`start`."""

    def __init__(self, port, host='127.0.0.1'):
        self.host = host
        self.port = int(port)
        self._httpd = None
        self._thread = None

    def start(self):
        if self._httpd is not None:
            return self
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_GET(handler):
                if handler.path.rstrip('/') not in ('', '/metrics'):
                    handler.send_error(404)
                    return
                body = prometheus_text().encode()
                handler.send_response(200)
                handler.send_header('Content-Type',
                                    'text/plain; version=0.0.4')
                handler.send_header('Content-Length', str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)

            def log_message(handler, *args):
                pass            # no stderr line a scrape

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]   # resolve port 0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name='mxnet-tpu-torch-telemetry-http')
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


_auto_server = None


def maybe_start_http_server():
    """Start the ``/metrics`` server when ``MXNET_TPU_TELEMETRY_HTTP_PORT``
    is a nonzero port (once a process). Returns the server or None."""
    global _auto_server
    if _auto_server is not None:
        return _auto_server
    try:
        from ..config import get as _cfg
        port = int(_cfg('MXNET_TPU_TELEMETRY_HTTP_PORT') or 0)
    except Exception:
        port = 0
    if not port:
        return None
    _auto_server = PrometheusServer(port).start()
    return _auto_server
