"""Telemetry of the port: the metrics registry and request tracing, the
port of ``mxnet_tpu/observability`` as far as the serving gateway reads
it (``mxnet_tpu/observability/__init__.py:75-88, 314-392``):

  * ``metrics`` -- lock-cheap labelled Counters / Gauges / Histograms
                   (fixed power-of-two buckets), ``snapshot()``,
                   near-zero overhead when disabled
                   (``MXNET_TPU_TELEMETRY=0``).
  * ``export``  -- the Prometheus text format (``prometheus_text``,
                   ``parse_prometheus``).
  * ``trace``   -- request tracing: the ``X-Mxnet-Trace`` context, the
                   bounded span buffer and the stitcher.

:func:`gateway_instruments` declares the gateway's series with the
reference's names, help and labels. The flight recorder
(``record_event``), the step-phase spans, the file and HTTP exporters and
the other instrument bags are not ported yet (ROADMAP A11). Stdlib only.
"""
from __future__ import annotations

from . import export, metrics, trace
from .export import parse_prometheus, prometheus_text
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, counter,
                      enabled, gauge, get_registry, histogram, set_enabled,
                      snapshot)
from .trace import TRACE_HEADER, TRACE_SCHEMA, SpanBuffer, TraceContext

__all__ = [
    'metrics', 'export', 'trace', 'TRACE_SCHEMA', 'TRACE_HEADER',
    'TraceContext', 'SpanBuffer', 'Counter', 'Gauge', 'Histogram',
    'MetricsRegistry', 'counter', 'gauge', 'histogram', 'get_registry',
    'enabled', 'set_enabled', 'snapshot', 'prometheus_text',
    'parse_prometheus', 'gateway_instruments',
]


class _Instruments:
    """Bag of pre-bound metric children so hot paths pay one attribute
    read per event, never a registry lookup."""

    def __init__(self, **children):
        self.__dict__.update(children)


_gateway_inst = None


def gateway_instruments():
    """Serving-gateway instruments (``serving/gateway.py``): routing
    health plus the availability-layer counters: mid-stream resumes,
    prefix-affine routing decisions, per-tenant admission rejections,
    drain migrations and prefill/decode handoffs."""
    global _gateway_inst
    if _gateway_inst is None:
        _gateway_inst = _Instruments(
            requests=counter('mxnet_tpu_gateway_requests_total',
                             help='requests accepted for routing by '
                                  'the gateway'),
            failovers=counter(
                'mxnet_tpu_gateway_failovers_total',
                help='before-first-byte failovers to another healthy '
                     'replica (transport failure, no bytes relayed)'),
            resumes=counter(
                'mxnet_tpu_gateway_resumes_total',
                help='mid-stream resumes: a /generate stream '
                     're-admitted on a healthy replica with '
                     'prompt+emitted-tokens as the prefix'),
            resume_failures=counter(
                'mxnet_tpu_gateway_resume_failures_total',
                help='streams aborted typed after exhausting the '
                     'resume budget (MXNET_TPU_GATEWAY_RESUME_MAX)'),
            resumed_tokens=counter(
                'mxnet_tpu_gateway_resumed_tokens_total',
                help='tokens spliced into client streams from a '
                     'resume target (post-failover continuation)'),
            affinity_routed=counter(
                'mxnet_tpu_gateway_affinity_routed_total',
                help='/generate requests routed by prompt-prefix '
                     'fingerprint (rendezvous hash) instead of '
                     'round-robin'),
            tenant_rejected=counter(
                'mxnet_tpu_gateway_tenant_rejected_total',
                labels=('tenant', 'reason'),
                help='per-tenant admission rejections (rate_limit / '
                     'fair_share), each answered 429 + Retry-After'),
            healthy_replicas=gauge(
                'mxnet_tpu_gateway_healthy_replicas',
                help='replicas currently in the gateway routing '
                     'rotation'),
            migrations=counter(
                'mxnet_tpu_gateway_migrations_total',
                help='streams spliced onto a healthy replica via '
                     'seqstate handoff (/drain -> /import) after a '
                     'source replica drained — zero re-prefill'),
            migration_failures=counter(
                'mxnet_tpu_gateway_migration_failures_total',
                help='seqstate handoffs that failed and fell back to '
                     'the re-prefill resume path'),
            journal_capped=counter(
                'mxnet_tpu_gateway_journal_capped_total',
                help='streams whose resume journal hit '
                     'MXNET_TPU_GATEWAY_JOURNAL_MAX (falls back to '
                     're-prefill resume on failure)'),
            handoffs=counter(
                'mxnet_tpu_gateway_handoffs_total',
                labels=('class', 'outcome'),
                help='disaggregated prefill->decode seqstate '
                     'handoffs by destination class and outcome '
                     '(spliced / fallback)'),
            handoff_retries=counter(
                'mxnet_tpu_gateway_handoff_retries_total',
                help='handoff attempts that were refused or lost a '
                     'decode target and retried on the next class '
                     'member (MXNET_TPU_GATEWAY_HANDOFF_RETRIES)'),
            handoff_seconds=histogram(
                'mxnet_tpu_gateway_handoff_seconds',
                help='wall seconds from the prefill-boundary export '
                     'landing at the gateway to the decode-class '
                     'import splicing the continuation'),
        )
    return _gateway_inst
