"""Telemetry of the port, the port of ``mxnet_tpu/observability`` for the
serving and resilience paths:

  * ``metrics``  -- lock-cheap labelled Counters / Gauges / Histograms
                    (fixed power-of-two buckets), ``snapshot()``,
                    near-zero overhead when disabled
                    (``MXNET_TPU_TELEMETRY=0``).
  * ``recorder`` -- the FlightRecorder: a bounded ring of structured
                    events dumped as a ``mxnet_tpu.flight.v1`` JSONL
                    artifact on a stall, a breaker trip, a preemption or
                    a crash, so a post-mortem has the last N events.
  * ``export``   -- the Prometheus text format (file, and a stdlib HTTP
                    ``/metrics`` server off by default) and JSONL.
  * ``trace``    -- request tracing: the ``X-Mxnet-Trace`` context, the
                    bounded span buffer and the stitcher.
  * ``spans``    -- step-phase spans (data-wait / step / sync / checkpoint
                    / compile) into ``mxnet_tpu_phase_seconds``, unified
                    with the profiler's scopes and ``torch.profiler``.

:func:`serving_instruments`, :func:`trainer_instruments` and
:func:`gateway_instruments` declare the reference's series (names, help,
labels); the decode engine, the one-shot session, the micro-batcher, the
programs' builds, the adapter pool, the gateway, the watchdog, the
trainer (``ParallelTrainer``'s step, compile and checkpoint emits) and
the checkpoint manager feed them, from host values only. :func:`summary`
folds the registry and the recorder's stats into one small dict.
``python -m mxnet_tpu_torch.observability`` runs the self-test's eight
legs. The HLO and roofline readers and the TensorBoard export are not
ported (ROADMAP A11). Stdlib only at import.
"""
from __future__ import annotations

from . import export, metrics, recorder, spans, trace
from .export import (PrometheusServer, maybe_start_http_server,
                     parse_prometheus, prometheus_text, write_jsonl,
                     write_prometheus)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, counter,
                      enabled, gauge, get_registry, histogram, set_enabled,
                      snapshot)
from .recorder import (FLIGHT_SCHEMA, FlightRecorder, configure_flight,
                       flight_dump, get_recorder, install_excepthook,
                       read_flight, record_event, uninstall_excepthook)
from .spans import PHASES, span
from .trace import TRACE_HEADER, TRACE_SCHEMA, SpanBuffer, TraceContext

__all__ = [
    'metrics', 'recorder', 'spans', 'export', 'trace', 'TRACE_SCHEMA',
    'TRACE_HEADER', 'TraceContext', 'SpanBuffer', 'Counter', 'Gauge',
    'Histogram', 'MetricsRegistry', 'counter', 'gauge', 'histogram',
    'get_registry', 'enabled', 'set_enabled', 'snapshot', 'FLIGHT_SCHEMA',
    'FlightRecorder', 'get_recorder', 'record_event', 'flight_dump',
    'configure_flight', 'install_excepthook', 'uninstall_excepthook',
    'read_flight', 'PHASES', 'span', 'prometheus_text', 'write_prometheus', 'write_jsonl',
    'PrometheusServer', 'maybe_start_http_server', 'parse_prometheus',
    'trainer_instruments', 'serving_instruments', 'gateway_instruments',
    'summary',
]


class _Instruments:
    """Bag of pre-bound metric children so hot paths pay one attribute
    read per event, never a registry lookup."""

    def __init__(self, **children):
        self.__dict__.update(children)


_trainer_inst = None
_serving_inst = None


def trainer_instruments():
    """Fused-step / fit-loop instruments, declared whole as the
    reference declares them. ``ParallelTrainer`` moves the step, example,
    step / compile seconds and global-step series, the checkpoint manager
    ``checkpoints``, the watchdog ``heartbeat_age``; the guardrail's,
    ``Module.fit``'s and the Speedometer's series wait for those
    modules."""
    global _trainer_inst
    if _trainer_inst is None:
        # first instrumented training activity: honor the HTTP-export
        # knob so MXNET_TPU_TELEMETRY_HTTP_PORT=<port> alone exposes
        # /metrics for any training entry point (still off by default)
        try:
            maybe_start_http_server()
        except Exception:
            pass          # an occupied port must not fail training
        _trainer_inst = _Instruments(
            steps=counter('mxnet_tpu_steps_total',
                          help='optimizer steps dispatched'),
            examples=counter('mxnet_tpu_examples_total',
                             help='training examples consumed'),
            step_seconds=histogram(
                'mxnet_tpu_step_seconds',
                help='host wall seconds per fused-step dispatch '
                     '(dispatch-to-dispatch; async backends overlap '
                     'device time)'),
            compile_seconds=histogram(
                'mxnet_tpu_compile_seconds',
                help='wall seconds spent building+compiling programs'),
            epoch=gauge('mxnet_tpu_epoch',
                        help='current epoch cursor (Module.fit)'),
            global_step=gauge('mxnet_tpu_global_step',
                              help='current global step cursor'),
            grad_norm=gauge('mxnet_tpu_grad_norm',
                            help='last observed global gradient norm '
                                 '(guardrail sentinel)'),
            loss_scale=gauge('mxnet_tpu_loss_scale',
                             help='current dynamic loss scale'),
            skipped=counter('mxnet_tpu_skipped_updates_total',
                            help='optimizer updates skipped on '
                                 'non-finite gradients'),
            nonfinite=counter('mxnet_tpu_nonfinite_events_total',
                              help='non-finite sentinel events'),
            checkpoints=counter('mxnet_tpu_checkpoints_total',
                                help='checkpoints written'),
            heartbeat_age=gauge(
                'mxnet_tpu_watchdog_heartbeat_age_seconds',
                help='age of the last watchdog heartbeat at the most '
                     'recent stall check'),
            speedometer=gauge(
                'mxnet_tpu_speedometer_samples_per_sec',
                help='last Speedometer window throughput'),
        )
    return _trainer_inst


def serving_instruments():
    """Inference-engine instruments: the decode engine, the one-shot
    session, the micro-batcher, the programs' builds and the adapter pool
    feed them."""
    global _serving_inst
    if _serving_inst is None:
        try:
            maybe_start_http_server()
        except Exception:
            pass      # an occupied port must not fail serving
        _serving_inst = _Instruments(
            requests=counter('mxnet_tpu_serve_requests_total',
                             help='inference requests admitted'),
            rejected=counter('mxnet_tpu_serve_rejected_total',
                             labels=('reason',),
                             help='requests rejected by admission '
                                  'control (queue_full, ...)'),
            batches=counter('mxnet_tpu_serve_batches_total',
                            help='micro-batches dispatched'),
            batch_size=histogram('mxnet_tpu_serve_batch_size',
                                 help='requests aggregated per '
                                      'micro-batch'),
            queue_depth=gauge('mxnet_tpu_serve_queue_depth',
                              help='pending requests in the '
                                   'micro-batch queue'),
            latency=histogram('mxnet_tpu_serve_request_seconds',
                              help='request latency: enqueue to '
                                   'result set (queue wait + batch '
                                   'execute)'),
            compiles=counter('mxnet_tpu_serve_compiles_total',
                             help='inference programs built (bounded '
                                  'by the bucket ladder)'),
            breaker_trips=counter(
                'mxnet_tpu_serve_breaker_trips_total',
                help='circuit-breaker open transitions'),
            fallbacks=counter('mxnet_tpu_serve_fallback_batches_total',
                              help='batches served on the CPU '
                                   'fallback path'),
            degraded=gauge('mxnet_tpu_serve_degraded',
                           help='1 while the session serves degraded '
                                '(breaker open / fallback active)'),
            # autoregressive decode engine (serving/decode/)
            tokens=counter('mxnet_tpu_serve_tokens_total',
                           help='tokens generated (prefill first '
                                'tokens + decode steps + degraded '
                                'fallback tokens)'),
            prefills=counter('mxnet_tpu_serve_prefills_total',
                             help='prompt prefills landed in cache '
                                  'slots (sequence joins)'),
            decode_steps=counter(
                'mxnet_tpu_serve_decode_steps_total',
                help='fixed-shape decode steps (each advances every '
                     'live slot one token)'),
            ttft=histogram('mxnet_tpu_serve_ttft_seconds',
                           help='time to first token: submit to the '
                                'prefill-produced token'),
            tpot=histogram('mxnet_tpu_serve_tpot_seconds',
                           help='per-decode-step latency (time per '
                                'output token across the batch)'),
            active_slots=gauge('mxnet_tpu_serve_active_slots',
                               help='in-flight sequences in the '
                                    'continuous decode batch'),
            # paged KV cache (serving/decode/paged.py): the flight
            # recorder pairs these with page_alloc / page_evict /
            # prefix_hit events so pool-exhaustion admission
            # rejections are explainable post-hoc
            pages_total=gauge('mxnet_tpu_serve_pages_total',
                              help='allocatable KV pages in the paged '
                                   'decode pool (excl. the reserved '
                                   'trash page)'),
            pages_free=gauge('mxnet_tpu_serve_pages_free',
                             help='currently free KV pages in the '
                                  'paged decode pool'),
            page_occupancy=gauge(
                'mxnet_tpu_serve_page_occupancy_pct',
                help='percent of the paged decode pool in use '
                     '(allocated or prefix-cached)'),
            prefix_hits=counter(
                'mxnet_tpu_serve_prefix_hits_total',
                help='admissions that referenced shared prompt-'
                     'prefix pages instead of re-prefilling them'),
            prefix_tokens_saved=counter(
                'mxnet_tpu_serve_prefix_tokens_saved_total',
                help='prompt tokens whose prefill compute was '
                     'skipped via prefix sharing'),
            spec_proposed=counter(
                'mxnet_tpu_serve_spec_proposed_total',
                help='draft-model tokens proposed by speculative '
                     'decoding'),
            spec_accepted=counter(
                'mxnet_tpu_serve_spec_accepted_total',
                help='draft proposals accepted by the target '
                     'verify step (acceptance rate = accepted / '
                     'proposed)'),
            # live decode-state migration (serving/decode/seqstate.py,
            # docs/SERVING.md "Drain & live migration"): paired with
            # drain_begin / seq_export / seq_import / drain_complete
            # flight events
            sequences_migrated=counter(
                'mxnet_tpu_serve_sequences_migrated_total',
                help='in-flight sequences exported as seqstate '
                     'payloads (graceful drain / prefill-decode '
                     'handoff)'),
            drains=counter(
                'mxnet_tpu_serve_drains_total',
                help='graceful drains begun (SIGTERM/preempt hook or '
                     'explicit begin_drain)'),
            handoff_pages=counter(
                'mxnet_tpu_serve_handoff_pages_total',
                help='KV pages carried across engines by seqstate '
                     'export/import'),
            migration_seconds=histogram(
                'mxnet_tpu_serve_migration_seconds',
                help='per-sequence export/import latency (device '
                     'gather/scatter + payload assembly)'),
            drain_seconds=histogram(
                'mxnet_tpu_serve_drain_seconds',
                help='graceful drain wall time: begin_drain to all '
                     'sequences exported and handed off'),
            # multi-adapter (LoRA) serving + sampled decoding
            # (serving/adapters/, docs/SERVING.md "Multi-adapter
            # serving & sampling")
            adapter_loads=counter(
                'mxnet_tpu_serve_adapter_loads_total',
                help='adapter uploads into the device-resident pool '
                     '(a warm re-acquire is a refcount bump, not a '
                     'load)'),
            adapter_evictions=counter(
                'mxnet_tpu_serve_adapter_evictions_total',
                help='LRU evictions of unpinned adapter pool rows to '
                     'make room for a cold load'),
            active_adapters=gauge(
                'mxnet_tpu_serve_active_adapters',
                help='adapters resident in the device pool (excl. '
                     'the reserved base row)'),
            sampled_tokens=counter(
                'mxnet_tpu_serve_sampled_tokens_total',
                help='tokens emitted under temperature>0 sampling '
                     '(greedy traffic is tokens_total minus this)'),
        )
    return _serving_inst


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


def summary():
    """Compact telemetry block for bench/instrument status JSON: scalar
    series verbatim, histograms reduced to count/sum/avg — small enough
    to fold into every artifact."""
    out = {'enabled': enabled(), 'flight': get_recorder().stats(),
           'trace': trace.get_buffer().stats()}
    series_out = {}
    for name, fam in snapshot().items():
        rows = []
        for series in fam['series']:
            if fam['type'] == 'histogram':
                count = series['count']
                rows.append({'labels': series['labels'],
                             'count': count,
                             'sum': round(series['sum'], 6),
                             'avg': round(series['sum'] / count, 6)
                             if count else None})
            else:
                rows.append({'labels': series['labels'],
                             'value': series['value']})
        series_out[name] = {'type': fam['type'], 'series': rows}
    out['metrics'] = series_out
    return out
