"""Percentile math and the versioned ``mxnet_tpu.slo.v1`` artifact, the
port of ``mxnet_tpu/loadgen/report.py``.

One JSON document a load-harness run: the offered / admitted / shed
accounting, the latency distribution of ADMITTED requests (a 429 is the
mechanism that protects the latency SLO, so it is left out of it, but its
own speed is reported: a shed must be a fast rejection, not a slow
timeout), TTFT / TPOT of the streamed ``/generate`` path, the error
taxonomy by class, and the per-fault recovery times of the chaos mode.
The documents are the reference's for the same records.

Pure math over RequestRecords; no HTTP, no clocks.
"""
from __future__ import annotations

__all__ = ['SLO_SCHEMA', 'percentile', 'latency_summary', 'summarize',
           'build_artifact']

SLO_SCHEMA = 'mxnet_tpu.slo.v1'


def percentile(values, q):
    """Nearest-rank percentile (q in [0, 100]) of a sequence; None on
    empty input. Deterministic, interpolation-free — artifact numbers
    diff stably."""
    if not values:
        return None
    if not 0.0 <= q <= 100.0:
        raise ValueError('q must be in [0, 100], got %r' % (q,))
    vals = sorted(values)
    rank = max(1, int(-(-q * len(vals) // 100)))   # ceil, 1-based
    return vals[min(rank, len(vals)) - 1]


def _ms(v):
    return None if v is None else round(v * 1e3, 3)


def latency_summary(seconds):
    """p50/p99/p999/max/mean over a list of second-valued latencies,
    reported in milliseconds."""
    if not seconds:
        return {'n': 0, 'p50_ms': None, 'p99_ms': None,
                'p999_ms': None, 'max_ms': None, 'mean_ms': None}
    return {
        'n': len(seconds),
        'p50_ms': _ms(percentile(seconds, 50)),
        'p99_ms': _ms(percentile(seconds, 99)),
        'p999_ms': _ms(percentile(seconds, 99.9)),
        'max_ms': _ms(max(seconds)),
        'mean_ms': _ms(sum(seconds) / len(seconds)),
    }


def summarize(records):
    """Aggregate a run's RequestRecords into the artifact's metric
    block."""
    offered = len(records)
    admitted = [r for r in records if r.status == 200]
    ok = [r for r in admitted if r.error_class is None]
    shed = [r for r in records if r.status == 429]
    unresolved = sum(1 for r in records if not r.resolved)
    taxonomy = {}
    for r in records:
        key = r.error_class if r.error_class is not None else 'ok'
        taxonomy[key] = taxonomy.get(key, 0) + 1
    out = {
        'offered': offered,
        'admitted': len(admitted),
        'served_ok': len(ok),
        'shed': len(shed),
        'degraded': sum(1 for r in admitted if r.degraded),
        # success-with-resume: streams the gateway failed over
        # mid-generation and completed clean — they count toward
        # goodput, never as failures (the resume is the mechanism
        # that KEPT them successful)
        'resumed_streams': sum(1 for r in ok
                               if getattr(r, 'resumed', 0)),
        'retried': sum(1 for r in records
                       if getattr(r, 'retries', 0)),
        'unresolved': unresolved,
        'goodput': (len(ok) / float(offered)) if offered else None,
        'availability': ((len(admitted)) / float(offered))
        if offered else None,
        'errors': dict(sorted(taxonomy.items())),
        # latency SLO: over requests admission control let IN
        'admitted_latency': latency_summary(
            [r.latency_s() for r in admitted
             if r.latency_s() is not None]),
        # sheds must be FAST rejections (429 now beats 504 later)
        'shed_latency': latency_summary(
            [r.latency_s() for r in shed
             if r.latency_s() is not None]),
        'retry_after': {
            'n': sum(1 for r in shed if r.retry_after_s is not None),
            'max_s': max([r.retry_after_s for r in shed
                          if r.retry_after_s is not None],
                         default=None),
        },
    }
    gen = [r for r in admitted if r.kind == 'generate']
    if gen:
        out['generate'] = {
            'n': len(gen),
            'tokens': sum(r.tokens for r in gen),
            'ttft': latency_summary([r.ttft_s() for r in gen
                                     if r.ttft_s() is not None]),
            'tpot': latency_summary([r.tpot_s() for r in gen
                                     if r.tpot_s() is not None]),
        }
    return out


def build_artifact(mode, config, metrics, faults=None, server=None,
                   verdicts=None):
    """Assemble the versioned artifact document.

    ``faults``   chaos mode: [{kind, injected_at_s, cleared_at_s,
                 recovery_s, consumed, aborted_requests}, ...]
    ``server``   end-of-run server-side drain proof (leaked slots,
                 queue depths, breaker state)
    ``verdicts`` {check_name: bool} the mode itself asserted
    """
    doc = {
        'schema': SLO_SCHEMA,
        'mode': mode,
        'config': dict(config),
        'metrics': metrics,
    }
    if faults is not None:
        doc['faults'] = faults
    if server is not None:
        doc['server'] = server
    if verdicts is not None:
        doc['verdicts'] = {k: bool(v)
                           for k, v in sorted(verdicts.items())}
        doc['ok'] = all(verdicts.values())
    return doc
