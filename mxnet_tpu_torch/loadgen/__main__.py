"""The command line of the load and chaos harness, the port of
``mxnet_tpu/loadgen/__main__.py``::

    python -m mxnet_tpu_torch.loadgen --mode overload --out SLO.json
    python -m mxnet_tpu_torch.loadgen --mode capacity --device cpu
    python -m mxnet_tpu_torch.loadgen --mode chaos --full

Builds the in-process serving rig (a frozen MLP behind /predict and a
decode LM behind /generate, one live HTTP endpoint; the gateway modes N
such replicas behind a ``ServingGateway``), runs the mode, writes the
``mxnet_tpu.slo.v1`` artifact, prints a one-screen summary, and exits
non-zero when the mode's own verdicts fail. The rig runs on the card
unless ``--device cpu`` is given, with the reference's tiny LM (head dim
8) by default; ``--lm bert-base`` serves a ``TransformerLM`` at BERT-base
widths (12 layers, 768 units, 12 heads, vocabulary 30522, max_len 512,
page size 16) in its place.
"""
from __future__ import annotations

import argparse
import json
import sys

# --lm: the decoder's widths (init_transformer_lm's), max_len and page size
LMS = {
    'tiny': None,
    'bert-base': dict(lm=dict(vocab=30522, units=768, hidden=3072,
                              layers=12, heads=12),
                      decode_max_len=512, decode_page_size=16),
}


def _write(path, doc):
    try:
        from ..resilience.checkpoint import atomic_write_bytes
        atomic_write_bytes(path, (json.dumps(
            doc, indent=1, sort_keys=True) + '\n').encode())
    except Exception:
        with open(path, 'w') as f:
            json.dump(doc, f, indent=1, sort_keys=True)


def _summary(doc):
    m = doc.get('metrics', {})
    if m.get('offered') is not None:
        lines = ['loadgen %s: offered=%s admitted=%s shed=%s '
                 'degraded=%s unresolved=%s'
                 % (doc['mode'], m.get('offered'), m.get('admitted'),
                    m.get('shed'), m.get('degraded'),
                    m.get('unresolved'))]
    else:
        lines = ['loadgen %s' % doc['mode']]
    lat = m.get('admitted_latency') or {}
    if lat.get('n'):
        lines.append('  admitted latency p50=%.1fms p99=%.1fms '
                     'p999=%.1fms'
                     % (lat['p50_ms'], lat['p99_ms'], lat['p999_ms']))
    shed = m.get('shed_latency') or {}
    if shed.get('n'):
        lines.append('  shed (429) latency p99=%.1fms, retry-after '
                     'advertised on %d' % (shed['p99_ms'],
                                           (m.get('retry_after') or
                                            {}).get('n', 0)))
    gen = m.get('generate') or {}
    if gen.get('n'):
        lines.append('  generate n=%d tokens=%d ttft_p99=%sms '
                     'tpot_p99=%sms'
                     % (gen['n'], gen['tokens'],
                        gen['ttft'].get('p99_ms'),
                        gen['tpot'].get('p99_ms')))
    if doc['mode'] == 'capacity':
        lines.append('  max_qps=%s (p99 < SLO, goodput >= floor)'
                     % (m.get('max_qps'),))
    if doc['mode'] == 'gateway-failover':
        lines.append('  resumed_streams=%s error_lines=%s '
                     'availability=%s'
                     % (m.get('resumed_streams'),
                        m.get('error_lines'),
                        m.get('availability')))
    if doc['mode'] == 'drain':
        lines.append('  migrated_streams=%s dest_prefill_delta=%s '
                     'error_lines=%s availability=%s drain_rc=%s'
                     % (m.get('migrated_streams'),
                        m.get('dest_prefill_delta'),
                        m.get('error_lines'), m.get('availability'),
                        (m.get('drain_result') or {}).get('rc')))
    if doc['mode'] == 'disagg':
        h = m.get('handoff') or {}
        lines.append('  handoffs=%s retries=%s fallbacks=%s '
                     'dest_prefill_delta=%s dest_imports=%s '
                     'ttft_p99=%sms availability=%s'
                     % (h.get('spliced'), h.get('retries'),
                        h.get('fallbacks'),
                        m.get('dest_prefill_delta'),
                        m.get('dest_imports'), m.get('ttft_p99_ms'),
                        m.get('availability')))
    if doc['mode'] == 'adapters':
        srv = (doc.get('server') or {}).get('generate') or {}
        pool = srv.get('adapters') or {}
        lines.append('  fleet=%s resident=%s loads=%s evictions=%s '
                     'sampled_tokens=%s retraced=%s'
                     % ((doc.get('config') or {}).get('adapter_fleet'),
                        pool.get('resident'), pool.get('loads'),
                        pool.get('evictions'),
                        srv.get('sampled_tokens'),
                        m.get('retraced_programs') or 'none'))
    if doc['mode'] == 'tenants':
        for tenant in ('steady', 'burst'):
            tm = m.get(tenant) or {}
            gen = tm.get('generate') or {}
            lines.append('  %-6s offered=%s served_ok=%s shed=%s '
                         'retried=%s ttft_p99=%sms'
                         % (tenant, tm.get('offered'),
                            tm.get('served_ok'), tm.get('shed'),
                            tm.get('retried'),
                            (gen.get('ttft') or {}).get('p99_ms')))
    for f in doc.get('faults', []):
        lines.append('  fault %-19s consumed=%s recovery=%ss'
                     % (f['kind'], f['consumed'], f['recovery_s']))
    for name, ok in (doc.get('verdicts') or {}).items():
        lines.append('  verdict %-28s %s'
                     % (name, 'OK' if ok else 'FAIL'))
    return '\n'.join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m mxnet_tpu_torch.loadgen',
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--mode', choices=('capacity', 'overload', 'chaos',
                                      'prefix', 'gateway-failover',
                                      'drain', 'tenants', 'disagg',
                                      'adapters'),
                   default='overload')
    p.add_argument('--out', default='SLO.json')
    p.add_argument('--seed', type=int, default=None,
                   help='schedule seed (default: '
                        'MXNET_TPU_LOADGEN_SEED)')
    p.add_argument('--qps', type=float, default=None,
                   help='chaos: sustained offered rate; '
                        'capacity/overload: ramp start rate')
    p.add_argument('--duration', type=float, default=None,
                   help='overload/chaos soak length in seconds')
    p.add_argument('--factor', type=float, default=2.5,
                   help='overload: offered rate as a multiple of '
                        'measured capacity')
    p.add_argument('--capacity-qps', type=float, default=None,
                   help='overload: skip the probe and take capacity '
                        'as given')
    p.add_argument('--slo-ms', type=float, default=None,
                   help='admitted-request p99 budget (default: '
                        'MXNET_TPU_SLO_P99_MS)')
    p.add_argument('--no-generate', action='store_true',
                   help='predict-only rig (faster build; no decode '
                        'legs)')
    p.add_argument('--full', action='store_true',
                   help='long soak: 4x the default windows/durations')
    p.add_argument('--device', default=None,
                   help='where the rig serves: cuda (default) or cpu')
    p.add_argument('--lm', choices=sorted(LMS), default='tiny',
                   help='the /generate LM: the reference\'s tiny one '
                        '(default) or BERT-base widths')
    args = p.parse_args(argv)

    from .harness import GatewayRig, ServingRig, run_adapters, \
        run_capacity, run_chaos, run_disagg, run_drain, \
        run_gateway_failover, run_overload, run_prefix, run_tenants
    from .harness import _knob
    seed = args.seed if args.seed is not None \
        else int(_knob('MXNET_TPU_LOADGEN_SEED', 0))
    slo_s = (args.slo_ms / 1e3) if args.slo_ms is not None else None
    # --lm and --device under every mode's own settings (they win)
    wide = dict(LMS[args.lm] or {}, device=args.device)

    def serving_rig(**kw):
        return ServingRig(**dict(wide, **kw))

    def gateway_rig(**kw):
        return GatewayRig(**dict(wide, **kw))

    scale = 4.0 if args.full else 1.0
    # mix=None lets each mode pick its own default (chaos soaks on
    # mostly-cheap traffic, capacity/overload weight the expensive
    # decode workload the SLO guards)
    mix = {'predict': 1.0} if args.no_generate else None

    if args.mode in ('prefix', 'gateway-failover', 'drain',
                     'tenants', 'disagg', 'adapters') \
            and args.no_generate:
        raise SystemExit('--mode %s needs the generate rig'
                         % args.mode)
    if args.mode == 'adapters':
        # multi-adapter Zipf workload: 8 LoRA artifacts + the base
        # row baked into one compiled signature; a deeper queue keeps
        # replica-side 429s out of the zero-retrace/TTFT signal
        rig = serving_rig(predict=False, adapter_fleet=8,
                          decode_max_queue=16)
    elif args.mode == 'prefix':
        # bigger prefill bucket: the shared-prefix workload carries
        # page-aligned system prompts + a one-token suffix
        rig = serving_rig(decode_prefill_buckets=(32,))
    elif args.mode == 'gateway-failover':
        # long generations (the kill must land MID-stream), a prefill
        # bucket wide enough for prompt+emitted re-admission, and a
        # full (non-oversubscribed) page pool — this drill gates
        # failover, the chaos squeeze gates pool exhaustion
        rig = gateway_rig(replicas=2, health_period_s=0.25,
                          predict=False, slots=4, max_new_tokens=48,
                          decode_max_queue=16,
                          decode_prefill_buckets=(64,),
                          decode_max_len=128, decode_pages=64)
    elif args.mode == 'drain':
        # graceful-drain drill: slots >= streams so EVERY stream is
        # active when the drain fires (a queued sequence exports cold
        # and would re-prefill on import — gated against); a full
        # page pool on each replica so the survivor can absorb all 8
        # imported sequences' pages on top of its own traffic
        rig = gateway_rig(replicas=2, health_period_s=0.25,
                          predict=False, slots=8, max_new_tokens=48,
                          decode_max_queue=16,
                          decode_prefill_buckets=(64,),
                          decode_max_len=128, decode_pages=128)
    elif args.mode == 'disagg':
        # disaggregated topology: two prefill-class + two decode-class
        # replicas so one of EACH class can be hard-killed mid-run
        # with a survivor left per class. Full page pools: every
        # stream's KV pages travel prefill -> decode in the seqstate
        # payload and must land without eviction pressure
        rig = gateway_rig(replicas=4,
                          classes=('prefill', 'prefill',
                                   'decode', 'decode'),
                          health_period_s=0.25, predict=False,
                          slots=8, max_new_tokens=24,
                          decode_max_queue=16,
                          decode_prefill_buckets=(64,),
                          decode_max_len=128, decode_pages=128,
                          gateway_kwargs=dict(handoff_timeout_s=10.0,
                                              handoff_retries=2))
    elif args.mode == 'tenants':
        # two-tenant burst phase: per-tenant buckets sized so the
        # steady lane never touches its budget while the burst lane
        # blows through; deep replica queues keep replica-side 429s
        # out of the tenant-isolation signal
        rig = gateway_rig(replicas=2, health_period_s=0.25,
                          predict=False, slots=4, decode_max_queue=16,
                          gateway_kwargs=dict(tenant_rps=8.0,
                                              tenant_burst=8.0,
                                              tenant_max_inflight=32))
    else:
        rig = serving_rig(generate=not args.no_generate)
    try:
        if args.mode == 'adapters':
            doc = run_adapters(rig, qps=args.qps or 10.0,
                               duration_s=(args.duration
                                           or 4.0 * scale),
                               seed=seed)
        elif args.mode == 'prefix':
            doc = run_prefix(rig, qps=args.qps or 12.0,
                             duration_s=(args.duration
                                         or 4.0 * scale),
                             seed=seed)
        elif args.mode == 'gateway-failover':
            doc = run_gateway_failover(rig, streams=8, seed=seed)
        elif args.mode == 'drain':
            doc = run_drain(rig, streams=8, seed=seed)
        elif args.mode == 'disagg':
            doc = run_disagg(rig, streams=8, seed=seed)
        elif args.mode == 'tenants':
            doc = run_tenants(rig,
                              duration_s=(args.duration
                                          or 4.0 * scale),
                              seed=seed)
        elif args.mode == 'capacity':
            doc = run_capacity(
                rig, slo_s=slo_s, mix=mix, seed=seed,
                start_qps=args.qps or 16.0,
                window_s=1.5 * scale,
                bisect_iters=3 if not args.full else 5)
        elif args.mode == 'overload':
            doc = run_overload(
                rig, factor=args.factor,
                duration_s=(args.duration or 3.0 * scale),
                slo_s=slo_s, mix=mix, seed=seed,
                start_qps=args.qps or 16.0,
                probe_window_s=1.0 * scale,
                capacity_qps=args.capacity_qps)
        else:
            doc = run_chaos(
                rig, qps=args.qps or 20.0,
                duration_s=(args.duration or 12.0 * scale),
                mix=mix, seed=seed)
    finally:
        rig.close()
    _write(args.out, doc)
    print(_summary(doc), flush=True)
    ok = doc.get('ok', True)
    print('loadgen %s: %s -> %s'
          % (doc['mode'], 'OK' if ok else 'FAIL', args.out),
          flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
