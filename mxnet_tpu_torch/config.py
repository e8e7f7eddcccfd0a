"""Knobs of the port, the counterpart of ``mxnet_tpu/config.py``.

The port keeps its own copy of the knobs its paths read: the
``MXNET_TPU_SERVE_*`` knobs of the serving paths (the decode engine, and
the one-shot freeze and micro-batcher) and ``MXNET_TPU_AMP`` of the
training step, with the JAX package's names, defaults and parsing (read
from the environment). Constructor arguments always win over a knob.
There is no kernel on/off knob: on a CUDA tensor the kernel runs.

Parsing is the reference's (``Knob.parse`` and ``get``,
``mxnet_tpu/config.py:44-47, 729-738``): an unset variable gives the
default; a set one is parsed as it stands, unstripped. A bool knob is
False for ``'0'``, ``''``, ``'false'`` and ``'False'`` and True for
anything else (``' 0'`` is True); an int or float knob raises
``ValueError`` on ``''``.

The paged-cache knobs (``MXNET_TPU_SERVE_PAGED`` to
``MXNET_TPU_SERVE_SPEC_DRAFT``, the path of a saved decode artifact a
session loads as its speculative draft) are here, and the HTTP
endpoint's: ``MXNET_TPU_SERVE_HTTP_PORT`` (0, the default, keeps it off)
and ``MXNET_TPU_SERVE_MAX_CONCURRENT``. The sampling and adapter knobs
(``MXNET_TPU_SERVE_SAMPLE_ARGS`` to ``MXNET_TPU_SERVE_ADAPTER_DIR``) carry
the reference's defaults and help text: every decode program compiles the
sampling inputs in unless told otherwise.

The resilience knobs carry the reference's names, defaults and help:
``MXNET_TPU_FAULT`` scripts faults (``resilience.policy.get_injector``
re-parses it when it changes; the serving sites are ``serving.decode``,
``serving`` and ``serving.infer``), ``MXNET_TPU_SERVE_BREAKER`` is the
session breaker's failure threshold, and ``MXNET_TPU_WATCHDOG_COMPILE_S``,
``_STEP_S``, ``_COLLECTIVE_S`` and ``_POLL_S`` are the stall watchdog's
budgets and its monitor's poll (a serving session's watchdog holds each
device call to ``_STEP_S``). The drain and preemption knobs are the reference's too:
``MXNET_TPU_SERVE_DRAIN_TIMEOUT_S`` bounds a draining endpoint's handoff
window, ``MXNET_TPU_PREEMPT_EXIT_CODE`` is the resumable exit code (75)
and ``MXNET_TPU_PREEMPT_GRACE_S`` a preemption drain's budget. The
trainer's: ``MXNET_TPU_CKPT_EVERY_N_STEPS`` (the checkpoint cadence of
``attach_checkpointing``), ``MXNET_TPU_CKPT_KEEP`` (what a
``CheckpointManager`` keeps when not told), ``MXNET_TPU_ELASTIC`` (a resume
from a larger mesh's checkpoint by accumulation, or a refusal) and
``MXNET_PROFILER_AUTOSTART`` (the profiler started when the package is
imported).

The observability knobs (``MXNET_TPU_TELEMETRY``, the metrics registry's
switch, on by default; ``MXNET_TPU_TELEMETRY_HTTP_PORT``, the ``/metrics``
server's port, 0 for none; ``MXNET_TPU_FLIGHT``, ``_CAPACITY`` and
``_PATH``, the flight recorder's switch, ring size and dump path;
``MXNET_TPU_TRACE`` and ``MXNET_TPU_TRACE_BUFFER``, request tracing and its
span buffer) and the serving gateway's fifteen
``MXNET_TPU_GATEWAY_*`` knobs carry the reference's names, types,
defaults and help, as do the load harness's (``mxnet_tpu_torch.loadgen``):
the thirteen ``MXNET_TPU_SLO_*`` budgets its modes judge by and the five
``MXNET_TPU_LOADGEN_*`` knobs (the schedule's seed, the overload rate's
ceiling, the client's in-flight bound, its retries and their cap).
"""
from __future__ import annotations

import os

__all__ = ['KNOBS', 'get']

# name -> (type, default, doc)
KNOBS = {
    'MXNET_TPU_SERVE_MAX_BATCH': (
        int, 64, 'Largest micro-batch; also the default top of the '
        'batch bucket ladder.'),
    'MXNET_TPU_SERVE_DEADLINE_MS': (
        float, 5.0, 'Micro-batch flush deadline: the oldest queued '
        'request waits at most this long for batch-mates.'),
    'MXNET_TPU_SERVE_BUCKETS': (
        str, None, 'Explicit batch bucket ladder as a comma list '
        '(e.g. "1,8,32,64"); unset derives powers of two up to '
        'MXNET_TPU_SERVE_MAX_BATCH.'),
    'MXNET_TPU_SERVE_QUEUE_DEPTH': (
        int, 256, 'Admission bound on pending requests; a submit against '
        'a full queue raises BackpressureError.'),
    'MXNET_TPU_SERVE_TIMEOUT_S': (
        float, 30.0, 'Per-request budget: older requests fail with '
        'RequestTimeout; 0 disables.'),
    'MXNET_TPU_SERVE_DRAIN_TIMEOUT_S': (
        float, 30.0, 'Graceful-drain handoff budget: a draining replica '
        'waits this long for every exported seqstate payload to be fetched '
        '(or readmitted) before the drain result records expired.'),
    'MXNET_TPU_SERVE_DECODE_SLOTS': (
        int, 8, 'In-flight sequence slots of the continuous decode '
        'batch; the slot KV cache is slots x max_len.'),
    'MXNET_TPU_SERVE_MAX_SEQ_LEN': (
        int, 256, 'Per-slot cache capacity of a decode program frozen '
        'from gluon RNN blocks: prompt + generated tokens a sequence '
        'never exceed this.'),
    'MXNET_TPU_SERVE_PREFILL_BUCKETS': (
        str, None, 'Explicit prompt-length bucket ladder as a comma '
        'list; unset derives powers of two up to '
        'MXNET_TPU_SERVE_MAX_PREFILL.'),
    'MXNET_TPU_SERVE_MAX_PREFILL': (
        int, 64, 'Default top of the prefill ladder: the longest '
        'admissible prompt.'),
    'MXNET_TPU_SERVE_MAX_NEW_TOKENS': (
        int, 64, 'Default generation budget per request.'),
    'MXNET_TPU_SERVE_PREFILL_INTERLEAVE': (
        int, 1, 'Prefills admitted between consecutive decode steps '
        'while sequences are in flight.'),
    'MXNET_TPU_SERVE_PAGED': (
        bool, True, 'Serve decode families that support it '
        '(transformers) from the paged KV cache: one page pool shared by '
        'the sequences plus a page table each, instead of slots x max_len '
        'rows reserved per slot. 0 keeps the slot cache.'),
    'MXNET_TPU_SERVE_PAGE_SIZE': (
        int, 16, 'KV rows per page of the paged decode cache (a power of '
        'two).'),
    'MXNET_TPU_SERVE_PAGES': (
        int, 0, 'Pages of the pool, the reserved trash page included. 0 '
        'sizes it to the slot cache\'s worst case (slots x max_pages + 1); '
        'a smaller pool trades capacity for memory, and admission then '
        'fails typed (BackpressureError) when the pool is exhausted.'),
    'MXNET_TPU_SERVE_PREFIX_CACHE': (
        bool, True, 'Share common prompt prefixes in the paged cache: '
        'full (and exactly matching partial) prompt pages are refcounted '
        'and referenced read-only by later prompts that walk the same '
        'tokens, copied on write at the first divergent token. 0 '
        'disables sharing.'),
    'MXNET_TPU_SERVE_SPEC_K': (
        int, 0, 'Speculative-decoding lookahead: the draft proposes this '
        'many tokens a tick and the target verifies them in one pass '
        '(greedy acceptance). 0 disables speculation; needs a paged '
        'target and a draft program.'),
    'MXNET_TPU_SERVE_SPEC_DRAFT': (
        str, None, 'Path to a frozen decode artifact to load as the'
        ' speculative-decoding draft model (same vocab as the target;'
        ' transformer family, so rejected proposals roll back for free;'
        ' frozen SLOT-addressed, paged=False \u2014 a draft-sized cache has'
        ' no memory wall to page). Unset = no speculation unless a draft'
        ' is passed programmatically.'),
    'MXNET_TPU_SERVE_HTTP_PORT': (
        int, 0, 'Port for the stdlib JSON inference endpoint (/predict,'
        ' /generate, /status, /healthz; binds 127.0.0.1). 0 (default)'
        ' keeps the server off \u2014 production fronts the engine with a'
        ' real gateway.'),
    'MXNET_TPU_SERVE_MAX_CONCURRENT': (
        int, 0, 'Cap on in-flight HTTP POST handlers (one thread per'
        ' connection): past it requests shed instantly with 429 +'
        ' Retry-After instead of piling scheduling contention onto'
        ' admitted requests. 0 (default) = unbounded, the pre-harness'
        ' behavior; production fronts set it to a small multiple of the'
        ' batch/slot capacity.'),
    'MXNET_TPU_SERVE_SAMPLE_ARGS': (
        bool, True, 'Compile temperature/top-p/PRNG-key sampling as '
        'fixed-shape ARRAY arguments of the one decode step: greedy and '
        'sampled requests share the same executable (temperature 0 stays '
        'byte-identical to the greedy-only program). 0 freezes the '
        'pre-sampling signature -- old artifacts load either way.'),
    'MXNET_TPU_SERVE_SAMPLE_MASK': (
        bool, False, 'Also compile the per-request additive logit-mask '
        'argument (grammar/JSON constrained decoding hook): a (rows, vocab) '
        'float32 mask added to logits before sampling. Costs slots x vocab '
        'of transfer per step when used; off by default.'),
    'MXNET_TPU_SERVE_ADAPTER_RANK': (
        int, 0, 'Low-rank adapter (LoRA) pool rank compiled into the decode '
        'step: per-request A/B deltas gather from a device-resident pool '
        'inside the ONE compiled program, so adapter switches are int32 '
        'array-arg changes (zero retraces). 0 (default) freezes the '
        'base-only signature.'),
    'MXNET_TPU_SERVE_ADAPTER_SLOTS': (
        int, 8, 'Device-resident adapter pool capacity (rows, incl. the '
        'reserved all-zero base row 0): how many LoRA variants can serve '
        'concurrently. Unpinned rows evict LRU on a cold load; with every '
        'row pinned a new adapter admission rejects typed '
        '(AdapterExhaustedError, shed/retry).'),
    'MXNET_TPU_SERVE_ADAPTER_DIR': (
        str, None, 'Artifact-directory root the decode engine\'s adapter '
        'registry resolves unknown adapter ids against: <dir>/<id> must '
        'hold a mxnet_tpu.adapter.v1 artifact (loaded lazily on first use, '
        'digest-verified). Unset = only programmatically registered '
        'adapters resolve.'),
    'MXNET_TPU_SERVE_BREAKER': (
        int, 3, 'Consecutive device-side batch failures before the serving '
        'circuit breaker opens and batches go straight to the CPU fallback '
        'until the reset probe succeeds.'),
    'MXNET_TPU_FAULT': (
        str, None, 'Scripted fault injection: comma list of '
        'kind[@site][:count] (device_unavailable, tunnel_stall, '
        'worker_crash, preempt, hang, device_loss, and the value kinds '
        'nan/inf, e.g. nan@grads:2 for the guardrail or '
        'preempt@train.step.12:1 to preempt exactly at step 12). CI and '
        'tests only; leave unset in production.'),
    'MXNET_TPU_PREEMPT_EXIT_CODE': (
        int, 75, 'Process exit code marking a preempted-but-resumable run '
        '(75 = BSD EX_TEMPFAIL). Launchers restart the same command on this '
        'rc; any other non-zero rc is a real failure.'),
    'MXNET_TPU_PREEMPT_GRACE_S': (
        float, 30.0, 'Drain budget after a SIGTERM/SIGINT: the emergency '
        'checkpoint must finish within this many seconds (the preemption '
        'notice-to-reclaim window).'),
    'MXNET_TPU_CKPT_EVERY_N_STEPS': (
        int, 0, 'Step-granular checkpoint cadence for ParallelTrainer when '
        'a CheckpointManager is attached without every_n; 0 checkpoints '
        'only when asked (and at a preemption drain).'),
    'MXNET_TPU_CKPT_KEEP': (
        int, 2, 'How many step-granular checkpoints CheckpointManager '
        'retains when built without keep= (keep=N pruning; the newest that '
        'validates wins at resume).'),
    'MXNET_TPU_ELASTIC': (
        bool, True, 'Allow a restart that sees fewer devices than the '
        'checkpoint mesh to shrink the dp axis and preserve the global '
        'batch via gradient accumulation; 0 makes a device-count mismatch '
        'a hard error.'),
    'MXNET_PROFILER_AUTOSTART': (
        bool, False, 'Start the profiler at import.'),
    'MXNET_TPU_WATCHDOG_COMPILE_S': (
        float, 1800.0, 'Watchdog stall budget (seconds) for the compile '
        'phase (first-program XLA compiles legitimately take minutes).'),
    'MXNET_TPU_WATCHDOG_STEP_S': (
        float, 300.0, 'Watchdog stall budget for a dispatched compiled '
        'step.'),
    'MXNET_TPU_WATCHDOG_COLLECTIVE_S': (
        float, 600.0, 'Watchdog stall budget for host-side collectives '
        '(kvstore dist push/pull/barrier).'),
    'MXNET_TPU_WATCHDOG_POLL_S': (
        float, 10.0, 'Poll cadence of the background watchdog monitor '
        'thread.'),
    'MXNET_TPU_TELEMETRY': (
        bool, True,
        'Master switch for the unified telemetry layer (metrics registry + '
        'step-phase spans + flight recorder). 0 turns every instrument into'
        ' a flag-check no-op with no per-step allocation.'),
    'MXNET_TPU_TELEMETRY_HTTP_PORT': (
        int, 0,
        'Port for the stdlib Prometheus /metrics HTTP endpoint (binds '
        '127.0.0.1). 0 (default) keeps the server off; production scrapes '
        'tail the file exporter instead.'),
    'MXNET_TPU_FLIGHT': (
        bool, True,
        'Flight recorder enable (subordinate to MXNET_TPU_TELEMETRY): keep a'
        ' bounded ring of structured run events and dump a '
        'mxnet_tpu.flight.v1 JSONL artifact on crash / stall / preemption.'),
    'MXNET_TPU_FLIGHT_CAPACITY': (
        int, 2048,
        'Flight recorder ring size (events); the oldest events drop when '
        'full.'),
    'MXNET_TPU_FLIGHT_PATH': (
        str, 'FLIGHT.jsonl',
        'Default dump path for the flight-recorder artifact.'),
    'MXNET_TPU_TRACE': (
        bool, False,
        'Distributed request tracing enable (off by default): carry a trace'
        ' context across gateway/replica hops in the X-Mxnet-Trace header '
        'and emit mxnet_tpu.trace.v1 span records into the bounded '
        'per-process span buffer served at GET /trace.'),
    'MXNET_TPU_TRACE_BUFFER': (
        int, 4096,
        'Span-buffer capacity per process (records); the oldest spans drop '
        'when full.'),
    'MXNET_TPU_GATEWAY_PORT': (
        int, 0,
        'Default port for the multi-replica serving gateway when '
        'ServingGateway(port=None) (binds 127.0.0.1; 0 picks a free port).'),
    'MXNET_TPU_GATEWAY_HEALTH_S': (
        float, 1.0,
        "Gateway health-probe cadence: each replica's /healthz is polled "
        'this often; non-200 (or unreachable) replicas leave the routing '
        'rotation until they recover.'),
    'MXNET_TPU_GATEWAY_TIMEOUT_S': (
        float, 30.0,
        'Per-request budget for a gateway-forwarded upstream call; an '
        'unreachable replica fails over to the next healthy one, and an '
        'all-replicas-down gateway answers typed 503.'),
    'MXNET_TPU_GATEWAY_RESUME': (
        bool, True,
        'Mid-stream failover for /generate: the gateway journals every '
        'streamed token and, when a replica dies mid-stream, re-admits the '
        'request on a healthy replica with prompt+emitted-tokens as the new'
        ' prefix, splicing the resumed tokens into the SAME client NDJSON '
        'stream (at-most-once per token index). 0 restores the pre-resume '
        'behavior: typed abort line / cut connection.'),
    'MXNET_TPU_GATEWAY_RESUME_MAX': (
        int, 2,
        'Bounded resume attempts per stream: after this many mid-stream '
        'failovers the gateway stops retrying and emits the typed '
        'ReplicaLost abort line (partial tokens attached), ending the '
        'chunked stream cleanly.'),
    'MXNET_TPU_GATEWAY_AFFINITY': (
        bool, True,
        'Prefix-affine /generate routing: rendezvous-hash the prompt-prefix'
        ' fingerprint over the healthy replica set so a shared system '
        'prompt keeps landing on the replica whose PrefixCache already '
        'holds it (resume targets prefer the prefix owner too). 0 = plain '
        'round-robin.'),
    'MXNET_TPU_GATEWAY_TENANT_HEADER': (
        str, 'X-Tenant',
        'Request header naming the tenant for per-tenant admission at the '
        'gateway; requests without it share the "default" tenant bucket.'),
    'MXNET_TPU_GATEWAY_TENANT_RPS': (
        float, 0.0,
        'Per-tenant token-bucket refill rate (requests/second) at the '
        'gateway: past it a tenant sheds typed 429s with a Retry-After '
        "naming when its bucket refills, so one tenant's burst cannot "
        'starve the pool. 0 (default) disables rate admission.'),
    'MXNET_TPU_GATEWAY_TENANT_BURST': (
        float, 0.0,
        'Per-tenant token-bucket depth (burst allowance). 0 derives it as '
        'max(1, 2x MXNET_TPU_GATEWAY_TENANT_RPS).'),
    'MXNET_TPU_GATEWAY_TENANT_MAX_INFLIGHT': (
        int, 0,
        'Gateway-wide in-flight request cap shared weighted-fair across '
        'active tenants: a tenant may exceed its 1/k share only while the '
        'pool has slack, so a burst queues behind its own share, not '
        "everyone's. 0 = unbounded."),
    'MXNET_TPU_GATEWAY_JOURNAL_MAX': (
        int, 0,
        'Per-stream resume-journal cap (tokens): past it the journal '
        'degrades to the relayed COUNT — a later resume re-admits the '
        'ORIGINAL prompt and greedy determinism + index dedup re-derive the'
        ' delivered prefix. 0 = unbounded journal.'),
    'MXNET_TPU_GATEWAY_CLASS_MAP': (
        str, '',
        'Disaggregated replica classes as "url=class,url=class" (class in '
        'prefill|decode|both): a prefill replica takes /generate admissions'
        ' and exports seqstate at the prefill boundary, a decode replica '
        'takes the POST /import step loop. Any replica declaring a role '
        'makes the gateway disaggregated; unlisted replicas stay "both". '
        'Explicit ServingGateway(classes=...) entries override this map.'),
    'MXNET_TPU_GATEWAY_HANDOFF_TIMEOUT_S': (
        float, 10.0,
        'Per-attempt budget for the prefill->decode seqstate handoff POST '
        '/import: past it the attempt counts against '
        'MXNET_TPU_GATEWAY_HANDOFF_RETRIES and the payload goes to the next'
        ' decode-class member.'),
    'MXNET_TPU_GATEWAY_HANDOFF_RETRIES': (
        int, 2,
        'Bounded handoff retries per prefill-boundary export: refusals '
        '(pool pressure, geometry/version checks) and dead decode targets '
        'each consume one; past the budget the request falls back '
        'MONOLITHIC on the prefill class — never dropped.'),
    'MXNET_TPU_GATEWAY_DISAGG_MIN_PROMPT': (
        int, 0,
        'Prompt-length threshold (tokens) for the disaggregated path: '
        'prompts at/above it admit prefill_only on the prefill class and '
        'hand their seqstate to the decode class; shorter prompts run '
        'monolithically ON the prefill class (the decode class only ever '
        'imports). 0 disaggregates every streamed /generate.'),
    'MXNET_TPU_SLO_P99_MS': (
        float, 500.0,
        'Admitted-request p99 latency budget (ms) the load harness gates '
        'on: capacity search bisects the max QPS holding it, overload '
        'mode asserts admission control protects it at 2.5x capacity. '
        'SLO_BASELINE.json overrides it in CI.'),
    'MXNET_TPU_SLO_SHED_P99_MS': (
        float, 250.0,
        'p99 budget (ms) for SHED responses: a 429 must be a fast '
        'rejection, not a slow timeout — overload mode fails when '
        'shedding itself is slow.'),
    'MXNET_TPU_SLO_AVAILABILITY': (
        float, 0.85,
        'Chaos-soak availability floor: fraction of offered requests that'
        ' must be ADMITTED (2xx, degraded allowed) while scripted faults '
        'fire. Sheds (429) count as unavailable — the floor prices how '
        'much shedding the degraded paths are allowed to need.'),
    'MXNET_TPU_SLO_RECOVERY_S': (
        float, 12.0,
        'Per-fault recovery ceiling (seconds): after a scripted fault '
        'burst clears, /status must report every session ok with its '
        'breaker closed within this budget.'),
    'MXNET_TPU_SLO_PREFIX_TTFT_P99_MS': (
        float, 400.0,
        'TTFT p99 budget (ms) for the shared-prefix loadgen workload '
        '(mxnet_tpu.loadgen --mode prefix): Zipf-distributed system '
        'prompts + one-token suffixes against the paged decode engine '
        'with prefix sharing on. SLO_BASELINE.json prefix_ttft_p99_ms '
        'overrides it in the slo CI stage.'),
    'MXNET_TPU_SLO_GOODPUT': (
        float, 0.9,
        'Capacity-search goodput floor: fraction of offered requests '
        'served clean (200, no typed error) a rate must sustain to count '
        'as within capacity.'),
    'MXNET_TPU_SLO_GATEWAY_AVAILABILITY': (
        float, 0.99,
        'Availability floor for the gateway-failover drill '
        '(mxnet_tpu.loadgen --mode gateway-failover): fraction of streams'
        ' that must complete CLEAN — zero error lines — while a replica '
        'is killed mid-stream and the gateway resumes them on the '
        'survivors.'),
    'MXNET_TPU_SLO_TENANT_TTFT_P99_MS': (
        float, 400.0,
        'Steady-tenant TTFT p99 budget (ms) for the two-tenant burst '
        'phase (--mode tenants): while another tenant bursts past its '
        "bucket, the steady tenant's time to first token must stay inside"
        ' this budget (zero cross-tenant SLO bleed).'),
    'MXNET_TPU_SLO_TENANT_TPOT_P99_MS': (
        float, 250.0,
        'Steady-tenant TPOT p99 budget (ms) for the two-tenant burst '
        "phase: per-output-token latency of the steady tenant's admitted "
        "streams under a neighbor's burst."),
    'MXNET_TPU_SLO_DRAIN_AVAILABILITY': (
        float, 1.0,
        'Availability floor for the drain drill (--mode drain): a '
        'GRACEFUL preemption loses nothing, so the default demands every '
        'stream completes clean.'),
    'MXNET_TPU_SLO_DISAGG_AVAILABILITY': (
        float, 0.99,
        'Availability floor for the disaggregated prefill/decode drill '
        '(--mode disagg): fraction of mixed long/short streams that must '
        'complete CLEAN while one replica of EACH class is hard-killed '
        'mid-run.'),
    'MXNET_TPU_SLO_DISAGG_TTFT_P99_MS': (
        float, 2500.0,
        "TTFT p99 budget (ms) for the disagg drill's mixed workload: time"
        ' to first token INCLUDING the prefill-class admission (the '
        'boundary token streams from the prefill replica before the '
        'handoff completes).'),
    'MXNET_TPU_SLO_ADAPTER_TTFT_P99_MS': (
        float, 600.0,
        'TTFT p99 budget (ms) for the multi-adapter loadgen workload '
        '(--mode adapters): Zipf-distributed adapter ids + sampled/greedy'
        ' mix against one engine — admissions pay at most one adapter '
        'pool upload, never a retrace. SLO_BASELINE.json '
        'adapter_ttft_p99_ms overrides it in the slo CI stage.'),
    'MXNET_TPU_LOADGEN_SEED': (
        int, 0,
        'Default seed for the open-loop arrival schedule '
        '(mxnet_tpu.loadgen): same seed, same arrival times and request '
        'kinds — load runs are replayable.'),
    'MXNET_TPU_LOADGEN_MAX_QPS': (
        float, 100.0,
        'Ceiling on the offered rate overload mode will drive: past '
        "O(100) connections/s the stdlib endpoint's accept loop (kernel "
        'SYN queue) owns the latency on a small host, and the harness '
        'gates admission control, not the accept path. Raise it when '
        'fronting with a real gateway.'),
    'MXNET_TPU_LOADGEN_MAX_INFLIGHT': (
        int, 512,
        'Client-side bound on concurrently in-flight harness requests '
        '(one thread each). An arrival above the bound resolves as '
        'client_saturated — counted against goodput, never silently '
        'dropped.'),
    'MXNET_TPU_LOADGEN_RETRIES': (
        int, 0,
        'Loadgen client retry budget on 429/503: each retry honors the '
        "server's Retry-After (capped by MXNET_TPU_LOADGEN_RETRY_CAP_S) "
        'before re-firing, and the record counts its retries in the '
        'taxonomy. 0 (default) keeps the one-shot open-loop behavior the '
        'overload verdicts are calibrated on.'),
    'MXNET_TPU_LOADGEN_RETRY_CAP_S': (
        float, 2.0,
        'Ceiling on a single loadgen retry backoff sleep: a Retry-After '
        'above it is clamped so a mis-advertised hint cannot stall the '
        'harness.'),
    'MXNET_TPU_AMP': (
        str, None, "Default AMP policy ('bf16' | 'fp16' | 'off') for "
        'ParallelTrainer / Module.fit / gluon Trainer when no explicit '
        'amp= is passed. Low-precision compute copies are cast inside the '
        'compiled step; fp32 master weights, optimizer state, guardrail '
        'sentinel and checkpoints stay float32 (bit-exact resume). '
        "'fp16' auto-enables the dynamic-loss-scaling guardrail. Unset/off "
        'keeps every program float32, byte-identical to pre-AMP builds.'),
}


def _parse(typ, raw):
    if typ is bool:
        return raw not in ('0', '', 'false', 'False')
    return typ(raw)


def get(name):
    """Typed value of knob ``name``: the environment's, parsed as it
    stands, else (unset) the default."""
    typ, default, _doc = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    return _parse(typ, raw)
