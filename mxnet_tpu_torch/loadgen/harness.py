"""The open-loop load and chaos harness over a live
``ServingHTTPServer``, the port of ``mxnet_tpu/loadgen/harness.py``.

The rig builds the real serving stack in-process -- a frozen MLP behind
``/predict`` and a decode session streaming NDJSON behind ``/generate``,
one HTTP endpoint fronting both, on the card unless the caller passes
``device='cpu'`` -- then drives it over real sockets from a precomputed
open-loop schedule (:mod:`.schedule`): arrivals never wait for
completions, so overload shows up as measured latency and 429s. Modes:

  * **capacity** -- ramp the offered QPS, then bisect the highest rate
    where p99 of ADMITTED requests stays under the SLO budget and goodput
    over the floor;
  * **overload** -- offer a multiple (default 2.5x) of the measured
    capacity: the admitted tail inside the budget, the excess as FAST
    429s with Retry-After;
  * **chaos** -- sustained mixed traffic while the port's FaultInjector
    scripts device_unavailable bursts, tunnel stalls, a worker crash and a
    preemption; availability floor, recovery ceiling per fault, zero hang,
    no leaked slot, then the paged pool squeezed past exhaustion;
  * **prefix**, **adapters** -- the shared-prefix and the Zipf
    multi-adapter workloads;
  * over a :class:`GatewayRig` (N rigs behind the port's
    ``ServingGateway``): **gateway-failover**, **drain**, **disagg** and
    **tenants**, the first and third traced end to end
    (:func:`_trace_drill` stitches the gateway's and every replica's span
    buffer).

Every mode returns a versioned ``mxnet_tpu.slo.v1`` artifact
(:mod:`.report`). The port's differences: the ``/predict`` MLP is the
reference's network built from the port's gluon and trained one epoch in
plain torch (its weights are not the reference's: those come from a JAX
key); ``ServingRig`` takes ``device``, and ``lm`` / ``decode_page_size``
(default: the reference's tiny LM, head dim 8, page size 8, on the card as
on the CPU) for a wider decoder; the
adapters mode's "zero retraces" reads the programs built
(``compile_seconds``), since nothing is traced here.
"""
from __future__ import annotations

import os
import threading
import time

from ..serving.batcher import BackpressureError
from .client import LoadClient, RequestRecord
from .report import build_artifact, summarize
from .schedule import build_schedule

__all__ = ['ServingRig', 'GatewayRig', 'Dispatcher', 'run_capacity',
           'run_overload', 'run_chaos', 'run_prefix',
           'run_gateway_failover', 'run_drain', 'run_disagg',
           'run_tenants', 'DEFAULT_MIX', 'OVERLOAD_MIX']

# chaos soak: mostly-cheap traffic keeps the soak itself off the
# host's critical path while faults fire
DEFAULT_MIX = {'predict': 0.7, 'generate': 0.3}
# capacity/overload: weight the EXPENSIVE workload (streamed decode,
# the engine the SLO guards) so the measured capacity is the decode
# engine's, not the stdlib accept loop's
OVERLOAD_MIX = {'predict': 0.3, 'generate': 0.7}

# chaos fault script: (fraction of soak when injected, fault kind,
# MXNET_TPU_FAULT spec). Sites: 'serving' fires per one-shot batch,
# 'serving.decode' per decode device call; counts bound each burst so
# the injector drains and recovery can be timed.
CHAOS_SCRIPT = (
    (0.10, 'device_unavailable',
     'device_unavailable@serving:3,device_unavailable@serving.decode:1'),
    (0.32, 'tunnel_stall',
     'tunnel_stall@serving:2,tunnel_stall@serving.decode:1'),
    (0.50, 'worker_crash', 'worker_crash@serving.decode:1'),
    (0.64, 'preempt', 'preempt@serving.decode:1'),
)

FEATURES = 8
CLASSES = 4
_VOCAB = 23
# the reference's /generate LM (init_transformer_lm's widths)
TINY_LM = dict(vocab=_VOCAB, units=16, hidden=24, layers=1, heads=2)


def _knob(name, default):
    try:
        from .. import config as _config
        v = _config.get(name)
        return default if v is None else v
    except Exception:
        return default


def _build_frozen(device=None):
    """Deterministic tiny MLP, trained one epoch, frozen: the /predict
    workload, the reference's network (FullyConnected 16, relu,
    FullyConnected 4, softmax) from the port's gluon. Initial weights
    uniform in +-0.01 from numpy seed 3 (``Module``'s default
    ``Uniform(0.01)``), biases 0; one epoch of 4 batches of 8 from
    ``RandomState(0)``, SGD lr 0.1 on the mean softmax cross-entropy (the
    gradient of ``SoftmaxOutput`` rescaled by 1 / batch), on the CPU; then
    the network moves to ``device`` and freezes."""
    import numpy as onp
    import torch
    from ..context import resolve_device
    from ..gluon.block import Block
    from ..gluon.nn import Activation, Dense, HybridSequential
    from ..ops import nn as _ops
    from ..serving.freeze import freeze

    class Softmax(Block):
        def forward(self, x):
            return _ops.softmax(x, axis=-1)

    device = resolve_device(device)
    init = onp.random.RandomState(3)
    net = HybridSequential()
    net.add(Dense(16, in_units=FEATURES, device='cpu'), Activation('relu'),
            Dense(CLASSES, in_units=16, device='cpu'))
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() > 1:
                p.copy_(torch.from_numpy(init.uniform(
                    -0.01, 0.01, tuple(p.shape)).astype('float32')))
    rs = onp.random.RandomState(0)
    x = rs.randn(32, FEATURES).astype('float32')
    y = rs.randint(0, CLASSES, (32,)).astype('int64')
    for i in range(0, 32, 8):
        for p in net.parameters():
            p.grad = None
        loss = torch.nn.functional.cross_entropy(
            net(torch.from_numpy(x[i:i + 8])), torch.from_numpy(y[i:i + 8]))
        loss.backward()
        with torch.no_grad():
            for p in net.parameters():
                p -= 0.1 * p.grad
    for p in net.parameters():
        p.grad = None
        p.requires_grad_(False)
    net.add(Softmax())
    net.to(device)
    return freeze(net, [('data', (FEATURES,))], max_batch=8,
                  name='loadgen-mlp')


def _build_decoder(slots, pages=None, prefill_buckets=(8,),
                   max_len=64, page_size=8, adapter_rank=0,
                   adapter_slots=0, lm=None, device=None):
    """Deterministic transformer LM (``lm``: ``init_transformer_lm``'s
    widths, default :data:`TINY_LM`, seed 5) over the PAGED KV cache: the
    /generate workload. The pool defaults to ~65% of the worst-case (slots
    x max_pages) reservation, a production-shaped oversubscription, so the
    chaos squeeze can exhaust it while normal soak traffic never does.
    ``adapter_rank`` > 0 builds an adapter pool (``adapter_slots`` rows,
    the base row among them) into the programs: the multi-adapter
    workload."""
    from ..serving.decode import PagedDecodeProgram, init_transformer_lm
    model, params = init_transformer_lm(max_len=max_len, seed=5,
                                        **dict(lm or TINY_LM))
    max_pages = -(-max_len // page_size)
    if pages is None:
        pages = max(2, int(0.65 * slots * max_pages) + 1)
    aspec = None
    if adapter_rank:
        from ..serving.adapters import AdapterSpec
        aspec = AdapterSpec.for_model(model, rank=int(adapter_rank),
                                      capacity=int(adapter_slots))
    return PagedDecodeProgram(model, params, slots=slots,
                              prefill_buckets=prefill_buckets,
                              page_size=page_size, pages=pages,
                              adapter_spec=aspec, name='loadgen-lm',
                              device=device)


def _stamp_adapter_fleet(root, n, rank=4, lm=None, max_len=64):
    """Stamp ``n`` deterministic LoRA artifacts for the loadgen LM
    (ids ``ad0`` .. ``ad{n-1}``) under ``root``. scale=50: the random
    0.05-std A/B product is tiny, and the workload verdict needs the
    adapters to visibly steer the stream."""
    from ..serving.adapters import init_adapter, save_adapter
    from ..serving.decode import TransformerLM
    model = TransformerLM(dict(max_len=max_len, **dict(lm or TINY_LM)))
    ids = []
    for i in range(int(n)):
        ad = init_adapter(model, rank=rank, seed=300 + i, scale=50.0,
                          name='ad%d' % i)
        save_adapter(os.path.join(root, 'ad%d' % i), ad)
        ids.append('ad%d' % i)
    return ids


class ServingRig:
    """The live system under test: real sessions, real HTTP.

    Sized for a CPU rig by default — a SMALL bounded queue so overload
    produces sheds within seconds, a short per-request budget so 504s
    are observable, and a fast-reset breaker so chaos recovery fits a
    CI window. Every knob is a constructor argument; the breaker is
    injected so the harness controls recovery timing deterministically.
    ``device`` (None: the card) holds both programs; ``lm`` (a dict of
    ``init_transformer_lm`` widths, default :data:`TINY_LM`),
    ``decode_page_size`` and ``adapter_slots`` (default ``adapter_fleet``
    + 1: every adapter resident) size the decoder.
    """

    def __init__(self, predict=True, generate=True, max_queue=16,
                 timeout_s=5.0, deadline_ms=2.0, max_batch=8,
                 slots=4, decode_max_queue=6, max_new_tokens=8,
                 breaker_threshold=3, breaker_reset_s=0.4,
                 max_concurrent=24, warmup=True, decode_pages=None,
                 decode_prefill_buckets=(8,), decode_max_len=64,
                 adapter_fleet=0, adapter_rank=4, device=None, lm=None,
                 decode_page_size=8, adapter_slots=None):
        from ..resilience.policy import CircuitBreaker
        from ..serving.server import InferenceSession, \
            ServingHTTPServer
        if not (predict or generate):
            raise ValueError('rig needs at least one of predict/'
                             'generate')
        self.max_new_tokens = int(max_new_tokens)
        self.slots = int(slots)
        self.predict_session = None
        self.decode_session = None
        # multi-adapter workload mode: stamp a fleet of LoRA
        # artifacts and bake a pool row per adapter (+ base row 0)
        # into the decode program's compiled signature
        self.adapter_ids = []
        self._adapter_tmp = None
        adapter_dir = None
        if adapter_fleet:
            if not generate:
                raise ValueError('adapter_fleet needs the generate '
                                 'rig')
            import tempfile
            self._adapter_tmp = tempfile.TemporaryDirectory(
                prefix='loadgen-adapters-')
            adapter_dir = self._adapter_tmp.name
            self.adapter_ids = _stamp_adapter_fleet(
                adapter_dir, adapter_fleet, rank=adapter_rank, lm=lm,
                max_len=decode_max_len)
        if predict:
            frozen = _build_frozen(device)
            if warmup:
                frozen.warmup()
            self.predict_session = InferenceSession(
                frozen, max_batch=max_batch, deadline_ms=deadline_ms,
                max_queue=max_queue, timeout_s=timeout_s,
                watchdog=False,
                breaker=CircuitBreaker(
                    failure_threshold=breaker_threshold,
                    reset_timeout=breaker_reset_s),
                name='loadgen-predict')
        if generate:
            prog = _build_decoder(
                slots, pages=decode_pages,
                prefill_buckets=decode_prefill_buckets,
                max_len=decode_max_len, page_size=decode_page_size,
                adapter_rank=adapter_rank if adapter_fleet else 0,
                adapter_slots=adapter_slots if adapter_slots is not None
                else adapter_fleet + 1, lm=lm, device=device)
            if warmup:
                prog.warmup()
            self.decode_session = InferenceSession(
                prog, max_queue=decode_max_queue, timeout_s=timeout_s,
                watchdog=False, max_new_tokens=max_new_tokens,
                breaker=CircuitBreaker(
                    failure_threshold=breaker_threshold,
                    reset_timeout=breaker_reset_s),
                name='loadgen-decode', adapters=adapter_dir)
        primary = self.predict_session or self.decode_session
        secondary = self.decode_session \
            if self.predict_session is not None else None
        self.server = ServingHTTPServer(
            primary, 0, decode_session=secondary,
            max_concurrent=max_concurrent).start()
        self.port = self.server.port

    # -- end-of-run drain proof --------------------------------------------

    def server_stats(self):
        """Server-side half of the zero-hang invariant: after drain,
        no queue holds a request and every decode slot is free."""
        out = {}
        if self.predict_session is not None:
            q = self.predict_session._batcher.stats()
            out['predict'] = {
                'depth': q['depth'],
                'shed_doomed': q['shed_doomed'],
                'timeouts': q['timeouts'],
                'breaker': self.predict_session._breaker.state,
            }
        if self.decode_session is not None:
            st = self.decode_session._engine.stats()
            out['generate'] = {
                'pending': st['pending'], 'active': st['active'],
                'free_slots': st['free_slots'],
                'leaked_slots': st['slots'] - st['free_slots']
                - st['active'],
                'retired': st['counts']['retired'],
                'breaker': st['breaker'],
            }
            if st.get('pages'):
                out['generate']['pages'] = st['pages']
                out['generate']['prefix_hits'] = \
                    st['counts']['prefix_hits']
                out['generate']['pool_exhausted'] = \
                    st['counts']['pool_exhausted']
            if st.get('adapters'):
                out['generate']['adapters'] = st['adapters']
                out['generate']['sampled_tokens'] = \
                    st['counts'].get('sampled_tokens', 0)
        return out

    def healthy(self, payload):
        """True when a /status payload reports every mounted session
        ok with its breaker closed."""
        if payload is None:
            return False
        if 'predict' in payload or 'generate' in payload:
            parts = [payload[k] for k in ('predict', 'generate')
                     if k in payload]
        else:
            parts = [payload]
        for part in parts:
            if part.get('status') != 'ok':
                return False
            breaker = part.get('breaker')
            if isinstance(breaker, dict):
                breaker = breaker.get('state')
            if breaker not in (None, 'closed'):
                return False
        return True

    def close(self):
        self.server.stop()
        for sess in (self.predict_session, self.decode_session):
            if sess is not None:
                sess.close(drain=False)
        if self._adapter_tmp is not None:
            self._adapter_tmp.cleanup()


class GatewayRig:
    """Multi-replica system under test: N independent :class:`ServingRig`
    replicas fronted by one :class:`~mxnet_tpu_torch.serving.ServingGateway`
    (docs/DISTRIBUTED.md "Gateway").

    Mirrors the ServingRig driving interface (``port`` — the
    GATEWAY's, ``healthy(payload)``, ``server_stats()``, ``close()``)
    so every loadgen mode (:func:`run_capacity`, :func:`run_overload`,
    ...) drives a multi-replica deployment unchanged.
    :meth:`kill_replica` takes one replica down mid-run — the
    host-loss drill: the gateway must keep
    serving (degraded) on the survivors.
    """

    def __init__(self, replicas=2, health_period_s=0.25,
                 gateway_kwargs=None, classes=None, **rig_kwargs):
        from ..serving.gateway import ServingGateway
        if int(replicas) < 1:
            raise ValueError('GatewayRig needs >= 1 replica')
        if classes is not None and len(classes) != int(replicas):
            raise ValueError('classes must name every replica '
                             '(%d != %d)' % (len(classes),
                                             int(replicas)))
        self.replicas = [ServingRig(**rig_kwargs)
                         for _ in range(int(replicas))]
        self.classes = list(classes) if classes is not None \
            else ['both'] * int(replicas)
        self.gateway = ServingGateway(
            [('http://127.0.0.1:%d' % r.port, cls)
             for r, cls in zip(self.replicas, self.classes)],
            port=0, health_period_s=health_period_s,
            **(gateway_kwargs or {})).start()
        self.port = self.gateway.port
        self.max_new_tokens = self.replicas[0].max_new_tokens
        self.slots = self.replicas[0].slots
        self._killed = set()
        self._drained = set()

    @property
    def predict_session(self):
        return self.replicas[0].predict_session

    @property
    def decode_session(self):
        return self.replicas[0].decode_session

    def replica_index(self, base_url):
        """Index of the replica serving ``base_url`` (the drill maps
        the gateway's affinity target back to a killable rig)."""
        for i, rep in enumerate(self.replicas):
            if base_url == 'http://127.0.0.1:%d' % rep.port:
                return i
        raise ValueError('no replica at %r' % (base_url,))

    def kill_replica(self, index, drain=False):
        """Take one replica down mid-flight. ``drain=False`` is the
        whole-host-down drill: sessions close FIRST, undrained —
        every in-flight and queued stream dies NOW with a typed
        error, the mid-stream signal the gateway's resume journal
        acts on — then the HTTP server stops. A graceful server-first
        stop would let in-flight streams run to completion during the
        shutdown, which is a drained host, not a lost one.

        ``drain=True`` is the graceful-preemption drill
        (docs/SERVING.md "Drain & live migration"): ``begin_drain``
        flips /healthz to 503 draining, sheds new admissions, and
        exports every in-flight sequence over GET /drain — the HTTP
        server STAYS UP so the gateway can fetch the handoff payloads
        and splice continuations via POST /import; the replica's
        ``drain_result`` then carries the resumable exit code."""
        rep = self.replicas[index]
        if index in self._killed:
            return rep
        self._killed.add(index)
        if drain:
            self._drained.add(index)
            rep.server.begin_drain(reason='drill')
            return rep
        for sess in (rep.predict_session, rep.decode_session):
            if sess is not None:
                sess.close(drain=False)
        rep.server.stop()
        return rep

    def healthy(self, payload):
        """Gateway /status: healthy when every LIVE replica reports
        ok (killed replicas are expected casualties)."""
        if payload is None:
            return False
        expected = len(self.replicas) - len(self._killed)
        if payload.get('healthy', 0) < expected:
            return False
        statuses = payload.get('replicas', {})
        live_urls = {'http://127.0.0.1:%d' % r.port
                     for i, r in enumerate(self.replicas)
                     if i not in self._killed}
        for url, st in statuses.items():
            if url in live_urls and not self.replicas[0].healthy(st):
                return False
        return True

    def server_stats(self):
        out = {'gateway': self.gateway.stats()}
        for i, rep in enumerate(self.replicas):
            out['replica_%d' % i] = {'killed': True} \
                if i in self._killed else rep.server_stats()
        return out

    def close(self):
        self.gateway.stop()
        for i, rep in enumerate(self.replicas):
            if i in self._killed and i not in self._drained:
                continue
            try:
                rep.close()
            except Exception:
                pass       # a drained replica's sessions are closed


class Dispatcher:
    """Fires a schedule open-loop: one thread per in-flight request,
    launched at the scheduled instant regardless of completions.

    ``max_inflight`` bounds the thread population; an arrival above
    the bound resolves immediately as ``client_saturated`` — counted,
    never silently dropped (a silent drop would fake goodput).
    """

    def __init__(self, client, max_new_tokens=8, max_inflight=None,
                 clock=time.monotonic, sleep=time.sleep,
                 prefix_prompts=None, adapter_ids=None):
        self.client = client
        self.max_new_tokens = int(max_new_tokens)
        self.max_inflight = int(
            max_inflight if max_inflight is not None
            else _knob('MXNET_TPU_LOADGEN_MAX_INFLIGHT', 512))
        # shared-prefix workload mode: generate payloads draw a system
        # prompt Zipf-style (rank weights ~ 3:2:1) and append a
        # per-rid suffix token — deterministic in rid, so runs replay
        self.prefix_prompts = [list(p) for p in (prefix_prompts or [])]
        # multi-adapter workload mode: each generate request draws an
        # adapter Zipf-style over the fleet (harmonic rank weights,
        # pure in rid) and every other request samples (temperature
        # 0.8, per-rid seed) — greedy and sampled traffic interleave
        # on the same engine, the one-compiled-step claim under load
        self.adapter_ids = list(adapter_ids or [])
        self._clock = clock
        self._sleep = sleep
        # O(1) in-flight accounting: the dispatch loop sits on the
        # timing-critical path (late dispatch skews the open-loop
        # arrival times), so it must not scan the thread list
        self._live = 0
        self._live_lock = threading.Lock()

    @staticmethod
    def _predict_payload(rid):
        # deterministic per-rid example (seeded by rid, no rng state)
        return [(((rid * 31 + i * 7) % 17) - 8) / 8.0
                for i in range(FEATURES)]

    @staticmethod
    def _generate_payload(rid):
        return [1 + (rid % (_VOCAB - 2)), 2, 3]

    # Zipf-ish rank pick over 3 prompts: ranks weighted 3:2:1 (the
    # harmonic 1/(r+1) shape at n=3), pure function of rid
    _ZIPF_RANKS = (0, 0, 0, 1, 1, 2)

    def _prefix_payload(self, rid):
        prompts = self.prefix_prompts
        rank = self._ZIPF_RANKS[rid % len(self._ZIPF_RANKS)]
        sp = prompts[rank % len(prompts)]
        return sp + [1 + (rid % (_VOCAB - 2))]

    def _adapter_extra(self, rid):
        """Per-rid adapter + sampling fields (pure in rid, so runs
        replay). Zipf over [base] + fleet via harmonic rank weights;
        odd rids sample, even rids stay greedy."""
        ids = ['base'] + self.adapter_ids
        # harmonic Zipf: rank r picked proportional to 1/(r+1)
        weights = [1.0 / (r + 1) for r in range(len(ids))]
        total = sum(weights)
        u = ((rid * 2654435761) % 1000) / 1000.0 * total
        rank = 0
        for rank, w in enumerate(weights):
            u -= w
            if u < 0:
                break
        extra = {'adapter': ids[rank]}
        if rid % 2:
            extra.update(temperature=0.8, top_p=0.9, seed=rid)
        return extra

    def _fire(self, rec):
        try:
            if rec.kind == 'generate':
                payload = self._prefix_payload(rec.rid) \
                    if self.prefix_prompts \
                    else self._generate_payload(rec.rid)
                extra = self._adapter_extra(rec.rid) \
                    if self.adapter_ids else None
                self.client.generate(
                    rec, payload,
                    max_new_tokens=self.max_new_tokens,
                    extra=extra)
            else:
                self.client.predict(rec,
                                    self._predict_payload(rec.rid))
        finally:
            with self._live_lock:
                self._live -= 1

    def run(self, arrivals):
        """Dispatch the whole schedule; returns (records, threads).
        Call :meth:`drain` afterwards to enforce the zero-hang
        invariant client-side."""
        records = []
        threads = []
        t0 = self._clock()
        for a in arrivals:
            delay = (t0 + a.t) - self._clock()
            if delay > 0:
                self._sleep(delay)
            rec = RequestRecord(a.rid, a.kind, a.t)
            records.append(rec)
            with self._live_lock:
                saturated = self._live >= self.max_inflight
                if not saturated:
                    self._live += 1
            if saturated:
                rec.error_class = 'client_saturated'
                rec.resolved = True
                continue
            th = threading.Thread(target=self._fire, args=(rec,),
                                  daemon=True,
                                  name='loadgen-%d' % a.rid)
            th.start()
            threads.append(th)
        return records, threads

    def drain(self, threads, budget_s):
        """Join every request thread; returns the number still alive
        after the budget (0 = zero-hang holds client-side)."""
        deadline = self._clock() + budget_s
        for th in threads:
            th.join(max(0.0, deadline - self._clock()))
        return sum(1 for th in threads if th.is_alive())


def _run_window(rig, qps, duration_s, mix, seed, timeout_s,
                poisson=True, prefix_prompts=None, adapter_ids=None):
    """One open-loop window against the rig; returns (records,
    unresolved)."""
    client = LoadClient('127.0.0.1', rig.port, timeout_s=timeout_s)
    disp = Dispatcher(client, max_new_tokens=rig.max_new_tokens,
                      prefix_prompts=prefix_prompts,
                      adapter_ids=adapter_ids)
    arrivals = build_schedule(qps, duration_s, mix=mix, seed=seed,
                              poisson=poisson)
    records, threads = disp.run(arrivals)
    unresolved = disp.drain(threads, timeout_s + 2.0)
    return records, unresolved


def _settle(rig, budget_s=2.0):
    """Let queues drain between probe windows so one window's backlog
    does not pollute the next window's tail."""
    client = LoadClient('127.0.0.1', rig.port, timeout_s=1.0)
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        _code, payload = client.get_json('/status')
        if payload is not None and rig.healthy(payload):
            return True
        time.sleep(0.05)
    return False


def _probe_capacity(rig, mix, seed, slo_s, goodput_floor, start_qps,
                    window_s, timeout_s, max_qps=2048.0,
                    margin=0.6):
    """Coarse doubling ramp: the highest rate whose window stayed
    within SLO. Returns (last_good_qps, first_bad_qps, probes).

    ``margin`` < 1 demands headroom: a short window at a borderline
    rate can luck under the budget once and send overload mode off a
    cliff; "within capacity" means comfortably within, the full
    budget is what overload verifies."""
    qps = float(start_qps)
    last_good = None
    probes = []
    while qps <= max_qps:
        records, unresolved = _run_window(rig, qps, window_s, mix,
                                          seed, timeout_s)
        m = summarize(records)
        p99 = m['admitted_latency']['p99_ms']
        good = (unresolved == 0
                and m['goodput'] is not None
                and m['goodput'] >= goodput_floor
                and p99 is not None and p99 <= slo_s * 1e3 * margin)
        probes.append({'qps': qps, 'good': good, 'p99_ms': p99,
                       'goodput': m['goodput'],
                       'offered': m['offered']})
        _settle(rig)
        if not good:
            return last_good, qps, probes
        last_good = qps
        qps *= 2.0
    return last_good, None, probes


def run_capacity(rig, slo_s=None, goodput_floor=None, mix=None,
                 seed=0, start_qps=8.0, window_s=2.0,
                 bisect_iters=3, timeout_s=6.0):
    """Capacity-search mode: max offered QPS with admitted-p99 under
    the SLO and goodput over the floor."""
    slo_s = float(slo_s if slo_s is not None
                  else _knob('MXNET_TPU_SLO_P99_MS', 500.0) / 1e3)
    goodput_floor = float(
        goodput_floor if goodput_floor is not None
        else _knob('MXNET_TPU_SLO_GOODPUT', 0.9))
    mix = mix or OVERLOAD_MIX
    lo, hi, probes = _probe_capacity(rig, mix, seed, slo_s,
                                     goodput_floor, start_qps,
                                     window_s, timeout_s)
    if lo is None:                 # even the base rate failed
        verdicts = {'capacity_found': False}
        return build_artifact(
            'capacity',
            {'slo_p99_ms': slo_s * 1e3, 'goodput_floor': goodput_floor,
             'seed': seed, 'window_s': window_s, 'mix': mix},
            {'max_qps': None, 'probes': probes}, verdicts=verdicts)
    if hi is not None:
        for i in range(bisect_iters):
            mid = (lo + hi) / 2.0
            records, unresolved = _run_window(rig, mid, window_s, mix,
                                              seed + 17 * (i + 1),
                                              timeout_s)
            m = summarize(records)
            p99 = m['admitted_latency']['p99_ms']
            good = (unresolved == 0 and m['goodput'] is not None
                    and m['goodput'] >= goodput_floor
                    and p99 is not None and p99 <= slo_s * 1e3)
            probes.append({'qps': mid, 'good': good, 'p99_ms': p99,
                           'goodput': m['goodput'],
                           'offered': m['offered']})
            _settle(rig)
            if good:
                lo = mid
            else:
                hi = mid
    return build_artifact(
        'capacity',
        {'slo_p99_ms': slo_s * 1e3, 'goodput_floor': goodput_floor,
         'seed': seed, 'window_s': window_s, 'mix': mix},
        {'max_qps': lo, 'probes': probes},
        verdicts={'capacity_found': True})


def run_overload(rig, factor=2.5, duration_s=3.0, slo_s=None,
                 shed_p99_s=None, mix=None, seed=0, start_qps=8.0,
                 probe_window_s=2.0, timeout_s=6.0, capacity_qps=None):
    """Overload mode: offer ``factor`` x capacity; admission control
    must keep the ADMITTED p99 inside the SLO budget while the excess
    resolves as fast 429s (not slow timeouts)."""
    slo_s = float(slo_s if slo_s is not None
                  else _knob('MXNET_TPU_SLO_P99_MS', 500.0) / 1e3)
    shed_p99_s = float(
        shed_p99_s if shed_p99_s is not None
        else _knob('MXNET_TPU_SLO_SHED_P99_MS', 250.0) / 1e3)
    mix = mix or OVERLOAD_MIX
    if capacity_qps is None:
        goodput_floor = float(_knob('MXNET_TPU_SLO_GOODPUT', 0.9))
        lo, _hi, _probes = _probe_capacity(
            rig, mix, seed, slo_s, goodput_floor, start_qps,
            probe_window_s, timeout_s)
        capacity_qps = lo if lo is not None else float(start_qps)
    # clamp below the stdlib endpoint's accept ceiling: past O(100)
    # connections/s on a small host the kernel SYN queue — not
    # admission control — owns the latency, and this harness gates
    # the latter (production fronts the engine with a real gateway)
    offered_qps = min(float(capacity_qps) * float(factor),
                      float(_knob('MXNET_TPU_LOADGEN_MAX_QPS', 100.0)))
    records, unresolved = _run_window(rig, offered_qps, duration_s,
                                      mix, seed + 1, timeout_s)
    m = summarize(records)
    # a thread alive past the drain budget is a request whose record
    # never resolved — the same futures summarize() already counted
    m['unresolved'] = max(m['unresolved'], unresolved)
    failures = [r for r in records if r.status != 200]
    sheds_429 = sum(1 for r in failures if r.status == 429)
    shed_429_frac = (sheds_429 / float(len(failures))) \
        if failures else None
    p99 = m['admitted_latency']['p99_ms']
    shed_p99 = m['shed_latency']['p99_ms']
    verdicts = {
        'admitted_p99_within_slo': p99 is not None
        and p99 <= slo_s * 1e3,
        'sheds_are_fast_429s': (not failures) or (
            shed_429_frac is not None and shed_429_frac >= 0.8
            and (shed_p99 is None or shed_p99 <= shed_p99_s * 1e3)),
        'retry_after_advertised': m['shed'] == 0
        or m['retry_after']['n'] > 0,
        'zero_unresolved': m['unresolved'] == 0,
    }
    metrics = dict(m, shed_429_frac=shed_429_frac)
    return build_artifact(
        'overload',
        {'capacity_qps': capacity_qps, 'offered_qps': offered_qps,
         'factor': factor, 'duration_s': duration_s,
         'slo_p99_ms': slo_s * 1e3,
         'shed_p99_budget_ms': shed_p99_s * 1e3,
         'seed': seed, 'mix': mix},
        metrics, server=rig.server_stats(), verdicts=verdicts)


def run_chaos(rig, qps=20.0, duration_s=12.0, mix=None, seed=0,
              availability_floor=None, recovery_ceiling_s=None,
              timeout_s=6.0, script=CHAOS_SCRIPT):
    """Chaos-soak mode: sustained open-loop traffic while the
    FaultInjector scripts fault bursts; gates availability, per-fault
    recovery time, and the zero-hang invariant."""
    availability_floor = float(
        availability_floor if availability_floor is not None
        else _knob('MXNET_TPU_SLO_AVAILABILITY', 0.9))
    recovery_ceiling_s = float(
        recovery_ceiling_s if recovery_ceiling_s is not None
        else _knob('MXNET_TPU_SLO_RECOVERY_S', 12.0))
    mix = mix or DEFAULT_MIX
    # drop script entries aimed at a session the rig does not mount
    # (a fault nothing can consume would fail the consumed verdict)
    pruned = []
    for frac, kind, spec in script:
        parts = []
        for entry in spec.split(','):
            site = entry.split('@', 1)[1].rsplit(':', 1)[0] \
                if '@' in entry else ''
            if site.startswith('serving.decode') \
                    and rig.decode_session is None:
                continue
            if site == 'serving' and rig.predict_session is None:
                continue
            parts.append(entry)
        if parts:
            pruned.append((frac, kind, ','.join(parts)))
    script = pruned
    client = LoadClient('127.0.0.1', rig.port, timeout_s=timeout_s)
    disp = Dispatcher(client, max_new_tokens=rig.max_new_tokens)
    arrivals = build_schedule(qps, duration_s, mix=mix, seed=seed)

    box = {}

    def _drive():
        box['records'], box['threads'] = disp.run(arrivals)

    driver = threading.Thread(target=_drive, daemon=True,
                              name='loadgen-chaos-driver')
    t0 = time.monotonic()
    driver.start()

    from ..resilience.policy import get_injector

    # monitor-side probe traffic: consumption of a scripted burst and
    # the breaker's half-open recovery probe both need device calls,
    # and the Poisson schedule may not land one exactly when the
    # monitor is waiting — a light deterministic probe stream
    # (excluded from the scheduled-traffic metrics) keeps both
    # moving. Probes use a short budget so a wedged server cannot
    # wedge the monitor.
    probe_client = LoadClient('127.0.0.1', rig.port, timeout_s=2.0)
    probe_seq = [0]

    def _probe():
        rid = probe_seq[0]
        probe_seq[0] += 1
        rec = RequestRecord(rid, 'probe', 0.0)
        try:
            if rig.decode_session is not None and rid % 3 == 0:
                probe_client.generate(
                    rec, Dispatcher._generate_payload(rid),
                    max_new_tokens=2)
            elif rig.predict_session is not None:
                probe_client.predict(
                    rec, Dispatcher._predict_payload(rid))
            elif rig.decode_session is not None:
                probe_client.generate(
                    rec, Dispatcher._generate_payload(rid),
                    max_new_tokens=2)
        except Exception:
            pass

    faults = []
    try:
        for frac, kind, spec in script:
            at_s = frac * duration_s
            now = time.monotonic()
            if t0 + at_s > now:
                time.sleep(t0 + at_s - now)
            injected_at = time.monotonic() - t0
            _set_fault(spec)
            # wait for the scripted burst to be consumed (probes keep
            # device calls flowing; an unconsumed fault is a finding)
            sites = sorted({entry.split('@', 1)[1].rsplit(':', 1)[0]
                            for entry in spec.split(',')
                            if '@' in entry})
            consumed = False
            # a decode worker mid-fallback makes no device calls for
            # a few seconds — give the burst room to land
            wait_deadline = time.monotonic() + 6.0
            while time.monotonic() < wait_deadline:
                inj = get_injector()
                if not any(inj.pending(site, (kind,))
                           for site in sites):
                    consumed = True
                    break
                _probe()
                time.sleep(0.03)
            _set_fault(None)
            cleared_at = time.monotonic() - t0
            # recovery: first /status with every session ok and its
            # breaker closed after the burst cleared (probe traffic
            # feeds the half-open reset probe even past schedule end)
            recovery_s = None
            rec_deadline = time.monotonic() + recovery_ceiling_s + 2.0
            while time.monotonic() < rec_deadline:
                _code, payload = client.get_json('/status')
                if rig.healthy(payload):
                    recovery_s = (time.monotonic() - t0) - cleared_at
                    break
                _probe()
                time.sleep(0.05)
            faults.append({'kind': kind, 'spec': spec,
                           'injected_at_s': round(injected_at, 3),
                           'cleared_at_s': round(cleared_at, 3),
                           'consumed': consumed,
                           'recovery_s': None if recovery_s is None
                           else round(recovery_s, 3)})
    finally:
        _set_fault(None)
    driver.join(duration_s + timeout_s + 4.0)
    records = box.get('records', [])
    threads = box.get('threads', [])
    unresolved = disp.drain(threads, timeout_s + 2.0)
    # settle FIRST (breaker closed, queues drained) so the squeeze
    # exercises the pool, not a still-degraded engine whose fallback
    # path would never allocate a page
    _settle(rig)
    # page-pool squeeze: exhaust the (deliberately oversubscribed)
    # paged decode pool mid-stream and prove the zero-hang invariant
    # holds there too — every squeezed stream resolves, the failures
    # are typed BackpressureError, never a stall
    squeeze = _pool_squeeze(rig, budget_s=timeout_s + 10.0)
    # capture the server-side drain proof (incl. the squeeze's counts)
    server = rig.server_stats()
    m = summarize(records)
    m['unresolved'] = max(m['unresolved'], unresolved)
    leaked = sum(part.get('leaked_slots', 0)
                 for part in server.values())
    aborted = sum(n for cls, n in m['errors'].items()
                  if cls == 'aborted' or cls.startswith('stream_'))
    recoveries = [f['recovery_s'] for f in faults]
    verdicts = {
        'availability_above_floor': m['availability'] is not None
        and m['availability'] >= availability_floor,
        'all_faults_consumed': all(f['consumed'] for f in faults),
        'all_faults_recovered': all(r is not None
                                    and r <= recovery_ceiling_s
                                    for r in recoveries),
        'zero_unresolved': m['unresolved'] == 0,
        'no_leaked_slots': leaked == 0,
    }
    metrics = dict(m, aborted_typed=aborted)
    if squeeze is not None:
        metrics['pool_squeeze'] = squeeze
        verdicts['pool_exhaustion_typed'] = (
            squeeze['pool_exhausted'] > 0
            and squeeze['unresolved'] == 0
            and squeeze['untyped_failures'] == 0)
    return build_artifact(
        'chaos',
        {'qps': qps, 'duration_s': duration_s, 'seed': seed,
         'availability_floor': availability_floor,
         'recovery_ceiling_s': recovery_ceiling_s, 'mix': mix},
        metrics, faults=faults, server=server, verdicts=verdicts)


def _set_fault(spec):
    """Script ``MXNET_TPU_FAULT`` (None clears it): the port's knobs live
    in the environment, which ``get_injector`` re-reads, re-parsing on a
    change."""
    from ..resilience.policy import get_injector
    if spec is None:
        os.environ.pop('MXNET_TPU_FAULT', None)
    else:
        os.environ['MXNET_TPU_FAULT'] = spec
    get_injector()


def _pool_squeeze(rig, budget_s=15.0):
    """Drive the paged decode pool past exhaustion: more long
    generations than the oversubscribed pool can hold. Returns the
    squeeze record, or None when the rig mounts no paged decoder.

    Invariant gated: every squeezed stream RESOLVES within the budget
    — completed, or failed with the typed BackpressureError — and the
    engine counted pool exhaustion. An unresolved stream here is a
    stall, the exact failure mode typed backpressure exists to
    prevent."""
    sess = rig.decode_session
    if sess is None or not getattr(sess._engine, 'paged', False):
        return None
    eng = sess._engine
    prog = eng.program
    max_new = max(8, prog.max_len - 8)
    n = eng.slots * 2
    streams = []
    shed_at_admission = 0
    for i in range(n):
        try:
            streams.append(eng.generate(
                [1 + (i % (_VOCAB - 2)), 2, 3],
                max_new_tokens=max_new))
        except BackpressureError:
            shed_at_admission += 1
    from ..serving.batcher import RequestTimeout
    deadline = time.monotonic() + budget_s
    typed = completed = untyped = unresolved = timed_out = 0
    for s in streams:
        try:
            s.result(max(0.1, deadline - time.monotonic()))
            completed += 1
        except BackpressureError:
            typed += 1
        except RequestTimeout:
            # the per-request budget fired (typed, resolved) — only
            # an UNRESOLVED stream is a stall
            if s.done():
                timed_out += 1
            else:
                unresolved += 1
        except Exception:
            if s.done():
                untyped += 1
            else:
                unresolved += 1
    st = eng.stats()
    return {'streams': len(streams),
            'shed_at_admission': shed_at_admission,
            'completed': completed,
            'typed_backpressure': typed,
            'timed_out': timed_out,
            'untyped_failures': untyped,
            'unresolved': unresolved,
            'pool_exhausted': st['counts']['pool_exhausted'],
            'page_evictions': st['counts']['page_evictions'],
            'pages': st.get('pages')}


def run_prefix(rig, qps=12.0, duration_s=4.0, seed=0,
               ttft_p99_budget_s=None, timeout_s=6.0,
               system_prompt_len=24):
    """Shared-prefix workload mode: generate-only open-loop traffic
    whose prompts draw a system prompt Zipf-style (3:2:1 over three
    prompts) plus a one-token user suffix — the workload prefix
    sharing exists for. Gates a TTFT p99 budget
    (``MXNET_TPU_SLO_PREFIX_TTFT_P99_MS``) and that sharing actually engaged
    (prefix hits observed server-side)."""
    import random as _random
    if rig.decode_session is None:
        raise ValueError('prefix mode needs a generate-capable rig')
    ttft_p99_budget_s = float(
        ttft_p99_budget_s if ttft_p99_budget_s is not None
        else _knob('MXNET_TPU_SLO_PREFIX_TTFT_P99_MS', 400.0) / 1e3)
    rng = _random.Random(seed + 101)
    prompts = [[1 + rng.randrange(_VOCAB - 2)
                for _ in range(int(system_prompt_len))]
               for _ in range(3)]
    records, unresolved = _run_window(
        rig, qps, duration_s, {'generate': 1.0}, seed, timeout_s,
        prefix_prompts=prompts)
    _settle(rig)
    server = rig.server_stats()
    m = summarize(records)
    m['unresolved'] = max(m['unresolved'], unresolved)
    gen = m.get('generate') or {}
    ttft_p99 = (gen.get('ttft') or {}).get('p99_ms')
    hits = (server.get('generate') or {}).get('prefix_hits', 0)
    verdicts = {
        'prefix_ttft_within_budget': ttft_p99 is not None
        and ttft_p99 <= ttft_p99_budget_s * 1e3,
        'prefix_hits_observed': hits > 0,
        'zero_unresolved': m['unresolved'] == 0,
    }
    return build_artifact(
        'prefix',
        {'qps': qps, 'duration_s': duration_s, 'seed': seed,
         'system_prompt_len': int(system_prompt_len),
         'zipf_system_prompts': len(prompts),
         'prefix_ttft_p99_budget_ms': ttft_p99_budget_s * 1e3},
        m, server=server, verdicts=verdicts)


def run_adapters(rig, qps=10.0, duration_s=4.0, seed=0,
                 ttft_p99_budget_s=None, timeout_s=6.0):
    """Multi-adapter Zipf workload mode (docs/SERVING.md
    "Multi-adapter serving & sampling"): generate-only open-loop
    traffic where every request draws an adapter Zipf-style over
    ``base`` + the rig's fleet and every other request samples
    (temperature 0.8, per-rid seed). Gates the one-compiled-step
    claim under load — the decode program builds no program
    (``compile_seconds`` unchanged) after warmup while >= 8 adapters
    rotate through mixed greedy/sampled traffic — plus a TTFT p99 budget
    (``MXNET_TPU_SLO_ADAPTER_TTFT_P99_MS``), the whole fleet resident
    server-side, and sampled tokens actually observed."""
    sess = rig.decode_session
    if sess is None or not rig.adapter_ids:
        raise ValueError('adapters mode needs a generate rig built '
                         'with adapter_fleet > 0')
    ttft_p99_budget_s = float(
        ttft_p99_budget_s if ttft_p99_budget_s is not None
        else _knob('MXNET_TPU_SLO_ADAPTER_TTFT_P99_MS', 600.0) / 1e3)
    # warmup: touch every compiled path once (greedy base, sampled
    # base, greedy adapter, sampled adapter) and pre-load the whole
    # fleet so the measured window carries zero first-load device
    # writes, then snapshot the trace ledger
    fleet = list(rig.adapter_ids)
    warm = [{}, {'temperature': 0.8, 'top_p': 0.9, 'seed': 1},
            {'adapter': fleet[0]},
            {'adapter': fleet[-1], 'temperature': 0.5, 'seed': 2}]
    warm += [{'adapter': a} for a in fleet[1:-1]]
    for kw in warm:
        list(sess.generate([1, 2, 3], max_new_tokens=4, **kw))
    tc0 = dict(sess.program.compile_seconds)
    records, unresolved = _run_window(
        rig, qps, duration_s, {'generate': 1.0}, seed, timeout_s,
        adapter_ids=fleet)
    _settle(rig)
    retraced = {k: v for k, v in sess.program.compile_seconds.items()
                if tc0.get(k) != v}
    server = rig.server_stats()
    m = summarize(records)
    m['unresolved'] = max(m['unresolved'], unresolved)
    gen = m.get('generate') or {}
    ttft_p99 = (gen.get('ttft') or {}).get('p99_ms')
    sgen = server.get('generate') or {}
    pool = sgen.get('adapters') or {}
    sampled = sgen.get('sampled_tokens', 0)
    verdicts = {
        'zero_retraces_after_warmup': not retraced,
        'fleet_resident': pool.get('resident', 0) >= len(fleet),
        'sampled_tokens_observed': sampled > 0,
        'adapter_ttft_within_budget': ttft_p99 is not None
        and ttft_p99 <= ttft_p99_budget_s * 1e3,
        'zero_unresolved': m['unresolved'] == 0,
    }
    m['retraced_programs'] = retraced
    return build_artifact(
        'adapters',
        {'qps': qps, 'duration_s': duration_s, 'seed': seed,
         'adapter_fleet': len(fleet),
         'adapter_ttft_p99_budget_ms': ttft_p99_budget_s * 1e3},
        m, server=server, verdicts=verdicts)


def _read_token_stream(host, port, payload, timeout_s=30.0,
                       on_token=None, trace_ctx=None):
    """Read one streamed /generate end to end, keeping the token
    VALUES and indices (RequestRecord only counts tokens — the
    bit-identity drill needs the actual sequence). Returns
    {'status', 'tokens', 'indices', 'done', 'error', 'trace_id'};
    transport failures land in 'error', never raise. ``trace_ctx``
    (a :class:`~mxnet_tpu_torch.observability.trace.TraceContext`) rides
    the request as the distributed-trace header."""
    import http.client
    import json as _json
    out = {'status': None, 'tokens': [], 'indices': [],
           'done': None, 'error': None,
           'trace_id': trace_ctx.trace_id
           if trace_ctx is not None else None}
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=timeout_s)
    try:
        body = _json.dumps(payload).encode()
        headers = {'Content-Type': 'application/json',
                   'Content-Length': str(len(body)),
                   'Connection': 'close'}
        if trace_ctx is not None:
            from ..observability.trace import TRACE_HEADER
            headers[TRACE_HEADER] = trace_ctx.to_header()
        conn.request('POST', '/generate', body=body, headers=headers)
        resp = conn.getresponse()
        out['status'] = resp.status
        if resp.status != 200:
            resp.read()
            return out
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            try:
                obj = _json.loads(line)
            except ValueError:
                continue
            if 'token' in obj:
                out['tokens'].append(int(obj['token']))
                out['indices'].append(obj.get('index'))
                if on_token is not None:
                    on_token(len(out['tokens']))
            elif obj.get('done'):
                out['done'] = obj
                if obj.get('error'):
                    out['error'] = obj.get('error_class') or 'error'
                break
    except Exception as exc:
        out['error'] = type(exc).__name__
    finally:
        conn.close()
    return out


def _trace_drill(rig, results, classes=None):
    """Trace-completeness verdicts + critical-path artifact for a
    drill pass that ran with per-stream trace contexts. Scrapes every
    span buffer in the rig — gateway plus every replica, KILLED
    replicas included (the rig is in-process, so a dead replica's
    buffer is still readable: the spans a real fleet would have from
    the gateway's last scrape) — stitches per-request trees, and
    gates that every traced request resolved into exactly one
    complete tree with zero orphan spans. Returns
    ``(verdicts, metrics)``; ``({}, None)`` when no request carried a
    trace id (tracing off)."""
    from ..observability import trace as _tr
    ids = [r['trace_id'] for r in results
           if r is not None and r.get('trace_id')]
    if not ids:
        return {}, None
    site_cls = {'replica:%d' % rep.port: cls
                for rep, cls in zip(rig.replicas,
                                    getattr(rig, 'classes', None)
                                    or [])}
    # the client resolves on the done LINE, a beat before the
    # gateway handler thread unwinds and emits its gw.relay /
    # gw.request spans — poll the scrape until every tree closes (or
    # a short deadline: a genuinely missing span must still fail)
    deadline = time.monotonic() + 5.0
    while True:
        records = list(rig.gateway._trace_buf.read())
        for rep in rig.replicas:
            records.extend(rep.server._trace_buf.read())
        trees = _tr.stitch(records)
        complete = 0
        orphan_spans = 0
        classes_seen = set()
        stream_trees = []
        for tid in ids:
            tree = trees.get(tid)
            if tree is None:
                continue
            stream_trees.append(tree)
            if _tr.tree_verdict(tree):
                complete += 1
            orphan_spans += len(tree['orphans'])
            for s in tree['spans'].values():
                cls = site_cls.get(s.get('site'))
                if cls:
                    classes_seen.add(cls)
        settled = (complete == len(ids) and orphan_spans == 0)
        if settled or time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    for tree in stream_trees:
        _tr.normalize_skew(tree)
    verdicts = {
        'trace_complete': complete == len(ids),
        'trace_zero_orphans': orphan_spans == 0,
    }
    if classes:
        verdicts['trace_both_classes'] = \
            set(classes) <= classes_seen
    metrics = {
        'requests': len(ids),
        'stitched_complete': complete,
        'orphan_spans': orphan_spans,
        'spans': sum(len(t['spans']) for t in stream_trees),
        'classes_seen': sorted(classes_seen),
        'critical_path': _tr.critical_path(stream_trees),
    }
    return verdicts, metrics


def run_gateway_failover(rig, streams=8, seed=0,
                         availability_floor=None, timeout_s=30.0,
                         kill=True):
    """Kill-replica-mid-stream drill: >= ``streams`` concurrent
    /generate streams share ONE system prompt, so prefix-affine
    routing aims them all at a single replica; that replica is killed
    once tokens are flowing, and the gateway must resume every live
    stream on the survivors. Its verdicts:

      * zero client-visible NDJSON error lines,
      * availability (clean completions / offered) above the
        ``MXNET_TPU_SLO_GATEWAY_AVAILABILITY`` floor,
      * every token stream BIT-IDENTICAL to the unkilled reference
        run (greedy decode + replay-from-journal = same sequence),
      * token indices contiguous with no duplicates across the splice
        (the at-most-once contract),
      * at least one stream actually resumed (the drill proved the
        mechanism, not a lucky miss).
    """
    if rig.decode_session is None:
        raise ValueError('gateway-failover mode needs a generate-'
                         'capable rig')
    if len(rig.replicas) < 2:
        raise ValueError('gateway-failover mode needs >= 2 replicas')
    availability_floor = float(
        availability_floor if availability_floor is not None
        else _knob('MXNET_TPU_SLO_GATEWAY_AVAILABILITY', 0.99))
    streams = int(streams)
    max_new = int(rig.max_new_tokens)
    system = [2 + ((seed + j) % (_VOCAB - 3)) for j in range(12)]
    payloads = [{'tokens': system + [1 + (i % (_VOCAB - 2))],
                 'max_new_tokens': max_new, 'stream': True}
                for i in range(streams)]
    # every payload shares the system prompt => one affinity target
    target_url = rig.gateway.affinity_target(payloads[0]['tokens'])
    target = rig.replica_index(target_url)
    # reference pass (unkilled): the token sequences the client is
    # entitled to — also warms the target's prefix cache, exactly the
    # state a long-lived deployment would be in
    reference = [_read_token_stream('127.0.0.1', rig.port, p,
                                    timeout_s=timeout_s)
                 for p in payloads]
    _settle(rig)
    # killed pass: all streams concurrent; the killer waits for
    # first tokens so the kill lands MID-stream, not before admission.
    # The pass runs TRACED (per-stream client-minted contexts): the
    # trace_complete verdict proves every resumed stream still
    # stitches into one tree across the replica loss
    from ..observability import trace as _tr
    _tr.set_enabled(True)
    results = [None] * streams
    first_tokens = threading.Event()

    def _on_token(n):
        first_tokens.set()

    def _drive(i):
        results[i] = _read_token_stream(
            '127.0.0.1', rig.port, payloads[i], timeout_s=timeout_s,
            on_token=_on_token, trace_ctx=_tr.TraceContext.new())

    threads = [threading.Thread(target=_drive, args=(i,),
                                daemon=True,
                                name='loadgen-failover-%d' % i)
               for i in range(streams)]
    try:
        for th in threads:
            th.start()
        killed = False
        if kill:
            # kill on the FIRST streamed token: the first slot wave
            # is mid-generation and the rest still queued on the
            # target, so the loss hits streams in every admission
            # state
            first_tokens.wait(timeout_s)
            rig.kill_replica(target)
            killed = True
        deadline = time.monotonic() + timeout_s + 10.0
        for th in threads:
            th.join(max(0.1, deadline - time.monotonic()))
    except BaseException:
        _tr.set_enabled(None)      # back to the config default
        raise
    unresolved = sum(1 for th in threads if th.is_alive())
    # -- verdicts ----------------------------------------------------------
    clean = [r for r in results
             if r is not None and r['status'] == 200
             and r['error'] is None and r['done'] is not None]
    error_lines = sum(1 for r in results
                      if r is not None and r['error'] is not None)
    resumed = sum(1 for r in clean
                  if (r['done'] or {}).get('resumed'))
    # bit-identity over CLEAN streams (a rejected/unresolved stream
    # is an availability miss, already gated above)
    identical = all(
        reference[i]['error'] is None
        and results[i]['tokens'] == reference[i]['tokens']
        for i in range(streams)
        if results[i] is not None and results[i]['status'] == 200
        and results[i]['error'] is None
        and results[i]['done'] is not None)
    contiguous = all(
        r['indices'] == list(range(len(r['tokens'])))
        and (r['done'] or {}).get('tokens') == r['tokens']
        for r in clean)
    availability = len(clean) / float(streams) if streams else None
    gw_stats = rig.gateway.stats()
    try:
        trace_verdicts, trace_metrics = _trace_drill(rig, results)
    finally:
        # only after the scrape: the handlers and the workers emit their
        # last spans after the client's done line
        _tr.set_enabled(None)
    verdicts = {
        'zero_error_lines': error_lines == 0,
        'availability_above_floor': availability is not None
        and availability >= availability_floor,
        'token_streams_bit_identical': identical,
        'indices_contiguous_no_dupes': contiguous,
        'resume_engaged': (not killed)
        or (resumed >= 1 and gw_stats.get('resumes', 0) >= 1),
        'zero_unresolved': unresolved == 0,
    }
    verdicts.update(trace_verdicts)
    metrics = {
        'offered': streams,
        'admitted': sum(1 for r in results
                        if r is not None and r['status'] == 200),
        'served_ok': len(clean),
        'availability': availability,
        'resumed_streams': resumed,
        'error_lines': error_lines,
        'unresolved': unresolved,
        'tokens_per_stream': max_new,
        'gateway': gw_stats,
    }
    if trace_metrics is not None:
        metrics['trace'] = trace_metrics
    return build_artifact(
        'gateway-failover',
        {'streams': streams, 'seed': seed, 'killed_replica': target
         if killed else None, 'replicas': len(rig.replicas),
         'max_new_tokens': max_new,
         'availability_floor': availability_floor},
        metrics, server=rig.server_stats(), verdicts=verdicts)


def run_drain(rig, streams=8, seed=0, availability_floor=None,
              timeout_s=30.0):
    """Graceful-drain drill (docs/SERVING.md "Drain & live
    migration"): >= ``streams`` concurrent /generate streams share
    one system prompt so prefix-affine routing lands them all on one
    replica; once EVERY stream has its first token (all sequences
    ACTIVE in the decode engine, none still queued), that replica
    begins a graceful drain. The gateway must route away, import the
    handed-off sequences on the survivors, and splice each
    continuation into the same client stream. Its verdicts:

      * zero client-visible NDJSON error lines — a drain is not a
        failure,
      * availability at/above ``MXNET_TPU_SLO_DRAIN_AVAILABILITY``
        (default 1.0: a graceful drain loses NOTHING),
      * every token stream BIT-IDENTICAL to the undrained reference,
      * token indices contiguous with no duplicates across the
        splice,
      * ZERO destination re-prefills — the KV pages travelled in the
        seqstate payloads (survivor prefill delta == 0, imports > 0),
      * the drain completed with the resumable exit code (rc 75),
      * zero unresolved streams.
    """
    if rig.decode_session is None:
        raise ValueError('drain mode needs a generate-capable rig')
    if len(rig.replicas) < 2:
        raise ValueError('drain mode needs >= 2 replicas')
    streams = int(streams)
    if int(rig.slots) < streams:
        raise ValueError(
            'drain drill needs slots >= streams (%d < %d): every '
            'stream must be ACTIVE when the drain fires — a still-'
            'queued sequence exports cold and re-prefills on import, '
            'which this drill gates against' % (rig.slots, streams))
    availability_floor = float(
        availability_floor if availability_floor is not None
        else _knob('MXNET_TPU_SLO_DRAIN_AVAILABILITY', 1.0))
    max_new = int(rig.max_new_tokens)
    system = [2 + ((seed + j) % (_VOCAB - 3)) for j in range(12)]
    payloads = [{'tokens': system + [1 + (i % (_VOCAB - 2))],
                 'max_new_tokens': max_new, 'stream': True}
                for i in range(streams)]
    target_url = rig.gateway.affinity_target(payloads[0]['tokens'])
    target = rig.replica_index(target_url)
    # reference pass (undrained): the sequences the client is
    # entitled to (greedy bit-identity across the handoff)
    reference = [_read_token_stream('127.0.0.1', rig.port, p,
                                    timeout_s=timeout_s)
                 for p in payloads]
    _settle(rig)
    survivors = [i for i in range(len(rig.replicas)) if i != target]
    pre = {i: dict(rig.replicas[i].decode_session._engine
                   .stats()['counts']) for i in survivors}
    results = [None] * streams
    first = [threading.Event() for _ in range(streams)]

    def _drive(i):
        results[i] = _read_token_stream(
            '127.0.0.1', rig.port, payloads[i], timeout_s=timeout_s,
            on_token=lambda _n, i=i: first[i].set())

    threads = [threading.Thread(target=_drive, args=(i,),
                                daemon=True,
                                name='loadgen-drain-%d' % i)
               for i in range(streams)]
    for th in threads:
        th.start()
    all_active = all(ev.wait(timeout_s) for ev in first)
    rig.kill_replica(target, drain=True)
    deadline = time.monotonic() + timeout_s + 10.0
    for th in threads:
        th.join(max(0.1, deadline - time.monotonic()))
    unresolved = sum(1 for th in threads if th.is_alive())
    drained = rig.replicas[target].server
    drain_done = drained.wait_drained(timeout=timeout_s)
    drain_res = drained.drain_result or {}
    # -- verdicts ----------------------------------------------------------
    clean = [r for r in results
             if r is not None and r['status'] == 200
             and r['error'] is None and r['done'] is not None]
    error_lines = sum(1 for r in results
                      if r is not None and r['error'] is not None)
    migrated_streams = sum(1 for r in clean
                           if (r['done'] or {}).get('migrated'))
    identical = all(
        reference[i]['error'] is None
        and results[i]['tokens'] == reference[i]['tokens']
        for i in range(streams)
        if results[i] is not None and results[i]['status'] == 200
        and results[i]['error'] is None
        and results[i]['done'] is not None)
    contiguous = all(
        r['indices'] == list(range(len(r['tokens'])))
        and (r['done'] or {}).get('tokens') == r['tokens']
        for r in clean)
    post = {i: dict(rig.replicas[i].decode_session._engine
                    .stats()['counts']) for i in survivors}
    prefill_delta = sum(post[i].get('prefills', 0)
                        - pre[i].get('prefills', 0)
                        for i in survivors)
    imports = sum(post[i].get('migrated_in', 0)
                  - pre[i].get('migrated_in', 0) for i in survivors)
    availability = len(clean) / float(streams) if streams else None
    gw_stats = rig.gateway.stats()
    verdicts = {
        'zero_error_lines': error_lines == 0,
        'availability_above_floor': availability is not None
        and availability >= availability_floor,
        'token_streams_bit_identical': identical,
        'indices_contiguous_no_dupes': contiguous,
        'zero_dest_reprefills': prefill_delta == 0 and imports >= 1,
        'migration_engaged': all_active and migrated_streams >= 1
        and gw_stats['migrations']['spliced'] >= 1,
        'drain_rc_resumable': bool(drain_done)
        and drain_res.get('rc') == 75,
        'zero_unresolved': unresolved == 0,
    }
    metrics = {
        'offered': streams,
        'admitted': sum(1 for r in results
                        if r is not None and r['status'] == 200),
        'served_ok': len(clean),
        'availability': availability,
        'migrated_streams': migrated_streams,
        'dest_prefill_delta': prefill_delta,
        'dest_imports': imports,
        'error_lines': error_lines,
        'unresolved': unresolved,
        'all_streams_active_at_drain': all_active,
        'drain_result': drain_res,
        'tokens_per_stream': max_new,
        'gateway': gw_stats,
    }
    return build_artifact(
        'drain',
        {'streams': streams, 'seed': seed,
         'drained_replica': target, 'replicas': len(rig.replicas),
         'max_new_tokens': max_new,
         'availability_floor': availability_floor},
        metrics, server=rig.server_stats(), verdicts=verdicts)


def run_disagg(rig, streams=8, seed=0, availability_floor=None,
               ttft_budget_s=None, timeout_s=30.0, kill=True):
    """Disaggregated prefill/decode chaos drill (docs/SERVING.md
    "Disaggregated prefill/decode"): a class topology (>= 2 prefill,
    >= 2 decode replicas) serves ``streams`` concurrent mixed-length
    /generate streams — Zipf-weighted long system-prompt traffic
    interleaved with short prompts. Every stream admits on the
    prefill class, exports at the prefill boundary, and splices its
    continuation from a decode-class import. Once tokens flow, one
    replica of EACH class is hard-killed. Its verdicts:

      * zero client-visible NDJSON error lines,
      * availability at/above ``MXNET_TPU_SLO_DISAGG_AVAILABILITY``,
      * every token stream BIT-IDENTICAL to an unkilled MONOLITHIC
        reference run on a (surviving) prefill replica,
      * token indices contiguous with no duplicates across prefill ->
        decode splices and kill-triggered resumes,
      * every stream actually handed off (handoff spliced >= streams)
        with retries inside the bounded budget,
      * ZERO decode-class re-prefills: surviving decode replicas with
        >= 1 import show prefill-counter delta 0 (the KV travelled in
        the seqstate payloads, never recomputed),
      * mixed-traffic TTFT p99 within
        ``MXNET_TPU_SLO_DISAGG_TTFT_P99_MS``,
      * zero unresolved streams.
    """
    if rig.decode_session is None:
        raise ValueError('disagg mode needs a generate-capable rig')
    classes = getattr(rig, 'classes', None) or []
    prefills = [i for i, c in enumerate(classes)
                if c in ('prefill', 'both')]
    decodes = [i for i, c in enumerate(classes)
               if c in ('decode', 'both')]
    if len(prefills) < 2 or len(decodes) < 2 \
            or not rig.gateway.disaggregated:
        raise ValueError(
            'disagg mode needs a disaggregated GatewayRig with >= 2 '
            'replicas per class (classes=%r)' % (classes,))
    availability_floor = float(
        availability_floor if availability_floor is not None
        else _knob('MXNET_TPU_SLO_DISAGG_AVAILABILITY', 0.99))
    ttft_budget_s = float(
        ttft_budget_s if ttft_budget_s is not None
        else _knob('MXNET_TPU_SLO_DISAGG_TTFT_P99_MS', 2500.0) / 1e3)
    streams = int(streams)
    max_new = int(rig.max_new_tokens)
    # Zipf-weighted long-prompt traffic: three shared system prompts,
    # rank-r picked proportionally to 1/r (deterministic unrolling),
    # interleaved with short prompts — the mixed workload the
    # disaggregated topology exists for
    systems = [[2 + ((seed + r * 5 + j) % (_VOCAB - 3))
                for j in range(12 + 4 * r)] for r in range(3)]
    zipf_order = [0, 1, 0, 2, 0, 1, 0, 0]
    payloads = []
    for i in range(streams):
        if i % 2 == 0:      # long: Zipf-shared system prompt + suffix
            sys_p = systems[zipf_order[(i // 2) % len(zipf_order)]]
            toks = sys_p + [1 + (i % (_VOCAB - 2))]
        else:               # short: the steady cheap lane
            toks = [2 + ((seed + i) % (_VOCAB - 3)),
                    1 + (i % (_VOCAB - 2)), 3]
        payloads.append({'tokens': toks, 'max_new_tokens': max_new,
                         'stream': True})
    # unkilled MONOLITHIC reference, direct against a prefill replica
    # that survives the drill: the token sequences every client is
    # entitled to, whatever topology served them
    ref_idx = prefills[-1]
    reference = [_read_token_stream('127.0.0.1',
                                    rig.replicas[ref_idx].port, p,
                                    timeout_s=timeout_s)
                 for p in payloads]
    _settle(rig)
    pre = {i: dict(rig.replicas[i].decode_session._engine
                   .stats()['counts']) for i in decodes}
    # the chaos pass runs TRACED: the trace_complete verdict proves
    # every stream — across prefill->decode handoff AND the double
    # kill — stitches into exactly one tree spanning both classes
    from ..observability import trace as _tr
    _tr.set_enabled(True)
    results = [None] * streams
    ttfts = [None] * streams
    t0s = [None] * streams
    first_tokens = threading.Event()

    def _drive(i):
        def _on_token(n, i=i):
            if n == 1:
                ttfts[i] = time.monotonic() - t0s[i]
                first_tokens.set()
        t0s[i] = time.monotonic()
        results[i] = _read_token_stream(
            '127.0.0.1', rig.port, payloads[i], timeout_s=timeout_s,
            on_token=_on_token, trace_ctx=_tr.TraceContext.new())

    threads = [threading.Thread(target=_drive, args=(i,),
                                daemon=True,
                                name='loadgen-disagg-%d' % i)
               for i in range(streams)]
    try:
        for th in threads:
            th.start()
        killed = []
        if kill:
            # on the first streamed token: streams are mid-handoff in
            # every state (prefilling, exported-awaiting-import,
            # decoding on the destination). Kill the decode-class
            # replica FIRST (the mid-stream loss the journal resume
            # must absorb), then a prefill-class replica (resumes
            # must re-route)
            first_tokens.wait(timeout_s)
            rig.kill_replica(decodes[0])
            killed.append(decodes[0])
            rig.kill_replica(prefills[0])
            killed.append(prefills[0])
        deadline = time.monotonic() + timeout_s + 10.0
        for th in threads:
            th.join(max(0.1, deadline - time.monotonic()))
    except BaseException:
        _tr.set_enabled(None)      # back to the config default
        raise
    unresolved = sum(1 for th in threads if th.is_alive())
    # -- verdicts ----------------------------------------------------------
    clean = [r for r in results
             if r is not None and r['status'] == 200
             and r['error'] is None and r['done'] is not None]
    error_lines = sum(1 for r in results
                      if r is not None and r['error'] is not None)
    identical = all(
        reference[i]['error'] is None
        and results[i]['tokens'] == reference[i]['tokens']
        for i in range(streams)
        if results[i] is not None and results[i]['status'] == 200
        and results[i]['error'] is None
        and results[i]['done'] is not None)
    contiguous = all(
        r['indices'] == list(range(len(r['tokens'])))
        for r in clean)
    live_decodes = [i for i in decodes if i not in killed]
    post = {i: dict(rig.replicas[i].decode_session._engine
                    .stats()['counts']) for i in live_decodes}
    prefill_delta = sum(post[i].get('prefills', 0)
                        - pre[i].get('prefills', 0)
                        for i in live_decodes)
    imports = sum(post[i].get('migrated_in', 0)
                  - pre[i].get('migrated_in', 0)
                  for i in live_decodes)
    availability = len(clean) / float(streams) if streams else None
    gw_stats = rig.gateway.stats()
    handoff = gw_stats.get('handoff') or {}
    resume_max = int(getattr(rig.gateway, 'resume_max', 2))
    retries_bound = streams * (resume_max + 1) \
        * (int(rig.gateway.handoff_retries) + 1)
    ttft_clean = sorted(t for t in ttfts if t is not None)
    ttft_p99 = ttft_clean[max(0, int(0.99 * len(ttft_clean)) - 1)] \
        if ttft_clean else None
    try:
        trace_verdicts, trace_metrics = _trace_drill(
            rig, results, classes=('prefill', 'decode'))
    finally:
        _tr.set_enabled(None)      # after the scrape, as above
    verdicts = {
        'zero_error_lines': error_lines == 0,
        'availability_above_floor': availability is not None
        and availability >= availability_floor,
        'token_streams_bit_identical': identical,
        'indices_contiguous_no_dupes': contiguous,
        'handoff_engaged': handoff.get('spliced', 0) >= streams,
        'handoff_retries_bounded':
            handoff.get('retries', 0) <= retries_bound,
        'zero_decode_reprefills': prefill_delta == 0
        and imports >= 1,
        'mixed_ttft_within_budget': ttft_p99 is not None
        and ttft_p99 <= ttft_budget_s,
        'zero_unresolved': unresolved == 0,
    }
    verdicts.update(trace_verdicts)
    metrics = {
        'offered': streams,
        'admitted': sum(1 for r in results
                        if r is not None and r['status'] == 200),
        'served_ok': len(clean),
        'availability': availability,
        'handoff': dict(handoff),
        'dest_prefill_delta': prefill_delta,
        'dest_imports': imports,
        'error_lines': error_lines,
        'unresolved': unresolved,
        'ttft_p99_ms': round(ttft_p99 * 1e3, 3)
        if ttft_p99 is not None else None,
        'tokens_per_stream': max_new,
        'gateway': gw_stats,
    }
    if trace_metrics is not None:
        metrics['trace'] = trace_metrics
    return build_artifact(
        'disagg',
        {'streams': streams, 'seed': seed, 'classes': list(classes),
         'killed_replicas': killed, 'replicas': len(rig.replicas),
         'max_new_tokens': max_new,
         'availability_floor': availability_floor,
         'ttft_budget_ms': ttft_budget_s * 1e3,
         'handoff_retries': int(rig.gateway.handoff_retries)},
        metrics, server=rig.server_stats(), verdicts=verdicts)


def run_tenants(rig, steady_qps=4.0, burst_qps=30.0, duration_s=4.0,
                seed=0, ttft_budget_s=None, tpot_budget_s=None,
                timeout_s=6.0):
    """Two-tenant burst phase: a STEADY tenant runs inside its
    admission budget while a BURST tenant offers far past its bucket.
    Its verdicts: the burst tenant sheds
    typed per-tenant 429s with Retry-After, the steady tenant is
    never shed and its TTFT/TPOT p99 stay inside the committed
    budgets — zero cross-tenant SLO bleed. The rig's gateway must
    mount tenant admission (GatewayRig(gateway_kwargs=...))."""
    if rig.decode_session is None:
        raise ValueError('tenants mode needs a generate-capable rig')
    gw = getattr(rig, 'gateway', None)
    if gw is None or gw.admission is None:
        raise ValueError('tenants mode needs a gateway with tenant '
                         'admission (tenant_rps > 0)')
    ttft_budget_s = float(
        ttft_budget_s if ttft_budget_s is not None
        else _knob('MXNET_TPU_SLO_TENANT_TTFT_P99_MS', 400.0) / 1e3)
    tpot_budget_s = float(
        tpot_budget_s if tpot_budget_s is not None
        else _knob('MXNET_TPU_SLO_TENANT_TPOT_P99_MS', 250.0) / 1e3)
    header = gw.tenant_header
    lanes = {}
    for tenant, qps, lane_seed, retries in (
            ('steady', steady_qps, seed, 0),
            # the burst lane honors Retry-After once per shed — the
            # client-backoff contract, recorded in the taxonomy
            ('burst', burst_qps, seed + 7919, 1)):
        client = LoadClient('127.0.0.1', rig.port,
                            timeout_s=timeout_s,
                            headers={header: tenant},
                            retries=retries)
        disp = Dispatcher(client, max_new_tokens=rig.max_new_tokens)
        arrivals = build_schedule(qps, duration_s,
                                  mix={'generate': 1.0},
                                  seed=lane_seed)
        lanes[tenant] = {'disp': disp, 'arrivals': arrivals}

    def _drive(lane):
        lane['records'], lane['threads'] = \
            lane['disp'].run(lane['arrivals'])

    drivers = [threading.Thread(target=_drive, args=(lane,),
                                daemon=True,
                                name='loadgen-tenant-%s' % name)
               for name, lane in lanes.items()]
    for th in drivers:
        th.start()
    for th in drivers:
        th.join(duration_s + timeout_s + 4.0)
    unresolved = 0
    for lane in lanes.values():
        unresolved += lane['disp'].drain(
            lane.get('threads', []), timeout_s + 2.0)
    _settle(rig)
    m_steady = summarize(lanes['steady'].get('records', []))
    m_burst = summarize(lanes['burst'].get('records', []))
    gw_stats = gw.stats()
    steady_gen = m_steady.get('generate') or {}
    ttft_p99 = (steady_gen.get('ttft') or {}).get('p99_ms')
    tpot_p99 = (steady_gen.get('tpot') or {}).get('p99_ms')
    verdicts = {
        'burst_shed_typed_429': m_burst['shed'] > 0
        and m_burst['retry_after']['n'] > 0,
        'burst_retry_after_honored': m_burst['retried'] > 0,
        'steady_never_shed': m_steady['shed'] == 0,
        'steady_ttft_within_budget': ttft_p99 is not None
        and ttft_p99 <= ttft_budget_s * 1e3,
        'steady_tpot_within_budget': tpot_p99 is None
        or tpot_p99 <= tpot_budget_s * 1e3,
        'zero_unresolved': unresolved == 0
        and m_steady['unresolved'] == 0
        and m_burst['unresolved'] == 0,
    }
    metrics = {
        'steady': m_steady,
        'burst': m_burst,
        'availability': m_steady['availability'],
        'admitted_latency': m_steady['admitted_latency'],
        'unresolved': unresolved,
        'gateway': gw_stats,
    }
    return build_artifact(
        'tenants',
        {'steady_qps': steady_qps, 'burst_qps': burst_qps,
         'duration_s': duration_s, 'seed': seed,
         'tenant_header': header,
         'tenant_rps': gw.admission.rps,
         'tenant_burst': gw.admission.burst,
         'tenant_max_inflight': gw.admission.max_inflight,
         'ttft_budget_ms': ttft_budget_s * 1e3,
         'tpot_budget_ms': tpot_budget_s * 1e3},
        metrics, server=rig.server_stats(), verdicts=verdicts)
