"""ServingGateway, the port of ``mxnet_tpu/serving/gateway.py``: the
availability layer over the port's serving replicas.

Each replica is a :class:`~.server.ServingHTTPServer` over its own
``InferenceSession``; the gateway fronts them all behind ONE address and
owns five concerns, on the wire exactly as the reference's gateway (the
same routes, bodies, status codes, ``Retry-After`` values, NDJSON lines,
done-line fields, request ids ``gw<port>-<seq>`` and ``stats()``):

  * **health-aware routing** -- a background probe polls every
    replica's ``/healthz`` each ``MXNET_TPU_GATEWAY_HEALTH_S`` seconds,
    with a deterministic per-replica phase offset (a hash of its URL) so
    N replicas are never probed in lockstep. A replica answering non-200
    or not answering leaves the rotation until its probe recovers; an
    in-flight connection error marks it down at once. A *draining* 503
    marks it draining, not dead.
  * **prefix-affine routing** -- ``/generate`` routes by a prompt-prefix
    fingerprint under rendezvous (highest-random-weight) hashing over the
    healthy set (``MXNET_TPU_GATEWAY_AFFINITY``), so a shared prompt
    keeps landing on the replica whose PrefixCache holds it and only the
    keys a lost replica owned move. ``/predict`` stays round-robin.
  * **mid-stream failover** -- the gateway journals every streamed
    token of a ``/generate`` stream. When a replica dies mid-stream (a
    transport failure or a typed abort line) it re-admits the request on
    a healthy replica with prompt + emitted tokens as the new prompt,
    dedups by token index and splices the continuation into the SAME
    client NDJSON stream, at most once an index, up to
    ``MXNET_TPU_GATEWAY_RESUME_MAX`` times, then a typed ``ReplicaLost``
    done line with the partial tokens. A draining replica's streams
    finish ``migrated``: the gateway polls its ``GET /drain?request_id=``
    and lands the payload on another replica by ``POST /import`` (no
    re-prefill).
  * **disaggregated prefill/decode** -- replicas carry a class
    (``prefill`` / ``decode`` / ``both``: ``(url, cls)`` tuples,
    ``classes=`` or ``MXNET_TPU_GATEWAY_CLASS_MAP``): a ``/generate``
    admits ``prefill_only`` on the prefill class, the done line carries
    the ``mxnet_tpu.seqstate.v1`` payload, and the gateway POSTs it to
    the least-loaded decode member (each candidate's ``/status``),
    retrying refusals with the resilience ``Retry`` backoff
    (``MXNET_TPU_GATEWAY_HANDOFF_{TIMEOUT_S,RETRIES}``), then falling back
    to finishing on the prefill class: never a dropped request.
  * **per-tenant admission** -- a token bucket and a weighted-fair
    in-flight share keyed on the ``MXNET_TPU_GATEWAY_TENANT_HEADER``
    header: a bursting tenant sheds typed per-tenant 429s whose
    ``Retry-After`` names its own bucket's refill. A replica's own 429
    passes through verbatim.

Streaming responses forward line by line (each NDJSON line flushed), so
TTFT through the gateway tracks the replica's. ``GET /trace`` serves the
gateway's span buffer (``gw.request`` / ``gw.admit`` / ``gw.route`` /
``gw.relay`` / ``gw.handoff`` / ``gw.splice`` / ``gw.readmit``; empty
unless ``MXNET_TPU_TRACE`` is on) and every hop carries its child context
in ``X-Mxnet-Trace``; ``GET /metrics`` the gateway's series and, with
``MXNET_TPU_TELEMETRY`` on (the default), the metrics registry. The
flight recorder gets the reference's events with its fields:
``gateway_resume`` / ``gateway_resume_failed`` on a failover,
``gateway_migrate`` / ``gateway_migrate_failed`` on a drain's handoff,
``gateway_journal_capped``, ``seq_handoff`` (stage ``export``, ``retry``,
``spliced`` or ``fallback``) on a prefill/decode handoff and
``tenant_reject`` on a 429 of admission. Stdlib only: the gateway touches
no tensor. Binds 127.0.0.1 by default.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

from ..observability import trace as _trace
from ..observability.emit import event as _record_event

__all__ = ['ReplicaState', 'ServingGateway', 'TokenBucket',
           'TenantAdmission', 'prefix_fingerprint', 'rendezvous_rank',
           'ADAPTER_HEADER']

_HOP_HEADERS = {'connection', 'keep-alive', 'transfer-encoding',
                'te', 'trailer', 'upgrade', 'proxy-authorization',
                'proxy-authenticate', 'host', 'content-length'}

# the LoRA-variant routing relay: clients may name the adapter here
# instead of the JSON body; the gateway folds it into the body and
# the affinity fingerprint
ADAPTER_HEADER = 'X-Mxnet-Adapter'


def _knob(name, default):
    try:
        from .. import config as _config
        v = _config.get(name)
        return default if v is None else v
    except Exception:
        return default


def _instruments():
    try:
        from .. import observability as _obs
        if _obs.enabled():
            return _obs.gateway_instruments()
    except Exception:
        pass
    return None


# -- prefix-affine routing (pure functions, unit-tested) -------------------

def prefix_fingerprint(tokens, adapter=None):
    """Stable fingerprint of a prompt's ROUTING prefix: everything but
    the final token (the per-user suffix in the system-prompt workload
    prefix sharing exists for), the whole prompt when it is a single
    token. Same prefix, same fingerprint — the affinity key.

    ``adapter`` folds the LoRA variant into the key: the replica-side
    PrefixCache namespaces warm pages per adapter, so the same prompt
    under different adapters shares NOTHING — routing them together
    would pin unrelated tenants to one replica for no cache win.
    ``None``/``''``/``'base'`` all hash as the base (same key as
    pre-adapter gateways)."""
    toks = [int(t) for t in tokens]
    core = toks[:-1] if len(toks) > 1 else toks
    body = ','.join(map(str, core))
    if adapter is not None and adapter not in ('', 'base'):
        body = '%s@%s' % (adapter, body)
    h = hashlib.blake2b(body.encode(), digest_size=8)
    return h.hexdigest()


def rendezvous_rank(key, members):
    """Rendezvous (highest-random-weight) order of ``members`` for
    ``key``: each member scores hash(key | member); descending score.
    Removing a member only moves the keys it owned — every other
    key keeps its winner, which is exactly the stability PrefixCache
    affinity needs across replica loss and scale-out."""
    def score(member):
        h = hashlib.blake2b(('%s|%s' % (key, member)).encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, 'big')
    return sorted(members, key=score, reverse=True)


# -- per-tenant admission --------------------------------------------------

class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``
    capacity; :meth:`take` answers (admitted, retry_after_s) — the
    hint names when THIS bucket next holds a whole token, so a shed
    tenant backs off exactly as long as its own budget demands."""

    def __init__(self, rate, burst, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._clock = clock
        self._updated = clock()

    def take(self, n=1.0):
        now = self._clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._updated)
                          * self.rate)
        self._updated = now
        if self.tokens >= n:
            self.tokens -= n
            return True, 0.0
        if self.rate <= 0:
            return False, 60.0
        return False, (n - self.tokens) / self.rate


class TenantAdmission:
    """Token-bucket + weighted-fair in-flight admission per tenant.

    ``rps``/``burst`` bound each tenant's arrival RATE (0 disables
    rate admission); ``max_inflight`` bounds the gateway-wide
    CONCURRENCY, shared weighted-fair across the tenants currently
    holding requests: every active tenant is guaranteed
    ``weight/total_weight`` of the pool, and may exceed it only while
    the pool has slack — so a burst queues behind its own share, not
    everyone's. Thread-safe; hints are derived under the lock but all
    telemetry is the caller's."""

    def __init__(self, rps=0.0, burst=None, max_inflight=0,
                 weights=None, clock=time.monotonic):
        self.rps = float(rps)
        self.burst = float(burst) if burst else max(1.0,
                                                    2.0 * self.rps)
        self.max_inflight = int(max_inflight)
        self.weights = dict(weights or {})
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets = {}
        self._inflight = {}        # tenant -> live request count
        self._shed = {}            # tenant -> {reason: n}
        self._admitted = {}

    def _weight(self, tenant):
        return float(self.weights.get(tenant, 1.0))

    def _fair_share(self, tenant):
        active = {t for t, n in self._inflight.items() if n > 0}
        active.add(tenant)
        total_w = sum(self._weight(t) for t in active)
        return max(1.0, self.max_inflight * self._weight(tenant)
                   / total_w)

    def admit(self, tenant):
        """(admitted, retry_after_s, reason). On True the caller MUST
        :meth:`release` when the request finishes."""
        with self._lock:
            if self.rps > 0:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = TokenBucket(
                        self.rps, self.burst, clock=self._clock)
                ok, hint = bucket.take()
                if not ok:
                    shed = self._shed.setdefault(tenant, {})
                    shed['rate_limit'] = shed.get('rate_limit', 0) + 1
                    return False, hint, 'rate_limit'
            if self.max_inflight > 0:
                mine = self._inflight.get(tenant, 0)
                total = sum(self._inflight.values())
                if mine >= self._fair_share(tenant) \
                        and total >= self.max_inflight:
                    shed = self._shed.setdefault(tenant, {})
                    shed['fair_share'] = shed.get('fair_share', 0) + 1
                    hint = 1.0 / self.rps if self.rps > 0 else 0.5
                    return False, hint, 'fair_share'
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
            return True, 0.0, None

    def release(self, tenant):
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n <= 1:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = n - 1

    def stats(self):
        with self._lock:
            return {t: {'admitted': self._admitted.get(t, 0),
                        'inflight': self._inflight.get(t, 0),
                        'shed': dict(self._shed.get(t, {}))}
                    for t in (set(self._admitted)
                              | set(self._inflight)
                              | set(self._shed))}


_REPLICA_CLASSES = ('prefill', 'decode', 'both')


class ReplicaState:
    """One upstream replica: base URL + class + live health view.

    ``cls`` is the disaggregated-serving role: a ``prefill`` replica
    takes prompt admissions (and exports seqstate at the prefill
    boundary), a ``decode`` replica takes seqstate imports (the step
    loop), ``both`` (the default) serves monolithically. ``draining``
    distinguishes a replica that answered a *draining* 503 from a
    dead one: it leaves the routing rotation but stays drain-pollable
    and does not count toward the all-down shed."""

    __slots__ = ('base_url', 'cls', 'healthy', 'draining',
                 'last_error', 'last_checked', 'transitions',
                 'next_probe_at', 'load')

    def __init__(self, base_url, cls='both'):
        if cls not in _REPLICA_CLASSES:
            raise ValueError('replica class %r not in %r'
                             % (cls, _REPLICA_CLASSES))
        self.base_url = base_url.rstrip('/')
        self.cls = cls
        self.healthy = True          # optimistic until the first probe
        self.draining = False        # 503 draining, not dead
        self.last_error = None
        self.last_checked = 0.0
        self.transitions = 0
        self.next_probe_at = 0.0     # staggered probe schedule (mono)
        self.load = None             # last observed pool load [0,1]

    def mark(self, healthy, error=None, draining=False):
        if healthy != self.healthy:
            self.transitions += 1
        self.healthy = healthy
        self.draining = bool(draining) and not healthy
        self.last_error = error
        self.last_checked = time.time()

    def serves(self, role):
        """Whether this replica serves ``role`` ('prefill'/'decode');
        ``None`` matches every class."""
        return role is None or self.cls == 'both' or self.cls == role

    def as_dict(self):
        return {'url': self.base_url, 'class': self.cls,
                'healthy': self.healthy, 'draining': self.draining,
                'error': self.last_error,
                'transitions': self.transitions}


def _draining_body(raw):
    """True when an upstream 503 body is the typed *draining* refusal
    (``error_class: Draining`` on POSTs, ``status: draining`` on
    /healthz) rather than a dead/broken replica."""
    try:
        doc = json.loads(raw.decode() if isinstance(raw, bytes)
                         else raw)
    except Exception:
        return False
    return (isinstance(doc, dict)
            and (doc.get('error_class') == 'Draining'
                 or doc.get('status') == 'draining'))


def _relay_budget(resp, seconds):
    """Give the rest of a spliced stream the gateway's own read budget.
    The handoff timeout bounds the hop (the POST, the import, the first
    byte); left on the socket, a decode replica's pause between two
    tokens longer than it would end the relay mid-stream. ``resp`` is
    urllib's response over a plain HTTP socket."""
    resp.fp.raw._sock.settimeout(seconds)


def _probe_jitter_frac(url):
    """Deterministic per-replica jitter in [0, 1): a hash of the URL,
    so the same fleet gets the same stagger every restart (replayable
    probe timelines) without any two replicas sharing a phase."""
    h = hashlib.blake2b(url.encode(), digest_size=4).digest()
    return int.from_bytes(h, 'big') / 2.0 ** 32


class ServingGateway:
    """Front N serving replicas behind one HTTP address.

    ``replicas``: iterable of base URLs (``http://127.0.0.1:8471``).
    ``port`` 0 picks a free port. ``health_period_s`` /
    ``timeout_s`` / ``resume`` / ``resume_max`` / ``affinity`` /
    ``tenant_*`` default from the ``MXNET_TPU_GATEWAY_*`` knobs.

    Routes::

        GET  /healthz   200 {"ok": true, "status": "ok"|"degraded",
                             "healthy": k, "replicas": n}
                        503 when NO replica is healthy
        GET  /status    aggregate: gateway view + every replica's
                        /status payload (or its error)
        GET  /replicas  the routing table with health + transitions
        GET  /metrics   gateway counters in Prometheus text format
        GET  /trace     the gateway's mxnet_tpu.trace.v1 span buffer
                        as NDJSON (?since=N drain cursor); empty
                        unless MXNET_TPU_TRACE is on
        POST /predict   forwarded to the next healthy replica
        POST /generate  forwarded prefix-affine; chunked NDJSON
                        streams line-by-line, resumed across replica
                        loss when MXNET_TPU_GATEWAY_RESUME is on
    """

    def __init__(self, replicas, port=None, host='127.0.0.1',
                 health_period_s=None, timeout_s=None, resume=None,
                 resume_max=None, affinity=None, tenant_header=None,
                 tenant_rps=None, tenant_burst=None,
                 tenant_max_inflight=None, tenant_weights=None,
                 journal_max=None, classes=None,
                 handoff_timeout_s=None, handoff_retries=None,
                 disagg_min_prompt=None):
        specs = list(replicas)
        if not specs:
            raise ValueError('gateway needs at least one replica URL')
        # replica classes: a (url, cls) item wins, then the
        # ``classes`` url->cls mapping, then MXNET_TPU_GATEWAY_
        # CLASS_MAP ("url=class,url=class"), default 'both'
        cmap = {}
        raw_map = _knob('MXNET_TPU_GATEWAY_CLASS_MAP', '')
        if raw_map:
            for part in str(raw_map).split(','):
                if '=' in part:
                    u, c = part.rsplit('=', 1)
                    cmap[u.strip().rstrip('/')] = c.strip()
        for u, c in (classes or {}).items():
            cmap[str(u).rstrip('/')] = c
        self.replicas = []
        for spec in specs:
            if isinstance(spec, (tuple, list)):
                url, cls = spec
            else:
                url = spec
                cls = cmap.get(str(url).rstrip('/'), 'both')
            self.replicas.append(ReplicaState(url, cls=cls))
        # the gateway is disaggregated the moment any replica declares
        # a role; an all-'both' fleet routes exactly as before
        self.disaggregated = any(r.cls != 'both'
                                 for r in self.replicas)
        self.host = host
        # explicit port wins; None resolves the knob (whose 0 default
        # means "pick a free port", same as passing 0)
        self.port = int(port if port is not None
                        else _knob('MXNET_TPU_GATEWAY_PORT', 0))
        self.health_period_s = float(
            health_period_s if health_period_s is not None
            else _knob('MXNET_TPU_GATEWAY_HEALTH_S', 1.0))
        self.timeout_s = float(
            timeout_s if timeout_s is not None
            else _knob('MXNET_TPU_GATEWAY_TIMEOUT_S', 30.0))
        self.resume = bool(
            resume if resume is not None
            else _knob('MXNET_TPU_GATEWAY_RESUME', True))
        self.resume_max = int(
            resume_max if resume_max is not None
            else _knob('MXNET_TPU_GATEWAY_RESUME_MAX', 2))
        # journal bound (tokens per stream); 0 = unbounded. Past the
        # cap the journal keeps only the per-stream COUNT of relayed
        # tokens: a resume re-admits the original prompt and dedups
        # the regenerated prefix by index (greedy determinism).
        self.journal_max = int(
            journal_max if journal_max is not None
            else _knob('MXNET_TPU_GATEWAY_JOURNAL_MAX', 0))
        self.affinity = bool(
            affinity if affinity is not None
            else _knob('MXNET_TPU_GATEWAY_AFFINITY', True))
        # disaggregated handoff policy: per-hop timeout + bounded
        # retries across the decode class before the monolithic
        # fallback; prompts shorter than disagg_min_prompt stay
        # monolithic on the prefill class
        self.handoff_timeout_s = float(
            handoff_timeout_s if handoff_timeout_s is not None
            else _knob('MXNET_TPU_GATEWAY_HANDOFF_TIMEOUT_S', 10.0))
        self.handoff_retries = int(
            handoff_retries if handoff_retries is not None
            else _knob('MXNET_TPU_GATEWAY_HANDOFF_RETRIES', 2))
        self.disagg_min_prompt = int(
            disagg_min_prompt if disagg_min_prompt is not None
            else _knob('MXNET_TPU_GATEWAY_DISAGG_MIN_PROMPT', 0))
        self.tenant_header = str(
            tenant_header if tenant_header is not None
            else _knob('MXNET_TPU_GATEWAY_TENANT_HEADER', 'X-Tenant'))
        tenant_rps = float(
            tenant_rps if tenant_rps is not None
            else _knob('MXNET_TPU_GATEWAY_TENANT_RPS', 0.0))
        tenant_burst = float(
            tenant_burst if tenant_burst is not None
            else _knob('MXNET_TPU_GATEWAY_TENANT_BURST', 0.0))
        tenant_max_inflight = int(
            tenant_max_inflight if tenant_max_inflight is not None
            else _knob('MXNET_TPU_GATEWAY_TENANT_MAX_INFLIGHT', 0))
        self.admission = None
        if tenant_rps > 0 or tenant_max_inflight > 0:
            self.admission = TenantAdmission(
                rps=tenant_rps, burst=tenant_burst or None,
                max_inflight=tenant_max_inflight,
                weights=tenant_weights)
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._request_seq = 0
        self._httpd = None
        self._thread = None
        self._probe_thread = None
        self._probe_stop = None
        # request tracing: the gateway's own span buffer (site
        # 'gateway') — gw.request is the tree root when the client
        # sent a bare trace identity, and every relay/handoff hop
        # propagates its child context in the X-Mxnet-Trace header
        self._trace_buf = _trace.SpanBuffer(site='gateway')
        self._stats = {'requests': 0, 'failovers': 0, 'shed': 0,
                       'passthrough_429': 0, 'resumes': 0,
                       'resume_failures': 0, 'affinity_routed': 0,
                       'tenant_shed': 0, 'migrated_streams': 0,
                       'migration_failures': 0, 'journal_capped': 0,
                       'handoffs': 0, 'handoff_retries': 0,
                       'handoff_fallbacks': 0}
        self._class_routed = {c: 0 for c in _REPLICA_CLASSES}
        self._stats_lock = threading.Lock()

    # -- health ------------------------------------------------------------

    def _probe_replica(self, rep):
        """One /healthz probe against one replica; updates its mark."""
        try:
            req = urllib.request.Request(rep.base_url + '/healthz')
            with urllib.request.urlopen(
                    req, timeout=min(self.timeout_s,
                                     max(1.0,
                                         self.health_period_s * 3))
            ) as resp:
                ok = resp.status == 200
                rep.mark(ok, None if ok
                         else 'healthz %d' % resp.status)
        except urllib.error.HTTPError as exc:
            raw = b''
            try:
                raw = exc.read()
            except Exception:
                pass
            if exc.code == 503 and _draining_body(raw):
                # draining, not dead: route away but keep it
                # drain-pollable and outside the all-down shed
                rep.mark(False, 'draining', draining=True)
            else:
                rep.mark(False, 'healthz %d' % exc.code)
        except Exception as exc:
            rep.mark(False, '%s: %s' % (type(exc).__name__, exc))

    def probe_once(self):
        """Probe every replica's /healthz once (startup + tests; the
        background loop staggers them); returns the healthy count."""
        for rep in self.replicas:
            self._probe_replica(rep)
        healthy = sum(1 for r in self.replicas if r.healthy)
        self._note_health(healthy)
        return healthy

    def _note_health(self, healthy):
        inst = _instruments()
        if inst is not None:
            try:
                inst.healthy_replicas.set(healthy)
            except Exception:
                pass

    def healthy_replicas(self):
        return [r for r in self.replicas if r.healthy]

    def _note_routed(self, rep):
        if rep is not None:
            with self._stats_lock:
                self._class_routed[rep.cls] = \
                    self._class_routed.get(rep.cls, 0) + 1

    def _pick(self, exclude=(), role=None):
        """Next healthy replica round-robin, skipping ``exclude``;
        ``role`` restricts to replicas whose class serves it."""
        with self._rr_lock:
            candidates = [r for r in self.replicas
                          if r.healthy and r.serves(role)
                          and r not in exclude]
            if not candidates:
                return None
            rep = candidates[self._rr % len(candidates)]
            self._rr += 1
        self._note_routed(rep)
        return rep

    def _route(self, fingerprint, exclude=(), role=None):
        """Prefix-affine pick when a fingerprint is given (rendezvous
        hash over the healthy set serving ``role``: stable under
        replica loss), else round-robin."""
        if fingerprint is not None:
            candidates = [r for r in self.replicas
                          if r.healthy and r.serves(role)
                          and r not in exclude]
            if candidates:
                by_url = {r.base_url: r for r in candidates}
                winner = rendezvous_rank(fingerprint,
                                         sorted(by_url))[0]
                self._bump('affinity_routed')
                inst = _instruments()
                if inst is not None:
                    inst.affinity_routed.inc()
                rep = by_url[winner]
                self._note_routed(rep)
                return rep
            return None if role is not None else self._pick(exclude)
        return self._pick(exclude, role=role)

    def _class_counts(self):
        """(healthy prefill-capable, healthy decode-capable)."""
        p = sum(1 for r in self.replicas
                if r.healthy and r.serves('prefill'))
        d = sum(1 for r in self.replicas
                if r.healthy and r.serves('decode'))
        return p, d

    def _pool_load(self, rep):
        """Decode-pool occupancy in [0, 1] from the replica's /status
        (page-pool occupancy when paged, busy-slot fraction
        otherwise); 0.5 when unreadable, so an opaque replica neither
        attracts nor repels handoffs."""
        doc = self._fetch_json(rep, '/status')
        rec = doc.get('generate') if isinstance(doc, dict) else None
        if not isinstance(rec, dict):
            rec = doc if isinstance(doc, dict) else {}
        dec = rec.get('decode')
        if isinstance(dec, dict):
            pages = dec.get('pages')
            if isinstance(pages, dict) \
                    and pages.get('occupancy_pct') is not None:
                try:
                    return max(0.0, min(
                        1.0, float(pages['occupancy_pct']) / 100.0))
                except (TypeError, ValueError):
                    pass
            slots = dec.get('slots')
            if slots:
                try:
                    return max(0.0, min(1.0, (
                        float(slots) - float(dec.get('free_slots')
                                             or 0)) / float(slots)))
                except (TypeError, ValueError):
                    pass
        return 0.5

    def _pick_decode(self, exclude=()):
        """Least-loaded healthy decode-capable replica for a seqstate
        handoff (one /status round-trip per candidate; the observed
        load is cached on the replica for the stats() pool view)."""
        candidates = [r for r in self.replicas
                      if r.healthy and r.serves('decode')
                      and r not in exclude]
        if not candidates:
            return None
        if len(candidates) > 1:
            for rep in candidates:
                rep.load = self._pool_load(rep)
            candidates.sort(key=lambda r: (r.load, r.base_url))
        rep = candidates[0]
        self._note_routed(rep)
        return rep

    def _handoff_delay(self, attempt):
        """Backoff before handoff retry ``attempt`` (1-based): the
        resilience Retry policy's jittered exponential schedule."""
        try:
            from ..resilience.policy import Retry
            return Retry(max_attempts=max(2, self.handoff_retries + 1),
                         base_delay=0.05, multiplier=2.0,
                         max_delay=1.0,
                         jitter=0.25).delay(max(1, attempt))
        except Exception:
            return min(1.0, 0.05 * 2.0 ** max(0, attempt - 1))

    def affinity_target(self, tokens, adapter=None):
        """The replica URL a prompt would route to right now (healthy
        set + rendezvous hash), or None. Drill/test helper — the
        kill-mid-stream harness uses it to aim at the serving
        replica."""
        fp = prefix_fingerprint(tokens, adapter=adapter)
        healthy = sorted(r.base_url for r in self.replicas
                         if r.healthy)
        if not healthy:
            return None
        return rendezvous_rank(fp, healthy)[0]

    # -- forwarding --------------------------------------------------------

    def _bump(self, key, n=1):
        with self._stats_lock:
            self._stats[key] += n

    def _next_request_id(self):
        # port is fixed by start() before any request flows — only the
        # sequence counter needs the lock
        port = self.port
        with self._stats_lock:
            self._request_seq += 1
            seq = self._request_seq
        return 'gw%d-%d' % (port, seq)

    def _forward(self, rep, path, body, content_type, tenant=None,
                 timeout=None, trace_ctx=None):
        headers = {'Content-Type': content_type or 'application/json'}
        if tenant is not None:
            headers[self.tenant_header] = tenant
        if trace_ctx is not None:
            headers[_trace.TRACE_HEADER] = trace_ctx.to_header()
        req = urllib.request.Request(
            rep.base_url + path, data=body, headers=headers,
            method='POST')
        return urllib.request.urlopen(
            req, timeout=self.timeout_s if timeout is None
            else timeout)

    def _fetch_json(self, rep, path, headers=None):
        try:
            req = urllib.request.Request(rep.base_url + path,
                                         headers=headers or {})
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as exc:
            try:
                return json.loads(exc.read().decode())
            except Exception:
                return {'error': 'HTTP %d' % exc.code}
        except Exception as exc:
            return {'error': '%s: %s' % (type(exc).__name__, exc)}

    # -- server ------------------------------------------------------------

    def start(self):
        if self._httpd is not None:
            return self
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer
        import http.client as _hc
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = 'HTTP/1.1'

            def _json(handler, code, payload, headers=None):
                body = (json.dumps(payload, sort_keys=True)
                        + '\n').encode()
                handler.send_response(code)
                handler.send_header('Content-Type', 'application/json')
                handler.send_header('Content-Length', str(len(body)))
                for k, v in (headers or {}).items():
                    handler.send_header(k, v)
                handler.end_headers()
                handler.wfile.write(body)

            def do_GET(handler):
                parsed = urllib.parse.urlparse(handler.path)
                path = parsed.path.rstrip('/')
                if path == '/healthz':
                    healthy = len(gw.healthy_replicas())
                    draining = sum(1 for r in gw.replicas
                                   if r.draining and not r.healthy)
                    total = len(gw.replicas)
                    if healthy == 0 and draining == 0:
                        # ALL replicas are dead (draining ones do not
                        # count — they come back): the only case that
                        # sheds
                        hint = max(1, int(gw.health_period_s + 0.999))
                        handler._json(503, {
                            'ok': False, 'status': 'unavailable',
                            'healthy': 0, 'draining': 0,
                            'replicas': total},
                            headers={'Retry-After': str(hint)})
                    else:
                        status = 'ok' if healthy == total \
                            else 'degraded'
                        body = {'ok': True, 'status': status,
                                'healthy': healthy,
                                'draining': draining,
                                'replicas': total}
                        if gw.disaggregated:
                            # a whole class down degrades the gateway
                            # to monolithic routing — visible here
                            has_p, has_d = gw._class_counts()
                            if healthy and (not has_p or not has_d):
                                body['status'] = 'degraded'
                            body['classes'] = {
                                'prefill': has_p, 'decode': has_d}
                        handler._json(200, body)
                elif path == '/replicas':
                    handler._json(200, {
                        'replicas': [r.as_dict()
                                     for r in gw.replicas],
                        'stats': gw.stats()})
                elif path == '/status':
                    statuses = {}
                    for rep in gw.replicas:
                        statuses[rep.base_url] = \
                            gw._fetch_json(rep, '/status') \
                            if rep.healthy else \
                            {'error': rep.last_error or 'unhealthy'}
                    healthy = len(gw.healthy_replicas())
                    handler._json(200, {
                        'status': 'ok'
                        if healthy == len(gw.replicas)
                        else ('degraded' if healthy else
                              'unavailable'),
                        'healthy': healthy,
                        'replicas': statuses,
                        'stats': gw.stats()})
                elif path == '/trace':
                    q = urllib.parse.parse_qs(parsed.query)
                    try:
                        since = int((q.get('since') or ['0'])[0] or 0)
                    except (TypeError, ValueError):
                        since = 0
                    body = gw._trace_buf.ndjson(since)
                    handler.send_response(200)
                    handler.send_header('Content-Type',
                                        'application/x-ndjson')
                    handler.send_header('Content-Length',
                                        str(len(body)))
                    handler.end_headers()
                    handler.wfile.write(body)
                elif path == '/metrics':
                    body = gw.metrics_text().encode()
                    handler.send_response(200)
                    handler.send_header(
                        'Content-Type',
                        'text/plain; version=0.0.4; charset=utf-8')
                    handler.send_header('Content-Length',
                                        str(len(body)))
                    handler.end_headers()
                    handler.wfile.write(body)
                else:
                    handler.send_error(404)

            # -- plain relay (predict, non-journaled generate) -----------

            def _relay_response(handler, resp, streaming):
                """Copy an upstream response to the client; chunked
                NDJSON forwards line-by-line so tokens stream."""
                ct = resp.headers.get('Content-Type',
                                      'application/json')
                chunked = streaming and 'ndjson' in ct
                handler.send_response(resp.status)
                handler.send_header('Content-Type', ct)
                passthrough = {k: v for k, v in resp.headers.items()
                               if k.lower() == 'retry-after'}
                if chunked:
                    handler.send_header('Transfer-Encoding', 'chunked')
                    for k, v in passthrough.items():
                        handler.send_header(k, v)
                    handler.end_headers()
                    for line in resp:
                        handler.wfile.write(b'%x\r\n' % len(line))
                        handler.wfile.write(line + b'\r\n')
                        handler.wfile.flush()
                    handler.wfile.write(b'0\r\n\r\n')
                    handler.wfile.flush()
                else:
                    body = resp.read()
                    handler.send_header('Content-Length',
                                        str(len(body)))
                    for k, v in passthrough.items():
                        handler.send_header(k, v)
                    handler.end_headers()
                    handler.wfile.write(body)

            def _shed_no_replica(handler, tried):
                gw._bump('shed')
                hint = max(1, int(gw.health_period_s + 0.999))
                draining = sum(1 for r in gw.replicas
                               if r.draining and not r.healthy)
                handler._json(
                    503,
                    {'error': 'no healthy serving replica '
                              '(%d configured, %d tried, %d draining)'
                              % (len(gw.replicas), len(tried),
                                 draining),
                     'retry_after_s': hint},
                    headers={'Retry-After': str(hint)})

            def _relay_consumed(handler, exc, body):
                """Relay an HTTPError whose body was already read
                (the draining sniff consumed it); Retry-After and
                content type pass through verbatim."""
                handler.send_response(exc.code)
                handler.send_header(
                    'Content-Type',
                    exc.headers.get('Content-Type',
                                    'application/json'))
                handler.send_header('Content-Length', str(len(body)))
                ra = exc.headers.get('Retry-After')
                if ra:
                    handler.send_header('Retry-After', ra)
                handler.end_headers()
                handler.wfile.write(body)

            def _forward_plain(handler, path, body, ctype, tenant,
                               fingerprint=None, tctx=None):
                """The pre-resume forwarding contract: fail over only
                before the first upstream byte; a mid-stream transport
                death cuts the client connection, a typed upstream
                abort line relays verbatim. /predict always takes this
                path, /generate does when resume is off."""
                tried = []
                while True:
                    r0 = time.time() if tctx is not None else 0.0
                    rep = gw._route(fingerprint, exclude=tried)
                    if rep is None:
                        handler._shed_no_replica(tried)
                        return
                    if tctx is not None:
                        gw._trace_buf.emit('gw.route', tctx.child(),
                                           r0, time.time(),
                                           url=rep.base_url,
                                           cls=rep.cls)
                    tried.append(rep)
                    # the relay span's child ctx rides the forwarded
                    # request's X-Mxnet-Trace header: the replica's
                    # srv.* span nests under THIS hop, which is the
                    # skew-normalization anchor (send/receive bounds)
                    relay = gw._trace_buf.span(
                        'gw.relay', tctx, url=rep.base_url,
                        cls=rep.cls, attempt=len(tried))
                    with relay:
                        try:
                            resp = gw._forward(rep, path, body, ctype,
                                               tenant=tenant,
                                               trace_ctx=relay.ctx)
                        except urllib.error.HTTPError as exc:
                            # a typed upstream error (429/504/503/
                            # 500/400) passes through verbatim — incl.
                            # Retry-After, so client backoff sees the
                            # replica's queue estimate, not a gateway
                            # guess. EXCEPT a 503 Draining: that is
                            # the replica's exit notice, not the
                            # client's problem — honor it by
                            # re-routing NOW to another class member
                            if exc.code == 503:
                                raw = b''
                                try:
                                    raw = exc.read()
                                except Exception:
                                    pass
                                if _draining_body(raw):
                                    rep.mark(False, 'draining',
                                             draining=True)
                                    gw._bump('failovers')
                                    inst = _instruments()
                                    if inst is not None:
                                        inst.failovers.inc()
                                    gw._note_health(
                                        len(gw.healthy_replicas()))
                                    continue
                                handler._relay_consumed(exc, raw)
                                return
                            if exc.code == 429:
                                gw._bump('passthrough_429')
                            handler._relay_response(exc,
                                                    streaming=False)
                            return
                        except Exception as exc:
                            # transport-level failure: the replica is
                            # gone — mark it down NOW and fail over
                            # (no bytes were relayed yet, so a retry
                            # is safe)
                            rep.mark(False, '%s: %s'
                                     % (type(exc).__name__, exc))
                            gw._bump('failovers')
                            inst = _instruments()
                            if inst is not None:
                                inst.failovers.inc()
                            gw._note_health(
                                len(gw.healthy_replicas()))
                            continue
                        try:
                            with resp:
                                handler._relay_response(
                                    resp,
                                    streaming=(path == '/generate'))
                        except _hc.HTTPException as exc:
                            # upstream died MID-stream (IncompleteRead
                            # on a killed replica): mark it down now,
                            # cut the client connection (the chunked
                            # stream cannot be terminated cleanly) —
                            # no failover, bytes already went out
                            rep.mark(False, '%s: %s'
                                     % (type(exc).__name__, exc))
                            gw._note_health(
                                len(gw.healthy_replicas()))
                            handler.close_connection = True
                            return
                        except OSError:
                            return   # client went away mid-stream
                        return

            # -- journaled streaming generate (mid-stream failover) ------

            def _chunk_line(handler, line):
                handler.wfile.write(b'%x\r\n' % len(line))
                handler.wfile.write(line + b'\r\n')
                handler.wfile.flush()

            def _chunk_obj(handler, obj):
                handler._chunk_line(
                    (json.dumps(obj, sort_keys=True) + '\n').encode())

            def _end_chunks(handler):
                try:
                    handler.wfile.write(b'0\r\n\r\n')
                    handler.wfile.flush()
                except OSError:
                    pass

            def _generate_resumable(handler, req, ctype, tenant,
                                    fingerprint, tctx=None):
                """Streamed /generate with the per-stream journal:
                relay token lines while recording them; on replica
                death re-admit prompt+emitted on a healthy replica and
                splice the continuation into the SAME client chunked
                stream, deduping by token index (at-most-once).

                A DRAINING replica finishes the stream with a clean
                ``finish_reason: "migrated"`` done line instead of an
                abort: the gateway fetches the exported seqstate from
                the replica's GET /drain, lands it on a healthy
                replica via POST /import (no re-prefill — the KV
                pages travel in the payload), and splices the
                continuation the same way. Past
                ``MXNET_TPU_GATEWAY_JOURNAL_MAX`` journaled tokens
                the journal degrades to a COUNT: a later resume
                re-admits the original prompt and dedups the
                regenerated prefix by index."""
                prompt = [int(t) for t in req['tokens']]
                orig_max_new = req.get('max_new_tokens')
                if orig_max_new is not None:
                    orig_max_new = int(orig_max_new)
                request_id = req.get('request_id') \
                    or gw._next_request_id()
                emitted = []        # journal: token values relayed
                relayed = 0         # dedup watermark (survives cap)
                capped = False      # journal overflowed journal_max
                attempts = 0        # resume attempts consumed
                spliced = 0         # drain handoffs spliced in
                migrate = None      # seqstate awaiting POST /import
                started = False     # client headers sent
                tried = []          # replicas tried for this segment
                handoff_live = False   # inline prefill-boundary
                #                        handoff in flight (vs a
                #                        drain-path migration)
                handoff_t0 = 0.0
                handoff_attempts = 0
                no_disagg = False   # handoff fell back: this request
                #                     stays monolithic on the prefill
                #                     class
                seg_ctx = None      # trace ctx of the current relay
                seg_t0 = 0.0        # wall start of the current relay
                handoff_ctx = None  # trace ctx of an in-flight handoff
                handoff_w0 = 0.0

                def _seg_emit(outcome, **extra):
                    # close the current gw.relay span exactly once per
                    # segment — emitted manually (not a with-block)
                    # because the 'segment' spans several try/except
                    # arms of the loop body
                    if seg_ctx is not None:
                        gw._trace_buf.emit(
                            'gw.relay', seg_ctx, seg_t0, time.time(),
                            url=rep.base_url, cls=rep.cls,
                            outcome=outcome, **extra)
                while True:
                    use_prefill_only = False
                    route_w0 = time.time() if tctx is not None else 0.0
                    if migrate is not None:
                        if handoff_live and handoff_attempts \
                                > gw.handoff_retries:
                            rep = None     # retry budget spent
                        else:
                            rep = gw._pick_decode(exclude=tried)
                        if rep is None and handoff_live:
                            # no decode-capable target left (or the
                            # retry budget is spent): monolithic
                            # fallback — finish on the prefill class
                            # via the journal, never a dropped request
                            gw._bump('handoff_fallbacks')
                            inst = _instruments()
                            if inst is not None:
                                inst.handoffs.labels(
                                    **{'class': 'decode',
                                       'outcome': 'fallback'}).inc()
                            _record_event(
                                'seq_handoff', stage='fallback',
                                request_id=request_id,
                                attempts=handoff_attempts,
                                tokens=relayed)
                            if handoff_ctx is not None:
                                gw._trace_buf.emit(
                                    'gw.handoff', handoff_ctx,
                                    handoff_w0, time.time(),
                                    outcome='fallback',
                                    attempts=handoff_attempts)
                                handoff_ctx = None
                            migrate = None
                            handoff_live = False
                            no_disagg = True
                            tried = []
                            continue
                        if rep is None:
                            # legacy drain-path migration: any
                            # healthy replica can land the import
                            rep = gw._route(fingerprint,
                                            exclude=tried)
                    else:
                        role = None
                        if gw.disaggregated:
                            has_p, has_d = gw._class_counts()
                            if no_disagg:
                                role = 'prefill' if has_p else None
                            elif has_p and has_d:
                                # the disaggregated path: admit on
                                # the prefill class; long-enough
                                # prompts run prefill only and hand
                                # their seqstate to the decode class
                                role = 'prefill'
                                use_prefill_only = (
                                    len(prompt)
                                    >= gw.disagg_min_prompt)
                            elif has_p:
                                # decode class down: degrade to
                                # monolithic on the prefill class
                                # (healthz says 'degraded', not shed)
                                role = 'prefill'
                            # decode-only survivors: role stays None
                            # — monolithic over whatever is healthy
                        rep = gw._route(fingerprint, exclude=tried,
                                        role=role)
                        if rep is None and role is not None:
                            use_prefill_only = False
                            rep = gw._route(fingerprint,
                                            exclude=tried)
                    if rep is None:
                        if not started:
                            handler._shed_no_replica(tried)
                        else:
                            gw._bump('resume_failures')
                            inst = _instruments()
                            if inst is not None:
                                inst.resume_failures.inc()
                            _record_event(
                                'gateway_resume_failed',
                                request_id=request_id,
                                attempts=attempts,
                                reason='no_healthy_replica',
                                tokens=relayed)
                            out = {
                                'done': True,
                                'error': 'no healthy serving '
                                         'replica to resume '
                                         'stream (%d tokens '
                                         'emitted, %d resume '
                                         'attempts)'
                                         % (relayed, attempts),
                                'error_class': 'ReplicaLost',
                                'tokens': list(emitted),
                                'resumed': attempts,
                                'request_id': request_id}
                            if capped:
                                out['journal_capped'] = True
                            try:
                                handler._chunk_obj(out)
                            except OSError:
                                return
                            handler._end_chunks()
                        return
                    if tctx is not None:
                        gw._trace_buf.emit('gw.route', tctx.child(),
                                           route_w0, time.time(),
                                           url=rep.base_url,
                                           cls=rep.cls)
                    tried.append(rep)
                    if migrate is not None:
                        seg_path = '/import'
                        # start_index=relayed keeps the continuation's
                        # client indices aligned even when the source
                        # admission was itself a re-admission (its
                        # payload['emitted'] counts only the segment)
                        body = json.dumps({'seqstate': migrate,
                                           'stream': True,
                                           'start_index': relayed
                                           }).encode()
                    else:
                        seg_path = '/generate'
                        payload = dict(req, request_id=request_id)
                        # the gateway owns the prefill_only decision:
                        # never let a client smuggle a seqstate line
                        # into its own stream
                        payload.pop('prefill_only', None)
                        if use_prefill_only:
                            payload['prefill_only'] = True
                        if relayed and capped:
                            # the token VALUES are gone — re-admit
                            # the original prompt; greedy decode
                            # re-derives the delivered prefix and the
                            # index dedup below keeps the client at
                            # at-most-once
                            pass
                        elif emitted:
                            payload['tokens'] = prompt + emitted
                            payload['start_index'] = len(emitted)
                            if orig_max_new is not None:
                                payload['max_new_tokens'] = \
                                    orig_max_new - len(emitted)
                        body = json.dumps(payload).encode()
                    if tctx is not None:
                        seg_ctx = tctx.child()
                        seg_t0 = time.time()
                    try:
                        resp = gw._forward(
                            rep, seg_path, body, ctype,
                            tenant=tenant,
                            timeout=(gw.handoff_timeout_s
                                     if handoff_live else None),
                            trace_ctx=seg_ctx)
                    except urllib.error.HTTPError as exc:
                        _seg_emit('refused', code=exc.code)
                        seg_ctx = None
                        if migrate is not None:
                            try:
                                exc.read()
                            except Exception:
                                pass
                            if handoff_live:
                                # the decode target refused the
                                # import (pool exhaustion, geometry/
                                # version check): the payload is
                                # intact — back off, then the next
                                # class member gets it
                                handoff_attempts += 1
                                gw._bump('handoff_retries')
                                inst = _instruments()
                                if inst is not None:
                                    inst.handoff_retries.inc()
                                _record_event(
                                    'seq_handoff', stage='retry',
                                    request_id=request_id,
                                    to_url=rep.base_url,
                                    reason='import %d' % exc.code,
                                    attempt=handoff_attempts)
                                time.sleep(gw._handoff_delay(
                                    handoff_attempts))
                                continue
                            # a drain-path import target refused the
                            # handoff (backpressure, geometry/version
                            # check): drop to the plain resume path —
                            # the journal (or the capped re-prefill)
                            # still completes the stream
                            gw._bump('migration_failures')
                            inst = _instruments()
                            if inst is not None:
                                inst.migration_failures.inc()
                            _record_event('gateway_migrate_failed',
                                          request_id=request_id,
                                          reason='import %d'
                                                 % exc.code,
                                          tokens=relayed)
                            migrate = None
                            continue
                        if not started:
                            if exc.code in (500, 502, 503):
                                # a typed 5xx at admission (e.g. the
                                # engine closing under the request on
                                # a dying host): zero bytes relayed,
                                # so trying another replica is safe —
                                # the health probe will catch up. A
                                # 503 Draining marks the replica
                                # draining (route-away, drain-pollable)
                                raw = b''
                                try:
                                    raw = exc.read()
                                except Exception:
                                    pass
                                if exc.code == 503 \
                                        and _draining_body(raw):
                                    rep.mark(False, 'draining',
                                             draining=True)
                                gw._bump('failovers')
                                inst = _instruments()
                                if inst is not None:
                                    inst.failovers.inc()
                                continue
                            # before any client byte: the verbatim
                            # passthrough contract (429 backpressure
                            # stays the replica's call, 4xx/504 are
                            # the client's problem)
                            if exc.code == 429:
                                gw._bump('passthrough_429')
                            handler._relay_response(exc,
                                                    streaming=False)
                            return
                        # typed refusal of a RESUME re-admission
                        # (e.g. the target's queue is full): try the
                        # next healthy replica for this segment
                        try:
                            exc.read()
                        except Exception:
                            pass
                        continue
                    except Exception as exc:
                        # transport failure before the segment's first
                        # byte: mark down + try the next replica
                        _seg_emit('transport_error')
                        seg_ctx = None
                        rep.mark(False, '%s: %s'
                                 % (type(exc).__name__, exc))
                        gw._bump('failovers')
                        inst = _instruments()
                        if inst is not None:
                            inst.failovers.inc()
                        if handoff_live and migrate is not None:
                            # a dead decode target consumes a handoff
                            # retry too — the budget bounds the hop,
                            # whatever killed it
                            handoff_attempts += 1
                            gw._bump('handoff_retries')
                            if inst is not None:
                                inst.handoff_retries.inc()
                        gw._note_health(len(gw.healthy_replicas()))
                        continue
                    if not started:
                        handler.send_response(resp.status)
                        handler.send_header(
                            'Content-Type',
                            resp.headers.get('Content-Type',
                                             'application/x-ndjson'))
                        handler.send_header('Transfer-Encoding',
                                            'chunked')
                        handler.end_headers()
                        started = True
                    if seg_path == '/import':
                        if tctx is not None:
                            w = time.time()
                            gw._trace_buf.emit(
                                'gw.splice', tctx.child(), w, w,
                                kind=('handoff' if handoff_live
                                      else 'drain'),
                                url=rep.base_url, tokens=relayed)
                        if handoff_ctx is not None:
                            gw._trace_buf.emit(
                                'gw.handoff', handoff_ctx,
                                handoff_w0, time.time(),
                                to_url=rep.base_url,
                                attempts=handoff_attempts)
                            handoff_ctx = None
                        if handoff_live:
                            dt = time.monotonic() - handoff_t0
                            gw._bump('handoffs')
                            inst = _instruments()
                            if inst is not None:
                                inst.handoffs.labels(
                                    **{'class': rep.cls,
                                       'outcome': 'spliced'}).inc()
                                inst.handoff_seconds.observe(dt)
                            _record_event(
                                'seq_handoff', stage='spliced',
                                request_id=request_id,
                                to_url=rep.base_url,
                                attempts=handoff_attempts,
                                seconds=round(dt, 6),
                                tokens=relayed)
                            handoff_live = False
                            _relay_budget(resp, gw.timeout_s)
                        else:
                            spliced += 1
                            gw._bump('migrated_streams')
                            inst = _instruments()
                            if inst is not None:
                                inst.migrations.inc()
                            _record_event('gateway_migrate',
                                          request_id=request_id,
                                          to_url=rep.base_url,
                                          tokens=relayed)
                        migrate = None
                    segment_tokens = 0
                    abort_line = None       # typed upstream abort obj
                    dead = False            # transport death
                    done = False            # clean final line relayed
                    migrating = False       # handoff/drain announced
                    inline_state = None     # seqstate on the done line
                    try:
                        with resp:
                            for line in resp:
                                if not line.strip():
                                    continue
                                try:
                                    obj = json.loads(line)
                                except ValueError:
                                    handler._chunk_line(
                                        line.rstrip(b'\n')
                                        + b'\n')
                                    continue
                                if 'token' in obj:
                                    idx = obj.get('index')
                                    if idx is not None \
                                            and idx < relayed:
                                        continue   # dedup: delivered
                                    relayed += 1
                                    if not capped:
                                        emitted.append(obj['token'])
                                        if 0 < gw.journal_max \
                                                < len(emitted):
                                            # past the cap the journal
                                            # degrades to the relayed
                                            # COUNT (typed re-prefill
                                            # fallback on resume)
                                            capped = True
                                            emitted = []
                                            gw._bump('journal_capped')
                                            inst = _instruments()
                                            if inst is not None:
                                                inst.journal_capped \
                                                    .inc()
                                            _record_event(
                                                'gateway_journal'
                                                '_capped',
                                                request_id=request_id,
                                                tokens=relayed)
                                    segment_tokens += 1
                                    handler._chunk_line(
                                        line.rstrip(b'\n') + b'\n')
                                elif obj.get('done'):
                                    if obj.get('error'):
                                        abort_line = obj
                                    elif obj.get('finish_reason') \
                                            == 'migrated':
                                        # clean handoff: do NOT relay
                                        # — a prefill-boundary export
                                        # carries its seqstate inline;
                                        # a drain export is fetched
                                        # from GET /drain below
                                        migrating = True
                                        inline_state = \
                                            obj.get('seqstate')
                                    else:
                                        if attempts or spliced:
                                            if not capped:
                                                obj['tokens'] = \
                                                    list(emitted)
                                            else:
                                                obj['journal_capped']\
                                                    = True
                                            obj['resumed'] = attempts
                                            if spliced:
                                                obj['migrated'] = \
                                                    spliced
                                            obj['request_id'] = \
                                                request_id
                                            handler._chunk_obj(obj)
                                        else:
                                            handler._chunk_line(
                                                line.rstrip(b'\n')
                                                + b'\n')
                                        done = True
                                    break
                                else:
                                    handler._chunk_line(
                                        line.rstrip(b'\n') + b'\n')
                    except _hc.HTTPException as exc:
                        rep.mark(False, '%s: %s'
                                 % (type(exc).__name__, exc))
                        gw._note_health(len(gw.healthy_replicas()))
                        dead = True
                    except OSError:
                        _seg_emit('client_gone',
                                  tokens=segment_tokens)
                        return     # client went away mid-stream
                    _seg_emit('done' if done
                              else 'migrating' if migrating
                              else 'dead' if dead
                              else 'abort' if abort_line is not None
                              else 'truncated',
                              tokens=segment_tokens)
                    seg_ctx = None
                    if done:
                        if (attempts or spliced) and segment_tokens:
                            inst = _instruments()
                            if inst is not None:
                                inst.resumed_tokens.inc(
                                    segment_tokens)
                        handler._end_chunks()
                        return
                    if migrating and inline_state is not None:
                        # prefill-boundary handoff: the seqstate rode
                        # the done line. The source replica is HEALTHY
                        # (this is the routine disaggregated path, not
                        # a drain) — keep it in rotation and POST the
                        # payload to the least-loaded decode-class
                        # member
                        migrate = inline_state
                        handoff_live = True
                        handoff_t0 = time.monotonic()
                        handoff_attempts = 0
                        tried = []
                        if tctx is not None:
                            handoff_ctx = tctx.child()
                            handoff_w0 = time.time()
                        _record_event('seq_handoff', stage='export',
                                      request_id=request_id,
                                      from_url=rep.base_url,
                                      tokens=relayed)
                        continue
                    if migrating:
                        # the replica drained under us: pull the
                        # exported seqstate (KV pages + position +
                        # emitted tokens) and continue on a healthy
                        # replica with ZERO re-prefill. The migrated
                        # done line races the drain worker publishing
                        # the payload set (ours streams out while the
                        # worker is still exporting its siblings), so
                        # poll until it lands or the drain completes
                        # without it.
                        drain_path = '/drain?request_id=' \
                            + urllib.parse.quote(str(request_id))
                        deadline = time.monotonic() \
                            + min(gw.timeout_s, 10.0)
                        dctx = None
                        dhdr = None
                        dw0 = 0.0
                        if tctx is not None:
                            # the drain polls carry a trace header so
                            # the replica's srv.drain spans parent to
                            # this gw.handoff(kind=drain) span instead
                            # of orphaning
                            dctx = tctx.child()
                            dhdr = {_trace.TRACE_HEADER:
                                    dctx.to_header()}
                            dw0 = time.time()
                        seqs = []
                        while True:
                            snap = gw._fetch_json(rep, drain_path,
                                                  headers=dhdr) \
                                or {}
                            seqs = snap.get('sequences') or []
                            if seqs or 'error' in snap \
                                    or snap.get('complete') \
                                    or time.monotonic() >= deadline:
                                break
                            time.sleep(0.05)
                        if dctx is not None:
                            gw._trace_buf.emit(
                                'gw.handoff', dctx, dw0, time.time(),
                                kind='drain', from_url=rep.base_url,
                                found=bool(seqs))
                        rep.mark(False, 'draining', draining=True)
                        gw._note_health(len(gw.healthy_replicas()))
                        if seqs:
                            migrate = seqs[0]
                            tried = [rep]
                            continue
                        # nothing to import (the drain window closed
                        # or the sequence finished): plain resume
                        gw._bump('migration_failures')
                        inst = _instruments()
                        if inst is not None:
                            inst.migration_failures.inc()
                        _record_event('gateway_migrate_failed',
                                      request_id=request_id,
                                      reason='no_payload',
                                      tokens=relayed)
                        dead = True
                    if not dead and abort_line is None:
                        # stream ended without a done line: the
                        # replica terminated the chunks while dying —
                        # same treatment as a transport death
                        rep.mark(False, 'stream truncated (no done '
                                        'line)')
                        gw._note_health(len(gw.healthy_replicas()))
                        dead = True
                    if orig_max_new is not None \
                            and relayed >= orig_max_new:
                        # every token the request asked for reached
                        # the client and only the done line was lost:
                        # a re-admission would ask a replica for 0 new
                        # tokens, which it refuses. Finish the stream
                        # from the journal, as the done branch does
                        out = {'done': True, 'finish_reason': 'length',
                               'request_id': request_id}
                        if not capped:
                            out['tokens'] = list(emitted)
                        else:
                            out['journal_capped'] = True
                        if attempts:
                            out['resumed'] = attempts
                        if spliced:
                            out['migrated'] = spliced
                        _record_event('gateway_done_lost',
                                      request_id=request_id,
                                      from_url=rep.base_url,
                                      tokens=relayed)
                        try:
                            handler._chunk_obj(out)
                        except OSError:
                            return
                        handler._end_chunks()
                        return
                    # the segment failed (typed abort OR transport
                    # death). Resume on a healthy replica while the
                    # budget lasts; past it, surface the typed abort.
                    if attempts < gw.resume_max:
                        attempts += 1
                        gw._bump('resumes')
                        inst = _instruments()
                        if inst is not None:
                            inst.resumes.inc()
                        if tctx is not None:
                            w = time.time()
                            gw._trace_buf.emit(
                                'gw.readmit', tctx.child(), w, w,
                                attempt=attempts,
                                cause=('transport' if dead else
                                       'abort'),
                                tokens=relayed)
                        _record_event(
                            'gateway_resume',
                            request_id=request_id,
                            attempt=attempts,
                            from_url=rep.base_url,
                            cause='transport' if dead else str(
                                abort_line.get('error_class')
                                or 'error'),
                            tokens=relayed,
                            journal_capped=capped)
                        tried = [rep]
                        continue
                    gw._bump('resume_failures')
                    inst = _instruments()
                    if inst is not None:
                        inst.resume_failures.inc()
                    _record_event('gateway_resume_failed',
                                  request_id=request_id,
                                  attempts=attempts,
                                  reason='budget_exhausted',
                                  tokens=relayed)
                    out = dict(abort_line) if abort_line is not None \
                        else {'done': True,
                              'error': 'replica lost mid-stream '
                                       '(resume budget exhausted '
                                       'after %d attempts)'
                                       % attempts,
                              'error_class': 'ReplicaLost'}
                    out['tokens'] = list(emitted)
                    if capped:
                        out['journal_capped'] = True
                    out['resumed'] = attempts
                    out['request_id'] = request_id
                    try:
                        handler._chunk_obj(out)
                    except OSError:
                        return
                    handler._end_chunks()
                    return

            def do_POST(handler):
                path = handler.path.rstrip('/')
                if path not in ('/predict', '/generate'):
                    handler.send_error(404)
                    return
                gw._bump('requests')
                inst = _instruments()
                if inst is not None:
                    inst.requests.inc()
                length = int(handler.headers.get('Content-Length',
                                                 0) or 0)
                body = handler.rfile.read(length) if length else b'{}'
                ctype = handler.headers.get('Content-Type')
                tenant = (handler.headers.get(gw.tenant_header)
                          or 'default').strip() or 'default'
                # request tracing: a client-minted bare identity
                # (all-zero span) makes gw.request the TREE ROOT;
                # every hop below propagates a child context. Untraced
                # requests take the shared null span — no header
                # parse, no allocation
                in_ctx = None
                if _trace.enabled():
                    in_ctx = _trace.parse_header(
                        handler.headers.get(_trace.TRACE_HEADER))
                with gw._trace_buf.span('gw.request', in_ctx,
                                        path=path) as rsp, \
                        _trace.activate(rsp.ctx):
                    tctx = rsp.ctx
                    admitted = None
                    if gw.admission is not None:
                        with gw._trace_buf.span('gw.admit', tctx,
                                                tenant=tenant):
                            ok, hint, reason = \
                                gw.admission.admit(tenant)
                        if not ok:
                            gw._bump('tenant_shed')
                            if inst is not None:
                                inst.tenant_rejected.labels(
                                    tenant=tenant,
                                    reason=reason).inc()
                            _record_event('tenant_reject',
                                          tenant=tenant,
                                          reason=reason,
                                          retry_after_s=round(hint,
                                                              3))
                            handler._json(
                                429,
                                {'error': 'tenant admission: %s'
                                          % reason,
                                 'tenant': tenant,
                                 'retry_after_s': round(hint, 3)},
                                headers={'Retry-After':
                                         str(max(1,
                                                 int(hint + 0.999)))})
                            return
                        admitted = tenant
                    try:
                        req = None
                        if path == '/generate':
                            try:
                                req = json.loads(body or b'{}')
                            except ValueError:
                                req = None  # replica answers the 400
                        # multi-adapter routing: body 'adapter' wins;
                        # an X-Mxnet-Adapter header folds INTO the
                        # body so resume re-admissions and handoffs
                        # (rebuilt from req) stay on the variant
                        adapter = None
                        if isinstance(req, dict):
                            adapter = req.get('adapter')
                            if adapter is None:
                                adapter = handler.headers.get(
                                    ADAPTER_HEADER)
                                if adapter is not None:
                                    req['adapter'] = adapter
                                    body = json.dumps(req).encode()
                        fingerprint = None
                        if gw.affinity and isinstance(req, dict) \
                                and req.get('tokens'):
                            try:
                                fingerprint = prefix_fingerprint(
                                    req['tokens'], adapter=adapter)
                            except (TypeError, ValueError):
                                fingerprint = None
                        if (path == '/generate' and gw.resume
                                and isinstance(req, dict)
                                and req.get('tokens')
                                and req.get('stream', True)):
                            handler._generate_resumable(
                                req, ctype, tenant, fingerprint,
                                tctx=tctx)
                        else:
                            handler._forward_plain(
                                path, body, ctype, tenant,
                                fingerprint=fingerprint, tctx=tctx)
                    finally:
                        if admitted is not None:
                            gw.admission.release(admitted)

            def log_message(handler, *args):
                pass

        class _GatewayServer(ThreadingHTTPServer):
            request_queue_size = 128
            daemon_threads = True

            def handle_error(server_self, request, client_address):
                import sys as _sys
                exc = _sys.exc_info()[1]
                if isinstance(exc, (ConnectionError, TimeoutError)):
                    return
                ThreadingHTTPServer.handle_error(
                    server_self, request, client_address)

        self._httpd = _GatewayServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name='mxnet-tpu-gateway')
        self._thread.start()
        self.probe_once()
        stop = threading.Event()

        def probe_loop():
            # staggered schedule: replica i's probes fire at phase
            # ((i + jitter(url)) / N) x period — N replicas spread
            # across the period instead of N simultaneous probes
            # every tick (the recovery thundering-herd)
            period = self.health_period_s
            n = len(self.replicas)
            base = time.monotonic()
            for i, rep in enumerate(self.replicas):
                rep.next_probe_at = base + period * (
                    (i + _probe_jitter_frac(rep.base_url)) / n)
            while True:
                due_at = min(r.next_probe_at for r in self.replicas)
                if stop.wait(max(0.0, due_at - time.monotonic())):
                    return
                now = time.monotonic()
                probed = False
                for rep in self.replicas:
                    if rep.next_probe_at <= now:
                        try:
                            self._probe_replica(rep)
                        except Exception:
                            pass   # a probe bug must not kill routing
                        # re-arm one period after THIS fire: the
                        # per-replica phase offsets persist
                        rep.next_probe_at = now + period
                        probed = True
                if probed:
                    self._note_health(len(self.healthy_replicas()))

        self._probe_stop = stop
        self._probe_thread = threading.Thread(
            target=probe_loop, daemon=True,
            name='mxnet-tpu-gateway-health')
        self._probe_thread.start()
        return self

    @property
    def base_url(self):
        return 'http://%s:%d' % (self.host, self.port)

    def stats(self):
        with self._stats_lock:
            out = dict(self._stats)
            routed = dict(self._class_routed)
        out['migrations'] = {
            'spliced': out.pop('migrated_streams', 0),
            'failures': out.pop('migration_failures', 0),
            'journal_capped': out.pop('journal_capped', 0),
        }
        out['handoff'] = {
            'spliced': out.pop('handoffs', 0),
            'retries': out.pop('handoff_retries', 0),
            'fallbacks': out.pop('handoff_fallbacks', 0),
        }
        classes = {}
        for rep in self.replicas:
            c = classes.setdefault(rep.cls, {
                'replicas': 0, 'healthy': 0, 'draining': 0,
                'routed': routed.get(rep.cls, 0), 'pool': {}})
            c['replicas'] += 1
            if rep.healthy:
                c['healthy'] += 1
            if rep.draining:
                c['draining'] += 1
            if rep.load is not None:
                c['pool'][rep.base_url] = rep.load
        out['classes'] = classes
        out['healthy'] = len(self.healthy_replicas())
        out['replicas'] = len(self.replicas)
        if self.admission is not None:
            out['tenants'] = self.admission.stats()
        return out

    def metrics_text(self):
        """The ``GET /metrics`` payload (Prometheus text format):
        gateway-local series — a per-replica ``mxnet_tpu_gateway_up``
        gauge labeled ``url``/``class`` and every scalar stats()
        counter as ``mxnet_tpu_gateway_events_total{event=...}`` —
        followed by the process metrics registry when telemetry is
        enabled."""
        lines = [
            '# HELP mxnet_tpu_gateway_up replica health from the '
            'gateway probe (1 healthy, 0 down/draining)',
            '# TYPE mxnet_tpu_gateway_up gauge',
        ]
        for rep in self.replicas:
            lines.append(
                'mxnet_tpu_gateway_up{url="%s",class="%s"} %d'
                % (rep.base_url, rep.cls, 1 if rep.healthy else 0))
        lines.append('# HELP mxnet_tpu_gateway_events_total '
                     'gateway request-path counters by event')
        lines.append('# TYPE mxnet_tpu_gateway_events_total counter')
        with self._stats_lock:
            flat = sorted((k, v) for k, v in self._stats.items()
                          if isinstance(v, (int, float)))
        for k, v in flat:
            lines.append(
                'mxnet_tpu_gateway_events_total{event="%s"} %d'
                % (k, v))
        head = '\n'.join(lines) + '\n'
        try:
            from ..observability import export as _export
            from ..observability import metrics as _metrics
            if _metrics.enabled():
                return head + _export.prometheus_text()
        except Exception:
            pass
        return head

    def stop(self):
        if self._probe_stop is not None:
            self._probe_stop.set()
            self._probe_thread.join(timeout=5.0)
            self._probe_thread = None
            self._probe_stop = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5.0)
            self._httpd = None
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
