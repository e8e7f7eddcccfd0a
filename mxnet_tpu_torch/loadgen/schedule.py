"""Open-loop arrival schedules, the port of
``mxnet_tpu/loadgen/schedule.py``: WHEN requests fire, decided up front.

Arrivals are independent of completions: a slow server does not slow the
offered rate down, so queueing delay shows up in the measured latency
instead of silently throttling the experiment (the coordinated-omission
trap of a closed-loop benchmark). The schedule is pure math over an
injectable rng: the same (qps, duration, mix, seed) gives the same arrival
times and request kinds, the reference's for the same seed (both draw
from ``random.Random``), so a load run replays and the dispatcher can be
tested without a server. Stdlib only.
"""
from __future__ import annotations

import random

__all__ = ['Arrival', 'build_schedule']


class Arrival:
    """One scheduled request: fire at ``t`` seconds after start."""

    __slots__ = ('t', 'kind', 'rid')

    def __init__(self, t, kind, rid):
        self.t = float(t)
        self.kind = kind          # 'predict' | 'generate'
        self.rid = int(rid)

    def __repr__(self):
        return 'Arrival(t=%.6f, kind=%r, rid=%d)' % (self.t, self.kind,
                                                     self.rid)


def build_schedule(qps, duration_s, mix=None, seed=0, poisson=True,
                   rng=None):
    """Arrival times for an open-loop run.

    ``qps``        offered rate (arrivals per second, > 0)
    ``duration_s`` schedule length; arrivals land in [0, duration_s)
    ``mix``        {'predict': w, 'generate': w} request-kind weights
                   (default: predict only); kinds are drawn from the
                   same rng as the gaps, so the whole schedule is one
                   deterministic function of the seed
    ``poisson``    True (default) draws exponential inter-arrival gaps
                   (memoryless arrivals, the M/*/* of the paper SLO
                   claim); False fires at a fixed 1/qps cadence
    ``rng``        injectable ``random.Random``-alike; overrides seed

    Returns a list of :class:`Arrival` sorted by time.
    """
    if qps <= 0:
        raise ValueError('qps must be > 0, got %r' % (qps,))
    if duration_s <= 0:
        raise ValueError('duration_s must be > 0, got %r'
                         % (duration_s,))
    mix = dict(mix) if mix else {'predict': 1.0}
    total = float(sum(mix.values()))
    if total <= 0 or any(w < 0 for w in mix.values()):
        raise ValueError('mix weights must be >= 0 with a positive '
                         'sum: %r' % (mix,))
    kinds = sorted(mix)           # deterministic iteration order
    rng = rng if rng is not None else random.Random(seed)
    out = []
    t = 0.0
    rid = 0
    while True:
        t += rng.expovariate(qps) if poisson else 1.0 / qps
        if t >= duration_s:
            break
        pick = rng.random() * total
        acc = 0.0
        kind = kinds[-1]
        for k in kinds:
            acc += mix[k]
            if pick < acc:
                kind = k
                break
        out.append(Arrival(t, kind, rid))
        rid += 1
    return out
