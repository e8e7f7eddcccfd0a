"""The open-loop load and chaos harness for the serving stack, the port of
``mxnet_tpu/loadgen``.

A Poisson-arrival, fixed-rate (never closed-loop) generator drives a live
:class:`~mxnet_tpu_torch.serving.ServingHTTPServer` (or the
``ServingGateway`` over several) over real HTTP on ``/predict`` and
``/generate`` (streamed NDJSON): capacity search, overload, a chaos soak,
the shared-prefix and multi-adapter workloads, gateway failover, the
drain, the prefill / decode handoff and tenant isolation. Each mode
returns a versioned ``mxnet_tpu.slo.v1`` artifact with its verdicts::

    python -m mxnet_tpu_torch.loadgen --mode overload --out SLO.json
"""
from .client import LoadClient, RequestRecord
from .harness import (DEFAULT_MIX, OVERLOAD_MIX, Dispatcher, GatewayRig,
                      ServingRig, run_adapters, run_capacity, run_chaos,
                      run_disagg, run_drain, run_gateway_failover,
                      run_overload, run_prefix, run_tenants)
from .report import (SLO_SCHEMA, build_artifact, latency_summary,
                     percentile, summarize)
from .schedule import Arrival, build_schedule

__all__ = [
    'Arrival', 'build_schedule',
    'LoadClient', 'RequestRecord',
    'SLO_SCHEMA', 'percentile', 'latency_summary', 'summarize',
    'build_artifact',
    'ServingRig', 'GatewayRig', 'Dispatcher', 'DEFAULT_MIX', 'OVERLOAD_MIX',
    'run_capacity', 'run_overload', 'run_chaos', 'run_prefix',
    'run_adapters', 'run_gateway_failover', 'run_drain', 'run_disagg',
    'run_tenants',
]
