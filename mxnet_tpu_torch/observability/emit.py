"""The emit helpers of the serving and resilience paths, the reference's
``_serving_instruments`` / ``_record_event`` / ``_flight_dump`` (the
helpers ``mxnet_tpu/serving/decode/engine.py:84-108`` and
``serving/batcher.py:90-104`` each keep a copy of; the gateway's
``_record_event`` is :func:`event`).

Each is one flag read while telemetry is off (``MXNET_TPU_TELEMETRY=0``:
:func:`serving` returns None, the others return at once). A failing emit
is swallowed, as in the reference, because a metric must not fail a
request; the values they take are host values the caller already holds,
so no emit reads a device tensor or hides a device error.
"""
from __future__ import annotations

from . import metrics as _metrics
from . import recorder as _recorder
from . import serving_instruments

__all__ = ['serving', 'event', 'dump']


def serving():
    """The serving instruments, or None while telemetry is off."""
    if not _metrics.enabled():
        return None
    try:
        return serving_instruments()
    except Exception:
        return None


def event(kind, **fields):
    """Record one flight event (nothing while telemetry is off)."""
    if not _metrics.enabled():
        return
    try:
        _recorder.record_event(kind, **fields)
    except Exception:
        pass


def dump(reason):
    """Dump the flight ring (nothing while telemetry is off)."""
    if not _metrics.enabled():
        return
    try:
        _recorder.flight_dump(reason=reason)
    except Exception:
        pass
