"""The resilience layer of the port, the counterpart of
``mxnet_tpu/resilience``:

  * ``policy``     -- Retry / Timeout / Deadline / CircuitBreaker and the
                      scripted FaultInjector (``MXNET_TPU_FAULT``);
  * ``checkpoint`` -- the atomic write (temp + fsync + rename) the stall
                      artifact goes through;
  * ``watchdog``   -- per-phase stall budgets and the
                      ``mxnet_tpu.stall.v1`` artifact, escalating by
                      :class:`TunnelStallError`;
  * ``preempt``    -- the SIGTERM drain and the resumable exit
                      (:class:`PreemptionHandler`, :class:`Preempted`,
                      rc ``MXNET_TPU_PREEMPT_EXIT_CODE``), which a serving
                      endpoint's ``install_preempt_hook`` drives.

The serving paths run every device call under a breaker and a watchdog
(``serving/decode/engine.py``, ``serving/server.py``) and complete work
on the CPU, visibly, only after a transient device fault or while the
breaker is open; a kernel's build or launch failure is never transient.

Not ported: ``device.acquire_backend(allow_cpu_fallback=True)``, because
carrying on without a card at start-up is what the port refuses (its
entry points raise, ``context.resolve_device``); the degraded-mode
artifacts, the trainer's preemption hook, elastic resume and the
trainer's checkpoints wait for the trainer's hooks (ROADMAP A11).
"""
from __future__ import annotations

from .checkpoint import atomic_replace, atomic_write_bytes
from .policy import (CircuitBreaker, CircuitOpenError, Deadline,
                     DeviceLossError, DeviceUnavailableError, FaultInjector,
                     HangError, InjectedFault, PreemptionSignal,
                     ResilienceError, Retry, RetryExhausted, Timeout,
                     TimeoutExpired, TunnelStallError, WorkerCrashError,
                     get_injector, inject, is_transient, poison)
from .preempt import Preempted, PreemptionHandler, resumable_exit_code
from .watchdog import STALL_SCHEMA, Watchdog, stall_record

__all__ = [
    'Retry', 'Timeout', 'Deadline', 'CircuitBreaker', 'FaultInjector',
    'get_injector', 'inject', 'poison', 'ResilienceError', 'RetryExhausted',
    'TimeoutExpired', 'CircuitOpenError', 'InjectedFault',
    'DeviceUnavailableError', 'TunnelStallError', 'WorkerCrashError',
    'PreemptionSignal', 'HangError', 'DeviceLossError', 'is_transient',
    'atomic_write_bytes', 'atomic_replace', 'STALL_SCHEMA', 'Watchdog',
    'stall_record', 'Preempted', 'PreemptionHandler', 'resumable_exit_code']
