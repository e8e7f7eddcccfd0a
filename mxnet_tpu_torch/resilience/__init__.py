"""The resilience layer of the port, the counterpart of
``mxnet_tpu/resilience``:

  * ``policy``     -- Retry / Timeout / Deadline / CircuitBreaker and the
                      scripted FaultInjector (``MXNET_TPU_FAULT``);
  * ``checkpoint`` -- the atomic write (temp + fsync + rename), and the
                      trainer's checkpoints: ``save_state`` /
                      ``load_state`` (the reference's framing, a
                      restricted unpickler) and ``CheckpointManager``;
  * ``watchdog``   -- per-phase stall budgets and the
                      ``mxnet_tpu.stall.v1`` artifact, escalating by
                      :class:`TunnelStallError`;
  * ``preempt``    -- the SIGTERM drain and the resumable exit
                      (:class:`PreemptionHandler`, :class:`Preempted`,
                      rc ``MXNET_TPU_PREEMPT_EXIT_CODE``), which a serving
                      endpoint's ``install_preempt_hook`` and the
                      trainer's ``attach_preemption`` drive;
  * ``elastic``    -- the mesh-shrink resume: ``shrink_plan`` /
                      ``host_loss_plan``, ``available_devices`` (the
                      ``device_loss@elastic.restart`` fault),
                      ``mesh_meta``, ``MeshShrinkError``.

The serving paths run every device call under a breaker and a watchdog
(``serving/decode/engine.py``, ``serving/server.py``) and complete work
on the CPU, visibly, only after a transient device fault or while the
breaker is open; a kernel's build or launch failure is never transient.

``ParallelTrainer`` (``parallel/train_step.py``) takes a handler, a
watchdog and a manager at its step boundaries (``attach_preemption``,
``attach_watchdog``, ``attach_checkpointing``, ``save_checkpoint``,
``resume``); ``python -m mxnet_tpu_torch.resilience`` runs the
reference's self-test (``--train``, ``--watchdog-smoke``).

Not ported: ``device.acquire_backend(allow_cpu_fallback=True)``, because
carrying on without a card at start-up is what the port refuses (its
entry points raise, ``context.resolve_device``); the degraded-mode
artifacts (``artifact.py``, ``run_instrument``: they need
``acquire_backend`` and the port's bench script, ROADMAP A10) and the
gluon ``Trainer`` wiring (``snapshot_gluon`` / ``restore_gluon``, A10).
"""
from __future__ import annotations

from .checkpoint import (CheckpointManager, atomic_replace,
                         atomic_write_bytes, load_state, save_state)
from .elastic import (ElasticPlan, MeshShrinkError, available_devices,
                      host_loss_plan, mesh_meta, shrink_plan)
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
    'atomic_write_bytes', 'atomic_replace', 'save_state', 'load_state',
    'CheckpointManager', 'STALL_SCHEMA', 'Watchdog', 'stall_record',
    'Preempted', 'PreemptionHandler', 'resumable_exit_code',
    'MeshShrinkError', 'ElasticPlan', 'shrink_plan', 'host_loss_plan',
    'available_devices', 'mesh_meta']
