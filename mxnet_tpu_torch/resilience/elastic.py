"""Elastic mesh shrink: resume training on fewer devices, the port of
``mxnet_tpu/resilience/elastic.py``.

Checkpoints store logical (full, host-side) arrays, so restoring onto a
smaller mesh is a placement decision, not a data transformation. What this
module owns is the semantics of the shrink:

  * :func:`shrink_plan` -- given the checkpoint's mesh and the devices
    present after a restart, the new mesh axes and the gradient
    accumulation factor that keeps the global batch: dp 8 -> 4 gives
    ``accum_steps=2``, two microbatches whose mean of means equals the
    full-batch mean for equal sizes, so the loss trajectory matches the
    uninterrupted run to float32 tolerance;
  * :func:`available_devices` -- the restart's device probe, with the
    scripted ``device_loss`` fault (``MXNET_TPU_FAULT=
    device_loss@elastic.restart:1``) halving the devices it reports;
  * :class:`MeshShrinkError` -- a shrink that cannot keep the semantics
    (model-parallel axes that no longer fit, a replica count that does
    not divide, a batch that does not split) raises instead of training a
    different job.

The port trains on one device (``ParallelTrainer`` refuses a larger
mesh), so its trainers' :func:`mesh_meta` is ``{'axes': {'dp': 1},
'device_count': 1, 'process_count': 1}``, and a checkpoint of a larger
mesh (the JAX package's, say ``dp=2``) resumes here by accumulation:
``shrink_plan(meta, 1)``. Divergences of such a resume, as in the
reference: BatchNorm statistics follow the last microbatch, and the
reduction order changes; both are float tolerance, not bit-exact.
"""
from __future__ import annotations

import logging
import math

from ..observability import emit as _emit
from .policy import DeviceLossError, ResilienceError, inject

__all__ = ['MeshShrinkError', 'ElasticPlan', 'shrink_plan',
           'host_loss_plan', 'available_devices', 'mesh_meta']


class MeshShrinkError(ResilienceError):
    """The checkpoint's mesh cannot be mapped onto the surviving devices
    without changing training semantics."""


def mesh_meta(mesh=None):
    """A JSON-serializable description of a mesh, stored in checkpoints
    so that a restart can see a change of device (or host) count.
    ``mesh``: None (the port's one device), an ``{axis: size}`` dict or a
    sequence of devices (one ``dp`` axis over them)."""
    if mesh is None:
        axes = {'dp': 1}
    elif isinstance(mesh, dict):
        axes = {k: int(v) for k, v in mesh.items()}
    else:
        axes = {'dp': len(mesh)}
    return {'axes': axes, 'device_count': math.prod(axes.values()),
            'process_count': 1}


def available_devices(injector=None, platform=None):
    """The devices a restart sees: the CUDA cards (``platform`` None or
    ``'cuda'``; a host without one raises, as the port's entry points do)
    or ``[torch.device('cpu')]`` for ``'cpu'``. The ``elastic.restart``
    site consumes one scripted ``device_loss`` fault and halves the list:
    the stand-in for "the slice came back smaller"."""
    import torch
    from ..context import resolve_device
    if platform == 'cpu':
        devs = [torch.device('cpu')]
    else:
        resolve_device(platform)
        devs = [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    try:
        inject('elastic.restart', ('device_loss',), injector=injector)
    except DeviceLossError as exc:
        devs = devs[:max(1, len(devs) // 2)]
        logging.warning('elastic: %s -- restart sees %d device(s)',
                        exc, len(devs))
    return devs


class ElasticPlan:
    """How to resume a checkpoint on the devices present: ``new_axes`` is
    the mesh to build, ``accum_steps`` microbatches an optimizer step keep
    the global batch (1: no change), ``changed`` is False when the mesh
    survives intact."""

    __slots__ = ('old_axes', 'new_axes', 'accum_steps', 'changed',
                 'note')

    def __init__(self, old_axes, new_axes, accum_steps, note=''):
        self.old_axes = dict(old_axes)
        self.new_axes = dict(new_axes)
        self.accum_steps = int(accum_steps)
        self.changed = dict(old_axes) != dict(new_axes)
        self.note = note

    def as_dict(self):
        return {'old_axes': self.old_axes, 'new_axes': self.new_axes,
                'accum_steps': self.accum_steps,
                'changed': self.changed, 'note': self.note}

    def __repr__(self):
        return ('ElasticPlan(%s -> %s, accum_steps=%d)'
                % (self.old_axes, self.new_axes, self.accum_steps))


def shrink_plan(ckpt_mesh, n_devices, global_batch=None):
    """Map a checkpointed mesh (a :func:`mesh_meta` dict, or what
    :func:`mesh_meta` takes) onto ``n_devices`` surviving devices.

    Only the ``dp`` axis shrinks, and the shrink factor must divide the
    old ``dp``, so that each surviving replica adopts a whole number of
    lost replicas' microbatches. Raises :class:`MeshShrinkError` for
    anything that would change training semantics."""
    if not (isinstance(ckpt_mesh, dict) and 'axes' in ckpt_mesh):
        ckpt_mesh = mesh_meta(ckpt_mesh)
    old_axes = dict(ckpt_mesh['axes'])
    old_total = int(ckpt_mesh.get('device_count') or 1)
    n_devices = int(n_devices)
    if n_devices >= old_total:
        return ElasticPlan(old_axes, old_axes, 1,
                           note='mesh intact (%d device(s))' % old_total)

    old_dp = int(old_axes.get('dp', 1))
    fixed = old_total // max(1, old_dp)     # model/tp/pp/sp/ep product
    if n_devices < fixed or n_devices % fixed:
        raise MeshShrinkError(
            'cannot shrink mesh %s onto %d device(s): the non-dp axes '
            '(%s) need a multiple of %d devices (model-parallel shards '
            'are tied to program structure; documented divergence -- '
            'only the dp axis is elastic)'
            % (old_axes, n_devices,
               [k for k in old_axes if k != 'dp'] or 'none', fixed))
    new_dp = n_devices // fixed
    if old_dp % new_dp:
        raise MeshShrinkError(
            'cannot shrink dp=%d onto dp=%d: the replica count must '
            'divide evenly so each survivor adopts whole lost-replica '
            'microbatches (got %d survivors for %d replicas); resume '
            'on %s devices instead'
            % (old_dp, new_dp, new_dp, old_dp,
               sorted({fixed * d for d in range(1, old_dp + 1)
                       if old_dp % d == 0})))
    accum = old_dp // new_dp
    if global_batch is not None and int(global_batch) % (new_dp * accum):
        raise MeshShrinkError(
            'global batch %d does not split into %d microbatches over '
            'dp=%d' % (global_batch, accum, new_dp))
    new_axes = dict(old_axes)
    new_axes['dp'] = new_dp
    plan = ElasticPlan(
        old_axes, new_axes, accum,
        note='dp %d->%d; global batch preserved via %d-step gradient '
             'accumulation' % (old_dp, new_dp, accum))
    logging.warning('elastic: %s (%s)', plan, plan.note)
    return plan


def host_loss_plan(ckpt_mesh, surviving_processes, devices_per_host=None):
    """Whole-host loss: map a cross-host checkpoint mesh onto the hosts
    that survive. A lost host takes all its devices, so the shrink is
    host-granular: ``surviving_processes`` hosts of ``devices_per_host``
    devices (default: the checkpoint's device_count / process_count),
    the dp axis absorbing the loss as in :func:`shrink_plan`. Records the
    ``host_lost`` flight event of the decision."""
    if not (isinstance(ckpt_mesh, dict) and 'axes' in ckpt_mesh):
        ckpt_mesh = mesh_meta(ckpt_mesh)
    old_procs = int(ckpt_mesh.get('process_count') or 1)
    old_total = int(ckpt_mesh.get('device_count') or 1)
    surviving = int(surviving_processes)
    if surviving < 1:
        raise MeshShrinkError('no surviving hosts to re-form the mesh '
                              'on (surviving_processes=%d)' % surviving)
    if devices_per_host is None:
        if old_total % max(1, old_procs):
            raise MeshShrinkError(
                'checkpoint mesh has %d devices over %d hosts (not '
                'uniform) -- pass devices_per_host explicitly'
                % (old_total, old_procs))
        devices_per_host = old_total // max(1, old_procs)
    n_devices = surviving * int(devices_per_host)
    plan = shrink_plan(ckpt_mesh, n_devices)
    plan.note = ('host loss: %d -> %d host(s) x %d device(s); %s'
                 % (old_procs, surviving, devices_per_host, plan.note))
    _emit.event('host_lost', where='elastic', old_hosts=old_procs,
                surviving_hosts=surviving, accum_steps=plan.accum_steps)
    return plan
