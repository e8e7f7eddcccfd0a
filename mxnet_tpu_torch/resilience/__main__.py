"""Preemption / elasticity / watchdog self-test of the port, the port of
``mxnet_tpu/resilience/__main__.py``::

  # uninterrupted reference
  python -m mxnet_tpu_torch.resilience --train --steps 18 \\
      --ckpt-dir /tmp/d0 --out ref.json

  # preempted run: drains an emergency checkpoint at step 9 and exits
  # with the resumable rc (75)
  MXNET_TPU_FAULT=preempt@train.step.9:1 \\
  python -m mxnet_tpu_torch.resilience --train --steps 18 \\
      --ckpt-dir /tmp/d1 --out a.json

  # restart with the same command: resumes at step 9, finishes, and its
  # param_hash is bit-identical to ref.json's
  python -m mxnet_tpu_torch.resilience --train --steps 18 \\
      --ckpt-dir /tmp/d1 --out b.json

  # watchdog: a scripted hang at step 3 is detected within the stall
  # budget and the mxnet_tpu.stall.v1 artifact is written
  MXNET_TPU_FAULT=hang@train.step.3:1 \\
  python -m mxnet_tpu_torch.resilience --watchdog-smoke \\
      --stall-artifact /tmp/STALL.json --out w.json

``--device`` (``cuda``, the default, or ``cpu``) takes the place of the
reference's ``--devices``: the port trains on one device. A checkpoint of
a larger mesh (the JAX package's ``python -m mxnet_tpu.resilience --train
--devices 2``, ``dp=2``) resumes here elastically, each step accumulating
the lost replicas' microbatches (``shrink_plan``; ``MXNET_TPU_ELASTIC``),
and ``MXNET_TPU_FAULT=device_loss@elastic.restart:1`` halves the devices
the restart sees.

Everything is deterministic: per-step synthetic batches drawn from the
step index (the sampler-rewind contract), scripted faults in place of
real signals, weights drawn with numpy from the mode's seed (the
initializer family waits for ROADMAP A10; after a resume the weights are
the checkpoint's). The checkpoints are the trainer's
(``ParallelTrainer.save_checkpoint``), kept 3 deep as in the reference.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

FEATURES = 16
CLASSES = 4
SEED = 11


def _net_and_loss(device):
    """The reference's MLP, Dense(32, relu) -> Dense(4) over 16 features,
    its weights drawn with numpy from :data:`SEED` (Xavier's uniform
    range, biases 0)."""
    import numpy as np
    import torch
    from ..gluon import loss as gloss
    from ..gluon import nn
    rs = np.random.RandomState(SEED)
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation='relu', in_units=FEATURES,
                     prefix='dense0_', device=device),
            nn.Dense(CLASSES, in_units=32, prefix='dense1_', device=device))
    with torch.no_grad():
        for name, p in net.collect_params().tensors().items():
            if name.endswith('weight'):
                s = np.sqrt(6.0 / sum(p.shape))
                p.copy_(torch.from_numpy(
                    rs.uniform(-s, s, p.shape).astype('float32')))
    return net, gloss.SoftmaxCrossEntropyLoss()


def _batch(step, batch, device):
    """The batch of global step ``step`` (the reference's draw): the data
    order is a function of the step index, which makes a resume's
    fast-forward exact."""
    import numpy as np
    import torch
    rs = np.random.RandomState(1000 + step)
    x = rs.randn(batch, FEATURES).astype('float32')
    y = rs.randint(0, CLASSES, (batch,)).astype('float32')
    return (torch.tensor(x, device=device), torch.tensor(y, device=device))


def _param_hash(net):
    """sha256 over the names and float32 bytes of every parameter in name
    order: equal hashes, bit-identical parameters."""
    import numpy as np
    h = hashlib.sha256()
    for name, p in sorted(net.collect_params().tensors().items()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(p.detach().cpu().numpy(),
                                      dtype='<f4').tobytes())
    return h.hexdigest()


def _write(path, payload):
    from .checkpoint import atomic_write_bytes
    atomic_write_bytes(path, (json.dumps(payload, indent=1,
                                         sort_keys=True) + '\n').encode())


def _configure_flight(args):
    """Point the flight recorder at the requested artifact, so an
    injected stall or preemption dumps where the caller looks."""
    from .. import observability
    observability.configure_flight(path=args.flight_artifact,
                                   name='resilience-selftest')


def run_train(args):
    from ..parallel import ParallelTrainer
    from . import (CheckpointManager, PreemptionHandler, Watchdog,
                   available_devices, shrink_plan)

    _configure_flight(args)
    # the port trains on one device; the probe honors
    # device_loss@elastic.restart all the same
    device = available_devices(platform=args.device)[0]
    mgr = CheckpointManager(args.ckpt_dir, prefix='pt', keep=3) \
        if args.ckpt_dir else None
    latest = mgr.latest() if mgr is not None else None

    accum = 1
    axes = {'dp': 1}
    if latest is not None and latest[1].get('mesh'):
        plan = shrink_plan(latest[1]['mesh'], 1)
        axes, accum = plan.new_axes, plan.accum_steps
    net, loss = _net_and_loss(device)
    pt = ParallelTrainer(net, loss, 'sgd',
                         {'learning_rate': 0.1, 'momentum': 0.9}, axes)
    if args.batch % accum:
        raise SystemExit('batch %d not divisible by accum %d'
                         % (args.batch, accum))
    x0, y0 = _batch(0, args.batch, device)
    micro = args.batch // accum
    pt.build(x0[:micro], y0[:micro])

    start = 0
    if mgr is not None:
        resumed = pt.resume(mgr)
        if resumed is not None:
            start = resumed[0]
            print('selftest: resumed at step %d (accum=%d, mesh=%s)'
                  % (start, accum, axes), flush=True)

    handler = PreemptionHandler().install()
    watchdog = Watchdog(artifact_path=args.stall_artifact)
    pt.attach_preemption(handler).attach_watchdog(watchdog)
    if mgr is not None:
        pt.attach_checkpointing(mgr, every_n=args.ckpt_every)

    losses = []
    for step in range(start, args.steps):
        x, y = _batch(step, args.batch, device)
        if accum > 1:
            out = pt.step_accum(x, y, accum)
        else:
            out = pt.step(x, y)
        losses.append(float(out))

    _write(args.out, {
        'steps': args.steps,
        'start_step': start,
        'accum': accum,
        'mesh': axes,
        'device': str(device),
        'losses': losses,
        'final_loss': losses[-1] if losses else None,
        'param_hash': _param_hash(net),
    })
    print('selftest: trained steps [%d, %d) accum=%d on %s -> %s'
          % (start, args.steps, accum, device, args.out), flush=True)
    return 0


def run_watchdog_smoke(args):
    from ..context import resolve_device
    from ..parallel import ParallelTrainer
    from . import TunnelStallError, Watchdog

    _configure_flight(args)
    device = resolve_device(args.device)
    net, loss = _net_and_loss(device)
    pt = ParallelTrainer(net, loss, 'sgd', {'learning_rate': 0.1})
    watchdog = Watchdog(artifact_path=args.stall_artifact,
                        name='watchdog-smoke')
    pt.attach_watchdog(watchdog)
    detected = None
    try:
        for step in range(args.steps):
            pt.step(*_batch(step, args.batch, device))
    except TunnelStallError as exc:
        detected = {'step': pt.num_update - 1, 'error': str(exc)}
    record = watchdog.last_record or {}
    artifact_ok = os.path.exists(args.stall_artifact)
    _write(args.out, {
        'detected': detected is not None,
        'detail': detected,
        'artifact': args.stall_artifact if artifact_ok else None,
        'schema': record.get('schema'),
        'phase': record.get('phase'),
        'waited_s': record.get('waited_s'),
        'budget_s': record.get('budget_s'),
    })
    ok = detected is not None and artifact_ok
    print('selftest: watchdog %s (artifact=%s)'
          % ('detected the hang' if ok else 'MISSED the hang',
             args.stall_artifact), flush=True)
    return 0 if ok else 1


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m mxnet_tpu_torch.resilience',
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument('--train', action='store_true',
                      help='deterministic training leg (preempt / resume / '
                           'elastic-shrink contract)')
    mode.add_argument('--watchdog-smoke', action='store_true',
                      help='injected-hang detection leg')
    p.add_argument('--steps', type=int, default=18)
    p.add_argument('--batch', type=int, default=32)
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    p.add_argument('--ckpt-dir', default=None)
    p.add_argument('--ckpt-every', type=int, default=5)
    p.add_argument('--out', default='SELFTEST.json')
    p.add_argument('--stall-artifact', default='STALL.json')
    p.add_argument('--flight-artifact', default='FLIGHT.jsonl',
                   help='flight-recorder dump path (written on an injected '
                        'stall or preemption; schema mxnet_tpu.flight.v1)')
    args = p.parse_args(argv)
    if args.train:
        return run_train(args)
    return run_watchdog_smoke(args)


if __name__ == '__main__':
    sys.exit(main())
