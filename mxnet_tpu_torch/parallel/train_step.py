"""The training step, the counterpart of ``mxnet_tpu/parallel/train_step.py``
(``ParallelTrainer`` :119-236, ``_build`` :498-651, ``step_accum``
:843-958, ``build`` :1020, ``step_n`` :1030-1115, ``_hyper`` :1142-1155,
``step`` :1157-1236, ``snapshot`` / ``restore`` :1270-1318), on one
device.

The JAX trainer compiles forward, backward and the optimizer update into
one XLA program over a mesh (``_build`` :498-640), the update traced from
the optimizer's own ``update_multi_precision`` for every parameter
(``optimizer/fused.py``) and fused by XLA. The port's step body is the
same sequence of work on one device: the forward in training mode,
``mean(loss(outputs, labels))``, its backward (through the kernels'
``autograd.Function``s), then the whole-model update of every parameter,
in place (``optimizer/fused.py`` ``FusedUpdate``): on the card one launch
of the multi-tensor kernel a group of parameters of one form, on the CPU
its plain version, ``update_multi_precision`` parameter by parameter.

On a card the step is one program, as the reference's is: the first
:meth:`ParallelTrainer.step` of an input signature (shapes, dtypes and
``None`` positions) runs the body eagerly, which builds the kernels, the
library handles and the update's plans; the second captures forward,
loss, backward and update into one CUDA graph
(:class:`~mxnet_tpu_torch.capture.Program`) over static buffers, and
every later call copies its inputs and the step's per-parameter lr / wd
columns in with one host-to-device copy and replays. The gradients stay
where the capture put them (the backward overwrites them each replay),
the trainer's generator is registered with each graph (replay k draws
eager step k's dropout masks), the step's hyperparameters are resolved on
the host as before (``FusedUpdate``), and the returned loss is a copy.
A new signature is captured again, as the reference retraces; a capture
that fails raises (``CaptureError``), never falling back to eager steps.
:meth:`ParallelTrainer.step_n` (n replays, no host sync between them),
:meth:`ParallelTrainer.step_accum` (a graph a (signature, accum)) and
:meth:`ParallelTrainer.build` (captured with the state rewound) run the
same way; on the CPU every body runs uncaptured. What the JAX trainer
does that the port keeps:

  * the loss is ``mean(loss_fn(outs, labels))``, differentiated as is
    (``rescale_grad`` stays the optimizer's, 1 by default);
  * ``idx2name`` is filled at the first step when the optimizer has none,
    and the wd table is not rebuilt: weight decay reaches every
    parameter (see ``optimizer/optimizer.py``);
  * update counts, and so Adam's and AdamW's ``t``, run per parameter
    from 1; a
    parameter the loss does not reach gets a zero gradient and is still
    updated (its weight decays), as the traced update does;
  * parameters that take no gradient (``requires_grad`` False: the
    BatchNorm moving statistics, ``grad_req='null'`` in the JAX net) keep
    their index in ``idx2name`` but are not updated; the training-mode
    forward writes the new moving averages in place, where the JAX step
    writes its aux outputs back after the update (train_step.py:573-637);
  * dropout masks come from a ``torch.Generator`` that the trainer owns
    and seeds (``seed``); JAX's threefry masks cannot be reproduced;
  * AMP (``amp=``, train_step.py:170-196, 519-565): the forward and the
    loss run under the policy's scope (``amp.scope``), so each op casts
    its inputs by its class: the matmul family computes on bf16 copies
    of the float32 masters, and the gradients widen back to float32 at
    each parameter through the casts' backward. The loss widens to
    float32 before the mean. Masters and optimizer state stay float32;
  * low-precision parameters (a net after ``cast('bfloat16')``, with or
    without ``amp``; train_step.py:519-580): their gradients come out in
    their dtype, and the optimizer's low-precision protocol takes them:
    states from ``create_state_multi_precision`` (a float32 master under
    ``multi_precision``, else a warning and state in the weight's
    dtype), updates through ``update_multi_precision`` or the kernel's
    bf16 forms (with or without a float32 master).

  * ``snapshot`` / ``restore`` cover the parameters, the optimizer state
    (``leaves``, in the reference's order: each parameter that takes a
    gradient, its state's tensors depth first, as ``_flatten_state``
    walks them; SGD's momentum, AdamW's mean then variance, a master
    before its state), the update counts and ``num_update``, and the
    generator's state in place of the reference's base key; ``restore``
    copies into the storage the graphs were captured against, so a fresh
    trainer builds (captures) first and restores after.

An optimizer whose ``fusable`` is False (``SGLD``, ``Nadam``,
``LBSGD``) is refused with ``FusedUpdateError``: the JAX step traces it
anyway, and so freezes ``Nadam``'s host-side ``m_schedule`` (and SGLD's
and LBSGD's host reads) at their trace-time values; the port does not
copy that quirk (ROADMAP C3). ``gluon.Trainer`` runs their loops.

The step-boundary protocol of the reference (train_step.py:278-436):
``attach_preemption`` (a pending stop drains an emergency checkpoint
through the attached manager and raises ``Preempted``),
``attach_watchdog`` (a heartbeat before the dispatch, phase ``compile``
on a step that builds, else ``step``; the stall check after it) and
``attach_checkpointing(manager, every_n)`` (a checkpoint every ``every_n``
updates, ``MXNET_TPU_CKPT_EVERY_N_STEPS``) run around every entry point;
``step_n`` is one window, one boundary. :meth:`ParallelTrainer.
save_checkpoint` writes the reference's keys (``params``, ``leaves``,
``num_update``, ``update_counts``, ``opt_num_update``, ``base_key``,
``mesh``, ``zero``, ``amp``, ``rng``, ``process_count``, ``step``) with
numpy values, bf16 widened to float32 (exact) and narrowed back on
restore, plus ``generator``, the trainer's generator state as uint8; the
port has no base key and no global key chain, so ``base_key`` and ``rng``
are None. :meth:`ParallelTrainer.resume` restores the newest valid
checkpoint and returns ``(step, plan)``: a checkpoint of a larger mesh
(the JAX package's ``dp=2``) resumes under ``MXNET_TPU_ELASTIC`` with
``plan.accum_steps`` for :meth:`ParallelTrainer.step_accum`, and raises
``MeshShrinkError`` with elasticity off. A checkpoint without
``generator`` (the JAX package's) keeps the trainer's own stream, and
says so in the log: dropout draws differ across the packages.

Telemetry (the reference's ``_record_step_telemetry``,
train_step.py:1238-1270): each entry point records the host wall time of
its call, ``mxnet_tpu_compile_seconds`` and a ``compile`` flight event
(``program='fused_step'``) on a call that builds, else
``mxnet_tpu_step_seconds``; ``mxnet_tpu_steps_total``,
``mxnet_tpu_examples_total``, ``mxnet_tpu_global_step`` and a ``step``
event with ``n``. No sync is added. The first build and every capture run
under ``span('compile')``, the checkpoint writes under
``span('checkpoint')``, and ``step``'s dispatch under the profiler's
``op_span('fused_train_step')``, which fences on the step's loss while
the profiler runs. On the CPU (no capture) the series and events are the
JAX trainer's call for call. On a card a captured signature builds twice,
at its first call (the eager build) and at its second (the capture), so
it records one more ``compile``; the capture's own seconds are also in
:attr:`ParallelTrainer.compile_seconds`. A capture that fails while the
profiler runs raises ``ProfilerCaptureError`` (``capture.py``), never an
uncaptured step.

Not ported yet, and refused with ``NotImplementedError``: a mesh of more
than one device, ZeRO and the numerical guardrail (ROADMAP: "multi-GPU,
robustness layers and the tail"), and so the fp16 policy, whose dynamic
loss scaling the reference runs through that guardrail;
``prefetch_iter``, and the HLO collective accounting
(``MXNET_TPU_TELEMETRY_HLO``: one device has no collectives).
"""
from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from .. import amp as _amp
from .. import autograd as _autograd
from .. import config as _config
from .. import observability as _obs
from .. import profiler as _profiler
from ..capture import Program
from ..gluon.nn import Dropout
from ..observability import metrics as _metrics
from ..observability.spans import span as _span
from ..ops.kernels import multi_tensor as _mt
from ..optimizer import fused as _fused
from ..optimizer import optimizer as _optmod

__all__ = ['ParallelTrainer']


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _mesh_devices(mesh):
    if isinstance(mesh, dict):
        return math.prod(int(n) for n in mesh.values())
    return len(mesh)


def _host(a):
    """``a`` as a tensor (a numpy array or a tensor passes through)."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(a)


def _state_tensors(state):
    """The tensors of one optimizer state (None, a tensor, or nested
    tuples of them), in order."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _state_tensors(s)]


def _numpy(t):
    """A host tensor as numpy for a checkpoint: bf16 widened to float32
    (exact; narrowed back on restore)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _fence(t):
    """Wait for the device work that produces ``t`` (the profiler's fence
    on a step's loss); nothing for a CPU tensor."""
    if t is not None and t.device.type == 'cuda':
        torch.cuda.current_stream(t.device).synchronize()


def _copy_in(what, dst, values):
    """Copy each of ``values`` (tensors or numpy arrays) into the tensor
    of ``dst`` at its position, in its dtype; shapes must match."""
    if len(values) != len(dst):
        raise ValueError('restore: the state holds %d %s, this trainer %d'
                         % (len(values), what, len(dst)))
    for i, (t, v) in enumerate(zip(dst, values)):
        v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError('restore: %s %d has shape %s, this trainer %s'
                             % (what, i, tuple(v.shape), tuple(t.shape)))
        t.copy_(v)


class _Staged:
    """A captured step's static inputs: the update's (width,
    len(COLUMNS)) int32 columns, then each data and label tensor, each
    16-byte aligned in one device buffer (``dev``) that the replay reads,
    filled by one copy from one of two pinned staging buffers, each reused
    only once the copy out of it ran."""

    def __init__(self, device, width, specs):
        at, self._at = 0, []
        for shape, dtype in [((width, len(_mt.COLUMNS)), torch.int32)] \
                + list(specs):
            self._at.append((at, shape, dtype))
            at += -(-math.prod(shape) * dtype.itemsize // 16) * 16
        self.nbytes = max(at, 16)
        self.dev = torch.zeros(self.nbytes, dtype=torch.uint8, device=device)
        self.views = [self._view(self.dev, *a) for a in self._at]
        self._stage = [torch.zeros(self.nbytes, dtype=torch.uint8,
                                   pin_memory=True) for _ in range(2)]
        self._events = [torch.cuda.Event() for _ in range(2)]
        self._turn = 0

    @staticmethod
    def _view(buf, at, shape, dtype):
        n = math.prod(shape) * dtype.itemsize
        return buf[at:at + n].view(dtype).view(shape)

    def fill(self, host, cols, arrays):
        """``cols`` (np) and each of ``arrays`` (a host tensor; a card
        tensor is copied on the card after) into the host buffer
        ``host``."""
        views = [self._view(host, *a) for a in self._at]
        views[0].copy_(torch.from_numpy(cols))
        for v, a in zip(views[1:], arrays):
            if a.device.type == 'cpu':
                v.copy_(a)

    def load(self, cols, arrays):
        """One step's columns and inputs to the card: one host-to-device
        copy (then a card-to-card copy of each input already there)."""
        k = self._turn
        self._turn ^= 1
        self._events[k].synchronize()
        self.fill(self._stage[k], cols, arrays)
        self.dev.copy_(self._stage[k], non_blocking=True)
        self._events[k].record()
        for v, a in zip(self.views[1:], arrays):
            if a.device.type != 'cpu':
                v.copy_(a)


class _StepProgram:
    """One captured step: its staged inputs, static loss, update
    bindings and graph."""

    def __init__(self, trainer, specs):
        self.bindings = trainer._update.bind()
        self.staged = _Staged(trainer._device,
                              sum(b.size for _, b in self.bindings), specs)
        self.loss = torch.zeros((), dtype=trainer._loss_dtype,
                                device=trainer._device)
        self.scal = trainer._update.scalars()
        self.graph = None
        self.grads = []


class ParallelTrainer:
    """Gluon-style trainer whose ``step`` runs forward, backward and the
    update of every parameter of ``net`` on the net's device, as one
    captured program on a card.

    ``loss`` is a loss block, called as ``loss(outputs[0], labels[0])``,
    or a callable ``fn(outputs, labels)`` that receives the net's outputs
    and the labels (a list when there are several): multi-output models
    (BERT: MLM + NSP heads) compose their objective there. ``x`` / ``y``
    of :meth:`step` are one tensor (or numpy array) or a list; they are
    copied to the net's device.

    ``mesh`` may be None or a one-device mesh (a ``{axis: size}`` dict or
    a sequence of devices); ``guardrail`` and ``zero`` may be None or
    False. ``amp``: None reads the ``MXNET_TPU_AMP`` knob; False or
    ``'off'`` is off; True, ``'bf16'`` or a ``Policy`` without loss
    scaling turns it on (:func:`mxnet_tpu_torch.amp.resolve`).
    ``capture`` (True) captures the step on a card; set it False to run
    every step's body eagerly there (the reference the replays are held
    to).
    """

    capture = True

    def __init__(self, net, loss, optimizer='sgd', optimizer_params=None,
                 mesh=None, guardrail=None, zero=None, amp=None, seed=0):
        if mesh is not None and _mesh_devices(mesh) > 1:
            raise NotImplementedError(
                'ParallelTrainer: a mesh of %d devices is not ported yet '
                '(ROADMAP: "multi-GPU, robustness layers and the tail"); '
                'the port trains on one device' % _mesh_devices(mesh))
        if zero:
            raise NotImplementedError('ParallelTrainer: the ZeRO-sharded '
                                      'update is not ported yet (ROADMAP: '
                                      '"multi-GPU, robustness layers '
                                      'and the tail")')
        if guardrail:
            raise NotImplementedError('ParallelTrainer: the numerical '
                                      'guardrail is not ported yet (ROADMAP: '
                                      '"multi-GPU, robustness layers '
                                      'and the tail")')
        self._amp_policy = _amp.resolve(amp)
        if self._amp_policy is not None and self._amp_policy.loss_scaling:
            raise NotImplementedError(
                'ParallelTrainer: amp=%r needs dynamic loss scaling, which '
                'the reference runs through the numerical guardrail; the '
                'guardrail is not ported yet (ROADMAP: "multi-GPU, '
                'robustness layers and the tail")' % self._amp_policy.name)
        self._net = net
        self._loss = loss
        if isinstance(optimizer, str):
            self._opt = _optmod.create(optimizer, **(optimizer_params or {}))
        else:
            self._opt = optimizer
        if not self._opt.fusable:
            raise _fused.FusedUpdateError(
                'ParallelTrainer: %s is not fusable (its update reads host '
                'state each step), and the step is one program with the '
                'whole-model update; train it with gluon.Trainer, which '
                'runs its per-parameter loop (ROADMAP C3)'
                % type(self._opt).__name__)
        self._device = next(net.parameters()).device
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(int(seed))
        for m in net.modules():
            if isinstance(m, Dropout):
                m.generator = self._generator
        self._mesh = mesh
        self._params = None
        self._states = None
        self._update = None
        self._sig = None
        self._programs = {}       # key -> _StepProgram (None: warmed)
        self._loss_dtype = torch.float32
        self._preempt = None
        self._watchdog = None
        self._ckpt_mgr = None
        self._ckpt_every = 0
        self.compile_seconds = {}
        self.num_update = 0

    @property
    def learning_rate(self):
        return self._opt.lr

    def set_learning_rate(self, lr):
        """The optimizer's lr from the next step on (a captured step
        reads it from its per-step columns)."""
        self._opt.set_learning_rate(lr)

    @property
    def amp(self):
        """The active AMP policy's name ('bf16') or 'off'."""
        return self._amp_policy.name if self._amp_policy is not None \
            else 'off'

    @property
    def compile_count(self):
        """Step programs captured so far (their capture seconds in
        ``compile_seconds``, by kind and first input's shape)."""
        return sum(p is not None for p in self._programs.values())

    def _build(self):
        named = list(self._net.collect_params().tensors().items())
        opt = self._opt
        if not opt.idx2name:
            opt.idx2name = {i: n for i, (n, _) in enumerate(named)}
        # parameters that take no gradient (BatchNorm's moving statistics,
        # grad_req 'null' in the JAX net) are not updated: the forward
        # writes them in place
        self._all = [p for _, p in named]
        self._params = [(i, p) for i, (_, p) in enumerate(named)
                        if p.requires_grad]
        self._stats = [p for p in self._all if not p.requires_grad]
        self._states = [opt.create_state_multi_precision(i, p.detach())
                        for i, p in self._params]
        self._update = _fused.FusedUpdate(opt, self._params, self._states,
                                          self._device)

    def _check(self, what, xs, ys):
        """The reference's signature rule: input / label arity and
        ``None`` positions are fixed by the first call, which builds the
        step (under ``span('compile')``)."""
        if self._params is None:
            with _span('compile'):
                self._build()
        sig = (tuple(a is None for a in xs), len(ys))
        if self._sig is None:
            self._sig = sig
        elif sig != self._sig:
            raise ValueError(
                '%s called with input signature %r but the compiled step '
                'was built for %r -- input/label arity and None-positions '
                'must match the first call' % (what, sig, self._sig))

    @staticmethod
    def _arrays(xs, ys):
        """The step's live inputs, data then labels, as tensors."""
        return [_host(a) for a in xs if a is not None] + \
            [_host(a) for a in ys]

    def _key(self, arrays, accum=1):
        """A step program's key: its inputs' shapes and dtypes, ``accum``
        and the launch scalars the capture bakes in."""
        return (tuple((tuple(a.shape), a.dtype) for a in arrays), accum,
                tuple(sorted(self._update.scalars().items())))

    def _captures(self):
        return self.capture and self._device.type == 'cuda'

    # -- the step's bodies ---------------------------------------------------

    def _forward_backward(self, xs, ys):
        """Forward in training mode (``autograd.train_mode()``, which the
        gluon layers read), ``mean(loss)``, backward; the gradients
        accumulate into ``.grad``. Returns the loss."""
        net = self._net
        with _autograd.train_mode():
            with _amp.scope(self._amp_policy):
                outs = _as_list(net(*xs))
                if isinstance(self._loss, torch.nn.Module):
                    loss = self._loss(outs[0], ys[0])
                else:
                    loss = self._loss(outs if len(outs) > 1 else outs[0],
                                      ys if len(ys) > 1 else ys[0])
            if self._amp_policy is not None:
                # the mean sums in float32 whatever the loss's dtype
                loss = loss.to(torch.float32)
            loss = torch.mean(loss)
        loss.backward()
        return loss.detach()

    def _gradients(self, xs, ys, accum):
        """The step's gradients in ``.grad`` (which starts at None) and
        its loss: one pass, or ``accum`` microbatch passes over the
        leading-dim split of ``xs`` / ``ys``, their gradients summed and
        divided by ``accum`` and their losses averaged, the BatchNorm
        moving statistics following the last microbatch (each pass starts
        from the step's statistics), as the reference's accum step."""
        if accum == 1:
            return self._forward_backward(xs, ys)

        def split(a, i):
            return a.reshape((accum, a.shape[0] // accum)
                             + tuple(a.shape[1:]))[i]
        saved = [p.detach().clone() for p in self._stats]
        losses = []
        for i in range(accum):
            if i:
                with torch.no_grad():
                    for p, s in zip(self._stats, saved):
                        p.copy_(s)
            losses.append(self._forward_backward(
                [None if a is None else split(a, i) for a in xs],
                [split(a, i) for a in ys]))
        with torch.no_grad():
            for _, p in self._params:
                if p.grad is not None:
                    p.grad.div_(accum)
        return torch.mean(torch.stack(losses))

    def _eager(self, xs, ys, accum=1):
        """The step's body, uncaptured (a CPU step, and the first step of
        a signature on a card): inputs to the device, gradients, the
        update."""
        xs = [None if a is None else torch.as_tensor(a, device=self._device)
              for a in xs]
        ys = [torch.as_tensor(a, device=self._device) for a in ys]
        for _, p in self._params:
            p.grad = None
        loss = self._gradients(xs, ys, accum)
        self._loss_dtype = loss.dtype
        self._update()
        for _, p in self._params:
            p.grad = None
        self.num_update += 1
        return loss

    def _capture(self, key):
        """Capture the step of ``key`` over new static buffers: forward,
        loss, backward (into gradients the capture places) and the
        update reading its columns from the staged buffer."""
        specs, accum = key[:2]
        prog = _StepProgram(self, specs)
        views = prog.staged.views[1:]
        nx = len(self._sig[0]) - sum(self._sig[0])
        live = iter(views[:nx])
        xs = [None if none else next(live) for none in self._sig[0]]
        ys = views[nx:]
        for _, p in self._params:
            p.grad = None

        def body():
            prog.loss.copy_(self._gradients(xs, ys, accum))
            self._update.launch_bound(prog.bindings, prog.staged.views[0],
                                      prog.scal)
        # a pool of its own: the gradients it places stay allocated
        with _span('compile'):
            prog.graph = Program('ParallelTrainer step %r' % (key,), body,
                                 self._device, generators=(self._generator,))
        for _, b in prog.bindings:
            b.upload()
        self.compile_seconds['%s %s' % (
            'step' if accum == 1 else 'accum:%d' % accum,
            'x'.join(map(str, specs[0][0])))] = prog.graph.seconds
        # the graph's gradients stay allocated as long as it lives
        prog.grads = [p.grad for _, p in self._params]
        self._programs[key] = prog
        return prog

    def _program(self, arrays, accum=1):
        """The captured program for these inputs, capturing it at the
        second call of its key; None for an uncaptured step (the first
        call of a key, or no capture)."""
        if not self._captures():
            return None
        key = self._key(arrays, accum)
        if key not in self._programs:
            self._programs[key] = None          # this call warms it
            return None
        return self._programs[key] or self._capture(key)

    def _replay(self, prog, arrays):
        """One step through ``prog``: resolve the step's hypers, stage
        its columns and inputs, replay. Returns a copy of the loss."""
        a, wd, b, _ = self._update._hypers()
        prog.staged.load(self._update.columns(prog.bindings, a, wd, b),
                         arrays)
        prog.graph.run()
        self.num_update += 1
        return prog.loss.clone()

    # -- resilience attachments (the reference's step-boundary protocol) -----

    def attach_preemption(self, handler):
        """Attach a :class:`~mxnet_tpu_torch.resilience.PreemptionHandler`:
        every step boundary polls it; a pending stop (a signal or a
        scripted ``preempt`` fault) drains an emergency checkpoint through
        the attached manager and raises
        :class:`~mxnet_tpu_torch.resilience.Preempted` (the resumable
        rc)."""
        self._preempt = handler
        return self

    def attach_watchdog(self, watchdog):
        """Attach a :class:`~mxnet_tpu_torch.resilience.Watchdog`: each
        entry point heartbeats before its dispatch (phase ``compile`` on a
        call that builds, ``step`` after) and checks the stall budget after
        it: a stalled step (a scripted ``hang`` fault, or an overrun seen
        by the monitor) surfaces as the stall artifact and
        ``TunnelStallError``."""
        self._watchdog = watchdog
        return self

    def attach_checkpointing(self, manager, every_n=None):
        """Attach a ``CheckpointManager``: the trainer checkpoints itself
        every ``every_n`` updates (None: ``MXNET_TPU_CKPT_EVERY_N_STEPS``,
        0 for never) and is the drain target of an attached preemption
        handler."""
        if every_n is None:
            every_n = int(_config.get('MXNET_TPU_CKPT_EVERY_N_STEPS') or 0)
        self._ckpt_mgr = manager
        self._ckpt_every = int(every_n)
        return self

    def _boundary_pre(self, building):
        """Before any build or dispatch: the preemption drain first (a
        preempted process starts no other step), then the heartbeat
        arming the coming phase."""
        if self._preempt is not None and \
                self._preempt.check(self.num_update):
            if self._ckpt_mgr is not None and self._params is not None:
                self._preempt.drain(
                    lambda: self.save_checkpoint(self._ckpt_mgr))
            self._preempt.exit(step=self.num_update)
        if self._watchdog is not None:
            self._watchdog.beat(self.num_update,
                                phase='compile' if building else 'step')

    def _boundary_post(self):
        if self._watchdog is not None:
            self._watchdog.check()
        if self._ckpt_mgr is not None and self._ckpt_every and \
                self.num_update % self._ckpt_every == 0:
            self.save_checkpoint(self._ckpt_mgr)

    def _builds(self, arrays, accum=1):
        """True when a call on ``arrays`` builds: the trainer's first, or
        on a card the one that captures their signature."""
        if self._params is None:
            return True
        if not self._captures():
            return False
        key = self._key(arrays, accum)
        return key in self._programs and self._programs[key] is None

    def save_checkpoint(self, manager=None, extra=None):
        """Atomic step-granular checkpoint, numbered by ``num_update``:
        :meth:`snapshot` as numpy under the reference's keys, plus the
        mesh, ``zero``, ``amp`` and ``process_count``: what a restarted
        process needs for a deterministic resume. Returns the path."""
        from ..resilience.elastic import mesh_meta
        manager = manager or self._ckpt_mgr
        if manager is None:
            raise ValueError('no CheckpointManager attached or given')
        state = self.snapshot()
        state['params'] = [_numpy(t) for t in state['params']]
        state['leaves'] = [_numpy(t) for t in state['leaves']]
        state['generator'] = state['generator'].numpy()
        state.update(mesh=mesh_meta(self._mesh), zero=False, amp=self.amp,
                     rng=None, process_count=1)
        if extra:
            state.update(extra)
        # CheckpointManager.save counts the write and records its event;
        # the span gives the wall time to this phase
        with _span('checkpoint'):
            return manager.save(self.num_update, state)

    def resume(self, manager=None, elastic=None):
        """Restore the newest valid checkpoint into this built trainer;
        returns ``(step, plan)``, or None when there is none.

        A checkpoint of a mesh with more devices than this trainer's
        (one) resumes when elasticity is on (``elastic``, else
        ``MXNET_TPU_ELASTIC``): the returned
        :class:`~mxnet_tpu_torch.resilience.ElasticPlan` says how many
        microbatches a step accumulates (:meth:`step_accum`) to keep the
        global batch. With elasticity off, or for a shrink that cannot
        keep the semantics, it raises
        :class:`~mxnet_tpu_torch.resilience.MeshShrinkError`."""
        from ..resilience import elastic as _elastic
        manager = manager or self._ckpt_mgr
        if manager is None:
            raise ValueError('no CheckpointManager attached or given')
        latest = manager.latest()
        if latest is None:
            return None
        step, state = latest
        plan = None
        meta = state.get('mesh')
        here = _elastic.mesh_meta(self._mesh)
        if meta is not None and meta['device_count'] != \
                here['device_count']:
            if elastic is None:
                elastic = bool(_config.get('MXNET_TPU_ELASTIC'))
            if not elastic:
                raise _elastic.MeshShrinkError(
                    'checkpoint mesh %s != trainer mesh %s and elastic '
                    'resume is disabled (MXNET_TPU_ELASTIC=0)'
                    % (meta, here))
            plan = _elastic.shrink_plan(meta, here['device_count'])
            if plan.new_axes != here['axes']:
                raise _elastic.MeshShrinkError(
                    'elastic plan wants mesh axes %s but the trainer '
                    'was built on %s -- rebuild the mesh from the plan'
                    % (plan.new_axes, here['axes']))
        if state.get('zero'):
            # checkpoints hold logical arrays: a ZeRO checkpoint restores
            # onto the one-device trainer with its values unchanged
            logging.warning('resume: checkpoint was written with zero=True, '
                            'the trainer has one device -- state re-placed '
                            'unsharded (values unchanged)')
        if state.get('amp') is not None and state['amp'] != self.amp:
            logging.info('resume: checkpoint was written with amp=%s, '
                         'trainer runs amp=%s -- masters restored unchanged',
                         state['amp'], self.amp)
        self.restore(state)
        return step, plan

    # -- entry points --------------------------------------------------------

    def _dispatch(self, what, xs, ys, accum=1):
        """One step, no boundary and no telemetry: the signature checked
        (the first call builds), the program for these inputs, the step;
        returns its loss."""
        self._check(what, xs, ys)
        arrays = self._arrays(xs, ys)
        prog = self._program(arrays, accum)
        if prog is None:
            return self._eager(xs, ys, accum)
        return self._replay(prog, arrays)

    def _record_step_telemetry(self, built, t0, examples, nsteps=1):
        """The reference's per-dispatch telemetry: the compile or step
        seconds histogram, the step and example counters, the cursor
        gauge and a flight event. Host wall time only: no device sync."""
        dt = time.perf_counter() - t0
        inst = _obs.trainer_instruments()
        step = self.num_update - nsteps
        if built:
            inst.compile_seconds.observe(dt)
            _obs.record_event('compile', program='fused_step', step=step,
                              seconds=round(dt, 6))
        else:
            inst.step_seconds.observe(dt)
        inst.steps.inc(nsteps)
        if examples:
            inst.examples.inc(examples)
        inst.global_step.set(self.num_update)
        _obs.record_event('step', step=step, n=nsteps, seconds=round(dt, 6))

    def step(self, x, y):
        """One training step; returns the step's loss, a scalar tensor on
        the net's device (a copy; reading it waits for the device). With
        attachments, the step-boundary protocol runs around it:
        preemption drain, heartbeat, dispatch, stall check, periodic
        checkpoint."""
        xs, ys = _as_list(x), _as_list(y)
        building = self._builds(self._arrays(xs, ys))
        self._boundary_pre(building)
        tel = _metrics.enabled()
        t0 = time.perf_counter() if tel else 0.0
        loss = None
        with _profiler.op_span('fused_train_step', lambda: _fence(loss)):
            loss = self._dispatch('ParallelTrainer.step', xs, ys)
        if tel:
            self._record_step_telemetry(building, t0,
                                        int(ys[0].shape[0]) if ys else 0)
        self._boundary_post()
        return loss

    def step_accum(self, x, y, accum):
        """One optimizer update from ``accum`` microbatches, the leading
        dim of ``x`` / ``y`` (the full batch) split into ``accum`` equal
        parts: their gradients summed and divided by ``accum``, one
        update, one ``num_update`` advance, the BatchNorm moving
        statistics following the last microbatch; returns the mean loss.
        ``accum <= 1`` is :meth:`step`. A graph a (signature, accum)."""
        accum = int(accum)
        if accum <= 1:
            return self.step(x, y)
        xs, ys = _as_list(x), _as_list(y)
        arrays = self._arrays(xs, ys)
        building = self._builds(arrays, accum)
        self._boundary_pre(building)
        for a in arrays:
            if a.shape[0] % accum:
                raise ValueError('global batch %d does not split into %d '
                                 'microbatches' % (a.shape[0], accum))
        tel = _metrics.enabled()
        t0 = time.perf_counter() if tel else 0.0
        loss = self._dispatch('step_accum', xs, ys, accum)
        if tel:
            self._record_step_telemetry(building, t0,
                                        int(ys[0].shape[0]) if ys else 0)
        self._boundary_post()
        return loss

    def step_n(self, x, y):
        """One step per leading-dim slice of ``x`` / ``y``; returns the
        (n,) losses, as n calls of :meth:`step` (bitwise). On a card the
        inputs and all n steps' hypers (resolved ahead) cross to the card
        in one copy, and the n steps are n replays with no host sync
        between them. The step-boundary protocol runs once a window, as
        in the reference."""
        xs, ys = _as_list(x), _as_list(y)
        live = [a for a in xs if a is not None]
        arrays = self._arrays(xs, ys) if live and ys else []
        building = self._params is None or (
            bool(arrays) and self._captures() and not self._ready(arrays))
        self._boundary_pre(building)
        if not live or not ys:
            raise ValueError('step_n needs at least one data and one '
                             'label array')
        n = int(live[0].shape[0])
        if n == 0:
            raise ValueError('step_n called with a zero-length leading '
                             '(steps) dimension')
        tel = _metrics.enabled()
        t0 = time.perf_counter() if tel else 0.0
        self._check('step_n', xs, ys)
        losses = []
        k = 0
        while k < n and not self._ready(arrays):
            losses.append(self._dispatch('step_n', [None if a is None
                                                    else a[k] for a in xs],
                                         [a[k] for a in ys]))
            k += 1
        if k < n:
            losses.append(self._replay_n([a[k:] for a in arrays]))
        if tel:
            self._record_step_telemetry(building, t0,
                                        n * int(ys[0].shape[1]), nsteps=n)
        self._boundary_post()
        return torch.cat([l.reshape(-1) for l in losses])

    def _ready(self, arrays):
        """True when a step on slice 0 of ``arrays`` replays a captured
        program (and :meth:`_replay_n` can run the rest)."""
        return self._captures() and self._programs.get(
            self._key([a[0] for a in arrays])) is not None

    def _replay_n(self, arrays):
        """n replays of the captured step over the slices of ``arrays``:
        every slice's inputs and columns staged in one host buffer and
        copied in once, then per replay a copy on the card."""
        n = int(arrays[0].shape[0])
        prog = self._programs[self._key([a[0] for a in arrays])]
        st = prog.staged
        hypers = [self._update._hypers()[:3] for _ in range(n)]
        host = torch.zeros((n, st.nbytes), dtype=torch.uint8,
                           pin_memory=True)
        for i, (a, wd, b) in enumerate(hypers):
            st.fill(host[i], self._update.columns(prog.bindings, a, wd, b),
                    [t[i] for t in arrays])
        dev = host.to(self._device, non_blocking=True)
        losses = torch.empty(n, dtype=prog.loss.dtype, device=self._device)
        for i in range(n):
            st.dev.copy_(dev[i])
            for v, t in zip(st.views[1:], arrays):
                if t.device.type != 'cpu':
                    v.copy_(t[i])
            prog.graph.run()
            losses[i].copy_(prog.loss)
        self.num_update += n
        return losses

    def build(self, x, y):
        """Build the step for these inputs without running it: on a card
        its program is captured after one warm-up step that the trainer's
        state is rewound from (:meth:`snapshot` / :meth:`restore`)."""
        xs, ys = _as_list(x), _as_list(y)
        if self._params is None:
            self._build()           # the reference's build has no span
        self._check('build', xs, ys)
        key = self._key(self._arrays(xs, ys))
        if self._captures() and self._programs.get(key) is None:
            snap = self.snapshot()
            self._eager(xs, ys)
            self.restore(snap)
            self._capture(key)
        return self

    # -- rollback (the reference's guardrail contract) -----------------------

    def snapshot(self):
        """Host copies of everything a step moves, under the reference's
        keys: the parameters (the BatchNorm statistics among them), the
        optimizer state (``leaves``), the update counts, ``num_update``,
        and the generator's state in place of the base key
        (``base_key`` None). Feed to :meth:`restore` for a bit-exact
        rewind."""
        if self._params is None:
            raise RuntimeError('snapshot() before the step is built; call '
                               'build(x, y) (or one step) first')
        return {
            'num_update': self.num_update,
            'params': [p.detach().to('cpu', copy=True) for p in self._all],
            'leaves': [t.detach().to('cpu', copy=True) for st in self._states
                       for t in _state_tensors(st)],
            'base_key': None,
            'update_counts': dict(self._opt._index_update_count),
            'opt_num_update': self._opt.num_update,
            'generator': self._generator.get_state(),
        }

    @torch.no_grad()
    def restore(self, state):
        """Rewind to a :meth:`snapshot` or a loaded checkpoint (numpy
        values; bf16 parameters narrowed back from their float32 copies),
        copying into the storage the captured steps read and write. A
        state without ``generator`` (a checkpoint of the JAX package)
        leaves the trainer's generator as it is, and says so."""
        if self._params is None:
            raise RuntimeError('restore() on an un-built trainer')
        _copy_in('parameters', self._all, state['params'])
        _copy_in('optimizer-state tensors', [
            t for st in self._states for t in _state_tensors(st)],
            state['leaves'])
        self.num_update = int(state['num_update'])
        self._opt._index_update_count.clear()
        self._opt._index_update_count.update(state['update_counts'])
        self._opt.num_update = state.get('opt_num_update', 0)
        gen = state.get('generator')
        if gen is None:
            logging.warning('restore: the state has no generator state (a '
                            'checkpoint of the JAX package has a base key '
                            'instead): the trainer keeps its own dropout '
                            'stream')
        else:
            self._generator.set_state(torch.as_tensor(
                np.asarray(gen, dtype=np.uint8)).clone())
