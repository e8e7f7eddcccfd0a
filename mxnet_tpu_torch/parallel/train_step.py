"""The training step, the counterpart of ``mxnet_tpu/parallel/train_step.py``
(``ParallelTrainer`` :119-236, ``_build`` :498-651, ``_hyper`` :1142-1155,
``step`` :1157-1236), on one device.

The JAX trainer compiles forward, backward and the optimizer update into
one XLA program over a mesh (``_build`` :498-640), the update traced from
the optimizer's own ``update_multi_precision`` for every parameter
(``optimizer/fused.py``) and fused by XLA. PyTorch runs eagerly, so the
port's step is the same sequence of work issued in order on one device:
the forward in training mode, ``mean(loss(outputs, labels))``, its
backward (through the kernels' ``autograd.Function``s), then the
whole-model update of every parameter, in place
(``optimizer/fused.py`` ``FusedUpdate``): on the card one launch of the
multi-tensor kernel a group of parameters of one form, on the CPU its
plain version, ``update_multi_precision`` parameter by parameter. What
the JAX trainer does that the port keeps:

  * the loss is ``mean(loss_fn(outs, labels))``, differentiated as is
    (``rescale_grad`` stays the optimizer's, 1 by default);
  * ``idx2name`` is filled at the first step when the optimizer has none,
    and the wd table is not rebuilt: weight decay reaches every
    parameter (see ``optimizer/optimizer.py``);
  * update counts, and so AdamW's ``t``, run per parameter from 1; a
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

Not ported yet, and refused with ``NotImplementedError``: a mesh of more
than one device, ZeRO and the numerical guardrail (ROADMAP: "multi-GPU,
robustness layers and the tail"), and so the fp16 policy, whose dynamic
loss scaling the reference runs through that guardrail.
"""
from __future__ import annotations

import math

import torch

from .. import amp as _amp
from ..gluon.nn import Dropout
from ..optimizer import fused as _fused
from ..optimizer import optimizer as _optmod

__all__ = ['ParallelTrainer']


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _mesh_devices(mesh):
    if isinstance(mesh, dict):
        return math.prod(int(n) for n in mesh.values())
    return len(mesh)


class ParallelTrainer:
    """Gluon-style trainer whose ``step`` runs forward, backward and the
    update of every parameter of ``net`` on the net's device.

    ``loss`` is a loss block, called as ``loss(outputs[0], labels[0])``,
    or a callable ``fn(outputs, labels)`` that receives the net's outputs
    and the labels (a list when there are several): multi-output models
    (BERT: MLM + NSP heads) compose their objective there. ``x`` / ``y``
    of :meth:`step` are one tensor (or numpy array) or a list; they are
    moved to the net's device.

    ``mesh`` may be None or a one-device mesh (a ``{axis: size}`` dict or
    a sequence of devices); ``guardrail`` and ``zero`` may be None or
    False. ``amp``: None reads the ``MXNET_TPU_AMP`` knob; False or
    ``'off'`` is off; True, ``'bf16'`` or a ``Policy`` without loss
    scaling turns it on (:func:`mxnet_tpu_torch.amp.resolve`).
    """

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
        self._device = next(net.parameters()).device
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(int(seed))
        for m in net.modules():
            if isinstance(m, Dropout):
                m.generator = self._generator
        self._params = None
        self._states = None
        self._update = None
        self.num_update = 0

    @property
    def learning_rate(self):
        return self._opt.lr

    @property
    def amp(self):
        """The active AMP policy's name ('bf16') or 'off'."""
        return self._amp_policy.name if self._amp_policy is not None \
            else 'off'

    def _build(self):
        named = list(self._net.collect_params().items())
        opt = self._opt
        if not opt.idx2name:
            opt.idx2name = {i: n for i, (n, _) in enumerate(named)}
        # parameters that take no gradient (BatchNorm's moving statistics,
        # grad_req 'null' in the JAX net) are not updated: the forward
        # writes them in place
        self._params = [(i, p) for i, (_, p) in enumerate(named)
                        if p.requires_grad]
        self._states = [opt.create_state_multi_precision(i, p.detach())
                        for i, p in self._params]
        self._update = _fused.FusedUpdate(opt, self._params, self._states,
                                          self._device)

    def _to_device(self, a):
        return torch.as_tensor(a, device=self._device)

    def step(self, x, y):
        """One training step; returns the step's loss, a scalar tensor on
        the net's device (reading it waits for the device)."""
        if self._params is None:
            self._build()
        xs = [None if a is None else self._to_device(a) for a in _as_list(x)]
        ys = [self._to_device(a) for a in _as_list(y)]
        net = self._net
        for _, p in self._params:
            p.grad = None
        net.train(True)
        try:
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
        finally:
            net.train(False)
        loss.backward()
        self._update()
        for _, p in self._params:
            p.grad = None
        self.num_update += 1
        return loss.detach()
