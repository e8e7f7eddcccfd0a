"""The whole-model optimizer update, the counterpart of
``mxnet_tpu/optimizer/fused.py``.

The reference's ``ParallelTrainer`` traces the optimizer's own
``update_multi_precision`` for every parameter into its one program
(``_HyperPatch`` :86-116, ``apply_traced_updates`` :119-147), the
per-step hyperparameters (lr, wd, the update count ``t``,
``rescale_grad``) as float32 scalars, and XLA fuses the whole update
into a couple of kernels. The port runs eagerly; :class:`FusedUpdate`
keeps the one-update-a-step shape:

  * at build time it groups the updated parameters by the optimizer's
    rule (``SGD`` without or with momentum, ``AdamW``) and the form of
    each parameter (float32; bf16 without a master; bf16 with a float32
    master under ``multi_precision``);
  * at each step it resolves, on the host and in the order and with the
    scalars of the per-parameter path, each parameter's update count, lr
    and wd (the mult tables), AdamW's ``eta``, ``rescale_grad`` and
    ``clip_gradient``, then makes one launch of the multi-tensor kernel a
    group, through a plan that checked the group's weights and states and
    packed their part of the table once
    (``ops.kernels.multi_tensor.MultiTensorPlan``).

Its plain version is the per-parameter loop of ``update_multi_precision``,
which the CPU runs, and which the kernel is bitwise on the card. On a CUDA
device an optimizer other than the port's ``SGD`` and ``AdamW`` (a
subclass among them: its ``update`` may differ), or a weight of a form the
kernel has none for (float16), raises :class:`FusedUpdateError` when the
update is built; nothing falls back to the loop there.

Inside a captured training step (``parallel/train_step.py``) the update
is :meth:`FusedUpdate.bind` (tables made before the capture),
:meth:`FusedUpdate.launch_bound` (in it) and, before each replay, the
step's ``_hypers`` packed by :meth:`FusedUpdate.columns`:
the same per-parameter resolution, so the captured update stays bitwise
the plain loop.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import multi_tensor
from . import optimizer as _optmod

__all__ = ['FusedUpdate', 'FusedUpdateError', 'rule_of']


class FusedUpdateError(TypeError):
    """The whole-model update has no kernel for this optimizer or
    parameter on a CUDA device."""


def rule_of(opt):
    """The kernel's rule for ``opt`` ('sgd', 'sgd_mom', 'adamw'), or None
    for an optimizer it does not cover."""
    if type(opt) is _optmod.SGD:
        return 'sgd_mom' if opt.momentum != 0.0 else 'sgd'
    if type(opt) is _optmod.AdamW:
        return 'adamw'
    return None


class FusedUpdate:
    """One step of ``opt`` over ``params`` (``(index, Parameter)`` pairs)
    with their ``states`` (from ``create_state_multi_precision``) on
    ``device``: call it after the backward; each parameter's ``.grad``
    is its gradient (None: zero)."""

    def __init__(self, opt, params, states, device):
        self._opt = opt
        self._params = list(params)
        self._states = list(states)
        self._rule = rule_of(opt)
        self._plain = device.type == 'cpu'
        self._ptrs = self._plan = None
        self.groups = {}
        for pos, ((i, p), st) in enumerate(zip(self._params, self._states)):
            master = bool(opt.multi_precision
                          and _optmod._is_low_precision(p.dtype))
            form = multi_tensor.form_of(p.dtype, master)
            if not self._plain and (self._rule is None or form is None):
                raise FusedUpdateError(
                    'the whole-model update has no kernel for %s on %s '
                    'parameter %r (%s): it covers the port\'s SGD and '
                    'AdamW on float32 and bf16 weights'
                    % (type(opt).__name__, p.dtype, opt.idx2name.get(i, i),
                       device))
            self.groups.setdefault(form, []).append(pos)

    def _hypers(self):
        """Advance the update counts; each parameter's lr (AdamW: its
        ``eta``) and wd, resolved as ``update_multi_precision`` resolves
        them, parameter by parameter in order, and the launch's scalars.
        Called n times ahead, it gives n steps' (a captured window's)."""
        opt, rule = self._opt, self._rule
        a, wd = [], []
        for i, _ in self._params:
            lr, d = opt._begin(i)
            if rule == 'adamw':
                lr = opt._bias_corrected(lr, opt._step_of(i))
            a.append(lr)
            wd.append(d)
        return a, wd, self.scalars()

    def scalars(self):
        """The launch's scalars (the same every step until the optimizer's
        attributes change: a captured step bakes them in)."""
        opt, rule = self._opt, self._rule
        scal = dict(rescale_grad=opt.rescale_grad,
                    clip_gradient=opt.clip_gradient)
        if rule == 'adamw':
            scal.update(beta1=opt.beta1, beta2=opt.beta2,
                        epsilon=opt.epsilon, lr=1.0)
        elif rule == 'sgd_mom':
            scal['momentum'] = opt.momentum
        return scal

    def _group(self, poses):
        """(weights, states, masters) of the parameters at ``poses``."""
        states = [self._states[k] for k in poses]
        weights = [self._params[k][1].data for k in poses]
        if self._opt.multi_precision and \
                _optmod._is_low_precision(weights[0].dtype):
            return weights, [s[1] for s in states], [s[0] for s in states]
        return weights, states, None

    def _plans(self):
        """One :class:`~ops.kernels.multi_tensor.MultiTensorPlan` a group,
        made again when a parameter's storage moved (``p.data`` set)."""
        ptrs = [p.data_ptr() for _, p in self._params]
        if ptrs != self._ptrs:
            self._ptrs = ptrs
            self._plan = [(poses, multi_tensor.MultiTensorPlan(
                self._rule, *self._group(poses)))
                for poses in self.groups.values()]
        return self._plan

    @torch.no_grad()
    def __call__(self):
        if self._plain:
            opt = self._opt
            for (i, p), st in zip(self._params, self._states):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                opt.update_multi_precision(i, p.data, g, st)
            return
        plans = self._plans()
        a, wd, scal = self._hypers()
        for poses, plan in plans:
            plan.launch([self._params[k][1].grad for k in poses],
                        [a[k] for k in poses], [wd[k] for k in poses],
                        **scal)

    # -- inside a captured step ----------------------------------------------

    def bind(self):
        """One :class:`~ops.kernels.multi_tensor.BoundLaunch` a group, for
        a step about to be captured (their tables made before the
        capture)."""
        return [(poses, multi_tensor.BoundLaunch(plan))
                for poses, plan in self._plans()]

    @torch.no_grad()
    def launch_bound(self, bindings, cols, scal):
        """In the capture, after the backward: the update of each group
        from the static gradients, the step's columns read from ``cols``
        ((width, 3) int32 on the card)."""
        at = 0
        for poses, b in bindings:
            b.launch([self._params[k][1].grad for k in poses],
                     cols[at:at + b.size], **scal)
            at += b.size

    @staticmethod
    def columns(bindings, a, wd):
        """One step's (width, 3) int32 columns for its resolved ``a`` and
        ``wd`` (``_hypers``)."""
        return np.concatenate(
            [b.columns([a[k] for k in poses], [wd[k] for k in poses])
             for poses, b in bindings]) if bindings \
            else np.zeros((0, 3), np.int32)
