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
    rule (:func:`rule_of`: one for each fusable optimizer; ``SGD``,
    ``NAG`` and ``DCASGD`` without or with momentum, ``Signum``'s
    signsgd or signum, ``RMSProp`` plain or centered) and the form of
    each parameter (float32; bf16 without a master, for SGD and AdamW;
    bf16 with a float32 master under ``multi_precision``);
  * at each step it resolves, on the host and in the order and with the
    scalars of the per-parameter path, each parameter's update count, lr
    and wd (the mult tables) and the rule's per-parameter factors (AdamW's
    ``eta``, Adam's bias-corrected lr, FTML's ``(1 - beta1^t) / lr`` and
    ``1 - beta2^t``, Adamax's ``lr / (1 - beta1^t)``, Signum's ``1 - lr
    wd_lh``), ``rescale_grad`` and ``clip_gradient``, then makes one
    launch of the multi-tensor kernel a group, through a plan that checked
    the group's weights and states and packed their part of the table
    once (``ops.kernels.multi_tensor.MultiTensorPlan``).

Its plain version is the per-parameter loop of ``update_multi_precision``,
which the CPU runs, and which the kernel is bitwise on the card. An
optimizer whose ``fusable`` is False (``SGLD``, ``Nadam``, ``LBSGD``) runs
that loop on the card too, as the reference's ``Trainer`` runs them
(trainer.py:335): it is their design, not a fallback. On a CUDA device a
fusable optimizer without a rule (a subclass of one with a rule: its
update may differ), or a weight of a form the kernel has none for
(float16; bf16 without a master under a rule other than SGD's and
AdamW's), raises :class:`FusedUpdateError` when the update is built;
nothing falls back to the loop there.

Inside a captured training step (``parallel/train_step.py``) the update
is :meth:`FusedUpdate.bind` (tables made before the capture),
:meth:`FusedUpdate.launch_bound` (in it) and, before each replay, the
step's ``_hypers`` packed by :meth:`FusedUpdate.columns`:
the same per-parameter resolution, so the captured update of every rule
stays bitwise the plain loop, Adam's lr changing every step included.
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


def _momentum_rule(name):
    return lambda opt: name + '_mom' if opt.momentum != 0.0 else name


# the optimizer classes (exactly those types) the kernel has rules for
_RULES = {
    _optmod.SGD: _momentum_rule('sgd'),
    _optmod.ccSGD: _momentum_rule('sgd'),
    _optmod.AdamW: lambda opt: 'adamw',
    _optmod.Adam: lambda opt: 'adam',
    _optmod.NAG: _momentum_rule('nag'),
    _optmod.Signum: lambda opt: 'signum' if opt.momentum != 0.0
    else 'signsgd',
    _optmod.FTML: lambda opt: 'ftml',
    _optmod.DCASGD: _momentum_rule('dcasgd'),
    _optmod.AdaGrad: lambda opt: 'adagrad',
    _optmod.RMSProp: lambda opt: 'rmspropalex' if opt.centered
    else 'rmsprop',
    _optmod.AdaDelta: lambda opt: 'adadelta',
    _optmod.Ftrl: lambda opt: 'ftrl',
    _optmod.Adamax: lambda opt: 'adamax',
    _optmod.Test: lambda opt: 'test',
}


def rule_of(opt):
    """The kernel's rule for ``opt`` (one of ``multi_tensor.RULES``), or
    None for an optimizer it does not cover: a subclass of one it covers,
    or one whose ``fusable`` is False."""
    pick = _RULES.get(type(opt))
    return None if pick is None else pick(opt)


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
        # the CPU, and the optimizers the reference keeps out of its fused
        # update, run the per-parameter loop
        self._plain = device.type == 'cpu' or not opt.fusable
        self._ptrs = self._plan = None
        self.groups = {}
        for pos, ((i, p), st) in enumerate(zip(self._params, self._states)):
            master = bool(opt.multi_precision
                          and _optmod._is_low_precision(p.dtype))
            form = multi_tensor.form_of(p.dtype, master)
            if not self._plain and (
                    self._rule is None or form is None
                    or (form == 'low'
                        and self._rule not in multi_tensor.LOW_RULES)):
                raise FusedUpdateError(
                    'the whole-model update has no kernel for %s on %s '
                    'parameter %r (%s): it covers %s on float32 weights and '
                    'bf16 ones with a float32 master (multi_precision), and '
                    'SGD and AdamW on bf16 weights without one'
                    % (type(opt).__name__, p.dtype, opt.idx2name.get(i, i),
                       device, ', '.join(sorted(
                           k.__name__ for k in _RULES))))
            self.groups.setdefault(form, []).append(pos)

    def _hypers(self):
        """Advance the update counts; each parameter's a (the lr, or the
        rule's factor), wd and b (the rule's second factor), resolved as
        ``update_multi_precision`` resolves them, parameter by parameter
        in order, and the launch's scalars. Called n times ahead, it gives
        n steps' (a captured window's)."""
        opt, rule = self._opt, self._rule
        a, wd, b = [], [], []
        for i, _ in self._params:
            if rule == 'test':
                # Test.update reads no lr or wd and counts no update
                a.append(0.0)
                wd.append(0.0)
                b.append(0.0)
                continue
            lr, d = opt._begin(i)
            extra = 0.0
            if rule in ('adamw', 'adam'):
                lr = opt._bias_corrected(lr, opt._step_of(i))
            elif rule == 'ftml':
                t = opt._step_of(i)
                lr, extra = (1 - opt.beta1 ** t) / lr, 1 - opt.beta2 ** t
            elif rule == 'adamax':
                lr /= 1. - opt.beta1 ** opt._step_of(i)
            elif rule == 'signum':
                extra = 1 - lr * opt.wd_lh
            a.append(lr)
            wd.append(d)
            b.append(extra)
        return a, wd, b, self.scalars()

    def scalars(self):
        """The launch's scalars (the same every step until the optimizer's
        attributes change: a captured step bakes them in), as
        ``multi_tensor.launch_scalars``' keywords: ``beta1`` / ``beta2``
        carry RMSProp's gamma1 / gamma2, AdaDelta's rho and Signum's
        momentum (its ``1 - momentum``), ``k0`` / ``k1`` DCASGD's lamda,
        Ftrl's lamda1 / beta and RMSProp's clip_weights (``k_on``)."""
        opt, rule = self._opt, self._rule
        scal = dict(rescale_grad=opt.rescale_grad,
                    clip_gradient=opt.clip_gradient)
        if rule == 'adamw':
            scal.update(beta1=opt.beta1, beta2=opt.beta2,
                        epsilon=opt.epsilon, lr=1.0)
        elif rule in ('adam', 'ftml'):
            scal.update(beta1=opt.beta1, beta2=opt.beta2,
                        epsilon=opt.epsilon)
        elif rule == 'adamax':
            scal.update(beta1=opt.beta1, beta2=opt.beta2)
        elif rule in ('sgd_mom', 'nag_mom'):
            scal['momentum'] = opt.momentum
        elif rule == 'signum':
            scal.update(momentum=opt.momentum, beta1=opt.momentum)
        elif rule in ('dcasgd', 'dcasgd_mom'):
            scal.update(momentum=opt.momentum, k0=opt.lamda)
        elif rule == 'adagrad':
            scal['epsilon'] = opt.float_stable_eps
        elif rule in ('rmsprop', 'rmspropalex'):
            cw = opt.clip_weights
            on = bool(cw) and cw > 0
            scal.update(beta1=opt.gamma1, beta2=opt.gamma2,
                        epsilon=opt.epsilon, k0=cw if on else 0.0, k_on=on)
        elif rule == 'adadelta':
            scal.update(beta1=opt.rho, epsilon=opt.epsilon)
        elif rule == 'ftrl':
            scal.update(k0=opt.lamda1, k1=opt.beta)
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
        a, wd, b, scal = self._hypers()
        for poses, plan in plans:
            plan.launch([self._params[k][1].grad for k in poses],
                        [a[k] for k in poses], [wd[k] for k in poses],
                        [b[k] for k in poses], **scal)

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
        ((width, len(COLUMNS)) int32 on the card)."""
        at = 0
        for poses, b in bindings:
            b.launch([self._params[k][1].grad for k in poses],
                     cols[at:at + b.size], **scal)
            at += b.size

    @staticmethod
    def columns(bindings, a, wd, b):
        """One step's (width, len(COLUMNS)) int32 columns for its resolved
        ``a``, ``wd`` and ``b`` (``_hypers``)."""
        return np.concatenate(
            [bl.columns([a[k] for k in poses], [wd[k] for k in poses],
                        [b[k] for k in poses])
             for poses, bl in bindings]) if bindings \
            else np.zeros((0, len(multi_tensor.COLUMNS)), np.int32)
