"""The optimizer zoo, the counterpart of ``mxnet_tpu/optimizer/optimizer.py``.

Ported: the ``Optimizer`` bookkeeping (optimizer.py:78-257) -- per-index
update counts, lr / wd multiplier tables, ``rescale_grad``,
``clip_gradient``, the registry -- and every optimizer of the reference,
under its registered name, with its defaults, ``create_state`` and
``update``: ``SGD`` (:259-305; PyTorch gradients are dense, so its
row-sparse ``lazy_update`` has no counterpart), ``Signum``, ``FTML``,
``DCASGD``, ``NAG``, ``SGLD``, ``ccSGD`` (:309-419), ``Adam``, ``AdamW``
(:423-483), ``AdaGrad``, ``RMSProp``, ``AdaDelta``, ``Ftrl``, ``Adamax``,
``Nadam``, ``LBSGD`` and ``Test`` (:487-698). Each update goes through the
port's ops of the reference's names (``ops/optimizer_ops.py``) or, where
the JAX body is plain array arithmetic (``DCASGD``, ``NAG``, ``SGLD``,
``AdaDelta``, ``Adamax``, ``Nadam``, ``Test``, and the port's ``Adam``),
through the same expressions on tensors, in the JAX body's order. So is
the low-precision protocol (:93-150, 278-300): ``multi_precision``,
``create_state_multi_precision`` (a float32 master for a float16 or
bfloat16 weight when ``multi_precision``, else a warning and state in the
weight's dtype) and ``update_multi_precision`` (SGD: ``mp_sgd_update`` /
``mp_sgd_mom_update`` on the master; every other optimizer: ``update`` on
the master with the widened gradient, as the reference does). Without
``multi_precision`` a bf16 weight keeps bf16 state and SGD's and AdamW's
ops round as the reference's traced update does (``ops/optimizer_ops.py``).

``fusable`` is the reference's flag: the whole-model update
(``optimizer/fused.py``) has a kernel rule for every optimizer whose
``fusable`` is True; ``SGLD`` (its noise), ``Nadam`` (its host-side
``m_schedule``) and ``LBSGD`` (its norms read back) are False and run
their per-parameter loop, as the JAX ``Trainer`` runs them. ``SGLD``
draws its noise from the port's generator of the weight's device
(``random.py``): torch's bits, not threefry's, with the same law.

``lr_scheduler`` (read at the optimizer's ``num_update``) and
``param_dict`` (index -> gluon ``Parameter``, whose ``lr_mult`` /
``wd_mult`` win over the tables, as the gluon Trainer passes it) are the
reference's; so are ``Updater`` and ``get_updater``, whose pickled states
``Trainer.save_states`` writes. There is no symbolic API in the port, so
no symbol attributes.

Weight decay reaches every parameter, under SGD as under AdamW:
``set_wd_mult`` gives names not ending in ``_weight`` a multiplier of 0,
but it runs in ``__init__``, when ``idx2name`` is still empty, and the
trainer fills ``idx2name`` later without rebuilding the table
(train_step.py:511-512). The port copies that behaviour of the JAX
package: BatchNorm gamma / beta and conv biases decay too.
"""
from __future__ import annotations

import math
import pickle
import warnings

import torch

from .. import random as _random
from ..ops.optimizer_ops import (adagrad_update, adamw_update, ftml_update,
                                 ftrl_update, mp_sgd_mom_update,
                                 mp_sgd_update, rmsprop_update,
                                 rmspropalex_update, sgd_mom_update,
                                 sgd_update, signsgd_update, signum_update)

__all__ = ['Optimizer', 'SGD', 'Signum', 'FTML', 'DCASGD', 'NAG', 'SGLD',
           'Adam', 'AdaGrad', 'RMSProp', 'AdaDelta', 'Ftrl', 'Adamax',
           'Nadam', 'LBSGD', 'AdamW', 'Test', 'Updater', 'register',
           'create', 'get_updater', 'opt_registry', 'ccSGD']

opt_registry = {}


def register(klass):
    """Register an Optimizer subclass under its lowercase class name."""
    opt_registry[klass.__name__.lower()] = klass
    return klass


def _is_low_precision(dtype):
    """float16 and bfloat16: both need a float32 accumulator
    (``_is_low_precision``, optimizer.py:64-76)."""
    return dtype in (torch.float16, torch.bfloat16)


def _dtype_name(dtype):
    return str(dtype).replace('torch.', '')


def create(name, **kwargs):
    """Instantiate an optimizer by registered name (or pass one
    through)."""
    if isinstance(name, Optimizer):
        return name
    if isinstance(name, str) and name.lower() in opt_registry:
        return opt_registry[name.lower()](**kwargs)
    raise ValueError('Cannot find optimizer %s (the port has %s)'
                     % (name, ', '.join(sorted(opt_registry))))


class Optimizer:
    """Base optimizer: update counts, lr/wd multiplier tables,
    rescale/clip."""

    # the whole-model update has a kernel rule for this optimizer (see the
    # module docstring); False: it runs its per-parameter loop
    fusable = True

    def __init__(self, rescale_grad=1., param_idx2name=None, wd=0.,
                 clip_gradient=None, learning_rate=0.01,
                 multi_precision=False, lr_scheduler=None, param_dict=None,
                 begin_num_update=0):
        self.rescale_grad, self.clip_gradient = rescale_grad, clip_gradient
        self.lr, self.wd = learning_rate, wd
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.param_dict = dict(param_dict or {})
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self._index_update_count = {}
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise TypeError(
                'param_idx2name should be a dict of param indexes to names.')
        self.idx2name = dict(param_idx2name)
        self.set_lr_mult({})
        self.set_wd_mult({})

    @property
    def learning_rate(self):
        """The lr of the next update: the scheduler's at ``num_update``, or
        the base lr."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def __getstate__(self):
        # the gluon Parameters stay out of a pickled optimizer (the
        # Trainer's save_states): the trainer sets them again on load
        state = dict(self.__dict__)
        state['param_dict'] = {}
        return state

    def set_learning_rate(self, lr):
        """The base learning rate from the next update on; refused under a
        scheduler, as ``optimizer.py:178-185`` does."""
        if self.lr_scheduler is not None:
            raise UserWarning('LRScheduler of the optimizer has already '
                              'been defined. Note that set_learning_rate '
                              'can mutate the value of the learning rate '
                              'of the optimizer only when the LRScheduler '
                              'of the optimizer is undefined.')
        self.lr = lr

    def create_state(self, index, weight):
        """Optimizer state for one weight; None if stateless."""
        return None

    def create_state_multi_precision(self, index, weight):
        """State for one weight under the low-precision protocol: for a
        float16 / bfloat16 weight with ``multi_precision``, ``(master,
        state)`` with a float32 master copy; without it, a warning and
        :meth:`create_state` in the weight's dtype."""
        if _is_low_precision(weight.dtype):
            if self.multi_precision:
                master = weight.detach().to(torch.float32)
                return (master, self.create_state(index, master))
            warnings.warn('Accumulating with %s in optimizer can lead '
                          'to poor accuracy or slow convergence. '
                          'Consider using multi_precision=True option '
                          'of the optimizer' % _dtype_name(weight.dtype))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`, or for a low-precision weight under
        ``multi_precision`` the update of its float32 master (state
        ``(master, state)``) with the widened gradient, the weight then
        the master rounded."""
        if self.multi_precision and _is_low_precision(weight.dtype):
            master, master_state = state
            self.update(index, master, grad.to(torch.float32), master_state)
            weight.copy_(master)
        else:
            self.update(index, weight, grad, state)

    def _begin(self, index):
        """Bump the update count and resolve (lr, wd) for one step."""
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index)

    def _step_of(self, index):
        return self._index_update_count[index]

    def _clipped(self, grad):
        """``rescale_grad * grad``, clipped to [-clip, clip] whenever
        ``clip_gradient`` is set (``_clipped``, optimizer.py:152-157)."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def _base_kwargs(self, lr, wd):
        return {'lr': lr, 'wd': wd, 'rescale_grad': self.rescale_grad,
                'clip_gradient': self.clip_gradient}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # non-weight params (bias/gamma/beta...) default to wd 0 -- of the
        # names known now (see the module docstring)
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith('_weight')}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        indices = index if isinstance(index, (list, tuple)) else [index]
        for idx in indices:
            bumped = self._index_update_count.get(idx, 0) + 1
            self._index_update_count[idx] = bumped
            self.num_update = max(bumped, self.num_update)

    def _mult_of(self, index, table):
        """Per-param multiplier: the gluon Parameter's (``param_dict``)
        beats an explicit index, which beats the name lookup."""
        if index in self.param_dict:
            attr = 'lr_mult' if table is self.lr_mult else 'wd_mult'
            return getattr(self.param_dict[index], attr)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        base = self.lr if self.lr_scheduler is None \
            else self.lr_scheduler(self.num_update)
        return base * self._mult_of(index, self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult_of(index, self.wd_mult)


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay: ``mom = momentum * mom - lr *
    (clip(g) + wd * w)``, ``w += mom``; without momentum (the default)
    ``w -= lr * (clip(g) + wd * w)`` and no state."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        # kept for the reference's signature: the port's gradients are
        # dense, which the reference updates in full whatever the flag
        self.momentum, self.lazy_update = momentum, lazy_update

    def create_state(self, index, weight):
        return torch.zeros_like(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, multi_precision=False)

    def update_multi_precision(self, index, weight, grad, state):
        use_mp = self.multi_precision and _is_low_precision(weight.dtype)
        self._update_impl(index, weight, grad, state, multi_precision=use_mp)

    def _update_impl(self, index, weight, grad, state, multi_precision=False):
        lr, wd = self._begin(index)
        kwargs = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=self.clip_gradient)
        if multi_precision:
            master, mom = state
            if mom is not None:
                mp_sgd_mom_update(weight, grad, mom, master,
                                  momentum=self.momentum, **kwargs)
            else:
                mp_sgd_update(weight, grad, master, **kwargs)
        elif state is not None:
            sgd_mom_update(weight, grad, state, momentum=self.momentum,
                           **kwargs)
        else:
            sgd_update(weight, grad, **kwargs)


@register
class Signum(Optimizer):
    """SignSGD (``momentum`` 0: ``w -= lr (sign(g) + wd w)``) and Signum
    (``mom = momentum mom - (1 - momentum) g``, ``w = (1 - lr wd_lh) w +
    lr sign(mom)``), through ``signsgd_update`` / ``signum_update``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        return torch.zeros_like(weight) if self.momentum != 0.0 else None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        kwargs = self._base_kwargs(lr, wd)
        if state is None:
            weight.copy_(signsgd_update(weight, grad, **kwargs))
        else:
            w, mom = signum_update(weight, grad, state,
                                   momentum=self.momentum,
                                   wd_lh=self.wd_lh, **kwargs)
            state.copy_(mom)
            weight.copy_(w)


@register
class FTML(Optimizer):
    """FTML (``ftml_update``): state (d, v, z), ``t`` the parameter's
    update count."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(torch.zeros_like(weight) for _ in 'dvz')

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        d, v, z = state
        outs = ftml_update(weight, grad, d, v, z, lr=lr, wd=wd,
                           rescale_grad=self.rescale_grad,
                           clip_grad=self.clip_gradient, beta1=self.beta1,
                           beta2=self.beta2, epsilon=self.epsilon,
                           t=self._step_of(index))
        for dst, src in zip((weight, d, v, z), outs):
            dst.copy_(src)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD: ``delta = -lr (g + wd w + lamda g^2
    (w - prev))``, through a momentum when ``momentum`` != 0; state
    (momentum or None, the previous weight)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda
        self.weight_previous = {}

    def create_state(self, index, weight):
        mom = torch.zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.detach().clone())

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        g = self._clipped(grad)
        mom, prev = state
        delta = -lr * (g + wd * weight +
                       self.lamda * g * g * (weight - prev))
        if mom is not None:
            mom.copy_(self.momentum * mom + delta)
            delta = mom
        prev.copy_(weight)
        weight.copy_(weight + delta)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD: ``mom = momentum mom + g + wd w``, ``w -=
    lr (momentum mom + g)``; without momentum ``w -= lr (g + wd w)``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return torch.zeros_like(weight) if self.momentum != 0.0 else None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        g = self._clipped(grad)
        if state is None:
            weight.copy_(weight - lr * (g + wd * weight))
        else:
            state.copy_(self.momentum * state + g + wd * weight)
            # the lookahead step: the gradient past the momentum move
            g = self.momentum * state + g
            weight.copy_(weight - lr * g)


def _sgld_noise(weight, lr):
    """SGLD's noise: N(0, lr) in the weight's dtype, from the generator
    of its device (``random.generator``)."""
    return torch.normal(0.0, math.sqrt(lr), tuple(weight.shape),
                        generator=_random.generator(weight.device),
                        dtype=weight.dtype, device=weight.device)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics: ``w -= lr / 2 (g + wd w)``
    plus N(0, lr) noise."""

    fusable = False  # lr ** 0.5 scales a sampler

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        g = self._clipped(grad)
        noise = _sgld_noise(weight, lr)
        weight.copy_(weight - lr / 2 * (g + wd * weight) + noise)


@register  # pylint: disable=invalid-name
class ccSGD(SGD):
    """The reference's deprecated alias of SGD."""


class _AdamFamily(Optimizer):
    """Shared (mean, var) state + bias-correction arithmetic."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        """Zero (mean, var) in the weight's dtype (``_fresh``,
        optimizer.py:63-65, 431-432)."""
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _bias_corrected(self, lr, t):
        """lr * sqrt(1 - beta2^t) / (1 - beta1^t)."""
        return lr * (1. - self.beta2 ** t) ** 0.5 / (1. - self.beta1 ** t)


@register
class Adam(_AdamFamily):
    """Adam: ``g = clip(rescale * grad + wd * w)``, ``m = beta1 m + (1 -
    beta1) g``, ``v = beta2 v + (1 - beta2) g^2``, ``w -= eta * m /
    (sqrt(v) + eps)`` with ``eta`` the bias-corrected lr (``adam_update``,
    optimizer_ops.py:125-136), written out on tensors."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon, **kwargs)
        self.lazy_update = lazy_update

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        lr = self._bias_corrected(lr, self._step_of(index))
        mean, var = state
        g = grad * self.rescale_grad
        if wd != 0.0:
            g = g + wd * weight
        if self.clip_gradient is not None and self.clip_gradient > 0:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        mean.copy_(self.beta1 * mean + (1 - self.beta1) * g)
        var.copy_(self.beta2 * var + (1 - self.beta2) * torch.square(g))
        weight.copy_(weight - lr * mean / (torch.sqrt(var) + self.epsilon))


@register
class AdamW(_AdamFamily):
    """AdamW with decoupled weight decay scaled by the bias-corrected
    step: ``w -= eta * (m / (sqrt(v) + eps) + wd * w)`` with
    ``eta = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` and ``t`` counted
    per parameter from 1."""

    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        eta = self._bias_corrected(lr, self._step_of(index))
        mean, var = state
        adamw_update(weight, grad, mean, var, self.rescale_grad, lr=1.0,
                     eta=eta, wd=wd, clip_gradient=self.clip_gradient,
                     beta1=self.beta1, beta2=self.beta2,
                     epsilon=self.epsilon)


@register
class AdaGrad(Optimizer):
    """AdaGrad (``_sparse_adagrad_update``): ``h += g^2``, ``w -= lr (g /
    sqrt(h + eps) + wd w)``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        w, h = adagrad_update(weight, grad, state, lr=lr, wd=wd,
                              rescale_grad=self.rescale_grad,
                              clip_gradient=self.clip_gradient,
                              epsilon=self.float_stable_eps)
        state.copy_(h)
        weight.copy_(w)


@register
class RMSProp(Optimizer):
    """RMSProp, plain (Tieleman, ``rmsprop_update``) or ``centered``
    (Graves, ``rmspropalex_update``: state (n, g, delta))."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon, self.centered = epsilon, centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if not self.centered:
            return torch.zeros_like(weight)
        return tuple(torch.zeros_like(weight) for _ in 'ngd')

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        kwargs = {'gamma1': self.gamma1, 'epsilon': self.epsilon,
                  **self._base_kwargs(lr, wd)}
        if self.clip_weights:
            kwargs['clip_weights'] = self.clip_weights
        if self.centered:
            n, g, delta = state
            outs = rmspropalex_update(weight, grad, n, g, delta,
                                      gamma2=self.gamma2, **kwargs)
            for dst, src in zip((weight, n, g, delta), outs):
                dst.copy_(src)
        else:
            w, n = rmsprop_update(weight, grad, state, **kwargs)
            state.copy_(n)
            weight.copy_(w)


@register
class AdaDelta(Optimizer):
    """AdaDelta: state (E[g^2], E[dx^2]); the lr is not read."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _, wd = self._begin(index)
        g = self._clipped(grad)
        acc_g, acc_delta = state
        acc_g.copy_(self.rho * acc_g + (1. - self.rho) * g * g)
        step = (torch.sqrt(acc_delta + self.epsilon)
                / torch.sqrt(acc_g + self.epsilon)) * g
        acc_delta.copy_(self.rho * acc_delta
                        + (1. - self.rho) * step * step)
        weight.copy_(weight - step - wd * weight)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (``ftrl_update``): state (z, n)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        z, n = state
        outs = ftrl_update(weight, grad, z, n, lamda1=self.lamda1,
                           beta=self.beta, **self._base_kwargs(lr, wd))
        for dst, src in zip((weight, z, n), outs):
            dst.copy_(src)


@register
class Adamax(Optimizer):
    """AdaMax, Adam with an infinity-norm second moment: ``g = clip(rescale
    grad + wd w)``, ``m = beta1 m + (1 - beta1) g``, ``u = max(beta2 u,
    |g|)``, ``w -= lr / (1 - beta1^t) m / u``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        lr /= 1. - self.beta1 ** self._step_of(index)
        # the reference's order: rescale, add wd, then clip
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        m, u = state
        m.copy_(self.beta1 * m + (1. - self.beta1) * g)
        u.copy_(torch.maximum(self.beta2 * u, torch.abs(g)))
        weight.copy_(weight - lr * m / u)


@register
class Nadam(Optimizer):
    """Nesterov Adam, with the reference's host-side ``m_schedule``."""

    fusable = False  # mutates self.m_schedule per update

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _momentum_at(self, t):
        return self.beta1 * (1. - 0.5 * 0.96 ** (t * self.schedule_decay))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._begin(index)
        t = self._step_of(index)
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        mu_t, mu_next = self._momentum_at(t), self._momentum_at(t + 1)
        self.m_schedule *= mu_t
        schedule_next = self.m_schedule * mu_next
        m, v = state
        m.copy_(self.beta1 * m + (1. - self.beta1) * g)
        v.copy_(self.beta2 * v + (1. - self.beta2) * g * g)
        g_hat = g / (1. - self.m_schedule)
        m_hat = m / (1. - schedule_next)
        v_hat = v / (1. - self.beta2 ** t)
        m_bar = (1. - mu_t) * g_hat + mu_next * m_hat
        weight.copy_(weight - lr * m_bar / (torch.sqrt(v_hat)
                                            + self.epsilon))


@register
class LBSGD(SGD):
    """Large-batch SGD with LARS's layer-wise lr: SGD's update at ``lr
    eta ||w|| / (||g|| + wd ||w|| + 1e-9)`` (``eta`` 0.001), the norms
    read back on the host; the warm-up arguments are the reference's and
    unused, as there."""

    fusable = False  # the LARS norms are read back on the host

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy='linear', warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(momentum=momentum, multi_precision=multi_precision,
                         **kwargs)
        self.eta = 0.001  # LARS trust coefficient

    def _update_impl(self, index, weight, grad, state, multi_precision=False):
        lr, wd = self._begin(index)
        wnorm = float(torch.linalg.vector_norm(weight))
        gnorm = float(torch.linalg.vector_norm(grad * self.rescale_grad))
        if wnorm > 0 and gnorm > 0:
            lr *= self.eta * wnorm / (gnorm + wd * wnorm + 1e-9)
        kwargs = self._base_kwargs(lr, wd)
        if multi_precision:
            master, mom = state
            if mom is not None:
                mp_sgd_mom_update(weight, grad, mom, master,
                                  momentum=self.momentum, **kwargs)
            else:
                mp_sgd_update(weight, grad, master, **kwargs)
        elif state is not None:
            sgd_mom_update(weight, grad, state, momentum=self.momentum,
                           **kwargs)
        else:
            sgd_update(weight, grad, **kwargs)


@register
class Test(Optimizer):
    """The reference's test optimizer: ``w += rescale g``, its state the
    new weight; no update count."""

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.copy_(weight + grad * self.rescale_grad)
        state.copy_(weight)


class Updater:
    """Per-index optimizer state, made on first use, applied as (index,
    grad, weight) triples arrive (``Updater``, optimizer.py:701-752);
    ``get_states`` / ``set_states`` pickle the states (and the
    optimizer)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def state_for(self, idx, weight):
        if idx not in self.states:
            self.states[idx] = \
                self.optimizer.create_state_multi_precision(idx, weight)
        return self.states[idx]

    def __call__(self, index, grad, weight):
        triples = zip(index, grad, weight) if isinstance(
            index, (list, tuple)) else [(index, grad, weight)]
        for idx, g, w in triples:
            self.optimizer.update_multi_precision(idx, w, g,
                                                  self.state_for(idx, w))

    def set_states(self, states):
        payload = pickle.loads(states)
        if isinstance(payload, tuple) and len(payload) == 2:
            self.states, self.optimizer = payload
        else:
            self.states = payload

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)


def get_updater(optimizer):
    """Wrap an optimizer as an :class:`Updater`."""
    return Updater(optimizer)
