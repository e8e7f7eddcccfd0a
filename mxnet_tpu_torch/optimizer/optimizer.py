"""Optimizer base, SGD, Adam and AdamW, the counterpart of
``mxnet_tpu/optimizer/optimizer.py``.

Ported: the ``Optimizer`` bookkeeping (optimizer.py:78-257) -- per-index
update counts, lr / wd multiplier tables, ``rescale_grad``,
``clip_gradient``, the registry -- plus ``SGD`` (:259-305; PyTorch
gradients are dense, so its row-sparse ``lazy_update`` has no
counterpart), ``_AdamFamily`` (:423-437) and ``AdamW`` (:464-483), and
the low-precision protocol (:93-150, 278-300): ``multi_precision``,
``create_state_multi_precision`` (a float32 master for a float16 or
bfloat16 weight when ``multi_precision``, else a warning and state in the
weight's dtype) and ``update_multi_precision`` (SGD: ``mp_sgd_update`` /
``mp_sgd_mom_update`` on the master; AdamW: ``update`` on the master
with the widened gradient, as the reference does, which is
``mp_adamw_update``). Without ``multi_precision`` a bf16 weight keeps
bf16 state and the ops round as the reference's traced update does
(``ops/optimizer_ops.py``). ``Adam`` (:440-461) is the plain update the
CPU runs; the whole-model update kernel has no rule for it, so a card
refuses it (``FusedUpdateError``). ``lr_scheduler`` (read at the
optimizer's ``num_update``) and ``param_dict`` (index -> gluon
``Parameter``, whose ``lr_mult`` / ``wd_mult`` win over the tables, as
the gluon Trainer passes it) are the reference's; so are ``Updater`` and
``get_updater``, whose pickled states ``Trainer.save_states`` writes.
There is no symbolic API in the port, so no symbol attributes.

Weight decay reaches every parameter, under SGD as under AdamW:
``set_wd_mult`` gives names not ending in ``_weight`` a multiplier of 0,
but it runs in ``__init__``, when ``idx2name`` is still empty, and the
trainer fills ``idx2name`` later without rebuilding the table
(train_step.py:511-512). The port copies that behaviour of the JAX
package: BatchNorm gamma / beta and conv biases decay too.
"""
from __future__ import annotations

import pickle
import warnings

import torch

from ..ops.optimizer_ops import (adamw_update, mp_sgd_mom_update,
                                 mp_sgd_update, sgd_mom_update, sgd_update)

__all__ = ['Optimizer', 'SGD', 'Adam', 'AdamW', 'register', 'create',
           'opt_registry', 'Updater', 'get_updater']

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

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

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
    optimizer_ops.py:125-136). Plain torch: no kernel covers it."""

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
