"""The gluon ``Trainer``, the counterpart of ``mxnet_tpu/gluon/trainer.py``.

``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` and
updates every parameter whose gradient a backward wrote since the last
step, through the port's whole-model update, :class:`FusedUpdate`
(``optimizer/fused.py``): one multi-tensor kernel launch per parameter
form on a card, the per-parameter ``update_multi_precision`` loop on the
CPU. It stands where the JAX Trainer's ``_try_fused_update``
(trainer.py:329-355) stands: every optimizer whose ``fusable`` is True
takes one kernel launch per parameter form on a card, and the three that
the reference keeps out of its fused update (``SGLD``, ``Nadam``,
``LBSGD``: ``fusable`` False, trainer.py:335) run their per-parameter
loop there, as in the reference. The JAX package's fallback from a
failed trace to that loop is not copied: on a card a fusable optimizer
the kernel has no rule for (a subclass of one with a rule) raises
``FusedUpdateError``.

A parameter with ``grad_req`` other than ``'null'`` whose gradient is
stale (no backward wrote it since the last step) raises the reference's
``UserWarning``, unless ``ignore_stale_grad`` skips it. The port trains
on one device: ``kvstore`` names ('device', 'local', ...) and
``update_on_kvstore`` are accepted, and the gradient all-reduce is the
identity. ``amp='bf16'`` (or the ``MXNET_TPU_AMP`` knob) turns the
optimizer's ``multi_precision`` on, for a net after ``cast('bfloat16')``.
The numerical guardrail is not ported (ROADMAP A11):
:meth:`attach_guardrail` raises.
"""
from __future__ import annotations

import warnings

from .. import amp as _amp
from ..optimizer import fused as _fused
from ..optimizer import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ['Trainer']


class Trainer:
    """Applies an Optimizer on a set of Parameters."""

    @staticmethod
    def _flatten_params(params):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[k] for k in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                'First argument must be a list or dict of Parameters, '
                'got %s.' % (type(params)))
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError(
                    'First argument must be a list or dict of Parameters, '
                    'got list of %s.' % (type(p)))
        return list(params)

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore='device', compression_params=None,
                 update_on_kvstore=None, amp=None):
        self._params = self._flatten_params(params)
        if compression_params:
            raise NotImplementedError('Trainer: gradient compression is not '
                                      'ported (one device, no all-reduce)')
        if kvstore is not None and not isinstance(kvstore, str):
            raise NotImplementedError('Trainer: a kvstore object is not '
                                      'ported; the port trains on one '
                                      'device')
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get('rescale_grad', 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._amp_policy = _amp.resolve(amp)
        if self._amp_policy is not None:
            self._optimizer.multi_precision = True
            if self._amp_policy.loss_scaling:
                warnings.warn(
                    "amp='%s' on the eager path applies no loss scaling "
                    '(the guardrail is not ported); use bf16'
                    % self._amp_policy.name, stacklevel=2)
        self._fused = None          # (indices, FusedUpdate) once built
        self._watchdog = None
        self._preempt = None
        self._step_count = 0
        self._check_rule()

    def _index_table(self):
        return dict(enumerate(self._params))

    def _init_optimizer(self, optimizer, optimizer_params):
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise AssertionError(
                    'optimizer_params must be None if optimizer is an '
                    'Optimizer instance')
            self._optimizer = optimizer
            self._optimizer.param_dict = self._index_table()
        else:
            self._optimizer = opt.create(
                optimizer, param_dict=self._index_table(),
                **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    def _check_rule(self):
        """On a card the whole-model update needs a rule for a fusable
        optimizer: refuse early when the parameters already live there."""
        devices = {p._tensor.device.type for p in self._params
                   if p._tensor is not None}
        if 'cuda' in devices and self._optimizer.fusable and \
                _fused.rule_of(self._optimizer) is None:
            raise _fused.FusedUpdateError(
                'the whole-model update has no kernel for %s on a CUDA '
                'device: it covers the fusable optimizers of the port, '
                'exactly those classes'
                % type(self._optimizer).__name__)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def amp(self):
        return self._amp_policy.name if self._amp_policy is not None \
            else 'off'

    def set_learning_rate(self, lr):
        """Set a new learning rate."""
        self._optimizer.set_learning_rate(lr)

    def attach_guardrail(self, guard):
        raise NotImplementedError('Trainer.attach_guardrail: the numerical '
                                  'guardrail is not ported (ROADMAP A11)')

    def attach_watchdog(self, watchdog):
        """Heartbeat a :class:`~mxnet_tpu_torch.resilience.Watchdog`
        before each update and check it after."""
        self._watchdog = watchdog
        return self

    def attach_preemption(self, handler):
        """Poll a :class:`~mxnet_tpu_torch.resilience.PreemptionHandler`
        at each step's entry (a pending stop exits resumably)."""
        self._preempt = handler
        return self

    def step(self, batch_size, ignore_stale_grad=False):
        """One update: rescale by ``1 / batch_size``, all-reduce (the
        identity on one device), apply the optimizer."""
        if self._preempt is not None and \
                self._preempt.check(self._step_count):
            self._preempt.exit(step=self._step_count)
        if self._watchdog is not None:
            self._watchdog.beat(self._step_count, phase='step')
        self._step_count += 1
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)
        if self._watchdog is not None:
            self._watchdog.check()

    def allreduce_grads(self):
        """Reduce the gradients over devices: the identity on one."""

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply the optimizer only (gradients already reduced)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        updatable = []
        for i, param in enumerate(self._params):
            if param.grad_req == 'null':
                continue
            fresh = param.data()._grad_fresh
            if not ignore_stale_grad and not fresh:
                raise UserWarning(
                    'Gradient of Parameter `%s` on context %s has not been '
                    'updated by backward since last `step`. This could mean '
                    'a bug in your model that made it only use a subset of '
                    'the Parameters (Blocks) for this iteration. If you are '
                    'intentionally only using a subset, call step with '
                    'ignore_stale_grad=True to suppress this warning and '
                    'skip updating of Parameters with stale gradient' % (
                        param.name, str(param.data().context)))
            if fresh:
                updatable.append((i, param))
        if not updatable:
            return
        self._fused_for(updatable)()
        for _, p in updatable:
            p._data._grad_fresh = False

    def _fused_for(self, updatable):
        """The :class:`FusedUpdate` of these parameters (built again when
        the set changes); their states are the updater's."""
        key = tuple(i for i, _ in updatable)
        if self._fused is None or self._fused[0] != key:
            updater = self._updaters[0]
            pairs = [(i, p._tensor) for i, p in updatable]
            states = [updater.state_for(i, t.detach()) for i, t in pairs]
            self._fused = (key, _fused.FusedUpdate(
                self._optimizer, pairs, states, pairs[0][1].device))
        return self._fused[1]

    def get_states_bytes(self):
        """The pickled optimizer states and optimizer (the
        ``save_states`` payload)."""
        return self._updaters[0].get_states(dump_optimizer=True)

    def save_states(self, fname):
        """Save the trainer's states atomically."""
        from ..resilience.checkpoint import atomic_write_bytes
        atomic_write_bytes(fname, self.get_states_bytes())

    def set_states_bytes(self, payload):
        """Inverse of :meth:`get_states_bytes`."""
        updater = self._updaters[0]
        updater.set_states(payload)
        self._optimizer = updater.optimizer
        self._optimizer.param_dict = self._index_table()
        for i, p in enumerate(self._params):
            st = updater.states.get(i)
            if st is not None and p._tensor is not None:
                updater.states[i] = _to(st, p._tensor.device)
        self._fused = None

    def load_states(self, fname):
        """Load the trainer's states."""
        with open(fname, 'rb') as f:
            self.set_states_bytes(f.read())


def _to(state, device):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_to(s, device) for s in state)
    return state.to(device)
