"""Imperative autograd over torch's, the counterpart of
``mxnet_tpu/autograd.py``.

The JAX package records each op's ``jax.vjp`` pullback on a tape of its
own. The port lets torch record: inside :func:`record` the ops of the
imperative surface (``mx.nd.*``, ``NDArray`` arithmetic, a block called
on ``NDArray``s) run with torch's grad mode on, and outside it under
``torch.no_grad()``, so that only what ``record()`` saw builds a graph,
even for arrays with gradients attached.

:func:`backward` computes the gradients of the heads with
``torch.autograd.grad`` over the recorded leaves it reaches (the arrays
that :meth:`NDArray.attach_grad`, :func:`mark_variables` or a gluon
``Parameter`` marked), then writes each into the leaf's gradient buffer
(``grad_req='write'``) or adds it there (``'add'``), and sets the leaf's
``_grad_fresh`` mark for the gluon Trainer's stale-gradient check. A head
that is not a scalar seeds ones. torch's own ``.grad`` accumulation is
not used.

``is_training()`` decides training for the gluon layers (Dropout,
BatchNorm, the RNN layers): ``record()`` turns it on, ``record(
train_mode=False)``, ``pause()`` and ``predict_mode()`` off;
``ParallelTrainer`` enters ``train_mode()`` around its forward.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ['record', 'pause', 'train_mode', 'predict_mode', 'is_recording',
           'is_training', 'backward', 'grad', 'Function', 'mark_variables',
           'set_recording', 'set_training', 'get_symbol']

_state = threading.local()


def _st():
    if not hasattr(_state, 'recording'):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    prev = _st().recording
    _state.recording = bool(is_record)
    return prev


def set_training(train_mode):
    prev = _st().training
    _state.training = bool(train_mode)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, ptype, value, trace):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    """Scope in which executed ops are recorded for :func:`backward`."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def grad_enabled():
    """torch's grad mode for an op of the imperative surface: on inside
    :func:`record`, off outside it."""
    return torch.set_grad_enabled(is_recording())


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def _mark(var, gradient, req):
    """Make ``var`` (an NDArray) a recorded leaf with gradient buffer
    ``gradient`` (an NDArray; None for 'null')."""
    t = var._data
    if t.grad_fn is not None:
        t = var._data = t.detach()
    if req == 'null':
        var._grad, var._grad_req = None, 'null'
        if t.requires_grad:
            t.requires_grad_(False)
        return
    if not (t.is_floating_point() or t.is_complex()):
        raise TypeError('mark_variables: a gradient needs a floating-point '
                        'array, got %s' % t.dtype)
    t.requires_grad_(True)
    t._mx_var = weakref.ref(var)
    var._grad, var._grad_req = gradient, req
    var._grad_fresh = False


def mark_variables(variables, gradients, grad_reqs='write'):
    """Associate gradient buffers with variables."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, gradient, req in zip(variables, gradients, grad_reqs):
        _mark(var, gradient, req)


def _leaves(roots):
    """The leaf tensors that need a gradient, reachable from the graph
    roots (``grad_fn``s), in the order first reached."""
    seen, out, stack = set(), [], list(roots)
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, 'variable', None)
        if var is not None:
            out.append(var)
            continue
        for nxt, _ in fn.next_functions:
            if nxt is not None and nxt not in seen:
                stack.append(nxt)
    return out


def _heads(heads, head_grads):
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue
        outs.append(t)
        seeds.append(torch.ones_like(t) if hg is None else
                     (hg._data if isinstance(hg, NDArray) else
                      torch.as_tensor(hg, device=t.device)).to(t.dtype))
    return outs, seeds


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             create_graph=False):
    """Compute the gradients of ``heads`` with respect to the marked
    variables they depend on, into the variables' gradient buffers."""
    outs, seeds = _heads(heads, head_grads)
    if not outs:
        return
    reached = [o for o in outs if o.grad_fn is None] + \
        _leaves([o.grad_fn for o in outs])
    leaves = [t for t in reached
              if getattr(t, '_mx_var', None) is not None
              and t._mx_var() is not None and t._mx_var()._grad is not None]
    if not leaves:
        return
    grads = torch.autograd.grad(outs, leaves, seeds,
                                retain_graph=retain_graph or create_graph,
                                create_graph=create_graph,
                                allow_unused=True)
    for t, g in zip(leaves, grads):
        var = t._mx_var()
        if g is None:
            continue
        buf = var._grad
        with torch.no_grad():
            g = g.to(buf._data.dtype)
            if var._grad_req == 'add':
                buf._data.add_(g)
            else:
                buf._data.copy_(g)
        var._grad_fresh = True


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, as new
    arrays; the variables' gradient buffers are left alone. With
    ``create_graph`` the results are recorded, so they can be
    differentiated again."""
    from .ndarray import NDArray
    if create_graph:
        retain_graph = True
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    outs, seeds = _heads(heads, head_grads)
    tensors = [v._data for v in variables]
    with torch.set_grad_enabled(create_graph or torch.is_grad_enabled()):
        grads = torch.autograd.grad(outs, tensors, seeds,
                                    retain_graph=bool(retain_graph),
                                    create_graph=create_graph,
                                    allow_unused=True)
    results = [NDArray(torch.zeros_like(t) if g is None else g)
               for t, g in zip(tensors, grads)]
    return results[0] if single else results


def get_symbol(x):
    raise NotImplementedError('autograd.get_symbol: the port has no '
                              'symbolic API')


class Function:
    """A differentiable function with a hand-written backward: subclass
    it and override :meth:`forward` and :meth:`backward`, both on
    ``NDArray``s. Called inside :func:`record`, it runs as one
    ``torch.autograd.Function`` whose backward calls :meth:`backward`."""

    def __init__(self):
        self._used = False
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if self._used:
            raise RuntimeError('A Function instance cannot be called twice')
        self._used = True
        func = self
        single = []

        class _Bridge(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *tensors):
                with pause():
                    outs = func.forward(*[NDArray(t) for t in tensors])
                single.append(not isinstance(outs, (list, tuple)))
                outs = [outs] if single[0] else list(outs)
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *cts):
                with pause():
                    grads = func.backward(*[NDArray(c) for c in cts])
                if not isinstance(grads, (list, tuple)):
                    grads = [grads]
                return tuple(None if g is None else g._data for g in grads)

        tensors = [i._data for i in inputs]
        with grad_enabled():
            outs = _Bridge.apply(*tensors)
        outs = [NDArray(t) for t in outs]
        return outs[0] if single[0] else outs
