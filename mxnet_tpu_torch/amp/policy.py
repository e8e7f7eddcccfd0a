"""AMP policy: which ops compute in low precision, which stay float32 --
the port's own copy of ``mxnet_tpu/amp/policy.py`` (:46-220), on tensors.

A :class:`Policy` is scoped over the ops a step calls: while active,
every op of ``ops/nn.py`` casts its floating inputs by its class, under
the reference's op names:

  * **cast-to-compute ops** (the matmul family: ``FullyConnected``,
    ``Convolution``, ``batch_dot``, ``_contrib_flash_attention``, ...)
    cast float32 inputs DOWN to the compute dtype, weights included, so
    the parameter entering the op is a low-precision copy of the float32
    master and the op's backward runs in low precision; the cast's own
    backward widens the gradient to float32 at the parameter;
  * **keep-fp32 ops** (the softmax family, losses, reductions) cast
    low-precision inputs UP to float32;
  * everything else passes its dtype through (LayerNorm keeps float32
    statistics and returns its input's dtype, ``ops/nn.py``).

The reference casts at trace time inside one compiled program; the port
runs eagerly, so the scope is read as each op is called. It is a
thread-local: ``scope(None)`` is a no-op, and with no policy active
:func:`cast_op_inputs` returns its inputs untouched, so a step without
AMP runs exactly the float32 path.
"""
from __future__ import annotations

import threading

import torch

from .. import config as _config

__all__ = ['Policy', 'bf16', 'fp16', 'resolve', 'scope', 'current_policy',
           'cast_op_inputs', 'CAST_COMPUTE_OPS', 'KEEP_FP32_OPS']

# the matmul family: inputs (activations AND weights) cast down to the
# compute dtype
CAST_COMPUTE_OPS = frozenset((
    'FullyConnected', 'Convolution', 'Deconvolution', 'RNN',
    'dot', 'batch_dot', 'linalg_gemm', 'linalg_gemm2',
    '_contrib_flash_attention',
))

# value-range / accumulation-sensitive ops: inputs widen to float32
KEEP_FP32_OPS = frozenset((
    'softmax', 'log_softmax', 'softmin', 'SoftmaxActivation',
    'SoftmaxOutput', 'Softmax', 'softmax_cross_entropy',
    'LinearRegressionOutput', 'LogisticRegressionOutput',
    'MAERegressionOutput', 'MakeLoss', 'CTCLoss', 'ctc_loss',
    'sum', 'mean', 'nansum', 'nanmean', 'norm', 'moments',
    'L2Normalization',
    '_contrib_fused_softmax_xent',
))

_TORCH = {'bfloat16': torch.bfloat16, 'float16': torch.float16,
          'float32': torch.float32}
_LOW = (torch.float16, torch.bfloat16)


class Policy:
    """One mixed-precision recipe: compute dtype + op classification.

    ``compute_dtype`` is a name (``'bfloat16'``, ``'float16'``);
    ``loss_scaling`` marks a recipe that needs dynamic loss scaling
    (fp16), which the reference's trainer honours by turning its
    numerical guardrail on."""

    __slots__ = ('name', 'compute_dtype', 'cast_ops', 'fp32_ops',
                 'loss_scaling')

    def __init__(self, name, compute_dtype, cast_ops=CAST_COMPUTE_OPS,
                 fp32_ops=KEEP_FP32_OPS, loss_scaling=False):
        if str(compute_dtype) not in _TORCH:
            raise ValueError('Policy %r: compute dtype %r is not one of %s'
                             % (name, compute_dtype, sorted(_TORCH)))
        self.name = name
        self.compute_dtype = str(compute_dtype)
        self.cast_ops = frozenset(cast_ops)
        self.fp32_ops = frozenset(fp32_ops)
        overlap = self.cast_ops & self.fp32_ops
        if overlap:
            raise ValueError('Policy %r classifies %s as both '
                             'cast-to-compute and keep-fp32'
                             % (name, sorted(overlap)))
        self.loss_scaling = bool(loss_scaling)

    @property
    def torch_dtype(self):
        return _TORCH[self.compute_dtype]

    def cast_op_inputs(self, op_name, arrays):
        """The list ``arrays`` recast for op ``op_name``. Only floating
        tensors move: float32 down to the compute dtype for a
        cast-to-compute op, float16 / bfloat16 up to float32 for a
        keep-fp32 op; integer tensors, float64 and non-tensors (None)
        never do."""
        if op_name in self.cast_ops:
            tgt = self.torch_dtype
            return [a.to(tgt) if isinstance(a, torch.Tensor)
                    and a.dtype == torch.float32 else a for a in arrays]
        if op_name in self.fp32_ops:
            return [a.to(torch.float32) if isinstance(a, torch.Tensor)
                    and a.dtype in _LOW else a for a in arrays]
        return list(arrays)

    def __repr__(self):
        return 'Policy(%s, compute=%s, loss_scaling=%s)' % (
            self.name, self.compute_dtype, self.loss_scaling)


def bf16():
    """bf16 compute, no loss scaling (bf16 keeps float32's exponent
    range)."""
    return Policy('bf16', 'bfloat16')


def fp16():
    """fp16 compute with dynamic loss scaling."""
    return Policy('fp16', 'float16', loss_scaling=True)


_NAMED = {'bf16': bf16, 'bfloat16': bf16, 'fp16': fp16, 'float16': fp16}


def resolve(amp=None):
    """An ``amp=`` argument as a :class:`Policy`, or None (off).

    None reads the ``MXNET_TPU_AMP`` knob (``bf16`` | ``fp16`` |
    ``off``/unset); False forces off whatever the knob says; True means
    the default ``bf16`` policy; a string names a policy; a Policy
    passes through."""
    if amp is None:
        amp = _config.get('MXNET_TPU_AMP')
        if amp is None or str(amp).lower() in ('', 'off', '0', 'false'):
            return None
    if amp is False:
        return None
    if amp is True:
        return bf16()
    if isinstance(amp, Policy):
        return amp
    key = str(amp).lower()
    if key in ('off', 'false', '0', ''):
        return None
    if key not in _NAMED:
        raise ValueError('unknown AMP policy %r (want bf16, fp16, off, or a '
                         'Policy instance)' % (amp,))
    return _NAMED[key]()


_tls = threading.local()


def current_policy():
    """The policy active on this thread, or None."""
    return getattr(_tls, 'policy', None)


def cast_op_inputs(op_name, *arrays):
    """``arrays`` recast by the active policy for op ``op_name`` (a
    list), or as they are when no policy is active: the call every op of
    ``ops/nn.py`` makes at entry."""
    policy = getattr(_tls, 'policy', None)
    if policy is None:
        return list(arrays)
    return policy.cast_op_inputs(op_name, arrays)


class scope:
    """Activate a policy for the ops called inside the ``with`` block
    (re-entrant; ``scope(None)`` is a no-op, so call sites stay
    unconditional)."""

    __slots__ = ('_policy', '_prev')

    def __init__(self, policy):
        self._policy = policy

    def __enter__(self):
        self._prev = getattr(_tls, 'policy', None)
        if self._policy is not None:
            _tls.policy = self._policy
        return self._policy

    def __exit__(self, *exc):
        if self._policy is not None:
            _tls.policy = self._prev
        return False
