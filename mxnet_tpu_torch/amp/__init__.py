"""Automatic mixed precision of the port, the counterpart of
``mxnet_tpu/amp``.

``ParallelTrainer(amp='bf16')`` (or ``MXNET_TPU_AMP=bf16``) runs the
forward and the loss under a :class:`Policy` scope: each op of
``ops/nn.py`` recasts its floating inputs by its class as it is called,
so the matmul family computes on bf16 copies of the float32 masters,
gradients widen to float32 at each parameter (the cast's backward), and
the optimizer update and its state stay float32.
"""
from .policy import (CAST_COMPUTE_OPS, KEEP_FP32_OPS, Policy, bf16,
                     cast_op_inputs, current_policy, fp16, resolve, scope)

__all__ = ['Policy', 'bf16', 'fp16', 'resolve', 'scope', 'current_policy',
           'cast_op_inputs', 'CAST_COMPUTE_OPS', 'KEEP_FP32_OPS']
