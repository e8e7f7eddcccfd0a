"""Serving (the port of ``mxnet_tpu/serving``): one-shot inference
(``freeze`` -> ``FrozenProgram`` -> ``InferenceSession.infer`` / ``submit``
through the micro-batcher) and generation (``freeze_decode`` ->
``PagedDecodeProgram`` or ``DecodeProgram`` -> ``InferenceSession.generate``).
"""
from .batcher import (BackpressureError, BatcherClosed, MicroBatcher,
                      RequestTimeout)
from .bucket import BucketPolicy
from .decode import (DecodeProgram, PagedDecodeProgram, TransformerLM,
                     freeze_decode, init_transformer_lm, params_from_jax)
from .freeze import FrozenProgram, freeze
from .server import InferenceSession

__all__ = ['BackpressureError', 'BatcherClosed', 'MicroBatcher',
           'RequestTimeout', 'BucketPolicy', 'DecodeProgram',
           'PagedDecodeProgram',
           'TransformerLM', 'freeze_decode', 'init_transformer_lm',
           'params_from_jax', 'FrozenProgram', 'freeze', 'InferenceSession']
