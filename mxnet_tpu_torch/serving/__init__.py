"""Serving (the port of ``mxnet_tpu/serving``): one-shot inference
(``freeze`` -> ``FrozenProgram`` -> ``InferenceSession.infer`` / ``submit``
through the micro-batcher) and generation (``freeze_decode`` ->
``PagedDecodeProgram`` or ``DecodeProgram`` -> ``InferenceSession.generate``);
their artifacts (``save``, ``load_frozen``, ``load_decode``), the JSON
endpoint (``ServingHTTPServer``, ``maybe_start_http_server``) and the
gateway over a fleet of endpoints (``ServingGateway``).
"""
from .batcher import (BackpressureError, BatcherClosed, MicroBatcher,
                      RequestTimeout)
from .bucket import BucketPolicy
from .decode import (RNNLM, DecodeProgram, PagedDecodeProgram, TransformerLM,
                     freeze_decode, init_rnn_lm, init_transformer_lm,
                     load_decode, params_from_jax)
from .freeze import FROZEN_SCHEMA, FrozenProgram, freeze, load_frozen
from .gateway import ServingGateway
from .server import (InferenceSession, ServingHTTPServer,
                     maybe_start_http_server)

__all__ = ['BackpressureError', 'BatcherClosed', 'MicroBatcher',
           'RequestTimeout', 'BucketPolicy', 'DecodeProgram',
           'PagedDecodeProgram', 'RNNLM',
           'TransformerLM', 'freeze_decode', 'init_rnn_lm',
           'init_transformer_lm',
           'load_decode', 'params_from_jax', 'FROZEN_SCHEMA', 'FrozenProgram',
           'freeze', 'load_frozen', 'InferenceSession', 'ServingHTTPServer',
           'maybe_start_http_server', 'ServingGateway']
