"""Autoregressive decoding over a slot or a paged KV cache, or an RNN's
recurrent state (the port of ``mxnet_tpu/serving/decode``)."""
from .engine import DecodeEngine, DrainTimeout, GenerateStream
from .model import (RNNLM, DecodeModel, TransformerLM, from_gluon_rnn_lm,
                    init_rnn_lm, init_transformer_lm, model_from_config,
                    params_from_jax)
from .paged import PageAllocator, PagedCacheSpec, PrefixCache
from .program import (DecodeProgram, PagedDecodeProgram, freeze_decode,
                      load_decode)
from .seqstate import SEQSTATE_SCHEMA, SeqStateError

__all__ = ['DecodeEngine', 'DrainTimeout', 'GenerateStream', 'DecodeModel',
           'RNNLM', 'TransformerLM', 'from_gluon_rnn_lm', 'init_rnn_lm',
           'init_transformer_lm', 'model_from_config',
           'params_from_jax', 'PageAllocator', 'PagedCacheSpec',
           'PrefixCache', 'DecodeProgram', 'PagedDecodeProgram',
           'freeze_decode', 'load_decode', 'SEQSTATE_SCHEMA',
           'SeqStateError']
