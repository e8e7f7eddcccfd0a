"""BERT for masked-LM + next-sentence pretraining, the counterpart of
``mxnet_tpu/gluon/model_zoo/bert.py``.

The blocks and parameter names are the JAX model's, so
:func:`params_from_jax` carries a JAX net's weights over one to one and
the CPU parity tests compare like with like. Where the JAX model gathers
the masked positions with a one-hot ``batch_dot`` (bert.py:88-101), the
port gathers them with ``torch.gather``, which is exact against it in
float32; under AMP the rows are cast first, as ``batch_dot`` (a
cast-to-compute op) casts them, so the gathered rows have the JAX
dtype. The MLM decoder is tied to ``word_embed.weight``: the same
``nn.Parameter`` serves both, and its gradient is the sum of both uses.

Weights: :func:`init_params` fills a net from a numpy seed (normal with
std 0.02 for weights and embeddings, ones for LayerNorm gamma, zeros for
biases and beta); :func:`params_from_jax` copies a JAX net's.
"""
from __future__ import annotations

import numpy as onp
import torch

from ...amp import cast_op_inputs as _amp
from ...context import resolve_device
from ...ops import nn as ops
from ..block import Block, params_from_jax
from ..nn import Dense, Dropout, Embedding, LayerNorm, TransformerEncoder
from .stamp import zoo_constructor

__all__ = ['BERTModel', 'get_bert', 'bert_12_768_12', 'init_params',
           'params_from_jax']


class BERTModel(Block):
    """BERT encoder + pooler + tied masked-LM decoder + NSP classifier.

    Call: ``(inputs, token_types, valid_length=None,
    masked_positions=None)`` with inputs / token_types (B, S),
    valid_length (B,) and masked_positions (B, P), each of any numeric
    dtype (cast to integers as the JAX ops cast them). Returns seq_out
    (B, S, C) [, pooled (B, C)] [, mlm_scores (B, P, V)], nsp_scores
    (B, 2), as the JAX model does.
    """

    def __init__(self, vocab_size=30522, token_type_vocab_size=2, units=768,
                 hidden_size=3072, num_layers=12, num_heads=12,
                 max_length=512, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, prefix='',
                 device=None):
        super().__init__(prefix)
        device = resolve_device(device)
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        self._units = units
        self.word_embed = Embedding(vocab_size, units, prefix='word_',
                                    device=device)
        self.token_type_embed = Embedding(token_type_vocab_size, units,
                                          prefix='type_', device=device)
        self.position_embed = Embedding(max_length, units, prefix='pos_',
                                        device=device)
        self.embed_layer_norm = LayerNorm(epsilon=1e-12, in_channels=units,
                                          prefix='emb_ln_', device=device)
        self.embed_dropout = Dropout(dropout)
        self.encoder = TransformerEncoder(
            num_layers=num_layers, units=units, hidden_size=hidden_size,
            num_heads=num_heads, dropout=dropout, prefix='enc_',
            device=device)
        if use_pooler:
            self.pooler = Dense(units, activation='tanh', flatten=False,
                                in_units=units, prefix='pooler_',
                                device=device)
        if use_decoder:
            self.decoder_transform = Dense(units, activation='gelu',
                                           flatten=False, in_units=units,
                                           prefix='dec_', device=device)
            self.decoder_layer_norm = LayerNorm(epsilon=1e-12,
                                                in_channels=units,
                                                prefix='dec_ln_',
                                                device=device)
            # the decoder's weight is word_embed.weight; only the bias is
            # its own
            self.decoder_bias = torch.nn.Parameter(
                torch.zeros(vocab_size, device=device))
        if use_classifier:
            self.nsp_classifier = Dense(2, flatten=False, in_units=units,
                                        prefix='nsp_', device=device)

    def _embed(self, inputs, token_types):
        positions = torch.arange(inputs.shape[1], device=inputs.device)
        x = (self.word_embed(inputs) + self.token_type_embed(token_types)
             + self.position_embed(positions)[None])
        return self.embed_dropout(self.embed_layer_norm(x))

    def forward(self, inputs, token_types, valid_length=None,
                masked_positions=None):
        x = self._embed(inputs, token_types)
        seq = self.encoder(x, valid_length)
        outputs = [seq]
        if self._use_pooler:
            outputs.append(self.pooler(seq[:, 0, :]))
        if self._use_decoder and masked_positions is not None:
            idx = masked_positions.to(torch.int64)
            rows, = _amp('batch_dot', seq)
            gathered = torch.gather(
                rows, 1, idx[..., None].expand(-1, -1, seq.shape[2]))
            h = self.decoder_layer_norm(self.decoder_transform(gathered))
            # the tied decoder: one FullyConnected over word_embed.weight
            outputs.append(ops.fully_connected(h, self.word_embed.weight,
                                               self.decoder_bias,
                                               flatten=False))
        if self._use_classifier and self._use_pooler:
            outputs.append(self.nsp_classifier(outputs[1]))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


_BERT_CONFIGS = {
    'bert_12_768_12': dict(units=768, hidden_size=3072, num_layers=12,
                           num_heads=12),
}


@zoo_constructor
def get_bert(model_name='bert_12_768_12', vocab_size=30522, max_length=512,
             dropout=0.1, use_pooler=True, use_decoder=True,
             use_classifier=True, device=None, **kwargs):
    """A BERT of a named configuration; keyword arguments override its
    widths. ``device`` None means ``cuda``. The weights are allocated, not
    set: fill them with :func:`init_params` or :func:`params_from_jax`."""
    cfg = dict(_BERT_CONFIGS[model_name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, use_pooler=use_pooler,
                     use_decoder=use_decoder, use_classifier=use_classifier,
                     device=device, **cfg)


@zoo_constructor
def bert_12_768_12(**kwargs):
    return get_bert('bert_12_768_12', **kwargs)


@torch.no_grad()
def init_params(net, seed=0, std=0.02):
    """Fill every parameter of ``net`` from a numpy seed: LayerNorm gamma
    1, biases and beta 0, every other weight normal(0, ``std``), BERT's
    usual initializer. (``bench_bert`` asks for ``TruncNorm(0.02)`` only
    where the package has it, bench.py:283-284; the JAX package has
    none, so the bench initializes with ``Xavier()``.) Parameters are
    drawn in sorted name order, so the values do not depend on the device
    or on the order of construction. Returns ``net``."""
    rng = onp.random.default_rng(seed)
    params = net.collect_params().tensors()
    for name in sorted(params):
        p = params[name]
        if name.endswith('gamma'):
            p.fill_(1.0)
        elif name.endswith('bias') or name.endswith('beta'):
            p.zero_()
        else:
            w = rng.standard_normal(tuple(p.shape), dtype=onp.float32) * std
            p.copy_(torch.from_numpy(w))
    for p in net.collect_params().values():
        p._initialized = True
    return net
