"""Transformer blocks of BERT, the counterpart of
``mxnet_tpu/gluon/nn/transformer.py``.

Self-attention always runs the flash path of the JAX blocks (the one
``MXNET_TPU_PALLAS=attention`` selects there): the valid lengths go to the
kernel as (B,) int32, no (B, S, S) mask is built, and the attention
dropout applies to the attention *context*, since the probability matrix
never exists (transformer.py:105-120). Cross-attention and dense masks,
which the JAX blocks run on their unfused path, are not ported.
"""
from __future__ import annotations

import torch

from ...context import resolve_device
from ...ops import nn as ops
from ..block import Block
from .basic_layers import Dense, Dropout, LayerNorm

__all__ = ['MultiHeadAttention', 'PositionwiseFFN', 'TransformerEncoderCell',
           'TransformerEncoder']


class MultiHeadAttention(Block):
    """Multi-head scaled dot-product self-attention with one fused QKV
    projection. Input (B, S, C) and optional (B,) valid lengths; output
    (B, S, units).

    Like the JAX block it also owns the ``query_`` and ``kv_`` projections
    of cross-attention, which self-attention never uses: they keep the
    parameter sets one to one (their gradient is zero, yet AdamW's weight
    decay still moves them, as in the JAX trainer)."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 prefix='multiheadattention_', device=None):
        super().__init__(prefix)
        if units % num_heads:
            raise ValueError('units (%d) must be divisible by num_heads (%d)'
                             % (units, num_heads))
        device = resolve_device(device)
        self._units, self._num_heads = units, num_heads
        kw = dict(use_bias=use_bias, flatten=False, in_units=units,
                  device=device)
        self.qkv_proj = Dense(3 * units, prefix='qkv_', **kw)
        self.q_proj = Dense(units, prefix='query_', **kw)
        self.kv_proj = Dense(2 * units, prefix='kv_', **kw)
        self.out_proj = Dense(units, prefix='out_', **kw)
        self.attn_dropout = Dropout(dropout)

    def _split_heads(self, x):
        # (B, S, C) -> (B*H, S, C/H); the copy leaves it contiguous
        b, s, _ = x.shape
        x = x.reshape(b, s, self._num_heads, -1).permute(0, 2, 1, 3)
        return x.reshape(b * self._num_heads, s, -1)

    def _merge_heads(self, x):
        # (B*H, S, C/H) -> (B, S, C)
        bh, s, d = x.shape
        x = x.reshape(bh // self._num_heads, self._num_heads, s, d)
        return x.permute(0, 2, 1, 3).reshape(bh // self._num_heads, s, -1)

    def forward(self, query, valid_length=None):
        q, k, v = self.qkv_proj(query).split(self._units, dim=-1)
        ctx = ops.flash_attention_op(
            self._split_heads(q), self._split_heads(k), self._split_heads(v),
            valid_length, num_heads=self._num_heads)
        ctx = self.attn_dropout(ctx)
        return self.out_proj(self._merge_heads(ctx))


class PositionwiseFFN(Block):
    """Dense -> activation -> Dense -> dropout."""

    def __init__(self, units, hidden_size, dropout=0.0, activation='gelu',
                 prefix='positionwiseffn_', device=None):
        super().__init__(prefix)
        device = resolve_device(device)
        self.ffn_1 = Dense(hidden_size, activation=activation, flatten=False,
                           in_units=units, prefix='ffn1_', device=device)
        self.ffn_2 = Dense(units, flatten=False, in_units=hidden_size,
                           prefix='ffn2_', device=device)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.drop(self.ffn_2(self.ffn_1(x)))


class TransformerEncoderCell(Block):
    """Post-norm (BERT-style) encoder cell:
    x = LN(x + Dropout(MHA(x))); x = LN(x + FFN(x))."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation='gelu', layer_norm_eps=1e-12,
                 prefix='transformerencodercell_', device=None):
        super().__init__(prefix)
        device = resolve_device(device)
        self.attention = MultiHeadAttention(units, num_heads, dropout=dropout,
                                            prefix='attn_', device=device)
        self.attn_drop = Dropout(dropout)
        self.ln_attn = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                 prefix='ln_attn_', device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                   activation=activation, prefix='ffn_',
                                   device=device)
        self.ln_ffn = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                prefix='ln_ffn_', device=device)

    def forward(self, x, valid_length=None):
        att = self.attention(x, valid_length)
        x = self.ln_attn(x + self.attn_drop(att))
        return self.ln_ffn(x + self.ffn(x))


class TransformerEncoder(Block):
    """Stack of encoder cells over (B, S, C) with optional (B,) valid
    lengths, which every cell's attention takes as they are."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, activation='gelu', layer_norm_eps=1e-12,
                 prefix='transformerencoder_', device=None):
        super().__init__(prefix)
        device = resolve_device(device)
        self.cells = torch.nn.ModuleList(
            TransformerEncoderCell(units, hidden_size, num_heads,
                                   dropout=dropout, activation=activation,
                                   layer_norm_eps=layer_norm_eps,
                                   prefix='layer%d_' % i, device=device)
            for i in range(num_layers))

    def forward(self, x, valid_length=None):
        for cell in self.cells:
            x = cell(x, valid_length)
        return x

