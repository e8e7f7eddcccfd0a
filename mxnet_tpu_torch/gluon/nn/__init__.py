"""Layers of the port (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import Activation, Dense, Dropout, Embedding, LayerNorm
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ['Activation', 'Dense', 'Dropout', 'Embedding', 'LayerNorm',
           'MultiHeadAttention', 'PositionwiseFFN', 'TransformerEncoder',
           'TransformerEncoderCell']
