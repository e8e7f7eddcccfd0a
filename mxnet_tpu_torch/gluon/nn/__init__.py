"""Layers of the port (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridLambda, HybridSequential, Lambda,
                           LayerNorm, Sequential)
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ['Activation', 'BatchNorm', 'Conv2D', 'Dense', 'Dropout',
           'Embedding', 'Flatten', 'GlobalAvgPool2D', 'HybridLambda',
           'HybridSequential', 'Lambda',
           'LayerNorm', 'MaxPool2D', 'MultiHeadAttention', 'PositionwiseFFN',
           'Sequential',
           'TransformerEncoder', 'TransformerEncoderCell']
