"""Layers of the port (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .activations import (ELU, GELU, SELU, Activation, LeakyReLU, PReLU,
                          Swish)
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding, Flatten,
                           HybridLambda, HybridSequential, InstanceNorm,
                           Lambda, LayerNorm, Sequential)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                          ReflectionPad2D)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ['Activation', 'AvgPool1D', 'AvgPool2D', 'AvgPool3D', 'BatchNorm',
           'Conv1D', 'Conv1DTranspose', 'Conv2D', 'Conv2DTranspose',
           'Conv3D', 'Conv3DTranspose', 'Dense', 'Dropout', 'ELU',
           'Embedding', 'Flatten', 'GELU', 'GlobalAvgPool1D',
           'GlobalAvgPool2D', 'GlobalAvgPool3D', 'GlobalMaxPool1D',
           'GlobalMaxPool2D', 'GlobalMaxPool3D', 'HybridLambda',
           'HybridSequential', 'InstanceNorm', 'Lambda', 'LayerNorm',
           'LeakyReLU', 'MaxPool1D', 'MaxPool2D', 'MaxPool3D',
           'MultiHeadAttention', 'PReLU', 'PositionwiseFFN',
           'ReflectionPad2D', 'SELU', 'Sequential', 'Swish',
           'TransformerEncoder', 'TransformerEncoderCell']
