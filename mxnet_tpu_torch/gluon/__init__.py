"""Gluon of the port (counterpart of ``mxnet_tpu/gluon``): blocks over
``torch.nn.Module``, parameters, the trainer, layers, losses and the
model zoo."""
from . import loss, model_zoo, nn, rnn
from .block import Block, HybridBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ['Block', 'HybridBlock', 'Parameter', 'ParameterDict', 'Constant',
           'DeferredInitializationError', 'Trainer', 'loss', 'model_zoo',
           'nn', 'rnn']
