"""Gluon layers, losses and model zoo of the port (counterpart of
``mxnet_tpu/gluon``), as ``torch.nn.Module``s."""
from . import loss, model_zoo, nn, rnn
from .block import Block

__all__ = ['Block', 'loss', 'model_zoo', 'nn', 'rnn']
