"""Recurrent layers of the port (counterpart of ``mxnet_tpu/gluon/rnn``):
the fused ``RNN``, ``LSTM`` and ``GRU`` layers. The unrolled cells of
``rnn_cell.py`` are not ported."""
from .rnn_layer import GRU, LSTM, RNN

__all__ = ['RNN', 'LSTM', 'GRU']
