"""Fused recurrent layers, the counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py`` (``_RNNLayer`` :18, ``RNN`` :153,
``LSTM`` :173, ``GRU`` :194) over the port's fused op
(``ops.nn.rnn``).

The parameters are the JAX layer's, under its names and in its order:
for each direction (``l``, then ``r`` when bidirectional), for each
layer, ``<d><i>_i2h_weight`` (G*H, in), ``_h2h_weight`` (G*H, H),
``_i2h_bias`` and ``_h2h_bias`` (G*H,). So ``gluon.block.params_from_jax``
fills them from a JAX layer's ``collect_params()``, and the flat vector
the op takes is built in the cuDNN layout the op unpacks (every layer's
weights, then every layer's biases).

A ``torch.nn.Module`` allocates at construction, so the port needs
``input_size`` up front (the JAX layer infers it at the first call).
Weights are allocated uninitialised and biases start at 0, as the other
layers of the port; the model's initializer or ``params_from_jax`` fills
them. ``dropout`` applies between layers in training only, and the fused
op does not port it: a layer with ``dropout`` > 0 computes in inference
mode and raises NotImplementedError in training. ``projection_size``
raises NotImplementedError (the JAX layer stores it and ignores it).
"""
from __future__ import annotations

import torch

from ...context import resolve_device
from ...ops import nn as ops
from ..block import Block, training

__all__ = ['RNN', 'LSTM', 'GRU']


class _RNNLayer(Block):
    """A multi-layer (bi)RNN of one mode over the fused op."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode, prefix='', device=None):
        super().__init__(prefix)
        if layout not in ('TNC', 'NTC'):
            raise ValueError('Invalid layout %s; must be one of ["TNC" or '
                             '"NTC"]' % layout)
        if input_size <= 0:
            raise ValueError('%s: the port allocates at construction and '
                             'needs input_size > 0, got %r'
                             % (type(self).__name__, input_size))
        device = resolve_device(device)
        self._hidden_size, self._num_layers = hidden_size, num_layers
        self._mode, self._layout, self._dropout = mode, layout, dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = ops._gates(mode)
        gh = self._gates * hidden_size
        for d in self._directions():
            for layer in range(num_layers):
                fan_in = input_size if layer == 0 else hidden_size * self._dir
                for piece, shape in (('i2h_weight', (gh, fan_in)),
                                     ('h2h_weight', (gh, hidden_size)),
                                     ('i2h_bias', (gh,)),
                                     ('h2h_bias', (gh,))):
                    t = torch.empty(shape, dtype=torch.float32, device=device)
                    if piece.endswith('bias'):
                        t.zero_()
                    setattr(self, '%s%d_%s' % (d, layer, piece),
                            torch.nn.Parameter(t))

    def _directions(self):
        return ('l', 'r')[:self._dir]

    def __repr__(self):
        parts = ['%d -> %d' % (self._input_size, self._hidden_size),
                 self._layout]
        if self._num_layers != 1:
            parts.append('num_layers=%d' % self._num_layers)
        if self._dropout != 0:
            parts.append('dropout=%g' % self._dropout)
        if self._dir == 2:
            parts.append('bidirectional')
        return '%s(%s)' % (type(self).__name__, ', '.join(parts))

    def state_info(self, batch_size=0):
        """One ``{'shape', '__layout__'}`` a state tensor: (L*D, N, H)."""
        info = {'shape': (self._num_layers * self._dir, batch_size,
                          self._hidden_size), '__layout__': 'LNC'}
        return [info, dict(info)] if self._mode == 'lstm' else [info]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, ``func(shape, **kwargs)`` each (default
        ``torch.zeros`` on the layer's device, float32)."""
        if func is None:
            func = torch.zeros
            kwargs.setdefault('device', self.l0_i2h_weight.device)
            kwargs.setdefault('dtype', torch.float32)
        return [func(info['shape'], **kwargs)
                for info in self.state_info(batch_size)]

    def _flat_params(self):
        """The op's flat vector: every layer's weights, then every
        layer's biases, each layer's directions in turn."""
        return ops._rnn_param_concat(*[
            getattr(self, '%s%d_%s' % (d, layer, piece))
            for group in (('i2h_weight', 'h2h_weight'),
                          ('i2h_bias', 'h2h_bias'))
            for layer in range(self._num_layers)
            for d in self._directions()
            for piece in group])

    def forward(self, inputs, states=None):
        """``inputs`` (T, N, C) or, under ``NTC``, (N, T, C). Without
        ``states`` (the zeros of :meth:`begin_state`) returns the output;
        with them, (output, [new states])."""
        batch_size = inputs.shape[self._layout.find('N')]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size)
        if isinstance(states, torch.Tensor):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if tuple(state.shape) != info['shape']:
                raise ValueError(
                    'Invalid recurrent state shape. Expecting %s, got %s.'
                    % (str(info['shape']), str(tuple(state.shape))))
        if self._layout == 'NTC':
            inputs = inputs.transpose(0, 1)
        out = ops.rnn(inputs, self._flat_params(), *states,
                      state_size=self._hidden_size,
                      num_layers=self._num_layers,
                      bidirectional=self._dir == 2, mode=self._mode,
                      p=self._dropout if training(self) else 0.0)
        outputs, states = out[0], list(out[1:])
        if self._layout == 'NTC':
            outputs = outputs.transpose(0, 1)
        return outputs if skip_states else (outputs, states)


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with ``activation`` tanh or relu."""

    def __init__(self, hidden_size, num_layers=1, activation='relu',
                 layout='TNC', dropout=0, bidirectional=False, input_size=0,
                 prefix='', device=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, 'rnn_' + activation,
                         prefix=prefix, device=device)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (gates i, f, g, o)."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0, projection_size=None,
                 prefix='', device=None):
        if projection_size is not None:
            raise NotImplementedError(
                'LSTM: projection_size=%r is not ported (the JAX layer '
                'ignores it)' % (projection_size,))
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, 'lstm', prefix=prefix,
                         device=device)


class GRU(_RNNLayer):
    """Multi-layer GRU (gates r, z, n)."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0, prefix='', device=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, 'gru', prefix=prefix,
                         device=device)
