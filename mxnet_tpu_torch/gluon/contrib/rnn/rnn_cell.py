"""Contrib recurrent cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``): ``VariationalDropoutCell``
and ``LSTMPCell``, both stepped by the step loop of
``gluon.rnn.RecurrentCell.unroll``."""
from __future__ import annotations

from typing import Optional

import torch

from ....base import MXNetError
from ....context import resolve_device
from ....ops import nn as FNN
from ....ops.registry import invoke
from ...nn.basic_layers import _param, drawing, dropout, note_draw
from ...rnn.rnn_cell import RecurrentCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(RecurrentCell):
    """Variational dropout around ``base_cell`` (Gal & Ghahramani,
    arXiv:1512.05287): one mask for the inputs, one for the first state
    and one for the outputs, each drawn at the first step (from
    ``generator``) and kept until :meth:`reset`. A mask drawn in eval
    mode is all ones, and is kept as well. Call ``reset()`` between
    sequences, as in the reference; a loss function captured by
    ``compile_step`` calls it first (``ROADMAP.md`` §3)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.base_cell = base_cell
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._generator = generator
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size=batch_size, **kwargs)

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _mask(self, like, rate):
        note_draw(self, self._generator)
        ones = torch.ones_like(like)
        return dropout(ones, rate, self._generator) if drawing(self) else ones

    def forward(self, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = self._mask(states[0], self.drop_states)
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = self._mask(inputs, self.drop_inputs)
        if self.drop_states:
            states = list(states)
            # only h, the first state (the reference's contract)
            states[0] = states[0] * self.drop_states_mask
        if self.drop_inputs:
            inputs = inputs * self.drop_inputs_mask
        out, next_states = self.base_cell(inputs, states)
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = self._mask(out, self.drop_outputs)
        if self.drop_outputs:
            out = out * self.drop_outputs_mask
        return out, next_states

    def extra_repr(self):
        return (f"p_out={self.drop_outputs}, p_state={self.drop_states}, "
                f"p_in={self.drop_inputs}")


class LSTMPCell(RecurrentCell):
    """LSTM with a projected hidden state (Sak et al. 2014): the (N, H)
    hidden is projected to (N, P) by ``h2r_weight`` (P, H), no bias,
    before it recurs. Gate order [i, f, g, o]; states ``[r (N, P), c (N,
    H)]``. ``input_size`` is required."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_size <= 0:
            raise MXNetError("LSTMPCell needs input_size (shapes are not "
                             "inferred at the first call)")
        dev = resolve_device(device)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        g = 4 * hidden_size
        for name, shape, init in (
                ("i2h_weight", (g, input_size), i2h_weight_initializer),
                ("h2h_weight", (g, projection_size), h2h_weight_initializer),
                ("h2r_weight", (projection_size, hidden_size),
                 h2r_weight_initializer),
                ("i2h_bias", (g,), i2h_bias_initializer),
                ("h2h_bias", (g,), h2h_bias_initializer)):
            setattr(self, name, _param(name, shape, dev, init, generator))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, inputs, states):
        r, c = states
        i2h = invoke("fully_connected", FNN.linear, inputs, self.i2h_weight,
                     self.i2h_bias)
        h2h = invoke("fully_connected", FNN.linear, r, self.h2h_weight,
                     self.h2h_bias)
        i, f, g, o = (i2h + h2h).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hidden = torch.sigmoid(o) * torch.tanh(c_new)
        r_new = invoke("fully_connected", FNN.linear, hidden,
                       self.h2r_weight)
        return r_new, [r_new, c_new]

    def extra_repr(self):
        return (f"{self._input_size} -> {self._hidden_size} -> "
                f"{self._projection_size}")
