"""Recurrent cells (counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``)
as ``nn.Module``s.

A cell steps one timestep: ``cell(input, states) -> (output,
new_states)``. ``unroll`` runs it over a sequence given as a list of
``(N, C)`` steps or as one tensor laid out ``NTC`` / ``TNC``, and
returns a list of ``T`` outputs, or one merged tensor with
``merge_outputs=True``, and the last states. ``valid_length`` (N,)
zeroes each sequence's outputs past its length (``SequenceMask``); the
states run on over the whole sequence, as in the JAX package.

The three gated cells, exactly ``RNNCell`` (tanh or relu), ``LSTMCell``
and ``GRUCell`` and no subclass, unroll a merged 3-d ``NTC`` / ``TNC``
tensor without ``valid_length`` through the same time-fused recurrence
as the ``rnn_layer.py`` layers (``ops.rnn.fused_rnn``, one layer): one
product for all input projections, then the recurrence kernels (on the
card one ``rnn_scan_fwd`` launch an unroll and one ``rnn_scan_bwd`` in
a backward), funnelled as ``f"rnn_{mode}_unroll"`` with the input, the
states and every parameter as its inputs, so ``amp`` casts it as it
casts the layers. Every other unroll (a step list, ``valid_length``, a
subclass, the combinators) is the step loop, whose products go through
the funnel as ``"fully_connected"``.

Parameter names are the JAX blocks' ``collect_params()`` names
(``i2h_weight`` (G*H, C), ``h2h_weight`` (G*H, H), ``i2h_bias``,
``h2h_bias``; a sequential cell's children ``0``, ``1``, ...; a
modifier's ``base_cell``; a bidirectional cell's ``l_cell`` /
``r_cell``), so ``gluon.params.load_jax_params`` loads a JAX cell's dict
as it is. ``input_size`` is required (shapes are not inferred at the
first call); a cell with parameters takes ``device`` (default
``cuda:0``; without CUDA it raises unless ``device="cpu"``) and a
``generator`` for its random initial weights.

``DropoutCell`` and ``ZoneoutCell`` draw their masks from their
``generator`` (None: the device's default one) and note it with
``note_draw``, so a captured train step registers it and each replay
draws anew; in eval mode they are the identity. ``ZoneoutCell`` keeps
its previous output in Python between calls, until ``reset()``: a loss
function captured by ``compile_step`` calls ``net.reset()`` first, as
the reference does between sequences (``ROADMAP.md`` §3).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ndarray.ops import SequenceMask, SequenceReverse
from ...ops import nn as FNN
from ...ops import rnn as rnn_ops
from ...ops.registry import invoke
from ..nn.basic_layers import (_param, activation, drawing, dropout,
                                keep_mask, note_draw)

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout):
    """``inputs`` as a list of steps (a tensor is split on its T axis,
    its first ``length`` steps), the length and the T axis."""
    t_axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        steps = list(inputs)
        if length is not None and len(steps) != length:
            raise MXNetError(f"expected {length} steps, got {len(steps)}")
        return steps, len(steps), t_axis
    if length is None:
        length = inputs.shape[t_axis]
    return [inputs.select(t_axis, i) for i in range(length)], length, t_axis


class RecurrentCell(nn.Module):
    """Base cell: ``cell(input, states) -> (output, new_states)``."""

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states, ``func(shape, **kwargs)`` a state (default
        ``torch.zeros``), on the cell's device unless ``kwargs`` name
        one."""
        func = func or torch.zeros
        p = next(self.parameters(), None)
        if p is not None:
            kwargs.setdefault("device", p.device)
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def reset(self):
        """Forget what the cell holds between calls (a zoneout cell's
        previous output, a variational cell's masks), in every child."""
        for child in self.children():
            if isinstance(child, RecurrentCell):
                child.reset()

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps: the step loop. States
        default to zeros in the input's dtype and on its device."""
        steps, length, t_axis = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(steps[0].shape[0],
                                           dtype=steps[0].dtype,
                                           device=steps[0].device)
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(steps[i], states)
            outputs.append(out)
        if valid_length is not None:
            masked = SequenceMask(torch.stack(outputs, dim=0),
                                  sequence_length=valid_length,
                                  use_sequence_length=True, value=0.0)
            outputs = list(masked.unbind(0))
        if merge_outputs:
            return torch.stack(outputs, dim=t_axis), states
        return outputs, states


#: the JAX package makes every cell traceable, so the two are one class
HybridRecurrentCell = RecurrentCell


class _BaseRNNCell(RecurrentCell):
    """The parameters and the fused unroll of the three gated cells."""

    _gates = 1

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_size <= 0:
            raise MXNetError(f"{type(self).__name__} needs input_size "
                             "(shapes are not inferred at the first call)")
        dev = resolve_device(device)
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = self._gates * hidden_size
        for name, shape, init in (
                ("i2h_weight", (ng, input_size), i2h_weight_initializer),
                ("h2h_weight", (ng, hidden_size), h2h_weight_initializer),
                ("i2h_bias", (ng,), i2h_bias_initializer),
                ("h2h_bias", (ng,), h2h_bias_initializer)):
            setattr(self, name, _param(name, shape, dev, init, generator))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _fused_mode(self) -> Optional[str]:
        """The ``ops.rnn`` mode when this exact class's step is the fused
        recurrence's (None: the step loop). A subclass may override the
        step, so only the three plain gated cells qualify."""
        return None

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """A merged (N, T, C) / (T, N, C) tensor without ``valid_length``
        runs through the fused recurrence (module docstring); anything
        else takes the step loop."""
        mode = self._fused_mode()
        if (mode is None or valid_length is not None
                or not isinstance(inputs, torch.Tensor) or inputs.ndim != 3
                or layout not in ("NTC", "TNC")):
            return super().unroll(length, inputs, begin_state, layout,
                                  merge_outputs, valid_length)
        t_axis = layout.find("T")
        x = inputs.transpose(0, 1) if layout == "NTC" else inputs
        if length is not None and x.shape[0] != length:
            raise MXNetError(f"expected {length} steps, got {x.shape[0]}")
        if begin_state is None:
            begin_state = self.begin_state(x.shape[1], dtype=x.dtype,
                                           device=x.device)
        lstm = mode == "lstm"
        states = [s.unsqueeze(0) for s in begin_state[:2 if lstm else 1]]

        def fn(x_, h0_, *rest):
            c0_, pk = (rest[0], rest[1:]) if lstm else (None, rest)
            y, h, c = rnn_ops.fused_rnn(x_, h0_, c0_, list(pk), mode, 1,
                                        False)
            return (y, h, c) if lstm else (y, h)

        y, *out = invoke(f"rnn_{mode}_unroll", fn, x, *states,
                         self.i2h_weight, self.h2h_weight, self.i2h_bias,
                         self.h2h_bias)
        out = [s[0] for s in out]
        if layout == "NTC":
            y = y.transpose(0, 1)
        if merge_outputs:
            return y, out
        return list(y.unbind(t_axis)), out

    def _proj(self, x, h):
        i2h = invoke("fully_connected", FNN.linear, x, self.i2h_weight,
                     self.i2h_bias)
        h2h = invoke("fully_connected", FNN.linear, h, self.h2h_weight,
                     self.h2h_bias)
        return i2h, h2h

    def extra_repr(self):
        return f"{self._input_size} -> {self._hidden_size}"


class RNNCell(_BaseRNNCell):
    """Elman cell: h' = act(W_i x + b_i + W_h h + b_h)."""

    _gates = 1

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def _fused_mode(self):
        if type(self) is RNNCell and self._activation in ("tanh", "relu"):
            return f"rnn_{self._activation}"
        return None

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states[0])
        out = activation(i2h + h2h, self._activation)
        return out, [out]


class LSTMCell(_BaseRNNCell):
    """LSTM cell, gate order [i, f, g, o]."""

    _gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _fused_mode(self):
        return "lstm" if type(self) is LSTMCell else None

    def forward(self, inputs, states):
        h, c = states
        i2h, h2h = self._proj(inputs, h)
        i, f, g, o = (i2h + h2h).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, [h_new, c_new]


class GRUCell(_BaseRNNCell):
    """GRU cell, gate order [r, z, n]."""

    _gates = 3

    def _fused_mode(self):
        return "gru" if type(self) is GRUCell else None

    def forward(self, inputs, states):
        h = states[0]
        i2h, h2h = self._proj(inputs, h)
        xr, xz, xn = i2h.chunk(3, dim=-1)
        hr, hz, hn = h2h.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        return h_new, [h_new]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each steps on the output of the one before; the
    states are the cells' states concatenated. Children are named ``0``,
    ``1``, ... in the order :meth:`add` gave them."""

    def add(self, cell):
        self.add_module(str(len(self._modules)), cell)

    @property
    def _cells(self) -> List[RecurrentCell]:
        return list(self._modules.values())

    def state_info(self, batch_size=0):
        return _cells_state_info(self._cells, batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return _cells_begin_state(self._cells, batch_size=batch_size,
                                  **kwargs)

    def forward(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._cells:
            n = len(cell.state_info())
            inputs, st = cell(inputs, states[pos:pos + n])
            next_states.extend(st)
            pos += n
        return inputs, next_states

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return self._cells[i]


class HybridSequentialRNNCell(SequentialRNNCell):
    """:class:`SequentialRNNCell` under the JAX package's hybridizable
    name (the port has one kind of cell)."""


class DropoutCell(RecurrentCell):
    """Dropout on the input at ``rate`` in training mode (masks from
    ``generator``); no states."""

    def __init__(self, rate, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._rate = rate
        self._generator = generator

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        note_draw(self, self._generator)
        if self._rate > 0 and drawing(self):
            inputs = dropout(inputs, self._rate, self._generator)
        return inputs, states


class ModifierCell(RecurrentCell):
    """A cell wrapped to modify its step: the parameters and states are
    the wrapped ``base_cell``'s."""

    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size=batch_size, **kwargs)


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al. 2016): in training mode each output unit
    keeps the previous step's output with probability
    ``zoneout_outputs``, each state unit its previous value with
    probability ``zoneout_states`` (masks from ``generator``). The
    previous output is held between calls until :meth:`reset` (zeros at
    the first step)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(base_cell)
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._generator = generator
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        note_draw(self, self._generator)
        gen = self._generator
        if self._zoneout_outputs > 0 and drawing(self):
            prev = self._prev_output
            if prev is None:
                prev = torch.zeros_like(out)
            out = torch.where(keep_mask(out, self._zoneout_outputs, gen),
                              out, prev)
        if self._zoneout_states > 0 and drawing(self):
            next_states = [torch.where(keep_mask(ns, self._zoneout_states,
                                                 gen), ns, s)
                           for ns, s in zip(next_states, states)]
        self._prev_output = out
        return out, next_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def forward(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        return out + inputs, next_states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed (each
    sequence over its own ``valid_length``), their outputs concatenated
    on the last axis; only :meth:`unroll` runs it. Both run the step
    loop, as in the JAX package."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return _cells_state_info([self.l_cell, self.r_cell], batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return _cells_begin_state([self.l_cell, self.r_cell],
                                  batch_size=batch_size, **kwargs)

    def forward(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        steps, length, t_axis = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(steps[0].shape[0],
                                           dtype=steps[0].dtype,
                                           device=steps[0].device)
        n_l = len(self.l_cell.state_info())
        l_states, r_states = begin_state[:n_l], begin_state[n_l:]
        sub = "TNC" if t_axis == 0 else "NTC"
        l_out, l_states = self.l_cell.unroll(
            length, steps, l_states, layout=sub, merge_outputs=False,
            valid_length=valid_length)
        if valid_length is not None:
            rev = SequenceReverse(torch.stack(steps, dim=0),
                                  sequence_length=valid_length,
                                  use_sequence_length=True)
            rev_steps = list(rev.unbind(0))
        else:
            rev_steps = steps[::-1]
        r_out, r_states = self.r_cell.unroll(
            length, rev_steps, r_states, layout=sub, merge_outputs=False,
            valid_length=valid_length)
        if valid_length is not None:
            r_out = list(SequenceReverse(torch.stack(r_out, dim=0),
                                         sequence_length=valid_length,
                                         use_sequence_length=True).unbind(0))
        else:
            r_out = r_out[::-1]
        outputs = [torch.cat([lo, ro], dim=-1) for lo, ro in zip(l_out, r_out)]
        if merge_outputs:
            return torch.stack(outputs, dim=t_axis), l_states + r_states
        return outputs, l_states + r_states
