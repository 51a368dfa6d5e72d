"""Fused recurrent layers: RNN / LSTM / GRU (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``) as ``nn.Module``s.

Parameters are separate per (layer, direction) arrays with the JAX
package's names and layouts, so a dict of its ``collect_params()`` loads
as it is (``gluon.params.load_jax_params``): ``l0_i2h_weight`` (G*H, C),
``l0_h2h_weight`` (G*H, H), ``l0_i2h_bias`` and ``l0_h2h_bias`` (G*H,),
``r0_...`` for the reverse direction. The recurrence is
``ops.rnn.fused_rnn``: one product for all input projections, then the
time-fused kernels, run through the op funnel (``ops/registry.py``) as
``f"rnn_{mode}"`` with the input, the states and every parameter as its
inputs, as the JAX package funnels it (``amp`` casts them all).

``input_size`` is required (shapes are not inferred at the first call),
parameters are float32, and ``device`` defaults to ``cuda:0``. The
``i2h_*_initializer`` / ``h2h_*_initializer`` keywords name the
parameters' initializers, as ``gluon.nn``'s layers do.
Inter-layer dropout runs in ``train()`` mode only, with masks from
``generator``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops import rnn as rnn_ops
from ...ops.registry import invoke
from ..nn.basic_layers import _param, drawing, note_draw

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(nn.Module):
    def __init__(self, mode, hidden_size, num_layers=1, layout="TNC",
                 dropout=0.0, bidirectional=False, input_size=0,
                 device=None, generator: Optional[torch.Generator] = None,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros"):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"invalid layout {layout!r}; TNC or NTC")
        if input_size <= 0:
            raise MXNetError(f"{type(self).__name__} needs input_size "
                             "(shapes are not inferred at the first call)")
        dev = resolve_device(device)
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._generator = generator
        ng = rnn_ops.GATES[mode] * hidden_size
        inits = {"i2h_weight": i2h_weight_initializer,
                 "h2h_weight": h2h_weight_initializer,
                 "i2h_bias": i2h_bias_initializer,
                 "h2h_bias": h2h_bias_initializer}
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * self._dir
            for pre in ("l", "r")[:self._dir]:
                for sfx, shape in (("i2h_weight", (ng, in_sz)),
                                   ("h2h_weight", (ng, hidden_size)),
                                   ("i2h_bias", (ng,)),
                                   ("h2h_bias", (ng,))):
                    name = f"{pre}{layer}_{sfx}"
                    setattr(self, name, _param(name, shape, dev, inits[sfx],
                                               generator))

    def _ordered_params(self) -> List[nn.Parameter]:
        return [getattr(self, f"{pre}{layer}_{sfx}")
                for layer in range(self._num_layers)
                for pre in ("l", "r")[:self._dir]
                for sfx in ("i2h_weight", "h2h_weight", "i2h_bias",
                            "h2h_bias")]

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"} for _ in range(n)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero initial states (``func(shape, **kwargs)`` when given), on
        the layer's device and in its dtype unless ``kwargs`` say
        otherwise."""
        func = func or torch.zeros
        p = self.l0_h2h_weight
        kwargs.setdefault("device", p.device)
        kwargs.setdefault("dtype", p.dtype)
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def forward(self, inputs, states=None):
        """inputs: (T, N, C) for TNC / (N, T, C) for NTC. Returns output, or
        ``(output, states_out)`` when states were passed (the JAX
        package's forward contract)."""
        x = inputs.transpose(0, 1) if self._layout == "NTC" else inputs
        ret_states = states is not None
        if states is None:
            states = self.begin_state(x.shape[1], dtype=x.dtype)
        elif isinstance(states, torch.Tensor):
            states = [states]
        mode = self._mode
        nl, bi, dr = self._num_layers, self._dir == 2, self._dropout
        train, gen = drawing(self), self._generator
        if self._dropout > 0.0 and self._num_layers > 1:
            note_draw(self, gen)

        def fn(x_, h0_, *rest):
            if mode == "lstm":
                c0_, *pk = rest
            else:
                c0_, pk = None, list(rest)
            y, h, c = rnn_ops.fused_rnn(x_, h0_, c0_, pk, mode, nl, bi,
                                        dropout=dr, train=train,
                                        generator=gen)
            return (y, h, c) if c is not None else (y, h)

        inputs = [x, states[0]] + ([states[1]] if mode == "lstm" else []) \
            + self._ordered_params()
        y, *out_states = invoke(f"rnn_{mode}", fn, *inputs)
        if self._layout == "NTC":
            y = y.transpose(0, 1)
        return (y, out_states) if ret_states else y

    def extra_repr(self):
        return (f"{self._input_size} -> {self._hidden_size}, {self._layout}, "
                f"num_layers={self._num_layers}"
                f"{', bidirectional' if self._dir == 2 else ''}")


class RNN(_RNNLayer):
    """Vanilla Elman RNN (``activation`` "relu" or "tanh")."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(mode, hidden_size, num_layers, layout, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (gate order i, f, g, o)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (gate order r, z, n)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, **kwargs)
