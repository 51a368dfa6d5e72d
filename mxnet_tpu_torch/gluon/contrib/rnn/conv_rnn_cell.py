"""Convolutional recurrent cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``): ``Conv{1,2,3}D{RNN,
LSTM,GRU}Cell``.

A step is two convolutions, i2h on the input and h2h on the hidden
state, through ``ops.nn.conv`` (cuDNN on the card, as the convolutional
layers; the JAX package's are XLA's), funnelled as ``"convolution"``,
then the gate arithmetic with the gates split on axis 1. The h2h
convolution takes an odd kernel with SAME padding (``dilate * (k - 1) //
2``), so the state keeps its spatial shape, which is the i2h
convolution's output shape over ``input_shape`` (stride 1). Layouts are
channel-first (NCW, NCHW, NCDHW); any other raises. Parameter names
and shapes are the JAX cells': ``i2h_weight`` (G*C_h, C_in, *k),
``h2h_weight`` (G*C_h, C_h, *k), ``i2h_bias``, ``h2h_bias``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ....base import MXNetError
from ....context import resolve_device
from ....ops import nn as FNN
from ....ops.registry import invoke
from ...nn.basic_layers import _param, activation
from ...rnn.rnn_cell import RecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, n, name):
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    if len(t) != n:
        raise MXNetError(f"{name} must be an int or length-{n} tuple, "
                         f"got {v!r}")
    return t


class _BaseConvRNNCell(RecurrentCell):
    """The convolutions and parameters of the nine cells."""

    _gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dims=2, conv_layout="NCHW", activation="tanh", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if conv_layout != "NC" + "DHW"[3 - dims:]:
            raise MXNetError("only the channel-first layout is supported, "
                             f"got {conv_layout!r}")
        dev = resolve_device(device)
        self._dims = dims
        self._input_shape = tuple(input_shape)   # (C_in, *spatial)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, dims, "i2h_kernel")
        self._i2h_pad = _tup(i2h_pad, dims, "i2h_pad")
        self._i2h_dilate = _tup(i2h_dilate, dims, "i2h_dilate")
        self._h2h_kernel = _tup(h2h_kernel, dims, "h2h_kernel")
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise MXNetError(f"h2h_kernel must be odd (SAME padding keeps "
                             f"the state shape), got {self._h2h_kernel}")
        self._h2h_dilate = _tup(h2h_dilate, dims, "h2h_dilate")
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        ng = self._gates * hidden_channels
        for name, shape, init in (
                ("i2h_weight", (ng, self._input_shape[0]) + self._i2h_kernel,
                 i2h_weight_initializer),
                ("h2h_weight", (ng, hidden_channels) + self._h2h_kernel,
                 h2h_weight_initializer),
                ("i2h_bias", (ng,), i2h_bias_initializer),
                ("h2h_bias", (ng,), h2h_bias_initializer)):
            setattr(self, name, _param(name, shape, dev, init, generator))
        self._i2h = functools.partial(FNN.conv, stride=1,
                                      dilate=self._i2h_dilate,
                                      pad=self._i2h_pad)
        self._h2h = functools.partial(FNN.conv, stride=1,
                                      dilate=self._h2h_dilate,
                                      pad=self._h2h_pad)

    @property
    def _state_spatial(self):
        """The state's spatial shape: the i2h convolution's output shape
        over ``input_shape`` (stride 1)."""
        return tuple(x + 2 * p - d * (k - 1)
                     for x, k, p, d in zip(self._input_shape[1:],
                                           self._i2h_kernel, self._i2h_pad,
                                           self._i2h_dilate))

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._state_spatial
        return [{"shape": shape, "__layout__": "NC" + "DHW"[3 - self._dims:]}]

    def _convs(self, x, h):
        i2h = invoke("convolution", self._i2h, x, self.i2h_weight,
                     self.i2h_bias)
        h2h = invoke("convolution", self._h2h, h, self.h2h_weight,
                     self.h2h_bias)
        return i2h, h2h

    def _act(self, x):
        return activation(x, self._activation)

    def extra_repr(self):
        return (f"{self._input_shape} -> {self._hidden_channels}, "
                f"i2h_kernel={self._i2h_kernel}, "
                f"h2h_kernel={self._h2h_kernel}")


class _ConvRNNCell(_BaseConvRNNCell):
    _gates = 1

    def forward(self, inputs, states):
        i2h, h2h = self._convs(inputs, states[0])
        out = self._act(i2h + h2h)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    """Convolutional LSTM (Shi et al. 2015), gate order [i, f, g, o]."""

    _gates = 4

    def state_info(self, batch_size=0):
        info = super().state_info(batch_size)[0]
        return [dict(info), dict(info)]

    def forward(self, inputs, states):
        h, c = states
        i2h, h2h = self._convs(inputs, h)
        i, f, g, o = (i2h + h2h).chunk(4, dim=1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * self._act(g)
        h_new = torch.sigmoid(o) * self._act(c_new)
        return h_new, [h_new, c_new]


class _ConvGRUCell(_BaseConvRNNCell):
    _gates = 3

    def forward(self, inputs, states):
        h = states[0]
        i2h, h2h = self._convs(inputs, h)
        xr, xz, xn = i2h.chunk(3, dim=1)
        hr, hz, hn = h2h.chunk(3, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = self._act(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        return h_new, [h_new]


class _DimCell:
    """The public cells' number of spatial axes and default layout."""

    _dims = 2
    _layout = "NCHW"

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout=None, activation="tanh", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            input_shape, hidden_channels, i2h_kernel, h2h_kernel, i2h_pad,
            i2h_dilate, h2h_dilate,
            i2h_weight_initializer=i2h_weight_initializer,
            h2h_weight_initializer=h2h_weight_initializer,
            i2h_bias_initializer=i2h_bias_initializer,
            h2h_bias_initializer=h2h_bias_initializer, dims=self._dims,
            conv_layout=self._layout if conv_layout is None else conv_layout,
            activation=activation, device=device, generator=generator)


class Conv1DRNNCell(_DimCell, _ConvRNNCell):
    _dims, _layout = 1, "NCW"


class Conv2DRNNCell(_DimCell, _ConvRNNCell):
    _dims, _layout = 2, "NCHW"


class Conv3DRNNCell(_DimCell, _ConvRNNCell):
    _dims, _layout = 3, "NCDHW"


class Conv1DLSTMCell(_DimCell, _ConvLSTMCell):
    _dims, _layout = 1, "NCW"


class Conv2DLSTMCell(_DimCell, _ConvLSTMCell):
    _dims, _layout = 2, "NCHW"


class Conv3DLSTMCell(_DimCell, _ConvLSTMCell):
    _dims, _layout = 3, "NCDHW"


class Conv1DGRUCell(_DimCell, _ConvGRUCell):
    _dims, _layout = 1, "NCW"


class Conv2DGRUCell(_DimCell, _ConvGRUCell):
    _dims, _layout = 2, "NCHW"


class Conv3DGRUCell(_DimCell, _ConvGRUCell):
    _dims, _layout = 3, "NCDHW"
