"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv1D/2D/3D``,
``MaxPool1D/2D/3D``, ``AvgPool1D/2D/3D``, ``GlobalMaxPool1D/2D/3D`` and
``GlobalAvgPool1D/2D/3D`` as ``nn.Module``s.

Layouts are NC + spatial (NCW, NCHW, NCDHW), as in the JAX package; a
convolution's weight is ``(channels, in_channels // groups, *kernel)``
and its bias ``(channels,)``. As with ``Dense``, shapes are not inferred
at the first call: ``in_channels`` is required. Each layer runs its op
through the op funnel (``ops/registry.py``) as ``"convolution"``,
``"pooling"`` or ``"global_pool"``, the names under which ``amp`` casts
them. The transposed convolutions and ``ReflectionPad2D`` are not
ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as FNN
from ...ops.registry import invoke
from .basic_layers import _param, activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _check_layout(layout: Optional[str]) -> None:
    if layout is not None and not layout.startswith("NC"):
        raise MXNetError(f"only NC-leading layouts are supported, got "
                         f"{layout}")


class _Conv(nn.Module):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels, activation, use_bias, ndim,
                 device, generator, weight_initializer, bias_initializer):
        super().__init__()
        _check_layout(layout)
        if in_channels <= 0:
            raise MXNetError(f"Conv{ndim}D needs in_channels (shapes are "
                             "not inferred at the first call)")
        if in_channels % groups or channels % groups:
            raise MXNetError(f"Conv{ndim}D: in_channels {in_channels} and "
                             f"channels {channels} must divide by groups "
                             f"{groups}")
        dev = resolve_device(device)
        self._kernel = FNN._tup(kernel_size, ndim)
        self._strides = FNN._tup(strides, ndim)
        self._padding = FNN._tup(padding, ndim)
        self._dilation = FNN._tup(dilation, ndim)
        self._groups = groups
        self._activation = activation
        self.weight = _param("weight", (channels, in_channels // groups)
                             + self._kernel, dev, weight_initializer,
                             generator)
        self.bias = _param("bias", (channels,), dev, bias_initializer,
                           generator) if use_bias else None

    def forward(self, x):
        args = (x, self.weight) if self.bias is None \
            else (x, self.weight, self.bias)
        out = invoke("convolution", self._conv, *args)
        if self._activation:
            out = activation(out, self._activation)
        return out

    def _conv(self, x, w, b=None):
        return FNN.conv(x, w, b, self._strides, self._dilation,
                        self._padding, self._groups)

    def extra_repr(self):
        w = self.weight.shape
        return (f"{w[1] * self._groups} -> {w[0]}, kernel={self._kernel}, "
                f"stride={self._strides}, padding={self._padding}"
                + (f", groups={self._groups}" if self._groups > 1 else ""))


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", in_channels=0,
                 activation=None, use_bias=True, device=None,
                 generator: Optional[torch.Generator] = None,
                 weight_initializer=None, bias_initializer="zeros"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         1, device, generator, weight_initializer,
                         bias_initializer)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", in_channels=0,
                 activation=None, use_bias=True, device=None,
                 generator: Optional[torch.Generator] = None,
                 weight_initializer=None, bias_initializer="zeros"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         2, device, generator, weight_initializer,
                         bias_initializer)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", in_channels=0, activation=None,
                 use_bias=True, device=None,
                 generator: Optional[torch.Generator] = None,
                 weight_initializer=None, bias_initializer="zeros"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         3, device, generator, weight_initializer,
                         bias_initializer)


class _Pool(nn.Module):
    def __init__(self, pool_size, strides, padding, pool_type, ndim,
                 layout, count_include_pad=True, ceil_mode=False):
        super().__init__()
        _check_layout(layout)
        self._kernel = FNN._tup(pool_size, ndim)
        self._strides = FNN._tup(strides if strides is not None else pool_size,
                             ndim)
        self._padding = FNN._tup(padding, ndim)
        self._pool_type = pool_type
        self._cip = count_include_pad
        self._ceil = ceil_mode

    def forward(self, x):
        return invoke("pooling", self._pool, x)

    def _pool(self, x):
        return FNN.pool(x, self._kernel, self._pool_type, self._strides,
                        self._padding, self._cip, self._ceil)

    def extra_repr(self):
        return (f"{self._pool_type}, size={self._kernel}, "
                f"stride={self._strides}, padding={self._padding}"
                + (", ceil_mode" if self._ceil else ""))


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(pool_size, strides, padding, "max", 1, layout,
                         ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, "max", 2, layout,
                         ceil_mode=ceil_mode)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, "max", 3, layout,
                         ceil_mode=ceil_mode)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, "avg", 1, layout,
                         count_include_pad, ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, "avg", 2, layout,
                         count_include_pad, ceil_mode)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, "avg", 3, layout,
                         count_include_pad, ceil_mode)


class _GlobalPool(nn.Module):
    def __init__(self, pool_type, ndim, layout):
        super().__init__()
        _check_layout(layout)
        self._pool_type = pool_type

    def forward(self, x):
        return invoke("global_pool", self._pool, x)

    def _pool(self, x):
        return FNN.global_pool(x, self._pool_type)

    def extra_repr(self):
        return self._pool_type


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW"):
        super().__init__("max", 1, layout)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW"):
        super().__init__("max", 2, layout)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW"):
        super().__init__("max", 3, layout)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW"):
        super().__init__("avg", 1, layout)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW"):
        super().__init__("avg", 2, layout)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW"):
        super().__init__("avg", 3, layout)
