"""Contrib layers (counterpart of
``mxnet_tpu/gluon/contrib/nn/basic_layers.py``).

``Concurrent`` / ``HybridConcurrent`` and ``Identity`` are ``gluon.nn``'s
``Concatenate`` / ``HybridConcatenate`` and ``Identity`` under the
contrib names. ``PixelShuffle1D/2D/3D`` are the sub-pixel upsampling of
Shi et al. 2016 (arXiv:1609.05158) as one reshape, one permute and one
reshape. ``SparseEmbedding`` is ``Embedding`` with ``sparse_grad``; its
gradient is dense here (the rows a batch does not touch are zero), which
the updates of SGD and Adam (``lazy_update=False``, their default) treat
as the JAX package's row-sparse gradient; the lazy row updates are not
ported. ``SyncBatchNorm`` is ``gluon.nn``'s: its training statistics
span the ranks of a split batch, as every ``BatchNorm``'s do.
"""
from __future__ import annotations

from torch import nn

from ....base import MXNetError
from ...nn.basic_layers import (Concatenate, Embedding, HybridConcatenate,
                                Identity, SyncBatchNorm)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class Concurrent(Concatenate):
    """Children run on the same input, outputs concatenated on ``axis``."""


class HybridConcurrent(HybridConcatenate):
    """:class:`Concurrent` under the hybridizable name."""


class SparseEmbedding(Embedding):
    """``Embedding`` whose weight's gradient the reference keeps
    row-sparse (module docstring)."""

    def __init__(self, input_dim, output_dim, **kwargs):
        super().__init__(input_dim, output_dim, **kwargs)
        self.sparse_grad = True


def _factors(factor, n):
    try:
        return (int(factor),) * n
    except TypeError:
        f = tuple(int(v) for v in factor)
        if len(f) != n:
            raise MXNetError(f"factor must be an int or {n}-tuple, got "
                             f"{factor!r}") from None
        return f


class PixelShuffle1D(nn.Module):
    """(N, f*C, W) -> (N, C, W*f): channel c*f + j goes to position w*f
    + j."""

    def __init__(self, factor):
        super().__init__()
        self._factor = int(factor)

    def forward(self, x):
        f = self._factor
        n, fc, w = x.shape
        c = fc // f
        return x.reshape(n, c, f, w).permute(0, 1, 3, 2) \
            .reshape(n, c, w * f)

    def extra_repr(self):
        return str(self._factor)


class PixelShuffle2D(nn.Module):
    """(N, f1*f2*C, H, W) -> (N, C, H*f1, W*f2)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 2)

    def forward(self, x):
        f1, f2 = self._factors
        n, c_in, h, w = x.shape
        c = c_in // (f1 * f2)
        return x.reshape(n, c, f1, f2, h, w).permute(0, 1, 4, 2, 5, 3) \
            .reshape(n, c, h * f1, w * f2)

    def extra_repr(self):
        return str(self._factors)


class PixelShuffle3D(nn.Module):
    """(N, f1*f2*f3*C, D, H, W) -> (N, C, D*f1, H*f2, W*f3)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 3)

    def forward(self, x):
        f1, f2, f3 = self._factors
        n, c_in, d, h, w = x.shape
        c = c_in // (f1 * f2 * f3)
        return x.reshape(n, c, f1, f2, f3, d, h, w) \
            .permute(0, 1, 5, 2, 6, 3, 7, 4) \
            .reshape(n, c, d * f1, h * f2, w * f3)

    def extra_repr(self):
        return str(self._factors)
