"""Gradient compression with error feedback (counterpart of
``mxnet_tpu/parallel/compression.py``).

What a store applies to each gradient before it is summed across the
workers (``kvstore.KVStore.set_gradient_compression``): the residual of
the last round is added, the sum is quantized (what the wire would
carry), and what the quantization lost is kept as the next residual.
Types: ``"2bit"`` (+threshold, 0, -threshold), ``"1bit"`` (+threshold
or -threshold by sign), ``"fp16"`` and ``"bf16"`` (a round trip through
the narrower float). The JAX package jits the same elementwise
function; here it is a few PyTorch elementwise ops on the gradient's
device, with the same roundings, so both packages compress bit for bit
alike.
"""
from __future__ import annotations

from typing import Dict, Hashable, Optional

import torch

from ..base import MXNetError

__all__ = ["GradientCompression"]

TYPES = ("2bit", "1bit", "fp16", "bf16")


class GradientCompression:
    """``type`` one of :data:`TYPES`; ``threshold`` the quantization
    level of the bit types."""

    def __init__(self, type: str = "2bit", threshold: float = 0.5):  # noqa: A002
        if type not in TYPES:
            raise MXNetError(f"unsupported compression type {type!r}")
        self.type = type
        self.threshold = float(threshold)
        self._residuals: Dict[Hashable, torch.Tensor] = {}

    def _quantize(self, g: torch.Tensor) -> torch.Tensor:
        if self.type == "fp16":
            return g.to(torch.float16).to(g.dtype)
        if self.type == "bf16":
            return g.to(torch.bfloat16).to(g.dtype)
        # the threshold in g's dtype, as the JAX package's weak scalar
        t = torch.tensor(self.threshold, dtype=g.dtype, device=g.device)
        if self.type == "1bit":
            return torch.where(g >= 0, t, -t)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return torch.where(g >= t, t, torch.where(g <= -t, -t, zero))

    @torch.no_grad()
    def compress_decompress(self, grad: torch.Tensor,
                            key: Optional[Hashable] = None) -> torch.Tensor:
        """The quantized gradient (a new tensor) after adding the
        residual kept under ``key``, whose new residual is what the
        quantization lost. A store keys residuals by ``(str(key), replica
        index)``: a buffer's identity changes every step and ids are
        reused after collection. ``key=None`` falls back to ``id(grad)``
        for direct callers, as the JAX package does."""
        if key is None:
            key = id(grad)
        res = self._residuals.get(key)
        if res is None or res.shape != grad.shape:
            res = torch.zeros_like(grad)
        g = grad + res
        q = self._quantize(g)
        self._residuals[key] = g - q
        return q
