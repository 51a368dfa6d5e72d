"""Dynamic loss scaling (counterpart of
``mxnet_tpu/amp/loss_scaler.py``).

Needed for true float16, whose 5-bit exponent underflows gradients; a
no-op for bfloat16, which has float32's exponent range, so ``amp``
starts a bfloat16 run at scale 1.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    """Multiplicative dynamic scaler: halve on overflow, double after
    ``scale_window`` clean steps."""

    def __init__(self, init_scale: float = 2. ** 16, scale_factor: float = 2.,
                 scale_window: int = 2000, min_scale: float = 1.0):
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._min_scale = min_scale
        self._unskipped = 0

    def has_overflow(self, params) -> bool:
        """True if any gradient is not finite. ``params`` holds
        parameters (their ``.grad`` is checked) or gradient tensors. The
        check runs on the gradients' device and brings one flag back to
        the host: one sync for all of them."""
        flags = []
        for p in params:
            g = p.grad if isinstance(p, torch.nn.Parameter) else p
            if g is not None:
                flags.append(torch.logical_not(torch.isfinite(g)).any())
        if not flags:
            return False
        return bool(torch.stack(flags).any())

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self._min_scale,
                                  self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
