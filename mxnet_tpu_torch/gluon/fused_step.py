"""The whole training step as one callable (counterpart of
``mxnet_tpu/gluon/fused_step.py``, single device).

``Trainer.compile_step(loss_fn)`` returns a :class:`CompiledTrainStep`.
Each call runs ``loss_fn(*batch)`` (the forward, returning a per-sample
loss), the backward of the loss's SUM (what ``loss.backward()`` seeds
with ones), and ``trainer.step(batch_size)`` with ``batch_size`` taken
from the leading axis of the first batched argument. It returns the
per-sample loss, detached, without waiting for the device.

The JAX package traces this into one XLA program; PyTorch runs eagerly,
so here the step is the same three phases in order. Dropout follows the
modules' own ``train()`` / ``eval()`` mode. The ZeRO sharded update, the
``TrainLoop`` and its in-flight window are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["CompiledTrainStep"]


def _infer_batch_size(leaves) -> int:
    for leaf in leaves:
        if getattr(leaf, "ndim", 0) >= 1:
            return int(leaf.shape[0])
    return 1


class CompiledTrainStep:
    """One callable = forward + backward + update. Built by
    ``Trainer.compile_step(loss_fn)``."""

    def __init__(self, trainer, loss_fn: Callable):
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._device = trainer._params[0].device if trainer._params \
            else torch.device("cpu")
        self._steps_done = 0

    @property
    def steps_done(self) -> int:
        return self._steps_done

    def _as_tensor(self, leaf):
        """numpy batches move to the parameters' device."""
        if isinstance(leaf, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(leaf)) \
                .to(self._device)
        return leaf

    def __call__(self, *args, batch_size: Optional[int] = None, **kwargs):
        args = tuple(self._as_tensor(a) for a in args)
        kwargs = {k: self._as_tensor(v) for k, v in kwargs.items()}
        loss = self._loss_fn(*args, **kwargs)
        loss.sum().backward()
        if batch_size is None:
            batch_size = _infer_batch_size(list(args) + list(kwargs.values()))
        self._trainer.step(batch_size)
        self._steps_done += 1
        return loss.detach()

    step = __call__
