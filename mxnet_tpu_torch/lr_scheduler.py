"""Learning-rate schedulers (counterpart of ``mxnet_tpu/lr_scheduler.py``).

A scheduler maps the optimizer's update count to a learning rate; every
scheduler but :class:`LinearWarmUp` takes ``warmup_steps`` with a
``"linear"`` or ``"constant"`` warmup from ``warmup_begin_lr``. Plain host
arithmetic: nothing here touches a device.
"""
from __future__ import annotations

import math

from .base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "LinearWarmUp"]


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update: int) -> float:
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) * \
                num_update / max(self.warmup_steps, 1)
            return self.warmup_begin_lr + inc
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        raise MXNetError(f"bad warmup_mode {self.warmup_mode}")

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates, never below
    ``stop_factor_lr``."""

    def __init__(self, step: int, factor: float = 1.0, stop_factor_lr=1e-8,
                 base_lr=0.01, **kwargs):
        super().__init__(base_lr, **kwargs)
        if step < 1:
            raise MXNetError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        n = (num_update - self.warmup_steps) // self.step
        lr = self.base_lr * (self.factor ** n)
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each update count in ``step``."""

    def __init__(self, step, factor=1.0, base_lr=0.01, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.step = sorted(step)
        self.factor = factor

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr
        for s in self.step:
            if num_update >= s:
                lr *= self.factor
        return lr


class PolyScheduler(LRScheduler):
    """Polynomial decay of power ``pwr`` to ``final_lr`` at
    ``max_update``."""

    def __init__(self, max_update: int, base_lr=0.01, pwr=2, final_lr=0,
                 **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / max(self.max_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 - frac) ** self.power


class CosineScheduler(LRScheduler):
    """Half-cosine decay to ``final_lr`` at ``max_update``."""

    def __init__(self, max_update: int, base_lr=0.01, final_lr=0, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / max(self.max_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 + math.cos(math.pi * frac)) / 2


class LinearWarmUp(LRScheduler):
    """Wrap another scheduler with a linear warmup from ``start_lr`` over
    ``length`` updates."""

    def __init__(self, schedule: LRScheduler, start_lr: float, length: int):
        super().__init__(schedule.base_lr)
        self.schedule = schedule
        self.start_lr = start_lr
        self.length = length

    def __call__(self, num_update: int) -> float:
        if num_update < self.length:
            return self.start_lr + (self.schedule(self.length)
                                    - self.start_lr) \
                * num_update / max(self.length, 1)
        return self.schedule(num_update)
