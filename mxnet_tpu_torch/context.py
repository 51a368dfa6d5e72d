"""Devices (counterpart of ``mxnet_tpu/context.py``).

The default device is ``cuda:0``. There is no fallback: without a CUDA
device, :func:`default_device` raises, and a caller that wants the CPU
asks for it with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

from .base import MXNetError

__all__ = ["gpu", "cpu", "default_device", "resolve_device"]

DeviceLike = Union[str, torch.device, None]


def gpu(device_id: int = 0) -> torch.device:
    """The CUDA device ``cuda:<device_id>``; raises when it is absent."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    n = torch.cuda.device_count()
    if not 0 <= device_id < n:
        raise MXNetError(f"gpu({device_id}) requested but only {n} CUDA "
                         "device(s) are visible")
    return torch.device("cuda", device_id)


def cpu() -> torch.device:
    return torch.device("cpu")


def default_device() -> torch.device:
    """``cuda:0``; raises :class:`MXNetError` when CUDA is absent."""
    return gpu(0)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given (a CUDA
    one is checked to exist), else :func:`default_device`."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cpu":
        return cpu()
    if dev.type == "cuda":
        return gpu(0 if dev.index is None else dev.index)
    raise MXNetError(f"unsupported device {device!r} (cuda or cpu)")
