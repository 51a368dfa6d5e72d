"""Devices (counterpart of ``mxnet_tpu/context.py``).

A :class:`Context` names a device: ``gpu(i)`` is ``cuda:i``, ``cpu()``
the host, ``cpu_pinned()`` the host's page-locked memory. Entered with
``with mx.gpu(1):`` it is the default device of the calling thread until
the block ends (:func:`current_context`); :func:`default_device` and
``resolve_device(None)`` honour the innermost such block, so a model
built inside it lands on that card.

Outside any block the default is ``cuda:0``, not the JAX package's
``cpu``: an entry point runs on the card unless the caller asks for the
CPU. There is no fallback: without a CUDA device, :func:`default_device`
raises, and a caller that wants the CPU asks for it with
``device="cpu"`` (or ``with mx.cpu():``).
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["Context", "gpu", "cpu", "cpu_pinned", "current_context",
           "num_gpus", "gpu_memory_info", "default_device",
           "resolve_device"]

_TYPES = ("cpu", "gpu", "cpu_pinned")


def _cuda_index(device_id: int) -> int:
    """``device_id``, checked to name a visible card."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    n = torch.cuda.device_count()
    if not 0 <= device_id < n:
        raise MXNetError(f"gpu({device_id}) requested but only {n} CUDA "
                         "device(s) are visible")
    return device_id


class Context:
    """A device by MXNet's name: ``device_type`` ``gpu``, ``cpu`` or
    ``cpu_pinned`` and ``device_id``. Compares by both. ``with ctx:``
    makes it the calling thread's default device (the previous one comes
    back on exit; blocks nest). :attr:`torch_device` is the
    ``torch.device`` it names (``cpu_pinned`` is the host)."""

    _default_ctx = threading.local()

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type == "cuda":
            device_type = "gpu"
        if device_type not in _TYPES:
            raise MXNetError(f"unknown device type {device_type!r} "
                             f"({', '.join(_TYPES)})")
        if device_type == "gpu":
            _cuda_index(device_id)
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctx: list = []

    @property
    def device_typeid(self) -> int:
        return {"cpu": 1, "gpu": 2, "cpu_pinned": 3}[self.device_type]

    @property
    def torch_device(self) -> torch.device:
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        self._old_ctx.append(getattr(Context._default_ctx, "value", None))
        Context._default_ctx.value = self
        return self

    def __exit__(self, *exc):
        Context._default_ctx.value = self._old_ctx.pop()

    def empty_cache(self):
        """Release the caching allocator's free blocks of this card (a
        no-op for the host)."""
        if self.device_type == "gpu":
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()


def current_context() -> Optional[Context]:
    """The innermost ``with ctx:`` of the calling thread, else None (the
    default device, ``cuda:0``)."""
    return getattr(Context._default_ctx, "value", None)


def gpu(device_id: int = 0) -> Context:
    """The CUDA device ``cuda:<device_id>``; raises when it is absent."""
    return Context("gpu", device_id)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """The host's page-locked memory (tensors for ``non_blocking``
    copies; as a device, the CPU)."""
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    """The CUDA devices this process sees."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu_memory_info(device_id: int = 0):
    """``(free, total)`` bytes of card ``device_id``, as the CUDA
    runtime reports them (MXNet's ``gpu_memory_info``)."""
    with torch.cuda.device(_cuda_index(device_id)):
        return torch.cuda.mem_get_info()


def default_device() -> torch.device:
    """The innermost ``with ctx:`` block's device on the calling thread,
    else ``cuda:0``; raises :class:`MXNetError` when that card is
    absent."""
    ctx = current_context()
    if ctx is not None:
        return ctx.torch_device
    return torch.device("cuda", _cuda_index(0))


DeviceLike = Union[str, torch.device, Context, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given (a CUDA
    one is checked to exist), else :func:`default_device`."""
    if device is None:
        return default_device()
    if isinstance(device, Context):
        return device.torch_device
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type == "cuda":
        return torch.device("cuda", _cuda_index(
            0 if dev.index is None else dev.index))
    raise MXNetError(f"unsupported device {device!r} (cuda or cpu)")
