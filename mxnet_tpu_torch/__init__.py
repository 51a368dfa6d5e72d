"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

The port mirrors the JAX package's module layout and names. Plain tensor
code is PyTorch; every Pallas kernel of the JAX package becomes a CUDA
kernel written for Hopper (``ops/kernels/csrc``). Entry points run on
``cuda:0`` unless the caller passes ``device="cpu"``; without a CUDA
device they raise :class:`MXNetError` rather than run on the CPU.
"""
from . import (amp, checkpoint, elastic, init, initializer, kvstore,
               lr_scheduler, metric, ndarray, optimizer, parallel, testing)
from .base import MXNetError
from .context import cpu, default_device, gpu, resolve_device

__all__ = ["MXNetError", "cpu", "gpu", "default_device", "resolve_device",
           "amp", "checkpoint", "elastic", "init", "initializer", "kvstore",
           "lr_scheduler", "metric", "ndarray", "optimizer", "parallel",
           "testing"]
