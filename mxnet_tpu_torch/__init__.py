"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

The port mirrors the JAX package's module layout and names. Plain tensor
code is PyTorch; every Pallas kernel of the JAX package becomes a CUDA
kernel written for Hopper (``ops/kernels/csrc``). Entry points run on
``cuda:0`` unless the caller passes ``device="cpu"``; without a CUDA
device they raise :class:`MXNetError` rather than run on the CPU.
"""
from . import (amp, analysis, checkpoint, elastic, image, init,
               initializer, inspector, io, kvstore, lr_scheduler, metric,
               ndarray, optimizer, parallel, profiler, recordio, telemetry,
               testing)
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context,
                      default_device, gpu, gpu_memory_info, num_gpus,
                      resolve_device)

__all__ = ["MXNetError", "Context", "cpu", "gpu", "cpu_pinned",
           "current_context", "num_gpus", "gpu_memory_info",
           "default_device", "resolve_device",
           "amp", "analysis", "checkpoint", "elastic", "image", "init", "initializer",
           "inspector", "io", "kvstore", "lr_scheduler", "metric",
           "ndarray", "optimizer", "parallel", "profiler", "recordio",
           "telemetry", "testing"]
