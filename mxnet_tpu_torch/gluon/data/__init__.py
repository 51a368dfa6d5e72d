"""Data loading for training (counterpart of ``mxnet_tpu/gluon/data``):
so far the device prefetcher (:mod:`.prefetcher`), which
``TrainLoop.prefetch`` wraps. The JAX package's datasets, samplers and
``DataLoader`` are not ported (``ROADMAP.md`` queue 1, item 10)."""
from . import prefetcher
from .prefetcher import DevicePrefetcher, default_prefetch_depth

__all__ = ["prefetcher", "DevicePrefetcher", "default_prefetch_depth"]
