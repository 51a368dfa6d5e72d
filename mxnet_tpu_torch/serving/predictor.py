"""Bucketed inference (counterpart of ``mxnet_tpu/serving/predictor.py``).

``CompiledPredictor`` runs a whole forward pass per call, on one device,
in ``eval()`` mode under ``torch.inference_mode()``. The leading batch
dimension is quantised to ``bucket_sizes``: :meth:`bucket_for` and
:meth:`pad_to_bucket` pad a partial batch with zero rows up to the next
bucket, so concurrent requests of any size run a handful of shapes. The
JAX package compiles one XLA program per bucket; PyTorch runs eagerly,
so here :attr:`n_traces` counts the distinct bucket shapes run, and
:meth:`warmup` runs each bucket once before traffic arrives.
:meth:`predict` returns the net's outputs on the device without waiting
for them. :func:`predictor_for` builds one at a serving precision
(float32, or bfloat16 through ``amp.convert_hybrid_block``).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["CompiledPredictor", "DEFAULT_BUCKETS", "map_tensors",
           "predictor_for", "synchronize"]

#: default leading-dim shape buckets: powers of two up to 64
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

_ARRAY_TYPES = (torch.Tensor, np.ndarray)


def _is_batched(leaf) -> bool:
    return isinstance(leaf, _ARRAY_TYPES) and leaf.ndim >= 1


def pad_rows(leaf, bucket: int):
    """Zero-pad a leaf's leading dim up to ``bucket`` rows."""
    n = int(leaf.shape[0])
    if n == bucket:
        return leaf
    if isinstance(leaf, np.ndarray):
        pad = np.zeros((bucket - n,) + leaf.shape[1:], leaf.dtype)
        return np.concatenate([leaf, pad], axis=0)
    pad = leaf.new_zeros((bucket - n,) + tuple(leaf.shape[1:]))
    return torch.cat([leaf, pad], dim=0)


def map_tensors(fn, out):
    """Apply ``fn`` to every tensor of a nested tuple/list/dict output."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (tuple, list)):
        return type(out)(map_tensors(fn, o) for o in out)
    if isinstance(out, dict):
        return {k: map_tensors(fn, v) for k, v in out.items()}
    return out


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CompiledPredictor:
    """One callable = the whole forward pass, per shape bucket.

        pred = CompiledPredictor(net)          # cuda:0 unless device="cpu"
        pred.warmup(example_row)               # run every bucket once
        out = pred.predict(*pred.pad_to_bucket(x)[0])
    """

    def __init__(self, net: torch.nn.Module,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 device=None):
        sizes = tuple(sorted({int(b) for b in
                              (bucket_sizes or DEFAULT_BUCKETS)}))
        if not sizes or sizes[0] < 1:
            raise MXNetError("bucket_sizes must be positive integers, "
                             f"got {bucket_sizes!r}")
        self.device = resolve_device(device)
        self.bucket_sizes = sizes
        self._net = net.to(self.device).eval()
        self._shapes = set()
        #: measured time of one micro-batch of the largest bucket, from
        #: :meth:`warmup`; None until warmup ran
        self.service_time_seed_s: Optional[float] = None

    @property
    def net(self) -> torch.nn.Module:
        return self._net

    @property
    def n_traces(self) -> int:
        """Distinct input shapes (buckets) run so far."""
        return len(self._shapes)

    # ---------------- bucketing ----------------
    def bucket_for(self, rows: int) -> int:
        """Smallest configured bucket >= ``rows``."""
        for b in self.bucket_sizes:
            if rows <= b:
                return b
        raise MXNetError(
            f"request of {rows} rows exceeds the largest shape bucket "
            f"({self.bucket_sizes[-1]}); raise bucket_sizes= or split "
            "the request")

    def pad_to_bucket(self, *args):
        """Pad every array argument's leading dim up to the next bucket.
        Returns ``(padded_args, rows)``: ``rows`` is the valid-row count;
        outputs beyond it are padding and must be sliced away."""
        batched = [a for a in args if _is_batched(a)]
        if not batched:
            raise MXNetError("pad_to_bucket: no array argument with a "
                             "leading batch dim")
        rows = int(batched[0].shape[0])
        bucket = self.bucket_for(rows)
        return tuple(pad_rows(a, bucket) if _is_batched(a) else a
                     for a in args), rows

    # ---------------- call ----------------
    def as_tensor(self, leaf):
        """An array argument as a tensor on this predictor's device."""
        if isinstance(leaf, torch.Tensor):
            return leaf.to(self.device)
        if isinstance(leaf, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(leaf)) \
                .to(self.device)
        return leaf

    def predict(self, *args, **kwargs):
        """Run one (bucket-shaped) batch; returns the net's outputs on the
        device, without waiting for the device to finish them."""
        args = tuple(self.as_tensor(a) for a in args)
        kwargs = {k: self.as_tensor(v) for k, v in kwargs.items()}
        self._shapes.add(tuple(
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
            for a in args + tuple(kwargs[k] for k in sorted(kwargs))))
        with torch.inference_mode():
            return self._net(*args, **kwargs)

    __call__ = predict

    def warmup(self, *example, buckets: Optional[Sequence[int]] = None
               ) -> Dict[int, float]:
        """Run every bucket once from one example request (a one-row
        batch), then time one more run of the largest bucket into
        :attr:`service_time_seed_s`. Returns {bucket: seconds of its
        first run}."""
        out = {}
        padded = None
        for b in (buckets or self.bucket_sizes):
            padded = tuple(pad_rows(a, b) if _is_batched(a) else a
                           for a in example)
            t0 = time.perf_counter()
            self.predict(*padded)
            synchronize(self.device)
            out[b] = time.perf_counter() - t0
        if padded is not None:
            t0 = time.perf_counter()
            self.predict(*padded)
            synchronize(self.device)
            self.service_time_seed_s = time.perf_counter() - t0
        return out


def predictor_for(net, dtype: str = "float32",
                  bucket_sizes: Optional[Sequence[int]] = None,
                  **kwargs) -> CompiledPredictor:
    """A :class:`CompiledPredictor` at the requested serving precision
    (``mxnet_tpu/serving/predictor.py`` ``predictor_for``):

    - ``float32``/``fp32``/``f32``: the net as it is;
    - ``bfloat16``/``bf16``/``float16``/``fp16``:
      ``amp.convert_hybrid_block`` casts every parameter not owned by a
      ``LayerNorm`` down (the LayerNorms stay float32);
    - ``int8``: raises, ``contrib.quantization`` is not ported.

    The conversion changes ``net`` in place; pass a copy to keep a
    float32 original. ``kwargs`` go to :class:`CompiledPredictor`
    (``device``)."""
    d = dtype.lower()
    if d in ("float32", "fp32", "f32"):
        pass
    elif d in ("bfloat16", "bf16", "float16", "fp16"):
        from .. import amp as _amp
        _amp.convert_hybrid_block(
            net, "bfloat16" if d.startswith("b") else "float16")
    elif d == "int8":
        raise MXNetError("int8 serving needs contrib.quantization, which "
                         "the port does not have")
    else:
        raise MXNetError(f"unknown serving dtype {dtype!r} (float32, "
                         "bfloat16, float16, int8)")
    return CompiledPredictor(net, bucket_sizes=bucket_sizes, **kwargs)
