"""Batchify functions (counterpart of ``mxnet_tpu/gluon/data/
batchify.py``): a list of samples in, one batch out, as CPU tensors.

A float64 result is narrowed to float32 (the arrays' default type, as
the JAX package's ``NDArray`` narrows it); other types are kept. The JAX
package's native parallel copy becomes ``torch.stack`` (for tensors) or
``numpy.stack``: the values are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ...host import to_numpy, to_tensor

__all__ = ["Stack", "Pad", "Group", "ImageNormalize"]


class Stack:
    """Stack samples along a new batch axis."""

    def __call__(self, data):
        if all(isinstance(d, torch.Tensor) for d in data):
            return to_tensor(torch.stack([d.detach().cpu() for d in data]))
        return to_tensor(np.stack([to_numpy(d) for d in data]))


class Pad:
    """Pad samples with ``val`` along ``axis`` to the batch's longest,
    then stack (cast to ``dtype`` when given)."""

    def __init__(self, axis=0, val=0, dtype=None):
        self._axis = axis
        self._val = val
        self._dtype = dtype

    def __call__(self, data):
        arrs = [to_numpy(d) for d in data]
        max_len = max(a.shape[self._axis] for a in arrs)
        padded = []
        for a in arrs:
            pad_width = [(0, 0)] * a.ndim
            pad_width[self._axis] = (0, max_len - a.shape[self._axis])
            padded.append(np.pad(a, pad_width, constant_values=self._val))
        out = np.stack(padded)
        if self._dtype:
            out = out.astype(self._dtype)
        return to_tensor(out)


class Group:
    """One batchify function a field of tuple samples."""

    def __init__(self, *fns):
        self._fns = fns

    def __call__(self, data):
        return tuple(fn([d[i] for d in data])
                     for i, fn in enumerate(self._fns))


class ImageNormalize:
    """HWC uint8 images to a normalized NCHW float32 batch:
    ``out[n, c, h, w] = (img[n, h, w, c] / 255 - mean[c]) / std[c]``,
    in the float32 operations of the JAX package's numpy path."""

    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
        self._mean = np.asarray(mean, "float32")
        self._std = np.asarray(std, "float32")

    def __call__(self, data):
        arrs = [to_numpy(d) for d in data]
        if any(a.ndim != 3 or a.dtype != np.uint8 for a in arrs):
            raise ValueError("ImageNormalize expects HWC uint8 samples")
        c = arrs[0].shape[2]
        if self._mean.shape[0] != c or self._std.shape[0] != c:
            raise ValueError(
                f"mean has {self._mean.shape[0]} and std has "
                f"{self._std.shape[0]} channels, images have {c}")
        batch = np.stack(arrs).astype("float32") / 255.0
        batch = (batch - self._mean) / self._std
        return to_tensor(batch.transpose(0, 3, 1, 2))
