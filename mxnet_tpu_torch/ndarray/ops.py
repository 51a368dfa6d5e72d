"""Sequence ops (counterpart of ``SequenceMask`` and ``SequenceReverse``
in ``mxnet_tpu/ndarray/ops.py``; the port has only these two of that
module so far).

Both take a ``(T, N, ...)`` tensor and a ``sequence_length`` of shape
``(N,)`` (integer or float), and run through the op funnel
(``ops/registry.py``) as ``"sequence_mask"`` / ``"sequence_reverse"``,
the JAX package's names. Without ``use_sequence_length`` (or without a
``sequence_length``) ``SequenceMask`` returns its input and
``SequenceReverse`` flips the whole time axis, as there.
"""
from __future__ import annotations

import torch

from ..ops.registry import invoke

__all__ = ["SequenceMask", "sequence_mask", "SequenceReverse"]


def SequenceMask(data, sequence_length=None, use_sequence_length=False,
                 value=0.0, axis=0):
    """``data`` with every position at or past its sequence's length set
    to ``value``. ``axis`` is the time axis (0 or 1); the batch axis is
    the other of the two."""
    if not use_sequence_length or sequence_length is None:
        return data

    def fn(x, sl):
        t = x.shape[axis]
        shape = [1] * x.ndim
        shape[axis] = t
        pos = torch.arange(t, device=x.device).reshape(shape)
        batch_axis = 1 - axis if axis in (0, 1) else 0
        slshape = [1] * x.ndim
        slshape[batch_axis] = x.shape[batch_axis]
        mask = pos < sl.to(x.device).reshape(slshape)
        return torch.where(mask, x, torch.as_tensor(value, dtype=x.dtype,
                                                    device=x.device))

    return invoke("sequence_mask", fn, data, sequence_length)


sequence_mask = SequenceMask


def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0):
    """The first ``length`` steps of each sequence in reverse order (time
    axis 0, batch axis 1); the positions past a sequence's length stay
    where they are. ``axis`` is taken, as in the JAX package, and the
    time axis is 0 whatever it says."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))

    def fn(x, sl):
        t = x.shape[0]
        pos = torch.arange(t, device=x.device)[:, None]
        sl_i = sl.to(x.device).to(torch.long)[None, :]
        idx = torch.where(pos < sl_i, sl_i - 1 - pos, pos)
        idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
        return torch.gather(x, 0, idx)

    return invoke("sequence_reverse", fn, data, sequence_length)
