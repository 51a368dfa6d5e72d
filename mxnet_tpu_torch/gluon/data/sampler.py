"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``): the
order in which a loader reads a dataset's indices, and its batches.
:class:`RandomSampler` draws ``numpy.random.permutation`` from numpy's
global generator, as the JAX package does, so the same seed gives the
same order in both."""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """``start``, ``start + 1``, ... (``length`` indices)."""

    def __init__(self, length: int, start: int = 0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A fresh permutation of ``range(length)`` each pass."""

    def __init__(self, length: int):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    """The indices whose sample ``fn`` accepts."""

    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class IntervalSampler(Sampler):
    """``0, interval, 2 * interval, ...``; with ``rollover`` then ``1,
    1 + interval, ...`` and so on (the word LM's batchified stream)."""

    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else [0]
        for s in starts:
            yield from range(s, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices from ``sampler``. The last,
    shorter list is kept (``"keep"``), dropped (``"discard"``) or
    carried to the front of the next pass (``"rollover"``)."""

    def __init__(self, sampler: Sampler, batch_size: int,
                 last_batch: str = "keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    f"last_batch must be keep/discard/rollover, "
                    f"got {self._last_batch}")

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._prev)) // self._batch_size
