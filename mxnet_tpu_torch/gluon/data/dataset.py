"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``).

A sample is whatever ``__getitem__`` returns: numpy arrays, CPU tensors
(the port's arrays), numbers, or tuples of them. ``filter``, ``shard``
and ``take`` build a :class:`SimpleDataset` at once; ``transform`` and
``transform_first`` apply their function when a sample is read, unless
``lazy=False``.
"""
from __future__ import annotations

import os
from typing import Callable, Sequence

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """A sized collection of samples read by index."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn: Callable) -> "SimpleDataset":
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def shard(self, num_shards: int, index: int) -> "SimpleDataset":
        return SimpleDataset([self[i]
                              for i in range(index, len(self), num_shards)])

    def take(self, count: int) -> "SimpleDataset":
        return SimpleDataset([self[i]
                              for i in range(min(count, len(self)))])

    def transform(self, fn: Callable, lazy: bool = True) -> "Dataset":
        """``fn`` over each sample (a tuple sample is passed unpacked)."""
        t = _LazyTransformDataset(self, fn)
        if lazy:
            return t
        return SimpleDataset([t[i] for i in range(len(t))])

    def transform_first(self, fn: Callable, lazy: bool = True) -> "Dataset":
        """``fn`` over the first field of each sample only."""
        def first(*items):
            if len(items) == 1:
                return fn(items[0])
            return (fn(items[0]),) + items[1:]
        return self.transform(first, lazy)


class _LazyTransformDataset(Dataset):
    def __init__(self, dataset: Dataset, fn: Callable):
        self._dataset = dataset
        self._fn = fn

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, idx):
        item = self._dataset[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    """A dataset over any sequence."""

    def __init__(self, data: Sequence):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Equal-length arrays zipped: sample ``i`` is the tuple of their
    ``i``-th rows (the row itself for one array)."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        for a in args:
            if len(a) != self._length:
                raise MXNetError("all arrays must have the same length")
        self._data = list(args)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """The records of a RecordIO file, in its index's order (the index
    is the file's name with ``.idx`` for its extension); a sample is
    one record's bytes."""

    def __init__(self, filename: str):
        from ... import recordio
        self._filename = filename
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
