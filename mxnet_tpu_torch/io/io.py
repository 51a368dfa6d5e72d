"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``, MXNet's
``io/io.py`` and its C++ ``CSVIter`` / ``ImageRecordIter``).

Arrays of a batch are CPU tensors (float64 narrowed to float32).
``PrefetchingIter`` and ``ImageRecordIter`` read ahead on a thread of
their own: the iterator's batches, or ``prefetch_buffer`` records, in a
bounded queue (the JAX package's ``ImageRecordIter`` reads through its
native prefetch thread). ``ImageRecordIter`` decodes and augments on the
consumer's thread; its mirror draws ``numpy.random.rand()`` a record, as
the JAX one does.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import List, Optional

import numpy as np

from .. import recordio
from ..base import MXNetError
from ..host import numpy_random, to_numpy, to_tensor

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "ResizeIter", "PrefetchingIter", "ImageRecordIter", "MXDataIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """A named shape, with ``dtype`` and ``layout`` attributes."""

    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        self = super().__new__(cls, name, tuple(shape))
        self.dtype = dtype
        self.layout = layout
        return self


class DataBatch:
    """One batch: lists of data and label arrays, ``pad`` (rows at the
    end that repeat others) and the descriptors."""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """The iterator protocol: ``next`` (raises ``StopIteration`` at the
    end), ``reset``, and the descriptors."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        raise NotImplementedError

    def __next__(self):
        return self.next()

    @property
    def provide_data(self) -> List[DataDesc]:
        return []

    @property
    def provide_label(self) -> List[DataDesc]:
        return []


class NDArrayIter(DataIter):
    """Batches of in-memory arrays (an array, a list or a dict of them),
    optionally shuffled (``numpy.random.shuffle`` at each reset). A
    short last batch is padded from the front (``"pad"``), dropped
    (``"discard"``) or filled from the front as well (``"roll_over"``,
    as the JAX package does)."""

    def __init__(self, data, label=None, batch_size: int = 1,
                 shuffle: bool = False, last_batch_handle: str = "pad",
                 data_name: str = "data", label_name: str = "softmax_label"):
        super().__init__(batch_size)
        self.data = self._canonize(data, data_name)
        self.label = self._canonize(label, label_name) if label is not None \
            else []
        self.shuffle = shuffle
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError("last_batch_handle must be pad/discard/roll_over")
        self.last_batch_handle = last_batch_handle
        self.num_data = self.data[0][1].shape[0]
        self._idx = np.arange(self.num_data)
        self.cursor = 0
        self.reset()

    @staticmethod
    def _canonize(data, default_name):
        if data is None:
            return []
        if isinstance(data, dict):
            return [(k, to_numpy(v)) for k, v in sorted(data.items())]
        if isinstance(data, (list, tuple)):
            return [(f"{default_name}_{i}" if i else default_name,
                     to_numpy(v)) for i, v in enumerate(data)]
        if hasattr(data, "shape"):
            return [(default_name, to_numpy(data))]
        raise MXNetError(f"unsupported data type {type(data)}")

    @property
    def provide_data(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:],
                         dtype=str(a.dtype)) for n, a in self.data]

    @property
    def provide_label(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:],
                         dtype=str(a.dtype)) for n, a in self.label]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self._idx)
        self.cursor = 0

    def next(self) -> DataBatch:
        if self.cursor >= self.num_data:
            raise StopIteration
        end = self.cursor + self.batch_size
        pad = 0
        if end > self.num_data:
            if self.last_batch_handle == "discard":
                raise StopIteration
            pad = end - self.num_data
            idx = np.concatenate([self._idx[self.cursor:], self._idx[:pad]])
        else:
            idx = self._idx[self.cursor:end]
        self.cursor = end
        data = [to_tensor(a[idx]) for _, a in self.data]
        label = [to_tensor(a[idx]) for _, a in self.label]
        return DataBatch(data, label, pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


class CSVIter(DataIter):
    """A float CSV file, each row reshaped to ``data_shape`` (and a
    label CSV beside it); a short last batch is padded when
    ``round_batch``, else dropped."""

    def __init__(self, data_csv: str, data_shape, batch_size: int,
                 label_csv: Optional[str] = None, label_shape=(1,),
                 round_batch: bool = True):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype="float32", ndmin=2)
        self._data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype="float32",
                               ndmin=2).reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(
            self._data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class ResizeIter(DataIter):
    """``size`` batches of ``data_iter`` a pass, restarting it when it
    ends early."""

    def __init__(self, data_iter: DataIter, size: int,
                 reset_internal: bool = True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur >= self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch


_END = object()


class _ReadAhead:
    """A thread calling ``produce()`` into a queue of ``depth`` items
    until it returns ``_END`` or raises (the exception is raised at
    :meth:`get`). :meth:`stop` ends the thread and drops what it
    read."""

    def __init__(self, produce, depth: int, name: str):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._halt = threading.Event()
        self._produce = produce
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._halt.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _loop(self):
        while True:
            try:
                item = self._produce()
            except BaseException as e:   # carried to the consumer
                self._put(e)
                return
            if not self._put(item) or item is _END:
                return

    def get(self):
        item = self._q.get()
        if isinstance(item, BaseException):
            self._q.put(item)            # every later get raises too
            raise item
        if item is _END:
            self._q.put(_END)
        return item

    def stop(self):
        self._halt.set()
        self._thread.join(timeout=5.0)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class PrefetchingIter(DataIter):
    """``iters`` (one iterator, or the first of a list) read ahead on a
    thread, ``prefetch_depth`` batches at most."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth: int = 2):
        it = iters[0] if isinstance(iters, (list, tuple)) else iters
        super().__init__(it.batch_size)
        self.iter = it
        self._depth = prefetch_depth
        self._ahead = None
        self._start()

    def _produce(self):
        try:
            return self.iter.next()
        except StopIteration:
            return _END

    def _start(self):
        self._ahead = _ReadAhead(self._produce, self._depth,
                                 "mxt-prefetching-iter")

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def reset(self):
        self._ahead.stop()
        self.iter.reset()
        self._start()

    def next(self):
        batch = self._ahead.get()
        if batch is _END:
            raise StopIteration
        return batch


class ImageRecordIter(DataIter):
    """Batches of a RecordIO file of image records (``recordio.pack``
    headers): each payload decoded with ``image.imdecode_or_raw`` (a raw
    CHW uint8 or float32 payload of ``data_shape`` needs no decoder),
    resized to ``data_shape`` with ``image.imresize_np`` when its size
    differs, mirrored when ``rand_mirror`` (probability 1/2), normalized
    by the means and stds (0-255), CHW float32. A short last batch repeats its
    last image when ``round_batch`` (its ``pad`` says how many), else it
    is dropped. Records are read ahead on a thread, ``prefetch_buffer``
    at most; ``shuffle``, ``rand_crop`` and ``preprocess_threads`` are
    accepted for MXNet's signature and change nothing, as in the JAX
    package."""

    def __init__(self, path_imgrec: str, data_shape, batch_size: int,
                 label_width: int = 1, shuffle: bool = False,
                 rand_crop: bool = False, rand_mirror: bool = False,
                 mean_r: float = 0., mean_g: float = 0., mean_b: float = 0.,
                 std_r: float = 1., std_g: float = 1., std_b: float = 1.,
                 preprocess_threads: int = 4, prefetch_buffer: int = 64,
                 round_batch: bool = True, **kwargs):
        super().__init__(batch_size)
        self.path_imgrec = path_imgrec
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.mean = np.array([mean_r, mean_g, mean_b], "float32")
        self.std = np.array([std_r, std_g, std_b], "float32")
        self.prefetch_buffer = prefetch_buffer
        self.round_batch = round_batch
        self._reader = None
        self._ahead = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label",
                         (self.batch_size, self.label_width)
                         if self.label_width > 1 else (self.batch_size,))]

    def _read_one(self):
        rec = self._reader.read()
        return _END if rec is None else rec

    def reset(self):
        self.close()
        self._reader = recordio.MXRecordIO(self.path_imgrec, "r")
        self._ahead = _ReadAhead(self._read_one, self.prefetch_buffer,
                                 "mxt-image-record-iter")

    def close(self):
        """Stop the reading thread and close the file."""
        if self._ahead is not None:
            self._ahead.stop()
            self._ahead = None
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _decode_one(self, rec: bytes):
        from ..image import imdecode_or_raw, imresize_np
        header, payload = recordio.unpack(rec)
        c, h, w = self.data_shape
        arr = imdecode_or_raw(payload, self.data_shape).astype("float32")
        if arr.shape[0] != h or arr.shape[1] != w:
            arr = imresize_np(arr, w, h)
        if self.rand_mirror and numpy_random().rand() < 0.5:
            arr = arr[:, ::-1]
        arr = (arr - self.mean) / self.std
        label = header.label
        if isinstance(label, np.ndarray):
            lab = label[:self.label_width]
        else:
            lab = np.array([label], "float32")[:self.label_width]
        return arr.transpose(2, 0, 1), lab

    def next(self) -> DataBatch:
        datas, labels = [], []
        while len(datas) < self.batch_size:
            rec = self._ahead.get()
            if rec is _END:
                break
            d, lab = self._decode_one(rec)
            datas.append(d)
            labels.append(lab)
        if not datas:
            raise StopIteration
        pad = self.batch_size - len(datas)
        if pad and not self.round_batch:
            raise StopIteration
        while len(datas) < self.batch_size:
            datas.append(datas[-1])
            labels.append(labels[-1])
        lab = np.stack(labels)
        if self.label_width == 1:
            lab = lab[:, 0]
        return DataBatch([to_tensor(np.stack(datas))], [to_tensor(lab)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)


#: MXNet surfaces its C++ iterators as ``MXDataIter``; the closest here
MXDataIter = ImageRecordIter
