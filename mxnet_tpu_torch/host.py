"""Host arrays and random draws of the input pipeline.

A host sample or batch is a numpy array or a CPU tensor (the port's
array). :func:`to_numpy` reads either as numpy (a CPU tensor's shares its
memory); :func:`to_tensor` makes a CPU tensor, narrowing float64 to
float32 as the JAX package's ``NDArray`` narrows it (other types are
kept: an int64 label stays int64 where the JAX ``NDArray`` holds int32).

The vision transforms, the image augmenters and ``io.ImageRecordIter``
draw as the JAX package's do: the same calls, in the same order, on
numpy's global ``RandomState`` (transforms, ``LightingAug``, mirrors) or
on Python's global ``random`` (the other augmenters). A seeded run of a
transform therefore repeats the JAX one value for value.

A threaded ``DataLoader`` runs several batches at once, and draws shared
between threads would interleave in whatever order the threads run.
Inside :func:`streams` the calling thread draws from generators of its
own instead: :func:`numpy_random` and :func:`py_random` return them.
:class:`BatchStreams` hands out one pair a batch, so a threaded loader
gives the same batches for the same seeds whatever its timing.
"""
from __future__ import annotations

import contextlib
import random
import threading

import numpy as np
import torch

__all__ = ["to_numpy", "to_tensor", "numpy_random", "py_random", "streams",
           "BatchStreams"]

_local = threading.local()


def to_numpy(x) -> np.ndarray:
    """A host array as numpy (a CPU tensor's shares its memory)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_tensor(arr) -> torch.Tensor:
    """A host array as a CPU tensor, float64 narrowed to float32."""
    if isinstance(arr, torch.Tensor):
        return arr.float() if arr.dtype == torch.float64 else arr
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32, order="C")
    elif not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")   # a tensor may be written to
    return torch.from_numpy(arr)


def numpy_random() -> np.random.RandomState:
    """This thread's numpy generator inside :func:`streams`, else numpy's
    global one (what ``numpy.random.<fn>`` draws from)."""
    rs = getattr(_local, "np", None)
    return rs if rs is not None else np.random.random_sample.__self__


def py_random() -> random.Random:
    """This thread's Python generator inside :func:`streams`, else the
    ``random`` module's global one."""
    rs = getattr(_local, "py", None)
    return rs if rs is not None else random.random.__self__


@contextlib.contextmanager
def streams(pair):
    """Draw from ``pair`` (numpy ``RandomState``, ``random.Random``) on
    this thread until the block ends."""
    old = getattr(_local, "np", None), getattr(_local, "py", None)
    _local.np, _local.py = pair
    try:
        yield
    finally:
        _local.np, _local.py = old


class BatchStreams:
    """The generators of one threaded pass over a loader, one pair a
    batch. Made on the consumer's side when the first batch is handed to
    a worker:

    - batch 0 draws from copies of the two global generators as they
      stand then, so it equals the first batch of the same loader run
      without workers from the same seeds;
    - batch ``k > 0`` draws from generators seeded from that state and
      ``k``.

    The pass draws nothing from the global generators. At its end,
    :meth:`close` reseeds each from its own next draw if any batch drew,
    so the next pass starts elsewhere; a pass that drew nothing leaves
    them as they were."""

    def __init__(self):
        self._np_state = numpy_random().get_state()
        self._py_state = py_random().getstate()
        self._words = [int(v) for v in self._np_state[1]] + \
            [int(self._np_state[2])]
        # the Python state's integers only: its last item (``gauss_next``,
        # mostly None) hashes by address before Python 3.12
        self._py_words = np.asarray(self._py_state[1], np.uint64)
        self._made = []

    def pair(self, k: int):
        if k == 0:
            rs, py = np.random.RandomState(), random.Random()
            rs.set_state(self._np_state)
            py.setstate(self._py_state)
        else:
            rs = np.random.RandomState(self._words + [k])
            py = random.Random(int.from_bytes(
                np.append(self._py_words, np.uint64(k)).tobytes(), "little"))
        self._made.append((rs, rs.get_state(), py, py.getstate()))
        return rs, py

    def drew(self) -> bool:
        """Whether any batch's generators were drawn from."""
        for rs, start, py, py_start in self._made:
            now = rs.get_state()
            if now[2:] != start[2:] or not np.array_equal(now[1], start[1]) \
                    or py.getstate() != py_start:
                return True
        return False

    def close(self):
        if self.drew():
            g_np, g_py = numpy_random(), py_random()
            g_np.seed(g_np.randint(0, 2 ** 31, size=4))
            g_py.seed(g_py.getrandbits(64))
