"""DataLoader: batched, shuffled, prefetching iteration (counterpart of
``mxnet_tpu/gluon/data/dataloader.py``).

Workers are threads, as in the JAX package: decoding and augmenting are
numpy / PIL work that releases the GIL, and a fork is hostile to CUDA.
With ``num_workers > 0`` each batch is one task of a thread pool, at
most ``prefetch`` batches in flight, handed out in order. Each task
draws its random numbers from its own generators
(:class:`host.BatchStreams`): the first batch equals the one the
same loader gives without workers from the same seeds, and every batch
is the same whatever the threads' timing.

Cleanup: on a worker's exception, a timeout, or the consumer leaving
the loop (``break``, ``close``), the batches still in flight are
cancelled and the pool is shut down without waiting, so a failing
dataset does not run the rest of its window.

``device=`` / ``prefetch_to_device=`` stage the batches on the card
ahead of the step through :class:`DevicePrefetcher`
(:attr:`DataLoader.device_prefetch_stats`). ``device=True`` is
:func:`default_device` (it raises without a card); a ``DeviceMesh``
places each batch as ``parallel.place_on_mesh`` does over
``device_axis``. Without either, batches stay on the host, as CPU
tensors; ``pin_memory=True`` pins them (it needs a card).
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Callable, Optional

import numpy as np
import torch

from ... import host
from ...base import MXNetError
from ...host import to_tensor
from .batchify import Stack
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack array samples into a batch, field by field for tuple
    samples; numbers become a tensor (float64 narrowed to float32)."""
    if isinstance(data[0], (torch.Tensor, np.ndarray)):
        return Stack()(data)
    if isinstance(data[0], (tuple, list)):
        return tuple(default_batchify_fn(list(d)) for d in zip(*data))
    return to_tensor(np.asarray(data))


default_mp_batchify_fn = default_batchify_fn


def _pin(batch):
    if isinstance(batch, torch.Tensor):
        return batch.pin_memory()
    if isinstance(batch, (tuple, list)):
        return type(batch)(_pin(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _pin(v) for k, v in batch.items()}
    return batch


class _Window:
    """A threaded pass's pool and the futures in flight; :meth:`close`
    may be called from any thread, more than once."""

    def __init__(self, workers: int):
        self.pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="mxt-dataloader")
        self.inflight = deque()
        self.streams = None
        self._mu = threading.Lock()

    def close(self):
        while self.inflight:
            try:
                self.inflight.popleft().cancel()
            except IndexError:
                break
        self.pool.shutdown(wait=False, cancel_futures=True)
        with self._mu:     # the consumer's and the producer's close
            streams, self.streams = self.streams, None
        if streams is not None:
            streams.close()


class DataLoader:
    """Batches of a :class:`Dataset`: ``batch_size``, ``shuffle``,
    ``sampler``, ``last_batch`` (``keep`` / ``discard`` /
    ``rollover``), or a ``batch_sampler`` instead of all four;
    ``batchify_fn``; ``num_workers`` threads with ``prefetch`` batches in
    flight (default twice the workers); ``timeout`` seconds for a
    batch. ``thread_pool`` and ``pin_device_id`` are accepted for
    MXNet's signature (the workers are always threads; pinned memory
    serves every card)."""

    def __init__(self, dataset: Dataset, batch_size: Optional[int] = None,
                 shuffle: bool = False, sampler: Optional[Sampler] = None,
                 last_batch: Optional[str] = None,
                 batch_sampler: Optional[Sampler] = None,
                 batchify_fn: Optional[Callable] = None,
                 num_workers: int = 0, pin_memory: bool = False,
                 pin_device_id: int = 0, prefetch: Optional[int] = None,
                 thread_pool: bool = False, timeout: int = 120,
                 device=None, prefetch_to_device: Optional[int] = None,
                 device_axis: str = "dp"):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError(
                    "batch_size is required unless batch_sampler is given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle is mutually exclusive with sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError(
                "batch_size/shuffle/sampler/last_batch are mutually "
                "exclusive with batch_sampler")
        if pin_memory and not torch.cuda.is_available():
            raise MXNetError("pin_memory=True needs a CUDA device")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._pin_memory = pin_memory
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * max(self._num_workers, 1))
        self._timeout = timeout
        self._device = device
        self._device_axis = device_axis
        self._prefetch_to_device = prefetch_to_device
        self._device_prefetcher = None

    def __len__(self):
        return len(self._batch_sampler)

    def _load_batch(self, indices):
        batch = self._batchify_fn([self._dataset[i] for i in indices])
        return _pin(batch) if self._pin_memory else batch

    def _load_in_streams(self, indices, pair):
        with host.streams(pair):
            return self._load_batch(indices)

    def __iter__(self):
        if self._device is None and self._prefetch_to_device is None:
            yield from self._host_iter()
            return
        from .prefetcher import DevicePrefetcher
        dev, mesh = self._device, None
        if dev is True:
            dev = None                        # the default device
        elif dev is not None and hasattr(dev, "axis_names"):
            dev, mesh = None, self._device    # a DeviceMesh target
        window = _Window(self._num_workers) if self._num_workers else None
        self._device_prefetcher = DevicePrefetcher(
            self._host_iter(window), depth=self._prefetch_to_device,
            device=dev, mesh=mesh, axis=self._device_axis,
            timeout=self._timeout)
        try:
            yield from self._device_prefetcher
        finally:
            # the producer thread may still hold the host iterator
            if window is not None:
                window.close()

    @property
    def device_prefetch_stats(self):
        """Staging stats of the latest device-prefetching pass
        (``input_wait_ms``, ``starvation_count``, ...), or None."""
        return None if self._device_prefetcher is None \
            else self._device_prefetcher.stats_snapshot()

    def _host_iter(self, window: Optional[_Window] = None):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load_batch(indices)
            return
        window = window or _Window(self._num_workers)
        pool, inflight = window.pool, window.inflight
        try:
            batches = iter(self._batch_sampler)
            first = next(batches, None)
            if first is None:
                return
            # made after the sampler's draws, before any batch's
            rngs = host.BatchStreams()
            window.streams = rngs
            n = 0

            def submit(indices):
                nonlocal n
                inflight.append(pool.submit(self._load_in_streams, indices,
                                            rngs.pair(n)))
                n += 1

            submit(first)
            while len(inflight) < max(self._prefetch, 1):
                nxt = next(batches, None)
                if nxt is None:
                    break
                submit(nxt)
            while inflight:
                fut = inflight.popleft()
                try:
                    batch = fut.result(timeout=self._timeout)
                except FutureTimeout:
                    raise MXNetError(
                        f"DataLoader worker produced no batch within "
                        f"timeout={self._timeout}s") from None
                nxt = next(batches, None)
                if nxt is not None:
                    submit(nxt)
                yield batch
        finally:
            window.close()
