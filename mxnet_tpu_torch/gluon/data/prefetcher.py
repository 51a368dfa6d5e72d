"""Staging the next batches on the card while the current step runs
(counterpart of ``mxnet_tpu/gluon/data/prefetcher.py``).

:class:`DevicePrefetcher` pulls batches from any host iterable on a
bounded background thread and copies them to the device ahead of the
step that reads them:

- each leaf is first placed as the train step places it
  (``CompiledTrainStep.input_placement()``: under a dp mesh this rank's
  1/N of the leading axis, marked so the step passes it through), so a
  rank copies only its own part;
- on a card the host part goes to pinned memory (``pin_memory()``, on
  the producer thread: it shares the GIL with the step's Python outside
  the copy itself) and up in one ``non_blocking`` copy on a side stream
  the prefetcher owns; an event is recorded after the batch's copies.
  The caching host allocator reuses a pinned block only once the copy
  out of it has finished;
- the consumer's current stream waits on that event before the batch is
  handed out, so no kernel reads it early, and every staged tensor is
  ``record_stream``-ed on that stream, so the allocator does not reuse
  its block while the step may still read it. (The current stream is
  per thread: the producer sets its device and stream itself.)
- on the CPU (``device="cpu"``) a leaf is staged with a plain ``.to()``.

The structure of a batch (tuple, list, dict) is kept. An exception of
the producer is raised at the consumer; a batch not produced within
``timeout`` seconds raises :class:`MXNetError`; an early ``break``
stops the producer and drops the batches it staged. Every batch passes
the ``prefetch.stage`` fault points, and a device loss there is
recorded (``elastic.detect``). ``stats``: ``prefetch_batches``,
``input_wait_ms`` (the time the consumer waited for a staged batch),
``starvation_count`` (times the queue was empty when it asked) and
``prefetch_depth``. ``MXNET_DEVICE_PREFETCH`` sets the default depth
(2); 0 stages inline, on the consumer's thread.

Telemetry: ``mx_prefetch_batches_total``, ``mx_prefetch_starvation_total``
and ``mx_prefetch_input_wait_seconds_total`` beside ``stats``; with
``MXNET_TELEMETRY`` (or a running profiler) the ``batch_fetch`` span (the
source's pull and the staging, on the producer) and the ``h2d_wait``
span (the consumer's wait) of each batch. Every staged tensor is filed
in the census pool ``prefetch`` by weakref, so it leaves the pool when
the step drops it, and on an early break or an error when the queue's
batches are dropped. An allocation failure while staging gets its OOM
post-mortem at the consumer.
"""
from __future__ import annotations

import functools
import os
import queue
import threading
import time
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from ... import telemetry as _telemetry
from ...analysis.threads import mx_lock
from ...base import MXNetError
from ...context import resolve_device
from ...parallel.mesh import carry_placement, place_on_mesh
from ...testing.faults import fault_point

__all__ = ["DevicePrefetcher", "default_prefetch_depth"]

_DONE = object()


def default_prefetch_depth(default: int = 2) -> int:
    try:
        v = int(os.environ.get("MXNET_DEVICE_PREFETCH", str(default)))
    except ValueError:
        return default
    return max(0, v)


class _Raised:
    """The producer's exception, carried to the consumer."""

    def __init__(self, exc):
        self.exc = exc


class DevicePrefetcher:
    """Bounded background staging of host batches on ``device``.

    ``place`` is the per-leaf placement (``CompiledTrainStep.
    input_placement()``); ``mesh=`` (with ``axis=``) stands for
    ``parallel.place_on_mesh`` on that mesh. ``device`` is where staged
    batches live: ``cuda:0`` by default (it raises without a card),
    ``"cpu"`` when asked. Iterating yields batches of the source's
    structure, already on the device. :attr:`stats` accumulate over
    iterations."""

    def __init__(self, source, depth: Optional[int] = None,
                 place: Optional[Callable] = None, device=None,
                 mesh=None, axis: str = "dp", timeout: float = 120.0):
        self._source = source
        self._depth = default_prefetch_depth() if depth is None \
            else max(0, int(depth))
        self._timeout = timeout
        if place is None and mesh is not None:
            place = functools.partial(place_on_mesh, mesh, axis)
        self._place = place
        self._device = resolve_device(device)
        self.stats = {"prefetch_depth": self._depth,
                      "prefetch_batches": 0, "input_wait_ms": 0.0,
                      "starvation_count": 0}
        # the stats are read while the producer runs: every update
        # holds this lock
        self._stats_mu = mx_lock("data.prefetch.stats")
        self._stream = None
        self._live = weakref.WeakSet()
        reg = _telemetry.registry()
        names = _telemetry.names
        self._m_batches = reg.counter(names.PREFETCH_BATCHES)
        self._m_starved = reg.counter(names.PREFETCH_STARVATION)
        self._m_wait = reg.counter(names.PREFETCH_INPUT_WAIT)

    def stats_snapshot(self) -> dict:
        with self._stats_mu:
            return dict(self.stats)

    def staged_alive(self) -> int:
        """Staged tensors still referenced anywhere (by the queue, the
        consumer or a step)."""
        return len(self._live)

    # ---------------- staging ----------------
    def _stage_leaf(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor):
            return x
        src = self._place(x) if self._place is not None else x
        if self._device.type == "cuda" and src.device.type == "cpu":
            host = src if src.is_pinned() else src.pin_memory()
            out = host.to(self._device, non_blocking=True)
        else:
            out = src.to(self._device)
            if out is src:      # same device: a new handle, same storage
                out = src.view_as(src)
        carry_placement(src, out)
        self._live.add(out)
        _telemetry.memory.census().register("prefetch", out)
        return out

    def _stage(self, batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._stage(b) for b in batch)
        if isinstance(batch, dict):
            return {k: self._stage(v) for k, v in batch.items()}
        return self._stage_leaf(batch)

    def _stage_batch(self, batch, ordinal):
        """One whole batch, bracketed by the ``prefetch.stage`` fault
        points (one hit a batch) and the device-lost detector. On a card:
        copied on the prefetcher's stream, with the event after it."""
        from ...elastic import detect
        fault_point("prefetch.stage", "before")
        try:
            if self._device.type == "cuda":
                with torch.cuda.device(self._device):
                    if self._stream is None:
                        self._stream = torch.cuda.Stream(self._device)
                    with torch.cuda.stream(self._stream):
                        staged = self._stage(batch)
                        ev = torch.cuda.Event()
                        ev.record(self._stream)
            else:
                staged, ev = self._stage(batch), None
        except BaseException as e:
            detect.maybe_record_device_lost(e, "prefetch staging",
                                            step=ordinal)
            raise
        fault_point("prefetch.stage", "after")
        return staged, ev

    def _hand_out(self, staged, ev):
        """Make the consumer's stream wait for the batch's copies, and
        tell the allocator its tensors are used on that stream."""
        if ev is None:
            return staged
        cur = torch.cuda.current_stream(self._device)
        cur.wait_event(ev)
        for t in _tensors(staged):
            t.record_stream(cur)
        return staged

    def _count(self, key, v=1):
        with self._stats_mu:
            self.stats[key] += v

    def _fetched(self, n, t0):
        """One batch pulled and staged: the ``batch_fetch`` span."""
        if _telemetry.active():
            _telemetry.timeline().record("batch_fetch", t0,
                                         time.perf_counter(), step=n)

    def _handed(self, n):
        self._count("prefetch_batches")
        self._m_batches.inc()

    # ---------------- iteration ----------------
    def __iter__(self):
        if self._depth == 0:
            it = iter(self._source)
            n = 0
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                staged, ev = self._stage_batch(batch, n)
                self._fetched(n, t0)
                self._handed(n)
                n += 1
                yield self._hand_out(staged, ev)

        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                it = iter(self._source)
                n = 0
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    staged = self._stage_batch(batch, n)
                    self._fetched(n, t0)
                    n += 1
                    if not put(staged):
                        return
                item = _DONE
            except BaseException as e:   # carried to the consumer
                item = _Raised(e)
            put(item)

        worker = threading.Thread(target=produce, daemon=True,
                                  name="mxt-device-prefetch")
        worker.start()
        try:
            n = 0
            while True:
                if q.empty():
                    self._count("starvation_count")
                    self._m_starved.inc()
                t0 = time.perf_counter()
                try:
                    item = q.get(timeout=self._timeout)
                except queue.Empty:
                    raise MXNetError(
                        f"DevicePrefetcher produced no batch within "
                        f"timeout={self._timeout}s") from None
                t1 = time.perf_counter()
                self._count("input_wait_ms", (t1 - t0) * 1e3)
                self._m_wait.inc(t1 - t0)
                if _telemetry.active():
                    _telemetry.timeline().record("h2d_wait", t0, t1, step=n)
                if item is _DONE:
                    return
                if isinstance(item, _Raised):
                    # an allocation failure (or a lost device) of the
                    # producer, recorded at the seam the caller sees
                    _telemetry.memory.maybe_record_oom(
                        item.exc, "prefetch staging", step=n)
                    from ...elastic import detect
                    detect.maybe_record_device_lost(
                        item.exc, "prefetch staging", step=n)
                    raise item.exc
                self._handed(n)
                n += 1
                yield self._hand_out(*item)
                del item
        finally:
            # on an early break or an error the queue still holds up to
            # `depth` staged batches: stop the producer, then drop them
            stop.set()
            worker.join(timeout=5.0)
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def _tensors(batch):
    if isinstance(batch, torch.Tensor):
        yield batch
    elif isinstance(batch, (tuple, list)):
        for b in batch:
            yield from _tensors(b)
    elif isinstance(batch, dict):
        for b in batch.values():
            yield from _tensors(b)
