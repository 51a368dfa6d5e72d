"""Dynamic request batching (counterpart of ``mxnet_tpu/serving/batcher.py``).

Concurrent requests are coalesced into a predictor's shape buckets, so N
clients share one forward pass per micro-batch:

- ``submit()`` puts a request (array arguments with a leading row dim)
  on a bounded queue and returns a :class:`ServingFuture`; a queue that
  stays full sheds with :class:`~.resilience.Overloaded` (``reason``
  ``"queue"``).
- The dispatcher gathers requests until ``max_batch`` rows wait or the
  oldest has aged ``timeout_ms`` (or, when nothing is in flight, ships at
  once: lingering on an idle device buys no fill). The rows are
  concatenated, zero-padded to the next bucket and run as ONE
  ``predict`` call.
- Micro-batches are pipelined: each one records a CUDA event and enters
  a window of ``inflight`` batches; the host forms batch N+1 while the
  device runs batch N and waits only on the oldest batch when the window
  is full. A future resolves at dispatch; its ``result()`` waits for its
  batch's event on the client's thread and slices its rows out.
- ``close()`` flushes what is waiting; a request that cannot be
  dispatched fails with :class:`ServingShutdown`, never hangs.

Deterministic testing: inject ``clock=`` and construct with
``start=False``, then drive :meth:`process_once` by hand.

Deadlines, admission shedding, drain, the supervisor and the fleet of
the JAX package are not ported yet.
"""
from __future__ import annotations

import collections
import logging
import os
import queue
import threading
import time
from functools import partial
from typing import Callable, List, Optional

import torch

from ..base import MXNetError
from .predictor import map_tensors
from .resilience import Overloaded, ServingShutdown

__all__ = ["DynamicBatcher", "ServingFuture", "Overloaded",
           "ServingShutdown", "queue_depth"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving")


def queue_depth(default: int = 1024) -> int:
    """``MXNET_SERVING_QUEUE_DEPTH``: bounded request-queue capacity
    (at least 1; an unparsable value gives ``default``)."""
    try:
        v = int(os.environ.get("MXNET_SERVING_QUEUE_DEPTH", str(default)))
    except ValueError:
        return default
    return max(1, v)


def _build_response(outs, off: int, rows: int, bucket: int, event):
    """Wait for the micro-batch (the response sync, on the client's
    thread), then slice this request's rows out of every output whose
    leading dim is the bucket."""
    if event is not None:
        event.synchronize()
    return map_tensors(
        lambda t: t[off:off + rows]
        if t.ndim >= 1 and int(t.shape[0]) == bucket else t, outs)


class ServingFuture:
    """Handle for one submitted request's result."""

    __slots__ = ("_cv", "_build", "_out", "_err", "_done")

    def __init__(self):
        self._cv = threading.Condition()
        self._build = None
        self._out = None
        self._err = None
        self._done = False

    def _resolve(self, build):
        with self._cv:
            self._build, self._done = build, True
            self._cv.notify_all()

    def _fail(self, err: BaseException):
        with self._cv:
            if self._done and self._err is None:
                return           # a dispatched request keeps its result
            self._err, self._done = err, True
            self._cv.notify_all()

    def done(self) -> bool:
        with self._cv:
            return self._done

    def result(self, timeout: Optional[float] = None):
        """Block until the response is computed and return it: the net's
        output structure with this request's rows only, on the device."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._done, timeout):
                raise MXNetError(f"serving request not completed within "
                                 f"{timeout}s (batcher stopped? queue "
                                 "saturated?)")
            if self._err is not None:
                raise self._err
            if self._out is not None:
                return self._out
            build = self._build
        out = build()
        with self._cv:
            self._out = out
        return out


class _Request:
    __slots__ = ("args", "rows", "t_submit", "future")

    def __init__(self, args, rows, t_submit, future):
        self.args = args
        self.rows = rows
        self.t_submit = t_submit
        self.future = future


class _Inflight:
    __slots__ = ("reqs", "event")

    def __init__(self, reqs, event):
        self.reqs = reqs
        self.event = event


class DynamicBatcher:
    """Coalesce concurrent requests into one predictor's shape buckets.

        with DynamicBatcher(pred, max_batch=32, timeout_ms=2) as b:
            futs = [b.submit(x_i) for x_i in requests]
            outs = [f.result() for f in futs]

    ``submit`` is thread-safe; one background dispatcher thread owns the
    batching loop (``start=False`` for manual :meth:`process_once`).
    """

    def __init__(self, predictor, max_batch: int = 32,
                 timeout_ms: float = 2.0, depth: int = 1024,
                 inflight: int = 2,
                 clock: Callable[[], float] = time.perf_counter,
                 start: bool = True):
        self._predictor = predictor
        self.max_batch = max(1, int(max_batch))
        if self.max_batch > predictor.bucket_sizes[-1]:
            raise MXNetError(
                f"max_batch={self.max_batch} exceeds the predictor's "
                f"largest shape bucket ({predictor.bucket_sizes[-1]})")
        self._timeout_s = max(0.0, float(timeout_ms)) / 1e3
        self._inflight_cap = max(0, int(inflight))
        self._clock = clock
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=max(1, int(depth)))
        self._forming: List[_Request] = []
        self._window: "collections.deque[_Inflight]" = collections.deque()
        self._stop = threading.Event()
        self._thread = None
        self._stats_mu = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "rows": 0,
                      "padded_rows": 0, "flush_full": 0,
                      "flush_timeout": 0, "flush_idle": 0,
                      "flush_force": 0, "errors": 0, "rejected": 0,
                      "shutdown_failed": 0}
        #: micro-batches dispatched per bucket size
        self.bucket_counts: "collections.Counter[int]" = \
            collections.Counter()
        #: per-request seconds from submit to the retire of its batch
        #: (the newest 100k)
        self.latencies: "collections.deque[float]" = \
            collections.deque(maxlen=100_000)
        if start:
            self._thread = threading.Thread(
                target=self._serve_loop, name="mxt-serving-batcher",
                daemon=True)
            self._thread.start()

    # ---------------- client surface ----------------
    def submit(self, *args, timeout: Optional[float] = None
               ) -> ServingFuture:
        """Enqueue one request and return its future. ``timeout`` bounds
        the wait on a full queue (default: do not wait); a still-full
        queue raises :class:`Overloaded`."""
        if self._stop.is_set():
            raise ServingShutdown("DynamicBatcher is closed")
        rows = self._rows_of(args)
        if rows > self.max_batch:
            raise MXNetError(f"request of {rows} rows exceeds "
                             f"max_batch={self.max_batch}")
        fut = ServingFuture()
        req = _Request(args, rows, self._clock(), fut)
        try:
            if timeout is None or timeout <= 0:
                self._queue.put_nowait(req)
            else:
                self._queue.put(req, timeout=timeout)
        except queue.Full:
            with self._stats_mu:
                self.stats["rejected"] += 1
            raise Overloaded(f"serving queue saturated "
                             f"({self._queue.maxsize} requests)",
                             reason="queue") from None
        if self._stop.is_set() and not fut.done():
            # closed while this request was enqueued: the closer's last
            # sweep may have run already, so nobody would dispatch it
            err = ServingShutdown("serving closed while this request was "
                                  "being accepted")
            fut._fail(err)
            raise err
        with self._stats_mu:
            self.stats["requests"] += 1
        return fut

    @property
    def batch_fill(self) -> Optional[float]:
        """Valid rows / dispatched bucket rows (1.0 = no padding)."""
        with self._stats_mu:
            total = self.stats["rows"] + self.stats["padded_rows"]
            return self.stats["rows"] / total if total else None

    def flush(self):
        """Dispatch whatever is waiting and retire every in-flight
        micro-batch."""
        while self.process_once(force=True):
            pass
        self._retire_all()

    def close(self):
        """Stop the dispatcher thread, flush what is waiting, and fail
        anything left with :class:`ServingShutdown`. Idempotent."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                raise MXNetError("serving dispatcher thread did not stop")
            self._thread = None
        try:
            self.flush()
        finally:
            self._fail_pending(ServingShutdown(
                "DynamicBatcher closed with this request still pending"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---------------- batching core ----------------
    @staticmethod
    def _rows_of(args) -> int:
        for a in args:
            if getattr(a, "ndim", 0) >= 1:
                return int(a.shape[0])
        raise MXNetError("serving request has no array argument with a "
                         "leading batch dim")

    def _forming_rows(self) -> int:
        return sum(r.rows for r in self._forming)

    def _drain_queue(self):
        while True:
            try:
                self._forming.append(self._queue.get_nowait())
            except queue.Empty:
                return

    def _fail_pending(self, err: BaseException):
        self._drain_queue()
        pending, self._forming = self._forming, []
        for r in pending:
            if not r.future.done():
                with self._stats_mu:
                    self.stats["shutdown_failed"] += 1
                r.future._fail(err)

    def _take_batch(self) -> List[_Request]:
        batch, rows = [], 0
        while self._forming and \
                rows + self._forming[0].rows <= self.max_batch:
            r = self._forming.pop(0)
            batch.append(r)
            rows += r.rows
        return batch

    def process_once(self, force: bool = False) -> bool:
        """Pull waiting requests and dispatch ONE batch if >= max_batch
        rows wait, the oldest request is older than the timeout, or
        ``force``. Returns whether a batch was dispatched. Consults only
        the injected clock."""
        self._drain_queue()
        if not self._forming:
            return False
        if self._forming_rows() >= self.max_batch:
            reason = "full"
        elif self._clock() - self._forming[0].t_submit >= self._timeout_s:
            reason = "timeout"
        elif force:
            reason = "force"
        else:
            return False
        self._dispatch(self._take_batch(), reason)
        return True

    def _serve_loop(self):
        """Dispatcher thread body. An error that escapes the loop fails
        every pending future instead of leaving clients blocked."""
        try:
            self._serve_loop_inner()
        except BaseException as e:   # noqa: BLE001 - no request may hang
            _LOG.error("serving dispatcher thread died (%s: %s)",
                       type(e).__name__, e, exc_info=True)
            self._stop.set()
            self._fail_pending(ServingShutdown(
                f"serving dispatcher thread died: {type(e).__name__}: {e}"))

    def _serve_loop_inner(self):
        idle_poll = max(self._timeout_s, 0.005)
        while not self._stop.is_set():
            if not self._forming:
                # idle: retire finished batches, then wait for a request
                self._retire_all()
                try:
                    self._forming.append(self._queue.get(timeout=idle_poll))
                except queue.Empty:
                    continue
            deadline = self._forming[0].t_submit + self._timeout_s
            while self._forming_rows() < self.max_batch:
                try:
                    self._forming.append(self._queue.get_nowait())
                    continue
                except queue.Empty:
                    pass
                if not self._window:
                    break        # device idle: ship what we have now
                # the device is busy: spend the linger retiring its batch
                self._retire_oldest()
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                try:
                    self._forming.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            if self._forming_rows() >= self.max_batch:
                reason = "full"
            elif self._clock() - self._forming[0].t_submit \
                    >= self._timeout_s:
                reason = "timeout"
            else:
                reason = "idle"
            try:
                self._dispatch(self._take_batch(), reason)
            except Exception as e:   # keep serving after a bad batch
                _LOG.warning("serving dispatch failed (%s: %s)",
                             type(e).__name__, e)

    # ---------------- dispatch ----------------
    def _dispatch(self, reqs: List[_Request], reason: str):
        """One micro-batch: concatenate + pad to the bucket, ONE predict
        call, resolve each future with its lazy row slice, push the batch
        into the in-flight window."""
        if not reqs:
            return
        try:
            self._dispatch_inner(reqs, reason)
        except BaseException as e:
            with self._stats_mu:
                self.stats["errors"] += 1
            for r in reqs:
                r.future._fail(e)
            raise

    def _dispatch_inner(self, reqs: List[_Request], reason: str):
        pred = self._predictor
        rows = sum(r.rows for r in reqs)
        bucket = pred.bucket_for(rows)
        n_pos = len(reqs[0].args)
        if any(len(r.args) != n_pos for r in reqs):
            raise MXNetError("coalesced requests disagree on argument "
                             "count — one model signature per batcher")
        batch_args = tuple(
            self._concat_pad([r.args[i] for r in reqs], rows, bucket)
            for i in range(n_pos))
        outs = pred.predict(*batch_args)
        event = None
        if pred.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(pred.device))
        off = 0
        for r in reqs:
            r.future._resolve(partial(_build_response, outs, off, r.rows,
                                      bucket, event))
            off += r.rows
        with self._stats_mu:
            self.stats["batches"] += 1
            self.stats["rows"] += rows
            self.stats["padded_rows"] += bucket - rows
            self.stats["flush_" + reason] += 1
            self.bucket_counts[bucket] += 1
        self._window.append(_Inflight(reqs, event))
        while len(self._window) > self._inflight_cap:
            self._retire_oldest()

    def _concat_pad(self, leaves, rows: int, bucket: int):
        """Concatenate one argument position across requests and pad it
        with zero rows to the bucket, on the predictor's device."""
        if not all(getattr(l, "ndim", 0) >= 1 for l in leaves):
            return leaves[0]     # an unbatched argument rides as it is
        ts = [self._predictor.as_tensor(l) for l in leaves]
        if bucket > rows:
            ts.append(ts[0].new_zeros((bucket - rows,)
                                      + tuple(ts[0].shape[1:])))
        return ts[0] if len(ts) == 1 else torch.cat(ts, dim=0)

    def _retire_oldest(self):
        """Wait for the oldest in-flight micro-batch, then record its
        requests' latencies."""
        rec = self._window.popleft()
        if rec.event is not None:
            rec.event.synchronize()
        now = self._clock()
        with self._stats_mu:
            self.latencies.extend(max(0.0, now - r.t_submit)
                                  for r in rec.reqs)

    def _retire_all(self):
        while self._window:
            self._retire_oldest()
