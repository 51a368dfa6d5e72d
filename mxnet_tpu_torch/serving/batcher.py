"""Dynamic request batching (counterpart of ``mxnet_tpu/serving/batcher.py``).

Concurrent requests are coalesced into a predictor's shape buckets, so N
clients share one forward pass per micro-batch:

- **Bounded queue.** ``submit()`` puts a request (array arguments with a
  leading row dim) on a bounded queue (``MXNET_SERVING_QUEUE_DEPTH``) and
  returns a :class:`ServingFuture`; a queue that stays full sheds with
  :class:`~.resilience.Overloaded` (``reason`` ``"queue"``). ``submit``
  waits on a full queue for ``timeout`` seconds, by default
  ``MXNET_SERVING_QUEUE_TIMEOUT_MS`` when it is set and not at all when
  it is not (the JAX package waits 120 s by default).
- **Deadlines and admission.** ``submit(deadline_ms=)`` (default
  ``MXNET_SERVING_DEADLINE_MS``) rides the queue with the request; one
  that expired while it queued is dropped at dequeue with
  :class:`~.resilience.DeadlineExceeded` and never dispatched. Under
  ``MXNET_SERVING_SHED=deadline`` a request whose projected wait
  (:meth:`DynamicBatcher.estimated_wait_s`: an EWMA of the micro-batch
  service time, seeded from the predictor's ``warmup``, times the
  batches ahead) exceeds its deadline is rejected at ``submit``.
- **Coalescing.** The dispatcher gathers requests until ``max_batch``
  rows wait or the oldest has aged ``timeout_ms`` (or, when nothing is
  in flight, ships at once: lingering on an idle device buys no fill).
  The rows are concatenated, zero-padded to the next bucket and run as
  ONE ``predict`` call.
- **Pipelining.** Each micro-batch records a CUDA event and enters a
  window of ``inflight`` batches; the host forms batch N+1 while the
  device runs batch N and waits only on the oldest batch when the
  window is full (the retire, where latencies and the service-time EWMA
  are recorded). A future resolves at dispatch; its ``result()`` waits
  for its batch's event on the client's thread and slices its rows out
  of the outputs ``predict`` returned: copies out of the bucket's
  captured program, which no later replay overwrites.
- **Failure containment.** A dispatch or retire failure goes to the
  ``on_batch_failure`` hook (a :class:`~.resilience.ServingSupervisor`
  or the fleet classifies and recovers it, re-enqueueing the affected
  requests through :meth:`DynamicBatcher.requeue`); without a handler
  the affected futures fail with the error. A dead dispatcher, or a
  ``close()`` with requests pending, fails every pending future with
  :class:`~.resilience.ServingShutdown`: an accepted request never
  hangs. :meth:`DynamicBatcher.drain` is the graceful path: reject new,
  flush what was accepted, close.
- **Chaos seams.** ``serving.admit``, ``serving.dispatch`` and
  ``serving.retire`` are ``testing.faults`` points, tagged with
  ``fault_ctx`` (the fleet sets it to the replica's name).

The dispatcher thread makes the predictor's card its current device, so
its events, copies and replays land there. Deterministic testing: inject
``clock=`` and construct with ``start=False``, then drive
:meth:`DynamicBatcher.process_once` / :meth:`DynamicBatcher.flush` by
hand; the flush, deadline and admission arithmetic read only the
injected clock.

``max_batch_rows`` / ``batch_timeout_s`` are the ``serving.max_batch``
/ ``serving.batch_timeout_ms`` tunables (``tuning/space.py``): autotune
override > ``MXNET_SERVING_MAX_BATCH`` / ``MXNET_SERVING_BATCH_TIMEOUT_MS``
> the default, read when a batcher is built, so one built after
``CompiledPredictor.warmup(autotune=)`` takes the tuned knobs.

Telemetry (the JAX package's ``mx_serving_*`` series, beside ``stats``):
``mx_serving_requests_total`` (admitted), ``mx_serving_batches_total``,
``mx_serving_rejected_total{reason}``, ``mx_serving_deadline_missed_
total``, the ``mx_serving_queue_depth`` / ``mx_serving_inflight_batches``
gauges and the ``mx_serving_batch_occupancy_ratio`` /
``mx_serving_request_seconds`` (submit to the retire of its batch) /
``mx_serving_drain_seconds`` histograms.
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

from .. import telemetry as _telemetry
from ..analysis.threads import mx_condition, mx_lock
from ..base import MXNetError
from ..testing.faults import fault_point
from .predictor import map_tensors
from .resilience import (DeadlineExceeded, Overloaded, ServingShutdown,
                         default_deadline_ms, queue_timeout_s, shed_mode)

__all__ = ["DynamicBatcher", "ServingFuture", "Overloaded",
           "ServingShutdown", "queue_depth", "max_batch_rows",
           "batch_timeout_s"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving")


def max_batch_rows(default: int = 32) -> int:
    """The most rows coalesced into one dispatch: autotune override >
    ``MXNET_SERVING_MAX_BATCH`` > ``default`` (the ``serving.max_batch``
    tunable; at least 1, an unparsable value gives ``default``)."""
    from ..tuning import space as _tspace
    found, v = _tspace.get_override("serving.max_batch")
    if not found:
        v = os.environ.get("MXNET_SERVING_MAX_BATCH", str(default))
    try:
        return max(1, int(v))
    except (TypeError, ValueError):
        return default


def batch_timeout_s(default_ms: float = 2.0) -> float:
    """How long the oldest waiting request may age before a partial batch
    flushes, as seconds: autotune override >
    ``MXNET_SERVING_BATCH_TIMEOUT_MS`` (milliseconds) > ``default_ms``
    (the ``serving.batch_timeout_ms`` tunable)."""
    from ..tuning import space as _tspace
    found, v = _tspace.get_override("serving.batch_timeout_ms")
    if not found:
        v = os.environ.get("MXNET_SERVING_BATCH_TIMEOUT_MS",
                           str(default_ms))
    try:
        v = float(v)
    except (TypeError, ValueError):
        v = default_ms
    return max(0.0, v) / 1e3


def _register_tunables():
    """The coalescing tunables: the cap trades occupancy against padding,
    the linger batching delay against fill. Both are dispatch policy (a
    request's result is the same at any setting), so the autotuner may
    sweep them."""
    from ..tuning.space import Tunable, register
    register(Tunable(
        "serving.max_batch", default=32, grid=(8, 16, 32, 64),
        env="MXNET_SERVING_MAX_BATCH", parse=int,
        valid=lambda v, _c: int(v) >= 1,
        seam="serving.batcher.max_batch_rows() -> DynamicBatcher "
             "coalescing cap (must fit the predictor's bucket ladder)",
        scope="serving",
        doc="max coalesced request rows per serving micro-batch"))
    register(Tunable(
        "serving.batch_timeout_ms", default=2.0,
        grid=(0.5, 1.0, 2.0, 5.0, 10.0),
        env="MXNET_SERVING_BATCH_TIMEOUT_MS", parse=float,
        valid=lambda v, _c: float(v) >= 0.0,
        seam="serving.batcher.batch_timeout_s() -> oldest-request "
             "linger before a partial flush",
        scope="serving",
        doc="max age (ms) of the oldest waiting request before a "
            "partial micro-batch flushes"))


_register_tunables()


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
    """Handle for one submitted request's result.

    It resolves when its micro-batch dispatches; :meth:`result` waits for
    the batch on the client's thread and slices this request's rows
    out. Under a supervisor or a fleet the future can be RE-ARMED: a
    request whose batch was lost is re-enqueued, and the future resolves
    again against the new batch (``_epoch`` tells the two apart), so a
    client already blocked in :meth:`result` rides through the recovery.
    ``replica`` / ``version`` name the fleet replica that served it and
    that replica's weight version."""

    __slots__ = ("_cv", "_build", "_out", "_err", "_done", "_epoch",
                 "_supervised", "replica", "version")

    def __init__(self):
        self._cv = mx_condition("serving.future")
        self._build = None
        self._out = None
        self._err = None
        self._done = False
        self._epoch = 0
        self._supervised = False
        self.replica: Optional[str] = None
        self.version: Optional[int] = None

    def _resolve(self, build):
        with self._cv:
            self._build, self._err, self._done = build, None, True
            self._cv.notify_all()

    def _fail(self, err: BaseException):
        with self._cv:
            if self._done and self._err is None and self._out is not None:
                return           # a delivered result is final
            self._err, self._done = err, True
            self._cv.notify_all()

    def _rearm(self):
        """Recovery: back in flight, pending its re-dispatched batch."""
        with self._cv:
            self._build = self._err = self._out = None
            self._done = False
            self._epoch += 1
            self._cv.notify_all()

    def done(self) -> bool:
        with self._cv:
            return self._done

    def _cv_wait(self, deadline) -> bool:
        """One bounded wait under the condition; False when the client's
        timeout passed."""
        if deadline is None:
            self._cv.wait()
            return True
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        self._cv.wait(remaining)
        return True

    def result(self, timeout: Optional[float] = None):
        """Block until the response is computed and return it: the net's
        output structure with this request's rows only, on the device.
        Raises the typed serving error, or the dispatch error when the
        batch failed for good."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cv:
                while not self._done:
                    if not self._cv_wait(deadline):
                        raise MXNetError(
                            f"serving request not completed within "
                            f"{timeout}s (batcher stopped? queue "
                            "saturated?)")
                if self._err is not None:
                    raise self._err
                if self._out is not None:
                    return self._out
                epoch, build = self._epoch, self._build
            try:
                out = build()
            except BaseException as e:
                if self._await_redispatch(epoch, e, deadline):
                    continue
                raise
            with self._cv:
                if self._epoch == epoch and self._err is None:
                    self._out = out
            return out

    def _await_redispatch(self, epoch, exc, deadline) -> bool:
        """The response's builder failed on the client's thread. Under a
        supervisor, a device loss or transient failure is seen by the
        dispatcher at the retire too: wait (within the client's timeout)
        for it to re-arm this future or fail it typed."""
        if not self._supervised:
            return False
        from ..elastic import detect
        if detect.classify(exc) not in ("device_lost", "transient"):
            return False
        with self._cv:
            while self._epoch == epoch and self._done \
                    and self._err is None:
                if not self._cv_wait(deadline):
                    return False
            return True


class _Request:
    __slots__ = ("args", "rows", "t_submit", "future", "deadline",
                 "retries", "requeues")

    def __init__(self, args, rows, t_submit, future, deadline=None):
        self.args = args
        self.rows = rows
        self.t_submit = t_submit
        self.future = future
        self.deadline = deadline   # absolute, on the batcher's clock
        self.retries = 0           # transient re-dispatches so far
        self.requeues = 0          # device-loss re-enqueues so far


class _Inflight:
    __slots__ = ("reqs", "event", "t_dispatch")

    def __init__(self, reqs, event, t_dispatch):
        self.reqs = reqs
        self.event = event
        self.t_dispatch = t_dispatch


class DynamicBatcher:
    """Coalesce concurrent requests into one predictor's shape buckets.

        with DynamicBatcher(pred, max_batch=32, timeout_ms=2) as b:
            futs = [b.submit(x_i) for x_i in requests]
            outs = [f.result() for f in futs]

    ``submit`` is thread-safe; one background dispatcher thread owns the
    batching loop (``start=False`` for manual :meth:`process_once`).

    The resilience hooks (a supervisor or a fleet sets them; all off by
    default): ``breaker`` (a :class:`~.resilience.CircuitBreaker` asked
    at admission), ``on_batch_failure(reqs, exc, seam) -> bool``
    (classify and recover; True when the requests were re-enqueued or
    failed by the handler), ``on_batch_retired()`` (after a successful
    retire), ``drain_check()`` (polled by the dispatch loop; True starts
    a graceful drain) and ``fault_ctx`` (the context of the chaos
    seams).
    """

    def __init__(self, predictor, max_batch: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 depth: Optional[int] = None,
                 inflight: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 start: bool = True):
        self._predictor = predictor
        self.max_batch = max_batch_rows() if max_batch is None \
            else max(1, int(max_batch))
        if self.max_batch > predictor.bucket_sizes[-1]:
            raise MXNetError(
                f"max_batch={self.max_batch} exceeds the predictor's "
                f"largest shape bucket ({predictor.bucket_sizes[-1]})")
        self._timeout_s = batch_timeout_s() if timeout_ms is None \
            else max(0.0, float(timeout_ms)) / 1e3
        self._inflight_cap = 2 if inflight is None else max(0, int(inflight))
        self._clock = clock
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=queue_depth() if depth is None else max(1, int(depth)))
        self._forming: List[_Request] = []
        self._window: "collections.deque[_Inflight]" = collections.deque()
        self._stop = threading.Event()
        self._drain_now = threading.Event()
        self._thread = None
        self._draining = False
        self._dead: Optional[BaseException] = None
        #: the admission EWMA of one micro-batch's service time, seeded
        #: from the predictor's warmup so shedding projects from the
        #: first request
        self._ewma_service: Optional[float] = self._service_seed(predictor)
        self.breaker = None
        self.on_batch_failure = None
        self.on_batch_retired = None
        self.drain_check = None
        self.fault_ctx: Optional[str] = None
        self._stats_mu = mx_lock("serving.batcher.stats")
        self._admit_mu = mx_lock("serving.batcher.admit")
        self.stats = {"requests": 0, "batches": 0, "rows": 0,
                      "padded_rows": 0, "flush_full": 0,
                      "flush_timeout": 0, "flush_idle": 0,
                      "flush_force": 0, "errors": 0, "rejected": 0,
                      "deadline_missed": 0, "requeued": 0,
                      "recovered_batches": 0, "shutdown_failed": 0}
        #: micro-batches dispatched per bucket size
        self.bucket_counts: "collections.Counter[int]" = \
            collections.Counter()
        #: per-request seconds from submit to the retire of its batch
        #: (the newest 100k)
        self.latencies: "collections.deque[float]" = \
            collections.deque(maxlen=100_000)
        #: seconds of each drain, from its start to the last retire
        self.drain_seconds: List[float] = []
        t = _telemetry
        reg = t.registry()
        self._m_requests = reg.counter(t.names.SERVING_REQUESTS)
        self._m_batches = reg.counter(t.names.SERVING_BATCHES)
        self._m_queue = reg.gauge(t.names.SERVING_QUEUE_DEPTH)
        self._m_inflight = reg.gauge(t.names.SERVING_INFLIGHT)
        self._m_occupancy = reg.histogram(t.names.SERVING_OCCUPANCY)
        self._m_latency = reg.histogram(t.names.SERVING_LATENCY)
        self._m_rejected = reg.counter(t.names.SERVING_REJECTED,
                                       label_key="reason")
        self._m_deadline = reg.counter(t.names.SERVING_DEADLINE_MISSED)
        self._m_drain = reg.histogram(t.names.SERVING_DRAIN_SECONDS)
        if start:
            self._thread = threading.Thread(
                target=self._serve_loop, name="mxt-serving-batcher",
                daemon=True)
            self._thread.start()

    # ---------------- client surface ----------------
    def _reject(self, reason: str, msg: str):
        with self._stats_mu:
            self.stats["rejected"] += 1
        self._m_rejected.inc(label=reason)
        raise Overloaded(msg, reason=reason)

    def submit(self, *args, deadline_ms: Optional[float] = None,
               timeout: Optional[float] = None) -> ServingFuture:
        """Enqueue one request and return its future.

        ``deadline_ms``: this request's latency budget (default
        ``MXNET_SERVING_DEADLINE_MS``; <= 0 opts out). ``timeout``: the
        longest wait on a full queue (see the module docstring); a
        still-full queue sheds with :class:`Overloaded` (``queue``)."""
        fault_point("serving.admit", "before", ctx=self.fault_ctx)
        self._check_open()
        if self.breaker is not None and not self.breaker.allow():
            self._reject("breaker",
                         "serving circuit breaker is open (recovery in "
                         "progress): failing fast instead of queueing")
        rows = self._rows_of(args)
        if rows > self.max_batch:
            raise MXNetError(f"request of {rows} rows exceeds "
                             f"max_batch={self.max_batch}")
        if deadline_ms is None:
            deadline_ms = default_deadline_ms()
        elif deadline_ms <= 0:
            deadline_ms = None
        now = self._clock()
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        mode = shed_mode()
        if mode == "deadline" and deadline is not None:
            est = self.estimated_wait_s(rows)
            if est is not None and now + est > deadline:
                self._reject(
                    "deadline",
                    f"projected queue wait {est * 1e3:.1f} ms exceeds the "
                    f"request deadline ({deadline_ms:.0f} ms): shed at "
                    "admission (MXNET_SERVING_SHED=deadline)")
        fut = ServingFuture()
        fut._supervised = self.on_batch_failure is not None
        req = _Request(args, rows, now, fut, deadline=deadline)
        block_s = queue_timeout_s(0.0) if timeout is None \
            else max(0.0, float(timeout))
        end = time.monotonic() + block_s
        while True:
            # the admission lock: a drain, close, failover or death that
            # closes admission waits for this put, so what is enqueued
            # here is flushed or failed by it, never left behind
            with self._admit_mu:
                closed = self._admission_closed()
                if not closed:
                    try:
                        self._queue.put_nowait(req)
                        break
                    except queue.Full:
                        pass
            if closed:
                # raised past the admission lock: a rejection takes the
                # stats lock, which never nests under this one
                self._check_open()
                continue
            if mode == "queue" or time.monotonic() >= end:
                self._reject("queue", f"serving queue saturated "
                             f"({self._queue.maxsize} requests)")
            time.sleep(0.0005)
        with self._stats_mu:
            self.stats["requests"] += 1
        self._m_requests.inc()
        self._m_queue.set(self._queue.qsize() + len(self._forming))
        return fut

    def _admission_closed(self) -> bool:
        return (self._dead is not None or self._stop.is_set()
                or self._draining)

    def _check_open(self):
        """Raise what a request meets at a batcher that no longer
        admits: the dispatcher died, it is closed, or it drains."""
        if self._dead is not None:
            raise ServingShutdown(
                f"serving dispatcher thread died "
                f"({type(self._dead).__name__}: {self._dead}); the "
                "batcher cannot accept requests")
        if self._stop.is_set():
            raise ServingShutdown("DynamicBatcher is closed")
        if self._draining:
            self._reject("draining",
                         "serving drain in progress: new requests are "
                         "rejected while accepted ones flush")

    def _close_admission(self, stop: bool = False):
        """Admit nothing more (drain mode, or closed with ``stop``), and
        wait out a submit that is enqueueing now."""
        if stop:
            self._stop.set()
        else:
            self._draining = True
        with self._admit_mu:
            pass

    @staticmethod
    def _service_seed(predictor) -> Optional[float]:
        seed = getattr(predictor, "service_time_seed_s", None)
        try:
            seed = float(seed) if seed is not None else None
        except (TypeError, ValueError):
            return None
        return seed if seed and seed > 0 else None

    def estimated_wait_s(self, rows: int = 0) -> Optional[float]:
        """The projected wait until a request submitted now retires: the
        waiting rows (its own included) in batches of ``max_batch``, plus
        the in-flight batches, times the EWMA service time. None before
        any seed or retire (no estimate: admit)."""
        ewma = self._ewma_service
        if ewma is None:
            return None
        waiting = self._queue.qsize() + self._forming_rows() + rows
        batches = (waiting + self.max_batch - 1) // self.max_batch \
            + len(self._window)
        return batches * ewma

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

    def drain(self):
        """Graceful shutdown: new submits shed with :class:`Overloaded`
        (``draining``), every waiting and in-flight request is flushed,
        then the batcher closes; nothing accepted is silently lost. The
        flush runs on the dispatcher thread when there is one (the
        owner of the forming list). Idempotent."""
        t0 = self._clock()
        self._close_admission()
        if self._thread is not None:
            self._drain_now.set()
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                raise MXNetError("serving dispatcher thread did not stop "
                                 "draining")
            self._thread = None
            self._stop.set()
            self._fail_pending(ServingShutdown(
                "serving drained before this request could be "
                "dispatched"))
            return
        if self._stop.is_set():
            return               # already closed
        try:
            self.flush()
        finally:
            self._stop.set()
            self._fail_pending(ServingShutdown(
                "serving drained before this request could be "
                "dispatched"))
            self._drained(t0)

    def close(self):
        """Stop the dispatcher thread, flush what is waiting, and fail
        anything left with :class:`ServingShutdown`. Idempotent."""
        self._close_admission(stop=True)
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                raise MXNetError("serving dispatcher thread did not stop")
            self._thread = None
        try:
            if self._dead is None:
                self.flush()
        finally:
            self._fail_pending(ServingShutdown(
                "DynamicBatcher closed with this request still pending"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---------------- recovery surface ----------------
    def requeue(self, reqs: List[_Request]):
        """Put recovered requests back at the FRONT of the forming list
        (recovery, on the dispatcher thread). Their submit times and
        deadlines stay, so the age flush re-dispatches them promptly."""
        if not reqs:
            return
        self._forming[0:0] = list(reqs)
        with self._stats_mu:
            self.stats["requeued"] += len(reqs)

    def rebind(self, predictor):
        """Serve from a rebuilt predictor (recovery); ``max_batch`` must
        still fit its buckets. The dispatcher thread moves to its
        device."""
        if self.max_batch > predictor.bucket_sizes[-1]:
            raise MXNetError(
                f"max_batch={self.max_batch} exceeds the rebuilt "
                f"predictor's largest shape bucket "
                f"({predictor.bucket_sizes[-1]})")
        self._predictor = predictor
        if self._ewma_service is None:
            self._ewma_service = self._service_seed(predictor)
        if threading.current_thread() is self._thread:
            self._enter_device()

    def abandon_inflight(self) -> List[_Request]:
        """Drop every in-flight micro-batch WITHOUT waiting for it (work
        on a lost device would only raise again) and return the requests
        that rode them, for the handler to re-enqueue or fail once."""
        recs, self._window = list(self._window), collections.deque()
        return [r for rec in recs for r in rec.reqs]

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

    def _expire_forming(self):
        """Fail the requests whose deadline passed while they queued
        with :class:`DeadlineExceeded`; they are never dispatched."""
        if not self._forming:
            return
        now = self._clock()
        kept = []
        for r in self._forming:
            if r.deadline is not None and now >= r.deadline:
                with self._stats_mu:
                    self.stats["deadline_missed"] += 1
                self._m_deadline.inc()
                r.future._fail(DeadlineExceeded(
                    f"request deadline expired after "
                    f"{(now - r.t_submit) * 1e3:.1f} ms in queue: dropped "
                    "at dequeue, never dispatched"))
            else:
                kept.append(r)
        self._forming = kept

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
        """Pull waiting requests, drop expired ones, and dispatch ONE
        batch if >= max_batch rows wait, the oldest request is older than
        the timeout, or ``force``. Returns whether a batch was
        dispatched. Reads only the injected clock."""
        self._drain_queue()
        self._expire_forming()
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

    def _enter_device(self):
        """Make the predictor's card this thread's current device."""
        dev = getattr(self._predictor, "device", None)
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)

    def _serve_loop(self):
        """Dispatcher thread body. An error that escapes the loop fails
        every pending future instead of leaving clients blocked."""
        try:
            self._enter_device()
            self._serve_loop_inner()
        except BaseException as e:   # noqa: BLE001 - no request may hang
            self._dead = e
            self._close_admission()
            _LOG.error("serving dispatcher thread died (%s: %s)",
                       type(e).__name__, e, exc_info=True)
            self._fail_pending(ServingShutdown(
                f"serving dispatcher thread died: {type(e).__name__}: {e}"))

    def _serve_loop_inner(self):
        idle_poll = max(self._timeout_s, 0.005)
        while not self._stop.is_set():
            if self._drain_now.is_set() or self._wants_drain():
                self._drain_in_loop()
                return
            try:
                if not self._forming:
                    # idle: retire finished batches, then wait for a
                    # request
                    self._retire_all()
                    try:
                        self._forming.append(
                            self._queue.get(timeout=idle_poll))
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
                        break    # device idle: ship what we have now
                    # the device is busy: spend the linger retiring
                    self._retire_oldest()
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        break
                    try:
                        self._forming.append(
                            self._queue.get(timeout=remaining))
                    except queue.Empty:
                        break
                if self._stop.is_set():
                    return       # a failover took this replica's queue
                if self._forming_rows() >= self.max_batch:
                    reason = "full"
                elif self._clock() - self._forming[0].t_submit \
                        >= self._timeout_s:
                    reason = "timeout"
                else:
                    reason = "idle"
                self._expire_forming()
                if not self._forming:
                    continue
                self._dispatch(self._take_batch(), reason)
            except Exception as e:   # keep serving after a bad batch
                if self._handle_batch_failure([], e, "dispatcher"):
                    continue
                _LOG.warning("serving dispatch failed (%s: %s)",
                             type(e).__name__, e)

    def _wants_drain(self) -> bool:
        """Poll the drain hook (the preemption bridge); a hook error
        never kills the loop."""
        if self.drain_check is None or self._draining:
            return False
        try:
            return bool(self.drain_check())
        except Exception:        # pragma: no cover - defensive
            return False

    def _drain_in_loop(self):
        """The drain, on the dispatcher thread: reject new, flush forming
        and in-flight, fail anything left typed, stop."""
        t0 = self._clock()
        self._close_admission()
        _LOG.warning("serving: drain requested; flushing %d waiting + %d "
                     "in-flight", self._queue.qsize() + len(self._forming),
                     len(self._window))
        try:
            self.flush()
        except Exception:        # pragma: no cover - defensive
            _LOG.warning("serving drain flush failed", exc_info=True)
        self._stop.set()
        self._fail_pending(ServingShutdown(
            "serving drained before this request could be dispatched"))
        self._drained(t0)

    def _drained(self, t0):
        dt = max(0.0, self._clock() - t0)
        self.drain_seconds.append(dt)
        self._m_drain.observe(dt)
        self._m_queue.set(0)
        self._m_inflight.set(len(self._window))

    # ---------------- dispatch ----------------
    def _handle_batch_failure(self, reqs, exc, seam: str) -> bool:
        """Hand a batch failure to the resilience handler. True when the
        handler re-enqueued or failed the requests."""
        handler = self.on_batch_failure
        if handler is None:
            return False
        try:
            handled = bool(handler(reqs, exc, seam))
        except Exception:        # pragma: no cover - defensive
            _LOG.error("serving failure handler raised; failing the "
                       "batch instead", exc_info=True)
            return False
        if handled:
            with self._stats_mu:
                self.stats["recovered_batches"] += 1
        return handled

    def _dispatch(self, reqs: List[_Request], reason: str):
        """One micro-batch: concatenate and pad to the bucket, ONE
        predict call, resolve each future with its lazy row slice, push
        the batch into the in-flight window."""
        if not reqs:
            return
        try:
            self._dispatch_inner(reqs, reason)
        except BaseException as e:
            if self._handle_batch_failure(reqs, e, "dispatch"):
                return
            with self._stats_mu:
                self.stats["errors"] += 1
            for r in reqs:
                if not r.future.done():
                    r.future._fail(e)
            raise

    def _dispatch_inner(self, reqs: List[_Request], reason: str):
        pred = self._predictor
        rows = sum(r.rows for r in reqs)
        bucket = pred.bucket_for(rows)
        n_pos = len(reqs[0].args)
        if any(len(r.args) != n_pos for r in reqs):
            raise MXNetError("coalesced requests disagree on argument "
                             "count: one model signature per batcher")
        batch_args = tuple(
            self._concat_pad([r.args[i] for r in reqs], rows, bucket)
            for i in range(n_pos))
        # a revoked device surfaces here when the loss hits at dispatch
        fault_point("serving.dispatch", "before", ctx=self.fault_ctx)
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
        self._window.append(_Inflight(list(reqs), event, self._clock()))
        self._m_batches.inc()
        self._m_occupancy.observe(rows / bucket)
        self._m_inflight.set(len(self._window))
        self._m_queue.set(self._queue.qsize() + len(self._forming))
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
        requests' latencies and fold its service time into the EWMA. A
        failure here goes to the handler with the batch's riders."""
        rec = self._window.popleft()
        try:
            # a deferred device loss surfaces at the wait on the batch
            fault_point("serving.retire", "before", ctx=self.fault_ctx)
            if rec.event is not None:
                rec.event.synchronize()
        except BaseException as e:
            if self._handle_batch_failure(rec.reqs, e, "retire"):
                return
            raise
        now = self._clock()
        dt = max(0.0, now - rec.t_dispatch)
        self._ewma_service = dt if self._ewma_service is None \
            else 0.3 * dt + 0.7 * self._ewma_service
        lat = [max(0.0, now - r.t_submit) for r in rec.reqs]
        with self._stats_mu:
            self.latencies.extend(lat)
        for v in lat:
            self._m_latency.observe(v)
        self._m_inflight.set(len(self._window))
        if self.on_batch_retired is not None:
            try:
                self.on_batch_retired()
            except Exception:    # pragma: no cover - defensive
                _LOG.warning("serving retire hook failed", exc_info=True)
        fault_point("serving.retire", "after", ctx=self.fault_ctx)

    def _retire_all(self):
        while self._window:
            self._retire_oldest()
