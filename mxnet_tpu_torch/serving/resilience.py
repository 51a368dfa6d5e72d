"""Resilient serving: typed failures, admission settings, the circuit
breaker and the supervisor (counterpart of
``mxnet_tpu/serving/resilience.py``).

- **Typed failures.** Every way an accepted request can fail is a
  distinct type the client can branch on: :class:`DeadlineExceeded`
  (its budget ran out while it queued: dropped at dequeue, never
  dispatched), :class:`Overloaded` (shed at admission; ``.reason`` says
  why) and :class:`ServingShutdown` (the batcher closed, or its
  dispatcher died, with the request pending). All subclass
  :class:`MXNetError`.
- **Admission** (``MXNET_SERVING_SHED``, :func:`shed_mode`): a request
  whose projected wait already exceeds its deadline is rejected at
  ``submit``, so accepted requests keep their latency under overload.
- **:class:`CircuitBreaker`**: closed -> open (new submits fast-fail
  while recovery runs) -> half-open (probe traffic) -> closed, on an
  injectable clock.
- **:class:`ServingSupervisor`**: classifies a batch's failure at the
  batcher's dispatch and retire seams (``elastic.detect.classify``):
  ``device_lost`` rebuilds the predictor on the first device of
  ``parallel.dist.available_devices()`` and re-enqueues the in-flight
  requests exactly once; ``transient`` re-enqueues with a bounded
  backoff (``MXNET_SERVING_RETRIES``); ``fatal`` / ``oom`` fail the
  futures with the error. A preemption notice drains the batcher.

A rebuilt predictor captures every bucket's CUDA graph anew on its
device (the JAX package warm-starts its AOT programs from a compile
cache; graphs do not move between cards), so that capture is part of a
recovery's downtime. Telemetry: ``mx_serving_breaker_state`` (0 closed,
1 half-open, 2 open), ``mx_serving_retries_total{cause}`` and
``mx_serving_recoveries_total{cause}``, beside ``stats``,
:attr:`CircuitBreaker.transitions` and
:attr:`ServingSupervisor.last_recovery`.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional, Sequence

from .. import telemetry as _telemetry
from ..analysis.threads import mx_lock, mx_rlock
from ..base import MXNetError

__all__ = ["DeadlineExceeded", "Overloaded", "ServingShutdown",
           "CircuitBreaker", "ServingSupervisor", "default_deadline_ms",
           "shed_mode", "queue_timeout_s", "transient_retries"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving")


# ---------------------------------------------------------------- errors
class DeadlineExceeded(MXNetError):
    """The request's latency budget ran out while it waited in the
    queue: it was dropped at dequeue, never padded into a bucket or
    dispatched."""


class Overloaded(MXNetError):
    """The request was shed at admission (``.reason`` ∈ {``queue``,
    ``deadline``, ``breaker``, ``draining``, ``kvcache``, ``fleet``}).
    Retryable: after a backoff, on another replica, or once the breaker
    closes."""

    def __init__(self, msg: str, reason: str = "queue"):
        super().__init__(msg)
        self.reason = reason


class ServingShutdown(MXNetError):
    """The server can no longer serve this request: it closed or
    drained, or its dispatcher died, with the request still pending.
    Every pending future gets this instead of hanging."""


# ---------------------------------------------------------------- env gates
def default_deadline_ms() -> Optional[float]:
    """``MXNET_SERVING_DEADLINE_MS``: the per-request latency budget when
    ``submit(deadline_ms=)`` is not given. Unset, empty, unparsable or
    <= 0 means no deadline."""
    v = os.environ.get("MXNET_SERVING_DEADLINE_MS", "").strip()
    if not v:
        return None
    try:
        ms = float(v)
    except ValueError:
        return None
    return ms if ms > 0 else None


def shed_mode(default: str = "deadline") -> str:
    """``MXNET_SERVING_SHED``: ``off`` (a full queue blocks ``submit`` up
    to the queue timeout), ``deadline`` (the default: also reject at
    ``submit`` when the projected wait exceeds the request's deadline;
    a request without one behaves as ``off``) or ``queue`` (never block:
    a full queue rejects at once)."""
    v = os.environ.get("MXNET_SERVING_SHED", "").strip().lower()
    return v if v in ("off", "deadline", "queue") else default


def queue_timeout_s(default_ms: float = 120000.0) -> float:
    """``MXNET_SERVING_QUEUE_TIMEOUT_MS``: how long a blocking ``submit``
    may wait on a full queue before it is shed with :class:`Overloaded`,
    as seconds. <= 0 means reject at once."""
    try:
        v = float(os.environ.get("MXNET_SERVING_QUEUE_TIMEOUT_MS",
                                 str(default_ms)))
    except (TypeError, ValueError):
        v = default_ms
    return max(0.0, v) / 1e3


def transient_retries(default: int = 2) -> int:
    """``MXNET_SERVING_RETRIES``: re-dispatches a request may take after
    ``transient`` failures (a device loss re-enqueues it at most once,
    apart from this budget)."""
    try:
        v = int(os.environ.get("MXNET_SERVING_RETRIES", default))
    except (TypeError, ValueError):
        return default
    return max(0, v)


# ---------------------------------------------------------------- breaker
class CircuitBreaker:
    """Three states for the serving admission path.

    ``closed`` (normal) -> ``open`` (:meth:`allow` is False: the
    supervisor trips it when recovery starts, or ``failure_threshold``
    failures in a row open it) -> ``half_open`` (probe traffic passes:
    the supervisor moves here once the predictor is rebuilt, or
    ``cooldown_s`` elapsed on ``clock``) -> ``closed`` on the first
    success; a failure while half-open opens it again. Every transition
    is kept in :attr:`transitions` as ``(state, time, cause)``."""

    CLOSED = "closed"
    HALF_OPEN = "half_open"
    OPEN = "open"
    #: the level of each state (0 closed, 1 half-open, 2 open)
    LEVEL = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, failure_threshold: int = 1,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._lock = mx_lock("serving.breaker")
        self._clock = clock
        self._threshold = max(1, int(failure_threshold))
        self._cooldown = cooldown_s
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at: Optional[float] = None
        self.transitions: List[tuple] = [(self.CLOSED, clock(), "init")]
        self._m_state = _telemetry.registry().gauge(
            _telemetry.names.SERVING_BREAKER_STATE)
        self._m_state.set(0)

    #: ``mx_serving_breaker_state``'s value of each state
    _LEVEL = {"closed": 0, "half_open": 1, "open": 2}

    def _set(self, state: str, cause: str):
        """Transition (under the lock)."""
        if state == self._state:
            return
        self._state = state
        self._m_state.set(self._LEVEL[state])
        if state == self.OPEN:
            self._opened_at = self._clock()
        if len(self.transitions) < 256:
            self.transitions.append((state, self._clock(), cause))

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """Whether a new submit may pass. An open breaker whose cooldown
        elapsed turns half-open and admits the probe."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._cooldown is not None and \
                        self._opened_at is not None and \
                        self._clock() - self._opened_at >= self._cooldown:
                    self._set(self.HALF_OPEN, "cooldown")
                    return True
                return False
            return True          # half-open: probe traffic flows

    def record_failure(self, cause: str = "failure"):
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN or \
                    self._failures >= self._threshold:
                self._set(self.OPEN, cause)

    def record_success(self):
        with self._lock:
            self._failures = 0
            if self._state == self.HALF_OPEN:
                self._set(self.CLOSED, "probe_ok")

    def trip(self, cause: str = "recovery"):
        """Force open (the supervisor's recovery entry)."""
        with self._lock:
            self._set(self.OPEN, cause)

    def half_open(self, cause: str = "recovered"):
        with self._lock:
            if self._state == self.OPEN:
                self._set(self.HALF_OPEN, cause)

    def close(self, cause: str = "reset"):
        with self._lock:
            self._failures = 0
            self._set(self.CLOSED, cause)


# ---------------------------------------------------------------- supervisor
class ServingSupervisor:
    """Keep one serving deployment alive across device loss, transient
    dispatch failures and preemption::

        def build():                        # deterministic
            net = make_net()
            return serving.CompiledPredictor(net, bucket_sizes=(1, 2, 4))

        sup = serving.ServingSupervisor(build, example=(x_row,),
                                        max_batch=4, timeout_ms=2.0)
        out = sup.submit(x).result(30)
        sup.drain()

    ``build()`` makes a FRESH predictor. It runs inside
    ``with context.Context(first available device):`` (so a predictor
    built without ``device=`` lands on the first card that survives),
    then ``warmup(*example)`` captures every bucket on that device.

    Failures at the batcher's dispatch and retire seams:

    - ``device_lost``: trip the breaker (new submits fail fast with
      :class:`Overloaded` ``reason="breaker"``), abandon the in-flight
      window, rebuild over the surviving devices, re-enqueue every
      affected request EXACTLY ONCE (one lost twice fails with the
      device-loss error), half-open the breaker; the first successful
      retire closes it.
    - ``transient``: re-enqueue after an exponential backoff, at most
      ``MXNET_SERVING_RETRIES`` times a request.
    - ``fatal`` / ``oom``: the futures fail with the error.

    ``drain_on_preemption`` (default True) polls the process-wide
    preemption notice from the dispatch loop: a SIGTERM drains the
    batcher (reject new, flush what was accepted, close). A string polls
    the notice of that scope (``elastic.detect.notice(scope)``), which
    drains only this supervisor: the fleet's per-replica drain.
    """

    def __init__(self, build: Callable, example: Optional[Sequence] = None,
                 *, max_batch: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 depth: Optional[int] = None,
                 inflight: Optional[int] = None,
                 max_requeues: int = 1,
                 max_retries: Optional[int] = None,
                 backoff_base: float = 0.05, backoff_max: float = 2.0,
                 breaker: Optional[CircuitBreaker] = None,
                 drain_on_preemption=True,
                 clock: Callable[[], float] = time.perf_counter,
                 start: bool = True):
        from ..elastic import detect as _detect
        from .batcher import DynamicBatcher
        self._build = build
        self._example = tuple(example) if example is not None else None
        self._max_requeues = max(0, int(max_requeues))
        self._max_retries = transient_retries() if max_retries is None \
            else max(0, int(max_retries))
        self._backoff_base = float(backoff_base)
        self._backoff_max = float(backoff_max)
        self._detect = _detect
        self._lock = mx_rlock("serving.supervisor")
        self._transient_streak = 0
        self._closed = False
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.stats = {"recoveries": 0, "requeued": 0, "retried": 0,
                      "failed_requeues": 0, "recovery_downtime_s": 0.0,
                      "drains": 0}
        self.last_recovery: Optional[dict] = None
        reg = _telemetry.registry()
        self._m_retries = reg.counter(_telemetry.names.SERVING_RETRIES,
                                      label_key="cause")
        self._m_recoveries = reg.counter(
            _telemetry.names.SERVING_RECOVERIES, label_key="cause")
        self._predictor = self._form(first=True)
        self._batcher = DynamicBatcher(
            self._predictor, max_batch=max_batch, timeout_ms=timeout_ms,
            depth=depth, inflight=inflight, clock=clock, start=start)
        self._batcher.breaker = self.breaker
        self._batcher.on_batch_failure = self._on_batch_failure
        self._batcher.on_batch_retired = self._on_batch_retired
        self.notice_scope = drain_on_preemption \
            if isinstance(drain_on_preemption, str) else None
        if drain_on_preemption:
            # a scoped notice also honours the process-wide one, so a
            # real SIGTERM still drains every scope
            self._batcher.drain_check = \
                self._detect.notice(self.notice_scope).requested

    # ---------------- public surface ----------------
    @property
    def predictor(self):
        """The live predictor (rebuilt at every recovery)."""
        return self._predictor

    @property
    def batcher(self):
        return self._batcher

    def submit(self, *args, deadline_ms=None, timeout=None):
        """Breaker-guarded submit; returns a ``ServingFuture``. Raises
        :class:`Overloaded` / :class:`ServingShutdown` at admission."""
        return self._batcher.submit(*args, deadline_ms=deadline_ms,
                                    timeout=timeout)

    def drain(self):
        """Graceful shutdown: reject new, flush what was accepted,
        close."""
        self.stats["drains"] += 1
        self._batcher.drain()
        self._closed = True

    def close(self):
        self._batcher.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---------------- formation ----------------
    def _form(self, first: bool = False):
        """Build (or rebuild) the predictor on the first surviving device
        and capture its buckets there."""
        from ..context import Context
        from ..parallel import dist as _dist
        devs = _dist.available_devices()
        if not devs:
            raise MXNetError("serving: no devices survive; cannot "
                             "(re)build the predictor")
        dev = devs[0]
        with Context("gpu" if dev.type == "cuda" else "cpu",
                     dev.index or 0):
            pred = self._build()
            if self._example is not None:
                pred.warmup(*self._example)
        if not first:
            _LOG.warning("serving: predictor rebuilt on %s (%d bucket "
                         "program(s) captured)", pred.device,
                         pred.n_traces)
        return pred

    # ---------------- failure handling (dispatcher thread) ----------------
    def _on_batch_failure(self, reqs, exc, seam: str) -> bool:
        """The batcher's hook: classify and recover. True when the
        requests were handled here (re-enqueued or failed); False lets
        the batcher fail their futures with the error."""
        cause = self._detect.classify(exc)
        if cause == "device_lost":
            self._recover(list(reqs), exc, seam, cause)
            return True
        if cause == "transient":
            return self._retry_transient(list(reqs), exc, seam)
        return False             # fatal / oom / stall: propagate

    def _on_batch_retired(self):
        """After a successful retire: a half-open breaker closes, the
        transient backoff streak resets."""
        self._transient_streak = 0
        self.breaker.record_success()

    def _retry_transient(self, reqs, exc, seam) -> bool:
        with self._lock:
            self._transient_streak += 1
            streak = self._transient_streak
        retry, fail = [], []
        for r in reqs:
            if r.retries >= self._max_retries:
                fail.append(r)
            else:
                r.retries += 1
                retry.append(r)
        for r in fail:
            self.stats["failed_requeues"] += 1
            r.future._fail(MXNetError(
                f"serving request failed after {r.retries} transient "
                f"retr{'ies' if r.retries != 1 else 'y'} "
                f"(MXNET_SERVING_RETRIES): {type(exc).__name__}: {exc}"))
        if not retry:
            return True
        delay = min(self._backoff_max,
                    self._backoff_base * (2 ** (streak - 1)))
        _LOG.warning(
            "serving: transient failure at %s (%s: %s); re-enqueueing "
            "%d request(s) after %.2fs backoff", seam,
            type(exc).__name__, exc, len(retry), delay)
        if delay > 0:
            time.sleep(delay)
        for r in retry:
            r.future._rearm()
            self._m_retries.inc(label="transient")
        self.stats["retried"] += len(retry)
        self._batcher.requeue(retry)
        return True

    def _recover(self, reqs, exc, seam, cause):
        """Device loss: breaker open, in-flight abandoned, predictor
        rebuilt over the surviving devices, requests re-enqueued exactly
        once, breaker half-open. Runs on the dispatcher thread."""
        with self._lock:
            t0 = time.monotonic()
            self.breaker.trip(cause)
            self._detect.maybe_record_device_lost(exc, f"serving {seam}")
            extra = self._batcher.abandon_inflight()
            seen = {id(r) for r in reqs}
            reqs = reqs + [r for r in extra if id(r) not in seen]
            reqs.sort(key=lambda r: r.t_submit)
            pred = self._rebuild(exc)
            if pred is None:     # nothing left to serve on
                for r in reqs:
                    self.stats["failed_requeues"] += 1
                    r.future._fail(ServingShutdown(
                        f"serving recovery failed after {cause} at "
                        f"{seam}: {type(exc).__name__}: {exc}"))
                return
            old = self._predictor
            self._predictor = pred
            self._batcher.rebind(pred)
            _release(old)
            requeue = []
            for r in reqs:
                if r.requeues >= self._max_requeues:
                    self.stats["failed_requeues"] += 1
                    r.future._fail(MXNetError(
                        f"serving request lost to repeated device "
                        f"failure (re-enqueued {r.requeues}x): "
                        f"{type(exc).__name__}: {exc}"))
                else:
                    r.requeues += 1
                    r.future._rearm()
                    self._m_retries.inc(label=cause)
                    requeue.append(r)
            self._batcher.requeue(requeue)
            self.stats["requeued"] += len(requeue)
            self.breaker.half_open()
            downtime = time.monotonic() - t0
            self.stats["recoveries"] += 1
            self.stats["recovery_downtime_s"] += downtime
            self._m_recoveries.inc(label=cause)
            self.last_recovery = {
                "cause": cause, "seam": seam, "downtime_s": downtime,
                "requeued": len(requeue),
                "failed": len(reqs) - len(requeue),
                "device": str(pred.device), "time_unix": time.time()}
            _LOG.warning(
                "serving: recovered from %s at %s in %.2fs "
                "(%d request(s) re-enqueued, %d failed)", cause, seam,
                downtime, len(requeue), len(reqs) - len(requeue))

    def _rebuild(self, exc):
        """The predictor rebuilt, with bounded retries; None when every
        attempt failed."""
        attempts = max(1, self._detect.max_retries())
        last = exc
        for i in range(attempts):
            try:
                return self._form()
            except Exception as e:       # noqa: BLE001 - retried
                last = e
                delay = min(self._backoff_max,
                            self._backoff_base * (2 ** i))
                _LOG.warning(
                    "serving: predictor rebuild attempt %d/%d failed "
                    "(%s: %s); retrying in %.2fs", i + 1, attempts,
                    type(e).__name__, e, delay)
                time.sleep(delay)
        _LOG.error("serving: predictor rebuild exhausted %d attempts "
                   "(%s: %s)", attempts, type(last).__name__, last)
        return None


def _release(pred):
    """Free a replaced predictor's captured graphs and their pool now
    (the device synchronized first), not when the cyclic collector
    runs."""
    progs = getattr(pred, "_programs", None)
    if progs is not None:
        try:
            progs.clear()
        except Exception:        # pragma: no cover - a lost device
            _LOG.warning("serving: freeing the old predictor's programs "
                         "failed", exc_info=True)
