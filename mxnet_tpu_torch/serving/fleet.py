"""Serving fleet: routing, failover and rolling weight swaps over several
replicas (counterpart of ``mxnet_tpu/serving/fleet.py``).

One :class:`~.resilience.ServingSupervisor` keeps one replica alive;
this module runs a FLEET of them, one predictor + batcher + supervisor a
device, from one process, behind a router:

- **:class:`FleetController`** spawns ``MXNET_FLEET_REPLICAS`` replicas,
  each built inside ``with context.Context(<its device>):`` so its
  parameters and captured graphs land on its own card, and owns the
  replica lifecycle (``serving`` -> ``draining`` / ``recovering`` ->
  ``retired``).
- **:class:`FleetRouter`**: ``submit()`` picks the serving replica with
  the lowest projected wait (each batcher's EWMA times its batches
  ahead), skipping open breakers and draining or retired replicas. When
  no replica can take the request the caller gets
  ``Overloaded(reason="fleet")``, never a hang.
- **Failover.** A ``device_lost`` at a replica's dispatch or retire
  seam moves its in-flight AND queued requests onto the survivors
  EXACTLY ONCE (their futures re-arm, so a client blocked in
  ``result()`` rides through; a request lost twice fails typed), then
  restarts the replica on a spare device with a bounded backoff. A
  restarted replica captures every bucket anew on its card (CUDA graphs
  do not move between cards and the port has no shared compile cache),
  so that capture is part of its time to recover. The old replica's
  graphs and pool are freed at once.
- **Autoscaling.** ``maybe_scale()`` adds a replica when the fleet's
  queue-wait EWMA passes ``MXNET_FLEET_SCALE_UP_WAIT_MS`` (and a device
  is free), and drain-then-retires the emptiest one below
  ``MXNET_FLEET_SCALE_DOWN_WAIT_MS``, within ``MXNET_FLEET_MIN_REPLICAS``
  / ``MXNET_FLEET_MAX_REPLICAS``.
- **Drain-then-retire.** A scoped preemption notice
  (``elastic.detect.notice("fleet/replica-N")``) drains exactly that
  replica; the process-wide notice drains every one.
- **Rolling weight swap.** :meth:`FleetController.swap_weights` checks
  the checkpoint's CRCs FIRST (a corrupt one aborts typed with every
  replica on the old weights), then walks the replicas one at a time:
  drain (accepted requests finish on the old weights, every replay in
  flight retired), copy the new weights INTO the parameters' storage
  (the captured graphs read it, so nothing is captured again and
  ``n_traces`` stays; a bf16 replica casts on the copy), a warm probe,
  back into rotation. A failed copy puts a saved clone of the old
  weights back in place. At most one weight version of skew is in
  flight.

Locks: the fleet's ``RLock`` is taken before a batcher's, never the
other way, and no future is waited on under it. ``_failover`` runs on
the lost replica's dispatcher thread. Telemetry: the ``mx_fleet_*``
series (``mx_fleet_replicas{state}``, refreshed at every fleet event,
``mx_fleet_routed_requests_total{replica}``, ``mx_fleet_replica_restarts_
total``, ``mx_fleet_weight_swaps_total``, ``mx_fleet_scale_events_total
{direction}`` and the ``mx_fleet_queue_wait_seconds`` of each routed
request's replica), beside ``stats``, ``events`` (:class:`FleetEvent`)
and :meth:`FleetController.describe`.

Deterministic testing: ``start=False`` runs every batcher by hand; drive
:meth:`FleetController.pump` with an injected ``clock=``; restarts then
run inline, without backoff sleeps. The chaos harness targets one
replica with ``point@ctx`` fault rules (``testing/faults.py``), e.g.
``serving.dispatch@replica-1:before=1:revoke:d1``. A device loss there
is simulated: the card stays healthy and ``available_devices()`` leaves
it out.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import telemetry as _telemetry
from ..analysis.threads import mx_lock, mx_rlock
from ..base import MXNetError
from ..testing.faults import fault_point
from .batcher import DynamicBatcher
from .predictor import map_tensors, synchronize
from .resilience import (CircuitBreaker, Overloaded, ServingShutdown,
                         ServingSupervisor, _release)

__all__ = ["FleetController", "FleetRouter", "FleetEvent",
           "fleet_replicas", "fleet_min_replicas", "fleet_max_replicas",
           "fleet_scale_up_wait_s", "fleet_scale_down_wait_s",
           "fleet_restart_retries"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving")


# ---------------------------------------------------------------- env gates
def _env(name: str, default, cast):
    try:
        return cast(os.environ.get(name, str(default)))
    except (TypeError, ValueError):
        return default


def fleet_replicas(default: int = 1) -> int:
    """``MXNET_FLEET_REPLICAS``: the initial replica count (each needs its
    own device of ``parallel.dist.available_devices()``)."""
    return max(1, _env("MXNET_FLEET_REPLICAS", default, int))


def fleet_min_replicas(default: int = 1) -> int:
    """``MXNET_FLEET_MIN_REPLICAS``: the scale-down floor."""
    return max(1, _env("MXNET_FLEET_MIN_REPLICAS", default, int))


def fleet_max_replicas(default: int = 0) -> int:
    """``MXNET_FLEET_MAX_REPLICAS``: the scale-up ceiling; <= 0 means one
    a device."""
    return _env("MXNET_FLEET_MAX_REPLICAS", default, int)


def fleet_scale_up_wait_s(default_ms: float = 200.0) -> float:
    """``MXNET_FLEET_SCALE_UP_WAIT_MS``: the queue-wait EWMA above which
    ``maybe_scale()`` adds a replica, as seconds."""
    return max(0.0, _env("MXNET_FLEET_SCALE_UP_WAIT_MS", default_ms,
                         float)) / 1e3


def fleet_scale_down_wait_s(default_ms: float = 5.0) -> float:
    """``MXNET_FLEET_SCALE_DOWN_WAIT_MS``: the queue-wait EWMA below which
    ``maybe_scale()`` retires the emptiest replica, as seconds; <= 0
    disables scaling down."""
    return _env("MXNET_FLEET_SCALE_DOWN_WAIT_MS", default_ms, float) / 1e3


def fleet_restart_retries(default: int = 2) -> int:
    """``MXNET_FLEET_RESTART_RETRIES``: attempts beyond the first to
    restart a lost replica before it is retired."""
    return max(0, _env("MXNET_FLEET_RESTART_RETRIES", default, int))


# ---------------------------------------------------------------- events
class FleetEvent:
    """One lifecycle record: ``kind`` (spawn / replica_lost / failover /
    restart / restart_failed / replica_dead / drain / retire /
    preempt_drain / preempt_retire / scale_up / scale_down / swap_begin /
    swap_drain / swap_done / swap_abort / swap_complete), the replica it
    concerns (None: the whole fleet), the controller's clock and a
    detail dict."""

    __slots__ = ("kind", "replica", "t", "detail")

    def __init__(self, kind: str, replica: Optional[str], t: float,
                 detail: Optional[dict] = None):
        self.kind = kind
        self.replica = replica
        self.t = t
        self.detail = dict(detail) if detail else {}

    def __repr__(self):
        who = f" {self.replica}" if self.replica else ""
        return f"<FleetEvent {self.kind}{who} t={self.t:.3f} " \
               f"{self.detail}>"


class _Replica:
    """One replica's identity and lifecycle state (its supervisor does
    the serving)."""

    SERVING = "serving"
    DRAINING = "draining"
    RECOVERING = "recovering"
    RETIRED = "retired"
    STATES = (SERVING, DRAINING, RECOVERING, RETIRED)

    __slots__ = ("name", "index", "device", "sup", "scope", "version",
                 "state", "error", "_managed")

    def __init__(self, name, index, device, sup, scope, version):
        self.name = name
        self.index = index
        self.device = device
        self.sup = sup
        self.scope = scope
        self.version = version
        self.state = self.SERVING
        self.error: Optional[BaseException] = None
        self._managed = False    # a swap or a scale owns it now

    def routable(self) -> bool:
        if self.state != self.SERVING:
            return False
        b = self.sup.batcher
        if b._draining or b._stop.is_set() or b._dead is not None:
            return False
        br = self.sup.breaker
        return br is None or br.state != CircuitBreaker.OPEN


# ---------------------------------------------------------------- router
class FleetRouter:
    """Least-projected-wait router over a :class:`FleetController`'s
    serving replicas. ``submit()`` keeps the single replica's contract
    (the same typed errors and futures), and stamps ``fut.replica`` /
    ``fut.version`` with who served it."""

    def __init__(self, controller: "FleetController"):
        self._c = controller

    def submit(self, *args, deadline_ms: Optional[float] = None,
               timeout: Optional[float] = None):
        """Route one request to the serving replica with the lowest
        projected wait; a replica that sheds at admission is skipped and
        the next tried. ``Overloaded(reason="fleet")`` when none is
        available or every one rejected."""
        c = self._c
        c.poll()
        rows = DynamicBatcher._rows_of(args)
        cands = []
        with c._lock:
            for rep in c._replicas:
                if not rep.routable():
                    continue
                est = rep.sup.batcher.estimated_wait_s(rows)
                cands.append((est if est is not None else 0.0,
                              rep.index, rep))
        cands.sort(key=lambda t: (t[0], t[1]))
        if not cands:
            c.stats["rejected_fleet"] += 1
            raise Overloaded(
                "fleet: no replica can take traffic (all draining, "
                "recovering, retired, or breaker-open); retry after a "
                "backoff", reason="fleet")
        last: Optional[BaseException] = None
        for est, _idx, rep in cands:
            fault_point("serving.route", "before", ctx=rep.name)
            try:
                fut = rep.sup.submit(*args, deadline_ms=deadline_ms,
                                     timeout=timeout)
            except (Overloaded, ServingShutdown) as e:
                last = e
                continue
            fut.replica = rep.name
            fut.version = rep.version
            with c._lock:
                c.stats["routed"] += 1
                c.routed[rep.name] = c.routed.get(rep.name, 0) + 1
                c._note_wait(est)
            c._m_routed.inc(label=rep.name)
            c._m_queue_wait.observe(est)
            if c.autoscale:
                c.maybe_scale()
            return fut
        c.stats["rejected_fleet"] += 1
        raise Overloaded(
            f"fleet: every serving replica rejected the request "
            f"(last: {type(last).__name__}: {last})",
            reason="fleet") from last


# ---------------------------------------------------------------- controller
class FleetController:
    """N serving replicas behind one router::

        def build():                          # deterministic
            net = make_net()                  # on the current device
            return serving.CompiledPredictor(net, bucket_sizes=(1, 2, 4))

        fleet = serving.FleetController(build, example=(x_row,),
                                        replicas=3, max_batch=4)
        out = fleet.router.submit(x).result(30)
        fleet.swap_weights(ckpt_root)         # rolling, no recapture
        fleet.close()

    ``build()`` makes a FRESH predictor without naming its device: the
    controller runs it inside ``with Context(<replica device>):``, so a
    net built with ``device=None`` and its predictor land there.
    ``start=False`` drives every batcher by hand (:meth:`pump`, an
    injected ``clock=``); failover restarts then run inline without
    backoff.
    """

    def __init__(self, build: Callable,
                 example: Optional[Sequence] = None, *,
                 replicas: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 depth: Optional[int] = None,
                 inflight: Optional[int] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 autoscale: bool = False,
                 backoff_base: float = 0.05, backoff_max: float = 2.0,
                 clock: Callable[[], float] = time.perf_counter,
                 start: bool = True):
        from ..elastic import detect as _detect
        from ..parallel import dist as _dist
        self._build = build
        self._example = tuple(example) if example is not None else None
        self._batcher_kwargs = dict(max_batch=max_batch,
                                    timeout_ms=timeout_ms, depth=depth,
                                    inflight=inflight)
        self._clock = clock
        self._start = bool(start)
        self._detect = _detect
        self._dist = _dist
        self._backoff_base = float(backoff_base)
        self._backoff_max = float(backoff_max)
        self._lock = mx_rlock("serving.fleet")
        self._scale_lock = mx_lock("serving.fleet.scale")
        self._replicas: List[_Replica] = []
        self._restarts: List[threading.Thread] = []
        self._next_idx = 0
        self.version = 0         # the weight version (each swap adds one)
        self.autoscale = bool(autoscale)
        self.queue_wait_ewma: Optional[float] = None
        self.events: List[FleetEvent] = []
        #: requests routed to each replica, by name
        self.routed: Dict[str, int] = {}
        self.stats = {"routed": 0, "rejected_fleet": 0, "failovers": 0,
                      "requeued": 0, "failed_requeues": 0, "restarts": 0,
                      "swaps": 0, "scale_ups": 0, "scale_downs": 0,
                      "drains": 0}
        t = _telemetry
        reg = t.registry()
        self._m_replicas = reg.gauge(t.names.FLEET_REPLICAS,
                                     label_key="state")
        self._m_routed = reg.counter(t.names.FLEET_ROUTED,
                                     label_key="replica")
        self._m_restarts = reg.counter(t.names.FLEET_RESTARTS)
        self._m_swaps = reg.counter(t.names.FLEET_SWAPS)
        self._m_scale = reg.counter(t.names.FLEET_SCALE_EVENTS,
                                    label_key="direction")
        self._m_queue_wait = reg.histogram(t.names.FLEET_QUEUE_WAIT)
        n = fleet_replicas() if replicas is None else max(1, int(replicas))
        devs = _dist.available_devices()
        if n > len(devs):
            raise MXNetError(
                f"fleet: {n} replicas requested but only {len(devs)} "
                "device(s) available (MXNET_FLEET_REPLICAS)")
        self.min_replicas = fleet_min_replicas() if min_replicas is None \
            else max(1, int(min_replicas))
        mx_r = fleet_max_replicas() if max_replicas is None \
            else int(max_replicas)
        self.max_replicas = mx_r if mx_r > 0 else len(devs)
        for _ in range(n):
            dev = self._pick_device()
            if dev is None:      # pragma: no cover - guarded above
                raise MXNetError("fleet: ran out of devices mid-spawn")
            self._spawn(dev)
        self.router = FleetRouter(self)
        self._update_gauge()

    # ---------------- introspection ----------------
    @property
    def replicas(self) -> List[_Replica]:
        return list(self._replicas)

    def live(self) -> List[_Replica]:
        """The replicas able to take routed traffic now."""
        with self._lock:
            return [r for r in self._replicas if r.routable()]

    def state_counts(self) -> Dict[str, int]:
        """Replicas in each lifecycle state."""
        with self._lock:
            counts = {s: 0 for s in _Replica.STATES}
            for r in self._replicas:
                counts[r.state] += 1
            return counts

    def _update_gauge(self):
        """``mx_fleet_replicas{state}`` from a copy of the replica list,
        without the fleet's lock (an event may be recorded under a
        batcher's lock, which the fleet's never nests in)."""
        counts = {s: 0 for s in _Replica.STATES}
        for r in list(self._replicas):
            counts[r.state] += 1
        for st, n in counts.items():
            self._m_replicas.set(float(n), label=st)

    def describe(self) -> dict:
        """A structured snapshot of the fleet."""
        with self._lock:
            reps = [{
                "name": r.name, "state": r.state,
                "device": str(r.device), "version": r.version,
                "breaker": r.sup.breaker.state
                if r.sup.breaker else None,
                "queued": r.sup.batcher._queue.qsize()
                + len(r.sup.batcher._forming),
                "inflight": len(r.sup.batcher._window),
                "est_wait_s": r.sup.batcher.estimated_wait_s(1),
                "routed": self.routed.get(r.name, 0),
                "error": f"{type(r.error).__name__}: {r.error}"
                if r.error else None,
            } for r in self._replicas]
        return {"replicas": reps, "version": self.version,
                "states": self.state_counts(),
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "autoscale": self.autoscale,
                "queue_wait_ewma_s": self.queue_wait_ewma,
                "stats": dict(self.stats),
                "events": [repr(e) for e in self.events[-16:]]}

    # ---------------- lifecycle plumbing ----------------
    def _event(self, kind: str, replica: Optional[str],
               detail: Optional[dict] = None):
        ev = FleetEvent(kind, replica, self._clock(), detail)
        if len(self.events) < 1024:
            self.events.append(ev)
        self._update_gauge()
        _LOG.info("fleet: %s%s %s", kind,
                  f" [{replica}]" if replica else "", ev.detail)

    def _note_wait(self, est: float):
        w = max(0.0, float(est))
        self.queue_wait_ewma = w if self.queue_wait_ewma is None \
            else 0.2 * w + 0.8 * self.queue_wait_ewma

    def _pick_device(self, exclude: Optional[_Replica] = None):
        """A device no live replica holds (revoked ones are already out
        of ``available_devices()``)."""
        used = {r.device for r in self._replicas
                if r is not exclude and r.state != _Replica.RETIRED}
        for d in self._dist.available_devices():
            if d not in used:
                return d
        return None

    def _pinned_build(self, device) -> Callable:
        base = self._build

        def build():
            from ..context import Context
            from .predictor import device_scope
            # the replica's card is the default device and the current
            # CUDA device inside, the caller's again after
            with Context("gpu" if device.type == "cuda" else "cpu",
                         device.index or 0), device_scope(device):
                return base()
        return build

    def _make_supervisor(self, device, scope) -> ServingSupervisor:
        return ServingSupervisor(
            self._pinned_build(device), example=self._example,
            drain_on_preemption=scope, clock=self._clock,
            start=self._start, **self._batcher_kwargs)

    def _wire(self, rep: _Replica):
        """Device loss on the replica fails over to the FLEET (not a
        rebuild in place), and its chaos seams carry its name."""
        b = rep.sup.batcher
        b.on_batch_failure = partial(self._on_replica_failure, rep)
        b.fault_ctx = rep.name

    def _spawn(self, device) -> _Replica:
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        name = f"replica-{idx}"
        scope = f"fleet/{name}"
        self._detect.notice(scope).clear()
        sup = self._make_supervisor(device, scope)
        rep = _Replica(name, idx, device, sup, scope, self.version)
        self._wire(rep)
        with self._lock:
            self._replicas.append(rep)
        self._event("spawn", name, {"device": str(device)})
        return rep

    # ---------------- replica-loss failover ----------------
    def _on_replica_failure(self, rep: _Replica, reqs, exc,
                            seam: str) -> bool:
        """The batcher's hook (on that replica's dispatcher thread):
        ``transient`` retries in place through the replica's supervisor,
        ``device_lost`` fails over to the survivors, anything else fails
        the futures."""
        cause = self._detect.classify(exc)
        if cause == "transient":
            return rep.sup._retry_transient(list(reqs), exc, seam)
        if cause != "device_lost":
            return False
        self._failover(rep, list(reqs), exc, seam)
        return True

    def _failover(self, rep: _Replica, reqs, exc, seam: str):
        """Move the lost replica's riders and queue onto the survivors
        exactly once, stop its batcher, free its graphs, and restart it
        on a spare device (a background thread; inline under manual
        drive)."""
        with self._lock:
            rep.state = _Replica.RECOVERING
            rep.error = exc
            self._event("replica_lost", rep.name, {
                "seam": seam, "error": f"{type(exc).__name__}: {exc}"})
            rep.sup.breaker.trip("fleet failover")
            self._detect.maybe_record_device_lost(exc, f"fleet {seam}")
            b = rep.sup.batcher
            # admit nothing more there: a submit enqueueing now lands
            # before the steal below (the router goes to the next one)
            b._close_admission()
            riders = list(reqs) + b.abandon_inflight()
            # on the dispatcher thread, the forming list's one owner
            b._drain_queue()
            riders += b._forming
            b._forming = []
            seen, uniq = set(), []
            for r in riders:
                if id(r) not in seen:
                    seen.add(id(r))
                    uniq.append(r)
            uniq.sort(key=lambda r: r.t_submit)
            b._stop.set()        # the dispatch loop exits after this
            moved = failed = 0
            for r in uniq:
                if r.future.done():
                    # resolved at dispatch: its copies of the outputs
                    # are its own, or it failed typed already
                    continue
                if r.requeues >= 1:
                    self.stats["failed_requeues"] += 1
                    r.future._fail(MXNetError(
                        f"serving request lost to repeated device "
                        f"failure (re-enqueued {r.requeues}x): "
                        f"{type(exc).__name__}: {exc}"))
                    failed += 1
                    continue
                target = self._pick_target(rep, r.rows)
                if target is None:
                    self.stats["failed_requeues"] += 1
                    r.future._fail(Overloaded(
                        "fleet failover: no surviving replica could "
                        "absorb this request", reason="fleet"))
                    failed += 1
                    continue
                r.requeues += 1
                r.future._rearm()
                r.future.replica = target.name
                r.future.version = target.version
                try:
                    target.sup.batcher._queue.put_nowait(r)
                except queue.Full:
                    self.stats["failed_requeues"] += 1
                    r.future._fail(Overloaded(
                        "fleet failover: survivor queue saturated",
                        reason="fleet"))
                    failed += 1
                    continue
                moved += 1
            # nothing can have entered since the steal; kept as the
            # batcher's close does it
            b._fail_pending(ServingShutdown(
                "replica lost; request arrived during fleet failover"))
            self.stats["failovers"] += 1
            self.stats["requeued"] += moved
            self._event("failover", rep.name, {
                "seam": seam, "moved": moved, "failed": failed})
        _release(rep.sup.predictor)
        if self._start:
            t = threading.Thread(
                target=self._restart_replica, args=(rep, exc),
                name=f"mxt-fleet-restart-{rep.name}", daemon=True)
            self._restarts.append(t)
            t.start()
        else:
            self._restart_replica(rep, exc, backoff=False)

    def _pick_target(self, rep: _Replica, rows: int) -> \
            Optional[_Replica]:
        """The surviving replica with the lowest projected wait (failover
        bypasses the router: the riders were admitted once)."""
        best, best_w = None, None
        for r in self._replicas:
            if r is rep or not r.routable():
                continue
            w = r.sup.batcher.estimated_wait_s(rows)
            w = 0.0 if w is None else w
            if best_w is None or w < best_w:
                best, best_w = r, w
        return best

    def _restart_replica(self, rep: _Replica, exc, backoff: bool = True):
        """Restart on a spare device with bounded retries: a fresh
        supervisor (fresh predictor, every bucket captured on its card,
        fresh breaker). A ``fatal`` / ``oom`` build failure retires the
        replica with the error recorded."""
        attempts = max(1, fleet_restart_retries() + 1)
        delay = self._backoff_base
        last = exc
        t0 = time.monotonic()
        for i in range(attempts):
            try:
                dev = self._pick_device(exclude=rep)
                if dev is None:
                    raise MXNetError(
                        "fleet: no spare device to restart "
                        f"{rep.name} on (the world shrank)")
                self._detect.notice(rep.scope).clear()
                sup = self._make_supervisor(dev, rep.scope)
                with self._lock:
                    rep.sup = sup
                    rep.device = dev
                    rep.version = self.version
                    rep.error = None
                    self._wire(rep)
                    rep.state = _Replica.SERVING
                    self.stats["restarts"] += 1
                    self._m_restarts.inc()
                    self._event("restart", rep.name, {
                        "device": str(dev), "attempt": i + 1,
                        "restart_s": time.monotonic() - t0})
                return
            except Exception as e:   # noqa: BLE001 - classified below
                last = e
                cause = self._detect.classify(e)
                _LOG.warning(
                    "fleet: restart of %s attempt %d/%d failed "
                    "(%s: %s; cause=%s)", rep.name, i + 1, attempts,
                    type(e).__name__, e, cause)
                if cause in ("fatal", "oom"):
                    break        # a retry cannot cure these
                if backoff and delay > 0:
                    time.sleep(delay)
                    delay = min(self._backoff_max, delay * 2)
        with self._lock:
            rep.state = _Replica.RETIRED
            rep.error = last
            self._event("restart_failed", rep.name, {
                "error": f"{type(last).__name__}: {last}",
                "attempts": attempts})

    def wait_restarts(self, timeout: float = 600.0) -> bool:
        """Wait (bounded) for every background restart to end; True when
        none is left running."""
        end = time.monotonic() + timeout
        for t in list(self._restarts):
            t.join(max(0.0, end - time.monotonic()))
        self._restarts = [t for t in self._restarts if t.is_alive()]
        return not self._restarts

    # ---------------- drain / retire / preemption ----------------
    def drain_then_retire(self, rep: _Replica, cause: str = "manual"):
        """Flush the replica's accepted requests, reject new, retire it
        and free its graphs."""
        with self._lock:
            if rep.state == _Replica.RETIRED:
                return
            rep.state = _Replica.DRAINING
            rep._managed = True
            self._event("drain", rep.name, {"cause": cause})
        try:
            rep.sup.drain()
            self.stats["drains"] += 1
        finally:
            with self._lock:
                rep.state = _Replica.RETIRED
                rep._managed = False
                self._event("retire", rep.name, {"cause": cause})
            _release(rep.sup.predictor)

    def poll(self):
        """Housekeeping (the router calls it on every submit): note the
        replicas whose dispatcher drained on a scoped notice or died,
        and under manual drive run the scoped drain here."""
        to_drain: List[_Replica] = []
        with self._lock:
            for rep in self._replicas:
                if rep._managed:
                    continue
                b = rep.sup.batcher
                if rep.state == _Replica.SERVING:
                    if b._dead is not None:
                        rep.state = _Replica.RETIRED
                        rep.error = b._dead
                        self._event("replica_dead", rep.name, {
                            "error": f"{type(b._dead).__name__}: "
                                     f"{b._dead}"})
                    elif b._stop.is_set():
                        rep.state = _Replica.RETIRED
                        self._event("preempt_retire", rep.name, {})
                    elif b._draining:
                        rep.state = _Replica.DRAINING
                        self._event("preempt_drain", rep.name, {})
                    elif not self._start and \
                            self._detect.notice(rep.scope).requested():
                        to_drain.append(rep)
                elif rep.state == _Replica.DRAINING and \
                        b._stop.is_set():
                    rep.state = _Replica.RETIRED
                    self._event("preempt_retire", rep.name, {})
        for rep in to_drain:
            self.drain_then_retire(rep, cause="preemption")

    # ---------------- autoscaling ----------------
    def maybe_scale(self) -> Optional[str]:
        """One autoscale decision from the queue-wait EWMA: ``"up"``
        (spawned a replica), ``"down"`` (drained and retired the
        emptiest) or None. Never waits on a scale already running."""
        ewma = self.queue_wait_ewma
        if ewma is None:
            return None
        if not self._scale_lock.acquire(blocking=False):
            return None
        try:
            with self._lock:
                serving = [r for r in self._replicas
                           if r.state == _Replica.SERVING]
            n = len(serving)
            if ewma >= fleet_scale_up_wait_s() and n < self.max_replicas:
                dev = self._pick_device()
                if dev is None:
                    return None
                rep = self._spawn(dev)
                self.stats["scale_ups"] += 1
                self._m_scale.inc(label="up")
                self._event("scale_up", rep.name, {
                    "queue_wait_ewma_s": ewma, "serving": n + 1})
                return "up"
            down = fleet_scale_down_wait_s()
            if down > 0 and ewma <= down and n > self.min_replicas:
                empt = min(serving, key=lambda r: (
                    r.sup.batcher.estimated_wait_s(0) or 0.0, -r.index))
                self.stats["scale_downs"] += 1
                self._m_scale.inc(label="down")
                self._event("scale_down", empt.name, {
                    "queue_wait_ewma_s": ewma, "serving": n - 1})
                self.drain_then_retire(empt, cause="scale_down")
                return "down"
            return None
        finally:
            self._scale_lock.release()

    # ---------------- rolling weight swap ----------------
    def swap_weights(self, checkpoint: str) -> dict:
        """Roll new weights out one replica at a time. The checkpoint is
        validated FIRST: a corrupt one raises
        :class:`~mxnet_tpu_torch.checkpoint.CheckpointCorruptError` with
        every replica on the old weights. A replica whose copy fails is
        put back on its old weights bit for bit and the error raised,
        with the fleet still serving.

        ``checkpoint``: a committed step directory, or a checkpoint root
        (its newest valid step)."""
        from ..checkpoint import atomic as _atomic
        path = self._resolve_checkpoint(checkpoint)
        _atomic.validate_checkpoint(path)    # corrupt -> typed abort
        arrays, manifest = _atomic.read_checkpoint(path)
        params = {k: v for k, v in arrays.items() if k.startswith("param/")}
        if not params:
            raise MXNetError(f"fleet swap: checkpoint {path} holds no "
                             "param/ arrays: nothing to roll out")
        array_meta = {k: v for k, v in manifest["arrays"].items()
                      if k.startswith("param/")}
        new_version = self.version + 1
        t0 = time.monotonic()
        self._event("swap_begin", None, {"path": path,
                                         "version": new_version})
        swapped = 0
        for rep in list(self._replicas):
            if rep.state != _Replica.SERVING:
                continue
            self._swap_one(rep, params, array_meta,
                           manifest.get("meta", {}), new_version)
            swapped += 1
        self.version = new_version
        self.stats["swaps"] += 1
        self._m_swaps.inc()
        duration = time.monotonic() - t0
        self._event("swap_complete", None, {
            "version": new_version, "replicas": swapped,
            "duration_s": duration})
        return {"version": new_version, "replicas": swapped, "path": path,
                "duration_s": duration}

    @staticmethod
    def _resolve_checkpoint(checkpoint: str) -> str:
        from ..checkpoint import atomic as _atomic
        p = os.path.abspath(checkpoint)
        if os.path.exists(os.path.join(p, _atomic.MANIFEST)):
            return p
        found = _atomic.latest_valid(p)
        if found is None:
            raise MXNetError(f"fleet swap: no valid checkpoint under {p}")
        return found[1]

    def _swap_one(self, rep: _Replica, params, array_meta, meta,
                  new_version: int):
        from ..checkpoint import state as _ckstate
        with self._lock:
            rep.state = _Replica.DRAINING
            rep._managed = True
            self._event("swap_drain", rep.name, {"version": new_version})
        try:
            rep.sup.drain()      # accepted traffic finishes on the OLD
            pred = rep.sup.predictor
            net = getattr(pred, "net", None)
            if net is None:
                raise MXNetError(
                    f"fleet swap: {rep.name}'s predictor exposes no net "
                    "to load weights into")
            # every replay in flight retired before a weight is written
            synchronize(pred.device)
            plist = list(net.parameters())
            saved = [p.detach().clone() for p in plist]
            try:
                st = _ckstate.TrainState(dict(params), dict(meta),
                                         dict(array_meta))
                arrays = _ckstate.assemble_segments(st.arrays,
                                                    st.array_meta)
                # in place: the captured graphs keep reading the storage
                _ckstate._apply_params(st, arrays, None, net, strict=True)
            except BaseException:
                with torch.no_grad():
                    for p, old in zip(plist, saved):
                        p.copy_(old)   # the old weights, bit for bit
                raise
            finally:
                del saved
            self._respawn_batcher(rep)
            self._warm_probe(rep)
            with self._lock:
                rep.version = new_version
                rep.state = _Replica.SERVING
                rep._managed = False
                self._event("swap_done", rep.name,
                            {"version": new_version})
        except BaseException as e:
            try:
                self._respawn_batcher(rep)
            except Exception:    # pragma: no cover - defensive
                _LOG.warning("fleet: batcher respawn after an aborted "
                             "swap failed", exc_info=True)
            with self._lock:
                rep.state = _Replica.SERVING
                rep._managed = False
                self._event("swap_abort", rep.name, {
                    "error": f"{type(e).__name__}: {e}"})
            raise

    def _respawn_batcher(self, rep: _Replica):
        """A fresh batcher after a drain (the drained one is closed); the
        admission EWMA carries over: same predictor, same service
        time."""
        sup = rep.sup
        old = sup._batcher
        b = DynamicBatcher(sup.predictor, clock=self._clock,
                           start=self._start, **self._batcher_kwargs)
        b.breaker = sup.breaker
        b.on_batch_retired = sup._on_batch_retired
        b.drain_check = self._detect.notice(rep.scope).requested
        if old is not None and old._ewma_service is not None:
            b._ewma_service = old._ewma_service
        sup._batcher = b
        sup._closed = False
        self._wire(rep)

    def _warm_probe(self, rep: _Replica):
        """One forward through the swapped predictor before it rejoins:
        a weight / architecture mismatch surfaces here (rolled back by
        the caller), not on traffic."""
        if self._example is None:
            return
        pred = rep.sup.predictor
        padded, _rows = pred.pad_to_bucket(*self._example)
        out = pred.predict(*padded)
        synchronize(pred.device)
        bad = []
        map_tensors(lambda t: bad.append(1) if t.is_floating_point()
                    and not bool(torch.isfinite(t).all()) else None, out)
        if bad:
            raise MXNetError(f"fleet swap: {rep.name}'s warm probe gave "
                             "non-finite outputs")

    # ---------------- manual drive + shutdown ----------------
    def pump(self, force: bool = False) -> bool:
        """Manual drive (``start=False``): one dispatch pass and a window
        retire on every serving replica, then :meth:`poll`. Returns
        whether any replica dispatched a batch."""
        did = False
        for rep in list(self._replicas):
            if rep.state != _Replica.SERVING:
                continue
            b = rep.sup.batcher
            if b._stop.is_set() or b._dead is not None:
                continue
            if b.process_once(force=force):
                did = True
            if rep.state == _Replica.SERVING and len(b._window):
                b._retire_all()
        self.poll()
        return did

    def drain(self):
        """Graceful fleet shutdown: drain every replica (accepted
        requests flush), retire all."""
        for rep in list(self._replicas):
            if rep.state in (_Replica.SERVING, _Replica.DRAINING):
                self.drain_then_retire(rep, cause="shutdown")

    def close(self):
        self.wait_restarts(timeout=600.0)
        for rep in list(self._replicas):
            if rep.state != _Replica.RETIRED:
                try:
                    rep.sup.close()
                except Exception:    # pragma: no cover - defensive
                    _LOG.warning("fleet: close of %s failed", rep.name,
                                 exc_info=True)
                rep.state = _Replica.RETIRED
            _release(rep.sup.predictor)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
