"""The elastic training supervisor: keep a run alive across device loss
(counterpart of ``mxnet_tpu/elastic/supervisor.py``).

State machine of one ``run()``::

        FORM ──────────► TRAIN ──────────► DONE
          ▲      build +   │  step loop,     (final checkpoint)
          │      restore   │  probes
          │                ├── preemption notice ──► GRACE SAVE ► exit
          │                ├── world grew ──► planned re-form ─┐
          │                └── device_lost / transient ──►     │
          │                    RECOVER ────────────────────────┤
          └────────────────────────────────────────────────────┘
               discard what is in flight, bounded retries with
               exponential backoff, re-form at the surviving world,
               restore the newest valid checkpoint (dp N -> dp M)

Every recovery leaves one :class:`RecoveryLog` event ``{cause,
lost_devices, old_dp, new_dp, restored_step, discarded_steps,
downtime_s, step, time_unix}``.

**The process model differs from the JAX package's.** Its supervisor is
one controller that re-forms a mesh of devices inside its process. The
port runs one process a card, so:

- with ``mesh_axes=None`` the supervisor runs in its own process on one
  device: its own ``TrainLoop``, restore, continue (the reference's
  state machine as it is);
- with a mesh the supervisor stays in the parent, and each formation is
  one ``parallel.dist.spawn`` of ``len(available_devices())`` ranks
  (capped by ``max_world``), rank r on the r-th surviving device. Every
  rank runs ``build()``, then ``TrainLoop(checkpoint_dir=...,
  resume=True)``, then steps ``batch_fn(i)``; rank 0 returns its
  per-step losses as floats. A rank's failure ends the formation
  (``spawn`` kills the others); the parent classifies it from the
  cause each failed rank wrote (a rank that saw only its peer go away
  is not the cause, and a rank that died with no exception of its own,
  e.g. killed, leaves none, so the failure propagates), logs it, backs
  off and forms again at the surviving world. The ranks agree at each
  step boundary, over a small gloo group on the CPU beside NCCL and
  with no device sync, whether to stop there (a preemption notice, a
  world that grew), so every rank stops at the same step. The run's
  revoked devices and fired fault rules are shared through the file
  ``testing.faults`` reads from ``MXNET_FAULT_STATE``, so a rule fires
  once a run, not once a process. A formation's checkpoints are written
  before its next step dispatches (not in the background): a failing
  rank ends the others at once, and a background write on rank 0 would
  die with it. ``build`` and ``batch_fn`` must be picklable
  (module-level functions).

Nothing continues on the CPU when the cards are gone: below
``min_devices`` the supervisor raises.

**Stall escalation** (``stall_escalation=N > 0``): the supervisor
subscribes to the telemetry watchdog (``telemetry.watchdog().subscribe``;
its stall detector runs with ``MXNET_TELEMETRY``) and counts ``stall``
episodes; at the N-th since the last recovery the next step boundary
raises :class:`StallEscalation`, classified ``stall`` and recovered like
a lost device: the world is treated as unhealthy, torn down, re-formed
and restored. In a formation each rank counts its own watchdog's
episodes and the ranks agree at the step boundary (the flag rides the
boundary's all-reduce), so every rank stops at the same step.

Telemetry: ``mx_elastic_recoveries_total{cause}``,
``mx_elastic_downtime_seconds``, ``mx_elastic_world_size`` and
``mx_elastic_preemptions_total``; :class:`RecoveryLog` keeps its
``counts`` and ``world_size`` beside them.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..parallel import dist as _dist
from ..testing import faults
from . import detect

__all__ = ["ElasticSupervisor", "ElasticResult", "RecoveryLog",
           "StallEscalation", "recovery_log"]

_LOG = logging.getLogger("mxnet_tpu_torch.elastic")

class StallEscalation(MXNetError):
    """Raised at a step boundary once ``stall_escalation`` watchdog stall
    episodes accumulated: the world is unhealthy (``detect.classify``
    maps it to ``stall``, which the supervisor recovers)."""


# ---------------------------------------------------------------- log
class RecoveryLog:
    """Bounded ring of recovery events (the JAX package's schema), in the
    ``mx_elastic_*`` series too; :attr:`world_size` holds the last
    world, :attr:`counts` the events by cause."""

    def __init__(self, max_events: int = 256):
        self._lock = threading.Lock()
        self._events: "deque[dict]" = deque(maxlen=max_events)
        self.world_size = 0
        self.counts: dict = {}
        t = _telemetry
        reg = t.registry()
        self._c_rec = reg.counter(t.names.ELASTIC_RECOVERIES,
                                  label_key="cause")
        self._h_down = reg.histogram(t.names.ELASTIC_DOWNTIME_SECONDS)
        self._g_world = reg.gauge(t.names.ELASTIC_WORLD_SIZE)

    def record(self, cause: str, lost_devices: List[str], old_dp: int,
               new_dp: int, restored_step: int, downtime_s: float,
               discarded_steps: int = 0, step=None) -> dict:
        evt = {"cause": cause, "lost_devices": list(lost_devices),
               "old_dp": int(old_dp), "new_dp": int(new_dp),
               "restored_step": int(restored_step),
               "discarded_steps": int(discarded_steps),
               "downtime_s": float(downtime_s), "step": step,
               "time_unix": time.time()}
        with self._lock:
            self._events.append(evt)
            self.counts[cause] = self.counts.get(cause, 0) + 1
            self.world_size = int(new_dp)
        self._c_rec.inc(label=cause)
        self._h_down.observe(float(downtime_s))
        self._g_world.set(int(new_dp))
        _LOG.warning("mx-recovery %s", json.dumps(evt))
        return evt

    def set_world(self, n: int):
        with self._lock:
            self.world_size = int(n)
        self._g_world.set(int(n))

    def events(self, cause: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if cause is None else [e for e in evs
                                          if e["cause"] == cause]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()
            self.counts.clear()

    def table(self) -> str:
        """The events as a table."""
        evs = self.events()
        if not evs:
            return "(no recovery events)"
        hdr = (f"{'cause':<12} {'lost':>4} {'dp':>7} {'restored':>8} "
               f"{'discard':>7} {'downtime':>10}")
        rows = [hdr, "-" * len(hdr)]
        for e in evs:
            rows.append(
                f"{e['cause']:<12} {len(e['lost_devices']):>4} "
                f"{e['old_dp']:>3}->{e['new_dp']:<3} "
                f"{e['restored_step']:>8} {e['discarded_steps']:>7} "
                f"{e['downtime_s'] * 1e3:>8.1f}ms")
        return "\n".join(rows)


_log: Optional[RecoveryLog] = None
_log_lock = threading.Lock()


def recovery_log() -> RecoveryLog:
    """The process-global recovery log (every supervisor records here
    unless given its own)."""
    global _log
    with _log_lock:
        if _log is None:
            _log = RecoveryLog()
        return _log


# ---------------------------------------------------------------- result
class ElasticResult:
    """What one ``ElasticSupervisor.run`` produced."""

    def __init__(self, losses: dict, events: List[dict], preempted: bool,
                 final_step: int, world_size: int, retries: int):
        self.losses = losses            # step index -> summed loss
        self.events = events            # this run's RecoveryLog events
        self.preempted = preempted
        self.final_step = final_step
        self.world_size = world_size
        self.retries = retries

    @property
    def recoveries(self) -> int:
        return len(self.events)

    def __repr__(self):
        return (f"ElasticResult(final_step={self.final_step}, "
                f"world={self.world_size}, recoveries={self.recoveries},"
                f" preempted={self.preempted})")


def _sum_loss(h) -> float:
    return float(h.detach().double().sum())


# ---------------------------------------------------------------- supervisor
class ElasticSupervisor:
    """Keep a training run alive across device loss, preemption and
    transient step failures::

        def build():                       # deterministic: seed inside
            torch.manual_seed(7)
            net = ...
            trainer = gluon.Trainer(dict(net.named_parameters()), "adam",
                                    {"learning_rate": 1e-3})
            return net, trainer, gluon.loss.SoftmaxCrossEntropyLoss()

        sup = elastic.ElasticSupervisor(build, "ckpts/run1",
                                        mesh_axes={"dp": -1},
                                        checkpoint_every=50)
        result = sup.run(batch_fn, total_steps=10_000)

    ``build()`` makes a FRESH (net, trainer, loss) on this process's
    device at every formation, the same every time: the restored
    checkpoint overwrites parameters, optimizer state and RNG, so a
    recovery is bit-exact from the restored step. ``batch_fn(i)``
    returns step i's (global) batch and can be asked again for any i.

    ``mesh_axes`` (e.g. ``{"dp": -1}``, sized to the surviving world at
    each formation; ``None``: in-process on one device), ``device`` the
    kind of the world (``"cuda"``; ``"cpu"`` for gloo ranks standing in
    for cards, their number ``MXNET_CPU_DEVICES``), ``max_retries`` /
    ``backoff_base`` / ``backoff_max`` (bounded exponential backoff; a
    step past the restored one resets the budget), ``min_devices``
    (below it the world is lost), ``max_world`` (caps a formation),
    ``grow`` / ``probe_every`` (re-form larger when devices come back),
    ``recover`` (default ``MXNET_ELASTIC``; False propagates every
    failure), ``formation_timeout_s`` (a formation that has not ended
    by then is killed and the run fails)."""

    RECOVERABLE = ("device_lost", "transient", "stall")

    def __init__(self, build: Callable, checkpoint_dir: str, *,
                 mesh_axes: Optional[dict] = None, axis: str = "dp",
                 checkpoint_every: Optional[int] = 10, keep_last: int = 3,
                 max_retries: Optional[int] = None,
                 backoff_base: float = 0.5, backoff_max: float = 30.0,
                 min_devices: int = 1, max_world: Optional[int] = None,
                 grow: bool = True, probe_every: int = 1,
                 stall_escalation: int = 0,
                 inflight: Optional[int] = None,
                 record_losses: bool = True,
                 final_checkpoint: bool = True,
                 recover: Optional[bool] = None,
                 log: Optional[RecoveryLog] = None,
                 device: str = "cuda",
                 formation_timeout_s: float = 3600.0):
        self._build = build
        self._stall_escalation = max(0, int(stall_escalation))
        self._stall_count = 0
        self._escalate = False
        self._dir = os.path.abspath(checkpoint_dir)
        self._mesh_axes = dict(mesh_axes) if mesh_axes else None
        self._axis = axis
        self._every = checkpoint_every
        self._keep = keep_last
        self._max_retries = detect.max_retries() if max_retries is None \
            else max(0, int(max_retries))
        self._backoff_base = float(backoff_base)
        self._backoff_max = float(backoff_max)
        self._min_devices = max(1, int(min_devices))
        self._max_world = max_world
        self._grow = grow
        self._probe_every = max(0, int(probe_every))
        self._inflight = inflight
        self._record_losses = record_losses
        self._final_checkpoint = final_checkpoint
        self._recover = detect.elastic_enabled() if recover is None \
            else bool(recover)
        self._log = log if log is not None else recovery_log()
        self._kind = _dist._kind(device)
        # in process the teardown waits for a background write; across
        # processes a failure kills rank 0's writer with it
        self._async_ckpt = self._mesh_axes is None
        self._formation_timeout_s = float(formation_timeout_s)
        self._preempt = detect.notice()

        self._loop = None
        self._world: List = []
        self._loss_handles: dict = {}
        self._losses: dict = {}
        self._pending: Optional[dict] = None
        self._retries = 0
        self._total_retries = 0
        self._recovered_at = 0
        self._events_before = 0
        self._final_step = 0

    # ---------------- public surface ----------------
    @property
    def world_size(self) -> int:
        """Devices of the current (last) formation."""
        return len(self._world)

    @property
    def dp_size(self) -> int:
        """Data-parallel width of the current formation (1 in-process)."""
        if self._mesh_axes is None:
            return 1 if self._world else 0
        return len(self._world)

    @property
    def loop(self):
        """The in-process TrainLoop (None between a failure and the next
        formation, and always with a mesh: the loops live in the
        ranks)."""
        return self._loop

    @property
    def recovery_log(self) -> RecoveryLog:
        return self._log

    @property
    def preemption(self) -> detect.PreemptionNotice:
        return self._preempt

    # ---------------- run ----------------
    def run(self, batch_fn: Callable, total_steps: int) -> ElasticResult:
        """Drive the run to ``total_steps`` (or a graceful preemption
        exit), recovering on the way. Raises when the failure is fatal,
        the retry budget is spent, too few devices survive, or recovery
        is off."""
        wd = _telemetry.watchdog()
        if self._stall_escalation and self._mesh_axes is None:
            wd.subscribe(self._on_anomaly)
        self._preempt.install()
        self._loss_handles, self._losses = {}, {}
        self._retries = self._total_retries = 0
        self._stall_count, self._escalate = 0, False
        self._events_before = len(self._log)
        try:
            if self._mesh_axes is None:
                preempted = self._run_in_process(batch_fn, total_steps)
            else:
                preempted = self._run_formations(batch_fn, total_steps)
        finally:
            self._preempt.uninstall()
            wd.unsubscribe(self._on_anomaly)
        return ElasticResult(
            losses=self._finalize_losses(), preempted=preempted,
            events=self._log.events()[self._events_before:],
            final_step=self._final_step, world_size=self.world_size,
            retries=self._total_retries)

    def _target_devices(self) -> List:
        devs = _dist.available_devices(self._kind)
        if self._max_world is not None:
            devs = devs[:self._max_world]
        return devs

    def _check_world(self, devs):
        if len(devs) < self._min_devices:
            raise MXNetError(
                f"elastic: only {len(devs)} {self._kind} device(s) "
                f"survive, below min_devices={self._min_devices}; cannot "
                "re-form (nothing continues on another device kind)")

    def _recoverable(self, cause: str, exc: BaseException) -> bool:
        return self._recover and cause in self.RECOVERABLE

    def _on_anomaly(self, evt: dict):
        """Watchdog-channel callback: counts ``stall`` episodes and sets
        the flag the next step boundary turns into a recovery."""
        if evt.get("kind") != "stall":
            return
        self._stall_count += 1
        if self._stall_count >= self._stall_escalation > 0:
            self._escalate = True

    def _check_escalation(self):
        if self._escalate:
            self._escalate = False
            raise StallEscalation(
                f"{self._stall_count} watchdog stall episode(s) since the "
                f"last recovery (threshold {self._stall_escalation}): "
                "treating the world as unhealthy")

    def _count_retry(self, exc, cause):
        """One more recovery attempt: check the budget, back off."""
        self._stall_count, self._escalate = 0, False
        self._retries += 1
        self._total_retries += 1
        if self._retries > self._max_retries:
            raise MXNetError(
                f"elastic: recovery budget exhausted ({self._retries - 1}"
                f" consecutive attempts, MXNET_ELASTIC_MAX_RETRIES="
                f"{self._max_retries}); last failure: "
                f"{type(exc).__name__}: {exc}") from exc
        delay = min(self._backoff_max,
                    self._backoff_base * (2 ** (self._retries - 1)))
        _LOG.warning("elastic: %s (%s: %s); recovery attempt %d/%d in "
                     "%.1fs", cause, type(exc).__name__, exc, self._retries,
                     self._max_retries, delay)
        if delay > 0:
            time.sleep(delay)

    def _complete_pending(self, restored: int, restored_unix: float):
        """Record the pending recovery's event once the next formation
        has restored."""
        if self._pending is None:
            return
        p, self._pending = self._pending, None
        self._log.record(
            cause=p["cause"], lost_devices=p["lost"], old_dp=p["old_dp"],
            new_dp=self.dp_size, restored_step=restored,
            discarded_steps=p["discarded"],
            downtime_s=restored_unix - p["t0"], step=p["step"])
        _LOG.warning("elastic: recovered (%s) at dp=%d, restored step %d",
                     p["cause"], self.dp_size, restored)

    def _lost_since(self, old_world) -> List[str]:
        alive = {d.index for d in _dist.available_devices(self._kind)}
        return [str(d) for d in old_world if d.index not in alive]

    # ---------------- in-process: one device ----------------
    def _run_in_process(self, batch_fn, total_steps) -> bool:
        while True:
            try:
                outcome = self._segment(batch_fn, total_steps)
            except BaseException as e:
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                cause = detect.classify(e)
                if not self._recoverable(cause, e):
                    raise
                self._begin_recovery(cause, e)
                continue
            if outcome == "reform":
                continue
            return outcome == "preempted"

    def _segment(self, batch_fn, total_steps) -> str:
        self._form()
        loop = self._loop
        start = loop.global_step
        for i in range(start, total_steps):
            if self._preempt.requested():
                self._graceful_preempt(loop)
                return "preempted"
            self._check_escalation()
            if self._grow and self._probe_every and i > start \
                    and (i - start) % self._probe_every == 0 \
                    and self._world_grew():
                self._planned_reform(loop)
                return "reform"
            loss = loop.step(*batch_fn(i))
            if self._record_losses:
                self._loss_handles[i] = loss
            self._final_step = loop.global_step
            if self._retries and loop.global_step > self._recovered_at:
                self._retries = 0   # forward progress resets the budget
        self._finish(loop)
        return "done"

    def _form(self):
        """FORM: the surviving device, a fresh (net, trainer, loss), the
        newest valid checkpoint; completes a pending recovery's event."""
        from ..gluon.fused_step import TrainLoop
        devs = self._target_devices()
        self._check_world(devs)
        self._world = devs[:1]
        self._log.set_world(1)
        net, trainer, loss_blk = self._build()
        self._loop = TrainLoop(
            net, trainer, loss_blk, checkpoint_dir=self._dir,
            checkpoint_every=self._every, keep_last=self._keep,
            async_checkpoint=self._async_ckpt, resume=True,
            inflight=self._inflight)
        self._recovered_at = self._final_step = self._loop.global_step
        if self._pending is not None:
            restored = self._loop.global_step
            # replayed steps overwrite their slots; the discarded ones'
            # handles go
            for k in [k for k in self._loss_handles if k >= restored]:
                del self._loss_handles[k]
            self._complete_pending(restored, time.time())

    def _world_grew(self) -> bool:
        return len(self._target_devices()[:1]) > len(self._world)

    def _begin_recovery(self, cause: str, exc: BaseException):
        """RECOVER, first half: retire what completed, discard the rest,
        check the budget, back off, and leave a pending event for the
        next formation to complete."""
        t0 = time.time()
        old_dp, old_world = self.dp_size, list(self._world)
        step = self._loop.global_step if self._loop is not None else None
        if cause == "device_lost":
            detect.maybe_record_device_lost(exc, "elastic supervisor",
                                            step=step)
        discarded = self._teardown(abandon=True)
        self._count_retry(exc, cause)
        self._pending = {"cause": cause, "lost": self._lost_since(old_world),
                         "old_dp": old_dp, "discarded": discarded,
                         "step": step, "t0": t0}

    def _planned_reform(self, loop):
        """The world GREW back: drain, checkpoint at the current step and
        re-form larger; a recovery with nothing discarded, cause
        ``grow``."""
        t0 = time.time()
        step = loop.global_step
        loop.synchronize()
        loop.save_checkpoint(block=True)
        loop.wait()
        self._teardown(abandon=False)
        self._pending = {"cause": "grow", "lost": [], "old_dp": self.dp_size,
                         "discarded": 0, "step": step, "t0": t0}

    def _teardown(self, abandon: bool) -> int:
        """Dismantle the formation; returns the steps discarded."""
        loop, self._loop = self._loop, None
        if loop is None:
            return 0
        discarded = 0
        try:
            if abandon:
                discarded = len(loop.discard_inflight()[1])
            else:
                loop.synchronize()
        except Exception:        # pragma: no cover - defensive
            _LOG.warning("elastic: window teardown failed", exc_info=True)
        try:
            # a background checkpoint write is host work a device loss
            # does not touch: let it publish, so the restore sees it
            loop.wait()
        except Exception as e:
            _LOG.warning("elastic: in-flight checkpoint write failed "
                         "during teardown: %s", e)
        return discarded

    def _graceful_preempt(self, loop):
        """GRACE SAVE: drain the window and commit the final checkpoint
        inside the grace window."""
        t0 = time.monotonic()
        try:
            loop.synchronize()
        except Exception:
            _LOG.warning("elastic: drain on preemption failed; "
                         "abandoning in-flight steps", exc_info=True)
            loop.discard_inflight()
        loop.save_checkpoint(block=True)
        loop.wait()
        self._record_preemption(loop.global_step, time.monotonic() - t0)

    def _record_preemption(self, step: int, took: float):
        grace = detect.preemption_grace_sec()
        if took > grace:
            _LOG.error("elastic: grace-window save took %.1fs, EXCEEDING "
                       "MXNET_PREEMPTION_GRACE_SEC=%.1fs", took, grace)
        else:
            _LOG.warning("elastic: preemption checkpoint committed at step "
                         "%d in %.1fs", step, took)
        self._final_step = step
        _telemetry.registry().counter(
            _telemetry.names.ELASTIC_PREEMPTIONS).inc()
        self._log.record(cause="preemption", lost_devices=[],
                         old_dp=self.dp_size, new_dp=self.dp_size,
                         restored_step=step, downtime_s=took, step=step)

    def _finish(self, loop):
        loop.synchronize()
        if loop.checkpoint_manager is not None and self._final_checkpoint:
            loop.save_checkpoint(block=True)
        loop.wait()
        self._final_step = loop.global_step

    def _finalize_losses(self) -> dict:
        """The losses, read after the run left its step loop."""
        if not self._record_losses:
            return {}
        losses = dict(self._losses)
        for i, h in sorted(self._loss_handles.items()):
            try:
                losses[i] = _sum_loss(h)
            except Exception:    # a handle the failure poisoned
                _LOG.debug("loss of step %d unreadable", i, exc_info=True)
        return dict(sorted(losses.items()))

    # ---------------- a process group a formation ----------------
    def _run_formations(self, batch_fn, total_steps) -> bool:
        run_dir = tempfile.mkdtemp(prefix="mxt-elastic-")
        state = os.path.join(run_dir, "faults.json")
        with open(state, "w") as f:
            json.dump({"revoked": sorted(faults.revoked_device_ids()),
                       "fired": []}, f)
        env = {faults.STATE_ENV_VAR: state,
               faults.ENV_VAR: faults.active_spec()}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        relay = _NoticeRelay(self._preempt,
                             os.path.join(run_dir, "preempt"))
        try:
            n = 0
            while True:
                devs = self._target_devices()
                self._check_world(devs)
                self._world = devs
                self._log.set_world(len(devs))
                fdir = os.path.join(run_dir, f"formation{n}")
                os.makedirs(fdir)
                n += 1
                cfg = {"build": self._build, "batch_fn": batch_fn,
                       "dir": self._dir, "every": self._every,
                       "keep": self._keep, "inflight": self._inflight,
                       "async_checkpoint": self._async_ckpt,
                       "total": int(total_steps), "fdir": fdir,
                       "notice_file": relay.path,
                       "mesh_axes": self._mesh_axes, "axis": self._axis,
                       "grow": self._grow, "probe_every": self._probe_every,
                       "max_world": self._max_world, "kind": self._kind,
                       "record_losses": self._record_losses,
                       "final_checkpoint": self._final_checkpoint,
                       "stall_escalation": self._stall_escalation}
                try:
                    ranks = _dist.spawn(
                        _formation_rank, len(devs), self._kind, (cfg,),
                        timeout_s=self._formation_timeout_s,
                        device_ids=[d.index for d in devs])
                except Exception as e:
                    self._formation_failed(e, fdir)
                    continue
                r0 = ranks[0]
                self._formation_info(fdir)
                self._losses.update(r0["losses"])
                self._final_step = r0["final_step"]
                if r0["outcome"] == "reform":
                    self._pending = {"cause": "grow", "lost": [],
                                     "old_dp": len(devs), "discarded": 0,
                                     "step": r0["final_step"],
                                     "t0": r0["stopped_unix"]}
                    continue
                if r0["outcome"] == "preempted":
                    self._record_preemption(r0["final_step"],
                                            r0["grace_s"])
                    return True
                return False
        finally:
            relay.stop()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            shutil.rmtree(run_dir, ignore_errors=True)

    def _formation_info(self, fdir) -> Optional[dict]:
        """Rank 0's account of the formation (restored step and time,
        whether it made progress, the losses it could read); completes
        a pending recovery's event."""
        info = _read_json(os.path.join(fdir, "formation.json"))
        if info is None:
            return None
        self._losses.update({int(k): v for k, v in
                             (info.get("losses") or {}).items()})
        self._complete_pending(info["start"], info["restored_unix"])
        return info

    def _formation_failed(self, exc, fdir):
        """A formation ended in a failure: decide its cause from what the
        ranks wrote, then recover or raise."""
        t0 = time.time()
        info = self._formation_info(fdir)
        if info is not None and info.get("progressed"):
            self._retries = 0   # it got past its restored step
        errs = [e for e in (_read_json(os.path.join(fdir, f"err{r}.json"))
                            for r in range(len(self._world)))
                if e is not None]
        primary = [e for e in errs if not e["rank_lost"]]
        # no rank failed of its own: one died without an exception (a
        # kill), or the formation hung; neither is recovered
        cause = primary[0]["cause"] if primary else "fatal"
        if not self._recoverable(cause, exc):
            raise exc
        first = primary[0]
        if cause == "device_lost":
            detect.maybe_record_device_lost(exc, "elastic supervisor",
                                            step=first["step"])
        old_world = list(self._world)
        self._count_retry(exc, cause)
        self._pending = {"cause": cause, "lost": self._lost_since(old_world),
                         "old_dp": len(old_world),
                         "discarded": first["discarded"],
                         "step": first["step"], "t0": t0}


class _NoticeRelay:
    """Carries the supervisor's preemption notice to its ranks: a thread
    that creates ``path`` once the notice is raised, which each rank
    checks at its step boundary."""

    def __init__(self, notice: detect.PreemptionNotice, path: str):
        self.path = path
        self._notice = notice
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="mxt-elastic-notice")
        self._thread.start()

    def _watch(self):
        while not self._stop.wait(0.05):
            if self._notice.requested():
                open(self.path, "a").close()
                return

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=1.0)


def _read_json(path) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _write_json(path, obj):
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_retired(handles: dict, discarded: set) -> dict:
    """Best effort: the losses of the steps that retired (their device
    work is done), read on a side stream so the copy does not queue
    behind a step that will never end."""
    import torch
    out = {}
    for i, h in sorted(handles.items()):
        if i + 1 in discarded:
            continue
        try:
            if h.is_cuda:
                with torch.cuda.stream(torch.cuda.Stream(h.device)):
                    out[i] = _sum_loss(h.to("cpu"))
            else:
                out[i] = _sum_loss(h)
        except Exception:
            break
    return out


def _formation_rank(cfg: dict) -> dict:
    """One rank of a formation (run by ``parallel.dist.spawn``): build,
    resume from the newest checkpoint, step until done, preempted or the
    world grew, agreeing with the other ranks at each step boundary. On
    a failure it writes its cause (``err<rank>.json``) and raises with
    ``elastic cause: <cause>`` in the message."""
    import torch
    import torch.distributed as tdist
    from ..gluon.fused_step import TrainLoop
    from ..parallel.mesh import make_mesh
    rank, world = _dist.rank(), _dist.size()
    fdir, total = cfg["fdir"], cfg["total"]
    notice = detect.notice()
    notice.install()
    ctl = tdist.new_group(backend="gloo")
    loop, handles, info = None, {}, {}
    stalls = []
    threshold = cfg.get("stall_escalation", 0)

    def on_anomaly(evt):
        if evt.get("kind") == "stall":
            stalls.append(evt.get("step"))

    wd = _telemetry.watchdog()
    if threshold:
        wd.subscribe(on_anomaly)
    try:
        with make_mesh({a: (world if s == -1 else s)
                        for a, s in cfg["mesh_axes"].items()}):
            net, trainer, loss_blk = cfg["build"]()
            loop = TrainLoop(
                net, trainer, loss_blk, checkpoint_dir=cfg["dir"],
                checkpoint_every=cfg["every"], keep_last=cfg["keep"],
                async_checkpoint=cfg["async_checkpoint"], resume=True,
                inflight=cfg["inflight"])
            start = loop.global_step
            info = {"start": start, "restored_unix": time.time(),
                    "world": world, "progressed": False}
            if rank == 0:
                _write_json(os.path.join(fdir, "formation.json"), info)
            outcome = "done"
            cap = cfg["max_world"]
            for i in range(start, total):
                if cfg["probe_every"] and \
                        (i - start) % cfg["probe_every"] == 0:
                    grew = cfg["grow"] and i > start and len(
                        _dist.available_devices(cfg["kind"])[:cap]) > world
                    flags = torch.tensor(
                        [int(notice.requested()
                             or os.path.exists(cfg["notice_file"])),
                         int(grew),
                         int(bool(threshold) and len(stalls) >= threshold)],
                        dtype=torch.int32)
                    tdist.all_reduce(flags, op=tdist.ReduceOp.MAX,
                                     group=ctl)
                    if flags[0]:
                        outcome = "preempted"
                        break
                    if flags[2]:
                        raise StallEscalation(
                            f"a rank saw {threshold} or more watchdog "
                            "stall episode(s) in this formation: treating "
                            "the world as unhealthy")
                    if flags[1]:
                        outcome = "reform"
                        break
                loss = loop.step(*cfg["batch_fn"](i))
                if cfg["record_losses"]:
                    handles[i] = loss
                if rank == 0 and not info["progressed"]:
                    info["progressed"] = True
                    _write_json(os.path.join(fdir, "formation.json"), info)
            t0 = time.monotonic()
            stopped = time.time()
            loop.synchronize()
            if outcome != "done" or (cfg["final_checkpoint"]
                                     and loop.checkpoint_manager):
                loop.save_checkpoint(block=True)
            loop.wait()
            losses = {i: _sum_loss(h) for i, h in handles.items()} \
                if rank == 0 else {}
            return {"outcome": outcome, "losses": losses, "start": start,
                    "final_step": loop.global_step,
                    "stopped_unix": stopped,
                    "grace_s": time.monotonic() - t0}
    except BaseException as e:
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
        cause = detect.classify(e)
        step = loop.global_step if loop is not None else None
        discarded = loop.discard_inflight(retire=False)[1] \
            if loop is not None else []
        if rank == 0 and info and cfg["record_losses"]:
            info["losses"] = _read_retired(handles, set(discarded))
            _write_json(os.path.join(fdir, "formation.json"), info)
        detect.maybe_record_device_lost(e, "elastic formation", step=step)
        _write_json(os.path.join(fdir, f"err{rank}.json"), {
            "cause": cause, "rank_lost": detect.is_rank_lost(e),
            "error": f"{type(e).__name__}: {e}"[:4000], "step": step,
            "discarded": len(discarded)})
        raise MXNetError(
            f"elastic formation rank {rank} failed at step {step}: "
            f"{type(e).__name__}: {e} [elastic cause: {cause}]") from e
    finally:
        wd.unsubscribe(on_anomaly)
        notice.uninstall()

