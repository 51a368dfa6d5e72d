"""Live MFU gauge + anomaly watchdog, piggybacking on window retires (the
port's counterpart of ``mxnet_tpu/telemetry/watchdog.py``).

The watchdog is fed from exactly one hot-path site — the dispatch
window's FIFO retire (engine.py), which is already the pipelined loop's
ONE designed host sync — so it adds no sync of its own:

- **step time**: retire-to-retire wall time is the steady-state step
  time of a pipelined run; it feeds the ``mx_step_time_seconds``
  histogram and an EWMA gauge.
- **MFU gauge**: FLOPs of one train step (``CompiledTrainStep.step_flops``
  / ``TrainLoop.arm_mfu``: the eager step under ``torch.utils.
  flop_counter.FlopCounterMode`` plus what each hand-written kernel's
  wrapper reports, the port having no ``cost_analysis()``) divided by measured step time, against the
  configured roofline (the card's published peak for the step's dtype) —
  ``mx_model_mfu_ratio``.
- **NaN/inf-loss detection**: the retired payload IS the step's loss;
  once the retire has blocked for completion, reading the small loss
  buffer is one cheap device->host copy inside the retire's
  designed sync. An episode TRANSITION (finite -> non-finite) emits
  exactly one structured ``nan_loss`` anomaly attributed to the step
  number the window tagged — not one event per poisoned step after it.
- **stall detection**: a retire whose step time exceeds
  ``MXNET_WATCHDOG_STALL_FACTOR`` x the EWMA (after a minimum sample
  count) emits one ``stall`` anomaly; the stalled sample is NOT folded
  into the EWMA, and re-arming requires a normal step, so one artificial
  stall produces exactly one event.

Anomaly events are structured dicts ``{kind, step, message, value,
time_unix}`` kept in a bounded ring (:meth:`Watchdog.anomalies`),
counted in ``mx_anomalies_total{kind=}``, and logged as one JSON line
on the ``mxnet_tpu_torch.telemetry`` logger. Other subsystems publish their
own kinds through :meth:`Watchdog.report`/:meth:`Watchdog.episode`:
``oom`` and ``memory_budget`` (telemetry/memory.py), the
``mx_numerics_*`` divergence kinds (telemetry/numerics.py), and
``device_lost`` — a CUDA device loss / preemption classified at the step
or retire seam (elastic/detect.py), the signal the elastic training
supervisor recovers from. Consumers that must REACT to anomalies (not
just export counts) register a callback with :meth:`Watchdog.subscribe`
— e.g. the elastic supervisor escalating repeated ``stall`` episodes
into a recovery.

Everything here is gated behind ``MXNET_TELEMETRY`` (telemetry.enabled)
at the engine call site; when telemetry is off the watchdog never runs.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as onp
import torch

from . import names
from .registry import default as _default_registry

__all__ = ["Watchdog", "watchdog", "stall_factor"]

_LOG = logging.getLogger("mxnet_tpu_torch.telemetry")

#: EWMA smoothing for the reference step time
_ALPHA = 0.2
#: samples before the stall detector arms (lets compile/warmup settle)
_MIN_SAMPLES = 5
#: largest loss buffer (elements) the NaN check will fetch
_MAX_FETCH = 1 << 20


def stall_factor(default: float = 4.0) -> float:
    """``MXNET_WATCHDOG_STALL_FACTOR``: a step slower than factor x the
    EWMA step time raises a ``stall`` anomaly (docs/OBSERVABILITY.md)."""
    try:
        v = float(os.environ.get("MXNET_WATCHDOG_STALL_FACTOR", default))
    except (TypeError, ValueError):
        return default
    return v if v > 1.0 else default


class Watchdog:
    """Process-global MFU gauge + NaN/stall anomaly detector."""

    def __init__(self, max_events: int = 256):
        self._lock = threading.Lock()
        self._events: "deque[dict]" = deque(maxlen=max_events)
        self._ewma: Optional[float] = None
        self._samples = 0
        self._nan_active = False
        self._stall_active = False
        # external episodic kinds (memory_budget, ...): kind -> active
        self._episode_active: dict = {}
        # anomaly-channel subscribers: callback(event_dict)
        self._subscribers: list = []
        self._flops: Optional[float] = None
        self._peak: Optional[float] = None
        reg = _default_registry()
        self._c_anom = reg.counter(names.ANOMALIES, label_key="kind")
        self._h_step = reg.histogram(names.STEP_TIME_SECONDS)
        self._g_ewma = reg.gauge(names.STEP_TIME_EWMA)
        self._g_flops = reg.gauge(names.MODEL_FLOPS_PER_STEP)
        self._g_fps = reg.gauge(names.MODEL_FLOPS_PER_SEC)
        self._g_mfu = reg.gauge(names.MFU)

    # ---------------- configuration ----------------
    def set_model_flops(self, flops_per_step: float):
        """Arm the MFU numerator: the FLOPs of ONE train step
        (``CompiledTrainStep.step_flops``)."""
        with self._lock:
            self._flops = float(flops_per_step)
        self._g_flops.set(float(flops_per_step))

    def set_peak_flops(self, peak_flops_per_sec: float):
        """Arm the MFU denominator: the roofline in FLOP/s (the
        card's published peak for the step's dtype)."""
        with self._lock:
            self._peak = float(peak_flops_per_sec)

    @property
    def model_flops(self) -> Optional[float]:
        return self._flops

    @property
    def peak_flops(self) -> Optional[float]:
        return self._peak

    # ---------------- the retire hook ----------------
    def observe_retire(self, step, payload=None,
                       dt: Optional[float] = None):
        """Called at each window retire (AFTER the blocking sync, inside
        the retire's ``engine.allow_sync`` region). ``dt`` is the
        retire-to-retire wall time (None on a window's first retire);
        ``payload`` is the retired result, inspected for NaN/inf when it
        is a small float tensor or array (the step's loss)."""
        if dt is not None and dt > 0:
            self._observe_step_time(step, dt)
        if payload is not None:
            self._check_finite(step, payload)

    def _observe_step_time(self, step, dt: float):
        self._h_step.observe(dt)
        with self._lock:
            ewma, samples = self._ewma, self._samples
        factor = stall_factor()
        if ewma is not None and samples >= _MIN_SAMPLES \
                and dt > factor * ewma:
            with self._lock:
                fire = not self._stall_active
                self._stall_active = True
            if fire:
                self._anomaly(
                    "stall", step, value=dt,
                    message=f"step {step} took {dt*1e3:.1f}ms, "
                            f"> {factor:g}x the {ewma*1e3:.1f}ms EWMA "
                            "step time")
            # the stalled sample is NOT folded into the EWMA: the
            # reference step time must not chase the pathology
        else:
            with self._lock:
                self._stall_active = False
                self._ewma = dt if self._ewma is None else \
                    (1 - _ALPHA) * self._ewma + _ALPHA * dt
                self._samples += 1
                ewma = self._ewma
                flops, peak = self._flops, self._peak
            self._g_ewma.set(ewma)
            if flops:
                fps = flops / dt
                self._g_fps.set(fps)
                if peak:
                    self._g_mfu.set(fps / peak)

    def _check_finite(self, step, payload):
        try:
            if isinstance(payload, torch.Tensor):
                if not payload.is_floating_point() or \
                        payload.numel() > _MAX_FETCH:
                    return
                # the retire already waited for the step; this is one
                # small device->host copy inside the designed retire
                finite = bool(torch.isfinite(
                    payload.detach().to("cpu")).all())
            else:
                arr = onp.asarray(payload)
                if arr.size > _MAX_FETCH or \
                        not onp.issubdtype(arr.dtype, onp.floating):
                    return
                finite = bool(onp.isfinite(arr).all())
        except Exception:           # exotic payloads: never kill a run
            return
        with self._lock:
            fire = not finite and not self._nan_active
            self._nan_active = not finite
        if fire:
            self._anomaly(
                "nan_loss", step, value=None,
                message=f"non-finite loss first observed at step {step}")

    # ---------------- events ----------------
    def report(self, kind: str, step, message: str, value=None) -> dict:
        """Emit one structured anomaly event on the watchdog channel —
        the SAME ring/counter/log-line path the built-in NaN and stall
        detectors use. Other subsystems (the memory watchdog, OOM
        forensics) publish through here so every anomaly, whatever its
        source, lands in ``anomalies()``, ``mx_anomalies_total{kind=}``
        and one ``mx-anomaly`` JSON log line. For a CONDITION (vs a
        one-shot event) use :meth:`episode` to get exactly-one-per-
        episode semantics."""
        evt = {"kind": kind, "step": step, "message": message,
               "value": value, "time_unix": time.time()}
        with self._lock:
            self._events.append(evt)
            subs = list(self._subscribers)
        self._c_anom.inc(label=kind)
        _LOG.warning("mx-anomaly %s", json.dumps(evt))
        for cb in subs:
            try:
                cb(evt)
            except Exception:    # pragma: no cover - a subscriber must
                _LOG.warning("anomaly subscriber %r failed", cb,
                             exc_info=True)   # never kill the reporter
        return evt

    _anomaly = report

    # ---------------- subscription ----------------
    def subscribe(self, callback):
        """Register ``callback(event_dict)`` to run on EVERY anomaly the
        channel reports (whatever its source subsystem) — the reactive
        half of the channel, e.g. the elastic supervisor escalating
        stall episodes into a recovery. Callbacks run synchronously on
        the reporting thread and must be cheap + non-raising (exceptions
        are logged and swallowed). Returns ``callback`` for symmetric
        :meth:`unsubscribe`."""
        with self._lock:
            if callback not in self._subscribers:
                self._subscribers.append(callback)
        return callback

    def unsubscribe(self, callback):
        with self._lock:
            if callback in self._subscribers:
                self._subscribers.remove(callback)

    def episode(self, kind: str, active: bool, step=None,
                message: str = "", value=None) -> bool:
        """Episode-transition reporting for external detectors: fires
        :meth:`report` exactly ONCE when ``kind`` goes inactive->active
        (the memory-budget discipline — a run sitting over budget for
        1000 steps produces one event, not 1000); recovery re-arms.
        Returns True when an event was emitted."""
        with self._lock:
            fire = bool(active) and not self._episode_active.get(kind)
            self._episode_active[kind] = bool(active)
        if fire:
            self.report(kind, step, message=message, value=value)
        return fire

    def anomalies(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if kind is None else [e for e in evs
                                         if e["kind"] == kind]

    def reset(self):
        with self._lock:
            self._events.clear()
            self._ewma = None
            self._samples = 0
            self._nan_active = False
            self._stall_active = False
            self._episode_active.clear()
            self._subscribers.clear()
            self._flops = None
            self._peak = None


_watchdog = Watchdog()


def watchdog() -> Watchdog:
    """The process-global watchdog (``mx.telemetry.watchdog()``)."""
    return _watchdog
