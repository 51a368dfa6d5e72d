"""Step-timeline tracing: structured spans over a train step's lifecycle
(the port's copy of ``mxnet_tpu/telemetry/timeline.py``).

One pipelined train step passes through five host-observable phases —

    batch_fetch   producer pulls + stages the batch (prefetcher thread)
    h2d_wait      consumer wait on the staged device-resident batch
    dispatch      host time inside the compiled step call (enqueue)
    window        residency in the in-flight dispatch window (push->done)
    retire        the blocking wait at the window boundary (FIFO oldest)

plus ``checkpoint`` for snapshot captures. Each instrumentation point
(engine.DispatchWindow, gluon.data.DevicePrefetcher, gluon.TrainLoop,
checkpoint.TrainCheckpointManager) records its span here; the timeline

- feeds the ``mx_step_phase_seconds{phase=}`` histogram in the metrics
  registry (always),
- keeps a bounded ring of raw span events for exact p50/p99 summaries,
  and
- when the host profiler is running, emits each span into the SAME
  Chrome-trace stream as the per-op events (``cat: "step"``, args
  carrying the step number and phase) — so host ops and step phases land
  on one chrome://tracing / Perfetto timeline. Device kernels align via
  the ``torch.profiler.record_function`` step annotation the TrainLoop
  wraps dispatch in.

Span recording is gated by :func:`active` at the call sites: on when
``MXNET_TELEMETRY`` is set (``mx.telemetry.enable()``) or when the host
profiler is running; the registry counters stay always-on regardless.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from ..base import MXNetError
from . import names
from .registry import default as _default_registry

__all__ = ["PHASES", "StepTimeline", "timeline"]

#: the span vocabulary — documented in docs/OBSERVABILITY.md; record()
#: rejects anything else so the phase label stays bounded
PHASES = ("batch_fetch", "h2d_wait", "dispatch", "window", "retire",
          "checkpoint")


class StepTimeline:
    """Bounded ring of step-phase spans + the phase-duration histogram."""

    def __init__(self, capacity: int = 2048):
        self._events: "deque[dict]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._hist = _default_registry().histogram(
            names.STEP_PHASE_SECONDS, label_key="phase")

    # ---------------- recording ----------------
    def record(self, phase: str, t0: float, t1: float,
               step: Optional[int] = None):
        """Record one span: ``t0``/``t1`` are ``time.perf_counter()``
        stamps; ``step`` is the global step number where the
        instrumentation point knows it (prefetcher spans use their own
        batch ordinal). Also mirrors the span into the profiler's
        Chrome-trace stream when it is running."""
        if phase not in PHASES:
            raise MXNetError(
                f"unknown step phase {phase!r}; the span vocabulary is "
                f"{PHASES} (docs/OBSERVABILITY.md)")
        dur = max(0.0, t1 - t0)
        self._hist.observe(dur, label=phase)
        with self._lock:
            self._events.append(
                {"phase": phase, "step": step, "t0": t0, "t1": t1,
                 "dur": dur})
        self._emit_trace(phase, t0, t1, step)

    @staticmethod
    def _emit_trace(phase, t0, t1, step):
        from ..profiler import Profiler
        prof = Profiler.get()
        if prof.running and not prof.paused:
            prof.record(f"step:{phase}", t0, t1, cat="step",
                        args={"step": step, "phase": phase})

    # ---------------- queries ----------------
    def events(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if n is None else evs[-n:]

    def clear(self):
        with self._lock:
            self._events.clear()

    def summary(self, last_steps: Optional[int] = None) -> Dict[str, dict]:
        """Exact per-phase stats over the retained ring (optionally the
        spans of the last N distinct step numbers): count, total/p50/p99
        milliseconds."""
        evs = self.events()
        if last_steps is not None:
            steps = sorted({e["step"] for e in evs
                            if e["step"] is not None})
            keep = set(steps[-last_steps:])
            evs = [e for e in evs
                   if e["step"] is None or e["step"] in keep]
        by_phase: Dict[str, List[float]] = {}
        for e in evs:
            by_phase.setdefault(e["phase"], []).append(e["dur"])
        import numpy as onp
        out = {}
        for phase in PHASES:
            durs = by_phase.get(phase)
            if not durs:
                continue
            a = onp.asarray(durs)
            out[phase] = {
                "count": int(a.size),
                "total_ms": float(a.sum() * 1e3),
                "p50_ms": float(onp.percentile(a, 50) * 1e3),
                "p99_ms": float(onp.percentile(a, 99) * 1e3),
                "max_ms": float(a.max() * 1e3),
            }
        return out


_timeline = StepTimeline()


def timeline() -> StepTimeline:
    """The process-global step timeline (``mx.telemetry.timeline()``)."""
    return _timeline
