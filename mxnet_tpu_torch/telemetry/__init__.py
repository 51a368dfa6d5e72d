"""mx.telemetry — unified runtime telemetry (the port's counterpart of
``mxnet_tpu/telemetry/``).

Three cooperating pieces:

1. **Step-timeline tracing** (:mod:`.timeline`): structured spans for a
   train step's lifecycle — batch fetch, prefetch h2d wait, host
   dispatch, window residency, retire, checkpoint — recorded from
   ``engine.DispatchWindow``, ``gluon.data.DevicePrefetcher``,
   ``gluon.TrainLoop`` and ``checkpoint.TrainCheckpointManager``, and
   emitted into the SAME Chrome-trace stream as the profiler's per-op
   events.
2. **Process-global metrics registry** (:mod:`.registry`): counters /
   gauges / histograms with bounded cardinality, named exclusively from
   the catalog in :mod:`.names` (the JAX package's, whole), behind the
   exporters (:mod:`.exporters`): JSON :func:`snapshot`, Prometheus
   text file, periodic structured-log heartbeat.
3. **MFU gauge + anomaly watchdog** (:mod:`.watchdog`): a step's FLOPs
   (the eager step under ``FlopCounterMode`` plus the hand-written
   kernels' own counts) over measured step time, plus NaN/inf-loss and
   step-time-stall detection piggybacked on window retires.

Two further domains build on these: device memory (:mod:`.memory` — the
caching allocator's accounting, buffer census, OOM forensics) and
training numerics (:mod:`.numerics` — grad/param health computed inside
the captured step, divergence watchdog, NaN-origin forensics).

Cost model: registry counters/gauges are ALWAYS on (one uncontended
lock + float update per event, no device synchronization). Span
recording and the watchdog are gated by :func:`enabled` —
``MXNET_TELEMETRY=1`` or :func:`enable` — and the watchdog's NaN check
adds one small device->host read per retire, inside the retire's
designed wait.
"""
from __future__ import annotations

import os
from typing import Optional

from . import names
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       default as registry)
from .timeline import PHASES, StepTimeline, timeline
from .watchdog import Watchdog, stall_factor, watchdog
from . import memory
from .memory import BufferCensus, MemoryReport, census
from . import numerics
from .numerics import NumericsMonitor, StepNumerics
from .exporters import (SCHEMA_VERSION, Heartbeat, heartbeat_interval,
                        prometheus_file, prometheus_text, snapshot,
                        start_heartbeat, stop_heartbeat,
                        write_prometheus)

__all__ = ["names", "registry", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "timeline", "StepTimeline", "PHASES",
           "watchdog", "Watchdog", "stall_factor", "snapshot",
           "prometheus_text", "write_prometheus", "prometheus_file",
           "Heartbeat", "start_heartbeat", "stop_heartbeat",
           "heartbeat_interval", "SCHEMA_VERSION", "enabled", "enable",
           "value", "reset", "memory", "census", "BufferCensus",
           "MemoryReport", "numerics", "NumericsMonitor",
           "StepNumerics"]

# every catalog series exists from import time: an exporter always shows
# the full schema (zero is information; absence is a question)
registry().ensure_catalog()

_OVERRIDE: Optional[bool] = None


def enabled() -> bool:
    """Whether the gated (span/watchdog) half of telemetry is on:
    ``MXNET_TELEMETRY`` truthy, or an :func:`enable` override. The
    always-on registry counters do not consult this."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    v = os.environ.get("MXNET_TELEMETRY", "").strip().lower()
    return v not in ("", "0", "off", "false", "no")


def enable(on: bool = True):
    """Programmatic override of ``MXNET_TELEMETRY`` (``enable(None)``
    restores env control)."""
    global _OVERRIDE
    _OVERRIDE = on


def active() -> bool:
    """Span-recording gate for instrumentation points: telemetry is
    enabled OR the host profiler is running (so a profiler session gets
    step spans in its Chrome trace without MXNET_TELEMETRY)."""
    if enabled():
        return True
    from ..profiler import Profiler
    prof = Profiler.get()
    return prof.running and not prof.paused


def value(name: str, label: Optional[str] = None):
    """Convenience read of one series from the default registry."""
    return registry().value(name, label)


def reset():
    """Zero every metric, clear the timeline ring and the watchdog state
    (registrations, cached metric objects, and collectors survive) —
    the test/bench isolation hook. The buffer census is NOT cleared:
    its weakref pools track live objects, not accumulated values, so
    zeroing would silently untrack still-live buffers registered once
    at compile time (``memory.census().clear()`` exists for tests that
    need a fresh census)."""
    registry().reset()
    timeline().clear()
    watchdog().reset()
    numerics.monitor().reset()
