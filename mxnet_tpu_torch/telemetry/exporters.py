"""Telemetry exporters: JSON snapshot, Prometheus text format, heartbeat
(the port's copy of ``mxnet_tpu/telemetry/exporters.py``).

Three pluggable ways out of the metrics registry (docs/OBSERVABILITY.md):

- :func:`snapshot` — one JSON-serializable dict of every series
  (schema-stable: tests pin the top-level keys), for ad-hoc dumps;
- :func:`prometheus_text` / :func:`write_prometheus` — Prometheus
  exposition format (``# HELP``/``# TYPE``, ``_bucket{le=}``/``_sum``/
  ``_count`` histograms), written atomically to
  ``MXNET_PROMETHEUS_FILE`` for a node-exporter textfile collector or
  any scraper that reads files;
- :class:`Heartbeat` — a daemon thread that logs one structured JSON
  line per ``MXNET_TELEMETRY_HEARTBEAT_SEC`` interval (and refreshes the
  Prometheus file when configured), so a headless run leaves a
  greppable pulse in its logs.

Registry collectors run before every export, so pull-model series
(the memory census, the device's allocator) are fresh. The heartbeat
thread, the prefetcher's thread and the step loop write into one
registry; each metric holds its own lock.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from ..analysis.threads import mx_lock
from ..base import MXNetError
from . import names
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       default as _default_registry)
from .watchdog import watchdog as _watchdog

__all__ = ["SCHEMA_VERSION", "snapshot", "prometheus_text",
           "write_prometheus", "prometheus_file", "Heartbeat",
           "start_heartbeat", "stop_heartbeat", "heartbeat_interval"]

_LOG = logging.getLogger("mxnet_tpu_torch.telemetry")

#: bump ONLY with a documented migration; tests pin the snapshot schema
SCHEMA_VERSION = 1


def prometheus_file() -> Optional[str]:
    """``MXNET_PROMETHEUS_FILE`` (None when unset)."""
    return os.environ.get("MXNET_PROMETHEUS_FILE") or None


def heartbeat_interval() -> float:
    """``MXNET_TELEMETRY_HEARTBEAT_SEC`` (0 = heartbeat off)."""
    try:
        return max(0.0, float(
            os.environ.get("MXNET_TELEMETRY_HEARTBEAT_SEC", "0")))
    except (TypeError, ValueError):
        return 0.0


# ---------------------------------------------------------------------------
# JSON snapshot
# ---------------------------------------------------------------------------

def _metric_values(m):
    """Flatten an unlabeled metric to its scalar, keep labeled ones as
    {label: value}."""
    vals = m.values()
    if m.label_key is None:
        return vals.get("", 0.0 if isinstance(m, Counter) else None)
    return dict(sorted(vals.items()))


def snapshot(registry: Optional[MetricsRegistry] = None) -> dict:
    """One JSON-serializable dict of the full telemetry state:

    ``{"schema_version", "time_unix", "counters", "gauges",
    "histograms", "anomalies"}`` — unlabeled series map name -> value,
    labeled ones name -> {label: value}, histograms name -> (slot or
    {label: slot}) where a slot is ``{count, sum, p50, p99, buckets}``.
    """
    reg = registry if registry is not None else _default_registry()
    counters, gauges, hists = {}, {}, {}
    for m in reg.collect():
        if isinstance(m, Histogram):
            if m.label_key is None:
                hists[m.name] = m.snapshot_slot()
            else:
                hists[m.name] = {lb: m.snapshot_slot(lb)
                                 for lb in m.labels()}
        elif isinstance(m, Counter):
            counters[m.name] = _metric_values(m)
        elif isinstance(m, Gauge):
            gauges[m.name] = _metric_values(m)
    wd = _watchdog()
    events = wd.anomalies()
    return {
        "schema_version": SCHEMA_VERSION,
        "time_unix": time.time(),
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
        "anomalies": {"count": len(events), "recent": events[-16:]},
    }


# ---------------------------------------------------------------------------
# Prometheus text format
# ---------------------------------------------------------------------------

def _fmt(v: float) -> str:
    if v != v:                       # pragma: no cover - NaN guard
        return "NaN"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _label_str(key: Optional[str], value: Optional[str],
               extra: str = "") -> str:
    parts = []
    if key is not None and value is not None and value != "":
        parts.append(f'{key}="{value}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry in Prometheus exposition format, deterministically
    ordered (sorted names, sorted label values) so exports diff and the
    golden test stays stable."""
    reg = registry if registry is not None else _default_registry()
    lines = []
    for m in reg.collect():
        lines.append(f"# HELP {m.name} {m.help or m.name}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            labels = m.labels() if m.label_key is not None else [None]
            for lb in labels:
                slot = m.snapshot_slot(lb)
                if slot is None:
                    slot = {"count": 0, "sum": 0.0,
                            "buckets": {"+Inf": 0}}
                for le, cum in slot["buckets"].items():
                    ls = _label_str(m.label_key, lb, f'le="{le}"')
                    lines.append(f"{m.name}_bucket{ls} {cum}")
                ls = _label_str(m.label_key, lb)
                lines.append(f"{m.name}_sum{ls} {_fmt(slot['sum'])}")
                lines.append(f"{m.name}_count{ls} {slot['count']}")
        else:
            vals = m.values()
            if not vals and isinstance(m, Counter) \
                    and m.label_key is None:
                vals = {"": 0.0}
            for lb in sorted(vals):
                ls = _label_str(m.label_key, lb or None)
                lines.append(f"{m.name}{ls} {_fmt(vals[lb])}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: Optional[str] = None,
                     registry: Optional[MetricsRegistry] = None) -> str:
    """Atomically write :func:`prometheus_text` to ``path`` (default
    ``MXNET_PROMETHEUS_FILE``); returns the path written."""
    path = path or prometheus_file()
    if not path:
        raise MXNetError(
            "write_prometheus: no path given and MXNET_PROMETHEUS_FILE "
            "is unset (docs/OBSERVABILITY.md)")
    text = prometheus_text(registry)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# heartbeat
# ---------------------------------------------------------------------------

def _heartbeat_payload() -> dict:
    """The condensed per-beat line: headline counters/gauges + anomaly
    count (full series belong in the Prometheus file, not the log)."""
    reg = _default_registry()
    wd = _watchdog()
    keys = (names.TRAIN_STEPS, names.WINDOW_RETIRES, names.HOST_SYNCS,
            names.PREFETCH_STARVATION, names.COMPILE_RETRACES,
            names.CHECKPOINT_SAVES)
    out = {"time_unix": time.time()}
    for k in keys:
        m = reg.get(k)
        if m is None:
            continue
        out[k] = _metric_values(m)
    for k in (names.STEP_TIME_EWMA, names.MFU,
              names.MODEL_FLOPS_PER_SEC, names.NUMERICS_GRAD_NORM,
              names.NUMERICS_PARAM_NORM):
        g = reg.get(k)
        v = g.value() if g is not None else None
        if v is not None:
            out[k] = v
    out["anomalies"] = len(wd.anomalies())
    return out


class Heartbeat:
    """Daemon thread emitting one structured-log telemetry line per
    interval; also refreshes ``MXNET_PROMETHEUS_FILE`` when set."""

    def __init__(self, interval: Optional[float] = None,
                 write_file: bool = True):
        self.interval = heartbeat_interval() if interval is None \
            else float(interval)
        if self.interval <= 0:
            raise MXNetError(
                "Heartbeat needs a positive interval (set "
                "MXNET_TELEMETRY_HEARTBEAT_SEC or pass interval=)")
        self._write_file = write_file
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="mx-telemetry-heartbeat", daemon=True)
        self._counter = _default_registry().counter(names.HEARTBEATS)
        self.beats = 0
        # serializes beat() between the daemon thread and any caller
        # (atexit flush, tests); also guards the terminal _stopped flag,
        # so a stop() landing mid-beat waits the beat out instead of
        # racing it into a second MXNET_PROMETHEUS_FILE write
        self._beat_mu = mx_lock("telemetry.heartbeat.beat")
        self._stopped = False

    def start(self) -> "Heartbeat":
        if self._stopped:
            raise MXNetError(
                "Heartbeat.start: this heartbeat was stopped; threads "
                "cannot be restarted — build a new Heartbeat()")
        _install_atexit()   # short runs still flush a final snapshot
        if not self._thread.is_alive():
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            self.beat()

    def beat(self):
        """One heartbeat: log the condensed payload, bump the counter,
        refresh the Prometheus file when configured. Serialized against
        concurrent callers and a no-op once :meth:`stop` has landed, so
        the final flush never doubles up with an in-flight beat."""
        with self._beat_mu:
            if self._stopped:
                return
            try:
                payload = _heartbeat_payload()
                _LOG.info("mx-telemetry %s", json.dumps(payload))
                self._counter.inc()
                self.beats += 1
                if self._write_file and prometheus_file():
                    write_prometheus()
            except Exception:        # a heartbeat must never kill a run
                _LOG.warning("telemetry heartbeat failed", exc_info=True)

    def stop(self, timeout: float = 5.0):
        """Signal shutdown and join the thread (idempotent).

        Acquiring the beat lock first means an in-flight beat finishes
        (or the next one sees ``_stopped`` and bails) before we join —
        and the join itself happens with no lock held."""
        self._stop.set()
        with self._beat_mu:
            self._stopped = True
        if self._thread.is_alive():
            self._thread.join(timeout)

    @property
    def running(self) -> bool:
        return self._thread.is_alive()


_active_heartbeat: Optional[Heartbeat] = None
_hb_lock = mx_lock("telemetry.heartbeat")
_atexit_installed = False


def _install_atexit():
    global _atexit_installed
    if not _atexit_installed:
        import atexit
        atexit.register(_atexit_flush)
        _atexit_installed = True


def _atexit_flush():
    """Final exporter flush at interpreter exit: a short run that exits
    before the first heartbeat interval (or between intervals) still
    leaves one last structured log line and a final
    ``MXNET_PROMETHEUS_FILE`` snapshot on disk — a scraper never reads
    a stale or absent file because the process was brief. With no
    heartbeat running, a configured Prometheus file is still refreshed.
    Never raises (exit paths must stay clean)."""
    with _hb_lock:
        hb = _active_heartbeat
    try:
        if hb is not None and hb.running:
            hb.beat()
            hb.stop()
        elif prometheus_file():
            write_prometheus()
    except Exception:            # pragma: no cover - defensive
        _LOG.warning("telemetry atexit flush failed", exc_info=True)


def start_heartbeat(interval: Optional[float] = None,
                    write_file: bool = True) -> Heartbeat:
    """Start (or return the already-running) process heartbeat."""
    global _active_heartbeat
    with _hb_lock:
        if _active_heartbeat is not None and _active_heartbeat.running:
            return _active_heartbeat
        _active_heartbeat = Heartbeat(interval=interval,
                                      write_file=write_file).start()
        return _active_heartbeat


def stop_heartbeat():
    """Stop the process heartbeat if one is running (idempotent)."""
    global _active_heartbeat
    with _hb_lock:
        hb, _active_heartbeat = _active_heartbeat, None
    if hb is not None:
        hb.stop()


# the flush re-checks configuration at exit time (env may be set after
# import), so installing unconditionally is a no-op for unconfigured
# processes and a final-snapshot guarantee for configured ones
_install_atexit()
