"""Process-global metrics registry: counters, gauges, histograms (the
port's copy of ``mxnet_tpu/telemetry/registry.py``).

The always-on half of the telemetry subsystem (docs/OBSERVABILITY.md).
Hot-path cost is one uncontended lock + a dict/float update per event —
no host syncs, no allocation beyond first registration — so the
instrumentation points (window retires, prefetch waits, the serving
and checkpoint paths) feed it unconditionally; the heavier span/watchdog machinery is
gated behind ``MXNET_TELEMETRY`` instead.

Cardinality is bounded by construction: a metric has at most ONE label
key, fixed at registration, and at most ``names.MAX_LABEL_VALUES``
distinct values — further values collapse into ``names.OVERFLOW_LABEL``,
so a mistake upstream (per-step or per-shape label values) degrades an
exporter to one extra series, never an unbounded one.

Registration funnels through :func:`names.check`: framework (``mx_``)
names must come from the catalog in ``telemetry/names.py``, which the
tier-1 metric-name lint sweep keeps as the single source of truth.
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..base import MXNetError
from . import names

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "default",
           "DEFAULT_BUCKETS"]

#: default histogram bucket upper bounds, seconds (phase/step/checkpoint
#: latencies from ~0.1ms to tens of seconds)
DEFAULT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                   1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0)

_UNLABELED = ""


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str = "",
                 label_key: Optional[str] = None):
        self.name = name
        self.help = help
        self.label_key = label_key
        self._lock = threading.Lock()

    def _slot(self, label: Optional[str]) -> str:
        """Normalize + bound the label value (call under self._lock)."""
        if label is None:
            if self.label_key is not None:
                raise MXNetError(
                    f"metric {self.name!r} requires a "
                    f"{self.label_key!r} label value")
            return _UNLABELED
        if self.label_key is None:
            raise MXNetError(
                f"metric {self.name!r} was registered without a label "
                f"key; got label {label!r}")
        label = str(label)
        if label not in self._values and \
                len(self._values) >= names.MAX_LABEL_VALUES:
            return names.OVERFLOW_LABEL
        return label

    def values(self) -> dict:
        """label value -> current value ('' for unlabeled)."""
        with self._lock:
            return dict(self._values)


class Counter(_Metric):
    """Monotonic float counter (optionally labeled)."""

    kind = "counter"

    def __init__(self, name, help="", label_key=None):
        super().__init__(name, help, label_key)
        self._values: Dict[str, float] = {}

    def inc(self, v: float = 1.0, label: Optional[str] = None):
        if v < 0:
            raise MXNetError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            slot = self._slot(label)
            self._values[slot] = self._values.get(slot, 0.0) + v

    def value(self, label: Optional[str] = None) -> float:
        with self._lock:
            return self._values.get(
                _UNLABELED if label is None else str(label), 0.0)

    def _reset(self):
        with self._lock:
            self._values.clear()


class Gauge(_Metric):
    """Point-in-time value (optionally labeled)."""

    kind = "gauge"

    def __init__(self, name, help="", label_key=None):
        super().__init__(name, help, label_key)
        self._values: Dict[str, float] = {}

    def set(self, v: float, label: Optional[str] = None):
        with self._lock:
            self._values[self._slot(label)] = float(v)

    def add(self, v: float, label: Optional[str] = None):
        with self._lock:
            slot = self._slot(label)
            self._values[slot] = self._values.get(slot, 0.0) + v

    def value(self, label: Optional[str] = None) -> Optional[float]:
        with self._lock:
            return self._values.get(
                _UNLABELED if label is None else str(label))

    def _reset(self):
        with self._lock:
            self._values.clear()


class _HistSlot:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets):
        self.counts = [0] * (n_buckets + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram with quantile estimation.

    Buckets are cumulative-style at export (Prometheus ``le``);
    internally per-bucket counts. ``percentile`` interpolates linearly
    inside the winning bucket — exact enough for p50/p99 phase summaries
    (the raw-event path in timeline.py is exact for recent steps).
    """

    kind = "histogram"

    def __init__(self, name, help="", label_key=None, buckets=None):
        super().__init__(name, help, label_key)
        self.buckets: Tuple[float, ...] = tuple(
            sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        if not self.buckets:
            raise MXNetError(f"histogram {name!r} needs >= 1 bucket")
        self._values: Dict[str, _HistSlot] = {}

    def observe(self, v: float, label: Optional[str] = None):
        v = float(v)
        with self._lock:
            slot = self._slot(label)
            h = self._values.get(slot)
            if h is None:
                h = self._values[slot] = _HistSlot(len(self.buckets))
            h.counts[bisect.bisect_left(self.buckets, v)] += 1
            h.sum += v
            h.count += 1

    def _get(self, label) -> Optional[_HistSlot]:
        return self._values.get(
            _UNLABELED if label is None else str(label))

    def count(self, label: Optional[str] = None) -> int:
        with self._lock:
            h = self._get(label)
            return h.count if h else 0

    def sum(self, label: Optional[str] = None) -> float:
        with self._lock:
            h = self._get(label)
            return h.sum if h else 0.0

    def percentile(self, p: float, label: Optional[str] = None
                   ) -> Optional[float]:
        """Estimate the p-th percentile (0..100) from bucket counts."""
        with self._lock:
            h = self._get(label)
            if h is None or h.count == 0:
                return None
            rank = p / 100.0 * h.count
            seen = 0.0
            lo = 0.0
            for i, c in enumerate(h.counts):
                if c == 0:
                    if i < len(self.buckets):
                        lo = self.buckets[i]
                    continue
                if seen + c >= rank:
                    hi = self.buckets[i] if i < len(self.buckets) \
                        else self.buckets[-1]
                    frac = (rank - seen) / c
                    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                seen += c
                if i < len(self.buckets):
                    lo = self.buckets[i]
            return self.buckets[-1]   # pragma: no cover - numeric edge

    def snapshot_slot(self, label: Optional[str] = None) -> Optional[dict]:
        """{count, sum, p50, p99, buckets:{le->cumulative}} for export."""
        with self._lock:
            h = self._get(label)
            if h is None:
                return None
        out = {"count": h.count, "sum": h.sum,
               "p50": self.percentile(50, label),
               "p99": self.percentile(99, label)}
        cum, buckets = 0, {}
        for le, c in zip(self.buckets, h.counts):
            cum += c
            buckets[repr(le)] = cum
        buckets["+Inf"] = h.count
        out["buckets"] = buckets
        return out

    def labels(self) -> List[str]:
        with self._lock:
            return sorted(self._values)

    def _reset(self):
        with self._lock:
            self._values.clear()


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Name -> metric map with get-or-create registration and pull-model
    collectors (callables refreshed before each export)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []
        self._lock = threading.Lock()

    # ---------------- registration ----------------
    def _register(self, kind: str, name: str, help: str,
                  label_key: Optional[str], **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise MXNetError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, not {kind}")
                if label_key is not None and m.label_key != label_key:
                    raise MXNetError(
                        f"metric {name!r} already registered with label "
                        f"key {m.label_key!r}, not {label_key!r}")
                return m
            names.check(name, kind)
            if name.startswith("mx_"):
                decl = names.CATALOG[name]
                help = help or decl["help"]
                if label_key is None:
                    label_key = decl["label"]
                elif decl["label"] != label_key:
                    raise MXNetError(
                        f"metric {name!r} declared with label "
                        f"{decl['label']!r} in the catalog, "
                        f"got {label_key!r}")
            m = _KINDS[kind](name, help=help, label_key=label_key,
                             **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                label_key: Optional[str] = None) -> Counter:
        return self._register("counter", name, help, label_key)

    def gauge(self, name: str, help: str = "",
              label_key: Optional[str] = None) -> Gauge:
        return self._register("gauge", name, help, label_key)

    def histogram(self, name: str, help: str = "",
                  label_key: Optional[str] = None,
                  buckets=None) -> Histogram:
        return self._register("histogram", name, help, label_key,
                              buckets=buckets)

    def ensure_catalog(self):
        """Pre-register every catalog series so exporters always show
        the full schema (a zero counter is information; a missing one is
        a question)."""
        for name, decl in names.CATALOG.items():
            self._register(decl["kind"], name, decl["help"], decl["label"])

    # ---------------- access ----------------
    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def value(self, name: str, label: Optional[str] = None):
        """Convenience read: counter/gauge value or histogram count."""
        m = self.get(name)
        if m is None:
            return None
        if isinstance(m, Histogram):
            return m.count(label)
        return m.value(label)

    # ---------------- collectors ----------------
    def register_collector(self, fn: Callable[["MetricsRegistry"], None]):
        """Pull-model refresh hook, run at collect()/export time (e.g.
        runtime.compile_cache_stats -> gauges)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def collect(self) -> List[_Metric]:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:       # a broken collector must not kill
                import logging      # the exporter
                logging.getLogger("mxnet_tpu_torch.telemetry").warning(
                    "telemetry collector %r failed", fn, exc_info=True)
        return self.metrics()

    # ---------------- lifecycle ----------------
    def reset(self):
        """Zero every metric IN PLACE (call sites cache metric objects,
        so objects survive; values drop to empty/zero). Collectors and
        registrations persist."""
        for m in self.metrics():
            m._reset()


_default = MetricsRegistry()


def default() -> MetricsRegistry:
    """The process-global registry every framework instrumentation point
    feeds (``mx.telemetry.registry()``)."""
    return _default
