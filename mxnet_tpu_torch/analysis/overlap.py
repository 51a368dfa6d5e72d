"""Exposed-communication analysis over a schedule record (counterpart of
``mxnet_tpu/analysis/overlap.py``: the same report, windows, baseline
gate and gauges, where the JAX package walks XLA's final schedule).

The record's issue order is the order the step puts work on the card's
streams. For each collective of the record this pass measures how much
independent compute lies inside its *overlap window*:

* an async pair (an ``async_op`` collective and its ``work.wait()``):
  the window is its issue..wait span, the kernels issued while the
  collective is on the wire (the ZeRO step's reduce-scatters launched
  from the backward's hooks);
* a synchronous collective: the window is its dependency slack, from
  the last kernel that wrote one of its inputs to the first kernel that
  needs its result (data movement — copies, casts, views, zero-FLOP
  kernels — does not end a window: the walk follows it); a result no
  kernel needs has the end of the step as its deadline.

Kernels inside the window that do not depend on the collective (forward
taint over storage ids) hide it by their roofline seconds on the H100
(the kernel census's FLOP/byte model, ``analysis/fusion.py``), credited
against the collective's wire seconds (ring model over the
``BandwidthProfile``, ``analysis/sharding.py``):

    exposed_s = max(0, comm_s - hide_s)        per collective
    overlap_fraction = 1 - sum(exposed) / sum(comm)

The serial ZeRO step (``MXNET_ZERO_BUCKET_BYTES=0``: one bucket,
reduce-scattered after the whole backward) measures ~0; the bucketed
step measures more, since bucket k's reduce-scatter is on the wire while
the backward of the layers before it runs. An observer: a failure
degrades to an empty report, never an exception.
"""
from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .report import Finding
from .schedule import ScheduleRecord

_LOG = logging.getLogger(__name__)

__all__ = [
    "CollectiveWindow", "OverlapReport", "overlap_census",
    "load_baselines", "check_baseline", "baseline_from_env", "publish",
]


@dataclass
class CollectiveWindow:
    """One collective's overlap accounting on the record."""
    name: str
    kind: str
    axis: str
    comm_s: float
    hide_s: float
    exposed_s: float
    n_hiders: int
    window: Tuple[int, int]
    computation: str = "?"
    is_async: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind, "axis": self.axis,
                "comm_s": self.comm_s, "hide_s": self.hide_s,
                "exposed_s": self.exposed_s, "n_hiders": self.n_hiders,
                "window": list(self.window), "is_async": self.is_async}


@dataclass
class OverlapReport:
    """Exposed-vs-total communication posture of one step."""
    windows: List[CollectiveWindow] = field(default_factory=list)
    per_axis_total_s: Dict[str, float] = field(default_factory=dict)
    per_axis_exposed_s: Dict[str, float] = field(default_factory=dict)
    total_comm_s: float = 0.0
    exposed_comm_s: float = 0.0
    n_async: int = 0
    #: the record is an issue order (always, in the port)
    scheduled: bool = True
    profile: str = "nvlink"
    #: the ``zero.bucket_bytes`` in force when the record was read
    zero_bucket_bytes: Optional[int] = None
    findings: List[Finding] = field(default_factory=list)

    @property
    def n_collectives(self) -> int:
        return len(self.windows)

    @property
    def overlap_fraction(self) -> float:
        """Share of modeled comm seconds hidden behind independent
        compute (0 = fully exposed/serial, 1 = fully hidden)."""
        if self.total_comm_s <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.exposed_comm_s / self.total_comm_s)

    def brief(self) -> Dict[str, Any]:
        return {"exposed_comm_s": self.exposed_comm_s,
                "total_comm_s": self.total_comm_s,
                "overlap_fraction": self.overlap_fraction,
                "n_collectives": self.n_collectives,
                "n_async": self.n_async,
                "zero_bucket_bytes": self.zero_bucket_bytes}

    def to_dict(self) -> Dict[str, Any]:
        d = self.brief()
        d.update({
            "scheduled": self.scheduled, "profile": self.profile,
            "per_axis_total_s": dict(self.per_axis_total_s),
            "per_axis_exposed_s": dict(self.per_axis_exposed_s),
            "windows": [w.to_dict() for w in self.windows[:24]],
        })
        return d

    def summary_line(self) -> str:
        return (f"exposed={self.exposed_comm_s:.3e}s of "
                f"{self.total_comm_s:.3e}s comm "
                f"(fraction={self.overlap_fraction:.2f}, "
                f"{self.n_collectives} collectives, "
                f"{self.n_async} async)")

    def table_str(self, top: int = 16) -> str:
        lines = [f"{'collective':<30s}{'kind':<18s}{'axis':<6s}"
                 f"{'comm s':>11s}{'hide s':>11s}{'exposed s':>11s}"
                 f"{'hiders':>7s}"]
        rows = sorted(self.windows, key=lambda w: -w.exposed_s)[:top]
        for w in rows:
            lines.append(
                f"{w.name[:28]:<30s}{w.kind:<18s}{w.axis:<6s}"
                f"{w.comm_s:>11.3e}{w.hide_s:>11.3e}"
                f"{w.exposed_s:>11.3e}{w.n_hiders:>7d}")
        for ax in sorted(self.per_axis_total_s):
            lines.append(
                f"  axis {ax!r}: exposed "
                f"{self.per_axis_exposed_s.get(ax, 0.0):.3e} s of "
                f"{self.per_axis_total_s[ax]:.3e} s")
        lines.append("  " + self.summary_line())
        return "\n".join(lines)


def _kernel_tables(rec: ScheduleRecord):
    """``(seconds, movement)``: each kernel node's roofline seconds by
    its position, and the positions of the kernels that only move bytes
    (they neither hide comm nor impose a deadline)."""
    from . import fusion as _fusion
    secs: Dict[int, float] = {}
    movement: set = set()
    rep = _fusion.fusion_census(rec)
    for k in rep.kernels:
        idx = int(k.name.split()[0].lstrip("#"))
        name = rec.nodes[idx].name
        if name in _fusion.MOVEMENT_OPS or k.flops <= 0:
            movement.add(idx)
            continue
        secs[idx] = k.roofline_s()
    return secs, movement


def _first_real_consumer(rec: ScheduleRecord, sids: set, after: int,
                         movement: set) -> Optional[int]:
    """Position of the first node after ``after`` that NEEDS one of
    ``sids``: a computing kernel or a collective. Views, allocations
    and data movement pass the value on (their outputs join the set)."""
    live = set(sids)
    for n in rec.nodes[after + 1:]:
        if not any(o.sid in live for o in n.inputs):
            continue
        if n.kind in ("kernel", "op") and n.index not in movement:
            return n.index
        if n.kind == "collective":
            return n.index
        live.update(o.sid for o in n.outputs)
        live.update(n.writes)
        live.update(n.meta.get("aliases", ()))
    return None


def _active_bucket_bytes() -> Optional[int]:
    try:
        from ..gluon.fused_step import _zero_bucket_bytes
        return int(_zero_bucket_bytes())
    except Exception:            # pragma: no cover - defensive
        return None


def overlap_census(rec: ScheduleRecord, profile=None) -> OverlapReport:
    """Exposed (non-overlapped) communication seconds per mesh axis of
    one schedule record; ``profile`` a ``BandwidthProfile`` (default:
    the active ``MXNET_SHARDING_BANDWIDTH`` profile)."""
    from . import program as _program
    from . import sharding as _sharding

    report = OverlapReport()
    try:
        profile = profile or _sharding.bandwidth_profile()
        report.profile = profile.name
        report.zero_bucket_bytes = _active_bucket_bytes()
        census = _program.collective_census(rec)
        by_name = {c.name: c for c in census.ops}
        kernel_s, movement = _kernel_tables(rec)
        comm_pos = {n.index for n in rec.nodes
                    if n.kind in ("collective", "wait")}
        comp = str(rec.meta.get("mode", "step"))
        for node in rec.collectives:
            cop = by_name.get(node.label)
            if cop is None:
                continue
            wire = _sharding.collective_wire_bytes(cop)
            gbps = profile.gbps(cop.axes)
            comm_s = wire / (gbps * 1e9) if gbps > 0 else 0.0
            p = node.index
            is_async = "wait" in node.meta
            if is_async:
                start, end = p, node.meta["wait"]
                out_sids = {o.sid for o in rec.nodes[end].outputs}
            else:
                start = -1
                for o in node.inputs:
                    w = rec.last_writer(o.sid, p)
                    if w is not None:
                        start = max(start, w.index)
                out_sids = {o.sid for o in node.outputs}
                first = _first_real_consumer(rec, out_sids, p, movement)
                end = first if first is not None else len(rec.nodes)
                end = max(end, p + 1)
            # forward taint: what depends on the collective's result
            tainted = set(out_sids)
            hide_s, n_hiders = 0.0, 0
            for i in range(max(0, start + 1), min(end, len(rec.nodes))):
                other = rec.nodes[i]
                if any(o.sid in tainted for o in other.inputs):
                    tainted.update(o.sid for o in other.outputs)
                    tainted.update(other.writes)
                    continue
                if i == p or i in comm_pos:
                    continue        # comm can't hide comm
                s = kernel_s.get(i, 0.0)
                if s > 0.0:
                    hide_s += s
                    n_hiders += 1
            exposed = max(0.0, comm_s - hide_s)
            ax = cop.axes[0] if cop.axes else "?"
            report.windows.append(CollectiveWindow(
                name=node.label, kind=cop.kind, axis=ax, comm_s=comm_s,
                hide_s=hide_s, exposed_s=exposed, n_hiders=n_hiders,
                window=(start, end), computation=comp,
                is_async=is_async))
            report.n_async += 1 if is_async else 0
            report.total_comm_s += comm_s
            report.exposed_comm_s += exposed
            report.per_axis_total_s[ax] = \
                report.per_axis_total_s.get(ax, 0.0) + comm_s
            report.per_axis_exposed_s[ax] = \
                report.per_axis_exposed_s.get(ax, 0.0) + exposed
    except Exception:            # pragma: no cover - defensive
        _LOG.debug("overlap census failed", exc_info=True)
    report.windows.sort(key=lambda w: -w.exposed_s)
    return report


# ---------------------------------------------------------------------------
# baseline regression gate
# ---------------------------------------------------------------------------

def load_baselines(path: str) -> Dict[str, Any]:
    """Per-leg overlap baselines: ``{leg: {exposed_comm_s,
    overlap_fraction, tol_pct}}`` (``_comment`` keys ignored)."""
    with open(path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    return {k: v for k, v in raw.items() if not k.startswith("_")}


def check_baseline(report: OverlapReport, baselines: Dict[str, Any],
                   leg: str) -> List[Finding]:
    """Diff a step's overlap posture against a checked-in baseline (the
    JAX bands: ``exposed_comm_s`` may grow by tol_pct at most (1 µs
    floor), ``overlap_fraction`` may fall by tol_pct relative or 0.05
    absolute at most); violations are error-severity
    ``overlap-regression`` findings."""
    base = baselines.get(leg)
    findings: List[Finding] = []
    if base is None:
        findings.append(Finding(
            checker="overlap", rule="overlap-regression",
            severity="warn",
            message=f"no overlap baseline for leg {leg!r} — add it to "
                    "the baselines file", where=leg))
        return findings
    tol = float(base.get("tol_pct", 50.0)) / 100.0
    e_base = float(base.get("exposed_comm_s", 0.0))
    e_band = max(e_base * (1.0 + tol), e_base + 1e-6)
    if report.exposed_comm_s > e_band:
        findings.append(Finding(
            checker="overlap", rule="overlap-regression",
            message=f"[{leg}] exposed comm {report.exposed_comm_s:.3e}"
                    f" s exceeds baseline {e_base:.3e} s by more than "
                    f"{base.get('tol_pct', 50.0)}% — communication "
                    "this step used to hide behind compute is exposed "
                    "again", where=leg))
    f_base = base.get("overlap_fraction")
    if f_base is not None:
        f_floor = min(float(f_base) * (1.0 - tol),
                      float(f_base) - 0.05)
        if report.overlap_fraction < f_floor:
            findings.append(Finding(
                checker="overlap", rule="overlap-regression",
                message=f"[{leg}] overlap fraction "
                        f"{report.overlap_fraction:.3f} fell below "
                        f"baseline {float(f_base):.3f} — the step "
                        "stopped interleaving collectives with "
                        "independent compute", where=leg))
    return findings


def baseline_from_env() -> Optional[tuple]:
    """``MXNET_OVERLAP_BASELINE=<path>[:<leg>]`` → (baselines dict,
    leg-or-None); None when unset or unreadable (logged)."""
    spec = os.environ.get("MXNET_OVERLAP_BASELINE")
    if not spec:
        return None
    path, leg = spec, None
    if ":" in spec and not os.path.exists(spec):
        path, leg = spec.rsplit(":", 1)
    try:
        return load_baselines(path), leg
    except Exception as e:       # pragma: no cover - defensive
        _LOG.warning("MXNET_OVERLAP_BASELINE=%r unreadable (%s: %s)",
                     spec, type(e).__name__, e)
        return None


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def publish(report: OverlapReport):
    """Refresh the exposed-comm gauges from one census."""
    try:
        from ..telemetry import names as tn
        from ..telemetry import registry as treg
        reg = treg()
        for ax in report.per_axis_exposed_s:
            reg.gauge(tn.SHARDING_EXPOSED_COMM).set(
                report.per_axis_exposed_s[ax], label=ax)
        reg.gauge(tn.OVERLAP_FRACTION).set(report.overlap_fraction)
    except Exception:            # pragma: no cover - defensive
        _LOG.debug("overlap gauge publish failed", exc_info=True)
