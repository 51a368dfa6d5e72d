"""Structured findings and reports of the program checkers (counterpart
of ``mxnet_tpu/analysis/report.py``, the same classes and fields).

Every checker in ``mxnet_tpu_torch.analysis`` speaks one vocabulary: a
``Finding`` names the rule that fired, where, and how bad it is; a
``ProgramReport`` aggregates one train step's census numbers
(collectives, donation, host transfers, dtype drift, retraces) plus the
findings derived from them. The program is the step's schedule record
(``analysis/schedule.py``: the aten ops, hand-written kernels and
collectives one run of the step's body issues), where the JAX package
reads XLA's optimized HLO. Numerics tests prove the step computes the
right thing; the report proves the program IS the right program.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Finding", "CollectiveOp", "CollectiveStats", "DonationAudit",
           "ProgramReport"]

# severity order for filtering
_SEV = {"error": 2, "warn": 1, "info": 0}


@dataclass
class Finding:
    """One rule violation (or blessed exception) from any checker.

    ``checker`` is the pass that produced it (``program`` | ``source`` |
    ``guard``), ``rule`` the stable machine id (``host-transfer``,
    ``donation-copy``, ``dtype-drift``, ``collective-mismatch``,
    ``MXA0xx`` for source rules), ``where`` a human location
    (``file:line``, a schedule node, or an argument label)."""
    checker: str
    rule: str
    message: str
    where: str = ""
    severity: str = "error"
    blessed: bool = False

    def __str__(self):
        tag = f"[{self.rule}]" + (" (blessed)" if self.blessed else "")
        loc = f" at {self.where}" if self.where else ""
        return f"{self.severity.upper()} {tag}{loc}: {self.message}"


@dataclass
class CollectiveOp:
    """One collective of the step. ``kind`` is the LOGICAL kind: the
    ZeRO step's ``collectives.reduce_scatter_rows`` (one
    ``all_to_all_single`` and a rank-ordered sum) is a ``reduce_scatter``
    whose ``elements`` are the row a rank keeps, as a native
    reduce-scatter's result. ``decomposed`` keeps the JAX field (an
    XLA:CPU reduce-scatter split into all-reduce + slice); the port's
    records never set it."""
    kind: str                 # all_reduce|all_gather|reduce_scatter|...
    name: str                 # schedule node, e.g. #412 reduce_scatter
    elements: int             # result element count
    dtype: str
    axes: Tuple[str, ...]     # mesh axes the replica groups span, if known
    group_size: int           # devices participating per group
    operand_count: int = 1    # tensors carried (combined/tupled ops > 1)
    decomposed: bool = False

    def to_dict(self):
        return {"kind": self.kind, "name": self.name,
                "elements": self.elements, "dtype": self.dtype,
                "axes": list(self.axes), "group_size": self.group_size,
                "operand_count": self.operand_count,
                "decomposed": self.decomposed}


@dataclass
class CollectiveStats:
    """Census over every collective in one compiled program."""
    ops: List[CollectiveOp] = field(default_factory=list)

    def count(self, kind: Optional[str] = None,
              axis: Optional[str] = None) -> int:
        n = 0
        for op in self.ops:
            if kind is not None and op.kind != kind:
                continue
            if axis is not None and op.axes and axis not in op.axes:
                continue
            n += 1
        return n

    @property
    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            out[op.kind] = out.get(op.kind, 0) + 1
        return out

    def per_axis(self) -> Dict[str, Dict[str, int]]:
        """kind counts per mesh axis (ops with unknown groups land under
        the pseudo-axis ``'?'``)."""
        out: Dict[str, Dict[str, int]] = {}
        for op in self.ops:
            for ax in (op.axes or ("?",)):
                out.setdefault(ax, {})
                out[ax][op.kind] = out[ax].get(op.kind, 0) + 1
        return out

    def total_elements(self, kind: Optional[str] = None) -> int:
        return sum(op.elements for op in self.ops
                   if kind is None or op.kind == kind)

    def matching(self, kind: str, sizes) -> List[CollectiveOp]:
        """Collectives of ``kind`` whose payload element count equals one
        of ``sizes`` — the per-parameter-collective detector."""
        sizes = set(int(s) for s in sizes)
        return [op for op in self.ops
                if op.kind == kind and op.elements in sizes]

    def to_dict(self):
        return {"by_kind": self.by_kind, "per_axis": self.per_axis(),
                "ops": [op.to_dict() for op in self.ops]}


@dataclass
class DonationAudit:
    """Were the step's parameters and optimizer states updated in place?
    ``declared`` counts the tensors the step must update (the
    counterpart of the JAX package's donated arguments), ``aliased`` those
    the record shows written in place (an in-place op, or the
    ``opt_update`` launch), ``copied`` the numbers of the others: a
    parameter or state whose update made a full-size copy or bound a
    fresh buffer in its place. ``donated_bytes`` is the bytes updated in
    place."""
    declared: int = 0
    aliased: int = 0
    copied: List[int] = field(default_factory=list)
    donated_bytes: int = 0          # bytes updated in place
    aliased_params: List[int] = field(default_factory=list)
    expected: Optional[int] = None  # caller's expectation (param+state)

    @property
    def ok(self) -> bool:
        if self.copied:
            return False
        if self.expected is not None:
            return self.aliased >= self.expected
        return True

    def to_dict(self):
        return {"declared": self.declared, "aliased": self.aliased,
                "copied": self.copied, "donated_bytes": self.donated_bytes,
                "expected": self.expected}


@dataclass
class ProgramReport:
    """Everything the program lint measured about ONE compiled step
    program, plus the findings the checkers derived.  ``mode`` and
    ``meta`` carry the CompiledTrainStep context (fused/zero/split,
    mesh axes, unit sizes) the expectation helpers key on."""
    mode: str = "?"
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    donation: DonationAudit = field(default_factory=DonationAudit)
    host_transfers: List[Finding] = field(default_factory=list)
    dtype_drift: List[Finding] = field(default_factory=list)
    findings: List[Finding] = field(default_factory=list)
    n_traces: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)
    #: the captured programs' memory accounting (telemetry.MemoryReport
    #: .to_dict()) — None where nothing was captured
    memory: Optional[Dict[str, int]] = None
    #: kernel census of the record (analysis.fusion.FusionReport)
    fusion: Optional[Any] = None
    #: sharding audit (analysis.sharding.ShardingAudit): the step plan's
    #: sharding table, implicit reshards, and per-axis comm cost
    sharding: Optional[Any] = None
    #: exposed-communication analysis (analysis.overlap.OverlapReport)
    #: over the record's issue order
    overlap: Optional[Any] = None

    def add(self, finding: Finding):
        self.findings.append(finding)

    def all_findings(self, min_severity: str = "info",
                     include_blessed: bool = False) -> List[Finding]:
        floor = _SEV[min_severity]
        out = []
        for f in (self.findings + self.host_transfers + self.dtype_drift):
            if f.blessed and not include_blessed:
                continue
            if _SEV.get(f.severity, 0) >= floor:
                out.append(f)
        return out

    @property
    def ok(self) -> bool:
        """No error-severity findings survived blessing."""
        return not self.all_findings(min_severity="error")

    def raise_if_findings(self, min_severity: str = "error"):
        bad = self.all_findings(min_severity=min_severity)
        if bad:
            from ..base import MXNetError
            raise MXNetError(
                "program analysis found "
                f"{len(bad)} violation(s) in the step program "
                f"(mode={self.mode}):\n" +
                "\n".join(f"  {f}" for f in bad))

    def _unblessed(self, fs: List[Finding]) -> List[Finding]:
        return [f for f in fs if not f.blessed]

    def to_dict(self):
        return {
            "mode": self.mode,
            "n_traces": self.n_traces,
            "collectives": self.collectives.by_kind,
            "collectives_per_axis": self.collectives.per_axis(),
            "donated_bytes": self.donation.donated_bytes,
            "donation": self.donation.to_dict(),
            "host_transfers": len(self._unblessed(self.host_transfers)),
            "dtype_drift": len(self._unblessed(self.dtype_drift)),
            "memory": self.memory,
            "fusion": self.fusion.brief() if self.fusion is not None
            else None,
            "sharding": self.sharding.brief()
            if self.sharding is not None else None,
            "overlap": self.overlap.brief()
            if self.overlap is not None else None,
            "findings": [str(f) for f in self.all_findings()],
        }

    def summary(self) -> str:
        lines = [f"ProgramReport(mode={self.mode}, "
                 f"n_traces={self.n_traces})"]
        bk = self.collectives.by_kind
        lines.append("  collectives : " +
                     (", ".join(f"{k}={v}" for k, v in sorted(bk.items()))
                      if bk else "none"))
        pa = self.collectives.per_axis()
        for ax in sorted(pa):
            lines.append(f"    axis {ax!r}: " + ", ".join(
                f"{k}={v}" for k, v in sorted(pa[ax].items())))
        d = self.donation
        lines.append(f"  donation    : declared={d.declared} "
                     f"aliased={d.aliased} copied={len(d.copied)} "
                     f"bytes={d.donated_bytes}")
        if self.memory:
            m = self.memory
            lines.append(f"  memory      : peak~{m['peak_bytes']} "
                         f"(args={m['argument_bytes']} "
                         f"temp={m['temp_bytes']} "
                         f"out={m['output_bytes']} "
                         f"code={m['generated_code_bytes']} "
                         f"donated={m['donated_bytes']})")
        if self.fusion is not None:
            lines.append("  fusion      : " + self.fusion.summary_line())
        if self.sharding is not None:
            lines.append("  sharding    : "
                         + self.sharding.summary_line())
        if self.overlap is not None:
            lines.append("  overlap     : "
                         + self.overlap.summary_line())
        n_bless = len(self.host_transfers) + len(self.dtype_drift) \
            - len(self._unblessed(self.host_transfers)) \
            - len(self._unblessed(self.dtype_drift))
        lines.append("  host xfers  : "
                     f"{len(self._unblessed(self.host_transfers))}")
        lines.append("  dtype drift : "
                     f"{len(self._unblessed(self.dtype_drift))}"
                     + (f" (+{n_bless} blessed)" if n_bless else ""))
        fl = self.all_findings()
        lines.append(f"  findings    : {len(fl)}")
        for f in fl:
            lines.append(f"    {f}")
        return "\n".join(lines)
