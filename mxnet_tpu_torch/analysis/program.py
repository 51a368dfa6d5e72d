"""Program lint: static analysis of a train step's schedule record
(counterpart of ``mxnet_tpu/analysis/program.py``).

Value-level tests prove a step computes the right numbers; this pass
proves the program is the right program — one reduce-scatter and one
all-gather a bucket instead of an all-reduce a parameter, every
parameter and optimizer state updated in place, no host round trip in
the step, bf16 staying bf16 outside the blessed float32 islands — over
the record of one run of the step's body (``analysis/schedule.py``),
where the JAX package reads the jaxpr and XLA's optimized HLO:

- **collectives** (:func:`collective_census`): the record's collective
  nodes, by logical kind, mesh axis, payload and group size;
- **donation** (:func:`donation_audit`): each parameter and optimizer
  state is written in place, by an in-place op or by ``opt_update``'s
  launch; one that is not (its update made a full-size copy, or bound a
  fresh buffer in its place) is the ``donation-copy`` finding;
  ``donated_bytes`` is the bytes updated in place;
- **host transfers** (:func:`host_transfer_scan`):
  ``_local_scalar_dense`` (``.item()``), a copy from the card to the
  CPU, and the ops whose output size depends on the data (``nonzero``,
  ``masked_select``, ``unique``), which wait for the card;
- **dtype drift** (:func:`dtype_drift_scan`): a widening copy (bf16 or
  f16 to float32, anything to float64) outside the blessed float32
  masters and amp's float32 islands;
- **retraces**: ``n_traces`` and the captured signatures.

:func:`analyze_step` takes a ``CompiledTrainStep``'s record
(``lower_entry``) and runs every checker, the kernel census, the
sharding audit and the overlap census included; :func:`expect_mode`
appends the mode's spec pack.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

from .guard import HOST_SYNC_OPS
from .report import (CollectiveOp, CollectiveStats, DonationAudit, Finding,
                     ProgramReport)
from .schedule import MATMUL_OPS, ScheduleRecord

__all__ = ["collective_census", "donation_audit", "host_transfer_scan",
           "dtype_drift_scan", "analyze_schedule", "analyze_lowered",
           "analyze_step", "analyze_info", "expect_mode", "mode_spec_pack",
           "explain_signature_diff", "analysis_mode"]

_LOG = logging.getLogger("mxnet_tpu_torch.analysis")

# dtype widths for drift direction checks
_WIDTH = {"bool": 0, "int8": 1, "uint8": 1, "bfloat16": 2, "float16": 2,
          "int16": 2, "float32": 4, "int32": 4, "float64": 8, "int64": 8}


def analysis_mode(requested: Optional[str]) -> Optional[str]:
    """Normalize the ``analyze=`` kwarg / MXNET_ANALYSIS env setting to
    one of None | 'report' | 'warn' | 'raise' (the JAX package's)."""
    v = requested if requested is not None \
        else os.environ.get("MXNET_ANALYSIS")
    if v is None or v is False:
        return None
    if v is True:
        return "warn"
    v = str(v).strip().lower()
    if v in ("", "0", "off", "false", "no", "none"):
        return None
    if v in ("1", "report"):
        return "report"
    if v in ("warn", "log"):
        return "warn"
    if v in ("raise", "error", "strict"):
        return "raise"
    _LOG.warning("unknown analysis mode %r (MXNET_ANALYSIS); "
                 "treating as 'warn'", v)
    return "warn"


# ---------------------------------------------------------------------------
# collective census
# ---------------------------------------------------------------------------

def collective_census(rec: ScheduleRecord) -> CollectiveStats:
    """Every collective of the record, as the JAX census's records."""
    stats = CollectiveStats()
    for n in rec.collectives:
        m = n.meta
        stats.ops.append(CollectiveOp(
            kind=m.get("kind", n.name), name=n.label,
            elements=int(m.get("elements", 0)), dtype=n.dtype or "?",
            axes=tuple(a for a in m.get("axes", ()) if a),
            group_size=int(m.get("group_size", 0)),
            operand_count=max(1, len(n.inputs))))
    return stats


# ---------------------------------------------------------------------------
# donation audit
# ---------------------------------------------------------------------------

def donation_audit(rec: ScheduleRecord,
                   expected: Optional[int] = None) -> DonationAudit:
    """Were the record's watched tensors (``meta["watch"]``: the
    parameters, optimizer states and float32 masters the step updates)
    written in place? A watched tensor no node wrote in place is a copy
    of its update per step (or a fresh buffer bound in its place, which
    a captured graph would not see)."""
    audit = DonationAudit(expected=expected)
    watch = rec.meta.get("watch", {})
    sizes = rec.meta.get("watch_bytes", {})
    written = rec.written_sids
    i = 0
    for role in ("params", "states", "masters"):
        for j, sid in enumerate(watch.get(role, ())):
            audit.declared += 1
            if sid in written:
                audit.aliased += 1
                audit.aliased_params.append(i)
                audit.donated_bytes += int(sizes.get(role, [0] * (j + 1))[j])
            else:
                audit.copied.append(i)
            i += 1
    return audit


# ---------------------------------------------------------------------------
# host transfers
# ---------------------------------------------------------------------------

def host_transfer_scan(rec: ScheduleRecord) -> List[Finding]:
    """The record's host syncs: a scalar read, a copy from a device to
    the CPU, a data-dependent output size. Each one is a device round
    trip per step (and, on a card, a capture the step cannot take)."""
    out: List[Finding] = []
    for n in rec.nodes:
        if n.kind != "op":
            continue
        if n.name in HOST_SYNC_OPS:
            out.append(Finding(
                checker="program", rule="host-transfer",
                message=f"`{n.name}` reads a tensor on the host inside "
                        "the step", where=n.label))
        elif n.name in ("_to_copy", "copy_") and \
                n.meta.get("src_device") not in (None, "cpu") and \
                n.meta.get("dst_device") == "cpu":
            out.append(Finding(
                checker="program", rule="host-transfer",
                message=f"`{n.name}` copies a {n.meta['src_device']} "
                        "tensor to the CPU inside the step",
                where=n.label))
    return out


# ---------------------------------------------------------------------------
# dtype drift
# ---------------------------------------------------------------------------

#: the ops a float64 copy may feed on the CPU without drifting
_PRODUCT_OPS = frozenset(MATMUL_OPS | {"convolution",
                                      "convolution_backward"})


def _feeds_a_product(rec: ScheduleRecord, i: int) -> bool:
    """Whether node ``i``'s output goes straight into a product: the
    next node that is neither a view, an allocation nor another float64
    copy is a product that reads it (nothing ran in between, so the
    storage id cannot have been reused)."""
    nodes, j = rec.nodes, i + 1
    while j < len(nodes) and (nodes[j].kind in ("view", "alloc") or (
            nodes[j].name == "_to_copy"
            and nodes[j].meta.get("dst_dtype") == "float64")):
        j += 1
    return j < len(nodes) and nodes[j].name in _PRODUCT_OPS and \
        nodes[i].outputs[0].sid in {o.sid for o in nodes[j].inputs}


def dtype_drift_scan(rec: ScheduleRecord,
                     blessed: Optional[Sequence[Tuple[str, str]]] = None
                     ) -> List[Finding]:
    """Widening float copies (``_to_copy`` / ``copy_`` into a wider float
    dtype). Narrowing (amp's casts to bf16) is free; widening doubles
    the bytes. ``blessed`` (src, dst) pairs are intentional (the float32
    masters of ``multi_precision``, amp's float32 islands); to float64 is
    never blessed. On the CPU a float32 copy to float64 that goes
    straight into a product is the port's exact accumulation of a
    float32 product (``ops.nn.linear`` / ``conv``), not drift."""
    blessed = {tuple(b) for b in (blessed or ())}
    out: List[Finding] = []
    for i, n in enumerate(rec.nodes):
        if n.kind != "op" or n.name not in ("_to_copy", "copy_") or str(
                n.meta.get("backward_of", "")).startswith("ToCopyBackward"):
            # a gradient going back through a narrowing cast to its
            # source dtype
            continue
        if n.meta.get("dst_dtype") == "float64" and \
                n.meta.get("src_dtype") == "float32" and \
                n.meta.get("src_device") == "cpu" and n.outputs and \
                _feeds_a_product(rec, i):
            # the CPU's float64 accumulation of a float32 product
            # (ops.nn.linear / conv)
            continue
        src, dst = n.meta.get("src_dtype"), n.meta.get("dst_dtype")
        if src not in _WIDTH or dst not in _WIDTH:
            continue
        if _WIDTH[dst] <= _WIDTH[src]:
            continue
        if not (src.startswith(("float", "bfloat"))
                and dst.startswith(("float", "bfloat"))):
            continue   # integer index promotions are not drift
        is_blessed = (src, dst) in blessed and dst != "float64"
        out.append(Finding(
            checker="program", rule="dtype-drift",
            severity="error" if dst == "float64" else "warn",
            blessed=is_blessed,
            message=f"widening convert {src} -> {dst} in the step"
                    + (" (blessed by the multi-precision master list)"
                       if is_blessed else ""),
            where=n.label))
    return out


# ---------------------------------------------------------------------------
# whole-program analysis
# ---------------------------------------------------------------------------

def analyze_schedule(rec: ScheduleRecord, expected_donated=None,
                     blessed_dtypes=None, mode: str = "?",
                     table=None, declared=()) -> ProgramReport:
    """Every program checker over one schedule record (the counterpart
    of the JAX ``analyze_lowered``): the collective census, donation,
    host transfers, dtype drift, the kernel census, the sharding audit
    (``table``: the step's sharding table) and the overlap census, with
    the baseline gates of ``MXNET_FUSION_BASELINE`` /
    ``MXNET_OVERLAP_BASELINE`` and the gauges."""
    from . import fusion as _fusion
    from . import overlap as _overlap
    from . import sharding as _sharding
    report = ProgramReport(mode=mode)
    report.collectives = collective_census(rec)
    report.sharding = _sharding.audit_sharding(
        report.collectives, table=table, rec=rec, declared=declared)
    _sharding.publish(report.sharding)
    report.donation = donation_audit(rec, expected=expected_donated)
    report.host_transfers = host_transfer_scan(rec)
    report.dtype_drift = dtype_drift_scan(rec, blessed=blessed_dtypes)
    try:
        report.fusion = _fusion.fusion_census(rec)
        report.findings.extend(report.fusion.findings)
        env = _fusion.baseline_from_env()
        if env is not None:
            baselines, leg = env
            report.findings.extend(_fusion.check_baseline(
                report.fusion, baselines, leg or mode))
        _fusion.publish(report.fusion)
    except Exception:       # pragma: no cover - defensive
        _LOG.debug("fusion census failed", exc_info=True)
    try:
        report.overlap = _overlap.overlap_census(rec)
        report.findings.extend(report.overlap.findings)
        env = _overlap.baseline_from_env()
        if env is not None:
            baselines, leg = env
            report.findings.extend(_overlap.check_baseline(
                report.overlap, baselines, leg or mode))
        _overlap.publish(report.overlap)
    except Exception:       # pragma: no cover - defensive
        _LOG.debug("overlap census failed", exc_info=True)
    for p in report.donation.copied:
        report.add(Finding(
            checker="program", rule="donation-copy",
            message=f"watched tensor #{p} (a parameter, optimizer state "
                    "or master) was not updated in place — a full "
                    "buffer copy every step", where=f"param {p}"))
    if expected_donated is not None and \
            report.donation.aliased < expected_donated:
        report.add(Finding(
            checker="program", rule="donation-copy",
            message=f"only {report.donation.aliased} of "
                    f"{expected_donated} param/state buffers updated in "
                    "place", where="in-place writes"))
    return report


#: the JAX name of :func:`analyze_schedule`
analyze_lowered = analyze_schedule


def analyze_step(step, *args, batch_size=None, **kwargs) -> ProgramReport:
    """Record one run of a ``CompiledTrainStep``'s body for this batch
    (``lower_entry``: no update count advances, the weights, states and
    generators are put back) and run the full program lint. The result
    is cached with the signature's record."""
    info = step.lower_entry(*args, batch_size=batch_size, **kwargs)
    if info is None:
        report = ProgramReport(mode=step.mode or "eager")
        report.n_traces = step.n_traces
        report.add(Finding(
            checker="program", rule="not-compiled", severity="warn",
            message="step runs on the eager path "
                    f"({step.mode!r}); there is no step program to "
                    "lint — the transfer guard (MXNET_TRANSFER_GUARD) "
                    "still covers its hot loop"))
        return report
    if info.get("report") is not None:
        return info["report"]
    report = analyze_info(info)
    report.n_traces = step.n_traces
    mem = step.memory_report()
    report.memory = mem.to_dict() if mem is not None else None
    info["report"] = report
    return report


def analyze_info(info: dict) -> ProgramReport:
    """The lint of a ``lower_entry`` dict (a step's, the predictor's, the
    decode engine's), with the mode's expectations."""
    report = analyze_schedule(
        info["schedule"], expected_donated=info.get("expected_donated"),
        blessed_dtypes=info.get("blessed_dtypes"),
        mode=info.get("mode", "?"), table=info.get("table"))
    report.meta.update({k: v for k, v in info.items()
                        if k in ("mode", "axis", "unit_sizes", "n_params",
                                 "n_state_leaves", "gather_sizes",
                                 "mesh_size")})
    expect_mode(report)
    return report


# ---------------------------------------------------------------------------
# mode expectations
# ---------------------------------------------------------------------------

def mode_spec_pack(mode: str, axis: Optional[str] = None, unit_sizes=(),
                   gather_sizes=()) -> Optional[object]:
    """The :class:`~.sharding.SpecPack` of one of the port's modes:

    - ``zero``: >= 1 reduce_scatter and >= 1 all_gather on the dp axis,
      no all-reduce carrying exactly one unit's gradient, the weight
      gathers declared by their payloads (a group's rows);
    - ``mesh``: the dp gradient reduction must exist (the JAX
      ``fused-mesh``);
    - ``split``: the dist store's reduction of the split program,
      declared (the store sums on the host, so none is required of it);
    - ``fused`` (one card) / ``predict`` / ``decode``: no collectives at
      all (warn).
    """
    from . import sharding as _sharding
    R = _sharding.CollectiveRule
    units = frozenset(int(u) for u in (unit_sizes or ()))
    gathers = frozenset(int(g) for g in (gather_sizes or ()))
    if mode == "zero":
        rules = [
            R("reduce_scatter", axis=axis, min_count=1,
              rule_id="collective-mismatch"),
            R("all_gather", axis=axis, min_count=1,
              rule_id="collective-mismatch"),
        ]
        if units:
            rules.append(R("all_reduce", axis=axis, max_count=0,
                           elements=units,
                           rule_id="per-param-allreduce"))
        return _sharding.SpecPack(
            name="zero-dp",
            description="ZeRO-1 sharded update (reduce-scatter grads, "
                        "shard-local update, all-gather weights)",
            axes=(axis,) if axis else (), rules=tuple(rules),
            declared=(R("all_reduce", axis=axis),
                      R("all_gather", axis=axis,
                        elements=(gathers | units) or None)),
            max_reshard_bytes=None, state_axis=axis)
    if mode == "mesh":
        return _sharding.SpecPack(
            name="mesh-dp",
            description="replicated update after an all-reduce of every "
                        "gradient over the dp mesh",
            axes=(axis,) if axis else (),
            rules=(R(("all_reduce", "reduce_scatter"), axis=axis,
                     min_count=1, rule_id="collective-mismatch"),),
            declared=(R("all_reduce", axis=axis),
                      R("reduce_scatter", axis=axis)),
            max_reshard_bytes=None)
    if mode == "split":
        return _sharding.SpecPack(
            name="split-dp",
            description="the dist store's split program (graph of the "
                        "gradients, the store's sum, graph of the update)",
            declared=(R(("all_reduce", "broadcast", "reduce_scatter",
                         "all_gather")),),
            max_reshard_bytes=None)
    if mode in ("fused", "predict", "decode"):
        what = {"fused": "single-device fused step",
                "predict": "serving predict program",
                "decode": "decode step program"}[mode]
        return _sharding.SpecPack(
            name=f"{mode}-single",
            description=f"{what} (no partitioning expected)",
            rules=(R("*", max_count=0, rule_id="collective-mismatch",
                     severity="warn"),))
    return None


def expect_mode(report: ProgramReport, mode: Optional[str] = None,
                axis: Optional[str] = None) -> ProgramReport:
    """Append the mode's structural invariants as findings: its spec
    pack (``expect_spec``: the collective signature, implicit reshards,
    the sharded-state byte budget), the ``MXNET_SHARDING_BASELINE``
    gate, and the fusion pack. In the JAX package a stranded op is an
    error (XLA fuses elementwise work); the port runs each aten op as a
    kernel of its own, so its stranded ops are a warning, the ranking
    that fusion work starts from."""
    from . import sharding as _sharding
    mode = mode or report.mode
    axis = axis or report.meta.get("axis")
    pack = mode_spec_pack(mode, axis=axis,
                          unit_sizes=report.meta.get("unit_sizes") or (),
                          gather_sizes=report.meta.get("gather_sizes")
                          or ())
    if pack is not None:
        _sharding.expect_spec(report, pack,
                              mesh_size=report.meta.get("mesh_size"))
    audit = report.sharding
    if audit is not None:
        env = _sharding.baseline_from_env()
        if env is not None:
            baselines, leg = env
            report.findings.extend(_sharding.check_baseline(
                audit, baselines, leg or mode))
        _sharding.publish(audit)
    fr = report.fusion
    if mode in ("fused", "mesh", "zero", "predict", "decode", "split") \
            and fr is not None and fr.stranded:
        worst = fr.stranded[0]
        report.add(Finding(
            checker="fusion", rule="stranded-op", severity="warn",
            message=f"{len(fr.stranded)} fusable op(s) above the "
                    f"{fr.stranded_floor} B floor stranded between "
                    f"kernels in the {mode} step ({fr.stranded_bytes} B; "
                    f"worst: `{worst.opcode}` {worst.bytes} B at "
                    f"{worst.name})", where=worst.name))
    return report


# ---------------------------------------------------------------------------
# retrace accounting
# ---------------------------------------------------------------------------

def explain_signature_diff(old, new) -> str:
    """Human-readable diff of two ``CompiledTrainStep`` signatures — WHY
    the second one captured a program of its own."""
    if old is None:
        return "first trace (no prior signature to compare)"
    from ..gluon.fused_step import explain_signature_diff as _diff
    return _diff(old, new)
