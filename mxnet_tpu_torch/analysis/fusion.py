"""Kernel census of a schedule record (counterpart of
``mxnet_tpu/analysis/fusion.py``: the same report classes, baseline gate
and gauges, over the port's record where the JAX package reads XLA's
fusions).

In the JAX package everything inside one XLA fusion streams through
registers and everything at a kernel boundary goes through HBM. In the
port every aten op of the record is a kernel of its own (PyTorch runs
them unfused) and each hand-written kernel is one fused kernel, so:

1. **Kernels** (:func:`fusion_census`): every ``op`` and ``kernel`` node
   of the record, with its kind (``custom`` for a hand-written kernel,
   ``dot`` / ``convolution`` for a product, ``input`` for a reduction,
   ``loop`` for any other aten op), an op census (a plain version's
   folded ops), a FLOP estimate and the bytes it reads and writes.
2. **The ideal-fusion diff**: (a) *stranded ops*: elementwise, convert,
   broadcast and transpose kernels (:data:`FUSABLE_OPS`) above a size
   floor whose input another kernel wrote and whose output a later
   kernel reads, each two HBM round trips a fused kernel would save;
   :meth:`FusionReport.stranded_chains` joins them into the chains they
   form, ranked by bytes; (b) *boundary materializations*: intermediates
   a kernel writes and a later one reads, ranked by bytes; (c) each
   kernel's arithmetic intensity against the H100's roofline ridge of
   its dtype.
3. **Regression gate** (:func:`check_baseline`,
   ``MXNET_FUSION_BASELINE=<path>[:<leg>]``; the port's baselines are
   ``tests/fixtures/torch_fusion_baselines.json``).

FLOPs: products 2·M·N·K, convolutions 2·out·(Cin/g)·k, reductions one
an input element, other ops one an output element (the JAX census's
rules), and the hand-written kernels the JAX package's custom-call rules
(:func:`register_custom_call_flops`) at the node's operand shapes. The
roofline constants are the H100 SXM's: 67 TFLOP/s float32 (no tensor
cores), 989 TFLOP/s bf16 / f16 dense, 3.35 TB/s HBM3.
"""
from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .report import Finding
from .schedule import MATMUL_OPS, REDUCE_OPS, Node, ScheduleRecord

__all__ = ["FusionKernel", "StrandedOp", "Boundary", "FusionReport",
           "fusion_census", "op_flops", "register_custom_call_flops",
           "load_baselines", "check_baseline", "baseline_from_env",
           "publish", "peak_flops", "STRANDED_FLOOR_BYTES",
           "BOUNDARY_FLOOR_BYTES", "RIDGE_FLOPS_PER_BYTE",
           "PEAK_TFLOPS", "HBM_BANDWIDTH_GBPS", "FUSABLE_OPS"]

_LOG = logging.getLogger("mxnet_tpu_torch.analysis")

#: the H100 SXM's peak rates by the kernel's dtype (TFLOP/s, dense) and
#: its HBM3 bandwidth (GB/s): the bounds ``PERF.md`` §6 uses
PEAK_TFLOPS = {"float32": 67.0, "bfloat16": 989.0, "float16": 989.0,
               "float64": 34.0}
HBM_BANDWIDTH_GBPS = 3350.0
#: float32's ridge point (FLOPs a byte) splits compute- from memory-bound
RIDGE_FLOPS_PER_BYTE = PEAK_TFLOPS["float32"] * 1e12 / \
    (HBM_BANDWIDTH_GBPS * 1e9)

#: byte floor below which a stranded op is scalar glue, not a finding
STRANDED_FLOOR_BYTES = 4096
#: byte floor above which a boundary materialization earns a finding
BOUNDARY_FLOOR_BYTES = 1 << 20

#: aten ops a fused kernel could absorb (elementwise, convert, broadcast,
#: transpose): one of them between two kernels is a missed fusion
FUSABLE_OPS = frozenset({
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "maximum", "minimum", "clamp", "clamp_", "clamp_min", "clamp_max",
    "abs", "neg", "exp", "exp_", "expm1", "log", "log1p", "tanh",
    "sigmoid", "sqrt", "rsqrt", "pow", "sign", "floor", "ceil", "round",
    "sin", "cos", "erf", "erfc", "gelu", "gelu_backward", "relu",
    "relu_", "threshold_backward", "where", "eq", "ne", "lt", "le", "gt",
    "ge", "logical_not", "logical_and", "bitwise_not", "masked_fill",
    "masked_fill_", "_to_copy", "copy_", "clone", "expand_copy",
    "transpose_copy", "permute_copy", "fill_", "zero_", "addcmul",
    "addcmul_", "addcdiv", "addcdiv_", "lerp", "lerp_", "tanh_backward",
    "sigmoid_backward", "native_dropout", "native_dropout_backward",
    "bernoulli", "bernoulli_", "reciprocal", "square", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "cat", "constant_pad_nd", "index_select", "embedding",
    "embedding_dense_backward", "select_backward", "slice_backward",
})

#: ops that only move bytes (the overlap census neither counts them as
#: hiders nor as a deadline)
MOVEMENT_OPS = frozenset({"_to_copy", "copy_", "clone", "cat",
                          "constant_pad_nd", "expand_copy",
                          "transpose_copy", "permute_copy", "fill_",
                          "zero_", "zeros", "zeros_like", "ones",
                          "ones_like", "full", "full_like", "new_zeros",
                          "scalar_tensor", "lift_fresh_copy",
                          "select_backward", "slice_backward", "stack",
                          "split_with_sizes_copy", "index_select"})


def peak_flops(dtype: str) -> float:
    """The H100's peak FLOP/s for kernels of ``dtype``."""
    return PEAK_TFLOPS.get(dtype, PEAK_TFLOPS["float32"]) * 1e12


# ---------------------------------------------------------------------------
# FLOP model
# ---------------------------------------------------------------------------

_CUSTOM_CALL_FLOPS: List[tuple] = []


def register_custom_call_flops(name: str, fn, match: Optional[str] = None):
    """Register a FLOP estimator for hand-written kernel nodes:
    ``fn(node, record|None) -> int`` runs for a kernel node whose name
    equals ``match`` (default ``name``). Re-registering a ``name``
    replaces it."""
    key = (match or name).lower()
    for i, (n, _, _) in enumerate(_CUSTOM_CALL_FLOPS):
        if n == name:
            _CUSTOM_CALL_FLOPS[i] = (name, key, fn)
            return
    _CUSTOM_CALL_FLOPS.append((name, key, fn))


def _custom_call_flops(node: Node, rec: Optional[ScheduleRecord]) -> int:
    name = node.name.lower()
    for _, key, fn in _CUSTOM_CALL_FLOPS:
        if key == name:
            try:
                return int(fn(node, rec))
            except Exception:      # estimator bug must not kill a census
                _LOG.debug("kernel flop estimator failed for %s",
                           node.label, exc_info=True)
                return 0
    return int(node.meta.get("wrapper_flops") or 0) \
        if not callable(node.meta.get("wrapper_flops")) else 0


def _dims(node: Node, i: int) -> List[int]:
    return list(node.inputs[i].shape) if i < len(node.inputs) else []


def _prod(dims) -> int:
    out = 1
    for d in dims:
        out *= int(d)
    return out


def _flash_fwd_flops(node: Node, rec=None) -> int:
    # q (..., Sq, D), k (..., Sk, D): two (Sq x Sk x D) products a head
    q, k = _dims(node, 0), _dims(node, 1)
    if len(q) < 3 or len(k) < 3:
        return 0
    return 4 * _prod(q[:-2]) * q[-2] * k[-2] * q[-1]


def _flash_bwd_flops(factor: int):
    def fn(node: Node, rec=None) -> int:
        return _flash_fwd_flops(node, rec) // 4 * factor
    return fn


def _rnn_scan_flops(node: Node, rec=None) -> int:
    # xw (T, N, G*H) + w_hh (G*H, H): T h2h products + gates
    xw = _dims(node, 0)
    if len(xw) < 2:
        return 0
    if len(xw) == 2:               # the decode step: one time step
        xw = [1] + xw
    t, n, gh = xw[0], xw[1], xw[2]
    w = next((d for d in (_dims(node, i)
                          for i in range(1, len(node.inputs)))
              if len(d) == 2 and d[0] == gh), None)
    h = w[1] if w else gh
    return 2 * t * n * gh * h + 10 * t * n * gh


def _elementwise_flops(per_element: int):
    def fn(node: Node, rec=None) -> int:
        widest = max((o.elements for o in node.inputs), default=0)
        return per_element * max(node.elements, widest)
    return fn


def _opt_update_flops(node: Node, rec=None) -> int:
    # 10 FLOPs an updated element: the JAX rule a unit, summed over the
    # entries of the port's one launch a list (``meta["elements"]``: the
    # gradients' elements)
    el = node.meta.get("elements")
    if el is None:
        el = max((o.elements for o in node.inputs), default=0)
    return 10 * int(el)


# the kernel layer (ops/attention.py + ops/kernels/), the JAX rules
register_custom_call_flops("flash_attention_fwd", _flash_fwd_flops,
                           match="flash_fwd")
register_custom_call_flops("flash_attention_bwd_dq",
                           _flash_bwd_flops(6), match="flash_bwd_dq")
register_custom_call_flops("flash_attention_bwd_dkv",
                           _flash_bwd_flops(8), match="flash_bwd_dkv")
register_custom_call_flops("flash_attention_bwd_fused",
                           _flash_bwd_flops(10), match="flash_bwd_fused")
register_custom_call_flops("flash_attention_bwd",
                           _flash_bwd_flops(14), match="flash_bwd")
register_custom_call_flops("rnn_scan_fwd", _rnn_scan_flops,
                           match="rnn_scan_fwd")
register_custom_call_flops("rnn_scan_bwd", _rnn_scan_flops,
                           match="rnn_scan_bwd")
register_custom_call_flops("rnn_decode", _rnn_scan_flops,
                           match="rnn_decode")
register_custom_call_flops("opt_update", _opt_update_flops,
                           match="opt_update")
register_custom_call_flops("layernorm_fwd", _elementwise_flops(8),
                           match="layernorm_fwd")
register_custom_call_flops("layernorm_bwd", _elementwise_flops(12),
                           match="layernorm_bwd")
register_custom_call_flops("bias_gelu_fwd", _elementwise_flops(15),
                           match="bias_gelu_fwd")
register_custom_call_flops("bias_gelu_bwd", _elementwise_flops(18),
                           match="bias_gelu_bwd")


def op_flops(node: Node, rec: Optional[ScheduleRecord] = None) -> int:
    """Estimated FLOPs of one record node: a hand-written kernel by its
    rule, an aten op by the record's (products, convolutions,
    reductions, elementwise); 0 for views, allocations, collectives."""
    if node.kind == "kernel":
        return _custom_call_flops(node, rec)
    if node.kind == "op":
        return int(node.flops)
    return 0


def _kind_of(node: Node) -> str:
    if node.kind == "kernel":
        return "custom"
    if node.name in MATMUL_OPS:
        return "dot"
    if node.name in ("convolution", "convolution_backward"):
        return "convolution"
    if node.name in REDUCE_OPS:
        return "input"
    return "loop"


# ---------------------------------------------------------------------------
# report structures
# ---------------------------------------------------------------------------

@dataclass
class FusionKernel:
    """One kernel of the record: an aten op or a hand-written kernel."""
    name: str
    kind: str
    computation: str
    n_ops: int
    op_census: Dict[str, int]
    flops: int
    bytes_in: int
    bytes_out: int
    dtype: str = "float32"

    @property
    def boundary_bytes(self) -> int:
        return self.bytes_in + self.bytes_out

    @property
    def intensity(self) -> float:
        """Arithmetic intensity: FLOPs per HBM boundary byte."""
        return self.flops / self.boundary_bytes \
            if self.boundary_bytes else 0.0

    def ridge_of(self) -> float:
        return peak_flops(self.dtype) / (HBM_BANDWIDTH_GBPS * 1e9)

    def bound(self, ridge: Optional[float] = None) -> str:
        r = self.ridge_of() if ridge is None else ridge
        return "compute" if self.intensity >= r else "memory"

    def roofline_s(self) -> float:
        """The least time this kernel takes on the H100: its FLOPs over
        the dtype's peak or its bytes over HBM, the larger."""
        return max(self.flops / peak_flops(self.dtype),
                   self.boundary_bytes / (HBM_BANDWIDTH_GBPS * 1e9))

    def to_dict(self, ridge: Optional[float] = None):
        return {"name": self.name, "kind": self.kind,
                "computation": self.computation, "n_ops": self.n_ops,
                "op_census": dict(self.op_census), "flops": self.flops,
                "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                "intensity": round(self.intensity, 4),
                "bound": self.bound(), "dtype": self.dtype}


@dataclass
class StrandedOp:
    """An unfused fusable op between two kernels: its input and its
    output both go through HBM where one fused kernel would keep them
    in registers."""
    name: str
    opcode: str
    bytes: int
    producer: str           # the upstream kernel
    consumers: List[str]    # downstream kernels
    computation: str

    def to_dict(self):
        return {"name": self.name, "opcode": self.opcode,
                "bytes": self.bytes, "producer": self.producer,
                "consumers": list(self.consumers),
                "computation": self.computation}


@dataclass
class Boundary:
    """One intermediate tensor materialized between two kernels."""
    name: str
    opcode: str
    bytes: int
    consumers: List[str]
    computation: str

    def to_dict(self):
        return {"name": self.name, "opcode": self.opcode,
                "bytes": self.bytes, "consumers": list(self.consumers),
                "computation": self.computation}


@dataclass
class FusionReport:
    """Everything the census measured about ONE record, plus the
    ideal-diff findings."""
    kernels: List[FusionKernel] = field(default_factory=list)
    stranded: List[StrandedOp] = field(default_factory=list)
    boundaries: List[Boundary] = field(default_factory=list)
    boundary_bytes: int = 0
    stranded_floor: int = STRANDED_FLOOR_BYTES
    boundary_floor: int = BOUNDARY_FLOOR_BYTES
    ridge: float = RIDGE_FLOPS_PER_BYTE
    findings: List[Finding] = field(default_factory=list)
    #: stranded op -> the stranded ops it feeds (chains)
    links: Dict[str, List[str]] = field(default_factory=dict, repr=False)

    @property
    def fusions(self) -> List[FusionKernel]:
        return [k for k in self.kernels
                if k.kind in ("loop", "input", "output", "custom")]

    @property
    def n_fusions(self) -> int:
        return len(self.fusions)

    @property
    def n_kernels(self) -> int:
        return len(self.kernels)

    @property
    def total_flops(self) -> int:
        return sum(k.flops for k in self.kernels)

    @property
    def stranded_bytes(self) -> int:
        return sum(s.bytes for s in self.stranded)

    @property
    def compute_bound_pct(self) -> float:
        """FLOP-weighted share (0–100) of kernels whose arithmetic
        intensity clears their dtype's roofline ridge point."""
        total = self.total_flops
        if not total:
            return 0.0
        cb = sum(k.flops for k in self.kernels if k.bound() == "compute")
        return round(100.0 * cb / total, 2)

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for k in self.kernels:
            out[k.kind] = out.get(k.kind, 0) + 1
        return out

    def flops_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for k in self.kernels:
            out[k.kind] = out.get(k.kind, 0) + k.flops
        return out

    def stranded_chains(self, top: int = 15) -> List[Dict[str, Any]]:
        """Stranded ops joined into the chains they form (one feeds the
        next), ranked by their bytes: each ``{"ops": [...], "bytes": B,
        "n": len}`` — the HBM round trips one fused kernel a chain would
        save."""
        by_name = {s.name: s for s in self.stranded}
        fed = {c for cs in self.links.values() for c in cs}
        chains = []
        seen = set()
        for s in sorted(self.stranded, key=lambda s: int(
                s.name.split()[0].lstrip("#"))):
            if s.name in seen or s.name in fed:
                continue
            stack, ops = [s.name], []
            while stack:
                n = stack.pop()
                if n in seen:
                    continue
                seen.add(n)
                ops.append(n)
                stack.extend(self.links.get(n, ()))
            chains.append(ops)
        for s in self.stranded:           # cycles cannot occur; strays
            if s.name not in seen:
                seen.add(s.name)
                chains.append([s.name])
        out = [{"ops": [by_name[n].opcode + "@" + n.split()[0]
                        for n in ops],
                "bytes": sum(by_name[n].bytes for n in ops),
                "n": len(ops)} for ops in chains]
        out.sort(key=lambda c: -c["bytes"])
        return out[:top]

    def brief(self) -> Dict[str, Any]:
        """The four headline numbers (ProgramReport.to_dict)."""
        return {"n_fusions": self.n_fusions,
                "stranded_ops": len(self.stranded),
                "boundary_bytes": self.boundary_bytes,
                "compute_bound_pct": self.compute_bound_pct}

    def to_dict(self):
        return {
            "n_fusions": self.n_fusions,
            "n_kernels": self.n_kernels,
            "by_kind": self.by_kind(),
            "stranded_ops": len(self.stranded),
            "boundary_bytes": self.boundary_bytes,
            "compute_bound_pct": self.compute_bound_pct,
            "stranded": [s.to_dict() for s in self.stranded[:16]],
            "top_boundaries": [b.to_dict()
                               for b in self.boundaries[:16]],
            "kernels": [k.to_dict() for k in self.kernels],
        }

    def summary_line(self) -> str:
        return (f"fusions={self.n_fusions} kernels={self.n_kernels} "
                f"stranded={len(self.stranded)} "
                f"boundary_bytes={self.boundary_bytes} "
                f"compute_bound={self.compute_bound_pct}%")

    def table(self, top: int = 24) -> str:
        """Human-readable kernel table."""
        rows = sorted(self.kernels, key=lambda k: -k.flops)[:top]
        lines = [f"{'kernel':<42s}{'kind':<8s}{'ops':>4s}{'flops':>14s}"
                 f"{'bound B':>12s}{'fl/B':>8s}  bound"]
        for k in rows:
            census = ",".join(f"{o}x{n}" for o, n in sorted(
                k.op_census.items(), key=lambda kv: -kv[1])[:3])
            lines.append(
                f"{k.name[:40]:<42s}{k.kind:<8s}{k.n_ops:>4d}"
                f"{k.flops:>14d}{k.boundary_bytes:>12d}"
                f"{k.intensity:>8.2f}  {k.bound()}"
                + (f"  [{census}]" if census else ""))
        if len(self.kernels) > top:
            lines.append(f"  ... {len(self.kernels) - top} more kernels")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

def _is_kernel(node: Node) -> bool:
    return node.kind in ("op", "kernel")


def fusion_census(rec: ScheduleRecord,
                  stranded_floor_bytes: int = STRANDED_FLOOR_BYTES,
                  boundary_floor_bytes: int = BOUNDARY_FLOOR_BYTES,
                  ridge_flops_per_byte: float = RIDGE_FLOPS_PER_BYTE) \
        -> FusionReport:
    """The kernel census of one schedule record; never raises on a
    malformed record (an analyzer must not take down the run it
    observes): what it cannot read it leaves out."""
    report = FusionReport(stranded_floor=stranded_floor_bytes,
                          boundary_floor=boundary_floor_bytes,
                          ridge=ridge_flops_per_byte)
    try:
        _census(rec, report)
    except Exception:            # pragma: no cover - defensive
        _LOG.debug("fusion census failed", exc_info=True)
    return report


def _census(rec: ScheduleRecord, report: FusionReport) -> None:
    nodes = rec.nodes
    comp = str(rec.meta.get("mode", "step"))
    # sid -> the kernel node that last defined or wrote it, and the
    # kernel nodes that read it after that (in issue order)
    writer: Dict[int, Node] = {}
    readers: Dict[tuple, List[Node]] = {}
    #: node index -> the nodes that wrote its inputs (when it ran)
    producers_of: Dict[int, List[Node]] = {}
    for n in nodes:
        if not _is_kernel(n) and n.kind != "wait":
            continue
        prods = []
        for o in n.inputs:
            w = writer.get(o.sid)
            if w is not None and _is_kernel(n):
                readers.setdefault((o.sid, w.index), []).append(n)
                prods.append(w)
        producers_of[n.index] = prods
        for o in n.outputs:
            writer[o.sid] = n
        for s in n.writes:
            writer[s] = n
    for n in nodes:
        if not _is_kernel(n):
            continue
        census = {n.name: int(n.meta.get("folded_ops") or 1)}
        report.kernels.append(FusionKernel(
            name=n.label, kind=_kind_of(n), computation=comp,
            n_ops=sum(census.values()), op_census=census,
            flops=op_flops(n, rec), bytes_in=n.bytes_in,
            bytes_out=n.bytes_out, dtype=n.dtype or "float32"))
    stranded_names = {}
    for n in nodes:
        if not _is_kernel(n):
            continue
        for o in n.outputs:
            cons = readers.get((o.sid, n.index), [])
            if not cons or o.nbytes == 0:
                continue
            report.boundary_bytes += o.nbytes
            report.boundaries.append(Boundary(
                name=n.label, opcode=n.name, bytes=o.nbytes,
                consumers=[c.label for c in cons], computation=comp))
        if n.kind != "op" or n.name not in FUSABLE_OPS:
            continue
        out_bytes = n.bytes_out
        if out_bytes < report.stranded_floor:
            continue
        producers = producers_of.get(n.index, [])
        consumers = [c for o in n.outputs
                     for c in readers.get((o.sid, n.index), [])]
        if producers and consumers:
            s = StrandedOp(name=n.label, opcode=n.name, bytes=out_bytes,
                           producer=producers[0].label,
                           consumers=[c.label for c in consumers],
                           computation=comp)
            report.stranded.append(s)
            stranded_names[n.label] = [c.label for c in consumers]
    names = set(stranded_names)
    report.links = {k: [c for c in v if c in names]
                    for k, v in stranded_names.items()}
    report.boundaries.sort(key=lambda b: -b.bytes)
    report.stranded.sort(key=lambda s: -s.bytes)
    for s in report.stranded[:8]:
        report.findings.append(Finding(
            checker="fusion", rule="stranded-op", severity="warn",
            message=f"unfused `{s.opcode}` ({s.bytes} B) stranded "
                    f"between kernel `{s.producer}` and "
                    f"{len(s.consumers)} downstream kernel(s) — two "
                    "avoidable HBM round-trips per step",
            where=s.name))
    for b in report.boundaries[:5]:
        if b.bytes < report.boundary_floor:
            break
        report.findings.append(Finding(
            checker="fusion", rule="fusion-boundary", severity="warn",
            message=f"kernel boundary materializes {b.bytes} B of "
                    f"`{b.opcode}` output to HBM (read back by "
                    f"{len(b.consumers)} consumer(s)) — candidates "
                    "for fusion or recomputation",
            where=b.name))


# ---------------------------------------------------------------------------
# baseline regression gate
# ---------------------------------------------------------------------------

def load_baselines(path: str) -> Dict[str, Any]:
    """Per-leg fusion baselines: ``{leg: {n_fusions, stranded_ops,
    boundary_bytes, tol_pct}}`` (``_comment`` keys ignored)."""
    with open(path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    return {k: v for k, v in raw.items() if not k.startswith("_")}


def check_baseline(report: FusionReport, baselines: Dict[str, Any],
                   leg: str) -> List[Finding]:
    """Diff a record's kernel posture against a checked-in baseline
    (the JAX package's bands): ``n_fusions`` within ±tol_pct (at least
    ±1); ``stranded_ops`` and ``boundary_bytes`` one-sided, more than
    the baseline (+tol for bytes) is an error-severity
    ``fusion-regression`` finding."""
    base = baselines.get(leg)
    findings: List[Finding] = []
    if base is None:
        findings.append(Finding(
            checker="fusion", rule="fusion-regression", severity="warn",
            message=f"no fusion baseline for leg {leg!r} — add it to "
                    "the baselines file", where=leg))
        return findings
    tol = float(base.get("tol_pct", 25.0)) / 100.0
    n_base = int(base.get("n_fusions", 0))
    band = max(1, int(round(n_base * tol)))
    if abs(report.n_fusions - n_base) > band:
        findings.append(Finding(
            checker="fusion", rule="fusion-regression",
            message=f"[{leg}] kernel count {report.n_fusions} left the "
                    f"baseline band {n_base}±{band} — the step issues "
                    "other kernels; investigate, then refresh the "
                    "baseline if intentional", where=leg))
    s_base = int(base.get("stranded_ops", 0))
    if len(report.stranded) > s_base:
        worst = report.stranded[0]
        findings.append(Finding(
            checker="fusion", rule="fusion-regression",
            message=f"[{leg}] {len(report.stranded)} stranded op(s) vs "
                    f"baseline {s_base} — new unfused op(s) between "
                    f"kernels (worst: `{worst.opcode}` {worst.bytes} B "
                    f"at {worst.name})", where=leg))
    b_base = int(base.get("boundary_bytes", 0))
    if b_base and report.boundary_bytes > b_base * (1.0 + tol):
        findings.append(Finding(
            checker="fusion", rule="fusion-regression",
            message=f"[{leg}] materialized boundary bytes "
                    f"{report.boundary_bytes} exceed baseline {b_base} "
                    f"by more than {base.get('tol_pct', 25.0)}% — the "
                    "step round-trips more intermediate data through "
                    "HBM than it used to", where=leg))
    return findings


def baseline_from_env() -> Optional[tuple]:
    """``MXNET_FUSION_BASELINE=<path>[:<leg>]`` → (baselines dict,
    leg-or-None); None when unset or unreadable (logged, never
    raises)."""
    spec = os.environ.get("MXNET_FUSION_BASELINE")
    if not spec:
        return None
    path, leg = spec, None
    if ":" in spec and not os.path.exists(spec):
        path, leg = spec.rsplit(":", 1)
    try:
        return load_baselines(path), leg
    except Exception as e:       # pragma: no cover - defensive
        _LOG.warning("MXNET_FUSION_BASELINE=%r unreadable (%s: %s)",
                     spec, type(e).__name__, e)
        return None


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def publish(report: FusionReport):
    """Refresh the ``mx_fusion_*`` gauges from one census (the latest
    analyzed program wins)."""
    try:
        from ..telemetry import names as tn
        from ..telemetry import registry as treg
        reg = treg()
        reg.gauge(tn.FUSION_REGIONS).set(report.n_fusions)
        reg.gauge(tn.FUSION_STRANDED).set(len(report.stranded))
        reg.gauge(tn.FUSION_BOUNDARY_BYTES).set(report.boundary_bytes)
        reg.gauge(tn.FUSION_COMPUTE_BOUND).set(
            report.compute_bound_pct / 100.0)
    except Exception:            # pragma: no cover - defensive
        _LOG.debug("fusion gauge publish failed", exc_info=True)
