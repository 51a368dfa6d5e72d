"""Sharding analysis of a step (counterpart of
``mxnet_tpu/analysis/sharding.py``: the same cost model, spec packs,
audit, baseline gate and gauges, for what the port runs).

The JAX package reads GSPMD's ``sharding={...}`` annotations off the
optimized HLO. The port's layouts are not a compiler's choice: they are
the step's plan, so :func:`sharding_table` reads them from there —
each parameter (replicated on every rank), each optimizer-state tensor
(the ZeRO plan's shards are split over ``dp``: a rank holds 1/N of its
unit, padded; otherwise replicated) and the batch (split over ``dp``
where the mesh split it). The collectives come from the schedule
record's census (``analysis/program.py``):

1. **Sharding table** (:func:`sharding_table`): the per-buffer layout,
   as the JAX ``ShardingTable`` (``params`` rows, ``digest``,
   ``sharded_bytes``).
2. **Implicit reshards** (:func:`implicit_reshards`): collectives that
   move data (all-gather / all-to-all / permute) that no rule of the
   mode's :class:`SpecPack` declares, above the byte floor.
3. **Communication cost** (:func:`comm_cost`): ring-model wire bytes
   over a per-axis :class:`BandwidthProfile`
   (``MXNET_SHARDING_BANDWIDTH``: ``nvlink`` | ``pcie`` | GB/s, per axis
   ``dp=nvlink``). The default is the H100 SXM's NVLink 4: 900 GB/s both
   directions, 450 GB/s one way, the rate a ring step moves bytes at.
4. **Spec packs** (:func:`expect_spec`) for the modes the port has:
   ``fused-single`` (one card), ``zero-dp`` (ZeRO-1), ``mesh-dp`` (the
   replicated update after an all-reduce) and ``split-dp`` (the dist
   store's split program), and ``predict-single`` for serving. The MoE,
   pipeline and ring-attention packs wait for their modules.
5. **Baseline gate** (:func:`check_baseline`,
   ``MXNET_SHARDING_BASELINE=<path>[:<leg>]``; the port's baselines are
   ``tests/fixtures/torch_sharding_baselines.json``).

An analyzer must not take down the run it observes: what cannot be read
is left out, never raised.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .report import CollectiveOp, CollectiveStats, Finding

__all__ = [
    "OpSharding", "ParamSharding", "ShardingTable", "sharding_table",
    "Reshard", "implicit_reshards", "BandwidthProfile",
    "bandwidth_profile", "collective_wire_fraction",
    "collective_wire_bytes", "CommCost", "comm_cost", "CollectiveRule",
    "SpecPack", "register_spec_pack", "get_spec_pack", "spec_packs",
    "expect_spec", "ShardingAudit", "audit_sharding", "publish",
    "load_baselines", "check_baseline", "baseline_from_env",
    "RESHARD_FLOOR_BYTES", "NVLINK_BANDWIDTH_GBPS", "PCIE_BANDWIDTH_GBPS",
]

_LOG = logging.getLogger("mxnet_tpu_torch.analysis")

#: byte floor below which an undeclared collective is scalar glue (the
#: loss's gather, a flag), not a reshard finding
RESHARD_FLOOR_BYTES = 4096

#: per-link bandwidth, one direction (GB/s): the H100 SXM's NVLink 4
#: (18 links, 900 GB/s both ways) and PCIe Gen5 x16 (64 GB/s). Estimates
#: that rank and budget, not a network simulator
#: (MXNET_SHARDING_BANDWIDTH overrides)
NVLINK_BANDWIDTH_GBPS = 450.0
PCIE_BANDWIDTH_GBPS = 64.0

_LINK_GBPS = {"nvlink": NVLINK_BANDWIDTH_GBPS, "pcie": PCIE_BANDWIDTH_GBPS}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "float16": 2,
    "bfloat16": 2, "int32": 4, "float32": 4, "int64": 8, "float64": 8,
}

#: collective kinds that MOVE data between layouts (vs reduce it): the
#: implicit-reshard candidates
RESHARD_KINDS = ("all_gather", "all_to_all", "collective_permute")


# ---------------------------------------------------------------------------
# the sharding table
# ---------------------------------------------------------------------------

@dataclass
class OpSharding:
    """One buffer's layout: ``replicated`` or ``tiled`` (``tile_dims``
    shards a dim, ``spec`` one entry a tensor dim: None or the mesh axis
    it is split over), as the JAX class resolves it."""
    kind: str
    raw: str = ""
    tile_dims: Tuple[int, ...] = ()
    spec: Optional[Tuple[Any, ...]] = None

    @property
    def shard_count(self) -> int:
        n = 1
        for d in self.tile_dims:
            n *= d
        return n

    def describe(self) -> str:
        if self.kind == "tiled" and self.spec is not None:
            return "P(" + ", ".join("-" if s is None else str(s)
                                    for s in self.spec) + ")"
        return self.kind

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "tile_dims": list(self.tile_dims),
                "shard_count": self.shard_count,
                "spec": list(self.spec) if self.spec is not None else None,
                "describe": self.describe()}


def _replicated() -> OpSharding:
    return OpSharding(kind="replicated", raw="{replicated}")


def _split(axis: str, n: int, ndim: int) -> OpSharding:
    spec = (axis,) + (None,) * max(0, ndim - 1)
    tiles = (n,) + (1,) * max(0, ndim - 1)
    return OpSharding(kind="tiled", raw=f"{{devices=[{n}]}}",
                      tile_dims=tiles, spec=spec)


@dataclass
class ParamSharding:
    """One buffer's resolved layout."""
    index: int
    name: str
    role: str
    local_shape: Tuple[int, ...]
    global_shape: Tuple[int, ...]
    dtype: str
    bytes_local: int
    bytes_global: int
    sharding: Optional[OpSharding]

    @property
    def describe(self) -> str:
        return self.sharding.describe() if self.sharding else "?"

    def to_dict(self) -> Dict[str, Any]:
        return {"index": self.index, "name": self.name, "role": self.role,
                "local_shape": list(self.local_shape),
                "global_shape": list(self.global_shape),
                "dtype": self.dtype, "bytes_local": self.bytes_local,
                "bytes_global": self.bytes_global,
                "sharding": self.sharding.to_dict()
                if self.sharding else None}


@dataclass
class ShardingTable:
    """Per-buffer layout of one step: ``params`` holds the parameters
    (``params[...]``), the optimizer-state tensors (``states[k][j]``, k
    the ZeRO unit or the parameter) and the batch (``traced_leaves[i]``),
    the entry parameters of the JAX program in that order."""
    params: List[ParamSharding] = field(default_factory=list)
    outputs: List[ParamSharding] = field(default_factory=list)
    annotated: List[ParamSharding] = field(default_factory=list)
    num_partitions: int = 1
    mesh_axes: Tuple[str, ...] = ()

    @property
    def rows(self) -> List[ParamSharding]:
        return self.params + self.outputs + self.annotated

    def digest(self) -> str:
        """Stable fingerprint of the step's layouts."""
        h = hashlib.sha1()
        for r in sorted(self.rows, key=lambda r: (r.role, r.index,
                                                  r.name)):
            h.update(f"{r.role}:{r.index}:{r.name}:{r.dtype}:"
                     f"{r.local_shape}:"
                     f"{r.sharding.raw if r.sharding else '-'}"
                     .encode())
        return h.hexdigest()[:12]

    def sharded_bytes(self, axis: str) -> Tuple[int, int]:
        """(local, global) bytes over the buffers split over ``axis``."""
        loc = glob = 0
        for r in self.params:
            spec = r.sharding.spec if r.sharding else None
            if not spec:
                continue
            if any(s == axis or (isinstance(s, tuple) and axis in s)
                   for s in spec):
                loc += r.bytes_local
                glob += r.bytes_global
        return loc, glob

    def to_dict(self) -> Dict[str, Any]:
        return {"num_partitions": self.num_partitions,
                "mesh_axes": list(self.mesh_axes),
                "digest": self.digest(),
                "params": [r.to_dict() for r in self.params],
                "outputs": [r.to_dict() for r in self.outputs],
                "annotated": [r.to_dict() for r in self.annotated]}

    def table_str(self, top: int = 32) -> str:
        lines = [f"{'#':>3s} {'buffer':<34s}{'dtype':<10s}"
                 f"{'local':<16s}{'global':<16s}layout"]
        for r in self.rows[:top]:
            lines.append(
                f"{r.index:>3d} {r.name[:32]:<34s}{r.dtype:<10s}"
                f"{str(list(r.local_shape)):<16s}"
                f"{str(list(r.global_shape)):<16s}{r.describe}")
        if len(self.rows) > top:
            lines.append(f"  ... {len(self.rows) - top} more buffers")
        return "\n".join(lines)


def _row(table, name, t_shape, dtype, elsize, sh, global_shape=None):
    loc = tuple(int(d) for d in t_shape)
    glob = tuple(global_shape) if global_shape is not None else loc
    n_loc = 1
    for d in loc:
        n_loc *= d
    n_glob = 1
    for d in glob:
        n_glob *= d
    table.params.append(ParamSharding(
        index=len(table.params), name=name, role="parameter",
        local_shape=loc, global_shape=glob, dtype=dtype,
        bytes_local=n_loc * elsize, bytes_global=n_glob * elsize,
        sharding=sh))


def sharding_table(step, batch=()) -> ShardingTable:
    """The layout of ``step``'s buffers (a ``CompiledTrainStep`` after
    its first call), read from its plan; ``batch`` the leaves of one
    batch as the step was given them (global)."""
    from .schedule import dtype_name
    from ..optimizer.optimizer import Optimizer
    table = ShardingTable()
    mesh = (step._zero_ok or step._plain_mesh or (None, None))
    m, axis = mesh
    n = m.axis_size(axis) if m is not None else 1
    table.num_partitions = n
    table.mesh_axes = tuple(m.axis_names) if m is not None else ()
    tr = step._trainer
    for i, p in enumerate(tr._params):
        _row(table, f"params[{tr._trainable_names[i]}]"
             if i < len(getattr(tr, "_trainable_names", ()))
             else f"params[{i}]", p.shape, dtype_name(p.dtype),
             p.element_size(), _replicated())
    plan = step._zero
    if plan is not None:
        for k, u in enumerate(plan.units):
            for j, s in enumerate(plan.states[k] or ()):
                _row(table, f"states[{k}][{j}]", s.shape,
                     dtype_name(s.dtype), s.element_size(),
                     _split(axis, n, 1), (int(u["padded"]),))
            if u.get("mp") and plan.masters[k] is not None:
                mk = plan.masters[k]
                _row(table, f"masters[{k}]", mk.shape,
                     dtype_name(mk.dtype), mk.element_size(),
                     _split(axis, n, 1), (int(u["padded"]),))
    else:
        for i in range(len(tr._params)):
            st = tr._updater.states.get(i)
            for j, s in enumerate(Optimizer.state_tensors(st)
                                  if st is not None else ()):
                _row(table, f"states[{i}][{j}]", s.shape,
                     dtype_name(s.dtype), s.element_size(), _replicated())
    for i, x in enumerate(batch):
        if not hasattr(x, "shape") or not hasattr(x, "dtype"):
            continue
        shape = tuple(int(d) for d in x.shape)
        try:
            import torch
            dt = x.dtype if isinstance(x, torch.Tensor) else \
                torch.from_numpy(x[:0]).dtype
            elsize = torch.empty((), dtype=dt).element_size()
        except Exception:
            dt, elsize = getattr(x, "dtype", "?"), 4
        if m is not None and n > 1 and shape and shape[0] % n == 0:
            local = (shape[0] // n,) + shape[1:]
            _row(table, f"traced_leaves[{i}]", local, dtype_name(dt),
                 elsize, _split(axis, n, len(shape)), shape)
        else:
            _row(table, f"traced_leaves[{i}]", shape, dtype_name(dt),
                 elsize, _replicated())
    return table


# ---------------------------------------------------------------------------
# per-axis communication cost model
# ---------------------------------------------------------------------------

class BandwidthProfile:
    """Per-mesh-axis link bandwidth, GB/s (one direction).

    Built from a spec string (``MXNET_SHARDING_BANDWIDTH``): a bare link
    kind (``nvlink`` | ``pcie``) or GB/s number applies to every axis;
    ``axis=kind_or_GBps`` entries override per axis. Default: the H100's
    NVLink."""

    def __init__(self, default_gbps: float,
                 axis_gbps: Optional[Dict[str, float]] = None,
                 name: str = "custom"):
        self.default_gbps = float(default_gbps)
        self.axis_gbps = dict(axis_gbps or {})
        self.name = name

    def gbps(self, axes: Sequence[str] = ()) -> float:
        for ax in axes or ():
            if ax in self.axis_gbps:
                return self.axis_gbps[ax]
        return self.default_gbps

    @staticmethod
    def _term(term: str) -> Optional[float]:
        term = term.strip().lower()
        if term in _LINK_GBPS:
            return _LINK_GBPS[term]
        try:
            return float(term)
        except ValueError:
            return None

    @classmethod
    def parse(cls, spec: str) -> "BandwidthProfile":
        default = None
        axis: Dict[str, float] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                ax, val = part.split("=", 1)
                g = cls._term(val)
                if g is not None:
                    if ax.strip() in ("default", "*"):
                        default = g
                    else:
                        axis[ax.strip()] = g
            else:
                g = cls._term(part)
                if g is not None:
                    default = g
        if default is None:
            default = NVLINK_BANDWIDTH_GBPS
        return cls(default, axis, name=spec)


def bandwidth_profile(spec: Optional[str] = None) -> BandwidthProfile:
    """The active profile: ``spec`` > ``MXNET_SHARDING_BANDWIDTH`` env >
    the H100's NVLink."""
    spec = spec if spec is not None \
        else os.environ.get("MXNET_SHARDING_BANDWIDTH")
    if spec:
        return BandwidthProfile.parse(spec)
    return BandwidthProfile(NVLINK_BANDWIDTH_GBPS, name="nvlink")


def collective_wire_fraction(kind: str, group_size: int,
                             decomposed: bool = False) -> float:
    """Ring-model wire traffic as a FRACTION of the census record's
    payload bytes (the JAX package's model): N bucketed collectives of B
    bytes cost what one of N·B bytes costs."""
    n = max(1, group_size)
    if n == 1:
        return 0.0
    if kind == "all_gather":
        return (n - 1) / n
    if kind == "reduce_scatter":
        if decomposed:                    # payload = full input
            return (n - 1) / n
        return float(n - 1)               # payload = the 1/n shard
    if kind == "all_reduce":
        return 2 * (n - 1) / n
    if kind == "all_to_all":
        return (n - 1) / n
    return 1.0                            # permute / broadcast: one hop


def collective_wire_bytes(op: CollectiveOp) -> int:
    """Ring-algorithm bytes each participant moves over its link for
    one collective, from the record's RESULT payload (all_gather
    (n-1)/n x result, reduce_scatter (n-1) x the shard, all_reduce
    2(n-1)/n, all_to_all (n-1)/n, permute / broadcast the payload)."""
    n = max(1, op.group_size)
    b = op.elements * _DTYPE_BYTES.get(op.dtype, 4)
    if n == 1:
        return 0
    if op.kind == "all_gather":
        return b * (n - 1) // n
    if op.kind == "reduce_scatter":
        if op.decomposed:
            return b * (n - 1) // n
        return b * (n - 1)
    if op.kind == "all_reduce":
        return 2 * b * (n - 1) // n
    if op.kind == "all_to_all":
        return b * (n - 1) // n
    return b


@dataclass
class CommCost:
    """Estimated communication cost of one step's census."""
    per_op: List[Dict[str, Any]] = field(default_factory=list)
    per_axis_s: Dict[str, float] = field(default_factory=dict)
    per_axis_bytes: Dict[str, int] = field(default_factory=dict)
    total_s: float = 0.0
    total_bytes: int = 0
    profile: str = "nvlink"

    def to_dict(self) -> Dict[str, Any]:
        return {"total_s": self.total_s, "total_bytes": self.total_bytes,
                "per_axis_s": dict(self.per_axis_s),
                "per_axis_bytes": dict(self.per_axis_bytes),
                "profile": self.profile,
                "per_op": self.per_op[:24]}

    def table_str(self, top: int = 12) -> str:
        lines = [f"{'collective':<28s}{'kind':<20s}{'axis':<8s}"
                 f"{'wire B':>12s}{'est s':>12s}"]
        for r in sorted(self.per_op, key=lambda r: -r["seconds"])[:top]:
            lines.append(f"{r['name'][:26]:<28s}{r['kind']:<20s}"
                         f"{(r['axes'][0] if r['axes'] else '?'):<8s}"
                         f"{r['wire_bytes']:>12d}{r['seconds']:>12.3e}")
        for ax in sorted(self.per_axis_s):
            lines.append(f"  axis {ax!r}: {self.per_axis_bytes[ax]} B, "
                         f"~{self.per_axis_s[ax]:.3e} s/step")
        return "\n".join(lines)


def comm_cost(census: CollectiveStats,
              profile: Optional[BandwidthProfile] = None) -> CommCost:
    """Cost every collective of a census against the profile, priced per
    payload byte (the JAX package's formula)."""
    profile = profile or bandwidth_profile()
    cost = CommCost(profile=profile.name)
    for op in census.ops:
        wire = collective_wire_bytes(op)
        payload = op.elements * _DTYPE_BYTES.get(op.dtype, 4)
        frac = collective_wire_fraction(
            op.kind, op.group_size, op.decomposed)
        gbps = profile.gbps(op.axes)
        sec = payload * frac / (gbps * 1e9) if gbps > 0 else 0.0
        ax = op.axes[0] if op.axes else "?"
        cost.per_op.append({"name": op.name, "kind": op.kind,
                            "axes": list(op.axes), "wire_bytes": wire,
                            "seconds": sec})
        cost.per_axis_s[ax] = cost.per_axis_s.get(ax, 0.0) + sec
        cost.per_axis_bytes[ax] = cost.per_axis_bytes.get(ax, 0) + wire
        cost.total_s += sec
        cost.total_bytes += wire
    cost.per_op.sort(key=lambda r: -r["seconds"])
    return cost


# ---------------------------------------------------------------------------
# implicit-reshard detection
# ---------------------------------------------------------------------------

@dataclass
class CollectiveRule:
    """One declared/asserted collective pattern of a spec pack (the JAX
    class: ``kind`` a census kind, a tuple of alternatives or ``"*"``;
    ``axis``; ``elements`` payload element counts; ``min_count`` /
    ``max_count`` make it an assertion)."""
    kind: Union[str, Tuple[str, ...]]
    axis: Optional[str] = None
    min_count: int = 0
    max_count: Optional[int] = None
    elements: Optional[frozenset] = None
    rule_id: str = "spec-mismatch"
    severity: str = "error"

    @property
    def kinds(self) -> Tuple[str, ...]:
        return (self.kind,) if isinstance(self.kind, str) \
            else tuple(self.kind)

    def matches(self, op: CollectiveOp) -> bool:
        if "*" not in self.kinds and op.kind not in self.kinds:
            return False
        if self.axis is not None and op.axes and \
                self.axis not in op.axes:
            return False
        if self.elements is not None and \
                op.elements not in self.elements:
            return False
        return True

    def describe_kind(self) -> str:
        return "|".join(self.kinds)


@dataclass
class Reshard:
    """One data-moving collective the declared spec did not imply."""
    name: str
    kind: str
    axes: Tuple[str, ...]
    group_size: int
    elements: int
    dtype: str
    payload_bytes: int
    wire_bytes: int
    seconds: float
    producer: str = ""
    consumers: Tuple[str, ...] = ()

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind,
                "axes": list(self.axes), "group_size": self.group_size,
                "elements": self.elements, "dtype": self.dtype,
                "payload_bytes": self.payload_bytes,
                "wire_bytes": self.wire_bytes, "seconds": self.seconds,
                "producer": self.producer,
                "consumers": list(self.consumers)}


def _neighbors(rec, name: str):
    """(producer, consumers) of a collective node of a schedule record."""
    if rec is None:
        return "", ()
    try:
        idx = int(name.split()[0].lstrip("#"))
        node = rec.nodes[idx]
    except (ValueError, IndexError):
        return "", ()
    producer = ""
    for o in node.inputs:
        w = rec.last_writer(o.sid, idx)
        if w is not None:
            producer = w.label
            break
    outs = [o.sid for o in node.outputs]
    end = node.meta.get("wait", idx)
    if end != idx:
        outs = [o.sid for o in rec.nodes[end].outputs]
    cons = []
    for s in outs:
        cons.extend(c.label for c in rec.consumers(s, after=end)
                    if c.kind in ("op", "kernel", "collective"))
    return producer, tuple(dict.fromkeys(cons))[:8]


def implicit_reshards(census: CollectiveStats, rec=None,
                      declared: Sequence[CollectiveRule] = (),
                      floor_bytes: int = RESHARD_FLOOR_BYTES,
                      profile: Optional[BandwidthProfile] = None) \
        -> List[Reshard]:
    """Data-moving collectives that match no declared rule and clear the
    byte floor, ranked by wire bytes, each with its producer and
    consumers in the record."""
    profile = profile or bandwidth_profile()
    out: List[Reshard] = []
    for op in census.ops:
        if op.kind not in RESHARD_KINDS:
            continue
        if any(r.matches(op) for r in declared):
            continue
        payload = op.elements * _DTYPE_BYTES.get(op.dtype, 4)
        if payload < floor_bytes:
            continue
        wire = collective_wire_bytes(op)
        gbps = profile.gbps(op.axes)
        producer, consumers = _neighbors(rec, op.name)
        out.append(Reshard(
            name=op.name, kind=op.kind, axes=op.axes,
            group_size=op.group_size, elements=op.elements,
            dtype=op.dtype, payload_bytes=payload, wire_bytes=wire,
            seconds=wire / (gbps * 1e9) if gbps > 0 else 0.0,
            producer=producer, consumers=consumers))
    out.sort(key=lambda r: -r.wire_bytes)
    return out


# ---------------------------------------------------------------------------
# spec invariant packs
# ---------------------------------------------------------------------------

@dataclass
class SpecPack:
    """Declarative invariant pack of one layout (the JAX class)."""
    name: str
    description: str = ""
    axes: Tuple[str, ...] = ()
    rules: Tuple[CollectiveRule, ...] = ()
    declared: Tuple[CollectiveRule, ...] = ()
    reshard_floor: int = RESHARD_FLOOR_BYTES
    max_reshard_bytes: Optional[int] = 0
    state_axis: Optional[str] = None
    state_pad_tol: float = 0.5

    def all_declared(self) -> Tuple[CollectiveRule, ...]:
        return tuple(self.rules) + tuple(self.declared)


_SPEC_PACKS: Dict[str, SpecPack] = {}


def register_spec_pack(pack: SpecPack) -> SpecPack:
    """Register (or replace) a pack in the process-wide catalog."""
    _SPEC_PACKS[pack.name] = pack
    return pack


def get_spec_pack(name: str) -> SpecPack:
    from ..base import MXNetError
    if name not in _SPEC_PACKS:
        raise MXNetError(f"no spec pack {name!r} registered; known: "
                         f"{sorted(_SPEC_PACKS)}")
    return _SPEC_PACKS[name]


def spec_packs() -> Dict[str, SpecPack]:
    return dict(_SPEC_PACKS)


def expect_spec(report, pack: Union[SpecPack, str], rec=None,
                mesh_size: Optional[int] = None) -> List[Finding]:
    """Assert one pack's invariants against a ProgramReport (or a bare
    CollectiveStats) and append the findings (the JAX checks, in order:
    the collective signature, implicit reshards, the sharded-state byte
    budget from the table)."""
    if isinstance(pack, str):
        pack = get_spec_pack(pack)
    census = getattr(report, "collectives", report)
    audit = getattr(report, "sharding", None)
    if audit is not None and rec is None:
        rec = audit.record
    findings: List[Finding] = []
    for rule in pack.rules:
        hits = [op for op in census.ops if rule.matches(op)]
        n = len(hits)
        where = f"{rule.describe_kind()}@{rule.axis or '*'}"
        if n < rule.min_count:
            findings.append(Finding(
                checker="sharding", rule=rule.rule_id,
                severity=rule.severity,
                message=f"[{pack.name}] expected >= {rule.min_count} "
                        f"`{rule.describe_kind()}` on axis "
                        f"{rule.axis!r}, found {n} — the "
                        f"{pack.description or pack.name} collective "
                        f"signature regressed (census: {census.by_kind})",
                where=where))
        if rule.max_count is not None and n > rule.max_count:
            if rule.elements is not None:
                msg = (f"[{pack.name}] {n} `{rule.describe_kind()}`(s) "
                       "carry exactly a declared unit's payload "
                       f"({sorted(set(o.elements for o in hits))} "
                       "elements) — the sharded update is paying "
                       "replicated reductions")
                where = ", ".join(o.name for o in hits[:4])
            else:
                msg = (f"[{pack.name}] {n} `{rule.describe_kind()}` "
                       f"on axis {rule.axis!r} exceed the declared "
                       f"maximum {rule.max_count} — the step runs "
                       f"collectives the spec did not imply "
                       f"(census: {census.by_kind})")
            findings.append(Finding(
                checker="sharding", rule=rule.rule_id,
                severity=rule.severity, message=msg, where=where))
    reshards = implicit_reshards(census, rec=rec,
                                 declared=pack.all_declared(),
                                 floor_bytes=pack.reshard_floor)
    if audit is not None:
        audit.reshards = reshards
        audit.reshard_floor = pack.reshard_floor
        audit.pack = pack.name
    total = sum(r.wire_bytes for r in reshards)
    for r in reshards[:8]:
        findings.append(Finding(
            checker="sharding", rule="implicit-reshard", severity="warn",
            message=f"[{pack.name}] `{r.kind}` of {r.payload_bytes} B "
                    f"({r.wire_bytes} B on the wire, ~{r.seconds:.2e} s) "
                    f"on axis {r.axes[0] if r.axes else '?'} not implied "
                    f"by the declared spec — produced by "
                    f"`{r.producer or '?'}`, consumed by "
                    f"{', '.join(r.consumers[:3]) or '?'}",
            where=r.name))
    if pack.max_reshard_bytes is not None and \
            total > pack.max_reshard_bytes:
        worst = reshards[0]
        findings.append(Finding(
            checker="sharding", rule="implicit-reshard",
            message=f"[{pack.name}] {len(reshards)} implicit reshard(s) "
                    f"move {total} B/step above the "
                    f"{pack.reshard_floor} B floor (budget "
                    f"{pack.max_reshard_bytes} B) — worst: "
                    f"`{worst.kind}` {worst.payload_bytes} B at "
                    f"{worst.name} (producer `{worst.producer or '?'}`)",
            where=worst.name))
    if pack.state_axis and audit is not None and \
            audit.table is not None:
        n = mesh_size or audit.table.num_partitions
        loc, glob = audit.table.sharded_bytes(pack.state_axis)
        if n >= 2 and glob:
            budget = int(glob / n * (1.0 + pack.state_pad_tol))
            if loc > budget:
                findings.append(Finding(
                    checker="sharding", rule="state-budget",
                    message=f"[{pack.name}] buffers sharded on "
                            f"{pack.state_axis!r} hold {loc} B per "
                            f"replica, over the ~1/{n} budget "
                            f"{budget} B (global {glob} B) — the "
                            "sharded-state contract regressed toward "
                            "replication",
                    where=f"axis {pack.state_axis}"))
    if hasattr(report, "add"):
        for f in findings:
            report.add(f)
    return findings


# ---------------------------------------------------------------------------
# whole-step audit + report plumbing
# ---------------------------------------------------------------------------

@dataclass
class ShardingAudit:
    """The table, the (pack-aware) implicit reshards and the comm cost
    of one step; ``ProgramReport.sharding`` carries one."""
    table: Optional[ShardingTable] = None
    reshards: List[Reshard] = field(default_factory=list)
    cost: Optional[CommCost] = None
    reshard_floor: int = RESHARD_FLOOR_BYTES
    pack: Optional[str] = None
    #: the schedule record, for pack re-audits — not serialized
    record: Any = field(default=None, repr=False)

    @property
    def reshard_bytes(self) -> int:
        return sum(r.wire_bytes for r in self.reshards)

    def brief(self) -> Dict[str, Any]:
        return {"implicit_reshards": len(self.reshards),
                "reshard_bytes": self.reshard_bytes,
                "comm_cost_est_s": self.cost.total_s if self.cost
                else 0.0,
                "sharding_table_digest": self.table.digest()
                if self.table else None}

    def to_dict(self) -> Dict[str, Any]:
        d = self.brief()
        d["pack"] = self.pack
        d["per_axis_cost_s"] = dict(self.cost.per_axis_s) \
            if self.cost else {}
        d["reshards"] = [r.to_dict() for r in self.reshards[:16]]
        d["table"] = self.table.to_dict() if self.table else None
        return d

    def summary_line(self) -> str:
        return (f"params={len(self.table.params) if self.table else 0} "
                f"reshards={len(self.reshards)} "
                f"reshard_bytes={self.reshard_bytes} "
                f"comm~{self.cost.total_s if self.cost else 0.0:.2e}s "
                f"digest={self.table.digest() if self.table else '-'}")


def audit_sharding(census: CollectiveStats, table=None, rec=None,
                   declared: Sequence[CollectiveRule] = (),
                   floor_bytes: int = RESHARD_FLOOR_BYTES,
                   profile: Optional[BandwidthProfile] = None) \
        -> ShardingAudit:
    """The sharding analysis of one step: its table, the implicit
    reshards of its census against ``declared`` and the comm cost.
    Never raises."""
    try:
        profile = profile or bandwidth_profile()
        return ShardingAudit(
            table=table,
            reshards=implicit_reshards(census, rec=rec, declared=declared,
                                       floor_bytes=floor_bytes,
                                       profile=profile),
            cost=comm_cost(census, profile=profile),
            reshard_floor=floor_bytes, record=rec)
    except Exception:                    # pragma: no cover - defensive
        _LOG.debug("sharding audit failed", exc_info=True)
        return ShardingAudit()


# ---------------------------------------------------------------------------
# baseline regression gate
# ---------------------------------------------------------------------------

def load_baselines(path: str) -> Dict[str, Any]:
    """Per-leg sharding baselines: ``{leg: {implicit_reshards,
    reshard_bytes, tol_pct}}`` (``_comment`` keys ignored)."""
    with open(path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    return {k: v for k, v in raw.items() if not k.startswith("_")}


def check_baseline(audit: ShardingAudit, baselines: Dict[str, Any],
                   leg: str) -> List[Finding]:
    """Diff one step's reshard posture against a checked-in baseline
    (one-sided bands; more is an error-severity ``sharding-regression``
    finding)."""
    base = baselines.get(leg)
    findings: List[Finding] = []
    if base is None:
        findings.append(Finding(
            checker="sharding", rule="sharding-regression",
            severity="warn",
            message=f"no sharding baseline for leg {leg!r} — add it to "
                    "the baselines file", where=leg))
        return findings
    tol = float(base.get("tol_pct", 25.0)) / 100.0
    r_base = int(base.get("implicit_reshards", 0))
    if len(audit.reshards) > r_base:
        worst = audit.reshards[0] if audit.reshards else None
        detail = (f" (worst: `{worst.kind}` {worst.payload_bytes} B "
                  f"at {worst.name})") if worst else ""
        findings.append(Finding(
            checker="sharding", rule="sharding-regression",
            message=f"[{leg}] {len(audit.reshards)} implicit reshard(s) "
                    f"vs baseline {r_base} — the step now moves data "
                    f"the spec does not imply{detail}", where=leg))
    b_base = int(base.get("reshard_bytes", 0))
    if audit.reshard_bytes > max(b_base * (1.0 + tol),
                                 b_base + audit.reshard_floor):
        findings.append(Finding(
            checker="sharding", rule="sharding-regression",
            message=f"[{leg}] implicit-reshard wire bytes "
                    f"{audit.reshard_bytes} exceed baseline {b_base} by "
                    f"more than {base.get('tol_pct', 25.0)}%", where=leg))
    return findings


def baseline_from_env() -> Optional[tuple]:
    """``MXNET_SHARDING_BASELINE=<path>[:<leg>]`` -> (baselines dict,
    leg-or-None); None when unset or unreadable (logged)."""
    spec = os.environ.get("MXNET_SHARDING_BASELINE")
    if not spec:
        return None
    path, leg = spec, None
    if ":" in spec and not os.path.exists(spec):
        path, leg = spec.rsplit(":", 1)
    try:
        return load_baselines(path), leg
    except Exception as e:               # pragma: no cover - defensive
        _LOG.warning("MXNET_SHARDING_BASELINE=%r unreadable (%s: %s)",
                     spec, type(e).__name__, e)
        return None


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def publish(audit: ShardingAudit):
    """Refresh the ``mx_sharding_*`` gauges from one audit."""
    try:
        from ..telemetry import names as tn
        from ..telemetry import registry as treg
        reg = treg()
        reg.gauge(tn.SHARDING_RESHARDS).set(len(audit.reshards))
        reg.gauge(tn.SHARDING_RESHARD_BYTES).set(audit.reshard_bytes)
        if audit.cost is not None:
            g_cost = reg.gauge(tn.SHARDING_COMM_COST)
            g_bytes = reg.gauge(tn.SHARDING_COLLECTIVE_BYTES)
            for ax, sec in audit.cost.per_axis_s.items():
                g_cost.set(sec, label=ax)
            for ax, b in audit.cost.per_axis_bytes.items():
                g_bytes.set(b, label=ax)
    except Exception:                    # pragma: no cover - defensive
        _LOG.debug("sharding gauge publish failed", exc_info=True)
