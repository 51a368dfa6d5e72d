"""mxnet_tpu_torch.analysis — static and runtime analysis of the port's
train steps, serving programs and host threads (counterpart of
``mxnet_tpu/analysis``).

- **schedule record** (:mod:`.schedule`): one run of a step's body
  under a ``TorchDispatchMode``: every aten op, hand-written kernel and
  collective in issue order, with shapes, dtypes and storage ids. It
  takes the place of the JAX package's ``hlo.py`` (the port has no
  HLO); every checker below reads it.
- **program lint** (:mod:`.program`): collective census, donation
  audit (in-place updates), host transfers, dtype drift, retraces.
  ``mxt.analysis.analyze_step(step, *batch)``.
- **kernel census** (:mod:`.fusion`): each aten op and kernel with its
  bytes and FLOPs, the stranded elementwise chains between them, a
  baseline gate (``MXNET_FUSION_BASELINE``).
- **sharding analysis** (:mod:`.sharding`): the step plan's sharding
  table, implicit reshards, the per-axis communication cost model, the
  mode spec packs, a baseline gate (``MXNET_SHARDING_BASELINE``).
- **overlap analysis** (:mod:`.overlap`): exposed vs total
  communication seconds over the record's issue order, a baseline gate
  (``MXNET_OVERLAP_BASELINE``).
- **source lint** (:mod:`.lint`): an AST pass over forwards and loss
  functions for capture-unsafe Python, and the thread rules over
  framework code. ``python -m mxnet_tpu_torch.analysis.lint``.
- **runtime transfer guard** (:mod:`.guard`):
  ``MXNET_TRANSFER_GUARD=log|raise`` catches device->host syncs inside
  the training hot loop.
- **concurrency audit** (:mod:`.threads`): named, audited locks, the
  lock-order graph and stall forensics.

This ``__init__`` stays import-light (PEP 562 lazy submodules).
"""
from .report import (CollectiveOp, CollectiveStats, DonationAudit,  # noqa
                     Finding, ProgramReport)
from .guard import (allow_transfers, hot_scope, transfer_guard)      # noqa

__all__ = [
    "Finding", "ProgramReport", "CollectiveOp", "CollectiveStats",
    "DonationAudit", "FusionReport",
    "analyze_step", "analyze_lowered", "collective_census",
    "donation_audit", "host_transfer_scan", "dtype_drift_scan",
    "expect_mode", "mode_spec_pack", "explain_signature_diff",
    "fusion_census", "check_baseline", "load_baselines",
    "lint_source", "lint_path", "lint_module", "lint_function",
    "lint_threads_source", "lint_threads_path",
    "load_allowlist", "filter_allowed",
    "mx_lock", "mx_rlock", "mx_condition", "ThreadReport",
    "transfer_guard", "hot_scope", "allow_transfers",
    "OpSharding", "ShardingTable", "ShardingAudit", "SpecPack",
    "CollectiveRule", "audit_sharding", "sharding_table",
    "implicit_reshards", "comm_cost", "bandwidth_profile",
    "expect_spec", "register_spec_pack", "get_spec_pack", "spec_packs",
    "overlap_census", "OverlapReport", "ScheduleRecord", "record",
]

_LAZY = {
    "analyze_step": "program", "analyze_lowered": "program",
    "collective_census": "program", "donation_audit": "program",
    "host_transfer_scan": "program", "dtype_drift_scan": "program",
    "expect_mode": "program", "mode_spec_pack": "program",
    "explain_signature_diff": "program",
    "fusion_census": "fusion", "check_baseline": "fusion",
    "load_baselines": "fusion", "FusionReport": "fusion",
    "lint_source": "lint", "lint_path": "lint", "lint_module": "lint",
    "lint_function": "lint", "load_allowlist": "lint",
    "filter_allowed": "lint",
    "lint_threads_source": "lint", "lint_threads_path": "lint",
    "mx_lock": "threads", "mx_rlock": "threads",
    "mx_condition": "threads", "ThreadReport": "threads",
    "OpSharding": "sharding", "ShardingTable": "sharding",
    "ShardingAudit": "sharding", "SpecPack": "sharding",
    "CollectiveRule": "sharding", "audit_sharding": "sharding",
    "sharding_table": "sharding", "implicit_reshards": "sharding",
    "comm_cost": "sharding", "bandwidth_profile": "sharding",
    "expect_spec": "sharding", "register_spec_pack": "sharding",
    "get_spec_pack": "sharding", "spec_packs": "sharding",
    "overlap_census": "overlap", "OverlapReport": "overlap",
    "ScheduleRecord": "schedule", "record": "schedule",
    "program": None, "lint": None, "guard": None, "schedule": None,
    "report": None, "fusion": None, "sharding": None, "overlap": None,
    "threads": None,
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(
            f".{_LAZY[name] or name}", __name__)
        if _LAZY[name] is None:
            return mod
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
