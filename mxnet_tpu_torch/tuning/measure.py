"""Measurement backends: how one candidate config becomes one score
(counterpart of ``mxnet_tpu/tuning/measure.py``).

Two backends behind one interface (``measure(config, fidelity) ->
MeasureResult``; the score is seconds a step or a served row, lower is
better):

- **timed** (:class:`TimedStepBackend`, :class:`TimedPredictorBackend`):
  the card's truth. The candidate is applied and the real step (or the
  bucket's captured program) runs ``warmup`` + ``steps x fidelity``
  times through a fresh :class:`~mxnet_tpu_torch.engine.DispatchWindow`;
  the score is the wall time at the drain over the steps.
- **analytical** (:class:`AnalyticalStepBackend`,
  :class:`AnalyticalPredictorBackend`): the CPU's. The step's FLOPs
  (``CompiledTrainStep.step_flops``) and memory traffic on the H100's
  roofline, plus the reference's closed forms of what the program
  cannot express: dispatch overhead amortised over the in-flight window,
  the collective count of the ZeRO layout, the coalescing delay of the
  serving knobs. Deterministic: the same space always picks the same
  winner.

``auto`` (``MXNET_AUTOTUNE_BACKEND``) is timed where the step or the
predictor lives on a card and analytical on the CPU.

A candidate that FAILS (out of memory, a lost device, a refused launch)
is scored infeasible (``feasible=False``, score inf) through
``elastic.detect.classify`` instead of ending the search; the
``autotune.trial`` fault point brackets every measurement.
"""
from __future__ import annotations

import logging
import math
import os
import time
from typing import Any, Dict, Optional

from . import space as _space
from ..testing.faults import fault_point

__all__ = ["MeasureResult", "TimedStepBackend", "AnalyticalStepBackend",
           "TimedPredictorBackend", "AnalyticalPredictorBackend",
           "backend_mode", "select_step_backend",
           "select_predictor_backend", "HOST_DISPATCH_S",
           "COLLECTIVE_LAT_S", "H100_HBM_BYTES_S", "H100_PEAK_FLOPS"]

_LOG = logging.getLogger("mxnet_tpu_torch.tuning")

#: host dispatch overhead a step, which the in-flight window amortises
#: (overhead / (1 + W)), and the fixed latency of one collective: the
#: JAX package's model constants, kept so that both packages' analytical
#: backends rank the same candidates alike (not a measurement of the
#: port)
HOST_DISPATCH_S = 300e-6
COLLECTIVE_LAT_S = 5e-6

#: the roofline of an H100 80GB HBM3 (SXM, 700 W), from its data sheet:
#: HBM3 at 3.35 TB/s; 67 TFLOP/s float32 on the CUDA cores and 989
#: TFLOP/s bfloat16 dense on the tensor cores (the figures PERF.md's
#: bounds use)
H100_HBM_BYTES_S = 3.35e12
H100_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

INFEASIBLE = float("inf")


class MeasureResult:
    """One trial's verdict: ``score`` seconds (inf when infeasible), the
    feasibility flag and reason, and the backend's terms."""

    def __init__(self, score: float, feasible: bool = True,
                 reason: str = "", detail: Optional[dict] = None):
        self.score = float(score)
        self.feasible = bool(feasible)
        self.reason = reason
        self.detail = detail or {}

    @classmethod
    def infeasible(cls, reason: str) -> "MeasureResult":
        return cls(INFEASIBLE, feasible=False, reason=reason)

    def __repr__(self):
        if not self.feasible:
            return f"MeasureResult(infeasible: {self.reason})"
        return f"MeasureResult({self.score:.3e}s)"


def _classify(exc: BaseException) -> str:
    from ..elastic import detect as _d
    return _d.classify(exc)


def guarded_measure(backend, config: Dict[str, Any],
                    fidelity: int = 1) -> MeasureResult:
    """One measurement under the fault discipline: the ``autotune.trial``
    fault point brackets it, and any failure becomes an infeasible score
    tagged with its failure class (the next candidate may be fine)."""
    try:
        fault_point("autotune.trial", "before")
        out = backend.measure(config, fidelity=fidelity)
        fault_point("autotune.trial", "after")
        return out
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as e:
        return infeasible(e, config)


def infeasible(exc: BaseException, config) -> MeasureResult:
    """The infeasible score of a candidate whose measurement raised
    ``exc``, tagged with its failure class."""
    kind = _classify(exc)
    _LOG.warning("autotune: candidate %r infeasible (%s: %s: %s)",
                 config, kind, type(exc).__name__, exc)
    return MeasureResult.infeasible(f"{kind}: {type(exc).__name__}: {exc}")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _roofline(dtype: str):
    """(peak FLOP/s of ``dtype``'s products, HBM bytes/s) of the H100."""
    return H100_PEAK_FLOPS.get(dtype, H100_PEAK_FLOPS["float32"]), \
        H100_HBM_BYTES_S


def _compute_dtype(params) -> str:
    """What the products run in: bfloat16 under ``amp`` or with bfloat16
    weights, else float32."""
    import torch
    from .. import amp as _amp
    if _amp.is_enabled():
        return "bfloat16"
    for p in params:
        return "bfloat16" if p.dtype == torch.bfloat16 else "float32"
    return "float32"


def _cfg_value(config: Dict[str, Any], name: str):
    if name in config:
        return config[name]
    t = _space.get(name)
    return t.resolve() if t is not None else None


def _program_key(config: Dict[str, Any], tunables) -> tuple:
    """The program-affecting slice of a candidate: the step's programs
    are captured anew when it changes."""
    return tuple((t.name, config.get(t.name, t.default))
                 for t in tunables if t.affects_program)


class _StepPrograms:
    """What a step backend knows of the step's programs: the
    program-affecting slice they were captured under (None: not yet)."""

    def _use(self, config: Dict[str, Any]):
        """Drop the step's programs when ``config``'s slice is another
        than the last one's."""
        key = _program_key(config, self._tunables)
        if self._last_key is not None and key != self._last_key:
            self._step._drop_programs()
        self._last_key = key

    def settle(self, config: Dict[str, Any]):
        """After the search: the programs left must be those of the
        applied ``config``."""
        if self._last_key is not None:
            self._use(config)


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _static_traffic(step, args, kwargs) -> float:
    """Bytes one step moves at the least, from its static buffers: every
    parameter read and written, its gradient written and read, each
    optimizer state read and written, and the batch read. Leaves out the
    activations and every other intermediate (what a capture's pool
    holds), which only a capture measures."""
    from ..gluon.fused_step import _flatten
    tr = step._trainer
    opt = tr._optimizer
    total = 0
    for i, p in enumerate(tr._params):
        st = tr._updater.states.get(i)
        if st is None:
            st = opt.create_state_multi_precision(i, p.detach())
        total += 4 * _nbytes(p)
        total += 2 * sum(_nbytes(s) for s in opt.state_tensors(st))
    leaves: list = []
    _flatten((tuple(args), dict(kwargs)), leaves)
    total += sum(_nbytes(x) if hasattr(x, "numel") else int(x.nbytes)
                 for x in leaves if hasattr(x, "nbytes")
                 or hasattr(x, "numel"))
    return float(total)


# ---------------------------------------------------------------------------
# train-step backends
# ---------------------------------------------------------------------------

class AnalyticalStepBackend(_StepPrograms):
    """A deterministic score for one ``CompiledTrainStep`` bucket:

    ``max(flops / F, traffic / B)``  (the step on the H100's roofline,
    F by the step's compute dtype)
    ``+ HOST_DISPATCH_S / (1 + inflight)``  (window amortisation)
    ``+ 2 * zero_units(min_size) * COLLECTIVE_LAT_S``  (collective count)
    ``+ exposed_comm_s``

    FLOPs are ``step.step_flops`` (one eager forward and backward under
    ``FlopCounterMode`` plus the kernels' own counts). Traffic is the
    capture's ``MemoryReport`` (argument + output + pool bytes) where the
    step is captured on a card, else :func:`_static_traffic` (the static
    buffers; activations left out). Both are probed once per distinct
    program-affecting slice. ``exposed_comm_s`` and ``overlap_fraction``
    come from the overlap census (``analysis/overlap.py``) of the
    candidate's schedule record (``CompiledTrainStep.lower_entry``, the
    candidate's ``zero.*`` bucketing in force) where the step has
    collectives (the ``zero`` and ``mesh`` modes, the split program): a
    bucketing that hides its reduce-scatters behind the backward scores
    better than one that serialises them, at equal FLOPs and traffic.
    A one-card step has none: 0 and 1.0. Under a dp group every rank
    records its candidate alike (the record runs the step's
    collectives).

    ``exposed_comm_s`` is not validated on the card, and there the order
    it gives is the wrong one: on four H100s (BERT-base, ZeRO dp 4, 8 x
    512 a rank, ``chip_smoke.py`` phase 21c) it scores 4 MiB buckets
    0.57 ms better than one bucket, yet the bucketed step takes 116.0
    ms against the serial 85.4 (timed in alternating turns). The eager
    ZeRO step is host-bound, each bucket costs ~0.4 ms of host time to
    issue, and the last rank to reach a collective has no kernel queued
    to hide it behind; this score counts none of that."""

    name = "analytical"
    deterministic = True

    def __init__(self, step, args, kwargs=None,
                 batch_size: Optional[int] = None, tunables=()):
        self._step = step
        self._args = tuple(args)
        self._kwargs = kwargs or {}
        self._batch_size = batch_size
        self._tunables = tuple(tunables)
        self._probes: Dict[tuple, dict] = {}
        self._last_key: Optional[tuple] = None

    def _probe(self, config: Dict[str, Any]) -> dict:
        key = _program_key(config, self._tunables)
        hit = self._probes.get(key)
        if hit is not None:
            return hit
        step = self._step
        with _space.trial(config):
            flops = step.step_flops(*self._args,
                                    batch_size=self._batch_size,
                                    **self._kwargs)
            if flops is None:
                # the eager mode: no program to score; every candidate
                # ties and the defaults win
                probe = {"flops": 0.0, "traffic_bytes": 0.0,
                         "exposed_comm_s": 0.0, "overlap_fraction": 1.0}
            else:
                traffic = None
                if step.device.type == "cuda" and step.mode == "fused":
                    self._use(config)
                    step.aot_compile(*self._args,
                                     batch_size=self._batch_size,
                                     **self._kwargs)
                    rep = step.memory_report()
                    if rep is not None:
                        traffic = float(rep.argument_bytes
                                        + rep.output_bytes
                                        + (rep.temp_bytes or 0))
                if traffic is None:
                    traffic = _static_traffic(step, self._args,
                                              self._kwargs)
                exposed, frac = self._overlap(config)
                probe = {"flops": float(flops), "traffic_bytes": traffic,
                         "exposed_comm_s": exposed,
                         "overlap_fraction": frac}
        self._probes[key] = probe
        return probe

    def _overlap(self, config: Dict[str, Any]):
        """``(exposed_comm_s, overlap_fraction)`` of the candidate's
        schedule record; ``(0.0, 1.0)`` without collectives."""
        from ..analysis.overlap import overlap_census
        step = self._step
        if step.mode not in ("zero", "mesh") and not step._split:
            return 0.0, 1.0
        self._use(config)
        info = step.lower_entry(*self._args, batch_size=self._batch_size,
                                **self._kwargs)
        rep = overlap_census(info["schedule"])
        return float(rep.exposed_comm_s), float(rep.overlap_fraction)

    def _zero_units(self, min_size) -> int:
        """Reduce-scatter / all-gather units under a candidate bucket
        floor: host arithmetic over the trainable parameters, the split
        of ``_ZeroShardPlan`` (a parameter of at least ``min_size``
        elements, or a low-precision one under ``multi_precision``, is a
        unit of its own; the rest make one bucket unit a dtype)."""
        from ..optimizer.optimizer import LOW_PRECISION
        step = self._step
        if step._zero is None and step._zero_ok is None:
            return 0
        try:
            min_size = int(min_size)
        except (TypeError, ValueError):
            return 0
        opt = step._trainer._optimizer
        mp = bool(getattr(opt, "multi_precision", False))
        solo, bucket_dtypes = 0, set()
        for p in step._trainer._params:
            if (mp and p.dtype in LOW_PRECISION) or p.numel() >= min_size:
                solo += 1
            else:
                bucket_dtypes.add(str(p.dtype))
        return solo + len(bucket_dtypes)

    def measure(self, config: Dict[str, Any],
                fidelity: int = 1) -> MeasureResult:
        probe = self._probe(config)
        F, B = _roofline(_compute_dtype(self._step._trainer._params))
        t_program = max(probe["flops"] / F, probe["traffic_bytes"] / B)
        w = _cfg_value(config, "engine.inflight_steps")
        w = 0 if w is None else max(0, int(w))
        t_host = HOST_DISPATCH_S / (1.0 + w)
        n_units = self._zero_units(
            _cfg_value(config, "zero.shard_min_size"))
        t_coll = 2 * n_units * COLLECTIVE_LAT_S   # RS + AG a unit
        t_exposed = float(probe.get("exposed_comm_s", 0.0))
        score = t_program + t_host + t_coll + t_exposed
        if not math.isfinite(score):
            return MeasureResult.infeasible("non-finite analytical score")
        return MeasureResult(score, detail={
            "t_program": t_program, "t_host": t_host,
            "t_collective": t_coll, "flops": probe["flops"],
            "traffic_bytes": probe["traffic_bytes"],
            "zero_units": n_units, "exposed_comm_s": t_exposed,
            "overlap_fraction": probe.get("overlap_fraction", 1.0),
            "zero_bucket_bytes": _cfg_value(config, "zero.bucket_bytes")})


def _wait(loss):
    loss.cpu()      # waits for the step's device work


class TimedStepBackend(_StepPrograms):
    """The card's truth for one ``CompiledTrainStep`` bucket: apply the
    candidate, run ``warmup`` + ``steps x fidelity`` real steps through a
    fresh :class:`~mxnet_tpu_torch.engine.DispatchWindow` whose depth is
    the candidate's ``engine.inflight_steps``, and score the seconds a
    step at the drain.

    Trials RUN the step, so the orchestrator snapshots and restores the
    whole train state around the search (``tuning.tune_step``). A
    candidate whose program-affecting slice differs from the last one's
    drops the step's programs first (``CompiledTrainStep.
    _drop_programs``: the graphs and their pool go at once, so one
    recapture's memory is what a trial holds); the recapture is part of
    its cost, which ``MXNET_AUTOTUNE_BUDGET_TRIALS`` bounds."""

    name = "timed"
    deterministic = False

    def __init__(self, step, args, kwargs=None,
                 batch_size: Optional[int] = None, tunables=(),
                 warmup: int = 2, steps: int = 4):
        self._step = step
        self._args = tuple(args)
        self._kwargs = kwargs or {}
        self._batch_size = batch_size
        self._tunables = tuple(tunables)
        self._warmup = max(1, int(warmup))
        self._steps = max(1, int(steps))
        self._last_key: Optional[tuple] = None

    def measure(self, config: Dict[str, Any],
                fidelity: int = 1) -> MeasureResult:
        from .. import engine as _engine
        step = self._step
        with _space.trial(config):
            self._use(config)
            n = self._steps * max(1, int(fidelity))
            window = _engine.DispatchWindow(
                _wait, max_inflight=_engine.inflight_steps(),
                what="autotune trial step")

            def run(tag=None):
                window.push(step(*self._args, batch_size=self._batch_size,
                                 **self._kwargs), tag=tag)

            for _ in range(self._warmup):
                run()
            window.drain()
            t0 = time.perf_counter()
            for i in range(n):
                run(i)
            window.drain()
            dt = time.perf_counter() - t0
        return MeasureResult(dt / n, detail={
            "steps": n, "wall_s": dt, "inflight": window.max_inflight})


# ---------------------------------------------------------------------------
# predictor backends
# ---------------------------------------------------------------------------

def _padded(example, bucket: int) -> tuple:
    from ..serving.predictor import _is_batched, pad_rows
    return tuple(pad_rows(a, bucket) if _is_batched(a) else a
                 for a in example)


def _serving_knobs(config):
    m = _cfg_value(config, "serving.max_batch")
    m = 1 if m is None else max(1, int(m))
    timeout_ms = _cfg_value(config, "serving.batch_timeout_ms")
    timeout_ms = 0.0 if timeout_ms is None else float(timeout_ms)
    return m, timeout_ms


class AnalyticalPredictorBackend:
    """A deterministic latency a served row for one ``CompiledPredictor``
    + ``DynamicBatcher`` deployment:

    ``t_bucket(max_batch) / max_batch``  (compute shared by the rows)
    ``+ HOST_DISPATCH_S / max_batch``    (one dispatch a micro-batch)
    ``+ batch_timeout / 2``              (mean coalescing delay)

    ``t_bucket`` is the FLOPs of the bucket ``max_batch`` pads into
    (``CompiledPredictor.aot_compile``, which captures it as ``warmup``
    would) over the H100's peak for the net's dtype."""

    name = "analytical"
    deterministic = True

    def __init__(self, pred, example, tunables=()):
        self._pred = pred
        self._example = tuple(example)
        self._tunables = tuple(tunables)
        self._flops: Dict[int, float] = {}

    def _bucket_flops(self, bucket: int) -> float:
        hit = self._flops.get(bucket)
        if hit is not None:
            return hit
        flops = self._pred.aot_compile(*_padded(self._example, bucket))
        self._flops[bucket] = float(flops or 0.0)
        return self._flops[bucket]

    def measure(self, config: Dict[str, Any],
                fidelity: int = 1) -> MeasureResult:
        m, timeout_ms = _serving_knobs(config)
        with _space.trial(config):
            bucket = self._pred.bucket_for(m)   # raises: infeasible
            flops = self._bucket_flops(bucket)
        F, _B = _roofline(_compute_dtype(list(
            self._pred.net.parameters())))
        t_bucket = flops / F
        score = (t_bucket + HOST_DISPATCH_S) / m + timeout_ms / 2e3
        return MeasureResult(score, detail={
            "bucket": bucket, "t_bucket": t_bucket, "flops": flops,
            "max_batch": m, "timeout_ms": timeout_ms})


class TimedPredictorBackend:
    """Measured latency a row: the example padded to the candidate
    ``serving.max_batch``'s bucket, ``steps x fidelity`` replays of the
    bucket's captured program timed to the device's drain, plus the
    candidate's mean coalescing delay (the linger is policy, not
    program: modelled, not slept)."""

    name = "timed"
    deterministic = False

    def __init__(self, pred, example, tunables=(), warmup: int = 2,
                 steps: int = 8):
        self._pred = pred
        self._example = tuple(example)
        self._warmup = max(1, int(warmup))
        self._steps = max(1, int(steps))

    def measure(self, config: Dict[str, Any],
                fidelity: int = 1) -> MeasureResult:
        from ..engine import allow_sync
        from ..serving.predictor import synchronize
        m, timeout_ms = _serving_knobs(config)
        with _space.trial(config):
            bucket = self._pred.bucket_for(m)
            padded = _padded(self._example, bucket)
            n = self._steps * max(1, int(fidelity))
            for _ in range(self._warmup):
                self._pred.predict(*padded)
            with allow_sync():
                synchronize(self._pred.device)
            t0 = time.perf_counter()
            for _ in range(n):
                self._pred.predict(*padded)
            with allow_sync():
                synchronize(self._pred.device)
            dt = time.perf_counter() - t0
        score = dt / n / m + timeout_ms / 2e3
        return MeasureResult(score, detail={
            "bucket": bucket, "dispatches": n, "wall_s": dt})


# ---------------------------------------------------------------------------
# backend selection
# ---------------------------------------------------------------------------

def backend_mode() -> str:
    """``MXNET_AUTOTUNE_BACKEND``: ``auto`` (timed on a card, analytical
    on the CPU) | ``timed`` | ``analytical``."""
    v = os.environ.get("MXNET_AUTOTUNE_BACKEND", "auto").strip().lower()
    return v if v in ("timed", "analytical") else "auto"


def _pick(device) -> str:
    mode = backend_mode()
    if mode != "auto":
        return mode
    return "timed" if device.type == "cuda" else "analytical"


def select_step_backend(step, args, kwargs=None, batch_size=None,
                        tunables=()):
    cls = (TimedStepBackend if _pick(step.device) == "timed"
           else AnalyticalStepBackend)
    return cls(step, args, kwargs, batch_size=batch_size,
               tunables=tunables)


def select_predictor_backend(pred, example, tunables=()):
    cls = (TimedPredictorBackend if _pick(pred.device) == "timed"
           else AnalyticalPredictorBackend)
    return cls(pred, example, tunables=tunables)
