"""tuning: the self-tuning performance autopilot (counterpart of
``mxnet_tpu/tuning/``).

Every hot-path knob the port ships as a constant (the shared memory a
kernel's launch plan may claim, the in-flight window's depth, the ZeRO
bucket floor and communication bucket, the serving and decode knobs) is
a declared :class:`~mxnet_tpu_torch.tuning.space.Tunable` with a grid, a
validity predicate and the seam it feeds. This package closes the loop:
it *measures* each candidate (steps timed on the card, an analytical
roofline score on the CPU), *searches* the joint space (budget-bounded
coordinate descent with successive halving; a faulting candidate is an
infeasible score) and *keeps* the winner keyed by the program's
signature, so a restarted job replays its tuned config with no trials.

Gate: ``MXNET_AUTOTUNE`` (or the entry point's ``autotune=``):

- ``off`` (default): nothing happens; every seam resolves env > default;
- ``cached``: a cached winner replays (0 trials); a miss runs the
  defaults without searching;
- ``on``: a miss runs the search (at most ``MXNET_AUTOTUNE_BUDGET_
  TRIALS`` measurements), keeps the winner in ``MXNET_AUTOTUNE_CACHE``
  and applies it.

Entry points: ``Trainer.compile_step(autotune=...)`` tunes at the step's
first call (a real batch pins the shape), ``CompiledPredictor.warmup(
autotune=...)`` before it captures the buckets.

Tunables change speed, never numerics: the timed backend snapshots and
restores the whole train state around its trials (parameters, optimizer
state and counts, the random generators, in place), the analytical one
runs no step, and the kernel tunable's grid holds only values whose
launch plans give bit-identical outputs.

Across ranks (a dp group): every rank must run the same candidates in
the same order, or the collectives of a trial step hang. Rank 0's cache
decision is broadcast, and each trial's score is the max over the ranks
(infeasible where any rank found it so) before the search decides, so
every rank walks the same trials to the same winner. The JAX package runs
one controller and needs none of this.
"""
from __future__ import annotations

import logging
import math
import os
import time as _time
from typing import Any, Dict, Optional

from . import cache, measure, search, space
from .cache import (AutotuneCache, cache_path, default_cache,
                    predictor_signature, signature_key, step_signature)
from .measure import (AnalyticalPredictorBackend, AnalyticalStepBackend,
                      MeasureResult, TimedPredictorBackend,
                      TimedStepBackend, backend_mode)
from .search import SearchResult, Trial, coordinate_search
from .space import SearchSpace, Tunable

__all__ = ["space", "measure", "search", "cache", "Tunable",
           "SearchSpace", "MeasureResult", "SearchResult", "Trial",
           "AutotuneCache", "AutotuneOutcome", "autotune_mode",
           "budget_trials", "tune_step", "tune_predictor",
           "outcomes", "last_outcome", "coordinate_search",
           "step_signature", "predictor_signature", "signature_key",
           "cache_path", "default_cache", "backend_mode"]

_LOG = logging.getLogger("mxnet_tpu_torch.tuning")


def autotune_mode(explicit: Optional[str] = None) -> str:
    """The gate, normalised: ``off`` | ``cached`` | ``on``; ``explicit``
    (the ``autotune=`` argument) wins over ``MXNET_AUTOTUNE``."""
    v = explicit if explicit is not None \
        else os.environ.get("MXNET_AUTOTUNE", "")
    if isinstance(v, bool):
        return "on" if v else "off"
    v = str(v).strip().lower()
    if v in ("on", "1", "true", "yes", "search"):
        return "on"
    if v in ("cached", "cache", "replay"):
        return "cached"
    return "off"


def budget_trials(default: int = 32) -> int:
    """``MXNET_AUTOTUNE_BUDGET_TRIALS``: the measurements one search may
    make (the default config is trial 1)."""
    try:
        v = int(os.environ.get("MXNET_AUTOTUNE_BUDGET_TRIALS",
                               str(default)))
    except (TypeError, ValueError):
        return default
    return max(1, v)


class AutotuneOutcome:
    """What one entry point's tuning did."""

    def __init__(self, mode: str, source: str, key: Optional[str] = None,
                 backend: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None,
                 trials: int = 0, delta_pct: Optional[float] = None,
                 score: Optional[float] = None,
                 default_score: Optional[float] = None):
        self.mode = mode          # off | cached | on
        self.source = source      # off | cache | default | search
        self.key = key
        self.backend = backend
        self.config = dict(config or {})   # the applied non-default slice
        self.trials = int(trials)
        self.delta_pct = delta_pct
        self.score = score
        self.default_score = default_score

    def to_dict(self) -> dict:
        return {"mode": self.mode, "source": self.source,
                "key": self.key, "backend": self.backend,
                "config": self.config, "trials": self.trials,
                "delta_pct": self.delta_pct}

    def bench_dict(self) -> dict:
        """The three fields a benchmark record carries a leg."""
        return {"autotune_config": self.config,
                "autotune_trials": self.trials,
                "autotune_delta_pct": self.delta_pct}

    def __repr__(self):
        return (f"AutotuneOutcome({self.source}, trials={self.trials}, "
                f"config={self.config})")


_OUTCOMES: list = []


def outcomes() -> list:
    """Every AutotuneOutcome this process produced, oldest first."""
    return list(_OUTCOMES)


def last_outcome() -> Optional[AutotuneOutcome]:
    return _OUTCOMES[-1] if _OUTCOMES else None


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def _telemetry():
    from .. import telemetry as _t
    return _t


def _publish_active(config: Dict[str, Any]):
    """``mx_autotune_active_config{tunable}``: a numeric value as it is,
    another as its index in the grid (which candidate is live)."""
    t = _telemetry()
    g = t.registry().gauge(t.names.AUTOTUNE_ACTIVE, label_key="tunable")
    for name, v in config.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            tn = space.get(name)
            try:
                v = tn.grid.index(v) if tn else 1
            except ValueError:
                v = -1
        g.set(float(v), label=name)


def _count(counter_name: str, label: Optional[str] = None, n: int = 1):
    t = _telemetry()
    c = t.registry().counter(
        counter_name, label_key="backend" if label is not None else None)
    if label is not None:
        c.inc(n, label=label)
    else:
        c.inc(n)


# ---------------------------------------------------------------------------
# agreement across ranks
# ---------------------------------------------------------------------------

class _Ranks:
    """The default process group's ranks, agreeing on what the search
    reads: rank 0's cache record, and each trial's score (the max over
    the ranks; infeasible where any rank found it so). Collectives go
    through a tensor on ``device`` (NCCL takes CUDA tensors, gloo CPU
    ones)."""

    def __init__(self, device):
        import torch
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")

    @staticmethod
    def active() -> bool:
        from ..parallel import dist as _dist
        return _dist.size() > 1

    def broadcast(self, obj):
        import torch.distributed as tdist
        box = [obj]
        tdist.broadcast_object_list(
            box, src=0,
            device=self.device if self.device.type == "cuda" else None)
        return box[0]


class _AgreedBackend:
    """``backend`` whose every score is agreed over the ranks. A failure
    on one rank is caught here, on that rank, so every rank still joins
    the all-reduce (a rank that left it would hang the others)."""

    def __init__(self, inner, device):
        self._inner = inner
        self._device = device
        self.name = inner.name
        self.deterministic = inner.deterministic

    def measure(self, config, fidelity: int = 1) -> MeasureResult:
        import torch
        import torch.distributed as tdist
        try:
            res = self._inner.measure(config, fidelity=fidelity)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            res = measure.infeasible(e, config)
        local = res.score if res.feasible else math.inf
        box = torch.tensor([local, 0.0 if res.feasible else 1.0],
                           dtype=torch.float64, device=self._device)
        tdist.all_reduce(box, op=tdist.ReduceOp.MAX)
        score, bad = float(box[0]), float(box[1]) > 0
        if bad or not math.isfinite(score):
            return MeasureResult.infeasible(
                res.reason or "infeasible on another rank")
        return MeasureResult(score, detail=dict(res.detail,
                                                local_score=local))


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def _tune(scope: str, key: str, make_backend, mode: str,
          budget: Optional[int], db: Optional[AutotuneCache],
          snapshot_state=None, ranks: Optional[_Ranks] = None
          ) -> AutotuneOutcome:
    t = _telemetry()
    db = db or default_cache()
    lead = ranks is None or _rank() == 0
    rec = db.get(key) if lead else None
    if ranks is not None:
        rec = ranks.broadcast(rec)
    if rec is not None and isinstance(rec.get("config"), dict):
        _count(t.names.AUTOTUNE_CACHE_HITS)
        config = dict(rec["config"])
        space.apply_config(config)
        _publish_active(config)
        out = AutotuneOutcome(mode, "cache", key=key,
                              backend=rec.get("backend"),
                              config=config, trials=0,
                              delta_pct=rec.get("delta_pct"),
                              score=rec.get("score"),
                              default_score=rec.get("default_score"))
        _OUTCOMES.append(out)
        _LOG.info("autotune[%s]: cache HIT %s -> %r", scope, key[:12],
                  config)
        return out
    _count(t.names.AUTOTUNE_CACHE_MISSES)
    if mode != "on":
        # a miss under 'cached': the defaults run, no trial
        out = AutotuneOutcome(mode, "default", key=key, trials=0)
        _OUTCOMES.append(out)
        _LOG.info("autotune[%s]: cache MISS %s (mode=cached; defaults)",
                  scope, key[:12])
        return out
    backend = make_backend()
    searched = backend if ranks is None \
        else _AgreedBackend(backend, ranks.device)
    tunables = space.tunables(scope)
    budget = budget if budget is not None else budget_trials()

    def on_trial(trial):
        _count(t.names.AUTOTUNE_TRIALS, label=backend.name)

    restore = None
    if snapshot_state is not None and not backend.deterministic:
        restore = snapshot_state()
    try:
        result = coordinate_search(tunables, searched, budget,
                                   on_trial=on_trial)
    finally:
        if restore is not None:
            restore()
    settle = getattr(backend, "settle", None)
    if settle is not None:
        settle(result.best_config)
    tuned = result.tuned_overrides()
    record = {
        "config": tuned, "score":
            None if not math.isfinite(result.best_score)
            else result.best_score,
        "default_score":
            None if not math.isfinite(result.default_score)
            else result.default_score,
        "delta_pct": result.delta_pct, "trials": result.n_trials,
        "backend": backend.name, "scope": scope,
        "space": space.space_signature(scope),
        "created": _time.time(),
        "trial_log": [tr.to_dict() for tr in result.trials],
    }
    db.put(key, record, persist=lead)     # one rank writes the file
    space.apply_config(tuned)
    _publish_active(tuned)
    out = AutotuneOutcome(mode, "search", key=key,
                          backend=backend.name, config=tuned,
                          trials=result.n_trials,
                          delta_pct=result.delta_pct,
                          score=result.best_score,
                          default_score=result.default_score)
    _OUTCOMES.append(out)
    _LOG.info("autotune[%s]: searched %d trials, tuned=%r "
              "(delta %s%%), kept %s", scope, result.n_trials,
              tuned, result.delta_pct, key[:12])
    return out


def _rank() -> int:
    from ..parallel import dist as _dist
    return _dist.rank()


def _snapshot_step(step, create_states: bool = True):
    """Capture the whole train state of ``step``'s trainer (its optimizer
    states created first, as the first step would, unless
    ``create_states`` is False: a ZeRO plan holds its own), and record the
    random generators the trials draw from and the buffers they write in
    place (a BatchNorm's running statistics). Returns the thunk that puts
    all of it back IN PLACE (captured graphs keep their pointers), with
    the step's count."""
    from ..checkpoint.state import apply_train_state, capture_train_state
    from ..gluon.fused_step import _copy_back
    from ..gluon.nn.basic_layers import recording_draws
    tr = step._trainer
    if create_states:
        for i, p in enumerate(tr._params):
            tr._updater._state_for(i, p)
    state = capture_train_state(trainer=tr)
    steps_done = step._steps_done
    scope = recording_draws(snapshot=True)
    rec = scope.__enter__()

    def restore():
        scope.__exit__(None, None, None)
        apply_train_state(state, trainer=tr)
        for _, g, g_state, saved in rec.values():
            if g is not None:
                g.set_state(g_state)
            if saved:
                _copy_back(saved)
        step._steps_done = steps_done
    return restore


def tune_step(step, args, kwargs=None, batch_size: Optional[int] = None,
              mode: Optional[str] = None, budget: Optional[int] = None,
              db: Optional[AutotuneCache] = None) -> AutotuneOutcome:
    """Tune one ``CompiledTrainStep`` for the shape ``args`` pin. The step
    calls it at its first call when ``compile_step(autotune=)`` /
    ``MXNET_AUTOTUNE`` arms it; callable directly for offline tuning.
    Applies (and after a search keeps) the winner as tuned overrides;
    returns the :class:`AutotuneOutcome`. Under a dp group every rank
    must call it with its own part of the same batch."""
    mode = autotune_mode(mode)
    if mode == "off":
        return AutotuneOutcome("off", "off")
    space.ensure_registered()
    kwargs = kwargs or {}
    if step._mode is None:
        step._mode = step._decide_mode()
    key = step_signature(step, args, kwargs)
    tunables = space.tunables("train")
    ranks = _Ranks(step.device) if _Ranks.active() else None

    def make_backend():
        return measure.select_step_backend(
            step, args, kwargs, batch_size=batch_size, tunables=tunables)

    return _tune("train", key, make_backend, mode, budget, db,
                 snapshot_state=lambda: _snapshot_step(step),
                 ranks=ranks)


def tune_predictor(pred, example, mode: Optional[str] = None,
                   budget: Optional[int] = None,
                   db: Optional[AutotuneCache] = None) -> AutotuneOutcome:
    """Tune one ``CompiledPredictor`` deployment's serving knobs from an
    example request. ``warmup(autotune=)`` calls it; the tuned overrides
    govern any :class:`~mxnet_tpu_torch.serving.DynamicBatcher` built
    after."""
    mode = autotune_mode(mode)
    if mode == "off":
        return AutotuneOutcome("off", "off")
    space.ensure_registered()
    key = predictor_signature(pred, example)
    tunables = space.tunables("serving")

    def make_backend():
        return measure.select_predictor_backend(pred, example,
                                                tunables=tunables)

    return _tune("serving", key, make_backend, mode, budget, db)
