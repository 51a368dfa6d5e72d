"""Budget-bounded coordinate descent with successive halving
(counterpart of ``mxnet_tpu/tuning/search.py``: given the same scores,
the same trials in the same order and the same winner).

The joint space is a handful of knobs with short grids, but a
measurement is expensive, so the search is

- **coordinate descent** over the tunables in name order: sweep one
  knob's grid with every other knob pinned at the incumbent, adopt a
  strictly better winner, move on; passes repeat until one improves
  nothing (or the budget runs out);
- **successive halving** inside a sweep when the backend is noisy
  (``deterministic=False``): every candidate at fidelity 1, the better
  half again at doubled fidelity, until one remains. A deterministic
  backend measures each candidate once;
- **budget-bounded**: ``MXNET_AUTOTUNE_BUDGET_TRIALS`` caps the
  measurements (the default config is trial 1); the search returns its
  best so far when the budget runs out and never raises.

Every measurement goes through :func:`measure.guarded_measure`, so a
candidate that faults (out of memory, a lost device, a refused launch)
is an infeasible score, not a dead search. Candidates the validity
predicate refuses are filtered before measuring and cost no budget.
"""
from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, List, Optional

from .measure import MeasureResult, guarded_measure

__all__ = ["Trial", "SearchResult", "coordinate_search"]

_LOG = logging.getLogger("mxnet_tpu_torch.tuning")

#: relative improvement a candidate must clear to replace the
#: incumbent — ties keep the default (stability beats churn)
MIN_REL_IMPROVEMENT = 1e-9


class Trial:
    """One measurement: the candidate config, its verdict, and which
    rung (fidelity) it ran at."""

    def __init__(self, number: int, config: Dict[str, Any],
                 result: MeasureResult, fidelity: int = 1):
        self.number = number
        self.config = dict(config)
        self.result = result
        self.fidelity = fidelity

    def to_dict(self) -> dict:
        return {"number": self.number, "config": self.config,
                "score": None if not math.isfinite(self.result.score)
                else self.result.score,
                "feasible": self.result.feasible,
                "reason": self.result.reason,
                "fidelity": self.fidelity}


class SearchResult:
    """The search's verdict: the winning config (FULL config — every
    swept tunable pinned, defaults included), its score, the
    default-config baseline score, and the full trial log."""

    def __init__(self, best_config: Dict[str, Any], best_score: float,
                 default_config: Dict[str, Any], default_score: float,
                 trials: List[Trial], budget: int, exhausted: bool):
        self.best_config = dict(best_config)
        self.best_score = best_score
        self.default_config = dict(default_config)
        self.default_score = default_score
        self.trials = list(trials)
        self.budget = budget
        self.exhausted = exhausted

    @property
    def n_trials(self) -> int:
        return len(self.trials)

    @property
    def improved(self) -> bool:
        return (math.isfinite(self.best_score)
                and math.isfinite(self.default_score)
                and self.best_score
                < self.default_score * (1 - MIN_REL_IMPROVEMENT))

    @property
    def delta_pct(self) -> Optional[float]:
        """Win over the defaults, percent of the default score (None
        when either side is unmeasurable)."""
        if not (math.isfinite(self.best_score)
                and math.isfinite(self.default_score)
                and self.default_score > 0):
            return None
        return round((self.default_score - self.best_score)
                     / self.default_score * 100.0, 3)

    def tuned_overrides(self) -> Dict[str, Any]:
        """The non-default slice of the winner — what actually gets
        applied/persisted (a knob tuned TO its default needs no
        override)."""
        return {k: v for k, v in self.best_config.items()
                if v != self.default_config.get(k)}

    def to_dict(self) -> dict:
        return {"best_config": self.best_config,
                "tuned": self.tuned_overrides(),
                "best_score": None if not math.isfinite(self.best_score)
                else self.best_score,
                "default_score":
                    None if not math.isfinite(self.default_score)
                    else self.default_score,
                "delta_pct": self.delta_pct,
                "n_trials": self.n_trials, "budget": self.budget,
                "exhausted": self.exhausted}


def coordinate_search(tunables, backend, budget: int,
                      max_passes: int = 3,
                      on_trial: Optional[Callable[[Trial], None]]
                      = None) -> SearchResult:
    """Coordinate-descent + successive-halving search over
    ``tunables`` scored by ``backend`` (``measure.guarded_measure``
    wraps every call). Returns the best feasible config found within
    ``budget`` total measurements."""
    tunables = tuple(tunables)
    budget = max(1, int(budget))
    trials: List[Trial] = []
    measured: Dict[tuple, MeasureResult] = {}
    exhausted = [False]

    def cfg_key(config):
        return tuple(sorted(config.items()))

    def run(config, fidelity=1) -> Optional[MeasureResult]:
        key = cfg_key(config)
        if backend.deterministic and key in measured:
            return measured[key]           # free: same score by design
        if len(trials) >= budget:
            exhausted[0] = True
            return None
        res = guarded_measure(backend, config, fidelity=fidelity)
        t = Trial(len(trials) + 1, config, res, fidelity)
        trials.append(t)
        measured[key] = res
        if on_trial is not None:
            try:
                on_trial(t)
            except Exception:    # pragma: no cover - telemetry guard
                pass
        return res

    default_config = {t.name: t.default for t in tunables}
    base = run(default_config)
    default_score = base.score if base is not None else float("inf")
    best_config = dict(default_config)
    best_score = default_score

    for _pass in range(max(1, int(max_passes))):
        improved = False
        for t in tunables:
            if exhausted[0]:
                break
            cands = []
            for v in t.grid:
                if v == best_config[t.name]:
                    continue
                cand = dict(best_config, **{t.name: v})
                if not t.valid(v, cand):
                    continue
                cands.append(cand)
            if not cands:
                continue
            # rung 0: everyone at fidelity 1
            fidelity = 1
            ring = []
            for cand in cands:
                res = run(cand, fidelity)
                if res is None:
                    break
                if res.feasible:
                    ring.append((cand, res.score))
            # successive halving (noisy backends only): survivors
            # re-measured at doubled fidelity until one remains
            while (not backend.deterministic and len(ring) > 1
                   and not exhausted[0]):
                ring.sort(key=lambda cs: cs[1])
                ring = ring[:max(1, len(ring) // 2)]
                if len(ring) == 1:
                    break
                fidelity *= 2
                nxt = []
                for cand, _old in ring:
                    res = run(cand, fidelity)
                    if res is None:
                        break
                    if res.feasible:
                        nxt.append((cand, res.score))
                if not nxt:
                    break
                ring = nxt
            if not ring:
                continue
            ring.sort(key=lambda cs: cs[1])
            cand, score = ring[0]
            if math.isfinite(score) and (
                    not math.isfinite(best_score)
                    or score < best_score * (1 - MIN_REL_IMPROVEMENT)):
                best_config, best_score = dict(cand), score
                improved = True
        if not improved or exhausted[0]:
            break

    _LOG.info("autotune search: %d/%d trials, default=%.3e best=%.3e "
              "tuned=%r", len(trials), budget, default_score,
              best_score,
              {k: v for k, v in best_config.items()
               if v != default_config.get(k)})
    return SearchResult(best_config, best_score, default_config,
                        default_score, trials, budget, exhausted[0])
