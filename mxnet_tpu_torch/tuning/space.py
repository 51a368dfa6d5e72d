"""The declarative tunable registry: the autotuner's search space
(counterpart of ``mxnet_tpu/tuning/space.py``, the same names, defaults,
grids, env vars and scopes).

Every hot-path knob the port ships as a constant is a :class:`Tunable`
registered next to the constant it makes sweepable (the constant stays,
as the *default*): the shared memory a kernel's launch plan may claim
(``ops/kernels``), the dispatch-window depth (``engine.inflight_steps``),
the ZeRO bucket floor and communication bucket size (``gluon/
fused_step``), the serving coalescing knobs (``serving/batcher``) and the
decode engine's (``serving/decode``). Each declaration names its
candidate grid, a validity predicate and the *seam* that consumes it:
the accessor hand-tuners and the autotuner share.

Value resolution at every consumer seam is

    tuned override  >  env var  >  registered default

so a hand-set env var still works alone, and an applied autotune config
(a trial's candidate or a cached winner) wins while it is active.
Overrides are process-global and cheap to read: consumers resolve at
each use, never at import.

Standard library only: the consumer modules register at import time
without importing the rest of the package.
"""
from __future__ import annotations

import hashlib
import os
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

__all__ = ["Tunable", "SearchSpace", "register", "get", "table",
           "tunables", "value", "set_override", "get_override",
           "clear_overrides", "overrides", "apply_config", "trial",
           "space_signature", "ensure_registered", "SPACE_VERSION"]

#: bumped when the semantics of the space change incompatibly; the
#: content hash in :func:`space_signature` catches grid and default
#: edits, and together they version the cache key (the JAX package's)
SPACE_VERSION = 1


class Tunable:
    """One declared knob with a candidate grid.

    - ``name``: dotted ``<group>.<knob>`` (``kernels``, ``engine``,
      ``zero``, ``serving``, ``decode``);
    - ``default``: the shipped constant (what ``MXNET_AUTOTUNE=off`` and
      every untuned run uses);
    - ``grid``: the candidate values the search sweeps;
    - ``env``: the env var hand-tuners use for the same knob (resolved
      between override and default), read through ``parse``;
    - ``valid(value, config)``: feasibility against the whole candidate
      config; an invalid candidate is filtered before measuring;
    - ``seam``: the consumer call site, in words;
    - ``scope``: ``'train'`` | ``'serving'`` | ``'both'``, the entry
      point that sweeps it;
    - ``affects_program``: whether a change needs the step's programs
      captured anew (the timed backend drops them between candidates
      that differ here)."""

    def __init__(self, name: str, default: Any, grid: Sequence[Any],
                 seam: str, env: Optional[str] = None,
                 parse: Callable[[str], Any] = None,
                 valid: Optional[Callable[[Any, dict], bool]] = None,
                 scope: str = "train", affects_program: bool = False,
                 doc: str = ""):
        if "." not in name:
            raise ValueError(
                f"tunable name {name!r} must be '<group>.<knob>'")
        if scope not in ("train", "serving", "both"):
            raise ValueError(f"tunable {name!r}: bad scope {scope!r}")
        self.name = name
        self.default = default
        self.grid = tuple(grid)
        self.seam = seam
        self.env = env
        self.parse = parse or (lambda s: s)
        self._valid = valid
        self.scope = scope
        self.affects_program = bool(affects_program)
        self.doc = doc

    def valid(self, value: Any, config: Optional[dict] = None) -> bool:
        """Whether ``value`` is feasible under ``config`` (the whole
        candidate config; defaults where it says nothing)."""
        if self._valid is None:
            return True
        try:
            return bool(self._valid(value, config or {}))
        except Exception:
            return False

    def resolve(self) -> Any:
        """The value at this knob's seam now: override > env > default."""
        found, v = get_override(self.name)
        if found:
            return v
        if self.env:
            raw = os.environ.get(self.env)
            if raw is not None and raw.strip() != "":
                try:
                    return self.parse(raw)
                except (TypeError, ValueError):
                    pass
        return self.default

    def __repr__(self):
        return (f"Tunable({self.name!r}, default={self.default!r}, "
                f"grid={self.grid!r}, scope={self.scope!r})")


_LOCK = threading.Lock()
_REGISTRY: "Dict[str, Tunable]" = {}
_OVERRIDES: "Dict[str, Any]" = {}


def register(t: Tunable) -> Tunable:
    """Register (or register again: reloads are idempotent) one tunable;
    returns it. A default outside the grid is put at its front: the
    search starts from it."""
    if t.default not in t.grid:
        t.grid = (t.default,) + t.grid
    with _LOCK:
        _REGISTRY[t.name] = t
    return t


def get(name: str) -> Optional[Tunable]:
    return _REGISTRY.get(name)


def tunables(scope: Optional[str] = None) -> Tuple[Tunable, ...]:
    """Registered tunables sorted by name; ``scope`` keeps those an entry
    point sweeps ('train' and 'serving' each include 'both')."""
    out = [t for _, t in sorted(_REGISTRY.items())]
    if scope is not None:
        out = [t for t in out if t.scope in (scope, "both")]
    return tuple(out)


def table() -> Tuple[dict, ...]:
    """One row per registered tunable (the docs and diagnose view)."""
    return tuple({"name": t.name, "default": t.default,
                  "grid": t.grid, "scope": t.scope,
                  "current": t.resolve(), "seam": t.seam}
                 for t in tunables())


# ---------------------------------------------------------------------------
# overrides: what the autotuner's trials and applied winners set
# ---------------------------------------------------------------------------

def value(name: str, default: Any = None) -> Any:
    """The resolved value of ``name`` (override > env > registered
    default); ``default`` when the tunable is unknown."""
    t = _REGISTRY.get(name)
    if t is None:
        found, v = get_override(name)
        return v if found else default
    return t.resolve()


def set_override(name: str, v: Any):
    with _LOCK:
        _OVERRIDES[name] = v


def get_override(name: str) -> Tuple[bool, Any]:
    """(found, value): an override set to None or 0 is still found."""
    with _LOCK:
        if name in _OVERRIDES:
            return True, _OVERRIDES[name]
    return False, None


def clear_overrides(names: Optional[Sequence[str]] = None):
    with _LOCK:
        if names is None:
            _OVERRIDES.clear()
        else:
            for n in names:
                _OVERRIDES.pop(n, None)


def overrides() -> Dict[str, Any]:
    with _LOCK:
        return dict(_OVERRIDES)


def apply_config(config: Dict[str, Any]):
    """Install a (partial) config as overrides: a cached or searched
    winner becomes the active config."""
    for k, v in config.items():
        set_override(k, v)


class trial:
    """Apply a candidate config for one measurement; on exit the prior
    overrides come back (keys the trial added are removed)."""

    def __init__(self, config: Dict[str, Any]):
        self._config = dict(config)
        self._saved: Optional[Dict[str, Any]] = None

    def __enter__(self):
        with _LOCK:
            self._saved = dict(_OVERRIDES)
            _OVERRIDES.update(self._config)
        return self

    def __exit__(self, *exc):
        with _LOCK:
            _OVERRIDES.clear()
            _OVERRIDES.update(self._saved or {})
        return False


class SearchSpace:
    """A scoped view of the registry: what one search sweeps
    (``SearchSpace('train')``, ``SearchSpace('serving')``)."""

    def __init__(self, scope: Optional[str] = None):
        self.scope = scope

    @property
    def tunables(self) -> Tuple[Tunable, ...]:
        return tunables(self.scope)

    def defaults(self) -> Dict[str, Any]:
        return {t.name: t.default for t in self.tunables}

    def current(self) -> Dict[str, Any]:
        """The value at every seam now (override > env > default)."""
        return {t.name: t.resolve() for t in self.tunables}

    def valid(self, config: Dict[str, Any]) -> bool:
        """Whether a whole candidate config meets every predicate."""
        return all(t.valid(config.get(t.name, t.default), config)
                   for t in self.tunables)

    def signature(self) -> str:
        return space_signature(self.scope)

    def __len__(self):
        return len(self.tunables)

    def __iter__(self):
        return iter(self.tunables)


# ---------------------------------------------------------------------------
# the space's identity (part of the cache key)
# ---------------------------------------------------------------------------

def space_signature(scope: Optional[str] = None) -> str:
    """Content hash of the registered space (name, default, grid and
    scope of every tunable, and :data:`SPACE_VERSION`): a grid or default
    edit invalidates the cached winners."""
    parts = [f"v{SPACE_VERSION}"]
    for t in tunables(scope):
        parts.append(f"{t.name}={t.default!r}:{t.grid!r}:{t.scope}")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]


def ensure_registered():
    """Import every consumer module that registers tunables, so
    :func:`table` and the search see the whole space whatever the
    process imported so far."""
    import importlib
    for mod in ("mxnet_tpu_torch.engine", "mxnet_tpu_torch.ops.kernels",
                "mxnet_tpu_torch.gluon.fused_step",
                "mxnet_tpu_torch.serving.batcher",
                "mxnet_tpu_torch.serving.decode"):
        importlib.import_module(mod)
