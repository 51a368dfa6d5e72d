"""Training-numerics observability: in-program grad/param health,
divergence watchdog, NaN-origin forensics (the port's counterpart of
``mxnet_tpu/telemetry/numerics.py``).

1. **In-program health statistics.** ``Trainer.compile_step(numerics=)``
   (env ``MXNET_NUMERICS=off|global|per_layer``) adds reductions to the
   captured step, inside its CUDA graph: the global grad norm (of the
   gradients the update reads, rescaled as the update rescales them),
   the param norm (the weights the update reads), the update norm (the
   new weights less a copy of the old ones taken in the graph before
   the in-place update: one copy of the weights, the price of the
   in-place ``opt_update``), non-finite gradient counts by dtype and
   (``per_layer``) a per-parameter grad-norm vector. They land in one
   static output buffer that each replay writes and ``run()`` copies out
   with the loss. Under the ZeRO sharded update each rank reduces its
   own shards and one all-reduce composes them, so every rank reports
   the global statistic.

2. **Sync-free retirement.** The aux tensor rides the dispatch window
   beside the loss (:class:`StepNumerics`); the :class:`NumericsMonitor`
   reads it at the window's retire, the one designed wait — the step has
   completed by then, so the small copy adds no stall.

3. **Divergence watchdog.** Episode-semantics anomalies through the
   watchdog channel, each exactly once per episode: ``grad_spike``,
   ``nonfinite_grad``, ``update_ratio``, ``master_drift``. The eager NaN
   guard (``inspector.install_nan_guard``) reports ``nonfinite_eager``
   through the same channel.

4. **NaN-origin forensics.** When ``nonfinite_grad`` fires, one eager
   re-execution of the step's loss and backward on the step's own batch
   runs outside the hot loop under :func:`localize_nonfinite` (a check
   of every op's outputs through the op funnel plus
   ``torch.autograd.detect_anomaly`` for the backward: the counterpart
   of ``jax.debug_nans``), naming the first op that produced a
   non-finite value, and an atomic ranked post-mortem JSON (schema v1,
   the JAX package's) is written to ``MXNET_NUMERICS_DUMP_DIR``.

Cost: the statistics only READ what the step computes, so losses and
weights stay bit-equal with numerics off (the update kernel is
unchanged); ``global`` adds a few reductions a parameter and the
weights' copy to the graph, ``per_layer`` the same plus a vector.
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as onp
import torch

from . import names
from .registry import default as _default_registry
from .watchdog import watchdog as _watchdog

__all__ = ["mode", "spike_factor", "master_drift_tol", "dump_dir",
           "DUMP_SCHEMA_VERSION", "TOP_K_LAYERS", "sumsq",
           "nonfinite_count", "StepNumerics", "NumericsMonitor",
           "monitor", "localize_nonfinite", "write_dump"]

_LOG = logging.getLogger("mxnet_tpu_torch.telemetry")

#: schema of the numerics post-mortem dump (the JAX package's)
DUMP_SCHEMA_VERSION = 1

#: per-layer gauge series published per retire (largest norms first);
#: bounded well under names.MAX_LABEL_VALUES
TOP_K_LAYERS = 16

#: samples before the spike/ratio detectors arm (warmup transients)
_MIN_SAMPLES = 5

#: EWMA smoothing for the grad-norm / update-ratio references
_ALPHA = 0.2

_EPS = 1e-12

#: update/weight-ratio histogram buckets (log-spaced; healthy training
#: sits around 1e-3..1e-2)
RATIO_BUCKETS = (1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 3e-3, 1e-2, 3e-2,
                 1e-1, 0.3, 1.0)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def mode(requested: Optional[str] = None) -> Optional[str]:
    """Normalize the ``numerics=`` kwarg / ``MXNET_NUMERICS`` env value
    to one of ``None`` (off) | ``'global'`` | ``'per_layer'``."""
    v = requested if requested is not None \
        else os.environ.get("MXNET_NUMERICS")
    if v is None or v is False:
        return None
    if v is True:
        return "global"
    v = str(v).strip().lower().replace("-", "_")
    if v in ("", "0", "off", "false", "no", "none"):
        return None
    if v in ("1", "on", "global", "true"):
        return "global"
    if v in ("per_layer", "layer", "layers", "2"):
        return "per_layer"
    _LOG.warning("unknown MXNET_NUMERICS mode %r; treating as 'global'",
                 v)
    return "global"


def spike_factor(default: float = 10.0) -> float:
    """``MXNET_GRADNORM_SPIKE_FACTOR``: a retired grad norm above
    factor x its EWMA raises a ``grad_spike`` anomaly (the same
    threshold gates the update-ratio band)."""
    try:
        v = float(os.environ.get("MXNET_GRADNORM_SPIKE_FACTOR", default))
    except (TypeError, ValueError):
        return default
    return v if v > 1.0 else default


def master_drift_tol(default: float = 1e-2) -> float:
    """``MXNET_MASTER_DRIFT_TOL``: max tolerated relative drift between
    an fp32 master shard and its low-precision weight cast before a
    ``master_drift`` anomaly fires."""
    try:
        v = float(os.environ.get("MXNET_MASTER_DRIFT_TOL", default))
    except (TypeError, ValueError):
        return default
    return v if v > 0 else default


def dump_dir() -> Optional[str]:
    """``MXNET_NUMERICS_DUMP_DIR`` (None = no post-mortem files; the
    ``nonfinite_grad`` anomaly still fires)."""
    return os.environ.get("MXNET_NUMERICS_DUMP_DIR") or None


# ---------------------------------------------------------------------------
# the reductions (run inside the captured step)
# ---------------------------------------------------------------------------

def sumsq(tensors) -> torch.Tensor:
    """Per-tensor sums of squares in float32, as a (len,) tensor: each
    tensor's 2-norm in float32 (one reduction a tensor), squared. The
    JAX ``sumsq`` is ``sum(square(x.astype(f32)))``; the two agree to
    float32 rounding."""
    norms = [torch.linalg.vector_norm(t, 2, dtype=torch.float32)
             for t in tensors]
    return torch.stack(norms).square() if norms else torch.zeros(0)


def nonfinite_count(tensors) -> torch.Tensor:
    """Count of non-finite elements over ``tensors`` (int32, 0-d). Zero
    padding is finite and never inflates the count."""
    counts = [torch.count_nonzero(~torch.isfinite(t)) for t in tensors]
    return torch.stack(counts).sum().to(torch.int32)


# ---------------------------------------------------------------------------
# the per-step aux record riding the dispatch window
# ---------------------------------------------------------------------------

class StepNumerics:
    """One step's numerics aux, pushed into the dispatch window alongside
    the loss and read back at the retire.

    ``raw`` holds the step's statistics: ``grad_sq``, ``param_sq``,
    ``upd_sq``, ``nonfinite`` ({dtype: count}) and,
    per layer, ``layer_grad_sq`` — views of the float64 vector the
    captured step wrote, on the device until the retire reads them;
    ``forensic`` is the step's one-shot NaN-origin re-execution closure
    (the step's batch, the current parameters); ``context`` is the
    host-side lr / loss-scale / step snapshot taken at dispatch.
    """

    __slots__ = ("mode", "raw", "param_names", "context", "forensic",
                 "_vals")

    def __init__(self, mode: str, raw: Dict[str, Any],
                 param_names: List[str], context: dict,
                 forensic: Optional[Callable] = None):
        self.mode = mode
        self.raw = raw
        self.param_names = list(param_names)
        self.context = dict(context or {})
        self.forensic = forensic
        self._vals: Optional[dict] = None

    def host_values(self) -> dict:
        """Host view of the aux: derived norms/ratios/counts. One small
        device->host copy — call at (or after) the retire, when the step
        has completed."""
        if self._vals is not None:
            return self._vals
        raw = {k: _host(v) for k, v in self.raw.items()}

        def f(key):
            return float(onp.asarray(raw[key], dtype="float64"))

        gsq, psq, usq = f("grad_sq"), f("param_sq"), f("upd_sq")
        pnorm = math.sqrt(max(psq, 0.0)) if math.isfinite(psq) else psq
        vals = {
            "grad_norm": _safe_sqrt(gsq),
            "param_norm": pnorm,
            "update_norm": _safe_sqrt(usq),
            "update_ratio": _safe_sqrt(usq) / (pnorm + _EPS)
            if math.isfinite(pnorm) else float("nan"),
            "nonfinite": {dt: int(onp.asarray(c))
                          for dt, c in raw["nonfinite"].items()},
        }
        vals["nonfinite_total"] = sum(vals["nonfinite"].values())
        if "master_drift" in raw:
            vals["master_drift"] = f("master_drift")
        if "layer_grad_sq" in raw:
            lsq = onp.asarray(raw["layer_grad_sq"], dtype="float64")
            vals["layer_grad_norm"] = {
                name: _safe_sqrt(float(v))
                for name, v in zip(self.param_names, lsq)}
        self._vals = vals
        return vals


def _host(v):
    """A raw aux entry on the host: tensors as float64 numpy (counts
    stay exact: a float64 holds every int32), dicts entry by entry."""
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float64).numpy()
    return v


def _safe_sqrt(v: float) -> float:
    return math.sqrt(v) if math.isfinite(v) and v >= 0 else float(v)


# ---------------------------------------------------------------------------
# NaN-origin localization
# ---------------------------------------------------------------------------

class _NonFinite(FloatingPointError):
    pass


def _funnel_check(name, fn):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, o in enumerate(outs):
            if isinstance(o, torch.Tensor) and o.is_floating_point() \
                    and not bool(torch.isfinite(o.detach()).all()):
                raise _NonFinite(
                    f"invalid value (nan/inf) encountered in {name} "
                    f"(output {i})")
        return out
    return wrapped


def localize_nonfinite(thunk: Callable[[], Any]) -> Optional[str]:
    """Run ``thunk`` (the failing step's loss and backward) with every
    op of the funnel (``ops.registry.invoke``) checked for non-finite
    outputs and ``torch.autograd.detect_anomaly`` armed for the backward:
    the FIRST op producing a non-finite value raises, naming it — the
    NaN's origin. Returns the description, ``None`` when the
    re-execution stayed finite (the failure did not reproduce), or an
    error note when the re-execution itself failed. A debugging path
    that synchronizes at every op: run it OUTSIDE the hot loop."""
    from ..ops import registry as _registry
    _registry.add_invoke_wrapper(_funnel_check)
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            thunk()
        return None
    except FloatingPointError as e:
        return str(e).split("\n", 1)[0]
    except RuntimeError as e:
        msg = str(e)
        if "nan" in msg.lower():
            # detect_anomaly: "Function 'XBackward0' returned nan values
            # in its 0th output."
            return msg.split("\n", 1)[0]
        return f"re-execution failed: {type(e).__name__}: {e}"
    except Exception as e:       # pragma: no cover - defensive
        return f"re-execution failed: {type(e).__name__}: {e}"
    finally:
        _registry.remove_invoke_wrapper(_funnel_check)


# ---------------------------------------------------------------------------
# post-mortem dump
# ---------------------------------------------------------------------------

def _json_safe(v):
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    if isinstance(v, (onp.floating, onp.integer)):
        return _json_safe(v.item())
    return str(v)


def write_dump(payload: dict) -> Optional[str]:
    """Write one numerics post-mortem JSON atomically (the tmp + fsync +
    ``os.replace`` helper checkpoints use) to ``MXNET_NUMERICS_DUMP_DIR``;
    returns the path or None when the dir is unset."""
    d = dump_dir()
    if not d:
        return None
    from ..checkpoint.atomic import atomic_write_bytes
    os.makedirs(d, exist_ok=True)
    path = os.path.join(
        d, f"mx_numerics_{int(time.time())}_{os.getpid()}.json")
    data = json.dumps(payload, indent=1, default=_json_safe).encode()
    atomic_write_bytes(path, data, fault="numerics.dump")
    return path


def _divergence_hints(vals: dict, context: dict) -> List[str]:
    """Actionable knobs, ranked by what the statistics implicate."""
    hints = []
    nf = vals.get("nonfinite", {})
    low_prec = [dt for dt, n in nf.items()
                if n and dt in ("bfloat16", "float16")]
    if low_prec:
        hints.append(
            f"non-finite gradients in {'/'.join(low_prec)} params: "
            "enable multi_precision fp32 masters and/or dynamic loss "
            "scaling (mx.amp)")
    lr = context.get("learning_rate")
    ratio = vals.get("update_ratio")
    if ratio is not None and math.isfinite(ratio) and ratio > 0.1:
        hints.append(
            f"update/weight ratio {ratio:.3g} is large: the step is "
            "rewriting the weights — lower the learning rate"
            + (f" (currently {lr})" if lr is not None else "")
            + " or add warmup")
    if context.get("clip_gradient") in (None, 0.0):
        hints.append(
            "no gradient clipping configured: set clip_gradient on the "
            "optimizer to bound spikes while you bisect the cause")
    if context.get("loss_scale") not in (None, 1.0):
        hints.append(
            f"AMP loss scale is {context.get('loss_scale')}: an "
            "overflowing scale poisons gradients before the unscale — "
            "check the scaler's backoff window")
    hints.append(
        "re-run the failing batch under MXNET_INSPECT_NAN=1 (eager "
        "per-op NaN guard) to confirm the offending op interactively")
    return hints


# ---------------------------------------------------------------------------
# the monitor: gauges, episodes, forensics trigger
# ---------------------------------------------------------------------------

class NumericsMonitor:
    """Process-global numerics observer, fed from the dispatch window's
    retire (``engine.DispatchWindow``) — or directly via
    ``CompiledTrainStep.numerics_values()`` for windowless callers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ewma_g: Optional[float] = None
        self._n_g = 0
        self._ewma_r: Optional[float] = None
        self._n_r = 0
        self._active: Dict[str, bool] = {}
        self._last: Optional[dict] = None
        reg = _default_registry()
        self._g_gnorm = reg.gauge(names.NUMERICS_GRAD_NORM)
        self._g_pnorm = reg.gauge(names.NUMERICS_PARAM_NORM)
        self._g_ewma = reg.gauge(names.NUMERICS_GRAD_NORM_EWMA)
        self._g_drift = reg.gauge(names.NUMERICS_MASTER_DRIFT)
        self._g_layer = reg.gauge(names.NUMERICS_LAYER_GRAD_NORM,
                                  label_key="param")
        self._h_ratio = reg.histogram(names.NUMERICS_UPDATE_RATIO,
                                      buckets=RATIO_BUCKETS)
        self._c_nonfinite = reg.counter(names.NUMERICS_NONFINITE,
                                        label_key="dtype")
        self._c_dumps = reg.counter(names.NUMERICS_DUMPS)

    # ---------------- the retire hook ----------------
    def observe_retire(self, step, rec: StepNumerics) -> Optional[dict]:
        """Consume one step's aux record at its window retire: publish
        the ``mx_numerics_*`` series, run the divergence detectors
        (exactly one anomaly per episode), and on a fresh non-finite
        episode run the NaN-origin forensics + dump. Never raises —
        observability must not kill a run."""
        try:
            return self._observe(step, rec)
        except Exception:        # pragma: no cover - defensive
            _LOG.warning("numerics retire observation failed",
                         exc_info=True)
            return None

    def _observe(self, step, rec: StepNumerics) -> dict:
        from ..engine import allow_sync
        # the step completed at the retire; this read is the designed
        # device->host copy numerics adds
        with allow_sync():
            vals = rec.host_values()
        gn, pn = vals["grad_norm"], vals["param_norm"]
        ratio = vals["update_ratio"]
        nf_total = vals["nonfinite_total"]
        self._g_gnorm.set(gn)
        self._g_pnorm.set(pn)
        for dt, n in vals["nonfinite"].items():
            if n:
                self._c_nonfinite.inc(n, label=dt)
        if math.isfinite(ratio):
            self._h_ratio.observe(ratio)
        if "master_drift" in vals:
            self._g_drift.set(vals["master_drift"])
        layers = vals.get("layer_grad_norm")
        if layers:
            top = sorted(layers.items(),
                         key=lambda kv: -_finite_or_inf(kv[1]))
            for name, v in top[:TOP_K_LAYERS]:
                self._g_layer.set(v, label=name)

        wd = _watchdog()
        # non-finite gradients: one anomaly + one forensic dump per
        # episode; the anomaly message names the offending op and dump
        if self._transition("nonfinite_grad", nf_total > 0):
            path, op = self._run_forensics(step, rec, vals)
            counts = ", ".join(f"{dt}:{n}" for dt, n
                               in sorted(vals["nonfinite"].items()) if n)
            msg = (f"non-finite gradient first observed at step {step} "
                   f"({counts or nf_total} non-finite elements)")
            if op:
                msg += f"; origin: {op}"
            msg += (f"; post-mortem dump: {path}" if path else
                    "; set MXNET_NUMERICS_DUMP_DIR for a ranked "
                    "post-mortem dump")
            wd.report("nonfinite_grad", step, message=msg,
                      value=nf_total)

        # grad-norm spike: EWMA-relative, spiking samples not folded in
        factor = spike_factor()
        if math.isfinite(gn):
            with self._lock:
                ewma, n = self._ewma_g, self._n_g
            spike = (ewma is not None and n >= _MIN_SAMPLES
                     and gn > factor * ewma)
            if self._transition("grad_spike", spike):
                wd.report(
                    "grad_spike", step, value=gn,
                    message=f"grad norm {gn:.4g} at step {step} exceeds "
                            f"{factor:g}x the {ewma:.4g} EWMA")
            if not spike:
                with self._lock:
                    self._ewma_g = gn if self._ewma_g is None else \
                        (1 - _ALPHA) * self._ewma_g + _ALPHA * gn
                    self._n_g += 1
                    ewma = self._ewma_g
                self._g_ewma.set(ewma)
        # update/weight ratio out-of-band vs its own EWMA
        if math.isfinite(ratio):
            with self._lock:
                ewma_r, n_r = self._ewma_r, self._n_r
            oob = (ewma_r is not None and n_r >= _MIN_SAMPLES
                   and ratio > factor * max(ewma_r, _EPS))
            if self._transition("update_ratio", oob):
                wd.report(
                    "update_ratio", step, value=ratio,
                    message=f"update/weight ratio {ratio:.4g} at step "
                            f"{step} is out of band (> {factor:g}x the "
                            f"{ewma_r:.4g} EWMA)")
            if not oob:
                with self._lock:
                    self._ewma_r = ratio if self._ewma_r is None else \
                        (1 - _ALPHA) * self._ewma_r + _ALPHA * ratio
                    self._n_r += 1
        # bf16 master-vs-weight drift (ZeRO multi-precision units)
        if "master_drift" in vals:
            tol = master_drift_tol()
            drift = vals["master_drift"]
            bad = not math.isfinite(drift) or drift > tol
            if self._transition("master_drift", bad):
                wd.report(
                    "master_drift", step, value=drift,
                    message=f"fp32 master vs low-precision weight "
                            f"drift {drift:.4g} at step {step} exceeds "
                            f"the {tol:g} tolerance")
        out = dict(vals)
        out["step"] = step
        with self._lock:
            self._last = out
        return vals

    # ---------------- eager NaN-guard channel ----------------
    def eager_nonfinite(self, op_name: str, output_index: int) -> bool:
        """One ``nonfinite_eager`` anomaly per episode, fed by the
        inspector's op-funnel NaN guard; a clean checked op
        (:meth:`eager_clean`) re-arms."""
        if self._transition("nonfinite_eager", True):
            _watchdog().report(
                "nonfinite_eager", None,
                message=f"MXNET_INSPECT_NAN: op {op_name!r} produced a "
                        f"non-finite value in output {output_index}")
            return True
        return False

    def eager_clean(self):
        self._transition("nonfinite_eager", False)

    # ---------------- episodes / state ----------------
    def _transition(self, kind: str, active: bool) -> bool:
        """True exactly once per inactive->active transition; recovery
        re-arms."""
        with self._lock:
            fire = bool(active) and not self._active.get(kind)
            self._active[kind] = bool(active)
        return fire

    def last(self) -> Optional[dict]:
        """The most recently retired step's host values (plus its step
        number)."""
        with self._lock:
            return dict(self._last) if self._last is not None else None

    def reset(self):
        with self._lock:
            self._ewma_g = None
            self._n_g = 0
            self._ewma_r = None
            self._n_r = 0
            self._active.clear()
            self._last = None

    # ---------------- forensics ----------------
    def _run_forensics(self, step, rec: StepNumerics, vals: dict):
        """One-shot NaN-origin forensics for a fresh non-finite episode:
        re-execute the step's batch (outside the hot loop, the device
        synchronized per op), write the atomic ranked dump. Returns
        (path, op)."""
        path = op = None
        try:
            from ..engine import allow_sync
            info = None
            if rec.forensic is not None:
                with allow_sync():
                    info = rec.forensic(step)
            info = info or {}
            op = info.get("offending_op")
            layers = info.get("layers")
            if not layers and vals.get("layer_grad_norm"):
                layers = [{"param": k, "grad_norm": v}
                          for k, v in vals["layer_grad_norm"].items()]
            payload = {
                "schema_version": DUMP_SCHEMA_VERSION,
                "time_unix": time.time(),
                "kind": "nonfinite_grad",
                "step": step,
                "offending_op": op,
                "grad_norm": vals["grad_norm"],
                "param_norm": vals["param_norm"],
                "update_ratio": vals["update_ratio"],
                "nonfinite": vals["nonfinite"],
                "loss": info.get("loss"),
                "layers": layers or [],
                "context": rec.context,
                "hints": _divergence_hints(vals, rec.context),
            }
            if "reexec_error" in info:
                payload["reexec_error"] = info["reexec_error"]
            path = write_dump(payload)
            if path:
                self._c_dumps.inc()
        except Exception:        # pragma: no cover - defensive
            _LOG.warning("numerics forensics failed", exc_info=True)
        return path, op


def _finite_or_inf(v: float) -> float:
    """Sort key: non-finite norms rank first (they ARE the story)."""
    return v if math.isfinite(v) else float("inf")


_monitor = NumericsMonitor()


def monitor() -> NumericsMonitor:
    """The process-global numerics monitor
    (``telemetry.numerics.monitor()``)."""
    return _monitor
