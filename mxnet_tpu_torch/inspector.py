"""Tensor inspector: value dumping, checkers, checksums, NaN guard (the
port's counterpart of ``mxnet_tpu/inspector.py``).

Reference analog: ``src/common/tensor_inspector.h`` (TensorInspector with
interactive_print/check_value/dump_to_file and the CheckerType zoo). The
ANY-violation test of a check is one reduction on the tensor's device
(coordinates come to the host only when a violation exists), and an
env-gated op-funnel guard (``MXNET_INSPECT_NAN=1``) validates every op
sent through ``ops.registry.invoke``, naming the producing op. Under
autograd the port's ops see real tensors, so the funnel alone covers
recorded ops too; inside a CUDA-graph capture the values are not yet
known (as inside a JAX trace) and the check is skipped.
"""
from __future__ import annotations

import io
import os
import zlib
from typing import Callable, List, Tuple, Union

import numpy as onp
import torch

from .base import MXNetError
from .ops import registry as _registry

__all__ = ["TensorInspector", "CheckerType", "install_nan_guard",
           "remove_nan_guard"]


class CheckerType:
    """Value checkers (reference tensor_inspector.h:71 CheckerType)."""
    NegativeChecker = "negative"
    PositiveChecker = "positive"
    ZeroChecker = "zero"
    NaNChecker = "nan"
    InfChecker = "inf"
    NegativeInfChecker = "neg_inf"
    PositiveInfChecker = "pos_inf"
    FiniteChecker = "finite"
    AbnormalChecker = "abnormal"   # nan or inf


_CHECKS = {
    CheckerType.NegativeChecker: lambda d: d < 0,
    CheckerType.PositiveChecker: lambda d: d > 0,
    CheckerType.ZeroChecker: lambda d: d == 0,
    CheckerType.NaNChecker: lambda d: torch.isnan(d),
    CheckerType.InfChecker: lambda d: torch.isinf(d),
    CheckerType.NegativeInfChecker: lambda d: torch.isneginf(d),
    CheckerType.PositiveInfChecker: lambda d: torch.isposinf(d),
    CheckerType.FiniteChecker: lambda d: ~torch.isfinite(d),
    CheckerType.AbnormalChecker: lambda d: ~torch.isfinite(d),
}


def _raw(t) -> torch.Tensor:
    return t.detach() if isinstance(t, torch.Tensor) \
        else torch.as_tensor(onp.asarray(t))


def _host(t: torch.Tensor) -> onp.ndarray:
    """A host numpy copy (bfloat16 widened to float32, which holds it
    exactly: numpy has no bfloat16)."""
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class TensorInspector:
    """Inspect one tensor (reference TensorInspector)."""

    def __init__(self, tensor, tag: str = ""):
        self._t = _raw(tensor)
        self._tag = tag

    # -- printing ----------------------------------------------------------
    def to_string(self) -> str:
        arr = _host(self._t)
        head = (f"Tensor{f' <{self._tag}>' if self._tag else ''} "
                f"shape={tuple(self._t.shape)} "
                f"dtype={str(self._t.dtype).replace('torch.', '')}")
        return head + "\n" + onp.array2string(arr, threshold=200)

    def interactive_print(self, tag: str = ""):
        """Non-interactive environments get the plain dump (the reference
        prompts on a terminal; under a driver we just print)."""
        if tag:
            self._tag = tag
        print(self.to_string())

    # -- value checking ----------------------------------------------------
    def check_value(self, checker: Union[str, Callable],
                    interactive: bool = False,
                    tag: str = "") -> List[Tuple[int, ...]]:
        """Return coordinates of violating values. The ANY-violation test is
        one reduction on the tensor's device; coordinates are computed on
        the host only when a violation exists."""
        fn = _CHECKS.get(checker, checker)
        if not callable(fn):
            raise MXNetError(f"unknown checker {checker!r}")
        mask = fn(self._t)
        if not bool(torch.any(mask)):
            return []
        coords = [tuple(int(i) for i in idx)
                  for idx in zip(*onp.nonzero(_host(mask)))]
        if interactive or tag:
            print(f"check_value <{tag or self._tag}>: "
                  f"{len(coords)} violations, first at {coords[0]}")
        return coords

    # -- checksums / dumping ----------------------------------------------
    def checksum(self) -> int:
        """CRC32 of the raw bytes (reference dump checksum usage)."""
        return zlib.crc32(onp.ascontiguousarray(_host(self._t)))

    def dump_to_file(self, tag: str, directory: str = ".") -> str:
        """Write .npy named <tag>_<n>.npy (reference dump_to_file naming
        with a per-tag visit counter). The write is crash-safe — staged
        to a temp file, fsynced, and os.replace'd via the same atomic
        helper ``nd.save`` and the telemetry dump writers use — so a
        kill mid-dump never leaves a torn .npy; the sequence number
        advances only on a durable write (a failed attempt retries
        under the same name)."""
        from .checkpoint.atomic import atomic_write_bytes
        count = _dump_counters.get(tag, 0) + 1
        path = os.path.join(directory, f"{tag}_{count}.npy")
        buf = io.BytesIO()
        onp.save(buf, _host(self._t))
        atomic_write_bytes(path, buf.getvalue(), fault="inspector.dump")
        _dump_counters[tag] = count
        return path


_dump_counters: dict = {}

# ---------------------------------------------------------------------------
# Invoke-funnel NaN guard
# ---------------------------------------------------------------------------

_guard_installed = False


def _numerics_monitor():
    """The telemetry numerics monitor (lazy: the guard must work even
    if telemetry failed to import) — eager non-finite hits feed the
    SAME anomaly channel as the compiled-step numerics watchdog, one
    ``nonfinite_eager`` event per episode."""
    try:
        from .telemetry import numerics
        return numerics.monitor()
    except Exception:            # pragma: no cover - defensive
        return None


def _check_concrete_outputs(name, outs):
    """The funnel's checker: raise (naming the op) on the first
    non-finite float output, and report/arm the telemetry episode.
    Skipped inside a CUDA-graph capture, where values are not known."""
    if torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing():
        return
    checked = False
    for i, o in enumerate(outs):
        if isinstance(o, torch.Tensor) and o.is_floating_point():
            checked = True
            if not bool(torch.isfinite(o.detach()).all()):
                mon = _numerics_monitor()
                if mon is not None:
                    mon.eager_nonfinite(name, i)
                raise MXNetError(
                    f"MXNET_INSPECT_NAN: op {name!r} produced a "
                    f"non-finite value in output {i}")
    if checked:
        mon = _numerics_monitor()
        if mon is not None:
            mon.eager_clean()       # a clean op re-arms the episode


def _nan_guard_wrapper(name, fn):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        _check_concrete_outputs(
            name, out if isinstance(out, (tuple, list)) else (out,))
        return out
    return wrapped


def install_nan_guard():
    """Check every funnelled op's outputs for NaN/Inf, raising with the
    op name (reference check_value NaNChecker wired through the op
    funnel; enabled at import when MXNET_INSPECT_NAN=1). Each violation
    also emits one ``nonfinite_eager`` anomaly per episode on the
    telemetry watchdog channel (a clean checked op re-arms). Idempotent:
    calling it twice never double-wraps. Synchronizes per op — a
    debugging tool, not a production mode."""
    global _guard_installed
    if _guard_installed:
        return
    # defensive de-dup before add: the funnel carries at most one guard
    _registry.remove_invoke_wrapper(_nan_guard_wrapper)
    _registry.add_invoke_wrapper(_nan_guard_wrapper)
    _guard_installed = True


def remove_nan_guard():
    """Uninstall the guard (idempotent); other funnel wrappers stay."""
    global _guard_installed
    if not _guard_installed:
        return
    try:
        _registry.remove_invoke_wrapper(_nan_guard_wrapper)
    finally:
        _guard_installed = False


if os.environ.get("MXNET_INSPECT_NAN", "0") == "1":
    install_nan_guard()
