"""Device-loss detection, failure classification, preemption notices
(counterpart of ``mxnet_tpu/elastic/detect.py``).

The seams the elastic supervisor recovers from:

1. **Errors at the dispatch seams.** A lost card surfaces as a
   ``RuntimeError`` (or ``torch.AcceleratorError``) whose message holds
   one of the CUDA runtime's device-lost texts; a lost rank surfaces on
   the others as NCCL's or gloo's text for a peer that went away.
   :func:`maybe_record_device_lost` classifies an escaping exception at
   the step's dispatch, the dispatch window's retire and the
   prefetcher's staging, and records exactly ONE ``device_lost`` anomaly
   per failure however many seams it crosses (the exception is
   marked).
2. **Preemption notices.** A spot host gets a SIGTERM with a grace
   window before the hard kill. :class:`PreemptionNotice` turns the
   signal into a flag the supervisor polls at each step boundary, so the
   run drains its window and commits a final checkpoint inside
   ``MXNET_PREEMPTION_GRACE_SEC``.

A ``device_lost`` anomaly goes out on the telemetry watchdog's channel
(``telemetry.watchdog().report``: its ring, ``mx_anomalies_total{kind=
device_lost}``, one JSON log line and the subscribers, the elastic
supervisor among them), and is also kept on the exception
(``exc._mx_anomaly``) and in this module's list (:func:`anomalies`).
The supervisor escalates the watchdog's ``stall`` episodes into
recoveries (``supervisor.py``: ``StallEscalation``).
"""
from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
import time
from typing import List, Optional

__all__ = ["is_device_lost", "is_rank_lost", "classify",
           "maybe_record_device_lost", "device_lost_guard",
           "PreemptionNotice", "notice", "clear_scoped_notices",
           "elastic_enabled", "armed", "max_retries",
           "preemption_grace_sec", "anomalies", "reset_anomalies"]

_LOG = logging.getLogger("mxnet_tpu_torch.elastic")


# ---------------------------------------------------------------- env gates
def _falsy(v: str) -> bool:
    return v.strip().lower() in ("", "0", "off", "false", "no")


def elastic_enabled(default: bool = True) -> bool:
    """``MXNET_ELASTIC``: whether an ``ElasticSupervisor`` recovers
    (default yes once one is built); ``0``/``off`` makes it a plain
    runner that propagates every failure."""
    v = os.environ.get("MXNET_ELASTIC")
    return default if v is None else not _falsy(v)


def armed() -> bool:
    """Whether ``MXNET_ELASTIC`` is set truthy explicitly."""
    v = os.environ.get("MXNET_ELASTIC")
    return v is not None and not _falsy(v)


def max_retries(default: int = 3) -> int:
    """``MXNET_ELASTIC_MAX_RETRIES``: consecutive recoveries without
    forward progress before the supervisor gives up (one step past the
    restored one resets the budget)."""
    try:
        v = int(os.environ.get("MXNET_ELASTIC_MAX_RETRIES", default))
    except (TypeError, ValueError):
        return default
    return max(0, v)


def preemption_grace_sec(default: float = 30.0) -> float:
    """``MXNET_PREEMPTION_GRACE_SEC``: the budget between the preemption
    notice and the hard kill, inside which the final checkpoint must
    commit (exceeding it is logged; the checkpoint is attempted
    regardless)."""
    try:
        v = float(os.environ.get("MXNET_PREEMPTION_GRACE_SEC", default))
    except (TypeError, ValueError):
        return default
    return v if v > 0 else default


# ---------------------------------------------------------------- classify
#: lowercase substrings of the texts that mean the DEVICE failed, not the
#: program. The CUDA runtime's: cudaErrorDevicesUnavailable ("CUDA-capable
#: device(s) is/are busy or unavailable"), cudaErrorNoDevice ("no
#: CUDA-capable device is detected"), cudaErrorECCUncorrectable
#: ("uncorrectable ECC error encountered"), cudaErrorNvlinkUncorrectable
#: ("uncorrectable NVLink error detected during the execution"),
#: cudaErrorHardwareStackError ("hardware stack error"); the kernel
#: module's Xid 79 ("GPU has fallen off the bus") and NVML's
#: NVML_ERROR_GPU_IS_LOST ("GPU is lost"); and the injected revocation's
#: "device lost"
_DEVICE_LOST_MARKERS = (
    "device lost",
    "device_lost",
    "busy or unavailable",
    "no cuda-capable device is detected",
    "uncorrectable ecc error",
    "uncorrectable nvlink error",
    "hardware stack error",
    "fallen off the bus",
    "gpu is lost",
    "removed from the system",
)
#: ... and those that mean another RANK of the group went away (its card
#: or its process): NCCL's ncclRemoteError ("remote process exited or
#: there was a network error"), a communicator aborted after a peer's
#: failure, and gloo's TCP transport ("Connection closed by peer",
#: "Connection reset by peer")
_RANK_LOST_MARKERS = (
    "remote process exited or there was a network error",
    "nccl communicator was aborted",
    "connection closed by peer",
    "connection reset by peer",
)
#: the texts of an allocation that failed: torch.cuda.OutOfMemoryError's
#: ("CUDA out of memory") and the runtime's cudaErrorMemoryAllocation
_OOM_MARKERS = ("cuda out of memory", "out of memory")
#: a cause named in a child process's traceback by the supervisor's rank
_CAUSE_TAG = "elastic cause: "


def _chain(exc):
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def _text(e) -> str:
    return f"{type(e).__name__}: {e}".lower()


def is_rank_lost(exc: BaseException) -> bool:
    """Whether ``exc`` (or its cause chain) says another rank of the
    process group went away."""
    return any(m in _text(e) for e in _chain(exc) for m in _RANK_LOST_MARKERS)


def is_device_lost(exc: BaseException) -> bool:
    """Whether ``exc`` (or anything in its cause chain) is a device loss:
    a failure of the HARDWARE world, recoverable by re-forming at the
    surviving world, unlike a failure of the program, which would fail
    again. A child process's exception, carried as its traceback's text,
    is recognised by the same texts and by ``DeviceRevokedError``'s
    name."""
    for e in _chain(exc):
        if type(e).__name__ == "DeviceRevokedError":
            return True
        t = _text(e)
        if "devicerevokederror" in t or any(
                m in t for m in _DEVICE_LOST_MARKERS + _RANK_LOST_MARKERS):
            return True
    return False


def _is_oom(exc) -> bool:
    import torch
    oom = getattr(torch.cuda, "OutOfMemoryError", ())
    return any((oom and isinstance(e, oom))
               or any(m in _text(e) for m in _OOM_MARKERS)
               for e in _chain(exc))


def classify(exc: BaseException) -> str:
    """The failure taxonomy of the recovery decision:

    - ``device_lost``: the world shrank; re-form and restore;
    - ``stall``: escalated watchdog stall episodes (the supervisor's
      ``StallEscalation`` marker);
    - ``oom``: ``torch.cuda.OutOfMemoryError``; NOT recovered (a smaller
      world only raises each device's load);
    - ``transient``: an ``OSError`` (an IO blip, an injected fault),
      worth a bounded retry from the last checkpoint;
    - ``fatal``: anything else (a shape error fails again forever).

    A supervisor's rank names its failure's cause in its traceback
    (``elastic cause: <cause>``); that tag decides for the text of a
    child's exception."""
    for e in _chain(exc):
        t = str(e)
        i = t.rfind(_CAUSE_TAG)
        if i >= 0:
            return t[i + len(_CAUSE_TAG):].split()[0].strip(".,;:)]")
    if is_device_lost(exc):
        return "device_lost"
    for e in _chain(exc):
        if type(e).__name__ == "StallEscalation":
            return "stall"
    if _is_oom(exc):
        return "oom"
    for e in _chain(exc):
        if isinstance(e, OSError):
            return "transient"
    return "fatal"


# ---------------------------------------------------------------- anomalies
_anomalies: List[dict] = []
_anom_lock = threading.Lock()


def anomalies(kind: Optional[str] = None) -> List[dict]:
    """The anomalies recorded in this process (``device_lost`` ones), in
    order: ``{kind, step, seam, message, time_unix}``."""
    with _anom_lock:
        evs = list(_anomalies)
    return evs if kind is None else [e for e in evs if e["kind"] == kind]


def reset_anomalies():
    with _anom_lock:
        _anomalies.clear()


def _lost_device_count() -> int:
    try:
        from ..parallel.dist import available_devices, visible_device_ids
        return max(0, len(visible_device_ids()) - len(available_devices()))
    except Exception:            # pragma: no cover - defensive
        return 0


def maybe_record_device_lost(exc: BaseException, seam: str,
                             step=None) -> bool:
    """If ``exc`` is a device loss no inner seam has recorded, emit
    exactly one ``device_lost`` anomaly on the watchdog channel (ring,
    ``mx_anomalies_total{kind=device_lost}``, one JSON log line and the
    subscribers), also kept on the exception and in :func:`anomalies`.
    Returns True when it recorded. Never raises: detection must not mask
    the original error."""
    try:
        if not is_device_lost(exc):
            return False
        for e in _chain(exc):
            if getattr(e, "_mx_device_lost_handled", False):
                return False
        lost = _lost_device_count()
        evt = {"kind": "device_lost", "step": step, "seam": seam,
               "value": lost or None, "time_unix": time.time(),
               "message": f"device loss at {seam}"
                          + (f" (step {step})" if step is not None else "")
                          + (f"; {lost} device(s) missing from the world"
                             if lost else "")
                          + f": {type(exc).__name__}: {exc}"}
        try:
            exc._mx_device_lost_handled = True
            exc._mx_anomaly = evt
        except Exception:        # pragma: no cover - frozen exc types
            pass
        with _anom_lock:
            _anomalies.append(evt)
        from .. import telemetry
        telemetry.watchdog().report("device_lost", step,
                                    message=evt["message"],
                                    value=evt["value"])
        return True
    except Exception:            # pragma: no cover - defensive
        _LOG.warning("device-lost detection failed", exc_info=True)
        return False


@contextlib.contextmanager
def device_lost_guard(seam: str, step=None):
    """Wrap a dispatch seam: an escaping device loss gets its anomaly
    recorded (once, however nested the seams) and propagates
    unchanged."""
    try:
        yield
    except BaseException as e:
        maybe_record_device_lost(e, seam, step=step)
        raise


# ---------------------------------------------------------------- preemption
class PreemptionNotice:
    """Signal-to-flag bridge for the preemption grace window.

    ``install()`` (main thread) replaces the handlers of the given
    signals with one that records the notice time and sets a flag; it
    does NOT raise into the training loop: the supervisor polls
    :meth:`requested` at its step boundary, where the window drains and
    the final checkpoint commits cleanly. ``trigger()`` raises the flag
    from code. A notice with a ``scope`` (:func:`notice`) also honours
    the process-global one."""

    def __init__(self, scope: Optional[str] = None):
        self.scope = scope
        self._event = threading.Event()
        self._time: Optional[float] = None
        self._prev: dict = {}
        self._lock = threading.Lock()

    def install(self, signals=(signal.SIGTERM,)):
        """Arm the handlers; safe to call repeatedly. Off the main thread
        (where ``signal.signal`` raises) it is skipped with a warning;
        :meth:`trigger` still works."""
        for sig in signals:
            with self._lock:
                if sig in self._prev:
                    continue
            try:
                prev = signal.signal(sig, self._handler)
            except ValueError:   # not the main thread
                _LOG.warning(
                    "cannot install preemption handler for signal %s "
                    "off the main thread; rely on trigger()", sig)
                continue
            with self._lock:
                self._prev[sig] = prev

    def uninstall(self):
        """Restore the previous handlers and clear the flag."""
        with self._lock:
            prev, self._prev = dict(self._prev), {}
        for sig, handler in prev.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, TypeError):  # pragma: no cover
                pass
        self.clear()

    def _handler(self, signum, frame):      # pragma: no cover - signal
        self.trigger(signum)

    def trigger(self, signum=None):
        """Raise the preemption flag (what the signal handler does)."""
        with self._lock:
            if self._time is None:
                self._time = time.time()
        self._event.set()
        _LOG.warning(
            "preemption notice received (%s%s): requesting grace-window "
            "final checkpoint (MXNET_PREEMPTION_GRACE_SEC=%.0fs)",
            f"signal {signum}" if signum is not None else "programmatic",
            f", scope {self.scope!r}" if self.scope else "",
            preemption_grace_sec())

    def requested(self) -> bool:
        """Whether this notice (or, for a scoped one, the process-global
        one) has fired."""
        if self._event.is_set():
            return True
        return self.scope is not None and _notice._event.is_set()

    @property
    def notice_time(self) -> Optional[float]:
        return self._time

    def remaining_grace(self) -> float:
        """Seconds left in the grace window (the whole budget before a
        notice)."""
        grace = preemption_grace_sec()
        if self._time is None:
            return grace
        return grace - (time.time() - self._time)

    def clear(self):
        self._event.clear()
        with self._lock:
            self._time = None


_notice = PreemptionNotice()
_scoped_lock = threading.Lock()
_scoped: dict = {}


def notice(scope: Optional[str] = None) -> PreemptionNotice:
    """The process-global preemption notice, or with a ``scope`` the one
    registered for it (created at first use)."""
    if scope is None:
        return _notice
    with _scoped_lock:
        n = _scoped.get(scope)
        if n is None:
            n = _scoped[scope] = PreemptionNotice(scope=scope)
        return n


def clear_scoped_notices():
    """Drop every scoped notice."""
    with _scoped_lock:
        _scoped.clear()
