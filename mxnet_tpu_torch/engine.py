"""Bounded in-flight dispatch (counterpart of ``mxnet_tpu/engine.py``
``DispatchWindow``).

PyTorch's CUDA calls return before the device has run them, so a
dispatched step is already a future. :class:`DispatchWindow` bounds how
far the host runs ahead: ``push()`` records each step's result, and only
when more than ``max_inflight`` are outstanding does the host wait, on
the OLDEST one (FIFO). The retire is the one designed host sync of a
pipelined loop: it runs with PyTorch's sync debug mode off
(:func:`allow_sync`), so a loop guarded by
``torch.cuda.set_sync_debug_mode("error")`` flags every other sync.

Error contract: an asynchronous failure surfaces at the retire of the
step that faulted, as an :class:`MXNetError` naming that step's tag; a
device loss among them is recorded once (``elastic.detect``). The
retire is bracketed by the ``window.retire`` fault points, where a
revoked device lands in a pipelined run. :meth:`DispatchWindow.
drain_partial` is the recovery's drain: it retires what still completes
and discards the rest.

Telemetry (``telemetry/``): the push / retire / error counters and the
occupancy / capacity gauges are always on; with ``MXNET_TELEMETRY`` (or a
running profiler) each retire records the ``window`` and ``retire``
spans and feeds the watchdog (step time, MFU, the NaN check of the
retired loss, the memory budget). A step's numerics record
(``telemetry.StepNumerics``), pushed beside its loss, is read at its
retire. An allocation failure surfacing at a retire gets its OOM
post-mortem (``telemetry.memory.maybe_record_oom``).

:func:`inflight_steps` is the window depth a ``TrainLoop`` (and the
autotuner's timed trials) takes: the ``engine.inflight_steps`` tunable
(``tuning/space.py``), registered here next to its default.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import deque
from typing import Any, Callable

import torch

from . import telemetry as _telemetry
from .analysis import guard as _tguard
from .analysis.threads import mx_lock
from .base import MXNetError
from .testing.faults import fault_point

__all__ = ["DispatchWindow", "allow_sync", "inflight_steps"]

_LOG = logging.getLogger("mxnet_tpu_torch.engine")


def inflight_steps(default: int = 2) -> int:
    """The dispatch window's depth: how many dispatched steps the host
    may keep outstanding before it waits on the oldest. Resolved autotune
    override > ``MXNET_INFLIGHT_STEPS`` > ``default`` (the
    ``engine.inflight_steps`` tunable); ``MXNET_ENGINE_TYPE=NaiveEngine``
    forces 0 (every step retires at once)."""
    if os.environ.get("MXNET_ENGINE_TYPE") == "NaiveEngine":
        return 0
    from .tuning import space as _tspace
    found, v = _tspace.get_override("engine.inflight_steps")
    if not found:
        v = os.environ.get("MXNET_INFLIGHT_STEPS", str(default))
    try:
        return max(0, int(v))
    except (TypeError, ValueError):
        return default


def _register_tunables():
    """The window-depth tunable: losses are bit-equal at any depth (the
    window only decides when the host waits), so it is speed alone."""
    from .tuning.space import Tunable, register
    register(Tunable(
        "engine.inflight_steps", default=2, grid=(0, 1, 2, 3, 4, 6, 8),
        env="MXNET_INFLIGHT_STEPS", parse=int,
        valid=lambda v, _c: int(v) >= 0,
        seam="engine.inflight_steps() -> DispatchWindow max_inflight",
        scope="train",
        doc="async step futures outstanding before the host blocks on "
            "the oldest"))


_register_tunables()


@contextlib.contextmanager
def allow_sync():
    """Turn PyTorch's CUDA sync debug mode off for the block (the
    designed sync of a retire), restoring it afterwards; the transfer
    guard (``analysis.guard``) blesses it too."""
    with _tguard.allow_transfers("designed sync"):
        if not torch.cuda.is_available():
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)


class DispatchWindow:
    """At most ``max_inflight`` dispatched steps outstanding; the host
    waits on the oldest when a push exceeds it. ``sync_fn(payload)`` is
    the retire (it waits for and reads the step's result)."""

    def __init__(self, sync_fn: Callable[[Any], Any],
                 max_inflight: int = 2, what: str = "step"):
        self.max_inflight = max(0, int(max_inflight))
        self._sync = sync_fn
        self._what = what
        self._pending: "deque[tuple]" = deque()
        self._mu = mx_lock("engine.window")
        self.stats = {"pushes": 0, "retires": 0, "errors": 0,
                      "max_pending": 0, "abandoned": 0}
        self._last_retire_t = None
        t = _telemetry
        reg = t.registry()
        self._m_pushes = reg.counter(t.names.WINDOW_PUSHES)
        self._m_retires = reg.counter(t.names.WINDOW_RETIRES)
        self._m_errors = reg.counter(t.names.WINDOW_ERRORS)
        self._m_occupancy = reg.gauge(t.names.WINDOW_OCCUPANCY)
        self._m_capacity = reg.gauge(t.names.WINDOW_CAPACITY)
        self._m_capacity.set(self.max_inflight)

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, payload, tag=None, aux=None):
        """Record one dispatched step; returns at once unless the window
        is over capacity, in which case the oldest entry retires.
        ``aux`` is the step's numerics record
        (``telemetry.StepNumerics``), read at this entry's retire."""
        with self._mu:
            self.stats["pushes"] += 1
            self._pending.append((tag, payload, aux, time.perf_counter()))
            self.stats["max_pending"] = max(self.stats["max_pending"],
                                            len(self._pending))
            depth = len(self._pending)
        self._m_pushes.inc()
        # re-asserted per push: gauges survive telemetry.reset() zeroing
        self._m_capacity.set(self.max_inflight)
        self._m_occupancy.set(depth)
        while len(self._pending) > self.max_inflight:
            self._retire_oldest()

    def _retire_oldest(self):
        with self._mu:
            if not self._pending:
                return
            tag, payload, aux, t_push = self._pending.popleft()
            depth = len(self._pending)
        self._m_occupancy.set(depth)
        fault_point("window.retire", "before")
        t_wait = time.perf_counter()
        _tguard.count_sync("window_retire")
        with allow_sync():
            try:
                self._sync(payload)
            except MXNetError as e:
                self._failed(e, tag)
                raise
            except Exception as e:
                self._failed(e, tag)
                raise MXNetError(
                    f"async {self._what} "
                    f"{tag if tag is not None else '<untagged>'} failed "
                    f"(deferred error surfaced at its in-flight-window "
                    f"retire): {type(e).__name__}: {e}") from e
            with self._mu:
                self.stats["retires"] += 1
            self._m_retires.inc()
            # still inside the retire's designed sync: the watchdog's
            # NaN check of the (completed) loss and the numerics read
            self._observe_retire(tag, payload, aux, t_push, t_wait)
        fault_point("window.retire", "after")

    def _failed(self, e, tag):
        with self._mu:
            self.stats["errors"] += 1
        self._m_errors.inc()
        # a deferred allocation failure surfaces here, steps after the
        # allocation: its post-mortem first, then the device-loss record
        _telemetry.memory.maybe_record_oom(e, "dispatch-window retire",
                                           step=tag)
        _record_device_lost(e, tag)

    def _observe_retire(self, tag, payload, aux, t_push, t_wait):
        """Step-timeline spans + watchdog feed for one retire, gated on
        ``MXNET_TELEMETRY`` / a running profiler; never kills a run. The
        numerics record is read first and regardless of that gate
        (``MXNET_NUMERICS`` is its own opt-in)."""
        t = _telemetry
        try:
            if aux is not None:
                t.numerics.monitor().observe_retire(tag, aux)
            if not t.active():
                self._last_retire_t = None
                return
            t_done = time.perf_counter()
            tl = t.timeline()
            tl.record("window", t_push, t_done, step=tag)
            tl.record("retire", t_wait, t_done, step=tag)
            dt = None if self._last_retire_t is None \
                else t_done - self._last_retire_t
            self._last_retire_t = t_done
            if t.enabled():
                t.watchdog().observe_retire(tag, payload=payload, dt=dt)
                # the memory budget's headroom check, on the same retire
                # (host-side allocator counters; no-op unless
                # MXNET_MEMORY_BUDGET is set)
                t.memory.maybe_check_budget(step=tag)
        except Exception:            # pragma: no cover - defensive
            logging.getLogger("mxnet_tpu_torch.telemetry").warning(
                "window retire telemetry failed", exc_info=True)

    def drain(self):
        """Retire every outstanding entry; a deferred error surfaces here
        attributed to its step."""
        while self._pending:
            self._retire_oldest()

    def abandon(self) -> list:
        """Discard every in-flight entry without waiting; returns their
        tags."""
        with self._mu:
            tags = [t for t, *_ in self._pending]
            self._pending.clear()
            self.stats["abandoned"] += len(tags)
        self._m_occupancy.set(0)
        return tags

    def drain_partial(self):
        """The recovery's drain: retire entries that still complete, in
        FIFO order (work the device finished before it failed), then
        discard everything after the first failure. Returns ``(retired,
        discarded_tags)``; the failed entry is consumed. The failure is
        logged, not raised: the caller already holds the one that
        started the recovery."""
        retired = 0
        while self._pending:
            try:
                self._retire_oldest()
                retired += 1
            except Exception as e:
                _LOG.warning(
                    "recovery drain: retire failed (%s: %s); discarding "
                    "%d in-flight step(s)", type(e).__name__, e,
                    len(self._pending))
                return retired, self.abandon()
        return retired, []


def _record_device_lost(exc, tag):
    from .elastic import detect
    detect.maybe_record_device_lost(exc, "dispatch-window retire", step=tag)
