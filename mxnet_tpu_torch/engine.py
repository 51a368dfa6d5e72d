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
"""
from __future__ import annotations

import contextlib
import logging
import threading
from collections import deque
from typing import Any, Callable

import torch

from .base import MXNetError
from .testing.faults import fault_point

__all__ = ["DispatchWindow", "allow_sync"]

_LOG = logging.getLogger("mxnet_tpu_torch.engine")


@contextlib.contextmanager
def allow_sync():
    """Turn PyTorch's CUDA sync debug mode off for the block (the
    designed sync of a retire), restoring it afterwards."""
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
        self._mu = threading.Lock()
        self.stats = {"pushes": 0, "retires": 0, "errors": 0,
                      "max_pending": 0, "abandoned": 0}

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, payload, tag=None):
        """Record one dispatched step; returns at once unless the window
        is over capacity, in which case the oldest entry retires."""
        with self._mu:
            self.stats["pushes"] += 1
            self._pending.append((tag, payload))
            self.stats["max_pending"] = max(self.stats["max_pending"],
                                            len(self._pending))
        while len(self._pending) > self.max_inflight:
            self._retire_oldest()

    def _retire_oldest(self):
        with self._mu:
            if not self._pending:
                return
            tag, payload = self._pending.popleft()
        fault_point("window.retire", "before")
        try:
            with allow_sync():
                self._sync(payload)
        except MXNetError as e:
            with self._mu:
                self.stats["errors"] += 1
            _record_device_lost(e, tag)
            raise
        except Exception as e:
            with self._mu:
                self.stats["errors"] += 1
            _record_device_lost(e, tag)
            raise MXNetError(
                f"async {self._what} "
                f"{tag if tag is not None else '<untagged>'} failed "
                f"(deferred error surfaced at its in-flight-window "
                f"retire): {type(e).__name__}: {e}") from e
        with self._mu:
            self.stats["retires"] += 1
        fault_point("window.retire", "after")

    def drain(self):
        """Retire every outstanding entry; a deferred error surfaces here
        attributed to its step."""
        while self._pending:
            self._retire_oldest()

    def abandon(self) -> list:
        """Discard every in-flight entry without waiting; returns their
        tags."""
        with self._mu:
            tags = [t for t, _ in self._pending]
            self._pending.clear()
            self.stats["abandoned"] += len(tags)
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
