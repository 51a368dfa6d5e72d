"""Typed serving failures and admission settings (counterpart of
``mxnet_tpu/serving/resilience.py``; the supervisor and circuit breaker
are not ported yet).

Every way an accepted request can fail is a distinct type the client can
branch on: :class:`DeadlineExceeded`, :class:`Overloaded` (shed at
admission; ``.reason`` says why) and :class:`ServingShutdown`. All
subclass :class:`MXNetError`.
"""
from __future__ import annotations

import os
from typing import Optional

from ..base import MXNetError

__all__ = ["DeadlineExceeded", "Overloaded", "ServingShutdown",
           "default_deadline_ms", "shed_mode"]


class DeadlineExceeded(MXNetError):
    """The request's latency budget ran out before it completed."""


class Overloaded(MXNetError):
    """The request was shed at admission (``.reason`` ∈ {``queue``,
    ``deadline``, ``breaker``, ``draining``, ``kvcache``}). Retryable."""

    def __init__(self, msg: str, reason: str = "queue"):
        super().__init__(msg)
        self.reason = reason


class ServingShutdown(MXNetError):
    """The server can no longer serve this request: it closed, or its
    dispatcher died, with the request still pending."""


def default_deadline_ms() -> Optional[float]:
    """``MXNET_SERVING_DEADLINE_MS``: the per-request latency budget when
    ``submit(deadline_ms=)`` is not given. Unset, empty, unparsable or
    <= 0 means no deadline."""
    v = os.environ.get("MXNET_SERVING_DEADLINE_MS", "").strip()
    if not v:
        return None
    try:
        ms = float(v)
    except ValueError:
        return None
    return ms if ms > 0 else None


def shed_mode(default: str = "deadline") -> str:
    """``MXNET_SERVING_SHED``: ``off``, ``deadline`` (the default: reject
    at submit when the projected wait exceeds the request's deadline) or
    ``queue``."""
    v = os.environ.get("MXNET_SERVING_SHED", "").strip().lower()
    return v if v in ("off", "deadline", "queue") else default
