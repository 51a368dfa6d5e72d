"""Fault injection for crash-consistency tests (counterpart of
``mxnet_tpu/testing/faults.py``).

The persistence stack plants named *fault points* (``checkpoint.stage``,
``checkpoint.commit``, ``checkpoint.prune``, ``ndarray.save``, ...) that
do nothing until a rule arms them, through one env var or
:func:`configure`::

    MXNET_FAULT_INJECT="checkpoint.commit:after=1"          # SIGKILL
    MXNET_FAULT_INJECT="checkpoint.stage:before=2:error"    # raise IO error
    MXNET_FAULT_INJECT="ndarray.save:before=1:delay:250"    # sleep 250ms

Grammar (``;``-separated rules, as the JAX package's)::

    rule   := point ['@' ctx] ':' phase '=' nth [':' action]
    ctx    := a caller's context tag: the rule fires on the nth hit AT
              THAT CONTEXT only (``fault_point(point, phase, ctx=...)``);
              a rule without '@' matches every context
    phase  := 'before' | 'after'     # relative to the guarded operation
    nth    := 1-based hit count at which the rule fires (once)
    action := 'kill'                 # os.kill(SIGKILL): a hard preemption
            | 'error'                # raise FaultInjectedError (an OSError)
            | 'delay' ':' millis     # sleep, for overlap and race windows

The JAX package's ``revoke`` and ``restore`` actions mark devices lost
and found for its elastic supervisor, which this package does not port
yet: a rule naming them is refused with :class:`MXNetError`.
"""
from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..base import MXNetError

__all__ = ["fault_point", "FaultInjectedError", "FaultRule", "configure",
           "reset", "hit_counts"]

_LOG = logging.getLogger("mxnet_tpu_torch.faults")

ENV_VAR = "MXNET_FAULT_INJECT"

_ACTIONS = ("kill", "error", "delay")
#: the JAX package's device-loss actions, refused here
_ELASTIC_ACTIONS = ("revoke", "restore")


class FaultInjectedError(OSError):
    """The injected IO failure (an ``OSError``, so a recovery path that
    catches ``OSError`` meets it as it would a real disk error)."""


class FaultRule:
    __slots__ = ("point", "phase", "nth", "action", "delay_ms", "ctx",
                 "fired")

    def __init__(self, point: str, phase: str, nth: int, action: str,
                 delay_ms: int = 0, ctx: Optional[str] = None):
        if phase not in ("before", "after"):
            raise ValueError(f"fault phase must be before/after, got {phase!r}")
        if action in _ELASTIC_ACTIONS:
            raise MXNetError(
                f"fault action {action!r} marks devices lost for the "
                "elastic supervisor, which mxnet_tpu_torch does not port "
                "yet; the ported actions are kill, error and delay")
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        self.point = point
        self.phase = phase
        self.nth = int(nth)
        self.action = action
        self.delay_ms = int(delay_ms)
        self.ctx = ctx               # None = match every context
        self.fired = False

    def __repr__(self):
        at = f"@{self.ctx}" if self.ctx else ""
        return (f"FaultRule({self.point}{at}:{self.phase}={self.nth}"
                f":{self.action})")


def _parse(spec: str) -> List[FaultRule]:
    rules: List[FaultRule] = []
    for chunk in spec.replace(",", ";").split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        if len(parts) < 2 or "=" not in parts[1]:
            raise ValueError(
                f"bad {ENV_VAR} rule {chunk!r}; expected "
                "'point[@ctx]:before|after=N[:kill|error|delay:MS]'")
        point, ctx = parts[0], None
        if "@" in point:
            point, ctx = point.split("@", 1)
        phase, nth = parts[1].split("=", 1)
        action = parts[2] if len(parts) > 2 else "kill"
        delay_ms = int(parts[3]) if action == "delay" and len(parts) > 3 \
            else 0
        rules.append(FaultRule(point, phase.strip(), int(nth), action,
                               delay_ms, ctx=ctx))
    return rules


# (point, phase[, ctx]) -> hit count; the rules are parsed from the env
# var once a process (a subprocess test sets it before it starts) or set
# by configure()
_lock = threading.Lock()
_rules: Optional[List[FaultRule]] = None
_counts: Dict[Tuple[str, ...], int] = {}


def _get_rules() -> List[FaultRule]:
    global _rules
    if _rules is None:
        spec = os.environ.get(ENV_VAR, "")
        _rules = _parse(spec) if spec else []
        if _rules:
            _LOG.warning("fault injection ARMED: %s", _rules)
    return _rules


def configure(spec: Optional[str]) -> List[FaultRule]:
    """Arm (or, with None or '', disarm) fault rules in this process,
    in place of the env var; the hit counts start again from 0."""
    global _rules
    with _lock:
        _rules = _parse(spec) if spec else []
        _counts.clear()
        return _rules


def reset():
    """Disarm everything and forget the hit counts (the env var is read
    again at the next fault point)."""
    global _rules
    with _lock:
        _rules = None
        _counts.clear()


def hit_counts() -> Dict[Tuple[str, ...], int]:
    return dict(_counts)


def fault_point(point: str, phase: str = "before",
                ctx: Optional[str] = None):
    """A named fault point. Call sites bracket a critical operation::

        fault_point("checkpoint.commit", "before")
        os.replace(tmp, final)
        fault_point("checkpoint.commit", "after")

    ``ctx`` tags the call with a caller's context: ``point@ctx`` rules
    fire on the nth hit at that context only. Without an armed rule this
    is one list lookup."""
    rules = _get_rules()
    if not rules:
        return
    with _lock:
        key = (point, phase)
        _counts[key] = n = _counts.get(key, 0) + 1
        nc = None
        if ctx is not None:
            ckey = (point, phase, ctx)
            _counts[ckey] = nc = _counts.get(ckey, 0) + 1
        to_fire = [r for r in rules
                   if r.point == point and r.phase == phase
                   and not r.fired
                   and (r.nth == n if r.ctx is None
                        else (r.ctx == ctx and r.nth == nc))]
        for r in to_fire:
            r.fired = True
    for r in to_fire:
        _fire(r)


def _fire(rule: FaultRule):
    _LOG.warning("fault injection FIRING %r", rule)
    if rule.action == "kill":
        # the hard preemption: no atexit, no finally, no flush, as a
        # node eviction or an OOM kill ends a process
        os.kill(os.getpid(), signal.SIGKILL)
    elif rule.action == "error":
        raise FaultInjectedError(
            f"injected IO failure at {rule.point}:{rule.phase}")
    elif rule.action == "delay":
        time.sleep(rule.delay_ms / 1000.0)
