"""Fault injection for crash-consistency and chaos tests (counterpart of
``mxnet_tpu/testing/faults.py``).

The persistence stack and the training loop plant named *fault points*
(``checkpoint.stage``, ``checkpoint.commit``, ``checkpoint.prune``,
``ndarray.save``, ``step.dispatch``, ``window.retire``,
``prefetch.stage``, ...) that do nothing until a rule arms them, through
one env var or :func:`configure`::

    MXNET_FAULT_INJECT="checkpoint.commit:after=1"          # SIGKILL
    MXNET_FAULT_INJECT="checkpoint.stage:before=2:error"    # raise IO error
    MXNET_FAULT_INJECT="ndarray.save:before=1:delay:250"    # sleep 250ms
    MXNET_FAULT_INJECT="step.dispatch:before=6:revoke:2"    # lose 2 devices

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
            | 'revoke' [':' count]   # mark `count` devices (default 1)
                                     # revoked and raise DeviceRevokedError:
                                     # a device lost mid-run
            | 'revoke' ':' targets   # targets := 'd' id ['+' 'd' id ...]:
                                     # revoke those device ids
            | 'restore'              # un-revoke every device (the world
                                     # grows back); does not raise

``revoke`` marks the LAST ``count`` devices still alive revoked (one
always survives): ``parallel.dist.available_devices()`` leaves them out,
so the elastic supervisor (``mxnet_tpu_torch.elastic``) re-forms at a
smaller world. Its :class:`DeviceRevokedError` names the CUDA runtime's
device-lost text, so ``elastic.detect`` classifies it as the real thing.

**One run, several processes.** The port runs one process a card, and
the supervisor starts new ranks at every formation. Hit counts are per
process, but what a run has done is not: when ``MXNET_FAULT_STATE``
names a file (the supervisor sets it for its ranks), the revoked device
ids and the rules that already fired live there, under a file lock. A
rule then fires once in the whole run, on the first process to reach
its hit, and every process sees the same surviving world.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["fault_point", "FaultInjectedError", "DeviceRevokedError",
           "FaultRule", "configure", "reset", "hit_counts", "active_spec",
           "revoked_device_ids", "restore_devices", "STATE_ENV_VAR"]

_LOG = logging.getLogger("mxnet_tpu_torch.faults")

ENV_VAR = "MXNET_FAULT_INJECT"
#: the file shared by the processes of one run (revoked ids, fired rules)
STATE_ENV_VAR = "MXNET_FAULT_STATE"

_ACTIONS = ("kill", "error", "delay", "revoke", "restore")


class FaultInjectedError(OSError):
    """The injected IO failure (an ``OSError``, so a recovery path that
    catches ``OSError`` meets it as it would a real disk error)."""


class DeviceRevokedError(RuntimeError):
    """The injected device loss. Its message carries the CUDA runtime's
    device-lost text, so ``elastic.detect.is_device_lost`` classifies it
    as it classifies the real failure (a ``RuntimeError``, the type
    PyTorch raises for a failed CUDA call)."""


class FaultRule:
    __slots__ = ("point", "phase", "nth", "action", "delay_ms", "count",
                 "ctx", "device_ids", "fired", "key")

    def __init__(self, point: str, phase: str, nth: int, action: str,
                 delay_ms: int = 0, count: int = 1,
                 ctx: Optional[str] = None, device_ids=None):
        if phase not in ("before", "after"):
            raise ValueError(
                f"fault phase must be before/after, got {phase!r}")
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        self.point = point
        self.phase = phase
        self.nth = int(nth)
        self.action = action
        self.delay_ms = int(delay_ms)
        self.count = max(1, int(count))
        self.ctx = ctx               # None = match every context
        self.device_ids = tuple(device_ids) if device_ids else None
        self.fired = False
        #: the rule's name in the run's shared state (set by _parse)
        self.key = repr(self)

    def __repr__(self):
        at = f"@{self.ctx}" if self.ctx else ""
        return (f"FaultRule({self.point}{at}:{self.phase}={self.nth}"
                f":{self.action})")


def _parse_revoke_arg(arg: str):
    """``revoke``'s argument: a count, or 'd<id>' ('+'-joined for
    several) naming the device ids to revoke."""
    if arg and arg.lstrip().startswith("d"):
        ids = []
        for tok in arg.split("+"):
            tok = tok.strip()
            if not tok.startswith("d"):
                raise ValueError(
                    f"bad revoke target {tok!r}; expected 'd<id>'")
            ids.append(int(tok[1:]))
        return 1, tuple(ids)
    return int(arg), None


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
                "'point[@ctx]:before|after=N[:kill|error|delay:MS"
                "|revoke[:COUNT|:dID]|restore]'")
        point, ctx = parts[0], None
        if "@" in point:
            point, ctx = point.split("@", 1)
        phase, nth = parts[1].split("=", 1)
        action = parts[2] if len(parts) > 2 else "kill"
        delay_ms = int(parts[3]) if action == "delay" and len(parts) > 3 \
            else 0
        count, device_ids = 1, None
        if action == "revoke" and len(parts) > 3:
            count, device_ids = _parse_revoke_arg(parts[3])
        rule = FaultRule(point, phase.strip(), int(nth), action, delay_ms,
                         count, ctx=ctx, device_ids=device_ids)
        rule.key = f"{len(rules)}:{chunk}"
        rules.append(rule)
    return rules


# (point, phase[, ctx]) -> hit count; the rules are parsed from the env
# var once a process (a subprocess test sets it before it starts) or set
# by configure()
_lock = threading.Lock()
_rules: Optional[List[FaultRule]] = None
_spec: str = ""
_counts: Dict[Tuple[str, ...], int] = {}
# device ids a `revoke` marked lost in this process (with no shared file)
_revoked: set = set()


def _get_rules() -> List[FaultRule]:
    global _rules, _spec
    if _rules is None:
        _spec = os.environ.get(ENV_VAR, "")
        _rules = _parse(_spec) if _spec else []
        if _rules:
            _LOG.warning("fault injection ARMED: %s", _rules)
    return _rules


def configure(spec: Optional[str]) -> List[FaultRule]:
    """Arm (or, with None or '', disarm) fault rules in this process,
    in place of the env var; the hit counts start again from 0."""
    global _rules, _spec
    with _lock:
        _rules = _parse(spec) if spec else []
        _spec = spec or ""
        _counts.clear()
        return _rules


def active_spec() -> str:
    """The spec string of the armed rules ('' when none): what a parent
    hands its child processes in ``MXNET_FAULT_INJECT``."""
    _get_rules()
    return _spec


def reset():
    """Disarm everything, forget the hit counts and restore revoked
    devices (the env var is read again at the next fault point); with a
    shared state file, the run's fired rules and revoked ids go too."""
    global _rules, _spec
    with _lock:
        _rules = None
        _spec = ""
        _counts.clear()
        _revoked.clear()
    with _shared_state() as st:
        if st is not None:
            st["revoked"], st["fired"] = [], []


def hit_counts() -> Dict[Tuple[str, ...], int]:
    return dict(_counts)


# ---------------------------------------------------------------------------
# the run's shared state: revoked devices and fired rules
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _shared_state():
    """The run's state file, read and written back under an exclusive
    lock; yields None when ``MXNET_FAULT_STATE`` is not set."""
    path = os.environ.get(STATE_ENV_VAR)
    if not path:
        yield None
        return
    import fcntl
    with open(path + ".lock", "a") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            try:
                with open(path) as f:
                    st = json.load(f)
            except (OSError, ValueError):
                st = {}
            st.setdefault("revoked", [])
            st.setdefault("fired", [])
            yield st
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(st, f)
            os.replace(tmp, path)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def revoked_device_ids() -> frozenset:
    """Ids of the devices a ``revoke`` marked lost (empty normally)."""
    with _shared_state() as st:
        if st is not None:
            return frozenset(st["revoked"])
    with _lock:
        return frozenset(_revoked)


def restore_devices(ids=None):
    """Un-revoke devices (all by default): the world grows back; also
    what the ``restore`` action does."""
    with _shared_state() as st:
        if st is not None:
            st["revoked"] = [] if ids is None else \
                [i for i in st["revoked"] if i not in set(ids)]
            return
    with _lock:
        if ids is None:
            _revoked.clear()
        else:
            _revoked.difference_update(ids)


def _revoke(rule: FaultRule) -> list:
    """Mark the rule's devices revoked (its ids, or the LAST ``count``
    still alive); at least one device always survives. Returns the ids
    lost."""
    from ..parallel.dist import visible_device_ids
    every = visible_device_ids()
    with _shared_state() as st:
        held = set(st["revoked"]) if st is not None else _revoked
        alive = [d for d in every if d not in held]
        if rule.device_ids:
            lost = [d for d in alive if d in set(rule.device_ids)]
            lost = lost[:max(0, len(alive) - 1)]
        else:
            lost = alive[max(1, len(alive) - rule.count):]
        if st is not None:
            st["revoked"] = sorted(held | set(lost))
        else:
            with _lock:
                _revoked.update(lost)
    return lost


def _claim(rules: List[FaultRule]) -> List[FaultRule]:
    """The rules of ``rules`` this process may fire: with a shared state
    file, those no process of the run has fired yet (each recorded as
    fired); else all of them."""
    if not rules:
        return rules
    with _shared_state() as st:
        if st is None:
            return rules
        done = set(st["fired"])
        mine = [r for r in rules if r.key not in done]
        st["fired"] = sorted(done | {r.key for r in mine})
        return mine


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
    for r in _claim(to_fire):
        _fire(r)


def _fire(rule: FaultRule):
    _LOG.warning("fault injection FIRING %r (pid %d)", rule, os.getpid())
    if rule.action == "kill":
        # the hard preemption: no atexit, no finally, no flush, as a
        # node eviction or an OOM kill ends a process
        os.kill(os.getpid(), signal.SIGKILL)
    elif rule.action == "error":
        raise FaultInjectedError(
            f"injected IO failure at {rule.point}:{rule.phase}")
    elif rule.action == "delay":
        time.sleep(rule.delay_ms / 1000.0)
    elif rule.action == "revoke":
        lost = _revoke(rule)
        names = ", ".join(f"device {d}" for d in lost) \
            or "<none revocable: single-device world>"
        # the CUDA runtime's text for a card that fell off the bus
        # (cudaErrorDevicesUnavailable / an Xid 79 "GPU has fallen off
        # the bus"), which detect.is_device_lost matches
        raise DeviceRevokedError(
            f"CUDA error: device lost: {names} removed from the system; "
            f"all CUDA-capable devices are busy or unavailable "
            f"(injected revocation at {rule.point}:{rule.phase})")
    elif rule.action == "restore":
        restore_devices()
