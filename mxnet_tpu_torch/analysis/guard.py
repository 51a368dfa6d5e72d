"""Runtime transfer guard: catch silent device->host syncs in hot loops
(counterpart of ``mxnet_tpu/analysis/guard.py``).

The program lint (``analysis/program.py``) reads the host transfers a
recorded step issues; this guard catches them while the step runs: a
stray ``.item()`` / ``float(loss)`` / ``.cpu()`` in a loss function
costs one device round trip a step (and on a card it cannot be captured
in the step's graph, so the step falls back to eager), with no error
anywhere.

``MXNET_TRANSFER_GUARD=log|raise`` arms the guard; the hot regions
(``CompiledTrainStep.__call__`` and ``TrainLoop.step``) declare
themselves with :func:`hot_scope`. The port's arrays are
``torch.Tensor``s, which have no sync method of the framework's own to
hook, so an armed region runs under a ``TorchDispatchMode``
(:class:`_SyncWatch`) that sees the aten ops a host read is made of:
``_local_scalar_dense`` (``.item()``, ``float(t)``, ``bool(t)``, ``if
t:``), a copy from a device to the CPU (``.cpu()``, ``.to("cpu")``,
``.numpy()`` of a card's tensor goes through one), and the ops whose
output size depends on the data (``nonzero``, ``masked_select``,
``unique``), which wait for the card. Each one inside the region logs
the offending Python line (``log``) or raises an ``MXNetError``
(``raise``). Syncs OUTSIDE a hot region (printing the loss after the
step, metric updates between epochs) are never flagged.

Explicit use, independent of the env var::

    with mxt.analysis.transfer_guard("raise"):
        loss = step(x, y)        # any host sync inside raises

Framework code that must sync inside a hot region (the dist store's one
host sum a step, the loop's retire) wraps itself in
:func:`allow_transfers`. :func:`count_sync` is the always-on census
(``mx_guard_host_syncs_total{kind=}``) of the designed sync points.
"""
from __future__ import annotations

import logging
import os
import threading
import traceback
from contextlib import contextmanager
from typing import List, Optional, Tuple

__all__ = ["transfer_guard", "hot_scope", "allow_transfers", "armed",
           "on_sync", "events", "clear_events", "env_mode",
           "count_sync", "sync_counts", "reset_sync_counts",
           "HOST_SYNC_OPS"]

_LOG = logging.getLogger("mxnet_tpu_torch.analysis.guard")

_MODES = ("log", "raise")

#: aten ops that wait for the device and hand its data to the host
#: (the schedule record's ``host-transfer`` rule reads the same set)
HOST_SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "nonzero", "nonzero_static",
    "masked_select", "unique", "_unique", "_unique2", "unique_consecutive",
    "unique_dim", "repeat_interleave",
})


class _State(threading.local):
    def __init__(self):
        self.mode: Optional[str] = None   # active mode inside a scope
        self.suppress: int = 0            # allow_transfers depth
        self.scope: str = ""              # hot-region label for messages
        self.events: List[Tuple[str, str]] = []   # (kind, where)
        self.counts: dict = {}            # kind -> total syncs (always on)


_STATE = _State()


def env_mode() -> Optional[str]:
    """The MXNET_TRANSFER_GUARD env setting (None when unset/off)."""
    v = os.environ.get("MXNET_TRANSFER_GUARD", "").strip().lower()
    if not v or v in ("0", "off", "false", "no"):
        return None
    if v not in _MODES:
        _LOG.warning("MXNET_TRANSFER_GUARD=%r is not one of %s; "
                     "treating as 'log'", v, _MODES)
        return "log"
    return v


def armed() -> bool:
    """Whether a sync on this thread would be flagged now."""
    return _STATE.mode is not None and _STATE.suppress == 0


def events() -> List[Tuple[str, str]]:
    """(kind, caller) tuples recorded by 'log' mode since the last
    :func:`clear_events` — test hook."""
    return list(_STATE.events)


def clear_events():
    _STATE.events.clear()


#: the process-global mx_guard_host_syncs_total{kind=} counter, bound on
#: first use (the thread-local dict above it stays for per-region deltas)
_SYNC_COUNTER = None


def count_sync(kind: str):
    """Always-on census of device->host sync points: an int increment,
    armed or not. ``window_retire`` counts the dispatch window's designed
    retire (``engine.DispatchWindow``), ``predict`` a predictor's output
    copied to the host, ``wait_to_read`` and the aten kinds each sync an
    armed region saw. The per-thread dict feeds region deltas
    (:func:`sync_counts`); the process-global series the exporters."""
    global _SYNC_COUNTER
    st = _STATE
    st.counts[kind] = st.counts.get(kind, 0) + 1
    if _SYNC_COUNTER is None:
        from ..telemetry import names as _tnames
        from ..telemetry.registry import default as _treg
        _SYNC_COUNTER = _treg().counter(_tnames.HOST_SYNCS,
                                        label_key="kind")
    _SYNC_COUNTER.inc(label=kind)


def sync_counts() -> dict:
    """Per-kind sync totals on this thread since the last
    :func:`reset_sync_counts`."""
    return dict(_STATE.counts)


def reset_sync_counts():
    _STATE.counts.clear()


def _caller() -> str:
    """First stack frame outside this framework (and outside torch) —
    the user line that triggered the sync."""
    import mxnet_tpu_torch
    pkg = os.path.dirname(os.path.abspath(mxnet_tpu_torch.__file__))
    tdir = os.path.dirname(os.path.abspath(
        __import__("torch").__file__))
    for frame in reversed(traceback.extract_stack()):
        fn = os.path.abspath(frame.filename)
        if not fn.startswith((pkg, tdir)):
            return f"{frame.filename}:{frame.lineno} ({frame.name})"
    return "<unknown>"


def on_sync(kind: str, what: str = ""):
    """A sync inside an armed region: log it or raise."""
    st = _STATE
    where = _caller()
    st.events.append((kind, where))
    desc = (f"device->host sync `{kind}` inside the hot region "
            f"{st.scope or 'transfer_guard'}"
            + (f" on {what}" if what else "")
            + f" — triggered at {where}")
    if st.mode == "raise":
        from ..base import MXNetError
        raise MXNetError(
            desc + ". A sync here runs every step and blocks the device "
            "pipeline; move it outside the loop, or wrap it in "
            "mxt.analysis.allow_transfers() if intentional. "
            "(MXNET_TRANSFER_GUARD=log to only warn)")
    _LOG.warning("%s\n%s", desc,
                 "".join(traceback.format_stack(limit=8)[:-1]))


def _sync_kind(func, args, kwargs) -> Optional[str]:
    """The host-sync kind of one aten call, or None: a scalar read, a
    data-dependent shape, or a copy from a device to the CPU."""
    name = func.overloadpacket.__name__
    if name in HOST_SYNC_OPS:
        return "item" if name in ("_local_scalar_dense", "item") else name
    if name not in ("_to_copy", "copy_") or not args:
        return None
    src = args[1] if name == "copy_" and len(args) > 1 else args[0]
    if getattr(src, "device", None) is None or src.device.type == "cpu":
        return None
    if name == "copy_":
        dst = args[0].device
    else:
        dst = kwargs.get("device")
    return "to_host" if dst is not None and \
        str(dst).startswith("cpu") else None


def _watch_mode():
    """A ``TorchDispatchMode`` that reports each host sync of an armed
    region (built at first use: ``torch.utils._python_dispatch`` is
    imported lazily)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _SyncWatch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if armed():
                kind = _sync_kind(func, args, kwargs)
                if kind is not None:
                    count_sync(kind)
                    on_sync(kind, str(func))
            return func(*args, **kwargs)

    return _SyncWatch()


@contextmanager
def _watching():
    with _watch_mode():
        yield


@contextmanager
def transfer_guard(mode: str = "raise", scope: str = ""):
    """Explicitly guard a region regardless of MXNET_TRANSFER_GUARD."""
    if mode not in _MODES:
        raise ValueError(f"transfer_guard mode must be one of {_MODES}, "
                         f"got {mode!r}")
    st = _STATE
    prev_mode, prev_scope = st.mode, st.scope
    st.mode, st.scope = mode, scope or "transfer_guard"
    try:
        if prev_mode is None:
            with _watching():
                yield
        else:
            yield
    finally:
        st.mode, st.scope = prev_mode, prev_scope


@contextmanager
def hot_scope(name: str):
    """Declare a hot region; activates only when MXNET_TRANSFER_GUARD is
    set (or an enclosing transfer_guard is already active)."""
    st = _STATE
    if st.mode is not None:          # nested: keep the outer mode
        yield
        return
    mode = env_mode()
    if mode is None:
        yield
        return
    prev_scope = st.scope
    st.mode, st.scope = mode, name
    try:
        with _watching():
            yield
    finally:
        st.mode, st.scope = None, prev_scope


@contextmanager
def allow_transfers(reason: str = ""):
    """Bless syncs in a sub-region of a guarded scope (the dist store's
    one host sync a step, checkpoint capture, the loop's retire)."""
    _STATE.suppress += 1
    try:
        yield
    finally:
        _STATE.suppress -= 1
