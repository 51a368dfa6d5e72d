"""Profiler: per-op event recording + Chrome-trace dump + device trace
(the port's counterpart of ``mxnet_tpu/profiler.py``).

Reference analog: src/profiler/ (Profiler singleton with mode bitmask,
per-device stat queues, Chrome tracing JSON via DumpProfile) and
python/mxnet/profiler.py (set_config/set_state/dump/dumps).

What this module records natively is the *host-side* op stream — every
op through the port's op funnel (``ops.registry.invoke``), with its
dispatch wall time — dumped in Chrome tracing format (chrome://tracing /
Perfetto), plus aggregate tables like the reference's ``dumps();
aggregate_stats=True``. Each op also runs inside a
``torch.profiler.record_function`` of its name, so a device trace groups
its kernels under it. Device time comes from ``torch.profiler`` where
the JAX package points at XProf: ``set_config(tensorboard_dir=DIR)``
runs a ``torch.profiler.profile`` (CPU and, on a card, CUDA activities)
between ``set_state("run")`` and ``set_state("stop")``, writes its
Chrome trace to ``DIR/device_trace.json`` and keeps it as
:attr:`Profiler.device_profile` (``key_averages()``).

Async attribution: a CUDA op returns before the card ran it, so every
per-op event carries ``args.phase = "dispatch"`` (``"sync"`` under
``MXNET_ENGINE_TYPE=NaiveEngine``, whose loops wait for every step). The
moments work actually COMPLETES appear on the same timeline as the
step-phase spans the telemetry subsystem records (``cat: "step"``:
window residency push→retire and the blocking retire wait, stamped from
``engine.DispatchWindow``'s retire timestamps, plus batch_fetch /
h2d_wait / dispatch / checkpoint) — one merged stream.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import torch

from .base import MXNetError
from .ops import registry as _registry

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "pause",
           "resume", "scope", "Profiler", "dump_memory", "memory_summary",
           "Domain", "Task", "Frame", "Event", "Counter", "Marker",
           "profiler_set_config", "profiler_set_state", "dump_profile",
           "set_kvstore_handle"]


class Profiler:
    """Process-global profiler (reference Profiler singleton)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self.filename = "profile.json"
        self.aggregate_stats = False
        self.tensorboard_dir: Optional[str] = None
        self.running = False
        self.paused = False
        self._events = []
        self._ev_lock = threading.Lock()
        self._scope = ""
        self._hook_installed = False
        self._tb_active = False
        self._torch_prof = None
        #: the last device trace (``torch.profiler.profile``) taken with
        #: ``tensorboard_dir`` set, for ``key_averages()``
        self.device_profile = None

    @classmethod
    def get(cls) -> "Profiler":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = Profiler()
        return cls._instance

    # -- recording ---------------------------------------------------------

    def record(self, name: str, t_start: float, t_end: float,
               cat: str = "operator", args: Optional[dict] = None):
        """Append one complete ('X') slice; ``args`` lands in the Chrome
        event's args field — per-op events carry the dispatch/sync phase,
        step spans carry {step, phase} (docs/OBSERVABILITY.md)."""
        if not self.running or self.paused:
            return
        ev = {
            "name": (self._scope + name) if self._scope else name,
            "cat": cat, "ph": "X",
            "ts": t_start * 1e6, "dur": (t_end - t_start) * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident() % 100000,
        }
        if args:
            ev["args"] = args
        with self._ev_lock:
            self._events.append(ev)

    @staticmethod
    def _op_phase() -> str:
        """Honest attribution for per-op durations: host 'dispatch' time
        (a CUDA op returned before the card ran it), 'sync' under
        ``MXNET_ENGINE_TYPE=NaiveEngine``."""
        naive = os.environ.get("MXNET_ENGINE_TYPE") == "NaiveEngine"
        return "sync" if naive else "dispatch"

    def _invoke_wrapper(self, name, fn):
        prof = self

        def wrapped(*args, **kwargs):
            if not prof.running or prof.paused:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                # a device trace groups the op's kernels under its name
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            finally:
                prof.record(name, t0, time.perf_counter(),
                            args={"phase": prof._op_phase()})
        return wrapped

    def _install_hook(self):
        if not self._hook_installed:
            _registry.add_invoke_wrapper(self._invoke_wrapper)
            self._hook_installed = True

    # -- state -------------------------------------------------------------

    def set_config(self, **kwargs):
        known = {"filename", "aggregate_stats", "tensorboard_dir",
                 # reference mode flags, accepted for parity (the host
                 # stream records every funnelled op; torch.profiler
                 # owns device timing):
                 "profile_all", "profile_symbolic", "profile_imperative",
                 "profile_memory", "profile_api", "continuous_dump"}
        for k, v in kwargs.items():
            if k not in known:
                raise MXNetError(f"unknown profiler option {k!r}")
            if k in ("filename", "aggregate_stats", "tensorboard_dir"):
                setattr(self, k, v)

    def set_state(self, state: str):
        if state not in ("run", "stop"):
            raise MXNetError("profiler state must be 'run' or 'stop'")
        if state == "run":
            self._install_hook()
            self.running = True
            if self.tensorboard_dir and not self._tb_active:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._torch_prof = torch.profiler.profile(activities=acts)
                self._torch_prof.start()
                self._tb_active = True
        else:
            self.running = False
            if self._tb_active:
                prof, self._torch_prof = self._torch_prof, None
                self._tb_active = False
                prof.stop()
                os.makedirs(self.tensorboard_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    self.tensorboard_dir, "device_trace.json"))
                self.device_profile = prof

    def dump(self, finished: bool = True):
        """Write accumulated events as Chrome tracing JSON."""
        with self._ev_lock:
            events = list(self._events)
            if finished:
                self._events.clear()
        with open(self.filename, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)

    def dumps(self, reset: bool = False) -> str:
        """Aggregate per-op table (reference aggregate_stats output)."""
        with self._ev_lock:
            events = list(self._events)
            if reset:
                self._events.clear()
        agg = {}
        for e in events:
            st = agg.setdefault(e["name"], [0, 0.0, float("inf"), 0.0])
            st[0] += 1
            st[1] += e["dur"]
            st[2] = min(st[2], e["dur"])
            st[3] = max(st[3], e["dur"])
        lines = [f"{'Name':<40s}{'Calls':>8s}{'Total(us)':>14s}"
                 f"{'Min(us)':>12s}{'Max(us)':>12s}{'Avg(us)':>12s}"]
        for name in sorted(agg, key=lambda n: -agg[n][1]):
            c, tot, mn, mx = agg[name]
            lines.append(f"{name:<40s}{c:>8d}{tot:>14.1f}{mn:>12.1f}"
                         f"{mx:>12.1f}{tot / c:>12.1f}")
        return "\n".join(lines)


def set_config(**kwargs):
    Profiler.get().set_config(**kwargs)


def set_state(state: str = "stop"):
    Profiler.get().set_state(state)


def state() -> str:
    return "run" if Profiler.get().running else "stop"


def dump(finished: bool = True):
    Profiler.get().dump(finished)


def dumps(reset: bool = False) -> str:
    return Profiler.get().dumps(reset)


def dump_memory(path: str = "memory_snapshot.json") -> str:
    """Write the caching allocator's segments (reference storage
    profiler; here ``torch.cuda.memory_snapshot()``: every segment of
    every card with its blocks, sizes and states) as JSON. Needs a card:
    the CPU has no allocator to read."""
    if not torch.cuda.is_available():
        raise MXNetError("dump_memory reads the CUDA caching allocator; "
                         "there is no CUDA device here (use "
                         "memory_summary())")
    snap = torch.cuda.memory_snapshot()
    with open(path, "w") as f:
        json.dump(snap, f, default=str)
    return path


def memory_summary() -> dict:
    """Per-device memory totals (the aggregate the reference printed
    from its storage profiler), routed through the telemetry catalog:
    each read refreshes the ``mx_mem_device_bytes_in_use`` /
    ``_peak_bytes`` / ``_limit_bytes`` gauges instead of living in an
    ad-hoc dict only this call ever saw.

    Each card reports its caching allocator's ``{bytes_in_use,
    peak_bytes_in_use, bytes_limit, source: "allocator"}``. The CPU has
    NO allocator stats — the documented fallback prices every live CPU
    tensor (``source: "live_arrays"``; peak/limit stay None because live
    accounting has no high-water mark)."""
    from .telemetry.memory import device_memory_stats
    return device_memory_stats()


def pause():
    Profiler.get().paused = True


def resume():
    Profiler.get().paused = False


@contextlib.contextmanager
def scope(name: str):
    """Prefix recorded op names (reference __profiler_scope__ attr,
    c_api_ndarray.cc:104); also a ``torch.profiler.record_function`` so
    the scope shows up in device traces."""
    prof = Profiler.get()
    old = prof._scope
    prof._scope = old + name.rstrip(":") + ":"
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        prof._scope = old


# ---------------------------------------------------------------------------
# instrumentation object API (reference profiler.py:228-520: Domain,
# Task, Frame, Event, Counter, Marker over the MXProfile* C API). Here
# each object writes straight into the profiler's Chrome-trace event
# stream: durations as 'X' slices categorized by domain, counters as
# 'C' samples, markers as 'i' instants — visible in chrome://tracing
# next to the per-op events.
# ---------------------------------------------------------------------------

class Domain:
    """Category grouping for instrumentation objects (reference :228)."""

    def __init__(self, name):
        self.name = name

    def __str__(self):
        return self.name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class _DurationObject:
    """start()/stop() pair recording one Chrome-trace slice."""

    _cat_suffix = ""

    def __init__(self, domain, name):
        self.name = name
        self._domain = domain
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise MXNetError(f"{type(self).__name__} {self.name!r}: "
                             "stop() before start()")
        Profiler.get().record(self.name, self._t0, time.perf_counter(),
                              cat=str(self._domain) + self._cat_suffix)
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def __str__(self):
        return self.name


class Task(_DurationObject):
    """Accumulated logical unit of work (reference :287)."""


class Frame(_DurationObject):
    """Per-pass discrete duration, e.g. one video frame
    (reference :329)."""

    _cat_suffix = ":frame"


class Event(_DurationObject):
    """Per-thread demarcated event without a domain (reference :371)."""

    def __init__(self, name):
        super().__init__(_EVENT_DOMAIN, name)


_EVENT_DOMAIN = Domain("event")


class Counter:
    """Numeric counter sampled into the trace (reference :420):
    set_value/increment/decrement emit Chrome 'C' events."""

    def __init__(self, domain, name, value=None):
        self.name = name
        self._domain = domain
        self._value = 0
        if value is not None:
            self.set_value(value)

    def _emit(self):
        prof = Profiler.get()
        if not prof.running or prof.paused:
            return
        with prof._ev_lock:
            prof._events.append({
                "name": self.name, "cat": str(self._domain), "ph": "C",
                "ts": time.perf_counter() * 1e6, "pid": os.getpid(),
                "tid": threading.get_ident() % 100000,
                "args": {"value": self._value},
            })

    def set_value(self, value):
        self._value = value
        self._emit()

    def increment(self, delta=1):
        self._value += delta
        self._emit()

    def decrement(self, delta=1):
        self._value -= delta
        self._emit()

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self

    def __str__(self):
        return self.name


class Marker:
    """Instant marker (reference :470): mark(scope) emits a Chrome 'i'
    event with the given scope ('process'|'thread'|'global')."""

    _SCOPES = {"process": "p", "thread": "t", "global": "g"}

    def __init__(self, domain, name):
        self.name = name
        self._domain = domain

    def mark(self, scope="process"):
        prof = Profiler.get()
        if not prof.running or prof.paused:
            return
        with prof._ev_lock:
            prof._events.append({
                "name": self.name, "cat": str(self._domain), "ph": "i",
                "ts": time.perf_counter() * 1e6, "pid": os.getpid(),
                "tid": threading.get_ident() % 100000,
                "s": self._SCOPES.get(scope, "p"),
            })


# deprecated 1.x aliases (reference profiler.py keeps them with warnings)
def profiler_set_config(mode="symbolic", filename="profile.json"):
    import warnings
    warnings.warn("profiler.profiler_set_config is deprecated; use "
                  "profiler.set_config", DeprecationWarning, stacklevel=2)
    set_config(filename=filename)


def profiler_set_state(state="stop"):
    import warnings
    warnings.warn("profiler.profiler_set_state is deprecated; use "
                  "profiler.set_state", DeprecationWarning, stacklevel=2)
    set_state(state)


def dump_profile():
    import warnings
    warnings.warn("profiler.dump_profile is deprecated; use "
                  "profiler.dump", DeprecationWarning, stacklevel=2)
    dump(True)


def set_kvstore_handle(handle=None):
    """No-op shim (reference wires the kvstore's server-side profiler
    over the C API; the port's stores are in-process, so their ops
    already land in this profiler's stream)."""
    return None
