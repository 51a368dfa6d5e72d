"""Concurrency audit: named locks, lock-order graph, deadlock forensics
(counterpart of ``mxnet_tpu/analysis/threads.py``, pure Python, the same
names and behaviour).

The host-side thread layer (window retires, the batcher's dispatcher,
checkpoint writers, prefetch staging, heartbeats, fleet failover) is
audited here:

- :func:`mx_lock` / :func:`mx_rlock` / :func:`mx_condition` return
  NAMED, instrumented primitives that behave exactly like their
  ``threading`` counterparts but additionally record, per thread, the
  stack of locks currently held. Every acquisition made while other
  audited locks are held adds a ``held -> acquired`` edge (with both
  call sites) to a process-global :class:`LockOrderGraph`.
- A CYCLE in that graph is a potential deadlock: two threads can
  interleave the two orderings and wedge. :func:`find_cycles` /
  :func:`cycle_findings` report each one with the owning stacks named.
- The blessed hierarchy lives in
  ``tests/fixtures/torch_lock_hierarchy.json``;
  :func:`check_hierarchy` fails on any edge outside it (the checked-in
  baseline discipline the fusion/sharding audits use). Refresh with
  :func:`save_baseline` after reviewing the new edge.
- RUNTIME forensics: a thread blocked on an audited lock for longer
  than ``MXNET_LOCK_STALL_SEC`` fires exactly one ``deadlock`` episode
  anomaly on the watchdog channel and writes one atomic ranked dump
  (ownership graph, per-thread stacks, queue depths) to
  ``MXNET_THREADS_DUMP_DIR`` — the OOM/NaN post-mortem pattern.
- ``mx_threads_*`` metrics (held-lock gauge, longest-wait gauge,
  per-lock wait histogram, dump counter) feed the always-on registry.

The deterministic-schedule harness (``testing/sched.py``) interposes on
these same primitives: while a ``VirtualScheduler`` is installed via
:func:`set_scheduler`, acquire/release/wait/notify on its managed
threads become cooperative yield points, making thread interleavings
replayable from a seed.

Import discipline: this module must stay light (no torch, no telemetry
at import time) — engine.py and telemetry/exporters.py import it at
module scope. Telemetry is reached lazily, the package-wide idiom.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .report import Finding

__all__ = [
    "MxLock", "MxCondition", "LockOrderGraph", "ThreadReport",
    "mx_lock", "mx_rlock", "mx_condition",
    "graph", "snapshot", "find_cycles", "cycle_findings",
    "check_hierarchy", "load_baseline", "save_baseline",
    "describe_locks", "register_queue", "write_dump", "dump_payload",
    "stall_seconds", "dump_dir", "reset",
    "set_scheduler", "scheduler",
]

_LOG = logging.getLogger("mxnet_tpu_torch.analysis")

# The instrument's own mutex — the ONE lock that must stay outside the
# audited universe (auditing the auditor would recurse). Kept bare on
# purpose.
_MU = threading.Lock()  # mx-lint: allow=MXA009

# telemetry is imported lazily (package initializes in dependency
# order) and cached — the idiom engine.py uses
_TELEM = None


def _telemetry():
    global _TELEM
    if _TELEM is None:
        from .. import telemetry as _t
        _TELEM = _t
    return _TELEM


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def stall_seconds(default: float = 0.0) -> float:
    """``MXNET_LOCK_STALL_SEC``: a thread blocked on an audited lock
    longer than this fires the ``deadlock`` watchdog episode + dump.
    Unset/<=0 disables the detector (the default — training loops own
    their own latency budget)."""
    try:
        v = float(os.environ.get("MXNET_LOCK_STALL_SEC", default))
    except (TypeError, ValueError):
        return default
    return v if v > 0 else 0.0


def dump_dir() -> Optional[str]:
    """``MXNET_THREADS_DUMP_DIR``: where stall dumps land (None = no
    dumps, the anomaly event still fires)."""
    d = os.environ.get("MXNET_THREADS_DUMP_DIR", "").strip()
    return d or None


# ---------------------------------------------------------------------------
# per-thread held-lock stack + call sites
# ---------------------------------------------------------------------------

class _Held:
    __slots__ = ("lock", "site", "count")

    def __init__(self, lock, site, count=1):
        self.lock = lock
        self.site = site
        self.count = count


_TLS = threading.local()


def _held_stack() -> list:
    st = getattr(_TLS, "held", None)
    if st is None:
        st = _TLS.held = []
    return st


def _call_site(limit: int = 3) -> Tuple[str, ...]:
    """Up to ``limit`` frames of the caller's stack, innermost first,
    skipping this module — cheap frame walk, no traceback objects."""
    try:
        f = sys._getframe(1)
    except ValueError:      # pragma: no cover - no caller frame
        return ()
    here = __file__
    out = []
    while f is not None and len(out) < limit:
        co = f.f_code
        if co.co_filename != here:
            out.append("%s:%d in %s" % (
                os.path.basename(co.co_filename), f.f_lineno, co.co_name))
        f = f.f_back
    return tuple(out)


# ---------------------------------------------------------------------------
# the lock-order graph
# ---------------------------------------------------------------------------

class LockOrderGraph:
    """Directed graph of observed lock acquisition orderings.

    Edge ``a -> b`` means: some thread acquired ``b`` while holding
    ``a``. The first observation's call sites (both sides) and thread
    name are kept; later observations only bump the count. A cycle is a
    potential deadlock."""

    def __init__(self):
        self._edges: Dict[Tuple[str, str], dict] = {}

    def record(self, frm: str, to: str,
               frm_site: Sequence[str], to_site: Sequence[str]):
        key = (frm, to)
        with _MU:
            e = self._edges.get(key)
            if e is None:
                self._edges[key] = {
                    "from": frm, "to": to, "count": 1,
                    "from_site": list(frm_site),
                    "to_site": list(to_site),
                    "thread": threading.current_thread().name,
                }
            else:
                e["count"] += 1

    def edges(self) -> List[dict]:
        with _MU:
            return [dict(e) for e in self._edges.values()]

    def edge_pairs(self) -> Set[Tuple[str, str]]:
        with _MU:
            return set(self._edges)

    def clear(self):
        with _MU:
            self._edges.clear()

    def find_cycles(self) -> List[List[str]]:
        """Simple cycles as node-name lists ``[a, b, ..., a]`` — one
        representative per distinct node set, DFS back-edge extraction
        (the graph has tens of nodes, recursion is fine)."""
        pairs = self.edge_pairs()
        adj: Dict[str, List[str]] = {}
        nodes: Set[str] = set()
        for a, b in pairs:
            adj.setdefault(a, []).append(b)
            nodes.add(a)
            nodes.add(b)
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in nodes}
        cycles: List[List[str]] = []
        seen: Set[frozenset] = set()
        path: List[str] = []

        def dfs(n):
            color[n] = GRAY
            path.append(n)
            for m in sorted(adj.get(n, ())):
                c = color.get(m, WHITE)
                if c == GRAY:
                    cyc = path[path.index(m):] + [m]
                    key = frozenset(cyc)
                    if key not in seen:
                        seen.add(key)
                        cycles.append(cyc)
                elif c == WHITE:
                    dfs(m)
            path.pop()
            color[n] = BLACK

        for n in sorted(nodes):
            if color[n] == WHITE:
                dfs(n)
        return cycles


_GRAPH = LockOrderGraph()


def graph() -> LockOrderGraph:
    """The process-global lock-order graph every audited lock feeds."""
    return _GRAPH


# ---------------------------------------------------------------------------
# scheduler hook (testing/sched.py installs itself here)
# ---------------------------------------------------------------------------

_SCHED = None


def set_scheduler(s) -> None:
    """Install/clear the live VirtualScheduler (testing/sched.py).
    While installed, audited-lock operations on threads the scheduler
    MANAGES become cooperative yield points; every other thread keeps
    real blocking semantics."""
    global _SCHED
    _SCHED = s


def scheduler():
    return _SCHED


def _sched_for_current():
    s = _SCHED
    if s is not None and s.manages_current_thread():
        return s
    return None


# ---------------------------------------------------------------------------
# metrics (lazy; cached — registry.reset() zeroes in place)
# ---------------------------------------------------------------------------

_METRICS = None
_HELD_TOTAL = 0
_LONGEST = 0.0


def _metrics():
    global _METRICS
    if _METRICS is None:
        t = _telemetry()
        reg = t.registry()
        _METRICS = (reg.gauge(t.names.THREADS_HELD),
                    reg.gauge(t.names.THREADS_LONGEST_WAIT),
                    reg.histogram(t.names.THREADS_LOCK_WAIT),
                    reg.counter(t.names.THREADS_DUMPS))
    return _METRICS


def _set_held_gauge(total: int):
    try:
        _metrics()[0].set(total)
    except Exception:       # metrics must never break locking
        pass


def _note_wait(waited: float):
    """Live longest-wait gauge update while a waiter is still blocked —
    so a wedged process shows the stall before (or without) resolving."""
    global _LONGEST
    try:
        with _MU:
            if waited > _LONGEST:
                _LONGEST = waited
            longest = _LONGEST
        _metrics()[1].set(longest)
    except Exception:
        pass


def _observe_wait(name: str, waited: float):
    global _LONGEST
    try:
        with _MU:
            if waited > _LONGEST:
                _LONGEST = waited
            longest = _LONGEST
        _metrics()[2].observe(waited, label=name)
        _metrics()[1].set(longest)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# audited lock
# ---------------------------------------------------------------------------

#: live audited-lock instances, for dumps/diagnose
_LOCKS: "weakref.WeakSet" = weakref.WeakSet()

#: contended-acquire poll slice: bounds stall-detection latency without
#: adding wakeup latency (a timed raw acquire returns the moment the
#: lock frees)
_WAIT_SLICE = 0.05


class MxLock:
    """A named, audited Lock/RLock — drop-in for ``threading.Lock()`` /
    ``threading.RLock()`` with ordering audit, stall forensics and
    sched-harness yield points. See the module docstring."""

    def __init__(self, name: str, reentrant: bool = False, graph=None):
        self.name = name
        self._reentrant = bool(reentrant)
        # the raw primitive under audit — the one place a bare
        # constructor is the point
        if reentrant:
            self._raw = threading.RLock()  # mx-lint: allow=MXA009
        else:
            self._raw = threading.Lock()  # mx-lint: allow=MXA009
        self._graph = graph if graph is not None else _GRAPH
        self._owner = None          # thread ident while held
        self._owner_name = None
        self._owner_site = None
        self._waiters: Dict[int, tuple] = {}   # ident -> (name, t0)
        with _MU:
            _LOCKS.add(self)

    # -------------- acquire --------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        if self._reentrant:
            for e in held:
                if e.lock is self:
                    self._raw.acquire()
                    e.count += 1
                    return True
        site = _call_site()
        # record ordering edges BEFORE blocking: the would-be edge
        # matters most when the acquire is the one that deadlocks
        for e in held:
            if e.lock.name != self.name:
                self._graph.record(e.lock.name, self.name, e.site, site)
        s = _sched_for_current()
        if s is not None:
            ok = s.acquire_lock(self, blocking=blocking, timeout=timeout)
        else:
            ok = self._acquire_real(blocking, timeout)
        if ok:
            self._mark_acquired(site, held)
        return ok

    def _acquire_real(self, blocking: bool, timeout: float) -> bool:
        raw = self._raw
        if not blocking:
            return raw.acquire(False)
        if raw.acquire(False):
            return True
        # contended slow path: poll in slices so the stall detector and
        # the longest-wait gauge see the wait while it is happening
        t0 = time.perf_counter()
        deadline = None if timeout is None or timeout < 0 \
            else t0 + timeout
        me = threading.current_thread()
        with _MU:
            self._waiters[me.ident] = (me.name, t0)
        stall = stall_seconds()
        fired = False
        ok = False
        try:
            while True:
                slc = _WAIT_SLICE
                if deadline is not None:
                    rem = deadline - time.perf_counter()
                    if rem <= 0:
                        break
                    slc = min(slc, rem)
                if raw.acquire(timeout=slc):
                    ok = True
                    break
                waited = time.perf_counter() - t0
                _note_wait(waited)
                if stall > 0 and waited >= stall and not fired:
                    fired = True
                    self._report_stall(me, waited)
        finally:
            with _MU:
                self._waiters.pop(me.ident, None)
            _observe_wait(self.name, time.perf_counter() - t0)
            if fired and ok:
                # the stall resolved — re-arm the episode channel so
                # the NEXT stall is a new episode
                try:
                    _telemetry().watchdog().episode("deadlock", False)
                except Exception:   # pragma: no cover - defensive
                    pass
        return ok

    def _mark_acquired(self, site, held):
        held.append(_Held(self, site))
        t = threading.current_thread()
        global _HELD_TOTAL
        with _MU:
            self._owner = t.ident
            self._owner_name = t.name
            self._owner_site = site
            _HELD_TOTAL += 1
            total = _HELD_TOTAL
        _set_held_gauge(total)

    def _report_stall(self, me, waited: float):
        """Exactly one ``deadlock`` anomaly + one atomic dump per
        episode: the watchdog's episode() transition gates both."""
        try:
            with _MU:
                owner = self._owner_name
                osite = self._owner_site
            if owner:
                own = f"held by {owner!r}"
                if osite:
                    own += f" (acquired at {osite[0]})"
            else:
                own = "owner unknown"
            msg = (f"thread {me.name!r} blocked {waited:.2f}s "
                   f"(> MXNET_LOCK_STALL_SEC={stall_seconds():g}) "
                   f"acquiring mx_lock {self.name!r}; {own}")
            fired = _telemetry().watchdog().episode(
                "deadlock", True, message=msg, value=waited)
            if fired:
                write_dump("lock-stall", stalled={
                    "lock": self.name, "thread": me.name,
                    "waited_s": round(waited, 3), "owner": owner,
                    "owner_site": list(osite or ())})
        except Exception:   # forensics must never kill the waiter
            _LOG.warning("deadlock forensics failed", exc_info=True)

    # -------------- release --------------
    def release(self):
        held = _held_stack()
        entry = None
        for e in reversed(held):
            if e.lock is self:
                entry = e
                break
        if entry is not None and entry.count > 1:
            entry.count -= 1
            self._raw.release()
            return
        if entry is not None:
            held.remove(entry)
        # entry may be None: threading.Lock permits cross-thread
        # release (the signal idiom); keep the books consistent anyway
        global _HELD_TOTAL
        with _MU:
            self._owner = self._owner_name = self._owner_site = None
            _HELD_TOTAL = max(0, _HELD_TOTAL - 1)
            total = _HELD_TOTAL
        self._raw.release()
        _set_held_gauge(total)
        s = _sched_for_current()
        if s is not None:
            s.yield_point()

    # -------------- condition support --------------
    def _suspend_for_wait(self):
        """Condition.wait fully releases the raw lock; mirror that in
        the audit books and hand back the held entry for restore."""
        held = _held_stack()
        entry = None
        for e in reversed(held):
            if e.lock is self:
                entry = e
                break
        if entry is not None:
            held.remove(entry)
            global _HELD_TOTAL
            with _MU:
                self._owner = self._owner_name = self._owner_site = None
                _HELD_TOTAL = max(0, _HELD_TOTAL - 1)
                total = _HELD_TOTAL
            _set_held_gauge(total)
        return entry

    def _resume_after_wait(self, entry):
        if entry is None:
            return
        _held_stack().append(entry)
        t = threading.current_thread()
        global _HELD_TOTAL
        with _MU:
            self._owner = t.ident
            self._owner_name = t.name
            self._owner_site = entry.site
            _HELD_TOTAL += 1
            total = _HELD_TOTAL
        _set_held_gauge(total)

    def _sched_release_for_wait(self):
        """Scheduler-path cond wait: fully release the raw lock (all
        reentrant counts) and return the saved entry."""
        entry = self._suspend_for_wait()
        for _ in range(entry.count if entry is not None else 1):
            self._raw.release()
        return entry

    def _sched_reacquire_after_wait(self, entry):
        self.acquire()      # routes back through the scheduler
        if entry is not None and entry.count > 1:
            for _ in range(entry.count - 1):
                self._raw.acquire()
            _held_stack()[-1].count = entry.count

    # -------------- sugar --------------
    def locked(self) -> bool:
        with _MU:
            return self._owner is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):     # pragma: no cover - debugging aid
        kind = "rlock" if self._reentrant else "lock"
        return f"<MxLock {self.name!r} ({kind}) owner={self._owner_name!r}>"


class MxCondition:
    """A named, audited ``threading.Condition`` — built on an
    :class:`MxLock` (reentrant by default, mirroring the stdlib) so
    enter/exit feed the ordering audit and wait/notify become
    sched-harness yield points."""

    def __init__(self, name: str, lock: Optional[MxLock] = None,
                 graph=None):
        self._lock = lock if lock is not None \
            else MxLock(name, reentrant=True, graph=graph)
        self.name = self._lock.name
        # wraps the audited raw primitive — not a second bare lock
        self._cond = threading.Condition(self._lock._raw)  # mx-lint: allow=MXA009

    # lock protocol delegates
    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        s = _sched_for_current()
        if s is not None:
            return s.cond_wait(self, timeout)
        entry = self._lock._suspend_for_wait()
        try:
            return self._cond.wait(timeout)
        finally:
            self._lock._resume_after_wait(entry)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait(None)
            result = predicate()
        return result

    def notify(self, n: int = 1):
        s = _SCHED
        if s is not None:
            s.cond_notify(self, n)
        self._cond.notify(n)

    def notify_all(self):
        s = _SCHED
        if s is not None:
            s.cond_notify(self, None)
        self._cond.notify_all()

    def __repr__(self):     # pragma: no cover - debugging aid
        return f"<MxCondition {self.name!r}>"


def mx_lock(name: str, graph=None) -> MxLock:
    """A named audited mutex (``threading.Lock`` semantics)."""
    return MxLock(name, reentrant=False, graph=graph)


def mx_rlock(name: str, graph=None) -> MxLock:
    """A named audited reentrant mutex (``threading.RLock`` semantics)."""
    return MxLock(name, reentrant=True, graph=graph)


def mx_condition(name: str, lock: Optional[MxLock] = None,
                 graph=None) -> MxCondition:
    """A named audited condition variable (``threading.Condition``)."""
    return MxCondition(name, lock=lock, graph=graph)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

@dataclass
class ThreadReport:
    """One audit snapshot: live locks, the ordering graph, its cycles
    and any findings (cycles and/or off-baseline edges)."""

    locks: List[dict]
    edges: List[dict]
    cycles: List[List[str]]
    findings: List[Finding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.cycles and not self.findings

    def __str__(self):
        lines = [f"ThreadReport: {len(self.locks)} lock name(s), "
                 f"{len(self.edges)} ordering edge(s), "
                 f"{len(self.cycles)} cycle(s)"]
        for f in self.findings:
            lines.append("  " + str(f))
        return "\n".join(lines)


def describe_locks() -> List[dict]:
    """Live audited locks aggregated by name (several instances may
    share a name — e.g. every ServingFuture's condition)."""
    with _MU:
        locks = list(_LOCKS)
    now = time.perf_counter()
    agg: Dict[str, dict] = {}
    for lk in locks:
        with _MU:
            owner = lk._owner_name
            osite = lk._owner_site
            waiters = list(lk._waiters.values())
        a = agg.setdefault(lk.name, {
            "name": lk.name,
            "kind": "rlock" if lk._reentrant else "lock",
            "instances": 0, "held": 0, "waiters": 0,
            "owner": None, "owner_site": [], "longest_wait_s": 0.0})
        a["instances"] += 1
        a["waiters"] += len(waiters)
        for _n, t0 in waiters:
            a["longest_wait_s"] = max(a["longest_wait_s"],
                                      round(now - t0, 3))
        if owner is not None:
            a["held"] += 1
            a["owner"] = owner
            a["owner_site"] = list(osite or ())
    return [agg[k] for k in sorted(agg)]


def _fmt_site(site) -> str:
    return site[0] if site else "?"


def cycle_findings(g: Optional[LockOrderGraph] = None) -> List[Finding]:
    """One Finding per lock-order cycle, naming each hop's thread and
    both call sites — the 'two stacks printed' contract."""
    g = g if g is not None else _GRAPH
    emap = {(e["from"], e["to"]): e for e in g.edges()}
    out = []
    for cyc in g.find_cycles():
        hops = []
        for a, b in zip(cyc, cyc[1:]):
            e = emap.get((a, b), {})
            hops.append(
                f"{a}->{b} [thread {e.get('thread', '?')}: holds {a} "
                f"from {_fmt_site(e.get('from_site'))}, acquires {b} "
                f"at {_fmt_site(e.get('to_site'))}]")
        out.append(Finding(
            checker="threads", rule="lock-cycle",
            message="potential deadlock, lock-order cycle: "
                    + "; ".join(hops),
            where="->".join(cyc), severity="error"))
    return out


def check_hierarchy(baseline: Set[Tuple[str, str]],
                    g: Optional[LockOrderGraph] = None) -> List[Finding]:
    """Findings for every observed edge outside the blessed baseline
    (with both acquisition stacks) plus every cycle. Empty list = the
    observed ordering is inside the checked-in hierarchy."""
    g = g if g is not None else _GRAPH
    out = cycle_findings(g)
    for e in g.edges():
        if (e["from"], e["to"]) in baseline:
            continue
        out.append(Finding(
            checker="threads", rule="lock-order",
            message=(f"new lock-order edge {e['from']} -> {e['to']} "
                     f"(x{e['count']}, thread {e['thread']}): held "
                     f"{e['from']} from [{' <- '.join(e['from_site']) or '?'}]"
                     f", acquired {e['to']} at "
                     f"[{' <- '.join(e['to_site']) or '?'}] — review, "
                     "then bless in tests/fixtures/torch_lock_hierarchy.json"),
            where=f"{e['from']}->{e['to']}", severity="error"))
    return out


def find_cycles() -> List[List[str]]:
    return _GRAPH.find_cycles()


def snapshot(baseline: Optional[Set[Tuple[str, str]]] = None
             ) -> ThreadReport:
    """The current audit state as a :class:`ThreadReport`; pass a
    baseline edge set to include hierarchy findings."""
    findings = check_hierarchy(baseline) if baseline is not None \
        else cycle_findings()
    return ThreadReport(locks=describe_locks(), edges=_GRAPH.edges(),
                        cycles=_GRAPH.find_cycles(), findings=findings)


def load_baseline(path: str) -> Set[Tuple[str, str]]:
    """``lock_hierarchy.json`` -> blessed edge-pair set."""
    with open(path) as f:
        data = json.load(f)
    return {(str(a), str(b)) for a, b in data["edges"]}


def save_baseline(path: str, g: Optional[LockOrderGraph] = None):
    """Refresh workflow: write the CURRENT graph as the blessed
    hierarchy (review the diff before committing)."""
    g = g if g is not None else _GRAPH
    pairs = sorted(g.edge_pairs())
    payload = {"schema": 1,
               "comment": "blessed lock-order hierarchy; refresh via "
                          "analysis.threads.save_baseline after "
                          "reviewing new edges",
               "edges": [list(p) for p in pairs]}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")


# ---------------------------------------------------------------------------
# queue census (dump enrichment)
# ---------------------------------------------------------------------------

_QUEUES: Dict[str, "weakref.ref"] = {}


def register_queue(name: str, q) -> None:
    """Register a queue for the forensics dump's depth census (weakly
    held; dead entries are pruned at dump time)."""
    with _MU:
        _QUEUES[name] = weakref.ref(q)


def _queue_depths() -> List[dict]:
    with _MU:
        items = list(_QUEUES.items())
    out = []
    for name, ref in sorted(items):
        q = ref()
        if q is None:
            with _MU:
                if _QUEUES.get(name) is ref:
                    del _QUEUES[name]
            continue
        try:
            out.append({"name": name, "depth": q.qsize(),
                        "maxsize": getattr(q, "maxsize", None)})
        except Exception:       # pragma: no cover - exotic queues
            pass
    return out


# ---------------------------------------------------------------------------
# forensics dump
# ---------------------------------------------------------------------------

def dump_payload(reason: str, stalled: Optional[dict] = None) -> dict:
    """The ranked dump: stalled thread first, then lock owners, then
    the rest — per-thread stacks via sys._current_frames."""
    locks = describe_locks()
    owner_names = {l["owner"] for l in locks if l["owner"]}
    stalled_name = (stalled or {}).get("thread")
    frames = sys._current_frames()

    def rank(t):
        if t.name == stalled_name:
            return 0
        if t.name in owner_names:
            return 1
        return 2

    threads_out = []
    for t in sorted(threading.enumerate(), key=lambda t: (rank(t), t.name)):
        fr = frames.get(t.ident)
        stack = traceback.format_stack(fr) if fr is not None else []
        threads_out.append({
            "name": t.name, "ident": t.ident, "daemon": t.daemon,
            "rank": rank(t),
            "stack": [ln.strip().replace("\n", " | ")
                      for ln in stack][-12:]})
    return {"schema": 1, "kind": "deadlock", "reason": reason,
            "time_unix": time.time(), "pid": os.getpid(),
            "stalled": stalled,
            "locks": locks,
            "edges": _GRAPH.edges(),
            "threads": threads_out,
            "queues": _queue_depths()}


def write_dump(reason: str, stalled: Optional[dict] = None
               ) -> Optional[str]:
    """Atomically (tmp + fsync + rename) write one forensics dump to
    ``MXNET_THREADS_DUMP_DIR``; returns the path (None when unset)."""
    d = dump_dir()
    if d is None:
        return None
    payload = dump_payload(reason, stalled)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(
        d, f"mx-threads-{os.getpid()}-{int(time.time() * 1e3)}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        _metrics()[3].inc()
    except Exception:           # pragma: no cover - defensive
        pass
    _LOG.warning("mx-threads dump written: %s", path)
    return path


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def reset():
    """Clear audit HISTORY (ordering edges, longest-wait, queue
    census). Live lock state (owners, held counts) is reality, not
    history — it stays."""
    global _LONGEST
    _GRAPH.clear()
    with _MU:
        _LONGEST = 0.0
        _QUEUES.clear()
