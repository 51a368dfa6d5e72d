"""Deterministic-schedule harness: seeded, replayable thread interleavings
(counterpart of ``mxnet_tpu/testing/sched.py``, pure Python: the same
seed gives the same interleaving in both packages).

Wall-clock threaded tests prove a race exists roughly never and prove
its absence exactly never. This harness makes small-schedule exhaustion
possible instead: real OS threads run the REAL code under test, but a
:class:`VirtualScheduler` holds them all parked except one, choosing
which runs next from a seeded RNG at every yield point. The same seed
replays the same interleaving; 64+ seeds sweep the schedule space.

Yield points come from the audited primitives in
``analysis/threads.py``: while a scheduler is installed
(``threads.set_scheduler``), every ``mx_lock`` acquire/release and
``MxCondition`` wait/notify on a thread the scheduler MANAGES parks the
thread and hands control back. Unmanaged threads (pytest's main thread,
real daemons) keep real blocking semantics. :class:`SchedQueue` extends
the yield points to queue get/put, and :meth:`VirtualScheduler.checkpoint`
marks explicit schedule points in test bodies.

Blocking under the scheduler is VIRTUAL: a managed thread never really
blocks on a lock/condition/queue — it parks with a ``blocked`` note and
only becomes runnable again when the resource frees (owner released,
notify arrived, queue non-empty). If every live task is blocked the
harness raises :class:`SchedDeadlock` naming each task's obstacle — a
real deadlock caught in microseconds instead of a hung CI job. Timed
waits are modeled as "the timeout may expire whenever the scheduler
says so": a timed cond/lock/queue wait is always schedulable and
returns its timeout outcome if the resource is still unavailable.

Typical shape::

    def body_a(): ...            # real code under test
    def body_b(): ...
    for seed in range(64):
        s = VirtualScheduler(seed=seed)
        s.spawn("a", body_a)
        s.spawn("b", body_b)
        s.run()                  # replays one interleaving; reraises
        assert invariant_holds() # task exceptions with the trace
"""
from __future__ import annotations

import functools
import queue
import random
import threading
from typing import Callable, List, Optional

from ..analysis import threads as _threads

__all__ = ["VirtualScheduler", "SchedError", "SchedDeadlock",
           "SchedQueue", "explore"]

#: real-time guard on every park/handoff — only trips when the code
#: under test escapes the harness (blocks outside an audited primitive)
_HANDOFF_TIMEOUT = 30.0


class SchedError(RuntimeError):
    """Harness failure: step bound exceeded, task escaped, misuse."""


class SchedDeadlock(SchedError):
    """Every live task is blocked — an actual deadlock in the schedule."""


class _SchedAbort(BaseException):
    """Raised inside straggler tasks on the failure path so their
    ``with lock:`` frames unwind (releasing the raw locks) instead of
    retrying real blocking acquires and wedging until the join
    timeout. BaseException so test-body ``except Exception`` handlers
    cannot swallow it."""


class _Task:
    __slots__ = ("name", "fn", "go", "parked", "finished", "exc",
                 "blocked", "notified", "timed", "thread")

    def __init__(self, name: str, fn: Callable[[], None]):
        self.name = name
        self.fn = fn
        self.go = threading.Event()
        self.parked = threading.Event()
        self.finished = False
        self.exc: Optional[BaseException] = None
        #: None | ("lock", MxLock) | ("cond", MxCondition)
        #: | ("queue", SchedQueue, "get"/"put")
        self.blocked = None
        self.notified = False
        self.timed = False
        self.thread: Optional[threading.Thread] = None


class VirtualScheduler:
    """One seeded interleaving over a set of spawned task bodies.

    Exactly one managed thread runs at any moment; control transfers
    through Event handshakes at every audited-primitive yield point, so
    the scheduler observes a QUIESCENT system (all tasks parked) at
    each scheduling decision — task state reads race-free by
    construction."""

    def __init__(self, seed: int = 0, max_steps: int = 50000,
                 name: str = "sched"):
        self.seed = seed
        self.rng = random.Random(seed)
        self.max_steps = max_steps
        self.name = name
        self.tasks: List[_Task] = []
        self._by_ident = {}
        self.trace: List[str] = []
        self.steps = 0
        self._started = False
        self._aborting = False

    # ------------- setup -------------
    def spawn(self, name: str, fn: Callable, *args, **kwargs) -> _Task:
        if self._started:
            raise SchedError("spawn() after run()")
        if args or kwargs:
            fn = functools.partial(fn, *args, **kwargs)
        t = _Task(name, fn)
        self.tasks.append(t)
        return t

    def manages_current_thread(self) -> bool:
        return threading.get_ident() in self._by_ident

    # ------------- task side (runs on managed threads) -------------
    def _current(self) -> _Task:
        return self._by_ident[threading.get_ident()]

    def _park(self, task: _Task, blocked=None):
        task.blocked = blocked
        task.parked.set()
        task.go.wait()
        task.go.clear()
        task.blocked = None
        if self._aborting:
            raise _SchedAbort()

    def yield_point(self):
        """Hand control back to the scheduler (threads.py calls this
        after every audited release)."""
        self._park(self._current())

    #: explicit schedule point for test bodies
    checkpoint = yield_point

    def acquire_lock(self, lk, blocking: bool = True,
                     timeout: float = -1) -> bool:
        task = self._current()
        self._park(task)                # pre-acquire schedule point
        timed = timeout is not None and timeout >= 0
        while True:
            if lk._raw.acquire(False):
                return True
            if not blocking:
                return False
            if timed:
                # virtual expiry: one more schedule round, then the
                # timeout "fires" if the lock is still held
                self._park(task)
                if lk._raw.acquire(False):
                    return True
                return False
            self._park(task, blocked=("lock", lk))

    def cond_wait(self, cond, timeout: Optional[float] = None) -> bool:
        task = self._current()
        entry = cond._lock._sched_release_for_wait()
        task.notified = False
        task.timed = timeout is not None
        self._park(task, blocked=("cond", cond))
        got = task.notified
        task.notified = False
        task.timed = False
        cond._lock._sched_reacquire_after_wait(entry)
        return got

    def cond_notify(self, cond, n: Optional[int] = 1):
        """Mark up to ``n`` (None = all) virtual waiters on ``cond``
        notified-and-runnable. Safe from managed AND unmanaged threads:
        waiters are parked, so their ``blocked`` notes are stable."""
        waiters = [t for t in self.tasks
                   if t.blocked is not None and t.blocked[0] == "cond"
                   and t.blocked[1] is cond and not t.notified]
        if n is None:
            n = len(waiters)
        for t in waiters[:n]:
            t.notified = True

    # ------------- scheduler side -------------
    def _runnable(self, t: _Task) -> bool:
        b = t.blocked
        if b is None:
            return True
        kind = b[0]
        if kind == "lock":
            return b[1]._owner is None
        if kind == "cond":
            return t.notified or t.timed
        if kind == "queue":
            q, op = b[1], b[2]
            if op == "get":
                return q.qsize() > 0
            return q.maxsize <= 0 or q.qsize() < q.maxsize
        return True         # pragma: no cover - unknown kinds run

    def _deadlock_message(self, live: List[_Task]) -> str:
        bits = []
        for t in live:
            b = t.blocked
            if b is None:
                desc = "runnable?"      # pragma: no cover
            elif b[0] == "lock":
                lk = b[1]
                desc = (f"blocked on mx_lock {lk.name!r} "
                        f"(owner: {lk._owner_name!r})")
            elif b[0] == "cond":
                desc = f"waiting on condition {b[1].name!r} (no notify)"
            else:
                desc = f"blocked on queue {b[0:3]!r}"
            bits.append(f"{t.name}: {desc}")
        return (f"schedule deadlock (seed={self.seed}, "
                f"step={self.steps}): " + "; ".join(bits)
                + f"; trace tail={self.trace[-12:]}")

    def run(self) -> "VirtualScheduler":
        """Replay one interleaving to completion; reraises the first
        task exception. One-shot."""
        if self._started:
            raise SchedError("run() is one-shot; build a new scheduler")
        self._started = True
        if _threads.scheduler() is not None:
            raise SchedError("another VirtualScheduler is installed")
        _threads.set_scheduler(self)
        try:
            for task in self.tasks:
                th = threading.Thread(
                    target=self._bootstrap, args=(task,),
                    name=f"{self.name}:{task.name}", daemon=True)
                task.thread = th
                th.start()
                if not task.parked.wait(_HANDOFF_TIMEOUT):
                    raise SchedError(
                        f"task {task.name!r} failed to start")
            while True:
                live = [t for t in self.tasks if not t.finished]
                if not live:
                    break
                runnable = [t for t in live if self._runnable(t)]
                if not runnable:
                    raise SchedDeadlock(self._deadlock_message(live))
                t = self.rng.choice(runnable)
                self.steps += 1
                if self.steps > self.max_steps:
                    raise SchedError(
                        f"schedule exceeded {self.max_steps} steps "
                        f"(seed={self.seed}; livelock? trace tail="
                        f"{self.trace[-20:]})")
                self.trace.append(t.name)
                t.parked.clear()
                t.go.set()
                if not t.parked.wait(_HANDOFF_TIMEOUT):
                    raise SchedError(
                        f"task {t.name!r} did not yield within "
                        f"{_HANDOFF_TIMEOUT}s (seed={self.seed}) — "
                        "blocked outside an audited primitive?")
        finally:
            _threads.set_scheduler(None)
            self._release_stragglers()
        for t in self.tasks:
            if t.exc is not None:
                raise AssertionError(
                    f"task {t.name!r} failed under seed {self.seed} "
                    f"(trace={self.trace}): "
                    f"{type(t.exc).__name__}: {t.exc}") from t.exc
        return self

    def _bootstrap(self, task: _Task):
        ident = threading.get_ident()
        self._by_ident[ident] = task
        self._park(task)        # born parked; first go runs the body
        try:
            task.fn()
        except BaseException as e:      # noqa: BLE001 - reraised in run()
            task.exc = e
        finally:
            task.finished = True
            self._by_ident.pop(ident, None)
            task.parked.set()

    def _release_stragglers(self):
        """Failure-path cleanup: un-park unfinished tasks with the
        abort flag set, so each raises :class:`_SchedAbort` at its
        park point and unwinds — releasing whatever raw locks its
        ``with`` frames hold, which in turn un-wedges its peers. The
        join timeout is only a backstop for a task blocked outside the
        harness (real blocking on an unaudited primitive — daemon
        threads, so the process still exits)."""
        self._aborting = True
        for t in self.tasks:
            if not t.finished:
                t.go.set()
        for t in self.tasks:
            if t.thread is not None:
                t.thread.join(timeout=1.0)


class SchedQueue(queue.Queue):
    """``queue.Queue`` whose blocking get/put are sched-aware yield
    points on managed threads (real semantics everywhere else). Timed
    operations expire virtually: if the queue cannot satisfy them at
    their schedule point, Empty/Full raises immediately."""

    def get(self, block: bool = True, timeout: Optional[float] = None):
        s = _threads.scheduler()
        if s is None or not s.manages_current_thread():
            return super().get(block, timeout)
        task = s._current()
        s._park(task)           # pre-op schedule point
        while True:
            try:
                return super().get(False)
            except queue.Empty:
                if not block or timeout is not None:
                    raise
                s._park(task, blocked=("queue", self, "get"))

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None):
        s = _threads.scheduler()
        if s is None or not s.manages_current_thread():
            return super().put(item, block, timeout)
        task = s._current()
        s._park(task)
        while True:
            try:
                return super().put(item, False)
            except queue.Full:
                if not block or timeout is not None:
                    raise
                s._park(task, blocked=("queue", self, "put"))


def explore(build: Callable[["VirtualScheduler"], Optional[Callable]],
            seeds: int = 64, base_seed: int = 0,
            name: str = "sched") -> int:
    """Sweep ``seeds`` interleavings: ``build(sched)`` spawns the tasks
    for one fresh scheduler and may return a post-run check callable
    (called with the completed scheduler). Failures name the seed and
    trace. Returns the number of schedules run."""
    for i in range(seeds):
        s = VirtualScheduler(seed=base_seed + i, name=f"{name}-{i}")
        check = build(s)
        s.run()
        if check is not None:
            check(s)
    return seeds
