"""Serving load generator (counterpart of ``mxnet_tpu/serving/loadgen.py``):
closed- and open-loop traffic with exact percentiles and an outcome
census.

- :func:`run_closed_loop`: C concurrent clients, each issuing its next
  request the moment the previous one completes (sustainable throughput
  at a fixed concurrency).
- :func:`run_open_loop`: Poisson arrivals at a target rate whatever the
  completions (the latency under uncoordinated traffic: a closed loop
  hides queueing by throttling itself).

Both record each request's terminal state (:data:`OUTCOMES`): ``ok``,
``rejected`` (a typed ``Overloaded`` at admission), ``deadline_missed``
(a typed ``DeadlineExceeded``, or a completion later than
``deadline_s``) or ``error``, and report goodput (ok/s) beside the raw
rate. p50/p99 are exact, from the ``ok`` requests' raw samples.
:func:`fleet_issue` / :func:`fleet_submit` adapt a ``FleetRouter`` (or a
list of submit callables) to the loops and carry ``fut.replica``, so a
report also holds a per-replica census under ``replicas``.
:func:`streaming_summary` aggregates decode streams' records
(``DecodeStream.record()``) into TTFT/TPOT percentiles, token throughput
and the speculative-decode view. Numbers are not rounded.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["run_closed_loop", "run_open_loop", "percentiles",
           "classify_outcome", "streaming_summary", "fleet_issue",
           "fleet_submit", "OUTCOMES"]

#: a request's terminal states
OUTCOMES = ("ok", "rejected", "deadline_missed", "error")


def classify_outcome(exc: BaseException) -> str:
    """A failure's terminal state: a typed ``Overloaded`` anywhere in the
    cause chain is ``rejected``, a ``DeadlineExceeded`` is
    ``deadline_missed``, anything else ``error``."""
    from .resilience import DeadlineExceeded, Overloaded
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, Overloaded):
            return "rejected"
        if isinstance(e, DeadlineExceeded):
            return "deadline_missed"
        e = e.__cause__ or e.__context__
    return "error"


def percentiles(latencies) -> dict:
    """{p50_ms, p99_ms, mean_ms} from raw per-request seconds."""
    if not len(latencies):
        return {"p50_ms": None, "p99_ms": None, "mean_ms": None}
    a = np.asarray(latencies, dtype="float64") * 1e3
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean())}


def streaming_summary(records, wall: Optional[float] = None) -> dict:
    """Token-level latency of decode streams: exact TTFT (time to first
    token) and TPOT (time per output token) percentiles, streamed tokens
    and tokens/s over ``wall``. A record is a dict with ``ttft_s``,
    ``tpot_s`` (inter-token gaps) and ``tokens``; records that carry the
    engine's per-step accounting (``step_tokens``, ``spec_drafted``,
    ``spec_accepted``) add ``acceptance_rate`` (accepted / proposed
    drafts) and ``tokens_per_step`` {mean, p50, p99, max}."""
    records = [r for r in records if isinstance(r, dict)]
    ttfts = [r["ttft_s"] for r in records if r.get("ttft_s") is not None]
    tpots = [g for r in records for g in (r.get("tpot_s") or ())]
    tokens = sum(int(r.get("tokens") or 0) for r in records)
    out = {}
    out.update({"ttft_" + k: v for k, v in percentiles(ttfts).items()})
    out.update({"tpot_" + k: v for k, v in percentiles(tpots).items()})
    out["stream_tokens"] = tokens
    out["tokens_per_sec"] = tokens / wall if wall and wall > 0 else None
    steps = [n for r in records for n in (r.get("step_tokens") or ())]
    if steps:
        drafted = sum(int(r.get("spec_drafted") or 0) for r in records)
        accepted = sum(int(r.get("spec_accepted") or 0) for r in records)
        a = np.asarray(steps, dtype="float64")
        out["acceptance_rate"] = accepted / drafted if drafted else None
        out["tokens_per_step"] = {"mean": float(a.mean()),
                                  "p50": float(np.percentile(a, 50)),
                                  "p99": float(np.percentile(a, 99)),
                                  "max": int(a.max())}
    return out


class _Census:
    """The terminal states, the ok latencies, streaming records and the
    per-replica census of one run (thread-safe)."""

    def __init__(self, deadline_s: Optional[float]):
        self.deadline_s = deadline_s
        self.outcomes = {k: 0 for k in OUTCOMES}
        self.ok_lat: list = []
        self.stream: list = []
        self.by_replica: dict = {}
        self.first_error: Optional[str] = None
        self.lock = threading.Lock()

    def _tally(self, replica, outcome: str, dt):
        self.outcomes[outcome] += 1
        if not replica:
            return
        rec = self.by_replica.setdefault(replica, {
            "outcomes": {k: 0 for k in OUTCOMES}, "lat": []})
        rec["outcomes"][outcome] += 1
        if dt is not None:
            rec["lat"].append(dt)

    def failed(self, e: BaseException):
        with self.lock:
            oc = classify_outcome(e)
            if oc == "error" and self.first_error is None:
                self.first_error = repr(e)
            self._tally(getattr(e, "replica", None), oc, None)

    def done(self, ret, dt: float):
        with self.lock:
            rep = ret.get("replica") if isinstance(ret, dict) else None
            if isinstance(ret, dict) and "ttft_s" in ret:
                self.stream.append(ret)
            if self.deadline_s is not None and dt > self.deadline_s:
                self._tally(rep, "deadline_missed", None)
            else:
                self.ok_lat.append(dt)
                self._tally(rep, "ok", dt)

    def report(self, mode: str, wall: float, extra: dict) -> dict:
        oc = self.outcomes
        total = sum(oc.values())
        done = oc["ok"] + oc["deadline_missed"] + oc["error"]
        out = dict(extra)
        out.update({
            "mode": mode, "requests": oc["ok"], "issued": total,
            "errors": oc["error"], "first_error": self.first_error,
            "outcomes": dict(oc), "wall_s": wall,
            "qps": done / wall if wall > 0 else None,
            "goodput_qps": oc["ok"] / wall if wall > 0 else None,
            "reject_rate": oc["rejected"] / total if total else None,
            "deadline_miss_rate": oc["deadline_missed"] / total
            if total else None})
        out.update(percentiles(self.ok_lat))
        if self.by_replica:
            reps = {}
            for name in sorted(self.by_replica):
                rec = self.by_replica[name]
                roc = rec["outcomes"]
                rdone = roc["ok"] + roc["deadline_missed"] + roc["error"]
                r = {"qps": rdone / wall if wall > 0 else None,
                     "goodput_qps": roc["ok"] / wall if wall > 0 else None,
                     "outcomes": dict(roc)}
                r.update(percentiles(rec["lat"]))
                reps[name] = r
            out["replicas"] = reps
        recs = [r for r in self.stream if "ttft_s" in r]
        if recs:
            out.update(streaming_summary(recs, wall))
        return out


def _submit_of(target) -> Callable:
    """One submit callable from a fleet target: a router (anything with
    ``.submit``) routes every request; a LIST of submit callables (one a
    replica) is taken round robin by request index."""
    if callable(getattr(target, "submit", None)):
        return lambda i, *args, **kw: target.submit(*args, **kw)
    fns = list(target)
    if not fns or not all(callable(f) for f in fns):
        raise TypeError("fleet target must be a router (with .submit) or "
                        "a non-empty list of submit callables")
    return lambda i, *args, **kw: fns[i % len(fns)](*args, **kw)


def _attributed_wait(fut, timeout):
    """``fut.result`` with the replica carried through both outcomes:
    a failure gets ``e.replica``, a success returns ``{"replica": ...}``
    for the census."""
    try:
        fut.result(timeout)
    except BaseException as e:
        rep = getattr(fut, "replica", None)
        if rep is not None:
            try:
                e.replica = rep
            except Exception:    # pragma: no cover - exotic exception
                pass
        raise
    return {"replica": getattr(fut, "replica", None)}


def fleet_issue(target, make_args: Callable[[int], tuple],
                deadline_ms: Optional[float] = None,
                timeout: Optional[float] = 30.0) -> Callable:
    """:func:`run_closed_loop`'s ``issue(i)`` over a fleet target: submit
    ``make_args(i)``, wait for the result, return the per-replica
    record."""
    submit = _submit_of(target)

    def issue(i: int):
        fut = submit(i, *make_args(i), deadline_ms=deadline_ms)
        return _attributed_wait(fut, timeout)
    return issue


def fleet_submit(target, make_args: Callable[[int], tuple],
                 deadline_ms: Optional[float] = None) -> Callable:
    """:func:`run_open_loop`'s ``submit(i)`` over a fleet target: enqueue
    without waiting and return the wait callable."""
    submit = _submit_of(target)

    def submit_one(i: int):
        fut = submit(i, *make_args(i), deadline_ms=deadline_ms)
        return lambda timeout=None: _attributed_wait(fut, timeout)
    return submit_one


def run_closed_loop(issue: Callable[[int], object], concurrency: int,
                    requests: int,
                    deadline_s: Optional[float] = None) -> dict:
    """``concurrency`` threads call ``issue(i)`` (submit AND wait for one
    request) back to back until ``requests`` have been issued. Latency
    is the wall time of each ``issue``; with ``deadline_s`` a slower
    completion counts as ``deadline_missed``. An ``issue`` that returns a
    streaming record adds TTFT/TPOT; one that returns or raises with a
    ``replica`` adds the per-replica census."""
    census = _Census(deadline_s)
    lock = threading.Lock()
    counter = [0]

    def worker():
        while True:
            with lock:
                i = counter[0]
                if i >= requests:
                    return
                counter[0] += 1
            t0 = time.perf_counter()
            try:
                ret = issue(i)
            except Exception as e:   # noqa: BLE001 - counted, reported
                census.failed(e)
                continue
            census.done(ret, time.perf_counter() - t0)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, concurrency))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return census.report("closed", wall, {"concurrency": int(concurrency)})


def run_open_loop(submit: Callable[[int], Callable], rate_qps: float,
                  requests: int, seed: int = 0,
                  timeout: Optional[float] = 120.0,
                  deadline_s: Optional[float] = None) -> dict:
    """Poisson arrivals at ``rate_qps``: ``submit(i)`` enqueues request
    ``i`` WITHOUT waiting and returns a wait callable (taking a timeout,
    e.g. a future's ``result``). Arrival gaps are drawn from ``seed``.
    Latency runs from the scheduled arrival to completion, queueing
    included. A ``submit`` that raises (shed at admission) is that
    request's terminal state; the arrival clock keeps going. Every wait
    is bounded by ``timeout``: a request that does not complete in time
    counts as an ``error``, never a hang."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / max(rate_qps, 1e-9), size=requests)
    census = _Census(deadline_s)
    # waiters record each completion as it happens, so an early request
    # is not charged the rest of the arrival phase
    work: "_queue.Queue" = _queue.Queue()

    def waiter():
        while True:
            item = work.get()
            if item is None:
                return
            t0, wait = item
            try:
                try:
                    ret = wait() if timeout is None else wait(timeout)
                except TypeError:
                    ret = wait()
            except Exception as e:   # noqa: BLE001 - counted, reported
                census.failed(e)
                continue
            census.done(ret, time.perf_counter() - t0)

    threads = [threading.Thread(target=waiter, daemon=True)
               for _ in range(min(32, max(4, requests // 8)))]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    next_t = t_start
    for i in range(requests):
        now = time.perf_counter()
        if next_t > now:
            time.sleep(next_t - now)
        t0 = time.perf_counter()
        try:
            waitfn = submit(i)
        except Exception as e:       # noqa: BLE001 - shed at admission
            census.failed(e)
        else:
            work.put((t0, waitfn))
        next_t += gaps[i]
    for _ in threads:
        work.put(None)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    return census.report("open", wall, {"rate_qps": float(rate_qps)})
