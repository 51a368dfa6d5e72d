"""Serving load generator (counterpart of ``mxnet_tpu/serving/loadgen.py``;
this slice ports the closed loop and exact percentiles).

:func:`run_closed_loop`: C concurrent clients, each issuing its next
request the moment the previous one completes. The report carries the
request count, errors, wall time, QPS and exact p50/p99 latency computed
from the raw per-request samples.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np

__all__ = ["run_closed_loop", "percentiles"]


def percentiles(latencies) -> dict:
    """{p50_ms, p99_ms, mean_ms} from raw per-request seconds."""
    if not len(latencies):
        return {"p50_ms": None, "p99_ms": None, "mean_ms": None}
    a = np.asarray(latencies, dtype="float64") * 1e3
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean())}


def run_closed_loop(issue: Callable[[int], object], concurrency: int,
                    requests: int) -> dict:
    """``concurrency`` threads call ``issue(i)`` (submit AND wait for one
    request) back to back until ``requests`` have been issued. Latency is
    the wall time of each successful ``issue``; one that raises counts
    as an error, and the first error is kept in the report."""
    lock = threading.Lock()
    counter = [0]
    ok_lat: list = []
    errors: list = []

    def worker():
        while True:
            with lock:
                i = counter[0]
                if i >= requests:
                    return
                counter[0] += 1
            t0 = time.perf_counter()
            try:
                issue(i)
            except Exception as e:   # noqa: BLE001 - counted, reported
                with lock:
                    errors.append(e)
                continue
            dt = time.perf_counter() - t0
            with lock:
                ok_lat.append(dt)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, concurrency))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    out = {"mode": "closed", "concurrency": int(concurrency),
           "requests": len(ok_lat), "issued": len(ok_lat) + len(errors),
           "errors": len(errors),
           "first_error": repr(errors[0]) if errors else None,
           "wall_s": wall,
           "qps": (len(ok_lat) + len(errors)) / wall if wall > 0 else None}
    out.update(percentiles(ok_lat))
    return out
