"""Serving load generator (counterpart of ``mxnet_tpu/serving/loadgen.py``;
this port has the closed loop, exact percentiles and the streaming view).

:func:`run_closed_loop`: C concurrent clients, each issuing its next
request the moment the previous one completes. The report carries the
request count, errors, wall time, QPS and exact p50/p99 latency computed
from the raw per-request samples. :func:`streaming_summary` aggregates
decode streams' records (``DecodeStream.record()``) into TTFT/TPOT
percentiles, token throughput and the speculative-decode view. Numbers
are not rounded.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["run_closed_loop", "percentiles", "streaming_summary"]


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
