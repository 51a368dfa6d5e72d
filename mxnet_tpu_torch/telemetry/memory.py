"""Device-memory observability: allocator accounting, buffer census, OOM
forensics (the port's counterpart of ``mxnet_tpu/telemetry/memory.py``).

1. **Captured-program memory report** (:class:`MemoryReport`). The JAX
   package parses XLA's ``memory_analysis()`` of each compiled program.
   The port's counterpart is what each CUDA-graph capture holds of the
   caching allocator (``captured.CapturedProgram``): its static inputs
   (``argument_bytes``), its static outputs (``output_bytes``) and the
   bytes its private graph pool reserved beyond those outputs
   (``temp_bytes``: the intermediates a replay reuses). XLA's
   ``generated_code_bytes`` and ``donated_bytes`` have no counterpart (a
   graph updates its buffers in place and holds no code in device
   memory): they are reported absent (``None``), never invented.
   ``CompiledTrainStep.memory_report()`` merges a step's captures and
   publishes the ``mx_hbm_*`` gauges.

2. **Live-buffer census** (:class:`BufferCensus`): weakrefs to the
   framework's long-lived tensors by POOL — ``params``, ``optimizer``,
   ``checkpoint`` (host capture copies awaiting serialization),
   ``prefetch`` (staged input batches), ``kvcache`` (decode's page
   pools), ``ndarray`` (user-tracked handles). A tensor leaves its pool
   the moment it is collected; the census holds no strong reference, so
   it keeps no dropped step's graph pool alive. :func:`device_bytes` is
   the one accounting rule (``numel * element_size``: the bytes one card
   holds). ``reconcile()`` diffs the pools against the caching
   allocator's ``torch.cuda.memory_allocated`` per card: the bytes no
   pool claims are ``mx_mem_untracked_bytes`` (activations, graph pools,
   user tensors, the allocator's rounding to 512-byte blocks).

3. **Memory watchdog + budget**: per-device numbers from
   ``torch.cuda.memory_stats`` / ``mem_get_info`` (``source:
   "allocator"``); on the CPU, which has no allocator statistics, the
   documented fallback prices every live CPU tensor the garbage
   collector tracks (``source: "live_arrays"``, as the JAX package's
   XLA:CPU fallback prices ``jax.live_arrays()``; peak and limit stay
   None). ``MXNET_MEMORY_BUDGET`` arms a headroom check at each window
   retire that emits exactly ONE ``memory_budget`` anomaly per
   over-budget episode through the watchdog channel.

4. **OOM forensics**: ``torch.cuda.OutOfMemoryError`` (anywhere in the
   exception chain) caught at the dispatch seams writes one atomic
   ranked post-mortem JSON to ``MXNET_MEMORY_DUMP_DIR`` — the pools, the
   largest buffers, each capture's report, sizing hints — and emits
   exactly one ``oom`` anomaly per failure, however many seams the
   exception passes (the exception object is marked).

Nothing here synchronizes with the device: every number comes from
shapes, dtypes and the allocator's host-side counters.
"""
from __future__ import annotations

import gc
import json
import logging
import os
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as onp
import torch

from ..base import MXNetError
from . import names
from .registry import MetricsRegistry, default as _default_registry
from .watchdog import watchdog as _watchdog

__all__ = ["POOLS", "MemoryReport", "BufferCensus", "census",
           "device_bytes", "device_memory_stats", "memory_budget",
           "parse_budget", "maybe_check_budget", "dump_dir",
           "is_resource_exhausted", "maybe_record_oom", "oom_guard",
           "register_compiled_report", "compiled_reports"]

_LOG = logging.getLogger("mxnet_tpu_torch.telemetry")

#: the census pool taxonomy (the JAX package's); earlier pools win when
#: two pools reach the same physical buffer
POOLS = ("params", "optimizer", "checkpoint", "prefetch", "kvcache",
         "ndarray")

#: schema of the OOM post-mortem dump (the JAX package's)
DUMP_SCHEMA_VERSION = 1

#: buffers listed in dumps / top_buffers()
_TOP_N = 20


# ---------------------------------------------------------------------------
# byte accounting — the ONE helper every accounting path shares
# ---------------------------------------------------------------------------

def device_bytes(arr) -> int:
    """Bytes of one buffer on its card: ``numel * element_size`` of a
    tensor, ``nbytes`` of a numpy array (the port's buffers are whole on
    each card; a ZeRO shard is its own, smaller tensor). This is the one
    rule behind the census, ``CompiledTrainStep.optimizer_state_bytes()``
    and ``_ZeroShardPlan.state_bytes_per_replica()``."""
    if arr is None:
        return 0
    if isinstance(arr, torch.Tensor):
        return int(arr.numel()) * arr.element_size()
    if isinstance(arr, (onp.ndarray, onp.generic)):
        return int(arr.nbytes)
    nbytes = getattr(arr, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0


def _key(d):
    """One physical buffer: a tensor by its card and address (two tensor
    objects over one storage count once), anything else by identity."""
    if isinstance(d, torch.Tensor) and d.numel():
        return (str(d.device), d.data_ptr(), device_bytes(d))
    return ("id", id(d))


# ---------------------------------------------------------------------------
# captured-program memory report
# ---------------------------------------------------------------------------

class MemoryReport:
    """What one captured program holds of the allocator, in the JAX
    report's fields:

    - ``argument_bytes`` — its static input buffers;
    - ``output_bytes`` — its static output buffers;
    - ``temp_bytes`` — what its graph pool reserved beyond the outputs
      (the intermediates every replay reuses);
    - ``generated_code_bytes``, ``donated_bytes`` — absent (``None``): a
      CUDA graph keeps no code in device memory and donates nothing;
    - ``peak_bytes`` — the sum of the present fields, less the donated.
    """

    FIELDS = ("argument_bytes", "output_bytes", "temp_bytes",
              "generated_code_bytes", "donated_bytes")

    def __init__(self, argument_bytes: Optional[int] = 0,
                 output_bytes: Optional[int] = 0,
                 temp_bytes: Optional[int] = 0,
                 generated_code_bytes: Optional[int] = None,
                 donated_bytes: Optional[int] = None):
        for f, v in zip(self.FIELDS, (argument_bytes, output_bytes,
                                      temp_bytes, generated_code_bytes,
                                      donated_bytes)):
            setattr(self, f, None if v is None else int(v))

    @property
    def absent(self) -> List[str]:
        return [f for f in self.FIELDS if getattr(self, f) is None]

    @property
    def peak_bytes(self) -> int:
        get = lambda f: getattr(self, f) or 0          # noqa: E731
        return max(0, get("argument_bytes") + get("output_bytes")
                   + get("temp_bytes") + get("generated_code_bytes")
                   - get("donated_bytes"))

    @classmethod
    def merge(cls, reports: List["MemoryReport"]) -> "MemoryReport":
        """Field-wise max over captures (programs replay one at a time,
        so the headroom a mixed-shape run needs is the worst one's); a
        field absent from every report stays absent."""
        out = cls(0, 0, 0, None, None)
        for f in cls.FIELDS:
            vals = [getattr(r, f) for r in reports
                    if getattr(r, f) is not None]
            setattr(out, f, max(vals) if vals else None)
        return out

    def to_dict(self) -> dict:
        d = {f: getattr(self, f) for f in self.FIELDS}
        d["peak_bytes"] = self.peak_bytes
        d["absent"] = self.absent
        return d

    def __repr__(self):
        return (f"MemoryReport(peak={self.peak_bytes}, "
                f"args={self.argument_bytes}, out={self.output_bytes}, "
                f"temp={self.temp_bytes}, absent={self.absent})")


#: tag -> MemoryReport dict of recent captures (bounded), so an OOM dump
#: can name every program's footprint
_compiled_reports: "Dict[str, dict]" = {}
_compiled_lock = threading.Lock()
_COMPILED_CAP = 32


def register_compiled_report(tag: str, report: "MemoryReport"):
    """Record one captured program's memory report for OOM forensics."""
    with _compiled_lock:
        if tag in _compiled_reports:
            _compiled_reports.pop(tag)
        elif len(_compiled_reports) >= _COMPILED_CAP:
            _compiled_reports.pop(next(iter(_compiled_reports)))
        _compiled_reports[tag] = report.to_dict()


def compiled_reports() -> Dict[str, dict]:
    with _compiled_lock:
        return dict(_compiled_reports)


# ---------------------------------------------------------------------------
# live-buffer census
# ---------------------------------------------------------------------------

def _leaf_arrays(handle):
    """The raw buffers one registered handle owns: a checkpoint
    ``TrainState`` -> its host arrays; a tensor or array is itself."""
    arrays = getattr(handle, "arrays", None)
    if isinstance(arrays, dict):                 # checkpoint.TrainState
        return list(arrays.values())
    return [] if handle is None else [handle]


def _buffer_info(d, pool: str) -> dict:
    host = not isinstance(d, torch.Tensor) or d.device.type == "cpu"
    return {"pool": pool,
            "shape": list(getattr(d, "shape", ()) or ()),
            "dtype": str(getattr(d, "dtype", "?")).replace("torch.", ""),
            "bytes": device_bytes(d),
            "sharded": False,
            "host": host}


class BufferCensus:
    """Pool-tagged weakref registry of the framework's live buffers.

    ``register(pool, handle)`` files a weak reference to a tensor (a
    parameter, an optimizer state, a staged batch, a page pool), a numpy
    array or a checkpoint ``TrainState``. Reads walk the surviving
    weakrefs and price each physical buffer once — one reachable from two
    pools counts toward the earlier pool in :data:`POOLS`.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # id-keyed (NOT WeakSet: set membership would hash/== the
        # referents, and a tensor's elementwise __eq__ makes that raise)
        self._pools: Dict[str, "weakref.WeakValueDictionary"] = {
            p: weakref.WeakValueDictionary() for p in POOLS}

    def register(self, pool: str, handle) -> bool:
        """File ``handle`` under ``pool``; idempotent; returns False for
        handles that cannot be weak-referenced (a numpy array's view,
        plain tuples)."""
        if pool not in self._pools:
            raise MXNetError(
                f"unknown census pool {pool!r}; the taxonomy is {POOLS}")
        try:
            with self._lock:
                self._pools[pool][id(handle)] = handle
            return True
        except TypeError:
            return False

    def clear(self):
        """Drop every registration (test isolation)."""
        with self._lock:
            for s in self._pools.values():
                s.clear()

    # ---------------- accounting ----------------
    def _collect(self) -> Dict[str, Dict[tuple, tuple]]:
        """pool -> {buffer key: (buffer, info)}, deduped across pools by
        POOLS precedence (a buffer never counts twice)."""
        with self._lock:
            handles = {p: list(s.values()) for p, s in self._pools.items()}
        seen: set = set()
        out: Dict[str, Dict[tuple, tuple]] = {}
        for pool in POOLS:
            bufs: Dict[tuple, tuple] = {}
            for h in handles[pool]:
                for d in _leaf_arrays(h):
                    k = _key(d)
                    if k in seen:
                        continue
                    seen.add(k)
                    bufs[k] = (d, _buffer_info(d, pool))
            out[pool] = bufs
        return out

    def live_bytes_by_pool(self) -> Dict[str, int]:
        """Current bytes per pool (every pool present, 0 when empty)."""
        c = self._collect()
        return {p: sum(i["bytes"] for _, i in c[p].values()) for p in POOLS}

    def live_count_by_pool(self) -> Dict[str, int]:
        c = self._collect()
        return {p: len(c[p]) for p in POOLS}

    def device_bytes_by_pool(self, device) -> Dict[str, int]:
        """Bytes per pool of the buffers that live on ``device``."""
        dev = str(torch.device(device))
        c = self._collect()
        return {p: sum(i["bytes"] for d, i in c[p].values()
                       if isinstance(d, torch.Tensor)
                       and str(d.device) == dev) for p in POOLS}

    def buffers(self, pool: Optional[str] = None) -> List[dict]:
        """Live buffer infos (``{pool, shape, dtype, bytes, sharded,
        host}``), biggest first."""
        c = self._collect()
        pools = (pool,) if pool is not None else POOLS
        out = [i for p in pools for _, i in c.get(p, {}).values()]
        return sorted(out, key=lambda i: -i["bytes"])

    def top_buffers(self, n: int = _TOP_N) -> List[dict]:
        return self.buffers()[:n]

    # ---------------- reconciliation ----------------
    def reconcile(self) -> dict:
        """Diff the pools against the caching allocator: on each card the
        bytes ``torch.cuda.memory_allocated`` counts that no pool claims
        are untracked (activations, graph pools, user tensors and the
        allocator's rounding). The allocator cannot list its buffers, so
        ``untracked.count`` is None and ``untracked.top`` empty; on the
        CPU the untracked bytes are those of the live CPU tensors the
        garbage collector tracks that no pool claims."""
        c = self._collect()
        by_pool = {p: sum(i["bytes"] for _, i in c[p].values())
                   for p in POOLS}
        counts = {p: len(c[p]) for p in POOLS}
        untracked = 0
        per_device = {}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                dev = f"cuda:{i}"
                tracked = sum(info["bytes"] for bufs in c.values()
                              for d, info in bufs.values()
                              if isinstance(d, torch.Tensor)
                              and str(d.device) == dev)
                alloc = int(torch.cuda.memory_allocated(i))
                per_device[dev] = {"allocated": alloc, "tracked": tracked}
                untracked += max(0, alloc - tracked)
        else:
            tracked = {k for bufs in c.values() for k in bufs}
            for k, t in _live_cpu_tensors().items():
                if k not in tracked:
                    untracked += device_bytes(t)
        return {
            "by_pool": by_pool,
            "counts": counts,
            "devices": per_device,
            "untracked": {"count": None, "bytes": untracked, "top": []},
        }

    # ---------------- registry publication ----------------
    def publish(self, registry: Optional[MetricsRegistry] = None):
        """Refresh the ``mx_mem_pool_*`` / ``mx_mem_untracked_bytes``
        gauges from the current census (the pull-model collector
        exporters run before every export)."""
        reg = registry if registry is not None else _default_registry()
        rec = self.reconcile()
        g_bytes = reg.gauge(names.MEM_POOL_BYTES)
        g_count = reg.gauge(names.MEM_POOL_BUFFERS)
        for p in POOLS:
            g_bytes.set(rec["by_pool"][p], label=p)
            g_count.set(rec["counts"][p], label=p)
        reg.gauge(names.MEM_UNTRACKED_BYTES).set(
            rec["untracked"]["bytes"])
        return rec


_census = BufferCensus()


def census() -> BufferCensus:
    """The process-global buffer census (``telemetry.memory.census()``)."""
    return _census


def _collector(reg: MetricsRegistry):
    """Registry pull-model collector: census pools + device stats are
    refreshed before every snapshot/Prometheus export."""
    _census.publish(reg)
    device_memory_stats(registry=reg)
    b = memory_budget()
    if b is not None:
        reg.gauge(names.MEM_BUDGET_BYTES).set(b)


# ---------------------------------------------------------------------------
# device capacity + budget watchdog
# ---------------------------------------------------------------------------

def _live_cpu_tensors() -> Dict[tuple, torch.Tensor]:
    """Every live CPU tensor the garbage collector tracks, one a buffer
    (the CPU fallback's walk; the CPU has no allocator statistics)."""
    out = {}
    for o in gc.get_objects():
        # type(), not isinstance(): some tracked objects answer
        # ``__class__`` with a deprecation warning
        if issubclass(type(o), torch.Tensor) and not o.is_meta and \
                o.device.type == "cpu" and o.numel():
            try:
                out.setdefault(_key(o), o)
            except RuntimeError:     # a tensor without storage
                continue
    return out


def _cuda_stats(i: int) -> dict:
    s = torch.cuda.memory_stats(i)
    _, total = torch.cuda.mem_get_info(i)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "source": "allocator"}


def device_memory_stats(registry: Optional[MetricsRegistry] = None
                        ) -> Dict[str, dict]:
    """Per-device memory stats through the catalog (``mx_mem_device_*``
    gauges): on each card the caching allocator's bytes in use and its
    high-water mark, with the card's total memory as the limit
    (``source: "allocator"``). The CPU has no allocator statistics: the
    documented fallback prices every live CPU tensor
    (``source: "live_arrays"``; peak and limit stay None — live
    accounting has no high-water mark)."""
    reg = registry if registry is not None else _default_registry()
    out: Dict[str, dict] = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"cuda:{i}"] = _cuda_stats(i)
    else:
        out["cpu"] = {"bytes_in_use": sum(
            device_bytes(t) for t in _live_cpu_tensors().values()),
            "peak_bytes_in_use": None, "bytes_limit": None,
            "source": "live_arrays"}
    g_use = reg.gauge(names.MEM_DEVICE_IN_USE)
    g_peak = reg.gauge(names.MEM_DEVICE_PEAK)
    g_lim = reg.gauge(names.MEM_DEVICE_LIMIT)
    for k, s in out.items():
        g_use.set(s["bytes_in_use"] or 0, label=k)
        g_peak.set(-1 if s["peak_bytes_in_use"] is None
                   else s["peak_bytes_in_use"], label=k)
        g_lim.set(-1 if s["bytes_limit"] is None else s["bytes_limit"],
                  label=k)
    return out


_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_budget(value: str,
                 capacity: Optional[int] = None) -> Optional[int]:
    """Parse a ``MXNET_MEMORY_BUDGET`` value: plain bytes (``8589934592``),
    a K/M/G/T-suffixed size (``28g``, ``500MB``), or a strict fraction
    in (0, 1) of the device capacity (``0.9`` — only meaningful where the
    card reports its memory). Returns None for unset/unparsable."""
    v = (value or "").strip().lower()
    if not v:
        return None
    mult = 1
    if v.endswith("b"):
        v = v[:-1]
    if v and v[-1] in _SUFFIX:
        mult = _SUFFIX[v[-1]]
        v = v[:-1]
    try:
        f = float(v)
    except ValueError:
        return None
    if f <= 0:
        return None
    if mult == 1 and f < 1.0:
        return int(f * capacity) if capacity else None
    return int(f * mult)


def _device_capacity() -> Optional[int]:
    """The smallest card's total memory (None without a card)."""
    if not torch.cuda.is_available():
        return None
    return min(int(torch.cuda.mem_get_info(i)[1])
               for i in range(torch.cuda.device_count()))


def memory_budget() -> Optional[int]:
    """The configured headroom bound in bytes (``MXNET_MEMORY_BUDGET``),
    or None when unset."""
    raw = os.environ.get("MXNET_MEMORY_BUDGET")
    if not raw:
        return None
    return parse_budget(raw, capacity=_device_capacity())


def maybe_check_budget(step=None) -> Optional[dict]:
    """The retire-piggybacked headroom check (``engine.DispatchWindow``
    feeds this when telemetry is enabled): no-op when
    ``MXNET_MEMORY_BUDGET`` is unset. In-use bytes are the allocator's on
    the fullest card, else (the CPU) the census pools. Exceeding the
    budget emits exactly one ``memory_budget`` anomaly per episode via
    the watchdog channel; dropping back under re-arms."""
    budget = memory_budget()
    if budget is None:
        return None
    if torch.cuda.is_available():
        in_use = max(int(torch.cuda.memory_allocated(i))
                     for i in range(torch.cuda.device_count()))
        source = "allocator"
    else:
        in_use = sum(_census.live_bytes_by_pool().values())
        source = "census"
    over = in_use > budget
    reg = _default_registry()
    reg.gauge(names.MEM_BUDGET_BYTES).set(budget)
    top = ""
    if over:
        by_pool = _census.live_bytes_by_pool()
        if any(by_pool.values()):
            pool = max(by_pool, key=by_pool.get)
            top = f"; largest pool: {pool} ({by_pool[pool]} B)"
    _watchdog().episode(
        "memory_budget", over, step=step, value=in_use,
        message=(f"device memory {in_use} B exceeds the "
                 f"MXNET_MEMORY_BUDGET of {budget} B "
                 f"({source} accounting){top}") if over else "")
    return {"budget": budget, "in_use": in_use, "over": over,
            "source": source}


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

def dump_dir() -> Optional[str]:
    """``MXNET_MEMORY_DUMP_DIR`` (None = no post-mortem files; the
    ``oom`` anomaly event still fires)."""
    return os.environ.get("MXNET_MEMORY_DUMP_DIR") or None


_OOM_MARKERS = ("CUDA out of memory", "out of memory", "Out of memory",
                "RESOURCE_EXHAUSTED")


def _exc_chain(exc):
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def is_resource_exhausted(exc: BaseException) -> bool:
    """Whether ``exc`` (or anything in its cause chain) is an allocation
    failure: ``torch.cuda.OutOfMemoryError``, or an error whose message
    says the allocator ran out (an ``MXNetError`` a capture or replay
    wrapped one in)."""
    for e in _exc_chain(exc):
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
        msg = str(e)
        if any(m in msg for m in _OOM_MARKERS):
            return True
    return False


def _sizing_hints(by_pool: Dict[str, int], compiled: Dict[str, dict],
                  budget: Optional[int]) -> List[str]:
    """Actionable knobs ranked by what the census says dominates."""
    hints = []
    opt, params = by_pool.get("optimizer", 0), by_pool.get("params", 0)
    if opt and opt >= params / 2:
        hints.append(
            "optimizer state is fully replicated: enable the ZeRO-1 "
            "sharded update (compile_step on a dp mesh, zero_shard=True) "
            "for an ~N-per-replica reduction")
    if by_pool.get("prefetch", 0):
        hints.append(
            "staged input batches hold device memory: lower "
            "MXNET_DEVICE_PREFETCH and/or MXNET_INFLIGHT_STEPS to shrink "
            "the in-flight window")
    if by_pool.get("kvcache", 0):
        hints.append(
            "the decode KV cache's page pools hold device memory: lower "
            "MXNET_DECODE_PAGES or MXNET_DECODE_PAGE_SIZE")
    peak = max((r.get("peak_bytes", 0) for r in compiled.values()),
               default=0)
    temp = max((r.get("temp_bytes") or 0 for r in compiled.values()),
               default=0)
    if temp and temp >= peak / 2:
        hints.append(
            "the captured graphs' pools (activations/workspace) dominate "
            "the captured peak: reduce the batch size")
    if by_pool.get("checkpoint", 0):
        hints.append(
            "a checkpoint capture is in flight: stagger checkpoint_every "
            "away from peak-memory steps, or save with block=True")
    if budget is not None:
        hints.append(f"MXNET_MEMORY_BUDGET is {budget} B")
    if not hints:
        hints.append(
            "inspect top_buffers below; PYTORCH_CUDA_ALLOC_CONF bounds the "
            "caching allocator if the card is shared")
    return hints


def maybe_record_oom(exc: BaseException, seam: str,
                     step=None) -> Optional[str]:
    """OOM post-mortem: if ``exc`` is an allocation failure not already
    handled at an inner seam, emit exactly one ``oom`` anomaly and write
    one ranked dump file (atomic tmp+rename) to
    ``MXNET_MEMORY_DUMP_DIR``. Returns the dump path (None when no dump
    was written). Never raises — forensics must not mask the original
    error."""
    try:
        if not is_resource_exhausted(exc):
            return None
        for e in _exc_chain(exc):
            if getattr(e, "_mx_oom_handled", False):
                return None
        try:
            exc._mx_oom_handled = True
        except Exception:        # pragma: no cover - frozen exc types
            pass
        rec = _census.reconcile()
        by_pool = rec["by_pool"]
        compiled = compiled_reports()
        budget = memory_budget()
        largest = max(by_pool, key=by_pool.get) \
            if any(by_pool.values()) else None
        dump = {
            "schema_version": DUMP_SCHEMA_VERSION,
            "time_unix": time.time(),
            "seam": seam,
            "step": step,
            "error": f"{type(exc).__name__}: {exc}",
            "budget_bytes": budget,
            "device_stats": device_memory_stats(),
            "live_bytes_by_pool": by_pool,
            "largest_pool": largest,
            "untracked": rec["untracked"],
            "top_buffers": _census.top_buffers(_TOP_N),
            "compiled": compiled,
            "hints": _sizing_hints(by_pool, compiled, budget),
        }
        path = None
        d = dump_dir()
        if d:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"mx_oom_{int(time.time())}_{os.getpid()}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dump, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _default_registry().counter(names.OOM_DUMPS).inc()
        _watchdog().report(
            "oom", step, value=None,
            message=f"allocation failure at {seam}"
                    + (f" (step {step})" if step is not None else "")
                    + (f"; largest pool: {largest}" if largest else "")
                    + (f"; post-mortem dump: {path}" if path else
                       "; set MXNET_MEMORY_DUMP_DIR for a ranked "
                       "post-mortem dump"))
        return path
    except Exception:            # pragma: no cover - defensive
        _LOG.warning("OOM forensics failed", exc_info=True)
        return None


@contextmanager
def oom_guard(seam: str, step=None):
    """Wrap a dispatch seam: an escaping allocation failure gets its
    post-mortem recorded (once, however nested the seams) and then
    propagates unchanged."""
    try:
        yield
    except BaseException as e:
        maybe_record_oom(e, seam, step=step)
        raise


# publish pools/device stats before every export (snapshot, Prometheus)
_default_registry().register_collector(_collector)
