"""One captured program per input signature (the counterpart of the JAX
package's AOT-compiled bucket executables and its compiled train-step
programs).

A :class:`CapturedProgram` is the whole work of one signature: its
static input buffers on the device, the body that reads them, and on a
CUDA device one ``torch.cuda.CUDAGraph`` of that body, replayed for
every later call. On the CPU the same body runs eagerly over the same
static buffers. :class:`Programs` keeps one owner's programs (a
predictor's, a decode engine's or a compiled train step's) by
signature, all in one memory pool, and counts its captures. Every
capture of a process runs on one side stream a device, one at a time.

How a capture goes, and the traps it avoids:

- The body first runs eagerly on the side stream (``WARMUP_RUNS``
  times): cuBLAS creates its handle and workspace for that stream, the
  kernel library is loaded, the allocator has its blocks. The stream is
  shared because cuBLAS keeps a workspace for every stream it has seen
  as long as the process lives. A body that changes state (a train
  step updates weights) is warmed up inside its owner's ``scope``,
  which leaves that state as it was (a train step skips its update
  there) and names the random generators the body drew from, put back
  before the capture, so the capture registers them.
- The capture uses ``capture_error_mode="thread_local"``: other threads
  (a batcher's clients reading results with ``.cpu()``) go on with their
  CUDA work while a first-seen signature is captured. A backward inside
  the body runs on autograd's worker thread, on the capture's stream.
- The cyclic garbage collector is off during a capture: collecting an
  unreachable program there would destroy its graph, a call a capture
  does not permit, and the capture would fail.
- ``torch.cuda.graph`` synchronizes the device when it starts a capture,
  so an owner captures its known signatures before traffic (``warmup``)
  and a step loop that must make no host sync captures nothing.
- A replay overwrites the static outputs. :meth:`CapturedProgram.run`
  returns copies made in stream order right after the replay, so a
  result read after later replays (a dispatch window, a batcher's lazy
  slices) is still its own.
- The graph reads the tensors it was captured against where they were
  at capture. A program whose owner's tensors moved since
  (``amp.convert_hybrid_block`` after warm-up, which gives the same
  parameters new storage; optimizer states loaded as new tensors) is
  captured again; values copied in place (``load_jax_params``) need no
  capture.
- Kernel launches during a capture are recorded, not counted
  (``ops.kernels.record_launches``, every thread's on the capture's
  stream), and each replay counts them once.
- A body holds what it reads (the net, state tensors, static views),
  never its owner: a program would otherwise keep its owner alive in a
  reference cycle, holding its graph pool until the cyclic collector
  ran. An owner dropped is freed at once, and :class:`Programs` runs
  :meth:`Programs.clear` (the device synchronized first) as it goes.
- A capture that fails never reaches the end that takes the random
  generators it registered (the device's default one, and the ones the
  warm-up named) out of capture mode; the next eager draw from them
  would raise. One empty capture that registers the same generators and
  ends normally takes them out (:func:`_end_generator_capture`).

On a CUDA device a capture or replay that fails raises ``MXNetError``;
nothing runs the body eagerly on the card instead.

Each capture on a card records what it holds of the caching allocator as
a ``telemetry.MemoryReport`` (:attr:`CapturedProgram.memory`: its static
inputs, its static outputs, and the segments of the graph pool beyond
those outputs, read from ``torch.cuda.memory_snapshot()`` by the pool's
id; the pool is the owner's, shared by its programs), filed for the OOM
forensics; an allocation failure of a capture or a replay gets its
post-mortem (``telemetry.memory.maybe_record_oom``).
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import telemetry as _telemetry
from .base import MXNetError
from .engine import allow_sync
from .ops.kernels import add_launches, record_launches

__all__ = ["CapturedProgram", "Programs", "map_tensors", "WARMUP_RUNS"]

#: eager runs of a body on the capture stream before its capture
WARMUP_RUNS = 2

_CAPTURE_MU = threading.Lock()
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device):
    """The one capture stream of ``device`` (made at first use)."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _no_scope():
    """The warm-up scope of a body that changes no state: no
    generators to register."""
    return contextlib.nullcontext(())


def _end_generator_capture(device, generators) -> None:
    """Take ``generators`` and the device's default generator out of
    the capture mode a failed capture left them in: one capture of a
    trivial body that registers them and ends normally (their state is
    theirs again; the graph is dropped)."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                          capture_error_mode="thread_local"):
        torch.zeros(1, device=device)
    del graph


def _pool_bytes(pool) -> int:
    """Bytes of the caching allocator's segments in graph pool ``pool``."""
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def map_tensors(fn, out):
    """Apply ``fn`` to every tensor of a nested tuple/list/dict output."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (tuple, list)):
        return type(out)(map_tensors(fn, o) for o in out)
    if isinstance(out, dict):
        return {k: map_tensors(fn, v) for k, v in out.items()}
    return out


class CapturedProgram:
    """``body(*inputs)`` over static ``inputs`` on ``device``: a CUDA graph
    of it on a card (captured at construction), the body itself on the
    CPU. ``ptrs`` are the owner's tensors' addresses it was built
    against. ``scope()`` wraps the warm-up runs: a context manager that
    yields the ``torch.Generator``s the body draws from (filled by the
    time it exits) and undoes the runs' effects on exit. ``debug`` keeps
    the graph's nodes past instantiation, for :meth:`graph_nodes`."""

    def __init__(self, what: str, body: Callable, inputs: Sequence,
                 device: torch.device, ptrs: Tuple[int, ...], pool=None,
                 scope: Optional[Callable] = None, debug: bool = False):
        self.what = what
        self.body = body
        self.inputs = tuple(inputs)
        self.device = device
        self.ptrs = ptrs
        self.graph = None
        self.outputs = None
        self.memory = None
        self.delta: Dict[tuple, int] = {}
        t0 = time.perf_counter()
        if device.type == "cuda":
            with _CAPTURE_MU:
                self._capture(pool, _capture_stream(device),
                              scope or _no_scope, debug)
        self.capture_s = time.perf_counter() - t0

    def _capture(self, pool, stream, scope, debug):
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        if debug:
            # the cudaGraph_t kept past instantiation, for debug_dump
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            graph.enable_debug_mode()
        else:
            graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        capturing = None
        try:
            with torch.cuda.stream(stream):
                with scope() as generators:
                    for _ in range(WARMUP_RUNS):
                        self.body(*self.inputs)
            for g in generators:
                graph.register_generator_state(g)
            gc.disable()
            capturing = generators
            with record_launches(stream) as delta, torch.cuda.graph(
                    graph, pool=pool, stream=stream,
                    capture_error_mode="thread_local"):
                out = self.body(*self.inputs)
        except Exception as e:
            _telemetry.memory.maybe_record_oom(e, f"capture of {self.what}")
            # a capture that fails to end leaves its stream current
            torch.cuda.set_stream(cur)
            if capturing is not None:
                del graph
                _end_generator_capture(self.device, capturing)
            if isinstance(e, MXNetError):
                raise
            raise MXNetError(f"capture of {self.what} failed: "
                             f"{type(e).__name__}: {e}") from e
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(stream)
        self.graph, self.outputs, self.delta = graph, out, delta
        mem = _telemetry.memory
        outs: list = []
        map_tensors(outs.append, out)
        out_bytes = sum(mem.device_bytes(t) for t in outs)
        self.memory = mem.MemoryReport(
            argument_bytes=sum(mem.device_bytes(t) for t in self.inputs),
            output_bytes=out_bytes,
            temp_bytes=max(0, _pool_bytes(graph.pool()) - out_bytes))
        mem.register_compiled_report(f"{self.what}@{id(self):x}",
                                     self.memory)

    def graph_nodes(self, path: str) -> Optional[Dict[str, int]]:
        """The captured graph's nodes by type (``KERNEL``, ``MEMCPY``,
        ``MEMSET``, ...), read from its ``debug_dump`` written to
        ``path`` (removed after); None where there is no graph (the
        CPU), ``{"error": ...}`` where the dump failed (a capture not
        made with ``debug``)."""
        import os
        import re
        if self.graph is None:
            return None
        try:
            self.graph.debug_dump(path)
            with open(path) as f:
                text = f.read()
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"[:200]}
        finally:
            if os.path.exists(path):
                os.remove(path)
        out: Dict[str, int] = {}
        for kind in re.findall(r'label="\{(\w+)', text):
            out[kind] = out.get(kind, 0) + 1
        return out

    def run(self):
        """Replay the graph (the card) or run the body over the static
        inputs (the CPU); returns copies of the outputs, made in stream
        order before anything else can overwrite them."""
        if self.graph is None:
            return map_tensors(torch.clone, self.body(*self.inputs))
        # the graph's card current, whichever thread replays it
        with torch.cuda.device(self.device) if self.device.type == "cuda" \
                else contextlib.nullcontext():
            try:
                self.graph.replay()
            except Exception as e:
                _telemetry.memory.maybe_record_oom(
                    e, f"replay of {self.what}")
                raise MXNetError(f"replay of {self.what} failed: "
                                 f"{type(e).__name__}: {e}") from e
            add_launches(self.delta)
            return map_tensors(torch.clone, self.outputs)


class Programs:
    """One owner's programs by signature, over ``owner``'s tensors: an
    ``nn.Module`` (its parameters and buffers, taken once, so a tensor
    replaced by another object after that is not seen) or a callable
    that returns the tensors to watch at each :meth:`get` (a train
    step's parameters and optimizer states). One memory pool on a card
    (replays run one after another on the caller's stream).
    :attr:`n_traces` counts the captures made with ``count=True``."""

    def __init__(self, owner, device):
        self.device = torch.device(device)
        if isinstance(owner, torch.nn.Module):
            tensors = tuple(itertools.chain(owner.parameters(),
                                            owner.buffers()))
            self._tensors = lambda: tensors
        else:
            self._tensors = owner
        self._progs: Dict = {}
        self.n_traces = 0
        self._mu = threading.RLock()
        self._pool = None
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()

    def __len__(self) -> int:
        return len(self._progs)

    def programs(self) -> list:
        """The programs captured now, in no particular order."""
        with self._mu:
            return list(self._progs.values())

    def ptrs(self) -> Tuple[int, ...]:
        """Where the owner's tensors live now."""
        return tuple(t.data_ptr() for t in self._tensors())

    def _drop(self, keys) -> None:
        # a replay still queued must not find its pool handed out again
        if keys and self.device.type == "cuda":
            with allow_sync():
                torch.cuda.synchronize(self.device)
        for k in keys:
            del self._progs[k]

    def drop(self, key) -> None:
        """Drop the program of signature ``key``, if there is one."""
        with self._mu:
            self._drop([key] if key in self._progs else [])

    def rekey(self, old, new) -> None:
        """File the program of signature ``old`` under ``new``."""
        with self._mu:
            if new in self._progs:
                self._drop([new])
            self._progs[new] = self._progs.pop(old)

    def clear(self) -> None:
        """Drop every program (their graphs and static buffers)."""
        with self._mu:
            self._drop(list(self._progs))

    def __del__(self):
        # dropped with its owner (a step, a predictor): the device is
        # synchronized before the graphs hand their pool back, as
        # :meth:`clear` does
        if getattr(self, "_progs", None):
            self.clear()

    def get(self, key, build: Callable[[], tuple], count: bool = True,
            what: str = "", scope: Optional[Callable] = None,
            debug: bool = False) -> CapturedProgram:
        """The program of signature ``key``. When there is none, or the
        owner's tensors moved since its capture, ``build()`` gives
        ``(body, inputs)`` and the program is captured anew (one more
        trace when ``count``), its warm-up inside ``scope``, its graph's
        nodes kept when ``debug`` (:class:`CapturedProgram`)."""
        with self._mu:
            ptrs = self.ptrs()
            prog = self._progs.get(key)
            if prog is not None:
                if prog.ptrs == ptrs:
                    return prog
                self._drop([key])
            body, inputs = build()
            prog = CapturedProgram(what or repr(key), body, inputs,
                                   self.device, ptrs, self._pool, scope,
                                   debug)
            self._progs[key] = prog
            if count:
                self.n_traces += 1
            return prog
