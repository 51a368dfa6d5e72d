"""Bucketed inference (counterpart of ``mxnet_tpu/serving/predictor.py``).

``CompiledPredictor`` runs a whole forward pass per call, on one device,
in ``eval()`` mode under ``torch.inference_mode()``. The leading batch
dimension is quantised to ``bucket_sizes``: :meth:`bucket_for` and
:meth:`pad_to_bucket` pad a partial batch with zero rows up to the next
bucket, so concurrent requests of any size run a handful of shapes.
Where the JAX package AOT-compiles one XLA program per bucket, this
predictor captures one CUDA graph per input signature
(:mod:`mxnet_tpu_torch.captured`): :meth:`aot_compile` captures one and
returns its FLOPs, :meth:`warmup` captures every bucket before traffic
arrives (``{bucket: FLOPs}``, as the JAX package's; each capture's
seconds in :attr:`CompiledPredictor.capture_s`), and :meth:`predict`
copies its arguments into the program's static inputs and replays it.
``warmup(autotune=)`` first tunes the serving knobs (``tuning/``).
A signature not seen before is captured at its first call, and
:attr:`n_traces` counts the programs captured. On the CPU each program
runs its forward eagerly over the same static inputs. :meth:`predict`
returns copies of the net's outputs on the device without waiting for
them. :func:`predictor_for` builds one at a serving precision (float32,
or bfloat16 through ``amp.convert_hybrid_block``). Each capture counts in
``mx_compile_retraces_total``; :meth:`CompiledPredictor.memory_report`
merges the captures' allocator footprints (``telemetry.MemoryReport``).
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..analysis.program import analysis_mode
from ..base import MXNetError
from ..context import resolve_device
from ..captured import Programs, map_tensors

__all__ = ["CompiledPredictor", "DEFAULT_BUCKETS", "map_tensors",
           "predictor_for", "synchronize", "device_scope"]

#: default leading-dim shape buckets: powers of two up to 64
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

_ARRAY_TYPES = (torch.Tensor, np.ndarray)

_LOG = logging.getLogger("mxnet_tpu_torch.serving")


def _is_batched(leaf) -> bool:
    return isinstance(leaf, _ARRAY_TYPES) and leaf.ndim >= 1


def pad_rows(leaf, bucket: int):
    """Zero-pad a leaf's leading dim up to ``bucket`` rows."""
    n = int(leaf.shape[0])
    if n == bucket:
        return leaf
    if isinstance(leaf, np.ndarray):
        pad = np.zeros((bucket - n,) + leaf.shape[1:], leaf.dtype)
        return np.concatenate([leaf, pad], axis=0)
    pad = leaf.new_zeros((bucket - n,) + tuple(leaf.shape[1:]))
    return torch.cat([leaf, pad], dim=0)


#: where a static input goes among a call's arguments
_INPUT = object()


def _static_key(leaf):
    """A non-tensor argument as part of a program's signature."""
    if leaf is None or isinstance(leaf, (bool, int, float, str)):
        return leaf
    return repr(leaf)


def device_scope(device: torch.device):
    """``device`` as the current CUDA device inside (nothing for the
    CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CompiledPredictor:
    """One callable = the whole forward pass, per shape bucket.

        pred = CompiledPredictor(net)          # cuda:0 unless device="cpu"
        pred.warmup(example_row)               # capture every bucket
        out = pred.predict(*pred.pad_to_bucket(x)[0])
    """

    def __init__(self, net: torch.nn.Module,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 device=None, analyze: Optional[str] = None):
        sizes = tuple(sorted({int(b) for b in
                              (bucket_sizes or DEFAULT_BUCKETS)}))
        if not sizes or sizes[0] < 1:
            raise MXNetError("bucket_sizes must be positive integers, "
                             f"got {bucket_sizes!r}")
        self.device = resolve_device(device)
        self.bucket_sizes = sizes
        self._net = net.to(self.device).eval()
        self._programs = Programs(self._net, self.device)
        self._mu = threading.Lock()
        self._m_retraces = _telemetry.registry().counter(
            _telemetry.names.COMPILE_RETRACES)
        #: measured time of one micro-batch of the largest bucket, from
        #: :meth:`warmup`; None until warmup ran
        self.service_time_seed_s: Optional[float] = None
        #: {bucket: seconds its capture took}, from :meth:`warmup`
        self.capture_s: Dict[int, float] = {}
        self._flops: Dict = {}
        self._autotune_outcome = None
        # the program lint after the first request (analysis/): None |
        # 'report' | 'warn' | 'raise', MXNET_ANALYSIS by default
        self._analyze = analysis_mode(analyze)
        self._analysis_report = None
        self._analysis: Dict = {}

    @property
    def net(self) -> torch.nn.Module:
        return self._net

    @property
    def n_traces(self) -> int:
        """Programs captured so far: one per input signature (bucket), and
        one more each time the parameters moved since a capture."""
        return self._programs.n_traces

    # ---------------- bucketing ----------------
    def bucket_for(self, rows: int) -> int:
        """Smallest configured bucket >= ``rows``."""
        for b in self.bucket_sizes:
            if rows <= b:
                return b
        raise MXNetError(
            f"request of {rows} rows exceeds the largest shape bucket "
            f"({self.bucket_sizes[-1]}); raise bucket_sizes= or split "
            "the request")

    def pad_to_bucket(self, *args):
        """Pad every array argument's leading dim up to the next bucket.
        Returns ``(padded_args, rows)``: ``rows`` is the valid-row count;
        outputs beyond it are padding and must be sliced away."""
        batched = [a for a in args if _is_batched(a)]
        if not batched:
            raise MXNetError("pad_to_bucket: no array argument with a "
                             "leading batch dim")
        rows = int(batched[0].shape[0])
        bucket = self.bucket_for(rows)
        return tuple(pad_rows(a, bucket) if _is_batched(a) else a
                     for a in args), rows

    # ---------------- call ----------------
    def as_tensor(self, leaf):
        """An array argument as a tensor on this predictor's device."""
        if isinstance(leaf, torch.Tensor):
            return leaf.to(self.device)
        if isinstance(leaf, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(leaf)) \
                .to(self.device)
        return leaf

    @staticmethod
    def _leaves(args, kwargs):
        names = tuple(sorted(kwargs))
        leaves = [torch.from_numpy(np.ascontiguousarray(a))
                  if isinstance(a, np.ndarray) else a
                  for a in args + tuple(kwargs[k] for k in names)]
        return names, leaves

    def _key(self, args, kwargs) -> tuple:
        """The signature of a call: its arguments' shapes and dtypes and
        the other values."""
        names, leaves = self._leaves(args, kwargs)
        return (len(args), names, tuple(
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
            else _static_key(a) for a in leaves))

    def _program(self, args, kwargs):
        """The program of this call's signature (captured when new) and
        the call's tensor arguments in the order of its static inputs."""
        names, leaves = self._leaves(args, kwargs)
        tensors = [a for a in leaves if isinstance(a, torch.Tensor)]
        key = self._key(args, kwargs)

        net = self._net     # not self: a program must not keep its owner
        fixed = [_INPUT if isinstance(a, torch.Tensor) else a
                 for a in leaves]
        nargs = len(args)

        def build():
            inputs = [t.to(self.device, copy=True) for t in tensors]

            def body(*ins):
                it = iter(ins)
                vals = [next(it) if a is _INPUT else a for a in fixed]
                with torch.inference_mode():
                    return net(*vals[:nargs],
                               **dict(zip(names, vals[nargs:])))
            return body, inputs

        shapes = [tuple(t.shape) for t in tensors]
        traces = self._programs.n_traces
        prog = self._programs.get(key, build,
                                  what=f"predictor program {shapes}")
        if self._programs.n_traces != traces:
            self._m_retraces.inc()
        return prog, tensors

    def memory_report(self):
        """The field-wise max of the captured programs' allocator
        footprints (``telemetry.MemoryReport``), None before a capture or
        on the CPU."""
        reports = [p.memory for p in self._programs.programs()
                   if p.memory is not None]
        return _telemetry.memory.MemoryReport.merge(reports) \
            if reports else None

    def aot_compile(self, *args, **kwargs) -> Optional[float]:
        """Capture the program of this (bucket-shaped) batch ahead of
        traffic, unless it exists; returns its FLOPs, as the JAX package
        returns XLA's count: the products one eager forward on the
        program's inputs runs (``torch.utils.flop_counter``) plus what
        the hand-written kernels launched in it report
        (``ops.kernels.count_flops``), counted once a signature, as
        ``CompiledTrainStep.step_flops`` counts."""
        with self._mu, device_scope(self.device):
            prog, _ = self._program(args, kwargs)
            key = self._key(args, kwargs)
            if key not in self._flops:
                self._flops[key] = self._count_flops(prog)
            return self._flops[key]

    def _count_flops(self, prog) -> float:
        from torch.utils.flop_counter import FlopCounterMode
        from ..ops.kernels import count_flops, record_launches
        # launched to be counted, not served: out of the launch counts
        with FlopCounterMode(display=False) as fc, count_flops() as kf, \
                record_launches(), torch.inference_mode():
            prog.body(*prog.inputs)
        synchronize(self.device)
        return float(fc.get_total_flops()) + kf["flops"]

    def predict(self, *args, **kwargs):
        """Run one (bucket-shaped) batch: its arguments are copied into
        its program's static inputs and the program replays. Returns
        copies of the net's outputs on the device, without waiting for
        the device to finish them. The predictor's card is the current
        device meanwhile, whichever thread calls."""
        with self._mu, device_scope(self.device):
            prog, tensors = self._program(args, kwargs)
            for static, t in zip(prog.inputs, tensors):
                static.copy_(t)
            with torch.inference_mode():
                out = prog.run()
        if self._analyze is not None and self._analysis_report is None:
            self._run_analysis(args, kwargs)
        return out

    __call__ = predict

    # ---------------- static analysis (analysis/) ----------------
    @property
    def analysis_report(self):
        """The ProgramReport of the ``analyze=`` run after the first
        request (None before it, or without ``analyze``)."""
        return self._analysis_report or None

    def _run_analysis(self, args, kwargs):
        try:
            report = self.analyze(*args, **kwargs)
        except Exception as e:   # analysis must not kill serving
            _LOG.warning("CompiledPredictor: program analysis failed "
                         "(%s: %s); skipping", type(e).__name__, e)
            self._analysis_report = False
            return
        self._analysis_report = report
        if self._analyze == "warn" and not report.ok:
            _LOG.warning("CompiledPredictor program analysis:\n%s",
                         report.summary())
        elif self._analyze == "raise":
            report.raise_if_findings()

    def lower_entry(self, *args, batch_size: Optional[int] = None,
                    **kwargs):
        """Record this (bucket-shaped) batch's program for static
        analysis: the dict of ``CompiledTrainStep.lower_entry`` (mode
        ``predict``, ``schedule`` the record of one eager run of the
        forward: no graph is captured, no capture counted). Cached per
        signature."""
        from ..analysis import schedule as _sched
        key = self._key(args, kwargs)
        info = self._analysis.get(key)
        if info is not None:
            return info
        names, leaves = self._leaves(args, kwargs)
        vals = [self.as_tensor(a) for a in leaves]
        nargs, net = len(args), self._net

        def body():
            # no_grad, not inference_mode: the record then sees the aten
            # ops the kernels run (inference mode hands the dispatch mode
            # composite ops such as ``linear`` before they decompose)
            with torch.no_grad():
                return net(*vals[:nargs], **dict(zip(names, vals[nargs:])))

        params = list(net.parameters())
        devices = [self.device.index or 0] \
            if self.device.type == "cuda" else []
        with self._mu, device_scope(self.device), \
                torch.random.fork_rng(devices=devices):
            rec, _ = _sched.record(body)
        rec.meta.update(mode="predict", device=str(self.device))
        blessed = [("bfloat16", "float32"), ("float16", "float32")] \
            if any(p.dtype in (torch.bfloat16, torch.float16)
                   for p in params) else []
        info = dict(kind="predict", mode="predict", schedule=rec,
                    mesh=None, axis=None, expected_donated=None,
                    unit_sizes=[], n_params=len(params), n_state_leaves=0,
                    blessed_dtypes=blessed, table=None, report=None)
        self._analysis[key] = info
        return info

    def analyze(self, *args, **kwargs):
        """The program lint of this bucket's serving program
        (:class:`~mxnet_tpu_torch.analysis.ProgramReport`): no
        collectives, no host transfers, no unblessed dtype drift, the
        kernel census — the gates the training step passes."""
        from ..analysis.program import analyze_step
        return analyze_step(self, *args, **kwargs)

    def fusion_report(self, *args, **kwargs):
        report = self.analyze(*args, **kwargs)
        return getattr(report, "fusion", None)

    @property
    def autotune_result(self):
        """The :class:`~mxnet_tpu_torch.tuning.AutotuneOutcome` of the last
        ``warmup(autotune=)`` (None before, or with the gate off)."""
        return self._autotune_outcome

    def warmup(self, *example, buckets: Optional[Sequence[int]] = None,
               autotune: Optional[str] = None) -> Dict[int, Optional[float]]:
        """Capture every bucket's program from one example request (a
        one-row batch), then time one replay of the largest bucket into
        :attr:`service_time_seed_s`. Returns {bucket: FLOPs of its
        program} (:meth:`aot_compile`); each capture's seconds go to
        :attr:`capture_s`.

        ``autotune`` (the ``MXNET_AUTOTUNE`` gate by default): first
        replay or search this deployment's serving tunables
        (``serving.max_batch``, ``serving.batch_timeout_ms``; a
        ``max_batch`` past the largest bucket is infeasible); the tuned
        overrides govern a :class:`~mxnet_tpu_torch.serving.DynamicBatcher`
        built after warmup. A request's result is the same at any
        setting. A tuning that fails logs a warning and the defaults
        serve."""
        from .. import tuning as _tuning
        if _tuning.autotune_mode(autotune) != "off":
            try:
                self._autotune_outcome = _tuning.tune_predictor(
                    self, example, mode=autotune)
            except Exception as e:
                _LOG.warning("CompiledPredictor: autotune failed (%s: %s); "
                             "serving with defaults", type(e).__name__, e)
        out = {}
        padded = None
        for b in (buckets or self.bucket_sizes):
            padded = tuple(pad_rows(a, b) if _is_batched(a) else a
                           for a in example)
            out[b] = self.aot_compile(*padded)
            with self._mu:
                self.capture_s[b] = self._program(padded, {})[0].capture_s
        if padded is not None:
            t0 = time.perf_counter()
            self.predict(*padded)
            synchronize(self.device)
            self.service_time_seed_s = time.perf_counter() - t0
        return out


def predictor_for(net, dtype: str = "float32",
                  bucket_sizes: Optional[Sequence[int]] = None,
                  **kwargs) -> CompiledPredictor:
    """A :class:`CompiledPredictor` at the requested serving precision
    (``mxnet_tpu/serving/predictor.py`` ``predictor_for``):

    - ``float32``/``fp32``/``f32``: the net as it is;
    - ``bfloat16``/``bf16``/``float16``/``fp16``:
      ``amp.convert_hybrid_block`` casts every parameter not owned by a
      ``LayerNorm`` down (the LayerNorms stay float32);
    - ``int8``: raises, ``contrib.quantization`` is not ported.

    The conversion changes ``net`` in place; pass a copy to keep a
    float32 original. ``kwargs`` go to :class:`CompiledPredictor`
    (``device``)."""
    d = dtype.lower()
    if d in ("float32", "fp32", "f32"):
        pass
    elif d in ("bfloat16", "bf16", "float16", "fp16"):
        from .. import amp as _amp
        _amp.convert_hybrid_block(
            net, "bfloat16" if d.startswith("b") else "float16")
    elif d == "int8":
        raise MXNetError("int8 serving needs contrib.quantization, which "
                         "the port does not have")
    else:
        raise MXNetError(f"unknown serving dtype {dtype!r} (float32, "
                         "bfloat16, float16, int8)")
    return CompiledPredictor(net, bucket_sizes=bucket_sizes, **kwargs)
