"""The kernel layer: CUDA C++ kernels written for Hopper (``sm_90a``).

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into ONE shared
library with a plain C interface, at first use, and loaded with
``ctypes``. The library lives under ``build/torch_kernels/<hash>/`` at
the root of the checkout, keyed by a hash of the sources, so an edited
kernel is rebuilt and an unchanged one is not. Nothing is compiled or
loaded when this module is imported.

Dispatch rule, shared by every wrapper (``norm.layer_norm``,
``norm.layer_norm_bwd``, ``norm.bias_gelu``, ``norm.bias_gelu_bwd``,
``attention.flash_attention_fwd``, ``attention.flash_attention_bwd``,
``rnn_scan.rnn_scan_fwd``, ``rnn_scan.rnn_scan_bwd``,
``rnn_scan.rnn_decode_step``, ``opt_update.multi_update``):
a tensor on the CPU takes the plain PyTorch version that sits beside
the wrapper; a tensor on a CUDA device launches the kernel or raises.
There is no switch that turns a kernel off on the card.

Each wrapper adds one to its kernel's launch counter where it launches,
and nowhere else (:func:`launch_counts`, and by input dtype
:func:`launch_counts_by_dtype`), so a run can show that its path went
through the kernels, and in which dtype. A CUDA-graph capture launches
nothing on the card: :func:`record_launches` takes what the capturing
thread's wrappers, and any thread's on the capture's stream, would have
counted into a dict instead, and
:func:`add_launches` adds that delta at each replay, so the counts stay
the launches the card ran. Every wrapper call also feeds the telemetry
series ``mx_kernel_dispatch_total{path}``: ``cuda`` for a launch the card
ran (a replay adds its graph's launches), ``plain`` for a CPU tensor's
plain version (:func:`count_plain`).

FLOPs: inside :func:`count_flops` each launch adds the operations its
wrapper reports (the counts ``chip_smoke.py``'s bounds use: the products
of attention and of the recurrences, the elementwise work of LayerNorm,
bias-GELU and the update), which ``torch.utils.flop_counter`` cannot see
behind ``ctypes`` (``CompiledTrainStep.step_flops``).

The ``kernels.vmem_tile_budget`` tunable (``tuning/space.py``) keeps the
JAX package's name; on the card it is the shared memory a launch plan
may let one block claim (:func:`vmem_tile_budget`, capped by the card's
opt-in limit). :func:`plan_limits` hands it to the plans written in
Python (``norm.ln_fwd_plan``, ``norm.bg_bwd_plan``, which reads the SM
count alone, and ``rnn_scan.rnn_decode_plan``) and
:func:`sync_smem_budget` to the recurrence forward's plan, written in C
(``rnn_fwd_plan``). Its grid holds only values under which those plans
give bit-identical outputs (the card tests check each). Two plans keep
the card's whole limit, because their grid decides a summation order:
``norm.ln_bwd_plan`` (a smaller limit gives its block branch fewer blocks,
and the blocks' column partials are dgamma's and dbeta's sums) and the
recurrence walk (``rnn_bwd_walk_plan``: fed the budget, its tile moved
the backward's outputs by up to 2.3e-5 at the LM's shape on an H100).
The flash backward's tiles are fixed (``attention.flash_bwd_plan``
reports them); no budget moves them. The JAX package's second kernel
tunable, ``kernels.rnn_block_t`` (timesteps a Pallas grid step walks),
has no counterpart: the cooperative scan walks every timestep in one
launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ...base import MXNetError

__all__ = ["KERNELS", "KernelInfo", "launch_counts", "count_plain",
           "count_flops", "causal_pairs",
           "launch_counts_by_dtype", "reset_launch_counts",
           "record_launches", "add_launches",
           "library", "build_library", "launch", "check_cuda_operands",
           "DTYPE_CODES", "card_limits", "launch_empty",
           "vmem_tile_budget", "plan_limits", "sync_smem_budget",
           "SMEM_TILE_BUDGET_BYTES", "SMEM_BUDGET_GRID", "HOOKS",
           "plain_version"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
#: the checkout's root: the directory that holds the package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_DIR = os.path.join(ROOT, "build", "torch_kernels")
LIB_NAME = "libmxt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)

#: an H100's SMs and the shared memory a block may opt in to: what the
#: plans written in Python assume where no card is at hand
H100_SMS, H100_SMEM_OPTIN = 132, 232448


def card_limits(device=None):
    """(SMs, bytes of shared memory a block may opt in to) of the CUDA
    ``device`` (the current one by default), for the launch plans written
    in Python; an H100's where the device is not a CUDA device or there
    is no card."""
    if device is not None and torch.device(device).type != "cuda" \
            or not torch.cuda.is_available():
        return H100_SMS, H100_SMEM_OPTIN
    props = torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None else device)
    return props.multi_processor_count, getattr(
        props, "shared_memory_per_block_optin", H100_SMEM_OPTIN)


#: the shared memory a launch plan may let a block claim, by default all
#: that a block may opt in to on an H100, and the least the tunable takes
SMEM_TILE_BUDGET_BYTES = H100_SMEM_OPTIN
SMEM_BUDGET_FLOOR = 64 * 1024
#: the budget's candidates: each gives plans whose outputs are
#: bit-identical to the default's (tests/test_torch_cuda.py checks each;
#: ROADMAP.md says which values left the grid and why)
SMEM_BUDGET_GRID = (H100_SMEM_OPTIN, 192 * 1024, 128 * 1024, 96 * 1024,
                    64 * 1024)


def vmem_tile_budget(device=None) -> int:
    """The shared memory a launch plan may let one block claim on
    ``device``: autotune override > ``MXNET_VMEM_TILE_BUDGET`` > all the
    card offers (the ``kernels.vmem_tile_budget`` tunable), clamped to
    [64 KiB, the card's opt-in limit]."""
    from ...tuning import space as _tspace
    optin = card_limits(device)[1]
    try:
        v = int(_tspace.value("kernels.vmem_tile_budget",
                              SMEM_TILE_BUDGET_BYTES))
    except (TypeError, ValueError):
        v = SMEM_TILE_BUDGET_BYTES
    return max(SMEM_BUDGET_FLOOR, min(v, optin))


def plan_limits(device=None):
    """(SMs, the shared memory a block may claim) for a launch plan:
    :func:`card_limits` with the opt-in limit capped by
    :func:`vmem_tile_budget`."""
    sms, optin = card_limits(device)
    return sms, min(optin, vmem_tile_budget(device))


_SMEM_SET = [None]


def sync_smem_budget(device=None) -> None:
    """Hand :func:`vmem_tile_budget` to the plan the library computes in
    C (the recurrence forward's), when it changed since the last call."""
    b = vmem_tile_budget(device)
    if _SMEM_SET[0] != b:
        library().mxt_set_smem_budget(b)
        _SMEM_SET[0] = b


def _register_tunables():
    """The kernel layer's tunable, next to the constant it makes
    sweepable. It changes launch plans, never a kernel's numbers: every
    grid value gives bit-identical outputs."""
    from ...tuning.space import Tunable, register
    register(Tunable(
        "kernels.vmem_tile_budget", default=SMEM_TILE_BUDGET_BYTES,
        grid=SMEM_BUDGET_GRID,
        env="MXNET_VMEM_TILE_BUDGET", parse=lambda s: int(float(s)),
        valid=lambda v, _c: SMEM_BUDGET_FLOOR <= int(v)
        <= card_limits()[1],
        seam="ops.kernels.vmem_tile_budget() -> plan_limits(): the "
             "LayerNorm forward, bias-GELU backward and decode-step "
             "plans; sync_smem_budget(): the recurrence forward's plan",
        scope="train", affects_program=True,
        doc="shared memory (bytes) a launch plan may let one block "
            "claim (<= the card's opt-in limit)"))


_register_tunables()


@dataclass(frozen=True)
class KernelInfo:
    name: str
    source: str        # path in the repository
    entry: str         # C symbol in the shared library
    argtypes: tuple
    replaces: str      # the TPU kernel it replaces (file:line)


KERNELS: Dict[str, KernelInfo] = {k.name: k for k in (
    KernelInfo(
        "flash_fwd", "mxnet_tpu_torch/ops/kernels/csrc/flash_fwd.cu",
        "mxt_flash_fwd",
        # q, k, v, out, lse, BH, Sq, Sk, D, causal, sm_scale, dtype, stream
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
        "mxnet_tpu/ops/attention.py:157 (_flash_kernel)"),
    KernelInfo(
        "layernorm_fwd", "mxnet_tpu_torch/ops/kernels/csrc/layernorm_fwd.cu",
        "mxt_layernorm_fwd",
        # x, gamma, beta, out, rows, C, eps, dtype, vec, packs, threads,
        # blocks, stream
        (_P, _P, _P, _P, _L, _I, _F) + (_I,) * 5 + (_P,),
        "mxnet_tpu/ops/kernels/norm.py:107 (_ln_fwd_kernel)"),
    KernelInfo(
        "bias_gelu_fwd", "mxnet_tpu_torch/ops/kernels/csrc/bias_gelu_fwd.cu",
        "mxt_bias_gelu_fwd",
        # x, b, out, n, C, dtype, stream
        (_P, _P, _P, _L, _I, _I, _P),
        "mxnet_tpu/ops/kernels/norm.py:222 (_bg_fwd_kernel)"),
    KernelInfo(
        "flash_bwd_fused",
        "mxnet_tpu_torch/ops/kernels/csrc/flash_bwd_fused.cu",
        "mxt_flash_bwd_fused",
        # q, k, v, dout, lse, delta, dq, dq_acc, dk, dv, BH, Sq, Sk, D,
        # causal, sm_scale, dtype, stream
        (_P,) * 10 + (_I,) * 5 + (_F, _I, _P),
        "mxnet_tpu/ops/attention.py:371 (_flash_bwd_fused_kernel)"),
    KernelInfo(
        "flash_bwd_dq", "mxnet_tpu_torch/ops/kernels/csrc/flash_bwd.cu",
        "mxt_flash_bwd_dq",
        # q, k, v, dout, lse, delta, dq, BH, Sq, Sk, D, causal, sm_scale,
        # dtype, stream
        (_P,) * 7 + (_I,) * 5 + (_F, _I, _P),
        "mxnet_tpu/ops/attention.py:405 (_flash_bwd_dq_kernel)"),
    KernelInfo(
        "flash_bwd_dkv", "mxnet_tpu_torch/ops/kernels/csrc/flash_bwd.cu",
        "mxt_flash_bwd_dkv",
        # q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk, D, causal,
        # sm_scale, dtype, stream
        (_P,) * 8 + (_I,) * 5 + (_F, _I, _P),
        "mxnet_tpu/ops/attention.py:322 (_flash_bwd_dkv_kernel)"),
    KernelInfo(
        "layernorm_bwd", "mxnet_tpu_torch/ops/kernels/csrc/layernorm_bwd.cu",
        "mxt_layernorm_bwd",
        # x, gamma, dy, dx, part, dgamma, dbeta, rows, C, eps, dtype, vec,
        # packs, threads, blocks, stream
        (_P,) * 7 + (_L, _I, _F) + (_I,) * 5 + (_P,),
        "mxnet_tpu/ops/kernels/norm.py:116 (_ln_bwd_kernel)"),
    KernelInfo(
        "bias_gelu_bwd", "mxnet_tpu_torch/ops/kernels/csrc/bias_gelu_bwd.cu",
        "mxt_bias_gelu_bwd",
        # x, b, dy, dx, part, db, rows, C, dtype, b_dtype, vec, tiles,
        # chunks, rows_per_chunk, stream
        (_P,) * 6 + (_L,) + (_I,) * 6 + (_L, _P),
        "mxnet_tpu/ops/kernels/norm.py:227 (_bg_bwd_kernel)"),
    KernelInfo(
        "rnn_scan_fwd", "mxnet_tpu_torch/ops/kernels/csrc/rnn_scan_fwd.cu",
        "mxt_rnn_scan_fwd",
        # xw, h0, c0, w_hh, b_hh, ys, cs, T, N, H, mode, dtype, stream
        (_P,) * 7 + (_I,) * 5 + (_P,),
        "mxnet_tpu/ops/kernels/rnn_scan.py:210 (_fwd_kernel)"),
    KernelInfo(
        "rnn_scan_bwd", "mxnet_tpu_torch/ops/kernels/csrc/rnn_scan_bwd.cu",
        "mxt_rnn_scan_bwd",
        # xw, h0, c0, w_hh, b_hh, ys, cs, dy, dh_s, dc_s, dxw, dhw, dh0,
        # dc0, dw, db, T, N, H, mode, dtype, stream
        (_P,) * 16 + (_I,) * 5 + (_P,),
        "mxnet_tpu/ops/kernels/rnn_scan.py:240 (_bwd_kernel)"),
    KernelInfo(
        "rnn_decode", "mxnet_tpu_torch/ops/kernels/csrc/rnn_decode.cu",
        "mxt_rnn_decode",
        # xw, h, c, w_hh, b_hh, h_out, c_out, N, H, mode, dtype, w_dtype,
        # units, threads, group_rows, path, stream
        (_P,) * 7 + (_I,) * 9 + (_P,),
        "mxnet_tpu/ops/kernels/rnn_scan.py:486 (_decode_kernel)"),
    KernelInfo(
        "opt_update", "mxnet_tpu_torch/ops/kernels/csrc/opt_update.cu",
        "mxt_opt_update",
        # entries, n_entries, n_chunks, chunk, kind, has_clip, rsp, clp,
        # rescale, clip, mom, b1, b2, eps, omb1, omb2, dtype, stream
        (_P,) + (_I,) * 5 + (_P, _P) + (_F,) * 8 + (_I, _P),
        "mxnet_tpu/ops/kernels/opt_update.py:107 (_opt_kernel)"),
)}

_COUNTS: Dict[str, int] = {name: 0 for name in KERNELS}
_DTYPE_COUNTS: Dict[tuple, int] = {}
_COUNT_MU = threading.Lock()
#: per thread: the dict a capture on that thread records its launches into
_RECORDING = threading.local()
#: per capture stream (its handle): the dict its capture records into
_RECORDING_STREAMS: Dict[int, Dict[tuple, int]] = {}
_LIB_MU = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


_DISPATCH = []


def _dispatch_counter():
    """``mx_kernel_dispatch_total`` (registered at first use: the
    telemetry package is imported lazily by the kernel layer)."""
    if not _DISPATCH:
        from ...telemetry import names, registry
        _DISPATCH.append(registry().counter(names.KERNEL_DISPATCH))
    return _DISPATCH[0]


def count_plain() -> None:
    """A wrapper ran its kernel's plain version (a CPU tensor)."""
    _dispatch_counter().inc(label="plain")


#: observers of the kernel layer, None unless one is installed (a
#: schedule record installs both while it runs): ``launch(name, dtype,
#: flops, args, io)`` after each launch (:func:`launch`), and
#: ``fold(name, args, kwargs, meta)``, a context manager around a call of
#: a plain version (:func:`plain_version`) that yields a list to append
#: the call's result to, or None
HOOKS: Dict[str, object] = {"launch": None, "fold": None}


def plain_version(kernel, when=None, meta=None):
    """Decorator of a kernel's plain version: while a ``fold`` hook is
    installed (:data:`HOOKS`), the call runs inside it, named ``kernel``
    (a name, or a callable of the call's arguments: the kernel the card
    would launch); ``when(*args, **kwargs)`` False leaves the call alone,
    and ``meta(*args, **kwargs)`` is handed to the hook."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            fold = HOOKS["fold"]
            if fold is None or (when is not None and
                                not when(*args, **kwargs)):
                return fn(*args, **kwargs)
            name = kernel(*args, **kwargs) if callable(kernel) else kernel
            extra = meta(*args, **kwargs) if meta is not None else None
            with fold(name, args, kwargs, extra) as box:
                out = fn(*args, **kwargs)
                if box is not None:
                    box.append(out)
            return out
        return wrapper
    return deco


#: FLOPs the launches report while :func:`count_flops` is open (a
#: backward's launches come from autograd's worker thread, so the sum is
#: the process's, not a thread's)
_FLOPS = {"open": 0, "flops": 0.0}


@contextmanager
def count_flops():
    """Within the block, each launch adds the FLOPs its wrapper reports;
    yields a dict whose ``"flops"`` holds the sum on exit."""
    out = {"flops": 0.0}
    with _COUNT_MU:
        _FLOPS["open"] += 1
        start = _FLOPS["flops"]
    try:
        yield out
    finally:
        with _COUNT_MU:
            _FLOPS["open"] -= 1
            out["flops"] = _FLOPS["flops"] - start


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes: all, or under the
    end-aligned causal mask those with k <= q + (sk - sq)."""
    if not causal:
        return sq * sk
    import numpy as np
    return int(np.clip(np.arange(sq) + (sk - sq) + 1, 0, sk).sum())


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    with _COUNT_MU:
        return dict(_COUNTS)


def launch_counts_by_dtype() -> Dict[str, Dict[str, int]]:
    """Launches per kernel and input dtype (``"float32"``,
    ``"bfloat16"``) since the last :func:`reset_launch_counts`."""
    with _COUNT_MU:
        out: Dict[str, Dict[str, int]] = {}
        for (name, dt), n in _DTYPE_COUNTS.items():
            out.setdefault(name, {})[dt] = n
        return out


def reset_launch_counts() -> None:
    with _COUNT_MU:
        for k in _COUNTS:
            _COUNTS[k] = 0
        _DTYPE_COUNTS.clear()


@contextmanager
def record_launches(stream=None):
    """Within the block, launches counted on this thread go into the
    yielded dict ``{(kernel, input dtype): launches}`` and not into the
    counts: a graph capture, which the card runs only at each replay
    (:func:`add_launches`). With ``stream`` (the capture's), launches
    made on that stream by any thread go there too: a captured backward
    runs on autograd's worker thread. Other launches count as before."""
    delta: Dict[tuple, int] = {}
    prev = getattr(_RECORDING, "delta", None)
    _RECORDING.delta = delta
    key = None if stream is None else stream.cuda_stream
    if key is not None:
        with _COUNT_MU:
            _RECORDING_STREAMS[key] = delta
    try:
        yield delta
    finally:
        _RECORDING.delta = prev
        if key is not None:
            with _COUNT_MU:
                del _RECORDING_STREAMS[key]


def add_launches(delta: Dict[tuple, int]) -> None:
    """Count ``delta``'s launches once (a graph's replay)."""
    total = 0
    with _COUNT_MU:
        for key, n in delta.items():
            _COUNTS[key[0]] += n
            _DTYPE_COUNTS[key] = _DTYPE_COUNTS.get(key, 0) + n
            total += n
    if total:
        _dispatch_counter().inc(total, label="cuda")


def _count(name: str, dtype: torch.dtype, stream: Optional[int] = None
           ) -> None:
    """One launch of kernel ``name`` on inputs of ``dtype`` (on the CUDA
    stream handle ``stream``): into this thread's capture record, or the
    record of the capture of ``stream``, when one is open, else into the
    counts."""
    key = (name, str(dtype).replace("torch.", ""))
    delta = getattr(_RECORDING, "delta", None)
    with _COUNT_MU:
        if delta is None:
            delta = _RECORDING_STREAMS.get(stream)
        if delta is not None:
            delta[key] = delta.get(key, 0) + 1
            return
        _COUNTS[name] += 1
        _DTYPE_COUNTS[key] = _DTYPE_COUNTS.get(key, 0) + 1
    _dispatch_counter().inc(label="cuda")


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                     "kernels are built on the machine with the card")


def build_library(verbose: bool = False) -> str:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` per source, all started
    together) and link them into one shared library. Returns its path;
    a library already built from the same sources is reused."""
    out_dir = os.path.join(BUILD_DIR, _source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
    cu = [p for p in _sources() if p.endswith(".cu")]
    procs = []
    for src in cu:
        obj = os.path.join(tmp, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors, objs = [], []
    for cmd, obj, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(out, flush=True)
        if p.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out}")
        objs.append(obj)
    if errors:
        raise MXNetError("nvcc failed:\n" + "\n".join(errors))
    tmp_lib = os.path.join(tmp, LIB_NAME)
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise MXNetError(f"nvcc link failed:\n$ {' '.join(cmd)}\n"
                         f"{res.stdout}")
    # publish atomically: a concurrent builder sees all of it or none
    try:
        os.rename(tmp, out_dir)
    except OSError:
        if not os.path.exists(lib):
            raise
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LIB_MU:
        if _LIB is None:
            lib = ctypes.CDLL(build_library())
            for info in KERNELS.values():
                fn = getattr(lib, info.entry)
                fn.argtypes = list(info.argtypes)
                fn.restype = ctypes.c_int
            lib.mxt_error_string.argtypes = [ctypes.c_int]
            lib.mxt_error_string.restype = ctypes.c_char_p
            # queries of the kernels' plans, not kernels
            for query in ("mxt_rnn_fwd_plan", "mxt_rnn_bwd_walk_plan"):
                getattr(lib, query).argtypes = [_I, _I, _I, _I, _P]
                getattr(lib, query).restype = ctypes.c_int
            lib.mxt_set_smem_budget.argtypes = [_I]
            lib.mxt_set_smem_budget.restype = ctypes.c_int
            lib.mxt_flash_bwd_plan.argtypes = [_I] * 6 + [_P]
            lib.mxt_flash_bwd_plan.restype = ctypes.c_int
            # an empty kernel: the launch floor, for timing (not counted)
            lib.mxt_empty_launch.argtypes = [_I, _I, _P]
            lib.mxt_empty_launch.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def launch_empty(device: torch.device, blocks: int, threads: int) -> None:
    """Launch an empty kernel of ``blocks`` x ``threads`` on PyTorch's
    current stream of ``device``: the floor under any launch, timed beside
    the kernels. Not a kernel of :data:`KERNELS` and not counted."""
    with torch.cuda.device(device):
        err = library().mxt_empty_launch(
            blocks, threads, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        what = library().mxt_error_string(err).decode()
        raise MXNetError(f"empty launch: CUDA error {err} ({what})")


def check_cuda_operands(name: str, x: torch.Tensor, *others) -> None:
    """Raise unless ``x`` and ``others`` lie on one CUDA device and ``x``
    is a contiguous float32 or bfloat16 tensor."""
    if x.device.type != "cuda":
        raise MXNetError(f"{name}: tensors on {x.device} are not supported "
                         "(cuda, or cpu for the plain version)")
    for t in others:
        if t.device != x.device:
            raise MXNetError(f"{name}: operands on {x.device} and "
                             f"{t.device}")
    if x.dtype not in DTYPE_CODES:
        raise MXNetError(f"{name}: dtype {x.dtype} has no kernel "
                         "(float32, bfloat16)")
    if not x.is_contiguous():
        raise MXNetError(f"{name}: the kernel takes contiguous tensors")


#: kernels whose C entry plans its own launch against the budget
_C_PLANNED = ("rnn_scan_fwd",)


def launch(name: str, device: torch.device, *args,
           dtype: torch.dtype, flops=None, io=None) -> None:
    """Call kernel ``name``'s C entry with ``args`` followed by PyTorch's
    current stream on ``device``, and count the launch, also under the
    ``dtype`` of its inputs (:func:`launch_counts_by_dtype`; under
    :func:`record_launches`, into the capture's record). ``flops`` (a
    number, or a callable evaluated only inside :func:`count_flops`) is
    the launch's work; ``io`` = ``(reads, writes in place)`` tensors
    where the arguments hold no tensor's pointer (``opt_update``'s
    table), for the ``launch`` hook (:data:`HOOKS`). Raises when the entry reports a CUDA error (a refused
    launch)."""
    fn = getattr(library(), KERNELS[name].entry)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        if name in _C_PLANNED:
            sync_smem_budget(device)
        err = fn(*args, stream)
    if err != 0:
        what = library().mxt_error_string(err).decode()
        raise MXNetError(f"{name}: CUDA error {err} ({what}) at launch")
    _count(name, dtype, stream)
    hook = HOOKS["launch"]
    if hook is not None:
        hook(name, dtype, flops, args, io)
    if flops is not None and _FLOPS["open"]:
        n = float(flops() if callable(flops) else flops)
        with _COUNT_MU:
            _FLOPS["flops"] += n
