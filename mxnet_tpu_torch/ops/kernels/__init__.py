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
``rnn_scan.rnn_decode_step``, ``opt_update.unit_update``):
a tensor on the CPU takes the plain PyTorch version that sits beside
the wrapper; a tensor on a CUDA device launches the kernel or raises.
There is no switch that turns a kernel off on the card.

Each wrapper adds one to its kernel's launch counter where it launches,
and nowhere else (:func:`launch_counts`), so a run can show that its
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ...base import MXNetError

__all__ = ["KERNELS", "KernelInfo", "launch_counts", "reset_launch_counts",
           "library", "build_library", "launch", "check_cuda_operands",
           "DTYPE_CODES"]

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
        # x, gamma, beta, out, rows, C, eps, dtype, stream
        (_P, _P, _P, _P, _L, _I, _F, _I, _P),
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
        # x, gamma, dy, dx, dg_part, db_part, dgamma, dbeta, rows, C,
        # nparts, eps, dtype, stream
        (_P,) * 8 + (_L, _I, _I, _F, _I, _P),
        "mxnet_tpu/ops/kernels/norm.py:116 (_ln_bwd_kernel)"),
    KernelInfo(
        "bias_gelu_bwd", "mxnet_tpu_torch/ops/kernels/csrc/bias_gelu_bwd.cu",
        "mxt_bias_gelu_bwd",
        # x, b, dy, dx, db_part, db, rows, C, nparts, dtype, stream
        (_P,) * 6 + (_L, _I, _I, _I, _P),
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
        # xw, h, c, w_hh, b_hh, h_out, c_out, N, H, mode, dtype, stream
        (_P,) * 7 + (_I,) * 4 + (_P,),
        "mxnet_tpu/ops/kernels/rnn_scan.py:486 (_decode_kernel)"),
    KernelInfo(
        "opt_update", "mxnet_tpu_torch/ops/kernels/csrc/opt_update.cu",
        "mxt_opt_update",
        # w, g, s0, s1, lrv, wdv, tv, n, kind, has_clip, vec, lr, wd, t,
        # rescale, clip, mom, b1, b2, eps, omb1, omb2, dtype, stream
        (_P,) * 7 + (_L, _I, _I, _I, _F, _F, _I) + (_F,) * 8 + (_I, _P),
        "mxnet_tpu/ops/kernels/opt_update.py:107 (_opt_kernel)"),
)}

_COUNTS: Dict[str, int] = {name: 0 for name in KERNELS}
_COUNT_MU = threading.Lock()
_LIB_MU = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    with _COUNT_MU:
        return dict(_COUNTS)


def reset_launch_counts() -> None:
    with _COUNT_MU:
        for k in _COUNTS:
            _COUNTS[k] = 0


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
            lib.mxt_flash_bwd_plan.argtypes = [_I] * 6 + [_P]
            lib.mxt_flash_bwd_plan.restype = ctypes.c_int
            _LIB = lib
        return _LIB


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


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C entry with ``args`` followed by PyTorch's
    current stream on ``device``, and count the launch. Raises when the
    entry reports a CUDA error (a refused launch)."""
    fn = getattr(library(), KERNELS[name].entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        what = library().mxt_error_string(err).decode()
        raise MXNetError(f"{name}: CUDA error {err} ({what}) at launch")
    with _COUNT_MU:
        _COUNTS[name] += 1
