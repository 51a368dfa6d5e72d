"""The fused optimizer update over one flat unit (counterpart of
``mxnet_tpu/ops/kernels/opt_update.py``): SGD, with momentum or not, and
Adam, as the ZeRO-1 sharded update applies them to each rank's shard of
a parameter or of a bucket of small parameters.

:func:`unit_update` updates the weight and its states IN PLACE (the JAX
package donates those buffers; here the persistent shard buffers are
written directly). For a tensor on a CUDA device it launches the
``opt_update`` kernel (``csrc/opt_update.cu``) or raises; for a tensor on
the CPU it runs :func:`unit_update_plain`, the same rule as separate
PyTorch elementwise ops in the kernel's order, and copies the result in.

Only exact ``SGD`` / ``Adam`` instances take the kernel
(:func:`opt_kernel_kind`): a subclass may override the rule, so it keeps
``Optimizer.fused_step_fn``.

The hyperparameters come in one of three forms, all three alike: host
scalars; lr, wd and t as per-element (n,) vectors (a ZeRO bucket unit)
with a host rescale and clip; or all five as 0-d tensors on the unit's
card (float32, but t int32), which the kernel reads from device memory:
element i of a (P,) buffer is its pointer plus an offset. In the device
form the wrapper reads no value on the host, so a captured CUDA graph of
the launch reads each step's values at its replay (the one-card
``compile_step``, ``gluon/fused_step.py``). Other mixes are refused.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...base import MXNetError
from . import DTYPE_CODES, check_cuda_operands, launch

__all__ = ["unit_update", "unit_update_plain", "opt_kernel_kind",
           "kernel_step_fn", "KIND_CODES"]

#: kind codes of the C interface (csrc/opt_update.cu)
KIND_CODES = {"sgd": 0, "sgd_mom": 1, "adam": 2}


def _code(kind: str, cfg: dict) -> str:
    if kind == "sgd":
        return "sgd" if cfg["momentum"] == 0.0 else "sgd_mom"
    if kind == "adam":
        return "adam"
    raise MXNetError(f"opt_update: unknown kind {kind!r} (sgd, adam)")


def _c32(v) -> float:
    """A host scalar rounded to float32 (a weakly typed constant)."""
    return float(np.float32(v))


def _dev32(v, device):
    """``v`` as float32 on ``device``: a tensor moves, a host scalar is
    filled in on the device (no host-to-device copy, so a CUDA graph can
    capture it)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), _c32(v), dtype=torch.float32, device=device)


def _host32(v):
    """A host scalar rounded to float32; a tensor (a device scalar) as
    float32 where it lies, read on no host."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return _c32(v)


def unit_update_plain(kind: str, cfg: dict, w, g, lr, wd, t, rescale, clip,
                      states):
    """Plain version of the kernel → ``(new_w, new_states)``, new tensors
    in w's dtype. ``lr``/``wd`` (float32) and ``t`` (int32) are scalars,
    0-d tensors or per-element vectors of w's length; ``rescale`` and
    ``clip`` scalars or 0-d tensors. The constants ``mom``, ``b1`` and
    ``b2`` that multiply a state are rounded to w's dtype (weakly typed
    Python floats in the JAX kernel); all arithmetic is float32, one
    elementwise op at a time."""
    code = _code(kind, cfg)
    dev, wdt = w.device, w.dtype
    wf = w.float()
    lr, wd = _dev32(lr, dev), _dev32(wd, dev)
    g = g.to(wdt).float() * _host32(rescale)
    if cfg["has_clip"]:
        c = _host32(clip)
        g = torch.clamp(g, -c, c)
    g = g + wd * wf
    if code == "sgd":
        return (wf - lr * g).to(wdt), ()

    def in_dt(c, s):
        """A constant as w's dtype holds it, times a state, in float32."""
        return s.float() * _dev32(c, dev).to(wdt).float()

    if code == "sgd_mom":
        (m,) = states
        nm = in_dt(cfg["momentum"], m) - lr * g
        return (wf + nm).to(wdt), (nm.to(wdt),)
    b1, b2, eps = cfg["beta1"], cfg["beta2"], cfg["epsilon"]
    m, v = states
    nm = in_dt(b1, m) + _c32(1 - b1) * g
    nv = in_dt(b2, v) + _c32(1 - b2) * g * g
    tf = t.to(dev).float() if isinstance(t, torch.Tensor) \
        else _dev32(int(t), dev)
    mhat = nm / (1 - torch.pow(_dev32(b1, dev), tf))
    vhat = nv / (1 - torch.pow(_dev32(b2, dev), tf))
    nw = wf - lr * mhat / (torch.sqrt(vhat) + _c32(eps))
    return nw.to(wdt), (nm.to(wdt), nv.to(wdt))


def _check_vec(name, v, n, dtype, device):
    if not isinstance(v, torch.Tensor) or v.ndim == 0:
        return None
    if tuple(v.shape) != (n,):
        raise MXNetError(f"opt_update: {name} has shape {tuple(v.shape)}, "
                         f"expected ({n},)")
    return v.to(device=device, dtype=dtype).contiguous()


def _scalar(v, cast):
    return cast(v.item()) if isinstance(v, torch.Tensor) else cast(v)


def _on_card(v) -> bool:
    """A device scalar: a 0-d tensor on a CUDA device."""
    return isinstance(v, torch.Tensor) and v.ndim == 0 and \
        v.device.type == "cuda"


def _dev_scalar(name, v, dtype, device):
    """``v``'s device pointer: a 0-d ``dtype`` tensor on ``device``
    (taken as it is: no copy, no host read)."""
    if v.dtype != dtype or v.device != device:
        raise MXNetError(f"opt_update: device scalar {name} must be "
                         f"{dtype} on {device}, got {v.dtype} on "
                         f"{v.device}")
    return v.data_ptr()


def unit_update(kind: str, cfg: dict, w, g, lr, wd, t, rescale, clip,
                states):
    """One flat unit through the update, in place: ``w`` and ``states``
    (flat, w's length and dtype) are overwritten with the new values and
    returned as ``(w, states)``. ``g`` is cast to w's dtype. ``lr``/``wd``
    /``t`` are host scalars or per-element (n,) vectors (a bucket unit's
    ``pack_shard_hparams``), with ``rescale`` and ``clip`` host scalars;
    or all five are device scalars (0-d tensors on w's card: float32, t
    int32)."""
    states = tuple(states)
    n_states = {"sgd": 0, "sgd_mom": 1, "adam": 2}[_code(kind, cfg)]
    if len(states) != n_states:
        raise MXNetError(f"opt_update: {kind} takes {n_states} states, "
                         f"got {len(states)}")
    if w.device.type == "cpu":
        nw, ns = unit_update_plain(kind, cfg, w, g, lr, wd, t, rescale,
                                   clip, states)
        w.copy_(nw)
        for s, n in zip(states, ns):
            s.copy_(n)
        return w, states
    g = g.to(w.dtype).contiguous()
    check_cuda_operands("opt_update", w, g, *states)
    n = w.numel()
    if w.ndim != 1:
        raise MXNetError("opt_update: the kernel takes flat (1-d) units")
    for x in (g,) + states:
        if x.shape != w.shape or x.dtype != w.dtype or \
                not x.is_contiguous():
            raise MXNetError("opt_update: g and the states must be "
                             "contiguous, of w's shape and dtype")
    dev = w.device
    on_card = [_on_card(v) for v in (lr, wd, t, rescale, clip)]
    if all(on_card):
        hp, ptrs = 2, tuple(
            _dev_scalar(name, v, dt, dev) for name, v, dt in (
                ("lr", lr, torch.float32), ("wd", wd, torch.float32),
                ("t", t, torch.int32), ("rescale", rescale, torch.float32),
                ("clip", clip, torch.float32)))
        scalars = (0.0, 0.0, 0, 0.0, 0.0)
    elif any(on_card):
        raise MXNetError("opt_update: lr, wd, t, the rescale and the clip "
                         "are all device scalars or none")
    else:
        vecs = (_check_vec("lr", lr, n, torch.float32, dev),
                _check_vec("wd", wd, n, torch.float32, dev),
                _check_vec("t", t, n, torch.int32, dev))
        hp = int(vecs[0] is not None)
        if any((v is not None) != bool(hp) for v in vecs):
            raise MXNetError("opt_update: lr, wd and t are all scalars or "
                             "all vectors")
        ptrs = tuple(None if v is None else v.data_ptr() for v in vecs) \
            + (None, None)
        scalars = ((0.0, 0.0, 0) if hp else (
            _scalar(lr, float), _scalar(wd, float), _scalar(t, int))) + (
            _scalar(rescale, float), _scalar(clip, float))
    code = _code(kind, cfg)
    b1, b2 = cfg.get("beta1", 0.0), cfg.get("beta2", 0.0)
    launch("opt_update", dev, w.data_ptr(), g.data_ptr(),
           states[0].data_ptr() if states else None,
           states[1].data_ptr() if len(states) > 1 else None,
           *ptrs, n, KIND_CODES[code], int(bool(cfg["has_clip"])), hp,
           *scalars, float(cfg.get("momentum", 0.0)),
           float(b1), float(b2), float(cfg.get("epsilon", 0.0)),
           float(1 - b1), float(1 - b2), DTYPE_CODES[w.dtype], dtype=w.dtype)
    return w, states


def opt_kernel_kind(opt) -> Optional[tuple]:
    """``(kind, cfg)`` when ``opt`` is an EXACT SGD/Adam instance (a
    subclass may override the rule), else None."""
    from ...optimizer.optimizer import SGD, Adam
    if type(opt) is SGD:
        return "sgd", {"momentum": float(opt.momentum),
                       "has_clip": opt.clip_gradient is not None}
    if type(opt) is Adam:
        return "adam", {"beta1": float(opt.beta1),
                        "beta2": float(opt.beta2),
                        "epsilon": float(opt.epsilon),
                        "has_clip": opt.clip_gradient is not None}
    return None


def kernel_step_fn(opt):
    """A drop-in for ``Optimizer.fused_step_fn`` that routes every flat
    unit through :func:`unit_update` (in place), or None when the rule is
    not kernelized (exact SGD/Adam only)."""
    kk = opt_kernel_kind(opt)
    if kk is None:
        return None
    kind, cfg = kk

    def stepfn(ws, gs, lrs, wds, ts, rescale, clip, states):
        new_ws, new_ss = [], []
        for i, (w, g, st) in enumerate(zip(ws, gs, states)):
            nw, ns = unit_update(kind, cfg, w, g, lrs[i], wds[i], ts[i],
                                 rescale, clip, st)
            new_ws.append(nw)
            new_ss.append(ns)
        return tuple(new_ws), tuple(new_ss)

    return stepfn
