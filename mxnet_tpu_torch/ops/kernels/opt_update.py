"""The fused optimizer update (counterpart of
``mxnet_tpu/ops/kernels/opt_update.py``): SGD, with momentum or not, and
Adam over flat units, as the one-card captured step, the ZeRO-1 sharded
update and the eager ``Trainer.step`` apply them.

:func:`multi_update` updates a LIST of flat units in place (the JAX
package donates those buffers; here the persistent buffers are written
directly). For the units on a CUDA device it launches the ``opt_update``
kernel (``csrc/opt_update.cu``) once a (device, dtype) group, or raises;
for the units on the CPU it runs :func:`multi_update_plain`, the rule of
:func:`unit_update_plain` entry by entry, and copies the results in.
:func:`unit_update`, the JAX counterpart's API, is a one-entry call of
it.

Only exact ``SGD`` / ``Adam`` instances take the kernel
(:func:`opt_kernel_kind`): a subclass may override the rule, so it keeps
``Optimizer.fused_step_fn``.

Each entry's lr, wd and t come in one of three forms: host scalars;
per-element (n,) vectors (a ZeRO bucket unit); or 0-d tensors on the
unit's card (float32, but t int32), which the kernel reads from device
memory (element i of a (P,) buffer is its pointer plus an offset). The
rescale and the clip are one pair for the whole call: host scalars, or
0-d float32 tensors on the card exactly when every entry's lr, wd and t
are. In the device form the wrapper reads no value on the host, so a
captured CUDA graph of the launch reads each step's values at its replay
(the one-card ``compile_step``, ``gluon/fused_step.py``).

An entry may name ``low``: a bfloat16 or float16 copy of a float32 ``w``
(a ``multi_precision`` master's weight), written with the rounding of
the new value, as ``low.copy_(w)`` would write it.

The kernel reads its table of entries from its launch parameters; the
host cuts each entry into chunks of :data:`CHUNK` elements
(:func:`plan_launches`), one block a chunk; a list longer than :data:`CAPACITY` entries takes
several launches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ...base import MXNetError
from . import (DTYPE_CODES, check_cuda_operands, count_plain, launch,
               plain_version)

__all__ = ["unit_update", "unit_update_plain", "multi_update",
           "multi_update_plain", "plan_launches", "opt_kernel_kind",
           "kernel_step_fn", "KIND_CODES", "CAPACITY", "CHUNK",
           "ENTRY_DTYPE"]

#: kind codes of the C interface (csrc/opt_update.cu)
KIND_CODES = {"sgd": 0, "sgd_mom": 1, "adam": 2}
#: entries one launch takes (csrc/opt_update.cu ``OPT_CAPACITY``)
CAPACITY = 400
#: elements a chunk (a block's unit of work; a multiple of the 16-byte
#: pack of both dtypes)
CHUNK = 2048
#: an entry of the launch's table (csrc/opt_update.cu ``OptEntry``): the
#: pointers; lr, wd, t as pointers or float32 / int32 bits; n; its first
#: chunk; the form
ENTRY_DTYPE = np.dtype([
    ("w", "<u8"), ("g", "<u8"), ("s0", "<u8"), ("s1", "<u8"),
    ("low", "<u8"), ("lr", "<u8"), ("wd", "<u8"), ("t", "<u8"),
    ("n", "<i8"), ("chunk0", "<i4"), ("form", "<i4")])
_HP_HOST, _HP_DEVICE, _HP_VECTOR, _LOW_F16 = 0, 1, 2, 4
_LOW_DTYPES = (torch.bfloat16, torch.float16)


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
    """Plain version of one entry of the kernel → ``(new_w, new_states)``,
    new tensors in w's dtype. ``lr``/``wd`` (float32) and ``t`` (int32)
    are scalars, 0-d tensors or per-element vectors of w's length;
    ``rescale`` and ``clip`` scalars or 0-d tensors. The constants
    ``mom``, ``b1`` and ``b2`` that multiply a state are rounded to w's
    dtype (weakly typed Python floats in the JAX kernel); all arithmetic
    is float32, one elementwise op at a time."""
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


def multi_update_plain(kind: str, cfg: dict, ws, gs, lrs, wds, ts, rescale,
                       clip, states) -> list:
    """Plain version of the kernel over a list: :func:`unit_update_plain`
    of each entry, in order → ``[(new_w, new_states)]``, new tensors."""
    return [unit_update_plain(kind, cfg, w, g, lr, wd, t, rescale, clip, st)
            for w, g, lr, wd, t, st in zip(ws, gs, lrs, wds, ts, states)]


def plan_launches(ns: Sequence[int], chunk: int,
                  capacity: int = CAPACITY) -> List[tuple]:
    """The launches of a list of entries of ``ns`` elements:
    ``[(entry indices, first chunk of each, chunks in all)]``, at most
    ``capacity`` entries a launch, entries of no element left out. Entry
    k's chunks ``chunk0[k], chunk0[k] + 1, ...`` cover its elements
    ``[c * chunk, (c + 1) * chunk)`` in order, the last one ragged (the
    kernel runs chunk c on block c, of the last entry whose first chunk
    is at or before c), so with ``chunk`` a multiple of 8 each starts on
    a 16-byte pack of both dtypes. A pure function of its arguments."""
    if chunk <= 0 or chunk % 8:
        raise MXNetError(f"opt_update: chunk {chunk} is not a positive "
                         "multiple of 8")
    out, idx, first, total = [], [], [], 0
    for k, n in enumerate(ns):
        if n <= 0:
            continue
        chunks = -(-int(n) // chunk)
        if idx and (len(idx) == capacity or total + chunks >= 2 ** 31):
            out.append((idx, first, total))
            idx, first, total = [], [], 0
        idx.append(k)
        first.append(total)
        total += chunks
    if idx:
        out.append((idx, first, total))
    return out


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


def _bits(v, np_dtype) -> int:
    """A host value's 32 bits as the low half of an entry's 8 bytes."""
    return int(np.asarray(v, np_dtype).reshape(()).view(np.uint32))


def _entry(code, w, g, st, low, lr, wd, t, dev_form, keep) -> tuple:
    """One record of the table (a tuple in :data:`ENTRY_DTYPE`'s order,
    ``chunk0`` left 0). Tensors made here (a cast gradient, vectors moved
    to the card) go into ``keep``, alive until the launch is queued."""
    if w.ndim != 1:
        raise MXNetError("opt_update: the kernel takes flat (1-d) units")
    n, dev = w.numel(), w.device
    g = g.to(w.dtype).contiguous()
    keep.append(g)
    check_cuda_operands("opt_update", w, g, *st)
    for x in (g,) + st:
        if x.shape != w.shape or x.dtype != w.dtype or \
                not x.is_contiguous():
            raise MXNetError("opt_update: g and the states must be "
                             "contiguous, of w's shape and dtype")
    form = _HP_HOST
    if low is not None:
        if w.dtype != torch.float32 or low.dtype not in _LOW_DTYPES or \
                low.shape != w.shape or not low.is_contiguous() or \
                low.device != dev:
            raise MXNetError("opt_update: a low copy is a contiguous "
                             "bfloat16 or float16 tensor of a float32 w's "
                             "shape on its device")
        form |= _LOW_F16 if low.dtype == torch.float16 else 0
    on_card = [_on_card(v) for v in (lr, wd, t)]
    if all(on_card) and dev_form:
        form |= _HP_DEVICE
        hp = (_dev_scalar("lr", lr, torch.float32, dev),
              _dev_scalar("wd", wd, torch.float32, dev),
              _dev_scalar("t", t, torch.int32, dev))
    elif any(on_card) or dev_form:
        raise MXNetError("opt_update: lr, wd, t, the rescale and the clip "
                         "are all device scalars or none")
    else:
        vecs = (_check_vec("lr", lr, n, torch.float32, dev),
                _check_vec("wd", wd, n, torch.float32, dev),
                _check_vec("t", t, n, torch.int32, dev))
        if any(v is not None for v in vecs):
            if any(v is None for v in vecs):
                raise MXNetError("opt_update: lr, wd and t are all scalars "
                                 "or all vectors")
            form |= _HP_VECTOR
            keep.extend(vecs)
            hp = tuple(v.data_ptr() for v in vecs)
        else:
            hp = (_bits(_scalar(lr, float), np.float32),
                  _bits(_scalar(wd, float), np.float32),
                  _bits(_scalar(t, int), np.int32))
    ptr = lambda x: 0 if x is None else x.data_ptr()   # noqa: E731
    s0 = st[0] if st else None
    s1 = st[1] if len(st) > 1 else None
    return (w.data_ptr(), g.data_ptr(), ptr(s0), ptr(s1), ptr(low)) + hp \
        + (n, 0, form)


def _launch_group(code, cfg, records, dtype, dev, rescale, clip,
                  dev_form, ios) -> None:
    """The launches of one (device, dtype) group's records (``ios``: each
    record's ``(reads, writes)`` tensors)."""
    if dev_form:
        rsp = _dev_scalar("rescale", rescale, torch.float32, dev)
        clp = _dev_scalar("clip", clip, torch.float32, dev)
        rs, cl = 0.0, 0.0
    else:
        rsp = clp = None
        rs, cl = _scalar(rescale, float), _scalar(clip, float)
    b1, b2 = cfg.get("beta1", 0.0), cfg.get("beta2", 0.0)
    table = np.array(records, dtype=ENTRY_DTYPE)
    for idx, first, n_chunks in plan_launches(table["n"], CHUNK):
        part = np.ascontiguousarray(table[idx])
        part["chunk0"] = first
        launch("opt_update", dev, part.ctypes.data, len(idx), n_chunks,
               CHUNK, KIND_CODES[code], int(bool(cfg["has_clip"])), rsp, clp,
               rs, cl, float(cfg.get("momentum", 0.0)), float(b1), float(b2),
               float(cfg.get("epsilon", 0.0)), float(1 - b1), float(1 - b2),
               DTYPE_CODES[dtype], dtype=dtype,
               flops=20.0 * float(part["n"].sum()),
               io=([t for i in idx for t in ios[i][0]],
                   [t for i in idx for t in ios[i][1]]))


@plain_version("opt_update", when=lambda kind, cfg, ws, *a, **kw:
               bool(ws) and ws[0].device.type == "cpu",
               meta=lambda kind, cfg, ws, gs, *a, **kw:
               {"elements": sum(int(g.numel()) for g in gs)})
def multi_update(kind: str, cfg: dict, ws, gs, lrs, wds, ts, rescale, clip,
                 states, lows=None):
    """A list of flat units through the update, in place: each ``ws[i]``,
    its ``states[i]`` (flat, w's length and dtype) and ``lows[i]`` (None,
    or a low-precision copy of a float32 w) are overwritten with the new
    values; returns ``(ws, states)``. ``gs[i]`` is cast to w's dtype.
    ``lrs[i]``/``wds[i]``/``ts[i]`` are host scalars or per-element (n,)
    vectors (a bucket unit's ``pack_shard_hparams``), with ``rescale`` and
    ``clip`` host scalars; or all are device scalars (0-d tensors on the
    units' card: float32, t int32). CPU units take the plain version; the
    CUDA ones one ``opt_update`` launch a (device, dtype) group."""
    code = _code(kind, cfg)
    n_states = {"sgd": 0, "sgd_mom": 1, "adam": 2}[code]
    states = tuple(tuple(st) for st in states)
    lows = [None] * len(ws) if lows is None else list(lows)
    if not len(ws) == len(gs) == len(lrs) == len(wds) == len(ts) == \
            len(states) == len(lows):
        raise MXNetError("opt_update: the lists differ in length")
    for st in states:
        if len(st) != n_states:
            raise MXNetError(f"opt_update: {kind} takes {n_states} states, "
                             f"got {len(st)}")
    dev_form = _on_card(rescale) and _on_card(clip)
    if not dev_form and (_on_card(rescale) or _on_card(clip)):
        raise MXNetError("opt_update: lr, wd, t, the rescale and the clip "
                         "are all device scalars or none")
    groups: dict = {}
    ios: dict = {}
    keep: list = []
    for i, w in enumerate(ws):
        if w.device.type == "cpu":
            count_plain()
            nw, ns = unit_update_plain(kind, cfg, w, gs[i], lrs[i], wds[i],
                                       ts[i], rescale, clip, states[i])
            w.copy_(nw)
            for s, n in zip(states[i], ns):
                s.copy_(n)
            if lows[i] is not None:
                lows[i].copy_(nw)
            continue
        rec = _entry(code, w, gs[i], states[i], lows[i], lrs[i], wds[i],
                     ts[i], dev_form, keep)
        groups.setdefault((w.device, w.dtype), []).append(rec)
        # what the entry reads and writes in place (a schedule record's)
        ios.setdefault((w.device, w.dtype), []).append(
            ([gs[i]], [w, *states[i]] + ([lows[i]] if lows[i] is not None
                                         else [])))
    for key, records in groups.items():
        _launch_group(code, cfg, records, key[1], key[0], rescale, clip,
                      dev_form, ios[key])
    return tuple(ws), states


def unit_update(kind: str, cfg: dict, w, g, lr, wd, t, rescale, clip,
                states):
    """One flat unit through the update, in place: :func:`multi_update`
    of one entry. Returns ``(w, states)``."""
    ws, sts = multi_update(kind, cfg, [w], [g], [lr], [wd], [t], rescale,
                           clip, [states])
    return ws[0], sts[0]


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
    """A drop-in for ``Optimizer.fused_step_fn`` that routes all the flat
    units through :func:`multi_update` (in place: one launch a (device,
    dtype) group), or None when the rule is not kernelized (exact
    SGD/Adam only). It also takes ``lows``, the low-precision copies of
    float32 masters to write (:func:`multi_update`)."""
    kk = opt_kernel_kind(opt)
    if kk is None:
        return None
    kind, cfg = kk

    def stepfn(ws, gs, lrs, wds, ts, rescale, clip, states, lows=None):
        return multi_update(kind, cfg, ws, gs, lrs, wds, ts, rescale, clip,
                            states, lows)

    return stepfn
