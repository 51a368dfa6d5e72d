"""Time-fused recurrence kernels: LSTM / GRU / vanilla RNN (counterpart
of ``mxnet_tpu/ops/kernels/rnn_scan.py``).

:func:`rnn_scan` runs the recurrence of one (layer, direction) from the
precomputed input projections ``xw`` (T, N, G*H) = x @ W_ih^T + b_ih and
returns ``(ys, h_T, c_T|None)``, ys in forward time order. Gate order is
the JAX package's: LSTM [i, f, g, o], GRU [r, z, n].

- forward: CUDA kernel ``csrc/rnn_scan_fwd.cu``, one cooperative launch
  that owns the whole sequence (:func:`rnn_scan_fwd`; its tile:
  :func:`rnn_fwd_plan`);
- backward: ``csrc/rnn_scan_bwd.cu``, one C entry
  (:func:`rnn_scan_bwd`): the gate recompute h_{t-1} @ W_hh^T of every
  step as one tiled product, the cooperative reverse-time walk, then the
  dW_hh and db_hh sums;
- decode: :func:`rnn_decode_step`, one inference step from (N, G*H)
  projections, CUDA kernel ``csrc/rnn_decode.cu`` (one ordinary launch a
  step, the scan's gate math), and :func:`rnn_verify_scan`, the same step
  over K masked positions (speculative-decode verification).

Each carry family is a ``torch.autograd.Function`` (``_ScanLSTM``
returns (ys, c_T) and takes h_T as ys[-1]; ``_ScanNoC`` returns ys), as
the JAX package's custom VJPs are. For a tensor on the CPU the
Function's forward and backward run the plain versions beside them
(:func:`rnn_scan_plain`, :func:`rnn_scan_bwd_plain`); for a tensor on a
CUDA device the kernels run, raising on what they do not take.

Numbers: a step's arithmetic is float32; the state (h and c) keeps the
activation dtype from step to step, rounded there as the TPU kernel's
h_s / c_s scratch is; the backward's carries dh, dc and its sums dW, db
are float32 (the TPU scratch), dxw, dh0, dc0 come back in the
activation dtype and dW, db in W_hh's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ...base import MXNetError
from . import (DTYPE_CODES, check_cuda_operands, count_plain, launch,
               library, plain_version, plan_limits, sync_smem_budget)

__all__ = ["GATES", "MODE_CODES", "scan_supported", "rnn_scan",
           "rnn_scan_plain", "rnn_scan_bwd_plain", "rnn_scan_fwd",
           "rnn_scan_bwd", "rnn_fwd_plan", "rnn_bwd_walk_plan",
           "decode_supported", "rnn_decode_plan",
           "rnn_decode_step", "rnn_decode_step_plain", "rnn_verify_scan"]

GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
#: mode codes of the C interface (csrc/rnn_scan.cuh)
MODE_CODES = {"rnn_relu": 0, "rnn_tanh": 1, "lstm": 2, "gru": 3}


def scan_supported(xw, h0, c0, mode: str) -> Optional[str]:
    """None when the kernels cover this call, else the reason (the
    JAX package's rule: a known mode, float32 or bfloat16, xw (T, N, G*H)
    with T >= 1)."""
    if mode not in GATES:
        return f"unknown mode {mode!r}"
    if xw.dtype not in DTYPE_CODES:
        return f"dtype {xw.dtype} has no kernel (float32, bfloat16)"
    if xw.ndim != 3 or xw.shape[0] < 1:
        return "expects (T, N, G*H) with T >= 1"
    return None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _split(a, g):
    return a.chunk(g, dim=-1) if g > 1 else (a,)


def _fwd_step(mode, x, hw, b, h_prev, c_prev, dtype):
    """One step in float32 (``_fwd_step`` of the JAX package): x, hw, b
    float32 (N, G*H), h_prev, c_prev float32 (N, H). The new cell state is
    rounded to ``dtype`` before tanh reads it (the stored state)."""
    if mode == "lstm":
        gi, gf, gg, go = _split((x + hw) + b, 4)
        i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        c = (f * c_prev + i * torch.tanh(gg)).to(dtype).float()
        return o * torch.tanh(c), c
    if mode == "gru":
        hr, hz, hn = _split(hw + b, 3)
        xr, xz, xn = _split(x, 3)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h_prev, None
    pre = (x + hw) + b
    return (torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)), None


@plain_version("rnn_scan_fwd")
def rnn_scan_plain(xw, h0, c0, w_hh, b_hh, mode: str):
    """Plain forward (the Python loop of ``ops/rnn.py``'s reference) →
    (ys, cs|None), each (T, N, H) in xw's dtype; cs is the cell-state
    trajectory (LSTM), the residual of the backward."""
    dt = xw.dtype
    w = w_hh.float()
    b = b_hh.float()
    h = h0.to(dt)
    c = c0.to(dt) if mode == "lstm" else None
    ys, cs = [], []
    for t in range(xw.shape[0]):
        hf = h.float()
        h_new, c_new = _fwd_step(mode, xw[t].float(), hf @ w.t(), b, hf,
                                 c.float() if c is not None else None, dt)
        h = h_new.to(dt)
        ys.append(h)
        if c_new is not None:
            c = c_new.to(dt)
            cs.append(c)
    return torch.stack(ys), (torch.stack(cs) if cs else None)


def _dtanh(t, y):
    """Cotangent through tanh with output y, in the JAX rule's form:
    u = t * (1 - y); u + u * y."""
    u = t * (1.0 - y)
    return u + u * y


def _dsigmoid(t, s):
    return t * (s * (1.0 - s))


def _bwd_step(mode, x, hw, b, h_prev, c_prev, c_new, y, dy, dh_carry,
              dc_carry):
    """One reverse step (``_bwd_step`` of the JAX package), float32 →
    (dxw, dhw, dh_dir, dc_carry')."""
    dh = dy + dh_carry
    if mode == "lstm":
        gi, gf, gg, go = _split((x + hw) + b, 4)
        i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        g = torch.tanh(gg)
        tc = torch.tanh(c_new)
        u = (dh * o) * (1.0 - tc)
        dc = dc_carry + u + u * tc
        dg = torch.cat([_dsigmoid(dc * g, i), _dsigmoid(dc * c_prev, f),
                        _dtanh(dc * i, g), _dsigmoid(dh * tc, o)], dim=-1)
        return dg, dg, None, dc * f
    if mode == "gru":
        hr, hz, hn = _split(hw + b, 3)
        xr, xz, xn = _split(x, 3)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dz = dh * h_prev - dh * n
        dn_pre = _dtanh(dh * (1.0 - z), n)
        dr_pre = _dsigmoid(dn_pre * hn, r)
        dz_pre = _dsigmoid(dz, z)
        return (torch.cat([dr_pre, dz_pre, dn_pre], dim=-1),
                torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1), dh * z, None)
    if mode == "rnn_tanh":
        dpre = _dtanh(dh, y)
    else:
        dpre = torch.where(y > 0, dh, torch.zeros_like(dh))
    return dpre, dpre, None, None


@plain_version("rnn_scan_bwd")
def rnn_scan_bwd_plain(xw, h0, c0, w_hh, b_hh, ys, cs, dys, dc_t,
                       mode: str):
    """Plain backward: an explicit reverse-time loop that recomputes the
    gates from xw_t and h_{t-1} each step (the TPU kernel's order) →
    (dxw, dh0, dc0|None, dw, db). ``dc_t`` (c_T's cotangent, LSTM) seeds
    the cell carry at t = T-1; ``dys`` is the cotangent of ys."""
    dt = xw.dtype
    n_t = xw.shape[0]
    w = w_hh.float()
    b = b_hh.float()
    lstm = mode == "lstm"
    dh = torch.zeros(h0.shape, dtype=torch.float32, device=xw.device)
    dc = dc_t.to(dt).float() if lstm else None
    dw = torch.zeros(w.shape, dtype=torch.float32, device=xw.device)
    db = torch.zeros(b.shape, dtype=torch.float32, device=xw.device)
    dys = dys.to(dt)
    dxw = [None] * n_t
    for t in reversed(range(n_t)):
        h_prev = (h0 if t == 0 else ys[t - 1]).float()
        c_prev = (c0 if t == 0 else cs[t - 1]).float() if lstm else None
        dg_x, dg_h, dh_dir, dc = _bwd_step(
            mode, xw[t].float(), h_prev @ w.t(), b, h_prev, c_prev,
            cs[t].float() if lstm else None, ys[t].float(),
            dys[t].float(), dh, dc)
        dxw[t] = dg_x.to(dt)
        dh_mat = dg_h @ w
        dh = dh_dir + dh_mat if dh_dir is not None else dh_mat
        dw += dg_h.t() @ h_prev
        db += dg_h.sum(0)
    return (torch.stack(dxw), dh.to(dt), dc.to(dt) if lstm else None,
            dw.to(w_hh.dtype), db.to(b_hh.dtype))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_scan(name, xw, h0, c0, w_hh, b_hh, mode, own_weights=False):
    """Raise unless the kernels take these operands → (T, N, H). With
    ``own_weights`` (the decode step) W_hh and b_hh may be float32 or
    bfloat16 whatever xw's dtype; else every operand is in xw's."""
    why = scan_supported(xw, h0, c0, mode)
    if why is not None:
        raise MXNetError(f"{name}: {why}")
    lstm = mode == "lstm"
    others = [h0, w_hh, b_hh] + ([c0] if lstm else [])
    check_cuda_operands(name, xw, *others)
    n_t, n, gh = xw.shape
    g = GATES[mode]
    if gh % g:
        raise MXNetError(f"{name}: xw's last axis {gh} is not {g} gates")
    h = gh // g
    want = {"h0": (h0, (n, h)), "w_hh": (w_hh, (gh, h)),
            "b_hh": (b_hh, (gh,))}
    if lstm:
        if c0 is None:
            raise MXNetError(f"{name}: lstm needs c0")
        want["c0"] = (c0, (n, h))
    for what, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise MXNetError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if own_weights and what in ("w_hh", "b_hh"):
            if t.dtype not in DTYPE_CODES:
                raise MXNetError(f"{name}: {what} is {t.dtype}: no kernel "
                                 "(float32, bfloat16)")
        elif t.dtype != xw.dtype:
            raise MXNetError(f"{name}: {what} is {t.dtype}, xw {xw.dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"{name}: the kernel takes contiguous tensors "
                             f"({what} is not)")
    return n_t, n, h


def rnn_scan_fwd(xw, h0, c0, w_hh, b_hh, mode: str):
    """Forward of the recurrence → (ys, cs|None). A CUDA tensor launches
    the ``rnn_scan_fwd`` kernel (contiguous float32 or bfloat16 operands
    of one dtype, else it raises; any T, N, H); a CPU tensor runs
    :func:`rnn_scan_plain`."""
    if xw.device.type == "cpu":
        count_plain()
        return rnn_scan_plain(xw, h0, c0, w_hh, b_hh, mode)
    n_t, n, h = _check_scan("rnn_scan_fwd", xw, h0, c0, w_hh, b_hh, mode)
    lstm = mode == "lstm"
    ys = torch.empty(n_t, n, h, dtype=xw.dtype, device=xw.device)
    cs = torch.empty_like(ys) if lstm else None
    w = w_hh.float().contiguous()
    b = b_hh.float().contiguous()
    launch("rnn_scan_fwd", xw.device, xw.data_ptr(), h0.data_ptr(),
           c0.data_ptr() if lstm else None, w.data_ptr(), b.data_ptr(),
           ys.data_ptr(), cs.data_ptr() if lstm else None, n_t, n, h,
           MODE_CODES[mode], DTYPE_CODES[xw.dtype], dtype=xw.dtype,
           flops=2.0 * n_t * n * w.shape[0] * h)
    return ys, cs


def rnn_scan_bwd(xw, h0, c0, w_hh, b_hh, ys, cs, dys, dc_t, mode: str):
    """Backward of the recurrence → (dxw, dh0, dc0|None, dw, db). A CUDA
    tensor launches the ``rnn_scan_bwd`` kernel (its reverse-time walk and
    the dW/db sums, one launch counted), raising as :func:`rnn_scan_fwd`;
    a CPU tensor runs :func:`rnn_scan_bwd_plain`."""
    if xw.device.type == "cpu":
        count_plain()
        return rnn_scan_bwd_plain(xw, h0, c0, w_hh, b_hh, ys, cs, dys, dc_t,
                                  mode)
    n_t, n, h = _check_scan("rnn_scan_bwd", xw, h0, c0, w_hh, b_hh, mode)
    lstm = mode == "lstm"
    g = GATES[mode]
    dys = dys.to(xw.dtype).contiguous()
    if tuple(dys.shape) != (n_t, n, h):
        raise MXNetError(f"rnn_scan_bwd: dys {tuple(dys.shape)}, expected "
                         f"{(n_t, n, h)}")
    dev = xw.device
    w = w_hh.float().contiguous()
    b = b_hh.float().contiguous()
    dh_s = torch.zeros(n, h, dtype=torch.float32, device=dev)
    # the kernel updates the cell carry in place: always a fresh copy
    dc_s = dc_t.to(xw.dtype).to(torch.float32, copy=True).contiguous() \
        if lstm else None
    dxw = torch.empty_like(xw)
    dhw = torch.empty(n_t, n, g * h, dtype=torch.float32, device=dev)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0) if lstm else None
    dw = torch.empty(g * h, h, dtype=xw.dtype, device=dev)
    db = torch.empty(g * h, dtype=xw.dtype, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    launch("rnn_scan_bwd", dev, xw.data_ptr(), h0.data_ptr(), ptr(c0),
           w.data_ptr(), b.data_ptr(), ys.data_ptr(), ptr(cs),
           dys.data_ptr(), dh_s.data_ptr(), ptr(dc_s), dxw.data_ptr(),
           dhw.data_ptr(), dh0.data_ptr(), ptr(dc0), dw.data_ptr(),
           db.data_ptr(), n_t, n, h, MODE_CODES[mode],
           DTYPE_CODES[xw.dtype], dtype=xw.dtype,
           flops=6.0 * n_t * n * w.shape[0] * h)
    return dxw, dh0, dc0, dw.to(w_hh.dtype), db.to(b_hh.dtype)


def _plan_query(entry: str, n: int, h: int, mode: str, dtype, device,
                size: int):
    if dtype not in DTYPE_CODES or mode not in MODE_CODES:
        raise MXNetError(f"{entry}: no kernel for {mode!r} in {dtype}")
    out = (ctypes.c_int * size)()
    with torch.cuda.device(device):
        sync_smem_budget(device)
        err = getattr(library(), "mxt_" + entry)(
            n, h, MODE_CODES[mode], DTYPE_CODES[dtype], out)
    if err != 0:
        what = library().mxt_error_string(err).decode()
        raise MXNetError(f"{entry}: CUDA error {err} ({what})")
    return list(out)


def rnn_fwd_plan(n: int, h: int, mode: str,
                 dtype: torch.dtype = torch.float32, device=None) -> dict:
    """The tile that ``rnn_scan_fwd`` takes for batch ``n`` and hidden size
    ``h`` on the CUDA ``device`` (the current one by default): batch rows
    and hidden units a tile, tiles, blocks, the most tiles a block takes a
    step, whether W_hh's rows of a tile sit in shared memory (else the
    product reads them through L2), and the columns of h staged at once
    (``h``: whole rows). A query: it launches nothing and counts nothing."""
    o = _plan_query("rnn_fwd_plan", n, h, mode, dtype, device, 7)
    return {"rows": o[0], "units": o[1], "tiles": o[2], "blocks": o[3],
            "tiles_per_block": o[4], "w_in_smem": bool(o[5]),
            "k_chunk": o[6]}


def rnn_bwd_walk_plan(n: int, h: int, mode: str,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> dict:
    """The plan that ``rnn_scan_bwd``'s reverse-time walk takes for batch
    ``n`` and hidden size ``h`` on the CUDA ``device`` (the current one by
    default): hidden units and batch rows a tile, blocks, whether W_hh's
    column slice sits in shared memory (else the walk reads it through
    L2), tiles, and the most tiles a block takes a step (more than one
    where no grid of one tile a block can be resident). A query: it
    launches nothing and counts nothing."""
    o = _plan_query("rnn_bwd_walk_plan", n, h, mode, dtype, device, 6)
    return {"units": o[0], "rows": o[1], "blocks": o[2],
            "w_in_smem": bool(o[3]), "tiles": o[4], "tiles_per_block": o[5]}


# ---------------------------------------------------------------------------
# autograd Functions, one per carry family
# ---------------------------------------------------------------------------

class _ScanLSTM(torch.autograd.Function):
    """→ (ys, c_T): the final cell state, not its trajectory, so that c_T's
    cotangent seeds the backward's cell carry at t = T-1."""

    @staticmethod
    def forward(ctx, xw, h0, c0, w_hh, b_hh):
        ys, cs = rnn_scan_fwd(xw, h0, c0, w_hh, b_hh, "lstm")
        ctx.save_for_backward(xw, h0, c0, w_hh, b_hh, ys, cs)
        return ys, cs[-1]

    @staticmethod
    @once_differentiable
    def backward(ctx, dys, dc_t):
        xw, h0, c0, w_hh, b_hh, ys, cs = ctx.saved_tensors
        if dys is None:
            dys = torch.zeros_like(ys)
        if dc_t is None:
            dc_t = torch.zeros_like(c0)
        return rnn_scan_bwd(xw, h0, c0, w_hh, b_hh, ys, cs, dys, dc_t,
                            "lstm")


class _ScanNoC(torch.autograd.Function):
    """→ ys, for the carry families without a cell state (GRU, RNN)."""

    @staticmethod
    def forward(ctx, xw, h0, w_hh, b_hh, mode):
        ys, _ = rnn_scan_fwd(xw, h0, None, w_hh, b_hh, mode)
        ctx.save_for_backward(xw, h0, w_hh, b_hh, ys)
        ctx.mode = mode
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, dys):
        xw, h0, w_hh, b_hh, ys = ctx.saved_tensors
        dxw, dh0, _, dw, db = rnn_scan_bwd(xw, h0, None, w_hh, b_hh, ys,
                                           None, dys, None, ctx.mode)
        return dxw, dh0, dw, db, None


# ---------------------------------------------------------------------------
# single-step decode (inference only: no autograd)
# ---------------------------------------------------------------------------

def decode_supported(xw, h, c, mode: str) -> Optional[str]:
    """None when the decode kernel covers this call, else the reason (the
    JAX package's rule: a known mode, float32 or bfloat16, xw (N, G*H))."""
    if mode not in GATES:
        return f"unknown mode {mode!r}"
    if xw.dtype not in DTYPE_CODES:
        return f"dtype {xw.dtype} has no kernel (float32, bfloat16)"
    if xw.ndim != 2:
        return "expects (N, G*H): one timestep per call"
    return None


@plain_version("rnn_decode")
def rnn_decode_step_plain(xw, h, c, w_hh, b_hh, mode: str):
    """Plain version of one decode step → (h_new, c_new|None) in xw's
    dtype: the scan's ``_fwd_step`` on one position, so a token decoded
    step by step equals the same position of :func:`rnn_scan_plain`."""
    dt = xw.dtype
    hf = h.to(dt).float()
    cf = c.to(dt).float() if mode == "lstm" else None
    h_new, c_new = _fwd_step(mode, xw.float(), hf @ w_hh.float().t(),
                             b_hh.float(), hf, cf, dt)
    return h_new.to(dt), (c_new.to(dt) if c_new is not None else None)


#: the decode kernel's rows of W_hh a warp multiplies at once (W_hh in
#: registers; W_hh in shared memory) and most warps a block
#: (csrc/rnn_decode.cu MXT_DEC_RB, MXT_DEC_TMA_RB, MXT_DEC_MAX_WARPS)
DEC_ROWS_PER_WARP = 2
DEC_TMA_ROWS_PER_WARP = 4
DEC_MAX_WARPS = 16
#: the kernel's paths (csrc/rnn_decode.cu MxtDecPath)
DEC_PATHS = {"l2": 0, "staged": 1, "tma": 2}


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def _warps(rows: int, per_warp: int) -> dict:
    groups = -(-rows // per_warp)
    warps = min(DEC_MAX_WARPS, groups)
    return {"warps": warps, "threads": 32 * warps,
            "rows_per_warp": -(-groups // warps) * per_warp}


@functools.lru_cache(maxsize=256)
def _decode_plan(n: int, h: int, g: int, act_size: int, w_size: int,
                 sms: int, optin: int) -> dict:
    units = min(h, -(-h // sms))
    rows = g * units
    # the block's rows of W_hh and the batch's h both in shared memory (the
    # mxt_dec_tma_smem layout), where one group of the whole batch fits
    tma = (_a16(16 + 4 * rows * n) + _a16(act_size * n * h + 16)
           + g * _a16(w_size * units * h + 16))
    if tma <= optin:
        return dict(_warps(rows, DEC_TMA_ROWS_PER_WARP), units=units,
                    rows=rows, group_rows=n, groups=1, blocks=-(-h // units),
                    path="tma", staged=True, smem_bytes=tma, sms=sms)
    budget = optin // 4                 # floats of shared memory a block
    staged, groups = True, 1
    while True:
        per = -(-n // groups)
        units = min(h, max(1, -(-h * groups // sms)))
        rows = g * units
        width = (h if staged else 0) + rows
        if per * width <= budget:
            break
        if staged and budget < h + rows:
            staged = False              # not one row of h fits a block
            continue
        groups = max(groups + 1, -(-n // max(1, budget // width)))
    return dict(_warps(rows, DEC_ROWS_PER_WARP), units=units, rows=rows,
                group_rows=per, groups=-(-n // per),
                blocks=-(-h // units) * -(-n // per),
                path="staged" if staged else "l2", staged=staged,
                smem_bytes=4 * per * width, sms=sms)


def rnn_decode_plan(n: int, h: int, mode: str,
                    dtype: torch.dtype = torch.float32, device=None,
                    w_dtype: Optional[torch.dtype] = None) -> dict:
    """The launch of the ``rnn_decode`` kernel for batch ``n`` and hidden
    size ``h`` on ``device`` (an H100's limits where there is no card).
    Plain Python: it launches nothing, and the wrapper launches what it
    says. ``units`` hidden units a block (all gates of each: ``rows`` rows
    of W_hh), chosen so that a group's blocks are about the card's SM
    count; ``warps`` / ``threads`` a block and ``rows_per_warp`` (at most
    DEC_MAX_WARPS warps a block); the batch in ``groups`` of
    ``group_rows`` rows; the ``path``: ``"tma"`` where the block's rows of
    W_hh (in ``w_dtype``, xw's ``dtype`` by default) and the whole batch's
    h fit shared memory (bulk copies; DEC_TMA_ROWS_PER_WARP rows a warp
    at once), else ``"staged"`` (h staged in shared memory, W_hh through
    registers, DEC_ROWS_PER_WARP rows a warp) or, where not one row of h
    fits a block, ``"l2"`` (h read through L2); ``staged`` (h in shared
    memory), ``blocks``, ``smem_bytes`` and ``sms``."""
    w_dtype = dtype if w_dtype is None else w_dtype
    if mode not in GATES or dtype not in DTYPE_CODES \
            or w_dtype not in DTYPE_CODES:
        raise MXNetError(f"rnn_decode_plan: no kernel for {mode!r} in "
                         f"{dtype} (W_hh {w_dtype})")
    if n < 1 or h < 1:
        raise MXNetError(f"rnn_decode_plan: N {n}, H {h}")
    return dict(_decode_plan(int(n), int(h), GATES[mode], dtype.itemsize,
                             w_dtype.itemsize, *plan_limits(device)))


def rnn_decode_step(xw, h, c, w_hh, b_hh, mode: str):
    """ONE recurrence step from a precomputed input projection ``xw``
    (N, G*H) → ``(h_new, c_new|None)``, new tensors in xw's dtype. A CUDA
    tensor launches the ``rnn_decode`` kernel as :func:`rnn_decode_plan`
    plans it (contiguous operands; xw, h and c float32 or bfloat16 of one
    dtype, W_hh float32 or bfloat16 read as it is, b_hh taken in W_hh's
    dtype; else it raises; any N and H); a CPU tensor runs
    :func:`rnn_decode_step_plain`. Inference only: no gradient."""
    why = decode_supported(xw, h, c, mode)
    if why is not None and not (xw.device.type == "cpu" and "dtype" in why):
        raise MXNetError(f"rnn_decode_step: {why}")
    if xw.device.type == "cpu":
        count_plain()
        return rnn_decode_step_plain(xw, h, c, w_hh, b_hh, mode)
    _, n, h_dim = _check_scan("rnn_decode_step", xw[None], h, c, w_hh, b_hh,
                              mode, own_weights=True)
    lstm = mode == "lstm"
    h_new = torch.empty(n, h_dim, dtype=xw.dtype, device=xw.device)
    c_new = torch.empty_like(h_new) if lstm else None
    b = b_hh.to(w_hh.dtype)
    plan = rnn_decode_plan(n, h_dim, mode, xw.dtype, xw.device, w_hh.dtype)
    launch("rnn_decode", xw.device, xw.data_ptr(), h.data_ptr(),
           c.data_ptr() if lstm else None, w_hh.data_ptr(), b.data_ptr(),
           h_new.data_ptr(), c_new.data_ptr() if lstm else None, n, h_dim,
           MODE_CODES[mode], DTYPE_CODES[xw.dtype], DTYPE_CODES[w_hh.dtype],
           plan["units"], plan["threads"], plan["group_rows"],
           DEC_PATHS[plan["path"]], dtype=xw.dtype,
           flops=2.0 * n * w_hh.shape[0] * h_dim)
    return h_new, c_new


def rnn_verify_scan(xw, h, c, w_hh, b_hh, mode: str, valid):
    """Masked multi-position scan for speculative-decode verification:
    the SAME single step as :func:`rnn_decode_step` (the kernel on the
    card) over K positions ``xw`` (K, N, G*H), the carry kept where
    ``valid`` (K, N) is False → the state trajectories ``(hs, cs|None)``,
    each (K, N, H)."""
    lstm = mode == "lstm"
    hs, cs = [], []
    for t in range(xw.shape[0]):
        h2, c2 = rnn_decode_step(xw[t], h, c, w_hh, b_hh, mode)
        vm = valid[t][:, None]
        h = torch.where(vm, h2, h)
        hs.append(h)
        if lstm:
            c = torch.where(vm, c2, c)
            cs.append(c)
    return torch.stack(hs), (torch.stack(cs) if lstm else None)


def rnn_scan(xw, h0, c0, w_hh, b_hh, mode: str, reverse: bool = False):
    """The recurrence of one RNN direction from precomputed input
    projections ``xw`` (T, N, G*H) → ``(ys, h_T, c_T|None)`` with ys in
    forward time order, differentiable in xw, h0, c0, w_hh and b_hh.
    ``reverse=True`` scans from the last step to the first (flip, scan,
    flip, as the JAX package does). On the CPU any float dtype runs the
    plain versions; on the card a dtype without a kernel raises."""
    why = scan_supported(xw, h0, c0, mode)
    if why is not None and not (xw.device.type == "cpu" and "dtype" in why):
        raise MXNetError(f"rnn_scan: {why}")
    if reverse:
        xw = torch.flip(xw, dims=(0,))
    if mode == "lstm":
        ys, c_t = _ScanLSTM.apply(xw, h0, c0, w_hh, b_hh)
    else:
        ys, c_t = _ScanNoC.apply(xw, h0, w_hh, b_hh, mode), None
    h_t = ys[-1]
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    return ys, h_t, c_t
