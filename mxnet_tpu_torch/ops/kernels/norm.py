"""LayerNorm and bias-GELU kernels (counterpart of
``mxnet_tpu/ops/kernels/norm.py``).

- :func:`layer_norm`: float32 two-pass statistics over the trailing axis,
  output in x's dtype (CUDA kernel ``csrc/layernorm_fwd.cu``); its
  backward :func:`layer_norm_bwd` (``csrc/layernorm_bwd.cu``) gives dx,
  and dgamma/dbeta summed over all rows in float32.
- :func:`bias_gelu`: exact (erf) ``gelu(x + b)`` over the trailing axis
  (CUDA kernel ``csrc/bias_gelu_fwd.cu``); its backward
  :func:`bias_gelu_bwd` (``csrc/bias_gelu_bwd.cu``) gives dx, and db
  summed over all rows in float32.

Each op is a ``torch.autograd.Function``: for a tensor on the CPU its
forward and backward run the plain PyTorch versions beside them
(``layer_norm_plain``, ``layer_norm_bwd_plain``, ``bias_gelu_plain``,
``bias_gelu_bwd_plain``); for a tensor on a CUDA device the kernels run,
raising on what a kernel does not take.
"""
from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from ...base import MXNetError
from . import (DTYPE_CODES, card_limits, check_cuda_operands, count_plain,
               launch, plain_version, plan_limits)

__all__ = ["layer_norm", "layer_norm_plain", "ln_fwd_plan",
           "layer_norm_bwd", "layer_norm_bwd_plain", "ln_bwd_plan",
           "bias_gelu", "bias_gelu_plain", "bias_gelu_bwd",
           "bias_gelu_bwd_plain", "bg_bwd_plan"]

_SQRT_HALF = math.sqrt(0.5)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)
#: widest C of the LayerNorm backward: a block's partials live in shared
#: memory
LN_BWD_MAX_C = 16384
#: the LayerNorm kernels' warp branch (a warp a row, forward and
#: backward): threads a block, and the widest C it takes with 16-byte
#: loads (by dtype) and with one element a load; wider rows take the
#: block branch (a block a row)
LN_WARP_THREADS = 128
LN_WARP_CAP = {torch.float32: 1024, torch.bfloat16: 2048}
LN_SCALAR_CAP = 1024
#: the block branch: most threads a block
LN_BLOCK_THREADS = 512
#: the forward's block branch keeps a row of up to this many bytes in
#: shared memory (``LNF_SMEM_CAP`` in ``csrc/layernorm_fwd.cu``)
LN_FWD_SMEM_CAP = 65536
#: the bias-GELU backward: threads a block (8 warps on rows 8 apart, each
#: lane on one pack of a tile's 32 packs of columns) and the blocks an SM
#: its launch bounds ask for (``BGB_MINB`` in ``csrc/bias_gelu_bwd.cu``)
BG_BWD_THREADS = 256
BG_BWD_BLOCKS_PER_SM = 3


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """Normalisation statistics are float32 even for bfloat16/float16
    activations (float64 stays float64)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _check_vector(name: str, t: torch.Tensor, c: int, what: str) -> None:
    if tuple(t.shape) != (c,):
        raise MXNetError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected ({c},)")


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def _ln_stats(xf):
    """mean and var over the trailing axis: the mean, then the mean of
    squared deviations (two passes, as ``jnp.var``)."""
    mean = xf.mean(dim=-1, keepdim=True)
    d = xf - mean
    return mean, (d * d).mean(dim=-1, keepdim=True)


@plain_version("layernorm_fwd")
def layer_norm_plain(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the trailing axis, statistics in float32."""
    dt = stat_dtype(x)
    xf = x.to(dt)
    mean, var = _ln_stats(xf)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * gamma.to(dt) + beta.to(dt)).to(x.dtype)


@plain_version("layernorm_bwd")
def layer_norm_bwd_plain(x, gamma, dy, eps: float = 1e-5):
    """Plain version of the LayerNorm backward kernel → (dx, dgamma,
    dbeta): statistics recomputed from x as in the forward, dy taken in
    x's dtype, dx in x's dtype, dgamma and dbeta summed over all rows in
    float32 and returned in gamma's dtype."""
    dt = stat_dtype(x)
    xf = x.to(dt)
    dyf = dy.to(x.dtype).to(dt)
    mean, var = _ln_stats(xf)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    rows = dyf.reshape(-1, x.shape[-1])
    dg = (rows * xhat.reshape(rows.shape)).sum(0)
    db = rows.sum(0)
    dxhat = dyf * gamma.to(dt)
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return dx.to(x.dtype), dg.to(gamma.dtype), db.to(gamma.dtype)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor, converted only if it is not
    one already."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def _ln_layout(c: int, dtype: torch.dtype, aligned: bool):
    """(vec, packs) of a LayerNorm kernel's row of ``c`` columns: 16-byte
    loads where C and the pointers allow, else one element a load; a
    lane's loads a row in the warp branch (rounded up to 8 single
    elements), or 0 past its cap (the block branch)."""
    wide = 16 // dtype.itemsize
    vec = wide if aligned and c % wide == 0 else 1
    if c > (LN_WARP_CAP[dtype] if vec > 1 else LN_SCALAR_CAP):
        return vec, 0
    packs = -(-c // (32 * vec))
    return vec, -(-packs // 8) * 8 if vec == 1 else packs


def _ln_block_threads(c: int, vec: int) -> int:
    """Threads a block of the block branch (the backward's rule)."""
    return min(LN_BLOCK_THREADS, max(32, -(-c // vec + 31) // 32 * 32))


def _ln_fwd_blocks_per_sm(dtype: torch.dtype, vec: int, packs: int) -> int:
    """Blocks an SM of the forward's warp branch: the register estimate of
    ``LnFwdCfg`` in ``csrc/layernorm_fwd.cu``, from what a lane holds (its
    packs of the row as loaded, and the rest)."""
    row = -(-packs * vec * dtype.itemsize // 4)
    regs = (row + 40 + 7) // 8 * 8
    return max(1, min(16, 65536 // (LN_WARP_THREADS * regs)))


def ln_fwd_plan(rows: int, c: int, dtype: torch.dtype = torch.float32,
                device=None, aligned: bool = True) -> dict:
    """The launch of the ``layernorm_fwd`` kernel for ``rows`` rows of
    ``c`` columns in ``dtype`` on ``device`` (an H100's SM count where
    there is no card; ``aligned``: x, out, gamma and beta start on 16
    bytes). Plain Python: it launches nothing, and the wrapper launches
    what it says. No C is refused.

    - ``branch`` ``"warp"`` (a warp a row, C up to ``LN_WARP_CAP`` with
      16-byte loads, ``LN_SCALAR_CAP`` with one element a load) or
      ``"block"`` (a block a row; ``cached``: the row kept in shared
      memory, up to ``LN_FWD_SMEM_CAP`` bytes);
    - ``vec`` elements a load, ``packs`` loads a lane a row (0 in the
      block branch);
    - ``threads`` and ``warps`` a block, ``blocks_per_sm`` (what the warp
      kernel's launch bounds ask for), ``blocks`` (a persistent grid of
      at most that many an SM), ``rows_per_warp`` or ``rows_per_block``
      (the most any takes), ``smem_bytes`` a block and ``sms``."""
    if dtype not in DTYPE_CODES:
        raise MXNetError(f"ln_fwd_plan: no kernel in {dtype}")
    if c < 1 or rows < 1:
        raise MXNetError(f"ln_fwd_plan: rows {rows}, C {c}")
    sms, optin = plan_limits(device)
    vec, packs = _ln_layout(c, dtype, aligned)
    if packs:
        warps = LN_WARP_THREADS // 32
        per_sm = _ln_fwd_blocks_per_sm(dtype, vec, packs)
        blocks = min(-(-rows // warps), sms * per_sm)
        return {"branch": "warp", "vec": vec, "packs": packs,
                "threads": LN_WARP_THREADS, "warps": warps,
                "blocks_per_sm": per_sm, "blocks": blocks,
                "rows_per_warp": -(-rows // (blocks * warps)),
                "smem_bytes": 0, "sms": sms}
    cached = c * dtype.itemsize <= LN_FWD_SMEM_CAP
    smem = -(-c * dtype.itemsize // 16) * 16 if cached else 0
    threads = _ln_block_threads(c, vec)
    per_sm = max(1, min(2048 // threads, optin // (smem + 1024)))
    blocks = min(rows, sms * per_sm)
    return {"branch": "block", "vec": vec, "packs": 0, "cached": cached,
            "threads": threads, "warps": threads // 32,
            "blocks_per_sm": per_sm, "blocks": blocks,
            "rows_per_block": -(-rows // blocks), "smem_bytes": smem,
            "sms": sms}


def _ln_fwd_kernel(x, gamma, beta, eps):
    check_cuda_operands("layer_norm", x, gamma, beta)
    if x.ndim < 1:
        raise MXNetError("layer_norm: expects at least one axis")
    c = int(x.shape[-1])
    _check_vector("layer_norm", gamma, c, "gamma")
    _check_vector("layer_norm", beta, c, "beta")
    out = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return out
    g, b = _f32(gamma), _f32(beta)
    plan = ln_fwd_plan(rows, c, x.dtype, x.device, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, out, g, b)))
    launch("layernorm_fwd", x.device, x.data_ptr(), g.data_ptr(),
           b.data_ptr(), out.data_ptr(), rows, c, float(eps),
           DTYPE_CODES[x.dtype], plan["vec"], plan["packs"], plan["threads"],
           plan["blocks"], dtype=x.dtype, flops=8.0 * x.numel())
    return out


def _ln_warp_blocks_per_sm(vec: int, packs: int) -> int:
    """Blocks an SM of the warp branch: the register estimate of
    ``LnWarpCfg`` in ``csrc/layernorm_bwd.cu``, from what a lane holds
    (x and dy of a row as floats, the float32 dgamma/dbeta partials of its
    columns, and the rest)."""
    regs = (4 * packs * vec + (24 if vec > 1 else 40) + 7) // 8 * 8
    return max(1, min(16, 65536 // (LN_WARP_THREADS * regs)))


def ln_bwd_plan(rows: int, c: int, dtype: torch.dtype = torch.float32,
                device=None, aligned: bool = True) -> dict:
    """The launch of the ``layernorm_bwd`` kernel for ``rows`` rows of
    ``c`` columns in ``dtype`` on ``device`` (an H100's SM count where
    there is no card; ``aligned``: x, dy, dx and gamma start on 16
    bytes). Plain Python: it launches nothing, and the wrapper launches
    what it says.

    - ``branch`` ``"warp"`` (a warp a row, C up to ``LN_WARP_CAP`` with
      16-byte loads, ``LN_SCALAR_CAP`` with one element a load) or
      ``"block"`` (a block a row, up to ``LN_BWD_MAX_C``);
    - ``vec`` elements a load, ``packs`` loads a lane a row (0 in the
      block branch);
    - ``threads`` and ``warps`` a block, ``blocks_per_sm`` (what the warp
      kernel's launch bounds ask for), ``blocks`` (= the column partials
      the second pass sums), ``rows_per_warp`` or ``rows_per_block`` (the
      most any takes), ``smem_bytes`` a block and ``sms``."""
    if dtype not in DTYPE_CODES:
        raise MXNetError(f"ln_bwd_plan: no kernel in {dtype}")
    if not 0 < c <= LN_BWD_MAX_C or rows < 1:
        raise MXNetError(f"ln_bwd_plan: rows {rows}, C {c} (1 <= C <= "
                         f"{LN_BWD_MAX_C})")
    sms, optin = card_limits(device)
    vec, packs = _ln_layout(c, dtype, aligned)
    smem = 4 * 2 * c
    plan = {"vec": vec, "smem_bytes": smem, "sms": sms}
    if packs:
        per_sm = _ln_warp_blocks_per_sm(vec, packs)
        warps = LN_WARP_THREADS // 32
        per_warp = -(-rows // (sms * per_sm * warps))
        blocks = -(-(-(-rows // per_warp)) // warps)
        nw = blocks * warps
        return dict(plan, branch="warp", packs=packs,
                    threads=LN_WARP_THREADS, warps=warps,
                    blocks_per_sm=per_sm, blocks=blocks,
                    rows_per_warp=-(-rows // nw))
    threads = _ln_block_threads(c, vec)
    per_sm = max(1, min(2048 // threads, optin // (smem + 1024)))
    blocks = min(rows, sms * per_sm)
    return dict(plan, branch="block", packs=0, threads=threads,
                warps=threads // 32, blocks_per_sm=per_sm, blocks=blocks,
                rows_per_block=-(-rows // blocks))


def layer_norm_bwd(x, gamma, dy, eps: float = 1e-5):
    """LayerNorm backward → (dx, dgamma, dbeta). A CUDA tensor launches
    the ``layernorm_bwd`` kernel as :func:`ln_bwd_plan` plans it
    (contiguous float32 or bfloat16 x, C <= 16384, else it raises); a CPU
    tensor runs :func:`layer_norm_bwd_plain`."""
    if x.device.type == "cpu":
        count_plain()
        return layer_norm_bwd_plain(x, gamma, dy, eps)
    dy = dy.to(x.dtype).contiguous()
    check_cuda_operands("layer_norm_bwd", x, gamma, dy)
    c = int(x.shape[-1]) if x.ndim else 0
    _check_vector("layer_norm_bwd", gamma, c, "gamma")
    if dy.shape != x.shape:
        raise MXNetError(f"layer_norm_bwd: dy {tuple(dy.shape)} and x "
                         f"{tuple(x.shape)} disagree")
    if c > LN_BWD_MAX_C:
        raise MXNetError(f"layer_norm_bwd: C {c} > {LN_BWD_MAX_C}")
    rows = x.numel() // c if c else 0
    dx = torch.empty_like(x)
    if not rows:
        dgb = torch.zeros(2, c, dtype=torch.float32, device=x.device)
        return dx, dgb[0].to(gamma.dtype), dgb[1].to(gamma.dtype)
    dgb = torch.empty(2, c, dtype=torch.float32, device=x.device)
    g = _f32(gamma)
    plan = ln_bwd_plan(rows, c, x.dtype, x.device, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, dy, dx, g)))
    part = torch.empty(plan["blocks"], 2, c, dtype=torch.float32,
                       device=x.device)
    launch("layernorm_bwd", x.device, x.data_ptr(), g.data_ptr(),
           dy.data_ptr(), dx.data_ptr(), part.data_ptr(), dgb[0].data_ptr(),
           dgb[1].data_ptr(), rows, c, float(eps), DTYPE_CODES[x.dtype],
           plan["vec"], plan["packs"], plan["threads"], plan["blocks"],
           dtype=x.dtype, flops=14.0 * x.numel())
    return dx, dgb[0].to(gamma.dtype), dgb[1].to(gamma.dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        if x.device.type == "cpu":
            count_plain()
            out = layer_norm_plain(x, gamma, beta, eps)
        else:
            out = _ln_fwd_kernel(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x, gamma, dy, ctx.eps)
        return dx, dg, db, None


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """Fused LayerNorm over the trailing axis (float32 statistics, output
    in x's dtype), differentiable in x, gamma and beta."""
    return _LayerNorm.apply(x, gamma, beta, float(eps))


# ---------------------------------------------------------------------------
# bias-GELU
# ---------------------------------------------------------------------------

@plain_version("bias_gelu_fwd")
def bias_gelu_plain(x, b):
    """``gelu(x + b)``, exact erf form: z = x + b in x's dtype, then
    0.5 * z * erfc(-z / sqrt(2)) in float32, written in x's dtype."""
    z = (x + b.to(x.dtype)).to(stat_dtype(x))
    return (0.5 * z * torch.erfc(-z * _SQRT_HALF)).to(x.dtype)


@plain_version("bias_gelu_bwd")
def bias_gelu_bwd_plain(x, b, dy):
    """Plain version of the JAX package's bias-GELU backward kernel →
    (dx, db): z = x + b, dx = dy * (Phi(z) + z * phi(z)) in float32
    written in x's dtype, db = the float32 column sums of dx in b's
    dtype."""
    dt = stat_dtype(x)
    z = (x + b.to(x.dtype)).to(dt)
    phi = torch.exp(-0.5 * z * z) * _INV_SQRT2PI
    cdf = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    dx = dy.to(x.dtype).to(dt) * (cdf + z * phi)
    db = dx.reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), db.to(b.dtype)


def bg_bwd_plan(rows: int, c: int, dtype: torch.dtype = torch.float32,
                device=None, aligned: bool = True) -> dict:
    """The launch of the ``bias_gelu_bwd`` kernel for ``rows`` rows of
    ``c`` columns in ``dtype`` on ``device`` (an H100's SM count where
    there is no card; ``aligned``: x, dy and dx start on 16 bytes). Plain
    Python: it launches nothing, and the wrapper launches what it says.
    No C is refused.

    - ``vec`` elements a load (16 bytes, or one element when C or a
      pointer does not allow it);
    - a grid of ``tiles`` column tiles (32 loads of ``vec`` columns) x
      ``chunks`` row chunks of ``rows_per_chunk`` rows: at most one wave
      of ``blocks_per_sm`` blocks an SM (one chunk where the tiles alone
      fill it), no chunk empty, and no warp without a row;
    - ``threads`` and ``warps`` a block, ``blocks`` (= tiles x chunks),
      ``rows_per_warp`` (the most any warp walks), ``partial_bytes`` (the
      float32 column partials the second pass sums) and ``sms``."""
    if dtype not in DTYPE_CODES:
        raise MXNetError(f"bg_bwd_plan: no kernel in {dtype}")
    if c < 1 or rows < 1:
        raise MXNetError(f"bg_bwd_plan: rows {rows}, C {c}")
    sms, _ = plan_limits(device)
    wide = 16 // dtype.itemsize
    vec = wide if aligned and c % wide == 0 else 1
    tiles = -(-c // (32 * vec))
    warps = BG_BWD_THREADS // 32
    chunks = max(1, min(sms * BG_BWD_BLOCKS_PER_SM // tiles,
                        -(-rows // warps)))
    per_chunk = -(-rows // chunks)
    chunks = -(-rows // per_chunk)
    return {"vec": vec, "tiles": tiles, "chunks": chunks,
            "rows_per_chunk": per_chunk, "blocks": tiles * chunks,
            "threads": BG_BWD_THREADS, "warps": warps,
            "blocks_per_sm": BG_BWD_BLOCKS_PER_SM,
            "rows_per_warp": -(-per_chunk // warps),
            "partial_bytes": 4 * chunks * c, "sms": sms}


def bias_gelu_bwd(x, b, dy):
    """bias-GELU backward → (dx, db). A CUDA tensor launches the
    ``bias_gelu_bwd`` kernel as :func:`bg_bwd_plan` plans it (contiguous
    float32 or bfloat16 x, else it raises; db written in b's dtype); a
    CPU tensor runs :func:`bias_gelu_bwd_plain`."""
    if x.device.type == "cpu":
        count_plain()
        return bias_gelu_bwd_plain(x, b, dy)
    dy = dy.to(x.dtype).contiguous()
    check_cuda_operands("bias_gelu_bwd", x, b, dy)
    c = int(x.shape[-1]) if x.ndim else 0
    _check_vector("bias_gelu_bwd", b, c, "b")
    if dy.shape != x.shape:
        raise MXNetError(f"bias_gelu_bwd: dy {tuple(dy.shape)} and x "
                         f"{tuple(x.shape)} disagree")
    rows = x.numel() // c if c else 0
    dx = torch.empty_like(x)
    # the kernel reads b and writes db in b's dtype where it has one
    bb = (b if b.dtype in DTYPE_CODES else b.to(x.dtype)).contiguous()
    if not rows:
        return dx, torch.zeros(c, dtype=b.dtype, device=x.device)
    db = torch.empty(c, dtype=bb.dtype, device=x.device)
    plan = bg_bwd_plan(rows, c, x.dtype, x.device, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, dy, dx)))
    part = torch.empty(plan["chunks"], c, dtype=torch.float32,
                       device=x.device)
    launch("bias_gelu_bwd", x.device, x.data_ptr(), bb.data_ptr(),
           dy.data_ptr(), dx.data_ptr(), part.data_ptr(), db.data_ptr(),
           rows, c, DTYPE_CODES[x.dtype], DTYPE_CODES[bb.dtype],
           plan["vec"], plan["tiles"], plan["chunks"],
           plan["rows_per_chunk"], dtype=x.dtype, flops=25.0 * x.numel())
    return dx, db.to(b.dtype)


def _bg_fwd_kernel(x, b):
    check_cuda_operands("bias_gelu", x, b)
    c = int(x.shape[-1]) if x.ndim else 0
    _check_vector("bias_gelu", b, c, "b")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    bb = b.to(x.dtype).contiguous()
    launch("bias_gelu_fwd", x.device, x.data_ptr(), bb.data_ptr(),
           out.data_ptr(), x.numel(), c, DTYPE_CODES[x.dtype], dtype=x.dtype,
           flops=20.0 * x.numel())
    return out


class _BiasGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b):
        if x.device.type == "cpu":
            count_plain()
            out = bias_gelu_plain(x, b)
        else:
            out = _bg_fwd_kernel(x, b)
        ctx.save_for_backward(x, b)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, b = ctx.saved_tensors
        return bias_gelu_bwd(x, b, dy)


def bias_gelu(x, b):
    """Fused ``gelu(x + b)`` (exact erf form) over the trailing axis."""
    return _BiasGelu.apply(x, b)
