"""Attention ops (counterpart of ``mxnet_tpu/ops/attention.py``).

Inputs are (batch, heads, seq, head_dim), as in the JAX package. The
softmax scale defaults to head_dim**-0.5; masking uses the finite value
-1e30, and a query row with no valid key outputs exactly zero on every
path of this module.

- :func:`flash_attention`: a ``torch.autograd.Function`` whose forward
  is, on a CUDA tensor, the kernel ``csrc/flash_fwd.cu`` (online softmax
  over key tiles, returning the per-row log-sum-exp beside the output)
  and whose backward is ``csrc/flash_bwd_fused.cu`` up to 512 positions,
  else the dq and dkv kernels of ``csrc/flash_bwd.cu`` (P rebuilt from
  the saved lse; :func:`flash_bwd_plan` shows their tiles); on a CPU
  tensor the plain versions
  :func:`flash_attention_fwd_plain` and :func:`flash_attention_bwd_plain`
  run in the same Function. With ``valid_length`` (a per-sample key
  count) it runs the blockwise PyTorch path on either device, as the JAX
  package runs that case outside its Pallas kernels.
- :func:`attention_reference`: unfused softmax(QK^T)V, the oracle and
  the path for an arbitrary additive mask.
- :func:`paged_decode_attention`: one query token per slot over a paged
  K/V cache (page gather, then the blockwise path), for decode.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..base import MXNetError
from .kernels import (DTYPE_CODES, causal_pairs, check_cuda_operands,
                      count_plain, launch, library, plain_version)

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_bwd_fused", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_bwd_plan", "attention_reference",
           "paged_decode_attention"]

NEG_INF = -1e30  # finite mask value: keeps exp() NaN-free for masked rows
MAX_HEAD_DIM = 128
#: longest Sq and Sk of the fused backward kernel (the JAX package's
#: 512-row block: one block per head there)
FUSED_BWD_MAX_SEQ = 512
#: keys per block of the blockwise (``valid_length``) path
BLOCK_K = 512


def _default_scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    """(sq, sk) bool: key j is visible to query i iff j <= i + (sk - sq)
    (the causal diagonal aligned to the end)."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(
        diagonal=sk - sq)


def attention_reference(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None, mask=None):
    """Unfused softmax(QK^T)V in float32. ``mask`` is an additive float
    mask broadcastable to (B, H, Sq, Sk)."""
    sm_scale = _default_scale(q, sm_scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if mask is not None:
        s = s + mask.float()
    if causal:
        s = torch.where(_causal_keep(s.shape[-2], s.shape[-1], s.device),
                        s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.matmul(p, v.float())
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.where(m > NEG_INF / 2, out, 0.0)  # fully-masked rows → 0
    return out.to(q.dtype)


def attention_blockwise(q, k, v, causal: bool, sm_scale: float,
                        valid_length=None):
    """Online-softmax attention over blocks of ``BLOCK_K`` keys (the
    counterpart of ``_attention_xla``): O(Sq * BLOCK_K) live memory.
    ``valid_length`` is an optional (B,) per-sample key count."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    block_k = max(1, min(BLOCK_K, sk))
    qf = q.float() * sm_scale
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    acc = torch.zeros(b, h, sq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, sq, dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, block_k):
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k].float()
        s = torch.matmul(qf, kb.transpose(-1, -2))
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        valid = torch.ones(1, 1, 1, kb.shape[2], dtype=torch.bool,
                           device=q.device)
        if causal:
            valid = valid & (k_pos[None, :] <= q_pos[:, None])
        if valid_length is not None:
            vl = valid_length.to(device=q.device, dtype=torch.float32)
            valid = valid & (k_pos[None, None, None, :]
                             < vl[:, None, None, None])
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = torch.where((m > NEG_INF / 2)[..., None], out, 0.0)
    return out.to(q.dtype)


@plain_version("flash_fwd")
def flash_attention_fwd_plain(q, k, v, causal: bool = False,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward kernel → (out, lse): scores in
    float32, P rounded to V's dtype before the PV product, a row with no
    valid key gives out 0 and lse -1e30."""
    sm_scale = _default_scale(q, sm_scale)
    sq, sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        s = torch.where(_causal_keep(sq, sk, s.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True) if sk else \
        torch.full(s.shape[:-1] + (1,), NEG_INF, device=s.device)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    seen = m > NEG_INF / 2
    out = torch.where(seen, acc / l, 0.0).to(q.dtype)
    lse = torch.where(seen, m + torch.log(l), NEG_INF)[..., 0]
    return out, lse


def _check_flash_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise MXNetError("flash_attention expects (batch, heads, seq, dim)")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise MXNetError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")


def _check_cuda_attention(q, *others):
    check_cuda_operands("flash_attention", q, *others)
    for t in others:
        if t.dtype != q.dtype or not t.is_contiguous():
            raise MXNetError("flash_attention: q, k, v (and dO) must be "
                             "contiguous and of one dtype")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention: head_dim {q.shape[-1]} > "
                         f"{MAX_HEAD_DIM}")


def _products(q, k, causal: bool, n: int) -> float:
    """FLOPs of ``n`` (B, H, Sq, D) x (B, H, D, Sk)-sized products over
    the (query, key) pairs the mask keeps: a flash kernel's work (the
    forward 2, QK^T and PV; the fused backward 5, dq 3, dkv 4)."""
    b, h, sq, d = q.shape
    return 2.0 * d * b * h * causal_pairs(sq, k.shape[2], causal) * n


def _flash_fwd_kernel(q, k, v, causal: bool, sm_scale: float):
    """(out, lse) from the ``flash_fwd`` kernel (CUDA tensors)."""
    _check_cuda_attention(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    launch("flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), lse.data_ptr(), b * h, sq, sk, d, int(causal),
           sm_scale, DTYPE_CODES[q.dtype], dtype=q.dtype,
           flops=functools.partial(_products, q, k, causal, 2))
    return out, lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

@plain_version(lambda q, k, *a, **kw: "flash_bwd_fused"
               if uses_fused_bwd(q.shape[2], k.shape[2]) else "flash_bwd")
def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = False,
                              sm_scale: Optional[float] = None):
    """Plain version of the flash backward kernels → (dq, dk, dv): P
    rebuilt as exp(s - lse) in float32 and zeroed where masked, P
    rounded to dO's dtype before dV, dS = P (dP - delta) scale rounded to
    q's dtype before dQ and dK, delta = rowsum(dO * O); outputs in the
    inputs' dtype."""
    sm_scale = _default_scale(q, sm_scale)
    sq, sk = q.shape[2], k.shape[2]
    dout = dout.to(q.dtype)
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        p = torch.where(_causal_keep(sq, sk, p.device), p, 0.0)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * sm_scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def uses_fused_bwd(sq: int, sk: int) -> bool:
    """The JAX package's rule (``_flash_bwd_pallas``): one 512-block
    holds the whole sequence, so dq, dk and dv come from one kernel;
    longer sequences take the dq and dkv kernels."""
    return sq <= FUSED_BWD_MAX_SEQ and sk <= FUSED_BWD_MAX_SEQ


def _bwd_operands(q, k, v, dout, lse, delta, causal, sm_scale):
    """Checked pointers and sizes of a backward kernel's C entry."""
    _check_cuda_attention(q, k, v, dout)
    b, h, sq, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != q.device:
            raise MXNetError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous float32 ({b}, {h}, {sq}) tensor "
                             f"on {q.device}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    geom = (b * h, sq, k.shape[2], d, int(causal), float(sm_scale),
            DTYPE_CODES[q.dtype])
    return ptrs, geom


def flash_bwd_fused(q, k, v, dout, lse, delta, causal, sm_scale):
    """(dq, dk, dv) from the ``flash_bwd_fused`` kernel (CUDA tensors;
    ``delta`` = rowsum(dO * O) in float32). dq is summed by atomic adds
    in no fixed order, so it repeats only within float32 rounding."""
    ptrs, geom = _bwd_operands(q, k, v, dout, lse, delta, causal, sm_scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # dq accumulates in float32 (zeroed by the kernel's entry): in dq
    # itself when that is float32
    acc = dq if q.dtype == torch.float32 else \
        torch.empty(dq.shape, dtype=torch.float32, device=q.device)
    launch("flash_bwd_fused", q.device, *ptrs, dq.data_ptr(),
           acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), *geom,
           dtype=q.dtype, flops=functools.partial(_products, q, k, causal, 5))
    return dq, dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, causal, sm_scale):
    """dq from the ``flash_bwd_dq`` kernel (CUDA tensors)."""
    ptrs, geom = _bwd_operands(q, k, v, dout, lse, delta, causal, sm_scale)
    dq = torch.empty_like(q)
    launch("flash_bwd_dq", q.device, *ptrs, dq.data_ptr(), *geom,
           dtype=q.dtype, flops=functools.partial(_products, q, k, causal, 3))
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal, sm_scale):
    """(dk, dv) from the ``flash_bwd_dkv`` kernel (CUDA tensors)."""
    ptrs, geom = _bwd_operands(q, k, v, dout, lse, delta, causal, sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch("flash_bwd_dkv", q.device, *ptrs, dk.data_ptr(), dv.data_ptr(),
           *geom, dtype=q.dtype,
           flops=functools.partial(_products, q, k, causal, 4))
    return dk, dv


def flash_bwd_plan(kernel: str, bh: int, sq: int, sk: int, d: int,
                   dtype: torch.dtype = torch.float32, device=None) -> dict:
    """The plan of the ``flash_bwd_dq`` or ``flash_bwd_dkv`` kernel for
    ``bh`` heads of ``sq`` queries and ``sk`` keys at head_dim ``d`` on the
    CUDA ``device`` (the current one by default): rows of a block (queries
    for dq, keys for dkv), rows of the tile it walks, threads, shared
    memory a block, blocks resident on an SM, blocks, and the card's SMs.
    A query: it launches nothing and counts nothing."""
    kinds = {"flash_bwd_dq": 1, "flash_bwd_dkv": 2}
    if kernel not in kinds or dtype not in DTYPE_CODES:
        raise MXNetError(f"flash_bwd_plan: no kernel {kernel!r} in {dtype}")
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = library().mxt_flash_bwd_plan(kinds[kernel], bh, sq, sk, d,
                                           DTYPE_CODES[dtype], out)
    if err != 0:
        what = library().mxt_error_string(err).decode()
        raise MXNetError(f"flash_bwd_plan: CUDA error {err} ({what})")
    per_sm, blocks, sms = out[4], out[5], out[6]
    return {"rows": out[0], "walk_rows": out[1], "threads": out[2],
            "smem_bytes": out[3], "blocks_per_sm": per_sm,
            "blocks": blocks, "sms": sms,
            "waves": blocks / max(per_sm * sms, 1)}


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Flash-attention backward → (dq, dk, dv) from the forward's ``out``
    and ``lse``. A CUDA tensor launches ``flash_bwd_fused`` when Sq and
    Sk are both <= 512, else ``flash_bwd_dq`` and ``flash_bwd_dkv``
    (contiguous float32 or bfloat16, head_dim <= 128, else it raises); a
    CPU tensor runs :func:`flash_attention_bwd_plain`."""
    _check_flash_shapes(q, k, v)
    if q.device.type == "cpu":
        count_plain()
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         sm_scale)
    sm_scale = _default_scale(q, sm_scale)
    _check_cuda_attention(q, out, dout)
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    # delta_i = rowsum(dO_i * O_i), outside the kernel as on the TPU
    delta = (dout.float() * out.float()).sum(-1)
    if uses_fused_bwd(q.shape[2], k.shape[2]):
        return flash_bwd_fused(q, k, v, dout, lse, delta, causal, sm_scale)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, sm_scale)
    return (dq,) + flash_bwd_dkv(q, k, v, dout, lse, delta, causal,
                                 sm_scale)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward. A CPU tensor runs the plain
    forward and backward, a CUDA tensor the kernels; ``lse`` is an output
    without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.device.type == "cpu":
            count_plain()
            out, lse = flash_attention_fwd_plain(q, k, v, causal, sm_scale)
        else:
            out, lse = _flash_fwd_kernel(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        # the gradient arrives strided from the head merge
        # (out.permute(0, 2, 1, 3).reshape(...)) and maybe in another dtype
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.to(q.dtype).contiguous(), ctx.causal,
            ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward → (out, lse), differentiable in q, k and v
    (``lse`` carries no gradient). A CUDA tensor launches the kernel
    (contiguous float32 or bfloat16, head_dim <= 128, else it raises), and
    its backward the flash backward kernels; a CPU tensor runs
    :func:`flash_attention_fwd_plain` and the plain backward."""
    _check_flash_shapes(q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 _default_scale(q, sm_scale))


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None, valid_length=None):
    """Fused memory-efficient attention on (B, H, S, D) tensors.
    ``valid_length`` (B,) masks padded keys on the blockwise path (plain
    PyTorch, differentiated by autograd)."""
    _check_flash_shapes(q, k, v)
    if valid_length is not None:
        return attention_blockwise(q, k, v, causal,
                                   _default_scale(q, sm_scale),
                                   valid_length=torch.as_tensor(
                                       valid_length))
    return flash_attention_fwd(q, k, v, causal, sm_scale)[0]


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           sm_scale: Optional[float] = None):
    """One query token per batch slot attending over K/V held in a paged
    cache (``serving/kvcache.py``), read through page-table indirection.

    - ``q``: (S, H, D), the current token's query per slot;
    - ``k_pages``/``v_pages``: (P, page_size, Hkv, D), one layer's page
      arrays. ``Hkv`` may divide H (grouped-query attention): stored head
      j serves query heads [j*g, (j+1)*g), g = H // Hkv;
    - ``page_table``: (S, max_pages) integer page ids, padded with the
      null page 0;
    - ``lengths``: (S,) valid key count per slot.

    A page gather, then :func:`flash_attention` with ``valid_length``
    (the blockwise path, as the JAX package runs it), so padding pages
    and unwritten positions are masked exactly. Returns (S, H, D)."""
    s, h, d = q.shape
    hkv = k_pages.shape[2]
    if hkv < 1 or h % hkv:
        raise MXNetError(f"paged_decode_attention: query heads {h} not a "
                         f"multiple of K/V heads {hkv} (GQA needs integer "
                         "groups)")
    t = page_table.shape[1] * k_pages.shape[1]
    # (S, max_pages, page_size, Hkv, D) -> (S, Hkv, T, D): slot s's key at
    # position p lives at flat index p because pages fill in order
    k = k_pages[page_table].reshape(s, t, hkv, d).transpose(1, 2)
    v = v_pages[page_table].reshape(s, t, hkv, d).transpose(1, 2)
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    out = flash_attention(q[:, :, None, :], k, v, causal=False,
                          sm_scale=sm_scale, valid_length=lengths)
    return out[:, :, 0, :]
