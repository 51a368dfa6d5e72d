"""Attention ops (counterpart of ``mxnet_tpu/ops/attention.py``).

Inputs are (batch, heads, seq, head_dim), as in the JAX package. The
softmax scale defaults to head_dim**-0.5; masking uses the finite value
-1e30, and a query row with no valid key outputs exactly zero on every
path of this module.

- :func:`flash_attention`: on a CUDA tensor the forward kernel
  ``csrc/flash_fwd.cu`` (online softmax over key tiles, returning the
  per-row log-sum-exp beside the output); on a CPU tensor its plain
  version :func:`flash_attention_fwd_plain`. With ``valid_length`` (a
  per-sample key count) it runs the blockwise PyTorch path on either
  device, as the JAX package runs that case outside its Pallas kernel.
- :func:`attention_reference`: unfused softmax(QK^T)V, the oracle and
  the path for an arbitrary additive mask.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..base import MXNetError
from .kernels import DTYPE_CODES, check_cuda_operands, launch

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "attention_reference"]

NEG_INF = -1e30  # finite mask value: keeps exp() NaN-free for masked rows
MAX_HEAD_DIM = 128
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


def flash_attention_fwd(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward → (out, lse). A CUDA tensor launches the
    kernel (contiguous float32 or bfloat16, head_dim <= 128, else it
    raises); a CPU tensor runs :func:`flash_attention_fwd_plain`."""
    _check_flash_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale)
    sm_scale = _default_scale(q, sm_scale)
    check_cuda_operands("flash_attention", q, k, v)
    for t in (k, v):
        if t.dtype != q.dtype or not t.is_contiguous():
            raise MXNetError("flash_attention: q, k and v must be "
                             "contiguous and of one dtype")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention: head_dim {d} > {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    launch("flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), lse.data_ptr(), b * h, sq, sk, d, int(causal),
           sm_scale, DTYPE_CODES[q.dtype])
    return out, lse


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None, valid_length=None):
    """Fused memory-efficient attention on (B, H, S, D) tensors.
    ``valid_length`` (B,) masks padded keys on the blockwise path."""
    _check_flash_shapes(q, k, v)
    if valid_length is not None:
        return attention_blockwise(q, k, v, causal,
                                   _default_scale(q, sm_scale),
                                   valid_length=torch.as_tensor(
                                       valid_length))
    return flash_attention_fwd(q, k, v, causal, sm_scale)[0]
