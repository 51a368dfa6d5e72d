"""Transformer layers (counterpart of ``mxnet_tpu/gluon/nn/transformer.py``):
``MultiHeadAttention``, ``PositionwiseFFN``, ``TransformerEncoderCell``
and ``TransformerEncoder``, used by ``model_zoo.bert``.

Attention goes through ``ops.attention.flash_attention`` (the flash
forward and backward kernels on the card); the FFN's ``gelu`` branch
through the bias-GELU kernels; every trailing-axis LayerNorm through the
LayerNorm kernels. Each runs through the op funnel (``ops/registry.py``)
under the JAX package's name: ``"flash_attention"``,
``"flash_attention_vl"`` (with ``valid_length``), ``"masked_attention"``
(with ``mask``) and ``"bias_gelu_dense"``, where ``amp`` casts it or
leaves it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops import attention as ATT
from ...ops import nn as FNN
from ...ops.kernels.norm import bias_gelu
from ...ops.registry import invoke
from .basic_layers import Dense, Dropout, LayerNorm, activation

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerEncoder"]


def _masked_attention(q, k, v, mask, sm_scale, causal=False,
                      valid_length=None):
    """Arbitrary-additive-mask attention on the unfused oracle; padding
    given as ``valid_length`` is folded into the mask."""
    if valid_length is not None:
        keep = torch.arange(k.shape[2], device=k.device)[None, :] \
            < valid_length.to(k.device)[:, None]
        pad = torch.where(keep, 0.0, ATT.NEG_INF)[:, None, None, :]
        mask = mask.to(torch.float32) + pad
    return ATT.attention_reference(q, k, v, causal=causal,
                                   sm_scale=sm_scale, mask=mask)


class MultiHeadAttention(nn.Module):
    """Multi-head attention over (batch, seq, units) inputs.

    ``forward(q, k=None, v=None, mask=None, valid_length=None)``:
    self-attention when k and v are omitted. ``valid_length`` (B,) masks
    padded keys; ``mask`` is an additive float mask broadcastable to
    (batch, heads, seq_q, seq_k), on the unfused path."""

    def __init__(self, units: int, num_heads: int, dropout: float = 0.0,
                 use_bias: bool = True, causal: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        dev = resolve_device(device)
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        kw = dict(use_bias=use_bias, flatten=False, in_units=units,
                  device=dev, generator=generator)
        self.query_proj = Dense(units, **kw)
        self.key_proj = Dense(units, **kw)
        self.value_proj = Dense(units, **kw)
        self.out_proj = Dense(units, **kw)
        self.dropout = Dropout(dropout, generator=generator)

    def _split(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self._num_heads,
                         self._units // self._num_heads) \
            .permute(0, 2, 1, 3).contiguous()

    def forward(self, q, k=None, v=None, mask=None, valid_length=None):
        k = q if k is None else k
        v = k if v is None else v
        qh = self._split(self.query_proj(q))
        kh = self._split(self.key_proj(k))
        vh = self._split(self.value_proj(v))
        scale = 1.0 / math.sqrt(self._units // self._num_heads)
        causal = self._causal
        if mask is not None:
            vl = None if valid_length is None \
                else torch.as_tensor(valid_length)
            out = invoke(
                "masked_attention",
                lambda q_, k_, v_, m_: _masked_attention(
                    q_, k_, v_, m_, scale, causal=causal, valid_length=vl),
                qh, kh, vh, torch.as_tensor(mask, device=qh.device))
        elif valid_length is not None:
            # the key counts stay integers: the wrapper casts only float32
            out = invoke(
                "flash_attention_vl",
                lambda q_, k_, v_: ATT.flash_attention(
                    q_, k_, v_, causal=causal, sm_scale=scale,
                    valid_length=valid_length),
                qh, kh, vh)
        else:
            out = invoke(
                "flash_attention",
                lambda q_, k_, v_: ATT.flash_attention(
                    q_, k_, v_, causal=causal, sm_scale=scale),
                qh, kh, vh)
        b, _, s, _ = out.shape
        out = out.permute(0, 2, 1, 3).reshape(b, s, self._units)
        return self.dropout(self.out_proj(out))


class PositionwiseFFN(nn.Module):
    """Transformer FFN: dense → activation → dense (+ dropout). With
    ``activation="gelu"`` the first dense's bias add and the GELU run as
    one bias-GELU kernel after the product ``x W^T``."""

    def __init__(self, units: int, hidden_size: int, dropout: float = 0.0,
                 activation: str = "gelu", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.ffn_1 = Dense(hidden_size, flatten=False, in_units=units,
                           device=dev, generator=generator)
        self.ffn_2 = Dense(units, flatten=False, in_units=hidden_size,
                           device=dev, generator=generator)
        self._activation = activation
        self.dropout = Dropout(dropout, generator=generator)

    def forward(self, x):
        if self._activation == "gelu" and self.ffn_1.bias is not None:
            h = invoke("bias_gelu_dense",
                       lambda x_, w_, b_: bias_gelu(FNN.linear(x_, w_), b_),
                       x, self.ffn_1.weight, self.ffn_1.bias)
        else:
            h = activation(self.ffn_1(x), self._activation)
        return self.dropout(self.ffn_2(h))


class TransformerEncoderCell(nn.Module):
    """Post-LN (BERT-style) or pre-LN transformer encoder layer."""

    def __init__(self, units: int, hidden_size: int, num_heads: int,
                 dropout: float = 0.0, pre_norm: bool = False,
                 activation: str = "gelu", causal: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self._pre_norm = pre_norm
        self.attention = MultiHeadAttention(units, num_heads,
                                            dropout=dropout, causal=causal,
                                            device=dev, generator=generator)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                   activation=activation, device=dev,
                                   generator=generator)
        self.ln_1 = LayerNorm(in_channels=units, device=dev)
        self.ln_2 = LayerNorm(in_channels=units, device=dev)

    def forward(self, x, mask=None, valid_length=None):
        if self._pre_norm:
            x = x + self.attention(self.ln_1(x), mask=mask,
                                   valid_length=valid_length)
            return x + self.ffn(self.ln_2(x))
        x = self.ln_1(x + self.attention(x, mask=mask,
                                         valid_length=valid_length))
        return self.ln_2(x + self.ffn(x))


class TransformerEncoder(nn.Module):
    """Stack of encoder cells, held as attributes ``layer0``, ``layer1``,
    … (the JAX package's parameter names)."""

    def __init__(self, num_layers: int, units: int, hidden_size: int,
                 num_heads: int, dropout: float = 0.0,
                 pre_norm: bool = False, activation: str = "gelu",
                 causal: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self._num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}", TransformerEncoderCell(
                units, hidden_size, num_heads, dropout=dropout,
                pre_norm=pre_norm, activation=activation, causal=causal,
                device=dev, generator=generator))

    def forward(self, x, mask=None, valid_length=None):
        for i in range(self._num_layers):
            x = getattr(self, f"layer{i}")(x, mask=mask,
                                           valid_length=valid_length)
        return x
