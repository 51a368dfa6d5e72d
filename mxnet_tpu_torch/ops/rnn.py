"""Fused multi-layer recurrent ops (counterpart of
``mxnet_tpu/ops/rnn.py``).

The input projection of ALL timesteps is one product over the flattened
T*N rows (``x @ W_ih^T + b_ih``, cuBLAS on the card), and only the
sequential hidden-to-hidden recurrence runs in the time-fused kernels
(``ops/kernels/rnn_scan.py``). Gate order: LSTM [i, f, g, o], GRU
[r, z, n], as the JAX package and the reference's ``rnn_impl.h``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..base import MXNetError
from . import nn as _nn
from .kernels import rnn_scan as _krnn

__all__ = ["GATES", "fused_rnn", "scan_reference", "rnn_packed_param_size"]

GATES = _krnn.GATES


def scan_reference(xw, h0, c0, w_hh, b_hh, mode, reverse=False):
    """The plain recurrence over precomputed input projections ``xw`` (T,
    N, G*H) → ``(ys, h_T, c_T|None)``, ys in forward time order: the
    Python loop the kernels are held against (``rnn_scan_plain``)."""
    if reverse:
        xw = torch.flip(xw, dims=(0,))
    ys, cs = _krnn.rnn_scan_plain(xw, h0, c0, w_hh, b_hh, mode)
    h_t = ys[-1]
    c_t = cs[-1] if cs is not None else None
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    return ys, h_t, c_t


def _one_direction(x, h0, c0, w_ih, w_hh, b_ih, b_hh, mode, reverse):
    """x: (T, N, C) → (ys (T, N, H), h_T, c_T|None): one product for all
    input projections, then the time-fused recurrence."""
    xw = _nn.linear(x, w_ih, b_ih).contiguous()      # (T, N, G*H)
    return _krnn.rnn_scan(xw, h0, c0, w_hh, b_hh, mode, reverse=reverse)


def fused_rnn(x, h0, c0, params: Sequence, mode: str, num_layers: int,
              bidirectional: bool, dropout: float = 0.0,
              train: bool = False,
              generator: Optional[torch.Generator] = None):
    """Multi-layer (optionally bidirectional) recurrence.

    x: (T, N, C); h0/c0: (L*D, N, H); params: flat per-(layer, direction)
    [w_ih, w_hh, b_ih, b_hh] * L * D. Returns (y, h_out, c_out|None).
    Inter-layer dropout at rate ``dropout`` is applied to each layer's
    output except the last, in training only, with masks drawn from
    ``generator`` (the default generator when None)."""
    if mode not in GATES:
        raise MXNetError(f"unknown RNN mode {mode!r}")
    dirs = 2 if bidirectional else 1
    if len(params) != 4 * num_layers * dirs:
        raise MXNetError(f"expected {4 * num_layers * dirs} param arrays, "
                         f"got {len(params)}")
    hs, cs = [], []
    inp = x
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            idx = (layer * dirs + d) * 4
            w_ih, w_hh, b_ih, b_hh = params[idx:idx + 4]
            s = layer * dirs + d
            y, h_t, c_t = _one_direction(
                inp, h0[s], c0[s] if c0 is not None else None, w_ih, w_hh,
                b_ih, b_hh, mode, reverse=(d == 1))
            outs.append(y)
            hs.append(h_t)
            if c_t is not None:
                cs.append(c_t)
        inp = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if train and dropout > 0.0 and layer < num_layers - 1:
            keep = torch.bernoulli(
                torch.full(inp.shape, 1.0 - dropout, device=inp.device),
                generator=generator).to(torch.bool)
            inp = torch.where(keep, inp / (1.0 - dropout),
                              torch.zeros((), dtype=inp.dtype,
                                          device=inp.device))
    h_out = torch.stack(hs, dim=0)
    c_out = torch.stack(cs, dim=0) if cs else None
    return inp, h_out, c_out


def rnn_packed_param_size(mode: str, input_size: int, hidden_size: int,
                          num_layers: int, bidirectional: bool) -> int:
    """Total scalar count of the reference RNN op's packed parameter vector
    (rnn-inl.h GetParamSize)."""
    g = GATES[mode]
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden_size * dirs
        total += g * hidden_size * (in_sz + hidden_size + 2) * dirs
    return total
