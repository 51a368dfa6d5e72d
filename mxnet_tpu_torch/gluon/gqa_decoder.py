"""GQA transformer decode stack (counterpart of
``mxnet_tpu/gluon/gqa_decoder.py``): the second model of the decode
engine.

A decoder-only transformer implementing the ``DecodeEngine`` model
protocol (``decode_step`` / ``prefill_chunk`` / ``verify_chunk``) over the
same paged KV layout as the reference RNN: per-layer K/V pages of shape
``(num_layers, num_pages, page_size, num_kv_heads, head_dim)``. It
queries with ``num_heads`` heads and caches ``num_kv_heads`` (grouped-query
attention, broadcast inside ``paged_decode_attention``). All three entry
points run one token through the same block, so they agree by
construction. There is no recurrent carry: the engine's state rows are
(slots, 1) zeros passed through untouched. It runs no kernel of its own.

Parameters are named after the JAX model's flattened ``params`` pytree
(``embed``, ``pos``, ``lnf``, ``layers.0.ln1``, ``layers.0.wq``, ...) and
drawn from ``RandomState(seed)`` in the JAX model's order.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from ..ops.attention import paged_decode_attention

__all__ = ["GQADecoder"]


def _rmsnorm(x, g, eps: float = 1e-6):
    return x * g * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def _param(a: np.ndarray, dev) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(a).to(dev), requires_grad=False)


class _Layer(nn.Module):
    def __init__(self, arrays, dev):
        super().__init__()
        for name, a in arrays:
            self.register_parameter(name, _param(a, dev))


class GQADecoder(nn.Module):
    """Decoder-only transformer with grouped-query attention over the
    engine's paged KV cache. Per layer: RMS pre-norm, q/k/v projections
    (q ``num_heads`` heads, k/v ``num_kv_heads``), the K/V page write at
    this token's position, paged attention, the output projection
    residual, and a pre-norm ReLU MLP residual. Logits tie the
    embedding."""

    def __init__(self, vocab: int = 64, d_model: int = 32,
                 num_heads: int = 4, num_kv_heads: int = 2,
                 num_layers: int = 2, max_len: int = 512, seed: int = 0,
                 device=None):
        super().__init__()
        if d_model % num_heads:
            raise MXNetError(f"d_model={d_model} not divisible by "
                             f"num_heads={num_heads}")
        if num_heads % num_kv_heads:
            raise MXNetError(
                f"num_heads={num_heads} not a multiple of "
                f"num_kv_heads={num_kv_heads} (GQA groups must be even)")
        self.vocab = int(vocab)
        self.d_model = int(d_model)
        self.num_heads = int(num_heads)
        self.num_kv_heads = int(num_kv_heads)
        self.num_layers = int(num_layers)
        self.head_dim = self.d_model // self.num_heads
        self.max_len = int(max_len)
        dev = resolve_device(device)
        rng = np.random.RandomState(seed)
        H = self.d_model
        kvw = self.num_kv_heads * self.head_dim

        def mat(*shape, scale=0.3):
            return rng.normal(0.0, scale, shape).astype("float32")

        ones = np.ones(H, "float32")
        self.embed = _param(mat(self.vocab, H, scale=0.5), dev)
        self.pos = _param(mat(self.max_len, H, scale=0.2), dev)
        self.lnf = _param(ones.copy(), dev)
        self.layers = nn.ModuleList(
            _Layer([("ln1", ones.copy()), ("wq", mat(H, H)),
                    ("wk", mat(H, kvw)), ("wv", mat(H, kvw)),
                    ("wo", mat(H, H)), ("ln2", ones.copy()),
                    ("w1", mat(H, 2 * H)), ("w2", mat(2 * H, H))], dev)
            for _ in range(self.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def params(self) -> Dict:
        """The JAX pytree's shape: top-level tensors and a list of
        per-layer dicts."""
        return {"embed": self.embed, "pos": self.pos, "lnf": self.lnf,
                "layers": [dict(layer.named_parameters())
                           for layer in self.layers]}

    def init_state(self, slots: int):
        return (torch.zeros(slots, 1, device=self.device),
                torch.zeros(slots, 1, device=self.device))

    def _block(self, params, tokens, pos, k_pages, v_pages, pidx, poff,
               table, lengths):
        """The single-token block every entry point shares."""
        S = tokens.shape[0]
        Hq, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        p = pos.clamp(0, self.max_len - 1)
        x = params["embed"][tokens] + params["pos"][p]
        for li, lp in enumerate(params["layers"]):
            y = _rmsnorm(x, lp["ln1"])
            q = (y @ lp["wq"]).reshape(S, Hq, D)
            k = (y @ lp["wk"]).reshape(S, Hkv, D)
            v = (y @ lp["wv"]).reshape(S, Hkv, D)
            k_pages[li, pidx, poff] = k.to(k_pages.dtype)
            v_pages[li, pidx, poff] = v.to(v_pages.dtype)
            attn = paged_decode_attention(q, k_pages[li], v_pages[li],
                                          table, lengths)
            x = x + attn.reshape(S, -1) @ lp["wo"]
            y2 = _rmsnorm(x, lp["ln2"])
            x = x + torch.relu(y2 @ lp["w1"]) @ lp["w2"]
        logits = _rmsnorm(x, params["lnf"]) @ params["embed"].t()
        return logits.argmax(dim=-1), k_pages, v_pages

    def _position(self, table, start_len, t, active_t, page_size):
        """(page, offset, lengths) of position start_len + t, the null
        page and length 1 where ``active_t`` is False."""
        pos = start_len + t
        col = (pos // page_size).clamp(max=table.shape[1] - 1)
        page = torch.gather(table, 1, col[:, None])[:, 0]
        return (pos, torch.where(active_t, page, 0),
                torch.where(active_t, pos % page_size, 0),
                torch.where(active_t, pos + 1, 1))

    @torch.no_grad()
    def decode_step(self, params, tokens, h, c, k_pages, v_pages,
                    pidx, poff, table, lengths, active):
        """One iteration over every slot: write this token's K/V in every
        layer, attend over the slot's history, emit the greedy next
        token. Inactive slots write the null page and keep their
        token."""
        pidx = torch.where(active, pidx, 0)
        poff = torch.where(active, poff, 0)
        nxt, k_pages, v_pages = self._block(
            params, tokens, lengths - 1, k_pages, v_pages, pidx, poff,
            table, lengths)
        return torch.where(active, nxt, tokens), h, c, k_pages, v_pages

    @torch.no_grad()
    def prefill_chunk(self, params, tokens, h, c, k_pages, v_pages,
                      start_len, n_valid, reset, active, table,
                      page_size: int):
        """Consume up to ``tokens.shape[1]`` prompt tokens through the
        same block, one position at a time (each position's attention
        sees the chunk's earlier writes); returns the greedy continuation
        of the last valid position."""
        last = torch.zeros_like(tokens[:, 0])
        for t in range(tokens.shape[1]):
            valid = active & (t < n_valid)
            pos, pg, off, lengths = self._position(table, start_len, t,
                                                   valid, page_size)
            nxt, k_pages, v_pages = self._block(
                params, tokens[:, t], pos, k_pages, v_pages, pg, off, table,
                lengths)
            last = torch.where(valid, nxt, last)
        return torch.where(active, last, 0), h, c, k_pages, v_pages

    @torch.no_grad()
    def verify_chunk(self, params, tokens, h, c, k_pages, v_pages,
                     start_len, n_draft, active, table, page_size: int):
        """Score the committed token and the drafts in one dispatch; the
        state trajectories are the dummy carries repeated per position
        (the pages hold all the state)."""
        K = tokens.shape[1]
        ys = []
        for t in range(K):
            valid = active & (t < n_draft)
            pos, pg, off, lengths = self._position(table, start_len, t,
                                                   valid, page_size)
            y, k_pages, v_pages = self._block(
                params, tokens[:, t], pos, k_pages, v_pages, pg, off, table,
                lengths)
            ys.append(y)
        hs = h[None].expand((K,) + tuple(h.shape))
        cs = c[None].expand((K,) + tuple(c.shape))
        return torch.stack(ys, dim=1), hs, cs, k_pages, v_pages
