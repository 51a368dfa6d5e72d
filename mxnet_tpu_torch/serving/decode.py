"""Continuous-batching autoregressive decode engine (counterpart of
``mxnet_tpu/serving/decode.py``).

Scheduling happens at the STEP boundary: requests join and leave the
running batch between decode steps over a ladder of slot-count buckets
(``MXNET_DECODE_SLOTS``), with a per-slot active mask; a slot freed by EOS
or its token budget is refilled from the queue at the next iteration.

- **Paged KV cache** (:class:`~.kvcache.PagedKVCache`): K/V history lives
  in pages behind a (slots, max_pages) page table; a request that cannot
  reserve its worst-case pages at submit is shed with a typed
  ``Overloaded(reason="kvcache")``. Deadlines are re-projected per token
  from the inter-token time, and a stream that cannot finish in budget is
  shed mid-flight with ``DeadlineExceeded``.
- **Chunked prefill**: prompts are consumed ``MXNET_DECODE_PREFILL_CHUNK``
  tokens at a time, alternating with decode steps whenever both kinds of
  work exist, so a long prompt never starves the running batch.
- **The kernels**: :class:`TinyDecoder`'s recurrence runs through
  :func:`~..ops.kernels.rnn_scan.rnn_decode_step` (the ``rnn_decode``
  CUDA kernel on the card) in every decode step, every prefill position
  and every verify position, and attention reads K/V through the page
  table (:func:`~..ops.attention.paged_decode_attention`).
- **Speculative decode** (``spec_k`` / ``MXNET_DECODE_SPEC_K``): a host
  drafter (:class:`NgramDrafter` by default) proposes up to K tokens per
  slot, one verify dispatch scores them over the same per-token cell,
  and the longest prefix matching the model's own greedy continuation is
  accepted on the device (:func:`_accept_longest_prefix`): 1 to K+1
  tokens a step, the same tokens as plain greedy decode.
- **Prefix sharing** (``prefix_share`` / ``MXNET_DECODE_PREFIX_SHARE``):
  retired prefill chunks register their pages and a snapshot of the
  recurrent state; a later prompt extending a registered prefix maps the
  pages, installs the state and prefills only its tail; a write onto a
  shared page copies it first (:meth:`DecodeEngine._cow_guard`).

Pipelining: every step is dispatched asynchronously and pushed into an
:class:`~..engine.DispatchWindow`; its retire is the one host sync, where
the step's tokens are read back and streamed to the :class:`DecodeStream`
futures. Next-step tokens chain on the device.

One captured program per (kind, bucket), as the JAX package compiles
one: a model's ``decode_step`` / ``prefill_chunk`` / ``verify_chunk``
with the state stitch around it runs as one CUDA graph
(:mod:`mxnet_tpu_torch.captured`), captured by :meth:`DecodeEngine.warmup`
on inactive dummy inputs (their writes land on the null page, the state is left as
it was) and replayed by every step; a (kind, bucket) the warm-up did not
cover is captured at its first step and counts in
:attr:`DecodeEngine.n_traces`. On the CPU each program's body runs
eagerly over the same static buffers. The graphs read the slot state,
the token array and the K/V pages where they always live, and the
per-step host arrays (page indices, the page table, lengths, masks,
prompt and draft tokens) from one static device buffer: each step packs
them into one array, pins it and copies it up with ``non_blocking=True``
(the caching host allocator hands the pinned block out again only once
that copy has finished), so no dispatch waits for the device
and the loop runs clean under ``torch.cuda.set_sync_debug_mode("error")``
with the retire exempt. A replay's outputs are copied out before the
next replay can overwrite them. The K/V pages are written in place,
where the JAX package donates them; copy-on-write page copies, the
prefill's first-token copy and the prefix registry's state snapshots
(clones: a view of the live state rows would go on changing) run
eagerly between replays.

Telemetry: ``mx_decode_tokens_total``, ``mx_decode_active_slots``, the
``mx_decode_ttft_seconds`` / ``mx_decode_tpot_seconds`` histograms,
``mx_serving_rejected_total{reason}`` and ``mx_decode_spec_drafted_total``
/ ``_accepted_total`` (the JAX engine's series), beside ``stats``; the
KV cache's page pools are in the memory census (``kvcache.py``). With
``MXNET_MEMORY_BUDGET`` set, the engine prices its real geometry at
construction — the page pools, plus the speculative overrun slack of
``spec_k`` positions a slot — and raises where it does not fit (the
check the JAX package's ``decode.page_size`` / ``decode.spec_k``
validators make at a nominal geometry).

The engine's knobs are the five ``decode.*`` tunables
(``tuning/space.py``): :func:`slot_ladder`, :func:`kv_page_size`,
:func:`prefill_chunk`, :func:`spec_k` and :func:`prefix_share` resolve
autotune override > their env var > the default, when an engine is
built. :meth:`DecodeEngine.lower_entry` / :meth:`DecodeEngine.analyze`
record a bucket's decode program for ``analysis/``.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import resolve_device
from ..engine import DispatchWindow
from ..ops.attention import paged_decode_attention
from ..ops.kernels import launch_counts
from ..ops.kernels.rnn_scan import rnn_decode_step, rnn_verify_scan
from .batcher import queue_depth
from ..captured import Programs
from .kvcache import KV_PAGE_SIZE, PagedKVCache, pages_needed
from .resilience import (DeadlineExceeded, Overloaded, ServingShutdown,
                         default_deadline_ms, shed_mode)

__all__ = ["DecodeEngine", "DecodeStream", "TinyDecoder", "run_decode",
           "NgramDrafter", "ModelDrafter", "slot_ladder", "kv_page_size",
           "prefill_chunk", "spec_k", "prefix_share", "DECODE_SLOT_LADDER",
           "PREFILL_CHUNK", "SPEC_K", "PREFIX_SHARE"]

#: default slot-count ladder (``MXNET_DECODE_SLOTS``)
DECODE_SLOT_LADDER = (1, 2, 4, 8)
#: default prompt tokens a prefill chunk consumes
#: (``MXNET_DECODE_PREFILL_CHUNK``)
PREFILL_CHUNK = 16
#: default draft tokens a speculative step proposes (0 = off;
#: ``MXNET_DECODE_SPEC_K``)
SPEC_K = 0
#: default prefix sharing (1 = on; ``MXNET_DECODE_PREFIX_SHARE``)
PREFIX_SHARE = 1


def _parse_ladder(v) -> Tuple[int, ...]:
    """'1,2,4,8' (or an int sequence) -> sorted unique positive tuple."""
    if isinstance(v, (tuple, list)):
        vals = tuple(sorted({int(x) for x in v}))
    else:
        vals = tuple(sorted({int(x) for x in
                             str(v).replace(" ", "").split(",") if x}))
    if not vals or vals[0] < 1:
        raise ValueError(f"bad slot ladder {v!r}")
    return vals


def slot_ladder() -> Tuple[int, ...]:
    """The slot-count ladder: autotune override > ``MXNET_DECODE_SLOTS``
    ('1,2,4,8') > the default (the ``decode.slot_ladder`` tunable)."""
    from ..tuning import space as _tspace
    v = _tspace.value("decode.slot_ladder",
                      ",".join(str(x) for x in DECODE_SLOT_LADDER))
    try:
        return _parse_ladder(v)
    except (TypeError, ValueError):
        return DECODE_SLOT_LADDER


def _tuned(name: str, default: int, least: int) -> int:
    from ..tuning import space as _tspace
    try:
        return max(least, int(_tspace.value(name, default)))
    except (TypeError, ValueError):
        return default


def kv_page_size() -> int:
    """Tokens per KV page: autotune override >
    ``MXNET_DECODE_KV_PAGE_SIZE`` > ``kvcache.KV_PAGE_SIZE``."""
    return _tuned("decode.kv_page_size", KV_PAGE_SIZE, 1)


def prefill_chunk() -> int:
    """Prompt tokens one prefill chunk consumes: autotune override >
    ``MXNET_DECODE_PREFILL_CHUNK`` > the default."""
    return _tuned("decode.prefill_chunk", PREFILL_CHUNK, 1)


def spec_k() -> int:
    """Draft tokens per speculative step (0 = off): autotune override >
    ``MXNET_DECODE_SPEC_K`` > the default."""
    return _tuned("decode.spec_k", SPEC_K, 0)


def prefix_share() -> bool:
    """Whether the engine shares prefix pages across requests: autotune
    override > ``MXNET_DECODE_PREFIX_SHARE`` > the default."""
    return bool(_tuned("decode.prefix_share", PREFIX_SHARE, 0))


def _nominal_fits(page_size: int, overrun: int) -> bool:
    """Whether a nominal full cache (the default ladder's most slots at a
    256-token context, float32, 2 heads x 16 dims x 1 layer, plus
    ``overrun`` speculative positions a slot) fits
    ``MXNET_MEMORY_BUDGET`` (no budget: it fits). An engine checks its
    real geometry at construction."""
    from ..telemetry.memory import memory_budget
    budget = memory_budget()
    if budget is None:
        return True
    slots = DECODE_SLOT_LADDER[-1]
    page_bytes = 2 * 1 * page_size * 2 * 16 * 4     # K+V, 1 layer, f32
    pages = 1 + slots * pages_needed(256 + overrun, page_size)
    return pages * page_bytes <= budget


def _page_size_valid(v, _config) -> bool:
    v = int(v)
    return 1 <= v <= 4096 and _nominal_fits(v, 0)


def _spec_k_valid(v, _config) -> bool:
    v = int(v)
    return 0 <= v <= 64 and (v == 0 or _nominal_fits(KV_PAGE_SIZE, v))


def _register_tunables():
    """The decode engine's tunables, with the JAX package's grids and
    validity predicates (a candidate priced against the KV budget at the
    nominal geometry)."""
    from ..tuning.space import Tunable, register
    register(Tunable(
        "decode.slot_ladder",
        default=",".join(str(x) for x in DECODE_SLOT_LADDER),
        grid=("1,2,4", "1,2,4,8", "1,2,4,8,16", "1,4,16"),
        env="MXNET_DECODE_SLOTS", parse=str,
        valid=lambda v, _c: bool(_parse_ladder(v)),
        seam="serving.decode.slot_ladder() -> DecodeEngine AOT "
             "slot-count buckets",
        scope="serving", affects_program=True,
        doc="slot-count buckets the decode step is compiled for "
            "(comma list; largest = physical slots)"))
    register(Tunable(
        "decode.kv_page_size", default=KV_PAGE_SIZE,
        grid=(8, 16, 32, 64),
        env="MXNET_DECODE_KV_PAGE_SIZE", parse=int,
        valid=_page_size_valid,
        seam="serving.decode.kv_page_size() -> PagedKVCache page "
             "geometry + page-table width",
        scope="serving", affects_program=True,
        doc="tokens per KV page (pages x page_bytes must fit "
            "MXNET_MEMORY_BUDGET)"))
    register(Tunable(
        "decode.prefill_chunk", default=PREFILL_CHUNK,
        grid=(8, 16, 32, 64, 128),
        env="MXNET_DECODE_PREFILL_CHUNK", parse=int,
        valid=lambda v, _c: 1 <= int(v) <= 4096,
        seam="serving.decode.prefill_chunk() -> chunked-prefill "
             "program width",
        scope="serving", affects_program=True,
        doc="prompt tokens one prefill iteration consumes (smaller = "
            "better decode-batch latency, larger = better prefill "
            "throughput)"))
    register(Tunable(
        "decode.spec_k", default=SPEC_K,
        grid=(0, 2, 4, 8),
        env="MXNET_DECODE_SPEC_K", parse=int,
        valid=_spec_k_valid,
        seam="serving.decode.spec_k() -> DecodeEngine draft->verify "
             "width (verify-program token dim = spec_k + 1)",
        scope="serving", affects_program=True,
        doc="max draft tokens the drafter proposes per speculative "
            "step (0 = off; overrun slack must fit the KV budget)"))
    register(Tunable(
        "decode.prefix_share", default=PREFIX_SHARE,
        grid=(0, 1),
        env="MXNET_DECODE_PREFIX_SHARE", parse=int,
        valid=lambda v, _c: int(v) in (0, 1),
        seam="serving.decode.prefix_share() -> PagedKVCache prefix "
             "registry + COW sharing",
        scope="serving", affects_program=False,
        doc="share committed prompt-prefix KV pages across requests "
            "(refcounted, copy-on-write on divergence)"))


_register_tunables()


# ---------------------------------------------------------------------------
# speculative drafters
# ---------------------------------------------------------------------------

class NgramDrafter:
    """The default drafter: prompt lookup over the request's own token
    history. ``propose`` finds the most recent earlier occurrence of the
    last ``n`` tokens and returns up to ``k`` of the tokens that followed
    it. A bad draft costs speed, never correctness."""

    def __init__(self, n: int = 2, min_n: int = 1):
        self.n = max(1, int(n))
        self.min_n = max(1, min(int(min_n), self.n))

    def propose(self, history, k: int) -> List[int]:
        k = int(k)
        if k <= 0 or len(history) < 2:
            return []
        hist = list(history)
        L = len(hist)
        for n in range(min(self.n, L - 1), self.min_n - 1, -1):
            tail = hist[L - n:]
            for i in range(L - n - 1, -1, -1):
                if hist[i:i + n] == tail:
                    cont = hist[i + n:i + n + k]
                    if cont:
                        return [int(t) for t in cont]
                    break
        return []


class ModelDrafter:
    """Small-model drafter: greedy-decodes ``k`` draft tokens with a
    second engine-protocol model that has ``_cell`` and
    ``draft_logits(params, h)`` (its own state per request key). Each
    draft token is read back to the host, so this drafter syncs per
    proposal."""

    def __init__(self, model):
        self.model = model
        self._state: Dict[int, tuple] = {}

    def reset(self, key: int):
        self._state.pop(key, None)

    @torch.no_grad()
    def propose(self, history, k: int, key: int = 0) -> List[int]:
        k = int(k)
        if k <= 0 or not len(history):
            return []
        m = self.model
        dev = m.device
        h, c = m.init_state(1)
        cached = self._state.get(key)
        start = 0
        if cached is not None and cached[0] <= len(history) \
                and list(history[:cached[0]]) == cached[1]:
            start, h, c = cached[0], cached[2], cached[3]
        for t in history[start:]:
            tok = torch.full((1,), int(t), dtype=torch.long, device=dev)
            h, c = m._cell(m.params, tok, h, c)
        self._state[key] = (len(history), list(history), h, c)
        out: List[int] = []
        logits_of = getattr(m, "draft_logits", None)
        for _ in range(k):
            if logits_of is None:
                break
            cur = int(logits_of(m.params, h).argmax())
            out.append(cur)
            tok = torch.full((1,), cur, dtype=torch.long, device=dev)
            h, c = m._cell(m.params, tok, h, c)
        return out


def _accept_longest_prefix(ys, hs, cs, tokens, n_draft, active):
    """Device-side acceptance of one verify dispatch.

    ``ys`` (S, K): the model's greedy token at each verified position;
    ``hs``/``cs`` (K, S, ...): the masked state trajectories; ``tokens``
    (S, K): the fed inputs (position 0 the last committed token, then the
    drafts); ``n_draft`` (S,): valid inputs. Position t's output is
    emitted iff every draft before it matched the model's own
    continuation, so the block is exactly what sequential greedy decode
    gives. Returns (emitted (S, K), n_acc (S,), next_tok (S,), h_fin,
    c_fin) with the state at the last accepted position (inactive slots
    keep everything)."""
    S, K = ys.shape
    if K > 1:
        idx = torch.arange(1, K, device=ys.device)[None, :]
        eq = (ys[:, :-1] == tokens[:, 1:]) & (idx < n_draft[:, None])
        n_acc = 1 + torch.cumprod(eq.long(), dim=1).sum(dim=1)
    else:
        n_acc = torch.ones(S, dtype=torch.long, device=ys.device)
    n_acc = torch.minimum(n_acc, n_draft.clamp(min=1))
    a_idx = (n_acc - 1).clamp(min=0)

    def at_accept(traj):
        if traj is None:
            return None
        t = traj.movedim(0, 1)                          # (S, K, ...)
        ix = a_idx.view((S, 1) + (1,) * (t.ndim - 2)).expand(
            (S, 1) + tuple(t.shape[2:]))
        return torch.gather(t, 1, ix)[:, 0]

    next_tok = torch.gather(ys, 1, a_idx[:, None])[:, 0]
    next_tok = torch.where(active, next_tok, tokens[:, 0])
    n_acc = torch.where(active, n_acc, torch.zeros_like(n_acc))
    return ys, n_acc, next_tok, at_accept(hs), at_accept(cs)


def _table_page(table, pos, page_size: int):
    """table[s, pos[s] // page_size], the column clamped to the table (a
    position past a slot's valid inputs is masked by its caller)."""
    col = (pos // page_size).clamp(max=table.shape[1] - 1)
    return torch.gather(table, 1, col[:, None])[:, 0]


# ---------------------------------------------------------------------------
# reference model
# ---------------------------------------------------------------------------

class TinyDecoder(nn.Module):
    """The reference decode model: one LSTM cell through
    :func:`rnn_decode_step` plus one attention layer reading K/V through
    the page table. Parameters are named as the JAX model's ``params``
    keys (``embed``, ``w_ih``, ``b_ih``, ``w_hh``, ``b_hh``, ``wq``,
    ``wk``, ``wv``, ``wo``) and drawn from ``RandomState(seed)`` in the
    JAX model's order, so the same seed gives the same weights.

    The engine protocol: ``params`` (a dict of tensors), ``num_layers`` /
    ``num_heads`` / ``head_dim`` / ``d_model``, :meth:`init_state`,
    :meth:`decode_step`, :meth:`prefill_chunk` and :meth:`verify_chunk`,
    each a function of its inputs that writes the K/V pages in place and
    also returns them."""

    num_layers = 1

    def __init__(self, vocab: int = 64, d_model: int = 32,
                 num_heads: int = 2, seed: int = 0, device=None):
        super().__init__()
        if d_model % num_heads:
            raise MXNetError(f"d_model={d_model} not divisible by "
                             f"num_heads={num_heads}")
        self.vocab = int(vocab)
        self.d_model = int(d_model)
        self.num_heads = int(num_heads)
        self.head_dim = self.d_model // self.num_heads
        dev = resolve_device(device)
        rng = np.random.RandomState(seed)
        H = self.d_model

        def mat(*shape, scale=0.3):
            return rng.normal(0.0, scale, shape).astype("float32")

        arrays = [("embed", mat(self.vocab, H, scale=0.5)),
                  ("w_ih", mat(4 * H, H)),
                  ("b_ih", np.zeros(4 * H, "float32")),
                  ("w_hh", mat(4 * H, H)),
                  ("b_hh", np.zeros(4 * H, "float32")),
                  ("wq", mat(H, H)), ("wk", mat(H, H)), ("wv", mat(H, H)),
                  ("wo", mat(H, H))]
        for name, a in arrays:
            self.register_parameter(name, nn.Parameter(
                torch.from_numpy(a).to(dev), requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def init_state(self, slots: int):
        H = self.d_model
        return (torch.zeros(slots, H, device=self.device),
                torch.zeros(slots, H, device=self.device))

    # -- the per-token sub-step decode, prefill and verify share
    def _xw(self, params, tokens):
        return params["embed"][tokens] @ params["w_ih"].t() + params["b_ih"]

    def _cell(self, params, tokens, h, c):
        return rnn_decode_step(self._xw(params, tokens), h, c,
                               params["w_hh"], params["b_hh"], "lstm")

    def _qkv(self, params, h2):
        S = h2.shape[0]
        nH, hd = self.num_heads, self.head_dim
        return tuple((h2 @ params[w]).reshape(S, nH, hd)
                     for w in ("wq", "wk", "wv"))

    def _logits(self, params, h2, attn):
        out = h2 + attn.reshape(h2.shape) @ params["wo"]
        return out @ params["embed"].t()

    @torch.no_grad()
    def decode_step(self, params, tokens, h, c, k_pages, v_pages,
                    pidx, poff, table, lengths, active):
        """One iteration over every slot: consume each slot's last token,
        write this position's K/V through the page table, attend over the
        slot's history, emit the next greedy token. Inactive slots keep
        their state and write the null page."""
        h2, c2 = self._cell(params, tokens, h, c)
        act = active[:, None]
        h_new = torch.where(act, h2, h)
        c_new = torch.where(act, c2, c)
        q, k, v = self._qkv(params, h2)
        pidx = torch.where(active, pidx, 0)
        poff = torch.where(active, poff, 0)
        k_pages[0, pidx, poff] = k.to(k_pages.dtype)
        v_pages[0, pidx, poff] = v.to(v_pages.dtype)
        attn = paged_decode_attention(q, k_pages[0], v_pages[0], table,
                                      lengths)
        nxt = self._logits(params, h2, attn).argmax(dim=-1)
        return torch.where(active, nxt, tokens), h_new, c_new, k_pages, \
            v_pages

    @torch.no_grad()
    def prefill_chunk(self, params, tokens, h, c, k_pages, v_pages,
                      start_len, n_valid, reset, active, table,
                      page_size: int):
        """Consume up to ``tokens.shape[1]`` prompt tokens for the active
        slot(s) through the same per-token cell, writing each position's
        K/V; the returned token is the greedy continuation of the last
        valid position (the request's first token on its final chunk)."""
        C = tokens.shape[1]
        zero = torch.zeros_like(h)
        h = torch.where(reset[:, None], zero, h)
        c = torch.where(reset[:, None], zero, c)
        for t in range(C):
            valid = active & (t < n_valid)
            h2, c2 = self._cell(params, tokens[:, t], h, c)
            vm = valid[:, None]
            h = torch.where(vm, h2, h)
            c = torch.where(vm, c2, c)
            _, k, v = self._qkv(params, h2)
            pos = start_len + t
            pg = torch.where(valid, _table_page(table, pos, page_size), 0)
            off = torch.where(valid, pos % page_size, 0)
            k_pages[0, pg, off] = k.to(k_pages.dtype)
            v_pages[0, pg, off] = v.to(v_pages.dtype)
        lengths = (start_len + n_valid).clamp(min=1)
        q, _, _ = self._qkv(params, h)
        attn = paged_decode_attention(q, k_pages[0], v_pages[0], table,
                                      lengths)
        nxt = self._logits(params, h, attn).argmax(dim=-1)
        return torch.where(active, nxt, 0), h, c, k_pages, v_pages

    @torch.no_grad()
    def verify_chunk(self, params, tokens, h, c, k_pages, v_pages,
                     start_len, n_draft, active, table, page_size: int):
        """Score ``tokens`` (S, K: the last committed token and up to K-1
        drafts) in one dispatch: the masked verify scan over the same
        per-token cell, then each position writes its K/V and emits the
        greedy token over the history sequential decode would see.
        Returns ``ys`` (S, K) and the state trajectories."""
        K = tokens.shape[1]
        xw = torch.stack([self._xw(params, tokens[:, t]) for t in range(K)])
        steps = torch.arange(K, device=tokens.device)
        valid = active[None, :] & (steps[:, None] < n_draft[None, :])
        hs, cs = rnn_verify_scan(xw, h, c, params["w_hh"], params["b_hh"],
                                 "lstm", valid)
        ys = []
        for t in range(K):
            h2 = hs[t]
            q, k, v = self._qkv(params, h2)
            val = valid[t]
            pos = start_len + t
            pg = torch.where(val, _table_page(table, pos, page_size), 0)
            off = torch.where(val, pos % page_size, 0)
            k_pages[0, pg, off] = k.to(k_pages.dtype)
            v_pages[0, pg, off] = v.to(v_pages.dtype)
            lengths = torch.where(val, pos + 1, 1)
            attn = paged_decode_attention(q, k_pages[0], v_pages[0], table,
                                          lengths)
            ys.append(self._logits(params, h2, attn).argmax(dim=-1))
        return torch.stack(ys, dim=1), hs, cs, k_pages, v_pages


# ---------------------------------------------------------------------------
# streaming future
# ---------------------------------------------------------------------------

class DecodeStream:
    """Per-request streaming future: each token is delivered as the step
    that computed it retires. Iterate for tokens as they arrive, or
    :meth:`result` for the whole sequence; :meth:`record` gives the
    streaming-latency record (``ttft_s`` / ``tpot_s`` / ``tokens``) that
    ``loadgen.streaming_summary`` aggregates."""

    def __init__(self, t_submit: float):
        self._cv = threading.Condition()
        self._tokens: List[int] = []
        self._times: List[float] = []
        self._cursor = 0
        self._done = False
        self._exc: Optional[BaseException] = None
        self.t_submit = t_submit
        # speculative-decode accounting: emitted tokens per step, drafted
        # and accepted totals
        self._step_tokens: List[int] = []
        self._drafted = 0
        self._accepted = 0

    # -- engine side
    def _deliver(self, tok: int, t: float):
        with self._cv:
            self._tokens.append(int(tok))
            self._times.append(float(t))
            self._cv.notify_all()

    def _record_step(self, emitted: int, drafted: int, accepted: int):
        with self._cv:
            self._step_tokens.append(int(emitted))
            self._drafted += int(drafted)
            self._accepted += int(accepted)

    def _finish(self):
        with self._cv:
            self._done = True
            self._cv.notify_all()

    def _fail(self, exc: BaseException):
        with self._cv:
            self._exc = exc
            self._done = True
            self._cv.notify_all()

    # -- client side
    def next_token(self, timeout: Optional[float] = None) -> Optional[int]:
        """Next token, blocking until one arrives; None at the end of the
        stream. Raises the request's typed failure once the cursor
        reaches it."""
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self._cursor < len(self._tokens) or self._done,
                    timeout=timeout):
                raise MXNetError("DecodeStream.next_token timed out")
            if self._cursor < len(self._tokens):
                tok = self._tokens[self._cursor]
                self._cursor += 1
                return tok
            if self._exc is not None:
                raise self._exc
            return None

    def __iter__(self):
        while True:
            tok = self.next_token()
            if tok is None:
                return
            yield tok

    def result(self, timeout: Optional[float] = None) -> List[int]:
        with self._cv:
            if not self._cv.wait_for(lambda: self._done, timeout=timeout):
                raise MXNetError("DecodeStream.result timed out")
            if self._exc is not None:
                raise self._exc
            return list(self._tokens)

    @property
    def done(self) -> bool:
        with self._cv:
            return self._done

    @property
    def ttft_s(self) -> Optional[float]:
        with self._cv:
            return (self._times[0] - self.t_submit) if self._times else None

    def record(self) -> dict:
        with self._cv:
            times = list(self._times)
            n = len(times)
            rec = {
                "tokens": n,
                "ttft_s": (times[0] - self.t_submit) if n else None,
                "tpot_s": [times[i] - times[i - 1] for i in range(1, n)],
                "wall_s": (times[-1] - self.t_submit) if n else None,
                "outcome": ("error" if self._exc is not None
                            else "ok" if self._done else "pending"),
            }
            if self._step_tokens:
                rec["step_tokens"] = list(self._step_tokens)
                rec["spec_drafted"] = self._drafted
                rec["spec_accepted"] = self._accepted
            return rec


class _Request:
    __slots__ = ("prompt", "max_new", "eos", "stream", "deadline",
                 "t_submit", "t_last_tok", "slot", "phase", "pos",
                 "generated", "done", "npages", "seq", "need_tokens",
                 "history", "inflight", "shared_len")

    def __init__(self, prompt, max_new, eos, stream, deadline, npages,
                 seq, need_tokens=0):
        self.prompt = prompt
        self.max_new = max_new
        self.eos = eos
        self.stream = stream
        self.deadline = deadline
        self.t_submit = stream.t_submit
        self.t_last_tok = stream.t_submit
        self.slot = -1
        self.phase = "queued"      # queued -> prefill -> decode
        self.pos = 0               # prompt tokens consumed
        self.generated = 0
        self.done = False
        self.npages = npages
        self.seq = seq
        self.need_tokens = need_tokens
        # prompt + emitted tokens: what the drafter proposes from
        self.history = [int(t) for t in prompt]
        self.inflight = False      # a verify step is in flight
        self.shared_len = 0        # prompt tokens seated from the cache


def _program_body(model, params, kind: str, names, state, tokens,
                  page_size: int):
    """The body of a (kind, bucket) program: the model call over the
    static buffer's views (named ``names``, in order) and the bucket's
    slot rows ``state`` = (h, c, k_pages, v_pages), the new h, c
    stitched back into those rows and (decode, verify) the next tokens
    into ``tokens``. Returns what the retire reads: the tokens, or
    (emitted, n_acc). It holds what it reads, not the engine."""
    h, c = state[0], state[1]

    def body(*views):
        v = dict(zip(names, views))
        active = v["active"] != 0
        with torch.no_grad():
            if kind == "decode":
                nxt, h2, c2, _, _ = model.decode_step(
                    params, tokens, *state, v["pidx"], v["poff"],
                    v["table"], v["lengths"], active)
                out = nxt
            elif kind == "verify":
                ys, hs, cs, _, _ = model.verify_chunk(
                    params, v["tokens"], *state, v["start"], v["n_draft"],
                    active, v["table"], page_size=page_size)
                emitted, n_acc, nxt, h2, c2 = _accept_longest_prefix(
                    ys, hs, cs, v["tokens"], v["n_draft"], active)
                out = (emitted, n_acc)
            else:
                nxt, h2, c2, _, _ = model.prefill_chunk(
                    params, v["tokens"], *state, v["start"], v["n_valid"],
                    v["reset"] != 0, active, v["table"],
                    page_size=page_size)
                out = nxt
            h.copy_(h2)
            c.copy_(c2)
            if kind != "prefill":
                tokens.copy_(nxt)
        return out
    return body


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class DecodeEngine:
    """Iteration-level scheduler over a slot ladder with a paged KV cache
    on the model's device (the module docstring has the design).

    ``static=True`` flips only the scheduling policy to the whole-batch
    baseline (fill every slot, prefill all prompts, decode until the last
    member finishes, then admit the next batch) with the same model
    calls. Deterministic tests drive a ``start=False`` engine by hand with
    :meth:`step_once` and :meth:`sync` and an injected ``clock``."""

    def __init__(self, model, *, ladder: Optional[Sequence[int]] = None,
                 num_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 max_context: int = 128, max_new_default: int = 16,
                 eos_id: Optional[int] = None,
                 depth: Optional[int] = None, inflight: int = 1,
                 static: bool = False, admission: bool = True,
                 dtype: str = "float32",
                 clock: Callable[[], float] = time.perf_counter,
                 start: bool = True,
                 spec_k: Optional[int] = None, drafter=None,
                 prefix_share: Optional[bool] = None):
        self.model = model
        self.device = model.device
        self._params = model.params
        self._ladder = _parse_ladder(ladder if ladder is not None
                                     else slot_ladder())
        self.slots = self._ladder[-1]
        ps = int(page_size) if page_size else kv_page_size()
        self._chunk = prefill_chunk()
        self._spec_k = (globals()["spec_k"]() if spec_k is None
                        else max(0, int(spec_k)))
        self._prefix_share = (globals()["prefix_share"]()
                              if prefix_share is None
                              else bool(prefix_share))
        self._drafter = drafter if drafter is not None else \
            (NgramDrafter() if self._spec_k else None)
        self.max_context = int(max_context)
        self.max_pages_per_slot = pages_needed(self.max_context, ps)
        if num_pages is None:
            num_pages = 1 + self.slots * self.max_pages_per_slot
        # GQA models cache fewer K/V heads than they query with
        kv_heads = int(getattr(model, "num_kv_heads", model.num_heads))
        self.kv = PagedKVCache(model.num_layers, kv_heads, model.head_dim,
                               num_pages, ps, dtype=dtype,
                               device=self.device)
        self._check_budget(ps)
        self._h, self._c = model.init_state(self.slots)
        self._tokens_dev = torch.zeros(self.slots, dtype=torch.long,
                                       device=self.device)
        # the programs and their one static device buffer of per-step
        # host arrays
        self._programs = Programs(model, self.device)
        n = max(sum(int(np.prod(shape)) for _, shape in
                    self._fields(kind, self.slots))
                for kind in ("decode", "prefill", "verify"))
        self._staged = torch.zeros(n, dtype=torch.long, device=self.device)
        self._analysis: Dict[int, dict] = {}
        self._table = np.zeros((self.slots, self.max_pages_per_slot),
                               np.int64)
        self._device_len = np.zeros(self.slots, np.int64)
        self._occupant: List[Optional[_Request]] = [None] * self.slots
        self._queue: "deque[_Request]" = deque()
        self._depth = queue_depth() if depth is None else max(1, int(depth))
        self.max_new_default = max(1, int(max_new_default))
        self.eos_id = eos_id
        self.static = bool(static)
        self.admission = bool(admission)
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._clock = clock
        me = weakref.ref(self)      # the window must not keep its engine
        self._window = DispatchWindow(
            max_inflight=max(0, int(inflight)), what="decode step",
            sync_fn=lambda payload: me()._retire_sync(payload))
        self._seq = 0
        self._tag = 0
        self._draining = False
        self._dead: Optional[BaseException] = None
        self._ewma_step: Optional[float] = None
        # inter-token-gap EWMA (TPOT) for the per-token deadline
        # re-projection
        self._ewma_tpot: Optional[float] = None
        self._last_was_prefill = False
        self.stats = {"submitted": 0, "completed": 0, "rejected": 0,
                      "deadline_missed": 0, "shed_midstream": 0,
                      "steps": 0, "prefill_chunks": 0, "tokens": 0,
                      "kv_util_peak": 0.0,
                      "spec_steps": 0, "spec_drafted": 0,
                      "spec_accepted": 0,
                      "accept_hist": {},     # accepted-block len -> n
                      "prefix_hits": 0, "prefix_tokens": 0,
                      "kv_shared_peak": 0}
        t = _telemetry
        reg = t.registry()
        self._m_tokens = reg.counter(t.names.DECODE_TOKENS)
        self._m_active = reg.gauge(t.names.DECODE_ACTIVE_SLOTS)
        self._m_ttft = reg.histogram(t.names.DECODE_TTFT_SECONDS)
        self._m_tpot = reg.histogram(t.names.DECODE_TPOT_SECONDS)
        self._m_rejected = reg.counter(t.names.SERVING_REJECTED,
                                       label_key="reason")
        self._m_drafted = reg.counter(t.names.DECODE_SPEC_DRAFTED)
        self._m_accepted = reg.counter(t.names.DECODE_SPEC_ACCEPTED)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._serve_loop, name="mxt-decode-engine",
                daemon=True)
            self._thread.start()

    # ---------------- the programs ----------------
    def _fields(self, kind: str, b: int):
        """(name, shape) of the per-step host arrays of a (kind, bucket)
        program, in their order in the static buffer."""
        mp = self.max_pages_per_slot
        if kind == "decode":
            return (("pidx", (b,)), ("poff", (b,)), ("table", (b, mp)),
                    ("lengths", (b,)), ("active", (b,)))
        if kind == "verify":
            return (("tokens", (b, self._spec_k + 1)), ("start", (b,)),
                    ("n_draft", (b,)), ("active", (b,)), ("table", (b, mp)))
        return (("tokens", (b, self._chunk)), ("start", (b,)),
                ("n_valid", (b,)), ("reset", (b,)), ("active", (b,)),
                ("table", (b, mp)))

    def _stage(self, arrays) -> None:
        """Pack one step's host arrays into one array and copy it into the
        static buffer (on a card non-blocking from pinned memory, whose
        block the caching host allocator keeps until the copy is done)."""
        packed = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int64).ravel() for a in arrays]))
        if self.device.type == "cuda":
            packed = packed.pin_memory()
        self._staged[:packed.numel()].copy_(packed, non_blocking=True)

    def _entry(self, kind: str, b: int, count: bool = True):
        """The captured program of (kind, bucket b). A new one (or one
        whose parameters moved) is captured on inactive dummy inputs
        staged first, and counts in :attr:`n_traces` unless ``count`` is
        False (the warm-up)."""
        def build():
            self._params = self.model.params
            views, o = [], 0
            dummy = []
            for name, shape in self._fields(kind, b):
                n = int(np.prod(shape))
                views.append(self._staged[o:o + n].view(shape))
                o += n
                dummy.append(np.full(n, 1 if name in ("lengths", "n_draft")
                                     else 0, np.int64))
            self._stage(dummy)
            return _program_body(
                self.model, self._params, kind,
                [name for name, _ in self._fields(kind, b)],
                (self._h[:b], self._c[:b], self.kv.k_pages, self.kv.v_pages),
                self._tokens_dev[:b], self.kv.page_size), views
        return self._programs.get((kind, b), build, count=count,
                                  what=f"decode {kind} bucket {b}")

    @property
    def n_traces(self) -> int:
        """Programs captured outside :meth:`warmup`: 0 while the warm-up
        covered every (kind, bucket) traffic needs and the parameters
        stayed where they were."""
        return self._programs.n_traces

    def memory_report(self):
        """The field-wise max of the captured programs' allocator
        footprints, None before a capture or on the CPU."""
        reports = [p.memory for p in self._programs.programs()
                   if p.memory is not None]
        return _telemetry.memory.MemoryReport.merge(reports) \
            if reports else None

    def lower_entry(self, *args, batch_size: Optional[int] = None,
                    **kwargs):
        """Record one slot bucket's DECODE program for static analysis
        (the dict of ``CompiledPredictor.lower_entry``, mode ``predict``):
        one eager run of the program's body on inactive dummy inputs, as
        a capture's warm-up runs it, over copies of the slot rows and the
        token buffer (the engine may hold live requests). No graph is
        captured, no capture counted. Cached per bucket."""
        from ..analysis import schedule as _sched
        b = self._bucket_for(int(batch_size) if batch_size
                             else self.slots)
        info = self._analysis.get(b)
        if info is not None:
            return info
        fields = self._fields("decode", b)
        staged = torch.zeros_like(self._staged)
        views, o = [], 0
        for name, shape in fields:
            n = int(np.prod(shape))
            views.append(staged[o:o + n].view(shape))
            if name == "lengths":
                views[-1].fill_(1)
            o += n
        body = _program_body(
            self.model, self.model.params, "decode",
            [name for name, _ in fields],
            (self._h[:b].clone(), self._c[:b].clone(), self.kv.k_pages,
             self.kv.v_pages), self._tokens_dev[:b].clone(),
            self.kv.page_size)
        rec, _ = _sched.record(body, *views)
        rec.meta.update(mode="predict", device=str(self.device))
        info = dict(kind="predict", mode="predict", schedule=rec,
                    mesh=None, axis=None, expected_donated=None,
                    unit_sizes=[], n_params=len(self.model.params),
                    n_state_leaves=0, blessed_dtypes=[], table=None,
                    report=None)
        self._analysis[b] = info
        return info

    def analyze(self, batch_size: Optional[int] = None):
        """The program lint of the decode step of a bucket
        (:class:`~mxnet_tpu_torch.analysis.ProgramReport`, ``predict``
        expectations: no collectives, no host transfers, no unblessed
        dtype drift, the kernel census)."""
        from ..analysis.program import analyze_step
        return analyze_step(self, batch_size=batch_size)

    def _bucket_for(self, rows: int) -> int:
        """The smallest ladder bucket of at least ``rows`` slots."""
        for b in self._ladder:
            if rows <= b:
                return b
        return self._ladder[-1]

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> dict:
        """Capture the decode and prefill programs (and the verify one
        with ``spec_k``) of every ladder bucket before traffic, so no
        request pays for a capture and live steps capture nothing.
        Returns {(kind, bucket): seconds of its capture}."""
        out = {}
        kinds = ("decode", "prefill", "verify") if self._spec_k > 0 \
            else ("decode", "prefill")
        with self._lock:
            for b in (buckets or self._ladder):
                for kind in kinds:
                    out[(kind, int(b))] = self._entry(
                        kind, int(b), count=False).capture_s
        return out

    def _check_budget(self, ps: int):
        """``MXNET_MEMORY_BUDGET`` against this engine's real geometry:
        its page pools, plus ``spec_k`` uncommitted positions a slot (the
        speculative overrun). Raises ``MXNetError`` where they do not
        fit."""
        budget = _telemetry.memory.memory_budget()
        if budget is None:
            return
        need = self.kv.total_bytes()
        if self._spec_k:
            extra = pages_needed(self.max_context + self._spec_k, ps) \
                - self.max_pages_per_slot
            need += self.slots * extra * self.kv.bytes_per_page
        if need > budget:
            raise MXNetError(
                f"DecodeEngine: the KV page pools ({self.kv.num_pages} "
                f"pages of {ps} positions) and the spec_k={self._spec_k} "
                f"overrun need {need} B, over MXNET_MEMORY_BUDGET "
                f"({budget} B): lower the page size, slots, max_context "
                "or spec_k")

    def _active(self):
        self._m_active.set(sum(1 for o in self._occupant
                               if o is not None))

    # ---------------- admission ----------------
    def _reject(self, reason: str, msg: str):
        self.stats["rejected"] += 1
        self._m_rejected.inc(label=reason)
        raise Overloaded(msg, reason=reason)

    def submit(self, prompt, max_new: Optional[int] = None,
               eos: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> DecodeStream:
        """Admit one request (or shed it with a typed ``Overloaded``) and
        return its token stream. Admission, in order: draining, queue
        depth, the deadline shedder, and the KV page reservation
        (``reason="kvcache"``)."""
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.size < 1:
            raise MXNetError("decode prompt must have >= 1 token")
        mn = self.max_new_default if max_new is None else max(1,
                                                              int(max_new))
        if deadline_ms is None:
            deadline_ms = default_deadline_ms()
        with self._lock:
            if self._dead is not None:
                raise ServingShutdown(
                    "DecodeEngine is shut down") from self._dead
            if self._draining:
                self._reject("draining",
                             "DecodeEngine is draining; request shed")
            if len(self._queue) >= self._depth:
                self._reject("queue", f"decode queue full ({self._depth})")
            slack = max(1, self._window.max_inflight)
            if self._spec_k:
                # a verify step writes up to spec_k draft positions past
                # the committed length before acceptance trims
                slack += self._spec_k
            need_tokens = int(prompt.size) + mn + slack
            if need_tokens > self.max_pages_per_slot * self.kv.page_size:
                raise MXNetError(
                    f"request needs {need_tokens} KV positions "
                    f"(prompt {prompt.size} + max_new {mn} + inflight "
                    f"slack {slack}) > max_context {self.max_context}")
            npages = pages_needed(need_tokens, self.kv.page_size)
            if self._prefix_share:
                # price only the unshared tail: full pages a registered
                # prefix covers are mapped, not allocated
                ent = self.kv.lookup_prefix(
                    prompt, max_pos=int(prompt.size) - 1)
                if ent is not None:
                    npages = max(1, npages - ent.pos // self.kv.page_size)
            if (deadline_ms is not None and shed_mode() != "off"
                    and self._ewma_step is not None):
                projected = self._ewma_step * (len(self._queue) + 1)
                if projected * 1e3 > float(deadline_ms):
                    self._reject(
                        "deadline",
                        f"projected first-token wait {projected * 1e3:.1f}"
                        f" ms exceeds deadline {deadline_ms:.1f} ms")
            now = self._clock()
            stream = DecodeStream(now)
            deadline = (now + float(deadline_ms) / 1e3
                        if deadline_ms is not None else None)
            req = _Request(prompt, mn, eos, stream, deadline, npages,
                           self._seq, need_tokens=need_tokens)
            self._seq += 1
            if self.admission and not self.kv.reserve(req, npages):
                self._reject(
                    "kvcache",
                    f"KV page pool exhausted: need {npages} page(s), "
                    f"{self.kv.free_pages()} free of "
                    f"{self.kv.num_pages - 1}")
            self._queue.append(req)
            self.stats["submitted"] += 1
            self._work.notify_all()
            return stream

    # ---------------- scheduling ----------------
    def _bucket_for(self, n: int) -> int:
        for b in self._ladder:
            if b >= n:
                return b
        return self._ladder[-1]

    def _bucket(self) -> int:
        hi = max((s + 1 for s in range(self.slots)
                  if self._occupant[s] is not None), default=1)
        return self._bucket_for(hi)

    def _refill(self):
        if self.static and any(o is not None for o in self._occupant):
            return           # whole-batch barrier
        ps = self.kv.page_size
        for slot in range(self.slots):
            if not self._queue:
                break
            if self._occupant[slot] is not None:
                continue
            req = self._queue[0]
            tot = (pages_needed(req.need_tokens, ps)
                   if req.need_tokens else req.npages)
            ent = None
            if self._prefix_share and req.prompt.size > 1:
                # the authoritative seat-time lookup; >= 1 prompt token
                # stays to prefill, so the last chunk makes token one
                ent = self.kv.lookup_prefix(
                    req.prompt, max_pos=int(req.prompt.size) - 1)
            if ent is not None:
                shared = list(ent.pages)
                own_n = max(0, tot - len(shared))
                own = self.kv.alloc(req, own_n) if own_n else []
                if own is None:      # admission=False: wait
                    break
                self.kv.share(req, shared)
                # keep ONE spare page when the last shared page is
                # partial: the copy-on-write target of the first write
                self.kv.trim_reservation(req, 1 if ent.pos % ps else 0)
                pages = shared + list(own)
                self._device_len[slot] = ent.pos
                req.pos = ent.pos
                req.shared_len = ent.pos
                if ent.state is not None:
                    self._h[slot].copy_(ent.state[0])
                    self._c[slot].copy_(ent.state[1])
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens"] += ent.pos
            else:
                pages = self.kv.alloc(req, tot)
                if pages is None:    # admission=False: wait
                    break
                self._device_len[slot] = 0
            self._queue.popleft()
            req.slot = slot
            req.phase = "prefill"
            self._occupant[slot] = req
            self._table[slot, :] = 0
            self._table[slot, :len(pages)] = pages
            self._active()

    def _plan(self):
        occ = self._occupant
        pre = [s for s in range(self.slots)
               if occ[s] is not None and occ[s].phase == "prefill"]
        dec = [s for s in range(self.slots)
               if occ[s] is not None and occ[s].phase == "decode"
               and not occ[s].done]
        kind = "decode"
        if self._spec_k:
            # a slot joins a verify step once its first token retired
            # (the drafter proposes from host history) and its previous
            # verify is out of flight
            kind = "verify"
            dec = [s for s in dec if not occ[s].inflight
                   and occ[s].generated >= 1]
        if self.static:
            if pre:
                return "prefill", min(pre, key=lambda s: occ[s].seq)
            if dec:
                return kind, dec
            return None, None
        # continuous: prefill never runs twice in a row while decode work
        # exists (the non-starvation rule)
        if pre and (not dec or not self._last_was_prefill):
            return "prefill", min(pre, key=lambda s: occ[s].seq)
        if dec:
            return kind, dec
        return None, None

    def step_once(self) -> bool:
        """One scheduler iteration: refill free slots, dispatch one model
        call (a decode or verify step over every active slot, or one
        prefill chunk) and push it into the window. False when there is
        no work."""
        with self._lock:
            if self._dead is not None:
                return False
            self._refill()
            kind, what = self._plan()
            if kind is None:
                return False
            try:
                if kind == "prefill":
                    self._dispatch_prefill(what)
                elif kind == "verify":
                    self._dispatch_verify(what)
                else:
                    self._dispatch_decode(what)
            except MXNetError as e:
                self._fail_all(e)
                return False
            return True

    def sync(self):
        """Retire every in-flight step: delivers all tokens computed so
        far to their streams."""
        with self._lock:
            if len(self._window):
                self._window.drain()

    def _push(self, meta: tuple, arr):
        self._tag += 1
        self._window.push((meta, arr), tag=f"{meta[0]}#{self._tag}")

    def _cow_guard(self, slot: int, req: _Request, start: int, n: int):
        """Copy-on-write fence: before a dispatch writes positions
        [start, start + n), give the slot private copies of the pages in
        that range still shared with another request. Runs before the
        dispatch uploads the table."""
        if not self._prefix_share or n <= 0:
            return
        ps = self.kv.page_size
        for pi in range(start // ps, (start + n - 1) // ps + 1):
            page = int(self._table[slot, pi])
            if page and self.kv.page_shared(page):
                self._table[slot, pi] = self.kv.cow(req, page)

    def _dispatch_decode(self, slots_active: List[int]):
        b = self._bucket()
        ps = self.kv.page_size
        pidx = np.zeros(b, np.int64)
        poff = np.zeros(b, np.int64)
        lengths = np.ones(b, np.int64)
        act = np.zeros(b, bool)
        metas = []
        for s in slots_active:
            dl = int(self._device_len[s])
            self._cow_guard(s, self._occupant[s], dl, 1)
            pidx[s] = self._table[s, dl // ps]
            poff[s] = dl % ps
            lengths[s] = dl + 1
            act[s] = True
            metas.append((s, self._occupant[s]))
            self._device_len[s] += 1
        prog = self._entry("decode", b)
        self._stage((pidx, poff, self._table[:b], lengths, act))
        nxt = prog.run()
        self.stats["steps"] += 1
        self._last_was_prefill = False
        self._push(("decode", metas, self._clock()), nxt)

    def _dispatch_prefill(self, slot: int):
        req = self._occupant[slot]
        b = self._bucket()
        C = self._chunk
        n_valid = min(C, req.prompt.size - req.pos)
        toks = np.zeros((b, C), np.int64)
        toks[slot, :n_valid] = req.prompt[req.pos:req.pos + n_valid]
        start = np.zeros(b, np.int64)
        start[slot] = self._device_len[slot]
        nv = np.zeros(b, np.int64)
        nv[slot] = n_valid
        reset = np.zeros(b, bool)
        reset[slot] = req.pos == 0
        act = np.zeros(b, bool)
        act[slot] = True
        self._cow_guard(slot, req, int(start[slot]), n_valid)
        prog = self._entry("prefill", b)
        self._stage((toks, start, nv, reset, act, self._table[:b]))
        nxt = prog.run()
        self._device_len[slot] += n_valid
        req.pos += n_valid
        final = req.pos >= req.prompt.size
        if final:
            # the slot joins the decode batch next iteration; its first
            # token chains on the device into the token array
            req.phase = "decode"
            self._tokens_dev[slot:slot + 1].copy_(nxt[slot:slot + 1])
        reg = None
        if self._prefix_share:
            # snapshot now: clones, because the live rows go on changing
            # before the retire registers the prefix
            npg = pages_needed(req.pos, self.kv.page_size)
            reg = (np.ascontiguousarray(req.prompt[:req.pos]), req.pos,
                   [int(p) for p in self._table[slot, :npg]],
                   (self._h[slot].clone(), self._c[slot].clone()))
        self.stats["prefill_chunks"] += 1
        self._last_was_prefill = True
        self._push(("prefill", slot, req, final, self._clock(), reg), nxt)

    def _dispatch_verify(self, slots_active: List[int]):
        b = self._bucket()
        ps = self.kv.page_size
        K = self._spec_k + 1
        toks = np.zeros((b, K), np.int64)
        start = np.zeros(b, np.int64)
        nd = np.ones(b, np.int64)
        act = np.zeros(b, bool)
        metas = []
        for s in slots_active:
            req = self._occupant[s]
            dl = int(self._device_len[s])
            # never draft past the request's token budget or its table
            room = self.max_pages_per_slot * ps - dl - 1
            left = req.max_new - req.generated - 1
            k_prop = max(0, min(self._spec_k, left, room))
            drafts = (list(self._drafter.propose(req.history,
                                                 k_prop))[:k_prop]
                      if k_prop else [])
            n = 1 + len(drafts)
            toks[s, 0] = req.history[-1]
            if drafts:
                toks[s, 1:n] = drafts
            start[s] = dl
            nd[s] = n
            act[s] = True
            req.inflight = True
            self._cow_guard(s, req, dl, n)
            metas.append((s, req, n))
        prog = self._entry("verify", b)
        self._stage((toks, start, nd, act, self._table[:b]))
        emitted, n_acc = prog.run()
        self.stats["steps"] += 1
        self.stats["spec_steps"] += 1
        self._last_was_prefill = False
        self._push(("verify", metas, self._clock()), (emitted, n_acc))

    # ---------------- retire (the one host sync) ----------------
    def _observe_step(self, t0: float, now: float):
        dt = max(0.0, now - t0)
        self._ewma_step = dt if self._ewma_step is None \
            else 0.8 * self._ewma_step + 0.2 * dt

    def _retire_sync(self, payload):
        meta, arr = payload
        if meta[0] == "verify":
            emitted = arr[0].cpu().numpy()
            n_acc = arr[1].cpu().numpy()
        else:
            toks = arr.cpu().numpy()
        now = self._clock()
        if meta[0] == "decode":
            _, pairs, t0 = meta
            self._observe_step(t0, now)
            for slot, req in pairs:
                if not req.done:
                    self._deliver(slot, req, int(toks[slot]), now)
        elif meta[0] == "verify":
            _, triples, t0 = meta
            self._observe_step(t0, now)
            for slot, req, n in triples:
                req.inflight = False
                if req.done:
                    continue
                a = max(1, min(int(n_acc[slot]), n))
                # the KV commit is length bookkeeping: the verify wrote
                # positions [dl, dl + n), attention masks by lengths, and
                # a later step overwrites the rejected tail
                self._device_len[slot] += a
                drafted, accepted = n - 1, a - 1
                self.stats["spec_drafted"] += drafted
                self.stats["spec_accepted"] += accepted
                self._m_drafted.inc(drafted)
                self._m_accepted.inc(accepted)
                hist = self.stats["accept_hist"]
                hist[a] = hist.get(a, 0) + 1
                req.stream._record_step(a, drafted, accepted)
                for t in range(a):
                    self._deliver(slot, req, int(emitted[slot, t]), now)
                    if req.done:
                        break
        else:
            _, slot, req, final, _t0, reg = meta
            if reg is not None and not req.done:
                toks_r, pos_r, pages_r, state_r = reg
                self.kv.register_prefix(toks_r, pos_r, pages_r,
                                        state=state_r)
            if final and not req.done:
                self._deliver(slot, req, int(toks[slot]), now)
        self.stats["kv_shared_peak"] = max(self.stats["kv_shared_peak"],
                                           self.kv.shared_pages())
        self.stats["kv_util_peak"] = max(self.stats["kv_util_peak"],
                                         self.kv.utilization())

    def _deliver(self, slot: int, req: _Request, tok: int, now: float):
        first = req.generated == 0
        req.generated += 1
        req.history.append(int(tok))
        req.stream._deliver(tok, now)
        self.stats["tokens"] += 1
        self._m_tokens.inc()
        if first:
            self._m_ttft.observe(max(0.0, now - req.t_submit))
        else:
            gap = max(0.0, now - req.t_last_tok)
            self._m_tpot.observe(gap)
            self._ewma_tpot = gap if self._ewma_tpot is None \
                else 0.8 * self._ewma_tpot + 0.2 * gap
        req.t_last_tok = now
        if req.deadline is not None and now > req.deadline:
            self.stats["deadline_missed"] += 1
            self._finish_slot(slot, req, DeadlineExceeded(
                f"decode request missed its deadline after "
                f"{req.generated} token(s)"))
            return
        eos = req.eos if req.eos is not None else self.eos_id
        if (eos is not None and tok == eos) or req.generated >= req.max_new:
            self._finish_slot(slot, req, None)
            return
        # per-token deadline re-projection: shed the stream now when the
        # remaining tokens cannot land inside its deadline, freeing its
        # pages for streams that can
        left = req.max_new - req.generated
        if req.deadline is not None and self._ewma_tpot is not None \
                and now + left * self._ewma_tpot > req.deadline:
            self.stats["deadline_missed"] += 1
            self.stats["shed_midstream"] += 1
            self._finish_slot(slot, req, DeadlineExceeded(
                f"decode stream shed mid-flight after {req.generated} "
                f"token(s): projected remaining decode time ({left} x "
                f"{self._ewma_tpot * 1e3:.2f} ms TPOT) overruns the "
                f"deadline"))

    def _finish_slot(self, slot: int, req: _Request,
                     exc: Optional[BaseException]):
        req.done = True
        if self._occupant[slot] is req:
            self._occupant[slot] = None
            self._table[slot, :] = 0
            self._active()
        self.kv.release(req)
        if exc is None:
            self.stats["completed"] += 1
            req.stream._finish()
        else:
            req.stream._fail(exc)
        self._work.notify_all()

    def _fail_requests(self, exc: BaseException):
        for slot in range(self.slots):
            req = self._occupant[slot]
            if req is not None and not req.done:
                req.done = True
                self.kv.release(req)
                req.stream._fail(exc)
            self._occupant[slot] = None
        self._m_active.set(0)
        while self._queue:
            req = self._queue.popleft()
            self.kv.release(req)
            req.stream._fail(exc)

    def _fail_all(self, exc: BaseException):
        self._dead = exc
        self._window.abandon()
        self._fail_requests(exc)

    # ---------------- lifecycle ----------------
    def _idle(self) -> bool:
        return (not self._queue and len(self._window) == 0
                and all(o is None for o in self._occupant))

    def _drain_window(self) -> bool:
        """Retire what is in flight; False (and the engine failed) when a
        retire raised."""
        try:
            self._window.drain()
            return True
        except MXNetError as e:
            self._fail_all(e)
            return False

    def _serve_loop(self):
        while not self._stop.is_set():
            if self.step_once():
                continue
            with self._lock:
                if len(self._window):
                    self._drain_window()
                    continue
            with self._work:
                self._work.wait(0.002)

    def drain(self, timeout: float = 60.0) -> bool:
        """Stop admitting (later submits shed with ``reason="draining"``)
        and run every accepted request to completion. True when fully
        drained."""
        with self._lock:
            self._draining = True
            self._work.notify_all()
        if self._thread is not None:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if self._idle() or self._dead is not None:
                        return self._dead is None
                time.sleep(0.002)
            return False
        while True:
            if self.step_once():
                continue
            with self._lock:
                if len(self._window):
                    if not self._drain_window():
                        return False
                    continue
                return self._idle()

    def close(self, timeout: float = 5.0):
        """Drain the window, fail anything still queued or running with a
        typed ``ServingShutdown``, stop the dispatch thread."""
        self._stop.set()
        with self._work:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        with self._lock:
            try:
                if len(self._window):
                    self._window.drain()
            except MXNetError:
                self._window.abandon()
            if self._dead is None:
                exc = ServingShutdown("DecodeEngine closed")
                self._fail_requests(exc)
                self._dead = exc
            self._programs.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# the harness: continuous vs static A/B
# ---------------------------------------------------------------------------

def run_decode(model, prompts, max_new, *, static: bool = False,
               ladder: Optional[Sequence[int]] = None,
               page_size: Optional[int] = None,
               eos_id: Optional[int] = None, inflight: int = 1,
               warmup: bool = True, spec_k: Optional[int] = None,
               prefix_share: Optional[bool] = None,
               drafter=None) -> dict:
    """Submit every request up front and drive the engine to completion
    (the JAX package's bench ``decode`` leg). ``static`` selects the
    whole-batch baseline; everything else is identical, so the difference
    is scheduling. Besides the JAX report this returns each request's
    tokens (``tokens_by_request``), the kernel launches of the run after
    the warm-up (``launches``), the warm-up's capture seconds per
    (kind, bucket) (``captures``) and the programs the run captured after
    it (``n_traces``)."""
    prompts = [np.asarray(p, np.int32).ravel() for p in prompts]
    mns = ([int(max_new)] * len(prompts) if isinstance(max_new, int)
           else [int(m) for m in max_new])
    sk = (globals()["spec_k"]() if spec_k is None else max(0, int(spec_k)))
    slack = max(1, int(inflight)) + sk
    ps = int(page_size) if page_size else kv_page_size()
    mc = max(int(p.size) + m + slack for p, m in zip(prompts, mns))
    # every request can hold its reservation at once: the A/B measures
    # scheduling, not page starvation
    total_pages = 1 + sum(pages_needed(p.size + m + slack, ps)
                          for p, m in zip(prompts, mns))
    eng = DecodeEngine(model, ladder=ladder, num_pages=total_pages,
                       page_size=ps, max_context=mc, eos_id=eos_id,
                       inflight=inflight, depth=len(prompts) + 1,
                       static=static, start=False, spec_k=sk,
                       prefix_share=prefix_share, drafter=drafter)
    try:
        warm = eng.warmup() if warmup else {}
        before = launch_counts()
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new=m) for p, m in zip(prompts, mns)]
        eng.drain()
        wall = time.perf_counter() - t0
        after = launch_counts()
        recs = [s.record() for s in streams]
        tokens = sum(r["tokens"] for r in recs)
        from . import loadgen
        out = {
            "mode": "static" if static else "continuous",
            "requests": len(prompts),
            "tokens": int(tokens),
            "wall_s": wall,
            "decode_tokens_per_sec": tokens / wall if wall > 0 else None,
            "steps": eng.stats["steps"],
            "prefill_chunks": eng.stats["prefill_chunks"],
            "kv_page_util": eng.stats["kv_util_peak"],
            "kv_num_pages": eng.kv.num_pages,
            "slot_ladder": list(eng._ladder),
            "page_size": ps,
            "errors": sum(1 for r in recs if r["outcome"] != "ok"),
            "warmup_s": sum(warm.values()),
            "captures": {f"{k} {b}": t for (k, b), t in warm.items()},
            "n_traces": eng.n_traces,
            "launches": {k: after[k] - before[k] for k in after},
            "tokens_by_request": [s.result(0) if r["outcome"] == "ok"
                                  else None
                                  for s, r in zip(streams, recs)],
        }
        if eng._spec_k:
            st = eng.stats
            out["spec_k"] = eng._spec_k
            out["spec_steps"] = st["spec_steps"]
            out["spec_drafted"] = st["spec_drafted"]
            out["spec_accepted"] = st["spec_accepted"]
            out["accept_hist"] = dict(st["accept_hist"])
        if eng._prefix_share:
            kvs = eng.kv.stats()
            out["prefix_hits"] = kvs["prefix_hits"]
            out["cow_copies"] = kvs["cow_copies"]
            out["kv_shared_peak"] = eng.stats["kv_shared_peak"]
        out.update(loadgen.streaming_summary(recs, wall))
        return out
    finally:
        eng.close()
