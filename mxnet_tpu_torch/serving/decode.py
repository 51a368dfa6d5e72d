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
futures. Next-step tokens chain on the device. The per-step index arrays
are built on the host and copied from pinned memory with
``non_blocking=True`` (a fresh pinned buffer a dispatch), so no dispatch
waits for the device: the loop runs clean under
``torch.cuda.set_sync_debug_mode("error")`` with the retire exempt.

What the JAX package's compiled programs do, these do eagerly: a model's
``decode_step`` / ``prefill_chunk`` / ``verify_chunk`` are called as they
are (:meth:`DecodeEngine.warmup` runs each (kind, bucket) once on inactive
dummy inputs). The K/V pages are written in place, where the JAX package
donates them. The state snapshots of the prefix registry are clones:
a view of the live state rows would go on changing.

Not ported yet: the ``decode.*`` tunables, telemetry and the memory census,
``lower_entry``/``analyze``, and the fleet's use of the engine.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from ..engine import DispatchWindow
from ..ops.attention import paged_decode_attention
from ..ops.kernels import launch_counts
from ..ops.kernels.rnn_scan import rnn_decode_step, rnn_verify_scan
from .batcher import queue_depth
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


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def slot_ladder() -> Tuple[int, ...]:
    """``MXNET_DECODE_SLOTS`` ('1,2,4,8'), else the default ladder."""
    v = os.environ.get("MXNET_DECODE_SLOTS")
    if not v:
        return DECODE_SLOT_LADDER
    try:
        return _parse_ladder(v)
    except ValueError:
        return DECODE_SLOT_LADDER


def kv_page_size() -> int:
    """Tokens per KV page: ``MXNET_DECODE_KV_PAGE_SIZE``, else
    ``kvcache.KV_PAGE_SIZE``."""
    return max(1, _env_int("MXNET_DECODE_KV_PAGE_SIZE", KV_PAGE_SIZE))


def prefill_chunk() -> int:
    """Prompt tokens one prefill chunk consumes:
    ``MXNET_DECODE_PREFILL_CHUNK``, else the default."""
    return max(1, _env_int("MXNET_DECODE_PREFILL_CHUNK", PREFILL_CHUNK))


def spec_k() -> int:
    """Draft tokens per speculative step (0 = off):
    ``MXNET_DECODE_SPEC_K``, else the default."""
    return max(0, _env_int("MXNET_DECODE_SPEC_K", SPEC_K))


def prefix_share() -> bool:
    """Whether the engine shares prefix pages across requests:
    ``MXNET_DECODE_PREFIX_SHARE``, else the default."""
    return bool(_env_int("MXNET_DECODE_PREFIX_SHARE", PREFIX_SHARE))


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
        self._h, self._c = model.init_state(self.slots)
        self._tokens_dev = torch.zeros(self.slots, dtype=torch.long,
                                       device=self.device)
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
        self._window = DispatchWindow(max_inflight=max(0, int(inflight)),
                                      what="decode step",
                                      sync_fn=self._retire_sync)
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
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._serve_loop, name="mxt-decode-engine",
                daemon=True)
            self._thread.start()

    # ---------------- host -> device ----------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: on a card through a fresh
        pinned buffer and a non-blocking copy (a pageable source would
        make the copy wait for the device), on the CPU a copy."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _run(self, kind: str, b: int, *args):
        """One model call of ``kind`` at bucket ``b`` (the slot rows
        [0, b) of the state)."""
        m, ps = self.model, self.kv.page_size
        state = (self._h[:b], self._c[:b], self.kv.k_pages, self.kv.v_pages)
        with torch.no_grad():
            if kind == "decode":
                tokens, pidx, poff, table, lengths, active = args
                return m.decode_step(self._params, tokens, *state, pidx,
                                     poff, table, lengths, active)
            if kind == "verify":
                tokens, start, n_draft, active, table = args
                ys, hs, cs, kp, vp = m.verify_chunk(
                    self._params, tokens, *state, start, n_draft, active,
                    table, page_size=ps)
                emitted, n_acc, nxt, h2, c2 = _accept_longest_prefix(
                    ys, hs, cs, tokens, n_draft, active)
                return emitted, n_acc, nxt, h2, c2, kp, vp
            tokens, start, n_valid, reset, active, table = args
            return m.prefill_chunk(self._params, tokens, *state, start,
                                   n_valid, reset, active, table,
                                   page_size=ps)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> dict:
        """Run each (kind, bucket) once on inactive dummy inputs (their
        writes land on the null page, the state is left as it was), so
        no request pays for a first call: the kernel build, and each
        shape's first cuBLAS and allocator work. Returns {(kind, bucket):
        seconds}."""
        out = {}
        kinds = ("decode", "prefill", "verify") if self._spec_k > 0 \
            else ("decode", "prefill")
        i64 = np.int64
        for b in (buckets or self._ladder):
            b = int(b)
            table = self._upload(np.zeros((b, self.max_pages_per_slot), i64))
            zeros = self._upload(np.zeros(b, i64))
            off = self._upload(np.zeros(b, bool))
            for kind in kinds:
                t0 = time.perf_counter()
                if kind == "decode":
                    self._run(kind, b, self._upload(np.zeros(b, i64)), zeros,
                              zeros, table, self._upload(np.ones(b, i64)),
                              off)
                elif kind == "verify":
                    self._run(kind, b, self._upload(
                        np.zeros((b, self._spec_k + 1), i64)), zeros,
                        self._upload(np.ones(b, i64)), off, table)
                else:
                    self._run(kind, b, self._upload(
                        np.zeros((b, self._chunk), i64)), zeros, zeros, off,
                        off, table)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                out[(kind, b)] = time.perf_counter() - t0
        return out

    # ---------------- admission ----------------
    def _reject(self, reason: str, msg: str):
        self.stats["rejected"] += 1
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

    def _stitch(self, b: int, h2, c2):
        """Fold one bucket's new state back into the full-slot rows (on
        the device, in stream order)."""
        self._h[:b].copy_(h2)
        self._c[:b].copy_(c2)

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
        nxt, h2, c2, _, _ = self._run(
            "decode", b, self._tokens_dev[:b], self._upload(pidx),
            self._upload(poff), self._upload(self._table[:b]),
            self._upload(lengths), self._upload(act))
        self._stitch(b, h2, c2)
        self._tokens_dev[:b].copy_(nxt)
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
        nxt, h2, c2, _, _ = self._run(
            "prefill", b, self._upload(toks), self._upload(start),
            self._upload(nv), self._upload(reset), self._upload(act),
            self._upload(self._table[:b]))
        self._stitch(b, h2, c2)
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
        emitted, n_acc, nxt, h2, c2, _, _ = self._run(
            "verify", b, self._upload(toks), self._upload(start),
            self._upload(nd), self._upload(act),
            self._upload(self._table[:b]))
        self._stitch(b, h2, c2)
        self._tokens_dev[:b].copy_(nxt)
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
        if not first:
            gap = max(0.0, now - req.t_last_tok)
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
    tokens (``tokens_by_request``) and the kernel launches of the run
    after the warm-up (``launches``)."""
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
