"""Paged KV cache: the pooled page allocator behind continuous batching
(counterpart of ``mxnet_tpu/serving/kvcache.py``).

K/V history lives in fixed-size pages (``page_size`` tokens each, shared
across layers) handed to each request as it needs them:

- **Layout.** One K and one V tensor of shape ``(num_layers, num_pages,
  page_size, num_heads, head_dim)`` on the engine's device. A decode
  program reads them through a (slots, max_pages) page table and writes
  them through scatter indices. Page 0 is the null page: table padding
  and inactive slots' writes target it.
- **Written in place.** The JAX package donates the page arrays to each
  step and binds the new ones it returns; here the models write these
  two tensors in place (stream order makes that safe), so their identity
  never changes.
- **Admission = free pages.** :meth:`PagedKVCache.reserve` earmarks a
  request's worst-case pages at submit, so an admitted request never
  runs out mid-flight.
- **Prefix sharing + copy-on-write.** A content-hash registry over
  committed prefill pages (keyed by the whole token prefix, byte-verified
  on lookup so a hash collision never aliases two prefixes); a request
  whose prompt extends a registered prefix maps those pages (refcounted,
  :meth:`share`); a write onto a page held by two or more requests first
  gets a private copy (:meth:`cow`, one device-side page copy). A page
  returns to the free list when its last holder releases it, and every
  registry entry built over it goes with it.

Both page pools are filed in the memory census (pool ``kvcache``, by
weakref), so the census prices them as the allocator holds them
(``telemetry.memory.device_bytes``, equal to :meth:`PagedKVCache.
total_bytes`). Telemetry: ``mx_decode_kv_pages{state}`` (used, free,
shared) after every change, ``mx_decode_prefix_hits_total`` and
``mx_decode_cow_copies_total``.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..base import MXNetError

__all__ = ["PagedKVCache", "KV_PAGE_SIZE", "pages_needed", "prefix_hash"]

#: tokens per KV page by default (``serving.decode.kv_page_size()`` reads
#: ``MXNET_DECODE_KV_PAGE_SIZE`` over it)
KV_PAGE_SIZE = 16

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages covering ``tokens`` positions (at least one)."""
    return max(1, -(-int(tokens) // max(1, int(page_size))))


def prefix_hash(tokens) -> int:
    """Registry key of a committed token prefix: a content hash of the
    int32 token bytes. Lookups byte-verify against the stored tokens
    afterwards, so a collision alone never shares."""
    b = np.ascontiguousarray(tokens, np.int32).tobytes()
    return int.from_bytes(hashlib.blake2b(b, digest_size=8).digest(),
                          "little")


class _PrefixEntry:
    """One registered prefix: ``pages`` hold the K/V of ``tokens[:pos]``
    (the last page possibly partial); ``state`` is the engine's
    recurrent-state snapshot at ``pos`` (tensors it owns)."""

    __slots__ = ("tokens", "pages", "pos", "state")

    def __init__(self, tokens, pages, pos, state):
        self.tokens = np.ascontiguousarray(tokens, np.int32)
        self.pages = tuple(int(p) for p in pages)
        self.pos = int(pos)
        self.state = state


class PagedKVCache:
    """Fixed-size K/V pages for ``num_layers`` attention layers and a
    free-list allocator over them. Page 0 is the null page, never
    allocated."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_pages: int, page_size: Optional[int] = None,
                 dtype: Union[str, torch.dtype] = "float32",
                 device: Union[str, torch.device] = "cpu"):
        if page_size is None:
            from .decode import kv_page_size
            page_size = kv_page_size()
        if num_pages < 2:
            raise MXNetError(
                f"PagedKVCache needs num_pages >= 2 (page 0 is the "
                f"reserved null page), got {num_pages}")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_pages = int(num_pages)
        self.page_size = max(1, int(page_size))
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.device = torch.device(device)
        shape = (self.num_layers, self.num_pages, self.page_size,
                 self.num_heads, self.head_dim)
        self.k_pages = torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)
        self.v_pages = torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._owned: Dict[object, List[int]] = {}
        self._reserved: Dict[object, int] = {}
        # holder counts of pages held by >= 2 owners, the prefix
        # registry, and page -> registry keys (eviction on free)
        self._refcnt: Dict[int, int] = {}
        self._prefix: Dict[int, List[_PrefixEntry]] = {}
        self._page_keys: Dict[int, set] = {}
        self.cow_copies = 0
        self.prefix_hits = 0
        t = _telemetry
        t.memory.census().register("kvcache", self.k_pages)
        t.memory.census().register("kvcache", self.v_pages)
        reg = t.registry()
        self._g_pages = reg.gauge(t.names.DECODE_KV_PAGES,
                                  label_key="state")
        self._m_prefix_hits = reg.counter(t.names.DECODE_PREFIX_HITS)
        self._m_cow = reg.counter(t.names.DECODE_COW_COPIES)
        self._publish()

    def _publish(self):
        self._g_pages.set(self.used_pages(), label="used")
        self._g_pages.set(self.free_pages(), label="free")
        self._g_pages.set(self.shared_pages(), label="shared")

    # ---------------- accounting ----------------
    @property
    def bytes_per_page(self) -> int:
        """Bytes one page costs across K, V and every layer."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return (2 * self.num_layers * self.page_size * self.num_heads
                * self.head_dim * itemsize)

    def total_bytes(self) -> int:
        """Bytes of the two page tensors."""
        return sum(t.numel() * t.element_size()
                   for t in (self.k_pages, self.v_pages))

    def free_pages(self) -> int:
        """Allocatable pages now (reservations excluded)."""
        return len(self._free) - sum(self._reserved.values())

    def used_pages(self) -> int:
        """Physical pages allocated (a shared page counts once)."""
        return self.num_pages - 1 - len(self._free)

    def logical_pages(self) -> int:
        """Page holdings summed over owners (a shared page once per
        holder)."""
        return sum(len(p) for p in self._owned.values())

    def shared_pages(self) -> int:
        """Physical pages held by two or more owners."""
        return sum(1 for n in self._refcnt.values() if n >= 2)

    def utilization(self) -> float:
        """used / allocatable (the null page is outside both)."""
        cap = self.num_pages - 1
        return self.used_pages() / cap if cap else 0.0

    # ---------------- admission ----------------
    def can_reserve(self, n: int) -> bool:
        return self.free_pages() >= int(n)

    def reserve(self, owner, n: int) -> bool:
        """Earmark ``n`` pages for ``owner``; False (nothing reserved)
        when the pool cannot cover it."""
        n = int(n)
        if not self.can_reserve(n):
            return False
        self._reserved[owner] = self._reserved.get(owner, 0) + n
        self._publish()
        return True

    def trim_reservation(self, owner, keep: int):
        """Lower ``owner``'s reservation to at most ``keep`` pages."""
        keep = max(0, int(keep))
        if self._reserved.get(owner, 0) > keep:
            if keep:
                self._reserved[owner] = keep
            else:
                self._reserved.pop(owner, None)

    # ---------------- alloc / free ----------------
    def alloc(self, owner, n: int = 1) -> Optional[List[int]]:
        """Allocate ``n`` pages to ``owner``, drawing down its reservation
        first; None when the free list cannot cover it."""
        n = int(n)
        reserved = self._reserved.get(owner, 0)
        if max(0, n - reserved) > self.free_pages():
            return None
        if reserved:
            left = max(0, reserved - n)
            if left:
                self._reserved[owner] = left
            else:
                self._reserved.pop(owner, None)
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(pages)
        self._publish()
        return pages

    def pages_of(self, owner) -> List[int]:
        return list(self._owned.get(owner, ()))

    def release(self, owner) -> int:
        """Return ``owner``'s pages and leftover reservation; a shared
        page only leaves ``owner``'s holdings and frees (evicting its
        registry entries) with its last holder. Returns the pages
        freed."""
        pages = self._owned.pop(owner, [])
        freed = 0
        for p in reversed(pages):
            n = self._refcnt.get(p)
            if n is not None and n >= 2:
                if n == 2:
                    self._refcnt.pop(p, None)
                else:
                    self._refcnt[p] = n - 1
                continue
            self._refcnt.pop(p, None)
            self._evict_prefixes(p)
            self._free.append(p)
            freed += 1
        self._reserved.pop(owner, None)
        self._publish()
        return freed

    # ---------------- prefix sharing + copy-on-write ----------------
    def page_shared(self, page: int) -> bool:
        """Whether a write to ``page`` needs a private copy first."""
        return self._refcnt.get(int(page), 1) >= 2

    def share(self, owner, pages) -> List[int]:
        """Map already-allocated ``pages`` into ``owner``'s holdings."""
        pages = [int(p) for p in pages]
        for p in pages:
            if not 1 <= p < self.num_pages or p in self._free:
                raise MXNetError(f"share: page {p} is not allocated")
            self._refcnt[p] = self._refcnt.get(p, 1) + 1
        self._owned.setdefault(owner, []).extend(pages)
        self.prefix_hits += 1
        self._m_prefix_hits.inc()
        self._publish()
        return pages

    def cow(self, owner, page: int) -> int:
        """Copy-on-write: give ``owner`` a private copy of ``page`` (one
        device-side copy across K, V and every layer, no host sync) and
        drop its hold on the original. Returns the new page id."""
        page = int(page)
        held = self._owned.get(owner, [])
        if page not in held:
            raise MXNetError(f"cow: owner does not hold page {page}")
        got = self.alloc(owner, 1)
        if got is None:
            raise MXNetError(
                "cow: no page available for a copy-on-write target "
                "(admission under-priced the unshared tail)")
        new = got[0]
        self.k_pages[:, new].copy_(self.k_pages[:, page])
        self.v_pages[:, new].copy_(self.v_pages[:, page])
        held.remove(page)
        n = self._refcnt.get(page)
        if n is not None:
            if n <= 2:
                self._refcnt.pop(page, None)
            else:
                self._refcnt[page] = n - 1
        self.cow_copies += 1
        self._m_cow.inc()
        self._publish()
        return new

    def register_prefix(self, tokens, pos: int, pages, state=None):
        """Commit ``tokens[:pos]`` -> ``pages`` (and the recurrent-state
        snapshot ``state``) into the registry. Entries hold no refcount:
        they go when any of their pages is freed."""
        pos = int(pos)
        if pos < 1:
            return
        toks = np.ascontiguousarray(
            np.asarray(tokens, np.int32).ravel()[:pos])
        key = prefix_hash(toks)
        bucket = self._prefix.setdefault(key, [])
        for e in bucket:
            if e.pos == pos and np.array_equal(e.tokens, toks):
                return
        entry = _PrefixEntry(toks, pages, pos, state)
        bucket.append(entry)
        for p in entry.pages:
            self._page_keys.setdefault(p, set()).add(key)

    def lookup_prefix(self, prompt, max_pos: Optional[int] = None):
        """Longest registered prefix of ``prompt`` (hash lookup per
        registered length, then a byte compare), at most ``max_pos``
        long; the entry or None."""
        prompt = np.asarray(prompt, np.int32).ravel()
        cap = prompt.size if max_pos is None else min(int(max_pos),
                                                      prompt.size)
        positions = sorted({e.pos for b in self._prefix.values()
                            for e in b if e.pos <= cap}, reverse=True)
        for pos in positions:
            key = prefix_hash(np.ascontiguousarray(prompt[:pos]))
            for e in self._prefix.get(key, ()):
                if e.pos == pos and np.array_equal(e.tokens, prompt[:pos]):
                    return e
        return None

    def prefix_entries(self) -> int:
        return sum(len(b) for b in self._prefix.values())

    def _evict_prefixes(self, page: int):
        for key in self._page_keys.pop(page, ()):
            bucket = self._prefix.get(key)
            if not bucket:
                continue
            bucket[:] = [e for e in bucket if page not in e.pages]
            if not bucket:
                self._prefix.pop(key, None)

    def stats(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "used_pages": self.used_pages(),
            "logical_pages": self.logical_pages(),
            "shared_pages": self.shared_pages(),
            "free_pages": self.free_pages(),
            "reserved_pages": sum(self._reserved.values()),
            "owners": len(self._owned),
            "prefix_entries": self.prefix_entries(),
            "prefix_hits": self.prefix_hits,
            "cow_copies": self.cow_copies,
            "bytes_per_page": self.bytes_per_page,
            "total_bytes": self.total_bytes(),
            "utilization": self.utilization(),
        }
