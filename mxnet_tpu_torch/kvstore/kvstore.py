"""Key-value stores (counterpart of ``mxnet_tpu/kvstore/kvstore.py``):
the single-process :class:`KVStore` (``'device'``, ``'local'``,
``'tpu'``, ``'nccl'``) and the store of several processes,
:class:`KVStoreDist` (``'dist'``, ``'dist_sync'``, ``'dist_async'``,
``'dist_device_sync'``, ``'p3'``).

One process holds one logical array per key, so a pushpull of one value
is the identity and of several values their sum. Under data parallelism
over a dp mesh the gradient reduction is not the store's: it lives in
the train step (``gluon.fused_step``), which reads
:attr:`KVStore.in_program_reduce` and
:attr:`KVStore.in_program_reduce_scatter` to decide whether it may own
the reduction (the ZeRO sharded update, or one all-reduce a gradient).

:class:`KVStoreDist` sums across the ranks of the default
``torch.distributed`` group (``parallel.dist``: NCCL on the card, gloo
on the CPU) where the JAX package sums over a mesh of one device a
process. Its :meth:`KVStoreDist.pushpull_list` packs every key's local
sum into few flat buckets of one dtype, launches each bucket's
all-reduce before it waits for any, and waits once (``dist_sync``) or
leaves the wait to the stream (``dist_async``). ``stats`` counts the
collectives it launched and its host waits. A train step cannot own its
reduction (:attr:`KVStoreDist.in_program_reduce` is False with several
ranks), so ``Trainer.compile_step`` runs its split program around the
store's ``pushpull_list``.
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch
import torch.distributed as tdist

from ..base import MXNetError
from ..parallel import dist as _dist
from .base import KVStoreBase

__all__ = ["KVStore", "KVStoreDist", "create", "LOCAL_NAMES", "DIST_NAMES"]

#: names of the single-process store
LOCAL_NAMES = ("device", "local", "tpu", "nccl")
#: names of the store of several processes
DIST_NAMES = ("dist", "dist_sync", "dist_async", "dist_device_sync", "p3")

#: elements a bucket of :meth:`KVStoreDist.pushpull_list` holds at most
#: (an array larger than that is a bucket of its own)
SLICE_THRESHOLD = 4 << 20


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _int_or_str(k: str):
    """A stored key as the updater's index (an int where it is one)."""
    try:
        return int(k)
    except ValueError:
        return k


def _reduce_sum(values: List[torch.Tensor]) -> torch.Tensor:
    """The sum of the replicas' values, a new tensor on the first's
    device."""
    acc = values[0].detach().clone()
    for v in values[1:]:
        acc += v.detach().to(acc.device)
    return acc


def _write(outs, result) -> None:
    with torch.no_grad():
        for o in _as_list(outs):
            o.copy_(result)


def _slice_threshold() -> int:
    v = os.environ.get("MXNET_KVSTORE_SLICE_THRESHOLD")
    return SLICE_THRESHOLD if v in (None, "") else int(v)


@KVStoreBase.register
class KVStore(KVStoreBase):
    """The single-process store."""

    def __init__(self, name: str = "device"):
        self._name = name
        self._store: Dict[str, torch.Tensor] = {}
        self._updater = None
        self._optimizer = None
        self._compression = None

    @property
    def type(self) -> str:
        return self._name

    # ---------------- 2.0 API ----------------
    def broadcast(self, key, value, out, priority=0):
        values = _as_list(value)
        merged = _reduce_sum(values) if len(values) > 1 \
            else values[0].detach().clone()
        self._store[str(key)] = merged
        _write(out, merged)
        return out

    def _merge(self, values: List[torch.Tensor]) -> torch.Tensor:
        """The replicas' values reduced to one tensor (a new one).
        :class:`KVStoreDist` adds the sum across the ranks."""
        return _reduce_sum(values)

    def _compressed(self, key, values: List[torch.Tensor]):
        """The values as the wire would carry them (new tensors, so the
        result is written back to the caller's originals), each replica
        with its own residual."""
        if self._compression is None:
            return values
        return [self._compression.compress_decompress(v, (str(key), i))
                for i, v in enumerate(values)]

    def _apply(self, skey: str, merged: torch.Tensor) -> torch.Tensor:
        """With an updater, run it on the store's copy of the key (seeded
        with the merged value when there is none) and return that copy;
        without one, the merged value."""
        if self._updater is None:
            return merged
        if skey not in self._store:
            self._store[skey] = merged.clone()
        self._updater(_int_or_str(skey), merged, self._store[skey])
        return self._store[skey]

    def pushpull(self, key, value, out=None, priority=0):
        values = _as_list(value)
        outs_alias = out is None or out is value or (
            len(_as_list(out)) == len(values)
            and all(o is v for o, v in zip(_as_list(out), values)))
        if (len(values) == 1 and self._updater is None
                and self._compression is None and self.num_workers == 1
                and outs_alias):
            # one replica and nothing to apply: the reduce is the identity
            return value if out is None else out
        merged = self._merge(self._compressed(key, values))
        result = self._apply(str(key), merged)
        _write(values if out is None else out, result)
        return value if out is None else out

    def pushpull_list(self, keys, values, outs=None, priority=0):
        """One pushpull a key (a one-process reduce has nothing to pack;
        :class:`KVStoreDist` buckets the keys)."""
        outs = [None] * len(keys) if outs is None else outs
        return [self.pushpull(k, v, out=o, priority=priority)
                for k, v, o in zip(keys, values, outs)]

    # ---------------- legacy API ----------------
    def init(self, key, value):
        for k, v in zip(_as_list(key), _as_list(value)):
            self._store[str(k)] = v.detach().clone()

    def push(self, key, value, priority=0):
        keys = _as_list(key)
        grouped: Dict[str, list] = {}
        if len(keys) == 1:
            grouped[str(keys[0])] = _as_list(value)
        else:
            for k, v in zip(keys, value):
                grouped.setdefault(str(k), []).extend(_as_list(v))
        for k, vals in grouped.items():
            merged = self._merge(self._compressed(k, vals))
            if self._updater is not None:
                self._apply(k, merged)
            else:
                self._store[k] = merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys = _as_list(key)
        if len(keys) == 1:
            _write(out, self._store[str(keys[0])])
        else:
            for k, o in zip(keys, _as_list(out)):
                _write(o, self._store[str(k)])
        return out

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull: the port has no sparse storage "
                         "yet (ROADMAP.md queue 1, item 8)")

    # ---------------- optimizer on the store ----------------
    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        from ..optimizer import get_updater
        self._optimizer = optimizer
        self._updater = get_updater(optimizer)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The store's updater's states in the Updater's pickle (the JAX
        package's format), written atomically."""
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        from ..checkpoint.atomic import atomic_write_bytes
        atomic_write_bytes(fname, self._updater.get_states(dump_optimizer),
                           fault="kvstore.save_optimizer_states")

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # ---------------- compression ----------------
    def set_gradient_compression(self, compression_params):
        from ..parallel.compression import GradientCompression
        self._compression = GradientCompression(**compression_params)

    # ---------------- train-step integration ----------------
    @property
    def in_program_reduce(self) -> bool:
        """True: one process holds one logical array per parameter, so
        the train step may own the gradient reduction across ranks."""
        return True

    @property
    def in_program_reduce_scatter(self) -> bool:
        """True: the reduction may take the ZeRO-1 form (reduce-scatter,
        the update of each rank's shard, all-gather) on a dp mesh."""
        return self.in_program_reduce

    @property
    def rank(self) -> int:
        return _dist.rank()

    @property
    def num_workers(self) -> int:
        return _dist.size()

    def barrier(self):
        """The device's queued work done (a one-process sync point)."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()


@KVStoreBase.register
class KVStoreDist(KVStore):
    """The store of several processes, over the default process group.

    ``dist_sync``: every collective the store launches is waited for by
    the host before its result is used (one wait per key on the per-key
    path, one per call on :meth:`pushpull_list`). ``dist_async``: the
    collectives are launched the same way and only the stream waits for
    them (``Work.wait()``: on NCCL the compute stream, not the host), so
    the values are the same and the host runs on. In a group of one the
    sums are the identity and count nothing. ``_force_fuse = True``
    makes a group of one take the bucketed path and the train step's
    split program, as the JAX package's tests do."""

    def __init__(self, name: str = "dist_sync"):
        super().__init__(name)
        self._async = "async" in name
        #: collectives launched, host waits
        self.stats = {"collectives": 0, "blocks": 0}
        #: element counts of the last :meth:`pushpull_list`'s buckets
        self.last_buckets: List[int] = []

    @property
    def in_program_reduce(self) -> bool:
        """False with several ranks (or ``_force_fuse``): the sum crosses
        processes, so a train step routes its gradients through the
        host-side :meth:`pushpull_list` between its gradient and update
        programs."""
        return _dist.size() == 1 and not getattr(self, "_force_fuse", False)

    # -------- the collectives --------
    def _dispatch_sum(self, x: torch.Tensor):
        """Launch the all-reduce (sum) of ``x`` in place without waiting;
        its work handle, None in a group of one (the identity). Every
        rank must launch the same sums in the same order."""
        if _dist.size() == 1:
            return None
        self.stats["collectives"] += 1
        return tdist.all_reduce(x, async_op=True)

    def _block(self, works) -> None:
        """One host wait for a batch of launched collectives."""
        self.stats["blocks"] += 1
        for w in works:
            w.wait()
        dev = _dist.device()
        if dev is not None and dev.type == "cuda":
            from ..engine import allow_sync
            with allow_sync():
                torch.cuda.current_stream(dev).synchronize()

    def _finish(self, works) -> None:
        """Wait for ``works`` as the mode says: the host once (sync), or
        the stream alone (async)."""
        works = [w for w in works if w is not None]
        if not works:
            return
        if self._async:
            for w in works:
                w.wait()
        else:
            self._block(works)

    def _cross_process_sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce one tensor in place (the per-key path: in sync
        mode one host wait per key)."""
        self._finish([self._dispatch_sum(x)])
        return x

    def _merge(self, values: List[torch.Tensor]) -> torch.Tensor:
        """The local sum of the replicas, then its sum across the ranks;
        push and pushpull (and their compression) are the base store's."""
        return self._cross_process_sum(_reduce_sum(values))

    # -------- the bucketed multi-key path --------
    def pushpull_list(self, keys, values, outs=None, priority=0):
        """Every key's compressed local sum packed into flat buckets of
        one dtype (grouped by dtype first, in the shared key order, then
        split at ``MXNET_KVSTORE_SLICE_THRESHOLD`` elements, default
        4 << 20; a larger array is a bucket of its own), ONE all-reduce a
        bucket, all launched before any wait, then one wait as the mode
        says, and the sums unpacked per key: through the updater on the
        store's copy where there is one, written to ``outs`` or back to
        the caller's values. In a group of one without ``_force_fuse``
        it is the base store's per-key loop."""
        outs = [None] * len(keys) if outs is None else outs
        if _dist.size() == 1 and not getattr(self, "_force_fuse", False):
            return super().pushpull_list(keys, values, outs, priority)
        results: List = [None] * len(keys)
        by_dtype: Dict[torch.dtype, list] = {}
        for i, (k, v) in enumerate(zip(keys, values)):
            vals = _as_list(v)
            local = _reduce_sum(self._compressed(k, vals))
            by_dtype.setdefault(local.dtype, []).append(
                (i, str(k), vals, local))
        thresh = _slice_threshold()
        buckets = []
        for items in by_dtype.values():
            cur, cur_n = [], 0
            for item in items:
                n = item[3].numel()
                if cur and cur_n + n > thresh:
                    buckets.append(cur)
                    cur, cur_n = [], 0
                cur.append(item)
                cur_n += n
            if cur:
                buckets.append(cur)
        pending = []
        for b in buckets:
            buf = b[0][3].reshape(-1) if len(b) == 1 else \
                torch.cat([it[3].reshape(-1) for it in b])
            pending.append((b, buf, self._dispatch_sum(buf)))
        self.last_buckets = [int(buf.numel()) for _, buf, _ in pending]
        self._finish([w for _, _, w in pending])
        for b, buf, _ in pending:
            off = 0
            for i, skey, vals, local in b:
                n = local.numel()
                merged = buf[off:off + n].view(local.shape)
                off += n
                result = self._apply(skey, merged)
                if outs[i] is None:
                    _write(vals, result)
                    results[i] = values[i]
                else:
                    _write(outs[i], result)
                    results[i] = outs[i]
        return results

    def broadcast(self, key, value, out, priority=0):
        """Rank 0's value wins: ``torch.distributed.broadcast`` from rank
        0 (one collective, and in sync mode one host wait), kept by the
        store and written to ``out``."""
        values = _as_list(value)
        data = _reduce_sum(values)
        if _dist.size() > 1:
            self.stats["collectives"] += 1
            self._finish([tdist.broadcast(data, src=0, async_op=True)])
        self._store[str(key)] = data
        _write(out, data)
        return out

    def init(self, key, value):
        """Each key seeded with rank 0's value, written back to the
        caller's tensor on every rank."""
        for k, v in zip(_as_list(key), _as_list(value)):
            self.broadcast(k, v, out=[v])

    def barrier(self):
        if _dist.size() > 1:
            tdist.barrier()
        else:
            super().barrier()


#: name -> class (the JAX package's table)
_ALIASES = {**{n: KVStore for n in LOCAL_NAMES},
            **{n: KVStoreDist for n in DIST_NAMES}}


def create(name="local") -> KVStoreBase:
    """A store by name (an instance passes through)."""
    if isinstance(name, KVStoreBase):
        return name
    lname = name.lower()
    if lname in _ALIASES:
        return _ALIASES[lname](lname)
    if lname in KVStoreBase.kv_registry:
        return KVStoreBase.kv_registry[lname]()
    raise MXNetError(f"unknown kvstore type {name!r}")
