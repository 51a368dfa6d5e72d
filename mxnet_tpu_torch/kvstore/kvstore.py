"""The single-process KVStore (counterpart of the ``'tpu'`` store of
``mxnet_tpu/kvstore/kvstore.py``), serving as ``'device'``, ``'local'``
and ``'tpu'``.

One process holds one logical array per key, so a pushpull of one value
is the identity and of several values their sum. Under data parallelism
the gradient reduction is not the store's: it lives in the train step
(``gluon.fused_step``), which reads :attr:`KVStore.in_program_reduce` and
:attr:`KVStore.in_program_reduce_scatter` to decide whether the ZeRO
sharded update may take it over. The store of several processes
(``dist_sync``, update on the store) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..base import MXNetError
from ..parallel import dist as _dist
from .base import KVStoreBase

__all__ = ["KVStore", "create", "LOCAL_NAMES"]

#: names of the single-process store
LOCAL_NAMES = ("device", "local", "tpu")


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _int_or_str(k: str):
    """A stored key as the updater's index (an int where it is one)."""
    try:
        return int(k)
    except ValueError:
        return k


def _reduce_sum(values: List[torch.Tensor]) -> torch.Tensor:
    acc = values[0].clone()
    for v in values[1:]:
        acc += v.to(acc.device)
    return acc


class KVStore(KVStoreBase):
    """The single-process store."""

    def __init__(self, name: str = "device"):
        self._name = name
        self._store: Dict[str, torch.Tensor] = {}
        self._updater = None

    @property
    def type(self) -> str:
        return self._name

    def _write(self, outs, result):
        with torch.no_grad():
            for o in _as_list(outs):
                o.copy_(result)

    def broadcast(self, key, value, out, priority=0):
        values = _as_list(value)
        merged = _reduce_sum(values) if len(values) > 1 else values[0]
        self._store[str(key)] = merged.detach().clone()
        self._write(out, merged)
        return out

    def pushpull(self, key, value, out=None, priority=0):
        values = _as_list(value)
        if len(values) == 1 and self._updater is None:
            if out is not None and out is not value:
                self._write(out, values[0])
            return value if out is None else out
        merged = _reduce_sum(values)
        if self._updater is not None:
            skey = str(key)
            if skey not in self._store:
                self._store[skey] = merged.clone()
            self._updater(key, merged, self._store[skey])
            merged = self._store[skey]
        self._write(value if out is None else out, merged)
        return value if out is None else out

    def pushpull_list(self, keys, values, outs=None, priority=0):
        outs = [None] * len(keys) if outs is None else outs
        return [self.pushpull(k, v, out=o) for k, v, o in
                zip(keys, values, outs)]

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
            merged = _reduce_sum(vals)
            if self._updater is not None:
                if k not in self._store:
                    self._store[k] = merged.clone()
                self._updater(_int_or_str(k), merged, self._store[k])
            else:
                self._store[k] = merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys = _as_list(key)
        outs = [out] if len(keys) == 1 else _as_list(out)
        for k, o in zip(keys, outs):
            self._write(o, self._store[str(k)])
        return out

    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        from ..optimizer import get_updater
        self._updater = get_updater(optimizer)

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
        if _dist.is_initialized() and _dist.size() > 1:
            torch.distributed.barrier()


def create(name="device") -> KVStoreBase:
    """A store by name (an instance passes through). Only the
    single-process store is ported."""
    if isinstance(name, KVStoreBase):
        return name
    if name in LOCAL_NAMES:
        return KVStore(name)
    raise MXNetError(f"kvstore {name!r}: only a single-process store "
                     f"{LOCAL_NAMES} is ported")
