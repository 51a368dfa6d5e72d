"""The KVStore interface (counterpart of ``mxnet_tpu/kvstore/base.py``).
The JAX package's registry of plug-in backends is not ported: the port
has one store (:mod:`.kvstore`)."""
from __future__ import annotations

__all__ = ["KVStoreBase"]


class KVStoreBase:
    """Backend interface: broadcast + pushpull."""

    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    @property
    def type(self) -> str:
        return type(self).__name__.lower()

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1
