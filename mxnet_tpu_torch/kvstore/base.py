"""The KVStore interface and its registry of backends (counterpart of
``mxnet_tpu/kvstore/base.py``): :meth:`KVStoreBase.register` adds a
backend class under its lower-cased class name, which ``kvstore.create``
resolves after the built-in names."""
from __future__ import annotations

from typing import Dict

__all__ = ["KVStoreBase"]


class KVStoreBase:
    """Backend interface: broadcast + pushpull."""

    kv_registry: Dict[str, type] = {}

    @staticmethod
    def register(klass):
        KVStoreBase.kv_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def is_capable(capability: str) -> bool:
        return capability in ("optimizer", "int_keys")

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
