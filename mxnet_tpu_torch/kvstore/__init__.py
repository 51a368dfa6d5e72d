"""Key-value stores (counterpart of ``mxnet_tpu/kvstore``): the
single-process store."""
from .base import KVStoreBase
from .kvstore import KVStore, create

__all__ = ["KVStoreBase", "KVStore", "create"]
