"""Key-value stores (counterpart of ``mxnet_tpu/kvstore``): the
single-process store and the store of several processes
(``KVStoreDist``: ``dist``, ``dist_sync``, ``dist_async``,
``dist_device_sync``, ``p3``) over ``torch.distributed``."""
from .base import KVStoreBase
from .kvstore import KVStore, KVStoreDist, create

__all__ = ["KVStoreBase", "KVStore", "KVStoreDist", "create"]
