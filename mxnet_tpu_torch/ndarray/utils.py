"""Array files: ``save`` / ``load`` (counterpart of
``mxnet_tpu/ndarray/utils.py``, the same file format, so a file written
by either package loads into the other).

The file is an ``.npz``: a list of arrays or a str-keyed dict of them,
told apart by the ``__mx_tpu_list__`` entry (1 for a list, keys "0",
"1", ...), and bfloat16 stored as its uint16 bits under the key with the
suffix ``__bf16``. The write is atomic (staged, fsynced, then
``os.replace``d), under the fault point ``ndarray.save``.
"""
from __future__ import annotations

import io
import zipfile
from typing import Dict, List, Union

import numpy as np
import torch

from ..base import MXNetError
from ..checkpoint.atomic import BF16, atomic_write_bytes, host_array, \
    to_tensor
from ..context import resolve_device

__all__ = ["save", "load", "load_host"]

_MAGIC_LIST = "__mx_tpu_list__"
_BF16_SUFFIX = "__bf16"

Tensors = Union[torch.Tensor, List[torch.Tensor], Dict[str, torch.Tensor]]


def save(fname: str, data: Tensors) -> None:
    """Save a tensor, a list of tensors or a str-keyed dict of them, on
    the CPU or the card, to ``fname``."""
    if isinstance(data, torch.Tensor):
        data = [data]
    payload = {}
    if isinstance(data, dict):
        items = data.items()
        payload[_MAGIC_LIST] = np.array(0)
    elif isinstance(data, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(data))
        payload[_MAGIC_LIST] = np.array(1)
    else:
        raise MXNetError("save expects a tensor, a list or a dict of tensors")
    for k, v in items:
        if not isinstance(v, torch.Tensor):
            raise MXNetError(f"value for key {k!r} is not a tensor")
        a, logical = host_array(v)
        payload[k + (_BF16_SUFFIX if logical == BF16 else "")] = a
    # serialized whole in memory, then staged and replaced: a kill in the
    # middle never leaves a torn archive where a good file was
    buf = io.BytesIO()
    np.savez(buf, **payload)
    atomic_write_bytes(fname, buf.getvalue(), fault="ndarray.save")


def load_host(fname: str):
    """The file's arrays as CPU tensors (a list or a dict, as saved)."""
    if not zipfile.is_zipfile(fname):
        raise MXNetError(f"{fname} is not a valid saved array file")
    with np.load(fname, allow_pickle=False) as z:
        is_list = bool(z[_MAGIC_LIST]) if _MAGIC_LIST in z.files else False
        out = {}
        for k in z.files:
            if k == _MAGIC_LIST:
                continue
            a = z[k]
            if k.endswith(_BF16_SUFFIX):
                out[k[:-len(_BF16_SUFFIX)]] = to_tensor(a, BF16)
            else:
                out[k] = to_tensor(a)
    if is_list:
        return [out[str(i)] for i in range(len(out))]
    return out


def load(fname: str, device=None):
    """The file's arrays as tensors on ``device`` (``cuda:0`` unless
    ``device="cpu"``): a list or a dict, as saved."""
    dev = resolve_device(device)
    out = load_host(fname)
    if isinstance(out, list):
        return [t.to(dev) for t in out]
    return {k: t.to(dev) for k, t in out.items()}
