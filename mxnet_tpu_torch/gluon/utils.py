"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
splitting a batch over devices, clipping gradients by their global
norm, and fetching files.

``download`` serves ``file://`` URLs and local paths only: the port
makes no network request.
"""
from __future__ import annotations

import hashlib
import math
import os
import shutil
from typing import List

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..host import to_tensor

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def _as_tensor(data) -> torch.Tensor:
    # a tensor as it is (to_tensor would narrow a float64 one)
    return data if isinstance(data, torch.Tensor) else to_tensor(data)


def split_data(data, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[torch.Tensor]:
    """``num_slice`` views of ``data`` along ``batch_axis``; without
    ``even_split`` the last slice takes the remainder."""
    data = _as_tensor(data)
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"cannot evenly split batch of {size} into {num_slice} slices")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        lo = i * step
        hi = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.narrow(batch_axis, lo, hi - lo))
    return slices


def split_and_load(data, ctx_list, batch_axis: int = 0,
                   even_split: bool = True) -> List[torch.Tensor]:
    """Split ``data`` along ``batch_axis`` and copy slice ``i`` to
    ``ctx_list[i]`` (a ``Context``, ``torch.device`` or device string)."""
    data = _as_tensor(data)
    devs = [resolve_device(c) for c in ctx_list]
    if len(devs) == 1:
        return [data.to(devs[0])]
    slices = split_data(data, len(devs), batch_axis, even_split)
    return [s.to(d) for s, d in zip(slices, devs)]


def clip_global_norm(arrays, max_norm: float,
                     check_isfinite: bool = True) -> float:
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling, a Python float.

    Each array's sum of squares is taken in float32 on its device; the
    sums of a device come to the host in one copy and are added there in
    float64. The arrays are multiplied by ``max_norm / (total + 1e-8)``
    only when that is below 1. A total that is not finite raises
    :class:`MXNetError` when ``check_isfinite``."""
    arrays = list(arrays)
    by_device = {}
    for a in arrays:
        by_device.setdefault(a.device, []).append(a)
    sq = []
    with torch.no_grad():
        for group in by_device.values():
            sums = torch.stack([a.detach().float().square().sum()
                                for a in group])
            sq.append(sums.to("cpu", torch.float64).numpy())
    total = math.sqrt(float(np.concatenate(sq).sum())) if sq else 0.0
    if check_isfinite and not math.isfinite(total):
        raise MXNetError(f"global norm is not finite: {total}")
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for a in arrays:
                a.mul_(scale)
    return total


def check_sha1(filename, sha1_hash) -> bool:
    """Whether the file's sha1 hex digest is ``sha1_hash`` or starts
    with it (MXNet's short hashes)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    digest = sha1.hexdigest()
    return digest == sha1_hash or digest.startswith(sha1_hash)


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """Copy ``url`` (a ``file://`` URL or a local path) to ``path`` (a
    file or a directory; default: the URL's last part here) and return
    the destination. The copy goes to a temporary file, is checked
    against ``sha1_hash`` and only then renamed into place; a
    destination that exists (and matches ``sha1_hash``) is kept unless
    ``overwrite``. No network request is made, so there is one attempt:
    ``retries`` and ``verify_ssl`` are accepted for MXNet's signature."""
    dst = path or url.split("/")[-1]
    if os.path.isdir(dst):
        dst = os.path.join(dst, url.split("/")[-1])
    if os.path.exists(dst) and not overwrite and \
            (sha1_hash is None or check_sha1(dst, sha1_hash)):
        return dst
    src = url[len("file://"):] if url.startswith("file://") else url
    if not os.path.exists(src):
        raise MXNetError(f"cannot fetch {url}: only file:// URLs and local "
                         "paths are served (no network requests)")
    tmp = f"{dst}.tmp-{os.getpid()}"
    try:
        shutil.copyfile(src, tmp)
        if sha1_hash and not check_sha1(tmp, sha1_hash):
            raise MXNetError(f"downloaded file {url} failed sha1 "
                             f"verification (expected {sha1_hash})")
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return dst
