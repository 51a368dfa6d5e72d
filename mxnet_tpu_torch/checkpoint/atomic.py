"""Atomic, checksummed checkpoint directories (counterpart of
``mxnet_tpu/checkpoint/atomic.py``, the same on-disk format, so a
checkpoint written by either package loads into the other).

Every checkpoint is

1. **staged** into a hidden temp dir (``.tmp-*``) beside its final
   place: one ``arrays/<i>.npy`` file per array, fsynced, and a
   ``manifest.json`` (``format: 1``; per array its file, CRC32, shape,
   logical dtype and byte count), fsynced too;
2. **committed** by one ``os.replace(tmp, step-<N>)``, the only point
   at which it becomes visible, then an fsync of the parent directory;
3. **published** by an atomic rewrite of the ``latest`` pointer file.

A reader never sees a partial checkpoint. :func:`load_latest` checks
every CRC and falls back to the newest older checkpoint that passes,
warning about the corrupt ones it skips.

bfloat16 is stored as its uint16 bits with ``"dtype": "bfloat16"`` in
the array's manifest entry. numpy has no bfloat16 without ``ml_dtypes``,
so the host arrays of this package keep bf16 as uint16 (:func:`host_array`
gives the logical dtype beside them) and they become ``torch.bfloat16``
only when they are applied (:func:`to_tensor`).

Fault points (``mxnet_tpu_torch.testing.faults``): ``checkpoint.stage``,
``checkpoint.manifest``, ``checkpoint.commit``, ``checkpoint.publish``,
``checkpoint.prune``, each before and after, so kill -9 tests can die at
every boundary.
"""
from __future__ import annotations

import io
import json
import logging
import os
import shutil
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..testing.faults import fault_point

__all__ = ["CheckpointCorruptError", "write_checkpoint", "read_checkpoint",
           "validate_checkpoint", "list_checkpoints", "latest_valid",
           "load_latest", "prune_checkpoints", "atomic_write_bytes",
           "step_dir_name", "host_array", "to_tensor", "MANIFEST",
           "FORMAT_VERSION"]

_LOG = logging.getLogger("mxnet_tpu_torch.checkpoint")

MANIFEST = "manifest.json"
LATEST = "latest"
FORMAT_VERSION = 1
_STEP_PREFIX = "step-"
BF16 = "bfloat16"


class CheckpointCorruptError(MXNetError):
    """Manifest unreadable or a payload failed its checksum."""


# ---------------------------------------------------------------- host arrays
def host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A COPY of ``t`` in host memory, and its logical dtype: bfloat16
    as its uint16 bits. The copy matters: a CPU tensor's ``.numpy()`` is
    a view of memory the optimizer keeps updating in place."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    return t.numpy(), str(t.numpy().dtype)


def to_tensor(arr: np.ndarray, logical: Optional[str] = None,
              device=None) -> torch.Tensor:
    """A host array as a tensor on ``device`` (the CPU by default):
    uint16 bits of logical dtype bfloat16 become ``torch.bfloat16``
    (numpy's own bfloat16, where ``ml_dtypes`` gives one, too)."""
    arr = np.asarray(arr)
    if str(arr.dtype) == BF16:
        arr, logical = arr.view(np.uint16), BF16
    if logical == BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t if device is None else t.to(device)


# ---------------------------------------------------------------- helpers
def _fsync_path(path: str):
    """fsync a file or directory by path (a directory's fsync persists
    the entries created or renamed in it)."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0) \
        if os.path.isdir(path) else os.O_RDONLY
    try:
        fd = os.open(path, flags)
    except OSError:        # pragma: no cover - platform without dir-open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _npy_bytes(arr: np.ndarray) -> Tuple[bytes, str]:
    """.npy bytes and the logical dtype; a numpy bfloat16 array goes as
    its uint16 bits."""
    logical = str(arr.dtype)
    if logical == BF16:
        arr = arr.view(np.uint16)
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue(), logical


def step_dir_name(step: int) -> str:
    return f"{_STEP_PREFIX}{int(step):010d}"


def _parse_step(name: str) -> Optional[int]:
    if not name.startswith(_STEP_PREFIX):
        return None
    try:
        return int(name[len(_STEP_PREFIX):])
    except ValueError:
        return None


def atomic_write_bytes(fname: str, data: bytes, fault: str = "ndarray.save"):
    """Crash-safe write of one file: stage to ``fname.tmp-<pid>-<id>``,
    fsync, ``os.replace`` over the destination, fsync the directory. A
    kill at any point leaves the old complete file or the new one."""
    tmp = f"{fname}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        fault_point(fault, "before")
        os.replace(tmp, fname)
        fault_point(fault, "after")
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_path(os.path.dirname(os.path.abspath(fname)))


# ---------------------------------------------------------------- write
def write_checkpoint(root: str, step: int,
                     arrays: Dict[str, np.ndarray],
                     array_meta: Optional[Dict[str, dict]] = None,
                     meta: Optional[dict] = None) -> str:
    """Write one atomic checkpoint ``<root>/step-<N>``; returns its path.

    ``arrays``: name -> host numpy array. ``array_meta``: extra JSON per
    array, merged into its manifest entry (``{"dtype": "bfloat16"}``
    marks uint16 bits as bf16). ``meta``: JSON for the whole checkpoint.
    """
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, step_dir_name(step))
    tmp = os.path.join(root, f".tmp-{step_dir_name(step)}-{os.getpid()}-"
                             f"{uuid.uuid4().hex[:8]}")
    os.makedirs(os.path.join(tmp, "arrays"))
    manifest: Dict[str, Any] = {
        "format": FORMAT_VERSION, "step": int(step),
        "meta": meta or {}, "arrays": {}}
    try:
        fault_point("checkpoint.stage", "before")
        for i, (name, arr) in enumerate(arrays.items()):
            arr = np.asarray(arr)
            raw, logical = _npy_bytes(arr)
            rel = os.path.join("arrays", f"{i}.npy")
            entry = {"file": rel, "crc32": zlib.crc32(raw),
                     "shape": [int(s) for s in arr.shape],
                     "dtype": logical, "nbytes": len(raw)}
            if array_meta and name in array_meta:
                entry.update(array_meta[name])
            manifest["arrays"][name] = entry
            with open(os.path.join(tmp, rel), "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
        fault_point("checkpoint.stage", "after")
        fault_point("checkpoint.manifest", "before")
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        fault_point("checkpoint.manifest", "after")
        _fsync_path(os.path.join(tmp, "arrays"))
        _fsync_path(tmp)
        # the ONE visibility point: before this replace the checkpoint
        # does not exist; after it, it is complete and checksummed
        fault_point("checkpoint.commit", "before")
        if os.path.isdir(final):      # the same step saved again
            _replace_dir(tmp, final)
        else:
            os.replace(tmp, final)
        fault_point("checkpoint.commit", "after")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_path(root)
    _publish_latest(root, step)
    return final


def _replace_dir(tmp: str, final: str):
    """``os.replace`` cannot overwrite a non-empty directory: move the
    old one aside first, so the final name never holds a partial one."""
    aside = final + f".old-{uuid.uuid4().hex[:8]}"
    os.replace(final, aside)
    os.replace(tmp, final)
    shutil.rmtree(aside, ignore_errors=True)


def _publish_latest(root: str, step: int):
    fault_point("checkpoint.publish", "before")
    atomic_write_bytes(os.path.join(root, LATEST),
                       (step_dir_name(step) + "\n").encode(),
                       fault="checkpoint.publish.replace")
    fault_point("checkpoint.publish", "after")


# ---------------------------------------------------------------- read
def validate_checkpoint(path: str) -> dict:
    """Parse the manifest and check every array file's CRC; returns the
    manifest. Raises :class:`CheckpointCorruptError` on any mismatch."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path}: unreadable manifest ({e})") from e
    if manifest.get("format") != FORMAT_VERSION:
        raise CheckpointCorruptError(
            f"checkpoint {path}: unsupported format "
            f"{manifest.get('format')!r}")
    for name, entry in manifest.get("arrays", {}).items():
        try:
            with open(os.path.join(path, entry["file"]), "rb") as f:
                raw = f.read()
        except OSError as e:
            raise CheckpointCorruptError(
                f"checkpoint {path}: missing payload for {name!r}") from e
        if len(raw) != entry["nbytes"] or zlib.crc32(raw) != entry["crc32"]:
            raise CheckpointCorruptError(
                f"checkpoint {path}: checksum mismatch for {name!r} "
                f"({entry['file']})")
    return manifest


def read_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Load a validated checkpoint: (arrays, manifest). A bf16 array
    comes back as its uint16 bits; ``manifest["arrays"][name]["dtype"]``
    says ``"bfloat16"``."""
    manifest = validate_checkpoint(path)
    arrays: Dict[str, np.ndarray] = {}
    for name, entry in manifest["arrays"].items():
        with open(os.path.join(path, entry["file"]), "rb") as f:
            arr = np.load(io.BytesIO(f.read()), allow_pickle=False)
        arrays[name] = arr.reshape(tuple(entry["shape"]))
    return arrays, manifest


def list_checkpoints(root: str) -> List[int]:
    """Committed step numbers under ``root``, ascending (not validated)."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        s = _parse_step(name)
        if s is not None and os.path.isdir(os.path.join(root, name)):
            steps.append(s)
    return sorted(steps)


def _latest_pointer(root: str) -> Optional[int]:
    try:
        with open(os.path.join(root, LATEST)) as f:
            return _parse_step(f.read().strip())
    except OSError:
        return None


def latest_valid(root: str) -> Optional[Tuple[int, str]]:
    """The newest checkpoint that passes validation, as (step, path), or
    None: the ``latest`` pointer's step and every committed step, newest
    first; corrupt ones are skipped with a warning."""
    root = os.path.abspath(root)
    candidates: List[int] = []
    ptr = _latest_pointer(root)
    if ptr is not None:
        candidates.append(ptr)
    for s in reversed(list_checkpoints(root)):
        if s not in candidates:
            candidates.append(s)
    candidates.sort(reverse=True)
    for s in candidates:
        path = os.path.join(root, step_dir_name(s))
        try:
            validate_checkpoint(path)
            return s, path
        except CheckpointCorruptError as e:
            _LOG.warning("skipping corrupt checkpoint: %s", e)
    return None


def load_latest(root: str) \
        -> Optional[Tuple[int, Dict[str, np.ndarray], dict]]:
    """The newest VALID checkpoint as (step, arrays, manifest), or None."""
    found = latest_valid(root)
    if found is None:
        return None
    step, path = found
    arrays, manifest = read_checkpoint(path)
    return step, arrays, manifest


def prune_checkpoints(root: str, keep_last: int,
                      protect: Tuple[int, ...] = ()):
    """Delete all but the newest ``keep_last`` committed checkpoints
    (never those in ``protect``), and stale staging dirs. Pruning runs
    after commit and publish, so a crash in it still leaves the newest
    valid checkpoints."""
    if keep_last <= 0:
        return
    steps = list_checkpoints(root)
    doomed = [s for s in steps[:-keep_last] if s not in protect]
    for s in doomed:
        fault_point("checkpoint.prune", "before")
        shutil.rmtree(os.path.join(root, step_dir_name(s)),
                      ignore_errors=True)
        fault_point("checkpoint.prune", "after")
    # staging dirs of crashed writers are garbage, not state
    if os.path.isdir(root):
        for name in os.listdir(root):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
