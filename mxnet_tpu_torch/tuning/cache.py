"""The persistent autotune-config DB: winners keyed by program identity
(counterpart of ``mxnet_tpu/tuning/cache.py``, the same file format).

A tuned config is worth its trials only if a restarted job replays it
for free: the DB maps a signature key (the program's identity: parameter
and input shapes and dtypes, the step's mode, the mesh shape, the
device, the tunable space's version) to the winning config and its
provenance (trials, score against the default's, backend, time). Keys
are content hashes, so any drift in what was tuned (a model edit,
another dp size, a grid change) is a miss, never a wrong replay.

Storage is one JSON file (``MXNET_AUTOTUNE_CACHE``) written atomically
(``checkpoint.atomic.atomic_write_bytes``); with the env unset the DB
lives in the process's memory. Each ``put`` reads, merges and rewrites
the file, so jobs tuning different programs into one file all land. The
file is the JAX package's (``{"schema": 1, "entries": {key: record}}``):
the two packages' keys differ (the device part), so one file holds
records of both and each reads its own.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Dict, Optional

from ..analysis.threads import mx_lock

__all__ = ["AutotuneCache", "cache_path", "default_cache",
           "signature_key", "step_signature", "predictor_signature",
           "device_identity", "CACHE_SCHEMA"]

_LOG = logging.getLogger("mxnet_tpu_torch.tuning")

CACHE_SCHEMA = 1


def cache_path() -> Optional[str]:
    """``MXNET_AUTOTUNE_CACHE``: the persistent DB's path (None: in
    memory only)."""
    p = os.environ.get("MXNET_AUTOTUNE_CACHE", "").strip()
    return p or None


class AutotuneCache:
    """Atomic JSON config DB; ``path=None`` keeps it in memory."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem: Dict[str, dict] = {}
        self._lock = mx_lock("tuning.cache")

    # ------------- the file -------------
    def _read_file(self) -> Dict[str, dict]:
        if not self.path or not os.path.exists(self.path):
            return {}
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("schema") != CACHE_SCHEMA:
                _LOG.warning("autotune cache %s: schema %r != %d; "
                             "ignoring", self.path, doc.get("schema"),
                             CACHE_SCHEMA)
                return {}
            entries = doc.get("entries")
            return entries if isinstance(entries, dict) else {}
        except (OSError, ValueError, AttributeError) as e:
            # a corrupt or truncated DB costs a re-tune, never a crash
            _LOG.warning("autotune cache %s unreadable (%s: %s); "
                         "treating as empty", self.path,
                         type(e).__name__, e)
            return {}

    def _write_file(self, entries: Dict[str, dict]):
        from ..checkpoint.atomic import atomic_write_bytes
        data = json.dumps({"schema": CACHE_SCHEMA, "entries": entries},
                          indent=1, sort_keys=True).encode()
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        atomic_write_bytes(self.path, data, fault="autotune.cache")

    # ------------- API -------------
    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            if key in self._mem:
                return dict(self._mem[key])
        rec = self._read_file().get(key)
        if rec is not None:
            with self._lock:
                self._mem[key] = dict(rec)
            return dict(rec)
        return None

    def put(self, key: str, record: dict, persist: bool = True):
        """Keep one winner (read, merge, rewrite when file-backed and
        ``persist``; in memory only otherwise)."""
        rec = dict(record)
        with self._lock:
            self._mem[key] = dict(rec)
        if not self.path or not persist:
            return
        with self._lock:
            entries = self._read_file()
            entries[key] = rec
            try:
                self._write_file(entries)
            except OSError as e:
                _LOG.warning("autotune cache write failed (%s: %s); "
                             "config kept in memory only",
                             type(e).__name__, e)

    def keys(self):
        entries = self._read_file()
        with self._lock:
            return sorted(set(entries) | set(self._mem))


_DEFAULT: Optional[AutotuneCache] = None
_DEFAULT_PATH: Optional[str] = None
_DLOCK = mx_lock("tuning.cache.default")


def default_cache() -> AutotuneCache:
    """The process's cache, bound to the CURRENT ``MXNET_AUTOTUNE_CACHE``
    (bound anew when the env changes)."""
    global _DEFAULT, _DEFAULT_PATH
    p = cache_path()
    with _DLOCK:
        if _DEFAULT is None or p != _DEFAULT_PATH:
            _DEFAULT = AutotuneCache(p)
            _DEFAULT_PATH = p
    return _DEFAULT


# ---------------------------------------------------------------------------
# signature keys
# ---------------------------------------------------------------------------

def signature_key(program_sig: str, mesh_shape: Any, backend: str,
                  space_sig: str) -> str:
    """The DB key: (program signature, mesh shape, device identity,
    tunable space version), content-hashed."""
    raw = f"{program_sig}|mesh={mesh_shape!r}|{backend}|{space_sig}"
    return hashlib.sha1(raw.encode()).hexdigest()


def device_identity(device) -> str:
    """What the key holds of where the program runs, in place of the JAX
    package's ``jax.default_backend()``: the torch version and the device
    type, and on a card its name and compute capability."""
    import torch
    dev = torch.device(device)
    parts = [f"torch-{torch.__version__}", dev.type]
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        props = torch.cuda.get_device_properties(idx)
        parts += [props.name, f"sm_{props.major}{props.minor}"]
    return ":".join(parts)


def _mesh_shape(mesh) -> Optional[tuple]:
    if mesh is None:
        return None
    return tuple(sorted(dict(mesh.shape).items()))


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def step_signature(step, args, kwargs=None, scope: str = "train") -> str:
    """Identity of one ``CompiledTrainStep`` program and its input
    bucket, stable across processes: every parameter's (shape, dtype) in
    the trainer's order, the input leaves' (shape, dtype) and the other
    arguments, the train / numerics / ZeRO settings, the optimizer, the
    mesh, the device and the space's signature. Anything that would
    capture another program (or change which seams exist) changes it."""
    from ..gluon.fused_step import _flatten
    from ..parallel.mesh import current_mesh
    from . import space as _space
    kwargs = kwargs or {}
    parts = ["step"]
    for p in step._trainer._all_params:
        parts.append(f"p:{tuple(p.shape)}:{_dtype(p)}:{p.grad_req}")
    leaves: list = []
    treedef = _flatten((tuple(args), dict(kwargs)), leaves)
    for leaf in leaves:
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            parts.append(f"x:{tuple(leaf.shape)}:"
                         f"{str(leaf.dtype).replace('torch.', '')}")
        else:
            parts.append(f"s:{leaf!r}")
    parts.append(f"tree:{treedef!r}")
    parts.append(f"train:{step._train_mode}")
    parts.append(f"numerics:{step._numerics}")
    parts.append(f"zero:{step._zero_requested}:{step._zero_axis}")
    parts.append(f"opt:{type(step._trainer._optimizer).__name__}")
    mesh = step._zero_mesh or current_mesh()
    return signature_key("|".join(parts), _mesh_shape(mesh),
                         device_identity(step._device),
                         _space.space_signature(scope))


def predictor_signature(pred, example, scope: str = "serving") -> str:
    """Identity of one ``CompiledPredictor`` deployment: the parameters'
    (shape, dtype), the example request's leaves (less the bucketed
    leading dim), the bucket ladder, the device and the space."""
    from . import space as _space
    parts = ["predict"]
    for p in pred.net.parameters():
        parts.append(f"p:{tuple(p.shape)}:{_dtype(p)}")
    for leaf in example:
        shp = tuple(getattr(leaf, "shape", ()))
        dt = getattr(leaf, "dtype", type(leaf).__name__)
        parts.append(f"x:{shp[1:] if shp else ()}:"
                     f"{str(dt).replace('torch.', '')}")
    parts.append(f"buckets:{pred.bucket_sizes}")
    return signature_key("|".join(parts), None,
                         device_identity(pred.device),
                         _space.space_signature(scope))
