"""Checkpoint lifecycle: retention, background writes, resume
(counterpart of ``mxnet_tpu/checkpoint/manager.py``).

``TrainCheckpointManager`` drives the atomic format (:mod:`.atomic`):

- ``save(step, trainer, net)`` captures the state synchronously (the
  copies to the host are the only part that must pause training) and
  hands serialization, fsync and commit to a background thread, which
  overlaps the next steps;
- a failed background write surfaces at the NEXT ``save`` or ``wait``;
- after each commit the newest ``keep_last`` checkpoints stay and older
  ones are pruned (after publish, so a crash in the prune never leaves
  fewer valid checkpoints than before);
- ``restore_latest`` applies the newest checkpoint that VALIDATES,
  skipping corrupt or truncated ones with a warning.

In a process group of one host (``parallel.dist``) every rank calls the
same methods at the same steps: a ZeRO step's capture gathers the
shards over the mesh, rank 0 writes, and every rank waits in
:meth:`wait` (a collective) until rank 0's write is published, so no
rank reads a checkpoint before it exists. The JAX package's per-host
``host-<rank>/`` subtrees, for process groups over several hosts, are
not ported.

Telemetry: ``mx_checkpoint_saves_total`` / ``_errors_total`` /
``_restores_total`` and the ``mx_checkpoint_capture_seconds`` /
``_save_seconds`` / ``_recovery_seconds`` histograms (:attr:`stats` keeps
the counts and the last times beside them); with ``MXNET_TELEMETRY`` each
write is a ``checkpoint`` span; a capture's host copies are filed in the
census pool ``checkpoint`` until the write drops them.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Optional

import torch.distributed as dist

from .. import telemetry as _telemetry
from ..analysis.threads import mx_lock
from ..base import MXNetError
from ..parallel import dist as _dist
from . import atomic
from .state import TrainState, apply_train_state, capture_train_state

__all__ = ["TrainCheckpointManager"]

_LOG = logging.getLogger("mxnet_tpu_torch.checkpoint")


class TrainCheckpointManager:
    """Step-indexed atomic train-state checkpoints with retention::

        mgr = checkpoint.TrainCheckpointManager(dir, keep_last=3)
        ...
        mgr.save(step, trainer=trainer, net=net)     # async by default
        ...
        meta = mgr.restore_latest(trainer=trainer, net=net)
        start = meta["step"] if meta else 0

    ``gluon.TrainLoop(checkpoint_dir=...)`` wraps exactly this.
    """

    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True):
        if keep_last < 1:
            raise MXNetError(f"keep_last must be >= 1, got {keep_last}")
        self._root = os.path.abspath(directory)
        self._rank, self._size = _dist.rank(), _dist.size()
        self._keep_last = keep_last
        self._async = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # guards the writer handoff (_thread, _error) between save(),
        # wait() and the writer; the join runs outside it, so waiters
        # never block each other behind slow I/O
        self._mu = mx_lock("checkpoint.manager")
        self._last_restore: Optional[Dict[str, Any]] = None
        #: saves, errors, restores; seconds of the last capture, write
        #: (serialize + fsync + commit + prune) and restore
        self.stats: Dict[str, float] = {
            "saves": 0, "errors": 0, "restores": 0, "capture_s": 0.0,
            "write_s": 0.0, "restore_s": 0.0}
        t = _telemetry
        reg = t.registry()
        self._m_saves = reg.counter(t.names.CHECKPOINT_SAVES)
        self._m_errors = reg.counter(t.names.CHECKPOINT_ERRORS)
        self._m_capture = reg.histogram(t.names.CHECKPOINT_CAPTURE_SECONDS)
        self._m_write = reg.histogram(t.names.CHECKPOINT_SAVE_SECONDS)
        self._m_restores = reg.counter(t.names.CHECKPOINT_RESTORES)
        self._m_recovery = reg.histogram(
            t.names.CHECKPOINT_RECOVERY_SECONDS)

    # ---------------- save ----------------
    def save(self, step: int, trainer=None, net=None,
             extra: Optional[Dict[str, Any]] = None,
             block: Optional[bool] = None) -> TrainState:
        """Capture (synchronously) and persist (in the background unless
        ``block=True`` or ``async_save=False``) the whole train state."""
        self.wait()   # one write in flight; surfaces an earlier failure
        t0 = time.perf_counter()
        writer = self._rank == 0
        state = capture_train_state(trainer=trainer, net=net, step=step,
                                    extra=extra, keep=writer)
        self.stats["capture_s"] = time.perf_counter() - t0
        self._m_capture.observe(self.stats["capture_s"])
        # the capture's host copies live until the write drops them
        _telemetry.memory.census().register("checkpoint", state)
        if self._last_restore is not None:
            # where the run came from rides every later save
            state.meta.setdefault("resumed_from", {
                k: self._last_restore[k]
                for k in ("step", "resumed_from", "dp_from", "dp_to")})
        sync = not self._async if block is None else block
        if writer and sync:
            self._write_guarded(state)
        elif writer:
            t = threading.Thread(
                target=self._write_guarded, args=(state,),
                name=f"ckpt-write-step{step}", daemon=True)
            with self._mu:
                self._thread = t
            t.start()
        if sync:
            self.wait()
        return state

    def _write_guarded(self, state: TrainState):
        try:
            self._write(state)
        except BaseException as e:   # raised by wait() / the next save()
            _LOG.error("checkpoint write for step %d failed: %s",
                       state.step, e)
            with self._mu:
                self._error = e
                self.stats["errors"] += 1
            self._m_errors.inc()

    def _write(self, state: TrainState):
        t0 = time.perf_counter()
        atomic.write_checkpoint(self._root, state.step, state.arrays,
                                array_meta=state.array_meta,
                                meta=state.meta)
        atomic.prune_checkpoints(self._root, self._keep_last)
        t1 = time.perf_counter()
        self.stats["write_s"] = t1 - t0
        self.stats["saves"] += 1
        self._m_write.observe(t1 - t0)
        self._m_saves.inc()
        if _telemetry.active():
            # on the writer thread for a background save; the timeline
            # and the histograms hold their own locks
            _telemetry.timeline().record("checkpoint", t0, t1,
                                         step=state.step)

    def wait(self):
        """Block until the write in flight is done; re-raise its error.
        In a process group every rank calls it: rank 0's outcome is
        broadcast, so every rank returns after the write is published,
        or raises."""
        with self._mu:
            t, self._thread = self._thread, None
        if t is not None:
            t.join()        # outside the lock: never join while holding it
        with self._mu:
            err, self._error = self._error, None
        if self._size > 1 and dist.is_initialized():
            msg = [None if err is None else f"{type(err).__name__}: {err}"]
            dist.broadcast_object_list(msg, src=0)
            if err is None and msg[0] is not None:
                raise MXNetError(
                    f"checkpoint write on rank 0 failed: {msg[0]}")
        if err is not None:
            raise MXNetError(
                f"background checkpoint write failed: {err}") from err

    # ---------------- query ----------------
    def latest_step(self) -> Optional[int]:
        found = atomic.latest_valid(self._root)
        return found[0] if found else None

    def has_checkpoint(self) -> bool:
        return self.latest_step() is not None

    def latest_path(self) -> Optional[str]:
        """Directory of the newest VALID checkpoint, or None."""
        found = atomic.latest_valid(self._root)
        return found[1] if found else None

    @property
    def writing(self) -> bool:
        """Whether a background write is in flight."""
        with self._mu:
            return self._thread is not None and self._thread.is_alive()

    # ---------------- restore ----------------
    def restore_latest(self, trainer=None, net=None,
                       strict: bool = True) -> Optional[Dict[str, Any]]:
        """Apply the newest valid checkpoint; returns its meta (with
        ``"step"``), or None when the directory holds none."""
        self.wait()
        t0 = time.perf_counter()
        found = atomic.load_latest(self._root)
        if found is None:
            return None
        return self._apply_found(found, trainer, net, strict, t0)

    def restore_step(self, step: int, trainer=None, net=None,
                     strict: bool = True) -> Dict[str, Any]:
        """Apply ONE retained checkpoint (raises if it is missing or
        corrupt): a rollback, where the newest is not the state wanted."""
        self.wait()
        t0 = time.perf_counter()
        path = os.path.join(self._root, atomic.step_dir_name(step))
        arrays, manifest = atomic.read_checkpoint(path)
        return self._apply_found((step, arrays, manifest), trainer, net,
                                 strict, t0)

    def _apply_found(self, found, trainer, net, strict, t0):
        step, arrays, manifest = found
        state = TrainState(arrays, manifest.get("meta", {}),
                           array_meta=dict(manifest["arrays"]))
        meta = dict(apply_train_state(state, trainer=trainer, net=net,
                                      strict=strict))
        _LOG.info("restored checkpoint step %d from %s", step, self._root)
        meta.setdefault("step", step)
        dt = time.perf_counter() - t0
        self.stats["restores"] += 1
        self.stats["restore_s"] = dt
        self._m_restores.inc()
        self._m_recovery.observe(dt)
        dp_from = meta.get("dp_size")
        dp_to = self._current_dp()
        self._last_restore = {
            "step": int(step),
            "resumed_from": os.path.join(self._root,
                                         atomic.step_dir_name(step)),
            "dp_from": dp_from, "dp_to": dp_to,
            "reshard": (f"dp{dp_from}->dp{dp_to}"
                        if dp_from and dp_from != dp_to else None),
            "duration_s": dt, "time_unix": time.time()}
        return meta

    @staticmethod
    def _current_dp() -> int:
        from ..parallel.mesh import current_mesh
        m = current_mesh()
        return int(m.shape.get("dp", 1)) if m is not None else 1

    @property
    def restore_provenance(self) -> Optional[Dict[str, Any]]:
        """Where the current run's state came from: ``{step,
        resumed_from, dp_from, dp_to, reshard, duration_s, time_unix}``
        of the last restore through this manager (None before one).
        ``reshard`` names a dp N -> dp M change of layout."""
        return self._last_restore
