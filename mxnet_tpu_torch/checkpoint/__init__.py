"""Checkpoint and resume (counterpart of ``mxnet_tpu/checkpoint``, its
native atomic stack; the JAX package's orbax layer needs JAX and is not
ported): staged, checksummed checkpoints committed by one
``os.replace`` (:mod:`.atomic`), the whole train state, ZeRO shards
included (:mod:`.state`), and retention, background writes and resume
(:mod:`.manager`). ``gluon.TrainLoop(checkpoint_dir=...)`` is the
high-level entry."""
from . import atomic, manager, state
from .atomic import (CheckpointCorruptError, atomic_write_bytes,
                     latest_valid, list_checkpoints, load_latest,
                     prune_checkpoints, read_checkpoint,
                     validate_checkpoint, write_checkpoint)
from .manager import TrainCheckpointManager
from .state import (TrainState, apply_train_state, assemble_segments,
                    capture_train_state)

__all__ = ["TrainCheckpointManager", "TrainState", "capture_train_state",
           "apply_train_state", "assemble_segments", "write_checkpoint",
           "read_checkpoint", "validate_checkpoint", "load_latest",
           "latest_valid", "list_checkpoints", "prune_checkpoints",
           "atomic_write_bytes", "CheckpointCorruptError", "atomic",
           "manager", "state"]
