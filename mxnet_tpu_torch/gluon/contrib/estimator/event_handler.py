"""Estimator event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``).

A handler subclasses the event bases whose hooks it implements
(``TrainBegin`` ... ``BatchEnd``); ``Estimator.fit`` calls each hook with
the estimator. ``CheckpointHandler`` writes ``<prefix>-epoch<n>.params``
(``gluon.block.save_parameters``) each ``epoch_period`` epochs and, with
``save_trainer_states``, the whole train state (parameters, optimizer
state, update counts, RNG) through ``checkpoint.TrainCheckpointManager``
under ``<model_dir>/<prefix>-ckpt/``; ``resume_from_checkpoint=True``
restores the newest valid one at ``train_begin`` and counts epochs on
from its step.
"""
from __future__ import annotations

import logging
import math
import os
import time
from typing import Optional

__all__ = ["EventHandler", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


class EventHandler:
    pass


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stops after ``max_epoch`` epochs or ``max_batch`` batches."""

    def __init__(self, max_epoch: Optional[int] = None,
                 max_batch: Optional[int] = None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            self.stop_training = True
        return self.stop_training

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            self.stop_training = True
        return self.stop_training


class MetricHandler(EpochBegin, BatchEnd):
    """Resets the training metrics each epoch and updates them each
    batch (a loss metric with the batch's loss)."""

    def __init__(self, metrics):
        self.metrics = metrics

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, pred=None, label=None, loss=None,
                  **kwargs):
        for m in self.metrics:
            if "loss" in m.name.lower():
                m.update(None, loss)
            else:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Calls ``eval_fn(val_data)`` every ``epoch_period`` epochs."""

    def __init__(self, val_data, eval_fn, epoch_period: int = 1):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.current_epoch = 0

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.current_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    """Logs the metrics each epoch, and each ``log_interval`` batches
    when that is an int."""

    def __init__(self, log_interval="epoch", metrics=None, logger=None):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.logger = logger or logging.getLogger(
            "mxnet_tpu_torch.estimator")
        self.batch_index = 0

    def _values(self):
        return ", ".join(f"{m.name}={m.get()[1]:.4f}" for m in self.metrics)

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        self.logger.info("Training end; total time %.1fs",
                         time.time() - self.train_start)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()

    def epoch_end(self, estimator, *args, **kwargs):
        self.logger.info("Epoch done (%.1fs) %s",
                         time.time() - self.epoch_start, self._values())

    def batch_end(self, estimator, *args, **kwargs):
        self.batch_index += 1
        if isinstance(self.log_interval, int) and \
                self.batch_index % self.log_interval == 0:
            self.logger.info("Batch %d %s", self.batch_index, self._values())


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Saves the parameters (and, with ``save_best``, the best by
    ``monitor``) each ``epoch_period`` epochs, and the whole train state
    with ``save_trainer_states`` (module docstring), keeping the newest
    ``keep_last``."""

    def __init__(self, model_dir: str, model_prefix: str = "model",
                 monitor=None, mode: str = "min", save_best: bool = False,
                 epoch_period: int = 1, save_trainer_states: bool = True,
                 keep_last: int = 3, resume_from_checkpoint: bool = False):
        if mode not in ("min", "max"):
            raise ValueError("mode must be min/max")
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.current_epoch = 0
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.save_trainer_states = save_trainer_states
        self.keep_last = keep_last
        self.resume_from_checkpoint = resume_from_checkpoint
        self._manager = None

    def _get_manager(self):
        if self._manager is None:
            from ....checkpoint.manager import TrainCheckpointManager
            self._manager = TrainCheckpointManager(
                os.path.join(self.model_dir, f"{self.model_prefix}-ckpt"),
                keep_last=self.keep_last)
        return self._manager

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)
        if self.resume_from_checkpoint and self.save_trainer_states:
            meta = self._get_manager().restore_latest(
                trainer=getattr(estimator, "trainer", None),
                net=getattr(estimator, "net", None), strict=False)
            if meta is not None:
                self.current_epoch = int(meta.get("step", 0))

    def epoch_end(self, estimator, *args, **kwargs):
        from ...block import save_parameters
        self.current_epoch += 1
        if self.current_epoch % self.epoch_period:
            return
        prefix = os.path.join(self.model_dir, self.model_prefix)
        save_parameters(estimator.net,
                        f"{prefix}-epoch{self.current_epoch}.params")
        trainer = getattr(estimator, "trainer", None)
        if self.save_trainer_states and trainer is not None:
            self._get_manager().save(self.current_epoch, trainer=trainer,
                                     net=estimator.net, block=True)
        if self.save_best and self.monitor is not None:
            _, val = self.monitor.get()
            if (val < self.best) if self.mode == "min" else (val > self.best):
                self.best = val
                save_parameters(estimator.net, f"{prefix}-best.params")


class EarlyStoppingHandler(TrainBegin, EpochEnd):
    """Stops once ``monitor`` has not improved by ``min_delta`` for more
    than ``patience`` epochs (a NaN reading is skipped)."""

    def __init__(self, monitor, min_delta: float = 0.0, patience: int = 0,
                 mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be min/max")
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0
        self.stop_training = False
        self.stopped_epoch = 0
        self.current_epoch = 0

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        _, val = self.monitor.get()
        if math.isnan(val):
            return self.stop_training
        improved = (val < self.best - self.min_delta) if self.mode == "min" \
            else (val > self.best + self.min_delta)
        if improved:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stop_training = True
                self.stopped_epoch = self.current_epoch
        return self.stop_training
