"""Estimator: a fit loop with event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator/estimator.py``).

``fit`` runs the eager training loop over ``Trainer.step``: for each
batch ``(x, y)`` the net in training mode, the loss's sum backward, then
``trainer.step(batch size)``, with the handlers called at the train,
epoch and batch boundaries (a handler that returns True from
``batch_end`` or ``epoch_end`` ends the epoch or the training).
``evaluate`` runs the net in eval mode without gradients and puts the
net's mode back after. The default trainer is the JAX package's: SGD at
lr 0.01 over every parameter of the net.
"""
from __future__ import annotations

from typing import Optional

import torch

from .... import metric as metric_mod
from ....base import MXNetError
from ...trainer import Trainer
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd)

__all__ = ["Estimator"]


def _update(metrics, loss_fn, pred, label, loss=None):
    """A loss metric (its name holds "loss") takes the loss, any other
    metric the labels and predictions."""
    for m in metrics:
        if "loss" in m.name.lower():
            m.update(None, loss_fn(pred, label) if loss is None else loss)
        else:
            m.update(label, pred)


class Estimator:
    """Trains ``net`` under ``loss`` over batches of ``(data, label)``
    with pluggable handlers. ``context`` is taken for the JAX package's
    signature and not used: the net's parameters stay on their device."""

    def __init__(self, net, loss, train_metrics=None,
                 trainer: Optional[Trainer] = None, context=None):
        self.net = net
        self.loss = loss
        if train_metrics is None:
            train_metrics = [metric_mod.Accuracy()]
        if not isinstance(train_metrics, (list, tuple)):
            train_metrics = [train_metrics]
        self.train_metrics = list(train_metrics)
        self.train_loss_metric = metric_mod.Loss("train_loss")
        self.trainer = trainer or Trainer(dict(net.named_parameters()),
                                          "sgd", {"learning_rate": 0.01})

    def _dispatch(self, handlers, event, *args, **kwargs):
        stop = False
        for h in handlers:
            stop = bool(getattr(h, event)(self, *args, **kwargs)) or stop
        return stop

    def evaluate(self, val_data, val_metrics=None):
        """One pass over ``val_data`` updating ``val_metrics`` (the train
        metrics without them), each reset first; returns the metrics."""
        metrics = val_metrics or self.train_metrics
        for m in metrics:
            m.reset()
        training = self.net.training
        self.net.eval()
        try:
            with torch.no_grad():
                for batch in val_data:
                    x, y = batch[0], batch[1]
                    _update(metrics, self.loss, self.net(x), y)
        finally:
            self.net.train(training)
        return metrics

    def fit(self, train_data, val_data=None, epochs: Optional[int] = None,
            event_handlers=None, batches: Optional[int] = None):
        """Train for ``epochs`` epochs or ``batches`` batches, whichever
        comes first. ``val_data`` is taken for the JAX package's
        signature; a ``ValidationHandler`` evaluates."""
        if epochs is None and batches is None:
            raise MXNetError("fit requires epochs or batches")
        stopper = StoppingHandler(max_epoch=epochs, max_batch=batches)
        handlers = [stopper,
                    MetricHandler([self.train_loss_metric]
                                  + self.train_metrics)]
        if event_handlers:
            handlers.extend(event_handlers)
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(
                metrics=[self.train_loss_metric] + self.train_metrics))

        def of(kind):
            return [h for h in handlers if isinstance(h, kind)]

        tb, te, eb, ee, bb, be = (of(k) for k in (
            TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
            BatchEnd))
        self.net.train()
        self._dispatch(tb, "train_begin")
        while not stopper.stop_training:
            self._dispatch(eb, "epoch_begin")
            for batch in train_data:
                x, y = batch[0], batch[1]
                self._dispatch(bb, "batch_begin")
                pred = self.net(x)
                loss = self.loss(pred, y)
                loss.sum().backward()
                self.trainer.step(x.shape[0])
                if self._dispatch(be, "batch_end", pred=pred.detach(),
                                  label=y, loss=loss.detach()):
                    break
            if self._dispatch(ee, "epoch_end"):
                break
        self._dispatch(te, "train_end")
        return self
