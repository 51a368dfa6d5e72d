"""Loss functions (counterpart of ``mxnet_tpu/gluon/loss.py``; this slice
ports ``L2Loss``, ``L1Loss``, ``SigmoidBinaryCrossEntropyLoss`` and
``SoftmaxCrossEntropyLoss``).

Each loss is an ``nn.Module`` whose ``forward(pred, label,
sample_weight=None)`` returns the PER-SAMPLE loss: the elementwise loss,
times ``sample_weight`` and the constructor's ``weight``, averaged over
every axis but ``batch_axis``. Pair it with ``loss.backward()`` (which
sums) and ``trainer.step(batch_size)``, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import nn as FNN

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if label.shape != pred.shape else label


class Loss(nn.Module):
    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_all_but_batch(self, loss):
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class L2Loss(Loss):
    """``weight / 2 * (label - pred)**2``."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(label - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_all_but_batch(loss)


class L1Loss(Loss):
    """``|label - pred|``."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.abs(label - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy; on logits (the numerically stable form) unless
    ``from_sigmoid``, with an optional ``pos_weight`` on positives."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            softrelu = F.softplus(-torch.abs(pred))
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + softrelu
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = torch.relu(pred) - pred * label + log_weight * \
                    (softrelu + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Log-softmax cross-entropy over ``axis``. Sparse labels are class
    indices (clipped into range, as the JAX package's ``pick``); dense
    labels are distributions. ``from_logits`` takes ``pred`` as
    log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = FNN.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            n = pred.shape[self._axis]
            idx = label.to(torch.long).clamp(0, n - 1)
            loss = -torch.gather(pred, self._axis,
                                 idx.unsqueeze(self._axis))
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
