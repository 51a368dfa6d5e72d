"""Loss functions (counterpart of ``mxnet_tpu/gluon/loss.py``: all 14 of
its losses and their aliases).

Each loss is an ``nn.Module`` whose ``forward(pred, label,
sample_weight=None)`` returns the PER-SAMPLE loss: the elementwise loss,
times ``sample_weight`` and the constructor's ``weight``, averaged over
every axis but ``batch_axis`` (``TripletLoss``, ``CosineEmbeddingLoss``,
``PoissonNLLLoss``, ``CTCLoss`` and ``SDMLLoss`` reduce as the JAX
package's do). Pair it with ``loss.backward()`` (which sums) and
``trainer.step(batch_size)``, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import nn as FNN
from ..ops.registry import invoke

__all__ = ["Loss", "L2Loss", "L1Loss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "TripletLoss", "CosineEmbeddingLoss",
           "PoissonNLLLoss", "CTCLoss", "SDMLLoss"]


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


class HuberLoss(Loss):
    """``|e| - rho / 2`` where ``|e| > rho``, else ``e**2 / (2 rho)``,
    ``e = label - pred``."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        err = torch.abs(label - pred)
        loss = torch.where(err > self._rho, err - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(err))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)``, labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.relu(self._margin - pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)**2``, labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(torch.relu(self._margin - pred * label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class LogisticLoss(Loss):
    """The logistic loss on logits, labels in {-1, 1}
    (``label_format="signed"``) or {0, 1} (any other format)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + \
            F.softplus(-torch.abs(pred))
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


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``; ``pred`` is taken as
    log-probabilities unless ``from_logits=False`` (then log-softmax over
    ``axis`` first)."""

    def __init__(self, from_logits=True, axis=-1, weight=None,
                 batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = FNN.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class TripletLoss(Loss):
    """``max(0, |pred - positive|^2 - |pred - negative|^2 + margin)``,
    the squares summed over every axis but the first."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        axes = tuple(range(1, pred.ndim))
        loss = (torch.square(pred - positive)
                - torch.square(pred - negative)).sum(dim=axes)
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` where ``label`` is 1, else
    ``max(0, cos - margin)``; the cosine over axis 1."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        eps = 1e-12
        num = (input1 * input2).sum(dim=1)
        den = torch.sqrt((input1 * input1).sum(dim=1) + eps) * \
            torch.sqrt((input2 * input2).sum(dim=1) + eps)
        cos = num / den
        label = label.reshape(-1)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """The Poisson negative log-likelihood: ``exp(pred) - target * pred``
    on log-rates (``from_logits``), else ``pred - target * log(pred +
    epsilon)``; ``compute_full`` adds Stirling's term where target > 1.
    Averaged over every axis but the first."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + 1e-12) - target + \
                0.5 * torch.log(2 * math.pi * (target + 1e-12))
            stirling = torch.where(target <= 1, torch.zeros_like(stirling),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean(dim=tuple(range(1, loss.ndim))) if loss.ndim > 1 \
            else loss


#: minus infinity of the CTC recursion, as the JAX package's
CTC_NEG_INF = -1e30


def ctc_loss(pred, label, pred_lengths=None, label_lengths=None):
    """Connectionist temporal classification, the JAX package's
    computation: per batch row ``-log p(label | pred)`` by the alpha
    recursion in log space over the extended label sequence (blank 0
    between and around the labels), ``pred`` (N, T, C) logits
    (log-softmax over C here), ``label`` (N, L) class ids. A row's
    recursion freezes past its ``pred_lengths``; ``label_lengths=None``
    counts its non-zero labels. Minus infinity is ``-1e30``, so an
    alignment that cannot exist costs about 1e30 (``F.ctc_loss`` returns
    inf there)."""
    n, t_len, c = pred.shape
    dev = pred.device
    plen = pred_lengths.to(torch.int32) if pred_lengths is not None \
        else torch.full((n,), t_len, dtype=torch.int32, device=dev)
    lab = label.to(torch.long)
    llen = label_lengths.to(torch.long) if label_lengths is not None \
        else (lab != 0).sum(dim=1)
    logp = torch.log_softmax(pred, dim=-1)
    s_len = 2 * lab.shape[1] + 1
    ext = torch.zeros((n, s_len), dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    ext = torch.where(ext < 0, ext + c, ext)     # numpy's negative ids
    idx = torch.arange(s_len, device=dev)
    skip_ok = (idx[None, :] >= 2) & (ext != 0) & \
        (ext != torch.roll(ext, 2, dims=1))
    neg = torch.full((), CTC_NEG_INF, dtype=logp.dtype, device=dev)
    # (N, T, S): each position's log-probability along the sequence
    lp = torch.gather(logp, 2, ext[:, None, :].expand(n, t_len, s_len))
    alpha = torch.full((n, s_len), CTC_NEG_INF, dtype=logp.dtype,
                       device=dev)
    first = torch.where(llen > 0, lp[:, 0, 1], neg)
    alpha = torch.cat([lp[:, 0, :1], first[:, None], alpha[:, 2:]], dim=1)
    pad1 = neg.expand(n, 1)
    pad2 = neg.expand(n, 2)
    for t in range(1, t_len):
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(skip_ok, torch.cat([pad2, alpha[:, :-2]], dim=1),
                         neg)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        new = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                            + torch.exp(a2 - m)) + lp[:, t]
        alpha = torch.where((t < plen)[:, None], new, alpha)
    send = 2 * llen
    a_end = torch.gather(alpha, 1, send[:, None])[:, 0]
    a_end1 = torch.gather(alpha, 1, torch.clamp(send - 1, min=0)[:, None]
                          )[:, 0]
    m = torch.maximum(a_end, a_end1)
    return -(m + torch.log(torch.exp(a_end - m) + torch.exp(a_end1 - m)))


class CTCLoss(Loss):
    """Connectionist temporal classification (:func:`ctc_loss`), through
    the funnel as ``"ctc_loss"``. ``layout`` "NTC" or "TNC" for ``pred``,
    ``label_layout`` "NT" or "TN"; the loss is one value a batch row."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        super().__init__(weight, 0)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "TNC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        loss = invoke("ctc_loss", ctc_loss, pred, label, pred_lengths,
                      label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning: row i of ``x1`` should be nearest
    row i of ``x2``; cross-entropy of the softmax of minus the pairwise
    euclidean distances against labels smoothed by
    ``smoothing_parameter``."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._smooth = smoothing_parameter

    def forward(self, x1, x2, sample_weight=None):
        return invoke("sdml_loss", self._sdml, x1, x2)

    def _sdml(self, a, b):
        n = a.shape[0]
        d = torch.sqrt(torch.sum((a[:, None, :] - b[None, :, :]) ** 2,
                                 dim=-1) + 1e-12)
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        labels = eye * (1 - self._smooth) + \
            (1 - eye) * self._smooth / (n - 1)
        logp = torch.log_softmax(-d, dim=-1)
        return -(labels * logp).sum(dim=1)
