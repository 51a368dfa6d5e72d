"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``).

``update(labels, preds)`` takes tensors or numpy arrays (one of each, or
lists of them). The accumulation rule is the JAX package's:

- a batch with a tensor on either side is reduced on that tensor's
  device into a running float32 tensor there; ``update`` queues the work
  and returns with no device-to-host copy and no sync, so a metric can
  be updated inside a training or evaluation loop without stalling the
  card. The count of instances is a host int taken from shapes.
- a batch of numpy arrays (or lists) accumulates on the host in Python
  floats (float64), as the JAX package's host path does.
- :meth:`EvalMetric.get` reads the sums: the one sync.

``PCC`` (its confusion matrix grows with the largest class seen),
``PearsonCorrelation`` (it keeps the raw vectors), ``CustomMetric`` (its
function takes numpy) and ``Perplexity`` with ``ignore_label`` (the count
of kept tokens depends on the data) copy each batch to the host, by
design, as there.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "MAE", "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "F1", "MCC", "PearsonCorrelation", "Loss",
           "Torch", "Caffe", "CustomMetric", "np", "create", "PCC",
           "Fbeta", "BinaryAccuracy", "MeanPairwiseDistance",
           "MeanCosineSimilarity"]

_registry = {}

_F32 = torch.float32


def _register(*names):
    def deco(cls):
        for n in names:
            _registry[n.lower()] = cls
        return cls
    return deco


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return onp.asarray(x)


def _device_pair(label, pred):
    """(label, pred) as tensors on one device when either is a tensor:
    the signal to accumulate there, with no host sync. Two host arrays
    give None (the float64 host path)."""
    lt, pt = isinstance(label, torch.Tensor), isinstance(pred, torch.Tensor)
    if not (lt or pt):
        return None
    dev = (pred if pt else label).device
    if not lt:
        label = torch.as_tensor(onp.asarray(label), device=dev)
    if not pt:
        pred = torch.as_tensor(onp.asarray(pred), device=dev)
    return label.detach(), pred.detach()


def _numel(shape) -> int:
    return int(onp.prod(shape)) if len(shape) else 1


def _host(v) -> float:
    """An accumulated scalar read on the host: the designed sync
    (:meth:`EvalMetric.get`)."""
    return float(v)


def check_label_shapes(labels, preds, shape=False):
    if len(labels) != len(preds):
        raise MXNetError(
            f"labels/preds count mismatch: {len(labels)} vs {len(preds)}")


class EvalMetric:
    """Base metric. ``sum_metric`` is a host float (numpy batches) or a
    float32 tensor on the batches' device; ``num_inst`` a host int;
    :meth:`get` the one sync."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, _host(self.sum_metric) / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label, pred):
        self.update(list(label.values()), list(pred.values()))

    def __repr__(self):
        return f"EvalMetric: {dict([self.get()])}"


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get`` gives lists."""

    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) if isinstance(m, str) else m
                        for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _classes(pd, axis=-1):
    """Predicted classes: the argmax of scores with a class axis."""
    return torch.argmax(pd, dim=axis) if pd.ndim > 1 else pd


@_register("accuracy", "acc")
class Accuracy(EvalMetric):
    """The share of predictions (the argmax over ``axis`` of scores that
    have more axes than the label) equal to the label."""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            dev = _device_pair(label, pred)
            if dev is not None:
                ld, pd = dev
                if pd.ndim > ld.ndim:
                    pd = torch.argmax(pd, dim=self.axis)
                eq = pd.to(torch.int32).reshape(-1) \
                    == ld.to(torch.int32).reshape(-1)
                self.sum_metric = self.sum_metric + eq.sum(dtype=_F32)
                self.num_inst += _numel(ld.shape)
                continue
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            if pred.ndim > label.ndim:
                pred = onp.argmax(pred, axis=self.axis)
            pred = pred.astype("int64").flatten()
            label = label.astype("int64").flatten()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@_register("top_k_accuracy", "topkaccuracy")
class TopKAccuracy(EvalMetric):
    """The share of rows whose label is among the ``top_k`` highest
    scores (ties in index order: a stable sort)."""

    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            dev = _device_pair(label, pred)
            if dev is not None:
                ld, pd = dev
                ld = ld.to(torch.int64).reshape(-1)
                topk = torch.argsort(-pd, dim=-1, stable=True)[:, :self.top_k]
                hit = (topk == ld[:, None]).any(dim=1)
                self.sum_metric = self.sum_metric + hit.sum(dtype=_F32)
                self.num_inst += int(ld.shape[0])
                continue
            label = _to_numpy(label).astype("int64").flatten()
            pred = _to_numpy(pred)
            topk = onp.argsort(-pred, axis=-1, kind="stable")[:, :self.top_k]
            self.sum_metric += float((topk == label[:, None]).any(axis=1)
                                     .sum())
            self.num_inst += len(label)


@_register("mae")
class MAE(EvalMetric):
    """The mean absolute error, averaged over batches."""

    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def _batch(self, diff):
        return torch.abs(diff).mean()

    def _batch_host(self, diff):
        return onp.abs(diff).mean()

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            dev = _device_pair(label, pred)
            if dev is not None:
                ld, pd = dev
                self.sum_metric = self.sum_metric + self._batch(
                    ld.reshape(pd.shape) - pd).to(_F32)
            else:
                label, pred = _to_numpy(label), _to_numpy(pred)
                self.sum_metric += float(self._batch_host(
                    label.reshape(pred.shape) - pred))
            self.num_inst += 1


@_register("mse")
class MSE(MAE):
    """The mean squared error, averaged over batches."""

    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def _batch(self, diff):
        return (diff ** 2).mean()

    def _batch_host(self, diff):
        return (diff ** 2).mean()


@_register("rmse")
class RMSE(MSE):
    """The root of :class:`MSE`'s mean."""

    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.sqrt(_host(self.sum_metric) / self.num_inst)


@_register("ce", "crossentropy", "cross-entropy")
class CrossEntropy(EvalMetric):
    """``-log(p[label] + eps)`` of probabilities, averaged over rows."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            dev = _device_pair(label, pred)
            if dev is not None:
                ld, pd = dev
                ld = ld.to(torch.int64).reshape(-1)
                prob = pd[torch.arange(ld.shape[0], device=pd.device), ld]
                self.sum_metric = self.sum_metric + \
                    torch.sum(-torch.log(prob + self.eps)).to(_F32)
                self.num_inst += int(ld.shape[0])
                continue
            label = _to_numpy(label).astype("int64").flatten()
            pred = _to_numpy(pred)
            prob = pred[onp.arange(label.shape[0]), label]
            self.sum_metric += float((-onp.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@_register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@_register("perplexity")
class Perplexity(EvalMetric):
    """``exp`` of the mean ``-log(max(p[label], 1e-10))``; with
    ``ignore_label`` the rows of that label are left out (a host
    decision: that batch is copied to the host)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            dev = _device_pair(label, pred) \
                if self.ignore_label is None else None
            if dev is not None:
                ld, pd = dev
                ld = ld.to(torch.int64).reshape(-1)
                pd = pd.reshape(ld.shape[0], -1)
                prob = pd[torch.arange(ld.shape[0], device=pd.device), ld]
                self.sum_metric = self.sum_metric + torch.sum(
                    -torch.log(torch.clamp(prob, min=1e-10))).to(_F32)
                self.num_inst += int(ld.shape[0])
                continue
            label = _to_numpy(label).astype("int64").reshape(-1)
            pred = _to_numpy(pred).reshape(label.shape[0], -1)
            prob = pred[onp.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                prob = prob[label != self.ignore_label]
            self.sum_metric += float(-onp.log(onp.maximum(prob, 1e-10))
                                     .sum())
            self.num_inst += prob.shape[0]

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.exp(_host(self.sum_metric) / self.num_inst)


class _Confusion(EvalMetric):
    """Binary counts of true and false positives and negatives (classes
    the argmax over the last axis of scores with one)."""

    _COUNTS = ("_tp", "_fp", "_fn", "_tn")

    def reset(self):
        super().reset()
        for k in self._COUNTS:
            setattr(self, k, 0.0)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            dev = _device_pair(label, pred)
            if dev is not None:
                ld, pd = dev
                pd = _classes(pd).to(torch.int32).reshape(-1)
                ld = ld.to(torch.int32).reshape(-1)
                host = False
            else:
                pd = _to_numpy(pred)
                if pd.ndim > 1:
                    pd = onp.argmax(pd, axis=-1)
                pd = pd.astype("int64").flatten()
                ld = _to_numpy(label).astype("int64").flatten()
                host = True
            cells = {"_tp": (pd == 1) & (ld == 1),
                     "_fp": (pd == 1) & (ld == 0),
                     "_fn": (pd == 0) & (ld == 1),
                     "_tn": (pd == 0) & (ld == 0)}
            for k in self._COUNTS:
                n = float(cells[k].sum()) if host \
                    else cells[k].sum(dtype=_F32)
                setattr(self, k, getattr(self, k) + n)
            self.num_inst += int(ld.shape[0])


@_register("f1")
class F1(_Confusion):
    """The F1 score of binary predictions (:class:`Fbeta` at beta 1)."""

    _COUNTS = ("_tp", "_fp", "_fn")
    beta = 1.0

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        tp, fp, fn = _host(self._tp), _host(self._fp), _host(self._fn)
        prec = tp / max(tp + fp, 1e-12)
        rec = tp / max(tp + fn, 1e-12)
        b2 = self.beta * self.beta
        return self.name, (1 + b2) * prec * rec / max(b2 * prec + rec,
                                                      1e-12)


@_register("mcc")
class MCC(_Confusion):
    """Matthews' correlation coefficient of binary predictions."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        tp, fp = _host(self._tp), _host(self._fp)
        fn, tn = _host(self._fn), _host(self._tn)
        den = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return self.name, (tp * tn - fp * fn) / den if den else 0.0


@_register("pearsonr")
class PearsonCorrelation(EvalMetric):
    """Pearson's r of every label and prediction seen (kept on the
    host)."""

    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_to_numpy(label).flatten())
            self._preds.append(_to_numpy(pred).flatten())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        lab = onp.concatenate(self._labels)
        pred = onp.concatenate(self._preds)
        return self.name, float(onp.corrcoef(lab, pred)[0, 1])


@_register("pcc")
class PCC(EvalMetric):
    """Multiclass Matthews correlation from a K x K confusion matrix
    (kept on the host), which grows as new class indices appear; MCC
    for K = 2."""

    def __init__(self, name="pcc", **kwargs):
        self.k = 2
        super().__init__(name, **kwargs)

    def reset(self):
        self.num_inst = 0
        self.lcm = onp.zeros((self.k, self.k), dtype="float64")

    def _grow(self, inc):
        self.lcm = onp.pad(self.lcm, ((0, inc), (0, inc)), "constant")
        self.k += inc

    @staticmethod
    def _calc_mcc(cmat):
        n = cmat.sum()
        x = cmat.sum(axis=1)
        y = cmat.sum(axis=0)
        cov_xx = float((x * (n - x)).sum())
        cov_yy = float((y * (n - y)).sum())
        if cov_xx == 0 or cov_yy == 0:
            return float("nan")
        i = cmat.diagonal()
        cov_xy = float((i * n - x * y).sum())
        return cov_xy / (cov_xx * cov_yy) ** 0.5

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).astype("int64").flatten()
            pred = _to_numpy(pred)
            if pred.ndim > 1 and pred.shape != tuple(label.shape):
                pred = onp.argmax(pred, axis=1)
            pred = pred.astype("int64").flatten()
            n = int(max(pred.max(), label.max()))
            if n >= self.k:
                self._grow(n + 1 - self.k)
            bcm = onp.zeros((self.k, self.k), dtype="float64")
            onp.add.at(bcm, (pred, label), 1)
            self.lcm += bcm
        self.num_inst += 1

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self._calc_mcc(self.lcm)


@_register("loss")
class Loss(EvalMetric):
    """The mean of loss values (the labels are ignored)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            if isinstance(pred, torch.Tensor):
                self.sum_metric = self.sum_metric + \
                    torch.sum(pred.detach()).to(_F32)
                self.num_inst += _numel(pred.shape)
                continue
            loss = _to_numpy(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


class Torch(Loss):
    def __init__(self, name="torch", **kwargs):
        super().__init__(name, **kwargs)


class Caffe(Loss):
    def __init__(self, name="caffe", **kwargs):
        super().__init__(name, **kwargs)


@_register("custom")
class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy copies: a value, or ``(sum,
    count)``."""

    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            v = self._feval(_to_numpy(label), _to_numpy(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


@_register("fbeta")
class Fbeta(F1):
    """The F-beta score: :class:`F1`'s counts, recall weighed by
    ``beta``."""

    def __init__(self, name="fbeta", beta=1.0, average="macro", **kwargs):
        super().__init__(name=name, average=average, **kwargs)
        self.beta = beta


@_register("binary_accuracy")
class BinaryAccuracy(EvalMetric):
    """The share of probabilities above ``threshold`` that match labels
    above 0.5."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        super().__init__(name, **kwargs)
        self.threshold = threshold

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            dev = _device_pair(label, pred)
            if dev is not None:
                ld, pd = dev
                hit = (pd.reshape(-1) > self.threshold) \
                    == (ld.reshape(-1) > 0.5)
                self.sum_metric = self.sum_metric + hit.sum(dtype=_F32)
                self.num_inst += _numel(ld.shape)
                continue
            label = _to_numpy(label).flatten()
            pred = _to_numpy(pred).flatten() > self.threshold
            self.sum_metric += float((pred == (label > 0.5)).sum())
            self.num_inst += len(label)


@_register("mean_pairwise_distance", "mpd")
class MeanPairwiseDistance(EvalMetric):
    """The mean ``p``-norm distance between label and prediction rows."""

    def __init__(self, name="mpd", p=2, **kwargs):
        super().__init__(name, **kwargs)
        self.p = p

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            dev = _device_pair(label, pred)
            if dev is not None:
                ld, pd = dev
                d = (torch.abs(pd - ld) ** self.p).sum(
                    dim=tuple(range(1, ld.ndim))) ** (1.0 / self.p)
                self.sum_metric = self.sum_metric + torch.sum(d).to(_F32)
                self.num_inst += int(ld.shape[0])
                continue
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            d = (onp.abs(pred - label) ** self.p).sum(
                axis=tuple(range(1, label.ndim))) ** (1.0 / self.p)
            self.sum_metric += float(d.sum())
            self.num_inst += d.shape[0]


@_register("mean_cosine_similarity", "cos_sim")
class MeanCosineSimilarity(EvalMetric):
    """The mean cosine similarity of label and prediction along the last
    axis."""

    def __init__(self, name="cos_sim", eps=1e-12, **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            dev = _device_pair(label, pred)
            if dev is not None:
                ld, pd = dev
                num = (ld * pd).sum(-1)
                den = torch.linalg.vector_norm(ld, dim=-1) * \
                    torch.linalg.vector_norm(pd, dim=-1)
                sim = num / torch.clamp(den, min=self.eps)
                self.sum_metric = self.sum_metric + torch.sum(sim).to(_F32)
                self.num_inst += _numel(sim.shape)
                continue
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            num = (label * pred).sum(-1)
            den = onp.linalg.norm(label, axis=-1) * \
                onp.linalg.norm(pred, axis=-1)
            sim = num / onp.maximum(den, self.eps)
            self.sum_metric += float(sim.sum())
            self.num_inst += sim.size


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """A :class:`CustomMetric` over a numpy function."""
    return CustomMetric(numpy_feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs):
    """A metric by registered name, a list of them (composite), a
    callable (custom) or an instance (as it is)."""
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        return CompositeEvalMetric([create(m) for m in metric])
    try:
        return _registry[metric.lower()](*args, **kwargs)
    except KeyError as e:
        raise MXNetError(f"unknown metric {metric!r}") from e
