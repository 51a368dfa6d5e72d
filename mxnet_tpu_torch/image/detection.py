"""The detection input pipeline (counterpart of
``mxnet_tpu/image/detection.py``, MXNet's ``image/detection.py``):
augmenters that move the boxes with the image, and ``ImageDetIter``,
which batches images with labels of any number of objects.

Labels: per image a float32 array (num_objects, width >= 5) of rows
``[class_id, xmin, ymin, xmax, ymax, ...]``, coordinates in [0, 1]. A
batch pads the object axis with -1 rows (class_id < 0: no object, the
padding ``MultiBoxTarget`` skips). The batch is a pair of CPU tensors,
data (B, C, H, W) float32 and label (B, max_obj, width), so a captured
training step sees one shape.

The augmenters run on the host in numpy, as the JAX package's do, and
draw the same numbers in the same order. Where the JAX package draws
from Python's global ``random``, each detection augmenter and the
iterator here draw from the ``random.Random`` given as ``rng``, or
without one from :func:`host.py_random` (the global generator, or a
loader worker's own). The image augmenters a detection stack borrows
(resize, colour jitter, ...) draw as ``image.py``'s do.
"""
from __future__ import annotations

import os
import random
from math import sqrt
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError
from ..host import py_random, to_numpy, to_tensor
from .image import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
                    ForceResizeAug, HueJitterAug, LightingAug, RandomGrayAug,
                    ResizeAug, fixed_crop, imdecode_or_raw, imresize_np)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
           "ImageDetIter"]


def _box_areas(boxes: np.ndarray) -> np.ndarray:
    """Areas of [x1, y1, x2, y2] rows, clipped at 0."""
    return (np.maximum(0.0, boxes[:, 2] - boxes[:, 0])
            * np.maximum(0.0, boxes[:, 3] - boxes[:, 1]))


class DetAugmenter:
    """A detection augmenter: ``aug(src, label) -> (src, label)``; draws
    from ``rng`` (a ``random.Random``), else from ``host.py_random()``."""

    def __init__(self, rng: Optional[random.Random] = None, **kwargs):
        self._kwargs = kwargs
        self._rng = rng

    @property
    def rng(self) -> random.Random:
        return self._rng if self._rng is not None else py_random()

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image :class:`Augmenter` in a detection stack: it changes
    pixels only and the labels pass through, so borrow only augmenters
    that keep the geometry."""

    def __init__(self, augmenter: Augmenter):
        super().__init__(augmenter=augmenter._kwargs)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """One augmenter of ``aug_list`` picked at random, or none with
    probability ``skip_prob``."""

    def __init__(self, aug_list: Sequence[DetAugmenter],
                 skip_prob: float = 0.0, rng: Optional[random.Random] = None):
        super().__init__(rng, skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or self.rng.random() < self.skip_prob:
            return src, label
        return self.rng.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip the image and its boxes left to right with probability
    ``p``."""

    def __init__(self, p: float = 0.5, rng: Optional[random.Random] = None):
        super().__init__(rng, p=p)
        self.p = p

    def __call__(self, src, label):
        if self.rng.random() < self.p:
            src = to_tensor(to_numpy(src)[:, ::-1].copy())
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """A random crop under constraints, its boxes re-expressed in the
    crop: aspect ratio and relative area within their ranges, more than
    ``min_object_covered`` of some object inside, and objects keeping
    ``min_eject_coverage`` of their area or less dropped. After
    ``max_attempts`` refused proposals the input comes back unchanged."""

    def __init__(self, min_object_covered: float = 0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage: float = 0.3, max_attempts: int = 50,
                 rng: Optional[random.Random] = None):
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(rng, min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self.enabled = (0 < area_range[0] <= area_range[1]
                        and 0 < aspect_ratio_range[0]
                        <= aspect_ratio_range[1])

    def __call__(self, src, label):
        img = to_numpy(src)
        prop = self._propose(label, img.shape[0], img.shape[1])
        if prop is None:
            return src, label
        x, y, w, h, new_label = prop
        return fixed_crop(img, x, y, w, h, None), new_label

    def _covered_enough(self, boxes, x1, y1, x2, y2) -> bool:
        """Does the crop cover more than min_object_covered of some
        object?"""
        areas = _box_areas(boxes)
        valid = areas > 0
        if not valid.any():
            return False
        b = boxes[valid]
        inter = (np.maximum(0.0, np.minimum(b[:, 2], x2)
                            - np.maximum(b[:, 0], x1))
                 * np.maximum(0.0, np.minimum(b[:, 3], y2)
                              - np.maximum(b[:, 1], y1)))
        cov = inter / areas[valid]
        cov = cov[cov > 0]
        return cov.size > 0 and cov.min() > self.min_object_covered

    def _shift_labels(self, label, x1, y1, cw, ch) -> Optional[np.ndarray]:
        """The boxes in crop coordinates, shrunken objects dropped."""
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] - x1) / cw
        out[:, (2, 4)] = (out[:, (2, 4)] - y1) / ch
        out[:, 1:5] = np.clip(out[:, 1:5], 0.0, 1.0)
        old = _box_areas(label[:, 1:5])
        new = _box_areas(out[:, 1:5]) * cw * ch
        with np.errstate(divide="ignore", invalid="ignore"):
            coverage = np.where(old > 0, new / old, 0.0)
        keep = (out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2]) \
            & (coverage > self.min_eject_coverage)
        if not keep.any():
            return None
        return out[keep]

    def _propose(self, label, height, width):
        if not self.enabled or height <= 0 or width <= 0:
            return None
        rng = self.rng
        min_area = self.area_range[0] * height * width
        max_area = self.area_range[1] * height * width
        for _ in range(self.max_attempts):
            ratio = rng.uniform(*self.aspect_ratio_range)
            if ratio <= 0:
                continue
            h_lo = int(round(sqrt(min_area / ratio)))
            h_hi = min(int(round(sqrt(max_area / ratio))), height,
                       int(width / ratio))
            if h_lo > h_hi or h_hi <= 0:
                continue
            h = rng.randint(max(1, h_lo), h_hi)
            w = min(int(round(h * ratio)), width)
            if not (min_area * 0.99 <= w * h <= max_area * 1.01):
                continue
            if w * h < 2:
                continue
            y = rng.randint(0, height - h)
            x = rng.randint(0, width - w)
            nx1, ny1 = x / width, y / height
            nx2, ny2 = (x + w) / width, (y + h) / height
            if not self._covered_enough(label[:, 1:5], nx1, ny1, nx2, ny2):
                continue
            new_label = self._shift_labels(label, nx1, ny1,
                                           nx2 - nx1, ny2 - ny1)
            if new_label is not None:
                return x, y, w, h, new_label
        return None


class DetRandomPadAug(DetAugmenter):
    """Expansion: the image placed at random on a larger canvas of
    ``pad_val``, its boxes shrunk to match."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts: int = 50,
                 pad_val=(128, 128, 128),
                 rng: Optional[random.Random] = None):
        if not isinstance(pad_val, (tuple, list)):
            pad_val = (pad_val,) * 3
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(rng, aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.pad_val = pad_val
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.enabled = (area_range[1] > 1.0
                        and 0 < aspect_ratio_range[0]
                        <= aspect_ratio_range[1])

    def __call__(self, src, label):
        img = to_numpy(src)
        height, width = img.shape[0], img.shape[1]
        prop = self._propose(height, width)
        if prop is None:
            return src, label
        x, y, w, h = prop
        pv = np.asarray(self.pad_val, img.dtype)
        if pv.size != img.shape[2]:   # e.g. a 3-tuple on a grey image
            pv = pv.flat[0]
        canvas = np.empty((h, w, img.shape[2]), img.dtype)
        canvas[...] = pv
        canvas[y:y + height, x:x + width] = img
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] * width + x) / w
        out[:, (2, 4)] = (out[:, (2, 4)] * height + y) / h
        return to_tensor(canvas), out

    def _propose(self, height, width):
        if not self.enabled or height <= 0 or width <= 0:
            return None
        rng = self.rng
        min_area = self.area_range[0] * height * width
        max_area = self.area_range[1] * height * width
        for _ in range(self.max_attempts):
            ratio = rng.uniform(*self.aspect_ratio_range)
            if ratio <= 0:
                continue
            h_lo = max(height, int(round(sqrt(min_area / ratio))),
                       int(round(width / ratio)))
            h_hi = int(round(sqrt(max_area / ratio)))
            if h_lo > h_hi:
                continue
            h = rng.randint(h_lo, h_hi)
            w = int(round(h * ratio))
            if (h - height) < 2 or (w - width) < 2:
                continue
            y = rng.randint(0, h - height)
            x = rng.randint(0, w - width)
            return x, y, w, h
        return None


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0.0,
                                 rng: Optional[random.Random] = None
                                 ) -> DetRandomSelectAug:
    """One :class:`DetRandomCropAug` a constraint where the arguments are
    lists (SSD's sampling), one picked at random an image."""
    def as_list(v):
        return list(v) if isinstance(v, (list, tuple)) \
            and isinstance(v[0], (list, tuple)) else None

    covered = min_object_covered if isinstance(min_object_covered,
                                               (list, tuple)) \
        else [min_object_covered]
    ratios = as_list(aspect_ratio_range) or [aspect_ratio_range]
    areas = as_list(area_range) or [area_range]
    ejects = min_eject_coverage if isinstance(min_eject_coverage,
                                              (list, tuple)) \
        else [min_eject_coverage]
    attempts = max_attempts if isinstance(max_attempts, (list, tuple)) \
        else [max_attempts]
    n = max(len(covered), len(ratios), len(areas), len(ejects),
            len(attempts))

    def pick(lst, i):
        return lst[i] if i < len(lst) else lst[-1]

    augs = [DetRandomCropAug(pick(covered, i), pick(ratios, i),
                             pick(areas, i), pick(ejects, i),
                             pick(attempts, i), rng=rng) for i in range(n)]
    return DetRandomSelectAug(augs, skip_prob=skip_prob, rng=rng)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127),
                       rng: Optional[random.Random] = None
                       ) -> List[DetAugmenter]:
    """The standard detection stack: resize, constrained random crop,
    mirror, random pad, forced resize to ``data_shape``, cast, colour
    jitter / hue / PCA noise / grey, normalize; the boxes follow every
    change of geometry. ``rng`` feeds the crop, mirror and pad."""
    augs: List[DetAugmenter] = []
    if resize > 0:
        augs.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        augs.append(CreateMultiRandCropAugmenter(
            min_object_covered, aspect_ratio_range,
            (area_range[0], min(1.0, area_range[1])), min_eject_coverage,
            max_attempts, skip_prob=1 - rand_crop, rng=rng))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5, rng=rng))
    if rand_pad > 0:
        augs.append(DetRandomSelectAug(
            [DetRandomPadAug(aspect_ratio_range,
                             (1.0, max(1.0 + 1e-6, area_range[1])),
                             max_attempts, pad_val, rng=rng)],
            skip_prob=1 - rand_pad, rng=rng))
    augs.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    augs.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        augs.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        augs.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        augs.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        augs.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], "float32")
    if std is True:
        std = np.array([58.395, 57.12, 57.375], "float32")
    if mean is not None or std is not None:
        augs.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return augs


class ImageDetIter:
    """Detection batches: each image augmented with its boxes, the labels
    padded with -1 rows to a fixed (batch, max_obj, width).

    Sources, exactly one: ``imglist``, a list of ``(label, image)`` pairs
    (label an (N, >= 5) array or the flat header form ``[header_width,
    obj_width, <header...>, objects...]``; image an HWC array or a file
    under ``path_root``), or ``path_imgrec``, a record file whose headers
    carry the flat form. ``rng`` (a ``random.Random``) feeds the shuffle
    and the default stack's crop, mirror and pad; ``kwargs`` go to
    :func:`CreateDetAugmenter`. ``last_batch_handle``: ``"pad"`` (repeat
    the last image; ``DataBatch.pad`` counts them), ``"discard"`` or
    ``"roll_over"`` (the tail leads the next pass)."""

    def __init__(self, batch_size: int, data_shape, path_imgrec=None,
                 imglist=None, path_root: str = "", shuffle: bool = False,
                 aug_list: Optional[List[DetAugmenter]] = None,
                 label_shape=None, last_batch_handle: str = "pad",
                 rng: Optional[random.Random] = None, **kwargs):
        if (path_imgrec is None) == (imglist is None):
            raise MXNetError(
                "ImageDetIter needs exactly one of path_imgrec / imglist")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.path_root = path_root
        self.shuffle = shuffle
        self._rng = rng
        self.auglist = aug_list if aug_list is not None \
            else CreateDetAugmenter(data_shape, rng=rng, **kwargs)
        self._samples = []
        if imglist is not None:
            for label, img in imglist:
                self._samples.append((self._parse_label(label), img))
        else:
            from .. import recordio
            reader = recordio.MXRecordIO(path_imgrec, "r")
            while True:
                rec = reader.read()
                if rec is None:
                    break
                header, payload = recordio.unpack(rec)
                self._samples.append(
                    (self._parse_label(np.asarray(header.label)), payload))
            reader.close()
        if not self._samples:
            raise MXNetError("ImageDetIter: empty data source")
        self.label_width = self._samples[0][0].shape[1]
        if label_shape is None:
            max_obj = max(s[0].shape[0] for s in self._samples)
            label_shape = (max_obj, self.label_width)
        self.label_shape = tuple(label_shape)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(f"last_batch_handle must be pad/discard/"
                             f"roll_over, got {last_batch_handle!r}")
        self._order = list(range(len(self._samples)))
        self._cursor = 0
        self._leftover: List[int] = []
        self._last_batch_handle = last_batch_handle
        self.reset()

    @staticmethod
    def _parse_label(label) -> np.ndarray:
        """An (N, >= 5) array, or the flat header form without its -1
        padding rows."""
        arr = np.asarray(to_numpy(label), "float32")
        if arr.ndim == 2:
            if arr.shape[1] < 5:
                raise MXNetError(f"label width must be >= 5, got "
                                 f"{arr.shape[1]}")
            return arr
        raw = arr.ravel()
        if raw.size < 7:
            raise MXNetError(f"label is too short: {raw.size}")
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if obj_width < 5:
            raise MXNetError(f"object width must be >= 5, got {obj_width}")
        body = raw[header_width:]
        body = body[:(body.size // obj_width) * obj_width]
        out = body.reshape(-1, obj_width)
        return out[out[:, 0] >= 0]

    def _pad_label(self, label: np.ndarray) -> np.ndarray:
        max_obj, width = self.label_shape
        out = np.full((max_obj, width), -1.0, "float32")
        n = min(label.shape[0], max_obj)
        w = min(width, label.shape[1])
        out[:n, :w] = label[:n, :w]
        return out

    def sync_label_shape(self, it: "ImageDetIter", verbose: bool = False):
        """Give this iterator and ``it`` (train and validation) one padded
        label shape, the larger of the two in each axis."""
        shape = (max(self.label_shape[0], it.label_shape[0]),
                 max(self.label_shape[1], it.label_shape[1]))
        self.label_shape = shape
        it.label_shape = shape
        return it

    @property
    def provide_data(self):
        from ..io.io import DataDesc
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        from ..io.io import DataDesc
        return [DataDesc("label", (self.batch_size,) + self.label_shape)]

    def reset(self):
        order = list(range(len(self._samples)))
        if self.shuffle:
            (self._rng if self._rng is not None else py_random()) \
                .shuffle(order)
        # roll_over: the tail deferred from the last pass leads this one
        self._order = self._leftover + order
        self._leftover = []
        self._cursor = 0

    def __iter__(self):
        return self

    def _load_image(self, img):
        if isinstance(img, bytes):
            return imdecode_or_raw(img, self.data_shape)
        if isinstance(img, str):
            with open(os.path.join(self.path_root, img), "rb") as f:
                return imdecode_or_raw(f.read(), self.data_shape)
        return to_numpy(img)

    def _augment(self, img: np.ndarray, label: np.ndarray):
        src = to_tensor(np.ascontiguousarray(img))
        for aug in self.auglist:
            src, label = aug(src, label) if isinstance(aug, DetAugmenter) \
                else (aug(src), label)
        arr = to_numpy(src).astype("float32")
        _, h, w = self.data_shape
        if arr.shape[0] != h or arr.shape[1] != w:
            arr = imresize_np(arr, w, h)
        return arr.transpose(2, 0, 1), self._pad_label(label)

    def next(self):
        from ..io.io import DataBatch
        remaining = len(self._order) - self._cursor
        if remaining <= 0:
            raise StopIteration
        if remaining < self.batch_size:
            if self._last_batch_handle == "discard":
                raise StopIteration
            if self._last_batch_handle == "roll_over":
                self._leftover = self._order[self._cursor:]
                self._cursor = len(self._order)
                raise StopIteration
        datas, labels = [], []
        while len(datas) < self.batch_size \
                and self._cursor < len(self._order):
            label, img = self._samples[self._order[self._cursor]]
            self._cursor += 1
            d, lab = self._augment(self._load_image(img), label)
            datas.append(d)
            labels.append(lab)
        pad = self.batch_size - len(datas)
        while len(datas) < self.batch_size:
            datas.append(datas[-1])
            labels.append(labels[-1])
        return DataBatch([torch.from_numpy(np.stack(datas))],
                         [torch.from_numpy(np.stack(labels))], pad=pad)

    __next__ = next
