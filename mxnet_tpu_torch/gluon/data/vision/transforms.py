"""Vision transforms (counterpart of ``mxnet_tpu/gluon/data/vision/
transforms.py``), as ``nn.Module``s.

A transform takes an HWC image (CHW for ``Rotate`` / ``RandomRotation``,
after ``ToTensor``) as a numpy array or a CPU tensor and returns a CPU
tensor. It computes on the host in numpy, in the JAX package's
operations and order, so the values are the JAX ones; a float64 result
is narrowed to float32, as the JAX ``NDArray`` narrows it.
``CropResize`` is the exception: it runs on the device that holds its
input. Random transforms draw with the JAX package's calls, in its order,
from numpy's global generator (``RandomHue`` from Python's ``random``, as
``image.HueJitterAug`` does), through :mod:`mxnet_tpu_torch.host`, so a
loader's worker draws from its batch's own generators.

``Resize``, ``CenterCrop`` (where the crop is short) and
``RandomResizedCrop`` resize by nearest neighbour and ignore
``interpolation`` / ``keep_ratio``, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ....host import numpy_random, to_numpy, to_tensor
from ....image import image as _image
from ...nn.basic_layers import Sequential

__all__ = ["Compose", "HybridCompose", "Cast", "ToTensor", "Normalize",
           "Resize", "CenterCrop", "CropResize", "RandomResizedCrop",
           "RandomCrop", "RandomApply", "HybridRandomApply",
           "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomColorJitter", "RandomLighting",
           "RandomGray", "Rotate", "RandomRotation"]


class HostTransform(nn.Module):
    """A transform that computes on the host (the JAX package's
    non-hybrid ``Block`` transforms): not allowed in
    :class:`HybridCompose` or :class:`HybridRandomApply`."""


def _check_hybrid(t):
    if isinstance(t, HostTransform):
        raise ValueError(f"{t} computes on the host and is not a "
                         "HybridBlock; use `Compose` / `RandomApply`")


class Compose(Sequential):
    """Transforms applied one after another."""

    def __init__(self, transforms):
        super().__init__(*transforms)


class HybridCompose(Sequential):
    """:class:`Compose` of transforms that do not compute on the host
    (``CropResize``, or any module of tensor operations)."""

    def __init__(self, transforms):
        for t in transforms:
            _check_hybrid(t)
        super().__init__(*transforms)


class RandomApply(Sequential):
    """``transforms`` with probability ``p`` (a numpy draw a call)."""

    def __init__(self, transforms, p=0.5):
        super().__init__()
        self.transforms = transforms
        self.p = p

    def forward(self, x):
        if self.p < numpy_random().random():
            return to_tensor(x)
        return self.transforms(x)


class HybridRandomApply(Sequential):
    """``transforms`` (not a host transform) with probability ``p``: it
    applies when a uniform draw in [0, 1) is at most ``p``. The JAX
    package draws that coin from its device generator, the port from
    numpy's (:mod:`host`)."""

    def __init__(self, transforms, p=0.5):
        _check_hybrid(transforms)
        super().__init__()
        self.transforms = transforms
        self.p = p

    def forward(self, x):
        if numpy_random().uniform(0, 1) <= self.p:
            return self.transforms(x)
        return to_tensor(x)


class Cast(HostTransform):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return to_tensor(to_numpy(x).astype(self._dtype))


class ToTensor(HostTransform):
    """HWC (or NHWC) [0, 255] to CHW (NCHW) float32 [0, 1]."""

    def forward(self, x):
        arr = to_numpy(x).astype("float32") / 255.0
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        return to_tensor(arr)


class Normalize(HostTransform):
    """``(x - mean) / std`` a channel of a CHW image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype="float32")
        self._std = np.asarray(std, dtype="float32")

    def forward(self, x):
        arr = to_numpy(x)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return to_tensor((arr - mean) / std)


def _resize_np(arr, size):
    """Nearest-neighbour resize of an HWC array to ``size`` (w, h)."""
    h, w = arr.shape[:2]
    ow, oh = (size, size) if isinstance(size, int) else size
    ys = (np.arange(oh) * h / oh).astype(int).clip(0, h - 1)
    xs = (np.arange(ow) * w / ow).astype(int).clip(0, w - 1)
    return arr[ys][:, xs]


class Resize(HostTransform):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size

    def forward(self, x):
        return to_tensor(_resize_np(to_numpy(x), self._size))


class CenterCrop(HostTransform):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        arr = to_numpy(x)
        h, w = arr.shape[:2]
        cw, ch = self._size
        x0 = max((w - cw) // 2, 0)
        y0 = max((h - ch) // 2, 0)
        out = arr[y0:y0 + ch, x0:x0 + cw]
        if out.shape[:2] != (ch, cw):
            out = _resize_np(arr, self._size)
        return to_tensor(out)


class RandomCrop(HostTransform):
    """A crop of ``size`` at a random place, after zero ``pad``."""

    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        arr = to_numpy(x)
        if self._pad:
            p = self._pad
            arr = np.pad(arr, ((p, p), (p, p), (0, 0)), mode="constant")
        h, w = arr.shape[:2]
        cw, ch = self._size
        rnd = numpy_random()
        y0 = rnd.randint(0, max(h - ch, 0) + 1)
        x0 = rnd.randint(0, max(w - cw, 0) + 1)
        return to_tensor(arr[y0:y0 + ch, x0:x0 + cw])


class RandomResizedCrop(HostTransform):
    """A crop of random area (share ``scale``) and aspect ratio
    (uniform in ``ratio``), resized to ``size``; ten tries, then the
    whole image resized."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        arr = to_numpy(x)
        h, w = arr.shape[:2]
        area = h * w
        rnd = numpy_random()
        for _ in range(10):
            target_area = rnd.uniform(*self._scale) * area
            ar = rnd.uniform(*self._ratio)
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if cw <= w and ch <= h:
                x0 = rnd.randint(0, w - cw + 1)
                y0 = rnd.randint(0, h - ch + 1)
                crop = arr[y0:y0 + ch, x0:x0 + cw]
                return to_tensor(_resize_np(crop, self._size))
        return to_tensor(_resize_np(arr, self._size))


class RandomFlipLeftRight(HostTransform):
    def forward(self, x):
        if numpy_random().rand() < 0.5:
            return to_tensor(to_numpy(x)[:, ::-1].copy())
        return to_tensor(x)


class RandomFlipTopBottom(HostTransform):
    def forward(self, x):
        if numpy_random().rand() < 0.5:
            return to_tensor(to_numpy(x)[::-1].copy())
        return to_tensor(x)


class _RandomJitter(HostTransform):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _factor(self):
        return 1.0 + numpy_random().uniform(-self._amount, self._amount)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        return to_tensor(to_numpy(x).astype("float32") * self._factor())


class RandomContrast(_RandomJitter):
    def forward(self, x):
        arr = to_numpy(x).astype("float32")
        mean = arr.mean()
        return to_tensor(mean + (arr - mean) * self._factor())


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        arr = to_numpy(x).astype("float32")
        gray = arr.mean(axis=-1, keepdims=True)
        return to_tensor(gray + (arr - gray) * self._factor())


class RandomHue(_RandomJitter):
    """A chroma-plane rotation in YIQ space (``image.HueJitterAug``)."""

    def forward(self, x):
        return _image.HueJitterAug(self._amount)(x)


class RandomColorJitter(HostTransform):
    """Brightness, contrast, saturation and hue jitter in a random
    order (a numpy permutation)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        ts = []
        if brightness:
            ts.append(RandomBrightness(brightness))
        if contrast:
            ts.append(RandomContrast(contrast))
        if saturation:
            ts.append(RandomSaturation(saturation))
        if hue:
            ts.append(RandomHue(hue))
        self._ts = nn.ModuleList(ts)

    def forward(self, x):
        order = numpy_random().permutation(len(self._ts))
        for i in order:
            x = self._ts[int(i)](x)
        return x


class RandomLighting(HostTransform):
    """AlexNet's PCA lighting noise along ImageNet's RGB eigenvectors,
    ``alpha`` the std of its normal draws."""

    _EIGVAL = np.array([55.46, 4.794, 1.148], "float32")
    _EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], "float32")

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        alpha = numpy_random().normal(0, self._alpha, size=(3,))
        rgb = (self._EIGVEC * alpha * self._EIGVAL).sum(axis=1)
        return to_tensor(to_numpy(x).astype("float32")
                         + rgb.astype("float32"))


class RandomGray(HostTransform):
    """Three-channel grayscale (the augmenters' luma weights) with
    probability ``p``."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if numpy_random().rand() < self._p:
            arr = to_numpy(x).astype("float32")
            gray = (arr * _image.ContrastJitterAug._COEF).sum(
                -1, keepdims=True)
            return to_tensor(np.broadcast_to(gray, arr.shape).copy())
        return to_tensor(x)


def _require_float32(x):
    if to_numpy(x).dtype != np.float32:
        raise TypeError("This transformation only supports float32. "
                        "Consider calling it after ToTensor, "
                        f"given: {x.dtype}")


class Rotate(HostTransform):
    """Rotate a CHW float32 image (or NCHW batch) by a fixed angle,
    keeping its shape (``image.imrotate``)."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        super().__init__()
        self._args = (rotation_degrees, zoom_in, zoom_out)

    def forward(self, x):
        _require_float32(x)
        deg, zin, zout = self._args
        return _image.imrotate(x, deg, zoom_in=zin, zoom_out=zout)


class RandomRotation(HostTransform):
    """Rotate by an angle drawn uniformly from ``angle_limits``, with
    probability ``rotate_with_proba``."""

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False,
                 rotate_with_proba=1.0):
        super().__init__()
        lower, upper = angle_limits
        if lower >= upper:
            raise ValueError("`angle_limits` must be an ordered tuple")
        if rotate_with_proba < 0 or rotate_with_proba > 1:
            raise ValueError("Probability of rotating the image should "
                             "be between 0 and 1")
        self._args = (angle_limits, zoom_in, zoom_out)
        self._rotate_with_proba = rotate_with_proba

    def forward(self, x):
        if numpy_random().random() > self._rotate_with_proba:
            return to_tensor(x)
        _require_float32(x)
        limits, zin, zout = self._args
        return _image.random_rotate(x, limits, zoom_in=zin, zoom_out=zout)


class CropResize(nn.Module):
    """The ``width`` x ``height`` crop at (``x``, ``y``) of an HWC image
    (or NHWC batch), resized to ``size`` (w, h) when given (antialiased
    bilinear in float32, nearest for ``interpolation=0``), in the input's
    dtype. Runs on the device that holds the input."""

    def __init__(self, x, y, width, height, size=None, interpolation=None):
        super().__init__()
        self._x = int(x)
        self._y = int(y)
        self._width = int(width)
        self._height = int(height)
        if size is not None and not isinstance(size, (tuple, list)):
            size = (size, size)
        self._size = tuple(size) if size is not None else None
        self._interpolation = interpolation

    def forward(self, data):
        if not isinstance(data, torch.Tensor):
            data = to_tensor(data)
        if data.dim() not in (3, 4):
            raise ValueError("CropResize expects (H, W, C) or "
                             f"(N, H, W, C) input, got {tuple(data.shape)}")
        x0, y0, w, h = self._x, self._y, self._width, self._height
        crop = data[..., y0:y0 + h, x0:x0 + w, :]
        if self._size is None:
            return crop
        t = crop.float()
        t = _image.resize_hw(t[None] if t.dim() == 3 else t,
                             self._size[1], self._size[0],
                             self._interpolation)
        return (t[0] if data.dim() == 3 else t).to(data.dtype)
