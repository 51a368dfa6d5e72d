"""Image operations and augmenters (counterpart of
``mxnet_tpu/image/image.py``, MXNet's ``image/image.py``).

Arrays are HWC on the host: numpy arrays or CPU tensors in, CPU tensors
out (float64 narrowed to float32, as the JAX package's ``NDArray``
narrows it), except ``imdecode_or_raw`` and ``imresize_np``, which give
numpy arrays as the JAX ones do.

- Decoding: JPEG, PNG and the other formats PIL reads, through PIL;
  without PIL :func:`imdecode` raises :class:`MXNetError` (the JAX
  package's native libjpeg / libpng decoder is not part of the port).
  :func:`imdecode_or_raw` also takes a raw CHW uint8 or float32 payload
  of ``data_shape`` (synthetic records), with or without PIL.
  :func:`imread` reads a file and decodes it (a ``.npy`` file is
  loaded).
- Resizing: ``F.interpolate`` bilinear with ``antialias=True`` (the
  antialiased linear filter of ``jax.image.resize``, which the JAX
  package uses); for ``interp=0`` the rows and columns
  ``jax.image.resize`` picks.
- Rotation: the JAX package's grid about the image centre and its
  4-corner bilinear sampling with zero padding, in float32 torch ops.
- Augmenters draw from Python's ``random`` (``LightingAug`` and
  ``random_rotate`` from numpy's) with the JAX package's calls in its
  order, through :mod:`host` (a loader's worker draws from its
  batch's own generators).
"""
from __future__ import annotations

import io
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..host import numpy_random, py_random, to_numpy, to_tensor

__all__ = ["imread", "imdecode", "imresize", "imresize_np",
           "imdecode_or_raw", "imrotate", "random_rotate",
           "resize_short", "fixed_crop", "center_crop", "random_crop",
           "color_normalize", "random_size_crop", "Augmenter",
           "SequentialAug", "ResizeAug", "ForceResizeAug", "CastAug",
           "HorizontalFlipAug", "RandomCropAug", "CenterCropAug",
           "ColorNormalizeAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "RandomGrayAug", "HueJitterAug",
           "LightingAug", "RandomOrderAug", "ColorJitterAug",
           "CreateAugmenter"]


def _payload(buf) -> bytes:
    if isinstance(buf, torch.Tensor):
        buf = buf.detach().cpu().numpy()
    if isinstance(buf, np.ndarray):
        return buf.tobytes()
    return bytes(buf)


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("imdecode needs PIL to decode JPEG / PNG (no "
                         "decoder is installed); store raw arrays "
                         "instead (imdecode_or_raw)") from e
    return Image


def imdecode(buf, flag: int = 1, to_rgb: bool = True) -> torch.Tensor:
    """Decode an encoded image to HWC uint8: three channels (RGB, or BGR
    with ``to_rgb=False``), or one with ``flag=0``."""
    im = _pil_image().open(io.BytesIO(_payload(buf)))
    if flag == 0:
        arr = np.asarray(im.convert("L"))[..., None]
    else:
        arr = np.asarray(im.convert("RGB"))
        if not to_rgb:
            arr = arr[..., ::-1]
    return to_tensor(arr)


def imread(filename: str, flag: int = 1, to_rgb: bool = True
           ) -> torch.Tensor:
    """Read an image file and :func:`imdecode` it; a ``.npy`` file is
    loaded as it was saved."""
    if filename.lower().endswith(".npy"):
        return to_tensor(np.load(filename))
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imdecode_or_raw(payload: bytes, data_shape) -> np.ndarray:
    """A record payload as an HWC array: decoded (uint8) when PIL reads
    it, else a raw CHW array of ``data_shape`` (uint8 bytes, returned as
    float32, or float32 bytes)."""
    payload = _payload(payload)
    try:
        from PIL import Image
        return np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))
    except Exception:
        pass
    c, h, w = data_shape
    n = c * h * w
    if len(payload) == n:
        return np.frombuffer(payload, np.uint8).reshape(
            c, h, w).transpose(1, 2, 0).astype("float32")
    if len(payload) == 4 * n:
        return np.frombuffer(payload, np.float32).reshape(
            c, h, w).transpose(1, 2, 0)
    raise MXNetError(f"cannot decode record payload of {len(payload)} "
                     f"bytes as an image or as raw {tuple(data_shape)}")


def nearest_indices(m: int, n: int) -> np.ndarray:
    """The source rows of ``n`` nearest-neighbour rows out of ``m``:
    ``floor((i + 0.5) * (m * (1 / n)))`` in float32, the float32
    operations ``jax.image.resize`` compiles to (``nearest-exact``
    rounds otherwise where ``(i + 0.5) * m / n`` is near an integer)."""
    f = np.float32
    i = np.arange(n, dtype=f)
    return np.floor((i + f(0.5)) * (f(m) * (f(1) / f(n)))).astype(np.int64)


def resize_hw(t: torch.Tensor, h: int, w: int, interp) -> torch.Tensor:
    """Resize a float32 (N, H, W, C) tensor on its device: antialiased
    bilinear (``jax.image.resize``'s ``linear``), or nearest for
    ``interp=0``."""
    if interp == 0:
        ys = torch.from_numpy(nearest_indices(t.shape[1], h)).to(t.device)
        xs = torch.from_numpy(nearest_indices(t.shape[2], w)).to(t.device)
        return t.index_select(1, ys).index_select(2, xs)
    out = F.interpolate(t.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def imresize_np(src: np.ndarray, w: int, h: int,
                interp: int = 1) -> np.ndarray:
    """Resize an HWC image to ``h`` x ``w`` in float32: antialiased
    bilinear, or nearest (``interp=0``)."""
    t = torch.from_numpy(np.ascontiguousarray(src, np.float32))[None]
    return resize_hw(t, h, w, interp)[0].contiguous().numpy()


def imresize(src, w: int, h: int, interp: int = 1) -> torch.Tensor:
    """:func:`imresize_np` of ``src`` as a float32 tensor."""
    return to_tensor(imresize_np(to_numpy(src).astype("float32"), w, h,
                                 interp))


def _vec(v, like: torch.Tensor) -> torch.Tensor:
    # a one-element vector, not a scalar: torch divides by a CPU scalar
    # through its reciprocal, which is not the division XLA does
    return torch.tensor([v], dtype=like.dtype, device=like.device)


def grid_sample(data: torch.Tensor, ys: torch.Tensor,
                xs: torch.Tensor) -> torch.Tensor:
    """Sample ``data`` (B, C, H, W) at fractional pixel coordinates
    ``ys`` / ``xs`` (B, *S) from its four neighbours, zero outside the
    image; (B, C, *S). The JAX package's ``_grid_sample`` (the weights,
    the validity test and the order of the four terms)."""
    B, C, H, W = data.shape
    sshape = ys.shape[1:]
    ys = ys.reshape(B, -1)
    xs = xs.reshape(B, -1)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    flat = data.reshape(B, C, H * W)

    def corner(yi, xi, wy, wx):
        valid = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        yc = yi.clamp(0, H - 1).to(torch.int64)
        xc = xi.clamp(0, W - 1).to(torch.int64)
        idx = (yc * W + xc)[:, None, :].expand(B, C, yc.shape[1])
        vals = torch.gather(flat, 2, idx)
        return vals * (wy * wx * valid.to(data.dtype))[:, None, :]

    out = (corner(y0, x0, wy0, wx0) + corner(y0, x0 + 1, wy0, wx1)
           + corner(y0 + 1, x0, wy1, wx0) + corner(y0 + 1, x0 + 1, wy1, wx1))
    return out.reshape((B, C) + tuple(sshape))


def imrotate(src, rotation_degrees, zoom_in: bool = False,
             zoom_out: bool = False) -> torch.Tensor:
    """Rotate a CHW float32 image (or an NCHW batch, one angle an image)
    by ``rotation_degrees`` about its centre, bilinear, zero outside.
    ``zoom_in`` scales so that no padding shows, ``zoom_out`` so that the
    whole source stays visible. Runs on ``src``'s device."""
    if zoom_in and zoom_out:
        raise ValueError("`zoom_in` and `zoom_out` cannot be both True")
    if not isinstance(src, torch.Tensor):
        src = to_tensor(src)
    if src.dtype != torch.float32:
        raise TypeError("Only `float32` images are supported by this "
                        f"function, got {src.dtype}")
    expanded = src.dim() == 3
    if expanded:
        if np.ndim(to_numpy(rotation_degrees)) > 0:
            raise TypeError("When a single image is passed the rotation "
                            "angle is required to be a scalar.")
        src = src[None]
    elif src.dim() != 4:
        raise ValueError("Only 3D and 4D are supported by this function")
    n = src.shape[0]
    deg = np.asarray(to_numpy(rotation_degrees), "float32").reshape(-1)
    if deg.size == 1:
        deg = np.repeat(deg, n)
    if deg.shape[0] != n:
        raise ValueError("The number of images must be equal to the "
                         "number of rotation angles")
    deg = torch.from_numpy(deg).to(src.device)
    B, C, H, W = src.shape
    rad = (math.pi / 180.0) * deg
    hs, ws = (H - 1) / 2.0, (W - 1) / 2.0
    hm = (torch.arange(H, dtype=src.dtype, device=src.device)
          - hs)[:, None].expand(H, W)
    wm = (torch.arange(W, dtype=src.dtype, device=src.device)
          - ws)[None, :].expand(H, W)
    c = torch.cos(rad)[:, None, None]
    s = torch.sin(rad)[:, None, None]
    # rotate, then normalize (keeps the aspect ratio)
    wrot = (wm * c - hm * s) / _vec(ws, src)
    hrot = (wm * s + hm * c) / _vec(hs, src)
    if zoom_in or zoom_out:
        rho = math.hypot(H, W)
        ang = math.atan2(H, W)
        ar = rad.abs()
        c1x = (rho * torch.cos(ang + ar)).abs()
        c1y = (rho * torch.sin(ang + ar)).abs()
        c2x = (rho * torch.cos(ang - ar)).abs()
        c2y = (rho * torch.sin(ang - ar)).abs()
        max_x = torch.maximum(c1x, c2x)
        max_y = torch.maximum(c1y, c2y)
        if zoom_out:
            scale = torch.maximum(max_x / _vec(W, src),
                                  max_y / _vec(H, src))
        else:
            scale = torch.minimum(_vec(W, src) / max_x,
                                  _vec(H, src) / max_y)
        scale = scale[:, None, None]
        wrot = wrot * scale
        hrot = hrot * scale
    out = grid_sample(src, (hrot + 1.0) * hs, (wrot + 1.0) * ws)
    return out[0] if expanded else out


def random_rotate(src, angle_limits, zoom_in: bool = False,
                  zoom_out: bool = False) -> torch.Tensor:
    """:func:`imrotate` by an angle drawn uniformly from
    ``angle_limits`` (one an image for a batch)."""
    if getattr(src, "ndim", 3) == 3:
        rotation_degrees = float(numpy_random().uniform(*angle_limits))
    else:
        rotation_degrees = numpy_random().uniform(
            *angle_limits, size=src.shape[0]).astype("float32")
    return imrotate(src, rotation_degrees, zoom_in=zoom_in,
                    zoom_out=zoom_out)


def resize_short(src, size: int, interp: int = 2) -> torch.Tensor:
    """Resize so that the shorter side is ``size``."""
    h, w = to_numpy(src).shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0: int, y0: int, w: int, h: int, size=None,
               interp: int = 2) -> torch.Tensor:
    """The ``w`` x ``h`` crop at (``x0``, ``y0``), resized to ``size``
    (w, h) when given."""
    img = to_numpy(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != tuple(size):
        return imresize(img, size[0], size[1], interp)
    return to_tensor(img)


def center_crop(src, size, interp: int = 2):
    """The centred crop of ``size`` (w, h): ``(image, (x0, y0, w, h))``."""
    img = to_numpy(src)
    h, w = img.shape[:2]
    ow, oh = size
    x0 = max(0, (w - ow) // 2)
    y0 = max(0, (h - oh) // 2)
    out = fixed_crop(img, x0, y0, min(ow, w), min(oh, h), size, interp)
    return out, (x0, y0, ow, oh)


def random_crop(src, size, interp: int = 2):
    """A crop of ``size`` (w, h) at a random place."""
    img = to_numpy(src)
    h, w = img.shape[:2]
    ow, oh = min(size[0], w), min(size[1], h)
    rnd = py_random()
    x0 = rnd.randint(0, w - ow)
    y0 = rnd.randint(0, h - oh)
    out = fixed_crop(img, x0, y0, ow, oh, size, interp)
    return out, (x0, y0, ow, oh)


def random_size_crop(src, size, area, ratio, interp: int = 2):
    """A crop of random area (a share in ``area``) and aspect ratio
    (log-uniform in ``ratio``), resized to ``size``; ten tries, then the
    centred crop."""
    img = to_numpy(src)
    h, w = img.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    rnd = py_random()
    for _ in range(10):
        target_area = rnd.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(rnd.uniform(*log_ratio))
        ow = int(round(np.sqrt(target_area * ar)))
        oh = int(round(np.sqrt(target_area / ar)))
        if ow <= w and oh <= h:
            x0 = rnd.randint(0, w - ow)
            y0 = rnd.randint(0, h - oh)
            return fixed_crop(img, x0, y0, ow, oh, size, interp), \
                (x0, y0, ow, oh)
    return center_crop(img, size, interp)


def color_normalize(src, mean, std=None) -> torch.Tensor:
    """``(src - mean) / std`` in float32 (``std`` optional)."""
    img = to_numpy(src).astype("float32") - to_numpy(mean)
    if std is not None:
        img = img / to_numpy(std)
    return to_tensor(img)


class Augmenter:
    """An image-to-image function; ``_kwargs`` records its settings."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts: List[Augmenter]):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size: int, interp: int = 2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp: int = 2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class CastAug(Augmenter):
    def __init__(self, typ: str = "float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return to_tensor(to_numpy(src).astype(self.typ))


class HorizontalFlipAug(Augmenter):
    def __init__(self, p: float = 0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if py_random().random() < self.p:
            return to_tensor(to_numpy(src)[:, ::-1].copy())
        return to_tensor(src)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp: int = 2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp: int = 2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class ColorNormalizeAug(Augmenter):
    """Subtract ``mean`` and divide by ``std``; either may be None."""

    def __init__(self, mean, std):
        super().__init__()
        self.mean = np.asarray(mean, "float32") if mean is not None \
            else None
        self.std = np.asarray(std, "float32") if std is not None else None

    def __call__(self, src):
        if self.mean is None:
            img = to_numpy(src).astype("float32")
            return to_tensor(img / self.std if self.std is not None
                             else img)
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness: float):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + py_random().uniform(-self.brightness, self.brightness)
        return to_tensor(to_numpy(src).astype("float32") * alpha)


class ContrastJitterAug(Augmenter):
    #: luma weights (ITU-R BT.601)
    _COEF = np.array([0.299, 0.587, 0.114], "float32")

    def __init__(self, contrast: float):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        img = to_numpy(src).astype("float32")
        alpha = 1.0 + py_random().uniform(-self.contrast, self.contrast)
        gray_mean = (img * self._COEF).sum(-1).mean()
        return to_tensor(img * alpha + gray_mean * (1 - alpha))


class SaturationJitterAug(Augmenter):
    _COEF = ContrastJitterAug._COEF

    def __init__(self, saturation: float):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        img = to_numpy(src).astype("float32")
        alpha = 1.0 + py_random().uniform(-self.saturation, self.saturation)
        gray = (img * self._COEF).sum(-1, keepdims=True)
        return to_tensor(img * alpha + gray * (1 - alpha))


class RandomGrayAug(Augmenter):
    _COEF = ContrastJitterAug._COEF

    def __init__(self, p: float = 0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        img = to_numpy(src).astype("float32")
        if py_random().random() < self.p:
            gray = (img * self._COEF).sum(-1, keepdims=True)
            img = np.broadcast_to(gray, img.shape).copy()
        return to_tensor(img)


class HueJitterAug(Augmenter):
    """Rotate the chroma plane in YIQ space by an angle drawn in
    [-hue, hue] (units of pi)."""

    _TYIQ = np.array([[0.299, 0.587, 0.114],
                      [0.596, -0.274, -0.321],
                      [0.211, -0.523, 0.311]], "float32")
    _ITYIQ = np.array([[1.0, 0.956, 0.621],
                       [1.0, -0.272, -0.647],
                       [1.0, -1.107, 1.705]], "float32")

    def __init__(self, hue: float):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        img = to_numpy(src).astype("float32")
        alpha = py_random().uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        rot = np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], "float32")
        t = (self._ITYIQ @ rot @ self._TYIQ).T
        return to_tensor(img @ t)


class LightingAug(Augmenter):
    """AlexNet's PCA noise: add ``eigvec @ (eigval * N(0, alphastd))``
    to every pixel."""

    def __init__(self, alphastd: float, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, "float32")
        self.eigvec = np.asarray(eigvec, "float32")

    def __call__(self, src):
        img = to_numpy(src).astype("float32")
        alpha = numpy_random().normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return to_tensor(img + rgb.astype("float32"))


class RandomOrderAug(Augmenter):
    """Apply ``ts`` in a random order."""

    def __init__(self, ts: List[Augmenter]):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        order = list(range(len(self.ts)))
        py_random().shuffle(order)
        for i in order:
            src = self.ts[i](src)
        return src


class ColorJitterAug(RandomOrderAug):
    """Brightness, contrast and saturation jitter in a random order."""

    def __init__(self, brightness: float, contrast: float,
                 saturation: float):
        ts: List[Augmenter] = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)
        self.brightness, self.contrast, self.saturation = \
            brightness, contrast, saturation


def CreateAugmenter(data_shape, resize: int = 0, rand_crop: bool = False,
                    rand_resize: bool = False, rand_mirror: bool = False,
                    mean=None, std=None, brightness: float = 0,
                    contrast: float = 0, saturation: float = 0,
                    rand_gray: float = 0, inter_method: int = 2
                    ) -> List[Augmenter]:
    """The standard augmenter list, as the JAX package builds it
    (``rand_resize`` takes a random crop, as ``rand_crop`` does)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize or rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast:
        auglist.append(ContrastJitterAug(contrast))
    if saturation:
        auglist.append(SaturationJitterAug(saturation))
    if rand_gray:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], "float32")
    if std is True:
        std = np.array([58.395, 57.12, 57.375], "float32")
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist
