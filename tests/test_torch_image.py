"""The port's ``image`` module against the JAX package's.

The same numpy-seeded images go through both; random augmenters run
from the same seeds of Python's ``random`` and numpy's generator.

Tolerances:
- decoding: exact against the JAX package's PIL path (its native
  decoder switched off). Against its native libjpeg / libpng path, which
  this environment builds: RGB JPEG exact here (the bound held is 1
  level of 255), PNG exact. A colour JPEG read with ``flag=0`` is not
  compared with the native path: libjpeg's grey output is the file's Y
  channel, PIL's is its RGB weighted by ITU-R 601, and the JAX package's
  two paths part by up to 12 levels on the test image (the port keeps
  the PIL meaning);
- bilinear resizing (``imresize``, and every augmenter that resizes):
  within RESIZE_ATOL = 2e-3 on 0-255 (``F.interpolate`` with
  ``antialias=True`` against ``jax.image.resize``; measured 4.6e-5);
  nearest resizing exact;
- rotation: exact (the JAX grid and sampling in the same float32
  operations; measured bit-equal on the CPU);
- everything else exact: the same numpy operations in the same order.
"""
import io
import random
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import image as jimg
from mxnet_tpu.gluon.data.vision import datasets as jdatasets
from mxnet_tpu.image import image as jimage_mod

from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.data.vision import datasets as tdatasets

RESIZE_ATOL = 2e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _seed(s):
    random.seed(s)
    onp.random.seed(s)


def _img(h=20, w=16, c=3, seed=0, dtype="uint8"):
    r = onp.random.RandomState(seed)
    return r.randint(0, 256, (h, w, c)).astype(dtype)


def _encoded(img, fmt, **kw):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img.squeeze(-1) if img.shape[-1] == 1 else img).save(
        buf, format=fmt, **kw)
    return buf.getvalue()


@pytest.fixture
def jax_pil(monkeypatch):
    """The JAX package's decoder on its PIL path."""
    monkeypatch.setattr(jimage_mod, "_native_jpeg_decode",
                        lambda payload, flag: None)


@pytest.mark.parametrize("fmt,c", [("JPEG", 3), ("PNG", 3), ("PNG", 1),
                                   ("JPEG", 1)])
@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_matches_jax_pil_path(jax_pil, fmt, c, flag, to_rgb):
    pytest.importorskip("PIL")
    payload = _encoded(_img(c=c), fmt, **({"quality": 90}
                                          if fmt == "JPEG" else {}))
    got = timg.imdecode(payload, flag, to_rgb)
    ref = jimg.imdecode(payload, flag, to_rgb).asnumpy()
    assert got.dtype == torch.uint8
    onp.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape[-1] == (1 if flag == 0 else 3)


def test_imdecode_against_jax_native_path():
    pytest.importorskip("PIL")
    if jimage_mod._native_jpeg_decode(_encoded(_img(), "JPEG"), 1) is None:
        pytest.skip("the JAX package's native decoder is not built here")
    img = _img(32, 40, seed=7)
    jpeg = _encoded(img, "JPEG", quality=95)
    diff = onp.abs(timg.imdecode(jpeg).numpy().astype(int)
                   - jimg.imdecode(jpeg).asnumpy().astype(int))
    assert diff.max() <= 1
    png = _encoded(img, "PNG")
    onp.testing.assert_array_equal(timg.imdecode(png).numpy(),
                                   jimg.imdecode(png).asnumpy())
    onp.testing.assert_array_equal(timg.imdecode(png).numpy(), img)


def test_decoders_without_pil(monkeypatch):
    pytest.importorskip("PIL")
    jpeg = _encoded(_img(), "JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(MXNetError, match="PIL"):
        timg.imdecode(jpeg)
    raw = _img(4, 5, seed=3).transpose(2, 0, 1).copy()
    onp.testing.assert_array_equal(
        timg.imdecode_or_raw(raw.tobytes(), (3, 4, 5)),
        raw.transpose(1, 2, 0).astype("float32"))


@pytest.mark.parametrize("kind", ["uint8", "float32", "jpeg", "bad"])
def test_imdecode_or_raw_matches_jax(kind):
    shape = (3, 6, 5)
    r = onp.random.RandomState(4)
    if kind == "jpeg":
        pytest.importorskip("PIL")
        payload = _encoded(_img(6, 5), "JPEG", quality=95)
    elif kind == "bad":
        payload = b"\x01" * 7
        with pytest.raises(MXNetError):
            timg.imdecode_or_raw(payload, shape)
        return
    else:
        payload = r.uniform(0, 255, shape).astype(kind).tobytes()
    got = timg.imdecode_or_raw(payload, shape)
    ref = jimg.imdecode_or_raw(payload, shape)
    assert isinstance(got, onp.ndarray) and got.dtype == ref.dtype
    if kind == "jpeg":
        assert onp.abs(got.astype(int) - ref.astype(int)).max() <= 1
    else:
        onp.testing.assert_array_equal(got, ref)


RESIZES = [((48, 64), (22, 22)), ((30, 20), (25, 18)), ((10, 12), (22, 22)),
           ((17, 9), (17, 30)), ((120, 160), (56, 56))]


@pytest.mark.parametrize("shapes", RESIZES, ids=str)
@pytest.mark.parametrize("interp", [0, 1, 2])
def test_imresize_matches_jax(shapes, interp):
    (h, w), (oh, ow) = shapes
    x = onp.random.RandomState(5).uniform(0, 255, (h, w, 3)).astype("f4")
    got = timg.imresize(x, ow, oh, interp)
    ref = jimg.imresize(x, ow, oh, interp).asnumpy()
    assert got.shape == (oh, ow, 3) and got.dtype == torch.float32
    if interp == 0:
        onp.testing.assert_array_equal(got.numpy(), ref)
    else:
        onp.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                    atol=RESIZE_ATOL)
    onp.testing.assert_array_equal(timg.imresize_np(x, ow, oh, interp),
                                   got.numpy())


@pytest.mark.parametrize("zoom", [(False, False), (True, False),
                                  (False, True)])
def test_imrotate_matches_jax(zoom):
    zin, zout = zoom
    x = onp.random.RandomState(6).uniform(0, 1, (2, 3, 9, 13)).astype("f4")
    deg = onp.array([33.0, -71.5], "f4")
    got = timg.imrotate(torch.from_numpy(x), deg, zoom_in=zin,
                        zoom_out=zout)
    ref = jimg.imrotate(mx.nd.array(x), mx.nd.array(deg), zoom_in=zin,
                        zoom_out=zout).asnumpy()
    onp.testing.assert_array_equal(got.numpy(), ref)
    one = timg.imrotate(x[0], 90.0, zoom_in=zin, zoom_out=zout)
    onp.testing.assert_array_equal(
        one.numpy(), jimg.imrotate(mx.nd.array(x[0]), 90.0, zoom_in=zin,
                                   zoom_out=zout).asnumpy())
    for seed in (1, 2):
        _seed(seed)
        a = timg.random_rotate(torch.from_numpy(x), (-40, 40), zin, zout)
        _seed(seed)
        b = jimg.random_rotate(mx.nd.array(x), (-40, 40), zin, zout)
        onp.testing.assert_array_equal(a.numpy(), b.asnumpy())
        _seed(seed)
        a = timg.random_rotate(torch.from_numpy(x[1]), (-40, 40))
        _seed(seed)
        b = jimg.random_rotate(mx.nd.array(x[1]), (-40, 40))
        onp.testing.assert_array_equal(a.numpy(), b.asnumpy())


def test_imrotate_errors():
    x = torch.zeros(3, 4, 4)
    with pytest.raises(ValueError):
        timg.imrotate(x, 10, zoom_in=True, zoom_out=True)
    with pytest.raises(TypeError):
        timg.imrotate(x.double(), 10)
    with pytest.raises(TypeError):
        timg.imrotate(x, [10.0, 20.0])
    with pytest.raises(ValueError):
        timg.imrotate(torch.zeros(2, 3, 4, 4), [1.0, 2.0, 3.0])
    with pytest.raises(ValueError):
        timg.imrotate(torch.zeros(4, 4), 1.0)


def _crops():
    return [
        lambda m: m.fixed_crop(_img(), 2, 3, 8, 9),
        lambda m: m.fixed_crop(_img(), 2, 3, 8, 9, size=(5, 4)),
        lambda m: m.center_crop(_img(), (10, 12))[0],
        lambda m: m.center_crop(_img(), (30, 12))[0],
        lambda m: m.random_crop(_img(), (7, 5))[0],
        lambda m: m.random_size_crop(_img(), (6, 6), (0.2, 0.9),
                                     (0.75, 1.33))[0],
        lambda m: m.random_size_crop(_img(), (6, 6), 0.95, (3.9, 4.0))[0],
        lambda m: m.resize_short(_img(), 9),
        lambda m: m.color_normalize(_img(), onp.array([1.0, 2.0, 3.0], "f4"),
                                    onp.array([2.0, 3.0, 4.0], "f4")),
        lambda m: m.color_normalize(_img(), onp.float32(5.0)),
    ]


@pytest.mark.parametrize("i", range(len(_crops())))
def test_crop_functions_match_jax(i):
    fn = _crops()[i]
    for seed in (3, 4):
        _seed(seed)
        got = _np(fn(timg))
        _seed(seed)
        ref = _np(fn(jimg))
        assert got.shape == ref.shape
        onp.testing.assert_allclose(got, ref, rtol=0, atol=RESIZE_ATOL)
        if i in (0, 2, 4, 8, 9):
            onp.testing.assert_array_equal(got, ref)


_EIGVAL = onp.array([55.46, 4.794, 1.148], "float32")
_EIGVEC = onp.array([[-0.5675, 0.7192, 0.4009],
                     [-0.5808, -0.0045, -0.8140],
                     [-0.5836, -0.6948, 0.4203]], "float32")

AUGMENTERS = [
    ("ResizeAug", (12,), True), ("ForceResizeAug", ((9, 7),), True),
    ("CastAug", (), False), ("HorizontalFlipAug", (0.5,), False),
    ("RandomCropAug", ((9, 7),), False), ("CenterCropAug", ((9, 7),), False),
    ("ColorNormalizeAug", (onp.array([120.0, 110.0, 100.0], "f4"),
                           onp.array([50.0, 60.0, 70.0], "f4")), False),
    ("ColorNormalizeAug", (None, onp.array([50.0, 60.0, 70.0], "f4")),
     False),
    ("BrightnessJitterAug", (0.4,), False),
    ("ContrastJitterAug", (0.4,), False),
    ("SaturationJitterAug", (0.4,), False),
    ("RandomGrayAug", (0.5,), False), ("HueJitterAug", (0.3,), False),
    ("LightingAug", (0.1, _EIGVAL, _EIGVEC), False),
    ("ColorJitterAug", (0.4, 0.3, 0.2), False),
]


@pytest.mark.parametrize("case", AUGMENTERS, ids=lambda c: c[0])
def test_augmenters_match_jax(case):
    name, args, resizes = case
    t, j = getattr(timg, name)(*args), getattr(jimg, name)(*args)
    assert isinstance(t, timg.Augmenter)
    for seed in range(4):
        x = _img(seed=seed)
        _seed(seed)
        got = t(x)
        _seed(seed)
        ref = j(x).asnumpy()
        assert isinstance(got, torch.Tensor)
        if resizes:
            onp.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                        atol=RESIZE_ATOL)
        else:
            onp.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kw", [
    dict(), dict(resize=14, rand_crop=True, rand_mirror=True, mean=True,
                 std=True),
    dict(rand_resize=True, brightness=0.3, contrast=0.3, saturation=0.3,
         rand_gray=0.5, mean=onp.array([1.0, 2.0, 3.0], "f4")),
])
def test_create_augmenter_matches_jax(kw):
    t = timg.CreateAugmenter((3, 8, 6), **kw)
    j = jimg.CreateAugmenter((3, 8, 6), **kw)
    assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
    # the resize's limit on 0-255, carried through the division by std
    atol = RESIZE_ATOL / float(onp.min(t[-1].std)) if "resize" in kw else 0
    for seed in range(3):
        x = _img(seed=seed)
        _seed(seed)
        got = timg.SequentialAug(t)(x)
        _seed(seed)
        ref = jimg.SequentialAug(j)(x).asnumpy()
        onp.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)
        assert got.shape == (8, 6, 3)


def test_random_order_matches_jax():
    t = timg.RandomOrderAug([timg.BrightnessJitterAug(0.5),
                             timg.HueJitterAug(0.2), timg.CastAug()])
    j = jimg.RandomOrderAug([jimg.BrightnessJitterAug(0.5),
                             jimg.HueJitterAug(0.2), jimg.CastAug()])
    for seed in range(4):
        _seed(seed)
        got = t(_img(seed=seed))
        _seed(seed)
        onp.testing.assert_array_equal(got.numpy(),
                                       j(_img(seed=seed)).asnumpy())


def _image_folder(root):
    pytest.importorskip("PIL")
    imgs = {}
    for k, cls in enumerate(("cat", "dog")):
        (root / cls).mkdir()
        for n in range(2):
            img = _img(5, 4, seed=10 * k + n)
            onp.save(root / cls / f"{n}.npy", img)
            (root / cls / f"{n}.png").write_bytes(_encoded(img, "PNG"))
            imgs[(cls, n)] = img
    (root / "notes.txt").write_text("not a class")
    (root / "cat" / "skip.txt").write_text("not an image")
    return imgs


def test_imread_and_image_folder_dataset(tmp_path):
    imgs = _image_folder(tmp_path)
    onp.testing.assert_array_equal(
        timg.imread(str(tmp_path / "dog" / "1.png")).numpy(),
        imgs[("dog", 1)])
    onp.testing.assert_array_equal(
        timg.imread(str(tmp_path / "dog" / "1.npy")).numpy(),
        imgs[("dog", 1)])
    gray = timg.imread(str(tmp_path / "cat" / "0.png"), 0)
    assert gray.shape == (5, 4, 1)
    ds = tdatasets.ImageFolderDataset(str(tmp_path))
    assert ds.synsets == ["cat", "dog"] and len(ds) == 8
    for i, (path, label) in enumerate(ds.items):
        img, lbl = ds[i]
        cls, name = path.split("/")[-2:]
        assert lbl == label == ("cat", "dog").index(cls)
        onp.testing.assert_array_equal(img.numpy(),
                                       imgs[(cls, int(name[0]))])
    shifted = tdatasets.ImageFolderDataset(
        str(tmp_path), transform=lambda x, y: (x.float() + 1, y * 10))
    img, lbl = shifted[7]
    assert lbl == 10 and img.dtype == torch.float32
    with pytest.raises(MXNetError):
        tdatasets.ImageFolderDataset(str(tmp_path / "missing"))


def test_jax_image_folder_dataset_calls_a_missing_imread(tmp_path):
    """The reference's ``ImageFolderDataset.__getitem__`` calls
    ``mx_image.imread``, which ``mxnet_tpu/image`` does not define."""
    _image_folder(tmp_path)
    ds = jdatasets.ImageFolderDataset(str(tmp_path))
    assert len(ds) == 8
    assert not hasattr(jimg, "imread")
    with pytest.raises(AttributeError, match="imread"):
        ds[0]
