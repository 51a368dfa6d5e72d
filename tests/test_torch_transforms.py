"""The port's vision transforms against the JAX package's, all 23.

The same numpy-seeded images go through both, the random transforms
from the same seeds of numpy's generator (and Python's ``random``, which
``RandomHue`` draws from, as the JAX package's does).

Tolerances: exact, where the port repeats the JAX package's numpy
operations (every transform but two) and for ``Rotate`` /
``RandomRotation`` (the JAX grid and sampling in the same float32
operations, bit-equal on the CPU). ``CropResize`` with a bilinear resize:
within 2e-3 on 0-255 (RESIZE_ATOL of ``tests/test_torch_image.py``,
``F.interpolate`` with ``antialias=True`` against ``jax.image.resize``),
and into uint8 within one level (the float result is truncated on both
sides); its nearest resize is exact. ``HybridRandomApply`` draws its
coin from the JAX package's device generator there, from numpy here, so
it is held only at p near 0 and near 1.
"""
import random

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.data.vision import transforms as J

from mxnet_tpu_torch.gluon.data.vision import transforms as T

RESIZE_ATOL = 2e-3
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _seed(s):
    random.seed(s)
    onp.random.seed(s)


def _img(shape=(20, 16, 3), seed=0, dtype="uint8"):
    r = onp.random.RandomState(seed)
    if dtype == "uint8":
        return r.randint(0, 256, shape).astype("uint8")
    return r.uniform(0, 1, shape).astype(dtype)


def _hwc(seed=0):
    return _img(seed=seed)


def _chw(seed=0):
    return _img((3, 12, 10), seed, "float32")


def test_same_public_names():
    assert sorted(T.__all__) == sorted(J.__all__)
    assert len(T.__all__) == 23


CASES = [
    ("Cast", ("float16",), _hwc), ("Cast", (), _hwc),
    ("ToTensor", (), _hwc), ("ToTensor", (), lambda s: _img((2, 5, 4, 3), s)),
    ("Normalize", (MEAN, STD), _chw), ("Normalize", (0.5, 2.0), _chw),
    ("Resize", (7,), _hwc), ("Resize", ((9, 5),), _hwc),
    ("CenterCrop", (8,), _hwc), ("CenterCrop", ((30, 8),), _hwc),
    ("RandomResizedCrop", (8,), _hwc),
    ("RandomResizedCrop", ((9, 7), (0.9, 1.0), (3.0, 4.0)), _hwc),
    ("RandomCrop", (7,), _hwc), ("RandomCrop", ((5, 9), 2), _hwc),
    ("RandomFlipLeftRight", (), _hwc), ("RandomFlipTopBottom", (), _hwc),
    ("RandomBrightness", (0.4,), _hwc), ("RandomContrast", (0.4,), _hwc),
    ("RandomSaturation", (0.4,), _hwc), ("RandomHue", (0.3,), _hwc),
    ("RandomColorJitter", (0.4, 0.4, 0.4, 0.2), _hwc),
    ("RandomColorJitter", (0.0, 0.3, 0.0, 0.0), _hwc),
    ("RandomLighting", (0.1,), _hwc), ("RandomGray", (0.5,), _hwc),
    ("Rotate", (30.0,), _chw), ("Rotate", (-50.0, True), _chw),
    ("Rotate", (75.0, False, True), lambda s: _img((2, 3, 8, 8), s, "f4")),
    ("RandomRotation", ((-40.0, 40.0),), _chw),
    ("RandomRotation", ((-40.0, 40.0), False, True, 0.5), _chw),
    ("CropResize", (2, 3, 8, 9), _hwc),
    ("CropResize", (2, 3, 8, 9, 6, 0), _hwc),
    ("CropResize", (1, 1, 5, 4, None), lambda s: _img((2, 8, 7, 3), s)),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_transform_matches_jax(case):
    name, args, make = case
    t, j = getattr(T, name)(*args), getattr(J, name)(*args)
    assert isinstance(t, torch.nn.Module)
    for seed in range(6):
        x = make(seed)
        _seed(seed)
        got = t(torch.from_numpy(x) if seed % 2 else x)
        _seed(seed)
        ref = j(mx.nd.array(x, dtype=x.dtype)).asnumpy()
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert tuple(got.shape) == ref.shape
        assert str(got.dtype) == f"torch.{ref.dtype}"
        onp.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("batch", [False, True])
def test_crop_resize_bilinear_matches_jax(dtype, batch):
    shape = (2, 14, 12, 3) if batch else (14, 12, 3)
    x = (_img(shape, 1, "float32") * 255).astype(dtype)
    for size in (7, (15, 9)):
        got = T.CropResize(1, 2, 9, 10, size)(x)
        ref = J.CropResize(1, 2, 9, 10, size)(
            mx.nd.array(x, dtype=dtype)).asnumpy()
        assert str(got.dtype) == f"torch.{dtype}"
        atol = 1 if dtype == "uint8" else RESIZE_ATOL
        onp.testing.assert_allclose(got.numpy().astype("f4"),
                                    ref.astype("f4"), rtol=0, atol=atol)
    with pytest.raises(ValueError):
        T.CropResize(0, 0, 2, 2)(torch.zeros(4, 4))


def test_the_resnet_records_chain_matches_jax():
    """The record pipeline's transform chain at 32 x 32, from 48 x 64
    images: bit-equal for the same seeds."""
    def chain(M):
        return M.Compose([M.RandomResizedCrop(32), M.RandomFlipLeftRight(),
                          M.RandomColorJitter(0.4, 0.4, 0.4),
                          M.RandomLighting(0.1), M.ToTensor(),
                          M.Normalize(MEAN, STD)])
    t, j = chain(T), chain(J)
    for seed in range(5):
        x = _img((48, 64, 3), seed)
        _seed(seed)
        got = t(x)
        _seed(seed)
        ref = j(mx.nd.array(x, dtype="uint8")).asnumpy()
        assert got.shape == (3, 32, 32)
        onp.testing.assert_array_equal(got.numpy(), ref)


class _Double(torch.nn.Module):
    def forward(self, x):
        return x * 2


def test_random_apply_matches_jax():
    for p in (1e-6, 0.5, 1 - 1e-6):
        t = T.RandomApply(T.Compose([T.RandomBrightness(0.5)]), p)
        j = J.RandomApply(J.Compose([J.RandomBrightness(0.5)]), p)
        for seed in range(8):
            x = _img(seed=seed)
            _seed(seed)
            got = t(x)
            _seed(seed)
            ref = j(mx.nd.array(x, dtype="uint8")).asnumpy()
            onp.testing.assert_array_equal(onp.asarray(got), ref)


def test_hybrid_random_apply_near_0_and_1():
    x = torch.ones(2, 2, 3)
    for p, expect in ((1e-6, 1.0), (1 - 1e-6, 2.0)):
        tf = T.HybridRandomApply(_Double(), p)
        outs = {float(tf(x)[0, 0, 0]) for _ in range(40)}
        assert outs == {expect}

    class JDouble(mx.gluon.HybridBlock):
        def forward(self, v):
            return v * 2.0

    jx = mx.nd.array(onp.ones((2, 2, 3), "float32"))
    for p, expect in ((0.0, 1.0), (1.0, 2.0)):
        outs = {float(J.HybridRandomApply(JDouble(), p)(jx).asnumpy()
                      .ravel()[0]) for _ in range(5)}
        assert outs == {expect}
    with pytest.raises(ValueError):
        T.HybridRandomApply(T.ToTensor(), 0.5)


def test_hybrid_compose():
    x = _img((10, 9, 3), 2)
    t = T.HybridCompose([T.CropResize(1, 1, 6, 6), _Double()])
    j = J.HybridCompose([J.CropResize(1, 1, 6, 6)])
    onp.testing.assert_array_equal(
        t(torch.from_numpy(x)).numpy(),
        j(mx.nd.array(x, dtype="uint8")).asnumpy() * 2)
    for bad in (T.ToTensor(), T.RandomFlipLeftRight(), T.Cast()):
        with pytest.raises(ValueError):
            T.HybridCompose([T.CropResize(0, 0, 2, 2), bad])


def test_rotation_errors_match_jax():
    for mod in (T, J):
        with pytest.raises(ValueError):
            mod.RandomRotation((10, -10))
        with pytest.raises(ValueError):
            mod.RandomRotation((-10, 10), rotate_with_proba=1.5)
    with pytest.raises(TypeError):
        T.Rotate(10)(torch.zeros(3, 4, 4, dtype=torch.float64))
    with pytest.raises(TypeError):
        T.RandomRotation((-10, 10))(_img())
