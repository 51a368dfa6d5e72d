"""The port's ``io`` iterators against the JAX package's.

The same numpy-seeded arrays, CSV files and record files go through
both; ``NDArrayIter``'s shuffle and ``ImageRecordIter``'s mirror draw
from numpy's global generator, seeded the same on both sides. Batches,
pads and descriptors are compared exactly, except ``ImageRecordIter``
where it resizes (records of another size than ``data_shape``): within
2e-3 on 0-255 (``tests/test_torch_image.py``'s bilinear bound), then
normalized by the std.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrio

from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trio
from mxnet_tpu_torch.base import MXNetError

RESIZE_ATOL = 2e-3


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x.asnumpy()


def _desc(d):
    return [(x.name, tuple(x.shape), x.dtype, x.layout) for x in d]


def _same_batches(t_iter, j_iter, atol=0.0, seed=None):
    """Both iterators' batches (each from numpy seed ``seed`` when
    given) held equal; returns the port's."""
    if seed is not None:
        onp.random.seed(seed)
    tb = list(t_iter)
    if seed is not None:
        onp.random.seed(seed)
    jb = list(j_iter)
    assert len(tb) == len(jb) > 0
    for a, b in zip(tb, jb):
        assert a.pad == b.pad
        assert _desc(a.provide_data) == _desc(b.provide_data)
        assert _desc(a.provide_label) == _desc(b.provide_label)
        for key in ("data", "label"):
            assert len(getattr(a, key)) == len(getattr(b, key))
            for u, v in zip(getattr(a, key), getattr(b, key)):
                assert isinstance(u, torch.Tensor)
                assert onp.isfinite(_np(u)).all()
                onp.testing.assert_allclose(_np(u), _np(v), rtol=0,
                                            atol=atol)
    return tb


def _arrays(n=11):
    r = onp.random.RandomState(0)
    return (r.uniform(size=(n, 2, 3)).astype("float32"),
            r.randint(0, 5, n).astype("float32"))


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(handle, shuffle):
    x, y = _arrays()
    onp.random.seed(3)
    t = tio.NDArrayIter(x, y, 4, shuffle=shuffle, last_batch_handle=handle)
    onp.random.seed(3)
    j = jio.NDArrayIter(x, y, 4, shuffle=shuffle, last_batch_handle=handle)
    assert _desc(t.provide_data) == _desc(j.provide_data)
    _same_batches(t, j)
    onp.random.seed(4)
    t.reset()
    onp.random.seed(4)
    j.reset()
    _same_batches(t, j)


def test_ndarray_iter_dict_and_list_inputs():
    x, y = _arrays()
    for data in ({"b": x, "a": x * 2}, [x, x + 1]):
        t = tio.NDArrayIter(data, [y], 3)
        j = jio.NDArrayIter(data, [y], 3)
        _same_batches(t, j)
    with pytest.raises(MXNetError):
        tio.NDArrayIter(x, y, 2, last_batch_handle="wrap")
    with pytest.raises(MXNetError):
        tio.NDArrayIter("not an array", None, 2)


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    r = onp.random.RandomState(1)
    onp.savetxt(tmp_path / "d.csv", r.uniform(size=(7, 6)), delimiter=",")
    onp.savetxt(tmp_path / "l.csv", r.randint(0, 3, (7, 1)), delimiter=",")
    kw = dict(data_shape=(2, 3), batch_size=3, round_batch=round_batch,
              label_csv=str(tmp_path / "l.csv"))
    t = tio.CSVIter(str(tmp_path / "d.csv"), **kw)
    j = jio.CSVIter(str(tmp_path / "d.csv"), **kw)
    _same_batches(t, j)
    t.reset()
    j.reset()
    _same_batches(t, j)


def test_resize_and_prefetching_iters_match_jax():
    x, y = _arrays()
    for size in (2, 5):
        t = tio.ResizeIter(tio.NDArrayIter(x, y, 4), size)
        j = jio.ResizeIter(jio.NDArrayIter(x, y, 4), size)
        assert len(_same_batches(t, j)) == size
        t.reset()
        j.reset()
        _same_batches(t, j)
    t = tio.PrefetchingIter(tio.NDArrayIter(x, y, 4), prefetch_depth=3)
    j = jio.PrefetchingIter(jio.NDArrayIter(x, y, 4))
    _same_batches(t, j)
    with pytest.raises(StopIteration):
        t.next()
    t.reset()
    j.reset()
    _same_batches(t, j)


def test_prefetching_iter_carries_errors():
    class Boom(tio.DataIter):
        def next(self):
            raise KeyError("boom")
    it = tio.PrefetchingIter([Boom(2)])
    for _ in range(2):
        with pytest.raises(KeyError):
            it.next()


def _record_file(path, n, shape, label_width=1, seed=5, mod=trio,
                 png=False):
    """``n`` records of CHW uint8 images, raw (or as PNG)."""
    r = onp.random.RandomState(seed)
    w = mod.MXRecordIO(str(path), "w")
    imgs, labels = [], []
    for i in range(n):
        img = r.randint(0, 256, shape).astype("uint8")
        label = r.randint(0, 9, label_width).astype("float32") \
            if label_width > 1 else float(r.randint(0, 9))
        head = mod.IRHeader(0, label, i, 0)
        w.write(mod.pack_img(head, img.transpose(1, 2, 0), img_fmt=".png")
                if png else mod.pack(head, img.tobytes()))
        imgs.append(img)
        labels.append(label)
    w.close()
    return imgs, labels


@pytest.mark.parametrize("case", [
    dict(n=10, rec=(3, 8, 6), shape=(3, 8, 6), round_batch=True),
    dict(n=10, rec=(3, 8, 6), shape=(3, 8, 6), round_batch=False,
         rand_mirror=True, mean_r=120.0, mean_g=110.0, mean_b=100.0,
         std_r=50.0, std_g=60.0, std_b=70.0),
    dict(n=9, rec=(3, 8, 6), shape=(3, 8, 6), label_width=3,
         rand_mirror=True),
    dict(n=7, rec=(3, 12, 10), shape=(3, 6, 5), rand_mirror=True,
         std_r=2.0, std_g=2.0, std_b=2.0, png=True),
], ids=["plain", "mirror-normalize", "multi-label", "resize-png"])
def test_image_record_iter_matches_jax(tmp_path, case):
    case = dict(case)
    n, rec, shape = case.pop("n"), case.pop("rec"), case.pop("shape")
    lw = case.get("label_width", 1)
    png = case.pop("png", False)
    if png:
        pytest.importorskip("PIL")
    imgs, labels = _record_file(tmp_path / "r.rec", n, rec, lw, png=png)
    atol = 0.0 if rec == shape else RESIZE_ATOL / 2.0
    t = tio.ImageRecordIter(str(tmp_path / "r.rec"), shape, 4,
                            prefetch_buffer=3, **case)
    j = jio.ImageRecordIter(str(tmp_path / "r.rec"), shape, 4, **case)
    for seed in (6, 7):
        tb = _same_batches(t, j, atol, seed)
        t.reset()
        j.reset()
    t.close()
    if rec == shape and not case.get("rand_mirror"):
        onp.testing.assert_array_equal(
            tb[0].data[0][1].numpy(), imgs[1].astype("float32"))
    first = tb[0].label[0].numpy()
    onp.testing.assert_array_equal(
        first, onp.stack(labels[:4]) if lw > 1 else onp.array(labels[:4]))


def test_image_record_iter_reads_jax_files_and_resets(tmp_path):
    _record_file(tmp_path / "j.rec", 6, (3, 4, 4), mod=jrio)
    t = tio.ImageRecordIter(str(tmp_path / "j.rec"), (3, 4, 4), 4)
    assert [b.pad for b in t] == [0, 2]
    with pytest.raises(StopIteration):
        t.next()
    t.reset()
    assert [b.pad for b in t] == [0, 2]
    assert tio.MXDataIter is tio.ImageRecordIter
    t.close()


def test_image_record_iter_raw_record_of_other_shape_raises(tmp_path):
    """A raw record is read only at ``data_shape``: one of another size
    raises in both packages (records of another size are encoded
    images, as im2rec writes them)."""
    _record_file(tmp_path / "raw.rec", 2, (3, 12, 10))
    t = tio.ImageRecordIter(str(tmp_path / "raw.rec"), (3, 7, 5), 2)
    with pytest.raises(MXNetError, match="payload"):
        t.next()
    t.close()
    with pytest.raises(Exception, match="payload"):
        jio.ImageRecordIter(str(tmp_path / "raw.rec"), (3, 7, 5), 2).next()