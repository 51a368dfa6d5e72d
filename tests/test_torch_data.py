"""The port's ``gluon.data`` (samplers, batchify functions, datasets,
``DataLoader``) and ``gluon.utils`` against the JAX package's.

The same numpy-seeded data goes through both. Exact throughout, except
``clip_global_norm``: its total and its scaled arrays within 1e-6
relative (the JAX package adds float32 sums in Python floats, the port
in float64 on the host; both take each array's sum of squares in
float32). Batches are compared by value: the port keeps an int64 label
as int64 where the JAX ``NDArray`` narrows it to int32.
"""
import hashlib
import os
import subprocess
import sys
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon import utils as jutils
from mxnet_tpu.gluon.data import batchify as jbatchify

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon import utils as tutils
from mxnet_tpu_torch.gluon.data import batchify as tbatchify
from mxnet_tpu_torch.gluon.data.vision import transforms as T

REL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    assert a.shape == b.shape
    onp.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- samplers

def _sampler_pairs(n=23):
    return [
        (tdata.SequentialSampler(n, start=3), jdata.SequentialSampler(n, 3)),
        (tdata.RandomSampler(n), jdata.RandomSampler(n)),
        (tdata.IntervalSampler(n, 5), jdata.IntervalSampler(n, 5)),
        (tdata.IntervalSampler(n, 5, rollover=False),
         jdata.IntervalSampler(n, 5, rollover=False)),
        (tdata.FilterSampler(lambda v: v % 3 == 0, list(range(n))),
         jdata.FilterSampler(lambda v: v % 3 == 0, list(range(n)))),
    ]


@pytest.mark.parametrize("i", range(5))
def test_samplers_match_jax(i):
    t, j = _sampler_pairs()[i]
    assert len(t) == len(j)
    for seed in (0, 1):
        onp.random.seed(seed)
        got = list(t)
        onp.random.seed(seed)
        assert got == list(j)


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_batch_sampler_matches_jax(last):
    t = tdata.BatchSampler(tdata.RandomSampler(22), 5, last)
    j = jdata.BatchSampler(jdata.RandomSampler(22), 5, last)
    onp.random.seed(3)
    got = [list(t) for _ in range(3)] + [len(t)]
    onp.random.seed(3)
    assert got == [list(j) for _ in range(3)] + [len(j)]
    with pytest.raises(ValueError):
        list(tdata.BatchSampler(tdata.SequentialSampler(3), 2, "bad"))


# ---------------------------------------------------------------- batchify

def _samples(n=5, shape=(4, 3), seed=0, dtype="float32"):
    r = onp.random.RandomState(seed)
    return [r.uniform(-1, 1, shape).astype(dtype) for _ in range(n)]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_stack_matches_jax(as_tensor):
    xs = _samples()
    t_in = [torch.from_numpy(x) for x in xs] if as_tensor else xs
    _same(tbatchify.Stack()(t_in), jbatchify.Stack()(xs))
    f64 = _samples(dtype="float64")
    out = tbatchify.Stack()(f64)
    assert out.dtype == torch.float32
    _same(out, jbatchify.Stack()(f64))


@pytest.mark.parametrize("axis,val,dtype", [(0, 0, None), (1, -1, "float32"),
                                            (0, 7, "int32")])
def test_pad_matches_jax(axis, val, dtype):
    r = onp.random.RandomState(1)
    xs = [r.randint(0, 9, (n, 3) if axis == 0 else (3, n)).astype("int64")
          for n in (2, 5, 1, 4)]
    t = tbatchify.Pad(axis, val, dtype)(xs)
    _same(t, jbatchify.Pad(axis, val, dtype)(xs))
    if dtype:
        assert str(t.dtype) == f"torch.{dtype}"


def test_group_and_image_normalize_match_jax():
    r = onp.random.RandomState(2)
    imgs = [r.randint(0, 256, (6, 5, 3)).astype("uint8") for _ in range(4)]
    labels = [r.randint(0, 9, (3,)) for _ in range(4)]
    data = list(zip(imgs, labels))
    t = tbatchify.Group(tbatchify.ImageNormalize(),
                        tbatchify.Pad())(data)
    j = jbatchify.Group(jbatchify.ImageNormalize(), jbatchify.Pad())(data)
    # under 1 MB a batch: the JAX package takes its numpy path
    _same(t, j)
    assert t[0].shape == (4, 3, 6, 5) and t[0].is_contiguous()
    with pytest.raises(ValueError):
        tbatchify.ImageNormalize()([onp.zeros((2, 2, 3), "float32")])
    with pytest.raises(ValueError):
        tbatchify.ImageNormalize(mean=(0.5,), std=(0.5,))(imgs)


# ---------------------------------------------------------------- datasets

def test_datasets_match_jax():
    r = onp.random.RandomState(4)
    x = r.uniform(size=(11, 3)).astype("float32")
    y = r.randint(0, 5, 11)
    t, j = tdata.ArrayDataset(x, y), jdata.ArrayDataset(x, y)
    assert len(t) == len(j) == 11
    for a, b in ((t, j), (t.filter(lambda s: s[1] > 1),
                          j.filter(lambda s: s[1] > 1)),
                 (t.shard(3, 1), j.shard(3, 1)), (t.take(4), j.take(4)),
                 (t.transform(lambda a, b: (a * 2, b + 1)),
                  j.transform(lambda a, b: (a * 2, b + 1))),
                 (t.transform_first(lambda a: a - 1, lazy=False),
                  j.transform_first(lambda a: a - 1, lazy=False))):
        assert len(a) == len(b)
        for i in range(len(a)):
            _same(list(a[i]), list(b[i]))
    single = tdata.SimpleDataset(list(range(4))).transform_first(
        lambda v: v * 3)
    assert [single[i] for i in range(4)] == [0, 3, 6, 9]
    with pytest.raises(MXNetError):
        tdata.ArrayDataset(x, y[:3])


def test_record_file_dataset_reads_jax_records(tmp_path):
    from mxnet_tpu import recordio as jrio
    recs = [bytes([i]) * (i + 1) for i in range(9)]
    w = jrio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                               str(tmp_path / "d.rec"), "w")
    for i, rec in enumerate(recs):
        w.write_idx(i, rec)
    w.close()
    t = tdata.RecordFileDataset(str(tmp_path / "d.rec"))
    j = jdata.RecordFileDataset(str(tmp_path / "d.rec"))
    assert len(t) == len(j) == 9
    assert [t[i] for i in range(9)] == [j[i] for i in range(9)] == recs


def test_record_file_dataset_under_threaded_workers(tmp_path):
    """Sixteen workers (more than the cores) read one indexed file at
    once, with frequent thread switches: every record comes back whole (the reader's seek and read hold a lock; the JAX
    package's share one file position unguarded)."""
    from mxnet_tpu_torch import recordio as trio
    recs = [bytes([i % 251]) * (100 + i) for i in range(300)]
    w = trio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                               str(tmp_path / "d.rec"), "w")
    for i, rec in enumerate(recs):
        w.write_idx(i, rec)
    w.close()
    ds = tdata.RecordFileDataset(str(tmp_path / "d.rec"))
    loader = tdata.DataLoader(tdata.SimpleDataset(list(range(300))), 6,
                              num_workers=16, timeout=60,
                              batchify_fn=lambda idx: [(i, ds[i])
                                                       for i in idx])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)      # more thread switches, more races
    try:
        for _ in range(3):
            got = [pair for batch in loader for pair in batch]
            assert len(got) == 300
            assert all(rec == recs[i] for i, rec in got)
    finally:
        sys.setswitchinterval(old)


# ---------------------------------------------------------------- DataLoader

def _loader_data(n=23):
    r = onp.random.RandomState(6)
    return (r.uniform(size=(n, 2, 3)).astype("float32"),
            r.randint(0, 7, n).astype("int64"))


LOADER_CASES = [dict(batch_size=5), dict(batch_size=5, last_batch="discard"),
                dict(batch_size=5, last_batch="rollover"),
                dict(batch_size=4, shuffle=True),
                dict(batch_size=6, shuffle=True, last_batch="rollover")]


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("case", range(len(LOADER_CASES)))
def test_dataloader_batches_match_jax(workers, case):
    x, y = _loader_data()
    kw = LOADER_CASES[case]
    t = tdata.DataLoader(tdata.ArrayDataset(x, y), num_workers=workers, **kw)
    j = jdata.DataLoader(jdata.ArrayDataset(x, y), **kw)
    assert len(t) == len(j)
    onp.random.seed(8)
    got = [list(t) for _ in range(2)]
    onp.random.seed(8)
    ref = [list(j) for _ in range(2)]
    assert [len(e) for e in got] == [len(e) for e in ref]
    for a, b in zip(got, ref):
        for u, v in zip(a, b):
            _same(list(u), list(v))
    assert got[0][0][1].dtype == torch.int64


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_batch_sampler_and_batchify_fn(workers):
    x, y = _loader_data()
    bs = [[0, 3, 5], [1, 2], [22, 4, 9, 10]]
    t = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_sampler=bs,
                         num_workers=workers,
                         batchify_fn=tbatchify.Group(tbatchify.Stack(),
                                                     tbatchify.Stack()))
    j = jdata.DataLoader(jdata.ArrayDataset(x, y), batch_sampler=bs,
                         batchify_fn=jbatchify.Group(jbatchify.Stack(),
                                                     jbatchify.Stack()))
    assert len(t) == 3
    for u, v in zip(t, j):
        _same(list(u), list(v))


def test_dataloader_argument_clashes_raise():
    ds = tdata.SimpleDataset(list(range(4)))
    with pytest.raises(MXNetError):
        tdata.DataLoader(ds)
    with pytest.raises(MXNetError):
        tdata.DataLoader(ds, 2, shuffle=True,
                         sampler=tdata.SequentialSampler(4))
    for kw in (dict(batch_size=2), dict(shuffle=True),
               dict(sampler=tdata.SequentialSampler(4)),
               dict(last_batch="keep")):
        with pytest.raises(MXNetError):
            tdata.DataLoader(ds, batch_sampler=[[0, 1]], **kw)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            tdata.DataLoader(ds, 2, pin_memory=True)
        with pytest.raises(MXNetError):
            next(iter(tdata.DataLoader(ds, 2, device=True)))


def _augment():
    return T.Compose([T.RandomResizedCrop(4), T.RandomFlipLeftRight(),
                      T.RandomColorJitter(0.4, 0.4, 0.4, 0.1),
                      T.RandomLighting(0.1), T.ToTensor()])


def _image_set(n=20):
    r = onp.random.RandomState(9)
    imgs = r.randint(0, 256, (n, 9, 7, 3)).astype("uint8")
    return tdata.ArrayDataset(imgs, onp.arange(n)).transform_first(_augment())


def test_threaded_loader_draws_per_batch():
    """Random transforms in worker threads: batch 0 equals the loader
    without workers from the same seeds, and a seed gives the same
    batches whatever the threads' timing."""
    ds = _image_set()

    def run(workers, seed):
        onp.random.seed(seed)
        __import__("random").seed(seed)
        return list(tdata.DataLoader(ds, 4, shuffle=True,
                                     num_workers=workers, prefetch=5))
    plain = run(0, 11)
    threaded = [run(4, 11) for _ in range(3)]
    _same(list(threaded[0][0]), list(plain[0]))
    for other in threaded[1:]:
        for u, v in zip(threaded[0], other):
            _same(list(u), list(v))
    # later batches draw from their own generators: a shuffled order
    # that every run repeats, and no two batches alike
    assert [b[1].tolist() for b in threaded[0]] == \
        [b[1].tolist() for b in plain]
    firsts = {float(b[0].flatten()[0]) for b in threaded[0]}
    assert len(firsts) == len(threaded[0])


_PY_DRAWS = """
import random, sys
import numpy as onp
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch.gluon import data as tdata
imgs = onp.random.RandomState(3).randint(0, 256, (16, 9, 7, 3))
ds = tdata.ArrayDataset(imgs.astype("uint8"), onp.arange(16)) \\
    .transform_first(timg.BrightnessJitterAug(0.5))
random.seed(5)
onp.random.seed(5)
batches = list(tdata.DataLoader(ds, 4, num_workers=3))
sys.stdout.write(" ".join(b[0].numpy().tobytes().hex() for b in batches))
"""


def test_threaded_loader_python_draws_repeat_across_processes():
    """An augmenter drawing from Python's generator (``py_random``) gives
    the same later batches in two processes from the same seeds: their
    generators are seeded from integers only."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [subprocess.run(
        [sys.executable, "-c", _PY_DRAWS], cwd=root, check=True,
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONHASHSEED=str(h))).stdout.split()
        for h in (1, 2)]
    assert len(outs[0]) == 4 and outs[0] == outs[1]
    assert len(set(outs[0])) == 4


class _Failing(tdata.Dataset):
    """Index 0 raises; every other read is recorded."""

    def __init__(self, n, delay=0.0):
        self.n, self.delay, self.read = n, delay, []
        self._mu = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == 0:
            raise KeyError("boom")
        time.sleep(self.delay)
        with self._mu:
            self.read.append(i)
        return onp.float32(i)


def _loader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("mxt-dataloader")]


def _wait_threads_gone(timeout=5.0):
    t0 = time.time()
    while _loader_threads() and time.time() - t0 < timeout:
        time.sleep(0.01)
    return not _loader_threads()


def test_failing_dataset_cancels_the_window():
    """Batch 0 fails: the error reaches the consumer, the batches still
    queued in the window never run and the pool's thread ends."""
    ds = _Failing(40, delay=0.05)
    loader = tdata.DataLoader(ds, 2, num_workers=1, prefetch=10)
    with pytest.raises(KeyError):
        list(loader)
    assert _wait_threads_gone()
    # at most the batch the one worker had started after batch 0
    assert set(ds.read) <= {1, 2, 3}


def test_break_mid_epoch_stops_the_workers():
    """A ``break`` after two batches: the pool's threads end and no
    batch beyond those in flight is read."""
    ds = _Failing(200, delay=0.01)
    loader = tdata.DataLoader(tdata.SimpleDataset(list(range(1, 200))), 4,
                              num_workers=2, prefetch=4,
                              batchify_fn=lambda s: [ds[i] for i in s])
    for n, _ in enumerate(loader):
        if n == 1:
            break
    assert _wait_threads_gone()
    # two batches consumed, the window of 4 and at most the ones running
    assert len(ds.read) <= 4 * (2 + 4 + 2)
    settled = len(ds.read)
    time.sleep(0.1)
    assert len(ds.read) == settled


@pytest.mark.parametrize("workers", [0, 2])
def test_prefetch_to_device_on_the_cpu(workers):
    x, y = _loader_data()
    t = tdata.DataLoader(tdata.ArrayDataset(x, y), 5, num_workers=workers,
                         device="cpu", prefetch_to_device=2)
    j = jdata.DataLoader(jdata.ArrayDataset(x, y), 5)
    for u, v in zip(t, j):
        _same(list(u), list(v))
    stats = t.device_prefetch_stats
    assert stats["prefetch_batches"] == 5 and stats["prefetch_depth"] == 2
    assert {"input_wait_ms", "starvation_count"} <= set(stats)
    for n, _ in enumerate(t):
        if n == 0:
            break
    assert _wait_threads_gone()


# ---------------------------------------------------------------- utils

@pytest.mark.parametrize("even", [True, False])
def test_split_data_and_load_match_jax(even):
    x = onp.random.RandomState(12).uniform(size=(10, 3)).astype("float32")
    n = 5 if even else 3
    t = tutils.split_data(torch.from_numpy(x), n, even_split=even)
    j = jutils.split_data(mx.nd.array(x), n, even_split=even)
    _same(t, j)
    loaded = tutils.split_and_load(x, [mxt.cpu(0)] * n, even_split=even)
    _same(loaded, j)
    assert all(s.device.type == "cpu" for s in loaded)
    _same(tutils.split_and_load(x, ["cpu"]), [x])
    y = onp.zeros((4, 6), "float32")
    _same(tutils.split_data(y, 3, batch_axis=1),
          jutils.split_data(mx.nd.array(y), 3, batch_axis=1))
    if even:
        with pytest.raises(MXNetError):
            tutils.split_data(x, 3)


def _grads(seed=13, scale=1.0):
    r = onp.random.RandomState(seed)
    return [(r.standard_normal(s) * scale).astype("float32")
            for s in ((7, 5), (5,), (3, 4, 2), (1,))]


@pytest.mark.parametrize("max_norm", [0.5, 2.0, 1e4])
def test_clip_global_norm_matches_jax(max_norm):
    arrs = _grads()
    t = [torch.from_numpy(a.copy()) for a in arrs]
    j = [mx.nd.array(a) for a in arrs]
    tt, jt = tutils.clip_global_norm(t, max_norm), \
        jutils.clip_global_norm(j, max_norm)
    assert isinstance(tt, float)
    assert abs(tt - jt) <= REL * jt
    for a, b, orig in zip(t, j, arrs):
        onp.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=REL,
                                    atol=0)
        if max_norm > tt:
            onp.testing.assert_array_equal(a.numpy(), orig)
    if max_norm < tt:
        clipped = onp.sqrt(sum(float((a.double() ** 2).sum()) for a in t))
        assert clipped <= max_norm * (1 + REL)


def test_clip_global_norm_non_finite():
    arrs = [torch.from_numpy(a) for a in _grads()]
    arrs[1][2] = float("nan")
    with pytest.raises(MXNetError, match="not finite"):
        tutils.clip_global_norm(arrs, 1.0)
    arrs[1][2] = float("inf")
    total = tutils.clip_global_norm(arrs, 1.0, check_isfinite=False)
    assert total == float("inf")
    assert tutils.clip_global_norm([], 1.0) == 0.0


def test_check_sha1_and_download(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"mxnet" * 100)
    digest = hashlib.sha1(src.read_bytes()).hexdigest()
    for fn in (tutils.check_sha1, jutils.check_sha1):
        assert fn(str(src), digest) and fn(str(src), digest[:8])
        assert not fn(str(src), "0" * 40)
    out = tmp_path / "out"
    out.mkdir()
    got = tutils.download("file://" + str(src), str(out), sha1_hash=digest)
    assert got == str(out / "src.bin")
    assert (out / "src.bin").read_bytes() == src.read_bytes()
    # an existing, matching destination is kept
    (out / "src.bin").write_bytes(src.read_bytes())
    assert tutils.download(str(src), str(out / "src.bin")) == \
        str(out / "src.bin")
    with pytest.raises(MXNetError, match="sha1"):
        tutils.download(str(src), str(tmp_path / "x.bin"),
                        sha1_hash="0" * 40, retries=1)
    assert not any(p.name.startswith("x.bin") for p in tmp_path.iterdir())
    with pytest.raises(MXNetError, match="file://"):
        tutils.download("https://example.invalid/a.bin",
                        str(tmp_path / "a.bin"), retries=1)


# ---------------------------------------------------------------- the slice

#: the ResNet's and the LM's losses and weights: tests/test_torch_vision.py's
#: and tests/test_torch_rnn.py's MODEL_TOL through a whole model
MODEL_TOL = 2e-5
REC_SHAPE = (3, 48, 64)


def _write_records(path, n, png=False):
    from mxnet_tpu_torch import recordio as trio
    r = onp.random.RandomState(21)
    w = trio.MXIndexedRecordIO(str(path.with_suffix(".idx")), str(path), "w")
    for i in range(n):
        img = r.randint(0, 256, REC_SHAPE).astype("uint8")
        head = trio.IRHeader(0, float(r.randint(0, 10)), i, 0)
        w.write_idx(i, trio.pack_img(head, img.transpose(1, 2, 0),
                                     img_fmt=".png") if png
                    else trio.pack(head, img.tobytes()))
    w.close()


def _record_loader(pkg, path, png):
    """The record pipeline in package ``pkg`` ("t" the port, "j" the
    JAX package), at 32 x 32."""
    if pkg == "t":
        from mxnet_tpu_torch import image, recordio
        from mxnet_tpu_torch.gluon import data
        M, wrap = T, lambda a: a
    else:
        from mxnet_tpu import image, recordio
        from mxnet_tpu.gluon import data
        from mxnet_tpu.gluon.data.vision import transforms as M
        wrap = mx.nd.array       # the JAX transforms take NDArrays

    def decode(rec):
        head, payload = recordio.unpack(rec)
        return wrap(image.imdecode_or_raw(payload, REC_SHAPE)), head.label

    ds = data.vision.ImageRecordDataset(str(path)) if png else \
        data.RecordFileDataset(str(path)).transform(decode)
    chain = M.Compose([M.RandomResizedCrop(32), M.RandomFlipLeftRight(),
                       M.RandomColorJitter(0.4, 0.4, 0.4),
                       M.RandomLighting(0.1), M.ToTensor(),
                       M.Normalize((0.485, 0.456, 0.406),
                                   (0.229, 0.224, 0.225))])
    return data.DataLoader(ds.transform_first(chain), batch_size=4,
                           shuffle=True, last_batch="discard")


def _resnet_weights(tnet, seed=11):
    r = onp.random.RandomState(seed)
    out = {}
    for k, p in tnet.named_parameters():
        shape = tuple(p.shape)
        if k.endswith(("gamma", "running_var")):
            v = r.uniform(0.8, 1.2, shape)
        elif k.endswith(("beta", "running_mean", "bias")):
            v = r.uniform(-0.1, 0.1, shape)
        else:
            fan_in = int(onp.prod(shape[1:]))
            v = r.randn(*shape) * onp.sqrt((2.0 if len(shape) > 2 else 1.0)
                                           / fan_in)
        out[k] = v.astype("f4")
    return out


@pytest.mark.parametrize("png", [False, True], ids=["raw", "png"])
def test_record_pipeline_trains_a_resnet_as_jax(tmp_path, png):
    """Records → the 32 x 32 transform chain → DataLoader → three SGD
    steps (momentum 0.9) of resnet18_v1 (thumbnail, 10 classes) in each
    package, weights through ``load_jax_params``: the batches bit-equal,
    then both nets in float64 (the batches cast), losses and weights
    within MODEL_TOL (measured 6e-8 on the CPU). In float32 either
    package parts from its float64 run by ~2e-4 of the loss at the
    second step here (BatchNorm over 4 images at 4 x 4 pixels in the
    last stage amplifies rounding), so float32 is no reference."""
    if png:
        pytest.importorskip("PIL")
    import jax
    from mxnet_tpu import autograd as jautograd
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JSCE
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon import Trainer as TTrainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss as TSCE
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    from mxnet_tpu_torch.gluon.params import load_jax_params

    path = tmp_path / "train.rec"
    _write_records(path, 13, png)
    _seed_all(5)
    tb = list(_record_loader("t", path, png))
    _seed_all(5)
    jb = list(_record_loader("j", path, png))
    assert len(tb) == len(jb) == 3
    for u, v in zip(tb, jb):
        _same(list(u), list(v))
        assert u[0].shape == (4, 3, 32, 32) and u[0].dtype == torch.float32

    kw = dict(classes=10, thumbnail=True)
    sgd = {"learning_rate": 0.01, "momentum": 0.9}
    tnet = tvision.get_model("resnet18_v1", device="cpu", **kw)
    params = _resnet_weights(tnet)
    load_jax_params(tnet, params)
    tnet.double()
    ttr = TTrainer(dict(tnet.named_parameters()), "sgd", dict(sgd))
    tloss = TSCE()
    tl = []
    for x, y in tb:
        x, y = x.double(), y.double()
        loss = tloss(tnet(x), y)
        loss.sum().backward()
        ttr.step(x.shape[0])
        tl.append(loss.detach().numpy())
    with jax.enable_x64(True):
        jnet = jvision.get_model("resnet18_v1", **kw)
        jnet.initialize()
        jnet(mx.nd.zeros((4, 3, 32, 32)))
        jnet.cast("float64")
        for k, p in jnet.collect_params().items():
            p.set_data(mx.nd.array(params[k]).astype("float64"))
        jtr = JTrainer(jnet.collect_params(), "sgd", dict(sgd))
        jloss = JSCE()
        jl = []
        for x, y in jb:
            x, y = x.astype("float64"), y.astype("float64")
            with jautograd.record():
                loss = jloss(jnet(x), y)
            loss.backward()
            jtr.step(x.shape[0])
            jl.append(loss.asnumpy())
        jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    for a, b in zip(tl, jl):
        onp.testing.assert_allclose(a, b, rtol=MODEL_TOL, atol=MODEL_TOL)
    for k, p in tnet.named_parameters():
        onp.testing.assert_allclose(p.detach().numpy(), jp[k],
                                    rtol=MODEL_TOL, atol=MODEL_TOL,
                                    err_msg=k)


def _seed_all(s):
    import random
    random.seed(s)
    onp.random.seed(s)


class _Windows:
    """``bptt``-long (data, target) windows of a token stream (the word
    LM example's batchified corpus, one window a sample)."""

    def __init__(self, stream, bptt):
        self.stream, self.bptt = stream, bptt

    def __len__(self):
        return (len(self.stream) - 1) // self.bptt

    def __getitem__(self, i):
        s = self.stream[i * self.bptt:(i + 1) * self.bptt + 1]
        return s[:-1], s[1:]


def test_word_lm_with_interval_sampler_and_clipping_as_jax(monkeypatch):
    """The word LM example's loop at a narrow width (vocab 64, embed 16,
    hidden 32, 2 layers, batch 4, bptt 6): DataLoader over windows with
    ``IntervalSampler``, backward, ``clip_global_norm``, SGD
    ``step(1)``, against the JAX example's WordLM and loop: batches
    equal, each step's norm, the losses and the weights within
    MODEL_TOL, and the clip taken on some steps and not on others."""
    import importlib.util
    import os
    from mxnet_tpu import autograd as jautograd
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu_torch.gluon import Trainer as TTrainer
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import WordLM
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    monkeypatch.setenv("MXNET_PALLAS", "on")
    vocab, embed, hidden, layers, batch, bptt = 64, 16, 32, 2, 4, 6
    stream = onp.random.RandomState(31).randint(
        0, vocab, batch * bptt * 5 + 1).astype("int32")
    nwin = (len(stream) - 1) // bptt
    nbatch = nwin // batch

    def loader(data):
        return data.DataLoader(data.SimpleDataset(_Windows(stream, bptt)),
                               batch_size=batch, last_batch="discard",
                               sampler=data.IntervalSampler(nwin, nbatch))
    tb, jb = list(loader(tdata)), list(loader(jdata))
    assert len(tb) == len(jb) == 5
    for u, v in zip(tb, jb):
        _same(list(u), list(v))
    # row b of batch k continues row b of batch k - 1
    onp.testing.assert_array_equal(tb[1][0][:, 0].numpy(),
                                   tb[0][1][:, -1].numpy())

    tnet = WordLM(vocab, embed, hidden, layers, device="cpu")
    params = init_params_numpy(tnet, 13)
    load_jax_params(tnet, params)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "train_lstm_lm", os.path.join(root, "examples", "train_lstm_lm.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    jnet = ex.WordLM(vocab, embed, hidden, layers)
    jnet.initialize()
    jnet(tb[0][0].numpy())
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    sgd = {"learning_rate": 1.0}
    ttr = TTrainer(dict(tnet.named_parameters()), "sgd", dict(sgd))
    jtr = JTrainer(jnet.collect_params(), "sgd", dict(sgd))
    tl_fn, jl_fn = tloss.SoftmaxCrossEntropyLoss(), \
        jloss.SoftmaxCrossEntropyLoss()
    # between the steps' norms (0.76-0.92 unclipped): some steps clip
    max_norm = 0.85
    totals = []
    for (tx, ty), (jx, jy) in zip(tb, jb):
        tloss_v = tl_fn(tnet(tx), ty)
        tloss_v.sum().backward()
        tt = tutils.clip_global_norm(
            [p.grad for p in tnet.parameters()], max_norm)
        ttr.step(1)
        with jautograd.record():
            jloss_v = jl_fn(jnet(jx), jy)
        jloss_v.backward()
        jt = jutils.clip_global_norm(
            [p.grad() for p in jnet.collect_params().values()], max_norm)
        jtr.step(1)
        onp.testing.assert_allclose(tloss_v.detach().numpy(),
                                    jloss_v.asnumpy(), rtol=MODEL_TOL,
                                    atol=MODEL_TOL)
        assert abs(tt - jt) <= MODEL_TOL * jt
        totals.append(tt)
    assert min(totals) < max_norm < max(totals), totals
    tparams = dict(tnet.named_parameters())
    for k, p in jnet.collect_params().items():
        onp.testing.assert_allclose(tparams[k].detach().numpy(),
                                    p.data().asnumpy(), rtol=MODEL_TOL,
                                    atol=MODEL_TOL, err_msg=k)
