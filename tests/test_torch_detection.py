"""The port's detection path against the JAX package on the CPU: the box
ops of ``ndarray/contrib.py``, the detection augmenters and
``ImageDetIter`` of ``image/detection.py``, the SSD-ResNet50 model and
loss of ``chip_smoke.py`` against ``bench.py``'s, and
``model_zoo.get_model``.

The same numpy-seeded inputs go through both packages. Tolerances:
- box ops: integer outputs, class ids, masks and the kept / suppressed
  pattern exact; coordinates, IoUs, scores and pooled values within
  BOX_ATOL (1e-6); encoded box targets within BOX_ATOL + BOX_ATOL x
  |target| (log and divisions by the variances, up to ~10 in size);
- augmenters and ``ImageDetIter``: boxes and pixels bit-equal (the same
  numpy operations and the same draws, Python's global ``random`` on the
  JAX side and a ``random.Random`` of the same seed on the port's),
  except after a bilinear resize: within RESIZE_ATOL (2e-3 on 0-255,
  ``F.interpolate`` with ``antialias=True`` against
  ``jax.image.resize``, as ``tests/test_torch_image.py``);
- the SSD model at ``bench.py``'s CPU shape (2 x 3 x 64 x 64): anchors,
  class scores and box predictions within MODEL_TOL (2e-5), one step's
  loss within MODEL_TOL, its gradients within 1e-6 + 1e-3 x each
  parameter's largest (chip_smoke's gradient bound).
"""
import importlib.util
import os
import random

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd

from mxnet_tpu_torch.ndarray import contrib as tc

BOX_ATOL = 1e-6
RESIZE_ATOL = 2e-3
MODEL_TOL = 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _boxes(rs, shape, lo=0.0, hi=0.7, wmin=0.05, wmax=0.35):
    """Random corner boxes (..., 4) inside the unit square."""
    xy = rs.uniform(lo, hi, shape + (2,))
    wh = rs.uniform(wmin, wmax, shape + (2,))
    return onp.concatenate([xy, xy + wh], -1).astype("float32")


def _center(b):
    return onp.concatenate([(b[..., :2] + b[..., 2:]) / 2,
                            b[..., 2:] - b[..., :2]], -1).astype("float32")


# ---- box_iou

@pytest.mark.parametrize("fmt", ["corner", "center"])
@pytest.mark.parametrize("batch", [(), (3,)], ids=["2d", "3d"])
def test_box_iou_matches_jax(fmt, batch):
    rs = onp.random.RandomState(0)
    a, b = _boxes(rs, batch + (7,)), _boxes(rs, batch + (5,))
    a[..., 0, :] = b[..., 0, :]               # one IoU of exactly 1
    a[..., 1, 2:] = a[..., 1, :2]             # an empty box: IoU 0
    if fmt == "center":
        a, b = _center(a), _center(b)
    got = tc.box_iou(_t(a), _t(b), format=fmt)
    ref = jnd.contrib.box_iou(jnd.array(a), jnd.array(b), format=fmt)
    assert got.shape == batch + (7, 5)
    onp.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=BOX_ATOL)


# ---- box_nms

def _nms_rows(rs, shape, classes=3, ties=True):
    """Rows [id, score, x1, y1, x2, y2] of heavily overlapping boxes, some
    scores below the valid threshold and, with ``ties``, tied scores."""
    boxes = _boxes(rs, shape, lo=0.2, hi=0.4, wmin=0.2, wmax=0.4)
    ids = rs.randint(0, classes, shape).astype("float32")
    scores = rs.uniform(0, 1, shape).astype("float32")
    if ties:
        flat = scores.reshape(-1)
        flat[1::3] = flat[0::3][:len(flat[1::3])]  # pairs of equal scores
        flat[2] = flat[0]
    return onp.concatenate([ids[..., None], scores[..., None], boxes], -1)


NMS_CASES = {
    "plain": {},
    "topk": dict(topk=5),
    "force_suppress": dict(force_suppress=True, id_index=0),
    "by_class": dict(id_index=0),
    "no_class": dict(id_index=-1),
    "center_in_corner_out": dict(in_format="center", out_format="corner"),
    "corner_in_center_out": dict(in_format="corner", out_format="center",
                                 id_index=0),
    "valid_thresh": dict(valid_thresh=0.4, overlap_thresh=0.3),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
@pytest.mark.parametrize("shape", [(17,), (3, 17)], ids=["2d", "3d"])
def test_box_nms_matches_jax(case, shape):
    kw = NMS_CASES[case]
    x = _nms_rows(onp.random.RandomState(1), shape)
    if kw.get("in_format") == "center":
        x[..., 2:6] = _center(x[..., 2:6])
    got = tc.box_nms(_t(x), **kw)
    ref = _np(jnd.contrib.box_nms(jnd.array(x), **kw))
    got = _np(got)
    assert got.shape == x.shape
    # the same rows kept, in the same order, with the same ids and scores
    onp.testing.assert_array_equal(got[..., 0] < 0, ref[..., 0] < 0)
    onp.testing.assert_array_equal(got[..., :2], ref[..., :2])
    onp.testing.assert_allclose(got, ref, rtol=0, atol=BOX_ATOL)
    assert (got[..., 0] >= 0).any() and (got[..., 0] < 0).any()


def test_box_nms_keeps_the_earlier_of_tied_scores():
    # two identical boxes with equal scores: the stable sort keeps the
    # first row, as the JAX argsort does
    x = onp.array([[0, 0.5, 0.1, 0.1, 0.5, 0.5],
                   [0, 0.5, 0.1, 0.1, 0.5, 0.5],
                   [0, 0.9, 0.6, 0.6, 0.9, 0.9]], "float32")
    x[1, 0] = 1                       # tell the rows apart by their id
    got = _np(tc.box_nms(_t(x), force_suppress=True))
    ref = _np(jnd.contrib.box_nms(jnd.array(x), force_suppress=True))
    onp.testing.assert_array_equal(got, ref)
    assert got[1, 0] == 0 and (got[2] == -1).all()


# ---- ROIAlign

ROI_CASES = {
    "plain": dict(pooled_size=(3, 2), spatial_scale=0.5, sample_ratio=2),
    "square": dict(pooled_size=2, spatial_scale=1.0, sample_ratio=1),
    "adaptive": dict(pooled_size=(2, 3), spatial_scale=0.5,
                     sample_ratio=0),
    "position_sensitive": dict(pooled_size=(2, 2), spatial_scale=0.5,
                               sample_ratio=2, position_sensitive=True),
}


@pytest.mark.parametrize("case", sorted(ROI_CASES))
def test_roi_align_matches_jax(case):
    kw = ROI_CASES[case]
    rs = onp.random.RandomState(2)
    x = rs.standard_normal((2, 8, 9, 11)).astype("float32")
    rois = onp.array([[0, 1.0, 2.0, 12.0, 15.0],
                      [1, -4.0, -3.0, 6.0, 5.0],      # partly outside
                      [1, 18.0, 14.0, 30.0, 26.0],    # past the image
                      [-1, 2.0, 2.0, 8.0, 8.0],       # padding ROI
                      [0, 3.3, 4.7, 3.9, 5.1],        # under one pixel
                      [1, 0.0, 0.0, 21.0, 17.0]], "float32")
    got = tc.ROIAlign(_t(x), _t(rois), **kw)
    ref = _np(jnd.contrib.ROIAlign(jnd.array(x), jnd.array(rois), **kw))
    assert got.shape == ref.shape
    onp.testing.assert_allclose(_np(got), ref, rtol=0, atol=BOX_ATOL)
    assert (_np(got)[3] == 0).all()


def test_roi_align_position_sensitive_needs_divisible_channels():
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError):
        tc.ROIAlign(torch.zeros(1, 6, 4, 4), torch.zeros(1, 5), (2, 2),
                    1.0, position_sensitive=True)


# ---- MultiBoxPrior

PRIOR_CASES = {
    "ssd_scale0": dict(sizes=(0.2, 0.272), ratios=(1.0, 2.0, 0.5)),
    "clip": dict(sizes=(0.54, 0.619, 0.9), ratios=(1.0, 3.0), clip=True),
    "steps": dict(sizes=(0.3,), ratios=(1.0, 2.0, 0.5, 1 / 3),
                  steps=(0.1, 0.125), offsets=(0.25, 0.75)),
    "steps_clip": dict(sizes=0.5, ratios=2.0, steps=(0.2, 0.2), clip=True),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
@pytest.mark.parametrize("hw", [(10, 10), (3, 5)], ids=str)
def test_multibox_prior_matches_jax(case, hw):
    kw = PRIOR_CASES[case]
    x = onp.zeros((2, 4) + hw, "float32")
    got = tc.MultiBoxPrior(_t(x), **kw)
    ref = _np(jnd.contrib.MultiBoxPrior(jnd.array(x), **kw))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # float32 operations in the same order: bit-equal
    onp.testing.assert_array_equal(_np(got), ref)


def test_multibox_prior_is_float32_for_a_bf16_map():
    x = torch.zeros(1, 2, 5, 5, dtype=torch.bfloat16)
    got = tc.MultiBoxPrior(x, sizes=(0.37, 0.447), ratios=(1.0, 2.0, 0.5))
    ref = tc.MultiBoxPrior(x.float(), sizes=(0.37, 0.447),
                           ratios=(1.0, 2.0, 0.5))
    assert got.dtype == torch.float32 and torch.equal(got, ref)


# ---- MultiBoxTarget

def _target_inputs(seed, b=3, m=4, classes=5, hw=(6, 6)):
    """Anchors of two SSD scales, labels with padding rows and a planted
    duplicate best anchor (two valid ground truths with the same box in
    image 0, the second of another class), class predictions."""
    rs = onp.random.RandomState(seed)
    anc = onp.concatenate([
        _np(tc.MultiBoxPrior(torch.zeros((1, 1) + hw),
                             sizes=(0.2, 0.272), ratios=(1.0, 2.0, 0.5))),
        _np(tc.MultiBoxPrior(torch.zeros(1, 1, 3, 3),
                             sizes=(0.37, 0.447), ratios=(1.0, 2.0, 0.5)))],
        1)
    n = anc.shape[1]
    lab = onp.full((b, m, 5), -1.0, "float32")
    for i in range(b):
        k = 1 + i % m                            # 1..m valid rows
        lab[i, :k, 0] = rs.randint(0, classes, k)
        lab[i, :k, 1:] = _boxes(rs, (k,), hi=0.6, wmin=0.1, wmax=0.4)
    lab[0, 1] = lab[0, 0]
    lab[0, 1, 0] = (lab[0, 0, 0] + 1) % classes
    lab[1, 2:, 1:] = lab[1, 0, 1:]               # padding over a real box
    cp = rs.standard_normal((b, classes + 1, n)).astype("float32")
    return anc, lab, cp


TARGET_CASES = {
    "bench": {},
    "mining": dict(negative_mining_ratio=3.0),
    "mining_min_neg": dict(negative_mining_ratio=3.0,
                           minimum_negative_samples=40,
                           negative_mining_thresh=0.4, ignore_label=-2.0),
    "threshold": dict(overlap_threshold=0.3, variances=(0.1, 0.2, 0.3, 0.4)),
}


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_multibox_target_matches_jax(case):
    kw = TARGET_CASES[case]
    anc, lab, cp = _target_inputs(3)
    got = [_np(t) for t in tc.MultiBoxTarget(_t(anc), _t(lab), _t(cp), **kw)]
    ref = [_np(t) for t in jnd.contrib.MultiBoxTarget(
        jnd.array(anc), jnd.array(lab), jnd.array(cp), **kw)]
    bt, mask, cls = got
    assert bt.shape == mask.shape == (3, anc.shape[1] * 4)
    onp.testing.assert_array_equal(cls, ref[2])
    onp.testing.assert_array_equal(mask, ref[1])
    onp.testing.assert_allclose(bt, ref[0], rtol=BOX_ATOL, atol=BOX_ATOL)
    if "negative_mining_ratio" in kw:
        assert (cls == kw.get("ignore_label", -1.0)).any()


def test_multibox_target_duplicate_best_anchor_takes_the_later_truth():
    anc, lab, cp = _target_inputs(3)
    cls = _np(tc.MultiBoxTarget(_t(anc), _t(lab), _t(cp))[2])
    iou = _np(tc.box_iou(_t(anc[0]), _t(lab[0, :2, 1:])))
    best = int(iou[:, 0].argmax())
    assert best == int(iou[:, 1].argmax())
    # the anchor both truths claim carries the second one's class
    assert cls[0, best] == lab[0, 1, 0] + 1


# ---- MultiBoxDetection

@pytest.mark.parametrize("kw", [dict(), dict(nms_topk=6, clip=False),
                                dict(force_suppress=True,
                                     nms_threshold=0.3, threshold=0.2),
                                dict(background_id=2)], ids=str)
def test_multibox_detection_matches_jax(kw):
    rs = onp.random.RandomState(4)
    anc = _np(tc.MultiBoxPrior(torch.zeros(1, 1, 4, 4), sizes=(0.3, 0.4),
                               ratios=(1.0, 2.0)))
    n = anc.shape[1]
    logits = rs.standard_normal((2, 4, n)).astype("float32") * 2
    prob = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    prob = prob.astype("float32")
    loc = (rs.standard_normal((2, n * 4)) * 0.5).astype("float32")
    got = _np(tc.MultiBoxDetection(_t(prob), _t(loc), _t(anc), **kw))
    ref = _np(jnd.contrib.MultiBoxDetection(
        jnd.array(prob), jnd.array(loc), jnd.array(anc), **kw))
    assert got.shape == (2, n, 6)
    onp.testing.assert_array_equal(got[..., :2] < 0, ref[..., :2] < 0)
    onp.testing.assert_array_equal(got[..., 0], ref[..., 0])
    onp.testing.assert_allclose(got, ref, rtol=0, atol=BOX_ATOL)
    assert (got[..., 0] >= 0).any()


def test_multibox_detection_widens_bf16_boxes_as_jax_does():
    anc = tc.MultiBoxPrior(torch.zeros(1, 1, 3, 3), sizes=(0.3,),
                           ratios=(1.0,))
    n = anc.shape[1]
    prob = torch.full((1, 2, n), 0.5)
    loc = torch.linspace(-1, 1, n * 4).reshape(1, -1)
    got = tc.MultiBoxDetection(prob, loc.bfloat16(), anc)
    ref = tc.MultiBoxDetection(prob, loc.bfloat16().float(), anc)
    assert got.dtype == torch.float32 and torch.equal(got, ref)


def test_box_ops_run_through_the_funnel():
    from mxnet_tpu_torch.ops import registry
    seen = []

    def spy(name, fn):
        seen.append(name)
        return fn

    anc, lab, cp = _target_inputs(5, b=2)
    registry.add_invoke_wrapper(spy)
    try:
        tc.box_iou(_t(anc[0]), _t(anc[0]))
        tc.ROIAlign(torch.zeros(1, 1, 4, 4), torch.zeros(1, 5), 2, 1.0)
        tc.MultiBoxPrior(torch.zeros(1, 1, 2, 2))
        tc.MultiBoxTarget(_t(anc), _t(lab), _t(cp))
        tc.MultiBoxDetection(torch.softmax(_t(cp), 1), torch.zeros(
            2, anc.shape[1] * 4), _t(anc))
    finally:
        registry.remove_invoke_wrapper(spy)
    assert seen == ["box_iou", "ROIAlign", "MultiBoxPrior", "MultiBoxTarget",
                    "MultiBoxDetection_decode", "box_nms"]


# ---- augmenters

def _det_label(rs, n):
    lab = onp.zeros((n, 6), "float32")
    lab[:, 0] = rs.randint(0, 20, n)
    lab[:, 1:5] = _boxes(rs, (n,), hi=0.6, wmin=0.15, wmax=0.4)
    lab[:, 5] = rs.uniform(0, 1, n)               # an extra field rides
    return lab


def _det_image(rs, h=24, w=32):
    return rs.randint(0, 256, (h, w, 3)).astype("uint8")


def _aug_pair(name, kw):
    """The JAX augmenter and the port's, built alike; the port's draws
    from ``rng``."""
    from mxnet_tpu.image import detection as jdet
    from mxnet_tpu_torch.image import detection as tdet

    def make(mod, rng=None):
        extra = {} if rng is None else {"rng": rng}
        if name == "select":
            return mod.DetRandomSelectAug(
                [mod.DetHorizontalFlipAug(1.0, **extra),
                 mod.DetRandomPadAug(**kw, **extra)], skip_prob=0.3, **extra)
        return getattr(mod, name)(**kw, **extra)
    return (lambda: make(jdet)), (lambda rng: make(tdet, rng))


AUG_CASES = {
    "flip": ("DetHorizontalFlipAug", dict(p=0.5)),
    "crop": ("DetRandomCropAug", dict(min_object_covered=0.3,
                                      area_range=(0.1, 1.0))),
    "crop_tight": ("DetRandomCropAug", dict(min_object_covered=0.9,
                                            aspect_ratio_range=0.5,
                                            max_attempts=5)),
    "pad": ("DetRandomPadAug", dict(area_range=(1.0, 2.5),
                                    pad_val=(1, 2, 3))),
    "multi_crop": ("CreateMultiRandCropAugmenter",
                   dict(min_object_covered=[0.1, 0.5, 0.7],
                        aspect_ratio_range=[(0.5, 2.0)],
                        area_range=[(0.1, 1.0), (0.3, 1.0)],
                        skip_prob=0.2)),
    "select": ("select", dict(area_range=(1.0, 2.0))),
}


@pytest.mark.parametrize("case", sorted(AUG_CASES))
def test_det_augmenters_match_jax_under_one_seed(case):
    jmake, tmake = _aug_pair(*AUG_CASES[case])
    rs = onp.random.RandomState(6)
    changed = 0
    for seed in range(6):
        img, lab = _det_image(rs), _det_label(rs, 1 + seed % 3)
        random.seed(seed)
        jimg, jlab = jmake()(mx.nd.array(img), lab.copy())
        timg, tlab = tmake(random.Random(seed))(torch.from_numpy(img),
                                               lab.copy())
        onp.testing.assert_array_equal(_np(timg), _np(jimg))
        onp.testing.assert_array_equal(tlab, jlab)
        changed += _np(timg).shape != img.shape or \
            not onp.array_equal(_np(timg), img)
    assert changed > 0


def _write_records(path, samples, data_shape):
    """Raw uint8 CHW payloads of ``data_shape`` with flat-form labels
    ``[2, width, objects...]``."""
    from mxnet_tpu_torch import recordio
    w = recordio.MXRecordIO(path, "w")
    for i, (lab, img) in enumerate(samples):
        flat = onp.concatenate([[2, lab.shape[1]], lab.ravel()]) \
            .astype("float32")
        w.write(recordio.pack(recordio.IRHeader(0, flat, i, 0),
                              img.transpose(2, 0, 1).tobytes()))
    w.close()


def _det_iters(source, tmp_path, n=7, batch=3, **kw):
    """(JAX ImageDetIter, port's ImageDetIter) over the same ``n``
    samples; labels of 1-3 objects."""
    from mxnet_tpu.image import ImageDetIter as JIter
    from mxnet_tpu_torch.image import ImageDetIter as TIter
    rs = onp.random.RandomState(8)
    shape = (3, 20, 28)
    samples = [(_det_label(rs, 1 + i % 3), _det_image(rs, 20, 28))
               for i in range(n)]
    if source == "imglist":
        src = dict(imglist=samples)
    elif source == "flat":
        src = dict(imglist=[(onp.concatenate(
            [[4, 6, 7, 9], l.ravel(), -onp.ones(6)]), im)
            for l, im in samples])
    else:
        path = str(tmp_path / "det.rec")
        _write_records(path, samples, shape)
        src = dict(path_imgrec=path)
    seed = kw.pop("seed", 11)
    random.seed(seed)
    jit = JIter(batch, shape, **src, **kw)
    tit = TIter(batch, shape, **src, rng=random.Random(seed), **kw)
    return jit, tit


def _drain(it):
    out = []
    for b in it:
        out.append((_np(b.data[0]), _np(b.label[0]), b.pad))
    return out


ITER_KW = dict(rand_crop=0.7, rand_pad=0.6, rand_mirror=True,
               shuffle=True, area_range=(0.2, 2.0), mean=True, std=True)


@pytest.mark.parametrize("source", ["imglist", "flat", "recordio"])
@pytest.mark.parametrize("interp", [0, 2])
def test_image_det_iter_matches_jax(source, interp, tmp_path):
    jit, tit = _det_iters(source, tmp_path, inter_method=interp, **ITER_KW)
    assert tit.label_shape == jit.label_shape == (3, 6)
    assert tit.provide_data == jit.provide_data
    assert tit.provide_label == jit.provide_label
    for _ in range(2):                      # two passes, reshuffled
        got, ref = _drain(tit), _drain(jit)
        assert len(got) == len(ref) == 3
        for (gd, gl, gp), (rd, rl, rp) in zip(got, ref):
            assert gd.shape == (3, 3, 20, 28) and gl.shape == (3, 3, 6)
            assert gp == rp
            onp.testing.assert_array_equal(gl, rl)
            if interp == 0:
                onp.testing.assert_array_equal(gd, rd)
            else:                           # 0-255 scale: RESIZE_ATOL / std
                onp.testing.assert_allclose(gd, rd, rtol=0,
                                            atol=RESIZE_ATOL / 57.12)
        tit.reset()
        jit.reset()


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_image_det_iter_last_batch_handle(handle, tmp_path):
    jit, tit = _det_iters("imglist", tmp_path, n=7, batch=3,
                          last_batch_handle=handle, inter_method=0,
                          shuffle=True, rand_mirror=True)
    pads = []
    for _ in range(3):
        got, ref = _drain(tit), _drain(jit)
        assert len(got) == len(ref)
        for (gd, gl, gp), (rd, rl, rp) in zip(got, ref):
            onp.testing.assert_array_equal(gd, rd)
            onp.testing.assert_array_equal(gl, rl)
            assert gp == rp
        pads.append([p for _, _, p in got])
        tit.reset()
        jit.reset()
    expect = {"pad": [[0, 0, 2]] * 3, "discard": [[0, 0]] * 3,
              "roll_over": [[0, 0], [0, 0], [0, 0, 0]]}[handle]
    assert pads == expect


def test_image_det_iter_label_shape_and_errors(tmp_path):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.image import ImageDetIter as TIter
    jit, tit = _det_iters("imglist", tmp_path, label_shape=(5, 7),
                          inter_method=0)
    got, ref = _drain(tit), _drain(jit)
    for (gd, gl, _), (rd, rl, _) in zip(got, ref):
        assert gl.shape == (3, 5, 7)
        onp.testing.assert_array_equal(gl, rl)
    other = TIter(2, (3, 8, 8), imglist=[(onp.zeros((6, 5)),
                                          onp.zeros((8, 8, 3), "uint8"))])
    tit.sync_label_shape(other)
    assert other.label_shape == tit.label_shape == (6, 7)
    with pytest.raises(MXNetError):
        TIter(2, (3, 8, 8))
    with pytest.raises(MXNetError):
        TIter(2, (3, 8, 8), imglist=[(onp.zeros((1, 4)),
                                      onp.zeros((8, 8, 3)))])
    with pytest.raises(MXNetError):
        TIter(2, (3, 8, 8), imglist=[(onp.zeros((1, 5)),
                                      onp.zeros((8, 8, 3)))],
              last_batch_handle="keep")


# ---- the SSD

def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@pytest.fixture(scope="module")
def ssd_pair():
    """chip_smoke's SSD and bench.py's, phase 22's seeded weights in both
    (each residual block's last gamma 0), and bench's CPU batch."""
    import chip_smoke as cs
    from mxnet_tpu_torch.gluon.params import load_jax_params
    jnet = _load_bench()._SSDResNet50.build()
    tnet = cs.ssd_resnet50(torch, "cpu")
    init = cs.resnet_init(onp, tnet, seed=24)
    load_jax_params(tnet, init)
    for k, p in jnet.collect_params().items():   # no deferred shapes left
        p.set_data(mx.nd.array(init[k]))
    x, lab = cs.ssd_batch(onp, onp.random.RandomState(25), 2, 64)
    return cs, jnet, tnet, x, lab


def _bench_value_and_grad(jnet, x, lab):
    """bench_ssd's loss_fn (bench.py:618-636) and its value_and_grad."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import _tape
    from mxnet_tpu.ndarray.ndarray import NDArray
    from __graft_entry__ import _functional_apply
    items = [(k, p) for k, p in jnet.collect_params().items()
             if p._data is not None]
    params = [p for _, p in items]
    apply_fn = _functional_apply(jnet, params, train=True, with_state=True)

    def loss_fn(pd, x, labels):
        (anchors, cls, loc), state = apply_fn(pd, x, jax.random.PRNGKey(0))
        prev = _tape.set_recording(False)
        try:
            loc_t, loc_mask, cls_t = jnd.contrib.MultiBoxTarget(
                NDArray(jax.lax.stop_gradient(anchors)), NDArray(labels),
                NDArray(jax.lax.stop_gradient(cls).transpose((0, 2, 1))))
            ce = jnd.softmax_cross_entropy(
                NDArray(cls.reshape((-1, cls.shape[-1]))),
                NDArray(cls_t._data.reshape((-1,))))
            l1 = jnd.abs(NDArray(loc) * loc_mask - loc_t * loc_mask)
        finally:
            _tape.set_recording(prev)
        l = ce._data / cls.shape[0] / cls.shape[1] + jnp.mean(l1._data)
        return l, (anchors, cls, loc)

    pd = tuple(jnp.asarray(p._data._data) for p in params)
    (loss, outs), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(pd, jnp.asarray(x), jnp.asarray(lab))
    return float(loss), [onp.asarray(o) for o in outs], \
        {k: onp.asarray(g) for (k, _), g in zip(items, grads)}


def test_ssd_model_and_loss_match_bench(ssd_pair):
    cs, jnet, tnet, x, lab = ssd_pair
    names = [n for n, _ in tnet.named_parameters()]
    assert names == list(jnet.collect_params())
    ref_loss, ref_out, ref_grads = _bench_value_and_grad(jnet, x, lab)
    tnet.train()
    out = tnet(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [o.shape for o in ref_out] \
        == [(1, 24, 4), (2, 24, 21), (2, 96)]
    onp.testing.assert_array_equal(_np(out[0]), ref_out[0])
    for got, ref in zip(out[1:], ref_out[1:]):
        onp.testing.assert_allclose(_np(got), ref, rtol=MODEL_TOL,
                                    atol=MODEL_TOL)
    per_image = cs.ssd_loss(torch)(out, torch.from_numpy(lab))
    assert per_image.shape == (2,)
    onp.testing.assert_allclose(float(per_image.detach().mean()), ref_loss,
                                rtol=MODEL_TOL, atol=MODEL_TOL)
    # compile_step's gradient: the sum's, rescaled by 1 / batch
    (per_image.sum() / 2).backward()
    worst = {}
    for n, p in tnet.named_parameters():
        if not p.requires_grad:
            continue
        ref = ref_grads[n]
        err = onp.abs(_np(p.grad) - ref).max()
        worst[n] = err / (1e-6 + 1e-3 * onp.abs(ref).max())
    assert len(worst) == 175
    assert max(worst.values()) <= 1.0, sorted(worst.items(),
                                              key=lambda kv: -kv[1])[:3]
    # the zero gammas stop the gradient of the layers before them in each
    # block's body (exactly 0 on both sides); the stem, the shortcuts,
    # the last BatchNorms, the extra scales and the heads have one
    live = [n for n in worst if onp.abs(ref_grads[n]).max() > 0]
    assert len(live) == 59 and "backbone.0.weight" in live


# ---- get_model

def test_model_zoo_get_model_builds_resnet50_with_the_jax_names():
    from mxnet_tpu.gluon.model_zoo import get_model as jget
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    import mxnet_tpu_torch.gluon.model_zoo as zoo
    assert "get_model" in zoo.__all__
    tnet = get_model("resnet50_v1", device="cpu")
    names = [n for n, _ in tnet.named_parameters()]
    assert names == list(jget("resnet50_v1").collect_params())
    assert len(names) == 267
