"""The convolutional path of the port (``ops.nn`` conv / pool /
global_pool / batch_norm, ``gluon.nn`` conv and pooling layers,
BatchNorm and the containers, ``model_zoo.vision`` ResNets) against the
JAX package on the CPU, the same numpy-seeded weights and inputs on both
sides.

Tolerances: TOL (1e-5) for one op or layer in float32 (the port's CPU
convolutions accumulate in float64 and round once, XLA's in float32);
MODEL_TOL (2e-5, as ``tests/test_torch_train.py``) through a ResNet and
three SGD-momentum steps of one; BF16_TOL (2e-2 of the largest value,
a bfloat16 output rounded on both sides in other orders) for the
bfloat16 ops. Covered: conv (strides, padding, dilation, groups, 1-3
spatial axes), pooling (max / avg / sum / lp, ceil mode with and without
``count_include_pad``, padding past half the window), global pooling,
BatchNorm's training and inference ops in float32 and bfloat16 with their
gradients, every new layer, the ResNet forwards in training and eval
mode with the JAX ``collect_params()`` names, ``compile_step`` against
the JAX ``TrainLoop`` (losses, weights, running statistics),
``train_mode=False``, ``get_model``, ``convert_hybrid_block``, the
predictor over image buckets, and parameter files and train checkpoints
across the packages.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import nn as jops

from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import TrainLoop as TTrainLoop
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.ops import nn as tops

TOL = 1e-5
MODEL_TOL = 2e-5
BF16_TOL = 2e-2


def _np(t):
    if hasattr(t, "asnumpy"):
        t = t.asnumpy()
    if isinstance(t, torch.Tensor):
        t = t.detach().float().numpy()
    return onp.asarray(t, dtype=onp.float64)


def _close(got, ref, tol=TOL, msg=""):
    onp.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol,
                                err_msg=msg)


def _close_scaled(got, ref, rtol, msg=""):
    """Within ``rtol`` of the largest |ref| (a bfloat16 result)."""
    got, ref = _np(got), _np(ref)
    scale = max(float(onp.abs(ref).max()), 1e-30)
    assert float(onp.abs(got - ref).max()) <= rtol * scale, msg


def _jarr(a, dtype=None):
    x = mx.nd.array(a)
    return x.astype(dtype) if dtype else x


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

CONV_CASES = [
    # x shape, (out, in/groups, *kernel), stride, pad, dilate, groups, bias
    ((2, 3, 9, 9), (4, 3, 3, 3), 1, 1, 1, 1, True),
    ((2, 4, 11, 10), (6, 2, 3, 3), 2, 1, 1, 2, False),
    ((1, 3, 12, 12), (5, 3, 3, 2), (2, 1), (1, 0), (2, 1), 1, True),
    ((3, 4, 8, 8), (4, 1, 3, 3), 1, 2, 2, 4, False),
    ((2, 3, 13), (4, 3, 5), 2, 2, 1, 1, True),
    ((1, 2, 5, 6, 7), (3, 2, 3, 3, 3), (1, 2, 1), 1, 1, 1, True),
    ((2, 3, 16, 16), (8, 3, 7, 7), 2, 3, 1, 1, False),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_matches_jax(case):
    xs, ws, stride, pad, dilate, groups, bias = case
    r = onp.random.RandomState(0)
    x = r.randn(*xs).astype("f4")
    w = (r.randn(*ws) * 0.3).astype("f4")
    b = r.randn(ws[0]).astype("f4") if bias else None
    ref = jops.conv(_jarr(x)._data, _jarr(w)._data,
                    None if b is None else _jarr(b)._data, stride, dilate,
                    pad, groups)
    got = tops.conv(torch.from_numpy(x), torch.from_numpy(w),
                    None if b is None else torch.from_numpy(b), stride,
                    dilate, pad, groups)
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got, ref)


POOL_CASES = [
    # x shape, kernel, type, stride, pad, count_include_pad, ceil_mode
    ((2, 3, 9, 9), 3, "max", 2, 1, True, False),
    ((2, 3, 9, 9), 3, "max", 2, 1, True, True),
    ((2, 3, 10, 10), 3, "max", 2, 0, True, True),
    ((1, 2, 7, 8), 2, "max", 2, 2, True, False),           # pad > k / 2
    ((2, 3, 10, 10), 3, "avg", 2, 1, True, False),
    ((2, 3, 10, 10), 3, "avg", 2, 1, False, False),
    ((2, 3, 10, 10), 3, "avg", 2, 1, True, True),
    ((2, 3, 10, 10), 3, "avg", 2, 1, False, True),
    ((2, 3, 10, 11), (3, 2), "avg", (2, 3), (1, 0), True, True),
    ((2, 3, 10, 11), (3, 2), "avg", (2, 3), (1, 0), False, True),
    ((2, 3, 9, 9), 3, "sum", 2, 1, True, True),
    ((2, 3, 9, 9), 2, "lp", 2, 0, True, False),
    ((2, 3, 11), 3, "avg", 2, 1, True, True),
    ((2, 3, 11), 3, "max", 2, 1, True, True),
    ((1, 2, 5, 6, 7), 2, "avg", 2, 1, False, True),
    ((1, 2, 5, 6, 7), 3, "max", 2, 1, True, True),
]


@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_matches_jax(case):
    xs, kernel, kind, stride, pad, cip, ceil = case
    x = onp.random.RandomState(1).randn(*xs).astype("f4")
    ref = jops.pool(_jarr(x)._data, kernel, kind, stride, pad, cip, ceil)
    got = tops.pool(torch.from_numpy(x), kernel, kind, stride, pad, cip,
                    ceil)
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got, ref)


@pytest.mark.parametrize("kind", ["max", "avg", "sum"])
@pytest.mark.parametrize("xs", [(2, 3, 7), (2, 3, 5, 6), (1, 2, 3, 4, 5)])
def test_global_pool_matches_jax(kind, xs):
    x = onp.random.RandomState(2).randn(*xs).astype("f4")
    ref = jops.global_pool(_jarr(x)._data, kind)
    got = tops.global_pool(torch.from_numpy(x), kind)
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got, ref)


def _bn_inputs(shape, seed=3):
    r = onp.random.RandomState(seed)
    c = shape[1]
    return (r.randn(*shape).astype("f4") * 2 + 0.5,
            r.uniform(0.5, 1.5, c).astype("f4"),
            r.uniform(-0.5, 0.5, c).astype("f4"),
            r.uniform(-0.3, 0.3, c).astype("f4"),
            r.uniform(0.5, 2.0, c).astype("f4"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 3, 5, 5), (6, 4, 7), (1, 5, 1, 1)])
def test_batch_norm_ops_match_jax(dtype, shape):
    """Training mode: the output and the batch's statistics (float32 for
    a bfloat16 x, the biased variance), and the gradients of a weighted
    sum of the output with respect to x, gamma and beta; inference mode
    with the running statistics."""
    import jax
    import jax.numpy as jnp
    x, g, b, rm, rv = _bn_inputs(shape)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    cot = onp.random.RandomState(4).randn(*shape).astype("f4")
    jx = jnp.asarray(x).astype(jdt)

    def jfn(xx, gg, bb):
        out, m, v = jops.batch_norm_train(xx, gg, bb, 1e-5)
        return (out.astype(jnp.float32) * cot).sum(), (out, m, v)

    (_, (jout, jm, jv)), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)(jx, jnp.asarray(g),
                                              jnp.asarray(b))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out, m, v = tops.batch_norm_train(tx, tg, tb, 1e-5)
    assert out.dtype == tdt and m.dtype == v.dtype == torch.float32
    (out.float() * torch.from_numpy(cot)).sum().backward()
    if dtype == "float32":
        _close(out, jout)
        _close(m, jm)
        _close(v, jv)
        for got, ref in zip((tx.grad, tg.grad, tb.grad), jgrads):
            _close(got, ref, tol=1e-4)
    else:
        _close_scaled(out, jout, BF16_TOL)
        _close(m, jm, tol=1e-6)
        _close(v, jv, tol=1e-5)
        for got, ref in zip((tx.grad, tg.grad, tb.grad), jgrads):
            _close_scaled(got, ref, BF16_TOL)
    jinf = jops.batch_norm_infer(jx, *(jnp.asarray(a) for a in (g, b, rm,
                                                               rv)), 1e-5)
    tinf = tops.batch_norm_infer(torch.from_numpy(x).to(tdt),
                                 *(torch.from_numpy(a) for a in (g, b, rm,
                                                                 rv)), 1e-5)
    assert tinf.dtype == tdt
    if dtype == "float32":
        _close(tinf, jinf)
    else:
        _close_scaled(tinf, jinf, BF16_TOL)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _load_both(jblock, tblock, seed=5, x=None):
    """The same numpy weights into both blocks (the JAX one initialised
    by a first forward of ``x`` where its shapes are deferred): uniform
    in [-0.5, 0.5], a running variance in [0.5, 1.5]."""
    jblock.initialize()
    if x is not None:
        jblock(_jarr(x))
    r = onp.random.RandomState(seed)
    params = {}
    for k, p in tblock.named_parameters():
        lo = 0.5 if k.endswith("running_var") else -0.5
        params[k] = r.uniform(lo, lo + 1.0, tuple(p.shape)).astype("f4")
    jp = jblock.collect_params()
    assert sorted(jp) == sorted(params)
    for k, p in jp.items():
        p.set_data(mx.nd.array(params[k]))
    load_jax_params(tblock, params)
    return params


LAYER_CASES = {
    "conv1d": (lambda: jnn.Conv1D(4, 3, strides=2, padding=1, in_channels=3),
               lambda: tnn.Conv1D(4, 3, strides=2, padding=1, in_channels=3,
                                  device="cpu"), (2, 3, 9)),
    "conv2d": (lambda: jnn.Conv2D(6, (3, 2), strides=(2, 1), padding=(1, 0),
                                  dilation=(1, 2), groups=2, in_channels=4,
                                  activation="relu"),
               lambda: tnn.Conv2D(6, (3, 2), strides=(2, 1), padding=(1, 0),
                                  dilation=(1, 2), groups=2, in_channels=4,
                                  activation="relu", device="cpu"),
               (2, 4, 8, 9)),
    "conv2d_nobias": (lambda: jnn.Conv2D(5, 1, use_bias=False,
                                         in_channels=3),
                      lambda: tnn.Conv2D(5, 1, use_bias=False, in_channels=3,
                                         device="cpu"), (2, 3, 4, 4)),
    "conv3d": (lambda: jnn.Conv3D(3, 2, padding=1, in_channels=2),
               lambda: tnn.Conv3D(3, 2, padding=1, in_channels=2,
                                  device="cpu"), (1, 2, 4, 5, 3)),
    "maxpool1d": (lambda: jnn.MaxPool1D(3, 2, 1, ceil_mode=True),
                  lambda: tnn.MaxPool1D(3, 2, 1, ceil_mode=True), (2, 3, 10)),
    "maxpool2d": (lambda: jnn.MaxPool2D(3, 2, 1),
                  lambda: tnn.MaxPool2D(3, 2, 1), (2, 3, 9, 9)),
    "maxpool3d": (lambda: jnn.MaxPool3D(2, 2, 0, ceil_mode=True),
                  lambda: tnn.MaxPool3D(2, 2, 0, ceil_mode=True),
                  (1, 2, 5, 4, 3)),
    "avgpool1d": (lambda: jnn.AvgPool1D(3, 2, 1, count_include_pad=False),
                  lambda: tnn.AvgPool1D(3, 2, 1, count_include_pad=False),
                  (2, 3, 10)),
    "avgpool2d": (lambda: jnn.AvgPool2D(3, 2, 1, ceil_mode=True),
                  lambda: tnn.AvgPool2D(3, 2, 1, ceil_mode=True),
                  (2, 3, 10, 10)),
    "avgpool3d": (lambda: jnn.AvgPool3D(2, ceil_mode=True,
                                        count_include_pad=False),
                  lambda: tnn.AvgPool3D(2, ceil_mode=True,
                                        count_include_pad=False),
                  (1, 2, 5, 4, 3)),
    "globalmax1d": (jnn.GlobalMaxPool1D, tnn.GlobalMaxPool1D, (2, 3, 7)),
    "globalmax2d": (jnn.GlobalMaxPool2D, tnn.GlobalMaxPool2D, (2, 3, 5, 4)),
    "globalmax3d": (jnn.GlobalMaxPool3D, tnn.GlobalMaxPool3D,
                    (1, 2, 3, 4, 5)),
    "globalavg1d": (jnn.GlobalAvgPool1D, tnn.GlobalAvgPool1D, (2, 3, 7)),
    "globalavg2d": (jnn.GlobalAvgPool2D, tnn.GlobalAvgPool2D, (2, 3, 5, 4)),
    "globalavg3d": (jnn.GlobalAvgPool3D, tnn.GlobalAvgPool3D,
                    (1, 2, 3, 4, 5)),
    "flatten": (jnn.Flatten, tnn.Flatten, (2, 3, 4, 5)),
    "identity": (jnn.Identity, tnn.Identity, (2, 3, 4)),
    "sigmoid": (lambda: jnn.Activation("sigmoid"),
                lambda: tnn.Activation("sigmoid"), (2, 3, 4)),
    "softrelu": (lambda: jnn.Activation("softrelu"),
                 lambda: tnn.Activation("softrelu"), (2, 3, 4)),
    "relu": (lambda: jnn.Activation("relu"), lambda: tnn.Activation("relu"),
             (2, 3, 4)),
    "sequential": (
        lambda: jnn.Sequential().add(
            jnn.Conv2D(4, 3, padding=1, in_channels=3),
            jnn.BatchNorm(in_channels=4), jnn.Activation("relu"),
            jnn.MaxPool2D(2), jnn.Flatten(), jnn.Dense(3, in_units=16)),
        lambda: tnn.Sequential().add(
            tnn.Conv2D(4, 3, padding=1, in_channels=3, device="cpu"),
            tnn.BatchNorm(in_channels=4, device="cpu"),
            tnn.Activation("relu"), tnn.MaxPool2D(2), tnn.Flatten(),
            tnn.Dense(3, in_units=16, device="cpu")), (2, 3, 4, 4)),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_jax(name):
    jmake, tmake, xs = LAYER_CASES[name]
    jblock, tblock = jmake(), tmake()
    x = onp.random.RandomState(6).randn(*xs).astype("f4")
    _load_both(jblock, tblock, x=x)
    tblock.eval()
    _close(tblock(torch.from_numpy(x)), jblock(_jarr(x)), msg=name)


@pytest.mark.parametrize("kind", ["plain", "relu", "axis", "no_center_scale",
                                  "global_stats"])
def test_batch_norm_layer_matches_jax(kind):
    """BatchNorm in training mode (the batch's statistics, the running
    statistics written in place with momentum 0.9 and the biased
    variance) and in eval mode; ``center`` / ``scale`` off freeze beta /
    gamma (``grad_req="null"``); ``use_global_stats`` normalises with
    the running statistics in training mode too and writes nothing."""
    kw = {"plain": {}, "relu": {}, "axis": {"axis": 2},
          "no_center_scale": {"center": False, "scale": False},
          "global_stats": {"use_global_stats": True}}[kind]
    xs = (4, 3, 5, 6) if kind != "axis" else (4, 5, 3, 6)
    ch = xs[kw.get("axis", 1)]
    jcls = jnn.BatchNormReLU if kind == "relu" else jnn.BatchNorm
    tcls = tnn.BatchNormReLU if kind == "relu" else tnn.BatchNorm
    jb, tb = jcls(in_channels=ch, **kw), tcls(in_channels=ch, device="cpu",
                                              **kw)
    params = _load_both(jb, tb)
    r = onp.random.RandomState(7)
    for step in range(2):
        x = (r.randn(*xs) * 3 + 1).astype("f4")
        with jautograd.record():
            jout = jb(_jarr(x))
        tout = tb(torch.from_numpy(x))
        _close(tout, jout, msg=f"train {step}")
        jp = jb.collect_params()
        for k, p in tb.named_parameters():
            _close(p, jp[k].data(), msg=f"{k} after step {step}")
    if kind == "global_stats":
        for k in ("running_mean", "running_var"):
            assert onp.array_equal(getattr(tb, k).detach().numpy(),
                                   params[k])
    tb.eval()
    x = r.randn(*xs).astype("f4")
    _close(tb(torch.from_numpy(x)), jb(_jarr(x)), msg="eval")
    jreq = {k: p.grad_req for k, p in jb.collect_params().items()}
    treq = {k: p.grad_req for k, p in tb.named_parameters()}
    assert treq == jreq
    assert all(p.requires_grad == (p.grad_req != "null")
               for p in tb.parameters())


def test_layers_need_in_channels():
    for make in (lambda: tnn.Conv2D(4, 3, device="cpu"),
                 lambda: tnn.BatchNorm(device="cpu"),
                 lambda: tnn.Conv2D(4, 3, in_channels=3, groups=2,
                                    device="cpu"),
                 lambda: tnn.Conv2D(4, 3, in_channels=3, layout="NHWC",
                                    device="cpu"),
                 lambda: tnn.Activation("nope")):
        with pytest.raises(MXNetError):
            make()


def test_sequential_names_and_indexing():
    seq = tnn.HybridSequential(tnn.Identity(), tnn.Flatten())
    seq.add(tnn.Activation("relu"))
    assert len(seq) == 3 and isinstance(seq[1], tnn.Flatten)
    assert [type(m).__name__ for m in seq] == ["Identity", "Flatten",
                                               "Activation"]
    assert [n for n, _ in seq.named_children()] == ["0", "1", "2"]
    x = torch.randn(2, 3, 4)
    assert torch.equal(seq(x), torch.relu(x.reshape(2, -1)))


# ---------------------------------------------------------------------------
# the ResNets
# ---------------------------------------------------------------------------

def _resnet_weights(tnet, seed):
    """Seeded numpy weights under the port's names: He-normal
    convolutions, a 1 / sqrt(fan-in) Dense layer, gamma and the running
    variance near 1, beta and the running mean near 0."""
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
            gain = 2.0 if len(shape) > 2 else 1.0
            v = r.randn(*shape) * onp.sqrt(gain / fan_in)
        out[k] = v.astype("f4")
    return out


def _resnet_pair(name, size, n, seed=11, dtype="float32", **kw):
    """The JAX and the port's ``name`` with the same weights (the JAX
    net's deferred shapes settled by one eval forward of ``n`` images
    first; with ``dtype="float64"`` the JAX net cast, inside
    ``jax.enable_x64``)."""
    jnet = jvision.get_model(name, **kw)
    jnet.initialize()
    jnet(mx.nd.zeros((n, 3, size, size)))
    if dtype != "float32":
        jnet.cast(dtype)
    tnet = tvision.get_model(name, device="cpu", **kw)
    params = _resnet_weights(tnet, seed)
    jp = jnet.collect_params()
    assert list(jp) == list(params)
    for k, p in jp.items():
        p.set_data(mx.nd.array(params[k]).astype(dtype))
    load_jax_params(tnet, params)
    return jnet, tnet, params


def _images(n, size, seed=12):
    """``bench_resnet``'s inputs: uniform draws in [0, 1)."""
    return onp.random.RandomState(seed).uniform(
        size=(n, 3, size, size)).astype("f4")


#: the small nets' forwards (each later test reuses one of the first two,
#: so the JAX side's ops are compiled once a shape)
#: resnet50_v1's logits and running statistics (64 x 64, batch 2), port
#: against JAX in float32: within RESNET50_RTOL of the tensor's largest
#: |value|. Measured on the CPU with the weights of :func:`_resnet_weights`
#: (``tests/vision_rounding.py``): the logits 1.17e-4 of the largest apart
#: in training mode (the batch's statistics at 2 x 2 pixels in the last
#: stage amplify rounding), 7.2e-6 in eval mode; against the port in
#: float64 the JAX package's float32 logits 1.12e-4 and the port's 1.6e-5
#: (eval 7.2e-6 and 1.2e-6): the gap is the JAX side's float32 rounding.
#: The deepest running variance measured 4.7e-5 of its largest apart
RESNET50_RTOL = 5e-4

FORWARD_CASES = [("resnet18_v1", 32, 2, dict(classes=10, thumbnail=True)),
                 ("resnet18_v2", 32, 2, dict(classes=10, thumbnail=True)),
                 ("resnet50_v1", 64, 2, dict())]


@pytest.mark.parametrize("case", FORWARD_CASES, ids=lambda c: c[0])
def test_resnet_forward_matches_jax(case):
    """Training mode (the batch's statistics; every running statistic
    after the forward) and eval mode; the parameter names are the JAX
    ``collect_params()`` keys, running statistics included."""
    name, size, n, kw = case
    jnet, tnet, _ = _resnet_pair(name, size, n, **kw)
    assert list(dict(tnet.named_parameters())) == list(jnet.collect_params())

    def close(got, ref, msg):
        if name == "resnet50_v1":
            _close_scaled(got, ref, RESNET50_RTOL, msg)
        else:
            _close(got, ref, MODEL_TOL, msg)

    x = _images(n, size)
    with jautograd.record():
        jout = jnet(_jarr(x))
    close(tnet(torch.from_numpy(x)), jout, "train")
    jp = jnet.collect_params()
    for k, p in tnet.named_parameters():
        if "running" in k:
            close(p, jp[k].data(), k)
    tnet.eval()
    x = _images(n, size, seed=13)
    close(tnet(torch.from_numpy(x)), jnet(_jarr(x)), "eval")


def test_resnet50_v1_shape_and_counts():
    """The headline net at full width: 161 trainable tensors of
    25,557,032 values and 106 running statistics, as the JAX net's
    ``collect_params()`` gives them."""
    net = tvision.resnet50_v1(device="cpu")
    ps = dict(net.named_parameters())
    train = [p for p in ps.values() if p.grad_req != "null"]
    assert len(train) == 161
    assert sum(p.numel() for p in train) == 25_557_032
    assert sum(1 for k in ps if k.endswith(("running_mean",
                                            "running_var"))) == 106
    assert list(ps)[:5] == ["features.0.weight", "features.1.gamma",
                            "features.1.beta", "features.1.running_mean",
                            "features.1.running_var"]
    assert "features.4.0.body.1.running_mean" in ps
    # ResNet 1.5: the stride sits on the bottleneck's 3x3
    block = net.features[5][0]
    assert block.body[0]._strides == (1, 1)
    assert block.body[3]._strides == (2, 2)


TRAIN_SIZE, TRAIN_BATCH, TRAIN_CLASSES, TRAIN_STEPS = 16, 4, 4, 3
TRAIN_KW = dict(classes=TRAIN_CLASSES, thumbnail=True)
SGD = {"learning_rate": 0.01, "momentum": 0.9}


def _train_batches():
    r = onp.random.RandomState(14)
    for i in range(TRAIN_STEPS):
        yield (_images(TRAIN_BATCH, TRAIN_SIZE, seed=20 + i),
               r.randint(0, TRAIN_CLASSES, TRAIN_BATCH).astype("f4"))


def test_compile_step_matches_jax_trainloop():
    """Three SGD-momentum steps (momentum 0.9) of resnet18_v1 (thumbnail,
    16 x 16, batch 4, one batch a step) from the same weights: the port's
    ``TrainLoop`` (one captured program, the ``fused`` mode of
    ``compile_step``) in float32 against the JAX package's ``TrainLoop``
    in float64 (``jax.enable_x64``): losses, every weight and every
    running statistic within MODEL_TOL. The JAX package's own float32
    run is no reference here: measured on the CPU
    (``tests/vision_rounding.py``), it parts from its float64 run by
    3.9e-4 at the third loss and 3.8e-4 in the weights, the port's
    float32 by 7.7e-7 and 5.0e-7."""
    import jax
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import TrainLoop as JTrainLoop
    from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JSCE
    with jax.enable_x64(True):
        jnet, tnet, params = _resnet_pair("resnet18_v1", TRAIN_SIZE,
                                          TRAIN_BATCH, dtype="float64",
                                          **TRAIN_KW)
        jloop = JTrainLoop(jnet, JTrainer(jnet.collect_params(), "sgd",
                                          dict(SGD)), JSCE())
        jl = [_np(jloop.step(_jarr(x, "float64"), _jarr(y, "float64")))
              for x, y in _train_batches()]
        jp = {k: _np(p.data()) for k, p in jnet.collect_params().items()}
    tloop = TTrainLoop(tnet, TTrainer(dict(tnet.named_parameters()), "sgd",
                                      dict(SGD)),
                       tloss.SoftmaxCrossEntropyLoss())
    tl = [_np(tloop.step(torch.from_numpy(x), torch.from_numpy(y)))
          for x, y in _train_batches()]
    step = tloop.compiled_step
    assert step.mode == "fused" and step.n_traces == 1
    assert tl[-1].mean() < tl[0].mean()
    for i, (a, b) in enumerate(zip(tl, jl)):
        _close(a, b, MODEL_TOL, msg=f"loss {i}")
    for k, p in tnet.named_parameters():
        _close(p, jp[k], MODEL_TOL, msg=k)
        if "running" in k or p.grad_req != "null":
            assert not onp.array_equal(p.detach().numpy(), params[k]), k


def test_train_mode_false_leaves_running_stats_untouched():
    """``compile_step(train_mode=False)``: BatchNorm normalises with the
    running statistics and writes none (bit for bit) while the weights
    train; each step's loss is the eval-mode forward's at the weights it
    started from."""
    tnet = tvision.resnet18_v1(device="cpu", **TRAIN_KW)
    params = _resnet_weights(tnet, 11)
    load_jax_params(tnet, params)
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = TTrainer(dict(tnet.named_parameters()), "sgd",
                    dict(SGD)).compile_step(lambda a, b: lb(tnet(a), b),
                                            train_mode=False)
    for x, y in _train_batches():
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        tnet.eval()
        with torch.no_grad():
            ref = lb(tnet(x), y)
        tnet.train()
        _close(step(x, y), ref, TOL)
    assert step.n_traces == 1
    for k, p in tnet.named_parameters():
        same = onp.array_equal(p.detach().numpy(), params[k])
        assert same == ("running" in k), k


def test_batch_norm_mode_is_part_of_the_signature():
    """``net.eval()`` between steps makes a program of its own (on a
    card the graph froze BatchNorm's mode); ``net.train()`` takes the
    first again."""
    tnet = tvision.resnet18_v1(classes=3, thumbnail=True, device="cpu")
    tr = TTrainer(dict(tnet.named_parameters()), "sgd", dict(SGD))
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(tnet(a), b))
    x = torch.from_numpy(_images(2, 8))
    y = torch.tensor([0.0, 2.0])
    step(x, y)
    step(x, y)
    assert step.n_traces == 1
    tnet.eval()
    before = tnet.features[1][0].body[1].running_mean.detach().clone()
    step(x, y)
    assert step.n_traces == 2
    assert "train_mode changed" in step.explain_retrace()
    assert torch.equal(before, tnet.features[1][0].body[1].running_mean)
    tnet.train()
    step(x, y)
    assert step.n_traces == 2


def test_warmup_scope_puts_running_stats_back():
    """The capture's warm-up runs of a step's body (the forward and
    backward, twice) write BatchNorm's running statistics; the scope
    puts them back in place, and hands the same undo to a failed
    capture (``restore``)."""
    from mxnet_tpu_torch.gluon import fused_step as tfs
    bn = tnn.BatchNorm(in_channels=3, device="cpu")
    mean, var = bn.running_mean, bn.running_var
    before = (mean.detach().clone(), var.detach().clone())
    restore, warming = [], [False]
    with tfs._warmup_scope(warming, torch.device("cpu"), restore):
        for _ in range(2):
            bn(torch.randn(4, 3, 2, 2) + 1)
    assert torch.equal(mean, before[0]) and torch.equal(var, before[1])
    assert bn.running_mean is mean
    bn(torch.randn(4, 3, 2, 2) + 1)
    assert not torch.equal(mean, before[0])
    for fn in restore:
        fn()
    assert torch.equal(mean, before[0]) and torch.equal(var, before[1])


# ---------------------------------------------------------------------------
# the zoo's surface, amp, serving, persistence
# ---------------------------------------------------------------------------

def test_get_model_names_and_errors():
    """The port's zoo names are the JAX zoo's ResNets; an unknown name
    raises as there; ``pretrained=True`` raises (no model store)."""
    jnames = {n for n in jvision._models if n.startswith("resnet")}
    assert set(tvision._models) == jnames
    net = tvision.get_model("ResNet18_V2", classes=7, thumbnail=True,
                            device="cpu")
    assert isinstance(net, tvision.ResNetV2)
    assert net.output.weight.shape == (7, 512)
    with pytest.raises(MXNetError, match="not in the zoo"):
        tvision.get_model("resnet1000_v9")
    with pytest.raises(mx.MXNetError):
        jvision.get_model("resnet1000_v9")
    with pytest.raises(MXNetError, match="model store"):
        tvision.resnet50_v1(pretrained=True, device="cpu")
    with pytest.raises(MXNetError):
        tvision.get_resnet(3, 18, device="cpu")


def test_convert_hybrid_block_keeps_batch_norm_float32():
    """``amp.convert_hybrid_block`` casts what the JAX package's casts
    (every parameter but the norm layers'), name by name; a bfloat16
    predictor over it takes bfloat16 images and answers in bfloat16."""
    from mxnet_tpu import amp as jamp
    from mxnet_tpu_torch.serving import predictor_for
    jnet, tnet, _ = _resnet_pair(*FORWARD_CASES[1][:3], **FORWARD_CASES[1][3])
    jamp.convert_hybrid_block(jnet, "bfloat16")
    x = torch.from_numpy(_images(2, 32))
    with torch.no_grad():
        ref = tnet.eval()(x)
    pred = predictor_for(tnet, "bfloat16", bucket_sizes=(2,), device="cpu")
    got = {k: str(p.dtype).replace("torch.", "")
           for k, p in tnet.named_parameters()}
    assert got == {k: str(p.dtype) for k, p in
                   jnet.collect_params().items()}
    assert got["features.0.running_var"] == "float32"
    assert got["features.2.0.bn1.gamma"] == "float32"
    assert got["features.2.0.conv1.weight"] == "bfloat16"
    out = pred.predict(x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    _close_scaled(out, ref, 5e-2)


def test_predictor_buckets_image_batches():
    """``CompiledPredictor`` pads an image batch (n, 3, H, W) on its
    leading axis to the next bucket and runs the net in eval mode: each
    row's logits are the same in every bucket and equal the eval-mode
    forward's; the running statistics are not written."""
    from mxnet_tpu_torch.serving import CompiledPredictor
    tnet = tvision.resnet18_v1(classes=6, thumbnail=True, device="cpu")
    load_jax_params(tnet, _resnet_weights(tnet, 11))
    stats = {k: p.detach().clone() for k, p in tnet.named_parameters()
             if "running" in k}
    pred = CompiledPredictor(tnet, bucket_sizes=(2, 8), device="cpu")
    x = _images(3, 16, seed=15)
    outs = []
    for rows in (1, 3):
        padded, n = pred.pad_to_bucket(x[:rows])
        outs.append(pred.predict(*padded)[:n])
    assert pred.n_traces == 2
    with torch.no_grad():
        ref = tnet(torch.from_numpy(x))
    assert torch.equal(outs[0], outs[1][:1])
    assert torch.equal(outs[1], ref)
    for k, p in tnet.named_parameters():
        if k in stats:
            assert torch.equal(p, stats[k]), k


def _random_stats(block, seed):
    """Give ``block`` (either package's) random parameters, running
    statistics included; returns them as numpy."""
    r = onp.random.RandomState(seed)
    if hasattr(block, "collect_params"):
        out = {}
        for k, p in block.collect_params().items():
            out[k] = r.uniform(0.5, 1.5, p.shape).astype("f4")
            p.set_data(mx.nd.array(out[k]))
        return out
    out = {k: r.uniform(0.5, 1.5, tuple(p.shape)).astype("f4")
           for k, p in block.named_parameters()}
    load_jax_params(block, out)
    return out


def test_parameter_files_cross_load(tmp_path):
    """A ResNet's parameter file, running statistics included, written by
    either package loads into the other (``save_parameters`` /
    ``load_parameters``), in place."""
    from mxnet_tpu_torch.gluon import load_parameters, save_parameters
    jnet, tnet, _ = _resnet_pair(*FORWARD_CASES[0][:3], **FORWARD_CASES[0][3])
    f = str(tmp_path / "port.params")
    sent = _random_stats(tnet, 16)
    save_parameters(tnet, f)
    jnet.load_parameters(f)
    for k, p in jnet.collect_params().items():
        assert onp.array_equal(p.data().asnumpy(), sent[k]), k
    f = str(tmp_path / "jax.params")
    sent = _random_stats(jnet, 17)
    jnet.save_parameters(f)
    mean = tnet.features[1][0].body[1].running_mean
    load_parameters(tnet, f)
    assert tnet.features[1][0].body[1].running_mean is mean
    for k, p in tnet.named_parameters():
        assert onp.array_equal(p.detach().numpy(), sent[k]), k


def test_train_checkpoints_cross_load(tmp_path):
    """A train checkpoint (``TrainCheckpointManager``) of a ResNet and
    its SGD-momentum trainer written by either package restores into the
    other: every parameter, running statistics included, and the
    momentum of every trainable one."""
    from mxnet_tpu.checkpoint import TrainCheckpointManager as JMgr
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu_torch.checkpoint import TrainCheckpointManager as TMgr
    jnet, tnet, _ = _resnet_pair(*FORWARD_CASES[0][:3], **FORWARD_CASES[0][3])
    ttr = TTrainer(dict(tnet.named_parameters()), "sgd", dict(SGD))
    lb = tloss.SoftmaxCrossEntropyLoss()
    lb(tnet(torch.from_numpy(_images(2, 32))), torch.tensor([0., 2.])) \
        .sum().backward()
    ttr.step(2)
    d = str(tmp_path / "port")
    TMgr(d, async_save=False).save(1, trainer=ttr, net=tnet)
    jtr = JTrainer(jnet.collect_params(), "sgd", dict(SGD))
    assert int(JMgr(d, async_save=False).restore_latest(
        trainer=jtr, net=jnet)["step"]) == 1
    jp = jnet.collect_params()
    for k, p in tnet.named_parameters():
        assert onp.array_equal(jp[k].data().asnumpy(),
                               p.detach().numpy()), k
    tstates = [ttr._updater.states[i] for i in range(len(ttr._params))]
    jstates = [jtr._updater.states[i] for i in range(len(ttr._params))]
    for ts, js in zip(tstates, jstates):
        assert onp.array_equal(_np(js), _np(ts))
    d = str(tmp_path / "jax")
    sent = _random_stats(jnet, 18)
    JMgr(d, async_save=False).save(2, trainer=jtr, net=jnet)
    ttr2 = TTrainer(dict(tnet.named_parameters()), "sgd", dict(SGD))
    assert int(TMgr(d, async_save=False).restore_latest(
        trainer=ttr2, net=tnet)["step"]) == 2
    for k, p in tnet.named_parameters():
        assert onp.array_equal(p.detach().numpy(), sent[k]), k
    for i, js in enumerate(jstates):
        assert onp.array_equal(_np(ttr2._updater.states[i]), _np(js))
