"""The rest of ``gluon.nn``'s basic layers (GroupNorm, InstanceNorm, the
activation layers, Lambda, Concatenate) against the JAX package.

The same numpy-seeded inputs go through the JAX layer and the port's,
the JAX layer's parameters set from a seeded numpy dict that
``load_jax_params`` loads into the port's. Forward outputs and the
gradients of a weighted sum (input and parameters) are held within 1e-5
absolute and relative (float32 statistics and transcendental functions
of two libraries; the normalisations' sums run in another order), the
elementwise layers within 1e-6 (GELU's tanh form 1e-5: torch and XLA
differentiate it by other formulas, 1.3e-6 apart at worst here).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ndarray import ops as jF

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.ops import registry

TOL = 1e-5
ELEM_TOL = 1e-6


def set_jax_params(block, seed, scale=0.5, shift=0.0):
    block.initialize()
    r = onp.random.RandomState(seed)
    out = {}
    for k, p in sorted(block.collect_params().items()):
        v = (r.randn(*p.shape) * scale + shift).astype("f4")
        p.set_data(mx.nd.array(v))
        out[k] = v
    return out


def run_both(jl, tl, x, seed=0, tol=TOL, jfn=None, record_train=True):
    """Forward and the backward of a weighted sum through both layers;
    outputs, input gradients and parameter gradients held within
    ``tol``. ``jfn`` replaces the JAX layer's call."""
    dy = onp.random.RandomState(seed + 100).randn(
        *(jfn or jl)(mx.nd.array(x)).shape).astype("f4")
    jx = mx.nd.array(x)
    jx.attach_grad()
    with jautograd.record(train_mode=record_train):
        jy = (jfn or jl)(jx)
        (jy * mx.nd.array(dy)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = tl(tx)
    (ty * torch.from_numpy(dy)).sum().backward()
    onp.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), rtol=tol,
                                atol=tol)
    onp.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                                rtol=tol, atol=tol)
    if jl is not None:
        tp = dict(tl.named_parameters())
        for k, p in jl.collect_params().items():
            if p.grad_req == "null":
                assert tp[k].grad is None and tp[k].grad_req == "null", k
                continue
            onp.testing.assert_allclose(tp[k].grad.numpy(),
                                        p.grad().asnumpy(), rtol=tol,
                                        atol=tol, err_msg=k)
    return ty


@pytest.mark.parametrize("center,scale", [(True, True), (False, True),
                                          (True, False)])
@pytest.mark.parametrize("groups,shape", [(2, (3, 4, 5, 6)), (4, (2, 8, 7)),
                                          (1, (2, 3, 2, 3, 4))])
def test_group_norm_vs_jax(groups, shape, center, scale):
    jl = jnn.GroupNorm(groups, center=center, scale=scale,
                       in_channels=shape[1])
    tl = tnn.GroupNorm(groups, center=center, scale=scale,
                       in_channels=shape[1], device="cpu")
    load_jax_params(tl, set_jax_params(jl, 1, shift=1.0))
    x = (onp.random.RandomState(2).randn(*shape) * 3 + 1).astype("f4")
    run_both(jl, tl, x)


@pytest.mark.parametrize("axis,shape", [(1, (3, 4, 5, 6)), (1, (2, 3, 9)),
                                        (-1, (2, 6, 5, 3)), (2, (2, 5, 4))])
@pytest.mark.parametrize("scale", [False, True])
def test_instance_norm_vs_jax(axis, shape, scale):
    """InstanceNorm's default keeps gamma frozen at 1 (scale=False), as
    the JAX layer; ``axis`` names the channels."""
    ch = shape[axis]
    jl = jnn.InstanceNorm(axis=axis, scale=scale, in_channels=ch)
    tl = tnn.InstanceNorm(axis=axis, scale=scale, in_channels=ch,
                          device="cpu")
    load_jax_params(tl, set_jax_params(jl, 3, shift=1.0))
    x = onp.random.RandomState(4).randn(*shape).astype("f4")
    run_both(jl, tl, x)


def test_norm_funnel_names_and_errors():
    seen = []

    def w(name, fn):
        seen.append(name)
        return fn

    registry.add_invoke_wrapper(w)
    try:
        tnn.GroupNorm(2, in_channels=4, device="cpu")(torch.randn(2, 4, 3))
        tnn.InstanceNorm(in_channels=4, device="cpu")(torch.randn(2, 4, 3))
    finally:
        registry.remove_invoke_wrapper(w)
    assert seen == ["group_norm", "instance_norm"]
    with pytest.raises(mxt.MXNetError, match="in_channels"):
        tnn.GroupNorm(2)
    with pytest.raises(mxt.MXNetError, match="divide"):
        tnn.GroupNorm(3, in_channels=4, device="cpu")(torch.randn(2, 4, 3))


def test_group_norm_bf16_keeps_float32_statistics():
    """A bfloat16 input: float32 statistics, the output bfloat16, within
    a bf16 rounding (2**-8 relative) of the float32 layer's."""
    tl = tnn.GroupNorm(2, in_channels=4, device="cpu")
    x = torch.randn(3, 4, 8, 8) * 5 + 3
    y32 = tl(x)
    y16 = tl(x.to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16
    torch.testing.assert_close(y16.float(), y32, rtol=2 ** -7, atol=2 ** -7)


ACTS = [
    ("LeakyReLU", (0.1,), lambda x: jF.LeakyReLU(x, act_type="leaky",
                                                 slope=0.1), "leaky_relu"),
    ("ELU", (0.7,), lambda x: jF.LeakyReLU(x, act_type="elu", slope=0.7),
     "elu"),
    ("SELU", (), lambda x: jF.LeakyReLU(x, act_type="selu"), "selu"),
    ("GELU", (), lambda x: jF.Activation(x, act_type="gelu"), "gelu"),
    ("GELU", ("tanh",), lambda x: jF.Activation(x, act_type="gelu_tanh"),
     "gelu_tanh"),
    ("Swish", (1.5,), None, None),
    ("SiLU", (), lambda x: jF.Activation(x, act_type="silu"), None),
]


@pytest.mark.parametrize("name,args,jfn,funnel", ACTS,
                         ids=[f"{a[0]}{a[1]}" for a in ACTS])
def test_activation_layers_vs_jax(name, args, jfn, funnel):
    """Each activation layer, forward and input gradient, against the
    JAX layer (Swish) or the JAX activation it computes. GELU's two forms
    stand against the JAX ``gelu`` and ``gelu_tanh`` activations (the JAX
    ``GELU`` layer ignores ``approximation``; ROADMAP.md §3)."""
    x = onp.random.RandomState(5).randn(6, 7).astype("f4") * 3
    tl = getattr(tnn, name)(*args)
    jl = getattr(jnn, name)(*args) if name in ("Swish", "SiLU") else None
    if jl is not None:
        jl.initialize()
    seen = []

    def w(n, fn):
        seen.append(n)
        return fn

    registry.add_invoke_wrapper(w)
    try:
        run_both(None, tl, x, tol=TOL if args == ("tanh",) else ELEM_TOL,
                 jfn=jfn or jl)
    finally:
        registry.remove_invoke_wrapper(w)
    assert seen == ([funnel] if funnel else [])


def test_jax_gelu_layer_ignores_approximation():
    """The divergence the port does not copy: the JAX GELU layer takes
    the erf form for "tanh" too, the port MXNet's tanh form."""
    x = onp.linspace(-4, 4, 41, dtype="f4")
    jt = jnn.GELU(approximation="tanh")
    jt.initialize()
    erf = jF.Activation(mx.nd.array(x), act_type="gelu").asnumpy()
    assert onp.array_equal(jt(mx.nd.array(x)).asnumpy(), erf)
    port = tnn.GELU("tanh")(torch.from_numpy(x)).numpy()
    assert onp.abs(port - erf).max() > 1e-4
    with pytest.raises(mxt.MXNetError, match="approximation"):
        tnn.GELU("sigmoid")


@pytest.mark.parametrize("shape,c", [((4, 6), 6), ((3, 5, 2), 1),
                                     ((2, 3, 4), 4)])
def test_prelu_vs_jax(shape, c):
    """PReLU's alpha (0.25 by default, broadcast on the last axis) and
    its gradient."""
    jl = jnn.PReLU(in_channels=c)
    tl = tnn.PReLU(in_channels=c, device="cpu")
    jl.initialize()
    jl(mx.nd.ones(shape))
    assert onp.allclose(jl.alpha.data().asnumpy(), 0.25)
    assert torch.equal(tl.alpha.detach(), torch.full((c,), 0.25))
    load_jax_params(tl, set_jax_params(jl, 6, scale=0.2, shift=0.3))
    x = onp.random.RandomState(7).randn(*shape).astype("f4")
    run_both(jl, tl, x, tol=ELEM_TOL)


def test_lambda_layers_vs_jax():
    x = onp.random.RandomState(8).randn(3, 4).astype("f4")
    for jl, tl in ((jnn.Lambda("tanh"), tnn.Lambda("tanh")),
                   (jnn.HybridLambda(lambda a: a * 2 + 1),
                    tnn.HybridLambda(lambda a: a * 2 + 1))):
        jl.initialize()
        run_both(None, tl, x, tol=ELEM_TOL, jfn=jl)
    two = tnn.Lambda(lambda a, b: a - b)
    assert torch.equal(two(torch.ones(2), torch.ones(2)), torch.zeros(2))
    with pytest.raises(mxt.MXNetError, match="no op named"):
        tnn.Lambda("no_such_op")


@pytest.mark.parametrize("kind", ["Concatenate", "HybridConcatenate"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_concatenate_vs_jax(kind, axis):
    """Children on the same input, outputs concatenated on ``axis``;
    children named 0, 1, ... as the JAX block's."""
    jl = getattr(jnn, kind)(axis=axis)
    jl.add(jnn.Dense(3, in_units=4), jnn.Dense(3, in_units=4,
                                                activation="tanh"))
    tl = getattr(tnn, kind)(axis=axis)
    tl.add(tnn.Dense(3, in_units=4, device="cpu"),
           tnn.Dense(3, in_units=4, activation="tanh", device="cpu"))
    load_jax_params(tl, set_jax_params(jl, 9))
    x = onp.random.RandomState(10).randn(5, 4).astype("f4")
    y = run_both(jl, tl, x)
    assert y.shape == ((5, 6) if axis == -1 else (10, 3))


def test_new_layers_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda d: tnn.GroupNorm(2, in_channels=4, device=d),
                 lambda d: tnn.InstanceNorm(in_channels=4, device=d),
                 lambda d: tnn.PReLU(device=d)):
        with pytest.raises(mxt.MXNetError, match="no CUDA device"):
            make(None)
        assert next(make("cpu").parameters()).device.type == "cpu"
