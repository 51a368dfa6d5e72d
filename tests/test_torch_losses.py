"""The ten losses of ``mxnet_tpu_torch.gluon.loss`` that the training
slices before did not need, against the JAX package's on the same
numpy-seeded inputs: each loss's per-sample values and the gradient of
their sum with respect to every float input (the JAX side through
``autograd.record`` / ``backward``), with and without ``sample_weight``
and a constructor ``weight`` where the loss takes them.

Tolerances: 1e-5 absolute and relative in float32 (the same arithmetic
in another library); ``CTCLoss`` 1e-4 relative (a recursion of T
log-sum-exps, each rounded), its infeasible rows (about 1e30) 1e-6
relative.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon import loss as jloss

from mxnet_tpu_torch.gluon import loss as tloss

TOL = 1e-5
CTC_RTOL = 1e-4


def _both(name, kwargs, inputs, grad_of, kw_call=None):
    """The JAX and the port loss on ``inputs`` and the keyword inputs
    ``kw_call`` (numpy): (values, grads of the inputs named by index in
    ``grad_of``) for each package."""
    kw_call = kw_call or {}
    jin = [mx.nd.array(a) for a in inputs]
    for i in grad_of:
        jin[i].attach_grad()
    with jautograd.record():
        jout = getattr(jloss, name)(**kwargs)(
            *jin, **{k: mx.nd.array(v) for k, v in kw_call.items()})
    jout.backward()
    tin = [torch.from_numpy(onp.array(a)) for a in inputs]
    for i in grad_of:
        tin[i].requires_grad_()
    tout = getattr(tloss, name)(**kwargs)(
        *tin, **{k: torch.from_numpy(v) for k, v in kw_call.items()})
    tout.sum().backward()
    return ((jout.asnumpy(), [jin[i].grad.asnumpy() for i in grad_of]),
            (tout.detach().numpy(), [tin[i].grad.numpy() for i in grad_of]))


def _check(j, t, rtol=TOL, atol=TOL):
    (jv, jg), (tv, tg) = j, t
    assert tv.shape == jv.shape
    onp.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol)
    for a, b in zip(tg, jg):
        onp.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _pair(seed, shape=(6, 5)):
    r = onp.random.RandomState(seed)
    return (r.randn(*shape).astype("f4"), r.randn(*shape).astype("f4"),
            r.rand(shape[0], 1).astype("f4"))


@pytest.mark.parametrize("name,kwargs", [
    ("HuberLoss", {}), ("HuberLoss", {"rho": 0.3, "weight": 2.0}),
    ("HingeLoss", {}), ("HingeLoss", {"margin": 2, "weight": 0.5}),
    ("SquaredHingeLoss", {}), ("SquaredHingeLoss", {"margin": 0.5}),
    ("LogisticLoss", {}), ("LogisticLoss", {"label_format": "binary"}),
    ("LogisticLoss", {"weight": 1.5, "batch_axis": 1}),
])
@pytest.mark.parametrize("with_sw", [False, True])
def test_pointwise_losses_vs_jax(name, kwargs, with_sw):
    pred, label, sw = _pair(1)
    if name in ("HingeLoss", "SquaredHingeLoss") or (
            name == "LogisticLoss" and kwargs.get("label_format") is None):
        label = onp.sign(label).astype("f4")
    elif name == "LogisticLoss":
        label = (label > 0).astype("f4")
    if kwargs.get("batch_axis") == 1:
        sw = sw.reshape(1, -1)[:, :5]
    inputs = [pred, label] + ([sw] if with_sw else [])
    _check(*_both(name, kwargs, inputs, grad_of=[0]))


@pytest.mark.parametrize("kwargs", [{}, {"from_logits": False},
                                    {"from_logits": False, "axis": 0},
                                    {"weight": 3.0}])
def test_kldiv_vs_jax(kwargs):
    r = onp.random.RandomState(2)
    pred = r.randn(6, 5).astype("f4")
    if kwargs.get("from_logits", True):
        pred = pred - onp.log(onp.exp(pred).sum(-1, keepdims=True))
    label = r.rand(6, 5).astype("f4")
    label /= label.sum(-1, keepdims=True)
    label[0, 0] = 0.0                  # log(0 + 1e-12) on both sides
    _check(*_both("KLDivLoss", kwargs, [pred, label], grad_of=[0]))


@pytest.mark.parametrize("kwargs", [{}, {"margin": 0.3, "weight": 2.0}])
def test_triplet_vs_jax(kwargs):
    r = onp.random.RandomState(3)
    a, p, n = (r.randn(6, 4, 3).astype("f4") for _ in range(3))
    p[0] = a[0] + 0.01                 # a row under the margin: relu's 0
    sw = r.rand(6).astype("f4")
    _check(*_both("TripletLoss", kwargs, [a, p, n], grad_of=[0, 1, 2]))
    _check(*_both("TripletLoss", kwargs, [a, p, n, sw], grad_of=[0, 1, 2]))


@pytest.mark.parametrize("margin", [0, 0.2])
def test_cosine_embedding_vs_jax(margin):
    r = onp.random.RandomState(4)
    x1, x2 = r.randn(8, 6).astype("f4"), r.randn(8, 6).astype("f4")
    label = onp.array([1, -1, 1, -1, -1, 1, 1, -1], "f4")
    _check(*_both("CosineEmbeddingLoss", {"margin": margin},
                  [x1, x2, label], grad_of=[0, 1]))


@pytest.mark.parametrize("kwargs", [
    {}, {"from_logits": False}, {"compute_full": True},
    {"from_logits": False, "compute_full": True, "weight": 0.5}])
def test_poisson_nll_vs_jax(kwargs):
    r = onp.random.RandomState(5)
    pred = r.randn(6, 4).astype("f4")
    if not kwargs.get("from_logits", True):
        pred = onp.exp(pred)
    target = r.poisson(2.0, (6, 4)).astype("f4")
    _check(*_both("PoissonNLLLoss", kwargs, [pred, target], grad_of=[0]))
    sw = r.rand(6, 1).astype("f4")
    _check(*_both("PoissonNLLLoss", kwargs, [pred, target, sw],
                  grad_of=[0]))


@pytest.mark.parametrize("smooth", [0.3, 0.1])
def test_sdml_vs_jax(smooth):
    r = onp.random.RandomState(6)
    x1 = r.randn(5, 8).astype("f4")
    x2 = x1 + 0.3 * r.randn(5, 8).astype("f4")
    _check(*_both("SDMLLoss", {"smoothing_parameter": smooth}, [x1, x2],
                  grad_of=[0, 1]))


def _ctc_inputs(seed, n=4, t=12, c=6, lmax=4):
    r = onp.random.RandomState(seed)
    pred = r.randn(n, t, c).astype("f4")
    lab = onp.zeros((n, lmax), "f4")
    lens = r.randint(1, lmax + 1, n)
    for i, k in enumerate(lens):
        lab[i, :k] = r.randint(1, c, k)
    lab[0, :2] = [2, 2]                # a repeat: no skip between them
    return pred, lab, lens.astype("f4")


@pytest.mark.parametrize("case", ["plain", "lengths", "tnc", "weighted"])
def test_ctc_vs_jax(case):
    pred, lab, llen = _ctc_inputs(7)
    plen = onp.array([12, 9, 7, 12], "f4")
    kwargs, inputs, kw_call = {}, [pred, lab], {}
    if case == "lengths":
        inputs += [plen, llen]
    elif case == "tnc":
        kwargs = {"layout": "TNC", "label_layout": "TN"}
        inputs = [pred.transpose(1, 0, 2).copy(), lab.T.copy()]
    elif case == "weighted":
        kwargs = {"weight": 0.5}
        kw_call = {"pred_lengths": plen}
    j, t = _both("CTCLoss", kwargs, inputs, grad_of=[0], kw_call=kw_call)
    assert onp.all(t[0] < 1e3)
    _check(j, t, rtol=CTC_RTOL, atol=CTC_RTOL)


def test_ctc_padding_counts_nonzero_labels():
    """``label_lengths=None``: the count of non-zero labels, so a row
    padded with zeros scores as its unpadded labels."""
    pred, lab, llen = _ctc_inputs(8)
    full = tloss.CTCLoss()(torch.from_numpy(pred), torch.from_numpy(lab))
    given = tloss.CTCLoss()(torch.from_numpy(pred), torch.from_numpy(lab),
                            None, torch.from_numpy(llen))
    torch.testing.assert_close(full, given, rtol=0, atol=0)


def test_ctc_infeasible_alignment_vs_jax():
    """Labels that need more frames than the row has (three labels with a
    repeat in 3 frames need 4): about 1e30 on both sides, where
    ``F.ctc_loss`` gives inf; the feasible rows as before."""
    pred, lab, _ = _ctc_inputs(9, n=3, t=6, c=5, lmax=3)
    lab[0] = [1, 1, 2]
    plen = onp.array([3, 6, 6], "f4")
    j, t = _both("CTCLoss", {}, [pred, lab, plen], grad_of=[0])
    assert 1e29 < t[0][0] < 1e31 and onp.isfinite(t[0]).all()
    onp.testing.assert_allclose(t[0][0], j[0][0], rtol=1e-6)
    onp.testing.assert_allclose(t[0][1:], j[0][1:], rtol=CTC_RTOL,
                                atol=CTC_RTOL)
    onp.testing.assert_allclose(t[1][0][1:], j[1][0][1:], rtol=CTC_RTOL,
                                atol=CTC_RTOL)


def test_ctc_matches_torch_ctc_where_feasible():
    """Where every alignment exists and rows are unpadded, the recursion
    is the CTC loss: ``F.ctc_loss`` (reduction none) within 1e-4."""
    pred, lab, llen = _ctc_inputs(10)
    p = torch.from_numpy(pred)
    got = tloss.CTCLoss()(p, torch.from_numpy(lab), None,
                          torch.from_numpy(llen))
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(p, -1).transpose(0, 1),
        torch.from_numpy(lab).long(), torch.full((4,), 12, dtype=torch.long),
        torch.from_numpy(llen).long(), blank=0, reduction="none")
    torch.testing.assert_close(got, ref, rtol=CTC_RTOL, atol=CTC_RTOL)
