"""mxnet_tpu_torch training against the JAX package: losses, learning-rate
schedulers, optimizers, the Trainer's gradient semantics, and a small
BERT classifier trained for three Adam steps.

The same numpy-seeded inputs and weights go through both packages.
Tolerances: 1e-5 absolute and relative in float32 for one op or one
update rule (the same arithmetic in another library); 2e-5 through a
whole model (sums in another order, the port's CPU products accumulated
in float64); learning-rate schedules are host arithmetic and match to
1e-12.
"""
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.nn import Dense, set_grad_req
from mxnet_tpu_torch.gluon.params import init_params_numpy, load_jax_params

TOL = 1e-5
MODEL_TOL = 2e-5


def _np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return x.detach().numpy() if isinstance(x, torch.Tensor) else x


def _close(a, b, tol=TOL, msg=""):
    onp.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                                err_msg=msg)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(seed, shape=(5, 4)):
    r = onp.random.RandomState(seed)
    return (r.randn(*shape).astype("f4"), r.randn(*shape).astype("f4"),
            r.rand(shape[0], 1).astype("f4"))


@pytest.mark.parametrize("name,kwargs", [
    ("L2Loss", {}), ("L2Loss", {"weight": 3.0}),
    ("L1Loss", {}), ("L1Loss", {"weight": 0.5}),
])
@pytest.mark.parametrize("with_sw", [False, True])
def test_regression_losses_vs_jax(name, kwargs, with_sw):
    pred, label, sw = _loss_inputs(1)
    jl = getattr(jloss, name)(**kwargs)
    tl = getattr(tloss, name)(**kwargs)
    jargs = [mx.nd.array(pred), mx.nd.array(label)]
    targs = [torch.from_numpy(pred), torch.from_numpy(label)]
    if with_sw:
        jargs.append(mx.nd.array(sw))
        targs.append(torch.from_numpy(sw))
    got = tl(*targs)
    assert got.shape == (5,)
    _close(got, jl(*jargs))


@pytest.mark.parametrize("from_sigmoid", [False, True])
@pytest.mark.parametrize("pos_weight", [None, 2.5])
def test_sigmoid_bce_vs_jax(from_sigmoid, pos_weight):
    pred, _, sw = _loss_inputs(2)
    r = onp.random.RandomState(3)
    label = r.randint(0, 2, pred.shape).astype("f4")
    if from_sigmoid:
        pred = 1.0 / (1.0 + onp.exp(-pred))
    jl = jloss.SigmoidBinaryCrossEntropyLoss(from_sigmoid=from_sigmoid,
                                             weight=0.7)
    tl = tloss.SigmoidBCELoss(from_sigmoid=from_sigmoid, weight=0.7)
    kw_j = {} if pos_weight is None else {"pos_weight": pos_weight}
    ref = jl(mx.nd.array(pred), mx.nd.array(label), mx.nd.array(sw), **kw_j)
    got = tl(torch.from_numpy(pred), torch.from_numpy(label),
             torch.from_numpy(sw), **kw_j)
    _close(got, ref)


@pytest.mark.parametrize("kwargs", [
    {}, {"from_logits": True}, {"weight": 2.0}, {"sparse_label": False},
    {"axis": 1, "batch_axis": 0},
])
def test_softmax_ce_vs_jax(kwargs):
    r = onp.random.RandomState(4)
    pred = r.randn(6, 5).astype("f4")
    if kwargs.get("from_logits"):
        pred = pred - onp.log(onp.exp(pred).sum(-1, keepdims=True))
    if kwargs.get("sparse_label", True):
        label = r.randint(0, 5, (6,)).astype("f4")
        label[0] = 9          # out of range: clipped, as the JAX pick
    else:
        label = r.rand(6, 5).astype("f4")
        label /= label.sum(-1, keepdims=True)
    sw = r.rand(6, 1).astype("f4")
    jl = jloss.SoftmaxCrossEntropyLoss(**kwargs)
    tl = tloss.SoftmaxCELoss(**kwargs)
    for extra in ((), (sw,)):
        ref = jl(mx.nd.array(pred), mx.nd.array(label),
                 *(mx.nd.array(a) for a in extra))
        got = tl(torch.from_numpy(pred), torch.from_numpy(label),
                 *(torch.from_numpy(a) for a in extra))
        assert got.shape == (6,)
        _close(got, ref)


def test_softmax_ce_gradient_vs_jax():
    r = onp.random.RandomState(5)
    pred = r.randn(4, 3).astype("f4")
    label = onp.array([0, 2, 1, 1], "f4")
    jp = mx.nd.array(pred)
    jp.attach_grad()
    with jautograd.record():
        jl = jloss.SoftmaxCrossEntropyLoss()(jp, mx.nd.array(label))
    jl.backward()
    tp = torch.from_numpy(pred).requires_grad_()
    tloss.SoftmaxCrossEntropyLoss()(tp, torch.from_numpy(label)) \
        .sum().backward()
    _close(tp.grad, jp.grad)


# ---------------------------------------------------------------------------
# learning-rate schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, base_lr=0.1,
                             warmup_steps=4, warmup_begin_lr=0.01)),
    ("FactorScheduler", dict(step=2, factor=0.1, stop_factor_lr=1e-4,
                             base_lr=0.1)),
    ("MultiFactorScheduler", dict(step=[9, 5], factor=0.3, base_lr=0.2,
                                  warmup_steps=3, warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=12, base_lr=0.1, pwr=2, final_lr=1e-3,
                           warmup_steps=2)),
    ("CosineScheduler", dict(max_update=10, base_lr=0.1, final_lr=0.01,
                             warmup_steps=3, warmup_begin_lr=0.001)),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULERS)
def test_schedulers_vs_jax(name, kwargs):
    j = getattr(jlrs, name)(**kwargs)
    t = getattr(tlrs, name)(**kwargs)
    for n in range(16):
        assert t(n) == pytest.approx(j(n), abs=1e-12, rel=1e-12), n


def test_linear_warmup_vs_jax():
    j = jlrs.LinearWarmUp(jlrs.CosineScheduler(10, base_lr=0.2), 0.0, 4)
    t = tlrs.LinearWarmUp(tlrs.CosineScheduler(10, base_lr=0.2), 0.0, 4)
    for n in range(14):
        assert t(n) == pytest.approx(j(n), abs=1e-12, rel=1e-12), n


def test_scheduler_refuses_bad_settings():
    with pytest.raises(mxt.MXNetError, match="step must be"):
        tlrs.FactorScheduler(0)
    s = tlrs.FactorScheduler(2, warmup_steps=3, warmup_mode="cubic")
    with pytest.raises(mxt.MXNetError, match="warmup_mode"):
        s(1)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.05}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.05, "correct_bias": False}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("signum", {"learning_rate": 0.01, "wd": 0.01, "wd_lh": 0.001}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0, "wd": 0.01}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adabelief", {"learning_rate": 0.01, "wd": 0.01}),
    ("adamax", {"learning_rate": 0.01, "wd": 0.01}),
    ("nadam", {"learning_rate": 0.01, "wd": 0.01,
               "schedule_decay": 0.01}),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01}),
    ("groupadagrad", {"learning_rate": 0.1}),
    ("adadelta", {"wd": 0.01, "rho": 0.8}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_weights": 0.5}),
    ("ftrl", {"learning_rate": 0.1, "wd": 0.01, "lamda1": 0.05}),
    ("ftml", {"learning_rate": 0.01, "wd": 0.01}),
    ("lars", {"learning_rate": 0.1, "wd": 0.01, "eta": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01, "lower_bound": 0.5,
              "upper_bound": 1.5, "bias_correction": False}),
    ("lans", {"learning_rate": 0.01, "wd": 0.01}),
]


def _run_updates(mod, nd, name, kwargs, sched_cls, steps=3):
    r = onp.random.RandomState(7)
    ws = [r.randn(4, 3).astype("f4"), r.randn(5).astype("f4")]
    grads = [[r.randn(*w.shape).astype("f4") * 3 for w in ws]
             for _ in range(steps)]
    opt = mod.create(name, rescale_grad=0.5, clip_gradient=1.0,
                     lr_scheduler=sched_cls(step=2, factor=0.5),
                     param_idx2name={0: "w0", 1: "w1"},
                     param_dict={0: types.SimpleNamespace(lr_mult=1.5,
                                                          wd_mult=2.0),
                                 1: types.SimpleNamespace(lr_mult=1.0,
                                                          wd_mult=0.0)},
                     **kwargs)
    opt.set_lr_mult({"w0": 0.5, 0: 0.8, "w1": 2.0})
    opt.set_wd_mult({"w1": 3.0})
    upd = mod.get_updater(opt)
    weights = [nd(w) for w in ws]
    for g in grads:
        upd([0, 1], [nd(a) for a in g], weights)
    return weights, opt


@pytest.mark.parametrize("name,kwargs", OPTIMIZERS)
def test_optimizers_three_steps_vs_jax(name, kwargs):
    jw, jo = _run_updates(jopt, mx.nd.array, name, kwargs,
                          jlrs.FactorScheduler)
    tw, to = _run_updates(topt, torch.from_numpy, name, kwargs,
                          tlrs.FactorScheduler)
    for a, b in zip(tw, jw):
        _close(a, b)
    assert to.num_update == jo.num_update == 3
    assert to._index_update_count == jo._index_update_count


def test_single_index_updates_vs_jax():
    """One parameter per call: its own count t, lr read after it."""
    r = onp.random.RandomState(8)
    w = r.randn(6).astype("f4")
    jo = jopt.Adam(learning_rate=0.05, lr_scheduler=jlrs.FactorScheduler(
        1, factor=0.9))
    to = topt.Adam(learning_rate=0.05, lr_scheduler=tlrs.FactorScheduler(
        1, factor=0.9))
    ju, tu = jopt.get_updater(jo), topt.get_updater(to)
    jw, tw = mx.nd.array(w), torch.from_numpy(w.copy())
    for i in range(3):
        g = r.randn(6).astype("f4")
        ju(0, mx.nd.array(g), jw)
        tu(0, torch.from_numpy(g), tw)
    _close(tw, jw)


@pytest.mark.parametrize("mod", [jopt, topt], ids=["jax", "torch"])
def test_mult_precedence_pinned(mod):
    """tests/test_optimizer_mults.py's cases on both packages: an
    index-keyed mult wins over a name-keyed one."""
    opt = mod.SGD(learning_rate=1.0, wd=1.0,
                  param_idx2name={0: "fc_weight", 1: "fc_bias"})
    opt.set_lr_mult({"fc_weight": 0.5, 0: 0.25})
    assert opt._get_lr(0) == 0.25
    opt.set_lr_mult({"fc_bias": 2.0})
    assert opt._get_lr(1) == 2.0 and opt._get_lr(0) == 1.0
    opt.set_wd_mult({"fc_weight": 0.5, 0: 4.0, "fc_bias": 0.0})
    assert opt._get_wd(0) == 4.0 and opt._get_wd(1) == 0.0
    bare = mod.SGD(learning_rate=1.0, wd=1.0)
    bare.set_lr_mult({0: 0.1})
    assert bare._get_lr(0) == pytest.approx(0.1) and bare._get_lr(1) == 1.0


def test_create_and_register():
    assert isinstance(topt.create("SGD"), topt.SGD)
    opt = topt.Adam()
    assert topt.create(opt) is opt
    with pytest.raises(mxt.MXNetError, match="unknown optimizer"):
        topt.create("no_such_rule")
    # every name the JAX package registers
    assert sorted(topt.optimizer._registry) == \
        sorted(jopt.optimizer._registry)

    @topt.register
    class Halve(topt.SGD):
        pass
    try:
        assert isinstance(topt.create("halve"), Halve)
    finally:
        topt.optimizer._registry.pop("halve")


# ---------------------------------------------------------------------------
# Trainer: grad_req and stale gradients
# ---------------------------------------------------------------------------

def _dense_pair(seed=0, grad_reqs=None):
    """A two-layer Dense net in each package with the same weights; a
    dict name -> grad_req applies to both."""
    r = onp.random.RandomState(seed)
    weights = {"0.weight": r.randn(6, 4).astype("f4"),
               "0.bias": r.randn(6).astype("f4"),
               "1.weight": r.randn(3, 6).astype("f4"),
               "1.bias": r.randn(3).astype("f4")}
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(6, in_units=4, activation="relu"))
    jnet.add(jnn.Dense(3, in_units=6))
    jparams = jnet.collect_params()
    for k, req in (grad_reqs or {}).items():
        jparams[k].grad_req = req
    jnet.initialize()
    for k, p in jparams.items():
        p.set_data(mx.nd.array(weights[k]))
    tnet = torch.nn.Sequential(
        Dense(6, in_units=4, activation="relu", device="cpu"),
        Dense(3, in_units=6, device="cpu"))
    load_jax_params(tnet, weights)
    tparams = dict(tnet.named_parameters())
    for k, req in (grad_reqs or {}).items():
        set_grad_req(tparams[k], req)
    assert sorted(jparams) == sorted(tparams)
    return jnet, tnet


def _batch(seed):
    r = onp.random.RandomState(seed)
    return r.randn(5, 4).astype("f4"), r.randint(0, 3, (5,)).astype("f4")


@pytest.mark.parametrize("grad_reqs", [
    {}, {"0.weight": "add", "1.bias": "add"}, {"0.bias": "null"},
    {"1.weight": "null", "0.weight": "add"},
])
def test_grad_req_vs_jax(grad_reqs):
    """write overwrites, add accumulates across backward calls and steps,
    null freezes: two backward calls before each of three steps."""
    jnet, tnet = _dense_pair(grad_reqs=grad_reqs)
    jtr = JTrainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1})
    ttr = TTrainer(dict(tnet.named_parameters()), "sgd",
                   {"learning_rate": 0.1})
    jl, tl = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    for step in range(3):
        for sub in range(2):
            x, y = _batch(10 * step + sub)
            with jautograd.record():
                jloss_v = jl(jnet(mx.nd.array(x)), mx.nd.array(y))
            jloss_v.backward()
            tl(tnet(torch.from_numpy(x)), torch.from_numpy(y)).backward(
                torch.ones(5))
        jtr.step(5)
        ttr.step(5)
    tparams = dict(tnet.named_parameters())
    for k, p in jnet.collect_params().items():
        _close(tparams[k], p.data(), msg=k)
        if grad_reqs.get(k) == "null":
            assert tparams[k].grad is None and not tparams[k].requires_grad


def test_stale_gradient_raises_like_jax():
    jnet, tnet = _dense_pair()
    jtr = JTrainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1})
    ttr = TTrainer(dict(tnet.named_parameters()), "sgd",
                   {"learning_rate": 0.1})
    x, _ = _batch(3)
    # a loss of the first layer alone: the second layer's gradients stay
    # stale
    with jautograd.record():
        jh = jnet[0](mx.nd.array(x)).sum()
    jh.backward()
    tnet[0](torch.from_numpy(x)).sum().backward()
    for tr in (jtr, ttr):
        with pytest.raises(Exception, match="has not been updated"):
            tr.step(5)
    with pytest.raises(mxt.MXNetError, match="1.bias"):
        ttr.step(5)
    jtr.step(5, ignore_stale_grad=True)
    ttr.step(5, ignore_stale_grad=True)
    tparams = dict(tnet.named_parameters())
    for k, p in jnet.collect_params().items():
        _close(tparams[k], p.data(), msg=k)
    # the first layer's gradient was consumed: now every one is stale
    with pytest.raises(mxt.MXNetError, match="has not been updated"):
        ttr.step(5)


def test_trainer_learning_rate_and_kvstore():
    _, tnet = _dense_pair()
    tr = TTrainer(list(tnet.parameters()), "sgd", {"learning_rate": 0.3})
    assert tr.learning_rate == 0.3
    tr.set_learning_rate(0.1)
    assert tr.learning_rate == 0.1 and tr.optimizer.lr == 0.1
    tr.allreduce_grads()
    # the dist store builds; in one process it may reduce in-program
    dist_tr = TTrainer(list(tnet.parameters()), "sgd", kvstore="dist_sync")
    assert type(dist_tr._kvstore).__name__ == "KVStoreDist"
    assert dist_tr._kvstore.in_program_reduce
    with pytest.raises(mxt.MXNetError, match="unknown kvstore"):
        TTrainer(list(tnet.parameters()), "sgd", kvstore="dist_nowhere")
    with pytest.raises(mxt.MXNetError, match="dict or list"):
        TTrainer(tnet.parameters(), "sgd")
    with pytest.raises(mxt.MXNetError, match="zero_shard"):
        tr.compile_step(lambda x: x, zero_shard=True)
    with pytest.raises(mxt.MXNetError, match="grad_req"):
        set_grad_req(tnet[0].weight, "sometimes")


def test_compile_step_returns_detached_per_sample_loss():
    _, tnet = _dense_pair()
    tr = TTrainer(dict(tnet.named_parameters()), "sgd",
                  {"learning_rate": 0.1})
    step = tr.compile_step(
        lambda a, b: tloss.SoftmaxCELoss()(tnet(a), b))
    x, y = _batch(4)
    before = tnet[0].weight.detach().clone()
    loss = step(x, y)            # numpy batches move to the params' device
    assert loss.shape == (5,) and not loss.requires_grad
    assert step.steps_done == 1
    assert not torch.equal(before, tnet[0].weight.detach())
    assert all(p.grad is None for p in tnet.parameters())


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

SEQ, BATCH = 10, 4


def _bert_pair(seed=0, **kw):
    x = onp.random.RandomState(seed + 1).randint(0, 128, (BATCH, SEQ)) \
        .astype("int32")
    tnet = tbert.BERTClassifier(tbert.bert_small_test(dropout=0.0,
                                                      device="cpu", **kw),
                                num_classes=3, dropout=0.0, device="cpu")
    params = init_params_numpy(tnet, seed)
    load_jax_params(tnet, params)
    jnet = jbert.BERTClassifier(jbert.bert_small_test(dropout=0.0, **kw),
                                num_classes=3, dropout=0.0)
    jnet.initialize()
    jnet(mx.nd.array(x, dtype="int32"))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    return jnet, tnet, x


def _train_jax(jnet, x, y, path, steps=3):
    trainer = JTrainer(jnet.collect_params(), "adam",
                       {"learning_rate": 1e-3, "wd": 0.01})
    lb = jloss.SoftmaxCrossEntropyLoss()
    xs, ys = mx.nd.array(x, dtype="int32"), mx.nd.array(y)
    losses = []
    if path == "compile_step":
        step = trainer.compile_step(lambda a, b: lb(jnet(a), b))
    for _ in range(steps):
        if path == "compile_step":
            loss = step(xs, ys)
        else:
            with jautograd.record():
                loss = lb(jnet(xs), ys)
            loss.backward()
            trainer.step(x.shape[0])
        losses.append(loss.asnumpy())
    return losses


def _train_torch(tnet, x, y, path, steps=3):
    trainer = TTrainer(dict(tnet.named_parameters()), "adam",
                       {"learning_rate": 1e-3, "wd": 0.01})
    lb = tloss.SoftmaxCrossEntropyLoss()
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    if path == "compile_step":
        step = trainer.compile_step(lambda a, b: lb(tnet(a), b))
    for _ in range(steps):
        if path == "compile_step":
            loss = step(xs, ys)
        else:
            loss = lb(tnet(xs), ys)
            loss.backward(torch.ones_like(loss))
            trainer.step(x.shape[0])
        losses.append(loss.detach().numpy())
    return losses


@pytest.mark.parametrize("pallas", ["off", "on"])
@pytest.mark.parametrize("path", ["record", "compile_step"])
def test_bert_classifier_three_adam_steps_vs_jax(monkeypatch, path, pallas):
    # MXNET_PALLAS=on runs the JAX package's flash-attention and
    # LayerNorm forward and backward kernels in interpret mode
    monkeypatch.setenv("MXNET_PALLAS", pallas)
    jnet, tnet, x = _bert_pair()
    y = onp.array([0, 2, 1, 1], "f4")
    jl = _train_jax(jnet, x, y, path)
    tl = _train_torch(tnet, x, y, path)
    for a, b in zip(tl, jl):
        _close(a, b, MODEL_TOL)
    assert tl[-1].mean() < tl[0].mean()
    tparams = dict(tnet.named_parameters())
    jparams = jnet.collect_params()
    assert len(tparams) == len(jparams) == 41
    for k, p in jparams.items():
        _close(tparams[k], p.data(), MODEL_TOL, msg=k)


def test_bert_mlm_tied_embedding_gradients_vs_jax():
    """The decoder's projection reuses word_embed.weight: it gets the
    gradient of the lookup and of the projection."""
    x = onp.random.RandomState(2).randint(0, 128, (2, SEQ)).astype("int32")
    tnet = tbert.bert_small_test(dropout=0.0, use_decoder=True, device="cpu")
    params = init_params_numpy(tnet, 4)
    load_jax_params(tnet, params)
    jnet = jbert.bert_small_test(dropout=0.0, use_decoder=True)
    jnet.initialize()
    jnet(mx.nd.array(x, dtype="int32"))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    r = onp.random.RandomState(3)
    w_seq, w_pool, w_mlm = (r.randn(*s).astype("f4") for s in
                            ((2, SEQ, 32), (2, 32), (2, SEQ, 128)))
    with jautograd.record():
        seq, pooled, scores = jnet(mx.nd.array(x, dtype="int32"))
        jl = (seq * mx.nd.array(w_seq)).sum() \
            + (pooled * mx.nd.array(w_pool)).sum() \
            + (scores * mx.nd.array(w_mlm)).sum()
    jl.backward()
    seq, pooled, scores = tnet(torch.from_numpy(x))
    ((seq * torch.from_numpy(w_seq)).sum()
     + (pooled * torch.from_numpy(w_pool)).sum()
     + (scores * torch.from_numpy(w_mlm)).sum()).backward()
    _close(jl.asnumpy(), (seq * torch.from_numpy(w_seq)).sum().detach()
           + (pooled * torch.from_numpy(w_pool)).sum().detach()
           + (scores * torch.from_numpy(w_mlm)).sum().detach(), MODEL_TOL)
    tparams = dict(tnet.named_parameters())
    for k, p in jnet.collect_params().items():
        _close(tparams[k].grad, p.grad(), MODEL_TOL, msg=k)
    # the lookup's gradient alone touches only the ids of x; the tied
    # projection's reaches every row
    g = tparams["word_embed.weight"].grad
    unused = sorted(set(range(128)) - set(x.ravel().tolist()))
    assert (g[unused].abs().sum(-1) > 0).all()
