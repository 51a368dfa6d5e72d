"""The one-card ``Trainer.compile_step`` of the port (its ``fused`` mode:
one captured CUDA graph per batch signature on a card; on the CPU the
same body runs eagerly over the same static buffers) against the JAX
package's ``compile_step`` (one XLA program per signature).

The same numpy-seeded weights and batches go through both. Tolerances:
MODEL_TOL (2e-5, as ``tests/test_torch_train.py``: sums in another
order, the port's CPU products accumulated in float64) through a model;
TOL (1e-5) for a few Dense layers; update rules that repeat the same
float32 arithmetic are held bit for bit. The JAX side runs with its
Pallas kernels in interpret mode (``MXNET_PALLAS=on``) and through XLA
(``off``), as ``tests/test_torch_train.py`` does.

Covered: the optimizer's keyword surface (``use_fused_step``,
``lazy_update``, other keywords) in both packages; three Adam steps of
the narrow BERT with lr from a scheduler or set between steps, wd and
clip; two SGD-momentum steps of the narrow LSTM LM; a parameter the
loss does not reach; the retrace policy and ``MXNET_FUSED_STEP_CACHE_
SIZE``; ``aot_compile``; ``save_states`` / ``load_states`` between steps;
one call = one eager step; the warm-up that does not update; the
training flags in the signature; ``opt_update``'s device-scalar form.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon import HybridBlock as JHybridBlock
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import fused_step as tfs
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.word_lm import WordLM
from mxnet_tpu_torch.gluon.nn import Dense, Dropout
from mxnet_tpu_torch.gluon.nn.basic_layers import recording_draws
from mxnet_tpu_torch.gluon.params import init_params_numpy, load_jax_params
from mxnet_tpu_torch.ops.kernels import opt_update as topu
from mxnet_tpu_torch.optimizer.optimizer import DeviceHParams

TOL = 1e-5
MODEL_TOL = 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(a, b, tol=TOL, msg=""):
    a = a.asnumpy() if hasattr(a, "asnumpy") else a
    b = b.asnumpy() if hasattr(b, "asnumpy") else b
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    onp.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# a few Dense layers in both packages, one of them unreached by the loss
# ---------------------------------------------------------------------------

class JTwo(JHybridBlock):
    def __init__(self):
        super().__init__()
        self.a = jnn.Dense(5, in_units=4)
        self.b = jnn.Dense(3, in_units=5)
        self.c = jnn.Dense(3, in_units=5)       # not reached

    def hybrid_forward(self, F, x):
        return self.b(self.a(x))


class TTwo(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = Dense(5, in_units=4, device="cpu")
        self.b = Dense(3, in_units=5, device="cpu")
        self.c = Dense(3, in_units=5, device="cpu")

    def forward(self, x):
        return self.b(self.a(x))


def _two_pair(seed=0):
    jnet, tnet = JTwo(), TTwo()
    jnet.initialize()
    r = onp.random.RandomState(seed)
    params = {k: r.uniform(-0.5, 0.5, tuple(p.shape)).astype("f4")
              for k, p in tnet.named_parameters()}
    load_jax_params(tnet, params)
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    return jnet, tnet


def _batch(n=6, seed=1):
    r = onp.random.RandomState(seed)
    return (r.randn(n, 4).astype("f4"),
            r.randint(0, 3, (n,)).astype("f4"))


def _reached(params):
    return {k: p for k, p in params.items() if not k.startswith("c.")}


def _steps(jnet, tnet, opt, kw, batches, compiled=True):
    """The same steps in both packages: per step (loss, loss); the
    trainers and (JAX, port) compiled steps. The eager steps' trainers
    leave out ``c``, whose gradient the loss never makes (a stale
    gradient, which the eager step refuses)."""
    jp, tp = jnet.collect_params(), dict(tnet.named_parameters())
    if not compiled:
        jp = {k: jp[k] for k in _reached(tp)}
        tp = _reached(tp)
    jtr = JTrainer(jp, opt, dict(kw))
    ttr = TTrainer(tp, opt, dict(kw))
    jlb, tlb = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b)) if compiled \
        else None
    tstep = ttr.compile_step(lambda a, b: tlb(tnet(a), b)) if compiled \
        else None
    out = []
    for x, y in batches:
        if compiled:
            jl = jstep(mx.nd.array(x), mx.nd.array(y)).asnumpy()
            tl = tstep(x, y).numpy()
        else:
            with jautograd.record():
                jl_ = jlb(jnet(mx.nd.array(x)), mx.nd.array(y))
            jl_.backward()
            jtr.step(x.shape[0])
            jl = jl_.asnumpy()
            tl_ = tlb(tnet(torch.from_numpy(x)), torch.from_numpy(y))
            tl_.sum().backward()
            ttr.step(x.shape[0])
            tl = tl_.detach().numpy()
        out.append((jl, tl))
    return out, (jtr, ttr), (jstep, tstep)


def _same_params(jnet, tnet, tol=TOL):
    tparams = dict(tnet.named_parameters())
    for k, p in jnet.collect_params().items():
        _close(tparams[k], p.data(), tol, msg=k)


# ---------------------------------------------------------------------------
# the optimizer's keyword surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "lazy_update": False,
             "use_fused_step": False}),
    ("sgd", {"learning_rate": 0.1, "lazy_update": True,
             "use_fused_step": True, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "lazy_update": False,
              "use_fused_step": False, "wd": 0.01}),
    ("adamw", {"learning_rate": 0.01, "use_fused_step": True,
               "wd": 0.01}),
])
def test_optimizer_keywords_build_and_update_alike(name, kw):
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    assert type(to).__name__.lower() == type(jo).__name__.lower() == name
    if "lazy_update" in kw:
        assert to.lazy_update == jo.lazy_update == kw["lazy_update"]
    jnet, tnet = _two_pair()
    out, _, _ = _steps(jnet, tnet, name, kw,
                       [_batch(seed=s) for s in (1, 2, 3)], compiled=False)
    for jl, tl in out:
        _close(tl, jl)
    tparams = dict(tnet.named_parameters())
    for k in ("a.weight", "a.bias", "b.weight", "b.bias"):
        _close(tparams[k], jnet.collect_params()[k].data(), msg=k)


# ---------------------------------------------------------------------------
# compile_step's keyword surface
# ---------------------------------------------------------------------------

class JDrop(JHybridBlock):
    def __init__(self):
        super().__init__()
        self.a = jnn.Dense(5, in_units=4)
        self.d = jnn.Dropout(0.5)
        self.b = jnn.Dense(3, in_units=5)

    def hybrid_forward(self, F, x):
        return self.b(self.d(self.a(x)))


class TDrop(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = Dense(5, in_units=4, device="cpu")
        self.d = Dropout(0.5)
        self.b = Dense(3, in_units=5, device="cpu")

    def forward(self, x):
        return self.b(self.d(self.a(x)))


def _drop_pair(seed=0):
    jnet, tnet = JDrop(), TDrop()
    jnet.initialize()
    r = onp.random.RandomState(seed)
    params = {k: r.uniform(-0.5, 0.5, tuple(p.shape)).astype("f4")
              for k, p in tnet.named_parameters()}
    load_jax_params(tnet, params)
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    return jnet, tnet


@pytest.mark.parametrize("donate", [True, False])
def test_compile_step_keywords_build_and_train_alike(donate):
    """The JAX package's compile_step signature: ``donate`` (nothing to
    donate in a graph, accepted) and ``train_mode=False`` (the dropout
    layer runs as in eval mode, though the module is in training mode)
    build and train in both packages alike, three Adam steps within
    TOL; with ``train_mode`` True the same net draws masks, and the flag
    is the signature's first field. ``analyze`` builds a step that lints
    itself after its first step, the JAX normalisation of the value
    (``analysis/``, ``tests/test_torch_analysis.py``); ``autotune`` builds a step that tunes
    at its first call (``tuning/``, ``tests/test_torch_tuning.py``);
    ``numerics`` builds its instrumented step."""
    jnet, tnet = _drop_pair()
    kw = {"learning_rate": 0.01}
    jtr = JTrainer(jnet.collect_params(), "adam", dict(kw))
    ttr = TTrainer(dict(tnet.named_parameters()), "adam", dict(kw))
    jlb, tlb = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b), donate=donate,
                             train_mode=False)
    tstep = ttr.compile_step(lambda a, b: tlb(tnet(a), b), donate=donate,
                             train_mode=False)
    assert tnet.training
    for s in (1, 2, 3):
        x, y = _batch(seed=s)
        _close(tstep(x, y), jstep(mx.nd.array(x), mx.nd.array(y)))
    _same_params(jnet, tnet)
    assert tstep.mode == "fused" and tstep.n_traces == 1
    assert tstep._sig_history[-1][0] == (False,)
    # from the same weights, train_mode True draws masks: another loss
    losses = []
    for train_mode in (False, True):
        _, net = _drop_pair()
        tr = TTrainer(dict(net.named_parameters()), "adam", dict(kw))
        step = tr.compile_step(lambda a, b: tlb(net(a), b), donate=donate,
                               train_mode=train_mode)
        losses.append(step(*_batch(seed=1)))
        assert step._sig_history[-1][0] == (train_mode,)
    assert not torch.equal(losses[0], losses[1])
    assert ttr.compile_step(lambda a: a, analyze="on")._analyze == "warn"
    assert ttr.compile_step(lambda a: a, autotune="off")._autotune == "off"
    assert ttr.compile_step(lambda a: a, numerics="on").numerics == "global"


@pytest.mark.parametrize("where", ["loss", "update"])
def test_first_call_falls_back_only_when_the_loss_fails(monkeypatch, where):
    """A first call whose loss fails inside the step's program (on a card,
    a loss that syncs with the host cannot be captured; here it raises
    once) falls back to the eager step, as the JAX package's first
    failed trace does (its loss reads a value to the host): three calls
    of each package within TOL, Adam's first real step at t = 1. A first
    call whose update fails (the ``opt_update`` wrapper raising, as a
    kernel that does not build or launch would) raises ``MXNetError``
    instead: the eager step would not run that kernel. It then updates
    and counts nothing and the step stays fused; with the wrapper back,
    the next call is the first step."""
    jnet, tnet = _two_pair()
    kw = {"learning_rate": 0.01}
    tp = _reached(dict(tnet.named_parameters()))
    jp = {k: p for k, p in jnet.collect_params().items() if k in tp}
    jtr, ttr = JTrainer(jp, "adam", dict(kw)), TTrainer(tp, "adam", dict(kw))
    jlb, tlb = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    fails = [1 if where == "loss" else 0]

    def tloss_fn(a, b):
        out = tnet(a)
        if fails[0]:
            fails[0] -= 1
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return tlb(out, b)

    def jloss_fn(a, b):
        out = jnet(a)
        if where == "loss":
            _ = float(out.asnumpy().sum())
        return jlb(out, b)

    jstep, tstep = jtr.compile_step(jloss_fn), ttr.compile_step(tloss_fn)
    if where == "update":
        before = {k: p.detach().clone() for k, p in tp.items()}

        def launch_fails(*a, **k):
            raise RuntimeError("opt_update: the kernel did not launch")

        with monkeypatch.context() as m:
            m.setattr(topu, "multi_update", launch_fails)
            with pytest.raises(mxt.MXNetError, match="did not launch"):
                tstep(*_batch(seed=1))
        assert tstep.mode == "fused"
        assert ttr.optimizer._index_update_count == {}
        assert all(torch.equal(p, before[k]) for k, p in tp.items())
    for s in (1, 2, 3):
        x, y = _batch(seed=s)
        _close(tstep(x, y), jstep(mx.nd.array(x), mx.nd.array(y)))
    _same_params(jnet, tnet)
    assert tstep.mode == jstep.mode == \
        ("eager" if where == "loss" else "fused")
    assert ttr.optimizer._index_update_count == {i: 3 for i in range(4)}


# ---------------------------------------------------------------------------
# models, against the JAX package's compile_step
# ---------------------------------------------------------------------------

BATCH, SEQ = 4, 8


def _bert_pair(seed=0):
    x = onp.random.RandomState(seed + 1).randint(0, 128, (BATCH, SEQ)) \
        .astype("int32")
    tnet = tbert.BERTClassifier(tbert.bert_small_test(dropout=0.0,
                                                      device="cpu"),
                                num_classes=3, dropout=0.0, device="cpu")
    params = init_params_numpy(tnet, seed)
    load_jax_params(tnet, params)
    jnet = jbert.BERTClassifier(jbert.bert_small_test(dropout=0.0),
                                num_classes=3, dropout=0.0)
    jnet.initialize()
    jnet(mx.nd.array(x, dtype="int32"))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    return jnet, tnet, x


@pytest.mark.parametrize("pallas", ["off", "on"])
@pytest.mark.parametrize("lr_from", ["scheduler", "set_between_steps"])
def test_bert_three_adam_steps_every_hyperparameter_reaches_the_update(
        monkeypatch, pallas, lr_from):
    """lr changes every step (a FactorScheduler, or trainer.learning_rate
    set between steps), with wd and a clip that binds: the port's losses
    and weights follow the JAX compile_step's, so the lr, t, wd and clip
    of each step reach its update."""
    monkeypatch.setenv("MXNET_PALLAS", pallas)
    jnet, tnet, x = _bert_pair()
    y = onp.array([0, 2, 1, 1], "f4")
    kw = {"learning_rate": 2e-3, "wd": 0.01, "clip_gradient": 0.05}
    jkw, tkw = dict(kw), dict(kw)
    if lr_from == "scheduler":
        jkw["lr_scheduler"] = jlrs.FactorScheduler(step=1, factor=0.5)
        tkw["lr_scheduler"] = tlrs.FactorScheduler(step=1, factor=0.5)
    jtr = JTrainer(jnet.collect_params(), "adam", jkw)
    ttr = TTrainer(dict(tnet.named_parameters()), "adam", tkw)
    jlb, tlb = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b))
    tstep = ttr.compile_step(lambda a, b: tlb(tnet(a), b))
    lrs = []
    for i in range(3):
        if lr_from == "set_between_steps":
            jtr.learning_rate = ttr.learning_rate = 2e-3 * (3 - i)
        jl = jstep(mx.nd.array(x, dtype="int32"), mx.nd.array(y))
        tl = tstep(torch.from_numpy(x), torch.from_numpy(y))
        _close(tl, jl.asnumpy(), MODEL_TOL, msg=f"loss {i}")
        lrs.append((ttr.learning_rate, jtr.learning_rate))
    assert tstep.mode == "fused" and tstep.n_traces == 1
    assert len({t for t, _ in lrs}) == 3
    for t, j in lrs:
        assert t == pytest.approx(j, rel=1e-12)
    assert ttr.optimizer.num_update == jtr._optimizer.num_update == 3
    tparams = dict(tnet.named_parameters())
    for k, p in jnet.collect_params().items():
        _close(tparams[k], p.data(), MODEL_TOL, msg=k)


def _jax_lm_example():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_lstm_lm", os.path.join(ROOT, "examples", "train_lstm_lm.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex


@pytest.mark.parametrize("pallas", ["off", "on"])
def test_word_lm_two_sgd_momentum_steps_vs_jax(monkeypatch, pallas):
    """The narrow LSTM LM (2 layers, vocab 64, 16 / 32): two SGD-momentum
    steps with wd, lr halved between them."""
    monkeypatch.setenv("MXNET_PALLAS", pallas)
    vocab, embed, hidden, layers, batch, bptt = 64, 16, 32, 2, 4, 6
    r = onp.random.RandomState(12)
    x = r.randint(0, vocab, (batch, bptt)).astype("int32")
    y = r.randint(0, vocab, (batch, bptt)).astype("int32")
    tnet = WordLM(vocab, embed, hidden, layers, device="cpu")
    params = init_params_numpy(tnet, 13)
    load_jax_params(tnet, params)
    jnet = _jax_lm_example().WordLM(vocab, embed, hidden, layers)
    jnet.initialize()
    jnet(mx.nd.array(x, dtype="int32"))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    kw = {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-3}
    jtr = JTrainer(jnet.collect_params(), "sgd", dict(kw))
    ttr = TTrainer(dict(tnet.named_parameters()), "sgd", dict(kw))
    jlb, tlb = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b))
    tstep = ttr.compile_step(lambda a, b: tlb(tnet(a), b))
    for i in range(2):
        jl = jstep(mx.nd.array(x, dtype="int32"), mx.nd.array(y))
        tl = tstep(torch.from_numpy(x), torch.from_numpy(y))
        _close(tl, jl.asnumpy(), MODEL_TOL, msg=f"loss {i}")
        jtr.learning_rate = ttr.learning_rate = 0.25
    assert tstep.mode == "fused" and tstep.n_traces == 1
    tparams = dict(tnet.named_parameters())
    for k, p in jnet.collect_params().items():
        _close(tparams[k], p.data(), MODEL_TOL, msg=k)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.1}),
    ("adam", {"learning_rate": 0.05, "wd": 0.1}),
    ("adamw", {"learning_rate": 0.05, "wd": 0.1}),
])
def test_unreached_parameter_updates_as_the_jax_fused_step(name, kw):
    """``c`` is not on the loss's path: the JAX fused program's
    ``jax.grad`` gives it a zero gradient and its rule still applies (wd
    moves it); the port's captured body does the same."""
    jnet, tnet = _two_pair()
    c0 = tnet.c.weight.detach().clone()
    out, _, (jstep, tstep) = _steps(jnet, tnet, name, kw,
                                    [_batch(seed=s) for s in (1, 2)])
    assert jstep.mode == tstep.mode == "fused"
    for jl, tl in out:
        _close(tl, jl)
    _same_params(jnet, tnet)
    assert not torch.equal(tnet.c.weight, c0)


# ---------------------------------------------------------------------------
# signatures, captures and the update counts
# ---------------------------------------------------------------------------

def test_retrace_policy_side_by_side(monkeypatch):
    """One program per signature, as the JAX step counts them: lr
    changes and a batch_size argument reuse it, a new batch shape makes
    one more, the first shape is cached; with
    MXNET_FUSED_STEP_CACHE_SIZE=1 the least recently used is evicted and
    made again."""
    jnet, tnet = _two_pair()
    kw = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = JTrainer(jnet.collect_params(), "sgd", dict(kw))
    ttr = TTrainer(dict(tnet.named_parameters()), "sgd", dict(kw))
    jlb, tlb = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b))
    tstep = ttr.compile_step(lambda a, b: tlb(tnet(a), b))
    assert tstep.n_traces == 0
    assert tstep.explain_retrace() == jstep.explain_retrace() \
        == "no program traced yet"

    def both(x, y, **k):
        jstep(mx.nd.array(x), mx.nd.array(y), **k)
        tstep(x, y, **k)
        return jstep.n_traces, tstep.n_traces

    x, y = _batch(6)
    for lr in (0.1, 0.05, 0.2):
        jtr.learning_rate = ttr.learning_rate = lr
        assert both(x, y) == (1, 1)
    assert "only one program" in tstep.explain_retrace()
    assert both(x, y, batch_size=12) == (1, 1)
    x2, y2 = _batch(3)
    assert both(x2, y2) == (2, 2)
    for step in (jstep, tstep):
        why = step.explain_retrace()
        assert "traced argument shapes/dtypes changed" in why
        assert "(6, 4)" in why and "(3, 4)" in why
    assert both(x, y) == (2, 2)
    _same_params(jnet, tnet)
    monkeypatch.setenv("MXNET_FUSED_STEP_CACHE_SIZE", "1")
    x3, y3 = _batch(2)
    assert both(x3, y3) == (3, 3)
    assert len(tstep._lru) == len(tstep._programs) == 1
    assert both(x, y) == (4, 4)        # evicted: made again
    assert "traced argument shapes/dtypes changed" in \
        tstep.explain_retrace()
    _same_params(jnet, tnet)


def test_aot_compile_advances_no_count():
    """aot_compile makes the signature's program and touches no count,
    weight or state; the steps after it make none (the JAX package's
    test_train_loop_convergence_and_aot)."""
    jnet, tnet = _two_pair()
    _, ref = _two_pair()
    x, y = _batch()
    kw = {"learning_rate": 0.05, "wd": 0.01}
    ttr = TTrainer(dict(tnet.named_parameters()), "adam", dict(kw))
    jtr = JTrainer(jnet.collect_params(), "adam", dict(kw))
    tlb, jlb = tloss.SoftmaxCrossEntropyLoss(), jloss.SoftmaxCrossEntropyLoss()
    tstep = ttr.compile_step(lambda a, b: tlb(tnet(a), b))
    jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b))
    w0 = [p.detach().clone() for p in tnet.parameters()]
    assert tstep.aot_compile(x, y) is None
    jstep.aot_compile(mx.nd.array(x), mx.nd.array(y))
    assert tstep.n_traces == jstep.n_traces == 1
    assert ttr.optimizer.num_update == jtr._optimizer.num_update == 0
    assert ttr.optimizer._index_update_count == {}
    assert all(torch.equal(a, b) for a, b in zip(w0, tnet.parameters()))
    for _ in range(3):
        tstep(x, y)
    assert tstep.n_traces == 1 and ttr.optimizer.num_update == 3
    rtr = TTrainer(dict(ref.named_parameters()), "adam", dict(kw))
    rstep = rtr.compile_step(lambda a, b: tlb(ref(a), b))
    for _ in range(3):
        rstep(x, y)
    for a, b in zip(tnet.parameters(), ref.parameters()):
        assert torch.equal(a, b)


def test_save_and_load_states_between_steps_vs_jax(tmp_path):
    """Two steps, save_states, load_states into the same trainer (new
    state tensors: the port's next call captures again, and says why),
    a third step: weights and counts as the JAX package's."""
    jnet, tnet = _two_pair()
    kw = {"learning_rate": 0.05, "wd": 0.01}
    out, (jtr, ttr), (jstep, tstep) = _steps(
        jnet, tnet, "adam", kw, [_batch(seed=s) for s in (1, 2)])
    jf, tf = str(tmp_path / "j.states"), str(tmp_path / "t.states")
    jtr.save_states(jf)
    ttr.save_states(tf)
    jtr.load_states(jf)
    ttr.load_states(tf)
    x, y = _batch(seed=3)
    jstep(mx.nd.array(x), mx.nd.array(y))
    tstep(x, y)
    assert tstep.n_traces == 2
    assert "moved" in tstep.explain_retrace()
    _same_params(jnet, tnet)
    assert ttr.optimizer.num_update == jtr._optimizer.num_update == 3
    # the file the port wrote loads into the JAX trainer too
    jtr.load_states(tf)
    assert jtr._optimizer.num_update == 2


def test_one_call_is_one_eager_step():
    """After one call the update counts are 1 and the weights are one
    eager step's (loss.sum().backward(); trainer.step) bit for bit: the
    same SGD-momentum arithmetic. (``c``, which the loss does not reach,
    is left out: the eager step would refuse its stale gradient.)"""
    _, tnet = _two_pair()
    _, ref = _two_pair()
    x, y = _batch()
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}

    ttr = TTrainer(_reached(dict(tnet.named_parameters())), "sgd",
                   dict(kw))
    rtr = TTrainer(_reached(dict(ref.named_parameters())), "sgd", dict(kw))
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = ttr.compile_step(lambda a, b: lb(tnet(a), b))
    loss = step(x, y)
    assert ttr.optimizer._index_update_count == {i: 1 for i in range(4)}
    rl = lb(ref(torch.from_numpy(x)), torch.from_numpy(y))
    rl.sum().backward()
    rtr.step(x.shape[0])
    assert torch.equal(loss, rl.detach())
    for (k, a), b in zip(tnet.named_parameters(), ref.parameters()):
        assert torch.equal(a, b), k


def test_warmup_scope_puts_weights_states_and_generators_back():
    """What a capture's warm-up runs inside: two runs of a step body
    whose forward draws dropout masks from an explicit generator and from
    the default one. The body skips its update there, so the weight and
    its state are as they were, and both generators are put back; the
    generator is named for the graph only if it is a CUDA one. The same
    body outside the scope updates."""
    w, st = torch.nn.Parameter(torch.ones(8)), torch.zeros(8)
    gen = torch.Generator().manual_seed(3)
    drop = Dropout(0.5, generator=gen)

    @torch.no_grad()
    def update(grads):
        w.sub_(grads[0])
        st.add_(1.0)

    def loss_fn(x):
        return (drop(x) * w + torch.rand(8)).reshape(2, 4).sum(1)

    warming, leaves = [False], []
    treedef = tfs._flatten(((torch.ones(8),), {}), leaves)
    body = tfs._step_body(loss_fn, treedef, (tfs._TRACED,), [w], update,
                          [], warming)
    before = (w.detach().clone(), st.clone(), gen.get_state(),
              torch.get_rng_state())
    with tfs._warmup_scope(warming, torch.device("cpu")) as gens:
        assert warming == [True]
        for _ in range(2):
            body(torch.ones(8))
    assert warming == [False]
    assert torch.equal(w, before[0]) and torch.equal(st, before[1])
    assert torch.equal(gen.get_state(), before[2])
    assert torch.equal(torch.get_rng_state(), before[3])
    assert gens == []           # a CPU generator: no graph to register
    body(torch.ones(8))
    assert not torch.equal(w, before[0]) and torch.equal(st, torch.ones(8))
    with recording_draws() as outer, recording_draws() as inner:
        drop(torch.ones(2))
    assert list(outer) == list(inner) == [id(drop)]
    assert outer[id(drop)][1] is gen


def test_training_flags_are_part_of_the_signature():
    """A dropout layer switched to eval mode makes a program of its own
    (on a card the graph froze its masks); switched back, the first is
    used again."""
    net = torch.nn.Sequential(Dense(8, in_units=4, device="cpu"),
                              Dropout(0.5), Dense(3, in_units=8,
                                                  device="cpu"))
    tr = TTrainer(dict(net.named_parameters()), "adam",
                  {"learning_rate": 0.01})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    x, y = _batch()
    for _ in range(2):
        step(x, y)
    assert step.n_traces == 1
    net.eval()
    step(x, y)
    assert step.n_traces == 2
    assert "train_mode changed ((True,) -> (False,))" in \
        step.explain_retrace()
    net.train()
    step(x, y)
    assert step.n_traces == 2


def test_moved_parameters_make_a_new_program():
    _, tnet = _two_pair()
    tr = TTrainer(dict(tnet.named_parameters()), "sgd",
                  {"learning_rate": 0.1})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(tnet(a), b))
    x, y = _batch()
    step(x, y)
    with torch.no_grad():
        tnet.a.weight.data = tnet.a.weight.data.clone()
    step(x, y)
    assert step.n_traces == 2 and "moved" in step.explain_retrace()
    step(x, y)
    assert step.n_traces == 2


def test_mode_decision_follows_the_jax_package():
    """fused on one device; eager for bf16 parameters under
    multi_precision (their float32 masters), as the JAX _decide_mode."""
    _, tnet = _two_pair()
    lb = tloss.SoftmaxCrossEntropyLoss()
    tr = TTrainer(dict(tnet.named_parameters()), "adam",
                  {"learning_rate": 0.01, "multi_precision": True})
    step = tr.compile_step(lambda a, b: lb(tnet(a), b))
    x, y = _batch()
    step(x, y)
    assert step.mode == "fused"        # float32: no master
    tnet.to(torch.bfloat16)
    tr = TTrainer(_reached(dict(tnet.named_parameters())), "adam",
                  {"learning_rate": 0.01, "multi_precision": True})
    step = tr.compile_step(lambda a, b: lb(tnet(a).float(), b))
    step(torch.from_numpy(x).to(torch.bfloat16), y)
    assert step.mode == "eager" and step.n_traces == 0


# ---------------------------------------------------------------------------
# opt_update's device-scalar form and the hyperparameter block
# ---------------------------------------------------------------------------

KINDS = [("sgd", {"momentum": 0.0}), ("sgd", {"momentum": 0.9}),
         ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})]


@pytest.mark.parametrize("kind,extra", KINDS)
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opt_update_plain_device_scalars_equal_host_scalars(kind, extra,
                                                            clip, dtype):
    """lr, wd, t, the rescale and the clip as 0-d tensors (what a
    captured step passes, element i of the hyperparameter block) give
    the host scalars' result bit for bit, through unit_update_plain and
    through unit_update on the CPU."""
    r = onp.random.RandomState(5)
    n = 37
    w = torch.from_numpy(r.randn(n).astype("f4")).to(dtype)
    g = torch.from_numpy(3 * r.randn(n).astype("f4")).to(dtype)
    n_states = 0 if extra.get("momentum") == 0.0 else \
        (1 if kind == "sgd" else 2)
    states = tuple(torch.from_numpy(0.1 * r.rand(n).astype("f4")).to(dtype)
                   for _ in range(n_states))
    cfg = dict(extra, has_clip=clip)
    host = (0.05, 0.01, 3, 0.25, 0.5)
    hp = DeviceHParams(2, "cpu")
    hp.stage([0.7, host[0]], [0.0, host[1]], [9, host[2]], host[3], host[4])
    lrs, wds, ts = hp.per_param()
    dev_args = (lrs[1], wds[1], ts[1], hp.rescale, hp.clip)
    pw, ps = topu.unit_update_plain(kind, cfg, w, g, *host, states)
    dw, ds = topu.unit_update_plain(kind, cfg, w, g, *dev_args, states)
    assert torch.equal(pw, dw)
    assert all(torch.equal(a, b) for a, b in zip(ps, ds))
    kw, ks = w.clone(), tuple(s.clone() for s in states)
    topu.unit_update(kind, cfg, kw, g, *dev_args, ks)
    assert torch.equal(kw, pw)
    assert all(torch.equal(a, b) for a, b in zip(ks, ps))


def test_device_hparams_block_layout():
    """One int32 buffer: (P,) lr, (P,) wd, (P,) t, rescale, clip; element
    i's 0-d views point into it at offset i."""
    hp = DeviceHParams(3, "cpu")
    hp.stage(onp.float32([0.1, 0.2, 0.3]), [0.0, 0.5, 1.0], [1, 2, 7],
             0.125, 2.5)
    lrs, wds, ts = hp.per_param()
    base = hp.buf.data_ptr()
    for i in range(3):
        assert lrs[i].data_ptr() == base + 4 * i
        assert wds[i].data_ptr() == base + 4 * (3 + i)
        assert ts[i].data_ptr() == base + 4 * (6 + i)
        assert lrs[i].ndim == 0 and ts[i].dtype == torch.int32
    assert [float(v) for v in lrs] == [onp.float32(v) for v in
                                       (0.1, 0.2, 0.3)]
    assert [int(v) for v in ts] == [1, 2, 7]
    assert float(hp.rescale) == 0.125 and float(hp.clip) == 2.5
    hp.stage([0.0] * 3, [0.0] * 3, [4] * 3, 1.0, 0.0)
    assert [int(v) for v in ts] == [4, 4, 4]       # the same views, read anew


def test_a_device_scalar_of_the_wrong_dtype_is_refused_before_launch():
    with pytest.raises(mxt.MXNetError, match="device scalar t must be"):
        topu._dev_scalar("t", torch.zeros((), dtype=torch.float32),
                         torch.int32, torch.device("cpu"))
