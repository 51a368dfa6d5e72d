"""``mxnet_tpu_torch.initializer`` / ``init``, ``gluon.block.initialize``
with the layers' initializer keywords, and ``mxnet_tpu_torch.metric``,
against the JAX package.

Initializers: the deterministic ones (``Zero``, ``One``, ``Constant``,
``Bilinear``, ``LSTMBias``, ``Mixed``, ``Load`` and the name-suffix
rules) bit for bit; the random ones by their law, their scale from the
same fans as the JAX package's (a draw of 200,000 values: the bound of a
uniform exactly, its std and a normal's within 1 %, the sampling spread
being 0.16 %); ``Orthogonal`` by ``W W^T = scale^2 I`` within 1e-5.
``initialize`` over a net against the JAX ``Block.initialize`` of the
same net bit for bit, where the values are deterministic.

Metrics: each of the JAX package's ``__all__`` on the same numpy inputs
(two batches each), the float64 host path to 1e-12 relative; on tensors
(the port's device path, the JAX package's jax arrays) within 1e-5
relative (float32 sums in another order).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import initializer as jinit
from mxnet_tpu import metric as jmetric
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch.gluon import initialize
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _jax(ini, name, shape):
    return onp.asarray(ini.init_array(name, shape, "float32")._data)


def _port(ini, name, shape, seed=None):
    g = None if seed is None else torch.Generator().manual_seed(seed)
    return ini.init_array(name, shape, torch.float32, g).numpy()


DETERMINISTIC = [
    ("Zero", {}, "fc_weight", (3, 4)), ("One", {}, "fc_weight", (3, 4)),
    ("Constant", {"value": 0.25}, "fc_weight", (5,)),
    ("Bilinear", {}, "up_weight", (2, 1, 4, 4)),
    ("Bilinear", {}, "up_weight", (1, 2, 3, 5)),
    ("LSTMBias", {"forget_bias": 2.0}, "lstm_i2h_weight", (16,)),
    # the suffix rules, whatever the initializer
    ("Uniform", {}, "dense0_bias", (4,)), ("Normal", {}, "ln_beta", (4,)),
    ("Xavier", {}, "bn_gamma", (4,)), ("One", {}, "bn_running_mean", (3,)),
    ("Zero", {}, "bn_running_var", (3,)), ("One", {}, "x_moving_mean", (2,)),
    ("Zero", {}, "x_moving_var", (2,)),
]


@pytest.mark.parametrize("cls,kw,name,shape", DETERMINISTIC)
def test_deterministic_initializers_bit_equal(cls, kw, name, shape):
    got = _port(getattr(tinit, cls)(**kw), name, shape)
    ref = _jax(getattr(jinit, cls)(**kw), name, shape)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    onp.testing.assert_array_equal(got, ref)


def test_registry_and_create_like_jax():
    assert sorted(tinit.registry) == sorted(jinit.registry)
    for name in tinit.registry:
        assert type(tinit.create(name)).__name__ == \
            type(jinit.create(name)).__name__
    assert isinstance(tinit.create(None), tinit.Uniform)
    x = tinit.Xavier(magnitude=2)
    assert tinit.create(x) is x
    assert tinit.create("constant", value=3.0).value == 3.0
    assert mxt.init.MSRAPrelu is tinit.MSRAPrelu
    with pytest.raises(mxt.MXNetError, match="unknown initializer"):
        tinit.create("nope")
    d = tinit.InitDesc("w", attrs={"a": 1})
    assert d == "w" and d.attrs == {"a": 1}


def test_mixed_and_load_bit_equal():
    pats, inis = ["^.*bias$", ".*"], ["one", tinit.Constant(0.5)]
    jm = jinit.Mixed(pats, ["one", jinit.Constant(0.5)])
    tm = tinit.Mixed(pats, inis)
    for name, shape in (("fc_bias", (3,)), ("fc_weight", (3, 2)),
                        ("bn_gamma", (3,))):
        onp.testing.assert_array_equal(_port(tm, name, shape),
                                       _jax(jm, name, shape))
    with pytest.raises(mxt.MXNetError, match="no initializer pattern"):
        tinit.Mixed(["^a$"], ["one"]).init_array("b", (1,))
    saved = {"arg:fc_weight": onp.arange(6, dtype="f4").reshape(3, 2),
             "fc_bias": onp.full(3, 7.0, "f4")}
    jl = jinit.Load({k: mx.nd.array(v) for k, v in saved.items()},
                    default_init="one")
    tl = tinit.Load({k: torch.from_numpy(v) for k, v in saved.items()},
                    default_init="one")
    for name, shape in (("fc_weight", (3, 2)), ("fc_bias", (3,)),
                        ("other_weight", (2,)), ("other_bias", (2,))):
        onp.testing.assert_array_equal(_port(tl, name, shape),
                                       _jax(jl, name, shape))
    with pytest.raises(mxt.MXNetError, match="shape"):
        tl.init_array("fc_weight", (2, 3))
    with pytest.raises(mxt.MXNetError, match="no saved array"):
        tinit.Load({}).init_array("w", (1,))


N_LAW = 200_000


@pytest.mark.parametrize("ini,shape", [
    (("Uniform", {"scale": 0.3}), (400, 500)),
    (("Normal", {"sigma": 0.02}), (400, 500)),
    (("Xavier", {}), (400, 500)),
    (("Xavier", {"rnd_type": "gaussian", "factor_type": "in",
                 "magnitude": 2}), (200, 100, 10)),
    (("Xavier", {"factor_type": "out"}), (100, 50, 2, 20)),
    (("MSRAPrelu", {}), (256, 96, 3, 3)),
    (("MSRAPrelu", {"factor_type": "in", "slope": 0.0}), (512, 64, 3, 3)),
])
def test_random_initializers_by_law(ini, shape):
    """The bound or std from the JAX package's formula and fans; values
    within the bound, mean ~0, std within 1 %; the same generator seed
    gives the same values, another seed others."""
    cls, kw = ini
    t, j = getattr(tinit, cls)(**kw), getattr(jinit, cls)(**kw)
    if cls == "Uniform":
        bound, std = kw["scale"], kw["scale"] / 3 ** 0.5
    elif cls == "Normal":
        bound, std = None, kw["sigma"]
    else:
        fan_in, fan_out = j._fans(shape)
        assert t.fans(shape) == (fan_in, fan_out)
        factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
                  "out": fan_out}[j.factor_type]
        s = (j.magnitude / factor) ** 0.5
        assert t.scale(shape) == pytest.approx(s, rel=1e-12)
        uniform = j.rnd_type == "uniform"
        bound, std = (s, s / 3 ** 0.5) if uniform else (None, s)
    v = _port(t, "conv0_weight", shape, seed=1)
    assert v.shape == shape and v.size >= N_LAW
    assert abs(v.mean()) < 5 * std / v.size ** 0.5
    assert v.std() == pytest.approx(std, rel=0.01)
    if bound is not None:
        assert v.min() >= -bound and v.max() <= bound
        assert v.max() > 0.999 * bound
    onp.testing.assert_array_equal(v, _port(t, "w", shape, seed=1))
    assert not onp.array_equal(v, _port(t, "w", shape, seed=2))


@pytest.mark.parametrize("shape,rand_type", [((6, 10), "uniform"),
                                             ((10, 6), "normal"),
                                             ((4, 2, 3), "uniform")])
def test_orthogonal_by_its_gram_matrix(shape, rand_type):
    scale = 1.414
    w = _port(tinit.Orthogonal(scale, rand_type), "w", shape, seed=3)
    jw = _jax(jinit.Orthogonal(scale, rand_type), "w", shape)
    assert w.shape == jw.shape == shape
    for m in (w, jw):
        m = m.reshape(shape[0], -1).astype("f8")
        gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        onp.testing.assert_allclose(gram, scale ** 2 * onp.eye(len(gram)),
                                    atol=1e-5)


def _nets(**kw):
    """One net in each package: Dense -> BatchNorm -> LayerNorm -> Dense
    (the JAX one given its shapes by a forward), the keyword initializers
    ``kw`` on the first Dense."""
    j = jnn.HybridSequential()
    j.add(jnn.Dense(4, in_units=3, **kw), jnn.BatchNorm(in_channels=4),
          jnn.LayerNorm(in_channels=4), jnn.Dense(2, in_units=4))
    t = tnn.Sequential(tnn.Dense(4, in_units=3, device="cpu", **kw),
                       tnn.BatchNorm(in_channels=4, device="cpu"),
                       tnn.LayerNorm(in_channels=4, device="cpu"),
                       tnn.Dense(2, in_units=4, device="cpu"))
    return j, t


@pytest.mark.parametrize("init,kw", [
    (tinit.Constant(0.5), {}),
    (tinit.One(), {"weight_initializer": "zeros", "bias_initializer": "ones"}),
    (tinit.Mixed(["^bias$", ".*"], [tinit.Constant(2.0), "one"]), {}),
    (tinit.Load({"weight": onp.ones((4, 3), "f4")}, default_init="one"),
     {}),
])
def test_initialize_vs_jax_block_initialize(init, kw):
    """``initialize(net, init)`` against the JAX ``net.initialize(init)``:
    a layer keyword (a Dense bias's default "zeros", BatchNorm's and
    LayerNorm's gamma "ones" and beta "zeros", the running statistics)
    wins over ``init`` and takes no suffix rule; the others take
    ``init_array`` under their own names. Load's dict is keyed by those
    names (a weight of another shape raises: the second Dense's)."""
    jcls = {tinit.Constant: lambda i: jinit.Constant(i.value),
            tinit.One: lambda i: jinit.One(),
            tinit.Mixed: lambda i: jinit.Mixed(["^bias$", ".*"],
                                               [jinit.Constant(2.0), "one"]),
            tinit.Load: lambda i: jinit.Load(
                {"weight": mx.nd.array(onp.ones((4, 3), "f4"))},
                default_init="one")}[type(init)]
    j, t = _nets(**kw)
    if isinstance(init, tinit.Load):
        with pytest.raises(mxt.MXNetError, match="shape"):
            initialize(t, init)
        with pytest.raises(Exception, match="shape"):
            j.initialize(jcls(init))
        return
    j.initialize(jcls(init))
    j(mx.nd.array(onp.zeros((2, 3), "f4")))
    initialize(t, init)
    jp = {k: p.data().asnumpy() for k, p in j.collect_params().items()}
    tp = {k: p.detach().numpy() for k, p in t.named_parameters()}
    assert sorted(jp) == sorted(tp)
    for k in jp:
        onp.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


def test_initialize_in_place_and_force_reinit():
    """The values are written in place (storage and gradient hook kept):
    a second call without ``force_reinit`` leaves a parameter as it is,
    as does a loaded one; ``force_reinit`` writes again; random values
    follow the generator."""
    net = tnn.Sequential(tnn.Dense(8, in_units=6, device="cpu"),
                         tnn.Dense(2, in_units=8, device="cpu"))
    w = net[0].weight
    ptr = w.data_ptr()
    before = w.detach().clone()
    assert not w.initialized
    initialize(net, tinit.Xavier(), generator=torch.Generator()
               .manual_seed(4))
    assert w.data_ptr() == ptr and w.initialized
    assert not torch.equal(w.detach(), before)
    first = w.detach().clone()
    initialize(net, tinit.One())
    assert torch.equal(w.detach(), first)
    initialize(net, tinit.Xavier(), force_reinit=True,
               generator=torch.Generator().manual_seed(4))
    assert torch.equal(w.detach(), first) and w.data_ptr() == ptr
    assert torch.equal(net[0].bias.detach(), torch.zeros(8))
    net(torch.ones(3, 6)).sum().backward()
    assert w.fresh_grad and w.grad is not None
    mxt.gluon.params.load_jax_params(
        net, {k: onp.zeros(tuple(p.shape), "f4")
              for k, p in net.named_parameters()})
    fresh = tnn.Dense(2, in_units=8, device="cpu")
    assert not fresh.weight.initialized
    initialize(net, tinit.One())
    assert float(w.detach().abs().sum()) == 0.0


def test_layers_keep_their_initial_weights_and_take_keywords():
    """Without keywords a layer starts as before (uniform in [-0.07,
    0.07] from its generator, biases 0, gamma 1); a keyword gives the
    initial value and is recorded as the parameter's ``init``; the conv
    and recurrent layers take theirs."""
    g = torch.Generator().manual_seed(5)
    ref = torch.empty(4, 3).uniform_(-0.07, 0.07, generator=g)
    d = tnn.Dense(4, in_units=3, device="cpu",
                  generator=torch.Generator().manual_seed(5))
    assert torch.equal(d.weight.detach(), ref)
    assert d.weight.init is None and d.bias.init == "zeros"
    d2 = tnn.Dense(4, in_units=3, device="cpu", weight_initializer="ones",
                   bias_initializer=tinit.Constant(0.5))
    assert torch.equal(d2.weight.detach(), torch.ones(4, 3))
    assert torch.equal(d2.bias.detach(), torch.full((4,), 0.5))
    bn = tnn.BatchNorm(in_channels=3, device="cpu", gamma_initializer="zeros",
                       running_variance_initializer=tinit.Constant(2.0))
    assert torch.equal(bn.gamma.detach(), torch.zeros(3))
    assert torch.equal(bn.running_var.detach(), torch.full((3,), 2.0))
    conv = tnn.Conv2D(4, 3, in_channels=2, device="cpu",
                      weight_initializer=tinit.MSRAPrelu(),
                      generator=torch.Generator().manual_seed(6))
    assert conv.weight.init is not None and conv.bias.init == "zeros"
    lstm = trnn.LSTM(8, input_size=4, device="cpu",
                     i2h_bias_initializer=tinit.LSTMBias(1.0))
    b = lstm.l0_i2h_bias.detach()
    assert torch.equal(b[8:16], torch.ones(8)) and float(b.sum()) == 8.0
    assert lstm.l0_h2h_bias.init == "zeros"
    emb = tnn.Embedding(10, 4, device="cpu", weight_initializer="zeros")
    ln = tnn.LayerNorm(in_channels=4, device="cpu", beta_initializer="ones")
    assert float(emb.weight.detach().abs().sum()) == 0.0
    assert torch.equal(ln.beta.detach(), torch.ones(4))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _softmax(a):
    e = onp.exp(a - a.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype("f4")


def _batches(kind, seed):
    r = onp.random.RandomState(seed)
    out = []
    for _ in range(2):
        if kind == "classes":
            out.append((r.randint(0, 5, 16).astype("f4"),
                        _softmax(r.randn(16, 5))))
        elif kind == "binary":
            out.append((r.randint(0, 2, 16).astype("f4"),
                        _softmax(r.randn(16, 2))))
        elif kind == "prob":
            out.append((r.randint(0, 2, 16).astype("f4"),
                        r.rand(16).astype("f4")))
        elif kind == "regression":
            out.append((r.randn(16, 3).astype("f4"),
                        r.randn(16, 3).astype("f4")))
        elif kind == "loss":
            out.append((None, r.rand(16).astype("f4")))
    return out


METRICS = [
    ("Accuracy", {}, "classes"), ("TopKAccuracy", {"top_k": 3}, "classes"),
    ("MAE", {}, "regression"), ("MSE", {}, "regression"),
    ("RMSE", {}, "regression"), ("CrossEntropy", {}, "classes"),
    ("NegativeLogLikelihood", {}, "classes"), ("Perplexity", {}, "classes"),
    ("Perplexity", {"ignore_label": 2}, "classes"), ("F1", {}, "binary"),
    ("Fbeta", {"beta": 2.0}, "binary"), ("MCC", {}, "binary"),
    ("PearsonCorrelation", {}, "regression"), ("PCC", {}, "classes"),
    ("Loss", {}, "loss"), ("Torch", {}, "loss"), ("Caffe", {}, "loss"),
    ("BinaryAccuracy", {"threshold": 0.4}, "prob"),
    ("MeanPairwiseDistance", {}, "regression"),
    ("MeanPairwiseDistance", {"p": 1}, "regression"),
    ("MeanCosineSimilarity", {}, "regression"),
]


def _feed(m, batches, wrap):
    for label, pred in batches:
        m.update(None if label is None else wrap(label), wrap(pred))
    return m.get()


@pytest.mark.parametrize("name,kw,kind", METRICS)
@pytest.mark.parametrize("inputs", ["numpy", "tensors"])
def test_metric_vs_jax(name, kw, kind, inputs):
    """Two batches; the name and value against the JAX package's. On
    tensors the device-path metrics keep a float32 tensor sum (no host
    read before ``get``) and a host int count."""
    batches = _batches(kind, 7)
    jm, tm = getattr(jmetric, name)(**kw), getattr(tmetric, name)(**kw)
    if inputs == "numpy":
        jname, jv = _feed(jm, batches, lambda a: a)
        tname, tv = _feed(tm, batches, lambda a: a)
        rtol = 1e-12
    else:
        jname, jv = _feed(jm, batches, mx.nd.array)
        tm_sum = None
        for label, pred in batches:
            tm.update(None if label is None else torch.from_numpy(label),
                      torch.from_numpy(pred))
            tm_sum = getattr(tm, "sum_metric", None)
        host = name in ("PCC", "PearsonCorrelation") or \
            kw.get("ignore_label") is not None
        if not host and name not in ("F1", "Fbeta", "MCC"):
            assert isinstance(tm_sum, torch.Tensor) and \
                tm_sum.dtype == torch.float32
        tname, tv = tm.get()
        rtol = 1e-5
    assert tname == jname
    assert tm.num_inst == jm.num_inst
    assert tv == pytest.approx(jv, rel=rtol, abs=rtol)


def test_composite_custom_np_and_create_like_jax():
    batches = _batches("classes", 8)

    def feval(label, pred):
        return float((pred.argmax(-1) == label).sum()), len(label)

    for make in (lambda mod: mod.create(["acc", "ce", "top_k_accuracy"]),
                 lambda mod: mod.create(feval, name="hits"),
                 lambda mod: mod.np(lambda l, p: float(p.max()), "pmax"),
                 lambda mod: mod.CompositeEvalMetric(["acc", "nll_loss"])):
        jm, tm = make(jmetric), make(tmetric)
        for wrap in (lambda a: a, torch.from_numpy):
            tm.reset()
            jm.reset()
            tn, tv = _feed(tm, batches, wrap)
            jn, jv = _feed(jm, batches, lambda a: a)
            assert tn == jn
            assert onp.allclose(tv, jv, rtol=1e-5, atol=1e-6)
    assert sorted(tmetric._registry) == sorted(jmetric._registry)
    for k in tmetric._registry:
        assert tmetric._registry[k].__name__ == jmetric._registry[k].__name__
    assert set(tmetric.__all__) == set(jmetric.__all__)
    with pytest.raises(mxt.MXNetError, match="unknown metric"):
        tmetric.create("nope")
    acc = tmetric.Accuracy()
    assert tmetric.create(acc) is acc
    assert acc.get()[1] != acc.get()[1]          # nan before any update
