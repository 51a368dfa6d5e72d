"""bf16 mixed precision of mxnet_tpu_torch against the JAX package: the
op funnel and ``amp`` (init/uninit, the casting lists, ``LossScaler``,
``scale_loss``, ``convert_hybrid_block``), ``multi_precision`` in the
optimizers, and ``serving.predictor_for``.

The same numpy-seeded weights and inputs go through both packages; the
JAX side runs its Pallas kernels in interpret mode (``MXNET_PALLAS=on``),
the path whose casts the port follows (its FFN always takes the bias-GELU
kernel, so ``"bias_gelu_dense"`` stays float32 under amp in both).

amp is process-wide in both packages: every test that turns it on turns
it off in a fixture's teardown, which runs however the test ends.

Tolerances: results that pass through bf16 products agree to 2e-2 of
their largest value. bf16 keeps 8 bits of mantissa (2**-8 = 0.0039 of a
value per rounding); the two frameworks round the same sums at different
places (a fused bias add in torch, a separate one in XLA; other
accumulation orders), so a product's output may differ by an ulp and
that carries through two layers and three Adam steps. float32 masters of
one optimizer rule agree to 1e-6, their bf16 weights to one bf16 ulp.
"""
import contextlib

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.params import init_params_numpy, load_jax_params
from mxnet_tpu_torch.ops import nn as FNN
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.serving import predictor_for

BF16_TOL = 2e-2
SEQ, BATCH = 10, 4


@pytest.fixture
def amp_on():
    """amp on in both packages for the test, off after it."""
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    try:
        yield
    finally:
        jamp.uninit()
        tamp.uninit()


def _listed(name):
    return name in (jamp.TARGET_DTYPE_OPS | jamp.FP32_OPS | jamp.NORM_OPS) \
        or name.startswith("rnn_")


@contextlib.contextmanager
def _census():
    """(funnel name, output dtype) of every listed op, in call order, in
    each package: a recording wrapper installed after amp's, so it sees
    amp's casts."""
    log = {"jax": [], "torch": []}

    def recorder(side):
        def wrapper(name, fn):
            def rec(*a, **k):
                out = fn(*a, **k)
                first = out[0] if isinstance(out, (tuple, list)) else out
                if _listed(name):
                    log[side].append(
                        (name, str(first.dtype).replace("torch.", "")))
                return out
            return rec
        return wrapper

    jw, tw = recorder("jax"), recorder("torch")
    jreg.add_invoke_wrapper(jw)
    treg.add_invoke_wrapper(tw)
    try:
        yield log
    finally:
        jreg.remove_invoke_wrapper(jw)
        treg.remove_invoke_wrapper(tw)


def _tokens(n=BATCH, seed=1):
    return onp.random.RandomState(seed).randint(0, 128, (n, SEQ)) \
        .astype("int32")


def _classifier_pair(seed=0, **kw):
    """The same seeded float32 weights in a JAX and a port
    BERTClassifier over bert_small_test (dropout off)."""
    tnet = tbert.BERTClassifier(tbert.bert_small_test(dropout=0.0,
                                                      device="cpu", **kw),
                                num_classes=3, dropout=0.0, device="cpu")
    params = init_params_numpy(tnet, seed)
    load_jax_params(tnet, params)
    jnet = jbert.BERTClassifier(jbert.bert_small_test(dropout=0.0, **kw),
                                num_classes=3, dropout=0.0)
    jnet.initialize()
    jnet(mx.nd.array(_tokens(1), dtype="int32"))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    return jnet, tnet


def _close_bf16(a, b, msg=""):
    a = onp.asarray(a, onp.float32)
    b = onp.asarray(b, onp.float32)
    scale = max(float(onp.abs(b).max()), 1e-6)
    onp.testing.assert_allclose(a, b, rtol=0, atol=BF16_TOL * scale,
                                err_msg=msg)


def _np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy().astype(onp.float32)
    return x.detach().float().numpy()


# ---------------------------------------------------------------------------
# the funnel and the lists
# ---------------------------------------------------------------------------

def test_funnel_without_wrappers_is_the_call():
    calls = []
    assert treg.invoke("x", lambda a, b=1: a + b, 2, b=3) == 5

    def wrapper(name, fn):
        def w(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return w

    treg.add_invoke_wrapper(wrapper)
    try:
        assert treg.invoke("y", lambda a: a * 2, 4) == 8
    finally:
        treg.remove_invoke_wrapper(wrapper)
    treg.remove_invoke_wrapper(wrapper)      # removing twice is harmless
    assert treg.invoke("z", lambda: 1) == 1
    assert calls == ["y"]


def test_lists_are_the_jax_packages():
    assert tamp.TARGET_DTYPE_OPS == jamp.TARGET_DTYPE_OPS
    assert tamp.FP32_OPS == jamp.FP32_OPS
    assert tamp.NORM_OPS == jamp.NORM_OPS
    # the gelu FFN's fused product is in no list, in either package
    assert not _listed("bias_gelu_dense")


@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_casts_by_list(target):
    dt = {"bfloat16": torch.bfloat16, "float16": torch.float16}[target]
    x32 = torch.ones(2, 3)
    tamp.init(target)
    try:
        assert tamp.is_enabled()
        tamp.init(target)        # a second init is a no-op
        seen = {}

        def probe(name, x):
            return treg.invoke(name, lambda t: (seen.__setitem__(name,
                                                                 t.dtype),
                                                t)[1], x)

        assert probe("fully_connected", x32).dtype == dt
        assert probe("rnn_gru", x32).dtype == dt
        assert probe("softmax", x32.to(dt)).dtype == torch.float32
        # the port's softmaxes funnel under the JAX package's names
        assert FNN.softmax(x32.to(dt)).dtype == torch.float32
        assert FNN.log_softmax(x32.to(dt)).dtype == torch.float32
        # norms: float32-pinned under float16 only
        assert probe("layer_norm", x32.to(dt)).dtype == \
            (torch.float32 if target == "float16" else dt)
        # unlisted ops follow their inputs
        assert probe("embedding", x32).dtype == torch.float32
        assert probe("activation_relu", x32.to(dt)).dtype == dt
        # integer inputs are never cast
        assert probe("fully_connected", torch.ones(2, dtype=torch.int64)) \
            .dtype == torch.int64
    finally:
        tamp.uninit()
    assert not tamp.is_enabled()
    assert treg.invoke("fully_connected", lambda t: t, x32).dtype == \
        torch.float32
    with pytest.raises(mxt.MXNetError, match="unsupported AMP"):
        tamp.init("int8")


# ---------------------------------------------------------------------------
# BERT under amp: the dtype census, logits, three Adam steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_valid_length", [False, True])
def test_bert_dtype_census_and_logits_vs_jax(monkeypatch, amp_on,
                                             with_valid_length):
    monkeypatch.setenv("MXNET_PALLAS", "on")
    jnet, tnet = _classifier_pair()
    x = _tokens()
    vl = onp.array([10, 7, 3, 9], "int32") if with_valid_length else None
    with _census() as log:
        jl = jnet(mx.nd.array(x, dtype="int32"), None,
                  None if vl is None else mx.nd.array(vl, dtype="int32"))
        tl = tnet(torch.from_numpy(x), None,
                  None if vl is None else torch.from_numpy(vl))
    assert log["torch"] == log["jax"]
    attn = "flash_attention_vl" if with_valid_length else "flash_attention"
    layer = [("fully_connected", "bfloat16")] * 3 + \
        [(attn, "bfloat16"), ("fully_connected", "bfloat16"),
         ("layer_norm", "float32"), ("fully_connected", "bfloat16"),
         ("fully_connected", "bfloat16"), ("layer_norm", "float32")]
    # embedding LayerNorm, two layers, pooler, classifier
    assert log["torch"] == [("layer_norm", "float32")] + 2 * layer + \
        [("fully_connected", "bfloat16")] * 2
    assert tl.dtype == torch.bfloat16 and tl.shape == (BATCH, 3)
    _close_bf16(_np(tl), _np(jl))


def test_lstm_under_amp_vs_jax(monkeypatch, amp_on):
    """A small 2-layer LSTM: its funnel name "rnn_lstm" is a target op by
    prefix, so the input, states and weights go to bf16 and so do its
    outputs, in both packages."""
    monkeypatch.setenv("MXNET_PALLAS", "on")
    r = onp.random.RandomState(10)
    T, N, C, H = 5, 3, 4, 6
    x = r.randn(T, N, C).astype("f4")
    jl = jrnn.LSTM(H, num_layers=2, input_size=C)
    jl.initialize()
    with jamp_off():
        jl(mx.nd.array(x))
    # the JAX package's default initial weights (uniform in +-0.07, zero
    # biases), drawn from numpy: its own initializer reads the process's
    # mx.random state, which the tests run before this one in the same
    # worker decide
    w = onp.random.RandomState(11)
    params = {k: (onp.zeros(p.shape, "f4") if k.endswith("bias") else
                  w.uniform(-0.07, 0.07, p.shape).astype("f4"))
              for k, p in jl.collect_params().items()}
    for k, p in jl.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    tl = trnn.LSTM(H, num_layers=2, input_size=C, device="cpu")
    load_jax_params(tl, params)
    states = [(r.randn(2, N, H) * 0.5).astype("f4") for _ in range(2)]
    with _census() as log:
        jy, js = jl(mx.nd.array(x), [mx.nd.array(s) for s in states])
        ty, ts = tl(torch.from_numpy(x), [torch.from_numpy(s)
                                          for s in states])
    assert log["torch"] == log["jax"] == [("rnn_lstm", "bfloat16")]
    assert ty.dtype == torch.bfloat16 and all(
        s.dtype == torch.bfloat16 for s in ts)
    for a, b in zip([ty] + ts, [jy] + js):
        _close_bf16(_np(a), _np(b))
    # the gradient reaches the float32 weights, in float32
    ty.float().sum().backward()
    assert tl.l0_h2h_weight.grad.dtype == torch.float32


@contextlib.contextmanager
def jamp_off():
    """The JAX package without amp for a moment (its deferred shapes are
    inferred at a first float32 call)."""
    jamp.uninit()
    try:
        yield
    finally:
        jamp.init("bfloat16")


def test_bert_three_adam_steps_compile_step_vs_jax(monkeypatch, amp_on):
    """Three Adam steps through compile_step under amp: the losses within
    the bf16 tolerance of the JAX package's; parameters and gradients
    stay float32. Adam moves every element by about lr a step whatever
    its gradient's size, so where a gradient is near zero its bf16
    rounding can flip the step's sign in one framework only: a
    parameter's elements may then differ by up to 2 lr a step, and on
    average they must agree within the bf16 tolerance of the 3 lr they
    moved (observed: 5 of 24,515 elements past a tenth of it)."""
    monkeypatch.setenv("MXNET_PALLAS", "on")
    jnet, tnet = _classifier_pair()
    x = _tokens()
    y = onp.array([0, 2, 1, 1], "f4")
    hp = {"learning_rate": 1e-3, "wd": 0.01}
    jtr = JTrainer(jnet.collect_params(), "adam", dict(hp))
    ttr = TTrainer(dict(tnet.named_parameters()), "adam", dict(hp))
    jlb, tlb = jloss.SoftmaxCrossEntropyLoss(), \
        tloss.SoftmaxCrossEntropyLoss()
    jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b))
    tstep = ttr.compile_step(lambda a, b: tlb(tnet(a), b))
    jl, tl = [], []
    for _ in range(3):
        jl.append(jstep(mx.nd.array(x, dtype="int32"),
                        mx.nd.array(y)).asnumpy())
        tl.append(tstep(torch.from_numpy(x), torch.from_numpy(y)).numpy())
    for a, b in zip(tl, jl):
        assert a.dtype == onp.float32
        _close_bf16(a, b)
    assert tl[-1].mean() < tl[0].mean()
    tparams = dict(tnet.named_parameters())
    moved = 3 * hp["learning_rate"]
    for k, p in jnet.collect_params().items():
        assert tparams[k].dtype == torch.float32
        d = onp.abs(_np(tparams[k]) - _np(p.data()))
        assert d.max() <= 2 * moved, k
        assert d.mean() <= BF16_TOL * moved, k


def test_amp_gradients_vs_float64_within_the_card_check_bound():
    """The yardstick of chip_smoke.py phase 6b on the CPU: one backward of
    bert_small_test under amp against a float64 copy of the same weights
    (its attention float32: the plain version computes in float32). Every
    parameter within the bound phase 6b holds the card to
    (``GRAD_RTOL_BF16`` of its largest gradient, a bias's scaled by its
    weight's); float32 without amp within 1e-4 (rounding of float32
    sums), and amp's error bf16-sized, above float32's."""
    import chip_smoke as CS
    _, tnet = _classifier_pair()
    _, net64 = _classifier_pair()
    net64.double()
    x = _tokens()
    y = onp.array([0, 2, 1, 1], "f4")
    lf = tloss.SoftmaxCrossEntropyLoss()
    g64 = CS.param_grads(torch, net64, lf, x, y)
    assert all(g.dtype == torch.float64 for g in g64.values())
    g32 = CS.param_grads(torch, tnet, lf, x, y)
    tamp.init("bfloat16")
    try:
        g_amp = CS.param_grads(torch, tnet, lf, x, y)
    finally:
        tamp.uninit()
    res = CS.grad_check(torch, None, None, lf, x, y, atol=CS.GRAD_ATOL,
                        rtol=CS.GRAD_RTOL_BF16, scale_of=CS.bias_scale,
                        grads=(g_amp, g64))
    assert res["ok"] and res["params"] == len(g64), res
    f32 = CS.grad_errors(g32, g64, CS.bias_scale)
    amp = CS.grad_errors(g_amp, g64, CS.bias_scale)
    assert max(f32.values()) < 1e-4
    assert max(f32.values()) < max(amp.values()) < CS.GRAD_RTOL_BF16
    sides = CS.amp_vs_float64([CS.side_errors(g_amp, g_amp, g32, g64)],
                              {n: t.numel() for n, t in g64.items()})
    assert sides["batches"] == 1 and len(sides["per_param"]) == len(g64)
    for m in CS.F64_MEASURES:
        assert sides[m]["within_2x"] and sides[m]["median_ratio"] == 1.0
        assert sides[m]["max"]["cpu_float32"] < sides[m]["max"]["cpu_amp"]


# ---------------------------------------------------------------------------
# LossScaler and scale_loss
# ---------------------------------------------------------------------------

def test_loss_scaler_update_sequence_vs_jax():
    pattern = [False, True, False, False, False, True, True, False, False,
               False, False, False, False, False]
    for init in (1.0, 2. ** 16):
        js = jamp.LossScaler(init_scale=init, scale_window=3)
        ts = tamp.LossScaler(init_scale=init, scale_window=3)
        got, ref = [], []
        for ov in pattern:
            js.update_scale(ov)
            ts.update_scale(ov)
            ref.append(js.loss_scale)
            got.append(ts.loss_scale)
        assert got == ref


def test_has_overflow_vs_jax():
    r = onp.random.RandomState(0)
    grads = [r.randn(5, 3).astype("f4") for _ in range(4)]
    bad = [g.copy() for g in grads]
    bad[2][1, 1] = onp.inf
    nan = [g.copy() for g in grads]
    nan[3][0, 0] = onp.nan
    js, ts = jamp.LossScaler(), tamp.LossScaler()
    for gs in (grads, bad, nan, []):
        assert ts.has_overflow([torch.from_numpy(g) for g in gs]) == \
            js.has_overflow([mx.nd.array(g) for g in gs])
    # parameters: their .grad, None skipped
    ps = [torch.nn.Parameter(torch.zeros(5, 3)) for _ in range(4)]
    for p, g in zip(ps, bad):
        p.grad = torch.from_numpy(g)
    ps[0].grad = None
    assert ts.has_overflow(ps)
    ps[2].grad = None
    assert not ts.has_overflow(ps)


@pytest.mark.parametrize("init", [1.0, 2. ** 16])
def test_scale_loss_sets_trainer_scale_vs_jax(init):
    """scale_loss yields the scaled loss and sets trainer._scale against
    the original scale, step after step, as the scale moves."""
    jw = mx.gluon.Parameter("w", shape=(2,))
    jw.initialize()
    jtr = JTrainer({"w": jw}, "sgd", {"learning_rate": 0.1})
    ttr = TTrainer([torch.nn.Parameter(torch.zeros(2))], "sgd",
                   {"learning_rate": 0.1})
    for tr, mod in ((jtr, jamp), (ttr, tamp)):
        tr._amp_loss_scaler = mod.LossScaler(init_scale=init,
                                             scale_window=2)
    pattern = [False, False, True, False, False, False, True]
    loss = onp.array([0.5, 1.5], "f4")
    for ov in pattern:
        with jamp.scale_loss(mx.nd.array(loss), jtr) as jl, \
                tamp.scale_loss(torch.from_numpy(loss), ttr) as tl:
            onp.testing.assert_array_equal(tl.numpy(), jl.asnumpy())
        assert ttr._scale == jtr._scale
        jtr._amp_loss_scaler.update_scale(ov)
        ttr._amp_loss_scaler.update_scale(ov)
    assert ttr._amp_original_scale == jtr._amp_original_scale == 1.0


def test_init_trainer_attaches_a_scaler_like_jax(amp_on):
    jw = mx.gluon.Parameter("w", shape=(2,))
    jw.initialize()
    js = jamp.init_trainer(JTrainer({"w": jw}, "sgd"))
    tr = TTrainer([torch.nn.Parameter(torch.zeros(2))], "sgd")
    ts = tamp.init_trainer(tr)
    assert tr._amp_loss_scaler is ts
    assert ts.loss_scale == js.loss_scale == 1.0


# ---------------------------------------------------------------------------
# convert_hybrid_block and predictor_for
# ---------------------------------------------------------------------------

def test_convert_hybrid_block_casts_the_same_names_as_jax():
    jnet, tnet = _classifier_pair()
    params = dict(tnet.named_parameters())
    jamp.convert_hybrid_block(jnet)
    assert tamp.convert_hybrid_block(tnet) is tnet
    jcast = sorted(k for k, p in jnet.collect_params().items()
                   if p.dtype == "bfloat16")
    tcast = sorted(k for k, p in tnet.named_parameters()
                   if p.dtype == torch.bfloat16)
    assert tcast == jcast
    kept = sorted(set(params) - set(tcast))
    assert kept and all(k.endswith((".gamma", ".beta")) for k in kept)
    assert all(params[k].dtype == torch.float32 for k in kept)
    # the same Parameter objects, cast in place
    assert all(params[k] is p for k, p in tnet.named_parameters())


def test_predictor_for_bfloat16_logits_vs_jax(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "on")
    from mxnet_tpu.serving import predictor_for as jpredictor_for
    jnet, tnet = _classifier_pair()
    tnet.eval()
    x = _tokens()
    jpred = jpredictor_for(jnet, dtype="bfloat16", bucket_sizes=(BATCH,))
    tpred = predictor_for(tnet, dtype="bf16", bucket_sizes=(BATCH,),
                          device="cpu")
    jl = jpred.predict(mx.nd.array(x, dtype="int32"))
    tl = tpred.predict(x)
    assert tl.dtype == torch.bfloat16
    _close_bf16(_np(tl), _np(jl))


def test_predictor_for_float32_and_refusals():
    _, tnet = _classifier_pair()
    pred = predictor_for(tnet, dtype="float32", device="cpu")
    assert pred.net is tnet
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    with pytest.raises(mxt.MXNetError, match="contrib.quantization"):
        predictor_for(tnet, dtype="int8", device="cpu")
    with pytest.raises(mxt.MXNetError, match="unknown serving dtype"):
        predictor_for(tnet, dtype="int4", device="cpu")


# ---------------------------------------------------------------------------
# multi_precision
# ---------------------------------------------------------------------------

def _bf16_ulps(a, b):
    """Distance in bf16 ulps, elementwise (a, b bf16 values as float32)."""
    ia = onp.asarray(a, onp.float32).view(onp.int32).astype(onp.int64) >> 16
    ib = onp.asarray(b, onp.float32).view(onp.int32).astype(onp.int64) >> 16
    return onp.abs(ia - ib)


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 1e-2, "wd": 0.01}),
])
def test_multi_precision_updates_vs_jax(name, kwargs):
    """Three updates of a bf16 weight with a float32 master: the master
    within 1e-6 of the JAX package's, the bf16 weight equal to it or one
    bf16 ulp away (where a master lands within float32 rounding of a
    bf16 tie, the two frameworks' float32 rules can round it apart)."""
    r = onp.random.RandomState(3)
    w0 = r.randn(64).astype("f4")
    grads = [r.randn(64).astype("f4") * 0.5 for _ in range(3)]
    jo = jopt.create(name, multi_precision=True, **kwargs)
    to = topt.create(name, multi_precision=True, **kwargs)
    jw = mx.nd.array(w0).astype("bfloat16")
    tw = torch.from_numpy(w0).to(torch.bfloat16)
    jst = jo.create_state_multi_precision(0, jw)
    tst = to.create_state_multi_precision(0, tw)
    assert to.is_master_state(tw, tst)
    assert tst[1].dtype == torch.float32
    assert all(s.dtype == torch.float32 for s in tst[0])
    for g in grads:
        jo.update(0, jw, mx.nd.array(g).astype("bfloat16"), jst)
        to.update(0, tw, torch.from_numpy(g).to(torch.bfloat16), tst)
    onp.testing.assert_allclose(tst[1].numpy(), jst[1].asnumpy(),
                                rtol=1e-6, atol=1e-6)
    assert tw.dtype == torch.bfloat16
    assert _bf16_ulps(tw.float().numpy(),
                      jw.asnumpy().astype("f4")).max() <= 1
    # the weight is its master, rounded
    assert torch.equal(tw, tst[1].to(torch.bfloat16))
    # without multi_precision, or for a float32 weight, no master
    assert not to.is_master_state(
        tw, topt.create(name, **kwargs).create_state_multi_precision(0, tw))
    st32 = to.create_state_multi_precision(1, torch.zeros(3))
    assert not to.is_master_state(torch.zeros(3), st32)


def test_trainer_multi_precision_eager_vs_jax():
    """A bf16 Dense trained by Trainer.step with multi_precision, on
    both packages: the updater keeps (state, master) pairs, the weights
    stay bf16 and agree within the bf16 tolerance after three steps, and
    the compiled step takes the eager mode."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon.nn import Dense
    r = onp.random.RandomState(4)
    wts = {"weight": (r.randn(3, 4) * 0.5).astype("f4"),
           "bias": (r.randn(3) * 0.1).astype("f4")}
    jd = jnn.Dense(3, in_units=4)
    jd.initialize()
    for k, p in jd.collect_params().items():
        p.set_data(mx.nd.array(wts[k]))
        p.cast("bfloat16")
    td = Dense(3, in_units=4, device="cpu")
    load_jax_params(td, wts)
    td.to(torch.bfloat16)
    hp = {"learning_rate": 0.05, "momentum": 0.9, "multi_precision": True}
    jtr = JTrainer(jd.collect_params(), "sgd", dict(hp))
    ttr = TTrainer(dict(td.named_parameters()), "sgd", dict(hp))
    tstep = ttr.compile_step(lambda a: (td(a).float() ** 2).sum(-1))
    from mxnet_tpu import autograd as jag
    for i in range(3):
        x = r.randn(8, 4).astype("f4")
        with jag.record():
            jl = (jd(mx.nd.array(x).astype("bfloat16"))
                  .astype("float32") ** 2).sum(axis=-1)
        jl.backward()
        jtr.step(8)
        tstep(torch.from_numpy(x).to(torch.bfloat16))
    assert tstep.mode == "eager"
    for k, p in jd.collect_params().items():
        tp = dict(td.named_parameters())[k]
        assert tp.dtype == torch.bfloat16
        st = ttr._updater.states[next(i for i, q in enumerate(ttr._params)
                                      if q is tp)]
        assert topt.Optimizer.is_master_state(tp, st)
        _close_bf16(_np(tp), _np(p.data()), msg=k)
    # masters counted in the eager state bytes
    n = sum(p.numel() for p in td.parameters())
    assert tstep.optimizer_state_bytes() == 2 * 4 * n
