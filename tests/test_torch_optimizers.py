"""The port's optimizers beyond the three-step parity of
``test_torch_train.py``: ``multi_precision`` bf16 masters for each rule
and ``update_multi_precision`` against the JAX package; a
non-elementwise rule (``GroupAdaGrad``) on a 3-d weight through
``compile_step`` against the eager ``Trainer.step``; a small BERT trained
with LAMB (no weight decay on gamma, beta and bias, as GluonNLP's BERT
recipe) through ``compile_step`` against the eager loop and against the
JAX package's ``compile_step``; SGLD by its deterministic part and the
law of its noise; the ZeRO gate refusing a rule that is not elementwise;
the states of FTML, DCASGD, GroupAdaGrad and centered RMSProp through
``save_states`` / ``load_states`` and the checkpoint format, both ways
with the JAX package.

Tolerances: masters 1e-5 absolute and relative (float32 arithmetic on
the same bf16 inputs); the bf16 weight its own master's rounding; the
captured step against the eager one bit for bit (the same rule on the
same device scalars); BERT 2e-5 through the whole model, as in
``test_torch_train.py``; SGLD's deterministic part 1e-5, its noise mean
within 5 standard errors of 0 and its std within 1 % of sqrt(lr) over
200,000 draws (the std's own sampling spread is 0.16 %).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import loss as jloss
from test_torch_train import (MODEL_TOL, OPTIMIZERS, TOL, _batch, _bert_pair,
                              _close, _dense_pair)

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import loss as tloss

#: every registered rule with its defaults, SGLD aside (its noise is not
#: the JAX package's bits), then each non-default setting of
#: ``test_torch_train.OPTIMIZERS``
RULES = [(n, {}) for n in sorted(topt.optimizer._registry) if n != "sgld"] \
    + [c for c in OPTIMIZERS if len(c[1]) > 1]


def _mp_run(mod, nd, name, kwargs, steps=3):
    """Three multi-tensor updates of two parameters (bf16 with float32
    masters unless ``kwargs`` says otherwise; rescale and clip set); the
    weights and the updater."""
    r = onp.random.RandomState(11)
    ws = [r.randn(4, 3).astype("f4"), r.randn(5).astype("f4")]
    grads = [[r.randn(*w.shape).astype("f4") for w in ws]
             for _ in range(steps)]
    kwargs = dict({"multi_precision": True}, **kwargs)
    opt = mod.create(name, rescale_grad=0.5, clip_gradient=1.0, **kwargs)
    upd = mod.get_updater(opt)
    weights = [nd(w) for w in ws]
    for g in grads:
        upd([0, 1], [nd(a) for a in g], weights)
    return weights, upd


def _bf16(a):
    """``a`` rounded to bfloat16 and widened back (exact)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("name,kwargs", RULES)
def test_multi_precision_masters_vs_jax(name, kwargs):
    """The port's float32 masters equal the JAX package's, and each bf16
    weight is its master's rounding on both sides. AdaDelta is held to
    the JAX package's float32 update of the same bf16 values instead:
    the JAX package's multi-precision state starts as bf16 zeros, and
    its first step takes ``sqrt(acc_d + eps)`` on them in bfloat16 (eps
    rounded to bf16, 2**-9 relative), where the port's float32 state
    (``create_state_multi_precision``) takes it in float32."""
    tw, tu = _mp_run(topt, lambda a: torch.from_numpy(a).to(torch.bfloat16),
                     name, kwargs)
    if name == "adadelta":
        jw, _ = _mp_run(jopt, lambda a: mx.nd.array(_bf16(a)), name,
                        dict(kwargs, multi_precision=False))
        for i, a in enumerate(tw):
            _close(tu.states[i][1], jw[i], msg=f"{name} master {i}")
            assert torch.equal(a, tu.states[i][1].to(torch.bfloat16))
        return
    jw, ju = _mp_run(jopt, lambda a: mx.nd.array(a, dtype="bfloat16"),
                     name, kwargs)
    for i, a in enumerate(tw):
        assert a.dtype == torch.bfloat16
        tmaster, jmaster = tu.states[i][1], ju.states[i][1]
        _close(tmaster, jmaster, msg=f"{name} master {i}")
        assert torch.equal(a, tmaster.to(torch.bfloat16))
        onp.testing.assert_array_equal(
            onp.asarray(jw[i]._data.astype("float32")),
            onp.asarray(jmaster._data.astype("bfloat16").astype("float32")))


@pytest.mark.parametrize("name,kwargs", [
    ("nag", {"momentum": 0.9, "learning_rate": 0.1}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
    ("rmsprop", {"centered": True}), ("dcasgd", {"momentum": 0.5}),
])
@pytest.mark.parametrize("mp", [False, True])
def test_update_multi_precision_vs_jax(name, kwargs, mp):
    """``update_multi_precision(i, w, g, state)``, the single-parameter
    call of the JAX package's ``test_utils.compare_optimizer``, with and
    without bf16 masters: three calls a parameter, as that helper
    makes them."""
    r = onp.random.RandomState(12)
    dt = "bfloat16" if mp else "float32"
    tdt = torch.bfloat16 if mp else torch.float32
    jo = jopt.create(name, multi_precision=mp, **kwargs)
    to = topt.create(name, multi_precision=mp, **kwargs)
    for i, shape in enumerate([(3, 4), (7,)]):
        w = r.uniform(size=shape).astype("f4")
        jw, tw = mx.nd.array(w, dtype=dt), torch.from_numpy(w).to(tdt)
        js = jo.create_state_multi_precision(i, jw)
        ts = to.create_state_multi_precision(i, tw)
        for _ in range(3):
            g = r.uniform(size=shape).astype("f4")
            jo.update_multi_precision(i, jw, mx.nd.array(g, dtype=dt), js)
            to.update_multi_precision(i, tw, torch.from_numpy(g).to(tdt),
                                      ts)
        if mp:
            _close(ts[1], js[1], msg=name)
        else:
            _close(tw, jw, msg=name)
    assert to._index_update_count == jo._index_update_count


class _Cube(torch.nn.Module):
    """A 3-d weight (rows, k, j): ``y[n, r] = sum_kj x[n, k] W[r, k, j]``;
    then a Dense head."""

    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.cube = torch.nn.Parameter(torch.randn(6, 4, 3, generator=g))
        from mxnet_tpu_torch.gluon.nn import Dense
        self.head = Dense(3, in_units=6, device="cpu", generator=g)

    def forward(self, x):
        return self.head(torch.einsum("nk,rkj->nr", x, self.cube))


@pytest.mark.parametrize("name,kwargs", [
    ("groupadagrad", {"learning_rate": 0.1}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01, "lower_bound": 0.1}),
    ("lars", {"learning_rate": 0.1, "wd": 0.01}),
    ("sgld", {"learning_rate": 1e-3}),
])
def test_non_elementwise_rule_compile_step_equals_eager(name, kwargs):
    """A rule that is not elementwise gets each weight, gradient and
    state in its own shape in ``compile_step``'s whole update (a row
    mean of GroupAdaGrad's (6, 1, 1) history over a (6, 4, 3) weight, the
    norms of LAMB and LARS): three captured steps (on the CPU the body
    runs over the static buffers) equal three eager ``Trainer.step``s
    bit for bit, SGLD from the same generator state."""
    r = onp.random.RandomState(13)
    x = torch.from_numpy(r.randn(5, 4).astype("f4"))
    y = torch.from_numpy(r.randint(0, 3, 5).astype("f4"))
    lb = tloss.SoftmaxCrossEntropyLoss()
    runs = []
    for path in ("compile_step", "eager"):
        net = _Cube(0)
        kw = dict(kwargs)
        if name == "sgld":
            kw["generator"] = torch.Generator().manual_seed(3)
        tr = TTrainer(dict(net.named_parameters()), name, kw)
        step = tr.compile_step(lambda a, b: lb(net(a), b))
        for _ in range(3):
            if path == "compile_step":
                step(x, y)
            else:
                lb(net(x), y).sum().backward()
                tr.step(5)
        if path == "compile_step":
            assert step.mode == "fused" and step.n_traces == 1
        runs.append([p.detach().clone() for p in net.parameters()])
        states = tr._updater.states
        if name == "groupadagrad":
            assert tuple(states[0][0].shape) == (6, 1, 1)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _bert_lamb_trainer(mod, params, names):
    """LAMB at lr 1e-3, wd 0.01, with wd_mult 0 on every gamma, beta and
    bias (GluonNLP's BERT pretraining script)."""
    for n in names:
        if n.endswith(("gamma", "beta", "bias")):
            params[n].wd_mult = 0.0
    return mod(params, "lamb", {"learning_rate": 1e-3, "wd": 0.01})


@pytest.fixture(scope="module")
def jax_bert_lamb():
    """The JAX package's three LAMB steps through its ``compile_step``
    (once for both paths of the port): losses and parameters."""
    jnet, _, x = _bert_pair()
    y = onp.array([0, 2, 1, 1], "f4")
    jparams = jnet.collect_params()
    jtr = _bert_lamb_trainer(JTrainer, jparams, list(jparams))
    jlb = jloss.SoftmaxCrossEntropyLoss()
    jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b))
    xs, ys = mx.nd.array(x, dtype="int32"), mx.nd.array(y)
    losses = [jstep(xs, ys).asnumpy() for _ in range(3)]
    return losses, {k: p.data().asnumpy() for k, p in jparams.items()}, \
        sum(p.wd_mult == 0.0 for p in jparams.values())


@pytest.mark.parametrize("path", ["record", "compile_step"])
def test_bert_small_lamb_vs_jax_compile_step(path, jax_bert_lamb):
    """A small BERT classifier, three LAMB steps in the port (the eager
    loop or ``compile_step``) against the JAX package's
    ``compile_step``: the losses and the parameters within 2e-5, but for
    the key projections' biases (see below)."""
    jl, jparams, j_no_wd = jax_bert_lamb
    _, tnet, x = _bert_pair()
    y = onp.array([0, 2, 1, 1], "f4")
    w0 = {k: p.detach().numpy().copy() for k, p in tnet.named_parameters()}
    tparams = dict(tnet.named_parameters())
    ttr = _bert_lamb_trainer(TTrainer, tparams, list(tparams))
    tlb = tloss.SoftmaxCrossEntropyLoss()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tl = []
    if path == "compile_step":
        step = ttr.compile_step(lambda a, b: tlb(tnet(a), b))
        tl = [step(xt, yt).numpy() for _ in range(3)]
    else:
        for _ in range(3):
            loss = tlb(tnet(xt), yt)
            loss.sum().backward()
            ttr.step(4)
            tl.append(loss.detach().numpy())
    for a, b in zip(tl, jl):
        _close(a, b, MODEL_TOL)
    assert tl[-1].mean() < tl[0].mean()
    assert sum(p.wd_mult == 0.0 for p in tparams.values()) == j_no_wd > 0
    for k, p in jparams.items():
        if k.endswith("key_proj.bias"):
            # its true gradient is 0 (a per-query constant a softmax over
            # the keys drops); the computed one is rounding noise, whose
            # direction LAMB's trust ratio scales to a step of lr |w|:
            # held to that norm on both sides
            for w in (tparams[k].detach().numpy(), p):
                moved = onp.linalg.norm(w - w0[k]) / onp.linalg.norm(w0[k])
                assert 0 < moved <= 3 * 1e-3 * (1 + 1e-3), (k, moved)
            continue
        _close(tparams[k], p, MODEL_TOL, msg=k)


def test_sgld_deterministic_part_vs_jax_and_noise_law():
    """SGLD: the port's update minus its own noise (drawn again from a
    copy of the generator) equals the JAX package's minus its noise
    (``fold_in(PRNGKey(0x51D), t)``, drawn here as the JAX rule draws
    it), over three multi-tensor steps with wd, each from the same
    weights on both sides; then, with a zero
    gradient, the noise over 200,000 values has mean 0 and std sqrt(lr)
    (float32 lr)."""
    import jax
    import jax.numpy as jnp
    r = onp.random.RandomState(14)
    ws = [r.randn(4, 3).astype("f4"), r.randn(6).astype("f4")]
    lr, wd = 0.01, 0.1
    gen = torch.Generator().manual_seed(9)
    jo = jopt.SGLD(learning_rate=lr, wd=wd)
    to = topt.SGLD(learning_rate=lr, wd=wd, generator=gen)
    ju, tu = jopt.get_updater(jo), topt.get_updater(to)
    jw = [mx.nd.array(w) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    sq = torch.sqrt(torch.tensor(lr, dtype=torch.float32))
    for t in range(1, 4):
        g = [r.randn(*w.shape).astype("f4") for w in ws]
        copy = torch.Generator().set_state(gen.get_state())
        tnoise = [torch.randn(w.shape, generator=copy) * sq for w in ws]
        key = jax.random.fold_in(jax.random.PRNGKey(0x51D), t)
        jnoise = [onp.asarray(jax.random.normal(key, w.shape, jnp.float32)
                              * jnp.sqrt(jnp.float32(lr))) for w in ws]
        ju([0, 1], [mx.nd.array(a) for a in g], jw)
        tu([0, 1], [torch.from_numpy(a) for a in g], tw)
        for a, b, na, nb in zip(tw, jw, tnoise, jnoise):
            _close(a - na, b.asnumpy() - nb, TOL)
        # the next step starts both from the same weights (the noise
        # parted them)
        jw = [mx.nd.array(a.numpy()) for a in tw]
    big = torch.zeros(200_000)
    to2 = topt.SGLD(learning_rate=lr, generator=torch.Generator()
                    .manual_seed(10))
    to2.update(0, big, torch.zeros_like(big), ())
    std = float(big.std())
    assert abs(float(big.mean())) < 5 * std / (big.numel() ** 0.5)
    assert abs(std / float(sq) - 1) < 0.01


class _StubMesh:
    """What the ZeRO gate reads of a mesh: a ``dp`` axis of 2 spanning
    the group (the gate's decision alone; no process group)."""
    axis_names = ("dp",)
    shape = {"dp": 2}
    size = 2

    def check_axis(self, axis):
        return 2


@pytest.mark.parametrize("name", ["lamb", "lars", "lans", "groupadagrad",
                                  "sgld"])
def test_zero_shard_refuses_a_rule_that_is_not_elementwise(name):
    """``zero_shard=True`` with a rule that is not elementwise raises the
    JAX package's reason; the default (``zero_shard=None``) takes the
    ``mesh`` mode (a replicated update after an all-reduce); an
    elementwise rule (NAG) takes the ZeRO mode."""
    net = torch.nn.Sequential(mxt.gluon.nn.Dense(2, in_units=3,
                                                 device="cpu"))

    def step(opt, zero_shard):
        tr = TTrainer(dict(net.named_parameters()), opt)
        return tr.compile_step(lambda a, b: a, zero_shard=zero_shard,
                               mesh=_StubMesh())

    cls = type(topt.create(name)).__name__
    with pytest.raises(mxt.MXNetError) as err:
        step(name, True)._decide_mode()
    assert str(err.value) == (
        f"compile_step(zero_shard=True): {cls} update is not elementwise "
        "(cannot run on flat shards)")
    assert not topt.create(name).elementwise_update
    assert not jopt.create(name).elementwise_update
    assert step(name, None)._decide_mode() == "mesh"
    assert step("nag", None)._decide_mode() == "zero"


STATE_RULES = [("ftml", {"learning_rate": 0.01}),
               ("dcasgd", {"momentum": 0.9, "learning_rate": 0.1}),
               ("groupadagrad", {"learning_rate": 0.1}),
               ("rmsprop", {"centered": True, "learning_rate": 0.01})]


def _steps(jtr, ttr, jnet, tnet, n, seed):
    jl, tl = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    for i in range(n):
        x, y = _batch(seed + i)
        if jtr is not None:
            with jautograd.record():
                loss = jl(jnet(mx.nd.array(x)), mx.nd.array(y))
            loss.backward()
            jtr.step(5)
        if ttr is not None:
            tl(tnet(torch.from_numpy(x)), torch.from_numpy(y)).sum() \
                .backward()
            ttr.step(5)


@pytest.mark.parametrize("name,kwargs", STATE_RULES)
def test_states_round_trip_across_packages(tmp_path, name, kwargs):
    """Two steps in each package, then the states cross: the port's
    ``save_states`` loads into the JAX trainer and the JAX package's into
    the port's (``load_states``); two more steps on each side from the
    other's states end where a run of four steps on one side ends
    (within 1e-5). GroupAdaGrad's (rows, 1) history, DCASGD's copy of the
    weight, FTML's and centered RMSProp's three states keep their
    shapes."""
    ends = {}
    for order in ("port_then_jax", "jax_then_port", "jax_only"):
        jnet, tnet = _dense_pair()
        jtr = JTrainer(jnet.collect_params(), name, dict(kwargs))
        ttr = TTrainer(dict(tnet.named_parameters()), name, dict(kwargs))
        _steps(jtr, ttr, jnet, tnet, 2, 20)
        f = str(tmp_path / f"{order}.states")
        if order == "port_then_jax":
            ttr.save_states(f)
            jtr.load_states(f)
        elif order == "jax_then_port":
            jtr.save_states(f)
            ttr.load_states(f)
        _steps(jtr, ttr, jnet, tnet, 2, 30)
        ends[order] = ({k: p.data().asnumpy() for k, p in
                        jnet.collect_params().items()},
                       {k: p.detach().numpy().copy() for k, p in
                        tnet.named_parameters()})
        for i, p in enumerate(ttr._params):
            st = ttr._updater.states[i]
            shapes = [tuple(s.shape) for s in topt.Optimizer.state_tensors(st)]
            if name == "groupadagrad":
                assert shapes == [(p.shape[0],) + (1,) * (p.dim() - 1)]
            else:
                assert all(s == tuple(p.shape) for s in shapes)
    ref = ends["jax_only"][0]
    for order in ("port_then_jax", "jax_then_port"):
        for side in ends[order]:
            for k in ref:
                _close(side[k], ref[k], msg=f"{order} {k}")


@pytest.mark.parametrize("name,kwargs", STATE_RULES)
def test_states_through_the_checkpoint_format_both_ways(tmp_path, name,
                                                         kwargs):
    """The same states through the checkpoint format (each package's
    ``TrainCheckpointManager``): the port's checkpoint after two steps
    restored into a fresh JAX run and the JAX package's into a fresh port
    run, each then two more steps, end as the runs that never stopped
    (within 1e-5)."""
    from mxnet_tpu.checkpoint import TrainCheckpointManager as JMgr
    from mxnet_tpu_torch.checkpoint import TrainCheckpointManager as TMgr
    jnet, tnet = _dense_pair()
    jtr = JTrainer(jnet.collect_params(), name, dict(kwargs))
    ttr = TTrainer(dict(tnet.named_parameters()), name, dict(kwargs))
    _steps(jtr, ttr, jnet, tnet, 2, 40)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    TMgr(tdir, async_save=False).save(2, trainer=ttr, net=tnet)
    JMgr(jdir, async_save=False).save(2, trainer=jtr, net=jnet)
    jnet2, tnet2 = _dense_pair(seed=5)
    jtr2 = JTrainer(jnet2.collect_params(), name, dict(kwargs))
    ttr2 = TTrainer(dict(tnet2.named_parameters()), name, dict(kwargs))
    assert JMgr(tdir, async_save=False).restore_latest(
        trainer=jtr2, net=jnet2)["step"] == 2
    assert TMgr(jdir, async_save=False).restore_latest(
        trainer=ttr2, net=tnet2)["step"] == 2
    _steps(jtr, ttr, jnet, tnet, 2, 50)
    _steps(jtr2, ttr2, jnet2, tnet2, 2, 50)
    for k, p in jnet.collect_params().items():
        _close(jnet2.collect_params()[k].data(), p.data(), msg=k)
    for (k, p), p2 in zip(tnet.named_parameters(), tnet2.parameters()):
        _close(p2, p, msg=k)
