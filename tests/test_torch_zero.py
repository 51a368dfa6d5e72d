"""The ZeRO-1 data-parallel training path of mxnet_tpu_torch against the
JAX package: the fused optimizer update (kernel 12's plain version)
against ``unit_update(..., interpret=True)``, the sharded update's plan
and bucket schedule against the JAX ``_ZeroShardPlan``, the bucketed
routing, and four gloo ranks on the CPU against the JAX ZeRO step at
dp 4 (the 8-device virtual CPU mesh) and against the port's own eager
trainer.

JAX is imported inside the tests: the spawned ranks import this module
to find their worker functions, and need only torch.

Tolerances: the update's new states are bit-exact; so is the new weight,
except where Adam's bias correction ``1 - beta**t`` goes through float32
``pow``, which XLA's CPU backend and torch's CPU kernel may round apart:
there the weight may differ by 2 ulps. Training runs across ranks
compare at the JAX ZeRO test's own tolerances (losses atol 1e-5,
parameters rtol 1e-4 / atol 1e-5): the gradient's sum over ranks is
taken in another order than the one-program sum.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import TrainLoop
from mxnet_tpu_torch.gluon import fused_step as tfs
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.gluon.params import init_params_numpy, load_jax_params
from mxnet_tpu_torch.ops.kernels import opt_update as topu
from mxnet_tpu_torch.parallel import collectives as tcoll
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.parallel import make_mesh as tmake_mesh

DP = 4
SPAWN_TIMEOUT_S = 90
P = 5000                     # a ragged unit: not a multiple of 4 or 128

OPT_CASES = {
    "sgd": ("sgd", {"momentum": 0.0}, 0),
    "sgd_mom": ("sgd", {"momentum": 0.9}, 1),
    "adam": ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, 2),
}


def _ulps(a, b):
    """Distance in float32 ulps, elementwise."""
    ia = onp.asarray(a, onp.float32).view(onp.int32).astype(onp.int64)
    ib = onp.asarray(b, onp.float32).view(onp.int32).astype(onp.int64)
    return onp.abs(ia - ib)


def _unit_inputs(n_states, hp, seed=0):
    r = onp.random.RandomState(seed)
    w = r.randn(P).astype("f4")
    g = r.randn(P).astype("f4") * 3
    states = tuple(abs(r.randn(P)).astype("f4") * 0.1
                   for _ in range(n_states))
    if hp == "scalar":
        lr, wd, t = onp.float32(0.05), onp.float32(0.01), onp.int32(3)
    else:
        lr = r.rand(P).astype("f4") * 0.1
        wd = r.rand(P).astype("f4") * 0.01
        t = r.randint(1, 5, P).astype("i4")
    return w, g, states, lr, wd, t


def _jax_unit_update(kind, cfg, w, g, lr, wd, t, rescale, clip, states):
    import jax.numpy as jnp
    from mxnet_tpu.ops.kernels import opt_update as jopu
    nw, ns = jopu.unit_update(
        kind, cfg, jnp.asarray(w), jnp.asarray(g), jnp.asarray(lr),
        jnp.asarray(wd), jnp.asarray(t), jnp.float32(rescale),
        jnp.float32(clip), tuple(jnp.asarray(s) for s in states),
        interpret=True)
    return onp.asarray(nw), [onp.asarray(s) for s in ns]


def _numpy_rule(case, w, g, lr, wd, t, rescale, clip, states):
    """The rule in numpy float32, each operation rounded on its own (the
    order of the JAX kernel's ``_state_body`` / ``_weight_body``)."""
    f = onp.float32
    g = g * f(rescale)
    if clip is not None:
        g = onp.clip(g, f(-clip), f(clip))
    g = g + f(wd) * w
    if case == "sgd":
        return w - f(lr) * g, ()
    if case == "sgd_mom":
        m = f(0.9) * states[0] - f(lr) * g
        return w + m, (m,)
    m = f(0.9) * states[0] + f(1 - 0.9) * g
    v = f(0.999) * states[1] + f(1 - 0.999) * g * g
    tf = onp.asarray(t, f)
    mhat = m / (f(1) - onp.power(f(0.9), tf))
    vhat = v / (f(1) - onp.power(f(0.999), tf))
    return w - f(lr) * mhat / (onp.sqrt(vhat) + f(1e-8)), (m, v)


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("hp", ["scalar", "vector"])
@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_unit_update_plain_vs_jax_kernel(case, hp, clip):
    """The plain version, in place, against the rule with each operation
    rounded on its own (bit for bit; the Adam weight within 2 ulps of
    |w| where float32 ``pow`` of numpy and of torch round apart) and
    against the JAX kernel in interpret mode. XLA's CPU backend contracts
    ``b * m + x`` into one FMA there (its new states equal
    ``fma(b1, m, (1 - b1) * g)`` element for element), so against it the
    states hold within 2**-23 and the weights within 2**-21 (the ulp of
    the O(1) weights and terms); the card's kernel rounds each operation
    on its own, as the plain version does."""
    kind, extra, n_states = OPT_CASES[case]
    cfg = dict(extra, has_clip=clip is not None)
    w, g, states, lr, wd, t = _unit_inputs(n_states, hp)
    cval = 0.0 if clip is None else clip
    jw, js = _jax_unit_update(kind, cfg, w, g, lr, wd, t, 0.25, cval,
                              states)
    tw, ts = (torch.from_numpy(w.copy()),
              tuple(torch.from_numpy(s.copy()) for s in states))
    to_t = lambda v: torch.from_numpy(v) if onp.ndim(v) else v  # noqa
    out_w, out_s = topu.unit_update(kind, cfg, tw, torch.from_numpy(g),
                                    to_t(lr), to_t(wd), to_t(t),
                                    onp.float32(0.25), onp.float32(cval),
                                    ts)
    assert out_w is tw and all(a is b for a, b in zip(out_s, ts))
    nw, ns = _numpy_rule(case, w, g, lr, wd, t, 0.25, clip, states)
    for a, b in zip(ts, ns):
        onp.testing.assert_array_equal(a.numpy(), b)
    if kind == "adam":
        onp.testing.assert_allclose(tw.numpy(), nw, rtol=0,
                                    atol=2 ** -22 * abs(w).max())
    else:
        onp.testing.assert_array_equal(tw.numpy(), nw)
    for a, b in zip(ts, js):
        onp.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2 ** -23)
    onp.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=2 ** -21)


@pytest.mark.parametrize("case", ["sgd_mom", "adam"])
def test_unit_update_plain_bf16_vs_jax_kernel(case):
    """bfloat16 weights and states: the constants that multiply a state
    rounded to bfloat16, the arithmetic float32, the outputs rounded.
    The new states are bit-exact; the weight within one bfloat16 ulp
    (Adam's float32 pow may round apart)."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.kernels import opt_update as jopu
    kind, extra, n_states = OPT_CASES[case]
    cfg = dict(extra, has_clip=False)
    w, g, states, lr, wd, t = _unit_inputs(n_states, "scalar", seed=1)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)             # noqa: E731
    jw, js = jopu.unit_update(kind, cfg, bf(w), bf(g), lr, wd, t,
                              jnp.float32(0.25), jnp.float32(0.0),
                              tuple(bf(s) for s in states), interpret=True)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    tw, ts = tb(w), tuple(tb(s) for s in states)
    topu.unit_update(kind, cfg, tw, tb(g), lr, wd, t, 0.25, 0.0, ts)
    for a, b in zip(ts, js):
        onp.testing.assert_array_equal(a.float().numpy(),
                                       onp.asarray(b, onp.float32))
    onp.testing.assert_allclose(tw.float().numpy(),
                                onp.asarray(jw, onp.float32),
                                rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("hp", ["scalar", "vector"])
@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "clip_gradient": 0.5}),
    ("adam", {"learning_rate": 0.01}),
])
def test_kernel_step_fn_vs_fused_step_fn(name, kwargs, hp):
    """The optimizer's kernel route (in place) against its plain
    multi-tensor rule on the same flat units."""
    opt = topt.create(name, **kwargs)
    n_states = 1 if name == "sgd" else 2
    units = [_unit_inputs(n_states, hp, seed=s) for s in (3, 4)]
    args = lambda: (   # noqa: E731
        tuple(torch.from_numpy(u[0].copy()) for u in units),
        tuple(torch.from_numpy(u[1]) for u in units),
        [torch.as_tensor(u[3]) for u in units],
        [torch.as_tensor(u[4]) for u in units],
        [torch.as_tensor(u[5]) for u in units], onp.float32(0.25),
        onp.float32(0.5),
        tuple(tuple(torch.from_numpy(s.copy()) for s in u[2])
              for u in units))
    fw, fs = opt.fused_step_fn()(*args())
    kw, ks = opt.kernel_step_fn()(*args())
    for a, b in zip(kw, fw):
        onp.testing.assert_array_equal(a.numpy(), b.numpy())
    for sa, sb in zip(ks, fs):
        for a, b in zip(sa, sb):
            onp.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kernel_step_fn_only_for_exact_sgd_adam():
    assert topu.opt_kernel_kind(topt.SGD(momentum=0.9))[0] == "sgd"
    assert topu.opt_kernel_kind(topt.Adam())[0] == "adam"
    assert topt.AdamW().kernel_step_fn() is None

    class MySGD(topt.SGD):
        pass
    assert MySGD().kernel_step_fn() is None
    assert all(o.elementwise_update for o in
               (topt.SGD(), topt.Adam(), topt.AdamW()))


# ---------------------------------------------------------------------------
# the plan: units, bucket schedule, hyperparameter packing
# ---------------------------------------------------------------------------

def _mlp_weights(seed=3):
    """test_zero_shard.py's MLP (Dense(5, in_units=8): weight 40, bias 5;
    Dense(3, in_units=5): weight 15 — sizes not divisible by 4)."""
    r = onp.random.RandomState(seed)
    shapes = {"0.weight": (8, 4), "0.bias": (8,), "1.weight": (5, 8),
              "1.bias": (5,), "2.weight": (3, 5), "2.bias": (3,)}
    return {k: (r.randn(*s) * 0.5).astype("f4") for k, s in shapes.items()}


def _torch_mlp(weights):
    net = torch.nn.Sequential(
        Dense(8, in_units=4, activation="relu", device="cpu"),
        Dense(5, in_units=8, activation="relu", device="cpu"),
        Dense(3, in_units=5, device="cpu"))
    load_jax_params(net, weights)
    return net


def _jax_mlp(weights):
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import nn as jnn
    net = jnn.HybridSequential()
    net.add(jnn.Dense(8, in_units=4, activation="relu"))
    net.add(jnn.Dense(5, in_units=8, activation="relu"))
    net.add(jnn.Dense(3, in_units=5))
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(weights[k]))
    return net


def _bert_weights():
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
    tnet = tbert.BERTClassifier(tbert.bert_small_test(dropout=0.0,
                                                      device="cpu"),
                                num_classes=3, dropout=0.0, device="cpu")
    return tnet, init_params_numpy(tnet, 0)


def _jax_bert(weights):
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo import bert as jbert
    jnet = jbert.BERTClassifier(jbert.bert_small_test(dropout=0.0),
                                num_classes=3, dropout=0.0)
    jnet.initialize()
    jnet(mx.nd.array(onp.zeros((1, 4)), dtype="int32"))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(weights[k]))
    return jnet


@pytest.mark.parametrize("min_size", [1, 2048, 100000])
@pytest.mark.parametrize("model", ["mlp", "bert_small_test"])
def test_plan_layout_vs_jax(monkeypatch, model, min_size):
    import jax
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import fused_step as jfs
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    monkeypatch.setenv("MXNET_ZERO_SHARD_MIN_SIZE", str(min_size))
    if model == "mlp":
        weights = _mlp_weights()
        tnet, jnet = _torch_mlp(weights), _jax_mlp(weights)
    else:
        tnet, weights = _bert_weights()
        load_jax_params(tnet, weights)
        jnet = _jax_bert(weights)
    jtr = JTrainer(jnet.collect_params(), "adam", {"learning_rate": 0.01})
    ttr = TTrainer(dict(tnet.named_parameters()), "adam",
                   {"learning_rate": 0.01})
    n = len(ttr._params)
    mults = {i: 0.5 + (i % 3) for i in range(n)}
    for tr in (jtr, ttr):
        tr._optimizer.set_lr_mult(mults)
    jplan = jfs._ZeroShardPlan(jtr, jmake_mesh({"dp": DP},
                                               jax.devices()[:DP]), "dp")
    tplan = tfs._ZeroShardPlan(ttr._params, ttr._optimizer, DP)
    keys = ("members", "sizes", "shapes", "total", "padded")
    assert [{k: u[k] for k in keys} for u in tplan.units] == \
        [{k: u[k] for k in keys} for u in jplan.units]
    for bucket_bytes in (0, 1 << 20, 4 << 20, 64):
        assert tfs.zero_bucket_schedule(tplan.units, bucket_bytes) == \
            jfs.zero_bucket_schedule(jplan.units, bucket_bytes)
    hp_j = jtr._optimizer.begin_fused_step(list(range(n)))
    hp_t = ttr._optimizer.begin_fused_step(list(range(n)))
    for a, b in zip(hp_t, hp_j):
        onp.testing.assert_array_equal(a, b)
    for a, b in zip(tplan.pack_hparams(ttr._optimizer, *hp_t),
                    jplan.pack_hparams(jtr._optimizer, *hp_j)):
        for x, y in zip(a, b):
            onp.testing.assert_array_equal(onp.asarray(x), onp.asarray(y))


def _dtype_name(dt):
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else onp.dtype(dt).name


def test_multi_precision_plan_layout_vs_jax():
    """bert_small_test converted to bf16 (LayerNorms stay float32), Adam
    with multi_precision: every bf16 parameter is its own mp unit updated
    in float32 on a float32 master, the float32 ones share a bucket, as
    in the JAX plan; a rank's state bytes count the master shards and
    equal the JAX step's per-replica bytes at dp 4."""
    import jax
    from mxnet_tpu import amp as jamp
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import fused_step as jfs
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    from mxnet_tpu_torch import amp as tamp
    tnet, weights = _bert_weights()
    load_jax_params(tnet, weights)
    jnet = _jax_bert(weights)
    jamp.convert_hybrid_block(jnet)
    tamp.convert_hybrid_block(tnet)
    hp = {"learning_rate": 0.01, "multi_precision": True}
    jtr = JTrainer(jnet.collect_params(), "adam", dict(hp))
    ttr = TTrainer(dict(tnet.named_parameters()), "adam", dict(hp))
    jplan = jfs._ZeroShardPlan(jtr, jmake_mesh({"dp": DP},
                                               jax.devices()[:DP]), "dp")
    tplan = tfs._ZeroShardPlan(ttr._params, ttr._optimizer, DP)
    keys = ("members", "sizes", "shapes", "total", "padded", "mp")
    assert [{k: u[k] for k in keys} for u in tplan.units] == \
        [{k: u[k] for k in keys} for u in jplan.units]
    assert [_dtype_name(u["upd_dtype"]) for u in tplan.units] == \
        [_dtype_name(u["upd_dtype"]) for u in jplan.units]
    mp = [k for k, u in enumerate(tplan.units) if u["mp"]]
    assert len(mp) == sum(1 for p in ttr._params
                          if p.dtype == torch.bfloat16) > 0
    for bucket_bytes in (0, 1 << 20, 64):
        assert tfs.zero_bucket_schedule(tplan.units, bucket_bytes) == \
            jfs.zero_bucket_schedule(jplan.units, bucket_bytes)
    total = 0
    for rank in range(DP):
        tplan.create_states(ttr._optimizer, rank)
        assert sorted(tplan.masters) == mp
        for k in mp:
            m = tplan.masters[k]
            assert m.dtype == torch.float32
            p = tplan.params[tplan.units[k]["members"][0]]
            s = tplan.shard_len(k)
            flat = torch.zeros(tplan.units[k]["padded"])
            flat[:p.numel()] = p.detach().float().reshape(-1)
            assert torch.equal(m, flat[rank * s:(rank + 1) * s])
        assert all(t.dtype == torch.float32 for st in tplan.states
                   for t in st)
        total += tplan.state_bytes_per_replica()
    assert total == sum(4 * u["padded"] * (3 if u["mp"] else 2)
                        for u in tplan.units)
    assert tplan.state_bytes_per_replica() == jplan.state_bytes_per_replica()


@pytest.mark.parametrize("lens", [[5, 13, 8, 1], [16], [3, 4097]])
def test_bucketed_routing_vs_jax(lens):
    import jax.numpy as jnp
    from mxnet_tpu.parallel import collectives as jcoll
    r = onp.random.RandomState(len(lens))
    segs = [r.randn(n).astype("f4") for n in lens]
    got = tcoll.reduce_scatter_bucketed([torch.from_numpy(s) for s in segs],
                                        DP)
    ref = jcoll.reduce_scatter_bucketed([jnp.asarray(s) for s in segs], DP)
    for a, b in zip(got, ref):
        onp.testing.assert_array_equal(a.numpy(), onp.asarray(b))
    back = tcoll.allgather_bucketed(got, DP, orig_lens=lens)
    ref_back = jcoll.allgather_bucketed(ref, DP, orig_lens=lens)
    for a, b, s in zip(back, ref_back, segs):
        onp.testing.assert_array_equal(a.numpy(), onp.asarray(b))
        onp.testing.assert_array_equal(a.numpy(), s)
    with pytest.raises(mxt.MXNetError, match="not divisible"):
        tcoll.allgather_bucketed([torch.zeros(5)], DP)


# ---------------------------------------------------------------------------
# four gloo ranks (workers at module level: the ranks import this module)
# ---------------------------------------------------------------------------

def _mlp_batch(bs, seed=0):
    r = onp.random.RandomState(seed)
    return r.randn(bs, 4).astype("f4"), r.randint(0, 3, (bs,)).astype("f4")


def _rank_params(net):
    return {k: p.detach().numpy().copy() for k, p in net.named_parameters()}


def _worker_mlp(weights, opt, kwargs, steps, lr_change, bs, zero_shard):
    """One rank: the MLP through ``compile_step`` under a dp mesh, on the
    global batch; the losses it returned (the global batch's), final
    weights and plan facts."""
    torch.set_num_threads(1)
    from mxnet_tpu_torch.ops import kernels as K
    net = _torch_mlp(weights)
    tr = TTrainer(dict(net.named_parameters()), opt, dict(kwargs))
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b),
                           zero_shard=zero_shard)
    x, y = _mlp_batch(bs)
    losses = []
    with tmake_mesh({"dp": tdist.size()}):
        for i in range(steps):
            if lr_change and i == lr_change[0]:
                tr.learning_rate = lr_change[1]
            losses.append(step(x, y).numpy().copy())
    plan = step.zero_plan
    r = tdist.rank()
    x = torch.arange(6, dtype=torch.float32) + 10 * r
    with tmake_mesh({"dp": tdist.size()}):
        coll = {"allreduce": tcoll.allreduce(x), "max": tcoll.allreduce(
                    x, op="max"), "mean": tcoll.allreduce(x, op="mean"),
                "allgather": tcoll.allgather(x[:2]),
                "stacked": tcoll.allgather(x[:2], tiled=False),
                "reduce_scatter": tcoll.reduce_scatter(x),
                "reduce_scatter_2d": tcoll.reduce_scatter(x.view(3, 2)),
                "broadcast": tcoll.broadcast_axis(x, src=2),
                "replicate": mxt.parallel.replicate(x.clone(), src=1)}
    return {"losses": losses, "params": _rank_params(net),
            "mode": step.mode, "launches": K.launch_counts(),
            "units": None if plan is None else len(plan.units),
            "collectives": {k: v.numpy() for k, v in coll.items()}}


def _eager_mlp(weights, opt, kwargs, steps, lr_change, bs):
    net = _torch_mlp(weights)
    tr = TTrainer(dict(net.named_parameters()), opt, dict(kwargs))
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    x, y = _mlp_batch(bs)
    losses = []
    for i in range(steps):
        if lr_change and i == lr_change[0]:
            tr.learning_rate = lr_change[1]
        losses.append(step(x, y).numpy())
    return losses, _rank_params(net)


def _jax_zero_mlp(weights, opt, kwargs, steps, lr_change, bs):
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    from mxnet_tpu.parallel import shard_batch
    net = _jax_mlp(weights)
    tr = JTrainer(net.collect_params(), opt, dict(kwargs))
    lb = jloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    x, y = _mlp_batch(bs)
    losses = []
    with jmake_mesh({"dp": DP}, jax.devices()[:DP]) as mesh:
        xs = shard_batch(mx.nd.array(x), mesh)
        ys = shard_batch(mx.nd.array(y), mesh)
        for i in range(steps):
            if lr_change and i == lr_change[0]:
                tr.learning_rate = lr_change[1]
            losses.append(step(xs, ys).asnumpy())
    assert step.zero_sharded
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


@pytest.mark.parametrize("opt,kwargs,min_size", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, "1"),
    ("adam", {"learning_rate": 1e-2, "wd": 0.01}, "2048"),
])
def test_four_rank_zero_vs_jax_zero_step(monkeypatch, opt, kwargs,
                                         min_size):
    """Four gloo ranks against the JAX ZeRO step at dp 4 (kernel 12 in
    interpret mode): 4 steps, an lr change at step 2. At min size 1 every
    parameter is its own unit (scalar hyperparameters), at 2048 all six
    share one bucket unit (vector hyperparameters)."""
    monkeypatch.setenv("MXNET_PALLAS", "on")
    monkeypatch.setenv("MXNET_ZERO_SHARD_MIN_SIZE", min_size)
    weights = _mlp_weights()
    run = (weights, opt, kwargs, 4, (2, 0.02), 8)
    jl, jp = _jax_zero_mlp(*run)
    ranks = tdist.spawn(_worker_mlp, DP, "cpu", run + (None,),
                        timeout_s=SPAWN_TIMEOUT_S)
    assert all(r["mode"] == "zero" for r in ranks)
    assert ranks[0]["units"] == (6 if min_size == "1" else 1)
    # every rank returns the global batch's losses, as the JAX step does
    for i, ref in enumerate(jl):
        for r in ranks:
            onp.testing.assert_allclose(r["losses"][i], ref, atol=1e-5)
    for r in ranks:
        for k, ref in jp.items():
            onp.testing.assert_allclose(r["params"][k], ref, rtol=1e-4,
                                        atol=1e-5, err_msg=k)
        onp.testing.assert_array_equal(r["params"]["0.weight"],
                                       ranks[0]["params"]["0.weight"])
    # the collectives, rank r holding arange(6) + 10 r: the sum over ranks
    # 4 * arange(6) + 60; reduce_scatter's tiles of 6 / 4 -> 2, 2, 2, 0
    # elements, and of 3 rows -> 1, 1, 1, 0 rows
    xs = [onp.arange(6, dtype="f4") + 10 * r for r in range(DP)]
    total = onp.sum(xs, axis=0)
    for rank, r in enumerate(ranks):
        c = r["collectives"]
        onp.testing.assert_array_equal(c["allreduce"], total)
        onp.testing.assert_array_equal(c["max"], xs[-1])
        onp.testing.assert_array_equal(c["mean"], total / DP)
        onp.testing.assert_array_equal(
            c["allgather"], onp.concatenate([x[:2] for x in xs]))
        onp.testing.assert_array_equal(c["stacked"],
                                       onp.stack([x[:2] for x in xs]))
        onp.testing.assert_array_equal(c["reduce_scatter"],
                                       total[2 * rank:2 * rank + 2])
        onp.testing.assert_array_equal(c["reduce_scatter_2d"],
                                       total.reshape(3, 2)[rank:rank + 1])
        onp.testing.assert_array_equal(c["broadcast"], xs[2])
        onp.testing.assert_array_equal(c["replicate"], xs[1])


def test_four_rank_replicated_batch_and_plain_mesh_mode():
    """A batch of 6 rows does not divide by 4: each rank computes it
    whole, and its gradient is reduced as a mean, not counted four
    times. The same holds in the plain mesh mode (``zero_shard=False``:
    all-reduce, replicated update). SGD-momentum, where a gradient four
    times too large would show."""
    weights = _mlp_weights(5)
    run = (weights, "sgd", {"learning_rate": 0.1, "momentum": 0.9}, 3,
           None, 6)
    el, ep = _eager_mlp(*run)
    for zero_shard, mode in ((None, "zero"), (False, "mesh")):
        ranks = tdist.spawn(_worker_mlp, DP, "cpu", run + (zero_shard,),
                            timeout_s=SPAWN_TIMEOUT_S)
        for r in ranks:
            assert r["mode"] == mode
            for a, b in zip(r["losses"], el):
                onp.testing.assert_allclose(a, b, atol=1e-6)
            for k, ref in ep.items():
                onp.testing.assert_allclose(r["params"][k], ref,
                                            rtol=1e-5, atol=1e-6,
                                            err_msg=k)


def _worker_mlp_mp(weights, kwargs, steps, bs):
    """One rank: the MLP in bf16 with ``multi_precision`` through
    ``compile_step`` under a dp mesh; its losses, bf16 weights (as
    float32), master shards and plan facts."""
    torch.set_num_threads(1)
    from mxnet_tpu_torch.ops import kernels as K
    net = _torch_mlp(weights).to(torch.bfloat16)
    tr = TTrainer(dict(net.named_parameters()), "adam",
                  dict(kwargs, multi_precision=True))
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    x, y = _mlp_batch(bs)
    with tmake_mesh({"dp": tdist.size()}):
        losses = [step(x, y).float().numpy().copy() for _ in range(steps)]
    plan = step.zero_plan
    return {"losses": losses, "mode": step.mode,
            "params": {k: p.detach().float().numpy().copy()
                       for k, p in net.named_parameters()},
            "names": [n for n, _ in sorted(net.named_parameters())],
            "mp": [u["mp"] for u in plan.units],
            "members": [u["members"] for u in plan.units],
            "masters": {k: m.numpy().copy() for k, m in plan.masters.items()},
            "shard_len": [plan.shard_len(k) for k in range(len(plan.units))],
            "state_bytes": step.optimizer_state_bytes(),
            "launches": K.launch_counts()}


def _jax_zero_mlp_mp(weights, kwargs, steps, bs):
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    from mxnet_tpu.parallel import shard_batch
    net = _jax_mlp(weights)
    for p in net.collect_params().values():
        p.cast("bfloat16")
    tr = JTrainer(net.collect_params(), "adam",
                  dict(kwargs, multi_precision=True))
    lb = jloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    x, y = _mlp_batch(bs)
    with jmake_mesh({"dp": DP}, jax.devices()[:DP]) as mesh:
        xs = shard_batch(mx.nd.array(x), mesh)
        ys = shard_batch(mx.nd.array(y), mesh)
        losses = [step(xs, ys).asnumpy().astype("f4") for _ in range(steps)]
    assert step.zero_sharded
    return losses, {k: p.data().asnumpy().astype("f4")
                    for k, p in net.collect_params().items()}, \
        step.optimizer_state_bytes()


def test_four_rank_multi_precision_zero_vs_jax_zero_step(monkeypatch):
    """The MLP's weights in bf16, Adam with multi_precision: four gloo
    ranks against the JAX ZeRO step at dp 4 (kernel 12 in interpret
    mode), four steps. Every parameter is an mp unit with a float32
    master shard; on every rank each weight equals its gathered master
    rounded to bf16. Both sides rebuild the forward in float32 from the
    same bf16 weights and reduce bf16 gradients in float32, so the
    losses agree to 1e-5; the weights to one bf16 ulp (2**-8 of a value:
    a master within float32 rounding of a bf16 tie can round apart)."""
    monkeypatch.setenv("MXNET_PALLAS", "on")
    monkeypatch.setenv("MXNET_ZERO_SHARD_MIN_SIZE", "1")
    weights = _mlp_weights()
    run = (weights, {"learning_rate": 1e-2, "wd": 0.01}, 4, 8)
    jl, jp, jbytes = _jax_zero_mlp_mp(*run)
    ranks = tdist.spawn(_worker_mlp_mp, DP, "cpu", run,
                        timeout_s=SPAWN_TIMEOUT_S)
    for r in ranks:
        assert r["mode"] == "zero" and all(r["mp"])
        assert r["state_bytes"] == jbytes
        for a, b in zip(r["losses"], jl):
            onp.testing.assert_allclose(a, b, atol=1e-5)
        for k, ref in jp.items():
            onp.testing.assert_allclose(r["params"][k], ref, rtol=2 ** -8,
                                        atol=1e-6, err_msg=k)
            onp.testing.assert_array_equal(r["params"][k],
                                           ranks[0]["params"][k])
    # each weight is its master (gathered over the ranks) in bf16
    r0 = ranks[0]
    for k, members in enumerate(r0["members"]):
        name = r0["names"][members[0]]
        full = onp.concatenate([r["masters"][k] for r in ranks])
        w = r0["params"][name]
        master = torch.from_numpy(full[:w.size].reshape(w.shape))
        onp.testing.assert_array_equal(
            master.to(torch.bfloat16).float().numpy(), w)


def _worker_bert(weights, x, y, steps):
    """One rank: bert_small_test through TrainLoop under a dp mesh."""
    torch.set_num_threads(1)
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
    net = tbert.BERTClassifier(tbert.bert_small_test(dropout=0.0,
                                                     device="cpu"),
                               num_classes=3, dropout=0.0, device="cpu")
    load_jax_params(net, weights)
    tr = TTrainer(dict(net.named_parameters()), "adam",
                  {"learning_rate": 1e-3, "wd": 0.01})
    losses = []
    with tmake_mesh({"dp": tdist.size()}):
        loop = TrainLoop(net, tr, tloss.SoftmaxCrossEntropyLoss())
        for _ in range(steps):
            losses.append(loop.step(x, y))
        loop.synchronize()
    step = loop.compiled_step
    plan = step.zero_plan
    return {"losses": [l.numpy() for l in losses],
            "params": _rank_params(net), "zero": step.zero_sharded,
            "state_bytes": step.optimizer_state_bytes(),
            "expect_bytes": sum(2 * 4 * plan.shard_len(k)
                                for k in range(len(plan.units))),
            "stats": loop.engine_stats()}


def test_four_rank_zero_bert_vs_eager_trainer():
    """bert_small_test (dropout 0), three Adam steps: four gloo ranks
    through TrainLoop against the port's eager trainer on one process;
    each rank holds ~1/4 of the Adam state."""
    tnet, weights = _bert_weights()
    load_jax_params(tnet, weights)
    x = onp.random.RandomState(1).randint(0, 128, (4, 10)).astype("int64")
    y = onp.array([0, 2, 1, 1], "f4")
    ranks = tdist.spawn(_worker_bert, DP, "cpu", (weights, x, y, 3),
                        timeout_s=SPAWN_TIMEOUT_S)
    tr = TTrainer(dict(tnet.named_parameters()), "adam",
                  {"learning_rate": 1e-3, "wd": 0.01})
    lb = tloss.SoftmaxCrossEntropyLoss()
    eager = []
    for _ in range(3):
        loss = lb(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        loss.sum().backward()
        tr.step(4)
        eager.append(loss.detach().numpy())
    full_bytes = sum(2 * 4 * p.numel() for p in tnet.parameters())
    for i, ref in enumerate(eager):
        for r in ranks:
            onp.testing.assert_allclose(r["losses"][i], ref, rtol=2e-5,
                                        atol=2e-5)
    assert eager[-1].mean() < eager[0].mean()
    for r in ranks:
        assert r["zero"] and r["stats"]["retires"] == 3
        assert r["state_bytes"] == r["expect_bytes"]
        assert full_bytes / DP <= r["state_bytes"] <= 1.01 * full_bytes / DP
        for k, p in tnet.named_parameters():
            onp.testing.assert_allclose(r["params"][k], p.detach().numpy(),
                                        rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# BatchNorm over the dp group: the statistics of the global batch
# ---------------------------------------------------------------------------

BN_STEPS = 3
BN_LR = 0.1


def _bn_weights(seed=7):
    """A conv net with BatchNorm: Conv2D(4, 3x3, pad 1) on 2 channels,
    BatchNorm(4), ReLU, global average pool, Dense(3)."""
    r = onp.random.RandomState(seed)
    w = {"0.weight": r.randn(4, 2, 3, 3) * 0.5, "0.bias": r.randn(4) * 0.1,
         "1.gamma": 1.0 + r.randn(4) * 0.2, "1.beta": r.randn(4) * 0.1,
         "1.running_mean": r.randn(4) * 0.1,
         "1.running_var": 1.0 + r.rand(4) * 0.5,
         "5.weight": r.randn(3, 4) * 0.5, "5.bias": r.randn(3) * 0.1}
    return {k: v.astype("f4") for k, v in w.items()}


def _bn_batch(bs, seed=11):
    r = onp.random.RandomState(seed)
    # an offset mean a channel: a one-pass variance would show it
    x = r.randn(bs, 2, 5, 5) * 2.0 + onp.array([3.0, -1.0])[:, None, None]
    return x.astype("f4"), r.randint(0, 3, (bs,)).astype("f4")


def _torch_bn_net(weights, sync):
    from mxnet_tpu_torch.gluon import nn as tnn
    from mxnet_tpu_torch.gluon.contrib import nn as tcnn
    norm = tcnn.SyncBatchNorm(in_channels=4, num_devices=DP, device="cpu") \
        if sync else tnn.BatchNorm(in_channels=4, device="cpu")
    net = tnn.HybridSequential()
    net.add(tnn.Conv2D(4, 3, padding=1, in_channels=2, device="cpu"), norm,
            tnn.Activation("relu"), tnn.GlobalAvgPool2D(), tnn.Flatten(),
            tnn.Dense(3, in_units=4, device="cpu"))
    load_jax_params(net, weights)
    return net


def _bn_train(net, step, x, y, steps):
    """Losses and every parameter after each step."""
    losses, params = [], [_rank_params(net)]
    for _ in range(steps):
        losses.append(step(x, y).numpy().copy())
        params.append(_rank_params(net))
    return losses, params


def _worker_bn(weights, cases, steps):
    """One rank: each case (sync layer, zero_shard, batch) through
    ``compile_step`` under a dp mesh, on the global batch."""
    torch.set_num_threads(1)
    out = []
    for sync, zero_shard, bs in cases:
        net = _torch_bn_net(weights, sync)
        tr = TTrainer(dict(net.named_parameters()), "sgd",
                      {"learning_rate": BN_LR})
        lb = tloss.SoftmaxCrossEntropyLoss()
        step = tr.compile_step(lambda a, b: lb(net(a), b),
                               zero_shard=zero_shard)
        x, y = _bn_batch(bs)
        with tmake_mesh({"dp": tdist.size()}):
            losses, params = _bn_train(net, step, x, y, steps)
        out.append({"losses": losses, "params": params, "mode": step.mode})
    return out


def _jax_bn(weights, sync, bs, steps, dp):
    """The JAX package's step on the same net: the ZeRO step over a dp
    mesh of the 8-device virtual CPU (``dp`` 4), or one device
    (``dp`` None)."""
    import contextlib
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    from mxnet_tpu.parallel import shard_batch
    net = jnn.HybridSequential()
    net.add(jnn.Conv2D(4, 3, padding=1, in_channels=2),
            (jnn.SyncBatchNorm if sync else jnn.BatchNorm)(in_channels=4),
            jnn.Activation("relu"), jnn.GlobalAvgPool2D(), jnn.Flatten(),
            jnn.Dense(3, in_units=4))
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(weights[k]))
    tr = JTrainer(net.collect_params(), "sgd", {"learning_rate": BN_LR})
    lb = jloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    x, y = _bn_batch(bs)
    snap = lambda: {k: p.data().asnumpy()  # noqa: E731
                    for k, p in net.collect_params().items()}
    losses, params = [], [snap()]
    scope = jmake_mesh({"dp": dp}, jax.devices()[:dp]) if dp \
        else contextlib.nullcontext()
    with scope as mesh:
        xs, ys = mx.nd.array(x), mx.nd.array(y)
        if dp:
            xs, ys = shard_batch(xs, mesh), shard_batch(ys, mesh)
        for _ in range(steps):
            losses.append(step(xs, ys).asnumpy())
            params.append(snap())
    return losses, params


def _bn_close(got, ref, what):
    """BatchNorm at dp 4 against the one-program reference: the
    per-channel sums are taken a rank at a time, then across ranks, so
    losses agree to 1e-5, each step's gradient ((w_t - w_t+1) / lr) and
    the running statistics to rtol 1e-4 / atol 1e-5."""
    gl, gp = got
    rl, rp = ref
    for a, b in zip(gl, rl):
        onp.testing.assert_allclose(a, b, atol=1e-5, err_msg=what)
    for t in range(len(rl)):
        for k in rp[0]:
            if "running" in k:
                onp.testing.assert_allclose(gp[t + 1][k], rp[t + 1][k],
                                            rtol=1e-4, atol=1e-5,
                                            err_msg=f"{what} {k} step {t}")
            else:
                onp.testing.assert_allclose(
                    (gp[t][k] - gp[t + 1][k]) / BN_LR,
                    (rp[t][k] - rp[t + 1][k]) / BN_LR, rtol=1e-4,
                    atol=1e-5, err_msg=f"{what} grad {k} step {t}")


# (sync layer, zero_shard, global batch): the zero mode with BatchNorm and
# with SyncBatchNorm, the plain mesh mode, and a batch of 6 rows that does
# not divide by 4 (each rank computes it whole)
BN_CASES = ((False, None, 8), (True, None, 8), (False, False, 8),
            (False, None, 6))


@pytest.fixture(scope="module")
def bn_ranks():
    return tdist.spawn(_worker_bn, DP, "cpu",
                       (_bn_weights(), BN_CASES, BN_STEPS),
                       timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("case", range(len(BN_CASES)),
                         ids=["zero", "zero_sync", "mesh", "whole_batch"])
def test_four_rank_batchnorm_vs_jax_zero_step(bn_ranks, case):
    """Four gloo ranks, each holding 1/4 of the batch, against the JAX
    ZeRO step at dp 4: BatchNorm normalises with the global batch's
    statistics on every rank, so the losses, every step's gradients
    and the running statistics match the one SPMD program's, and the
    running statistics are bit-identical on every rank (the ones a
    checkpoint takes from rank 0). A batch of 6 rows is computed whole
    on every rank, as before, and held against the JAX one-device step."""
    sync, zero_shard, bs = BN_CASES[case]
    # the JAX mesh does not place 6 rows on 4 devices: its one-device
    # step is the whole batch's reference
    ref = _jax_bn(_bn_weights(), sync, bs, BN_STEPS, DP if bs % DP == 0
                  else None)
    ranks = [r[case] for r in bn_ranks]
    for i, r in enumerate(ranks):
        assert r["mode"] == ("mesh" if zero_shard is False else "zero")
        _bn_close((r["losses"], r["params"]), ref, f"rank {i}")
        for k in ("1.running_mean", "1.running_var"):
            onp.testing.assert_array_equal(r["params"][-1][k],
                                           ranks[0]["params"][-1][k])
    # the running statistics moved: the check is not of initial values
    assert not onp.allclose(ranks[0]["params"][-1]["1.running_mean"],
                            ranks[0]["params"][0]["1.running_mean"])


def test_four_rank_batchnorm_is_not_each_ranks_own(bn_ranks):
    """What the repair changed: normalising each rank's 2 rows with their
    own statistics (the step without ``split_batch``) parts from the
    JAX step far beyond the tolerance above."""
    ref = _jax_bn(_bn_weights(), False, 8, 1, DP)
    x, y = _bn_batch(8)
    net = _torch_bn_net(_bn_weights(), False)
    lb = tloss.SoftmaxCrossEntropyLoss()
    local = onp.concatenate([
        lb(net(torch.from_numpy(x[2 * r:2 * r + 2])),
           torch.from_numpy(y[2 * r:2 * r + 2])).detach().numpy()
        for r in range(DP)])
    assert onp.abs(local - ref[0][0]).max() > 1e-3
    onp.testing.assert_allclose(bn_ranks[0][0]["losses"][0], ref[0][0],
                                atol=1e-5)


@pytest.mark.parametrize("sync", [False, True])
def test_one_process_batchnorm_vs_jax_step(sync):
    """One process: SyncBatchNorm is BatchNorm (bit for bit), and both
    train as the JAX package's one-device step."""
    weights = _bn_weights()
    x, y = _bn_batch(8)
    got = []
    for s in (False, sync):
        net = _torch_bn_net(weights, s)
        tr = TTrainer(dict(net.named_parameters()), "sgd",
                      {"learning_rate": BN_LR})
        lb = tloss.SoftmaxCrossEntropyLoss()
        step = tr.compile_step(lambda a, b: lb(net(a), b))
        got.append(_bn_train(net, step, x, y, BN_STEPS))
    for a, b in zip(got[0][0], got[1][0]):
        onp.testing.assert_array_equal(a, b)
    for pa, pb in zip(got[0][1], got[1][1]):
        for k in pa:
            onp.testing.assert_array_equal(pa[k], pb[k])
    _bn_close(got[1], _jax_bn(weights, sync, 8, BN_STEPS, None), "one")


def test_split_batch_scope_marks_the_sync_statistics():
    """``parallel.split_batch`` is what makes a BatchNorm take the
    statistics across ranks: with no mesh, a mesh of one, or
    ``split=False`` no collective runs; the scopes nest per thread."""
    from mxnet_tpu_torch.parallel import mesh as tmesh
    assert tmesh.split_mesh() is None
    m1 = tmake_mesh({"dp": 1})
    with tmesh.split_batch(m1):
        assert tmesh.split_mesh() is None        # one rank: local ops
    fake = tmesh.DeviceMesh({"dp": 4})
    with tmesh.split_batch(fake):
        assert tmesh.split_mesh() is fake
        with tmesh.split_batch(fake, split=False):
            assert tmesh.split_mesh() is None
        assert tmesh.split_mesh() is fake
    assert tmesh.split_mesh() is None


# ---------------------------------------------------------------------------
# the gate, the window
# ---------------------------------------------------------------------------

def test_zero_shard_true_without_dp_world_raises_like_jax():
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    weights = _mlp_weights()
    jnet, tnet = _jax_mlp(weights), _torch_mlp(weights)
    jtr = JTrainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1})
    jstep = jtr.compile_step(
        lambda a, b: jloss.SoftmaxCrossEntropyLoss()(jnet(a), b),
        zero_shard=True)
    x, y = _mlp_batch(8)
    with pytest.raises(Exception) as jerr:
        jstep(mx.nd.array(x), mx.nd.array(y))
    ttr = TTrainer(dict(tnet.named_parameters()), "sgd",
                   {"learning_rate": 0.1})
    with pytest.raises(mxt.MXNetError) as terr:
        ttr.compile_step(lambda a, b: a, zero_shard=True)
    assert str(terr.value) == str(jerr.value) == \
        "compile_step(zero_shard=True): no active mesh with a 'dp' axis " \
        "of size >= 2"
    with pytest.raises(mxt.MXNetError, match="needs 4 ranks"):
        tmake_mesh({"dp": 4})
    dist_kv = TTrainer(dict(tnet.named_parameters()), "sgd",
                       kvstore="dist_sync")._kvstore
    assert type(dist_kv).__name__ == "KVStoreDist" and \
        dist_kv.in_program_reduce and dist_kv.in_program_reduce_scatter
    with pytest.raises(mxt.MXNetError, match="unknown kvstore"):
        TTrainer(dict(tnet.named_parameters()), "sgd", kvstore="dist_x")
    assert TTrainer(dict(tnet.named_parameters()), "sgd",
                    kvstore="tpu")._kvstore.in_program_reduce_scatter


def test_single_process_kvstore_vs_jax():
    """The single-process store against the JAX package's 'local' store:
    a push of two values sums them, a pull reads the store, an updater
    set from an optimizer applies it on push (by the key as the index,
    so lr_mult holds), and a pushpull of two values returns their sum."""
    import mxnet_tpu as mx
    from mxnet_tpu import kvstore as jkv
    from mxnet_tpu import optimizer as jopt
    from mxnet_tpu_torch import kvstore as tkv
    r = onp.random.RandomState(2)
    w0, g1, g2 = (r.randn(4, 3).astype("f4") for _ in range(3))
    jstore, tstore = jkv.create("local"), tkv.create("local")
    assert tstore.type == "local" and tstore.num_workers == 1
    jstore.init(3, mx.nd.array(w0))
    tstore.init(3, torch.from_numpy(w0.copy()))
    jstore.push(3, [mx.nd.array(g1), mx.nd.array(g2)])
    tstore.push(3, [torch.from_numpy(g1), torch.from_numpy(g2)])
    jo, to = mx.nd.zeros((4, 3)), torch.zeros(4, 3)
    jstore.pull(3, out=jo)
    tstore.pull(3, out=to)
    onp.testing.assert_array_equal(to.numpy(), jo.asnumpy())
    jstore.init(5, mx.nd.array(w0))
    tstore.init(5, torch.from_numpy(w0.copy()))
    jo_, to_ = jopt.create("sgd", learning_rate=0.1, momentum=0.9), \
        topt.create("sgd", learning_rate=0.1, momentum=0.9)
    jo_.set_lr_mult({5: 0.5})
    to_.set_lr_mult({5: 0.5})
    jstore.set_optimizer(jo_)
    tstore.set_optimizer(to_)
    for _ in range(2):
        jstore.push(5, mx.nd.array(g1))
        tstore.push(5, torch.from_numpy(g1))
    jstore.pull(5, out=jo)
    tstore.pull(5, out=to)
    onp.testing.assert_allclose(to.numpy(), jo.asnumpy(), rtol=1e-6,
                                atol=1e-7)
    a, b = torch.from_numpy(g1.copy()), torch.from_numpy(g2.copy())
    tkv.create("device").pushpull(7, [a, b])
    onp.testing.assert_allclose(a.numpy(), g1 + g2, rtol=0, atol=0)
    onp.testing.assert_array_equal(b.numpy(), a.numpy())


@pytest.mark.parametrize("inflight", [0, 1, 3])
def test_trainloop_window_holds_at_most_inflight(inflight):
    tnet = _torch_mlp(_mlp_weights())
    tr = TTrainer(dict(tnet.named_parameters()), "sgd",
                  {"learning_rate": 0.1})
    loop = TrainLoop(tnet, tr, tloss.SoftmaxCrossEntropyLoss(),
                     inflight=inflight)
    x, y = _mlp_batch(8)
    for i in range(5):
        loss = loop.step(x, y)
        assert loss.shape == (8,)
        assert loop.engine_stats()["pending"] <= inflight
    s = loop.engine_stats()
    assert s["max_pending"] <= inflight + 1 and s["pushes"] == 5
    assert s["retires"] == 5 - s["pending"] and loop.global_step == 5
    loop.synchronize()
    assert loop.engine_stats()["pending"] == 0
    assert loop.compiled_step.mode == "fused"


def test_place_on_mesh_and_state_bytes_single_rank():
    """A world of one: the mesh needs no group, every batch stays whole,
    and the plan of 4 shards splits each unit into equal padded tiles."""
    mesh = tmake_mesh({"dp": 1})
    x = onp.arange(12, dtype="f4").reshape(6, 2)
    assert torch.equal(tcoll.allgather(torch.ones(3), mesh=mesh),
                       torch.ones(3))
    assert tuple(mxt.parallel.place_on_mesh(mesh, "dp", x).shape) == (6, 2)
    tnet = _torch_mlp(_mlp_weights())
    params = list(tnet.parameters())
    plan = tfs._ZeroShardPlan(params, topt.Adam(), DP)
    total = 0
    for rank in range(DP):
        plan.create_states(topt.Adam(), rank)
        total += plan.state_bytes_per_replica()
    assert total == sum(2 * 4 * u["padded"] for u in plan.units)
    flat = plan.unit_flat(0, params)
    shard = torch.empty(plan.shard_len(0))
    plan.copy_shard(0, params, 3, shard)
    s = plan.shard_len(0)
    assert torch.equal(shard, flat[3 * s:4 * s])
