"""The store of several processes (``kvstore.KVStoreDist``), gradient
compression and the Trainer's store surface, against the JAX package.

One process: the port's bucketed ``pushpull_list`` with ``_force_fuse``
against the JAX ``KVStoreDist`` with ``_force_fuse`` (the cases of
``tests/test_kvstore_batched.py``: values, dtype bucketing, the slice
threshold, the updater on the store, the sparse fallback, the stats);
``GradientCompression`` against the JAX one for all four types over
three rounds with residuals; the names ``create`` resolves; the
``MXNET_UPDATE_ON_KVSTORE`` decision matrix beside the JAX Trainer's;
``compile_step``'s split program (``tests/test_fused_step.py::
test_compile_step_split_mode_host_allreduce``, without BatchNorm, which
the port does not have).

Two gloo ranks (``parallel.dist.spawn``): ``init`` broadcasts rank 0's
value; ``pushpull`` / ``pushpull_list`` (sync and async, with an updater
on the store, with fp16 and 2bit compression) against the JAX
``KVStoreTPU`` fed the ranks' values as one replica list; the Trainer
with ``kvstore="dist_sync"`` (``update_on_kvstore`` False and True, fp16
compression, ``dist_async``, a parameter one rank leaves unreached,
``compile_step``'s split program, also under a dp mesh with and
without fp16 compression, and the ``mesh`` mode of bfloat16 weights with
float32 masters) against the JAX Trainer on the whole batch;
the decision matrix with two workers.

Tolerances: a sum of two float32 values is exact in either order, and
compression is elementwise with the same roundings, so the stores'
results are held bit for bit; the update rules within 1e-6 of the
largest |weight| of their tensor (the port's float32 rule against
XLA's, and two ranks' partial gradient sums added in another order than
one process's whole-batch sum); fp16 compression against the JAX
Trainer without compression within FP16_ATOL, bfloat16 weights within
BF16_ATOL (below).

The ranks import this module to find their workers, so JAX is imported
inside the reference functions alone.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.kvstore import KVStoreDist
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.parallel import make_mesh
from mxnet_tpu_torch.parallel.compression import GradientCompression

WORLD = 2
BATCH = 8
STEPS = 3
SPAWN_TIMEOUT_S = 90
REL_TOL = 1e-6
#: SGD at lr 0.1 for STEPS steps, each gradient rounded to fp16 per rank
#: (two halves, each within half an fp16 ulp, 2**-11 relative, of
#: gradients below 2 in magnitude) against the whole batch's unrounded
#: gradient: |dw| <= STEPS * 0.1 * 2 * 2**-11 * 2 ~ 6e-4; the bound
#: below has that margin again
FP16_ATOL = 1.2e-3
#: bfloat16 weights (float32 masters) against the JAX float32 Trainer:
#: two bfloat16 ulps of a weight below 2 in magnitude (2 x 2**-7), for
#: the stored weight's rounding and the bfloat16 forward and backward
BF16_ATOL = 2 * 2.0 ** -7
OPTS = {"sgd": ("sgd", {"learning_rate": 0.1}),
        "sgd_mom": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
        "adam": ("adam", {"learning_rate": 1e-2, "wd": 0.01}),
        "sgd_mp": ("sgd", {"learning_rate": 0.1, "multi_precision": True})}
STORE_NAMES = ("device", "local", "tpu", "nccl", "dist", "dist_sync",
               "dist_async", "dist_device_sync", "p3")


def _weights(seed=11):
    r = onp.random.RandomState(seed)
    shapes = {"0.weight": (6, 4), "0.bias": (6,), "1.weight": (3, 6),
              "1.bias": (3,)}
    return {k: (r.randn(*s) * 0.5).astype("f4") for k, s in shapes.items()}


def _batch(seed=0):
    r = onp.random.RandomState(seed)
    return (r.randn(BATCH, 4).astype("f4"),
            r.randint(0, 3, (BATCH,)).astype("f4"))


def _half(a, rank):
    h = BATCH // WORLD
    return a[rank * h:(rank + 1) * h]


def _net(shift=0.0):
    net = torch.nn.Sequential(
        Dense(6, in_units=4, activation="relu", device="cpu"),
        Dense(3, in_units=6, device="cpu"))
    load_jax_params(net, {k: v + shift for k, v in _weights().items()})
    return net


def _params(net):
    return {k: p.detach().float().numpy().copy()
            for k, p in net.named_parameters()}


def _fused_store(name="dist_sync"):
    kv = tkv.create(name)
    kv._force_fuse = True
    return kv


def _jax_fused_store(name="dist_sync"):
    import mxnet_tpu as mx
    kv = mx.kvstore.create(name)
    kv._force_fuse = True
    return kv


def _t(a):
    return torch.from_numpy(onp.array(a))


# ---------------------------------------------------------------------------
# one process: the bucketed path with _force_fuse (tests/test_kvstore_batched)
# ---------------------------------------------------------------------------

def test_fused_matches_per_key_results_and_the_jax_store():
    from mxnet_tpu import nd
    rng = onp.random.RandomState(0)
    shapes = [(4, 3), (7,), (2, 2, 2), (5, 1)]
    vals = [rng.randn(*s).astype("float32") for s in shapes]
    keys = list(range(len(shapes)))
    kv = _fused_store()
    fused = [_t(v) for v in vals]
    kv.pushpull_list(keys, fused)
    per_key = [_t(v) for v in vals]
    single = tkv.create("dist_sync")
    for k, a in zip(keys, per_key):
        single.pushpull(k, a)
    jarrs = [nd.array(v) for v in vals]
    _jax_fused_store().pushpull_list(keys, jarrs)
    for f, s, j in zip(fused, per_key, jarrs):
        onp.testing.assert_array_equal(f.numpy(), s.numpy())
        onp.testing.assert_array_equal(f.numpy(), j.asnumpy())
    assert kv.last_buckets == [sum(v.size for v in vals)]
    assert kv.stats == {"collectives": 0, "blocks": 0}


def test_fused_mixed_dtypes_bucket_separately():
    from mxnet_tpu import nd
    ins = [onp.ones((3,), "float32"), onp.full((3,), 4, "int32"),
           onp.full((2,), 2.0, "float32")]
    kv = _fused_store()
    t = [_t(a) for a in ins]
    kv.pushpull_list([0, 1, 2], t)
    j = [nd.array(a) for a in ins]
    _jax_fused_store().pushpull_list([0, 1, 2], j)
    # float32 first (its first key comes first), then int32
    assert kv.last_buckets == [5, 3]
    assert t[1].dtype == torch.int32
    for a, b in zip(t, j):
        onp.testing.assert_array_equal(a.numpy(), b.asnumpy())


def test_fused_slice_threshold_splits_buckets(monkeypatch):
    from mxnet_tpu import nd
    monkeypatch.setenv("MXNET_KVSTORE_SLICE_THRESHOLD", "8")
    ins = [onp.full((6,), float(i + 1), "float32") for i in range(4)]
    kv = _fused_store()
    t = [_t(a) for a in ins]
    kv.pushpull_list(list(range(4)), t)
    j = [nd.array(a) for a in ins]
    _jax_fused_store().pushpull_list(list(range(4)), j)
    assert kv.last_buckets == [6, 6, 6, 6]
    for a, b in zip(t, j):
        onp.testing.assert_array_equal(a.numpy(), b.asnumpy())
    monkeypatch.setenv("MXNET_KVSTORE_SLICE_THRESHOLD", "12")
    kv.pushpull_list(list(range(4)), t)
    assert kv.last_buckets == [12, 12]


def test_fused_with_updater_runs_store_optimizer():
    from mxnet_tpu import nd
    from mxnet_tpu import optimizer as jopt
    kv, jkv = _fused_store(), _jax_fused_store()
    kv.set_optimizer(topt.SGD(learning_rate=0.5))
    jkv.set_optimizer(jopt.SGD(learning_rate=0.5))
    ws = [onp.zeros((3,), "float32"), onp.zeros((2, 2), "float32")]
    gs = [onp.ones((3,), "float32"), onp.full((2, 2), 2.0, "float32")]
    for k, w in enumerate(ws):
        kv.init(k, _t(w))
        jkv.init(k, nd.array(w))
    outs = [torch.zeros(3), torch.zeros(2, 2)]
    jouts = [nd.zeros((3,)), nd.zeros((2, 2))]
    kv.pushpull_list([0, 1], [_t(g) for g in gs], outs=outs)
    jkv.pushpull_list([0, 1], [nd.array(g) for g in gs], outs=jouts)
    onp.testing.assert_allclose(outs[0].numpy(), -0.5 * onp.ones(3))
    onp.testing.assert_allclose(outs[1].numpy(), -1.0 * onp.ones((2, 2)))
    for a, b in zip(outs, jouts):
        onp.testing.assert_array_equal(a.numpy(), b.asnumpy())


def test_sparse_fallback_is_the_jax_packages_and_the_port_refuses():
    """The JAX store sends a row-sparse value down its per-key path; the
    port has no sparse storage, so its ``row_sparse_pull`` raises and
    names the queue item that ports it."""
    from mxnet_tpu import nd
    from mxnet_tpu.ndarray.sparse import RowSparseNDArray
    jkv = _jax_fused_store()
    dense = nd.array(onp.ones((3,), "float32"))
    sp = nd.sparse.row_sparse_array(
        (onp.ones((1, 2), "float32"), onp.array([1], "int32")),
        shape=(4, 2))
    jkv.pushpull_list([0, 1], [dense, sp])
    assert isinstance(sp, RowSparseNDArray)
    kv = _fused_store()
    kv.init(0, torch.ones(4, 2))
    with pytest.raises(mxt.MXNetError, match="queue 1, item 8"):
        kv.row_sparse_pull(0, out=torch.zeros(4, 2),
                           row_ids=torch.tensor([1]))


def test_trainer_uses_the_bucketed_path_once_a_step():
    """``Trainer.step`` makes ONE ``pushpull_list`` call a step and no
    per-key call; one bucket of the four float32 parameters; in one
    process no collective and no wait. The weights follow the JAX
    Trainer's with the same forced store."""
    import mxnet_tpu as mx
    from mxnet_tpu import autograd
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import nn as jnn
    calls = {"list": 0, "single": 0}
    orig_list, orig_single = KVStoreDist.pushpull_list, KVStoreDist.pushpull

    def counting_list(self, *a, **k):
        calls["list"] += 1
        return orig_list(self, *a, **k)

    def counting_single(self, *a, **k):
        calls["single"] += 1
        return orig_single(self, *a, **k)

    net, kv = _net(), _fused_store()
    x, y = _batch()
    KVStoreDist.pushpull_list = counting_list
    KVStoreDist.pushpull = counting_single
    try:
        tr = Trainer(dict(net.named_parameters()), "sgd",
                     {"learning_rate": 0.1}, kvstore=kv,
                     update_on_kvstore=False)
        for _ in range(STEPS):
            (net(_t(x)) ** 2).sum().backward()
            tr.step(BATCH)
    finally:
        KVStoreDist.pushpull_list = orig_list
        KVStoreDist.pushpull = orig_single
    assert calls == {"list": STEPS, "single": 0}
    assert kv.last_buckets == [6 * 4 + 6 + 3 * 6 + 3]
    assert kv.stats == {"collectives": 0, "blocks": 0}
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(6, in_units=4, activation="relu"))
    jnet.add(jnn.Dense(3, in_units=6))
    jnet.initialize()
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(_weights()[k]))
    jtr = JTrainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1},
                   kvstore=_jax_fused_store(), update_on_kvstore=False)
    for _ in range(STEPS):
        with autograd.record():
            loss = (jnet(mx.nd.array(x)) ** 2).sum()
        loss.backward()
        jtr.step(BATCH)
    got = _params(net)
    for k, p in jnet.collect_params().items():
        want = p.data().asnumpy()
        onp.testing.assert_allclose(got[k], want, rtol=0,
                                    atol=REL_TOL * onp.abs(want).max(),
                                    err_msg=k)


# ---------------------------------------------------------------------------
# gradient compression against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["2bit", "1bit", "fp16", "bf16"])
def test_gradient_compression_bit_equal_to_jax(kind):
    """Three rounds of two keys with error feedback: every quantized
    value and every residual bit-equal. The inputs hold values at and
    around the threshold, zeros of both signs, and values fp16 rounds to
    infinity."""
    from mxnet_tpu import nd
    from mxnet_tpu.parallel.compression import GradientCompression as JGC
    r = onp.random.RandomState(5)
    tc, jc = GradientCompression(kind, 0.3), JGC(kind, 0.3)
    for rnd in range(3):
        for key in (("w", 0), ("w", 1)):
            g = (r.randn(64) * 0.4).astype("f4")
            g[:6] = [0.3, -0.3, 0.29999998, -0.0, 0.0, 7e4]
            q = tc.compress_decompress(_t(g), key)
            jq = jc.compress_decompress(nd.array(g), key)
            onp.testing.assert_array_equal(q.numpy(), jq.asnumpy(),
                                           err_msg=f"round {rnd} {key}")
            onp.testing.assert_array_equal(
                tc._residuals[key].numpy(), onp.asarray(jc._residuals[key]),
                err_msg=f"residual, round {rnd} {key}")


def test_unknown_compression_type_raises_the_jax_packages_words():
    from mxnet_tpu.base import MXNetError as JError
    from mxnet_tpu.parallel.compression import GradientCompression as JGC
    with pytest.raises(JError) as jerr:
        JGC("3bit")
    with pytest.raises(mxt.MXNetError) as terr:
        GradientCompression("3bit")
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# names and the update_on_kvstore decision matrix in one process
# ---------------------------------------------------------------------------

def test_create_resolves_every_name_as_the_jax_package():
    import mxnet_tpu as mx
    for name in STORE_NAMES:
        kv, jkv = tkv.create(name), mx.kvstore.create(name)
        dist_ = type(jkv).__name__ == "KVStoreDist"
        assert (type(kv).__name__ == "KVStoreDist") == dist_, name
        assert kv.type == jkv.type == name
        assert kv.in_program_reduce and kv.is_capable("optimizer")
    assert tkv.create(tkv.create("p3")).type == "p3"
    for store in (tkv.create("dist"), mx.kvstore.create("dist")):
        store._force_fuse = True
        assert not store.in_program_reduce
        assert not store.in_program_reduce_scatter
    with pytest.raises(mxt.MXNetError, match="unknown kvstore type"):
        tkv.create("dist_elsewhere")


def _decisions(make):
    """``make(kvstore)`` -> a trainer whose store is set up; its
    ``update_on_kvstore`` for each store name and env setting."""
    out = {}
    for env in (None, "0", "1", "false"):
        if env is None:
            os.environ.pop("MXNET_UPDATE_ON_KVSTORE", None)
        else:
            os.environ["MXNET_UPDATE_ON_KVSTORE"] = env
        try:
            for name in STORE_NAMES:
                out[(env, name)] = bool(make(name)._update_on_kvstore)
        finally:
            os.environ.pop("MXNET_UPDATE_ON_KVSTORE", None)
    return out


def _port_decision(name):
    tr = Trainer(dict(_net().named_parameters()), "sgd", kvstore=name)
    tr._init_kvstore()
    return tr


def test_update_on_kvstore_decision_matrix_vs_jax():
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import nn as jnn

    def jax_decision(name):
        net = jnn.Dense(3, in_units=4)
        net.initialize()
        tr = JTrainer(net.collect_params(), "sgd", kvstore=name)
        tr._init_kvstore()
        return tr

    port = _decisions(_port_decision)
    assert port == _decisions(jax_decision)
    # one worker: only the env turns it on
    assert port[(None, "dist_sync")] is False and port[("1", "device")]
    tr = Trainer(dict(_net().named_parameters()), "sgd", kvstore=None)
    tr._init_kvstore()
    assert tr._update_on_kvstore is False and tr._kvstore is None


# ---------------------------------------------------------------------------
# compile_step's split program (tests/test_fused_step.py)
# ---------------------------------------------------------------------------

def test_compile_step_split_mode_host_allreduce():
    """A dist store that cannot reduce in-program (``_force_fuse`` here)
    routes the gradients through its ``pushpull_list`` between the
    gradient program and the update program; ``mode`` still reads
    ``fused``; one process sums nothing across ranks. The weights equal
    the eager step's (the same kernels' plain versions: SGD-momentum)
    within REL_TOL, and the JAX split mode's."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon import nn as jnn
    name, kw = OPTS["sgd_mom"]
    x, y = _batch()
    lb = tloss.SoftmaxCrossEntropyLoss()
    kv = _fused_store()
    assert not kv.in_program_reduce
    net_s = _net()
    tr = Trainer(dict(net_s.named_parameters()), name, dict(kw), kvstore=kv)
    calls = [0]
    orig = kv.pushpull_list

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    kv.pushpull_list = counted
    step = tr.compile_step(lambda a, b: lb(net_s(a), b))
    for _ in range(STEPS):
        step(x, y)
    assert step.mode == "fused" and step._split and step.n_traces == 1
    assert len(step._programs) == 2          # the gradient and update
    assert calls[0] == STEPS
    assert kv.stats["collectives"] == 0
    assert all(p.grad is None for p in net_s.parameters())

    net_e = _net()
    tre = Trainer(dict(net_e.named_parameters()), name, dict(kw))
    for _ in range(STEPS):
        lb(net_e(_t(x)), _t(y)).sum().backward()
        tre.step(BATCH)

    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(6, in_units=4, activation="relu"))
    jnet.add(jnn.Dense(3, in_units=6))
    jnet.initialize()
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(_weights()[k]))
    jtr = JTrainer(jnet.collect_params(), name, dict(kw),
                   kvstore=_jax_fused_store())
    jlb = jloss.SoftmaxCrossEntropyLoss()
    jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b))
    for _ in range(STEPS):
        jstep(mx.nd.array(x), mx.nd.array(y))
    assert jstep.mode == "fused"
    got = _params(net_s)
    refs = [_params(net_e), {k: p.data().asnumpy()
                             for k, p in jnet.collect_params().items()}]
    for ref in refs:
        for k, want in ref.items():
            onp.testing.assert_allclose(got[k], want, rtol=0,
                                        atol=REL_TOL * onp.abs(want).max(),
                                        err_msg=k)


def test_update_on_kvstore_makes_compile_step_eager():
    kv = _fused_store()
    net = _net()
    tr = Trainer(dict(net.named_parameters()), "sgd",
                 {"learning_rate": 0.1}, kvstore=kv, update_on_kvstore=True)
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    x, y = _batch()
    before = _params(net)
    step(x, y)
    assert step.mode == "eager" and step.n_traces == 0
    assert tr._updater is kv._updater
    assert any(not onp.array_equal(before[k], v)
               for k, v in _params(net).items())


def test_update_on_the_store_keeps_the_stale_rule():
    """Under ``update_on_kvstore`` a parameter no backward reached stops
    the step before the store updates anything; with
    ``ignore_stale_grad`` the reached ones update on the store and the
    stale one keeps its weight."""
    net = _net()
    tr = Trainer(dict(net.named_parameters()), "sgd",
                 {"learning_rate": 0.1}, kvstore=_fused_store(),
                 update_on_kvstore=True)
    x, _ = _batch()
    before = _params(net)
    net[0](_t(x)).sum().backward()          # the second layer unreached
    # the first stale parameter in the trainer's (sorted) order
    with pytest.raises(mxt.MXNetError, match="parameter 1.bias has not"):
        tr.step(BATCH)
    assert all(onp.array_equal(before[k], v)
               for k, v in _params(net).items())
    tr.step(BATCH, ignore_stale_grad=True)
    after = _params(net)
    for k in ("0.weight", "0.bias"):
        assert not onp.array_equal(after[k], before[k]), k
    for k in ("1.weight", "1.bias"):
        onp.testing.assert_array_equal(after[k], before[k])


# ---------------------------------------------------------------------------
# two gloo ranks: the store
# ---------------------------------------------------------------------------

def _store_inputs(seed=21):
    """Per key: each rank's value (key 2 an int32, so two buckets)."""
    r = onp.random.RandomState(seed)
    shapes = {0: (5, 3), 1: (4,), 2: (6,), 3: (2, 2)}
    out = {}
    for k, s in shapes.items():
        if k == 2:
            out[k] = [r.randint(-5, 5, s).astype("int32")
                      for _ in range(WORLD)]
        else:
            out[k] = [(r.randn(*s) * 0.6).astype("f4")
                      for _ in range(WORLD)]
    return out


def _store_worker():
    rank = tdist.rank()
    ins = _store_inputs()
    keys = sorted(ins)
    res = {}
    # init: rank 0's value wins, on every rank
    kv = tkv.create("dist_sync")
    w = _t(ins[0][rank])
    kv.init(0, w)
    res["init"] = w.numpy().copy()
    res["init_stats"] = dict(kv.stats)
    # pushpull, one key at a time
    kv = tkv.create("dist_sync")
    vals = [_t(ins[k][rank]) for k in keys]
    for k, v in zip(keys, vals):
        kv.pushpull(k, v)
    res["pushpull"] = [v.numpy().copy() for v in vals]
    res["pushpull_stats"] = dict(kv.stats)
    # pushpull_list, sync and async
    for name in ("dist_sync", "dist_async"):
        kv = tkv.create(name)
        vals = [_t(ins[k][rank]) for k in keys]
        kv.pushpull_list(keys, vals)
        res[name] = [v.numpy().copy() for v in vals]
        res[name + "_stats"] = dict(kv.stats)
        res[name + "_buckets"] = list(kv.last_buckets)
    # the updater on the store (SGD-momentum), two rounds into outs
    fkeys = [k for k in keys if k != 2]
    kv = tkv.create("dist_sync")
    kv.set_optimizer(topt.create("sgd", learning_rate=0.1, momentum=0.9))
    for k in fkeys:
        kv.init(k, torch.ones(ins[k][0].shape))
    outs = [torch.zeros(ins[k][0].shape) for k in fkeys]
    for _ in range(2):
        kv.pushpull_list(fkeys, [_t(ins[k][rank]) for k in fkeys],
                         outs=outs)
    res["updater"] = [o.numpy().copy() for o in outs]
    # compression: two rounds, each rank its own residual
    for ctype in ("fp16", "2bit"):
        kv = tkv.create("dist_sync")
        kv.set_gradient_compression({"type": ctype, "threshold": 0.5})
        rounds = []
        for rnd in range(2):
            vals = [_t(ins[k][rank] * (1 + rnd)) for k in fkeys]
            kv.pushpull_list(fkeys, vals)
            rounds.append([v.numpy().copy() for v in vals])
        res[ctype] = rounds
        res[ctype + "_residuals"] = [
            kv._compression._residuals[(str(k), 0)].numpy().copy()
            for k in fkeys]
    kv = tkv.create("dist_sync")
    kv.barrier()
    return res


def _jax_store_reference():
    """The JAX one-process store fed each key's ranks' values as one
    replica list."""
    import mxnet_tpu as mx
    from mxnet_tpu import nd
    from mxnet_tpu import optimizer as jopt
    ins = _store_inputs()
    keys = sorted(ins)
    fkeys = [k for k in keys if k != 2]
    ref = {}
    kv = mx.kvstore.create("local")
    out = []
    for k in keys:
        reps = [nd.array(a, dtype=a.dtype) for a in ins[k]]
        kv.pushpull(k, reps)
        out.append(reps[0].asnumpy())
    ref["sum"] = out
    kv = mx.kvstore.create("local")
    kv.set_optimizer(jopt.create("sgd", learning_rate=0.1, momentum=0.9))
    for k in fkeys:
        kv.init(k, nd.ones(ins[k][0].shape))
    outs = [nd.zeros(ins[k][0].shape) for k in fkeys]
    for _ in range(2):
        for k, o in zip(fkeys, outs):
            kv.pushpull(k, [nd.array(a) for a in ins[k]], out=o)
    ref["updater"] = [o.asnumpy() for o in outs]
    for ctype in ("fp16", "2bit"):
        kv = mx.kvstore.create("local")
        kv.set_gradient_compression({"type": ctype, "threshold": 0.5})
        rounds = []
        for rnd in range(2):
            got = []
            for k in fkeys:
                reps = [nd.array(a * (1 + rnd)) for a in ins[k]]
                kv.pushpull(k, reps)
                got.append(reps[0].asnumpy())
            rounds.append(got)
        ref[ctype] = rounds
    return ref


@pytest.fixture(scope="module")
def store_ranks():
    return tdist.spawn(_store_worker, WORLD, "cpu", (),
                       timeout_s=SPAWN_TIMEOUT_S)


def test_init_broadcasts_rank_0s_value(store_ranks):
    want = _store_inputs()[0][0]
    for r in store_ranks:
        onp.testing.assert_array_equal(r["init"], want)
        # one broadcast, and in dist_sync one host wait for it
        assert r["init_stats"] == {"collectives": 1, "blocks": 1}


@pytest.mark.parametrize("path", ["pushpull", "dist_sync", "dist_async"])
def test_sums_across_ranks_equal_the_jax_replica_sum(store_ranks, path):
    ref = _jax_store_reference()["sum"]
    for r in store_ranks:
        for got, want in zip(r[path], ref):
            assert got.dtype == want.dtype
            onp.testing.assert_array_equal(got, want)
    stats = store_ranks[0][path + "_stats"]
    if path == "pushpull":          # one collective and one wait a key
        assert stats == {"collectives": 4, "blocks": 4}
    else:   # float32 keys in one bucket, the int32 key in another
        assert store_ranks[0][path + "_buckets"] == [15 + 4 + 4, 6]
        assert stats == {"collectives": 2,
                         "blocks": 0 if path == "dist_async" else 1}


def test_async_equals_sync_bit_for_bit(store_ranks):
    for r in store_ranks:
        for a, b in zip(r["dist_async"], r["dist_sync"]):
            onp.testing.assert_array_equal(a, b)


def test_updater_on_the_store_vs_jax(store_ranks):
    ref = _jax_store_reference()["updater"]
    for r in store_ranks:
        for got, want in zip(r["updater"], ref):
            onp.testing.assert_allclose(got, want, rtol=0,
                                        atol=REL_TOL * onp.abs(want).max())
    for a, b in zip(store_ranks[0]["updater"], store_ranks[1]["updater"]):
        onp.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ctype", ["fp16", "2bit"])
def test_compressed_sums_equal_the_jax_replicas(store_ranks, ctype):
    """Each rank compresses its own value with its own residual and the
    compressed values are summed: the JAX store does the same over a
    replica list, bit for bit over two rounds; 2bit's residuals are
    non-zero and finite."""
    ref = _jax_store_reference()[ctype]
    for r in store_ranks:
        for rnd, (got, want) in enumerate(zip(r[ctype], ref)):
            for g, w in zip(got, want):
                onp.testing.assert_array_equal(g, w, err_msg=f"round {rnd}")
    if ctype == "2bit":
        for r in store_ranks:
            res = onp.concatenate([a.ravel() for a in r["2bit_residuals"]])
            assert onp.isfinite(res).all() and onp.abs(res).max() > 0


# ---------------------------------------------------------------------------
# two gloo ranks: the Trainer over a dist store
# ---------------------------------------------------------------------------

#: scenario -> (kvstore name, optimizer, Trainer keywords, how)
SCENARIOS = {
    "sync": ("dist_sync", "adam", {"update_on_kvstore": False}, "eager"),
    "on_store": ("dist_sync", "adam", {}, "eager"),
    "fp16": ("dist_sync", "sgd", {"update_on_kvstore": False,
                                  "compression_params": {"type": "fp16"}},
             "eager"),
    "async": ("dist_async", "adam", {"update_on_kvstore": False}, "eager"),
    "unreached": ("dist_sync", "adam", {"update_on_kvstore": False},
                  "unreached"),
    "split": ("dist_sync", "sgd_mom", {"update_on_kvstore": False},
              "compiled"),
    "split_adam": ("dist_sync", "adam", {"update_on_kvstore": False},
                   "compiled"),
    "eager_mom": ("dist_sync", "sgd_mom", {"update_on_kvstore": False},
                  "eager"),
    "mesh": ("dist_sync", "sgd_mom", {"update_on_kvstore": False}, "mesh"),
    "mesh_fp16": ("dist_sync", "sgd", {"update_on_kvstore": False,
                                       "compression_params": {
                                           "type": "fp16"}}, "mesh"),
    "mesh_masters": ("dist_sync", "sgd_mp", {"update_on_kvstore": False},
                     "mesh"),
}


def _scenario(name, tmp):
    """One rank's STEPS steps of a scenario. The compiled step sets its
    store up at its first call, before the forward, so there the ranks
    start from different weights (rank 1's shifted by 1) and the store's
    init gives rank 1 rank 0's; the eager ``Trainer.step`` sets it up
    after the first backward (the JAX package's order), so there they
    start equal. Under a dp mesh every rank passes the whole batch and
    the compiled step keeps the rank's half."""
    store, opt, kw, how = SCENARIOS[name]
    rank = tdist.rank()
    net = _net(shift=float(rank) if how in ("compiled", "mesh") else 0.0)
    oname, okw = OPTS[opt]
    if okw.get("multi_precision"):
        net.to(torch.bfloat16)
    dtype = next(net.parameters()).dtype
    tr = Trainer(dict(net.named_parameters()), oname, dict(okw),
                 kvstore=store, **kw)
    lb = tloss.SoftmaxCrossEntropyLoss()
    x, y = (_t(_half(a, rank)) for a in _batch())
    calls = [0]
    orig = KVStoreDist.pushpull_list

    def counted(self, *a, **k):
        calls[0] += 1
        return orig(self, *a, **k)

    KVStoreDist.pushpull_list = counted
    out = {}
    try:
        if how == "compiled":
            step = tr.compile_step(lambda a, b: lb(net(a), b))
            for _ in range(STEPS):
                step(x, y, batch_size=BATCH)
            out["mode"] = (step.mode, step._split, step.n_traces)
        elif how == "mesh":
            whole = [_t(a) for a in _batch()]
            with make_mesh({"dp": WORLD}):
                step = tr.compile_step(
                    lambda a, b: lb(net(a.to(dtype)).float(), b))
                losses = [step(*whole).numpy() for _ in range(STEPS)]
            out["mode"] = (step.mode, step._split, step.n_traces)
            out["loss_shape"] = losses[0].shape
        else:
            for _ in range(STEPS):
                if how == "unreached" and rank == 1:
                    net[0](x).sum().backward()
                else:
                    lb(net(x), y).sum().backward()
                tr.step(BATCH)
    finally:
        KVStoreDist.pushpull_list = orig
    out.update(params=_params(net), stats=dict(tr._kvstore.stats),
               list_calls=calls[0], on_store=tr._update_on_kvstore)
    if name == "on_store":
        f = os.path.join(tmp, f"states{rank}")
        tr.save_states(f)
        before = tr._kvstore._updater.get_states()
        tr._kvstore._updater.states = {}
        tr.load_states(f)
        out["states_round_trip"] = \
            tr._kvstore._updater.get_states() == before
        out["one_updater"] = tr._updater is tr._kvstore._updater
    return out


def _trainer_worker(tmp):
    torch.set_num_threads(1)
    out = {name: _scenario(name, tmp) for name in SCENARIOS}
    out["decisions"] = _decisions(_port_decision)
    return out


def _jax_trainer(opt, kind="full", **kw):
    """The JAX Trainer, eagerly, in one process on the whole batch, from
    rank 0's weights."""
    import mxnet_tpu as mx
    from mxnet_tpu import autograd as jautograd
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon import nn as jnn
    net = jnn.HybridSequential()
    net.add(jnn.Dense(6, in_units=4, activation="relu"))
    net.add(jnn.Dense(3, in_units=6))
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(_weights()[k]))
    name, okw = OPTS[opt]
    tr = JTrainer(net.collect_params(), name, dict(okw), **kw)
    lb = jloss.SoftmaxCrossEntropyLoss()
    x, y = _batch()
    for _ in range(STEPS):
        with jautograd.record():
            if kind == "full":
                loss = lb(net(mx.nd.array(x)), mx.nd.array(y)).sum()
            else:       # rank 1's half reaches the first layer alone
                loss = lb(net(mx.nd.array(_half(x, 0))),
                          mx.nd.array(_half(y, 0))).sum() + \
                    net[0](mx.nd.array(_half(x, 1))).sum()
        loss.backward()
        tr.step(BATCH)
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def trainer_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("states"))
    return tdist.spawn(_trainer_worker, WORLD, "cpu", (tmp,),
                       timeout_s=SPAWN_TIMEOUT_S)


def _held(ranks, name, ref, atol_of):
    for k, want in ref.items():
        for r in ranks:
            onp.testing.assert_allclose(r[name]["params"][k], want, rtol=0,
                                        atol=atol_of(want), err_msg=k)
    for k, got in ranks[1][name]["params"].items():
        onp.testing.assert_array_equal(got, ranks[0][name]["params"][k])


@pytest.mark.parametrize("name", ["sync", "on_store", "async", "unreached",
                                  "split", "split_adam", "eager_mom",
                                  "mesh"])
def test_dist_trainer_matches_the_jax_trainer_on_the_whole_batch(
        trainer_ranks, name):
    """Each step's gradients are summed through the store (the compiled
    step's ranks starting from different weights, which the store's init
    makes rank 0's): the weights follow the JAX Trainer's on the whole
    batch from rank 0's weights, and are bit-equal on the two ranks."""
    _, opt, kw, how = SCENARIOS[name]
    jkw = {"update_on_kvstore": True, "kvstore": "dist_sync"} \
        if name == "on_store" else {}
    ref = _jax_trainer(opt, "unreached" if how == "unreached" else "full",
                       **jkw)
    _held(trainer_ranks, name, ref, lambda w: REL_TOL * onp.abs(w).max())
    r0 = trainer_ranks[0][name]
    # init: one broadcast a parameter (a host wait each in dist_sync)
    init = {"collectives": 4, "blocks": 0 if name == "async" else 4}
    if name == "on_store":
        # one push a parameter a step, each one collective and one wait
        assert r0["on_store"] is True and r0["list_calls"] == 0
        assert r0["stats"] == {"collectives": 4 + 4 * STEPS,
                               "blocks": 4 + 4 * STEPS}
        assert r0["states_round_trip"] and r0["one_updater"]
    else:
        # one pushpull_list a step: one bucket, one wait (none in async)
        assert r0["on_store"] is False and r0["list_calls"] == STEPS
        assert r0["stats"] == {
            "collectives": init["collectives"] + STEPS,
            "blocks": init["blocks"] + (0 if name == "async" else STEPS)}
    if how in ("compiled", "mesh"):
        assert r0["mode"] == ("fused", True, 1)


def test_dist_compiled_split_step_equals_the_eager_dist_step(trainer_ranks):
    """compile_step's split program against the eager dist step, SGD-
    momentum, on the same ranks: the same sums through the same store,
    the update rule's plain version against the eager one."""
    for r in trainer_ranks:
        for k, got in r["split"]["params"].items():
            want = r["eager_mom"]["params"][k]
            onp.testing.assert_allclose(got, want, rtol=0,
                                        atol=REL_TOL * onp.abs(want).max())


def test_dist_trainer_fp16_compression(trainer_ranks):
    """fp16 compression of each rank's gradient: within FP16_ATOL of the
    JAX Trainer without compression, and not equal to the uncompressed
    run (the rounding reached the weights)."""
    ref = _jax_trainer("sgd")
    _held(trainer_ranks, "fp16", ref, lambda w: FP16_ATOL)
    r0 = trainer_ranks[0]["fp16"]["params"]
    assert any(not onp.array_equal(r0[k], ref[k]) for k in ref)


def test_dist_store_under_a_mesh_sums_through_the_store(trainer_ranks):
    """A dist store under an active dp mesh: the split program (not the
    ``mesh`` mode's all-reduces, which would bypass the store), each rank
    keeping its half of the global batch; one ``pushpull_list`` a step,
    so fp16 compression reaches the weights: within FP16_ATOL of the JAX
    Trainer without compression on the whole batch, not equal to it, and
    bit-equal on the two ranks. Each rank returns the global batch's
    per-sample loss."""
    ref = _jax_trainer("sgd")
    _held(trainer_ranks, "mesh_fp16", ref, lambda w: FP16_ATOL)
    for r in trainer_ranks:
        got = r["mesh_fp16"]
        assert got["mode"] == ("fused", True, 1)
        assert got["list_calls"] == STEPS and got["on_store"] is False
        assert got["stats"] == {"collectives": 4 + STEPS,
                                "blocks": 4 + STEPS}
        assert got["loss_shape"] == (BATCH,)
    r0 = trainer_ranks[0]["mesh_fp16"]["params"]
    assert any(not onp.array_equal(r0[k], ref[k]) for k in ref)


def test_masters_under_a_mesh_reduce_through_the_store(trainer_ranks):
    """bfloat16 weights with float32 masters (``multi_precision``) under
    a dp mesh and a dist store: the ``mesh`` mode (masters fuse only
    through the sharded update, which a dist store never takes), its
    gradients summed by one ``pushpull_list`` a step, not by the mesh's
    all-reduces; within BF16_ATOL of the JAX float32 Trainer on the
    whole batch and bit-equal on the two ranks."""
    _held(trainer_ranks, "mesh_masters", _jax_trainer("sgd"),
          lambda w: BF16_ATOL)
    for r in trainer_ranks:
        got = r["mesh_masters"]
        assert got["mode"] == ("mesh", False, 0)
        assert got["list_calls"] == STEPS
        assert got["stats"] == {"collectives": 4 + STEPS,
                                "blocks": 4 + STEPS}


def test_decision_matrix_with_two_workers(trainer_ranks):
    """With two workers a store whose type names "dist" updates on the
    store by default (the JAX package's rule: not ``p3``, a KVStoreDist
    all the same); the env overrides either way; a one-process store
    never does unless told."""
    for r in trainer_ranks:
        d = r["decisions"]
        for name in STORE_NAMES:
            assert d[(None, name)] is ("dist" in name), name
            assert d[("1", name)] is True and d[("0", name)] is False
            assert d[("false", name)] is False
