"""``Trainer.step`` across ranks: an eager ``loss.backward();
trainer.step(global_batch_size)`` on each of two gloo ranks, each
holding its half of a seeded batch, updates from the gradient of the
global batch (``Trainer.allreduce_grads``), with a mesh active and
without one; a parameter that one rank's backward leaves unreached is
reduced all the same (zeros from that rank), and one that no rank
reached stays stale on both; ``compile_step``'s ``mesh`` mode reduces
each gradient exactly once through the same path; and the compiled step
(``zero`` and ``mesh`` modes) and ``TrainLoop.step`` return the GLOBAL
batch's per-sample loss on every rank, as the JAX package's step does.

The reference is the JAX package's ``gluon.Trainer`` stepping eagerly in
one process on the whole batch from the same weights, and beside it the
port's own Trainer doing the same. Tolerance: weights within 1e-6 of the
largest |weight| of their tensor, since the two ranks' partial sums are
added in another order than the one-process sum (and XLA's CPU products
round apart from torch's); the two ranks end bit-equal to each other
(one all-reduce gives every rank the same sum). Losses: within 1e-6 of
the JAX package's compiled step under a dp 2 mesh (the 8-device CPU
platform) and of the port's one-process compiled step, for the same
reasons; equal bit for bit on the two ranks (one all-gather).

The ranks import this module to find their workers, so JAX is imported
inside the reference function alone.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.gluon import Trainer, TrainLoop
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.parallel import make_mesh

WORLD = 2
BATCH = 8
STEPS = 3
SPAWN_TIMEOUT_S = 90
REL_TOL = 1e-6
LOSS_ATOL = 1e-6
N_PARAMS = 4
OPTS = {"sgd": ("sgd", {"learning_rate": 0.1}),
        "sgd_mom": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
        "adam": ("adam", {"learning_rate": 1e-2, "wd": 0.01})}
#: which parameters each rank's loss reaches: "full" all of them on both
#: ranks; "rank1_first_layer": rank 1's loss is the first layer's output
#: alone, so its backward leaves the second layer unreached;
#: "first_layer_only": both ranks' losses are, so no rank reaches it and
#: the step skips it (``ignore_stale_grad=True``)
LOSSES = ("full", "rank1_first_layer", "first_layer_only")


def _weights(seed=11):
    r = onp.random.RandomState(seed)
    shapes = {"0.weight": (6, 4), "0.bias": (6,), "1.weight": (3, 6),
              "1.bias": (3,)}
    return {k: (r.randn(*s) * 0.5).astype("f4") for k, s in shapes.items()}


def _batch(seed=0):
    r = onp.random.RandomState(seed)
    return (r.randn(BATCH, 4).astype("f4"),
            r.randint(0, 3, (BATCH,)).astype("f4"))


def _halves(a):
    half = BATCH // WORLD
    return [a[r * half:(r + 1) * half] for r in range(WORLD)]


def _net():
    net = torch.nn.Sequential(
        Dense(6, in_units=4, activation="relu", device="cpu"),
        Dense(3, in_units=6, device="cpu"))
    load_jax_params(net, _weights())
    return net


def _params(net):
    return {k: p.detach().numpy().copy() for k, p in net.named_parameters()}


def _rank_loss(net, lb, x, y, kind, rank):
    """The summed loss of one rank's rows, under the reach of ``kind``
    (works on either package's network)."""
    if kind == "full" or (kind == "rank1_first_layer" and rank == 0):
        return lb(net(x), y).sum()
    return net[0](x).sum()


def _count_all_reduce(counter):
    """Wrap ``torch.distributed.all_reduce`` so each call adds one to
    ``counter[0]`` (the Trainer looks it up at call time)."""
    real = torch.distributed.all_reduce

    def counted(*a, **kw):
        counter[0] += 1
        return real(*a, **kw)

    torch.distributed.all_reduce = counted


def _eager_worker(opt, with_mesh, kind):
    """One rank: its half of the batch, ``loss.backward();
    trainer.step(BATCH)`` for STEPS steps."""
    torch.set_num_threads(1)
    calls = [0]
    _count_all_reduce(calls)
    net = _net()
    name, kw = OPTS[opt]
    tr = Trainer(dict(net.named_parameters()), name, dict(kw))
    lb = tloss.SoftmaxCrossEntropyLoss()
    r = tdist.rank()
    x, y = (torch.from_numpy(h[r]) for h in map(_halves, _batch()))
    mesh = make_mesh({"dp": WORLD}) if with_mesh else None
    stale_ok = kind == "first_layer_only"
    for _ in range(STEPS):
        if mesh is not None:
            with mesh:
                _rank_loss(net, lb, x, y, kind, r).backward()
                tr.step(BATCH, ignore_stale_grad=stale_ok)
        else:
            _rank_loss(net, lb, x, y, kind, r).backward()
            tr.step(BATCH, ignore_stale_grad=stale_ok)
    return {"params": _params(net), "all_reduce_calls": calls[0]}


def _compiled_worker(opt, sharded_batch):
    """One rank: ``compile_step(mesh=...)`` with the sharded update off
    (the ``mesh`` mode), given the global batch (each rank keeps its
    half, the gradients are summed) or a batch of 5 rows, which does not
    divide by 2, so every rank computes it whole (a mean)."""
    torch.set_num_threads(1)
    calls = [0]
    _count_all_reduce(calls)
    net = _net()
    name, kw = OPTS[opt]
    tr = Trainer(dict(net.named_parameters()), name, dict(kw))
    lb = tloss.SoftmaxCrossEntropyLoss()
    x, y = (torch.from_numpy(a) for a in _batch())
    if not sharded_batch:
        x, y = x[:5], y[:5]
    mesh = make_mesh({"dp": WORLD})
    step = tr.compile_step(lambda a, b: lb(net(a), b), zero_shard=False,
                           mesh=mesh)
    for _ in range(STEPS):
        step(x, y)
    return {"params": _params(net), "all_reduce_calls": calls[0],
            "mode": step.mode}


def _rows(rows, kind):
    """The one-process reference's (x, y, rank) parts: the whole batch as
    one part for "full", else each rank's half under its own loss."""
    x, y = _batch()
    if kind == "full":
        return [(x[:rows], y[:rows], 0)]
    return list(zip(_halves(x), _halves(y), range(WORLD)))


def _one_process(opt, rows=BATCH, kind="full"):
    """The port's Trainer in one process on the global batch."""
    net = _net()
    name, kw = OPTS[opt]
    tr = Trainer(dict(net.named_parameters()), name, dict(kw))
    lb = tloss.SoftmaxCrossEntropyLoss()
    for _ in range(STEPS):
        sum(_rank_loss(net, lb, torch.from_numpy(x), torch.from_numpy(y),
                       kind, r) for x, y, r in _rows(rows, kind)).backward()
        tr.step(rows, ignore_stale_grad=kind == "first_layer_only")
    return _params(net)


def _jax_one_process(opt, rows=BATCH, kind="full"):
    """The JAX package's Trainer, eagerly, in one process on the global
    batch, from the same weights."""
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
    name, kw = OPTS[opt]
    tr = JTrainer(net.collect_params(), name, dict(kw))
    lb = jloss.SoftmaxCrossEntropyLoss()
    for _ in range(STEPS):
        with jautograd.record():
            loss = sum(_rank_loss(net, lb, mx.nd.array(x), mx.nd.array(y),
                                  kind, r) for x, y, r in _rows(rows, kind))
        loss.backward()
        tr.step(rows, ignore_stale_grad=kind == "first_layer_only")
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _assert_matches(ranks, opt, rows=BATCH, kind="full"):
    """Both ranks against the JAX reference and the port's one-process
    step, and bit-equal to each other."""
    for ref in (_jax_one_process(opt, rows, kind),
                _one_process(opt, rows, kind)):
        assert sorted(ref) == sorted(ranks[0]["params"])
        for k, want in ref.items():
            scale = float(onp.abs(want).max())
            for r in ranks:
                onp.testing.assert_allclose(r["params"][k], want, rtol=0,
                                            atol=REL_TOL * scale, err_msg=k)
    for r in ranks[1:]:
        for k, got in r["params"].items():
            onp.testing.assert_array_equal(got, ranks[0]["params"][k])


@pytest.mark.parametrize("with_mesh", [False, True])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_eager_step_across_ranks_matches_global_batch(opt, with_mesh):
    ranks = tdist.spawn(_eager_worker, WORLD, "cpu", (opt, with_mesh, "full"),
                        timeout_s=SPAWN_TIMEOUT_S)
    _assert_matches(ranks, opt)
    # per step: one all-reduce of the fresh flags, then one per trainable
    # parameter, on every rank
    assert all(r["all_reduce_calls"] == STEPS * (1 + N_PARAMS)
               for r in ranks)


@pytest.mark.parametrize("kind", ["rank1_first_layer", "first_layer_only"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_eager_step_with_a_parameter_a_rank_leaves_unreached(opt, kind):
    """The ranks agree on what to reduce: where rank 1 never reaches the
    second layer, both still reduce its gradient (rank 1 adding zeros) in
    the same order, rather than pairing different parameters' collectives
    or waiting on each other; where no rank reaches it, neither reduces
    nor updates it."""
    ranks = tdist.spawn(_eager_worker, WORLD, "cpu", (opt, False, kind),
                        timeout_s=SPAWN_TIMEOUT_S)
    _assert_matches(ranks, opt, kind=kind)
    reduced = N_PARAMS if kind == "rank1_first_layer" else 2
    assert all(r["all_reduce_calls"] == STEPS * (1 + reduced) for r in ranks)
    if kind == "first_layer_only":
        for k in ("1.weight", "1.bias"):
            onp.testing.assert_array_equal(ranks[0]["params"][k],
                                           _weights()[k])


@pytest.mark.parametrize("sharded_batch", [True, False])
def test_compiled_mesh_step_reduces_once(sharded_batch):
    """The ``mesh`` mode reduces through ``Trainer.allreduce_grads``
    once a step: a second reduction would double every gradient (a sum)
    and show in the SGD-momentum weights."""
    ranks = tdist.spawn(_compiled_worker, WORLD, "cpu",
                        ("sgd_mom", sharded_batch),
                        timeout_s=SPAWN_TIMEOUT_S)
    assert all(r["mode"] == "mesh" for r in ranks)
    _assert_matches(ranks, "sgd_mom", BATCH if sharded_batch else 5)
    assert all(r["all_reduce_calls"] == STEPS * (1 + N_PARAMS)
               for r in ranks)


def test_allreduce_grads_is_a_no_op_in_one_process():
    net = _net()
    tr = Trainer(dict(net.named_parameters()), "sgd", {"learning_rate": 0.1})
    lb = tloss.SoftmaxCrossEntropyLoss()
    x, y = (torch.from_numpy(a) for a in _batch())
    lb(net(x), y).sum().backward()
    before = {k: p.grad.clone() for k, p in net.named_parameters()}
    calls = [0]
    real = torch.distributed.all_reduce
    try:
        _count_all_reduce(calls)
        tr.allreduce_grads()
        tr.allreduce_grads(mean=True)
    finally:
        torch.distributed.all_reduce = real
    assert calls[0] == 0
    for k, p in net.named_parameters():
        assert torch.equal(p.grad, before[k])


# ---------------------------------------------------------------------------
# the loss a data-parallel step returns
# ---------------------------------------------------------------------------

#: how the step is driven on each rank: compile_step's ``zero`` mode (the
#: sharded update), its ``mesh`` mode (all-reduce, replicated update), or
#: ``TrainLoop.step`` (the zero mode through the dispatch window)
LOSS_STEPS = {"zero": ("zero", None), "mesh": ("mesh", False),
                "loop": ("zero", None)}


def _loss_worker(how, rows):
    """One rank: STEPS SGD-momentum steps on the global batch of ``rows``
    rows under a dp mesh of both ranks; the loss each step returned."""
    torch.set_num_threads(1)
    net = _net()
    name, kw = OPTS["sgd_mom"]
    tr = Trainer(dict(net.named_parameters()), name, dict(kw))
    lb = tloss.SoftmaxCrossEntropyLoss()
    x, y = (torch.from_numpy(a[:rows]) for a in _batch())
    losses = []
    with make_mesh({"dp": WORLD}):
        if how == "loop":
            loop = TrainLoop(net, tr, lb)
            run, step = loop.step, loop.compiled_step
        else:
            step = tr.compile_step(lambda a, b: lb(net(a), b),
                                   zero_shard=LOSS_STEPS[how][1])
            run = step
        for _ in range(STEPS):
            losses.append(run(x, y).numpy().copy())
        if how == "loop":
            loop.synchronize()
    return {"losses": losses, "mode": step.mode}


def _one_process_losses(rows):
    """The port's compiled step in one process on the global batch."""
    net = _net()
    name, kw = OPTS["sgd_mom"]
    tr = Trainer(dict(net.named_parameters()), name, dict(kw))
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    x, y = (torch.from_numpy(a[:rows]) for a in _batch())
    return [step(x, y).numpy() for _ in range(STEPS)]


def _jax_dp_losses(rows, zero_shard):
    """The JAX package's compiled step under a dp mesh of WORLD devices,
    given the global batch, from the same weights."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    net = jnn.HybridSequential()
    net.add(jnn.Dense(6, in_units=4, activation="relu"))
    net.add(jnn.Dense(3, in_units=6))
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(_weights()[k]))
    name, kw = OPTS["sgd_mom"]
    tr = JTrainer(net.collect_params(), name, dict(kw))
    lb = jloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b), zero_shard=zero_shard)
    x, y = (a[:rows] for a in _batch())
    with jmake_mesh({"dp": WORLD}, jax.devices()[:WORLD]):
        return [step(mx.nd.array(x), mx.nd.array(y)).asnumpy()
                for _ in range(STEPS)]


@pytest.mark.parametrize("rows", [BATCH, 5])
@pytest.mark.parametrize("how", sorted(LOSS_STEPS))
def test_dp_step_returns_the_global_batch_loss(how, rows):
    """Each rank returns the loss of every row of the global batch, in
    the batch's order: one all-gather of the ranks' halves. A batch of 5
    rows does not divide by 2, so each rank computes it whole and returns
    that whole-batch loss as it is."""
    ranks = tdist.spawn(_loss_worker, WORLD, "cpu", (how, rows),
                        timeout_s=SPAWN_TIMEOUT_S)
    mode, zero_shard = LOSS_STEPS[how]
    assert all(r["mode"] == mode for r in ranks)
    refs = {"port one process": _one_process_losses(rows),
            "JAX dp mesh": _jax_dp_losses(rows, zero_shard)}
    for what, ref in refs.items():
        for i, want in enumerate(ref):
            assert want.shape == (rows,)
            for r in ranks:
                assert r["losses"][i].shape == (rows,)
                onp.testing.assert_allclose(r["losses"][i], want, rtol=0,
                                            atol=LOSS_ATOL,
                                            err_msg=f"{what}, step {i}")
    for i in range(STEPS):
        onp.testing.assert_array_equal(ranks[1]["losses"][i],
                                       ranks[0]["losses"][i])
