"""``gluon.data.DevicePrefetcher`` and ``TrainLoop.prefetch`` of the
port, on the CPU (``device="cpu"``: staging is a plain ``.to()``; the
card's pinned copies on a side stream are in ``tests/test_torch_cuda.py``).

Covers the JAX package's prefetcher contract (``tests/
test_async_engine.py``): order and structure kept, the depth bound, the
producer's exception carried to the consumer, the staged batches
released on an early break, the stats, the timeout, depth 0 (inline),
the ``prefetch.stage`` fault points, and under a dp mesh of two gloo
ranks each rank staging only its own rows, which the step passes
through. ``TrainLoop.prefetch`` trains bit for bit like plain steps (the
same tensors reach the same step) and within 1e-5 of the JAX
``TrainLoop`` driven through its own ``prefetch`` (the tolerance of
``test_torch_zero.py``'s MLP runs).
"""
import gc
import threading
import time

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import TrainLoop
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.data import DevicePrefetcher
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.parallel import make_mesh as tmake_mesh
from mxnet_tpu_torch.testing import faults
from mxnet_tpu_torch.testing.faults import FaultInjectedError

from test_torch_zero import _jax_mlp, _mlp_weights, _torch_mlp

SPAWN_TIMEOUT_S = 90


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    yield
    faults.reset()


def _host_batches(n=4, bs=8, seed=0):
    rng = onp.random.RandomState(seed)
    return [(rng.randn(bs, 4).astype("f4"),
             rng.randint(0, 3, size=(bs,)).astype("f4")) for _ in range(n)]


# ---------------------------------------------------------------------------
# the prefetcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_order_values_and_stats(depth):
    host = _host_batches(6)
    pf = DevicePrefetcher(iter(host), depth=depth, device="cpu")
    out = list(pf)
    assert len(out) == 6
    for (hx, hy), (dx, dy) in zip(host, out):
        assert isinstance(dx, torch.Tensor) and dx.device.type == "cpu"
        onp.testing.assert_array_equal(dx.numpy(), hx)
        onp.testing.assert_array_equal(dy.numpy(), hy)
    st = pf.stats_snapshot()
    assert st["prefetch_batches"] == 6 and st["prefetch_depth"] == depth
    assert st["input_wait_ms"] >= 0.0
    assert st["starvation_count"] >= (0 if depth == 0 else 1)


def test_structure_and_leaf_types_are_kept():
    x = onp.arange(6, dtype="f4").reshape(3, 2)
    t = torch.arange(3)
    batch = {"a": (x, [t, None]), "b": 7, "c": "tag"}
    (got,) = list(DevicePrefetcher([batch], depth=2, device="cpu"))
    assert set(got) == {"a", "b", "c"}
    assert isinstance(got["a"], tuple) and isinstance(got["a"][1], list)
    onp.testing.assert_array_equal(got["a"][0].numpy(), x)
    assert torch.equal(got["a"][1][0], t) and got["a"][1][1] is None
    assert got["b"] == 7 and got["c"] == "tag"


def test_depth_bounds_the_producer():
    """The producer runs at most ``depth`` staged batches, one it is
    putting and one it is staging ahead of the consumer."""
    produced = []

    def batches():
        for i in range(1000):
            produced.append(i)
            yield onp.full((2,), i, "f4")

    pf = DevicePrefetcher(batches(), depth=2, device="cpu")
    it = iter(pf)
    next(it)
    time.sleep(0.3)                  # let the producer fill the queue
    assert len(produced) <= 1 + 2 + 2
    it.close()


def test_producer_exception_reaches_the_consumer():
    def batches():
        yield onp.zeros((2, 2), "f4")
        raise ValueError("dataset exploded")

    it = iter(DevicePrefetcher(batches(), depth=2, device="cpu"))
    next(it)
    with pytest.raises(ValueError, match="dataset exploded"):
        next(it)


def test_early_break_stops_the_producer_and_drops_staged_batches():
    produced = []

    def batches():
        for i in range(1000):
            produced.append(i)
            yield onp.full((4,), i, "f4")

    pf = DevicePrefetcher(batches(), depth=3, device="cpu")
    for i, b in enumerate(pf):
        if i == 2:
            break
    del b
    gc.collect()
    assert len(produced) <= 3 + 3 + 2
    assert pf.staged_alive() == 0


def test_timeout_raises():
    def batches():
        yield onp.zeros(2, "f4")
        time.sleep(2.0)
        yield onp.ones(2, "f4")

    it = iter(DevicePrefetcher(batches(), depth=1, device="cpu",
                               timeout=0.2))
    next(it)
    with pytest.raises(MXNetError, match="no batch within"):
        next(it)
    it.close()


def test_depth_zero_stages_inline():
    threads = []

    def batches():
        for i in range(3):
            threads.append(threading.current_thread())
            yield onp.full((2,), i, "f4")

    out = list(DevicePrefetcher(batches(), depth=0, device="cpu"))
    assert [float(b[0]) for b in out] == [0.0, 1.0, 2.0]
    assert set(threads) == {threading.current_thread()}


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_stage_fault_points(depth):
    """One ``prefetch.stage`` hit a batch (not a leaf), before and
    after; an injected error reaches the consumer at that batch."""
    faults.configure("prefetch.stage:before=3:error")
    it = iter(DevicePrefetcher(iter(_host_batches(5)), depth=depth,
                               device="cpu"))
    next(it)
    next(it)
    with pytest.raises(FaultInjectedError, match="prefetch.stage"):
        next(it)
    it.close()
    assert faults.hit_counts()[("prefetch.stage", "before")] == 3
    assert faults.hit_counts()[("prefetch.stage", "after")] == 2


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is cuda:0")
    with pytest.raises(MXNetError, match="no CUDA device"):
        DevicePrefetcher(iter(_host_batches(1)))


# ---------------------------------------------------------------------------
# TrainLoop.prefetch
# ---------------------------------------------------------------------------

def _loop(weights):
    net = _torch_mlp(weights)
    tr = TTrainer(dict(net.named_parameters()), "adam",
                  {"learning_rate": 1e-2})
    return net, TrainLoop(net, tr, tloss.SoftmaxCrossEntropyLoss())


def test_trainloop_prefetch_bit_equal_to_plain_steps_and_vs_jax():
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import TrainLoop as JTrainLoop
    from mxnet_tpu.gluon import loss as jloss
    weights, host = _mlp_weights(), _host_batches(5)
    net_a, plain = _loop(weights)
    ref = [plain.step(x, y).numpy().copy() for x, y in host]
    plain.synchronize()
    net_b, loop = _loop(weights)
    got = [loop.step(x, y).numpy().copy()
           for x, y in loop.prefetch(iter(host), depth=2)]
    loop.synchronize()
    for a, b in zip(got, ref):
        onp.testing.assert_array_equal(a, b)
    for (k, p), q in zip(net_b.named_parameters(), net_a.parameters()):
        assert torch.equal(p, q), k
    st = loop.engine_stats()
    assert st["prefetch_batches"] == 5 and st["prefetch_depth"] == 2
    assert {"input_wait_ms", "starvation_count", "retires"} <= set(st)
    jnet = _jax_mlp(weights)
    jloop = JTrainLoop(jnet, JTrainer(jnet.collect_params(), "adam",
                                      {"learning_rate": 1e-2}),
                       jloss.SoftmaxCrossEntropyLoss())
    jgot = [jloop.step(x, y).asnumpy() for x, y in jloop.prefetch(
        (mx.nd.array(x), mx.nd.array(y)) for x, y in host)]
    jloop.synchronize()
    for a, b in zip(got, jgot):
        onp.testing.assert_allclose(a, b, atol=1e-5)


def _rank_prefetch(weights, host):
    """One rank under a dp mesh: plain steps, then ``loop.prefetch``;
    what each rank staged (shape, split mark) and both runs' losses."""
    torch.set_num_threads(1)
    out = {}
    with tmake_mesh({"dp": tdist.size()}):
        net_a, plain = _loop(weights)
        out["plain"] = [plain.step(x, y).numpy().copy() for x, y in host]
        plain.synchronize()
        net_b, loop = _loop(weights)
        rows, losses = [], []
        for bx, by in loop.prefetch(iter(host), depth=2):
            rows.append((tuple(bx.shape), tuple(by.shape)))
            losses.append(loop.step(bx, by).numpy().copy())
        loop.synchronize()
    same = all(torch.equal(p, q) for p, q in
               zip(net_a.parameters(), net_b.parameters()))
    out.update(prefetch=losses, rows=rows, same=same,
               zero=loop.compiled_step.zero_sharded,
               stats=loop.engine_stats())
    return out


def test_each_rank_stages_its_own_rows_and_the_step_passes_them_through():
    """Two gloo ranks, batches of 8 rows: each stages 4 (its half), the
    ZeRO step reads them as its part of the global batch of 8 (the
    losses it returns are the global batch's 8, bit for bit those of
    plain steps on the global host batches), and a batch of 5 rows
    (not divisible by 2), which both ranks stage and compute whole."""
    host = _host_batches(3) + _host_batches(1, bs=5, seed=5)
    ranks = tdist.spawn(_rank_prefetch, 2, "cpu", (_mlp_weights(), host),
                        timeout_s=SPAWN_TIMEOUT_S)
    for r in ranks:
        assert r["zero"] and r["same"]
        assert r["rows"] == [((4, 4), (4,))] * 3 + [((5, 4), (5,))]
        for a, b in zip(r["prefetch"], r["plain"]):
            assert a.shape in ((8,), (5,))
            onp.testing.assert_array_equal(a, b)
        assert r["stats"]["prefetch_batches"] == 4
