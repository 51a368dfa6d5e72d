"""The ZeRO step's reduce-scatters launched from the backward, against
the step that waits for it and against the JAX ZeRO step.

Each gradient is written into its bucket's interleaved buffer as it
arrives (``parallel.collectives.write_segment``) and a bucket's
reduce-scatter goes out, asynchronously, once the bucket is whole and
every bucket before it is out. ``MXNET_ZERO_BUCKET_BYTES=0`` gives one
bucket, launched after the backward: the serial baseline.

Four gloo ranks on the CPU run every case in ONE module-scoped spawn:
the MLP of ``test_torch_zero.py`` (every parameter its own unit) in
float32 and in bf16 with Adam's ``multi_precision``, three Adam steps
each, serial, with one unit a bucket (64-byte buckets) and at the
default 4 MiB; a model with a tied weight (one parameter used twice)
and one the forward never uses; and a hook and a collective that fail.

Tolerances: the packing is routing only and gloo's reduce-scatter sums
an element in the same order wherever it lies in the buffer, so every
bucketing trains bit for bit like the serial one. Against the JAX ZeRO
step (kernel 12 in interpret mode), ``test_torch_zero.py``'s own
tolerances: losses atol 1e-5, parameters rtol 1e-4 / atol 1e-5.
"""
import os

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import fused_step as tfs
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.parallel import collectives as tcoll
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.parallel import make_mesh as tmake_mesh

from test_torch_zero import (_jax_zero_mlp, _mlp_batch, _mlp_weights,
                             _torch_mlp)

DP = 4
SPAWN_TIMEOUT_S = 90
STEPS = 3
ADAM = {"learning_rate": 1e-2, "wd": 0.01}
#: bucket bounds: the serial baseline, one unit a bucket, the default
BUCKETS = {"serial": 0, "per_unit": 64, "default": 4 << 20}


# ---------------------------------------------------------------------------
# the packing, without a group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,start,s", [
    (10, 0, 3), (10, 2, 3), (7, 5, 4), (1, 0, 1), (12, 0, 3), (5, 7, 4),
    (33, 1, 9)])
def test_write_segment_places_each_element_at_its_row_and_column(
        total, start, s):
    """Position p of a unit's flat buffer lands at row p // s, column
    off + p % s; everything else of the buffer is untouched, and
    zero_segment zeroes exactly the positions it is given."""
    n, off, width = 4, 2, 2 + s + 3
    flat = torch.arange(1, total + 1, dtype=torch.float32)
    start = min(start, n * s - total)
    buf = torch.full((n, width), -1.0)
    tcoll.write_segment(buf, off, s, start, flat)
    ref = onp.full((n, width), -1.0, "f4")
    for i, v in enumerate(flat.numpy()):
        r, c = divmod(start + i, s)
        ref[r, off + c] = v
    onp.testing.assert_array_equal(buf.numpy(), ref)
    tcoll.zero_segment(buf, off, s, start, start + total)
    for i in range(total):
        r, c = divmod(start + i, s)
        ref[r, off + c] = 0.0
    onp.testing.assert_array_equal(buf.numpy(), ref)


def test_write_segment_casts_into_a_float32_buffer():
    g = torch.randn(9).to(torch.bfloat16)
    buf = torch.zeros(4, 3)
    tcoll.write_segment(buf, 0, 3, 0, g)
    onp.testing.assert_array_equal(buf.reshape(-1)[:9].numpy(),
                                   g.float().numpy())


# ---------------------------------------------------------------------------
# four gloo ranks (the worker at module level: the ranks import this module)
# ---------------------------------------------------------------------------

class _TiedNet(torch.nn.Module):
    """``a`` is applied twice (one parameter, two uses) and ``unused``
    never: its gradient never arrives."""

    def __init__(self, weights):
        super().__init__()
        self.a = Dense(8, in_units=8, device="cpu")
        self.b = Dense(3, in_units=8, device="cpu")
        self.unused = Dense(5, in_units=8, device="cpu")
        load_jax_params(self, weights)

    def forward(self, x):
        return self.b(torch.relu(self.a(torch.relu(self.a(x)))))


def _tied_weights(seed=9):
    r = onp.random.RandomState(seed)
    shapes = {"a.weight": (8, 8), "a.bias": (8,), "b.weight": (3, 8),
              "b.bias": (3,), "unused.weight": (5, 8), "unused.bias": (5,)}
    return {k: (r.randn(*s) * 0.4).astype("f4") for k, s in shapes.items()}


def _tied_batch(bs=8, seed=4):
    r = onp.random.RandomState(seed)
    return r.randn(bs, 8).astype("f4"), r.randint(0, 3, (bs,)).astype("f4")


def _train(make_net, kwargs, x, y, bucket_bytes, steps=STEPS):
    """``steps`` Adam steps of ``make_net()`` through ``compile_step``
    under the dp mesh, with every parameter its own unit and
    ``bucket_bytes`` the bucket bound."""
    os.environ["MXNET_ZERO_BUCKET_BYTES"] = str(bucket_bytes)
    os.environ["MXNET_ZERO_SHARD_MIN_SIZE"] = "1"
    net = make_net()
    named = dict(net.named_parameters())
    tr = TTrainer(named, "adam", dict(kwargs))
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    losses, traces = [], []
    with tmake_mesh({"dp": tdist.size()}):
        for _ in range(steps):
            losses.append(step(x, y).float().numpy().copy())
            traces.append(step.zero_trace)
    plan = step.zero_plan
    return {"losses": losses, "traces": traces, "mode": step.mode,
            "params": {k: p.detach().float().numpy().copy()
                       for k, p in named.items()},
            "names": sorted(named),
            "buckets": step.buckets,
            "schedule": tfs.zero_bucket_schedule(plan.units, bucket_bytes),
            "members": [u["members"] for u in plan.units]}


class _FailingWork:
    def wait(self):
        raise RuntimeError("injected: the reduce-scatter failed")


def _failures(weights, x, y):
    """A hook that raises and a collective whose wait raises: each step
    must raise (no fallback to another path)."""
    out = {}
    real_on_grad = tfs._BucketReducer.on_grad
    real_rs = tfs.reduce_scatter_rows

    def bad_hook(self, j, p):
        if sum(1 for e, _ in self.trace if e == "grad") == 2:
            raise RuntimeError("injected: a gradient hook failed")
        return real_on_grad(self, j, p)

    def bad_collective(buf, mesh, mean=False, async_op=False, out=None):
        return out, _FailingWork()

    for name, attr, fake in (("hook", "_BucketReducer", bad_hook),
                             ("collective", "reduce_scatter_rows",
                              bad_collective)):
        if attr == "_BucketReducer":
            tfs._BucketReducer.on_grad = fake
        else:
            tfs.reduce_scatter_rows = fake
        try:
            _train(lambda: _torch_mlp(weights), ADAM, x, y, 64, steps=1)
            out[name] = None
        except Exception as e:       # the test reads what was raised
            out[name] = f"{type(e).__name__}: {e}"
        finally:
            tfs._BucketReducer.on_grad = real_on_grad
            tfs.reduce_scatter_rows = real_rs
    return out


def _worker(weights, tied):
    torch.set_num_threads(1)
    x, y = _mlp_batch(8)
    out = {}
    for mode, bb in BUCKETS.items():
        out[mode] = _train(lambda: _torch_mlp(weights), ADAM, x, y, bb)
    mp = dict(ADAM, multi_precision=True)
    for mode in ("serial", "per_unit"):
        out["mp_" + mode] = _train(
            lambda: _torch_mlp(weights).to(torch.bfloat16), mp, x, y,
            BUCKETS[mode])
    tx, ty = _tied_batch()
    for mode in ("serial", "per_unit"):
        out["tied_" + mode] = _train(lambda: _TiedNet(tied), ADAM, tx, ty,
                                     BUCKETS[mode])
    out["failures"] = _failures(weights, x, y)
    return out


@pytest.fixture(scope="module")
def ranks():
    return tdist.spawn(_worker, DP, "cpu", (_mlp_weights(), _tied_weights()),
                       timeout_s=SPAWN_TIMEOUT_S)


def _assert_same_run(a, b):
    for la, lb in zip(a["losses"], b["losses"]):
        onp.testing.assert_array_equal(la, lb)
    for k in a["params"]:
        onp.testing.assert_array_equal(a["params"][k], b["params"][k],
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["per_unit", "default"])
def test_overlapped_trains_bit_equal_to_serial_float32(ranks, mode):
    for r in ranks:
        assert r[mode]["mode"] == "zero"
        _assert_same_run(r[mode], r["serial"])
        _assert_same_run(r[mode], ranks[0][mode])


def test_overlapped_trains_bit_equal_to_serial_multi_precision(ranks):
    for r in ranks:
        _assert_same_run(r["mp_per_unit"], r["mp_serial"])
        _assert_same_run(r["mp_per_unit"], ranks[0]["mp_per_unit"])
    assert len(ranks[0]["mp_per_unit"]["buckets"]) == 6


def test_overlapped_vs_jax_zero_step(ranks, monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "on")
    monkeypatch.setenv("MXNET_ZERO_SHARD_MIN_SIZE", "1")
    jl, jp = _jax_zero_mlp(_mlp_weights(), "adam", ADAM, STEPS, None, 8)
    for r in ranks:
        got = r["per_unit"]
        for a, b in zip(got["losses"], jl):
            onp.testing.assert_allclose(a, b, atol=1e-5)
        for k, ref in jp.items():
            onp.testing.assert_allclose(got["params"][k], ref, rtol=1e-4,
                                        atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["serial", "per_unit", "default",
                                  "mp_per_unit", "tied_per_unit"])
def test_every_rank_launches_in_schedule_order(ranks, mode):
    """On every rank and step the reduce-scatters go out bucket 0, 1,
    2, ... of ``zero_bucket_schedule``, whatever order the gradients
    arrived in, all before the first all-gather; then one all-gather a
    run of buckets of one dtype (one here: each model is of one
    dtype)."""
    for r in ranks:
        run = r[mode]
        assert run["buckets"] == run["schedule"]
        nb = len(run["buckets"])
        for trace in run["traces"]:
            assert [b for e, b in trace if e == "reduce_scatter"] == \
                list(range(nb))
            assert [b for e, b in trace if e == "all_gather"] == [0]
            assert trace.index(("all_gather", 0)) > max(
                i for i, (e, _) in enumerate(trace) if e == "reduce_scatter")
    assert len(ranks[0]["serial"]["buckets"]) == 1
    assert len(ranks[0]["per_unit"]["buckets"]) == 6


def _assert_launched_when_ready(trace, run):
    """After each gradient's arrival, exactly the longest prefix of the
    schedule whose buckets are whole has gone out: a bucket leaves as
    soon as it and every bucket before it are complete."""
    members = [sum((run["members"][k] for k in b), ()) for b in
               run["buckets"]]
    arrived, launched = set(), 0
    events = iter(trace)
    for e, x in events:
        if e != "grad":
            continue
        arrived.add(x)
        ready = 0
        while ready < len(members) and set(members[ready]) <= arrived:
            ready += 1
        while launched < ready:
            assert next(events) == ("reduce_scatter", launched)
            launched += 1


def test_first_bucket_goes_out_before_the_last_gradient_arrives(ranks):
    """With one unit a bucket, bucket 0 (the last layer's, the first the
    backward finishes) is launched before the last gradient hook fires;
    the serial bucket only after it."""
    for r in ranks:
        for trace in r["per_unit"]["traces"]:
            last_grad = max(i for i, (e, _) in enumerate(trace)
                            if e == "grad")
            assert trace.index(("reduce_scatter", 0)) < last_grad
            _assert_launched_when_ready(trace, r["per_unit"])
        for trace in r["serial"]["traces"]:
            last_grad = max(i for i, (e, _) in enumerate(trace)
                            if e == "grad")
            assert trace.index(("reduce_scatter", 0)) > last_grad


def test_tied_and_unused_parameters(ranks):
    """The tied weight's hook fires once a step (the two uses summed);
    the unused parameter's never does, yet its bucket goes out, in
    order, with zeros (or every rank would hang): every rank trains bit
    for bit as with the serial bucket, and the used parameters match
    one process's eager training of them."""
    weights = _tied_weights()
    x, y = _tied_batch()
    net = _TiedNet(weights)
    used = {k: p for k, p in net.named_parameters()
            if not k.startswith("unused")}
    tr = TTrainer(used, "adam", dict(ADAM))
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    eager = [step(x, y).numpy() for _ in range(STEPS)]
    for r in ranks:
        run = r["tied_per_unit"]
        _assert_same_run(run, r["tied_serial"])
        names = run["names"]
        tied_j, unused_j = names.index("a.weight"), names.index(
            "unused.weight")
        for trace in run["traces"]:
            grads = [j for e, j in trace if e == "grad"]
            assert grads.count(tied_j) == 1
            assert unused_j not in grads
            assert len(grads) == len(names) - 2     # unused weight, bias
        for a, b in zip(run["losses"], eager):
            onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        for k, p in used.items():
            onp.testing.assert_allclose(run["params"][k],
                                        p.detach().numpy(), rtol=1e-5,
                                        atol=1e-6, err_msg=k)
        # the unused parameters: a zero gradient (only the weight decay,
        # folded into it, moves them), the same on every rank
        for k in ("unused.weight", "unused.bias"):
            assert onp.all(onp.isfinite(run["params"][k]))
            onp.testing.assert_array_equal(run["params"][k],
                                           ranks[0]["tied_per_unit"]
                                           ["params"][k])


def test_a_failing_hook_or_collective_raises(ranks):
    for r in ranks:
        f = r["failures"]
        assert f["hook"] is not None and "a gradient hook failed" in \
            f["hook"]
        assert f["collective"] is not None and \
            "the reduce-scatter failed" in f["collective"]
