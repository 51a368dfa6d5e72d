"""The overlap census of mxnet_tpu_torch (``analysis/overlap.py``) against
the JAX package's, and the analytical tuning backend that reads it.

The ZeRO MLP of ``tests/test_torch_zero.py`` (every parameter its own
unit) on four gloo ranks (one module-scoped spawn) and as the JAX ZeRO
step on a 4-device CPU mesh, serial (``MXNET_ZERO_BUCKET_BYTES=0``) and
bucketed (64-byte buckets): the serial step's ``overlap_fraction`` is at
most 0.05 and the bucketed one above 0 in both packages (the port hides
its bucketed reduce-scatters behind the backward, the JAX program its
bucketed all-gathers behind the updates). ``AnalyticalStepBackend``
reads a non-zero ``exposed_comm_s`` for the serial step and scores it
worse than the bucketed one. The report class, its gate and its gauges
are the JAX package's (equal ``brief()`` / ``to_dict()`` and findings for
the same numbers).
"""
import os

import pytest
import torch

from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.analysis import overlap as tover
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.parallel import make_mesh as tmake_mesh

DP = 4
BUCKETS = {"serial": "0", "bucketed": "64"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINES = os.path.join(ROOT, "tests", "fixtures",
                         "torch_overlap_baselines.json")


def _worker(weights):
    """One rank: the serial and the bucketed ZeRO MLP step, each
    analyzed, and the analytical backend's score of each."""
    torch.set_num_threads(1)
    os.environ["MXNET_ZERO_SHARD_MIN_SIZE"] = "1"
    from test_torch_zero import _mlp_batch, _torch_mlp
    from mxnet_tpu_torch.tuning.measure import AnalyticalStepBackend
    out = {}
    for mode, bb in BUCKETS.items():
        os.environ["MXNET_ZERO_BUCKET_BYTES"] = bb
        net = _torch_mlp(weights)
        tr = TTrainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": 1e-2})
        lb = tloss.SoftmaxCrossEntropyLoss()
        step = tr.compile_step(lambda a, b: lb(net(a), b))
        x, y = _mlp_batch(8)
        with tmake_mesh({"dp": tdist.size()}):
            step(x, y)
            rep = step.analyze(x, y)
            m = AnalyticalStepBackend(step, (x, y)).measure({})
        out[mode] = {"brief": rep.overlap.brief(),
                     "windows": [w.to_dict() for w in rep.overlap.windows],
                     "buckets": len(step.buckets),
                     "score": m.score, "detail": m.detail,
                     "gauge": ttel.value(ttel.names.OVERLAP_FRACTION)}
    return out


@pytest.fixture(scope="module")
def ranks():
    from test_torch_zero import _mlp_weights
    return tdist.spawn(_worker, DP, "cpu", (_mlp_weights(),), timeout_s=90)


def _jax_overlap(bb):
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.analysis import overlap as jover
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    from mxnet_tpu.parallel import shard_batch
    from test_torch_zero import _jax_mlp, _mlp_batch, _mlp_weights
    net = _jax_mlp(_mlp_weights())
    tr = JTrainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
    lb = jloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    x, y = _mlp_batch(8)
    with jmake_mesh({"dp": DP}, jax.devices()[:DP]) as mesh:
        xs = shard_batch(mx.nd.array(x), mesh)
        ys = shard_batch(mx.nd.array(y), mesh)
        step(xs, ys)
        info = step.lower_entry(xs, ys)
        return jover.overlap_census(info["lowered"].compile().as_text(),
                                    mesh=info["mesh"])


@pytest.mark.parametrize("mode", sorted(BUCKETS))
def test_overlap_fraction_serial_and_bucketed_in_both(ranks, mode,
                                                      monkeypatch):
    monkeypatch.setenv("MXNET_ZERO_SHARD_MIN_SIZE", "1")
    monkeypatch.setenv("MXNET_ZERO_BUCKET_BYTES", BUCKETS[mode])
    ref = _jax_overlap(BUCKETS[mode])
    runs = [r[mode] for r in ranks]
    got = runs[0]["brief"]
    assert all(r["brief"] == got for r in runs)     # every rank alike
    assert got["zero_bucket_bytes"] == int(BUCKETS[mode])
    if mode == "serial":
        assert ref.overlap_fraction <= 0.05
        assert got["overlap_fraction"] <= 0.05
        assert got["exposed_comm_s"] > 0 and runs[0]["buckets"] == 1
    else:
        assert ref.overlap_fraction > 0
        assert got["overlap_fraction"] > 0 and runs[0]["buckets"] > 1
        assert got["n_async"] > 1
    assert runs[0]["gauge"] == pytest.approx(got["overlap_fraction"])


def test_overlap_fraction_rises_with_buckets(ranks):
    for r in ranks:
        assert r["bucketed"]["brief"]["overlap_fraction"] > \
            r["serial"]["brief"]["overlap_fraction"]
        # the modeled comm is priced per payload byte: bucketing moves
        # what is exposed, not the total
        assert r["bucketed"]["brief"]["total_comm_s"] == pytest.approx(
            r["serial"]["brief"]["total_comm_s"], rel=1e-9)


def test_analytical_backend_scores_serial_worse(ranks):
    for r in ranks:
        s, b = r["serial"], r["bucketed"]
        assert s["detail"]["exposed_comm_s"] > 0
        assert s["detail"]["exposed_comm_s"] == pytest.approx(
            s["brief"]["exposed_comm_s"], rel=1e-12)
        assert s["detail"]["overlap_fraction"] <= 0.05
        assert s["score"] > b["score"]
        assert s["score"] - b["score"] == pytest.approx(
            s["detail"]["exposed_comm_s"] - b["detail"]["exposed_comm_s"],
            rel=1e-6)


def _fill(O, fraction_base):
    rep = O.OverlapReport()
    rep.windows = [O.CollectiveWindow("rs", "reduce_scatter", "dp", 3e-6,
                                      1e-6, 2e-6, 4, (3, 9), is_async=True),
                   O.CollectiveWindow("ag", "all_gather", "dp", 2e-6, 0.0,
                                      2e-6, 0, (10, 11))]
    rep.total_comm_s, rep.exposed_comm_s, rep.n_async = 5e-6, 4e-6, 1
    rep.per_axis_total_s = {"dp": 5e-6}
    rep.per_axis_exposed_s = {"dp": 4e-6}
    rep.zero_bucket_bytes = 64
    base = {"leg": {"exposed_comm_s": 1e-6, "overlap_fraction":
                    fraction_base, "tol_pct": 10}}
    return rep, base


def test_report_and_gate_equal_jax():
    from mxnet_tpu.analysis import overlap as jover
    (j, jb), (t, tb) = _fill(jover, 0.6), _fill(tover, 0.6)
    assert t.brief() == j.brief()
    jd, td = j.to_dict(), t.to_dict()
    for k in ("scheduled", "profile"):
        jd.pop(k), td.pop(k)
    assert td == jd and t.summary_line() == j.summary_line()
    ref = jover.check_baseline(j, jb, "leg")
    got = tover.check_baseline(t, tb, "leg")
    assert [(f.rule, f.severity) for f in got] == \
        [(f.rule, f.severity) for f in ref]
    assert len(got) == 2
    (miss,) = tover.check_baseline(t, tb, "other")
    assert miss.severity == "warn"
    base = tover.load_baselines(BASELINES)
    assert {"zero_mlp_dp4_serial_cpu", "zero_mlp_dp4_bucketed_cpu"} <= \
        set(base)


def test_checked_in_legs_hold(ranks):
    base = tover.load_baselines(BASELINES)
    for mode in BUCKETS:
        rep = tover.OverlapReport()
        brief = ranks[0][mode]["brief"]
        rep.total_comm_s = brief["total_comm_s"]
        rep.exposed_comm_s = brief["exposed_comm_s"]
        assert tover.check_baseline(rep, base,
                                    f"zero_mlp_dp4_{mode}_cpu") == []
