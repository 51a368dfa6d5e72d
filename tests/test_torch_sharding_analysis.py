"""The sharding analysis of mxnet_tpu_torch (``analysis/sharding.py``, the
collective census of ``analysis/program.py``) against the JAX package's.

The ZeRO MLP of ``tests/test_torch_zero.py`` (every parameter its own
unit, one bucket: ``MXNET_ZERO_BUCKET_BYTES=0``) runs on four gloo ranks
(one module-scoped spawn) and, in this process, as the JAX ZeRO step on
a 4-device CPU mesh:

- the collective census: the same counts of gradient reductions (the
  port's reduce-scatter; the JAX census's reduce-scatter, or on an
  XLA:CPU that keeps it whole the all-reduce of the unpadded gradient)
  and of weight all-gathers, and the same payload elements, exactly:
  the JAX reduction's the plan's unpadded (all-reduce) or padded / N
  (reduce-scatter) elements, the weight gathers' the padded units'. The
  port's step also gathers the global batch's loss (the JAX step returns
  the loss sharded): one all-gather of the batch's size;
- the sharding table: the same spec for each parameter (replicated) and
  each Adam state (split over ``dp``, the padded unit's global shape),
  and the same sharded bytes;
- ``comm_cost`` of one ``CollectiveStats`` under one explicit
  ``BandwidthProfile`` equal to rtol 1e-12, the wire model equal, and
  the spec packs' findings over one census equal.
"""
import os

import pytest
import torch

from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.analysis import program as tprog
from mxnet_tpu_torch.analysis import report as trep
from mxnet_tpu_torch.analysis import sharding as tshard
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.parallel import make_mesh as tmake_mesh

DP = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINES = os.path.join(ROOT, "tests", "fixtures",
                         "torch_sharding_baselines.json")


def _worker(weights):
    """One rank: the serial ZeRO MLP step, then its analysis."""
    torch.set_num_threads(1)
    os.environ["MXNET_ZERO_SHARD_MIN_SIZE"] = "1"
    os.environ["MXNET_ZERO_BUCKET_BYTES"] = "0"
    from test_torch_zero import _mlp_batch, _torch_mlp
    net = _torch_mlp(weights)
    tr = TTrainer(dict(net.named_parameters()), "adam",
                  {"learning_rate": 1e-2})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    x, y = _mlp_batch(8)
    with tmake_mesh({"dp": tdist.size()}):
        step(x, y)
        rep = step.analyze(x, y)
    plan = step.zero_plan
    table = rep.sharding.table
    return {
        "mode": rep.mode,
        "ops": [(o.kind, o.elements, o.dtype, o.axes, o.group_size)
                for o in rep.collectives.ops],
        "totals": [u["total"] for u in plan.units],
        "padded": [u["padded"] for u in plan.units],
        "table": [(r.name, r.describe, tuple(r.global_shape),
                   tuple(r.local_shape)) for r in table.params],
        "sharded_bytes": table.sharded_bytes("dp"),
        "digest": table.digest(), "pack": rep.sharding.pack,
        "reshards": len(rep.sharding.reshards), "ok": rep.ok,
        "errors": [str(f) for f in rep.all_findings("error")],
        "brief": rep.sharding.brief(),
        "comm_s": rep.sharding.cost.total_s,
        "gauge": ttel.value(ttel.names.SHARDING_COMM_COST, "dp")}


@pytest.fixture(scope="module")
def ranks():
    from test_torch_zero import _mlp_weights
    return tdist.spawn(_worker, DP, "cpu", (_mlp_weights(),), timeout_s=90)


@pytest.fixture(scope="module")
def jax_zero():
    """The JAX ZeRO step's optimized program (same MLP, same batch)."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    from mxnet_tpu.parallel import shard_batch
    from test_torch_zero import _jax_mlp, _mlp_batch, _mlp_weights
    env = {"MXNET_ZERO_SHARD_MIN_SIZE": "1", "MXNET_ZERO_BUCKET_BYTES": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
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
            hlo = info["lowered"].compile().as_text()
            stablehlo = info["lowered"].as_text()
            from mxnet_tpu.analysis import program as jprog
            from mxnet_tpu.analysis import sharding as jshard
            census = jprog.collective_census(hlo, mesh=info["mesh"])
            table = jshard.sharding_table(hlo, mesh=info["mesh"],
                                          stablehlo=stablehlo)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return census, table, info


def test_every_rank_is_zero_and_clean(ranks):
    assert all(r["mode"] == "zero" and r["ok"] and not r["errors"]
               for r in ranks)
    assert all(r["pack"] == "zero-dp" and r["reshards"] == 0
               for r in ranks)
    assert len({r["digest"] for r in ranks}) == 1
    assert all(r["gauge"] == pytest.approx(r["comm_s"], rel=1e-12)
               for r in ranks)


def test_collective_census_vs_jax_zero_step(ranks, jax_zero):
    census, _, _ = jax_zero
    r = ranks[0]
    ops = r["ops"]
    rs = [o for o in ops if o[0] == "reduce_scatter"]
    ags = [o for o in ops if o[0] == "all_gather"]
    assert len(rs) + len(ags) == len(ops)
    n_pad, n_tot = sum(r["padded"]), sum(r["totals"])
    # the port: one reduce-scatter of the bucket's row, one all-gather of
    # the padded units, one all-gather of the global batch's loss
    assert [o[1] for o in rs] == [n_pad // DP]
    assert sorted(o[1] for o in ags) == [8, n_pad]
    assert all(o[3] == ("dp",) and o[4] == DP for o in ops)
    # the JAX program's gradient reductions and weight gathers
    red = [o for o in census.ops if o.kind in ("reduce_scatter",
                                               "all_reduce")]
    jag = [o for o in census.ops if o.kind == "all_gather"]
    assert len(red) == len(rs) == 1
    (jr,) = red
    if jr.kind == "all_reduce":
        assert jr.elements == n_tot
    elif jr.decomposed:
        assert jr.elements == n_pad
    else:
        assert jr.elements == n_pad // DP
    assert sum(o.elements for o in jag) == n_pad
    assert all(o.group_size == DP and o.axes == ("dp",)
               for o in census.ops)


def test_sharding_table_specs_vs_jax(ranks, jax_zero):
    _, table, info = jax_zero
    n = info["n_params"]
    jrows = table.params
    jparams = sorted((r.describe, tuple(r.global_shape))
                     for r in jrows[:n])
    jstates = sorted((r.describe, tuple(r.global_shape),
                      tuple(r.local_shape)) for r in jrows
                     if r.name.startswith("sts["))
    port = ranks[0]["table"]
    pparams = sorted((d, g) for name, d, g, _ in port
                     if name.startswith("params["))
    pstates = sorted((d, g, loc) for name, d, g, loc in port
                     if name.startswith("states["))
    assert pparams == jparams
    assert pstates == jstates and jstates
    assert tuple(ranks[0]["sharded_bytes"]) == table.sharded_bytes("dp")


def _stats(R, dtype):
    s = R.CollectiveStats()
    s.ops = [R.CollectiveOp("reduce_scatter", "rs", 27, dtype, ("dp",), 4),
             R.CollectiveOp("reduce_scatter", "rs.d", 108, dtype, ("dp",),
                            4, decomposed=True),
             R.CollectiveOp("all_gather", "ag", 108, dtype, ("dp",), 4),
             R.CollectiveOp("all_reduce", "ar", 1001, dtype, ("tp",), 2),
             R.CollectiveOp("all_to_all", "a2a", 64, dtype, (), 8),
             R.CollectiveOp("collective_permute", "cp", 33, dtype, ("pp",),
                            2)]
    return s


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_comm_cost_equal_jax(dtype):
    from mxnet_tpu.analysis import report as jrep
    from mxnet_tpu.analysis import sharding as jshard
    jp = jshard.BandwidthProfile(12.5, {"dp": 100.0, "tp": 37.0}, name="p")
    tp = tshard.BandwidthProfile(12.5, {"dp": 100.0, "tp": 37.0}, name="p")
    ref = jshard.comm_cost(_stats(jrep, dtype), jp)
    got = tshard.comm_cost(_stats(trep, dtype), tp)
    assert got.total_s == pytest.approx(ref.total_s, rel=1e-12)
    assert got.total_bytes == ref.total_bytes
    assert got.per_axis_bytes == ref.per_axis_bytes
    for ax, sec in ref.per_axis_s.items():
        assert got.per_axis_s[ax] == pytest.approx(sec, rel=1e-12)
    for a, b in zip(_stats(jrep, dtype).ops, _stats(trep, dtype).ops):
        assert tshard.collective_wire_bytes(b) == \
            jshard.collective_wire_bytes(a)
        assert tshard.collective_wire_fraction(
            b.kind, b.group_size, b.decomposed) == \
            jshard.collective_wire_fraction(a.kind, a.group_size,
                                            a.decomposed)
    spec = "dp=7.5,tp=3,default=2"
    assert (tshard.BandwidthProfile.parse(spec).axis_gbps,
            tshard.BandwidthProfile.parse(spec).default_gbps) == \
        (jshard.BandwidthProfile.parse(spec).axis_gbps,
         jshard.BandwidthProfile.parse(spec).default_gbps)


def test_default_link_is_the_cards():
    prof = tshard.bandwidth_profile("")
    assert prof.default_gbps == tshard.NVLINK_BANDWIDTH_GBPS == 450.0
    assert tshard.bandwidth_profile("pcie").default_gbps == 64.0


@pytest.mark.parametrize("mode", ["zero", "mesh", "fused"])
def test_spec_pack_findings_equal_jax(mode):
    """The same census through the mode's pack in both packages gives
    the same findings (``fused-mesh`` is the JAX name of ``mesh``)."""
    from mxnet_tpu.analysis import program as jprog
    from mxnet_tpu.analysis import report as jrep
    out = []
    for R, P, m in ((jrep, jprog, "fused-mesh" if mode == "mesh" else mode),
                    (trep, tprog, mode)):
        rep = R.ProgramReport(mode=m)
        rep.collectives = _stats(R, "f32")
        rep.meta["unit_sizes"] = [108, 1001]
        P.expect_mode(rep, mode=m, axis="dp")
        out.append(sorted((f.rule, f.severity) for f in rep.findings))
    assert out[0] == out[1]


def test_baseline_gate(ranks, tmp_path):
    base = tshard.load_baselines(BASELINES)
    audit = tshard.ShardingAudit()
    assert tshard.check_baseline(audit, base, "zero_mlp_dp4_cpu") == []
    assert ranks[0]["brief"]["implicit_reshards"] == \
        base["zero_mlp_dp4_cpu"]["implicit_reshards"]
    audit.reshards = [tshard.Reshard("ag", "all_gather", ("dp",), 4, 4096,
                                     "float32", 16384, 12288, 1e-6)]
    bad = tshard.check_baseline(audit, base, "zero_mlp_dp4_cpu")
    assert {f.rule for f in bad} == {"sharding-regression"}
    assert all(f.severity == "error" for f in bad)
