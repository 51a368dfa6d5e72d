"""The program lint of mxnet_tpu_torch (``analysis/report.py``,
``schedule.py``, ``program.py``, ``guard.py``) against the JAX package's,
and its wiring into ``compile_step(analyze=)``, the predictor and the
decode engine.

- The report classes are the JAX package's: the same fields give the
  same ``to_dict()`` and ``summary()``, exactly.
- Each known-bad program of ``tests/test_analysis.py`` has a port
  counterpart over a schedule record that fires the same rule id: a host
  read in the loss (``host-transfer``), an update that binds a fresh
  buffer (``donation-copy``), a float64 upcast (``dtype-drift``, error),
  bf16 widening and its blessing (``dtype-drift``, warn / blessed), and
  an all-reduce where the ZeRO pack expects a reduce-scatter
  (``collective-mismatch`` + ``per-param-allreduce``, the JAX
  ``expect_mode`` on the same census giving the same findings).
- ``compile_step(analyze='report'|'warn'|'raise')`` and
  ``MXNET_ANALYSIS``; ``analyze()`` leaves the weights, Adam states,
  update counts and generators bit-equal and ``n_traces`` unmoved.
- The transfer guard in ``raise``, ``log`` and ``allow_transfers``.

Inputs are numpy-seeded; every comparison is exact.
"""
import logging

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.analysis import guard as tguard
from mxnet_tpu_torch.analysis import program as tprog
from mxnet_tpu_torch.analysis import report as trep
from mxnet_tpu_torch.analysis import schedule as tsched
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.gluon.params import load_jax_params


# ---------------------------------------------------------------------------
# the report classes
# ---------------------------------------------------------------------------

def _filled(R):
    rep = R.ProgramReport(mode="zero")
    rep.collectives.ops = [
        R.CollectiveOp("reduce_scatter", "rs.1", 27, "f32", ("dp",), 4),
        R.CollectiveOp("all_gather", "ag.1", 108, "f32", ("dp",), 4),
        R.CollectiveOp("all_gather", "ag.2", 8, "f32", (), 4)]
    rep.donation = R.DonationAudit(declared=18, aliased=17, copied=[3],
                                   donated_bytes=628, expected=18)
    rep.host_transfers = [R.Finding("program", "host-transfer", "h",
                                    "a.py:1")]
    rep.dtype_drift = [R.Finding("program", "dtype-drift", "w", "b:2",
                                 severity="warn", blessed=True),
                       R.Finding("program", "dtype-drift", "f64", "c:3")]
    rep.add(R.Finding("sharding", "collective-mismatch", "m", "rs@dp"))
    rep.n_traces = 2
    rep.meta["axis"] = "dp"
    return rep


def test_report_to_dict_and_summary_equal_jax():
    from mxnet_tpu.analysis import report as jrep
    j, t = _filled(jrep), _filled(trep)
    assert t.to_dict() == j.to_dict()
    assert t.summary() == j.summary()
    assert t.ok == j.ok is False
    assert [str(f) for f in t.all_findings(include_blessed=True)] == \
        [str(f) for f in j.all_findings(include_blessed=True)]
    assert t.collectives.to_dict() == j.collectives.to_dict()
    assert t.collectives.matching("all_gather", [108, 8]) != []
    assert t.donation.ok == j.donation.ok is False
    with pytest.raises(mxt.MXNetError, match="3 violation"):
        t.raise_if_findings()


# ---------------------------------------------------------------------------
# the schedule record
# ---------------------------------------------------------------------------

def test_record_keeps_ops_views_allocs_and_in_place_writes():
    w = torch.zeros(4, 3)
    x = torch.from_numpy(onp.random.RandomState(0).randn(2, 4)
                         .astype("f4"))

    def body():
        y = x @ w
        y2 = y.t()
        buf = torch.empty(3, 2)
        buf.copy_(y2)
        w.add_(1.0)
        return buf

    rec, out = tsched.record(body, watch={"params": [w]})
    kinds = [(n.kind, n.name) for n in rec.nodes]
    assert ("op", "mm") in kinds and ("view", "t") in kinds
    assert ("alloc", "empty") in kinds and ("op", "add_") in kinds
    (mm,) = [n for n in rec.nodes if n.name == "mm"]
    assert mm.flops == 2 * 2 * 4 * 3
    assert rec.meta["watch"]["params"][0] in rec.written_sids
    (cp,) = [n for n in rec.nodes if n.name == "copy_"]
    # the copy reads mm's output through the view: one storage id
    assert cp.inputs[1].sid == mm.outputs[0].sid
    assert tsched.active() is None
    assert out.shape == (3, 2)


def test_plain_versions_fold_into_one_kernel_node():
    from mxnet_tpu_torch.ops.kernels import norm as KN
    rs = onp.random.RandomState(1)
    x = torch.from_numpy(rs.randn(6, 8).astype("f4"))
    g = torch.ones(8)
    b = torch.zeros(8)
    rec, _ = tsched.record(lambda: KN.layer_norm(x, g, b))
    (k,) = rec.of_kind("kernel")
    assert k.name == "layernorm_fwd" and k.meta["folded_ops"] > 3
    assert [o.shape for o in k.inputs[:3]] == [(6, 8), (8,), (8,)]
    assert rec.of_kind("op") == []


# ---------------------------------------------------------------------------
# the known-bad programs (tests/test_analysis.py:91-199)
# ---------------------------------------------------------------------------

def test_known_bad_host_read_in_the_loss():
    x = torch.ones(4)
    rec, _ = tsched.record(lambda: (x * 2).sum().item())
    (f,) = tprog.host_transfer_scan(rec)
    assert f.rule == "host-transfer" and "_local_scalar_dense" in \
        f.message
    clean, _ = tsched.record(lambda: (x * 2).sum())
    assert tprog.host_transfer_scan(clean) == []


def test_known_bad_broken_donation():
    """One of two watched tensors updated by a fresh buffer bound in
    its place: donation-copy, as the JAX audit reports a dropped
    donation."""
    a, b = torch.ones(8, 8), torch.ones(8, 8)
    box = {"b": b}

    def body():
        a.add_(1.0)                  # in place
        box["b"] = box["b"] * 2.0    # a fresh buffer in its place

    rec, _ = tsched.record(body, watch={"params": [a, b]})
    report = tprog.analyze_schedule(rec, expected_donated=2)
    assert not report.donation.ok and report.donation.aliased == 1
    assert report.donation.copied == [1]
    assert "donation-copy" in [f.rule for f in report.findings]
    rec2, _ = tsched.record(lambda: (a.add_(1), b.mul_(2)),
                            watch={"params": [a, b]})
    rep2 = tprog.analyze_schedule(rec2, expected_donated=2)
    assert rep2.donation.ok and rep2.donation.aliased == 2
    assert rep2.donation.donated_bytes == 2 * 8 * 8 * 4


def test_known_bad_accidental_f64_upcast():
    x = torch.ones(4)
    rec, _ = tsched.record(lambda: x.double().sum())
    fs = tprog.dtype_drift_scan(rec)
    assert any(f.rule == "dtype-drift" and f.severity == "error"
               and "float64" in f.message for f in fs)
    # never blessed, not even by the master list
    fs = tprog.dtype_drift_scan(rec, blessed=[("float32", "float64")])
    assert not any(f.blessed for f in fs)


def test_known_bad_bf16_widening_and_blessing():
    x = torch.ones(4, dtype=torch.bfloat16)
    rec, _ = tsched.record(lambda: x.float() * 2.0)
    (f,) = tprog.dtype_drift_scan(rec)
    assert f.rule == "dtype-drift" and not f.blessed
    (f,) = tprog.dtype_drift_scan(rec, blessed=[("bfloat16", "float32")])
    assert f.blessed and f.severity == "warn"


def test_known_bad_allreduce_where_reduce_scatter_expected():
    """The zero pack over a census of one unit-sized all-reduce: the
    missing reduce-scatter / all-gather and the per-parameter
    all-reduce, the same findings as the JAX ``expect_mode``."""
    from mxnet_tpu.analysis import program as jprog
    from mxnet_tpu.analysis import report as jrep
    out = []
    for R, P in ((jrep, jprog), (trep, tprog)):
        report = R.ProgramReport(mode="zero")
        report.collectives.ops = [R.CollectiveOp(
            "all_reduce", "all-reduce", 1024, "f32", (), 8)]
        report.meta["unit_sizes"] = [1024]
        P.expect_mode(report, mode="zero", axis=None)
        out.append(sorted((f.rule, f.severity, f.where)
                          for f in report.findings))
        assert not report.ok
    assert out[0] == out[1]
    assert sorted({r for r, _, _ in out[1]}) == ["collective-mismatch",
                                                 "per-param-allreduce"]


# ---------------------------------------------------------------------------
# compile_step(analyze=) and analyze()
# ---------------------------------------------------------------------------

def _mlp(seed=0):
    rs = onp.random.RandomState(seed)
    w = {"0.weight": rs.randn(16, 8).astype("f4") * 0.3,
         "0.bias": rs.randn(16).astype("f4") * 0.1,
         "1.weight": rs.randn(4, 16).astype("f4") * 0.3,
         "1.bias": rs.randn(4).astype("f4") * 0.1}
    net = torch.nn.Sequential(Dense(16, in_units=8, activation="relu",
                                    device="cpu"),
                              Dense(4, in_units=16, device="cpu"))
    load_jax_params(net, w)
    return net


def _batch(seed=1, bs=8):
    rs = onp.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(bs, 8).astype("f4")),
            torch.from_numpy(rs.randint(0, 4, (bs,)).astype("f4")))


@pytest.mark.parametrize("mode", ["report", "warn", "raise"])
def test_compile_step_analyze_modes(mode, caplog):
    net = _mlp()
    tr = Trainer(dict(net.named_parameters()), "adam",
                 {"learning_rate": 1e-2})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b), analyze=mode)
    assert step.analysis_report is None
    x, y = _batch()
    with caplog.at_level(logging.WARNING):
        step(x, y)
    rep = step.analysis_report
    assert rep.mode == "fused" and rep.ok and rep.n_traces == 1
    assert rep.collectives.ops == [] and rep.host_transfers == []
    assert rep.donation.declared == rep.donation.aliased == 4 + 8
    assert rep.fusion.n_kernels > 0 and rep.overlap.n_collectives == 0
    step(x, y)                      # analyzed once
    assert step.analysis_report is rep


def test_analyze_raise_on_a_host_read_and_warn_logs_it(caplog):
    net = _mlp()
    lb = tloss.SoftmaxCrossEntropyLoss()

    def leaky(a, b):
        loss = lb(net(a), b)
        scale = loss.mean().item()      # a host read in the loss
        return loss * (scale == scale)

    x, y = _batch()
    tr = Trainer(dict(net.named_parameters()), "sgd",
                 {"learning_rate": 0.1})
    step = tr.compile_step(leaky, analyze="raise")
    with pytest.raises(mxt.MXNetError, match="host-transfer"):
        step(x, y)
    tr2 = Trainer(dict(net.named_parameters()), "sgd",
                  {"learning_rate": 0.1})
    step2 = tr2.compile_step(leaky, analyze="warn")
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.gluon"):
        step2(x, y)
    rep = step2.analysis_report
    rules = {f.rule for f in rep.all_findings()}
    assert {"host-transfer", "MXA001"} <= rules
    assert "program analysis" in caplog.text


def test_mxnet_analysis_env_arms_the_lint(monkeypatch):
    monkeypatch.setenv("MXNET_ANALYSIS", "report")
    net = _mlp()
    tr = Trainer(dict(net.named_parameters()), "sgd",
                 {"learning_rate": 0.1, "momentum": 0.9})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    step(*_batch())
    assert step.analysis_report is not None
    assert step.analysis_report.donation.aliased == 4 + 4
    from mxnet_tpu.gluon import fused_step as jfs
    for v in ("1", "report", "warn", "log", "raise", "strict", "off",
              "0", "", "bogus"):
        assert tprog.analysis_mode(v) == jfs._analysis_mode(v), v


def test_analyze_leaves_the_state_bit_equal():
    """``analyze()`` before the first step: the weights, Adam states,
    update counts, the generator and the dropout layer's generator bit
    for bit, ``n_traces`` unmoved; then the steps train as without it."""
    from mxnet_tpu_torch.gluon.nn import Dropout

    def build():
        torch.manual_seed(0)
        net = torch.nn.Sequential(_mlp(), Dropout(0.5))
        tr = Trainer(dict(net.named_parameters()), "adam",
                     {"learning_rate": 1e-2})
        lb = tloss.SoftmaxCrossEntropyLoss()
        return net, tr, tr.compile_step(lambda a, b: lb(net(a), b))

    x, y = _batch()
    net, tr, step = build()
    opt = tr._optimizer
    sts = [tr._updater._state_for(i, p) for i, p in enumerate(tr._params)]
    before = ([p.detach().clone() for p in net.parameters()],
              [s.clone() for st in sts for s in opt.state_tensors(st)],
              (opt.num_update, dict(opt._index_update_count)),
              torch.get_rng_state())
    rep = step.analyze(x, y)
    after = ([p.detach() for p in net.parameters()],
             [s for st in sts for s in opt.state_tensors(st)],
             (opt.num_update, dict(opt._index_update_count)),
             torch.get_rng_state())
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
    assert before[2] == after[2] and torch.equal(before[3], after[3])
    assert step.n_traces == 0 and rep.n_traces == 0
    assert step.analyze(x, y) is rep          # cached per signature
    losses = [step(x, y) for _ in range(3)]
    net2, tr2, step2 = build()
    ref = [step2(x, y) for _ in range(3)]
    for a, b in zip(losses, ref):
        assert torch.equal(a, b)
    for p, q in zip(net.parameters(), net2.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("program", ["fused", "numerics", "split"])
def test_record_runs_the_body_the_step_runs(program):
    """The schedule record runs the body the step's program runs: its
    ops, hand-written kernels (plain versions on the CPU, one node each)
    and collectives, in order, are those of a recorded step (on the CPU
    a program's run is its body), less the copies into the program's
    static inputs and out of its outputs, for the one-graph step, the
    step with the numerics aux and the split program (a dist store that
    cannot sum in-program: gradient body, the store's sum, update
    body)."""
    from mxnet_tpu_torch.kvstore import KVStoreDist
    net = _mlp()
    kv = None
    if program == "split":
        kv = KVStoreDist("dist_sync")
        kv._force_fuse = True
    tr = Trainer(dict(net.named_parameters()), "adam",
                 {"learning_rate": 1e-2}, kvstore=kv)
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b),
                           numerics="global" if program == "numerics"
                           else None)
    x, y = _batch()
    step(x, y)
    assert step._split is (program == "split")
    rec = step.lower_entry(x, y)["schedule"]
    real, _ = tsched.record(step, x, y)

    def shape(r):
        return [(n.kind, n.name) for n in r.nodes
                if n.kind in ("op", "kernel", "collective")
                and n.name not in ("copy_", "clone")]

    assert shape(rec) == shape(real)
    assert ("kernel", "opt_update") in shape(rec)
    rep = step.analyze(x, y)
    assert rep.donation.declared == rep.donation.aliased == 4 + 8


def test_lower_entry_keys_and_eager_mode():
    net = _mlp()
    tr = Trainer(dict(net.named_parameters()), "sgd",
                 {"learning_rate": 0.1})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    info = step.lower_entry(*_batch())
    assert {"kind", "mode", "schedule", "mesh", "axis",
            "expected_donated", "unit_sizes", "n_params",
            "n_state_leaves", "blessed_dtypes", "report"} <= set(info)
    assert isinstance(info["schedule"], tsched.ScheduleRecord)
    assert info["expected_donated"] == 4 and info["mode"] == "fused"
    # bf16 weights under multi_precision run eagerly: no program
    low = _mlp().to(torch.bfloat16)
    eager = Trainer(dict(low.named_parameters()), "sgd",
                    {"learning_rate": 0.1, "multi_precision": True})
    es = eager.compile_step(lambda a, b: lb(low(a), b))
    x, y = _batch()
    rep = es.analyze(x.to(torch.bfloat16), y)
    assert rep.mode == "eager" and rep.findings[0].rule == "not-compiled"


def test_predictor_and_decode_engine_analyze():
    from mxnet_tpu_torch.serving import (CompiledPredictor, DecodeEngine,
                                         TinyDecoder)
    net = _mlp()
    pred = CompiledPredictor(net, bucket_sizes=(8,), device="cpu",
                             analyze="raise")
    x, _ = _batch()
    pred.predict(x)
    rep = pred.analysis_report
    assert rep.mode == "predict" and rep.ok
    assert rep.collectives.ops == [] and rep.host_transfers == []
    assert pred.analyze(x) is rep
    info = pred.lower_entry(x)
    assert info["expected_donated"] is None and \
        info["schedule"].of_kind("op")
    model = TinyDecoder(vocab=50, d_model=16, num_heads=2, seed=0,
                        device="cpu")
    eng = DecodeEngine(model, start=False)
    drep = eng.analyze(batch_size=2)
    assert drep.mode == "predict" and drep.ok
    names = [k.name for k in drep.fusion.kernels]
    assert any(n.endswith("rnn_decode") for n in names)
    assert eng.n_traces == 0
    eng.close()


# ---------------------------------------------------------------------------
# the transfer guard
# ---------------------------------------------------------------------------

def test_guard_raise_log_and_allow_transfers(monkeypatch):
    x = torch.ones(3)
    with tguard.transfer_guard("raise"):
        with pytest.raises(mxt.MXNetError, match="test_torch_analysis.py"):
            x.sum().item()
        with tguard.allow_transfers():
            assert x.sum().item() == 3.0
        y = x * 2                        # no host read: quiet
    tguard.clear_events()
    with tguard.transfer_guard("log"):
        float(x.sum())
    (kind, where), = tguard.events()
    assert kind == "item" and "test_torch_analysis.py" in where
    # outside a hot region nothing is flagged
    assert x.sum().item() == 3.0
    with pytest.raises(ValueError):
        with tguard.transfer_guard("bogus"):
            pass
    from mxnet_tpu.analysis import guard as jguard
    for v in ("raise", "log", "off", "", "weird"):
        monkeypatch.setenv("MXNET_TRANSFER_GUARD", v)
        assert tguard.env_mode() == jguard.env_mode(), v
    del y


def test_guard_in_the_step_names_the_loss_line(monkeypatch):
    monkeypatch.setenv("MXNET_TRANSFER_GUARD", "raise")
    net = _mlp()
    tr = Trainer(dict(net.named_parameters()), "sgd",
                 {"learning_rate": 0.1})
    lb = tloss.SoftmaxCrossEntropyLoss()

    def planted(a, b):
        loss = lb(net(a), b)
        peek = loss.sum().item()
        return loss * (peek == peek)

    line = planted.__code__.co_firstlineno + 2
    with pytest.raises(mxt.MXNetError,
                       match=f"test_torch_analysis.py:{line}"):
        tr.compile_step(planted)(*_batch())
    # a clean loop stays quiet, its retires counted
    from mxnet_tpu_torch.gluon import TrainLoop
    net2 = _mlp()
    tr2 = Trainer(dict(net2.named_parameters()), "sgd",
                  {"learning_rate": 0.1})
    loop = TrainLoop(net2, tr2, lb, inflight=1)
    tguard.reset_sync_counts()
    c0 = ttel.value(ttel.names.HOST_SYNCS, "window_retire") or 0
    for _ in range(3):
        loop.step(*_batch())
    loop.synchronize()
    assert tguard.sync_counts() == {"window_retire": 3}
    assert (ttel.value(ttel.names.HOST_SYNCS, "window_retire") or 0) \
        - c0 == 3
