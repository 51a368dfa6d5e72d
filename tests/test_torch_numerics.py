"""Training numerics of the port (``telemetry/numerics.py``,
``compile_step(numerics=...)``, ``inspector.py``) against the JAX
package's.

The narrow BERT classifier (``bert_small_test``, dropout off) takes the
same numpy-seeded weights and batches in both packages; one Adam step of
each package's ``compile_step(numerics='global'|'per_layer')`` reports the
grad, param and update norms, the non-finite counts and the per-layer
grad norms (by the same parameter names), held within RTOL (1e-5
relative: float32 sums in another order; the port's products on the CPU
accumulate differently from XLA's). The port's losses and weights with
numerics on are bit-equal to numerics off (the statistics only read what
the step computes). Under the ZeRO sharded update at dp 2 (two gloo ranks,
the only process group the new test files spawn) the norms composed from
each rank's shards equal the one-process step's within RTOL. An injected
overflow gives one ``nonfinite_grad`` anomaly, one dump naming the planted
op; the divergence detectors fire once an episode, as the JAX monitor's
do on the same sequence.

JAX is imported inside the tests: the spawned ranks import this module.
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import inspector as tinsp
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.gluon.params import init_params_numpy, load_jax_params
from mxnet_tpu_torch.ops.registry import invoke
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.parallel import make_mesh as tmake_mesh
from mxnet_tpu_torch.telemetry import names as tnames
from mxnet_tpu_torch.telemetry import numerics as tnx

RTOL = 1e-5
BATCH, SEQ = 4, 8


@pytest.fixture(autouse=True)
def _fresh():
    ttel.reset()
    yield
    tinsp.remove_nan_guard()
    ttel.reset()


def _rel(a, b, what=""):
    assert abs(a - b) <= RTOL * max(abs(a), abs(b), 1e-30), (what, a, b)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_mode_parsing_and_env_equal_jax(monkeypatch):
    from mxnet_tpu.telemetry import numerics as jnx
    for v in (None, "off", "global", "per_layer", "per-layer", "on", "1",
              "2", "0", "", True, False, "layers", "none"):
        assert tnx.mode(v) == jnx.mode(v), v
    for v in ("", "0", "1", "global", "per_layer"):
        monkeypatch.setenv("MXNET_NUMERICS", v)
        assert tnx.mode() == jnx.mode(), v
    for v in ("25", "bogus", "0.5"):
        monkeypatch.setenv("MXNET_GRADNORM_SPIKE_FACTOR", v)
        monkeypatch.setenv("MXNET_MASTER_DRIFT_TOL", v)
        assert tnx.spike_factor() == jnx.spike_factor()
        assert tnx.master_drift_tol() == jnx.master_drift_tol()


# ---------------------------------------------------------------------------
# the narrow BERT against the JAX compile_step
# ---------------------------------------------------------------------------

def _bert_pair(seed=0):
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo import bert as jbert
    x = onp.random.RandomState(seed + 1).randint(0, 128, (BATCH, SEQ)) \
        .astype("int32")
    tnet = tbert.BERTClassifier(tbert.bert_small_test(dropout=0.0,
                                                      device="cpu"),
                                num_classes=3, dropout=0.0, device="cpu")
    params = init_params_numpy(tnet, seed)
    load_jax_params(tnet, params)
    jnet = jbert.BERTClassifier(jbert.bert_small_test(dropout=0.0),
                                num_classes=3, dropout=0.0)
    jnet.initialize()
    jnet(mx.nd.array(x, dtype="int32"))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    return jnet, tnet, x, params


def _port_step(params, mode, x, y, steps=2):
    tnet = tbert.BERTClassifier(tbert.bert_small_test(dropout=0.0,
                                                      device="cpu"),
                                num_classes=3, dropout=0.0, device="cpu")
    load_jax_params(tnet, params)
    tr = TTrainer(dict(tnet.named_parameters()), "adam",
                  {"learning_rate": 1e-3})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(tnet(a), b), numerics=mode)
    losses, vals = [], []
    for _ in range(steps):
        losses.append(step(torch.from_numpy(x), torch.from_numpy(y)))
        vals.append(step.numerics_values())
    return tnet, losses, vals, step


def test_bert_numerics_vs_jax_compile_step(monkeypatch):
    """Two Adam steps: the port's per-layer numerics against the JAX
    step's within RTOL; a layer's norm within RTOL of itself or of the
    step's grad norm (the key projection's bias has a true gradient of 0:
    softmax over the keys drops a per-query constant, so both sides
    report rounding noise there). The port's ``global`` mode reports the
    same global statistics as its ``per_layer`` mode, bit for bit."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    monkeypatch.setenv("MXNET_PALLAS", "off")
    jnet, _, x, params = _bert_pair()
    y = onp.array([0, 2, 1, 1], "f4")
    jtr = JTrainer(jnet.collect_params(), "adam", {"learning_rate": 1e-3})
    jlb = jloss.SoftmaxCrossEntropyLoss()
    jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b),
                             numerics="per_layer")
    jvals = []
    for _ in range(2):
        jstep(mx.nd.array(x, dtype="int32"), mx.nd.array(y))
        jvals.append(jstep.take_numerics().host_values())
    _, _, gvals, _ = _port_step(params, "global", x, y)
    tnet, _, tvals, tstep = _port_step(params, "per_layer", x, y)
    assert tstep.mode == "fused" and tstep.n_traces == 1
    keys = ("grad_norm", "param_norm", "update_norm", "update_ratio")
    for jv, tv, gv in zip(jvals, tvals, gvals):
        for k in keys:
            _rel(tv[k], jv[k], k)
            assert gv[k] == tv[k], k
        assert tv["nonfinite"] == jv["nonfinite"] == {"float32": 0}
        assert "layer_grad_norm" not in gv
        assert list(tv["layer_grad_norm"]) == list(jv["layer_grad_norm"])
        for name, v in jv["layer_grad_norm"].items():
            got = tv["layer_grad_norm"][name]
            assert abs(got - v) <= RTOL * max(abs(v), jv["grad_norm"]), \
                (name, got, v)
    last = ttel.numerics.monitor().last()
    assert last["grad_norm"] == tvals[-1]["grad_norm"]
    assert ttel.value(tnames.NUMERICS_GRAD_NORM) == tvals[-1]["grad_norm"]
    top = ttel.registry().get(tnames.NUMERICS_LAYER_GRAD_NORM).values()
    assert len(top) == min(tnx.TOP_K_LAYERS,
                           len(tvals[-1]["layer_grad_norm"]))


def test_bert_numerics_on_off_bit_equal():
    """Losses and every weight after the same two Adam steps are equal
    bit for bit with numerics off, global and per_layer; each mode's
    step captures one program (the mode is part of the signature)."""
    _, _, x, params = _bert_pair()
    y = onp.array([0, 2, 1, 1], "f4")
    runs = [_port_step(params, m, x, y) for m in (None, "global",
                                                  "per_layer")]
    ref_net, ref_losses, ref_vals, _ = runs[0]
    assert ref_vals == [None, None]
    for net, losses, vals, step in runs[1:]:
        for a, b in zip(losses, ref_losses):
            assert torch.equal(a, b)
        for (k, a), (_, b) in zip(net.named_parameters(),
                                  ref_net.named_parameters()):
            assert torch.equal(a, b), k
        assert step.n_traces == 1 and all(v is not None for v in vals)


def test_set_numerics_captures_a_new_signature():
    _, _, x, params = _bert_pair()
    y = onp.array([0, 2, 1, 1], "f4")
    _, _, _, step = _port_step(params, None, x, y, steps=1)
    step.set_numerics("global")
    step(torch.from_numpy(x), torch.from_numpy(y))
    assert step.numerics == "global" and step.n_traces == 2
    assert "numerics changed (None -> global)" in step.explain_retrace()
    assert step.take_numerics() is not None
    assert step.take_numerics() is None


# ---------------------------------------------------------------------------
# ZeRO at dp 2: the composed norms
# ---------------------------------------------------------------------------

def _mlp_weights():
    r = onp.random.RandomState(4)
    return [r.randn(16, 6).astype("f4") * 0.3, r.randn(16).astype("f4"),
            r.randn(3, 16).astype("f4") * 0.3, r.randn(3).astype("f4")]


def _mlp(weights):
    net = torch.nn.Sequential(Dense(16, in_units=6, activation="relu",
                                    device="cpu"),
                              Dense(3, in_units=16, device="cpu"))
    with torch.no_grad():
        for p, w in zip(net.parameters(), weights):
            p.copy_(torch.from_numpy(w))
    return net


def _mlp_batch():
    r = onp.random.RandomState(5)
    return torch.from_numpy(r.randn(8, 6).astype("f4")), \
        torch.from_numpy(r.randint(0, 3, (8,)).astype("f4"))


def _mlp_numerics(zero: bool):
    """Two Adam steps of the MLP with per-layer numerics; under a dp
    mesh (the ZeRO mode) when ``zero``; the host values of each."""
    torch.set_num_threads(1)
    net = _mlp(_mlp_weights())
    tr = TTrainer(dict(net.named_parameters()), "adam",
                  {"learning_rate": 0.01})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b),
                           numerics="per_layer")
    x, y = _mlp_batch()
    out = []
    for _ in range(2):
        if zero:
            with tmake_mesh({"dp": tdist.size()}):
                step(x, y)
        else:
            step(x, y)
        out.append(step.numerics_values())
    return {"mode": step.mode, "vals": out,
            "units": None if step.zero_plan is None
            else [u["members"] for u in step.zero_plan.units]}


def _zero_worker():
    return _mlp_numerics(True)


def test_zero_dp2_composed_norms_equal_one_process(monkeypatch):
    monkeypatch.setenv("MXNET_ZERO_SHARD_MIN_SIZE", "32")
    ref = _mlp_numerics(False)
    ranks = tdist.spawn(_zero_worker, 2, "cpu", (), timeout_s=90)
    assert ref["mode"] == "fused"
    for r in ranks:
        assert r["mode"] == "zero"
        # the weights are units of their own, the biases one bucket
        assert sorted(len(m) for m in r["units"]) == [1, 1, 2]
        for zv, fv in zip(r["vals"], ref["vals"]):
            for k in ("grad_norm", "param_norm", "update_norm"):
                _rel(zv[k], fv[k], k)
            assert zv["nonfinite"] == fv["nonfinite"]
            assert list(zv["layer_grad_norm"]) == \
                list(fv["layer_grad_norm"])
            for name, v in fv["layer_grad_norm"].items():
                _rel(zv["layer_grad_norm"][name], v, name)
    assert ranks[0]["vals"] == ranks[1]["vals"]


# ---------------------------------------------------------------------------
# non-finite episodes, forensics, the detectors
# ---------------------------------------------------------------------------

def test_injected_overflow_one_anomaly_and_dump(tmp_path, monkeypatch):
    """The JAX test of the same shape: an overflow batch at a known step,
    retired through a live dispatch window, gives exactly ONE
    nonfinite_grad anomaly at that step and one atomic schema-v1 dump
    whose forensics name the planted op (``exp``, sent through the op
    funnel), with the per-layer table and the step's context."""
    dump = tmp_path / "dumps"
    monkeypatch.setenv("MXNET_NUMERICS_DUMP_DIR", str(dump))
    net = _mlp(_mlp_weights())
    tr = TTrainer(dict(net.named_parameters()), "sgd",
                  {"learning_rate": 0.1, "momentum": 0.9})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(
        lambda a, b: lb(net(invoke("exp", torch.exp, a)), b),
        numerics="global")
    x, y = _mlp_batch()
    xinf = torch.full((8, 6), 120.0)
    w = tengine.DispatchWindow(lambda p: p.cpu(), max_inflight=2)
    for i in range(1, 9):
        loss = step(xinf if i == 5 else x, y)
        w.push(loss, tag=i, aux=step.take_numerics())
    w.drain()
    ev = ttel.watchdog().anomalies("nonfinite_grad")
    assert [e["step"] for e in ev] == [5]
    assert "exp" in ev[0]["message"]
    assert ttel.value(tnames.NUMERICS_DUMPS) == 1
    files = sorted(dump.glob("mx_numerics_*.json"))
    assert len(files) == 1 and not list(dump.glob("*.tmp*"))
    d = json.load(open(files[0]))
    assert d["schema_version"] == tnx.DUMP_SCHEMA_VERSION == 1
    from mxnet_tpu.telemetry import numerics as jnx
    assert jnx.DUMP_SCHEMA_VERSION == 1
    for key in ("time_unix", "kind", "step", "offending_op", "grad_norm",
                "param_norm", "update_ratio", "nonfinite", "layers",
                "context", "hints"):
        assert key in d, key
    assert d["kind"] == "nonfinite_grad" and d["step"] == 5
    assert "exp" in d["offending_op"]
    assert d["nonfinite"]["float32"] > 0
    assert d["layers"][0]["nonfinite"] > 0
    assert {"param", "shape", "dtype", "grad_norm", "param_norm",
            "nonfinite"} <= set(d["layers"][0])
    assert d["context"]["learning_rate"] == pytest.approx(0.1)
    assert d["context"]["optimizer"] == "SGD"
    assert d["context"]["batch_size"] == 8
    assert d["hints"]


def _synthetic(gn, psq, usq, nf=0, layers=None):
    raw = {"grad_sq": gn ** 2, "param_sq": psq, "upd_sq": usq,
           "nonfinite": {"float32": nf}}
    if layers is not None:
        raw["layer_grad_sq"] = onp.square(onp.asarray(layers, "f8"))
    return raw


def test_divergence_detectors_fire_once_per_episode_like_jax(monkeypatch):
    """One sequence of step statistics through both monitors: the same
    grad_spike / update_ratio / nonfinite_grad events at the same steps
    (one an episode), and the same gauges."""
    from mxnet_tpu import telemetry as jtel
    monkeypatch.setenv("MXNET_GRADNORM_SPIKE_FACTOR", "5")
    jtel.reset()
    seq = ([(1.0, 100.0, 1e-4)] * 7 + [(30.0, 100.0, 1e-4)] * 2
           + [(1.0, 100.0, 1e-4)] * 3 + [(1.0, 100.0, 4.0)]
           + [(1.0, 100.0, 1e-4)] * 2)
    names = ["a.weight", "b.weight"]
    for i, (gn, psq, usq) in enumerate(seq):
        nf = 3 if i == 10 else 0
        for nx, mk in ((tnx, ttel), (jtel.numerics, jtel)):
            rec = nx.StepNumerics("per_layer", _synthetic(
                gn, psq, usq, nf, [gn, gn / 2]), names, {})
            nx.monitor().observe_retire(i, rec)

    def evs(wd):
        return [(e["kind"], e["step"], e["value"]) for e in
                wd.anomalies()]

    assert evs(ttel.watchdog()) == evs(jtel.watchdog())
    assert [k for k, _, _ in evs(ttel.watchdog())] == \
        ["grad_spike", "nonfinite_grad", "update_ratio"]
    for n in (tnames.NUMERICS_GRAD_NORM, tnames.NUMERICS_GRAD_NORM_EWMA,
              tnames.NUMERICS_PARAM_NORM):
        assert ttel.value(n) == jtel.value(n), n
    assert ttel.registry().get(tnames.NUMERICS_LAYER_GRAD_NORM).values() \
        == jtel.registry().get(tnames.NUMERICS_LAYER_GRAD_NORM).values()
    jtel.reset()


# ---------------------------------------------------------------------------
# the inspector and its NaN guard
# ---------------------------------------------------------------------------

def test_nan_guard_names_the_op_and_feeds_one_episode():
    tinsp.install_nan_guard()
    tinsp.install_nan_guard()                 # idempotent
    from mxnet_tpu_torch.ops import registry as reg
    assert reg._INVOKE_WRAPPERS.count(tinsp._nan_guard_wrapper) == 1
    ok = torch.ones(3)
    assert torch.equal(invoke("relu", torch.relu, ok), ok)
    for _ in range(3):
        with pytest.raises(mxt.MXNetError, match="'log'.*output 0"):
            invoke("log", torch.log, -ok)
    invoke("relu", torch.relu, ok)            # a clean op re-arms
    with pytest.raises(mxt.MXNetError):
        invoke("log", torch.log, -ok)
    assert ttel.value(tnames.ANOMALIES, "nonfinite_eager") == 2
    tinsp.remove_nan_guard()
    tinsp.remove_nan_guard()
    assert torch.isnan(invoke("log", torch.log, -ok)).all()


def test_tensor_inspector_checks_and_atomic_dump(tmp_path):
    from mxnet_tpu.inspector import TensorInspector as JTI
    a = onp.array([[1.0, -2.0], [onp.inf, 0.0]], "f4")
    t = tinsp.TensorInspector(torch.from_numpy(a), tag="w")
    j = JTI(a, tag="w")
    for c in ("negative", "positive", "zero", "inf", "finite", "abnormal",
              "pos_inf", "nan"):
        assert t.check_value(c) == j.check_value(c), c
    assert t.checksum() == j.checksum()
    p1 = t.dump_to_file("w", str(tmp_path))
    p2 = t.dump_to_file("w", str(tmp_path))
    assert p1.endswith("w_1.npy") and p2.endswith("w_2.npy")
    onp.testing.assert_array_equal(onp.load(p2), a)
    assert not [f for f in tmp_path.iterdir() if ".tmp" in f.name]
    bf = tinsp.TensorInspector(torch.ones(2, dtype=torch.bfloat16))
    assert "dtype=bfloat16" in bf.to_string()
