"""The port's telemetry layer (``mxnet_tpu_torch/telemetry/``) against the
JAX package's (``mxnet_tpu/telemetry/``).

The same event sequences go through both packages' registries, timelines
and watchdogs, and what comes out is held equal: the catalog (names,
kinds, label keys, help text), the values and percentiles of each metric,
``prometheus_text`` byte for byte, the snapshot's schema, the timeline's
summaries, the watchdog's stall / NaN / MFU episodes as event lists. Then
the port's own wiring: a pipelined ``TrainLoop`` run feeds the series the
JAX test of the same name asserts, an injected NaN batch gives exactly one
``nan_loss`` anomaly at its step (in both packages), a slow retire one
``stall``, the batcher's series equal its own counts, the elastic
supervisor escalates stall episodes into a recovery on one device, and a
lint sweep fails any series name of ``mxnet_tpu_torch/`` that is not in
the catalog (the counterpart of ``tests/test_metric_names_lint.py``).
Equal means equal: no tolerance, except where stated.
"""
import os
import re
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import engine as jengine
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import TrainLoop as JTrainLoop
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.telemetry import names as jnames
from mxnet_tpu.telemetry.registry import MetricsRegistry as JRegistry

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import elastic
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import TrainLoop as TTrainLoop
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.telemetry import names as tnames
from mxnet_tpu_torch.telemetry.registry import MetricsRegistry as TRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh():
    """Zero both packages' process-global telemetry around each test."""
    for t in (jtel, ttel):
        t.stop_heartbeat()
        t.reset()
    yield
    for t in (jtel, ttel):
        t.enable(None)
        t.stop_heartbeat()
        t.reset()


# ---------------------------------------------------------------------------
# the catalog and the registry
# ---------------------------------------------------------------------------

def test_catalog_equals_the_jax_catalog():
    """Every series with its kind, label key and help text, and the
    naming rules, as the JAX package declares them."""
    assert tnames.CATALOG == jnames.CATALOG
    assert tnames.NAME_RE.pattern == jnames.NAME_RE.pattern
    assert (tnames.MAX_LABEL_VALUES, tnames.OVERFLOW_LABEL) == \
        (jnames.MAX_LABEL_VALUES, jnames.OVERFLOW_LABEL) == (24, "other")
    consts = {k: v for k, v in vars(jnames).items()
              if k.isupper() and isinstance(v, str) and v.startswith("mx_")}
    assert consts == {k: v for k, v in vars(tnames).items()
                      if k.isupper() and isinstance(v, str)
                      and v.startswith("mx_")}
    # every catalog series exists from import time in both registries
    for name in jnames.CATALOG:
        assert ttel.registry().get(name).kind == \
            jtel.registry().get(name).kind


def _drive(reg, mod_names):
    """One fixed sequence of events into a fresh registry."""
    c = reg.counter("demo_requests_total", help="requests")
    lab = reg.counter("demo_errors_total", label_key="code")
    g = reg.gauge("demo_depth")
    h = reg.histogram("demo_latency_seconds")
    hl = reg.histogram("demo_phase_seconds", label_key="phase",
                       buckets=(0.001, 0.01, 0.1))
    rs = onp.random.RandomState(7)
    for i in range(200):
        c.inc()
        lab.inc(label=str(i % 30))          # 30 values: overflow past 24
        g.set(float(rs.randint(0, 50)))
        h.observe(float(rs.exponential(0.02)))
        hl.observe(float(rs.exponential(0.02)), label=("a", "b")[i % 2])
    g.add(2.5)
    reg.counter(mod_names.TRAIN_STEPS).inc(12)
    reg.gauge(mod_names.WINDOW_CAPACITY).set(2)
    reg.histogram(mod_names.STEP_PHASE_SECONDS,
                  label_key="phase").observe(0.003, label="dispatch")
    return c, lab, g, h, hl


def test_registry_values_percentiles_and_prometheus_text_byte_for_byte():
    jreg, treg = JRegistry(), TRegistry()
    jm, tm = _drive(jreg, jnames), _drive(treg, tnames)
    for a, b in zip(jm, tm):
        assert a.values().keys() == b.values().keys()
    assert tm[1].values() == jm[1].values()
    assert len(tm[1].values()) == 25 and "other" in tm[1].values()
    for p in (1, 50, 90, 99, 100):
        assert tm[3].percentile(p) == jm[3].percentile(p)
        assert tm[4].percentile(p, "a") == jm[4].percentile(p, "a")
    assert tm[3].snapshot_slot() == jm[3].snapshot_slot()
    from mxnet_tpu.telemetry import exporters as jexp
    from mxnet_tpu_torch.telemetry import exporters as texp
    assert texp.prometheus_text(treg) == jexp.prometheus_text(jreg)
    js, ts = jexp.snapshot(jreg), texp.snapshot(treg)
    for snap in (js, ts):
        snap.pop("time_unix")
    assert ts == js


def test_registry_rules_raise_alike():
    for reg, err in ((JRegistry(), mx.base.MXNetError),
                     (TRegistry(), mxt.MXNetError)):
        with pytest.raises(err):
            reg.counter("mx_not_in_catalog_total")
        with pytest.raises(err):
            reg.counter("bad-name")
        with pytest.raises(err):
            reg.gauge("demo_thing_total")
        c = reg.counter("demo_x_total")
        with pytest.raises(err):
            c.inc(-1)
        with pytest.raises(err):
            reg.counter("demo_y_total", label_key="k").inc()


def test_snapshot_schema_and_write_prometheus_atomic(tmp_path, monkeypatch):
    js, ts = jtel.snapshot(), ttel.snapshot()
    assert set(ts) == set(js) == {"schema_version", "time_unix",
                                  "counters", "gauges", "histograms",
                                  "anomalies"}
    assert ts["schema_version"] == js["schema_version"]
    for k in ("counters", "gauges", "histograms"):
        assert set(ts[k]) == set(js[k]), k
    path = str(tmp_path / "m.prom")
    monkeypatch.setenv("MXNET_PROMETHEUS_FILE", path)
    assert ttel.write_prometheus() == path
    text = open(path).read()
    assert not os.path.exists(path + ".tmp")
    for name in tnames.CATALOG:
        assert f"# TYPE {name} " in text, name


def test_heartbeat_beats_writes_and_stops(tmp_path, monkeypatch):
    path = str(tmp_path / "hb.prom")
    monkeypatch.setenv("MXNET_PROMETHEUS_FILE", path)
    with pytest.raises(mxt.MXNetError):
        ttel.Heartbeat(interval=0)
    hb = ttel.start_heartbeat(interval=0.02)
    deadline = time.monotonic() + 5
    while hb.beats < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    ttel.stop_heartbeat()
    assert hb.beats >= 2 and not hb.running
    assert ttel.value(tnames.HEARTBEATS) == hb.beats
    assert f"{tnames.HEARTBEATS} {hb.beats - 1}" in open(path).read() \
        or f"{tnames.HEARTBEATS} {hb.beats}" in open(path).read()
    n = hb.beats
    hb.beat()                      # a no-op once stopped
    assert hb.beats == n
    assert isinstance(hb._beat_mu, mxt.analysis.threads.MxLock)
    assert hb._beat_mu.name == "telemetry.heartbeat.beat"


# ---------------------------------------------------------------------------
# the timeline and the watchdog
# ---------------------------------------------------------------------------

def test_timeline_summary_and_histogram_equal_jax():
    rs = onp.random.RandomState(3)
    spans = [(ph, float(t0), float(t0 + d), s)
             for s in range(40)
             for ph, t0, d in (("dispatch", s, rs.exponential(0.01)),
                               ("window", s, rs.exponential(0.05)),
                               ("retire", s, rs.exponential(0.002)))]
    for ph, t0, t1, s in spans:
        jtel.timeline().record(ph, t0, t1, step=s)
        ttel.timeline().record(ph, t0, t1, step=s)
    assert ttel.timeline().summary() == jtel.timeline().summary()
    assert ttel.timeline().summary(last_steps=5) == \
        jtel.timeline().summary(last_steps=5)
    jh = jtel.registry().get(jnames.STEP_PHASE_SECONDS)
    th = ttel.registry().get(tnames.STEP_PHASE_SECONDS)
    for ph in ("dispatch", "window", "retire"):
        assert th.snapshot_slot(ph) == jh.snapshot_slot(ph)
    with pytest.raises(mxt.MXNetError):
        ttel.timeline().record("warp", 0.0, 1.0)


def _events(wd):
    return [{k: e[k] for k in ("kind", "step", "message", "value")}
            for e in wd.anomalies()]


def test_watchdog_stall_nan_and_mfu_episodes_equal_jax(monkeypatch):
    """One sequence of retires (step times, losses) through both
    watchdogs: the same stall and nan_loss events (one per episode), the
    same EWMA, FLOP/s and MFU gauges."""
    monkeypatch.setenv("MXNET_WATCHDOG_STALL_FACTOR", "4")
    for wd in (jtel.watchdog(), ttel.watchdog()):
        wd.set_model_flops(2.0e11)
        wd.set_peak_flops(6.7e13)
    dts = [0.01] * 8 + [0.09, 0.2, 0.011] + [0.01] * 4 + [0.07, 0.01]
    nan_at = {5, 6, 7, 12}
    for i, dt in enumerate(dts):
        loss = onp.full((4,), onp.nan if i in nan_at else 0.5, "float32")
        jtel.watchdog().observe_retire(i, payload=loss, dt=dt)
        ttel.watchdog().observe_retire(i, payload=torch.from_numpy(loss),
                                       dt=dt)
    ev = _events(ttel.watchdog())
    assert ev == _events(jtel.watchdog())
    assert [(e["kind"], e["step"]) for e in ev] == \
        [("nan_loss", 5), ("stall", 8), ("nan_loss", 12), ("stall", 15)]
    for n in (tnames.STEP_TIME_EWMA, tnames.MODEL_FLOPS_PER_SEC,
              tnames.MFU, tnames.MODEL_FLOPS_PER_STEP):
        assert ttel.value(n) == jtel.value(n), n
    assert 0 < ttel.value(tnames.MFU) <= 1
    assert ttel.value(tnames.ANOMALIES, "stall") == 2


def test_watchdog_episode_and_subscribe():
    got = []
    cb = ttel.watchdog().subscribe(got.append)
    try:
        for active in (True, True, False, True):
            ttel.watchdog().episode("memory_budget", active, step=1,
                                    message="over")
    finally:
        ttel.watchdog().unsubscribe(cb)
    assert [e["kind"] for e in got] == ["memory_budget", "memory_budget"]


# ---------------------------------------------------------------------------
# the wiring: TrainLoop, DispatchWindow, the kernel funnel
# ---------------------------------------------------------------------------

def _nets(seed=3):
    r = onp.random.RandomState(seed)
    w1, b1 = r.randn(8, 4).astype("f4") * 0.5, r.randn(8).astype("f4") * .1
    w2, b2 = r.randn(3, 8).astype("f4") * 0.5, r.randn(3).astype("f4") * .1
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(8, in_units=4, activation="relu"))
    jnet.add(jnn.Dense(3, in_units=8))
    jnet.initialize()
    for p, v in zip(jnet.collect_params().values(), (w1, b1, w2, b2)):
        p.set_data(mx.nd.array(v))
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(8, in_units=4, activation="relu", device="cpu"))
    tnet.add(tnn.Dense(3, in_units=8, device="cpu"))
    with torch.no_grad():
        for p, v in zip(tnet.parameters(), (w1, b1, w2, b2)):
            p.copy_(torch.from_numpy(v))
    return jnet, tnet


def _loops(**kw):
    jnet, tnet = _nets()
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jl = JTrainLoop(jnet, JTrainer(jnet.collect_params(), "sgd", dict(opt)),
                    jloss.SoftmaxCrossEntropyLoss(), **kw)
    tl = TTrainLoop(tnet, TTrainer(dict(tnet.named_parameters()), "sgd",
                                   dict(opt)),
                    tloss.SoftmaxCrossEntropyLoss(), **kw)
    return jl, tl


def _batch(bs=8, seed=0):
    r = onp.random.RandomState(seed)
    return r.randn(bs, 4).astype("float32"), \
        r.randint(0, 3, size=(bs,)).astype("float32")


def test_pipelined_loop_feeds_the_series(tmp_path, monkeypatch):
    """The JAX test of the same shape (``test_pipelined_telemetry_zero_
    unblessed_syncs``): 12 prefetched steps with two checkpoints; the
    series a pipelined run exports, counted in both packages alike."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_WATCHDOG_STALL_FACTOR", "50")
    jl, tl = _loops(checkpoint_dir=None, inflight=2)
    tl = TTrainLoop(tl._net, tl.trainer, tloss.SoftmaxCrossEntropyLoss(),
                    inflight=2, checkpoint_dir=str(tmp_path / "t"),
                    checkpoint_every=6)
    jl = JTrainLoop(jl._net, jl._trainer, jloss.SoftmaxCrossEntropyLoss(),
                    inflight=2, checkpoint_dir=str(tmp_path / "j"),
                    checkpoint_every=6)
    x, y = _batch()
    jl.step(mx.nd.array(x), mx.nd.array(y))
    tl.step(torch.from_numpy(x), torch.from_numpy(y))
    jl.synchronize()
    tl.synchronize()
    jtel.reset()
    ttel.reset()
    for bx, by in jl.prefetch((mx.nd.array(x), mx.nd.array(y))
                              for _ in range(12)):
        jl.step(bx, by)
    for bx, by in tl.prefetch(((torch.from_numpy(x), torch.from_numpy(y))
                               for _ in range(12)), depth=2):
        tl.step(bx, by)
    for loop in (jl, tl):
        loop.synchronize()
        loop.wait()
    js, ts = jtel.snapshot(), ttel.snapshot()
    for name in (jnames.TRAIN_STEPS, jnames.WINDOW_RETIRES,
                 jnames.WINDOW_PUSHES, jnames.PREFETCH_BATCHES,
                 jnames.CHECKPOINT_SAVES):
        assert ts["counters"][name] == js["counters"][name] == \
            (2 if name == jnames.CHECKPOINT_SAVES else 12), name
    for name in (jnames.WINDOW_OCCUPANCY, jnames.WINDOW_CAPACITY):
        assert ts["gauges"][name] == js["gauges"][name], name
    tph, jph = ts["histograms"][tnames.STEP_PHASE_SECONDS], \
        js["histograms"][jnames.STEP_PHASE_SECONDS]
    for phase in ("dispatch", "window", "retire", "checkpoint"):
        assert tph[phase]["count"] == jph[phase]["count"], phase
    assert ts["histograms"][tnames.CHECKPOINT_CAPTURE_SECONDS]["count"] == 2
    assert ts["anomalies"]["count"] == 0
    text = ttel.prometheus_text()
    assert "mx_engine_window_occupancy 0" in text
    # the plain versions counted through the kernel funnel: none here
    # (Dense layers), so the series stays at its schema line
    assert "# TYPE mx_kernel_dispatch_total counter" in text


def test_injected_nan_loss_one_anomaly_at_its_step(monkeypatch):
    """A NaN batch at one known step: exactly ONE nan_loss anomaly in each
    package, attributed to that step, though every later loss is NaN (the
    stall detector is kept out of it: a loaded CPU's step times vary)."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_WATCHDOG_STALL_FACTOR", "50")
    jl, tl = _loops(inflight=2)
    x, y = _batch()
    xnan = onp.full((8, 4), onp.nan, "float32")
    jl.step(mx.nd.array(x), mx.nd.array(y))
    tl.step(torch.from_numpy(x), torch.from_numpy(y))
    jl.synchronize()
    tl.synchronize()
    jtel.reset()
    ttel.reset()
    inject = jl.global_step + 7
    assert tl.global_step + 7 == inject
    for _ in range(12):
        bad = jl.global_step + 1 == inject
        jl.step(mx.nd.array(xnan if bad else x), mx.nd.array(y))
        tl.step(torch.from_numpy(xnan if bad else x), torch.from_numpy(y))
    jl.synchronize()
    tl.synchronize()
    for wd, v in ((jtel.watchdog(), jtel.value(jnames.ANOMALIES,
                                                "nan_loss")),
                  (ttel.watchdog(), ttel.value(tnames.ANOMALIES,
                                               "nan_loss"))):
        ev = wd.anomalies()
        assert [(e["kind"], e["step"]) for e in ev] == \
            [("nan_loss", inject)] and v == 1


def test_slow_retire_one_stall_anomaly(monkeypatch):
    """The JAX test's artificial stall: one slow retire in a live window,
    one ``stall`` anomaly naming its tag, in both packages."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_WATCHDOG_STALL_FACTOR", "8")

    def sync(payload):
        time.sleep(0.25 if payload == "slow" else 0.002)

    jw = jengine.DispatchWindow(max_inflight=0, sync_fn=sync)
    tw = tengine.DispatchWindow(sync, max_inflight=0)
    for w in (jw, tw):
        for i in range(10):
            w.push("fast", tag=i)
        for i, p in ((30, "slow"), (31, "fast"), (32, "fast")):
            w.push(p, tag=i)
    for wd in (jtel.watchdog(), ttel.watchdog()):
        ev = wd.anomalies("stall")
        assert [e["step"] for e in ev] == [30]
    assert ttel.value(tnames.WINDOW_RETIRES) == 13
    assert ttel.value(tnames.WINDOW_OCCUPANCY) == 0
    assert ttel.value(tnames.WINDOW_CAPACITY) == 0


def test_window_error_counter_and_plain_dispatch_counter():
    def boom(payload):
        raise RuntimeError("device fault")

    w = tengine.DispatchWindow(boom, max_inflight=0)
    with pytest.raises(mxt.MXNetError, match="step 4"):
        w.push(1, tag=4)
    assert ttel.value(tnames.WINDOW_ERRORS) == 1
    from mxnet_tpu_torch.ops.kernels import norm
    x = torch.randn(4, 8)
    norm.layer_norm(x, torch.ones(8), torch.zeros(8), 1e-5)
    assert ttel.value(tnames.KERNEL_DISPATCH, "plain") == 1
    assert ttel.value(tnames.KERNEL_DISPATCH, "cuda") in (None, 0.0)


def test_arm_mfu_from_step_flops(monkeypatch):
    """``arm_mfu`` arms the watchdog with the step's FLOPs (the products
    FlopCounterMode sees, here the two Dense layers' forward and backward,
    plus the update's 20 a parameter element) and the gauges follow."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    _, tl = _loops(inflight=2)
    x, y = map(torch.from_numpy, _batch())
    flops = tl.arm_mfu(x, y, peak_flops=1e12)
    n_params = 8 * 4 + 8 + 3 * 8 + 3
    # forward 2*B*(4*8 + 8*3); backward: the grad of each weight, and the
    # input grad of the second layer (the first's input needs none)
    dense = 2 * 8 * (4 * 8 + 8 * 3) * 2 + 2 * 8 * 8 * 3
    assert flops == dense + 20 * n_params
    assert ttel.value(tnames.MODEL_FLOPS_PER_STEP) == flops
    for _ in range(8):
        tl.step(x, y)
    tl.synchronize()
    fps = ttel.value(tnames.MODEL_FLOPS_PER_SEC)
    assert fps > 0 and ttel.value(tnames.MFU) == pytest.approx(fps / 1e12)


# ---------------------------------------------------------------------------
# serving and elastic
# ---------------------------------------------------------------------------

def test_batcher_series_equal_its_own_counts():
    from mxnet_tpu_torch.serving import CompiledPredictor, DynamicBatcher
    _, tnet = _nets()
    pred = CompiledPredictor(tnet, bucket_sizes=(1, 2, 4, 8),
                             device="cpu")
    b = DynamicBatcher(pred, max_batch=8, timeout_ms=1.0, start=False)
    r = onp.random.RandomState(0)
    futs = [b.submit(r.randn(n, 4).astype("f4")) for n in (1, 3, 2, 4, 1)]
    b.flush()
    for f in futs:
        f.result(5)
    b.close()
    assert ttel.value(tnames.SERVING_REQUESTS) == b.stats["requests"] == 5
    assert ttel.value(tnames.SERVING_BATCHES) == b.stats["batches"]
    assert ttel.value(tnames.SERVING_LATENCY) == 5
    assert ttel.value(tnames.SERVING_OCCUPANCY) == b.stats["batches"]
    assert ttel.value(tnames.COMPILE_RETRACES) == pred.n_traces


def _elastic_build():
    torch.manual_seed(0)
    _, net = _nets()
    tr = TTrainer(dict(net.named_parameters()), "sgd",
                  {"learning_rate": 0.1})
    return net, tr, tloss.SoftmaxCrossEntropyLoss()


def test_stall_escalation_recovers_on_one_device(tmp_path, monkeypatch):
    """``stall_escalation=2``: two ``stall`` episodes on the watchdog's
    channel (reported there as the stall detector reports them: its own
    timing is held by the tests above) raise ``StallEscalation`` at the
    next step boundary; it is classified ``stall`` and recovered (torn
    down, re-formed, restored), counted in ``mx_elastic_recoveries_total
    {cause=stall}`` and the log's counts."""
    monkeypatch.setenv("MXNET_CPU_DEVICES", "1")
    x, y = map(torch.from_numpy, _batch())
    stalls = {8, 11}

    def batch_fn(i):
        if i in stalls:
            stalls.discard(i)
            ttel.watchdog().report("stall", i, message=f"step {i} stalled")
        return x, y

    log = elastic.RecoveryLog()
    sup = elastic.ElasticSupervisor(
        _elastic_build, str(tmp_path / "ck"), mesh_axes=None,
        stall_escalation=2, checkpoint_every=4, backoff_base=0.0,
        inflight=0, log=log, device="cpu")
    res = sup.run(batch_fn, 16)
    assert res.final_step == 16
    assert [(e["cause"], e["step"], e["restored_step"])
            for e in res.events] == [("stall", 12, 12)]
    assert log.counts == {"stall": 1}
    assert ttel.value(tnames.ELASTIC_RECOVERIES, "stall") == 1
    assert elastic.detect.classify(elastic.StallEscalation("x")) == "stall"


# ---------------------------------------------------------------------------
# the lint sweep
# ---------------------------------------------------------------------------

_REGISTER = re.compile(
    r"\.(counter|gauge|histogram)\(\s*([^,\)\s]+)", re.MULTILINE)


def test_every_series_the_port_registers_is_in_the_catalog():
    """Every ``registry().counter/gauge/histogram(...)`` call of the port
    names its series through ``telemetry/names.py``'s constants (never a
    string literal), each constant is in the catalog with that kind, and
    every catalog series the JAX package fills from a module the port has
    is registered by the port too."""
    used = {}
    for d, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            rel = os.path.relpath(path, ROOT)
            if rel.endswith(os.path.join("telemetry", "registry.py")):
                continue
            src = open(path, encoding="utf-8").read()
            for m in _REGISTER.finditer(src):
                kind, arg = m.group(1), m.group(2)
                assert not arg.startswith(("'", '"')), \
                    f"{rel}: {kind}({arg}) registers a string literal"
                const = arg.split(".")[-1]
                if not const.isupper():
                    continue
                assert hasattr(tnames, const), f"{rel}: {const}"
                name = getattr(tnames, const)
                assert name in tnames.CATALOG, f"{rel}: {name}"
                assert tnames.CATALOG[name]["kind"] == kind, \
                    f"{rel}: {name} registered as {kind}"
                used[name] = rel
    for const in ("TRAIN_STEPS", "WINDOW_PUSHES", "PREFETCH_BATCHES",
                  "COMPILE_RETRACES", "CHECKPOINT_SAVES",
                  "SERVING_REQUESTS", "SERVING_BREAKER_STATE",
                  "SERVING_RETRIES", "FLEET_ROUTED", "DECODE_TOKENS",
                  "DECODE_KV_PAGES", "ELASTIC_RECOVERIES",
                  "ELASTIC_PREEMPTIONS", "KERNEL_DISPATCH",
                  "HBM_PEAK_BYTES", "NUMERICS_GRAD_NORM", "ANOMALIES",
                  "HEARTBEATS"):
        assert getattr(tnames, const) in used, const


def test_registry_holds_under_concurrent_writers():
    """Threads (more than cores, a short switch interval) write one
    counter, one labeled gauge and one histogram while another exports:
    no update is lost."""
    import sys
    import threading
    reg = TRegistry()
    c = reg.counter("demo_hits_total")
    h = reg.histogram("demo_wait_seconds")
    g = reg.gauge("demo_level", label_key="worker")
    n_threads, n = 2 * min(os.cpu_count() or 4, 8), 500
    from mxnet_tpu_torch.telemetry import exporters as texp
    stop = threading.Event()

    def work(k):
        for i in range(n):
            c.inc()
            h.observe(i * 1e-5)
            g.add(1.0, label=str(k % 4))

    def export():
        while not stop.is_set():
            texp.prometheus_text(reg)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,))
              for k in range(n_threads)]
        ex = threading.Thread(target=export)
        ex.start()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        stop.set()
        ex.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts) and not ex.is_alive()
    assert c.value() == n_threads * n
    assert h.count() == n_threads * n
    assert sum(g.values().values()) == n_threads * n


def test_causal_pairs_counts_the_kept_pairs():
    """The pairs the flash wrappers report their FLOPs over: every
    (query, key) pair, or those the end-aligned causal mask keeps,
    counted one by one."""
    from mxnet_tpu_torch.ops.kernels import causal_pairs
    for sq in (1, 3, 7, 512, 513):
        for sk in (1, 5, 512, 600):
            assert causal_pairs(sq, sk, False) == sq * sk
            kept = sum(1 for i in range(sq) for j in range(sk)
                       if j <= i + sk - sq)
            assert causal_pairs(sq, sk, True) == kept, (sq, sk)
