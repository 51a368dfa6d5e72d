"""The serving fleet of mxnet_tpu_torch: the JAX package's
``tests/test_fleet.py`` case by case, on the CPU.

- least-projected-wait routing with ``fut.replica`` / ``fut.version``;
  open breakers, draining and retired replicas get ZERO new requests;
  no replica available is a typed ``Overloaded(reason="fleet")``;
- failover: a lost replica's in-flight and queued requests re-enqueue
  EXACTLY once onto the survivors, the replica restarts on a spare
  device (one restart), a request lost twice fails typed;
- scoped preemption notices drain the named replica only; the
  process-wide notice drains all;
- the rolling weight swap: the checkpoint validated first, one replica
  draining at a time (at most one version of skew), no accepted request
  dropped, outputs after it bit-equal to a fresh predictor on the new
  weights, a corrupt checkpoint aborting typed with the old weights
  serving, and no program captured again (``n_traces`` unchanged);
- autoscaling against the queue-wait EWMA; the warmup-seeded admission
  EWMA; the decode engine's mid-stream deadline shed; the loadgen's
  per-replica census;
- the chaos cases, threaded: a replica-targeted revoke mid-burst, a
  rolling swap under traffic.

The devices are the CPU's virtual ones (``MXNET_CPU_DEVICES=4``), each
replica pinned to one through ``context.Context``; a device loss is a
``revoke`` fault rule. The JAX package's ``mx_fleet_*`` series are read
here from ``stats``, ``routed`` and ``state_counts()``. The fleet's
answers are held against the JAX package's predictor on the same
numpy-seeded weights (float32, rtol 1e-5 / atol 1e-6). Every threaded
wait is bounded.
"""
import os
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointCorruptError, atomic
from mxnet_tpu_torch.checkpoint.state import capture_train_state
from mxnet_tpu_torch.elastic import detect
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.serving import loadgen
from mxnet_tpu_torch.serving.fleet import _Replica
from mxnet_tpu_torch.testing import faults

IN, HIDDEN, CLASSES = 16, 32, 4
BUCKETS = (1, 2, 4)


@pytest.fixture(autouse=True)
def _clean_harness(monkeypatch):
    """Four virtual CPU devices; the CPU is this thread's default
    device; every test leaves the chaos harness disarmed, devices
    restored and every (scoped) preemption notice cleared."""
    monkeypatch.setenv("MXNET_CPU_DEVICES", "4")
    monkeypatch.delenv("MXNET_SERVING_SHED", raising=False)
    with mxt.cpu():
        yield
    faults.reset()
    detect.notice().clear()
    detect.clear_scoped_notices()


def net_weights(seed=7):
    r = onp.random.RandomState(seed)
    return {"0.weight": (r.randn(HIDDEN, IN) * 0.3).astype("f4"),
            "0.bias": (r.randn(HIDDEN) * 0.1).astype("f4"),
            "1.weight": (r.randn(CLASSES, HIDDEN) * 0.3).astype("f4"),
            "1.bias": (r.randn(CLASSES) * 0.1).astype("f4")}


def make_net(seed=7):
    """The reference's MLP on the current device, numpy-seeded."""
    net = tnn.HybridSequential()
    net.add(tnn.Dense(HIDDEN, activation="relu", in_units=IN),
            tnn.Dense(CLASSES, in_units=HIDDEN))
    load_jax_params(net, net_weights(seed))
    return net


def build_pred(seed=7):
    # deterministic, per the build() contract: failover and restart
    # are bit-exact
    return serving.CompiledPredictor(make_net(seed), bucket_sizes=BUCKETS)


def rows(n, seed=0):
    return torch.from_numpy(onp.random.RandomState(seed).randn(
        n, IN).astype("float32"))


def make_fleet(clk, n=3, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("timeout_ms", 5.0)
    return serving.FleetController(
        build_pred, example=(rows(1),), replicas=n,
        clock=lambda: clk[0], start=False, **kw)


def seed_waits(fleet, waits):
    """Pin each replica's admission EWMA so routing is deterministic."""
    for rep, w in zip(fleet.replicas, waits):
        rep.sup.batcher._ewma_service = w


def pump_until_done(fleet, futs, rounds=50):
    for _ in range(rounds):
        if all(f.done() for f in futs):
            return
        fleet.pump(force=True)
    raise AssertionError("futures did not resolve under pump()")


# ---------------------------------------------------------------------------
# env accessors
# ---------------------------------------------------------------------------

def test_fleet_env_parsing(monkeypatch):
    for var in ("MXNET_FLEET_REPLICAS", "MXNET_FLEET_MIN_REPLICAS",
                "MXNET_FLEET_MAX_REPLICAS", "MXNET_FLEET_SCALE_UP_WAIT_MS",
                "MXNET_FLEET_SCALE_DOWN_WAIT_MS",
                "MXNET_FLEET_RESTART_RETRIES"):
        monkeypatch.delenv(var, raising=False)
    assert serving.fleet_replicas() == 1
    assert serving.fleet_min_replicas() == 1
    assert serving.fleet_max_replicas() == 0
    assert serving.fleet_scale_up_wait_s() == pytest.approx(0.2)
    assert serving.fleet_scale_down_wait_s() == pytest.approx(0.005)
    assert serving.fleet_restart_retries() == 2
    monkeypatch.setenv("MXNET_FLEET_REPLICAS", "3")
    monkeypatch.setenv("MXNET_FLEET_SCALE_UP_WAIT_MS", "50")
    monkeypatch.setenv("MXNET_FLEET_SCALE_DOWN_WAIT_MS", "-1")
    monkeypatch.setenv("MXNET_FLEET_RESTART_RETRIES", "0")
    assert serving.fleet_replicas() == 3
    assert serving.fleet_scale_up_wait_s() == pytest.approx(0.05)
    assert serving.fleet_scale_down_wait_s() < 0      # disables
    assert serving.fleet_restart_retries() == 0
    monkeypatch.setenv("MXNET_FLEET_REPLICAS", "junk")
    assert serving.fleet_replicas() == 1


def test_fleet_env_parsing_matches_jax(monkeypatch):
    from mxnet_tpu.serving import fleet as jfleet
    from mxnet_tpu_torch.serving import fleet as tfleet
    for env, val in (("MXNET_FLEET_REPLICAS", "4"),
                     ("MXNET_FLEET_MIN_REPLICAS", "2"),
                     ("MXNET_FLEET_MAX_REPLICAS", "-3"),
                     ("MXNET_FLEET_SCALE_UP_WAIT_MS", "12.5"),
                     ("MXNET_FLEET_SCALE_DOWN_WAIT_MS", "bad"),
                     ("MXNET_FLEET_RESTART_RETRIES", "-1")):
        monkeypatch.setenv(env, val)
    for name in ("fleet_replicas", "fleet_min_replicas",
                 "fleet_max_replicas", "fleet_scale_up_wait_s",
                 "fleet_scale_down_wait_s", "fleet_restart_retries"):
        assert getattr(tfleet, name)() == getattr(jfleet, name)(), name


def test_fleet_rejects_more_replicas_than_devices():
    too_many = len(tdist.available_devices()) + 1
    with pytest.raises(MXNetError, match="device"):
        serving.FleetController(build_pred, replicas=too_many,
                                start=False)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_router_picks_lowest_projected_wait():
    clk = [0.0]
    fleet = make_fleet(clk, 3)
    try:
        seed_waits(fleet, [0.5, 0.001, 0.5])
        fut = fleet.router.submit(rows(1))
        assert fut.replica == "replica-1"
        assert fut.version == 0
        assert fleet.stats["routed"] == 1
        seed_waits(fleet, [0.5, 0.5, 0.0001])
        fut2 = fleet.router.submit(rows(1, seed=1))
        assert fut2.replica == "replica-2"
        pump_until_done(fleet, [fut, fut2])
        assert fut.result(10).shape == (1, CLASSES)
        assert fut2.result(10).shape == (1, CLASSES)
    finally:
        fleet.close()


def test_replicas_are_pinned_to_distinct_devices():
    """Each replica is built inside its own device's Context: distinct
    devices of ``available_devices()``, in order."""
    clk = [0.0]
    fleet = make_fleet(clk, 3)
    try:
        assert [r.device for r in fleet.replicas] == \
            tdist.available_devices()[:3]
        assert fleet.state_counts() == {"serving": 3, "draining": 0,
                                        "recovering": 0, "retired": 0}
        d = fleet.describe()
        assert [r["device"] for r in d["replicas"]] == \
            ["cpu:0", "cpu:1", "cpu:2"]
    finally:
        fleet.close()


def test_router_skips_open_breaker_zero_new_requests():
    """An open breaker gets ZERO new routed requests: the router filters
    it out (no admission attempt, no queue entry)."""
    clk = [0.0]
    fleet = make_fleet(clk, 3)
    try:
        seed_waits(fleet, [0.001, 0.5, 0.5])   # victim would win
        victim = fleet.replicas[0]
        victim.sup.breaker.trip("test")
        assert not victim.routable()
        for i in range(4):
            fut = fleet.router.submit(rows(1, seed=i))
            assert fut.replica != victim.name
        assert victim.sup.batcher._queue.qsize() == 0
        assert len(victim.sup.batcher._forming) == 0
        assert fleet.routed.get(victim.name, 0) == 0
        victim.sup.breaker.close()
        fut = fleet.router.submit(rows(1))
        assert fut.replica == victim.name      # back in rotation
    finally:
        fleet.close()


def test_router_all_unavailable_is_typed_overloaded():
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        rej0 = fleet.stats["rejected_fleet"]
        for rep in fleet.replicas:
            rep.sup.breaker.trip("test")
        with pytest.raises(serving.Overloaded, match="no replica") as ei:
            fleet.router.submit(rows(1))
        assert ei.value.reason == "fleet"
        assert isinstance(ei.value, MXNetError)
        assert fleet.stats["rejected_fleet"] == rej0 + 1
    finally:
        fleet.close()


def test_router_falls_through_replica_rejection():
    """A replica that sheds at admission is skipped; the next serves."""
    clk = [0.0]
    fleet = make_fleet(clk, 2, depth=1)
    a, b = fleet.replicas
    try:
        seed_waits(fleet, [0.001, 0.5])
        filler = fleet.router.submit(rows(1))   # a's queue is full now
        assert filler.replica == a.name
        fut = fleet.router.submit(rows(1), timeout=0.01)
        assert fut.replica == b.name
        pump_until_done(fleet, [filler, fut])
    finally:
        fleet.close()


def test_route_fault_point_targets_one_replica():
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        seed_waits(fleet, [0.001, 0.5])
        faults.configure("serving.route@replica-0:before=1:error")
        with pytest.raises(faults.FaultInjectedError):
            fleet.router.submit(rows(1))
        faults.configure(None)
        fut = fleet.router.submit(rows(1))
        assert fut.replica == "replica-0"      # untargeted peer unharmed
    finally:
        fleet.close()


def test_fleet_answers_vs_jax_predictor():
    """Requests routed over three replicas against the JAX package's
    CompiledPredictor on the same numpy-seeded weights."""
    import mxnet_tpu as mx
    from mxnet_tpu import serving as jserving
    from mxnet_tpu.gluon import nn as jnn
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(HIDDEN, activation="relu", in_units=IN),
             jnn.Dense(CLASSES, in_units=HIDDEN))
    jnet.initialize()
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(net_weights()[k]))
    jpred = jserving.CompiledPredictor(jnet, bucket_sizes=BUCKETS)
    X = rows(6, seed=31)
    clk = [0.0]
    fleet = make_fleet(clk, 3)
    try:
        futs = []
        for i in range(6):
            seed_waits(fleet, [0.5] * 3)
            fleet.replicas[i % 3].sup.batcher._ewma_service = 0.001
            futs.append(fleet.router.submit(X[i:i + 1]))
        assert {f.replica for f in futs} == {r.name for r in
                                            fleet.replicas}
        pump_until_done(fleet, futs)
        for i, f in enumerate(futs):
            ref = jpred.predict(mx.nd.array(X[i:i + 1].numpy())).asnumpy()
            onp.testing.assert_allclose(f.result(10).numpy(), ref,
                                        rtol=1e-5, atol=1e-6)
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# replica-loss failover (manual drive, fake clock)
# ---------------------------------------------------------------------------

def test_failover_moves_riders_exactly_once_and_restarts():
    N = 6
    X = rows(N, seed=3)
    singles = [build_pred().predict(X[i:i + 1]).numpy() for i in range(N)]
    clk = [0.0]
    fleet = make_fleet(clk, 3)
    try:
        victim = fleet.replicas[2]
        old_device = victim.device
        old_pred = victim.sup.predictor
        seed_waits(fleet, [0.5, 0.5, 0.001])   # all traffic -> victim
        futs = [fleet.router.submit(X[i:i + 1]) for i in range(N)]
        assert all(f.replica == victim.name for f in futs)
        faults.configure(f"serving.dispatch@{victim.name}:before=1"
                         f":revoke:d{victim.device.index}")
        pump_until_done(fleet, futs)
        outs = [f.result(10).numpy() for f in futs]
        for i in range(N):                     # failover preserves answers
            assert (outs[i] == singles[i]).all()
        assert fleet.stats["failovers"] == 1
        assert fleet.stats["requeued"] >= 1
        assert fleet.stats["failed_requeues"] == 0
        assert fleet.stats["restarts"] == 1
        # restarted on the spare device, serving again, fresh breaker
        assert victim.state == _Replica.SERVING
        assert victim.device != old_device
        assert victim.device == torch.device("cpu", 3)
        assert victim.sup.breaker.state == "closed"
        # the lost replica's programs were freed at once
        assert len(old_pred._programs) == 0
        kinds = [e.kind for e in fleet.events if e.replica == victim.name]
        assert kinds[-3:] == ["replica_lost", "failover", "restart"]
        # riders carry the survivor breadcrumb after the re-arm
        assert all(f.replica != victim.name or f.done() for f in futs)
        seed_waits(fleet, [0.5, 0.5, 0.001])
        late = fleet.router.submit(X[:1])
        assert late.replica == victim.name
        pump_until_done(fleet, [late])
        assert (late.result(10).numpy() == singles[0]).all()
    finally:
        fleet.close()


def test_request_lost_twice_fails_typed():
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        a, b = fleet.replicas
        seed_waits(fleet, [0.001, 0.5])
        fut = fleet.router.submit(rows(1))
        assert fut.replica == a.name
        faults.configure(
            f"serving.dispatch@{a.name}:before=1:revoke:d{a.device.index};"
            f"serving.dispatch@{b.name}:before=1:revoke:d{b.device.index}")
        for _ in range(20):
            if fut.done():
                break
            fleet.pump(force=True)
        with pytest.raises(MXNetError, match="repeated device"):
            fut.result(5)
        assert fleet.stats["failed_requeues"] == 1
        assert fleet.stats["failovers"] == 2
    finally:
        fleet.close()


def test_restart_exhaustion_retires_replica(monkeypatch):
    """Every restart attempt failing (nothing spare) retires the replica
    with the error recorded: no endless loop."""
    monkeypatch.setenv("MXNET_FLEET_RESTART_RETRIES", "1")
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        a = fleet.replicas[0]
        monkeypatch.setattr(fleet, "_pick_device",
                            lambda exclude=None: None)
        seed_waits(fleet, [0.001, 0.5])
        fut = fleet.router.submit(rows(1))
        faults.configure(f"serving.dispatch@{a.name}:before=1"
                         f":revoke:d{a.device.index}")
        pump_until_done(fleet, [fut])          # rider lands on survivor
        assert fut.result(10).shape == (1, CLASSES)
        assert a.state == _Replica.RETIRED
        assert isinstance(a.error, MXNetError)
        assert any(e.kind == "restart_failed" for e in fleet.events)
        assert fleet.stats["restarts"] == 0
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# scoped preemption drain (fake clock)
# ---------------------------------------------------------------------------

def test_scoped_notice_drains_only_named_replica():
    clk = [0.0]
    fleet = make_fleet(clk, 3)
    try:
        target = fleet.replicas[1]
        seed_waits(fleet, [0.5, 0.001, 0.5])
        futs = [fleet.router.submit(rows(1, seed=i)) for i in range(3)]
        assert all(f.replica == target.name for f in futs)
        detect.notice(target.scope).trigger()
        fleet.poll()                           # manual-mode drain
        assert target.state == _Replica.RETIRED
        for f in futs:                         # accepted requests land
            assert f.result(10).shape == (1, CLASSES)
        others = [r for r in fleet.replicas if r is not target]
        assert all(r.state == _Replica.SERVING for r in others)
        fut = fleet.router.submit(rows(1))
        assert fut.replica != target.name
        pump_until_done(fleet, [fut])
        assert fut.result(10).shape == (1, CLASSES)
        kinds = [(e.kind, e.replica) for e in fleet.events
                 if e.kind in ("drain", "retire")]
        assert kinds == [("drain", target.name), ("retire", target.name)]
    finally:
        fleet.close()


def test_global_notice_drains_every_replica():
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        detect.notice().trigger()
        fleet.poll()
        assert all(r.state == _Replica.RETIRED for r in fleet.replicas)
        with pytest.raises(serving.Overloaded) as ei:
            fleet.router.submit(rows(1))
        assert ei.value.reason == "fleet"
    finally:
        detect.notice().clear()
        fleet.close()


def test_training_supervisor_ignores_scoped_notices():
    """A replica-scoped notice never pauses training: the elastic
    supervisor polls only the process-wide notice."""
    detect.notice("fleet/replica-0").trigger()
    assert detect.notice("fleet/replica-0").requested()
    assert not detect.notice().requested()
    detect.clear_scoped_notices()
    assert not detect.notice("fleet/replica-0").requested()
    # and the global notice reaches scoped listeners (drain everything)
    detect.notice().trigger()
    assert detect.notice("fleet/replica-0").requested()


# ---------------------------------------------------------------------------
# autoscaling (fake clock)
# ---------------------------------------------------------------------------

def test_autoscale_up_and_down(monkeypatch):
    monkeypatch.setenv("MXNET_FLEET_SCALE_UP_WAIT_MS", "100")
    monkeypatch.setenv("MXNET_FLEET_SCALE_DOWN_WAIT_MS", "5")
    clk = [0.0]
    fleet = make_fleet(clk, 2, min_replicas=1, max_replicas=3)
    try:
        fleet.queue_wait_ewma = 0.5            # way past the high water
        assert fleet.maybe_scale() == "up"
        assert len([r for r in fleet.replicas
                    if r.state == _Replica.SERVING]) == 3
        assert fleet.stats["scale_ups"] == 1
        assert fleet.maybe_scale() is None     # at max_replicas
        fleet.queue_wait_ewma = 0.001          # idle below the low water
        assert fleet.maybe_scale() == "down"
        assert fleet.stats["scale_downs"] == 1
        serving_now = [r for r in fleet.replicas
                       if r.state == _Replica.SERVING]
        assert len(serving_now) == 2
        fleet.queue_wait_ewma = 0.001
        fleet.maybe_scale()
        fleet.queue_wait_ewma = 0.001
        assert fleet.maybe_scale() is None     # floor: min_replicas=1
        assert len([r for r in fleet.replicas
                    if r.state == _Replica.SERVING]) == 1
    finally:
        fleet.close()


def test_autoscale_down_disabled(monkeypatch):
    monkeypatch.setenv("MXNET_FLEET_SCALE_DOWN_WAIT_MS", "0")
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        fleet.queue_wait_ewma = 0.0
        assert fleet.maybe_scale() is None
        assert fleet.stats["scale_downs"] == 0
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# rolling weight swap
# ---------------------------------------------------------------------------

def write_ckpt(tmp_path, seed=23, step=1):
    """A committed checkpoint of a DIFFERENT deterministic net's
    weights (what a training run would have produced)."""
    st = capture_train_state(net=make_net(seed), step=step)
    root = os.path.join(str(tmp_path), "ckpt")
    return atomic.write_checkpoint(root, step, st.arrays,
                                   array_meta=st.array_meta,
                                   meta=st.meta), root


def test_rolling_swap_zero_drop_bit_exact(tmp_path):
    N = 4
    X = rows(N, seed=5)
    old_out = [build_pred().predict(X[i:i + 1]).numpy() for i in range(N)]
    new_out = [build_pred(23).predict(X[i:i + 1]).numpy()
               for i in range(N)]
    path, root = write_ckpt(tmp_path)
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        traces = [r.sup.predictor.n_traces for r in fleet.replicas]
        seed_waits(fleet, [0.001, 0.001])
        # accepted-but-unserved traffic rides through the rollout
        inflight = [fleet.router.submit(X[i:i + 1]) for i in range(N)]
        res = fleet.swap_weights(root)         # resolves newest valid
        assert res["version"] == 1 and res["replicas"] == 2
        assert res["path"] == path
        assert fleet.version == 1
        assert all(r.version == 1 for r in fleet.replicas)
        assert fleet.stats["swaps"] == 1
        # zero dropped: the in-flight requests flushed during the drain,
        # ON THE OLD WEIGHTS
        for i, f in enumerate(inflight):
            assert (f.result(10).numpy() == old_out[i]).all()
        # <= 1 version of skew: replicas drained strictly one at a time
        order = [(e.kind, e.replica) for e in fleet.events
                 if e.kind in ("swap_drain", "swap_done")]
        assert order == [("swap_drain", "replica-0"),
                         ("swap_done", "replica-0"),
                         ("swap_drain", "replica-1"),
                         ("swap_done", "replica-1")]
        # after the swap: bit-exact against a fresh predictor on the new
        # weights, with no program captured again
        for i in range(N):
            fut = fleet.router.submit(X[i:i + 1])
            assert fut.version == 1
            pump_until_done(fleet, [fut])
            assert (fut.result(10).numpy() == new_out[i]).all()
        assert [r.sup.predictor.n_traces for r in fleet.replicas] == traces
    finally:
        fleet.close()


def test_corrupt_checkpoint_aborts_typed_old_weights_serve(tmp_path):
    X = rows(2, seed=5)
    old_out = [build_pred().predict(X[i:i + 1]).numpy() for i in range(2)]
    path, _root = write_ckpt(tmp_path)
    # flip bytes in one committed array file: the CRC must catch it
    arrays_dir = os.path.join(path, "arrays")
    victim_file = os.path.join(arrays_dir,
                               sorted(os.listdir(arrays_dir))[0])
    with open(victim_file, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef")
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        with pytest.raises(CheckpointCorruptError):
            fleet.swap_weights(path)
        # typed abort BEFORE any replica drained
        assert fleet.version == 0
        assert all(r.state == _Replica.SERVING for r in fleet.replicas)
        assert all(r.version == 0 for r in fleet.replicas)
        assert fleet.stats["swaps"] == 0
        assert not any(e.kind.startswith("swap_drain")
                       for e in fleet.events)
        seed_waits(fleet, [0.001, 0.5])
        fut = fleet.router.submit(X[:1])
        pump_until_done(fleet, [fut])
        assert (fut.result(10).numpy() == old_out[0]).all()
    finally:
        fleet.close()


def test_failed_copy_rolls_back_to_the_old_weights_in_place(tmp_path):
    """A checkpoint whose shapes do not fit passes its CRCs but fails
    the copy: the replica is back on its old weights bit for bit, in the
    same storage (the captured programs read it), and serving."""
    st = capture_train_state(net=make_net(23), step=1)
    st.arrays["param/1.bias"] = onp.zeros(CLASSES + 1, "f4")
    root = os.path.join(str(tmp_path), "bad")
    path = atomic.write_checkpoint(root, 1, st.arrays,
                                   array_meta=st.array_meta, meta=st.meta)
    X = rows(1, seed=8)
    old = build_pred().predict(X).numpy()
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        rep = fleet.replicas[0]
        ptrs = [p.data_ptr() for p in rep.sup.predictor.net.parameters()]
        with pytest.raises(MXNetError, match="shape"):
            fleet.swap_weights(path)
        assert [p.data_ptr() for p in
                rep.sup.predictor.net.parameters()] == ptrs
        assert rep.state == _Replica.SERVING and rep.version == 0
        assert any(e.kind == "swap_abort" for e in fleet.events)
        seed_waits(fleet, [0.001, 0.5])
        fut = fleet.router.submit(X)
        assert fut.replica == rep.name
        pump_until_done(fleet, [fut])
        assert (fut.result(10).numpy() == old).all()
    finally:
        fleet.close()


def test_swap_missing_checkpoint_is_typed(tmp_path):
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        with pytest.raises(MXNetError, match="no valid checkpoint"):
            fleet.swap_weights(str(tmp_path / "empty"))
    finally:
        fleet.close()


def test_manager_latest_path_feeds_swap(tmp_path):
    """TrainCheckpointManager.latest_path() is the training-to-serving
    rollout handle."""
    from mxnet_tpu_torch.checkpoint import TrainCheckpointManager
    root = str(tmp_path / "mgr")
    mgr = TrainCheckpointManager(root, keep_last=2)
    assert mgr.latest_path() is None
    mgr.save(5, net=make_net(23), block=True)
    p = mgr.latest_path()
    assert p is not None and os.path.isdir(p)
    atomic.validate_checkpoint(p)              # swap-ready
    clk = [0.0]
    fleet = make_fleet(clk, 1)
    try:
        assert fleet.swap_weights(p)["path"] == p
        X = rows(1, seed=2)
        fut = fleet.router.submit(X)
        pump_until_done(fleet, [fut])
        assert (fut.result(10).numpy() ==
                build_pred(23).predict(X).numpy()).all()
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# warmup-seeded EWMA, decode mid-stream shed, loadgen census
# ---------------------------------------------------------------------------

def test_warmup_seeds_admission_ewma():
    """A warmed predictor hands its replay timing to the batcher, so
    deadline shedding projects from request 1."""
    pred = build_pred()
    assert pred.service_time_seed_s is None
    cold = serving.DynamicBatcher(pred, start=False, max_batch=4)
    assert cold._ewma_service is None
    assert cold.estimated_wait_s(1) is None    # blind before warmup
    cold.close()
    pred.warmup(rows(1))
    assert pred.service_time_seed_s is not None
    assert pred.service_time_seed_s > 0
    warm = serving.DynamicBatcher(pred, start=False, max_batch=4)
    assert warm._ewma_service == pytest.approx(pred.service_time_seed_s)
    assert warm.estimated_wait_s(1) is not None
    warm.close()


def test_warm_seed_sheds_from_first_request(monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_SHED", "deadline")
    pred = build_pred()
    pred.warmup(rows(1))
    pred.service_time_seed_s = 0.050           # pin a slow seed
    clk = [0.0]
    b = serving.DynamicBatcher(pred, start=False, max_batch=4,
                               clock=lambda: clk[0])
    with pytest.raises(serving.Overloaded) as ei:
        b.submit(rows(1), deadline_ms=20.0)
    assert ei.value.reason == "deadline"       # shed on request ONE
    b.close()


def test_decode_midstream_deadline_shed_returns_pages():
    """A stream whose TPOT EWMA says the remaining tokens cannot finish
    in budget is shed MID-stream with a typed DeadlineExceeded, and its
    KV pages return to the pool."""
    clk = [0.0]
    model = serving.TinyDecoder(vocab=32, d_model=16, num_heads=2, seed=0,
                                device="cpu")
    eng = serving.DecodeEngine(model, ladder=(1, 2), max_context=64,
                               page_size=8, start=False,
                               clock=lambda: clk[0])
    eng.warmup()
    free0 = eng.kv.free_pages()
    stream = eng.submit(onp.array([3, 1], onp.int32), max_new=24,
                        deadline_ms=200.0)
    for _ in range(30):
        if stream.done:
            break
        clk[0] += 0.060
        eng.step_once()
        eng.sync()
    with pytest.raises(serving.DeadlineExceeded, match="mid-flight"):
        stream.result(5)
    rec = stream.record()
    assert 0 < rec["tokens"] < 24              # shed MID-stream
    assert eng.stats["shed_midstream"] == 1
    assert eng.stats["deadline_missed"] >= 1
    assert eng.kv.free_pages() == free0        # pages back in the pool
    assert all(r is None for r in eng._occupant)
    eng.close()


def test_decode_stream_without_deadline_never_shed_midstream():
    clk = [0.0]
    model = serving.TinyDecoder(vocab=32, d_model=16, num_heads=2, seed=0,
                                device="cpu")
    eng = serving.DecodeEngine(model, ladder=(1, 2), max_context=64,
                               page_size=8, start=False,
                               clock=lambda: clk[0])
    eng.warmup()
    stream = eng.submit(onp.array([3, 1], onp.int32), max_new=4)
    for _ in range(30):
        if stream.done:
            break
        clk[0] += 60.0                         # hopeless pace, no budget
        eng.step_once()
        eng.sync()
    assert len(stream.result(5)) == 4          # runs to completion
    assert eng.stats["shed_midstream"] == 0
    eng.close()


class _FakeFut:
    def __init__(self, replica, exc=None):
        self.replica = replica
        self._exc = exc

    def result(self, timeout=None):
        if self._exc is not None:
            raise self._exc


def test_loadgen_fleet_census_round_robin():
    subs = [lambda *a, **kw: _FakeFut("r0"),
            lambda *a, **kw: _FakeFut("r1")]
    rep = loadgen.run_closed_loop(
        loadgen.fleet_issue(subs, lambda i: (i,)),
        concurrency=2, requests=10)
    assert rep["outcomes"]["ok"] == 10
    census = rep["replicas"]
    assert census["r0"]["outcomes"]["ok"] == 5
    assert census["r1"]["outcomes"]["ok"] == 5
    assert census["r0"]["qps"] > 0
    assert "p99_ms" in census["r0"]


def test_loadgen_fleet_census_attributes_failures():
    def sub(i, *a, **kw):
        if i % 2:
            return _FakeFut("r1", serving.DeadlineExceeded("late"))
        return _FakeFut("r0")

    rep = loadgen.run_closed_loop(
        loadgen.fleet_issue([sub], lambda i: (i,)),
        concurrency=1, requests=8)
    census = rep["replicas"]
    assert census["r0"]["outcomes"]["ok"] == 4
    assert census["r1"]["outcomes"]["deadline_missed"] == 4
    assert rep["outcomes"] == {"ok": 4, "rejected": 0,
                               "deadline_missed": 4, "error": 0}


def test_open_loop_through_fleet_submit():
    """``fleet_submit`` over a threaded fleet: the open loop's census
    holds every request, attributed to the replica that served it."""
    fleet = serving.FleetController(build_pred, example=(rows(1),),
                                     replicas=2, max_batch=4,
                                     timeout_ms=1.0)
    try:
        rep = loadgen.run_open_loop(
            loadgen.fleet_submit(fleet.router,
                                 lambda i: (rows(1, seed=i),)),
            rate_qps=500.0, requests=24, timeout=30.0)
    finally:
        fleet.close()
    assert rep["outcomes"]["ok"] == 24 and rep["errors"] == 0
    assert sum(r["outcomes"]["ok"] for r in rep["replicas"].values()) == 24
    assert set(rep["replicas"]) <= {"replica-0", "replica-1"}


def test_replica_states_track_the_lifecycle():
    """The state half of the JAX package's replica gauge: counts by
    lifecycle state, from ``state_counts()``."""
    clk = [0.0]
    fleet = make_fleet(clk, 2)
    try:
        assert fleet.state_counts()["serving"] == 2
        fleet.drain_then_retire(fleet.replicas[0])
        counts = fleet.state_counts()
        assert counts["serving"] == 1 and counts["retired"] == 1
        assert len(fleet.replicas[0].sup.predictor._programs) == 0
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# chaos: replica-targeted revoke mid-burst, threaded fleet
# ---------------------------------------------------------------------------

def _client_loop(fleet, X, results, errors):
    def client(i):
        deadline = time.time() + 60
        while True:
            try:
                results[i] = fleet.router.submit(X[i:i + 1]).result(60)
                return
            except (serving.Overloaded, serving.ServingShutdown):
                # typed retryable signals: breaker fast-fail, fleet
                # saturation, or "arrived during fleet failover"
                if time.time() >= deadline:
                    raise
                time.sleep(0.01)
            except MXNetError as e:
                errors[i] = e
                return
    return client


def test_chaos_fleet_kill_one_replica_mid_burst(monkeypatch):
    """3 threaded replicas, a 28-request burst, one replica-targeted
    revoke mid-traffic: zero lost accepted requests, zero hangs, exactly
    one restart, the victim back in rotation on the spare device,
    bit-exact results."""
    N = 28
    X = rows(N, seed=13)
    singles = [build_pred().predict(X[i:i + 1]).numpy() for i in range(N)]
    monkeypatch.setenv("MXNET_SERVING_SHED", "off")
    results = [None] * N
    errors = [None] * N
    fleet = serving.FleetController(
        build_pred, example=(rows(1),), replicas=3, max_batch=4,
        timeout_ms=2.0)
    try:
        victim = fleet.replicas[-1]
        # steer the burst's head at the victim, so the targeted fault
        # is sure to fire
        victim.sup.batcher._ewma_service = 1e-6
        faults.configure(f"serving.dispatch@{victim.name}:before=2"
                         f":revoke:d{victim.device.index}")
        threads = [threading.Thread(
            target=_client_loop(fleet, X, results, errors), args=(i,),
            daemon=True) for i in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(90)
        hung = [i for i, t in enumerate(threads) if t.is_alive()]
        assert not hung, f"clients hung: {hung}"
        assert fleet.wait_restarts(60)
        assert any(e.kind == "restart" for e in fleet.events), \
            "victim replica never restarted"
        assert fleet.stats["failovers"] == 1
        assert fleet.stats["restarts"] == 1
        assert victim.state == _Replica.SERVING
        assert victim.device == torch.device("cpu", 3)
        faults.restore_devices()
        late = fleet.router.submit(X[:1])
        assert late.result(30) is not None
    finally:
        fleet.close()
    for i in range(N):
        assert (results[i] is None) != (errors[i] is None), \
            f"request {i} has no terminal state"
        assert errors[i] is None, \
            f"request {i}: terminal failure {errors[i]!r}"
    for i in range(N):
        assert (results[i].numpy() == singles[i]).all(), \
            f"request {i} differs from single dispatch"


def test_chaos_rolling_swap_under_traffic(tmp_path, monkeypatch):
    """A rolling swap while threaded traffic flows: zero dropped
    accepted requests, every result bit-exact against the OLD or the
    NEW weights as its ``fut.version`` says (never a torn mix), and the
    fleet at the new version afterwards."""
    N = 24
    X = rows(N, seed=19)
    outs = {0: [build_pred().predict(X[i:i + 1]).numpy()
                for i in range(N)],
            1: [build_pred(23).predict(X[i:i + 1]).numpy()
                for i in range(N)]}
    monkeypatch.setenv("MXNET_SERVING_SHED", "off")
    _path, root = write_ckpt(tmp_path)
    results = [None] * N
    versions = [None] * N
    errors = [None] * N
    fleet = serving.FleetController(
        build_pred, example=(rows(1),), replicas=3, max_batch=4,
        timeout_ms=2.0)
    try:
        def client(i):
            deadline = time.time() + 60
            while True:
                try:
                    fut = fleet.router.submit(X[i:i + 1])
                    results[i] = fut.result(60)
                    versions[i] = fut.version
                    return
                except (serving.Overloaded, serving.ServingShutdown):
                    if time.time() >= deadline:
                        raise
                    time.sleep(0.005)
                except MXNetError as e:
                    errors[i] = e
                    return

        threads = [threading.Thread(target=client, args=(i,),
                                    daemon=True) for i in range(N)]
        for t in threads:
            t.start()
        time.sleep(0.05)                       # traffic in flight
        res = fleet.swap_weights(root)
        assert res["replicas"] == 3
        for t in threads:
            t.join(90)
        hung = [i for i, t in enumerate(threads) if t.is_alive()]
        assert not hung, f"clients hung: {hung}"
        for i in range(N):
            assert errors[i] is None and results[i] is not None, \
                f"request {i}: {errors[i]!r}"
            assert (results[i].numpy() == outs[versions[i]][i]).all(), \
                f"request {i} does not match its version {versions[i]}"
        assert fleet.version == 1
        assert all(r.version == 1 for r in fleet.replicas
                   if r.state == _Replica.SERVING)
        fut = fleet.router.submit(X[:1])
        assert (fut.result(30).numpy() == outs[1][0]).all()
    finally:
        fleet.close()
