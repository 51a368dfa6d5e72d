"""The concurrency audit of mxnet_tpu_torch (``analysis/threads.py``,
``testing/sched.py``) against the JAX package's.

Both packages keep a pure-Python copy of the same audit, so the same
seed over the same task bodies must give the same interleaving (the
scheduler's trace and the bodies' log, seeds 0-63) and a wedged schedule
the same ``SchedDeadlock`` message, exactly. The port's own audited locks
carry the JAX package's names, and the port's threaded serving leaves a
lock-order graph without a cycle, inside
``tests/fixtures/torch_lock_hierarchy.json``. Tolerances: none, every
comparison is exact.
"""
import glob
import json
import os
import re
import threading
import time

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.analysis import threads as tthreads
from mxnet_tpu_torch.testing import sched as tsched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "tests", "fixtures",
                        "torch_lock_hierarchy.json")
SEEDS = 64


def _pkgs():
    """(threads, sched) of the JAX package and of the port."""
    from mxnet_tpu.analysis import threads as jthreads
    from mxnet_tpu.testing import sched as jsched
    return (jthreads, jsched), (tthreads, tsched)


def _contended(threads, sched, seed):
    g = threads.LockOrderGraph()
    lk = threads.mx_lock("test.sched.contend", graph=g)
    log = []

    def body(tag):
        for _ in range(3):
            with lk:
                log.append(tag)

    s = sched.VirtualScheduler(seed=seed, name="det")
    s.spawn("a", body, "a")
    s.spawn("b", body, "b")
    s.run()
    return log, list(s.trace)


def _producer_consumer(threads, sched, seed):
    cv = threads.mx_condition("test.sched.cv")
    q = sched.SchedQueue(maxsize=2)
    items, got = [], []

    def producer():
        for i in range(4):
            with cv:
                items.append(i)
                cv.notify()
            q.put(i)

    def consumer():
        for _ in range(4):
            with cv:
                while not items:
                    cv.wait()
                got.append(("cv", items.pop(0)))
            got.append(("q", q.get()))

    s = sched.VirtualScheduler(seed=seed, name="pc")
    s.spawn("producer", producer)
    s.spawn("consumer", consumer)
    s.run()
    return got, list(s.trace)


@pytest.mark.sched
@pytest.mark.parametrize("case", ["contended", "producer_consumer"])
def test_same_interleaving_as_jax_for_seeds_0_to_63(case):
    """One body set, both packages' schedulers, seeds 0-63: the same
    trace (which task ran at each schedule point) and the same log."""
    fn = {"contended": _contended,
          "producer_consumer": _producer_consumer}[case]
    (jthreads, jsched), (pthreads, psched) = _pkgs()
    outcomes = set()
    for seed in range(SEEDS):
        ref = fn(jthreads, jsched, seed)
        got = fn(pthreads, psched, seed)
        assert got == ref, seed
        outcomes.add(tuple(got[1]))
    assert len(outcomes) > 1        # the sweep varies the interleaving


def _ab_ba(threads, sched, seed):
    g = threads.LockOrderGraph()
    a = threads.mx_lock("test.dl.a", graph=g)
    b = threads.mx_lock("test.dl.b", graph=g)

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    s = sched.VirtualScheduler(seed=seed, name="dl")
    s.spawn("ab", ab)
    s.spawn("ba", ba)
    try:
        s.run()
    except sched.SchedDeadlock as e:
        return str(e), len(threads.cycle_findings(g))
    return None, len(threads.cycle_findings(g))


@pytest.mark.sched
def test_sched_deadlock_names_the_same_obstacles_as_jax():
    """A planted AB/BA inversion wedges the same seeds in both packages,
    with the same message (each task's obstacle, the lock's owner, the
    trace's tail), and the static audit reports it as one cycle."""
    (jthreads, jsched), (pthreads, psched) = _pkgs()
    wedged = 0
    for seed in range(SEEDS):
        ref = _ab_ba(jthreads, jsched, seed)
        got = _ab_ba(pthreads, psched, seed)
        assert got == ref, seed
        if got[0] is not None:
            wedged += 1
            assert "test.dl" in got[0] and f"seed={seed}" in got[0]
        assert got[1] == 1
    assert 0 < wedged < SEEDS


@pytest.mark.sched
def test_explore_runs_every_seed_and_checks():
    def build(s):
        q = tsched.SchedQueue(maxsize=2)
        got = []

        def producer():
            for i in range(4):
                q.put(i)

        def consumer():
            for _ in range(4):
                got.append(q.get())

        s.spawn("producer", producer)
        s.spawn("consumer", consumer)

        def check(_s):
            assert got == [0, 1, 2, 3]
        return check

    assert tsched.explore(build, seeds=16, name="q") == 16


# ---------------------------------------------------------------------------
# the lock-order graph (the JAX package's goldens, on the port's copy)
# ---------------------------------------------------------------------------

def test_nested_acquire_records_edge_with_sites():
    g = tthreads.LockOrderGraph()
    a = tthreads.mx_lock("test.edge.a", graph=g)
    b = tthreads.mx_lock("test.edge.b", graph=g)
    for n in (1, 2):
        with a:
            with b:
                pass
        (e,) = g.edges()
        assert (e["from"], e["to"], e["count"]) == \
            ("test.edge.a", "test.edge.b", n)
    assert "test_torch_threads.py" in e["to_site"][0]
    assert g.find_cycles() == []


def test_planted_inversion_is_one_cycle_finding_as_in_jax():
    from mxnet_tpu.analysis import threads as jthreads
    out = []
    for threads in (jthreads, tthreads):
        g = threads.LockOrderGraph()
        a = threads.mx_lock("test.inv.a", graph=g)
        b = threads.mx_lock("test.inv.b", graph=g)
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        (f,) = threads.cycle_findings(g)
        out.append((f.rule, f.severity, f.where, g.find_cycles()))
    assert out[0] == out[1]
    assert out[1][:2] == ("lock-cycle", "error")


def test_rlock_reacquire_and_hierarchy_check():
    g = tthreads.LockOrderGraph()
    r = tthreads.mx_rlock("test.re.r", graph=g)
    with r:
        with r:
            pass
    assert g.edges() == []
    a = tthreads.mx_lock("test.base.a", graph=g)
    b = tthreads.mx_lock("test.base.b", graph=g)
    with a:
        with b:
            pass
    assert tthreads.check_hierarchy({("test.base.a", "test.base.b")},
                                    g) == []
    (bad,) = tthreads.check_hierarchy(set(), g)
    assert bad.rule == "lock-order"
    assert "torch_lock_hierarchy.json" in bad.message


def test_baseline_save_load_roundtrip(tmp_path):
    g = tthreads.LockOrderGraph()
    a = tthreads.mx_lock("test.rt.a", graph=g)
    b = tthreads.mx_lock("test.rt.b", graph=g)
    with a:
        with b:
            pass
    p = str(tmp_path / "hier.json")
    tthreads.save_baseline(p, g)
    assert json.load(open(p))["schema"] == 1
    assert tthreads.load_baseline(p) == {("test.rt.a", "test.rt.b")}


def test_planted_stall_one_anomaly_one_dump(tmp_path, monkeypatch):
    """MXNET_LOCK_STALL_SEC: one ``deadlock`` episode and one ranked dump
    in MXNET_THREADS_DUMP_DIR for a stall, however long."""
    monkeypatch.setenv("MXNET_LOCK_STALL_SEC", "0.12")
    monkeypatch.setenv("MXNET_THREADS_DUMP_DIR", str(tmp_path))
    wd = ttel.watchdog()
    wd.reset()
    dumps0 = ttel.value(ttel.names.THREADS_DUMPS) or 0
    lk = tthreads.mx_lock("test.stall.planted")
    release = threading.Event()

    def holder():
        with lk:
            release.wait(5.0)

    def waiter():
        with lk:
            pass

    h = threading.Thread(target=holder, name="stall-holder", daemon=True)
    h.start()
    for _ in range(500):
        if lk.locked():
            break
        time.sleep(0.005)
    w = threading.Thread(target=waiter, name="stall-waiter", daemon=True)
    w.start()
    time.sleep(0.4)
    release.set()
    h.join(5.0)
    w.join(5.0)
    (ev,) = wd.anomalies("deadlock")
    assert "test.stall.planted" in ev["message"]
    assert "stall-waiter" in ev["message"] and \
        "stall-holder" in ev["message"]
    (path,) = glob.glob(os.path.join(str(tmp_path), "mx-threads-*.json"))
    payload = json.load(open(path))
    assert payload["stalled"]["owner"] == "stall-holder"
    assert payload["threads"][0]["name"] == "stall-waiter"
    assert (ttel.value(ttel.names.THREADS_DUMPS) or 0) - dumps0 == 1
    wd.reset()


# ---------------------------------------------------------------------------
# the port's audited locks
# ---------------------------------------------------------------------------

#: JAX lock names with no counterpart in the port: the JAX engine's
#: singleton and its host-callback lock (the port has no Engine object)
_NOT_PORTED = {"engine.singleton", "engine.host"}


def _audited_names(root):
    names = set()
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(d, f)).read()
                names.update(re.findall(
                    r'mx_(?:lock|rlock|condition)\("([^"]+)"', src))
    return names


def test_audited_locks_carry_the_jax_names():
    """Every lock the JAX package audits has an audited lock of the same
    name in the port (its ported modules), and the live objects carry
    them."""
    jax_names = _audited_names(os.path.join(ROOT, "mxnet_tpu"))
    port_names = _audited_names(os.path.join(ROOT, "mxnet_tpu_torch"))
    assert jax_names - _NOT_PORTED <= port_names, \
        sorted(jax_names - _NOT_PORTED - port_names)
    from mxnet_tpu_torch.engine import DispatchWindow
    from mxnet_tpu_torch.serving import CircuitBreaker
    from mxnet_tpu_torch.telemetry import exporters
    from mxnet_tpu_torch.tuning import cache
    w = DispatchWindow(lambda p: None, max_inflight=1)
    assert isinstance(w._mu, tthreads.MxLock) and \
        w._mu.name == "engine.window"
    assert CircuitBreaker()._lock.name == "serving.breaker"
    assert exporters._hb_lock.name == "telemetry.heartbeat"
    assert cache._DLOCK.name == "tuning.cache.default"


def test_threaded_serving_leaves_the_lock_graph_inside_the_hierarchy():
    """Threaded serving on the CPU (a DynamicBatcher over a predictor,
    eight client threads, a drain) adds no lock-order cycle, and every
    edge of the process's graph lies inside the checked-in hierarchy."""
    from mxnet_tpu_torch.gluon.nn import Dense
    from mxnet_tpu_torch.serving import CompiledPredictor, DynamicBatcher
    torch.manual_seed(0)
    net = torch.nn.Sequential(Dense(8, in_units=4, device="cpu"))
    pred = CompiledPredictor(net, bucket_sizes=(4, 8), device="cpu")
    rs = onp.random.RandomState(0)
    rows = [rs.randn(1, 4).astype("f4") for _ in range(32)]
    with DynamicBatcher(pred, max_batch=8, timeout_ms=1.0) as b:
        outs = [None] * len(rows)

        def client(k):
            for i in range(k, len(rows), 8):
                outs[i] = b.submit(rows[i]).result(30)

        ts = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        b.drain()
    assert all(o is not None for o in outs)
    assert tthreads.find_cycles() == []
    base = tthreads.load_baseline(BASELINE)
    assert tthreads.check_hierarchy(base) == [], \
        [str(f) for f in tthreads.check_hierarchy(base)]


def test_submit_that_meets_a_drain_rejects_outside_the_admission_lock():
    """A submit that waits on a full queue while a drain closes admission
    is shed as ``draining``, and its rejection (which counts under the
    stats lock) does not nest that lock under the admission lock: the
    graph gains no ``serving.batcher.admit`` edge."""
    from mxnet_tpu_torch.gluon.nn import Dense
    from mxnet_tpu_torch.serving import (CompiledPredictor, DynamicBatcher,
                                         Overloaded)
    torch.manual_seed(0)
    net = torch.nn.Sequential(Dense(8, in_units=4, device="cpu"))
    pred = CompiledPredictor(net, bucket_sizes=(4, 8), device="cpu")
    row = onp.zeros((1, 4), "f4")
    b = DynamicBatcher(pred, max_batch=8, timeout_ms=1.0, depth=1,
                       start=False)
    b.submit(row)                        # fills the one-slot queue
    got = []

    def client():
        try:
            b.submit(row, deadline_ms=0, timeout=30)
        except Overloaded as e:
            got.append(e.reason)

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.05)                     # the client is in its Full loop
    b._close_admission()
    t.join(30)
    assert not t.is_alive()
    assert got == ["draining"]
    assert b.stats["rejected"] == 1
    assert not [e for e in tthreads.graph().edges()
                if e["from"] == "serving.batcher.admit"]
    b.close()
