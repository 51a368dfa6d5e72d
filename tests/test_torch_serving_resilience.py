"""Resilient serving in mxnet_tpu_torch: the JAX package's
``tests/test_serving_resilience.py`` case by case, on the CPU.

- typed failures: DeadlineExceeded / Overloaded(reason) /
  ServingShutdown; an accepted request ends in a result or a typed
  failure, never a hang;
- deadlines: an expired request is dropped at dequeue, never dispatched;
  admission sheds at submit when the EWMA-projected wait exceeds the
  deadline (MXNET_SERVING_SHED=off|deadline|queue), on an injected clock;
- the circuit breaker's transitions; graceful drain; a dead dispatcher
  fails every pending future;
- ServingSupervisor: a device loss rebuilds the predictor over
  ``available_devices()`` and re-enqueues in-flight requests exactly
  once; transient failures retry within a budget; fatal ones propagate;
- the chaos cases: a revoke mid-traffic loses no accepted request.

The devices are the CPU's virtual ones (``MXNET_CPU_DEVICES=4``); a
device loss is a ``revoke`` fault rule. The JAX package's telemetry
series are read here from the port's ``stats``, ``drain_seconds`` and
``CircuitBreaker.transitions``. The served outputs are held against the
JAX package's predictor on the same numpy-seeded weights (float32,
rtol 1e-5 / atol 1e-6: one Dense product's sums in another order). Every
threaded wait is bounded.
"""
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.elastic import detect
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.serving import loadgen
from mxnet_tpu_torch.serving.resilience import CircuitBreaker
from mxnet_tpu_torch.testing import faults

IN, HIDDEN, CLASSES = 16, 32, 4
BUCKETS = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def _clean_harness(monkeypatch):
    """Four virtual CPU devices; the CPU is this thread's default
    device; every test leaves the chaos harness disarmed, devices
    restored and the preemption notice cleared."""
    monkeypatch.setenv("MXNET_CPU_DEVICES", "4")
    monkeypatch.delenv("MXNET_SERVING_SHED", raising=False)
    monkeypatch.delenv("MXNET_SERVING_DEADLINE_MS", raising=False)
    with mxt.cpu():
        yield
    faults.reset()
    detect.notice().clear()


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
    """Deterministic, per the supervisor's build() contract: every
    (re)build gives the same weights, so recovery is bit-exact."""
    return serving.CompiledPredictor(make_net(seed), bucket_sizes=BUCKETS)


def rows(n, in_units=IN, seed=0):
    return torch.from_numpy(onp.random.RandomState(seed).randn(
        n, in_units).astype("float32"))


@pytest.fixture
def pred():
    return build_pred()


def manual_batcher(pred, clk, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("timeout_ms", 5.0)
    return serving.DynamicBatcher(pred, start=False,
                                  clock=lambda: clk[0], **kw)


# ---------------------------------------------------------------------------
# env accessors
# ---------------------------------------------------------------------------

def test_shed_mode_parsing(monkeypatch):
    monkeypatch.delenv("MXNET_SERVING_SHED", raising=False)
    assert serving.shed_mode() == "deadline"          # the default
    for v in ("off", "deadline", "queue"):
        monkeypatch.setenv("MXNET_SERVING_SHED", v)
        assert serving.shed_mode() == v
    monkeypatch.setenv("MXNET_SERVING_SHED", "bogus")
    assert serving.shed_mode() == "deadline"


def test_default_deadline_parsing(monkeypatch):
    monkeypatch.delenv("MXNET_SERVING_DEADLINE_MS", raising=False)
    assert serving.default_deadline_ms() is None
    monkeypatch.setenv("MXNET_SERVING_DEADLINE_MS", "25")
    assert serving.default_deadline_ms() == 25.0
    monkeypatch.setenv("MXNET_SERVING_DEADLINE_MS", "0")
    assert serving.default_deadline_ms() is None
    monkeypatch.setenv("MXNET_SERVING_DEADLINE_MS", "junk")
    assert serving.default_deadline_ms() is None


def test_queue_timeout_parsing(monkeypatch):
    monkeypatch.delenv("MXNET_SERVING_QUEUE_TIMEOUT_MS", raising=False)
    assert serving.queue_timeout_s() == pytest.approx(120.0)
    monkeypatch.setenv("MXNET_SERVING_QUEUE_TIMEOUT_MS", "250")
    assert serving.queue_timeout_s() == pytest.approx(0.25)
    monkeypatch.setenv("MXNET_SERVING_QUEUE_TIMEOUT_MS", "-5")
    assert serving.queue_timeout_s() == 0.0


def test_env_accessors_match_jax(monkeypatch):
    """The port's accessors read the JAX package's variables alike."""
    from mxnet_tpu.serving import batcher as jb
    from mxnet_tpu.serving import resilience as jr
    from mxnet_tpu_torch.serving import batcher as tb
    for env, val in (("MXNET_SERVING_RETRIES", "5"),
                     ("MXNET_SERVING_MAX_BATCH", "12"),
                     ("MXNET_SERVING_BATCH_TIMEOUT_MS", "3.5")):
        monkeypatch.setenv(env, val)
    assert serving.transient_retries() == jr.transient_retries() == 5
    assert tb.max_batch_rows() == jb.max_batch_rows() == 12
    assert tb.batch_timeout_s() == pytest.approx(jb.batch_timeout_s())


# ---------------------------------------------------------------------------
# deadlines: expiry at dequeue (fake clock)
# ---------------------------------------------------------------------------

def test_expired_request_dropped_at_dequeue(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk)
    fut = b.submit(rows(1), deadline_ms=3.0)
    clk[0] = 0.004                        # past the 3 ms deadline
    assert b.process_once(force=True) is False   # nothing dispatched
    with pytest.raises(serving.DeadlineExceeded, match="never dispatched"):
        fut.result(5)
    assert b.stats["batches"] == 0        # never padded/dispatched
    assert b.stats["deadline_missed"] == 1
    b.close()


def test_unexpired_request_dispatches_normally(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk)
    fut = b.submit(rows(1), deadline_ms=50.0)
    clk[0] = 0.006                        # past the batch timeout only
    assert b.process_once() is True
    assert fut.result(10).shape == (1, CLASSES)
    b.close()


def test_deadline_boundary_exact(pred):
    # a request AT its deadline is expired; one a tick under is served
    clk = [0.0]
    b = manual_batcher(pred, clk)
    f_dead = b.submit(rows(1), deadline_ms=10.0)
    clk[0] = 0.010
    assert b.process_once(force=True) is False
    with pytest.raises(serving.DeadlineExceeded):
        f_dead.result(5)
    f_live = b.submit(rows(1), deadline_ms=10.0)
    clk[0] = 0.010 + 0.0099
    assert b.process_once(force=True) is True
    assert f_live.result(10).shape == (1, CLASSES)
    b.close()


def test_env_default_deadline_applies(pred, monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_DEADLINE_MS", "3")
    monkeypatch.setenv("MXNET_SERVING_SHED", "off")
    clk = [0.0]
    b = manual_batcher(pred, clk)
    fut = b.submit(rows(1))               # deadline from env
    clk[0] = 0.004
    assert b.process_once(force=True) is False
    with pytest.raises(serving.DeadlineExceeded):
        fut.result(5)
    # deadline_ms=0 opts a single request out of the env default
    f2 = b.submit(rows(1), deadline_ms=0)
    clk[0] = 60.0
    assert b.process_once(force=True) is True
    assert f2.result(10).shape == (1, CLASSES)
    b.close()


# ---------------------------------------------------------------------------
# admission control / shedding (fake clock, seeded EWMA)
# ---------------------------------------------------------------------------

def test_shed_deadline_rejects_on_projected_wait(pred, monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_SHED", "deadline")
    clk = [0.0]
    b = manual_batcher(pred, clk)
    b._ewma_service = 0.050               # 50 ms per micro-batch
    # 1 waiting batch x 50 ms projected > 20 ms deadline: shed
    with pytest.raises(serving.Overloaded, match="projected queue wait") \
            as ei:
        b.submit(rows(1), deadline_ms=20.0)
    assert ei.value.reason == "deadline"
    assert b.stats["rejected"] == 1
    # same request with budget for one batch: admitted
    fut = b.submit(rows(1), deadline_ms=100.0)
    assert b.process_once(force=True) is True
    assert fut.result(10).shape == (1, CLASSES)
    # no deadline: never shed by projection
    assert b.submit(rows(1)) is not None
    b.flush()
    b.close()


def test_shed_off_admits_regardless_of_projection(pred, monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_SHED", "off")
    clk = [0.0]
    b = manual_batcher(pred, clk)
    b._ewma_service = 10.0                # hopeless projection
    fut = b.submit(rows(1), deadline_ms=5.0)
    assert fut is not None                # admitted anyway (off)
    b.flush()
    b.close()


def test_shed_queue_rejects_without_blocking(pred, monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_SHED", "queue")
    clk = [0.0]
    b = manual_batcher(pred, clk, depth=1)
    b.submit(rows(1))
    t0 = time.perf_counter()
    with pytest.raises(serving.Overloaded, match="saturated") as ei:
        b.submit(rows(1), timeout=30.0)   # timeout ignored
    assert ei.value.reason == "queue"
    assert time.perf_counter() - t0 < 1.0              # no blocking
    b.flush()
    b.close()


def test_queue_full_is_typed_overloaded(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk, depth=1)
    b.submit(rows(1))
    with pytest.raises(serving.Overloaded, match="saturated") as ei:
        b.submit(rows(1), timeout=0.02)
    assert ei.value.reason == "queue"
    assert isinstance(ei.value, MXNetError)            # still an MXNetError
    assert b.stats["rejected"] == 1
    b.flush()
    b.close()


def test_queue_full_waits_for_the_env_timeout(pred, monkeypatch):
    """Without ``timeout=`` a full queue waits
    MXNET_SERVING_QUEUE_TIMEOUT_MS when it is set (the port's default
    without it is not to wait)."""
    monkeypatch.setenv("MXNET_SERVING_QUEUE_TIMEOUT_MS", "50")
    b = manual_batcher(pred, [0.0], depth=1)
    b.submit(rows(1))
    t0 = time.perf_counter()
    with pytest.raises(serving.Overloaded, match="saturated"):
        b.submit(rows(1))
    assert 0.04 <= time.perf_counter() - t0 < 5.0
    b.flush()
    b.close()


def test_estimated_wait_formula(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk)                      # max_batch 4
    assert b.estimated_wait_s(1) is None               # no EWMA yet
    b._ewma_service = 0.010
    # 1 row waiting -> 1 batch, empty window
    assert b.estimated_wait_s(1) == pytest.approx(0.010)
    # 5 rows -> 2 batches
    assert b.estimated_wait_s(5) == pytest.approx(0.020)
    b.close()


def test_ewma_updates_at_retire(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk)
    b.submit(rows(1))
    assert b.process_once(force=True) is True
    clk[0] = 0.030                        # 30 ms of "device time"
    b.flush()                             # retire records service time
    assert b._ewma_service == pytest.approx(0.030)
    b.close()


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def test_breaker_opens_at_threshold():
    clk = [0.0]
    br = CircuitBreaker(failure_threshold=3, clock=lambda: clk[0])
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"           # under threshold
    br.record_failure()
    assert br.state == "open" and not br.allow()


def test_breaker_cooldown_half_open_then_closes():
    clk = [0.0]
    br = CircuitBreaker(failure_threshold=1, cooldown_s=5.0,
                        clock=lambda: clk[0])
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clk[0] = 4.9
    assert not br.allow()                 # cooldown not elapsed
    clk[0] = 5.1
    assert br.allow()                     # the probe
    assert br.state == "half_open"
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_breaker_reopens_on_half_open_failure():
    clk = [0.0]
    br = CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                        clock=lambda: clk[0])
    br.trip("recovery")
    clk[0] = 2.0
    assert br.allow() and br.state == "half_open"
    br.record_failure()                   # probe failed
    assert br.state == "open"
    states = [s for s, _t, _c in br.transitions]
    assert states == ["closed", "open", "half_open", "open"]


def test_breaker_explicit_transitions_and_level():
    """The JAX package's gauge values (0 closed, 1 half-open, 2 open) of
    each state, and the causes of the transitions."""
    br = CircuitBreaker()
    assert CircuitBreaker.LEVEL[br.state] == 0
    br.trip("recovery")
    assert CircuitBreaker.LEVEL[br.state] == 2
    br.half_open()
    assert CircuitBreaker.LEVEL[br.state] == 1
    br.close()
    assert CircuitBreaker.LEVEL[br.state] == 0
    assert [c for _s, _t, c in br.transitions] == [
        "init", "recovery", "recovered", "reset"]


def test_open_breaker_fast_fails_submit(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk)
    b.breaker = CircuitBreaker()
    b.breaker.trip("recovery")
    with pytest.raises(serving.Overloaded, match="circuit breaker") as ei:
        b.submit(rows(1))
    assert ei.value.reason == "breaker"
    assert b._queue.qsize() == 0          # nothing queued behind it
    b.breaker.close()
    assert b.submit(rows(1)) is not None
    b.flush()
    b.close()


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

def test_drain_flushes_accepted_then_rejects_new(pred):
    pred.warmup(rows(1))
    b = serving.DynamicBatcher(pred, max_batch=8, timeout_ms=50.0)
    futs = [b.submit(rows(1, seed=i)) for i in range(5)]
    b.drain()
    for f in futs:                        # accepted requests all land
        assert f.result(30).shape == (1, CLASSES)
    with pytest.raises((serving.Overloaded, serving.ServingShutdown)):
        b.submit(rows(1))
    assert len(b.drain_seconds) == 1      # drain duration recorded
    b.drain()                             # idempotent
    b.close()


def test_drain_manual_mode(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk)
    fut = b.submit(rows(1))
    b.drain()
    assert fut.result(10).shape == (1, CLASSES)
    with pytest.raises(serving.ServingShutdown):
        b.submit(rows(1))


def test_drain_check_preemption_bridge(pred):
    """The supervisor's SIGTERM path: the dispatch loop polls
    drain_check and drains itself."""
    pred.warmup(rows(1), buckets=BUCKETS)
    b = serving.DynamicBatcher(pred, max_batch=8, timeout_ms=1.0)
    want = threading.Event()
    b.drain_check = want.is_set
    futs = [b.submit(rows(1, seed=i)) for i in range(4)]
    want.set()
    deadline = time.time() + 15
    while not b._stop.is_set() and time.time() < deadline:
        time.sleep(0.005)
    assert b._stop.is_set(), "drain_check never initiated the drain"
    for f in futs:
        assert f.result(30).shape == (1, CLASSES)
    with pytest.raises((serving.Overloaded, serving.ServingShutdown)):
        b.submit(rows(1))
    b.close()


# ---------------------------------------------------------------------------
# dispatcher death -> ServingShutdown (the anti-hang regression)
# ---------------------------------------------------------------------------

def test_dispatcher_death_fails_pending_futures(pred):
    b = serving.DynamicBatcher(pred, max_batch=4, timeout_ms=60000.0,
                               start=False)
    f1 = b.submit(rows(1))
    f2 = b.submit(rows(1, seed=1))

    def boom():
        raise RuntimeError("loop machinery bug")

    b._serve_loop_inner = boom
    t = threading.Thread(target=b._serve_loop, daemon=True)
    t.start()
    t.join(10)
    assert not t.is_alive()
    for f in (f1, f2):                    # typed, not a hang
        with pytest.raises(serving.ServingShutdown, match="died"):
            f.result(5)
    with pytest.raises(serving.ServingShutdown, match="died"):
        b.submit(rows(1))
    assert b.stats["shutdown_failed"] == 2


def test_close_with_backlog_never_hangs(pred):
    # close() flushes the backlog; anything undispatchable fails typed
    clk = [0.0]
    b = manual_batcher(pred, clk)
    fut = b.submit(rows(1))
    b.close()                             # flush dispatches the backlog
    assert fut.result(10).shape == (1, CLASSES)


# ---------------------------------------------------------------------------
# ServingSupervisor: classified recovery
# ---------------------------------------------------------------------------

def make_supervisor(example=False, **kw):
    ex = (rows(1),) if example else None
    kw.setdefault("max_batch", 8)
    kw.setdefault("timeout_ms", 1.0)
    return serving.ServingSupervisor(build_pred, example=ex, **kw)


def test_supervisor_serves_plain_traffic():
    X = rows(8, seed=3)
    with make_supervisor() as sup:
        futs = [sup.submit(X[i:i + 1]) for i in range(8)]
        outs = [f.result(30) for f in futs]
    assert all(o.shape == (1, CLASSES) for o in outs)
    assert sup.stats["recoveries"] == 0
    assert sup.breaker.state == "closed"


def test_supervisor_outputs_vs_jax_predictor():
    """The supervised port against the JAX package's CompiledPredictor on
    the same numpy-seeded weights and rows."""
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
    X = rows(6, seed=21)
    with make_supervisor(example=True) as sup:
        futs = [sup.submit(X[i:i + 2]) for i in range(0, 6, 2)]
        got = onp.concatenate([f.result(30).numpy() for f in futs])
    ref = onp.concatenate([jpred.predict(mx.nd.array(
        X[i:i + 2].numpy())).asnumpy() for i in range(0, 6, 2)])
    onp.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def submit_with_retry(sup, x, budget_s=60.0):
    """A real client's posture: an Overloaded rejection (breaker open
    while recovery runs, queue full) is retryable: back off and
    resubmit, within a budget."""
    deadline = time.time() + budget_s
    while True:
        try:
            return sup.submit(x)
        except serving.Overloaded:
            if time.time() >= deadline:
                raise
            time.sleep(0.01)


def test_supervisor_device_loss_recovery_requeues_once():
    X = rows(8, seed=3)
    singles = [build_pred().predict(X[i:i + 1]).numpy() for i in range(8)]
    with make_supervisor() as sup:
        faults.configure("serving.dispatch:before=1:revoke:1")
        futs = [submit_with_retry(sup, X[i:i + 1]) for i in range(8)]
        outs = [f.result(60).numpy() for f in futs]
        assert sup.stats["recoveries"] == 1
        assert sup.stats["requeued"] >= 1     # the revoked batch's riders
        assert sup.stats["failed_requeues"] == 0
        assert sup.last_recovery["cause"] == "device_lost"
        assert sup.last_recovery["downtime_s"] < 60
        assert 3 not in {d.index for d in
                         mxt.parallel.dist.available_devices()}
    # the half-open breaker closes at the first successful retire
    states = [s for s, _t, _c in sup.breaker.transitions]
    assert states == ["closed", "open", "half_open", "closed"]
    for i in range(8):                    # recovery preserves answers
        assert (outs[i] == singles[i]).all()


def test_supervisor_second_loss_fails_typed():
    """Re-enqueue is EXACTLY once: a request lost twice fails with the
    device-loss error instead of looping forever."""
    X = rows(1, seed=5)
    with make_supervisor() as sup:
        faults.configure("serving.dispatch:before=1:revoke:1;"
                         "serving.dispatch:before=2:revoke:1")
        fut = sup.submit(X)
        with pytest.raises(MXNetError, match="repeated device"):
            fut.result(60)
        assert sup.stats["recoveries"] == 2
        assert sup.stats["failed_requeues"] == 1


def test_supervisor_transient_retry_succeeds():
    X = rows(4, seed=7)
    with make_supervisor(backoff_base=0.01) as sup:
        faults.configure("serving.dispatch:before=1:error")
        futs = [sup.submit(X[i:i + 1]) for i in range(4)]
        outs = [f.result(60) for f in futs]
        assert all(o.shape == (1, CLASSES) for o in outs)
        assert sup.stats["retried"] >= 1       # the faulted batch's riders
        assert sup.stats["failed_requeues"] == 0
        assert sup.stats["recoveries"] == 0    # no rebuild for transient


def test_supervisor_transient_budget_exhausted():
    X = rows(1, seed=9)
    with make_supervisor(max_retries=0, backoff_base=0.01) as sup:
        faults.configure("serving.dispatch:before=1:error")
        fut = sup.submit(X)
        with pytest.raises(MXNetError, match="transient"):
            fut.result(60)
        assert sup.stats["failed_requeues"] == 1


def test_supervisor_fatal_propagates():
    # wrong feature width against a proven program: classified fatal,
    # no recovery, the future fails with the dispatch error
    with make_supervisor(example=True) as sup:
        good = sup.submit(rows(1))
        assert good.result(30).shape == (1, CLASSES)
        bad = sup.submit(torch.zeros((1, IN + 3)))
        with pytest.raises(Exception):
            bad.result(30)
        assert sup.stats["recoveries"] == 0
        assert sup.stats["retried"] == 0


def test_supervisor_drain_on_preemption_notice():
    X = rows(4, seed=11)
    sup = make_supervisor()
    try:
        futs = [sup.submit(X[i:i + 1]) for i in range(4)]
        detect.notice().trigger()
        deadline = time.time() + 15
        while not sup.batcher._stop.is_set() and time.time() < deadline:
            time.sleep(0.005)
        assert sup.batcher._stop.is_set(), "preemption never drained"
        for f in futs:                    # accepted requests all land
            assert f.result(30).shape == (1, CLASSES)
        with pytest.raises((serving.Overloaded, serving.ServingShutdown)):
            sup.submit(X[:1])
        assert len(sup.batcher.drain_seconds) == 1
    finally:
        detect.notice().clear()
        sup.close()


def test_fault_point_serving_admit(pred):
    """Faults injected at admission surface on the submitting client's
    thread."""
    clk = [0.0]
    b = manual_batcher(pred, clk)
    faults.configure("serving.admit:before=1:error")
    with pytest.raises(faults.FaultInjectedError):
        b.submit(rows(1))
    faults.configure(None)
    assert b.submit(rows(1)) is not None
    b.flush()
    b.close()


def test_supervisor_builds_on_the_first_surviving_device(monkeypatch):
    """``build()`` runs inside ``with Context(available_devices()[0])``:
    a net built without ``device=`` lands there, and ``with mx.cpu():``
    / ``current_context()`` nest per thread."""
    seen = []

    def build():
        seen.append((mxt.current_context(), mxt.default_device()))
        return build_pred()

    with serving.ServingSupervisor(build, max_batch=8, start=False) as sup:
        assert sup.predictor.device == torch.device("cpu")
    ctx, dev = seen[0]
    assert ctx == mxt.Context("cpu", 0) and dev == torch.device("cpu")
    assert mxt.current_context() == mxt.cpu()      # the fixture's, back


# ---------------------------------------------------------------------------
# loadgen outcome census
# ---------------------------------------------------------------------------

def test_loadgen_outcome_census_closed():
    def issue(i):
        if i % 4 == 0:
            raise serving.Overloaded("shed", reason="queue")
        if i % 4 == 1:
            raise serving.DeadlineExceeded("late")
        if i % 4 == 2:
            raise RuntimeError("boom")

    rep = loadgen.run_closed_loop(issue, concurrency=2, requests=40)
    assert rep["outcomes"] == {"ok": 10, "rejected": 10,
                               "deadline_missed": 10, "error": 10}
    assert rep["issued"] == 40 and rep["requests"] == 10
    assert rep["reject_rate"] == pytest.approx(0.25)
    assert rep["deadline_miss_rate"] == pytest.approx(0.25)
    assert rep["goodput_qps"] is not None
    assert rep["goodput_qps"] <= rep["qps"]


def test_loadgen_slow_completion_counts_as_deadline_missed():
    def issue(i):
        if i % 2:
            time.sleep(0.03)

    rep = loadgen.run_closed_loop(issue, concurrency=1, requests=10,
                                  deadline_s=0.01)
    assert rep["outcomes"]["ok"] == 5
    assert rep["outcomes"]["deadline_missed"] == 5


def test_loadgen_open_loop_counts_submit_rejections():
    def submit(i):
        if i % 2:
            raise serving.Overloaded("shed at admission",
                                     reason="deadline")
        return lambda *_: None

    rep = loadgen.run_open_loop(submit, rate_qps=2000.0, requests=20)
    assert rep["outcomes"]["rejected"] == 10
    assert rep["outcomes"]["ok"] == 10
    assert rep["reject_rate"] == pytest.approx(0.5)


def test_classify_outcome_walks_cause_chain():
    try:
        try:
            raise serving.Overloaded("inner", reason="queue")
        except serving.Overloaded as inner:
            raise MXNetError("wrapped") from inner
    except MXNetError as e:
        assert loadgen.classify_outcome(e) == "rejected"
    assert loadgen.classify_outcome(RuntimeError("x")) == "error"
    assert loadgen.classify_outcome(
        serving.DeadlineExceeded("late")) == "deadline_missed"


def test_open_loop_census_matches_jax_loadgen():
    """The same Poisson schedule and outcomes through both packages'
    open loops: the census and the rates' definitions agree."""
    from mxnet_tpu import serving as jserving
    from mxnet_tpu.serving import loadgen as jloadgen

    def submitter(pkg):
        """Each package's own typed failures."""
        def submit(i):
            if i % 3 == 0:
                raise pkg.Overloaded("shed", reason="deadline")
            if i % 3 == 1:
                def late(*_):
                    raise pkg.DeadlineExceeded("late")
                return late
            return lambda *_: None
        return submit

    got = loadgen.run_open_loop(submitter(serving), rate_qps=3000.0,
                                requests=30, seed=3)
    ref = jloadgen.run_open_loop(submitter(jserving), rate_qps=3000.0,
                                 requests=30, seed=3)
    assert got["outcomes"] == {"ok": 10, "rejected": 10,
                               "deadline_missed": 10, "error": 0}
    assert got["outcomes"] == ref["outcomes"]
    assert got["issued"] == ref["issued"] == 30
    # the JAX package rounds its rates to 4 places; the port does not
    assert got["reject_rate"] == pytest.approx(ref["reject_rate"],
                                               abs=1e-4)


# ---------------------------------------------------------------------------
# chaos: revoke mid-traffic, zero lost accepted requests
# ---------------------------------------------------------------------------

def test_chaos_revoke_mid_traffic_zero_lost(monkeypatch):
    """Concurrent traffic across a revoke -> recover -> restore cycle:
    every accepted request ends in exactly one of {result, typed
    failure} with zero hangs, exactly one recovery with bounded
    downtime, and results bit-exact against single dispatch after it."""
    N = 32
    X = rows(N, seed=13)
    singles = [build_pred().predict(X[i:i + 1]).numpy() for i in range(N)]
    monkeypatch.setenv("MXNET_SERVING_SHED", "off")
    results = [None] * N
    errors = [None] * N
    with make_supervisor(example=True, timeout_ms=2.0) as sup:
        faults.configure("serving.dispatch:before=2:revoke:1")

        def client(i):
            try:
                results[i] = submit_with_retry(
                    sup, X[i:i + 1]).result(60)
            except MXNetError as e:
                errors[i] = e

        threads = [threading.Thread(target=client, args=(i,),
                                    daemon=True) for i in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(90)
        hung = [i for i, t in enumerate(threads) if t.is_alive()]
        assert not hung, f"clients hung: {hung}"
        assert sup.stats["recoveries"] == 1
        assert sup.stats["recovery_downtime_s"] < 60
        faults.restore_devices()           # the world grows back
        late = sup.submit(X[:1])
        assert late.result(30) is not None
    for i in range(N):
        assert (results[i] is None) != (errors[i] is None), \
            f"request {i} has no terminal state"
        assert errors[i] is None, \
            f"request {i}: terminal failure {errors[i]!r}"
    for i in range(N):                     # bit-exact incl. post-recovery
        assert (results[i].numpy() == singles[i]).all(), \
            f"request {i} differs from single dispatch post-recovery"


def test_chaos_revoke_at_retire_seam():
    """A device loss surfacing at the window retire (not at dispatch)
    recovers alike: the in-flight riders re-enqueue and resolve."""
    N = 8
    X = rows(N, seed=17)
    with make_supervisor(timeout_ms=1.0, inflight=2) as sup:
        faults.configure("serving.retire:before=1:revoke:1")
        futs = []
        for i in range(N):
            try:
                futs.append(sup.submit(X[i:i + 1]))
            except serving.Overloaded:
                futs.append(None)          # shed while breaker open
        outs = []
        for f in futs:
            if f is None:
                continue
            try:
                outs.append(f.result(60))
            except serving.Overloaded:
                pass
        deadline = time.time() + 30
        while sup.stats["recoveries"] < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert sup.stats["recoveries"] == 1
        assert outs, "no request survived the retire-seam revocation"
        assert all(o.shape == (1, CLASSES) for o in outs)


def test_context_scopes_nest_per_thread():
    """``with ctx:`` sets the calling thread's default device, nests, and
    is not seen by another thread (as the JAX package's Context); the
    CPU's name and equality are MXNet's."""
    import mxnet_tpu as mx
    assert mxt.current_context() == mxt.cpu()      # the fixture's
    with mxt.cpu_pinned():
        assert mxt.default_device() == torch.device("cpu")
        assert str(mxt.current_context()) == str(mx.cpu_pinned()) == \
            "cpu_pinned(0)"
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            mxt.current_context()))
        t.start()
        t.join(10)
        assert seen == [None]
    assert mxt.current_context() == mxt.cpu()
    assert mxt.resolve_device(mxt.cpu()) == torch.device("cpu")
    assert mxt.cpu(0) == mxt.Context("cpu", 0) != mxt.cpu_pinned(0)
    if not torch.cuda.is_available():
        assert mxt.num_gpus() == 0
        with pytest.raises(MXNetError, match="no CUDA device"):
            mxt.gpu(0)
