"""Elastic training of the port (``mxnet_tpu_torch.elastic``), against
the JAX package's ``tests/test_elastic.py`` where its tests apply.

Covers: device-loss classification (the CUDA, NCCL and gloo texts of a
lost card or rank, chained exceptions, a child process's traceback),
exactly one ``device_lost`` record per failure; the ``revoke`` /
``restore`` fault actions, their once-a-run rule state shared between
processes, and the surviving world (``parallel.dist.
available_devices`` / ``world_changed``); the dispatch window's
``abandon`` / ``drain_partial`` and its ``window.retire`` fault points;
``TrainLoop``'s interrupt path; preemption notices, the grace-window
save and a SIGTERM to a supervised process; and the supervisor: in
process (a transient failure recovered bit for bit against an
uninterrupted run restored at the same step, the retry budget and its
reset, ``MXNET_ELASTIC=0``, fatal errors, nothing continued on the CPU
when the cards are gone) and across four gloo ranks (revoked to two,
bit for bit against an uninterrupted dp-2 restore and within 1e-5, the
tolerance of ``test_torch_checkpoint.py``'s cross-loads, of the JAX
package's ``TrainLoop`` restoring the same checkpoint; grown back to
four by a ``restore``; a killed rank propagating; a preemption stopping
every rank at one step). JAX is imported inside the tests: the ranks
import this module for their functions.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import elastic
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import TrainCheckpointManager
from mxnet_tpu_torch.elastic import detect
from mxnet_tpu_torch.engine import DispatchWindow
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import TrainLoop
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.parallel import make_mesh as tmake_mesh
from mxnet_tpu_torch.testing import faults
from mxnet_tpu_torch.testing.faults import (DeviceRevokedError,
                                            FaultInjectedError)

SPAWN_TIMEOUT_S = 90
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _clean_elastic(monkeypatch):
    monkeypatch.delenv(faults.STATE_ENV_VAR, raising=False)
    monkeypatch.setenv("MXNET_CPU_DEVICES", "4")
    faults.reset()
    detect.notice().clear()
    detect.reset_anomalies()
    yield
    faults.reset()
    detect.notice().clear()
    detect.reset_anomalies()


# ---------------------------------------------------------------- helpers
# (module level: the ranks of a formation unpickle them)
def _weights(seed=3):
    r = onp.random.RandomState(seed)
    return {"0.weight": (r.randn(8, 4) * 0.5).astype("f4"),
            "0.bias": (r.randn(8) * 0.1).astype("f4"),
            "1.weight": (r.randn(3, 8) * 0.5).astype("f4"),
            "1.bias": (r.randn(3) * 0.1).astype("f4")}


def _net():
    net = torch.nn.Sequential(
        Dense(8, in_units=4, activation="relu", device="cpu"),
        Dense(3, in_units=8, device="cpu"))
    load_jax_params(net, _weights())
    return net


def _build_opt(opt):
    net = _net()
    hp = {"learning_rate": 0.05}
    if opt == "sgd":
        hp["momentum"] = 0.9
    trainer = TTrainer(dict(net.named_parameters()), opt, hp)
    return net, trainer, tloss.SoftmaxCrossEntropyLoss()


def _build():
    return _build_opt("adam")


def _build_sgd():
    return _build_opt("sgd")


def _batch(i, bs=8):
    rng = onp.random.RandomState(1000 + i)
    return (rng.randn(bs, 4).astype("f4"),
            rng.randint(0, 3, size=(bs,)).astype("f4"))


def _slow_batch(i):
    time.sleep(0.05)
    return _batch(i)


def _batch_preempt_at_3(i):
    if i == 3:
        detect.notice().trigger()
    return _batch(i)


def _fresh_log():
    return elastic.RecoveryLog()


# ================================================================ detection
CUDA_LOST = [
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "CUDA error: no CUDA-capable device is detected",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: uncorrectable NVLink error detected during the execution",
    "NVRM: Xid 79, GPU has fallen off the bus.",
    "Unable to determine the device handle for GPU0000:1A:00.0: GPU is lost",
    "CUDA error: device lost: device 3 removed from the system",
]
RANK_LOST = [
    "NCCL error in: ProcessGroupNCCL.cpp:1970, remote process exited or "
    "there was a network error, NCCL version 2.21.5",
    "[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection "
    "closed by peer [127.0.0.1]:54321",
    "Connection reset by peer",
]
NOT_LOST = [
    "CUDA error: an illegal memory access was encountered",
    "shape mismatch",
    "CUDA out of memory. Tried to allocate 2.00 GiB",
]


@pytest.mark.parametrize("msg", CUDA_LOST + RANK_LOST)
def test_device_and_rank_loss_texts(msg):
    assert detect.is_device_lost(RuntimeError(msg))
    assert detect.classify(RuntimeError(msg)) == "device_lost"
    assert detect.is_rank_lost(RuntimeError(msg)) == (msg in RANK_LOST)


@pytest.mark.parametrize("msg", NOT_LOST)
def test_program_failures_are_not_device_loss(msg):
    assert not detect.is_device_lost(RuntimeError(msg))
    assert not detect.is_device_lost(ValueError(msg))


def test_is_device_lost_walks_the_chain():
    inner = DeviceRevokedError("CUDA error: device lost: device 3")
    outer = MXNetError("async TrainLoop step 5 failed (deferred error)")
    outer.__cause__ = inner
    assert detect.is_device_lost(outer)
    assert detect.classify(outer) == "device_lost"


def test_classify_taxonomy():
    assert detect.classify(DeviceRevokedError("device lost: x")) \
        == "device_lost"
    assert detect.classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "oom"
    assert detect.classify(RuntimeError("CUDA out of memory.")) == "oom"
    assert detect.classify(FaultInjectedError("disk blip")) == "transient"
    assert detect.classify(OSError("connection refused")) == "transient"
    assert detect.classify(ValueError("bad shape")) == "fatal"
    assert detect.classify(elastic.StallEscalation("3 stalls")) == "stall"


def test_classify_reads_a_child_processes_traceback():
    """A rank's exception reaches the parent as its traceback's text
    (``torch.multiprocessing``'s ``ProcessRaisedException``): the cause
    the rank named decides, and ``DeviceRevokedError`` is recognised by
    name."""
    from torch.multiprocessing import ProcessRaisedException
    tb = ("Traceback (most recent call last):\n  ...\n"
          "mxnet_tpu_torch.testing.faults.DeviceRevokedError: injected\n")
    assert detect.classify(ProcessRaisedException(tb, 1, 123)) \
        == "device_lost"
    tb = ("mxnet_tpu_torch.base.MXNetError: elastic formation rank 1 "
          "failed at step 5: FaultInjectedError: injected IO failure "
          "[elastic cause: transient]\n")
    assert detect.classify(ProcessRaisedException(tb, 1, 123)) \
        == "transient"


def test_device_lost_recorded_exactly_once_across_seams():
    e = DeviceRevokedError("CUDA error: device lost: device 3")
    assert detect.maybe_record_device_lost(e, "inner seam", step=4)
    wrapped = MXNetError("async step 4 failed")
    wrapped.__cause__ = e
    assert not detect.maybe_record_device_lost(wrapped, "outer seam")
    assert not detect.maybe_record_device_lost(e, "third seam")
    evs = detect.anomalies("device_lost")
    assert len(evs) == 1 and evs[0]["step"] == 4
    assert "inner seam" in evs[0]["message"]
    assert e._mx_anomaly is evs[0]


def test_non_device_errors_not_recorded():
    assert not detect.maybe_record_device_lost(ValueError("nope"), "seam")
    assert detect.anomalies("device_lost") == []


def test_device_lost_guard_propagates_and_records():
    with pytest.raises(DeviceRevokedError):
        with detect.device_lost_guard("guarded seam", step=7):
            raise DeviceRevokedError("device lost: y")
    assert len(detect.anomalies("device_lost")) == 1


def test_a_step_records_a_device_loss_at_its_dispatch():
    net, trainer, lb = _build()
    step = trainer.compile_step(lambda a, b: lb(net(a), b))
    faults.configure("step.dispatch@dp1:before=2:revoke")
    step(*_batch(0))
    with pytest.raises(DeviceRevokedError, match="device lost"):
        step(*_batch(1))
    evs = detect.anomalies("device_lost")
    assert len(evs) == 1 and evs[0]["seam"] == "CompiledTrainStep.step"
    assert step.steps_done == 1


# ================================================================ faults
def test_revoke_grammar():
    rules = faults.configure("step.dispatch:before=6:revoke:4")
    assert rules[0].action == "revoke" and rules[0].count == 4
    rules = faults.configure("p:after=1:revoke")
    assert rules[0].count == 1
    rules = faults.configure("p:before=1:revoke:d1+d3")
    assert rules[0].device_ids == (1, 3)
    rules = faults.configure("p@dp2:before=2:restore")
    assert rules[0].action == "restore" and rules[0].ctx == "dp2"
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.configure("p:before=1:explode")
    with pytest.raises(ValueError, match="revoke target"):
        faults.configure("p:before=1:revoke:d1+x2")


def test_revoke_shrinks_the_world_and_restore_grows_it_back():
    n0 = len(tdist.available_devices("cpu"))
    assert n0 == 4
    faults.configure("p:before=1:revoke:2;q:before=1:restore")
    with pytest.raises(DeviceRevokedError, match="device lost"):
        faults.fault_point("p")
    assert faults.revoked_device_ids() == {2, 3}
    assert [d.index for d in tdist.available_devices("cpu")] == [0, 1]
    assert tdist.world_changed(list(range(4)))
    faults.fault_point("q")                 # restore: does not raise
    assert len(tdist.available_devices("cpu")) == n0
    assert not tdist.world_changed(tdist.available_devices("cpu"))


def test_revoke_named_devices_and_never_the_last():
    faults.configure("p:before=1:revoke:d0+d2")
    with pytest.raises(DeviceRevokedError):
        faults.fault_point("p")
    assert faults.revoked_device_ids() == {0, 2}
    faults.configure("p:before=1:revoke:9999")
    with pytest.raises(DeviceRevokedError):
        faults.fault_point("p")
    assert len(tdist.available_devices("cpu")) == 1


def test_reset_restores_revoked_devices():
    faults.configure("p:before=1:revoke:1")
    with pytest.raises(DeviceRevokedError):
        faults.fault_point("p")
    assert faults.revoked_device_ids()
    faults.reset()
    assert not faults.revoked_device_ids()


def test_shared_state_fires_a_rule_once_across_processes(tmp_path,
                                                         monkeypatch):
    """With ``MXNET_FAULT_STATE`` two processes (here: the same rules
    configured twice, as a new formation's process parses them again
    with fresh hit counts) fire a rule once, and both see the devices
    it revoked."""
    monkeypatch.setenv(faults.STATE_ENV_VAR, str(tmp_path / "state.json"))
    spec = "step.dispatch:before=2:revoke:2"
    faults.configure(spec)
    faults.fault_point("step.dispatch")
    with pytest.raises(DeviceRevokedError):
        faults.fault_point("step.dispatch")
    faults.configure(spec)                  # the next process
    for _ in range(4):
        faults.fault_point("step.dispatch")   # hit 2 again: no refire
    assert faults.revoked_device_ids() == {2, 3}
    state = json.loads((tmp_path / "state.json").read_text())
    assert state["revoked"] == [2, 3] and len(state["fired"]) == 1


# ================================================================ dist
def test_available_devices_asks_afresh(monkeypatch):
    assert [d.index for d in tdist.available_devices("cpu")] == [0, 1, 2, 3]
    monkeypatch.setenv("MXNET_CPU_DEVICES", "3")   # the world shrank
    assert [d.index for d in tdist.available_devices("cpu")] == [0, 1, 2]
    assert tdist.world_changed([0, 1, 2, 3])
    assert not tdist.world_changed([torch.device("cpu", i)
                                    for i in range(3)])


def test_available_cuda_devices_without_a_card_is_empty():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tdist.available_devices("cuda") == []


# ================================================================ window
def test_window_abandon_discards_without_sync():
    synced = []
    w = DispatchWindow(synced.append, max_inflight=5)
    for i in range(3):
        w.push(onp.zeros(2), tag=i + 1)
    assert w.abandon() == [1, 2, 3]
    assert len(w) == 0 and synced == []
    assert w.stats["abandoned"] == 3


def test_window_drain_partial_discards_after_first_failure():
    def sync(p):
        if p == "bad":
            raise RuntimeError("CUDA error: device lost: gone mid-flight")

    w = DispatchWindow(sync, max_inflight=5)
    for tag, p in ((1, "ok"), (2, "bad"), (3, "late")):
        w.push(p, tag=tag)
    retired, discarded = w.drain_partial()
    assert retired == 1 and discarded == [3] and len(w) == 0
    # the deferred device loss was recorded at the retire seam
    assert len(detect.anomalies("device_lost")) == 1


def test_window_drain_partial_clean():
    w = DispatchWindow(lambda p: p, max_inflight=5)
    w.push("a", tag=1)
    w.push("b", tag=2)
    assert w.drain_partial() == (2, [])


def test_window_retire_fault_points():
    faults.configure("window.retire:before=2:error")
    w = DispatchWindow(lambda p: p, max_inflight=0)
    w.push("a", tag=1)
    with pytest.raises(FaultInjectedError, match="window.retire"):
        w.push("b", tag=2)
    assert faults.hit_counts()[("window.retire", "after")] == 1


# ================================================================ interrupt
def test_interrupt_drains_window_and_writes_final_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    net, trainer, lb = _build()
    loop = TrainLoop(net, trainer, lb, checkpoint_dir=d, inflight=4)
    for i in range(3):
        loop.step(*_batch(i))
    assert loop.engine_stats()["pending"] == 3

    def boom(*a, **k):
        raise KeyboardInterrupt

    loop._step = boom
    with pytest.raises(KeyboardInterrupt):
        loop.step(*_batch(3))
    assert loop.engine_stats()["pending"] == 0
    assert loop.engine_stats()["retires"] == 3
    assert TrainCheckpointManager(d).latest_step() == 3


def test_interrupt_propagates_earliest_faulted_step_error(tmp_path):
    d = str(tmp_path / "ck")
    net, trainer, lb = _build()
    loop = TrainLoop(net, trainer, lb, checkpoint_dir=d, inflight=4)
    for i in range(3):
        loop.step(*_batch(i))
    faults.configure("window.retire:before=1:error")

    def boom(*a, **k):
        raise KeyboardInterrupt

    loop._step = boom
    with pytest.raises(FaultInjectedError):
        loop.step(*_batch(3))
    assert loop.engine_stats()["pending"] == 0
    assert TrainCheckpointManager(d).latest_step() == 3


def test_discard_inflight_without_retiring():
    net, trainer, lb = _build()
    loop = TrainLoop(net, trainer, lb, inflight=4)
    for i in range(3):
        loop.step(*_batch(i))
    assert loop.discard_inflight(retire=False) == (0, [1, 2, 3])
    assert loop.engine_stats()["retires"] == 0


# ================================================================ preemption
def test_preemption_notice_trigger_and_grace(monkeypatch):
    n = detect.notice()
    assert not n.requested()
    monkeypatch.setenv("MXNET_PREEMPTION_GRACE_SEC", "45")
    assert detect.preemption_grace_sec() == 45
    assert n.remaining_grace() == 45
    n.trigger()
    assert n.requested() and n.remaining_grace() <= 45
    scoped = detect.notice("replica-1")
    assert scoped.requested()             # the global notice concerns all
    n.clear()
    assert not n.requested() and not scoped.requested()
    detect.clear_scoped_notices()


def test_supervisor_graceful_preemption(tmp_path):
    d = str(tmp_path / "ck")
    sup = elastic.ElasticSupervisor(
        _build, d, mesh_axes=None, checkpoint_every=None,
        backoff_base=0.0, log=_fresh_log(), device="cpu")
    res = sup.run(_batch_preempt_at_3, 10)
    assert res.preempted
    # the notice lands during step 4's batch; the check before the next
    # step saves at step 4
    assert res.final_step == 4
    assert TrainCheckpointManager(d).latest_step() == 4
    assert [e["cause"] for e in res.events] == ["preemption"]


def _sigterm_worker(ckpt_dir):
    """A supervised run that steps slowly until a SIGTERM; prints READY
    once steps flow, then RESULT with what the run did."""
    import logging
    logging.basicConfig(level=logging.ERROR)

    def batch_fn(i):
        if i == 2:
            print("READY", flush=True)
        time.sleep(0.05)
        return _batch(i)

    sup = elastic.ElasticSupervisor(
        _build, ckpt_dir, mesh_axes=None, checkpoint_every=None,
        backoff_base=0.0, log=_fresh_log(), device="cpu")
    res = sup.run(batch_fn, 100000)
    print("RESULT " + json.dumps({
        "preempted": res.preempted, "final_step": res.final_step,
        "causes": [e["cause"] for e in res.events],
        "latest_checkpoint": TrainCheckpointManager(ckpt_dir).latest_step(),
    }), flush=True)


def test_sigterm_grace_window_save(tmp_path):
    """SIGTERM to a supervised process: the notice, the window drained,
    the final checkpoint at the step the run stopped on, a clean exit."""
    d = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.path.dirname(
        HERE) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop(faults.ENV_VAR, None)
    p = subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_elastic as T; T._sigterm_worker({d!r})"],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        lines = []
        deadline = time.time() + 60
        while time.time() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("READY"):
                break
        assert lines and lines[-1].startswith("READY"), "".join(lines)
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, err[-3000:]
    res = [json.loads(line[7:]) for line in out.splitlines()
           if line.startswith("RESULT ")][0]
    assert res["preempted"] and res["causes"] == ["preemption"]
    assert res["latest_checkpoint"] == res["final_step"] > 2


# ================================================================ in-process supervisor
def _restored_reference(build, d, restored, total, dp=None):
    """A fresh build restoring checkpoint ``restored`` and running the
    same steps uninterrupted: the summed loss of each."""
    net, trainer, lb = build()
    TrainCheckpointManager(d, keep_last=99).restore_step(
        restored, trainer=trainer, net=net)
    loop = TrainLoop(net, trainer, lb)
    handles = {i: loop.step(*_batch(i)) for i in range(restored, total)}
    loop.synchronize()
    return {i: float(h.detach().double().sum()) for i, h in handles.items()}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_in_process_transient_recovery_bit_exact(tmp_path, opt):
    """A transient failure at step 6's dispatch: one event (restored
    step 4, failed at step 5) and the losses after it bit for bit those
    of an uninterrupted run restored from the same checkpoint."""
    d = str(tmp_path / "ck")
    build = _build if opt == "adam" else _build_sgd
    faults.configure("step.dispatch:before=6:error")
    sup = elastic.ElasticSupervisor(
        build, d, mesh_axes=None, checkpoint_every=2, keep_last=99,
        backoff_base=0.0, log=_fresh_log(), device="cpu")
    res = sup.run(_batch, 8)
    faults.reset()
    assert res.final_step == 8 and len(res.events) == 1
    ev = res.events[0]
    assert ev["cause"] == "transient"
    assert ev["restored_step"] == 4 and ev["step"] == 5
    assert ev["old_dp"] == ev["new_dp"] == 1 and ev["downtime_s"] >= 0
    assert sorted(res.losses) == list(range(8))
    ref = _restored_reference(build, d, 4, 8)
    for i in range(4, 8):
        assert res.losses[i] == ref[i], f"step {i} diverged"


def test_window_retire_seam_recovers(tmp_path):
    faults.configure("window.retire:before=5:error")
    sup = elastic.ElasticSupervisor(
        _build, str(tmp_path / "ck"), mesh_axes=None, checkpoint_every=2,
        backoff_base=0.0, log=_fresh_log(), device="cpu")
    res = sup.run(_batch, 8)
    assert res.final_step == 8
    assert [e["cause"] for e in res.events] == ["transient"]


def test_retry_budget_exhausted(tmp_path):
    faults.configure(";".join(
        f"step.dispatch:before={n}:error" for n in range(1, 6)))
    sup = elastic.ElasticSupervisor(
        _build, str(tmp_path / "ck"), mesh_axes=None, max_retries=2,
        backoff_base=0.0, log=_fresh_log(), device="cpu")
    with pytest.raises(MXNetError, match="recovery budget exhausted"):
        sup.run(_batch, 8)


def test_forward_progress_resets_retry_budget(tmp_path):
    faults.configure("step.dispatch:before=3:error;"
                     "step.dispatch:before=7:error;"
                     "step.dispatch:before=10:error")
    sup = elastic.ElasticSupervisor(
        _build, str(tmp_path / "ck"), mesh_axes=None, checkpoint_every=1,
        max_retries=1, backoff_base=0.0, log=_fresh_log(), device="cpu")
    res = sup.run(_batch, 8)
    assert res.final_step == 8 and res.recoveries == 3


def test_recovery_disabled_propagates(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_ELASTIC", "0")
    faults.configure("step.dispatch:before=3:error")
    log = _fresh_log()
    sup = elastic.ElasticSupervisor(_build, str(tmp_path / "ck"),
                                    mesh_axes=None, backoff_base=0.0,
                                    log=log, device="cpu")
    with pytest.raises(FaultInjectedError):
        sup.run(_batch, 8)
    assert len(log) == 0


def test_fatal_errors_propagate(tmp_path):
    def batch_fn(i):
        if i == 2:
            raise ValueError("a real bug, not the hardware")
        return _batch(i)

    sup = elastic.ElasticSupervisor(_build, str(tmp_path / "ck"),
                                    mesh_axes=None, backoff_base=0.0,
                                    log=_fresh_log(), device="cpu")
    with pytest.raises(ValueError, match="real bug"):
        sup.run(batch_fn, 8)


def test_stall_escalation_is_not_ported(tmp_path):
    """Stall escalation is ported now (the telemetry watchdog came with
    it): ``stall_escalation`` builds, and a ``StallEscalation`` at a step
    boundary is classified ``stall`` and recovered like a lost device,
    resuming from the newest checkpoint (``tests/test_torch_telemetry.py``
    drives it from the watchdog's stall episodes)."""
    elastic.ElasticSupervisor(_build, str(tmp_path / "ck0"),
                              stall_escalation=2, device="cpu")
    raised = []

    def batch_fn(i):
        if i == 2 and not raised:
            raised.append(i)
            raise elastic.StallEscalation("3 stall episodes")
        return _batch(i)

    sup = elastic.ElasticSupervisor(_build, str(tmp_path / "ck"),
                                    mesh_axes=None, backoff_base=0.0,
                                    log=_fresh_log(), device="cpu")
    res = sup.run(batch_fn, 8)
    assert res.final_step == 8 and raised == [2]
    assert [e["cause"] for e in res.events] == ["stall"]


def test_nothing_continues_on_the_cpu_without_cards(tmp_path):
    """The default world is the cards: with none (or fewer than
    ``min_devices``) the supervisor raises instead of training
    elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sup = elastic.ElasticSupervisor(_build, str(tmp_path / "ck"),
                                    mesh_axes=None, log=_fresh_log())
    with pytest.raises(MXNetError, match="0 cuda device"):
        sup.run(_batch, 4)
    sup = elastic.ElasticSupervisor(_build, str(tmp_path / "ck2"),
                                    mesh_axes={"dp": -1}, min_devices=5,
                                    log=_fresh_log(), device="cpu")
    with pytest.raises(MXNetError, match="below min_devices=5"):
        sup.run(_batch, 4)


# ================================================================ log, gates
def test_recovery_log_schema():
    log = _fresh_log()
    evt = log.record(cause="device_lost", lost_devices=["cuda:3"],
                     old_dp=4, new_dp=2, restored_step=40,
                     downtime_s=1.25, discarded_steps=2, step=42)
    assert set(evt) == {"cause", "lost_devices", "old_dp", "new_dp",
                        "restored_step", "discarded_steps", "downtime_s",
                        "step", "time_unix"}
    assert len(log) == 1 and log.events("device_lost") == [evt]
    assert log.events("grow") == []
    assert log.world_size == 2 and log.counts == {"device_lost": 1}
    assert "4->2" in log.table().replace(" ", "")
    log.clear()
    assert len(log) == 0 and log.table() == "(no recovery events)"
    assert isinstance(elastic.recovery_log(), elastic.RecoveryLog)


def test_env_gates(monkeypatch):
    monkeypatch.delenv("MXNET_ELASTIC", raising=False)
    assert detect.elastic_enabled() and not detect.armed()
    monkeypatch.setenv("MXNET_ELASTIC", "1")
    assert detect.elastic_enabled() and detect.armed()
    monkeypatch.setenv("MXNET_ELASTIC", "off")
    assert not detect.elastic_enabled() and not detect.armed()
    monkeypatch.setenv("MXNET_ELASTIC_MAX_RETRIES", "7")
    assert detect.max_retries() == 7
    monkeypatch.setenv("MXNET_ELASTIC_MAX_RETRIES", "bogus")
    assert detect.max_retries() == 3


# ================================================================ four gloo ranks
def _dp_reference_rank(d, restored, total):
    """One rank of an uninterrupted run at this world, restored from
    checkpoint ``restored``: rank 0's summed losses."""
    torch.set_num_threads(1)
    with tmake_mesh({"dp": tdist.size()}):
        losses = _restored_reference(_build, d, restored, total)
    return losses if tdist.rank() == 0 else None


def _jax_restored_losses(d, restored, total, dp):
    """The JAX package's TrainLoop at dp ``dp`` (the 8-device virtual
    CPU mesh) restoring the port's checkpoint ``restored``."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.checkpoint import TrainCheckpointManager as JMgr
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import TrainLoop as JTrainLoop
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    net = jnn.HybridSequential()
    net.add(jnn.Dense(8, in_units=4, activation="relu"))
    net.add(jnn.Dense(3, in_units=8))
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(_weights()[k]))
    trainer = JTrainer(net.collect_params(), "adam", {"learning_rate": 0.05})
    with jmake_mesh({"dp": dp}, jax.devices()[:dp]):
        JMgr(d, keep_last=99).restore_step(restored, trainer=trainer,
                                           net=net)
        loop = JTrainLoop(net, trainer, jloss.SoftmaxCrossEntropyLoss())
        handles = {i: loop.step(*(mx.nd.array(a) for a in _batch(i)))
                   for i in range(restored, total)}
        loop.synchronize()
        assert loop.compiled_step.zero_sharded
    return {i: float(onp.asarray(h.asnumpy(), "f8").sum())
            for i, h in handles.items()}


def test_four_ranks_revoked_to_two_bit_exact(tmp_path):
    """dp 4 on four gloo ranks; a revocation of two devices at step 6's
    dispatch (fired on whichever rank gets there first, ONCE in the run:
    the dp-2 formation dispatches six times again without refiring).
    Exactly one ``device_lost`` event (dp 4 -> 2, restored step 4,
    failed at step 5), the run finishes, and the losses after the
    recovery are bit for bit an uninterrupted dp-2 run restored from the
    same checkpoint, and within 1e-5 of the JAX package's TrainLoop
    restoring it at dp 2."""
    d = str(tmp_path / "ck")
    total = 10
    faults.configure("step.dispatch:before=6:revoke:2")
    log = _fresh_log()
    sup = elastic.ElasticSupervisor(
        _build, d, mesh_axes={"dp": -1}, checkpoint_every=2, keep_last=99,
        backoff_base=0.0, log=log, device="cpu",
        formation_timeout_s=SPAWN_TIMEOUT_S)
    res = sup.run(_batch, total)
    faults.reset()
    assert res.final_step == total and res.world_size == 2
    assert len(res.events) == 1
    ev = res.events[0]
    assert ev["cause"] == "device_lost"
    assert (ev["old_dp"], ev["new_dp"], ev["restored_step"], ev["step"]) \
        == (4, 2, 4, 5)
    assert ev["lost_devices"] == ["cpu:2", "cpu:3"]
    assert ev["downtime_s"] > 0
    assert len(detect.anomalies("device_lost")) == 1
    assert sorted(res.losses) == list(range(total))
    (ref, _) = tdist.spawn(_dp_reference_rank, 2, "cpu", (d, 4, total),
                           timeout_s=SPAWN_TIMEOUT_S)
    for i in range(4, total):
        assert res.losses[i] == ref[i], f"step {i} diverged"
    jax_ref = _jax_restored_losses(d, 4, total, 2)
    for i in range(4, total):
        onp.testing.assert_allclose(res.losses[i], jax_ref[i], atol=1e-5,
                                    err_msg=f"step {i}")


def test_four_ranks_grow_back_after_a_restore(tmp_path):
    """Revoked to dp 2 at step 3's dispatch, restored at the dp-2
    formation's second dispatch (``@dp2``): at the next step boundary
    every rank agrees the world grew, checkpoints there and the run
    re-forms at dp 4 (cause ``grow``, nothing discarded)."""
    faults.configure("step.dispatch:before=3:revoke:2;"
                     "step.dispatch@dp2:before=2:restore")
    sup = elastic.ElasticSupervisor(
        _build, str(tmp_path / "ck"), mesh_axes={"dp": -1},
        checkpoint_every=2, backoff_base=0.0, log=_fresh_log(),
        device="cpu", formation_timeout_s=SPAWN_TIMEOUT_S)
    res = sup.run(_batch, 8)
    assert res.final_step == 8 and res.world_size == 4
    causes = [(e["cause"], e["old_dp"], e["new_dp"]) for e in res.events]
    assert causes == [("device_lost", 4, 2), ("grow", 2, 4)]
    grow = res.events[1]
    assert grow["discarded_steps"] == 0
    assert grow["restored_step"] == grow["step"] == 4
    assert sorted(res.losses) == list(range(8))


def test_a_killed_rank_is_not_recovered(tmp_path):
    """A rank that dies with no exception of its own (SIGKILL) ends the
    formation; the others saw only their peer go: nothing is the cause,
    so the failure propagates and no event is recorded."""
    faults.configure("step.dispatch:before=3:kill")
    log = _fresh_log()
    sup = elastic.ElasticSupervisor(
        _build, str(tmp_path / "ck"), mesh_axes={"dp": -1},
        checkpoint_every=2, backoff_base=0.0, log=log, device="cpu",
        formation_timeout_s=SPAWN_TIMEOUT_S)
    with pytest.raises(Exception) as info:
        sup.run(_batch, 6)
    assert "did not finish within" not in str(info.value)
    assert len(log) == 0


def test_four_ranks_stop_together_on_a_preemption(tmp_path):
    """The notice, raised on the ranks during step 4's batch: at the
    next boundary every rank stops, the grace-window checkpoint lands at
    step 4, and the run ends preempted."""
    d = str(tmp_path / "ck")
    sup = elastic.ElasticSupervisor(
        _build, d, mesh_axes={"dp": -1}, checkpoint_every=None,
        backoff_base=0.0, log=_fresh_log(), device="cpu",
        formation_timeout_s=SPAWN_TIMEOUT_S)
    res = sup.run(_batch_preempt_at_3, 10)
    assert res.preempted and res.final_step == 4
    assert [e["cause"] for e in res.events] == ["preemption"]
    assert TrainCheckpointManager(d).latest_step() == 4
    assert sorted(res.losses) == list(range(4))


def test_the_supervisors_notice_reaches_every_rank(tmp_path):
    """A preemption notice raised in the supervisor's process (what its
    SIGTERM handler does) reaches the ranks of the running formation:
    they stop together at one step boundary, checkpoint there, and the
    run ends preempted."""
    import threading
    d = str(tmp_path / "ck")
    sup = elastic.ElasticSupervisor(
        _build, d, mesh_axes={"dp": -1}, checkpoint_every=None,
        backoff_base=0.0, log=_fresh_log(), device="cpu",
        formation_timeout_s=SPAWN_TIMEOUT_S)
    timer = threading.Timer(3.0, detect.notice().trigger)
    timer.start()
    try:
        res = sup.run(_slow_batch, 10000)
    finally:
        timer.cancel()
    assert res.preempted and res.final_step < 10000
    assert [e["cause"] for e in res.events] == ["preemption"]
    assert TrainCheckpointManager(d).latest_step() == res.final_step
