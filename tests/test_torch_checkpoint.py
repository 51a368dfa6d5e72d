"""Persistence of mxnet_tpu_torch, and cross-loading with the JAX package.

The port's own stack first, as the JAX package's ``tests/
test_checkpoint.py`` tests its own: the atomic checksummed format
(staged temp dir, CRC manifest, one ``os.replace`` commit, the
``latest`` pointer, fallback past corrupt checkpoints), the fault
grammar, the whole train state captured and restored in the eager,
``compile_step`` and four-rank gloo ZeRO modes (losses bit-exact after
resume; dp 4 -> dp 2 within the JAX test's rel 1e-5), background writes,
``TrainLoop`` resume and pruning, and subprocess kill -9 runs killed at
each commit boundary that resume bit-exactly.

Then the two packages against each other on the same numpy-seeded
weights and batches: a checkpoint written by either restores into the
other and training continues within the port-vs-JAX tolerances of
``tests/test_torch_train.py`` (1e-5 in float32 for one update rule on a
small model) and ``tests/test_torch_zero.py`` (losses atol 1e-5 across
ranks); both writers give the same array names (the RNG keys excepted:
the JAX package keeps ``rng/key``, the port ``rng/torch/...``), shapes,
logical dtypes, meta keys and manifest fields; ``ndarray.save`` files,
parameter files and ``Updater.get_states`` pickles load both ways.

JAX is imported inside the tests: the spawned ranks and the kill -9
worker import this module and need only torch.
"""
import argparse
import json
import logging
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import (
    CheckpointCorruptError, TrainCheckpointManager, apply_train_state,
    assemble_segments, atomic_write_bytes, capture_train_state,
    latest_valid, list_checkpoints, load_latest, prune_checkpoints,
    read_checkpoint, write_checkpoint)
from mxnet_tpu_torch.checkpoint.atomic import host_array, step_dir_name, \
    to_tensor
from mxnet_tpu_torch.gluon import (TrainLoop, Trainer, load_dict,
                                   load_parameters, save_parameters)
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.nn import Dense, Dropout
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.parallel import make_mesh
from mxnet_tpu_torch.testing import faults
from mxnet_tpu_torch.testing.faults import FaultInjectedError

HERE = os.path.dirname(os.path.abspath(__file__))
SPAWN_TIMEOUT_S = 120
#: port vs JAX, float32, one small model (tests/test_torch_train.py)
TOL = 1e-5
DP = 4


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


# ---------------------------------------------------------------- helpers
SHAPES = {"0.weight": (8, 4), "0.bias": (8,), "1.weight": (5, 8),
          "1.bias": (5,), "2.weight": (3, 5), "2.bias": (3,)}

OPTS = {"sgd": ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
        "adam": ("adam", {"learning_rate": 0.05})}


def _weights(seed=3):
    """The JAX checkpoint test's MLP (4 -> 8 -> 5 -> 3), numpy-seeded."""
    r = onp.random.RandomState(seed)
    return {k: (r.randn(*s) * 0.5).astype("f4") for k, s in SHAPES.items()}


def _build(seed=3, dtype=None):
    net = torch.nn.Sequential(
        Dense(8, in_units=4, activation="relu", device="cpu"),
        Dense(5, in_units=8, activation="relu", device="cpu"),
        Dense(3, in_units=5, device="cpu"))
    load_jax_params(net, _weights(seed))
    return net.to(dtype) if dtype is not None else net


def _trainer(net, opt, **extra):
    name, hp = OPTS[opt]
    return Trainer(dict(net.named_parameters()), name, dict(hp, **extra))


def _batch(i, bs=8):
    rng = onp.random.RandomState(1000 + i)
    return (rng.randn(bs, 4).astype("f4"),
            rng.randint(0, 3, size=(bs,)).astype("f4"))


def _tbatch(i):
    return tuple(torch.from_numpy(a) for a in _batch(i))


def _np(loss):
    return loss.detach().float().numpy().copy()


def _train_run(mode, opt, n_steps, ckpt_dir=None, save_at=(), resume=False,
               async_save=False):
    """One deterministic run: {step index: per-sample loss}. ``mode``
    eager (``loss.backward`` + ``trainer.step``), fused
    (``compile_step``) or zero (``compile_step`` under the active dp
    mesh: call it in every rank)."""
    net = _build()
    trainer = _trainer(net, opt)
    lb = tloss.SoftmaxCrossEntropyLoss()
    mgr = TrainCheckpointManager(ckpt_dir, keep_last=3,
                                 async_save=async_save) if ckpt_dir else None
    start = 0
    if mgr and resume and mgr.has_checkpoint():
        start = int(mgr.restore_latest(trainer=trainer, net=net)["step"])
    step = None if mode == "eager" else \
        trainer.compile_step(lambda a, b: lb(net(a), b))
    losses = {}
    for i in range(start, n_steps):
        x, y = _tbatch(i)
        if step is None:
            loss = lb(net(x), y)
            loss.backward(torch.ones_like(loss))
            trainer.step(8)
        else:
            loss = step(x, y)
        losses[i] = _np(loss)
        if mgr and (i + 1) in save_at:
            mgr.save(i + 1, trainer=trainer, net=net)
    if mgr:
        mgr.wait()
    if mode == "zero":
        assert step.zero_sharded
    return losses


def _same(a, b):
    assert sorted(a) == sorted(b)
    for i in a:
        onp.testing.assert_array_equal(a[i], b[i], err_msg=f"step {i}")


# ================================================================ atomic IO
def test_write_read_roundtrip(tmp_path):
    root = str(tmp_path / "ck")
    bf = torch.tensor([1.5, -2.25, 3e-3, 7.0], dtype=torch.bfloat16)
    bits, logical = host_array(bf)
    assert logical == "bfloat16" and bits.dtype == onp.uint16
    arrays = {"a": onp.arange(6, dtype=onp.float32).reshape(2, 3),
              "b/nested": onp.array([1, 2], dtype=onp.int64), "c": bits}
    path = write_checkpoint(root, 7, arrays, meta={"note": "hi"},
                            array_meta={"c": {"dtype": "bfloat16"}})
    assert os.path.basename(path) == step_dir_name(7)
    got, manifest = read_checkpoint(path)
    assert manifest["step"] == 7 and manifest["meta"]["note"] == "hi"
    assert sorted(got) == sorted(arrays)
    assert got["a"].dtype == onp.float32
    assert (got["a"] == arrays["a"]).all()
    entry = manifest["arrays"]["c"]
    assert entry["dtype"] == "bfloat16" and got["c"].dtype == onp.uint16
    assert sorted(entry) == ["crc32", "dtype", "file", "nbytes", "shape"]
    assert torch.equal(to_tensor(got["c"], entry["dtype"]), bf)
    step, arrays2, _ = load_latest(root)
    assert step == 7 and (arrays2["b/nested"] == arrays["b/nested"]).all()


def test_corrupt_manifest_falls_back_to_older(tmp_path, caplog):
    root = str(tmp_path / "ck")
    write_checkpoint(root, 1, {"a": onp.zeros(3)})
    write_checkpoint(root, 2, {"a": onp.ones(3)})
    with open(os.path.join(root, step_dir_name(2), "manifest.json"),
              "w") as f:
        f.write("{not json")
    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.checkpoint"):
        step, arrays, _ = load_latest(root)
    assert step == 1 and (arrays["a"] == 0).all()
    assert any("corrupt" in r.message for r in caplog.records)


def test_truncated_array_fails_crc_and_falls_back(tmp_path):
    root = str(tmp_path / "ck")
    write_checkpoint(root, 1, {"a": onp.zeros(64)})
    write_checkpoint(root, 2, {"a": onp.ones(64)})
    target = os.path.join(root, step_dir_name(2), "arrays", "0.npy")
    raw = open(target, "rb").read()
    with open(target, "wb") as f:
        f.write(raw[:len(raw) // 2])     # a torn write after the commit
    with pytest.raises(CheckpointCorruptError, match="checksum|missing"):
        read_checkpoint(os.path.join(root, step_dir_name(2)))
    step, _, _ = load_latest(root)
    assert step == 1


def test_stale_latest_pointer_falls_back_to_scan(tmp_path):
    root = str(tmp_path / "ck")
    write_checkpoint(root, 3, {"a": onp.arange(4)})
    with open(os.path.join(root, "latest"), "w") as f:
        f.write(step_dir_name(9) + "\n")      # points at nothing
    assert latest_valid(root)[0] == 3


def test_prune_keeps_newest(tmp_path):
    root = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        write_checkpoint(root, s, {"a": onp.full(2, s)})
    prune_checkpoints(root, keep_last=2)
    assert list_checkpoints(root) == [3, 4]
    os.makedirs(os.path.join(root, ".tmp-step-junk"))
    prune_checkpoints(root, keep_last=2)
    assert not any(n.startswith(".tmp-") for n in os.listdir(root))


def test_commit_crash_leaves_no_partial_visible(tmp_path):
    root = str(tmp_path / "ck")
    write_checkpoint(root, 1, {"a": onp.zeros(8)})
    faults.configure("checkpoint.commit:before=1:error")
    with pytest.raises(FaultInjectedError):
        write_checkpoint(root, 2, {"a": onp.ones(8)})
    faults.reset()
    assert list_checkpoints(root) == [1]
    assert latest_valid(root)[0] == 1
    assert not any(n.startswith(".tmp-") for n in os.listdir(root))


def test_nd_save_atomic_keeps_old_file_on_crash(tmp_path):
    fname = str(tmp_path / "arrs")
    tnd.save(fname, {"w": torch.tensor([1.0, 2.0])})
    faults.configure("ndarray.save:before=1:error")
    with pytest.raises(FaultInjectedError):
        tnd.save(fname, {"w": torch.tensor([9.0, 9.0, 9.0])})
    faults.reset()
    assert tnd.load(fname, device="cpu")["w"].tolist() == [1.0, 2.0]
    assert not [n for n in os.listdir(str(tmp_path)) if ".tmp-" in n]


def test_atomic_write_bytes_replaces_whole(tmp_path):
    f = str(tmp_path / "blob")
    atomic_write_bytes(f, b"one")
    atomic_write_bytes(f, b"two-longer")
    assert open(f, "rb").read() == b"two-longer"


# ================================================================ faults
def test_fault_spec_parsing_and_counts():
    rules = faults.configure(
        "checkpoint.commit:after=1;x.y:before=3:error;z:before=1:delay:5")
    assert [r.action for r in rules] == ["kill", "error", "delay"]
    assert rules[2].delay_ms == 5
    faults.fault_point("x.y", "before")
    faults.fault_point("x.y", "before")
    with pytest.raises(FaultInjectedError):
        faults.fault_point("x.y", "before")  # the 3rd fires
    faults.fault_point("x.y", "before")     # a fired rule stays quiet
    assert faults.hit_counts()[("x.y", "before")] == 4


def test_fault_bad_spec_rejected():
    with pytest.raises(ValueError):
        faults.configure("nonsense")
    with pytest.raises(ValueError):
        faults.configure("p:during=1")
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.configure("p:before=1:explode")
    # the elastic supervisor's device-loss actions parse since it is
    # ported (tests/test_torch_elastic.py exercises them)
    rules = faults.configure("step.dispatch:before=6:revoke:4;"
                             "window.retire:before=3:restore")
    assert [(r.action, r.count) for r in rules] == [("revoke", 4),
                                                    ("restore", 1)]


def test_fault_delay_sleeps(monkeypatch):
    slept = []
    import time as _t
    monkeypatch.setattr(_t, "sleep", lambda s: slept.append(s))
    faults.configure("p:before=1:delay:250")
    faults.fault_point("p", "before")
    assert slept == [0.25]


def test_fault_ctx_rule_fires_at_its_context_only():
    faults.configure("p@b:before=2:error")
    faults.fault_point("p", "before", ctx="a")
    faults.fault_point("p", "before", ctx="b")
    faults.fault_point("p", "before", ctx="a")   # 2nd hit of p, 1st of b
    with pytest.raises(FaultInjectedError):
        faults.fault_point("p", "before", ctx="b")
    assert faults.hit_counts()[("p", "before", "a")] == 2


def test_fault_env_var_arms_rules(monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_INJECT", "q:after=1:error")
    faults.reset()
    faults.fault_point("q", "before")
    with pytest.raises(FaultInjectedError):
        faults.fault_point("q", "after")


def test_assemble_segments_roundtrip():
    full = onp.arange(12, dtype=onp.float32).reshape(6, 2)
    arrays = {"x#seg0": full[:3], "x#seg3": full[3:], "y": onp.ones(2)}
    meta = {"x#seg0": {"seg_of": "x", "dim0_start": 0,
                       "global_shape": [6, 2]},
            "x#seg3": {"seg_of": "x", "dim0_start": 3,
                       "global_shape": [6, 2]}}
    out = assemble_segments(arrays, meta)
    assert (out["x"] == full).all() and (out["y"] == 1).all()
    with pytest.raises(MXNetError, match="gap|incomplete"):
        assemble_segments({"x#seg3": full[3:]}, {"x#seg3": meta["x#seg3"]})


# ================================================================ TrainState
@pytest.mark.parametrize("mode", ["eager", "fused"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_resume_bit_exact(tmp_path, mode, opt):
    """Save at step 3 of 6, restore into a FRESH net, trainer and step,
    go on: the losses equal the uninterrupted run's bit for bit."""
    base = _train_run(mode, opt, 6)
    d = str(tmp_path / "ck")
    first = _train_run(mode, opt, 3, ckpt_dir=d, save_at={3})
    _same(first, {i: base[i] for i in range(3)})
    resumed = _train_run(mode, opt, 6, ckpt_dir=d, resume=True)
    _same(resumed, {i: base[i] for i in range(3, 6)})


def test_capture_copies_live_parameters():
    """A capture is a copy: updating the parameters in place after it
    does not change the captured arrays (a background write would
    otherwise serialize memory the next steps are changing)."""
    net = _build()
    trainer = _trainer(net, "sgd")
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = trainer.compile_step(lambda a, b: lb(net(a), b))
    step(*_tbatch(0))
    state = capture_train_state(trainer=trainer, net=net, step=1)
    before = {k: v.copy() for k, v in state.arrays.items()}
    step(*_tbatch(1))
    for k, v in state.arrays.items():
        onp.testing.assert_array_equal(v, before[k], err_msg=k)
    assert not onp.array_equal(state.arrays["param/0.weight"],
                               net[0].weight.detach().numpy())


def _mp_run(n_steps, ckpt_dir=None, save_at=(), resume=False):
    """bf16 MLP, Adam with multi_precision, eager: (losses, masters)."""
    net = _build(dtype=torch.bfloat16)
    trainer = _trainer(net, "adam", multi_precision=True)
    mgr = TrainCheckpointManager(ckpt_dir, async_save=False) \
        if ckpt_dir else None
    start = 0
    if mgr and resume:
        start = int(mgr.restore_latest(trainer=trainer, net=net)["step"])
    step = trainer.compile_step(lambda a: (net(a).float() ** 2).mean())
    x = torch.from_numpy(_batch(0)[0]).to(torch.bfloat16)
    losses = {}
    for i in range(start, n_steps):
        losses[i] = _np(step(x, batch_size=8))
        if mgr and i + 1 in save_at:
            mgr.save(i + 1, trainer=trainer, net=net)
    masters = {i: s[1].clone() for i, s in trainer._updater.states.items()}
    return losses, masters


def test_eager_multi_precision_masters_roundtrip(tmp_path):
    """bf16 weights with float32 masters (the Updater's ``(state,
    master)``): the checkpoint holds uint16 bf16 parameters and the
    master as each state's last leaf, and the resume is bit-exact."""
    base, base_masters = _mp_run(6)
    d = str(tmp_path / "ck")
    _mp_run(3, ckpt_dir=d, save_at={3})
    arrays, manifest = read_checkpoint(latest_valid(d)[1])
    assert manifest["arrays"]["param/0.weight"]["dtype"] == "bfloat16"
    assert arrays["param/0.weight"].dtype == onp.uint16
    assert [manifest["arrays"][f"opt/0/{i}"]["dtype"] for i in range(3)] \
        == ["float32"] * 3
    resumed, masters = _mp_run(6, ckpt_dir=d, resume=True)
    _same(resumed, {i: base[i] for i in range(3, 6)})
    for i, m in masters.items():
        assert torch.equal(m, base_masters[i])


def test_state_includes_rng_and_scheduler():
    from mxnet_tpu_torch import lr_scheduler
    g = torch.Generator().manual_seed(11)
    net = torch.nn.Sequential(Dense(4, in_units=4, device="cpu"),
                              Dropout(0.5, generator=g),
                              Dropout(0.5, generator=g))
    sched = lr_scheduler.FactorScheduler(step=2, factor=0.5, base_lr=0.1)
    trainer = Trainer(dict(net.named_parameters()), "sgd",
                      {"learning_rate": 0.1, "lr_scheduler": sched})
    state = capture_train_state(trainer=trainer, net=net, step=5)
    rng_keys = sorted(k for k in state.arrays if k.startswith("rng/"))
    assert rng_keys == ["rng/torch/default", "rng/torch/module/1"]
    assert state.meta["lr_scheduler"]["base_lr"] == pytest.approx(0.1)
    want = net(torch.ones(64, 4))
    want_default = torch.rand(3)
    sched.base_lr = 0.7
    torch.manual_seed(123456)
    g.manual_seed(99)
    apply_train_state(state, trainer=trainer, net=net)
    assert sched.base_lr == pytest.approx(0.1)
    assert torch.equal(net(torch.ones(64, 4)), want)
    assert torch.equal(torch.rand(3), want_default)


def test_apply_refuses_a_mismatched_checkpoint():
    net = _build()
    trainer = _trainer(net, "sgd")
    state = capture_train_state(trainer=trainer, net=net, step=1)
    state.arrays["param/0.weight"] = onp.zeros((2, 2), onp.float32)
    with pytest.raises(MXNetError, match="shape"):
        apply_train_state(state, trainer=trainer, net=net)
    del state.arrays["param/0.weight"]
    with pytest.raises(MXNetError, match="no data"):
        apply_train_state(state, trainer=trainer, net=net)
    apply_train_state(state, trainer=trainer, net=net, strict=False)


# ================================================================ TrainLoop
def _loop_run(tmp_dir, n_steps, every=2, async_ckpt=True, keep_last=2,
              loss=None):
    net = _build()
    trainer = _trainer(net, "adam")
    loop = TrainLoop(net, trainer, loss or tloss.SoftmaxCrossEntropyLoss(),
                     checkpoint_dir=tmp_dir, checkpoint_every=every,
                     keep_last=keep_last, async_checkpoint=async_ckpt)
    losses = {}
    for i in range(loop.global_step, n_steps):
        losses[i] = _np(loop.step(*_tbatch(i)))
    loop.wait()
    return loop, losses


def test_trainloop_autoresume_bit_exact(tmp_path):
    d = str(tmp_path / "ck")
    base = _train_run("fused", "adam", 6)
    loop1, first = _loop_run(d, 4)
    _same(first, {i: base[i] for i in range(4)})
    assert loop1.checkpoint_manager.latest_step() == 4
    loop2, resumed = _loop_run(d, 6)
    assert loop2.global_step == 6
    assert loop2.checkpoint_manager.restore_provenance["step"] == 4
    _same(resumed, {i: base[i] for i in range(4, 6)})


def test_trainloop_prunes_to_keep_last(tmp_path):
    d = str(tmp_path / "ck")
    _loop_run(d, 8, every=2, keep_last=2)
    assert list_checkpoints(d) == [6, 8]


def test_restore_step_rolls_back_to_a_retained_checkpoint(tmp_path):
    """``restore_step`` applies one named retained checkpoint (not the
    newest), and raises for one that is gone."""
    d = str(tmp_path / "ck")
    _loop_run(d, 6, every=2, keep_last=3)
    base = _train_run("fused", "adam", 6)
    net = _build()
    trainer = _trainer(net, "adam")
    mgr = TrainCheckpointManager(d)
    assert mgr.latest_step() == 6
    assert mgr.restore_step(2, trainer=trainer, net=net)["step"] == 2
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = trainer.compile_step(lambda a, b: lb(net(a), b))
    _same({i: _np(step(*_tbatch(i))) for i in range(2, 6)},
          {i: base[i] for i in range(2, 6)})
    with pytest.raises(CheckpointCorruptError):
        mgr.restore_step(1, trainer=trainer, net=net)


def test_async_checkpoint_does_not_change_results(tmp_path):
    da, ds = str(tmp_path / "a"), str(tmp_path / "s")
    _, la = _loop_run(da, 5, async_ckpt=True)
    _, ls = _loop_run(ds, 5, async_ckpt=False)
    _same(la, ls)
    sa, ss = load_latest(da), load_latest(ds)
    assert sa[0] == ss[0] == 4
    assert sorted(sa[1]) == sorted(ss[1])
    for k in sa[1]:
        if k.startswith("rng/"):
            continue       # the process's generator, advanced in between
        onp.testing.assert_array_equal(sa[1][k], ss[1][k], err_msg=k)


def test_async_write_error_propagates(tmp_path):
    d = str(tmp_path / "ck")
    net = _build()
    trainer = _trainer(net, "sgd")
    mgr = TrainCheckpointManager(d, async_save=True)
    faults.configure("checkpoint.stage:before=1:error")
    mgr.save(1, trainer=trainer, net=net)       # fails on the writer
    with pytest.raises(MXNetError, match="background checkpoint"):
        mgr.wait()
    faults.reset()
    mgr.save(2, trainer=trainer, net=net, block=True)
    assert mgr.latest_step() == 2 and mgr.stats["errors"] == 1


def test_trainloop_without_dir_rejects_manual_save():
    net = _build()
    loop = TrainLoop(net, _trainer(net, "sgd"),
                     tloss.SoftmaxCrossEntropyLoss())
    with pytest.raises(MXNetError, match="checkpoint_dir"):
        loop.save_checkpoint()


def test_trainloop_interrupt_leaves_a_final_checkpoint(tmp_path):
    """A KeyboardInterrupt in the third step: the window drains, a final
    checkpoint of step 2 is written, and a new loop resumes from it
    bit-exactly."""
    d = str(tmp_path / "ck")
    base = _train_run("fused", "adam", 5)
    inner = tloss.SoftmaxCrossEntropyLoss()
    calls = []

    def flaky(out, label):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return inner(out, label)

    with pytest.raises(KeyboardInterrupt):
        _loop_run(d, 5, every=100, loss=flaky)
    assert latest_valid(d)[0] == 2
    loop, resumed = _loop_run(d, 5, every=100)
    _same(resumed, {i: base[i] for i in range(2, 5)})


# ================================================================ Trainer API
def test_save_states_and_load_states_dir_shim(tmp_path):
    """The single-file updater pickle (written atomically) and, through
    ``load_states``, a checkpoint directory."""
    net = _build()
    trainer = _trainer(net, "sgd")
    lb = tloss.SoftmaxCrossEntropyLoss()
    for i in range(2):
        loss = lb(net(_tbatch(i)[0]), _tbatch(i)[1])
        loss.backward(torch.ones_like(loss))
        trainer.step(8)
    fname = str(tmp_path / "trainer.states")
    trainer.save_states(fname)
    trainer2 = _trainer(_build(), "sgd")
    trainer2.load_states(fname)
    assert trainer2._optimizer.num_update == trainer._optimizer.num_update
    state = capture_train_state(trainer=trainer, net=net, step=2)
    path = write_checkpoint(str(tmp_path / "ck"), 2, state.arrays,
                            array_meta=state.array_meta, meta=state.meta)
    for tr in (trainer2, _trainer(_build(), "sgd")):
        if tr is not trainer2:
            tr.load_states(path)
        st = capture_train_state(trainer=tr, step=2)
        assert tr._optimizer.num_update == trainer._optimizer.num_update
        opt_keys = [k for k in state.arrays if k.startswith("opt/")]
        assert opt_keys and sorted(opt_keys) == sorted(
            k for k in st.arrays if k.startswith("opt/"))
        for k in opt_keys:
            onp.testing.assert_array_equal(st.arrays[k], state.arrays[k])


def test_trainer_train_state_convenience():
    net = _build()
    trainer = _trainer(net, "sgd")
    st = trainer.train_state(step=4, net=net, extra={"epoch": 3})
    assert st.step == 4 and any(k.startswith("param/") for k in st.arrays)
    assert int(st.arrays["extra/epoch"]) == 3
    assert trainer.load_train_state(st, net=net)["step"] == 4


# ================================================================ parameters
def test_save_load_parameters_checks_and_in_place(tmp_path):
    f = str(tmp_path / "net.params")
    src = _build(seed=5)
    save_parameters(src, f)
    dst = _build()
    ptrs = [p.data_ptr() for p in dst.parameters()]
    load_parameters(dst, f)
    assert [p.data_ptr() for p in dst.parameters()] == ptrs
    for (k, a), (_, b) in zip(src.named_parameters(),
                              dst.named_parameters()):
        assert torch.equal(a, b), k
    bigger = torch.nn.Sequential(*dst, Dense(2, in_units=3, device="cpu"))
    with pytest.raises(MXNetError, match="missing"):
        load_parameters(bigger, f)
    load_parameters(bigger, f, allow_missing=True)
    with pytest.raises(MXNetError, match="extra"):
        load_parameters(torch.nn.Sequential(dst[0]), f)
    load_parameters(torch.nn.Sequential(dst[0]), f, ignore_extra=True)
    half = _build(dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match="cast_dtype"):
        load_parameters(half, f)
    load_parameters(half, f, cast_dtype=True)
    assert half[0].weight.dtype == torch.bfloat16
    assert torch.equal(half[0].weight, src[0].weight.to(torch.bfloat16))
    load_parameters(half, f, cast_dtype=True, dtype_source="saved")
    assert half[0].weight.dtype == torch.float32
    load_dict(dst, {"arg:" + k: torch.zeros_like(v)
                    for k, v in dst.named_parameters()})
    assert all((p == 0).all() for p in dst.parameters())


def test_warm_predictor_reads_loaded_parameters(tmp_path):
    """``load_parameters`` into the net of a warmed ``CompiledPredictor``:
    its replies equal the eager net on the loaded weights, and nothing is
    captured again (the load writes in place)."""
    from mxnet_tpu_torch.serving import CompiledPredictor
    f = str(tmp_path / "net.params")
    save_parameters(_build(seed=9), f)
    net = _build()
    pred = CompiledPredictor(net, bucket_sizes=(2, 4), device="cpu")
    pred.warmup(torch.from_numpy(_batch(0)[0][:1]))
    n0 = pred.n_traces
    x = torch.from_numpy(_batch(1)[0][:4])
    old = pred.predict(x).clone()
    load_parameters(net, f)
    got = pred.predict(x)
    with torch.no_grad():
        want = net(x)
    assert torch.equal(got, want) and not torch.equal(got, old)
    assert pred.n_traces == n0


# ================================================================ ZeRO
def _zero_rank(root):
    """Every rank of a dp world: per optimizer, an uninterrupted 6-step
    ZeRO run, a 3-step run that saves at 3, a resume in fresh objects;
    a restore into a live plan mid-run; save_states under ZeRO; then
    bf16 + multi_precision with float32 master shards."""
    from mxnet_tpu_torch.gluon import fused_step as tfs
    out = {}
    with make_mesh({"dp": tdist.size()}):
        for opt in ("sgd", "adam"):
            d = os.path.join(root, opt)
            base = _train_run("zero", opt, 6)
            first = _train_run("zero", opt, 3, ckpt_dir=d, save_at={3})
            resumed = _train_run("zero", opt, 6, ckpt_dir=d, resume=True)
            out[opt] = (base, first, resumed)

        net = _build()
        trainer = _trainer(net, "adam")
        lb = tloss.SoftmaxCrossEntropyLoss()
        step = trainer.compile_step(lambda a, b: lb(net(a), b))
        for i in range(3):
            step(*_tbatch(i))
        state = capture_train_state(trainer=trainer, net=net, step=3)
        want = [_np(step(*_tbatch(i))) for i in range(3, 6)]
        for i in range(6, 8):
            step(*_tbatch(i))
        plan_states = [s for st in step.zero_plan.states for s in st]
        apply_train_state(state, trainer=trainer, net=net)
        got = [_np(step(*_tbatch(i))) for i in range(3, 6)]
        out["live"] = (want, got, all(
            a is b for a, b in zip(plan_states, [
                s for st in step.zero_plan.states for s in st])))
        try:
            trainer.save_states(os.path.join(root, f"st{tdist.rank()}"))
            out["save_states_raised"] = None
        except MXNetError as e:
            out["save_states_raised"] = str(e)

        # every bf16 parameter a unit of its own with a float32 master
        os.environ["MXNET_ZERO_SHARD_MIN_SIZE"] = "1"
        d = os.path.join(root, "mp")

        def run_mp(n_pre, n_post, ckpt=False):
            net = _build(dtype=torch.bfloat16)
            trainer = _trainer(net, "adam", multi_precision=True)
            step = trainer.compile_step(lambda a: (net(a).float() ** 2)
                                        .mean())
            mgr = TrainCheckpointManager(d, async_save=False) \
                if ckpt else None
            start = 0
            if mgr and mgr.has_checkpoint():
                start = mgr.restore_latest(trainer=trainer, net=net)["step"]
            x = torch.from_numpy(_batch(0)[0]).to(torch.bfloat16)
            losses = []
            for i in range(start, n_pre + n_post):
                losses.append(_np(step(x, batch_size=8)))
                if mgr and i + 1 == n_pre:
                    mgr.save(i + 1, trainer=trainer, net=net)
            plan = step.zero_plan
            assert step.zero_sharded and plan.masters
            assert isinstance(plan, tfs._ZeroShardPlan)
            return losses, {k: m.clone() for k, m in plan.masters.items()}

        base, base_m = run_mp(3, 3)
        run_mp(3, 0, ckpt=True)
        resumed, res_m = run_mp(3, 3, ckpt=True)
        out["mp"] = (base[3:], resumed, all(torch.equal(base_m[k], res_m[k])
                                            for k in base_m))
        del os.environ["MXNET_ZERO_SHARD_MIN_SIZE"]
    return out


def _resume_rank(d, opt, n_steps):
    """Every rank: resume from ``d`` under the dp mesh of this world and
    train to ``n_steps``; the losses and the restore provenance."""
    with make_mesh({"dp": tdist.size()}):
        net = _build()
        trainer = _trainer(net, opt)
        lb = tloss.SoftmaxCrossEntropyLoss()
        mgr = TrainCheckpointManager(d, async_save=False)
        start = int(mgr.restore_latest(trainer=trainer, net=net)["step"])
        step = trainer.compile_step(lambda a, b: lb(net(a), b))
        losses = {i: _np(step(*_tbatch(i))) for i in range(start, n_steps)}
        assert step.zero_sharded
        return losses, mgr.restore_provenance


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zero_ck"))
    ranks = tdist.spawn(_zero_rank, DP, "cpu", (root,),
                        timeout_s=SPAWN_TIMEOUT_S)
    return root, ranks


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_zero_resume_bit_exact_four_ranks(zero_runs, opt):
    """Four gloo ranks, ZeRO: the capture gathers the shards, rank 0
    writes, a fresh trainer and step resume and reproduce the
    uninterrupted run bit for bit on every rank."""
    root, ranks = zero_runs
    for base, first, resumed in (r[opt] for r in ranks):
        _same(first, {i: base[i] for i in range(3)})
        _same(resumed, {i: base[i] for i in range(3, 6)})
    arrays, manifest = read_checkpoint(
        os.path.join(root, opt, step_dir_name(3)))
    assert manifest["meta"]["opt_mode"] == "zero"
    assert manifest["meta"]["dp_size"] == DP
    n_leaves = 1 if opt == "sgd" else 2
    assert sorted(k for k in arrays if k.startswith("opt/")) == sorted(
        f"opt/{j}/{li}" for j in range(6) for li in range(n_leaves))
    names = sorted(SHAPES)
    for j, name in enumerate(names):
        assert arrays[f"opt/{j}/0"].shape == SHAPES[name]


def test_zero_reshard_dp4_to_dp2(zero_runs):
    """A dp 4 checkpoint resumes on a dp 2 world: the layout-free states
    are padded and sharded again (the JAX test's rel 1e-5: the gradient
    sums over 2 ranks in another order)."""
    root, ranks = zero_runs
    base = ranks[0]["adam"][0]
    out = tdist.spawn(_resume_rank, 2, "cpu",
                      (os.path.join(root, "adam"), "adam", 6),
                      timeout_s=SPAWN_TIMEOUT_S)
    for losses, prov in out:
        assert sorted(losses) == [3, 4, 5]
        assert prov["reshard"] == "dp4->dp2"
        for i in range(3, 6):
            onp.testing.assert_allclose(losses[i], base[i], rtol=1e-5)


def test_zero_restore_into_live_plan(zero_runs):
    """Restore INTO a live plan (mid-run): its shards are refilled in
    place and training continues bit-exactly."""
    _, ranks = zero_runs
    for r in ranks:
        want, got, same_tensors = r["live"]
        assert same_tensors
        for a, b in zip(want, got):
            onp.testing.assert_array_equal(a, b)


def test_save_states_raises_when_zero_owns_state(zero_runs):
    _, ranks = zero_runs
    for r in ranks:
        assert r["save_states_raised"] and "ZeRO-sharded" in \
            r["save_states_raised"]


def test_zero_multi_precision_masters_roundtrip(zero_runs):
    """bf16 + multi_precision under ZeRO: the float32 master shards are
    captured and restored exactly (not cast again from the bf16
    weights); the resumed losses are bit-exact."""
    _, ranks = zero_runs
    for r in ranks:
        base, resumed, masters_equal = r["mp"]
        assert masters_equal
        for a, b in zip(base, resumed):
            onp.testing.assert_array_equal(a, b)


# ================================================================ kill -9
def crash_worker(argv):
    """A training process for the kill -9 tests: a TrainLoop with
    checkpoints every ``--every`` steps; one ``<step> <loss>`` line per
    step appended to ``out_file`` once the step is done, so a killed run
    leaves a truncated but readable log. The caller arms
    ``MXNET_FAULT_INJECT``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir")
    ap.add_argument("out_file")
    ap.add_argument("--opt", choices=sorted(OPTS), default="sgd")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--sync", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    net = _build()
    loop = TrainLoop(net, _trainer(net, args.opt),
                     tloss.SoftmaxCrossEntropyLoss(),
                     checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=args.every, keep_last=args.keep,
                     async_checkpoint=not args.sync)
    for i in range(loop.global_step, args.steps):
        loss = loop.step(*_tbatch(i))
        with open(args.out_file, "a") as f:
            f.write(f"{i} {_np(loss).tobytes().hex()}\n")
            f.flush()
            os.fsync(f.fileno())
    loop.wait()
    return 0


def _run_worker(ckpt_dir, out, opt, fault=None, sync=True, keep=3):
    env = dict(os.environ)
    env.pop("MXNET_FAULT_INJECT", None)
    if fault:
        env["MXNET_FAULT_INJECT"] = fault
    code = ("import sys; sys.path.insert(0, {!r}); "
            "import test_torch_checkpoint as t; "
            "sys.exit(t.crash_worker(sys.argv[1:]))").format(HERE)
    cmd = [sys.executable, "-c", code, ckpt_dir, out, "--opt", opt,
           "--keep", str(keep)] + (["--sync"] if sync else [])
    repo = os.path.dirname(HERE)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(cmd, env=env, cwd=repo, capture_output=True,
                          text=True, timeout=120)


def _losses(path):
    out = {}
    if os.path.exists(path):
        for line in open(path):
            i, v = line.split()
            out[int(i)] = v
    return out


@pytest.fixture(scope="module")
def crash_base(tmp_path_factory):
    """The uninterrupted worker's losses, per optimizer."""
    out = {}
    for opt in ("sgd", "adam"):
        d = tmp_path_factory.mktemp(f"base_{opt}")
        r = _run_worker(str(d / "ck"), str(d / "base.log"), opt)
        assert r.returncode == 0, r.stderr[-2000:]
        out[opt] = _losses(str(d / "base.log"))
        assert sorted(out[opt]) == list(range(6))
    return out


#: (fault rule, optimizer, keep_last, the step the killed run leaves as
#: newest valid checkpoint; None: none at all). Saves come at steps 2, 4
#: and 6: every boundary of the second write with Adam, and the commit
#: with SGD-momentum too.
KILL_CASES = [
    ("checkpoint.stage:before=2", "adam", 3, 2),
    ("checkpoint.manifest:after=2", "adam", 3, 2),
    ("checkpoint.commit:before=2", "adam", 3, 2),
    ("checkpoint.commit:before=2", "sgd", 3, 2),
    ("checkpoint.commit:after=2", "adam", 3, 4),  # committed, unpublished
    ("checkpoint.publish:before=2", "adam", 3, 4),
    ("checkpoint.publish:after=2", "adam", 3, 4),
    ("checkpoint.prune:before=1", "adam", 1, 4),  # step 2 not yet pruned
    ("checkpoint.commit:before=1", "adam", 3, None),  # the first commit
]


@pytest.mark.parametrize("fault,opt,keep,newest", KILL_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in KILL_CASES])
def test_kill9_at_each_commit_boundary_resumes_bit_exact(
        tmp_path, crash_base, fault, opt, keep, newest):
    """A training subprocess SIGKILLed at a boundary of a checkpoint
    write: the newest valid checkpoint is the last one published (or
    committed), nothing partial is visible, and a rerun resumes from it
    and reproduces the uninterrupted run's losses bit for bit."""
    base = crash_base[opt]
    d = str(tmp_path / "ck")
    killed = str(tmp_path / "killed.log")
    r = _run_worker(d, killed, opt, fault=fault, keep=keep)
    assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
    for i, v in _losses(killed).items():
        assert v == base[i]
    found = latest_valid(d)
    assert (found and found[0]) == newest
    if os.path.isdir(d):
        for name in os.listdir(d):
            if name.startswith("step-"):
                read_checkpoint(os.path.join(d, name))   # all complete
    resumed = str(tmp_path / "resumed.log")
    r = _run_worker(d, resumed, opt, keep=keep)
    assert r.returncode == 0, r.stderr[-2000:]
    got = _losses(resumed)
    assert sorted(got) == list(range(newest or 0, 6))
    for i, v in got.items():
        assert v == base[i], f"loss diverged at step {i}"


# ================================================================ the JAX package
def _jax_net(weights, dtype=None):
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import nn as jnn
    net = jnn.HybridSequential()
    net.add(jnn.Dense(8, in_units=4, activation="relu"))
    net.add(jnn.Dense(5, in_units=8, activation="relu"))
    net.add(jnn.Dense(3, in_units=5))
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(weights[k]))
        if dtype is not None:
            p.cast(dtype)
    return net


def _jax_run(mode, opt, n_steps, ckpt_dir=None, save_at=(), resume=False):
    """The JAX package's counterpart of :func:`_train_run` (zero: its
    ZeRO step at dp 4 on the 8-device virtual CPU mesh)."""
    import contextlib

    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import autograd
    from mxnet_tpu.checkpoint import TrainCheckpointManager as JMgr
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    from mxnet_tpu.parallel import shard_batch
    net = _jax_net(_weights())
    name, hp = OPTS[opt]
    trainer = JTrainer(net.collect_params(), name, dict(hp))
    lb = jloss.SoftmaxCrossEntropyLoss()
    mesh = jmake_mesh({"dp": DP}, jax.devices()[:DP]) if mode == "zero" \
        else None
    losses = {}
    with mesh if mesh is not None else contextlib.nullcontext():
        mgr = JMgr(ckpt_dir, async_save=False) if ckpt_dir else None
        start = 0
        if mgr and resume:
            start = int(mgr.restore_latest(trainer=trainer, net=net)["step"])
        step = None if mode == "eager" else \
            trainer.compile_step(lambda a, b: lb(net(a), b))
        for i in range(start, n_steps):
            x, y = (mx.nd.array(a) for a in _batch(i))
            if mesh is not None:
                x, y = shard_batch(x, mesh), shard_batch(y, mesh)
            if step is None:
                with autograd.record():
                    loss = lb(net(x), y)
                loss.backward()
                trainer.step(8)
            else:
                loss = step(x, y)
            losses[i] = loss.asnumpy().astype("f4")
            if mgr and (i + 1) in save_at:
                mgr.save(i + 1, trainer=trainer, net=net)
        if mode == "zero":
            assert step.zero_sharded
    return losses


def _close(got, ref):
    assert sorted(got) == sorted(ref)
    for i in got:
        onp.testing.assert_allclose(got[i], ref[i], rtol=TOL, atol=TOL,
                                    err_msg=f"step {i}")


@pytest.mark.parametrize("mode", ["eager", "fused", "zero"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_jax_checkpoint_resumes_in_port(tmp_path, mode, opt):
    """The JAX package writes a checkpoint at step 3 (its ZeRO step at
    dp 4 for ``zero``); the port restores it (four gloo ranks for
    ``zero``) and continues 3 steps, within 1e-5 of the JAX package's
    uninterrupted run."""
    ref = _jax_run(mode, opt, 6)
    d = str(tmp_path / "ck")
    _jax_run(mode, opt, 3, ckpt_dir=d, save_at={3})
    if mode == "zero":
        ranks = tdist.spawn(_resume_rank, DP, "cpu", (d, opt, 6),
                            timeout_s=SPAWN_TIMEOUT_S)
        runs = [losses for losses, _ in ranks]
    else:
        runs = [_train_run(mode, opt, 6, ckpt_dir=d, resume=True)]
    for got in runs:
        _close(got, {i: ref[i] for i in range(3, 6)})


@pytest.mark.parametrize("mode", ["eager", "fused", "zero"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_port_checkpoint_resumes_in_jax(tmp_path, zero_runs, mode, opt):
    """The port writes at step 3 (four gloo ranks for ``zero``); the JAX
    package restores it (its ZeRO step at dp 4) and continues, within
    1e-5 of its own uninterrupted run."""
    if mode == "zero":
        d = os.path.join(zero_runs[0], opt)
    else:
        d = str(tmp_path / "ck")
        _train_run(mode, opt, 3, ckpt_dir=d, save_at={3})
    assert latest_valid(d)[0] == 3
    got = _jax_run(mode, opt, 6, ckpt_dir=d, resume=True)
    _close(got, {i: v for i, v in _jax_run(mode, opt, 6).items() if i >= 3})


def _one_eager_step_jax(opt, dtype, mp):
    import mxnet_tpu as mx
    from mxnet_tpu import autograd
    from mxnet_tpu.checkpoint import capture_train_state as jcapture
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss
    net = _jax_net(_weights(), dtype)
    name, hp = OPTS[opt]
    tr = JTrainer(net.collect_params(), name,
                  dict(hp, multi_precision=mp))
    x, y = _batch(0)
    with autograd.record():
        loss = jloss.SoftmaxCrossEntropyLoss()(
            net(mx.nd.array(x).astype(dtype or "float32")), mx.nd.array(y))
    loss.backward()
    tr.step(8)
    return jcapture(trainer=tr, net=net, step=1)


def _one_eager_step_port(opt, dtype, mp):
    net = _build(dtype=getattr(torch, dtype) if dtype else None)
    tr = _trainer(net, opt, multi_precision=mp)
    x, y = _tbatch(0)
    loss = tloss.SoftmaxCrossEntropyLoss()(
        net(x.to(net[0].weight.dtype)), y)
    loss.backward(torch.ones_like(loss))
    tr.step(8)
    return capture_train_state(trainer=tr, net=net, step=1)


@pytest.mark.parametrize("opt,dtype,mp", [("sgd", None, False),
                                          ("adam", None, False),
                                          ("adam", "bfloat16", True)])
def test_writers_agree_on_names_dtypes_and_fields(tmp_path, opt, dtype, mp):
    """One eager step in each package, captured and written: the same
    array names (RNG keys aside), shapes and logical dtypes, the same
    meta keys and values, and the same manifest fields."""
    from mxnet_tpu.checkpoint import write_checkpoint as jwrite
    js = _one_eager_step_jax(opt, dtype, mp)
    ts = _one_eager_step_port(opt, dtype, mp)
    jm = json.load(open(os.path.join(
        jwrite(str(tmp_path / "j"), 1, js.arrays, array_meta=js.array_meta,
               meta=js.meta), "manifest.json")))
    tm = json.load(open(os.path.join(
        write_checkpoint(str(tmp_path / "t"), 1, ts.arrays,
                         array_meta=ts.array_meta, meta=ts.meta),
        "manifest.json")))
    assert sorted(jm) == sorted(tm)
    rng = lambda names: {n for n in names if n.startswith("rng/")}  # noqa
    assert rng(jm["arrays"]) == {"rng/key"}
    assert rng(tm["arrays"]) == {"rng/torch/default"}
    names = set(jm["arrays"]) - rng(jm["arrays"])
    assert names == set(tm["arrays"]) - rng(tm["arrays"])
    assert any(n.startswith("opt/") for n in names)
    for n in names:
        je, te = jm["arrays"][n], tm["arrays"][n]
        assert sorted(je) == sorted(te), n
        assert (je["shape"], je["dtype"]) == (te["shape"], te["dtype"]), n
    assert sorted(jm["meta"]) == sorted(tm["meta"])
    for k in ("step", "param_names", "dp_size", "opt_mode", "optimizer",
              "num_update", "index_update_count", "trainable_names",
              "lr_scheduler"):
        assert jm["meta"][k] == tm["meta"][k], k


def test_bf16_multi_precision_checkpoint_loads_both_ways(tmp_path):
    """bf16 weights under Adam's ``multi_precision``, one eager step in
    each package: the other restores its checkpoint bit for bit, the
    bf16 weights (uint16 on disk) and the float32 moments and masters."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.checkpoint import TrainCheckpointManager as JMgr
    from mxnet_tpu.checkpoint import write_checkpoint as jwrite
    from mxnet_tpu.gluon import Trainer as JTrainer
    js = _one_eager_step_jax("adam", "bfloat16", True)
    ts = _one_eager_step_port("adam", "bfloat16", True)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jwrite(jdir, 1, js.arrays, array_meta=js.array_meta, meta=js.meta)
    write_checkpoint(tdir, 1, ts.arrays, array_meta=ts.array_meta,
                     meta=ts.meta)

    def f32(a):
        return onp.asarray(a).astype(onp.float32)

    # the port restores the JAX package's checkpoint
    net = _build(dtype=torch.bfloat16)
    tr = _trainer(net, "adam", multi_precision=True)
    TrainCheckpointManager(jdir).restore_latest(trainer=tr, net=net)
    for k, p in net.named_parameters():
        assert p.dtype == torch.bfloat16
        onp.testing.assert_array_equal(p.detach().float().numpy(),
                                       f32(js.arrays[f"param/{k}"]), k)
    assert sorted(tr._updater.states) == list(range(len(SHAPES)))
    for idx, st in tr._updater.states.items():
        leaves = tr._optimizer.state_tensors(st)
        assert [t.dtype for t in leaves] == [torch.float32] * 3
        for li, t in enumerate(leaves):
            onp.testing.assert_array_equal(
                t.numpy(), f32(js.arrays[f"opt/{idx}/{li}"]))
    assert tr._optimizer.num_update == 1

    # the JAX package restores the port's
    jnet = _jax_net(_weights(), "bfloat16")
    jtr = JTrainer(jnet.collect_params(), "adam",
                   dict(OPTS["adam"][1], multi_precision=True))
    JMgr(tdir).restore_latest(trainer=jtr, net=jnet)
    for k, p in jnet.collect_params().items():
        assert str(p.data().asnumpy().dtype) == "bfloat16"
        onp.testing.assert_array_equal(
            f32(p.data().asnumpy()),
            to_tensor(ts.arrays[f"param/{k}"], "bfloat16").float().numpy(),
            k)
    assert sorted(jtr._updater.states) == list(range(len(SHAPES)))
    for idx, st in jtr._updater.states.items():
        leaves = jax.tree_util.tree_leaves(
            st, is_leaf=lambda t: isinstance(t, mx.nd.NDArray))
        for li, t in enumerate(leaves):
            onp.testing.assert_array_equal(
                f32(t.asnumpy()), ts.arrays[f"opt/{idx}/{li}"])


@pytest.mark.parametrize("container", ["dict", "list"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nd_save_load_both_ways(tmp_path, dtype, container):
    import mxnet_tpu as mx
    r = onp.random.RandomState(4)
    vals = [r.randn(3, 5).astype("f4"), r.randn(7).astype("f4")]
    tt = [torch.from_numpy(v).to(getattr(torch, dtype)) for v in vals]
    jj = [mx.nd.array(v).astype(dtype) for v in vals]
    pack = (lambda xs: {"w": xs[0], "b": xs[1]}) if container == "dict" \
        else list
    unpack = (lambda d: [d["w"], d["b"]]) if container == "dict" else list
    fj, ft = str(tmp_path / "j.nd"), str(tmp_path / "t.nd")
    mx.nd.save(fj, pack(jj))
    tnd.save(ft, pack(tt))
    for got, want in zip(unpack(tnd.load(fj, device="cpu")), tt):
        assert got.dtype == want.dtype and torch.equal(got, want)
    for got, want in zip(unpack(mx.nd.load(ft)), jj):
        assert str(got.asnumpy().dtype) == dtype
        onp.testing.assert_array_equal(got.asnumpy().astype("f4"),
                                       want.asnumpy().astype("f4"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameter_files_load_both_ways(tmp_path, dtype):
    jnet = _jax_net(_weights(seed=5), dtype if dtype != "float32" else None)
    tnet = _build(seed=5, dtype=getattr(torch, dtype))
    fj, ft = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnet.save_parameters(fj)
    save_parameters(tnet, ft)
    tdst = _build(dtype=getattr(torch, dtype))
    load_parameters(tdst, fj)
    for (k, a), (_, b) in zip(tnet.named_parameters(),
                              tdst.named_parameters()):
        assert b.dtype == a.dtype and torch.equal(a, b), k
    jdst = _jax_net(_weights(), dtype if dtype != "float32" else None)
    jdst.load_parameters(ft)
    for k, p in jdst.collect_params().items():
        assert str(p.data().asnumpy().dtype) == dtype
        onp.testing.assert_array_equal(
            p.data().asnumpy().astype("f4"),
            dict(tnet.named_parameters())[k].detach().float().numpy(),
            err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_trainer_state_files_load_both_ways(tmp_path, opt):
    """``save_states`` (``Updater.get_states``' pickle, float32 states)
    of either package loads into the other's trainer: the same states
    and update counts, and one more step agrees within 1e-5."""
    import mxnet_tpu as mx
    from mxnet_tpu import autograd
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu.gluon import loss as jloss

    def jax_step(tr, net, i):
        x, y = (mx.nd.array(a) for a in _batch(i))
        with autograd.record():
            loss = jloss.SoftmaxCrossEntropyLoss()(net(x), y)
        loss.backward()
        tr.step(8)

    def port_step(tr, net, i):
        x, y = _tbatch(i)
        loss = tloss.SoftmaxCrossEntropyLoss()(net(x), y)
        loss.backward(torch.ones_like(loss))
        tr.step(8)

    name, hp = OPTS[opt]
    jnet = _jax_net(_weights())
    jtr = JTrainer(jnet.collect_params(), name, dict(hp))
    tnet = _build()
    ttr = _trainer(tnet, opt)
    for i in range(2):
        jax_step(jtr, jnet, i)
        port_step(ttr, tnet, i)
    fj, ft = str(tmp_path / "j.states"), str(tmp_path / "t.states")
    jtr.save_states(fj)
    ttr.save_states(ft)
    # a fresh trainer of each package takes the other's file, on weights
    # equal to the writer's
    jnet2 = _jax_net({k: p.detach().numpy() for k, p in
                      tnet.named_parameters()})
    jtr2 = JTrainer(jnet2.collect_params(), name, dict(hp))
    jtr2.load_states(ft)
    tnet2 = _build()
    load_jax_params(tnet2, {k: p.data().asnumpy()
                            for k, p in jnet.collect_params().items()})
    ttr2 = _trainer(tnet2, opt)
    ttr2.load_states(fj)
    assert ttr2._optimizer.num_update == jtr._optimizer.num_update == 2
    assert jtr2._optimizer.num_update == 2
    assert sorted(ttr2._updater.states) == sorted(jtr._updater.states)
    for k, v in jtr._updater.states.items():
        for a, b in zip(ttr2._updater.states[k], v):
            onp.testing.assert_array_equal(a.numpy(), b.asnumpy())
    port_step(ttr2, tnet2, 2)        # places the loaded states
    jax_step(jtr, jnet, 2)
    for k, p in jnet.collect_params().items():
        onp.testing.assert_allclose(
            dict(tnet2.named_parameters())[k].detach().numpy(),
            p.data().asnumpy(), rtol=TOL, atol=TOL, err_msg=k)
    assert sorted(jtr2._updater.states) == sorted(ttr._updater.states)
    for k, v in ttr._updater.states.items():
        for a, b in zip(v, jtr2._updater.states[k]):
            onp.testing.assert_array_equal(a.numpy(), b.asnumpy())
