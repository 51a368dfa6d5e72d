"""The port's autopilot (``mxnet_tpu_torch/tuning/``) against the JAX
package's (``mxnet_tpu/tuning/``, ``tests/test_tuning.py``), side by side
where the two can meet:

- the registry: every tunable but the kernel ones has the JAX package's
  name, default, grid, env, scope and program flag; the kernel tunable
  keeps its name (its values are the card's shared memory, not VMEM), and
  ``kernels.rnn_block_t`` is the one JAX name the port leaves out;
- resolution (override > env > default) at every seam;
- ``coordinate_search`` of both packages on the same planted backends
  (deterministic, seeded noisy, faulting, budget-capped, filtered):
  equal trial lists and winners;
- the cache's file: one file written by both packages reads in both;
- the predictor's ``warmup`` keys and FLOPs against the JAX predictor's;
- the port's own contracts: signatures, the off / cached / on gates, the
  outcome record and metrics, tuned losses bit-equal to the defaults', the
  timed backend putting the train state back bit for bit, the serving
  scope's feasibility, two gloo ranks agreeing on one winner, and the
  kernel budget's plans.

JAX is imported inside the tests: the spawned ranks import this module.
"""
import json
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch import tuning as ttuning
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import TrainLoop as TTrainLoop
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops.kernels import norm as KN
from mxnet_tpu_torch.ops.kernels import rnn_scan as KR
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.tuning import cache as tcache
from mxnet_tpu_torch.tuning import space as tspace

IN, HIDDEN, CLASSES, BS = 16, 32, 8, 8
KERNEL_TUNABLES = ("kernels.vmem_tile_budget", "kernels.rnn_block_t")
ENV = ("MXNET_AUTOTUNE", "MXNET_AUTOTUNE_CACHE",
       "MXNET_AUTOTUNE_BUDGET_TRIALS", "MXNET_AUTOTUNE_BACKEND")


def _jax():
    import mxnet_tpu as mx
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu import tuning as jtuning
    return mx, jtel, jtuning


@pytest.fixture(autouse=True)
def clean_tuning(monkeypatch):
    """No tuned override, a memory-only default cache, the gate off and
    zeroed telemetry in both packages."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    _, jtel, jtuning = _jax()
    for sp in (tspace, jtuning.space):
        sp.clear_overrides()
    for t in (ttel, jtel):
        t.reset()
    yield
    for sp in (tspace, jtuning.space):
        sp.clear_overrides()
    for t in (ttel, jtel):
        t.reset()


def make_batch(seed=0, rows=BS):
    rs = onp.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(rows, IN).astype("float32")),
            torch.from_numpy(rs.randint(0, CLASSES, size=(rows,))))


def make_net(hidden=HIDDEN, seed=42):
    torch.manual_seed(seed)
    net = tnn.HybridSequential()
    net.add(tnn.Dense(hidden, activation="relu", in_units=IN, device="cpu"),
            tnn.Dense(CLASSES, in_units=hidden, device="cpu"))
    return net


def make_step(hidden=HIDDEN, autotune=None, opt="sgd", lr=0.1):
    net = make_net(hidden)
    loss = tloss.SoftmaxCrossEntropyLoss()
    kw = {"learning_rate": lr}
    if opt == "sgd":
        kw["momentum"] = 0.9
    trainer = TTrainer(dict(net.named_parameters()), opt, kw, kvstore=None)
    step = trainer.compile_step(lambda a, b: loss(net(a), b),
                                autotune=autotune)
    return step, net, trainer


def make_loop():
    net = make_net()
    trainer = TTrainer(dict(net.named_parameters()), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9},
                       kvstore=None)
    return TTrainLoop(net, trainer, tloss.SoftmaxCrossEntropyLoss())


# ---------------------------------------------------------------------------
# the registry and resolution
# ---------------------------------------------------------------------------

def _spec(t):
    return (t.default, t.grid, t.env, t.scope, t.affects_program)


def test_registry_matches_the_jax_registry():
    _, _, jtuning = _jax()
    tspace.ensure_registered()
    jtuning.space.ensure_registered()
    jt = {t.name: t for t in jtuning.space.tunables()}
    tt = {t.name: t for t in tspace.tunables()}
    assert set(jt) - set(tt) == {"kernels.rnn_block_t"}
    assert set(tt) == set(jt) - {"kernels.rnn_block_t"}
    for name in set(jt) - set(KERNEL_TUNABLES):
        assert _spec(tt[name]) == _spec(jt[name]), name
        assert tt[name].seam and tt[name].default in tt[name].grid
    # the kernel tunable: the same name, env and scope; the card's values
    b = tt["kernels.vmem_tile_budget"]
    assert (b.env, b.scope, b.affects_program) == \
        (jt[b.name].env, jt[b.name].scope, jt[b.name].affects_program)
    assert b.default == K.H100_SMEM_OPTIN == max(b.grid)
    assert b.grid == K.SMEM_BUDGET_GRID
    rows = {r["name"]: r for r in tspace.table()}
    assert set(rows) == set(tt)


def test_resolution_precedence(monkeypatch):
    tspace.ensure_registered()
    t = tspace.get("engine.inflight_steps")
    assert t.resolve() == 2
    monkeypatch.setenv("MXNET_INFLIGHT_STEPS", "5")
    assert t.resolve() == 5
    tspace.set_override("engine.inflight_steps", 7)
    assert t.resolve() == 7
    tspace.clear_overrides(["engine.inflight_steps"])
    assert t.resolve() == 5


def _seams():
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.gluon import fused_step
    from mxnet_tpu_torch.serving import batcher, decode
    return {
        "engine.inflight_steps": (engine.inflight_steps, 6, 6, "3", 3),
        "zero.shard_min_size": (fused_step._zero_min_size, 512, 512,
                                "8192", 8192),
        "zero.bucket_bytes": (fused_step._zero_bucket_bytes, 0, 0,
                              "1048576", 1 << 20),
        "kernels.vmem_tile_budget": (K.vmem_tile_budget, 128 * 1024,
                                     128 * 1024, "98304", 98304),
        "serving.max_batch": (batcher.max_batch_rows, 16, 16, "8", 8),
        "serving.batch_timeout_ms": (batcher.batch_timeout_s, 0.5, 0.5e-3,
                                     "5", 5e-3),
        "decode.slot_ladder": (decode.slot_ladder, "1,4,16", (1, 4, 16),
                               "1,2,4", (1, 2, 4)),
        "decode.kv_page_size": (decode.kv_page_size, 32, 32, "8", 8),
        "decode.prefill_chunk": (decode.prefill_chunk, 64, 64, "8", 8),
        "decode.spec_k": (decode.spec_k, 4, 4, "2", 2),
        "decode.prefix_share": (decode.prefix_share, 0, False, "0", False),
    }


@pytest.mark.parametrize("name", sorted(_seams()))
def test_each_seam_resolves_override_then_env_then_default(name,
                                                           monkeypatch):
    fn, override, want, env_value, env_want = _seams()[name]
    t = tspace.get(name)
    default = fn()
    monkeypatch.setenv(t.env, env_value)
    assert fn() == env_want
    tspace.set_override(name, override)
    assert fn() == want
    tspace.clear_overrides([name])
    monkeypatch.delenv(t.env)
    assert fn() == default


def test_kernel_budget_accessor_clamps_to_the_card():
    assert K.vmem_tile_budget() == K.SMEM_TILE_BUDGET_BYTES
    tspace.set_override("kernels.vmem_tile_budget", 10 ** 12)
    assert K.vmem_tile_budget() == K.H100_SMEM_OPTIN
    tspace.set_override("kernels.vmem_tile_budget", 1)
    assert K.vmem_tile_budget() == 64 * 1024
    t = tspace.get("kernels.vmem_tile_budget")
    assert not t.valid(2 ** 40) and all(t.valid(v) for v in t.grid)


def test_trial_context_restores_overrides():
    tspace.set_override("engine.inflight_steps", 3)
    with tspace.trial({"engine.inflight_steps": 8,
                       "zero.shard_min_size": 512}):
        assert tspace.value("engine.inflight_steps") == 8
        assert tspace.value("zero.shard_min_size") == 512
    assert tspace.value("engine.inflight_steps") == 3
    assert tspace.get_override("zero.shard_min_size") == (False, None)


def test_search_space_views_as_the_jax_package():
    _, _, jtuning = _jax()
    tspace.ensure_registered()
    jtuning.space.ensure_registered()
    for scope in ("train", "serving"):
        tnames = {t.name for t in ttuning.SearchSpace(scope)}
        jnames = {t.name for t in jtuning.SearchSpace(scope)}
        assert tnames == jnames - {"kernels.rnn_block_t"}, scope
    train = ttuning.SearchSpace("train")
    assert train.valid(train.defaults())
    assert not train.valid({"kernels.vmem_tile_budget": 2 ** 40})
    assert train.signature() != ttuning.SearchSpace("serving").signature()
    assert train.signature() == tspace.space_signature("train")


# ---------------------------------------------------------------------------
# the search, side by side on planted backends
# ---------------------------------------------------------------------------

def _bowl(c):
    return 1e-3 + 1e-4 * ((c["syn.x"] - 4) ** 2 + (c["syn.y"] - 2) ** 2)


class _Planted:
    """Scores ``fn(config)``, times ``1 + noise`` from a seeded stream
    drawn in call order when ``noise``; raises ``err(msg)`` where ``fn``
    returns a string."""

    name = "analytical"

    def __init__(self, pkg_result, err, fn, deterministic=True, noise=0.0,
                 seed=0):
        self._result, self._err, self._fn = pkg_result, err, fn
        self.deterministic = deterministic
        self._noise = noise
        self._rs = onp.random.RandomState(seed)
        self.calls = 0

    def measure(self, config, fidelity=1):
        self.calls += 1
        v = self._fn(config)
        if isinstance(v, str):
            raise self._err(v)
        if self._noise:
            v *= 1.0 + self._noise * self._rs.randn() / fidelity
        return self._result(v)


def _faulting(c):
    if c["syn.x"] == 4:
        return "RESOURCE_EXHAUSTED: out of memory allocating 8G"
    return _bowl(c)


def _faulting_default(c):
    return "RESOURCE_EXHAUSTED: out of memory" if c["syn.x"] == 3 \
        else _bowl(c)


SEARCH_CASES = {
    # name: (grids {knob: (default, grid)}, fn, deterministic, noise,
    #        budget, valid {knob: max})
    "planted": ({"syn.x": (3, (1, 2, 3, 4, 5)), "syn.y": (5, (1, 2, 3, 4, 5))},
                _bowl, True, 0.0, 16, {}),
    "budget_cap": ({"syn.x": (3, (1, 2, 3, 4, 5)),
                    "syn.y": (5, (1, 2, 3, 4, 5))}, _bowl, True, 0.0, 3, {}),
    "faulting": ({"syn.x": (3, (1, 2, 3, 4, 5)),
                  "syn.y": (5, (1, 2, 3, 4, 5))}, _faulting, True, 0.0, 32,
                 {}),
    "infeasible_default": ({"syn.x": (3, (1, 2, 3, 4, 5)),
                            "syn.y": (5, (1, 2, 3, 4, 5))},
                           _faulting_default, True, 0.0, 32, {}),
    "validity": ({"syn.v": (1, (1, 2, 3, 4))}, lambda c: 1.0 / c["syn.v"],
                 True, 0.0, 16, {"syn.v": 2}),
    "halving": ({"syn.x": (1, (1, 2, 3, 4, 5, 6, 7, 8))},
                lambda c: 1e-3 + 1e-4 * abs(c["syn.x"] - 6), False, 0.0, 64,
                {}),
    "noisy": ({"syn.x": (3, (1, 2, 3, 4, 5, 6)),
               "syn.y": (5, (1, 2, 3, 4, 5, 6))}, _bowl, False, 0.3, 40, {}),
}


def _run_search(pkg, err, case):
    grids, fn, det, noise, budget, valid = SEARCH_CASES[case]
    tunables = tuple(
        pkg.Tunable(name, default=d, grid=g, seam="synthetic",
                    valid=(lambda v, _c, m=valid[name]: v <= m)
                    if name in valid else None)
        for name, (d, g) in sorted(grids.items()))
    backend = _Planted(pkg.MeasureResult, err, fn, det, noise, seed=11)
    res = pkg.coordinate_search(tunables, backend, budget)
    return res, backend


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_coordinate_search_walks_the_jax_trials(case):
    _, _, jtuning = _jax()
    from mxnet_tpu.base import MXNetError as JErr
    jres, jb = _run_search(jtuning, JErr, case)
    tres, tb = _run_search(ttuning, mxt.MXNetError, case)
    assert [t.to_dict() for t in tres.trials] == \
        [t.to_dict() for t in jres.trials]
    assert tres.to_dict() == jres.to_dict()
    assert tb.calls == jb.calls
    if case == "planted":
        assert tres.best_config == {"syn.x": 4, "syn.y": 2}
        assert tres.improved and tres.delta_pct > 0
    elif case == "budget_cap":
        assert tres.n_trials == 3 and tres.exhausted
    elif case == "faulting":
        bad = [t for t in tres.trials if not t.result.feasible]
        assert bad and all("oom" in t.result.reason for t in bad)
        assert tres.best_config["syn.x"] != 4
    elif case == "infeasible_default":
        assert tres.best_config["syn.x"] == 4 and tres.delta_pct is None
    elif case == "validity":
        assert tres.best_config == {"syn.v": 2}
        assert all(t.config["syn.v"] <= 2 for t in tres.trials)
    elif case == "halving":
        assert tres.best_config == {"syn.x": 6}
        assert max(t.fidelity for t in tres.trials) >= 2


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_cache_atomic_roundtrip(tmp_path):
    db = ttuning.AutotuneCache(str(tmp_path / "at.json"))
    db.put("k1", {"config": {"a.b": 1}, "trials": 5})
    fresh = ttuning.AutotuneCache(str(tmp_path / "at.json"))
    assert fresh.get("k1")["config"] == {"a.b": 1}
    assert fresh.get("nope") is None
    doc = json.loads((tmp_path / "at.json").read_text())
    assert doc["schema"] == tcache.CACHE_SCHEMA == 1


def test_cache_corrupt_file_degrades_to_retune(tmp_path):
    p = tmp_path / "at.json"
    p.write_text("{ not json !!!")
    db = ttuning.AutotuneCache(str(p))
    assert db.get("k1") is None
    db.put("k1", {"config": {}})
    assert ttuning.AutotuneCache(str(p)).get("k1") == {"config": {}}


def test_one_cache_file_written_by_both_packages(tmp_path):
    _, _, jtuning = _jax()
    path = str(tmp_path / "shared.json")
    jtuning.AutotuneCache(path).put("jax-key", {"config": {"x.y": 1}})
    ttuning.AutotuneCache(path).put("torch-key", {"config": {"x.y": 2}})
    jtuning.AutotuneCache(path).put("jax-key2", {"config": {"x.y": 3}})
    for pkg in (jtuning, ttuning):
        db = pkg.AutotuneCache(path)
        assert db.get("jax-key")["config"] == {"x.y": 1}
        assert db.get("torch-key")["config"] == {"x.y": 2}
        assert db.get("jax-key2")["config"] == {"x.y": 3}
        assert db.keys() == ["jax-key", "jax-key2", "torch-key"]


def test_step_signature_stable_and_shape_sensitive():
    s1, _, _ = make_step()
    s2, _, _ = make_step()
    x, y = make_batch()
    assert tcache.step_signature(s1, (x, y)) == \
        tcache.step_signature(s2, (x, y))
    s3, _, _ = make_step(hidden=HIDDEN * 2)
    assert tcache.step_signature(s1, (x, y)) != \
        tcache.step_signature(s3, (x, y))
    x2, y2 = make_batch(rows=BS * 2)
    assert tcache.step_signature(s1, (x, y)) != \
        tcache.step_signature(s1, (x2, y2))
    assert "cpu" in tcache.device_identity("cpu")


def test_signature_change_invalidates_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("MXNET_AUTOTUNE_BUDGET_TRIALS", "8")
    x, y = make_batch()
    step, _, _ = make_step(autotune="on")
    step(x, y)
    assert step.autotune_result.source == "search"
    tspace.clear_overrides()
    step2, _, _ = make_step(autotune="on")
    step2(x, y)
    assert step2.autotune_result.source == "cache"
    assert step2.autotune_result.trials == 0
    tspace.clear_overrides()
    step3, _, _ = make_step(hidden=HIDDEN * 2, autotune="on")
    step3(x, y)
    assert step3.autotune_result.source == "search"
    assert step3.autotune_result.key != step2.autotune_result.key


# ---------------------------------------------------------------------------
# the gates and the outcome
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,want", [
    ("on", "on"), ("1", "on"), ("true", "on"), ("cached", "cached"),
    ("CACHED", "cached"), ("off", "off"), ("0", "off"), ("", "off"),
    ("bogus", "off")])
def test_autotune_mode_parsing_as_the_jax_package(monkeypatch, value, want):
    _, _, jtuning = _jax()
    monkeypatch.setenv("MXNET_AUTOTUNE", value)
    assert ttuning.autotune_mode() == jtuning.autotune_mode() == want
    assert ttuning.autotune_mode("off") == "off"
    assert ttuning.autotune_mode(True) == "on"


def test_gate_off_does_nothing():
    x, y = make_batch()
    step, _, _ = make_step()
    step(x, y)
    out = step.autotune_result
    assert out.mode == "off" and out.trials == 0
    assert tspace.overrides() == {}
    assert ttel.value(ttel.names.AUTOTUNE_CACHE_MISSES) == 0


def test_gate_cached_miss_runs_defaults_zero_trials(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    x, y = make_batch()
    step, _, _ = make_step(autotune="cached")
    step(x, y)
    out = step.autotune_result
    assert out.source == "default" and out.trials == 0 and out.config == {}
    assert tspace.overrides() == {}
    assert not (tmp_path / "at.json").exists()
    assert ttel.value(ttel.names.AUTOTUNE_CACHE_MISSES) == 1
    assert ttel.value(ttel.names.AUTOTUNE_TRIALS, "analytical") in (None,
                                                                     0.0)


def test_gate_on_searches_within_budget(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("MXNET_AUTOTUNE_BUDGET_TRIALS", "5")
    x, y = make_batch()
    step, _, _ = make_step(autotune="on")
    step(x, y)
    out = step.autotune_result
    assert out.source == "search" and 1 <= out.trials <= 5
    assert out.backend == "analytical"
    assert (tmp_path / "at.json").exists()
    assert ttel.value(ttel.names.AUTOTUNE_TRIALS, "analytical") == \
        out.trials


def test_explicit_autotune_method_and_outcome_record(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("MXNET_AUTOTUNE_BUDGET_TRIALS", "8")
    x, y = make_batch()
    step, _, _ = make_step()
    out = step.autotune(x, y, mode="on")
    assert out is step.autotune_result and out.source == "search"
    assert set(out.bench_dict()) == {"autotune_config", "autotune_trials",
                                     "autotune_delta_pct"}
    assert set(out.to_dict()) == {"mode", "source", "key", "backend",
                                  "config", "trials", "delta_pct"}
    assert ttuning.last_outcome() is out and out in ttuning.outcomes()
    before = ttel.value(ttel.names.AUTOTUNE_TRIALS, "analytical")
    step(x, y)                  # the first call does not tune again
    assert ttel.value(ttel.names.AUTOTUNE_TRIALS, "analytical") == before


def test_compile_step_analyze_still_raises():
    """``analyze`` no longer raises at build time (``analysis/`` is
    ported): 'raise' arms the lint, which raises only on a finding."""
    _, net, tr = make_step()
    assert tr.compile_step(lambda a, b: a, analyze="raise")._analyze == \
        "raise"


# ---------------------------------------------------------------------------
# numerics: tuned = default, bit for bit
# ---------------------------------------------------------------------------

def run_trajectory(config=None, steps=6):
    tspace.clear_overrides()
    if config:
        tspace.apply_config(config)
    try:
        loop = make_loop()
        x, y = make_batch()
        losses = [loop.step(x, y) for _ in range(steps)]
        loop.synchronize()
        return [l.numpy().tolist() for l in losses]
    finally:
        tspace.clear_overrides()


@pytest.mark.parametrize("config", [
    {"engine.inflight_steps": 4, "kernels.vmem_tile_budget": 64 * 1024},
    {"engine.inflight_steps": 0},
    {"zero.shard_min_size": 512, "zero.bucket_bytes": 0}],
    ids=["deep_window_small_budget", "sync", "zero_knobs"])
def test_tuned_configs_are_bit_exact_on_losses(config):
    assert run_trajectory(config) == run_trajectory(None)


def test_timed_backend_restores_train_state(tmp_path, monkeypatch):
    """The timed trials run real Adam steps; afterwards the weights, the
    optimizer's states, its counts and the step's own count are the ones
    from before, bit for bit, and the tuned step trains as an untouched
    one does."""
    monkeypatch.setenv("MXNET_AUTOTUNE_BACKEND", "timed")
    monkeypatch.setenv("MXNET_AUTOTUNE_BUDGET_TRIALS", "4")
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    x, y = make_batch()
    step, net, trainer = make_step(opt="adam", lr=0.01)
    step(x, y)                          # one real step: live Adam states
    params = [p.detach().clone() for p in net.parameters()]
    opt = trainer._optimizer
    states = [s.clone() for st in trainer._updater.states.values()
              for s in opt.state_tensors(st)]
    counts = (opt.num_update, dict(opt._index_update_count),
              step.steps_done)
    rng = torch.get_rng_state()
    out = ttuning.tune_step(step, (x, y), mode="on")
    assert out.source == "search" and out.backend == "timed"
    assert out.trials == 4
    assert (opt.num_update, dict(opt._index_update_count),
            step.steps_done) == counts
    assert all(torch.equal(a, b) for a, b in zip(params, net.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(
        states, [s for st in trainer._updater.states.values()
                 for s in opt.state_tensors(st)]))
    assert torch.equal(rng, torch.get_rng_state())
    tspace.clear_overrides()
    ref, ref_net, _ = make_step(opt="adam", lr=0.01)
    ref(x, y)
    assert torch.equal(step(x, y), ref(x, y))
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                                 ref_net.parameters()))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_predictor(buckets=(1, 2, 4, 8)):
    return tserving.CompiledPredictor(make_net(seed=11),
                                      bucket_sizes=buckets, device="cpu")


def test_predictor_warmup_autotune_and_bucket_feasibility(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    from mxnet_tpu_torch.serving import batcher
    pred = make_predictor()
    x1 = make_batch(rows=1)[0]
    pred.warmup(x1, autotune="on")
    out = pred.autotune_result
    assert out is not None and out.source == "search"
    applied = tspace.value("serving.max_batch")
    assert applied <= 8 and batcher.max_batch_rows() == applied
    rec = ttuning.default_cache().get(out.key)
    bad = [t for t in rec["trial_log"] if not t["feasible"]]
    assert bad and all(t["config"]["serving.max_batch"] > 8 for t in bad)
    tspace.clear_overrides()
    ttel.reset()
    pred2 = make_predictor()
    pred2.warmup(x1, autotune="cached")
    assert pred2.autotune_result.source == "cache"
    assert pred2.autotune_result.trials == 0
    assert tspace.value("serving.max_batch") == applied
    b = batcher.DynamicBatcher(pred2, start=False)
    assert b.max_batch == applied
    b.close()


def test_warmup_returns_flops_as_the_jax_predictor():
    """``warmup`` returns {bucket: FLOPs} in both packages, growing with
    the bucket alike. The port counts the products (FlopCounterMode:
    2 x M x N x K a Dense) and the kernels' reported work; XLA's count
    also holds the bias adds and the ReLU, one operation an element: 72
    of 1,608 a row here, so the port's count is 4.5 % under the JAX one
    (held within 5 %), and equal in growth."""
    mx, _, _ = _jax()
    from mxnet_tpu import serving as jserving
    from mxnet_tpu.gluon import nn as jnn
    mx.random.seed(11)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(HIDDEN, activation="relu", in_units=IN),
             jnn.Dense(CLASSES, in_units=HIDDEN))
    jnet.initialize()
    jnet(mx.nd.array(onp.zeros((1, IN), "float32")))
    jp = jserving.CompiledPredictor(jnet, bucket_sizes=(1, 2, 4, 8))
    tp = make_predictor()
    x1 = make_batch(rows=1)[0]
    jw = jp.warmup(mx.nd.array(x1.numpy()))
    tw = tp.warmup(x1)
    assert set(tw) == set(jw) == {1, 2, 4, 8}
    assert set(tp.capture_s) == set(tw)
    assert all(s >= 0 for s in tp.capture_s.values())
    for b in tw:
        assert tw[b] == tw[1] * b
        assert jw[b] == pytest.approx(jw[1] * b, rel=1e-6)
        assert 0.95 * jw[b] <= tw[b] <= jw[b]
    assert tw[1] == 2.0 * (IN * HIDDEN + HIDDEN * CLASSES)
    assert tp.aot_compile(make_batch(rows=2)[0]) == tw[2]


def test_train_and_serving_scopes_do_not_cross(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("MXNET_AUTOTUNE_BUDGET_TRIALS", "8")
    x, y = make_batch()
    step, _, _ = make_step(autotune="on")
    step(x, y)
    assert not any(k.startswith(("serving.", "decode."))
                   for k in step.autotune_result.config)
    pred = make_predictor()
    pred.warmup(make_batch(rows=1)[0], autotune="on")
    assert all(k.startswith(("serving.", "decode."))
               for k in pred.autotune_result.config)


def test_autotune_metric_flow(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("MXNET_AUTOTUNE_BUDGET_TRIALS", "8")
    x, y = make_batch()
    step, _, _ = make_step(autotune="on")
    step(x, y)
    n = ttel.value(ttel.names.AUTOTUNE_TRIALS, "analytical")
    assert n == step.autotune_result.trials >= 1
    assert ttel.value(ttel.names.AUTOTUNE_CACHE_MISSES) == 1
    assert step.autotune_result.config
    for name, v in step.autotune_result.config.items():
        assert ttel.value(ttel.names.AUTOTUNE_ACTIVE, name) == float(v)
    tspace.clear_overrides()
    step2, _, _ = make_step(autotune="cached")
    step2(x, y)
    assert ttel.value(ttel.names.AUTOTUNE_CACHE_HITS) == 1


def test_closed_loop_end_to_end_cpu(tmp_path, monkeypatch):
    """The analytical backend tunes a real step and keeps the winner; a
    fresh construction under ``cached`` replays it with no trial, and
    trains bit for bit as the defaults do."""
    db_path = tmp_path / "autotune.json"
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", str(db_path))
    x, y = make_batch()
    losses_default = run_trajectory(None)
    monkeypatch.setenv("MXNET_AUTOTUNE", "on")
    loop = make_loop()
    loop.step(x, y)
    loop.synchronize()
    out1 = loop.compiled_step.autotune_result
    assert out1.source == "search" and out1.trials >= 1
    doc = json.loads(db_path.read_text())
    assert list(doc["entries"]) == [out1.key]
    persisted = doc["entries"][out1.key]["config"]
    assert persisted == out1.config and persisted
    tspace.clear_overrides()
    ttel.reset()
    monkeypatch.setenv("MXNET_AUTOTUNE", "cached")
    loop2 = make_loop()
    losses = [loop2.step(x, y) for _ in range(6)]
    loop2.synchronize()
    out2 = loop2.compiled_step.autotune_result
    assert out2.source == "cache" and out2.trials == 0
    assert out2.config == persisted and tspace.overrides() == persisted
    assert ttel.value(ttel.names.AUTOTUNE_CACHE_HITS) == 1
    assert [l.numpy().tolist() for l in losses] == losses_default


# ---------------------------------------------------------------------------
# two ranks, one winner
# ---------------------------------------------------------------------------

def _rank_tune(cache_path, budget):
    """One gloo rank: a ZeRO dp-2 MLP step tuned by the timed backend
    (each rank times its own steps, so local scores differ); returns the
    outcome, the trials' local and agreed scores and whether the weights
    came back."""
    torch.set_num_threads(1)
    os.environ["MXNET_AUTOTUNE_BACKEND"] = "timed"
    os.environ["MXNET_AUTOTUNE_BUDGET_TRIALS"] = str(budget)
    os.environ["MXNET_AUTOTUNE_CACHE"] = cache_path
    from mxnet_tpu_torch.parallel import make_mesh
    step, net, _ = make_step(opt="adam", lr=0.01)
    x, y = make_batch(rows=BS)
    before = [p.detach().clone() for p in net.parameters()]
    with make_mesh({"dp": tdist.size()}):
        out = step.autotune(x, y, mode="on")
        same = all(torch.equal(a, b)
                   for a, b in zip(before, net.parameters()))
        losses = [step(x, y).numpy().tolist() for _ in range(2)]
    rec = ttuning.default_cache().get(out.key)
    return {"outcome": out.to_dict(), "same": same, "losses": losses,
            "mode": step.mode,
            "log": [(t["config"], t["score"], t["fidelity"])
                    for t in rec["trial_log"]]}


def test_two_gloo_ranks_agree_on_one_winner(tmp_path):
    ranks = tdist.spawn(_rank_tune, 2, "cpu",
                        (str(tmp_path / "at.json"), 6), timeout_s=90)
    a, b = ranks
    assert a["mode"] == b["mode"] == "zero"
    assert a["outcome"]["trials"] == b["outcome"]["trials"] == 6
    assert a["outcome"]["config"] == b["outcome"]["config"]
    assert a["log"] == b["log"]           # the agreed scores, in order
    assert a["same"] and b["same"]
    assert a["losses"] == b["losses"]
    assert json.loads((tmp_path / "at.json").read_text())["entries"]


# ---------------------------------------------------------------------------
# the kernel budget's plans (plain Python)
# ---------------------------------------------------------------------------

def test_budget_moves_the_plans_it_feeds_and_no_other():
    """Under ``space.trial`` the LayerNorm forward's block branch and the
    decode step's path take the budget; the LayerNorm backward's column
    partials (its dgamma / dbeta summation) and the bias-GELU backward's
    grid do not move at any grid value; BERT's 16384 x 768 LayerNorm
    plans move at none."""
    f32 = torch.float32

    def plans():
        return {"ln_fwd_block": KN.ln_fwd_plan(2048, 16384, f32),
                "ln_fwd_bert": KN.ln_fwd_plan(16384, 768, f32),
                "ln_bwd_block": KN.ln_bwd_plan(512, 4096, f32),
                "ln_bwd_bert": KN.ln_bwd_plan(16384, 768, f32),
                "bg_bwd": KN.bg_bwd_plan(4096, 3072, f32),
                "decode": KR.rnn_decode_plan(8, 650, "lstm", f32)}

    ref = plans()
    assert ref["ln_fwd_block"]["branch"] == "block"
    assert ref["decode"]["path"] == "tma"
    moved = set()
    for budget in K.SMEM_BUDGET_GRID[1:]:
        with tspace.trial({"kernels.vmem_tile_budget": budget}):
            got = plans()
            assert K.plan_limits()[1] == budget
        moved |= {k for k in ref if got[k] != ref[k]}
        for k in ("ln_fwd_bert", "ln_bwd_block", "ln_bwd_bert", "bg_bwd"):
            assert got[k] == ref[k], (k, budget)
    assert moved == {"ln_fwd_block", "decode"}
    with tspace.trial({"kernels.vmem_tile_budget": 64 * 1024}):
        assert KR.rnn_decode_plan(8, 650, "lstm", f32)["path"] == "staged"
