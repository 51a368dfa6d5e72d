"""The port's memory observability (``telemetry/memory.py``) against the
JAX package's: ``parse_budget`` on every form, the budget watchdog's
episodes, the buffer census (weakrefs, pools, precedence, the bytes each
buffer is priced at), the OOM forensics (one anomaly however many seams,
the dump's schema, the sizing hints' ranking) and ``memory_summary``'s
CPU fallback; then the census as the port's modules fill it: the
optimizer state, the prefetcher's staged batches (released on an early
break and on an error), a checkpoint capture and the KV cache's pools.
Equal means equal (these are integers and strings).
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import TrainLoop as TTrainLoop
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.data.prefetcher import DevicePrefetcher
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.telemetry import memory as tmem
from mxnet_tpu_torch.telemetry import names as tnames


@pytest.fixture(autouse=True)
def _fresh():
    ttel.reset()
    tmem.census().clear()
    yield
    ttel.reset()
    tmem.census().clear()


def _jmem():
    from mxnet_tpu.telemetry import memory as jmem
    return jmem


def test_parse_budget_forms_equal_jax():
    jmem = _jmem()
    for v in ("8589934592", "28g", "28G", "500MB", "500mb", "1.5k", "2t",
              "0.9", "0.5", "0", "-3", "", "  ", "garbage", "12q", "1b",
              "3KB", "1e9"):
        for cap in (None, 80 << 30):
            assert tmem.parse_budget(v, cap) == jmem.parse_budget(v, cap), \
                (v, cap)


def test_device_bytes_and_census_pools():
    jmem = _jmem()
    for shape, dt in (((3, 5), "float32"), ((7,), "int64"), ((), "int32"),
                      ((2, 4, 8), "float16")):
        a = onp.zeros(shape, dt)
        assert tmem.device_bytes(torch.from_numpy(a)) == \
            jmem.device_bytes(a) == a.nbytes
    assert tmem.device_bytes(torch.zeros(4, 3, dtype=torch.bfloat16)) == 24
    c = tmem.census()
    w = torch.zeros(10, 10)
    s = torch.zeros(10, 10)
    assert c.register("params", w) and c.register("optimizer", s)
    assert c.register("optimizer", w)     # params wins: counted once
    view = w.view(100)                    # the same buffer, another object
    assert c.register("ndarray", view)
    by = c.live_bytes_by_pool()
    assert by["params"] == 400 and by["optimizer"] == 400
    assert by["ndarray"] == 0
    assert set(by) == set(tmem.POOLS) == set(_jmem().POOLS)
    assert c.buffers()[0]["bytes"] == 400
    with pytest.raises(mxt.MXNetError):
        c.register("heap", w)
    del s
    assert c.live_bytes_by_pool()["optimizer"] == 0   # weakref released
    del w, view
    assert c.live_bytes_by_pool()["params"] == 0


def test_census_publish_and_reconcile_on_cpu():
    keep = torch.zeros(256)
    tmem.census().register("params", keep)
    untracked = torch.ones(1000)
    rec = tmem.census().reconcile()
    assert rec["by_pool"]["params"] == 1024
    assert rec["untracked"]["bytes"] >= untracked.numel() * 4
    snap = ttel.snapshot()
    assert snap["gauges"][tnames.MEM_POOL_BYTES]["params"] == 1024
    assert snap["gauges"][tnames.MEM_UNTRACKED_BYTES] >= 4000


def test_memory_summary_cpu_fallback_documented_not_silent():
    """The JAX test of the same name: every device reports the four keys;
    on the CPU the live-arrays fallback prices what is alive, and the
    gauges carry the same numbers."""
    keep = torch.zeros(256)
    out = tprof.memory_summary()
    assert out
    for dev, s in out.items():
        assert set(s) == {"bytes_in_use", "peak_bytes_in_use",
                          "bytes_limit", "source"}
        assert s["source"] == "live_arrays"
        assert s["peak_bytes_in_use"] is None and s["bytes_limit"] is None
        assert s["bytes_in_use"] >= keep.numel() * 4
        assert ttel.registry().gauge(tnames.MEM_DEVICE_IN_USE).value(dev) \
            == s["bytes_in_use"]
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        tprof.dump_memory("x.json")


def test_budget_one_anomaly_per_episode_like_jax(monkeypatch):
    """The census accounting (the CPU has no allocator) over and under
    the budget, through both packages' watchdogs: one memory_budget
    anomaly per over-budget episode, at the same steps."""
    from mxnet_tpu import nd
    from mxnet_tpu import telemetry as jtel
    jmem = _jmem()
    jtel.reset()
    jmem.census().clear()
    monkeypatch.setenv("MXNET_MEMORY_BUDGET", "1000")
    assert tmem.maybe_check_budget(step=0)["over"] is False
    held_t, held_j = [], []
    for step, n in enumerate((100, 200, 0, -1, 200, 50, -2, -1)):
        if n > 0:
            held_t.append(torch.zeros(n))
            held_j.append(nd.array(onp.zeros(n, "float32")))
            tmem.census().register("params", held_t[-1])
            jmem.census().register("params", held_j[-1])
        elif n < 0:
            held_t = held_t[:n]
            held_j = held_j[:n]
        rt = tmem.maybe_check_budget(step=step + 1)
        rj = jmem.maybe_check_budget(step=step + 1)
        assert (rt["in_use"], rt["over"], rt["source"]) == \
            (rj["in_use"], rj["over"], rj["source"]), step
    ev_t = [(e["kind"], e["step"]) for e in ttel.watchdog().anomalies()]
    ev_j = [(e["kind"], e["step"]) for e in jtel.watchdog().anomalies()]
    assert ev_t == ev_j == [("memory_budget", 2), ("memory_budget", 5)]
    assert ttel.value(tnames.MEM_BUDGET_BYTES) == 1000
    monkeypatch.delenv("MXNET_MEMORY_BUDGET")
    assert tmem.maybe_check_budget() is None
    jtel.reset()
    jmem.census().clear()


def test_budget_checked_at_the_window_retire(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_MEMORY_BUDGET", "100")
    keep = torch.zeros(64)
    tmem.census().register("params", keep)
    w = tengine.DispatchWindow(lambda p: None, max_inflight=0)
    for i in range(4):
        w.push(None, tag=i)
    ev = ttel.watchdog().anomalies("memory_budget")
    assert [e["step"] for e in ev] == [0]
    assert "largest pool: params (256 B)" in ev[0]["message"]


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

def _oom():
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")


def test_is_resource_exhausted_matches_the_chain():
    assert tmem.is_resource_exhausted(_oom())
    try:
        try:
            raise _oom()
        except Exception as e:
            raise mxt.MXNetError("replay of x failed") from e
    except mxt.MXNetError as wrapped:
        assert tmem.is_resource_exhausted(wrapped)
    assert not tmem.is_resource_exhausted(ValueError("shape mismatch"))
    assert tmem.is_resource_exhausted(
        RuntimeError("RESOURCE_EXHAUSTED: out of memory"))


def test_oom_dump_schema_single_event_and_reraise(tmp_path, monkeypatch):
    """An allocation failure through three nested seams: ONE oom anomaly,
    ONE atomic dump whose schema is the JAX dump's (plus the largest
    pool's name), the error re-raised unchanged at each seam."""
    monkeypatch.setenv("MXNET_MEMORY_DUMP_DIR", str(tmp_path))
    keep = torch.zeros(1000)
    tmem.census().register("optimizer", keep)
    err = _oom()
    with pytest.raises(torch.cuda.OutOfMemoryError) as got:
        with tmem.oom_guard("outer", step=3):
            with tmem.oom_guard("middle", step=3):
                with tmem.oom_guard("inner", step=3):
                    raise err
    assert got.value is err
    ev = ttel.watchdog().anomalies("oom")
    assert len(ev) == 1 and ev[0]["step"] == 3
    assert "largest pool: optimizer" in ev[0]["message"]
    files = list(tmp_path.glob("mx_oom_*.json"))
    assert len(files) == 1 and not list(tmp_path.glob("*.tmp"))
    d = json.load(open(files[0]))
    jkeys = {"schema_version", "time_unix", "seam", "step", "error",
             "budget_bytes", "device_stats", "live_bytes_by_pool",
             "untracked", "top_buffers", "compiled", "hints"}
    assert set(d) == jkeys | {"largest_pool"}
    assert d["schema_version"] == tmem.DUMP_SCHEMA_VERSION == \
        _jmem().DUMP_SCHEMA_VERSION
    assert d["seam"] == "inner" and d["largest_pool"] == "optimizer"
    assert d["live_bytes_by_pool"]["optimizer"] == 4000
    assert set(d["untracked"]) == {"count", "bytes", "top"}
    assert d["top_buffers"][0]["bytes"] == 4000
    assert ttel.value(tnames.OOM_DUMPS) == 1
    assert tmem.maybe_record_oom(ValueError("no"), "x") is None
    assert len(ttel.watchdog().anomalies("oom")) == 1


def test_sizing_hints_rank_what_dominates_like_jax():
    """The same pools give hints on the same knobs in the same order (the
    port's texts name its own settings)."""
    jmem = _jmem()
    topics = (("ZeRO", "zero"), ("prefetch", "prefetch"),
              ("checkpoint", "checkpoint"))

    def order(hints):
        out = []
        for h in hints:
            for key, name in topics:
                if key in h:
                    out.append(name)
        return out

    for pools in ({"optimizer": 800, "params": 400},
                  {"prefetch": 10, "params": 100},
                  {"optimizer": 100, "params": 400, "checkpoint": 5},
                  {"optimizer": 900, "params": 100, "prefetch": 1,
                   "checkpoint": 1}):
        assert order(tmem._sizing_hints(pools, {}, None)) == \
            order(jmem._sizing_hints(pools, {}, None)), pools
    assert tmem._sizing_hints({}, {}, None)


def test_memory_report_fields_absent_not_invented():
    r = tmem.MemoryReport(argument_bytes=100, output_bytes=20,
                          temp_bytes=300)
    assert r.absent == ["generated_code_bytes", "donated_bytes"]
    assert r.peak_bytes == 420
    m = tmem.MemoryReport.merge([r, tmem.MemoryReport(10, 50, 5)])
    assert (m.argument_bytes, m.output_bytes, m.temp_bytes) == (100, 50, 300)
    assert m.generated_code_bytes is None
    d = m.to_dict()
    assert set(_jmem().MemoryReport.FIELDS) <= set(d)
    assert d["absent"] == ["generated_code_bytes", "donated_bytes"]


# ---------------------------------------------------------------------------
# the census as the port's modules fill it
# ---------------------------------------------------------------------------

def _net():
    torch.manual_seed(0)
    return torch.nn.Sequential(Dense(8, in_units=4, activation="relu",
                                     device="cpu"),
                               Dense(3, in_units=8, device="cpu"))


def _xy():
    r = onp.random.RandomState(0)
    return torch.from_numpy(r.randn(8, 4).astype("f4")), \
        torch.from_numpy(r.randint(0, 3, (8,)).astype("f4"))


def test_optimizer_state_bytes_agree_with_the_census():
    net = _net()
    tr = TTrainer(dict(net.named_parameters()), "adam",
                  {"learning_rate": 0.1})
    lb = tloss.SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    step(*_xy())
    by = tmem.census().live_bytes_by_pool()
    n = sum(p.numel() for p in net.parameters())
    assert by["params"] == 4 * n
    assert step.optimizer_state_bytes() == by["optimizer"] == 2 * 4 * n


def test_prefetcher_stages_into_the_pool_and_releases_it():
    x, y = _xy()

    def source():
        for _ in range(6):
            yield x.clone(), y.clone()

    pf = DevicePrefetcher(source(), depth=2, device="cpu")
    it = iter(pf)
    first = next(it)
    assert tmem.census().live_bytes_by_pool()["prefetch"] >= \
        (x.numel() + y.numel()) * 4
    it.close()              # an early break
    del first
    import gc
    gc.collect()
    assert tmem.census().live_bytes_by_pool()["prefetch"] == 0
    assert pf.staged_alive() == 0

    def failing():
        yield x.clone(), y.clone()
        raise OSError("disk gone")

    pf = DevicePrefetcher(failing(), depth=2, device="cpu")
    with pytest.raises(OSError):
        for b in pf:
            del b           # the consumer lets each batch go
    gc.collect()
    assert tmem.census().live_bytes_by_pool()["prefetch"] == 0
    assert ttel.value(tnames.PREFETCH_BATCHES) == 2


def test_checkpoint_capture_lands_in_its_pool(tmp_path):
    net = _net()
    tr = TTrainer(dict(net.named_parameters()), "sgd",
                  {"learning_rate": 0.1, "momentum": 0.9})
    loop = TTrainLoop(net, tr, tloss.SoftmaxCrossEntropyLoss(),
                      checkpoint_dir=str(tmp_path))
    loop.step(*_xy())
    loop.synchronize()
    state = loop.checkpoint_manager.save(1, trainer=tr, net=net, block=True)
    by = tmem.census().live_bytes_by_pool()
    assert by["checkpoint"] == sum(a.nbytes for a in state.arrays.values())
    assert ttel.value(tnames.CHECKPOINT_SAVES) == 1
    assert ttel.value(tnames.CHECKPOINT_CAPTURE_SECONDS) == 1
    del state
    assert tmem.census().live_bytes_by_pool()["checkpoint"] == 0


def test_kvcache_pools_in_the_census_at_their_bytes():
    from mxnet_tpu_torch.serving.kvcache import PagedKVCache
    kv = PagedKVCache(2, 2, 8, 9, 4, dtype="float32", device="cpu")
    by = tmem.census().live_bytes_by_pool()
    assert by["kvcache"] == kv.total_bytes() == \
        tmem.device_bytes(kv.k_pages) + tmem.device_bytes(kv.v_pages)
    pages = kv.alloc("a", 3)
    assert ttel.registry().gauge(tnames.DECODE_KV_PAGES).value("used") == 3
    kv.share("b", pages[:1])
    kv.cow("b", pages[0])
    assert ttel.value(tnames.DECODE_COW_COPIES) == 1
    assert ttel.value(tnames.DECODE_PREFIX_HITS) == 1
    del kv
    assert tmem.census().live_bytes_by_pool()["kvcache"] == 0
