"""The port's continuous-batching decode engine on the CPU: scheduling
(join and leave between steps, EOS, deadlines, drain and close, KV
exhaustion, oversized requests), streams on an injected clock, and
``run_decode``'s tokens against the JAX package's engine: continuous,
static, speculative with prefix sharing, and the GQA decoder. Tokens are
compared exactly; the JAX engine runs under ``MXNET_PALLAS=off``, whose
step the interpret-mode test of ``tests/test_torch_decode.py`` ties to
the Pallas kernel.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu import serving as JS
from mxnet_tpu.gluon import GQADecoder as JGQADecoder
from mxnet_tpu.serving import loadgen as jloadgen

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.engine import DispatchWindow
from mxnet_tpu_torch.gluon import GQADecoder
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.serving import (DecodeEngine, DeadlineExceeded,
                                     Overloaded, ServingShutdown,
                                     TinyDecoder, loadgen)

VOCAB = 48


@pytest.fixture(scope="module")
def model():
    return TinyDecoder(vocab=VOCAB, d_model=32, num_heads=2, seed=0,
                       device="cpu")


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


def make_engine(model, **kw):
    kw.setdefault("ladder", (1, 2))
    kw.setdefault("page_size", 4)
    kw.setdefault("max_context", 32)
    kw.setdefault("start", False)
    return DecodeEngine(model, **kw)


def drive(eng, max_iters: int = 300) -> int:
    it = 0
    while it < max_iters:
        did = eng.step_once()
        eng.sync()
        if not did and eng._idle():
            return it
        it += 1
    raise AssertionError(f"engine did not go idle in {max_iters} iters")


def prompt(seed: int, n: int, vocab: int = VOCAB):
    return onp.random.RandomState(seed).randint(0, vocab, size=n).astype(
        onp.int32)


# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------

def test_env_settings(monkeypatch):
    monkeypatch.setenv("MXNET_DECODE_SLOTS", "2, 8,4")
    assert serving.slot_ladder() == (2, 4, 8)
    monkeypatch.setenv("MXNET_DECODE_SLOTS", "garbage")
    assert serving.slot_ladder() == serving.decode.DECODE_SLOT_LADDER
    monkeypatch.setenv("MXNET_DECODE_KV_PAGE_SIZE", "8")
    monkeypatch.setenv("MXNET_DECODE_PREFILL_CHUNK", "32")
    monkeypatch.setenv("MXNET_DECODE_SPEC_K", "3")
    monkeypatch.setenv("MXNET_DECODE_PREFIX_SHARE", "0")
    assert serving.kv_page_size() == 8 and serving.prefill_chunk() == 32
    assert serving.spec_k() == 3 and serving.prefix_share() is False
    monkeypatch.setenv("MXNET_DECODE_SPEC_K", "x")
    assert serving.spec_k() == serving.decode.SPEC_K
    monkeypatch.setenv("MXNET_SERVING_DEADLINE_MS", "250")
    monkeypatch.setenv("MXNET_SERVING_QUEUE_DEPTH", "7")
    monkeypatch.setenv("MXNET_SERVING_SHED", "bogus")
    assert serving.default_deadline_ms() == 250.0
    assert serving.queue_depth() == 7 and serving.shed_mode() == "deadline"


def test_engine_reads_spec_env(monkeypatch, model):
    monkeypatch.setenv("MXNET_DECODE_SPEC_K", "3")
    monkeypatch.setenv("MXNET_DECODE_PREFIX_SHARE", "0")
    eng = make_engine(model)
    try:
        assert eng._spec_k == 3 and eng._prefix_share is False
        assert isinstance(eng._drafter, serving.NgramDrafter)
    finally:
        eng.close()


def test_overloaded_reason_defaults_to_queue():
    e = Overloaded("full")
    assert e.reason == "queue" and isinstance(e, mxt.MXNetError)
    assert Overloaded("x", reason="kvcache").reason == "kvcache"


# ---------------------------------------------------------------------------
# scheduling on an injected clock
# ---------------------------------------------------------------------------

def test_join_leave_between_steps(model):
    clk = FakeClock()
    eng = make_engine(model, clock=clk)
    try:
        sa = eng.submit(prompt(1, 3), max_new=6)
        sb = eng.submit(prompt(2, 2), max_new=2)
        sc = eng.submit(prompt(3, 2), max_new=3)
        eng.step_once()
        assert [o is not None for o in eng._occupant] == [True, True]
        assert len(eng._queue) == 1
        joined_at = None
        for it in range(60):
            clk.advance(0.001)
            did = eng.step_once()
            eng.sync()
            occ = [getattr(o, "seq", None) for o in eng._occupant]
            if joined_at is None and 2 in occ:
                joined_at = it
                assert sb.done       # C sits in B's freed slot
            if not did and eng._idle():
                break
        assert joined_at is not None, "queued request never joined"
        assert [len(s.result(0)) for s in (sa, sb, sc)] == [6, 2, 3]
        assert eng.stats["completed"] == 3
        assert eng.kv.used_pages() == 0 and eng.kv.free_pages() > 0
    finally:
        eng.close()


def test_fake_clock_ttft_and_stream_record(model):
    clk = FakeClock(t=50.0)
    eng = make_engine(model, ladder=(1,), clock=clk)
    try:
        s = eng.submit(prompt(4, 2), max_new=3)
        while not s.done:
            clk.advance(0.25)
            eng.step_once()
            eng.sync()
        rec = s.record()
        assert rec["outcome"] == "ok" and rec["tokens"] == 3
        assert rec["ttft_s"] == pytest.approx(0.25)
        assert rec["tpot_s"] == pytest.approx([0.25, 0.25])
        assert s.ttft_s == pytest.approx(0.25)
        toks = s.result(0)
        assert [t for t in s] == toks and s.next_token(0) is None
    finally:
        eng.close()


def test_eos_frees_slot_early(model):
    eng = make_engine(model, ladder=(1,))
    try:
        s = eng.submit(prompt(6, 3), max_new=20)
        drive(eng)
        tok0 = s.result(0)[0]
        s2 = eng.submit(prompt(6, 3), max_new=20, eos=int(tok0))
        drive(eng)
        assert s2.result(0) == [tok0]
        assert eng.kv.used_pages() == 0
    finally:
        eng.close()


def test_deadline_miss_is_typed(model):
    clk = FakeClock()
    eng = make_engine(model, ladder=(1,), clock=clk)
    try:
        s = eng.submit(prompt(7, 2), max_new=8, deadline_ms=100.0)
        clk.advance(10.0)
        drive(eng)
        with pytest.raises(DeadlineExceeded):
            s.result(0)
        assert eng.stats["deadline_missed"] == 1
        assert eng.kv.used_pages() == 0
    finally:
        eng.close()


def test_midstream_deadline_shed_frees_pages(model):
    clk = FakeClock()
    eng = make_engine(model, ladder=(1,), clock=clk)
    try:
        s = eng.submit(prompt(8, 2), max_new=12, deadline_ms=1000.0)
        for _ in range(4):           # first token, then 0.2 s gaps
            clk.advance(0.2)
            eng.step_once()
            eng.sync()
        drive(eng)
        with pytest.raises(DeadlineExceeded, match="mid-flight"):
            s.result(0)
        assert eng.stats["shed_midstream"] == 1
        assert eng.kv.used_pages() == 0
    finally:
        eng.close()


def test_drain_sheds_then_close_is_shutdown(model):
    eng = make_engine(model, ladder=(1,))
    try:
        s = eng.submit(prompt(8, 2), max_new=2)
        assert eng.drain()
        assert s.result(0) and s.done
        with pytest.raises(Overloaded) as ei:
            eng.submit(prompt(8, 2))
        assert ei.value.reason == "draining"
    finally:
        eng.close()
    with pytest.raises(ServingShutdown):
        eng.submit(prompt(8, 2))


def test_close_fails_pending_requests_typed(model):
    eng = make_engine(model, ladder=(1,))
    s = eng.submit(prompt(9, 3), max_new=5)
    eng.close()
    with pytest.raises(ServingShutdown):
        s.result(0)


def test_kv_exhaustion_sheds_typed_overloaded(model):
    eng = make_engine(model, ladder=(1, 2), num_pages=4, depth=8)
    try:
        s = eng.submit(prompt(40, 3), max_new=6)     # needs 3 pages
        with pytest.raises(Overloaded) as ei:
            eng.submit(prompt(41, 3), max_new=6)
        assert ei.value.reason == "kvcache"
        assert eng.stats["rejected"] == 1
        drive(eng)
        assert len(s.result(0)) == 6
        s2 = eng.submit(prompt(41, 3), max_new=6)
        drive(eng)
        assert len(s2.result(0)) == 6
    finally:
        eng.close()


def test_queue_depth_sheds_with_reason_queue(model):
    eng = make_engine(model, depth=1)
    try:
        eng.submit(prompt(43, 2), max_new=2)
        with pytest.raises(Overloaded) as ei:
            eng.submit(prompt(44, 2), max_new=2)
        assert ei.value.reason == "queue"
    finally:
        eng.close()


def test_oversized_request_is_an_error_not_a_shed(model):
    eng = make_engine(model, max_context=8)
    try:
        with pytest.raises(mxt.MXNetError, match="max_context") as ei:
            eng.submit(prompt(42, 6), max_new=6)     # 6+6+1 > 8
        assert not isinstance(ei.value, Overloaded)
        with pytest.raises(mxt.MXNetError, match=">= 1 token"):
            eng.submit([], max_new=2)
    finally:
        eng.close()


def test_chunked_prefill_never_starves_decode(model, monkeypatch):
    monkeypatch.setenv("MXNET_DECODE_PREFILL_CHUNK", "4")
    eng = make_engine(model, ladder=(2,))
    kinds = []
    real_pre, real_dec = eng._dispatch_prefill, eng._dispatch_decode

    def spy_pre(slot):
        dec_ready = [s for s in range(eng.slots)
                     if eng._occupant[s] is not None
                     and eng._occupant[s].phase == "decode"]
        kinds.append(("prefill", bool(dec_ready)))
        return real_pre(slot)

    def spy_dec(slots):
        kinds.append(("decode", True))
        return real_dec(slots)

    eng._dispatch_prefill, eng._dispatch_decode = spy_pre, spy_dec
    try:
        s_short = eng.submit(prompt(30, 2), max_new=8)
        s_long = eng.submit(prompt(31, 12), max_new=2)
        drive(eng)
        assert len(s_short.result(0)) == 8 and len(s_long.result(0)) == 2
        assert eng.stats["prefill_chunks"] == 1 + 3
        for i in range(1, len(kinds)):
            if kinds[i][0] == "prefill" and kinds[i][1]:
                assert kinds[i - 1][0] != "prefill"
    finally:
        eng.close()


def test_threaded_engine_serves_and_warmup_counts(model):
    eng = make_engine(model, ladder=(1, 2), start=True, depth=16)
    try:
        warm = eng.warmup()
        assert set(warm) == {("decode", 1), ("decode", 2), ("prefill", 1),
                             ("prefill", 2)}
        streams = [eng.submit(prompt(60 + i, 3), max_new=3)
                   for i in range(4)]
        assert [len(s.result(30.0)) for s in streams] == [3, 3, 3, 3]
        assert eng.drain(30.0)
    finally:
        eng.close()


def test_dispatch_window_names_the_faulting_step():
    def sync(payload):
        if payload == "bad":
            raise RuntimeError("device fault")

    win = DispatchWindow(max_inflight=1, sync_fn=sync, what="decode step")
    win.push("ok", tag="decode#1")
    win.push("bad", tag="decode#2")          # retires decode#1
    with pytest.raises(mxt.MXNetError, match="decode#2.*device fault"):
        win.drain()
    assert win.stats["errors"] == 1 and len(win) == 0
    win.push("x", tag="t")
    assert win.abandon() == ["t"] and len(win) == 0


def test_engine_failure_fails_every_stream(model):
    eng = make_engine(model, ladder=(1, 2))
    try:
        streams = [eng.submit(prompt(70 + i, 2), max_new=4)
                   for i in range(3)]

        def broken(*a, **k):
            raise mxt.MXNetError("dispatch broke")

        eng._dispatch_prefill = broken
        assert eng.step_once() is False
        for s in streams:
            with pytest.raises(mxt.MXNetError, match="dispatch broke"):
                s.result(0)
        with pytest.raises(ServingShutdown):
            eng.submit(prompt(1, 2))
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# run_decode against the JAX engine
# ---------------------------------------------------------------------------

def _jax_tokens(model, prompts, mns, ladder, page_size, **kw):
    """The JAX engine driven exactly as its ``run_decode`` drives it,
    returning each request's tokens."""
    sk = kw.get("spec_k") or 0
    slack = 1 + sk
    mc = max(p.size + m + slack for p, m in zip(prompts, mns))
    tot = 1 + sum(JS.pages_needed(p.size + m + slack, page_size)
                  for p, m in zip(prompts, mns))
    eng = JS.DecodeEngine(model, ladder=ladder, num_pages=tot,
                          page_size=page_size, max_context=mc,
                          depth=len(prompts) + 1, start=False, **kw)
    try:
        streams = [eng.submit(p, max_new=m) for p, m in zip(prompts, mns)]
        eng.drain()
        return [s.result(0) for s in streams]
    finally:
        eng.close()


def _mix(vocab=64, n=12):
    rng = onp.random.RandomState(7)
    prompts, mns = [], []
    for i in range(n):
        prompts.append(rng.randint(0, vocab, size=int(rng.randint(2, 12)))
                       .astype(onp.int32))
        mns.append(16 if i % 8 == 0 else int(rng.randint(2, 6)))
    return prompts, mns


@pytest.fixture(scope="module")
def models64():
    return (JS.TinyDecoder(vocab=64, d_model=32, num_heads=2, seed=0),
            TinyDecoder(vocab=64, d_model=32, num_heads=2, seed=0,
                        device="cpu"))


@pytest.mark.parametrize("static", [False, True])
def test_run_decode_tokens_vs_jax(models64, static, monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "off")
    jm, tm = models64
    prompts, mns = _mix()
    ref = _jax_tokens(jm, prompts, mns, (1, 2, 4), 8, static=static)
    rep = serving.run_decode(tm, prompts, mns, ladder=(1, 2, 4),
                             page_size=8, static=static)
    assert rep["tokens_by_request"] == ref
    assert rep["mode"] == ("static" if static else "continuous")
    assert rep["errors"] == 0 and rep["tokens"] == sum(mns)
    # the CPU launches no kernel; the rnn_decode count stays 0
    assert rep["launches"]["rnn_decode"] == 0
    for key in ("ttft_p50_ms", "tpot_p99_ms", "decode_tokens_per_sec"):
        assert rep[key] is not None
    assert 0 < rep["kv_page_util"] <= 1.0


def test_run_decode_speculative_with_sharing_vs_jax(models64, monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "off")
    jm, tm = models64
    rng = onp.random.RandomState(8)
    base = rng.randint(0, 64, size=24).astype(onp.int32)
    prompts = [onp.concatenate([base, rng.randint(0, 64, size=2 + i % 3)
                                .astype(onp.int32)]) for i in range(8)]
    mns = [12] * 8
    ref = _jax_tokens(jm, prompts, mns, (1, 2, 4), 8, spec_k=4,
                      prefix_share=True)
    greedy = serving.run_decode(tm, prompts, mns, ladder=(1, 2, 4),
                                page_size=8, spec_k=0, prefix_share=False)
    spec = serving.run_decode(tm, prompts, mns, ladder=(1, 2, 4),
                              page_size=8, spec_k=4, prefix_share=True)
    assert spec["tokens_by_request"] == ref == greedy["tokens_by_request"]
    assert spec["spec_steps"] > 0 and spec["prefix_hits"] > 0
    assert spec["acceptance_rate"] is not None
    assert spec["tokens_per_step"]["mean"] > 1.0


def test_run_decode_gqa_vs_jax(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "off")
    kw = dict(vocab=64, d_model=32, num_heads=4, num_kv_heads=2,
              num_layers=2, seed=1)
    prompts, mns = _mix(n=6)
    ref = _jax_tokens(JGQADecoder(**kw), prompts, mns, (1, 2, 4), 8)
    model = GQADecoder(**kw, device="cpu")
    rep = serving.run_decode(model, prompts, mns, ladder=(1, 2, 4),
                             page_size=8)
    assert rep["tokens_by_request"] == ref
    spec = serving.run_decode(model, prompts, mns, ladder=(1, 2, 4),
                              page_size=8, spec_k=3, prefix_share=True)
    assert spec["tokens_by_request"] == ref


def test_gqa_engine_sizes_cache_by_kv_heads():
    model = GQADecoder(vocab=VOCAB, d_model=16, num_heads=4, num_kv_heads=2,
                       num_layers=2, seed=1, device="cpu")
    eng = make_engine(model)
    try:
        assert eng.kv.num_heads == 2 and eng.kv.num_layers == 2
        assert tuple(eng._h.shape) == (eng.slots, 1)
    finally:
        eng.close()
    with pytest.raises(mxt.MXNetError, match="multiple"):
        GQADecoder(d_model=32, num_heads=4, num_kv_heads=3, device="cpu")
    with pytest.raises(mxt.MXNetError, match="divisible"):
        GQADecoder(d_model=30, num_heads=4, num_kv_heads=2, device="cpu")


def test_models_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="no CUDA device"):
        TinyDecoder(vocab=8, d_model=4, num_heads=2)
    with pytest.raises(mxt.MXNetError, match="no CUDA device"):
        GQADecoder(vocab=8, d_model=8, num_heads=2, num_kv_heads=1)


def test_launch_counts_include_rnn_decode():
    K.reset_launch_counts()
    assert K.launch_counts()["rnn_decode"] == 0
    assert K.KERNELS["rnn_decode"].replaces == \
        "mxnet_tpu/ops/kernels/rnn_scan.py:486 (_decode_kernel)"


# ---------------------------------------------------------------------------
# streaming summary
# ---------------------------------------------------------------------------

def test_streaming_summary_vs_jax():
    recs = [{"tokens": 3, "ttft_s": 0.010, "tpot_s": [0.002, 0.003],
             "step_tokens": [1, 2], "spec_drafted": 4, "spec_accepted": 1},
            {"tokens": 2, "ttft_s": 0.030, "tpot_s": [0.004],
             "step_tokens": [2], "spec_drafted": 2, "spec_accepted": 1},
            {"tokens": 0, "ttft_s": None, "tpot_s": []}, "not a record"]
    got = loadgen.streaming_summary(recs, wall=0.5)
    ref = jloadgen.streaming_summary(recs, wall=0.5)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            assert got[k] == pytest.approx(v, abs=1e-3)
        else:
            assert got[k] == pytest.approx(v, abs=1e-3)
    assert loadgen.streaming_summary([], None)["tokens_per_sec"] is None
