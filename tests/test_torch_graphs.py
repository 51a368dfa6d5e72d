"""The port's captured programs (``serving/captured.py``) on the CPU: one
program per signature for ``CompiledPredictor`` and ``DecodeEngine``,
the counterpart of the JAX package's AOT-compiled buckets.

- The reference's trace-count contracts, held side by side with the JAX
  package: the predictor's ``n_traces`` after warm-up and traffic at
  every bucket, and one trace per distinct bucket without warm-up
  (``tests/test_serving.py``); the engine's ``warmup()`` keys and 0 live
  traces (``tests/test_decode.py``, ``tests/test_decode_spec.py``).
- The static-buffer path's tokens against the JAX engine's for
  continuous, static, speculative and GQA runs after a warm-up, with a
  deeper dispatch window (tokens: exact; the JAX engine under
  ``MXNET_PALLAS=off``, as ``tests/test_torch_decode_engine.py`` runs
  it), and the predictor's outputs against the JAX predictor's (float32:
  1e-5, sums in another order).
- Outputs survive later dispatches of the same program: a program whose
  body writes one static output buffer, as a graph replay does, still
  hands back each run's own values; a micro-batch's outputs and a decode
  step's retired tokens are unchanged after three more dispatches.
- Parameters moved after a capture are captured again (one more trace);
  weights copied in place are read by the same program.
- The launch-delta accounting: a capture records what its thread's
  wrappers count, and each replay adds it once (through
  ``ops.kernels.record_launches`` / ``add_launches`` and a stand-in
  graph, no card).
"""
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as JS
from mxnet_tpu.gluon import GQADecoder as JGQADecoder
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon import GQADecoder
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.serving import DecodeEngine, TinyDecoder
from mxnet_tpu_torch.serving.captured import CapturedProgram, Programs

IN, HIDDEN, CLASSES = 16, 32, 4
BUCKETS = (1, 2, 4, 8)
VOCAB = 64


def jax_net():
    onp.random.seed(7)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(HIDDEN, activation="relu", in_units=IN),
            jnn.Dense(CLASSES, in_units=HIDDEN))
    net.initialize()
    net(mx.nd.array(onp.zeros((1, IN), "float32")))
    return net


def torch_net(jnet):
    """The port's copy of ``jnet`` (same weights, in order)."""
    net = torch.nn.Sequential(
        tnn.Dense(HIDDEN, activation="relu", in_units=IN, device="cpu"),
        tnn.Dense(CLASSES, in_units=HIDDEN, device="cpu"))
    with torch.no_grad():
        for p, a in zip(net.parameters(), jnet.collect_params().values()):
            p.copy_(torch.from_numpy(onp.asarray(a.data().asnumpy())))
    return net


def rows(n, seed=0):
    return onp.random.RandomState(seed).randn(n, IN).astype("float32")


@pytest.fixture
def preds():
    jnet = jax_net()
    return (JS.CompiledPredictor(jnet, bucket_sizes=BUCKETS),
            serving.CompiledPredictor(torch_net(jnet), bucket_sizes=BUCKETS,
                                      device="cpu"))


# ---------------------------------------------------------------------------
# the predictor's contracts, side by side with the JAX package
# ---------------------------------------------------------------------------

def test_warmup_captures_every_bucket_then_traffic_captures_nothing(preds):
    jp, tp = preds
    jwarm, twarm = jp.warmup(mx.nd.array(rows(1))), tp.warmup(rows(1))
    assert set(twarm) == set(jwarm) == set(BUCKETS)
    assert tp.n_traces == jp.n_traces == 4
    assert tp.service_time_seed_s > 0
    for n in (1, 2, 3, 4, 7, 8):
        x = rows(n, seed=n)
        (jx,), _ = jp.pad_to_bucket(mx.nd.array(x))
        (tx,), valid = tp.pad_to_bucket(x)
        ref = jp.predict(jx).asnumpy()
        got = tp.predict(tx)
        assert got.shape[0] == tp.bucket_for(n) and valid == n
        onp.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert tp.n_traces == jp.n_traces == 4


@pytest.mark.parametrize("sizes", [(1, 1, 2, 2, 4, 1), (8, 3, 8, 1),
                                   (2,)])
def test_one_trace_per_distinct_bucket_without_warmup(preds, sizes):
    jp, tp = preds
    for n in sizes:
        (jx,), _ = jp.pad_to_bucket(mx.nd.array(rows(n)))
        (tx,), _ = tp.pad_to_bucket(rows(n))
        jp.predict(jx)
        tp.predict(tx)
    assert tp.n_traces == jp.n_traces == len({tp.bucket_for(n)
                                              for n in sizes})


def test_aot_compile_captures_once_per_signature(preds):
    _, tp = preds
    (x,), _ = tp.pad_to_bucket(rows(3))
    assert isinstance(tp.aot_compile(x), float)
    tp.aot_compile(x)
    assert tp.n_traces == 1
    # an array and a tensor of one shape and dtype are one signature
    tp.aot_compile(torch.from_numpy(x))
    assert tp.n_traces == 1
    tp.aot_compile(torch.from_numpy(x).double())
    assert tp.n_traces == 2
    tp.predict(x)
    assert tp.n_traces == len(tp._programs) == 2


def test_predict_reads_each_call_into_the_static_inputs(preds):
    _, tp = preds
    tp.warmup(rows(1))
    for seed in (1, 2, 3):
        (x,), _ = tp.pad_to_bucket(rows(4, seed=seed))
        got = tp.predict(x)
        with torch.inference_mode():
            ref = tp.net(torch.from_numpy(x))
        assert torch.equal(got, ref), "a replay must equal the eager net"
    assert tp.n_traces == 4


def test_microbatch_outputs_survive_three_more_dispatches(preds):
    _, tp = preds
    tp.warmup(rows(1))
    with serving.DynamicBatcher(tp, max_batch=4, timeout_ms=1.0,
                                inflight=2, start=False) as b:
        futs = [b.submit(rows(4, seed=s)) for s in range(4)]
        for _ in range(4):
            assert b.process_once(force=True)
        outs = [f.result(10) for f in futs]
    for s, out in enumerate(outs):
        with torch.inference_mode():
            ref = tp.net(torch.from_numpy(rows(4, seed=s)))
        assert torch.equal(out, ref)


def test_moved_parameters_are_captured_again(preds):
    _, tp = preds
    (x,), _ = tp.pad_to_bucket(rows(2))
    before = tp.predict(x)
    assert tp.n_traces == 1
    # new storage (as amp.convert_hybrid_block gives): a new capture
    with torch.no_grad():
        for p in tp.net.parameters():
            p.data = p.data.clone()
    assert torch.equal(tp.predict(x), before)
    assert tp.n_traces == 2
    # weights copied in place: the same program reads them
    with torch.no_grad():
        for p in tp.net.parameters():
            p.mul_(2.0)
    after = tp.predict(x)
    with torch.inference_mode():
        assert torch.equal(after, tp.net(torch.from_numpy(x)))
    assert not torch.equal(after, before) and tp.n_traces == 2


def test_load_jax_params_after_warmup_needs_no_capture():
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    net = tbert.BERTClassifier(tbert.bert_small_test(device="cpu"),
                               num_classes=2, device="cpu")
    load_jax_params(net, init_params_numpy(net, 0))
    pred = serving.CompiledPredictor(net, bucket_sizes=(2,), device="cpu")
    x = onp.random.RandomState(4).randint(0, 128, (2, 12)).astype("int64")
    pred.warmup(x[:1])
    first = pred.predict(x)
    load_jax_params(net, init_params_numpy(net, 1))
    second = pred.predict(x)
    with torch.inference_mode():
        ref = net(torch.from_numpy(x))
    assert torch.equal(second, ref) and not torch.equal(first, second)
    assert pred.n_traces == 1


# ---------------------------------------------------------------------------
# the helper: outputs copied out, launches counted per replay
# ---------------------------------------------------------------------------

class StandInGraph:
    """What a replay does, without a card: the body's work lands in the
    same static output buffer every time."""

    def __init__(self, body, inputs, out):
        self.body, self.inputs, self.out = body, inputs, out
        self.replays = 0
        self.fail = False

    def replay(self):
        if self.fail:
            raise RuntimeError("graph launch failed")
        self.replays += 1
        self.out.copy_(self.body(*self.inputs))


def stand_in_program(static_in, recorded):
    prog = CapturedProgram("stand-in", lambda x: x * 2.0, [static_in],
                           torch.device("cpu"), ())
    prog.outputs = torch.zeros_like(static_in)
    prog.graph = StandInGraph(prog.body, prog.inputs, prog.outputs)
    prog.delta = recorded
    return prog


def test_record_launches_keeps_a_capture_out_of_the_counts():
    K.reset_launch_counts()
    seen = {}

    def other_thread():
        K._count("layernorm_fwd", torch.float32)
        seen["recording"] = K.launch_counts()["layernorm_fwd"]

    with K.record_launches() as delta:
        for _ in range(12):
            K._count("flash_fwd", torch.bfloat16)
        for _ in range(25):
            K._count("layernorm_fwd", torch.float32)
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
    # the other thread counted as before; this one recorded
    assert seen["recording"] == 1
    assert K.launch_counts()["flash_fwd"] == 0
    assert delta == {("flash_fwd", "bfloat16"): 12,
                     ("layernorm_fwd", "float32"): 25}
    for _ in range(3):
        K.add_launches(delta)
    assert K.launch_counts()["flash_fwd"] == 36
    assert K.launch_counts()["layernorm_fwd"] == 76
    assert K.launch_counts_by_dtype() == {
        "flash_fwd": {"bfloat16": 36}, "layernorm_fwd": {"float32": 76}}
    K.reset_launch_counts()


def test_each_replay_counts_its_recorded_launches_once():
    K.reset_launch_counts()
    with K.record_launches() as delta:
        K._count("rnn_decode", torch.float32)
    prog = stand_in_program(torch.ones(3), delta)
    for _ in range(5):
        prog.run()
    assert prog.graph.replays == 5
    assert K.launch_counts()["rnn_decode"] == 5
    assert K.launch_counts_by_dtype()["rnn_decode"] == {"float32": 5}
    K.reset_launch_counts()


def test_outputs_are_copies_that_later_replays_leave_alone():
    static_in = torch.zeros(4)
    prog = stand_in_program(static_in, {})
    outs = []
    for v in (1.0, 2.0, 3.0, 4.0):
        static_in.fill_(v)
        outs.append(prog.run())
    # the static output holds the last replay's values; each copy its own
    assert torch.equal(prog.outputs, torch.full((4,), 8.0))
    for v, out in zip((1.0, 2.0, 3.0, 4.0), outs):
        assert torch.equal(out, torch.full((4,), 2.0 * v))


def test_a_failed_replay_raises_mxnet_error():
    prog = stand_in_program(torch.ones(2), {})
    prog.graph.fail = True
    with pytest.raises(mxt.MXNetError, match="replay of stand-in failed"):
        prog.run()


def test_programs_capture_once_per_key_and_again_after_a_move():
    net = torch.nn.Linear(3, 2)
    progs = Programs(net, "cpu")
    built = []

    def build():
        built.append(1)
        x = torch.ones(1, 3)
        return (lambda t: net(t)), [x]

    a = progs.get("k", build)
    assert progs.get("k", build) is a and len(built) == 1
    progs.get("w", build, count=False)
    assert progs.n_traces == 1 and len(progs) == 2
    ptrs = progs.ptrs()
    net.weight.data = net.weight.data.clone()
    assert progs.ptrs() != ptrs
    b = progs.get("k", build)
    assert b is not a and progs.n_traces == 2 and len(progs) == 2
    progs.clear()
    assert len(progs) == 0


# ---------------------------------------------------------------------------
# the decode engine's contracts, side by side with the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return (JS.TinyDecoder(vocab=VOCAB, d_model=32, num_heads=2, seed=0),
            TinyDecoder(vocab=VOCAB, d_model=32, num_heads=2, seed=0,
                        device="cpu"))


def make_engines(models, **kw):
    kw.setdefault("ladder", (1, 2))
    kw.setdefault("page_size", 4)
    kw.setdefault("max_context", 32)
    kw.setdefault("start", False)
    return JS.DecodeEngine(models[0], **kw), DecodeEngine(models[1], **kw)


def drive(eng, max_iters=300):
    for _ in range(max_iters):
        did = eng.step_once()
        eng.sync()
        if not did and eng._idle():
            return
    raise AssertionError("engine did not go idle")


def prompt(seed, n):
    return onp.random.RandomState(seed).randint(0, VOCAB, size=n).astype(
        onp.int32)


@pytest.mark.parametrize("spec", [0, 2])
def test_engine_warmup_keys_and_no_live_trace(models, spec, monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "off")
    je, te = make_engines(models, spec_k=spec)
    try:
        jkeys, tkeys = set(je.warmup()), set(te.warmup())
        assert tkeys == jkeys
        assert len(tkeys) == 2 * (3 if spec else 2)
        assert te.n_traces == je.n_traces == 0
        got = []
        for eng in (je, te):
            streams = [eng.submit(prompt(60 + i, 3), max_new=6)
                       for i in range(2)]
            drive(eng)
            got.append([s.result(0) for s in streams])
        assert got[0] == got[1] and all(len(t) == 6 for t in got[1])
        assert te.n_traces == je.n_traces == 0
    finally:
        je.close()
        te.close()


def test_engine_unwarmed_traces_each_kind_and_bucket_once(models):
    te = make_engines(models)[1]
    try:
        streams = [te.submit(prompt(70 + i, 3), max_new=3) for i in range(2)]
        drive(te)
        assert all(len(s.result(0)) == 3 for s in streams)
        # decode and prefill, at the buckets the traffic reached
        assert te.n_traces == len(te._programs) <= 4
        n = te.n_traces
        streams = [te.submit(prompt(80 + i, 3), max_new=3) for i in range(2)]
        drive(te)
        assert te.n_traces == n
    finally:
        te.close()


def test_engine_recaptures_after_its_parameters_moved(models):
    model = TinyDecoder(vocab=VOCAB, d_model=32, num_heads=2, seed=0,
                        device="cpu")
    outs = []
    for move in (False, True):
        eng = DecodeEngine(model, ladder=(1, 2), page_size=4, max_context=32,
                           start=False)
        try:
            eng.warmup()
            if move:
                model.w_hh.data = model.w_hh.data.clone()
            s = eng.submit(prompt(5, 4), max_new=5)
            drive(eng)
            outs.append(s.result(0))
            assert eng.n_traces == (2 if move else 0)   # decode + prefill
            assert eng._params["w_hh"] is model.w_hh
        finally:
            eng.close()
    assert outs[0] == outs[1]


def test_stage_packs_one_step_into_the_static_buffer(models):
    te = make_engines(models)[1]
    try:
        prog = te._entry("decode", 2)
        arrays = (onp.array([3, 4]), onp.array([1, 2]),
                  onp.arange(2 * te.max_pages_per_slot).reshape(2, -1),
                  onp.array([5, 6]), onp.array([True, False]))
        te._stage(arrays)
        want = onp.concatenate([onp.asarray(a, onp.int64).ravel()
                                for a in arrays])
        assert (te._staged[:want.size].numpy() == want).all()
        pidx, poff, table, lengths, active = prog.inputs
        assert table.shape == (2, te.max_pages_per_slot)
        assert active.tolist() == [1, 0] and lengths.tolist() == [5, 6]
        # the next step's arrays replace them in the same views
        te._stage([a[::-1] for a in arrays])
        assert active.tolist() == [0, 1] and lengths.tolist() == [6, 5]
    finally:
        te.close()


@pytest.mark.parametrize("owner", ["predictor", "engine"])
def test_programs_do_not_keep_their_owner_alive(models, owner):
    """A warmed owner dropped without ``close()`` is freed at once: no
    program body (nor the dispatch window) holds it in a cycle that only
    the garbage collector would break."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        if owner == "predictor":
            obj = serving.CompiledPredictor(torch_net(jax_net()),
                                            bucket_sizes=BUCKETS,
                                            device="cpu")
            obj.warmup(rows(1))
            obj.predict(obj.pad_to_bucket(rows(3))[0][0])
        else:
            obj = make_engines(models, inflight=2)[1]
            obj.warmup()
            streams = [obj.submit(prompt(90 + i, 3), max_new=4)
                       for i in range(2)]
            drive(obj)
            assert all(len(s.result(0)) == 4 for s in streams)
        assert len(obj._programs) > 0
        ref = weakref.ref(obj)
        del obj
        assert ref() is None
    finally:
        gc.enable()


def _jax_tokens(model, prompts, mns, ladder, page_size, **kw):
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


def _mix(n=10):
    rng = onp.random.RandomState(9)
    prompts = [rng.randint(0, VOCAB, size=int(rng.randint(2, 12)))
               .astype(onp.int32) for _ in range(n)]
    mns = [14 if i % 5 == 0 else int(rng.randint(2, 6)) for i in range(n)]
    return prompts, mns


@pytest.mark.parametrize("run", ["continuous", "static", "speculative",
                                 "gqa"])
def test_static_buffer_tokens_vs_jax_with_a_deep_window(models, run,
                                                        monkeypatch):
    """Tokens exact against the JAX engine after a warm-up, with a
    dispatch window of 3 (a step's tokens are read after three more
    dispatches), and no live trace."""
    monkeypatch.setenv("MXNET_PALLAS", "off")
    jm, tm = models
    kw = {"static": run == "static"}
    if run == "speculative":
        kw.update(spec_k=3, prefix_share=True)
    if run == "gqa":
        gkw = dict(vocab=VOCAB, d_model=32, num_heads=4, num_kv_heads=2,
                   num_layers=2, seed=1)
        jm, tm = JGQADecoder(**gkw), GQADecoder(**gkw, device="cpu")
    prompts, mns = _mix()
    ref = _jax_tokens(jm, prompts, mns, (1, 2, 4), 8, **kw)
    eng = DecodeEngine(tm, ladder=(1, 2, 4), page_size=8, max_context=64,
                       num_pages=64, inflight=3, depth=len(prompts) + 1,
                       start=False, **kw)
    try:
        warm = eng.warmup()
        assert len(warm) == 3 * (3 if run == "speculative" else 2)
        streams = [eng.submit(p, max_new=m) for p, m in zip(prompts, mns)]
        assert eng.drain()
        assert eng._window.stats["max_pending"] == 4
        assert [s.result(0) for s in streams] == ref
        assert eng.n_traces == 0
    finally:
        eng.close()
