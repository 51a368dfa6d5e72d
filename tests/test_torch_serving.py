"""mxnet_tpu_torch serving: CompiledPredictor + DynamicBatcher + loadgen.

Pins within the port what tests/test_serving.py pins within the JAX
package — bucket rounding, fake-clock timeout / max-batch / force
flushes, batched results bit-exact against one request at a time on the
CPU, pad/mask parity, pipelined vs synchronous parity, concurrent
clients — and holds the port's serving of a small BERT against the JAX
package's (float32 against float32: 2e-5, as tests/test_torch_bert.py).
"""
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon.model_zoo import bert as jbert

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.params import init_params_numpy, load_jax_params
from mxnet_tpu_torch.serving import loadgen

SEQ, VOCAB, CLASSES = 12, 128, 3
BUCKETS = (1, 2, 4, 8)


def make_net(seed=0):
    net = tbert.BERTClassifier(tbert.bert_small_test(device="cpu"),
                               num_classes=CLASSES, device="cpu")
    params = init_params_numpy(net, seed)
    load_jax_params(net, params)
    return net, params


def rows(n, seed=0):
    return onp.random.RandomState(seed).randint(0, VOCAB, (n, SEQ)) \
        .astype("int64")


@pytest.fixture(scope="module")
def net_params():
    return make_net()


@pytest.fixture
def pred(net_params):
    return serving.CompiledPredictor(net_params[0], bucket_sizes=BUCKETS,
                                     device="cpu")


def manual_batcher(pred, clk, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("timeout_ms", 5.0)
    return serving.DynamicBatcher(pred, start=False,
                                  clock=lambda: clk[0], **kw)


# ---------------------------------------------------------------------------
# CompiledPredictor
# ---------------------------------------------------------------------------

def test_bucket_for_rounds_up(pred):
    assert pred.bucket_for(1) == 1
    assert pred.bucket_for(3) == 4
    assert pred.bucket_for(8) == 8
    with pytest.raises(mxt.MXNetError, match="largest shape bucket"):
        pred.bucket_for(9)
    with pytest.raises(mxt.MXNetError, match="positive"):
        serving.CompiledPredictor(pred.net, bucket_sizes=(0, 2),
                                  device="cpu")


def test_pad_to_bucket_returns_mask(pred):
    (padded,), valid = pred.pad_to_bucket(rows(3))
    assert padded.shape == (4, SEQ) and valid == 3
    assert (padded[3] == 0).all()
    (tp,), valid = pred.pad_to_bucket(torch.ones(5, SEQ))
    assert tp.shape == (8, SEQ) and valid == 5 and (tp[5:] == 0).all()
    with pytest.raises(mxt.MXNetError, match="leading batch dim"):
        pred.pad_to_bucket(None)


def test_predict_runs_eval_inference(pred):
    out = pred.predict(rows(2))
    assert isinstance(out, torch.Tensor) and out.shape == (2, CLASSES)
    assert out.is_inference() and not pred.net.training


def test_warmup_runs_every_bucket_once(pred):
    times = pred.warmup(rows(1))
    assert set(times) == set(BUCKETS) and pred.n_traces == 4
    assert pred.service_time_seed_s > 0
    for n in (1, 2, 3, 4, 7, 8):
        padded, _ = pred.pad_to_bucket(rows(n))
        assert pred.predict(*padded).shape[0] == pred.bucket_for(n)
    assert pred.n_traces == 4


def test_bucket_trace_count_without_warmup(pred):
    for n in (1, 1, 2, 2, 4, 1):
        padded, _ = pred.pad_to_bucket(rows(n))
        pred.predict(*padded)
    assert pred.n_traces == 3


def test_predictor_raises_without_cuda(monkeypatch, net_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="no CUDA device"):
        serving.CompiledPredictor(net_params[0])


# ---------------------------------------------------------------------------
# DynamicBatcher: fake-clock semantics
# ---------------------------------------------------------------------------

def test_fake_clock_timeout_flush(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk)
    fut = b.submit(rows(1))
    assert b.process_once() is False          # young and not full
    clk[0] = 0.0049
    assert b.process_once() is False          # still inside the window
    clk[0] = 0.0051
    assert b.process_once() is True           # oldest aged past 5 ms
    assert b.stats["flush_timeout"] == 1
    assert fut.result(10).shape == (1, CLASSES)
    b.close()


def test_fake_clock_max_batch_flush(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk)
    futs = [b.submit(rows(1, seed=i)) for i in range(4)]
    assert b.process_once() is True           # size-triggered
    assert b.stats["flush_full"] == 1
    assert b.stats["rows"] == 4 and b.stats["padded_rows"] == 0
    for f in futs:
        assert f.result(10).shape == (1, CLASSES)
    b.close()


def test_fake_clock_force_flush_and_fill(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk)
    fut = b.submit(rows(3))
    assert b.process_once() is False
    assert b.process_once(force=True) is True
    assert b.stats["flush_force"] == 1
    assert b.stats["rows"] == 3 and b.stats["padded_rows"] == 1
    assert b.batch_fill == pytest.approx(0.75)
    assert b.bucket_counts == {4: 1}
    assert fut.result(10).shape == (3, CLASSES)
    b.close()


def test_process_once_empty_is_noop(pred):
    b = manual_batcher(pred, [0.0])
    assert b.process_once() is False
    assert b.process_once(force=True) is False
    assert b.batch_fill is None
    b.close()


def test_oversized_request_rejected(pred):
    b = manual_batcher(pred, [0.0])
    with pytest.raises(mxt.MXNetError, match="max_batch"):
        b.submit(rows(5))
    with pytest.raises(mxt.MXNetError, match="largest shape bucket"):
        serving.DynamicBatcher(pred, max_batch=16, start=False)
    b.close()


def test_queue_backpressure(pred):
    b = manual_batcher(pred, [0.0], depth=1)
    b.submit(rows(1))
    with pytest.raises(serving.Overloaded, match="saturated"):
        b.submit(rows(1), timeout=0.05)
    assert b.stats["rejected"] == 1
    b.flush()
    b.close()


def test_future_timeout_message(pred):
    b = manual_batcher(pred, [0.0])
    fut = b.submit(rows(1))
    with pytest.raises(mxt.MXNetError, match="not completed"):
        fut.result(0.01)
    b.flush()
    assert fut.result(10).shape == (1, CLASSES)
    b.close()


def test_dispatch_error_fails_futures(pred):
    clk = [0.0]
    b = manual_batcher(pred, clk)
    # tokens past max_length: the forward raises at dispatch
    fut = b.submit(onp.zeros((1, 65), "int64"))
    with pytest.raises(mxt.MXNetError, match="max_length"):
        b.process_once(force=True)
    with pytest.raises(mxt.MXNetError, match="max_length"):
        fut.result(10)
    assert b.stats["errors"] == 1
    b.close()


def test_closed_batcher_refuses_and_fails_pending(pred):
    b = manual_batcher(pred, [0.0])
    b.close()
    with pytest.raises(serving.ServingShutdown):
        b.submit(rows(1))


# ---------------------------------------------------------------------------
# batched-vs-single parity (bit-exact on the CPU)
# ---------------------------------------------------------------------------

def test_batched_bit_exact_vs_single(pred):
    pred.warmup(rows(1))
    X = rows(8, seed=3)
    singles = [pred.predict(X[i:i + 1]).numpy() for i in range(8)]
    with serving.DynamicBatcher(pred, max_batch=8, timeout_ms=20.0) as b:
        futs = [b.submit(X[i:i + 1]) for i in range(8)]
        batched = [f.result(30).numpy() for f in futs]
    for i in range(8):
        assert (batched[i] == singles[i]).all(), \
            f"row {i} differs between batched and single dispatch"


def test_pad_mask_parity_multi_row_request(pred):
    X = rows(3, seed=5)
    singles = [pred.predict(X[i:i + 1]).numpy() for i in range(3)]
    with serving.DynamicBatcher(pred, max_batch=4, timeout_ms=5.0) as b:
        out = b.submit(X).result(30).numpy()
    assert out.shape == (3, CLASSES)
    for i in range(3):
        assert (out[i:i + 1] == singles[i]).all()


def test_pipelined_vs_sync_parity(pred):
    X = rows(12, seed=9)

    def run(inflight):
        with serving.DynamicBatcher(pred, max_batch=4, timeout_ms=2.0,
                                    inflight=inflight) as b:
            futs = [b.submit(X[i:i + 1]) for i in range(12)]
            return [f.result(30).numpy() for f in futs]

    for a, c in zip(run(0), run(2)):
        assert (a == c).all()


def test_concurrent_clients_all_served(pred):
    pred.warmup(rows(1))
    X = rows(24, seed=17)
    singles = [pred.predict(X[i:i + 1]).numpy() for i in range(24)]
    results = [None] * 24
    with serving.DynamicBatcher(pred, max_batch=8, timeout_ms=2.0) as b:
        def client(i):
            results[i] = b.submit(X[i:i + 1]).result(30).numpy()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    for i in range(24):
        assert (results[i] == singles[i]).all()
    assert pred.n_traces == 4        # buckets only, never per request
    assert len(b.latencies) == 24


# ---------------------------------------------------------------------------
# the port's serving against the JAX package's, same small BERT
# ---------------------------------------------------------------------------

def test_serving_vs_jax(net_params):
    net, params = net_params
    jnet = jbert.BERTClassifier(jbert.bert_small_test(), num_classes=CLASSES)
    jnet.initialize()
    jnet(mx.nd.array(rows(1).astype("int32"), dtype="int32"))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    jpred = jserving.CompiledPredictor(jnet, bucket_sizes=BUCKETS)
    tpred = serving.CompiledPredictor(net, bucket_sizes=BUCKETS,
                                      device="cpu")
    reqs = [rows(n, seed=20 + n) for n in (1, 3, 2, 1, 4)]
    with jserving.DynamicBatcher(jpred, max_batch=8, timeout_ms=5.0) as jb:
        jouts = [jb.submit(mx.nd.array(r.astype("int32"), dtype="int32"))
                 for r in reqs]
        jouts = [f.result(60).asnumpy() for f in jouts]
    with serving.DynamicBatcher(tpred, max_batch=8, timeout_ms=5.0) as tb:
        touts = [f.result(60).numpy() for f in [tb.submit(r)
                                                for r in reqs]]
    for r, a, b in zip(reqs, jouts, touts):
        assert a.shape == b.shape == (r.shape[0], CLASSES)
        onp.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# load generator
# ---------------------------------------------------------------------------

def test_loadgen_percentiles_exact():
    lat = [0.001 * i for i in range(1, 101)]     # 1..100 ms
    p = loadgen.percentiles(lat)
    assert p["p50_ms"] == pytest.approx(50.5)
    assert p["p99_ms"] == pytest.approx(99.01)
    assert loadgen.percentiles([])["p50_ms"] is None


def test_loadgen_closed_loop_counts():
    seen = []
    rep = loadgen.run_closed_loop(lambda i: seen.append(i), concurrency=4,
                                  requests=40)
    assert rep["requests"] == 40 and rep["errors"] == 0
    assert sorted(seen) == list(range(40)) and rep["qps"] > 0
    assert rep["p50_ms"] is not None


def test_loadgen_counts_errors():
    def issue(i):
        if i % 2:
            raise RuntimeError("boom")

    rep = loadgen.run_closed_loop(issue, concurrency=2, requests=10)
    assert rep["errors"] == 5 and rep["requests"] == 5
    assert "boom" in rep["first_error"]
