"""``gluon.contrib`` of mxnet_tpu_torch (the contrib recurrent cells, the
contrib layers, the Estimator and its handlers) against the JAX package.

The same numpy-seeded inputs and weights go through both packages (the
JAX block's parameters set from a seeded numpy dict that
``load_jax_params`` loads into the port's). Tolerances: 1e-5 absolute
and relative for the cells' outputs and states (convolutions and
products summed in another order, float64-accumulated on the port's
CPU; torch's and XLA's sigmoid and tanh), 2e-5 for gradients and for
weights after training; the pixel shuffles and the embedding are exact.
Dropout laws: shares within 0.01 over >= 20,000 draws (4.5 standard
deviations). A resumed Estimator equals the uninterrupted run bit for
bit (the same operations on the same values).
"""
import logging
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import metric as jmetric
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.gluon.contrib import estimator as jest
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu.gluon.contrib import rnn as jcrnn

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import contrib
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.block import load_parameters
from mxnet_tpu_torch.gluon.contrib import estimator as test
from mxnet_tpu_torch.gluon.contrib import nn as tcnn
from mxnet_tpu_torch.gluon.contrib import rnn as tcrnn
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.ops import registry

TOL = 1e-5
GRAD_TOL = 2e-5


def set_jax_params(block, seed, scale=0.3):
    block.initialize()
    r = onp.random.RandomState(seed)
    out = {}
    for k, p in sorted(block.collect_params().items()):
        v = (r.randn(*p.shape) * scale).astype("f4")
        p.set_data(mx.nd.array(v))
        out[k] = v
    return out


def close(a, b, tol=TOL, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    b = b.asnumpy() if hasattr(b, "asnumpy") else onp.asarray(b)
    onp.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=msg)


def unroll_both(jc, tc, x, dy, length, layout="NTC", train=True):
    """Merged unroll of both cells from zeros, the backward of a
    weighted sum of the outputs plus the states' squares; everything
    held against the JAX side."""
    jx = mx.nd.array(x)
    jx.attach_grad()
    with jautograd.record(train_mode=train):
        jo, js = jc.unroll(length, jx, layout=layout, merge_outputs=True)
        ((jo * mx.nd.array(dy)).sum()
         + sum((s * s).sum() for s in js)).backward()
    tx = torch.from_numpy(x).requires_grad_()
    to, ts = tc.unroll(length, tx, layout=layout, merge_outputs=True)
    ((to * torch.from_numpy(dy)).sum()
     + sum((s * s).sum() for s in ts)).backward()
    close(to, jo)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        close(a, b)
    close(tx.grad, jx.grad, GRAD_TOL)
    tp = dict(tc.named_parameters())
    for k, p in jc.collect_params().items():
        close(tp[k].grad, p.grad(), GRAD_TOL, k)
    return to, ts


# ---- contrib.rnn ----

CONV_SHAPES = {1: (2, 7), 2: (2, 5, 6), 3: (2, 3, 4, 5)}
CONV_CELLS = [f"Conv{d}D{k}Cell" for d in (1, 2, 3)
              for k in ("RNN", "LSTM", "GRU")]


@pytest.mark.parametrize("name", CONV_CELLS)
@pytest.mark.parametrize("pad,dil", [(1, 1), (0, 2)])
def test_conv_cells_vs_jax(name, pad, dil):
    """Each of the nine conv cells over a 3-step clip (NTC: (N, T, C,
    *spatial)): outputs, states (their spatial shape the i2h
    convolution's) and every gradient."""
    dims = int(name[4])
    shape = CONV_SHAPES[dims]
    kw = dict(input_shape=shape, hidden_channels=3, i2h_kernel=3,
              h2h_kernel=3, i2h_pad=pad, i2h_dilate=1, h2h_dilate=dil)
    jc = getattr(jcrnn, name)(**kw)
    tc = getattr(tcrnn, name)(device="cpu", **kw)
    params = set_jax_params(jc, 20 + dims)
    assert sorted(params) == sorted(k for k, _ in tc.named_parameters())
    load_jax_params(tc, params)
    assert tc.state_info(2) == jc.state_info(2)
    r = onp.random.RandomState(dims)
    x = r.randn(2, 3, *shape).astype("f4")
    spatial = tc.state_info(2)[0]["shape"][2:]
    dy = r.randn(2, 3, 3, *spatial).astype("f4")
    seen = []

    def w(n, fn):
        seen.append(n)
        return fn

    registry.add_invoke_wrapper(w)
    try:
        unroll_both(jc, tc, x, dy, 3)
    finally:
        registry.remove_invoke_wrapper(w)
    assert seen == ["convolution"] * 6


def test_conv_cells_refuse_even_kernels_and_other_layouts():
    with pytest.raises(mxt.MXNetError, match="odd"):
        tcrnn.Conv2DLSTMCell((2, 5, 5), 3, 3, 4, device="cpu")
    with pytest.raises(mxt.MXNetError, match="channel-first"):
        tcrnn.Conv2DGRUCell((2, 5, 5), 3, 3, 3, conv_layout="NHWC",
                            device="cpu")
    with pytest.raises(mxt.MXNetError, match="length-2"):
        tcrnn.Conv2DRNNCell((2, 5, 5), 3, (3, 3, 3), 3, device="cpu")


def test_lstmp_cell_vs_jax():
    """LSTMPCell: states [r (N, P), c (N, H)], the bias-free projection
    h2r (P, H); a TNC unroll with gradients."""
    jc = jcrnn.LSTMPCell(16, 5, input_size=4)
    tc = tcrnn.LSTMPCell(16, 5, input_size=4, device="cpu")
    load_jax_params(tc, set_jax_params(jc, 30))
    assert [i["shape"] for i in tc.state_info(3)] == [(3, 5), (3, 16)]
    r = onp.random.RandomState(31)
    x = r.randn(6, 3, 4).astype("f4")
    dy = r.randn(6, 3, 5).astype("f4")
    unroll_both(jc, tc, x, dy, 6, layout="TNC")
    with pytest.raises(mxt.MXNetError, match="input_size"):
        tcrnn.LSTMPCell(16, 5, device="cpu")


def test_variational_dropout_in_eval_mode_vs_jax():
    """In eval mode the masks are ones: the cell is its base cell (the
    JAX side records in predict mode)."""
    jb = jrnn.GRUCell(8, input_size=4)
    jc = jcrnn.VariationalDropoutCell(jb, 0.3, 0.4, 0.5)
    tc = tcrnn.VariationalDropoutCell(
        trnn.GRUCell(8, input_size=4, device="cpu"), 0.3, 0.4, 0.5)
    load_jax_params(tc, set_jax_params(jc, 32))
    tc.eval()
    r = onp.random.RandomState(33)
    x = r.randn(3, 5, 4).astype("f4")
    dy = r.randn(3, 5, 8).astype("f4")
    unroll_both(jc, tc, x, dy, 5, train=False)
    assert torch.equal(tc.drop_inputs_mask, torch.ones(3, 4))


def test_variational_dropout_masks_lock_until_reset():
    """One mask a sequence for inputs, the first state and outputs, at
    their rates, scaled by 1 / (1 - rate); the same mask every step
    until reset() draws new ones."""
    class Echo(trnn.RecurrentCell):
        def state_info(self, batch_size=0):
            return [{"shape": (batch_size, 400)}, {"shape": (batch_size, 3)}]

        def forward(self, inputs, states):
            return inputs + states[0], list(states)

    cell = tcrnn.VariationalDropoutCell(
        Echo(), drop_inputs=0.25, drop_states=0.5, drop_outputs=0.2,
        generator=torch.Generator().manual_seed(7))
    x = torch.ones(100, 400)
    steps, st = cell.unroll(4, [x] * 4, begin_state=[torch.zeros(100, 400),
                                                     torch.ones(100, 3)],
                            layout="TNC")
    m_in, m_st, m_out = (cell.drop_inputs_mask, cell.drop_states_mask,
                         cell.drop_outputs_mask)
    for m, rate in ((m_in, 0.25), (m_st, 0.5), (m_out, 0.2)):
        assert abs((m == 0).float().mean().item() - rate) < 0.01
        kept = m[m != 0]
        assert torch.equal(kept, torch.full_like(kept, 1 / (1 - rate)))
    assert all(torch.equal(s, steps[0]) for s in steps[1:])
    assert torch.equal(steps[0], x * m_in * m_out)
    assert torch.equal(st[1], torch.ones(100, 3))   # only h is masked
    cell.reset()
    assert cell.drop_inputs_mask is None
    again, _ = cell.unroll(1, [x], begin_state=[torch.zeros(100, 400),
                                                torch.ones(100, 3)])
    assert not torch.equal(cell.drop_inputs_mask, m_in)


def test_contrib_rnn_parameter_names_match_jax():
    j = jcrnn.VariationalDropoutCell(jrnn.LSTMCell(4, input_size=3), 0.1)
    t = tcrnn.VariationalDropoutCell(trnn.LSTMCell(4, input_size=3,
                                                   device="cpu"), 0.1)
    j.initialize()
    assert sorted(j.collect_params()) == \
        sorted(k for k, _ in t.named_parameters())


# ---- contrib.nn ----

@pytest.mark.parametrize("kind,factor,shape", [
    ("PixelShuffle1D", 3, (2, 6, 5)),
    ("PixelShuffle2D", 3, (1, 9, 4, 5)),
    ("PixelShuffle2D", (2, 3), (2, 12, 3, 4)),
    ("PixelShuffle3D", (2, 1, 3), (1, 12, 2, 3, 2)),
])
def test_pixel_shuffle_vs_jax(kind, factor, shape):
    x = onp.random.RandomState(40).randn(*shape).astype("f4")
    jl = getattr(jcnn, kind)(factor)
    tl = getattr(tcnn, kind)(factor)
    got = tl(torch.from_numpy(x)).numpy()
    assert onp.array_equal(got, jl(mx.nd.array(x)).asnumpy())


def test_concurrent_identity_and_sparse_embedding_vs_jax():
    jl = jcnn.HybridConcurrent(axis=1)
    jl.add(jnn.Dense(3, in_units=4), jcnn.Identity())
    tl = tcnn.HybridConcurrent(axis=1)
    tl.add(tnn.Dense(3, in_units=4, device="cpu"), tcnn.Identity())
    load_jax_params(tl, set_jax_params(jl, 41))
    x = onp.random.RandomState(42).randn(5, 4).astype("f4")
    close(tl(torch.from_numpy(x)), jl(mx.nd.array(x)))
    assert isinstance(tcnn.Concurrent(), tnn.Concatenate)
    # SparseEmbedding: the lookup, and its gradient (dense here: the
    # JAX row-sparse gradient densified)
    je = jcnn.SparseEmbedding(10, 3)
    te = tcnn.SparseEmbedding(10, 3, device="cpu")
    load_jax_params(te, set_jax_params(je, 43))
    ids = onp.array([[1, 4, 4], [9, 0, 1]], "int32")
    dy = onp.random.RandomState(44).randn(2, 3, 3).astype("f4")
    with jautograd.record():
        (je(mx.nd.array(ids, dtype="int32")) * mx.nd.array(dy)).sum() \
            .backward()
    (te(torch.from_numpy(ids)) * torch.from_numpy(dy)).sum().backward()
    jg = je.weight.grad()
    jg = jg.tostype("default") if hasattr(jg, "tostype") else jg
    assert te.sparse_grad
    close(te.weight.grad, jg, TOL)
    # SyncBatchNorm constructs with the reference's signature and is
    # gluon.nn's BatchNorm (its cases are in test_torch_zero.py)
    sb = tcnn.SyncBatchNorm(in_channels=4, num_devices=2, device="cpu")
    assert isinstance(sb, tnn.BatchNorm) and tcnn.SyncBatchNorm is \
        tnn.SyncBatchNorm


def test_contrib_exports_match_jax():
    import mxnet_tpu.gluon.contrib as jcontrib
    for mod in ("rnn", "nn", "estimator"):
        jm, tm = getattr(jcontrib, mod), getattr(contrib, mod)
        names = [n for n in getattr(jm, "__all__", dir(jm))
                 if not n.startswith("_")]
        assert [n for n in names if not hasattr(tm, n)] == [], mod


# ---- the Estimator ----

def _data(seed, batches=4, bs=6):
    r = onp.random.RandomState(seed)
    return [(r.randn(bs, 5).astype("f4"),
             r.randint(0, 3, bs).astype("f4")) for _ in range(batches)]


def _nets(seed):
    jn = jnn.HybridSequential()
    jn.add(jnn.Dense(8, activation="tanh", in_units=5),
           jnn.Dense(3, in_units=8))
    tn = tnn.HybridSequential()
    tn.add(tnn.Dense(8, activation="tanh", in_units=5, device="cpu"),
           tnn.Dense(3, in_units=8, device="cpu"))
    load_jax_params(tn, set_jax_params(jn, seed))
    return jn, tn


def test_estimator_fit_with_handlers_vs_jax():
    """fit over 3 epochs of 4 batches (SGD momentum) with validation,
    early stopping that does not fire, and batch logging: final weights,
    the train metrics (loss, accuracy) and the validation loss against
    the JAX Estimator's."""
    train, val = _data(50), _data(51, batches=2)
    jn, tn = _nets(52)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jlb, tlb = jloss.SoftmaxCrossEntropyLoss(), \
        tloss.SoftmaxCrossEntropyLoss()
    je = jest.Estimator(jn, jlb, train_metrics=jmetric.Accuracy(),
                        trainer=JTrainer(jn.collect_params(), "sgd",
                                         dict(opt)))
    te = test.Estimator(tn, tlb, train_metrics=tmetric.Accuracy(),
                        trainer=TTrainer(dict(tn.named_parameters()), "sgd",
                                         dict(opt)))
    jval, tval = jmetric.Loss("val_loss"), tmetric.Loss("val_loss")
    jtrain = [(mx.nd.array(x), mx.nd.array(y)) for x, y in train]
    ttrain = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in train]
    jvd = [(mx.nd.array(x), mx.nd.array(y)) for x, y in val]
    tvd = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in val]
    for est, vd, vm, mod in ((je, jvd, jval, jest), (te, tvd, tval, test)):
        stop = mod.EarlyStoppingHandler(vm, patience=5)
        est.fit(jtrain if mod is jest else ttrain, epochs=3,
                event_handlers=[
                    mod.ValidationHandler(vd, lambda d, e=est, m=vm:
                                          e.evaluate(d, [m])),
                    stop, mod.LoggingHandler(log_interval=2)])
        assert not stop.stop_training and stop.current_epoch == 3
    tp = dict(tn.named_parameters())
    for k, p in jn.collect_params().items():
        close(tp[k], p.data(), GRAD_TOL, k)
    for a, b in ((te.train_loss_metric, je.train_loss_metric),
                 (te.train_metrics[0], je.train_metrics[0]), (tval, jval)):
        assert a.name == b.name
        onp.testing.assert_allclose(a.get()[1], b.get()[1], rtol=GRAD_TOL,
                                    atol=GRAD_TOL)
    assert tn.training


class _Fixed:
    """A monitor whose readings are given."""

    def __init__(self, values):
        self.name, self.values = "fixed", list(values)

    def get(self):
        return self.name, self.values.pop(0)


@pytest.mark.parametrize("mode,values,stopped", [
    ("min", [3.0, 2.0, 2.5, 2.5, 1.0, 1.0], 4),
    ("max", [1.0, float("nan"), 0.5, 0.5, 0.5, 0.5], 4),
])
def test_early_stopping_and_batch_stop_as_jax(mode, values, stopped):
    """EarlyStoppingHandler(patience=1) stops fit at the same epoch as
    the JAX handler (a NaN reading skipped); fit(batches=5) stops after
    five batches."""
    train = _data(53)
    jn, tn = _nets(54)
    ends = []
    for mod, net, data, lb, make in (
            (jest, jn, [(mx.nd.array(x), mx.nd.array(y)) for x, y in train],
             jloss.SoftmaxCrossEntropyLoss(),
             lambda n: JTrainer(n.collect_params(), "sgd",
                                {"learning_rate": 0.1})),
            (test, tn, [(torch.from_numpy(x), torch.from_numpy(y))
                        for x, y in train], tloss.SoftmaxCrossEntropyLoss(),
             lambda n: TTrainer(dict(n.named_parameters()), "sgd",
                                {"learning_rate": 0.1}))):
        est = mod.Estimator(net, lb, trainer=make(net))
        h = mod.EarlyStoppingHandler(_Fixed(values), patience=1, mode=mode)
        est.fit(data, epochs=10, event_handlers=[h])
        ends.append(h.stopped_epoch)
        count = []

        class Counter(mod.BatchEnd):
            def batch_end(self, estimator, *args, **kwargs):
                count.append(1)

        est.fit(data, batches=5, event_handlers=[Counter()])
        assert len(count) == 5
    assert ends == [stopped, stopped]
    with pytest.raises(mxt.MXNetError, match="epochs or batches"):
        test.Estimator(tn, tloss.L2Loss()).fit([])


def _rmsprop_estimator(seed, data_seed=55):
    _, tn = _nets(seed)
    tr = TTrainer(dict(tn.named_parameters()), "rmsprop",
                  {"learning_rate": 1e-2, "rho": 0.9, "momentum": 0.0})
    est = test.Estimator(tn, tloss.SoftmaxCrossEntropyLoss(),
                         train_metrics=tmetric.Accuracy(), trainer=tr)
    data = [(torch.from_numpy(x), torch.from_numpy(y))
            for x, y in _data(data_seed)]
    return tn, est, data


def test_checkpoint_handler_resume_is_bit_equal(tmp_path):
    """CheckpointHandler(save_trainer_states=True) over 2 epochs, then a
    new net, trainer and Estimator with resume_from_checkpoint=True for
    one more epoch: weights bit-equal to an uninterrupted 3-epoch run
    (RMSProp's state restored); the epoch files load into the JAX net;
    save_best keeps the best by its monitor."""
    d = str(tmp_path)
    net, est, data = _rmsprop_estimator(56)
    mon = tmetric.Loss("val_loss")
    ck = test.CheckpointHandler(d, save_trainer_states=True, monitor=mon,
                                save_best=True)
    est.fit(data, epochs=2, event_handlers=[
        test.ValidationHandler(data[:1], lambda v: est.evaluate(v, [mon])),
        ck])
    assert ck.current_epoch == 2
    assert os.path.exists(os.path.join(d, "model-epoch2.params"))
    assert os.path.exists(os.path.join(d, "model-best.params"))
    jn, _ = _nets(56)
    jn.load_parameters(os.path.join(d, "model-epoch2.params"))
    tp = dict(net.named_parameters())
    for k, p in jn.collect_params().items():
        assert onp.array_equal(tp[k].detach().numpy(), p.data().asnumpy())

    resumed, est2, _ = _rmsprop_estimator(57)
    ck2 = test.CheckpointHandler(d, save_trainer_states=True,
                                 resume_from_checkpoint=True)
    est2.fit(data, epochs=1, event_handlers=[ck2])
    assert ck2.current_epoch == 3
    whole, est3, _ = _rmsprop_estimator(56)
    est3.fit(data, epochs=3)
    for (k, a), b in zip(resumed.named_parameters(), whole.parameters()):
        assert torch.equal(a, b), k
    # the later epoch file holds the resumed weights
    check, _, _ = _rmsprop_estimator(58)
    load_parameters(check, os.path.join(d, "model-epoch3.params"))
    for a, b in zip(check.parameters(), whole.parameters()):
        assert torch.equal(a, b)


def test_evaluate_runs_eval_mode_without_gradients_and_logging(caplog):
    net, est, data = _rmsprop_estimator(59)
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append((self.training, torch.is_grad_enabled()))
            return x

    net.add(Probe())
    net.train()
    (loss_m, acc) = est.evaluate(data, [tmetric.Loss(), tmetric.Accuracy()])
    assert seen and all(s == (False, False) for s in seen)
    assert net.training and loss_m.num_inst == 24 and acc.num_inst == 24
    with caplog.at_level(logging.INFO, "mxnet_tpu_torch.estimator"):
        est.fit(data, epochs=1,
                event_handlers=[test.LoggingHandler(log_interval=2)])
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs[0] == "Training begin"
    assert sum(m.startswith("Batch ") for m in msgs) == 2
    assert any(m.startswith("Epoch done") for m in msgs)
