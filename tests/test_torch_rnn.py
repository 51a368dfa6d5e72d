"""mxnet_tpu_torch's recurrence (the time-fused scan, ``ops.rnn``,
``gluon.rnn`` and the LSTM word LM) against the JAX package.

The same numpy-seeded inputs and weights go through both packages. The
JAX side runs its Pallas scan kernels in interpret mode (``MXNET_PALLAS=
on``, as tests/test_kernels.py does); the port runs on the CPU, where the
``torch.autograd.Function`` of each carry family runs the plain forward
and the plain reverse-time backward (on the card, the kernels of
tests/test_torch_cuda.py).

Tolerances: 1e-5 absolute and relative in float32 (the same step
arithmetic in another library: torch's and XLA's tanh and sigmoid differ
in the last bits, and the h2h products sum in another order); 2e-5
through a whole model (the port's CPU products accumulate in float64);
bfloat16 forwards 5e-2, because the JAX package rounds every gate
expression to bfloat16 while the port computes a step in float32 and
rounds only the stored state.
"""
import importlib.util
import os

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.ops import rnn as jrnn_ops
from mxnet_tpu.ops.kernels import rnn_scan as jkrnn

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.model_zoo.word_lm import WordLM
from mxnet_tpu_torch.gluon.params import init_params_numpy, load_jax_params
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops import rnn as trnn_ops
from mxnet_tpu_torch.ops.kernels import rnn_scan as KR

TOL = 1e-5
MODEL_TOL = 2e-5
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan_args(mode, T=7, N=3, H=37, seed=0):
    g = KR.GATES[mode]
    r = onp.random.RandomState(seed)
    xw = (r.randn(T, N, g * H) * 0.5).astype("f4")
    h0 = (r.randn(N, H) * 0.5).astype("f4")
    c0 = (r.randn(N, H) * 0.5).astype("f4") if mode == "lstm" else None
    w = (r.randn(g * H, H) * 0.3).astype("f4")
    b = (r.randn(g * H) * 0.1).astype("f4")
    cot = (r.randn(T, N, H).astype("f4"), r.randn(N, H).astype("f4"),
           r.randn(N, H).astype("f4"))
    return (xw, h0, c0, w, b), cot


def _jax_scan(args, cot, mode, rev):
    """outputs and the vjp of (ys, h_T, c_T) with cotangents ``cot``."""
    lstm = mode == "lstm"
    ja = [jnp.asarray(a) for a in args if a is not None]

    def f(*xs):
        if lstm:
            ys, h, c = jkrnn.rnn_scan(*xs, mode, reverse=rev)
            return ys, h, c
        xw, h0, w, b = xs
        ys, h, _ = jkrnn.rnn_scan(xw, h0, None, w, b, mode, reverse=rev)
        return ys, h

    outs, vjp = jax.vjp(f, *ja)
    grads = vjp(tuple(jnp.asarray(c) for c in cot[:len(outs)]))
    return [onp.asarray(o) for o in outs], [onp.asarray(g) for g in grads]


def _torch_scan(args, cot, mode, rev, fn=KR.rnn_scan):
    lstm = mode == "lstm"
    leaves = [torch.from_numpy(a).requires_grad_() if a is not None else None
              for a in args]
    ys, h, c = fn(*leaves, mode, reverse=rev)
    outs = [ys, h] + ([c] if lstm else [])
    grads = torch.autograd.grad(outs, [t for t in leaves if t is not None],
                                [torch.from_numpy(x) for x in cot[:len(outs)]])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


@pytest.mark.parametrize("block_t", [None, 4])
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_scan_vs_jax_kernel(monkeypatch, mode, rev, block_t):
    """Forward outputs (ys, h_T, c_T) and the gradients of xw, h0, c0,
    W_hh and b_hh: the port's Function (plain forward and plain backward
    on the CPU) against ``jax.vjp`` of the interpret-mode Pallas kernels,
    also with the JAX side's time blocks forced to 4 (T = 7: a padded
    tail)."""
    monkeypatch.setenv("MXNET_PALLAS", "on")
    monkeypatch.setattr(jkrnn, "_FORCE_BLOCK_T", block_t)
    args, cot = _scan_args(mode, seed=MODES.index(mode))
    jo, jg = _jax_scan(args, cot, mode, rev)
    K.reset_launch_counts()
    to, tg = _torch_scan(args, cot, mode, rev)
    assert all(n == 0 for n in K.launch_counts().values())
    assert len(jo) == len(to) and len(jg) == len(tg)
    for a, b in zip(to + tg, jo + jg):
        onp.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_scan_bf16_forward_vs_jax(monkeypatch, mode):
    """bfloat16: the port rounds only the stored state, the JAX package
    every gate expression (module docstring); 5e-2."""
    monkeypatch.setenv("MXNET_PALLAS", "on")
    args, _ = _scan_args(mode, seed=5)
    ref = jkrnn.rnn_scan(*(jnp.asarray(a).astype(jnp.bfloat16)
                           if a is not None else None for a in args), mode)
    got = KR.rnn_scan(*(torch.from_numpy(a).to(torch.bfloat16)
                        if a is not None else None for a in args), mode)
    assert got[0].dtype == torch.bfloat16
    for g, r in zip(got, ref):
        if r is None:
            continue
        onp.testing.assert_allclose(g.float().numpy(),
                                    onp.asarray(r.astype(jnp.float32)),
                                    rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_scan_reference_is_the_plain_forward(mode, rev):
    args, _ = _scan_args(mode, T=5, N=2, H=9, seed=7)
    t = [torch.from_numpy(a) if a is not None else None for a in args]
    ref = trnn_ops.scan_reference(*t, mode, reverse=rev)
    got = KR.rnn_scan(*t, mode, reverse=rev)
    jref = jrnn_ops.scan_reference(*(jnp.asarray(a) if a is not None
                                     else None for a in args), mode,
                                   reverse=rev)
    for g, r, j in zip(got, ref, jref):
        if r is None:
            assert g is None and j is None
            continue
        assert torch.equal(g, r)
        onp.testing.assert_allclose(r.numpy(), onp.asarray(j), rtol=TOL,
                                    atol=TOL)


def test_rnn_scan_bwd_plain_seeds_dc_at_the_last_step():
    """c_T's cotangent enters only at t = T-1: with ys and h_T cotangents
    zero, dxw at T-1 carries it and a change of it moves every step."""
    args, _ = _scan_args("lstm", T=4, N=2, H=5, seed=8)
    t = [torch.from_numpy(a) for a in args]
    ys, cs = KR.rnn_scan_plain(*t, "lstm")
    zeros = torch.zeros_like(ys)
    dct = torch.ones(2, 5)
    dxw = KR.rnn_scan_bwd_plain(*t, ys, cs, zeros, dct, "lstm")[0]
    assert (dxw[-1].abs().sum(-1) > 0).all()
    dxw0 = KR.rnn_scan_bwd_plain(*t, ys, cs, zeros, 0 * dct, "lstm")[0]
    assert (dxw0 == 0).all()


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_fused_rnn_two_layers_bidirectional_vs_jax(monkeypatch, mode):
    monkeypatch.setenv("MXNET_PALLAS", "on")
    g = KR.GATES[mode]
    r = onp.random.RandomState(9)
    T, N, C, H, L = 6, 3, 5, 8, 2
    x = r.randn(T, N, C).astype("f4")
    h0 = (r.randn(2 * L, N, H) * 0.5).astype("f4")
    c0 = (r.randn(2 * L, N, H) * 0.5).astype("f4") if mode == "lstm" \
        else None
    params = []
    for layer in range(L):
        in_sz = C if layer == 0 else 2 * H
        for _ in range(2):
            params += [(r.randn(g * H, in_sz) * 0.3).astype("f4"),
                       (r.randn(g * H, H) * 0.3).astype("f4"),
                       (r.randn(g * H) * 0.1).astype("f4"),
                       (r.randn(g * H) * 0.1).astype("f4")]
    ref = jrnn_ops.fused_rnn(jnp.asarray(x), jnp.asarray(h0),
                             jnp.asarray(c0) if c0 is not None else None,
                             [jnp.asarray(p) for p in params], mode, L, True)
    got = trnn_ops.fused_rnn(torch.from_numpy(x), torch.from_numpy(h0),
                             torch.from_numpy(c0) if c0 is not None else None,
                             [torch.from_numpy(p) for p in params], mode, L,
                             True)
    assert got[0].shape == (T, N, 2 * H)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
            continue
        onp.testing.assert_allclose(a.numpy(), onp.asarray(b), rtol=TOL,
                                    atol=TOL)


def test_fused_rnn_dropout_masks_at_rate_and_only_in_training():
    """Inter-layer dropout: a 2-layer relu RNN with H = 1 whose first
    layer outputs 1 everywhere and whose second passes its input through,
    so the output is the mask: kept at 1 - rate, scaled by 1 / (1 -
    rate). Off in eval(), and never after the last layer."""
    ones = torch.ones(200, 100, 50)
    params = [torch.eye(1, 50), torch.zeros(1, 1), torch.zeros(1),
              torch.zeros(1), torch.ones(1, 1), torch.zeros(1, 1),
              torch.zeros(1), torch.zeros(1)]

    def run(train, rate=0.3, seed=2):
        return trnn_ops.fused_rnn(
            ones, torch.zeros(2, 100, 1), None, params, "rnn_relu", 2,
            False, dropout=rate, train=train,
            generator=torch.Generator().manual_seed(seed))[0]

    masked = run(True)
    kept = (masked > 0).float().mean().item()
    assert abs(kept - 0.7) < 0.01
    torch.testing.assert_close(masked[masked > 0],
                               torch.full_like(masked[masked > 0], 1 / 0.7))
    assert torch.equal(run(True), masked)           # the generator's seed
    assert not torch.equal(run(True, seed=3), masked)
    assert (run(False) == 1).all()
    layer = trnn.LSTM(8, num_layers=2, dropout=0.5, input_size=4,
                      device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 5, 4)
    layer.eval()
    assert torch.equal(layer(x), layer(x))
    layer.train()
    assert not torch.equal(layer(x), layer(x))


def _jax_block_params(block, x):
    block.initialize()
    block(mx.nd.array(x))
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("kind,kw", [
    ("LSTM", {}), ("GRU", {}), ("RNN", {"activation": "tanh"}),
    ("RNN", {"activation": "relu"}),
])
def test_gluon_rnn_layers_vs_jax(monkeypatch, kind, kw, layout):
    """The port's layer, loaded from the JAX block's own parameters,
    with states passed in and returned."""
    monkeypatch.setenv("MXNET_PALLAS", "on")
    r = onp.random.RandomState(10)
    T, N, C, H = 5, 3, 4, 6
    x = r.randn(*((T, N, C) if layout == "TNC" else (N, T, C))).astype("f4")
    jl = getattr(jrnn, kind)(H, num_layers=2, layout=layout, input_size=C,
                             **kw)
    params = _jax_block_params(jl, x)
    tl = getattr(trnn, kind)(H, num_layers=2, layout=layout, input_size=C,
                             device="cpu", **kw)
    load_jax_params(tl, params)
    n_states = 2 if kind == "LSTM" else 1
    states = [(r.randn(2, N, H) * 0.5).astype("f4") for _ in range(n_states)]
    jy, js = jl(mx.nd.array(x), [mx.nd.array(s) for s in states])
    ty, ts = tl(torch.from_numpy(x), [torch.from_numpy(s) for s in states])
    assert len(ts) == len(js) == n_states
    for a, b in zip([ty] + ts, [jy] + js):
        onp.testing.assert_allclose(a.detach().numpy(), b.asnumpy(),
                                    rtol=TOL, atol=TOL)
    # no states: the output alone, from zero states
    onp.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                                jl(mx.nd.array(x)).asnumpy(), rtol=TOL,
                                atol=TOL)
    assert [i["shape"] for i in tl.state_info(N)] == \
        [i["shape"] for i in jl.state_info(N)]


def test_bidirectional_gru_weights_carried_across(monkeypatch):
    """A 2-layer bidirectional GRU built by the JAX package: its
    collect_params() dict loads as it is, and the port computes the
    same outputs and input gradients from it."""
    monkeypatch.setenv("MXNET_PALLAS", "on")
    r = onp.random.RandomState(11)
    x = r.randn(6, 2, 5).astype("f4")
    dy = r.randn(6, 2, 14).astype("f4")
    jl = jrnn.GRU(7, num_layers=2, bidirectional=True, input_size=5)
    params = _jax_block_params(jl, x)
    assert "r1_h2h_weight" in params
    tl = trnn.GRU(7, num_layers=2, bidirectional=True, input_size=5,
                  device="cpu")
    load_jax_params(tl, params)
    jx = mx.nd.array(x)
    jx.attach_grad()
    with jautograd.record():
        jy = jl(jx)
        jsum = (jy * mx.nd.array(dy)).sum()
    jsum.backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = tl(tx)
    (ty * torch.from_numpy(dy)).sum().backward()
    onp.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), rtol=TOL,
                                atol=TOL)
    onp.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                                rtol=TOL, atol=TOL)
    tparams = dict(tl.named_parameters())
    for k, p in jl.collect_params().items():
        onp.testing.assert_allclose(tparams[k].grad.numpy(),
                                    p.grad().asnumpy(), rtol=MODEL_TOL,
                                    atol=MODEL_TOL, err_msg=k)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "train_lstm_lm", os.path.join(ROOT, "examples", "train_lstm_lm.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex


VOCAB, EMBED, HIDDEN, LAYERS, BATCH, BPTT = 64, 16, 32, 2, 4, 6


@pytest.mark.parametrize("path", ["record", "compile_step"])
def test_word_lm_sgd_momentum_step_vs_jax(monkeypatch, path):
    """WordLM (2 layers, vocab 64, embed 16, hidden 32): logits, and one
    SGD-momentum step's loss and updated parameters, against the JAX
    example's WordLM and the JAX Trainer."""
    monkeypatch.setenv("MXNET_PALLAS", "on")
    r = onp.random.RandomState(12)
    x = r.randint(0, VOCAB, (BATCH, BPTT)).astype("int32")
    y = r.randint(0, VOCAB, (BATCH, BPTT)).astype("int32")
    tnet = WordLM(VOCAB, EMBED, HIDDEN, LAYERS, device="cpu")
    params = init_params_numpy(tnet, 13)
    load_jax_params(tnet, params)
    jnet = _jax_example().WordLM(VOCAB, EMBED, HIDDEN, LAYERS)
    jnet.initialize()
    jnet(mx.nd.array(x, dtype="int32"))
    assert sorted(jnet.collect_params()) == sorted(params)
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    opt = {"learning_rate": 0.5, "momentum": 0.9}
    xs, ys = mx.nd.array(x, dtype="int32"), mx.nd.array(y)

    jlogits = jnet(xs).asnumpy()
    tlogits = tnet(torch.from_numpy(x)).detach().numpy()
    assert tlogits.shape == (BATCH, BPTT, VOCAB)
    onp.testing.assert_allclose(tlogits, jlogits, rtol=MODEL_TOL,
                                atol=MODEL_TOL)

    jtr = JTrainer(jnet.collect_params(), "sgd", dict(opt))
    jlb = jloss.SoftmaxCrossEntropyLoss()
    ttr = TTrainer(dict(tnet.named_parameters()), "sgd", dict(opt))
    tlb = tloss.SoftmaxCrossEntropyLoss()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jlosses, tlosses = [], []
    if path == "compile_step":
        jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b))
        tstep = ttr.compile_step(lambda a, b: tlb(tnet(a), b))
    for _ in range(2):
        if path == "compile_step":
            jlosses.append(jstep(xs, ys).asnumpy())
            tlosses.append(tstep(tx, ty).numpy())
        else:
            with jautograd.record():
                jl_ = jlb(jnet(xs), ys)
            jl_.backward()
            jtr.step(BATCH)
            jlosses.append(jl_.asnumpy())
            tl_ = tlb(tnet(tx), ty)
            tl_.sum().backward()
            ttr.step(BATCH)
            tlosses.append(tl_.detach().numpy())
    for a, b in zip(tlosses, jlosses):
        assert a.shape == (BATCH,)
        onp.testing.assert_allclose(a, b, rtol=MODEL_TOL, atol=MODEL_TOL)
    tparams = dict(tnet.named_parameters())
    for k, p in jnet.collect_params().items():
        onp.testing.assert_allclose(tparams[k].detach().numpy(),
                                    p.data().asnumpy(), rtol=MODEL_TOL,
                                    atol=MODEL_TOL, err_msg=k)


def test_softmax_ce_over_sequence_logits_vs_jax():
    """(N, T, V) logits with (N, T) labels over axis -1: per-sample loss
    averaged over T, as the JAX loss."""
    r = onp.random.RandomState(14)
    pred = r.randn(3, 5, 7).astype("f4")
    label = r.randint(0, 7, (3, 5)).astype("f4")
    ref = jloss.SoftmaxCrossEntropyLoss()(mx.nd.array(pred),
                                          mx.nd.array(label))
    got = tloss.SoftmaxCrossEntropyLoss()(torch.from_numpy(pred),
                                          torch.from_numpy(label))
    assert got.shape == (3,)
    onp.testing.assert_allclose(got.numpy(), ref.asnumpy(), rtol=TOL,
                                atol=TOL)


def test_packed_param_size_and_gates_match_jax():
    assert trnn_ops.GATES == jrnn_ops.GATES
    for mode in MODES:
        for bi in (False, True):
            assert trnn_ops.rnn_packed_param_size(mode, 5, 7, 2, bi) == \
                jrnn_ops.rnn_packed_param_size(mode, 5, 7, 2, bi)


def test_rnn_wrappers_refuse_what_they_do_not_take():
    args, _ = _scan_args("lstm", T=2, N=2, H=3)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(mxt.MXNetError, match="unknown mode"):
        KR.rnn_scan(*t, "lstm2")
    with pytest.raises(mxt.MXNetError, match="T >= 1"):
        KR.rnn_scan(t[0][:0], *t[1:], "lstm")
    meta = [x.to("meta") for x in t]
    with pytest.raises(mxt.MXNetError, match="not supported"):
        KR.rnn_scan_fwd(*meta, "lstm")
    with pytest.raises(mxt.MXNetError, match="input_size"):
        trnn.LSTM(4, device="cpu")
    with pytest.raises(mxt.MXNetError, match="layout"):
        trnn.GRU(4, layout="CTN", input_size=3, device="cpu")
    # float64 on the CPU runs the plain versions
    ys, h, c = KR.rnn_scan(*(x.double() for x in t), "lstm")
    assert ys.dtype == torch.float64 and c.dtype == torch.float64


def test_word_lm_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="no CUDA device"):
        WordLM(8, 4, 4, 1)
    assert WordLM(8, 4, 4, 1, device="cpu").head.weight.shape == (8, 4)
