"""mxnet_tpu_torch's recurrent cells (``gluon.rnn.rnn_cell``) and
sequence ops against the JAX package.

The same numpy-seeded inputs and weights go through both packages: the
JAX cell's parameters are set from a seeded numpy dict, which
``load_jax_params`` loads into the port's cell. The JAX package's fused
unroll runs its Pallas scan in interpret mode (``MXNET_PALLAS=on``) and
through its plain ``lax.scan`` reference (``off``), as
tests/test_torch_rnn.py runs it; the port runs on the CPU, where the
recurrence's ``torch.autograd.Function`` runs the plain forward and
backward (on the card, the kernels: tests/test_torch_cuda.py).

Tolerances: 1e-5 absolute and relative for a step and an unroll's
outputs and states (the same arithmetic in another library: torch's and
XLA's tanh and sigmoid differ in the last bits, and the products sum in
another order); 2e-5 for gradients and through a whole model (the port's
CPU products accumulate in float64); the fused and the looped unroll of
the port within 1e-5 of each other (the fused step adds the two biases
in another order). Sequence ops are exact. Dropout laws: a kept share
within 0.01 of 1 - rate over 20,000 draws (4.5 standard deviations).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.ndarray import ops as jF

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.ndarray import SequenceMask, SequenceReverse
from mxnet_tpu_torch.ops import registry

TOL = 1e-5
GRAD_TOL = 2e-5
T, N, C, H = 7, 3, 5, 16
CELLS = [("RNNCell", {"activation": "tanh"}), ("RNNCell",
                                               {"activation": "relu"}),
         ("LSTMCell", {}), ("GRUCell", {})]
CELL_IDS = ["rnn_tanh", "rnn_relu", "lstm", "gru"]


def set_jax_params(block, seed, scale=0.3):
    """Seeded normal values into every parameter of the (initialized)
    JAX block; returns them as a numpy dict under its names."""
    block.initialize()
    r = onp.random.RandomState(seed)
    out = {}
    for k, p in sorted(block.collect_params().items()):
        v = (r.randn(*p.shape) * scale).astype("f4")
        p.set_data(mx.nd.array(v))
        out[k] = v
    return out


def pair(kind, kw, seed=0, hidden=H, input_size=C):
    """A JAX cell and the port's, loaded with the same weights."""
    jc = getattr(jrnn, kind)(hidden, input_size=input_size, **kw)
    tc = getattr(trnn, kind)(hidden, input_size=input_size, device="cpu",
                             **kw)
    load_jax_params(tc, set_jax_params(jc, seed))
    return jc, tc


def n_states(kind):
    return 2 if kind == "LSTMCell" else 1


def close(a, b, tol=TOL, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    b = b.asnumpy() if hasattr(b, "asnumpy") else onp.asarray(b)
    onp.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=msg)


def funnel_names():
    """Records the op funnel's names while installed."""
    seen = []

    def wrapper(name, fn):
        seen.append(name)
        return fn

    return seen, wrapper


@pytest.mark.parametrize("kind,kw", CELLS, ids=CELL_IDS)
def test_cell_step_and_gradients_vs_jax(kind, kw):
    """One step with given states: output, new states, and the gradients
    of input, states and parameters of a weighted sum of them."""
    jc, tc = pair(kind, kw, seed=1)
    r = onp.random.RandomState(2)
    x = r.randn(N, C).astype("f4")
    st = [(r.randn(N, H) * 0.5).astype("f4") for _ in range(n_states(kind))]
    w = [r.randn(N, H).astype("f4") for _ in range(1 + n_states(kind))]
    jx, js = mx.nd.array(x), [mx.nd.array(s) for s in st]
    for a in [jx] + js:
        a.attach_grad()
    with jautograd.record():
        jo, jns = jc(jx, js)
        jsum = sum(((o * mx.nd.array(wi)).sum()
                    for o, wi in zip([jo] + jns, w)), mx.nd.zeros((1,)))
    jsum.backward()
    tx = torch.from_numpy(x).requires_grad_()
    ts = [torch.from_numpy(s).requires_grad_() for s in st]
    to, tns = tc(tx, ts)
    sum((o * torch.from_numpy(wi)).sum()
        for o, wi in zip([to] + tns, w)).backward()
    assert len(tns) == len(jns) == n_states(kind)
    for a, b in zip([to] + tns, [jo] + jns):
        close(a, b)
    for a, b in zip([tx] + ts, [jx] + js):
        close(a.grad, b.grad, GRAD_TOL)
    tp = dict(tc.named_parameters())
    for k, p in jc.collect_params().items():
        close(tp[k].grad, p.grad(), GRAD_TOL, k)


def _jax_unroll(jc, x, layout, merge, states, valid, dy, use_list):
    jx = mx.nd.array(x)
    jx.attach_grad()
    js = None if states is None else [mx.nd.array(s) for s in states]
    vl = None if valid is None else mx.nd.array(valid)
    t_axis = layout.find("T")
    with jautograd.record():
        inp = [jx.take(i, axis=t_axis) for i in range(T)] if use_list \
            else jx
        out, st = jc.unroll(T, inp, begin_state=js, layout=layout,
                            merge_outputs=merge, valid_length=vl)
        merged = out if merge else jF.stack(*out, axis=t_axis)
        s = (merged * mx.nd.array(dy)).sum() + sum(
            (si * si).sum() for si in st)
    s.backward()
    return merged.asnumpy(), [si.asnumpy() for si in st], jx.grad.asnumpy()


def _torch_unroll(tc, x, layout, merge, states, valid, dy, use_list):
    tx = torch.from_numpy(x).requires_grad_()
    ts = None if states is None else [torch.from_numpy(s) for s in states]
    vl = None if valid is None else torch.from_numpy(valid)
    t_axis = layout.find("T")
    inp = list(tx.unbind(t_axis)) if use_list else tx
    out, st = tc.unroll(T, inp, begin_state=ts, layout=layout,
                        merge_outputs=merge, valid_length=vl)
    if merge:
        assert isinstance(out, torch.Tensor)
        merged = out
    else:
        assert isinstance(out, list) and len(out) == T
        merged = torch.stack(out, dim=t_axis)
    ((merged * torch.from_numpy(dy)).sum()
     + sum((si * si).sum() for si in st)).backward()
    grads = {k: p.grad.clone() for k, p in tc.named_parameters()}
    tc.zero_grad()
    return merged.detach().numpy(), [si.detach().numpy() for si in st], \
        tx.grad.numpy(), grads


def _unroll_case(seed, layout):
    r = onp.random.RandomState(seed)
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    x = r.randn(*shape).astype("f4")
    dy = r.randn(*shape[:2], H).astype("f4")
    return r, x, dy


@pytest.mark.parametrize("pallas", ["on", "off"])
@pytest.mark.parametrize("merge", [None, False, True])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind,kw", CELLS, ids=CELL_IDS)
def test_fused_unroll_vs_jax(monkeypatch, kind, kw, layout, merge, pallas):
    """A merged 3-d input: the port's unroll goes through the fused
    recurrence (funnel name ``rnn_<mode>_unroll``, no per-step
    ``fully_connected``), the JAX cell's too; outputs (a list of T steps
    unless merge_outputs is True), states and all gradients agree, from
    given states and from zeros."""
    monkeypatch.setenv("MXNET_PALLAS", pallas)
    jc, tc = pair(kind, kw, seed=3)
    r, x, dy = _unroll_case(4, layout)
    states = [(r.randn(N, H) * 0.5).astype("f4")
              for _ in range(n_states(kind))]
    for st in (states, None):
        seen, w = funnel_names()
        registry.add_invoke_wrapper(w)
        try:
            to, ts, tg, tpg = _torch_unroll(tc, x, layout, merge, st, None,
                                            dy, False)
        finally:
            registry.remove_invoke_wrapper(w)
        mode = tc._fused_mode()
        assert seen == [f"rnn_{mode}_unroll"]
        jo, js, jg = _jax_unroll(jc, x, layout, merge, st, None, dy, False)
        close(to, jo)
        for a, b in zip(ts, js):
            close(a, b)
        close(tg, jg, GRAD_TOL)
        for k, p in jc.collect_params().items():
            close(tpg[k], p.grad(), GRAD_TOL, k)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind,kw", CELLS, ids=CELL_IDS)
def test_looped_unroll_vs_jax(kind, kw, layout, valid):
    """A step list (and a merged input with ``valid_length``): the step
    loop on both sides, outputs past a sequence's length zero, the
    states run on; gradients agree."""
    jc, tc = pair(kind, kw, seed=5)
    r, x, dy = _unroll_case(6, layout)
    vl = onp.array([T, 3, 1], "int32") if valid else None
    for use_list in ((False, True) if valid else (True,)):
        seen, w = funnel_names()
        registry.add_invoke_wrapper(w)
        try:
            to, ts, tg, tpg = _torch_unroll(tc, x, layout, True, None, vl,
                                            dy, use_list)
        finally:
            registry.remove_invoke_wrapper(w)
        assert not any(n.endswith("_unroll") for n in seen)
        assert seen.count("fully_connected") == 2 * T
        jo, js, jg = _jax_unroll(jc, x, layout, True, None,
                                 None if vl is None else vl.astype("f4"),
                                 dy, use_list)
        close(to, jo)
        if valid:
            t_axis = layout.find("T")
            assert (onp.take(to, [1], axis=1 - t_axis)
                    .take(range(3, T), axis=t_axis) == 0).all()
        for a, b in zip(ts, js):
            close(a, b)
        close(tg, jg, GRAD_TOL)
        for k, p in jc.collect_params().items():
            close(tpg[k], p.grad(), GRAD_TOL, k)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind,kw", CELLS, ids=CELL_IDS)
def test_fused_and_looped_unroll_agree(kind, kw, layout):
    """The port alone: the fused unroll of a merged input and the step
    loop over the same steps give the same outputs, states and
    gradients (1e-5)."""
    _, tc = pair(kind, kw, seed=7)
    r, x, dy = _unroll_case(8, layout)
    st = [(r.randn(N, H) * 0.5).astype("f4") for _ in range(n_states(kind))]
    fused = _torch_unroll(tc, x, layout, True, st, None, dy, False)
    looped = _torch_unroll(tc, x, layout, True, st, None, dy, True)
    for a, b in zip(fused[:3], looped[:3]):
        if isinstance(a, list):
            for u, v in zip(a, b):
                close(u, v)
        else:
            close(a, b)
    for k in fused[3]:
        close(fused[3][k], looped[3][k], TOL, k)


def test_subclass_and_other_activations_take_the_loop():
    """Only the exact classes fuse: a subclass of LSTMCell, an RNNCell
    with another activation, a 4-d input and a length that does not
    match take the loop or raise."""
    class MyLSTM(trnn.LSTMCell):
        pass

    x = torch.randn(N, T, C)
    for cell in (MyLSTM(H, input_size=C, device="cpu"),
                 trnn.RNNCell(H, activation="sigmoid", input_size=C,
                              device="cpu")):
        assert cell._fused_mode() is None
        seen, w = funnel_names()
        registry.add_invoke_wrapper(w)
        try:
            out, _ = cell.unroll(T, x, merge_outputs=True)
        finally:
            registry.remove_invoke_wrapper(w)
        assert out.shape == (N, T, H)
        assert set(seen) == {"fully_connected"}
    with pytest.raises(mxt.MXNetError, match="expected 4 steps"):
        trnn.GRUCell(H, input_size=C, device="cpu").unroll(4, x)


def test_begin_state_and_device_rules(monkeypatch):
    cell = trnn.LSTMCell(H, input_size=C, device="cpu")
    st = cell.begin_state(4)
    assert [tuple(s.shape) for s in st] == [(4, H), (4, H)]
    assert all(s.dtype == torch.float32 and not s.any() for s in st)
    st = cell.begin_state(2, dtype=torch.float64)
    assert st[0].dtype == torch.float64
    ones = cell.begin_state(2, func=torch.ones)
    assert all((s == 1).all() for s in ones)
    out, states = cell.unroll(T, torch.randn(2, T, C, dtype=torch.float64))
    assert out[0].dtype == torch.float64 == states[1].dtype
    jc = jrnn.LSTMCell(H, input_size=C)
    assert [i["shape"] for i in cell.state_info(3)] == \
        [i["shape"] for i in jc.state_info(3)]
    with pytest.raises(mxt.MXNetError, match="input_size"):
        trnn.GRUCell(H, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="no CUDA device"):
        trnn.RNNCell(H, input_size=C)


def _seq_model_pair(seed, kind="HybridSequentialRNNCell"):
    """A ``kind`` (sequential cell) of Zoneout(LSTM), Dropout and
    Residual(GRU) in both packages, weights loaded alike."""
    js = getattr(jrnn, kind)()
    js.add(jrnn.ZoneoutCell(jrnn.LSTMCell(H, input_size=C), 0.3, 0.2))
    js.add(jrnn.DropoutCell(0.5))
    js.add(jrnn.ResidualCell(jrnn.GRUCell(H, input_size=H)))
    ts = getattr(trnn, kind)()
    ts.add(trnn.ZoneoutCell(trnn.LSTMCell(H, input_size=C, device="cpu"),
                            0.3, 0.2))
    ts.add(trnn.DropoutCell(0.5))
    ts.add(trnn.ResidualCell(trnn.GRUCell(H, input_size=H, device="cpu")))
    params = set_jax_params(js, seed)
    assert sorted(params) == sorted(k for k, _ in ts.named_parameters())
    load_jax_params(ts, params)
    return js, ts


@pytest.mark.parametrize("kind", ["SequentialRNNCell",
                                  "HybridSequentialRNNCell"])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_combinators_in_eval_mode_vs_jax(layout, kind):
    """Zoneout and Dropout cells are the identity outside training: the
    stack (states concatenated: LSTM's two, GRU's one) agrees with the
    JAX one, gradients included (the JAX side records in predict
    mode)."""
    js, ts = _seq_model_pair(9, kind)
    ts.eval()
    r, x, dy = _unroll_case(10, layout)
    assert len(ts.state_info(N)) == len(js.state_info(N)) == 3
    assert len(ts) == 3 and isinstance(ts[1], trnn.DropoutCell)
    jx = mx.nd.array(x)
    jx.attach_grad()
    with jautograd.record(train_mode=False):
        jo, jst = js.unroll(T, jx, layout=layout, merge_outputs=True)
        jsum = (jo * mx.nd.array(dy)).sum()
    jsum.backward()
    tx = torch.from_numpy(x).requires_grad_()
    to, tst = ts.unroll(T, tx, layout=layout, merge_outputs=True)
    (to * torch.from_numpy(dy)).sum().backward()
    close(to, jo)
    for a, b in zip(tst, jst):
        close(a, b)
    close(tx.grad, jx.grad, GRAD_TOL)
    tp = dict(ts.named_parameters())
    for k, p in js.collect_params().items():
        close(tp[k].grad, p.grad(), GRAD_TOL, k)


def test_modifier_cells_step_vs_jax():
    """ResidualCell adds its input; ZoneoutCell in eval keeps the base
    cell's step; ModifierCell's states are its base cell's."""
    jb, tb = pair("GRUCell", {}, seed=11, input_size=H)
    jr, tr = jrnn.ResidualCell(jb), trnn.ResidualCell(tb)
    r = onp.random.RandomState(12)
    x = r.randn(N, H).astype("f4")
    s = [r.randn(N, H).astype("f4")]
    jo, _ = jr(mx.nd.array(x), [mx.nd.array(s[0])])
    to, _ = tr(torch.from_numpy(x), [torch.from_numpy(s[0])])
    close(to, jo)
    assert tr.state_info(2) == tb.state_info(2)
    z = trnn.ZoneoutCell(tb, 0.5, 0.5).eval()
    zo, _ = z(torch.from_numpy(x), [torch.from_numpy(s[0])])
    bo, _ = tb(torch.from_numpy(x), [torch.from_numpy(s[0])])
    assert torch.equal(zo, bo)


def test_dropout_cell_law_and_generator():
    """DropoutCell keeps 1 - rate of its inputs, scaled by 1 / (1 -
    rate), draws from its generator, and is the identity in eval."""
    x = torch.ones(200, 100)
    cell = trnn.DropoutCell(0.3, generator=torch.Generator().manual_seed(1))
    out, st = cell(x, [])
    assert st == []
    kept = (out > 0).float().mean().item()
    assert abs(kept - 0.7) < 0.01
    torch.testing.assert_close(out[out > 0],
                               torch.full_like(out[out > 0], 1 / 0.7))
    again = trnn.DropoutCell(0.3,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(again(x, [])[0], out)
    assert torch.equal(cell.eval()(x, [])[0], x)


def test_zoneout_cell_law_and_reset():
    """ZoneoutCell keeps the previous output where its mask drops (rate
    zoneout_outputs) and the previous state likewise; the first step's
    previous output is zeros; the previous output is held until
    reset()."""
    class Const(trnn.RecurrentCell):
        def state_info(self, batch_size=0):
            return [{"shape": (batch_size, 100)}]

        def forward(self, inputs, states):
            return inputs, [states[0] + 1]

    z = trnn.ZoneoutCell(Const(), zoneout_outputs=0.25, zoneout_states=0.4,
                         generator=torch.Generator().manual_seed(3))
    x = torch.full((200, 100), 2.0)
    out, st = z(x, [torch.zeros(200, 100)])
    assert set(out.unique().tolist()) == {0.0, 2.0}
    assert abs((out == 0).float().mean().item() - 0.25) < 0.01
    assert abs((st[0] == 0).float().mean().item() - 0.4) < 0.01
    out2, _ = z(x * 2, st)
    kept = out2 == 2.0        # the held previous output where dropped
    assert abs(kept.float().mean().item() - 0.25 * 0.75) < 0.01
    z.reset()
    assert z._prev_output is None
    out3, _ = z(x * 2, st)
    assert set(out3.unique().tolist()) == {0.0, 4.0}


def test_bidirectional_cell_with_ragged_lengths_vs_jax():
    """Each sequence reversed over its own length (not a plain flip) for
    r_cell, its outputs reversed back, concatenated on the last axis;
    states l_cell's then r_cell's; gradients agree."""
    jb = jrnn.BidirectionalCell(jrnn.LSTMCell(H, input_size=C),
                                jrnn.GRUCell(H, input_size=C))
    tb = trnn.BidirectionalCell(trnn.LSTMCell(H, input_size=C, device="cpu"),
                                trnn.GRUCell(H, input_size=C, device="cpu"))
    load_jax_params(tb, set_jax_params(jb, 13))
    r = onp.random.RandomState(14)
    x = r.randn(N, T, C).astype("f4")
    dy = r.randn(N, T, 2 * H).astype("f4")
    for vl in (onp.array([T, 4, 1], "int32"), None):
        jx = mx.nd.array(x)
        jx.attach_grad()
        with jautograd.record():
            jo, jst = jb.unroll(T, jx, layout="NTC", merge_outputs=True,
                                valid_length=None if vl is None
                                else mx.nd.array(vl.astype("f4")))
            (jo * mx.nd.array(dy)).sum().backward()
        tx = torch.from_numpy(x).requires_grad_()
        to, tst = tb.unroll(T, tx, layout="NTC", merge_outputs=True,
                            valid_length=None if vl is None
                            else torch.from_numpy(vl))
        (to * torch.from_numpy(dy)).sum().backward()
        assert to.shape == (N, T, 2 * H) and len(tst) == 3
        close(to, jo)
        for a, b in zip(tst, jst):
            close(a, b)
        close(tx.grad, jx.grad, GRAD_TOL)
        tb.zero_grad()
    with pytest.raises(mxt.MXNetError, match="unroll"):
        tb(torch.zeros(N, C), tb.begin_state(N))


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_mask_vs_jax(axis):
    r = onp.random.RandomState(15)
    x = r.randn(*((T, N, 4) if axis == 0 else (N, T, 4))).astype("f4")
    sl = onp.array([2, T, 0], "int32")
    got = SequenceMask(torch.from_numpy(x), torch.from_numpy(sl), True,
                       value=-3.0, axis=axis)
    ref = jF.SequenceMask(mx.nd.array(x), mx.nd.array(sl.astype("f4")),
                          True, value=-3.0, axis=axis)
    assert onp.array_equal(got.numpy(), ref.asnumpy())
    assert SequenceMask(torch.from_numpy(x)) is not None
    assert torch.equal(SequenceMask(torch.from_numpy(x)),
                       torch.from_numpy(x))


def test_sequence_reverse_vs_jax():
    r = onp.random.RandomState(16)
    x = r.randn(T, N, 2, 3).astype("f4")
    sl = onp.array([3, T, 1], "int32")
    got = SequenceReverse(torch.from_numpy(x), torch.from_numpy(sl), True)
    ref = jF.SequenceReverse(mx.nd.array(x), mx.nd.array(sl.astype("f4")),
                             True)
    assert onp.array_equal(got.numpy(), ref.asnumpy())
    # positions past a sequence's length stay
    assert onp.array_equal(got.numpy()[3:, 0], x[3:, 0])
    flipped = SequenceReverse(torch.from_numpy(x))
    assert onp.array_equal(flipped.numpy(), x[::-1])
    seen, w = funnel_names()
    registry.add_invoke_wrapper(w)
    try:
        SequenceReverse(torch.from_numpy(x), torch.from_numpy(sl), True)
        SequenceMask(torch.from_numpy(x), torch.from_numpy(sl), True)
    finally:
        registry.remove_invoke_wrapper(w)
    assert seen == ["sequence_reverse", "sequence_mask"]


# ---- the slice as a whole: a word LM built from cells ----

VOCAB, LM_H, LM_BATCH, LM_BPTT = 50, 16, 4, 6


class JaxCellLM(mx.gluon.HybridBlock):
    """Embedding, two LSTMCells unrolled over the merged NTC batch, a
    Dense head: the JAX side of the cell-built word LM."""

    def __init__(self):
        super().__init__()
        self.emb = jnn.Embedding(VOCAB, LM_H)
        self.l0 = jrnn.LSTMCell(LM_H, input_size=LM_H)
        self.l1 = jrnn.LSTMCell(LM_H, input_size=LM_H)
        self.head = jnn.Dense(VOCAB, flatten=False, in_units=LM_H)

    def forward(self, x):
        h = self.emb(x)
        h, _ = self.l0.unroll(h.shape[1], h, layout="NTC",
                              merge_outputs=True)
        h, _ = self.l1.unroll(h.shape[1], h, layout="NTC",
                              merge_outputs=True)
        return self.head(h)


class CellLM(torch.nn.Module):
    """The port's cell-built word LM (the same layout and names)."""

    def __init__(self, device="cpu"):
        super().__init__()
        self.emb = tnn.Embedding(VOCAB, LM_H, device=device)
        self.l0 = trnn.LSTMCell(LM_H, input_size=LM_H, device=device)
        self.l1 = trnn.LSTMCell(LM_H, input_size=LM_H, device=device)
        self.head = tnn.Dense(VOCAB, flatten=False, in_units=LM_H,
                              device=device)

    def forward(self, x):
        h = self.emb(x)
        h, _ = self.l0.unroll(h.shape[1], h, layout="NTC",
                              merge_outputs=True)
        h, _ = self.l1.unroll(h.shape[1], h, layout="NTC",
                              merge_outputs=True)
        return self.head(h)


@pytest.mark.parametrize("path", ["record", "compile_step"])
def test_cell_word_lm_sgd_momentum_vs_jax(monkeypatch, path):
    """The cell-built LM (vocab 50, H 16): three SGD-momentum steps at lr
    0.5, losses and final weights against the same model built from the
    JAX cells (its fused unroll in interpret mode), 2e-5."""
    monkeypatch.setenv("MXNET_PALLAS", "on")
    r = onp.random.RandomState(17)
    x = r.randint(0, VOCAB, (LM_BATCH, LM_BPTT)).astype("int32")
    y = r.randint(0, VOCAB, (LM_BATCH, LM_BPTT)).astype("int32")
    jnet = JaxCellLM()
    tnet = CellLM()
    params = set_jax_params(jnet, 18, scale=0.2)
    load_jax_params(tnet, params)
    opt = {"learning_rate": 0.5, "momentum": 0.9}
    jtr = JTrainer(jnet.collect_params(), "sgd", dict(opt))
    ttr = TTrainer(dict(tnet.named_parameters()), "sgd", dict(opt))
    jlb, tlb = jloss.SoftmaxCrossEntropyLoss(), \
        tloss.SoftmaxCrossEntropyLoss()
    xs, ys = mx.nd.array(x, dtype="int32"), mx.nd.array(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if path == "compile_step":
        jstep = jtr.compile_step(lambda a, b: jlb(jnet(a), b))
        tstep = ttr.compile_step(lambda a, b: tlb(tnet(a), b))
    for _ in range(3):
        if path == "compile_step":
            jl, tl = jstep(xs, ys).asnumpy(), tstep(tx, ty).numpy()
        else:
            with jautograd.record():
                jl_ = jlb(jnet(xs), ys)
            jl_.backward()
            jtr.step(LM_BATCH)
            tl_ = tlb(tnet(tx), ty)
            tl_.sum().backward()
            ttr.step(LM_BATCH)
            jl, tl = jl_.asnumpy(), tl_.detach().numpy()
        close(tl, jl, GRAD_TOL)
    tp = dict(tnet.named_parameters())
    for k, p in jnet.collect_params().items():
        close(tp[k], p.data(), GRAD_TOL, k)


def _dropout_lm(reset, zoneout=True):
    """Embedding, a VariationalDropout(LSTM) cell and (with ``zoneout``)
    a Zoneout(GRU) cell, a Dense head; the loss calls net.reset() first
    when ``reset``."""
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn
    torch.manual_seed(0)
    net = torch.nn.Module()
    net.emb = tnn.Embedding(VOCAB, LM_H, device="cpu")
    net.cells = trnn.SequentialRNNCell()
    net.cells.add(crnn.VariationalDropoutCell(
        trnn.LSTMCell(LM_H, input_size=LM_H, device="cpu"), 0.3, 0.3, 0.3,
        generator=torch.Generator().manual_seed(4)))
    if zoneout:
        net.cells.add(trnn.ZoneoutCell(
            trnn.GRUCell(LM_H, input_size=LM_H, device="cpu"), 0.2, 0.2,
            generator=torch.Generator().manual_seed(5)))
    net.head = tnn.Dense(VOCAB, flatten=False, in_units=LM_H, device="cpu")
    lb = tloss.SoftmaxCrossEntropyLoss()

    def loss(x, y):
        if reset:
            net.cells.reset()
        h, _ = net.cells.unroll(x.shape[1], net.emb(x), layout="NTC",
                                merge_outputs=True)
        return lb(net.head(h), y)

    return net, loss


def _lm_batch(seed=19):
    r = onp.random.RandomState(seed)
    return (torch.from_numpy(r.randint(0, VOCAB, (LM_BATCH, LM_BPTT))),
            torch.from_numpy(r.randint(0, VOCAB, (LM_BATCH, LM_BPTT))
                             .astype("f4")))


@pytest.mark.parametrize("reset", [True, False])
def test_dropout_cells_under_compile_step_equal_eager(reset):
    """The reset rule under capture (ROADMAP.md §3): with the loss
    calling ``net.reset()`` first, three compile_step calls equal three
    eager steps bit for bit (fresh masks each step from the cells'
    generators). Without it a variational cell keeps its masks from one
    call to the next, in both (on the CPU the step's body runs
    eagerly): the second step reuses the first's masks."""
    x, y = _lm_batch()
    runs = []
    for compiled in (False, True):
        net, loss = _dropout_lm(reset, zoneout=reset)
        tr = TTrainer(dict(net.named_parameters()), "sgd",
                      {"learning_rate": 0.5, "momentum": 0.9})
        step = tr.compile_step(loss) if compiled else None
        losses, masks = [], []
        for _ in range(3):
            if compiled:
                losses.append(step(x, y))
            else:
                lv = loss(x, y)
                lv.sum().backward()
                tr.step(LM_BATCH)
                losses.append(lv.detach())
            masks.append(net.cells[0].drop_inputs_mask.clone())
        runs.append((losses, masks, [p.detach().clone()
                                     for p in net.parameters()]))
    for a, b in zip(runs[0], runs[1]):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    masks = runs[0][1]
    assert torch.equal(masks[0], masks[1]) is (not reset)
    # the mask: 0 or 1 / 0.7 in float32
    vals = torch.unique(masks[0])
    assert len(vals) == 2 and vals[0] == 0
    assert vals[1] == torch.ones(()) / 0.7


@pytest.mark.parametrize("compiled", [False, True])
def test_zoneout_without_reset_holds_the_last_steps_graph(compiled):
    """Without ``reset()`` a training ZoneoutCell holds the previous
    call's last output, with its autograd graph: the next training
    step's backward reaches that freed graph and raises, eagerly and
    under compile_step (ROADMAP.md §3). A no-grad forward carries the
    output over as the JAX package does."""
    x, y = _lm_batch()
    net, loss = _dropout_lm(False)
    tr = TTrainer(dict(net.named_parameters()), "sgd",
                  {"learning_rate": 0.1})
    step = tr.compile_step(loss) if compiled else None

    def train_step():
        if compiled:
            return step(x, y)
        lv = loss(x, y)
        lv.sum().backward()
        tr.step(LM_BATCH)
        return lv

    train_step()
    held = net.cells[1]._prev_output
    assert held is not None and held.grad_fn is not None
    with pytest.raises(RuntimeError, match="backward through the graph"):
        train_step()
    net.cells.reset()
    with torch.no_grad():
        loss(x, y)
        first = net.cells[1]._prev_output
        loss(x, y)
    assert net.cells[1]._prev_output is not first
