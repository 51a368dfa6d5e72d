"""Kernel 12 as one launch over a list (``ops/kernels/opt_update.py``
``multi_update``), on the CPU: its plain version against the per-entry
``unit_update_plain`` and each entry against the JAX ``unit_update`` in
interpret mode; the host's plan of a launch (each entry cut into
chunks, one block of the kernel's grid a chunk); the optimizer's
eager route through the list (the card's bookkeeping, its arithmetic
run by the plain version here); and a dropped compiled step or ``TrainLoop`` freed at once, without the
cyclic garbage collector.

Tolerances: the plain version of a list equals its entries' plain
versions bit for bit (the same ops in the same order). Against the JAX
kernel, those of ``tests/test_torch_zero.py``: float32 states within
2**-23 and weights within 2**-21 (XLA's CPU backend contracts
``b * m + x`` into one FMA), bfloat16 states bit-exact and weights within
one bfloat16 ulp (2**-8 relative). The eager route against ``_apply``:
SGD bit for bit; Adam within 1e-6 absolute, since ``_apply`` takes
``1 - b1 ** t`` in double and the kernel's rule a float32 ``pow``.
"""
import bisect
import gc
import os
import re
import weakref

import numpy as onp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import TrainLoop
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops.kernels import opt_update as topu
from mxnet_tpu_torch.optimizer import optimizer as O
from mxnet_tpu_torch.optimizer.optimizer import DeviceHParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "sgd": ("sgd", {"momentum": 0.0}, 0),
    "sgd_mom": ("sgd", {"momentum": 0.9}, 1),
    "adam": ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, 2),
}
#: a list's lengths: 1 to 768 values, one no multiple of the pack, and
#: (last) a view one element into a larger buffer
LENGTHS = (1, 3, 64, 768, 1001, 999)


def _entries(n_states, form, dtype, seed=0, lengths=LENGTHS):
    """Flat units of ``lengths`` (the last a misaligned view) with their
    lr / wd / t in ``form``: "host" scalars, per-element "vector"s or
    "device" 0-d views of one ``DeviceHParams`` block (on the CPU here).
    Returns (ws, gs, states, lrs, wds, ts, rescale, clip)."""
    r = onp.random.RandomState(seed)
    ws, gs, sts, hps = [], [], [], []
    for i, n in enumerate(lengths):
        w = torch.from_numpy(r.randn(n).astype("f4")).to(dtype)
        if i == len(lengths) - 1:
            big = torch.zeros(n + 1, dtype=dtype)
            w = big[1:].copy_(w)
        ws.append(w)
        gs.append(torch.from_numpy(r.randn(n).astype("f4") * 3).to(dtype))
        sts.append(tuple(torch.from_numpy(
            abs(r.randn(n)).astype("f4") * 0.1).to(dtype)
            for _ in range(n_states)))
        if form == "vector":
            hps.append((torch.from_numpy(r.rand(n).astype("f4") * 0.1),
                        torch.from_numpy(r.rand(n).astype("f4") * 0.01),
                        torch.from_numpy(r.randint(1, 5, n).astype("i4"))))
        else:
            hps.append((0.05 * (1 + i % 3), 0.01 * (i % 2), 1 + i % 4))
    rescale, clip = 0.25, 0.5
    if form == "device":
        hp = DeviceHParams(len(hps), "cpu")
        hp.stage(*zip(*hps), rescale, clip)
        hps = list(zip(*hp.per_param()))
        rescale, clip = hp.rescale, hp.clip
    lrs, wds, ts = (list(c) for c in zip(*hps))
    return ws, gs, sts, lrs, wds, ts, rescale, clip


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["host", "vector", "device"])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_update_plain_equals_unit_update_plain(case, clip, form,
                                                     dtype):
    """The list's plain version is each entry's ``unit_update_plain`` in
    order, bit for bit; ``multi_update`` on CPU tensors writes exactly
    those values in place (and each low copy is the rounding of its new
    float32 weight)."""
    kind, extra, n_states = CASES[case]
    cfg = dict(extra, has_clip=clip)
    ws, gs, sts, lrs, wds, ts, rescale, clip_v = _entries(n_states, form,
                                                          dtype, seed=7)
    plain = topu.multi_update_plain(kind, cfg, ws, gs, lrs, wds, ts,
                                    rescale, clip_v, sts)
    assert len(plain) == len(ws)
    for i, (pw, ps) in enumerate(plain):
        uw, us = topu.unit_update_plain(kind, cfg, ws[i], gs[i], lrs[i],
                                        wds[i], ts[i], rescale, clip_v,
                                        sts[i])
        assert torch.equal(pw, uw) and pw.dtype == dtype
        assert len(ps) == len(us) == n_states
        assert all(torch.equal(a, b) for a, b in zip(ps, us))
    kw = [w.clone() for w in ws]
    ks = [tuple(s.clone() for s in st) for st in sts]
    lows = [torch.empty(w.numel(), dtype=torch.bfloat16)
            if dtype == torch.float32 and i % 2 else None
            for i, w in enumerate(ws)]
    out_w, out_s = topu.multi_update(kind, cfg, kw, gs, lrs, wds, ts,
                                     rescale, clip_v, ks, lows)
    assert all(a is b for a, b in zip(out_w, kw))
    for w, st, low, (pw, ps) in zip(kw, ks, lows, plain):
        assert torch.equal(w, pw)
        assert all(torch.equal(a, b) for a, b in zip(st, ps))
        if low is not None:
            assert torch.equal(low, pw.to(torch.bfloat16))
    assert K.launch_counts()["opt_update"] == 0


def _jax_unit(kind, cfg, w, g, lr, wd, t, rescale, clip, states, dtype):
    import jax.numpy as jnp
    from mxnet_tpu.ops.kernels import opt_update as jopu
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    arr = lambda a: jnp.asarray(a.float().numpy(), jdt)      # noqa: E731
    hp = lambda v: jnp.asarray(v.numpy()) if isinstance(  # noqa: E731
        v, torch.Tensor) else v
    nw, ns = jopu.unit_update(kind, cfg, arr(w), arr(g), hp(lr), hp(wd),
                              hp(t), jnp.float32(rescale),
                              jnp.float32(clip),
                              tuple(arr(s) for s in states), interpret=True)
    return (onp.asarray(nw, onp.float32),
            [onp.asarray(s, onp.float32) for s in ns])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["host", "vector"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_update_entries_vs_jax_kernel(case, form, dtype):
    """Each entry of a list through ``multi_update`` (the plain version on
    the CPU) against the JAX ``unit_update`` of that entry alone, in
    interpret mode, clip on: float32 within tests/test_torch_zero.py's
    bounds, bfloat16 states bit-exact and weights within a bfloat16
    ulp."""
    kind, extra, n_states = CASES[case]
    cfg = dict(extra, has_clip=True)
    lengths = (1, 64, 1001)
    ws, gs, sts, lrs, wds, ts, rescale, clip = _entries(
        n_states, form, dtype, seed=11, lengths=lengths)
    refs = [_jax_unit(kind, cfg, ws[i], gs[i], lrs[i], wds[i], ts[i],
                      rescale, clip, sts[i], dtype)
            for i in range(len(ws))]
    topu.multi_update(kind, cfg, ws, gs, lrs, wds, ts, rescale, clip, sts)
    for w, st, (jw, js) in zip(ws, sts, refs):
        if dtype == torch.float32:
            for a, b in zip(st, js):
                onp.testing.assert_allclose(a.numpy(), b, rtol=0,
                                            atol=2 ** -23)
            onp.testing.assert_allclose(w.numpy(), jw, rtol=0,
                                        atol=2 ** -21)
        else:
            for a, b in zip(st, js):
                onp.testing.assert_array_equal(a.float().numpy(), b)
            onp.testing.assert_allclose(w.float().numpy(), jw,
                                        rtol=2 ** -8, atol=0)


def _chunk_range(c, ns, first, chunk):
    """What the kernel updates for chunk ``c`` of a launch planned by
    ``plan_launches`` (csrc/opt_update.cu's mapping, written out): block c
    takes the last entry whose first chunk is at or before c, and its
    elements ``[(c - first) * chunk, ...)``, at most ``chunk``."""
    k = bisect.bisect_right(first, c) - 1
    base = (c - first[k]) * chunk
    return k, base, min(base + chunk, ns[k])


@settings(max_examples=200, deadline=None)
@given(ns=st.lists(st.integers(0, 40000), min_size=1, max_size=40),
       capacity=st.integers(1, 6), chunk=st.sampled_from([8, 64, 1024,
                                                          2048, 8192]))
def test_plan_covers_every_element_once_on_pack_boundaries(ns, capacity,
                                                           chunk):
    """The host's plan and the kernel's mapping of a chunk to its entry
    (``_chunk_range``): over the launches, every element of every entry
    with elements is updated exactly once, every chunk starts on a
    multiple of 8 of its entry (its 16-byte packs stay whole) and holds
    1 to ``chunk`` elements, a launch holds at most ``capacity`` entries
    in order, and the plan is a pure function."""
    plan = topu.plan_launches(ns, chunk, capacity)
    assert plan == topu.plan_launches(list(ns), chunk, capacity)
    seen = [onp.zeros(n, onp.int32) for n in ns]
    launched = []
    for idx, first, n_chunks in plan:
        assert 1 <= len(idx) <= capacity and first[0] == 0
        sizes = [ns[k] for k in idx]
        assert n_chunks == sum(-(-n // chunk) for n in sizes)
        launched += idx
        for c in range(n_chunks):
            j, a, z = _chunk_range(c, sizes, first, chunk)
            assert a % 8 == 0 and 0 <= a < z <= sizes[j] and z - a <= chunk
            seen[idx[j]][a:z] += 1
    assert launched == [k for k, n in enumerate(ns) if n > 0]
    assert all((s == 1).all() for s in seen)


def test_entry_layout_matches_the_kernel_source():
    """The table's record and capacity are those of csrc/opt_update.cu."""
    with open(os.path.join(ROOT, "mxnet_tpu_torch", "ops", "kernels",
                           "csrc", "opt_update.cu")) as f:
        src = f.read()
    assert topu.ENTRY_DTYPE.itemsize == int(re.search(
        r"sizeof\(OptEntry\) == (\d+)", src).group(1)) == 80
    assert topu.CAPACITY == int(re.search(
        r"#define OPT_CAPACITY (\d+)", src).group(1))
    fields = re.search(r"struct OptEntry \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+)(?:, (\w+))?(?:, (\w+))?;", fields)
    flat = [n for group in names for n in group if n]
    assert flat == list(topu.ENTRY_DTYPE.names)


def test_multi_update_refuses_mixed_forms():
    cfg = {"momentum": 0.9, "has_clip": False}
    w = torch.zeros(8)
    with pytest.raises(Exception, match="differ in length"):
        topu.multi_update("sgd", cfg, [w], [w, w], [0.1], [0.0], [1], 1.0,
                          0.0, [(torch.zeros(8),)])
    with pytest.raises(Exception, match="states"):
        topu.multi_update("sgd", cfg, [w], [w], [0.1], [0.0], [1], 1.0,
                          0.0, [()])


# ---------------------------------------------------------------------------
# the eager update's route through the list
# ---------------------------------------------------------------------------

def _eager_params(dtype, seed=3):
    r = onp.random.RandomState(seed)
    shapes = [(16, 8), (16,), (3, 16), (3,)]
    return [torch.nn.Parameter(torch.from_numpy(
        (r.randn(*s) * 0.1).astype("f4")).to(dtype)) for s in shapes], \
        [torch.from_numpy(r.randn(*s).astype("f4")).to(dtype)
         for s in shapes]


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
             "clip_gradient": 0.5}),
    ("sgd", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 1e-2, "wd": 1e-3}),
    ("adam", {"learning_rate": 1e-2, "multi_precision": True,
              "lr_scheduler": "factor"}),
], ids=["sgd_mom_clip", "sgd", "adam", "adam_bf16_mp_scheduled"])
def test_eager_kernel_route_bookkeeping(monkeypatch, name, kw):
    """``Optimizer.update``'s kernel route (what a card runs: one
    ``multi_update`` a step), here with its arithmetic in the plain
    version, against the rule parameter by parameter (``_apply``, what the
    CPU runs): the same counts, lr and wd a parameter (a scheduler read
    after the counts; with a master in the list one parameter at a time),
    each bf16 weight its master's rounding; three steps, SGD bit for bit,
    Adam within 1e-6."""
    from mxnet_tpu_torch import lr_scheduler as tlrs
    kw = dict(kw)
    mp = kw.get("multi_precision", False)
    runs, calls = [], []
    real = topu.multi_update

    def counted(*a, **k):
        calls.append(len(a[2]))
        return real(*a, **k)

    for route in (True, False):
        if kw.get("lr_scheduler") is not None:
            kw["lr_scheduler"] = tlrs.FactorScheduler(step=2, factor=0.5)
        params, grads = _eager_params(torch.bfloat16 if mp else
                                      torch.float32)
        tr = TTrainer({str(i): p for i, p in enumerate(params)}, name,
                      dict(kw))
        with monkeypatch.context() as m:
            m.setattr(O, "_on_card", lambda w: route)
            m.setattr(topu, "multi_update", counted)
            for _ in range(3):
                for p, g in zip(params, grads):
                    p.grad, p.fresh_grad = g.clone(), True
                tr.step(4)
        opt = tr.optimizer
        masters = [tr._updater.states[i][1] for i in range(len(params))] \
            if mp else None
        if mp:
            assert all(torch.equal(p.detach(), mw.to(p.dtype))
                       for p, mw in zip(params, masters))
        runs.append(([p.detach().float() for p in params], masters,
                     dict(opt._index_update_count), opt.num_update,
                     opt.learning_rate))
    assert calls == [len(params)] * 3
    (w1, m1, c1, n1, lr1), (w2, m2, c2, n2, lr2) = runs
    assert c1 == c2 and n1 == n2 == 3 and lr1 == lr2
    for a, b in zip(m1 if mp else w1, m2 if mp else w2):
        if name == "sgd":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_eager_update_keeps_the_rule_on_the_cpu():
    """On the CPU ``Optimizer.update`` runs ``_apply`` (the JAX ``_rule``
    the CPU tests hold it to): the kernel route is not taken, nothing is
    launched; a subclass and AdamW never take it."""
    params, grads = _eager_params(torch.float32)
    opt = topt.Adam(learning_rate=1e-2)
    assert opt._kernel_update(params, [()] * len(params)) is None
    assert topt.AdamW()._kernel_update(params, [()] * 4) is None
    tr = TTrainer({str(i): p for i, p in enumerate(params)}, "adam")
    for p, g in zip(params, grads):
        p.grad, p.fresh_grad = g.clone(), True
    K.reset_launch_counts()
    tr.step(4)
    assert K.launch_counts()["opt_update"] == 0


# ---------------------------------------------------------------------------
# a dropped step frees its programs at once
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("owner", ["step", "loop"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_dropped_step_is_freed_without_the_collector(owner, opt):
    """With the cyclic collector off, a ``CompiledTrainStep`` (and its
    programs) that was captured and stepped, or a ``TrainLoop`` and its
    step, is gone right after ``del``: nothing holds it in a reference
    cycle (a loop's loss holds the net and the loss block, not the
    loop), so on a card its graph pool goes back at once."""
    gc.collect()
    gc.disable()
    try:
        net = Dense(3, in_units=4, device="cpu")
        tr = TTrainer(dict(net.named_parameters()), opt,
                      {"learning_rate": 0.01})
        lb = tloss.SoftmaxCrossEntropyLoss()
        x, y = torch.randn(2, 4), torch.tensor([0.0, 1.0])
        if owner == "step":
            obj = step = tr.compile_step(lambda a, b: lb(net(a), b))
            step.aot_compile(x, y)
        else:
            obj = TrainLoop(net, tr, lb)
            step = obj.compiled_step
        for _ in range(2):
            obj.step(x, y)
        assert step.n_traces == 1 and len(step._programs) == 1
        refs = [weakref.ref(v) for v in (obj, step, step._programs)]
        del obj, step
        assert all(r() is None for r in refs)
        assert len(tr._live_compiled_steps()) == 0
    finally:
        gc.enable()
