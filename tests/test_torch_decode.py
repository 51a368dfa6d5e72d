"""The port's decode modules against the JAX package on the CPU: the
single-step recurrence (``rnn_decode_step``, ``rnn_verify_scan``), paged
decode attention, the paged KV cache, and the two decode models'
``decode_step`` / ``prefill_chunk`` / ``verify_chunk``.

Inputs come from seeded numpy. Tolerances: 1e-6 absolute in float32 for
one recurrence step and for attention over a few keys (float32 sums of
at most a few dozen terms in another order); 1e-5 for a model's state and
pages after a whole entry point (two products of width 32 more); tokens
exactly. The JAX recurrence runs under ``MXNET_PALLAS=on``, its
interpret-mode Pallas kernel, and ``off``, its XLA reference.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import serving as JS
from mxnet_tpu.gluon import GQADecoder as JGQADecoder
from mxnet_tpu.ops import attention as JATT
from mxnet_tpu.ops import rnn as JRNN
from mxnet_tpu.ops.kernels import rnn_scan as JK

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon import GQADecoder
from mxnet_tpu_torch.gluon.params import load_jax_params
from mxnet_tpu_torch.ops import attention as ATT
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops.kernels import rnn_scan as KR
from mxnet_tpu_torch.serving import PagedKVCache, TinyDecoder, kvcache

MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]
TOL = 1e-6
MODEL_TOL = 1e-5


def _step_inputs(mode, n, h, seed):
    rng = onp.random.RandomState(seed)
    g = KR.GATES[mode]
    return (rng.randn(n, g * h).astype("f4"), rng.randn(n, h).astype("f4"),
            rng.randn(n, h).astype("f4"),
            (rng.randn(g * h, h) * 0.3).astype("f4"),
            rng.randn(g * h).astype("f4"))


def _t(*arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


# ---------------------------------------------------------------------------
# the single step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pallas", ["on", "off"])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_decode_step_vs_jax(mode, pallas, monkeypatch):
    xw, h, c, w, b = _step_inputs(mode, 4, 8, seed=3)
    monkeypatch.setenv("MXNET_PALLAS", pallas)
    jh, jc = JK.rnn_decode_step(*(jnp.asarray(a) for a in (xw, h, c, w, b)),
                                mode)
    K.reset_launch_counts()
    th, tc = KR.rnn_decode_step(*_t(xw, h, c, w, b), mode)
    assert K.launch_counts()["rnn_decode"] == 0     # the CPU: plain version
    onp.testing.assert_allclose(th.numpy(), onp.asarray(jh), atol=TOL)
    if mode == "lstm":
        onp.testing.assert_allclose(tc.numpy(), onp.asarray(jc), atol=TOL)
    else:
        assert tc is None and jc is None


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_decode_step_at_128_rows_vs_jax(mode, monkeypatch):
    """128 rows at decode_wide's H 650, a batch the card kernel now takes
    in two row groups (the first version refused it): the plain step
    against the JAX package's interpret-mode kernel."""
    xw, h, c, w, b = _step_inputs(mode, 128, 650, seed=9)
    w = w * 650 ** -0.5
    monkeypatch.setenv("MXNET_PALLAS", "on")
    jh, jc = JK.rnn_decode_step(*(jnp.asarray(a) for a in (xw, h, c, w, b)),
                                mode)
    th, tc = KR.rnn_decode_step(*_t(xw, h, c, w, b), mode)
    onp.testing.assert_allclose(th.numpy(), onp.asarray(jh), atol=TOL)
    if mode == "lstm":
        onp.testing.assert_allclose(tc.numpy(), onp.asarray(jc), atol=TOL)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_verify_scan_ragged_vs_jax(mode, monkeypatch):
    rng = onp.random.RandomState(11)
    k, n, h = 4, 3, 8
    g = KR.GATES[mode]
    xw = rng.randn(k, n, g * h).astype("f4")
    _, h0, c0, w, b = _step_inputs(mode, n, h, seed=12)
    valid = onp.array([[1, 1, 0], [1, 0, 0], [1, 0, 0], [0, 0, 0]], bool)
    monkeypatch.setenv("MXNET_PALLAS", "on")
    jhs, jcs = JK.rnn_verify_scan(
        *(jnp.asarray(a) for a in (xw, h0, c0, w, b)), mode,
        jnp.asarray(valid))
    ths, tcs = KR.rnn_verify_scan(*_t(xw, h0, c0, w, b), mode,
                                  torch.from_numpy(valid))
    assert tuple(ths.shape) == (k, n, h)
    onp.testing.assert_allclose(ths.numpy(), onp.asarray(jhs), atol=TOL)
    if mode == "lstm":
        onp.testing.assert_allclose(tcs.numpy(), onp.asarray(jcs), atol=TOL)
    # a slot with no valid position keeps its carry bit for bit
    assert torch.equal(ths[:, 2], torch.from_numpy(h0)[2].expand(k, h))
    # the trajectory is the single step, masked
    h1, _ = KR.rnn_decode_step(*_t(xw[0], h0, c0, w, b), mode)
    assert torch.equal(ths[0, :2], h1[:2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_decode_step_is_scan_position(mode, dtype, monkeypatch):
    """A token decoded step by step equals the same position of the
    port's scan bit for bit (both dtypes), and the JAX scan within 1e-6
    in float32."""
    rng = onp.random.RandomState(5)
    t_len, n, h = 5, 3, 8
    g = KR.GATES[mode]
    xw = torch.from_numpy(rng.randn(t_len, n, g * h).astype("f4")).to(dtype)
    w = torch.from_numpy((rng.randn(g * h, h) * 0.3).astype("f4"))
    b = torch.from_numpy(rng.randn(g * h).astype("f4"))
    h0 = torch.zeros(n, h, dtype=dtype)
    c0 = torch.zeros(n, h, dtype=dtype) if mode == "lstm" else None
    ys, cs = KR.rnn_scan_plain(xw, h0, c0, w, b, mode)
    hh, cc = h0, c0
    for t in range(t_len):
        hh, cc = KR.rnn_decode_step(xw[t], hh, cc, w, b, mode)
        assert hh.dtype == dtype
        assert torch.equal(hh, ys[t])
        if mode == "lstm":
            assert torch.equal(cc, cs[t])
    if dtype == torch.float32:
        monkeypatch.setenv("MXNET_PALLAS", "off")
        jys, _, _ = JRNN.scan_reference(
            jnp.asarray(xw.numpy()), jnp.zeros((n, h), "float32"),
            jnp.zeros((n, h), "float32") if mode == "lstm" else None,
            jnp.asarray(w.numpy()), jnp.asarray(b.numpy()), mode)
        onp.testing.assert_allclose(ys.numpy(), onp.asarray(jys), atol=TOL)


def test_decode_bf16_state_within_bf16_resolution():
    xw, h, c, w, b = _step_inputs("lstm", 4, 16, seed=8)
    f32 = KR.rnn_decode_step(*_t(xw, h, c, w, b), "lstm")
    bf = KR.rnn_decode_step(*(t.to(torch.bfloat16) if i < 3 else t
                              for i, t in enumerate(_t(xw, h, c, w, b))),
                            "lstm")
    for a, r in zip(bf, f32):
        assert a.dtype == torch.bfloat16
        assert (a.float() - r).abs().max() < 2e-2


def test_decode_bf16_weights_equal_their_float32_form():
    """The kernel reads W_hh and b_hh in their own dtype and widens them
    in registers, as the float32 copy it no longer makes would hold them:
    the plain step with bfloat16 weights equals, bit for bit, the step
    with those weights widened to float32."""
    xw, h, c, w, b = _step_inputs("lstm", 8, 64, seed=9)
    acts = tuple(t.to(torch.bfloat16) for t in _t(xw, h, c))
    wb, bb = (t.to(torch.bfloat16) for t in _t(w, b))
    for mode in MODES:
        g = KR.GATES[mode]
        x_ = acts[0][:, :g * 64].contiguous()
        narrow = KR.rnn_decode_step(x_, acts[1], acts[2], wb[:g * 64],
                                    bb[:g * 64], mode)
        wide = KR.rnn_decode_step(x_, acts[1], acts[2],
                                  wb[:g * 64].float(), bb[:g * 64].float(),
                                  mode)
        for a, r in zip(narrow, wide):
            if r is not None:
                assert a.dtype == torch.bfloat16
                assert torch.equal(a, r), mode


#: (N, H, mode) -> (path, groups): decode_wide's bucket 8 at the word LM's
#: H 650 and decode_leg's H 128 (W_hh's rows and h in shared memory), two
#: row groups at N 128, H 4,096 at N 2 (h staged, W_hh through registers),
#: and H 60,000, where not one row of h fits a block (h through L2)
DECODE_PLANS = [
    ((8, 650, "lstm"), ("tma", 1)),
    ((8, 128, "lstm"), ("tma", 1)),
    ((128, 650, "lstm"), ("staged", 2)),
    ((2, 4096, "lstm"), ("staged", 1)),
    ((64, 4096, "rnn_tanh"), ("staged", 5)),
    ((3, 37, "gru"), ("tma", 1)),
    ((2, 60000, "rnn_tanh"), ("l2", 1)),
]


@pytest.mark.parametrize("case,want", DECODE_PLANS)
def test_rnn_decode_plan_branches(case, want):
    n, h, mode = case
    plan = KR.rnn_decode_plan(n, h, mode)
    g = KR.GATES[mode]
    assert (plan["path"], plan["groups"]) == want
    assert plan["staged"] == (plan["path"] != "l2")
    assert plan["sms"] == 132                  # an H100's, without a card
    assert plan["rows"] == g * plan["units"]
    assert plan["threads"] == 32 * plan["warps"] <= 32 * KR.DEC_MAX_WARPS
    assert plan["warps"] * plan["rows_per_warp"] >= plan["rows"]
    assert plan["groups"] * plan["group_rows"] >= n
    assert plan["blocks"] == -(-h // plan["units"]) * plan["groups"]
    # a group's blocks about fill the card: one wave, none ragged
    assert plan["blocks"] <= plan["groups"] * plan["sms"]
    assert plan["smem_bytes"] <= 232448
    if plan["path"] != "tma":
        assert plan["smem_bytes"] == 4 * plan["group_rows"] * (
            (h if plan["staged"] else 0) + plan["rows"])
    # bfloat16 halves what the shared-memory path holds, so a shape may
    # move onto it (N 128 x H 650 does); on one path the grid is the same
    bf = KR.rnn_decode_plan(n, h, mode, torch.bfloat16)
    assert bf["smem_bytes"] <= 232448
    if bf["path"] == plan["path"]:
        assert bf["smem_bytes"] <= plan["smem_bytes"]
        assert {k: v for k, v in bf.items() if k != "smem_bytes"} == \
            {k: v for k, v in plan.items() if k != "smem_bytes"}
    else:
        assert (plan["path"], bf["path"]) == ("staged", "tma")


def test_rnn_decode_plan_at_decode_wide():
    """N 8 x H 650: 2,600 gate rows as 130 blocks of 5 units (20 rows, 4 a
    warp), W_hh's rows and h copied to shared memory; the first version
    took 325 blocks of 8 rows."""
    plan = KR.rnn_decode_plan(8, 650, "lstm")
    assert (plan["units"], plan["blocks"], plan["warps"],
            plan["rows_per_warp"], plan["path"]) == (5, 130, 5, 4, "tma")
    with pytest.raises(mxt.MXNetError, match="no kernel"):
        KR.rnn_decode_plan(8, 650, "elman")


def test_decode_step_refuses_what_it_does_not_take():
    xw, h, c, w, b = _t(*_step_inputs("lstm", 2, 4, seed=1))
    with pytest.raises(mxt.MXNetError, match="unknown mode"):
        KR.rnn_decode_step(xw, h, c, w, b, "elman")
    with pytest.raises(mxt.MXNetError, match="one timestep"):
        KR.rnn_decode_step(xw[None], h, c, w, b, "lstm")
    assert KR.decode_supported(xw.half(), h, c, "lstm") is not None
    # the CPU runs the plain version in any float dtype
    out, _ = KR.rnn_decode_step(xw.double(), h.double(), c.double(), w, b,
                                "lstm")
    assert out.dtype == torch.float64
    meta = torch.empty(2, 16, device="meta")
    with pytest.raises(mxt.MXNetError, match="not supported"):
        KR.rnn_decode_step(meta, torch.empty(2, 4, device="meta"),
                           torch.empty(2, 4, device="meta"),
                           torch.empty(16, 4, device="meta"),
                           torch.empty(16, device="meta"), "lstm")


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (6, 1)])
def test_paged_decode_attention_vs_jax(hq, hkv):
    rng = onp.random.RandomState(9)
    s, d, p, ps = 3, 8, 7, 4
    q = rng.randn(s, hq, d).astype("f4")
    kp = rng.randn(p, ps, hkv, d).astype("f4")
    vp = rng.randn(p, ps, hkv, d).astype("f4")
    table = onp.array([[3, 1, 0], [5, 2, 4], [6, 0, 0]], onp.int32)
    lengths = onp.array([5, 11, 2], onp.int32)
    ref = JATT.paged_decode_attention(*(jnp.asarray(a) for a in (
        q, kp, vp, table, lengths)))
    got = ATT.paged_decode_attention(*_t(q, kp, vp), torch.from_numpy(
        table).long(), torch.from_numpy(lengths))
    assert tuple(got.shape) == (s, hq, d)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref), atol=TOL,
                                rtol=TOL)
    if hq != hkv:
        # the GQA broadcast is repeat_interleave: stored head j serves
        # query heads [j*g, (j+1)*g)
        g = hq // hkv
        rep = ATT.paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(kp).repeat_interleave(
                g, dim=2), torch.from_numpy(vp).repeat_interleave(g, dim=2),
            torch.from_numpy(table).long(), torch.from_numpy(lengths))
        onp.testing.assert_allclose(got.numpy(), rep.numpy(), atol=TOL)


def test_paged_decode_attention_rejects_uneven_groups():
    q = torch.zeros(2, 4, 8)
    kp = torch.zeros(4, 4, 3, 8)
    with pytest.raises(mxt.MXNetError, match="multiple"):
        ATT.paged_decode_attention(q, kp, kp, torch.zeros(2, 2).long(),
                                   torch.ones(2).long())


# ---------------------------------------------------------------------------
# the paged KV cache
# ---------------------------------------------------------------------------

def test_kvcache_null_page_and_freelist():
    kv = PagedKVCache(1, 2, 16, num_pages=5, page_size=4)
    assert kv.free_pages() == 4
    a, b = object(), object()
    pa = kv.alloc(a, 3)
    assert pa is not None and 0 not in pa
    assert kv.alloc(b, 2) is None
    pb = kv.alloc(b, 1)
    assert pb is not None and kv.free_pages() == 0
    assert kv.release(a) == 3
    assert kv.free_pages() == 3
    assert kv.used_pages() == 1 and kv.pages_of(b) == pb
    assert kv.k_pages.shape == (1, 5, 4, 2, 16)
    assert kv.total_bytes() == kv.bytes_per_page * kv.num_pages \
        == 2 * 5 * 4 * 2 * 16 * 4
    with pytest.raises(mxt.MXNetError, match="num_pages >= 2"):
        PagedKVCache(1, 2, 16, num_pages=1, page_size=4)


def test_kvcache_reserve_excludes_pages_from_admission():
    kv = PagedKVCache(1, 2, 16, num_pages=5, page_size=4)
    a, b = object(), object()
    assert kv.reserve(a, 3)
    assert not kv.can_reserve(2)
    assert not kv.reserve(b, 2)
    pages = kv.alloc(a, 3)
    assert len(pages) == 3 and kv.free_pages() == 1
    assert kv.reserve(b, 1)
    kv.trim_reservation(b, 0)
    assert kv.free_pages() == 1


def test_kvcache_share_refcounts_and_last_holder_frees():
    kv = PagedKVCache(1, 2, 16, num_pages=8, page_size=4)
    a, b = object(), object()
    pa = kv.alloc(a, 3)
    kv.register_prefix([1, 2, 3, 4, 5], 5, pa[:2])
    kv.share(b, pa[:2])
    kv.alloc(b, 1)
    assert kv.used_pages() == 4 and kv.logical_pages() == 6
    assert kv.shared_pages() == 2
    assert kv.release(a) == 1
    assert kv.prefix_entries() == 1
    assert kv.release(b) == 3
    assert kv.used_pages() == 0 and kv.free_pages() == 7
    assert kv.prefix_entries() == 0
    with pytest.raises(mxt.MXNetError, match="not allocated"):
        kv.share(object(), [3])


def test_kvcache_cow_copies_the_page_on_the_device():
    kv = PagedKVCache(2, 2, 4, num_pages=8, page_size=4)
    a, b = object(), object()
    (p,) = kv.alloc(a, 1)
    kv.k_pages[:, p] = 7.0
    kv.v_pages[:, p] = -3.0
    k_id = kv.k_pages.data_ptr()
    kv.share(b, [p])
    assert kv.page_shared(p)
    new = kv.cow(b, p)
    assert new != p and not kv.page_shared(p)
    assert kv.pages_of(b) == [new] and kv.pages_of(a) == [p]
    assert kv.cow_copies == 1 and kv.k_pages.data_ptr() == k_id
    assert torch.equal(kv.k_pages[:, new], kv.k_pages[:, p])
    assert torch.equal(kv.v_pages[:, new], kv.v_pages[:, p])
    with pytest.raises(mxt.MXNetError, match="does not hold"):
        kv.cow(b, p)


def test_kvcache_lookup_byte_verifies_under_hash_collision(monkeypatch):
    monkeypatch.setattr(kvcache, "prefix_hash", lambda toks: 7)
    kv = PagedKVCache(1, 2, 16, num_pages=8, page_size=4)
    a, b = object(), object()
    pa, pb = kv.alloc(a, 2), kv.alloc(b, 2)
    kv.register_prefix([1, 2, 3, 4, 5], 5, pa)
    kv.register_prefix([9, 8, 7, 6, 5], 5, pb)
    assert kv.lookup_prefix(onp.asarray([1, 2, 3, 4, 5, 6])).pages \
        == tuple(pa)
    assert kv.lookup_prefix(onp.asarray([9, 8, 7, 6, 5, 1])).pages \
        == tuple(pb)
    assert kv.lookup_prefix(onp.asarray([1, 2, 3, 9, 5, 6])) is None
    assert kv.lookup_prefix(onp.asarray([1, 2, 3, 4, 5, 6]),
                            max_pos=4) is None


def test_kvcache_lookup_matches_jax_registry():
    """The same registrations and lookups give the same entries in both
    packages."""
    regs = [([4, 4, 1, 2, 3, 9], 3), ([4, 4, 1, 2, 3, 9], 6),
            ([7, 1], 2)]
    probes = [[4, 4, 1, 2, 3, 9, 5], [4, 4, 1, 8], [7, 1, 7], [4, 4]]
    found = []
    for mod in (JS.kvcache, kvcache):
        kv = mod.PagedKVCache(1, 1, 4, num_pages=12, page_size=2)
        owner = object()
        for toks, pos in regs:
            kv.register_prefix(toks, pos, kv.alloc(owner, -(-pos // 2)))
        hits = [kv.lookup_prefix(onp.asarray(p, onp.int32)) for p in probes]
        found.append([(e.pos, e.pages) if e is not None else None
                      for e in hits])
    assert found[0] == found[1]
    assert kvcache.prefix_hash([1, 2, 3]) == JS.kvcache.prefix_hash([1, 2, 3])


# ---------------------------------------------------------------------------
# the models, weights carried by load_jax_params
# ---------------------------------------------------------------------------

def _flat(params, prefix=""):
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(params, list):
        for i, v in enumerate(params):
            out.update(_flat(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = onp.asarray(params)
    return out


def _models(kind):
    if kind == "tiny":
        jm = JS.TinyDecoder(vocab=40, d_model=32, num_heads=2, seed=3)
        tm = TinyDecoder(vocab=40, d_model=32, num_heads=2, seed=99,
                         device="cpu")
    else:
        jm = JGQADecoder(vocab=40, d_model=32, num_heads=4, num_kv_heads=2,
                         num_layers=2, seed=3)
        tm = GQADecoder(vocab=40, d_model=32, num_heads=4, num_kv_heads=2,
                        num_layers=2, seed=99, device="cpu")
    load_jax_params(tm, _flat(jm.params))
    return jm, tm


@pytest.mark.parametrize("kind", ["tiny", "gqa"])
def test_same_seed_same_weights(kind):
    jm, _ = _models(kind)
    tm = (TinyDecoder(vocab=40, d_model=32, num_heads=2, seed=3,
                      device="cpu") if kind == "tiny" else
          GQADecoder(vocab=40, d_model=32, num_heads=4, num_kv_heads=2,
                     num_layers=2, seed=3, device="cpu"))
    ref = _flat(jm.params)
    own = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    assert sorted(own) == sorted(ref)
    for n in ref:
        onp.testing.assert_array_equal(own[n], ref[n])


class _Case:
    """Inputs of the three entry points at S = 3 slots, page size 4,
    slot 1 inactive, slot 2 with a table of scattered pages."""

    def __init__(self, model_l, heads, hd, vocab, state_w, seed):
        rng = onp.random.RandomState(seed)
        self.S, self.ps, self.P, self.C = 3, 4, 12, 5
        shape = (model_l, self.P, self.ps, heads, hd)
        self.kp = rng.randn(*shape).astype("f4")
        self.vp = rng.randn(*shape).astype("f4")
        self.h = rng.randn(self.S, state_w).astype("f4")
        self.c = rng.randn(self.S, state_w).astype("f4")
        self.table = onp.array([[2, 5, 0], [0, 0, 0], [9, 3, 7]], onp.int32)
        self.tokens = rng.randint(0, vocab, self.S).astype(onp.int32)
        self.active = onp.array([True, False, True])
        self.lengths = onp.array([3, 1, 10], onp.int32)
        self.pidx = onp.array([2, 0, 7], onp.int32)
        self.poff = onp.array([2, 0, 1], onp.int32)
        self.chunk = rng.randint(0, vocab, (self.S, self.C)).astype(onp.int32)
        self.start = onp.array([0, 0, 6], onp.int32)
        self.n = onp.array([5, 0, 3], onp.int32)
        self.reset = onp.array([True, False, False])


def _run_both(jm, tm, case, entry):
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = lambda a: torch.from_numpy(onp.array(a))  # noqa: E731
    ti = lambda a: torch.from_numpy(onp.asarray(a, onp.int64))  # noqa: E731
    kp, vp = t(case.kp), t(case.vp)
    common_j = (j(case.h), j(case.c), j(case.kp), j(case.vp))
    common_t = (t(case.h), t(case.c), kp, vp)
    if entry == "decode":
        jo = jm.decode_step(jm.params, j(case.tokens), *common_j,
                            j(case.pidx), j(case.poff), j(case.table),
                            j(case.lengths), j(case.active))
        to = tm.decode_step(tm.params, ti(case.tokens), *common_t,
                            ti(case.pidx), ti(case.poff), ti(case.table),
                            ti(case.lengths), t(case.active))
    elif entry == "prefill":
        jo = jm.prefill_chunk(jm.params, j(case.chunk), *common_j,
                              j(case.start), j(case.n), j(case.reset),
                              j(case.active), j(case.table),
                              page_size=case.ps)
        to = tm.prefill_chunk(tm.params, ti(case.chunk), *common_t,
                              ti(case.start), ti(case.n), t(case.reset),
                              t(case.active), ti(case.table),
                              page_size=case.ps)
    else:
        jo = jm.verify_chunk(jm.params, j(case.chunk), *common_j,
                             j(case.start), j(case.n), j(case.active),
                             j(case.table), page_size=case.ps)
        to = tm.verify_chunk(tm.params, ti(case.chunk), *common_t,
                             ti(case.start), ti(case.n), t(case.active),
                             ti(case.table), page_size=case.ps)
    # the pages are written in place and returned
    assert to[-2] is kp and to[-1] is vp
    return jo, to


@pytest.mark.parametrize("entry", ["decode", "prefill", "verify"])
@pytest.mark.parametrize("kind", ["tiny", "gqa"])
def test_model_entry_points_vs_jax(kind, entry, monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "off")
    jm, tm = _models(kind)
    if kind == "tiny":
        case = _Case(1, 2, 16, 40, 32, seed=21)
    else:
        case = _Case(2, 2, 8, 40, 1, seed=22)
    K.reset_launch_counts()
    jo, to = _run_both(jm, tm, case, entry)
    tokens_j, tokens_t = onp.asarray(jo[0]), to[0].numpy()
    onp.testing.assert_array_equal(tokens_t, tokens_j)
    for a, r in zip(to[1:], jo[1:]):
        if r is None:
            assert a is None
            continue
        onp.testing.assert_allclose(a.numpy(), onp.asarray(r),
                                    atol=MODEL_TOL, rtol=MODEL_TOL)
    assert K.launch_counts()["rnn_decode"] == 0
