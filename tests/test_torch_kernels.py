"""mxnet_tpu_torch kernel layer: the plain versions against the JAX
package's Pallas kernels (interpret mode) and references, the dispatch
rules of the wrappers, and (on a card only) each CUDA kernel against
its plain version (tests/test_torch_cuda.py).

Tolerances (float32 against float32): 2e-5 absolute and relative for
attention (sums over keys taken in another order, exp of another
implementation), 1e-5 for LayerNorm and bias-GELU (one reduction over C,
or elementwise erfc). On the card: 1e-4 in float32, 2e-2 in bfloat16 (one
or two bfloat16 ulps of an O(1) output).
"""
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as JATT
from mxnet_tpu.ops import nn as JFNN
from mxnet_tpu.ops.kernels import norm as JNORM

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import attention as ATT
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops import nn as FNN
from mxnet_tpu_torch.ops.kernels import norm as KN

ATOL = RTOL = 2e-5
NORM_TOL = 1e-5
BF16_TOL = 2e-2

# (B, H, Sq, Sk, D, causal)
FLASH_CASES = [
    (1, 2, 64, 64, 32, False),
    (2, 2, 50, 50, 16, True),     # S not a multiple of 64
    (1, 2, 40, 72, 16, True),     # Sq != Sk, causal diagonal at the end
    (1, 2, 72, 40, 16, True),     # rows 0..31 see no valid key
    (1, 3, 100, 100, 8, False),
]


def _qkv(b, h, sq, sk, d, seed=0):
    r = onp.random.RandomState(seed)
    return (r.randn(b, h, sq, d).astype("f4"),
            r.randn(b, h, sk, d).astype("f4"),
            r.randn(b, h, sk, d).astype("f4"))


def _t(*arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


#: BERT training's sequence length, causal with Sq != Sk both ways: the
#: card kernel's tiles walk 8-10 key tiles here, its plain version the
#: whole row at once
FLASH_LONG_CASES = [
    (1, 2, 512, 640, 64, True),
    (1, 2, 640, 512, 64, True),   # rows 0..127 see no valid key
]


@pytest.mark.parametrize("case", FLASH_CASES + FLASH_LONG_CASES)
def test_flash_plain_vs_pallas_interpret(case):
    b, h, sq, sk, d, causal = case
    q, k, v = _qkv(b, h, sq, sk, d)
    scale = 1.0 / d ** 0.5
    jo, jl = JATT._flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, scale,
                                    interpret=True)
    to, tl = ATT.flash_attention_fwd_plain(*_t(q, k, v), causal, scale)
    onp.testing.assert_allclose(to.numpy(), onp.asarray(jo),
                                rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl),
                                rtol=RTOL, atol=ATOL)
    if sq > sk and causal:
        # no valid key: output exactly 0 and lse -1e30, on both sides
        dead = sq - sk
        assert (to[:, :, :dead] == 0).all()
        assert (tl[:, :, :dead] == ATT.NEG_INF).all()


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("case", FLASH_CASES[1:4])
def test_flash_attention_vs_jax_gate(monkeypatch, mode, case):
    b, h, sq, sk, d, causal = case
    q, k, v = _qkv(b, h, sq, sk, d, seed=1)
    monkeypatch.setenv("MXNET_PALLAS", mode)
    ref = JATT.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal)
    got = ATT.flash_attention(*_t(q, k, v), causal=causal)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref),
                                rtol=RTOL, atol=ATOL)


def test_flash_valid_length_vs_jax():
    q, k, v = _qkv(3, 2, 20, 20, 8, seed=2)
    vl = onp.array([20, 7, 1], "int32")
    ref = JATT.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), valid_length=jnp.asarray(vl))
    got = ATT.flash_attention(*_t(q, k, v), valid_length=torch.tensor(vl))
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref),
                                rtol=RTOL, atol=ATOL)


def test_attention_reference_vs_jax():
    q, k, v = _qkv(2, 2, 12, 12, 8, seed=3)
    mask = onp.random.RandomState(4).randn(2, 1, 12, 12).astype("f4")
    ref = JATT.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   mask=jnp.asarray(mask))
    got = ATT.attention_reference(*_t(q, k, v), causal=True,
                                  mask=torch.from_numpy(mask))
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref),
                                rtol=RTOL, atol=ATOL)


def test_flash_plain_matches_reference_bf16_rounding():
    # bfloat16: P is rounded to V's dtype before the PV product, so the
    # plain version stays within bfloat16 resolution of the oracle
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 2, 30, 30, 16, seed=5))
    out, lse = ATT.flash_attention_fwd_plain(q, k, v, True)
    ref = ATT.attention_reference(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert (out.float() - ref.float()).abs().max() < 2e-2


@pytest.mark.parametrize("c,dtype", [
    pytest.param(c, dt, id=str(c) if dt == "float32" else f"{c}-{dt}")
    for dt in ("float32", "bfloat16") for c in (32, 50, 768)])
def test_layer_norm_plain_vs_jax(c, dtype):
    """float32 within 1e-5; bfloat16 x (float32 gamma, beta and
    statistics on both sides, the output rounded to bfloat16 once) within
    2e-2: one or two bfloat16 ulps of an O(1) output."""
    r = onp.random.RandomState(c)
    x = r.randn(3, 5, c).astype("f4")
    g = r.randn(c).astype("f4")
    b = r.randn(c).astype("f4")
    tol = NORM_TOL if dtype == "float32" else BF16_TOL
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx, tg, tb = _t(x, g, b)
    tx = tx.to(getattr(torch, dtype))
    got = KN.layer_norm(tx, tg, tb)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    ker = JNORM.layer_norm(jx, jnp.asarray(g), jnp.asarray(b),
                           interpret=True)
    ref = JFNN.layer_norm(jx, jnp.asarray(g), jnp.asarray(b))
    for want in (ker, ref):
        onp.testing.assert_allclose(
            got, onp.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)
    # ops.nn.layer_norm routes the trailing axis through the wrapper
    onp.testing.assert_array_equal(
        FNN.layer_norm(tx, tg, tb).float().numpy(), got)


def test_layer_norm_other_axis_vs_jax():
    r = onp.random.RandomState(6)
    x = r.randn(6, 4).astype("f4")
    g = r.randn(6).astype("f4")
    b = r.randn(6).astype("f4")
    got = FNN.layer_norm(*_t(x, g, b), axis=0).numpy()
    ref = JFNN.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          axis=0)
    onp.testing.assert_allclose(got, onp.asarray(ref), rtol=NORM_TOL,
                                atol=NORM_TOL)


@pytest.mark.parametrize("c", [32, 50, 256])
def test_bias_gelu_plain_vs_jax(c):
    r = onp.random.RandomState(c + 1)
    x = r.randn(4, 7, c).astype("f4")
    b = r.randn(c).astype("f4")
    got = KN.bias_gelu(*_t(x, b)).numpy()
    ker = JNORM.bias_gelu(jnp.asarray(x), jnp.asarray(b), interpret=True)
    onp.testing.assert_allclose(got, onp.asarray(ker), rtol=NORM_TOL,
                                atol=NORM_TOL)
    onp.testing.assert_allclose(KN.bias_gelu_plain(*_t(x, b)).numpy(), got)


# ---------------------------------------------------------------------------
# device and dispatch rules
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_plain_versions_and_count_nothing():
    from mxnet_tpu_torch.ops.kernels import rnn_scan as KR
    K.reset_launch_counts()
    hd = KR.rnn_decode_step(torch.ones(2, 16), torch.zeros(2, 4),
                            torch.zeros(2, 4), torch.ones(16, 4),
                            torch.zeros(16), "lstm")
    assert torch.equal(hd[0], KR.rnn_decode_step_plain(
        torch.ones(2, 16), torch.zeros(2, 4), torch.zeros(2, 4),
        torch.ones(16, 4), torch.zeros(16), "lstm")[0])
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(1, 1, 8, 8, 4)))
    x = torch.ones(2, 8, requires_grad=True)
    loss = ATT.flash_attention(q, k, v).sum() \
        + KN.layer_norm(x, torch.ones(8), torch.zeros(8)).sum() \
        + KN.bias_gelu(x, torch.zeros(8)).sum()
    loss.backward()
    assert q.grad is not None and x.grad is not None
    from mxnet_tpu_torch.ops.kernels import opt_update as KO
    w, m = torch.ones(8), torch.zeros(8)
    KO.unit_update("sgd", {"momentum": 0.9, "has_clip": False}, w,
                   torch.ones(8), 0.5, 0.0, 1, 1.0, 0.0, (m,))
    assert torch.equal(m, torch.full((8,), -0.5))
    assert torch.equal(w, torch.full((8,), 0.5))
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}
    assert set(K.KERNELS) == {
        "flash_fwd", "layernorm_fwd", "bias_gelu_fwd", "flash_bwd_fused",
        "flash_bwd_dq", "flash_bwd_dkv", "layernorm_bwd", "bias_gelu_bwd",
        "rnn_scan_fwd", "rnn_scan_bwd", "rnn_decode", "opt_update"}


def test_wrappers_refuse_other_devices():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(mxt.MXNetError, match="not supported"):
        KN.layer_norm(x, torch.empty(8, device="meta"),
                      torch.empty(8, device="meta"))
    with pytest.raises(mxt.MXNetError, match="not supported"):
        KN.bias_gelu(x, torch.empty(8, device="meta"))
    q = torch.empty(1, 1, 4, 4, device="meta")
    with pytest.raises(mxt.MXNetError, match="not supported"):
        ATT.flash_attention(q, q, q)
    from mxnet_tpu_torch.ops.kernels import opt_update as KO
    w = torch.empty(8, device="meta")
    with pytest.raises(mxt.MXNetError, match="not supported"):
        KO.unit_update("sgd", {"momentum": 0.0, "has_clip": False}, w, w,
                       0.1, 0.0, 1, 1.0, 0.0, ())
    with pytest.raises(mxt.MXNetError, match="batch, heads, seq, dim"):
        ATT.flash_attention(torch.ones(4, 4), torch.ones(4, 4),
                            torch.ones(4, 4))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="no CUDA device"):
        mxt.default_device()
    with pytest.raises(mxt.MXNetError, match="no CUDA device"):
        mxt.resolve_device("cuda:0")
    assert mxt.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(mxt.MXNetError, match="unsupported device"):
        mxt.resolve_device("meta")


def test_import_needs_no_nvcc_and_builds_nothing(tmp_path):
    code = (
        "import mxnet_tpu_torch, mxnet_tpu_torch.serving, "
        "mxnet_tpu_torch.gluon.model_zoo.bert, chip_smoke\n"
        "from mxnet_tpu_torch.ops import kernels as K\n"
        "assert K._LIB is None\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               CUDA_HOME=str(tmp_path), PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(K, "BUILD_DIR", str(tmp_path / "torch_kernels"))
    with pytest.raises(mxt.MXNetError, match="nvcc not found"):
        K.build_library()


# ---------------------------------------------------------------------------
# the LayerNorm backward's launch plan (plain Python: no card needed)
# ---------------------------------------------------------------------------

#: (rows, C, dtype, aligned) -> (branch, vec, packs): BERT training's
#: 16384 x 768 in both dtypes (a warp a row, 16-byte loads), the caps
#: (1,024 float32 and 2,048 bfloat16 with 16-byte loads, 1,024 with one
#: element a load) and one past them, C 16,384, an unaligned C (771) and
#: unaligned pointers, one row
LN_PLANS = [
    ((16384, 768, torch.float32, True), ("warp", 4, 6)),
    ((16384, 768, torch.bfloat16, True), ("warp", 8, 3)),
    ((16384, 1024, torch.float32, True), ("warp", 4, 8)),
    ((16384, 1028, torch.float32, True), ("block", 4, 0)),
    ((4096, 1025, torch.float32, True), ("block", 1, 0)),
    ((4096, 2048, torch.bfloat16, True), ("warp", 8, 8)),
    ((4096, 2056, torch.bfloat16, True), ("block", 8, 0)),
    ((4096, 2049, torch.bfloat16, True), ("block", 1, 0)),
    ((64, 16384, torch.float32, True), ("block", 4, 0)),
    ((64, 16384, torch.bfloat16, True), ("block", 8, 0)),
    ((4099, 771, torch.float32, True), ("warp", 1, 32)),
    ((4099, 1024, torch.bfloat16, True), ("warp", 8, 4)),
    ((100, 768, torch.float32, False), ("warp", 1, 24)),
    ((1, 768, torch.float32, True), ("warp", 4, 6)),
]


@pytest.mark.parametrize("case,want", LN_PLANS)
def test_ln_bwd_plan_branches(case, want):
    rows, c, dtype, aligned = case
    plan = KN.ln_bwd_plan(rows, c, dtype, aligned=aligned)
    assert (plan["branch"], plan["vec"], plan["packs"]) == want
    assert plan["sms"] == 132                 # an H100's, without a card
    assert 1 <= plan["blocks"] <= rows
    assert plan["smem_bytes"] == 8 * c <= 232448
    assert plan["threads"] == 32 * plan["warps"] <= 1024
    if plan["branch"] == "warp":
        # every row has a warp, no warp more than its share, and the grid
        # stays within the blocks an SM the register estimate allows
        assert plan["packs"] * 32 * plan["vec"] >= c
        nw = plan["blocks"] * plan["warps"]
        assert nw * plan["rows_per_warp"] >= rows
        assert plan["rows_per_warp"] == -(-rows // nw)
        assert plan["blocks"] <= plan["sms"] * plan["blocks_per_sm"]
    else:
        assert plan["blocks"] * plan["rows_per_block"] >= rows


PLAN_CS = (1, 50, 768, 1023, 1024, 2048, 4096, 16384)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", PLAN_CS)
@pytest.mark.parametrize("rows", [1, 7, 16384])
def test_ln_fwd_plan_branches(rows, c, dtype, aligned):
    """Every row has a warp (warp branch) or a block (block branch), the
    grid fits the card, and no C is refused: past the warp branch's cap a
    block takes the row, kept in shared memory up to its cap."""
    plan = KN.ln_fwd_plan(rows, c, dtype, aligned=aligned)
    wide = 16 // dtype.itemsize
    assert plan["vec"] == (wide if aligned and c % wide == 0 else 1)
    assert plan["sms"] == 132                 # an H100's, without a card
    assert 1 <= plan["blocks"] <= rows
    assert plan["blocks"] <= plan["sms"] * plan["blocks_per_sm"]
    assert plan["threads"] == 32 * plan["warps"] <= 1024
    cap = KN.LN_WARP_CAP[dtype] if plan["vec"] > 1 else KN.LN_SCALAR_CAP
    assert plan["branch"] == ("warp" if c <= cap else "block")
    if plan["branch"] == "warp":
        assert plan["packs"] * 32 * plan["vec"] >= c
        assert plan["packs"] <= (8 if plan["vec"] > 1 else 32)
        nw = plan["blocks"] * plan["warps"]
        assert plan["rows_per_warp"] == -(-rows // nw)
        assert plan["blocks_per_sm"] == KN._ln_fwd_blocks_per_sm(
            dtype, plan["vec"], plan["packs"])
        assert plan["smem_bytes"] == 0
    else:
        assert plan["packs"] == 0
        assert plan["blocks"] * plan["rows_per_block"] >= rows
        assert plan["cached"] == (c * dtype.itemsize
                                  <= KN.LN_FWD_SMEM_CAP)
        assert plan["smem_bytes"] == (
            -(-c * dtype.itemsize // 16) * 16 if plan["cached"] else 0)
        assert plan["smem_bytes"] <= 232448
        assert 32 <= plan["threads"] <= KN.LN_BLOCK_THREADS


def test_ln_fwd_plan_at_served_and_training_shapes():
    """4096 x 768 (a served bucket-32 micro-batch): every row its own warp
    at once, 9 blocks of 4 warps an SM in bf16 (3 packs a lane), 8 in
    float32 (6 packs); BERT training's 16384 x 768 in float32: one wave
    of 1,056 blocks, 4 rows a warp."""
    bf = KN.ln_fwd_plan(4096, 768, torch.bfloat16)
    assert (bf["packs"], bf["blocks_per_sm"], bf["blocks"],
            bf["rows_per_warp"]) == (3, 9, 1024, 1)
    f32 = KN.ln_fwd_plan(4096, 768, torch.float32)
    assert (f32["packs"], f32["blocks_per_sm"], f32["blocks"],
            f32["rows_per_warp"]) == (6, 8, 1024, 1)
    train = KN.ln_fwd_plan(16384, 768, torch.float32)
    assert (train["blocks"], train["rows_per_warp"]) == (1056, 4)


def test_ln_fwd_plan_takes_any_c_and_refuses_other_dtypes():
    wide = KN.ln_fwd_plan(3, 120000, torch.bfloat16)
    assert wide["branch"] == "block" and not wide["cached"]
    assert wide["smem_bytes"] == 0 and wide["blocks"] == 3
    with pytest.raises(mxt.MXNetError, match="C 0"):
        KN.ln_fwd_plan(4, 0)
    with pytest.raises(mxt.MXNetError, match="no kernel"):
        KN.ln_fwd_plan(4, 64, torch.float16)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", PLAN_CS)
@pytest.mark.parametrize("rows", [1, 7, 4096])
def test_bg_bwd_plan_branches(rows, c, dtype, aligned):
    """Column tiles cover C, the row chunks cover every row with none
    empty and each warp given a row, the grid is one wave of the blocks
    an SM the launch bounds ask for (or one chunk), and no C is
    refused."""
    plan = KN.bg_bwd_plan(rows, c, dtype, aligned=aligned)
    wide = 16 // dtype.itemsize
    vec = wide if aligned and c % wide == 0 else 1
    assert plan["vec"] == vec and plan["sms"] == 132
    assert plan["tiles"] == -(-c // (32 * vec))
    assert plan["blocks"] == plan["tiles"] * plan["chunks"]
    per = plan["rows_per_chunk"]
    assert plan["chunks"] * per >= rows > (plan["chunks"] - 1) * per
    assert 1 <= plan["chunks"] <= min(65535, -(-rows // plan["warps"]))
    assert plan["rows_per_warp"] == -(-per // plan["warps"])
    assert plan["threads"] == 32 * plan["warps"] == KN.BG_BWD_THREADS
    assert plan["blocks"] <= plan["sms"] * plan["blocks_per_sm"] \
        or plan["chunks"] == 1
    assert plan["partial_bytes"] == 4 * plan["chunks"] * c


def test_bg_bwd_plan_at_the_encoder_fills_one_wave():
    """4096 x 3072 (the gelu encoder's FFN): 3 blocks of 8 warps an SM,
    one wave of 396 blocks of 12 column tiles of 256 bf16 columns (384 of
    24 tiles of 128 float32 columns)."""
    bf = KN.bg_bwd_plan(4096, 3072, torch.bfloat16)
    assert (bf["tiles"], bf["chunks"], bf["blocks"]) == (12, 33, 396)
    f32 = KN.bg_bwd_plan(4096, 3072, torch.float32)
    assert (f32["tiles"], f32["chunks"], f32["blocks"]) == (24, 16, 384)
    with pytest.raises(mxt.MXNetError, match="no kernel"):
        KN.bg_bwd_plan(4, 64, torch.float16)


def test_ln_bwd_plan_at_bert_training_fills_the_card():
    """16384 x 768: 4 blocks of 4 warps an SM (16 warps), 512 blocks, 8
    rows a warp, in both dtypes; rows below the block count take one warp
    each; C past 16,384 is refused."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = KN.ln_bwd_plan(16384, 768, dtype)
        assert (plan["blocks_per_sm"], plan["blocks"],
                plan["rows_per_warp"]) == (4, 512, 8)
    few = KN.ln_bwd_plan(5, 768, torch.float32)
    assert few["blocks"] == 2 and few["rows_per_warp"] == 1
    with pytest.raises(mxt.MXNetError, match="C 16385"):
        KN.ln_bwd_plan(4, 16385)
    with pytest.raises(mxt.MXNetError, match="no kernel"):
        KN.ln_bwd_plan(4, 64, torch.float16)
