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


@pytest.mark.parametrize("c", [32, 50, 768])
def test_layer_norm_plain_vs_jax(c):
    r = onp.random.RandomState(c)
    x = r.randn(3, 5, c).astype("f4")
    g = r.randn(c).astype("f4")
    b = r.randn(c).astype("f4")
    got = KN.layer_norm(*_t(x, g, b)).numpy()
    ker = JNORM.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                           interpret=True)
    ref = JFNN.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    onp.testing.assert_allclose(got, onp.asarray(ker), rtol=NORM_TOL,
                                atol=NORM_TOL)
    onp.testing.assert_allclose(got, onp.asarray(ref), rtol=NORM_TOL,
                                atol=NORM_TOL)
    # ops.nn.layer_norm routes the trailing axis through the wrapper
    onp.testing.assert_array_equal(FNN.layer_norm(*_t(x, g, b)).numpy(),
                                   got)


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
