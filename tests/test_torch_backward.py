"""Backward of mxnet_tpu_torch's kernels against the JAX package.

The same numpy-seeded inputs go through the JAX package's Pallas
backward kernels (``_flash_bwd_pallas`` and the LayerNorm custom VJP, in
interpret mode) and through the port's plain backward versions, both
called directly and through the ``torch.autograd.Function`` that the
layers use (on a CPU tensor its backward runs the plain version; on the
card, the kernels of ``tests/test_torch_cuda.py``).

Tolerances: 1e-5 absolute and relative in float32 (sums over keys or
rows taken in another order), 2e-2 in bfloat16 (one or two bfloat16
ulps of an O(1) gradient: P and dS are rounded to bfloat16 on both
sides).
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention as JATT
from mxnet_tpu.ops.kernels import norm as JNORM

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import attention as ATT
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops.kernels import norm as KN

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (B, H, Sq, Sk, D, causal): one 512-block on the JAX side (its fused
# backward kernel)
FUSED_CASES = [
    (1, 2, 64, 64, 32, False),
    (2, 2, 50, 50, 16, True),
    (1, 2, 40, 72, 16, True),      # causal, Sq < Sk: diagonal at the end
    (1, 2, 72, 40, 16, True),      # rows 0..31 see no valid key
    (1, 2, 30, 30, 80, False),     # D = 80
]
# 16-blocks on the JAX side: its dq and dkv kernels over a grid of blocks
MULTIBLOCK_CASES = [
    (1, 2, 48, 48, 8, False),
    (1, 2, 48, 48, 8, True),
    (1, 2, 40, 64, 8, True),
    (1, 2, 64, 40, 16, True),
    (1, 1, 48, 48, 80, False),
    # the dq/dkv kernels' tile edges: one ragged tile, rows that see no
    # key, one query, D 1, D 7, D 80 causal, D 128 causal
    (1, 2, 33, 33, 8, False),
    (1, 2, 50, 34, 8, True),
    (1, 2, 1, 66, 8, True),
    (1, 2, 40, 40, 1, False),
    (1, 2, 40, 40, 7, False),
    (1, 1, 40, 56, 80, True),
    (1, 1, 64, 64, 128, True),
]


def _inputs(case, seed=0):
    b, h, sq, sk, d, _ = case
    r = onp.random.RandomState(seed)
    return (r.randn(b, h, sq, d).astype("f4"),
            r.randn(b, h, sk, d).astype("f4"),
            r.randn(b, h, sk, d).astype("f4"),
            r.randn(b, h, sq, d).astype("f4"))


def _jax_bwd(q, k, v, do, causal, dtype, block=512):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))
    scale = 1.0 / q.shape[-1] ** 0.5
    o, lse = JATT._flash_fwd_pallas(jq, jk, jv, causal, scale,
                                    block_q=block, block_k=block,
                                    interpret=True)
    grads = JATT._flash_bwd_pallas(jq, jk, jv, o, lse, jdo, causal, scale,
                                   block_q=block, block_k=block,
                                   interpret=True)
    return o, lse, [onp.asarray(g.astype(jnp.float32)) for g in grads]


def _close(got, ref, dtype):
    tol = TOL[dtype]
    for g, r in zip(got, ref):
        onp.testing.assert_allclose(g.float().numpy(), r, rtol=tol,
                                    atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_flash_bwd_plain_vs_pallas_fused(case, dtype):
    q, k, v, do = _inputs(case)
    causal = case[-1]
    o, lse, ref = _jax_bwd(q, k, v, do, causal, dtype)
    td = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(td) for a in (q, k, v, do)]
    tout = torch.from_numpy(onp.array(o.astype(jnp.float32))).to(td)
    tlse = torch.from_numpy(onp.array(lse))
    got = ATT.flash_attention_bwd_plain(t[0], t[1], t[2], tout, tlse, t[3],
                                        causal)
    assert all(g.dtype == td for g in got)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MULTIBLOCK_CASES)
def test_flash_bwd_plain_vs_pallas_multiblock(case, dtype):
    """The plain backward, the CPU side of the dq and dkv kernels, against
    the JAX package's dq and dkv kernels over 16-blocks."""
    q, k, v, do = _inputs(case)
    causal = case[-1]
    o, lse, ref = _jax_bwd(q, k, v, do, causal, dtype, block=16)
    td = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(td) for a in (q, k, v, do)]
    tout = torch.from_numpy(onp.array(o.astype(jnp.float32))).to(td)
    tlse = torch.from_numpy(onp.array(lse))
    got = ATT.flash_attention_bwd_plain(t[0], t[1], t[2], tout, tlse, t[3],
                                        causal)
    assert all(g.dtype == td for g in got)
    _close(got, ref, dtype)


@pytest.mark.parametrize("case", FUSED_CASES + MULTIBLOCK_CASES)
def test_flash_bwd_through_function_vs_pallas(case):
    """The autograd Function (forward and backward) against the JAX
    backward kernels: fused at one block, dq + dkv at 16-blocks."""
    q, k, v, do = _inputs(case, seed=1)
    causal = case[-1]
    block = 512 if case in FUSED_CASES else 16
    _, _, ref = _jax_bwd(q, k, v, do, causal, "float32", block=block)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ATT.flash_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    _close((tq.grad, tk.grad, tv.grad), ref, "float32")


def test_flash_bwd_strided_gradient_and_lse():
    """dO arrives strided (the head merge's permute); lse is an output
    without a gradient."""
    q, k, v, do = _inputs((1, 2, 20, 20, 8, True), seed=2)
    tq = torch.from_numpy(q).requires_grad_()
    out, lse = ATT.flash_attention_fwd(tq, torch.from_numpy(k),
                                       torch.from_numpy(v), True)
    assert not lse.requires_grad
    merged = out.permute(0, 2, 1, 3).reshape(1, 20, 16)
    (merged * torch.from_numpy(do.transpose(0, 2, 1, 3).reshape(1, 20, 16))
     ).sum().backward()
    ref = ATT.flash_attention_bwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        out.detach(), lse, torch.from_numpy(do), True)
    torch.testing.assert_close(tq.grad, ref[0], atol=1e-6, rtol=1e-6)


def test_flash_bwd_dead_rows_get_zero_gradient():
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs((1, 2, 72, 40, 16, True), seed=3))
    out, lse = ATT.flash_attention_fwd_plain(q, k, v, True)
    dq, dk, dv = ATT.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert (dq[:, :, :32] == 0).all()


def test_fused_bwd_rule_is_the_jax_packages():
    assert ATT.uses_fused_bwd(512, 512) and ATT.uses_fused_bwd(1, 512)
    assert not ATT.uses_fused_bwd(513, 512)
    assert not ATT.uses_fused_bwd(100, 1024)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [768, 100])
def test_layer_norm_bwd_vs_jax_grad(c, dtype):
    r = onp.random.RandomState(c)
    x = r.randn(6, 7, c).astype("f4")
    g = (1.0 + 0.1 * r.randn(c)).astype("f4")
    b = r.randn(c).astype("f4")
    dy = r.randn(6, 7, c).astype("f4")
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jx, jdy = jnp.asarray(x).astype(jd), jnp.asarray(dy).astype(jd)

    def f(x_, g_, b_):
        return JNORM.layer_norm(x_, g_, b_, interpret=True)

    _, vjp = jax.vjp(f, jx, jnp.asarray(g), jnp.asarray(b))
    ref = [onp.asarray(a.astype(jnp.float32)) for a in vjp(jdy)]
    td = getattr(torch, dtype)
    tx, tdy = torch.from_numpy(x).to(td), torch.from_numpy(dy).to(td)
    tg, tb = torch.from_numpy(g), torch.from_numpy(b)
    got = KN.layer_norm_bwd_plain(tx, tg, tdy)
    assert got[0].dtype == td and got[1].dtype == torch.float32
    # sums over 42 rows of O(1) terms: the relative tolerance carries it
    _close(got, ref, dtype)
    # the same through the autograd Function of the layers
    tx.requires_grad_()
    tg.requires_grad_()
    tb.requires_grad_()
    KN.layer_norm(tx, tg, tb).backward(tdy)
    _close((tx.grad, tg.grad, tb.grad), ref, dtype)


def _bias_gelu_bwd_vs_jax(dtype):
    r = onp.random.RandomState(5)
    x = r.randn(4, 9, 50).astype("f4")
    b = r.randn(50).astype("f4")
    dy = r.randn(4, 9, 50).astype("f4")
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda x_, b_: JNORM.bias_gelu(x_, b_, interpret=True),
                     jnp.asarray(x).astype(jd), jnp.asarray(b).astype(jd))
    ref = [onp.asarray(a.astype(jnp.float32))
           for a in vjp(jnp.asarray(dy).astype(jd))]
    td = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tb = torch.from_numpy(b).to(td).requires_grad_()
    KN.bias_gelu(tx, tb).backward(torch.from_numpy(dy).to(td))
    assert tx.grad.dtype == td and tb.grad.dtype == td
    _close((tx.grad, tb.grad), ref, dtype)


def test_bias_gelu_bwd_plain_vs_jax():
    _bias_gelu_bwd_vs_jax("float32")


def test_bias_gelu_bwd_plain_vs_jax_bf16():
    """bfloat16 x, b and dy: z = x + b rounded to bfloat16 on both sides,
    dx from float32 and rounded once, db the float32 sums of the
    unrounded dx over 36 rows rounded once: within 2e-2 (one or two
    bfloat16 ulps of an O(1) gradient, relative for db)."""
    _bias_gelu_bwd_vs_jax("bfloat16")


def test_backward_on_the_cpu_launches_nothing():
    K.reset_launch_counts()
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs((1, 1, 600, 600, 8, False), seed=4))
    ATT.flash_attention_bwd(q, k, v, *ATT.flash_attention_fwd_plain(q, k, v),
                            do)
    KN.layer_norm_bwd(torch.ones(3, 8), torch.ones(8), torch.ones(3, 8))
    assert all(n == 0 for n in K.launch_counts().values())


def test_flash_bwd_plan_refuses_unknown_kernels():
    with pytest.raises(mxt.MXNetError, match="no kernel"):
        ATT.flash_bwd_plan("flash_bwd_fused", 24, 1024, 1024, 64)
    with pytest.raises(mxt.MXNetError, match="no kernel"):
        ATT.flash_bwd_plan("flash_bwd_dq", 24, 1024, 1024, 64,
                           torch.float16)


def test_backward_wrappers_refuse_other_devices():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(mxt.MXNetError, match="not supported"):
        KN.layer_norm_bwd(x, torch.empty(8, device="meta"), x)
    q = torch.empty(1, 1, 4, 4, device="meta")
    lse = torch.empty(1, 1, 4, device="meta")
    with pytest.raises(mxt.MXNetError, match="not supported"):
        ATT.flash_attention_bwd(q, q, q, q, lse, q)
