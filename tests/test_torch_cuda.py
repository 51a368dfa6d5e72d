"""mxnet_tpu_torch's CUDA kernels against their plain versions, on the
card, forward and backward; that kernel outputs carry gradients and
parameters train there; and a 2-layer encoder's gradients on the card
against a CPU copy. Every test here needs a CUDA device and skips
without one; the file imports nothing of JAX, so it runs on the machine
with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 in float32 (sums in another order, expf/erfcf of the
CUDA math library), 2e-2 in bfloat16 (one or two bfloat16 ulps of an O(1)
output); 2e-4 for the encoder's gradients (two layers of float32 sums in
another order, cuBLAS against a float64-accumulated CPU product).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import attention as ATT
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops.kernels import norm as KN

# (B, H, Sq, Sk, D, causal)
FLASH_CASES = [
    (1, 2, 64, 64, 32, False),
    (2, 2, 50, 50, 16, True),
    (1, 2, 40, 72, 16, True),
    (1, 2, 72, 40, 16, True),
    (1, 3, 100, 100, 8, False),
    (2, 12, 128, 128, 64, False),
    (1, 2, 70, 70, 128, True),
]


def _qkv(b, h, sq, sk, d, seed=0):
    r = onp.random.RandomState(seed)
    return tuple(torch.from_numpy(a) for a in (
        r.randn(b, h, sq, d).astype("f4"), r.randn(b, h, sk, d).astype("f4"),
        r.randn(b, h, sk, d).astype("f4")))


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run this file on the card)")
    return torch.device("cuda", 0)


CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_on_card(cuda_dev, dtype, case):
    b, h, sq, sk, d, causal = case
    q, k, v = (t.to(cuda_dev, dtype) for t in _qkv(b, h, sq, sk, d))
    K.reset_launch_counts()
    out, lse = ATT.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_fwd"] == 1
    rout, rlse = ATT.flash_attention_fwd_plain(q, k, v, causal)
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(out.float(), rout.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 768), (37, 50), (3, 5, 33)])
def test_norm_kernels_on_card(cuda_dev, dtype, shape):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(*shape, generator=g).to(cuda_dev, dtype)
    c = shape[-1]
    gam = torch.randn(c, generator=g).to(cuda_dev)
    bet = torch.randn(c, generator=g).to(cuda_dev)
    tol = CARD_TOL[dtype]
    K.reset_launch_counts()
    y = KN.layer_norm(x, gam, bet)
    z = KN.bias_gelu(x, bet.to(dtype))
    torch.cuda.synchronize()
    assert K.launch_counts()["layernorm_fwd"] == 1
    assert K.launch_counts()["bias_gelu_fwd"] == 1
    torch.testing.assert_close(y.float(), KN.layer_norm_plain(
        x, gam, bet).float(), atol=tol, rtol=tol)
    torch.testing.assert_close(z.float(), KN.bias_gelu_plain(
        x, bet.to(dtype)).float(), atol=tol, rtol=tol)


#: (B, H, Sq, Sk, D, causal) of the backward kernels: the fused kernel
#: up to 512, the dq/dkv kernels past it
FLASH_BWD_CASES = [
    (2, 3, 512, 512, 64, False),     # the training shape, fewer heads
    (2, 3, 512, 512, 64, True),
    (1, 2, 100, 164, 64, True),      # causal Sq < Sk
    (1, 2, 100, 40, 32, True),       # rows 0..59 see no valid key
    (1, 3, 70, 70, 80, False),       # D not a power of two
    (1, 2, 1024, 1024, 64, False),   # dq + dkv kernels
    (1, 2, 600, 1030, 64, True),
    (1, 2, 33, 700, 128, True),
]


def _bwd_inputs(case, dtype, dev, seed=1):
    b, h, sq, sk, d, causal = case
    q, k, v = (t.to(dev, dtype) for t in _qkv(b, h, sq, sk, d, seed))
    do = torch.from_numpy(onp.random.RandomState(seed + 1).randn(
        b, h, sq, d).astype("f4")).to(dev, dtype)
    out, lse = ATT.flash_attention_fwd_plain(q, k, v, causal)
    return q, k, v, out, lse, do, causal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_bwd_kernels_on_card(cuda_dev, dtype, case):
    q, k, v, out, lse, do, causal = _bwd_inputs(case, dtype, cuda_dev)
    K.reset_launch_counts()
    got = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    fused = ATT.uses_fused_bwd(q.shape[2], k.shape[2])
    assert K.launch_counts()["flash_bwd_fused"] == int(fused)
    assert K.launch_counts()["flash_bwd_dq"] == int(not fused)
    assert K.launch_counts()["flash_bwd_dkv"] == int(not fused)
    ref = ATT.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    tol = CARD_TOL[dtype]
    for g, r in zip(got, ref):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 768), (37, 50), (3, 5, 33)])
def test_layernorm_bwd_kernel_on_card(cuda_dev, dtype, shape):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(*shape, generator=g).to(cuda_dev, dtype)
    dy = torch.randn(*shape, generator=g).to(cuda_dev, dtype)
    gam = torch.randn(shape[-1], generator=g).to(cuda_dev)
    K.reset_launch_counts()
    got = KN.layer_norm_bwd(x, gam, dy)
    torch.cuda.synchronize()
    assert K.launch_counts()["layernorm_bwd"] == 1
    ref = KN.layer_norm_bwd_plain(x, gam, dy)
    tol = CARD_TOL[dtype]
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=tol)
    # the column sums take no atomics: a second run repeats bit for bit
    again = KN.layer_norm_bwd(x, gam, dy)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_outputs_carry_gradients_on_card(cuda_dev):
    q, k, v = (t.to(cuda_dev).requires_grad_() for t in
               _qkv(1, 2, 40, 40, 16))
    out = ATT.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (q, k, v))
    x = torch.randn(6, 32, device=cuda_dev, requires_grad=True)
    gam = torch.ones(32, device=cuda_dev, requires_grad=True)
    bet = torch.zeros(32, device=cuda_dev, requires_grad=True)
    y = KN.layer_norm(x, gam, bet)
    assert y.grad_fn is not None
    (y * torch.arange(32, device=cuda_dev)).sum().backward()
    assert x.grad.abs().sum() > 0 and gam.grad.abs().sum() > 0
    z = KN.bias_gelu(x, bet)
    assert z.grad_fn is not None
    with pytest.raises(mxt.MXNetError, match="_bg_bwd_kernel"):
        z.sum().backward()


@pytest.mark.cuda
def test_parameters_trainable_on_card(cuda_dev):
    from mxnet_tpu_torch.gluon.nn import Dense, LayerNorm
    dense = Dense(8, in_units=4, device=cuda_dev)
    ln = LayerNorm(in_channels=8, device=cuda_dev)
    assert all(p.requires_grad and p.grad_req == "write"
               for p in list(dense.parameters()) + list(ln.parameters()))
    ln(dense(torch.ones(3, 4, device=cuda_dev))).pow(2).sum().backward()
    assert dense.weight.grad is not None and dense.weight.fresh_grad


@pytest.mark.cuda
def test_encoder_gradients_on_card_vs_cpu(cuda_dev):
    from mxnet_tpu_torch.gluon.nn import TransformerEncoder
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    # gelu_tanh: the bias-GELU backward is not ported yet
    shape = (2, 64, 128, 4)
    nets = [TransformerEncoder(*shape, activation="gelu_tanh", device=d)
            for d in (cuda_dev, "cpu")]
    params = init_params_numpy(nets[0], 3)
    rs = onp.random.RandomState(4)
    x = rs.randn(2, 70, 64).astype("f4")
    w = rs.randn(2, 70, 64).astype("f4")
    grads = []
    for net in nets:
        load_jax_params(net, params)
        dev = net.layer0.ln_1.gamma.device
        K.reset_launch_counts()
        (net(torch.from_numpy(x).to(dev))
         * torch.from_numpy(w).to(dev)).sum().backward()
        grads.append({n: p.grad.cpu() for n, p in net.named_parameters()})
        if dev.type == "cuda":
            counts = K.launch_counts()
            assert counts["flash_bwd_fused"] == 2
            assert counts["layernorm_bwd"] == 4
    assert grads[0].keys() == grads[1].keys()
    for n in grads[1]:
        torch.testing.assert_close(grads[0][n], grads[1][n], atol=2e-4,
                                   rtol=2e-4, msg=n)


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_card(cuda_dev):
    q = torch.zeros(1, 1, 8, 160, device=cuda_dev)
    with pytest.raises(mxt.MXNetError, match="head_dim"):
        ATT.flash_attention(q, q, q)
    x = torch.zeros(4, 8, device=cuda_dev, dtype=torch.float16)
    with pytest.raises(mxt.MXNetError, match="no kernel"):
        KN.layer_norm(x, torch.ones(8, device=cuda_dev),
                      torch.zeros(8, device=cuda_dev))
    y = torch.zeros(8, 4, device=cuda_dev).t()
    with pytest.raises(mxt.MXNetError, match="contiguous"):
        KN.bias_gelu(y, torch.zeros(8, device=cuda_dev))
