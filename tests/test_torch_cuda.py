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
another order, cuBLAS against a float64-accumulated CPU product). The
recurrence's backward is held against the plain backward given the
kernel's own forward residuals, so that a state rounded the other way
in the forward does not count against it.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import attention as ATT
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops.kernels import norm as KN
from mxnet_tpu_torch.ops.kernels import rnn_scan as KR

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
    x.grad = None
    bet.grad = None
    K.reset_launch_counts()
    z = KN.bias_gelu(x, bet)
    assert z.grad_fn is not None
    (z * torch.arange(32, device=cuda_dev)).sum().backward()
    assert K.launch_counts()["bias_gelu_bwd"] == 1
    assert x.grad.abs().sum() > 0 and bet.grad.abs().sum() > 0


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
    # the default gelu FFN: the bias-GELU forward and backward kernels
    shape = (2, 64, 128, 4)
    nets = [TransformerEncoder(*shape, device=d) for d in (cuda_dev, "cpu")]
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
            assert counts["bias_gelu_bwd"] == 2
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 3072), (37, 50), (3, 5, 33)])
def test_bias_gelu_bwd_kernel_on_card(cuda_dev, dtype, shape):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(*shape, generator=g).to(cuda_dev, dtype)
    dy = torch.randn(*shape, generator=g).to(cuda_dev, dtype)
    b = torch.randn(shape[-1], generator=g).to(cuda_dev, dtype)
    K.reset_launch_counts()
    got = KN.bias_gelu_bwd(x, b, dy)
    torch.cuda.synchronize()
    assert K.launch_counts()["bias_gelu_bwd"] == 1
    tol = CARD_TOL[dtype]
    for a, r in zip(got, KN.bias_gelu_bwd_plain(x, b, dy)):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=tol)
    again = KN.bias_gelu_bwd(x, b, dy)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def _rnn_inputs(mode, n_t, n, h, dtype, dev, seed=3):
    r = onp.random.RandomState(seed)
    g = KR.GATES[mode]

    def t(*shape, s):
        return torch.from_numpy((r.randn(*shape) * s).astype("f4")).to(
            dev, dtype)

    xw, h0 = t(n_t, n, g * h, s=0.5), t(n, h, s=0.5)
    c0 = t(n, h, s=0.5) if mode == "lstm" else None
    w, b = t(g * h, h, s=0.5 / h ** 0.5), t(g * h, s=0.1)
    dys = t(n_t, n, h, s=1.0)
    dct = t(n, h, s=1.0) if mode == "lstm" else None
    return xw, h0, c0, w, b, dys, dct


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 3, 37), (12, 16, 300)])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_scan_kernels_on_card(cuda_dev, mode, shape, dtype):
    xw, h0, c0, w, b, dys, dct = _rnn_inputs(mode, *shape, dtype, cuda_dev)
    K.reset_launch_counts()
    ys, cs = KR.rnn_scan_fwd(xw, h0, c0, w, b, mode)
    got = KR.rnn_scan_bwd(xw, h0, c0, w, b, ys, cs, dys, dct, mode)
    torch.cuda.synchronize()
    assert K.launch_counts()["rnn_scan_fwd"] == 1
    assert K.launch_counts()["rnn_scan_bwd"] == 1
    tol = CARD_TOL[dtype]
    rys, rcs = KR.rnn_scan_plain(xw, h0, c0, w, b, mode)
    torch.testing.assert_close(ys.float(), rys.float(), atol=tol, rtol=tol)
    if mode == "lstm":
        torch.testing.assert_close(cs.float(), rcs.float(), atol=tol,
                                   rtol=tol)
    ref = KR.rnn_scan_bwd_plain(xw, h0, c0, w, b, ys, cs, dys, dct, mode)
    for a, r in zip(got, ref):
        if r is None:
            assert a is None
            continue
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=tol)
    # the kernels repeat bit for bit, and leave their inputs as they were
    dct_before = dct.clone() if dct is not None else None
    again = KR.rnn_scan_bwd(xw, h0, c0, w, b, ys, cs, dys, dct, mode)
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))
    if dct is not None:
        assert torch.equal(dct, dct_before)


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_scan_through_autograd_on_card_vs_cpu(cuda_dev, mode, rev):
    """``rnn_scan`` (the Functions, flip-scan-flip for ``reverse``) on the
    card against the same on the CPU (plain versions), float32."""
    inputs = _rnn_inputs(mode, 9, 4, 70, torch.float32, "cpu", seed=4)
    xw, h0, c0, w, b, dys, dct = inputs
    outs = []
    for dev in (cuda_dev, "cpu"):
        leaves = [t.to(dev).requires_grad_() if t is not None else None
                  for t in (xw, h0, c0, w, b)]
        ys, hy, cy = KR.rnn_scan(*leaves, mode, reverse=rev)
        res = [ys, hy] + ([cy] if cy is not None else [])
        cots = [dys.to(dev), dys[0].to(dev)] + \
            ([dct.to(dev)] if cy is not None else [])
        grads = torch.autograd.grad(res, [t for t in leaves
                                          if t is not None], cots)
        outs.append([t.detach().cpu() for t in res + list(grads)])
    for a, r in zip(*outs):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_rnn_wrappers_raise_on_card(cuda_dev):
    xw, h0, c0, w, b, _, _ = _rnn_inputs("lstm", 3, 2, 8, torch.float32,
                                         cuda_dev)
    with pytest.raises(mxt.MXNetError, match="no kernel"):
        KR.rnn_scan(*(t.half() for t in (xw, h0, c0, w, b)), "lstm")
    strided = xw.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(mxt.MXNetError, match="contiguous"):
        KR.rnn_scan_fwd(strided, h0, c0, w, b, "lstm")
    # a hidden width whose grid of at most 8 units a block cannot be
    # resident all at once on one card
    big = 12000
    xw1 = torch.zeros(1, 1, big, device=cuda_dev)
    h1 = torch.zeros(1, big, device=cuda_dev)
    w1 = torch.zeros(big, big, device=cuda_dev)
    b1 = torch.zeros(big, device=cuda_dev)
    with pytest.raises(mxt.MXNetError, match="cooperative"):
        KR.rnn_scan_fwd(xw1, h1, None, w1, b1, "rnn_tanh")
