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
    # the tiles' edges: D 1 and 80, Sq and Sk no multiple of a 64-row
    # tile, causal with Sq < Sk and Sq > Sk, D 7 (no 16-byte rows), S 512
    # causal and S 1024
    (1, 2, 1, 1, 1, False),
    (1, 2, 77, 93, 32, True),
    (1, 2, 150, 70, 128, True),
    (1, 3, 65, 129, 7, False),
    (1, 2, 200, 130, 80, False),
    (1, 4, 512, 512, 64, True),
    (1, 2, 1024, 1024, 64, False),
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
    # no atomics: a second run repeats bit for bit
    again = ATT.flash_attention_fwd(q, k, v, causal)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


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
    # the fused kernel's tile edges: one position, D = 1; one key; one
    # query; D = 128 causal at 512; a ragged key count
    (2, 3, 1, 1, 1, False),
    (2, 3, 77, 1, 64, True),
    (2, 3, 1, 130, 32, True),
    (1, 2, 512, 512, 128, True),
    (2, 3, 300, 449, 64, False),
    # the dq/dkv kernels' tile edges, past 512: one ragged tile, rows that
    # see no key, one query, D 1, D 7 (no 16-byte rows), D 80, D 128 causal
    (1, 2, 513, 513, 64, False),
    (1, 2, 1030, 600, 64, True),
    (1, 2, 1, 1030, 64, True),
    (1, 2, 600, 600, 1, False),
    (1, 2, 600, 600, 7, False),
    (1, 2, 600, 600, 80, False),
    (1, 2, 1024, 1024, 128, True),
]
#: the cases that take the dq and dkv kernels
DQ_DKV_CASES = [c for c in FLASH_BWD_CASES
                if not ATT.uses_fused_bwd(c[2], c[3])]


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
@pytest.mark.parametrize("case", DQ_DKV_CASES)
def test_flash_bwd_dq_dkv_repeat_bit_for_bit_on_card(cuda_dev, dtype, case):
    """Each of dq, dk and dv has one owner and no atomics: two calls
    agree bit for bit."""
    q, k, v, out, lse, do, causal = _bwd_inputs(case, dtype, cuda_dev)
    K.reset_launch_counts()
    first = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
    second = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 2
    assert counts["flash_bwd_fused"] == 0
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_flash_bwd_plan_on_card(cuda_dev, kernel, dtype):
    """The plan query at the long-sequence training shape (B*H 24, S 1024,
    D 64): a grid of whole tiles that the card holds, launching nothing."""
    K.reset_launch_counts()
    plan = ATT.flash_bwd_plan(kernel, 24, 1024, 1024, 64, dtype, cuda_dev)
    assert all(n == 0 for n in K.launch_counts().values())
    assert plan["blocks"] == 24 * (1024 // plan["rows"])
    assert plan["blocks_per_sm"] >= 1 and plan["sms"] >= 1
    assert plan["smem_bytes"] <= 232448


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
@pytest.mark.parametrize("shape", [(7, 3, 37), (12, 16, 300), (9, 1, 300),
                                   (5, 130, 200), (6, 17, 129)])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_scan_kernels_on_card(cuda_dev, mode, shape, dtype):
    _scan_kernels_vs_plain(cuda_dev, mode, shape, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,h", [("lstm", 1024), ("gru", 1024),
                                    ("rnn_tanh", 1500), ("rnn_relu", 1500)])
def test_rnn_scan_bwd_reads_w_hh_through_l2_on_card(cuda_dev, mode, h,
                                                    dtype):
    """300 batch rows at a hidden size the forward still serves, where no
    tile with W_hh's column slice in shared memory keeps the walk's grid
    resident: the walk reads W_hh through L2."""
    plan = KR.rnn_bwd_walk_plan(300, h, mode, dtype, cuda_dev)
    assert not plan["w_in_smem"], plan
    _scan_kernels_vs_plain(cuda_dev, mode, (3, 300, h), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_rnn_scan_fwd_keeps_w_hh_in_shared_memory_on_card(cuda_dev, mode,
                                                          dtype):
    """The LM's layer: one tile a block, W_hh's rows of the tile resident
    in shared memory, whole rows of h staged."""
    plan = KR.rnn_fwd_plan(64, 650, mode, dtype, cuda_dev)
    assert plan["w_in_smem"] and plan["tiles_per_block"] == 1, plan
    assert plan["k_chunk"] == 650 and plan["blocks"] <= 132, plan
    _scan_kernels_vs_plain(cuda_dev, mode, (5, 64, 650), dtype)


#: LSTM shapes the first card kernels refused ("too many blocks in
#: cooperative launch"), with what the plans must now show there
REFUSED_BEFORE = [
    ((3, 64, 4096), "forward"),   # W_hh through L2, several tiles a block
    ((2, 512, 4096), "walk"),     # several walk tiles a block
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,what", REFUSED_BEFORE)
def test_rnn_scan_serves_shapes_refused_before_on_card(cuda_dev, shape, what,
                                                       dtype):
    _, n, h = shape
    fwd = KR.rnn_fwd_plan(n, h, "lstm", dtype, cuda_dev)
    walk = KR.rnn_bwd_walk_plan(n, h, "lstm", dtype, cuda_dev)
    if what == "forward":
        assert not fwd["w_in_smem"] and fwd["tiles_per_block"] > 1, fwd
    else:
        assert walk["tiles_per_block"] > 1 and not walk["w_in_smem"], walk
        assert walk["blocks"] < walk["tiles"], walk
    _scan_kernels_vs_plain(cuda_dev, "lstm", shape, dtype)


@pytest.mark.cuda
def test_rnn_kernels_where_no_row_of_h_fits_a_block_on_card(cuda_dev):
    """H 60,000 (one gate): a row of h (240 KB) fits no block, so the
    forward stages h in column chunks and the decode step reads h through
    L2; W_hh (14.4 GB) has more than 2**31 elements. Forward, backward and
    a decode step against the plain versions, float32."""
    n_t, n, h = 2, 2, 60000
    plan = KR.rnn_fwd_plan(n, h, "rnn_tanh", torch.float32, cuda_dev)
    assert 0 < plan["k_chunk"] < h and not plan["w_in_smem"], plan
    g = torch.Generator(device=cuda_dev).manual_seed(9)

    def t(*shape, s):   # made on the card: W_hh alone is 14.4 GB
        return torch.randn(*shape, generator=g, device=cuda_dev) * s

    xw, h0, w, b = t(n_t, n, h, s=0.5), t(n, h, s=0.5), \
        t(h, h, s=0.5 / h ** 0.5), t(h, s=0.1)
    dys = t(n_t, n, h, s=1.0)
    ys, _ = KR.rnn_scan_fwd(xw, h0, None, w, b, "rnn_tanh")
    ref, _ = KR.rnn_scan_plain(xw, h0, None, w, b, "rnn_tanh")
    torch.testing.assert_close(ys, ref, atol=1e-4, rtol=1e-4)
    del ref
    got = KR.rnn_scan_bwd(xw, h0, None, w, b, ys, None, dys, None,
                          "rnn_tanh")
    ref = KR.rnn_scan_bwd_plain(xw, h0, None, w, b, ys, None, dys, None,
                                "rnn_tanh")
    for a, r in zip(got, ref):   # dxw, dh0, (no dc0), dw, db
        if r is None:
            continue
        for i in range(0, a.shape[0], 4096):   # in row blocks: dw is 14 GB
            torch.testing.assert_close(a[i:i + 4096], r[i:i + 4096],
                                       atol=1e-4, rtol=1e-4)
    del got, ref
    got, _ = KR.rnn_decode_step(xw[0], h0, None, w, b, "rnn_tanh")
    assert torch.equal(got, ys[0])   # the step equals the scan position


def _scan_kernels_vs_plain(cuda_dev, mode, shape, dtype):
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
    # a hidden width the first forward refused (its grid of at most 8
    # units a block could not be resident at once) now runs
    big = 12000
    xw1, h1, _, w1, b1, _, _ = _rnn_inputs("rnn_tanh", 1, 1, big,
                                           torch.float32, cuda_dev)
    ys, _ = KR.rnn_scan_fwd(xw1, h1, None, w1, b1, "rnn_tanh")
    ref, _ = KR.rnn_scan_plain(xw1, h1, None, w1, b1, "rnn_tanh")
    torch.testing.assert_close(ys, ref, atol=1e-4, rtol=1e-4)


def _decode_inputs(mode, n, h, dtype, dev, seed=5):
    xw, h0, c0, w, b, _, _ = _rnn_inputs(mode, 1, n, h, dtype, dev, seed)
    return xw[0].contiguous(), h0, c0, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 37), (8, 650), (11, 64), (128, 650)])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_decode_kernel_on_card(cuda_dev, mode, shape, dtype):
    xw, h, c, w, b = _decode_inputs(mode, *shape, dtype, cuda_dev)
    K.reset_launch_counts()
    hn, cn = KR.rnn_decode_step(xw, h, c, w, b, mode)
    torch.cuda.synchronize()
    assert K.launch_counts()["rnn_decode"] == 1
    rh, rc = KR.rnn_decode_step_plain(xw, h, c, w, b, mode)
    tol = CARD_TOL[dtype]
    assert hn.dtype == dtype and hn.data_ptr() != h.data_ptr()
    torch.testing.assert_close(hn.float(), rh.float(), atol=tol, rtol=tol)
    if mode == "lstm":
        assert cn.data_ptr() != c.data_ptr()
        torch.testing.assert_close(cn.float(), rc.float(), atol=tol,
                                   rtol=tol)
    else:
        assert cn is None
    # the kernel repeats bit for bit
    again = KR.rnn_decode_step(xw, h, c, w, b, mode)
    assert torch.equal(again[0], hn)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_decode_row_independent_of_batch(cuda_dev, mode):
    """A row computed at bucket 8 equals, bit for bit, the same row run
    alone (bucket 1): the engine's exact-token contracts rest on it."""
    xw, h, c, w, b = _decode_inputs(mode, 8, 650, torch.float32, cuda_dev)
    hn, cn = KR.rnn_decode_step(xw, h, c, w, b, mode)
    for row in (0, 3, 7):
        h1, c1 = KR.rnn_decode_step(
            xw[row:row + 1].contiguous(), h[row:row + 1].contiguous(),
            c[row:row + 1].contiguous() if c is not None else None, w, b,
            mode)
        assert torch.equal(h1[0], hn[row])
        if mode == "lstm":
            assert torch.equal(c1[0], cn[row])


@pytest.mark.cuda
def test_rnn_decode_wrapper_raises_on_card(cuda_dev):
    xw, h, c, w, b = _decode_inputs("lstm", 2, 8, torch.float32, cuda_dev)
    with pytest.raises(mxt.MXNetError, match="no kernel"):
        KR.rnn_decode_step(*(t.half() for t in (xw, h, c, w, b)), "lstm")
    strided = h.t().contiguous().t()
    with pytest.raises(mxt.MXNetError, match="contiguous"):
        KR.rnn_decode_step(xw, strided, c, w, b, "lstm")
    # h of 64 x 4,096 floats (1 MB), which the first version refused to
    # stage in one block's shared memory, now runs in row groups
    xw, h, _, w, b = _decode_inputs("rnn_tanh", 64, 4096, torch.float32,
                                    cuda_dev)
    got, _ = KR.rnn_decode_step(xw, h, None, w, b, "rnn_tanh")
    ref, _ = KR.rnn_decode_step_plain(xw, h, None, w, b, "rnn_tanh")
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [0, 3])
def test_decode_engine_dispatch_is_sync_free_on_card(cuda_dev, spec):
    """The engine's dispatches make no host sync (the retire is the one,
    exempt through ``engine.allow_sync``), and its tokens equal a CPU
    copy's."""
    from mxnet_tpu_torch.serving import DecodeEngine, TinyDecoder

    rng = onp.random.RandomState(3)
    base = rng.randint(0, 64, size=9)
    prompts = [onp.concatenate([base, rng.randint(0, 64, size=i + 1)])
               for i in range(4)] + [rng.randint(0, 64, size=3)]
    outs = []
    for dev in (cuda_dev, "cpu"):
        model = TinyDecoder(vocab=64, d_model=32, num_heads=2, seed=0,
                            device=dev)
        eng = DecodeEngine(model, ladder=(1, 2, 4), page_size=4,
                           max_context=48, start=False, spec_k=spec,
                           prefix_share=bool(spec))
        try:
            eng.warmup()
            streams = [eng.submit(p, max_new=6) for p in prompts]
            if dev != "cpu":
                torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(400):
                    did = eng.step_once()
                    if not did and eng._idle():
                        break
                    if not did:
                        eng.sync()
            finally:
                if dev != "cpu":
                    torch.cuda.set_sync_debug_mode(0)
            outs.append([s.result(0) for s in streams])
            assert eng._dead is None
        finally:
            eng.close()
    assert outs[0] == outs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_decode_equals_scan_position_on_card(cuda_dev, mode, dtype):
    """Decode steps fed back repeat the ``rnn_scan_fwd`` kernel's
    trajectory bit for bit: one summation order, one gate function."""
    xw, h0, c0, w, b, _, _ = _rnn_inputs(mode, 9, 8, 650, dtype, cuda_dev,
                                         seed=6)
    ys, cs = KR.rnn_scan_fwd(xw, h0, c0, w, b, mode)
    h, c = h0, c0
    for t in range(xw.shape[0]):
        h, c = KR.rnn_decode_step(xw[t], h, c, w, b, mode)
        assert torch.equal(h, ys[t])
        if mode == "lstm":
            assert torch.equal(c, cs[t])


def _opt_unit(kind_code, n, dtype, dev, seed, vec):
    """Flat unit inputs of the ``opt_update`` kernel on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    n_states = {"sgd": 0, "sgd_mom": 1, "adam": 2}[kind_code]
    w = torch.randn(n, generator=g).to(dev, dtype)
    grad = (torch.randn(n, generator=g) * 3).to(dev, dtype)
    states = tuple((torch.rand(n, generator=g) * 0.1).to(dev, dtype)
                   for _ in range(n_states))
    if vec:
        hp = ((torch.rand(n, generator=g) * 0.1).to(dev),
              (torch.rand(n, generator=g) * 0.01).to(dev),
              torch.randint(1, 5, (n,), generator=g).to(dev, torch.int32))
    else:
        hp = (0.05, 0.01, 3)
    return w, grad, states, hp


def opt_weight_ulps(got, ref, w_in):
    """Max |got - ref| in float32 ulps of max(|w_in|, |ref|): the new
    weight's error against the scale of the value it updates."""
    scale = torch.maximum(w_in.float().abs(), ref.float().abs())
    ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) \
        - scale
    return float(((got.float() - ref.float()).abs() / ulp).max())


OPT_KERNEL_CASES = [("sgd", {"momentum": 0.0}), ("sgd_mom", {"momentum": 0.9}),
                    ("adam", {"beta1": 0.9, "beta2": 0.999,
                              "epsilon": 1e-8})]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("case", OPT_KERNEL_CASES, ids=lambda c: c[0])
def test_opt_update_kernel_on_card(cuda_dev, case, clip, vec, dtype):
    """Kernel 12 against its plain version on the card at a ragged length:
    float32 states bit-exact and the weight within 1 ulp (float32 pow of
    the bias correction), bfloat16 within 2e-2."""
    from mxnet_tpu_torch.ops.kernels import opt_update as KO
    code, extra = case
    kind = "adam" if code == "adam" else "sgd"
    cfg = dict(extra, has_clip=clip)
    w, g, states, (lr, wd, t) = _opt_unit(code, 5001, dtype, cuda_dev, 4,
                                          vec)
    pw, ps = KO.unit_update_plain(kind, cfg, w, g, lr, wd, t, 0.25, 0.5,
                                  states)
    kw, ks = w.clone(), tuple(s.clone() for s in states)
    before = K.launch_counts()["opt_update"]
    KO.unit_update(kind, cfg, kw, g, lr, wd, t, 0.25, 0.5, ks)
    torch.cuda.synchronize()
    assert K.launch_counts()["opt_update"] == before + 1
    if dtype == torch.float32:
        for a, b in zip(ks, ps):
            assert torch.equal(a, b)
        assert opt_weight_ulps(kw, pw, w) <= 1
    else:
        for a, b in list(zip(ks, ps)) + [(kw, pw)]:
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=2e-2)


@pytest.mark.cuda
def test_opt_update_wrapper_raises_on_card(cuda_dev):
    from mxnet_tpu_torch.ops.kernels import opt_update as KO
    cfg = {"momentum": 0.9, "has_clip": False}
    w = torch.zeros(8, 4, device=cuda_dev)
    with pytest.raises(mxt.MXNetError, match="flat"):
        KO.unit_update("sgd", cfg, w, w, 0.1, 0.0, 1, 1.0, 0.0,
                       (torch.zeros_like(w),))
    w = torch.zeros(8, device=cuda_dev)
    with pytest.raises(mxt.MXNetError, match="states"):
        KO.unit_update("sgd", cfg, w, w, 0.1, 0.0, 1, 1.0, 0.0, ())
    with pytest.raises(mxt.MXNetError, match="all scalars or all"):
        KO.unit_update("sgd", cfg, w, w, torch.zeros(8, device=cuda_dev),
                       0.0, 1, 1.0, 0.0, (torch.zeros_like(w),))
