"""mxnet_tpu_torch's CUDA kernels against their plain versions, on the
card, forward and backward; that kernel outputs carry gradients and
parameters train there; a 2-layer encoder's gradients on the card
against a CPU copy; and bf16 ``amp``'s kernels by dtype and one-sync
overflow check. Every test here needs a CUDA device and skips
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
import functools
import os

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


#: the fused backward's bf16 tile edges (the tensor-core kernel): one
#: position at D 1, one key, one query, D 7, 80 and 128, a ragged key
#: count, S 512 non-causal and causal
FUSED_BF16_EDGES = [
    (2, 3, 1, 1, 1, False),
    (2, 3, 77, 1, 64, True),
    (2, 3, 1, 130, 32, True),
    (1, 2, 200, 200, 7, False),
    (1, 2, 70, 70, 80, False),
    (1, 2, 200, 130, 128, True),
    (2, 3, 300, 449, 64, False),
    (1, 4, 512, 512, 64, False),
    (1, 4, 512, 512, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_BF16_EDGES)
def test_flash_bwd_fused_bf16_edges_on_card(cuda_dev, case):
    """The bf16 fused backward against its plain version; dk and dv have
    one owner each and repeat bit for bit, dq (float32 atomics) within
    the tolerance; one launch a call, counted under bfloat16."""
    q, k, v, out, lse, do, causal = _bwd_inputs(case, torch.bfloat16,
                                                cuda_dev)
    K.reset_launch_counts()
    first = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
    second = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert K.launch_counts_by_dtype()["flash_bwd_fused"] == {"bfloat16": 2}
    ref = ATT.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for g, r in zip(first, ref):
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2,
                                   rtol=2e-2)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    torch.testing.assert_close(first[0].float(), second[0].float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_flash_bwd_fused_f32_on_a_second_card_in_one_process(cuda_dev):
    """The float32 fused backward's shared-memory attribute belongs to
    the device current when it is set: launched on cuda:0 and then on
    cuda:1 from one process (as a fleet drives several cards), each
    launch is within its plain version's tolerance."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    case = (2, 4, 128, 128, 64, False)
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        q, k, v, out, lse, do, causal = _bwd_inputs(case, torch.float32,
                                                    dev)
        K.reset_launch_counts()
        got = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize(dev)
        assert K.launch_counts()["flash_bwd_fused"] == 1
        ref = ATT.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        for g, r in zip(got, ref):
            assert g.device == dev
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_amp_bert_launches_by_dtype_on_card(cuda_dev):
    """bert_small_test under amp, forward and backward on the card: the
    flash kernels launch in bf16, the LayerNorm kernels in float32, and
    every gradient comes back float32."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.model_zoo import bert
    net = bert.bert_small_test(dropout=0.0, device=cuda_dev)
    x = torch.randint(0, 128, (2, 16), device=cuda_dev)
    amp.init()
    try:
        K.reset_launch_counts()
        seq, pooled = net(x)
        (seq.float().sum() + pooled.float().sum()).backward()
        torch.cuda.synchronize()
    finally:
        amp.uninit()
    n = K.launch_counts_by_dtype()
    assert n["flash_fwd"] == {"bfloat16": 2}
    assert n["flash_bwd_fused"] == {"bfloat16": 2}
    assert n["layernorm_fwd"] == {"float32": 5}
    assert n["layernorm_bwd"] == {"float32": 5}
    assert seq.dtype == torch.float32 and pooled.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 for p in net.parameters()
               if p.grad is not None)


@pytest.mark.cuda
def test_loss_scaler_has_overflow_syncs_once_on_card(cuda_dev):
    """has_overflow checks every gradient on the card and brings one flag
    back: one host sync, not one a parameter."""
    import warnings
    from mxnet_tpu_torch import amp
    grads = [torch.randn(64, 64, device=cuda_dev) for _ in range(40)]
    scaler = amp.LossScaler()
    torch.cuda.synchronize()
    for bad, want in ((None, False), (float("inf"), True)):
        if bad is not None:
            grads[17][3, 5] = bad
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = scaler.has_overflow(grads)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert got is want
        assert sum("synchroniz" in str(w.message) for w in caught) == 1


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


#: the LayerNorm backward's edges by dtype: C at the warp branch's cap
#: and one past it, C 16,384 (block branch), C 771 (one element a load),
#: rows below the block count, one row
LN_BWD_EDGES = {
    torch.float32: {"cap": (300, 1024), "cap+1": (300, 1025),
                    "c16384": (20, 16384), "c771": (4099, 771),
                    "few_rows": (3, 768), "one_row": (1, 768)},
    torch.bfloat16: {"cap": (300, 2048), "cap+1": (300, 2049),
                     "c16384": (20, 16384), "c771": (4099, 771),
                     "few_rows": (3, 768), "one_row": (1, 768)},
}
LN_BWD_BRANCH = {"cap": "warp", "cap+1": "block", "c16384": "block",
                 "c771": "warp", "few_rows": "warp", "one_row": "warp"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", sorted(LN_BWD_BRANCH))
def test_layernorm_bwd_edges_on_card(cuda_dev, dtype, edge):
    """Each branch of the plan at its edges: within tolerance of the plain
    version, and dx, dgamma, dbeta repeat bit for bit."""
    rows, c = LN_BWD_EDGES[dtype][edge]
    assert KN.ln_bwd_plan(rows, c, dtype, cuda_dev)["branch"] == \
        LN_BWD_BRANCH[edge]
    g = torch.Generator().manual_seed(rows + c)
    x = torch.randn(rows, c, generator=g).to(cuda_dev, dtype)
    dy = torch.randn(rows, c, generator=g).to(cuda_dev, dtype)
    gam = torch.randn(c, generator=g).to(cuda_dev)
    got = KN.layer_norm_bwd(x, gam, dy)
    ref = KN.layer_norm_bwd_plain(x, gam, dy)
    tol = CARD_TOL[dtype]
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=tol)
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


def _offset(shape, offset, g, dev, dtype):
    """A contiguous tensor of ``shape`` that starts ``offset`` elements
    into its storage (offset 1: no 16-byte loads)."""
    n = int(onp.prod(shape))
    return torch.randn(n + offset, generator=g).to(dev, dtype)[offset:] \
        .view(*shape)


#: the LayerNorm forward's shapes: served, one row, C 1, C 771, C 16,384
#: (block branch, the row in shared memory), C 120,000 (the row too wide
#: for it), a 3-axis x, and by dtype C at the warp branch's cap and one
#: past it
LN_FWD_SHAPES = [(4096, 768), (1, 768), (3, 1), (37, 771), (20, 16384),
                 (3, 120000), (3, 5, 33)]
LN_FWD_CAPS = {torch.float32: [(300, 1024), (300, 1025)],
               torch.bfloat16: [(300, 2048), (300, 2049)]}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LN_FWD_SHAPES + ["cap", "cap+1"])
def test_layernorm_fwd_kernel_on_card(cuda_dev, dtype, shape, offset):
    """Every branch of ln_fwd_plan, x aligned and offset by one element:
    one launch, within tolerance of the plain version, bit for bit on a
    second run."""
    if isinstance(shape, str):
        shape = LN_FWD_CAPS[dtype][shape == "cap+1"]
    g = torch.Generator().manual_seed(3)
    x = _offset(shape, offset, g, cuda_dev, dtype)
    c = shape[-1]
    gam = torch.randn(c, generator=g).to(cuda_dev)
    bet = torch.randn(c, generator=g).to(cuda_dev)
    plan = KN.ln_fwd_plan(x.numel() // c, c, dtype, cuda_dev,
                          aligned=offset == 0)
    assert plan["vec"] == 1 or offset == 0
    K.reset_launch_counts()
    y = KN.layer_norm(x, gam, bet)
    torch.cuda.synchronize()
    assert K.launch_counts()["layernorm_fwd"] == 1
    assert y.dtype == dtype and y.shape == x.shape
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(y.float(), KN.layer_norm_plain(
        x, gam, bet).float(), atol=tol, rtol=tol)
    assert torch.equal(KN.layer_norm(x, gam, bet), y)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 3072), (37, 50), (3, 5, 33),
                                   (1, 3072), (3, 1), (20, 16384)])
def test_bias_gelu_bwd_kernel_on_card(cuda_dev, dtype, shape, offset):
    """One launch, within tolerance of the plain version, dx and db bit
    for bit on a second run, x and dy aligned and offset by one element;
    db in b's dtype, also a float32 b under bfloat16 x."""
    g = torch.Generator().manual_seed(2)
    x = _offset(shape, offset, g, cuda_dev, dtype)
    dy = _offset(shape, offset, g, cuda_dev, dtype)
    for b_dtype in dict.fromkeys((dtype, torch.float32)):
        b = torch.randn(shape[-1], generator=g).to(cuda_dev, b_dtype)
        K.reset_launch_counts()
        got = KN.bias_gelu_bwd(x, b, dy)
        torch.cuda.synchronize()
        assert K.launch_counts()["bias_gelu_bwd"] == 1
        assert got[0].dtype == dtype and got[1].dtype == b_dtype
        tol = CARD_TOL[dtype]
        for a, r in zip(got, KN.bias_gelu_bwd_plain(x, b, dy)):
            torch.testing.assert_close(a.float(), r.float(), atol=tol,
                                       rtol=tol)
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
@pytest.mark.parametrize("shape", [(3, 37), (8, 650), (11, 64), (128, 650),
                                   (2, 4096)])
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
@pytest.mark.parametrize("shape", [(8, 650), (8, 128), (2, 4096)])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_rnn_decode_reads_bf16_weights_on_card(cuda_dev, mode, shape):
    """bfloat16 activations with bfloat16 W_hh and b_hh, read as they are
    (no float32 copy), give the bits of the same weights widened to
    float32, and the plain version's values within tolerance."""
    xw, h, c, w, b = _decode_inputs(mode, *shape, torch.bfloat16, cuda_dev)
    assert w.dtype == b.dtype == torch.bfloat16
    got = KR.rnn_decode_step(xw, h, c, w, b, mode)
    wide = KR.rnn_decode_step(xw, h, c, w.float(), b.float(), mode)
    ref = KR.rnn_decode_step_plain(xw, h, c, w, b, mode)
    for a, aw, r in zip(got, wide, ref):
        if r is None:
            continue
        assert torch.equal(a, aw)
        torch.testing.assert_close(a.float(), r.float(), atol=2e-2,
                                   rtol=2e-2)


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


def _sync_free_decode_tokens(cuda_dev, spec, inflight):
    """Tokens of a warmed engine on the card, its step loop run under
    ``set_sync_debug_mode("error")``, and of its CPU copy."""
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
                           prefix_share=bool(spec), inflight=inflight)
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
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [0, 3])
def test_decode_engine_dispatch_is_sync_free_on_card(cuda_dev, spec):
    """The engine's dispatches make no host sync (the retire is the one,
    exempt through ``engine.allow_sync``), and its tokens equal a CPU
    copy's."""
    outs = _sync_free_decode_tokens(cuda_dev, spec, inflight=1)
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_decode_engine_deep_window_is_sync_free_on_card(cuda_dev):
    """With four steps in flight no dispatch waits for an earlier one's
    staging copy: still no host sync, and the CPU copy's tokens."""
    outs = _sync_free_decode_tokens(cuda_dev, 0, inflight=4)
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
    # device scalars come all five together: lr, wd and t on the card
    # with a host rescale (or a device rescale with host lr) are refused
    f32 = functools.partial(torch.zeros, (), device=cuda_dev)
    t = torch.ones((), dtype=torch.int32, device=cuda_dev)
    with pytest.raises(mxt.MXNetError, match="all device scalars or none"):
        KO.unit_update("sgd", cfg, w, w, f32(), f32(), t, 1.0, 0.0,
                       (torch.zeros_like(w),))
    with pytest.raises(mxt.MXNetError, match="all device scalars or none"):
        KO.unit_update("sgd", cfg, w, w, 0.1, 0.0, 1, f32(), f32(),
                       (torch.zeros_like(w),))


def _param_shapes(model):
    """The trainable parameters' shapes of resnet18_v1 (thumbnail, 10
    classes: 60 tensors of 10 to 589,824 values) or of the small BERT
    classifier."""
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    net = resnet18_v1(classes=10, thumbnail=True, device="cpu") \
        if model == "resnet18" else tbert.BERTClassifier(
            tbert.bert_small_test(device="cpu"), num_classes=3,
            device="cpu")
    return [tuple(p.shape) for p in net.parameters()
            if getattr(p, "grad_req", "write") != "null"]


def _opt_list(code, shapes, dtype, dev, seed, forms):
    """Flat units of ``shapes`` on ``dev`` with their lr / wd / t, each
    entry's form taken in turn from ``forms`` ("host", "vector")."""
    units, hps = [], []
    for i, shp in enumerate(shapes):
        n = int(onp.prod(shp))
        w, g, st, hp = _opt_unit(code, n, dtype, dev, seed + i,
                                 forms[i % len(forms)] == "vector")
        if not isinstance(hp[0], torch.Tensor):
            hp = (0.05 * (1 + i % 3), 0.01 * (i % 2), 1 + i % 4)
        units.append((w, g, st))
        hps.append(hp)
    return units, hps


def _opt_list_vs_plain(kind, cfg, units, hps, rescale, clip, dtype,
                       lows=None):
    """The list through ``multi_update`` (one launch) against each entry's
    plain version: float32 states bit-exact and weights within 1 ulp (and
    each low copy the rounding of its new weight), bfloat16 within
    2e-2."""
    from mxnet_tpu_torch.ops.kernels import opt_update as KO
    ws = [w.clone() for w, _, _ in units]
    sts = [tuple(s.clone() for s in st) for _, _, st in units]
    before = K.launch_counts()["opt_update"]
    KO.multi_update(kind, cfg, ws, [g for _, g, _ in units],
                    [h[0] for h in hps], [h[1] for h in hps],
                    [h[2] for h in hps], rescale, clip, sts, lows)
    torch.cuda.synchronize()
    assert K.launch_counts()["opt_update"] == before + 1
    plain = KO.multi_update_plain(kind, cfg, *zip(*[(w, g) for w, g, _ in
                                                    units]),
                                  [h[0] for h in hps], [h[1] for h in hps],
                                  [h[2] for h in hps], rescale, clip,
                                  [st for _, _, st in units])
    for i, ((w, _, _), kw, ks, (pw, ps)) in enumerate(
            zip(units, ws, sts, plain)):
        if dtype == torch.float32:
            for a, b in zip(ks, ps):
                assert torch.equal(a, b), i
            assert opt_weight_ulps(kw, pw, w) <= 1, i
            if lows is not None and lows[i] is not None:
                assert torch.equal(lows[i], kw.to(lows[i].dtype)), i
        else:
            for a, b in list(zip(ks, ps)) + [(kw, pw)]:
                torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                           atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", ["resnet18", "bert_small"])
@pytest.mark.parametrize("case", OPT_KERNEL_CASES, ids=lambda c: c[0])
def test_multi_update_real_parameter_lists_on_card(cuda_dev, case, model,
                                                   dtype):
    """One ``opt_update`` launch over a model's whole parameter list
    (ResNet-18: 60 tensors; the small BERT), hyperparameters host scalars
    and per-element vectors in turn, clip on, against each tensor's plain
    version: float32 states at 0 ulps and weights within 1 ulp, as
    ``test_opt_update_kernel_on_card`` holds one unit."""
    code, extra = case
    kind = "adam" if code == "adam" else "sgd"
    units, hps = _opt_list(code, _param_shapes(model), dtype, cuda_dev, 30,
                           ("host", "vector"))
    _opt_list_vs_plain(kind, dict(extra, has_clip=True), units, hps, 0.25,
                       0.5, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["host", "device"])
@pytest.mark.parametrize("case", OPT_KERNEL_CASES, ids=lambda c: c[0])
def test_multi_update_ragged_misaligned_list_on_card(cuda_dev, case, form):
    """Entries of 1, 3, 64, 768, 5,001 and 20,000 values (several chunks),
    a view one element into a larger buffer (the element path), and
    float32 masters whose bfloat16 / float16 weights the same launch
    writes; hyperparameters host scalars, or read from a ``DeviceHParams``
    block with the rescale and the clip (the captured step's form)."""
    from mxnet_tpu_torch.optimizer.optimizer import DeviceHParams
    code, extra = case
    kind = "adam" if code == "adam" else "sgd"
    shapes = [(1,), (3,), (64,), (768,), (5001,), (20000,), (999,)]
    units, hps = _opt_list(code, shapes, torch.float32, cuda_dev, 50,
                           ("host",))
    big = torch.randn(1000, device=cuda_dev)
    w, g, st = units[-1]
    units[-1] = (big[1:].copy_(w), g, st)      # misaligned by 4 bytes
    rescale, clip = 0.25, 0.5
    if form == "device":
        hp = DeviceHParams(len(units), cuda_dev)
        hp.stage([h[0] for h in hps], [h[1] for h in hps],
                 [h[2] for h in hps], rescale, clip)
        hps = list(zip(*hp.per_param()))
        rescale, clip = hp.rescale, hp.clip
    lows = [None, torch.empty(3, dtype=torch.bfloat16, device=cuda_dev),
            None, torch.empty(768, dtype=torch.float16, device=cuda_dev),
            torch.empty(5001, dtype=torch.bfloat16, device=cuda_dev),
            None, None]
    _opt_list_vs_plain(kind, dict(extra, has_clip=True), units, hps,
                       rescale, clip, torch.float32, lows)


@pytest.mark.cuda
def test_multi_update_one_launch_a_group_on_card(cuda_dev):
    """A list of float32 and bfloat16 units is one launch a dtype, each
    counted under its dtype; more entries than one launch takes
    (``CAPACITY``) are several launches."""
    from mxnet_tpu_torch.ops.kernels import opt_update as KO
    cfg = {"momentum": 0.9, "has_clip": False}
    ws = [torch.ones(10, device=cuda_dev, dtype=dt)
          for dt in (torch.float32, torch.bfloat16) * 3]
    ms = [(torch.zeros_like(w),) for w in ws]
    K.reset_launch_counts()
    KO.multi_update("sgd", cfg, ws, ws, [0.5] * 6, [0.0] * 6, [1] * 6, 1.0,
                    0.0, ms)
    assert K.launch_counts_by_dtype()["opt_update"] == {"float32": 1,
                                                         "bfloat16": 1}
    n = KO.CAPACITY + 1
    ws = [torch.ones(2, device=cuda_dev) for _ in range(n)]
    KO.multi_update("sgd", cfg, ws, ws, [0.5] * n, [0.0] * n, [1] * n, 1.0,
                    0.0, [(torch.zeros_like(w),) for w in ws])
    torch.cuda.synchronize()
    assert K.launch_counts()["opt_update"] == 4
    assert all(torch.equal(w, torch.full_like(w, 0.5)) for w in ws)


def _eager_pair(dev, opt, kw, dtype=torch.float32):
    """Two copies of the small MLP, one gradient for both, and a trainer
    each: the second one's updates go through ``_apply``."""
    from mxnet_tpu_torch.gluon import Trainer
    nets = [_mlp_on(dev, 3) for _ in range(2)]
    for net in nets:
        net.to(dtype)
    trs = [Trainer(dict(net.named_parameters()), opt, dict(kw))
           for net in nets]
    r = onp.random.RandomState(4)
    grads = [torch.from_numpy(r.randn(*p.shape).astype("f4")).to(dev, dtype)
             for p in trs[0]._params]
    return nets, trs, grads


@pytest.mark.cuda
@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
             "clip_gradient": 0.5}),
    ("adam", {"learning_rate": 1e-2, "wd": 1e-3}),
    ("adam", {"learning_rate": 1e-2, "multi_precision": True}),
], ids=["sgd_mom", "adam", "adam_bf16_mp"])
def test_eager_trainer_step_one_launch_a_group_on_card(cuda_dev, opt, kw,
                                                       monkeypatch):
    """The eager ``Trainer.step`` of exact SGD/Adam on a card is one
    ``opt_update`` launch a step (bf16 weights with ``multi_precision``:
    their float32 masters, the weights written as the masters' rounding
    by the same launch). Three steps against ``_apply`` on the card (the
    eager rule parameter by parameter): SGD-momentum bit for bit; Adam
    within 1e-6 + 1e-5 |w|, since ``_apply`` takes ``1 - b1 ** t`` in
    double and the kernel a float32 ``powf``, a few ulps of each step."""
    from mxnet_tpu_torch.optimizer import optimizer as O
    mp = kw.get("multi_precision", False)
    nets, trs, grads = _eager_pair(cuda_dev, opt, kw,
                                   torch.bfloat16 if mp else torch.float32)
    K.reset_launch_counts()
    for step in range(3):
        for p, g in zip(trs[0]._params, grads):
            p.grad, p.fresh_grad = g.clone(), True
        trs[0].step(8)
    torch.cuda.synchronize()
    assert K.launch_counts_by_dtype()["opt_update"] == {"float32": 3}
    with monkeypatch.context() as m:
        m.setattr(O.Optimizer, "_kernel_update", lambda *a: None)
        for step in range(3):
            for p, g in zip(trs[1]._params, grads):
                p.grad, p.fresh_grad = g.clone(), True
            trs[1].step(8)
    torch.cuda.synchronize()
    assert K.launch_counts()["opt_update"] == 3
    for i, (a, b) in enumerate(zip(trs[0]._params, trs[1]._params)):
        if mp:
            ma, mb = trs[0]._updater.states[i][1], \
                trs[1]._updater.states[i][1]
            assert torch.equal(a, ma.to(a.dtype))
            a, b = ma, mb
        if opt == "sgd":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_dropped_step_frees_its_graph_pool_on_card(cuda_dev):
    """A captured step dropped (``del``) hands its graph pool and static
    buffers back at once, with no ``gc.collect()``: after
    ``empty_cache`` the reserved memory is within 4 MiB of what it was
    before the capture. The first round makes what lives as long as the
    process (cuBLAS's workspace for the capture stream)."""
    import gc
    net, lb, x, y = _dense_on(cuda_dev)
    tr, _ = _compiled(net, lb)
    reserved = []
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved.append(torch.cuda.memory_reserved(cuda_dev))
            step = tr.compile_step(lambda a, b: lb(net(a), b))
            step.aot_compile(x, y)
            step(x, y)
            step(x[:32], y[:32])
            assert step.n_traces == 2
            del step
            torch.cuda.empty_cache()
            reserved.append(torch.cuda.memory_reserved(cuda_dev))
    finally:
        gc.enable()
    assert abs(reserved[3] - reserved[2]) <= 4 << 20, reserved


# ---------------------------------------------------------------------------
# captured programs (serving/captured.py): CUDA graphs per signature
# ---------------------------------------------------------------------------

def _small_bert(dev, dtype, seed=0):
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    from mxnet_tpu_torch.serving import predictor_for
    net = tbert.BERTClassifier(tbert.bert_small_test(device=dev),
                               num_classes=3, device=dev)
    load_jax_params(net, init_params_numpy(net, seed))
    return predictor_for(net, dtype=dtype, device=dev)


def _tokens(b, seed, seq=32):
    return onp.random.RandomState(seed).randint(0, 128, (b, seq)) \
        .astype("int64")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_replay_equals_the_eager_net_on_card(cuda_dev, dtype):
    """Every bucket's graph replay gives the logits of the net called
    eagerly on the same padded batch, bit for bit (same kernels, same
    cuBLAS calls), and counts the kernels' launches once a replay."""
    pred = _small_bert(cuda_dev, dtype)
    warm = pred.warmup(_tokens(1, 0))
    assert set(warm) == set(pred.bucket_sizes)
    assert pred.n_traces == len(pred.bucket_sizes)
    for b in pred.bucket_sizes:
        x = _tokens(b, b)
        K.reset_launch_counts()
        got = pred.predict(x)
        counts = K.launch_counts()
        with torch.inference_mode():
            ref = pred.net(torch.from_numpy(x).to(cuda_dev))
        assert torch.equal(got, ref), f"bucket {b}"
        # 2 layers: 2 flash, 5 LayerNorm (embeddings + 2 a layer)
        assert counts["flash_fwd"] == 2 and counts["layernorm_fwd"] == 5
    assert pred.n_traces == len(pred.bucket_sizes)


@pytest.mark.cuda
def test_predictor_follows_weights_loaded_after_warmup_on_card(cuda_dev):
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    pred = _small_bert(cuda_dev, "float32")
    pred.warmup(_tokens(1, 0))
    x = _tokens(4, 3)
    first = pred.predict(x)
    load_jax_params(pred.net, init_params_numpy(pred.net, 1))
    second = pred.predict(x)
    with torch.inference_mode():
        ref = pred.net(torch.from_numpy(x).to(cuda_dev))
    assert torch.equal(second, ref) and not torch.equal(first, second)
    assert pred.n_traces == len(pred.bucket_sizes)


@pytest.mark.cuda
def test_first_seen_signature_captured_while_a_thread_reads_on_card(
        cuda_dev):
    """A capture (thread-local mode) goes through while another thread
    copies results to the host; both threads' results are right."""
    import threading
    pred = _small_bert(cuda_dev, "float32")
    pred.warmup(_tokens(1, 0), buckets=(1,))
    x1 = _tokens(1, 5)
    ref1 = pred.predict(x1).cpu()
    stop, seen, errors = threading.Event(), [], []

    def reader():
        try:
            while not stop.is_set():
                seen.append(torch.equal(pred.predict(x1).cpu(), ref1))
        except Exception as e:          # reported by the assert below
            errors.append(e)

    t = threading.Thread(target=reader)
    t.start()
    try:
        x4 = _tokens(4, 6)
        got = pred.predict(x4)          # bucket 4: captured now
    finally:
        stop.set()
        t.join(60)
    assert not errors and seen and all(seen)
    with torch.inference_mode():
        ref = pred.net(torch.from_numpy(x4).to(cuda_dev))
    assert torch.equal(got, ref) and pred.n_traces == 2


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tiny", "gqa"])
@pytest.mark.parametrize("spec", [0, 3])
def test_decode_graphs_tokens_equal_the_cpu_copy_on_card(cuda_dev, model,
                                                         spec):
    """``run_decode`` on the captured programs gives the CPU copy's
    tokens, with no program captured after the warm-up."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon import GQADecoder
    rng = onp.random.RandomState(4)
    prompts = [rng.randint(0, 64, size=int(rng.randint(2, 20)))
               for _ in range(6)]
    mns = [int(rng.randint(2, 9)) for _ in range(6)]
    reps = []
    for dev in (cuda_dev, "cpu"):
        if model == "tiny":
            m = serving.TinyDecoder(vocab=64, d_model=32, num_heads=2,
                                    seed=0, device=dev)
        else:
            m = GQADecoder(vocab=64, d_model=32, num_heads=4,
                           num_kv_heads=2, num_layers=2, seed=1, device=dev)
        reps.append(serving.run_decode(m, prompts, mns, ladder=(1, 2, 4),
                                       page_size=4, spec_k=spec,
                                       prefix_share=bool(spec)))
    assert reps[0]["tokens_by_request"] == reps[1]["tokens_by_request"]
    assert reps[0]["n_traces"] == 0 and reps[0]["errors"] == 0
    assert len(reps[0]["captures"]) == 3 * (3 if spec else 2)


@pytest.mark.cuda
def test_a_failed_capture_raises_and_runs_nothing_eagerly_on_card(cuda_dev):
    """A forward that syncs with the host cannot be captured: the call
    raises MXNetError, counts no program, and raises again next time."""
    from mxnet_tpu_torch.serving import CompiledPredictor

    class Syncing(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4, device=cuda_dev))

        def forward(self, x):
            return x * self.w * float(x.sum().item())

    pred = CompiledPredictor(Syncing(), bucket_sizes=(2,), device=cuda_dev)
    x = torch.ones(2, 4)
    for _ in range(2):
        with pytest.raises(mxt.MXNetError, match="capture of"):
            pred.predict(x)
    assert pred.n_traces == 0
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the prefetcher's side stream, TrainLoop.prefetch, the overlapped ZeRO
# step and the in-process supervisor on the card
# ---------------------------------------------------------------------------

def _mlp_on(dev, seed=3):
    from mxnet_tpu_torch.gluon.nn import Dense
    r = onp.random.RandomState(seed)
    net = torch.nn.Sequential(
        Dense(256, in_units=64, activation="relu", device=dev),
        Dense(3, in_units=256, device=dev))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(
                (r.randn(*p.shape) * 0.1).astype("f4")))
    return net


def _host_batches(n, bs=64, seed=0):
    r = onp.random.RandomState(seed)
    return [(r.randn(bs, 64).astype("f4"),
             r.randint(0, 3, (bs,)).astype("f4")) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
def test_prefetcher_stages_on_its_stream_on_card(cuda_dev, depth):
    """Large batches staged from pinned memory on the prefetcher's
    stream: the consumer's stream waits for them, so a kernel queued at
    once reads the whole copy; structure and values kept."""
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher
    r = onp.random.RandomState(1)
    host = [(r.randn(1 << 22).astype("f4"), {"i": onp.int64(i)})
            for i in range(4)]
    pf = DevicePrefetcher(iter(host), depth=depth, device=cuda_dev)
    sums, staged = [], []
    for (x, meta), (hx, hm) in zip(pf, host):
        assert x.is_cuda and meta["i"] == hm["i"]
        sums.append(x.double().sum())
        staged.append(x)
    # the same reduction over a synchronous copy, and the staged bytes
    ref = [torch.from_numpy(hx).to(cuda_dev).double().sum()
           for hx, _ in host]
    assert [float(s) for s in sums] == [float(r) for r in ref]
    for x, (hx, _) in zip(staged, host):
        assert torch.equal(x.cpu(), torch.from_numpy(hx))
    assert pf.stats_snapshot()["prefetch_batches"] == 4


@pytest.mark.cuda
def test_trainloop_prefetch_bit_equal_to_plain_steps_on_card(cuda_dev):
    from mxnet_tpu_torch.gluon import Trainer, TrainLoop
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    host = _host_batches(6)
    runs = []
    for prefetch in (False, True):
        net = _mlp_on(cuda_dev)
        loop = TrainLoop(net, Trainer(dict(net.named_parameters()), "adam",
                                      {"learning_rate": 1e-2}),
                         SoftmaxCrossEntropyLoss())
        src = loop.prefetch(iter(host)) if prefetch else iter(host)
        losses = [loop.step(x, y) for x, y in src]
        loop.synchronize()
        runs.append(([l.cpu() for l in losses],
                     [p.detach().cpu() for p in net.parameters()]))
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


def _elastic_build_on_card():
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    net = _mlp_on(torch.device("cuda", 0))
    return net, Trainer(dict(net.named_parameters()), "adam",
                        {"learning_rate": 1e-2}), SoftmaxCrossEntropyLoss()


@pytest.mark.cuda
def test_in_process_recovery_bit_exact_on_card(cuda_dev, tmp_path):
    """A transient failure at step 5's dispatch on the card: one event,
    restored at step 4, the losses after it bit for bit an uninterrupted
    run restored from the same checkpoint."""
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.checkpoint import TrainCheckpointManager
    from mxnet_tpu_torch.gluon import TrainLoop
    from mxnet_tpu_torch.testing import faults
    host = _host_batches(8)
    d = str(tmp_path / "ck")
    faults.configure("step.dispatch:before=5:error")
    try:
        res = elastic.ElasticSupervisor(
            _elastic_build_on_card, d, mesh_axes=None, checkpoint_every=2,
            keep_last=99, backoff_base=0.0,
            log=elastic.RecoveryLog()).run(lambda i: host[i], 8)
    finally:
        faults.reset()
    assert [(e["cause"], e["restored_step"]) for e in res.events] == \
        [("transient", 4)]
    net, trainer, lb = _elastic_build_on_card()
    TrainCheckpointManager(d, keep_last=99).restore_step(4, trainer=trainer,
                                                         net=net)
    loop = TrainLoop(net, trainer, lb)
    ref = {i: float(loop.step(*host[i]).detach().double().sum())
           for i in range(4, 8)}
    for i in range(4, 8):
        assert res.losses[i] == ref[i]


def _overlap_rank_on_card(bucket_bytes):
    import os
    from mxnet_tpu_torch.gluon import Trainer, TrainLoop
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import dist, make_mesh
    out = {}
    for bb in bucket_bytes:
        os.environ["MXNET_ZERO_BUCKET_BYTES"] = str(bb)
        os.environ["MXNET_ZERO_SHARD_MIN_SIZE"] = "1"
        net = _mlp_on(dist.device())
        with make_mesh({"dp": dist.size()}):
            loop = TrainLoop(net, Trainer(dict(net.named_parameters()),
                                          "adam", {"learning_rate": 1e-2}),
                             SoftmaxCrossEntropyLoss())
            losses = [loop.step(x, y).cpu() for x, y in _host_batches(4)]
            loop.synchronize()
        out[bb] = (losses, [p.detach().cpu() for p in net.parameters()],
                   loop.compiled_step.buckets, loop.compiled_step.zero_trace)
    return out


@pytest.mark.cuda
def test_overlapped_zero_step_bit_equal_to_serial_on_cards(cuda_dev):
    """Two cards over NCCL, an MLP with one unit a bucket against one
    bucket: the reduce-scatter's exchange and rank-ordered sum make every
    bucketing train bit for bit alike; bucket 0 leaves before the last
    gradient arrives."""
    from mxnet_tpu_torch.parallel import dist
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    ranks = dist.spawn(_overlap_rank_on_card, 2, "cuda", ((0, 64),),
                       timeout_s=300)
    for r in ranks:
        (ls, ws, bs, _), (lo, wo, bo, trace) = r[0], r[64]
        assert len(bs) == 1 and len(bo) == 4
        for a, b in zip(ls + ws, lo + wo):
            assert torch.equal(a, b)
        last_grad = max(i for i, (e, _) in enumerate(trace) if e == "grad")
        assert trace.index(("reduce_scatter", 0)) < last_grad


# ---------------------------------------------------------------------------
# the one-card compile_step: one captured CUDA graph a batch signature
# ---------------------------------------------------------------------------

def _dense_on(dev, seed=3):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    net = _mlp_on(dev, seed)
    r = onp.random.RandomState(seed + 1)
    x = torch.from_numpy(r.randn(64, 64).astype("f4")).to(dev)
    y = torch.from_numpy(r.randint(0, 3, (64,)).astype("f4")).to(dev)
    return net, SoftmaxCrossEntropyLoss(), x, y


def _lstm_on(dev, seed=3):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import WordLM
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params
    net = WordLM(50, 32, 32, 2, device=dev)
    load_jax_params(net, init_params_numpy(net, seed))
    r = onp.random.RandomState(seed + 1)
    x = torch.from_numpy(r.randint(0, 50, (8, 7))).to(dev)
    y = torch.from_numpy(r.randint(0, 50, (8, 7)).astype("f4")).to(dev)
    return net, SoftmaxCrossEntropyLoss(), x, y


def _compiled(net, lb, opt="adam", kw=None):
    from mxnet_tpu_torch.gluon import Trainer
    tr = Trainer(dict(net.named_parameters()), opt,
                 dict(kw or {"learning_rate": 1e-2}))
    return tr, tr.compile_step(lambda a, b: lb(net(a), b))


def _body_call(step, x, y):
    """One call of the step's body run eagerly, no graph (the staging a
    call does, then the body)."""
    n = len(step._drawers)
    prog, key = step._fused_program((x, y), {}, None, advance=True)
    out = prog.body(*prog.inputs)
    step._settle_key(n, *key)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["dense", "lstm"])
def test_captured_step_replays_equal_the_eager_body_on_card(cuda_dev,
                                                            model):
    """Every kernel of these models is deterministic: four replays give
    the weights and losses of the step's body run eagerly four times
    from the same state, bit for bit; one capture."""
    make = _dense_on if model == "dense" else _lstm_on
    opt, kw = ("adam", None) if model == "dense" else \
        ("sgd", {"learning_rate": 0.5, "momentum": 0.9})
    runs = []
    for eager in (False, True):
        net, lb, x, y = make(cuda_dev)
        tr, step = _compiled(net, lb, opt, kw)
        step.aot_compile(x, y)
        losses = [(_body_call(step, x, y) if eager else step(x, y)).cpu()
                  for _ in range(4)]
        assert step.mode == "fused" and step.n_traces == 1
        runs.append((losses, [p.detach().cpu() for p in net.parameters()]))
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_lr_zero_leaves_the_weights_alone_in_replay_on_card(cuda_dev):
    """lr is read from the device block at each replay: set to 0 between
    steps, the replayed Adam step changes no weight; set back, it does."""
    net, lb, x, y = _dense_on(cuda_dev)
    tr, step = _compiled(net, lb)
    step(x, y)
    step(x, y)
    before = [p.detach().clone() for p in net.parameters()]
    tr.learning_rate = 0.0
    step(x, y)
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))
    tr.learning_rate = 1e-2
    step(x, y)
    assert not any(torch.equal(a, b)
                   for a, b in zip(before, net.parameters()))
    assert step.n_traces == 1


@pytest.mark.cuda
def test_adam_t_advances_across_replays_on_card(cuda_dev):
    """Adam's bias correction reads t from the device block. A loss
    linear in the weight gives the same gradient g every step, so with t
    1, 2, 3 each bias-corrected step moves the weight by lr g / (|g| +
    eps), three of them in three replays; a t frozen at 1 would move it
    by ~1.34 lr at step 2. The block holds t 3 after them."""
    from mxnet_tpu_torch.gluon import Trainer
    w = torch.nn.Parameter(torch.zeros(1000, device=cuda_dev))
    sign = (torch.arange(1000, device=cuda_dev) % 2 * 2 - 1).float()
    x = (sign * 0.5).repeat(4, 1)
    tr = Trainer([w], "adam", {"learning_rate": 0.05})
    step = tr.compile_step(lambda a: (w * a).sum(-1))
    for _ in range(3):
        step(x)
    assert step.n_traces == 1
    assert step._hp.t.cpu().tolist() == [3]
    g = x.mean(0).double()
    expect = -3 * 0.05 * g / (g.abs() + 1e-8)
    torch.testing.assert_close(w.detach().double(), expect, rtol=1e-5,
                               atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("explicit", [False, True])
def test_dropout_masks_differ_between_replays_and_equal_the_body_on_card(
        cuda_dev, explicit):
    """Dropout drawing from an explicit CUDA generator (registered with
    the graph) or from the default one: at lr 0 only the masks move the
    loss, which differs from replay to replay, and equals the eager
    body's from the same generator state, replay k to call k."""
    from mxnet_tpu_torch.gluon.nn import Dropout
    runs = []
    for eager in (False, True):
        net, lb, x, y = _dense_on(cuda_dev)
        gen = torch.Generator(device=cuda_dev).manual_seed(7) if explicit \
            else None
        torch.cuda.manual_seed(7)
        net = torch.nn.Sequential(net[0], Dropout(0.5, generator=gen),
                                  net[1])
        tr, step = _compiled(net, lb, "adam", {"learning_rate": 0.0})
        step.aot_compile(x, y)
        losses = [(_body_call(step, x, y) if eager else step(x, y)).cpu()
                  for _ in range(3)]
        assert step.n_traces == 1
        runs.append(losses)
    assert not torch.equal(runs[0][0], runs[0][1])
    assert not torch.equal(runs[0][1], runs[0][2])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_new_state_tensors_after_load_states_capture_again_on_card(
        cuda_dev, tmp_path):
    """load_states of a states file puts new tensors in place of the
    optimizer states the graph reads: the next call captures again (and
    says why), and training goes on bit for bit as without the reload."""
    runs = []
    for reload in (False, True):
        net, lb, x, y = _dense_on(cuda_dev)
        tr, step = _compiled(net, lb)
        step(x, y)
        step(x, y)
        if reload:
            f = str(tmp_path / "states")
            tr.save_states(f)
            tr.load_states(f)
        step(x, y)
        assert step.n_traces == (2 if reload else 1)
        if reload:
            assert "moved" in step.explain_retrace()
        runs.append([p.detach().cpu() for p in net.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["dense", "lstm"])
def test_captured_step_launches_counted_once_a_replay_on_card(cuda_dev,
                                                              model):
    """The capture records every launch on its stream, the backward's on
    autograd's thread too; each replay counts them once."""
    net, lb, x, y = (_dense_on if model == "dense" else _lstm_on)(cuda_dev)
    tr, step = _compiled(net, lb)
    step.aot_compile(x, y)
    K.reset_launch_counts()
    for _ in range(3):
        step(x, y)
    torch.cuda.synchronize()
    got = {k: v for k, v in K.launch_counts().items() if v}
    expect = {"opt_update": 3}          # one launch a step
    if model == "lstm":
        expect.update(rnn_scan_fwd=6, rnn_scan_bwd=6)
    assert got == expect
    assert tr.optimizer.num_update == 3 and step.n_traces == 1


def _syncing_loss(net, lb, sync_rows=None):
    """A loss that reads a number back to the host (``.item()``), which
    no CUDA graph can capture: always, or only for a batch of
    ``sync_rows`` rows."""
    def loss_fn(a, b):
        out = net(a)
        if sync_rows is None or a.shape[0] == sync_rows:
            _ = float(out.sum().item())
        return lb(out, b)
    return loss_fn


@pytest.mark.cuda
@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-2})])
def test_failed_first_capture_falls_back_to_eager_on_card(cuda_dev, opt,
                                                          kw):
    """The first call's capture fails: the step runs eagerly from then
    on, as the JAX package's first failed trace does. Three calls equal
    three eager steps bit for bit (the same kernels), the dropout masks
    included (the generator the warm-up and the failed capture drew from
    is put back), and Adam's first real step has t = 1: the counts are
    3 after three calls."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.nn import Dropout
    runs = []
    for compiled in (True, False):
        net, lb, x, y = _dense_on(cuda_dev)
        net = torch.nn.Sequential(net[0], Dropout(0.1), net[1])
        tr = Trainer(dict(net.named_parameters()), opt, dict(kw))
        loss_fn = _syncing_loss(net, lb)
        torch.cuda.manual_seed(11)
        if compiled:
            step = tr.compile_step(loss_fn)
            losses = [step(x, y).cpu() for _ in range(3)]
            assert step.mode == "eager" and step.n_traces == 0
        else:
            losses = []
            for _ in range(3):
                loss = loss_fn(x, y)
                loss.sum().backward()
                tr.step(x.shape[0])
                losses.append(loss.detach().cpu())
        assert tr.optimizer._index_update_count == {i: 3 for i in range(4)}
        runs.append(losses + [p.detach().cpu() for p in net.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_later_capture_failure_raises_on_card(cuda_dev):
    """Once a program ran, a capture that fails (a new batch signature
    whose loss syncs) raises, updates nothing and counts nothing; the
    step stays captured and replays its first signature."""
    net, lb, x, y = _dense_on(cuda_dev)
    tr, _ = _compiled(net, lb)
    step = tr.compile_step(_syncing_loss(net, lb, sync_rows=32))
    step(x, y)
    step(x, y)
    assert step.mode == "fused" and step.n_traces == 1
    before = [p.detach().clone() for p in net.parameters()]
    counts = dict(tr.optimizer._index_update_count)
    with pytest.raises(mxt.MXNetError, match="capture of"):
        step(x[:32], y[:32])
    assert step.mode == "fused" and step.n_traces == 1
    assert tr.optimizer._index_update_count == counts
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))
    step(x, y)
    assert tr.optimizer.num_update == 3
    assert not any(torch.equal(a, b)
                   for a, b in zip(before, net.parameters()))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_a_failed_update_capture_raises_on_card(cuda_dev, monkeypatch,
                                                split):
    """The first call's capture of the update fails (the ``opt_update``
    wrapper raises inside the capture, as a kernel that does not build or
    launch would): the step raises ``MXNetError`` and does not fall back
    to the eager step, which would not run that kernel; nothing is
    updated or counted and the mode stays fused, in the one-graph program
    and in the split program's update graph. With the wrapper back the
    next call captures and is the first step."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.kvstore import KVStoreDist
    from mxnet_tpu_torch.ops.kernels import opt_update as topu
    net, lb, x, y = _dense_on(cuda_dev)
    kv = KVStoreDist("dist_sync")
    kv._force_fuse = split
    tr = Trainer(dict(net.named_parameters()), "adam",
                 {"learning_rate": 1e-2}, kvstore=kv)
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    before = [p.detach().clone() for p in net.parameters()]
    captured = []

    def launch_fails(*a, **k):
        captured.append(torch.cuda.is_current_stream_capturing())
        raise RuntimeError("opt_update: the kernel did not launch")

    with monkeypatch.context() as m:
        m.setattr(topu, "multi_update", launch_fails)
        with pytest.raises(mxt.MXNetError, match="did not launch"):
            step(x, y)
    assert captured == [True]
    assert step.mode == "fused" and step._split is split
    assert tr.optimizer._index_update_count == {}
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))
    step(x, y)
    assert tr.optimizer.num_update == 1
    assert not any(torch.equal(a, b)
                   for a, b in zip(before, net.parameters()))


@pytest.mark.cuda
def test_split_program_two_graphs_equal_the_fused_step_on_card(cuda_dev):
    """A dist store that cannot reduce in-program (``_force_fuse`` in one
    process) takes the split program: two graphs (gradients, update),
    the store's ``pushpull_list`` between them, one ``opt_update`` a
    step; its weights and losses equal the one-graph fused
    step's bit for bit (every kernel here is deterministic, and one
    process's sum is the gradient itself)."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.kvstore import KVStoreDist
    runs = []
    for split in (True, False):
        net, lb, x, y = _dense_on(cuda_dev)
        kv = KVStoreDist("dist_sync")
        kv._force_fuse = split
        tr = Trainer(dict(net.named_parameters()), "adam",
                     {"learning_rate": 1e-2}, kvstore=kv)
        step = tr.compile_step(lambda a, b: lb(net(a), b))
        step.aot_compile(x, y)
        K.reset_launch_counts()
        losses = [step(x, y).cpu() for _ in range(3)]
        torch.cuda.synchronize()
        assert step.mode == "fused" and step._split is split
        assert len(step._programs) == (2 if split else 1)
        assert K.launch_counts()["opt_update"] == 3   # one a step
        assert step.n_traces == 1 and kv.stats["collectives"] == 0
        runs.append(losses + [p.detach().cpu() for p in net.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


_FIRST_LAUNCH_IN_CAPTURE = """
import os, sys
import torch
sys.path.insert(0, sys.argv[1])
import test_torch_cuda as T
from mxnet_tpu_torch.ops import kernels as K
dev = torch.device("cuda:0")
runs = []
for eager in (False, True):
    net, lb, x, y = T._dense_on(dev)
    tr, step = T._compiled(net, lb, sys.argv[2])
    if not eager:
        step.aot_compile(x, y)
        assert K.launch_counts()["opt_update"] == 0
    losses = [(T._body_call(step, x, y) if eager else step(x, y)).cpu()
              for _ in range(3)]
    runs.append(losses + [p.detach().cpu() for p in net.parameters()])
assert all(torch.equal(a, b) for a, b in zip(*runs))
print("module loading", os.environ.get("CUDA_MODULE_LOADING"))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_first_update_launch_inside_a_capture_on_card(cuda_dev, opt):
    """The capture's warm-up skips the update, so in a fresh process the
    update's kernels (``opt_update`` for Adam; PyTorch's elementwise ops
    for AdamW) are first launched inside the capture, where lazy module
    loading has to load them. Three replays equal three eager body runs
    made after them, bit for bit."""
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-c", _FIRST_LAUNCH_IN_CAPTURE,
                          here, opt], capture_output=True, text=True,
                         timeout=600, cwd=os.path.dirname(here))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "module loading" in res.stdout


# ---------------------------------------------------------------------------
# the convolutional path: ResNet-18 (thumbnail) through compile_step
# ---------------------------------------------------------------------------

def _resnet_on(dev, seed=5):
    """resnet18_v1 (thumbnail, 10 classes) with seeded weights on ``dev``,
    its loss and a batch of 8 32 x 32 images."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    net = resnet18_v1(classes=10, thumbnail=True, device=dev,
                      generator=torch.Generator().manual_seed(seed))
    r = onp.random.RandomState(seed + 1)
    x = torch.from_numpy(r.uniform(size=(8, 3, 32, 32)).astype("f4")).to(dev)
    y = torch.from_numpy(r.randint(0, 10, (8,)).astype("f4")).to(dev)
    return net, SoftmaxCrossEntropyLoss(), x, y


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (its backward-filter defaults may
    sum with atomics), so two runs of the same step are bit-equal."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = old


def _stats(net):
    return [p.detach().clone() for n, p in net.named_parameters()
            if "running" in n]


@pytest.mark.cuda
def test_captured_resnet_step_first_replay_equals_first_eager_step_on_card(
        cuda_dev, deterministic_cudnn):
    """The capture's two warm-up runs of the forward write BatchNorm's
    running statistics; the warm-up puts them back, so after
    ``aot_compile`` they are as they were, and the first replay equals
    the step's body run once eagerly from the same state: loss, weights
    and running statistics bit for bit. Two more replays equal two more
    body runs."""
    sgd = {"learning_rate": 0.1, "momentum": 0.9}
    runs = []
    for eager in (False, True):
        net, lb, x, y = _resnet_on(cuda_dev)
        before = _stats(net)
        tr, step = _compiled(net, lb, "sgd", sgd)
        step.aot_compile(x, y)
        assert all(torch.equal(a, b) for a, b in zip(before, _stats(net)))
        losses = [(_body_call(step, x, y) if eager else step(x, y)).cpu()
                  for _ in range(3)]
        assert step.mode == "fused" and step.n_traces == 1
        assert not any(torch.equal(a, b)
                       for a, b in zip(before, _stats(net)))
        runs.append(losses + [p.detach().cpu() for p in net.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_resnet_eval_mode_captures_again_on_card(cuda_dev):
    """``net.eval()`` between steps: the next call captures a program of
    its own (BatchNorm's mode is part of the signature), which writes no
    running statistic; ``net.train()`` replays the first program again,
    which writes them."""
    net, lb, x, y = _resnet_on(cuda_dev)
    tr, step = _compiled(net, lb, "sgd", {"learning_rate": 0.05,
                                          "momentum": 0.9})
    step(x, y)
    assert step.n_traces == 1
    net.eval()
    before = _stats(net)
    step(x, y)
    assert step.n_traces == 2
    assert "train_mode changed" in step.explain_retrace()
    assert all(torch.equal(a, b) for a, b in zip(before, _stats(net)))
    net.train()
    step(x, y)
    assert step.n_traces == 2
    assert not any(torch.equal(a, b) for a, b in zip(before, _stats(net)))


@pytest.mark.cuda
def test_resnet_step_launches_one_opt_update_a_step_on_card(cuda_dev):
    """One replayed ResNet-18 step launches exactly one ``opt_update``, for
    all 60 trainable parameters (the 38 running statistics are not
    updated), and no other kernel of the library (convolutions, pooling
    and BatchNorm are cuDNN's)."""
    net, lb, x, y = _resnet_on(cuda_dev)
    tr, step = _compiled(net, lb, "sgd", {"learning_rate": 0.05,
                                          "momentum": 0.9})
    step.aot_compile(x, y)
    K.reset_launch_counts()
    step(x, y)
    torch.cuda.synchronize()
    assert len(tr._params) == 60
    assert {k: v for k, v in K.launch_counts().items() if v} == \
        {"opt_update": 1}


# ---------------------------------------------------------------------------
# training's surface: every optimizer captured, metrics without a sync,
# initialize under a captured predictor
# ---------------------------------------------------------------------------

#: each registered rule with a setting other than its default where it
#: has one
SURFACE_OPTS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("signum", {"learning_rate": 1e-3, "momentum": 0.0}),
    ("sgld", {"learning_rate": 1e-4}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-2, "wd": 1e-3}),
    ("adamw", {"learning_rate": 1e-2, "wd": 1e-2}),
    ("adabelief", {"learning_rate": 1e-3}),
    ("adamax", {"learning_rate": 2e-3, "beta2": 0.99}),
    ("nadam", {"learning_rate": 1e-3, "schedule_decay": 0.01}),
    ("adagrad", {"learning_rate": 1e-2, "wd": 1e-3}),
    ("groupadagrad", {"learning_rate": 1e-2}),
    ("adadelta", {"rho": 0.95}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True,
                 "clip_weights": 2.0}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 1e-3}),
    ("ftml", {"learning_rate": 2.5e-3}),
    ("lars", {"learning_rate": 0.1, "eta": 0.01, "wd": 1e-4}),
    ("lamb", {"learning_rate": 1e-3, "wd": 0.01, "lower_bound": 1e-3,
              "upper_bound": 10.0}),
    ("lans", {"learning_rate": 1e-3, "wd": 0.01}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("opt,kw", SURFACE_OPTS,
                         ids=[o for o, _ in SURFACE_OPTS])
def test_every_optimizer_captured_equals_its_eager_twin_on_card(cuda_dev,
                                                                 opt, kw):
    """Three replays of the captured step against three eager
    ``Trainer.step``s from the same weights (SGLD from the same generator
    state): the same rule on the same device scalars, so the weights
    agree to float32 rounding of the products (1e-5 relative, 1e-6
    absolute), SGLD's noise included; ``opt_update`` launches for exact
    SGD / Adam only (one a step), every other rule none."""
    from mxnet_tpu_torch.gluon import Trainer
    runs = []
    for captured in (True, False):
        net, lb, x, y = _dense_on(cuda_dev)
        kwargs = dict(kw)
        if opt == "sgld":
            kwargs["generator"] = torch.Generator(cuda_dev).manual_seed(8)
        tr = Trainer(dict(net.named_parameters()), opt, kwargs)
        step = tr.compile_step(lambda a, b: lb(net(a), b))
        if captured:
            step.aot_compile(x, y)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        for _ in range(3):
            if captured:
                step(x, y)
            else:
                lb(net(x), y).sum().backward()
                tr.step(x.shape[0])
        torch.cuda.synchronize()
        if captured:
            assert step.mode == "fused" and step.n_traces == 1
        launches = K.launch_counts()["opt_update"]
        assert launches == (3 if opt in ("sgd", "adam") else 0), launches
        runs.append([p.detach().clone() for p in net.parameters()])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_sgld_replays_draw_new_noise_from_a_registered_generator_on_card(
        cuda_dev):
    """SGLD's generator is registered with the captured step: at lr
    1e-2 the noise (std 0.1) dwarfs the half gradient step, and three
    replays move the weights by three different draws of it."""
    from mxnet_tpu_torch.gluon import Trainer
    net, lb, x, y = _dense_on(cuda_dev)
    g = torch.Generator(cuda_dev).manual_seed(2)
    tr = Trainer(dict(net.named_parameters()), "sgld",
                 {"learning_rate": 1e-2, "generator": g})
    step = tr.compile_step(lambda a, b: lb(net(a), b))
    step.aot_compile(x, y)
    moves, w = [], net[0].weight
    for _ in range(3):
        before = w.detach().clone()
        step(x, y)
        moves.append(w.detach() - before)
    assert not torch.equal(moves[0], moves[1])
    assert not torch.equal(moves[1], moves[2])
    for m in moves:
        assert 0.05 < float(m.std()) < 0.15          # ~sqrt(1e-2)
    assert step.n_traces == 1


@pytest.mark.cuda
def test_metric_updates_on_card_never_sync(cuda_dev):
    """Every device-path metric takes CUDA tensors under
    ``set_sync_debug_mode("error")`` (any sync raises) and, read after,
    equals the same metric fed numpy copies within 1e-5 relative."""
    from mxnet_tpu_torch import metric
    r = onp.random.RandomState(3)
    logits = torch.from_numpy(r.randn(64, 10).astype("f4"))
    probs = torch.softmax(logits, -1)
    labels = torch.from_numpy(r.randint(0, 10, 64).astype("f4"))
    binary = torch.from_numpy(r.randint(0, 2, 64).astype("f4"))
    reg = torch.from_numpy(r.randn(64, 3).astype("f4"))
    cases = [(metric.Accuracy(), labels, probs),
             (metric.TopKAccuracy(5), labels, logits),
             (metric.CrossEntropy(), labels, probs),
             (metric.NegativeLogLikelihood(), labels, probs),
             (metric.Perplexity(), labels, probs),
             (metric.MAE(), reg, reg * 0.5), (metric.MSE(), reg, reg * 0.5),
             (metric.RMSE(), reg, reg * 0.5),
             (metric.F1(), binary, probs[:, :2]),
             (metric.Fbeta(beta=2.0), binary, probs[:, :2]),
             (metric.MCC(), binary, probs[:, :2]),
             (metric.BinaryAccuracy(), binary, probs[:, 0]),
             (metric.MeanPairwiseDistance(), reg, reg * 0.5),
             (metric.MeanCosineSimilarity(), reg, reg + 0.3),
             (metric.Loss(), None, probs[:, 0])]
    on_card = [(m, None if l is None else l.to(cuda_dev), p.to(cuda_dev))
               for m, l, p in cases]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for m, l, p in on_card:
            for _ in range(2):
                m.update(l, p)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for (m, l, p), (mc, _, _) in zip(cases, on_card):
        ref = type(m)(**({"top_k": 5} if isinstance(m, metric.TopKAccuracy)
                         else {"beta": 2.0} if isinstance(m, metric.Fbeta)
                         else {}))
        for _ in range(2):
            ref.update(None if l is None else l.numpy(), p.numpy())
        assert mc.get()[1] == pytest.approx(ref.get()[1], rel=1e-5,
                                            abs=1e-6), type(m).__name__


@pytest.mark.cuda
def test_initialize_force_reinit_under_a_captured_predictor_on_card(
        cuda_dev):
    """``initialize(net, ..., force_reinit=True)`` writes the parameters
    in place: a ``CompiledPredictor`` captured before replays on the new
    weights, bit-equal to the eager net, with no new capture."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon import initialize
    from mxnet_tpu_torch.serving import CompiledPredictor
    net = _mlp_on(cuda_dev).eval()
    pred = CompiledPredictor(net, bucket_sizes=(8,), device=cuda_dev)
    x = torch.randn(8, 64, device=cuda_dev)
    first = pred.predict(x).clone()
    assert pred.n_traces == 1
    initialize(net, initializer.MSRAPrelu(), force_reinit=True,
               generator=torch.Generator(cuda_dev).manual_seed(4))
    got = pred.predict(x)
    with torch.no_grad():
        eager = net(x)
    assert pred.n_traces == 1
    assert torch.equal(got, eager) and not torch.equal(got, first)


def _cell_lm_on(dev, seed=3, zoneout=False):
    """A word LM of cells (vocab 50, H 32): Embedding, two LSTMCells
    each unrolled over the merged NTC batch (with ``zoneout``: the
    second wrapped in a ZoneoutCell, drawing from a CUDA generator, the
    loss resetting it first), a Dense head."""
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon import rnn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.params import init_params_numpy, \
        load_jax_params

    class CellLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = gnn.Embedding(50, 32, device=dev)
            self.l0 = rnn.LSTMCell(32, input_size=32, device=dev)
            self.l1 = rnn.LSTMCell(32, input_size=32, device=dev)
            if zoneout:
                self.l1 = rnn.ZoneoutCell(
                    self.l1, 0.2, 0.2,
                    generator=torch.Generator(dev).manual_seed(seed))
            self.head = gnn.Dense(50, flatten=False, in_units=32,
                                  device=dev)

        def forward(self, x):
            self.l1.reset()
            h, _ = self.l0.unroll(x.shape[1], self.emb(x),
                                  merge_outputs=True)
            h, _ = self.l1.unroll(x.shape[1], h, merge_outputs=True)
            return self.head(h)

    net = CellLM()
    load_jax_params(net, init_params_numpy(net, seed))
    r = onp.random.RandomState(seed + 1)
    x = torch.from_numpy(r.randint(0, 50, (8, 7))).to(dev)
    y = torch.from_numpy(r.randint(0, 50, (8, 7)).astype("f4")).to(dev)
    return net, SoftmaxCrossEntropyLoss(), x, y


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_cell_unroll_launches_one_scan_each_way_on_card(cuda_dev, mode):
    """A plain gated cell unrolled over a merged batch: one rnn_scan_fwd
    launch, and one rnn_scan_bwd in its backward; outputs and the input
    gradient against a CPU copy of the cell (2e-4)."""
    from mxnet_tpu_torch.gluon import rnn
    from mxnet_tpu_torch.gluon.params import load_jax_params

    def make(dev):
        if mode == "lstm":
            return rnn.LSTMCell(48, input_size=24, device=dev)
        if mode == "gru":
            return rnn.GRUCell(48, input_size=24, device=dev)
        return rnn.RNNCell(48, activation=mode[4:], input_size=24,
                           device=dev)

    cell = make(cuda_dev)
    cpu = make("cpu")
    load_jax_params(cpu, {k: p.detach().cpu().numpy()
                          for k, p in cell.named_parameters()})
    x = torch.randn(5, 9, 24)
    outs = []
    for c, dev in ((cell, cuda_dev), (cpu, torch.device("cpu"))):
        xd = x.to(dev).requires_grad_()
        K.reset_launch_counts()
        y, _ = c.unroll(9, xd, merge_outputs=True)
        fwd = dict(K.launch_counts())
        y.sum().backward()
        bwd = dict(K.launch_counts())
        outs.append((y.detach().cpu(), xd.grad.cpu(), fwd, bwd))
    assert outs[0][2]["rnn_scan_fwd"] == 1 and outs[0][2]["rnn_scan_bwd"] == 0
    assert outs[0][3]["rnn_scan_bwd"] == 1
    assert sum(outs[1][3].values()) == 0
    for a, b in zip(outs[0][:2], outs[1][:2]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cell_subclass_takes_the_loop_with_no_launch_on_card(cuda_dev):
    from mxnet_tpu_torch.gluon import rnn

    class MyLSTM(rnn.LSTMCell):
        pass

    cell = MyLSTM(32, input_size=16, device=cuda_dev)
    x = torch.randn(4, 6, 16, device=cuda_dev, requires_grad=True)
    K.reset_launch_counts()
    y, _ = cell.unroll(6, x, merge_outputs=True)
    y.sum().backward()
    assert sum(K.launch_counts().values()) == 0
    fused = rnn.LSTMCell(32, input_size=16, device=cuda_dev)
    fused.load_state_dict(cell.state_dict())
    y2, _ = fused.unroll(6, x, merge_outputs=True)
    torch.testing.assert_close(y2, y, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("zoneout", [False, True])
def test_captured_cell_lm_step_equals_eager_on_card(cuda_dev, zoneout):
    """A cell-built word LM through compile_step: four replays equal the
    step's body run eagerly four times from the same state, bit for bit
    (with a ZoneoutCell reset by the forward: its masks drawn anew each
    replay from the registered generator), one capture; per step two
    rnn_scan_fwd and two rnn_scan_bwd launches (one with zoneout: its
    LSTMCell steps through the loop)."""
    runs = []
    for eager in (False, True):
        net, lb, x, y = _cell_lm_on(cuda_dev, zoneout=zoneout)
        tr, step = _compiled(net, lb, "sgd",
                             {"learning_rate": 0.5, "momentum": 0.9})
        step.aot_compile(x, y)
        K.reset_launch_counts()
        losses = [(_body_call(step, x, y) if eager else step(x, y)).cpu()
                  for _ in range(4)]
        counts = K.launch_counts()
        assert step.mode == "fused" and step.n_traces == 1
        n = 1 if zoneout else 2
        assert counts["rnn_scan_fwd"] == counts["rnn_scan_bwd"] == 4 * n
        runs.append((losses, [p.detach().cpu() for p in net.parameters()]))
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [0, 3])
def test_dataloader_stages_batches_on_card(cuda_dev, workers):
    """``DataLoader(device=...)``: every staged batch on the card equal
    to the host loader's, pinned host batches with ``pin_memory``, the
    prefetcher's stats counted."""
    from mxnet_tpu_torch.gluon import data as gdata
    r = onp.random.RandomState(3)
    ds = gdata.ArrayDataset(r.uniform(size=(37, 3, 8, 8)).astype("f4"),
                            r.randint(0, 9, 37))
    host = list(gdata.DataLoader(ds, 8, last_batch="keep"))
    card = gdata.DataLoader(ds, 8, num_workers=workers, device=cuda_dev,
                            prefetch_to_device=2)
    got = list(card)
    assert len(got) == len(host) == 5
    for (x, y), (hx, hy) in zip(got, host):
        assert x.device == cuda_dev and y.device == cuda_dev
        assert torch.equal(x.cpu(), hx) and torch.equal(y.cpu(), hy)
    assert card.device_prefetch_stats["prefetch_batches"] == 5
    pinned = next(iter(gdata.DataLoader(ds, 8, num_workers=workers,
                                        pin_memory=True)))
    assert all(t.is_pinned() for t in pinned)


@pytest.mark.cuda
def test_clip_global_norm_on_card(cuda_dev):
    """``clip_global_norm`` over card tensors: the total within 1e-6 of a
    float64 norm on the CPU, the arrays scaled in place to the bound."""
    from mxnet_tpu_torch.gluon import clip_global_norm
    r = onp.random.RandomState(4)
    host = [r.standard_normal(s).astype("f4")
            for s in ((1000, 33), (77,), (5, 6, 7))]
    arrs = [torch.from_numpy(a).to(cuda_dev) for a in host]
    ref = onp.sqrt(sum((a.astype("f8") ** 2).sum() for a in host))
    total = clip_global_norm(arrs, 10.0)
    assert isinstance(total, float) and abs(total - ref) <= 1e-6 * ref
    after = onp.sqrt(sum((a.double() ** 2).sum().item() for a in arrs))
    assert after <= 10.0 * (1 + 1e-6)
    for a, h in zip(arrs, host):
        torch.testing.assert_close(a.cpu(), torch.from_numpy(h) * (10.0 / (
            ref + 1e-8)), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# telemetry on the card (telemetry/, numerics, memory)
# ---------------------------------------------------------------------------

def _tele_mlp(dev, seed=0):
    from mxnet_tpu_torch.gluon.nn import Dense
    torch.manual_seed(seed)
    return torch.nn.Sequential(Dense(64, in_units=32, activation="relu",
                                     device=dev),
                               Dense(8, in_units=64, device=dev))


@pytest.mark.cuda
def test_captured_numerics_bit_equal_and_norms_vs_float64(cuda_dev):
    """The captured step with numerics on: losses and weights bit-equal
    to numerics off after three Adam steps, one capture, the grad and
    param norms within 1e-5 of a float64 ``vector_norm`` of the same
    step's gradients (an eager backward from the same weights) and
    weights, the update norm of the weights' float64 difference."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon import loss as gloss
    r = onp.random.RandomState(0)
    x = torch.from_numpy(r.randn(16, 32).astype("f4")).to(cuda_dev)
    y = torch.from_numpy(r.randint(0, 8, 16).astype("f4")).to(cuda_dev)
    lb = gloss.SoftmaxCrossEntropyLoss()
    runs = {}
    for mode in (None, "global", "per_layer"):
        net = _tele_mlp(cuda_dev)
        tr = Trainer(dict(net.named_parameters()), "adam",
                     {"learning_rate": 0.01})
        step = tr.compile_step(lambda a, b: lb(net(a), b), numerics=mode)
        out = []
        for _ in range(3):
            before = [p.detach().double().clone() for p in net.parameters()]
            loss = step(x, y)
            vals = step.numerics_values()
            out.append((loss, before, vals))
        runs[mode] = (net, out, step)
    ref_net, ref_out, _ = runs[None]
    for mode in ("global", "per_layer"):
        net, out, step = runs[mode]
        assert step.n_traces == 1
        for (l, _, _), (rl, _, _) in zip(out, ref_out):
            assert torch.equal(l, rl)
        for a, b in zip(net.parameters(), ref_net.parameters()):
            assert torch.equal(a, b)
        # step 3's statistics against float64 on the card
        _, before, vals = out[2]
        eager = _tele_mlp(cuda_dev)
        with torch.no_grad():
            for p, w in zip(eager.parameters(), before):
                p.copy_(w.float())
        g = torch.autograd.grad(lb(eager(x), y).sum(),
                                list(eager.parameters()))
        gn = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t.double()) for t in g])).item() / 16
        pn = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(w) for w in before])).item()
        un = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.double() - w)
             for p, w in zip(net.parameters(), before)])).item()
        assert abs(vals["grad_norm"] - gn) <= 1e-5 * gn
        assert abs(vals["param_norm"] - pn) <= 1e-5 * pn
        assert abs(vals["update_norm"] - un) <= 1e-5 * un
        assert vals["nonfinite_total"] == 0


@pytest.mark.cuda
def test_census_reconciles_with_the_allocator(cuda_dev):
    """Tensors filed in the census count at their ``numel * element_size``
    against ``torch.cuda.memory_allocated``; a KV cache's pools equal
    what the allocator gave them (sizes a multiple of its 512-byte
    blocks)."""
    from mxnet_tpu_torch.serving.kvcache import PagedKVCache
    from mxnet_tpu_torch.telemetry import memory as tmem
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_dev)
    kv = PagedKVCache(2, 4, 32, 17, 16, dtype="float32", device=cuda_dev)
    grown = torch.cuda.memory_allocated(cuda_dev) - before
    assert grown == kv.total_bytes() == \
        tmem.census().device_bytes_by_pool(cuda_dev)["kvcache"]
    rec = tmem.census().reconcile()
    dev = rec["devices"][str(cuda_dev)]
    assert dev["allocated"] == torch.cuda.memory_allocated(cuda_dev)
    assert dev["tracked"] >= kv.total_bytes()
    stats = tmem.device_memory_stats()[str(cuda_dev)]
    assert stats["source"] == "allocator" and stats["bytes_limit"] > 0


@pytest.mark.cuda
def test_oom_guard_records_one_anomaly_and_reraises(cuda_dev, tmp_path,
                                                    monkeypatch):
    from mxnet_tpu_torch import telemetry as ttel
    from mxnet_tpu_torch.telemetry import memory as tmem
    monkeypatch.setenv("MXNET_MEMORY_DUMP_DIR", str(tmp_path))
    ttel.reset()
    # past the free bytes and the allocator's cached ones: the whole card
    _, total = torch.cuda.mem_get_info(cuda_dev)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with tmem.oom_guard("outer"), tmem.oom_guard("inner"):
            torch.empty(int(total) + (1 << 30), dtype=torch.uint8,
                        device=cuda_dev)
    assert len(ttel.watchdog().anomalies("oom")) == 1
    assert len(list(tmp_path.glob("mx_oom_*.json"))) == 1
    torch.zeros(1, device=cuda_dev)       # the process carries on
    ttel.reset()


@pytest.mark.cuda
def test_kernel_dispatch_counter_counts_launches_and_replays(cuda_dev):
    from mxnet_tpu_torch import telemetry as ttel
    ttel.reset()
    x = torch.randn(64, 768, device=cuda_dev)
    g, b = torch.ones(768, device=cuda_dev), torch.zeros(768,
                                                         device=cuda_dev)
    KN.layer_norm(x, g, b, 1e-5)
    KN.layer_norm(x, g, b, 1e-5)
    assert ttel.value("mx_kernel_dispatch_total", "cuda") == 2
    assert ttel.value("mx_kernel_dispatch_total", "plain") in (None, 0.0)
    ttel.reset()


# ---------------------------------------------------------------------------
# the kernels.vmem_tile_budget tunable: every grid value, bit-identical
# ---------------------------------------------------------------------------

def _smem_cases(dev):
    """(name, fn) pairs at PERF.md section 6's shapes (rows 2, 5, 6, 8-11)
    and at shapes where a smaller budget moves the plan: each fn returns
    the kernel's outputs for fixed inputs, and the plan it launched."""
    g = torch.Generator().manual_seed(7)

    def t(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * s).to(dev, dtype)

    cases = []
    for rows, c in ((16384, 768), (2048, 16384), (1000, 6017)):
        x, gam, bet, dy = t(rows, c), t(c), t(c), t(rows, c)
        cases.append((f"layernorm_fwd {rows}x{c}", functools.partial(
            lambda x, gm, bt: ((KN.layer_norm(x, gm, bt, 1e-5),),
                               KN.ln_fwd_plan(*x.shape, x.dtype, x.device)),
            x, gam, bet)))
        cases.append((f"layernorm_bwd {rows}x{c}", functools.partial(
            lambda x, gm, dy: (KN.layer_norm_bwd(x, gm, dy, 1e-5),
                               KN.ln_bwd_plan(*x.shape, x.dtype, x.device)),
            x, gam, dy)))
    x, b, dy = t(4096, 3072), t(3072), t(4096, 3072)
    cases.append(("bias_gelu_bwd 4096x3072", lambda: (
        KN.bias_gelu_bwd(x, b, dy), KN.bg_bwd_plan(4096, 3072,
                                                   device=dev))))
    for mode, n_t, n, h in (("lstm", 35, 64, 650), ("lstm", 8, 64, 1024),
                            ("gru", 6, 130, 300)):
        xw, h0, c0, w, bb, dys, dct = _rnn_inputs(mode, n_t, n, h,
                                                  torch.float32, dev)

        def scan(xw=xw, h0=h0, c0=c0, w=w, bb=bb, dys=dys, dct=dct,
                 mode=mode, n=n, h=h):
            ys, cs = KR.rnn_scan_fwd(xw, h0, c0, w, bb, mode)
            grads = KR.rnn_scan_bwd(xw, h0, c0, w, bb, ys, cs, dys, dct,
                                    mode)
            plans = (KR.rnn_fwd_plan(n, h, mode, device=dev),
                     KR.rnn_bwd_walk_plan(n, h, mode, device=dev))
            return (ys, cs) + tuple(grads), plans
        cases.append((f"rnn_scan {mode} T{n_t} N{n} H{h}", scan))
    for n, h in ((8, 128), (128, 650), (8, 650)):
        xw, hh, cc, w, bb = _decode_inputs("lstm", n, h, torch.float32, dev)
        cases.append((f"rnn_decode N{n} H{h}", functools.partial(
            lambda *a: (KR.rnn_decode_step(*a, "lstm"),
                        KR.rnn_decode_plan(a[0].shape[0], a[1].shape[1],
                                           "lstm", device=a[0].device)),
            xw, hh, cc, w, bb)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("budget", K.SMEM_BUDGET_GRID[1:])
def test_smem_budget_grid_values_bit_identical_on_card(cuda_dev, budget):
    """Under every value of the kernels.vmem_tile_budget grid, the plans
    the budget feeds may change, the outputs may not: each kernel's
    outputs equal the default budget's bit for bit."""
    from mxnet_tpu_torch.tuning import space
    default = {"kernels.vmem_tile_budget": K.SMEM_TILE_BUDGET_BYTES}
    moved = []
    for name, fn in _smem_cases(cuda_dev):
        with space.trial(default):
            ref, ref_plan = fn()
        with space.trial({"kernels.vmem_tile_budget": budget}):
            got, plan = fn()
        torch.cuda.synchronize()
        if plan != ref_plan:
            moved.append(name)
        for a, r in zip(got, ref):
            assert (a is None) == (r is None), name
            if r is not None:
                assert torch.equal(a, r), f"{name} at budget {budget}"
    print(f"budget {budget}: plans moved for {moved}")


@pytest.mark.cuda
@pytest.mark.parametrize("budget", K.SMEM_BUDGET_GRID[1:])
def test_smem_budget_leaves_the_fused_flash_bwd_on_card(cuda_dev, budget):
    """Row 2 (the fused flash backward at BERT's 32 x 12 x 512 x 64): its
    tiles are fixed, so the budget moves nothing; dk and dv equal the
    default budget's bit for bit, dq (summed by float32 atomics, which
    repeat only within rounding) within the default's own spread over
    two runs, or 1e-6 where that spread is 0."""
    from mxnet_tpu_torch.tuning import space
    q, k, v, out, lse, do, causal = _bwd_inputs((32, 12, 512, 512, 64,
                                                 False), torch.float32,
                                                cuda_dev)
    with space.trial({"kernels.vmem_tile_budget":
                      K.SMEM_TILE_BUDGET_BYTES}):
        ref = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
        ref2 = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
    with space.trial({"kernels.vmem_tile_budget": budget}):
        got = ATT.flash_attention_bwd(q, k, v, out, lse, do, causal)
    spread = float((ref[0] - ref2[0]).abs().max())
    assert float((got[0] - ref[0]).abs().max()) <= max(2 * spread, 1e-6)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


# ---------------------------------------------------------------------------
# analysis/ on the card (phase 21a at a small size)
# ---------------------------------------------------------------------------

def _small_bert_step(dev, analyze=None):
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
    torch.manual_seed(0)
    net = tbert.BERTClassifier(tbert.bert_small_test(dropout=0.1,
                                                     device=dev),
                               num_classes=3, dropout=0.1, device=dev)
    tr = Trainer(dict(net.named_parameters()), "adam",
                 {"learning_rate": 1e-3})
    lb = SoftmaxCrossEntropyLoss()
    step = tr.compile_step(lambda a, b: lb(net(a), b), analyze=analyze)
    rs = onp.random.RandomState(1)
    x = torch.from_numpy(rs.randint(0, 100, (4, 32))).to(dev)
    y = torch.from_numpy(rs.randint(0, 3, (4,)).astype("f4")).to(dev)
    return net, tr, step, x, y


@pytest.mark.cuda
def test_analyze_leaves_the_state_bit_equal_on_card(cuda_dev):
    """``analyze()`` of a captured step: weights, Adam states, counts,
    the card's generator and ``n_traces`` as before; the report clean;
    the record's hand-written kernels, one node a launch, are what a
    step launches."""
    net, tr, step, x, y = _small_bert_step(cuda_dev, analyze="raise")
    step.aot_compile(x, y)
    opt = tr._optimizer
    sts = [tr._updater._state_for(i, p) for i, p in enumerate(tr._params)]
    before = ([p.detach().clone() for p in net.parameters()],
              [s.clone() for st in sts for s in opt.state_tensors(st)],
              (opt.num_update, dict(opt._index_update_count)),
              torch.cuda.get_rng_state(cuda_dev))
    rep = step.analyze(x, y)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b.detach()) for a, b in
               zip(before[0], net.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(
        before[1], [s for st in sts for s in opt.state_tensors(st)]))
    assert before[2] == (opt.num_update, dict(opt._index_update_count))
    assert torch.equal(before[3], torch.cuda.get_rng_state(cuda_dev))
    assert step.n_traces == 1 and rep.ok
    assert rep.collectives.ops == [] and rep.host_transfers == []
    assert rep.donation.declared == rep.donation.aliased > 0
    kernels = {}
    for k in rep.fusion.kernels:
        if k.kind == "custom":
            name = k.name.split()[1]
            kernels[name] = kernels.get(name, 0) + 1
    b0 = K.launch_counts()
    step(x, y)
    torch.cuda.synchronize()
    per_step = {n: c - b0[n] for n, c in K.launch_counts().items()
                if c - b0[n]}
    assert per_step == kernels
    assert step.analysis_report is rep


@pytest.mark.cuda
def test_transfer_guard_raises_on_a_host_read_on_card(cuda_dev):
    x = torch.ones(8, device=cuda_dev)
    with mxt.analysis.transfer_guard("raise"):
        with pytest.raises(mxt.MXNetError, match="test_torch_cuda.py"):
            x.sum().item()
        with pytest.raises(mxt.MXNetError, match="to_host"):
            x.cpu()
        with mxt.analysis.allow_transfers():
            assert x.sum().item() == 8.0
        y = x * 2
    assert float(y.sum()) == 16.0


@pytest.mark.cuda
def test_predictor_analyze_on_card(cuda_dev):
    from mxnet_tpu_torch.gluon.nn import Dense
    from mxnet_tpu_torch.serving import CompiledPredictor
    torch.manual_seed(0)
    net = torch.nn.Sequential(Dense(32, in_units=16, activation="relu",
                                    device=cuda_dev),
                              Dense(4, in_units=32, device=cuda_dev))
    pred = CompiledPredictor(net, bucket_sizes=(8,), device=cuda_dev,
                             analyze="raise")
    pred.predict(torch.randn(8, 16, device=cuda_dev))
    rep = pred.analysis_report
    assert rep.mode == "predict" and rep.ok and rep.n_traces == 1
    assert rep.fusion.by_kind().get("dot", 0) == 2


def _box_inputs(seed, b=6, m=4, n_classes=5):
    """Anchors of two SSD scales, labels with padding rows and a duplicate
    best anchor (image 0's first two truths share one box), class scores,
    and NMS rows of heavily overlapping boxes."""
    from mxnet_tpu_torch.ndarray import contrib
    r = onp.random.RandomState(seed)
    anc = torch.cat([contrib.MultiBoxPrior(torch.zeros(1, 1, s, s),
                                           sizes=(0.2, 0.3),
                                           ratios=(1.0, 2.0, 0.5))
                     for s in (8, 4)], 1)
    lab = onp.full((b, m, 5), -1.0, "f4")
    for i in range(b):
        k = 1 + i % m
        xy = r.uniform(0, 0.6, (k, 2))
        lab[i, :k, 0] = r.randint(0, n_classes, k)
        lab[i, :k, 1:] = onp.concatenate([xy, xy + r.uniform(
            0.1, 0.4, (k, 2))], 1)
    lab[0, 1] = lab[0, 0]
    lab[0, 1, 0] = (lab[0, 0, 0] + 1) % n_classes
    cls = r.randn(b, n_classes + 1, anc.shape[1]).astype("f4")
    xy = r.uniform(0.2, 0.4, (2, 200, 2))
    rows = onp.concatenate([r.randint(0, 3, (2, 200, 1)),
                            r.uniform(0, 1, (2, 200, 1)), xy,
                            xy + r.uniform(0.2, 0.4, (2, 200, 2))], 2)
    return anc, torch.from_numpy(lab), torch.from_numpy(cls), \
        torch.from_numpy(rows.astype("f4"))


@pytest.mark.cuda
@pytest.mark.parametrize("mining", [-1.0, 3.0])
def test_multibox_target_on_card_equals_cpu(cuda_dev, mining):
    """The card's matching (duplicate best anchor: the later truth wins by
    ``scatter_reduce``) equals the CPU's; no host transfer."""
    from mxnet_tpu_torch.ndarray import contrib
    anc, lab, cls, _ = _box_inputs(0)
    ref = contrib.MultiBoxTarget(anc, lab, cls,
                                 negative_mining_ratio=mining)
    with mxt.analysis.transfer_guard("raise"):
        got = contrib.MultiBoxTarget(anc.to(cuda_dev), lab.to(cuda_dev),
                                     cls.to(cuda_dev),
                                     negative_mining_ratio=mining)
    got = [g.cpu() for g in got]
    assert torch.equal(got[2], ref[2]) and torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_box_nms_on_card_equals_cpu_and_replays(cuda_dev):
    """``box_nms`` on the card equals the CPU; captured, its greedy walk
    replays as one graph and equals the eager call."""
    from mxnet_tpu_torch.captured import CapturedProgram
    from mxnet_tpu_torch.ndarray import contrib
    *_, rows = _box_inputs(1)
    kw = dict(overlap_thresh=0.45, valid_thresh=0.01, id_index=0)
    ref = contrib.box_nms(rows, **kw)
    x = rows.to(cuda_dev)
    with mxt.analysis.transfer_guard("raise"):
        eager = contrib.box_nms(x, **kw)
    assert torch.equal(eager.cpu(), ref)
    prog = CapturedProgram("box_nms", lambda t: contrib.box_nms(t, **kw),
                           [x.clone()], cuda_dev, ())
    assert torch.equal(prog.run(), eager)
    assert bool((ref[..., 0] < 0).any()) and bool((ref[..., 0] >= 0).any())
