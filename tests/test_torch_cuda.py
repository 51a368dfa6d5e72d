"""mxnet_tpu_torch's CUDA kernels against their plain versions, on the
card. Every test here needs a CUDA device and skips without one; the file
imports nothing of JAX, so it runs on the machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 in float32 (sums in another order, expf/erfcf of the
CUDA math library), 2e-2 in bfloat16 (one or two bfloat16 ulps of an O(1)
output).
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
