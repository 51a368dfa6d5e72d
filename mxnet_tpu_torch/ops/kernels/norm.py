"""LayerNorm and bias-GELU forward kernels (counterpart of
``mxnet_tpu/ops/kernels/norm.py``).

- :func:`layer_norm`: float32 two-pass statistics over the trailing axis,
  output in x's dtype (CUDA kernel ``csrc/layernorm_fwd.cu``).
- :func:`bias_gelu`: exact (erf) ``gelu(x + b)`` over the trailing axis
  (CUDA kernel ``csrc/bias_gelu_fwd.cu``).

Each wrapper runs its plain PyTorch version (``layer_norm_plain``,
``bias_gelu_plain``, beside it) for a tensor on the CPU, and its kernel
for a tensor on a CUDA device, raising on what the kernel does not take.
"""
from __future__ import annotations

import math

import torch

from ...base import MXNetError
from . import DTYPE_CODES, check_cuda_operands, launch

__all__ = ["layer_norm", "layer_norm_plain", "bias_gelu", "bias_gelu_plain"]

_SQRT_HALF = math.sqrt(0.5)


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """Normalisation statistics are float32 even for bfloat16/float16
    activations (float64 stays float64)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _check_vector(name: str, t: torch.Tensor, c: int, what: str) -> None:
    if tuple(t.shape) != (c,):
        raise MXNetError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected ({c},)")


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def layer_norm_plain(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the trailing axis: the mean, then the mean of
    squared deviations (two passes, as ``jnp.var``), in float32."""
    dt = stat_dtype(x)
    xf = x.to(dt)
    mean = xf.mean(dim=-1, keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=-1, keepdim=True)
    out = d * torch.rsqrt(var + eps)
    return (out * gamma.to(dt) + beta.to(dt)).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """Fused LayerNorm over the trailing axis (float32 statistics, output
    in x's dtype)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    check_cuda_operands("layer_norm", x, gamma, beta)
    if x.ndim < 1:
        raise MXNetError("layer_norm: expects at least one axis")
    c = int(x.shape[-1])
    _check_vector("layer_norm", gamma, c, "gamma")
    _check_vector("layer_norm", beta, c, "beta")
    out = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return out
    g = gamma.to(torch.float32).contiguous()
    b = beta.to(torch.float32).contiguous()
    launch("layernorm_fwd", x.device, x.data_ptr(), g.data_ptr(),
           b.data_ptr(), out.data_ptr(), rows, c, float(eps),
           DTYPE_CODES[x.dtype])
    return out


# ---------------------------------------------------------------------------
# bias-GELU
# ---------------------------------------------------------------------------

def bias_gelu_plain(x, b):
    """``gelu(x + b)``, exact erf form: z = x + b in x's dtype, then
    0.5 * z * erfc(-z / sqrt(2)) in float32, written in x's dtype."""
    z = (x + b.to(x.dtype)).to(stat_dtype(x))
    return (0.5 * z * torch.erfc(-z * _SQRT_HALF)).to(x.dtype)


def bias_gelu(x, b):
    """Fused ``gelu(x + b)`` (exact erf form) over the trailing axis."""
    if x.device.type == "cpu":
        return bias_gelu_plain(x, b)
    check_cuda_operands("bias_gelu", x, b)
    c = int(x.shape[-1]) if x.ndim else 0
    _check_vector("bias_gelu", b, c, "b")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    bb = b.to(x.dtype).contiguous()
    launch("bias_gelu_fwd", x.device, x.data_ptr(), bb.data_ptr(),
           out.data_ptr(), x.numel(), c, DTYPE_CODES[x.dtype])
    return out
