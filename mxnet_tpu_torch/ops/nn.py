"""Layer ops (counterpart of ``mxnet_tpu/ops/nn.py``; this slice ports
``layer_norm``, the fully-connected product and the softmaxes).

:func:`softmax` and :func:`log_softmax` go through the op funnel
(``ops/registry.py``) under the JAX package's names, as its
``F.softmax`` / ``F.log_softmax`` do; :func:`linear` and
:func:`layer_norm` are the bodies the layers funnel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import norm as _knorm
from .registry import invoke

__all__ = ["layer_norm", "linear", "softmax", "log_softmax"]


def linear(x, weight, bias=None):
    """``x W^T (+ b)`` over the trailing axis.

    On the card this is one cuBLAS product in x's dtype (the JAX package
    leaves the product to XLA too). On the CPU, MKL picks its GEMM
    kernel by the number of rows and a row's position among them, so a
    float32 row would round differently with other batch-mates; there
    the product accumulates in float64 and rounds once, which keeps a
    request's result independent of the batch it rides in, as XLA's CPU
    dot does for the JAX package. Operands of mixed dtypes are promoted
    first (float32 with bfloat16 gives float32), as ``jnp.dot`` does."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
    x, weight = x.to(dt), weight.to(dt)
    bias = None if bias is None else bias.to(dt)
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return F.linear(x.double(), weight.double(),
                        None if bias is None else bias.double()).float()
    return F.linear(x, weight, bias)


def layer_norm(x, gamma, beta, axis: int = -1, eps: float = 1e-5):
    """LayerNorm with float32 statistics and output in x's dtype.
    Trailing-axis calls go through the kernel layer
    (``kernels.norm.layer_norm``); any other axis runs plain PyTorch."""
    if axis in (-1, x.ndim - 1):
        return _knorm.layer_norm(x, gamma, beta, eps)
    dt = _knorm.stat_dtype(x)
    xf = x.to(dt)
    mean = xf.mean(dim=axis, keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=axis, keepdim=True)
    out = d * torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return (out * gamma.to(dt).reshape(shape)
            + beta.to(dt).reshape(shape)).to(x.dtype)


def softmax(x, axis: int = -1):
    """Softmax over ``axis``, through the funnel as ``"softmax"``."""
    return invoke("softmax", lambda t: torch.softmax(t, dim=axis), x)


def log_softmax(x, axis: int = -1):
    """Log-softmax over ``axis``, through the funnel as
    ``"log_softmax"``."""
    return invoke("log_softmax", lambda t: torch.log_softmax(t, dim=axis),
                  x)
