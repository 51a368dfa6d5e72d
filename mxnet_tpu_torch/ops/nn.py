"""Layer ops (counterpart of ``mxnet_tpu/ops/nn.py``): ``layer_norm``,
the fully-connected product, the softmaxes, and the convolutional path's
``conv``, ``pool``, ``global_pool``, ``batch_norm_train`` and
``batch_norm_infer``; ``group_norm`` and ``instance_norm``.

:func:`softmax` and :func:`log_softmax` go through the op funnel
(``ops/registry.py``) under the JAX package's names, as its
``F.softmax`` / ``F.log_softmax`` do; the others are the bodies the
layers funnel (``"fully_connected"``, ``"layer_norm"``,
``"convolution"``, ``"pooling"``, ``"global_pool"``, ``"batch_norm"``,
``"group_norm"``, ``"instance_norm"``).

The JAX package computes convolutions and pooling with XLA's
``conv_general_dilated`` and ``reduce_window``, outside any Pallas
kernel; here they are cuDNN's (``F.conv2d``, ``F.max_pool2d``,
``F.batch_norm``), as a plain product is cuBLAS's. Layouts are
NC + spatial (NCW, NCHW, NCDHW), as there."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

from .kernels import norm as _knorm
from .registry import invoke

__all__ = ["layer_norm", "linear", "softmax", "log_softmax", "conv", "pool",
           "global_pool", "batch_norm_train", "batch_norm_train_sync",
           "batch_norm_infer", "group_norm", "instance_norm"]


def _promoted(*ts):
    """The tensors (None kept) in their promoted dtype, as ``jnp`` promotes
    (float32 with bfloat16 gives float32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return [None if t is None else t.to(dt) for t in ts]


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
    x, weight, bias = _promoted(x, weight, bias)
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


def _tup(v, n):
    """An int or a sequence as an n-tuple (a short sequence repeats its
    last entry), as the JAX package's ``_tup``."""
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    return t if len(t) == n else t + t[-1:] * (n - len(t))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def conv(x, w, b=None, stride=None, dilate=None, pad=None,
         num_group: int = 1):
    """N-d convolution (1-3 spatial axes), NC + spatial layout, weight
    ``(out, in // num_group, *kernel)``, symmetric zero padding ``pad``.
    Operands of mixed dtypes are promoted first, as :func:`linear` does.
    On the CPU a float32 convolution accumulates in float64 and rounds
    once, so a request's result does not depend on its batch-mates (the
    CPU's convolution picks its algorithm by the batch's shape)."""
    ndim = x.ndim - 2
    x, w, b = _promoted(x, w, b)
    kw = dict(stride=_tup(stride, ndim), padding=_tup(pad or 0, ndim),
              dilation=_tup(dilate, ndim), groups=num_group)
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return _CONV[ndim](x.double(), w.double(),
                           None if b is None else b.double(), **kw).float()
    return _CONV[ndim](x, w, b, **kw)


def _pool_pads(x, kernel, stride, pad, ceil_mode):
    """Left and right padding of each spatial axis: ``ceil_mode`` (the
    reference's ``pooling_convention="full"``) pads the right further so
    the last partial window is kept."""
    ndim = x.ndim - 2
    rpad = list(pad)
    if ceil_mode:
        for i in range(ndim):
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                rpad[i] = pad[i] + stride[i] - rem
    return tuple(pad), tuple(rpad)


def _padded(x, left, right, value):
    """``x`` padded on its spatial axes with ``value``."""
    widths = []
    for lo, hi in zip(reversed(left), reversed(right)):
        widths += [lo, hi]
    return F.pad(x, widths, value=value)


def _window_sums(x, kernel, stride):
    """The sum of each window (no padding): an average pool that divides
    by 1 (a 1-d pool as a 2-d one, which takes the divisor)."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(-1), (kernel[0], 1), (stride[0], 1),
                            divisor_override=1).squeeze(-1)
    return _AVG_POOL[len(kernel)](x, kernel, stride, divisor_override=1)


def pool(x, kernel, pool_type: str = "max", stride=None, pad=None,
         count_include_pad: bool = True, ceil_mode: bool = False,
         p_value: int = 2):
    """Max / avg / sum / lp pooling over the spatial axes, with the JAX
    package's rules (``reduce_window``): a padded position is -inf to
    max and 0 to a sum; ``ceil_mode`` pads the right further so the
    output size rounds up. An average divides by the window clipped to
    the explicitly padded extent with ``count_include_pad`` (``ceil_mode``'s
    extra right padding never counts), else by the real elements the
    window covers. ``F.avg_pool2d``'s own ``ceil_mode`` keeps other
    windows and divides otherwise, so only the plain padding is left to
    it."""
    ndim = x.ndim - 2
    kernel = _tup(kernel, ndim)
    stride = _tup(stride if stride is not None else kernel, ndim)
    left, right = _pool_pads(x, kernel, stride, _tup(pad or 0, ndim),
                             ceil_mode)
    plain = left == right and all(2 * p <= k for p, k in zip(left, kernel))
    if pool_type == "max":
        if plain:
            return _MAX_POOL[ndim](x, kernel, stride, left)
        low = -float("inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        return _MAX_POOL[ndim](_padded(x, left, right, low), kernel, stride)
    if pool_type not in ("avg", "sum", "lp"):
        raise MXNetError(f"unknown pool_type {pool_type}")
    src = x.abs() ** p_value if pool_type == "lp" else x
    s = _window_sums(_padded(src, left, right, 0.0), kernel, stride)
    if pool_type == "sum":
        return s
    if pool_type == "lp":
        return s ** (1.0 / p_value)
    if count_include_pad:
        # ones over [0, H + 2p), zeros in ceil mode's extra right padding
        ones = x.new_ones((1, 1) + tuple(
            n + 2 * p for n, p in zip(x.shape[2:], left)))
        cnt = _padded(ones, (0,) * ndim,
                      tuple(r - p for p, r in zip(left, right)), 0.0)
    else:
        cnt = _padded(x.new_ones((1, 1) + tuple(x.shape[2:])), left, right,
                      0.0)
    return s / _window_sums(cnt, kernel, stride)


def global_pool(x, pool_type: str = "max"):
    """Max / avg / sum over every spatial axis, kept as size-1 axes."""
    axes = tuple(range(2, x.ndim))
    if pool_type == "max":
        return x.amax(dim=axes, keepdim=True)
    if pool_type == "avg":
        return x.mean(dim=axes, keepdim=True)
    return x.sum(dim=axes, keepdim=True)


def _stat_params(x, *ts):
    """Per-channel tensors in the statistics' dtype (float32 for a
    bfloat16 or float16 x, float64 for a float64 one), as ``_stat_dtype``
    of the JAX package."""
    dt = _knorm.stat_dtype(x)
    return [t.to(dt) for t in ts]


def batch_norm_infer(x, gamma, beta, moving_mean, moving_var, eps: float):
    """Inference-mode BatchNorm over axis 1 with the running statistics:
    float32 arithmetic, output in x's dtype (cuDNN's mixed-precision
    BatchNorm takes a bfloat16 x with float32 statistics as they are)."""
    g, b, m, v = _stat_params(x, gamma, beta, moving_mean, moving_var)
    return F.batch_norm(x, m, v, g, b, training=False, eps=eps)


def batch_norm_train(x, gamma, beta, eps: float):
    """Training-mode BatchNorm over axis 1: returns ``(out, batch_mean,
    batch_var)``, the output normalised with the batch's statistics in
    x's dtype, the statistics in float32 (float64 for a float64 x) for
    the caller's running update. The variance is the biased one
    (``jnp.var``), for the normalisation and for the statistics alike.

    ``F.batch_norm`` (one cuDNN kernel each way, the backward through
    the batch's statistics included) normalises with the biased variance
    but writes the UNBIASED one into its running buffers, blended by its
    own momentum convention; so it is given fresh zero buffers and
    momentum 1 (which leaves it the batch's mean and unbiased variance,
    no gradient through them), and the variance is scaled back to the
    biased one by (n - 1) / n. One element a channel (n = 1) has no
    unbiased variance; there the statistics are computed plainly."""
    g, b = _stat_params(x, gamma, beta)
    n = x.numel() // x.shape[1]
    if n == 1:
        xf = x.to(g.dtype)
        axes = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean = xf.mean(dim=axes)
        d = xf - mean.reshape(shape)
        var = (d * d).mean(dim=axes)
        out = d * torch.rsqrt(var.reshape(shape) + eps) * g.reshape(shape) \
            + b.reshape(shape)
        return out.to(x.dtype), mean.detach(), var.detach()
    mean = torch.zeros_like(g)
    var = torch.zeros_like(g)
    out = F.batch_norm(x, mean, var, g, b, training=True, momentum=1.0,
                       eps=eps)
    # a new tensor: autograd checks the buffers it saved are unchanged
    return out, mean, var * ((n - 1) / n)


class _SyncBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm whose statistics span the ranks of
    ``group``: each rank holds its rows of one global batch.

    Forward: one all-reduce of each channel's count and sum gives the
    global mean, a second one of the sum of squared deviations from it
    the global (biased) variance; two passes, as ``jnp.var`` takes them
    (one pass over x^2 would part from the one-program reference by
    cancellation). Backward: one all-reduce of the per-channel sums of
    dy and of dy x-hat, then dx = gamma / sigma (dy - mean(dy) - x-hat
    mean(dy x-hat)) over the global batch. dgamma and dbeta are this
    rank's sums: the step's own gradient reduction adds the ranks'."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group):
        import torch.distributed as dist
        dt = _knorm.stat_dtype(x)
        xf = x.to(dt)
        axes = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        c = x.shape[1]
        head = torch.empty(c + 1, dtype=dt, device=x.device)
        head[0] = x.numel() // c
        head[1:] = xf.sum(dim=axes)
        dist.all_reduce(head, group=group)
        count = head[0]
        mean = head[1:] / count
        d = xf - mean.reshape(shape)
        sq = (d * d).sum(dim=axes)
        dist.all_reduce(sq, group=group)
        var = sq / count
        invstd = torch.rsqrt(var + eps)
        xhat = d * invstd.reshape(shape)
        g, b = gamma.to(dt), beta.to(dt)
        out = (xhat * g.reshape(shape) + b.reshape(shape)).to(x.dtype)
        ctx.save_for_backward(xhat, invstd, g, count)
        ctx.meta = (group, x.dtype, gamma.dtype, beta.dtype, axes, shape)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        import torch.distributed as dist
        xhat, invstd, g, count = ctx.saved_tensors
        group, x_dt, g_dt, b_dt, axes, shape = ctx.meta
        dyf = dy.to(xhat.dtype)
        c = xhat.shape[1]
        sums = torch.cat([dyf.sum(dim=axes), (dyf * xhat).sum(dim=axes)])
        dgamma, dbeta = sums[c:].to(g_dt), sums[:c].to(b_dt)
        sums = sums.clone()
        dist.all_reduce(sums, group=group)
        mdy = (sums[:c] / count).reshape(shape)
        mdyx = (sums[c:] / count).reshape(shape)
        dx = (g * invstd).reshape(shape) * (dyf - mdy - xhat * mdyx)
        return dx.to(x_dt), dgamma, dbeta, None, None


def batch_norm_train_sync(x, gamma, beta, eps: float, group=None):
    """:func:`batch_norm_train` over the global batch whose rows the
    ranks of ``group`` (a ``torch.distributed`` group; None is the
    default one) hold between them: ``(out, batch_mean, batch_var)``,
    the statistics the global batch's, equal on every rank. Collectives
    cannot be captured into a CUDA graph: a capture raises."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            "BatchNorm with statistics across ranks cannot be captured "
            "into a CUDA graph: train it with compile_step's zero or "
            "mesh mode, which run eagerly")
    return _SyncBatchNorm.apply(x, gamma, beta, eps, group)


def _affine(out, x, gamma, beta):
    """``out * gamma + beta`` over axis 1, in x's dtype."""
    g, b = _stat_params(x, gamma, beta)
    shape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    return (out * g.reshape(shape) + b.reshape(shape)).to(x.dtype)


def _normalised(xf, axes, eps):
    mean = xf.mean(dim=axes, keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=axes, keepdim=True)
    return d * torch.rsqrt(var + eps)


def group_norm(x, gamma, beta, num_groups: int, eps: float = 1e-5):
    """GroupNorm of an (N, C, ...) x: the channels in ``num_groups``
    groups, each (sample, group) normalised over its channels and
    spatial positions with the biased variance, eps inside the root,
    then ``gamma`` / ``beta`` a channel; float32 statistics, the output
    in x's dtype (the JAX package's ``group_norm``)."""
    n, c = x.shape[:2]
    if c % num_groups:
        raise MXNetError(f"group_norm: {c} channels do not divide into "
                         f"{num_groups} groups")
    xg = x.to(_knorm.stat_dtype(x)).reshape(
        (n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    out = _normalised(xg, tuple(range(2, xg.ndim)), eps).reshape(x.shape)
    return _affine(out, x, gamma, beta)


def instance_norm(x, gamma, beta, eps: float = 1e-5):
    """InstanceNorm of an (N, C, ...) x: each (sample, channel)
    normalised over its spatial positions, then ``gamma`` / ``beta`` a
    channel; float32 statistics, the output in x's dtype."""
    xf = x.to(_knorm.stat_dtype(x))
    return _affine(_normalised(xf, tuple(range(2, x.ndim)), eps), x, gamma,
                   beta)
