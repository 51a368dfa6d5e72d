"""Automatic mixed precision (counterpart of ``mxnet_tpu/amp``).

``amp.init()`` installs a wrapper on the op funnel (``ops/registry.py``)
with the JAX package's list semantics, by funnel name:

- ``TARGET_DTYPE_OPS`` (the products: fully-connected, attention,
  recurrent layers by the ``rnn_`` prefix) cast float32 inputs, weights
  included, down to the target dtype, and their outputs flow in it;
- ``FP32_OPS`` (softmax, log-softmax, ...) cast target-dtype inputs up
  to float32;
- ``NORM_OPS`` are float32-pinned only for float16; under bfloat16 they
  follow their input's dtype (their kernels keep statistics in float32);
- every other op follows torch's type promotion, which for float32 with
  bfloat16 gives float32, as ``jnp``'s does.

Parameters stay float32 under ``amp.init()``: the casts are autograd
operations, so gradients come back float32 and the optimizer needs no
master copy. ``convert_hybrid_block`` casts parameters for inference
instead (``serving.predictor_for``). The kernels take float32 and
bfloat16; float16 runs only on the CPU's plain versions.

amp is process-wide: ``uninit()`` removes the wrapper.
"""
from __future__ import annotations

import contextlib

import torch

from ..base import MXNetError
from ..ops import registry as _registry
from .loss_scaler import LossScaler

__all__ = ["init", "uninit", "is_enabled", "init_trainer", "scale_loss",
           "convert_hybrid_block", "LossScaler", "TARGET_DTYPE_OPS",
           "NORM_OPS", "FP32_OPS"]

# the JAX package's lists, by funnel name; the fused recurrent layers
# funnel as "rnn_<mode>", matched by prefix
TARGET_DTYPE_OPS = {
    "fully_connected", "convolution", "deconvolution", "dot", "batch_dot",
    "linalg_gemm2", "flash_attention", "flash_attention_vl",
    "masked_attention", "bert_decoder_proj", "moe_ffn",
    "Correlation", "DeformableConvolution",
}

NORM_OPS = {
    "batch_norm", "layer_norm", "group_norm", "instance_norm",
    "SyncBatchNorm",
}

FP32_OPS = NORM_OPS | {
    "softmax", "log_softmax", "softmax_cross_entropy", "norm", "moments",
    "exp", "log", "l2_normalization", "lrn",
}

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16}

_state = {"enabled": False, "dtype": None, "wrapper": None}


def _cast_down(x, dtype):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(dtype)
    return x


def _cast_up(x, dtype):
    if isinstance(x, torch.Tensor) and x.dtype == dtype:
        return x.float()
    return x


def _make_wrapper(target_dtype):
    fp32_ops = FP32_OPS if target_dtype == torch.float16 \
        else FP32_OPS - NORM_OPS

    def wrapper(name, fn):
        if name in TARGET_DTYPE_OPS or name.startswith("rnn_"):
            def amp_fn(*args, **kwargs):
                return fn(*[_cast_down(a, target_dtype) for a in args],
                          **kwargs)
            return amp_fn
        if name in fp32_ops:
            def fp32_fn(*args, **kwargs):
                return fn(*[_cast_up(a, target_dtype) for a in args],
                          **kwargs)
            return fp32_fn
        return fn
    return wrapper


def init(target_dtype: str = "bfloat16"):
    """Enable amp process-wide."""
    if _state["enabled"]:
        return
    dt = _DTYPES.get(target_dtype)
    if dt is None:
        raise MXNetError(f"unsupported AMP target dtype {target_dtype!r}")
    w = _make_wrapper(dt)
    _registry.add_invoke_wrapper(w)
    _state.update(enabled=True, dtype=dt, wrapper=w)


def uninit():
    """Disable amp (the reference has no un-init; tests need one)."""
    if _state["enabled"]:
        _registry.remove_invoke_wrapper(_state["wrapper"])
        _state.update(enabled=False, dtype=None, wrapper=None)


def is_enabled() -> bool:
    return _state["enabled"]


def init_trainer(trainer):
    """Attach a dynamic :class:`LossScaler` to a ``gluon.Trainer``: scale
    1 under bfloat16, 2**16 otherwise."""
    scaler = LossScaler(
        init_scale=1.0 if _state["dtype"] == torch.bfloat16 else 2. ** 16)
    trainer._amp_loss_scaler = scaler
    return scaler


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Yield the scaled loss. ``trainer._scale`` is set, against the
    trainer's original scale, to divide the loss scale out of the
    ``trainer.step()`` that follows, however the scale changes."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        scaler = init_trainer(trainer)
    if not hasattr(trainer, "_amp_original_scale"):
        trainer._amp_original_scale = trainer._scale
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale
    if scaler.loss_scale == 1.0:
        yield loss
    elif isinstance(loss, (list, tuple)):
        yield type(loss)(l * scaler.loss_scale for l in loss)
    else:
        yield loss * scaler.loss_scale


def convert_hybrid_block(block, target_dtype: str = "bfloat16"):
    """Cast a block's parameters for low-precision inference: every
    float32 parameter not owned by a normalisation layer (``BatchNorm``,
    its running statistics included, and ``LayerNorm``: the JAX
    package's ``norm_types`` the port has) goes to ``target_dtype``, in
    place (same Parameter objects). Returns ``block``."""
    from ..gluon.nn import BatchNorm, LayerNorm
    dt = _DTYPES.get(target_dtype)
    if dt is None:
        raise MXNetError(f"unsupported AMP target dtype {target_dtype!r}")
    norm_params = {id(p) for m in block.modules()
                   if isinstance(m, (BatchNorm, LayerNorm))
                   for p in m.parameters()}
    with torch.no_grad():
        for p in block.parameters():
            if id(p) not in norm_params and p.dtype == torch.float32:
                p.data = p.data.to(dt)
                if p.grad is not None:
                    p.grad = p.grad.to(dt)
    return block
