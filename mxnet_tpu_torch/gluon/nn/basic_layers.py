"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``):
``Dense``, ``Dropout``, ``Embedding`` and ``LayerNorm`` as ``nn.Module``s.

Parameter names and layouts are the JAX package's, so a dict of its
``collect_params()`` loads as it is (``gluon.params.load_jax_params``):
``Dense.weight`` is (units, in_units), ``Embedding.weight`` is
(input_dim, output_dim), ``LayerNorm`` has ``gamma`` and ``beta``.
``Dense`` and ``LayerNorm`` run their op through the op funnel
(``ops/registry.py``) as ``"fully_connected"`` and ``"layer_norm"``, the
names under which ``amp`` casts them.

Every layer takes ``device`` (default ``cuda:0``; without CUDA the
constructor raises unless ``device="cpu"``) and an optional
``torch.Generator`` for its random initial weights or dropout masks.
Shapes are not inferred at the first call: ``in_units`` / ``in_channels``
are required.

A layer that may draw random numbers in its forward (``Dropout``, the
recurrent layers' dropout between layers) notes itself and its generator
with :func:`note_draw` first, whatever its mode; inside
:func:`recording_draws` a caller (a captured train step, which must
register every generator its graph draws from and restore them after
its warm-up) learns of them. It draws when :func:`drawing` says so: in
training mode, outside a :func:`draws_off` block (``compile_step(...,
train_mode=False)``).

Parameters are trainable. Each carries the JAX package's ``Parameter``
attributes (``gluon/parameter.py``): ``grad_req`` (``"write"``,
``"add"`` or ``"null"``; set it with :func:`set_grad_req`), ``lr_mult``
and ``wd_mult``, and ``fresh_grad``, which a backward that reaches the
parameter sets and ``gluon.Trainer`` clears after each update. A hook on
each parameter gives ``"write"`` its meaning: each backward overwrites
the gradient.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import weakref
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as FNN
from ...ops.registry import invoke

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "activation",
           "init_param", "set_grad_req", "GRAD_REQS", "note_draw",
           "recording_draws", "draws_off", "drawing"]

GRAD_REQS = ("write", "add", "null")

#: initial weights: uniform in [-0.07, 0.07] (the JAX package's default
#: ``initializer.Uniform()``); biases and beta 0, gamma 1
INIT_SCALE = 0.07

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


#: per thread: the records the open :func:`recording_draws` fill
_DRAWS = threading.local()


@contextlib.contextmanager
def recording_draws():
    """Within the block, each layer that notes a draw on this thread
    (:func:`note_draw`) is recorded once, in first-seen order: yields a
    dict ``id(module) -> (module, generator or None, the generator's
    state before the layer's first draw or None)``. Blocks nest; each
    records what happens inside it."""
    rec: dict = {}
    if not hasattr(_DRAWS, "stack"):
        _DRAWS.stack = []
    _DRAWS.stack.append(rec)
    try:
        yield rec
    finally:
        _DRAWS.stack = [r for r in _DRAWS.stack if r is not rec]


@contextlib.contextmanager
def draws_off(off: bool = True):
    """Within the block (on this thread), with ``off``, every layer that
    draws runs as in eval mode whatever its own mode (:func:`drawing`)."""
    prev = getattr(_DRAWS, "off", False)
    _DRAWS.off = prev or off
    try:
        yield
    finally:
        _DRAWS.off = prev


def drawing(module: nn.Module) -> bool:
    """Whether ``module`` draws now: in training mode, and not inside
    :func:`draws_off`."""
    return module.training and not getattr(_DRAWS, "off", False)


def note_draw(module: nn.Module, generator: Optional[torch.Generator]):
    """``module`` is about to draw from ``generator`` (None: its
    device's default generator), or would in training mode."""
    for rec in getattr(_DRAWS, "stack", ()):
        if id(module) not in rec:
            rec[id(module)] = (module, generator, None if generator is None
                               else generator.get_state())


def activation(x, act_type: str):
    """``F.Activation`` of the JAX package for the activations this slice
    uses."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError(f"unknown Activation act_type {act_type!r}")
    return fn(x)


def _on_grad(param_ref, grad):
    """Runs when a backward is about to accumulate ``grad`` into the
    parameter (once per backward, with every use of it summed): under
    ``"write"`` the old gradient is dropped first, so the backward
    overwrites it, as in the JAX package; PyTorch alone would add."""
    p = param_ref()
    if p is not None:
        if p.grad_req == "write":
            p.grad = None
        p.fresh_grad = True
    return grad


def set_grad_req(p: nn.Parameter, grad_req: str) -> None:
    """Set ``p.grad_req``: ``"write"`` (a backward overwrites the
    gradient) and ``"add"`` (it accumulates) make it trainable, ``"null"``
    freezes it and drops its gradient."""
    if grad_req not in GRAD_REQS:
        raise MXNetError(f"grad_req must be one of {GRAD_REQS}, got "
                         f"{grad_req!r}")
    p.grad_req = grad_req
    p.requires_grad_(grad_req != "null")
    if grad_req == "null":
        p.grad = None
    elif not getattr(p, "_grad_hook", False):
        p.register_hook(functools.partial(_on_grad, weakref.ref(p)))
        p._grad_hook = True
    p.fresh_grad = False


def init_param(p: nn.Parameter, grad_req: str = "write",
               lr_mult: float = 1.0, wd_mult: float = 1.0) -> nn.Parameter:
    """Give ``p`` the JAX package's Parameter attributes (``grad_req``,
    ``lr_mult``, ``wd_mult``, ``fresh_grad``); returns ``p``."""
    p.lr_mult = lr_mult
    p.wd_mult = wd_mult
    set_grad_req(p, grad_req)
    return p


def _param(shape, device, fill=None, generator=None):
    t = torch.empty(shape, dtype=torch.float32)
    if fill is None:
        t.uniform_(-INIT_SCALE, INIT_SCALE, generator=generator)
    else:
        t.fill_(fill)
    return init_param(nn.Parameter(t.to(device)))


class Dense(nn.Module):
    """Fully-connected layer: ``act(x W^T + b)``. ``flatten`` collapses
    the trailing axes of a >2-d input first."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, flatten: bool = True,
                 in_units: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_units <= 0:
            raise MXNetError("Dense needs in_units (shapes are not "
                             "inferred at the first call)")
        dev = resolve_device(device)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = _param((units, in_units), dev, generator=generator)
        self.bias = _param((units,), dev, fill=0.0) if use_bias else None

    def forward(self, x):
        if self._flatten and x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        out = invoke("fully_connected", FNN.linear, x, self.weight,
                     self.bias)
        if self._activation:
            out = activation(out, self._activation)
        return out


class Dropout(nn.Module):
    """Inverted dropout in training mode, identity in eval mode."""

    def __init__(self, rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._rate = rate
        self._generator = generator

    def forward(self, x):
        note_draw(self, self._generator)
        if self._rate == 0 or not drawing(self):
            return x
        keep = torch.bernoulli(
            torch.full(x.shape, 1.0 - self._rate, device=x.device),
            generator=self._generator).to(torch.bool)
        return torch.where(keep, x / (1.0 - self._rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class Embedding(nn.Module):
    """Embedding lookup. Out-of-range ids clamp to the nearest row, as in
    the JAX package (``jnp.take(mode="clip")``)."""

    def __init__(self, input_dim: int, output_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = _param((input_dim, output_dim), dev,
                             generator=generator)

    def forward(self, x):
        idx = x.to(torch.long).clamp(0, self._input_dim - 1)
        return F.embedding(idx, self.weight)


class LayerNorm(nn.Module):
    """LayerNorm over ``axis`` (float32 statistics, output in x's dtype);
    the trailing axis goes through the LayerNorm kernel."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-5,
                 in_channels: int = 0, device=None):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("LayerNorm needs in_channels (shapes are not "
                             "inferred at the first call)")
        dev = resolve_device(device)
        self._axis = axis
        self._eps = epsilon
        self.gamma = _param((in_channels,), dev, fill=1.0)
        self.beta = _param((in_channels,), dev, fill=0.0)

    def forward(self, x):
        return invoke("layer_norm", self._norm, x, self.gamma, self.beta)

    def _norm(self, x, gamma, beta):
        return FNN.layer_norm(x, gamma, beta, axis=self._axis,
                              eps=self._eps)
