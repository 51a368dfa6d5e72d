"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``):
``Sequential``, ``HybridSequential``, ``Dense``, ``Dropout``,
``Embedding``, ``BatchNorm``, ``BatchNormReLU``, ``LayerNorm``,
``GroupNorm``, ``InstanceNorm``, ``Flatten``, ``Activation``,
``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``, ``Swish`` /
``SiLU``, ``Lambda``, ``HybridLambda``, ``Identity``, ``Concatenate``
and ``HybridConcatenate`` as ``nn.Module``s, and ``SyncBatchNorm``.

Parameter names and layouts are the JAX package's, so a dict of its
``collect_params()`` loads as it is (``gluon.params.load_jax_params``):
``Dense.weight`` is (units, in_units), ``Embedding.weight`` is
(input_dim, output_dim), ``LayerNorm`` has ``gamma`` and ``beta``,
``BatchNorm`` also ``running_mean`` and ``running_var``, and a
``Sequential``'s children are named ``0``, ``1``, ... in the order
added. ``Dense``, ``BatchNorm`` and ``LayerNorm`` run their op through
the op funnel (``ops/registry.py``) as ``"fully_connected"``,
``"batch_norm"`` and ``"layer_norm"``, the names under which ``amp``
casts them; the normalisations and activations added since funnel as
the JAX package's ``"group_norm"``, ``"instance_norm"``,
``"leaky_relu"``, ``"prelu"``, ``"elu"``, ``"selu"`` and ``"gelu"``
(``"gelu_tanh"`` for ``GELU("tanh")``).

``GELU`` takes MXNet's ``approximation`` ("erf" or "tanh"); the JAX
package's ``GELU`` ignores it and always takes the erf form
(``ROADMAP.md`` §3, a divergence of the reference).

Every layer takes ``device`` (default ``cuda:0``; without CUDA the
constructor raises unless ``device="cpu"``) and an optional
``torch.Generator`` for its random initial weights or dropout masks.
The JAX layers' initializer keywords (``weight_initializer``,
``bias_initializer``, ``gamma_initializer``, ...) name a parameter's
initializer (``mxnet_tpu_torch.initializer``): it gives the initial
value, is recorded as the parameter's ``init``, and wins over the
module-wide initializer of ``gluon.block.initialize``; a weight without
one starts uniform in [-0.07, 0.07], the JAX package's default.
Shapes are not inferred at the first call: ``in_units`` / ``in_channels``
are required.

A layer that may draw random numbers in its forward (``Dropout``, the
recurrent layers' dropout between layers) notes itself and its generator
with :func:`note_draw` first, whatever its mode; inside
:func:`recording_draws` a caller (a captured train step, which must
register every generator its graph draws from and restore them after
its warm-up) learns of them. It draws when :func:`drawing` says so: in
training mode, outside a :func:`draws_off` block (``compile_step(...,
train_mode=False)``). A layer that writes state in place in training
mode (``BatchNorm``'s running statistics) notes itself and those
tensors with :func:`note_writes` the same way, and follows the same
switch: a recording made with ``snapshot=True`` keeps copies of them
from before the first write, which the step's warm-up puts back.

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

from ... import initializer
from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as FNN
from ...ops.registry import invoke
from ...parallel.mesh import split_mesh

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "Embedding", "BatchNorm", "BatchNormReLU", "SyncBatchNorm",
           "LayerNorm",
           "GroupNorm", "InstanceNorm", "Flatten", "Activation", "LeakyReLU",
           "PReLU", "ELU", "SELU", "GELU", "Swish", "SiLU", "Lambda",
           "HybridLambda", "Identity", "Concatenate", "HybridConcatenate",
           "activation", "dropout", "keep_mask", "init_param",
           "set_grad_req", "GRAD_REQS", "note_draw", "note_writes",
           "recording_draws", "draws_off", "drawing"]

GRAD_REQS = ("write", "add", "null")

#: initial weights without an initializer keyword: uniform in [-0.07,
#: 0.07] (the JAX package's default ``initializer.Uniform()``); biases
#: and beta 0, gamma 1 (their keywords' defaults)
INIT_SCALE = 0.07

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


#: per thread: the records the open :func:`recording_draws` fill
_DRAWS = threading.local()


@contextlib.contextmanager
def recording_draws(snapshot: bool = False):
    """Within the block, each layer that notes a draw or an in-place
    write on this thread (:func:`note_draw`, :func:`note_writes`) is
    recorded once, in first-seen order: yields a dict ``id(module) ->
    (module, generator or None, the generator's state before the layer's
    first draw or None, ((tensor, its copy from before the layer's first
    write), ...))``; the copies are taken only with ``snapshot``, else
    that entry is empty. Blocks nest; each records what happens inside
    it."""
    rec: dict = {}
    if not hasattr(_DRAWS, "stack"):
        _DRAWS.stack = []
    _DRAWS.stack.append((rec, snapshot))
    try:
        yield rec
    finally:
        _DRAWS.stack = [r for r in _DRAWS.stack if r[0] is not rec]


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
    _note(module, generator, ())


def note_writes(module: nn.Module, tensors):
    """``module`` is about to write ``tensors`` in place (a BatchNorm
    its running statistics), or would in training mode."""
    _note(module, None, tuple(tensors))


def _note(module, generator, writes):
    for rec, snapshot in getattr(_DRAWS, "stack", ()):
        if id(module) not in rec:
            rec[id(module)] = (
                module, generator,
                None if generator is None else generator.get_state(),
                tuple((t, t.detach().clone()) for t in writes)
                if snapshot else ())


def keep_mask(like, rate: float, generator: Optional[torch.Generator]):
    """A boolean mask of ``like``'s shape, each element True with
    probability 1 - ``rate`` (drawn from ``generator``)."""
    return torch.bernoulli(
        torch.full(like.shape, 1.0 - rate, device=like.device),
        generator=generator).to(torch.bool)


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout: ``x / (1 - rate)`` where :func:`keep_mask`
    keeps, 0 elsewhere."""
    return torch.where(keep_mask(x, rate, generator), x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


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
               lr_mult: float = 1.0, wd_mult: float = 1.0,
               init=None) -> nn.Parameter:
    """Give ``p`` the JAX package's Parameter attributes (``grad_req``,
    ``lr_mult``, ``wd_mult``, ``fresh_grad``, and ``init``: the
    initializer a layer keyword named for it, None for the module-wide
    one of ``gluon.block.initialize``); returns ``p``. ``p`` counts as
    not yet initialized (``initialize`` without ``force_reinit`` writes
    it)."""
    p.lr_mult = lr_mult
    p.wd_mult = wd_mult
    p.init = init
    p.initialized = False
    set_grad_req(p, grad_req)
    return p


def _param(name, shape, device, init=None, generator=None,
           grad_req="write"):
    """A float32 parameter on ``device`` recording ``init``: its initial
    value is ``init``'s (``initializer.create(init)._init_weight``, as
    the JAX package's explicit initializer, no suffix rules) or, with
    ``init`` None, uniform in [-INIT_SCALE, INIT_SCALE] (the JAX
    package's default ``Uniform()``); draws from ``generator``."""
    if init is None:
        t = torch.empty(shape, dtype=torch.float32)
        t.uniform_(-INIT_SCALE, INIT_SCALE, generator=generator)
    else:
        t = initializer.create(init)._init_weight(
            name, shape, torch.float32, generator)
    return init_param(nn.Parameter(t.to(device)), grad_req, init=init)


class Sequential(nn.Module):
    """Children run one after another, each on the output of the one
    before; extra arguments go to the first child only. Children are
    named ``0``, ``1``, ... in the order :meth:`add` gave them."""

    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)
        return self

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(Sequential):
    """:class:`Sequential` (the JAX package's hybridizable one; the port
    has one kind of block)."""


class Dense(nn.Module):
    """Fully-connected layer: ``act(x W^T + b)``. ``flatten`` collapses
    the trailing axes of a >2-d input first."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, flatten: bool = True,
                 in_units: int = 0, device=None,
                 generator: Optional[torch.Generator] = None,
                 weight_initializer=None, bias_initializer="zeros"):
        super().__init__()
        if in_units <= 0:
            raise MXNetError("Dense needs in_units (shapes are not "
                             "inferred at the first call)")
        dev = resolve_device(device)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = _param("weight", (units, in_units), dev,
                             weight_initializer, generator)
        self.bias = _param("bias", (units,), dev, bias_initializer,
                           generator) if use_bias else None

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
        return dropout(x, self._rate, self._generator)


class Embedding(nn.Module):
    """Embedding lookup. Out-of-range ids clamp to the nearest row, as in
    the JAX package (``jnp.take(mode="clip")``)."""

    def __init__(self, input_dim: int, output_dim: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 weight_initializer=None):
        super().__init__()
        dev = resolve_device(device)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = _param("weight", (input_dim, output_dim), dev,
                             weight_initializer, generator)

    def forward(self, x):
        idx = x.to(torch.long).clamp(0, self._input_dim - 1)
        return F.embedding(idx, self.weight)


class LayerNorm(nn.Module):
    """LayerNorm over ``axis`` (float32 statistics, output in x's dtype);
    the trailing axis goes through the LayerNorm kernel."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-5,
                 in_channels: int = 0, device=None,
                 beta_initializer="zeros", gamma_initializer="ones"):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("LayerNorm needs in_channels (shapes are not "
                             "inferred at the first call)")
        dev = resolve_device(device)
        self._axis = axis
        self._eps = epsilon
        self.gamma = _param("gamma", (in_channels,), dev, gamma_initializer)
        self.beta = _param("beta", (in_channels,), dev, beta_initializer)

    def forward(self, x):
        return invoke("layer_norm", self._norm, x, self.gamma, self.beta)

    def _norm(self, x, gamma, beta):
        return FNN.layer_norm(x, gamma, beta, axis=self._axis,
                              eps=self._eps)


class BatchNorm(nn.Module):
    """Batch normalisation over ``axis`` (the channels): float32
    statistics whatever x's dtype, the output in x's dtype.

    In training mode (the module's, outside :func:`draws_off`; never
    with ``use_global_stats``) it normalises with the batch's mean and
    biased variance and writes ``running = momentum * running + (1 -
    momentum) * batch`` into ``running_mean`` / ``running_var`` in place,
    with no gradient; otherwise it normalises with the running
    statistics and writes nothing. The running statistics are
    parameters with ``grad_req="null"`` (as the JAX package's), so
    ``named_parameters()``, the parameter files, the checkpoints and
    ``load_jax_params`` carry them; ``Trainer`` leaves them out of the
    update. ``center=False`` / ``scale=False`` keep ``beta`` / ``gamma``
    frozen at 0 / 1.

    Under a dp mesh whose step split the batch (``parallel.split_batch``:
    ``compile_step``'s ``zero`` and ``mesh`` modes), the training
    statistics are the global batch's: all-reduced over the ranks in
    float32 (``ops.nn.batch_norm_train_sync``), the backward's two sums
    too, so every rank normalises as the JAX package's one program does
    and writes bit-identical running statistics. A batch each rank holds
    whole, and one process, take the local ops."""

    def __init__(self, axis: int = 1, momentum: float = 0.9,
                 epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, use_global_stats: bool = False,
                 in_channels: int = 0, device=None,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones"):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("BatchNorm needs in_channels (shapes are not "
                             "inferred at the first call)")
        dev = resolve_device(device)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._use_global_stats = use_global_stats
        c = (in_channels,)
        self.gamma = _param("gamma", c, dev, gamma_initializer,
                            grad_req="write" if scale else "null")
        self.beta = _param("beta", c, dev, beta_initializer,
                           grad_req="write" if center else "null")
        self.running_mean = _param("running_mean", c, dev,
                                   running_mean_initializer,
                                   grad_req="null")
        self.running_var = _param("running_var", c, dev,
                                  running_variance_initializer,
                                  grad_req="null")

    def forward(self, x):
        if self._axis != 1:
            x = x.transpose(1, self._axis)
        if self._use_global_stats:
            train = False
        else:
            note_writes(self, (self.running_mean, self.running_var))
            train = drawing(self)
        if not train:
            out = invoke("batch_norm", self._infer, x, self.gamma,
                         self.beta, self.running_mean, self.running_var)
        else:
            mesh = split_mesh()
            body = self._train if mesh is None else functools.partial(
                self._train_sync, group=mesh.group)
            out, mean, var = invoke("batch_norm", body, x, self.gamma,
                                    self.beta)
            m = self._momentum
            with torch.no_grad():
                for run, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                    run.mul_(m).add_(batch.to(run.dtype), alpha=1.0 - m)
        if self._axis != 1:
            out = out.transpose(1, self._axis)
        return out

    def _infer(self, x, gamma, beta, mean, var):
        return FNN.batch_norm_infer(x, gamma, beta, mean, var, self._eps)

    def _train(self, x, gamma, beta):
        return FNN.batch_norm_train(x, gamma, beta, self._eps)

    def _train_sync(self, x, gamma, beta, group):
        return FNN.batch_norm_train_sync(x, gamma, beta, self._eps, group)


class SyncBatchNorm(BatchNorm):
    """:class:`BatchNorm` under MXNet's cross-device name, with its
    signature (``in_channels``, ``num_devices``; the JAX package's
    ``gluon/nn/basic_layers.py`` ``SyncBatchNorm``). Every ``BatchNorm``
    here already takes its training statistics over the ranks that hold
    a split batch between them (``parallel.split_batch``), as the JAX
    package's one SPMD program does, so this layer adds nothing; on one
    process it is ``BatchNorm``. ``num_devices`` is kept, not used: the
    ranks are the split batch's."""

    def __init__(self, in_channels: int = 0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class BatchNormReLU(BatchNorm):
    """:class:`BatchNorm` followed by a ReLU."""

    def forward(self, x):
        return torch.relu(super().forward(x))


class Flatten(nn.Module):
    """Collapse every axis but the first: (N, ...) -> (N, -1)."""

    def forward(self, x):
        return x.reshape(x.shape[0] if x.ndim else 1, -1)


class Activation(nn.Module):
    """``activation(x, act_type)`` as a layer."""

    def __init__(self, activation: str):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise MXNetError(f"unknown Activation act_type {activation!r}")
        self._act_type = activation

    def forward(self, x):
        return activation(x, self._act_type)

    def extra_repr(self):
        return self._act_type


class Identity(nn.Module):
    def forward(self, x):
        return x


class _Norm(nn.Module):
    """``gamma`` / ``beta`` a channel, frozen (``grad_req="null"``) at 1
    / 0 with ``scale=False`` / ``center=False``."""

    def __init__(self, what, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, device):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError(f"{what} needs in_channels (shapes are not "
                             "inferred at the first call)")
        dev = resolve_device(device)
        self._eps = epsilon
        c = (in_channels,)
        self.gamma = _param("gamma", c, dev, gamma_initializer,
                            grad_req="write" if scale else "null")
        self.beta = _param("beta", c, dev, beta_initializer,
                           grad_req="write" if center else "null")


class GroupNorm(_Norm):
    """GroupNorm over ``num_groups`` groups of axis 1's channels
    (``ops.nn.group_norm``: float32 statistics, the output in x's
    dtype)."""

    def __init__(self, num_groups: int = 1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, device=None):
        super().__init__("GroupNorm", epsilon, center, scale,
                         beta_initializer, gamma_initializer, in_channels,
                         device)
        self._ngroups = num_groups

    def forward(self, x):
        return invoke("group_norm", self._norm, x, self.gamma, self.beta)

    def _norm(self, x, gamma, beta):
        return FNN.group_norm(x, gamma, beta, self._ngroups, self._eps)


class InstanceNorm(_Norm):
    """InstanceNorm: each sample's channel ``axis`` normalised over the
    other axes but the batch's (``ops.nn.instance_norm``). ``scale``
    defaults to False (gamma frozen at 1), as in the JAX package."""

    def __init__(self, axis: int = 1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, device=None):
        super().__init__("InstanceNorm", epsilon, center, scale,
                         beta_initializer, gamma_initializer, in_channels,
                         device)
        self._axis = axis

    def forward(self, x):
        if self._axis != 1:
            x = x.transpose(1, self._axis)
        out = invoke("instance_norm", self._norm, x, self.gamma, self.beta)
        if self._axis != 1:
            out = out.transpose(1, self._axis)
        return out

    def _norm(self, x, gamma, beta):
        return FNN.instance_norm(x, gamma, beta, self._eps)


def _leaky(x, slope):
    return torch.where(x > 0, x, slope * x)


class LeakyReLU(nn.Module):
    """``x`` where positive, ``alpha * x`` elsewhere."""

    def __init__(self, alpha: float = 0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return invoke("leaky_relu", functools.partial(
            _leaky, slope=self._alpha), x)


class PReLU(nn.Module):
    """LeakyReLU with a learned slope ``alpha`` (``in_channels`` values,
    broadcast against x's last axis; 0.25 each unless
    ``alpha_initializer`` says otherwise)."""

    def __init__(self, alpha_initializer="constant", in_channels: int = 1,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        init = initializer.Constant(0.25) \
            if alpha_initializer == "constant" else alpha_initializer
        self.alpha = _param("alpha", (in_channels,), dev, init)

    def forward(self, x):
        return invoke("prelu", _leaky, x, self.alpha)


class ELU(nn.Module):
    """``x`` where positive, ``alpha * (exp(x) - 1)`` elsewhere."""

    def __init__(self, alpha: float = 1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return invoke("elu", functools.partial(F.elu, alpha=self._alpha), x)


class SELU(nn.Module):
    """The scaled ELU of Klambauer et al. 2017."""

    def forward(self, x):
        return invoke("selu", torch.selu, x)


class GELU(nn.Module):
    """GELU, ``approximation`` "erf" (exact) or "tanh" (MXNet's meaning;
    module docstring)."""

    def __init__(self, approximation: str = "erf"):
        super().__init__()
        if approximation not in ("erf", "tanh"):
            raise MXNetError("GELU approximation must be 'erf' or 'tanh', "
                             f"got {approximation!r}")
        self._approx = approximation

    def forward(self, x):
        if self._approx == "tanh":
            return invoke("gelu_tanh", _ACTIVATIONS["gelu_tanh"], x)
        return invoke("gelu", F.gelu, x)


class Swish(nn.Module):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


SiLU = Swish


def _function(function):
    """A callable, or the op a name gives: the port's ``ndarray`` ops
    first, then torch's."""
    if not isinstance(function, str):
        return function
    from ... import ndarray
    fn = getattr(ndarray, function, None) or getattr(torch, function, None)
    if fn is None:
        raise MXNetError(f"Lambda: no op named {function!r}")
    return fn


class Lambda(nn.Module):
    """A function (or the name of an op) as a layer."""

    def __init__(self, function):
        super().__init__()
        self._func = _function(function)

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(Lambda):
    """:class:`Lambda` (the port has one kind of block)."""


class Concatenate(Sequential):
    """Children run on the same input; their outputs concatenated on
    ``axis``."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return torch.cat([block(x) for block in self._modules.values()],
                         dim=self._axis)


class HybridConcatenate(Concatenate):
    """:class:`Concatenate` (the port has one kind of block)."""
