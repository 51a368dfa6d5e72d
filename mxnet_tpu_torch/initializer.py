"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

An initializer gives the initial value of a parameter from its name,
shape and dtype. :meth:`Initializer.init_array` applies the JAX package's
name-suffix rules first (a name ending in ``bias``, ``beta``,
``running_mean`` or ``moving_mean`` is 0; ``gamma``, ``running_var`` or
``moving_var`` is 1), then :meth:`Initializer._init_weight`. Each is
registered under the JAX package's lowercase names, so ``"xavier"`` and
``create("msraprelu")`` work as there.

A random initializer draws from the ``torch.Generator`` it is given (on
the generator's device; without one, from the CPU's default generator)
and the value moves to the parameter's device. The bits differ from the
JAX package's keys; the laws and the scales, from the same fans, are
the same. Carrying weights across packages is
``gluon.params.load_jax_params``'s job.

:func:`gluon.block.initialize` is the counterpart of
``Block.initialize``: it writes a module's parameters in place.
"""
from __future__ import annotations

import math
import re
from typing import Optional

import numpy as np
import torch

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "Load", "registry", "create"]

registry = {}


def _register(name):
    def deco(cls):
        registry[name.lower()] = cls
        return cls
    return deco


class InitDesc(str):
    """A parameter's name (a str) carrying its ``attrs`` and a fallback
    ``global_init``."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _draw(shape, generator, fill):
    """A float32 tensor of ``shape`` on ``generator``'s device (the CPU
    without one), filled in place by ``fill(t, generator)``."""
    dev = generator.device if generator is not None else "cpu"
    t = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    fill(t, generator)
    return t


class Initializer:
    """Base initializer. A subclass implements :meth:`_init_weight`."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name_or_arr, arr: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        """``init(name, tensor)`` or ``init(tensor)``: writes the
        initial value into ``tensor`` in place and returns it."""
        if arr is None:
            name, arr = "", name_or_arr
        else:
            name = str(name_or_arr)
        with torch.no_grad():
            arr.copy_(self.init_array(name, arr.shape, arr.dtype,
                                      generator))
        return arr

    def init_array(self, name: str, shape, dtype=torch.float32,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """The initial value of parameter ``name``: the suffix rules,
        else :meth:`_init_weight`. On ``generator``'s device (the CPU
        without one)."""
        lname = name.lower()
        dev = generator.device if generator is not None else "cpu"
        if lname.endswith(("bias", "beta", "running_mean", "moving_mean")):
            return torch.zeros(tuple(shape), dtype=dtype, device=dev)
        if lname.endswith(("gamma", "running_var", "moving_var")):
            return torch.ones(tuple(shape), dtype=dtype, device=dev)
        return self._init_weight(name, shape, dtype, generator)

    def _init_weight(self, name, shape, dtype, generator=None):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@_register("zeros")
@_register("zero")
class Zero(Initializer):
    def _init_weight(self, name, shape, dtype, generator=None):
        return torch.zeros(tuple(shape), dtype=dtype)


@_register("ones")
@_register("one")
class One(Initializer):
    def _init_weight(self, name, shape, dtype, generator=None):
        return torch.ones(tuple(shape), dtype=dtype)


@_register("constant")
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, shape, dtype, generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype)


@_register("uniform")
class Uniform(Initializer):
    """Uniform in ``[-scale, scale]``."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, shape, dtype, generator=None):
        s = self.scale
        return _draw(shape, generator,
                     lambda t, g: t.uniform_(-s, s, generator=g)).to(dtype)


@_register("normal")
@_register("gaussian")
class Normal(Initializer):
    """Normal with mean 0 and standard deviation ``sigma``."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, shape, dtype, generator=None):
        s = self.sigma
        return _draw(shape, generator,
                     lambda t, g: t.normal_(0.0, s, generator=g)).to(dtype)


@_register("orthogonal")
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of the QR decomposition of
    a uniform (``rand_type="uniform"``) or normal random matrix, shaped
    (rows, the product of the other axes): its rows (or columns, the
    shorter side) orthonormal."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, shape, dtype, generator=None):
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        big, small = max(rows, cols), min(rows, cols)
        if self.rand_type == "uniform":
            tmp = _draw((big, small), generator,
                        lambda t, g: t.uniform_(-1.0, 1.0, generator=g))
        else:
            tmp = _draw((big, small), generator,
                        lambda t, g: t.normal_(generator=g))
        q, _ = torch.linalg.qr(tmp.cpu())
        q = q.T if rows < cols else q
        return (self.scale * q[:rows, :cols]).reshape(tuple(shape)) \
            .to(dtype)


@_register("xavier")
class Xavier(Initializer):
    """Glorot's initializer: uniform in ``[-s, s]`` or normal with std
    ``s``, ``s = sqrt(magnitude / factor)``, the factor the fans' mean
    (``"avg"``), fan-in (``"in"``) or fan-out (``"out"``); fan-in is
    axis 1 times the receptive field (axes 2...), fan-out axis 0 times
    it."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    @staticmethod
    def fans(shape):
        """``(fan_in, fan_out)`` of a weight of ``shape``."""
        hw = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
        return fan_in, shape[0] * hw

    def scale(self, shape) -> float:
        """The bound (uniform) or std (normal) for ``shape``."""
        fan_in, fan_out = self.fans(shape)
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError(f"bad factor_type {self.factor_type}")
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, shape, dtype, generator=None):
        s = self.scale(shape)
        if self.rnd_type == "uniform":
            fill = lambda t, g: t.uniform_(-s, s, generator=g)  # noqa
        else:
            fill = lambda t, g: t.normal_(0.0, s, generator=g)  # noqa
        return _draw(shape, generator, fill).to(dtype)


@_register("msraprelu")
class MSRAPrelu(Xavier):
    """He et al.'s initializer for PReLU nets: normal with magnitude
    ``2 / (1 + slope**2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@_register("bilinear")
class Bilinear(Initializer):
    """A bilinear upsampling kernel (for a transposed convolution's
    weight)."""

    def _init_weight(self, name, shape, dtype, generator=None):
        weight = np.zeros(shape, dtype="float32")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight).to(dtype)


@_register("lstmbias")
class LSTMBias(Initializer):
    """An LSTM bias: 0, and ``forget_bias`` on the forget gate's
    quarter."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, shape, dtype, generator=None):
        b = torch.zeros(tuple(shape), dtype=torch.float32)
        n = shape[0] // 4
        b[n:2 * n] = self.forget_bias
        return b.to(dtype)


class Mixed(Initializer):
    """The initializer of the first pattern (a regex, ``re.match``) that
    matches the parameter's name; that initializer's own suffix rules
    then apply."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise MXNetError("Mixed needs one initializer per pattern")
        self._map = [(re.compile(p), create(i))
                     for p, i in zip(patterns, initializers)]

    def init_array(self, name: str, shape, dtype=torch.float32,
                   generator=None) -> torch.Tensor:
        for pat, ini in self._map:
            if pat.match(name):
                return ini.init_array(name, shape, dtype, generator)
        raise MXNetError(
            f"no initializer pattern matched parameter {name!r}; add a "
            f"catch-all '.*' pattern")

    def _init_weight(self, name, shape, dtype, generator=None):
        return self.init_array(name, shape, dtype, generator)


class Load(Initializer):
    """Saved values by name (a dict of name -> tensor or array; an
    ``arg:`` / ``aux:`` prefix is dropped), ``default_init`` for a name
    not there. A saved value wins over the suffix rules."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        self._params = {k.split(":", 1)[-1]: v for k, v in param.items()}
        self._default = create(default_init) if default_init else None
        self._verbose = verbose

    def init_array(self, name: str, shape, dtype=torch.float32,
                   generator=None) -> torch.Tensor:
        if name in self._params:
            v = self._params[name]
            data = v.detach() if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(v))
            if tuple(data.shape) != tuple(shape):
                raise MXNetError(
                    f"Load: parameter {name!r} has shape "
                    f"{tuple(data.shape)} in the file but {tuple(shape)} "
                    "in the model")
            if self._verbose:
                print(f"Load: initialized {name} from saved array")
            return data.to(dtype, copy=True)
        if self._default is None:
            raise MXNetError(
                f"Load: no saved array for {name!r} and no default_init")
        return self._default.init_array(name, shape, dtype, generator)

    def _init_weight(self, name, shape, dtype, generator=None):
        return self.init_array(name, shape, dtype, generator)


def create(init, **kwargs) -> Initializer:
    """An initializer from a registered name (``kwargs`` to its
    constructor), an instance (as it is) or None (``Uniform()``)."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform()
    if isinstance(init, str):
        try:
            return registry[init.lower()](**kwargs)
        except KeyError as e:
            raise MXNetError(f"unknown initializer {init!r}") from e
    raise MXNetError(f"cannot create initializer from {init!r}")
