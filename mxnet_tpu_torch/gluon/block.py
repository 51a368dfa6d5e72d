"""Parameter files and initialization of a module (counterpart of the JAX
package's ``Block.save_parameters`` / ``load_parameters`` / ``load_dict``
/ ``initialize``, ``mxnet_tpu/gluon/block.py``).

The port's layers are plain ``torch.nn.Module``s, so these are
functions over a module. The file is ``ndarray.save``'s (the JAX
package's format), keyed by ``module.named_parameters()`` names, which
are the JAX package's ``collect_params()`` names: a file written by
either package loads into the other. Loading writes each parameter IN
PLACE, so a captured graph that reads it (``serving.CompiledPredictor``,
``serving.DecodeEngine``) replays on the new weights without a new
capture. :func:`initialize` writes in place too.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..base import MXNetError
from ..ndarray import utils as nd_utils

__all__ = ["save_parameters", "load_parameters", "load_dict", "initialize"]


def initialize(module: nn.Module, init=None, ctx=None, verbose=False,
               force_reinit: bool = False,
               generator: Optional[torch.Generator] = None) -> None:
    """Write the initial value of each parameter of ``module``, IN PLACE
    (its storage, device, dtype and gradient hooks stay, so a captured
    graph that reads it replays on the new value), as the JAX package's
    ``Block.initialize``: a parameter with its own initializer (a layer
    keyword, ``p.init``) takes that initializer's ``_init_weight``; any
    other takes ``init``'s (``initializer.create``; None: ``Uniform()``)
    ``init_array``, with the name-suffix rules, under its own name (the
    last part of its path, as the JAX Parameter's). A parameter already
    initialized (by an earlier call, or loaded: ``load_dict``,
    ``params.load_jax_params``) is left as it is unless
    ``force_reinit``. Random values come from ``generator`` (the CPU's
    default one without it). ``ctx`` and ``verbose`` are taken, as
    there, and not used: parameters stay on their devices."""
    from ..initializer import create
    default = create(init)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if getattr(p, "initialized", False) and not force_reinit:
                continue
            pname = name.rsplit(".", 1)[-1]
            own = getattr(p, "init", None)
            if own is not None:
                value = create(own)._init_weight(pname, tuple(p.shape),
                                                 p.dtype, generator)
            else:
                value = default.init_array(pname, tuple(p.shape), p.dtype,
                                           generator)
            p.copy_(value)
            p.initialized = True


def save_parameters(module: nn.Module, filename: str) -> None:
    """Save every parameter of ``module`` to ``filename`` (a parameter
    shared by several modules is saved once, under its first name)."""
    nd_utils.save(filename, {k: p.detach()
                             for k, p in module.named_parameters()})


def load_parameters(module: nn.Module, filename: str,
                    allow_missing: bool = False, ignore_extra: bool = False,
                    cast_dtype: bool = False,
                    dtype_source: str = "current") -> None:
    """Load ``filename`` into ``module``'s parameters, in place, on their
    own devices. See :func:`load_dict`."""
    load_dict(module, nd_utils.load_host(filename),
              allow_missing=allow_missing, ignore_extra=ignore_extra,
              cast_dtype=cast_dtype, dtype_source=dtype_source,
              what=filename)


def load_dict(module: nn.Module, param_dict: Dict[str, torch.Tensor],
              allow_missing: bool = False,
              ignore_extra: bool = False, cast_dtype: bool = False,
              dtype_source: str = "current", what: str = "param_dict"
              ) -> None:
    """Load a dict of name -> tensor into ``module``'s parameters, in
    place (``arg:`` / ``aux:`` key prefixes of MXNet 1.x files are
    stripped). A saved dtype other than the parameter's needs
    ``cast_dtype``: ``dtype_source="current"`` casts the saved values to
    the parameter's dtype, ``"saved"`` gives the parameter the saved
    dtype (a new storage: a captured graph of it captures again). A
    missing parameter raises unless ``allow_missing``, an extra key
    unless ``ignore_extra``, a shape mismatch always. Nothing is written
    unless every check passes."""
    if dtype_source not in ("current", "saved"):
        raise MXNetError("dtype_source must be 'current' or 'saved', "
                         f"got {dtype_source!r}")
    loaded = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
              for k, v in param_dict.items()}
    params = dict(module.named_parameters())
    todo = []
    for k, p in params.items():
        if k not in loaded:
            if not allow_missing:
                raise MXNetError(
                    f"Parameter '{k}' is missing in {what}. Set "
                    "allow_missing=True to ignore missing parameters.")
            continue
        v = loaded[k]
        if tuple(v.shape) != tuple(p.shape):
            raise MXNetError(
                f"Parameter '{k}' has shape {tuple(p.shape)}, {what} "
                f"holds {tuple(v.shape)}")
        if v.dtype != p.dtype and not cast_dtype:
            raise MXNetError(
                f"Parameter '{k}' is {p.dtype}, {what} holds {v.dtype}; "
                "set cast_dtype=True to load it cast")
        todo.append((p, v))
    if not ignore_extra:
        extra = set(loaded) - set(params)
        if extra:
            raise MXNetError(
                f"{what} contains extra parameters {sorted(extra)}; set "
                "ignore_extra=True to ignore them.")
    with torch.no_grad():
        for p, v in todo:
            if dtype_source == "saved" and v.dtype != p.dtype:
                p.data = v.to(p.device, copy=True)
            else:
                p.copy_(v)
            p.initialized = True
