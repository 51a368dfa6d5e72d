"""Weights carried across packages.

A module of this package and its JAX counterpart name their parameters
alike (``bert.encoder.layer0.attention.query_proj.weight``,
``bert.embed_ln.gamma``, ``classifier.bias``), so one dict of numpy
arrays feeds both: the JAX package's ``collect_params()`` ``set_data``
and :func:`load_jax_params` here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..base import MXNetError

__all__ = ["load_jax_params", "init_params_numpy"]

#: std of the normal initial weights of :func:`init_params_numpy`
INIT_STD = 0.02


def load_jax_params(module: nn.Module, params: Dict[str, np.ndarray]) -> None:
    """Copy ``params`` (keys as the JAX package's ``collect_params()``
    names them) into ``module``'s parameters, on their device and in
    their dtype (each then counts as initialized:
    ``gluon.block.initialize`` leaves it unless ``force_reinit``). Raises
    on a missing, extra or mis-shaped key."""
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError(f"load_jax_params: missing keys {missing}, "
                         f"unexpected keys {extra}")
    for name, p in own.items():
        value = np.asarray(params[name])
        if tuple(value.shape) != tuple(p.shape):
            raise MXNetError(f"load_jax_params: {name} has shape "
                             f"{tuple(value.shape)}, the module expects "
                             f"{tuple(p.shape)}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(torch.from_numpy(np.ascontiguousarray(params[name])))
            p.initialized = True


def init_params_numpy(module: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """A seeded float32 numpy dict under ``module``'s parameter names:
    LayerNorm ``gamma`` 1 and ``beta`` 0, every other parameter normal
    with std 0.02, drawn in the modules' registration order."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(".gamma"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(".beta"):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = (rng.standard_normal(shape) * INIT_STD) \
                .astype(np.float32)
    return out
