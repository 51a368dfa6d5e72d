"""The op funnel (counterpart of ``mxnet_tpu/ops/registry.py``'s
``invoke_raw`` and its invoke wrappers).

The JAX package sends every imperative op through one funnel, where
cross-cutting hooks (``amp``'s dtype casts, profiling) wrap the op's
function by the op's name. The port has no NDArray and no tape: PyTorch's
autograd records the op. What stays is the hook point. The layers call
:func:`invoke` at the call sites the JAX package funnels, under the JAX
package's names (``"fully_connected"``, ``"flash_attention"``,
``"layer_norm"``, ``"log_softmax"``, ``f"rnn_{mode}"``, ...), so a wrapper
sees the same sequence of names in both packages.

A wrapper is ``wrapper(name, fn) -> fn'``, applied in the order added (the
last one added is outermost). With no wrapper installed :func:`invoke`
only calls ``fn``; a wrapper is a Python call around the op and adds no
kernel launch.
"""
from __future__ import annotations

from typing import Callable, List

__all__ = ["invoke", "add_invoke_wrapper", "remove_invoke_wrapper"]

_INVOKE_WRAPPERS: List[Callable] = []


def add_invoke_wrapper(wrapper: Callable) -> None:
    _INVOKE_WRAPPERS.append(wrapper)


def remove_invoke_wrapper(wrapper: Callable) -> None:
    if wrapper in _INVOKE_WRAPPERS:
        _INVOKE_WRAPPERS.remove(wrapper)


def invoke(name: str, fn: Callable, *inputs, **kwargs):
    """``fn(*inputs, **kwargs)`` through the installed wrappers."""
    for w in _INVOKE_WRAPPERS:
        fn = w(name, fn)
    return fn(*inputs, **kwargs)
