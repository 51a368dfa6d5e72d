"""Package-wide error type (counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Error raised by the framework for invalid use: a missing device, a
    shape or dtype a kernel does not take, a bad request."""
