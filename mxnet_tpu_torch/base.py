"""Package-wide error type and data root (counterpart of
``mxnet_tpu/base.py``)."""
from __future__ import annotations

import os

__all__ = ["MXNetError", "data_dir"]


class MXNetError(RuntimeError):
    """Error raised by the framework for invalid use: a missing device, a
    shape or dtype a kernel does not take, a bad request."""


def data_dir() -> str:
    """Root of datasets and model files: ``MXNET_HOME``, else
    ``~/.mxnet`` (MXNet's ``base.data_dir``)."""
    return os.path.expanduser(os.environ.get(
        "MXNET_HOME", os.path.join("~", ".mxnet")))
