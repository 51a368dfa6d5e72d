"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``; this slice
ports BERT)."""
from . import bert

__all__ = ["bert"]
