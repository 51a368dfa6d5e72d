"""Gluon layers and models (counterpart of ``mxnet_tpu/gluon``) as
``torch.nn.Module``s."""
from . import model_zoo, nn, params

__all__ = ["model_zoo", "nn", "params"]
