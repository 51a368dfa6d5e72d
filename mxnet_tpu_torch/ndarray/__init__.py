"""Array files (counterpart of ``mxnet_tpu.ndarray``'s ``save`` and
``load``); the port's arrays are ``torch.Tensor``s."""
from .utils import load, save

__all__ = ["save", "load"]
