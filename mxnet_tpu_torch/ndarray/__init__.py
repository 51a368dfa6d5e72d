"""Arrays (counterpart of ``mxnet_tpu.ndarray``'s ``save`` and ``load``,
and of its sequence ops); the port's arrays are ``torch.Tensor``s."""
from . import ops
from .ops import SequenceMask, SequenceReverse, sequence_mask
from .utils import load, save

__all__ = ["save", "load", "ops", "SequenceMask", "SequenceReverse",
           "sequence_mask"]
