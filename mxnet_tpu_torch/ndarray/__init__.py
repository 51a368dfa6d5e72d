"""Arrays (counterpart of ``mxnet_tpu.ndarray``'s ``save`` and ``load``,
of its sequence ops and of the detection ops of its ``contrib``); the
port's arrays are ``torch.Tensor``s."""
from . import contrib, ops
from .contrib import (MultiBoxDetection, MultiBoxPrior, MultiBoxTarget,
                      ROIAlign, box_iou, box_nms)
from .ops import SequenceMask, SequenceReverse, sequence_mask
from .utils import load, save

__all__ = ["save", "load", "ops", "contrib", "SequenceMask",
           "SequenceReverse", "sequence_mask", "box_iou", "box_nms",
           "ROIAlign", "MultiBoxPrior", "MultiBoxTarget",
           "MultiBoxDetection"]
