"""Gluon layers, models, losses and the Trainer (counterpart of
``mxnet_tpu/gluon``) as ``torch.nn.Module``s."""
from . import loss, model_zoo, nn, params, rnn
from .fused_step import CompiledTrainStep
from .gqa_decoder import GQADecoder
from .trainer import Trainer

__all__ = ["loss", "model_zoo", "nn", "params", "rnn", "Trainer",
           "CompiledTrainStep", "GQADecoder"]
