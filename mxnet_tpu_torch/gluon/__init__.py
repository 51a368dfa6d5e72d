"""Gluon layers, models, losses and the Trainer (counterpart of
``mxnet_tpu/gluon``) as ``torch.nn.Module``s."""
from . import block, contrib, data, loss, model_zoo, nn, params, rnn
from .block import initialize, load_dict, load_parameters, save_parameters
from .fused_step import CompiledTrainStep, TrainLoop
from .gqa_decoder import GQADecoder
from .trainer import Trainer
from . import utils
from .utils import clip_global_norm, split_and_load, split_data

__all__ = ["block", "contrib", "data", "loss", "model_zoo", "nn", "params",
           "rnn", "Trainer",
           "CompiledTrainStep", "TrainLoop", "GQADecoder",
           "save_parameters", "load_parameters", "load_dict", "initialize",
           "utils", "split_data", "split_and_load", "clip_global_norm"]
