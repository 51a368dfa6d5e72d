"""Layers (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import (ELU, GELU, SELU, Activation, BatchNorm,
                           BatchNormReLU, Concatenate, Dense, Dropout,
                           Embedding, Flatten, GroupNorm, HybridConcatenate,
                           HybridLambda, HybridSequential, Identity,
                           InstanceNorm, Lambda, LayerNorm, LeakyReLU, PReLU,
                           Sequential, SiLU, Swish, SyncBatchNorm, init_param,
                           set_grad_req)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D, Conv2D,
                          Conv3D, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "BatchNormReLU", "SyncBatchNorm", "LayerNorm", "Flatten", "Activation",
           "Identity", "init_param", "set_grad_req", "GroupNorm",
           "InstanceNorm", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish", "SiLU", "Lambda", "HybridLambda", "Concatenate",
           "HybridConcatenate",
           "Conv1D", "Conv2D", "Conv3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "MultiHeadAttention", "PositionwiseFFN", "TransformerEncoder",
           "TransformerEncoderCell"]
