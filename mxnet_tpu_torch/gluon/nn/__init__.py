"""Layers (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import (Dense, Dropout, Embedding, LayerNorm, init_param,
                           set_grad_req)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "init_param",
           "set_grad_req", "MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoder", "TransformerEncoderCell"]
