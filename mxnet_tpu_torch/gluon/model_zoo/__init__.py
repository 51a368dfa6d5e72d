"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``; ports BERT,
the LSTM word language model and the vision zoo's ResNets)."""
from . import bert, vision, word_lm

__all__ = ["bert", "vision", "word_lm"]
