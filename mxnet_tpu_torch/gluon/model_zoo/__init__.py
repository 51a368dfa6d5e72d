"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``; ports BERT
and the LSTM word language model)."""
from . import bert, word_lm

__all__ = ["bert", "word_lm"]
