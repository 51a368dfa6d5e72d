"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``; ports BERT,
the LSTM word language model and the vision zoo's ResNets).
``get_model(name, **kwargs)`` is the vision zoo's, as there."""
from . import bert, vision, word_lm
from .vision import get_model

__all__ = ["bert", "vision", "word_lm", "get_model"]
