"""Recurrent layers (counterpart of ``mxnet_tpu/gluon/rnn``; this slice
ports the fused ``RNN``, ``LSTM`` and ``GRU``)."""
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU"]
