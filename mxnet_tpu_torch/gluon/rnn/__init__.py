"""Recurrent layers and cells (counterpart of ``mxnet_tpu/gluon/rnn``):
the fused ``RNN``, ``LSTM`` and ``GRU`` layers and the cells of
``rnn_cell.py``."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, HybridSequentialRNNCell,
                       LSTMCell, ModifierCell, RecurrentCell, ResidualCell,
                       RNNCell, SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "RNN", "LSTM", "GRU"]
