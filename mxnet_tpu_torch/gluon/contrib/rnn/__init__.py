"""Contrib recurrent cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn``)."""
from .conv_rnn_cell import (Conv1DGRUCell, Conv1DLSTMCell, Conv1DRNNCell,
                            Conv2DGRUCell, Conv2DLSTMCell, Conv2DRNNCell,
                            Conv3DGRUCell, Conv3DLSTMCell, Conv3DRNNCell)
from .rnn_cell import LSTMPCell, VariationalDropoutCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
           "VariationalDropoutCell", "LSTMPCell"]
