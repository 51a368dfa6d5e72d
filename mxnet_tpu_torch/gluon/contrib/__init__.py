"""gluon.contrib (counterpart of ``mxnet_tpu/gluon/contrib``): the
contrib recurrent cells (``rnn``), layers (``nn``) and the ``estimator``.
``cnn`` (the deformable convolution) and ``data`` (WikiText, whose files
are not in the repo) are not ported yet (``ROADMAP.md`` queue 1)."""
from . import estimator, nn, rnn

__all__ = ["estimator", "nn", "rnn"]
