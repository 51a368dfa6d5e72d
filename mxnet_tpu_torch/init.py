"""``mxnet_tpu_torch.init``: the initializers under their other name (the
JAX package exposes them both ways)."""
from .initializer import *  # noqa: F401,F403
from .initializer import __all__  # noqa: F401
