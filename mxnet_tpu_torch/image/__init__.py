"""Image decoding, resizing, rotation and augmenters (counterpart of
``mxnet_tpu/image``; its ``detection.py`` is not ported yet)."""
from .image import *  # noqa: F401,F403
from .image import __all__  # noqa: F401
