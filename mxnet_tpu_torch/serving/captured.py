"""Serving's captured programs: :mod:`mxnet_tpu_torch.captured`, which
the compiled train step shares, under the names serving has always
exported."""
from ..captured import WARMUP_RUNS, CapturedProgram, Programs, map_tensors

__all__ = ["CapturedProgram", "Programs", "map_tensors", "WARMUP_RUNS"]
