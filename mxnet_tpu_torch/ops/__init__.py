"""Operators (counterpart of ``mxnet_tpu/ops``): attention, layer ops and
the CUDA kernel layer (:mod:`.kernels`)."""
