"""Data parallelism over ``torch.distributed`` (counterpart of
``mxnet_tpu/parallel``): joining the job (:mod:`.dist`), the mesh over
the process group (:mod:`.mesh`) and its collectives
(:mod:`.collectives`), and gradient compression (:mod:`.compression`)."""
from . import collectives, compression, dist, mesh
from .collectives import (allgather, allgather_bucketed, allreduce,
                          broadcast_axis, reduce_scatter,
                          reduce_scatter_bucketed)
from .compression import GradientCompression
from .mesh import (DeviceMesh, current_mesh, data_parallel_mesh, make_mesh,
                   place_on_mesh, replicate, shard_batch, split_batch,
                   zero_shard_pad)

__all__ = ["collectives", "compression", "dist", "mesh",
           "GradientCompression", "DeviceMesh", "make_mesh",
           "current_mesh", "data_parallel_mesh", "shard_batch",
           "place_on_mesh", "replicate", "split_batch", "zero_shard_pad", "allreduce",
           "allgather", "reduce_scatter", "broadcast_axis",
           "reduce_scatter_bucketed", "allgather_bucketed"]
