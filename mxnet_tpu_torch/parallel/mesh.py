"""The device mesh over the process group (counterpart of
``mxnet_tpu/parallel/mesh.py``).

The JAX package's mesh is N devices driven by one process. Here it is a
world of N ranks, one process and one device each (:mod:`.dist`):
``make_mesh({"dp": N})`` wraps the default process group, whose size
must be N, and rank r is coordinate r on the axis. A tensor a rank holds
is its own part of the logical array: :func:`shard_batch` and
:func:`place_on_mesh` keep rank r's contiguous 1/N of a global batch's
leading axis when it divides by N, and the whole array otherwise (the
JAX package's "shard dim 0 when divisible, else replicate").
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError
from . import dist as _dist

__all__ = ["DeviceMesh", "make_mesh", "current_mesh", "data_parallel_mesh",
           "shard_batch", "place_on_mesh", "batch_is_sharded", "replicate",
           "zero_shard_pad", "carry_placement", "global_lead", "split_batch",
           "split_mesh"]

_state = threading.local()


class DeviceMesh:
    """Named axes over the ranks of a process group. Every collective of
    :mod:`.collectives` runs along an axis that spans the whole group
    (this slice's meshes are one axis of size N, or N x 1)."""

    def __init__(self, axes: Dict[str, int], group=None):
        self._axes = dict(axes)
        self.group = group

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._axes)

    @property
    def size(self) -> int:
        return int(np.prod(list(self._axes.values()))) if self._axes else 1

    @property
    def rank(self) -> int:
        """This process's coordinate along the mesh's non-trivial axis."""
        return dist.get_rank(self.group) if _dist.is_initialized() else 0

    def axis_size(self, axis: str) -> int:
        if axis not in self._axes:
            raise MXNetError(f"mesh has no axis {axis!r}; axes: "
                             f"{self.axis_names}")
        return int(self._axes[axis])

    def check_axis(self, axis: str) -> int:
        """The size of ``axis``, which must span the whole group."""
        n = self.axis_size(axis)
        if n != self.size:
            raise MXNetError(f"axis {axis!r} of {self.shape} does not span "
                             "the process group (one non-trivial axis)")
        return n

    def __enter__(self):
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()

    def __repr__(self):
        return f"DeviceMesh({self.shape})"


def make_mesh(axes: Dict[str, int], group=None) -> DeviceMesh:
    """A mesh from axis name -> size over the default process group (or
    ``group``). Sizes multiply to the group's size; one -1 is inferred.
    A mesh of size 1 needs no group."""
    world = dist.get_world_size(group) if _dist.is_initialized() else 1
    names, sizes = list(axes), list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    total = int(np.prod(sizes))
    if total != world:
        raise MXNetError(
            f"mesh {dict(zip(names, sizes))} needs {total} ranks but the "
            f"process group has {world}")
    return DeviceMesh(dict(zip(names, sizes)), group)


def data_parallel_mesh(num_devices: Optional[int] = None) -> DeviceMesh:
    return make_mesh({"dp": num_devices or _dist.size()})


def current_mesh() -> Optional[DeviceMesh]:
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


def _divides(d, n: int) -> bool:
    return getattr(d, "ndim", 0) >= 1 and d.shape[0] > 0 \
        and d.shape[0] % n == 0


#: the attribute a rank's part of a global batch carries: (mesh, axis,
#: the global leading size), so placing it again passes it through
_PLACED = "_mxt_placed"


def _placed(d, mesh, axis):
    p = getattr(d, _PLACED, None)
    return p if p is not None and p[0] is mesh and p[1] == axis else None


def place_on_mesh(mesh: DeviceMesh, axis: str, d):
    """Rank r's part of a global step input: its contiguous 1/N of the
    leading axis when that divides by N, else the whole array. numpy
    arrays become tensors; anything without a shape passes through. A
    part is marked with the mesh, the axis and the global leading size,
    so a part placed already (a batch a prefetcher staged) passes
    through unchanged and still counts as split."""
    if isinstance(d, np.ndarray):
        d = torch.from_numpy(np.ascontiguousarray(d))
    if not isinstance(d, torch.Tensor) or _placed(d, mesh, axis):
        return d
    n = mesh.check_axis(axis)
    if n > 1 and _divides(d, n):
        per = d.shape[0] // n
        part = d[mesh.rank * per:(mesh.rank + 1) * per]
        setattr(part, _PLACED, (mesh, axis, int(d.shape[0])))
        return part
    return d


def carry_placement(src, dst):
    """``dst`` (``src`` moved to another device) marked as ``src`` is;
    returns ``dst``."""
    p = getattr(src, _PLACED, None)
    if p is not None:
        setattr(dst, _PLACED, p)
    return dst


def global_lead(d) -> Optional[int]:
    """The global batch's leading size of a placed part, else None."""
    p = getattr(d, _PLACED, None)
    return None if p is None else p[2]


def batch_is_sharded(mesh: DeviceMesh, axis: str, leaves) -> bool:
    """Whether :func:`place_on_mesh` split (or has split) any of
    ``leaves``: when none was, every rank holds the whole batch."""
    n = mesh.check_axis(axis)
    return n > 1 and any(
        _placed(d, mesh, axis) or _divides(d, n) for d in leaves
        if isinstance(d, (torch.Tensor, np.ndarray)))


@contextlib.contextmanager
def split_batch(mesh: Optional[DeviceMesh] = None, axis: str = "dp",
                split: bool = True):
    """Mark the work inside as one global batch whose leading axis
    ``mesh`` split along ``axis`` (each rank its own rows, as
    :func:`place_on_mesh` keeps them), for the ops whose result spans
    the batch: a training ``BatchNorm`` then takes its statistics over
    the axis's ranks (:func:`split_mesh`), as the JAX package's one
    SPMD program does. ``compile_step``'s ``zero`` and ``mesh`` modes
    enter it for a batch they split; a loop written by hand enters it
    around its forward. ``split=False`` marks a batch every rank holds
    whole (inside an outer scope too)."""
    mesh = mesh or current_mesh()
    stack = getattr(_state, "split", None)
    if stack is None:
        stack = _state.split = []
    stack.append((mesh, axis) if split and mesh is not None else None)
    try:
        yield
    finally:
        stack.pop()


def split_mesh() -> Optional[DeviceMesh]:
    """The mesh whose ranks hold the rows of the batch under way (the
    innermost :func:`split_batch` on this thread, over an axis of size
    >= 2), else None: a batch each rank holds whole."""
    stack = getattr(_state, "split", None)
    top = stack[-1] if stack else None
    if top is None or top[0].axis_size(top[1]) < 2:
        return None
    return top[0]


def shard_batch(data, mesh: Optional[DeviceMesh] = None, axis: str = "dp"):
    """This rank's part of a global batch (:func:`place_on_mesh`);
    unchanged without a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return data
    return place_on_mesh(mesh, axis, data)


def replicate(data: torch.Tensor, mesh: Optional[DeviceMesh] = None,
              src: int = 0) -> torch.Tensor:
    """Rank ``src``'s value on every rank: a broadcast into ``data`` in
    place (the counterpart of placing an array replicated on the mesh)."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return data
    dist.broadcast(data, src, group=mesh.group)
    return data


def zero_shard_pad(n: int, num_shards: int) -> int:
    """Smallest multiple of ``num_shards`` >= ``n``: the padded flat length
    a ZeRO-sharded buffer needs so every rank owns an equal 1/N tile."""
    if num_shards <= 0:
        raise MXNetError(f"num_shards must be positive, got {num_shards}")
    return -(-n // num_shards) * num_shards
