"""Collectives over a mesh axis (counterpart of
``mxnet_tpu/parallel/collectives.py``) on ``torch.distributed``.

Each rank passes its own part of the logical array and gets its own part
of the result: :func:`allreduce` the sum (mean, max) over the ranks,
:func:`allgather` every rank's part in rank order, :func:`reduce_scatter`
its 1/N tile of the summed leading axis, :func:`broadcast_axis` rank
``src``'s part.

:func:`reduce_scatter_bucketed` / :func:`allgather_bucketed` are the
ZeRO step's interleaved routing: each flat segment is padded to a
multiple of N and viewed as ``(N, s_k)`` rows, and the views concatenate
on the free axis into one ``(N, S)`` buffer. Row d is contiguous in the
flat buffer, so ONE ``reduce_scatter_tensor`` of it hands rank d exactly
``[seg_0[d*s_0:(d+1)*s_0], seg_1[...], ...]``. ``constrain`` is where the
collective happens; ``None`` is the identity, which keeps the routing
testable without a group. :func:`write_segment` packs a flat segment
straight into its columns of such a buffer (one copy a segment, zeros
only in the pad tail): the ZeRO step packs each unit's gradient so as
it arrives, and :func:`reduce_scatter_rows` / :func:`all_gather_rows`
take ``async_op`` to return the work handle with the output.

Every ``torch.distributed`` call of the package's collectives is issued
here, through :func:`_issue`, which hands it to the observer in
:data:`HOOK` when one is installed (a schedule record installs one while
it runs) with its logical kind (``reduce_scatter_rows`` is a
reduce-scatter), mesh axis, element count and group size.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..base import MXNetError
from .mesh import DeviceMesh, current_mesh

__all__ = ["allreduce", "allgather", "reduce_scatter", "broadcast_axis",
           "reduce_scatter_bucketed", "allgather_bucketed", "bucket_rows",
           "write_segment", "zero_segment", "reduce_scatter_rows",
           "all_gather_rows"]

# the non-deprecated names where this torch has them
_RS = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_AG = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _axis_of(mesh: DeviceMesh, n: int) -> Optional[str]:
    """The mesh axis a group of ``n`` ranks spans (its only axis of that
    size), or None."""
    hits = [a for a in mesh.axis_names if mesh.axis_size(a) == n]
    return hits[0] if len(hits) == 1 else None


#: the observer of the collectives, None unless one is installed:
#: ``HOOK[0](kind, axis, n, inputs, outputs, call, async_op, elements)``
#: runs ``call()`` and returns its result (an ``async_op`` call's work,
#: or a stand-in with its ``wait()``)
HOOK: list = [None]


def _issue(kind, axis, n, inputs, outputs, call, async_op=False,
           elements=None):
    """``call()`` (one ``torch.distributed`` call), through the observer
    when one is installed (:data:`HOOK`)."""
    hook = HOOK[0]
    if hook is None:
        return call()
    return hook(kind, axis, n, inputs, outputs, call, async_op, elements)


def _mesh_n(mesh, axis):
    mesh = mesh or current_mesh()
    if mesh is None:
        raise MXNetError("no active mesh; wrap in `with make_mesh(...)`")
    return mesh, mesh.check_axis(axis)


def allreduce(x: torch.Tensor, axis: str = "dp",
              mesh: Optional[DeviceMesh] = None, op: str = "sum"):
    """The sum (``"mean"``, ``"max"``) of every rank's ``x``."""
    mesh, n = _mesh_n(mesh, axis)
    ops = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise MXNetError(f"unknown reduce op {op}")
    out = x.clone()
    if n > 1:
        _issue("all_reduce", axis, n, [x], [out],
               lambda: dist.all_reduce(out, ops[op], group=mesh.group))
    if op == "mean":
        out.div_(n)
    return out


def allgather(x: torch.Tensor, axis: str = "dp",
              mesh: Optional[DeviceMesh] = None, tiled: bool = True):
    """Every rank's ``x`` in rank order: concatenated on the leading axis
    (``tiled``) or stacked on a new one."""
    mesh, n = _mesh_n(mesh, axis)
    flat = x.reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    if n > 1:
        _issue("all_gather", axis, n, [flat], [out],
               lambda: _AG(out, flat, group=mesh.group))
    else:
        out.copy_(flat)
    out = out.view((n,) + tuple(x.shape))
    return out.reshape((-1,) + tuple(x.shape[1:])) if tiled else out


def reduce_scatter(x: torch.Tensor, axis: str = "dp",
                   mesh: Optional[DeviceMesh] = None):
    """This rank's tile of the leading axis of the sum of every rank's
    ``x``. A leading size not divisible by N is zero-padded for the
    collective and the padding cut from the result (the last ranks' tiles
    may be shorter, or empty)."""
    mesh, n = _mesh_n(mesh, axis)
    if x.ndim == 0:
        raise MXNetError("reduce_scatter needs a >=1-d operand")
    lead = int(x.shape[0])
    per = -(-lead // n)
    data = x.contiguous()
    if per * n != lead:
        data = torch.cat([data, data.new_zeros((per * n - lead,)
                                               + tuple(x.shape[1:]))])
    out = torch.empty((per,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if n > 1:
        _issue("reduce_scatter", axis, n, [data], [out],
               lambda: _RS(out, data, group=mesh.group))
    else:
        out.copy_(data)
    r = mesh.rank
    return out[:max(0, min(per, lead - r * per))]


def broadcast_axis(x: torch.Tensor, axis: str = "dp",
                   mesh: Optional[DeviceMesh] = None, src: int = 0):
    """Rank ``src``'s ``x`` on every rank."""
    mesh, n = _mesh_n(mesh, axis)
    out = x.clone()
    if n > 1:
        _issue("broadcast", axis, n, [x], [out],
               lambda: dist.broadcast(out, src, group=mesh.group))
    return out


# ---------------------------------------------------------------------------
# the interleaved bucket layout of the ZeRO step
# ---------------------------------------------------------------------------

def write_segment(buf: torch.Tensor, off: int, s: int, start: int,
                  flat: torch.Tensor) -> None:
    """Write ``flat`` at positions ``[start, start + flat.numel())`` of
    the column block ``buf[:, off:off + s]``, position p at row ``p // s``,
    column ``off + p % s`` (the interleaved layout): at most three copies,
    a partial first row, the whole rows, a partial last row. The copy
    casts to ``buf``'s dtype."""
    n = int(flat.numel())
    p, i, end = start, 0, start + n
    r, c = divmod(p, s)
    if c and n:
        take = min(s - c, n)
        buf[r, off + c:off + c + take].copy_(flat[:take])
        p, i = p + take, take
    full = (end - p) // s
    if full:
        r = p // s
        buf[r:r + full, off:off + s].copy_(flat[i:i + full * s].view(full, s))
        p, i = p + full * s, i + full * s
    if p < end:
        buf[p // s, off:off + end - p].copy_(flat[i:])


def zero_segment(buf: torch.Tensor, off: int, s: int, start: int,
                 end: int) -> None:
    """Zero positions ``[start, end)`` of the column block
    ``buf[:, off:off + s]`` (:func:`write_segment`'s layout)."""
    p = start
    r, c = divmod(p, s)
    if c and p < end:
        take = min(s - c, end - p)
        buf[r, off + c:off + c + take].zero_()
        p += take
    full = (end - p) // s
    if full:
        buf[p // s:p // s + full, off:off + s].zero_()
        p += full * s
    if p < end:
        buf[p // s, off:off + end - p].zero_()


def bucket_rows(segs, num_shards: int):
    """Pad each flat segment to ``num_shards`` divisibility and lay the
    ``(num_shards, s_k)`` views side by side: ``(buf (num_shards, S),
    cols)``, where ``cols[k]`` is segment k's per-shard column count.
    Each segment is one :func:`write_segment` into the buffer; only the
    pad tails are zeroed."""
    cols = [-(-int(g.numel()) // num_shards) for g in segs]
    buf = segs[0].new_empty(num_shards, sum(cols))
    off = 0
    for g, s in zip(segs, cols):
        write_segment(buf, off, s, 0, g.reshape(-1))
        zero_segment(buf, off, s, int(g.numel()), num_shards * s)
        off += s
    return buf, cols


class _RowSum:
    """The work of an asynchronous :func:`reduce_scatter_rows`:
    ``wait()`` waits for the exchange, then sums the N received rows in
    rank order into the output (on the caller's stream)."""

    def __init__(self, work, rows: torch.Tensor, out: torch.Tensor):
        self._work, self._rows, self._out = work, rows, out

    def wait(self) -> bool:
        self._work.wait()
        _sum_rows(self._rows, self._out)
        self._work = self._rows = None
        return True


def _sum_rows(rows: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out = ((rows[0] + rows[1]) + rows[2]) + ...``: one order for
    every element, wherever it lies."""
    if rows.shape[0] == 1:
        return out.copy_(rows[0])
    torch.add(rows[0], rows[1], out=out)
    for r in range(2, rows.shape[0]):
        out.add_(rows[r])
    return out


def reduce_scatter_rows(buf: torch.Tensor, mesh: DeviceMesh,
                        mean: bool = False, async_op: bool = False,
                        out: Optional[torch.Tensor] = None):
    """The reduce-scatter of an interleaved ``(N, S)`` buffer: this rank's
    row of the sum (or mean) over ranks, ``(S,)``.

    NCCL's and gloo's reduce-scatters pick their algorithm, and with it
    the order in which an element's N terms are summed, by the message's
    size, so one gradient reduces to other last bits in another bucket
    layout (measured with gloo: 1 ulp). Here rank d's rows travel in ONE
    ``all_to_all_single`` (the bytes a ring reduce-scatter moves:
    (N - 1)/N of the buffer a rank) and the N rows a rank receives are
    summed in rank order, so any bucketing reduces bit for bit alike.
    With ``async_op`` it returns ``(row, work)`` at once: ``row`` holds
    the SUM once ``work.wait()`` returned (the caller divides for a
    mean), and ``buf`` must stay alive until then. ``out`` is where the
    row goes (a new tensor by default)."""
    n, width = buf.shape
    if out is None:
        out = torch.empty(width, dtype=buf.dtype, device=buf.device)
    rows = torch.empty_like(buf)
    work = _issue("reduce_scatter", _axis_of(mesh, n), n, [buf], [rows],
                  lambda: dist.all_to_all_single(rows, buf,
                                                 group=mesh.group,
                                                 async_op=async_op),
                  async_op=async_op, elements=width)
    if async_op:
        return out, _RowSum(work, rows, out)
    _sum_rows(rows, out)
    return out.div_(n) if mean else out


def all_gather_rows(row: torch.Tensor, mesh: DeviceMesh, n: int,
                    async_op: bool = False):
    """One all-gather of every rank's ``(S,)`` row into ``(N, S)``. With
    ``async_op`` it returns ``(out, work)``; ``out`` holds the rows once
    ``work.wait()`` returned."""
    out = torch.empty(n, row.numel(), dtype=row.dtype, device=row.device)
    work = _issue("all_gather", _axis_of(mesh, n), n, [row], [out],
                  lambda: _AG(out.view(-1), row, group=mesh.group,
                              async_op=async_op), async_op=async_op)
    return (out, work) if async_op else out


def reduce_scatter_bucketed(segs, num_shards: int, constrain=None):
    """One reduce-scatter per bucket instead of one per segment.

    ``segs`` are flat gradient segments of any lengths. ``constrain``
    maps the interleaved ``(num_shards, S)`` buffer to its reduced
    layout; ``None`` is the identity. Returns the flat
    ``(num_shards * s_k,)`` padded segments in input order."""
    buf, cols = bucket_rows(segs, num_shards)
    if constrain is not None:
        buf = constrain(buf)
    outs, off = [], 0
    for s in cols:
        outs.append(buf[:, off:off + s].reshape(num_shards * s))
        off += s
    return outs


def allgather_bucketed(shards, num_shards: int, constrain=None,
                       orig_lens=None):
    """The inverse routing of :func:`reduce_scatter_bucketed`: flat
    segments whose lengths divide by ``num_shards`` concatenate into the
    interleaved buffer, ``constrain`` gathers it (``None``: identity),
    and each segment's full value slices back out; ``orig_lens`` strips
    the padding."""
    rows = []
    for w in shards:
        w = w.reshape(-1)
        n = int(w.numel())
        if n % num_shards:
            raise MXNetError(
                "allgather_bucketed: segment length %d not divisible "
                "by num_shards=%d (pass reduce_scatter_bucketed "
                "outputs)" % (n, num_shards))
        rows.append(w.reshape(num_shards, n // num_shards))
    buf = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
    if constrain is not None:
        buf = constrain(buf)
    outs, off = [], 0
    for k, r in enumerate(rows):
        s = r.shape[1]
        full = buf[:, off:off + s].reshape(num_shards * s)
        if orig_lens is not None:
            full = full[:int(orig_lens[k])]
        outs.append(full)
        off += s
    return outs
