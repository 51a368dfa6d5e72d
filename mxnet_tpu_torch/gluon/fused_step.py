"""The whole training step as one callable (counterpart of
``mxnet_tpu/gluon/fused_step.py``), on one device or data-parallel over
a process group with the ZeRO-1 sharded update.

``Trainer.compile_step(loss_fn)`` returns a :class:`CompiledTrainStep`.
Each call runs ``loss_fn(*batch)`` (the forward, returning a per-sample
loss), the backward of the loss's SUM (what ``loss.backward()`` seeds
with ones), and the update with gradients rescaled by 1 / ``batch_size``,
``batch_size`` taken from the leading axis of the first batched argument.
It returns the per-sample loss, detached, without waiting for the device.
The JAX package traces this into one XLA program; PyTorch runs eagerly,
so here the step is its phases in order. Dropout follows the modules'
own ``train()`` / ``eval()`` mode.

Three modes, decided at the first call as the JAX package decides them:

- ``eager``: no mesh; ``trainer.step(batch_size)`` after the backward.
- ``zero`` (the ZeRO-1 sharded update, arXiv:2004.13336): a
  ``parallel.make_mesh`` mesh with a ``dp`` axis of size >= 2 is active
  (or given), the optimizer's rule is elementwise and the kvstore lets
  the step own the reduction. Each rank is given the GLOBAL batch and
  keeps its own part (``parallel.place_on_mesh``), so ``batch_size`` is
  the global leading size. The trainable parameters map to flat units
  (:class:`_ZeroShardPlan`) grouped into communication buckets
  (:func:`zero_bucket_schedule`); per bucket, in the same order on every
  rank: the gradients packed into the interleaved buffer, ONE
  ``reduce_scatter_tensor``, each unit's update on this rank's shard
  against its persistent sharded state (the ``opt_update`` kernel for
  exact SGD/Adam, ``fused_step_fn`` for any other elementwise rule), ONE
  ``all_gather_into_tensor``, and the new weights unpacked into the
  parameters. A batch whose leading axis does not divide by N is computed
  whole on every rank; its gradient is then reduced as a mean, not a
  sum, so it is not counted N times.
- ``mesh``: the mesh is active but the sharded update is off
  (``zero_shard=False``, or a rule that is not elementwise): every
  gradient is all-reduced, then the replicated update.

The collectives wait for the backward to end: overlapping them with it
through gradient hooks is later work. :class:`TrainLoop` runs the step
with a bounded in-flight window (``engine.DispatchWindow``).
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..parallel import dist as _dist
from ..parallel.collectives import (all_gather_rows, bucket_rows,
                                    reduce_scatter_rows)
from ..parallel.mesh import (batch_is_sharded, current_mesh, place_on_mesh,
                             replicate, zero_shard_pad)

__all__ = ["CompiledTrainStep", "TrainLoop", "zero_bucket_schedule"]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _zero_min_size() -> int:
    """ZeRO bucket floor in elements: ``MXNET_ZERO_SHARD_MIN_SIZE``
    (2048). A smaller parameter shares a bucket unit."""
    return _env_int("MXNET_ZERO_SHARD_MIN_SIZE", 2048)


def _zero_bucket_bytes() -> int:
    """ZeRO communication bucket bound in bytes: ``MXNET_ZERO_BUCKET_
    BYTES`` (4 MiB); ``<= 0`` gives one bucket per dtype run."""
    return _env_int("MXNET_ZERO_BUCKET_BYTES", 4 << 20)


def zero_bucket_schedule(units, bucket_bytes: int):
    """Partition unit indices into size-bounded communication buckets,
    in REVERSE unit order (the backward finishes the last layers first),
    never mixing dtypes in a bucket. ``bucket_bytes <= 0`` gives the
    fewest buckets (one per run of one dtype), in unit order."""
    serial = bucket_bytes is None or int(bucket_bytes) <= 0
    order = range(len(units)) if serial else reversed(range(len(units)))
    buckets, cur, cur_b, cur_dt = [], [], 0, None
    for k in order:
        u = units[k]
        ub = int(u["padded"]) * u["upd_dtype"].itemsize
        dt = (str(u["upd_dtype"]), str(u["dtypes"][0]))
        if cur and (dt != cur_dt or
                    (not serial and cur_b + ub > int(bucket_bytes))):
            buckets.append(cur)
            cur, cur_b = [], 0
        cur.append(k)
        cur_b += ub
        cur_dt = dt
    if cur:
        buckets.append(cur)
    return buckets


class _ZeroShardPlan:
    """The layout of the ZeRO-1 sharded update, computed from the
    trainable parameters, the optimizer and the number of shards alone
    (no process group):

    - a parameter of at least ``MXNET_ZERO_SHARD_MIN_SIZE`` elements is
      its own unit;
    - smaller ones concatenate into one bucket unit per dtype, with
      per-element hyperparameters (``Optimizer.pack_shard_hparams``).

    Each unit is a flat buffer zero-padded to a multiple of ``n_shards``;
    shard d is its contiguous slice ``[d*s, (d+1)*s)``. The optimizer
    state of rank d's shards (:meth:`create_states`) is all that rank
    keeps of it. Multi-precision master units are not ported."""

    def __init__(self, params, optimizer, n_shards: int):
        self.params = list(params)
        self.n_shards = int(n_shards)
        min_size = _zero_min_size()
        raw_units, small = [], {}
        for j, p in enumerate(self.params):
            if p.numel() >= min_size:
                raw_units.append((j,))
            else:
                small.setdefault(str(p.dtype), []).append(j)
        raw_units += [tuple(js) for js in small.values()]
        self.units = []
        for members in raw_units:
            shapes = tuple(tuple(self.params[j].shape) for j in members)
            dtypes = tuple(self.params[j].dtype for j in members)
            sizes = tuple(self.params[j].numel() for j in members)
            total = int(sum(sizes))
            self.units.append(dict(
                members=members, shapes=shapes, dtypes=dtypes, sizes=sizes,
                total=total, padded=zero_shard_pad(total, self.n_shards),
                upd_dtype=dtypes[0]))
        self.states: Optional[list] = None
        self.rank: Optional[int] = None

    # ---------------- layout helpers ----------------
    def shard_len(self, k: int) -> int:
        return self.units[k]["padded"] // self.n_shards

    def unit_flat(self, k: int, tensors) -> torch.Tensor:
        """Unit k's padded flat buffer of ``tensors`` (indexed like the
        trainable parameters; None reads as zeros)."""
        u = self.units[k]
        ref = self.params[u["members"][0]]
        out = torch.zeros(u["padded"], dtype=u["upd_dtype"],
                          device=ref.device)
        off = 0
        for j, n in zip(u["members"], u["sizes"]):
            if tensors[j] is not None:
                out[off:off + n] = tensors[j].detach().reshape(-1)
            off += n
        return out

    def copy_shard(self, k: int, tensors, rank: int,
                   out: torch.Tensor) -> torch.Tensor:
        """Shard ``rank`` of unit k's flat buffer of ``tensors`` into
        ``out`` (``shard_len(k)`` elements), reading only that slice."""
        u, s = self.units[k], self.shard_len(k)
        lo, hi = rank * s, (rank + 1) * s
        out.zero_()
        off = 0
        for j, n in zip(u["members"], u["sizes"]):
            a, b = max(lo, off), min(hi, off + n)
            if a < b:
                out[a - lo:b - lo] = tensors[j].detach().reshape(-1)[
                    a - off:b - off]
            off += n
        return out

    def write_unit(self, k: int, flat: torch.Tensor) -> None:
        """Unit k's full (padded) flat values into its parameters."""
        u = self.units[k]
        off = 0
        with torch.no_grad():
            for j, shp, n in zip(u["members"], u["shapes"], u["sizes"]):
                self.params[j].copy_(flat[off:off + n].view(shp))
                off += n

    def pack_hparams(self, opt, lrs, wds, ts):
        """Per unit: numpy scalars for a one-parameter unit, per-element
        vectors of the padded length for a bucket."""
        ulrs, uwds, uts = [], [], []
        for u in self.units:
            m = u["members"]
            if len(m) == 1:
                ulrs.append(np.float32(lrs[m[0]]))
                uwds.append(np.float32(wds[m[0]]))
                uts.append(np.int32(ts[m[0]]))
            else:
                lv, wv, tv = opt.pack_shard_hparams(
                    lrs, wds, ts, list(m), list(u["sizes"]), u["padded"])
                ulrs.append(lv)
                uwds.append(wv)
                uts.append(tv)
        return ulrs, uwds, uts

    def shard_hparam(self, k: int, v, rank: int, device):
        """Rank ``rank``'s part of a unit hyperparameter: a scalar as it
        is, a vector's slice as a tensor on ``device``."""
        if np.ndim(v) == 0:
            return v
        s = self.shard_len(k)
        return torch.from_numpy(np.ascontiguousarray(
            v[rank * s:(rank + 1) * s])).to(device)

    # ---------------- sharded state ----------------
    def create_states(self, opt, rank: int, updater_states=None) -> list:
        """Shard ``rank`` of every unit's optimizer state: each member's
        state (adopted from ``updater_states`` when its shapes fit, else
        ``opt.create_state``), concatenated, padded and sliced."""
        updater_states = updater_states or {}
        states = []
        for k, u in enumerate(self.units):
            per_member = []
            for j, shape in zip(u["members"], u["shapes"]):
                st = updater_states.get(j)
                if not (isinstance(st, tuple) and all(
                        isinstance(s, torch.Tensor) and
                        tuple(s.shape) == shape for s in st)):
                    st = opt.create_state(j, self.params[j].detach())
                per_member.append(tuple(st))
            counts = {len(m) for m in per_member}
            if len(counts) != 1:
                raise MXNetError(
                    "zero-shard: optimizer state leaf count differs across "
                    f"bucket members ({sorted(counts)})")
            leaves = []
            for li in range(counts.pop()):
                leaf = [m[li] for m in per_member]
                out = torch.empty(self.shard_len(k), dtype=leaf[0].dtype,
                                  device=leaf[0].device)
                self.copy_shard(k, dict(zip(u["members"], leaf)), rank, out)
                leaves.append(out)
            states.append(tuple(leaves))
        self.states, self.rank = states, rank
        return states

    def state_bytes_per_replica(self) -> int:
        """Bytes of optimizer state this rank holds (its shards)."""
        return sum(s.numel() * s.element_size()
                   for st in self.states or () for s in st)


def _infer_batch_size(leaves) -> int:
    for leaf in leaves:
        if getattr(leaf, "ndim", 0) >= 1:
            return int(leaf.shape[0])
    return 1


class CompiledTrainStep:
    """One callable = forward + backward + (reduction +) update. Built by
    ``Trainer.compile_step(loss_fn)``."""

    def __init__(self, trainer, loss_fn: Callable,
                 zero_shard: Optional[bool] = None, zero_axis: str = "dp",
                 mesh=None):
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._device = trainer._params[0].device if trainer._params \
            else torch.device("cpu")
        self._steps_done = 0
        self._mode: Optional[str] = None
        # ZeRO-1: None = auto (on when a mesh with `zero_axis` of size >= 2
        # is active), True = required, False = off
        self._zero_requested = zero_shard
        self._zero_axis = zero_axis
        self._zero_mesh = mesh
        self._zero_ok: Optional[tuple] = None
        self._plain_mesh: Optional[tuple] = None
        self._zero: Optional[_ZeroShardPlan] = None
        self._buckets: List[list] = []
        if zero_shard and (mesh is not None or current_mesh() is not None
                           or _dist.size() < 2):
            # decidable now: raise at once when it cannot hold
            self._mode = self._decide_mode()

    # ---------------- introspection ----------------
    @property
    def steps_done(self) -> int:
        return self._steps_done

    @property
    def mode(self) -> Optional[str]:
        return self._mode

    @property
    def zero_sharded(self) -> bool:
        """True when the ZeRO-1 sharded update is active."""
        return self._zero_ok is not None

    @property
    def zero_plan(self) -> Optional[_ZeroShardPlan]:
        return self._zero

    def optimizer_state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds: its shards under the
        sharded update, every parameter's state otherwise."""
        if self._zero is not None:
            return self._zero.state_bytes_per_replica()
        return sum(s.numel() * s.element_size()
                   for st in self._trainer._updater.states.values()
                   for s in st)

    # ---------------- mode decision ----------------
    def _decide_mode(self) -> str:
        if self._resolve_zero():
            return "zero"
        return "mesh" if self._plain_mesh is not None else "eager"

    def _resolve_zero(self) -> bool:
        """Whether the ZeRO-1 sharded update applies: a mesh with the dp
        axis of size >= 2, an elementwise rule, and a kvstore whose
        reduction the step may own in its reduce-scatter form. A valid
        mesh whose sharded update is gated off runs the ``mesh`` mode."""
        mesh = self._zero_mesh or current_mesh()
        axis = self._zero_axis
        mesh_ok = (mesh is not None and axis in mesh.axis_names
                   and mesh.shape[axis] >= 2)
        if mesh_ok:
            mesh.check_axis(axis)
            self._plain_mesh = (mesh, axis)
        if self._zero_requested is False:
            return False
        reason = None
        if not mesh_ok:
            reason = f"no active mesh with a {axis!r} axis of size >= 2"
        else:
            opt = self._trainer._optimizer
            kv = self._trainer._kvstore
            if not getattr(opt, "elementwise_update", False):
                reason = (f"{type(opt).__name__} update is not elementwise "
                          "(cannot run on flat shards)")
            elif self._host_allreduce():
                reason = "kvstore reduction cannot live in-program"
            elif kv is not None and not getattr(
                    kv, "in_program_reduce_scatter", True):
                reason = "kvstore does not advertise the reduce-scatter path"
        if reason is not None:
            if self._zero_requested:
                raise MXNetError(f"compile_step(zero_shard=True): {reason}")
            return False
        self._zero_ok = (mesh, axis)
        return True

    def _host_allreduce(self) -> bool:
        kv = self._trainer._kvstore
        return kv is not None and not getattr(kv, "in_program_reduce",
                                              False)

    # ---------------- call ----------------
    def _as_tensor(self, leaf):
        """numpy batches move to the parameters' device."""
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        if isinstance(leaf, torch.Tensor) and leaf.device != self._device:
            leaf = leaf.to(self._device)
        return leaf

    def __call__(self, *args, batch_size: Optional[int] = None, **kwargs):
        if self._mode is None:
            self._mode = self._decide_mode()
        leaves = list(args) + list(kwargs.values())
        if batch_size is None:
            batch_size = _infer_batch_size(leaves)
        if self._mode == "eager":
            loss = self._eager_call(args, kwargs, batch_size)
        else:
            mesh, axis = self._zero_ok or self._plain_mesh
            mean = not batch_is_sharded(mesh, axis, leaves)
            args = tuple(place_on_mesh(mesh, axis, a) for a in args)
            kwargs = {k: place_on_mesh(mesh, axis, v)
                      for k, v in kwargs.items()}
            if self._mode == "zero":
                loss = self._zero_call(args, kwargs, batch_size, mesh, mean)
            else:
                loss = self._mesh_call(args, kwargs, batch_size, mesh, mean)
        self._steps_done += 1
        return loss

    step = __call__

    def _forward(self, args, kwargs):
        args = tuple(self._as_tensor(a) for a in args)
        kwargs = {k: self._as_tensor(v) for k, v in kwargs.items()}
        return self._loss_fn(*args, **kwargs)

    def _eager_call(self, args, kwargs, batch_size):
        loss = self._forward(args, kwargs)
        loss.sum().backward()
        self._trainer.step(batch_size)
        return loss.detach()

    def _mesh_call(self, args, kwargs, batch_size, mesh, mean):
        """Replicated update after an all-reduce of every gradient."""
        loss = self._forward(args, kwargs)
        loss.sum().backward()
        self._trainer.allreduce_grads(mean=mean, mesh=mesh)
        self._trainer.update(batch_size)
        return loss.detach()

    # ---------------- the ZeRO-1 step ----------------
    def _prepare_zero(self):
        """Rank 0's parameters on every rank, then the plan and this
        rank's sharded optimizer state."""
        mesh, axis = self._zero_ok
        with torch.no_grad():
            for p in self._trainer._all_params:
                replicate(p.data, mesh)
        tr = self._trainer
        self._zero = _ZeroShardPlan(tr._params, tr._optimizer,
                                    mesh.axis_size(axis))
        self._zero.create_states(tr._optimizer, mesh.rank,
                                 tr._updater.states)
        self._buckets = zero_bucket_schedule(self._zero.units,
                                             _zero_bucket_bytes())

    def _scalars(self, batch_size):
        tr = self._trainer
        opt = tr._optimizer
        opt.rescale_grad = tr._scale / batch_size
        lrs, wds, ts = opt.begin_fused_step(list(range(len(tr._params))))
        clip = opt.clip_gradient if opt.clip_gradient is not None else 0.0
        return lrs, wds, ts, np.float32(opt.rescale_grad), np.float32(clip)

    def _zero_call(self, args, kwargs, batch_size, mesh, mean):
        if self._zero is None:
            self._prepare_zero()
        plan, tr = self._zero, self._trainer
        params, opt = tr._params, tr._optimizer
        loss = self._forward(args, kwargs)
        grads = torch.autograd.grad(loss.sum(), params, allow_unused=True)
        lrs, wds, ts, rescale, clip = self._scalars(batch_size)
        ulrs, uwds, uts = plan.pack_hparams(opt, lrs, wds, ts)
        opt_fn = opt.kernel_step_fn() or opt.fused_step_fn()
        rank, n, dev = plan.rank, plan.n_shards, self._device
        for idx in self._buckets:
            buf, cols = bucket_rows([plan.unit_flat(k, grads) for k in idx],
                                    n)
            g_row = reduce_scatter_rows(buf, mesh, mean=mean)
            del buf
            w_row = torch.empty_like(g_row)
            ws, gs, offs, off = [], [], [], 0
            for k, s in zip(idx, cols):
                ws.append(plan.copy_shard(k, params, rank,
                                          w_row[off:off + s]))
                gs.append(g_row[off:off + s])
                offs.append(off)
                off += s
            sts = tuple(plan.states[k] for k in idx)
            new_ws, new_sts = opt_fn(
                tuple(ws), tuple(gs),
                [plan.shard_hparam(k, ulrs[k], rank, dev) for k in idx],
                [plan.shard_hparam(k, uwds[k], rank, dev) for k in idx],
                [plan.shard_hparam(k, uts[k], rank, dev) for k in idx],
                rescale, clip, sts)
            for w, nw, st, nst in zip(ws, new_ws, sts, new_sts):
                if nw is not w:              # fused_step_fn: new tensors
                    w.copy_(nw)
                for s_, ns in zip(st, nst):
                    if ns is not s_:
                        s_.copy_(ns)
            full = all_gather_rows(w_row, mesh, n)
            for k, s, o in zip(idx, cols, offs):
                plan.write_unit(k, full[:, o:o + s].reshape(-1))
        for p in params:
            p.fresh_grad = False
            p.grad = None
        return loss.detach()


class TrainLoop:
    """The canonical (net, loss, trainer) triple as one step::

        loop = gluon.TrainLoop(net, trainer, loss_block)
        with parallel.make_mesh({"dp": world}):
            for x, y in batches:             # global batches
                loss = loop.step(x, y)
        loop.synchronize()

    ``step(*inputs, label)`` feeds all but the last argument to ``net``
    and the last to the loss block through ``Trainer.compile_step``
    (the ZeRO-1 sharded update when a dp mesh is active at the first
    step). It returns the rank's per-sample loss without waiting for the
    device; a bounded window (``engine.DispatchWindow``, size
    ``inflight`` or ``MXNET_INFLIGHT_STEPS``, default 2;
    ``MXNET_ENGINE_TYPE=NaiveEngine`` forces 0) makes the host wait, on
    the OLDEST step's loss, only when more steps are outstanding.
    Checkpointing, numerics, telemetry and prefetch are not ported."""

    def __init__(self, net, trainer, loss, inflight: Optional[int] = None):
        from ..engine import DispatchWindow
        self._net = net
        self._loss = loss
        self._trainer = trainer
        self._step = trainer.compile_step(self._loss_fn)
        if inflight is None:
            inflight = _env_int("MXNET_INFLIGHT_STEPS", 2)
        if os.environ.get("MXNET_ENGINE_TYPE") == "NaiveEngine":
            inflight = 0
        self._window = DispatchWindow(self._retire, max_inflight=inflight,
                                      what="TrainLoop step")
        self._global_step = 0

    def _loss_fn(self, *batch):
        *inputs, label = batch
        return self._loss(self._net(*inputs), label)

    @staticmethod
    def _retire(loss):
        loss.cpu()         # waits for the step's device work

    def step(self, *batch, batch_size: Optional[int] = None):
        loss = self._step(*batch, batch_size=batch_size)
        self._global_step += 1
        self._window.push(loss, tag=self._global_step)
        return loss

    __call__ = step

    def synchronize(self):
        """Retire every outstanding step; a deferred error surfaces here
        attributed to its step."""
        self._window.drain()

    def engine_stats(self) -> dict:
        s = dict(self._window.stats)
        s["inflight_window"] = self._window.max_inflight
        s["pending"] = len(self._window)
        return s

    @property
    def global_step(self) -> int:
        return self._global_step

    @property
    def compiled_step(self) -> CompiledTrainStep:
        return self._step

    @property
    def trainer(self):
        return self._trainer
