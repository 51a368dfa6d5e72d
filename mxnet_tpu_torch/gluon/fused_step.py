"""The whole training step as one callable (counterpart of
``mxnet_tpu/gluon/fused_step.py``), on one device or data-parallel over
a process group with the ZeRO-1 sharded update.

``Trainer.compile_step(loss_fn)`` returns a :class:`CompiledTrainStep`.
Each call runs ``loss_fn(*batch)`` (the forward, returning a per-sample
loss), the backward of the loss's SUM (what ``loss.backward()`` seeds
with ones), and the update with gradients rescaled by 1 / ``batch_size``,
``batch_size`` taken from the leading axis of the first batched argument.
It returns the per-sample loss of the whole (global) batch, detached,
without waiting for the device: where the batch was split over the
ranks, each rank's part is all-gathered in rank order.
Dropout follows the modules' own ``train()`` / ``eval()`` mode.

Four modes, decided at the first call as the JAX package decides them:

- ``fused`` (one device, no dp mesh): the counterpart of the JAX
  package's one donated XLA program per input signature, here one
  captured CUDA graph per signature (``mxnet_tpu_torch.captured``). The
  signature is the batch leaves' shapes and dtypes, the non-array
  arguments' values, the arguments' structure and the training flags of
  the layers that draw random numbers or write state in place (a
  BatchNorm's running statistics) (``train_mode``), as the JAX
  ``_entry_for`` keys its cache; ``MXNET_FUSED_STEP_CACHE_SIZE`` (0:
  unbounded) bounds it, least recently used first, and :attr:`n_traces`
  / :meth:`explain_retrace` say what was captured and why. The graph
  holds the whole step: the batch copied into static inputs, the
  forward, the gradients of the loss's SUM (``torch.autograd.grad``, so
  a parameter the loss does not reach updates with a zero gradient, as
  the JAX program's ``jax.grad`` gives it, and no ``.grad`` is touched)
  and the update of every trainable parameter in place
  (``Optimizer.whole_step_fn``: one ``opt_update`` launch a dtype
  group of parameters for exact SGD / SGD-momentum / Adam). Every lr, wd,
  update count t, rescale (``trainer._scale`` / batch size, so an amp loss
  scale enters here) and clip the update reads comes from a device buffer
  (``optimizer.DeviceHParams``) that the host fills before each replay:
  the counts advance and lr / wd (a scheduler's, a
  ``trainer.learning_rate`` set between steps) are read on the host, as
  ``Trainer.step`` does, and go up in one copy. A capture runs the
  body's forward and backward twice eagerly first (its warm-up, the
  update skipped) with the random generators and the running statistics
  the forward wrote put back after, so the
  first N calls of a signature are exactly N eager steps; each
  generator a layer drew from is registered with the graph, so replay k
  draws what eager step k draws. New tensors in place of the
  parameters or the optimizer states (``Updater.set_states`` via
  ``Trainer.load_states`` of a states file) make the next call capture
  again; a checkpoint restore copies in place and does not.
  :meth:`aot_compile` captures a signature without stepping. On the
  CPU the same body runs eagerly over the same static buffers. If the
  loss's forward or backward fails in the step's FIRST call (on a card:
  a loss that syncs with the host, ``.item()``, cannot be captured), the
  step does what the JAX package does when its first trace fails: it
  drops its programs, puts the update counts and the random generators
  back, logs a warning and runs eagerly from then on, that call
  included. Any other failure of a first call (the update kernel's
  build or launch: the eager step would not run that kernel) and any
  failure of a later call raises ``MXNetError``. ``train_mode=False``
  runs the forward with every layer that draws in eval mode and is part
  of the signature.

  A store that cannot reduce in-program (``kvstore.KVStoreDist`` with
  several ranks, or ``_force_fuse``) gets the *split* program, whose
  ``mode`` still reads ``fused``, as the JAX package's does: a graph a
  signature of the forward and the backward that leaves every gradient
  in a static buffer; then, on the host, ``Trainer._allreduce_grads``,
  where the store's bucketed ``pushpull_list`` writes the sums back into
  those buffers in place (the collectives stay out of the graphs); then
  one graph of the update (one ``opt_update`` a dtype group, reading the
  same device block), shared by the signatures. Each rank passes its
  own rows, and ``batch_size=`` the global batch's size; under an
  active dp mesh (which must span every rank) each rank is given the
  global batch and keeps its part, as in the ``zero`` mode, and the
  store's sum takes the place of the mesh's all-reduce. The ``zero`` and
  ``mesh`` modes are never taken with such a store.
- ``eager``: bfloat16 / float16 parameters under ``multi_precision``
  (their float32 masters live in the Updater's states, as the JAX
  package sends them to its eager path), ``update_on_kvstore`` (the
  optimizer runs on the store), or a process group of several ranks
  without a dp mesh and without a dist store; the forward,
  ``loss.sum().backward()`` and ``trainer.step(batch_size)``, which
  reduces across the ranks.
- ``zero`` (the ZeRO-1 sharded update, arXiv:2004.13336): a
  ``parallel.make_mesh`` mesh with a ``dp`` axis of size >= 2 is active
  (or given), the optimizer's rule is elementwise and the kvstore lets
  the step own the reduction (a dist store never does). Each rank is given the GLOBAL batch and
  keeps its own part (``parallel.place_on_mesh``), so ``batch_size`` is
  the global leading size. The trainable parameters map to flat units
  (:class:`_ZeroShardPlan`) grouped into communication buckets
  (:func:`zero_bucket_schedule`). The backward runs with one
  post-accumulate hook a parameter: each gradient, as it arrives, is
  written straight into its columns of its bucket's interleaved buffer
  and dropped, and once a bucket is whole its ONE reduce-scatter
  (``collectives.reduce_scatter_rows``: an ``all_to_all_single`` and a
  rank-ordered sum) is launched asynchronously (NCCL runs it on its own
  stream while autograd goes on with earlier layers), in the schedule's
  order on every rank: a bucket that is whole waits for the ones before
  it. After the backward the buckets not yet out go (a parameter the
  step did not use has zeros). Then, once a run of buckets of one dtype
  (what a serial schedule makes one bucket): ``work.wait()`` on its
  buckets (the compute stream waits, not the host), the update of its
  units' shards on this rank against their persistent sharded state
  (ONE ``opt_update`` launch for exact SGD/Adam, an mp group's weights
  written from its masters by the same launch; ``fused_step_fn`` for
  any other elementwise rule; the bucket units' per-element lr, wd and
  t go up in one copy a step) and ONE asynchronous
  ``all_gather_into_tensor``; the new weights are unpacked into the
  parameters once every gather has landed. (The first design gathered
  each bucket on its own after the backward: at BERT-base's 75 buckets
  of 4 MiB its host work made a dp-4 step ~35 ms slower than one
  bucket's, on four H100s.) The packing is routing only and the sum's
  order is fixed, so any bucketing, ``MXNET_ZERO_BUCKET_BYTES=0``'s one
  bucket (no overlap) included, trains bit for bit alike. A batch whose
  leading axis does not divide by N is computed whole on every rank; its
  gradient is then reduced as a mean, not a sum, so it is not counted N
  times. Under ``multi_precision`` a bfloat16 or float16 parameter is a
  unit of its own with a float32 master shard: its gradient is reduced
  in float32, the rule updates the master, and the weight is rebuilt
  from the master in its own dtype before the all-gather.
- ``mesh``: the mesh is active but the sharded update is off
  (``zero_shard=False``, or a rule that is not elementwise): every
  gradient is all-reduced, then the replicated update. A dist store
  that sums on the host takes this mode only for float32 masters (or
  after a failed first capture), and then sums through the store.

The plain ``mesh`` mode's all-reduce still waits for the backward to
end. :class:`TrainLoop` runs the step with a bounded in-flight window
(``engine.DispatchWindow``). Every call is bracketed by the
``step.dispatch`` fault points (context ``dp<N>``, N the step's data
parallel width) and records a device loss escaping it
(``elastic.detect``).

The ``zero`` and ``mesh`` modes run eagerly: capturing their NCCL
collectives and the ZeRO gradient hooks is later work. Under
``amp.init()`` parameters stay float32 and gradients come back float32,
so no mode needs a master.

**Numerics** (``numerics='global'|'per_layer'``, ``MXNET_NUMERICS``;
``telemetry/numerics.py``): the step also computes the global grad norm
(of the gradients the update reads, times its rescale), the param norm
(the weights it reads), the update norm (new less old weights, from a
copy of the weights taken before the in-place update), non-finite
gradient counts by dtype and, ``per_layer``, each parameter's grad norm.
In the ``fused`` mode they are reductions inside the captured graph into
its one float64 aux output, copied out with the loss; the ``zero`` mode
reduces each rank's shards and composes them with one all-reduce; the
``mesh`` mode reduces the all-reduced gradients. The mode is part of the
signature. The statistics only read what the step computes: losses and
weights stay bit-equal with numerics off. :meth:`CompiledTrainStep.
take_numerics` hands the record to the loop's dispatch window, which
reads it at the retire. The split program and the ``eager`` mode run
without it (a warning), as the JAX package's do.

**Telemetry**: ``mx_compile_retraces_total`` counts captures,
:meth:`CompiledTrainStep.step_flops` gives the FLOPs of one step (the
eager step under ``torch.utils.flop_counter.FlopCounterMode`` plus what
the hand-written kernels' wrappers report) for ``TrainLoop.arm_mfu``,
and after its first step the parameters and optimizer states are filed in
the memory census (pools ``params`` and ``optimizer``).
:meth:`CompiledTrainStep.memory_report` merges the captures' allocator
footprints.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import os
import time
from collections import OrderedDict
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..analysis import guard as _tguard
from ..analysis.program import analysis_mode as _analysis_mode
from ..base import MXNetError
from ..captured import Programs
from ..kvstore import KVStoreDist
from ..optimizer.optimizer import LOW_PRECISION, DeviceHParams, Optimizer
from ..parallel import dist as _dist
from ..parallel.collectives import (all_gather_rows, allgather, allreduce,
                                    reduce_scatter_rows, write_segment,
                                    zero_segment)
from ..parallel.mesh import (batch_is_sharded, current_mesh, global_lead,
                             place_on_mesh, replicate, split_batch,
                             zero_shard_pad)
from ..testing.faults import fault_point
from .nn.basic_layers import draws_off, recording_draws

__all__ = ["CompiledTrainStep", "TrainLoop", "zero_bucket_schedule"]

_LOG = logging.getLogger("mxnet_tpu_torch.gluon")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _tuned_int(name: str, env: str, default: int) -> int:
    """Autotune override > ``env`` > ``default`` (``tuning/space.py``)."""
    from ..tuning import space as _tspace
    found, v = _tspace.get_override(name)
    if not found:
        v = os.environ.get(env, str(default))
    try:
        return int(v)
    except (TypeError, ValueError):
        return default


def _zero_min_size() -> int:
    """ZeRO bucket floor in elements: autotune override >
    ``MXNET_ZERO_SHARD_MIN_SIZE`` > 2048 (the ``zero.shard_min_size``
    tunable). A smaller parameter shares a bucket unit."""
    return _tuned_int("zero.shard_min_size", "MXNET_ZERO_SHARD_MIN_SIZE",
                      2048)


def _zero_bucket_bytes() -> int:
    """ZeRO communication bucket bound in bytes: autotune override >
    ``MXNET_ZERO_BUCKET_BYTES`` > 4 MiB (the ``zero.bucket_bytes``
    tunable); ``<= 0`` gives one bucket per dtype run."""
    return _tuned_int("zero.bucket_bytes", "MXNET_ZERO_BUCKET_BYTES",
                      4 << 20)


def _register_tunables():
    """The ZeRO layout's tunables, next to the constants they make
    sweepable. Any packing and any bucketing give bit-equal updates (the
    update is elementwise over the flat shards, and the row sums run in
    rank order whatever the bucket: ``collectives.reduce_scatter_rows``),
    so both knobs are speed alone. They change the plan built at the
    first ZeRO call, so a trial with other values drops it
    (``CompiledTrainStep._drop_programs``)."""
    from ..tuning.space import Tunable, register
    register(Tunable(
        "zero.shard_min_size", default=2048,
        grid=(512, 2048, 8192, 32768),
        env="MXNET_ZERO_SHARD_MIN_SIZE", parse=int,
        valid=lambda v, _c: int(v) >= 1,
        seam="gluon.fused_step._zero_min_size() -> _ZeroShardPlan "
             "solo-vs-bucketed unit split",
        scope="train", affects_program=True,
        doc="element floor for a param to get its own RS/AG pair "
            "under the ZeRO-1 sharded update"))
    register(Tunable(
        "zero.bucket_bytes", default=4 << 20,
        grid=(0, 1 << 20, 4 << 20, 16 << 20),
        env="MXNET_ZERO_BUCKET_BYTES", parse=int,
        valid=lambda v, _c: int(v) >= 0,
        seam="gluon.fused_step._zero_bucket_bytes() -> "
             "zero_bucket_schedule comm bucketing (0 = monolithic "
             "serial baseline)",
        scope="train", affects_program=True,
        doc="byte bound per ZeRO gradient communication bucket"))


_register_tunables()


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
      its own unit, and so is a bfloat16 or float16 one under the
      optimizer's ``multi_precision`` (``mp``: updated in float32,
      ``upd_dtype``, on a float32 master);
    - smaller ones concatenate into one bucket unit per dtype, with
      per-element hyperparameters (``Optimizer.pack_shard_hparams``).

    Each unit is a flat buffer zero-padded to a multiple of ``n_shards``;
    shard d is its contiguous slice ``[d*s, (d+1)*s)``. The optimizer
    state of rank d's shards, and the float32 master shard of each mp
    unit (:meth:`create_states`), are all that rank keeps of them."""

    def __init__(self, params, optimizer, n_shards: int):
        self.params = list(params)
        self.n_shards = int(n_shards)
        min_size = _zero_min_size()
        raw_units, small = [], {}
        for j, p in enumerate(self.params):
            mp = bool(getattr(optimizer, "multi_precision", False)) and \
                p.dtype in LOW_PRECISION
            if mp or p.numel() >= min_size:
                raw_units.append(((j,), mp))
            else:
                small.setdefault(str(p.dtype), []).append(j)
        raw_units += [(tuple(js), False) for js in small.values()]
        self.units = []
        for members, mp in raw_units:
            shapes = tuple(tuple(self.params[j].shape) for j in members)
            dtypes = tuple(self.params[j].dtype for j in members)
            sizes = tuple(self.params[j].numel() for j in members)
            total = int(sum(sizes))
            self.units.append(dict(
                members=members, shapes=shapes, dtypes=dtypes, sizes=sizes,
                total=total, padded=zero_shard_pad(total, self.n_shards),
                mp=mp, upd_dtype=torch.float32 if mp else dtypes[0]))
        self.states: Optional[list] = None
        #: unit index -> this rank's float32 master shard (mp units)
        self.masters: dict = {}
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

    def stage_hparams(self, lrs, wds, ts, rank: int, device):
        """Rank ``rank``'s part of every unit's lr, wd and t
        (:meth:`pack_hparams`' lists): a one-parameter unit's scalars as
        they are; the bucket units' vector slices staged into ONE int32
        block on ``device`` by one copy from pinned memory (lr and wd as
        float32 bits), each a view of it."""
        vec = [k for k, v in enumerate(lrs) if np.ndim(v)]
        out = [list(lrs), list(wds), list(ts)]
        if not vec:
            return out
        total = sum(self.shard_len(k) for k in vec)
        host = np.empty(3 * total, np.int32)
        hf = host.view(np.float32)
        offs, off = [], 0
        for k in vec:
            s = self.shard_len(k)
            part = slice(rank * s, (rank + 1) * s)
            hf[off:off + s] = lrs[k][part]
            hf[total + off:total + off + s] = wds[k][part]
            host[2 * total + off:2 * total + off + s] = ts[k][part]
            offs.append((k, off, s))
            off += s
        src = torch.from_numpy(host)
        buf = torch.empty(3 * total, dtype=torch.int32, device=device)
        if buf.device.type == "cuda":
            buf.copy_(src.pin_memory(), non_blocking=True)
        else:
            buf.copy_(src)
        f = buf.view(torch.float32)
        for k, o, s in offs:
            out[0][k] = f[o:o + s]
            out[1][k] = f[total + o:total + o + s]
            out[2][k] = buf[2 * total + o:2 * total + o + s]
        return out

    # ---------------- sharded state ----------------
    def create_states(self, opt, rank: int, updater_states=None,
                      masters=None) -> list:
        """Shard ``rank`` of every unit's optimizer state and each mp
        unit's float32 master shard (:attr:`masters`).

        A member's state is adopted from ``updater_states`` (a restored
        checkpoint's, or the eager steps' before the plan) when it is a
        tuple of param-shaped tensors, or a ``(state, master)`` pair of
        them; else it is ``opt.create_state``'s, on the float32 master
        of an mp unit. An mp member's master comes from ``masters``
        (index -> param-shaped float32, a checkpoint's ``master/<j>``;
        each used one is taken out), else from the adopted pair, else
        the weight cast to float32."""
        self.states, self.masters = self._build_states(
            opt, rank, updater_states or {}, masters)
        self.rank = rank
        return self.states

    def load_states(self, opt, updater_states, masters=None) -> None:
        """Refill a live plan's shards IN PLACE from restored states and
        masters (:meth:`create_states`' adoption rules): the tensors the
        step holds keep their storage."""
        states, new_masters = self._build_states(opt, self.rank,
                                                 updater_states, masters)
        with torch.no_grad():
            for st, nst in zip(self.states, states):
                for s_, ns in zip(st, nst):
                    s_.copy_(ns)
            for k, m in new_masters.items():
                self.masters[k].copy_(m)

    def _adopt(self, opt, j, st):
        """(state, master or None) of member j from ``st`` when it fits
        the parameter's shape, else (None, None)."""
        p = self.params[j]
        master = None
        if opt.is_master_state(p, st):
            st, master = st
        shape = tuple(p.shape)
        ok = isinstance(st, tuple) and all(
            isinstance(s, torch.Tensor) and tuple(s.shape) == shape
            for s in st)
        if master is not None and tuple(master.shape) != shape:
            master = None
        return (st if ok else None), master

    def _build_states(self, opt, rank, updater_states, masters):
        restored = masters if masters is not None else {}
        states, out_masters = [], {}
        for k, u in enumerate(self.units):
            dev = self.params[u["members"][0]].device
            per_member, pair_master = [], {}
            for j in u["members"]:
                st, m = self._adopt(opt, j, updater_states.get(j))
                if m is not None:
                    pair_master[j] = m
                if st is None:
                    w = self.params[j].detach()
                    st = opt.create_state(j, w.float() if u["mp"] else w)
                per_member.append(tuple(st))
            if u["mp"]:
                j = u["members"][0]
                src = restored.pop(j, None)
                if src is None:
                    src = pair_master.get(j, self.params[j])
                master = torch.empty(self.shard_len(k), dtype=torch.float32,
                                     device=dev)
                out_masters[k] = self.copy_shard(k, {j: src.to(dev)}, rank,
                                                 master)
            counts = {len(m) for m in per_member}
            if len(counts) != 1:
                raise MXNetError(
                    "zero-shard: optimizer state leaf count differs across "
                    f"bucket members ({sorted(counts)})")
            leaves = []
            for li in range(counts.pop()):
                leaf = [m[li].to(dev) for m in per_member]
                # a state is the dtype it updates in, whatever a
                # checkpoint stored it in
                out = torch.empty(self.shard_len(k), dtype=u["upd_dtype"],
                                  device=dev)
                self.copy_shard(k, dict(zip(u["members"], leaf)), rank, out)
                leaves.append(out)
            states.append(tuple(leaves))
        return states, out_masters

    def state_bytes_per_replica(self) -> int:
        """Bytes of optimizer state this rank holds: its shards of the
        states and of the float32 masters, each (re-)filed in the census
        pool ``optimizer`` (the walk is the registration)."""
        mem = _telemetry.memory
        c = mem.census()
        total = 0
        for st in (self.states or []) + [self.masters.values()]:
            for s in st:
                c.register("optimizer", s)
                total += mem.device_bytes(s)
        return total


class _BucketReducer:
    """One backward's reduce-scatters, launched from the parameters'
    post-accumulate hooks in the bucket schedule's order.

    Unit k of bucket b owns the columns ``[off, off + s_k)`` of b's
    ``(N, S)`` buffer (allocated in the bucket's update dtype when its
    first gradient arrives, only the pad tails zeroed). A gradient is
    written there in one :func:`write_segment` and the parameter's
    ``.grad`` dropped; when b's last unit is whole and every bucket
    before it is out, b's reduce-scatter is launched with ``async_op``.

    Consecutive buckets of one dtype form a group (the buckets a serial
    schedule would merge into one): their reduced rows land side by side
    in one group row, so what follows the backward runs once a group,
    whatever the bucket bound. ``trace`` receives ``("grad", j)`` and
    ``("reduce_scatter", b)`` in the order they happen."""

    def __init__(self, plan, buckets, mesh, trace: list):
        self.plan, self.buckets, self.mesh = plan, buckets, mesh
        self.trace = trace
        n = plan.n_shards
        #: param j -> (unit k, offset in the unit's flat buffer)
        self.member_of = {}
        #: unit k -> (bucket b, column offset, columns)
        self.unit_at = {}
        #: per bucket, its units' columns
        self.cols = []
        #: bucket b -> (group g, column offset in the group's row)
        self.group_of = []
        #: per group, its buckets and its row's width
        self.groups, self.widths = [], []
        key = None
        for b, idx in enumerate(buckets):
            off, cols = 0, []
            for k in idx:
                u = plan.units[k]
                s = u["padded"] // n
                self.unit_at[k] = (b, off, s)
                m_off = 0
                for j, size in zip(u["members"], u["sizes"]):
                    self.member_of[j] = (k, m_off)
                    m_off += size
                cols.append(s)
                off += s
            self.cols.append(cols)
            u0 = plan.units[idx[0]]
            if (u0["upd_dtype"], u0["dtypes"][0]) != key:
                key = (u0["upd_dtype"], u0["dtypes"][0])
                self.groups.append([])
                self.widths.append(0)
            self.group_of.append((len(self.groups) - 1, self.widths[-1]))
            self.groups[-1].append(b)
            self.widths[-1] += off
        self.missing = {k: set(u["members"])
                        for k, u in enumerate(plan.units)}
        self.units_left = [len(idx) for idx in buckets]
        self.bufs = [None] * len(buckets)
        self.works = [None] * len(buckets)
        self.rows = [None] * len(self.groups)
        self.next = 0

    def _unit0(self, b):
        u0 = self.plan.units[self.buckets[b][0]]
        return u0, self.plan.params[u0["members"][0]].device

    def _buf(self, b):
        if self.bufs[b] is None:
            plan, n = self.plan, self.plan.n_shards
            u0, dev = self._unit0(b)
            buf = torch.empty(n, sum(self.cols[b]), dtype=u0["upd_dtype"],
                              device=dev)
            for k in self.buckets[b]:
                _, off, s = self.unit_at[k]
                zero_segment(buf, off, s, plan.units[k]["total"], n * s)
            self.bufs[b] = buf
        return self.bufs[b]

    def on_grad(self, j, p):
        """The post-accumulate hook of parameter j."""
        k, m_off = self.member_of[j]
        b, off, s = self.unit_at[k]
        with torch.no_grad():
            write_segment(self._buf(b), off, s, m_off, p.grad.reshape(-1))
        p.grad = None
        self.trace.append(("grad", j))
        self.missing[k].discard(j)
        if not self.missing[k]:
            self.units_left[b] -= 1
        while self.next < len(self.buckets) and \
                self.units_left[self.next] == 0:
            self._launch(self.next)

    def _launch(self, b):
        g, goff = self.group_of[b]
        if self.rows[g] is None:
            u0, dev = self._unit0(b)
            self.rows[g] = torch.empty(self.widths[g], dtype=u0["upd_dtype"],
                                       device=dev)
        width = sum(self.cols[b])
        _, self.works[b] = reduce_scatter_rows(
            self._buf(b), self.mesh, async_op=True,
            out=self.rows[g][goff:goff + width])
        self.trace.append(("reduce_scatter", b))
        self.next = b + 1

    def backward(self, loss_sum, params):
        """``loss_sum``'s backward into ``params`` with the hooks on, then
        every bucket not yet out, in order: a member that got no
        gradient (a parameter the step did not use) reads as zeros."""
        for p in params:
            p.grad = None
        inputs = [p for p in params if p.requires_grad]
        handles = [p.register_post_accumulate_grad_hook(
            functools.partial(self.on_grad, j))
            for j, p in enumerate(params) if p.requires_grad]
        try:
            if inputs:
                loss_sum.backward(inputs=inputs)
        finally:
            for h in handles:
                h.remove()
        for b in range(self.next, len(self.buckets)):
            buf = self._buf(b)
            for k in self.buckets[b]:
                _, off, s = self.unit_at[k]
                for j in self.missing[k]:
                    _, m_off = self.member_of[j]
                    zero_segment(buf, off, s, m_off,
                                 m_off + self.plan.params[j].numel())
                self.missing[k].clear()
            self._launch(b)

    def group_row(self, g, mean: bool) -> torch.Tensor:
        """Group g's reduced row (this rank's shard of each of its units,
        in schedule order) once its buckets' reduce-scatters are done
        (``work.wait()``: on a card the compute stream waits, not the
        host); their packed buffers are released."""
        for b in self.groups[g]:
            self.works[b].wait()
            self.bufs[b] = self.works[b] = None
        row, self.rows[g] = self.rows[g], None
        return row.div_(self.plan.n_shards) if mean else row


def _global_loss(loss: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The global batch's per-sample loss from each rank's part of it:
    one all-gather over the mesh's ``axis`` group, in rank order (rank
    r's rows are the r-th 1/N of the batch, ``place_on_mesh``), so every
    rank returns what the JAX package's step returns. Issued after the
    update's collectives, on the same stream; the host does not wait. A
    scalar loss (no per-sample axis) stays the rank's own."""
    if loss.ndim == 0:
        return loss
    return allgather(loss.contiguous(), axis, mesh)


class _Traced:
    """The place of an array leaf in a signature's ``static_spec``."""

    def __repr__(self):
        return "<traced>"


_TRACED = _Traced()

#: a fused step's signature, field by field (the JAX package's, less the
#: NDArray mask, which the port does not have)
_SIG_FIELDS = ("train_mode", "arg_treedef", "static_spec", "shapes_dtypes",
               "numerics")


def explain_signature_diff(old, new) -> str:
    """Why the second of two fused-step signatures captured a program of
    its own, component by component, in the JAX package's words
    (``mxnet_tpu/analysis/program.py``)."""
    parts = []
    for i, fieldname in enumerate(_SIG_FIELDS):
        a, b = old[i], new[i]
        if a == b:
            continue
        if fieldname == "shapes_dtypes":
            diffs = [f"arg[{j}]: {sa} -> {sb}" for j, (sa, sb) in
                     enumerate(itertools.zip_longest(a, b)) if sa != sb]
            parts.append("traced argument shapes/dtypes changed ("
                         + "; ".join(diffs[:6])
                         + ("; ..." if len(diffs) > 6 else "") + ")")
        elif fieldname == "arg_treedef":
            parts.append(f"argument STRUCTURE changed ({a} -> {b})")
        elif fieldname == "static_spec":
            parts.append("non-array (static) argument values changed — "
                         "each distinct value compiles its own program")
        else:
            parts.append(f"{fieldname} changed ({a} -> {b})")
    return "; ".join(parts) if parts else \
        "signatures identical (cache eviction, not a retrace trigger)"


def _flatten(obj, leaves: list):
    """The structure of nested tuples / lists / dicts (hashable), their
    other values appended to ``leaves`` in order."""
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__, tuple(_flatten(o, leaves) for o in obj))
    if isinstance(obj, dict):
        keys = tuple(sorted(obj))
        return ("dict", keys, tuple(_flatten(obj[k], leaves) for k in keys))
    leaves.append(obj)
    return "*"


def _unflatten(tree, leaves):
    """:func:`_flatten`'s inverse over an iterator of leaves."""
    if tree == "*":
        return next(leaves)
    if tree[0] == "dict":
        return {k: _unflatten(t, leaves) for k, t in zip(tree[1], tree[2])}
    items = [_unflatten(t, leaves) for t in tree[1]]
    return tuple(items) if tree[0] == "tuple" else items


def _watched(params, updater, frozen=()):
    """What a captured step reads or writes in place: the trainable
    parameters, the trainer's frozen ones (``grad_req="null"``: a
    BatchNorm's running statistics) and the trainable ones' optimizer
    states, in order."""
    out = list(params) + list(frozen)
    for i in range(len(params)):
        out += Optimizer.state_tensors(updater.states[i])
    return out


def _copy_back(saved) -> None:
    """Write each ``(tensor, copy)`` pair's copy back into the tensor, in
    place (a captured graph keeps its pointer)."""
    with torch.no_grad():
        for t, copy in saved:
            t.copy_(copy)


@contextlib.contextmanager
def _warmup_scope(warming: list, device, restore: Optional[list] = None):
    """Around a capture's warm-up runs of a train step: the body skips
    its update there (``warming[0]`` is set), so no weight, optimizer
    state or update count changes; the random generators (the device's
    default one, and each one a layer noted: ``recording_draws``) are put
    back as they were before the runs, and so is what a layer wrote in
    place (``note_writes``: a BatchNorm's running statistics, copied
    before its first write), so the capture's first replay is the step's
    first. The warm-up is for the forward and backward (cuBLAS's and
    cuDNN's workspaces and algorithms, the allocator's blocks); the
    update's kernels load at their first launch in the capture, the
    kernel library already loaded (``whole_step_fn``). Yields the list
    of the noted CUDA generators, filled on exit, for the graph to
    register. ``restore``, when given, is filled with what puts the
    same states back, as calls without arguments: a capture that fails
    after the scope calls them again (:meth:`CompiledTrainStep.
    _fall_back`)."""
    from ..checkpoint.state import (_default_rng_state,
                                    _set_default_rng_state)
    rng = _default_rng_state(device)
    generators: list = []
    rec: dict = {}
    warming[0] = True
    try:
        with recording_draws(snapshot=True) as rec:
            yield generators
    finally:
        warming[0] = False
        undo = [functools.partial(_set_default_rng_state, device, rng)]
        for _, g, state, saved in rec.values():
            if g is not None:
                undo.append(functools.partial(g.set_state, state))
                if g.device.type == "cuda" and \
                        all(g is not h for h in generators):
                    generators.append(g)
            if saved:
                undo.append(functools.partial(_copy_back, saved))
        for fn in undo:
            fn()
        if restore is not None:
            restore.extend(undo)


#: set on an error the loss's forward or backward raised inside a step's
#: body: the only failure a first call falls back to eager for
_LOSS_FAILED = "mxt_loss_failed"


def _loss_failed(err) -> bool:
    """Whether ``err``, or an error it was raised from or while handling
    (a failed capture's ``MXNetError``, raised from the capture's end,
    raised while the loss's error went up), came from the loss's forward
    or backward (:func:`_step_body`)."""
    while err is not None:
        if getattr(err, _LOSS_FAILED, False):
            return True
        err = err.__cause__ or err.__context__
    return False


def _step_body(loss_fn, treedef, spec, params, update, drawers: list,
               warming: list, train_mode: bool = True):
    """A fused step's body over its static inputs (the array leaves, in
    order): the forward (with ``train_mode`` False, every layer that
    draws as in eval mode), the gradients of the loss's sum with respect
    to ``params`` (zeros for one the loss does not reach) and
    ``update(grads)``, skipped while ``warming[0]``
    (:func:`_warmup_scope`); returns the per-sample loss. An error of the
    forward or backward is marked :data:`_LOSS_FAILED`; the update's are
    not. A layer of the forward that draws random numbers joins
    ``drawers`` (its training flag is part of the signature). It holds
    what it reads, not the step."""

    def body(*inputs):
        it = iter(inputs)
        leaves = [next(it) if v is _TRACED else v for v in spec]
        args, kwargs = _unflatten(treedef, iter(leaves))
        try:
            with torch.enable_grad(), recording_draws() as rec, \
                    draws_off(not train_mode):
                loss = loss_fn(*args, **kwargs)
                grads = torch.autograd.grad(loss.sum(), params,
                                            allow_unused=True)
        except Exception as e:
            setattr(e, _LOSS_FAILED, True)
            raise
        for m, *_ in rec.values():
            if all(m is not d for d in drawers):
                drawers.append(m)
        if warming[0]:
            _note_update_draws(update)
            return loss.detach()
        aux = update([torch.zeros_like(p) if g is None else g
                      for p, g in zip(params, grads)])
        return loss.detach() if aux is None else (loss.detach(), aux)

    return body


def _keep_grads(bufs, grads):
    """The split program's gradient graph ends here: each gradient copied
    into its static buffer, which the store reduces in place and the
    update graph reads."""
    with torch.no_grad():
        for b, g in zip(bufs, grads):
            b.copy_(g)


def _update_body(update, warming: list):
    """The split program's update graph: ``update`` over its inputs, the
    static gradient buffers, skipped while ``warming[0]``."""

    def body(*grads):
        if warming[0]:
            _note_update_draws(update)
        else:
            update(list(grads))

    return body


def _note_update_draws(update) -> None:
    """A warm-up run skips the update: the generators its rule draws
    from are noted all the same (``Optimizer.note_draws``), so the scope
    registers them with the graph (an SGLD's noise then changes at every
    replay)."""
    note = getattr(update, "note_draws", None)
    if note is not None:
        note()


def _dtype_groups(params):
    """``[(dtype name, [indices])]`` of ``params`` by dtype, sorted (the
    non-finite counts' keys)."""
    groups: dict = {}
    for j, p in enumerate(params):
        groups.setdefault(str(p.dtype).replace("torch.", ""), []).append(j)
    return sorted(groups.items())


def _pack_aux(grad_sq, param_sq, upd_sq, nonfinite, layer=None,
              drift=None) -> torch.Tensor:
    """A step's numerics in one float64 vector: ``[grad_sq, param_sq,
    upd_sq, non-finite count per dtype..., (master drift), (per-layer
    grad_sq...)]`` (float64 keeps every count exact)."""
    parts = [torch.stack([grad_sq.double(), param_sq.double(),
                          upd_sq.double()]),
             torch.stack([n.double() for n in nonfinite])]
    if drift is not None:
        parts.append(drift.double().reshape(1))
    if layer is not None:
        parts.append(layer.double())
    return torch.cat(parts)


def _unpack_aux(buf, dtypes, drift: bool, layers: bool) -> dict:
    """:func:`_pack_aux`'s vector as ``StepNumerics.raw``: views."""
    k = 3 + len(dtypes)
    raw = {"grad_sq": buf[0], "param_sq": buf[1], "upd_sq": buf[2],
           "nonfinite": {dt: buf[3 + i] for i, dt in enumerate(dtypes)}}
    if drift:
        raw["master_drift"] = buf[k]
        k += 1
    if layers:
        raw["layer_grad_sq"] = buf[k:]
    return raw


class _NumericsUpdate:
    """A captured step's ``update(grads)`` with the numerics aux. Before
    the update (which overwrites the weights in place) the gradients and
    the weights are each concatenated into one float32 vector, whose
    sums of squares and non-finite count are a handful of reductions
    (one a tensor would be ~1,600 small kernels for BERT-base); the
    weights' vector is also the copy the update's distance is taken
    from after it. ``per_layer`` adds one norm a gradient. Returns
    :func:`_pack_aux`'s vector. The update itself runs unchanged."""

    def __init__(self, update, params, rescale, per_layer: bool):
        self.update = update
        self.params = list(params)
        self.rescale = rescale
        self.per_layer = per_layer
        self.groups = _dtype_groups(self.params)

    @property
    def note_draws(self):
        return getattr(self.update, "note_draws", None)

    @staticmethod
    def _flat(tensors):
        return torch.cat([t.reshape(-1).float() for t in tensors])

    def __call__(self, grads):
        with torch.no_grad():
            ws = [p.detach() for p in self.params]
            flat_g = self._flat(grads)
            gsq = flat_g.square().sum()
            if len(self.groups) == 1:
                nfs = [torch.count_nonzero(~torch.isfinite(flat_g))]
            else:
                nfs = [torch.count_nonzero(~torch.isfinite(
                    self._flat([grads[j] for j in js])))
                    for _, js in self.groups]
            layer = _telemetry.numerics.sumsq(grads) \
                if self.per_layer else None
            del flat_g
            old = self._flat(ws)
            psq = old.square().sum()
        self.update(grads)
        with torch.no_grad():
            usq = (self._flat(ws) - old).square().sum()
            r2 = torch.as_tensor(self.rescale, device=gsq.device,
                                 dtype=torch.float64).square()
            return _pack_aux(r2 * gsq.double(), psq, usq, nfs,
                             layer=None if layer is None
                             else r2 * layer.double())


def _infer_batch_size(leaves) -> int:
    for leaf in leaves:
        if getattr(leaf, "ndim", 0) >= 1:
            lead = global_lead(leaf)
            return int(leaf.shape[0]) if lead is None else lead
    return 1


class CompiledTrainStep:
    """One callable = forward + backward + (reduction +) update. Built by
    ``Trainer.compile_step(loss_fn)``."""

    def __init__(self, trainer, loss_fn: Callable, donate: bool = True,
                 train_mode: bool = True,
                 zero_shard: Optional[bool] = None, zero_axis: str = "dp",
                 mesh=None, numerics: Optional[str] = None,
                 autotune: Optional[str] = None,
                 analyze: Optional[str] = None):
        self._trainer = trainer
        self._loss_fn = loss_fn
        # the program lint after the first step (analysis/): None |
        # 'report' | 'warn' | 'raise', MXNET_ANALYSIS by default
        self._analyze = _analysis_mode(analyze)
        self._analysis_report = None
        #: lower_entry's records, by (mode, signature)
        self._analysis_cache: dict = {}
        # the autopilot (tuning/): None = the MXNET_AUTOTUNE gate, else
        # 'off' | 'cached' | 'on'; it runs once, at the first call,
        # before the program is captured, so the winner governs it
        self._autotune = autotune
        self._autotune_done = False
        self._autotune_outcome = None
        # ``donate`` is the JAX package's: a graph updates its static
        # buffers in place already, so there is nothing to donate
        self._train_mode = bool(train_mode)
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
        #: the last ZeRO step's hooks and launches, in order
        self._zero_trace: list = []
        # the fused mode: its programs, hyperparameter block, signatures
        # (least recently used first) and the layers that draw
        self._programs: Optional[Programs] = None
        self._watch: Optional[Callable] = None
        self._hp: Optional[DeviceHParams] = None
        self._lru: "OrderedDict[tuple, None]" = OrderedDict()
        self._sig_history: List[tuple] = []
        self._moved = False
        self._drawers: list = []
        # the split program (a store that reduces on the host): the
        # static gradient buffers between its two graphs
        self._split = False
        self._grads: Optional[List[torch.Tensor]] = None
        # numerics: None | 'global' | 'per_layer' (MXNET_NUMERICS by
        # default); part of the signature
        self._numerics = _telemetry.numerics.mode(numerics)
        self._pending_numerics = None
        self._numerics_names: Optional[List[str]] = None
        self._census_done = False
        self._flops: dict = {}
        self._m_retraces = _telemetry.registry().counter(
            _telemetry.names.COMPILE_RETRACES)
        # the checkpoint stack asks the trainer's live steps whether a
        # ZeRO plan owns the optimizer state
        trainer._register_compiled(self)
        if zero_shard and (mesh is not None or current_mesh() is not None
                           or _dist.size() < 2):
            # decidable now: raise at once when it cannot hold
            self._mode = self._decide_mode()

    # ---------------- introspection ----------------
    @property
    def steps_done(self) -> int:
        return self._steps_done

    @property
    def n_traces(self) -> int:
        """Programs the fused mode captured so far (CUDA graphs on a card,
        bodies built on the CPU): one a signature, one more for a
        signature evicted and seen again or whose parameters or optimizer
        states moved since its capture; 0 in the other modes."""
        return self._programs.n_traces if self._programs is not None else 0

    def explain_retrace(self) -> str:
        """WHY the most recent capture happened: a component-wise diff of
        the last two signatures captured (new shapes or dtypes, changed
        non-array arguments or structure, a layer's training flag), or
        that the tensors the program reads moved."""
        if not self._sig_history:
            return "no program traced yet"
        if self._moved:
            return ("parameters or optimizer states moved since the "
                    "capture (new tensors in their place): captured again")
        if len(self._sig_history) < 2:
            return "only one program traced (no retrace to explain)"
        return explain_signature_diff(self._sig_history[-2],
                                      self._sig_history[-1])

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

    @property
    def zero_trace(self) -> list:
        """The last ZeRO step's events in the order they happened:
        ``("grad", j)`` when parameter j's gradient arrived,
        ``("reduce_scatter", b)`` / ``("all_gather", b)`` when bucket b's
        collective was launched."""
        return list(self._zero_trace)

    @property
    def buckets(self) -> List[list]:
        """The ZeRO bucket schedule (unit indices a bucket, in launch
        order; empty before the first ZeRO step)."""
        return [list(b) for b in self._buckets]

    # ---------------- numerics instrumentation ----------------
    @property
    def numerics(self) -> Optional[str]:
        """Active numerics mode: None (off) | 'global' | 'per_layer'."""
        return self._numerics

    def set_numerics(self, mode: Optional[str]):
        """Switch the numerics mode ('off'/None, 'global', 'per_layer').
        The mode is part of the signature: the next call of a signature
        captures its instrumented program; the others stay."""
        self._numerics = _telemetry.numerics.mode(mode or "off")

    def take_numerics(self):
        """Pop the :class:`~mxnet_tpu_torch.telemetry.StepNumerics`
        record of the most recent step (None when numerics is off). The
        TrainLoop pushes it into the dispatch window beside the loss, so
        it is read at the retire; a caller without a window can hand it
        to ``telemetry.numerics.monitor()`` or call
        :meth:`numerics_values`."""
        rec, self._pending_numerics = self._pending_numerics, None
        return rec

    def numerics_values(self) -> Optional[dict]:
        """The last step's numerics, read now: pops the record, publishes
        it through the monitor (gauges, divergence anomalies, forensics)
        as a retire would, and returns its host values — None when
        numerics is off or no step ran. This WAITS for the step."""
        rec = self.take_numerics()
        if rec is None:
            return None
        return _telemetry.numerics.monitor().observe_retire(
            self._steps_done, rec)

    def _numerics_param_names(self) -> List[str]:
        """The trainable parameters' names in the trainer's order: the
        keys of the dict the trainer was given (``collect_params()`` /
        ``named_parameters()`` names, as the JAX package's)."""
        if self._numerics_names is None:
            tr = self._trainer
            by_id = {id(p): n for p, n in zip(tr._all_params,
                                              tr._param_names)}
            self._numerics_names = [by_id.get(id(p), str(j))
                                    for j, p in enumerate(tr._params)]
        return self._numerics_names

    def _numerics_context(self, batch_size) -> dict:
        tr = self._trainer
        opt = tr._optimizer
        ctx = {"optimizer": type(opt).__name__,
               "learning_rate": float(opt.learning_rate),
               "wd": float(getattr(opt, "wd", 0.0) or 0.0),
               "rescale_grad": float(opt.rescale_grad),
               "clip_gradient": None if opt.clip_gradient is None
               else float(opt.clip_gradient),
               "batch_size": batch_size,
               "step_in_program": self._steps_done + 1,
               "loss_scale": None, "mode": self._mode}
        scaler = getattr(tr, "_amp_loss_scaler", None)
        if scaler is not None:
            ctx["loss_scale"] = float(scaler.loss_scale)
        return ctx

    def _stash_numerics(self, aux, batch_size, args, kwargs,
                        drift: bool = False):
        """Wrap this step's aux vector in a StepNumerics record for the
        dispatch window: the vector (on the device until the retire
        reads it), the host-side context and the one-shot NaN-origin
        forensic closure over the step's own batch."""
        params = self._trainer._params
        rec = _telemetry.numerics.StepNumerics(
            mode=self._numerics,
            raw=_unpack_aux(aux, [dt for dt, _ in _dtype_groups(params)],
                            drift, self._numerics == "per_layer"),
            param_names=self._numerics_param_names(),
            context=self._numerics_context(batch_size),
            forensic=functools.partial(self._numerics_forensics, args,
                                       kwargs))
        self._pending_numerics = rec

    def _numerics_forensics(self, args, kwargs, step_tag):
        """NaN-origin forensics, run ONCE per non-finite episode and
        OUTSIDE the hot loop (the monitor calls it at the retire when the
        ``nonfinite_grad`` anomaly fires): the step's loss and backward
        re-run eagerly on the step's batch under
        ``telemetry.numerics.localize_nonfinite`` to name the first op
        that produced a non-finite value, then once more for the ranked
        per-layer norm table. The weights are the CURRENT ones (the step
        updated them in place), so the replay chases the batch, not the
        exact weight state (the dump says so). The random generators are
        put back after."""
        nx = _telemetry.numerics
        tr = self._trainer
        params = list(tr._params)
        info = {"params_at": "retire (post-update weights)"}

        def grads():
            loss = self._forward(args, kwargs)
            g = torch.autograd.grad(loss.sum(), params, allow_unused=True)
            return loss, g

        devices = [self._device.index or 0] \
            if self._device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            info["offending_op"] = nx.localize_nonfinite(grads)
        try:
            with torch.random.fork_rng(devices=devices):
                loss, gs = grads()
            info["loss"] = float(loss.detach().double().mean())
            layers = []
            for name, p, g in zip(self._numerics_param_names(), params,
                                  gs):
                g = torch.zeros_like(p) if g is None else g.detach()
                ga = g.double()
                fin = torch.isfinite(ga)
                layers.append({
                    "param": name, "shape": list(g.shape),
                    "dtype": str(g.dtype).replace("torch.", ""),
                    "grad_norm": float(ga[fin].square().sum().sqrt()),
                    "param_norm": float(p.detach().double().norm()),
                    "nonfinite": int((~fin).sum())})
            layers.sort(key=lambda d: (-d["nonfinite"], -d["grad_norm"]))
            info["layers"] = layers
        except Exception as e:
            info["reexec_error"] = f"{type(e).__name__}: {e}"
        return info

    # ---------------- telemetry ----------------
    def _register_census(self):
        """File the step's long-lived buffers in the memory census:
        parameters under ``params``, optimizer states (and ZeRO master
        shards) under ``optimizer``. By weakref and idempotent, once
        after the first step: the updates write in place."""
        c = _telemetry.memory.census()
        for p in self._trainer._all_params:
            c.register("params", p)
        if self._zero is not None:
            self._zero.state_bytes_per_replica()      # registers
        else:
            opt = self._trainer._optimizer
            for st in self._trainer._updater.states.values():
                for s in opt.state_tensors(st):
                    c.register("optimizer", s)
        self._census_done = True

    def step_flops(self, *args, batch_size: Optional[int] = None,
                   **kwargs) -> Optional[float]:
        """FLOPs of one step on this batch's shape — the numerator of
        the live MFU gauge. The port has no ``cost_analysis()``: one
        eager forward and backward on the batch under
        ``torch.utils.flop_counter.FlopCounterMode`` counts the products
        PyTorch runs (the dense layers', cuBLAS's), and each hand-written
        kernel launched in it adds what its wrapper reports
        (``ops.kernels.count_flops``: attention's and the recurrences'
        products, the elementwise work of the norms; FlopCounterMode
        cannot see behind ``ctypes``), plus the update's, once over the
        trainable parameters (the ``opt_update`` kernel's count). Nothing
        is updated and the random generators are put back. Cached by
        signature; None in the ``eager`` mode (as the JAX package has no
        program there)."""
        from torch.utils.flop_counter import FlopCounterMode
        from ..ops.kernels import count_flops
        if self._mode is None:
            self._mode = self._decide_mode()
        if self._mode == "eager":
            return None
        leaves: list = []
        _flatten((args, kwargs), leaves)
        key = tuple((tuple(a.shape), str(a.dtype)) for a in leaves
                    if hasattr(a, "shape"))
        if key in self._flops:
            return self._flops[key]
        params = list(self._trainer._params)
        devices = [self._device.index or 0] \
            if self._device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices), \
                FlopCounterMode(display=False) as fc, count_flops() as kf:
            loss = self._forward(args, kwargs)
            torch.autograd.grad(loss.sum(), params, allow_unused=True)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        flops = float(fc.get_total_flops()) + kf["flops"] \
            + 20.0 * sum(p.numel() for p in params)
        self._flops[key] = flops
        return flops

    def memory_report(self):
        """The captured programs' allocator footprint
        (:class:`~mxnet_tpu_torch.telemetry.MemoryReport`): the field-wise
        max over this step's captures, or None before the first capture
        (and in the modes that capture nothing). Publishes the
        ``mx_hbm_compiled_bytes{component}`` / ``mx_hbm_peak_estimate_
        bytes`` gauges (absent components are not set)."""
        if self._programs is None:
            return None
        reports = [p.memory for p in self._programs.programs()
                   if p.memory is not None]
        if not reports:
            return None
        t = _telemetry
        merged = t.memory.MemoryReport.merge(reports)
        reg = t.registry()
        g = reg.gauge(t.names.HBM_COMPILED_BYTES)
        for field in merged.FIELDS:
            v = getattr(merged, field)
            if v is not None:
                g.set(v, label=field.replace("_bytes", ""))
        reg.gauge(t.names.HBM_PEAK_BYTES).set(merged.peak_bytes)
        return merged

    def input_placement(self) -> Optional[Callable]:
        """What :meth:`__call__` applies to each input leaf, or None on
        one device (``.to(device)`` then suffices): under a dp mesh
        ``place(x)`` is ``parallel.place_on_mesh``, this rank's 1/N of
        the leading axis, marked so the step passes it through with no
        second copy. ``TrainLoop.prefetch`` stages batches through it."""
        if self._zero_ok is not None:
            mesh, axis = self._zero_ok
        elif self._plain_mesh is not None:
            mesh, axis = self._plain_mesh
        else:
            mesh, axis = self._zero_mesh or current_mesh(), self._zero_axis
            if mesh is None or axis not in mesh.axis_names \
                    or mesh.shape[axis] < 2:
                return None
        return functools.partial(place_on_mesh, mesh, axis)

    @property
    def device(self) -> torch.device:
        return self._device

    def optimizer_state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds: its shards under the
        sharded update, every parameter's state otherwise."""
        if self._zero is not None:
            return self._zero.state_bytes_per_replica()
        opt = self._trainer._optimizer
        c = _telemetry.memory.census()
        total = 0
        for st in self._trainer._updater.states.values():
            for s in opt.state_tensors(st):
                c.register("optimizer", s)
                total += _telemetry.memory.device_bytes(s)
        return total

    # ---------------- mode decision ----------------
    def _decide_mode(self) -> str:
        tr = self._trainer
        if not tr._kv_initialized:
            # a dist store needs its setup (the broadcast of rank 0's
            # weights, the update decision); a one-process store is not
            # read by the step, so it never updates, as the JAX package
            # decides
            if isinstance(tr._kvstore, KVStoreDist):
                tr._init_kvstore()
            else:
                tr._update_on_kvstore = False
        if tr._update_on_kvstore:
            return "eager"      # the optimizer lives on the store
        if self._resolve_zero():
            return "zero"
        # float32 masters fuse only through the sharded update
        masters = tr._optimizer.multi_precision and any(
            p.dtype in LOW_PRECISION for p in tr._params)
        if self._host_allreduce() and tr._params and not masters:
            # the store sums on the host: the split program, under a dp
            # mesh too (the store's sum over the ranks is the mesh's)
            if self._plain_mesh is not None and \
                    self._plain_mesh[0].size != _dist.size():
                raise MXNetError(
                    "compile_step: a dist store sums over every rank; the "
                    f"mesh {self._plain_mesh[0].shape} spans "
                    f"{self._plain_mesh[0].size} of {_dist.size()}")
            self._split = True
            return "fused"
        if self._plain_mesh is not None:
            return "mesh"
        if not tr._params or masters:
            return "eager"
        if _dist.size() > 1:
            # several ranks without a mesh: Trainer.step reduces
            return "eager"
        return "fused"

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

    # ---------------- autotune ----------------
    @property
    def autotune_result(self):
        """The :class:`~mxnet_tpu_torch.tuning.AutotuneOutcome` of this
        step's tuning (None before the first call; an 'off' outcome when
        the gate is off)."""
        return self._autotune_outcome

    def autotune(self, *args, batch_size: Optional[int] = None,
                 mode: Optional[str] = None, **kwargs):
        """Tune this step for the shape ``args`` pin now (the first call
        does it when ``compile_step(autotune=)`` / ``MXNET_AUTOTUNE`` arms
        it). Returns the outcome; the winner applies as tuned overrides
        and, after a search, is kept in ``MXNET_AUTOTUNE_CACHE``."""
        from .. import tuning as _tuning
        self._autotune_done = True
        self._autotune_outcome = _tuning.tune_step(
            self, args, kwargs, batch_size=batch_size,
            mode=mode if mode is not None else self._autotune)
        return self._autotune_outcome

    def _maybe_autotune(self, args, kwargs, batch_size):
        """The first call's tuning. A tuning that fails costs the tuned
        config, not the run: a warning, and the defaults train."""
        from .. import tuning as _tuning
        self._autotune_done = True
        if _tuning.autotune_mode(self._autotune) == "off":
            self._autotune_outcome = _tuning.AutotuneOutcome("off", "off")
            return
        try:
            self._autotune_outcome = _tuning.tune_step(
                self, args, kwargs, batch_size=batch_size,
                mode=self._autotune)
        except Exception as e:
            _LOG.warning("compile_step: autotune failed (%s: %s); "
                         "running with defaults", type(e).__name__, e)

    def _drop_programs(self):
        """Drop every captured program, its graph freed at once
        (``Programs.clear``), and a ZeRO plan (rebuilt at the next call
        from the optimizer's states): the next call captures (or plans)
        anew under the tunables in force then. The autotuner's trials
        call it between candidates that differ in a program-affecting
        tunable."""
        if self._programs is not None:
            self._programs.clear()
        self._lru.clear()
        self._analysis_cache.clear()
        if self._zero is not None:
            self._zero = None
            self._buckets = []

    def __call__(self, *args, batch_size: Optional[int] = None, **kwargs):
        from ..elastic import detect
        if not self._autotune_done and not self._steps_done:
            self._maybe_autotune(args, kwargs, batch_size)
        if self._mode is None:
            self._mode = self._decide_mode()
        if self._numerics and (self._mode == "eager" or self._split):
            _LOG.warning(
                "compile_step: numerics instrumentation needs the fused, "
                "zero or mesh step (this one runs %s); disabled",
                "the split program" if self._split else "eagerly")
            self._numerics = None
        mesh = self._zero_ok or self._plain_mesh
        ctx = "dp%d" % (mesh[0].axis_size(mesh[1]) if mesh else 1)
        # the step is a transfer-guard hot region: with
        # MXNET_TRANSFER_GUARD=log|raise a host sync in here (an .item()
        # in the loss) logs its line or raises
        with _tguard.hot_scope("CompiledTrainStep.step"), \
                detect.device_lost_guard("CompiledTrainStep.step",
                                         step=self._steps_done + 1), \
                _telemetry.memory.oom_guard("CompiledTrainStep.step",
                                            step=self._steps_done + 1):
            fault_point("step.dispatch", "before", ctx=ctx)
            loss = self._dispatch(args, kwargs, batch_size)
            fault_point("step.dispatch", "after", ctx=ctx)
        self._steps_done += 1
        if not self._census_done:
            self._register_census()
        if self._analyze is not None and self._analysis_report is None:
            self._run_analysis(args, kwargs, batch_size)
        return loss

    step = __call__

    # ---------------- program analysis (analysis/) ----------------
    @property
    def analysis_report(self):
        """The ProgramReport of the ``analyze=`` run after the first step
        (None before it, or without ``analyze``)."""
        return self._analysis_report or None

    def _run_analysis(self, args, kwargs, batch_size):
        """The program lint after the first step (``analyze=`` /
        MXNET_ANALYSIS): 'report' keeps the ProgramReport, 'warn' also
        logs its findings, 'raise' raises on error-severity findings. As
        in the JAX package, an analysis that fails for another reason
        logs a warning and the run goes on."""
        from ..analysis import program as _aprog
        from ..analysis.lint import lint_function
        try:
            report = _aprog.analyze_step(self, *args,
                                         batch_size=batch_size, **kwargs)
        except MXNetError:
            raise
        except Exception as e:   # analysis must not kill a healthy run
            _LOG.warning("compile_step: program analysis failed "
                         "(%s: %s); skipping", type(e).__name__, e)
            self._analysis_report = False
            return
        try:
            # the source lint explains WHY a step fell back to eager
            # (the .item() line) alongside the program findings
            report.findings.extend(lint_function(self._loss_fn))
        except Exception:        # pragma: no cover - defensive
            pass
        self._analysis_report = report
        if self._analyze == "warn" and not report.ok:
            _LOG.warning("compile_step program analysis:\n%s",
                         report.summary())
        elif self._analyze == "raise":
            report.raise_if_findings()

    def analyze(self, *args, batch_size: Optional[int] = None, **kwargs):
        """The program lint of this batch's step
        (:class:`~mxnet_tpu_torch.analysis.ProgramReport`): collective
        census, donation audit, host transfers, dtype drift, the kernel
        census, the sharding audit and the overlap census, over the
        schedule record of one run of the step's body
        (:meth:`lower_entry`). Nothing changes: no update count advances,
        and the weights, states and generators are put back bit for
        bit."""
        from ..analysis.program import analyze_step
        return analyze_step(self, *args, batch_size=batch_size, **kwargs)

    def fusion_report(self, *args, batch_size: Optional[int] = None,
                      **kwargs):
        """The kernel census of this batch's step
        (:class:`~mxnet_tpu_torch.analysis.fusion.FusionReport`), None in
        the eager mode. Cached with :meth:`analyze`'s report."""
        report = self.analyze(*args, batch_size=batch_size, **kwargs)
        return getattr(report, "fusion", None)

    def sharding_report(self, *args, batch_size: Optional[int] = None,
                        **kwargs):
        """The sharding audit of this batch's step
        (:class:`~mxnet_tpu_torch.analysis.sharding.ShardingAudit`), None
        in the eager mode. Cached with :meth:`analyze`'s report."""
        report = self.analyze(*args, batch_size=batch_size, **kwargs)
        return getattr(report, "sharding", None)

    def lower_entry(self, *args, batch_size: Optional[int] = None,
                    **kwargs):
        """Record this batch's step for static analysis: a dict with the
        JAX package's keys where they apply (``kind``, ``mode``,
        ``mesh``, ``axis``, ``expected_donated``, ``unit_sizes``,
        ``n_params``, ``n_state_leaves``, ``blessed_dtypes``,
        ``report``) and ``schedule`` in place of ``lowered`` /
        ``jaxpr``: the :class:`~mxnet_tpu_torch.analysis.schedule.
        ScheduleRecord` of one run of the step's body, forward, backward,
        collectives and update, run eagerly (on a card the kernels
        launch; no graph is captured). Also ``table`` (the sharding
        table), ``gather_sizes`` and ``mesh_size``. ``None`` in the
        ``eager`` mode, where there is no step program. The weights,
        optimizer states (a ZeRO plan's shards), update counts, random
        generators and running statistics are put back bit for bit after
        the run, and ``n_traces`` does not move. Cached per signature;
        under a dp mesh every rank must call it (the run has the step's
        collectives)."""
        from ..analysis import schedule as _sched
        from ..analysis.sharding import sharding_table
        from ..tuning import _snapshot_step
        if self._mode is None:
            self._mode = self._decide_mode()
        if self._mode == "eager":
            return None
        leaves: list = []
        _flatten((args, kwargs), leaves)
        key = (self._mode, self._split, self._numerics,
               tuple((tuple(getattr(a, "shape", ())),
                      str(getattr(a, "dtype", type(a).__name__)))
                     for a in leaves))
        info = self._analysis_cache.get(key)
        if info is not None:
            return info
        if self._zero_ok is not None and self._zero is None:
            self._prepare_zero()
        tr, opt = self._trainer, self._trainer._optimizer
        restore = _snapshot_step(self, create_states=self._zero is None)
        try:
            watch = self._analysis_watch()
            with self._analysis_stream():
                # the mode's own dispatch, the fused step's capture and
                # replay replaced by one eager run of the same body
                rec, _ = _sched.record(self._dispatch, args, kwargs,
                                       batch_size, self._record_call,
                                       watch=watch)
        finally:
            restore()
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        from .. import amp as _amp
        blessed = [("bfloat16", "float32"), ("float16", "float32")] \
            if (opt.multi_precision or _amp.is_enabled()) else []
        mesh = self._zero_ok or self._plain_mesh
        mode = "split" if self._split else self._mode
        rec.meta.update(mode=mode, device=str(self._device))
        plan = self._zero
        info = dict(
            kind=mode, mode=mode, schedule=rec,
            mesh=mesh[0] if mesh else None,
            axis=mesh[1] if mesh else None,
            mesh_size=mesh[0].axis_size(mesh[1]) if mesh else 1,
            expected_donated=sum(len(v) for v in watch.values()),
            unit_sizes=sorted({u["padded"] for u in plan.units}
                              | {u["total"] for u in plan.units})
            if plan is not None else sorted({int(p.numel())
                                             for p in tr._params}),
            gather_sizes=self._zero_gather_sizes(),
            n_params=len(tr._params),
            n_state_leaves=len(watch.get("states", ())),
            blessed_dtypes=blessed,
            table=sharding_table(self, leaves), report=None)
        self._analysis_cache[key] = info
        return info

    @contextlib.contextmanager
    def _analysis_stream(self):
        """Where the fused mode's record runs on a card: the capture
        stream, as a capture's warm-up runs the body (the autograd nodes
        a run creates remember their stream, and a capture must find its
        own there); the current stream waits for it after."""
        if self._mode != "fused" or self._device.type != "cuda":
            yield
            return
        from ..captured import _capture_stream
        cur = torch.cuda.current_stream(self._device)
        stream = _capture_stream(self._device)
        stream.wait_stream(cur)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            cur.wait_stream(stream)

    def _zero_gather_sizes(self) -> List[int]:
        """The ZeRO step's all-gather payloads: one a run of buckets of
        one dtype (``_BucketReducer.groups``), N times its row."""
        plan = self._zero
        if plan is None:
            return []
        n, sizes, key = plan.n_shards, [], None
        for idx in self._buckets:
            u0 = plan.units[idx[0]]
            k = (u0["upd_dtype"], u0["dtypes"][0])
            if k != key:
                key = k
                sizes.append(0)
            sizes[-1] += sum(plan.units[j]["padded"] // n for j in idx)
        return [n * s for s in sizes]

    def _analysis_watch(self) -> dict:
        """The tensors the step must update in place, by role."""
        tr = self._trainer
        params = list(tr._params)
        watch = {"params": params}
        if self._mode == "zero":
            plan = self._zero
            watch["states"] = [s for st in plan.states for s in (st or ())]
            watch["masters"] = [m for m in plan.masters if m is not None]
            return watch
        states = [tr._updater._state_for(i, p)
                  for i, p in enumerate(params)]
        watch["states"] = [s for st in states
                           for s in Optimizer.state_tensors(st)]
        return watch

    def _record_call(self, args, kwargs, batch_size, mean=False):
        """:meth:`_fused_call` without a capture, for a schedule record:
        one eager run of the body :meth:`_fused_program` captures (the
        split program's gradient body, then the store's sum and the
        update body, as :meth:`_fused_call` runs them). Its
        hyperparameters are staged as a step's; the caller puts the
        state back."""
        tr = self._trainer
        opt, params = tr._optimizer, list(tr._params)
        treedef, spec, arrays, batch_size = self._step_leaves(
            args, kwargs, batch_size)
        states = [tr._updater._state_for(i, p)
                  for i, p in enumerate(params)]
        hp = self._hp if self._hp is not None else \
            DeviceHParams(len(params), self._device)
        opt.stage_device_step(hp, list(range(len(params))))
        grads = [torch.empty_like(p) for p in params] \
            if self._split else None
        body = self._make_body(treedef, spec, params, states, hp, grads,
                               [], [False])
        loss = body(*[self._as_tensor(a) for a in arrays])
        if isinstance(loss, tuple):
            loss = loss[0]
        if grads is not None:
            self._split_reduce(grads, mean)
            _update_body(opt.whole_step_fn(params, states, hp),
                         [False])(*grads)
        for p in params:
            p.fresh_grad = False
        return loss

    def _dispatch(self, args, kwargs, batch_size, fused=None):
        """One step in this step's mode (``fused``: what runs the fused
        body, :meth:`_fused_call` unless given)."""
        fused = fused or self._fused_call
        leaves = list(args) + list(kwargs.values())
        if batch_size is None:
            batch_size = _infer_batch_size(leaves)
        placed = self._zero_ok or self._plain_mesh
        if self._mode == "eager":
            return self._eager_call(args, kwargs, batch_size)
        if self._mode == "fused" and not (self._split and placed):
            return fused(args, kwargs, batch_size)
        mesh, axis = placed
        mean = not batch_is_sharded(mesh, axis, leaves)
        args = tuple(place_on_mesh(mesh, axis, a) for a in args)
        kwargs = {k: place_on_mesh(mesh, axis, v) for k, v in kwargs.items()}
        # a split batch is one global batch: BatchNorm's statistics span
        # the ranks (a batch each rank holds whole needs no collective)
        with split_batch(mesh, axis, split=not mean):
            if self._mode == "zero":
                loss = self._zero_call(args, kwargs, batch_size, mesh, mean)
            elif self._mode == "mesh":
                loss = self._mesh_call(args, kwargs, batch_size, mesh, mean)
            else:
                loss = fused(args, kwargs, batch_size, mean)
        if not mean:
            loss = _global_loss(loss, mesh, axis)
        return loss

    def _forward(self, args, kwargs):
        args = tuple(self._as_tensor(a) for a in args)
        kwargs = {k: self._as_tensor(v) for k, v in kwargs.items()}
        with draws_off(not self._train_mode):
            return self._loss_fn(*args, **kwargs)

    def _eager_call(self, args, kwargs, batch_size):
        loss = self._forward(args, kwargs)
        loss.sum().backward()
        self._trainer.step(batch_size)
        return loss.detach()

    # ---------------- the fused (captured) step ----------------
    def aot_compile(self, *args, batch_size: Optional[int] = None,
                    debug_graph: bool = False, **kwargs):
        """Capture this batch's signature ahead of time, everything a
        first call does up to its replay, so a timed loop captures
        nothing. No update count advances and no weight, state or
        generator changes. ``debug_graph`` keeps the captured graph's
        nodes (``CapturedProgram.graph_nodes``). Returns None: the JAX
        package returns XLA's flop count, which a CUDA graph does not
        give."""
        if self._mode is None:
            self._mode = self._decide_mode()
        if self._mode == "fused":
            n = len(self._drawers)
            _, key = self._fused_program(args, kwargs, batch_size,
                                         advance=False, debug=debug_graph)
            if self._split:
                self._update_program()
            self._settle_key(n, *key)
        return None

    def _fused_call(self, args, kwargs, batch_size, mean=False):
        """One replay (the split program: the gradient graph, the store's
        ``pushpull_list``, divided by the ranks when ``mean``, the update
        graph). If the step's first call fails in the loss's forward or
        backward (a loss that syncs with the host cannot be captured),
        :meth:`_fall_back`; any other failure of a first call (the update
        kernel's build or launch, the signature) raises ``MXNetError``."""
        tr = self._trainer
        opt = tr._optimizer
        counts = dict(opt._index_update_count), opt.num_update
        n = len(self._drawers)
        restore: list = []
        try:
            prog, key = self._fused_program(args, kwargs, batch_size,
                                            advance=True, restore=restore)
            upd = self._update_program() if self._split else None
            loss = prog.run()
            if isinstance(loss, tuple):
                loss, aux = loss
                self._stash_numerics(aux, batch_size, args, kwargs)
        except Exception as e:
            # a step that did not run updates nothing, its counts included
            opt._index_update_count, opt.num_update = counts
            if self._steps_done:
                raise
            if not _loss_failed(e):
                if isinstance(e, MXNetError):
                    raise
                raise MXNetError(f"compile_step: {type(e).__name__}: "
                                 f"{e}") from e
            return self._fall_back(e, restore, args, kwargs, batch_size,
                                   mean)
        except BaseException:
            opt._index_update_count, opt.num_update = counts
            raise
        self._settle_key(n, *key)
        if upd is not None:
            self._split_reduce(self._grads, mean)
            upd.run()
        for p in tr._params:
            p.fresh_grad = False
        return loss

    def _fall_back(self, err, restore, args, kwargs, batch_size, mean):
        """The first call's loss failed in its program (on a card: a loss
        that syncs with the host cannot be captured). As the JAX package
        does: drop the programs and their graph pool, put back the random
        generators and the in-place writes (running statistics) the
        warm-up had put back (the failed capture may have drawn), log a
        warning and run the step eagerly, from now on too
        (under a dp mesh the ``mesh`` mode, the eager step over this
        rank's part). The update counts were already put back, so Adam's
        first real step has t = 1."""
        _LOG.warning("compile_step: the fused program failed (%s: %s); "
                     "falling back to the eager step", type(err).__name__,
                     err)
        for fn in restore:
            fn()
        self._programs = self._hp = self._watch = self._grads = None
        self._lru.clear()
        self._sig_history = []
        self._split = False
        if self._plain_mesh is not None:
            self._mode = "mesh"
            return self._mesh_call(args, kwargs, batch_size,
                                   self._plain_mesh[0], mean)
        self._mode = "eager"
        return self._eager_call(args, kwargs, batch_size)

    def _settle_key(self, n_drawers, sig, treedef, spec, shapes):
        """The body's first run (its capture's warm-up on a card, the
        call itself on the CPU) found layers that draw: file the program
        under the signature with their training flags."""
        if len(self._drawers) == n_drawers:
            return
        new = self._signature(treedef, spec, shapes)
        if new == sig:
            return
        self._programs.rekey(sig, new)
        self._lru.pop(sig, None)
        self._lru[new] = None
        self._sig_history = [new if h == sig else h
                             for h in self._sig_history]

    def _signature(self, treedef, spec, shapes) -> tuple:
        sig = (tuple(m.training and self._train_mode
                     for m in self._drawers), treedef, spec, shapes,
               self._numerics)
        try:
            hash(sig)
        except TypeError as e:
            raise MXNetError("compile_step: a non-array argument of the "
                             f"step must be hashable ({e})") from e
        return sig

    def _fused_program(self, args, kwargs, batch_size, advance: bool,
                       restore: Optional[list] = None, debug: bool = False):
        """The program of this call's signature (captured when new or
        moved; the split program's gradient graph), the batch copied into
        its static inputs and, when ``advance``, the update counts
        advanced and the step's hyperparameters staged; and
        ``(signature, treedef, static spec, shapes)``. ``restore`` is
        filled with the generator states a capture's warm-up put back;
        ``debug`` keeps a new capture's graph nodes."""
        tr, dev = self._trainer, self._device
        opt, n = tr._optimizer, len(tr._params)
        if self._programs is None:
            self._hp = DeviceHParams(n, dev)
            self._watch = functools.partial(
                _watched, list(tr._params), tr._updater,
                [p for p in tr._all_params if p.grad_req == "null"])
            self._programs = Programs(self._watch, dev)
            if self._split:
                self._grads = [torch.empty_like(p) for p in tr._params]
        treedef, spec, arrays, batch_size = self._step_leaves(
            args, kwargs, batch_size)
        states = [tr._updater._state_for(i, p)
                  for i, p in enumerate(tr._params)]
        if advance:
            opt.stage_device_step(self._hp, list(range(n)))
        shapes = tuple((tuple(a.shape), str(a.dtype).replace("torch.", ""))
                       for a in arrays)
        sig = self._signature(treedef, spec, shapes)
        known = sig in self._lru
        traces = self._programs.n_traces
        warming = [False]

        def build():
            inputs = [torch.empty(a.shape, dtype=a.dtype,
                                  device=dev).copy_(a) for a in arrays]
            return (self._make_body(treedef, spec, list(tr._params), states,
                                    self._hp, self._grads, self._drawers,
                                    warming), inputs)

        prog = self._programs.get(
            sig, build, what=f"train step {shapes}",
            scope=functools.partial(_warmup_scope, warming, dev, restore),
            debug=debug)
        if self._programs.n_traces != traces:
            self._m_retraces.inc()
            self._moved = known
            self._lru[sig] = None
            self._sig_history.append(sig)
            cap = _env_int("MXNET_FUSED_STEP_CACHE_SIZE", 0)
            while cap > 0 and len(self._lru) > cap:
                old, _ = self._lru.popitem(last=False)
                self._programs.drop(old)
        self._lru.move_to_end(sig)
        for dst, a in zip(prog.inputs, arrays):
            if a.device.type == "cpu" and dev.type == "cuda":
                a = a.pin_memory()
            dst.copy_(a, non_blocking=True)
        return prog, (sig, treedef, spec, shapes)

    def _step_leaves(self, args, kwargs, batch_size):
        """``(treedef, static spec, arrays, batch size)`` of a call's
        arguments (numpy arrays as tensors, the batch size inferred when
        not given); sets the optimizer's ``rescale_grad`` for it."""
        tr = self._trainer
        leaves: list = []
        treedef = _flatten((args, kwargs), leaves)
        leaves = [torch.from_numpy(np.ascontiguousarray(v))
                  if isinstance(v, np.ndarray) else v for v in leaves]
        arrays = [v for v in leaves if isinstance(v, torch.Tensor)]
        if batch_size is None:
            batch_size = _infer_batch_size(arrays)
        tr._optimizer.rescale_grad = tr._scale / batch_size
        spec = tuple(_TRACED if isinstance(v, torch.Tensor) else v
                     for v in leaves)
        return treedef, spec, arrays, batch_size

    def _make_body(self, treedef, spec, params, states, hp, grads,
                   drawers: list, warming: list):
        """The fused step's body (:func:`_step_body`): its update the
        optimizer's whole step over ``hp`` (with the numerics aux when
        asked), or, in the split program, the copy of each gradient into
        ``grads``."""
        if self._split:
            update = functools.partial(_keep_grads, grads)
        else:
            update = self._trainer._optimizer.whole_step_fn(params, states,
                                                            hp)
            if self._numerics:
                update = _NumericsUpdate(update, params, hp.rescale,
                                         self._numerics == "per_layer")
        return _step_body(self._loss_fn, treedef, spec, params, update,
                          drawers, warming, self._train_mode)

    def _split_reduce(self, grads, mean: bool) -> None:
        """The split program's sum between its graphs: ``grads`` (the
        gradient buffers) reduced in place through the store."""
        tr = self._trainer
        for p, g in zip(tr._params, grads):
            p.grad, p.fresh_grad = g, True
        try:
            tr._allreduce_grads(mean=mean, all_fresh=True)
        finally:
            for p in tr._params:
                p.grad = None

    def _update_program(self):
        """The split program's update graph (one for every signature,
        captured again when the parameters or states move): the update of
        every trainable parameter from the static gradient buffers, its
        hyperparameters read from the device block."""
        tr, dev = self._trainer, self._device
        warming = [False]

        def build():
            params = list(tr._params)
            states = [tr._updater._state_for(i, p)
                      for i, p in enumerate(params)]
            update = tr._optimizer.whole_step_fn(params, states, self._hp)
            return _update_body(update, warming), self._grads

        return self._programs.get(
            ("update",), build, count=False, what="train step update",
            scope=functools.partial(_warmup_scope, warming, dev))

    def _mesh_call(self, args, kwargs, batch_size, mesh, mean):
        """Replicated update after an all-reduce of every gradient (over
        the mesh, or through a dist store that sums on the host); the
        numerics of the reduced gradients, which every rank holds."""
        tr = self._trainer
        loss = self._forward(args, kwargs)
        loss.sum().backward()
        tr.allreduce_grads(mean=mean,
                           mesh=None if tr._store_reduces() else mesh)
        if self._numerics:
            params = list(tr._params)
            upd = _NumericsUpdate(lambda _g: tr.update(batch_size), params,
                                  tr._scale / batch_size,
                                  self._numerics == "per_layer")
            aux = upd([torch.zeros_like(p) if p.grad is None else p.grad
                       for p in params])
            self._stash_numerics(aux, batch_size, args, kwargs)
        else:
            tr.update(batch_size)
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
                                 tr._updater.states, tr._restored_masters)
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
        self._zero_trace = trace = []
        loss = self._forward(args, kwargs)
        red = _BucketReducer(plan, self._buckets, mesh, trace)
        red.backward(loss.sum(), params)
        lrs, wds, ts, rescale, clip = self._scalars(batch_size)
        rank, n, dev = plan.rank, plan.n_shards, self._device
        ulrs, uwds, uts = plan.stage_hparams(
            *plan.pack_hparams(opt, lrs, wds, ts), rank, dev)
        kernel = opt.kernel_step_fn()
        gathers = []
        zn = _ZeroNumerics(plan, self._numerics, rescale) \
            if self._numerics else None
        for g, bs in enumerate(red.groups):
            # an mp group's gradient was packed, and is reduced, in float32
            g_row = red.group_row(g, mean)
            idx = [k for b in bs for k in self._buckets[b]]
            cols = [c for b in bs for c in red.cols[b]]
            mp = plan.units[idx[0]]["mp"]   # a group is all mp or none
            w_row = torch.empty(g_row.shape, device=g_row.device,
                                dtype=plan.units[idx[0]]["dtypes"][0])
            ws, gs, offs, off = [], [], [], 0
            for k, s in zip(idx, cols):
                ws.append(plan.masters[k] if mp else
                          plan.copy_shard(k, params, rank,
                                          w_row[off:off + s]))
                gs.append(g_row[off:off + s])
                offs.append(off)
                off += s
            sts = tuple(plan.states[k] for k in idx)
            # the weights of an mp group: its masters' rounding
            lows = [w_row[o:o + s] for o, s in zip(offs, cols)] \
                if mp else None
            if zn is not None:
                zn.before(idx, ws, gs)
            step_args = (tuple(ws), tuple(gs), [ulrs[k] for k in idx],
                         [uwds[k] for k in idx], [uts[k] for k in idx],
                         rescale, clip, sts)
            if kernel is not None:
                # the whole group in one launch, in place
                kernel(*step_args, lows=lows)
            else:
                new_ws, new_sts = opt.fused_step_fn()(*step_args)
                for w, nw, st, nst in zip(ws, new_ws, sts, new_sts):
                    w.copy_(nw)
                    for s_, ns in zip(st, nst):
                        s_.copy_(ns)
                for low, w in zip(lows or (), ws):
                    low.copy_(w)
            if zn is not None:
                zn.after(ws, lows)
            full, work = all_gather_rows(w_row, mesh, n, async_op=True)
            trace.append(("all_gather", g))
            gathers.append((idx, cols, offs, w_row, full, work))
        for idx, cols, offs, _w_row, full, work in gathers:
            work.wait()
            for k, s, o in zip(idx, cols, offs):
                plan.write_unit(k, full[:, o:o + s].reshape(-1))
        for p in params:
            p.fresh_grad = False
            p.grad = None
        if zn is not None:
            self._stash_numerics(zn.compose(mesh, self._zero_ok[1]),
                                 batch_size, args, kwargs,
                                 drift=zn.drift is not None)
        return loss.detach()


class _ZeroNumerics:
    """The numerics of a ZeRO step from this rank's shards (the JAX
    ``zero_aux``): sums of squares of the reduced gradient shards, the
    weight (or float32 master) shards and their update, non-finite
    counts by the units' dtype, per parameter the grad sum of squares of
    its columns in this rank's shards, and the float32 masters' drift
    from their low-precision weights; :meth:`compose` sums the ranks'
    (and takes the largest drift) with all-reduces, so every rank
    reports the global statistic. Zero padding adds nothing."""

    def __init__(self, plan, mode, rescale):
        self.plan = plan
        self.per_layer = mode == "per_layer"
        self.r2 = float(rescale) ** 2
        dev = plan.params[0].device
        zero = functools.partial(torch.zeros, (), dtype=torch.float64,
                                 device=dev)
        self.gsq, self.psq, self.usq = zero(), zero(), zero()
        self.dtypes = [dt for dt, _ in _dtype_groups(plan.params)]
        self.nf = {dt: zero() for dt in self.dtypes}
        self.layer = torch.zeros(len(plan.params), dtype=torch.float64,
                                 device=dev) if self.per_layer else None
        self.drift = None
        self._olds = None

    def before(self, idx, ws, gs):
        nx = _telemetry.numerics
        with torch.no_grad():
            self.gsq += nx.sumsq(gs).double().sum()
            self.psq += nx.sumsq(ws).double().sum()
            for k, g in zip(idx, gs):
                dt = str(self.plan.units[k]["dtypes"][0]).replace(
                    "torch.", "")
                self.nf[dt] += nx.nonfinite_count([g]).double()
                if self.per_layer:
                    self._members(k, g)
            self._olds = [w.clone() for w in ws]

    def _members(self, k, g):
        u, plan = self.plan.units[k], self.plan
        s = plan.shard_len(k)
        lo = plan.rank * s
        off = 0
        for j, n in zip(u["members"], u["sizes"]):
            a, b = max(lo, off), min(lo + s, off + n)
            if a < b:
                self.layer[j] += g[a - lo:b - lo].double().square().sum()
            off += n

    def after(self, ws, lows):
        nx = _telemetry.numerics
        with torch.no_grad():
            for o, w in zip(self._olds, ws):
                o.sub_(w)
            self.usq += nx.sumsq(self._olds).double().sum()
            self._olds = None
            for low, w in zip(lows or (), ws):
                d = w.float()
                q = low.float()
                drift = ((d - q).abs() / (d.abs() + 1e-8)).max().double()
                self.drift = drift if self.drift is None \
                    else torch.maximum(self.drift, drift)

    def compose(self, mesh, axis) -> torch.Tensor:
        """This step's aux vector (:func:`_pack_aux`), summed over the
        ranks."""
        vec = _pack_aux(self.r2 * self.gsq, self.psq, self.usq,
                        [self.nf[dt] for dt in self.dtypes],
                        layer=None if self.layer is None
                        else self.r2 * self.layer)
        vec = allreduce(vec, axis, mesh)
        if self.drift is None:
            return vec
        drift = allreduce(self.drift.reshape(1), axis, mesh, op="max")
        k = 3 + len(self.dtypes)
        return torch.cat([vec[:k], drift, vec[k:]])


def _loop_loss(net, loss, *batch):
    """A :class:`TrainLoop`'s loss: all but the last input through
    ``net``, the last as the label."""
    *inputs, label = batch
    return loss(net(*inputs), label)


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
    step). It returns the global batch's per-sample loss (under a dp
    mesh every rank gathers the others' rows, in rank order, as the JAX
    package's step returns them) without waiting for the device; a
    bounded window (``engine.DispatchWindow``, size ``inflight`` or
    ``engine.inflight_steps()``: the tuned value, else
    ``MXNET_INFLIGHT_STEPS``, default 2; ``MXNET_ENGINE_TYPE=NaiveEngine``
    forces 0) makes the host wait, on
    the OLDEST step's loss, only when more steps are outstanding.

    **Checkpoints** (``checkpoint_dir=...``): the loop owns a
    ``checkpoint.TrainCheckpointManager``. At construction it resumes
    from the newest VALID checkpoint there (parameters, the optimizer
    state, the ZeRO shards' included, update counts, scheduler, RNG;
    corrupt ones are skipped with a warning) unless ``resume=False``.
    Every ``checkpoint_every`` steps it retires the window, captures the
    state (the step's one blessed wait for the device) and commits the
    write on a background thread (``async_checkpoint``), keeping the
    newest ``keep_last``. A failed background write surfaces at the next
    save or :meth:`wait`. An interrupt (``KeyboardInterrupt``,
    ``SystemExit``) in :meth:`step` drains the window and leaves a final
    checkpoint before it propagates.

    **Prefetch**: ``for x, y in loop.prefetch(batches): loop.step(x,
    y)`` stages the next batches on the card (this rank's part of each
    under a dp mesh) while the current step runs
    (``gluon.data.DevicePrefetcher``); its stats join
    :meth:`engine_stats`. **Recovery**: :meth:`discard_inflight` retires
    what still completes and discards the rest (the elastic supervisor's
    teardown).

    **Telemetry**: each step counts in ``mx_train_steps_total``; with
    ``MXNET_TELEMETRY`` (or a running profiler) its dispatch is a
    ``dispatch`` span (and a ``torch.profiler.record_function`` named
    ``mx_train_step``, which groups the step's kernels in a device
    trace), and the window's retires feed the watchdog. ``numerics=``
    (``MXNET_NUMERICS``) computes the step's grad / param / update norms
    and non-finite counts inside it (:class:`CompiledTrainStep`); the
    record rides the window beside the loss and is read at its retire
    (``mx_numerics_*``, divergence anomalies, one forensic dump a
    non-finite episode). :meth:`arm_mfu` arms ``mx_model_mfu_ratio``.
    The checkpoint's capture is the other designed wait of the loop."""

    def __init__(self, net, trainer, loss, inflight: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 keep_last: int = 3, async_checkpoint: bool = True,
                 resume: bool = True, numerics: Optional[str] = None):
        from ..engine import DispatchWindow
        self._net = net
        self._loss = loss
        self._trainer = trainer
        # the step holds the net and the loss, not the loop: a loop that
        # is dropped frees its step's programs at once (no cycle for the
        # cyclic collector to find later)
        self._step = trainer.compile_step(
            functools.partial(_loop_loss, net, loss), numerics=numerics)
        self._m_steps = _telemetry.registry().counter(
            _telemetry.names.TRAIN_STEPS)
        if inflight is None:
            from ..engine import inflight_steps
            inflight = inflight_steps()
        if os.environ.get("MXNET_ENGINE_TYPE") == "NaiveEngine":
            inflight = 0
        self._window = DispatchWindow(self._retire, max_inflight=inflight,
                                      what="TrainLoop step")
        self._global_step = 0
        self._every = checkpoint_every
        self._manager = None
        self._prefetcher = None
        if checkpoint_dir is not None:
            from ..checkpoint.manager import TrainCheckpointManager
            self._manager = TrainCheckpointManager(
                checkpoint_dir, keep_last=keep_last,
                async_save=async_checkpoint)
            if resume:
                meta = self._manager.restore_latest(
                    trainer=trainer, net=net, strict=False)
                if meta is not None:
                    self._global_step = int(meta.get("step", 0))
                    _LOG.info("TrainLoop resumed at step %d from %s",
                              self._global_step, checkpoint_dir)

    @staticmethod
    def _retire(loss):
        loss.cpu()         # waits for the step's device work

    def step(self, *batch, batch_size: Optional[int] = None):
        with _tguard.hot_scope("TrainLoop.step"):
            return self._guarded_step(batch, batch_size)

    __call__ = step

    def _guarded_step(self, batch, batch_size):
        from ..engine import allow_sync
        try:
            t = _telemetry
            step_no = self._global_step + 1
            if t.active():
                t0 = time.perf_counter()
                with torch.profiler.record_function("mx_train_step"):
                    loss = self._step(*batch, batch_size=batch_size)
                t.timeline().record("dispatch", t0, time.perf_counter(),
                                    step=step_no)
            else:
                loss = self._step(*batch, batch_size=batch_size)
            self._global_step = step_no
            self._m_steps.inc()
            # the numerics record rides the window with the loss and is
            # read at its retire
            self._window.push(loss, tag=step_no,
                              aux=self._step.take_numerics())
            if self._manager is not None and self._every and \
                    self._global_step % self._every == 0:
                # at the step's boundary, after its retire: the capture's
                # copies to the host are then its only wait
                self._window.drain()
                with allow_sync():
                    self.save_checkpoint()
            return loss
        except (KeyboardInterrupt, SystemExit) as intr:
            fault = self._interrupt_cleanup()
            if fault is not None:
                raise fault from intr
            raise

    def _interrupt_cleanup(self):
        """An interrupt landed in the loop: drain the window (the first
        deferred failure in it is the real story, returned for the
        caller to raise) and, with a checkpoint manager, commit a final
        checkpoint, so the run resumes where it stopped."""
        fault = None
        try:
            self._window.drain()
        except BaseException as e:
            fault = e
            self._window.abandon()
        if self._manager is not None:
            try:
                self._manager.save(self._global_step, trainer=self._trainer,
                                   net=self._net, block=True)
            except Exception:
                _LOG.warning("final checkpoint on interrupt failed",
                             exc_info=True)
        return fault

    def synchronize(self):
        """Retire every outstanding step; a deferred error surfaces here
        attributed to its step."""
        self._window.drain()

    def discard_inflight(self, retire: bool = True):
        """The recovery's window cleanup: retire the steps in flight that
        still complete, then discard everything after the first failure
        (their results died with the device; the newest checkpoint is
        the truth for them). Returns ``(retired, discarded_tags)``. With
        ``retire=False`` nothing is waited for and every step in flight
        is discarded: where another rank is gone, a wait on a step that
        needs its collective would never end."""
        if retire:
            return self._window.drain_partial()
        return 0, self._window.abandon()

    def prefetch(self, batches, depth: Optional[int] = None):
        """Wrap an iterable of host batches in a prefetcher that stages
        them as this loop's step places its inputs (this rank's part
        under a dp mesh, the whole batch on the step's device
        otherwise)::

            for x, y in loop.prefetch(loader):
                loop.step(x, y)

        The copy of batch N+1 to the card overlaps step N. ``depth``
        bounds the staged batches (``MXNET_DEVICE_PREFETCH``, default 2;
        0 stages inline). The stats join :meth:`engine_stats`."""
        from .data.prefetcher import DevicePrefetcher
        self._prefetcher = DevicePrefetcher(
            batches, depth=depth, place=self._step.input_placement(),
            device=self._step.device)
        return self._prefetcher

    def arm_mfu(self, *batch, peak_flops: Optional[float] = None,
                batch_size: Optional[int] = None) -> Optional[float]:
        """Arm the live MFU gauge (``mx_model_mfu_ratio``): this batch's
        FLOPs a step (:meth:`CompiledTrainStep.step_flops`) into the
        watchdog, and ``peak_flops`` (FLOP/s: the card's published peak
        for the step's dtype) as the denominator. The watchdog then sets
        FLOP/s and MFU at every retire. Call it OUTSIDE the timed loop:
        it runs one eager forward and backward. Returns the FLOPs a step
        (None in the eager mode)."""
        flops = self._step.step_flops(*batch, batch_size=batch_size)
        wd = _telemetry.watchdog()
        if flops:
            wd.set_model_flops(flops)
        if peak_flops:
            wd.set_peak_flops(peak_flops)
        return flops

    def engine_stats(self) -> dict:
        """The window's pushes, retires, errors and size, and the last
        :meth:`prefetch` iterator's ``prefetch_batches``,
        ``input_wait_ms``, ``starvation_count`` and ``prefetch_depth``."""
        s = dict(self._window.stats)
        s["inflight_window"] = self._window.max_inflight
        s["pending"] = len(self._window)
        if self._prefetcher is not None:
            s.update(self._prefetcher.stats_snapshot())
        return s

    # ---------------- checkpointing ----------------
    def save_checkpoint(self, block: Optional[bool] = None):
        """Checkpoint now, at :attr:`global_step`; in the background
        unless ``block=True`` (or ``async_checkpoint=False``). Returns
        the captured ``checkpoint.TrainState``."""
        if self._manager is None:
            raise MXNetError("TrainLoop was built without checkpoint_dir=")
        return self._manager.save(self._global_step, trainer=self._trainer,
                                  net=self._net, block=block)

    def wait(self):
        """Wait for the checkpoint write in flight (re-raising its
        error); call it before exiting so the newest one is durable."""
        if self._manager is not None:
            self._manager.wait()

    @property
    def checkpoint_manager(self):
        return self._manager

    @property
    def global_step(self) -> int:
        return self._global_step

    @property
    def compiled_step(self) -> CompiledTrainStep:
        return self._step

    @property
    def trainer(self):
        return self._trainer
