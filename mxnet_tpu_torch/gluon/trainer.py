"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``): applies
an optimizer to a set of parameters, on one device or, through
:meth:`Trainer.compile_step` on a ``parallel.make_mesh`` mesh, on every
rank of a data-parallel process group (the ZeRO-1 sharded update).

    trainer = Trainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": 1e-3})
    loss = loss_fn(net(x), y)          # per-sample
    loss.backward()
    trainer.step(x.shape[0])

Gradient semantics are the JAX package's, on top of PyTorch's autograd:

- ``grad_req="write"`` (the default): each backward overwrites the
  gradient (a hook on the parameter drops the old one first, where
  PyTorch alone would add), and the Trainer sets it to ``None`` after
  each update, which frees it until the next backward;
- ``grad_req="add"``: gradients accumulate across backward calls and the
  Trainer leaves them (zero them with ``p.grad = None``);
- ``grad_req="null"``: the parameter is frozen and not updated.

A parameter that no backward reached since the last update has a stale
gradient: :meth:`step` raises, unless ``ignore_stale_grad=True``, which
skips it.

The kvstore (``kvstore=``, default ``"device"``) is the JAX package's:
the single-process store, or a distributed one (``"dist_sync"``,
``"dist_async"``, ...: ``kvstore.KVStoreDist`` over the default process
group). Its setup runs at the first :meth:`step`, :meth:`update` or
:meth:`allreduce_grads`, with the JAX package's decision matrix:
``MXNET_UPDATE_ON_KVSTORE`` overrides, else ``update_on_kvstore``
defaults to True only for a dist store with several workers; under it
the store runs the optimizer (``set_optimizer``). A dist store, or one
given ``update_on_kvstore``, is seeded with every trainable parameter
(``init(i, p)``: a dist store broadcasts rank 0's weights to every
rank); ``compression_params`` (``{"type": "2bit" | "1bit" | "fp16" |
"bf16", "threshold": ...}``) compress each gradient with error feedback
before the sum (``parallel.compression``).

Across ranks (``parallel.dist.size() > 1``) :meth:`step` first
reduces the gradient of every parameter that some rank's backward
reached, so each rank updates from the gradient of the global batch:
each rank backpropagates its own part, and ``step(global_batch_size)``
turns the sum into the global mean, as the reference's global arrays
do. A dist store reduces them itself: one bucketed ``pushpull_list``
over those keys, or under ``update_on_kvstore`` one ``push`` a
parameter (the store updates its copy) and a ``pull`` of the new
weights. Any other store leaves it to :meth:`allreduce_grads`' one
all-reduce a gradient over the active mesh's group, or the default
group without a mesh. ``compile_step``'s ``mesh`` mode reduces
through the same :meth:`allreduce_grads`; its ``zero`` mode
reduce-scatters instead and never calls it. Its one-device ``fused`` mode
updates every trainable parameter inside its captured graph (one
``opt_update`` launch a parameter for SGD and Adam), its hyperparameters
staged by :meth:`Optimizer.stage_device_step` from the same counts, lr
and wd :meth:`step` would use; :meth:`step` itself updates eagerly.
"""
from __future__ import annotations

import os
import weakref
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..kvstore import KVStoreDist
from ..kvstore import create as create_kvstore
from ..parallel import dist as _dist
from ..parallel.mesh import current_mesh
from .nn.basic_layers import init_param

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore: Optional[bool] = None):
        if isinstance(params, dict):
            param_items = sorted(params.items())
            self._params = [p for _, p in param_items]
            self._param_names = [k for k, _ in param_items]
        elif isinstance(params, (list, tuple)):
            self._params = list(params)
            self._param_names = [str(i) for i in range(len(params))]
        else:
            raise MXNetError("params must be a dict or list of Parameters")
        # the store object at once (no collective); its setup at the
        # first step (_init_kvstore)
        self._kvstore = None if kvstore is None else create_kvstore(kvstore)
        self._update_on_kvstore = update_on_kvstore
        self._compression_params = compression_params
        self._kv_initialized = False
        # the keys the last reduction pushed to an updating store
        self._pushed: List[int] = []
        for p in self._params:
            if not hasattr(p, "grad_req"):
                init_param(p)       # a parameter made outside gluon.nn
        self._all_params = list(self._params)
        self._params = [p for p in self._params if p.grad_req != "null"]
        optimizer_params = optimizer_params or {}
        self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._updater = opt_mod.get_updater(self._optimizer)
        self._scale = 1.0
        # live CompiledTrainSteps of this trainer (weakrefs: a dropped
        # step must not leak): the checkpoint stack asks them whether a
        # ZeRO plan owns the optimizer state
        self._compiled_refs: List[weakref.ref] = []
        # float32 masters restored from a checkpoint, taken by the next
        # ZeRO plan that is built (checkpoint/state.py)
        self._restored_masters: Dict[int, torch.Tensor] = {}

    # ---------------- properties ----------------
    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    @learning_rate.setter
    def learning_rate(self, lr):
        self._optimizer.learning_rate = lr

    def set_learning_rate(self, lr):
        self._optimizer.learning_rate = lr

    @property
    def optimizer(self):
        return self._optimizer

    def compile_step(self, loss_fn, donate: bool = True,
                     train_mode: bool = True,
                     zero_shard: Optional[bool] = None,
                     zero_axis: str = "dp", mesh=None,
                     analyze: Optional[str] = None,
                     numerics: Optional[str] = None,
                     autotune: Optional[str] = None):
        """One callable for forward, backward and update
        (``gluon/fused_step.py``)::

            step = trainer.compile_step(lambda x, y: loss_blk(net(x), y))
            loss = step(x, y)      # == loss.backward(); step(batch_size)

        On one device (no dp mesh) the step is the ``fused`` mode: one
        captured CUDA graph per batch signature holds the forward, the
        backward and the update, and each call copies the batch in, fills
        the update's lr / wd / t / rescale / clip block on the card and
        replays it (on the CPU the same body runs eagerly). If the loss
        fails in the first call's capture (a loss that syncs with the
        host, e.g. ``.item()``), the step logs a warning and runs eagerly
        from then on, that call included, as the JAX package falls back
        to its tape path; any other failure (the update kernel's build or
        launch) and a later failure raise. bf16 or float16 parameters under
        ``multi_precision`` and ``update_on_kvstore`` run the ``eager``
        mode, as the JAX package sends them.

        A store that cannot reduce in-program (a ``KVStoreDist`` with
        several ranks, or ``_force_fuse``) gets the split program, whose
        ``mode`` still reads ``"fused"``: one captured graph of the
        forward and backward that leaves the gradients in static
        buffers, the store's ``pushpull_list`` on the host summing them in
        place, and one captured graph of the update; under a dp mesh too,
        whose all-reduce the store's sum replaces.

        Under a mesh with a ``zero_axis`` of size >= 2 (``mesh``, or the
        active ``parallel.make_mesh``) the update is the ZeRO-1 sharded
        one, unless ``zero_shard=False``; ``zero_shard=True`` raises
        where it cannot apply. The ``zero`` and ``mesh`` modes run
        eagerly: their NCCL collectives, and the gradient hooks that
        launch the ZeRO reduce-scatters during the backward, are not
        captured yet.

        ``donate`` is accepted for the JAX package's signature: a graph
        updates its static buffers in place already. ``train_mode=False``
        runs the forward with the layers that draw random numbers
        (dropout) in eval mode, whatever their own mode; it is part of
        the signature. ``numerics='global'|'per_layer'``
        (``MXNET_NUMERICS``) adds the step's grad / param / update norms
        and non-finite counts (``telemetry/numerics.py``; losses and
        weights stay bit-equal).

        ``autotune='off'|'cached'|'on'`` (``MXNET_AUTOTUNE`` by default;
        ``tuning/``): at the first call, before the step's program is
        captured, replay this signature's cached winner or search the
        train-scope tunables (``kernels.vmem_tile_budget``,
        ``engine.inflight_steps``, ``zero.*``) and apply the winner; the
        outcome is ``step.autotune_result``. The search runs real steps on
        a card and puts the whole train state back after them. A tuning
        that fails logs a warning and the step trains on the defaults.
        ``analyze='report'|'warn'|'raise'`` (``MXNET_ANALYSIS`` by
        default; ``analysis/``): after the first step, record one run of
        the step's body and lint it (collectives, in-place updates, host
        transfers, dtype drift, the kernel census, sharding and overlap,
        and the source lint of ``loss_fn``); the report is
        ``step.analysis_report``, 'warn' logs its findings and 'raise'
        raises ``MXNetError`` on an error-severity one. The run changes
        nothing (the state is put back bit for bit)."""
        from .fused_step import CompiledTrainStep
        return CompiledTrainStep(self, loss_fn, donate=donate,
                                 train_mode=train_mode,
                                 zero_shard=zero_shard,
                                 zero_axis=zero_axis, mesh=mesh,
                                 numerics=numerics, autotune=autotune,
                                 analyze=analyze)

    # ---------------- compiled-step registry ----------------
    def _register_compiled(self, step):
        self._compiled_refs.append(weakref.ref(step))

    def _live_compiled_steps(self):
        alive, out = [], []
        for ref in self._compiled_refs:
            s = ref()
            if s is not None:
                alive.append(ref)
                out.append(s)
        self._compiled_refs = alive
        return out

    def _zero_state_owner(self):
        """The CompiledTrainStep whose ZeRO plan owns (or will own at its
        next call) the sharded optimizer state, if any."""
        for s in self._live_compiled_steps():
            if s._zero is not None or s._zero_ok is not None:
                return s
        return None

    @property
    def _trainable_names(self) -> List[str]:
        """Each trainable parameter's own name, as the JAX package's
        ``Parameter.name`` gives it: the last part of its path."""
        return [n.rsplit(".", 1)[-1]
                for n, p in zip(self._param_names, self._all_params)
                if p.grad_req != "null"]

    # ---------------- persistence ----------------
    def train_state(self, step: int = 0, net=None, extra=None):
        """The WHOLE training state (parameters, the optimizer state,
        a ZeRO step's shards gathered, update counts, scheduler, RNG) as
        a ``checkpoint.TrainState`` of host arrays; write it with
        ``checkpoint.write_checkpoint`` or let a
        ``checkpoint.TrainCheckpointManager`` do it. Under a ZeRO step
        every rank must call it (it gathers the shards)."""
        from ..checkpoint.state import capture_train_state
        return capture_train_state(trainer=self, net=net, step=step,
                                   extra=extra)

    def load_train_state(self, state, net=None, strict: bool = True):
        """Restore a ``TrainState`` (the inverse of :meth:`train_state`);
        returns its meta dict (with ``"step"``)."""
        from ..checkpoint.state import apply_train_state
        return apply_train_state(state, trainer=self, net=net,
                                 strict=strict)

    def save_states(self, fname: str):
        """The optimizer state in one file (``Updater.get_states``'
        pickle, the JAX package's format), written atomically; under
        ``update_on_kvstore`` the store's updater writes it. It holds
        the eager updater's states only, so it raises while a ZeRO step
        owns the state: use :meth:`train_state` there."""
        if self._zero_state_owner() is not None:
            raise MXNetError(
                "Trainer.save_states cannot serialize the ZeRO-sharded "
                "optimizer state owned by a compile_step program (the "
                "eager updater it pickles does not hold the live moments "
                "and float32 masters). Use trainer.train_state() with "
                "checkpoint.write_checkpoint, or "
                "checkpoint.TrainCheckpointManager / "
                "gluon.TrainLoop(checkpoint_dir=...).")
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        from ..checkpoint.atomic import atomic_write_bytes
        atomic_write_bytes(fname,
                           self._updater.get_states(dump_optimizer=True),
                           fault="trainer.save_states")

    def load_states(self, fname: str):
        """Load :meth:`save_states`' file (into the store's updater under
        ``update_on_kvstore``), or the optimizer state and counts of a
        checkpoint directory (``step-<N>``) of either package."""
        self._init_kvstore()
        if os.path.isdir(fname):
            from ..checkpoint.atomic import read_checkpoint
            from ..checkpoint.state import TrainState, apply_train_state
            arrays, manifest = read_checkpoint(fname)
            apply_train_state(TrainState(arrays, manifest.get("meta", {}),
                                         array_meta=manifest["arrays"]),
                              trainer=self, strict=False)
            return
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # ---------------- kvstore setup ----------------
    def _init_kvstore(self):
        """The store's setup, once, at the first step (the JAX package's
        decision matrix): compression; ``update_on_kvstore`` from
        ``MXNET_UPDATE_ON_KVSTORE`` where it is set, else True only for a
        dist store with several workers; under it the store runs the
        optimizer (its updater is then this trainer's, so checkpoints and
        ``save_states`` see the live state); a dist store, or one that
        updates, seeded with every trainable parameter (``init(i, p)``: a
        dist store's broadcast gives every rank rank 0's weights). A
        one-process store that does not update is never read, so it is
        not seeded."""
        if self._kv_initialized:
            return
        kv = self._kvstore
        if kv is None:
            self._update_on_kvstore = False
        else:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore is None:
                env = os.environ.get("MXNET_UPDATE_ON_KVSTORE")
                if env is not None:
                    self._update_on_kvstore = \
                        env.lower() not in ("0", "false", "no", "")
                else:
                    self._update_on_kvstore = \
                        kv.num_workers > 1 and "dist" in kv.type
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
                self._updater = kv._updater
            if self._update_on_kvstore or isinstance(kv, KVStoreDist):
                for i, p in enumerate(self._params):
                    kv.init(i, p)
        self._kv_initialized = True

    def _store_reduces(self) -> bool:
        """Whether the store sums the gradients across the ranks: a dist
        store that cannot reduce in-program (several ranks, or
        ``_force_fuse``)."""
        kv = self._kvstore
        return isinstance(kv, KVStoreDist) and not kv.in_program_reduce

    # ---------------- core ----------------
    def step(self, batch_size: int, ignore_stale_grad: bool = False):
        """Reduce gradients across ranks (through a dist store, or
        :meth:`allreduce_grads`' all-reduces), then apply the optimizer
        with gradients rescaled by 1 / ``batch_size``, the global batch's
        size (under ``update_on_kvstore`` the store applies it on push
        and the new weights are pulled)."""
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads(ignore_stale_grad)
        self._update(ignore_stale_grad)

    def allreduce_grads(self, mean: bool = False, mesh=None):
        """Sum the gradients over the ranks: through a dist store's
        bucketed ``pushpull_list`` (no ``mesh`` given), else over the
        ranks of ``mesh`` (else the active mesh, else the default process
        group), one all-reduce a gradient; ``mean`` divides by the
        group's size (a batch every rank computed whole). A no-op in a
        single process without a dist store. Under ``update_on_kvstore``
        the gradients are pushed to the store, which updates.

        Every rank reduces the same parameters in the same order, as the
        reference's ``pushpull_list`` covers every key: one small
        all-reduce of the fresh flags first gives the parameters that some
        rank's backward reached, and a rank whose backward missed one of
        them adds zeros and takes the sum as its fresh gradient. A
        parameter no rank reached stays stale on every rank."""
        self._init_kvstore()
        self._allreduce_grads(mean=mean, mesh=mesh)

    def _allreduce_grads(self, ignore_stale_grad=False, mean=False,
                         mesh=None, all_fresh=False):
        """The step's reduction (the JAX package's name). With
        ``all_fresh`` (compile_step's split program, whose backward gives
        every parameter a gradient on every rank) the flags' exchange is
        skipped."""
        self._pushed = []
        if not self._params:
            return
        if mesh is None and self._store_reduces():
            keys = list(range(len(self._params))) if all_fresh \
                else self._agree_fresh(None, _dist.size())
        else:
            keys = self._group_reduce(mean, mesh)
            if not self._update_on_kvstore:
                return
        kv = self._kvstore
        if self._update_on_kvstore:
            # the stale rule before the store updates anything
            self._stale_check(keys, ignore_stale_grad)
            for i in keys:
                kv.push(i, self._params[i].grad)
            self._pushed = keys
            return
        grads = [self._params[i].grad for i in keys]
        kv.pushpull_list(keys, grads)
        if mean:
            for g in grads:
                g.div_(_dist.size())

    def _agree_fresh(self, group, n) -> List[int]:
        """The indices of the parameters some rank's backward reached
        (one MAX all-reduce of the fresh flags over ``group`` when ``n``
        >= 2); a rank that missed one of them takes zeros as its fresh
        gradient."""
        local = [p.fresh_grad and p.grad is not None for p in self._params]
        if n < 2:
            return [i for i, f in enumerate(local) if f]
        fresh = torch.tensor(local, dtype=torch.int32,
                             device=self._params[0].device)
        dist.all_reduce(fresh, op=dist.ReduceOp.MAX, group=group)
        keys = []
        for i, (p, anywhere) in enumerate(zip(self._params, fresh.tolist())):
            if not anywhere:
                continue
            if not local[i]:
                p.grad = torch.zeros_like(p)
                p.fresh_grad = True
            keys.append(i)
        return keys

    def _group_reduce(self, mean, mesh) -> List[int]:
        """One all-reduce a gradient fresh on some rank, over ``mesh``'s
        group (else the active mesh's, else the default group); the
        indices of the fresh ones."""
        n = 1
        if _dist.size() >= 2:
            mesh = mesh or current_mesh()
            n = mesh.size if mesh is not None else _dist.size()
        group = mesh.group if n >= 2 and mesh is not None else None
        keys = self._agree_fresh(group, n)
        if n < 2:
            return keys
        for i in keys:
            g = self._params[i].grad
            dist.all_reduce(g, group=group)
            if mean:
                g.div_(n)
        return keys

    def _stale_error(self, i) -> MXNetError:
        return MXNetError(
            f"gradient of parameter {self._param_names[i]} has not been "
            "updated by backward since the last step; set "
            "ignore_stale_grad=True to suppress")

    def _stale_check(self, fresh, ignore_stale_grad):
        stale = set(range(len(self._params))) - set(fresh)
        if stale and not ignore_stale_grad:
            raise self._stale_error(min(stale))

    def update(self, batch_size: int, ignore_stale_grad: bool = False):
        """Apply the optimizer only (gradients assumed reduced; under
        ``update_on_kvstore`` pull what the store updated)."""
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if self._update_on_kvstore:
            # the store ran the optimizer on push: pull the new weights
            for i in self._pushed:
                p = self._params[i]
                self._kvstore.pull(i, out=p)
                p.fresh_grad = False
                if p.grad_req == "write":
                    p.grad = None
            self._pushed = []
            return
        idxs, grads, datas = [], [], []
        for i, p in enumerate(self._params):
            if not p.fresh_grad:
                if not ignore_stale_grad:
                    raise self._stale_error(i)
                continue      # a stale parameter is skipped, not re-applied
            idxs.append(i)
            grads.append(p.grad)
            datas.append(p)
        if len(idxs) == len(self._params):
            self._updater(idxs, grads, datas)
        else:
            # a subset (stale ones skipped): one parameter at a time, as
            # the JAX package does, so each reads lr after its own count
            for i, g, d in zip(idxs, grads, datas):
                self._updater(i, g, d)
        for p in datas:
            p.fresh_grad = False
            if p.grad_req == "write":
                p.grad = None
