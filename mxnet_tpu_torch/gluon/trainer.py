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
skips it. The kvstore is the single-process store (``"device"``,
``"local"``, ``"tpu"``); a distributed one (``dist_sync``) is not ported
and raises.

Across ranks (``parallel.dist.size() > 1``) :meth:`step` first
all-reduces the gradient of every parameter that some rank's backward
reached, over the active mesh's group, or the default group without a
mesh, so each rank updates from the gradient of the global batch: each rank backpropagates its own part, and
``step(global_batch_size)`` turns the sum into the global mean, as the
reference's global arrays do. ``compile_step``'s ``mesh`` mode reduces
through the same :meth:`allreduce_grads`; its ``zero`` mode
reduce-scatters instead and never calls it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..kvstore import create as create_kvstore
from ..parallel import dist as _dist
from ..parallel.mesh import current_mesh
from .nn.basic_layers import init_param

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore: Optional[str] = None):
        if isinstance(params, dict):
            param_items = sorted(params.items())
            self._params = [p for _, p in param_items]
            self._param_names = [k for k, _ in param_items]
        elif isinstance(params, (list, tuple)):
            self._params = list(params)
            self._param_names = [str(i) for i in range(len(params))]
        else:
            raise MXNetError("params must be a dict or list of Parameters")
        self._kvstore = None if kvstore is None else create_kvstore(kvstore)
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

    def compile_step(self, loss_fn, zero_shard: Optional[bool] = None,
                     zero_axis: str = "dp", mesh=None):
        """One callable for forward, backward and update
        (``gluon/fused_step.py``)::

            step = trainer.compile_step(lambda x, y: loss_blk(net(x), y))
            loss = step(x, y)      # == loss.backward(); step(batch_size)

        Under a mesh with a ``zero_axis`` of size >= 2 (``mesh``, or the
        active ``parallel.make_mesh``) the update is the ZeRO-1 sharded
        one, unless ``zero_shard=False``; ``zero_shard=True`` raises
        where it cannot apply."""
        from .fused_step import CompiledTrainStep
        return CompiledTrainStep(self, loss_fn, zero_shard=zero_shard,
                                 zero_axis=zero_axis, mesh=mesh)

    # ---------------- core ----------------
    def step(self, batch_size: int, ignore_stale_grad: bool = False):
        """Reduce gradients across ranks (:meth:`allreduce_grads`), then
        apply the optimizer with gradients rescaled by 1 /
        ``batch_size``, the global batch's size."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self, mean: bool = False, mesh=None):
        """Sum the gradients over the ranks of ``mesh`` (else the active
        mesh, else the default process group); ``mean`` divides by the
        group's size (a batch every rank computed whole). A no-op in a
        single process.

        Every rank reduces the same parameters in the same order, as the
        reference's ``pushpull_list`` covers every key: one small
        all-reduce of the fresh flags first gives the parameters that some
        rank's backward reached, and a rank whose backward missed one of
        them adds zeros and takes the sum as its fresh gradient. A
        parameter no rank reached stays stale on every rank."""
        if _dist.size() < 2 or not self._params:
            return
        mesh = mesh or current_mesh()
        group = mesh.group if mesh is not None else None
        n = mesh.size if mesh is not None else _dist.size()
        if n < 2:
            return
        fresh = torch.tensor([p.fresh_grad and p.grad is not None
                              for p in self._params], dtype=torch.int32,
                             device=self._params[0].device)
        dist.all_reduce(fresh, op=dist.ReduceOp.MAX, group=group)
        for p, anywhere in zip(self._params, fresh.tolist()):
            if not anywhere:
                continue
            if not (p.fresh_grad and p.grad is not None):
                p.grad = torch.zeros_like(p)
                p.fresh_grad = True
            dist.all_reduce(p.grad, group=group)
            if mean:
                p.grad.div_(n)

    def update(self, batch_size: int, ignore_stale_grad: bool = False):
        """Apply the optimizer only (gradients assumed reduced)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        idxs, grads, datas = [], [], []
        for i, p in enumerate(self._params):
            if not p.fresh_grad:
                if not ignore_stale_grad:
                    raise MXNetError(
                        f"gradient of parameter {self._param_names[i]} has "
                        "not been updated by backward since the last step; "
                        "set ignore_stale_grad=True to suppress")
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
