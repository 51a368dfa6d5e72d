"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``: all
19 of its registered rules).

The update rules are the JAX package's, written as pure functions
``rule(w, g, lr, wd, t, states) -> (w', states')`` over tensors; the
optimizer applies them with the JAX package's bookkeeping:

- the gradient is multiplied by ``rescale_grad`` and then clipped to
  ``[-clip_gradient, clip_gradient]``;
- each parameter index counts its own updates ``t``; ``num_update`` is
  their maximum and feeds ``lr_scheduler``;
- lr and wd are scaled by the parameter's ``lr_mult``/``wd_mult``
  (``param_dict``) and by :meth:`Optimizer.set_lr_mult` /
  :meth:`Optimizer.set_wd_mult`, where an index-keyed entry wins over a
  name-keyed one (``param_idx2name``).

A rule reads lr, wd and t as 0-d tensors on the weight's device (float32,
float32, int32), the JAX package's float32 jit arguments, in the eager
update and in a captured step alike (:class:`DeviceHParams`): no rule
branches in Python on their values. Exact SGD and Adam take the
``opt_update`` kernel on a card (``ops/kernels/opt_update.py``); every
other rule runs as PyTorch tensor ops, as the JAX package runs them in
XLA.

``multi_precision=True`` gives a bfloat16 or float16 weight a float32
master copy: :meth:`Optimizer.create_state_multi_precision` returns
``(state, master)``, the rule updates the master with the gradient cast
to float32, and the weight takes ``master.to(weight.dtype)``
(``mxnet_tpu/optimizer/optimizer.py`` ``_update_one``).

``torch.optim`` is not a substitute: it places weight decay elsewhere,
counts one step for all parameters, and has no mults. Updates run on the
parameters' device, in place, with no host sync: weights and states keep
their tensors, and the new values are copied into them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "SGLD", "DCASGD", "Adam",
           "AdamW", "AdaBelief", "Adamax", "Nadam", "AdaGrad", "GroupAdaGrad",
           "AdaDelta", "RMSProp", "Ftrl", "FTML", "LARS", "LAMB", "LANS",
           "Updater", "get_updater", "create", "register", "LOW_PRECISION",
           "DeviceHParams"]

#: the weight dtypes that get a float32 master under ``multi_precision``
LOW_PRECISION = (torch.float16, torch.bfloat16)

_registry: Dict[str, type] = {}


def register(cls):
    """Register an optimizer under its lowercase class name."""
    _registry[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs) -> "Optimizer":
    """An optimizer by registered name (an instance passes through)."""
    if isinstance(name, Optimizer):
        return name
    try:
        cls = _registry[name.lower()]
    except KeyError as e:
        raise MXNetError(f"unknown optimizer {name!r} (ported: "
                         f"{sorted(_registry)})") from e
    return cls(**kwargs)


def _on_card(weight) -> bool:
    """Whether ``weight`` lies on a CUDA device (its update may take the
    ``opt_update`` kernel)."""
    return weight.device.type == "cuda"


class Optimizer:
    """Base optimizer. Subclasses define :meth:`create_state` and
    :meth:`_rule`."""

    #: the rule is elementwise over the weight (no reduction across
    #: elements) and takes per-element lr/wd/t: it runs on flat 1/N
    #: shards, which the ZeRO-1 sharded update keys on
    elementwise_update = True

    def __init__(self, rescale_grad: float = 1.0, param_idx2name=None,
                 wd: float = 0.0, clip_gradient: Optional[float] = None,
                 learning_rate: Optional[float] = None, lr_scheduler=None,
                 multi_precision: bool = False, param_dict=None,
                 begin_num_update: int = 0, use_fused_step: bool = True,
                 **kwargs):
        # use_fused_step and other keywords are taken and not used, as
        # the JAX package's base class takes them
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self._lr_mult: Dict[Any, float] = {}
        self._wd_mult: Dict[Any, float] = {}

    # ---------------- lr/wd handling ----------------
    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self.num_update))
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.lr = lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult: Dict[Any, float]):
        self._lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[Any, float]):
        self._wd_mult = dict(args_wd_mult)

    def _get_lr(self, index) -> float:
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        # an index-keyed mult wins over a name-keyed one for the same
        # parameter
        if index in self._lr_mult:
            lr *= self._lr_mult[index]
        else:
            lr *= self._lr_mult.get(self.idx2name.get(index, index), 1.0)
        return lr

    def _get_wd(self, index) -> float:
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        if index in self._wd_mult:
            wd *= self._wd_mult[index]
        else:
            wd *= self._wd_mult.get(self.idx2name.get(index, index), 1.0)
        return wd

    def _update_count(self, index) -> int:
        cnt = self._index_update_count.get(index, self.begin_num_update) + 1
        self._index_update_count[index] = cnt
        self.num_update = max(cnt, self.num_update)
        return cnt

    # ---------------- state ----------------
    def create_state(self, index, weight: torch.Tensor):
        return ()

    @staticmethod
    def _zeros_state(weight: torch.Tensor, n: int):
        return tuple(torch.zeros_like(weight, memory_format=torch.
                                      contiguous_format) for _ in range(n))

    def create_state_multi_precision(self, index, weight: torch.Tensor):
        """``(state, float32 master)`` for a bfloat16 or float16 weight
        under ``multi_precision``, else :meth:`create_state`. The state is
        float32, like the master it updates (the JAX package's bf16 zeros
        turn float32 at the first update)."""
        if self.multi_precision and weight.dtype in LOW_PRECISION:
            master = weight.detach().to(torch.float32,
                                        memory_format=torch.
                                        contiguous_format)
            return (self.create_state(index, master), master)
        return self.create_state(index, weight)

    @staticmethod
    def is_master_state(weight: torch.Tensor, state) -> bool:
        """Whether ``state`` is a ``(state, master)`` pair of
        :meth:`create_state_multi_precision`."""
        return (weight.dtype in LOW_PRECISION and isinstance(state, tuple)
                and len(state) == 2 and isinstance(state[0], tuple)
                and isinstance(state[1], torch.Tensor))

    @staticmethod
    def state_tensors(state):
        """The tensors of a state, a master's included, flattened: a
        ``(state, master)`` pair gives the state's leaves, then the
        master, as the JAX package's ``tree_leaves`` orders them."""
        if isinstance(state, torch.Tensor):
            return [state]
        return [t for s in state for t in Optimizer.state_tensors(s)]

    @torch.no_grad()
    def fill_state(self, index, weight: torch.Tensor, leaves,
                   template=None):
        """The state of ``weight`` holding ``leaves`` (tensors in
        :meth:`state_tensors` order, anywhere, any dtype): ``template``
        (a live state, else :meth:`create_state_multi_precision`'s) with
        each leaf copied in, so the structure, device and dtypes stay the
        live ones. Leaves that do not fit the template leaf for leaf are
        returned as a flat tuple on the weight's device."""
        if template is None:
            template = self.create_state_multi_precision(index, weight)
        flat = self.state_tensors(template)
        if len(flat) == len(leaves) and all(
                tuple(d.shape) == tuple(s.shape)
                for d, s in zip(flat, leaves)):
            for d, s in zip(flat, leaves):
                d.copy_(s)
            return template
        return tuple(s.to(weight.device) for s in leaves)

    # ---------------- update ----------------
    def _rule(self):
        """``rule(w, g, lr, wd, t, states) -> (w', states')``."""
        raise NotImplementedError

    def _rule_update(self, weight, grad, state, lrs, wds, ts):
        """The rule over whole parameters as a captured step runs it
        (:meth:`fused_step_fn`): lr, wd, t, the rescale and the clip
        staged as 0-d tensors on the weights' device
        (:class:`DeviceHParams`, one copy); a master, and the gradient
        cast to float32, in place of a low-precision weight, which then
        takes the master's rounding."""
        targets, gs, sts, masters = [], [], [], []
        for w, g, st in zip(weight, grad, state):
            master = self.is_master_state(w, st)
            if master:
                st, target = st
                g = g.to(torch.float32)
            else:
                target = w.detach()
            targets.append(target)
            gs.append(g)
            sts.append(tuple(st))
            masters.append(master)
        clip = self.clip_gradient if self.clip_gradient is not None else 0.0
        hp = DeviceHParams(len(targets), targets[0].device)
        hp.stage(lrs, wds, ts, self.rescale_grad, clip)
        new_ws, new_sts = self.fused_step_fn()(
            targets, gs, *hp.per_param(), hp.rescale, hp.clip, sts)
        for w, t, nw, st, nst, master in zip(weight, targets, new_ws, sts,
                                             new_sts, masters):
            t.copy_(nw)
            for s_, ns in zip(st, nst):
                if ns is not s_:
                    s_.copy_(ns)
            if master:
                w.copy_(t)

    # ---------------- the sharded update's surface ----------------
    def fused_step_fn(self):
        """The multi-tensor update as one function over flat units, the
        form the ZeRO-1 sharded update applies to each rank's shard:
        ``(ws, gs, lrs, wds, ts, rescale, clip, states) -> (new_ws,
        new_states)``, new tensors. ``lrs[i]``/``wds[i]`` (float32) and
        ``ts[i]`` (int32) are scalars, per-element vectors
        (:meth:`pack_shard_hparams`) or 0-d tensors on the units' device
        (:class:`DeviceHParams`); an :attr:`elementwise_update` rule
        applies unchanged either way. ``rescale`` and ``clip`` are host
        scalars or 0-d tensors."""
        rule = self._rule()
        has_clip = self.clip_gradient is not None

        def stepfn(ws, gs, lrs, wds, ts, rescale, clip, states):
            new_ws, new_ss = [], []
            for i, (w, g, st) in enumerate(zip(ws, gs, states)):
                dev = w.device
                g = g * torch.as_tensor(rescale, dtype=torch.float32,
                                        device=dev)
                if has_clip:
                    # a device scalar stays where it is: no host read
                    c = clip if isinstance(clip, torch.Tensor) \
                        else float(clip)
                    g = torch.clamp(g, -c, c)
                nw, ns = rule(
                    w, g,
                    torch.as_tensor(lrs[i], dtype=torch.float32, device=dev),
                    torch.as_tensor(wds[i], dtype=torch.float32, device=dev),
                    torch.as_tensor(ts[i], device=dev).to(torch.int32),
                    tuple(st))
                new_ws.append(nw)
                new_ss.append(tuple(ns))
            return tuple(new_ws), tuple(new_ss)

        return stepfn

    def kernel_step_fn(self):
        """:meth:`fused_step_fn` through the ``opt_update`` kernel over
        flat 1-d units, updating them IN PLACE (``ops/kernels/
        opt_update.py``), or None where the rule is not kernelized (exact
        SGD/Adam only: a subclass may override the rule)."""
        from ..ops.kernels.opt_update import kernel_step_fn as _kfn
        return _kfn(self)

    @staticmethod
    def pack_shard_hparams(lrs, wds, ts, member_idx, sizes, padded):
        """Per-element lr/wd/t of a ZeRO bucket unit (several small
        parameters in one flat buffer): each member's scalar repeated
        over its segment, the pad tail lr = wd = 0 and t = 1 so Adam's
        ``1 / (1 - beta**t)`` stays finite there. Returns numpy
        (float32, float32, int32) vectors of length ``padded``."""
        lr_vec = np.zeros(padded, np.float32)
        wd_vec = np.zeros(padded, np.float32)
        t_vec = np.ones(padded, np.int32)
        total = int(np.sum(sizes))
        lr_vec[:total] = np.repeat(
            np.asarray(lrs, np.float32)[member_idx], sizes)
        wd_vec[:total] = np.repeat(
            np.asarray(wds, np.float32)[member_idx], sizes)
        t_vec[:total] = np.repeat(
            np.asarray(ts, np.int32)[member_idx], sizes)
        return lr_vec, wd_vec, t_vec

    def whole_step_fn(self, weights, states, hp: "DeviceHParams"):
        """The update of whole parameters that a captured one-card step
        runs: ``update(grads)`` applies the rule to ``weights`` and their
        ``states`` (this optimizer's, parameter by parameter) IN PLACE,
        reading lr, wd, t, the rescale and the clip from ``hp``'s device
        tensors, so a replay reads each step's values
        (:meth:`stage_device_step`). An :attr:`elementwise_update` rule
        sees each contiguous tensor viewed flat as one unit; any other
        (norms, row means) each weight, gradient and state in its own
        shape. Exact SGD/Adam go through the ``opt_update`` kernel (one
        launch a dtype group for the whole list; on a card the kernel
        library is loaded here, so a capture of the update finds it
        loaded), any other rule through :meth:`fused_step_fn`.
        ``update.note_draws`` is :meth:`note_draws`, which a step whose
        warm-up skips the update calls there instead."""
        flat = self.elementwise_update
        ws = tuple(w.detach().view(-1) if flat else w.detach()
                   for w in weights)
        sts = tuple(tuple(s.view(-1) if flat else s
                          for s in self.state_tensors(st))
                    for st in states)
        fn = None
        if flat and all(w.dtype in (torch.float32, torch.bfloat16)
                        for w in ws):
            fn = self.kernel_step_fn()
            if fn is not None and hp.device.type == "cuda":
                from ..ops.kernels import library
                library()
        fn = fn or self.fused_step_fn()
        lrs, wds, ts = hp.per_param()

        @torch.no_grad()
        def update(grads):
            self.note_draws()
            # whole tensors contiguous, as a weight's .grad: a reduction's
            # order then follows the eager update's
            gs = tuple(g.reshape(-1) if flat else g.contiguous()
                       for g in grads)
            new_ws, new_sts = fn(ws, gs, lrs, wds, ts, hp.rescale, hp.clip,
                                 sts)
            for w, nw, st, nst in zip(ws, new_ws, sts, new_sts):
                if nw is not w:              # fused_step_fn: new tensors
                    w.copy_(nw)
                for s_, ns in zip(st, nst):
                    if ns is not s_:
                        s_.copy_(ns)
        update.note_draws = self.note_draws
        return update

    def stage_device_step(self, hp: "DeviceHParams", indices):
        """Host half of a captured step: :meth:`begin_fused_step` over
        ``indices`` (counts first, then lr and wd), then the values, the
        rescale and the clip, staged into ``hp`` for the step's replay."""
        lrs, wds, ts = self.begin_fused_step(indices)
        clip = self.clip_gradient if self.clip_gradient is not None else 0.0
        hp.stage(lrs, wds, ts, self.rescale_grad, clip)

    def begin_fused_step(self, indices):
        """Host half of a sharded step: advance the update counts of
        ``indices`` first, then read lr and wd (the multi-tensor
        bookkeeping of :meth:`update`). Returns numpy ``(lrs float32,
        wds float32, ts int32)``."""
        ts = [self._update_count(i) for i in indices]
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        return (np.asarray(lrs, np.float32), np.asarray(wds, np.float32),
                np.asarray(ts, np.int32))

    def _host_hparams(self, index, weight, state):
        """``(ts, lrs, wds)`` of an update of ``index``: every count
        advances first and lr/wd are read after, as the JAX package's
        multi-tensor update does; with a master in a list of several, one
        parameter at a time (count, then lr and wd), as it does there."""
        if len(index) > 1 and any(self.is_master_state(w, s)
                                  for w, s in zip(weight, state)):
            hps = [self._host_hparams([i], [w], [s])
                   for i, w, s in zip(index, weight, state)]
            return tuple([h[k][0] for h in hps] for k in range(3))
        ts = [self._update_count(i) for i in index]
        return ts, [self._get_lr(i) for i in index], \
            [self._get_wd(i) for i in index]

    def _kernel_update(self, weight, state):
        """The ``opt_update`` kernel's update of ``weight`` (exact SGD/Adam,
        every weight on a card, float32 or bfloat16, or a float32 master),
        as ``update(ts, lrs, wds, grads)``, or None: then
        :meth:`_rule_update`."""
        from ..ops.kernels import opt_update as KO
        kk = KO.opt_kernel_kind(self)
        if kk is None or not weight or not all(map(_on_card, weight)):
            return None
        targets, lows, sts = [], [], []
        for w, st in zip(weight, state):
            if self.is_master_state(w, st):
                st, master = st
                targets.append(master.view(-1))
                lows.append(w.detach().view(-1))
            elif w.dtype in (torch.float32, torch.bfloat16):
                targets.append(w.detach().view(-1))
                lows.append(None)
            else:
                return None
            sts.append(tuple(s.view(-1) for s in st))
        kind, cfg = kk
        clip = self.clip_gradient if self.clip_gradient is not None else 0.0

        def update(ts, lrs, wds, grads):
            KO.multi_update(kind, cfg, targets,
                            [g.reshape(-1) for g in grads], lrs, wds, ts,
                            self.rescale_grad, clip, sts, lows)
        return update

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        """Update one parameter, or several given as lists: then every
        update count advances first and lr/wd are read after, as the JAX
        package's multi-tensor update does. Exact SGD/Adam with every
        weight on a card take the ``opt_update`` kernel: one launch a
        dtype group (a master's weight is its rounding, written by the
        same launch); on the CPU, and for other rules, the rule runs
        parameter by parameter (:meth:`_rule_update`)."""
        if not isinstance(index, (list, tuple)):
            index, weight, grad, state = [index], [weight], [grad], [state]
        ts, lrs, wds = self._host_hparams(index, weight, state)
        kernel = self._kernel_update(weight, state)
        if kernel is not None:
            kernel(ts, lrs, wds, grad)
            return
        self._rule_update(weight, grad, state, lrs, wds, ts)

    #: the JAX package's name for the same call (``test_utils`` calls it)
    update_multi_precision = update

    def note_draws(self) -> None:
        """Note each generator the rule draws from
        (``gluon.nn.basic_layers.note_draw``), so a captured step
        registers it with its graph and puts it back after its warm-up;
        a rule that draws nothing notes nothing."""

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.learning_rate})"


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` != 0 (wd folded into the
    gradient)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        # the JAX package engages it only for row_sparse gradients, which
        # the port does not make
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return self._zeros_state(weight, 1)

    def _rule(self):
        mom = self.momentum

        def rule(w, g, lr, wd, t, states):
            g = g + wd * w
            if mom == 0.0:
                return w - lr * g, states
            (m,) = states
            m = mom * m - lr * g
            return w + m, (m,)
        return rule


@register
class Adam(Optimizer):
    """Adam with wd folded into the gradient and bias-corrected moments."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update    # as SGD's

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def _rule(self):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon

        def rule(w, g, lr, wd, t, states):
            m, v = states
            g = g + wd * w
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            return w - lr * mhat / (torch.sqrt(vhat) + eps), (m, v)
        return rule


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay: wd applies to the weight, outside
    the adaptive moments."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.correct_bias = correct_bias
        self.lazy_update = True     # as the JAX package sets it

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def _rule(self):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        correct = self.correct_bias

        def rule(w, g, lr, wd, t, states):
            m, v = states
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            if correct:
                mhat = m / (1 - b1 ** t)
                vhat = v / (1 - b2 ** t)
            else:
                mhat, vhat = m, v
            upd = mhat / (torch.sqrt(vhat) + eps) + wd * w
            return w - lr * upd, (m, v)
        return rule


def _norm(x):
    """The whole tensor's 2-norm, a 0-d tensor (the JAX package's
    ``jnp.sqrt(jnp.sum(x * x))``)."""
    return torch.sqrt(torch.sum(x * x))


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (wd folded into the gradient)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return self._zeros_state(weight, 1)

    def _rule(self):
        mom = self.momentum

        def rule(w, g, lr, wd, t, states):
            g = g + wd * w
            (m,) = states
            m = mom * m + g
            return w - lr * (g + mom * m), (m,)
        return rule


@register
class Signum(Optimizer):
    """Sign SGD, with momentum when ``momentum`` != 0; ``wd_lh`` decays
    the weight outside the sign."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return self._zeros_state(weight, 1) if self.momentum != 0 else ()

    def _rule(self):
        mom, wd_lh = self.momentum, self.wd_lh

        def rule(w, g, lr, wd, t, states):
            if mom == 0.0:
                return w * (1 - lr * (wd + wd_lh)) - lr * torch.sign(g), \
                    states
            (m,) = states
            m = mom * m - (1 - mom) * (g + wd * w)
            return w * (1 - lr * wd_lh) + lr * torch.sign(m), (m,)
        return rule


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half a gradient step plus
    Gaussian noise of standard deviation sqrt(lr), drawn from
    ``generator`` (a ``torch.Generator`` on the weights' device; None:
    that device's default generator). The JAX package draws its noise
    from ``fold_in(PRNGKey(0x51D), t)``, which PyTorch cannot reproduce:
    the noise here has the same law, not the same bits."""

    # the noise needs the whole weight's shape, as the JAX rule's key does
    elementwise_update = False

    def __init__(self, learning_rate=0.01,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.generator = generator

    def create_state(self, index, weight):
        return ()

    def note_draws(self) -> None:
        from ..gluon.nn.basic_layers import note_draw
        note_draw(self, self.generator)

    def _rule(self):
        gen = self.generator

        def rule(w, g, lr, wd, t, states):
            g = g + wd * w
            noise = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                                generator=gen) * torch.sqrt(lr)
            return w - 0.5 * lr * g + noise, states
        return rule


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the gradient corrected by
    ``lamda * g * g * (w - previous w)``; the state keeps the momentum
    and the weight before the update."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, memory_format=torch.
                                 contiguous_format),
                weight.detach().clone(memory_format=torch.contiguous_format))

    def _rule(self):
        mom, lam = self.momentum, self.lamda

        def rule(w, g, lr, wd, t, states):
            m, prev = states
            g = g + wd * w
            g = g + lam * g * g * (w - prev)
            m = mom * m - lr * g
            # a copy: the weight is written before the states
            return w + m, (m, w.clone())
        return rule


@register
class AdaBelief(Optimizer):
    """AdaBelief: Adam with the second moment of ``g - m``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def _rule(self):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon

        def rule(w, g, lr, wd, t, states):
            m, s = states
            g = g + wd * w
            m = b1 * m + (1 - b1) * g
            s = b2 * s + (1 - b2) * (g - m) ** 2 + eps
            mhat = m / (1 - b1 ** t)
            shat = s / (1 - b2 ** t)
            return w - lr * mhat / (torch.sqrt(shat) + eps), (m, s)
        return rule


@register
class Adamax(Optimizer):
    """Adamax: Adam with an infinity-norm second moment."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def _rule(self):
        b1, b2 = self.beta1, self.beta2

        def rule(w, g, lr, wd, t, states):
            m, u = states
            g = g + wd * w
            m = b1 * m + (1 - b1) * g
            u = torch.maximum(b2 * u, torch.abs(g))
            return w - lr / (1 - b1 ** t) * m / (u + 1e-8), (m, u)
        return rule


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum and a momentum schedule
    (``schedule_decay``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def _rule(self):
        b1, b2, eps, sd = self.beta1, self.beta2, self.epsilon, \
            self.schedule_decay

        def rule(w, g, lr, wd, t, states):
            m, v = states
            g = g + wd * w
            # t an int32 tensor: the powers in float32, as the JAX rule's
            mu_t = b1 * (1 - 0.5 * 0.96 ** (t * sd))
            mu_t1 = b1 * (1 - 0.5 * 0.96 ** ((t + 1) * sd))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            ghat = g / (1 - mu_t)
            mhat = m / (1 - mu_t1)
            vhat = v / (1 - b2 ** t)
            mbar = (1 - mu_t) * ghat + mu_t1 * mhat
            return w - lr * mbar / (torch.sqrt(vhat) + eps), (m, v)
        return rule


@register
class AdaGrad(Optimizer):
    """AdaGrad: the step scaled by the root of the summed squared
    gradients."""

    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon
        self.lazy_update = True     # as the JAX package sets it

    def create_state(self, index, weight):
        return self._zeros_state(weight, 1)

    def _rule(self):
        eps = self.epsilon

        def rule(w, g, lr, wd, t, states):
            (h,) = states
            g = g + wd * w
            h = h + g * g
            return w - lr * g / (torch.sqrt(h) + eps), (h,)
        return rule


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one history a row of the parameter: the mean of the
    squared gradient over the non-leading axes, a state of shape
    ``(rows, 1, ...)``. Weight decay is refused, as in the JAX
    package."""

    elementwise_update = False  # the row means need the full shape

    def __init__(self, learning_rate=0.01, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        if self.wd != 0.0:
            raise MXNetError("GroupAdaGrad does not support weight decay")
        self.epsilon = epsilon
        self.lazy_update = True     # as the JAX package sets it

    def create_state(self, index, weight):
        return (torch.zeros((weight.shape[0],) + (1,) * (weight.dim() - 1),
                            dtype=weight.dtype, device=weight.device),)

    def _rule(self):
        eps = self.epsilon

        def rule(w, g, lr, wd, t, states):
            (h,) = states
            axes = tuple(range(1, g.dim()))
            h = h + (torch.mean(g * g, dim=axes, keepdim=True)
                     if axes else g * g)
            return w - lr * g / (torch.sqrt(h) + eps), (h,)
        return rule


@register
class AdaDelta(Optimizer):
    """AdaDelta: running averages of the squared gradient and of the
    squared step."""

    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def _rule(self):
        rho, eps = self.rho, self.epsilon

        def rule(w, g, lr, wd, t, states):
            acc_g, acc_d = states
            g = g + wd * w
            acc_g = rho * acc_g + (1 - rho) * g * g
            d = torch.sqrt(acc_d + eps) / torch.sqrt(acc_g + eps) * g
            acc_d = rho * acc_d + (1 - rho) * d * d
            return w - lr * d, (acc_g, acc_d)
        return rule


@register
class RMSProp(Optimizer):
    """RMSProp with momentum; ``centered`` subtracts the squared mean
    gradient (three states: n, the mean gradient, the step), and
    ``clip_weights`` clips the new weight to ``[-c, c]``."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum = rho, momentum
        self.epsilon, self.centered = epsilon, centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return self._zeros_state(weight, 3 if self.centered else 2)

    def _rule(self):
        rho, mom, eps = self.rho, self.momentum, self.epsilon
        centered, cw = self.centered, self.clip_weights

        def rule(w, g, lr, wd, t, states):
            g = g + wd * w
            if centered:
                n, gavg, delta = states
                n = rho * n + (1 - rho) * g * g
                gavg = rho * gavg + (1 - rho) * g
                delta = mom * delta - lr * g / \
                    torch.sqrt(n - gavg * gavg + eps)
                new_states = (n, gavg, delta)
            else:
                n, delta = states
                n = rho * n + (1 - rho) * g * g
                delta = mom * delta - lr * g / torch.sqrt(n + eps)
                new_states = (n, delta)
            w = w + delta
            if cw:
                w = torch.clamp(w, -cw, cw)
            return w, new_states
        return rule


@register
class Ftrl(Optimizer):
    """FTRL-Proximal with L1 strength ``lamda1``: weights whose
    accumulated ``|z|`` stays within it are 0."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def _rule(self):
        l1, beta = self.lamda1, self.beta

        def rule(w, g, lr, wd, t, states):
            z, n = states
            g = g + wd * w
            sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / lr
            z = z + g - sigma * w
            n = n + g * g
            w = torch.where(
                torch.abs(z) > l1,
                -(z - torch.sign(z) * l1) / ((beta + torch.sqrt(n)) / lr),
                torch.zeros_like(w))
            return w, (z, n)
        return rule


@register
class FTML(Optimizer):
    """Follow the moving leader (three states: d, v, z)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return self._zeros_state(weight, 3)

    def _rule(self):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon

        def rule(w, g, lr, wd, t, states):
            d, v, z = states
            g = g + wd * w
            v = b2 * v + (1 - b2) * g * g
            d_t = (1 - b1 ** t) / lr * \
                (torch.sqrt(v / (1 - b2 ** t)) + eps)
            sigma = d_t - b1 * d
            z = b1 * z + (1 - b1) * g - sigma * w
            return -z / d_t, (d_t, v, z)
        return rule


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: SGD momentum with the step of
    each parameter scaled by ``eta * |w| / (|g| + wd |w| + eps)``."""

    elementwise_update = False  # the trust ratio needs whole-tensor norms

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return self._zeros_state(weight, 1)

    def _rule(self):
        mom, eta, eps = self.momentum, self.eta, self.epsilon

        def rule(w, g, lr, wd, t, states):
            (m,) = states
            wnorm, gnorm = _norm(w), _norm(g)
            trust = torch.where((wnorm > 0) & (gnorm > 0),
                                eta * wnorm / (gnorm + wd * wnorm + eps),
                                1.0)
            g = g + wd * w
            m = mom * m + trust * lr * g
            return w - m, (m,)
        return rule


@register
class LAMB(Optimizer):
    """Layer-wise Adam for large batches (You et al. 2019): the Adam
    step plus decoupled wd, scaled by ``|w| / |step|``, with ``|w|``
    clamped to ``[lower_bound, upper_bound]`` where given."""

    elementwise_update = False  # the trust ratio needs whole-tensor norms

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def _rule(self):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        lo, hi, bc = self.lower_bound, self.upper_bound, self.bias_correction

        def rule(w, g, lr, wd, t, states):
            m, v = states
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            if bc:
                mhat = m / (1 - b1 ** t)
                vhat = v / (1 - b2 ** t)
            else:
                mhat, vhat = m, v
            r = mhat / (torch.sqrt(vhat) + eps) + wd * w
            wnorm, rnorm = _norm(w), _norm(r)
            if lo is not None:
                wnorm = torch.clamp(wnorm, min=lo)
            if hi is not None:
                wnorm = torch.clamp(wnorm, max=hi)
            trust = torch.where((wnorm > 0) & (rnorm > 0), wnorm / rnorm,
                                1.0)
            return w - lr * trust * r, (m, v)
        return rule


@register
class LANS(Optimizer):
    """LAMB on the normalized gradient, with a second trust-scaled term
    on the gradient itself (Zheng et al. 2020)."""

    elementwise_update = False  # the trust ratios need whole-tensor norms

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def _rule(self):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon

        def rule(w, g, lr, wd, t, states):
            m, v = states
            g = g / torch.clamp(_norm(g), min=1e-12)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            r1 = mhat / (torch.sqrt(vhat) + eps) + wd * w
            r2 = g / (torch.sqrt(vhat) + eps) + wd * w
            wnorm = _norm(w)

            def ratio(r):
                rn = _norm(r)
                return torch.where((wnorm > 0) & (rn > 0), wnorm / rn, 1.0)
            w = w - lr * (b1 * ratio(r1) * r1 + (1 - b1) * ratio(r2) * r2)
            return w, (m, v)
        return rule


class DeviceHParams:
    """The hyperparameters one step of a captured one-card update reads,
    in one int32 buffer on ``device``: (P,) lr float32, (P,) wd float32,
    (P,) t int32, then the rescale and the clip (float32), each a view.
    :meth:`stage` writes a step's values into it in ONE host-to-device
    copy from pinned memory; the caching host allocator keeps each
    step's pinned block until its copy has run, so the host never
    rewrites memory a queued copy still reads."""

    def __init__(self, n: int, device):
        self.n = int(n)
        self.device = torch.device(device)
        self.buf = torch.zeros(3 * self.n + 2, dtype=torch.int32,
                               device=self.device)
        f = self.buf.view(torch.float32)
        n = self.n
        self.lr, self.wd = f[:n], f[n:2 * n]
        self.t = self.buf[2 * n:3 * n]
        self.rescale, self.clip = f[3 * n], f[3 * n + 1]

    def per_param(self):
        """Lists of 0-d views, one a parameter: ``(lrs, wds, ts)``
        (element i's pointer is the buffer's plus an offset)."""
        return ([self.lr[i] for i in range(self.n)],
                [self.wd[i] for i in range(self.n)],
                [self.t[i] for i in range(self.n)])

    def stage(self, lrs, wds, ts, rescale, clip) -> None:
        """Write one step's values (host numbers) into the buffer."""
        n = self.n
        host = np.empty(3 * n + 2, np.int32)
        hf = host.view(np.float32)
        hf[:n], hf[n:2 * n] = lrs, wds
        host[2 * n:3 * n] = ts
        hf[3 * n], hf[3 * n + 1] = rescale, clip
        src = torch.from_numpy(host)
        if self.device.type == "cuda":
            self.buf.copy_(src.pin_memory(), non_blocking=True)
        else:
            self.buf.copy_(src)


def _host_tree(state):
    """A state's nested tuples with numpy leaves (bfloat16 widened to
    float32, which holds it exactly: numpy has no bfloat16 of its own)."""
    if isinstance(state, torch.Tensor):
        t = state.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tuple(_host_tree(s) for s in state)


def _tensor_tree(state):
    if isinstance(state, (tuple, list)):
        return tuple(_tensor_tree(s) for s in state)
    return torch.from_numpy(np.ascontiguousarray(state))


class Updater:
    """Applies an optimizer to indexed weights and owns their states."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        # indices whose states set_states loaded to the host: they move
        # to their weight's device, in its state's dtypes, at first use
        self._unplaced: set = set()

    def get_states(self, dump_optimizer: bool = False) -> bytes:
        """The states pickled as the JAX package pickles them: a dict of
        index -> nested tuples of numpy arrays, with ``dump_optimizer``
        in ``(states, optimizer name, {num_update,
        index_update_count})``, so the update counts survive a
        restart."""
        import pickle
        host = {k: _host_tree(v) for k, v in self.states.items()}
        if dump_optimizer:
            meta = dict(num_update=self.optimizer.num_update,
                        index_update_count=dict(
                            self.optimizer._index_update_count))
            return pickle.dumps((host, type(self.optimizer).__name__, meta))
        return pickle.dumps(host)

    def set_states(self, states_bytes: bytes) -> None:
        """Load what :meth:`get_states` (of either package) pickled."""
        import pickle
        loaded = pickle.loads(states_bytes)
        if isinstance(loaded, tuple):
            loaded, _opt_name, meta = loaded
            self.optimizer.num_update = meta["num_update"]
            self.optimizer._index_update_count.update(
                meta["index_update_count"])
        self.states = {k: _tensor_tree(v) for k, v in loaded.items()}
        self._unplaced = set(self.states)

    def _state_for(self, i, w):
        if i not in self.states:
            self.states[i] = self.optimizer.create_state_multi_precision(i, w)
        elif i in self._unplaced:
            self._unplaced.discard(i)
            self.states[i] = self.optimizer.fill_state(
                i, w, Optimizer.state_tensors(self.states[i]))
        return self.states[i]

    def __call__(self, index, grad, weight):
        indices = index if isinstance(index, (list, tuple)) else [index]
        grads = grad if isinstance(grad, (list, tuple)) else [grad]
        weights = weight if isinstance(weight, (list, tuple)) else [weight]
        for i, w in zip(indices, weights):
            self._state_for(i, w)
        self.optimizer.update(list(indices), list(weights), list(grads),
                              [self.states[i] for i in indices])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
