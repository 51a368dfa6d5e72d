"""The whole training state, captured and restored (counterpart of
``mxnet_tpu/checkpoint/state.py``, the same array names and meta keys).

:func:`capture_train_state` copies a run's state into a flat
``{name: host numpy array}`` dict plus JSON meta, in a layout-free form:

- ``param/<name>``: every parameter, under ``net.named_parameters()``
  names (the JAX package's ``collect_params()`` names);
- ``opt/<idx>/<leaf>``: the optimizer state of the Trainer's trainable
  parameter ``idx`` (sorted by name), in the parameter's shape. The
  eager Updater's ``(state, master)`` of a multi-precision parameter
  gives the master as its last leaf; a ZeRO step's shards are gathered
  over the mesh, unpadded and split, and its float32 masters go to
  ``master/<idx>``, so a dp N checkpoint resumes at any dp, eagerly, or
  in the JAX package;
- ``rng/torch/default`` (the default generator of the net's device) and
  ``rng/torch/module/<path>`` (each distinct ``torch.Generator`` a
  module holds, e.g. ``Dropout(generator=...)``). The JAX package keeps
  its key chain as ``rng/key``; each package ignores the other's RNG
  keys, the one difference of their key sets;
- ``extra/<k>``: the caller's arrays;
- meta: ``step``, ``param_names``, ``dp_size``, ``opt_mode``,
  ``optimizer``, ``num_update``, ``index_update_count``,
  ``trainable_names``, ``lr_scheduler``.

Every captured array is a copy: the optimizer updates weights and states
in place, so a view would change under a background write while its CRC
still passed.

:func:`apply_train_state` writes parameters IN PLACE (``copy_``), so a
live ``CompiledPredictor`` or ``DecodeEngine`` replays its captured
graphs on the new weights without a new capture. Optimizer states land
in ``Updater.states`` in the live structure and dtypes (a loaded state
is cast to the live state's dtype), masters in ``trainer.
_restored_masters``; a ZeRO plan adopts both when it is built, and a
plan already live is refilled in place.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from .atomic import BF16, host_array, to_tensor

__all__ = ["TrainState", "capture_train_state", "apply_train_state",
           "assemble_segments"]

_LOG = logging.getLogger("mxnet_tpu_torch.checkpoint")

RNG_DEFAULT = "rng/torch/default"
RNG_MODULE = "rng/torch/module/"


class TrainState:
    """A captured snapshot: ``arrays`` (host numpy; bf16 as uint16 bits
    with ``{"dtype": "bfloat16"}`` in ``array_meta``), per-array JSON
    ``array_meta`` and whole-state JSON ``meta``."""

    def __init__(self, arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
                 array_meta: Optional[Dict[str, dict]] = None):
        self.arrays = arrays
        self.meta = meta
        self.array_meta = array_meta or {}

    @property
    def step(self) -> int:
        return int(self.meta.get("step", 0))

    def logical_dtype(self, name: str) -> str:
        return (self.array_meta.get(name) or {}).get(
            "dtype", str(self.arrays[name].dtype))

    def __repr__(self):
        return f"TrainState(step={self.step}, {len(self.arrays)} arrays)"


def _host_copy(t: torch.Tensor, name: str, arrays: dict, array_meta: dict):
    arrays[name], logical = host_array(t)
    if logical == BF16:
        array_meta[name] = {"dtype": BF16}


def assemble_segments(arrays: Dict[str, np.ndarray],
                      array_meta: Dict[str, dict]) -> Dict[str, np.ndarray]:
    """Merge ``name#seg<start>`` row segments (the JAX package's
    multi-host capture) back into whole arrays. Raises if a region is
    missing."""
    segs: Dict[str, List[Tuple[int, np.ndarray]]] = {}
    out: Dict[str, np.ndarray] = {}
    for name, arr in arrays.items():
        am = array_meta.get(name) or {}
        if "seg_of" in am:
            segs.setdefault(am["seg_of"], []).append(
                (int(am["dim0_start"]), arr))
        else:
            out[name] = arr
    for name, parts in segs.items():
        parts.sort(key=lambda t: t[0])
        gshape = array_meta[f"{name}#seg{parts[0][0]}"]["global_shape"]
        full = np.zeros(tuple(gshape), dtype=parts[0][1].dtype)
        pos = 0
        for start, arr in parts:
            if start != pos:
                raise MXNetError(
                    f"checkpoint segment gap in {name!r} at row {pos}: "
                    "not all hosts' shard files are present")
            full[start:start + arr.shape[0]] = arr
            pos = start + arr.shape[0]
        if pos != gshape[0]:
            raise MXNetError(
                f"checkpoint segments for {name!r} cover {pos} of "
                f"{gshape[0]} rows: incomplete multi-host restore")
        out[name] = full
    return out


# ---------------------------------------------------------------- capture
def _param_items(trainer, net):
    if net is not None:
        return list(net.named_parameters())
    if trainer is not None:
        return list(zip(trainer._param_names, trainer._all_params))
    return []


def _zero_step(trainer):
    """The live CompiledTrainStep whose ZeRO plan holds the optimizer
    state, if any."""
    if trainer is None:
        return None
    for step in trainer._live_compiled_steps():
        if step._zero is not None:
            return step
    return None


def _sched_state(sch) -> Optional[dict]:
    if sch is None:
        return None
    state = {}
    for k, v in vars(sch).items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            nested = _sched_state(v) if hasattr(v, "base_lr") else None
            if nested is not None:
                state[k] = {"__sched__": nested}
            continue
        state[k] = v
    return state


def _sched_restore(sch, state: Optional[dict]):
    if sch is None or not state:
        return
    for k, v in state.items():
        if isinstance(v, dict) and "__sched__" in v:
            _sched_restore(getattr(sch, k, None), v["__sched__"])
        elif hasattr(sch, k):
            setattr(sch, k, type(getattr(sch, k))(v)
                    if getattr(sch, k) is not None else v)


def _capture_zero_states(step, arrays, array_meta, keep: bool):
    """Gather every unit's shards over the mesh (a collective: every rank
    calls it), unpad and split them into param-shaped ``opt/<j>/<leaf>``
    and ``master/<j>``; host copies only where ``keep``."""
    from ..parallel.collectives import all_gather_rows
    plan = step._zero
    mesh = step._zero_ok[0]
    n = plan.n_shards
    for unit, st in zip(plan.units, plan.states):
        for li, leaf in enumerate(st):
            full = all_gather_rows(leaf, mesh, n).reshape(-1)
            off = 0
            for j, shp, sz in zip(unit["members"], unit["shapes"],
                                  unit["sizes"]):
                if keep:
                    _host_copy(full[off:off + sz].view(shp),
                               f"opt/{j}/{li}", arrays, array_meta)
                off += sz
    for k, m in plan.masters.items():
        unit = plan.units[k]
        full = all_gather_rows(m, mesh, n).reshape(-1)
        if keep:
            _host_copy(full[:unit["sizes"][0]].view(unit["shapes"][0]),
                       f"master/{unit['members'][0]}", arrays, array_meta)


def _current_dp(trainer) -> int:
    """The data-parallel width the state was captured at (restore
    provenance only: the format itself is layout-free)."""
    step = _zero_step(trainer)
    if step is not None:
        return int(step._zero.n_shards)
    from ..parallel.mesh import current_mesh
    m = current_mesh()
    return int(m.shape.get("dp", 1)) if m is not None else 1


def _device_of(trainer, net) -> torch.device:
    for _, p in _param_items(trainer, net):
        return p.device
    return torch.device("cpu")


def _generators(net) -> List[Tuple[str, torch.Generator]]:
    """(module path, generator) of every distinct ``torch.Generator`` the
    net's modules hold, first holder's path."""
    if net is None:
        return []
    out, seen = [], set()
    for path, m in net.named_modules():
        g = getattr(m, "_generator", None)
        if isinstance(g, torch.Generator) and id(g) not in seen:
            seen.add(id(g))
            out.append((path or "<root>", g))
    return out


def _default_rng_state(dev: torch.device) -> torch.Tensor:
    if dev.type == "cuda":
        return torch.cuda.get_rng_state(dev)
    return torch.get_rng_state()


def _set_default_rng_state(dev: torch.device, state: torch.Tensor):
    if dev.type == "cuda":
        torch.cuda.set_rng_state(state, dev)
    else:
        torch.set_rng_state(state)


def capture_train_state(trainer=None, net=None, step: int = 0,
                        extra: Optional[Dict[str, Any]] = None,
                        keep: bool = True) -> TrainState:
    """Copy parameters, the optimizer state (a ZeRO step's shards
    gathered), counts, scheduler and RNG into host memory. The copies
    happen HERE, synchronously, so the returned state can be written
    while training goes on. Under a ZeRO step every rank must call it;
    ``keep=False`` joins the gathers without copying anything (a rank
    that does not write)."""
    arrays: Dict[str, np.ndarray] = {}
    array_meta: Dict[str, dict] = {}
    meta: Dict[str, Any] = {"step": int(step)}

    names = []
    for name, p in _param_items(trainer, net):
        if keep:
            _host_copy(p, f"param/{name}", arrays, array_meta)
        names.append(name)
    meta["param_names"] = names
    meta["dp_size"] = _current_dp(trainer)

    if trainer is not None:
        opt = trainer._optimizer
        zstep = _zero_step(trainer)
        meta["opt_mode"] = "zero" if zstep is not None else "updater"
        meta["optimizer"] = type(opt).__name__
        meta["num_update"] = int(opt.num_update)
        meta["index_update_count"] = {
            str(k): int(v) for k, v in opt._index_update_count.items()}
        meta["trainable_names"] = trainer._trainable_names
        meta["lr_scheduler"] = _sched_state(
            getattr(opt, "lr_scheduler", None))
        if zstep is not None:
            _capture_zero_states(zstep, arrays, array_meta, keep)
        elif keep:
            for idx, st in trainer._updater.states.items():
                for li, leaf in enumerate(opt.state_tensors(st)):
                    _host_copy(leaf, f"opt/{idx}/{li}", arrays, array_meta)

    if keep:
        dev = _device_of(trainer, net)
        arrays[RNG_DEFAULT] = _default_rng_state(dev).numpy().copy()
        array_meta[RNG_DEFAULT] = {"device_type": dev.type}
        for path, g in _generators(net):
            key = RNG_MODULE + path
            arrays[key] = g.get_state().numpy().copy()
            array_meta[key] = {"device_type": g.device.type}
        for k, v in (extra or {}).items():
            if isinstance(v, torch.Tensor):
                _host_copy(v, f"extra/{k}", arrays, array_meta)
            else:
                arrays[f"extra/{k}"] = np.array(v)
    return TrainState(arrays, meta, array_meta)


# ---------------------------------------------------------------- apply
def _apply_params(state: TrainState, arrays, trainer, net, strict):
    todo = []
    for name, p in _param_items(trainer, net):
        key = f"param/{name}"
        if key not in arrays:
            if strict:
                raise MXNetError(
                    f"checkpoint has no data for parameter {name!r} "
                    "(pass strict=False to keep its current value)")
            continue
        if tuple(arrays[key].shape) != tuple(p.shape):
            raise MXNetError(
                f"checkpoint shape {tuple(arrays[key].shape)} does not "
                f"match parameter {name!r} shape {tuple(p.shape)}")
        todo.append((p, key))
    with torch.no_grad():
        for p, key in todo:
            # in place: captured graphs keep reading the same storage
            p.copy_(to_tensor(arrays[key], state.logical_dtype(key)))
    return len(todo)


def _apply_opt_states(state: TrainState, arrays, trainer):
    """Each trainable parameter's state into ``Updater.states``, in the
    live state's structure, device and dtypes (``Optimizer.fill_state``;
    a ZeRO checkpoint's ``master/<idx>`` completes a multi-precision
    pair); the masters into ``trainer._restored_masters``."""
    meta = state.meta
    tensor = lambda k: to_tensor(arrays[k], state.logical_dtype(k))  # noqa
    by_idx: Dict[int, Dict[int, str]] = {}
    masters: Dict[int, torch.Tensor] = {}
    for key in arrays:
        if key.startswith("opt/"):
            _, idx, li = key.split("/")
            by_idx.setdefault(int(idx), {})[int(li)] = key
        elif key.startswith("master/"):
            masters[int(key.split("/")[1])] = tensor(key).float()
    opt, upd, params = trainer._optimizer, trainer._updater, trainer._params
    for idx, slots in sorted(by_idx.items()):
        if idx >= len(params):
            raise MXNetError(
                f"checkpoint optimizer state index {idx} out of range "
                f"({len(params)} trainable params)")
        p = params[idx]
        leaves = [tensor(slots[li]) for li in sorted(slots)]
        live = upd.states.get(idx)
        template = live if live is not None and idx not in upd._unplaced \
            else opt.create_state_multi_precision(idx, p.detach())
        if opt.is_master_state(p, template) and idx in masters and \
                len(opt.state_tensors(template)) == len(leaves) + 1:
            leaves.append(masters[idx])
        upd.states[idx] = opt.fill_state(idx, p, leaves, template)
        upd._unplaced.discard(idx)
    # taken by the next ZeRO plan (and a live one, below): a restored
    # master keeps the low bits its bf16 weight lost
    trainer._restored_masters = masters

    if "num_update" in meta:
        opt.num_update = int(meta["num_update"])
    if "index_update_count" in meta:
        opt._index_update_count = {
            int(k): int(v) for k, v in meta["index_update_count"].items()}
    _sched_restore(getattr(opt, "lr_scheduler", None),
                   meta.get("lr_scheduler"))


def _reload_live_plan(trainer):
    """A ZeRO plan already built (a mid-run restore): refill its shards
    in place from the restored states and masters."""
    for step in trainer._live_compiled_steps():
        if step._zero is not None:
            step._zero.load_states(trainer._optimizer,
                                   trainer._updater.states,
                                   trainer._restored_masters)
            _LOG.info("restored state into a live zero-shard plan "
                      "(%d units)", len(step._zero.units))


def _apply_rng(state: TrainState, arrays, trainer, net):
    dev = _device_of(trainer, net)
    if RNG_DEFAULT in arrays:
        kind = (state.array_meta.get(RNG_DEFAULT) or {}).get("device_type")
        if kind == dev.type:
            _set_default_rng_state(dev, torch.from_numpy(
                np.ascontiguousarray(arrays[RNG_DEFAULT])))
        else:
            _LOG.warning("checkpoint RNG state is of a %s generator, the "
                         "net runs on %s: not restored", kind, dev.type)
    for path, g in _generators(net):
        key = RNG_MODULE + path
        if key in arrays:
            g.set_state(torch.from_numpy(np.ascontiguousarray(arrays[key])))


def apply_train_state(state: TrainState, trainer=None, net=None,
                      strict: bool = True) -> Dict[str, Any]:
    """Restore a captured or loaded TrainState into (net, trainer);
    returns its meta (with ``"step"``). Works before the first step (a
    ZeRO plan adopts the states when it is built) and mid-run (a live
    plan is refilled in place)."""
    arrays = assemble_segments(state.arrays, state.array_meta)
    _apply_params(state, arrays, trainer, net, strict)
    if trainer is not None:
        _apply_opt_states(state, arrays, trainer)
        _reload_live_plan(trainer)
    _apply_rng(state, arrays, trainer, net)
    return state.meta
