"""The schedule record: what one run of a step's body issues, in order.

The JAX package's checkers read XLA's optimized HLO (``hlo.py``). The
port has no HLO: a step is a sequence of aten ops, hand-written kernels
and collectives, replayed on one card as one captured CUDA graph a
signature and run eagerly in the ``zero`` / ``mesh`` modes. This module
takes ``hlo.py``'s place. :class:`Recorder` runs a body once under a
``TorchDispatchMode`` and keeps, for each thing the body issued:

- an aten op (``kind`` ``op``; ``view`` for an op whose output aliases
  its input, ``alloc`` for ``empty*``): its name, the shapes, dtypes and
  storage ids of the tensors it read and defined (the storage ids are
  its def-use edges), and the storage ids it wrote in place (from the
  op's schema);
- a hand-written kernel (``kernel``): one node a launch on the card
  (``ops.kernels.launch`` reports it to the ``launch`` hook, its operands
  matched by their data pointers, or handed over by the wrapper), one
  node a call of its plain version on the CPU (the plain version's ops
  fold into that node through the ``fold`` hook:
  ``ops.kernels.plain_version``), with the kernel's name either way;
- a collective of ``parallel/collectives.py`` (``collective``, through
  its ``HOOK``): its
  logical kind, mesh axis, result element count, dtype and group size;
  an ``async_op`` collective's ``work.wait()`` is a ``wait`` node, and
  the two form an async pair (XLA's ``*-start`` / ``*-done``). A raw
  ``torch.distributed`` call outside that module shows as its ``c10d``
  op, recorded as a collective of its raw kind.

The recorder installs those hooks of the kernel layer and the
collectives while it runs and removes them after, so neither layer knows
of this one. The record holds no tensor: shapes, dtypes, sizes and ids only. Nothing
is put back here; the callers (``CompiledTrainStep.lower_entry``, the
predictor's and the decode engine's) snapshot and restore what the body
changes.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["Operand", "Node", "ScheduleRecord", "Recorder", "active",
           "record", "MATMUL_OPS", "REDUCE_OPS"]

_DTYPE_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.float64: "float64",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}

#: product ops (their FLOP rules: :func:`_flops_of`)
MATMUL_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "addbmm", "mv",
                        "addmv", "dot", "vdot", "_addmm_activation"})
#: reductions: one FLOP an input element
REDUCE_OPS = frozenset({"sum", "mean", "amax", "amin", "max", "min",
                        "var", "var_mean", "std", "std_mean", "norm",
                        "linalg_vector_norm", "prod", "logsumexp", "all",
                        "any", "argmax", "argmin", "_log_softmax",
                        "_softmax", "count_nonzero", "cumsum"})
#: ops that only allocate (their output holds no data yet)
_ALLOC_OPS = frozenset({"empty", "empty_like", "empty_strided",
                        "new_empty", "new_empty_strided",
                        "empty_permuted"})
#: c10d ops -> the logical kind of the collective they issue
_C10D_KINDS = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
    "broadcast_": "broadcast", "reduce_": "reduce",
    "scatter_": "scatter", "gather_": "gather",
    "send": "send", "recv_": "recv", "barrier": "barrier",
}


def dtype_name(dt) -> str:
    return _DTYPE_NAMES.get(dt, str(dt).replace("torch.", ""))


@dataclass
class Operand:
    """A tensor a node read or defined: its storage id (``sid``, one per
    storage the record saw), shape, dtype name and bytes."""
    sid: int
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int

    @property
    def elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


@dataclass
class Node:
    """One thing the body issued (see the module docstring for kinds)."""
    index: int
    kind: str
    name: str
    inputs: List[Operand] = field(default_factory=list)
    outputs: List[Operand] = field(default_factory=list)
    writes: List[int] = field(default_factory=list)
    flops: int = 0
    dtype: str = ""
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def label(self) -> str:
        return f"#{self.index} {self.name}"

    @property
    def bytes_in(self) -> int:
        seen, n = set(), 0
        for o in self.inputs:
            if o.sid not in seen:
                seen.add(o.sid)
                n += o.nbytes
        return n

    @property
    def bytes_out(self) -> int:
        seen, n = set(), 0
        for o in self.outputs:
            if o.sid not in seen:
                seen.add(o.sid)
                n += o.nbytes
        return n

    @property
    def elements(self) -> int:
        return sum(o.elements for o in self.outputs)

    def to_dict(self) -> Dict[str, Any]:
        return {"index": self.index, "kind": self.kind, "name": self.name,
                "inputs": [(o.sid, list(o.shape), o.dtype)
                           for o in self.inputs],
                "outputs": [(o.sid, list(o.shape), o.dtype)
                            for o in self.outputs],
                "writes": list(self.writes), "flops": self.flops,
                "dtype": self.dtype, "meta": dict(self.meta)}


@dataclass
class ScheduleRecord:
    """The nodes of one run of a body, in issue order, and what the
    caller knows of it (``meta``: mode, the watched tensors' storage ids
    by role, the device)."""
    nodes: List[Node] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)

    def of_kind(self, *kinds) -> List[Node]:
        return [n for n in self.nodes if n.kind in kinds]

    @property
    def kernels(self) -> List[Node]:
        """The nodes that run on the device as kernels of their own: aten
        ops that compute or move data, and the hand-written kernels."""
        return self.of_kind("op", "kernel")

    @property
    def collectives(self) -> List[Node]:
        return self.of_kind("collective")

    @property
    def written_sids(self) -> set:
        out = set()
        for n in self.nodes:
            out.update(n.writes)
        return out

    def consumers(self, sid: int, after: int = -1) -> List[Node]:
        """Nodes after position ``after`` that read storage ``sid``."""
        return [n for n in self.nodes[after + 1:]
                if any(o.sid == sid for o in n.inputs)]

    def last_writer(self, sid: int, before: int) -> Optional[Node]:
        """The last node before position ``before`` that defined or
        wrote ``sid``."""
        for n in reversed(self.nodes[:before]):
            if sid in n.writes or any(o.sid == sid for o in n.outputs):
                return n
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {"meta": {k: v for k, v in self.meta.items()
                         if isinstance(v, (int, float, str, bool, type(None),
                                           list, tuple, dict))},
                "nodes": [n.to_dict() for n in self.nodes]}

    def summary_line(self) -> str:
        by: Dict[str, int] = {}
        for n in self.nodes:
            by[n.kind] = by.get(n.kind, 0) + 1
        return ", ".join(f"{k}={v}" for k, v in sorted(by.items()))


# ---------------------------------------------------------------------------
# the active recorder (one a process: a backward's ops come from
# autograd's worker threads, which inherit the dispatch mode)
# ---------------------------------------------------------------------------

_ACTIVE: List[Optional["Recorder"]] = [None]


def active() -> Optional["Recorder"]:
    """The recorder of the body being recorded, or None."""
    return _ACTIVE[0]


def _flops_of(name: str, ins: List[Operand], outs: List[Operand],
              args, kwargs) -> int:
    """An aten op's FLOPs: products 2·M·N·K, convolutions 2·out·(Cin/g)·k
    (their backward per gradient it computes), reductions one an input
    element, any other computing op one an output element (the JAX
    census's elementwise rule)."""
    if name in MATMUL_OPS:
        if name in ("mm", "addmm", "_addmm_activation"):
            a = [o for o in ins if len(o.shape) == 2]
            if len(a) >= 2:
                m, k = a[-2].shape
                return 2 * m * k * a[-1].shape[1]
        if name in ("bmm", "baddbmm"):
            a = [o for o in ins if len(o.shape) == 3]
            if len(a) >= 2:
                b, m, k = a[-2].shape
                return 2 * b * m * k * a[-1].shape[2]
        if name == "addbmm":
            a = [o for o in ins if len(o.shape) == 3]
            if len(a) >= 2:
                b, m, k = a[-2].shape
                return 2 * b * m * k * a[-1].shape[2]
        if name in ("mv", "addmv"):
            a = [o for o in ins if len(o.shape) == 2]
            if a:
                return 2 * a[0].shape[0] * a[0].shape[1]
        if name in ("dot", "vdot") and ins:
            return 2 * ins[0].elements
        return 0
    if name == "convolution":
        if len(ins) >= 2 and outs:
            # w is (out, in / groups, *kernel)
            w = ins[1].shape
            kelems = 1
            for d in w[1:]:
                kelems *= int(d)
            return 2 * outs[0].elements * kelems
        return 0
    if name == "convolution_backward":
        # (grad_output, input, weight, ...) -> grad_input, grad_weight
        if len(ins) >= 3:
            go, x, w = ins[0], ins[1], ins[2]
            kelems = 1
            for d in w.shape[2:]:
                kelems *= int(d)
            mask = args[-1] if args and isinstance(args[-1], (list, tuple)) \
                else (True, True, True)
            f = 0
            if mask[0]:
                f += 2 * x.elements * int(w.shape[0]) * kelems
            if len(mask) > 1 and mask[1]:
                f += 2 * go.elements * int(w.shape[1]) * kelems
            return f
        return 0
    if name in REDUCE_OPS:
        return max((o.elements for o in ins), default=0)
    return sum(o.elements for o in outs)


class _Fold:
    """A plain version's scope: its ops become one kernel node."""

    def __init__(self):
        self.reads: Dict[int, Operand] = {}
        self.defined: set = set()
        self.writes: set = set()
        self.dtype = ""
        self.n_ops = 0


class Recorder:
    """Records one run of a body (use :func:`record`)."""

    def __init__(self):
        self.record = ScheduleRecord()
        self._mu = threading.Lock()  # mx-lint: allow=MXA009
        self._next_sid = 0
        #: (device, storage pointer) -> sid
        self._sid_of: Dict[tuple, int] = {}
        #: sids allocated by an ``empty*`` op and not yet written
        self._blank: set = set()
        #: data pointer -> Operand (the latest tensor seen there)
        self._by_ptr: Dict[int, Operand] = {}
        self._fold: Optional[_Fold] = None
        self._collective_depth = 0
        self._mode = None

    # ---------------- storage ids ----------------
    def _key(self, t: torch.Tensor):
        try:
            return (str(t.device), t.untyped_storage().data_ptr())
        except Exception:       # a tensor without storage
            return (str(t.device), id(t))

    def _operand(self, t: torch.Tensor, fresh: bool = False) -> Operand:
        key = self._key(t)
        sid = None if fresh else self._sid_of.get(key)
        if sid is None:
            sid = self._next_sid
            self._next_sid += 1
            self._sid_of[key] = sid
        try:
            nbytes = int(t.numel()) * t.element_size()
        except Exception:
            nbytes = 0
        op = Operand(sid, tuple(int(d) for d in t.shape),
                     dtype_name(t.dtype), nbytes)
        try:
            if t.numel():
                self._by_ptr[int(t.data_ptr())] = op
        except Exception:
            pass
        return op

    def sid(self, t: torch.Tensor) -> int:
        """The storage id of ``t`` (assigned now if the record has not
        seen it yet)."""
        return self._operand(t).sid

    # ---------------- nodes ----------------
    def _append(self, node: Node) -> Node:
        with self._mu:
            node.index = len(self.record.nodes)
            self.record.nodes.append(node)
        return node

    def on_aten(self, func, args, kwargs, out):
        """One aten op ran (the dispatch mode's callback)."""
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "c10d":
            if self._collective_depth:
                return
            self._raw_collective(name, args)
            return
        schema = func._schema
        flat_args = []
        written_ptrs = set()
        for i, a in enumerate(schema.arguments):
            v = args[i] if i < len(args) else kwargs.get(a.name)
            ts = _tensors(v)
            flat_args.extend(ts)
            ai = a.alias_info
            if ai is not None and ai.is_write:
                written_ptrs.update(self._key(t) for t in ts)
        outs = _tensors(out)
        in_keys = {self._key(t) for t in flat_args}
        ins = [self._operand(t) for t in flat_args]
        is_view = any(r.alias_info is not None and not r.alias_info.is_write
                      for r in schema.returns) or name in (
                          "detach", "alias", "lift_fresh")
        fresh = [self._key(t) not in in_keys for t in outs]
        out_ops = [self._operand(t, fresh=f) for t, f in zip(outs, fresh)]
        writes = sorted({self._sid_of[k] for k in written_ptrs
                         if k in self._sid_of})
        if name in _ALLOC_OPS:
            kind = "alloc"
            self._blank.update(o.sid for o in out_ops)
        elif is_view and not writes:
            kind = "view"
        else:
            kind = "op"
            self._blank.difference_update(writes)
            self._blank.difference_update(o.sid for o in out_ops)
        fold = self._fold
        if fold is not None:
            fold.n_ops += 1
            for o in ins:
                if o.sid not in fold.defined:
                    fold.reads.setdefault(o.sid, o)
            fold.writes.update(s for s in writes if s not in fold.defined)
            for o, f in zip(out_ops, fresh):
                if f:
                    fold.defined.add(o.sid)
            if not fold.dtype and ins:
                fold.dtype = ins[0].dtype
            return
        dt = (out_ops[0].dtype if out_ops else
              (ins[0].dtype if ins else ""))
        node = Node(0, kind, name, ins, [] if kind == "view" else out_ops,
                    writes, dtype=dt)
        if kind == "view":
            node.meta["aliases"] = [o.sid for o in out_ops]
        grad_fn = torch._C._current_autograd_node()
        if grad_fn is not None:
            # the backward op of this forward node (a widening cast in
            # ToCopyBackward is a gradient returning to its source dtype)
            node.meta["backward_of"] = grad_fn.name()
        if kind == "op":
            node.flops = _flops_of(name, ins, out_ops, args, kwargs)
            if name in ("_to_copy", "copy_") and flat_args:
                src = flat_args[1] if name == "copy_" and \
                    len(flat_args) > 1 else flat_args[0]
                node.meta["src_dtype"] = dtype_name(src.dtype)
                node.meta["src_device"] = src.device.type
                dst = flat_args[0] if name == "copy_" else (
                    outs[0] if outs else None)
                if dst is not None:
                    node.meta["dst_dtype"] = dtype_name(dst.dtype)
                    node.meta["dst_device"] = dst.device.type
        self._append(node)

    def _raw_collective(self, name, args):
        kind = _C10D_KINDS.get(name, name)
        ts = []
        for a in args:
            ts.extend(_tensors(a))
        ops = [self._operand(t) for t in ts]
        el = ops[0].elements if ops else 0
        dt = ops[0].dtype if ops else "?"
        self._append(Node(0, "collective", kind, ops, [], [], dtype=dt,
                          meta={"kind": kind, "axes": (), "group_size": 0,
                                "elements": el, "async": False,
                                "raw": f"c10d::{name}"}))

    # ---------------- hand-written kernels ----------------
    def kernel_launch(self, name: str, dtype, flops, ptr_args,
                      io=None) -> None:
        """One launch on the card (``ops.kernels.launch``). ``io`` =
        ``(reads, writes)`` tensors where the wrapper hands them over;
        otherwise the pointer arguments name the operands: a buffer the
        record saw allocated and not yet written is an output, any other
        an input."""
        meta = {"launch": True, "wrapper_flops": flops}
        if io is not None:
            reads, writes = io
            meta["elements"] = sum(int(t.numel()) for t in reads)
            ins = [self._operand(t) for t in reads]
            outs: List[Operand] = []
            wr = sorted({self._operand(t).sid for t in writes})
            ins += [self._operand(t) for t in writes]
        else:
            ins, outs, wr = [], [], []
            seen = set()
            for a in ptr_args:
                if not isinstance(a, int) or a not in self._by_ptr:
                    continue
                op = self._by_ptr[a]
                if op.sid in seen:
                    continue
                seen.add(op.sid)
                if op.sid in self._blank:
                    outs.append(op)
                else:
                    ins.append(op)
            self._blank.difference_update(o.sid for o in outs)
        node = Node(0, "kernel", name, ins, outs, wr,
                    dtype=dtype_name(dtype) if dtype is not None else "",
                    meta=meta)
        self._append(node)

    @contextlib.contextmanager
    def fold(self, name: str, args, kwargs, meta=None):
        """A plain version's call: its ops fold into one kernel node
        named ``name`` (nested plain calls fold into the outer one)."""
        if self._fold is not None:
            yield None
            return
        f = _Fold()
        self._fold = f
        box: list = []
        try:
            yield box
        finally:
            self._fold = None
        # the plain version's tensor arguments first, in order (the
        # kernels' FLOP rules read their operands by position)
        ins = [self._operand(t) for t in _tensors(list(args))
               + _tensors(list(kwargs.values()))]
        have = {o.sid for o in ins}
        ins += [o for s, o in f.reads.items() if s not in have]
        outs = [self._operand(t) for t in _tensors(box[0] if box else None)]
        self._blank.difference_update(o.sid for o in outs)
        dt = f.dtype or (ins[0].dtype if ins else "")
        self._append(Node(0, "kernel", name, ins, outs, sorted(f.writes),
                          dtype=dt, meta=dict(meta or {}, launch=False,
                                              folded_ops=f.n_ops)))

    # ---------------- collectives ----------------
    def collective(self, kind: str, axis: Optional[str], group_size: int,
                   inputs, outputs, call: Callable, async_op: bool,
                   elements: Optional[int] = None):
        """The collectives' hook: run ``call`` (the ``torch.distributed``
        call) and record it as one collective of ``kind``; an
        ``async_op`` call's work is wrapped so its ``wait()`` records the
        pair's second half."""
        self._collective_depth += 1
        try:
            res = call()
        finally:
            self._collective_depth -= 1
        ins = [self._operand(t) for t in inputs]
        outs = [self._operand(t, fresh=False) for t in outputs]
        out0 = outs[0] if outs else (ins[0] if ins else None)
        el = int(elements) if elements is not None else \
            (out0.elements if out0 is not None else 0)
        dt = out0.dtype if out0 is not None else "?"
        node = self._append(Node(
            0, "collective", kind, ins, outs if not async_op else [],
            [], dtype=dt,
            meta={"kind": kind, "axes": (axis,) if axis else (),
                  "group_size": int(group_size), "elements": el,
                  "async": bool(async_op)}))
        if not async_op:
            return res
        node.meta["pending_outputs"] = outs
        return _RecordedWork(res, self, node)

    def note_wait(self, node: Node):
        """The ``wait()`` of async collective ``node``: its outputs are
        defined here."""
        outs = node.meta.pop("pending_outputs", [])
        w = self._append(Node(0, "wait", node.name, [], outs, [],
                              dtype=node.dtype,
                              meta={"pair": node.index}))
        node.meta["wait"] = w.index

    # ---------------- running ----------------
    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                rec.on_aten(func, args, kwargs, out)
                return out

        if _ACTIVE[0] is not None:
            from ..base import MXNetError
            raise MXNetError("a schedule record is already being taken")
        from ..ops import kernels
        from ..parallel import collectives
        self._mode = _Mode()
        self._mode.__enter__()
        _ACTIVE[0] = self
        kernels.HOOKS.update(launch=self.kernel_launch, fold=self.fold)
        collectives.HOOK[0] = self.collective
        return self

    def __exit__(self, *exc):
        from ..ops import kernels
        from ..parallel import collectives
        kernels.HOOKS.update(launch=None, fold=None)
        collectives.HOOK[0] = None
        _ACTIVE[0] = None
        self._mode.__exit__(*exc)
        self._mode = None
        return False


def _tensors(v) -> List[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        out = []
        for x in v:
            out.extend(_tensors(x))
        return out
    return []


def record(fn: Callable, *args, watch: Optional[Dict[str, list]] = None,
           **kwargs) -> Tuple[ScheduleRecord, Any]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`Recorder`;
    returns ``(record, fn's result)``. ``watch`` maps a role (``params``,
    ``states``) to tensors whose storage ids the record keeps in
    ``meta["watch"][role]`` (in order), assigned before the run."""
    rec = Recorder()
    ids = {role: [rec.sid(t) for t in ts] for role, ts in
           (watch or {}).items()}
    with rec:
        out = fn(*args, **kwargs)
    rec.record.meta["watch"] = ids
    rec.record.meta["watch_bytes"] = {
        role: [int(t.numel()) * t.element_size() for t in ts]
        for role, ts in (watch or {}).items()}
    return rec.record, out


class _RecordedWork:
    """An async collective's work while a record is taken: ``wait()``
    records the pair's wait node, then waits."""

    def __init__(self, work, rec: Recorder, node: Node):
        self._work, self._rec, self._node = work, rec, node

    def wait(self, *a, **kw):
        if self._node is not None:
            self._rec.note_wait(self._node)
            self._node = None
        return self._work.wait(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._work, name)
