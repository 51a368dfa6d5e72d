"""Source lint: capture-unsafe Python in forwards and loss functions
(counterpart of ``mxnet_tpu/analysis/lint.py``: the same AST pass, rule
ids and allowlist format, with each rule's torch forms added).

The program lint reads what a step DID run; this pass reads the Python
that is ABOUT to run inside a captured step and flags the constructs
that either break the capture (a host sync cannot be captured in a CUDA
graph: the step falls back to eager, with a warning) or bake a bug into
it:

====== =====================================================
rule   what it catches
====== =====================================================
MXA001 host materialization of a tensor — ``.item()``, ``.cpu()``,
       ``.numpy()``, ``.tolist()``, ``.asnumpy()``, ``.asscalar()``,
       ``.wait_to_read()``, ``numpy.asarray(x)``, ``device_get(x)``
MXA002 Python scalar cast of a non-literal — ``float(x)`` /
       ``int(x)`` / ``bool(x)`` read the tensor on the host
MXA003 Python ``if``/``while``/``assert`` on a tensor-dependent
       condition — a captured graph replays the branch its capture
       took
MXA004 unkeyed randomness — ``numpy.random.*`` / stdlib ``random.*``
       (host draws, a constant in a captured graph) and
       ``torch.rand*`` / ``torch.randint`` / ``torch.randperm`` /
       ``torch.normal`` / ``torch.bernoulli`` / ``torch.multinomial``
       without ``generator=`` (the process's default generator, which
       no layer notes for the step's capture; draw from a generator the
       layer owns)
MXA005 Python ``for`` loop over a tensor dimension — ``for i in
       range(x.shape[0])`` (or iterating a tensor directly) issues one
       op chain an iteration, kernels no fusion can merge (use the
       fused recurrence layers, or vectorize).  Literal
       ``range(<const>)`` loops are not flagged; intentionally-small
       dynamic loops are blessed via the allowlist
MXA006 sharding-opaque placement / raw collectives — ``device_put(x)``
       or ``place_on_mesh(...)`` inside a forward without an explicit
       sharding / axis, and raw collectives (``lax.psum`` ...,
       ``torch.distributed.all_reduce`` / ``all_gather*`` /
       ``reduce_scatter*`` / ``all_to_all*`` / ``broadcast`` / ...)
       anywhere outside ``parallel/collectives.py``, which the schedule
       record and the spec packs read — route them through
       ``mxnet_tpu_torch.parallel.collectives``
MXA007 blocking call inside a ``with <lock>`` body — ``queue.get/put``,
       ``Future.result``, ``wait_to_read``, ``time.sleep``,
       ``Thread.join``, predictor/step dispatch (``.predict``,
       ``synchronize``).  Holding a lock across a blocking call
       convoys every other acquirer and is one ordering edge away from
       deadlock; move the blocking work outside the critical section
MXA008 attribute mutated both from a thread body (``Thread(target=
       self.m)`` and its transitive self-call closure) and from a
       public method, with neither site inside a ``with <lock>`` — the
       classic unguarded cross-thread write
MXA009 bare ``threading.Lock()``/``RLock()``/``Condition()`` in
       framework code outside ``analysis/threads.py`` instead of
       ``analysis.threads.mx_lock`` — an unaudited lock is invisible to
       the lock-order graph and the deadlock forensics
====== =====================================================

Scope: MXA001-006 lint ``forward`` / ``hybrid_forward`` method bodies
(a ``torch.autograd.Function``'s too; its ``ctx`` is not data) and
functions nested in them — code outside a forward may sync freely and
is never flagged.  The THREAD rules MXA007-009 have module scope
instead (whole files, via :func:`lint_threads_source` /
:func:`lint_threads_path`) and run only over framework code: the tier-1
sweep covers ``mxnet_tpu_torch/``, not examples or tests.

Blessing an intentional violation: append ``# mx-lint: allow`` (or
``# mx-lint: allow=MXA001``) to the offending line, or list
``<path-suffix>::<rule>`` entries in an allowlist file (the tier-1
sweep uses ``tests/fixtures/torch_lint_allowlist.txt``).

CLI::

    python -m mxnet_tpu_torch.analysis.lint <module-or-path> [...]
    python -m mxnet_tpu_torch.analysis.lint --threads \
        --allowlist tests/fixtures/torch_lint_allowlist.txt mxnet_tpu_torch
"""
from __future__ import annotations

import ast
import importlib.util
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .report import Finding

__all__ = ["lint_source", "lint_path", "lint_module", "lint_function",
           "lint_threads_source", "lint_threads_path",
           "load_allowlist", "filter_allowed", "main"]

_SYNC_METHODS = {"asnumpy", "item", "asscalar", "wait_to_read",
                 "wait_to_write", "tolist", "cpu", "numpy"}
_NUMPY_SYNC_FUNCS = {"asarray", "array", "copy"}
_NUMPY_ALIASES = {"numpy", "np", "onp"}
_SCALAR_CASTS = {"float", "int", "bool"}
# attributes that yield trace-static values — reading them off a traced
# array is safe and UNtaints the expression
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "stype", "context",
                 "ctx", "device", "name", "dtype_name", "is_cuda",
                 "requires_grad", "layout", "training"}
_SAFE_CALLS = {"len", "isinstance", "type", "getattr", "hasattr",
               "range", "enumerate", "zip"}
# raw lax collectives (MXA006): communication primitives that must
# route through parallel/collectives.py (version-compat shims + the
# spec-pack blessing surface)
_LAX_COLLECTIVES = {"psum", "pmean", "pmax", "pmin", "all_gather",
                    "all_to_all", "ppermute", "pshuffle", "psum_scatter",
                    "pgather", "pbroadcast", "pvary", "pcast"}
#: raw torch.distributed collectives (MXA006)
_TORCH_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_single", "all_gather_object", "reduce_scatter",
    "reduce_scatter_tensor", "reduce_scatter_single", "all_to_all",
    "all_to_all_single", "broadcast", "broadcast_object_list", "reduce",
    "scatter", "gather", "send", "recv", "isend", "irecv", "barrier"}
#: names a module binds torch.distributed to
_DIST_ALIASES = {"dist", "tdist", "distributed"}
#: torch samplers that take ``generator=`` (MXA004)
_TORCH_RANDOM = {"rand", "randn", "rand_like", "randn_like", "randint",
                 "randint_like", "randperm", "normal", "bernoulli",
                 "multinomial", "poisson"}
#: path suffix exempt from the raw-collective rule — the one module
#: whose JOB is wrapping the collectives
_COLLECTIVES_HOME = "parallel/collectives.py"
#: the one module whose bare locks are the audit's own primitives
_THREADS_HOME = "analysis/threads.py"


def _is_dist(base) -> bool:
    """``dist`` / ``tdist`` / ``torch.distributed`` as a call's base."""
    if isinstance(base, ast.Name):
        return base.id in _DIST_ALIASES
    return isinstance(base, ast.Attribute) and base.attr == "distributed"


def _allow_marker(line: str) -> Optional[Set[str]]:
    """Rules blessed by an inline ``# mx-lint: allow[=MXA001[,MXA002]]``
    comment; empty set means allow everything on the line."""
    if "mx-lint:" not in line:
        return None
    frag = line.split("mx-lint:", 1)[1].strip()
    if not frag.startswith("allow"):
        return None
    if "=" in frag:
        return {r.strip() for r in
                frag.split("=", 1)[1].split(",") if r.strip()}
    return set()


class _ForwardLint(ast.NodeVisitor):
    """Lints ONE forward/loss function body with name-level taint
    tracking: data arguments are tainted; assignments propagate; reading
    a static attribute (``x.shape``) or calling a safe builtin
    sanitizes."""

    def __init__(self, filename: str, lines: Sequence[str], qualname: str,
                 tainted: Set[str],
                 rules: Optional[Set[str]] = None):
        self.filename = filename
        self.lines = lines
        self.qualname = qualname
        self.tainted = set(tainted)
        self.rules = rules            # None = every rule
        self.findings: List[Finding] = []

    # ---------------- reporting ----------------
    def _flag(self, node, rule: str, message: str, severity="error"):
        if self.rules is not None and rule not in self.rules:
            return
        lineno = getattr(node, "lineno", 0)
        line = self.lines[lineno - 1] if 0 < lineno <= len(self.lines) \
            else ""
        allowed = _allow_marker(line)
        blessed = allowed is not None and (not allowed or rule in allowed)
        self.findings.append(Finding(
            checker="source", rule=rule, message=message,
            where=f"{self.filename}:{lineno}", severity=severity,
            blessed=blessed))

    # ---------------- taint machinery ----------------
    def _is_tainted(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False                      # x.shape is static
            return self._is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self._is_tainted(node.value)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in _SAFE_CALLS:
                return False                      # len(x), isinstance(..)
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in _STATIC_ATTRS | {"astype", "reshape"}:
                # x.astype(..)/x.reshape(..) stay tainted via receiver
                return self._is_tainted(fn.value)
            # any call fed a tainted argument taints the result
            return any(self._is_tainted(a) for a in node.args) or \
                any(self._is_tainted(k.value) for k in node.keywords) or \
                (isinstance(fn, ast.Attribute)
                 and self._is_tainted(fn.value))
        if isinstance(node, (ast.BinOp,)):
            return self._is_tainted(node.left) or \
                self._is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` check argument STRUCTURE
            # (which call pattern this trace is), not traced values —
            # identity comparisons are trace-static by convention
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in node.ops):
                return False
            return self._is_tainted(node.left) or \
                any(self._is_tainted(c) for c in node.comparators)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self._is_tainted(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self._is_tainted(node.body) or \
                self._is_tainted(node.orelse)
        if isinstance(node, ast.Starred):
            return self._is_tainted(node.value)
        return False

    def _bind(self, target, tainted: bool):
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted)

    # ---------------- statements ----------------
    def visit_Assign(self, node):
        t = self._is_tainted(node.value)
        for tgt in node.targets:
            self._bind(tgt, t)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        if self._is_tainted(node.value):
            self._bind(node.target, True)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._bind(node.target, self._is_tainted(node.value))
        self.generic_visit(node)

    def visit_For(self, node):
        self._bind(node.target, self._is_tainted(node.iter))
        self._check_unrolled_loop(node)
        self.generic_visit(node)

    def _check_unrolled_loop(self, node):
        """MXA005: a ``for`` that unrolls tensor work at trace time.

        Candidates: ``range(<non-literal>)`` (shape-derived or variable
        trip counts — ``range(3)`` is visibly small and static, never
        flagged) and direct iteration over a traced array.  Only loops
        whose BODY touches traced values fire — a loop over config
        lists or child blocks is ordinary Python."""
        it = node.iter
        over = None
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "range" and it.args:
            if not all(isinstance(a, ast.Constant) for a in it.args):
                over = "range(<dynamic>)"
        elif self._is_tainted(it):
            over = "a traced array"
        if over is None:
            return
        body_touches_tracer = any(
            isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
            and n.id in self.tainted
            for stmt in node.body for n in ast.walk(stmt))
        if not body_touches_tracer:
            return
        self._flag(node, "MXA005",
                   f"Python `for` over {over} inside a forward unrolls "
                   "into one long op chain (every iteration issues its "
                   "own kernels, which no fusion can merge) — use the "
                   "fused recurrence layers (gluon.rnn) or vectorize; bless "
                   "intentionally-small static loops via the allowlist",
                   severity="warn")

    def visit_If(self, node):
        if self._is_tainted(node.test):
            self._flag(node, "MXA003",
                       "Python `if` on a tracer-dependent condition — "
                       "it reads the value on the host, and a captured "
                       "graph replays the branch its capture took (use "
                       "torch.where instead)")
        self.generic_visit(node)

    def visit_While(self, node):
        if self._is_tainted(node.test):
            self._flag(node, "MXA003",
                       "Python `while` on a tracer-dependent condition — "
                       "cannot be captured; the step will fall back to "
                       "eager")
        self.generic_visit(node)

    def visit_Assert(self, node):
        if self._is_tainted(node.test):
            self._flag(node, "MXA003",
                       "assert on a tracer-dependent condition "
                       "reads the value on the host every step",
                       severity="warn")
        self.generic_visit(node)

    def visit_IfExp(self, node):
        if self._is_tainted(node.test):
            self._flag(node, "MXA003",
                       "conditional expression on a tracer-dependent "
                       "condition is baked in at capture time")
        self.generic_visit(node)

    # ---------------- calls ----------------
    def visit_Call(self, node):
        fn = node.func
        # x.asnumpy() / x.item() / ...
        if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS:
            self._flag(node, "MXA001",
                       f"`.{fn.attr}()` inside a forward/loss "
                       "materializes the value on host — it cannot be "
                       "captured in the step's graph (the step falls "
                       "back to eager) and costs a device sync every "
                       "step")
        # numpy.asarray(x) / onp.array(x) on tainted values
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id in _NUMPY_ALIASES and \
                fn.attr in _NUMPY_SYNC_FUNCS and \
                any(self._is_tainted(a) for a in node.args):
            self._flag(node, "MXA001",
                       f"`{fn.value.id}.{fn.attr}()` of a traced value "
                       "pulls it to host every step")
        # jax.device_get
        if isinstance(fn, ast.Attribute) and fn.attr == "device_get":
            self._flag(node, "MXA001",
                       "`device_get` inside a forward/loss is a host "
                       "transfer per step")
        # float(x) / int(x) / bool(x)
        if isinstance(fn, ast.Name) and fn.id in _SCALAR_CASTS and \
                node.args and not isinstance(node.args[0], ast.Constant):
            if self._is_tainted(node.args[0]):
                self._flag(node, "MXA002",
                           f"`{fn.id}()` of a traced value concretizes "
                           "it on host — it cannot be captured")
            else:
                self._flag(node, "MXA002",
                           f"`{fn.id}()` of a non-literal inside a "
                           "forward — if the argument derives from a "
                           "traced array this concretizes it",
                           severity="warn")
        # MXA006: sharding-opaque placement — device_put/place_on_mesh
        # without an explicit sharding/destination
        if isinstance(fn, (ast.Attribute, ast.Name)):
            callee = fn.attr if isinstance(fn, ast.Attribute) else fn.id
            kwnames = {k.arg for k in node.keywords}
            if callee == "device_put" and len(node.args) < 2 and \
                    not kwnames & {"device", "dst", "sharding"}:
                self._flag(node, "MXA006",
                           "`device_put` without an explicit sharding "
                           "inside a forward bakes trace-time placement "
                           "into the compiled program — pass a "
                           "NamedSharding (or use parallel.mesh."
                           "place_on_mesh with mesh+axis) so the "
                           "sharding analysis can attribute the layout")
            elif callee == "place_on_mesh" and len(node.args) < 3 and \
                    not kwnames & {"axis"}:
                self._flag(node, "MXA006",
                           "`place_on_mesh` without an explicit "
                           "mesh+axis inside a forward hides the "
                           "intended layout from the compiled program "
                           "and the sharding analysis")
        # MXA006: raw lax collectives outside parallel/collectives.py
        if isinstance(fn, ast.Attribute) and \
                fn.attr in _LAX_COLLECTIVES:
            base = fn.value
            is_lax = (isinstance(base, ast.Name) and base.id == "lax") \
                or (isinstance(base, ast.Attribute)
                    and base.attr == "lax")
            norm = self.filename.replace(os.sep, "/")
            if is_lax and not norm.endswith(_COLLECTIVES_HOME):
                self._flag(node, "MXA006",
                           f"raw `lax.{fn.attr}` inside a forward "
                           "bypasses parallel/collectives.py (the "
                           "version-compat shims and the spec packs "
                           "that bless the framework's collective "
                           "patterns) — route it through "
                           "mxnet_tpu_torch.parallel.collectives",
                           severity="warn")
        if isinstance(fn, ast.Attribute) and \
                fn.attr in _TORCH_COLLECTIVES and _is_dist(fn.value):
            norm = self.filename.replace(os.sep, "/")
            if not norm.endswith(_COLLECTIVES_HOME):
                self._flag(node, "MXA006",
                           f"raw `torch.distributed.{fn.attr}` inside a "
                           "forward bypasses parallel/collectives.py "
                           "(the schedule record's collective census and "
                           "the spec packs that bless the framework's "
                           "collective patterns) — route it through "
                           "mxnet_tpu_torch.parallel.collectives",
                           severity="warn")
        # unkeyed randomness: numpy.random.* / random.*
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Attribute) and \
                    base.attr == "random" and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id in _NUMPY_ALIASES:
                self._flag(node, "MXA004",
                           f"`{base.value.id}.random.{fn.attr}` inside a "
                           "forward draws on the host: a captured step "
                           "replays the capture's draw as a constant — "
                           "draw on the device from a generator the "
                           "layer owns")
            elif isinstance(base, ast.Name) and base.id == "torch" and \
                    fn.attr in _TORCH_RANDOM and \
                    not any(k.arg == "generator" for k in node.keywords):
                self._flag(node, "MXA004",
                           f"`torch.{fn.attr}` without `generator=` "
                           "inside a forward draws from the process's "
                           "default generator, which the step's capture "
                           "does not put back after its warm-up — draw "
                           "from a generator the layer owns "
                           "(basic_layers.note_draw)")
            elif isinstance(base, ast.Name) and base.id == "random" and \
                    fn.attr in ("random", "randint", "uniform", "gauss",
                                "choice", "shuffle", "sample",
                                "randrange"):
                self._flag(node, "MXA004",
                           f"stdlib `random.{fn.attr}` inside a forward "
                           "draws on the host: a captured step replays "
                           "the capture's draw, not a new one per step")
        self.generic_visit(node)


def _iter_forward_functions(tree: ast.Module):
    """(qualname, FunctionDef, tainted-arg-names, rule-subset) for every
    forward/hybrid_forward method in the module — plus ``unroll``
    methods (the rnn API's forward-over-time), scanned for the
    loop-unrolling rule MXA005 only: unroll takes config flags
    (``layout``, ``merge_outputs``) that the all-args-tainted forward
    convention would false-flag under the other rules."""
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and item.name in ("forward", "hybrid_forward",
                                      "unroll"):
                args = [a.arg for a in item.args.args
                        + item.args.posonlyargs + item.args.kwonlyargs]
                if item.args.vararg:
                    args.append(item.args.vararg.arg)
                tainted = {a for a in args
                           if a not in ("self", "F", "ctx", "cls")}
                rules = {"MXA005"} if item.name == "unroll" else None
                yield f"{cls.name}.{item.name}", item, tainted, rules


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    """Lint one file's source text; returns findings (blessed ones
    included, marked)."""
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        return [Finding(checker="source", rule="MXA000", severity="warn",
                        message=f"could not parse: {e}",
                        where=f"{filename}:{e.lineno or 0}")]
    lines = src.splitlines()
    findings: List[Finding] = []
    for qualname, fn, tainted, rules in _iter_forward_functions(tree):
        linter = _ForwardLint(filename, lines, qualname, tainted,
                              rules=rules)
        for stmt in fn.body:
            linter.visit(stmt)
        findings.extend(linter.findings)
    return findings


def lint_function(fn) -> List[Finding]:
    """Lint a live function/lambda (loss functions handed to
    ``Trainer.compile_step``): every parameter is treated as traced."""
    import inspect
    import textwrap
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        filename = inspect.getsourcefile(fn) or "<function>"
        lineno = fn.__code__.co_firstlineno
    except (OSError, TypeError):
        return []
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []
    node = None
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            node = n
            break
    if node is None:
        return []
    args = [a.arg for a in node.args.args + node.args.posonlyargs]
    tainted = {a for a in args if a not in ("self", "F", "ctx", "cls")}
    lines = src.splitlines()
    linter = _ForwardLint(filename, lines, getattr(fn, "__name__", "<fn>"),
                          tainted)
    body = node.body if isinstance(node.body, list) else [node.body]
    for stmt in body:
        linter.visit(stmt)
    for f in linter.findings:     # rebase onto real file line numbers
        try:
            path, ln = f.where.rsplit(":", 1)
            f.where = f"{path}:{int(ln) + lineno - 1}"
        except ValueError:
            pass
    return linter.findings


def lint_path(path: str) -> List[Finding]:
    """Lint a file, or every ``*.py`` under a directory."""
    findings: List[Finding] = []
    if os.path.isdir(path):
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs
                       if d not in ("__pycache__", ".git")]
            for f in sorted(files):
                if f.endswith(".py"):
                    findings.extend(lint_path(os.path.join(root, f)))
        return findings
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), filename=path)


def lint_module(name: str) -> List[Finding]:
    """Lint an importable module (or package) by name, without
    importing it."""
    spec = importlib.util.find_spec(name)
    if spec is None or not spec.origin:
        raise ImportError(f"cannot locate module {name!r}")
    if spec.submodule_search_locations:
        out: List[Finding] = []
        for loc in spec.submodule_search_locations:
            out.extend(lint_path(loc))
        return out
    return lint_path(spec.origin)


# ---------------------------------------------------------------------------
# thread rules (MXA007-009): module-scope, framework code only
# ---------------------------------------------------------------------------

#: receiver/context names that look like a mutual-exclusion primitive
_LOCKISH = re.compile(r"(lock|mutex|(^|_)mu$|(^|_)cv$|cond)", re.I)
#: receiver names that look like a queue
_QUEUEISH = re.compile(r"(queue|(^|_)q$)", re.I)
#: attribute calls that block on device/predictor work (MXA007)
_DISPATCH_CALLS = {"predict", "block_until_ready", "dispatch",
                   "_dispatch", "_dispatch_inner", "synchronize"}
#: blocking attribute calls flagged unconditionally under a lock
_BLOCKING_ATTRS = {"result", "wait_to_read", "wait_to_write"}
#: bare-primitive constructors MXA009 keeps out of framework code
_BARE_PRIMITIVES = {"Lock", "RLock", "Condition"}


def _terminal_name(expr) -> Optional[str]:
    """The last identifier of a Name/Attribute chain (``self._lock`` ->
    ``_lock``); None for anything else."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _lockish_name(expr) -> Optional[str]:
    nm = _terminal_name(expr)
    if nm is not None and _LOCKISH.search(nm):
        return nm
    return None


def _is_queue_get(node: ast.Call) -> bool:
    """``Queue.get`` takes only ``block``/``timeout`` (bools/numbers);
    a ``.get(key)`` with an arbitrary positional is a dict lookup on a
    queue-ISH name, not a blocking dequeue."""
    if any(k.arg not in ("block", "timeout") for k in node.keywords):
        return False
    return all(isinstance(a, ast.Constant)
               and isinstance(a.value, (bool, int, float))
               for a in node.args)


def _is_join_blocking(node: ast.Call) -> bool:
    """``.join()`` is Thread.join when it takes no argument, a numeric
    timeout, or a ``timeout=`` keyword — ``", ".join(parts)`` (one
    non-numeric positional) is str.join and never flagged."""
    if any(k.arg == "timeout" for k in node.keywords):
        return True
    if not node.args and not node.keywords:
        return True
    if len(node.args) == 1 and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, (int, float)):
        return True
    return False


class _ThreadLint(ast.NodeVisitor):
    """MXA007 (blocking under lock) + MXA009 (bare primitive) over one
    module. Lock context is LEXICAL: statements inside a ``with
    <lockish>`` body; nested function definitions do not inherit it
    (a closure defined under a lock runs later, lock-free)."""

    def __init__(self, filename: str, lines: Sequence[str]):
        self.filename = filename
        self.lines = lines
        self._locks: List[str] = []
        self.findings: List[Finding] = []

    def _flag(self, node, rule: str, message: str, severity="error"):
        lineno = getattr(node, "lineno", 0)
        line = self.lines[lineno - 1] if 0 < lineno <= len(self.lines) \
            else ""
        allowed = _allow_marker(line)
        blessed = allowed is not None and (not allowed or rule in allowed)
        self.findings.append(Finding(
            checker="source", rule=rule, message=message,
            where=f"{self.filename}:{lineno}", severity=severity,
            blessed=blessed))

    # -------- lexical lock context --------
    def visit_With(self, node):
        held = [n for n in (_lockish_name(i.context_expr)
                            for i in node.items) if n]
        self._locks.extend(held)
        for item in node.items:
            self.visit(item)
        for stmt in node.body:
            self.visit(stmt)
        if held:
            del self._locks[-len(held):]

    def _visit_fn(self, node):
        saved, self._locks = self._locks, []
        self.generic_visit(node)
        self._locks = saved

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # -------- calls --------
    def visit_Call(self, node):
        fn = node.func
        # MXA009 everywhere (lock context irrelevant)
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id == "threading" and \
                fn.attr in _BARE_PRIMITIVES and not \
                self.filename.replace(os.sep, "/").endswith(_THREADS_HOME):
            self._flag(node, "MXA009",
                       f"bare `threading.{fn.attr}()` in framework code "
                       "is invisible to the lock-order audit and the "
                       "deadlock forensics — use analysis.threads."
                       f"{'mx_condition' if fn.attr == 'Condition' else 'mx_rlock' if fn.attr == 'RLock' else 'mx_lock'}"
                       "(name) (or bless the few legitimate bare locks "
                       "inline)")
        if not self._locks:
            self.generic_visit(node)
            return
        lock = self._locks[-1]
        # MXA007: blocking calls lexically under a lock
        blocked = None
        if isinstance(fn, ast.Attribute):
            recv = _terminal_name(fn.value)
            if fn.attr == "sleep" and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "time":
                blocked = "time.sleep"
            elif fn.attr == "join" and _is_join_blocking(node):
                blocked = f"{recv or '?'}.join"
            elif fn.attr in _BLOCKING_ATTRS:
                blocked = f"{recv or '?'}.{fn.attr}"
            elif fn.attr in ("get", "put") and recv is not None \
                    and _QUEUEISH.search(recv) \
                    and (fn.attr == "put" or _is_queue_get(node)):
                blocked = f"{recv}.{fn.attr}"
            elif fn.attr in _DISPATCH_CALLS:
                blocked = f"{recv or '?'}.{fn.attr}"
        if blocked is not None:
            self._flag(node, "MXA007",
                       f"blocking call `{blocked}(...)` inside `with "
                       f"{lock}:` — every other acquirer of {lock} "
                       "convoys behind this wait (and it is one "
                       "lock-order edge away from deadlock); move the "
                       "blocking work outside the critical section")
        self.generic_visit(node)


class _ClassShareAudit:
    """MXA008 over one ClassDef: attributes mutated WITHOUT a lock both
    from the class's thread-body closure (``Thread(target=self.m)``
    plus transitive self-calls) and from a public method."""

    def __init__(self, linter: "_ThreadLint", cls: ast.ClassDef):
        self.linter = linter
        self.cls = cls
        self.methods: Dict[str, ast.FunctionDef] = {
            it.name: it for it in cls.body
            if isinstance(it, (ast.FunctionDef, ast.AsyncFunctionDef))}
        # method -> attr -> [(lineno, guarded)]
        self.mutations: Dict[str, Dict[str, list]] = {}
        self.calls: Dict[str, Set[str]] = {}
        self.entries: Set[str] = set()

    def run(self):
        for name, fn in self.methods.items():
            self._scan_method(name, fn)
        closure = self._closure()
        if not closure:
            return
        public = [m for m in self.methods
                  if not m.startswith("_") and m not in closure]
        for attr in sorted({a for m in closure
                            for a in self.mutations.get(m, ())}):
            t_sites = [(m, ln) for m in closure
                       for ln, g in self.mutations.get(m, {}).get(attr, ())
                       if not g]
            if not t_sites:
                continue
            p_sites = [(m, ln) for m in public
                       for ln, g in self.mutations.get(m, {}).get(attr, ())
                       if not g]
            if not p_sites:
                continue
            tm, tl = t_sites[0]
            pm, pl = p_sites[0]
            self.linter._flag(
                _Loc(pl), "MXA008",
                f"`self.{attr}` is written without a lock from the "
                f"thread body `{self.cls.name}.{tm}` (line {tl}) AND "
                f"from public `{self.cls.name}.{pm}` (line {pl}) — "
                "guard both writes with one mx_lock, or bless with a "
                "comment naming why the race is benign")

    # ---- per-method scan: mutations + lock context + self-calls ----
    def _scan_method(self, name: str, fn):
        muts: Dict[str, list] = self.mutations.setdefault(name, {})
        calls: Set[str] = self.calls.setdefault(name, set())

        def self_attr(expr) -> Optional[str]:
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name) and \
                    expr.value.id == "self":
                return expr.attr
            return None

        def mutated_attr(tgt) -> Optional[str]:
            a = self_attr(tgt)
            if a is not None:
                return a
            if isinstance(tgt, ast.Subscript):
                return self_attr(tgt.value)
            return None

        def walk(node, depth: int):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                for child in ast.iter_child_nodes(node):
                    walk(child, 0)      # closures run lock-free later
                return
            if isinstance(node, ast.With):
                held = sum(1 for i in node.items
                           if _lockish_name(i.context_expr))
                for i in node.items:
                    walk(i, depth)
                for stmt in node.body:
                    walk(stmt, depth + held)
                return
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    a = mutated_attr(tgt)
                    if a is not None:
                        muts.setdefault(a, []).append(
                            (node.lineno, depth > 0))
            elif isinstance(node, ast.AugAssign):
                a = mutated_attr(node.target)
                if a is not None:
                    muts.setdefault(a, []).append(
                        (node.lineno, depth > 0))
            elif isinstance(node, ast.Call):
                callee = node.func
                m = self_attr(callee)
                if m is not None and m in self.methods:
                    calls.add(m)
                if isinstance(callee, (ast.Name, ast.Attribute)) and \
                        _terminal_name(callee) == "Thread":
                    for k in node.keywords:
                        if k.arg == "target":
                            t = self_attr(k.value)
                            if t is not None:
                                self.entries.add(t)
            for child in ast.iter_child_nodes(node):
                walk(child, depth)

        walk(fn, 0)

    def _closure(self) -> Set[str]:
        out: Set[str] = set()
        todo = [m for m in self.entries if m in self.methods]
        while todo:
            m = todo.pop()
            if m in out:
                continue
            out.add(m)
            todo.extend(c for c in self.calls.get(m, ())
                        if c in self.methods and c not in out)
        return out


class _Loc:
    """Minimal lineno carrier for _flag on synthesized findings."""

    def __init__(self, lineno: int):
        self.lineno = lineno


def lint_threads_source(src: str,
                        filename: str = "<string>") -> List[Finding]:
    """MXA007-009 over one file (module scope — not just forwards);
    blessed findings included, marked."""
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        return [Finding(checker="source", rule="MXA000", severity="warn",
                        message=f"could not parse: {e}",
                        where=f"{filename}:{e.lineno or 0}")]
    lines = src.splitlines()
    linter = _ThreadLint(filename, lines)
    linter.visit(tree)
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef):
            _ClassShareAudit(linter, cls).run()
    return linter.findings


def lint_threads_path(path: str) -> List[Finding]:
    """Thread rules over a file or every ``*.py`` under a directory."""
    findings: List[Finding] = []
    if os.path.isdir(path):
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs
                       if d not in ("__pycache__", ".git")]
            for f in sorted(files):
                if f.endswith(".py"):
                    findings.extend(
                        lint_threads_path(os.path.join(root, f)))
        return findings
    with open(path, "r", encoding="utf-8") as fh:
        return lint_threads_source(fh.read(), filename=path)


# ---------------------------------------------------------------------------
# allowlist
# ---------------------------------------------------------------------------

def load_allowlist(path: str) -> List[Tuple[str, str]]:
    """``<path-suffix>::<rule>`` entries (# comments and blanks
    skipped); rule ``*`` blesses every rule at that path."""
    entries: List[Tuple[str, str]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if "::" not in line:
                entries.append((line, "*"))
                continue
            p, rule = line.rsplit("::", 1)
            entries.append((p.strip(), rule.strip() or "*"))
    return entries


def filter_allowed(findings: Iterable[Finding],
                   allowlist: Sequence[Tuple[str, str]]) -> List[Finding]:
    """Findings NOT blessed by inline markers or allowlist entries."""
    out = []
    for f in findings:
        if f.blessed:
            continue
        fpath = f.where.rsplit(":", 1)[0].replace(os.sep, "/")
        hit = False
        for suffix, rule in allowlist:
            if fpath.endswith(suffix.replace(os.sep, "/")) and \
                    rule in ("*", f.rule):
                hit = True
                break
        if not hit:
            out.append(f)
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis.lint",
        description="capture-safety lint for forward/loss code and the "
                    "thread rules over framework code")
    parser.add_argument("targets", nargs="+",
                        help="files, directories, or importable module "
                             "names")
    parser.add_argument("--allowlist", default=None,
                        help="file of <path-suffix>::<rule> blessed "
                             "entries")
    parser.add_argument("--show-blessed", action="store_true",
                        help="also print violations blessed inline or by "
                             "the allowlist")
    parser.add_argument("--threads", action="store_true",
                        help="run the module-scope thread rules "
                             "MXA007-009 instead of the forward rules")
    args = parser.parse_args(argv)
    lint_fn = lint_threads_path if args.threads else lint_path
    findings: List[Finding] = []
    for target in args.targets:
        if os.path.exists(target):
            findings.extend(lint_fn(target))
        elif args.threads:
            spec = importlib.util.find_spec(target)
            if spec is None or not spec.origin:
                raise ImportError(f"cannot locate module {target!r}")
            for loc in (spec.submodule_search_locations or [spec.origin]):
                findings.extend(lint_threads_path(loc))
        else:
            findings.extend(lint_module(target))
    allow = load_allowlist(args.allowlist) if args.allowlist else []
    active = filter_allowed(findings, allow)
    shown = findings if args.show_blessed else active
    for f in shown:
        print(f)
    n_blessed = len(findings) - len(active)
    print(f"{len(active)} violation(s), {n_blessed} blessed",
          file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
