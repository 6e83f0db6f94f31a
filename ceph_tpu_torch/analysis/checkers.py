"""torchlint's AST checkers, redesigned for eager PyTorch on the card.

One :class:`Analyzer` instance lints one module, in two passes:

1. *Collect* — every function def of the module (methods included;
   a name defined twice is dropped), and a call graph over bare-name and
   ``self.method`` calls.  Its closures give two sets: the functions that
   transitively run a collective (``torch.distributed`` or a ``Mesh``
   collective, J008) and the functions that transitively read the device
   back to the host (J003's interprocedural half), so a call of a local
   helper that syncs counts like the sync itself.

2. *Check* — walk the module with a scope stack.  Per function scope a
   conservative dataflow marks names holding tensors (assigned from a
   ``torch.*`` call or from an operation on a tensor, or parameters
   annotated ``torch.Tensor``), numpy arrays (whose ``.tolist()`` and
   ``.item()`` are host work), rank-local values (J008), unordered sets
   (J009) and consumed buffers (J018).

The dataflow under-approximates where the receiver's type is unknown:
``bool(x)`` on a name of unknown type is not a finding.  The clean-tree
gate needs zero false positives far more than it needs the last false
negative, and the runtime guard
(:mod:`ceph_tpu_torch.analysis.runtime_guard`) counts the reads the
rules cannot see.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from .findings import Finding

#: host-read methods of a tensor (J003); ``nonzero`` is there because
#: its result's size is data
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "nonzero"}
#: host-read functions (J003)
_SYNC_FUNCS = {"torch.nonzero", "torch.cuda.synchronize"}
#: Python scalar conversions that read a tensor's value (J003)
_SCALAR_CASTS = {"bool", "int", "float"}
#: tensor methods whose result is a Python value, not a tensor
_HOST_VALUE_METHODS = {"tolist", "item", "numpy", "size", "dim", "numel", "element_size",
                       "data_ptr", "is_contiguous", "stride", "nelement", "get_device",
                       "untyped_storage"}
#: torch functions whose result is not a tensor
_NON_TENSOR_TORCH = {"device", "is_tensor", "is_floating_point", "Size", "iinfo", "finfo",
                     "Generator", "get_default_dtype", "no_grad", "dtype", "numel",
                     "inference_mode", "set_grad_enabled", "manual_seed", "compile"}
_NON_TENSOR_TORCH_ROOTS = ("torch.cuda", "torch.distributed", "torch.backends", "torch.utils",
                           "torch.profiler", "torch.testing", "torch.autograd", "torch.nn")

#: torch.distributed collectives (J008)
_DIST_COLLECTIVES = {
    f"torch.distributed.{c}"
    for c in ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
              "broadcast", "broadcast_object_list", "barrier", "reduce", "reduce_scatter",
              "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "gather",
              "gather_object", "scatter", "scatter_object_list", "monitored_barrier")
}
#: parallel/mesh.py::Mesh collectives, matched by method name (J008)
_MESH_COLLECTIVES = {"psum", "psum_ordered", "pmax", "pmin", "gather_stack", "all_gather",
                     "barrier"}

#: calls whose result differs across ranks (J008 taint sources)
_RANK_LOCAL_FNS = {"torch.distributed.get_rank", "os.getpid", "os.uname",
                   "socket.gethostname", "platform.node", "uuid.uuid1", "uuid.uuid4"}
#: methods and attributes that read a rank's own index (J008)
_RANK_LOCAL_METHODS = {"get_rank", "axis_index"}
_RANK_LOCAL_ATTRS = {"rank"}

#: host wall-clock reads (J010, and J008 branch-predicate taint)
_WALL_CLOCK_FNS = {"time.time", "time.time_ns", "time.monotonic",
                   "time.monotonic_ns", "time.perf_counter",
                   "time.perf_counter_ns", "datetime.datetime.now",
                   "datetime.datetime.utcnow"}

#: RNG factories that draw an OS-entropy seed when called bare (J011)
_UNSEEDED_RNG_FACTORIES = {"numpy.random.default_rng", "random.Random"}
#: legacy global-state RNG functions, always nondeterministic (J011)
_NP_GLOBAL_RNG = {"rand", "randn", "randint", "random",
                  "random_sample", "choice", "shuffle", "permutation",
                  "uniform", "normal", "standard_normal", "bytes"}
_PY_GLOBAL_RNG = {"random", "randint", "randrange", "uniform",
                  "choice", "choices", "sample", "shuffle", "gauss",
                  "normalvariate", "betavariate", "expovariate",
                  "triangular", "getrandbits"}
#: torch sampling functions that read the global generator unless
#: given ``generator=`` (J011)
_TORCH_RNG = {f"torch.{n}" for n in ("rand", "randn", "randint", "randperm", "normal",
                                     "bernoulli", "multinomial", "poisson", "rand_like",
                                     "randn_like", "randint_like")}
#: in-place tensor sampling methods, likewise (J011)
_TORCH_RNG_METHODS = {"uniform_", "normal_", "random_", "bernoulli_", "exponential_",
                      "geometric_", "log_normal_", "cauchy_"}
_TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                      "torch.cuda.manual_seed_all", "torch.random.manual_seed"}

#: method names whose call in a loop body makes set-iteration order
#: observable (J009 sinks)
_ORDER_SINK_ATTRS = {"append", "extend", "insert", "write",
                     "writelines", "put", "emit", "event", "span",
                     "add_event", "send"}

#: consuming callees known across modules, name -> ((param, position),
#: ...) (J018): the stripe buffer's ownership rule,
#: ``ec/online.py::stripe_buffer_step`` updates its buffer in place
CONSUMERS: dict[str, tuple[tuple[str, int], ...]] = {"stripe_buffer_step": (("buf", 0),)}
#: a docstring's consuming contract: ``consumes=buf`` or ``consumes=a,b``
_CONSUMES_RE = re.compile(r"consumes=([A-Za-z_][A-Za-z0-9_]*(?:\s*,\s*[A-Za-z_][A-Za-z0-9_]*)*)")

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def consumes_contract(fndef) -> tuple[tuple[str, int], ...]:
    """The parameters (name, position) a def's docstring ``consumes=``
    contract names (empty without one)."""
    doc = ast.get_docstring(fndef) or ""
    m = _CONSUMES_RE.search(doc)
    if not m:
        return ()
    order = [a.arg for a in fndef.args.posonlyargs + fndef.args.args]
    if order and order[0] in ("self", "cls"):
        order = order[1:]
    names = [n.strip() for n in m.group(1).split(",")]
    return tuple((n, order.index(n) if n in order else -1) for n in names)


def collect_consumers(tree: ast.Module) -> dict[str, tuple[tuple[str, int], ...]]:
    """Every def of ``tree`` with a ``consumes=`` contract."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, _FUNC_NODES):
            names = consumes_contract(node)
            if names:
                out[node.name] = names
    return out


class ImportMap:
    """Resolve local names to canonical dotted paths."""

    _BUILTIN_CANON = {"np": "numpy"}

    def __init__(self, tree: ast.Module):
        self.alias: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.alias[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                base = ("." * node.level) + node.module if node.level else node.module
                for a in node.names:
                    self.alias[a.asname or a.name] = f"{base}.{a.name}"

    def resolve(self, node: ast.expr) -> str | None:
        """Dotted canonical path for a Name/Attribute chain, else None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.alias.get(node.id, self._BUILTIN_CANON.get(node.id, node.id))
        return ".".join([root] + list(reversed(parts)))


@dataclass
class _Scope:
    #: names holding tensors / numpy arrays
    tensor_names: set[str] = field(default_factory=set)
    numpy_names: set[str] = field(default_factory=set)
    #: names holding rank-local values (rank, pid, wall clock)
    ranklocal_names: set[str] = field(default_factory=set)
    #: names holding unordered set values
    set_names: set[str] = field(default_factory=set)
    #: consumed names -> consuming call line (J018), per function
    consumed: dict[str, int] = field(default_factory=dict)


class Analyzer(ast.NodeVisitor):
    """Lint one parsed module; collects :class:`Finding` objects."""

    def __init__(self, path: str, tree: ast.Module, hot: bool = True,
                 vclock: bool = True, durable: bool = False,
                 consumers: dict[str, tuple[tuple[str, int], ...]] | None = None):
        self.path = path
        self.tree = tree
        self.hot = hot
        self.vclock = vclock
        self.durable = durable
        self.imports = ImportMap(tree)
        self.findings: list[Finding] = []
        self._scopes: list[_Scope] = [_Scope()]
        self._host_loop_depth = 0
        self.consumers = dict(CONSUMERS)
        self.consumers.update(consumers or {})
        self.consumers.update(collect_consumers(tree))
        self._defs: dict[str, ast.AST] = {}
        self._def_dupes: set[str] = set()
        self._collect()
        self._edges: dict[str, set[str]] = {}
        self._direct_collective: set[str] = set()
        self._build_call_graph()
        self._reaches_collective = self._reverse_closure(self._direct_collective, self._edges)
        #: the enclosing def names while visiting
        self._fn_stack: list[str] = []
        #: filled by run()'s first pass: defs that read the device back
        #: themselves (found with the dataflow), then their callers
        self._reaches_sync: set[str] = set()
        self._probing = False

    # ------------------------------------------------------------- collect

    def _collect(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, _FUNC_NODES):
                if node.name in self._defs or node.name in self._def_dupes:
                    self._def_dupes.add(node.name)
                    self._defs.pop(node.name, None)
                else:
                    self._defs[node.name] = node

    def _callee_name(self, call: ast.Call) -> str | None:
        """Bare local function (or ``self.method``) this call targets,
        when that name maps to exactly one def in this module."""
        func = call.func
        name = None
        if isinstance(func, ast.Name):
            name = func.id
        elif (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
              and func.value.id == "self"):
            name = func.attr
        if name in self._defs and name not in self._def_dupes:
            return name
        return None

    def _is_collective(self, call: ast.Call) -> bool:
        fn = self.imports.resolve(call.func)
        if fn in _DIST_COLLECTIVES:
            return True
        return isinstance(call.func, ast.Attribute) and call.func.attr in _MESH_COLLECTIVES

    @staticmethod
    def _shallow_walk(fndef):
        """Walk a function body without descending into nested defs."""
        stack = list(fndef.body)
        while stack:
            n = stack.pop()
            yield n
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(n))

    def _build_call_graph(self) -> None:
        for name, fndef in self._defs.items():
            edges: set[str] = set()
            for n in self._shallow_walk(fndef):
                if not isinstance(n, ast.Call):
                    continue
                callee = self._callee_name(n)
                if callee and callee != name:
                    edges.add(callee)
                if self._is_collective(n):
                    self._direct_collective.add(name)
            self._edges[name] = edges

    @staticmethod
    def _reverse_closure(targets: set[str], edges: dict[str, set[str]]) -> set[str]:
        """Everything that reaches ``targets`` along call edges."""
        reaches = set(targets)
        changed = True
        while changed:
            changed = False
            for name, callees in edges.items():
                if name not in reaches and callees & reaches:
                    reaches.add(name)
                    changed = True
        return reaches

    # ------------------------------------------------------------- helpers

    @property
    def _scope(self) -> _Scope:
        return self._scopes[-1]

    def _report(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(rule, self.path, getattr(node, "lineno", 0),
                    getattr(node, "col_offset", 0) + 1, message)
        )

    def _is_tensor(self, node: ast.expr) -> bool:
        """Does this expression certainly yield a tensor?"""
        if isinstance(node, ast.Name):
            return node.id in self._scope.tensor_names
        if isinstance(node, ast.Call):
            fn = self.imports.resolve(node.func)
            if fn and fn.startswith("torch.") and not fn.startswith(_NON_TENSOR_TORCH_ROOTS):
                return fn.rsplit(".", 1)[-1] not in _NON_TENSOR_TORCH and fn.count(".") == 1
            if isinstance(node.func, ast.Attribute):
                return (node.func.attr not in _HOST_VALUE_METHODS
                        and self._is_tensor(node.func.value))
            return False
        if isinstance(node, ast.Subscript):
            return self._is_tensor(node.value)
        if isinstance(node, ast.Attribute):
            return node.attr in ("T", "mT", "real", "imag", "data") and self._is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self._is_tensor(node.left) or self._is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            return self._is_tensor(node.left) or any(self._is_tensor(c) for c in node.comparators)
        return False

    def _is_numpy(self, node: ast.expr) -> bool:
        """Does this expression certainly yield a numpy array (a host
        value, whose ``.tolist()``/``.item()`` read nothing back)?"""
        if isinstance(node, ast.Name):
            return node.id in self._scope.numpy_names
        if isinstance(node, ast.Call):
            fn = self.imports.resolve(node.func)
            if fn and fn.startswith("numpy."):
                return True
            if isinstance(node.func, ast.Attribute):
                if node.func.attr == "numpy":
                    return True
                return (node.func.attr not in _HOST_VALUE_METHODS
                        and self._is_numpy(node.func.value))
            return False
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            return self._is_numpy(node.value)
        if isinstance(node, ast.BinOp):
            return ((self._is_numpy(node.left) or self._is_numpy(node.right))
                    and not (self._is_tensor(node.left) or self._is_tensor(node.right)))
        return False

    # ----------------------------------------------------------- visitors

    def visit_FunctionDef(self, node) -> None:
        parent = self._scope
        scope = _Scope(
            tensor_names=set(parent.tensor_names), numpy_names=set(parent.numpy_names),
            ranklocal_names=set(parent.ranklocal_names), set_names=set(parent.set_names),
        )
        args = node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            scope.tensor_names.discard(a.arg)
            scope.numpy_names.discard(a.arg)
            ann = self.imports.resolve(a.annotation) if a.annotation is not None else None
            if ann == "torch.Tensor":
                scope.tensor_names.add(a.arg)
            elif ann in ("numpy.ndarray",):
                scope.numpy_names.add(a.arg)
        if self.durable:
            self._check_durable_fn(node)
        self._scopes.append(scope)
        self._fn_stack.append(node.name)
        outer_loops = self._host_loop_depth
        self._host_loop_depth = 0  # a def's body runs when called, not per iteration
        for stmt in node.body:
            self.visit(stmt)
        self._host_loop_depth = outer_loops
        self._fn_stack.pop()
        self._scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_If(self, node: ast.If) -> None:
        self._check_rank_branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_rank_branch(node, "while")
        self._visit_host_loop(node, node.test)

    def visit_For(self, node: ast.For) -> None:
        if self._is_unordered(node.iter) and self._order_sensitive(node):
            self._report(
                "J009", node,
                "iteration over an unordered set builds ordered output: "
                "each rank (and each PYTHONHASHSEED) gets its own order; "
                "iterate sorted(...) instead",
            )
        self.visit(node.iter)
        self._visit_host_loop(node, None, skip=(node.iter,))

    visit_AsyncFor = visit_For

    def _visit_host_loop(self, node, test, skip=()) -> None:
        consumed_before = set(self._scope.consumed)
        self._host_loop_depth += 1
        for child in ast.iter_child_nodes(node):
            if child in skip:
                continue
            self.visit(child)
        self._host_loop_depth -= 1
        self._check_loop_consumption(node, consumed_before)

    def visit_Name(self, node: ast.Name) -> None:
        sc = self._scope
        if isinstance(node.ctx, ast.Load) and node.id in sc.consumed:
            line = sc.consumed.pop(node.id)
            self._report(
                "J018", node,
                f"`{node.id}` read after a call on line {line} consumed it: the "
                "callee updated the buffer in place; rebind the name to the call's "
                "result, or pass a `.clone()` where the old buffer is read again",
            )

    # ------------------------------------------------- J008 rank taint

    def _expr_ranklocal(self, node: ast.expr) -> bool:
        names = self._scope.ranklocal_names
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id in names:
                return True
            if isinstance(n, ast.Attribute) and n.attr in _RANK_LOCAL_ATTRS:
                return True
            if isinstance(n, ast.Call):
                fn = self.imports.resolve(n.func)
                if fn and (fn in _RANK_LOCAL_FNS or fn in _WALL_CLOCK_FNS):
                    return True
                if isinstance(n.func, ast.Attribute) and n.func.attr in _RANK_LOCAL_METHODS:
                    return True
        return False

    def _branch_hits_collective(self, node) -> ast.Call | None:
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            if self._is_collective(n):
                return n
            callee = self._callee_name(n)
            if callee in self._reaches_collective:
                return n
        return None

    def _check_rank_branch(self, node, kw: str) -> None:
        if not self._expr_ranklocal(node.test):
            return
        hit = self._branch_hits_collective(node)
        if hit is not None:
            self._report(
                "J008", node,
                f"`{kw}` on rank-local state guards a collective "
                f"(line {hit.lineno}): ranks taking different branches "
                "deadlock in the collective; make the predicate "
                "rank-identical or hoist the collective out",
            )

    # ------------------------------------------------- J009 set taint

    def _is_unordered(self, node: ast.expr) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Name):
            return node.id in self._scope.set_names
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)
        ):
            return self._is_unordered(node.left) or self._is_unordered(node.right)
        if isinstance(node, ast.Call):
            fn = self.imports.resolve(node.func)
            if fn in ("set", "frozenset"):
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "union", "intersection", "difference", "symmetric_difference",
            ):
                return self._is_unordered(node.func.value)
        return False

    @staticmethod
    def _order_sensitive(loop) -> bool:
        for n in ast.walk(loop):
            if isinstance(n, (ast.Yield, ast.YieldFrom)):
                return True
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _ORDER_SINK_ATTRS):
                return True
        return False

    # --------------------------------------------- J016 durable IO

    def _open_mode(self, call: ast.Call) -> str | None:
        fn = self.imports.resolve(call.func)
        if fn not in ("open", "io.open"):
            return None
        mode = call.args[1] if len(call.args) >= 2 else None
        for kw in call.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            return mode.value
        return "r" if mode is None else None

    def _check_durable_fn(self, fndef) -> None:
        """J016: per-function crash-consistency structure in a
        durable-write module — the write -> flush -> fsync ->
        os.replace -> dir-fsync -> repaired-append chain."""
        replaces: list[ast.Call] = []
        append_opens: list[ast.Call] = []
        has_write = has_fsync = has_dir_fsync = False
        has_repair = has_truncate = False
        for n in self._shallow_walk(fndef):
            if not isinstance(n, ast.Call):
                continue
            fn = self.imports.resolve(n.func)
            if fn in ("os.replace", "os.rename"):
                replaces.append(n)
            elif fn == "os.fsync":
                has_fsync = True
            elif fn and "fsync_dir" in fn.rsplit(".", 1)[-1]:
                has_dir_fsync = True
            elif fn and "repair_torn_tail" in fn:
                has_repair = True
            mode = self._open_mode(n)
            if mode is not None:
                if mode.startswith("a"):
                    append_opens.append(n)
                elif mode.startswith(("w", "x")):
                    has_truncate = True
            if isinstance(n.func, ast.Attribute):
                if n.func.attr in ("write", "writelines"):
                    has_write = True
                elif n.func.attr == "truncate":
                    has_truncate = True
        for r in replaces:
            if has_write and not has_fsync:
                self._report(
                    "J016", r,
                    "file written and os.replace'd without os.fsync: the rename "
                    "can commit before the data, so a crash leaves a truncated or "
                    "empty 'committed' file; flush + fsync before the replace",
                )
            if not has_dir_fsync:
                self._report(
                    "J016", r,
                    "os.replace without a directory fsync: the rename itself is "
                    "not durable until the parent directory entry is fsync'd "
                    "(_fsync_dir); a crash can roll the commit back",
                )
        for o in append_opens:
            if not (has_repair or has_truncate):
                self._report(
                    "J016", o,
                    "append-mode open in a durable-write module without repairing "
                    "a torn tail first: a crash-torn final line glues onto the new "
                    "record and corrupts both; call _repair_torn_tail(path) before "
                    "appending",
                )

    # --------------------------------------------------- J018 consumption

    def _consumed_names(self, node: ast.Call) -> list[str]:
        fn = self.imports.resolve(node.func)
        tail = fn.rsplit(".", 1)[-1] if fn else None
        params = self.consumers.get(tail) if tail else None
        if not params:
            return []
        out = []
        for p, pos in params:
            arg = node.args[pos] if 0 <= pos < len(node.args) else None
            for kw in node.keywords:
                if kw.arg == p:
                    arg = kw.value
            if isinstance(arg, ast.Name):
                out.append(arg.id)
        return out

    def _check_loop_consumption(self, loop, before: set[str]) -> None:
        """A name consumed in a loop body and not rebound by its end is
        consumed again (or read) on the next iteration."""
        sc = self._scope
        for name in sorted(set(sc.consumed) - before):
            line = sc.consumed[name]
            self._report(
                "J018", loop,
                f"`{name}` consumed on line {line} inside a loop and not rebound: "
                "the next iteration reads the buffer the call updated in place; "
                "rebind the name to the call's result",
            )
            del sc.consumed[name]

    # --------------------------------------------------------- assigns

    def _track_taints(self, targets, value) -> None:
        sc = self._scope
        names: list[str] = []
        for t in targets:
            if isinstance(t, ast.Name):
                names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                names.extend(e.id for e in t.elts if isinstance(e, ast.Name))
        if not names:
            return
        tensor = value is not None and self._is_tensor(value)
        numpy_ = value is not None and not tensor and self._is_numpy(value)
        ranklocal = value is not None and self._expr_ranklocal(value)
        unordered = value is not None and self._is_unordered(value)
        for name in names:
            for flag, bucket in ((tensor, sc.tensor_names), (numpy_, sc.numpy_names),
                                 (ranklocal, sc.ranklocal_names),
                                 (unordered, sc.set_names)):
                (bucket.add if flag else bucket.discard)(name)

    def _clear_consumed(self, targets) -> None:
        for tgt in targets:
            for leaf in ast.walk(tgt):
                if isinstance(leaf, ast.Name):
                    self._scope.consumed.pop(leaf.id, None)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        self._track_taints(node.targets, node.value)
        for t in node.targets:
            self.visit(t)
        self._clear_consumed(node.targets)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
        self._track_taints([node.target], node.value)
        self._clear_consumed([node.target])

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.target, ast.Name) and node.target.id in self._scope.consumed:
            line = self._scope.consumed.pop(node.target.id)
            self._report(
                "J018", node,
                f"`{node.target.id}` updated after a call on line {line} consumed "
                "it; rebind the name to the call's result instead",
            )
        self.generic_visit(node)

    # ----------------------------------------------------------- calls

    def _check_rng(self, node: ast.Call, fn: str) -> None:
        if fn in _UNSEEDED_RNG_FACTORIES and not node.args and not node.keywords:
            self._report(
                "J011", node,
                f"{fn}() with no seed draws from OS entropy: runs become "
                "unreproducible and rank-divergent; thread an explicit seed",
            )
        elif fn.startswith("numpy.random.") and fn.rsplit(".", 1)[-1] in _NP_GLOBAL_RNG:
            self._report(
                "J011", node,
                f"global-state {fn}() is unseeded shared state; use "
                "np.random.default_rng(seed)",
            )
        elif fn.startswith("random.") and fn.rsplit(".", 1)[-1] in _PY_GLOBAL_RNG:
            self._report(
                "J011", node,
                f"global-state {fn}() is unseeded shared state; use "
                "random.Random(seed) or np.random.default_rng(seed)",
            )
        elif fn in _TORCH_RNG and not any(kw.arg == "generator" for kw in node.keywords):
            self._report(
                "J011", node,
                f"{fn}() without generator= draws from torch's global "
                "generator; pass a seeded torch.Generator",
            )
        elif fn in _TORCH_GLOBAL_SEED:
            self._report(
                "J011", node,
                f"{fn}() reseeds the global generator every caller shares; "
                "pass a seeded torch.Generator as generator= instead",
            )

    def _in_hot_loop(self) -> bool:
        return self.hot and self._host_loop_depth > 0

    def _check_host_sync(self, node: ast.Call) -> None:
        what = self._direct_sync(node)
        if what is not None and self._probing and self._fn_stack:
            self._direct_syncs.add(self._fn_stack[-1])
        if what is None and not self._probing:
            callee = self._callee_name(node)
            if callee in self._reaches_sync:
                what = f"{callee}() (which reads the device back)"
        if what is not None and self._in_hot_loop() and not self._probing:
            self._report(
                "J003", node,
                f"{what} inside a host loop waits for the card every iteration "
                "in a hot module; read once after the loop or keep the decision "
                "on the device",
            )

    def _direct_sync(self, node: ast.Call) -> str | None:
        """What device->host read this call makes by itself, if any."""
        what = None
        fn = self.imports.resolve(node.func)
        if fn in _SYNC_FUNCS:
            what = f"{fn}()"
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS:
            recv = node.func.value
            attr = node.func.attr
            chained = (isinstance(recv, ast.Call) and isinstance(recv.func, ast.Attribute)
                       and recv.func.attr == "cpu")
            if attr == "cpu" and not node.args:
                what = ".cpu()"
            elif attr == "numpy" and not chained:
                what = ".numpy()"
            elif attr in ("item", "tolist") and not node.args and not chained \
                    and not self._is_numpy(recv):
                what = f".{attr}()"
            elif attr == "nonzero" and self._is_tensor(recv):
                what = ".nonzero()"
        elif (isinstance(node.func, ast.Name) and node.func.id in _SCALAR_CASTS
              and len(node.args) == 1 and self._is_tensor(node.args[0])):
            what = f"{node.func.id}(<tensor>)"
        return what

    def visit_Call(self, node: ast.Call) -> None:
        fn = self.imports.resolve(node.func)
        if fn:
            if self.vclock and fn in _WALL_CLOCK_FNS:
                self._report(
                    "J010", node,
                    f"{fn}() in a VirtualClock-domain module mixes wall time into "
                    "simulated time; use clock.now() (justify real-rate measurement "
                    "sites with a suppression)",
                )
            self._check_rng(node, fn)
        if (isinstance(node.func, ast.Attribute) and node.func.attr in _TORCH_RNG_METHODS
                and not any(kw.arg == "generator" for kw in node.keywords)):
            self._report(
                "J011", node,
                f".{node.func.attr}() without generator= draws from torch's global "
                "generator; pass a seeded torch.Generator",
            )
        self._check_host_sync(node)
        self.generic_visit(node)
        # register consumption only after the call's own argument loads,
        # so the consuming call does not flag itself
        for name in self._consumed_names(node):
            self._scope.consumed[name] = node.lineno

    # comprehensions are host loops too
    def _visit_comp(self, node) -> None:
        self._host_loop_depth += 1
        self.generic_visit(node)
        self._host_loop_depth -= 1

    def visit_ListComp(self, node: ast.ListComp) -> None:
        if any(self._is_unordered(g.iter) for g in node.generators):
            self._report(
                "J009", node,
                "list built by iterating an unordered set captures the "
                "per-rank hash order; iterate sorted(...) instead",
            )
        self._visit_comp(node)

    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    # ------------------------------------------------------------- entry

    def run(self) -> list[Finding]:
        # first pass: which defs read the device back themselves (the
        # dataflow decides), closed over the call graph; then report
        self._probing = True
        self._direct_syncs: set[str] = set()
        self.visit(self.tree)
        self._probing = False
        self.findings = []
        self._scopes = [_Scope()]
        self._reaches_sync = self._reverse_closure(self._direct_syncs, self._edges)
        self.visit(self.tree)
        self.findings.sort(key=lambda f: (f.line, f.col, f.rule))
        return self.findings
