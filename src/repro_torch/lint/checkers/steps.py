"""Host syncs and in-place writes in the code that runs every iteration.

The port runs a chunk's K iterations as a Python loop that only enqueues
device work, and the host waits for the card once a chunk, when the
driver reads the chunk's cost trace (``core/engine.py``,
``core/driver.py``).  One sync inside an iteration stalls the card K
times a chunk, and on the CPU nothing shows it: only the card's
sync-debug count does (``chip_smoke.py``, "host syncs per chunk").
These rules find such code on the CPU.  They take the place of the JAX
package's tracer rules (RPL301-303, over *jit-reachable* code) and its
RPL101 donated-reuse.

**Step-reachable code** is what runs once an iteration inside a chunk:

- the ``full_step``, ``light_step``, ``cost`` and ``refresh_replicated``
  hooks of a class registered with the port's ``@register``
  (``refresh_replicated`` runs inside the chunk's loop);
- every function defined inside a ``make_step_fn``,
  ``make_light_step_fn``, ``make_cost_fn`` or ``make_refresh_fn``
  factory;
- a function (by name) or lambda passed to ``engine.make_scan_step``,
  ``make_chunk_cost_step``,
  ``make_batched_scan_step``, ``make_batched_chunk_cost_step``,
  ``IterativeDriver(...)`` or ``BatchedDriver(...)``, or to
  ``RunOptions(step_fn_light=, step_fn_cost=, update_replicated=)``
  (the port's, not the JAX package's);
- a public function of ``kernels/*/ops.py`` or ``kernels/*/kernel.py``;
- a module-local function called by name, or a method called through
  ``self``, from any of the above, followed transitively;
- inside the ``repro_torch`` package, a function that step-reachable
  code of another of its modules calls by its imported name (the Condat
  pieces of ``imaging/condat.py`` that the deconvolution's steps call,
  ``core.compat.psum``), followed the same way.

Nothing else is: not ``ref.py``, ``init_bundle`` or ``finalize``, and
not the sequential references ``imaging.condat.solve`` and
``imaging.lowrank.svt``, which sync on purpose.

**Taint.**  A step-reachable function's parameters are tensors, except
those with a default, a static name (``self``, ``cfg``, ``axes``,
``mesh``, ``device``, ``opts``, ``n_scales``, ``chunk``, ...) or a
static annotation (``int``, ``float``, ``bool``, ``str``,
``torch.device`` ...).  Taint follows assignment, arithmetic, indexing,
method chains and ``torch.*`` calls; it stops at metadata (``.shape``,
``.dtype``, ``.device``, ``.ndim``, ``.dim()``, ``.numel()``,
``.data_ptr()`` ...), ``len()``, ``isinstance()``, ``is``/``is not``/
``in`` comparisons and container literals (their truthiness is their
length).  A module-local function's call is a tensor only where one of
its ``return`` values is.

RPL301 tensor-branch : ``if``, ``while``, a ternary, ``assert`` or a
                       comprehension filter on a tensor — an implicit
                       ``bool()``, which waits for the card.
RPL302 host-sync     : ``.item()``, ``.tolist()``, ``.cpu()``,
                       ``.numpy()``, ``.to("cpu")``; ``float()``,
                       ``int()``, ``bool()``, ``math.*`` or ``np.*`` of a
                       tensor; ``torch.linalg.eigh``/``eigvalsh``/``svd``/
                       ``svdvals``/``cholesky``/``inv``/``solve``/
                       ``lstsq`` (they check their result on the host; the
                       ``_ex`` forms and the Jacobi kernels do not);
                       ``torch.nonzero``, ``torch.unique``,
                       ``masked_select``, one-argument ``torch.where``,
                       boolean-mask indexing (output sizes the host must
                       read) and ``torch.cuda.synchronize()``.
RPL102 inplace-carry : an in-place write to a step's input — a trailing-
                       underscore method (``add_``, ``clamp_``,
                       ``copy_``), item assignment, an augmented
                       assignment or ``out=`` — landing on a parameter
                       or on a value read from one (``d["X"]``,
                       ``rep["tau"]``, and views of them).  The
                       resilience ring keeps *references* to the
                       chunk-start tensors and a checkpoint spills them
                       from the card in the background, so such a write
                       corrupts the snapshot silently, as reading a
                       donated buffer does in JAX.  Tensors made inside
                       the function may be written in place.
"""
from __future__ import annotations

import ast
import functools
import re
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from repro_torch.lint.checkers._ast_util import (PORT, assigned_pairs, dotted,
                                                 import_aliases,
                                                 kernel_family, methods,
                                                 params_with_defaults,
                                                 port_name, registered,
                                                 resolve)
from repro_torch.lint.core import Finding, ModuleSource, Rule, register_checker

RPL102 = Rule("RPL102", "inplace-carry",
              "in-place write to a step's input (the carry the ring and "
              "the checkpoints hold)")
RPL301 = Rule("RPL301", "tensor-branch",
              "Python control flow on a tensor in step-reachable code")
RPL302 = Rule("RPL302", "host-sync",
              "host sync in step-reachable code")

_HOOKS = frozenset({"full_step", "light_step", "cost", "refresh_replicated"})
_FACTORIES = frozenset({"make_step_fn", "make_light_step_fn", "make_cost_fn",
                        "make_refresh_fn"})
_STEP_TAKERS = frozenset({"make_scan_step", "make_chunk_cost_step",
                          "make_batched_scan_step",
                          "make_batched_chunk_cost_step", "IterativeDriver",
                          "BatchedDriver"})
_OPTION_KWARGS = frozenset({"step_fn_light", "step_fn_cost",
                            "update_replicated"})

# parameters that are static by convention in the port
_STATIC_PARAM_NAMES = frozenset({
    "self", "cls", "cfg", "config", "axes", "mesh", "device", "opts",
    "options", "use_kernel", "n_scales", "scale", "chunk", "cost_every"})
# parameters that hold tensors in a container (the bundle's dicts): their
# truthiness is their length; their entries are tensors
_CONTAINER_PARAM_NAMES = frozenset({"d", "rep"})
_CONTAINER_TYPES = frozenset({"Dict", "dict", "Mapping", "MutableMapping",
                              "List", "list", "Sequence", "Tuple", "tuple"})
_CONTAINER_CALLS = frozenset({"dict", "list", "tuple", "set", "zip",
                              "enumerate", "sorted", "reversed"})
_CONTAINER_NODES = (ast.Dict, ast.List, ast.Tuple, ast.Set, ast.ListComp,
                    ast.DictComp, ast.SetComp, ast.GeneratorExp)
# annotations that make a parameter static (Optional/Union/tuples of them)
_STATIC_TYPES = frozenset({"int", "float", "bool", "str", "bytes",
                           "complex", "device", "dtype", "Size"})
_WRAPPER_TYPES = frozenset({"Optional", "Union", "Tuple", "tuple", "List",
                            "list", "Sequence"})
# metadata attributes: static values even on tensors
_STATIC_ATTRS = frozenset({"shape", "dtype", "ndim", "device", "layout",
                           "is_cuda", "is_meta", "requires_grad", "itemsize",
                           "nbytes"})
# methods whose results are static on tensors (and dicts' keys)
_STATIC_METHODS = frozenset({
    "dim", "ndimension", "numel", "nelement", "size", "stride",
    "storage_offset", "element_size", "is_contiguous", "is_floating_point",
    "is_complex", "data_ptr", "untyped_storage", "get_device", "is_pinned",
    "keys"})
# calls whose results are static whatever their arguments
_STATIC_CALLS = frozenset({
    "len", "isinstance", "issubclass", "type", "range", "hasattr",
    "callable", "id", "repr", "str", "torch.is_tensor",
    "torch.is_floating_point", "torch.is_complex", "torch.device",
    "torch.Size", "torch.finfo", "torch.iinfo", "torch.get_default_dtype",
    "torch.promote_types", "torch.result_type",
    "repro_torch.kernels.common.on_card"})
_STATIC_PREFIXES = ("torch.cuda.", "torch.distributed.")

# host syncs
_HOST_CASTS = frozenset({"bool", "int", "float", "complex"})
_HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "__bool__",
                           "__float__", "__int__", "__index__"})
_SYNC_CALLS = frozenset(
    {f"torch.linalg.{n}" for n in ("eigh", "eigvalsh", "svd", "svdvals",
                                   "cholesky", "inv", "solve", "lstsq")}
    | {"torch.cholesky", "torch.inverse", "torch.svd", "torch.nonzero",
       "torch.unique", "torch.unique_consecutive", "torch.masked_select",
       "torch.cuda.synchronize"})
_SYNC_METHODS = frozenset({"nonzero", "unique", "unique_consecutive",
                           "masked_select"})
_MASKS = frozenset({"torch.isfinite", "torch.isnan", "torch.isinf",
                    "torch.logical_and", "torch.logical_or",
                    "torch.logical_not", "torch.logical_xor"})

# in-place writes: views keep aliasing their base
_VIEW_ATTRS = frozenset({"T", "mT", "H", "mH", "real", "imag", "data"})
_VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "reshape_as", "transpose", "t",
    "permute", "squeeze", "unsqueeze", "expand", "expand_as", "narrow",
    "select", "unfold", "flatten", "unflatten", "movedim", "moveaxis",
    "swapaxes", "swapdims", "diagonal", "as_strided", "detach",
    "contiguous", "to", "chunk", "split", "unbind", "tensor_split", "get",
    "values", "items"})
_TORCH_VIEWS = frozenset(f"torch.{m}" for m in _VIEW_METHODS)
_INPLACE_METHOD = re.compile(r"^[a-z][a-z0-9_]*[a-z0-9]_$")


def _static_annotation(ann) -> bool:
    """Whether an annotation names only static types (``int``,
    ``Optional[float]``, ``torch.device``, ``Tuple[int, ...]``)."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, (ast.Name, ast.Attribute)):
        return (dotted(ann) or "").split(".")[-1] in _STATIC_TYPES
    if isinstance(ann, ast.Subscript):
        if (dotted(ann.value) or "").split(".")[-1] not in _WRAPPER_TYPES:
            return False
        elts = ann.slice.elts if isinstance(ann.slice, ast.Tuple) \
            else [ann.slice]
        return all(_static_annotation(e) or (
            isinstance(e, ast.Constant) and e.value in (None, Ellipsis))
            for e in elts)
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return all(_static_annotation(s) or (
            isinstance(s, ast.Constant) and s.value is None)
            for s in (ann.left, ann.right))
    return False


def _tensor_params(fn) -> Set[str]:
    """The parameters taken to be tensors."""
    a = fn.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    if isinstance(fn, ast.Lambda):
        return {p.arg for p in params if p.arg not in _STATIC_PARAM_NAMES}
    defaulted = params_with_defaults(fn)
    return {p.arg for p in params
            if p.arg not in defaulted and p.arg not in _STATIC_PARAM_NAMES
            and not _static_annotation(p.annotation)}


def _container_params(fn) -> Set[str]:
    """The tensor parameters that are containers of tensors, by name or
    by annotation (``Dict[str, torch.Tensor]``)."""
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if p.arg in _CONTAINER_PARAM_NAMES
            or (dotted(getattr(p.annotation, "value", p.annotation)) or ""
                ).split(".")[-1] in _CONTAINER_TYPES} & _tensor_params(fn)


def _own_statements(fn) -> List[ast.stmt]:
    """``fn``'s statements in source order, nested definitions left out
    (a nested function is analysed on its own when it is reachable)."""
    out: List[ast.stmt] = []

    def visit(stmts):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            out.append(st)
            for name in ("body", "orelse", "finalbody"):
                visit(getattr(st, name, None) or [])
            for h in getattr(st, "handlers", None) or []:
                visit(h.body)

    if isinstance(fn, ast.Lambda):
        return []
    visit(fn.body)
    return out


def _header_exprs(st: ast.stmt) -> List[ast.AST]:
    """The expressions a statement evaluates itself (a compound
    statement's body comes as statements of its own)."""
    if isinstance(st, (ast.If, ast.While)):
        return [st.test]
    if isinstance(st, (ast.For, ast.AsyncFor)):
        return [st.iter]
    if isinstance(st, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in st.items]
    if isinstance(st, ast.Try) or \
            (hasattr(ast, "TryStar") and isinstance(st, ast.TryStar)):
        return []
    return [st]


def _calls(fn) -> List[ast.Call]:
    """The calls a function makes itself (nested definitions left out)."""
    body = [fn.body] if isinstance(fn, ast.Lambda) else \
        [e for st in _own_statements(fn) for e in _header_exprs(st)]
    return [node for root in body for node in ast.walk(root)
            if isinstance(node, ast.Call)]


class _Module:
    """What the rules need of one module: import aliases, the functions
    a call by name can reach, each method's class, and the memoised
    return taint of each local function."""

    def __init__(self, mod: ModuleSource):
        self.mod = mod
        self.aliases = import_aliases(mod.tree)
        self.defs: Dict[str, List[ast.AST]] = {}
        self.class_of: Dict[int, ast.ClassDef] = {}
        self._returns: Dict[int, bool] = {}

        def visit(node, in_class):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    if in_class is not None:
                        self.class_of[id(child)] = in_class
                    else:
                        self.defs.setdefault(child.name, []).append(child)
                visit(child, child if isinstance(child, ast.ClassDef)
                      else None)

        visit(mod.tree, None)

    def targets(self, call: ast.Call, caller) -> List[ast.AST]:
        """The local functions a call reaches: a module-local function by
        name, or a method of the caller's class through ``self``."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return self.defs.get(fn.id, [])
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and fn.value.id == "self":
            cls = self.class_of.get(id(caller))
            if cls is not None:
                m = methods(cls).get(fn.attr)
                return [m] if m is not None else []
        return []

    def returns_tensor(self, fn) -> bool:
        key = id(fn)
        if key not in self._returns:
            self._returns[key] = True          # a cycle: assume a tensor
            taint = _Taint(self, fn)
            if isinstance(fn, ast.Lambda):
                out = taint.tainted(fn.body)
            else:
                out = any(isinstance(st, ast.Return)
                          and taint.tainted(st.value)
                          for st in _own_statements(fn))
            self._returns[key] = out
        return self._returns[key]

    def roots(self, called=()) -> List[ast.AST]:
        """The step-reachable functions of the module's own (module
        docstring), and its top-level functions named in ``called``."""
        tree, aliases = self.mod.tree, self.aliases
        out: List[ast.AST] = [st for st in tree.body
                              if isinstance(st, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef))
                              and st.name in called]
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and registered(node, aliases):
                out.extend(fn for name, fn in methods(node).items()
                           if name in _HOOKS)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in _FACTORIES:
                out.extend(sub for sub in ast.walk(node) if sub is not node
                           and isinstance(sub, (ast.FunctionDef,
                                                ast.AsyncFunctionDef,
                                                ast.Lambda)))
            elif isinstance(node, ast.Call):
                name = resolve(node.func, aliases)
                if port_name(name, _STEP_TAKERS):
                    given = node.args + [kw.value for kw in node.keywords]
                elif port_name(name, ("RunOptions",)):
                    given = [kw.value for kw in node.keywords
                             if kw.arg in _OPTION_KWARGS]
                else:
                    continue
                for arg in given:
                    if isinstance(arg, ast.Lambda):
                        out.append(arg)
                    elif isinstance(arg, ast.Name):
                        out.extend(self.defs.get(arg.id, []))
        if kernel_family(self.mod.path) is not None and \
                self.mod.path.name in ("ops.py", "kernel.py"):
            out.extend(st for st in tree.body
                       if isinstance(st, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                       and not st.name.startswith("_"))
        return out

    def reachable(self, called=()) -> List[ast.AST]:
        seen: Dict[int, ast.AST] = {}
        work = self.roots(called)
        while work:
            fn = work.pop()
            if id(fn) not in seen:
                seen[id(fn)] = fn
                work.extend(t for call in _calls(fn)
                            for t in self.targets(call, fn))
        return list(seen.values())


class _Taint:
    """The tensors of one function: its tensor parameters and what is
    assigned from them (a fixpoint over its statements)."""

    def __init__(self, module: _Module, fn):
        self.module = module
        self.fn = fn
        self.aliases = module.aliases
        self.names = _tensor_params(fn)
        # the tensor names that are containers of tensors
        self.containers = _container_params(fn)
        stmts = _own_statements(fn)
        for _ in range(4):
            before = (len(self.names), len(self.containers))
            for st in stmts:
                if isinstance(st, ast.Assign):
                    targets, value = st.targets, st.value
                elif isinstance(st, (ast.AugAssign, ast.AnnAssign)) and \
                        st.value is not None:
                    targets, value = [st.target], st.value
                elif isinstance(st, (ast.For, ast.AsyncFor)):
                    targets, value = [st.target], st.iter
                    # for key, value in tree.items(): the keys are strings
                    if isinstance(value, ast.Call) and \
                            isinstance(value.func, ast.Attribute) and \
                            value.func.attr == "items" and \
                            isinstance(st.target, ast.Tuple) and \
                            len(st.target.elts) == 2:
                        targets = [st.target.elts[1]]
                else:
                    continue
                if self.tainted(value):
                    self.names |= {n.id for t in targets for n in ast.walk(t)
                                   if isinstance(n, ast.Name)}
                    if len(targets) == 1 and \
                            isinstance(targets[0], ast.Name) and \
                            self.holds(value):
                        self.containers.add(targets[0].id)
            if (len(self.names), len(self.containers)) == before:
                break

    def holds(self, node) -> bool:
        """Whether an expression is a container (of tensors, where
        ``tainted``): a literal, a comprehension, ``dict(...)``, ``zip``
        ... or a container name."""
        if isinstance(node, _CONTAINER_NODES):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.containers
        return isinstance(node, ast.Call) and \
            resolve(node.func, self.aliases) in _CONTAINER_CALLS

    def truthy(self, test) -> bool:
        """Whether testing ``test``'s truth reads a tensor (a container's
        truth is its length)."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self.truthy(test.operand)
        if isinstance(test, ast.BoolOp):
            return any(self.truthy(v) for v in test.values)
        return not self.holds(test) and self.tainted(test)

    def tainted(self, node) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            return node.attr not in _STATIC_ATTRS and self.tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.tainted(node.value)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.tainted(node.left) or \
                any(self.tainted(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.tainted(v) for v in node.values)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) or self.tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand)
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, (ast.Starred, ast.NamedExpr, ast.Await)):
            return self.tainted(node.value)
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.tainted(v) for v in node.values)
        # constants, f-strings, lambdas and comprehensions
        return False

    def _call(self, call: ast.Call) -> bool:
        local = self.module.targets(call, self.fn)
        if local:
            return any(self.module.returns_tensor(t) for t in local)
        name = resolve(call.func, self.aliases)
        fn = call.func
        if name in _STATIC_CALLS or (name or "").startswith(_STATIC_PREFIXES):
            return False
        if isinstance(fn, ast.Attribute) and fn.attr in _STATIC_METHODS:
            return False
        if (name or "").startswith("torch."):
            return True
        if isinstance(fn, ast.Attribute) and self.tainted(fn.value):
            return True                        # x.sum(), x.abs() ...
        # any other callee: a tensor in, a tensor out
        return any(self.tainted(a) for a in call.args) or \
            any(self.tainted(kw.value) for kw in call.keywords)


def _label(fn) -> str:
    return getattr(fn, "name", "<lambda>")


def _bool_mask(node, taint: _Taint) -> bool:
    """Whether an index is a boolean mask of a tensor."""
    if isinstance(node, ast.Compare):
        return taint.tainted(node)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _bool_mask(node.operand, taint)
    if isinstance(node, ast.Call):
        name = resolve(node.func, taint.aliases)
        if name in _MASKS:
            return True
        fn = node.func
        return isinstance(fn, ast.Attribute) and fn.attr == "bool" and \
            taint.tainted(fn.value)
    return False


def _to_cpu(call: ast.Call) -> bool:
    """``.to("cpu")``, ``.to(device="cpu")``, ``.to(torch.device("cpu"))``."""
    given = list(call.args) + [kw.value for kw in call.keywords
                               if kw.arg == "device"]
    for a in given:
        if isinstance(a, ast.Call) and a.args:
            a = a.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, str) and \
                a.value.split(":")[0] == "cpu":
            return True
    return False


class _Checks:
    """The three rules over one step-reachable function."""

    def __init__(self, module: _Module, fn, findings: List[Finding]):
        self.mod = module.mod
        self.taint = _Taint(module, fn)
        self.label = _label(fn)
        self.findings = findings
        # names that alias the step's input: its tensor parameters and
        # what is read or viewed from them
        self.carried = _tensor_params(fn)
        if isinstance(fn, ast.Lambda):
            self.exprs(fn.body)
            return
        for st in _own_statements(fn):
            if isinstance(st, (ast.If, ast.While)) and \
                    self.taint.truthy(st.test):
                kind = "if" if isinstance(st, ast.If) else "while"
                self.branch(st.test, f"'{kind}'")
            elif isinstance(st, ast.Assert) and self.taint.truthy(st.test):
                self.branch(st.test, "'assert'")
            for root in _header_exprs(st):
                self.exprs(root)
            self.writes(st)

    # ---------------------------------------------------- RPL301/302
    def branch(self, node, kind: str) -> None:
        self.findings.append(self.mod.finding(
            RPL301, node,
            f"{kind} on a tensor in step-reachable '{self.label}' — its "
            f"implicit bool() waits for the card every iteration; use "
            f"torch.where, or decide on the host once a chunk"))

    def sync(self, node, what: str, hint: str) -> None:
        self.findings.append(self.mod.finding(
            RPL302, node,
            f"{what} in step-reachable '{self.label}' syncs the host every "
            f"iteration — {hint}"))

    def exprs(self, root) -> None:
        t = self.taint
        for node in ast.walk(root):
            if isinstance(node, ast.IfExp) and t.truthy(node.test):
                self.branch(node.test, "a ternary")
            elif isinstance(node, ast.comprehension):
                # the loop variables are tensors where the iterable holds them
                own = {n.id for n in ast.walk(node.target)
                       if isinstance(n, ast.Name)} - t.names \
                    if t.tainted(node.iter) else set()
                t.names |= own
                for cond in node.ifs:
                    if t.truthy(cond):
                        self.branch(cond, "a comprehension filter")
                t.names -= own
            elif isinstance(node, ast.Subscript) and \
                    t.tainted(node.value) and _bool_mask(node.slice, t):
                self.sync(node, "boolean-mask indexing",
                          "its result's size must reach the host; use "
                          "torch.where")
            elif isinstance(node, ast.Call):
                self.call(node)

    def call(self, node: ast.Call) -> None:
        t = self.taint
        name = resolve(node.func, t.aliases) or ""
        fn = node.func
        args = list(node.args) + [kw.value for kw in node.keywords]
        if name in _SYNC_CALLS:
            hint = ("take the _ex form or the Jacobi kernels "
                    "(repro_torch.kernels.jacobi)" if ".linalg." in name
                    or name in ("torch.cholesky", "torch.inverse",
                                "torch.svd")
                    else "keep shapes static and read sizes once a chunk")
            self.sync(node, f"{name}()", hint)
        elif name == "torch.where" and len(node.args) == 1:
            self.sync(node, "one-argument torch.where()",
                      "its result's size must reach the host")
        elif name in _HOST_CASTS and node.args and (
                t.truthy(node.args[0]) if name == "bool"
                else t.tainted(node.args[0])):
            self.sync(node, f"{name}() of a tensor",
                      "keep the value on the device (a 0-d tensor)")
        elif name.startswith(("numpy.", "math.")) and \
                any(t.tainted(a) for a in args):
            self.sync(node, f"{name}() of a tensor",
                      "use the torch operation, on the device")
        elif isinstance(fn, ast.Attribute) and t.tainted(fn.value):
            if fn.attr in _HOST_METHODS or \
                    (fn.attr == "to" and _to_cpu(node)):
                self.sync(node, f".{fn.attr}() of a tensor",
                          "keep the value on the device; the driver reads "
                          "the chunk's trace once")
            elif fn.attr in _SYNC_METHODS:
                self.sync(node, f".{fn.attr}()",
                          "its result's size must reach the host")

    # ------------------------------------------------------- RPL102
    def carries(self, node) -> bool:
        """Whether an expression aliases the step's input."""
        if isinstance(node, ast.Name):
            return node.id in self.carried
        if isinstance(node, ast.Subscript):
            return self.carries(node.value)
        if isinstance(node, ast.Attribute):
            return node.attr not in _STATIC_ATTRS and self.carries(node.value)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _VIEW_METHODS:
                return self.carries(fn.value)
            return resolve(fn, self.taint.aliases) in _TORCH_VIEWS and \
                bool(node.args) and self.carries(node.args[0])
        if isinstance(node, ast.IfExp):
            return self.carries(node.body) or self.carries(node.orelse)
        if isinstance(node, ast.Starred):
            return self.carries(node.value)
        return False

    def inplace(self, node, how: str, target) -> None:
        self.findings.append(self.mod.finding(
            RPL102, node,
            f"{how} writes in place into '{ast.unparse(target)}', which "
            f"aliases the input of step-reachable '{self.label}' — the "
            f"resilience ring and the checkpoint spill hold references to "
            f"the chunk-start tensors, so this corrupts them silently; "
            f"write into a fresh tensor"))

    def writes(self, st: ast.stmt) -> None:
        for root in _header_exprs(st):
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = resolve(fn, self.taint.aliases) or ""
                if isinstance(fn, ast.Attribute) and \
                        _INPLACE_METHOD.match(fn.attr) and \
                        self.carries(fn.value):
                    self.inplace(node, f".{fn.attr}()", fn.value)
                elif name.startswith("torch.") and \
                        _INPLACE_METHOD.match(name.split(".")[-1]) and \
                        node.args and self.carries(node.args[0]):
                    self.inplace(node, f"{name}()", node.args[0])
                for kw in node.keywords:
                    if kw.arg == "out" and self.carries(kw.value):
                        self.inplace(node, "out=", kw.value)
        if isinstance(st, ast.Assign):
            targets = st.targets
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            targets = [st.target]
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self.rebind(assigned_pairs(st.target, None),
                        self.carries(st.iter))
            return
        else:
            return
        for tgt in targets:
            for node in ast.walk(tgt):
                if isinstance(node, ast.Subscript) and \
                        self.carries(node.value):
                    self.inplace(st, "item assignment", node.value)
        if isinstance(st, ast.AugAssign):
            if isinstance(st.target, ast.Name) and self.carries(st.target):
                self.inplace(st, "an augmented assignment", st.target)
            return
        if st.value is None:
            return
        for tgt in targets:
            self.rebind(assigned_pairs(tgt, st.value),
                        self.carries(st.value))

    def rebind(self, pairs, whole: bool) -> None:
        """Track which names alias the input after an assignment."""
        for name, value in pairs:
            aliased = self.carries(value) if value is not None else whole
            if aliased:
                self.carried.add(name)
            else:
                self.carried.discard(name)


def _package_root(path: Path) -> Optional[Path]:
    """The ``repro_torch`` package directory a module lies in, if any."""
    parts = path.resolve().parts
    if PORT not in parts[:-1]:
        return None
    return Path(*parts[:len(parts) - 1 - parts[-2::-1].index(PORT)])


def _locate(root: Path, name: str) -> Optional[Tuple[str, str]]:
    """(module file, function) for a resolved ``repro_torch.a.b.f``."""
    parts = name.split(".")[1:]
    if len(parts) < 2:
        return None
    module = root.joinpath(*parts[:-1])
    for path in (module.with_suffix(".py"), module / "__init__.py"):
        if path.is_file():
            return str(path), parts[-1]
    return None


@functools.lru_cache(maxsize=8)
def _called_across(root: Path, stamp) -> FrozenSet[Tuple[str, str]]:
    """Every (module file, function) of the package that step-reachable
    code of another of its modules calls by its imported name (``from
    repro_torch.imaging.condat import primal_update``, ``psf_op.H_fp``),
    followed to a fixpoint.  ``stamp`` (the files' sizes and times) keys
    the cache to the sources."""
    modules = {}
    for path, *_ in stamp:
        text = Path(path).read_text()
        try:
            modules[path] = _Module(ModuleSource(Path(path), text,
                                                 ast.parse(text)))
        except SyntaxError:
            continue
    called: Set[Tuple[str, str]] = set()
    while True:
        found = set()
        for path, module in modules.items():
            mine = {f for p, f in called if p == path}
            for fn in module.reachable(mine):
                for call in _calls(fn):
                    name = resolve(call.func, module.aliases) or ""
                    if name.startswith(PORT + "."):
                        target = _locate(root, name)
                        # a plain version is the CPU's route, not a step's
                        if target is not None and target[0] in modules \
                                and Path(target[0]).name != "ref.py":
                            found.add(target)
        if found <= called:
            return frozenset(called)
        called |= found


def _called_here(path: Path) -> Set[str]:
    """The functions of this module that the package's other
    step-reachable code calls."""
    root = _package_root(path)
    if root is None:
        return set()
    files = sorted(p for p in root.rglob("*.py")
                   if "__pycache__" not in p.parts)
    stamp = tuple((str(p), p.stat().st_size, p.stat().st_mtime_ns)
                  for p in files)
    here = str(path.resolve())
    return {f for p, f in _called_across(root, stamp) if p == here}


def step_reachable(mod: ModuleSource) -> List[ast.AST]:
    """The step-reachable functions of a module (module docstring)."""
    return _Module(mod).reachable(_called_here(mod.path))


@register_checker("steps", [RPL102, RPL301, RPL302])
def check(mod: ModuleSource):
    module = _Module(mod)
    findings: List[Finding] = []
    for fn in module.reachable(_called_here(mod.path)):
        _Checks(module, fn, findings)
    return findings
