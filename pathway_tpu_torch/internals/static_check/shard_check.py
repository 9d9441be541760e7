"""The UDF classifier of the static sharding analysis — port of the
classifier in pathway_tpu/internals/static_check/shard_check.py.

An AST (bytecode fallback) classifier tags every sync ``pw.udf`` as
jit-traceable, vmappable or host-only. The auto-jit tier
(internals/autojit.py) reads the class at compile time: traceable and
vmappable UDF chains fuse into one vectorized dispatch a batch. The rest
of the JAX module (the mesh and placement checks, ``ShardChecker`` and its
diagnostics) belongs to the static analyzer, which is not ported (ROADMAP
queue 1, item 6g). The classifier's rules are the JAX package's, word for
word: which UDFs may fuse is part of what the port is held to.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass


_KIND_ORDER = {"traceable": 0, "vmappable": 1, "host": 2}

# module aliases whose attribute calls are numeric array code (the JAX
# names stay: user code may call them, and the rules are the reference's)
_NUMERIC_MODULES = {"np", "numpy", "jnp", "jax", "lax", "math"}
# math.* works per-scalar: vmap-able after a rewrite, not batchable as is
_SCALAR_MODULES = {"math"}
# attribute calls that force a device→host copy / synchronization
_SYNC_ATTRS = {"item", "tolist", "numpy", "block_until_ready",
               "copy_to_host_async"}
# numpy-namespace calls that materialize a host ndarray from their operand
_SYNC_NP_FNS = {"asarray", "array", "ascontiguousarray", "frombuffer"}
# per-scalar builtins a vmap rewrite can express
_VMAP_BUILTINS = {"abs", "min", "max", "round", "float", "int", "bool",
                  "divmod", "pow"}
# builtins that pin execution to the Python interpreter
_HOST_BUILTINS = {"open", "print", "input", "eval", "exec", "compile",
                  "len", "sum", "sorted", "list", "dict", "set", "tuple",
                  "str", "repr", "format", "zip", "enumerate", "map",
                  "filter", "iter", "next", "isinstance", "getattr",
                  "setattr", "hash", "id", "type", "vars", "globals"}


@dataclass(frozen=True)
class UdfClassification:
    """Outcome of :func:`classify_udf`.

    ``kind``: ``"traceable"`` (jit directly over batched columns),
    ``"vmappable"`` (per-row scalar code a vmap rewrite can batch) or
    ``"host"`` (must run on the Python interpreter). ``sync_points`` lists
    host-device synchronization constructs found regardless of kind.
    """

    kind: str
    reasons: tuple[str, ...] = ()
    sync_points: tuple[str, ...] = ()

    @property
    def jit_eligible(self) -> bool:
        return self.kind in ("traceable", "vmappable")


class _UdfVisitor(ast.NodeVisitor):
    def __init__(self):
        self.kind = "traceable"
        self.reasons: list[str] = []
        self.sync_points: list[str] = []

    def _bump(self, kind: str, reason: str) -> None:
        if _KIND_ORDER[kind] > _KIND_ORDER[self.kind]:
            self.kind = kind
        if reason not in self.reasons:
            self.reasons.append(reason)

    def _sync(self, what: str) -> None:
        if what not in self.sync_points:
            self.sync_points.append(what)

    # control flow ----------------------------------------------------------
    def visit_If(self, node):
        self._bump("host", "data-dependent `if` statement (jit cannot "
                           "trace Python branches)")
        self.generic_visit(node)

    def visit_While(self, node):
        self._bump("host", "data-dependent `while` loop")
        self.generic_visit(node)

    def visit_For(self, node):
        self._bump("host", "Python `for` loop over row values")
        if any(isinstance(n, ast.AugAssign) for n in ast.walk(node)):
            self._sync("Python-loop reduction (accumulates element by "
                       "element on the host)")
        self.generic_visit(node)

    def visit_IfExp(self, node):
        self._bump("vmappable", "scalar conditional expression "
                                "(jnp.where under vmap)")
        self.generic_visit(node)

    # interpreter-only constructs -------------------------------------------
    def visit_Try(self, node):
        self._bump("host", "try/except block")
        self.generic_visit(node)

    def visit_With(self, node):
        self._bump("host", "context manager")
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def visit_Raise(self, node):
        self._bump("host", "raise statement")
        self.generic_visit(node)

    def visit_Await(self, node):
        self._bump("host", "await (event-loop bound)")
        self.generic_visit(node)

    def visit_Yield(self, node):
        self._bump("host", "generator")
        self.generic_visit(node)

    visit_YieldFrom = visit_Yield

    def visit_ListComp(self, node):
        self._bump("host", "Python comprehension")
        self.generic_visit(node)

    visit_SetComp = visit_ListComp
    visit_DictComp = visit_ListComp
    visit_GeneratorExp = visit_ListComp

    def visit_JoinedStr(self, node):
        self._bump("host", "string formatting")
        self.generic_visit(node)

    # calls -----------------------------------------------------------------
    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Name):
            name = func.id
            if name in _VMAP_BUILTINS:
                if name in ("int", "float", "bool") and node.args \
                        and not isinstance(node.args[0], ast.Constant):
                    # the cast's implicit .item() blocks until the device
                    # flushes — the sync form PWT105's original list
                    # missed (PWT402 widened the contract; this keeps
                    # classify_udf's view consistent with it)
                    self._sync(f"{name}() cast on a device value blocks "
                               "on an implicit .item()")
                self._bump("vmappable",
                           f"scalar builtin {name}() (vmap-able)")
            elif name in _HOST_BUILTINS:
                self._bump("host", f"host builtin {name}()")
            elif name not in ("jit", "vmap"):
                self._bump("host", f"call to {name}() (not a traceable "
                                   "numeric primitive)")
        elif isinstance(func, ast.Attribute):
            owner = func.value
            attr = func.attr
            if isinstance(owner, ast.Name) and owner.id in _NUMERIC_MODULES:
                if owner.id in ("np", "numpy") and attr in _SYNC_NP_FNS:
                    self._sync(f"{owner.id}.{attr}() on a device value "
                               "forces a device→host transfer")
                if owner.id in _SCALAR_MODULES:
                    self._bump("vmappable",
                               f"{owner.id}.{attr}() is per-scalar "
                               "(vmap-able after a jnp rewrite)")
                # numeric-namespace call: traceable, keep walking args
            elif attr in _SYNC_ATTRS:
                self._sync(f".{attr}() forces a device→host sync")
                self._bump("vmappable",
                           f".{attr}() yields a Python scalar")
            else:
                self._bump("host",
                           f"method call .{attr}() on a row value "
                           "(untraceable)")
        self.generic_visit(node)


def _function_node(fn):
    """The ast FunctionDef/Lambda for ``fn``, or None."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return None
    try:
        tree = ast.parse(src)
    except SyntaxError:
        # a lambda sharing its line with surrounding code: retry just the
        # fragment from the first `lambda` keyword
        i = src.find("lambda")
        if i < 0:
            return None
        frag = src[i:].rstrip().rstrip("),]}")
        try:
            tree = ast.parse(frag, mode="eval")
        except SyntaxError:
            return None
    name = getattr(fn, "__name__", "<lambda>")
    candidates = [n for n in ast.walk(tree)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n.name == name]
    if candidates:
        return candidates[0]
    lambdas = [n for n in ast.walk(tree) if isinstance(n, ast.Lambda)]
    if lambdas:
        return lambdas[0]
    return None


def _classify_bytecode(fn) -> UdfClassification:
    """Source-less fallback: judge by the globals the code object touches
    and its control-flow opcodes (co_names alone misses pure-local
    loops/branches, which would mis-classify them traceable)."""
    import dis

    code = getattr(fn, "__code__", None)
    if code is None:
        return UdfClassification(
            "host", ("no Python source or bytecode available — "
                     "classified host-only",))
    names = set(code.co_names)
    host = sorted((names - _NUMERIC_MODULES) & (_HOST_BUILTINS | {
        "os", "sys", "time", "random", "requests", "socket", "subprocess",
        "pickle", "json", "re", "hashlib", "urllib", "logging"}))
    if host:
        return UdfClassification(
            "host", tuple(f"bytecode touches host global {n!r}"
                          for n in host))
    branchy = any(
        ins.opname == "FOR_ITER" or "JUMP" in ins.opname
        for ins in dis.get_instructions(code))
    if branchy:
        return UdfClassification(
            "host", ("source unavailable; bytecode contains data-dependent "
                     "control flow — classified host-only",))
    if names <= _NUMERIC_MODULES | {"jit", "vmap"}:
        return UdfClassification(
            "traceable", ("straight-line bytecode touching only numeric "
                          "modules",))
    return UdfClassification(
        "host", ("source unavailable; bytecode references "
                 f"{sorted(names)[:4]!r} — classified host-only",))


def classify_udf(fn) -> UdfClassification:
    """Tag a UDF as jit-traceable / vmappable / host-only.

    AST-based when the source is retrievable, bytecode heuristics
    otherwise. Conservative by design: anything not provably expressible
    as traced numeric code classifies ``host``.
    """
    fn = inspect.unwrap(fn)
    if inspect.iscoroutinefunction(fn):
        return UdfClassification("host", ("async (event-loop bound)",))
    node = _function_node(fn)
    if node is None:
        return _classify_bytecode(fn)
    visitor = _UdfVisitor()
    body = node.body if isinstance(node.body, list) else [node.body]
    for stmt in body:
        visitor.visit(stmt)
    return UdfClassification(visitor.kind, tuple(visitor.reasons),
                             tuple(visitor.sync_points))
