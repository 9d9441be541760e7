"""Auto-jit execution tier: traceable UDF chains → one vectorized dispatch
— port of pathway_tpu/internals/autojit.py.

The shard checker's UDF classifier (internals/static_check/shard_check.py)
tags every sync ``pw.udf`` as jit-traceable / vmappable / host-only; this
module cashes that in. When the expression compiler assembles a map
program, every output expression whose tree is built from numeric columns,
exact arithmetic and traceable UDFs is *fused* into a single batched
program: one dispatch per engine batch for the whole chain, instead of one
Python call per row per UDF.

Execution backends, strongest first (the demotion chain):

- ``torch`` — the port's counterpart of the JAX package's ``xla``: the
  trees the exactness gate admits, as torch ops over int64 / float64 /
  bool tensors on the tier's device (``_autojit_device``: the card),
  with batch sizes padded to power-of-two buckets. On the card each
  bucket's first dispatch captures the partition as one CUDA graph (a
  capture is this tier's compile: ``compiles``, and
  ``device_sanitizer.note_capture``); every later dispatch copies the
  padded arrays into the graph's inputs through pinned buffers, replays
  it and copies the outputs back. A program with such trees and no card
  raises at build (``AutojitDeviceError``): it never falls back to numpy
  silently. Operators hosting a fused program are marked ``device_bound``
  so they ride the scheduler's device leg (engine/device_bridge.py).
- ``numpy`` — the same tree broadcast over numpy arrays. Bit-exact with
  the interpreter by construction (numpy elementwise IEEE ops are the
  same ops CPython uses), still one dispatch per batch.
- ``interp`` — the per-row interpreted path (the fallback fns the
  expression compiler builds anyway). Ground truth.

**Byte-identity with the interpreter is the invariant** — auto-jit may
never change results, only make them faster. Three mechanisms enforce it:

1. *Static exactness gating*, the JAX package's rule for rule, so the
   same trees reach the device partition: any tree with compounding float
   arithmetic (XLA CPU contracts ``a*b+c`` into an FMA), or a UDF body we
   cannot prove free of it, is barred from the device and runs on the
   ``numpy`` backend instead; division inside UDF bodies likewise (a zero
   divisor raises in Python → per-cell ERROR). Eager torch runs each op
   as its own kernel, so nothing contracts on the card either.
2. *Per-batch input guards.* Rows whose cells are not exactly the static
   dtype (Python ``int``/``float``/``bool``; no bigints past ±2^31, no
   ERROR/None) are split out and evaluated on the interpreted path, then
   spliced back — the fast path never sees a value it could mangle.
   Constants enter the torch partition as 0-d int64 / float64 tensors
   made before any capture, so torch's type promotion is numpy's (a
   Python float times an int64 tensor would give float32).
3. *Verify-then-trust.* A program's first live dispatch on each backend
   is compared cell-for-cell (type and value) against the interpreter; a
   mismatch demotes to the next backend, loudly, once. A UDF that fails
   at execution time (data-dependent control flow the AST pass could not
   see) demotes the same way — ``PATHWAY_AUTO_JIT`` can therefore never
   change a pipeline's output, only its speed.

The tier is on by default; ``PATHWAY_AUTO_JIT=0`` disables it everywhere
(compilation, warmup, the stats report it as disabled).
"""

from __future__ import annotations

import ast
import logging
import os
import reprlib
import threading
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch

from pathway_tpu_torch._device import PinnedStaging, resolve_device
from pathway_tpu_torch.engine import device_sanitizer
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex

log = logging.getLogger("pathway_tpu_torch.autojit")

# below this many clean rows a batch stays interpreted: array setup beats
# the per-row savings only past a handful of rows
MIN_ROWS = 8
# |int| bound for fast-path cells: products of two guarded ints stay well
# inside int64, so a single multiply can never wrap (deeper int chains are
# bounded by the static op scan — see _body_traits)
INT_GUARD = 1 << 31
_BUCKET_MIN = 8

_ENABLE_VALUES_OFF = ("0", "false", "off", "no")


def autojit_enabled() -> bool:
    """The ``PATHWAY_AUTO_JIT`` escape hatch, honored everywhere (default
    on)."""
    return os.environ.get("PATHWAY_AUTO_JIT", "1").lower() \
        not in _ENABLE_VALUES_OFF


def _autojit_device() -> torch.device:
    """The device of the fused programs' torch partitions (tests patch it
    to the CPU)."""
    return resolve_device("cuda")


class AutojitDeviceError(RuntimeError):
    """A fused program has trees for the device and there is no usable
    device. Raised at build, never demoted: the tier does not move device
    work to the host behind the caller's back."""


# ---------------------------------------------------------------------------
# tier-wide instrumentation (the monitor's pipelining lines, chip_smoke.py's
# framework phases)
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
_STATS = {
    "programs": 0,            # fused programs built this process
    "compiles": 0,            # torch buckets first walked (graph captures)
    "demotions": 0,           # backend demotions (torch→numpy→interp)
    "device_dispatches": 0,   # batches dispatched through the torch backend
    "vector_dispatches": 0,   # batches dispatched through the numpy backend
    "fallback_batches": 0,    # batches that fell back to the interpreter
}

# live fused programs, for pw.warmup() bucket walking and the stats
_REGISTRY: "weakref.WeakSet[FusedProgram]" = weakref.WeakSet()


def _bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def autojit_stats() -> dict:
    """Snapshot of the tier's counters plus the live-program backend mix."""
    with _STATS_LOCK:
        snap = dict(_STATS)
    backends: dict[str, int] = {}
    buckets = 0
    for prog in list(_REGISTRY):
        backends[prog.backend] = backends.get(prog.backend, 0) + 1
        buckets += len(prog._buckets)
    snap["enabled"] = autojit_enabled()
    snap["live_programs"] = backends
    snap["bucket_count"] = buckets
    return snap


def reset_stats() -> None:
    """Test hook: zero the counters (the registry drains by gc)."""
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


# ---------------------------------------------------------------------------
# UDF classification + body traits
# ---------------------------------------------------------------------------

def _classification(expr: ex.ApplyExpression):
    """The recorded shard-checker class, computed lazily (the attribute is
    the JAX package's, where the static check records it too)."""
    cls = getattr(expr, "_shard_class", None)
    if cls is None:
        from pathway_tpu_torch.internals.static_check.shard_check import \
            classify_udf

        cls = classify_udf(expr._fn)
        expr._shard_class = cls
    return cls


def _body_traits(fn) -> dict:
    """Static scan of a UDF body for exactness hazards the classifier does
    not track: division (a zero divisor raises in Python where arrays give
    inf or 0), pow (libm vs device approximations), compounding float
    arithmetic (FMA contraction on the JAX package's XLA backend: the gate
    stays the reference's), numpy usage (numpy ufuncs reject device
    tensors, so the body is host-vectorizable only), and truthiness
    constructs (``and``/``or``/chained comparisons return an OPERAND per
    Python semantics — arrays cannot reproduce that, and ``bool(array)``
    raises, so they are barred rather than demoted noisily at runtime).
    ``opaque=True`` (no source) assumes every hazard."""
    from pathway_tpu_torch.internals.static_check.shard_check import \
        _function_node

    try:
        node = _function_node(fn)
    except Exception:
        node = None
    if node is None:
        return {"opaque": True, "division": True, "pow": True,
                "arith_ops": 99, "numpy": True, "math": True,
                "math_attrs": set(), "truthy": True, "node": None}
    division = pow_ = False
    arith = 0
    uses_np = uses_math = truthy = False
    math_attrs: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, (ast.BinOp, ast.AugAssign)):
            op = n.op
            if isinstance(op, (ast.Div, ast.FloorDiv, ast.Mod)):
                division = True
            elif isinstance(op, ast.Pow):
                pow_ = True
            if isinstance(op, (ast.Add, ast.Sub, ast.Mult, ast.Div,
                               ast.FloorDiv, ast.Mod, ast.Pow)):
                arith += 1
        elif isinstance(n, ast.Name) and n.id in ("np", "numpy"):
            uses_np = True
        elif isinstance(n, ast.Name) and n.id == "math":
            uses_math = True
        elif isinstance(n, ast.Attribute) and \
                isinstance(n.value, ast.Name) and n.value.id == "math":
            math_attrs.add(n.attr)
        elif isinstance(n, ast.BoolOp):
            truthy = True
        elif isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
            truthy = True  # `not arr` calls bool(arr) — raises on arrays
        elif isinstance(n, ast.Compare) and len(n.ops) > 1:
            truthy = True  # a < b < c lowers to `and` on arrays
    return {"opaque": False, "division": division, "pow": pow_,
            "arith_ops": arith, "numpy": uses_np, "math": uses_math,
            "math_attrs": math_attrs, "truthy": truthy, "node": node}


# ---------------------------------------------------------------------------
# int-overflow bit bounds
# ---------------------------------------------------------------------------
# The interpreter computes on Python bigints; the fused path on int64.
# Byte-identity therefore requires a PROOF that no intermediate can leave
# int64 — verify-then-trust only sees the first batch, and a later batch
# overflowing silently (numpy int64 wraps without warning, torch likewise)
# would be exactly the wrong-but-plausible failure the invariant exists to
# prevent. Bits here bound magnitude: value v has "b bits" iff |v| < 2^b.
# Guarded leaf cells are < 2^31 (INT_GUARD); every arithmetic node
# combines bounds (add/sub: max+1, mult: sum, floordiv/mod: left) and any
# node past 63 bits — or any construct whose bound is unknowable — bars
# the tree from fusing.

_INT_BITS_MAX = 63  # int64 holds |v| < 2^63


class _BitsUnknown(Exception):
    """Raised by the body walker at any construct it cannot bound."""


# float64 represents ints exactly only below 2^53: any int operand past
# that mixed with a float (arith OR comparison) diverges from Python's
# exact int/float semantics once promoted to float64
_FLOAT_EXACT_BITS = 53


def _check_float_mix(lk, lb, rk, rb) -> None:
    """Bar int/float mixing whose int side may exceed float64's exact
    integer range (Python converts/compares exactly; numpy/torch round)."""
    if lk == "i" and rk == "f" and lb is not None \
            and lb > _FLOAT_EXACT_BITS:
        raise _BitsUnknown(f"int operand up to {lb} bits mixed with float")
    if rk == "i" and lk == "f" and rb is not None \
            and rb > _FLOAT_EXACT_BITS:
        raise _BitsUnknown(f"int operand up to {rb} bits mixed with float")


def _body_int_bits(node, params: dict) -> int | None:
    """Max int bits over every intermediate of a UDF body AST, or None
    when unprovable. ``params`` maps parameter names to the
    ``(kind, bits)`` of the argument tree feeding them."""
    seen_max = 0

    def mark(b: int) -> int:
        nonlocal seen_max
        seen_max = max(seen_max, b)
        if b > _INT_BITS_MAX:
            raise _BitsUnknown(f"intermediate needs {b} bits")
        return b

    def expr(n, env) -> tuple[str, int | None]:
        """(kind, bits): kind i/f/b; bits only for i."""
        if isinstance(n, ast.Constant):
            v = n.value
            if isinstance(v, bool):
                return "b", None
            if isinstance(v, int):
                return "i", mark(max(1, v.bit_length()))
            if isinstance(v, float):
                return "f", None
            raise _BitsUnknown(f"constant {type(v).__name__}")
        if isinstance(n, ast.Name):
            if n.id in env:
                k, b = env[n.id]
                return k, b
            raise _BitsUnknown(f"free name {n.id!r}")
        if isinstance(n, ast.BinOp):
            lk, lb = expr(n.left, env)
            rk, rb = expr(n.right, env)
            op = n.op
            if isinstance(op, ast.Div):
                _check_float_mix(lk, lb, rk, rb)
                return "f", None
            if "f" in (lk, rk):
                if isinstance(op, (ast.Add, ast.Sub, ast.Mult,
                                   ast.FloorDiv, ast.Mod)):
                    _check_float_mix(lk, lb, rk, rb)
                    return "f", None
                raise _BitsUnknown("float op")
            if lk != "i" or rk != "i":
                raise _BitsUnknown("non-numeric operand")
            if isinstance(op, (ast.Add, ast.Sub)):
                return "i", mark(max(lb, rb) + 1)
            if isinstance(op, ast.Mult):
                return "i", mark(lb + rb)
            if isinstance(op, ast.FloorDiv):
                # |a // b| <= |a| for |b| >= 1 (b == 0 raises -> fallback)
                return "i", mark(lb)
            if isinstance(op, ast.Mod):
                # |a % b| < |b| — bounded by the RIGHT operand; the left
                # bound would "prove" (-1 % (y*y)) * x safe at 33 bits
                # when it really needs ~93
                return "i", mark(rb)
            # NO bitwise ops: two's-complement breaks every magnitude
            # bound on negative operands (-1 & v == v, -8 ^ 8 == -16),
            # and a negative shift count raises in Python but is C-UB
            # vectorized — the sign is not tracked here, so none of
            # them can be bounded soundly
            raise _BitsUnknown(type(op).__name__)
        if isinstance(n, ast.UnaryOp):
            if isinstance(n.op, (ast.USub, ast.UAdd)):
                k, b = expr(n.operand, env)
                return k, (mark(b + 1) if k == "i" else b)
            if isinstance(n.op, ast.Not):
                expr(n.operand, env)
                return "b", None
            raise _BitsUnknown("invert")
        if isinstance(n, ast.IfExp):
            expr(n.test, env)
            tk, tb = expr(n.body, env)
            ek, eb = expr(n.orelse, env)
            if tk != ek:
                raise _BitsUnknown("mixed-kind conditional")
            if tk == "i":
                return "i", mark(max(tb, eb))
            return tk, None
        if isinstance(n, ast.Compare):
            lk, lb = expr(n.left, env)
            for c in n.comparators:
                rk, rb = expr(c, env)
                # Python compares int-vs-float EXACTLY; numpy/torch promote
                # int64 to float64, which rounds past 2^53
                _check_float_mix(lk, lb, rk, rb)
                lk, lb = rk, rb
            return "b", None
        if isinstance(n, ast.Call):
            fname = None
            if isinstance(n.func, ast.Name):
                fname = n.func.id
            elif isinstance(n.func, ast.Attribute) and \
                    isinstance(n.func.value, ast.Name) and \
                    n.func.value.id == "math":
                fname = f"math.{n.func.attr}"
            args = [expr(a, env) for a in n.args]
            if fname == "abs" and args:
                return args[0]
            if fname == "float":
                return "f", None
            if fname == "int":
                # the guarded _pw_int cast raises past 2^62 (per-batch
                # fallback), so its RESULT is bounded even though its
                # float input is not
                return "i", mark(_INT_BITS_MAX - 1)
            if fname in ("math.sqrt", "math.fabs"):
                return "f", None
            raise _BitsUnknown(fname or "call")
        raise _BitsUnknown(type(n).__name__)

    env = dict(params)
    try:
        if isinstance(node, ast.Lambda):
            expr(node.body, env)
            return seen_max
        for stmt in node.body:
            if isinstance(stmt, ast.Return):
                if stmt.value is not None:
                    expr(stmt.value, env)
                return seen_max
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                env[stmt.targets[0].id] = expr(stmt.value, env)
            elif isinstance(stmt, ast.AugAssign) and \
                    isinstance(stmt.target, ast.Name):
                synthetic = ast.BinOp(
                    left=ast.Name(id=stmt.target.id, ctx=ast.Load()),
                    op=stmt.op, right=stmt.value)
                env[stmt.target.id] = expr(synthetic, env)
            elif isinstance(stmt, ast.Expr):
                continue  # docstring / bare expression
            else:
                raise _BitsUnknown(type(stmt).__name__)
        return seen_max
    except (_BitsUnknown, RecursionError):
        return None


# ---------------------------------------------------------------------------
# array namespaces: what the fused trees and the rewritten bodies call
# ---------------------------------------------------------------------------

class _NumpyXP:
    """numpy under the names the fused trees call (the JAX package passes
    the numpy module itself; numpy 2.0 has no ``astype`` function, so the
    casts go through this namespace, as the torch one's do)."""

    asarray = staticmethod(np.asarray)
    where = staticmethod(np.where)
    trunc = staticmethod(np.trunc)
    abs = staticmethod(np.abs)
    sqrt = staticmethod(np.sqrt)
    float64 = np.float64
    int64 = np.int64

    @staticmethod
    def astype(a, dtype):
        return np.asarray(a).astype(dtype)

    @staticmethod
    def const(v):
        """A constant of a tree as the arrays meet it: the Python value."""
        return v


_NP = _NumpyXP()

_TORCH_DTYPE = {"i": torch.int64, "f": torch.float64, "b": torch.bool}
_TORCH_OK = (torch.int64, torch.float64, torch.bool)


class _TorchXP:
    """The torch counterpart of ``jax.numpy`` for the device partition:
    tensors on ``device``, Python floats as float64 and ints as int64 (the
    JAX package traces under x64)."""

    float64 = torch.float64
    int64 = torch.int64
    where = staticmethod(torch.where)
    trunc = staticmethod(torch.trunc)
    abs = staticmethod(torch.abs)
    sqrt = staticmethod(torch.sqrt)

    def __init__(self, device: torch.device):
        self.device = device

    def asarray(self, x):
        if isinstance(x, torch.Tensor):
            return x
        if type(x) is bool:
            dtype = torch.bool
        elif isinstance(x, int):
            dtype = torch.int64
        else:
            dtype = torch.float64
        # a fill kernel, not a host copy: legal inside a graph capture
        return torch.full((), x, dtype=dtype, device=self.device)

    def astype(self, a, dtype):
        return self.asarray(a).to(dtype)

    def const(self, v):
        """A constant of a tree as a 0-d tensor, made when the tree is
        built (before any capture): an int64 tensor times a Python float
        is float32 in torch, times a 0-d float64 tensor float64, as in
        numpy."""
        return self.asarray(v)


# ---------------------------------------------------------------------------
# row-wise rewrite (the "vmap" arm): IfExp → where, math.* → exact xp.*
# ---------------------------------------------------------------------------

# math functions whose numpy counterparts are IEEE-exact matches of
# CPython's (sqrt is correctly rounded everywhere; fabs is a sign op).
# exp/log/sin/... are approximated differently per backend and would break
# byte-identity silently, so they are NOT mapped — bodies using them stay
# interpreted.
_EXACT_MATH = {"sqrt": "sqrt", "fabs": "_pw_fabs"}


class _RowwiseRewriter(ast.NodeTransformer):
    """Rewrites the restricted per-scalar forms the classifier admits as
    "vmappable" into array-safe code over an ``xp`` namespace: scalar
    conditionals become ``_pw_where`` (with a trace-time branch-dtype
    equality check, since ``where`` promotes where Python picks per-row),
    ``math.sqrt``/``math.fabs`` become exact ``xp`` calls, ``float``/
    ``int`` casts become exact dtype casts. Anything else untranslatable
    marks the rewrite failed. Numeric literals become names bound to
    ``xp.const`` of their value (``consts``): the Python value itself for
    numpy, a 0-d tensor made before capture for torch."""

    def __init__(self):
        self.ok = True
        # int() lowers to the range-guarded _pw_int, whose bounds check
        # reads the data on the host (and an unguarded trunc-to-int64 of
        # an unbounded float would silently wrap) — numpy backend only
        self.no_device = False
        self.consts: list = []

    def visit_Constant(self, node):
        if type(node.value) not in (int, float):
            return node
        self.consts.append(node.value)
        return ast.copy_location(
            ast.Name(id=f"_pw_k{len(self.consts) - 1}", ctx=ast.Load()),
            node)

    def visit_IfExp(self, node):
        node = self.generic_visit(node)
        return ast.copy_location(
            ast.Call(func=ast.Name(id="_pw_where", ctx=ast.Load()),
                     args=[node.test, node.body, node.orelse], keywords=[]),
            node)

    def visit_Call(self, node):
        node = self.generic_visit(node)
        func = node.func
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and func.value.id == "math":
            target = _EXACT_MATH.get(func.attr)
            if target is None:
                self.ok = False
                return node
            if target.startswith("_pw"):
                name = ast.Name(id=target, ctx=ast.Load())
            else:
                name = ast.Attribute(
                    value=ast.Name(id="xp", ctx=ast.Load()),
                    attr=target, ctx=ast.Load())
            return ast.copy_location(
                ast.Call(func=name, args=node.args, keywords=node.keywords),
                node)
        if isinstance(func, ast.Name):
            if func.id == "float":
                return ast.copy_location(
                    ast.Call(func=ast.Name(id="_pw_float", ctx=ast.Load()),
                             args=node.args, keywords=node.keywords), node)
            if func.id == "int":
                self.no_device = True
                return ast.copy_location(
                    ast.Call(func=ast.Name(id="_pw_int", ctx=ast.Load()),
                             args=node.args, keywords=node.keywords), node)
            if func.id == "abs":
                return node  # __abs__ works on arrays and tensors alike
            self.ok = False
        return node


def _rewrite_namespace(xp) -> dict:
    """The helper namespace rewritten bodies run in. ``_pw_where`` rejects
    mixed-dtype branches at trace/broadcast time (Python's conditional is
    type-preserving per row; ``where`` would promote) — the rejection
    surfaces as a demotion, never a wrong value."""

    def _pw_where(c, a, b):
        aa, bb = xp.asarray(a), xp.asarray(b)
        if aa.dtype != bb.dtype:
            raise TypeError(
                "auto-jit: conditional branches have different dtypes "
                f"({aa.dtype} vs {bb.dtype}) — per-row type preservation "
                "cannot be vectorized")
        return xp.where(c, aa, bb)

    def _pw_float(x):
        return xp.astype(x, xp.float64)

    def _pw_int(x):
        # numpy backend only (the rewriter sets no_device): Python's
        # int(float) is exact at any magnitude; int64 is not.
        # Out-of-range (or non-finite) inputs raise FloatingPointError so
        # the dispatcher falls back to the interpreter for THIS batch
        # without demoting the tier — same contract as a zero divisor.
        arr = xp.asarray(x)
        if bool(np.any(~np.isfinite(arr) | (np.abs(arr) >= float(1 << 62)))):
            raise FloatingPointError(
                "auto-jit: int() cast outside int64-exact range")
        return xp.astype(xp.trunc(arr), xp.int64)

    def _pw_fabs(x):
        return xp.abs(xp.astype(x, xp.float64))

    return {"xp": xp, "_pw_where": _pw_where, "_pw_float": _pw_float,
            "_pw_int": _pw_int, "_pw_fabs": _pw_fabs}


def _rewrite_rowwise(fn) -> tuple[Callable[[Any], Callable], bool] | None:
    """``(build(xp) -> batched fn, no_device)`` for a vmappable body, or
    None. The rewritten function is elementwise, so broadcasting the
    arrays through it IS the vmap of the scalar original (the admitted
    forms are straight-line scalar code — no shape-dependent behavior to
    diverge)."""
    from pathway_tpu_torch.internals.static_check.shard_check import \
        _function_node

    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    closure_modules: dict[str, Any] = {}
    if code.co_freevars:
        # closure cells do not survive re-compilation, and freezing a
        # mutable cell would silently diverge from the live interpreter
        # path — EXCEPT cells holding module objects (a UDF defined
        # inside a function whose enclosing scope did `import math`):
        # modules are process singletons, so binding them is exact
        import types

        for name, cell in zip(code.co_freevars, fn.__closure__ or ()):
            try:
                val = cell.cell_contents
            except ValueError:  # empty cell
                return None
            if not isinstance(val, types.ModuleType):
                return None
            closure_modules[name] = val
    node = _function_node(fn)
    if node is None:
        return None
    rewriter = _RowwiseRewriter()
    if isinstance(node, ast.Lambda):
        new = rewriter.visit(
            ast.Expression(body=ast.Lambda(args=node.args, body=node.body)))
        if not rewriter.ok:
            return None
        mode, tree = "eval", new
    else:
        fndef = ast.FunctionDef(
            name=node.name, args=node.args, body=node.body,
            decorator_list=[], returns=None, type_params=[])
        new = rewriter.visit(ast.Module(body=[fndef], type_ignores=[]))
        if not rewriter.ok:
            return None
        mode, tree = "exec", new
    ast.fix_missing_locations(tree)
    try:
        compiled = compile(tree, f"<autojit:{code.co_filename}>", mode)
    except (SyntaxError, TypeError, ValueError):
        return None
    fn_globals = getattr(fn, "__globals__", {})
    consts = tuple(rewriter.consts)

    def build(xp):
        ns = dict(fn_globals)
        ns.update(closure_modules)
        ns.update(_rewrite_namespace(xp))
        ns.update((f"_pw_k{i}", xp.const(v)) for i, v in enumerate(consts))
        if mode == "eval":
            return eval(compiled, ns)  # noqa: S307 — our own rewritten AST
        exec(compiled, ns)  # noqa: S102
        return ns[node.name]

    return build, rewriter.no_device


# ---------------------------------------------------------------------------
# expression-tree emitter
# ---------------------------------------------------------------------------

_KIND_BY_DTYPE = None  # {dtype: numpy kind char}, populated lazily


def _leaf_kind(dtype) -> str | None:
    global _KIND_BY_DTYPE
    if _KIND_BY_DTYPE is None:
        _KIND_BY_DTYPE = {dt.INT: "i", dt.FLOAT: "f", dt.BOOL: "b"}
    return _KIND_BY_DTYPE.get(dt.unoptionalize(dtype))


_NP_DTYPE = {"i": np.int64, "f": np.float64, "b": np.bool_}

# expression-level binary ops with IEEE-exact vector semantics. The
# division family is deliberately absent: a zero divisor raises in Python
# (→ per-cell ERROR) but yields inf/0 vectorized, and the interpreter's
# numeric fast path already owns those guards.
_BIN_ARITH = {"+", "-", "*"}
_BIN_CMP = {"<", "<=", ">", ">=", "==", "!="}


class _Tree:
    """One emitted output expression: ``build(xp) -> f(env) -> array`` over
    the group's leaf environment, plus the exactness metadata the backend
    gate needs."""

    __slots__ = ("build", "kind", "fdepth", "device_ok", "has_udf", "labels",
                 "ibits")

    def __init__(self, build, kind, fdepth=0, device_ok=True, has_udf=False,
                 labels=(), ibits=None):
        self.build = build
        self.kind = kind          # result numpy kind: i / f / b
        self.fdepth = fdepth      # chained float-arith depth (FMA risk at 2)
        self.device_ok = device_ok
        self.has_udf = has_udf
        self.labels = tuple(labels)
        # int-magnitude bound: |value| < 2^ibits, proven statically (None
        # for f/b results). The guard that keeps int64 from wrapping where
        # the interpreter would have promoted to bigint.
        self.ibits = ibits if kind == "i" else None


class _LeafMap:
    """Assigns stable env slots to column references (deduped by column)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.slots: dict[tuple[int, str], int] = {}
        self.refs: list[ex.ColumnReference] = []
        self.kinds: list[str] = []

    def slot(self, ref: ex.ColumnReference, kind: str) -> int:
        key = (id(ref.table), ref.name)
        pos = self.slots.get(key)
        if pos is None:
            pos = len(self.refs)
            self.slots[key] = pos
            self.refs.append(ref)
            self.kinds.append(kind)
        return pos

    def positions(self) -> list[int]:
        return [self.ctx.position(r) for r in self.refs]


def _emit(expr, leaves: _LeafMap) -> _Tree | None:
    """Recursive tree build; None marks the subtree non-fusable."""
    from pathway_tpu_torch.internals.type_inference import infer_dtype

    if isinstance(expr, ex.IdExpression):
        return None
    if type(expr) is ex.ColumnReference:
        try:
            kind = _leaf_kind(infer_dtype(expr))
        except Exception:
            return None
        if kind is None:
            return None
        pos = leaves.slot(expr, kind)
        return _Tree(lambda xp, _p=pos: (lambda env: env[_p]), kind,
                     ibits=31)  # cells guarded to |v| < 2^31 at dispatch
    if isinstance(expr, ex.ConstExpression):
        v = expr._value
        tv = type(v)
        if tv is bool:
            kind = "b"
        elif tv is int:
            if not (-INT_GUARD < v < INT_GUARD):
                return None
            kind = "i"
        elif tv is float:
            kind = "f"
        else:
            return None
        return _Tree(lambda xp, _v=v: (lambda env, _c=xp.const(_v): _c),
                     kind,
                     ibits=max(1, v.bit_length()) if kind == "i" else None)
    if isinstance(expr, ex.UnaryExpression) and expr._op == "-":
        arg = _emit(expr._arg, leaves)
        if arg is None or arg.kind not in "if":
            return None
        return _Tree(
            # true negation, NOT `0 - x`: subtraction-from-zero turns
            # -0.0 into +0.0 where Python's unary minus keeps the sign
            lambda xp, _a=arg.build: (
                lambda env, _f=_a(xp): -_f(env)),
            arg.kind, arg.fdepth, arg.device_ok, arg.has_udf, arg.labels,
            ibits=arg.ibits)
    if isinstance(expr, ex.BinaryExpression):
        op = expr._op
        if op not in _BIN_ARITH and op not in _BIN_CMP:
            return None
        lt = _emit(expr._left, leaves)
        rt = _emit(expr._right, leaves)
        if lt is None or rt is None:
            return None
        if lt.kind not in "if" or rt.kind not in "if":
            return None
        import operator

        py_op = {"+": operator.add, "-": operator.sub, "*": operator.mul,
                 "<": operator.lt, "<=": operator.le, ">": operator.gt,
                 ">=": operator.ge, "==": operator.eq,
                 "!=": operator.ne}[op]

        def build(xp, _l=lt.build, _r=rt.build, _o=py_op):
            lf, rf = _l(xp), _r(xp)
            return lambda env: _o(lf(env), rf(env))

        device_ok = lt.device_ok and rt.device_ok
        ibits = None
        if {lt.kind, rt.kind} == {"i", "f"}:
            # int/float mixing (arith or comparison): Python converts and
            # compares EXACTLY; float64 promotion rounds past 2^53
            int_side = lt if lt.kind == "i" else rt
            if int_side.ibits is None or int_side.ibits > _FLOAT_EXACT_BITS:
                return None
        if op in _BIN_ARITH:
            kind = "f" if "f" in (lt.kind, rt.kind) else "i"
            fdepth = (max(lt.fdepth, rt.fdepth) + 1) if kind == "f" else 0
            if fdepth >= 2:
                device_ok = False  # FMA contraction on the JAX package's XLA
            if kind == "i":
                ibits = (lt.ibits + rt.ibits if op == "*"
                         else max(lt.ibits, rt.ibits) + 1)
                if ibits > _INT_BITS_MAX:
                    return None  # could leave int64 where Python promotes
        else:
            kind, fdepth = "b", 0
        return _Tree(build, kind, fdepth, device_ok,
                     lt.has_udf or rt.has_udf, lt.labels + rt.labels,
                     ibits=ibits)
    if isinstance(expr, ex.IfElseExpression):
        ct = _emit(expr._if, leaves)
        tt = _emit(expr._then, leaves)
        et = _emit(expr._else, leaves)
        if ct is None or tt is None or et is None or ct.kind != "b" \
                or tt.kind != et.kind or tt.kind not in "if":
            return None

        def build(xp, _c=ct.build, _t=tt.build, _e=et.build):
            cf, tf, ef = _c(xp), _t(xp), _e(xp)
            return lambda env: xp.where(cf(env), tf(env), ef(env))

        return _Tree(build, tt.kind, max(tt.fdepth, et.fdepth),
                     ct.device_ok and tt.device_ok and et.device_ok,
                     ct.has_udf or tt.has_udf or et.has_udf,
                     ct.labels + tt.labels + et.labels,
                     ibits=(max(tt.ibits, et.ibits)
                            if tt.kind == "i" else None))
    if type(expr) is ex.ApplyExpression:  # excludes the async subclasses
        return _emit_apply(expr, leaves)
    return None


def _globals_fusable(fn, node) -> bool:
    """True iff every name the body loads resolves to a parameter, a
    local assignment, a builtin, or a MODULE global. Non-module globals
    (a tunable ``SCALE = 2.0``) are refused: the fused program would
    freeze them (globals-dict copy for rewritten bodies, trace-time
    baking under jit) while the interpreter fallback reads them live —
    and the classifier admits such bodies as traceable, so without this
    gate a mid-run mutation silently diverges. Modules are process
    singletons; attribute lookups on them stay live in the rewritten
    namespace."""
    if node is None:
        return False
    import builtins
    import types

    bound: set[str] = set()
    arg_obj = node.args
    for a in (list(arg_obj.posonlyargs) + list(arg_obj.args)
              + list(arg_obj.kwonlyargs)):
        bound.add(a.arg)
    for v in (arg_obj.vararg, arg_obj.kwarg):
        if v is not None:
            bound.add(v.arg)
    # only the BODY executes per call — decorators (`@pw.udf`) and
    # annotations resolve at def time, and a decorator name imported in
    # an enclosing function scope is invisible to fn.__globals__ without
    # being a runtime read at all
    body = node.body if isinstance(node.body, list) else [node.body]
    body_nodes = [x for stmt in body for x in ast.walk(stmt)]
    for n in body_nodes:
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            bound.add(n.id)
    fn_globals = getattr(fn, "__globals__", {}) or {}
    closure_names = set(getattr(fn, "__code__", None).co_freevars
                        if getattr(fn, "__code__", None) else ())
    for n in body_nodes:
        if not (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)):
            continue
        name = n.id
        if name in bound:
            continue
        if name in closure_names:
            continue  # module-only, enforced by _rewrite_rowwise / below
        if name in fn_globals:
            if not isinstance(fn_globals[name], types.ModuleType):
                return False
        elif not hasattr(builtins, name):
            return False
    if closure_names:
        # non-rewrite path: closure cells must also be module-valued
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                if not isinstance(cell.cell_contents, types.ModuleType):
                    return False
            except ValueError:
                return False
    return True


def _emit_apply(expr: ex.ApplyExpression, leaves: _LeafMap) -> _Tree | None:
    from pathway_tpu_torch.internals.type_inference import infer_dtype

    if getattr(expr, "_batch", False):
        return None  # batch UDFs already amortize dispatch
    cls = _classification(expr)
    if not cls.jit_eligible:
        return None
    args = [_emit(a, leaves) for a in expr._args]
    kwargs = {k: _emit(v, leaves) for k, v in expr._kwargs.items()}
    if any(a is None for a in args) or any(v is None for v in kwargs.values()):
        return None
    try:
        ret_kind = _leaf_kind(infer_dtype(expr))
    except Exception:
        ret_kind = None
    if ret_kind is None:
        # no declared return type (plain pw.apply): predict from the arg
        # kinds — arithmetic preserves kind, and a misprediction only
        # tightens a parent's gating or trips the dtype checks/verify,
        # never a silent wrong value
        arg_kinds = [t.kind for t in args] + [t.kind for t in
                                              kwargs.values()]
        if not arg_kinds:
            return None
        ret_kind = "f" if "f" in arg_kinds else (
            "i" if "i" in arg_kinds else "b")
    fn = expr._fn
    traits = _body_traits(fn)
    if traits["truthy"]:
        # and/or/chained-compare return an OPERAND per Python truthiness;
        # arrays cannot reproduce that (bool(array) raises) — interpreted
        return None
    if traits["pow"] and ret_kind == "i":
        return None  # int ** int grows past int64 unboundedly
    needs_rewrite = cls.kind == "vmappable" or (
        not traits["opaque"] and traits["math"])
    rewrite_no_device = False
    if needs_rewrite:
        rewritten = _rewrite_rowwise(fn)
        if rewritten is None:
            return None
        body_build, rewrite_no_device = rewritten
    else:
        def body_build(xp, _fn=fn):
            if xp is _NP:
                return _fn
            # the device partition runs the body with its numeric
            # literals as 0-d tensors (see _TorchXP.const)
            lifted = _rewrite_rowwise(_fn)
            if lifted is None:
                raise TypeError(
                    f"auto-jit: the body of {_fn!r} cannot be rebuilt "
                    "over tensors")
            return lifted[0](xp)
    if not traits["opaque"] and not _globals_fusable(fn, traits["node"]):
        # the body reads a module-level name that is NOT a module: the
        # fused program would snapshot/bake its value while the
        # interpreter fallback reads it live — a mid-run mutation would
        # split a batch between stale and live values, and the
        # DeterministicMapOperator replay cache this fusion elides exists
        # precisely for such unverified-deterministic bodies
        return None
    # int-overflow proof (see _body_int_bits): the interpreter promotes to
    # bigint, int64 wraps — any int-involved body must bound every
    # intermediate within int64 or stay interpreted. An int() cast
    # ANYWHERE in the body forces the proof too: a predicted-float return
    # kind would otherwise skip it while _pw_int mints int64 values up to
    # 2^62 whose products wrap silently
    body_has_int_cast = traits["node"] is not None and any(
        isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
        and c.func.id == "int" for c in ast.walk(traits["node"]))
    int_involved = ret_kind == "i" or body_has_int_cast or any(
        t.kind == "i" for t in args) or any(
        t.kind == "i" for t in kwargs.values())
    ibits = None
    if int_involved:
        node = traits["node"]
        if node is None:
            return None  # opaque body: unprovable
        arg_objs = list(node.args.posonlyargs) + list(node.args.args)
        if node.args.vararg or node.args.kwarg or len(arg_objs) < len(args):
            return None
        params = {a.arg: (t.kind, t.ibits)
                  for a, t in zip(arg_objs, args)}
        for k, t in kwargs.items():
            params[k] = (t.kind, t.ibits)
        ibits = _body_int_bits(node, params)
        if ibits is None:
            return None
        ibits = max(ibits, 1)
    # backend exactness gate for the body (see module doc): division/pow/
    # compounding-float-arith/numpy/math-use bar the device partition
    float_involved = ret_kind == "f" or any(
        t.kind == "f" for t in args) or any(
        t.kind == "f" for t in kwargs.values())
    device_ok = not traits["division"] and not traits["pow"] \
        and not traits["numpy"] and not traits["math"] \
        and not rewrite_no_device \
        and not (float_involved and traits["arith_ops"] >= 2)
    device_ok = device_ok and all(t.device_ok for t in args) and all(
        t.device_ok for t in kwargs.values())
    name = getattr(fn, "__name__", "<udf>")

    def build(xp, _args=tuple(args), _kwargs=dict(kwargs), _bb=body_build):
        f = _bb(xp)
        arg_fns = [t.build(xp) for t in _args]
        kw_fns = {k: t.build(xp) for k, t in _kwargs.items()}

        def run(env):
            return f(*[g(env) for g in arg_fns],
                     **{k: g(env) for k, g in kw_fns.items()})

        return run

    labels = (name,) + tuple(
        x for t in args for x in t.labels) + tuple(
        x for t in kwargs.values() for x in t.labels)
    return _Tree(build, ret_kind,
                 2 if (float_involved and traits["arith_ops"]) else 0,
                 device_ok, True, labels,
                 ibits=ibits if ret_kind == "i" else None)


# ---------------------------------------------------------------------------
# the fused program
# ---------------------------------------------------------------------------

def _bucket(n: int) -> int:
    return max(_BUCKET_MIN, 1 << (n - 1).bit_length())


def _cells_equal(a, b) -> bool:
    if a is b:
        return True
    if type(a) is not type(b):
        return False
    try:
        if a == b:
            # == calls -0.0 equal to 0.0; byte-identity does not
            if type(a) is float and a == 0.0:
                import math as _math

                return _math.copysign(1.0, a) == _math.copysign(1.0, b)
            return True
        return a != a and b != b  # NaN == NaN for identity purposes
    except Exception:
        return False


def _host(o) -> np.ndarray:
    """A CPU tensor (or a constant output) as a numpy array."""
    return o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)


class FusedProgram:
    """One map program's fused output expressions (see module doc).

    ``dispatch(keys, rows, fallback_fns)`` returns the fused columns (in
    ``expr_idx`` order) or None when the whole batch must stay on the
    interpreted path. Rows whose cells fail the input guards are evaluated
    through ``fallback_fns`` (the interpreter) and spliced back, so a
    partially-dirty batch still vectorizes its clean majority.

    One program holds ALL the fusable expressions of a map — the leaf
    columns are extracted and guard-validated ONCE per batch, shared by
    both execution partitions: trees the exactness gate admits to the
    device run as torch ops (``_device_part``: one CUDA graph replay per
    batch on the card), trees it bars (compounding float arithmetic,
    division bodies — see module doc) run broadcast over the same arrays
    on the ``numpy`` partition (``_np_part``). A demotion collapses torch
    → numpy → interp for the whole program, loudly-once.

    ``device_ms`` sums the device partition's CUDA-event time over live
    dispatches on the card, ``numpy_ms`` the numpy partition's host time
    and ``verify_ms`` the host time of the first-batch verification (the
    interpreter over that batch); ``graphs`` maps each bucket captured on
    the card to its graph.
    """

    def __init__(self, expr_idx: list[int], trees: list[_Tree],
                 leaves: _LeafMap, label: str):
        self.expr_idx = list(expr_idx)
        self.leaf_pos = leaves.positions()
        self.leaf_kinds = list(leaves.kinds)
        self.label = label
        self._device_part = [i for i, t in enumerate(trees) if t.device_ok]
        self._np_part = [i for i, t in enumerate(trees) if not t.device_ok]
        self._np_fn = self._build(_NP, trees)
        self._np_sub_fn = (self._build(_NP, [trees[i] for i in self._np_part])
                           if self._np_part else None)
        self._torch_fn = None
        self._buckets: set[int] = set()
        self.graphs: dict[int, tuple] = {}
        self._staging: PinnedStaging | None = None
        # one dispatch at a time through the graphs' fixed tensors (worker
        # replicas share the program)
        self._lock = threading.Lock()
        self.device: torch.device | None = None
        self.backend = "numpy"
        self.verified = False
        self.device_ms = 0.0
        self.numpy_ms = 0.0
        self.verify_ms = 0.0
        if self._device_part and autojit_enabled():
            try:
                self.device = _autojit_device()
            except RuntimeError as e:
                raise AutojitDeviceError(
                    f"auto-jit: program {label} has {len(self._device_part)}"
                    f" device tree(s) and no device: {e}. Set "
                    "PATHWAY_AUTO_JIT=0 to run it interpreted") from e
            self._arm_torch([trees[i] for i in self._device_part])
        _REGISTRY.add(self)
        _bump("programs")

    @staticmethod
    def _build(xp, trees):
        fns = [t.build(xp) for t in trees]

        def fused(*arrays):
            return tuple(f(arrays) for f in fns)

        return fused

    def _arm_torch(self, device_trees) -> None:
        """Probe the device partition over bucket-8 tensors; arm the torch
        backend only when the probe passes AND every output is an int64,
        float64 or bool tensor of the bucket's length, or a Python
        constant (a body casting to float32 would change cell values)."""
        try:
            fused = self._build(_TorchXP(self.device), device_trees)
            probe = [torch.ones(_BUCKET_MIN, dtype=_TORCH_DTYPE[k],
                                device=self.device)
                     for k in self.leaf_kinds]
            bad = []
            for o in fused(*probe):
                if isinstance(o, torch.Tensor):
                    if o.dtype not in _TORCH_OK or \
                            o.shape not in ((), (_BUCKET_MIN,)):
                        bad.append(f"{o.dtype}{tuple(o.shape)}")
                elif type(o) not in (int, float, bool):
                    bad.append(type(o).__name__)
            if bad:
                raise TypeError(f"outputs not int64/float64/bool: {bad}")
            self._torch_fn = fused
            self.backend = "torch"
        except Exception as e:  # probe failure → numpy tier, recorded
            self._demote("numpy", f"torch probe failed: {e!r}",
                         level=logging.INFO)

    # ------------------------------------------------------------------
    def _demote(self, to: str, reason: str,
                level: int = logging.WARNING) -> None:
        log.log(level,
                "auto-jit: program %s demoted %s -> %s: %s (results are "
                "unaffected — the slower tier takes over)",
                self.label, self.backend, to, reason)
        self.backend = to
        self.verified = False
        if to != "torch":
            self._torch_fn = None
            self.graphs = {}
        _bump("demotions")

    # ------------------------------------------------------------------
    @staticmethod
    def _clean_col(col: list, k: str):
        """Typed array for an all-clean column, else None. The common case
        (homogeneous, in-range cells) validates at C speed — set(map(type))
        and ndarray reductions — with no per-row Python loop."""
        types = set(map(type, col))
        if k == "i":
            if types != {int}:
                return None
            try:
                arr = np.asarray(col, np.int64)
            except OverflowError:  # a bigint cell slipped past int64
                return None
            # min/max, not abs: np.abs(-2**63) wraps to itself (negative)
            # and would sneak the worst possible cell past the guard
            if int(arr.max(initial=0)) >= INT_GUARD \
                    or int(arr.min(initial=0)) <= -INT_GUARD:
                return None
            return arr
        if k == "f":
            return np.asarray(col, np.float64) if types == {float} else None
        return np.asarray(col, np.bool_) if types == {bool} else None

    def _split_rows(self, rows):
        """(live_idx, dead_idx, arrays): live_idx None means every row is
        clean (fast path, no index lists materialized); arrays is None
        when too few rows survive the cell guards."""
        cols = [[r[p] for r in rows] for p in self.leaf_pos]
        n = len(rows)
        kinds = self.leaf_kinds
        arrays = []
        for col, k in zip(cols, kinds):
            arr = self._clean_col(col, k)
            if arr is None:
                break
            arrays.append(arr)
        else:
            return None, (), arrays
        # a dirty column: per-row scan splits the batch so the clean
        # majority still vectorizes
        live: list[int] = []
        dead: list[int] = []
        for i in range(n):
            ok = True
            for col, k in zip(cols, kinds):
                v = col[i]
                tv = type(v)
                if k == "f":
                    if tv is not float:
                        ok = False
                        break
                elif k == "i":
                    if tv is not int or not (-INT_GUARD < v < INT_GUARD):
                        ok = False
                        break
                elif tv is not bool:
                    ok = False
                    break
            (live if ok else dead).append(i)
        if len(live) < MIN_ROWS:
            return live, dead, None
        try:
            arrays = [np.asarray([c[i] for i in live], _NP_DTYPE[k])
                      for c, k in zip(cols, kinds)]
        except Exception:
            return live, dead, None
        return live, dead, arrays

    def _run_torch(self, padded: list, b: int, warm: bool) -> list:
        """The device partition over the edge-padded arrays of bucket
        ``b``: numpy arrays of length b (0-d for a constant output), in
        partition order. On the card a replay of the bucket's graph (its
        first dispatch captures it); on the CPU the same ops eagerly."""
        if self.device.type != "cuda":
            if b not in self._buckets:
                self._buckets.add(b)
                _bump("compiles")
            outs = self._torch_fn(*[torch.from_numpy(a) for a in padded])
            return [_host(o) for o in outs]
        with self._lock:
            entry = self.graphs.get(b)
            if entry is None:
                entry = self.graphs[b] = self._capture(padded, b)
            graph, outs, host, start, end, done = entry
            self._staging.upload(padded)
            start.record()
            graph.replay()
            end.record()
            for h, o in zip(host, outs):
                if h is not None:
                    h.copy_(o, non_blocking=True)
            done.record()
            with device_sanitizer.explicit_sync("auto-jit result"):
                done.synchronize()
            if not warm:
                self.device_ms += start.elapsed_time(end)
            return [h.numpy().copy() if h is not None else np.asarray(o)
                    for h, o in zip(host, outs)]

    def _capture(self, padded: list, b: int) -> tuple:
        """(graph, its outputs, pinned host buffers, timing events) for
        bucket ``b``: one eager run on a side stream (PyTorch's recipe:
        lazy set-up before the capture), then the capture over the
        staging's fixed input tensors for the bucket. The capture's error
        mode is ``thread_local``: the bridge's worker may capture while
        the host thread runs CUDA work."""
        device_sanitizer.note_capture(f"autojit {self.label}, bucket {b}")
        if self._staging is None:
            self._staging = PinnedStaging(self.device)
        inputs = self._staging.upload(padded)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._torch_fn(*inputs)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # entering the capture synchronizes the device
        with device_sanitizer.explicit_sync("auto-jit capture"):
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = self._torch_fn(*inputs)
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                if isinstance(o, torch.Tensor) else None for o in outs]
        self._buckets.add(b)
        _bump("compiles")
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        return (graph, outs, host, *events, torch.cuda.Event())

    def _run_backend(self, arrays, n_live: int, warm: bool = False):
        """Raw fused outputs as numpy arrays of length ``n_live``, in tree
        order. On the ``torch`` backend the two partitions share the SAME
        guarded arrays: one device dispatch for the device trees, one
        broadcast pass for the numpy-only trees."""
        if self.backend == "torch":
            b = _bucket(n_live)
            padded = arrays
            if b != n_live:
                padded = [np.pad(a, (0, b - n_live), mode="edge")
                          for a in arrays]
            dev_outs = self._run_torch(padded, b, warm)
            if not warm:
                _bump("device_dispatches")
            merged: list = [None] * (len(self._device_part)
                                     + len(self._np_part))
            for i, o in zip(self._device_part, dev_outs):
                merged[i] = (o[:n_live] if o.ndim
                             else np.full(n_live, o[()]))
            if self._np_sub_fn is not None:
                np_outs = self._run_numpy(self._np_sub_fn, arrays, warm)
                for i, o in zip(self._np_part, np_outs):
                    merged[i] = (np.asarray(o) if getattr(o, "ndim", 0)
                                 else np.full(n_live, o))
            return merged
        outs = self._run_numpy(self._np_fn, arrays, warm)
        return [np.asarray(o) if getattr(o, "ndim", 0)
                else np.full(n_live, o) for o in outs]

    def _run_numpy(self, fn, arrays, warm: bool):
        t0 = time.perf_counter()
        with np.errstate(divide="raise", over="raise", invalid="raise"):
            outs = fn(*arrays)
        if not warm:
            self.numpy_ms += (time.perf_counter() - t0) * 1e3
            _bump("vector_dispatches")
        return outs

    def dispatch(self, keys, rows, fallback_fns):
        if self.backend == "interp" or not autojit_enabled():
            return None
        n = len(keys)
        if n < MIN_ROWS:
            return None
        live, dead, arrays = self._split_rows(rows)
        if arrays is None:
            _bump("fallback_batches")
            return None
        n_live = n if live is None else len(live)
        try:
            outs = self._run_backend(arrays, n_live)
            out_cols = [o.tolist() for o in outs]
        except FloatingPointError:
            # data-dependent (zero divisor / overflow in THIS batch):
            # interpret the batch, keep the tier armed
            _bump("fallback_batches")
            return None
        except Exception as e:
            # the runtime safety net: execution failed on real data —
            # demote loudly-once, results come from the fallback
            self._demote("numpy" if self.backend == "torch" else "interp",
                         f"dispatch failed: {e!r}")
            _bump("fallback_batches")
            return None
        if not self.verified:
            # verify-then-trust: the first live dispatch on each backend
            # is checked cell-for-cell against the interpreter
            t0 = time.perf_counter()
            if live is None:
                live_keys, live_rows = keys, rows
            else:
                live_keys = [keys[i] for i in live]
                live_rows = [rows[i] for i in live]
            expected = [fb(live_keys, live_rows) for fb in fallback_fns]
            for got_col, want_col in zip(out_cols, expected):
                for g, w in zip(got_col, want_col):
                    if not _cells_equal(g, w):
                        self._demote(
                            "numpy" if self.backend == "torch" else "interp",
                            "first-batch verify mismatch: "
                            f"{reprlib.repr(g)} != {reprlib.repr(w)}")
                        _bump("fallback_batches")
                        return None
            self.verified = True
            self.verify_ms += (time.perf_counter() - t0) * 1e3
        if not dead:
            return out_cols
        dead_keys = [keys[i] for i in dead]
        dead_rows = [rows[i] for i in dead]
        spliced = []
        for col, fb in zip(out_cols, fallback_fns):
            full: list = [None] * n
            fb_col = fb(dead_keys, dead_rows)
            for j, i in enumerate(live):
                full[i] = col[j]
            for j, i in enumerate(dead):
                full[i] = fb_col[j]
            spliced.append(full)
        return spliced

    # ------------------------------------------------------------------
    def warm(self, max_bucket: int | None = None) -> list[tuple]:
        """Walk the power-of-two buckets so no first-tick capture lands in
        serving latency (pw.warmup). Only the torch backend has buckets."""
        if self.backend != "torch" or self._torch_fn is None:
            return []
        if max_bucket is None:
            try:
                max_bucket = int(os.environ.get(
                    "PATHWAY_AUTO_JIT_WARM_MAX", str(2048)))
            except ValueError:
                max_bucket = 2048
        out = []
        b = _BUCKET_MIN
        while b <= max_bucket:
            arrays = [np.ones(b, _NP_DTYPE[k]) for k in self.leaf_kinds]
            try:
                self._run_backend(arrays, b, warm=True)
            except FloatingPointError:
                pass  # data-dependent (ones hit a guard) — bucket walked
            except Exception as e:
                self._demote("numpy", f"warmup dispatch failed: {e!r}")
                return out
            out.append(("autojit", (self.label, b)))
            b <<= 1
        return out


# ---------------------------------------------------------------------------
# compiler entry points
# ---------------------------------------------------------------------------

def fuse_program(exprs: list, ctx) -> list[FusedProgram]:
    """Fuse the traceable-UDF output expressions of one map program into
    ONE batched dispatch. Returns [] when the tier is off or nothing
    qualifies.

    All fusable trees share one program — leaf extraction and the input
    guard run once per batch — with device-exact trees and numpy-only
    trees (compounding float arithmetic, division-bearing bodies — see the
    module doc) split into internal PARTITIONS, so one float chain cannot
    drag the whole program off the device. A program with device trees
    and no device raises ``AutojitDeviceError``."""
    if not autojit_enabled():
        return []
    leaves = _LeafMap(ctx)
    idx: list[int] = []
    trees: list[_Tree] = []
    for i, e in enumerate(exprs):
        if not isinstance(e, ex.ColumnExpression):
            continue
        try:
            t = _emit(e, leaves)
        except Exception:
            t = None
        if t is not None and t.has_udf:
            idx.append(i)
            trees.append(t)
    if not idx:
        return []
    # re-emit over a fresh leaf map so only the FUSED trees' columns are
    # extracted at dispatch (the probe map may have collected leaves of
    # trees that did not qualify)
    final = _LeafMap(ctx)
    trees = [_emit(exprs[i], final) for i in idx]
    if any(t is None for t in trees) or not final.refs:
        return []
    label = "+".join(sorted({x for t in trees for x in t.labels})
                     or {"<expr>"})
    try:
        return [FusedProgram(idx, trees, final, label)]
    except AutojitDeviceError:
        raise
    except Exception as e:  # never let the tier break compilation
        log.info("auto-jit: fusing %s failed at build (%r) — "
                 "interpreted path keeps the program", label, e)
        return []


def discard_programs(programs) -> None:
    """Back out FusedPrograms built by a lowering path that then bailed
    (runner._lower_map_split): drop them from the warmup registry and the
    ``programs`` counter, so the stats count only programs that can ever
    dispatch."""
    for prog in programs or ():
        _REGISTRY.discard(prog)
        _bump("programs", -1)


def _contains_host_udf(expr) -> bool:
    stack = [expr]
    while stack:
        e = stack.pop()
        if type(e) is ex.ApplyExpression and not getattr(e, "_batch", False):
            if _classification(e).kind == "host":
                return True
        stack.extend(getattr(e, "_deps", ()))
    return False


def split_map_exprs(exprs: list) -> tuple[list[int], list[int]] | None:
    """Host/device split for a map program: when a select carries BOTH
    fusable-UDF expressions and host-only-UDF expressions, return
    (device_idx, host_idx) so the lowering can split them into two
    operators — the device part rides the device leg while the host part
    steps on the host thread, overlapping host-only UDF time with device
    time instead of serializing it. None = keep one operator."""
    if not autojit_enabled():
        return None
    leaves = _LeafMap(_NullCtx())
    device_idx: list[int] = []
    host_idx: list[int] = []
    host_udf_seen = False
    for i, e in enumerate(exprs):
        t = None
        if isinstance(e, ex.ColumnExpression):
            try:
                t = _emit(e, leaves)
            except Exception:
                t = None
        if t is not None and t.has_udf:
            device_idx.append(i)
        else:
            host_idx.append(i)
            if isinstance(e, ex.ColumnExpression) and _contains_host_udf(e):
                host_udf_seen = True
    if not device_idx or not host_idx or not host_udf_seen:
        return None
    return device_idx, host_idx


class _NullCtx:
    """Position-free stand-in so split_map_exprs can emit without a
    compile context (positions are only needed at dispatch time)."""

    def position(self, ref):  # pragma: no cover — never dispatched
        return 0


# ---------------------------------------------------------------------------
# warmup hook
# ---------------------------------------------------------------------------

def warm_registered(max_bucket: int | None = None) -> list[tuple]:
    """Walk every live fused program's bucket ladder (pw.warmup)."""
    if not autojit_enabled():
        return []
    out: list[tuple] = []
    for prog in list(_REGISTRY):
        out.extend(prog.warm(max_bucket))
    return out
