"""Expression AST → batched evaluators — port of
pathway_tpu/internals/expression_compiler.py.

Evaluation is *batched*: each compiled node maps a whole delta's column to
a result column. Sync UDFs run once per batch; async UDFs gather the whole
batch on one event loop. Numeric columns use numpy fast paths; object
columns fall back to per-row Python with ERROR-sentinel propagation per
cell. With the auto-jit tier on (internals/autojit.py, the default;
``PATHWAY_AUTO_JIT=0`` turns it off), the traceable-UDF chains of a map
program also compile into one fused dispatch a batch, torch ops on the
card for the trees its exactness gate admits and numpy for the rest; the
interpreted functions stay its fallback and verifier.
"""
from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import operations as ops
from pathway_tpu_torch.internals.error import ERROR, global_error_log
from pathway_tpu_torch.internals.keys import hash_values

Batch = list  # column of values, len == n rows


class CompileContext:
    """Maps column references to tuple positions in the engine row."""

    def __init__(self):
        self.col_pos: dict[tuple[int, str], int] = {}
        # table -> position of its id in the row (a join's wide row carries
        # both side ids after the columns)
        self.id_pos: dict[int, int] = {}

    def add_table(self, table, offset: int) -> int:
        """Register `table`'s columns at `offset`; returns next free offset."""
        names = table._column_names()
        for i, name in enumerate(names):
            self.col_pos.setdefault((id(table), name), offset + i)
        return offset + len(names)

    def position(self, ref: ex.ColumnReference) -> int:
        key = (id(ref.table), ref.name)
        if key not in self.col_pos:
            raise KeyError(
                f"column {ref.name!r} of table {ref.table!r} is not part of "
                "this context (did you mean pw.this, or join the tables first?)"
            )
        return self.col_pos[key]


class _AsyncLoop:
    """Shared background event loop for async UDF batches
    (reference: internals/graph_runner/async_utils.py)."""

    _instance = None

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="pathway-tpu-async-udf")
        self.thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    @classmethod
    def get(cls) -> "_AsyncLoop":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def gather(self, coros: list) -> list:
        async def _g():
            return await asyncio.gather(*coros, return_exceptions=True)

        fut = asyncio.run_coroutine_threadsafe(_g(), self.loop)
        return fut.result()


def run_coro_batch(coros: list) -> list:
    results = _AsyncLoop.get().gather(coros)
    out = []
    for r in results:
        if isinstance(r, Exception):
            global_error_log().log(f"async UDF failed: {r!r}")
            out.append(ERROR)
        else:
            out.append(r)
    return out


class ExpressionCompiler:
    def __init__(self, ctx: CompileContext):
        self.ctx = ctx
        self.has_non_deterministic = False
        # set when a compiled expression dispatches accelerator work
        # (batch UDF with device=True): the hosting operator is marked
        # device_bound, so it runs in the tick's device leg (the device
        # bridge's worker when PATHWAY_DEVICE_INFLIGHT >= 2)
        self.has_device = False
        # the fused auto-jit programs compiled for the last
        # compile_program call, if any (internals/autojit.py)
        self.autojit = None

    # -- public -------------------------------------------------------------
    def compile(self, expr: ex.ColumnExpression) -> Callable[[list, list], Batch]:
        return self._compile(expr)

    def compile_program(self, exprs: list[ex.ColumnExpression]):
        """Compile many output expressions into fn(keys, rows) -> list[tuple].

        With auto-jit on (internals/autojit.py, PATHWAY_AUTO_JIT), output
        expressions whose trees are fusable traceable-UDF chains compile
        additionally into ONE vectorized dispatch; the per-expression
        interpreted fns stay as the fallback/verification path, so the
        fused tier can never change results — only skip per-row calls.
        """
        fns = []
        nondet_idx = set()
        for i, e in enumerate(exprs):
            outer = self.has_non_deterministic
            self.has_non_deterministic = False
            fns.append(self._compile(e))
            if self.has_non_deterministic:
                nondet_idx.add(i)
            self.has_non_deterministic = outer or self.has_non_deterministic
        from pathway_tpu_torch.internals import autojit

        try:
            fused = autojit.fuse_program(exprs, self.ctx)
        except autojit.AutojitDeviceError:
            raise  # device trees and no card: never run them elsewhere
        except Exception:
            fused = []
        self.autojit = fused or None
        if fused and nondet_idx <= {i for g in fused for i in g.expr_idx}:
            # Every "non-deterministic" expression fused. Fusion only
            # admits UDFs the classifier proved to be straight-line
            # numeric code (no host calls, no RNG-bearing modules), so
            # they are deterministic in fact — the default
            # deterministic=False merely declares them UNVERIFIED. The
            # caching DeterministicMapOperator (per-row blake2b
            # fingerprints) exists to replay values for genuinely
            # non-deterministic fns; here it would cost more than the fused
            # dispatch itself, so the lowering may use the plain map:
            # recomputation at retraction time reproduces the same bytes.
            self.has_non_deterministic = False
        if not fused:
            def program(keys, rows):
                cols = [fn(keys, rows) for fn in fns]
                return list(zip(*cols)) if cols else [() for _ in keys]

            return program

        plan = [(grp, [fns[i] for i in grp.expr_idx]) for grp in fused]

        def program(keys, rows):
            cols: list = [None] * len(fns)
            for grp, fallbacks in plan:
                fcols = grp.dispatch(keys, rows, fallbacks)
                if fcols is not None:
                    for i, c in zip(grp.expr_idx, fcols):
                        cols[i] = c
            for i, fn in enumerate(fns):
                if cols[i] is None:
                    cols[i] = fn(keys, rows)
            return list(zip(*cols)) if cols else [() for _ in keys]

        return program

    def compile_predicate(self, expr: ex.ColumnExpression):
        fn = self._compile(expr)

        def pred(keys, rows):
            return [bool(v) and v is not ERROR for v in fn(keys, rows)]

        return pred

    def compile_key_fn(self, exprs: list[ex.ColumnExpression]):
        fns = [self._compile(e) for e in exprs]

        def key_fn(keys, rows):
            cols = [fn(keys, rows) for fn in fns]
            return [hash_values(*vals) for vals in zip(*cols)]

        return key_fn

    def compile_row(self, expr) -> Callable[[Any, tuple], Any]:
        """Per-row evaluator ``fn(key, row) -> value``: plain column and id
        references (group keys, join keys, reducer arguments) index the
        tuple directly; anything else runs as a batch of one."""
        if not isinstance(expr, ex.ColumnExpression):
            return lambda key, row: expr
        if isinstance(expr, ex.IdExpression):  # subclasses ColumnReference
            return lambda key, row: key
        if isinstance(expr, ex.ColumnReference):
            pos = self.ctx.position(expr)
            return lambda key, row: row[pos]
        if isinstance(expr, ex.ConstExpression):
            const = expr._value
            return lambda key, row: const
        batch_fn = self._compile(expr)
        return lambda key, row: batch_fn([key], [row])[0]

    # -- dispatch -----------------------------------------------------------
    def _compile(self, expr) -> Callable[[list, list], Batch]:
        if not isinstance(expr, ex.ColumnExpression):
            expr = ex.ConstExpression(expr)
        method = getattr(self, f"_compile_{type(expr).__name__}", None)
        if method is None:
            raise NotImplementedError(f"cannot compile {type(expr).__name__}")
        return method(expr)

    # -- leaves -------------------------------------------------------------
    def _compile_ConstExpression(self, expr):
        v = expr._value

        def fn(keys, rows):
            return [v] * len(keys)

        return fn

    def _compile_IdExpression(self, expr):
        pos = self.ctx.id_pos.get(id(expr.table))
        if pos is not None:
            def fn(keys, rows):
                return [r[pos] for r in rows]
            return fn

        def fn(keys, rows):
            return list(keys)

        return fn

    def _compile_ColumnReference(self, expr):
        pos = self.ctx.position(expr)

        def fn(keys, rows):
            return [r[pos] for r in rows]

        return fn

    # -- operators ----------------------------------------------------------

    # vectorizable ops over non-optional numeric columns — elementwise
    # array callables (BINARY_OPS' == / != are whole-array scalar equality
    # for ndarrays, so they get explicit elementwise forms here).
    # Division-family ops and exponent are excluded (zero divisors raise
    # in python but produce inf/nan in numpy); int overflow guards below
    # keep python's bigint semantics.
    _NUMERIC_FAST_OPS = {
        "+": np.add, "-": np.subtract, "*": np.multiply,
        "<": np.less, "<=": np.less_equal,
        ">": np.greater, ">=": np.greater_equal,
        "==": np.equal, "!=": np.not_equal,
        # division family: numpy matches python elementwise (floor toward
        # -inf, % sign follows divisor, / correctly rounded) EXCEPT for a
        # zero divisor (python raises → per-cell ERROR; numpy warns and
        # emits 0/inf/nan) — any zero in the divisor column falls back
        "//": np.floor_divide, "%": np.mod, "/": np.true_divide,
    }
    _INT_SAFE = 1 << 62
    _FLOAT_EXACT = float(1 << 53)  # beyond this, int->float64 rounds

    @staticmethod
    def _numeric_column(vals, pure_float: bool):
        """np array for a fast path, or None to fall back. ``pure_float``
        rejects float-kind arrays built from mixed runtime values: a
        statically-FLOAT column may hold python ints (types_lca widening),
        and coercing them would round >2^53 magnitudes and change per-row
        result types where the op preserves them (negation, if_else
        selection, exact int-vs-float comparison)."""
        try:
            a = np.asarray(vals)
        except Exception:
            return None
        k = a.dtype.kind
        if k not in "if":
            return None  # ERROR/None/bool/bigint cells present
        if k == "f" and pure_float and not all(
                type(v) is float for v in vals):
            return None
        return a

    def _numeric_fast_eligible(self, expr) -> bool:
        from pathway_tpu_torch.internals.type_inference import infer_dtype

        if expr._op not in self._NUMERIC_FAST_OPS:
            return False
        try:
            ld = infer_dtype(expr._left)
            rd = infer_dtype(expr._right)
        except Exception:
            return False
        for d in (ld, rd):
            if d != dt.unoptionalize(d):  # optional: None semantics
                return False
            if dt.unoptionalize(d) not in (dt.INT, dt.FLOAT):
                return False
        return True

    def _compile_BinaryExpression(self, expr):
        lf = self._compile(expr._left)
        rf = self._compile(expr._right)
        op = ops.BINARY_OPS[expr._op]
        opname = expr._op
        fast = self._numeric_fast_eligible(expr)

        def slow(lv, rv):
            out = []
            for a, b in zip(lv, rv):
                if a is ERROR or b is ERROR:
                    out.append(ERROR)
                elif a is None or b is None:
                    if opname == "==":
                        out.append(a is None and b is None)
                    elif opname == "!=":
                        out.append(not (a is None and b is None))
                    else:
                        out.append(None)
                else:
                    try:
                        out.append(op(a, b))
                    except Exception as e:
                        global_error_log().log(f"{opname} failed: {e!r}")
                        out.append(ERROR)
            return out

        if not fast:
            def fn(keys, rows):
                return slow(lf(keys, rows), rf(keys, rows))

            return fn

        int_safe = self._INT_SAFE
        float_exact = self._FLOAT_EXACT
        arith = opname in ("+", "-", "*", "//", "%", "/")
        divlike = opname in ("//", "%", "/")
        np_op = self._NUMERIC_FAST_OPS[opname]

        def magnitude(a) -> float:
            # NOT np.abs().max(): abs(INT64_MIN) wraps negative and would
            # slip past the guard
            return max(abs(float(a.max(initial=0))),
                       abs(float(a.min(initial=0))))

        def fn(keys, rows):
            lv = lf(keys, rows)
            rv = rf(keys, rows)
            if len(lv) < 8:  # array setup dominates tiny batches
                return slow(lv, rv)
            # comparisons are exact between int and float in python but
            # not after a float64 coercion, so they need pure columns
            la = self._numeric_column(lv, pure_float=not arith)
            ra = self._numeric_column(rv, pure_float=not arith)
            if la is None or ra is None:
                return slow(lv, rv)
            if divlike and bool((ra == 0).any()):
                # python raises (→ per-cell ERROR) where numpy warns
                return slow(lv, rv)
            lk, rk = la.dtype.kind, ra.dtype.kind
            if lk == "i" and rk == "i":
                if arith:
                    # keep python's arbitrary-precision ints:
                    # near-overflow magnitudes fall back (int64 wraps)
                    amax, bmax = magnitude(la), magnitude(ra)
                    if opname == "*":
                        if amax * bmax >= float(1 << 62):
                            return slow(lv, rv)
                    elif opname == "/":
                        # int/int → float: numpy converts operands to
                        # float64 FIRST, python divides exact ints — they
                        # differ beyond 2^53
                        if amax >= float_exact or bmax >= float_exact:
                            return slow(lv, rv)
                    elif amax >= int_safe or bmax >= int_safe:
                        return slow(lv, rv)
            elif lk != rk:
                # int-vs-float: numpy casts the int side to float64 first,
                # while python compares/combines exactly — ints beyond
                # 2^53 would round, so fall back
                ints = la if lk == "i" else ra
                if magnitude(ints) >= float_exact:
                    return slow(lv, rv)
            return np_op(la, ra).tolist()

        return fn

    def _compile_UnaryExpression(self, expr):
        af = self._compile(expr._arg)
        op = ops.UNARY_OPS[expr._op]
        fast_neg = False
        if expr._op == "-":
            from pathway_tpu_torch.internals.type_inference import infer_dtype

            try:
                d = infer_dtype(expr._arg)
                fast_neg = (d == dt.unoptionalize(d)
                            and dt.unoptionalize(d) in (dt.INT, dt.FLOAT))
            except Exception:
                fast_neg = False

        def slow(vals):
            return [
                ERROR if v is ERROR else (None if v is None else op(v))
                for v in vals
            ]

        if not fast_neg:
            def fn(keys, rows):
                return slow(af(keys, rows))

            return fn

        numcol = self._numeric_column

        def fn(keys, rows):
            vals = af(keys, rows)
            if len(vals) < 8:
                return slow(vals)
            a = numcol(vals, pure_float=True)  # negation preserves types
            if a is None:
                return slow(vals)
            if a.dtype.kind == "i" and a.size and \
                    float(a.min(initial=0)) <= float(-(1 << 63)):
                return slow(vals)  # -INT64_MIN overflows int64
            return np.negative(a).tolist()

        return fn

    def _compile_IsNoneExpression(self, expr):
        af = self._compile(expr._arg)

        def fn(keys, rows):
            return [v is None for v in af(keys, rows)]

        return fn

    def _compile_IsNotNoneExpression(self, expr):
        af = self._compile(expr._arg)

        def fn(keys, rows):
            return [v is not None for v in af(keys, rows)]

        return fn

    def _compile_IfElseExpression(self, expr):
        cf = self._compile(expr._if)
        tf = self._compile(expr._then)
        ef = self._compile(expr._else)
        fast = False
        try:
            from pathway_tpu_torch.internals.type_inference import infer_dtype

            td = infer_dtype(expr._then)
            ed = infer_dtype(expr._else)
            fast = (td == ed  # same static kind or the per-row types mix
                    and all(
                        d == dt.unoptionalize(d)
                        and dt.unoptionalize(d) in (dt.INT, dt.FLOAT)
                        for d in (td, ed)))
        except Exception:
            fast = False

        def slow(cond, tv, ev):
            return [
                ERROR if c is ERROR else (t if c else e)
                for c, t, e in zip(cond, tv, ev)
            ]

        numcol = self._numeric_column

        def fn(keys, rows):
            cond = cf(keys, rows)
            tv = tf(keys, rows)
            ev = ef(keys, rows)
            if not fast or len(cond) < 8:
                return slow(cond, tv, ev)
            try:
                ca = np.asarray(cond)
            except Exception:
                return slow(cond, tv, ev)
            if ca.dtype.kind != "b":  # ERROR cells in the condition
                return slow(cond, tv, ev)
            # selection preserves each value's own type, so both branches
            # must be pure columns of the SAME kind
            ta = numcol(tv, pure_float=True)
            ea = numcol(ev, pure_float=True)
            if ta is None or ea is None or ta.dtype.kind != ea.dtype.kind:
                return slow(cond, tv, ev)
            return np.where(ca, ta, ea).tolist()

        return fn

    def _compile_CoalesceExpression(self, expr):
        fns = [self._compile(a) for a in expr._args]

        def fn(keys, rows):
            cols = [f(keys, rows) for f in fns]
            out = []
            for vals in zip(*cols):
                res = None
                for v in vals:
                    if v is not None and v is not ERROR:
                        res = v
                        break
                    if v is ERROR:
                        res = ERROR
                        break
                out.append(res)
            return out

        return fn

    def _compile_RequireExpression(self, expr):
        vf = self._compile(expr._val)
        fns = [self._compile(a) for a in expr._args]

        def fn(keys, rows):
            vals = vf(keys, rows)
            deps = [f(keys, rows) for f in fns]
            out = []
            for i, v in enumerate(vals):
                if any(d[i] is None for d in deps):
                    out.append(None)
                else:
                    out.append(v)
            return out

        return fn

    def _compile_CastExpression(self, expr):
        af = self._compile(expr._expr)
        target = expr._return_type

        def fn(keys, rows):
            out = []
            for v in af(keys, rows):
                try:
                    out.append(ops.cast_value(v, target))
                except Exception as e:
                    global_error_log().log(f"cast failed: {e!r}")
                    out.append(ERROR)
            return out

        return fn

    def _compile_ConvertExpression(self, expr):
        af = self._compile(expr._expr)
        target = expr._return_type
        unwrap = expr._unwrap

        def fn(keys, rows):
            out = []
            for v in af(keys, rows):
                try:
                    out.append(ops.convert_value(v, target, unwrap))
                except Exception as e:
                    global_error_log().log(f"convert failed: {e!r}")
                    out.append(ERROR)
            return out

        return fn

    def _compile_DeclareTypeExpression(self, expr):
        return self._compile(expr._expr)

    def _compile_UnwrapExpression(self, expr):
        af = self._compile(expr._expr)

        def fn(keys, rows):
            out = []
            for v in af(keys, rows):
                if v is None:
                    global_error_log().log("unwrap() got None")
                    out.append(ERROR)
                else:
                    out.append(v)
            return out

        return fn

    def _compile_FillErrorExpression(self, expr):
        af = self._compile(expr._expr)
        rf = self._compile(expr._replacement)

        def fn(keys, rows):
            vals = af(keys, rows)
            reps = rf(keys, rows)
            return [r if v is ERROR else v for v, r in zip(vals, reps)]

        return fn

    def _compile_MakeTupleExpression(self, expr):
        fns = [self._compile(a) for a in expr._args]

        def fn(keys, rows):
            cols = [f(keys, rows) for f in fns]
            return [tuple(vals) for vals in zip(*cols)] if cols else [()] * len(keys)

        return fn

    def _compile_GetExpression(self, expr):
        of = self._compile(expr._obj)
        inf = self._compile(expr._index)
        df = self._compile(expr._default)
        check = expr._check_if_exists

        def fn(keys, rows):
            objs = of(keys, rows)
            idxs = inf(keys, rows)
            defs = df(keys, rows)
            out = []
            for o, i, d in zip(objs, idxs, defs):
                try:
                    out.append(ops.get_item(o, i, d, check))
                except Exception as e:
                    global_error_log().log(f"get_item failed: {e!r}")
                    out.append(ERROR)
            return out

        return fn

    def _compile_MethodCallExpression(self, expr):
        fns = [self._compile(a) for a in expr._args]
        method = ops.METHODS[expr._method]
        if expr._method.startswith("dt."):
            ops.pandas_for_dt()
        kwargs = expr._kwargs

        def fn(keys, rows):
            cols = [f(keys, rows) for f in fns]
            out = []
            for vals in zip(*cols):
                if vals[0] is None:
                    out.append(None)
                    continue
                if any(v is ERROR for v in vals):
                    out.append(ERROR)
                    continue
                try:
                    out.append(method(*vals, **kwargs))
                except Exception as e:
                    global_error_log().log(f"{expr._method} failed: {e!r}")
                    out.append(ERROR)
            return out

        return fn

    def _compile_PointerExpression(self, expr):
        fns = [self._compile(a) for a in expr._args]
        inst_fn = self._compile(expr._instance) if expr._instance is not None else None

        def fn(keys, rows):
            cols = [f(keys, rows) for f in fns]
            if inst_fn is not None:
                cols.append(inst_fn(keys, rows))
            return [hash_values(*vals) for vals in zip(*cols)]

        return fn

    def _compile_ApplyExpression(self, expr):
        fns = [self._compile(a) for a in expr._args]
        kw_fns = {k: self._compile(v) for k, v in expr._kwargs.items()}
        f = expr._fn
        propagate_none = expr._propagate_none
        if not expr._deterministic:
            self.has_non_deterministic = True
        if getattr(expr, "_batch", False):
            if getattr(expr, "_device", False):
                self.has_device = True
            return self._compile_batch_apply(expr, fns, kw_fns)

        def fn(keys, rows):
            arg_cols = [g(keys, rows) for g in fns]
            kw_cols = {k: g(keys, rows) for k, g in kw_fns.items()}
            out = []
            for i in range(len(keys)):
                args = [c[i] for c in arg_cols]
                kws = {k: c[i] for k, c in kw_cols.items()}
                if any(a is ERROR for a in args) or any(
                        v is ERROR for v in kws.values()):
                    out.append(ERROR)
                    continue
                if propagate_none and (any(a is None for a in args) or any(
                        v is None for v in kws.values())):
                    out.append(None)
                    continue
                try:
                    out.append(f(*args, **kws))
                except Exception as e:
                    global_error_log().log(f"apply failed: {e!r}")
                    out.append(ERROR)
            return out

        return fn

    def _compile_batch_apply(self, expr, fns, kw_fns):
        """Columnar UDF dispatch: ``fn`` gets whole columns (lists aligned by
        row) and returns a list of results — one host→device round-trip per
        engine batch instead of per row. Rows with ERROR/None args are masked
        out before the call and spliced back after."""
        f = expr._fn
        propagate_none = expr._propagate_none
        max_bs = expr._max_batch_size

        def fn(keys, rows):
            arg_cols = [g(keys, rows) for g in fns]
            kw_cols = {k: g(keys, rows) for k, g in kw_fns.items()}
            n = len(keys)
            out: list = [None] * n
            live: list[int] = []
            for i in range(n):
                args_i = [c[i] for c in arg_cols]
                kws_i = [c[i] for c in kw_cols.values()]
                if any(a is ERROR for a in args_i) or any(
                        v is ERROR for v in kws_i):
                    out[i] = ERROR
                elif propagate_none and (any(a is None for a in args_i)
                                         or any(v is None for v in kws_i)):
                    out[i] = None
                else:
                    live.append(i)
            step = max_bs or len(live) or 1
            for lo in range(0, len(live), step):
                idx = live[lo:lo + step]
                args = [[c[i] for i in idx] for c in arg_cols]
                kws = {k: [c[i] for i in idx] for k, c in kw_cols.items()}
                try:
                    results = f(*args, **kws)
                    if len(results) != len(idx):
                        raise ValueError(
                            f"batch UDF returned {len(results)} results "
                            f"for {len(idx)} rows")
                    for i, r in zip(idx, results):
                        out[i] = r
                except Exception as e:
                    global_error_log().log(f"batch apply failed: {e!r}")
                    for i in idx:
                        out[i] = ERROR
            return out

        return fn

    def _compile_AsyncApplyExpression(self, expr):
        fns = [self._compile(a) for a in expr._args]
        kw_fns = {k: self._compile(v) for k, v in expr._kwargs.items()}
        f = expr._fn
        propagate_none = expr._propagate_none
        if not expr._deterministic:
            self.has_non_deterministic = True

        def fn(keys, rows):
            arg_cols = [g(keys, rows) for g in fns]
            kw_cols = {k: g(keys, rows) for k, g in kw_fns.items()}
            coros = []
            slots = []  # (index, precomputed | None)
            for i in range(len(keys)):
                args = [c[i] for c in arg_cols]
                kws = {k: c[i] for k, c in kw_cols.items()}
                if any(a is ERROR for a in args) or any(
                        v is ERROR for v in kws.values()):
                    slots.append((i, ERROR))
                elif propagate_none and (any(a is None for a in args) or any(
                        v is None for v in kws.values())):
                    slots.append((i, None))
                else:
                    slots.append((i, _PENDING))
                    coros.append(f(*args, **kws))
            results = run_coro_batch(coros) if coros else []
            out: list = [None] * len(keys)
            it = iter(results)
            for i, pre in slots:
                out[i] = next(it) if pre is _PENDING else pre
            return out

        return fn

    _compile_FullyAsyncApplyExpression = _compile_AsyncApplyExpression

    def _compile_ReducerExpression(self, expr):
        raise TypeError(
            f"reducer {expr._name!r} used outside groupby().reduce()"
        )


class _Pending:
    pass


_PENDING = _Pending()


def compile_map_program(exprs, ctx: CompileContext):
    comp = ExpressionCompiler(ctx)
    program = comp.compile_program(list(exprs))
    # carried as function attributes so the lowering can mark the hosting
    # MapOperator device_bound without changing every call site. An
    # auto-jit fused program joins the device leg exactly like an explicit
    # device=True batch UDF: its dispatches belong on the bridge worker so
    # the host thread can start the next tick's host-side work.
    program.autojit = comp.autojit
    program.device_bound = comp.has_device or comp.autojit is not None
    return program, comp.has_non_deterministic
