"""Join DSL — port of pathway_tpu/internals/joins.py.

``t1.join(t2, t1.a == t2.b, how="left").select(...)`` — JoinResult carries
both sides + the on-condition; select/reduce lower to the engine
JoinOperator (internals/runner.py ``_lower_join_select``; result id =
mix of the side ids, or one side's id with ``id=``).

>>> import pathway_tpu_torch as pw
>>> l = pw.debug.table_from_markdown('''
... k | v
... a | 1
... b | 2
... ''')
>>> r = pw.debug.table_from_markdown('''
... k | w
... a | 10
... c | 30
... ''')
>>> pw.debug.compute_and_print(
...     l.join_left(r, l.k == r.k).select(l.k, l.v, r.w),
...     include_id=False)
k | v | w
a | 1 | 10
b | 2 |
"""

from __future__ import annotations

import enum

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.table import Plan, Table
from pathway_tpu_torch.internals.type_inference import infer_dtype
from pathway_tpu_torch.internals.universe import Universe


class JoinMode(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


class JoinResult:
    def __init__(self, left: Table, right: Table,
                 on: list[tuple[ex.ColumnExpression, ex.ColumnExpression]],
                 mode: str, id_expr=None, exact_match: bool = False):
        self._left = left
        self._right = right
        self._on = on
        self._mode = mode
        self._id_expr = id_expr

    @classmethod
    def create(cls, left: Table, right: Table, on, mode: str, id_expr,
               left_instance=None, right_instance=None) -> "JoinResult":
        pairs = []
        for cond in on:
            pairs.append(_split_condition(cond, left, right))
        if left_instance is not None and right_instance is not None:
            pairs.append((
                thisclass.resolve_this({"this": left, "left": left}, ex.wrap_arg(left_instance)),
                thisclass.resolve_this({"this": right, "right": right}, ex.wrap_arg(right_instance)),
            ))
        if isinstance(mode, JoinMode):
            mode = mode.value
        return cls(left, right, pairs, mode, id_expr)

    # -- result construction ------------------------------------------------
    def _resolve(self, e):
        proxy = _JoinThisProxy(self._left, self._right, self._mode)
        return thisclass.resolve_this(
            {"left": self._left, "right": self._right, "this": proxy}, e
        )

    def select(self, *args, **kwargs) -> Table:
        exprs: dict[str, ex.ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, thisclass.ThisRef):
                kind = arg._kind
                tab = {"left": self._left, "right": self._right}.get(kind)
                if tab is None:
                    for n in self._left.column_names():
                        exprs[n] = self._left[n]
                    for n in self._right.column_names():
                        if n not in exprs:
                            exprs[n] = self._right[n]
                else:
                    for n in tab.column_names():
                        exprs[n] = tab[n]
            elif isinstance(arg, ex.ColumnReference):
                exprs[arg.name] = self._resolve(arg)
            else:
                raise TypeError(f"bad positional select arg: {arg!r}")
        for name, e in kwargs.items():
            exprs[name] = self._resolve(ex.wrap_arg(e))

        # wrap dtypes Optional for the side that may be missing
        cols = {}
        for name, e in exprs.items():
            d = infer_dtype(e)
            side = _expr_side(e, self._left, self._right)
            if (side == "right" and self._mode in ("left", "outer")) or (
                    side == "left" and self._mode in ("right", "outer")):
                d = dt.Optional(d)
            cols[name] = sch.ColumnSchema(name=name, dtype=d)
        schema = sch.schema_from_columns(cols)
        plan = Plan(
            "join_select",
            left=self._left, right=self._right, on=self._on, mode=self._mode,
            id_expr=self._id_expr, exprs=list(exprs.values()),
            names=list(exprs.keys()),
        )
        universe = Universe()
        if self._id_expr is not None and isinstance(self._id_expr, ex.IdExpression):
            src = self._id_expr.table
            if src is self._left:
                universe = self._left._universe
            elif src is self._right:
                universe = self._right._universe
        return Table(plan, schema, universe)

    def reduce(self, *args, **kwargs) -> Table:
        return self._as_table().reduce(*args, **kwargs)

    def groupby(self, *args, **kwargs):
        resolved = [self._resolve(ex.wrap_arg(a)) for a in args]
        t = self._as_table()
        # re-point references at the materialized table by name
        mapped = []
        for e in resolved:
            if isinstance(e, ex.ColumnReference):
                mapped.append(t[e.name])
            else:
                mapped.append(e)
        return t.groupby(*mapped, **kwargs)

    def filter(self, expr) -> Table:
        return self._as_table().filter(
            _repoint(self._resolve(ex.wrap_arg(expr)), self))

    def _as_table(self) -> Table:
        exprs = {}
        for n in self._left.column_names():
            exprs[n] = self._left[n]
        for n in self._right.column_names():
            if n not in exprs:
                exprs[n] = self._right[n]
        return self.select(**exprs)


class _JoinThisProxy:
    """pw.this inside join select: unambiguous column from either side."""

    def __init__(self, left, right, mode):
        self._left = left
        self._right = right
        self._universe = None

    def __getitem__(self, name):
        in_left = name in self._left.column_names()
        in_right = name in self._right.column_names()
        if in_left and in_right:
            raise KeyError(
                f"column {name!r} exists on both sides; use pw.left/pw.right"
            )
        if in_left:
            return self._left[name]
        if in_right:
            return self._right[name]
        raise KeyError(name)


def _split_condition(cond, left: Table, right: Table):
    if not isinstance(cond, ex.BinaryExpression) or cond._op != "==":
        raise ValueError("join condition must be <left col> == <right col>")
    a, b = cond._left, cond._right
    a = thisclass.resolve_this({"left": left, "right": right, "this": left}, a)
    b = thisclass.resolve_this({"left": left, "right": right, "this": right}, b)
    a_side = _expr_side(a, left, right)
    b_side = _expr_side(b, left, right)
    if a_side == "right" or b_side == "left":
        a, b = b, a
    return (a, b)


def _expr_side(e, left, right):
    tables = set()

    def walk(x):
        if isinstance(x, ex.ColumnReference):
            if x.table is left:
                tables.add("left")
            elif x.table is right:
                tables.add("right")
        for d in getattr(x, "_deps", ()):
            walk(d)

    walk(e)
    if tables == {"left"}:
        return "left"
    if tables == {"right"}:
        return "right"
    return "both" if tables else "none"


def _repoint(expr, join_result):
    return expr
