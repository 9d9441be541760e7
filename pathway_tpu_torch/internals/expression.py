"""Lazy column expression AST — port of pathway_tpu/internals/expression.py.

Expressions are built by operator overloading on column references, carried
as metadata on Tables, and compiled at lowering time into *batched*
evaluators (internals/expression_compiler.py). UDFs (`ApplyExpression`) are
dispatched once per batch, never per row.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt


class ColumnExpression:
    _dtype: dt.DType | None = None

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other):
        return BinaryExpression("+", self, other)

    def __radd__(self, other):
        return BinaryExpression("+", other, self)

    def __sub__(self, other):
        return BinaryExpression("-", self, other)

    def __rsub__(self, other):
        return BinaryExpression("-", other, self)

    def __mul__(self, other):
        return BinaryExpression("*", self, other)

    def __rmul__(self, other):
        return BinaryExpression("*", other, self)

    def __truediv__(self, other):
        return BinaryExpression("/", self, other)

    def __rtruediv__(self, other):
        return BinaryExpression("/", other, self)

    def __floordiv__(self, other):
        return BinaryExpression("//", self, other)

    def __rfloordiv__(self, other):
        return BinaryExpression("//", other, self)

    def __mod__(self, other):
        return BinaryExpression("%", self, other)

    def __rmod__(self, other):
        return BinaryExpression("%", other, self)

    def __pow__(self, other):
        return BinaryExpression("**", self, other)

    def __rpow__(self, other):
        return BinaryExpression("**", other, self)

    def __matmul__(self, other):
        return BinaryExpression("@", self, other)

    def __rmatmul__(self, other):
        return BinaryExpression("@", other, self)

    def __neg__(self):
        return UnaryExpression("-", self)

    def __invert__(self):
        return UnaryExpression("~", self)

    def __abs__(self):
        return MethodCallExpression("num.abs", self)

    # -- comparison --------------------------------------------------------
    def __eq__(self, other):  # type: ignore[override]
        return BinaryExpression("==", self, other)

    def __ne__(self, other):  # type: ignore[override]
        return BinaryExpression("!=", self, other)

    def __lt__(self, other):
        return BinaryExpression("<", self, other)

    def __le__(self, other):
        return BinaryExpression("<=", self, other)

    def __gt__(self, other):
        return BinaryExpression(">", self, other)

    def __ge__(self, other):
        return BinaryExpression(">=", self, other)

    # -- boolean (bitwise like pandas) ------------------------------------
    def __and__(self, other):
        return BinaryExpression("&", self, other)

    def __rand__(self, other):
        return BinaryExpression("&", other, self)

    def __or__(self, other):
        return BinaryExpression("|", self, other)

    def __ror__(self, other):
        return BinaryExpression("|", other, self)

    def __xor__(self, other):
        return BinaryExpression("^", self, other)

    def __rxor__(self, other):
        return BinaryExpression("^", other, self)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise TypeError(
            "Cannot use a ColumnExpression in a boolean context — expressions "
            "are lazy; use & | ~ instead of and/or/not."
        )

    # -- access ------------------------------------------------------------
    def __getitem__(self, item):
        return GetExpression(self, item, check_if_exists=False)

    def get(self, item, default=None):
        return GetExpression(self, item, default=default, check_if_exists=True)

    # -- misc public combinators (parity with pw.ColumnExpression) ---------
    def is_none(self) -> "ColumnExpression":
        return IsNoneExpression(self)

    def is_not_none(self) -> "ColumnExpression":
        return IsNotNoneExpression(self)

    def as_int(self):
        return ConvertExpression(self, dt.INT)

    def as_float(self):
        return ConvertExpression(self, dt.FLOAT)

    def as_str(self):
        return ConvertExpression(self, dt.STR)

    def as_bool(self):
        return ConvertExpression(self, dt.BOOL)

    def to_string(self):
        return MethodCallExpression("to_string", self)

    def fill_error(self, replacement) -> "ColumnExpression":
        return FillErrorExpression(self, replacement)

    # namespaces
    @property
    def dt(self):
        from pathway_tpu_torch.internals.expressions.date_time import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self):
        from pathway_tpu_torch.internals.expressions.string import StringNamespace

        return StringNamespace(self)

    @property
    def num(self):
        from pathway_tpu_torch.internals.expressions.numerical import NumericalNamespace

        return NumericalNamespace(self)

    # -- internals ---------------------------------------------------------
    @property
    def _deps(self) -> tuple["ColumnExpression", ...]:
        return ()

    def _to_internal(self) -> "ColumnExpression":
        return self

    def __repr__(self):
        from pathway_tpu_torch.internals.expression_printer import print_expression

        return print_expression(self)


ExpressionLike = Any


def wrap_arg(arg: ExpressionLike) -> ColumnExpression:
    if isinstance(arg, ColumnExpression):
        return arg
    if isinstance(arg, ColumnNamespace):
        raise TypeError("namespace is not an expression")
    return ConstExpression(arg)


class ColumnNamespace:
    pass


class ConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        self._value = value


class ColumnReference(ColumnExpression):
    """``table.colname`` / ``pw.this.colname``."""

    def __init__(self, table, name: str):
        self._table = table
        self._name = name

    @property
    def table(self):
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def __call__(self, *args, **kwargs):
        raise TypeError(f"column {self._name!r} is not callable")


class IdExpression(ColumnReference):
    """``table.id`` — the key column."""

    def __init__(self, table):
        super().__init__(table, "id")


class BinaryExpression(ColumnExpression):
    def __init__(self, op: str, left: ExpressionLike, right: ExpressionLike):
        self._op = op
        self._left = wrap_arg(left)
        self._right = wrap_arg(right)

    @property
    def _deps(self):
        return (self._left, self._right)


class UnaryExpression(ColumnExpression):
    def __init__(self, op: str, arg: ExpressionLike):
        self._op = op
        self._arg = wrap_arg(arg)

    @property
    def _deps(self):
        return (self._arg,)


class IsNoneExpression(ColumnExpression):
    def __init__(self, arg):
        self._arg = wrap_arg(arg)

    @property
    def _deps(self):
        return (self._arg,)


class IsNotNoneExpression(ColumnExpression):
    def __init__(self, arg):
        self._arg = wrap_arg(arg)

    @property
    def _deps(self):
        return (self._arg,)


class IfElseExpression(ColumnExpression):
    def __init__(self, if_, then, else_):
        self._if = wrap_arg(if_)
        self._then = wrap_arg(then)
        self._else = wrap_arg(else_)

    @property
    def _deps(self):
        return (self._if, self._then, self._else)


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args):
        self._args = tuple(wrap_arg(a) for a in args)

    @property
    def _deps(self):
        return self._args


class RequireExpression(ColumnExpression):
    """pw.require(val, *deps): val if all deps non-None else None."""

    def __init__(self, val, *args):
        self._val = wrap_arg(val)
        self._args = tuple(wrap_arg(a) for a in args)

    @property
    def _deps(self):
        return (self._val, *self._args)


class CastExpression(ColumnExpression):
    def __init__(self, return_type, expr):
        self._return_type = dt.wrap(return_type)
        self._expr = wrap_arg(expr)

    @property
    def _deps(self):
        return (self._expr,)


class ConvertExpression(ColumnExpression):
    """Runtime conversion (as_int/as_float/…, JSON unpacking)."""

    def __init__(self, expr, return_type, unwrap: bool = False):
        self._expr = wrap_arg(expr)
        self._return_type = dt.wrap(return_type)
        self._unwrap = unwrap

    @property
    def _deps(self):
        return (self._expr,)


class DeclareTypeExpression(ColumnExpression):
    def __init__(self, return_type, expr):
        self._return_type = dt.wrap(return_type)
        self._expr = wrap_arg(expr)

    @property
    def _deps(self):
        return (self._expr,)


class UnwrapExpression(ColumnExpression):
    def __init__(self, expr):
        self._expr = wrap_arg(expr)

    @property
    def _deps(self):
        return (self._expr,)


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr, replacement):
        self._expr = wrap_arg(expr)
        self._replacement = wrap_arg(replacement)

    @property
    def _deps(self):
        return (self._expr, self._replacement)


class ApplyExpression(ColumnExpression):
    """Python UDF call — compiled to one *batched* host dispatch per delta."""

    def __init__(self, fn: Callable, return_type: Any, *args,
                 propagate_none: bool = False, deterministic: bool = True,
                 max_batch_size: int | None = None,
                 batch: bool = False, device: bool = False, **kwargs):
        self._fn = fn
        self._return_type = dt.wrap(return_type)
        self._args = tuple(wrap_arg(a) for a in args)
        self._kwargs = {k: wrap_arg(v) for k, v in kwargs.items()}
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._max_batch_size = max_batch_size
        # batch=True → fn receives whole columns (lists) and returns a list:
        # the columnar dispatch path for device/vectorized UDFs
        self._batch = batch
        # device=True (batch only) → the fn dispatches accelerator work;
        # the hosting operator is marked device_bound (it runs in the
        # tick's device leg)
        self._device = device and batch

    @property
    def _deps(self):
        return (*self._args, *self._kwargs.values())


class AsyncApplyExpression(ApplyExpression):
    """Async UDF — all rows of a batch awaited concurrently on one event
    loop (reference: async_apply_table, dataflow.rs:1454)."""


class FullyAsyncApplyExpression(ApplyExpression):
    """Non-blocking async UDF producing a Future column (pw.udf(executor=
    fully_async_executor)). Results arrive at later engine times."""

    def __init__(self, fn, return_type, *args, autocommit_duration_ms=1500, **kw):
        super().__init__(fn, return_type, *args, **kw)
        self._autocommit_duration_ms = autocommit_duration_ms


class ReducerExpression(ColumnExpression):
    """A reducer call inside ``groupby().reduce()`` (``pw.reducers.*``);
    the groupby lowering splits it out of the output expressions."""

    def __init__(self, name: str, *args, **kwargs):
        self._name = name
        self._args = tuple(wrap_arg(a) for a in args)
        self._kwargs = kwargs

    @property
    def _deps(self):
        return self._args


class MethodCallExpression(ColumnExpression):
    """Namespace method (dt/str/num) — maps to a columnar kernel."""

    def __init__(self, method: str, *args, **kwargs):
        self._method = method
        self._args = tuple(wrap_arg(a) for a in args)
        self._kwargs = kwargs

    @property
    def _deps(self):
        return self._args


class PointerExpression(ColumnExpression):
    """pw.this.pointer_from(*args) — derive a key from values
    (reference: Expressions::PointerFrom + ShardPolicy.LastKeyColumn)."""

    def __init__(self, table, *args, optional: bool = False, instance=None):
        self._table = table
        self._args = tuple(wrap_arg(a) for a in args)
        self._optional = optional
        self._instance = wrap_arg(instance) if instance is not None else None

    @property
    def _deps(self):
        extra = (self._instance,) if self._instance is not None else ()
        return (*self._args, *extra)


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args):
        self._args = tuple(wrap_arg(a) for a in args)

    @property
    def _deps(self):
        return self._args


class GetExpression(ColumnExpression):
    def __init__(self, obj, index, default=None, check_if_exists=True):
        self._obj = wrap_arg(obj)
        self._index = wrap_arg(index)
        self._default = wrap_arg(default)
        self._check_if_exists = check_if_exists

    @property
    def _deps(self):
        return (self._obj, self._index, self._default)


# ---------------------------------------------------------------------------
# public helper constructors (pw.* level)
# ---------------------------------------------------------------------------

def if_else(if_: ExpressionLike, then: ExpressionLike, else_: ExpressionLike):
    return IfElseExpression(if_, then, else_)


def coalesce(*args: ExpressionLike):
    return CoalesceExpression(*args)


def require(val, *deps):
    return RequireExpression(val, *deps)


def cast(target_type, expr):
    return CastExpression(target_type, expr)


def declare_type(target_type, expr):
    return DeclareTypeExpression(target_type, expr)


def unwrap(expr):
    return UnwrapExpression(expr)


def fill_error(expr, replacement):
    return FillErrorExpression(expr, replacement)


def make_tuple(*args):
    return MakeTupleExpression(*args)


def apply(fn, *args, **kwargs):
    return ApplyExpression(fn, dt.ANY, *args, **kwargs)


def apply_with_type(fn, ret_type, *args, **kwargs):
    return ApplyExpression(fn, ret_type, *args, **kwargs)


def apply_async(fn, *args, **kwargs):
    return AsyncApplyExpression(fn, dt.ANY, *args, **kwargs)
