"""Best-effort static dtype inference for expressions — port of
pathway_tpu/internals/type_inference.py: enough to give result schemas
correct dtypes for the common cases, degrading to ANY instead of raising
when unsure.
"""

from __future__ import annotations

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex

_CMP = {"==", "!=", "<", "<=", ">", ">="}
_BOOL = {"&", "|", "^"}

_REDUCER_TYPES = {
    "count": lambda args: dt.INT,
    "sum": lambda args: args[0] if args else dt.INT,
    "int_sum": lambda args: dt.INT,
    "float_sum": lambda args: dt.FLOAT,
    "array_sum": lambda args: dt.ANY_ARRAY,
    "avg": lambda args: dt.FLOAT,
    "min": lambda args: args[0] if args else dt.ANY,
    "max": lambda args: args[0] if args else dt.ANY,
    # one arg: the best row's KEY; two args: the payload expression's value
    "argmin": lambda args: args[1] if len(args) > 1 else dt.POINTER,
    "argmax": lambda args: args[1] if len(args) > 1 else dt.POINTER,
    "unique": lambda args: args[0] if args else dt.ANY,
    "any": lambda args: args[0] if args else dt.ANY,
    "sorted_tuple": lambda args: dt.List(args[0]) if args else dt.ANY_TUPLE,
    "tuple": lambda args: dt.List(args[0]) if args else dt.ANY_TUPLE,
    "ndarray": lambda args: dt.ANY_ARRAY,
    "earliest": lambda args: args[0] if args else dt.ANY,
    "latest": lambda args: args[0] if args else dt.ANY,
    "stateful": lambda args: dt.ANY,
}

_METHOD_TYPES = {
    "to_string": dt.STR,
    "num.abs": None,  # same as arg
    "num.round": None,
    "num.fill_na": None,
    "str.len": dt.INT,
    "str.count": dt.INT,
    "str.find": dt.INT,
    "str.rfind": dt.INT,
    "str.startswith": dt.BOOL,
    "str.endswith": dt.BOOL,
    "str.parse_int": dt.INT,
    "str.parse_float": dt.FLOAT,
    "str.parse_bool": dt.BOOL,
    "str.split": dt.List(dt.STR),
    "str.rsplit": dt.List(dt.STR),
    "dt.strftime": dt.STR,
    "dt.strptime": dt.DATE_TIME_NAIVE,
    "dt.timestamp": dt.INT,
    "dt.from_timestamp": dt.DATE_TIME_NAIVE,
    "dt.utc_from_timestamp": dt.DATE_TIME_UTC,
    "dt.to_utc": dt.DATE_TIME_UTC,
    "dt.to_naive_in_timezone": dt.DATE_TIME_NAIVE,
}
for _m in ("nanosecond", "microsecond", "millisecond", "second", "minute",
           "hour", "day", "month", "year", "weekday", "nanoseconds",
           "microseconds", "milliseconds", "seconds", "minutes", "hours",
           "days", "weeks"):
    _METHOD_TYPES[f"dt.{_m}"] = dt.INT
for _m in ("lower", "upper", "reversed", "strip", "lstrip", "rstrip",
           "swapcase", "title", "capitalize", "casefold", "removeprefix",
           "removesuffix", "replace", "slice"):
    _METHOD_TYPES[f"str.{_m}"] = dt.STR


def infer_dtype(expr: ex.ColumnExpression) -> dt.DType:
    try:
        return _infer(expr)
    except Exception:
        return dt.ANY


def _infer(expr: ex.ColumnExpression) -> dt.DType:
    if isinstance(expr, ex.IdExpression):
        return dt.POINTER
    if isinstance(expr, ex.ColumnReference):
        table = expr.table
        schema = getattr(table, "schema", None)
        if schema is not None:
            try:
                return schema[expr.name].dtype
            except KeyError:
                return dt.ANY
        return dt.ANY
    if isinstance(expr, ex.ConstExpression):
        return dt.wrap(type(expr._value)) if expr._value is not None else dt.NONE
    if isinstance(expr, ex.BinaryExpression):
        if expr._op in _CMP:
            return dt.BOOL
        lt, rt = _infer(expr._left), _infer(expr._right)
        if expr._op in _BOOL:
            return dt.BOOL if lt is dt.BOOL or rt is dt.BOOL else dt.types_lca(lt, rt)
        if expr._op == "/":
            if dt.unoptionalize(lt) in (dt.INT, dt.FLOAT):
                return dt.FLOAT
            return dt.types_lca(lt, rt)
        if expr._op == "-" and {dt.unoptionalize(lt), dt.unoptionalize(rt)} <= {
                dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC}:
            return dt.DURATION
        if expr._op == "@":
            return dt.ANY_ARRAY
        return dt.types_lca(lt, rt)
    if isinstance(expr, ex.UnaryExpression):
        return _infer(expr._arg)
    if isinstance(expr, (ex.IsNoneExpression, ex.IsNotNoneExpression)):
        return dt.BOOL
    if isinstance(expr, ex.IfElseExpression):
        return dt.types_lca(_infer(expr._then), _infer(expr._else))
    if isinstance(expr, ex.CoalesceExpression):
        out = dt.NONE
        for a in expr._args:
            out = dt.types_lca(out, _infer(a))
        for a in expr._args:
            if not dt.is_optional(_infer(a)):
                return dt.unoptionalize(out)
        return out
    if isinstance(expr, ex.RequireExpression):
        return dt.Optional(dt.unoptionalize(_infer(expr._val)))
    if isinstance(expr, (ex.CastExpression, ex.ConvertExpression,
                         ex.DeclareTypeExpression)):
        return expr._return_type
    if isinstance(expr, ex.UnwrapExpression):
        return dt.unoptionalize(_infer(expr._expr))
    if isinstance(expr, ex.FillErrorExpression):
        return dt.types_lca(_infer(expr._expr), _infer(expr._replacement))
    if isinstance(expr, ex.ApplyExpression):
        return expr._return_type
    if isinstance(expr, ex.ReducerExpression):
        arg_types = [_infer(a) for a in expr._args]
        fn = _REDUCER_TYPES.get(expr._name)
        return fn(arg_types) if fn else dt.ANY
    if isinstance(expr, ex.MethodCallExpression):
        t = _METHOD_TYPES.get(expr._method, dt.ANY)
        if t is None:
            return _infer(expr._args[0])
        return t
    if isinstance(expr, ex.PointerExpression):
        return dt.POINTER
    if isinstance(expr, ex.MakeTupleExpression):
        return dt.Tuple(*[_infer(a) for a in expr._args])
    if isinstance(expr, ex.GetExpression):
        obj_t = dt.unoptionalize(_infer(expr._obj))
        if obj_t is dt.JSON:
            return dt.JSON
        if isinstance(obj_t, dt.Tuple) and isinstance(expr._index, ex.ConstExpression):
            i = expr._index._value
            if isinstance(i, int) and -len(obj_t.args) <= i < len(obj_t.args):
                return obj_t.args[i]
        if isinstance(obj_t, dt.List):
            return obj_t.wrapped
        return dt.ANY
    return dt.ANY
