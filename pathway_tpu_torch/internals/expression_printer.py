"""Readable reprs for expressions — port of
pathway_tpu/internals/expression_printer.py."""

from __future__ import annotations


def print_expression(expr) -> str:
    from pathway_tpu_torch.internals import expression as ex

    if isinstance(expr, ex.IdExpression):
        return f"{_tab(expr.table)}.id"
    if isinstance(expr, ex.ColumnReference):
        return f"{_tab(expr.table)}.{expr.name}"
    if isinstance(expr, ex.ConstExpression):
        return repr(expr._value)
    if isinstance(expr, ex.BinaryExpression):
        return f"({print_expression(expr._left)} {expr._op} {print_expression(expr._right)})"
    if isinstance(expr, ex.UnaryExpression):
        return f"({expr._op}{print_expression(expr._arg)})"
    if isinstance(expr, ex.IfElseExpression):
        return (f"if_else({print_expression(expr._if)}, "
                f"{print_expression(expr._then)}, {print_expression(expr._else)})")
    if isinstance(expr, ex.CoalesceExpression):
        return f"coalesce({', '.join(print_expression(a) for a in expr._args)})"
    if isinstance(expr, ex.ApplyExpression):
        fname = getattr(expr._fn, "__name__", "fn")
        return f"apply({fname}, {', '.join(print_expression(a) for a in expr._args)})"
    if isinstance(expr, ex.ReducerExpression):
        return f"reducers.{expr._name}({', '.join(print_expression(a) for a in expr._args)})"
    if isinstance(expr, ex.MethodCallExpression):
        args = ", ".join(print_expression(a) for a in expr._args[1:])
        return f"{print_expression(expr._args[0])}.{expr._method}({args})"
    if isinstance(expr, ex.CastExpression):
        return f"cast({expr._return_type!r}, {print_expression(expr._expr)})"
    if isinstance(expr, ex.MakeTupleExpression):
        return f"make_tuple({', '.join(print_expression(a) for a in expr._args)})"
    if isinstance(expr, ex.PointerExpression):
        return f"pointer_from({', '.join(print_expression(a) for a in expr._args)})"
    return f"<{type(expr).__name__}>"


def _tab(table) -> str:
    from pathway_tpu_torch.internals.thisclass import ThisRef

    if isinstance(table, ThisRef):
        return f"pw.{table._kind}"
    name = getattr(table, "_name", None)
    return name or "<table>"
