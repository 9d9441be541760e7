"""Generic expression tree transformation — port of
pathway_tpu/internals/expression_utils.py."""

from __future__ import annotations

from typing import Callable, Optional

from pathway_tpu_torch.internals import expression as ex


def map_expression(expr, mapper: Callable[[ex.ColumnExpression], Optional[ex.ColumnExpression]]):
    """Bottom-up-less rewrite: mapper(e) returns a replacement or None to
    recurse into children."""
    if not isinstance(expr, ex.ColumnExpression):
        return expr
    replacement = mapper(expr)
    if replacement is not None:
        return replacement
    if not expr._deps:
        return expr
    new = object.__new__(type(expr))
    new.__dict__ = dict(expr.__dict__)
    for attr, val in list(new.__dict__.items()):
        if isinstance(val, ex.ColumnExpression):
            new.__dict__[attr] = map_expression(val, mapper)
        elif isinstance(val, tuple) and any(isinstance(v, ex.ColumnExpression) for v in val):
            new.__dict__[attr] = tuple(
                map_expression(v, mapper) if isinstance(v, ex.ColumnExpression) else v
                for v in val
            )
        elif isinstance(val, dict) and any(
            isinstance(v, ex.ColumnExpression) for v in val.values()
        ):
            new.__dict__[attr] = {
                k: map_expression(v, mapper) if isinstance(v, ex.ColumnExpression) else v
                for k, v in val.items()
            }
    return new

