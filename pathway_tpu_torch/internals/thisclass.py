"""`pw.this`, `pw.left`, `pw.right` deferred references — port of
pathway_tpu/internals/thisclass.py."""

from __future__ import annotations

from pathway_tpu_torch.internals.expression import (
    ColumnReference,
    IdExpression,
    PointerExpression,
)


class ThisRef:
    """Placeholder table; resolved against a concrete table at use site."""

    def __init__(self, kind: str = "this"):
        self._kind = kind

    @property
    def id(self):
        return IdExpression(self)

    def __getattr__(self, name: str):
        if name.startswith("__") or name == "_kind":
            raise AttributeError(name)
        return ColumnReference(self, name)

    def __getitem__(self, name):
        if isinstance(name, (list, tuple)):
            return [self[n] for n in name]
        if isinstance(name, ColumnReference):
            return ColumnReference(self, name.name)
        return ColumnReference(self, name)

    def pointer_from(self, *args, optional=False, instance=None):
        return PointerExpression(self, *args, optional=optional, instance=instance)

    def without(self, *cols):
        return ThisWithout(self, cols)

    def __iter__(self):
        raise TypeError(f"pw.{self._kind} is not iterable")

    def __repr__(self):
        return f"<pw.{self._kind}>"


class ThisWithout(ThisRef):
    def __init__(self, base, cols):
        super().__init__(getattr(base, "_kind", "this"))
        self._base = base
        self._cols = tuple(
            c.name if isinstance(c, ColumnReference) else c for c in cols
        )


this = ThisRef("this")
left = ThisRef("left")
right = ThisRef("right")


def resolve_this(kind_map: dict, expr):
    """Substitute ThisRef tables inside an expression with real tables.

    kind_map: {"this": table} or {"left": t1, "right": t2, "this": joined}.
    """
    from pathway_tpu_torch.internals import expression as ex

    if isinstance(expr, ex.ColumnReference):
        tab = expr.table
        if isinstance(tab, ThisRef):
            target = kind_map.get(tab._kind)
            if target is None:
                raise ValueError(f"pw.{tab._kind} cannot be used here")
            if isinstance(expr, ex.IdExpression):
                return ex.IdExpression(target)
            return target[expr.name]
        return expr
    if isinstance(expr, ex.PointerExpression) and isinstance(expr._table, ThisRef):
        target = kind_map.get(expr._table._kind)
        new = object.__new__(ex.PointerExpression)
        new.__dict__ = dict(expr.__dict__)
        new._table = target
        new._args = tuple(resolve_this(kind_map, a) for a in expr._args)
        if expr._instance is not None:
            new._instance = resolve_this(kind_map, expr._instance)
        return new
    # generic: rebuild children
    return _rebuild(kind_map, expr)


def _rebuild(kind_map, expr):
    from pathway_tpu_torch.internals import expression as ex

    if not isinstance(expr, ex.ColumnExpression):
        return expr
    deps = expr._deps
    if not deps:
        return expr
    new = object.__new__(type(expr))
    new.__dict__ = dict(expr.__dict__)
    for attr, val in list(new.__dict__.items()):
        if isinstance(val, ex.ColumnExpression):
            new.__dict__[attr] = resolve_this(kind_map, val)
        elif isinstance(val, tuple) and any(
            isinstance(v, ex.ColumnExpression) for v in val
        ):
            new.__dict__[attr] = tuple(
                resolve_this(kind_map, v) if isinstance(v, ex.ColumnExpression) else v
                for v in val
            )
        elif isinstance(val, dict) and any(
            isinstance(v, ex.ColumnExpression) for v in val.values()
        ):
            new.__dict__[attr] = {
                k: resolve_this(kind_map, v) if isinstance(v, ex.ColumnExpression) else v
                for k, v in val.items()
            }
    return new
