"""GroupedTable.reduce — port of pathway_tpu/internals/groupbys.py (the
reference: python/pathway/internals/groupbys.py).

Reducer expressions inside ``reduce(...)`` are split out; the engine
GroupByOperator maintains incremental per-group reducer state; compound
expressions around reducers become a post-map over (group values, reduced
values) rows.
"""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.expression_utils import map_expression
from pathway_tpu_torch.internals.table import Plan, Table
from pathway_tpu_torch.internals.type_inference import infer_dtype
from pathway_tpu_torch.internals.universe import Universe


class GroupedTable:
    def __init__(self, table: Table, by: list[ex.ColumnExpression], *,
                 instance=None, sort_by=None, by_id: bool = False):
        self._table = table
        self._by = by
        self._instance = instance
        self._sort_by = sort_by
        self._by_id = by_id

    def reduce(self, *args, **kwargs) -> Table:
        table = self._table
        out: dict[str, ex.ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, ex.ColumnReference):
                out[arg.name] = thisclass.resolve_this({"this": table}, arg)
            elif isinstance(arg, thisclass.ThisRef):
                for b in self._by:
                    if isinstance(b, ex.ColumnReference):
                        out[b.name] = b
            else:
                raise TypeError(f"positional reduce arg must be a column: {arg!r}")
        for name, e in kwargs.items():
            out[name] = thisclass.resolve_this({"this": table}, ex.wrap_arg(e))

        schema = sch.schema_from_columns({
            name: sch.ColumnSchema(name=name, dtype=infer_dtype(e))
            for name, e in out.items()
        })
        plan = Plan(
            "groupby",
            base=table,
            by=self._by,
            instance=self._instance,
            out_names=list(out.keys()),
            out_exprs=list(out.values()),
            sort_by=self._sort_by,
            by_id=self._by_id,
        )
        return Table(plan, schema, Universe())


def split_reducers(out_exprs: list[ex.ColumnExpression], by_exprs, instance,
                   proxy: object):
    """Rewrite output expressions over the grouped row space.

    Returns (rewritten_exprs, reducer_nodes) where the rewritten expressions
    reference the synthetic `proxy` table with columns
    ``__g{i}`` (grouping values) then ``__r{j}`` (reducer results).
    """
    by_keys = {}
    for i, b in enumerate(by_exprs):
        if isinstance(b, ex.ColumnReference):
            by_keys[(id(b.table), b.name)] = i
    if instance is not None and isinstance(instance, ex.ColumnReference):
        by_keys.setdefault((id(instance.table), instance.name), len(by_exprs))

    reducers: list[ex.ReducerExpression] = []

    def mapper(e):
        if isinstance(e, ex.ReducerExpression):
            for j, r in enumerate(reducers):
                if r is e:
                    return ex.ColumnReference(proxy, f"__r{j}")
            reducers.append(e)
            return ex.ColumnReference(proxy, f"__r{len(reducers) - 1}")
        if isinstance(e, ex.IdExpression):
            # id of the grouped row
            return ex.IdExpression(proxy)
        if isinstance(e, ex.ColumnReference):
            key = (id(e.table), e.name)
            if key in by_keys:
                return ex.ColumnReference(proxy, f"__g{by_keys[key]}")
            if e.table is proxy:
                return e
            raise KeyError(
                f"column {e.name!r} is neither a groupby key nor inside a reducer"
            )
        return None

    rewritten = [map_expression(e, mapper) for e in out_exprs]
    return rewritten, reducers
