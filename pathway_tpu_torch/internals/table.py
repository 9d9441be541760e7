"""The Table DSL — port of pathway_tpu/internals/table.py, trimmed to the
batch path's operations.

A Table is pure metadata: a plan node + schema + universe; nothing computes
until a GraphRunner (internals/runner.py) lowers and runs it. Ported:
select / with_columns / without / rename* / filter / remove_errors /
flatten / concat / concat_reindex / update_rows / update_cells (``<<``) /
with_id / with_id_from / pointer_from / groupby / reduce / deduplicate /
ix / ix_ref / cast_to_types / update_types / debug, the universe promises
and ``_external_index_as_of_now`` (the plan DataIndex queries build).
Every other Table method of the JAX package raises
``NotImplementedError`` naming the ROADMAP item that brings it
(``_UNPORTED`` below).
"""

from __future__ import annotations

import itertools
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.trace import trace_user_frame
from pathway_tpu_torch.internals.type_inference import infer_dtype
from pathway_tpu_torch.internals.universe import Universe

_table_ids = itertools.count()


class Plan:
    """One logical operator producing a keyed table."""

    __slots__ = ("kind", "params", "trace")

    def __init__(self, kind: str, **params):
        self.kind = kind
        self.params = params
        self.trace = trace_user_frame()

    def __repr__(self):
        return f"<Plan {self.kind}>"


class Table:
    def __init__(self, plan: Plan, schema: type[sch.Schema],
                 universe: Universe | None = None, name: str = ""):
        self._plan = plan
        self._schema = schema
        self._universe = universe or Universe()
        self._name = name or f"table_{next(_table_ids)}"
        self._id_dtype = dt.POINTER

    # ------------------------------------------------------------------
    # metadata
    # ------------------------------------------------------------------
    @property
    def schema(self) -> type[sch.Schema]:
        return self._schema

    @property
    def id(self) -> ex.ColumnExpression:
        return ex.IdExpression(self)

    def column_names(self) -> list[str]:
        return self._schema.column_names()

    _column_names = column_names

    def typehints(self):
        return self._schema.typehints()

    def keys(self):
        return self.column_names()

    @property
    def C(self) -> "_ColumnNamespaceProxy":
        return _ColumnNamespaceProxy(self)

    def __getattr__(self, name: str) -> ex.ColumnReference:
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            schema = object.__getattribute__(self, "_schema")
        except AttributeError:
            raise AttributeError(name) from None
        if name in schema.column_names():
            return ex.ColumnReference(self, name)
        raise AttributeError(
            f"table has no column {name!r}; columns: {schema.column_names()}"
        )

    def __getitem__(self, name) -> Any:
        if isinstance(name, (list, tuple)):
            return [self[n] for n in name]
        if isinstance(name, ex.ColumnReference):
            name = name.name
        if name == "id":
            return self.id
        if name not in self._schema.column_names():
            raise KeyError(name)
        return ex.ColumnReference(self, name)

    def __iter__(self):
        raise TypeError("Table is not iterable; use pw.debug helpers")

    def __repr__(self):
        return f"<pw.Table {self._name} {self._schema.column_names()}>"

    # ------------------------------------------------------------------
    # expression plumbing
    # ------------------------------------------------------------------
    def _resolve(self, expr):
        return thisclass.resolve_this({"this": self}, expr)

    def _select_args_to_exprs(self, args, kwargs) -> dict[str, ex.ColumnExpression]:
        out: dict[str, ex.ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, thisclass.ThisWithout):
                excluded = set(arg._cols)
                for n in self.column_names():
                    if n not in excluded:
                        out[n] = self[n]
            elif isinstance(arg, thisclass.ThisRef):
                for n in self.column_names():
                    out[n] = self[n]
            elif isinstance(arg, ex.ColumnReference):
                resolved = self._resolve(arg)
                out[arg.name] = resolved
            elif isinstance(arg, Table):
                for n in arg.column_names():
                    out[n] = arg[n]
            elif hasattr(arg, "_to_column_mapping"):  # TableSlice
                out.update(arg._to_column_mapping())
            else:
                raise TypeError(f"positional select arg must be a column: {arg!r}")
        for name, e in kwargs.items():
            out[name] = self._resolve(ex.wrap_arg(e))
        return out

    def _result_schema(self, exprs: dict[str, ex.ColumnExpression]):
        cols = {
            name: sch.ColumnSchema(name=name, dtype=infer_dtype(e))
            for name, e in exprs.items()
        }
        return sch.schema_from_columns(cols)

    # ------------------------------------------------------------------
    # projection & mutation
    # ------------------------------------------------------------------
    def select(self, *args, **kwargs) -> "Table":
        """Project/compute columns (reference: Table.select, table.py).

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown(\'\'\'
        ... name  | qty
        ... bolt  | 3
        ... screw | 5
        ... \'\'\')
        >>> pw.debug.compute_and_print(
        ...     t.select(t.name, double=t.qty * 2), include_id=False)
        name | double
        bolt | 6
        screw | 10
        """
        exprs = self._select_args_to_exprs(args, kwargs)
        schema = self._result_schema(exprs)
        plan = Plan("map", base=self, exprs=list(exprs.values()),
                    names=list(exprs.keys()))
        return Table(plan, schema, self._universe)

    def debug(self, name: str) -> "Table":
        """Print this table's final state during pw.run (reference:
        table.py Table.debug → DebugOperator)."""
        def binder(runner):
            def callback(time, delta):
                for key, row, diff in delta.entries:
                    print(f"[debug {name}] t={time} diff={diff} "
                          f"{dict(zip(self.column_names(), row))}")

            runner.subscribe(self, callback)

        G.add_output(binder, table=self, sink="debug")
        return self

    def eval_type(self, expression):
        """dtype of an expression evaluated in this table's row context
        (reference: table.py:2510)."""
        return infer_dtype(self._resolve(ex.wrap_arg(expression)))

    def remove_errors(self) -> "Table":
        """Filter out rows containing ERROR values (reference:
        table.py:2452)."""
        from pathway_tpu_torch.internals.error import is_error

        def no_errors(keys, rows):
            return [not any(is_error(v) for v in r) for r in rows]

        plan = Plan("filter_raw", base=self, pred_fn=no_errors)
        return Table(plan, self.schema, self._universe.subuniverse())

    def with_columns(self, *args, **kwargs) -> "Table":
        new = self._select_args_to_exprs(args, kwargs)
        exprs = {n: self[n] for n in self.column_names()}
        exprs.update(new)
        schema = self._result_schema(exprs)
        plan = Plan("map", base=self, exprs=list(exprs.values()),
                    names=list(exprs.keys()))
        return Table(plan, schema, self._universe)

    def without(self, *columns) -> "Table":
        names = {c.name if isinstance(c, ex.ColumnReference) else c for c in columns}
        keep = [n for n in self.column_names() if n not in names]
        return self.select(*[self[n] for n in keep])

    def rename(self, names_mapping: dict | None = None, **kwargs) -> "Table":
        if names_mapping:
            return self.rename_by_dict(names_mapping)
        return self.rename_columns(**kwargs)

    def rename_columns(self, **kwargs) -> "Table":
        # kwargs: new_name=old_column
        mapping = {}
        for new_name, old in kwargs.items():
            old_name = old.name if isinstance(old, ex.ColumnReference) else old
            mapping[old_name] = new_name
        return self.rename_by_dict(mapping)

    def rename_by_dict(self, names_mapping: dict) -> "Table":
        mapping = {
            (k.name if isinstance(k, ex.ColumnReference) else k):
            (v.name if isinstance(v, ex.ColumnReference) else v)
            for k, v in names_mapping.items()
        }
        exprs = {}
        for n in self.column_names():
            exprs[mapping.get(n, n)] = self[n]
        return self.select(**exprs)

    def with_prefix(self, prefix: str) -> "Table":
        return self.rename_by_dict({n: prefix + n for n in self.column_names()})

    def with_suffix(self, suffix: str) -> "Table":
        return self.rename_by_dict({n: n + suffix for n in self.column_names()})

    def cast_to_types(self, **kwargs) -> "Table":
        exprs = {n: self[n] for n in self.column_names()}
        for name, target in kwargs.items():
            exprs[name] = ex.CastExpression(target, self[name])
        return self.select(**exprs)

    def update_types(self, **kwargs) -> "Table":
        schema = self._schema.with_types(**kwargs)
        t = Table(Plan("identity", base=self), schema, self._universe)
        return t

    # ------------------------------------------------------------------
    # filtering / universe ops
    # ------------------------------------------------------------------
    def filter(self, filter_expression) -> "Table":
        """Keep rows where the predicate holds.

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown(\'\'\'
        ... name  | qty
        ... bolt  | 3
        ... screw | 5
        ... nut   | 9
        ... \'\'\')
        >>> pw.debug.compute_and_print(t.filter(t.qty > 4), include_id=False)
        name | qty
        nut | 9
        screw | 5
        """
        pred = self._resolve(ex.wrap_arg(filter_expression))
        plan = Plan("filter", base=self, pred=pred)
        return Table(plan, self._schema, self._universe.subuniverse())

    def split(self, split_expression) -> tuple["Table", "Table"]:
        pred = self._resolve(ex.wrap_arg(split_expression))
        return self.filter(pred), self.filter(~ex.wrap_arg(pred))

    def copy(self) -> "Table":
        return Table(Plan("identity", base=self), self._schema, self._universe)

    def with_universe_of(self, other: "Table") -> "Table":
        # universe_from lets the static analyzer (PWT007) tell this apart
        # from copy()/update_types() identity plans
        t = Table(Plan("identity", base=self, universe_from=other),
                  self._schema, other._universe)
        return t

    def promise_universes_are_disjoint(self, other: "Table") -> "Table":
        self._universe.promise_is_disjoint_from(other._universe)
        return self

    def promise_universes_are_equal(self, other: "Table") -> "Table":
        self._universe.promise_is_subset_of(other._universe)
        other._universe.promise_is_subset_of(self._universe)
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        self._universe.promise_is_subset_of(other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        return self.promise_universes_are_equal(other)

    def is_subset_of(self, other: "Table") -> bool:
        return self._universe.is_subset_of(other._universe)

    # ------------------------------------------------------------------
    # keys / reindex
    # ------------------------------------------------------------------
    def with_id(self, new_index: ex.ColumnExpression) -> "Table":
        expr = self._resolve(ex.wrap_arg(new_index))
        plan = Plan("reindex", base=self, key_exprs=[expr], raw=True)
        return Table(plan, self._schema, Universe())

    def with_id_from(self, *args, instance=None) -> "Table":
        exprs = [self._resolve(ex.wrap_arg(a)) for a in args]
        if instance is not None:
            exprs.append(self._resolve(ex.wrap_arg(instance)))
        plan = Plan("reindex", base=self, key_exprs=exprs, raw=False)
        return Table(plan, self._schema, Universe())

    def pointer_from(self, *args, optional=False, instance=None):
        return ex.PointerExpression(self, *args, optional=optional, instance=instance)

    # ------------------------------------------------------------------
    # groupby / reduce / dedup
    # ------------------------------------------------------------------
    def groupby(self, *args, id=None, sort_by=None, instance=None,
                **kwargs):
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        by = [self._resolve(ex.wrap_arg(a)) for a in args]
        if id is not None:
            by = [self._resolve(ex.wrap_arg(id))]
        inst = self._resolve(ex.wrap_arg(instance)) if instance is not None else None
        return GroupedTable(self, by, instance=inst, sort_by=sort_by, by_id=id is not None)

    def reduce(self, *args, **kwargs) -> "Table":
        return self.groupby().reduce(*args, **kwargs)

    def deduplicate(self, *, value=None, instance=None, acceptor=None, name=None,
                    persistent_id=None) -> "Table":
        """Keep one accepted value per instance; by default a new distinct
        value replaces the old one (reference: pw.Table.deduplicate).

        >>> import pathway_tpu_torch as pw
        >>> s = pw.debug.table_from_markdown(\'\'\'
        ... sensor | reading | _time
        ... a      | 5       | 2
        ... a      | 5       | 4
        ... a      | 8       | 6
        ... \'\'\')
        >>> pw.debug.compute_and_print(s.deduplicate(value=s.reading),
        ...                            include_id=False)
        sensor | reading
        a | 8
        """
        value_e = self._resolve(ex.wrap_arg(value)) if value is not None else None
        inst_e = self._resolve(ex.wrap_arg(instance)) if instance is not None else None
        if acceptor is None:
            acceptor = lambda new, old: new != old
        plan = Plan("dedupe", base=self, value=value_e, instance=inst_e,
                    acceptor=acceptor)
        return Table(plan, self._schema, Universe())

    # ------------------------------------------------------------------
    # set ops / combination
    # ------------------------------------------------------------------
    def concat(self, *others: "Table") -> "Table":
        tables = [self, *others]
        schema = _common_schema(tables)
        plan = Plan("concat", tables=tables, update=False)
        out = Table(plan, schema, Universe())
        for t in tables:  # union: every input is a subset of the result
            t._universe.promise_is_subset_of(out._universe)
        return out

    def concat_reindex(self, *others: "Table") -> "Table":
        tables = [self, *others]
        schema = _common_schema(tables)
        plan = Plan("concat_reindex", tables=tables)
        return Table(plan, schema, Universe())

    def update_rows(self, other: "Table") -> "Table":
        schema = _common_schema([self, other], update=True)
        plan = Plan("concat", tables=[self, other], update=True)
        out = Table(plan, schema, Universe())
        self._universe.promise_is_subset_of(out._universe)
        other._universe.promise_is_subset_of(out._universe)
        return out

    def update_cells(self, other: "Table") -> "Table":
        names = other.column_names()
        for n in names:
            if n not in self.column_names():
                raise ValueError(f"update_cells: unknown column {n!r}")
        plan = Plan("update_cells", base=self, other=other, columns=names)
        return Table(plan, self._schema, self._universe)

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    # ------------------------------------------------------------------
    # reshaping
    # ------------------------------------------------------------------
    def flatten(self, to_flatten: ex.ColumnReference, *, origin_id: str | None = None) -> "Table":
        resolved = self._resolve(to_flatten)
        name = to_flatten.name if isinstance(to_flatten, ex.ColumnReference) else "flat"
        inner = infer_dtype(resolved)
        inner_dt = dt.ANY
        if isinstance(inner, dt.List):
            inner_dt = inner.wrapped
        elif isinstance(inner, dt.Tuple):
            inner_dt = dt.types_lca_many(*inner.args)
        elif inner is dt.STR:
            inner_dt = dt.STR
        cols = {}
        for n in self.column_names():
            if n == name:
                cols[n] = sch.ColumnSchema(name=n, dtype=inner_dt)
            else:
                cols[n] = sch.ColumnSchema(name=n, dtype=self._schema[n].dtype)
        if origin_id is not None:
            cols[origin_id] = sch.ColumnSchema(name=origin_id, dtype=dt.POINTER)
        schema = sch.schema_from_columns(cols)
        plan = Plan("flatten", base=self, expr=resolved, col_name=name,
                    origin_id=origin_id)
        return Table(plan, schema, Universe())

    # ------------------------------------------------------------------
    # pointer lookup
    # ------------------------------------------------------------------
    def ix(self, expression, *, optional: bool = False, context=None) -> "Table":
        ctx_table = context
        if ctx_table is None:
            ctx_table = _expr_base_table(expression)
        if ctx_table is None:
            raise ValueError("ix needs a context table (pass context=...)")
        schema = self._schema
        if optional:
            schema = sch.schema_from_columns({
                n: sch.ColumnSchema(name=n, dtype=dt.Optional(self._schema[n].dtype))
                for n in self.column_names()
            })
        plan = Plan("ix", target=self, key_expr=expression, ctx=ctx_table,
                    optional=optional)
        return Table(plan, schema, ctx_table._universe)

    def ix_ref(self, *args, optional: bool = False, context=None, instance=None):
        if context is None:
            raise ValueError("ix_ref requires context= (the table to index from)")
        expr = context.pointer_from(*args, instance=instance)
        return self.ix(expr, optional=optional, context=context)

    # ------------------------------------------------------------------
    # indexes
    # ------------------------------------------------------------------
    def _external_index_as_of_now(self, query_table, *, index_factory,
                                  query_responses_limit_column=None,
                                  query_filter_column=None,
                                  index_filter_data_column=None,
                                  res_type=dt.ANY_TUPLE,
                                  revise: bool = False):
        cols = {"_pw_index_reply": sch.ColumnSchema(name="_pw_index_reply",
                                                    dtype=res_type)}
        schema = sch.schema_from_columns(cols)
        plan = Plan(
            "external_index", data=self, queries=query_table,
            index_factory=index_factory,
            limit_col=query_responses_limit_column,
            query_filter_col=query_filter_column,
            data_filter_col=index_filter_data_column,
            revise=revise,
        )
        return Table(plan, schema, query_table._universe.subuniverse())

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @staticmethod
    def empty(**kwargs) -> "Table":
        schema = sch.schema_from_types(**kwargs)
        return Table(Plan("static", keys=[], rows=[], times=None, diffs=None),
                     schema)



class _ColumnNamespaceProxy:
    def __init__(self, table: Table):
        self._table = table

    def __getattr__(self, name):
        return self._table[name]

    def __getitem__(self, name):
        return self._table[name]


def _common_schema(tables: list[Table], update: bool = False):
    names = tables[0].column_names()
    for t in tables[1:]:
        if set(t.column_names()) != set(names):
            raise ValueError(
                f"concat/update requires same columns; got {names} vs "
                f"{t.column_names()}"
            )
    cols = {}
    for n in names:
        dtypes = [t._schema[n].dtype for t in tables]
        cols[n] = sch.ColumnSchema(name=n, dtype=dt.types_lca_many(*dtypes))
    return sch.schema_from_columns(cols)


def _expr_base_table(expr) -> Table | None:
    if isinstance(expr, ex.ColumnReference) and isinstance(expr.table, Table):
        return expr.table
    for d in getattr(expr, "_deps", ()):
        t = _expr_base_table(d)
        if t is not None:
            return t
    return None


# where each unported Table method of the JAX package comes from
_DSL_REST = "ROADMAP queue 1, item 2d: the rest of the Table DSL"
_UNPORTED = {name: _DSL_REST for name in (
    "join", "join_inner", "join_left", "join_right", "join_outer",
    "asof_join", "asof_now_join", "interval_join", "window_join",
    "windowby", "restrict", "intersect", "difference", "having", "sort",
    "diff", "interpolate", "show", "plot", "live", "update_id_type",
    "_gradual_broadcast", "_forget_immediately", "_buffer", "_forget",
    "_freeze", "_filter_out_results_of_forgetting", "to", "from_columns")}


def _unported(name: str, item: str):
    def method(*args, **kwargs):
        raise NotImplementedError(
            f"Table.{name} is not ported to pathway_tpu_torch yet ({item})")

    method.__name__ = name
    return method


for _name, _item in _UNPORTED.items():
    setattr(Table, _name, _unported(_name, _item))
# a property in the JAX package: raise on access
Table.slice = property(_unported("slice", _DSL_REST))
