"""pw.stdlib.utils.col — port of pathway_tpu/stdlib/utils/col.py
(reference: python/pathway/stdlib/utils/col.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.table import Table


def unpack_col(column: ex.ColumnReference, *unpacked_columns,
               schema=None) -> Table:
    """Expand a tuple column into many columns."""
    table = column.table
    if schema is not None:
        names = schema.column_names()
    else:
        names = [c.name if isinstance(c, ex.ColumnReference) else str(c)
                 for c in unpacked_columns]
    return table.select(**{
        n: ex.GetExpression(column, i, check_if_exists=False)
        for i, n in enumerate(names)
    })


def flatten_column(column: ex.ColumnReference, origin_id: str | None = "origin_id"):
    table = column.table
    return table.flatten(column, origin_id=origin_id)


def multiapply_all_rows(*cols: ex.ColumnReference, fun,
                        result_col_names: list) -> Table:
    """Apply ``fun`` to ALL rows' values of the selected columns at once
    (one batched dispatch — the whole-table analogue of pw.apply), returning
    several columns re-keyed to the original rows (reference: stdlib/utils/
    col.py:211). fun(list_col1, list_col2, ...) -> (out1_list, out2_list, …).
    """
    import pathway_tpu_torch.internals.reducers_frontend as reducers
    from pathway_tpu_torch.internals.keys import Pointer

    assert cols, "need at least one column"
    table = cols[0].table
    names = [c.name if isinstance(c, ex.ColumnReference) else str(c)
             for c in result_col_names]

    packed = table.select(row=ex.apply(
        lambda rid, *vals: (int(rid), *vals), table.id, *cols))
    gathered = packed.reduce(rows=reducers.sorted_tuple(packed.row))

    def run(rows):
        ids, *col_lists = zip(*rows)
        outs = fun(*col_lists)
        return tuple(zip(ids, *outs))

    applied = gathered.select(out=ex.apply(run, gathered.rows))
    flat = applied.flatten(applied.out)
    keyed = flat.select(
        _pw_id=ex.apply(lambda r: Pointer(r[0]), flat.out),
        **{n: ex.apply(lambda r, _i=i: r[_i + 1], flat.out)
           for i, n in enumerate(names)})
    return keyed.with_id(keyed._pw_id).without("_pw_id")


def apply_all_rows(*cols: ex.ColumnReference, fun, result_col_name) -> Table:
    """Single-output-column variant of :func:`multiapply_all_rows`
    (reference: stdlib/utils/col.py:276)."""
    return multiapply_all_rows(
        *cols, fun=lambda *col_lists: [fun(*col_lists)],
        result_col_names=[result_col_name])


def groupby_reduce_majority(column: ex.ColumnReference, value_column):
    """Per ``column`` group, the most frequent ``value_column`` value
    (reference: stdlib/utils/col.py groupby_reduce_majority)."""
    import pathway_tpu_torch.internals.reducers_frontend as reducers

    table = column.table
    counted = table.groupby(column, value_column).reduce(
        column, value_column, _pw_cnt=reducers.count())
    val_name = value_column.name if isinstance(
        value_column, ex.ColumnReference) else str(value_column)
    return counted.groupby(counted[column.name]).reduce(
        counted[column.name],
        # two-arg argmax: payload is the VALUE with the top count
        majority=reducers.argmax(counted._pw_cnt, counted[val_name]),
    )
