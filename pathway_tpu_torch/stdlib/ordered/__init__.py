"""pw.stdlib.ordered — diff over ordered time; port of
pathway_tpu/stdlib/ordered."""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.table import Table


def diff(table: Table, timestamp, *values, instance=None) -> Table:
    """For each row, subtract the previous row's values (by timestamp order
    within instance). Result columns: diff_<name>."""
    sorted_t = table.sort(timestamp, instance=instance)
    prev_tbl = table.ix(sorted_t.prev, optional=True, context=sorted_t)
    out = {}
    for v in values:
        name = v.name if isinstance(v, ex.ColumnReference) else str(v)
        cur = table[name]
        prev_v = prev_tbl[name]
        out["diff_" + name] = ex.if_else(
            prev_v.is_none(), None, cur - ex.unwrap(prev_v))
    return table.select(**out)
