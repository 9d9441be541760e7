"""pw.stdlib.statistical — interpolation; port of
pathway_tpu/stdlib/statistical."""

from __future__ import annotations

import enum

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.table import Table


class InterpolateMode(enum.Enum):
    LINEAR = "linear"


def interpolate(table: Table, timestamp, *values,
                mode: InterpolateMode | None = None) -> Table:
    """Linear interpolation of missing (None) values along timestamp order
    (LINEAR, the one mode)."""
    ts_name = timestamp.name if isinstance(timestamp, ex.ColumnReference) else None

    # one pass over the (time, id, values) tuples sorted by time: each None
    # is filled from its nearest neighbours with values
    import pathway_tpu_torch.internals.reducers_frontend as reducers

    names = [v.name if isinstance(v, ex.ColumnReference) else str(v) for v in values]
    items = table.groupby().reduce(
        _pw_items=reducers.sorted_tuple(
            ex.MakeTupleExpression(
                table[ts_name], table.id,
                *[table[n] for n in names])),
    )

    def interp(rows):
        rows = list(rows)
        out = []
        for j, row in enumerate(rows):
            t, key, *vals = row
            fixed = []
            for ci, v in enumerate(vals):
                if v is not None:
                    fixed.append(v)
                    continue
                # find neighbours with values
                prev_t = prev_v = next_t = next_v = None
                for pj in range(j - 1, -1, -1):
                    if rows[pj][2 + ci] is not None:
                        prev_t, prev_v = rows[pj][0], rows[pj][2 + ci]
                        break
                for nj in range(j + 1, len(rows)):
                    if rows[nj][2 + ci] is not None:
                        next_t, next_v = rows[nj][0], rows[nj][2 + ci]
                        break
                if prev_v is not None and next_v is not None:
                    frac = (t - prev_t) / (next_t - prev_t)
                    fixed.append(prev_v + (next_v - prev_v) * frac)
                elif prev_v is not None:
                    fixed.append(prev_v)
                elif next_v is not None:
                    fixed.append(next_v)
                else:
                    fixed.append(None)
            out.append((key, tuple(fixed)))
        return tuple(out)

    per_row = items.select(
        _pw_fixed=ex.ApplyExpression(interp, None, items._pw_items))
    flat = per_row.flatten(per_row._pw_fixed)
    keyed = flat.select(
        _pw_key=flat._pw_fixed[0],
        _pw_vals=flat._pw_fixed[1],
    )
    keyed = keyed.with_id(keyed._pw_key)
    fixed_cols = {
        n: keyed._pw_vals[i] for i, n in enumerate(names)
    }
    fixed_t = keyed.select(**fixed_cols).with_universe_of(table)
    return table.update_cells(fixed_t)
