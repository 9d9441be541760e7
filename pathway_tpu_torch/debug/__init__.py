"""pw.debug — static table construction + deterministic printing — port of
pathway_tpu/debug/__init__.py.

`table_from_markdown` / `table_from_rows` + `compute_and_print` are the
backbone of the test harness:

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_markdown('''
... city   | temp
... Lagos  | 33
... Oslo   | 4
... ''')
>>> pw.debug.compute_and_print(
...     t.select(t.city, f=t.temp * 9 // 5 + 32), include_id=False)
city | f
Lagos | 91
Oslo | 39

The port does not depend on pandas: ``table_from_pandas``,
``table_to_pandas`` and the parquet helpers raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import (Pointer, hash_values,
                                              hash_values_uncached)
from pathway_tpu_torch.internals.runner import run_tables
from pathway_tpu_torch.internals.table import Plan, Table
from pathway_tpu_torch.internals.universe import Universe

_SPECIAL = ("_time", "_diff", "__time__", "__diff__")


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok in ("", "None"):
        return None
    if tok == "True":
        return True
    if tok == "False":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    if len(tok) >= 2 and tok[0] in "\"'" and tok[-1] == tok[0]:
        return tok[1:-1]
    return tok


def _split_cells(line: str) -> list[str]:
    """Split a markdown row into cells, preserving a leading empty cell
    (the reference's implicit-id header format: ``  | owner | pet``)."""
    cells = [c.strip() for c in line.strip().split("|")]
    while cells and cells[-1] == "":  # trailing pipe
        cells.pop()
    return cells


def table_from_markdown(txt: str, *, id_from=None, unsafe_trusted_ids=False,
                        schema: type[sch.Schema] | None = None,
                        _stream: bool = False) -> Table:
    lines = [l for l in txt.strip().splitlines()
             if l.strip() and not set(l.strip()) <= {"-", "|", " ", "+"}]
    header = _split_cells(lines[0])
    has_id = bool(header) and header[0] in ("", "id")
    if has_id:
        header = ["id"] + header[1:]
    rows_raw = []
    for line in lines[1:]:
        toks = _split_cells(line)
        rows_raw.append([_parse_value(t) for t in toks])
    col_names = [h for h in header if h not in _SPECIAL and h != "id"]
    time_idx = next((i for i, h in enumerate(header) if h in ("_time", "__time__")), None)
    diff_idx = next((i for i, h in enumerate(header) if h in ("_diff", "__diff__")), None)
    name_idx = {h: i for i, h in enumerate(header)}

    keys, rows, times, diffs = [], [], [], []
    for rix, raw in enumerate(rows_raw):
        if has_id:
            keys.append(hash_values("md-id", raw[0]))
        elif id_from:
            keys.append(hash_values(*[raw[name_idx[c]] for c in id_from]))
        elif diff_idx is not None:
            # with retractions, identical rows must share a key so -1 cancels +1
            keys.append(hash_values(
                "md-val", *[raw[name_idx[c]] if name_idx[c] < len(raw) else None
                            for c in col_names]))
        else:
            keys.append(hash_values("md-row", rix))
        rows.append(tuple(raw[name_idx[c]] if name_idx[c] < len(raw) else None
                          for c in col_names))
        times.append(int(raw[time_idx]) if time_idx is not None else 0)
        diffs.append(int(raw[diff_idx]) if diff_idx is not None else 1)

    if schema is not None:
        the_schema = schema
        dtypes = [the_schema[c].dtype for c in col_names]
        rows = [tuple(dt.coerce_value(v, d) for v, d in zip(r, dtypes))
                for r in rows]
    else:
        cols = {}
        for i, c in enumerate(col_names):
            vals = [r[i] for r in rows]
            cols[c] = sch.ColumnSchema(name=c, dtype=_infer_col_dtype(vals))
        the_schema = sch.schema_from_columns(cols)
        dtypes = [the_schema[c].dtype for c in col_names]
        rows = [tuple(dt.coerce_value(v, d) for v, d in zip(r, dtypes))
                for r in rows]

    plan = Plan("static", keys=keys, rows=rows,
                times=times if (time_idx is not None or _stream) else None,
                diffs=diffs if diff_idx is not None else None)
    return Table(plan, the_schema, Universe())


def _infer_col_dtype(vals) -> dt.DType:
    non_null = [v for v in vals if v is not None]
    opt = len(non_null) < len(vals)
    if not non_null:
        return dt.ANY
    types = {type(v) for v in non_null}
    if types <= {bool}:
        base = dt.BOOL
    elif types <= {int}:
        base = dt.INT
    elif types <= {int, float}:
        base = dt.FLOAT if float in types else dt.INT
    elif types <= {str}:
        base = dt.STR
    else:
        base = dt.ANY
    return dt.Optional(base) if opt else base


# alias used pervasively in reference tests
parse_to_table = table_from_markdown


def table_from_rows(schema: type[sch.Schema], rows: list[tuple],
                    unsafe_trusted_ids: bool = False, is_stream: bool = False) -> Table:
    """rows: tuples of column values, optionally + (time, diff) when is_stream."""
    col_names = schema.column_names()
    keys, data, times, diffs = [], [], [], []
    for rix, row in enumerate(rows):
        if is_stream:
            *vals, t, d = row
        else:
            vals, t, d = list(row), 0, 1
        # rix makes every key unique, so skip the memo cache; values are
        # hashed natively (_encode_value covers every engine type, with a
        # repr fallback for exotic objects) — an extra repr() per value
        # here was ~15% of the ETL source path
        keys.append(hash_values_uncached("row", rix, *vals))
        data.append(tuple(vals))
        times.append(int(t))
        diffs.append(int(d))
    plan = Plan("static", keys=keys, rows=data,
                times=times if is_stream else None,
                diffs=diffs if is_stream else None)
    return Table(plan, schema, Universe())


def _fmt(v) -> str:
    if v is None:
        return ""
    if isinstance(v, str):
        return v
    if isinstance(v, Pointer):
        return str(v)
    return repr(v)


def table_to_markdown(table: Table, *, include_id: bool = True,
                      n_rows: int | None = None) -> str:
    """Bounded snapshot rendered as the markdown-ish table format
    ``table_from_markdown`` parses (round-trippable)."""
    [cap] = run_tables(table)
    state = cap.snapshot()
    names = table.column_names()
    items = sorted(state.items(), key=lambda kv: _row_sort_key(kv[1], kv[0]))
    if n_rows is not None:
        items = items[:n_rows]
    cols = (["id"] if include_id else []) + names
    lines = [" | ".join(cols)]
    for key, row in items:
        cells = ([str(key)] if include_id else []) + [_fmt(v) for v in row]
        lines.append(" | ".join(cells))
    return "\n".join(lines)


def compute_and_print(table: Table, *, include_id: bool = True,
                      short_pointers: bool = True, n_rows: int | None = None,
                      squash_updates: bool = True, terminate_on_error: bool = True,
                      file=None) -> None:
    print(table_to_markdown(table, include_id=include_id, n_rows=n_rows),
          file=file)


def _row_sort_key(row, key):
    out = []
    for v in row:
        if isinstance(v, (bool, int, float)) and not isinstance(v, Pointer):
            out.append((0, float(v), ""))
        elif isinstance(v, str):
            out.append((1, 0.0, v))
        else:
            out.append((2, 0.0, repr(v)))
    out.append((3, float(int(key) % 10**9), ""))
    return tuple(out)


def compute_and_print_update_stream(table: Table, *, include_id: bool = True,
                                    short_pointers: bool = True,
                                    n_rows: int | None = None,
                                    terminate_on_error: bool = True,
                                    file=None) -> None:
    [cap] = run_tables(table)
    names = table.column_names()
    events = cap.consolidated_events()
    events.sort(key=lambda e: (e[2], _row_sort_key(e[1], e[0])))
    if n_rows is not None:
        events = events[:n_rows]
    cols = (["id"] if include_id else []) + names + ["__time__", "__diff__"]
    lines = [" | ".join(cols)]
    for key, row, time, diff in events:
        cells = ([str(key)] if include_id else []) + [_fmt(v) for v in row] + [
            str(time), str(diff)]
        lines.append(" | ".join(cells))
    print("\n".join(lines), file=file)


class StreamGenerator:
    """Programmatic multi-batch stream builder for tests
    (reference: debug/__init__.py StreamGenerator — batches become
    consecutive engine timestamps; the by-workers variant merges worker
    shards, since sharding here is by key, not by emitting worker)."""

    def __init__(self):
        self._count = 0

    def _next_name(self) -> str:
        self._count += 1
        return f"stream_generator_{self._count}"

    def table_from_list_of_batches(self, batches: list[list[dict]],
                                   schema: type[sch.Schema]) -> Table:
        """Each inner list lands at one (increasing) logical time."""
        names = schema.column_names()
        rows = []
        for t, batch in enumerate(batches):
            for values in batch:
                rows.append(tuple(values[n] for n in names) + (t + 1, 1))
        table = table_from_rows(schema, rows, is_stream=True)
        table._name = self._next_name()
        return table

    def table_from_list_of_batches_by_workers(
            self, batches: list[dict[int, list[dict]]],
            schema: type[sch.Schema]) -> Table:
        merged = [[values for shard in batch.values() for values in shard]
                  for batch in batches]
        return self.table_from_list_of_batches(merged, schema)

    def table_from_markdown(self, table: str) -> Table:
        """Markdown with a ``_time`` (and optional ``_diff``) column."""
        return table_from_markdown(table)


def table_to_dicts(table: Table):
    """(keys, {column -> {key -> value}}) of the table's final state
    (reference: debug/__init__.py:61)."""
    [cap] = run_tables(table)
    state = cap.snapshot()
    keys = list(state.keys())
    names = table.column_names()
    columns = {
        name: {key: state[key][i] for key in keys}
        for i, name in enumerate(names)
    }
    return keys, columns


_NO_PANDAS = ("the port does not depend on pandas (ROADMAP queue 1, item 2d: "
              "the rest of the Table DSL)")


def _needs_pandas(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"pw.debug.{name}: {_NO_PANDAS}")

    fn.__name__ = name
    return fn


table_from_pandas = _needs_pandas("table_from_pandas")
table_to_pandas = _needs_pandas("table_to_pandas")
table_from_parquet = _needs_pandas("table_from_parquet")
table_to_parquet = _needs_pandas("table_to_parquet")
