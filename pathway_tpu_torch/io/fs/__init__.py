"""pw.io.fs, the filesystem connector — port of pathway_tpu/io/fs/__init__.py
(reference: python/pathway/io/fs, src/connectors/data_storage.rs
FilesystemReader:566, FileWriter:538).

Formats: ``plaintext`` (a row a line), ``plaintext_by_file`` (a row a
file), ``binary``, ``csv``, ``dsv`` and ``json`` (JSON lines). Static mode
reads every file when the graph is built; streaming mode runs a reader
thread (io/_datasource.py) that polls the path and re-reads a file whose
modification time changed, retracting the rows it emitted before.
``with_metadata=True`` adds a ``_metadata`` Json column (path, size,
modified_at, created_at, seen_at). Not ported: ``parquet`` (no pandas or
pyarrow on the chip machine) and the persistence layer's resume from
offsets (``persistent_id`` is kept on the source and read by nothing).
"""

from __future__ import annotations

import csv as _csv
import json as _json
import os
import time as _time
from pathlib import Path

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Plan, Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._datasource import (DataSource, Session,
                                              apply_connector_policy)
from pathway_tpu_torch.io.formats import parse_payload

_PARQUET = "ROADMAP queue 1, step 9: pandas and parquet I/O"


def _refuse_parquet(format: str) -> None:
    if format == "parquet":
        raise NotImplementedError(
            "format='parquet' is not ported to pathway_tpu_torch yet "
            f"({_PARQUET})")


def _list_files(path: str) -> list[Path]:
    p = Path(path)
    if p.is_dir():
        return sorted(f for f in p.rglob("*") if f.is_file())
    if p.exists():
        return [p]
    import glob

    return sorted(Path(f) for f in glob.glob(path))


def _parse_file(fpath: Path, format: str, schema, with_metadata: bool,
                dsv_separator: str = ","):
    """Yield value-dicts for one file."""
    meta = None
    if with_metadata:
        st = fpath.stat()
        meta = Json({
            "path": str(fpath), "size": st.st_size,
            "modified_at": int(st.st_mtime), "created_at": int(st.st_ctime),
            "seen_at": int(_time.time()),
        })
    rows = parse_payload(fpath.read_bytes(), format, schema,
                         dsv_separator=dsv_separator)
    for r in rows:
        if meta is not None:
            r["_metadata"] = meta
        yield r


def _schema_for(format: str, schema, with_metadata: bool):
    if schema is not None:
        if with_metadata and "_metadata" not in schema.column_names():
            schema = schema | sch.schema_from_types(_metadata=dt.JSON)
        return schema
    if format in ("plaintext", "plaintext_by_file"):
        base = sch.schema_from_types(data=dt.STR)
    elif format == "binary":
        base = sch.schema_from_types(data=dt.BYTES)
    else:
        raise ValueError(f"schema required for format {format!r}")
    if with_metadata:
        base = base | sch.schema_from_types(_metadata=dt.JSON)
    return base


class FsSource(DataSource):
    name = "fs"

    def __init__(self, path: str, format: str, schema, mode: str,
                 with_metadata: bool, refresh_interval_s: float = 0.5,
                 autocommit_duration_ms=1500, dsv_separator: str = ","):
        super().__init__(schema, autocommit_duration_ms)
        self.path = path
        self.format = format
        self.mode = mode
        self.with_metadata = with_metadata
        self.refresh_interval_s = refresh_interval_s
        self.dsv_separator = dsv_separator

    def run(self, session: Session) -> None:
        seen: dict[str, float] = {}
        emitted: dict[str, list] = {}
        seq = 0
        while not session.stop_requested:
            for f in _list_files(self.path):
                mtime = f.stat().st_mtime
                fkey = str(f)
                if seen.get(fkey) == mtime:
                    continue
                for key, row in emitted.get(fkey, ()):
                    session.push(key, row, -1)
                seen[fkey] = mtime
                rows = []
                for values in _parse_file(f, self.format, self.schema,
                                          self.with_metadata,
                                          self.dsv_separator):
                    key, row = self.row_to_engine(values, seq)
                    seq += 1
                    session.push(key, row, 1)
                    rows.append((key, row))
                emitted[fkey] = rows
            if self.mode != "streaming":
                return
            if not session.sleep(self.refresh_interval_s):
                return


def read(path: str, *, format: str = "plaintext", schema=None,
         mode: str = "streaming", csv_settings=None, json_field_paths=None,
         with_metadata: bool = False, autocommit_duration_ms: int | None = 1500,
         name: str | None = None, persistent_id: str | None = None,
         dsv_separator: str = ",", connector_policy=None, **kwargs) -> Table:
    _refuse_parquet(format)
    the_schema = _schema_for(format, schema, with_metadata)
    if mode == "static":
        keys, rows = [], []
        seq = 0
        src = FsSource(path, format, the_schema, mode, with_metadata,
                       dsv_separator=dsv_separator)
        for f in _list_files(path):
            for values in _parse_file(f, format, the_schema, with_metadata,
                                      dsv_separator):
                key, row = src.row_to_engine(values, seq)
                seq += 1
                keys.append(key)
                rows.append(row)
        plan = Plan("static", keys=keys, rows=rows, times=None, diffs=None)
        return Table(plan, the_schema, Universe(), name=name or "fs_static")
    source = FsSource(path, format, the_schema, mode, with_metadata,
                      autocommit_duration_ms=autocommit_duration_ms,
                      dsv_separator=dsv_separator)
    source.persistent_id = persistent_id or name
    apply_connector_policy(source, {}, policy=connector_policy)
    return Table(Plan("input", datasource=source), the_schema, Universe(),
                 name=name or "fs_input")


def write(table: Table, filename: str, *, format: str = "json", name=None,
          **kwargs) -> None:
    """Append diffs to a file as CSV or JSON lines with time and diff
    columns (the reference's FileWriter output format)."""
    _refuse_parquet(format)
    names = table.column_names()
    path = filename

    def binder(runner):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        f = open(path, "w", newline="")
        if format == "csv":
            writer = _csv.writer(f)
            writer.writerow(names + ["time", "diff"])

            def callback(time, delta):
                for key, row, diff in delta.entries:
                    writer.writerow(list(row) + [time, diff])
                f.flush()
        else:
            def callback(time, delta):
                for key, row, diff in delta.entries:
                    rec = dict(zip(names, row))
                    rec["time"] = time
                    rec["diff"] = diff
                    f.write(_json.dumps(rec, default=str) + "\n")
                f.flush()

        runner.subscribe(table, callback)

    G.add_output(binder, table=table, sink="fs", format=format)
