"""pw.io.csv — port of pathway_tpu/io/csv/__init__.py (reference:
python/pathway/io/csv): ``pw.io.fs`` with ``format="csv"``; without a
schema, one is inferred from the first file (``schema_from_csv``)."""

from __future__ import annotations

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import fs as _fs


def read(path: str, *, schema=None, mode: str = "streaming", csv_settings=None,
         with_metadata: bool = False, autocommit_duration_ms: int | None = 1500,
         name: str | None = None, **kwargs) -> Table:
    if schema is None:
        from pathway_tpu_torch.internals.schema import schema_from_csv
        import glob
        from pathlib import Path

        p = Path(path)
        sample = path if p.is_file() else next(
            iter(sorted(str(f) for f in p.rglob("*") if f.is_file()))
            if p.is_dir() else iter(sorted(glob.glob(path))), None)
        if sample is None:
            raise FileNotFoundError(f"no csv files at {path}")
        schema = schema_from_csv(sample)
    return _fs.read(path, format="csv", schema=schema, mode=mode,
                    with_metadata=with_metadata,
                    autocommit_duration_ms=autocommit_duration_ms, name=name)


def write(table: Table, filename: str, *, name=None, **kwargs) -> None:
    _fs.write(table, filename, format="csv", name=name)
