"""pw.io.jsonlines — port of pathway_tpu/io/jsonlines/__init__.py
(reference: python/pathway/io/jsonlines): ``pw.io.fs`` with
``format="json"``."""

from __future__ import annotations

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import fs as _fs


def read(path: str, *, schema=None, mode: str = "streaming",
         json_field_paths=None, with_metadata: bool = False,
         autocommit_duration_ms: int | None = 1500, name=None, **kw) -> Table:
    return _fs.read(path, format="json", schema=schema, mode=mode,
                    with_metadata=with_metadata,
                    autocommit_duration_ms=autocommit_duration_ms, name=name)


def write(table: Table, filename: str, *, name=None, **kwargs) -> None:
    _fs.write(table, filename, format="json", name=name)
