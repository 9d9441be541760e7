"""pw.io.plaintext — port of pathway_tpu/io/plaintext/__init__.py
(reference: python/pathway/io/plaintext): ``pw.io.fs`` with
``format="plaintext"``, a row a line."""

from __future__ import annotations

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import fs as _fs


def read(path: str, *, mode: str = "streaming", with_metadata: bool = False,
         autocommit_duration_ms: int | None = 1500, name=None, **kw) -> Table:
    return _fs.read(path, format="plaintext", mode=mode,
                    with_metadata=with_metadata,
                    autocommit_duration_ms=autocommit_duration_ms, name=name)
