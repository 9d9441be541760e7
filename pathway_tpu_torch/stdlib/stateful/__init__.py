"""pw.stdlib.stateful — port of pathway_tpu/stdlib/stateful/__init__.py
(reference: python/pathway/stdlib/stateful/deduplicate.py)."""

from __future__ import annotations

from typing import Callable

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.table import Table


def deduplicate(table: Table, *, col: ex.ColumnExpression,
                instance: ex.ColumnExpression | None = None,
                acceptor: Callable, name: str | None = None) -> Table:
    return table.deduplicate(value=col, instance=instance, acceptor=acceptor,
                             name=name)
