"""Argmin/argmax row filtering helpers — port of
pathway_tpu/stdlib/utils/filtering.py
(reference: python/pathway/stdlib/utils/filtering.py)."""

from __future__ import annotations

import pathway_tpu_torch.internals.reducers_frontend as reducers
from pathway_tpu_torch.internals.table import Table


def argmax_rows(table: Table, *on, what) -> Table:
    best = table.groupby(*on).reduce(_pw_best=reducers.argmax(what))
    return table.having(best._pw_best)


def argmin_rows(table: Table, *on, what) -> Table:
    best = table.groupby(*on).reduce(_pw_best=reducers.argmin(what))
    return table.having(best._pw_best)
