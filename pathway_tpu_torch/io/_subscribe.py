"""pw.io.subscribe — port of pathway_tpu/io/_subscribe.py (reference:
python/pathway/io/_subscribe.py:13)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table


def subscribe(table: Table,
              on_change: Callable[..., Any],
              on_end: Callable[[], Any] | None = None,
              on_time_end: Callable[[int], Any] | None = None,
              *, name: str | None = None, sort_by=None) -> None:
    """Call ``on_change(key, row, time, is_addition)`` for every change of
    `table`, ``on_time_end(time)`` after each closed timestamp and
    ``on_end()`` when ``pw.run`` returns."""
    names = table.column_names()

    def binder(runner):
        def callback(time: int, delta):
            for key, row, diff in delta.entries:
                on_change(key=key, row=dict(zip(names, row)), time=time,
                          is_addition=diff > 0)
            if on_time_end is not None:
                on_time_end(time)

        runner.subscribe(table, callback)
        if on_end is not None:
            runner._on_end_callbacks = getattr(runner, "_on_end_callbacks", [])
            runner._on_end_callbacks.append(on_end)

    G.add_output(binder, table=table, sink="subscribe")
