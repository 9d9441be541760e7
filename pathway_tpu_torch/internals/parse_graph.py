"""Global registry of outputs collected as user code runs — port of
pathway_tpu/internals/parse_graph.py. The Table plans form the DAG
themselves; the registry only records output bindings (``Table.debug``,
``pw.io.subscribe``, a ``rest_connector``'s response writer), which
``pw.run`` attaches to its runner (``GraphRunner.capture`` does not read
them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class OutputBinding:
    """One registered sink: binder fn(runner) plus the bound table."""

    binder: Callable
    table: Any = None  # the Table routed to this sink (None: opaque binder)
    sink: str = "sink"  # connector name, e.g. "debug"
    format: str | None = None  # wire format, e.g. "json"


class ParseGraph:
    def __init__(self):
        # each binding's binder: fn(runner) -> None, attaches sinks/subscribers
        self.outputs: list[OutputBinding] = []

    @property
    def output_binders(self) -> list[Callable]:
        return [o.binder for o in self.outputs]

    def add_output(self, binder: Callable, *, table: Any = None,
                   sink: str = "sink", format: str | None = None) -> None:
        self.outputs.append(
            OutputBinding(binder, table=table, sink=sink, format=format))

    def clear(self) -> None:
        self.outputs.clear()
        from pathway_tpu_torch.internals.universe_solver import GLOBAL_SOLVER

        GLOBAL_SOLVER.reset()


G = ParseGraph()
