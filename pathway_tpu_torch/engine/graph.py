"""Engine graph + microbatch scheduler — port of pathway_tpu/engine/graph.py
with one worker on the calling thread.

Logical timestamps are totally ordered ints; at each committed timestamp
the scheduler pushes source deltas through the nodes in topological order —
every operator sees its complete input delta for time t before producing
output for t. Not ported: sharded workers (``n_workers > 1``, ROADMAP
queue 1 item 2d), iteration, the device bridge (item 2b: the JAX package
runs a device-bound operator's leg on a bridge thread when
``PATHWAY_DEVICE_INFLIGHT >= 2``; here every leg runs serially, as the JAX
package's do at ``PATHWAY_DEVICE_INFLIGHT=1``), the snapshot sanitizer,
the profiler hooks and the flight recorder.
"""

from __future__ import annotations

from pathway_tpu_torch.engine.delta import Delta, row_fingerprint
from pathway_tpu_torch.engine.operators import Operator, SourceOperator
from pathway_tpu_torch.internals.trace import add_trace_note


class Node:
    __slots__ = ("id", "op", "inputs", "name", "trace")

    def __init__(self, id: int, op: Operator, inputs: list["Node"], name: str = ""):
        self.id = id
        self.op = op
        self.inputs = inputs
        self.name = name
        self.trace = None  # user-frame Trace set by the lowering

    def __repr__(self):
        return f"<Node {self.id} {self.name or type(self.op).__name__}>"


class EngineGraph:
    def __init__(self):
        self.nodes: list[Node] = []

    def add_node(self, op: Operator, inputs: list[Node] | None = None,
                 name: str = "") -> Node:
        node = Node(len(self.nodes), op, list(inputs or []), name)
        self.nodes.append(node)
        return node

    def add_source(self, name: str = "source") -> Node:
        return self.add_node(SourceOperator(name), [], name)


class CapturedStream:
    """Output capture: the list of (key, row, time, diff) a table produced.

    Capture is chunk-buffered: on_delta stores (time, entries) references
    (deltas are never mutated after emission) and the flat event list
    materializes on first read — the dataflow's hot loop must not pay for
    the harness's bookkeeping.
    """

    def __init__(self):
        self._chunks: list[tuple[int, list]] = []
        self._events: list[tuple] = []  # flattened (key, row, time, diff)

    @property
    def events(self) -> list[tuple]:
        chunks, self._chunks = self._chunks, []
        for time, entries in chunks:
            self._events.extend(
                [(key, row, time, diff)
                 for key, row, diff in entries])
        return self._events

    def on_delta(self, time: int, delta: Delta) -> None:
        if delta.entries:
            self._chunks.append((time, delta.entries))

    def snapshot(self) -> dict:
        state: dict = {}
        counts: dict = {}
        for key, row, time, diff in self.events:
            c = counts.get(key, 0) + diff
            counts[key] = c
            if c > 0:
                state[key] = row
            else:
                state.pop(key, None)
                counts.pop(key, None)
        return state

    def consolidated_events(self) -> list[tuple]:
        acc: dict[tuple, int] = {}
        order: dict[tuple, int] = {}
        for i, (key, row, time, diff) in enumerate(self.events):
            k = (key, row_fingerprint(row), time)
            if k not in acc:
                acc[k] = 0
                order[k] = i
            acc[k] += diff
        out = []
        for i, (key, row, time, diff) in enumerate(self.events):
            k = (key, row_fingerprint(row), time)
            if order.get(k) == i and acc[k] != 0:
                out.append((key, row, time, acc[k]))
        return out


class Scheduler:
    """Single-worker microbatch driver for an EngineGraph, stepping every
    operator on the calling thread."""

    def __init__(self, graph: EngineGraph, n_workers: int = 1):
        if n_workers != 1:
            raise NotImplementedError(
                f"n_workers={n_workers}: the port's scheduler runs one "
                "worker (ROADMAP queue 1, item 2d: sharded execution)")
        self.graph = graph
        self.n_workers = 1
        self._topo = self._topo_sort()

    def push_source(self, node: Node, delta: Delta) -> None:
        """Feed a source node for the next committed timestamp."""
        node.op.push(delta)

    def _topo_sort(self) -> list[Node]:
        seen: dict[int, int] = {}
        order: list[Node] = []

        def visit(node: Node):
            state = seen.get(node.id, 0)
            if state == 2:
                return
            if state == 1:
                raise ValueError("cycle in engine graph (use iterate)")
            seen[node.id] = 1
            for up in node.inputs:
                visit(up)
            seen[node.id] = 2
            order.append(node)

        for node in self.graph.nodes:
            visit(node)
        return order

    def run_time(self, time: int, flush: bool = False) -> dict[int, Delta]:
        """Process one committed timestamp: sources already hold pending data.

        ``flush=True`` marks the end-of-stream tick: operators holding rows
        release them, and the releases propagate downstream within the same
        tick.
        """
        outputs: dict[int, Delta] = {}
        for node in self._topo:
            in_deltas = [outputs.get(up.id, _EMPTY) for up in node.inputs]
            outputs[node.id] = self._step_op(node, time, in_deltas, flush)
        return outputs

    def _step_op(self, node: Node, time: int, in_deltas: list[Delta],
                 flush: bool) -> Delta:
        op = node.op
        try:
            delta = op.step(time, in_deltas)
            extra = op.on_time_advance(time)
            if extra:
                delta = Delta(delta.entries + extra.entries).consolidate()
            if flush:
                held = op.flush(time)
                if held:
                    delta = Delta(delta.entries + held.entries).consolidate()
        except Exception as e:
            # annotate rather than wrap: the original exception type must
            # keep escaping the run so user except-clauses still match
            add_trace_note(e, node.trace,
                           node.name or type(node.op).__name__)
            raise
        return delta


_EMPTY = Delta()
