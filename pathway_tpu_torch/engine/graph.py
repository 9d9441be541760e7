"""Engine graph + microbatch scheduler — port of pathway_tpu/engine/graph.py
with one worker.

Logical timestamps are totally ordered ints; at each committed timestamp
the scheduler pushes source deltas through the nodes in topological order —
every operator sees its complete input delta for time t before producing
output for t.

Pipelined device legs (engine/device_bridge.py): every device-bound
operator (the encoder embedder's map, the device-resident KNN index) and
its downstream closure form a tick's device leg. With an in-flight window
of 2 or more (``PATHWAY_DEVICE_INFLIGHT``, default 2) the scheduler steps
the tick's host leg on the calling thread, submits the device leg to the
bridge's one worker thread, and goes on to the next tick's host leg; the
end-of-stream tick barriers. At a window of 1 every node steps on the
calling thread. Both modes give the same events.

The streaming runtime (engine/streaming.py) reads what the scheduler
keeps per node (``stats``: rows inserted and retracted, step latency) and
passes a flight recorder (engine/flight_recorder.py): operator spans, and
the request tracker's host-leg stamp for every query picked up in a tick.
With no recorder each step pays one branch for it.

Not ported: sharded workers (``n_workers > 1``, ROADMAP queue 1 item 2d),
iteration, the snapshot sanitizer and the profiler hooks.
"""

from __future__ import annotations

import time as _time

from pathway_tpu_torch.engine.delta import Delta, row_fingerprint
from pathway_tpu_torch.engine.device_bridge import (DeviceBridge,
                                                    device_inflight_from_env)
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
    """Single-worker microbatch scheduler for an EngineGraph: the host leg of
    each tick on the calling thread, its device leg on the device bridge
    when the window is 2 or more (``device_inflight``; None reads
    ``PATHWAY_DEVICE_INFLIGHT``)."""

    def __init__(self, graph: EngineGraph, n_workers: int = 1,
                 device_inflight: int | None = None, recorder=None):
        if n_workers != 1:
            raise NotImplementedError(
                f"n_workers={n_workers}: the port's scheduler runs one "
                "worker (ROADMAP queue 1, item 2d: sharded execution)")
        self.graph = graph
        self.n_workers = 1
        # flight recorder (engine/flight_recorder.py): None or disabled is
        # the hot-path default — one branch per operator step
        self.recorder = recorder
        self._topo = self._topo_sort()
        # per-operator counters (reference: OperatorStats, read by
        # bench.py's serving leg as serving_ingested_rows)
        self.stats: dict[int, dict] = {
            n.id: {"insertions": 0, "retractions": 0,
                   "latency_ms": 0.0, "total_ms": 0.0}
            for n in graph.nodes
        }
        if device_inflight is None:
            device_inflight = device_inflight_from_env()
        self.device_inflight = max(1, int(device_inflight))
        self._bridge = None
        self._deferred_ids: frozenset[int] = frozenset()
        device_nodes = [n.id for n in graph.nodes
                        if getattr(n.op, "device_bound", False)]
        if self.device_inflight >= 2 and device_nodes:
            self._deferred_ids = self._downstream_closure(device_nodes)
            self._bridge = DeviceBridge(self.device_inflight,
                                        recorder=recorder)
        # trace labeling: deferred-closure nodes are the device leg when
        # pipelining; synchronous mode labels the device-bound operators
        self._trace_device_ids = self._deferred_ids or frozenset(device_nodes)

    def _downstream_closure(self, roots: list[int]) -> frozenset[int]:
        """All nodes reachable from ``roots`` (inclusive) following output
        edges. Closed under successors, so every consumer of a deferred
        node's output is itself deferred — the device leg never feeds data
        back into the host leg of the same tick."""
        succs: dict[int, list[int]] = {n.id: [] for n in self.graph.nodes}
        for node in self.graph.nodes:
            for up in node.inputs:
                succs[up.id].append(node.id)
        seen = set(roots)
        frontier = list(roots)
        while frontier:
            nid = frontier.pop()
            for s in succs[nid]:
                if s not in seen:
                    seen.add(s)
                    frontier.append(s)
        return frozenset(seen)

    def resolve_barrier(self) -> None:
        """Wait for every in-flight device leg to resolve (no-op when
        pipelining is off); re-raises a leg's failure."""
        if self._bridge is not None:
            self._bridge.barrier()

    def wait_watermark(self, tick: int) -> int:
        """Block until the resolved-prefix watermark reaches ``tick``
        (synchronous mode: already there); returns early, with the frozen
        watermark, when the bridge goes idle without reaching it."""
        if self._bridge is not None:
            return self._bridge.wait_watermark(tick)
        return tick

    def commit_watermark(self, completed_tick: int) -> int:
        """The latest tick whose work has fully retired, once
        ``completed_tick`` returned from :meth:`run_time`: the bridge's
        resolved watermark when pipelining, else the tick itself."""
        if self._bridge is not None:
            return min(self._bridge.resolved_watermark(), completed_tick)
        return completed_tick

    def bridge_stats(self) -> dict | None:
        """Device-bridge instrumentation (None when pipelining is off)."""
        if self._bridge is not None:
            return self._bridge.stats()
        return None

    def take_device_error(self) -> BaseException | None:
        """A device-leg failure that no submit/barrier observed yet."""
        if self._bridge is not None:
            return self._bridge.error()
        return None

    def close(self) -> None:
        """Drain the bridge and stop its worker (idempotent). The bridge
        object survives so its counters stay readable."""
        if self._bridge is not None:
            self._bridge.close()

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
        if self._bridge is not None:
            return self._run_time_pipelined(time, flush)
        outputs: dict[int, Delta] = {}
        # request-tracking host-done stamp (engine/request_tracker.py): in
        # synchronous mode the "host leg" ends when the first device-bound
        # operator steps (no device nodes: after the loop). Armed only
        # while requests are in flight.
        requests = self._tracked_requests()
        host_pending = requests is not None
        for node in self._topo:
            if host_pending and node.id in self._trace_device_ids:
                requests.host_done(time)
                host_pending = False
            in_deltas = [outputs.get(up.id, _EMPTY) for up in node.inputs]
            delta = self._step_op(node, time, in_deltas, flush)
            outputs[node.id] = delta
            self._count(node.id, delta)
        if host_pending:
            requests.host_done(time)
        return outputs

    def _tracked_requests(self):
        """The run's request tracker iff recording is on AND a request is
        mid-flight — one branch per tick otherwise."""
        rec = self.recorder
        if rec is not None and rec.enabled and rec.requests is not None \
                and rec.requests.active():
            return rec.requests
        return None

    def _run_time_pipelined(self, time: int, flush: bool):
        """One tick, split into a host leg (stepped now, on this thread)
        and a device leg (the deferred closure, submitted to the bridge).

        The leg closure captures this tick's ``outputs`` dict; host-leg
        deltas are complete before submission and the deferred closure is
        closed under successors, so the two threads never share a node.
        Steps observe ticks in order because the bridge worker is a single
        FIFO. ``flush=True`` (end of stream) is a hard barrier: everything
        must have retired before the caller tears down or reads results.
        """
        outputs: dict[int, Delta] = {}
        deferred: list[Node] = []
        for node in self._topo:
            if node.id in self._deferred_ids:
                deferred.append(node)
                continue
            in_deltas = [outputs.get(up.id, _EMPTY) for up in node.inputs]
            delta = self._step_op(node, time, in_deltas, flush)
            outputs[node.id] = delta
            self._count(node.id, delta)
        requests = self._tracked_requests()
        if requests is not None:
            # host leg complete; the device leg (bridge worker) resolves
            # the request downstream — the stamp that opens its stage
            requests.host_done(time)

        def body() -> None:
            for node in deferred:
                in_deltas = [outputs.get(up.id, _EMPTY) for up in node.inputs]
                delta = self._step_op(node, time, in_deltas, flush)
                outputs[node.id] = delta
                self._count(node.id, delta)

        rec = self.recorder
        if rec is not None and rec.enabled:
            def leg() -> None:
                # a torch.profiler range: profiles of the card show the
                # same tick boundaries as the recorder's spans
                with rec.device_annotation(time):
                    body()
        else:
            leg = body

        self._bridge.submit(time, leg)
        if flush:
            self._bridge.barrier()
        return _PipelinedOutputs(self._bridge, outputs)

    def _step_op(self, node: Node, time: int, in_deltas: list[Delta],
                 flush: bool) -> Delta:
        op = node.op
        rec = self.recorder
        recording = rec is not None and rec.enabled
        if recording:
            leg = "device" if node.id in self._trace_device_ids else "host"
            # in-flight marker set BEFORE the step: a hung operator is
            # exactly the one the post-mortem must name
            rec.mark_op(time, node, leg)
        t0 = _time.perf_counter()
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
        ms = (_time.perf_counter() - t0) * 1e3
        st = self.stats[node.id]
        st["latency_ms"] = ms
        st["total_ms"] += ms
        if recording:
            rows_in = 0
            for d in in_deltas:
                rows_in += len(d.entries)
            # idle steps (no rows either way, sub-ms) are not recorded: a
            # quiescent server ticks every few ms and its idle spans would
            # evict the spans of the ticks that served requests
            if rows_in or delta.entries or ms >= 1.0:
                rec.record(time, node, leg, t0, ms, rows_in,
                           len(delta.entries))
            # cleared on success only: an operator that raised stays named
            # in the in-flight slot for the post-mortem dump
            rec.clear_op()
        return delta

    def _count(self, node_id: int, delta: Delta) -> None:
        if delta:
            st = self.stats[node_id]
            ins = rets = 0
            for _, _, d in delta.entries:
                if d >= 0:
                    ins += d
                else:
                    rets -= d
            st["insertions"] += ins
            st["retractions"] += rets


class _PipelinedOutputs:
    """Per-tick output view under pipelined execution: deferred-node
    deltas materialize on the bridge worker, so any read is a hard resolve
    barrier first; a caller gets the synchronous mode's answer, later."""

    __slots__ = ("_bridge", "_outputs")

    def __init__(self, bridge, outputs: dict[int, Delta]):
        self._bridge = bridge
        self._outputs = outputs

    def get(self, node_id: int, default: Delta | None = None) -> Delta | None:
        self._bridge.barrier()
        return self._outputs.get(node_id, default)

    def __getitem__(self, node_id: int) -> Delta:
        self._bridge.barrier()
        return self._outputs[node_id]

    def __contains__(self, node_id: int) -> bool:
        self._bridge.barrier()
        return node_id in self._outputs


_EMPTY = Delta()
