"""Engine graph + microbatch scheduler — port of pathway_tpu/engine/graph.py.

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

With ``n_workers > 1`` the dataflow runs sharded in this process: every
node gets one operator replica a worker, rows route between workers at
each stateful operator's exchange (``Exchange`` specs: by key, by a
routing value, broadcast or gathered to worker 0), and sources partition
by row key. Each tick is bulk-synchronous, node by node, so the per-time
consistency guarantee is unchanged and the consolidated streams equal the
one-worker run's. The device bridge stays single-worker: a sharded tick is
one host leg. ``PATHWAY_WORKER_THREADS=1`` steps the replicas of
``parallel_safe`` operators on a thread pool.

With a profiler installed (engine/profiler.py), sync mode's one worker
steps each device node as its own leg (``begin_leg`` / ``end_leg``), as
the bridge does for a pipelined tick.

Not ported: the multi-process cluster (``cluster=``, ROADMAP queue 1 item
6f), iteration and the snapshot sanitizer.
"""

from __future__ import annotations

import os
import threading
import time as _time

from pathway_tpu_torch.engine.delta import Delta, row_fingerprint
from pathway_tpu_torch.engine.device_bridge import (DeviceBridge,
                                                    device_inflight_from_env)
from pathway_tpu_torch.engine.operators import (Exchange, Operator,
                                                SourceOperator)
from pathway_tpu_torch.engine.profiler import current_profiler
from pathway_tpu_torch.internals.config import _env_int
from pathway_tpu_torch.internals.keys import hash_values
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
        # the sharded replicas of the capture share it, possibly from the
        # worker pool's threads: one lock operation a tick, not a row
        self._lock = threading.Lock()

    @property
    def events(self) -> list[tuple]:
        with self._lock:
            chunks, self._chunks = self._chunks, []
        for time, entries in chunks:
            self._events.extend(
                [(key, row, time, diff)
                 for key, row, diff in entries])
        return self._events

    def on_delta(self, time: int, delta: Delta) -> None:
        if delta.entries:
            with self._lock:
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
    """Microbatch scheduler for an EngineGraph.

    One worker: the host leg of each tick on the calling thread, its
    device leg on the device bridge when the window is 2 or more
    (``device_inflight``; None reads ``PATHWAY_DEVICE_INFLIGHT``).

    ``n_workers > 1``: the dataflow runs sharded — one operator replica a
    worker and node (``_replicas``; gather nodes keep one, on worker 0),
    rows routed by key at each exchange (reference: timely worker threads
    + exchange pacts, src/engine/dataflow/shard.rs), sources partitioned
    by row key. ``parallel_threads`` (None reads
    ``PATHWAY_WORKER_THREADS``) steps the replicas of ``parallel_safe``
    operators on a thread pool. ``cluster`` (the multi-process run) is not
    ported and raises.
    """

    def __init__(self, graph: EngineGraph, n_workers: int = 1,
                 parallel_threads: bool | None = None, cluster=None,
                 device_inflight: int | None = None, recorder=None):
        if cluster is not None:
            raise NotImplementedError(
                "Scheduler(cluster=...) is not ported to pathway_tpu_torch "
                "yet (ROADMAP queue 1, item 6f: the multi-process cluster)")
        self.graph = graph
        self.n_workers = max(1, int(n_workers))
        # flight recorder (engine/flight_recorder.py): None or disabled is
        # the hot-path default — one branch per operator step
        self.recorder = recorder
        if parallel_threads is None:
            parallel_threads = os.environ.get(
                "PATHWAY_WORKER_THREADS", "0") not in ("0", "", "false")
        # the replicas' state is disjoint, so stepping them on a pool is
        # safe; it pays only where operator work releases the GIL
        # (numpy, the card), hence opt-in
        self._pool = None
        if parallel_threads and self.n_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.n_workers)
        self._stats_lock = threading.Lock()
        # value -> worker memo per exchanged edge, bounded so that a
        # high-cardinality routing column does not grow it without end:
        # at the cap the edge's memo is dropped whole
        self._route_cache: dict[tuple[int, int], dict] = {}
        self._route_cache_max = max(
            1024, _env_int("PATHWAY_ROUTE_CACHE_MAX", 1 << 16))
        self._topo = self._topo_sort()
        # worker replicas per node; replica 0 is node.op itself. A gather
        # node (unpartitionable state) keeps one replica, worker 0's
        self._replicas: dict[int, list[Operator]] = {}
        self._gather: dict[int, bool] = {}
        for node in graph.nodes:
            gather = any(spec == Exchange.GATHER
                         for spec in node.op.exchange_specs())
            self._gather[node.id] = gather
            if gather or self.n_workers == 1:
                self._replicas[node.id] = [node.op]
            else:
                self._replicas[node.id] = node.op.replicate(self.n_workers)
        # per-operator counters (reference: OperatorStats, read by
        # bench.py's serving leg as serving_ingested_rows); under sharding
        # the replicas add into their node's
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
        # the bridge is single-worker: a sharded tick is bulk-synchronous,
        # its exchanges the consistency points
        if self.device_inflight >= 2 and self.n_workers == 1 \
                and device_nodes:
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
        """Drain the bridge, stop its worker and release the worker pool
        (idempotent). The bridge object survives so its counters stay
        readable."""
        if self._bridge is not None:
            self._bridge.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    # -- sharding helpers --------------------------------------------------
    def _route_value(self, v) -> int:
        if not isinstance(v, int):  # Pointer subclasses int
            v = hash_values(v)
        return int(v) % self.n_workers

    def push_source(self, node: Node, delta: Delta) -> None:
        """Feed a source node for the next committed timestamp, its rows
        partitioned across the workers by key (the in-process analogue of
        per-worker source reads, reference src/connectors/mod.rs:400)."""
        reps = self._replicas[node.id]
        if len(reps) == 1:
            reps[0].push(delta)
            return
        n = self.n_workers
        parts: list[list] = [[] for _ in reps]
        for key, row, diff in delta.entries:
            parts[int(key) % n].append((key, row, diff))
        for rep, part in zip(reps, parts):
            if part:
                rep.push(Delta(part))

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
        if self.n_workers > 1:
            return self._run_time_sharded(time, flush)
        if self._bridge is not None:
            return self._run_time_pipelined(time, flush)
        outputs: dict[int, Delta] = {}
        # request-tracking host-done stamp (engine/request_tracker.py): in
        # synchronous mode the "host leg" ends when the first device-bound
        # operator steps (no device nodes: after the loop). Armed only
        # while requests are in flight.
        requests = self._tracked_requests()
        host_pending = requests is not None
        prof = current_profiler()
        for node in self._topo:
            if host_pending and node.id in self._trace_device_ids:
                requests.host_done(time)
                host_pending = False
            in_deltas = [outputs.get(up.id, _EMPTY) for up in node.inputs]
            if prof is not None and node.id in self._trace_device_ids:
                # sync mode has no bridge leg to measure: each device
                # node's step is its own leg, so the dispatches inside are
                # re-timed to its measured time (engine/profiler.py)
                prof.begin_leg(time)
                t0 = _time.perf_counter()
                try:
                    delta = self._step_op(node, node.op, time, in_deltas,
                                          flush)
                except BaseException:
                    prof.end_leg(None)
                    raise
                prof.end_leg((_time.perf_counter() - t0) * 1e3)
            else:
                delta = self._step_op(node, node.op, time, in_deltas, flush)
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
            delta = self._step_op(node, node.op, time, in_deltas, flush)
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
                delta = self._step_op(node, node.op, time, in_deltas, flush)
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

    def _step_op(self, node: Node, op: Operator, time: int,
                 in_deltas: list[Delta], flush: bool) -> Delta:
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
        # replicas stepped on the pool add into one node's counters
        with self._stats_lock:
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

    def _run_time_sharded(self, time: int, flush: bool) -> "_MergedOutputs":
        """One tick over the workers, node by node in topological order:
        each input is routed as its spec says, the replicas step (on the
        pool when the operator is ``parallel_safe`` and the pool is on),
        and their outputs stay per worker until a consumer routes them."""
        outputs: dict[int, list[Delta]] = {}  # node.id -> per-worker deltas
        for node in self._topo:
            reps = self._replicas[node.id]
            if self._gather[node.id]:
                outs = self._step_gather(node, reps, time, flush, outputs)
            else:
                outs = self._step_replicas(node, reps, time, flush, outputs)
            outputs[node.id] = outs
            for d in outs:
                self._count(node.id, d)
        requests = self._tracked_requests()
        if requests is not None:
            # sharded execution is bulk-synchronous: the whole tick is one
            # host leg (its device stage reads 0)
            requests.host_done(time)
        return _MergedOutputs(outputs)

    def _step_replicas(self, node: Node, reps: list, time: int, flush: bool,
                       outputs: dict) -> list[Delta]:
        n = self.n_workers
        op0 = reps[0]
        specs = op0.exchange_specs()
        consolidate = op0.consolidate_inputs
        per_worker: list[list[Delta]] = [
            [_EMPTY] * len(node.inputs) for _ in range(n)]
        for j, up in enumerate(node.inputs):
            parts = outputs.get(up.id) or [_EMPTY] * n
            spec = specs[j]
            if spec is None:
                for w in range(n):
                    per_worker[w][j] = parts[w]
                continue
            if spec == Exchange.BROADCAST:
                # every worker sees the complete delta
                ents: list = []
                for p in parts:
                    ents.extend(p.entries)
                if ents:
                    merged = Delta(_retractions_first(ents))
                    if consolidate:
                        merged = merged.consolidate()
                    for w in range(n):
                        per_worker[w][j] = merged
                continue
            routed: list[list] = [[] for _ in range(n)]
            if spec == Exchange.BY_KEY:
                for p in parts:
                    for e in p.entries:  # inline: keys are ints
                        routed[int(e[0]) % n].append(e)
            else:
                # routing values (instance columns, group values) repeat
                # tick after tick: memoize value -> worker per edge. Ints
                # (Pointers included) route directly, and tuples are the
                # per-row null sentinels that would never hit
                cache = self._route_cache.setdefault((node.id, j), {})
                for p in parts:
                    for e in p.entries:
                        v = spec(e[0], e[1])
                        if isinstance(v, int):
                            w = int(v) % n
                        elif isinstance(v, tuple):
                            w = self._route_value(v)
                        else:
                            try:
                                w = cache.get(v)
                            except TypeError:  # unhashable
                                w = self._route_value(v)
                            else:
                                if w is None:
                                    w = self._route_value(v)
                                    if len(cache) >= self._route_cache_max:
                                        cache.clear()
                                    cache[v] = w
                        routed[w].append(e)
            self._merge_routed(per_worker, routed, j, consolidate)
        # temporal operators share one watermark across workers (global,
        # as a timely frontier is): advance it from every worker's input
        # before any replica releases rows on it
        if hasattr(op0, "_advance_watermark_value"):
            wm = None
            for up in node.inputs:
                for p in outputs.get(up.id) or ():
                    wm = _wm_max(wm, op0._watermark_candidate(p))
            op0._advance_watermark_value(wm)
        if self._pool is not None and op0.parallel_safe:
            return list(self._pool.map(
                lambda w: self._step_op(node, reps[w], time, per_worker[w],
                                        flush), range(n)))
        return [self._step_op(node, reps[w], time, per_worker[w], flush)
                for w in range(n)]

    def exchange_rounds_per_tick(self) -> int:
        """Exchange rounds one tick would cost a cluster after coalescing
        (a static count from the graph): exchanged and watermark nodes
        share one round a topological level; a gather node closes the open
        batch and pays its own round. bench.py reads it from the
        one-worker scheduler too."""
        rounds = 0
        pending: set[int] = set()
        for node in self._topo:
            if self._gather[node.id]:
                if pending:
                    rounds += 1
                    pending = set()
                rounds += 1
                continue
            op0 = self._replicas[node.id][0]
            exchanged = any(spec is not None
                            for spec in op0.exchange_specs())
            wm_node = hasattr(op0, "_advance_watermark")
            if pending and any(up.id in pending for up in node.inputs):
                rounds += 1
                pending = set()
            if exchanged or wm_node:
                pending.add(node.id)
        return rounds + (1 if pending else 0)

    @staticmethod
    def _merge_routed(per_worker, routed, j, consolidate: bool = True) -> None:
        for w, ents in enumerate(routed):
            if not ents:
                continue
            cur = per_worker[w][j]
            merged = Delta(_retractions_first(
                ents if cur is _EMPTY else cur.entries + ents))
            per_worker[w][j] = merged.consolidate() if consolidate \
                else merged

    def _step_gather(self, node: Node, reps: list, time: int, flush: bool,
                     outputs: dict) -> list[Delta]:
        """Gather node: one owner replica on worker 0, fed every worker's
        input; the other workers emit nothing."""
        ins_entries: list[list] = [[] for _ in node.inputs]
        for j, up in enumerate(node.inputs):
            for p in outputs.get(up.id) or ():
                ins_entries[j].extend(p.entries)
        ins = [Delta(e).consolidate() if e else _EMPTY for e in ins_entries]
        delta = self._step_op(node, reps[0], time, ins, flush)
        return [delta] + [_EMPTY] * (self.n_workers - 1)


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


def _retractions_first(ents: list) -> list:
    """A worker's merged input with each key's (key, row) pairs
    consolidated, the entries of a key made adjacent and its retractions
    before its insertions (keys keep their first-seen order; most ticks
    have no repeated key and pass unchanged).

    An upsert of a reindexed key arrives as a retraction and an insertion
    of different rows with different source keys, so the exchange may
    bring them from two workers in either order; an operator that drops a
    key's live row on a retraction (the join's per-key state) would lose
    the insertion that came first. One worker sees them in the order its
    source gave. Only such true upserts reorder: an insertion and a
    retraction of the same row cancel first, since a non-consolidating
    operator (the inner bilinear join) ignores a retraction of an absent
    row and would keep the insertion moved after it."""
    first: dict = {}
    for i, e in enumerate(ents):
        first.setdefault(e[0], i)
    if len(first) == len(ents):
        return ents
    ents = Delta(ents).consolidate().entries
    return sorted(ents, key=lambda e: (first[e[0]], e[2] > 0))


def _wm_max(a, b):
    """Max of two watermark candidates, tolerant of None and of event-time
    types that do not compare (as temporal_ops._gt is)."""
    if b is None:
        return a
    if a is None:
        return b
    try:
        return b if b > a else a
    except TypeError:
        return a


class _MergedOutputs:
    """Node-output view over per-worker deltas: the runtimes ignore
    run_time's return value, so a node's partitions are concatenated and
    consolidated only when a caller asks for it — the consolidated delta
    the one-worker path returns."""

    __slots__ = ("_per_worker",)

    def __init__(self, per_worker: dict[int, list[Delta]]):
        self._per_worker = per_worker

    def get(self, node_id: int, default: Delta = _EMPTY) -> Delta:
        outs = self._per_worker.get(node_id)
        if outs is None:
            return default
        entries: list = []
        for d in outs:
            entries.extend(d.entries)
        return Delta(entries).consolidate()

    def __getitem__(self, node_id: int) -> Delta:
        if node_id not in self._per_worker:
            raise KeyError(node_id)
        return self.get(node_id)

    def __contains__(self, node_id: int) -> bool:
        return node_id in self._per_worker
