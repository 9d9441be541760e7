"""As-of-now external index operator — port of pathway_tpu/engine/index_ops.py
(reference: UseExternalIndexAsOfNow, src/engine/dataflow/operators/
external_index.rs + src/external_integration/mod.rs:40-48).

The data stream's diffs maintain the index (add on +1, remove on -1); each
query insertion is answered against the index as of its arrival and the
answer is never revised — the semantics behind DataIndex.query_as_of_now
and live RAG serving. ``revise=True`` gives DataIndex.query: standing
queries are answered again whenever the data changes.

The index is pluggable (protocol below); the device-resident brute-force
KNN lives in pathway_tpu_torch/ops/knn.py. Not ported: the semantic result
cache (ROADMAP queue 1, item 4), operator-state snapshots, replicas under
sharded execution (item 2d), the QoS coalescing counters and the mesh
placement warning.
"""

from __future__ import annotations

from typing import Any, Protocol

from pathway_tpu_torch.engine.delta import Delta
from pathway_tpu_torch.engine.operators import Operator
from pathway_tpu_torch.internals.error import ERROR, global_error_log
from pathway_tpu_torch.internals.keys import Pointer


class ExternalIndex(Protocol):
    def add(self, key: Pointer, vector: Any, filter_data: Any | None) -> None: ...

    def remove(self, key: Pointer) -> None: ...

    def search(self, queries: list[tuple[Pointer, Any, int | None, str | None]]
               ) -> list[tuple]:
        """Batched: [(qkey, query_vec, limit, filter)] ->
        per query a tuple of (match_key, score) pairs."""
        ...


class ExternalIndexOperator(Operator):
    arity = 2  # [data, queries]

    @property
    def device_bound(self) -> bool:
        """True when the index itself is device-resident (the KNN slab);
        information only until the device bridge is ported (ROADMAP queue
        1, item 2b)."""
        return bool(getattr(self.index, "device_bound", False))

    def __init__(self, index, data_vec_pos: int, data_filter_pos: int | None,
                 query_vec_pos: int, query_limit_pos: int | None,
                 query_filter_pos: int | None, default_limit: int = 3,
                 revise: bool = False):
        self.index = index
        self.data_vec_pos = data_vec_pos
        self.data_filter_pos = data_filter_pos
        self.query_vec_pos = query_vec_pos
        self.query_limit_pos = query_limit_pos
        self.query_filter_pos = query_filter_pos
        self.default_limit = default_limit
        # revise=True: standing queries are answered again whenever the
        # indexed data changes (retract + re-emit on difference)
        self.revise = revise
        self.answers: dict[Pointer, tuple] = {}
        self.live_queries: dict[Pointer, tuple] = {}  # key → (vec, limit, filt)

    def step(self, time, in_deltas):
        data_delta, query_delta = in_deltas
        # 1. maintain the index from the data diffs, before this tick's
        #    queries are answered (the reference's order). Adds coalesce
        #    into one add_batch (one device write) when the index has it.
        add_keys: list[Pointer] = []
        add_vecs: list[Any] = []
        add_filts: list[Any] = []
        use_batch = hasattr(self.index, "add_batch")

        def flush_adds():
            if add_keys:
                self.index.add_batch(add_keys, add_vecs, add_filts)
                add_keys.clear()
                add_vecs.clear()
                add_filts.clear()

        data_changed = bool(data_delta.entries)
        for key, row, diff in data_delta.entries:
            if diff > 0:
                vec = row[self.data_vec_pos]
                if vec is None or vec is ERROR:
                    global_error_log().log(
                        "external index: skipping row with error/None vector",
                        operator="external_index")
                    continue
                filt = row[self.data_filter_pos] if self.data_filter_pos is not None else None
                if use_batch:
                    add_keys.append(key)
                    add_vecs.append(vec)
                    add_filts.append(filt)
                else:
                    self.index.add(key, vec, filt)
            else:
                flush_adds()  # preserve add/remove ordering within the batch
                self.index.remove(key)
        flush_adds()
        if data_changed and hasattr(self.index, "flush_device"):
            # push this tick's page writes to the device now, so that an
            # ingest-only tick does not leave them to the next query's tick
            self.index.flush_device()
        out = Delta()
        # 2. answer query insertions (batched), retract answers on removal.
        # Per-key net view of the batch: an update can arrive as +1 then -1
        # for the same key in either order, so each key resolves once —
        # the last positive row wins, net < 0 with no insert is a removal.
        per_key: dict[Pointer, list] = {}
        key_order: list[Pointer] = []
        for key, row, diff in query_delta.entries:
            if key not in per_key:
                per_key[key] = [0, None]  # [net, last_positive_row]
                key_order.append(key)
            per_key[key][0] += diff
            if diff > 0:
                per_key[key][1] = row

        batch = []
        for key in key_order:
            net, row = per_key[key]
            if row is None:
                if net < 0:
                    self.live_queries.pop(key, None)
                    prev = self.answers.pop(key, None)
                    if prev is not None:
                        out.append(key, (prev,), -1)
                continue
            # (re)insertion or in-batch update: retract a superseded answer
            prev = self.answers.pop(key, None)
            if prev is not None:
                out.append(key, (prev,), -1)
            vec = row[self.query_vec_pos]
            if vec is None or vec is ERROR:
                # poisoned query: empty reply, never crash the worker
                global_error_log().log(
                    "external index: query with error/None vector",
                    operator="external_index")
                self.answers[key] = ()
                out.append(key, ((),), 1)
                continue
            limit = (row[self.query_limit_pos]
                     if self.query_limit_pos is not None else self.default_limit)
            if not isinstance(limit, int):
                limit = self.default_limit
            filt = (row[self.query_filter_pos]
                    if self.query_filter_pos is not None else None)
            if filt is ERROR:
                filt = None
            batch.append((key, vec, limit, filt))
            if self.revise:
                self.live_queries[key] = (vec, limit, filt)
        new_keys = {k for k, _, _, _ in batch}
        if self.revise and data_changed and self.live_queries:
            # answer every standing query again against the updated index;
            # only changed replies produce retract + re-emit diffs
            batch = [(k, v, l, f) for k, (v, l, f)
                     in self.live_queries.items()]
        if batch:
            replies = self.index.search(batch)
            for (key, _, _, _), reply in zip(batch, replies):
                reply = tuple(reply)
                prev = self.answers.get(key)
                if key not in new_keys and prev == reply:
                    continue
                if prev is not None and key not in new_keys:
                    out.append(key, (prev,), -1)
                self.answers[key] = reply
                out.append(key, (reply,), 1)
        return out
