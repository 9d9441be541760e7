"""As-of-now external index operator — port of pathway_tpu/engine/index_ops.py
(reference: UseExternalIndexAsOfNow, src/engine/dataflow/operators/
external_index.rs + src/external_integration/mod.rs:40-48).

The data stream's diffs maintain the index (add on +1, remove on -1); each
query insertion is answered against the index as of its arrival and the
answer is never revised — the semantics behind DataIndex.query_as_of_now
and live RAG serving. ``revise=True`` gives DataIndex.query: standing
queries are answered again whenever the data changes.

The index is pluggable (protocol below); the device-resident brute-force
KNN lives in pathway_tpu_torch/ops/knn.py. Under sharded execution
(engine/graph.py) the data stream is broadcast and queries stay on the
worker that holds them; the replicas share the one index object (one copy
on the card) and only replica 0 maintains it. An as-of-now operator
answers through the index's semantic result cache
(engine/result_cache.py) when it carries one: hits and duplicate misses
never reach the device. Not ported: operator-state snapshots (ROADMAP
queue 1, step 7a) and the QoS coalescing counters (step 7b). An index on
a mesh other than the active one logs the PWT104 placement warning, as in
the JAX package.
"""

from __future__ import annotations

import copy
from typing import Any, Protocol

from pathway_tpu_torch.engine.delta import Delta
from pathway_tpu_torch.engine.operators import Exchange, Operator
from pathway_tpu_torch.engine.result_cache import fingerprint
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
    # replicas share one index and replica 0 mutates it: the per-worker
    # steps stay sequential
    parallel_safe = False

    @property
    def device_bound(self) -> bool:
        """True when the index itself is device-resident (the KNN slab):
        the operator then runs in the tick's device leg."""
        return bool(getattr(self.index, "device_bound", False))

    def exchange_specs(self):
        # the reference's semantics (operators/external_index.rs:97): the
        # data stream is broadcast so that every worker can answer, and
        # queries stay where they live. The replicas share one index on
        # the card instead of the reference's per-worker copies.
        return [Exchange.BROADCAST, None]

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
        # replica 0 maintains the shared index; the others only search
        self._is_primary = True
        self._warn_mesh_placement(index)

    @staticmethod
    def _warn_mesh_placement(index) -> None:
        """The PWT104 warning at run time: an index slab on a mesh of
        another shape than the process-wide active one makes every query
        batch cross topologies."""
        slab_mesh = getattr(index, "_mesh", None)
        if slab_mesh is None:
            return
        from pathway_tpu_torch.parallel.mesh import current_mesh

        active = current_mesh()
        if active is None or active is slab_mesh:
            return
        if dict(active.shape) != dict(slab_mesh.shape):
            import logging

            logging.getLogger("pathway_tpu_torch.shard_check").warning(
                "[PWT104] external index slab lives on a %s mesh while the "
                "active mesh is %s — every query batch pays a "
                "cross-topology transfer; build the index with mesh='auto' "
                "or the active mesh",
                dict(slab_mesh.shape), dict(active.shape))

    def replicate(self, n: int):
        reps = [self]
        for _ in range(n - 1):
            r = copy.copy(self)  # shares the index object
            r.answers = {}
            r.live_queries = {}
            r._is_primary = False
            reps.append(r)
        return reps

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
        if not self._is_primary:
            # every replica sees the broadcast data delta (revise mode
            # answers again on it), but only the primary writes the index
            data_delta = Delta()
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
        cache = (getattr(self.index, "result_cache", None)
                 if not self.revise else None)
        if cache is not None and data_changed and self._is_primary:
            # one index-version bump a data tick: the replicas see the
            # broadcast delta too, but share this index and its cache
            cache.note_data_tick()
        if data_changed and self._is_primary and \
                hasattr(self.index, "flush_device"):
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
            replies = self._answer_batch(batch, cache)
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

    def _answer_batch(self, batch: list[tuple], cache) -> list[tuple]:
        """Answer one tick's query batch, through the semantic result
        cache when the index carries one (as-of-now only — revise mode
        answers standing queries again, so its replies are not reusable).

        The misses ride one search; hits and duplicate misses (the same
        fingerprint again in this batch, which shares the first miss's
        reply) never reach the device. Replies come back in the batch's
        order, so a cache-on run emits exactly what a cache-off run does.
        Filtered queries bypass the cache (filter payloads can change
        without touching the vectors). The JAX package's two QoS
        coalescing counters here wait for the QoS port (ROADMAP queue 1,
        step 7b)."""
        if cache is None:
            return self.index.search(batch)
        fps = [None if filt is not None else fingerprint(vec, limit)
               for _key, vec, limit, filt in batch]
        replies: list = [None] * len(batch)
        to_search: list[int] = []
        fp_first: dict[bytes, int] = {}
        for i, fp in enumerate(fps):
            if fp is not None:
                hit = cache.lookup(fp)
                if hit is not None:
                    replies[i] = hit
                    continue
                if fp in fp_first:
                    continue  # duplicate miss: shares the first's reply
                fp_first[fp] = i
            to_search.append(i)
        if to_search:
            searched = self.index.search([batch[i] for i in to_search])
            pages = getattr(self.index, "last_search_coverage", None)
            for i, reply in zip(to_search, searched):
                reply = tuple(reply)
                replies[i] = reply
                fp = fps[i]
                if fp is not None:
                    _key, vec, limit, _filt = batch[i]
                    kth = (reply[-1][1]
                           if reply and len(reply) >= int(limit) else None)
                    cache.fill(fp, reply, pages, kth, vec)
        for i, fp in enumerate(fps):
            if replies[i] is None:
                replies[i] = replies[fp_first[fp]]
        return replies
